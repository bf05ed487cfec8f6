"""Multi-node dry run: trace one step of an (architecture x input shape) on
the production mesh of H100s without a card or an allocation, and read off
each device's memory, flops, bytes and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID] [--shape NAME]
        [--multi-pod | --both-meshes] [--no-probes] [--optimized] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --compare DIR_A DIR_B

Counterpart of the JAX package's ``launch/dryrun.py``.  Where it lowers and
compiles a jitted step over 512 fake XLA host devices, this module *traces*
the port's own step: the parameters, optimizer moments, batch and caches are
DTensors on ``launch.mesh``'s fake process group, sharded by
``distributed.sharding``'s specs, whose local shards are meta tensors
(shapes and dtypes, no storage; DTensor's own shape propagation runs under
``FakeTensorMode``).  The step runs the port's plain path under
``ops.meta_trace`` (no kernel; each scan one traced operator,
``kernels.trace_ops``), and DTensor inserts the collectives the placements
need.  Where the installed torch's DTensor places an op otherwise than torch
2.13 does, or not at all, ``kernels.trace_ops`` registers 2.13's rule, and
``StepCounter`` places the views 2.13 makes strided shards of, so that a pair
gives the same figures on either version; an op that no rule places runs
replicated and fails the pair.  ``StepCounter`` reads every ATen op the
local shards run (flops by ``torch.utils.flop_counter``'s formulas, bytes
read and written) and every collective, and follows the local shards'
storages for the per-device peak (``MemTracker`` reads 487.6 GB for
qwen3-1.7b x decode_32k on this mesh, the DTensors at their global sizes,
against 2.85 GB of local shards).  Plain tensors in the trace (RoPE tables,
masks, positions) are treated as replicated (``implicit_replication``).

Train and decode update the parameters, moments and caches in place (the
port's ``make_train_step`` and ``decode_step``), so the peak holds one copy
of each: the counterpart of the reference's buffer donation.

The roofline terms are predictions from NVIDIA's data-sheet figures at 700 W
(``launch.mesh``), not measurements.  Records go to ``build/dryrun/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.collectives import (CollectiveLog, dispatched_collective,
                                              mesh_groups, nbytes)
from repro_torch.config import (ALL_SHAPES, ArchConfig, InputShape, StepKind, get_arch,
                                get_shape)
from repro_torch.configs import ASSIGNED
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import axis_size, dp_axes, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.flops import model_flops

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")
# the record's list of ops DTensor could not place; any entry fails the pair
REPLICATED = "ops run replicated (no DTensor rule)"


# ---------------------------------------------------------------------------
# Config helpers


def with_layers(cfg: ArchConfig, n: int) -> ArchConfig:
    encdec = cfg.encdec
    if encdec is not None:
        encdec = dataclasses.replace(encdec, encoder_layers=n)
    return dataclasses.replace(cfg, n_layers=n, encdec=encdec)


def probe_layer_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """Two probe depths: one and two stack periods (Jamba's period is 8,
    homogeneous stacks use 2/4 for a stabler fit)."""
    (kinds, _), = T._stack_plan(cfg)
    period = len(kinds)
    if period == 1:
        return 2, 4
    return period, 2 * period


def serving_variant(cfg: ArchConfig, shape) -> Tuple[ArchConfig, str]:
    """long_500k needs sub-quadratic attention: SSM/hybrid/SWA archs run
    natively; pure full-attention archs get the documented sliding-window
    serving variant (window 4096)."""
    if shape.name != "long_500k" or cfg.supports_long_context_natively:
        return cfg, ""
    return (dataclasses.replace(cfg, sliding_window=4096),
            "swa-serving-variant(window=4096)")


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, no allocation)


def _dtype(cfg: ArchConfig):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def input_specs(cfg: ArchConfig, shape) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    dt = _dtype(cfg)

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    batch: Dict[str, torch.Tensor] = {}
    if shape.step == StepKind.DECODE:
        batch["tokens"] = meta((B, 1), torch.long)
        return batch
    if cfg.frontend is not None and cfg.encdec is None:     # VLM
        batch["embeds"] = meta((B, S, cfg.frontend.embed_dim), dt)
    else:
        batch["tokens"] = meta((B, S), torch.long)
    if cfg.encdec is not None:                               # audio enc-dec
        Tenc = cfg.encdec.max_source_positions
        batch["enc_embeds"] = meta(
            (B, Tenc, cfg.frontend.embed_dim if cfg.frontend else cfg.d_model), dt)
    if shape.step == StepKind.TRAIN:
        batch["labels"] = meta((B, S), torch.long)
    return batch


def cache_template(cfg: ArchConfig, batch: int, seq_len: int):
    """The decode step's cache tree as meta tensors: ``init_caches``' layers,
    and for an enc-dec model the cross K/V and their valid mask over the
    encoder's positions."""
    out = {"layers": T.init_caches({"embed": torch.empty(0, device="meta")}, cfg,
                                   batch, seq_len)}
    if cfg.encdec is not None:
        (kinds, n_groups), = T._stack_plan(cfg)
        Tenc = cfg.encdec.max_source_positions
        kv_shape = (n_groups, batch, Tenc, cfg.n_kv_heads, cfg.resolved_head_dim)
        out["cross_kv"] = tuple(
            (torch.empty(kv_shape, dtype=_dtype(cfg), device="meta"),
             torch.empty(kv_shape, dtype=_dtype(cfg), device="meta"))
            for _ in kinds)
        out["cross_valid"] = torch.empty((batch, Tenc), dtype=torch.bool, device="meta")
    return out


# ---------------------------------------------------------------------------
# DTensors from templates


def _local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    from torch.distributed.tensor import Shard
    local = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            if local[p.dim] % mesh.size(m):
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide over "
                                 f"mesh dim {m} ({mesh.size(m)})")
            local[p.dim] //= mesh.size(m)
    return tuple(local)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def distribute(template, specs, mesh, *, requires_grad: bool = False,
               dtype=None):
    """A tree of DTensors of the template's shapes (and dtypes, or ``dtype``)
    placed by ``specs``, each local shard a meta tensor."""
    from torch.distributed.tensor import DTensor

    def make(path, meta):
        pl = sh.placements(sh.leaf_at(specs, path), mesh)
        local = torch.zeros(_local_shape(meta.shape, mesh, pl), dtype=dtype or meta.dtype,
                            device="meta")
        d = DTensor.from_local(local, mesh, pl, run_check=False, shape=meta.shape,
                               stride=_contiguous_stride(meta.shape))
        return d.requires_grad_() if requires_grad else d

    return sh.walk(template, make)


# ---------------------------------------------------------------------------
# What the local shards run


# ops that move no bytes: allocations, and views that carry no alias note
_NO_BYTES = {"aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
             "aten.new_empty_strided", "prim.device", "aten.lift_fresh",
             "aten._unsafe_view"}
_VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default}
# ops that return their input on the device but a new tensor on the meta
# device (a collective's output, wrapped for autograd): no bytes, and the
# input's storage, not a new one
_WRAPS = {"_c10d_functional._wrap_tensor_autograd.default"}
# ops that read only the rows they pick (or write): output (or values) read
# and written once, and the indices
_GATHERS = {"aten.index", "aten.gather", "aten.embedding", "aten.index_select"}
_SCATTERS = {"aten.index_put_": 2, "aten.scatter_": 3, "aten.scatter_add_": 3,
             "aten.index_add_": 3}      # op -> argument holding the values


class StepCounter:
    """A ``TorchDispatchMode`` over the trace: for every ATen op on local
    shards (not the DTensor-level call, which it hands back to DTensor), the
    flops by ``torch.utils.flop_counter``'s formulas, the bytes it reads and
    writes (view ops move none), each collective into a ``CollectiveLog`` by
    its mesh axis, and the storages its outputs hold: one device's live
    bytes (``live``) and their high-water mark (``peak``), each storage
    counted from the op that made it until its last tensor dies.  Flops,
    bytes and collectives are counted only while ``counting`` (the step, not
    the set-up of its state); storages always.  DTensor's own ops on fake
    tensors of global shape, which derive an output's metadata, are neither
    counted nor tracked."""

    def __init__(self, mesh):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        counter = self
        self.counting = False
        self.replicated: Dict[str, int] = {}
        self.view_gathers = 0
        self.views_placed = 0
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.log = CollectiveLog()
        self._held = WeakIdKeyDictionary()
        groups = mesh_groups(mesh)

        class _Mode(TorchDispatchMode):
            """The outer mode takes each DTensor op (``_dtensor_op``); the inner
            one, which that pushes around the op, hands it to DTensor and
            counts its local ops."""

            def __init__(self, outer: bool):
                super().__init__()
                self.outer = outer

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    if not self.outer:
                        return NotImplemented
                    if func in _VIEWS and isinstance(args[0], DTensor):
                        return counter._view(func, args, kwargs)
                    return counter._dtensor_op(func, args, kwargs)
                out = func(*args, **kwargs)
                leaves = [t for t in tree_leaves((args, kwargs, out))
                          if isinstance(t, torch.Tensor)]
                if any(isinstance(t, FakeTensor) for t in leaves):
                    return out            # DTensor deriving an output's global shape
                if not self.outer and not any(t.device.type == "meta" for t in leaves):
                    return out            # DTensor's own index arithmetic on the host
                if str(func) in _WRAPS:       # the input itself on the device: its
                    weakref.finalize(out.untyped_storage(), _keep,   # storage lives on
                                     args[0].untyped_storage())      # with the output
                    return out
                hit = dispatched_collective(func, args, out, groups)
                if hit is not None:
                    if counter.counting:
                        counter.log.record(*hit)
                elif counter.counting:
                    if func.overloadpacket in flop_registry:
                        counter.flops += flop_registry[func.overloadpacket](
                            *args, **kwargs, out_val=out)
                    counter.bytes += _op_bytes(func, args, kwargs, out)
                if _is_view(func):
                    return out            # no new storage on the device
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        counter._hold(t.untyped_storage())
                return out

        self.mode = _Mode(outer=True)
        self._inner = lambda: _Mode(outer=False)

    def _dtensor_op(self, func, args, kwargs):
        """A DTensor op, by DTensor, under an inner mode that counts its local
        ops.  Where DTensor cannot run it (an op no rule places:
        ``kernels.trace_ops`` registers the port's where torch lacks its own)
        it runs as one device would: its inputs gathered whole (the gathers
        recorded as any collective), the op on their local tensors, its
        outputs replicated; what the failed attempt counted is taken back and
        the op counted in ``replicated``, which fails the pair
        (``require_placed``): every op after it on its outputs runs whole on
        every rank too.  An op in place writes the gathered copy, the input
        itself where it was replicated already."""
        from torch.distributed.tensor import DTensor, Replicate
        mark = (self.flops, self.bytes, len(self.log.calls))
        try:
            with self._inner():
                return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as first:
            self.flops, self.bytes = mark[:2]
            del self.log.calls[mark[2]:]
            # without its traceback: frames holding the attempt's tensors
            # would live on in a cycle, freed at the collector's whim
            error = first.with_traceback(None)
        mesh = next(t.device_mesh for t in tree_leaves((args, kwargs))
                    if isinstance(t, DTensor))
        whole_pl = [Replicate()] * mesh.ndim

        def whole(t):
            return t.redistribute(mesh, whole_pl) if isinstance(t, DTensor) else t

        def local(t):
            return t.to_local() if isinstance(t, DTensor) else t

        def wrap(t):
            if not isinstance(t, torch.Tensor):
                return t
            return DTensor.from_local(t, mesh, whole_pl, run_check=False)

        try:
            with self._inner():
                args, kwargs = tree_map(whole, (args, kwargs))
                out = func(*tree_map(local, args), **tree_map(local, kwargs))
        except (RuntimeError, NotImplementedError):
            raise error
        if func._schema.arguments and func._schema.arguments[0].alias_info is not None \
                and func._schema.arguments[0].alias_info.is_write:
            out = args[0]
        else:
            out = tree_map(wrap, out)
        name = str(func)
        self.replicated[name] = self.replicated.get(name, 0) + 1
        return out

    def _view(self, func, args, kwargs):
        """A view of a DTensor, by DTensor where it keeps to the public
        placements.  Where DTensor cannot view it in them (torch 2.11 merges
        dimensions only when the first of them alone is sharded, and splits a
        dimension sharded twice only when its first part divides over both
        mesh dimensions; 2.13 makes and undoes a strided shard there), the
        view is taken on the local shard and placed by ``view_placements``
        (``views placed``): the local shape of a strided shard, as a plain
        shard, on either version, so that the ops after it place alike.
        Where that cannot place it either, the mesh dimension that shards the
        highest tensor dimension is gathered first, and again, until the view
        goes: the all-gathers are recorded here, since the mode is off while
        it handles a call (``view gathers``).  A view moves no bytes and
        holds no new storage, so nothing else of it is counted."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        x = args[0]
        while True:
            try:
                out = func(x, *args[1:], **kwargs)
                if all(type(p) in (Shard, Replicate, Partial) for p in out.placements):
                    return out
            except (RuntimeError, AssertionError):
                pass
            mesh = x.device_mesh
            size = _view_size(x.shape, args[1])
            placed = view_placements(x.shape, size, x.placements, mesh.shape)
            sharded = [(p.dim, m) for m, p in enumerate(x.placements) if isinstance(p, Shard)]
            if placed is None and not sharded:
                return func(x, *args[1:], **kwargs)       # raises DTensor's error
            if placed is not None:
                if self.counting:
                    self.views_placed += 1
                local = list(size)
                for m, p in enumerate(placed):
                    if isinstance(p, Shard):
                        local[p.dim] //= mesh.size(m)
                return DTensor.from_local(func(x.to_local(), local), mesh, placed,
                                          run_check=False, shape=torch.Size(size),
                                          stride=_contiguous_stride(size))
            _, m = max(sharded)
            local = x.to_local()
            if self.counting:
                n = x.device_mesh.size(m)
                self.log.record("all-gather", nbytes(local) * n, n, x.device_mesh.mesh_dim_names[m])
                self.view_gathers += 1
            pl = list(x.placements)
            pl[m] = Replicate()
            x = x.redistribute(x.device_mesh, pl)

    def _hold(self, storage) -> None:
        if storage in self._held:
            return
        n = storage.nbytes()
        self._held[storage] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._release, n)

    def _release(self, n: int) -> None:
        self.live -= n


def _keep(*_) -> None:
    """A finalizer that only holds its arguments until it runs."""


def _view_size(shape, size) -> Tuple[int, ...]:
    """``size`` of a view of ``shape``, its -1 resolved."""
    size = list(size)
    if -1 in size:
        known = 1
        for n in size:
            known *= n if n != -1 else 1
        total = 1
        for n in shape:
            total *= n
        size[size.index(-1)] = total // known
    return tuple(size)


def view_placements(shape, size, placements, mesh_shape):
    """The placements of ``shape`` viewed as ``size``, each mesh dimension
    keeping its shard where its share of elements stays whole: the two sides
    are cut into the shortest runs of dimensions of equal product, a run
    taking the size-1 dimensions that follow it on either side; a run's mesh
    dimensions (by dimension, then by mesh dimension) shard its first output
    dimension while it divides over them, then the next.  So dimensions
    sharded on two mesh dimensions and merged become one dimension sharded
    twice, and split again go back.  None where a mesh dimension finds no
    output dimension."""
    from torch.distributed.tensor import Shard
    out = list(placements)
    i = j = 0
    while i < len(shape) or j < len(size):
        ins, outs = [], []
        a = b = 1
        while i < len(shape) or j < len(size):
            take_in = (a <= b and i < len(shape)) or j == len(size)
            if a == b:
                if i < len(shape) and shape[i] == 1:
                    take_in = True
                elif j < len(size) and size[j] == 1:
                    take_in = False
                elif ins and outs:
                    break
            if take_in:
                a *= shape[i]
                ins.append(i)
                i += 1
            else:
                b *= size[j]
                outs.append(j)
                j += 1
        meshes = [m for d in ins for m, p in enumerate(placements)
                  if isinstance(p, Shard) and p.dim == d]
        k, left = 0, size[outs[0]] if outs else 1
        for m in meshes:
            while outs and k < len(outs) and left % mesh_shape[m]:
                k += 1
                left = size[outs[k]] if k < len(outs) else 1
            if not outs or k == len(outs):
                return None
            left //= mesh_shape[m]
            out[m] = Shard(outs[k])
    return out


def _tensor_bytes(*xs) -> int:
    total = 0
    for a in xs:
        if isinstance(a, torch.Tensor):
            total += nbytes(a)
        elif isinstance(a, (tuple, list)):
            total += sum(nbytes(t) for t in a if isinstance(t, torch.Tensor))
    return total


def _is_view(func) -> bool:
    """Whether ``func`` returns a view of an input: its storage, not a new one.
    (On the meta device a view can show a storage not seen yet: a
    collective's output that DTensor waited on out of the mode's sight comes
    back as a new tensor there.)"""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _op_bytes(func, args, kwargs, out) -> int:
    """Bytes an op reads and writes: every tensor argument and output once;
    a gather its output twice and its indices, a scatter in place its values
    twice and its indices; none for allocations and views."""
    name = str(func.overloadpacket).replace("torch.ops.", "")
    if name in _NO_BYTES:
        return 0
    if _is_view(func):
        return 0                                  # a view: no bytes move
    if name in _GATHERS or name in _SCATTERS:
        indices = [t for a in args[1:] for t in (a if isinstance(a, (tuple, list)) else (a,))
                   if isinstance(t, torch.Tensor) and not t.is_floating_point()]
        moved = out if name in _GATHERS else args[_SCATTERS[name]]
        return 2 * _tensor_bytes(moved) + _tensor_bytes(indices)
    return _tensor_bytes(*args, *kwargs.values(),
                         *(out if isinstance(out, (tuple, list)) else (out,)))


@contextlib.contextmanager
def _alltoall_kept(mesh):
    """On a CPU mesh DTensor turns a shard-to-shard redistribute into an
    all-gather and a chunk (gloo has no all-to-all); within this context it
    issues DTensor's all-to-all op instead, whose fake kernel gives the
    shard's shape, so that the counter prices an all-to-all."""
    from torch.distributed.tensor import placement_types
    original = placement_types.shard_dim_alltoall

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = mesh.get_group(mesh_dim).group_name
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group)

    placement_types.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = original


# ---------------------------------------------------------------------------
# Step builders


def _options(cfg: ArchConfig, shape, mesh, policy: sh.Policy) -> dict:
    """The model's ``Options`` under ``policy``: the JAX Ctx's arguments."""
    from torch.distributed.tensor import Replicate, Shard
    B = shape.global_batch
    act = sh.placements(sh.act_spec(cfg, mesh, B, policy), mesh)
    opts = {"act_placements": act,
            "attn_impl": "chunked" if policy.chunked_attention else "dense"}
    dp = dp_axes(mesh)
    d_ax = "model" if cfg.d_model % axis_size(mesh, "model") == 0 else None
    if shape.step == StepKind.DECODE:
        opts["cache_update"] = "select" if policy.select_cache_update else "dus"
        opts["mixed_precision"] = policy.attn_mixed_precision
    if cfg.moe is not None and policy.shard_moe_dispatch:
        opts["moe_dispatch_placements"] = sh.placements((None, dp, d_ax), mesh)
    if cfg.moe is not None and policy.moe_local_dispatch and shape.step == StepKind.TRAIN:
        opts["moe_local_groups"] = axis_size(mesh, dp)
        opts["moe_group_placements"] = {
            "x": sh.placements((dp, None, d_ax), mesh),
            "dispatch": sh.placements((None, dp, d_ax), mesh)}
    del Replicate, Shard
    return opts


def build_step(cfg: ArchConfig, shape, mesh, policy: sh.Policy):
    """Returns ``run(counting)``: it builds the step's DTensors, runs the
    step once under ``counting()`` (inside a trace: what the step issues is
    counted, the set-up not) and returns the state the step keeps,
    {"params", and "opt" (train) or "cache"}."""
    B, S = shape.global_batch, shape.seq_len
    training = shape.step == StepKind.TRAIN
    pshapes = sh.param_shapes(cfg)
    pspecs = sh.param_specs(cfg, mesh, training=training, policy=policy, shapes=pshapes)
    bspecs = sh.batch_specs(cfg, shape, mesh)
    opts = _options(cfg, shape, mesh, policy)
    # the templates hold global shapes: made here, outside the trace's count
    inputs = input_specs(cfg, shape)

    if training:
        from repro_torch.train.optimizer import AdamWConfig, AdamWState
        from repro_torch.train.train_loop import make_train_step
        step_fn = make_train_step(cfg, AdamWConfig(), remat=True, **opts)

        def run(counting):
            params = distribute(pshapes, pspecs, mesh, requires_grad=True)
            opt = AdamWState(torch.zeros((), dtype=torch.int32),
                             distribute(pshapes, pspecs, mesh, dtype=torch.float32),
                             distribute(pshapes, pspecs, mesh, dtype=torch.float32))
            batch = distribute(inputs, bspecs, mesh)
            with counting():
                step_fn(params, opt, batch)
            return {"params": params, "opt": (opt.mu, opt.nu)}
        return run

    if shape.step == StepKind.PREFILL:
        tpl = cache_template(cfg, B, S)["layers"]
        cspecs = sh.cache_specs_for({"layers": tpl}, cfg, mesh, B, policy)["layers"]

        def run(counting):
            params = distribute(pshapes, pspecs, mesh)
            batch = distribute(inputs, bspecs, mesh)
            caches = distribute(tpl, cspecs, mesh)
            with torch.no_grad(), counting():
                _, out = T.prefill(params, cfg, batch, seq_len=S, caches=caches, **opts)
            return {"params": params, "cache": out}
        return run

    tpl = cache_template(cfg, B, S)              # DECODE: one token against seq_len
    cspecs = sh.cache_specs_for(tpl, cfg, mesh, B, policy)
    b_ax = dp_axes(mesh) if B % axis_size(mesh, dp_axes(mesh)) == 0 else None

    def run(counting):
        params = distribute(pshapes, pspecs, mesh)
        caches = distribute(tpl, cspecs, mesh)
        tokens = distribute(inputs["tokens"], (b_ax, None), mesh)
        with torch.no_grad(), counting():
            T.decode_step(params, cfg, tokens, S - 1, caches, **opts)
        return {"params": params, "cache": caches}
    return run


# ---------------------------------------------------------------------------
# Trace + analyse


def trace(cfg: ArchConfig, shape, mesh, policy: sh.Policy) -> Dict:
    """One step of ``cfg`` x ``shape`` on ``mesh`` under ``policy``, traced:
    {"flops", "bytes", "collectives" (a ``CollectiveStats``), "memory"
    (``memory_summary``)}, all per device."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ops, trace_ops
    trace_ops.register_shardings()
    trace_ops.register_aten_shardings()
    gc.collect()             # the peak counts what refcounts free, from a clean start
    run = build_step(cfg, shape, mesh, policy)
    counter = StepCounter(mesh)
    @contextlib.contextmanager
    def counting():
        counter.counting = True
        try:
            yield
        finally:
            counter.counting = False

    with ops.meta_trace(), implicit_replication(), _alltoall_kept(mesh), counter.mode:
        state = run(counting)
        held = {k: tree_bytes(v) for k, v in state.items()}
        del state
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": counter.log.stats(), "replicated_ops": dict(counter.replicated),
            "view_gathers": counter.view_gathers, "views_placed": counter.views_placed,
            "memory": memory_summary(counter, held)}


def tree_bytes(tree) -> int:
    """Bytes of one device's shards of a tree of DTensors (their local
    tensors), or of plain tensors."""
    total = 0

    def add(_path, t):
        nonlocal total
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()

    sh.walk(tree, add)
    return total


def memory_summary(counter: StepCounter, held: Dict[str, int]) -> Dict[str, float]:
    """One device's memory: the live-storage high-water mark of the step
    (``peak_bytes``, ``total_gb``) and the bytes of the state the step holds
    from end to end (``<name>_bytes``: parameters, optimizer moments,
    caches), each the local shards' sum."""
    out = {f"{k}_bytes": float(v) for k, v in held.items()}
    out["peak_bytes"] = float(counter.peak)
    out["total_gb"] = counter.peak / 1e9
    return out


def mesh_label(mesh) -> str:
    return "x".join(f"{n}{s}" for n, s in zip(mesh.mesh_dim_names, mesh.shape))


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             probes: bool = True, policy: Optional[sh.Policy] = None,
             verbose: bool = True, mesh=None, cfg: Optional[ArchConfig] = None,
             shape: Optional[InputShape] = None) -> Dict:
    """Dry-run one (architecture x input shape x mesh): trace the full model,
    then (optionally) the two probe depths, and build the roofline.  ``mesh``
    defaults to the production mesh, ``cfg`` to the registered config and
    ``shape`` to the registered shape of that name.  The record's
    ``REPLICATED``, ``"view gathers"`` and ``"views placed"`` sum over every
    trace of the pair; a pair with any op in the first fails
    (``require_placed``)."""
    policy = policy or sh.Policy()
    shape = shape or get_shape(shape_name)
    shape_name = shape.name
    cfg0 = cfg or get_arch(arch)
    cfg, variant_note = serving_variant(cfg0, shape)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh_label(mesh)
    chips = mesh.size()
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": chips, "note": variant_note,
                 "policy": dataclasses.asdict(policy)}
    # simlint: allow[wall-clock] trace_s measures the real time the trace takes
    t0 = time.time()
    counts = trace(cfg, shape, mesh, policy)
    # simlint: allow[wall-clock] trace_s measures the real time the trace takes
    rec["trace_s"] = time.time() - t0
    rec["memory"] = counts["memory"]
    coll = counts["collectives"]
    rec["cost"] = {"flops": counts["flops"], "bytes accessed": counts["bytes"],
                   "collective bytes": coll.bytes_per_chip,
                   "collective bytes by kind": coll.by_kind,
                   "collective bytes by axis": coll.by_axis,
                   "collective counts": coll.counts,
                   REPLICATED: dict(counts["replicated_ops"]),
                   "view gathers": counts["view_gathers"],
                   "views placed": counts["views_placed"]}
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] traced in "
              f"{rec['trace_s']:.1f}s  mem={rec['memory']['total_gb']:.2f}GB/dev "
              f"flops/dev={counts['flops']:.3e} coll={coll.bytes_per_chip:.3e}B")

    if probes:
        pts = []
        for n in probe_layer_counts(cfg):
            probe = trace(with_layers(cfg, n), shape, mesh, policy)
            for op, k in probe["replicated_ops"].items():
                rec["cost"][REPLICATED][op] = rec["cost"][REPLICATED].get(op, 0) + k
            rec["cost"]["view gathers"] += probe["view_gathers"]
            rec["cost"]["views placed"] += probe["views_placed"]
            pts.append(rl.probe_from_trace(n, probe))
            if verbose:
                print(f"    probe L={n}: flops={pts[-1].flops:.3e} "
                      f"coll={pts[-1].coll_bytes:.3e}B")
        totals = rl.extrapolate(pts[0], pts[1], cfg.n_layers)
        rec["probes"] = [dataclasses.asdict(p) for p in pts]
    else:
        totals = {"flops": counts["flops"], "bytes": counts["bytes"],
                  "coll": coll.bytes_per_chip, "coll_by_axis": dict(coll.by_axis)}
    roof = rl.build_roofline(
        arch, shape_name, mesh_name, chips, totals,
        model_flops(cfg, shape)["model_flops"],
        memory_per_chip_gb=rec["memory"]["total_gb"], notes=variant_note)
    rec["roofline"] = dataclasses.asdict(roof)
    if verbose:
        r = roof
        print(f"    roofline (H100 SXM data sheet, 700 W): compute={r.compute_s*1e3:.2f}ms "
              f"memory={r.memory_s*1e3:.2f}ms coll={r.collective_s*1e3:.2f}ms "
              f"-> {r.bottleneck}-bound, useful={r.useful_ratio:.2f}")
    return rec


def require_placed(rec: Dict) -> None:
    """Fail a pair whose trace ran an op replicated: DTensor had no rule to
    place it, so the op and every op after it on its outputs were counted
    whole on every rank, and the record's figures are not the step's."""
    ops = rec["cost"][REPLICATED]
    if ops:
        raise AssertionError(f"{rec['arch']} x {rec['shape']} x {rec['mesh']}: ops run "
                             f"replicated, DTensor has no rule for them: {ops}")


def save_record(rec: Dict, out_dir: str = RESULTS_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return path


def record_figures(rec: Dict) -> Dict[str, float]:
    """A record's figures by name: the peak, flops, bytes accessed and the
    collective bytes of each kind and each mesh axis, per device."""
    cost = rec["cost"]
    out = {"peak": rec["memory"]["peak_bytes"], "flops": cost["flops"],
           "bytes accessed": cost["bytes accessed"]}
    for group in ("collective bytes by kind", "collective bytes by axis"):
        out.update({f"{group.split()[-1]} {k}": v for k, v in cost[group].items()})
    return out


def compare_records(dir_a: str, dir_b: str, rtol: float = 0.01) -> int:
    """Print, for every record in both directories, the largest relative
    difference of ``record_figures`` (a figure one record lacks counts 0)
    and each record's replicated ops and view gathers, and every record only
    one directory holds; returns the number of pairs apart by more than
    ``rtol`` or missing from one side, at least 1 where the directories
    share no record."""
    in_a, in_b = set(os.listdir(dir_a)), set(os.listdir(dir_b))
    names = sorted(in_a & in_b)
    apart = len(in_a ^ in_b)
    print(f"pair | peak GB (A, B) | largest relative difference (figure) | "
          f"ops run replicated (A, B) | view gathers (A, B)")
    for name in names:
        with open(os.path.join(dir_a, name)) as f:
            a = json.load(f)
        with open(os.path.join(dir_b, name)) as f:
            b = json.load(f)
        fa, fb = record_figures(a), record_figures(b)
        diff, worst = max((abs(fa.get(k, 0.0) - fb.get(k, 0.0))
                           / max(abs(fa.get(k, 0.0)), abs(fb.get(k, 0.0)), 1e-300), k)
                          for k in sorted(set(fa) | set(fb)))
        apart += diff > rtol
        print(f"{a['arch']} x {a['shape']} | {fa['peak'] / 1e9:.2f}, {fb['peak'] / 1e9:.2f} | "
              f"{diff:.3g} ({worst}) | {a['cost'][REPLICATED]}, {b['cost'][REPLICATED]} | "
              f"{a['cost'].get('view gathers')}, {b['cost'].get('view gathers')}")
    for name in sorted(in_a ^ in_b):
        print(f"{name}: only in {dir_a if name in in_a else dir_b}")
    print(f"{len(names)} pairs in both, {len(in_a ^ in_b)} in one only, {apart} apart by "
          f"more than {rtol:g} or missing")
    return max(apart, int(not names))


OPTIMIZED_POLICY = sh.Policy(chunked_attention=True, moe_local_dispatch=True,
                             select_cache_update=True,
                             attn_mixed_precision=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-node dry run on a fake H100 mesh")
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="use the optimized policy instead of the baseline")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--compare", nargs=2, metavar=("DIR_A", "DIR_B"),
                    help="compare two directories of records (within 1 %%) and exit")
    args = ap.parse_args(argv)
    if args.compare:
        raise SystemExit(1 if compare_records(*args.compare) else 0)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    policy = OPTIMIZED_POLICY if args.optimized else None
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    # probes only make sense for the (single-pod) roofline
                    rec = run_pair(arch, shape, multi_pod=mp,
                                   probes=not args.no_probes and not mp, policy=policy)
                    save_record(rec, args.out)        # kept, so a failure can be read
                    require_placed(rec)
                except Exception as e:
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"FAILED [{arch} x {shape} x mp={mp}]: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
