"""Sharding policies: the per-dimension mesh axes of every parameter,
activation, batch and cache tensor, per (architecture x input shape x mesh).

Counterpart of the JAX package's ``distributed/sharding.py``, with the same
rule engine: a name-based rule per leaf with divisibility fallbacks (a
dimension is sharded only where the axis size divides it, otherwise the next
candidate or replication is taken), tensor parallelism over ``"model"`` on
the wide dimension (``_COL_PARALLEL`` on the last, ``_ROW_PARALLEL`` on the
second to last), FSDP over the data-parallel axes for training, and expert
parallelism on the expert dimension of the MoE weights when the policy asks.

A spec is a tuple with one entry per tensor dimension: ``None``, a mesh
axis name, or a tuple of axis names (the dimension split over several
axes, major first), what a JAX ``PartitionSpec`` holds.  ``placements``
turns a spec into the DTensor placements of a ``DeviceMesh``, one
``Shard(dim)`` or ``Replicate()`` per mesh dimension, where the JAX package
builds a ``NamedSharding``.  The rules walk the port's parameter and cache
trees, whose keys are JAX's; the port's cache tree has one leaf more,
``"cross_valid"`` (B, T) bool, which takes ``"enc_mask"``'s rule.

A mesh here is anything with ``mesh_dim_names`` and a ``shape`` tuple: a
``torch.distributed.DeviceMesh`` (``launch.mesh``) or a stand-in of the same
form, enough to compute specs without a process group.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.config import ArchConfig, InputShape, StepKind
from repro_torch.launch.mesh import axis_size, dp_axes

# weight matrices whose LAST dim is the "wide"/output dim -> TP on last
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "cm_wk", "wg", "wr",
                 "in_proj", "x_proj", "dt_proj_w", "frontend_proj", "lm_head"}
# matrices whose second-to-last dim is the contracted/wide dim -> TP on -2
_ROW_PARALLEL = {"wo", "w_down", "cm_wv", "out_proj"}
# per-channel vectors over d_inner / heads
_DI_VECTORS = {"conv_b", "D", "dt_proj_b"}


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


@dataclasses.dataclass(frozen=True)
class Policy:
    """Tunable knobs: ``launch.perf`` flips these."""
    fsdp: bool = True                 # shard weights over dp for training
    act_model_sharded: bool = True    # activations d-sharded between blocks
    seq_sharded_cache: bool = True    # KV seq over 'model' (vs replicated)
    vocab_sharded_logits: bool = True
    chunked_attention: bool = False   # query-chunked online-softmax attention
    moe_expert_parallel: bool = False # shard the expert dim over 'model'
    select_cache_update: bool = False # arange==slot KV write (layout-preserving)
    attn_mixed_precision: bool = False # bf16 products, fp32 accumulation
    shard_moe_dispatch: bool = False  # place the (E,C,d) dispatch over dp
    moe_local_dispatch: bool = False  # per-data-shard routing (production)


def walk(tree, fn, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` on every leaf of a tree of dicts and tuples, keeping
    its structure; ``path`` holds the dict keys and the tuple indices (as
    strings) from the root, as a JAX key path names them."""
    if isinstance(tree, dict):
        return {k: walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(walk(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_shapes(cfg: ArchConfig):
    """The parameter tree of ``transformer.init_params(cfg)`` as meta tensors
    (shape and dtype, no storage), drawn under ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import transformer as T
    with FakeTensorMode():
        fake = T.init_params(cfg, torch.Generator().manual_seed(0))
    return walk(fake, lambda _p, t: torch.empty(t.shape, dtype=t.dtype, device="meta"))


def param_specs(cfg: ArchConfig, mesh, *, training: bool,
                policy: Policy = Policy(), shapes=None):
    """Spec tree matching ``transformer.init_params(cfg)``; ``shapes`` is
    ``param_shapes(cfg)``, computed when not given."""
    if shapes is None:
        shapes = param_shapes(cfg)
    model_n = axis_size(mesh, "model")
    dp = dp_axes(mesh)
    dp_n = axis_size(mesh, dp)
    use_fsdp = policy.fsdp and training

    def base_rule(name: str, shape: Tuple[int, ...]) -> list:
        """Spec for the *unstacked* trailing dims of a leaf."""
        nd = len(shape)

        def fs(dim_size):  # fsdp candidate on a dim
            return dp if (use_fsdp and _divides(dim_size, dp_n)) else None

        if name == "embed":
            spec = [None, None]
            if _divides(shape[1], model_n):
                spec[1] = "model"
            if use_fsdp and _divides(shape[0], dp_n):
                spec[0] = dp
            return spec
        if name == "lm_head":
            if policy.vocab_sharded_logits and _divides(shape[-1], model_n):
                return [fs(shape[0]), "model"]
            if _divides(shape[0], model_n):
                return ["model", fs(shape[1])]
            return [None, None]
        if name == "A_log":      # (di, ds)
            return ["model" if _divides(shape[0], model_n) else None, None]
        if name in _DI_VECTORS:  # (di,)
            return ["model" if _divides(shape[-1], model_n) else None]
        if name == "conv_w":     # (d_conv, di)
            return [None, "model" if _divides(shape[-1], model_n) else None]
        if name == "bonus_u":    # (H, hd)
            return ["model" if _divides(shape[0], model_n) else None, None]
        if name == "router":
            return [None] * nd
        if name in _COL_PARALLEL:
            spec = [None] * nd
            if _divides(shape[-1], model_n):
                spec[-1] = "model"
                if use_fsdp and _divides(shape[-2], dp_n):
                    spec[-2] = dp
            elif _divides(shape[-2], model_n):
                spec[-2] = "model"
            return spec
        if name in _ROW_PARALLEL:
            spec = [None] * nd
            if _divides(shape[-2], model_n):
                spec[-2] = "model"
                if use_fsdp and _divides(shape[-1], dp_n):
                    spec[-1] = dp
            return spec
        # norms, mu_*, decay_base, ln_x, scalars: replicate
        return [None] * nd

    def rule(names, leaf) -> tuple:
        name = names[-1]
        # block params are stacked over the group dim: never sharded
        stacked = any(n in ("blocks", "enc_blocks") for n in names)
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        # expert parallelism: shard the expert dim instead of TP-on-f
        if (policy.moe_expert_parallel and "moe" in names
                and name in ("w_gate", "w_up", "w_down")
                and shape and _divides(shape[0], model_n)):
            spec = ["model"] + [None] * (len(shape) - 1)
        else:
            spec = base_rule(name, shape) if shape else []
        if stacked:
            spec = [None] + spec
        return tuple(spec)

    return walk(shapes, rule)


def act_spec(cfg: ArchConfig, mesh, batch: int, policy: Policy = Policy()) -> tuple:
    """Between-block activation spec (B, S, d)."""
    model_n = axis_size(mesh, "model")
    dp = dp_axes(mesh)
    dp_n = axis_size(mesh, dp)
    b = dp if _divides(batch, dp_n) else None
    d = "model" if (policy.act_model_sharded and _divides(cfg.d_model, model_n)) else None
    return (b, None, d)


def batch_specs(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    """Specs for the input batch dict (matches ``dryrun.input_specs``)."""
    dp = dp_axes(mesh)
    dp_n = axis_size(mesh, dp)
    b = dp if _divides(shape.global_batch, dp_n) else None
    specs = {}
    if cfg.frontend is not None and cfg.encdec is None:
        specs["embeds"] = (b, None, None)
    else:
        specs["tokens"] = (b, None)
    if cfg.encdec is not None:
        specs["enc_embeds"] = (b, None, None)
    if shape.step == StepKind.TRAIN:
        specs["labels"] = (b, None)
    return specs


def _dp_list(dp) -> list:
    return [dp] if isinstance(dp, str) else list(dp)


def cache_specs_for(tree, cfg: ArchConfig, mesh, batch: int,
                    policy: Policy = Policy()):
    """Spec tree for a cache tree (``prefill``'s: {'layers': ..., 'cross_kv':
    ..., 'cross_valid': ...}).  Layer and cross leaves carry a leading
    n_groups dim (never sharded)."""
    model_n = axis_size(mesh, "model")
    dp = dp_axes(mesh)
    dp_n = axis_size(mesh, dp)
    b = dp if _divides(batch, dp_n) else None

    def seq_spec(cap: int):
        """Axes for the sequence dim: dp lands here when the batch can't
        absorb it (long-context batch=1), plus 'model' when enabled."""
        axes = []
        if b is None:
            axes.extend(_dp_list(dp))
        if policy.seq_sharded_cache:
            axes.append("model")
        while axes:
            n = 1
            for a in axes:
                n *= axis_size(mesh, a)
            if _divides(cap, n):
                break
            axes.pop()            # drop minor axes until it divides
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]

    def rule(names, leaf) -> tuple:
        name = names[-1]
        shape = leaf.shape
        if "cross_kv" in names:   # (g, B, T, Hkv, hd)
            return (None, b, seq_spec(shape[2]), None, None)
        if name in ("enc_mask", "cross_valid"):   # (B, T)
            return (b, None)
        if name in ("k", "v"):    # (g, B, cap, Hkv, hd)
            return (None, b, seq_spec(shape[2]), None, None)
        if name == "h":           # mamba (g, B, di, ds)
            return (None, b, "model" if _divides(shape[2], model_n) else None, None)
        if name == "conv":        # (g, B, dconv-1, di)
            return (None, b, None, "model" if _divides(shape[3], model_n) else None)
        if name == "wkv":         # (g, B, H, hd, hd)
            return (None, b, "model" if _divides(shape[2], model_n) else None, None, None)
        if name in ("shift_tm", "shift_cm"):   # (g, B, 1, d)
            return (None, b, None, "model" if _divides(shape[3], model_n) else None)
        return (None,) * len(shape)

    return walk(tree, rule)


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` where tensor dimension d names its axis, else
    ``Replicate()``.  A dimension split over several axes names them in the
    mesh's order, which is the order DTensor shards it in."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for d, ax in enumerate(spec):
        axes = () if ax is None else ((ax,) if isinstance(ax, str) else tuple(ax))
        names = list(mesh.mesh_dim_names)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {spec}: axis {a!r} shards two dimensions")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


def leaf_at(tree, path: Tuple[str, ...]):
    """The entry of a tree at a ``walk`` path: a spec tree is read with the
    paths of the tree it was computed from, its spec tuples being leaves."""
    for k in path:
        tree = tree[int(k)] if isinstance(tree, tuple) else tree[k]
    return tree
