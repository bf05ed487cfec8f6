"""Wrapper of the CUDA AdamW kernel ``csrc/adamw.cu``.

No TPU kernel: the counterpart of XLA's fusion of the JAX package's
``apply_updates`` (``train/optimizer.py``) inside its jitted train step.
Plain version: ``ref.adamw_update_ref``.

:func:`adamw_update` takes the leaves as lists (parameters and gradients
in bf16 or fp32, a gradient in its parameter's dtype; fp32 moments), the
step counter (a () int32 tensor, already advanced to the step being taken)
and the learning rate (a () fp32 tensor), all on one card, and launches two
C entry points on the current stream: ``adamw_sumsq`` (a launch per table,
then one block that sums the partials in a fixed order into the norm) and
``adamw_update`` (a launch per table).  A table of at most ``MAX_LEAVES``
leaves travels by value in its launch's parameters, so nothing is copied to
the card and a CUDA graph captures the launches whole.  Each table is
walked in tiles of ``TILE`` elements (:func:`tile_starts`) by a persistent
grid of :func:`grid_size` blocks.  A failed build or launch raises.
``LAUNCHES`` counts the launches of each entry point's kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import raise_on_error, stream_handle

#: csrc/adamw.cu's constants
MAX_LEAVES = 64            # leaves a table (a launch) holds
THREADS = 256
VEC = 8                    # consecutive elements a thread a tile
TILE = THREADS * VEC
BLOCKS_PER_SM = 4          # the persistent grid
TABLE_BYTES = 3344         # sizeof(Table), static_assert-ed in the source
FLAG_BF16, FLAG_DECAY, FLAG_ALIGNED = 1, 2, 4

#: launches of each kernel: the sums of squares (one a table), the norm
#: (one a call) and the update (one a table)
LAUNCHES: Dict[str, int] = {"sumsq": 0, "norm": 0, "update": 0}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


class Table(ctypes.Structure):
    """``Table`` of ``csrc/adamw.cu``, field for field."""
    _fields_ = [("tile_start", ctypes.c_longlong * (MAX_LEAVES + 1)),
                ("numel", ctypes.c_longlong * MAX_LEAVES),
                ("g", _P * MAX_LEAVES),
                ("p", _P * MAX_LEAVES),
                ("m", _P * MAX_LEAVES),
                ("v", _P * MAX_LEAVES),
                ("n_leaves", _I),
                ("flags", _I * MAX_LEAVES)]


def leaf_tiles(numel: int) -> int:
    return -(-numel // TILE)


def split_tables(numels: Sequence[int]) -> List[List[int]]:
    """The leaves (indices into ``numels``) of each launch, in order: at
    most ``MAX_LEAVES`` a table, the empty leaves left out."""
    live = [i for i, n in enumerate(numels) if n > 0]
    return [live[i:i + MAX_LEAVES] for i in range(0, len(live), MAX_LEAVES)]


def tile_starts(numels: Sequence[int]) -> List[int]:
    """``Table.tile_start`` of a table of leaves with ``numels`` elements:
    the tiles of the leaves before each one, then the table's total."""
    starts = [0]
    for n in numels:
        starts.append(starts[-1] + leaf_tiles(n))
    return starts


def grid_size(tiles: int, sms: int) -> int:
    """Blocks of a launch over ``tiles`` > 0 tiles; block b walks tiles b,
    b + grid, b + 2 grid, ..."""
    return max(1, min(tiles, sms * BLOCKS_PER_SM))


def leaf_flags(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor) -> int:
    flags = FLAG_BF16 if p.dtype == torch.bfloat16 else 0
    if p.dim() >= 2:      # decay matrices only (norms/embedding-scales exempt)
        flags |= FLAG_DECAY
    if all(t.data_ptr() % 16 == 0 for t in (p, g, m, v)):
        flags |= FLAG_ALIGNED
    return flags


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry(name: str):
    fn = getattr(_build.load("adamw"), name)
    if name == "adamw_sumsq":
        fn.argtypes = [_P, _I, _P, _P, _P, _P]
    else:
        fn.argtypes = [_P, _I, _P, _P, _P, _P, _D, _D, _D, _D, _D, _P]
    fn.restype = ctypes.c_int
    return fn


def check_leaves(params, grads, mu, nu, step: torch.Tensor, lr: torch.Tensor) -> None:
    """Raise ValueError unless the lists have one length, every tensor is a
    contiguous tensor on one CUDA device, each parameter is bf16 or fp32 with
    a gradient of its dtype and shape and fp32 moments of its shape, the
    step a () int32 tensor and the learning rate a () fp32 tensor."""
    if not len(params) == len(grads) == len(mu) == len(nu) or not params:
        raise ValueError("adamw: params, grads, mu and nu must be lists of one length > 0")
    device = params[0].device
    if device.type != "cuda":
        raise ValueError(f"adamw: the kernel takes CUDA tensors, got {device}")
    for name, t, dtype in (("step", step, torch.int32), ("lr", lr, torch.float32)):
        if t.device != device or t.dtype != dtype or t.dim() != 0:
            raise ValueError(f"adamw: {name} must be a () {dtype} tensor on {device}")
    for i, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        if p.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"adamw: leaf {i}: dtype {p.dtype} not supported "
                             "(takes torch.float32, torch.bfloat16)")
        if g.dtype != p.dtype or m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"adamw: leaf {i}: the gradient must have its parameter's dtype "
                             "and the moments must be fp32")
        for t in (p, g, m, v):
            if t.device != device:
                raise ValueError(f"adamw: leaf {i}: operands on more than one device")
            if t.shape != p.shape:
                raise ValueError(f"adamw: leaf {i}: shapes {tuple(p.shape)} and "
                                 f"{tuple(t.shape)} differ")
            if not t.is_contiguous():
                raise ValueError(f"adamw: leaf {i}: operands must be contiguous")


def _tables(params, grads, mu, nu):
    """The ctypes tables of the leaves and each launch's grid."""
    sms = _sms(params[0].device.index)
    groups = split_tables([p.numel() for p in params])
    tables = (Table * len(groups))()
    grids = (_I * len(groups))()
    for k, leaves in enumerate(groups):
        t = tables[k]
        numels = [params[i].numel() for i in leaves]
        starts = tile_starts(numels)
        t.n_leaves = len(leaves)
        t.tile_start[:len(starts)] = starts
        for j, i in enumerate(leaves):
            p, g, m, v = params[i], grads[i], mu[i], nu[i]
            t.numel[j] = numels[j]
            t.g[j], t.p[j], t.m[j], t.v[j] = (g.data_ptr(), p.data_ptr(), m.data_ptr(),
                                              v.data_ptr())
            t.flags[j] = leaf_flags(p, g, m, v)
        grids[k] = grid_size(starts[-1], sms)
    return tables, grids, len(groups)


def adamw_update(params, grads, mu, nu, step: torch.Tensor, lr: torch.Tensor, *,
                 b1: float, b2: float, eps: float, weight_decay: float,
                 grad_clip: float) -> Tuple[torch.Tensor, int]:
    """The update of ``ref.adamw_update_ref`` on the card, in place.  Returns
    the gradients' global norm before clipping (a () fp32 tensor) and the
    number of kernel launches."""
    check_leaves(params, grads, mu, nu, step, lr)
    device = params[0].device
    tables, grids, n = _tables(params, grads, mu, nu)
    partials = torch.empty(sum(grids), dtype=torch.float64, device=device)
    gnorm = torch.empty((), dtype=torch.float32, device=device)
    stream = stream_handle(device)
    raise_on_error("adamw (sumsq)", _entry("adamw_sumsq")(
        ctypes.addressof(tables), n, ctypes.addressof(grids), partials.data_ptr(),
        gnorm.data_ptr(), stream))
    raise_on_error("adamw (update)", _entry("adamw_update")(
        ctypes.addressof(tables), n, ctypes.addressof(grids), gnorm.data_ptr(),
        step.data_ptr(), lr.data_ptr(), b1, b2, eps, weight_decay, grad_clip, stream))
    LAUNCHES["sumsq"] += n
    LAUNCHES["norm"] += 1
    LAUNCHES["update"] += n
    return gnorm, 2 * n + 1
