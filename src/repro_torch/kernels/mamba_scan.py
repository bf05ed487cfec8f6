"""Wrapper of the CUDA selective-scan kernel ``csrc/mamba_scan.cu``.

Counterpart of the Pallas ``mamba_scan`` in the JAX package's
``kernels/mamba_scan.py``, with the signature of its plain oracle
``ref.mamba_scan_ref``: dt, dtx (B, S, di), Bm, Cm (B, S, ds), A (di, ds) and
an optional fp32 initial state h0 (B, di, ds) -> y (B, S, di) in dt.dtype and
the last state (B, di, ds) in fp32.  The kernels mask the tails of S and di
themselves, so nothing is padded here.

Two designs, each its own C entry point, chosen by :func:`route` from the
dtype and ds before the launch: ds a multiple of 4 takes ``"lanes"`` (ds
split across 1, 2 or 4 lanes of 4 state values, each lane holding 4
neighbouring channels, chunks of dt, dtx, B_t and C_t brought by bulk
copies, or cp.async words where rows are not 16-byte aligned, into a ring
in shared memory); any other ds takes ``"simt"`` (a thread per channel).  A
failed build or launch raises; no route stands in for another.
:func:`mamba_scan_simt` reaches the simt design for any ds, so that the two
can be timed against each other on the card.  ``LAUNCHES`` counts the launches of each route, and
:func:`lanes_geometry` is the lanes launch that the source makes.

The backward, :func:`mamba_scan_bwd`, two designs, each its own C entry
point, chosen by :func:`bwd_route` from the dtype and shape: ``"ring"``
(entry ``mamba_scan_bwd_ring``) where the rows are 16-byte aligned (di and ds
times the element size multiples of 16: every model shape): chunks of
``RING_CHUNK`` steps of dt, dtx, dy (TMA boxes of 64 channels), B_t, C_t and
the chunk's checkpoint (bulk copies) brought into a ring of ``RING_STAGES``
stages, in time order for the forward walk that writes the checkpoints and
in reverse for the walk back, whose recompute keeps a_t = exp(dt_t A) beside
h_{t-1} so that the walk back takes no exponential; ``"ckpt"`` (entry
``mamba_scan_bwd``, the previous
design, every ds the forward takes) for the other shapes, and reachable
through :func:`mamba_scan_bwd_ckpt`.  In both each channel walks forward once
writing its state every chunk, then walks the chunks back, recomputing each
chunk's states from its checkpoint; dB and dC (sums over channels) and dA
(over batch rows) are written as per-block partials and added in a fixed
order by a second kernel.  The checkpoints and the partials are scratch that
the wrapper allocates (:func:`bwd_scratch_shapes`).  ``BWD_LAUNCHES`` counts
the launches of each design.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPE_CODES, check_operands,
                                         raise_on_error, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_STATE = 16             # state values per channel the kernel keeps in registers
_GRID_LIMIT = 65535        # gridDim.y (B)
_INDEX_LIMIT = 2 ** 31     # S, di and ds are int in the kernel
#: the lanes design's constants (csrc/mamba_scan.cu, namespace lanes)
LANES_TILE = 128           # inner channels per block
LANES_GROUP = 4            # neighbouring channels per lane
LANES_CHUNK = 8            # time steps per stage of the ring
LANES_STAGES = 3           # stages of the ring
SMEM_LIMIT = 227 * 1024    # shared memory a block may have on Hopper

#: launches of each route
LAUNCHES: Dict[str, int] = {"lanes": 0, "simt": 0}
#: the backward's constants (csrc/mamba_scan.cu, namespaces bwd and ring)
BWD_CHUNK = 16             # ckpt: steps between checkpoints, recomputed at once
BWD_CHANNELS = 64          # channels per block, 4 lanes each
BWD_SLOTS = 32             # a step's partial per block: dC in 0..15, dB in 16..31
RING_CHUNK = 8             # ring: steps between checkpoints, a stage of the ring
RING_CHUNKS = (8, 16)      # the chunks the ring entry takes (8, the route's: two blocks an SM)
RING_STAGES = 3            # the chunk walked, two in flight
#: launches of the backward, by design
BWD_LAUNCHES: Dict[str, int] = {"ring": 0, "ckpt": 0}


def route(dtype: torch.dtype, ds: int) -> str:
    """The design a CUDA call takes: ``"lanes"`` for fp32 or bf16 with ds a
    multiple of 4 (4, 8, 12, 16), else ``"simt"``."""
    if dtype in (torch.float32, torch.bfloat16) and 0 < ds <= MAX_STATE and ds % 4 == 0:
        return "lanes"
    return "simt"


def bwd_route(dtype: torch.dtype, ds: int, di: int) -> str:
    """The backward's design: ``"ring"`` for fp32 or bf16 where di and ds
    times the element size are multiples of 16 bytes (the row strides of its
    TMA boxes and the runs of its bulk copies; ds 4, 8, 12, 16 in fp32, 8, 16
    in bf16), else ``"ckpt"`` for 0 < ds <= 16 (ds below 16 masked), the
    shapes the forward takes."""
    if dtype in (torch.float32, torch.bfloat16) and 0 < ds <= MAX_STATE:
        size = 4 if dtype == torch.float32 else 2
        return "ring" if (di * size) % 16 == 0 and (ds * size) % 16 == 0 else "ckpt"
    raise ValueError(f"mamba_scan_bwd: no design for {dtype} at ds {ds}")


def bwd_scratch_shapes(B: int, S: int, di: int, ds: int,
                       chunk: int = BWD_CHUNK) -> Dict[str, Tuple[int, ...]]:
    """The fp32 scratch of the backward: the checkpoints (a state of 16
    values, ds padded, per channel every ``chunk`` steps: ``BWD_CHUNK`` for
    ckpt, one of ``RING_CHUNKS`` for ring), the blocks' partials of dC and dB
    at every step, and the batch rows' partials of dA."""
    return {"ckpt": (B, -(-S // chunk), di, MAX_STATE),
            "bc_part": (B, -(-di // BWD_CHANNELS), S, BWD_SLOTS),
            "dA_part": (B, di, ds)}


def ring_smem_bytes_model(itemsize: int, chunk: int = RING_CHUNK) -> int:
    """Shared memory of one block of the ring backward (``ring::Smem``): the
    ring's stages (a chunk's TMA boxes of dt, dtx and dy, 64 channels by
    ``chunk`` steps, 128-byte aligned; its runs of B_t and C_t at 16 values a
    step; its checkpoint of 64 x 16 fp32), B_t and C_t in fp32 for two
    chunks, h_{t-1} at the chunk's steps after the first and a_t at each (a
    thread's 4 fp32 values), each warp's dC and dB sums for two chunks, and
    the stages' mbarriers."""
    if chunk not in RING_CHUNKS:
        raise ValueError(f"mamba_scan_bwd: the ring design takes chunk in {RING_CHUNKS}")
    threads = BWD_CHANNELS * 4
    boxes = 3 * RING_STAGES * chunk * BWD_CHANNELS * itemsize
    raw = (boxes + RING_STAGES * (2 * chunk * MAX_STATE * itemsize + 16 * threads)
           + 4 * 2 * 2 * chunk * MAX_STATE + 16 * threads * (2 * chunk - 1)
           + 4 * 2 * chunk * (threads // 32) * BWD_SLOTS + 8 * RING_STAGES)
    return 128 * -(-raw // 128)


class LanesGeometry(NamedTuple):
    lanes: int             # lanes per group of channels, each holding 4 state values
    block: int             # threads per block
    grid: Tuple[int, int]  # (channel tiles, batch rows)
    chunks: int            # chunks of LANES_CHUNK steps that cover S
    smem: int              # static shared memory per block, in bytes


def lanes_geometry(B: int, S: int, di: int, ds: int, itemsize: int) -> LanesGeometry:
    """The launch of the lanes design for these shapes and an element of
    ``itemsize`` bytes (4 or 2): the grid, the block, the chunks and the
    shared memory of ``lanes::Smem`` (a stage holds a chunk's dt and dtx,
    each a row of 128 channels and one 16-byte word of slack per step, and
    its B_t and C_t, each a run of 8 * 16 values and a word, and has an
    mbarrier; y is staged as fp32, twice)."""
    if ds % 4 or not 0 < ds <= MAX_STATE:
        raise ValueError(f"mamba_scan: the lanes design takes ds in (4, 8, 12, 16), got {ds}")
    lanes = 1 if ds <= 4 else 2 if ds <= 8 else 4
    vec = 16 // itemsize
    stage = itemsize * (2 * LANES_CHUNK * (LANES_TILE + vec) + 2 * (LANES_CHUNK * MAX_STATE + vec))
    barriers = 16 * -(-8 * LANES_STAGES // 16)   # one 8-byte mbarrier a stage, in 16 bytes
    smem = barriers + LANES_STAGES * stage + 4 * 2 * LANES_CHUNK * LANES_TILE
    return LanesGeometry(lanes, LANES_TILE // LANES_GROUP * lanes, (-(-di // LANES_TILE), B),
                         -(-S // LANES_CHUNK), smem)


def lanes_owner(g: LanesGeometry, bx: int, tid: int) -> Tuple[range, range]:
    """(inner channels, state values) that thread ``tid`` of block column
    ``bx`` holds in the lanes design: lane q = tid % lanes of the group of
    channels 128 bx + 4 (tid // lanes) .. + 3, states 4q .. 4q + 3 of each
    (those past di or ds are masked)."""
    q, c = tid % g.lanes, bx * LANES_TILE + LANES_GROUP * (tid // g.lanes)
    return range(c, c + LANES_GROUP), range(4 * q, 4 * q + 4)


@functools.cache
def _entry(which: str):
    fn = getattr(_build.load("mamba_scan"), f"mamba_scan_{which}_fwd")
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.cache
def _bwd_entry(which: str):
    lib = _build.load("mamba_scan")
    if which == "ring":
        fn, ints = lib.mamba_scan_bwd_ring, 7     # ..., ds, dtype, chunk, reuse
    else:
        fn, ints = lib.mamba_scan_bwd, 5
    fn.argtypes = [_P] * 17 + [_I] * ints + [_P]
    fn.restype = _I
    return fn


def ring_smem_bytes(dtype: torch.dtype, chunk: int = RING_CHUNK) -> int:
    """Shared memory of one block of the ring backward as the compiled
    source has it (builds the library)."""
    fn = _build.load("mamba_scan").mamba_scan_bwd_ring_smem_bytes
    fn.argtypes, fn.restype = [_I, _I], _I
    return fn(DTYPE_CODES[dtype], chunk)


def lanes_smem_bytes(dtype: torch.dtype) -> int:
    """Shared memory of one block of the lanes design as the compiled source
    has it (builds the library)."""
    fn = _build.load("mamba_scan").mamba_scan_lanes_smem_bytes
    fn.argtypes, fn.restype = [_I], _I
    return fn(DTYPE_CODES[dtype])


def check_inputs(dt: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, A: torch.Tensor,
                 h0: Optional[torch.Tensor]) -> None:
    """Raise ValueError on shapes, or a state, that the kernel does not take."""
    if dt.dim() != 3 or dtx.shape != dt.shape:
        raise ValueError("mamba_scan: dt and dtx must both be (B, S, di)")
    B, S, di = dt.shape
    if Bm.dim() != 3 or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape:
        raise ValueError(f"mamba_scan: Bm and Cm must both be (B, S, ds) with (B, S) = "
                         f"{(B, S)}, got {tuple(Bm.shape)} and {tuple(Cm.shape)}")
    ds = Bm.shape[2]
    if tuple(A.shape) != (di, ds):
        raise ValueError(f"mamba_scan: A must be (di, ds) = {(di, ds)}, got {tuple(A.shape)}")
    if not 0 < ds <= MAX_STATE:
        raise ValueError(f"mamba_scan: ds {ds} not supported (takes 1..{MAX_STATE})")
    if B > _GRID_LIMIT or max(S, di) >= _INDEX_LIMIT:
        raise ValueError("mamba_scan: B must be at most 65535, S and di below 2**31")
    if h0 is not None:
        if tuple(h0.shape) != (B, di, ds):
            raise ValueError(f"mamba_scan: h0 must be (B, di, ds) = {(B, di, ds)}, "
                             f"got {tuple(h0.shape)}")
        if h0.dtype != torch.float32:
            raise ValueError(f"mamba_scan: h0 must be float32, got {h0.dtype}")
        if h0.device != dt.device or not h0.is_contiguous() or h0.data_ptr() % 16:
            raise ValueError("mamba_scan: h0 must be contiguous, 16-byte aligned and on "
                             "the device of dt")


def mamba_scan(dt: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
               A: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel of :func:`route`: -> (y (B, S, di) in dt.dtype,
    h_last (B, di, ds) fp32).  An empty input returns without a launch; its
    state is h0 (or zeros)."""
    return _launch(None, dt, dtx, Bm, Cm, A, h0)


def mamba_scan_simt(dt: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    A: torch.Tensor, h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the simt design whatever ds (the previous design, kept to be
    timed beside the lanes one)."""
    return _launch("simt", dt, dtx, Bm, Cm, A, h0)


def _launch(which, dt: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
            A: torch.Tensor, h0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    check_operands("mamba_scan", dt, dtx, Bm, Cm, A)
    check_inputs(dt, dtx, Bm, Cm, A, h0)
    B, S, di = dt.shape
    ds = Bm.shape[2]
    y = torch.empty_like(dt)
    if y.numel() == 0:
        h = torch.zeros((B, di, ds), dtype=torch.float32, device=dt.device)
        return y, (h if h0 is None else h.copy_(h0))
    which = which or route(dt.dtype, ds)
    h_last = torch.empty((B, di, ds), dtype=torch.float32, device=dt.device)
    err = _entry(which)(dt.data_ptr(), dtx.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                        A.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
                        h_last.data_ptr(), B, S, di, ds, DTYPE_CODES[dt.dtype],
                        stream_handle(dt.device))
    raise_on_error(f"mamba_scan ({which})", err)
    LAUNCHES[which] += 1
    return y, h_last


def mamba_scan_bwd(dt: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   A: torch.Tensor, h0: Optional[torch.Tensor], dy: torch.Tensor,
                   dh_last: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The gradients of the scan given dy (B, S, di) in dt.dtype and dh_last
    (B, di, ds) fp32 or None: (ddt, ddtx, dB, dC, dA) in the inputs' dtype
    and dh0 (B, di, ds) fp32, as ``ref.mamba_scan_bwd_ref``, on the design of
    :func:`bwd_route`.  An empty input launches nothing."""
    return _launch_bwd(None, RING_CHUNK, True, dt, dtx, Bm, Cm, A, h0, dy, dh_last)


def mamba_scan_bwd_ckpt(dt, dtx, Bm, Cm, A, h0, dy, dh_last) -> Tuple[torch.Tensor, ...]:
    """The ckpt design whatever the shape (the previous design, kept to be
    timed beside the ring design)."""
    return _launch_bwd("ckpt", BWD_CHUNK, False, dt, dtx, Bm, Cm, A, h0, dy, dh_last)


def mamba_scan_bwd_ring(dt, dtx, Bm, Cm, A, h0, dy, dh_last, chunk: int = RING_CHUNK,
                        reuse: bool = True) -> Tuple[torch.Tensor, ...]:
    """The ring design with checkpoints every ``chunk`` steps (8, the
    route's, or 16), keeping a_t from the recompute for the walk back, or
    (``reuse`` False, for timing) taking it again there."""
    return _launch_bwd("ring", chunk, reuse, dt, dtx, Bm, Cm, A, h0, dy, dh_last)


def _launch_bwd(which, chunk, reuse, dt, dtx, Bm, Cm, A, h0, dy, dh_last
                ) -> Tuple[torch.Tensor, ...]:
    check_operands("mamba_scan_bwd", dt, dtx, Bm, Cm, A, dy)
    check_inputs(dt, dtx, Bm, Cm, A, h0)
    B, S, di = dt.shape
    ds = Bm.shape[2]
    if dy.shape != dt.shape:
        raise ValueError(f"mamba_scan_bwd: dy must be (B, S, di) = {tuple(dt.shape)}, "
                         f"got {tuple(dy.shape)}")
    if dh_last is not None:
        check_inputs(dt, dtx, Bm, Cm, A, dh_last)
    grads = tuple(torch.empty_like(t) for t in (dt, dtx, Bm, Cm, A))
    dh0 = torch.empty((B, di, ds), dtype=torch.float32, device=dt.device)
    if dt.numel() == 0:
        for g in grads:
            g.zero_()
        return (*grads, dh0.copy_(dh_last) if dh_last is not None else dh0.zero_())
    which = which or bwd_route(dt.dtype, ds, di)
    if which == "ring" and (bwd_route(dt.dtype, ds, di) != "ring" or chunk not in RING_CHUNKS):
        raise ValueError(f"mamba_scan_bwd: the ring design does not take {dt.dtype} at di "
                         f"{di}, ds {ds}, chunk {chunk}")
    if which == "ckpt":
        chunk = BWD_CHUNK
    scratch = {k: torch.empty(shape, dtype=torch.float32, device=dt.device)
               for k, shape in bwd_scratch_shapes(B, S, di, ds, chunk).items()}
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = [*map(ptr, (dt, dtx, Bm, Cm, A, h0, dy, dh_last, scratch["ckpt"], scratch["bc_part"],
                       scratch["dA_part"], *grads, dh0)), B, S, di, ds, DTYPE_CODES[dt.dtype]]
    if which == "ring":
        args += [chunk, int(reuse)]
    err = _bwd_entry(which)(*args, stream_handle(dt.device))
    raise_on_error(f"mamba_scan_bwd ({which})", err)
    BWD_LAUNCHES[which] += 1
    return (*grads, dh0)
