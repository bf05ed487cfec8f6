"""Wrapper of the CUDA wkv-recurrence kernel ``csrc/rwkv6_scan.cu``.

Counterpart of the Pallas ``rwkv6_scan`` in the JAX package's
``kernels/rwkv6_scan.py``, with the signature of its plain oracle
``ref.rwkv6_scan_ref``: r, k, v, w (B, T, H, hd), u (H, hd) and an optional
fp32 initial state S0 (B, H, hd, hd) -> o (B, T, H, hd) in r.dtype and the
last state (B, H, hd, hd) in fp32.  The kernels cover any T by bounds, so
nothing is padded here.

Two designs, each its own C entry point, chosen by :func:`route` before the
launch: fp32 and bf16 at every hd the kernels take (16, 32, 64) take
``"cols"`` (the rows of the state split into slices of 8 across the warps,
one or two columns a thread, the slices' parts of o summed through shared
memory, chunks of r, k, w and v brought by TMA into a ring there);
``"simt"`` (a thread per column) stays reachable through
:func:`rwkv6_scan_simt`, so that the two can be timed against each other on
the card.  A failed build or launch raises; no route stands in for another.
``LAUNCHES`` counts the launches of each route, and :func:`cols_geometry`
is the cols launch that the source makes.

The backward, :func:`rwkv6_scan_bwd`, two designs, each its own C entry
point, chosen by :func:`bwd_route`: ``"ring"`` (entry
``rwkv6_scan_bwd_ring``) at every hd the forward takes: a block of hd * hd /
8 threads per (batch row, head), each holding 8 values of a row of the state
and of its cotangent; chunks of ``RING_CHUNK`` steps of r, k, v, w and do
brought by TMA into a ring of ``RING_STAGES`` stages, in time order for a
forward sweep that only writes the state every ``RING_CHUNK`` steps, in
reverse for the walk back, which takes each chunk's checkpoint by a bulk
copy, recomputes its states in two levels (every ``RING_PIECE`` steps, then
each piece) and gives dr, dk, dv and dw.  ``"rows"`` (entry
``rwkv6_scan_bwd``, the previous design: 4 hd threads, a forward sweep for dr
checkpointing every ``BWD_CHUNK`` steps, chunks staged through registers)
stays reachable through :func:`rwkv6_scan_bwd_rows`.  du (a sum over batch
rows) is written as per-block partials and added in order by a second
kernel in both.  The checkpoints and the partials are scratch that the
wrapper allocates (:func:`bwd_scratch_shapes`).  ``BWD_LAUNCHES`` counts the
launches of each design.
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
HEAD_SIZES = (16, 32, 64)  # hd the kernels are instantiated for
_INDEX_LIMIT = 2 ** 31     # B * H blocks and the B * T steps (TMA's row index) are int
#: the cols design's constants (csrc/rwkv6_scan.cu, namespace cols)
COLS_CHUNK = 8             # time steps per stage of the ring
COLS_STAGES = 4            # stages of the ring
COLS_ROWS = 8              # rows i of the state per thread
SMEM_LIMIT = 227 * 1024    # shared memory a block may have on Hopper

#: launches of each route
LAUNCHES: Dict[str, int] = {"cols": 0, "simt": 0}
#: the rows backward's constants (csrc/rwkv6_scan.cu, namespace bwd)
BWD_CHUNK = 4              # steps between checkpoints, recomputed at once
#: the ring backward's constants (csrc/rwkv6_scan.cu, namespace ring)
RING_CHUNK = 16            # steps between checkpoints: a stage of the ring
RING_PIECE = 4             # steps recomputed at once into the history
RING_STAGES = 3            # the chunk walked, two in flight
RING_CHUNKS = (16, 4)      # the spacings the entry takes: the route's, and rows' for timing
#: launches of the backward, by design
BWD_LAUNCHES: Dict[str, int] = {"ring": 0, "rows": 0}


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward's design: ``"ring"`` for fp32 or bf16 with hd in
    ``HEAD_SIZES`` (``"rows"``, which takes the same, on its own entry)."""
    if dtype in (torch.float32, torch.bfloat16) and hd in HEAD_SIZES:
        return "ring"
    raise ValueError(f"rwkv6_scan_bwd: no design for {dtype} at hd {hd}")


def bwd_smem_bytes(hd: int) -> int:
    """Shared memory of one block of the rows backward (``bwd::Smem``): a
    chunk's k, v, w, do and r, the chunk's recomputed states (hd x hd fp32 a
    step), each warp's sums of dv at each step, and the chunk's dr, dk and
    dw."""
    chunk_rows = BWD_CHUNK * hd
    return 4 * (5 * chunk_rows + BWD_CHUNK * hd * hd + BWD_CHUNK * (hd // 8) * hd
                + 3 * chunk_rows)


def bwd_scratch_shapes(B: int, T: int, H: int, hd: int, design: str = "ring",
                       chunk: int = RING_CHUNK) -> Dict[str, Tuple[int, ...]]:
    """The fp32 scratch of a backward design: the checkpoints (the state
    every ``chunk`` steps for ``"ring"``, every ``BWD_CHUNK`` for ``"rows"``)
    and the (batch row, head) partials of du."""
    if design == "rows":
        chunk = BWD_CHUNK
    elif design != "ring" or chunk not in RING_CHUNKS:
        raise ValueError(f"rwkv6_scan_bwd: no design {design!r} with chunk {chunk}")
    return {"ckpt": (B, H, -(-T // chunk), hd, hd), "du_part": (B, H, hd)}


class RingGeometry(NamedTuple):
    lanes: int             # lanes of a row of the state, 8 values each
    block: int             # threads per block: a (batch row, head)
    grid: int              # blocks: batch rows x heads
    chunks: int            # chunks of `chunk` steps that cover T
    smem: int              # dynamic shared memory per block, in bytes


def _layout(fields) -> int:
    """Bytes of a C struct of (align, size) fields in order, padded to its
    largest alignment."""
    off, top = 0, 1
    for align, size in fields:
        off = -(-off // align) * align + size
        top = max(top, align)
    return -(-off // top) * top


def ring_geometry(B: int, T: int, H: int, hd: int, itemsize: int,
                  chunk: int = RING_CHUNK) -> RingGeometry:
    """The launch of the ring backward for these shapes and an element of
    ``itemsize`` bytes: hd / 8 lanes a row, hd * hd / 8 threads, one block
    per (batch row, head), and the shared memory of ``ring::Smem`` (the
    ring's stages of r, k, v, w, do; two checkpoint buffers; S at the
    chunk's pieces' first steps after the first, 8 fp32 values a thread;
    each warp's dv sums for two pieces; v . g and r . (u k) a step; the
    mbarriers).  A piece's other states are held in registers."""
    if hd not in HEAD_SIZES or chunk not in RING_CHUNKS:
        raise ValueError(f"rwkv6_scan_bwd: the ring design takes hd in {HEAD_SIZES} and "
                         f"chunk in {RING_CHUNKS}, got {hd}, {chunk}")
    lanes = hd // 8
    nt = hd * lanes
    n_sub = max(1, chunk // RING_PIECE - 1)
    smem = _layout([(128, RING_STAGES * 5 * chunk * hd * itemsize),
                    (16, 2 * hd * hd * 4),
                    (16, n_sub * 2 * nt * 16),
                    (16, 2 * RING_PIECE * (nt // 32) * hd * 4),
                    (4, 2 * RING_STAGES * chunk * 4),
                    (8, 8 * (RING_STAGES + 2))])
    return RingGeometry(lanes, nt, B * H, -(-T // chunk), smem)


def ring_owner(hd: int, tid: int) -> Tuple[int, Tuple[int, ...]]:
    """(row i, columns) of a head's state that thread ``tid`` of the ring
    design holds: row tid // (hd / 8), lane p = tid % (hd / 8), columns 4p ..
    4p + 3 and hd / 2 + 4p .. + 3, in the order of its 8 values."""
    lanes = hd // 8
    i, p = divmod(tid, lanes)
    return i, tuple(4 * p + (e >> 2) * (hd // 2) + (e & 3) for e in range(8))


def route(dtype: torch.dtype, hd: int) -> str:
    """The design a CUDA call takes: ``"cols"`` for fp32 or bf16 with hd in
    ``HEAD_SIZES``, else ``"simt"`` (which refuses such an hd too)."""
    if dtype in (torch.float32, torch.bfloat16) and hd in HEAD_SIZES:
        return "cols"
    return "simt"


class ColsGeometry(NamedTuple):
    columns: int           # neighbouring columns of the state per thread
    slices: int            # slices of COLS_ROWS rows, whose parts of o are summed
    block: int             # threads per block: a (batch row, head)
    grid: int              # blocks: batch rows x heads
    chunks: int            # chunks of COLS_CHUNK steps that cover T
    smem: int              # dynamic shared memory per block, in bytes


def cols_geometry(B: int, T: int, H: int, hd: int, itemsize: int) -> ColsGeometry:
    """The launch of the cols design for these shapes and an element of
    ``itemsize`` bytes (4 or 2): the block, the grid, the chunks and the
    shared memory of ``cols::Smem`` (a stage holds a chunk's r, k, w and v
    rows and has an mbarrier; each slice's part of o is kept as fp32 for two
    chunks)."""
    if hd not in HEAD_SIZES:
        raise ValueError(f"rwkv6_scan: the cols design takes hd in {HEAD_SIZES}, got {hd}")
    columns = 2 if hd == 64 else 1
    slices = hd // COLS_ROWS
    raw = (COLS_STAGES * 4 * COLS_CHUNK * hd * itemsize + 4 * 2 * slices * COLS_CHUNK * hd
           + 8 * COLS_STAGES)                  # and one 8-byte mbarrier a stage
    smem = 128 * -(-raw // 128)                # the struct is 128-byte aligned for TMA
    return ColsGeometry(columns, slices, slices * hd // columns, B * H, -(-T // COLS_CHUNK),
                        smem)


def cols_owner(g: ColsGeometry, hd: int, tid: int) -> Tuple[range, range]:
    """(columns j, rows i) of a head's state that thread ``tid`` holds in the
    cols design: rows 8 s .. 8 s + 7 of columns C l .. C l + C - 1, with s =
    tid // (hd / C) and l = tid % (hd / C), C = ``g.columns``."""
    lanes = hd // g.columns
    s, j0 = tid // lanes, g.columns * (tid % lanes)
    return range(j0, j0 + g.columns), range(COLS_ROWS * s, COLS_ROWS * (s + 1))


@functools.cache
def _entry(which: str):
    fn = getattr(_build.load("rwkv6_scan"), f"rwkv6_scan_{which}_fwd")
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.cache
def _bwd_entry(which: str):
    lib = _build.load("rwkv6_scan")
    if which == "ring":
        fn, ints = lib.rwkv6_scan_bwd_ring, 6     # ..., hd, dtype, chunk
    else:
        fn, ints = lib.rwkv6_scan_bwd, 5
    fn.argtypes = [_P] * 16 + [_I] * ints + [_P]
    fn.restype = _I
    return fn


def ring_smem_bytes(hd: int, dtype: torch.dtype, chunk: int = RING_CHUNK) -> int:
    """Shared memory of one block of the ring backward as the compiled
    source has it (builds the library)."""
    fn = _build.load("rwkv6_scan").rwkv6_scan_bwd_ring_smem_bytes
    fn.argtypes, fn.restype = [_I, _I, _I], _I
    return fn(hd, DTYPE_CODES[dtype], chunk)


def cols_smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Shared memory of one block of the cols design as the compiled source
    has it (builds the library)."""
    fn = _build.load("rwkv6_scan").rwkv6_scan_cols_smem_bytes
    fn.argtypes, fn.restype = [_I, _I], _I
    return fn(hd, DTYPE_CODES[dtype])


def check_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, S0: Optional[torch.Tensor]) -> None:
    """Raise ValueError on shapes, or a state, that the kernel does not take."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError("rwkv6_scan: r, k, v and w must all be (B, T, H, hd)")
    B, T, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"rwkv6_scan: u must be (H, hd) = {(H, hd)}, got {tuple(u.shape)}")
    if hd not in HEAD_SIZES:
        raise ValueError(f"rwkv6_scan: head size {hd} not supported (takes {HEAD_SIZES})")
    if B * H >= _INDEX_LIMIT or B * T >= _INDEX_LIMIT:
        raise ValueError("rwkv6_scan: B * H and B * T must be below 2**31")
    if S0 is not None:
        if tuple(S0.shape) != (B, H, hd, hd):
            raise ValueError(f"rwkv6_scan: S0 must be (B, H, hd, hd) = {(B, H, hd, hd)}, "
                             f"got {tuple(S0.shape)}")
        if S0.dtype != torch.float32:
            raise ValueError(f"rwkv6_scan: S0 must be float32, got {S0.dtype}")
        if S0.device != r.device or not S0.is_contiguous() or S0.data_ptr() % 16:
            raise ValueError("rwkv6_scan: S0 must be contiguous, 16-byte aligned and on "
                             "the device of r")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, S0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel of :func:`route`: -> (o (B, T, H, hd) in r.dtype,
    S_last (B, H, hd, hd) fp32).  An empty input returns without a launch;
    its state is S0 (or zeros)."""
    return _launch(None, r, k, v, w, u, S0)


def rwkv6_scan_simt(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, S0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the simt design (the previous design, kept to be timed beside
    the cols one)."""
    return _launch("simt", r, k, v, w, u, S0)


def _launch(which, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, S0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    check_operands("rwkv6_scan", r, k, v, w, u)
    check_inputs(r, k, v, w, u, S0)
    B, T, H, hd = r.shape
    o = torch.empty_like(r)
    if o.numel() == 0:
        S = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
        return o, (S if S0 is None else S.copy_(S0))
    which = which or route(r.dtype, hd)
    S_last = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    err = _entry(which)(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                        u.data_ptr(), None if S0 is None else S0.data_ptr(), o.data_ptr(),
                        S_last.data_ptr(), B, T, H, hd, DTYPE_CODES[r.dtype],
                        stream_handle(r.device))
    raise_on_error(f"rwkv6_scan ({which})", err)
    LAUNCHES[which] += 1
    return o, S_last


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   u: torch.Tensor, S0: Optional[torch.Tensor], do: torch.Tensor,
                   dS_last: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The gradients of the recurrence given do (B, T, H, hd) in r.dtype and
    dS_last (B, H, hd, hd) fp32 or None: (dr, dk, dv, dw, du) in the inputs'
    dtype and dS0 (B, H, hd, hd) fp32, as ``ref.rwkv6_scan_bwd_ref``, on the
    design of :func:`bwd_route`.  An empty input launches nothing."""
    return _launch_bwd(None, RING_CHUNK, r, k, v, w, u, S0, do, dS_last)


def rwkv6_scan_bwd_rows(r, k, v, w, u, S0, do, dS_last) -> Tuple[torch.Tensor, ...]:
    """The rows design (the previous one, kept to be timed beside the ring
    design)."""
    return _launch_bwd("rows", BWD_CHUNK, r, k, v, w, u, S0, do, dS_last)


def rwkv6_scan_bwd_ring(r, k, v, w, u, S0, do, dS_last,
                        chunk: int = RING_CHUNK) -> Tuple[torch.Tensor, ...]:
    """The ring design with checkpoints every ``chunk`` steps (16, the
    route's; 4, one level, for timing)."""
    return _launch_bwd("ring", chunk, r, k, v, w, u, S0, do, dS_last)


def _launch_bwd(which, chunk, r, k, v, w, u, S0, do, dS_last) -> Tuple[torch.Tensor, ...]:
    check_operands("rwkv6_scan_bwd", r, k, v, w, u, do)
    check_inputs(r, k, v, w, u, S0)
    B, T, H, hd = r.shape
    if do.shape != r.shape:
        raise ValueError(f"rwkv6_scan_bwd: do must be (B, T, H, hd) = {tuple(r.shape)}, "
                         f"got {tuple(do.shape)}")
    if dS_last is not None:
        check_inputs(r, k, v, w, u, dS_last)
    grads = tuple(torch.empty_like(t) for t in (r, k, v, w, u))
    dS0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if r.numel() == 0:
        for g in grads:
            g.zero_()
        return (*grads, dS0.copy_(dS_last) if dS_last is not None else dS0.zero_())
    which = which or bwd_route(r.dtype, hd)
    scratch = {n: torch.empty(shape, dtype=torch.float32, device=r.device)
               for n, shape in bwd_scratch_shapes(B, T, H, hd, which, chunk).items()}
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = [*map(ptr, (r, k, v, w, u, S0, do, dS_last, scratch["ckpt"], scratch["du_part"],
                       *grads, dS0)), B, T, H, hd, DTYPE_CODES[r.dtype]]
    if which == "ring":
        args.append(chunk)
    err = _bwd_entry(which)(*args, stream_handle(r.device))
    raise_on_error(f"rwkv6_scan_bwd ({which})", err)
    BWD_LAUNCHES[which] += 1
    return (*grads, dS0)
