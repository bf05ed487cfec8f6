"""Wrapper of the CUDA expert-batched matmul kernel ``csrc/moe_gmm.cu``.

Counterpart of the Pallas ``moe_gmm`` in the JAX package's
``kernels/moe_gmm.py``: x (E, C, D), w (E, D, F) -> y (E, C, F) in x.dtype,
summed in fp32 and rounded once.  The kernels mask the tails of C, D and F
themselves, so nothing is padded here.

Three designs, each its own C entry point, chosen by :func:`route` from the
dtype and shape before the launch.  bf16 with D and F multiples of 8 (TMA's
16-byte row strides) takes ``"stream"`` for ``C <= STREAM_MAX_C`` (the
decode shapes: w streamed through a deep TMA ring by persistent blocks, fp32
sums on the CUDA cores) and ``"wgmma"`` for ``C >= WGMMA_MIN_C`` (the
prefill shapes: Hopper's tensor cores, TMA loads, warp-specialised,
persistent); everything else -- C between the two, ragged D or F, fp32 --
takes ``"mma_sync"`` (bf16 on ``mma.sync``, fp32 on the CUDA cores, never
TF32).  A failed build or launch raises; no route stands in for another.
:func:`moe_gmm_mma_sync`, :func:`moe_gmm_wgmma` and :func:`moe_gmm_stream`
reach each design at any shape it takes, so that they can be timed against
each other on the card.  ``LAUNCHES`` counts the launches of each route.

The backward, :func:`moe_gmm_bwd`: dx[e] = dy[e] w[e]^T and dw[e] = x[e]^T
dy[e], each summed in fp32 and rounded once, routed by :func:`bwd_route`.
Both products have a design of their own: two-block clusters sharing an
operand tile by TMA multicast, the tiles stored by TMA.  Where the wgmma
design takes dx's shape, dx reads w transposed, no copy of w: on
``"wgmma_nt"`` (``moe_gmm_dx_wgmma_nt``, the backward's design) where C's
128-row tiles pair up (an even count), else on ``"wgmma_nt_fwd"`` (the
forward's wgmma design reading w transposed, ``moe_gmm_wgmma_nt_fwd``,
which beat the backward's design's pairing of column tiles at Jamba's C =
640 on the H100); otherwise
dx is a forward product of dy and a copy of w laid out (E, F, D).  dw
takes ``"wgmma_tn"`` for bf16 with D and F multiples of 8 and D >=
``WGMMA_MIN_C`` (``moe_gmm_dw_wgmma_tn``: x and dy read through the
transpose bits where they lie, at any C); otherwise dw is a forward product
of a copy of x laid out (E, D, C) and dy on the design of :func:`route` at
its own shape.  The copies are made by the source's tiled transpose kernel
(``moe_gmm_transpose``).  :func:`moe_gmm_dx` and :func:`moe_gmm_dw` reach
each product alone, and :func:`moe_gmm_dx_previous` (``wgmma_nt_fwd`` at
any shape it takes) and :func:`moe_gmm_dw_transposed` (the forward's design
over a copy of x) the previous designs, to be timed on the card.
``BWD_LAUNCHES`` counts the backward's products by product and route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPE_CODES, check_operands,
                                         raise_on_error, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
_GRID_LIMIT = 65535        # gridDim.y (C / 64) and gridDim.z (E)
_INDEX_LIMIT = 2 ** 31     # C, D and F are int in the kernel
#: the least C (rows per expert) that takes the wgmma design.  Set by scope,
#: not by speed: no serving path has C between STREAM_MAX_C and 64;
#: chip_smoke.py times the three designs from C = 1 to 64.
WGMMA_MIN_C = 64
#: the most C that the stream kernel is instantiated for
STREAM_KERNEL_MAX_C = 8
#: the most C that routes to the stream design: the decode shapes (C = 1 or
#: 2 at batch 8) and up to where chip_smoke.py's C sweep (H100, mixtral's
#: gate/up widths) finds it ahead of mma_sync, which takes C = 7 to 63; at
#: C = 8 its fp32 multiply-adds bound it, 8 per weight
STREAM_MAX_C = 6

#: rows of C in a tile of the backward's design: its clusters pair them
DX_ROWS = 128

#: launches of each route
LAUNCHES: Dict[str, int] = {"stream": 0, "wgmma": 0, "mma_sync": 0}
#: launches of the backward's two products, by route: "dx_wgmma", "dw_mma_sync", ...
BWD_LAUNCHES: Dict[str, int] = {"dx_wgmma_nt": 0, "dw_wgmma_tn": 0, "dx_wgmma_nt_fwd": 0,
                                **{f"{part}_{r}": 0 for part in ("dx", "dw")
                                   for r in ("stream", "wgmma", "mma_sync")}}


def route(dtype: torch.dtype, C: int, D: int, F: int) -> str:
    """The design a CUDA call takes: for bf16 with D, F multiples of 8,
    ``"stream"`` when C <= ``STREAM_MAX_C`` and ``"wgmma"`` when C >=
    ``WGMMA_MIN_C``; else ``"mma_sync"``."""
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0:
        if C <= STREAM_MAX_C:
            return "stream"
        if C >= WGMMA_MIN_C:
            return "wgmma"
    return "mma_sync"


def bwd_route(dtype: torch.dtype, C: int, D: int, F: int) -> Tuple[str, str]:
    """The designs of the backward's two products for x (E, C, D), w (E, D,
    F): dx = dy w^T is a product of C rows over F into D columns: where
    ``route(dtype, C, F, D)`` is ``"wgmma"`` it reads w transposed, on
    ``"wgmma_nt"`` when C has an even count of ``DX_ROWS``-row tiles (the
    backward's design pairs them), else on ``"wgmma_nt_fwd"``; elsewhere
    that route on a copy of w, so a C of the decode shapes sends dx to
    ``"stream"``.  dw = x^T dy is one of D rows over C into F:
    bf16 with D and F multiples of 8 and D >= ``WGMMA_MIN_C`` takes
    ``"wgmma_tn"`` (x read transposed, no copy), whatever C: its TMA boxes
    run along D and F, and zero-fill the ragged tail of C; else
    ``route(dtype, D, C, F)`` on a copy of x."""
    r_dx = route(dtype, C, F, D)
    if r_dx == "wgmma":
        r_dx = "wgmma_nt" if -(-C // DX_ROWS) % 2 == 0 else "wgmma_nt_fwd"
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0 and D >= WGMMA_MIN_C:
        r_dw = "wgmma_tn"
    else:
        r_dw = route(dtype, D, C, F)
    return r_dx, r_dw


@functools.cache
def _transpose_entry():
    fn = _build.load("moe_gmm").moe_gmm_transpose
    fn.argtypes = [_P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.cache
def _entry(which: str):
    lib = _build.load("moe_gmm")
    if which in ("wgmma", "stream", "wgmma_nt"):
        fn = getattr(lib, f"moe_gmm_{which}_fwd")
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    elif which in ("dx_wgmma_nt", "dw_wgmma_tn"):
        fn = getattr(lib, f"moe_gmm_{which}")
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    else:
        fn = lib.moe_gmm_fwd
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def check_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise ValueError on shapes the kernel does not take."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError("moe_gmm: x (E,C,D) and w (E,D,F)")
    E, C, D = x.shape
    Ew, Dw, F = w.shape
    if Ew != E or Dw != D:
        raise ValueError(f"moe_gmm: shapes {tuple(x.shape)} and {tuple(w.shape)} "
                         "differ in E or D")
    if E > _GRID_LIMIT or -(-C // 64) > _GRID_LIMIT:
        raise ValueError("moe_gmm: E and C / 64 must be at most 65535 (grid limit)")
    if max(C, D, F) >= _INDEX_LIMIT:
        raise ValueError("moe_gmm: C, D and F must be below 2**31")


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of :func:`route`: x (E,C,D), w (E,D,F) -> (E,C,F).
    An empty output returns without a launch."""
    return _launch(None, x, w)


def moe_gmm_mma_sync(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the mma_sync design at any shape (the previous design for the
    prefill and decode shapes, kept to be timed beside the wgmma and stream
    ones)."""
    return _launch("mma_sync", x, w)


def moe_gmm_wgmma(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the wgmma design at any bf16 shape it takes, whatever C (to
    time it against the other designs below the threshold)."""
    return _launch("wgmma", x, w)


def moe_gmm_stream(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the stream design at any bf16 shape it takes (C <=
    ``STREAM_KERNEL_MAX_C``, past the route's threshold too)."""
    return _launch("stream", x, w)


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients by x (E, C, D) and w (E, D, F) given dy (E, C, F), in
    x's and w's dtype: each product on the design of :func:`bwd_route`.  An
    empty expert launches nothing: its gradients are zeros."""
    check_inputs(x, w)
    check_operands("moe_gmm_bwd", x, w, dy)
    E, C, D = x.shape
    F = w.shape[2]
    if tuple(dy.shape) != (E, C, F):
        raise ValueError(f"moe_gmm_bwd: dy must be (E, C, F) = {(E, C, F)}, "
                         f"got {tuple(dy.shape)}")
    if x.numel() == 0 or w.numel() == 0 or dy.numel() == 0:
        return torch.zeros_like(x), torch.zeros_like(w)
    r_dx, r_dw = bwd_route(x.dtype, C, D, F)
    return _dx(r_dx, w, dy), _dw(r_dw, x, dy)


def tn_clusters(dw: bool = True) -> int:
    """The two-block clusters of the backward's design (dw's, else dx's)
    that fit the current card at once: its persistent grid.  A cluster sits
    within one GPC, so a card whose GPCs hold odd SM counts fits fewer than
    half its SMs.  Raises if the query fails."""
    fn = _build.load("moe_gmm").moe_gmm_tn_clusters
    fn.argtypes = [_I]
    fn.restype = _I
    n = fn(int(dw))
    if n < 1:
        raise RuntimeError("moe_gmm: the cluster occupancy query failed")
    return n


def _check_bwd(name: str, a: torch.Tensor, dy: torch.Tensor, along: int) -> None:
    """``a`` and dy (E, C, F), CUDA operands, not empty, that agree in E and
    in dimension ``along`` (1: x (E, C, D) for dw; 2: w (E, D, F) for dx)."""
    check_operands(name, a, dy)
    if (a.dim() != 3 or dy.dim() != 3 or a.shape[0] != dy.shape[0]
            or a.shape[along] != dy.shape[along] or 0 in (*a.shape, *dy.shape)):
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and dy {tuple(dy.shape)} do not pair")


def moe_gmm_dx(w: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx (E, C, D) = dy (E, C, F) w^T, w (E, D, F), on its route in
    :func:`bwd_route` alone (to be timed on the card)."""
    _check_bwd("moe_gmm_dx", w, dy, 2)
    E, C, F = dy.shape
    return _dx(bwd_route(dy.dtype, C, w.shape[1], F)[0], w, dy)


def moe_gmm_dx_previous(w: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx as before the backward's own design: the forward's wgmma design
    reading w transposed (``moe_gmm_wgmma_nt_fwd``), kept to be timed beside
    the new one; counted as ``dx_wgmma_nt_fwd``."""
    _check_bwd("moe_gmm_dx_previous", w, dy, 2)
    return _dx("wgmma_nt_fwd", w, dy)


def moe_gmm_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw (E, D, F) = x^T dy for x (E, C, D), dy (E, C, F), on its route in
    :func:`bwd_route` alone (to be timed on the card)."""
    _check_bwd("moe_gmm_dw", x, dy, 1)
    E, C, D = x.shape
    return _dw(bwd_route(x.dtype, C, D, dy.shape[2])[1], x, dy)


def moe_gmm_dw_transposed(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw as before the ``wgmma_tn`` design: the forward's route at (D, C, F)
    over a copy of x laid out (E, D, C) (the previous design, kept to be
    timed beside the new one)."""
    _check_bwd("moe_gmm_dw_transposed", x, dy, 1)
    E, C, D = x.shape
    return _dw(route(x.dtype, D, C, dy.shape[2]), x, dy)


def _dx(r_dx: str, w: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    E, C, F = dy.shape
    D = w.shape[1]
    if r_dx == "wgmma_nt":
        dx = torch.empty((E, C, D), dtype=dy.dtype, device=dy.device)   # dy @ w^T
        err = _entry("dx_wgmma_nt")(dy.data_ptr(), w.data_ptr(), dx.data_ptr(), E, C, D, F,
                                    stream_handle(dy.device))
        raise_on_error("moe_gmm_bwd (wgmma_nt)", err)
    elif r_dx == "wgmma_nt_fwd":
        dx = torch.empty((E, C, D), dtype=dy.dtype, device=dy.device)   # dy @ w^T
        err = _entry("wgmma_nt")(dy.data_ptr(), w.data_ptr(), dx.data_ptr(), E, C, F, D,
                                 stream_handle(dy.device))
        raise_on_error("moe_gmm_bwd (wgmma_nt_fwd)", err)
    else:
        dx = _run(r_dx, dy, _transpose(w))   # (E, C, F) @ (E, F, D)
    BWD_LAUNCHES[f"dx_{r_dx}"] += 1
    return dx


def _dw(r_dw: str, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    E, C, D = x.shape
    F = dy.shape[2]
    if r_dw == "wgmma_tn":
        dw = torch.empty((E, D, F), dtype=x.dtype, device=x.device)   # x^T dy, x in place
        err = _entry("dw_wgmma_tn")(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), E, C, D, F,
                                    stream_handle(x.device))
        raise_on_error("moe_gmm_bwd (wgmma_tn)", err)
    else:
        dw = _run(r_dw, _transpose(x), dy)   # (E, D, C) @ (E, C, F)
    BWD_LAUNCHES[f"dw_{r_dw}"] += 1
    return dw


def _transpose(t: torch.Tensor) -> torch.Tensor:
    """(E, R, C) -> a contiguous (E, C, R) copy, by the transpose kernel."""
    E, R, C = t.shape
    if E > _GRID_LIMIT or -(-R // 64) > _GRID_LIMIT:
        raise ValueError("moe_gmm_bwd: E and R / 64 must be at most 65535 (grid limit)")
    out = torch.empty((E, C, R), dtype=t.dtype, device=t.device)
    err = _transpose_entry()(t.data_ptr(), out.data_ptr(), E, R, C, DTYPE_CODES[t.dtype],
                             stream_handle(t.device))
    raise_on_error("moe_gmm_bwd (transpose)", err)
    return out


def _launch(which, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    check_inputs(x, w)
    check_operands("moe_gmm", x, w)
    E, C, D = x.shape
    which = which or route(x.dtype, C, D, w.shape[2])
    out = _run(which, x, w)
    if out.numel():
        LAUNCHES[which] += 1
    return out


def _run(which: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, F) on design ``which``; nothing for an empty
    output."""
    check_inputs(x, w)
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    args = [x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F]
    if which == "mma_sync":
        args.append(DTYPE_CODES[x.dtype])
    elif x.dtype != torch.bfloat16 or D % 8 or F % 8:
        raise ValueError(f"moe_gmm: the {which} route takes bf16 with D and F multiples of 8, "
                         f"got {x.dtype}, D {D}, F {F}")
    elif which == "stream" and C > STREAM_KERNEL_MAX_C:
        raise ValueError(f"moe_gmm: the stream route takes C <= {STREAM_KERNEL_MAX_C}, "
                         f"got C {C}")
    err = _entry(which)(*args, stream_handle(x.device))
    raise_on_error(f"moe_gmm ({which})", err)
    return out
