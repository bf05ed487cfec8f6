"""Wrapper of the CUDA prefill attention kernel ``csrc/flash_attention.cu``.

Counterpart of the Pallas ``flash_attention`` in the JAX package's
``kernels/flash_attention.py``; same layouts and masking.  The kernels mask
the ragged edge of S and T themselves, so nothing is padded here.

Four routes, each its own C entry point, chosen by :func:`route` from the
dtype and the key mask before the launch.  Unmasked, bf16 takes ``"wgmma"``
(Hopper's tensor cores, TMA loads, warp-specialised) and fp32 takes
``"simt"`` (fp32 on the CUDA cores, never TF32).  Under a (B, T) key mask
(a cross prefill under an encoder mask), bf16 takes ``"wgmma_masked"``
(the wgmma design walking only the key tiles that hold a valid key of the
batch row, each tile's 64-bit valid word beside its K tile) and fp32 takes
``"masked"`` (the simt design with the mask in its score loop, walking from
the row's first valid key to its last).  In both masked designs a block
with a query row that has no allowed valid key walks every key tile, so
that row averages v over T as the plain version does.  A failed build or
launch raises; no route stands in for another.
:func:`flash_attention_simt` and :func:`flash_attention_masked_simt` reach
the simt designs for bf16 too, so that each can be timed against its wgmma
counterpart on the card.  ``LAUNCHES`` counts the launches of each route.

:func:`flash_attention_bwd` launches the backward's two kernels, dq (and
each row's log-sum-exp and D = rowsum(dO o)) and then dk and dv, in the
design :func:`bwd_route` gives the dtype and the key mask: bf16 ->
``"wgmma"`` (the pair ``bwd_dq_wgmma``, ``bwd_dkv_wgmma`` on the tensor
cores), or ``"wgmma_live"`` under a key mask (``bwd_dq_wgmma_live``,
``bwd_dkv_wgmma_live``: the first entry builds each batch row's list of
live key tiles and both kernels walk it; the dq kernel takes each row's
log-sum-exp from the forward, ``flash_attention(..., return_lse=True)``,
instead of a first pass of its own); anything else -> ``"simt"`` (the pair
``bwd_dq``, ``bwd_dkv`` on the CUDA cores), or ``"masked"`` under a key mask
(``bwd_dq_masked``, ``bwd_dkv_masked``).  Under a mask a query row with no
allowed valid key (whose output is the mean of v over T) gets dq = 0, gives
nothing to dk, and adds dO / T to dv of every key of its batch row, as the
plain version's softmax of equal scores does.  Each kernel is its own C
entry point, counted in ``BWD_LAUNCHES``.  :func:`flash_attention_bwd_simt`,
:func:`flash_attention_bwd_masked_simt` and
:func:`flash_attention_bwd_wgmma_masked` (the previous bf16 masked pair,
``bwd_dq_wgmma_masked`` and ``bwd_dkv_wgmma_masked``, which recomputes lse
and reads the mask in every block) reach the earlier pairs, to be timed
beside the routes' pairs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPE_CODES, check_head_dim,
                                         check_operands, raise_on_error,
                                         stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int

#: launches of each route
LAUNCHES: Dict[str, int] = {"wgmma": 0, "simt": 0, "masked": 0, "wgmma_masked": 0}
#: the backward's pair of kernels on each route (``wgmma_masked``: the
#: previous bf16 masked pair, on its own entry points)
BWD_PAIRS: Dict[str, Tuple[str, str]] = {
    "simt": ("bwd_dq", "bwd_dkv"), "wgmma": ("bwd_dq_wgmma", "bwd_dkv_wgmma"),
    "masked": ("bwd_dq_masked", "bwd_dkv_masked"),
    "wgmma_masked": ("bwd_dq_wgmma_masked", "bwd_dkv_wgmma_masked"),
    "wgmma_live": ("bwd_dq_wgmma_live", "bwd_dkv_wgmma_live")}
#: the key tiles of the live pair's list, and of a valid word
LIVE_TILE = 64
#: launches of each of the backward's kernels, the pairs of every route
BWD_LAUNCHES: Dict[str, int] = {name: 0 for pair in BWD_PAIRS.values() for name in pair}


def route(dtype: torch.dtype, masked: bool = False) -> str:
    """The design a CUDA call in ``dtype`` takes: bf16 -> ``"wgmma"``, or
    ``"wgmma_masked"`` under a key mask; anything else -> ``"simt"``, or
    ``"masked"`` under a key mask."""
    if dtype == torch.bfloat16:
        return "wgmma_masked" if masked else "wgmma"
    return "masked" if masked else "simt"


def bwd_route(dtype: torch.dtype, masked: bool = False) -> str:
    """The backward design a CUDA call in ``dtype`` takes: bf16 ->
    ``"wgmma"``, or ``"wgmma_live"`` under a key mask (which takes the
    forward's lse); anything else -> ``"simt"``, or ``"masked"`` under a key
    mask."""
    if dtype == torch.bfloat16:
        return "wgmma_live" if masked else "wgmma"
    return "masked" if masked else "simt"


@functools.cache
def _entry(which: str):
    lib = _build.load("flash_attention")
    if which == "wgmma":
        fn = lib.flash_attention_wgmma_fwd
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _P]
    elif which == "bwd_dq":
        fn = lib.flash_attention_bwd_dq
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _P]
    elif which == "bwd_dkv":
        fn = lib.flash_attention_bwd_dkv
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _P]
    elif which in ("bwd_dq_wgmma", "bwd_dkv_wgmma"):
        fn = getattr(lib, f"flash_attention_{which}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _P]
    elif which in ("bwd_dq_masked", "bwd_dkv_masked"):   # nine pointers, the mask among them
        fn = getattr(lib, f"flash_attention_{which}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _P]
    elif which in ("bwd_dq_wgmma_masked", "bwd_dkv_wgmma_masked"):
        fn = getattr(lib, f"flash_attention_{which}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _P]
    elif which in ("bwd_dq_wgmma_live", "bwd_dkv_wgmma_live"):   # twelve and ten pointers
        fn = getattr(lib, f"flash_attention_{which}")
        fn.argtypes = ([_P] * (12 if which == "bwd_dq_wgmma_live" else 10)
                       + [_I] * 9 + [ctypes.c_float, _P])
    elif which == "masked":
        fn = lib.flash_attention_masked_fwd
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _P]
    elif which == "wgmma_masked":   # the lse pointer after out: null, or (B, Hq, S) fp32
        fn = lib.flash_attention_wgmma_masked_fwd
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _P]
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int],
                 key_valid: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q (B,Hq,S,d), k and v (B,Hkv,T,d)")
    B, Hq, S, d = q.shape
    Bk, Hkv, T, dk = k.shape
    if Bk != B or dk != d or Hkv == 0 or Hq % Hkv or S == 0 or T == 0:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k.shape)} do not pair")
    check_head_dim("flash_attention", d)
    if B > 65535 or Hq > 65535:
        raise ValueError("flash_attention: B and Hq must be at most 65535 (grid limit)")
    if window is not None and not 0 < window < 2 ** 31:
        raise ValueError(f"flash_attention: window {window} out of range")
    if key_valid is not None and (key_valid.dtype != torch.bool
                                  or tuple(key_valid.shape) != (B, T)
                                  or key_valid.device != q.device):
        raise ValueError(f"flash_attention: key_valid must be ({B}, {T}) bool on {q.device}, "
                         f"got {tuple(key_valid.shape)} {key_valid.dtype} on {key_valid.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    key_valid: Optional[torch.Tensor] = None, return_lse: bool = False):
    """Launch the kernel of ``route(q.dtype, key_valid is not None)``: q
    (B,Hq,S,d), k/v (B,Hkv,T,d), key_valid (B,T) bool or None ->
    (B,Hq,S,d).  ``return_lse`` (the ``wgmma_masked`` route only, for the
    ``wgmma_live`` backward) -> (out, lse): lse (B,Hq,S) fp32, each row's
    log-sum-exp of its allowed scores in log2 units (scores times
    d**-0.5 log2(e)), -inf on a row with no allowed valid key."""
    return _launch(route(q.dtype, key_valid is not None), q, k, v, causal, window,
                   key_valid, return_lse)


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the simt design whatever the dtype (the previous design for
    bf16, kept to be timed beside the wgmma one)."""
    return _launch("simt", q, k, v, causal, window)


def flash_attention_masked_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                causal: bool = True, window: Optional[int] = None,
                                key_valid: torch.Tensor) -> torch.Tensor:
    """Launch the simt design under a key mask whatever the dtype (the
    previous design for bf16, kept to be timed beside the wgmma one)."""
    return _launch("masked", q, k, v, causal, window, key_valid)


def _launch(which: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int],
            key_valid: Optional[torch.Tensor] = None, return_lse: bool = False):
    check_inputs(q, k, v, window, key_valid)
    check_operands("flash_attention", q, k, v)
    if return_lse and which != "wgmma_masked":
        raise ValueError(f"flash_attention ({which}): only the wgmma_masked route returns lse")
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if which in ("masked", "wgmma_masked"):
        if key_valid is None:
            raise ValueError(f"flash_attention ({which}): takes a key_valid mask")
        key_valid = key_valid.contiguous()      # bool is one byte: 0 = masked key
        ptrs.append(key_valid.data_ptr())
    ptrs.append(out.data_ptr())
    lse = None
    if which == "wgmma_masked":
        lse = (torch.empty((B, Hq, S), dtype=torch.float32, device=q.device) if return_lse
               else None)
        ptrs.append(None if lse is None else lse.data_ptr())
    args = [*ptrs, B, Hq, Hkv, S, T, d, int(causal), int(window is not None), window or 0,
            d ** -0.5]
    if which in ("simt", "masked"):
        args.append(DTYPE_CODES[q.dtype])
    err = _entry(which)(*args, stream_handle(q.device))
    raise_on_error(f"flash_attention ({which})", err)
    LAUNCHES[which] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        key_valid: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`flash_attention`: q, o and dout (B,Hq,S,d),
    k/v (B,Hkv,T,d), key_valid (B,T) bool or None, o the forward's output
    and dout the gradient of the loss by it -> (dq, dk, dv) in the inputs'
    dtype.  The pair of ``bwd_route(q.dtype, key_valid is not None)`` on the
    current stream: the dq kernel, then the dkv kernel, which reads the
    rows' statistics the first wrote.  The ``wgmma_live`` pair takes lse,
    the forward's (``flash_attention(..., return_lse=True)``), and its dq
    entry builds the list of live tiles first."""
    return _bwd(bwd_route(q.dtype, key_valid is not None), q, k, v, o, dout, causal, window,
                key_valid, lse)


def flash_attention_bwd_wgmma_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     o: torch.Tensor, dout: torch.Tensor, *,
                                     causal: bool = True, window: Optional[int] = None,
                                     key_valid: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The previous bf16 masked pair (its dq kernel recomputes lse in a first
    pass, and every block reads the mask), kept to be timed beside the
    ``wgmma_live`` pair."""
    return _bwd("wgmma_masked", q, k, v, o, dout, causal, window, key_valid)


def flash_attention_bwd_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The simt pair whatever the dtype (the previous design for bf16, kept
    to be timed beside the wgmma pair)."""
    return _bwd("simt", q, k, v, o, dout, causal, window)


def flash_attention_bwd_masked_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    o: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                                    window: Optional[int] = None, key_valid: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The simt pair under a key mask whatever the dtype (for bf16, timed
    beside the wgmma_masked pair)."""
    return _bwd("masked", q, k, v, o, dout, causal, window, key_valid)


def _bwd(which: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
         dout: torch.Tensor, causal: bool, window: Optional[int],
         key_valid: Optional[torch.Tensor] = None, lse: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    check_inputs(q, k, v, window, key_valid)
    masked = which in ("masked", "wgmma_masked", "wgmma_live")
    if masked != (key_valid is not None):
        raise ValueError(f"flash_attention_bwd ({which}): takes a key_valid mask "
                         f"{'and got none' if masked else 'only on a masked route'}")
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and dout "
                         f"{tuple(dout.shape)} must be shaped as q {tuple(q.shape)}")
    check_operands("flash_attention_bwd", q, k, v, o, dout)
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if masked:
        key_valid = key_valid.contiguous()      # bool is one byte: 0 = masked key
    mask = [key_valid.data_ptr()] if masked else []
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    shape = [B, Hq, Hkv, S, T, d, int(causal), int(window is not None), window or 0,
             d ** -0.5]
    if which == "wgmma_live":
        return _bwd_live(q, k, v, o, dout, key_valid, lse, dq, dk, dv, shape)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    if which in ("simt", "masked"):
        shape.append(DTYPE_CODES[q.dtype])
    shape.append(stream_handle(q.device))
    names = BWD_PAIRS[which]
    err = _entry(names[0])(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           dout.data_ptr(), *mask, dq.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), *shape)
    raise_on_error(f"flash_attention_bwd ({names[0]})", err)
    BWD_LAUNCHES[names[0]] += 1
    err = _entry(names[1])(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), *mask,
                           lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                           *shape)
    raise_on_error(f"flash_attention_bwd ({names[1]})", err)
    BWD_LAUNCHES[names[1]] += 1
    return dq, dk, dv


def _bwd_live(q, k, v, o, dout, key_valid, lse, dq, dk, dv, shape):
    """The ``wgmma_live`` pair: the dq entry (the list of live tiles, then
    the dq kernel, from the forward's ``lse``), then the dkv entry."""
    B, Hq, S = q.shape[:3]
    T = k.shape[2]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd (wgmma_live): takes bf16, got {q.dtype}")
    if (lse is None or lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, S)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd (wgmma_live): takes the forward's lse, "
                         f"({B}, {Hq}, {S}) float32 contiguous on {q.device}")
    n_kt = -(-T // LIVE_TILE)
    words = torch.empty((B, n_kt), dtype=torch.int64, device=q.device)
    live = torch.empty((B, n_kt), dtype=torch.int32, device=q.device)
    prefix = torch.empty((B, n_kt + 1), dtype=torch.int32, device=q.device)
    delta = torch.empty_like(lse)
    shape = [*shape, stream_handle(q.device)]
    names = BWD_PAIRS["wgmma_live"]
    err = _entry(names[0])(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           dout.data_ptr(), key_valid.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                           delta.data_ptr(), words.data_ptr(), live.data_ptr(),
                           prefix.data_ptr(), *shape)
    raise_on_error(f"flash_attention_bwd ({names[0]})", err)
    BWD_LAUNCHES[names[0]] += 1
    err = _entry(names[1])(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                           lse.data_ptr(), delta.data_ptr(), words.data_ptr(), prefix.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), *shape)
    raise_on_error(f"flash_attention_bwd ({names[1]})", err)
    BWD_LAUNCHES[names[1]] += 1
    return dq, dk, dv
