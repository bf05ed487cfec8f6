"""Wrapper of the CUDA decode attention kernel ``csrc/decode_attention.cu``.

Counterpart of the Pallas ``decode_attention`` in the JAX package's
``kernels/decode_attention.py``; same layouts.  The kernels mask the ragged
edge of T by bounds, so nothing is padded here.

Two designs, each its own C entry point, chosen by :func:`route` from the
dtype, the query heads per kv head and T before the launch: bf16 with G in
``SPLIT_GROUPS`` takes ``"split"`` (T cut across the blocks of one cluster,
tiles with no valid slot skipped, K and V loaded by TMA into a ring, the
splits combined by log-sum-exp through the cluster's shared memory);
everything else takes ``"simt"`` (one block per (kv head, batch row), fp32
on the CUDA cores).  A failed build or launch raises; no route stands in for
another.  :func:`decode_attention_simt` reaches the simt design for bf16
too, so that the two can be timed against each other on the card.
``LAUNCHES`` counts the launches of each route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPE_CODES, check_head_dim,
                                         check_operands, raise_on_error,
                                         stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: query heads per kv head that the split design is instantiated for: those
#: of the assigned architectures (3 is phi4-mini-3.8b's 24 over 8)
SPLIT_GROUPS = (1, 2, 3, 4, 8)
#: cache slots per tile of the split design
TILE = 64
#: splits of one (batch row, kv head) at most: the blocks of one cluster
MAX_SPLITS = 8
#: the longest cache row the split design takes
MAX_T = 2 ** 20
#: tiles of one split at most: a whole row, so that one split can take it
#: when B x Hkv alone fills the card (the list of live tiles is kept in
#: shared memory; the source asserts that it fits)
MAX_TILES_PER_SPLIT = MAX_T // TILE
#: blocks per SM the split count aims at: one, so that all B x Hkv x splits
#: blocks run in one wave whatever G; at d = 128 and G = 8 a block's ring and
#: partials (about 117 KB) leave no room for a second
BLOCKS_PER_SM = 1

#: launches of each route
LAUNCHES: Dict[str, int] = {"split": 0, "simt": 0}


def route(dtype: torch.dtype, groups: int, T: int) -> str:
    """The design a CUDA call takes: ``"split"`` for bf16 with ``groups``
    (= Hq / Hkv) in ``SPLIT_GROUPS`` (1, 2, 3, 4 or 8: every grouping of the
    assigned architectures) and T <= ``MAX_T``, else ``"simt"``.  Every
    split count :func:`splits` gives for such a T launches, whatever B, Hkv
    and the card."""
    if dtype == torch.bfloat16 and groups in SPLIT_GROUPS and T <= MAX_T:
        return "split"
    return "simt"


def splits(B: int, Hkv: int, T: int, sms: int) -> Tuple[int, int]:
    """(splits, tiles per split) of the split design: whole 64-slot tiles,
    as many splits as keep the B x Hkv x splits blocks within
    ``BLOCKS_PER_SM`` blocks per SM (one wave), from 1 to ``MAX_SPLITS``."""
    n_tiles = -(-T // TILE)
    want = max(1, min(n_tiles, MAX_SPLITS, BLOCKS_PER_SM * sms // (B * Hkv)))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry(which: str):
    lib = _build.load("decode_attention")
    if which == "split":
        fn = lib.decode_attention_split_fwd
        fn.argtypes = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _P]
    else:
        fn = lib.decode_attention_fwd
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("decode_attention: q (B,Hq,d), k and v (B,T,Hkv,d)")
    B, Hq, d = q.shape
    Bk, T, Hkv, dk = k.shape
    if Bk != B or dk != d or Hkv == 0 or Hq % Hkv or T == 0:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k.shape)} do not pair")
    if B > 65535 or Hkv > 65535:
        raise ValueError("decode_attention: B and Hkv must be at most 65535 (grid limit)")
    if tuple(valid.shape) != (B, T):
        raise ValueError(f"decode_attention: valid must be (B, T) = {(B, T)}, "
                         f"got {tuple(valid.shape)}")
    if valid.dtype not in (torch.bool, torch.int32):
        raise ValueError(f"decode_attention: valid dtype {valid.dtype} "
                         "(takes bool or int32)")
    check_head_dim("decode_attention", d)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of :func:`route`: q (B,Hq,d), k/v (B,T,Hkv,d),
    valid (B,T) -> (B,Hq,d)."""
    return _launch(None, q, k, v, valid)


def decode_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Launch the simt design whatever the dtype (the previous design for
    bf16, kept to be timed beside the split one)."""
    return _launch("simt", q, k, v, valid)


def _launch(which, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    check_inputs(q, k, v, valid)
    check_operands("decode_attention", q, k, v)
    if valid.device != q.device:
        raise ValueError("decode_attention: valid is on another device")
    mask = (valid if valid.dtype == torch.bool else valid != 0).contiguous()
    B, Hq, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    which = which or route(q.dtype, Hq // Hkv, T)
    out = torch.empty_like(q)
    if which == "simt":
        args = [B, Hq, Hkv, T, d, d ** -0.5, DTYPE_CODES[q.dtype]]
    else:
        args = [B, Hq, Hkv, T, d, *splits(B, Hkv, T, _sm_count(q.device.index or 0)),
                d ** -0.5]
    err = _entry(which)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        mask.view(torch.uint8).data_ptr(), out.data_ptr(), *args,
                        stream_handle(q.device))
    raise_on_error(f"decode_attention ({which})", err)
    LAUNCHES[which] += 1
    return out
