"""Wrapper of the CUDA decode attention kernel ``csrc/decode_attention.cu``.

Counterpart of the Pallas ``decode_attention`` in the JAX package's
``kernels/decode_attention.py``; same layouts.  The kernel masks the ragged
edge of T by bounds, so nothing is padded here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPE_CODES, check_head_dim,
                                         check_operands, raise_on_error,
                                         stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _entry():
    fn = _build.load("decode_attention").decode_attention_fwd
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
    if B > 65535:
        raise ValueError("decode_attention: B must be at most 65535 (grid limit)")
    if tuple(valid.shape) != (B, T):
        raise ValueError(f"decode_attention: valid must be (B, T) = {(B, T)}, "
                         f"got {tuple(valid.shape)}")
    if valid.dtype not in (torch.bool, torch.int32):
        raise ValueError(f"decode_attention: valid dtype {valid.dtype} "
                         "(takes bool or int32)")
    check_head_dim("decode_attention", d)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: q (B,Hq,d), k/v (B,T,Hkv,d), valid (B,T) -> (B,Hq,d)."""
    check_inputs(q, k, v, valid)
    check_operands("decode_attention", q, k, v)
    if valid.device != q.device:
        raise ValueError("decode_attention: valid is on another device")
    mask = (valid if valid.dtype == torch.bool else valid != 0).contiguous()
    B, Hq, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   mask.view(torch.uint8).data_ptr(), out.data_ptr(),
                   B, Hq, Hkv, T, d, d ** -0.5, DTYPE_CODES[q.dtype],
                   stream_handle(q.device))
    raise_on_error("decode_attention", err)
    return out
