"""Wrapper of the CUDA prefill attention kernel ``csrc/flash_attention.cu``.

Counterpart of the Pallas ``flash_attention`` in the JAX package's
``kernels/flash_attention.py``; same layouts and masking.  The kernel masks
the ragged edge of S and T itself, so nothing is padded here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPE_CODES, check_head_dim,
                                         check_operands, raise_on_error,
                                         stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]) -> None:
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel: q (B,Hq,S,d), k/v (B,Hkv,T,d) -> (B,Hq,S,d)."""
    check_inputs(q, k, v, window)
    check_operands("flash_attention", q, k, v)
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Hq, Hkv, S, T, d, int(causal), int(window is not None),
                   window or 0, d ** -0.5, DTYPE_CODES[q.dtype],
                   stream_handle(q.device))
    raise_on_error("flash_attention", err)
    return out
