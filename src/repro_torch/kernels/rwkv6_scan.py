"""Wrapper of the CUDA wkv-recurrence kernel ``csrc/rwkv6_scan.cu``.

Counterpart of the Pallas ``rwkv6_scan`` in the JAX package's
``kernels/rwkv6_scan.py``, with the signature of its plain oracle
``ref.rwkv6_scan_ref``: r, k, v, w (B, T, H, hd), u (H, hd) and an optional
fp32 initial state S0 (B, H, hd, hd) -> o (B, T, H, hd) in r.dtype and the
last state (B, H, hd, hd) in fp32.  The kernel covers any T by bounds, so
nothing is padded here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPE_CODES, check_operands,
                                         raise_on_error, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
HEAD_SIZES = (16, 32, 64)  # hd the kernel is instantiated for (a thread per column)
_INDEX_LIMIT = 2 ** 31     # B * H blocks and T are int in the kernel


@functools.cache
def _entry():
    fn = _build.load("rwkv6_scan").rwkv6_scan_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


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
    if B * H >= _INDEX_LIMIT or T >= _INDEX_LIMIT:
        raise ValueError("rwkv6_scan: B * H and T must be below 2**31")
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
    """Launch the kernel: -> (o (B, T, H, hd) in r.dtype, S_last (B, H, hd,
    hd) fp32).  An empty input returns without a launch; its state is S0 (or
    zeros)."""
    check_operands("rwkv6_scan", r, k, v, w, u)
    check_inputs(r, k, v, w, u, S0)
    B, T, H, hd = r.shape
    o = torch.empty_like(r)
    if o.numel() == 0:
        S = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
        return o, (S if S0 is None else S.copy_(S0))
    S_last = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                   None if S0 is None else S0.data_ptr(), o.data_ptr(), S_last.data_ptr(),
                   B, T, H, hd, DTYPE_CODES[r.dtype], stream_handle(r.device))
    raise_on_error("rwkv6_scan", err)
    return o, S_last
