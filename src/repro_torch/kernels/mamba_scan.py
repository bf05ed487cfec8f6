"""Wrapper of the CUDA selective-scan kernel ``csrc/mamba_scan.cu``.

Counterpart of the Pallas ``mamba_scan`` in the JAX package's
``kernels/mamba_scan.py``, with the signature of its plain oracle
``ref.mamba_scan_ref``: dt, dtx (B, S, di), Bm, Cm (B, S, ds), A (di, ds) and
an optional fp32 initial state h0 (B, di, ds) -> y (B, S, di) in dt.dtype and
the last state (B, di, ds) in fp32.  The kernel masks the tails of S and di
itself, so nothing is padded here.
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
MAX_STATE = 16             # state values per channel the kernel keeps in registers
_GRID_LIMIT = 65535        # gridDim.y (B)
_INDEX_LIMIT = 2 ** 31     # S, di and ds are int in the kernel


@functools.cache
def _entry():
    fn = _build.load("mamba_scan").mamba_scan_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


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
    """Launch the kernel: -> (y (B, S, di) in dt.dtype, h_last (B, di, ds)
    fp32).  An empty input returns without a launch; its state is h0 (or
    zeros)."""
    check_operands("mamba_scan", dt, dtx, Bm, Cm, A)
    check_inputs(dt, dtx, Bm, Cm, A, h0)
    B, S, di = dt.shape
    ds = Bm.shape[2]
    y = torch.empty_like(dt)
    if y.numel() == 0:
        h = torch.zeros((B, di, ds), dtype=torch.float32, device=dt.device)
        return y, (h if h0 is None else h.copy_(h0))
    h_last = torch.empty((B, di, ds), dtype=torch.float32, device=dt.device)
    err = _entry()(dt.data_ptr(), dtx.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
                   None if h0 is None else h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                   B, S, di, ds, DTYPE_CODES[dt.dtype], stream_handle(dt.device))
    raise_on_error("mamba_scan", err)
    return y, h_last
