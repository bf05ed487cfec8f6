"""Wrapper of the CUDA expert-batched matmul kernel ``csrc/moe_gmm.cu``.

Counterpart of the Pallas ``moe_gmm`` in the JAX package's
``kernels/moe_gmm.py``: x (E, C, D), w (E, D, F) -> y (E, C, F) in x.dtype,
summed in fp32 and rounded once.  The kernel masks the tails of C, D and F
itself, so nothing is padded here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPE_CODES, check_operands,
                                         raise_on_error, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
_GRID_LIMIT = 65535        # gridDim.y (C / 64) and gridDim.z (E)
_INDEX_LIMIT = 2 ** 31     # C, D and F are int in the kernel


@functools.cache
def _entry():
    fn = _build.load("moe_gmm").moe_gmm_fwd
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
    """Launch the kernel: x (E,C,D), w (E,D,F) -> (E,C,F).  An empty output
    returns without a launch."""
    check_inputs(x, w)
    check_operands("moe_gmm", x, w)
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
                   DTYPE_CODES[x.dtype], stream_handle(x.device))
    raise_on_error("moe_gmm", err)
    return out
