"""Checks shared by the kernel wrappers before they hand pointers to CUDA."""
from __future__ import annotations

import ctypes

import torch

#: I/O types the kernels take, with the code their C entry points expect
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)


def check_operands(name: str, *tensors: torch.Tensor) -> None:
    """Raise ValueError unless every tensor is a contiguous, 16-byte aligned
    CUDA tensor of one supported dtype on one device."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t0.device}")
    if t0.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {t0.dtype} not supported "
                         f"(takes {sorted(map(str, DTYPE_CODES))})")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: operands differ in device or dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def check_head_dim(name: str, d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not supported (takes {HEAD_DIMS})")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
