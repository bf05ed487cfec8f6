"""Checks shared by the kernel wrappers before they hand pointers to CUDA."""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

#: I/O types the kernels take, with the code their C entry points expect
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the kernels are instantiated for
HEAD_DIMS = (32, 64, 120, 128)


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


def ring_schedule(n_chunks: int, stages: int) -> List[Tuple[str, int, int]]:
    """The ring of the scan backwards (``mamba_scan_bwd_ring``,
    ``rwkv6_scan_bwd_ring``) in program order: ``("fill", use, chunk)`` where
    one thread issues a stage's copies, ``("walk", use, chunk)`` where the
    block has waited for them and passed the chunk's first barrier.  The
    forward pass walks chunks 0 .. n - 1, the walk back n - 1 .. 0; use u of
    the 2 n takes stage u % stages at mbarrier parity (u // stages) & 1.  A
    pass's first ``stages - 1`` fills go out before it starts, and each walk
    issues the fill ``stages - 1`` uses ahead, into the stage of the use
    before it."""
    events = []
    for u0, order in ((0, range(n_chunks)), (n_chunks, range(n_chunks - 1, -1, -1))):
        order = list(order)
        events += [("fill", u0 + q, order[q]) for q in range(min(stages - 1, n_chunks))]
        for q, c in enumerate(order):
            events.append(("walk", u0 + q, c))
            if q + stages - 1 < n_chunks:
                events.append(("fill", u0 + q + stages - 1, order[q + stages - 1]))
    return events
