"""Wrapper of the CUDA AES-128-CTR kernel ``csrc/aes_ctr.cu``.

Counterpart of the Pallas ``aes_ctr`` in the JAX package's
``kernels/aes_ctr.py``: plaintext (N, 16) int32 bytes and round keys
(11, 16) int32 -> ciphertext (N, 16) int32.  The kernel computes each
counter block itself and masks the ragged edge of N by bounds, so nothing
is padded or materialised here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import raise_on_error, stream_handle

_P = ctypes.c_void_p


@functools.cache
def _entry():
    fn = _build.load("aes_ctr").aes_ctr_fwd
    fn.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_uint32, _P]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(plaintext: torch.Tensor, round_keys: torch.Tensor) -> None:
    """Raise ValueError unless plaintext is (N, 16) and round_keys (11, 16),
    both int32, contiguous, 16-byte aligned and on one CUDA device."""
    if plaintext.dim() != 2 or plaintext.shape[1] != 16:
        raise ValueError(f"aes_ctr: plaintext must be (N, 16), got {tuple(plaintext.shape)}")
    if tuple(round_keys.shape) != (11, 16):
        raise ValueError(f"aes_ctr: round keys must be (11, 16), got {tuple(round_keys.shape)}")
    for t in (plaintext, round_keys):
        if t.device.type != "cuda":
            raise ValueError(f"aes_ctr: the kernel takes CUDA tensors, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"aes_ctr: operands must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("aes_ctr: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("aes_ctr: operands must be 16-byte aligned")
    if round_keys.device != plaintext.device:
        raise ValueError("aes_ctr: round keys are on another device")


def aes_ctr(plaintext: torch.Tensor, round_keys: torch.Tensor, *,
            nonce: int = 0) -> torch.Tensor:
    """Launch the kernel: plaintext (N, 16), round keys (11, 16) -> (N, 16).
    N = 0 returns an empty tensor without a launch."""
    check_inputs(plaintext, round_keys)
    out = torch.empty_like(plaintext)
    if plaintext.shape[0] == 0:
        return out
    err = _entry()(plaintext.data_ptr(), round_keys.data_ptr(), out.data_ptr(),
                   plaintext.shape[0], ctypes.c_uint32(nonce & 0xFFFFFFFF),
                   stream_handle(plaintext.device))
    raise_on_error("aes_ctr", err)
    return out
