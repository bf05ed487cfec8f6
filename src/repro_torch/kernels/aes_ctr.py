"""Wrapper of the CUDA AES-128-CTR kernel ``csrc/aes_ctr.cu``.

Counterpart of the Pallas ``aes_ctr`` in the JAX package's
``kernels/aes_ctr.py``: plaintext (N, 16) int32 bytes and round keys
(11, 16) int32 -> ciphertext (N, 16) int32.  The kernels compute each
counter block themselves and mask the ragged edge of N by bounds, so
nothing is padded or materialised here.

Two designs, each its own C entry point: ``"ttable"`` (a word table
folding SubBytes and MixColumns, ``TTABLE_BLOCKS`` counter blocks a thread,
a persistent grid of :func:`ttable_grid` CTAs), which :func:`route` gives
every N, and ``"simt"`` (a thread per block, the S-box as a byte table), the
first design, which :func:`aes_ctr_simt` reaches so that the two can be
timed against each other on the card.  A failed build or launch raises; no
route stands in for another.  ``LAUNCHES`` counts the launches of each
route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import raise_on_error, stream_handle

_P = ctypes.c_void_p
#: the ttable design's constants (csrc/aes_ctr.cu, namespace ttable)
TTABLE_THREADS = 256       # threads a CTA
TTABLE_BLOCKS = 2          # counter blocks a thread carries through the rounds
TTABLE_CTAS_PER_SM = 2     # CTAs an SM of the persistent grid

#: launches of each route
LAUNCHES: Dict[str, int] = {"ttable": 0, "simt": 0}


def route(n: int) -> str:
    """The design a CUDA call on ``n`` counter blocks takes: ``"ttable"`` at
    every N.  Timed in turns with simt on the card at 1, 38 and 2**20 blocks,
    it was the faster at each (``chip_smoke.py`` phase 6), so there is no
    crossover."""
    return "ttable"


def ttable_grid(n: int, sms: int) -> int:
    """CTAs of the ttable launch for ``n`` > 0 blocks on ``sms`` SMs: enough
    for one pass of ``TTABLE_BLOCKS`` blocks a thread, at most
    ``TTABLE_CTAS_PER_SM`` an SM.  Thread t of the grid's T threads takes
    blocks t, t + T, t + 2T, ...: ``TTABLE_BLOCKS`` of them a pass."""
    return min(-(-n // (TTABLE_THREADS * TTABLE_BLOCKS)), sms * TTABLE_CTAS_PER_SM)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry(which: str):
    lib = _build.load("aes_ctr")
    if which == "ttable":
        fn = lib.aes_ctr_ttable_fwd
        fn.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_int, _P]
    else:
        fn = lib.aes_ctr_fwd
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
    """Launch the design of :func:`route`: plaintext (N, 16), round keys
    (11, 16) -> (N, 16).  N = 0 returns an empty tensor without a launch."""
    return _launch(None, plaintext, round_keys, nonce)


def aes_ctr_simt(plaintext: torch.Tensor, round_keys: torch.Tensor, *,
                 nonce: int = 0) -> torch.Tensor:
    """Launch the simt design whatever N (the first design, kept to be timed
    beside the ttable one)."""
    return _launch("simt", plaintext, round_keys, nonce)


def _launch(which, plaintext: torch.Tensor, round_keys: torch.Tensor,
            nonce: int) -> torch.Tensor:
    check_inputs(plaintext, round_keys)
    out = torch.empty_like(plaintext)
    n = plaintext.shape[0]
    if n == 0:
        return out
    which = which or route(n)
    args = [plaintext.data_ptr(), round_keys.data_ptr(), out.data_ptr(), n,
            ctypes.c_uint32(nonce & 0xFFFFFFFF)]
    if which == "ttable":
        args.append(ttable_grid(n, _sms(plaintext.device.index)))
    err = _entry(which)(*args, stream_handle(plaintext.device))
    raise_on_error(f"aes_ctr ({which})", err)
    LAUNCHES[which] += 1
    return out
