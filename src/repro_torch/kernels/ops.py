"""Public kernel ops, dispatched by the device of the tensors.

Counterpart of the JAX package's ``kernels/ops.py``.  A CPU tensor goes to
the plain PyTorch version in :mod:`repro_torch.kernels.ref`; a CUDA tensor
goes to the hand-written kernel, which raises on anything it does not take.
There is no override and no fallback.

``LAUNCHES`` counts the kernel launches of each op, so that a run can show
that it went through the kernels; the plain versions do not count.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import aes_ctr as _aes
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "decode_attention": 0, "aes_ctr": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no implementation for device {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,Hq,S,d), k/v (B,Hkv,T,d) -> (B,Hq,S,d)."""
    if not _on_cuda("flash_attention", q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    out = _flash.flash_attention(q, k, v, causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q (B,Hq,d), k/v (B,T,Hkv,d), valid (B,T) bool/int32 -> (B,Hq,d)."""
    if not _on_cuda("decode_attention", q):
        return ref.decode_attention_ref(q, k, v, valid)
    out = _decode.decode_attention(q, k, v, valid)
    LAUNCHES["decode_attention"] += 1
    return out


def aes_ctr(plaintext: torch.Tensor, key_bytes: torch.Tensor, *,
            nonce: int = 0) -> torch.Tensor:
    """AES-128-CTR: plaintext (N, 16) int32 bytes, key (16,) -> (N, 16) int32.

    The key schedule is plain torch, as in the JAX package, and lands on the
    plaintext's device as an (11, 16) int32 tensor.  An empty plaintext
    launches nothing and counts nothing."""
    if not _on_cuda("aes_ctr", plaintext):
        return ref.aes_ctr_ref(plaintext, key_bytes, nonce)
    rk = ref.aes_key_expand(key_bytes).to(plaintext.device)
    out = _aes.aes_ctr(plaintext, rk, nonce=nonce)
    if plaintext.shape[0]:
        LAUNCHES["aes_ctr"] += 1
    return out
