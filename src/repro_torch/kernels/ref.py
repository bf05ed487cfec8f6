"""Plain PyTorch versions of the attention kernels.

Counterparts of ``flash_attention_ref`` and ``decode_attention_ref`` in
the JAX package's ``kernels/ref.py``: same layouts, same fp32 softmax,
same finite ``NEG_INF`` for masked scores.  ``kernels.ops`` runs them for
CPU tensors; ``chip_smoke.py`` and the GPU tests hold the CUDA kernels
against them on the card.  They run on any device.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, S, d); k, v: (B, Hkv, T, d) -> (B, Hq, S, d)."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp + (T - S)     # allow prefix cache offset
    if window is not None:
        mask &= kp > qp + (T - S) - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, d); k, v: (B, T, Hkv, d); valid: (B, T) bool -> (B, Hq, d).

    A row with no valid slot averages v over the real T (softmax of equal
    scores), as the JAX oracle does.
    """
    B, Hq, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, Hkv, G, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    s = torch.where(valid.bool()[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(B, Hq, d).to(q.dtype)
