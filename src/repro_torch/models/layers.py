"""Shared building blocks, as plain functions on tensors.

Counterpart of the JAX package's ``models/layers.py``.  Parameters are
plain nested dicts of tensors.  Weights keep the JAX layout ``(d_in, d_out)``
and are applied as ``x @ W``, so JAX weights carry over as a plain copy.
Initialisers draw from an explicit ``torch.Generator`` on its device; they
cannot reproduce ``jax.random`` streams.  ``lead`` prepends a stacking
dimension (the layer axis of a homogeneous stack).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# ---------------------------------------------------------------------------
# Initialisers


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5
    w = torch.randn((*lead, d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rms_norm_init(d: int, dtype, device, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    return torch.ones((*lead, d), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RoPE


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotation angles at ``positions`` (..., seq) int,
    each (..., seq, 1, head_dim//2) fp32, broadcasting over the heads."""
    inv = rope_freqs(head_dim, theta, positions.device)         # (hd/2,)
    angles = positions[..., :, None].float() * inv              # (..., seq, hd/2)
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def rotate(x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Rotate the two halves of the head dimension (half split) of
    x (..., seq, heads, head_dim) by the angles of ``rope_tables``."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# SwiGLU MLP


def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int, dtype,
                lead: Tuple[int, ...] = ()) -> dict:
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype, lead),
        "w_up": dense_init(generator, d_model, d_ff, dtype, lead),
        "w_down": dense_init(generator, d_ff, d_model, dtype, lead),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]


# ---------------------------------------------------------------------------
# Masks


def causal_mask(q_len: int, kv_len: int, *, window: Optional[int] = None,
                q_offset: int = 0, device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask; True = attend.  ``q_offset`` is the
    absolute position of query 0 relative to kv position 0."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > (q_pos - window)
    return mask


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def tree_to(tree, device):
    """A copy of a tree of dicts and tuples of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_to(v, device) for v in tree)
    return tree.to(device)
