"""Shared building blocks, as plain functions on tensors.

Counterpart of the JAX package's ``models/layers.py``.  Parameters are
plain nested dicts of tensors.  Weights keep the JAX layout ``(d_in, d_out)``
and are applied as ``x @ W``, so JAX weights carry over as a plain copy.
Initialisers draw from an explicit ``torch.Generator`` on its device; they
cannot reproduce ``jax.random`` streams.  ``lead`` prepends a stacking
dimension (the layer axis of a homogeneous stack).
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# ---------------------------------------------------------------------------
# Initialisers


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """N(0, 1/d_in) weights (*lead, d_in, d_out) in ``dtype``.  A stacked
    tensor is drawn one leading index at a time into the result, so the fp32
    temporary is one (d_in, d_out) matrix, not the whole stack."""
    if lead:
        out = torch.empty((*lead, d_in, d_out), dtype=dtype, device=generator.device)
        for i in range(lead[0]):
            out[i] = dense_init(generator, d_in, d_out, dtype, lead[1:])
        return out
    scale = (1.0 / d_in) ** 0.5
    w = torch.randn((d_in, d_out), generator=generator, device=generator.device,
                    dtype=torch.float32)
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
    """Inverse frequencies, shape (head_dim//2,) fp32: 1 / theta ** (i /
    head_dim), the exponents in fp32, then the power and the inverse in
    float64, rounded once.

    That is what the JAX package's models compute: under ``jit`` and
    ``lax.scan`` XLA folds the frequencies, which depend on no input, into
    a constant, and folds in float64.  Taken in fp32, as torch's and JAX's
    eager ops take them, 10 to 25 of a head's 32 to 64 frequencies lie an
    ulp or two away, and the position multiplies that: at position 524287
    an ulp of a frequency near 1 turns its pair by up to 0.03 rad.  theta
    is rounded to fp32 on the host, as JAX takes a Python float: a tensor
    made from host data would be a copy to the card that no CUDA graph
    capture takes."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    base = struct.unpack("f", struct.pack("f", theta))[0]
    return (1.0 / base ** exps.double()).float()


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
    return tree_map(lambda t: t.to(device), tree)


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, tuples and NamedTuples,
    keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a tree, in the order JAX flattens it (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def constrain(x: torch.Tensor, placements) -> torch.Tensor:
    """x redistributed to the DTensor ``placements`` when it is a DTensor (the
    dry run's trace), else x: the counterpart of JAX's
    ``with_sharding_constraint``."""
    from torch.distributed.tensor import DTensor
    if placements is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements)
