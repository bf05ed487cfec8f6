"""GQA attention with RoPE, optional qk-norm and sliding window, plus a
single-token decode path against a (ring-buffered) KV cache.

Counterpart of the JAX package's ``models/attention.py`` for the dense
causal path.  Unlike the JAX model, which computes attention with jnp,
prefill and decode call the attention ops in :mod:`repro_torch.kernels.ops`:
the CUDA kernels for tensors on the card, their plain versions on the CPU.
``gqa_attend`` stays as the plain reference.

The caches are updated in place: the decode step writes one slot instead
of copying the whole cache, as the JAX version's functional update does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm, rope_tables, rotate

NEG_INF = -1e30


def attn_init(generator: torch.Generator, cfg: ArchConfig, dtype,
              lead: Tuple[int, ...] = ()) -> dict:
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(generator, cfg.d_model, cfg.n_heads * hd, dtype, lead),
        "wk": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype, lead),
        "wv": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype, lead),
        "wo": dense_init(generator, cfg.n_heads * hd, cfg.d_model, dtype, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=dtype, device=generator.device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dtype, device=generator.device)
    return p


def _project_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig,
                 rope: Tuple[torch.Tensor, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B,S,H,hd), qk-normed and rotated by the ``rope_tables``
    of the positions."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return rotate(q, rope), rotate(k, rope), v


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain reference.  q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd); mask: (S,T) or
    (B,S,T) bool."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / (hd ** 0.5)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        scores = torch.where(m[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def _rope(cfg: ArchConfig, positions: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """Causal self-attention through the flash op, converting the model's
    (B,S,H,hd) to the kernel's (B,H,S,hd) and back."""
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=True, window=cfg.sliding_window)
    return out.transpose(1, 2)


def attention_forward(params: dict, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal self-attention (training / prefill without a
    cache)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, _rope(cfg, positions))
    out = _flash(q, k, v, cfg)
    return out.reshape(B, S, -1) @ params["wo"]


# ---------------------------------------------------------------------------
# KV cache (per layer)


def kv_cache_capacity(cfg: ArchConfig, seq_len: int) -> int:
    """SWA architectures use a ring buffer of window size."""
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_kv_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, device,
                  lead: Tuple[int, ...] = ()) -> dict:
    cap = kv_cache_capacity(cfg, seq_len)
    hd = cfg.resolved_head_dim
    shape = (*lead, batch, cap, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_into_cache(params: dict, x: torch.Tensor, cfg: ArchConfig,
                       positions: torch.Tensor, cache: dict
                       ) -> Tuple[torch.Tensor, dict]:
    """Self-attention over the prompt, and write the (ring) cache in place."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, _rope(cfg, positions))
    out = _flash(q, k, v, cfg)
    cap = cache["k"].shape[1]
    if cap >= S:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    else:
        # ring: keep the last `cap` tokens, rolled so slot j holds pos p≡j (mod cap)
        shift = (S - cap) % cap
        cache["k"].copy_(torch.roll(k[:, S - cap:], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, S - cap:], shift, dims=1))
    y = out.reshape(B, S, -1) @ params["wo"]
    return y, cache


class DecodeStep(NamedTuple):
    """What the layers of one decode step share, built once per step by
    :func:`decode_step_inputs`."""
    pos: int                                   # absolute position of the new token
    rope: Tuple[torch.Tensor, torch.Tensor]    # its rope_tables
    valid: torch.Tensor                        # (B, cap) bool: slots valid after the write


def decode_step_inputs(cfg: ArchConfig, pos: int, batch: int, cap: int,
                       device) -> DecodeStep:
    """The RoPE rotation at ``pos`` and the valid mask over ``cap`` cache
    slots after slot ``pos % cap`` is written, for a batch sharing ``pos``."""
    positions = torch.full((batch, 1), pos, dtype=torch.long, device=device)
    # Absolute position held by slot j after the write.
    j = torch.arange(cap, device=device)
    abs_pos = pos - ((pos - j) % cap)
    valid = abs_pos >= 0
    if cfg.sliding_window is not None:
        valid &= abs_pos > pos - cfg.sliding_window
    return DecodeStep(pos, _rope(cfg, positions),
                      valid[None].expand(batch, cap).contiguous())


def decode_step_attention(params: dict, x: torch.Tensor, cfg: ArchConfig,
                          step: DecodeStep, cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, d) at ``step.pos``, shared by the batch.
    Writes k/v into slot ``pos % cap`` of the cache in place and attends
    over every valid slot."""
    q, k, v = _project_qkv(params, x, cfg, step.rope)
    slot = step.pos % cache["k"].shape[1]
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], step.valid)
    y = out.reshape(x.shape[0], 1, -1) @ params["wo"]
    return y, cache
