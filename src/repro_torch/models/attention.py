"""GQA attention with RoPE, optional qk-norm and sliding window, plus a
single-token decode path against a (ring-buffered) KV cache, the
bidirectional self-attention of an encoder and the cross-attention of an
encoder-decoder's decoder.

Counterpart of the JAX package's ``models/attention.py`` and of the
encoder and cross sub-layers of its ``models/transformer.py``.  Unlike the
JAX model, which computes attention with jnp, prefill, decode, the encoder
and the cross-attention call the attention ops in
:mod:`repro_torch.kernels.ops`: the CUDA kernels for tensors on the card,
their plain versions on the CPU.  ``gqa_attend`` stays as the plain
reference, and is what cross-attention takes on the CPU, as in JAX.

The caches are updated in place: the decode step writes one slot instead
of copying the whole cache, as the JAX version's functional update does.

Three options that only the dry run and ``launch.perf`` select: ``impl``
(``"dense"`` or ``"chunked"``, query chunks of 512 with an online softmax's
memory, ``chunked_gqa_attend``) on prefill, ``mixed_precision`` (the
softmax weights rounded to the inputs' dtype before the product with v,
products summed in fp32) on decode, and ``cache_update`` (``"dus"``, the
slot written in place, or ``"select"``, ``where(arange(cap) == slot, new,
cache)`` written back: elementwise, so a cache sharded over its sequence
keeps its layout).  The first two choose between plain versions only: on a
CUDA tensor prefill and decode still run the flash and decode kernels,
whatever they say.  ``cache_update`` chooses how the cache is written on
every device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

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
               mask: Optional[torch.Tensor],
               mixed_precision: bool = False) -> torch.Tensor:
    """Plain reference.  q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd); mask: (S,T) or
    (B,S,T) bool.

    ``mixed_precision`` rounds the softmax weights to q's dtype before their
    product with v, as the JAX version's bf16 dot with an fp32 accumulator
    does.  Its scores need nothing else: a product of two bf16 values is
    exact in fp32, so upcasting the operands and summing in fp32 is that
    dot."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / (hd ** 0.5)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        scores = torch.where(m[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    if mixed_precision:
        w = w.to(q.dtype).float()
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def chunked_gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       q_chunk: int = 512) -> torch.Tensor:
    """Query-chunked attention: the (S, T) scores are built ``q_chunk`` rows
    at a time, never whole, as the JAX version's scan over query chunks.
    q: (B,S,Hq,hd); k/v: (B,T,Hkv,hd) -> (B,S,Hq,hd).  Queries sit at the
    last S of the T key positions; S is padded to a multiple of the chunk
    and the padding dropped.  Products are summed in fp32 and the softmax
    weights rounded to q's dtype before their product with v (JAX's bf16
    dots with an fp32 accumulator); k and v are upcast once for all
    chunks."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    cq = min(q_chunk, S)
    pad = (-S) % cq
    if pad:
        q = torch.cat([q, q.new_zeros((B, pad, Hq, hd))], dim=1)
    n = (S + pad) // cq
    qs = q.reshape(B, n, cq, Hkv, G, hd)
    kf, vf = k.float(), v.float()
    scale = hd ** -0.5
    k_pos = torch.arange(T, device=q.device)
    outs = []
    for i in range(n):
        s = torch.einsum("bskgd,btkd->bkgst", qs[:, i].float(), kf) * scale
        q_pos = i * cq + torch.arange(cq, device=q.device) + (T - S)
        m = torch.ones((cq, T), dtype=torch.bool, device=q.device)
        if causal:
            m &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            m &= k_pos[None, :] > q_pos[:, None] - window
        p = torch.softmax(torch.where(m, s, NEG_INF), dim=-1)
        outs.append(torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype).float(), vf))
    out = torch.cat(outs, dim=1).reshape(B, S + pad, Hq, hd)
    return out[:, :S].to(q.dtype)


def _rope(cfg: ArchConfig, positions: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int],
           key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention through the flash op, converting the model's (B,S,H,hd) to
    the kernel's (B,H,S,hd) with one contiguous copy of each operand, and
    back; ``key_valid`` (B,T) bool masks keys, or is None."""
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=causal, window=window, key_valid=key_valid)
    return out.transpose(1, 2)


def _causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig,
            impl: str) -> torch.Tensor:
    """Causal (windowed) self-attention of a prompt: the flash op, or on a
    tensor off the card ``chunked_gqa_attend`` where ``impl`` is
    ``"chunked"``."""
    if impl not in ("dense", "chunked"):
        raise ValueError(f"attention impl {impl!r}: choose 'dense' or 'chunked'")
    if impl == "chunked" and q.device.type != "cuda":
        return chunked_gqa_attend(q, k, v, causal=True, window=cfg.sliding_window)
    return _flash(q, k, v, True, cfg.sliding_window)


def attention_forward(params: dict, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, impl: str = "dense") -> torch.Tensor:
    """Full-sequence causal self-attention (training / prefill without a
    cache); ``impl`` as in :func:`_causal`."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, _rope(cfg, positions))
    out = _causal(q, k, v, cfg, impl)
    return out.reshape(B, S, -1) @ params["wo"]


def encoder_attention(params: dict, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor) -> torch.Tensor:
    """The encoder's bidirectional self-attention: RoPE at ``positions``,
    no mask and no window (JAX ``transformer._apply_block`` with
    ``causal=False``)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, _rope(cfg, positions))
    out = _flash(q, k, v, False, None)
    return out.reshape(B, S, -1) @ params["wo"]


def project_kv_for_cross(params: dict, enc: torch.Tensor, cfg: ArchConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project encoder output once into cross-attention K/V (no RoPE), each
    (B, T, Hkv, hd): the decode kernel's layout."""
    B, T, _ = enc.shape
    hd = cfg.resolved_head_dim
    k = (enc @ params["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = (enc @ params["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return k, v


def cross_route(device_type: str, S: int) -> str:
    """How a cross-attention of S queries runs: ``"plain"`` (``gqa_attend``,
    as the JAX model) on the CPU; on the card ``"decode"`` (the decode
    kernel, which takes the valid mask) at S = 1, else ``"flash"`` (the
    flash kernel, non-causal, whose wrapper picks its design from the
    encoder mask, if any)."""
    if device_type == "cpu":
        return "plain"
    return "decode" if S == 1 else "flash"


def cross_attention(params: dict, x: torch.Tensor, cfg: ArchConfig,
                    cross_kv: Tuple[torch.Tensor, torch.Tensor],
                    cross_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B,S,d) attends over the encoder's K/V, each (B,T,Hkv,hd), with no
    RoPE; ``cross_mask`` (B,T) bool marks the valid encoder positions, or is
    None.  The path is :func:`cross_route`'s; the decode kernel takes a
    valid mask, all True where there is none."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
    ck, cv = cross_kv
    how = cross_route(x.device.type, S)
    if how == "decode":
        valid = cross_mask if cross_mask is not None else torch.ones(
            (B, ck.shape[1]), dtype=torch.bool, device=x.device)
        out = ops.decode_attention(q[:, 0], ck, cv, valid)
    elif how == "flash":
        out = _flash(q, ck, cv, False, None, cross_mask)
    else:
        mask = None if cross_mask is None else cross_mask[:, None, :].expand(B, S, ck.shape[1])
        out = gqa_attend(q, ck, cv, mask)
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
                       positions: torch.Tensor, cache: dict, impl: str = "dense"
                       ) -> Tuple[torch.Tensor, dict]:
    """Self-attention over the prompt (``impl`` as in :func:`_causal`), and
    write the (ring) cache in place."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, _rope(cfg, positions))
    out = _causal(q, k, v, cfg, impl)
    cap = cache["k"].shape[1]
    if cap == S:
        cache["k"].copy_(k)
        cache["v"].copy_(v)
    elif cap > S:
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
    pos: Union[int, torch.Tensor]              # absolute position of the new token
    rope: Tuple[torch.Tensor, torch.Tensor]    # its rope_tables
    valid: torch.Tensor                        # (B, cap) bool: slots valid after the write


def decode_step_inputs(cfg: ArchConfig, pos: Union[int, torch.Tensor], batch: int, cap: int,
                       device) -> DecodeStep:
    """The RoPE rotation at ``pos`` and the valid mask over ``cap`` cache
    slots after slot ``pos % cap`` is written, for a batch sharing ``pos``:
    a Python int, or a 0-d int64 tensor on ``device`` (the JAX
    ``jnp.int32(pos)``), from which both are built on the device, so that a
    captured step reads a new position from the same buffer."""
    if isinstance(pos, torch.Tensor):
        positions = pos.reshape(1, 1).expand(batch, 1)
    else:
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
                          step: DecodeStep, cache: dict, cache_update: str = "dus",
                          mixed_precision: bool = False) -> Tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, d) at ``step.pos``, shared by the batch.
    Writes k/v into slot ``pos % cap`` of the cache in place and attends
    over every valid slot.

    ``cache_update``: ``"dus"`` writes the slot alone (at a tensor ``pos``
    by ``index_copy_``, a device index); ``"select"`` writes back
    ``where(arange(cap) == slot, new, cache)``, the same values.
    ``mixed_precision`` takes, off the card, ``gqa_attend`` with that option
    in place of the decode op's plain version; on the card the decode
    kernel runs either way."""
    q, k, v = _project_qkv(params, x, cfg, step.rope)
    cap = cache["k"].shape[1]
    slot = step.pos % cap
    if cache_update == "select":
        sel = (torch.arange(cap, device=x.device) == slot)[None, :, None, None]
        cache["k"].copy_(torch.where(sel, k.to(cache["k"].dtype), cache["k"]))
        cache["v"].copy_(torch.where(sel, v.to(cache["v"].dtype), cache["v"]))
    elif cache_update == "dus" and isinstance(slot, torch.Tensor):
        cache["k"].index_copy_(1, slot.reshape(1), k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot.reshape(1), v.to(cache["v"].dtype))
    elif cache_update == "dus":
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
    else:
        raise ValueError(f"cache_update {cache_update!r}: choose 'dus' or 'select'")
    if mixed_precision and x.device.type != "cuda":
        out = gqa_attend(q, cache["k"], cache["v"], step.valid[:, None, :],
                         mixed_precision=True)[:, 0]
    else:
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], step.valid)
    y = out.reshape(x.shape[0], 1, -1) @ params["wo"]
    return y, cache
