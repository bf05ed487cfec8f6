"""Decoder stack for every block kind: attention (ATTN, ATTN_MOE), Mamba
(MAMBA, MAMBA_MOE) and RWKV6 (RWKV), with the bidirectional encoder and the
cross-attention of an encoder-decoder (seamless-m4t) and the stub frontends'
embeddings as inputs (seamless-m4t, pixtral).

Counterpart of the JAX package's ``models/transformer.py``.  The parameter
tree has the same shape and keys: ``params["blocks"]`` is a tuple over the
in-group positions of ``_stack_plan``, each a dict of tensors stacked over
the groups, so ``convert.params_from_jax`` is a plain copy.  Jamba's 1:7
Mamba:attention interleave is one group of ``attn_every`` kinds, repeated.
The JAX ``lax.scan`` over groups becomes a loop over the stacked tensors,
each taken apart once per call.  An enc-dec model adds ``enc_blocks``
(one group of ``encoder_layers`` ATTN blocks), ``enc_norm``, and
``ln_cross`` and ``cross`` in every decoder block; ``frontend_proj`` maps
frontend embeddings of another width onto ``d_model``.

Entry points: ``forward`` (full sequence), ``prefill`` (writes the caches)
and ``decode_step`` (one token against the caches, with a scalar ``pos``
shared by the batch).  A batch holds ``"tokens"`` or frontend
``"embeds"``, and for an enc-dec model ``"enc_embeds"`` and optionally
``"enc_mask"`` (B, T) bool.  The caches are per kind, as in JAX: a KV cache
for attention, the recurrent state ``{"h", "conv"}`` for Mamba and
``{"wkv", "shift_tm", "shift_cm"}`` for RWKV6; all are updated in place.
An enc-dec prefill adds the per-layer ``"cross_kv"`` and ``"cross_valid"``,
the decode kernel's valid mask over the encoder positions: the batch's
``"enc_mask"``, or all True when it has none.  A MoE block runs
``models.moe.moe_apply`` in capacity mode on the ``ln2`` output in place
of the dense SwiGLU, and its router's aux loss is summed over the layers.

The entry points take the options of the JAX ``Ctx`` as keywords, with its
defaults (``Options``); the dry run (``launch.dryrun``) sets them, and with
the defaults the path is the one above.  ``act_placements`` redistributes a
DTensor x to those placements after the embedding and after each block, the
counterpart of ``with_sharding_constraint`` (which JAX places after each
non-RWKV block only: XLA propagates shardings over the whole program, where
DTensor chooses op by op, and left alone places an RWKV stack's activations
with their sequence and width sharded and the batch whole); ``attn_impl``, ``cache_update`` and
``mixed_precision`` go to ``models.attention``; ``moe_dispatch_placements``,
``moe_local_groups`` and ``moe_group_placements`` to ``moe_apply``.  The
JAX ``unroll`` has no counterpart: the loop over groups here is unrolled
already.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ArchConfig, BlockKind
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rk
from repro_torch.models.layers import (constrain, dense_init, dtype_of,
                                       embed_init, rms_norm, rms_norm_init,
                                       swiglu, swiglu_init, tree_to)

_ATTN_KINDS = (BlockKind.ATTN, BlockKind.ATTN_MOE)
_MAMBA_KINDS = (BlockKind.MAMBA, BlockKind.MAMBA_MOE)


def _stack_plan(cfg: ArchConfig):
    """Group the layer pattern into stackable segments.

    Returns a list of (kinds_in_group: tuple, n_groups: int).  Homogeneous
    stacks give [((kind,), L)]; a periodic pattern gives [((k0..kp), L//p)].
    """
    kinds = cfg.block_kinds()
    L = len(kinds)
    if len(set(kinds)) == 1:
        return [((kinds[0],), L)]
    for p in range(1, L + 1):
        if L % p == 0 and all(kinds[i] == kinds[i % p] for i in range(L)):
            return [(tuple(kinds[:p]), L // p)]
    return [(tuple(kinds), 1)]


def _plan(cfg: ArchConfig):
    """The stack plan.  Raises NotImplementedError for an encoder under a
    decoder without cross-attention (RWKV blocks, or ``cross_attention``
    off), which the JAX model cannot run either: it finds no ``cross``
    parameters to project the encoder's output with."""
    (kinds, n_groups), = _stack_plan(cfg)
    if cfg.encdec is not None and (not cfg.encdec.cross_attention
                                   or BlockKind.RWKV in kinds):
        raise NotImplementedError(
            f"{cfg.name}: an encoder needs cross-attention in every decoder "
            "block, and an RWKV decoder has none")
    return kinds, n_groups


def _layer(tree, i: int):
    """Layer ``i`` of a dict of stacked tensors (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a dict of stacked tensors, each leaf taken apart
    once by ``unbind`` (views, no copy).  Under autograd that is one stack
    of the layers' gradients per leaf in the backward, where indexing each
    layer would zero-fill a gradient the size of the whole stack for every
    layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][g] for k in per} for g in range(n)]
    return tree.unbind(0)


# ---------------------------------------------------------------------------
# Blocks


def _block_init(generator: torch.Generator, kind: BlockKind, cfg: ArchConfig,
                dtype, n: int, cross: bool = False) -> dict:
    """Parameters of ``n`` blocks of ``kind``, stacked on a leading axis, with
    the keys of the JAX ``_block_init``: ``"attn"`` or ``"mamba"``, then
    ``"ln_cross"`` and ``"cross"`` if ``cross``, then ``"moe"`` (MoE kinds)
    or ``"mlp"``; an RWKV block has ``"rwkv"`` and ``"ln2"`` only, its
    channel mix living in ``"rwkv"``."""
    d, dev = cfg.d_model, generator.device
    p = {"ln1": rms_norm_init(d, dtype, dev, (n,))}
    if kind == BlockKind.RWKV:
        p["rwkv"] = rk.rwkv_init(generator, cfg, dtype, (n,))
        p["ln2"] = rms_norm_init(d, dtype, dev, (n,))
        return p
    if kind in _ATTN_KINDS:
        p["attn"] = attn.attn_init(generator, cfg, dtype, (n,))
    else:
        p["mamba"] = mb.mamba_init(generator, cfg, dtype, (n,))
    if cross:
        p["ln_cross"] = rms_norm_init(d, dtype, dev, (n,))
        p["cross"] = attn.attn_init(generator, cfg, dtype, (n,))
    p["ln2"] = rms_norm_init(d, dtype, dev, (n,))
    if kind in (BlockKind.ATTN_MOE, BlockKind.MAMBA_MOE):
        p["moe"] = moe_mod.moe_init(generator, cfg, dtype, (n,))
    else:
        p["mlp"] = swiglu_init(generator, d, cfg.d_ff, dtype, (n,))
    return p


@dataclasses.dataclass(frozen=True)
class Options:
    """The options of the JAX ``Ctx`` that the dry run selects; the defaults
    are the JAX package's and leave the path as it is."""
    act_placements: Any = None          # DTensor placements of x between blocks
    attn_impl: str = "dense"            # "dense" | "chunked" (off the card)
    cache_update: str = "dus"           # "dus" | "select"
    mixed_precision: bool = False       # decode's plain attention (off the card)
    moe_dispatch_placements: Any = None # placements of the (E, C, d) dispatch
    moe_local_groups: int = 0           # per-shard local dispatch groups
    moe_group_placements: Any = None    # {"x", "dispatch"} of the grouped dispatch


DEFAULT_OPTIONS = Options()


def _store(cache: dict, new: dict) -> None:
    """Write a block's new recurrent state into its cache views in place."""
    for k, v in new.items():
        cache[k].copy_(v)


def _apply_block(kind: BlockKind, p: dict, x: torch.Tensor, cfg: ArchConfig, mode: str,
                 positions: Optional[torch.Tensor], step: Optional[attn.DecodeStep],
                 cache: Optional[dict], cross=None, opts: Options = DEFAULT_OPTIONS
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, moe aux loss); a block without MoE has no aux loss (None).
    In "prefill" and "decode" mode ``cache`` is the block's cache, read and
    written in place; in "full" and "encode" (the encoder's bidirectional
    attention) mode it is None.  ``cross`` is the layer's encoder K/V and
    key mask, ``(k, v, mask)``, or None."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == BlockKind.RWKV:
        y, tm = rk.rwkv_time_mix(p["rwkv"], h, cfg, cache)
        x = x + y
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        y2, cm = rk.rwkv_channel_mix(p["rwkv"], h2, None if cache is None else cache["shift_cm"])
        if cache is not None:
            _store(cache, {**tm, "shift_cm": cm})
        return constrain(x + y2, opts.act_placements), None

    if kind in _MAMBA_KINDS:
        y, new = mb.mamba_forward(p["mamba"], h, cfg, cache)    # decode: S = 1 from the state
        if cache is not None:
            _store(cache, new)
    elif mode == "full":
        y = attn.attention_forward(p["attn"], h, cfg, positions, impl=opts.attn_impl)
    elif mode == "encode":
        y = attn.encoder_attention(p["attn"], h, cfg, positions)
    elif mode == "prefill":
        y, _ = attn.prefill_into_cache(p["attn"], h, cfg, positions, cache,
                                       impl=opts.attn_impl)
    else:
        y, _ = attn.decode_step_attention(p["attn"], h, cfg, step, cache,
                                          opts.cache_update, opts.mixed_precision)
    x = x + y
    if cross is not None:
        ck, cv, mask = cross
        hc = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        x = x + attn.cross_attention(p["cross"], hc, cfg, (ck, cv), mask)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if "moe" in p:
        y2, aux = moe_mod.moe_apply(p["moe"], h2, cfg,
                                    dispatch_placements=opts.moe_dispatch_placements,
                                    local_groups=opts.moe_local_groups,
                                    group_placements=opts.moe_group_placements)
    else:
        y2 = swiglu(p["mlp"], h2)
    return constrain(x + y2, opts.act_placements), aux


def _run_stack(params_groups, kinds, x: torch.Tensor, cfg: ArchConfig,
               mode: str, caches=None, positions: Optional[torch.Tensor] = None,
               step: Optional[attn.DecodeStep] = None, cross=None, remat: bool = False,
               opts: Options = DEFAULT_OPTIONS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run x through every layer: a loop over groups, and over the kinds in
    each group.  ``caches`` mirrors ``params_groups`` (stacked per kind) and
    is written in place.  ``cross`` is ``(cross_kv, mask)``: the encoder's
    K/V of every layer (``_cross_kv_all_layers``) and its key mask or None
    (JAX ``_run_stack_cross``).  ``remat`` (no caches) recomputes each
    group's activations in the backward instead of keeping them: the group's
    body runs under ``torch.utils.checkpoint``, as JAX's under
    ``jax.checkpoint``.  Returns (x, the aux losses summed over layers)."""
    n_groups = params_groups[0]["ln1"].shape[0]
    layers = [_unstack(p, n_groups) for p in params_groups]

    def group(x, g_params, g_caches, g_cross):
        """The group's blocks: (x, their aux losses summed, or None)."""
        total = None
        for i, kind in enumerate(kinds):
            x, aux = _apply_block(kind, g_params[i], x, cfg, mode, positions, step,
                                  g_caches[i], g_cross[i], opts)
            if aux is not None:
                total = aux if total is None else total + aux
        return x, total

    total = torch.zeros((), device=x.device)
    for g in range(n_groups):
        g_params = tuple(p[g] for p in layers)
        g_caches = ((None,) * len(kinds) if caches is None
                    else tuple(_layer(c, g) for c in caches))
        g_cross = ((None,) * len(kinds) if cross is None
                   else tuple((ck[g], cv[g], cross[1]) for ck, cv in cross[0]))
        if remat and caches is None and torch.is_grad_enabled():
            # the forward draws no random numbers, so the recompute needs no saved
            # RNG state (whose read a CUDA graph's capture may refuse)
            x, aux = checkpoint(group, x, g_params, g_caches, g_cross, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = group(x, g_params, g_caches, g_cross)
        if aux is not None:
            total = total + aux
    return x, total


# ---------------------------------------------------------------------------
# Model


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters drawn from ``generator`` on its device, then moved
    to ``device`` if another is given.  The tree matches the JAX
    ``init_params``."""
    dtype = dtype_of(cfg)
    kinds, n_groups = _plan(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": rms_norm_init(cfg.d_model, dtype, generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dtype)
    cross = cfg.encdec is not None
    params["blocks"] = tuple(_block_init(generator, kind, cfg, dtype, n_groups, cross)
                             for kind in kinds)
    # drawn after the decoder, so that a config without them keeps its weights
    if cfg.encdec is not None:
        params["enc_blocks"] = (_block_init(generator, BlockKind.ATTN, _encoder_cfg(cfg),
                                            dtype, cfg.encdec.encoder_layers),)
        params["enc_norm"] = rms_norm_init(cfg.d_model, dtype, generator.device)
    if cfg.frontend is not None and cfg.frontend.embed_dim != cfg.d_model:
        params["frontend_proj"] = dense_init(generator, cfg.frontend.embed_dim,
                                             cfg.d_model, dtype)
    return params if device is None else tree_to(params, device)


def _embed(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _unembed(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, sliding_window=None)


def _encode(params, cfg: ArchConfig, enc_embeds: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over stub frame embeddings (B, T, embed_dim) ->
    (B, T, d).  Like the JAX encoder it applies no key mask."""
    x = enc_embeds
    if "frontend_proj" in params:
        x = x @ params["frontend_proj"]
    B, T, _ = x.shape
    x, _ = _run_stack(params["enc_blocks"], (BlockKind.ATTN,), x, _encoder_cfg(cfg),
                      "encode", positions=_positions(B, T, x.device))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv_all_layers(params, cfg: ArchConfig, enc_out: torch.Tensor):
    """Project the encoder's output into every decoder layer's cross K/V: a
    tuple over the in-group kinds of (k, v), each (n_groups, B, T, Hkv, hd)."""
    kinds, n_groups = _plan(cfg)
    out = []
    for i in range(len(kinds)):
        p = params["blocks"][i]["cross"]
        ks, vs = zip(*(attn.project_kv_for_cross(_layer(p, g), enc_out, cfg)
                       for g in range(n_groups)))
        out.append((torch.stack(ks), torch.stack(vs)))
    return tuple(out)


def model_inputs_to_embeds(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Token or stub-frontend embeddings -> (B, S, d): ``"embeds"`` replaces
    the tokens, through ``frontend_proj`` where the model has one."""
    if "embeds" in batch:
        x = batch["embeds"]
        if "frontend_proj" in params:
            x = x @ params["frontend_proj"]
        return x
    return _embed(params, cfg, batch["tokens"])


def _encode_for_cross(params, cfg: ArchConfig, batch: dict):
    """Encode ``batch["enc_embeds"]`` and project it for every decoder
    layer: (``_cross_kv_all_layers``'s K/V, the batch's ``enc_mask`` as
    bool or None)."""
    enc_out = _encode(params, cfg, batch["enc_embeds"])
    mask = batch.get("enc_mask")
    return _cross_kv_all_layers(params, cfg, enc_out), None if mask is None else mask.bool()


def forward(params: dict, cfg: ArchConfig, batch: dict, remat: bool = False,
            **options) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full sequence -> (logits (B,S,V), moe_aux): the routers' aux loss
    summed over the layers, zero for a dense model.  ``remat`` recomputes
    each layer group's activations in the backward (training); ``options``
    are ``Options``' fields."""
    opts = Options(**options)
    kinds, _ = _plan(cfg)
    x = constrain(model_inputs_to_embeds(params, cfg, batch), opts.act_placements)
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(B, S, x.device)
    cross = None if cfg.encdec is None else _encode_for_cross(params, cfg, batch)
    x, aux = _run_stack(params["blocks"], kinds, x, cfg, "full", positions=positions,
                        cross=cross, remat=remat, opts=opts)
    return _unembed(params, cfg, x), aux


def init_caches(params, cfg: ArchConfig, batch: int, seq_len: int):
    """Per-kind caches stacked over the groups, on the parameters' device:
    a KV cache for attention, the recurrent state for Mamba and RWKV6."""
    kinds, n_groups = _plan(cfg)
    device, dtype, lead = params["embed"].device, dtype_of(cfg), (n_groups,)

    def one(kind):
        if kind in _ATTN_KINDS:
            return attn.init_kv_cache(cfg, batch, seq_len, dtype, device, lead)
        if kind in _MAMBA_KINDS:
            return mb.mamba_init_state(cfg, batch, dtype, device, lead)
        return rk.rwkv_init_state(cfg, batch, dtype, device, lead)

    return tuple(one(kind) for kind in kinds)


def init_cross_caches(params, cfg: ArchConfig, batch: int, frames: int) -> dict:
    """Zeroed buffers of an enc-dec prefill's ``"cross_kv"`` and
    ``"cross_valid"`` for ``batch`` rows of ``frames`` encoder frames, the
    shapes and dtypes ``prefill`` returns, on the parameters' device."""
    kinds, n_groups = _plan(cfg)
    device, dtype = params["embed"].device, dtype_of(cfg)
    shape = (n_groups, batch, frames, cfg.n_kv_heads, cfg.resolved_head_dim)
    kv = tuple((torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device)) for _ in kinds)
    return {"cross_kv": kv,
            "cross_valid": torch.zeros((batch, frames), dtype=torch.bool, device=device)}


def recurrent_states(cfg: ArchConfig, caches) -> list:
    """The Mamba and RWKV6 states of ``init_caches``' tree: what a prefill
    reads as its initial state and a decode step advances.  (A KV cache is
    written slot by slot and read under the valid mask, so what an earlier
    request left in it is never read.)"""
    kinds, _ = _plan(cfg)
    return [t for kind, c in zip(kinds, caches) if kind not in _ATTN_KINDS
            for t in c.values()]


def prefill(params: dict, cfg: ArchConfig, batch: dict, seq_len: int,
            caches=None, **options):
    """Run the prompt, returning (last-token logits, caches dict).  The
    layers' caches are ``caches`` when given (``init_caches``' tree, written
    in place: the dry run's sharded ones), else new; ``options`` are
    ``Options``' fields."""
    opts = Options(**options)
    kinds, _ = _plan(cfg)
    x = constrain(model_inputs_to_embeds(params, cfg, batch), opts.act_placements)
    B, S, _ = x.shape
    if caches is None:
        caches = init_caches(params, cfg, B, seq_len)
    extra, cross = {}, None
    if cfg.encdec is not None:
        cross = ckv, mask = _encode_for_cross(params, cfg, batch)
        extra["cross_kv"] = ckv
        extra["cross_valid"] = mask if mask is not None else torch.ones(
            batch["enc_embeds"].shape[:2], dtype=torch.bool, device=x.device)
    x, _ = _run_stack(params["blocks"], kinds, x, cfg, "prefill", caches,
                      positions=_positions(B, S, x.device), cross=cross, opts=opts)
    logits = _unembed(params, cfg, x[:, -1:])
    return logits, {"layers": caches, **extra}


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                pos, caches: dict, **options):
    """ONE-token decode.  tokens: (B,1) int; pos: absolute position of the
    new token, shared by the batch: a Python int, or a 0-d int64 tensor on
    the step's device, as the JAX step takes ``jnp.int32(pos)`` (what a
    captured step needs: ``serving.step_graph``).  Returns (logits
    (B,1,V), caches); ``options`` are ``Options``' fields."""
    opts = Options(**options)
    kinds, _ = _plan(cfg)
    x = constrain(_embed(params, cfg, tokens), opts.act_placements)
    step = None
    first_attn = next((i for i, k in enumerate(kinds) if k in _ATTN_KINDS), None)
    if first_attn is not None:
        cap = caches["layers"][first_attn]["k"].shape[2]   # (groups, B, cap, Hkv, hd)
        if not isinstance(pos, torch.Tensor):
            pos = int(pos)
        step = attn.decode_step_inputs(cfg, pos, x.shape[0], cap, x.device)
    cross = None
    if cfg.encdec is not None and "cross_kv" in caches:
        cross = (caches["cross_kv"], caches["cross_valid"])
    x, _ = _run_stack(params["blocks"], kinds, x, cfg, "decode", caches["layers"],
                      step=step, cross=cross, opts=opts)
    return _unembed(params, cfg, x), caches
