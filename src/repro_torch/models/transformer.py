"""Decoder stack for the architectures ported so far (ATTN blocks).

Counterpart of the JAX package's ``models/transformer.py``.  The parameter
tree has the same shape and keys: ``params["blocks"]`` is a tuple over the
in-group positions of ``_stack_plan``, each a dict of tensors stacked over
the layers, so ``convert.params_from_jax`` is a plain copy.  The JAX
``lax.scan`` over layers becomes a loop that indexes the stacked tensors.

Entry points: ``forward`` (full sequence), ``prefill`` (writes the KV
caches) and ``decode_step`` (one token against the caches, with a scalar
``pos`` shared by the batch).  Caches are updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ArchConfig, BlockKind
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       rms_norm, rms_norm_init, swiglu,
                                       swiglu_init, tree_to)

#: block kinds still to port, with the ROADMAP queue 1 item that ports them
_NOT_PORTED = {
    BlockKind.ATTN_MOE: "MoE blocks (ROADMAP queue 1 item 9)",
    BlockKind.MAMBA: "Mamba blocks (ROADMAP queue 1 item 10)",
    BlockKind.MAMBA_MOE: "Mamba blocks (ROADMAP queue 1 item 10)",
    BlockKind.RWKV: "RWKV6 blocks (ROADMAP queue 1 item 11)",
}


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
    """The stack plan, raising NotImplementedError for what is not ported."""
    if cfg.encdec is not None or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and frontend models are not ported "
            "yet (ROADMAP queue 1 item 12)")
    (kinds, n_groups), = _stack_plan(cfg)
    for kind in kinds:
        if kind in _NOT_PORTED:
            raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED[kind]} are not "
                                      "ported yet")
    return kinds, n_groups


def _layer(tree, i: int):
    """Layer ``i`` of a dict of stacked tensors (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Blocks


def _block_init(generator: torch.Generator, cfg: ArchConfig, dtype,
                n: int) -> dict:
    """Parameters of ``n`` ATTN blocks, stacked on a leading axis."""
    d, dev = cfg.d_model, generator.device
    return {
        "ln1": rms_norm_init(d, dtype, dev, (n,)),
        "attn": attn.attn_init(generator, cfg, dtype, (n,)),
        "ln2": rms_norm_init(d, dtype, dev, (n,)),
        "mlp": swiglu_init(generator, d, cfg.d_ff, dtype, (n,)),
    }


def _apply_block(p: dict, x: torch.Tensor, cfg: ArchConfig, mode: str,
                 positions: Optional[torch.Tensor], step: Optional[attn.DecodeStep],
                 cache: Optional[dict]) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "full":
        y = attn.attention_forward(p["attn"], h, cfg, positions)
    elif mode == "prefill":
        y, _ = attn.prefill_into_cache(p["attn"], h, cfg, positions, cache)
    else:
        y, _ = attn.decode_step_attention(p["attn"], h, cfg, step, cache)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(p["mlp"], h2)


def _run_stack(params_groups, kinds, x: torch.Tensor, cfg: ArchConfig,
               mode: str, caches=None, positions: Optional[torch.Tensor] = None,
               step: Optional[attn.DecodeStep] = None) -> torch.Tensor:
    """Run x through every layer: a loop over groups, and over the kinds in
    each group.  ``caches`` mirrors ``params_groups`` (stacked per kind) and
    is written in place."""
    for g in range(params_groups[0]["ln1"].shape[0]):
        for i in range(len(kinds)):
            c = None if caches is None else _layer(caches[i], g)
            x = _apply_block(_layer(params_groups[i], g), x, cfg, mode,
                             positions, step, c)
    return x


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
    params["blocks"] = tuple(_block_init(generator, cfg, dtype, n_groups)
                             for _ in kinds)
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


def forward(params: dict, cfg: ArchConfig, batch: dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full sequence -> (logits (B,S,V), moe_aux).  The aux loss is zero:
    no ported block kind has a router."""
    kinds, _ = _plan(cfg)
    x = _embed(params, cfg, batch["tokens"])
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(B, S, x.device)
    x = _run_stack(params["blocks"], kinds, x, cfg, "full", positions=positions)
    return _unembed(params, cfg, x), torch.zeros((), device=x.device)


def init_caches(params, cfg: ArchConfig, batch: int, seq_len: int):
    """Per-kind caches stacked over the groups, on the parameters' device."""
    kinds, n_groups = _plan(cfg)
    device = params["embed"].device
    return tuple(attn.init_kv_cache(cfg, batch, seq_len, dtype_of(cfg), device,
                                    (n_groups,))
                 for _ in kinds)


def prefill(params: dict, cfg: ArchConfig, batch: dict, seq_len: int):
    """Run the prompt, returning (last-token logits, caches dict)."""
    kinds, _ = _plan(cfg)
    x = _embed(params, cfg, batch["tokens"])
    B, S, _ = x.shape
    caches = init_caches(params, cfg, B, seq_len)
    x = _run_stack(params["blocks"], kinds, x, cfg, "prefill", caches,
                   positions=_positions(B, S, x.device))
    logits = _unembed(params, cfg, x[:, -1:])
    return logits, {"layers": caches}


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                pos: int, caches: dict):
    """ONE-token decode.  tokens: (B,1) int; pos: absolute position of the
    new token, shared by the batch.  Returns (logits (B,1,V), caches)."""
    kinds, _ = _plan(cfg)
    x = _embed(params, cfg, tokens)
    cap = caches["layers"][0]["k"].shape[2]        # (groups, B, cap, Hkv, hd)
    step = attn.decode_step_inputs(cfg, int(pos), x.shape[0], cap, x.device)
    x = _run_stack(params["blocks"], kinds, x, cfg, "decode", caches["layers"],
                   step=step)
    return _unembed(params, cfg, x), caches
