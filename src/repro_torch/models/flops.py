"""Analytic parameter / FLOP accounting.

Counterpart of the JAX package's ``models/flops.py``.  ``param_count``
derives N from the *actual* parameter tree, as JAX does through
``jax.eval_shape``: ``init_params`` runs under a ``FakeTensorMode``, so its
tensors carry shapes and dtypes and no storage, and nothing is allocated
however large the config.  ``model_flops`` implements the standard 6·N·D
(train) / 2·N·D (inference) estimates with MoE N_active, used for the
"useful compute" ratio.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import ArchConfig, ArchType, InputShape, StepKind
from repro_torch.models.layers import tree_leaves


@functools.lru_cache(maxsize=64)
def _param_shapes(cfg: ArchConfig) -> Tuple[Tuple[int, ...], ...]:
    """The shape of every leaf of ``init_params(cfg)``, from a draw on fake
    tensors (no storage)."""
    from repro_torch.models import transformer
    generator = torch.Generator().manual_seed(0)
    with FakeTensorMode():
        tree = transformer.init_params(cfg, generator)
        return tuple(tuple(leaf.shape) for leaf in tree_leaves(tree))


def param_count(cfg: ArchConfig) -> int:
    if cfg.arch_type == ArchType.MICRO:
        return 0
    return sum(math.prod(s) for s in _param_shapes(cfg))


def _expert_params_per_moe_layer(cfg: ArchConfig) -> int:
    # SwiGLU experts: 3 * d * d_ff each.
    return 3 * cfg.d_model * cfg.d_ff


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: top_k of num_experts)."""
    if cfg.arch_type == ArchType.MICRO:
        return 0
    n = param_count(cfg)
    if cfg.moe is None:
        return n
    per_layer = _expert_params_per_moe_layer(cfg)
    n_moe_layers = sum(1 for k in cfg.block_kinds() if "moe" in k.value)
    inactive = per_layer * (cfg.moe.num_experts - cfg.moe.top_k) * n_moe_layers
    return n - inactive


def _nonembedding_active(cfg: ArchConfig) -> int:
    n = active_param_count(cfg)
    emb = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        emb *= 2
    return n - emb


def attention_flops(cfg: ArchConfig, seq_len: int, batch: int,
                    kv_len: int | None = None) -> int:
    """Score+PV matmul FLOPs for all attention layers (fwd)."""
    if cfg.arch_type == ArchType.MICRO or cfg.n_heads == 0:
        return 0
    kinds = cfg.block_kinds()
    n_attn = sum(1 for k in kinds if k.value.startswith("attn"))
    hd = cfg.resolved_head_dim
    kv = kv_len if kv_len is not None else seq_len
    if cfg.sliding_window is not None:
        kv = min(kv, cfg.sliding_window)
    # 2 matmuls (QK^T and PV), 2 flops per MAC; causal halves the prefill cost
    per_layer = 2 * 2 * batch * seq_len * kv * cfg.n_heads * hd
    if kv_len is None:
        per_layer //= 2
    return n_attn * per_layer


def model_flops(cfg: ArchConfig, shape: InputShape) -> Dict[str, float]:
    """MODEL_FLOPS per executed step (the roofline 'useful compute')."""
    if cfg.arch_type == ArchType.MICRO:
        return {"model_flops": 0.0, "tokens": 0.0}
    N = _nonembedding_active(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.step == StepKind.TRAIN:
        tokens = B * S
        f = 6.0 * N * tokens + 3.0 * attention_flops(cfg, S, B)
        # unembed fwd+bwd
        f += 6.0 * cfg.d_model * cfg.vocab_size * tokens
    elif shape.step == StepKind.PREFILL:
        tokens = B * S
        f = 2.0 * N * tokens + attention_flops(cfg, S, B)
        f += 2.0 * cfg.d_model * cfg.vocab_size * B  # last-token logits only
    else:  # DECODE: one token per sequence, KV length = seq_len
        tokens = B
        f = 2.0 * N * tokens + attention_flops(cfg, 1, B, kv_len=S)
        f += 2.0 * cfg.d_model * cfg.vocab_size * B
    return {"model_flops": f, "tokens": float(tokens)}
