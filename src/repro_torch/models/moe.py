"""Mixture-of-Experts layer (top-k routing, SwiGLU experts).

Counterpart of the JAX package's ``models/moe.py``, without its sharding
arguments.  Three paths:

* ``moe_dense_ref`` runs every expert on every token and mixes by router
  weight: the oracle of the tests, through the plain ``moe_gmm_ref`` on any
  device.
* ``moe_capacity`` is the GShard-style fixed-capacity dispatch: each
  (token, slot) pair gets a rank within its expert in token order, pairs
  ranked past the capacity are dropped, the rest are scattered into an
  (E, C, d) buffer, run through the experts and gathered back.  The combine
  multiplies by router weight and does not renormalise after drops, as the
  JAX code does.
* ``moe_capacity_grouped`` does the same within contiguous groups of
  tokens; both go through one dispatch, which lays the (g, E, C, d) buffer
  out as (E, g*C, d) so that the experts see one batch per expert.

``moe_apply``, the layer the transformer calls, takes the ``moe_capacity``
path, or ``moe_capacity_grouped`` when asked for ``local_groups`` (the dry
run's per-shard dispatch).  Its ``dispatch_placements`` and
``group_placements`` redistribute the dispatch buffer, and the grouped
dispatch's tokens, when they are DTensors (the JAX version's sharding
constraints); elsewhere they do nothing.  The dispatch buffer is laid out
(E, g*C, d), so its group axis is the second: where JAX places the buffer
(g, E, C+1, d) over the data axes on its first dimension, the port places
(E, g*C, d) over them on its second.

The dispatched expert matmuls are :func:`repro_torch.kernels.ops.moe_gmm`:
the CUDA kernel for tensors on the card, the plain version on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import constrain, dense_init


def moe_init(generator: torch.Generator, cfg: ArchConfig, dtype,
             lead: Tuple[int, ...] = ()) -> dict:
    """Router (d, E) in fp32, whatever the model's dtype, and the experts'
    SwiGLU weights stacked on an expert axis after ``lead``."""
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(generator, d, E, torch.float32, lead),
        "w_gate": dense_init(generator, d, f, dtype, (*lead, E)),
        "w_up": dense_init(generator, d, f, dtype, (*lead, E)),
        "w_down": dense_init(generator, f, d, dtype, (*lead, E)),
    }


def _route(params: dict, x: torch.Tensor, cfg: ArchConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (weights (T,k) fp32, idx (T,k) int64, aux loss scalar).

    Top-k by a stable descending sort, so that ties go to the lower expert
    index, as ``jax.lax.top_k`` breaks them."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = x.float() @ params["router"]                         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = top[:, :k], order[:, :k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    # Switch-style load-balance aux loss.
    hard = F.one_hot(idx, E).sum(dim=1).float()                   # (T, E)
    frac_tokens = hard.mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = E * (frac_tokens * frac_probs).sum() * cfg.moe.aux_loss_coef
    return weights, idx, aux


def _expert_ffn(params: dict, xe: torch.Tensor, gmm=ops.moe_gmm) -> torch.Tensor:
    """xe: (E, C, d) contiguous -> (E, C, d): SwiGLU per expert, three
    expert matmuls through ``gmm``, each rounded to the model's dtype."""
    gate = F.silu(gmm(xe, params["w_gate"]))
    up = gmm(xe, params["w_up"])
    return gmm(gate * up, params["w_down"])


def moe_dense_ref(params: dict, x: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: run all experts on all tokens, by the plain expert matmul
    on any device (no kernel launch).  x: (T, d)."""
    weights, idx, aux = _route(params, x, cfg)
    E = cfg.moe.num_experts
    xe = x[None].expand(E, *x.shape).contiguous()                 # (E, T, d)
    ye = _expert_ffn(params, xe, ref.moe_gmm_ref)                 # (E, T, d)
    gate = (F.one_hot(idx, E) * weights[..., None]).sum(dim=1)    # (T, E)
    y = torch.einsum("te,etd->td", gate.to(ye.dtype), ye)
    return y, aux


def _ranks(idx: torch.Tensor, E: int) -> torch.Tensor:
    """idx (..., n) expert ids -> (..., n): the rank of each entry among the
    entries of the same expert before it on the last axis (token order)."""
    onehot = F.one_hot(idx, E)                                    # (..., n, E)
    return (onehot.cumsum(dim=-2) * onehot).sum(dim=-1) - 1


def _dispatch(params: dict, x: torch.Tensor, cfg: ArchConfig, g: int,
              capacity: int, placements=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch within ``g`` contiguous groups of the tokens of
    x (T, d): rank, drop, scatter, expert FFN, gather and combine.

    The buffer's rows are laid out (E, g, C), so every expert's rows of all
    groups are contiguous and the experts' input is an (E, g*C, d) view;
    one scratch row after them takes every dropped pair and is discarded
    (the JAX version's row C of each expert).  ``placements`` are those of
    the (E, g*C, d) buffer, before and after the experts."""
    T, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    Tl = T // g
    weights, idx, aux = _route(params, x, cfg)
    flat_expert = idx.reshape(g, Tl * k)
    flat_weight = weights.reshape(g, Tl * k)
    rank = _ranks(flat_expert, E)
    keep = rank < capacity
    gi = torch.arange(g, device=x.device)[:, None]
    rows = E * g * capacity
    row = torch.where(keep, (flat_expert * g + gi) * capacity + rank, rows)
    tok = gi * Tl + torch.arange(Tl, device=x.device).repeat_interleave(k)[None]

    buf = x.new_zeros((rows + 1, d))
    buf[row] = x[tok]
    xe = buf[:rows].view(E, g * capacity, d)
    xe = constrain(xe, placements)
    ye = constrain(_expert_ffn(params, xe), placements)
    ye = torch.cat([ye.reshape(rows, d), ye.new_zeros((1, d))])
    gathered = ye[row] * (flat_weight * keep).to(ye.dtype)[..., None]  # (g, Tl*k, d)
    return gathered.reshape(T, k, d).sum(dim=1), aux


def moe_capacity(params: dict, x: torch.Tensor, cfg: ArchConfig,
                 capacity: Optional[int] = None, dispatch_placements=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity scatter/gather dispatch over all tokens.  x: (T, d).
    The default capacity is ``max(1, int(capacity_factor * k * T / E))``."""
    T = x.shape[0]
    if capacity is None:
        capacity = max(1, int(cfg.moe.capacity_factor * cfg.moe.top_k * T
                              / cfg.moe.num_experts))
    return _dispatch(params, x, cfg, 1, capacity, dispatch_placements)


def moe_capacity_grouped(params: dict, x: torch.Tensor, cfg: ArchConfig,
                         n_groups: int, capacity: Optional[int] = None,
                         group_placements=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local dispatch: tokens split into ``n_groups`` contiguous groups, with
    rank, capacity and combine per group.  x: (T, d), T % n_groups == 0.

    The default capacity is that of one group, rounded so that C + 1
    divides by 16, as in the JAX version.  ``group_placements`` holds the
    placements of the tokens as (g, T/g, d) (``"x"``) and of the (E, g*C, d)
    buffer (``"dispatch"``)."""
    T, d = x.shape
    if capacity is None:
        Tl = T // n_groups
        capacity = max(1, int(cfg.moe.capacity_factor * cfg.moe.top_k * Tl
                              / cfg.moe.num_experts))
        capacity = -(-(capacity + 1) // 16) * 16 - 1
    gp = group_placements or {}
    if gp.get("x") is not None:
        x = constrain(x.reshape(n_groups, T // n_groups, d), gp["x"]).reshape(T, d)
    return _dispatch(params, x, cfg, n_groups, capacity, gp.get("dispatch"))


def moe_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
              dispatch_placements=None, local_groups: int = 0,
              group_placements=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (B, S, d), aux loss, by ``moe_capacity`` over all
    B * S tokens (the JAX version's default mode), or by
    ``moe_capacity_grouped`` in ``local_groups`` groups where there are
    more than one and they divide the tokens."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    if local_groups > 1 and (B * S) % local_groups == 0:
        y, aux = moe_capacity_grouped(params, flat, cfg, local_groups,
                                      group_placements=group_placements)
    else:
        y, aux = moe_capacity(params, flat, cfg, dispatch_placements=dispatch_placements)
    return y.reshape(B, S, d), aux
