"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of the JAX package's ``train/optimizer.py``, not
``torch.optim.AdamW``: the moments are fp32 whatever the parameters'
dtype, the update runs in fp32 and is cast back to each parameter's dtype
once, and only tensors with ``ndim >= 2`` decay.  The trees are the
model's nested dicts and tuples (``models.layers.tree_leaves`` order).  Unlike the JAX version, which returns
new trees, ``apply_updates`` updates the parameters, the moments and the
step counter in place, so that a step holds no second copy of them and a
CUDA graph that captures it reads the advanced counter at each replay; it
returns the same objects.  The update itself is ``kernels.ops.adamw_update``:
on the card the AdamW kernel (one pass over every leaf, as XLA fuses the
JAX version), on the CPU its plain version.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any
    nu: Any


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, in fp32 as in JAX: a () tensor on the
    step's device (the CPU for an int)."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                    0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(params) -> AdamWState:
    device = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params))


def global_norm(tree) -> torch.Tensor:
    return ref.global_norm(tree_leaves(tree))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState
                  ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step on every leaf, in place: clip the gradients by their
    global norm, update the fp32 moments, decay the matrices, and write the
    new parameters in their own dtype; the learning rate is the schedule's
    at ``state.step``, which then advances by one (in place) and gives the
    bias corrections.  Returns (params, state, {"grad_norm", "lr"}); the
    grad norm is the one before clipping."""
    lr = lr_schedule(cfg, state.step)
    state.step.add_(1)
    gnorm = ops.adamw_update(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
                             tree_leaves(state.nu), state.step, lr, b1=cfg.b1, b2=cfg.b2,
                             eps=cfg.eps, weight_decay=cfg.weight_decay,
                             grad_clip=cfg.grad_clip)
    return params, state, {"grad_norm": gnorm, "lr": lr}
