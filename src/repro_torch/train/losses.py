"""LM losses: cross-entropy (+ z-loss) with optional MoE aux loss.

Counterpart of the JAX package's ``train/losses.py``: the same terms, in
fp32 whatever the logits' dtype."""
from __future__ import annotations

from typing import Optional

import torch


def _is_dtensor(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss_coef: float = 1e-4) -> dict:
    """logits: (B, S, V); labels: (B, S) int; mask: (B, S) 1=count."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if _is_dtensor(logits):
        # the dry run's vocab-sharded logits: DTensor's sharded gather does not
        # trace on meta shards; the label's column picked by a mask is the
        # same value (the one non-zero of its row's sum)
        cols = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(cols == labels.long()[..., None], logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    zl = z_loss_coef * lse.square()
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    mean_nll = (nll * mask).sum() / denom
    return {
        "loss": ((nll + zl) * mask).sum() / denom,
        "nll": mean_nll,
        "ppl_proxy": torch.exp(torch.clamp(mean_nll, 0, 20.0)),
        "tokens": denom,
    }
