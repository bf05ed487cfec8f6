"""Token sampling for the serving engine.

Greedy sampling is the argmax, token for token the same as the JAX
version (both take the first index of a tie).  Temperature sampling draws
from an explicit ``torch.Generator``: it matches the JAX version in
distribution only, since the two random streams differ.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, 1, V) or (B, V) -> (B,) int64 tokens."""
    if logits.dim() == 3:
        logits = logits[:, -1]
    logits = logits.float()
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    if top_k > 0:
        kth = logits.topk(top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
