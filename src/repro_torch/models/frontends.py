"""Modality-frontend STUBS (the one sanctioned carve-out).

Counterpart of the JAX package's ``models/frontends.py``.  For the audio
and vision architectures only the transformer backbone is modelled; the
mel-spectrogram/conv feature extractor and the ViT vision encoder are
stubs that hand the backbone precomputed frame or patch embeddings of the
right shape.  The draws come from an explicit ``torch.Generator`` and
cannot reproduce ``jax.random``: tests give both packages the same numpy
embeddings instead.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ArchConfig
from repro_torch.models.layers import dtype_of


def stub_frontend_embeddings(cfg: ArchConfig, generator: torch.Generator, batch: int,
                             num_tokens: Optional[int] = None) -> torch.Tensor:
    """Standard normal (batch, n, embed_dim) embeddings in ``cfg.dtype``,
    drawn on the generator's device; n defaults to the frontend's token
    count."""
    if cfg.frontend is None:
        raise ValueError(f"{cfg.name} has no frontend stub")
    n = num_tokens or cfg.frontend.num_tokens
    x = torch.randn((batch, n, cfg.frontend.embed_dim), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return x.to(dtype_of(cfg))


def frontend_token_count(cfg: ArchConfig) -> int:
    return 0 if cfg.frontend is None else cfg.frontend.num_tokens
