"""Synthetic-but-structured LM data pipeline.

Deterministic, seed-sharded token streams with learnable structure (a
Zipfian unigram base measure mixed with a repeated-ngram process), so a
~100M model trained a few hundred steps shows a *decreasing* loss — good
enough to validate the training substrate end-to-end without external
datasets (offline container).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.35       # P(copy an earlier ngram) — compressible
    ngram: int = 8


class SyntheticLM:
    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self._rng = np.random.default_rng(cfg.seed * 1009 + shard)
        # Zipfian base distribution over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def _sequence(self) -> np.ndarray:
        c = self.cfg
        toks = np.empty(c.seq_len + 1, dtype=np.int32)
        i = 0
        while i < c.seq_len + 1:
            if i > c.ngram and self._rng.random() < c.repeat_p:
                # copy an earlier ngram (induction-head learnable)
                start = self._rng.integers(0, i - c.ngram)
                n = min(c.ngram, c.seq_len + 1 - i)
                toks[i:i + n] = toks[start:start + n]
                i += n
            else:
                toks[i] = self._rng.choice(c.vocab_size, p=self._p)
                i += 1
        return toks

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        c = self.cfg
        while True:
            seqs = np.stack([self._sequence() for _ in range(c.batch_size)])
            yield {
                "tokens": seqs[:, :-1],
                "labels": seqs[:, 1:].astype(np.int32),
            }
