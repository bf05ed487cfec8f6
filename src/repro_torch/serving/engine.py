"""Serving engine: prefill and decode steps plus the generation loop.

Counterpart of the JAX package's ``serving/engine.py``, with the same API
and step-time semantics: ``step_times_s[0]`` is the prefill, the rest are
decode steps, and ``mean_decode_step_us`` averages the decode steps only.
Each step is timed on the host clock up to ``torch.cuda.synchronize()``,
where the JAX engine waits with ``block_until_ready``.

It runs on the card unless the caller passes ``device="cpu"``; there the
attention ops take their plain versions.  ``params=`` takes a ready tree,
for example JAX weights from ``models.convert.params_from_jax``.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from repro_torch.config import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.kvcache import PagedKVManager
from repro_torch.serving.sampling import sample


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it asks for a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for the plain path")
    return dev


class ServingEngine:
    def __init__(self, cfg: ArchConfig, *, batch_slots: int = 4,
                 max_seq_len: int = 256, seed: int = 0, device="cuda",
                 params: Optional[dict] = None):
        self.cfg = cfg
        self.max_seq_len = max_seq_len
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = T.init_params(cfg, gen, self.device)
        self.params = params
        self.kv = PagedKVManager(cfg, batch_slots, max_seq_len)
        self.batcher = ContinuousBatcher(self.kv, batch_slots)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.step_times_s: List[float] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(self, prompts: List[List[int]], max_new_tokens: int = 8,
                 temperature: float = 0.0) -> List[List[int]]:
        """Batched greedy/temperature generation (all prompts same length;
        the batcher handles slot lifecycle)."""
        reqs = [self.batcher.submit(p, max_new_tokens) for p in prompts]
        self.batcher.admit_ready()
        plen = len(prompts[0])
        if any(len(p) != plen for p in prompts):
            raise ValueError("batch requires equal prompt lengths")
        tokens = torch.tensor(prompts, dtype=torch.long, device=self.device)
        t0 = time.perf_counter()
        logits, caches = T.prefill(self.params, self.cfg, {"tokens": tokens},
                                   seq_len=self.max_seq_len)
        self._sync()
        self.step_times_s.append(time.perf_counter() - t0)
        pos = plen
        next_tok = sample(logits, self._gen, temperature)
        toks = next_tok.tolist()
        for slot, r in list(self.batcher.running.items()):
            self.batcher.record_token(slot, toks[slot])
        while any(not r.done for r in reqs) and pos < self.max_seq_len - 1:
            t0 = time.perf_counter()
            logits, caches = T.decode_step(self.params, self.cfg,
                                           next_tok[:, None], pos, caches)
            self._sync()
            self.step_times_s.append(time.perf_counter() - t0)
            next_tok = sample(logits, self._gen, temperature)
            toks = next_tok.tolist()
            pos += 1
            for slot in list(self.batcher.running):
                self.batcher.record_token(slot, toks[slot])
            if not self.batcher.running:
                break
        return [r.generated for r in reqs]

    # ------------------------------------------------------------------
    def mean_decode_step_us(self) -> float:
        if len(self.step_times_s) <= 1:
            return float("nan")
        return 1e6 * sum(self.step_times_s[1:]) / len(self.step_times_s[1:])
