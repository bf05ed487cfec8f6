"""Paged KV-cache manager (vLLM-style pages, host-side bookkeeping).

The device-side caches are the stacked per-layer tensors built by
``transformer.init_caches``; this manager owns the *slot* dimension:
which sequence occupies which batch slot, page accounting for admission
control, and ring-buffer semantics for sliding-window architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.config import ArchConfig
from repro_torch.models.attention import kv_cache_capacity


@dataclasses.dataclass
class SeqState:
    seq_id: int
    slot: int
    length: int = 0          # tokens written so far
    max_len: int = 0


class PagedKVManager:
    """Fixed-slot cache pool with page-granular accounting."""

    def __init__(self, cfg: ArchConfig, n_slots: int, max_seq_len: int,
                 page_tokens: int = 128):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.page_tokens = page_tokens
        cap = kv_cache_capacity(cfg, max_seq_len) if cfg.n_kv_heads else 0
        self.pages_per_slot = max(1, -(-cap // page_tokens))
        self.total_pages = self.pages_per_slot * n_slots
        self.free_slots: List[int] = list(range(n_slots))
        self.seqs: Dict[int, SeqState] = {}
        self._next_id = 0

    # -- admission -----------------------------------------------------
    def can_admit(self) -> bool:
        return bool(self.free_slots)

    def admit(self, max_len: Optional[int] = None) -> SeqState:
        if not self.free_slots:
            raise RuntimeError("KV cache full: no free slots")
        slot = self.free_slots.pop(0)
        st = SeqState(seq_id=self._next_id, slot=slot,
                      max_len=max_len or self.max_seq_len)
        self._next_id += 1
        self.seqs[st.seq_id] = st
        return st

    def release(self, seq_id: int) -> None:
        st = self.seqs.pop(seq_id)
        self.free_slots.append(st.slot)
        self.free_slots.sort()

    def advance(self, seq_id: int, n_tokens: int = 1) -> None:
        st = self.seqs[seq_id]
        st.length += n_tokens
        if st.length > st.max_len:
            raise RuntimeError(f"seq {seq_id} exceeded max_len {st.max_len}")

    # -- accounting -----------------------------------------------------
    @property
    def used_pages(self) -> int:
        per = self.page_tokens
        return sum(min(-(-s.length // per), self.pages_per_slot)
                   for s in self.seqs.values())

    def utilization(self) -> float:
        return self.used_pages / max(1, self.total_pages)

    def bytes_per_slot(self) -> int:
        cfg = self.cfg
        if not cfg.n_kv_heads:
            return 0
        cap = kv_cache_capacity(cfg, self.max_seq_len)
        hd = cfg.resolved_head_dim
        n_attn = sum(1 for k in cfg.block_kinds() if k.value.startswith("attn"))
        itemsize = 2 if cfg.dtype == "bfloat16" else 4
        return 2 * cap * cfg.n_kv_heads * hd * n_attn * itemsize
