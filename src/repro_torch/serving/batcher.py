"""Continuous batcher: admission queue + iteration-level scheduling.

Decode steps run at fixed batch width (the compiled shape); finished or
empty slots are masked.  New requests join at the next iteration boundary
(Orca-style iteration-level scheduling), which is what keeps the paper's
serving story honest when the "function" is a model endpoint.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

from repro_torch.serving.kvcache import PagedKVManager


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_tokens: list
    max_new_tokens: int
    arrived_at: float = 0.0
    seq_id: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)


class ContinuousBatcher:
    def __init__(self, kv: PagedKVManager, max_batch: int):
        self.kv = kv
        self.max_batch = max_batch
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}    # slot -> request
        self._next_req = 0

    def submit(self, prompt_tokens: list, max_new_tokens: int,
               now: float = 0.0) -> Request:
        r = Request(self._next_req, list(prompt_tokens), max_new_tokens,
                    arrived_at=now)
        self._next_req += 1
        self.waiting.append(r)
        return r

    def admit_ready(self) -> List[Request]:
        """Move waiting requests into free slots (to be prefilled)."""
        admitted = []
        while (self.waiting and len(self.running) < self.max_batch
               and self.kv.can_admit()):
            r = self.waiting.popleft()
            st = self.kv.admit()
            r.seq_id = st.seq_id
            self.running[st.slot] = r
            self.kv.advance(st.seq_id, r.prompt_len)
            admitted.append(r)
        return admitted

    def record_token(self, slot: int, token: int) -> None:
        r = self.running[slot]
        r.generated.append(int(token))
        self.kv.advance(r.seq_id, 1)
        if len(r.generated) >= r.max_new_tokens:
            self.finish(slot)

    def finish(self, slot: int) -> None:
        r = self.running.pop(slot)
        r.done = True
        self.kv.release(r.seq_id)

    @property
    def active_slots(self) -> List[int]:
        return sorted(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
