"""The engine's prefill and decode steps captured as CUDA graphs and replayed.

Counterpart of the JAX engine's ``jax.jit`` of its two steps
(``serving/engine.py`` there): XLA compiles the prefill once per prompt
shape and the decode step once per batch shape, and runs each as one
program; here each step's kernels and PyTorch ops are captured once into a
CUDA graph over static buffers and replayed, so that a prefill or a token
costs one graph launch instead of the host's dispatch of every op.

A replay reads its inputs from the addresses the capture saw: the static
buffers of :class:`PrefillGraph` (the prompt's tokens or embeddings, an
enc-dec model's frames and mask) and :class:`DecodeGraph` (the tokens (B, 1)
int64 and ``pos`` () int64), and whatever the step closes over (the
engine's parameters, caches and cross K/V buffers, which it allocates once,
outside any capture).  The TMA descriptors that the kernels encode on the
host from ``data_ptr()`` are baked into the graph too, which is why every
tensor the step reads must be such a static buffer or the graph's own
memory.  The steps' temporaries and their logits come from the memory pool
the engine gives them, one for all of its graphs, shared under the
invariant stated in ``graphs.py``: nothing a later replay reads lives in
the pool, and the logits a replay returns are read before any other graph
of the engine replays.

Capture needs a step that never waits for the host: a ``.item()``, a
``.tolist()`` or a ``bool`` of a device tensor inside it makes the capture
raise, and nothing falls back to the eager step.  On the CPU there is no
graph: the engine runs the same step functions eagerly.  The mechanics of
warm-up, capture and launch counts are ``graphs.CapturedStep``'s, which the
trainer's graph (``train.step_graph.TrainGraph``) shares.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.graphs import CapturedStep

#: a decode step on the static buffers: (tokens (B, 1), pos ()) -> logits
Step = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
#: a prefill on the static buffers: batch -> the last token's logits (B, 1, V)
Prefill = Callable[[Dict[str, torch.Tensor]], torch.Tensor]


class PrefillGraph:
    """``prefill`` captured once on the card for the prompt shape of
    ``batch`` and replayed by :meth:`replay`.

    The constructor copies ``batch`` into static buffers on ``device``
    (``tokens`` as int64) and captures ``prefill`` on them into ``pool``
    (``graphs.CapturedStep``; nothing to restore: the prefill sets every
    state it reads, so its warm-up is a real prefill that the first replay
    repeats).  ``capture_s``, ``launches`` and ``pool`` are the capture's.
    """

    def __init__(self, prefill: Prefill, batch: Dict[str, torch.Tensor],
                 device: torch.device, pool: Optional[tuple] = None):
        if device.type != "cuda":
            raise ValueError(f"PrefillGraph: a CUDA graph needs a CUDA device, got {device}")
        self.batch = {k: v.to(device, torch.long if k == "tokens" else v.dtype).clone()
                      for k, v in batch.items()}
        self._captured = CapturedStep(lambda: prefill(self.batch), device, pool=pool)
        self.logits = self._captured.out
        self.capture_s = self._captured.capture_s
        self.launches = self._captured.launches
        self.pool = self._captured.pool

    def replay(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Copy ``batch`` (the keys and shapes of the first) into the static
        buffers, replay the prefill and return the last token's logits: the
        graph's own buffer, valid until the next replay of the pool."""
        if batch.keys() != self.batch.keys():
            raise ValueError(f"PrefillGraph: batch keys {sorted(batch)}, captured with "
                             f"{sorted(self.batch)}")
        for k, v in batch.items():
            buf = self.batch[k]
            if v.shape != buf.shape:
                raise ValueError(f"PrefillGraph: batch {k!r} is {tuple(v.shape)}, captured "
                                 f"as {tuple(buf.shape)}")
            buf.copy_(v)
        return self._captured.replay()


class DecodeGraph:
    """``step`` captured once on the card and replayed by :meth:`replay`.

    The constructor copies the first token's ``tokens`` and ``pos`` into the
    static buffers and captures ``step`` on them into ``pool``
    (``graphs.CapturedStep``, ``restore``: the recurrent states the warm-up
    step advanced; the KV slot it wrote is written again, to the same
    values, by the first replay).  ``capture_s``, ``launches`` and ``pool``
    are the capture's.
    """

    def __init__(self, step: Step, tokens: torch.Tensor, pos: int,
                 restore: Sequence[torch.Tensor] = (), pool: Optional[tuple] = None):
        device = tokens.device
        if device.type != "cuda":
            raise ValueError(f"DecodeGraph: a CUDA graph needs a CUDA device, got {device}")
        self.tokens = tokens.to(torch.long).clone()
        self.pos = torch.full((), pos, dtype=torch.long, device=device)
        self._captured = CapturedStep(lambda: step(self.tokens, self.pos), device, restore,
                                      pool)
        self.logits = self._captured.out
        self.capture_s = self._captured.capture_s
        self.launches = self._captured.launches
        self.pool = self._captured.pool

    def replay(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """Copy ``tokens`` (B, 1) and ``pos`` into the static buffers, replay
        the step and return its logits: the graph's own buffer, valid until
        the next replay of the pool."""
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        return self._captured.replay()
