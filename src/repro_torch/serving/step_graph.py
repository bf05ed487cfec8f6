"""The decode step captured as one CUDA graph and replayed for each token.

Counterpart of the JAX engine's ``jax.jit`` of its decode step
(``serving/engine.py`` there): XLA compiles the step once per shape and
runs it as one program; here the step's kernels and PyTorch ops are
captured once into a CUDA graph over static buffers and replayed, so that a
token costs one graph launch instead of the host's dispatch of every op.

A replay reads its inputs from the addresses the capture saw: the tokens
(B, 1) int64 and ``pos`` () int64 buffers of :class:`DecodeGraph`, and
whatever the step closes over (the engine's parameters and caches, which
it allocates once).  The TMA descriptors that the kernels encode on the
host from ``data_ptr()`` are baked into the graph too, which is why every
tensor the step reads must be such a static buffer.  The step's own
temporaries and its logits come from the graph's private memory pool; the
logits a replay returns are overwritten by the next replay.

Capture needs a step that never waits for the host: a ``.item()``, a
``.tolist()`` or a ``bool`` of a device tensor inside it makes the capture
raise, and nothing falls back to the eager step.  On the CPU there is no
graph: the engine runs the same step function eagerly.  The mechanics of
warm-up, capture and launch counts are ``graphs.CapturedStep``'s, which the
trainer's graph (``train.step_graph.TrainGraph``) shares.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.graphs import CapturedStep

#: a decode step on the static buffers: (tokens (B, 1), pos ()) -> logits
Step = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class DecodeGraph:
    """``step`` captured once on the card and replayed by :meth:`replay`.

    The constructor copies the first token's ``tokens`` and ``pos`` into the
    static buffers and captures ``step`` on them (``graphs.CapturedStep``,
    ``restore``: the recurrent states the warm-up step advanced; the KV slot
    it wrote is written again, to the same values, by the first replay).
    ``capture_s`` and ``launches`` are the capture's.
    """

    def __init__(self, step: Step, tokens: torch.Tensor, pos: int,
                 restore: Sequence[torch.Tensor] = ()):
        device = tokens.device
        if device.type != "cuda":
            raise ValueError(f"DecodeGraph: a CUDA graph needs a CUDA device, got {device}")
        self.tokens = tokens.to(torch.long).clone()
        self.pos = torch.full((), pos, dtype=torch.long, device=device)
        self._captured = CapturedStep(lambda: step(self.tokens, self.pos), device, restore)
        self.logits = self._captured.out
        self.capture_s = self._captured.capture_s
        self.launches = self._captured.launches

    def replay(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """Copy ``tokens`` (B, 1) and ``pos`` into the static buffers, replay
        the step and return its logits: the graph's own buffer, valid until
        the next replay."""
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        return self._captured.replay()
