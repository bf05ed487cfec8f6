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
graph: the engine runs the same step function eagerly.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from repro_torch.kernels import ops

#: a decode step on the static buffers: (tokens (B, 1), pos ()) -> logits
Step = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class DecodeGraph:
    """``step`` captured once on the card and replayed by :meth:`replay`.

    The constructor copies the first token's ``tokens`` and ``pos`` into the
    static buffers, runs ``step`` once eagerly on the stream the capture
    will use (the warm-up: the kernels' first-call set-up, such as
    ``cudaFuncSetAttribute``, the SM count and cuBLAS's handle and
    workspace for that stream, happens there and not inside the capture;
    torch keeps one capture stream, so every graph shares one workspace
    rather than leaving one behind on a stream of its own), puts back the
    tensors of ``restore`` (the recurrent states the warm-up advanced; the
    KV slot it wrote is written again, to the same values, by the first
    replay), and captures ``step`` into a graph with its own memory pool.
    ``capture_s`` is the seconds all that took.

    The kernel wrappers count their launches in Python, so they count once,
    at capture, though the capture launches nothing: ``launches`` keeps what
    the capture counted (keyed as ``ops.launch_counts``), takes it back off
    the counters, and each replay adds it again.
    """

    def __init__(self, step: Step, tokens: torch.Tensor, pos: int,
                 restore: Sequence[torch.Tensor] = ()):
        device = tokens.device
        if device.type != "cuda":
            raise ValueError(f"DecodeGraph: a CUDA graph needs a CUDA device, got {device}")
        t0 = time.perf_counter()
        self.tokens = tokens.to(torch.long).clone()
        self.pos = torch.full((), pos, dtype=torch.long, device=device)
        saved = [t.clone() for t in restore]
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph)
        side = capture.capture_stream        # torch's one capture stream, for every graph
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            step(self.tokens, self.pos)
        torch.cuda.current_stream(device).wait_stream(side)
        for t, s in zip(restore, saved):
            t.copy_(s)
        del saved
        torch.cuda.synchronize(device)
        before = ops.launch_counts()
        with capture:
            self.logits = step(self.tokens, self.pos)
        self.launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                         if n != before[k]}
        ops.add_launches(self.launches, -1)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def replay(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """Copy ``tokens`` (B, 1) and ``pos`` into the static buffers, replay
        the step and return its logits: the graph's own buffer, valid until
        the next replay."""
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.logits
