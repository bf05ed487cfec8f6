"""A step captured once as a CUDA graph and replayed: the mechanics that the
engine's prefill and decode graphs (``serving.step_graph.PrefillGraph``,
``DecodeGraph``) and the trainer's step graph (``train.step_graph.TrainGraph``)
share.

Graphs may share one memory pool (``pool``, a ``torch.cuda.graph_pool_handle``):
the engine captures all of its graphs, prefill and decode, into one, and the
trainer's graph keeps a pool of its own.  Graphs that share a pool reuse each
other's freed blocks, so a replay may overwrite any pool memory that no live
tensor holds.  Sharing is safe, whatever order the graphs are captured and
replayed in, under one invariant: **nothing that a later replay reads lives in
the pool**.  Every tensor a graph reads across replays (the weights, the
caches, the recurrent states, the cross K/V) is allocated outside any
capture.  The only pool tensors read after a replay are its own outputs
(``CapturedStep.out``), and since a graph captured earlier may have used
their blocks as scratch, the caller reads them before any other graph of the
pool replays.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.kernels import ops


class CapturedStep:
    """``run`` (a function of no arguments that reads only static buffers)
    run once eagerly and captured once as a CUDA graph on ``device``.

    The warm-up runs ``run`` on the stream the capture will use (the kernels'
    first-call set-up, such as ``cudaFuncSetAttribute``, the SM count and
    cuBLAS's handle and workspace for that stream, happens there and not
    inside the capture; torch keeps one capture stream, so every graph
    shares one workspace rather than leaving one behind on a stream of its
    own); its result is ``warm_up``.  The tensors of ``restore`` (state the
    warm-up advanced that the first replay must find as it was) are then put
    back, and ``run`` is captured into a graph whose memory comes from
    ``pool`` (shared with other graphs under the invariant of this module's
    docstring), or from a pool of its own where ``pool`` is None; torch's
    capture context empties the allocator's cache first, so the pool can
    take what the warm-up freed.  ``out`` is what the capture returned, the
    graph's own tensors, overwritten by every replay; ``pool`` the id of the
    pool it was captured in.  ``capture_s`` is the seconds all that took.  A
    ``run`` that cannot be captured raises, and nothing runs in its place.

    The kernel wrappers count their launches in Python, so they count once,
    at capture, though the capture launches nothing: ``launches`` keeps what
    the capture counted (keyed as ``ops.launch_counts``), takes it back off
    the counters, and each replay adds it again.
    """

    def __init__(self, run: Callable[[], Any], device: torch.device,
                 restore: Sequence[torch.Tensor] = (), pool: Optional[tuple] = None):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        t0 = time.perf_counter()
        saved = [t.clone() for t in restore]
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph, pool=pool)
        side = capture.capture_stream        # torch's one capture stream, for every graph
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.warm_up = run()
        torch.cuda.current_stream(device).wait_stream(side)
        for t, s in zip(restore, saved):
            t.copy_(s)
        del saved
        torch.cuda.synchronize(device)
        before = ops.launch_counts()
        with capture:
            self.out = run()
        self.launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                         if n != before[k]}
        ops.add_launches(self.launches, -1)
        torch.cuda.synchronize(device)
        self.pool = self.graph.pool()
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """Replay the graph and return ``out``."""
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.out
