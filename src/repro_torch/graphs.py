"""A step captured once as a CUDA graph and replayed: the mechanics that the
engine's decode graph (``serving.step_graph.DecodeGraph``) and the trainer's
step graph (``train.step_graph.TrainGraph``) share.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Sequence

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
    back, and ``run`` is captured into a graph with its own memory pool
    (torch's capture context empties the allocator's cache first, so the
    pool can take what the warm-up freed); ``out`` is what the capture
    returned, the graph's own tensors, overwritten by every replay.
    ``capture_s`` is the seconds all that took.  A ``run`` that cannot be
    captured raises, and nothing runs in its place.

    The kernel wrappers count their launches in Python, so they count once,
    at capture, though the capture launches nothing: ``launches`` keeps what
    the capture counted (keyed as ``ops.launch_counts``), takes it back off
    the counters, and each replay adds it again.
    """

    def __init__(self, run: Callable[[], Any], device: torch.device,
                 restore: Sequence[torch.Tensor] = ()):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        t0 = time.perf_counter()
        saved = [t.clone() for t in restore]
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph)
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
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """Replay the graph and return ``out``."""
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.out
