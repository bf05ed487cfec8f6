"""The training step captured as one CUDA graph and replayed for each step.

Counterpart of the JAX trainer's ``jax.jit`` of its train step
(``train/train_loop.py`` there): XLA compiles forward, backward, the clip
and the AdamW update into one program; here the step of ``make_train_step``
(the forward under remat, the loss, ``torch.autograd.grad`` over every leaf
and ``apply_updates``, whose update is the AdamW kernel) is captured once
into a CUDA graph over static batch buffers and replayed, so that a step
costs one graph launch instead of the host's dispatch of every op.

A replay reads the addresses the capture saw: the batch buffers of
:class:`TrainGraph`, and the parameters, the moments and the step counter,
which ``apply_updates`` updates in place (the counter too, so that each
replay takes the next learning rate and bias corrections).  The step's
activations, gradients and metrics come from the graph's private memory
pool; the metrics a replay returns are overwritten by the next replay.  The
first step runs eagerly as the warm-up: it is a real step, so nothing has
to be put back, and the capture, which executes nothing, follows it.
Capture needs a step that never waits for the host and never copies a
host tensor to the card; a step that does raises, and nothing falls back to
the eager step.  On the CPU there is no graph: ``train`` runs the same step
eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.graphs import CapturedStep


class TrainGraph:
    """``step`` (``make_train_step``'s) on ``params`` and ``opt_state``,
    run once on ``batch`` (the warm-up, whose metrics are
    ``first_metrics``) and captured on static copies of its tensors.

    :meth:`replay` takes the next batch: each later step is one replay.
    ``capture_s`` is the seconds of the warm-up step and the capture;
    ``launches`` the kernel launches of one replay (``graphs.CapturedStep``).
    """

    def __init__(self, step: Callable, params, opt_state, batch: Dict[str, torch.Tensor]):
        device = opt_state.step.device
        if device.type != "cuda":
            raise ValueError(f"TrainGraph: a CUDA graph needs a CUDA device, got {device}")
        self.batch = {k: v.clone() for k, v in batch.items()}
        self._captured = CapturedStep(lambda: step(params, opt_state, self.batch)[2], device)
        self.first_metrics = self._captured.warm_up
        self.capture_s = self._captured.capture_s
        self.launches = self._captured.launches

    def replay(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Copy ``batch`` (the keys, shapes and dtypes of the first) into the
        static buffers, replay the step and return its metrics: () tensors
        of the graph, valid until the next replay."""
        if batch.keys() != self.batch.keys():
            raise ValueError(f"TrainGraph: batch keys {sorted(batch)}, captured with "
                             f"{sorted(self.batch)}")
        for k, v in batch.items():
            buf = self.batch[k]
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise ValueError(f"TrainGraph: batch {k!r} is {tuple(v.shape)} {v.dtype}, "
                                 f"captured as {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(v)
        return self._captured.replay()
