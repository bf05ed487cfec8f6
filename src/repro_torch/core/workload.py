"""The paper's closed-loop methodology (Fig 5) and its metric helpers.

The port's copy of the first part of the JAX package's ``core/workload.py``:
``percentile``, ``LatencySummary`` and ``run_sequential``.  The open-loop
``drive``, the arrival processes and the knee search come later
(ROADMAP.md, queue 1 item 6d).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.faas import FaasdRuntime


def percentile(xs: Sequence[float], p: float) -> float:
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(xs), p))


@dataclasses.dataclass
class LatencySummary:
    n: int
    median_ms: float
    p99_ms: float
    mean_ms: float
    p999_ms: float

    @staticmethod
    def of(latencies_ms: Sequence[float]) -> "LatencySummary":
        a = np.asarray(latencies_ms, dtype=np.float64)
        if a.size == 0:
            nan = float("nan")
            return LatencySummary(0, nan, nan, nan, nan)
        med, p99, p999 = np.percentile(a, (50.0, 99.0, 99.9))
        return LatencySummary(n=int(a.size), median_ms=float(med),
                              p99_ms=float(p99), mean_ms=float(a.mean()),
                              p999_ms=float(p999))


def run_sequential(runtime: FaasdRuntime, fn_name: str, n: int = 100,
                   think_time_s: float = 0.0) -> LatencySummary:
    """Fig 5 methodology: n *sequential* invocations (closed loop)."""
    sim = runtime.sim

    def client():
        for _ in range(n):
            yield from runtime.invoke(fn_name)
            if think_time_s:
                yield sim.timeout(think_time_s)

    start = len(runtime.records)
    p = sim.process(client())
    p.completion.callbacks.append(lambda _v: sim.stop())
    sim.run()
    assert p.done, "sequential client did not finish"
    return LatencySummary.of([r.e2e * 1e3 for r in runtime.records[start:]])
