"""What the per-layer metrics' readers (``metrics/<name>.py``) share: the
profiled steps of a traced run (``ctx["steps"]``: (kind, device
activities, shape) a graph launch), their device time, and a kernel's or
a step's share of the roofline by ``work.counts``."""
from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional, Sequence

from perfbench.trace import busy_ns, matching
from perfbench.work import counts


def steps(ctx: dict, kind: str) -> list:
    return [s for s in ctx["steps"] if s[0] == kind] if ctx else []


def roofline(ctx: dict, kind: str, patterns: Sequence[str],
             work: Callable[[dict, dict], Dict[str, float]]) -> Optional[float]:
    """The work ``work(cfg, shape)`` of each ``kind`` step over the device
    time of the kernels whose names hold one of ``patterns`` in those
    steps, as a percentage of the roofline; None where none of them ran."""
    done, ns = [], 0
    for _, acts, shape in steps(ctx, kind):
        mine = matching(acts, patterns)
        if mine:
            ns += busy_ns(mine)
            done.append(work(ctx["cfg"], shape))
    if not ns:
        return None
    return counts.share(counts.add(*done), ns / 1e9)


def step_mfu(ctx: dict, kind: str, work: Callable[[dict, dict], Dict[str, float]]
             ) -> Optional[float]:
    """The whole step's share of the roofline over its device time (the
    union of its activities)."""
    return roofline(ctx, kind, [""], work)


def kernels_per_step(ctx: dict, kind: str) -> Optional[float]:
    got = steps(ctx, kind)
    if not got:
        return None
    return sum(len(acts) for _, acts, _ in got) / len(got)


def idle_share(ctx: dict) -> Optional[float]:
    if not ctx or not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def p95(values: List[float]) -> Optional[float]:
    if not values:
        return None
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def host_share(ctx: dict) -> Optional[float]:
    """The share of the untraced invocations' wall time that their steps
    (``step_times_s``: prefill and decode replays up to a synchronize) do
    not cover: sampling, ``.tolist()`` and the batcher between steps."""
    runs = ctx["runs"] if ctx else []
    wall = sum(w for _, w, _ in runs)
    if not wall:
        return None
    return 100.0 * (wall - sum(sum(t) for _, _, t in runs)) / wall
