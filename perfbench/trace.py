"""What a ``torch.profiler`` trace of part of a window says: the device's
activities (kernels, copies, sets), the host's calls that launched them,
and the harness's own spans.

``Trace.steps`` attributes every device activity to the graph launch
(``cudaGraphLaunch``) or the eager launch that issued it, by the
correlation id that CUPTI gives both; the harness names each launch (a
prefill, a decode step, a training step).  Busy time is the union of the
activities' intervals, so overlapping kernels count once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

GRAPH_LAUNCH = "cudaGraphLaunch"


@dataclasses.dataclass
class Activity:
    name: str
    start: int          # ns
    end: int            # ns
    corr: int


@dataclasses.dataclass
class Trace:
    device: List[Activity]       # kernels, copies and sets on the card, by start
    runtime: List[Activity]      # the host's CUDA runtime calls, by start
    host: List[Activity]         # the host's other ops and the harness's spans, by start

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        import torch
        dev, rt, host = [], [], []
        for e in prof.profiler.kineto_results.events():
            if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CUDA:
                continue      # a harness span mirrored on the device's timeline
            a = Activity(e.name(), int(e.start_ns()), int(e.start_ns() + e.duration_ns()), 0)
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                a.corr = int(e.linked_correlation_id() or e.correlation_id())
                dev.append(a)
            elif e.name().startswith("cuda"):
                a.corr = int(e.correlation_id())
                rt.append(a)
            else:
                host.append(a)
        return cls(*(sorted(x, key=lambda a: a.start) for x in (dev, rt, host)))

    def graph_launches(self) -> List[Activity]:
        return [a for a in self.runtime if a.name == GRAPH_LAUNCH]

    def steps(self, names: Sequence[str]) -> List[Tuple[str, List[Activity]]]:
        """(name, the device activities it issued) of each graph launch in
        order, named by ``names`` (one a launch); raises where the counts
        differ."""
        launches = self.graph_launches()
        if len(launches) != len(names):
            raise ValueError(f"trace: {len(launches)} graph launches, expected {len(names)}")
        by: Dict[int, List[Activity]] = {}
        for a in self.device:
            by.setdefault(a.corr, []).append(a)
        return [(n, by.get(a.corr, [])) for n, a in zip(names, launches)]

    def window(self, name: str) -> Tuple[int, int]:
        """(start, end) ns of the harness's span ``name``."""
        spans = [a for a in self.host if a.name == name]
        if not spans:
            raise ValueError(f"trace: no span {name!r}")
        return min(a.start for a in spans), max(a.end for a in spans)


def busy_ns(acts: Sequence[Activity], lo: Optional[int] = None, hi: Optional[int] = None) -> int:
    """The union of the activities' intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for a in sorted(acts, key=lambda a: a.start):
        s = a.start if lo is None else max(a.start, lo)
        e = a.end if hi is None else min(a.end, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(acts: Sequence[Activity], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The intervals of [lo, hi] in which no activity ran, longest first."""
    out, t = [], lo
    for a in sorted(acts, key=lambda a: a.start):
        if a.start > t:
            out.append((t, min(a.start, hi)))
        t = max(t, a.end)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


def matching(acts: Sequence[Activity], patterns: Sequence[str]) -> List[Activity]:
    return [a for a in acts if any(p in a.name for p in patterns)]


def top_ops(acts: Sequence[Activity], n: int = 10) -> List[List]:
    """[name, seconds] of the ``n`` device operations that took most time."""
    by: Dict[str, int] = {}
    for a in acts:
        by[a.name] = by.get(a.name, 0) + a.end - a.start
    return [[k[:200], v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def labelled_gaps(trace: Trace, lo: int, hi: int, n: int = 10) -> List[List]:
    """[what the host was doing, seconds] of the ``n`` longest idle gaps in
    [lo, hi]: the innermost harness span or host op (or runtime call) that
    covers the gap's start."""
    out = []
    host = trace.host + trace.runtime
    for s, e in gaps(trace.device, lo, hi)[:n]:
        cover = [a for a in host if a.start <= s < a.end]
        label = min(cover, key=lambda a: a.end - a.start).name if cover else "host"
        out.append([label[:200], (e - s) / 1e9])
    return out
