"""Gateway tier: admission + placement + pressure-driven expansion.

The gateway is the fleet's front door.  Every admitted invocation is
routed to one worker by the cluster's :class:`PlacementPolicy`; the
per-worker placement counts land in the artifact so placement skew is
observable.  When every ready worker for a function is saturated
(load >= ``spill_load``) and some worker lacks the function, the
gateway triggers an *expansion*: a one-replica provision onto the
least-loaded cold worker, paying the image-distribution cost mid-run.

The port's copy of the JAX package's ``fleet/gateway.py``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Set

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.fleet.cluster import Cluster, Worker
    from repro_torch.fleet.placement import PlacementPolicy


class Gateway:

    __slots__ = ("cluster", "policy", "spill_load", "placements",
                 "expansions", "_expanding", "_ready_cache", "_pick_min")

    def __init__(self, cluster: "Cluster", policy: "PlacementPolicy",
                 spill_load: Optional[float] = 8.0):
        self.cluster = cluster
        self.policy = policy
        self.spill_load = spill_load
        self.placements = [0] * len(cluster.workers)
        self.expansions: List[Dict] = []
        self._expanding: Set[str] = set()
        # per-function ready Worker lists, invalidated by length when a
        # provision marks a new worker ready (workers are never removed)
        self._ready_cache: Dict[str, List["Worker"]] = {}
        self._pick_min = getattr(policy, "pick_min", None)

    def route(self, fn: str) -> Optional["Worker"]:
        """Pick the worker for one invocation of ``fn``; ``None`` means
        no worker is ready (the caller rejects)."""
        cl = self.cluster
        ids = cl.ready.get(fn)
        if not ids:
            return None
        ready = self._ready_cache.get(fn)
        if ready is None or len(ready) != len(ids):
            ready = [cl.workers[i] for i in ids]
            self._ready_cache[fn] = ready
        pick_min = self._pick_min
        if pick_min is not None:
            w, lo = pick_min(fn, ready)
        else:
            w = self.policy.pick(fn, ready)
            lo = None
        self.placements[w.wid] += 1
        if (self.spill_load is not None
                and len(ids) < len(cl.workers)
                and fn not in self._expanding):
            if lo is None:
                lo = min(x.load for x in ready)
            if lo >= self.spill_load:
                self._expand(fn, ids)
        return w

    def _expand(self, fn: str, ready_ids) -> None:
        """Provision one replica of ``fn`` onto the least-loaded worker
        that lacks it (image pull charged via the distribution model)."""
        cl = self.cluster
        ready = set(ready_ids)
        target = min((w for w in cl.workers if w.wid not in ready),
                     key=lambda w: (w.load, w.wid))
        spec = dataclasses.replace(cl.functions[fn], scale=1)
        self._expanding.add(fn)
        t_req = cl.sim.now

        def go():
            try:
                pulled = yield from cl.provision(spec, target.wid)
                self.expansions.append({
                    "fn": fn, "worker": target.wid, "pulled": pulled,
                    "t_request_s": round(t_req, 6),
                    "ready_ms": round((cl.sim.now - t_req) * 1e3, 3)})
            finally:
                self._expanding.discard(fn)

        cl.sim.process(go())
