"""Fleet cluster: N per-worker runtimes behind one gateway.

A :class:`Cluster` owns N :class:`Worker`\\ s — each a full
``FaasdRuntime`` with a registry-resolved execution backend, its own
``CorePool``/net stacks, and (optionally) its own ``Autoscaler`` — plus
one :class:`~repro_torch.fleet.provisioning.ImageDistribution` model charging
image-transfer time whenever provisioning lands on a worker that does
not hold the function image.  All workers share the cluster's one
``Simulator`` clock and event heap, so cross-worker event ordering is
deterministic and a same-seed fleet run is byte-identical.

A cluster is driven exactly like a single runtime:
``drive(cluster, load)`` dispatches to the fleet driver, which routes
each arrival through the cluster's :class:`~repro_torch.fleet.gateway.Gateway`.

The port's copy of the JAX package's ``fleet/cluster.py``.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, Generator, List, Optional, Sequence

from repro_torch.core.autoscaler import Autoscaler
from repro_torch.core.faas import FaasdRuntime, FunctionSpec
from repro_torch.core.simulator import Simulator
from repro_torch.fleet.gateway import Gateway
from repro_torch.fleet.placement import resolve_placement
from repro_torch.fleet.provisioning import resolve_distribution


class Worker:
    """One fleet worker: a backend runtime plus gateway-visible state."""

    __slots__ = ("sim", "wid", "runtime", "images", "outstanding",
                 "admitted", "autoscaler")

    def __init__(self, sim: Simulator, wid: int, backend, n_cores: int):
        self.sim = sim
        self.wid = wid
        self.runtime = FaasdRuntime(sim, backend=backend, n_cores=n_cores)
        self.images: set = set()         # function images held locally
        self.outstanding = 0             # in-flight invocations
        self.admitted = 0                # lifetime routed invocations
        self.autoscaler: Optional[Autoscaler] = None

    @property
    def load(self) -> float:
        """Outstanding invocations per core — the gateway's load signal."""
        return self.outstanding / max(1, self.runtime.cores.n_cores)


class Cluster:
    """N workers + gateway + image-distribution model on one clock."""

    is_cluster = True

    def __init__(self, sim: Simulator, n_workers: int, *,
                 backend="containerd", n_cores: int = 10,
                 placement="least-loaded", distribution="tree",
                 image_mb: float = 256.0, origin_gbps: float = 10.0,
                 peer_gbps: float = 10.0, fanout: int = 2, chunks: int = 16,
                 spill_load: Optional[float] = 8.0,
                 scale_policy: Optional[Callable] = None):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.sim = sim
        self.image_mb = image_mb
        self.workers = [Worker(sim, wid, backend, n_cores)
                        for wid in range(n_workers)]
        if scale_policy is not None:
            for w in self.workers:
                w.autoscaler = Autoscaler(sim, w.runtime,
                                          policy=scale_policy())
                w.autoscaler.run()
        self.distribution = resolve_distribution(
            distribution, sim, origin_gbps=origin_gbps,
            peer_gbps=peer_gbps, fanout=fanout, chunks=chunks)
        self.functions: Dict[str, FunctionSpec] = {}
        self.ready: Dict[str, List[int]] = {}   # fn -> sorted worker ids
        self.gateway = Gateway(self, resolve_placement(placement),
                               spill_load=spill_load)
        self.rejected = 0
        self.storms: List[Dict] = []

    # -- topology helpers ----------------------------------------------
    def ready_workers(self, fn: str) -> List[Worker]:
        return [self.workers[i] for i in self.ready.get(fn, ())]

    def holders(self, fn: str) -> int:
        """Workers currently holding the function image."""
        return sum(1 for w in self.workers if fn in w.images)

    def reference_runtime(self, fn: str) -> FaasdRuntime:
        """A deployed runtime for cost-table lookups (tables are
        identical across same-backend workers)."""
        ids = self.ready.get(fn)
        if not ids:
            raise KeyError(f"function {fn!r} is not ready on any worker")
        return self.workers[ids[0]].runtime

    def _mark_ready(self, fn: str, wid: int) -> None:
        ids = self.ready.setdefault(fn, [])
        if wid not in ids:
            bisect.insort(ids, wid)

    # -- provisioning ---------------------------------------------------
    def provision(self, spec: FunctionSpec, wid: int, *,
                  pull: bool = True) -> Generator:
        """Process: land ``spec`` on worker ``wid`` — image transfer
        first (charged via the distribution model) if the worker does
        not hold it, then the backend's own deploy path.  Returns
        whether an image pull was charged."""
        w = self.workers[wid]
        pulled = False
        if pull and spec.name not in w.images:
            yield from self.distribution.fetch(
                spec.name, self.image_mb, wid, self.holders(spec.name))
            pulled = True
        w.images.add(spec.name)
        yield from w.runtime.deploy(spec)
        self.functions[spec.name] = spec
        self._mark_ready(spec.name, wid)
        return pulled

    def deploy_blocking(self, spec: FunctionSpec,
                        workers: Optional[Sequence[int]] = None) -> None:
        """Initial (pre-run) deployment: the image is considered
        pre-pulled — no distribution charge — on ``workers`` (default:
        all).  Blocks the caller by running the sim until every
        per-worker deploy completes."""
        targets = (list(range(len(self.workers))) if workers is None
                   else sorted(set(workers)))
        if not targets:
            raise ValueError("deploy_blocking needs at least one worker")
        remaining = [len(targets)]

        def one(wid: int) -> Generator:
            yield from self.provision(spec, wid, pull=False)
            remaining[0] -= 1
            if remaining[0] == 0:
                self.sim.stop()

        for wid in targets:
            self.sim.process(one(wid))
        self.sim.run()
        assert remaining[0] == 0, "fleet deploy did not converge"

    def scale_out(self, spec: FunctionSpec, total_replicas: int,
                  workers: Optional[Sequence[int]] = None) -> Generator:
        """Process: a provisioning storm — spread ``total_replicas`` of
        ``spec`` across ``workers`` (default: all), balanced; each
        worker pays an image pull (via the distribution model) if it
        lacks the image, then its backend's deploy cost.  Returns the
        storm record (also appended to ``self.storms``)."""
        if total_replicas < 1:
            raise ValueError(
                f"total_replicas must be >= 1, got {total_replicas}")
        targets = (list(range(len(self.workers))) if workers is None
                   else sorted(set(workers)))
        targets = targets[:total_replicas]   # never a zero-replica worker
        base, extra = divmod(total_replicas, len(targets))
        t0 = self.sim.now
        storm: Dict = {"fn": spec.name, "t_start_s": round(t0, 6),
                       "total_replicas": total_replicas,
                       "n_workers": len(targets), "workers": []}
        done = self.sim.event()
        remaining = [len(targets)]

        def one(wid: int, k: int) -> Generator:
            pulled = yield from self.provision(
                dataclasses.replace(spec, scale=k), wid)
            storm["workers"].append({
                "worker": wid, "replicas": k, "pulled": pulled,
                "t_ready_s": round(self.sim.now - t0, 6)})
            remaining[0] -= 1
            if remaining[0] == 0:
                done.succeed()

        for j, wid in enumerate(targets):
            self.sim.process(one(wid, base + (1 if j < extra else 0)))
        yield done
        storm["time_to_full_s"] = round(self.sim.now - t0, 6)
        storm["workers"].sort(key=lambda d: d["worker"])
        storm["pulls"] = self.distribution.pulls_for(spec.name)
        self.storms.append(storm)
        return storm
