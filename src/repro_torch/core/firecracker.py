"""Firecracker-style microVM backend (NSDI '20), modeled.

Each function runs in its own minimal VM: strong isolation behind a slim
VMM, a virtio datapath through two network stacks, and a containerd-class
control plane.  The design's distinctive lifecycle is the *snapshot
cache*: the first cold start of a function pays a full microVM boot
(~125 ms) and warms a per-function memory/device snapshot; every later
cold start — a redeploy or a scale-up replica — restores from that
snapshot in single-digit ms.  ``remove`` tears the function down
entirely, snapshot included, so the next deploy boots from scratch; the
cache holds at most ``snapshot_capacity`` snapshots and evicts the
least-recently-used one beyond that (snapshots are hundreds of MB of
guest memory — a host cannot keep one per function forever).

This fills the spectrum between ``wasm`` (instant cold start, weak
isolation story) and ``quark``/``gvisor`` (strong isolation, slow
control plane): VM-grade isolation whose *second* cold start is almost
junctiond-fast.

The port's copy of the JAX package's ``core/firecracker.py``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Generator, Optional

from repro_torch.core.backends import SnapshotColdStartModel, register_backend
from repro_torch.core.containerd import Containerd, ContainerRecord
from repro_torch.core.latency import (FIRECRACKER_BOOT_MS, FIRECRACKER_QUERY_MS,
                                      FIRECRACKER_RESTORE_MS, FIRECRACKER_RUNTIME,
                                      FIRECRACKER_SNAPSHOT_SAVE_MS,
                                      FIRECRACKER_STACK)
from repro_torch.core.scheduler import PollingModel
from repro_torch.core.simulator import Simulator

# Snapshots pin guest memory on the host; a worker keeps a bounded pool.
DEFAULT_SNAPSHOT_CAPACITY = 32


@dataclasses.dataclass
class Snapshot:
    """A pre-warmed memory/device snapshot of one function's booted guest."""
    fn: str
    taken_at: float


@dataclasses.dataclass
class MicroVMRecord(ContainerRecord):
    restored: bool = False    # last deploy was a snapshot restore, not a boot


class SnapshotCache:
    """Per-function snapshot store with LRU capacity eviction.

    ``get`` counts as a use (refreshes recency); ``put`` evicts the
    least-recently-used entry once the cache is full.  ``evict`` is the
    explicit-removal path (function removed -> snapshot must go too).
    """

    def __init__(self, capacity: int = DEFAULT_SNAPSHOT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"snapshot capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.evictions = 0
        self._entries: "collections.OrderedDict[str, Snapshot]" = \
            collections.OrderedDict()

    def get(self, fn: str) -> Optional[Snapshot]:
        snap = self._entries.get(fn)
        if snap is not None:
            self._entries.move_to_end(fn)
        return snap

    def put(self, snap: Snapshot) -> None:
        self._entries[snap.fn] = snap
        self._entries.move_to_end(snap.fn)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def evict(self, fn: str) -> bool:
        return self._entries.pop(fn, None) is not None

    def __contains__(self, fn: str) -> bool:
        return fn in self._entries

    def __len__(self) -> int:
        return len(self._entries)


@register_backend
class Firecracker(Containerd):
    """Container-shaped control plane over per-function microVMs with a
    two-mode cold path: full boot warms the snapshot, later cold starts
    restore from it (until ``remove`` evicts it or capacity pressure
    pushes it out)."""

    name = "firecracker"
    runtime = FIRECRACKER_RUNTIME
    stack_costs = FIRECRACKER_STACK
    coldstart = SnapshotColdStartModel(
        deploy_ms=FIRECRACKER_BOOT_MS,
        query_ms=FIRECRACKER_QUERY_MS,
        restore_ms=FIRECRACKER_RESTORE_MS,
        save_ms=FIRECRACKER_SNAPSHOT_SAVE_MS)

    def __init__(self, sim: Simulator, *, n_cores: int = 10,
                 polling_model: PollingModel = PollingModel.CENTRALIZED,
                 snapshot_capacity: int = DEFAULT_SNAPSHOT_CAPACITY):
        super().__init__(sim, n_cores=n_cores, polling_model=polling_model)
        self.snapshots = SnapshotCache(snapshot_capacity)
        self.boots = 0
        self.restores = 0

    # -- the two-mode cold path -------------------------------------------
    def _cold_start_one(self, fn_name: str) -> Generator:
        """Bring up one microVM for ``fn_name``: restore when a snapshot
        exists, else full boot + snapshot warm."""
        if self.snapshots.get(fn_name) is not None:
            yield self.sim.timeout(self.coldstart.restore_seconds)
            self.restores += 1
            return True
        # full boot + snapshot save: warming the cache costs extra over
        # a bare boot (pause + serialize memory/device state)
        yield self.sim.timeout(self.coldstart.boot_seconds)
        self.snapshots.put(Snapshot(fn=fn_name, taken_at=self.sim.now))
        self.boots += 1
        return False

    # -- lifecycle --------------------------------------------------------
    def deploy(self, fn_name: str, *, scale: int = 1, max_cores: int = 2,
               isolate_replicas: bool = False) -> Generator:
        # redeploy releases the old microVMs but NOT the snapshot: it is
        # keyed by the function image, so a config update restores fast
        super().remove(fn_name)     # the runtime-resource-only teardown
        restored = yield from self._cold_start_one(fn_name)
        for _ in range(1, scale):
            # extra replicas restore from the snapshot just warmed
            yield from self._cold_start_one(fn_name)
        self.records[fn_name] = MicroVMRecord(
            name=fn_name, ip=f"10.62.0.{len(self.records) + 2}", port=8080,
            replicas=scale, restored=restored)
        self.deploys += 1

    def scale(self, fn_name: str, replicas: int) -> Generator:
        rec = self._require(fn_name)
        # new replicas cold-start one by one: the first re-warms the
        # snapshot if capacity eviction dropped it, the rest restore;
        # scale-down reaps microVMs at no init cost
        for _ in range(replicas - rec.replicas):
            yield from self._cold_start_one(fn_name)
        rec.replicas = replicas

    def remove(self, fn_name: str) -> None:
        """Full teardown: microVMs *and* the function's snapshot — the
        next deploy pays a fresh boot."""
        super().remove(fn_name)
        self.snapshots.evict(fn_name)
