"""Pluggable gateway placement policies.

A :class:`PlacementPolicy` picks which worker serves an invocation among
the workers that are *ready* for the function (image present + function
deployed).  Policies are registered by ``kind`` in a small registry
mirroring the execution-backend registry (``@register_placement`` /
``resolve_placement``), so scenarios and the CLI can name them by
string and new policies plug in without touching the gateway.

All policies are deterministic: ties break on worker id and the only
hashing used (locality) is ``zlib.crc32``, which is stable across
processes and immune to ``PYTHONHASHSEED``.

The port's copy of the JAX package's ``fleet/placement.py``.
"""

from __future__ import annotations

import abc
import zlib
from typing import TYPE_CHECKING, Dict, List, Sequence, Type

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.fleet.cluster import Worker

_PLACEMENTS: Dict[str, Type["PlacementPolicy"]] = {}


def register_placement(cls: Type["PlacementPolicy"]) -> Type["PlacementPolicy"]:
    """Class decorator: register a placement policy under ``cls.kind``."""
    kind = getattr(cls, "kind", "")
    if not kind:
        raise ValueError(f"{cls.__name__} must define a non-empty 'kind'")
    if kind in _PLACEMENTS:
        raise ValueError(f"placement policy {kind!r} already registered")
    _PLACEMENTS[kind] = cls
    return cls


def available_placements() -> List[str]:
    return sorted(_PLACEMENTS)


def resolve_placement(policy) -> "PlacementPolicy":
    """Resolve a policy name (or pass through an instance) to a fresh
    policy object.  Policies hold per-cluster state (round-robin
    cursors), so names always resolve to a new instance."""
    if isinstance(policy, PlacementPolicy):
        return policy
    if policy in _PLACEMENTS:
        return _PLACEMENTS[policy]()
    raise ValueError(
        f"unknown placement policy {policy!r}; "
        f"available: {', '.join(available_placements())}"
    )


class PlacementPolicy(abc.ABC):
    """Picks a worker for one invocation among the ready set.

    ``ready`` is always non-empty and sorted by worker id; the gateway
    handles the no-ready-worker case (reject or expand) itself.
    """

    kind: str = ""

    @abc.abstractmethod
    def pick(self, fn: str, ready: Sequence["Worker"]) -> "Worker":
        ...


@register_placement
class RoundRobinPlacement(PlacementPolicy):
    """Cycle through the ready workers per function."""

    kind = "round-robin"

    def __init__(self) -> None:
        self._cursor: Dict[str, int] = {}

    def pick(self, fn: str, ready: Sequence["Worker"]) -> "Worker":
        i = self._cursor.get(fn, 0)
        self._cursor[fn] = i + 1
        return ready[i % len(ready)]


@register_placement
class LeastLoadedPlacement(PlacementPolicy):
    """Send each invocation to the ready worker with the lowest
    outstanding-per-core load.

    Ties break on a rotating cursor, not a fixed worker id: at low
    load most workers sit at load 0, and a static tie-break would herd
    every invocation onto worker 0 (real least-connection balancers
    rotate or sample among ties for the same reason).
    """

    kind = "least-loaded"

    def __init__(self) -> None:
        self._cursor = 0

    def pick(self, fn: str, ready: Sequence["Worker"]) -> "Worker":
        return self.pick_min(fn, ready)[0]

    def pick_min(self, fn: str, ready: Sequence["Worker"]):
        """``(pick(fn, ready), min load)`` in one pass over the ready
        set — the gateway reuses the scanned minimum for its spill
        check instead of re-walking the fleet.  ``ready`` arrives in
        wid order, so tracking the first minimum-load worker and the
        first at-or-after the cursor reproduces the tie-rotation of the
        two-pass form exactly."""
        c = self._cursor
        lo = float("inf")
        first = ge = None
        try:
            # inlined Worker.load: this scan runs once per routed
            # request and dominates the fleet driver's wall time
            for w in ready:
                l = w.outstanding / (w.runtime.cores.n_cores or 1)
                if l < lo:
                    lo = l
                    first = w
                    ge = w if w.wid >= c else None
                elif l == lo and ge is None and w.wid >= c:
                    ge = w
        except AttributeError:      # duck-typed stand-ins expose .load
            lo = float("inf")
            first = ge = None
            for w in ready:
                l = w.load
                if l < lo:
                    lo = l
                    first = w
                    ge = w if w.wid >= c else None
                elif l == lo and ge is None and w.wid >= c:
                    ge = w
        w = ge if ge is not None else first
        self._cursor = w.wid + 1
        return w, lo


@register_placement
class LocalityPlacement(PlacementPolicy):
    """Sticky function->worker affinity with load-bounded spill.

    Each (function, worker) pair gets a stable rendezvous score
    (crc32), giving every function its own preference order over the
    ready set.  Invocations go to the most-preferred worker whose load
    is below ``spill_load``; when all preferred workers are saturated
    the policy degrades to least-loaded.  Under a Zipf tenant mix this
    concentrates warm state (snapshot caches, provider caches) for the
    tail functions on a few "home" workers instead of smearing it
    fleet-wide.
    """

    kind = "locality"

    def __init__(self, spill_load: float = 6.0) -> None:
        self.spill_load = spill_load

    def pick(self, fn: str, ready: Sequence["Worker"]) -> "Worker":
        order = sorted(
            ready,
            key=lambda w: zlib.crc32(f"{fn}|{w.wid}".encode()),
        )
        for w in order:
            if w.load < self.spill_load:
                return w
        return min(ready, key=lambda w: (w.load, w.wid))
