"""Function-image distribution models for fleet provisioning.

At single-worker scale a cold start is dominated by the runtime's boot
path; at 1000-replica storm scale the binding constraint shifts to
*getting the function image onto N workers* (FaaSNet, arXiv:2105.11229).
This module charges that cost.  Two models, registered by ``kind``:

``naive``
    Every worker pulls the full image from one origin registry over a
    shared uplink.  The uplink is a processor-sharing fluid link, so N
    concurrent pulls each see ``1/N`` of the bandwidth and time-to-full
    capacity grows linearly in N.

``tree``
    FaaSNet-style peer-to-peer binary tree.  The first worker (root)
    pulls from the origin; every worker that finishes serves up to
    ``fanout`` children from its own uplink, and a child starts
    streaming chunks as soon as its parent holds them (pipelined, so a
    child finishes roughly one chunk after its parent rather than one
    full image later).  Time-to-full grows ~logarithmically in N.

Both models run on the shared simulator clock; ``fetch`` is a process
generator the cluster yields from, and every completed transfer is
recorded as a :class:`PullRecord` for per-worker artifact timelines.

The port's copy of the JAX package's ``fleet/provisioning.py``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Type

from repro_torch.core.simulator import Event, Simulator

# Residual bytes below this are float round-off, not real payload.
_DONE_EPS_BYTES = 0.5


@dataclasses.dataclass(frozen=True)
class PullRecord:
    """One completed image transfer onto one worker."""

    fn: str
    worker: int
    source: str        # "origin" | "peer"
    t_start: float     # request time (s, sim clock)
    t_ready: float     # transfer-complete time (s, sim clock)

    def as_dict(self) -> Dict[str, object]:
        return {
            "fn": self.fn,
            "worker": self.worker,
            "source": self.source,
            "t_start_s": round(self.t_start, 6),
            "t_ready_s": round(self.t_ready, 6),
        }


class SharedLink:
    """Processor-sharing fluid link: N concurrent transfers each see
    ``capacity/N``.  Deterministic: flows live in an insertion-ordered
    dict and completions are re-derived (version-tokened) whenever the
    flow set changes."""

    __slots__ = ("sim", "rate_Bps", "_flows", "_last_t", "_ver", "_next")

    def __init__(self, sim: Simulator, gbps: float):
        if gbps <= 0:
            raise ValueError(f"link bandwidth must be positive, got {gbps}")
        self.sim = sim
        self.rate_Bps = gbps * 1e9 / 8.0
        self._flows: Dict[Event, float] = {}   # event -> remaining bytes
        self._last_t = sim.now
        self._ver = 0
        self._next = 0

    @property
    def n_flows(self) -> int:
        return len(self._flows)

    def transfer(self, nbytes: float) -> Event:
        """Start a transfer; the returned event fires at completion."""
        if nbytes <= 0:
            raise ValueError(f"transfer size must be positive, got {nbytes}")
        self._advance()
        ev = Event(self.sim)
        self._flows[ev] = float(nbytes)
        self._resched()
        return ev

    def _advance(self) -> None:
        """Drain bytes for the elapsed interval at the current share."""
        now = self.sim.now
        if self._flows and now > self._last_t:
            drained = (now - self._last_t) * self.rate_Bps / len(self._flows)
            for ev in self._flows:
                self._flows[ev] -= drained
        self._last_t = now

    def _resched(self) -> None:
        """Re-derive the next completion after a membership change."""
        self._ver += 1
        if not self._flows:
            return
        rem_min = min(self._flows.values())
        dt = max(0.0, rem_min * len(self._flows) / self.rate_Bps)
        self.sim._schedule(dt, self._fire, self._ver)

    def _fire(self, ver: int) -> None:
        if ver != self._ver:   # stale: the flow set changed since
            return
        self._advance()
        done = [ev for ev, rem in self._flows.items()
                if rem <= _DONE_EPS_BYTES]
        for ev in done:
            del self._flows[ev]
        for ev in done:
            ev.succeed(self.sim.now)
        self._resched()


_DISTRIBUTIONS: Dict[str, Type["ImageDistribution"]] = {}


def register_distribution(cls: Type["ImageDistribution"]) -> Type["ImageDistribution"]:
    kind = getattr(cls, "kind", "")
    if not kind:
        raise ValueError(f"{cls.__name__} must define a non-empty 'kind'")
    if kind in _DISTRIBUTIONS:
        raise ValueError(f"image distribution {kind!r} already registered")
    _DISTRIBUTIONS[kind] = cls
    return cls


def available_distributions() -> List[str]:
    return sorted(_DISTRIBUTIONS)


def resolve_distribution(dist, sim: Simulator, **params) -> "ImageDistribution":
    if isinstance(dist, ImageDistribution):
        return dist
    if dist in _DISTRIBUTIONS:
        return _DISTRIBUTIONS[dist](sim, **params)
    raise ValueError(
        f"unknown image distribution {dist!r}; "
        f"available: {', '.join(available_distributions())}"
    )


class ImageDistribution:
    """Base: charges the time to land a function image on a worker.

    ``fetch`` is a generator the caller yields from; it returns only
    when the image is fully present on the requesting worker.
    """

    kind: str = ""

    def __init__(self, sim: Simulator, *, origin_gbps: float = 10.0,
                 peer_gbps: float = 10.0, fanout: int = 2,
                 chunks: int = 16):
        if fanout < 1:
            raise ValueError(f"fanout must be >= 1, got {fanout}")
        if chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {chunks}")
        self.sim = sim
        self.origin = SharedLink(sim, origin_gbps)
        self.peer_Bps = peer_gbps * 1e9 / 8.0
        self.fanout = fanout
        self.chunks = chunks
        self.pulls: List[PullRecord] = []

    def fetch(self, fn: str, size_mb: float, worker: int, holders: int):
        """Process generator: transfer ``size_mb`` onto ``worker``.

        ``holders`` is the number of workers that already held the
        image when the fetch was requested (0 for a cold fleet).
        """
        raise NotImplementedError

    def pulls_for(self, fn: str) -> List[Dict[str, object]]:
        return [p.as_dict() for p in self.pulls if p.fn == fn]

    def _record(self, fn: str, worker: int, source: str,
                t_start: float, t_ready: float) -> None:
        self.pulls.append(PullRecord(fn, worker, source, t_start, t_ready))


@register_distribution
class NaiveRegistryPull(ImageDistribution):
    """Every worker pulls the full image from the one origin registry;
    concurrent pulls share the origin uplink fairly."""

    kind = "naive"

    def fetch(self, fn: str, size_mb: float, worker: int, holders: int):
        t0 = self.sim.now
        yield self.origin.transfer(size_mb * 1e6)
        self._record(fn, worker, "origin", t0, self.sim.now)


class _TreeState:
    """Per-function wave state for the FaaSNet tree."""

    __slots__ = ("root_claimed", "slots", "waiters")

    def __init__(self) -> None:
        self.root_claimed = False
        # Each slot is the serving parent's own completion time; a
        # child streaming from that parent cannot finish earlier than
        # parent_done + one chunk.
        self.slots: Deque[float] = deque()
        self.waiters: Deque[Event] = deque()


@register_distribution
class FaasNetTree(ImageDistribution):
    """FaaSNet-style tree provisioning: the root pulls from the origin,
    finished workers each serve ``fanout`` children over their peer
    uplink, and children stream pipelined chunk-by-chunk behind their
    parent."""

    kind = "tree"

    def __init__(self, sim: Simulator, **params):
        super().__init__(sim, **params)
        self._state: Dict[str, _TreeState] = {}

    def fetch(self, fn: str, size_mb: float, worker: int, holders: int):
        size = size_mb * 1e6
        st = self._state.setdefault(fn, _TreeState())
        if holders > 0 and not st.root_claimed:
            # Warm seeds: workers that already hold the image serve as
            # ready parents, no origin round-trip needed.
            st.root_claimed = True
            self._release(st, [self.sim.now] * (self.fanout * holders))
        if not st.root_claimed:
            st.root_claimed = True
            t0 = self.sim.now
            yield self.origin.transfer(size)
            t_done = self.sim.now
            self._record(fn, worker, "origin", t0, t_done)
            self._release(st, [t_done] * self.fanout)
            return
        # Peer path: claim a serving slot (or queue for one).
        t0 = self.sim.now
        if st.slots:
            parent_done = st.slots.popleft()
        else:
            ev = Event(self.sim)
            st.waiters.append(ev)
            parent_done = yield ev
        t_start = self.sim.now
        rate = self.peer_Bps / self.fanout
        chunk_s = (size / self.chunks) / rate
        t_done = max(t_start + size / rate, parent_done + chunk_s)
        # Pipelining: this worker's children may start streaming the
        # chunks it already holds *now* — they just cannot finish
        # before this worker does (plus one chunk), which the released
        # completion time encodes.  This is what makes the tree depth
        # cost one chunk per level instead of one full image.
        self._release(st, [t_done] * self.fanout)
        yield self.sim.timeout(t_done - t_start)
        self._record(fn, worker, "peer", t0, self.sim.now)
        self._release(st, [parent_done])   # hand the parent's slot back

    def _release(self, st: _TreeState, parent_done_times) -> None:
        for pd in parent_done_times:
            if st.waiters:
                st.waiters.popleft().succeed(pd)
            else:
                st.slots.append(pd)
