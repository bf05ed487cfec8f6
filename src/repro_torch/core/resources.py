"""Host CPU core pool with a scheduling-thrash model.

``consume`` acquires one core for ``cpu_time`` seconds (FIFO).  The
effective occupancy is scaled by a thrash multiplier that grows with the
runnable backlog — modelling cache pollution, migrations and context
switching of kernel CFS under load (cf. Caladan).  Junction's
run-to-completion scheduling sets a near-1 cap.

The port's copy of the JAX package's ``core/resources.py``: the generator
path of the closed loop and the event-heap fast path, with its lazy
releases, of the open-loop ``drive``.  Both pools take the same decisions
in the same order.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Generator, Optional

from repro_torch.core.latency import RuntimeCosts
from repro_torch.core.simulator import Event, Simulator


class CorePool:
    __slots__ = ("sim", "n_cores", "runtime", "busy", "_waiters",
                 "_queued_weight", "busy_time", "served", "_off_pend")

    def __init__(self, sim: Simulator, n_cores: int, runtime: RuntimeCosts):
        self.sim = sim
        self.n_cores = n_cores
        self.runtime = runtime
        self.busy = 0
        # FIFO of waiters; entries are either Event (generator path) or
        # (avail_t, cb, args, weight) tuples (event-heap fast path) —
        # both paths drain through _grant_next so mixed traffic (a fast
        # open loop plus legacy deploy/invoke processes) shares one queue
        self._waiters: deque = deque()
        self._queued_weight = 0     # extra backlog weight of fast waiters
        # lazy releases: absolute times at which a held core frees
        # without a scheduled event (see release_at) — a float min-heap
        self._off_pend: list = []
        # accounting
        self.busy_time = 0.0
        self.served = 0

    # -- inspection ------------------------------------------------------
    @property
    def backlog(self) -> int:
        return len(self._waiters) + self._queued_weight

    def thrash(self) -> float:
        r = self.runtime
        x = self.backlog / max(1, self.n_cores)
        return min(r.thrash_cap, 1.0 + r.thrash_coeff * x)

    def utilization(self, horizon: float) -> float:
        return self.busy_time / (horizon * self.n_cores) if horizon > 0 else 0.0

    # -- usage -------------------------------------------------------
    def consume(self, cpu_time: float) -> Generator:
        """Process-style: yield from pool.consume(t)."""
        ev: Optional[Event] = None
        if self._off_pend:
            self._drain(self.sim.now)
        if self.busy >= self.n_cores:
            if self._off_pend:
                self._materialize()
            ev = self.sim.event()
            self._waiters.append(ev)
            yield ev
        self.busy += 1
        eff = cpu_time * self.thrash()
        yield self.sim.timeout(eff)
        self.busy -= 1
        self.busy_time += eff
        self.served += 1
        self._grant_next()

    # -- event-heap fast path --------------------------------------------
    #
    # The flat driver (repro_torch.core.workload.drive, engine="events") holds
    # cores without generator machinery: ``acquire_fast`` grants a core
    # and calls ``cb(start_t, *args)``; the callee times its own hold and
    # releases with ``release_fast``.  Thrash semantics match ``consume``
    # (multiplier read at grant time).

    def acquire_fast(self, avail_t: float, cb, args=(), weight: int = 1):
        """Request one core for a hold that can start no earlier than
        ``avail_t`` (the caller's in-flight network gap).  When a core is
        free the grant is immediate — reserving through a µs-scale future
        ``avail_t`` while at least one other core stays free, which costs
        capacity only when the pool is nearly full, where the wakeup
        event below takes over instead.  ``weight`` is this waiter's
        contribution to the thrash backlog (a merged off-path job stands
        for several legacy jobs)."""
        if self._off_pend:
            self._drain(self.sim.now)
        busy = self.busy
        nc = self.n_cores
        if busy < nc and not self._waiters:
            now = self.sim.now
            if avail_t <= now:
                self.busy = busy + 1
                cb(now, *args)
            elif busy < nc - 1:
                self.busy = busy + 1
                cb(avail_t, *args)
            else:
                self.sim._schedule(avail_t - now, self.acquire_fast,
                                   avail_t, cb, args, weight)
        else:
            if self._off_pend:
                self._materialize()
            self._waiters.append((avail_t, cb, args, weight))
            self._queued_weight += weight - 1

    def release_fast(self, eff: float) -> None:
        self.busy -= 1
        self.busy_time += eff
        self.served += 1
        if self._waiters:
            self._grant_next()

    # -- lazy releases (kernel-bypass for off-path core holds) ------------
    #
    # A held core whose release time is already known can free *without*
    # a scheduled event: ``release_at`` records the absolute time on a
    # float min-heap, every pool reader drains expired entries first,
    # and the moment anything has to queue (contention) the pending
    # releases materialise into real heap events so waiting grants still
    # fire at the exact release times.  Invariant: ``_off_pend`` is
    # non-empty only while the waiter queue is empty — enforced at run
    # time by ``repro_torch.analysis.sanitizer`` (REPRO_SIM_CHECK=1), which
    # also bounds ``busy`` transitions against ``n_cores``.

    def release_at(self, t: float) -> None:
        """Lazily release one already-held busy core at absolute ``t``
        (the caller incremented ``busy``; busy_time/served accounting
        stays with the caller)."""
        heapq.heappush(self._off_pend, t)

    def _drain(self, now: float) -> None:
        op = self._off_pend
        while op and op[0] <= now:
            heapq.heappop(op)
            self.busy -= 1

    def _materialize(self) -> None:
        sched = self.sim._schedule
        now = self.sim.now
        for t in self._off_pend:
            sched(t - now, self._lazy_release)
        self._off_pend.clear()

    def _lazy_release(self) -> None:
        self.busy -= 1
        if self._waiters:
            self._grant_next()

    def _grant_next(self) -> None:
        waiters = self._waiters
        if waiters and self.busy < self.n_cores:
            w = waiters.popleft()
            if type(w) is tuple:
                avail_t, cb, args, weight = w
                self._queued_weight -= weight - 1
                self.busy += 1
                now = self.sim.now
                cb(avail_t if avail_t > now else now, *args)
            else:
                w.succeed()

    def remove_cores(self, n: int) -> None:
        """Dedicate cores elsewhere (e.g. per-instance polling)."""
        self.n_cores = max(0, self.n_cores - n)

    def add_cores(self, n: int) -> None:
        self.n_cores += n
