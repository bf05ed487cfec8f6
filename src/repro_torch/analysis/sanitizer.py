"""Runtime sim-sanitizer: dynamic invariant checks for the event core.

The port's copy of the JAX package's ``analysis/sanitizer.py``: it checks
``repro_torch.core`` and never touches ``repro.core``.  Static analysis
(the JAX package's simlint, whose unscoped rules lint this package too)
catches contract violations visible in source; this module catches the
ones only visible at run time.  When installed it wraps the simulator's
hot paths with checked variants that assert, on every transition:

* **clock monotonicity** — ``EventLoop.run`` / ``Simulator.run`` never
  pop an event timestamped before the current clock, and presorted
  arrival streams never go backwards;
* **no scheduling into the past** — ``Simulator._schedule`` rejects
  negative delays (beyond float-roundoff tolerance);
* **CorePool capacity** — ``busy`` never goes negative, and an
  increment never jumps the pool from strictly below capacity to over
  capacity (a full pool may legitimately go one over: Event-waiter
  grants defer their increment to resume time, and ``remove_cores``
  can shrink ``n_cores`` under the held count);
* **pending-releases ⇒ no-waiters** — ``release_at`` refuses to queue a
  lazy release while waiters exist, and a waiter cannot be appended
  while lazy releases are pending (callers must ``_materialize``
  first);
* **fused fast path** — the fused-admit branches in
  ``repro_torch.core.workload`` and ``repro_torch.fleet.driver`` call
  :func:`fused_admit_check` (gated on ``workload.SIM_CHECK``, the same
  zero-overhead module-flag pattern as ``FUSED_FAST_PATH``) to assert
  the pool is genuinely uncontended and the precomputed completion
  times lie ahead of the clock.

Enable for a whole process with ``REPRO_SIM_CHECK=1`` (hooked at the
end of ``repro_torch.core.__init__``; the variable is the JAX package's
too, so one switch checks both), or programmatically::

    from repro_torch.analysis import sanitizer
    sanitizer.install()
    try:
        ...
    finally:
        sanitizer.uninstall()

The checked wrappers are operation-for-operation copies of the
originals, so checked runs are byte-identical to unchecked runs; when
not installed the only residual cost is one module-level boolean read
per fused admit.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Callable, Dict, Optional

#: absolute tolerance (seconds) absorbing float roundoff in delay and
#: past-event checks.
TOL = 1e-9


class SimCheckError(AssertionError):
    """A dynamic simulator invariant was violated."""


_installed = False
_saved: Dict[str, Any] = {}


def enabled() -> bool:
    return _installed


class _CheckedWaiters(deque):
    """CorePool waiter deque asserting the pending-releases⇒no-waiters
    invariant on every append."""

    __slots__ = ("pool",)

    def append(self, item: Any) -> None:
        if _installed and self.pool._off_pend:
            raise SimCheckError(
                "CorePool waiter queued while lazy releases are "
                "pending; callers must _materialize() first")
        deque.append(self, item)


def fused_admit_check(pool: Any, t: float, end_t: float,
                      off_end_t: Optional[float] = None) -> None:
    """Assert a fused fast-path admit is legitimate: the pool is
    uncontended and the precomputed timeline lies ahead of the clock.
    Called from the fused branches in ``workload._drive_events`` and
    ``fleet.driver.drive_cluster`` when ``workload.SIM_CHECK`` is on."""
    if pool._waiters:
        raise SimCheckError(
            "fused fast path admitted while the pool has waiters "
            "(contended pools must take the per-station path)")
    if end_t < t - TOL:
        raise SimCheckError(
            f"fused completion at {end_t} precedes the admit at {t}")
    if off_end_t is not None and off_end_t < t - TOL:
        raise SimCheckError(
            f"fused off-path release at {off_end_t} precedes the "
            f"admit at {t}")


def install() -> None:
    """Swap the checked wrappers in.  Idempotent."""
    global _installed
    if _installed:
        return
    from repro_torch.core import resources, simulator, workload

    CorePool = resources.CorePool
    Simulator = simulator.Simulator
    EventLoop = simulator.EventLoop

    _saved["busy_slot"] = busy_slot = CorePool.busy      # member descriptor
    _saved["release_at"] = orig_release_at = CorePool.release_at
    _saved["pool_init"] = orig_pool_init = CorePool.__init__
    _saved["schedule"] = orig_schedule = Simulator._schedule
    _saved["sim_run"] = Simulator.run
    _saved["loop_run"] = EventLoop.run

    # -- CorePool.busy: a validating property over the slot -------------
    def _busy_get(self: Any) -> int:
        return busy_slot.__get__(self, CorePool)

    def _busy_set(self: Any, value: int) -> None:
        try:
            old = busy_slot.__get__(self, CorePool)
        except AttributeError:
            old = None              # first assignment, in __init__
        if value < 0:
            raise SimCheckError(f"CorePool.busy went negative ({value})")
        nc = self.n_cores
        # a pool already at/over capacity may legitimately gain one more
        # hold: an Event-waiter grant defers its increment to resume
        # time (and remove_cores can shrink under the held count), so
        # only an increment that *jumps* from strictly below capacity to
        # above it is provably corrupt
        if old is not None and old < nc < value:
            raise SimCheckError(
                f"CorePool.busy incremented past capacity "
                f"({old} -> {value} with n_cores={nc})")
        busy_slot.__set__(self, value)

    setattr(CorePool, "busy", property(_busy_get, _busy_set))

    # -- pending-releases ⇒ no-waiters -----------------------------------
    def _checked_release_at(self: Any, t: float) -> None:
        if self._waiters:
            raise SimCheckError(
                "CorePool.release_at while waiters are queued "
                "(pending-releases => no-waiters invariant)")
        if t < self.sim.now - TOL:
            raise SimCheckError(
                f"lazy core release at {t} is in the past "
                f"(now={self.sim.now})")
        orig_release_at(self, t)

    CorePool.release_at = _checked_release_at

    def _checked_pool_init(self: Any, sim: Any, n_cores: int,
                           runtime: Any) -> None:
        orig_pool_init(self, sim, n_cores, runtime)
        w = _CheckedWaiters()
        w.pool = self
        self._waiters = w

    CorePool.__init__ = _checked_pool_init

    # -- no scheduling into the past -------------------------------------
    def _checked_schedule(self: Any, delay: float, fn: Callable,
                          *args: Any) -> None:
        if delay < -TOL:
            raise SimCheckError(
                f"negative delay {delay} schedules an event in the past")
        orig_schedule(self, delay, fn, *args)

    Simulator._schedule = _checked_schedule

    # -- clock monotonicity: checked copies of both run loops ------------
    # Operation-for-operation copies of the originals (see
    # repro_torch.core.simulator) so checked runs stay byte-identical.
    def _checked_sim_run(self: Any, until: float = float("inf")) -> None:
        self.stopped = False
        while self._heap and not self.stopped:
            t, _, fn, args = self._heap[0]
            if t > until:
                break
            if t < self.now - TOL:
                raise SimCheckError(
                    f"event at {t} pops with the clock at {self.now}")
            heapq.heappop(self._heap)
            self.now = t
            fn(*args)
        if until != float("inf") and not self.stopped:
            self.now = max(self.now, until)

    Simulator.run = _checked_sim_run

    def _checked_loop_run(self: Any, until: float, arrival_times: Any = None,
                          admit: Any = None) -> int:
        sim = self.sim
        heap = sim._heap
        pop = heapq.heappop
        arr = arrival_times if arrival_times is not None else ()
        n_arr = len(arr)
        inf = float("inf")
        i = 0
        t_ar = arr[0] if n_arr else inf
        sim.stopped = False
        while not sim.stopped:
            t_ev = heap[0][0] if heap else inf
            if t_ar <= t_ev:
                if t_ar > until:
                    break
                if t_ar < sim.now - TOL:
                    raise SimCheckError(
                        f"arrival stream goes backwards: {t_ar} with "
                        f"the clock at {sim.now}")
                sim.now = t_ar
                admit(i, t_ar)
                i += 1
                t_ar = arr[i] if i < n_arr else inf
            else:
                if t_ev > until:
                    break
                if t_ev < sim.now - TOL:
                    raise SimCheckError(
                        f"event at {t_ev} pops with the clock at "
                        f"{sim.now}")
                t, _, fn, args = pop(heap)
                sim.now = t
                fn(*args)
        if not sim.stopped:
            sim.now = max(sim.now, until)
        return i

    EventLoop.run = _checked_loop_run

    # -- fused-admit checks in the flat drivers --------------------------
    workload.SIM_CHECK = True

    _installed = True


def uninstall() -> None:
    """Restore the unchecked originals.  Idempotent."""
    global _installed
    if not _installed:
        return
    from repro_torch.core import resources, simulator, workload

    setattr(resources.CorePool, "busy", _saved["busy_slot"])
    resources.CorePool.release_at = _saved["release_at"]
    resources.CorePool.__init__ = _saved["pool_init"]
    simulator.Simulator._schedule = _saved["schedule"]
    simulator.Simulator.run = _saved["sim_run"]
    simulator.EventLoop.run = _saved["loop_run"]
    workload.SIM_CHECK = False
    _saved.clear()
    _installed = False
