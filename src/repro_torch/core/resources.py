"""Host CPU core pool with a scheduling-thrash model.

``consume`` acquires one core for ``cpu_time`` seconds (FIFO).  The
effective occupancy is scaled by a thrash multiplier that grows with the
runnable backlog — modelling cache pollution, migrations and context
switching of kernel CFS under load (cf. Caladan).  Junction's
run-to-completion scheduling sets a near-1 cap.

The port's copy of the JAX package's ``core/resources.py``, with the
generator path only: the event-heap fast path and its lazy releases serve
the open-loop ``drive``, which is not ported yet.  On the generator path the
two pools take the same decisions in the same order.
"""
from __future__ import annotations

from collections import deque
from typing import Generator

from repro_torch.core.latency import RuntimeCosts
from repro_torch.core.simulator import Simulator


class CorePool:
    __slots__ = ("sim", "n_cores", "runtime", "busy", "_waiters",
                 "busy_time", "served")

    def __init__(self, sim: Simulator, n_cores: int, runtime: RuntimeCosts):
        self.sim = sim
        self.n_cores = n_cores
        self.runtime = runtime
        self.busy = 0
        self._waiters: deque = deque()     # FIFO of Events
        # accounting
        self.busy_time = 0.0
        self.served = 0

    # -- inspection ------------------------------------------------------
    @property
    def backlog(self) -> int:
        return len(self._waiters)

    def thrash(self) -> float:
        r = self.runtime
        x = self.backlog / max(1, self.n_cores)
        return min(r.thrash_cap, 1.0 + r.thrash_coeff * x)

    def utilization(self, horizon: float) -> float:
        return self.busy_time / (horizon * self.n_cores) if horizon > 0 else 0.0

    # -- usage -------------------------------------------------------
    def consume(self, cpu_time: float) -> Generator:
        """Process-style: yield from pool.consume(t)."""
        if self.busy >= self.n_cores:
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

    def _grant_next(self) -> None:
        if self._waiters and self.busy < self.n_cores:
            self._waiters.popleft().succeed()

    def remove_cores(self, n: int) -> None:
        """Dedicate cores elsewhere (e.g. per-instance polling)."""
        self.n_cores = max(0, self.n_cores - n)

    def add_cores(self, n: int) -> None:
        self.n_cores += n
