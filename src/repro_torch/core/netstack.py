"""Network datapath models: kernel stack vs Junction kernel-bypass.

``deliver`` models one message traversal end-to-end: sender-side
processing, wire, receiver-side processing, and the wakeup of the target
(interrupt + context switch for the kernel path; centralized-scheduler
poll pickup for Junction).  CPU costs are charged to the host core pool;
latency-only components just advance time.
"""
from __future__ import annotations

from typing import Generator

from repro_torch.core.latency import StackCosts
from repro_torch.core.resources import CorePool
from repro_torch.core.simulator import Simulator


class NetStack:
    def __init__(self, sim: Simulator, costs: StackCosts, cores: CorePool):
        self.sim = sim
        self.costs = costs
        self.cores = cores
        # accounting
        self.messages = 0
        self.cpu_spent = 0.0
        self.hiccups = 0

    def _jitter(self, base_us: float) -> float:
        return self.sim.lognormal_us(base_us, self.costs.jitter_sigma)

    def _maybe_hiccup(self) -> float:
        c = self.costs
        if self.sim.rng.random() < c.hiccup_p:
            self.hiccups += 1
            return float(self.sim.rng.uniform(c.hiccup_lo_ms, c.hiccup_hi_ms)) * 1e-3
        return 0.0

    def deliver(self, size_bytes: int = 1024) -> Generator:
        """Process: one one-way message; returns (yields through) when the
        payload is in the receiver's hands (post-wakeup)."""
        c = self.costs
        kb = size_bytes / 1024.0
        # sender side: syscall + stack tx (consumes CPU and adds latency)
        tx_cpu = (c.tx_cpu_us + c.per_kb_us * kb) * 1e-6
        yield from self.cores.consume(tx_cpu)
        self.cpu_spent += tx_cpu
        yield self.sim.timeout(self._jitter(c.send_lat_us))
        # wire
        yield self.sim.timeout(c.wire_us * 1e-6)
        # receiver side: rx processing + wakeup of target thread/uthread
        rx_cpu = (c.rx_cpu_us + c.wakeup_cpu_us + c.per_kb_us * kb) * 1e-6
        yield from self.cores.consume(rx_cpu)
        self.cpu_spent += rx_cpu
        lat = self._jitter(c.rx_lat_us + c.wakeup_us) + self._maybe_hiccup()
        yield self.sim.timeout(lat)
        self.messages += 1
