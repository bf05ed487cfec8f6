"""Junction abstractions: instances, uProcs, queues (paper §2.2.1).

A ``JunctionInstance`` is a host-kernel process running the Junction
libOS kernel.  Executables inside it are ``uProc``s sharing that kernel;
each instance owns dedicated NIC packet queue pairs plus an event queue
that signals packet arrival to the centralized scheduler.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

from repro_torch.core.latency import JUNCTION_INSTANCE_INIT_MS
from repro_torch.core.simulator import Queue, Simulator

_ids = itertools.count()


@dataclasses.dataclass
class UProc:
    """User-level process-like abstraction inside an instance."""
    name: str
    handler: Optional[Callable] = None
    threads_active: int = 0


class JunctionInstance:
    """One libOS process: packet queues + event queue + uProcs.

    Syscalls of interposed binaries are served by the Junction kernel in
    user space (no host trap); only core/memory multiplexing reaches the
    host kernel.
    """

    INIT_SECONDS = JUNCTION_INSTANCE_INIT_MS * 1e-3

    def __init__(self, sim: Simulator, name: str, max_cores: int = 2,
                 nic_queue_pairs: int = 1):
        self.sim = sim
        self.id = next(_ids)
        self.name = name
        self.max_cores = max_cores
        self.nic_queue_pairs = max(1, nic_queue_pairs)
        self.packet_queue: Queue = sim.queue()   # direct HW delivery
        self.event_queue: Queue = sim.queue()    # arrival signals -> scheduler
        self.uprocs: list[UProc] = []
        self.cores_granted = 0
        self.runnable_uthreads = 0
        self.ready = False

    def spawn_uproc(self, name: str, handler: Optional[Callable] = None) -> UProc:
        up = UProc(name=name, handler=handler)
        self.uprocs.append(up)
        return up

    @property
    def core_demand(self) -> int:
        """Cores the instance could use right now (runnable work + packets),
        bounded by its configured limit."""
        want = self.runnable_uthreads + len(self.packet_queue.items)
        return min(self.max_cores, want)

    def signal_packet(self) -> None:
        """HW writes the event queue; the scheduler polls it."""
        self.event_queue.put(self.sim.now)
