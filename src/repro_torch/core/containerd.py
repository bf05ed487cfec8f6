"""containerd-backed baseline (mainline faasd): Linux containers as the
function sandbox, kernel network stack, CFS scheduling."""
from __future__ import annotations

import dataclasses
from typing import Generator, Optional

from repro_torch.core.backends import (ColdStartModel, ExecutionBackend,
                                       register_backend)
from repro_torch.core.latency import (CONTAINERD_COLDSTART_MS, CONTAINERD_QUERY_MS,
                                      KERNEL_RUNTIME, KERNEL_STACK)


@dataclasses.dataclass
class ContainerRecord:
    name: str
    ip: str
    port: int
    replicas: int = 1
    ready: bool = True


@register_backend
class Containerd(ExecutionBackend):
    """Container-class lifecycle: ms-scale control plane, cold starts in
    the hundreds of ms."""

    name = "containerd"
    runtime = KERNEL_RUNTIME
    stack_costs = KERNEL_STACK
    coldstart = ColdStartModel(deploy_ms=CONTAINERD_COLDSTART_MS,
                               scale_factor=0.6,
                               query_ms=CONTAINERD_QUERY_MS)

    def deploy(self, fn_name: str, *, scale: int = 1, max_cores: int = 2,
               isolate_replicas: bool = False) -> Generator:
        """Sandbox create + task start (warm image)."""
        self.remove(fn_name)      # redeploy releases the old sandbox
        yield self.sim.timeout(self.coldstart.deploy_seconds)
        self.records[fn_name] = ContainerRecord(
            name=fn_name, ip=f"10.62.0.{len(self.records) + 2}", port=8080,
            replicas=scale)
        self.deploys += 1

    def scale(self, fn_name: str, replicas: int) -> Generator:
        rec = self._require(fn_name)
        # additional (or reaped) sandbox tasks
        yield self.sim.timeout(self.coldstart.scale_seconds)
        rec.replicas = replicas

    # query(): the inherited GetTask/Status RPC costs CONTAINERD_QUERY_MS —
    # ms-scale, can exceed the function execution itself (paper §4).

    def lookup(self, fn_name: str) -> Optional[ContainerRecord]:
        return self.records.get(fn_name)
