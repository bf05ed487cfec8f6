"""junctiond — the paper's contribution (§3/§4): a function manager that
replaces containerd, deploying faasd components and user functions inside
Junction instances.

Responsibilities (paper §4): configure instance networking, deploy
instances via ``junction_run``, monitor running state.  junctiond itself
is the only component outside a Junction instance (it must spawn new host
processes).  Scale-up of a function either (a) adds uProcs to an existing
instance (runtimes without native parallelism, e.g. Python), (b) raises
the instance's core cap, or (c) spawns an isolated sibling instance.

As an :class:`~repro_torch.core.backends.ExecutionBackend` it also owns the
bypass datapath bundle: the centralized polling scheduler (one reserved
core), the Junction netstack costs, and the Junction instances hosting
the faasd gateway/provider services themselves (paper §3: "Junction
instances host not only the function code but also the services in the
FaaS runtime").
"""
from __future__ import annotations

import dataclasses
from typing import Generator, List, Optional

from repro_torch.core.backends import (ColdStartModel, ExecutionBackend,
                                       register_backend)
from repro_torch.core.junction import JunctionInstance
from repro_torch.core.latency import (JUNCTION_INSTANCE_INIT_MS, JUNCTION_RUNTIME,
                                      JUNCTION_STACK, JUNCTION_UPROC_SPAWN_MS,
                                      JUNCTIOND_QUERY_MS)
from repro_torch.core.scheduler import JunctionScheduler, PollingModel


@dataclasses.dataclass
class FunctionRecord:
    name: str
    instances: List[JunctionInstance]
    ip: str
    port: int
    replicas: int = 1
    isolated: bool = False      # replica = sibling instance, not uProc

    @property
    def ready(self) -> bool:
        return all(i.ready for i in self.instances)


@register_backend
class Junctiond(ExecutionBackend):
    name = "junctiond"
    runtime = JUNCTION_RUNTIME
    stack_costs = JUNCTION_STACK
    coldstart = ColdStartModel(
        deploy_ms=JUNCTION_INSTANCE_INIT_MS,
        scale_factor=JUNCTION_UPROC_SPAWN_MS / JUNCTION_INSTANCE_INIT_MS,
        query_ms=JUNCTIOND_QUERY_MS)

    # -- wiring ----------------------------------------------------------
    def _build_scheduler(self, polling_model: PollingModel) -> JunctionScheduler:
        scheduler = JunctionScheduler(self.sim, self.cores, polling_model)
        scheduler.run()
        return scheduler

    def _start_services(self) -> None:
        # the runtime services themselves live in Junction instances
        self._svc_gateway = JunctionInstance(self.sim, "svc/gateway",
                                             max_cores=4)
        self._svc_provider = JunctionInstance(self.sim, "svc/provider",
                                              max_cores=4)
        self._svc_gateway.ready = self._svc_provider.ready = True
        self.scheduler.register(self._svc_gateway)
        self.scheduler.register(self._svc_provider)

    # -- lifecycle -------------------------------------------------------
    def deploy(self, fn_name: str, *, scale: int = 1, max_cores: int = 2,
               isolate_replicas: bool = False) -> Generator:
        """Process: spawn Junction instance(s) via `junction_run` and
        configure networking.  Yields until ready."""
        self.remove(fn_name)      # redeploy releases the old instances
        insts: List[JunctionInstance] = []
        n_instances = scale if isolate_replicas else 1
        for i in range(n_instances):
            inst = yield from self._spawn_instance(fn_name, i, max_cores)
            if not isolate_replicas:
                for j in range(1, scale):
                    inst.spawn_uproc(f"{fn_name}/uproc{j}")
            insts.append(inst)
        self.records[fn_name] = FunctionRecord(
            name=fn_name, instances=insts, ip=f"10.62.0.{len(self.records) + 2}",
            port=8080, replicas=scale, isolated=isolate_replicas)
        self.deploys += 1

    def _spawn_instance(self, fn_name: str, idx: int,
                        max_cores: int) -> Generator:
        inst = JunctionInstance(self.sim, f"{fn_name}#{idx}",
                                max_cores=max_cores)
        # paper §5: 3.4 ms measured instance init (single-threaded)
        yield self.sim.timeout(self.coldstart.deploy_seconds)
        inst.spawn_uproc(f"{fn_name}/uproc0")
        inst.ready = True
        self.scheduler.register(inst)
        return inst

    def scale(self, fn_name: str, replicas: int) -> Generator:
        rec = self._require(fn_name)
        if rec.isolated:
            # replica = sibling instance: spawn new ones at full instance
            # init cost, reap extras (keeping one warm, as the shared path
            # keeps its instance) and release their scheduler registrations
            while len(rec.instances) < replicas:
                inst = yield from self._spawn_instance(
                    fn_name, len(rec.instances), rec.instances[0].max_cores)
                rec.instances.append(inst)
            for inst in rec.instances[max(1, replicas):]:
                self.scheduler.unregister(inst)
            del rec.instances[max(1, replicas):]
        else:
            inst = rec.instances[0]
            while len(inst.uprocs) < replicas:
                inst.spawn_uproc(f"{fn_name}/uproc{len(inst.uprocs)}")
                # uProc spawn inside the libOS
                yield self.sim.timeout(self.coldstart.scale_seconds)
            # scale-down reaps uProcs, keeping one warm like the isolated
            # path keeps an instance (scale-to-zero = warm floor of one)
            del inst.uprocs[max(1, replicas):]
        rec.replicas = replicas

    def remove(self, fn_name: str) -> None:
        rec = self.records.pop(fn_name, None)
        if rec:
            for inst in rec.instances:
                self.scheduler.unregister(inst)

    # query(): inherited control-plane state query at JUNCTIOND_QUERY_MS
    # (what the provider cache avoids, paper §4).

    def lookup(self, fn_name: str) -> Optional[FunctionRecord]:
        return self.records.get(fn_name)
