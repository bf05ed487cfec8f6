"""faasd runtime model: gateway → provider → function instance (paper §2.1.1).

Every invocation traverses the gateway and the provider before reaching
the sandbox running the function (3 gRPC legs, responses flowing back the
same path).  Where the orchestration services run and which datapath a
message rides is entirely the :class:`~repro_torch.core.backends.ExecutionBackend`'s
business: the runtime composes with whatever bundle the backend provides
(cost tables, core pool, optional scheduler, netstack, lifecycle) and has
no backend-specific branches.  Backends resolve by registry name or can
be passed as ready instances.

The provider optionally caches function metadata (replica count, IP,
port), keeping the backend's control plane off the warm critical path
(paper §4; applied to EVERY backend for a fair comparison, as in the
paper).

The port's copy of the JAX package's ``core/faas.py``: the generator
invocation path, which :func:`~repro_torch.core.workload.run_sequential`
drives.  The hop-compressed ``InvocationPlan`` of the open-loop ``drive``
and function chains come with ``drive`` (ROADMAP.md, queue 1 item 6d).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Generator, List, Optional, Union

from repro_torch.core.backends import ExecutionBackend, resolve_backend
from repro_torch.core.latency import AES_600B_WORK_US, RuntimeCosts
from repro_torch.core.scheduler import PollingModel
from repro_torch.core.simulator import Simulator


@dataclasses.dataclass
class FunctionSpec:
    """A deployable FaaS function."""
    name: str
    work_us: Union[float, Callable[[], float]] = AES_600B_WORK_US
    payload_bytes: int = 600
    response_bytes: int = 628          # input + AES-CTR overhead
    scale: int = 1
    max_cores: int = 2

    def work_seconds(self) -> float:
        w = self.work_us() if callable(self.work_us) else self.work_us
        return w * 1e-6


@dataclasses.dataclass(slots=True)
class InvocationRecord:
    fn: str
    t_arrival: float
    t_start_exec: float = 0.0
    t_end_exec: float = 0.0
    t_done: float = 0.0
    cold: bool = False

    @property
    def e2e(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def exec_latency(self) -> float:
        return self.t_end_exec - self.t_start_exec


class FaasdRuntime:
    """One worker node running the full faasd stack."""

    def __init__(self, sim: Simulator, *,
                 backend: Union[str, ExecutionBackend] = "junctiond",
                 n_cores: Optional[int] = None, provider_cache: bool = True,
                 polling_model: Optional[PollingModel] = None):
        self.sim = sim
        self.provider_cache = provider_cache
        self.backend = resolve_backend(backend, sim, n_cores=n_cores,
                                       polling_model=polling_model)
        self.backend_name = self.backend.name
        self.runtime: RuntimeCosts = self.backend.runtime
        self.cores = self.backend.cores
        self.scheduler = self.backend.scheduler
        self.stack = self.backend.stack
        self.manager = self.backend     # lifecycle ops go to the backend
        self.functions: Dict[str, FunctionSpec] = {}
        self._cache: Dict[str, object] = {}
        self.records: List[InvocationRecord] = []
        self.cache_hits = 0
        self.cache_misses = 0
        self.rejected = 0

    # -- deployment -------------------------------------------------------
    def deploy(self, spec: FunctionSpec) -> Generator:
        self.functions[spec.name] = spec
        yield from self.manager.deploy(spec.name, scale=spec.scale,
                                       max_cores=spec.max_cores)
        if self.provider_cache:
            self._cache[spec.name] = self.manager.lookup(spec.name)

    def deploy_blocking(self, spec: FunctionSpec) -> None:
        p = self.sim.process(self.deploy(spec))
        p.completion.callbacks.append(lambda _v: self.sim.stop())
        self.sim.run()
        assert p.done

    # -- helpers ------------------------------------------------------
    def _app(self, base_us: float) -> Generator:
        """Application processing: critical-path CPU with jitter, plus
        off-critical-path CPU (GC/softirq/bookkeeping) consumed
        asynchronously — it caps throughput without adding latency at low
        load."""
        t = self.sim.lognormal_us(base_us, self.runtime.app_jitter_sigma)
        yield from self.cores.consume(t)
        extra = t * (self.runtime.offpath_cpu_mult - 1.0)
        if extra > 0:
            self.sim.process(self.cores.consume(extra))

    def _exec_function(self, spec: FunctionSpec) -> Generator:
        """The function body: compute + OS interactions (+ tail hiccups)."""
        r = self.runtime
        work = spec.work_seconds() * r.work_mult
        overhead = self.sim.lognormal_us(r.exec_syscall_overhead_us,
                                         r.app_jitter_sigma)
        hic = 0.0
        if self.sim.rng.random() < r.exec_hiccup_p:
            hic = float(self.sim.rng.uniform(r.exec_hiccup_lo_ms,
                                             r.exec_hiccup_hi_ms)) * 1e-3
        yield from self.cores.consume(work + overhead)
        if hic:
            yield self.sim.timeout(hic)

    def _resolve(self, fn_name: str) -> Generator:
        """Provider resolving the function endpoint: cache or backend query."""
        if self.provider_cache and fn_name in self._cache:
            self.cache_hits += 1
            return self._cache[fn_name]
        self.cache_misses += 1
        rec = yield from self.manager.query(fn_name)
        if self.provider_cache:
            self._cache[fn_name] = rec
        return rec

    # -- the invocation path (measured from the gateway, as in Fig 5) ------
    def invoke(self, fn_name: str) -> Generator:
        """Process: one warm invocation; returns the InvocationRecord."""
        spec = self.functions[fn_name]
        r = self.runtime
        rec = InvocationRecord(fn=fn_name, t_arrival=self.sim.now)
        p = spec.payload_bytes
        # 1. gateway: auth + route + proxy
        yield from self._app(r.gateway_us)
        # 2. gw -> provider (gRPC leg 1)
        yield from self.stack.deliver(p + 220)
        # 3. provider: resolve endpoint (+ proxy)
        yield from self._resolve(fn_name)
        yield from self._app(r.provider_us)
        # 4. provider -> function instance (gRPC leg 2)
        yield from self.stack.deliver(p + 180)
        # 5. in-instance watchdog dispatch
        yield from self._app(r.watchdog_us)
        # 6. function execution
        rec.t_start_exec = self.sim.now
        yield from self._exec_function(spec)
        rec.t_end_exec = self.sim.now
        # 7. response: fn -> provider -> gateway (reverse proxying)
        yield from self.stack.deliver(spec.response_bytes + 120)
        yield from self._app(r.provider_us * 0.35)
        yield from self.stack.deliver(spec.response_bytes + 120)
        yield from self._app(r.gateway_us * 0.35)
        rec.t_done = self.sim.now
        self.records.append(rec)
        return rec

    # -- metrics ----------------------------------------------------------
    def latencies_ms(self) -> List[float]:
        return [r.e2e * 1e3 for r in self.records]

    def exec_latencies_ms(self) -> List[float]:
        return [r.exec_latency * 1e3 for r in self.records]
