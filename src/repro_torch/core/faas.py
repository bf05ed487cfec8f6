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
and the open loop's process engine drive (with the payload scale and the
fused callees of a function chain), and the hop-compressed
:class:`InvocationPlan` of the open loop's event engine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Generator, List, Optional, Tuple, Union

import numpy as np

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


@dataclasses.dataclass(frozen=True)
class InvocationPlan:
    """Hop-compressed invocation template for the event-heap driver.

    The generator path (:meth:`FaasdRuntime.invoke`) walks 14 CPU
    segments and 8 latency gaps per request; the flat driver compresses
    that chain to the station level — 3 contiguous-CPU *holds* separated
    by 2 pure-latency *gaps*, plus one merged off-path CPU job — so a
    request costs ~4 heap events instead of ~40 generator resumes.
    Component sums are preserved exactly: uncontended end-to-end latency
    and total CPU per request (hence capacity/knee locations) match the
    generator path; only the intra-request interleaving is coarser.

    Stations (CPU, acquired through the core pool with thrash):
      H0 ingress: gateway + both request-side proxy legs (gw->provider,
         provider->instance tx/rx and app costs)
      H1 exec: rx + watchdog + exec body + tx(response leg 1)
      H2 egress: both response-side proxy legs + gateway response
    Gaps (latency only, between consecutive stations): the summed send
    jitter + wire + rx/wakeup jitter + tail hiccups of the legs each
    station absorbed; the exec hiccup rides the egress gap.  The
    off-path job merges the five per-_app async CPU chunks into one
    (spawned at H0 completion, backlog weight 5 so the thrash signal
    sees the same queued-entry pressure as five legacy jobs).
    """

    fn: str
    app_medians_us: Tuple[float, ...]    # gw, provider, watchdog, p*.35, g*.35
    app_sigma: float
    tx_cpu_s: Tuple[float, ...]          # per net leg, seconds
    rx_cpu_s: Tuple[float, ...]
    send_lat_us: float
    rx_wake_us: float
    wire_s: float
    net_sigma: float
    net_hiccup_p: float
    net_hiccup_lo_s: float
    net_hiccup_hi_s: float
    work_us: Union[float, Callable[[], float]]
    work_mult: float
    overhead_us: float
    exec_hiccup_p: float
    exec_hiccup_lo_s: float
    exec_hiccup_hi_s: float
    offpath_mult: float
    stack_cpu_s: float                   # total netstack CPU per request

    OFFPATH_BACKLOG_WEIGHT = 5
    # a queued station wait stands for the queue pressure of the several
    # finer-grained legacy segment waits it merged: without the extra
    # weight the thrash signal under-reads near saturation and the
    # compressed plan's SLO knees drift one search step (~9%) above the
    # generator engine's (calibrated against the 6-backend knee suite)
    STATION_BACKLOG_WEIGHT = 2

    def _work_batch(self, rng: np.random.Generator, m: int) -> np.ndarray:
        w = self.work_us
        if callable(w):
            batch = getattr(w, "sample", None)
            if batch is not None:
                return np.asarray(batch(m), dtype=np.float64) * 1e-6
            return np.array([w() for _ in range(m)], dtype=np.float64) * 1e-6
        return np.full(m, w * 1e-6)

    def sample(self, rng: np.random.Generator, m: int):
        """Vectorized per-request variates for ``m`` invocations.

        Returns ``(holds, gaps, offpath, exec_s, n_net_hiccups)`` with
        ``holds`` of shape (m, 3), ``gaps`` (m, 2), ``offpath``/
        ``exec_s`` (m,) — all in seconds."""
        sig = self.app_sigma
        apps = [rng.lognormal(math.log(mu), sig, m) * 1e-6
                for mu in self.app_medians_us]
        work = self._work_batch(rng, m) * self.work_mult
        overhead = rng.lognormal(math.log(self.overhead_us), sig, m) * 1e-6
        ehic = np.zeros(m)
        hit = rng.random(m) < self.exec_hiccup_p
        ehic[hit] = rng.uniform(self.exec_hiccup_lo_s, self.exec_hiccup_hi_s,
                                int(hit.sum()))
        holds = np.empty((m, 3))
        holds[:, 0] = (apps[0] + self.tx_cpu_s[0]
                       + self.rx_cpu_s[0] + apps[1] + self.tx_cpu_s[1])
        holds[:, 1] = (self.rx_cpu_s[1] + apps[2] + work + overhead
                       + self.tx_cpu_s[2])
        holds[:, 2] = (self.rx_cpu_s[2] + apps[3] + self.tx_cpu_s[3]
                       + self.rx_cpu_s[3] + apps[4])
        # each compressed gap absorbs two of the chain's four net legs
        # (ingress: legs 0+1, egress: legs 2+3) — sums preserved
        gaps = np.empty((m, 2))
        n_hic = 0
        for k in range(2):
            send = rng.lognormal(math.log(self.send_lat_us),
                                 self.net_sigma, (2, m)).sum(axis=0) * 1e-6
            rx = rng.lognormal(math.log(self.rx_wake_us),
                               self.net_sigma, (2, m)).sum(axis=0) * 1e-6
            gaps[:, k] = send + 2.0 * self.wire_s + rx
            hit = rng.random((2, m)) < self.net_hiccup_p
            nh = int(hit.sum())
            if nh:
                extra = np.zeros((2, m))
                extra[hit] = rng.uniform(self.net_hiccup_lo_s,
                                         self.net_hiccup_hi_s, nh)
                gaps[:, k] += extra.sum(axis=0)
                n_hic += nh
        gaps[:, 1] += ehic
        offpath = ((apps[0] + apps[1] + apps[2] + apps[3] + apps[4])
                   * (self.offpath_mult - 1.0))
        exec_s = work + overhead + ehic
        return holds, gaps, offpath, exec_s, n_hic

    def sample_exec(self, rng: np.random.Generator, m: int):
        """Exec-only variates for ``m`` *fused* intra-sandbox handoffs:
        a fused chain callee skips the gateway and netstack stations
        entirely, so only its function body is charged — ``(cpu, hic)``
        where ``cpu`` is CPU held on the exec station (work + syscall
        overhead) and ``hic`` is tail-hiccup latency, both (m,) in
        seconds."""
        work = self._work_batch(rng, m) * self.work_mult
        overhead = rng.lognormal(math.log(self.overhead_us),
                                 self.app_sigma, m) * 1e-6
        hic = np.zeros(m)
        hit = rng.random(m) < self.exec_hiccup_p
        hic[hit] = rng.uniform(self.exec_hiccup_lo_s, self.exec_hiccup_hi_s,
                               int(hit.sum()))
        return work + overhead, hic


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

    def invocation_plan(self, fn_name: str,
                        payload_scale: float = 1.0) -> InvocationPlan:
        """Compile the warm invocation chain for ``fn_name`` into the
        hop-compressed template the event-heap driver executes (see
        :class:`InvocationPlan`).  Message sizes and cost tables are
        resolved once here instead of per request.  ``payload_scale``
        scales the request payload (a chain hop's input is the upstream
        edge's transformed payload); the response rides unscaled."""
        spec = self.functions[fn_name]
        r = self.runtime
        c = self.stack.costs
        p = spec.payload_bytes * payload_scale
        sizes = (p + 220, p + 180,
                 spec.response_bytes + 120, spec.response_bytes + 120)
        tx = tuple((c.tx_cpu_us + c.per_kb_us * s / 1024.0) * 1e-6
                   for s in sizes)
        rx = tuple((c.rx_cpu_us + c.wakeup_cpu_us
                    + c.per_kb_us * s / 1024.0) * 1e-6 for s in sizes)
        return InvocationPlan(
            fn=fn_name,
            app_medians_us=(r.gateway_us, r.provider_us, r.watchdog_us,
                            r.provider_us * 0.35, r.gateway_us * 0.35),
            app_sigma=r.app_jitter_sigma,
            tx_cpu_s=tx, rx_cpu_s=rx,
            send_lat_us=c.send_lat_us,
            rx_wake_us=c.rx_lat_us + c.wakeup_us,
            wire_s=c.wire_us * 1e-6,
            net_sigma=c.jitter_sigma,
            net_hiccup_p=c.hiccup_p,
            net_hiccup_lo_s=c.hiccup_lo_ms * 1e-3,
            net_hiccup_hi_s=c.hiccup_hi_ms * 1e-3,
            work_us=spec.work_us, work_mult=r.work_mult,
            overhead_us=r.exec_syscall_overhead_us,
            exec_hiccup_p=r.exec_hiccup_p,
            exec_hiccup_lo_s=r.exec_hiccup_lo_ms * 1e-3,
            exec_hiccup_hi_s=r.exec_hiccup_hi_ms * 1e-3,
            offpath_mult=r.offpath_cpu_mult,
            stack_cpu_s=float(sum(tx) + sum(rx)),
        )

    # -- the invocation path (measured from the gateway, as in Fig 5) ------
    def invoke(self, fn_name: str, payload_scale: float = 1.0,
               fused: Tuple[str, ...] = ()) -> Generator:
        """Process: one warm invocation; returns the InvocationRecord.

        ``payload_scale`` scales the request payload (chain hops carry
        the upstream edge's transformed payload); ``fused`` names chain
        callees co-located in this sandbox — their function bodies run
        inline inside the exec span, skipping gateway and netstack."""
        spec = self.functions[fn_name]
        r = self.runtime
        rec = InvocationRecord(fn=fn_name, t_arrival=self.sim.now)
        p = spec.payload_bytes * payload_scale
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
        # 6. function execution (+ fused chain callees, in-sandbox)
        rec.t_start_exec = self.sim.now
        yield from self._exec_function(spec)
        for nm in fused:
            yield from self._exec_function(self.functions[nm])
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
