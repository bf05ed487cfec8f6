"""Declarative scenario specs for the experiment runner.

A :class:`Scenario` is plain data (picklable, JSON-serialisable) describing
a workload: which functions are deployed (the mix), how requests arrive
(the arrival process), for how long, and against which backends.  The
:mod:`repro_torch.experiments.runner` interprets the spec; nothing here touches
the simulator, so scenario definitions stay cheap to build and ship to
parallel worker processes.

The port's copy of the JAX package's ``experiments/scenario.py``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.autoscaler import (LeadTimePolicy, QueueDepthPolicy,
                                         ScalePolicy)
from repro_torch.core.latency import AES_600B_WORK_US
from repro_torch.core.workload import (ArrivalProcess, BurstyArrivals, ChainEdge,
                                       DiurnalArrivals, FusionPlan, LoadSpec,
                                       PoissonArrivals, TraceReplay)

# Default matrix: the paper's pair.  Scenarios can widen this to any set
# of registered backend names (see repro_torch.core.backends), and the runner
# computes paper-claim deltas from ``claims_pair`` regardless of how many
# other backends ride along.
DEFAULT_BACKENDS = ("containerd", "junctiond")
DEFAULT_CLAIMS_PAIR = ("containerd", "junctiond")


@dataclasses.dataclass(frozen=True)
class FunctionProfile:
    """One deployable function in a scenario's mix.

    ``work_us`` is the median per-invocation CPU cost; when
    ``heavy_tail_alpha`` is set the runner replaces the constant with a
    Pareto sampler of that shape pinned to the same median.

    ``edges`` names the function's downstream chain edges
    (:class:`~repro_torch.core.workload.ChainEdge`): completing an invocation
    triggers each edge's target with its probability, making the mix a
    chain/DAG workload.  Chain-only targets (weight 0) still belong in
    the scenario's ``functions`` so they get deployed.
    """
    name: str
    work_us: float = AES_600B_WORK_US
    payload_bytes: int = 600
    response_bytes: int = 628
    weight: float = 1.0
    scale: int = 1
    max_cores: int = 2
    heavy_tail_alpha: Optional[float] = None
    edges: Tuple[ChainEdge, ...] = ()


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Recipe for an arrival process, parameterised by the offered rate so
    one spec serves every point of a load sweep.

    kinds: ``poisson`` | ``bursty`` | ``diurnal`` | ``trace``.
    """
    kind: str = "poisson"
    # bursty: fraction of the aggregate rate carried by the quiet state,
    # and burst/quiet dwell times
    quiet_frac: float = 0.25
    mean_quiet_s: float = 0.20
    mean_burst_s: float = 0.05
    # diurnal
    amplitude: float = 0.8
    period_s: float = 1.0
    # trace: absolute timestamps (rate argument ignored)
    trace_s: Tuple[float, ...] = ()
    time_scale: float = 1.0

    def build(self, rate_rps: float) -> ArrivalProcess:
        if self.kind == "poisson":
            return PoissonArrivals(rate_rps)
        if self.kind == "bursty":
            # split the aggregate rate so the time-average equals rate_rps
            tot = self.mean_quiet_s + self.mean_burst_s
            quiet = rate_rps * self.quiet_frac
            burst = (rate_rps * tot - quiet * self.mean_quiet_s) / self.mean_burst_s
            return BurstyArrivals(quiet, burst, self.mean_quiet_s,
                                  self.mean_burst_s)
        if self.kind == "diurnal":
            return DiurnalArrivals(rate_rps, self.amplitude, self.period_s)
        if self.kind == "trace":
            return TraceReplay(self.trace_s, self.time_scale)
        raise ValueError(f"unknown arrival kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class AutoscalerSpec:
    """Recipe for putting an autoscaler in a scenario's control loop.

    ``policy`` picks the :class:`~repro_torch.core.autoscaler.ScalePolicy`
    implementation: ``"queue-depth"`` (fixed ``period_s``) or
    ``"lead-time"`` (control period and scale-up headroom derived from
    the backend's ColdStartModel; ``period_s`` is ignored).  The runner
    builds one fresh Autoscaler per (rate, seed) run and records its
    scale-event telemetry into the artifact (schema v3).
    """
    policy: str = "lead-time"
    min_replicas: int = 1
    max_replicas: int = 16
    target_inflight_per_replica: float = 4.0
    scale_down_hysteresis: float = 0.5
    period_s: float = 0.25              # queue-depth control period
    period_floor_s: float = 0.01        # lead-time period bounds
    period_ceil_s: float = 0.25
    lead_mult: float = 2.0

    def build(self) -> ScalePolicy:
        common = dict(
            min_replicas=self.min_replicas, max_replicas=self.max_replicas,
            target_inflight_per_replica=self.target_inflight_per_replica,
            scale_down_hysteresis=self.scale_down_hysteresis)
        if self.policy == "queue-depth":
            return QueueDepthPolicy(period_s=self.period_s, **common)
        if self.policy == "lead-time":
            return LeadTimePolicy(period_floor_s=self.period_floor_s,
                                  period_ceil_s=self.period_ceil_s,
                                  lead_mult=self.lead_mult, **common)
        raise ValueError(f"unknown autoscaler policy {self.policy!r}")


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Recipe for the adaptive SLO-knee search that replaces hand-sized
    rate grids on open-mode scenarios.

    The runner drives one :class:`~repro_torch.core.workload.KneeSearch` per
    (backend, seed): coarse exponential bracketing at low resolution
    (``bracket_duration_frac`` of the scenario duration), then SLO-aware
    geometric bisection until the bracket's relative width is within
    ``rel_tol`` — all under a hard ``max_probes`` open-loop sample budget.
    Smoke runs use the coarser ``smoke_rel_tol``/``smoke_max_probes``.

    ``rate0`` seeds the bracket; ``None`` (the default) calibrates it
    from a cheap closed-loop warm-latency measurement, so a brand-new
    backend needs zero hand-measured rate entries.  ``rate0_frac``
    down-scales that seed: knee-claim scenarios start near the capacity
    estimate (fast bracketing), satellite scenarios start well under it
    so even a two-probe smoke budget lands one comfortable-load probe
    whose latency row is a sane representative.
    """
    rate0: Optional[float] = None
    rate0_frac: float = 1.0
    growth: float = 2.0
    shrink: float = 0.75
    rel_tol: float = 0.10
    max_probes: int = 12
    smoke_rel_tol: float = 0.15
    smoke_max_probes: int = 8
    bracket_duration_frac: float = 0.4
    rate_floor: float = 25.0
    rate_ceiling: float = 64000.0

    def rel_tol_for(self, smoke: bool) -> float:
        return self.smoke_rel_tol if smoke else self.rel_tol

    def max_probes_for(self, smoke: bool) -> int:
        return self.smoke_max_probes if smoke else self.max_probes


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Fleet topology + provisioning model for ``mode="fleet"`` scenarios.

    ``n_workers`` is the **simulated** cluster size (not the runner's
    ``--workers`` process parallelism).  ``placement`` /
    ``distribution`` name the primary gateway policy and image
    distribution (see ``repro_torch.fleet``); ``compare_*`` adds variants the
    runner executes side by side, so one scenario can pit tree against
    naive provisioning or least-loaded against locality placement.

    A non-zero ``storm_replicas`` schedules a provisioning storm at
    ``storm_t_frac`` of the run: that many replicas of a fresh function
    spread across the fleet, every worker paying an image transfer
    (``image_mb`` over ``origin_gbps``/``peer_gbps``) before its
    backend's deploy path.  ``rates[backend]`` is interpreted
    **per worker**; the gateway admits ``rate * n_workers``.

    ``spread`` places the warm mix: ``"all"`` deploys every function on
    every worker; ``"zipf"`` gives the rank-r function a
    popularity-proportional worker subset (min 2), leaving the gateway's
    pressure-driven expansion to widen hot functions mid-run.
    ``spill_load`` is the outstanding-per-core threshold that triggers
    expansion (``None`` disables it).
    """
    n_workers: int = 32
    placement: str = "least-loaded"
    compare_placements: Tuple[str, ...] = ()
    distribution: str = "tree"
    compare_distributions: Tuple[str, ...] = ()
    storm_replicas: int = 0
    storm_t_frac: float = 0.25
    image_mb: float = 256.0
    origin_gbps: float = 10.0
    peer_gbps: float = 10.0
    fanout: int = 2
    spread: str = "all"            # "all" | "zipf"
    spill_load: Optional[float] = 8.0

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.spread not in ("all", "zipf"):
            raise ValueError(f"unknown spread {self.spread!r}")
        if not 0.0 <= self.storm_t_frac < 1.0:
            raise ValueError(
                f"storm_t_frac must be in [0, 1), got {self.storm_t_frac}")

    def placements(self) -> Tuple[str, ...]:
        return (self.placement,) + tuple(self.compare_placements)

    def distributions(self) -> Tuple[str, ...]:
        return (self.distribution,) + tuple(self.compare_distributions)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A complete experiment: mix + arrivals + duration + backend matrix.

    modes:
      * ``closed`` — n_requests sequential invocations per function
        (paper Fig 5 methodology); ``rates`` unused.
      * ``open``   — adaptive SLO-knee search per backend (the default:
        ``search_spec()``), or an open-loop sweep over ``rates[backend]``
        when the scenario pins explicit grids (paper Fig 6 methodology,
        exact-reproduction runs).
      * ``storm``  — ``storm_functions`` concurrent deploy+first-invoke
        (cold-start storm; FaaSNet's provisioning regime).
      * ``mixed``  — steady warm traffic at ``rates[backend][0]`` plus a
        ``storm_functions`` provisioning storm on the same worker mid-run
        (warm-path interference; cold/warm path coupling).
      * ``fleet``  — an N-worker cluster behind a gateway
        (``repro_torch.fleet``), topology from ``fleet``; warm traffic at
        ``rates[backend][0]`` **per worker**, optional mid-run
        provisioning storm with image distribution (FaaSNet regime),
        placement/distribution variants side by side.
      * ``chain``  — chained/DAG traffic at ``rates[backend][0]``: the
        mix's ``edges`` expand each root arrival into its chain of
        hops; when ``fusion`` is set the same seeds also run fused
        (selected edges co-located in the caller's sandbox) and the
        result carries the fused-vs-unfused comparison.

    An optional ``autoscaler`` spec puts a backend-aware autoscaler in
    the control loop of ``open``/``mixed`` runs; its scale-event
    telemetry (reaction times, replica timeline, cold starts) lands in
    the artifact.
    """
    name: str
    description: str
    mode: str = "open"
    functions: Tuple[FunctionProfile, ...] = (FunctionProfile("aes"),)
    arrival: ArrivalSpec = ArrivalSpec("poisson")
    rates: Optional[Dict[str, Tuple[float, ...]]] = None
    smoke_rates: Optional[Dict[str, Tuple[float, ...]]] = None
    search: Optional[SearchSpec] = None
    duration_s: float = 1.0
    warmup_frac: float = 0.2
    n_requests: int = 100
    seeds: Tuple[int, ...] = (0,)
    n_cores: int = 10
    slo_p99_ms: float = 10.0
    storm_functions: int = 16
    fleet: Optional[FleetSpec] = None     # mode="fleet" topology
    fusion: Optional[FusionPlan] = None   # mode="chain" fusion pass
    autoscaler: Optional[AutoscalerSpec] = None
    backends: Tuple[str, ...] = DEFAULT_BACKENDS
    # (baseline, treatment) pair the paper-claim reductions are computed
    # from; claims are skipped when the pair is not part of the run.
    claims_pair: Tuple[str, str] = DEFAULT_CLAIMS_PAIR
    claims_kind: Optional[str] = None     # "fig5" | "fig6" | "coldstart"
    tags: Tuple[str, ...] = ()

    def search_spec(self) -> Optional[SearchSpec]:
        """The effective knee-search spec, or ``None`` when this scenario
        runs on a rate grid.

        Adaptive search is the default for open-mode scenarios: a
        scenario that pins explicit ``rates`` (exact-reproduction runs,
        the grid-mode regression anchor) keeps the grid sweep, and
        non-open modes never search."""
        if self.mode != "open" or self.rates:
            return None
        return self.search or SearchSpec()

    def weights(self) -> List[float]:
        return [f.weight for f in self.functions]

    def fn_names(self) -> List[str]:
        return [f.name for f in self.functions]

    def chain_edges(self) -> Dict[str, Tuple[ChainEdge, ...]]:
        """The mix's chain graph: function name -> downstream edges
        (empty when no profile declares edges)."""
        return {p.name: tuple(p.edges) for p in self.functions if p.edges}

    def load_spec(self, rate: float, duration_s: float,
                  fusion: Optional[FusionPlan] = None) -> LoadSpec:
        """The :func:`repro_torch.core.workload.drive` load for one open-loop
        run of this scenario at ``rate`` (mix, arrivals, warmup, and —
        when the mix declares edges — its chain graph).  ``fusion``
        optionally applies a fusion pass to the chained load."""
        chains = self.chain_edges()
        return LoadSpec(arrivals=self.arrival.build(rate),
                        functions=tuple(self.fn_names()),
                        weights=tuple(self.weights()),
                        duration_s=duration_s,
                        warmup_frac=self.warmup_frac,
                        chains=chains or None,
                        fusion=fusion)

    def rates_for(self, backend: str, smoke: bool = False) -> Sequence[float]:
        """Rate grid for one backend; the ``"*"`` key is the fallback grid
        for backends without an explicit entry (lets a scenario run
        against any registered backend).

        Falling through to ``"*"`` when the table carries explicit
        per-backend grids emits a one-line warning naming the backend: a
        fallback grid is sized for somebody else's knee, and silently
        reusing it has hidden backends sweeping entirely past their cliff
        (quark, pre-PR 3).  A table whose *only* key is ``"*"`` (e.g. the
        trace-replay scenario, where the trace fixes the rate) is a
        deliberate one-grid-for-all and stays silent."""
        table = (self.smoke_rates if smoke and self.smoke_rates
                 else self.rates) or {}
        if backend in table:
            return table[backend]
        fallback = table.get("*", ())
        if fallback and any(k != "*" for k in table):
            warnings.warn(
                f"scenario {self.name!r}: backend {backend!r} has no "
                f"explicit rate grid; falling back to the '*' grid "
                f"{tuple(fallback)} — size a knee-specific grid for it",
                RuntimeWarning, stacklevel=2)
        return fallback

def zipf_mix(n_functions: int, zipf_a: float = 1.5,
             work_us: float = AES_600B_WORK_US,
             prefix: str = "f") -> Tuple[FunctionProfile, ...]:
    """A multi-tenant mix with Zipf-distributed popularity (Shahrad et al.:
    most functions are rarely invoked)."""
    ranks = range(1, n_functions + 1)
    return tuple(FunctionProfile(name=f"{prefix}{i}", work_us=work_us,
                                 weight=float(r) ** (-zipf_a))
                 for i, r in enumerate(ranks))
