"""Workload generators + metric helpers for the evaluation (paper §5).

Beyond the paper's two methodologies (sequential closed loop, Poisson open
loop) this module provides the arrival-process zoo the scenario suite
drives: bursty MMPP traffic (FaaSNet's dominant provisioning regime),
diurnal rate drift, trace replay, and heavy-tailed per-invocation work —
all deterministic under a fixed RNG so every stream is reproducible.

The port's copy of the JAX package's ``core/workload.py``: the closed loop
(``run_sequential``), the open loop ``drive(runtime, LoadSpec)`` on both
engines with function chains and fusion, the SLO-knee search
(``KneeSearch``) and ``sustainable_throughput`` (Fig 6).  One seed gives
the same rows, latencies and records in both packages.  ``drive`` on a
fleet ``Cluster`` runs the port's ``fleet.driver.drive_cluster``, on the
event engine only, as in the JAX package.  One part stays out: the
deprecated shims ``run_open_loop`` and ``run_mixed_open_loop``.  Their
counterpart is ``drive(runtime, LoadSpec.single(fn, rate))``, or a
``LoadSpec`` over a weighted mix, and the ``deprecated-shim`` lint rule
allows them in the JAX package only.  ``SIM_CHECK`` is wired as in the
JAX package: while it is on (the port's ``analysis.sanitizer`` sets it),
the fused admits of the event engine and of the fleet driver assert
their preconditions.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import (Callable, Dict, List, Mapping, Optional, Protocol,
                    Sequence, Tuple)

import numpy as np

from repro_torch.core.faas import (FaasdRuntime, FunctionSpec, InvocationPlan,
                             InvocationRecord)
from repro_torch.core.simulator import EventLoop, Simulator


def percentile(xs: Sequence[float], p: float) -> float:
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(xs), p))


@dataclasses.dataclass
class LatencySummary:
    n: int
    median_ms: float
    p99_ms: float
    mean_ms: float
    p999_ms: float

    @staticmethod
    def of(latencies_ms: Sequence[float]) -> "LatencySummary":
        # one array conversion + one percentile call for all three
        # quantiles: the knee search summarises every probe, so a
        # per-quantile sort compounds with the driver's cost
        a = np.asarray(latencies_ms, dtype=np.float64)
        if a.size == 0:
            nan = float("nan")
            return LatencySummary(0, nan, nan, nan, nan)
        med, p99, p999 = np.percentile(a, (50.0, 99.0, 99.9))
        return LatencySummary(n=int(a.size), median_ms=float(med),
                              p99_ms=float(p99), mean_ms=float(a.mean()),
                              p999_ms=float(p999))


def run_sequential(runtime: FaasdRuntime, fn_name: str, n: int = 100,
                   think_time_s: float = 0.0) -> LatencySummary:
    """Fig 5 methodology: n *sequential* invocations (closed loop)."""
    sim = runtime.sim

    def client():
        for _ in range(n):
            yield from runtime.invoke(fn_name)
            if think_time_s:
                yield sim.timeout(think_time_s)

    start = len(runtime.records)
    p = sim.process(client())
    p.completion.callbacks.append(lambda _v: sim.stop())
    sim.run()
    assert p.done, "sequential client did not finish"
    return LatencySummary.of([r.e2e * 1e3 for r in runtime.records[start:]])


def _completion_rps(done, t_start: float, t_min_end: float) -> float:
    """Completions per second of *busy* time (first window instant to the
    last completion): under overload this approximates the service
    capacity no matter how the observation window truncates the backlog,
    where the drain-inclusive achieved rate over-counts (everything
    eventually completes) and the loaded-window rate under-counts (the
    queue delays every completion past the window).  The knee search's
    bracketing signal."""
    if not done:
        return 0.0
    span = max(1e-9, max(max(r.t_done for r in done), t_min_end) - t_start)
    return len(done) / span


# ---------------------------------------------------------------------------
# Arrival processes.
#
# Each process turns an RNG into a sorted array of absolute arrival times in
# [0, duration_s).  Times are materialised up front (not sampled inside sim
# processes) so a stream is a pure function of (process params, rng state):
# fixed seed -> identical stream, which the determinism tests pin down.


class ArrivalProcess:
    """Base: a recipe for an arrival-time stream."""

    def times(self, rng: np.random.Generator, duration_s: float) -> np.ndarray:
        raise NotImplementedError

    def mean_rps(self) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless open-loop arrivals (the paper's Fig 6 methodology)."""
    rate_rps: float

    def times(self, rng, duration_s):
        if self.rate_rps <= 0 or duration_s <= 0:
            return np.empty(0)
        # draw in blocks: cheaper than a python loop at 10k+ rps
        out: List[np.ndarray] = []
        t, expect = 0.0, max(16, int(self.rate_rps * duration_s * 1.2))
        while t < duration_s:
            gaps = rng.exponential(1.0 / self.rate_rps, size=expect)
            ts = t + np.cumsum(gaps)
            out.append(ts)
            t = float(ts[-1])
        all_ts = np.concatenate(out)
        return all_ts[all_ts < duration_s]

    def mean_rps(self):
        return self.rate_rps


@dataclasses.dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """Two-state Markov-modulated Poisson process: quiet periods at
    ``base_rps`` punctuated by bursts at ``burst_rps`` (FaaSNet-style
    bursty multi-function provisioning traffic)."""
    base_rps: float
    burst_rps: float
    mean_quiet_s: float = 0.20
    mean_burst_s: float = 0.05
    start_in_burst: bool = False

    def times(self, rng, duration_s):
        out: List[float] = []
        t, burst = 0.0, self.start_in_burst
        seg_end = float(rng.exponential(
            self.mean_burst_s if burst else self.mean_quiet_s))
        while t < duration_s:
            rate = self.burst_rps if burst else self.base_rps
            gap = float(rng.exponential(1.0 / rate)) if rate > 0 else math.inf
            if t + gap < seg_end:
                t += gap
                if t < duration_s:
                    out.append(t)
            else:
                # exponential dwell is memoryless: restarting the gap at the
                # segment boundary keeps each segment piecewise-Poisson
                t = seg_end
                burst = not burst
                seg_end = t + float(rng.exponential(
                    self.mean_burst_s if burst else self.mean_quiet_s))
        return np.asarray(out)

    def mean_rps(self):
        tot = self.mean_quiet_s + self.mean_burst_s
        return (self.base_rps * self.mean_quiet_s
                + self.burst_rps * self.mean_burst_s) / tot


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Sinusoidally-modulated Poisson (diurnal load drift compressed to
    sim time), sampled by Lewis-Shedler thinning against the peak rate."""
    mean_rate_rps: float
    amplitude: float = 0.8          # fraction of the mean, in [0, 1]
    period_s: float = 1.0
    phase: float = -math.pi / 2     # start at the trough

    def rate_at(self, t: float) -> float:
        return self.mean_rate_rps * (1.0 + self.amplitude
                                     * math.sin(2 * math.pi * t / self.period_s
                                                + self.phase))

    def times(self, rng, duration_s):
        peak = self.mean_rate_rps * (1.0 + self.amplitude)
        if peak <= 0 or duration_s <= 0:
            return np.empty(0)
        out: List[float] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / peak))
            if t >= duration_s:
                break
            if rng.random() * peak < self.rate_at(t):
                out.append(t)
        return np.asarray(out)

    def mean_rps(self):
        return self.mean_rate_rps   # the sinusoid integrates to zero


@dataclasses.dataclass(frozen=True)
class TraceReplay(ArrivalProcess):
    """Replays a recorded (or synthesised) timestamp trace, optionally
    time-compressed; arrivals beyond duration_s are dropped."""
    trace_s: Sequence[float]
    time_scale: float = 1.0

    def times(self, rng, duration_s):
        ts = np.sort(np.asarray(self.trace_s, dtype=np.float64)) * self.time_scale
        return ts[(ts >= 0) & (ts < duration_s)]

    def mean_rps(self):
        ts = np.asarray(self.trace_s, dtype=np.float64) * self.time_scale
        span = float(ts.max() - ts.min()) if len(ts) > 1 else 1.0
        return len(ts) / max(span, 1e-9)


class _ParetoWork:
    """Truncated-Pareto work sampler; callable per invocation (the
    generator path draws one variate per request) and batchable via
    :meth:`sample` (the event-heap driver draws whole runs at once)."""

    __slots__ = ("rng", "xm", "alpha", "cap")

    def __init__(self, rng: np.random.Generator, xm: float, alpha: float,
                 cap: float):
        self.rng = rng
        self.xm = xm
        self.alpha = alpha
        self.cap = cap

    def __call__(self) -> float:
        u = 1.0 - self.rng.random()     # u in (0, 1]
        return float(min(self.xm * u ** (-1.0 / self.alpha), self.cap))

    def sample(self, n: int) -> np.ndarray:
        u = 1.0 - self.rng.random(n)
        return np.minimum(self.xm * u ** (-1.0 / self.alpha), self.cap)


def heavy_tailed_work(rng: np.random.Generator, median_us: float,
                      alpha: float = 1.6,
                      cap_mult: float = 200.0) -> Callable[[], float]:
    """Pareto per-invocation CPU work (heavy-tailed payload sizes): returns
    a sampler usable as ``FunctionSpec.work_us``.  ``median_us`` pins the
    distribution median; ``cap_mult`` truncates the tail so a single
    invocation cannot exceed median*cap_mult.  The sampler also exposes
    ``.sample(n)`` so batch drivers draw a run's worth of work at once."""
    xm = median_us / (2.0 ** (1.0 / alpha))
    return _ParetoWork(rng, xm, alpha, median_us * cap_mult)


# ---------------------------------------------------------------------------
# The open-loop driver: drive(runtime, LoadSpec, observer).
#
# One entry point for every open loop: a LoadSpec names the arrival process and function mix, a
# SimObserver taps per-request admission/completion (autoscalers, knee
# feedback, tracers), and the engine choice picks between the event-heap
# fast path (default; ~5 station holds + 1 off-path job per request on
# flat callbacks) and the generator reference path that walks the full
# 14-segment invocation chain.  Both produce the same result schema from
# the same record stream, so they are same-seed comparable.


class SimObserver(Protocol):
    """Per-request taps on an open-loop run.  Both fire only for
    *admitted* requests (rejected arrivals reach neither); ``on_done``
    fires at response completion, in completion order."""

    def on_arrival(self, fn_name: str) -> None: ...

    def on_done(self, fn_name: str) -> None: ...


class NullObserver:
    """Default observer; ``drive`` recognises it and skips dispatch
    entirely, so unobserved runs pay nothing on the hot path."""

    __slots__ = ()

    def on_arrival(self, fn_name: str) -> None:
        pass

    def on_done(self, fn_name: str) -> None:
        pass


_NULL_OBSERVER = NullObserver()


def _check_chain_acyclic(chains: Mapping[str, Tuple["ChainEdge", ...]]):
    """Reject cyclic chain graphs at LoadSpec construction: a cycle
    would expand an arrival into an unbounded hop tree."""
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}

    def visit(fn: str, path: Tuple[str, ...]):
        color[fn] = GREY
        for e in chains.get(fn, ()):
            c = color.get(e.target, WHITE)
            if c == GREY:
                raise ValueError(
                    f"chain cycle: {' -> '.join(path + (e.target,))}")
            if c == WHITE:
                visit(e.target, path + (e.target,))
        color[fn] = BLACK

    for fn in chains:
        if color.get(fn, WHITE) == WHITE:
            visit(fn, (fn,))


@dataclasses.dataclass(frozen=True)
class ChainEdge:
    """One downstream edge of a function chain/DAG: on completion of the
    caller, ``target`` is invoked with probability ``prob``, its request
    payload scaled by ``payload_scale`` (the caller's transform of the
    data it forwards).  Scales compose multiplicatively along a chain."""

    target: str
    prob: float = 1.0
    payload_scale: float = 1.0

    def __post_init__(self):
        if not self.target:
            raise ValueError("ChainEdge needs a target function name")
        if not 0.0 < self.prob <= 1.0:
            raise ValueError(f"ChainEdge prob must be in (0, 1], "
                             f"got {self.prob}")
        if self.payload_scale <= 0.0:
            raise ValueError(f"ChainEdge payload_scale must be positive, "
                             f"got {self.payload_scale}")


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """Platform-side fusion pass (Provuse-style): ``edges`` names the
    (caller, callee) chain edges to co-locate in the caller's sandbox —
    a fused hop skips the gateway and netstack entirely and runs as an
    appended exec inside the caller's request.  ``backends`` restricts
    the pass to the named backends (``None`` fuses everywhere), so one
    scenario can fuse on containerd-class backends while leaving a
    kernel-bypass backend unfused for comparison."""

    edges: Tuple[Tuple[str, str], ...] = ()
    backends: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        norm = []
        for e in self.edges:
            caller, callee = e
            if not caller or not callee:
                raise ValueError(f"FusionPlan edge needs non-empty caller "
                                 f"and callee, got {e!r}")
            pair = (str(caller), str(callee))
            if pair not in norm:
                norm.append(pair)
        object.__setattr__(self, "edges", tuple(norm))
        if self.backends is not None:
            object.__setattr__(self, "backends",
                               tuple(str(b) for b in self.backends))
        object.__setattr__(self, "_edge_set", frozenset(self.edges))

    def fuses(self, caller: str, callee: str) -> bool:
        return (caller, callee) in self._edge_set

    def applies_to(self, backend: str) -> bool:
        return self.backends is None or backend in self.backends


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """What to offer a runtime: an arrival process over a weighted
    function mix, plus the observation window.

    ``warmup_s`` (absolute) overrides ``warmup_frac`` when set — latency
    statistics and the completed-fraction denominator only count
    requests arriving after the warmup boundary, though every admitted
    request still runs (and reaches the observer).

    ``chains`` maps a function name to its downstream
    :class:`ChainEdge`\\ s: each admitted arrival of that function
    expands into its chain of hops, every non-fused hop re-entering
    admission as a request of its own.  ``fusion`` optionally co-locates
    selected edges (see :class:`FusionPlan`); it requires ``chains``."""

    arrivals: ArrivalProcess
    functions: Tuple[str, ...]
    weights: Optional[Tuple[float, ...]] = None
    duration_s: float = 2.0
    warmup_frac: float = 0.2
    warmup_s: Optional[float] = None
    max_outstanding: int = 20000
    drain_s: float = 2.0
    chains: Optional[Mapping[str, Tuple[ChainEdge, ...]]] = None
    fusion: Optional[FusionPlan] = None

    def __post_init__(self):
        object.__setattr__(self, "functions", tuple(self.functions))
        if not self.functions:
            raise ValueError("LoadSpec needs at least one function")
        if self.weights is not None:
            w = tuple(float(x) for x in self.weights)
            if len(w) != len(self.functions):
                raise ValueError(
                    f"{len(w)} weights for {len(self.functions)} functions")
            if any(x < 0.0 for x in w):
                raise ValueError(f"LoadSpec weights must be non-negative, "
                                 f"got {w}")
            if sum(w) <= 0.0:
                raise ValueError("LoadSpec weights must have a positive sum "
                                 "(all-zero weights cannot be normalized)")
            object.__setattr__(self, "weights", w)
        if self.duration_s <= 0.0:
            raise ValueError(f"duration_s must be positive, "
                             f"got {self.duration_s}")
        if not 0.0 <= self.warmup_frac < 1.0:
            raise ValueError(
                f"warmup_frac must be in [0, 1) — a warmup covering the "
                f"whole run leaves an empty observation window; "
                f"got {self.warmup_frac}")
        if self.warmup_s is not None and not \
                0.0 <= self.warmup_s < self.duration_s:
            raise ValueError(
                f"warmup_s must be in [0, duration_s) — warmup "
                f"{self.warmup_s}s leaves no observation window in a "
                f"{self.duration_s}s run")
        if self.chains is not None:
            chains = {str(k): tuple(v) for k, v in dict(self.chains).items()}
            for fn, edges in chains.items():
                for e in edges:
                    if not isinstance(e, ChainEdge):
                        raise ValueError(f"chains[{fn!r}] must hold "
                                         f"ChainEdge instances, got {e!r}")
            _check_chain_acyclic(chains)
            object.__setattr__(self, "chains", chains)
        if self.fusion is not None and self.chains is None:
            raise ValueError("LoadSpec fusion requires chains")

    @classmethod
    def single(cls, fn_name: str, rate_rps: float, **kw) -> "LoadSpec":
        """Poisson arrivals over one function (the Fig 6 shape)."""
        return cls(arrivals=PoissonArrivals(rate_rps), functions=(fn_name,),
                   **kw)

    @property
    def effective_warmup_s(self) -> float:
        return (self.warmup_s if self.warmup_s is not None
                else self.warmup_frac * self.duration_s)

    def normalized_weights(self) -> np.ndarray:
        if self.weights is None:
            k = len(self.functions)
            return np.full(k, 1.0 / k)
        w = np.asarray(self.weights, dtype=np.float64)
        return w / w.sum()


def _load_function_names(load: LoadSpec) -> Tuple[str, ...]:
    """Every function a load can invoke: the mix itself plus any chain
    targets reachable through its edges."""
    names = list(load.functions)
    seen = set(names)
    if load.chains:
        for fn, edges in load.chains.items():
            for nm in (fn,) + tuple(e.target for e in edges):
                if nm not in seen:
                    seen.add(nm)
                    names.append(nm)
    return tuple(names)


def _fast_capable(runtime: FaasdRuntime, load: LoadSpec) -> bool:
    """The event engine compiles the warm cached-resolve chain; a run
    that would take the provider's backend-query path (cache disabled or
    not yet populated) must use the generator engine, which models it."""
    if not getattr(runtime, "provider_cache", False):
        return False
    cache = getattr(runtime, "_cache", None)
    return cache is not None and all(fn in cache
                                     for fn in _load_function_names(load))


class _ChainTable:
    """Expanded request table for one chained run: rows 0..n_roots-1 are
    the admitted arrival stream's roots (in arrival order); hop rows are
    appended in DFS order.  ``children[i]`` lists the rows spawned when
    row ``i`` completes; ``members[i]`` lists the ``(fn_index,
    payload_scale)`` of chain callees fused *into* row ``i``'s sandbox
    (they add exec cost to the row instead of becoming rows)."""

    __slots__ = ("fn_names", "fidx", "scale", "depth", "root", "children",
                 "members", "n_roots")

    def __init__(self, fn_names, fidx, scale, depth, root, children,
                 members, n_roots):
        self.fn_names = fn_names
        self.fidx = fidx
        self.scale = scale
        self.depth = depth
        self.root = root
        self.children = children
        self.members = members
        self.n_roots = n_roots

    def fused_names(self, row: int) -> Tuple[str, ...]:
        return tuple(self.fn_names[f] for f, _s in self.members[row])


def _expand_chains(load: LoadSpec, picks, rng,
                   backend: str) -> Optional[_ChainTable]:
    """Expand the root arrival stream into its chain-hop request table.

    Returns ``None`` (consuming no rng state) when the load has no
    chains.  Trigger draws — one ``rng.random()`` per sub-unit-prob edge,
    in DFS order — are independent of the fusion plan, so a fused and an
    unfused run of the same seed expand the identical hop tree and stay
    row-for-row comparable."""
    chains = load.chains
    if not chains:
        return None
    fusion = load.fusion
    fuse = fusion is not None and fusion.applies_to(backend)
    names: List[str] = list(load.functions)
    index = {nm: i for i, nm in enumerate(names)}

    def fidx_of(nm: str) -> int:
        i = index.get(nm)
        if i is None:
            index[nm] = i = len(names)
            names.append(nm)
        return i

    picksL = picks.tolist() if hasattr(picks, "tolist") else list(picks)
    n = len(picksL)
    fidx = [int(p) for p in picksL]
    scale = [1.0] * n
    depth = [0] * n
    root = list(range(n))
    children: List[List[int]] = [[] for _ in range(n)]
    members: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    rand = rng.random

    def walk(host: int, fn: str, sc: float, dp: int, r: int):
        for e in chains.get(fn, ()):
            if e.prob < 1.0 and rand() >= e.prob:
                continue
            cs = sc * e.payload_scale
            if fuse and fusion.fuses(fn, e.target):
                members[host].append((fidx_of(e.target), cs))
                walk(host, e.target, cs, dp + 1, r)
            else:
                c = len(fidx)
                fidx.append(fidx_of(e.target))
                scale.append(cs)
                depth.append(dp + 1)
                root.append(r)
                children.append([])
                members.append([])
                children[host].append(c)
                walk(c, e.target, cs, dp + 1, r)

    for i in range(n):
        walk(i, load.functions[fidx[i]], 1.0, 0, i)
    return _ChainTable(tuple(names), fidx, scale, depth, root, children,
                       members, n)


def _chain_result(table: _ChainTable, AT, done_t, EX, t_warm: float,
                  rejected_hops: int) -> Dict[str, object]:
    """Per-chain/per-hop breakdown (artifact schema v6 ``chain`` block).

    Root end-to-end latency spans the root's arrival to the last
    completion in its subtree; only past-warmup roots whose *entire*
    expanded subtree completed count.  ``hops`` rows break latency and
    the per-hop platform tax (latency minus the exec span — gateway +
    netstack + queueing) down by hop depth; hop 0 is the root itself."""
    dt = np.asarray(done_t)
    root_ids = np.asarray(table.root)
    depth = np.asarray(table.depth)
    nr = table.n_roots
    comp = dt > 0.0
    exp_cnt = np.bincount(root_ids, minlength=nr)
    comp_cnt = np.bincount(root_ids[comp], minlength=nr)
    maxd = np.zeros(nr)
    if comp.any():
        np.maximum.at(maxd, root_ids[comp], dt[comp])
    root_at = np.asarray(AT)[:nr]
    full = (comp_cnt == exp_cnt) & comp[:nr] & (root_at >= t_warm)
    root_lat = (maxd[full] - root_at[full]) * 1e3
    s = LatencySummary.of(root_lat)
    warm_row = comp & (np.asarray(AT) >= t_warm)
    hops = []
    tax_wsum = 0.0
    tax_n = 0
    for d in range(int(depth.max()) + 1 if len(depth) else 1):
        m = warm_row & (depth == d)
        nd = int(np.count_nonzero(m))
        if nd == 0:
            continue
        hop_lat = (dt[m] - np.asarray(AT)[m]) * 1e3
        hs = LatencySummary.of(hop_lat)
        tax = float(np.mean(hop_lat - EX[m] * 1e3))
        tax_wsum += tax * nd
        tax_n += nd
        hops.append({"hop": d, "n": nd,
                     "median_ms": round(hs.median_ms, 6),
                     "p99_ms": round(hs.p99_ms, 6),
                     "mean_ms": round(hs.mean_ms, 6),
                     "tax_mean_ms": round(tax, 6)})
    return {
        "n_roots": int(nr),
        "roots_completed": int(np.count_nonzero(full)),
        "root_median_ms": s.median_ms,
        "root_p99_ms": s.p99_ms,
        "root_mean_ms": s.mean_ms,
        "hops": hops,
        "hop_tax_mean_ms": (tax_wsum / tax_n) if tax_n else float("nan"),
        "fused_members": int(sum(len(m) for m in table.members)),
        "rejected_hops": int(rejected_hops),
    }


def drive(runtime: FaasdRuntime, load: LoadSpec,
          observer: Optional[SimObserver] = None,
          engine: str = "events") -> Dict[str, object]:
    """Run ``load`` against ``runtime`` as an open loop; returns the
    result row (rates, completed fraction, latency summary, per-function
    summaries, raw latencies).

    ``engine="events"`` (default) executes hop-compressed invocations on
    the flat event heap — order-of-magnitude faster, statistically
    equivalent; ``engine="process"`` walks the full generator chain (the
    reference semantics).  Runs that the fast engine cannot represent
    (uncached endpoint resolution) fall back to the process engine
    automatically."""
    if engine not in ("events", "process"):
        raise ValueError(f"unknown engine {engine!r}")
    for fn in _load_function_names(load):
        if fn not in runtime.functions:
            raise KeyError(f"function {fn!r} not deployed")
    obs = observer if observer is not None else _NULL_OBSERVER
    if getattr(runtime, "is_cluster", False):
        # a fleet Cluster quacks like a runtime but routes per-arrival
        # through its gateway; only the event engine drives fleets
        if engine != "events":
            raise ValueError("a Cluster only runs on the event engine")
        from repro_torch.fleet.driver import drive_cluster
        return drive_cluster(runtime, load, obs)
    if engine == "events" and not _fast_capable(runtime, load):
        engine = "process"
    if engine == "events":
        return _drive_events(runtime, load, obs)
    return _drive_process(runtime, load, obs)


def _assemble(runtime: FaasdRuntime, start_idx: int,
              fn_names: Sequence[str], t0: float, duration_s: float,
              warmup_s: float, drain_s: float, admitted: int,
              rejected0: int, offered_rps: float) -> Dict[str, object]:
    """Result row shared by both engines, from the run's record slice."""
    recs = [r for r in runtime.records[start_idx:]
            if r.t_arrival >= t0 + warmup_s]
    done = [r for r in recs if r.t_done <= t0 + duration_s + drain_s]
    lat = [r.e2e * 1e3 for r in recs]
    summary = LatencySummary.of(lat)
    per_fn: Dict[str, LatencySummary] = {}
    for name in fn_names:
        fn_lat = [r.e2e * 1e3 for r in recs if r.fn == name]
        if fn_lat:
            per_fn[name] = LatencySummary.of(fn_lat)
    return {
        "offered_rps": offered_rps,
        "achieved_rps": len(done) / max(1e-9, duration_s - warmup_s),
        "completion_rps": _completion_rps(done, t0 + warmup_s,
                                          t0 + duration_s),
        "completed_frac": len(done) / max(1, admitted),
        "median_ms": summary.median_ms,
        "p99_ms": summary.p99_ms,
        "mean_ms": summary.mean_ms,
        "p999_ms": summary.p999_ms,
        "n": summary.n,
        "rejected": runtime.rejected - rejected0,
        "per_fn": per_fn,
        "latencies_ms": lat,
    }


def _drive_process(runtime: FaasdRuntime, load: LoadSpec,
                   obs: SimObserver) -> Dict[str, object]:
    """Reference engine: every request walks the full generator chain."""
    sim = runtime.sim
    fn_names = load.functions
    duration_s = load.duration_s
    warmup_s = load.effective_warmup_s
    t0 = sim.now
    rel_times = load.arrivals.times(sim.rng, duration_s)
    picks = sim.rng.choice(len(fn_names), size=len(rel_times),
                           p=load.normalized_weights())
    table = _expand_chains(load, picks, sim.rng, runtime.backend_name)
    outstanding = [0]
    admitted = [0]                  # admitted past-warmup arrivals: the
    # completed_frac denominator must count every admitted request, not
    # just the ones that finished (records only exist on completion)
    rejected0 = runtime.rejected    # report this run's delta, not the
    # runtime-lifetime counter: knee-search bracketing reuses one runtime
    # across rates, and a cumulative count would fail rejected==0 forever
    observed = obs is not _NULL_OBSERVER

    if table is None:
        def driver():
            for rel_t, pick in zip(rel_times, picks):
                yield sim.timeout(t0 + float(rel_t) - sim.now)
                if outstanding[0] >= load.max_outstanding:
                    runtime.rejected += 1
                    continue
                outstanding[0] += 1
                if rel_t >= warmup_s:
                    admitted[0] += 1
                if observed:
                    obs.on_arrival(fn_names[pick])

                def one(fn=fn_names[pick]):
                    yield from runtime.invoke(fn)
                    outstanding[0] -= 1
                    if observed:
                        obs.on_done(fn)

                sim.process(one())
    else:
        fn_names = table.fn_names
        t_warm = t0 + warmup_s
        n_rows = len(table.fidx)
        AT = [0.0] * n_rows         # per-row spawn time (chain block)
        done_t = [0.0] * n_rows
        EX = [0.0] * n_rows         # recorded exec span (tax = e2e - EX)
        hop_rejected = [0]

        def one(row):
            fn = fn_names[table.fidx[row]]
            rec = yield from runtime.invoke(
                fn, payload_scale=table.scale[row],
                fused=table.fused_names(row))
            done_t[row] = rec.t_done
            EX[row] = rec.exec_latency
            outstanding[0] -= 1
            if observed:
                obs.on_done(fn)
            # the completed hop triggers its downstream edges: each child
            # re-enters admission as a request of its own
            for c in table.children[row]:
                if outstanding[0] >= load.max_outstanding:
                    runtime.rejected += 1
                    hop_rejected[0] += 1
                    continue
                outstanding[0] += 1
                if sim.now >= t_warm:
                    admitted[0] += 1
                if observed:
                    obs.on_arrival(fn_names[table.fidx[c]])
                AT[c] = sim.now
                sim.process(one(c))

        def driver():
            for row, rel_t in enumerate(rel_times):
                yield sim.timeout(t0 + float(rel_t) - sim.now)
                if outstanding[0] >= load.max_outstanding:
                    runtime.rejected += 1
                    continue
                outstanding[0] += 1
                if rel_t >= warmup_s:
                    admitted[0] += 1
                if observed:
                    obs.on_arrival(fn_names[table.fidx[row]])
                AT[row] = sim.now
                sim.process(one(row))

    start_idx = len(runtime.records)
    sim.process(driver())
    sim.run(until=t0 + duration_s + load.drain_s)
    res = _assemble(runtime, start_idx, fn_names, t0, duration_s, warmup_s,
                    load.drain_s, admitted[0], rejected0,
                    len(rel_times) / max(duration_s, 1e-9))
    if table is not None:
        res["chain"] = _chain_result(table, AT, done_t, np.asarray(EX),
                                     t0 + warmup_s, hop_rejected[0])
    return res


# The event engine's kernel-bypass analog: when a routed pool is
# uncontended at admit time (free cores beyond a one-core reservation
# margin, no waiters), the request's whole 3-station + 2-gap timeline is
# *fused* into one precomputed completion event (plus one off-path core
# release), skipping the per-station machine entirely — the same idea as
# acquire_fast's reservation-across-the-gap, extended to the request.
# Contended admits fall back to the per-station machine, whose thrash
# dynamics are path-dependent.  Tests flip this off to pin fused ==
# unfused accounting on contention-free schedules.
FUSED_FAST_PATH = True

# Runtime sim-sanitizer hook (repro_torch.analysis.sanitizer): when flipped on
# (REPRO_SIM_CHECK=1 or sanitizer.install()), the fused-admit branches
# below assert their preconditions via _fused_admit_check.  Same
# zero-overhead pattern as FUSED_FAST_PATH: drivers hoist the flag to a
# local once per run, so the disabled cost is one boolean read per run.
SIM_CHECK = False


def _fused_admit_check(pool, t, end_t, off_end_t=None):
    """Delegate to the sanitizer's fused-admit assertion (imported
    lazily: only ever called when SIM_CHECK is on)."""
    from repro_torch.analysis.sanitizer import fused_admit_check
    fused_admit_check(pool, t, end_t, off_end_t)


def _sample_request_matrices(runtime_of, fn_names, picks, rng, n):
    """Vectorized per-request cost matrices for one run, sampled once per
    function (the batch is routed afterwards).  Returns
    ``(H, G, OFF, EX, stack_cpu, n_hic)`` where ``stack_cpu``/``n_hic``
    are per-function lists (netstack accounting is the caller's business:
    the single-runtime driver books one stack, the fleet driver books the
    routed worker's)."""
    H = np.empty((n, 3))            # station CPU holds
    G = np.empty((n, 2))            # inter-station latency gaps
    OFF = np.empty(n)               # merged off-path CPU job
    EX = np.empty(n)                # exec-span approximation for records
    stack_cpu = [0.0] * len(fn_names)
    n_hic = [0] * len(fn_names)
    for f, nm in enumerate(fn_names):
        mask = picks == f
        m = int(mask.sum())
        if m == 0:
            continue
        plan = runtime_of(nm).invocation_plan(nm)
        h, g, off, ex, hic = plan.sample(rng, m)
        H[mask] = h
        G[mask] = g
        OFF[mask] = off
        EX[mask] = ex
        stack_cpu[f] = plan.stack_cpu_s
        n_hic[f] = hic
    return H, G, OFF, EX, stack_cpu, n_hic


def _sample_chain_matrices(runtime_of, table: _ChainTable, rng):
    """Vectorized per-row cost matrices for a chained run.  Rows group
    by ``(function, payload_scale)`` — a hop's plan depends on its
    scaled payload — and fused members append their exec-only cost to
    the host row (exec-station CPU, tail hiccup on the egress gap).

    Returns ``(H, G, OFF, EX, SC, n_hic)``: the per-row matrices of
    :func:`_sample_request_matrices` plus ``SC``, the per-row netstack
    CPU (scale-dependent, so per-function constants no longer work),
    and per-function net-hiccup counts.  Fused members book no netstack
    cost at all — they never touch the stack."""
    fn_names = table.fn_names
    picks = np.asarray(table.fidx, dtype=np.intp)
    scales = np.asarray(table.scale, dtype=np.float64)
    N = int(picks.size)
    H = np.empty((N, 3))
    G = np.empty((N, 2))
    OFF = np.empty(N)
    EX = np.empty(N)
    SC = np.empty(N)
    n_hic = [0] * len(fn_names)
    for f, nm in enumerate(fn_names):
        fmask = picks == f
        if not fmask.any():
            continue
        for s in sorted(set(scales[fmask].tolist())):
            m2 = fmask & (scales == s)
            m = int(m2.sum())
            plan = runtime_of(nm).invocation_plan(nm, payload_scale=s)
            h, g, off, ex, hic = plan.sample(rng, m)
            H[m2] = h
            G[m2] = g
            OFF[m2] = off
            EX[m2] = ex
            SC[m2] = plan.stack_cpu_s
            n_hic[f] += hic
    by_f: Dict[int, List[int]] = {}
    for host, ms in enumerate(table.members):
        for fm, _s in ms:
            by_f.setdefault(fm, []).append(host)
    for fm in sorted(by_f):
        hosts = by_f[fm]
        nm = fn_names[fm]
        plan = runtime_of(nm).invocation_plan(nm)
        cpu, hic = plan.sample_exec(rng, len(hosts))
        for j, host in enumerate(hosts):
            H[host, 1] += cpu[j]
            G[host, 1] += hic[j]
            EX[host] += cpu[j] + hic[j]
    return H, G, OFF, EX, SC, n_hic


def _fused_arrays(AT, H, G, OFF, EX):
    """Precomputed absolute timelines for the fused fast path, as flat
    Python lists (structure-of-arrays: one ``.tolist()`` per column beats
    per-request tuple/list allocation by a wide margin).

    Returns ``(END, OFFEND, CPU, EXS, EXE)``: uncontended completion
    time, off-path job end, total CPU charged per request, and the
    recorded exec span's start/end — all identical to what the
    per-station machine produces on an uncontended walk (thrash 1.0,
    every gap reservation granted)."""
    h0 = H[:, 0]
    span = H.sum(axis=1) + G.sum(axis=1)
    exs = AT + h0 + G[:, 0]
    return ((AT + span).tolist(), (AT + h0 + OFF).tolist(),
            (H.sum(axis=1) + OFF).tolist(), exs.tolist(),
            (exs + EX).tolist())


def _append_records(records, fn_names, picksL, ATL, ex_start, EX, done_t):
    """Materialise :class:`InvocationRecord`\\ s for every completed
    request, in completion order, after the event loop has drained —
    the hot loop only writes ``done_t``/``ex_start`` floats."""
    dt = np.asarray(done_t)
    idx = np.flatnonzero(dt > 0.0)
    if not idx.size:
        return
    idx = idx[np.argsort(dt[idx], kind="stable")]
    ex_end = (np.asarray(ex_start) + EX).tolist()
    rec = InvocationRecord
    append = records.append
    for i in idx.tolist():
        append(rec(fn_names[picksL[i]], ATL[i], ex_start[i], ex_end[i],
                   done_t[i]))


def _events_result(fn_names, picks, AT, done_t, t0, duration_s, warmup_s,
                   drain_s, admitted, rejected, offered_rps):
    """Vectorized result row for the event engines (same schema as
    :func:`_assemble`, computed from the driver's flat arrays instead of
    per-record Python loops)."""
    dt = np.asarray(done_t)
    m = (dt > 0.0) & (AT >= t0 + warmup_s)      # completed, past warmup
    lat = (dt[m] - AT[m]) * 1e3
    dmask = m & (dt <= t0 + duration_s + drain_s)
    n_done = int(np.count_nonzero(dmask))
    summary = LatencySummary.of(lat)
    per_fn: Dict[str, LatencySummary] = {}
    pm = picks[m]
    for f, name in enumerate(fn_names):
        fn_lat = lat[pm == f]
        if fn_lat.size:
            per_fn[name] = LatencySummary.of(fn_lat)
    t_start = t0 + warmup_s
    if n_done:
        span = max(1e-9, max(float(dt[dmask].max()), t0 + duration_s)
                   - t_start)
        completion_rps = n_done / span
    else:
        completion_rps = 0.0
    return {
        "offered_rps": offered_rps,
        "achieved_rps": n_done / max(1e-9, duration_s - warmup_s),
        "completion_rps": completion_rps,
        "completed_frac": n_done / max(1, admitted),
        "median_ms": summary.median_ms,
        "p99_ms": summary.p99_ms,
        "mean_ms": summary.mean_ms,
        "p999_ms": summary.p999_ms,
        "n": summary.n,
        "rejected": rejected,
        "per_fn": per_fn,
        "latencies_ms": lat.tolist(),
    }


def _drive_events(runtime: FaasdRuntime, load: LoadSpec,
                  obs: SimObserver) -> Dict[str, object]:
    """Fast engine: hop-compressed invocations on the flat event heap.

    All per-request randomness is drawn up front in vectorized batches
    (arrival times from the process, then per function: app jitter, work,
    overhead, hiccups, net jitter — see ``InvocationPlan.sample``); the
    event loop then runs pure float arithmetic over plain callbacks.
    Generator processes already on the simulator (autoscaler operations,
    the Junction scheduler poll loop, provisioning storms) interleave
    through the shared heap and contend for the same core pool.

    Requests admitted into an uncontended pool take the *fused* path:
    the whole station timeline collapses to one precomputed completion
    event (see ``FUSED_FAST_PATH`` above) — ~1-2 heap events per request
    instead of ~4 — while contended admits walk the per-station machine
    below, unchanged."""
    sim = runtime.sim
    fn_names = load.functions
    duration_s = load.duration_s
    warmup_s = load.effective_warmup_s
    drain_s = load.drain_s
    max_out = load.max_outstanding
    t0 = sim.now
    rel = load.arrivals.times(sim.rng, duration_s)
    n = len(rel)
    if len(fn_names) > 1 or load.chains is not None:
        # chained runs always draw picks so the trigger-draw stream
        # that follows stays aligned with the process engine's
        picks = sim.rng.choice(len(fn_names), size=n,
                               p=load.normalized_weights())
    else:
        picks = np.zeros(n, dtype=np.intp)
    table = _expand_chains(load, picks, sim.rng, runtime.backend_name)

    AT = t0 + rel
    stack = runtime.stack
    if table is None:
        N = n
        H, G, OFF, EX, stack_cpu, n_hic = _sample_request_matrices(
            lambda _nm: runtime, fn_names, picks, sim.rng, n)
        for f in range(len(fn_names)):
            m = int((picks == f).sum()) if len(fn_names) > 1 else n
            # netstack accounting the per-request path would have done
            stack.messages += 4 * m
            stack.cpu_spent += m * stack_cpu[f]
            stack.hiccups += n_hic[f]
    else:
        fn_names = table.fn_names
        picks = np.asarray(table.fidx, dtype=np.intp)
        N = int(picks.size)
        H, G, OFF, EX, SC, n_hic = _sample_chain_matrices(
            lambda _nm: runtime, table, sim.rng)
        # every table row (root or hop) is one request on this stack;
        # fused members contribute nothing (SC covers rows only)
        stack.messages += 4 * N
        stack.cpu_spent += float(SC.sum())
        stack.hiccups += sum(n_hic)

    # flat structure-of-arrays buffers: one list per column (station
    # holds indexed 3*i+k, gaps 2*i+k) — Python float access without the
    # per-request inner lists the old H.tolist() materialised
    H3 = H.ravel().tolist()
    G2 = G.ravel().tolist()
    OFFL = OFF.tolist()
    picksL = picks.tolist()
    if table is None:
        ATL = AT.tolist()
        rootATL = ATL
        ENDL, OFFENDL, CPUL, EXSL, EXEL = _fused_arrays(AT, H, G, OFF, EX)
        # exec-span start: fused requests keep the precomputed
        # uncontended value; the station machine overwrites it with the
        # actual exec grant
        ex_start = list(EXSL)
    else:
        # a hop's arrival time is only known when its parent completes:
        # keep the fused timeline *relative* and let _enter stamp the
        # absolute values at spawn
        rootATL = AT.tolist()
        ATL = [0.0] * N
        SPANL = (H.sum(axis=1) + G.sum(axis=1)).tolist()
        OFFRELL = (H[:, 0] + OFF).tolist()
        H0G0L = (H[:, 0] + G[:, 0]).tolist()
        ENDL = [0.0] * N
        OFFENDL = [0.0] * N
        ex_start = [0.0] * N
    done_t = [0.0] * N              # completion time; 0.0 = not completed

    # The station machine below inlines CorePool.acquire_fast /
    # release_fast field-for-field (busy/_waiters/_queued_weight stay
    # consistent, and queued grants drain through pool._grant_next either
    # way) — each spared function call is a measurable slice of the wall
    # time.  busy_time/served/cache_hits/rejected are pure end-of-run
    # accounting (nothing reads them mid-run), so they accumulate in
    # locals and flush once after the loop.  Two consequences of the
    # pool's invariants are exploited: an immediate grant requires an
    # empty waiter queue, where backlog == 0 and the thrash multiplier
    # is exactly 1.0; only grants popped off the waiter queue (by
    # _granted/_off_granted below) see a non-trivial backlog.
    pool = runtime.cores
    waiters = pool._waiters
    grant_next = pool._grant_next
    off_pend = pool._off_pend
    materialize = pool._materialize
    hpush = heapq.heappush
    hpop = heapq.heappop
    t_coeff = runtime.runtime.thrash_coeff
    t_cap = runtime.runtime.thrash_cap
    heap = sim._heap
    push = heapq.heappush
    counter = sim._counter
    records = runtime.records
    off_weight = InvocationPlan.OFFPATH_BACKLOG_WEIGHT
    st_weight = InvocationPlan.STATION_BACKLOG_WEIGHT
    observed = obs is not _NULL_OBSERVER
    fuse = FUSED_FAST_PATH
    check = SIM_CHECK
    t_warm = t0 + warmup_s
    outstanding = 0
    busy_time = 0.0
    served = 0
    rejected = 0
    rejected_warm = 0
    entered = 0                     # chained runs: rows that arrived
    entered_warm = 0
    hop_rejected = 0
    CHILD = table.children if table is not None else None
    fused = bytearray(N)            # fused admits; accounted post-loop

    def _admit(i, t):
        # per-request totals that nothing reads mid-run (cache_hits,
        # post-warmup admits, fused busy_time/served) are derived after
        # the loop from the arrival count and the fused bitmap — the
        # admit path only touches admission state
        nonlocal outstanding, rejected, rejected_warm
        if outstanding >= max_out:
            rejected += 1
            if t >= t_warm:
                rejected_warm += 1
            return
        outstanding += 1
        if observed:
            obs.on_arrival(fn_names[picksL[i]])
        while off_pend and off_pend[0] <= t:   # expired lazy releases
            hpop(off_pend)
            pool.busy -= 1
        b = pool.busy
        if not waiters:
            if fuse:
                # fused fast path: the whole timeline is precomputed
                # (thrash 1.0 throughout); holds the on-path core to
                # completion and the off-path core to the off job's end
                # (released lazily, no heap event), always leaving one
                # spare core unreserved
                off = OFFL[i]
                if off > 0.0:
                    if b + 2 < pool.n_cores:
                        if check:
                            _fused_admit_check(pool, t, ENDL[i],
                                               OFFENDL[i])
                        pool.busy = b + 2
                        fused[i] = 1
                        push(heap, (ENDL[i], next(counter),
                                    _fused_done, (i,)))
                        hpush(off_pend, OFFENDL[i])
                        return
                elif b + 1 < pool.n_cores:
                    if check:
                        _fused_admit_check(pool, t, ENDL[i])
                    pool.busy = b + 1
                    fused[i] = 1
                    push(heap, (ENDL[i], next(counter), _fused_done, (i,)))
                    return
            if b < pool.n_cores:
                pool.busy = b + 1
                eff = H3[3 * i]     # empty queue -> thrash == 1.0
                push(heap, (t + eff, next(counter), _complete,
                            (i, 0, eff, t)))
                return
        if off_pend:
            materialize()
        waiters.append((t, _granted, (i, 0), st_weight))
        pool._queued_weight += st_weight - 1

    def _fused_done(i):
        # one event for the whole request: release the on-path core and
        # finish (records and busy_time/served accounting are
        # materialised after the loop, off the hot path — done_t is the
        # only per-completion state)
        nonlocal outstanding
        pool.busy -= 1
        if waiters:
            grant_next()
        outstanding -= 1
        end = ENDL[i]
        done_t[i] = end
        if observed:
            obs.on_done(fn_names[picksL[i]])
        if CHILD is not None:
            for c in CHILD[i]:
                _enter(c, end)

    def _complete(i, k, eff, start):
        # release the station's core (event time is always start + eff)
        nonlocal busy_time, served
        pool.busy -= 1
        busy_time += eff
        served += 1
        if waiters:
            grant_next()
        now = start + eff
        if k == 2:
            nonlocal outstanding
            outstanding -= 1
            done_t[i] = now
            if observed:
                obs.on_done(fn_names[picksL[i]])
            if CHILD is not None:
                for c in CHILD[i]:
                    _enter(c, now)
            return
        while off_pend and off_pend[0] <= now:  # expired lazy releases
            hpop(off_pend)
            pool.busy -= 1
        if k == 0:
            off = OFFL[i]
            if off > 0.0:           # merged off-path CPU job
                b = pool.busy
                if b < pool.n_cores and not waiters:
                    pool.busy = b + 1
                    push(heap, (now + off, next(counter), _off_done, (off,)))
                else:
                    if off_pend:
                        materialize()
                    waiters.append((now, _off_granted, (off,), off_weight))
                    pool._queued_weight += off_weight - 1
        else:
            # completion of the exec station: its grant time starts the
            # recorded exec span
            ex_start[i] = start
        # acquire the next station's core, available after the net gap
        avail = now + G2[2 * i + k]
        k += 1
        b = pool.busy
        nc = pool.n_cores
        if b < nc and not waiters:
            if b < nc - 1:
                # reserve through the µs-scale gap while the pool keeps a
                # spare core; near saturation fall through to a wakeup
                # event at avail instead (no capacity is held idle)
                pool.busy = b + 1
                eff = H3[3 * i + k]
                push(heap, (avail + eff, next(counter), _complete,
                            (i, k, eff, avail)))
            else:
                push(heap, (avail, next(counter), _retry, (avail, i, k)))
        else:
            if off_pend:
                materialize()
            waiters.append((avail, _granted, (i, k), st_weight))
            pool._queued_weight += st_weight - 1

    def _retry(avail, i, k):
        while off_pend and off_pend[0] <= avail:  # expired lazy releases
            hpop(off_pend)
            pool.busy -= 1
        b = pool.busy
        if b < pool.n_cores and not waiters:
            pool.busy = b + 1
            eff = H3[3 * i + k]     # empty queue -> thrash == 1.0
            push(heap, (avail + eff, next(counter), _complete,
                        (i, k, eff, avail)))
        else:
            if off_pend:
                materialize()
            waiters.append((avail, _granted, (i, k), st_weight))
            pool._queued_weight += st_weight - 1

    def _granted(start, i, k):
        # popped off the waiter queue by a release; the remaining backlog
        # sets this hold's thrash multiplier (as in CorePool.consume)
        th = 1.0 + t_coeff * (len(waiters) + pool._queued_weight) \
            / pool.n_cores
        eff = H3[3 * i + k] * (t_cap if th > t_cap else th)
        push(heap, (start + eff, next(counter), _complete, (i, k, eff, start)))

    def _off_granted(start, off):
        th = 1.0 + t_coeff * (len(waiters) + pool._queued_weight) \
            / pool.n_cores
        eff = off * (t_cap if th > t_cap else th)
        push(heap, (start + eff, next(counter), _off_done, (eff,)))

    def _off_done(eff):
        nonlocal busy_time, served
        pool.busy -= 1
        busy_time += eff
        served += 1
        if waiters:
            grant_next()

    if table is not None:
        DEPTHL = table.depth
        SPANL_ = SPANL
        OFFRELL_ = OFFRELL
        H0G0L_ = H0G0L

        def _enter(i, t):
            # a root arrival or a spawned chain hop: stamp its absolute
            # fused timeline, then take the normal admission path
            nonlocal entered, entered_warm, hop_rejected
            ATL[i] = t
            ENDL[i] = t + SPANL_[i]
            OFFENDL[i] = t + OFFRELL_[i]
            ex_start[i] = t + H0G0L_[i]
            entered += 1
            if t >= t_warm:
                entered_warm += 1
            r0 = rejected
            _admit(i, t)
            if rejected > r0 and DEPTHL[i]:
                hop_rejected += 1

        delivered = EventLoop(sim).run(t0 + duration_s + drain_s,
                                       rootATL, _enter)
    else:
        _enter = None
        delivered = EventLoop(sim).run(t0 + duration_s + drain_s,
                                       ATL, _admit)
    # deferred per-request accounting: every delivered non-rejected
    # arrival is one warm cached resolve; a fused request whose single
    # completion event fired (done_t set — straddlers past the drain
    # horizon never fire, as their unfused stations would not have)
    # contributes its whole precomputed CPU/served total
    fmask = (np.frombuffer(fused, dtype=np.uint8).astype(bool)
             & (np.asarray(done_t) > 0.0))
    pool.busy_time += busy_time + float((H.sum(axis=1) + OFF)[fmask].sum())
    pool.served += served + int(3 * fmask.sum()
                                + np.count_nonzero(fmask & (OFF > 0.0)))
    if table is None:
        runtime.cache_hits += delivered - rejected
        admitted = (int(np.count_nonzero(AT[:delivered] >= t_warm))
                    - rejected_warm)
    else:
        # roots and hops alike: each admitted row did one warm resolve
        runtime.cache_hits += entered - rejected
        admitted = entered_warm - rejected_warm
        AT = np.asarray(ATL)
    runtime.rejected += rejected
    _append_records(records, fn_names, picksL, ATL, ex_start, EX, done_t)
    res = _events_result(fn_names, picks, AT, done_t, t0, duration_s,
                         warmup_s, drain_s, admitted, rejected,
                         n / max(duration_s, 1e-9))
    if table is not None:
        res["chain"] = _chain_result(table, AT, done_t, EX, t_warm,
                                     hop_rejected)
    return res


def _row_rate(row: Dict[str, float], rate_key: str) -> float:
    """A row's offered rate: the nominal grid/search rate when positive,
    else the measured offered rate (trace replay fixes the rate)."""
    return float(row.get(rate_key) or row["offered_rps"])


def _row_meets_slo(row: Dict[str, float], rate: float, slo_p99_ms: float,
                   min_achieved_frac: float) -> bool:
    p99 = float(row["p99_ms"])
    return (math.isfinite(p99) and p99 <= slo_p99_ms
            and row.get("rejected", 0) == 0
            and row["achieved_rps"] >= min_achieved_frac * rate)


def knee_index_of_curve(curve: List[Dict[str, float]], slo_p99_ms: float,
                        min_achieved_frac: float = 0.85,
                        rate_key: str = "nominal_rps") -> Optional[int]:
    """Index of the knee row (highest rate meeting the SLO criteria), or
    ``None`` when no row qualifies.  Callers wanting the knee's latency
    row should use this index instead of re-matching the returned rate by
    float equality — search-generated rates are not grid-aligned."""
    best_idx: Optional[int] = None
    best = 0.0
    for i, r in enumerate(curve):
        rate = _row_rate(r, rate_key)
        if _row_meets_slo(r, rate, slo_p99_ms, min_achieved_frac) \
                and rate >= best:
            best, best_idx = rate, i
    return best_idx


def knee_of_curve(curve: List[Dict[str, float]], slo_p99_ms: float,
                  min_achieved_frac: float = 0.85,
                  rate_key: str = "nominal_rps") -> float:
    """Max offered rate whose P99 meets the SLO with no rejects and
    achieved throughput within ``min_achieved_frac`` of offered.

    Rows without a positive nominal rate (e.g. trace replay, where the
    trace fixes the rate) fall back to the measured offered rate so the
    achieved-fraction check still binds."""
    idx = knee_index_of_curve(curve, slo_p99_ms, min_achieved_frac, rate_key)
    return 0.0 if idx is None else _row_rate(curve[idx], rate_key)


# ---------------------------------------------------------------------------
# Adaptive SLO-knee search.
#
# Fixed rate grids spend most of their samples on the flat part of the
# throughput-latency curve; the interesting behaviour lives in a narrow
# band at the capacity cliff (FaaSNet, Quark).  KneeSearch spends samples
# there instead: a coarse exponential bracketing pass finds a [pass, fail]
# rate bracket, then geometric bisection narrows it to a relative-width
# tolerance.  Failing probes feed back their *achieved* throughput as a
# capacity ceiling (an overloaded run completes work at roughly the
# service capacity, and the SLO knee cannot exceed it), which collapses
# the bracket in one probe even when the initial guess is far off — so a
# new backend needs zero hand-measured grid entries.


@dataclasses.dataclass
class KneeSearchResult:
    """Outcome of one :class:`KneeSearch` run.

    ``knee_rps`` is the highest probed rate that met the SLO criteria
    (0.0 when nothing was sustainable); ``[lo_rps, hi_rps]`` is the final
    bracket; ``trace`` records every probe in issue order (rate, phase,
    verdict, and the probe's measured row) — the artifact's audit trail
    for how the knee was located."""
    knee_rps: float
    lo_rps: float
    hi_rps: float
    n_probes: int
    converged: bool
    trace: List[Dict[str, object]]

    def knee_trace_index(self) -> Optional[int]:
        """Index (into ``trace``/``rows``) of the knee probe: the highest
        passing *full-resolution* probe — a passing low-res bracket probe
        under-samples the tail and never certifies the knee."""
        best_idx, best = None, 0.0
        for i, t in enumerate(self.trace):
            if (t["ok"] and t["phase"] == "bisect"
                    and float(t["rate_rps"]) >= best):
                best, best_idx = float(t["rate_rps"]), i
        return best_idx


class KneeSearch:
    """Adaptive SLO-knee locator over an open-loop probe function.

    ``probe(rate_rps, phase)`` runs one open-loop experiment at the given
    offered rate and returns its result row (needs ``p99_ms``,
    ``achieved_rps``, ``rejected``); ``phase`` is ``"bracket"`` or
    ``"bisect"`` so callers can run bracketing probes at lower resolution
    (shorter duration).  The search is deterministic given a
    deterministic probe.

    ``max_probes`` is a hard sample budget: the search never issues more
    open-loop runs than that, returning the best bracket found so far
    with ``converged=False`` when the budget ran out first.
    """

    def __init__(self, probe: Callable[[float, str], Dict[str, object]],
                 slo_p99_ms: float, rate0: float = 500.0,
                 growth: float = 2.0, shrink: float = 0.75,
                 rel_tol: float = 0.10, max_probes: int = 12,
                 min_achieved_frac: float = 0.85,
                 min_completed_frac: float = 0.95,
                 rate_floor: float = 25.0, rate_ceiling: float = 64000.0):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        if not 0.0 < shrink < 1.0:
            raise ValueError(f"shrink must be in (0, 1), got {shrink}")
        if rel_tol <= 0.0:
            raise ValueError(f"rel_tol must be positive, got {rel_tol}")
        if max_probes < 1:
            raise ValueError(f"max_probes must be >= 1, got {max_probes}")
        if not 0.0 < rate_floor <= rate_ceiling:
            raise ValueError(f"need 0 < rate_floor <= rate_ceiling, got "
                             f"[{rate_floor}, {rate_ceiling}]")
        self.probe = probe
        self.slo_p99_ms = slo_p99_ms
        self.rate0 = rate0
        self.growth = growth
        self.shrink = shrink
        self.rel_tol = rel_tol
        self.max_probes = max_probes
        self.min_achieved_frac = min_achieved_frac
        self.min_completed_frac = min_completed_frac
        self.rate_floor = rate_floor
        self.rate_ceiling = rate_ceiling

    def _clamp(self, rate: float) -> float:
        return min(max(rate, self.rate_floor), self.rate_ceiling)

    def _ok(self, row: Dict[str, object], rate: float) -> bool:
        """Probe verdict.  Prefers the *completed fraction* (did the work
        admitted during the run finish within the drain window?) over the
        grid criterion's achieved-vs-nominal ratio: the latter compares a
        completion count against the nominal rate, so at short probe
        durations Poisson arrival-count noise alone can flip it."""
        frac = row.get("completed_frac")
        if frac is None:
            return _row_meets_slo(row, rate, self.slo_p99_ms,
                                  self.min_achieved_frac)
        p99 = float(row["p99_ms"])
        return (math.isfinite(p99) and p99 <= self.slo_p99_ms
                and row.get("rejected", 0) == 0
                and float(frac) >= self.min_completed_frac)

    def _probe(self, rate: float, phase: str,
               trace: List[Dict[str, object]]) -> bool:
        row = self.probe(rate, phase)
        ok = self._ok(row, rate)
        trace.append({"rate_rps": float(rate), "phase": phase, "ok": ok,
                      "p99_ms": float(row.get("p99_ms", float("nan"))),
                      "achieved_rps": float(row.get("achieved_rps", 0.0)),
                      "completion_rps": float(
                          row.get("completion_rps",
                                  row.get("achieved_rps", 0.0))),
                      "row": row})
        return ok

    def _descend(self, rate: float, trace_entry: Dict[str, object]) -> float:
        """Next (lower) rate after a failing probe at ``rate``.  The
        failing run's busy-span completion rate hints at the capacity,
        which can collapse the walk in one step when the guess was far
        off — but under *deep* overload this runtime's throughput itself
        collapses, so the hint is never trusted below a plain geometric
        ``rate / growth`` step."""
        cap = trace_entry["completion_rps"]
        hint = self.shrink * cap if math.isfinite(cap) and cap > 0 else 0.0
        return self._clamp(max(hint, rate / self.growth))

    def run(self) -> KneeSearchResult:
        trace: List[Dict[str, object]] = []
        lo = 0.0                    # highest FULL-resolution rate that
        #                             met the SLO — only such a probe may
        #                             certify the knee
        hi: Optional[float] = None  # lowest rate actually probed-and-failed
        plo: Optional[float] = None  # provisional low-res pass (guidance)
        rate = self._clamp(self.rate0)
        # -- bracket: low-resolution exponential walk to a provisional
        #    [pass, fail] straddle of the knee.  One probe is always
        #    reserved for the full-resolution phase — only that phase can
        #    certify a knee, so a bracket walk that eats the whole budget
        #    would guarantee an empty result (a budget of 1 skips
        #    bracketing entirely and spends its one probe at rate0).
        bracket_budget = self.max_probes - 1
        while len(trace) < bracket_budget:
            if self._probe(rate, "bracket", trace):
                plo = max(plo or 0.0, rate)
                if hi is not None or rate >= self.rate_ceiling:
                    break
                rate = self._clamp(rate * self.growth)
            else:
                hi = rate if hi is None else min(hi, rate)
                if plo is not None:
                    break                           # bracketed
                if hi <= self.rate_floor:
                    break                           # nothing sustainable
                nxt = self._descend(rate, trace[-1])
                if nxt >= rate:                     # floor-pinned: re-probing
                    break                           # the same rate is futile
                rate = nxt
        # -- bisect: full-resolution probes, starting by confirming the
        #    provisional pass (a short bracket probe under-samples the
        #    tail and must never certify the knee itself); when nothing
        #    passed at low resolution, descend from the failing bound
        if plo is not None:
            next_rate = plo
        elif hi is not None and hi > self.rate_floor and trace:
            next_rate = self._descend(rate, trace[-1])
        elif not trace:
            next_rate = rate        # budget of 1: single full-res probe
        else:
            next_rate = None
        while next_rate is not None and len(trace) < self.max_probes:
            rate = next_rate
            if self._probe(rate, "bisect", trace):
                lo = max(lo, rate)
                if hi is None:
                    break                           # sustainable at ceiling
            else:
                hi = rate if hi is None else min(hi, rate)
            if hi is None:
                break
            if lo > 0.0:
                if (hi - lo) / hi <= self.rel_tol:
                    break                           # bracket narrow enough
                next_rate = math.sqrt(lo * hi)
            else:
                if hi <= self.rate_floor:
                    break                           # nothing sustainable
                nxt = self._descend(rate, trace[-1])
                if nxt >= rate:
                    break
                next_rate = nxt
        if hi is None:
            # no failing bound was ever found: the knee is only a lower
            # bound — converged solely when the ceiling itself sustained
            converged = lo >= self.rate_ceiling
            hi = lo if lo > 0.0 else self._clamp(self.rate0)
        else:
            converged = (lo > 0.0 and hi >= lo
                         and (hi - lo) / max(hi, 1e-9) <= self.rel_tol)
        return KneeSearchResult(knee_rps=lo, lo_rps=lo, hi_rps=hi,
                                converged=converged, n_probes=len(trace),
                                trace=trace)


def sustainable_throughput(backend: str, fn: Optional[FunctionSpec] = None,
                           slo_p99_ms: float = 50.0, rates=None,
                           n_cores: int = 10, seed: int = 0) -> Dict[str, object]:
    """Max offered rate whose P99 stays under the SLO; fresh runtime per
    rate (open-loop correctness)."""
    fn = fn or FunctionSpec(name="aes")
    rates = rates or [250, 500, 1000, 2000, 4000, 8000, 12000, 16000, 20000, 24000]
    best, curve = 0.0, []
    for rate in rates:
        sim = Simulator(seed=seed)
        rt = FaasdRuntime(sim, backend=backend, n_cores=n_cores)
        rt.deploy_blocking(fn)
        res = drive(rt, LoadSpec.single(fn.name, rate, warmup_s=0.3))
        res["offered_rps"] = float(rate)
        curve.append(res)
        ok = (res["p99_ms"] <= slo_p99_ms
              and res["achieved_rps"] >= 0.85 * rate and res["rejected"] == 0)
        if ok:
            best = max(best, rate)
    return {"sustainable_rps": best, "curve": curve}
