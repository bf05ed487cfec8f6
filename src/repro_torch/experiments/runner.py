"""ExperimentRunner: executes :class:`Scenario` specs across the backend
matrix and assembles the machine-readable bench artifact.

Execution is factored into module-level per-mode functions so (scenario,
backend) work items can ship to parallel worker processes unchanged; the
runner itself only schedules work and reduces results into the artifact
(claims, flat metrics, histograms).

The port's copy of the JAX package's ``experiments/runner.py``.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.autoscaler import Autoscaler
from repro_torch.core.faas import FaasdRuntime, FunctionSpec
from repro_torch.core.simulator import Simulator
from repro_torch.core.workload import (KneeSearch, LatencySummary, drive,
                                       heavy_tailed_work, knee_index_of_curve,
                                       knee_of_curve, percentile, run_sequential)
from repro_torch.experiments.artifacts import (build_artifact, latency_histogram,
                                               metric_row)
from repro_torch.experiments.scenario import (FleetSpec, FunctionProfile, Scenario,
                                              SearchSpec)
from repro_torch.fleet import Cluster

PAPER_FIG5 = {"e2e_median": 37.33, "e2e_p99": 63.42,
              "exec_median": 35.3, "exec_p99": 81.0}
PAPER_FIG6 = {"throughput_ratio": 10.0, "median_speedup": 2.0,
              "p99_speedup": 3.5}
PAPER_COLDSTART_JUNCTION_MS = 3.4


# ---------------------------------------------------------------------------
# Spec -> runtime plumbing.


def _deploy_mix(rt: FaasdRuntime, functions: Sequence[FunctionProfile]) -> None:
    for prof in functions:
        work = prof.work_us
        if prof.heavy_tail_alpha is not None:
            work = heavy_tailed_work(rt.sim.rng, prof.work_us,
                                     alpha=prof.heavy_tail_alpha)
        rt.deploy_blocking(FunctionSpec(
            name=prof.name, work_us=work, payload_bytes=prof.payload_bytes,
            response_bytes=prof.response_bytes, scale=prof.scale,
            max_cores=prof.max_cores))


def _seeds(sc: Scenario, smoke: bool) -> Sequence[int]:
    return sc.seeds[:2] if smoke else sc.seeds


def _mean(xs: Sequence[float]) -> float:
    return float(np.mean(xs)) if len(xs) else float("nan")


def _finite_mean(xs: Sequence[float]) -> float:
    """Mean over the finite values only (NaN when none are): one seed
    with an undefined sample must not poison the pooled statistic."""
    finite = [x for x in xs if math.isfinite(x)]
    return float(np.mean(finite)) if finite else float("nan")


def _storm_spec(sc: Scenario, i: int) -> FunctionSpec:
    """Spec for the i-th function of a provisioning storm; every storm
    wave (first deploys, redeploys, mixed-mode storms) must build the
    identical spec or the waves measure different functions."""
    prof = sc.functions[i % len(sc.functions)]
    return FunctionSpec(
        name=f"storm-{prof.name}-{i}", work_us=prof.work_us,
        payload_bytes=prof.payload_bytes,
        response_bytes=prof.response_bytes, max_cores=prof.max_cores)


def _make_autoscaler(sc: Scenario, rt: FaasdRuntime) -> Optional[Autoscaler]:
    if sc.autoscaler is None:
        return None
    asc = Autoscaler(rt.sim, rt, sc.autoscaler.build())
    asc.run()
    return asc


def _pool_autoscaler(runs: List[Dict[str, object]]) -> Dict[str, object]:
    """Reduce per-run Autoscaler.telemetry() dicts into the artifact's
    ``autoscaler`` block: counters summed, reaction times pooled into
    percentiles, the first *eventful* run's replica timeline kept as
    representative (a search's opening bracket probe can be too short to
    trigger any scale event)."""
    reactions = [x for t in runs for x in t["reactions_ms"]]
    timeline = next((t["timeline"] for t in runs if t["timeline"]),
                    runs[0]["timeline"])
    return {
        "policy": runs[0]["policy"],
        "n_runs": len(runs),
        "n_scale_events": int(sum(t["n_scale_events"] for t in runs)),
        "n_up": int(sum(t["n_up"] for t in runs)),
        "n_down": int(sum(t["n_down"] for t in runs)),
        "n_aborted": int(sum(t["n_aborted"] for t in runs)),
        "cold_starts": int(sum(t["cold_starts"] for t in runs)),
        "cold_path_arrivals": int(sum(t["cold_path_arrivals"]
                                      for t in runs)),
        "reaction_p50_ms": percentile(reactions, 50),
        "reaction_p99_ms": percentile(reactions, 99),
        "reaction_mean_ms": _mean(reactions),
        "reactions_ms": reactions[:500],
        "timeline": timeline[:200],
    }


# ---------------------------------------------------------------------------
# Mode executors.  Each returns a plain-JSON dict for one backend.


def _exec_closed(sc: Scenario, backend: str, duration_scale: float,
                 smoke: bool) -> Dict[str, object]:
    n = max(20, int(round(sc.n_requests * duration_scale)))
    if smoke:
        n = min(n, 60)
    pooled: List[float] = []
    e2e: List[LatencySummary] = []
    exe: List[LatencySummary] = []
    per_fn: Dict[str, List[float]] = {f.name: [] for f in sc.functions}
    for seed in _seeds(sc, smoke):
        sim = Simulator(seed=seed)
        rt = FaasdRuntime(sim, backend=backend, n_cores=sc.n_cores)
        _deploy_mix(rt, sc.functions)
        for prof in sc.functions:
            s = run_sequential(rt, prof.name, n=n)
            per_fn[prof.name].append(s.median_ms)
        e2e.append(LatencySummary.of(rt.latencies_ms()))
        exe.append(LatencySummary.of(rt.exec_latencies_ms()))
        pooled.extend(rt.latencies_ms())
    return {
        "mode": "closed",
        "n": sum(s.n for s in e2e),
        "n_per_function": n,
        "median_ms": _mean([s.median_ms for s in e2e]),
        "p99_ms": _mean([s.p99_ms for s in e2e]),
        "mean_ms": _mean([s.mean_ms for s in e2e]),
        "p999_ms": _mean([s.p999_ms for s in e2e]),
        "exec_median_ms": _mean([s.median_ms for s in exe]),
        "exec_p99_ms": _mean([s.p99_ms for s in exe]),
        "per_fn_median_ms": {k: _mean(v) for k, v in per_fn.items()},
        "hist": latency_histogram(pooled),
    }


def _open_loop_run(sc: Scenario, backend: str, seed: int, rate: float,
                   duration: float,
                   asc_runs: List[Dict[str, object]],
                   ) -> Tuple[Dict[str, object], List[float]]:
    """One fresh-runtime open-loop run (open-loop correctness: queueing
    state never leaks across rates); returns the result row and its
    latency samples, appending autoscaler telemetry to ``asc_runs``."""
    sim = Simulator(seed=seed)
    rt = FaasdRuntime(sim, backend=backend, n_cores=sc.n_cores)
    _deploy_mix(rt, sc.functions)
    asc = _make_autoscaler(sc, rt)     # an Autoscaler is a SimObserver
    res = drive(rt, sc.load_spec(rate, duration), observer=asc)
    lats = res.pop("latencies_ms")
    res.pop("per_fn")
    if asc is not None:
        t = asc.telemetry()
        res["scale_events"] = int(t["n_scale_events"])
        res["cold_path_arrivals"] = int(t["cold_path_arrivals"])
        asc_runs.append(t)
    return res, lats


def _assemble_open(sc: Scenario, duration: float,
                   curve: List[Dict[str, object]],
                   pooled: List[List[float]], knee: float,
                   rep_idx: Optional[int],
                   asc_runs: List[Dict[str, object]]) -> Dict[str, object]:
    """Common tail of the open-mode executors: representative latency row
    (tracked by *index* — search-generated rates are not grid-aligned, so
    re-matching the knee rate by float equality silently misses) and the
    artifact's per-backend block."""
    if rep_idx is None and curve:
        # no knee anywhere: fall back to the lowest offered rate so
        # over-SLO smoke runs still record latencies — preferring
        # full-resolution rows (a low-res bracket probe under-samples
        # the tail and must not become the headline latency row when a
        # full-duration row at the same rate exists)
        candidates = [i for i, r in enumerate(curve)
                      if r.get("phase") != "bracket"] \
            or list(range(len(curve)))
        rep_idx = min(candidates, key=lambda i: curve[i]["nominal_rps"])
    rep = curve[rep_idx] if rep_idx is not None else None
    out = {
        "mode": "open",
        "duration_s": duration,
        "arrival_kind": sc.arrival.kind,
        "slo_p99_ms": sc.slo_p99_ms,
        "curve": curve,
        "knee_rps": knee,
        "knee_row": rep_idx,
        "median_ms": rep["median_ms"] if rep else float("nan"),
        "p99_ms": rep["p99_ms"] if rep else float("nan"),
        "n": int(sum(r["n"] for r in curve)),
        "hist": latency_histogram(pooled[rep_idx]
                                  if rep_idx is not None else []),
    }
    if asc_runs:
        out["autoscaler"] = _pool_autoscaler(asc_runs)
    return out


def _calibrated_rate0(sc: Scenario, backend: str, seed: int,
                      spec: SearchSpec) -> float:
    """Initial bracket rate from a cheap closed-loop warm measurement:
    roughly half the worker's aggregate service rate.  A rough guess is
    all the search needs — failing probes feed their achieved throughput
    back into the bracket as a capacity ceiling."""
    sim = Simulator(seed=seed)
    rt = FaasdRuntime(sim, backend=backend, n_cores=sc.n_cores)
    _deploy_mix(rt, sc.functions)
    s = run_sequential(rt, sc.functions[0].name, n=16)
    if not math.isfinite(s.median_ms) or s.median_ms <= 0:
        return min(max(500.0, spec.rate_floor), spec.rate_ceiling)
    est = 0.5 * sc.n_cores * 1e3 / s.median_ms
    return min(max(est, spec.rate_floor), spec.rate_ceiling)


def _exec_open_search(sc: Scenario, backend: str, duration: float,
                      smoke: bool, spec: SearchSpec) -> Dict[str, object]:
    """Adaptive knee search per (backend, seed): bracketing probes run at
    ``bracket_duration_frac`` resolution, bisection probes at full
    scenario duration; per-seed knees are pooled into ``knee_rps`` and
    every probe lands in the curve + search trace."""
    tol = spec.rel_tol_for(smoke)
    budget = spec.max_probes_for(smoke)
    curve: List[Dict[str, object]] = []
    pooled: List[List[float]] = []
    asc_runs: List[Dict[str, object]] = []
    seed_traces: List[Dict[str, object]] = []
    knees: List[float] = []
    rep_idx: Optional[int] = None
    for seed in _seeds(sc, smoke):
        rate0 = spec.rate0 if spec.rate0 is not None else \
            _calibrated_rate0(sc, backend, seed, spec)
        rate0 *= spec.rate0_frac
        base_idx = len(curve)

        def probe(rate: float, phase: str, seed=seed) -> Dict[str, object]:
            frac = spec.bracket_duration_frac if phase == "bracket" else 1.0
            d = max(0.2, duration * frac)
            res, lats = _open_loop_run(sc, backend, seed, rate, d, asc_runs)
            row = {"nominal_rps": float(rate), "seed": seed,
                   "phase": phase, "duration_s": round(d, 4), **res}
            curve.append(row)
            pooled.append(lats)
            return row

        result = KneeSearch(
            probe, sc.slo_p99_ms, rate0=rate0, growth=spec.growth,
            shrink=spec.shrink, rel_tol=tol, max_probes=budget,
            rate_floor=spec.rate_floor,
            rate_ceiling=spec.rate_ceiling).run()
        knees.append(result.knee_rps)
        ti = result.knee_trace_index()
        if rep_idx is None and ti is not None:
            rep_idx = base_idx + ti
        seed_traces.append({
            "seed": seed,
            "rate0": round(rate0, 3),
            "knee_rps": result.knee_rps,
            "lo_rps": result.lo_rps,
            "hi_rps": result.hi_rps,
            "n_probes": result.n_probes,
            "converged": result.converged,
            "probes": [{k: t[k] for k in ("rate_rps", "phase", "ok",
                                          "p99_ms", "achieved_rps",
                                          "completion_rps")}
                       for t in result.trace],
        })
    out = _assemble_open(sc, duration, curve, pooled,
                         knee=_mean(knees) if knees else 0.0,
                         rep_idx=rep_idx, asc_runs=asc_runs)
    out["search"] = {
        "spec": {"rate0": spec.rate0, "rate0_frac": spec.rate0_frac,
                 "growth": spec.growth,
                 "shrink": spec.shrink, "rel_tol": tol,
                 "max_probes": budget,
                 "bracket_duration_frac": spec.bracket_duration_frac,
                 "rate_floor": spec.rate_floor,
                 "rate_ceiling": spec.rate_ceiling},
        "n_probes": int(sum(t["n_probes"] for t in seed_traces)),
        "knee_rps_per_seed": knees,
        "converged": all(t["converged"] for t in seed_traces),
        "trace": seed_traces,
    }
    return out


def _exec_open(sc: Scenario, backend: str, duration_scale: float,
               smoke: bool) -> Dict[str, object]:
    duration = max(0.3, sc.duration_s * duration_scale)
    spec = sc.search_spec()
    if spec is not None:
        return _exec_open_search(sc, backend, duration, smoke, spec)
    rates = sc.rates_for(backend, smoke=smoke)
    if not rates:
        # fail the cell loudly instead of emitting a zero-sample result
        # whose NaN medians would poison the JSON artifact
        raise ValueError(
            f"scenario {sc.name!r} has no rate grid for backend "
            f"{backend!r}; add rates[{backend!r}], a '*' fallback, or "
            f"drop the grids to use the adaptive knee search")
    curve: List[Dict[str, object]] = []
    pooled: List[List[float]] = []
    asc_runs: List[Dict[str, object]] = []
    for rate in rates:
        per_seed: List[Dict[str, object]] = []
        lats: List[float] = []
        row_telemetry: List[Dict[str, object]] = []
        for seed in _seeds(sc, smoke):
            res, run_lats = _open_loop_run(sc, backend, seed, rate,
                                           duration, row_telemetry)
            lats.extend(run_lats)
            per_seed.append(res)
        row = {"nominal_rps": float(rate)}
        for key in ("offered_rps", "achieved_rps", "completion_rps",
                    "median_ms", "p99_ms", "mean_ms", "p999_ms"):
            row[key] = _mean([r[key] for r in per_seed])
        row["n"] = int(sum(r["n"] for r in per_seed))
        row["rejected"] = int(sum(r["rejected"] for r in per_seed))
        if row_telemetry:
            row["scale_events"] = int(sum(t["n_scale_events"]
                                          for t in row_telemetry))
            row["cold_path_arrivals"] = int(sum(t["cold_path_arrivals"]
                                                for t in row_telemetry))
            asc_runs.extend(row_telemetry)
        curve.append(row)
        pooled.append(lats)
    return _assemble_open(sc, duration, curve, pooled,
                          knee=knee_of_curve(curve, sc.slo_p99_ms),
                          rep_idx=knee_index_of_curve(curve, sc.slo_p99_ms),
                          asc_runs=asc_runs)


def _exec_storm(sc: Scenario, backend: str, duration_scale: float,
                smoke: bool) -> Dict[str, object]:
    k = min(8, sc.storm_functions) if smoke else sc.storm_functions
    deploy_ms: List[float] = []
    invoke_ms: List[float] = []
    total_ms: List[float] = []
    redeploy_ms: List[float] = []
    for seed in _seeds(sc, smoke):
        sim = Simulator(seed=seed)
        rt = FaasdRuntime(sim, backend=backend, n_cores=sc.n_cores)
        t0 = sim.now
        remaining = [k]

        def one(i):
            spec = _storm_spec(sc, i)
            yield from rt.deploy(spec)
            deploy_ms.append((sim.now - t0) * 1e3)
            rec = yield from rt.invoke(spec.name)
            invoke_ms.append(rec.e2e * 1e3)
            total_ms.append((sim.now - t0) * 1e3)
            remaining[0] -= 1
            if remaining[0] == 0:
                sim.stop()

        for i in range(k):
            sim.process(one(i))
        sim.run()
        assert remaining[0] == 0, "storm did not drain"
        # second wave: redeploy every storm function (config-update shape).
        # Plain backends pay the same cold start again; a snapshotting
        # backend (firecracker) restores from the snapshots the first wave
        # warmed — this is the storm's snapshot-restore-vs-full-boot signal
        remaining = [k]

        def again(i):
            t1 = sim.now
            yield from rt.deploy(_storm_spec(sc, i))
            redeploy_ms.append((sim.now - t1) * 1e3)
            remaining[0] -= 1
            if remaining[0] == 0:
                sim.stop()

        for i in range(k):
            sim.process(again(i))
        sim.run()
        assert remaining[0] == 0, "redeploy wave did not drain"
    # contention-free singles: a first deploy for the paper's
    # instance-init claim, a redeploy for the snapshot-restore claim
    sim = Simulator(seed=0)
    rt = FaasdRuntime(sim, backend=backend, n_cores=sc.n_cores)
    t0 = sim.now
    rt.deploy_blocking(FunctionSpec(name="solo"))
    single_deploy_ms = (sim.now - t0) * 1e3
    t0 = sim.now
    rt.deploy_blocking(FunctionSpec(name="solo"))
    single_redeploy_ms = (sim.now - t0) * 1e3
    d, t = LatencySummary.of(deploy_ms), LatencySummary.of(total_ms)
    return {
        "mode": "storm",
        "functions": k,
        "n": len(total_ms),
        "single_deploy_ms": single_deploy_ms,
        "single_redeploy_ms": single_redeploy_ms,
        "redeploy_speedup": single_deploy_ms / max(single_redeploy_ms, 1e-9),
        "deploy_median_ms": d.median_ms,
        "deploy_p99_ms": d.p99_ms,
        "redeploy_median_ms": LatencySummary.of(redeploy_ms).median_ms,
        "first_invoke_median_ms": LatencySummary.of(invoke_ms).median_ms,
        "median_ms": t.median_ms,       # deploy + first invoke, end to end
        "p99_ms": t.p99_ms,
        "hist": latency_histogram(total_ms),
    }


def _exec_mixed(sc: Scenario, backend: str, duration_scale: float,
                smoke: bool) -> Dict[str, object]:
    """Steady warm traffic plus a provisioning storm on the same worker:
    ``storm_functions`` deploy+invoke-train storms land mid-run while the
    warm mix keeps arriving, measuring how much the cold path inflates
    warm-path tail latency (and, with an autoscaler in the loop, how the
    controller reacts to the combined pressure)."""
    duration = max(0.5, sc.duration_s * duration_scale)
    storm_t = duration * 0.25       # warm window established first
    k = min(8, sc.storm_functions) if smoke else sc.storm_functions
    rates = sc.rates_for(backend, smoke=smoke)
    if not rates:
        raise ValueError(
            f"scenario {sc.name!r} has no rate grid for backend "
            f"{backend!r}; add rates[{backend!r}] or a '*' fallback")
    rate = float(rates[0])          # mixed mode runs one warm rate
    warm_names = set(sc.fn_names())
    per_seed: List[Dict[str, float]] = []
    asc_runs: List[Dict[str, object]] = []
    storm_deploy_ms: List[float] = []
    storm_total_ms: List[float] = []
    warm_lats_pooled: List[float] = []
    for seed in _seeds(sc, smoke):
        sim = Simulator(seed=seed)
        rt = FaasdRuntime(sim, backend=backend, n_cores=sc.n_cores)
        _deploy_mix(rt, sc.functions)
        asc = _make_autoscaler(sc, rt)
        t0 = sim.now
        storm_done_t: List[float] = []

        def one_storm(i, t0=t0, sim=sim, rt=rt, done=storm_done_t):
            # staggered FaaSNet-style storm: deploy + a short invoke train
            yield sim.timeout(storm_t + i * 0.002 - (sim.now - t0))
            spec = _storm_spec(sc, i)
            t_start = sim.now
            yield from rt.deploy(spec)
            storm_deploy_ms.append((sim.now - t_start) * 1e3)
            for _ in range(4):
                yield from rt.invoke(spec.name)
                yield sim.timeout(0.001)
            storm_total_ms.append((sim.now - t_start) * 1e3)
            done.append(sim.now - t0)

        for i in range(k):
            sim.process(one_storm(i))
        start_idx = len(rt.records)
        drive(rt, sc.load_spec(rate, duration), observer=asc)
        if asc is not None:
            asc_runs.append(asc.telemetry())
        warmup = sc.warmup_frac * duration
        warm = [r for r in rt.records[start_idx:] if r.fn in warm_names
                and r.t_arrival >= t0 + warmup]
        storm_end = t0 + (max(storm_done_t) if storm_done_t else duration)
        before = [r.e2e * 1e3 for r in warm
                  if r.t_arrival < t0 + storm_t]
        during = [r.e2e * 1e3 for r in warm
                  if t0 + storm_t <= r.t_arrival <= storm_end]
        lat = [r.e2e * 1e3 for r in warm]
        warm_lats_pooled.extend(lat)
        s = LatencySummary.of(lat)
        p99_before = percentile(before, 99)
        p99_during = percentile(during, 99)
        # short smoke runs can leave the pre-storm warm window [warmup,
        # storm_t) empty: the percentiles come back NaN (or zero), and an
        # unguarded division would ship a NaN that poisons compare.py
        # baselines — flag the seed instead
        warm_ok = (math.isfinite(p99_before) and p99_before > 0
                   and math.isfinite(p99_during))
        per_seed.append({
            "n": s.n, "median_ms": s.median_ms, "p99_ms": s.p99_ms,
            "warm_median_before_ms": percentile(before, 50),
            "warm_median_during_ms": percentile(during, 50),
            "warm_p99_before_ms": p99_before,
            "warm_p99_during_ms": p99_during,
            "warm_p99_inflation": (p99_during / p99_before) if warm_ok
            else float("nan"),
            "insufficient_warm_samples": not warm_ok,
        })
    out: Dict[str, object] = {
        "mode": "mixed",
        "duration_s": duration,
        "storm_t_s": storm_t,
        "storm_functions": k,
        "warm_rps": rate,
        "arrival_kind": sc.arrival.kind,
        "n": int(sum(r["n"] for r in per_seed)),
        "storm_deploy_median_ms": LatencySummary.of(storm_deploy_ms).median_ms,
        "storm_total_median_ms": LatencySummary.of(storm_total_ms).median_ms,
        "hist": latency_histogram(warm_lats_pooled),
    }
    for key in ("median_ms", "p99_ms"):
        out[key] = _mean([r[key] for r in per_seed])
    for key in ("warm_median_before_ms", "warm_median_during_ms",
                "warm_p99_before_ms", "warm_p99_during_ms",
                "warm_p99_inflation"):
        out[key] = _finite_mean([r[key] for r in per_seed])
    out["insufficient_warm_samples"] = int(sum(
        r["insufficient_warm_samples"] for r in per_seed))
    if asc_runs:
        out["autoscaler"] = _pool_autoscaler(asc_runs)
    return out


def _fleet_warm_targets(sc: Scenario, spec: FleetSpec) -> Dict[str, object]:
    """Per-function worker subsets for the warm mix.

    ``spread="all"`` puts every function everywhere (None = all
    workers).  ``spread="zipf"`` gives the rank-r function a contiguous
    worker block sized by its popularity share (min 2 workers for
    redundancy), rotated per rank so the blocks interleave instead of
    piling onto worker 0."""
    if spec.spread == "all":
        return {prof.name: None for prof in sc.functions}
    n = spec.n_workers
    w_max = max(p.weight for p in sc.functions)
    out: Dict[str, object] = {}
    for r, prof in enumerate(sc.functions):
        k = max(2, min(n, int(round(n * prof.weight / w_max))))
        start = (r * 7) % n
        out[prof.name] = [(start + j) % n for j in range(k)]
    return out


def _fleet_run(sc: Scenario, backend: str, seed: int, placement: str,
               distribution: str, rate: float, duration: float,
               spec: FleetSpec,
               targets: Dict[str, object]) -> Dict[str, object]:
    """One (placement, distribution, seed) fleet run: deploy the warm
    mix, drive gateway-routed traffic, optionally land a provisioning
    storm mid-run (completing it past the drive window if needed)."""
    sim = Simulator(seed=seed)
    cluster = Cluster(
        sim, spec.n_workers, backend=backend, n_cores=sc.n_cores,
        placement=placement, distribution=distribution,
        image_mb=spec.image_mb, origin_gbps=spec.origin_gbps,
        peer_gbps=spec.peer_gbps, fanout=spec.fanout,
        spill_load=spec.spill_load,
        scale_policy=sc.autoscaler.build if sc.autoscaler else None)
    for prof in sc.functions:
        work = prof.work_us
        if prof.heavy_tail_alpha is not None:
            work = heavy_tailed_work(sim.rng, prof.work_us,
                                     alpha=prof.heavy_tail_alpha)
        cluster.deploy_blocking(
            FunctionSpec(name=prof.name, work_us=work,
                         payload_bytes=prof.payload_bytes,
                         response_bytes=prof.response_bytes,
                         scale=prof.scale, max_cores=prof.max_cores),
            workers=targets[prof.name])
    t0 = sim.now
    storm_t = spec.storm_t_frac * duration
    storm_proc = None
    if spec.storm_replicas:
        storm_fn = FunctionSpec(name="storm-fn", max_cores=2)

        def launch():
            yield sim.timeout(storm_t)
            yield from cluster.scale_out(storm_fn, spec.storm_replicas)

        storm_proc = sim.process(launch())
    res = drive(cluster, sc.load_spec(rate, duration))
    if storm_proc is not None and not storm_proc.done:
        # a slow (naive) distribution can outlast the drive window: run
        # the shared heap on until the storm lands so time-to-full is
        # always measured, never truncated
        storm_proc.completion.callbacks.append(lambda _v: sim.stop())
        sim.run()
        assert storm_proc.done, "provisioning storm did not converge"
    out: Dict[str, object] = {
        "n": res["n"], "median_ms": res["median_ms"],
        "p99_ms": res["p99_ms"], "rejected": res["rejected"],
        "latencies_ms": res["latencies_ms"],
        "workers": res["fleet"]["workers"],
        "expansions": len(res["fleet"]["expansions"]),
    }
    warmup = sc.warmup_frac * duration
    if spec.storm_replicas:
        storm = cluster.storms[-1]
        t_end = storm["t_start_s"] + storm["time_to_full_s"]
        warm_names = set(sc.fn_names())
        warm = [r for w in cluster.workers for r in w.runtime.records
                if r.fn in warm_names and r.t_arrival >= t0 + warmup]
        before = [r.e2e * 1e3 for r in warm if r.t_arrival < t0 + storm_t]
        during = [r.e2e * 1e3 for r in warm
                  if t0 + storm_t <= r.t_arrival <= t_end]
        p99_before = percentile(before, 99)
        p99_during = percentile(during, 99)
        warm_ok = (math.isfinite(p99_before) and p99_before > 0
                   and math.isfinite(p99_during))
        out.update({
            "time_to_full_s": storm["time_to_full_s"],
            "storm": storm,
            "warm_p99_before_ms": p99_before,
            "warm_p99_during_ms": p99_during,
            "warm_p99_inflation": (p99_during / p99_before) if warm_ok
            else float("nan"),
            "insufficient_warm_samples": not warm_ok,
        })
        by_wid = {d["worker"]: d for d in storm["workers"]}
        for blk in out["workers"]:
            sd = by_wid.get(blk["worker"])
            if sd is not None:
                blk["storm_replicas"] = sd["replicas"]
                blk["storm_pulled"] = sd["pulled"]
                blk["storm_t_ready_s"] = sd["t_ready_s"]
    if sc.autoscaler is not None:
        tele = [w.autoscaler.telemetry() for w in cluster.workers]
        out["autoscaler_runs"] = tele
        for blk, t in zip(out["workers"], tele):
            rx = t["reactions_ms"]
            blk["reaction_p50_ms"] = (round(percentile(rx, 50), 3)
                                      if rx else None)
            blk["n_scale_events"] = t["n_scale_events"]
    return out


def _exec_fleet(sc: Scenario, backend: str, duration_scale: float,
                smoke: bool) -> Dict[str, object]:
    """Fleet mode: N workers behind a gateway, per-variant runs over the
    (placement x distribution) grid from the scenario's FleetSpec.

    ``rates[backend][0]`` is the per-worker warm rate; the gateway
    admits ``rate * n_workers``.  The first (primary) variant provides
    the scenario's headline latency stats; when the spec compares tree
    vs naive distribution the fleet block carries
    ``tree_provisioning_speedup`` (naive/tree time-to-full-capacity)."""
    spec = sc.fleet or FleetSpec()
    duration = max(0.5, sc.duration_s * duration_scale)
    rates = sc.rates_for(backend, smoke=smoke)
    if not rates:
        raise ValueError(
            f"scenario {sc.name!r} has no per-worker rate for backend "
            f"{backend!r}; add rates[{backend!r}] or a '*' fallback")
    per_worker_rps = float(rates[0])
    rate = per_worker_rps * spec.n_workers
    targets = _fleet_warm_targets(sc, spec)
    variants: List[Dict[str, object]] = []
    primary_lats: List[float] = []
    for placement in spec.placements():
        for distribution in spec.distributions():
            per_seed: List[Dict[str, object]] = []
            for seed in _seeds(sc, smoke):
                per_seed.append(_fleet_run(sc, backend, seed, placement,
                                           distribution, rate, duration,
                                           spec, targets))
            first = per_seed[0]
            blk: Dict[str, object] = {
                "placement": placement,
                "distribution": distribution,
                "n": int(sum(r["n"] for r in per_seed)),
                "median_ms": _mean([r["median_ms"] for r in per_seed]),
                "p99_ms": _mean([r["p99_ms"] for r in per_seed]),
                "rejected": int(sum(r["rejected"] for r in per_seed)),
                "expansions": int(sum(r["expansions"] for r in per_seed)),
                "workers": first["workers"],    # per-worker telemetry
            }
            if spec.storm_replicas:
                blk["time_to_full_s"] = _mean(
                    [r["time_to_full_s"] for r in per_seed])
                storm = dict(first["storm"])
                storm["pulls"] = storm["pulls"][:2 * spec.n_workers]
                blk["storm"] = storm
                for key in ("warm_p99_before_ms", "warm_p99_during_ms",
                            "warm_p99_inflation"):
                    blk[key] = _finite_mean([r[key] for r in per_seed])
                blk["insufficient_warm_samples"] = int(sum(
                    r["insufficient_warm_samples"] for r in per_seed))
            asc_runs = [t for r in per_seed
                        for t in r.get("autoscaler_runs", ())]
            if asc_runs:
                blk["autoscaler"] = _pool_autoscaler(asc_runs)
            if not variants:        # primary variant feeds the histogram
                primary_lats = [x for r in per_seed
                                for x in r["latencies_ms"]]
            variants.append(blk)
    primary = variants[0]
    fleet: Dict[str, object] = {
        "n_workers": spec.n_workers,
        "placement": spec.placement,
        "distribution": spec.distribution,
        "spread": spec.spread,
        "image_mb": spec.image_mb,
        "storm_replicas": spec.storm_replicas,
        "variants": variants,
    }
    if spec.storm_replicas:
        by_dist = {v["distribution"]: v for v in variants
                   if v["placement"] == spec.placement
                   and "time_to_full_s" in v}
        if "tree" in by_dist and "naive" in by_dist:
            fleet["tree_provisioning_speedup"] = round(
                by_dist["naive"]["time_to_full_s"]
                / max(by_dist["tree"]["time_to_full_s"], 1e-9), 2)
    out: Dict[str, object] = {
        "mode": "fleet",
        "duration_s": duration,
        "arrival_kind": sc.arrival.kind,
        "n_workers": spec.n_workers,
        "warm_rps_per_worker": per_worker_rps,
        "warm_rps": rate,
        "n": primary["n"],
        "median_ms": primary["median_ms"],
        "p99_ms": primary["p99_ms"],
        "hist": latency_histogram(primary_lats),
        "fleet": fleet,
    }
    for key in ("warm_p99_before_ms", "warm_p99_during_ms",
                "warm_p99_inflation", "insufficient_warm_samples",
                "time_to_full_s"):
        if key in primary:
            out[key] = primary[key]
    if "autoscaler" in primary:
        out["autoscaler"] = primary["autoscaler"]
    return out


def _pool_chain(blocks: List[dict]) -> Dict[str, object]:
    """Reduce per-seed chain blocks into one: counters summed, latency
    stats seed-averaged, per-hop-depth rows matched by depth."""
    out: Dict[str, object] = {
        "n_roots": int(sum(b["n_roots"] for b in blocks)),
        "roots_completed": int(sum(b["roots_completed"] for b in blocks)),
        "rejected_hops": int(sum(b["rejected_hops"] for b in blocks)),
        "fused_members": int(sum(b["fused_members"] for b in blocks)),
    }
    for key in ("root_median_ms", "root_p99_ms", "root_mean_ms",
                "hop_tax_mean_ms"):
        out[key] = round(_finite_mean([b[key] for b in blocks]), 6)
    hops: List[dict] = []
    for d in sorted({r["hop"] for b in blocks for r in b["hops"]}):
        rows = [r for b in blocks for r in b["hops"] if r["hop"] == d]
        hops.append({
            "hop": d,
            "n": int(sum(r["n"] for r in rows)),
            **{k: round(_finite_mean([r[k] for r in rows]), 6)
               for k in ("median_ms", "p99_ms", "mean_ms", "tax_mean_ms")},
        })
    out["hops"] = hops
    return out


def _chain_run(sc: Scenario, backend: str, seed: int, rate: float,
               duration: float, fusion) -> Dict[str, object]:
    """One fresh-runtime chain run; records the core pool's busy time so
    fused and unfused runs can compare worker-side CPU cost."""
    sim = Simulator(seed=seed)
    rt = FaasdRuntime(sim, backend=backend, n_cores=sc.n_cores)
    _deploy_mix(rt, sc.functions)
    res = drive(rt, sc.load_spec(rate, duration, fusion=fusion))
    res["pool_busy_s"] = float(rt.cores.busy_time)
    return res


def _exec_chain(sc: Scenario, backend: str, duration_scale: float,
                smoke: bool) -> Dict[str, object]:
    """Chain mode: each admitted root arrival expands into its downstream
    hop tree (FunctionProfile.edges), so per-hop latency breakdowns and
    the per-hop platform tax land in the artifact.  When the scenario
    carries a FusionPlan that applies to this backend, a same-seed fused
    run rides along: fused hops skip gateway + netstack and execute
    inside the caller's sandbox, and the result block carries the
    fused-vs-unfused P99 and pool-efficiency comparison."""
    duration = max(0.5, sc.duration_s * duration_scale)
    rates = sc.rates_for(backend, smoke=smoke)
    if not rates:
        raise ValueError(
            f"scenario {sc.name!r} has no rate grid for backend "
            f"{backend!r}; add rates[{backend!r}] or a '*' fallback")
    rate = float(rates[0])
    per_seed: List[Dict[str, object]] = []
    fused_seed: List[Dict[str, object]] = []
    pooled: List[float] = []
    run_fused = sc.fusion is not None and sc.fusion.applies_to(backend)
    for seed in _seeds(sc, smoke):
        res = _chain_run(sc, backend, seed, rate, duration, fusion=None)
        pooled.extend(res["latencies_ms"])
        per_seed.append(res)
        if run_fused:
            fused_seed.append(_chain_run(sc, backend, seed, rate, duration,
                                         fusion=sc.fusion))
    chain = _pool_chain([r["chain"] for r in per_seed])
    out: Dict[str, object] = {
        "mode": "chain",
        "duration_s": duration,
        "rate_rps": rate,
        "arrival_kind": sc.arrival.kind,
        "n": int(sum(r["n"] for r in per_seed)),
        "median_ms": _mean([r["median_ms"] for r in per_seed]),
        "p99_ms": _mean([r["p99_ms"] for r in per_seed]),
        "mean_ms": _mean([r["mean_ms"] for r in per_seed]),
        "rejected": int(sum(r["rejected"] for r in per_seed)),
        "chain": chain,
        "hist": latency_histogram(pooled),
    }
    if fused_seed:
        fchain = _pool_chain([r["chain"] for r in fused_seed])
        busy_u = sum(r["pool_busy_s"] for r in per_seed)
        busy_f = sum(r["pool_busy_s"] for r in fused_seed)
        out["fusion"] = {
            "edges": [list(e) for e in sc.fusion.edges],
            "chain": fchain,
            "p99_improvement": round(
                chain["root_p99_ms"] / max(fchain["root_p99_ms"], 1e-9), 4),
            "median_improvement": round(
                chain["root_median_ms"]
                / max(fchain["root_median_ms"], 1e-9), 4),
            "pool_busy_unfused_s": round(busy_u, 6),
            "pool_busy_fused_s": round(busy_f, 6),
            "pool_efficiency": round(busy_u / max(busy_f, 1e-9), 4),
        }
    return out


_MODES = {"closed": _exec_closed, "open": _exec_open, "storm": _exec_storm,
          "mixed": _exec_mixed, "fleet": _exec_fleet, "chain": _exec_chain}


def _run_backend(item: Tuple[Scenario, str, float, bool]):
    """Worker entry point: one (scenario, backend) cell of the matrix."""
    sc, backend, duration_scale, smoke = item
    # simlint: allow[wall-clock] measures host elapsed time of the worker
    t0 = time.time()
    try:
        res = _MODES[sc.mode](sc, backend, duration_scale, smoke)
        # simlint: allow[wall-clock] elapsed_s reports host wall time
        res["elapsed_s"] = round(time.time() - t0, 2)
        return sc.name, backend, res, None
    except Exception:
        return sc.name, backend, None, traceback.format_exc()


# ---------------------------------------------------------------------------
# Paper-claim reductions.  Every builder works on the scenario's
# (baseline, treatment) pair — no backend names are hardcoded, so claims
# survive arbitrary backend matrices as long as the pair is part of them.


def _fig5_claims(base: dict, treat: dict) -> Dict[str, dict]:
    def red(key):
        return 100.0 * (1.0 - treat[key] / base[key])

    measured = {
        "e2e_median": red("median_ms"),
        "e2e_p99": red("p99_ms"),
        "exec_median": red("exec_median_ms"),
        "exec_p99": red("exec_p99_ms"),
    }
    return {f"{k}_reduction_pct": {"measured": round(v, 2),
                                   "paper": PAPER_FIG5[k],
                                   "delta": round(v - PAPER_FIG5[k], 2)}
            for k, v in measured.items()}


def _fig6_claims(base: dict, treat: dict) -> Dict[str, dict]:
    b_knee, t_knee = base["knee_rps"], treat["knee_rps"]
    ratio = t_knee / max(1.0, b_knee)
    claims = {
        "baseline_knee_rps": {"measured": b_knee},
        "treatment_knee_rps": {"measured": t_knee},
        "throughput_ratio": {
            "measured": round(ratio, 2), "paper": PAPER_FIG6["throughput_ratio"],
            "delta": round(ratio - PAPER_FIG6["throughput_ratio"], 2)},
    }
    # the baseline's knee row is tracked by index ("knee_row"), never by
    # re-matching the knee rate with float equality: search-generated
    # rates are not grid-aligned, and pooled multi-seed knees match no row
    b_at = (base["curve"][int(base["knee_row"])]
            if b_knee > 0 and base.get("knee_row") is not None else None)
    # only full-resolution rows may represent the treatment: a search
    # curve also holds short low-res bracket probes whose tails are
    # under-sampled (grid rows carry no "phase" and all qualify)
    t_curve = [r for r in treat["curve"] if r.get("phase") != "bracket"] \
        or treat["curve"]
    if b_at and t_curve and b_knee > 0:
        # latency comparison at ~1.3x the baseline's knee, as in the
        # paper — taken at the nearest measured treatment rate, which
        # the claim records since neither grids nor search probes are
        # guaranteed to have sampled that exact load
        target = b_knee * 1.3
        t_at = min(t_curve, key=lambda r: abs(r["nominal_rps"] - target))
        claims["latency_compare_rps"] = {
            "measured": round(float(t_at["nominal_rps"]), 1),
            "target": round(target, 1)}
        for key, short in (("median_ms", "median_speedup"),
                           ("p99_ms", "p99_speedup")):
            x = b_at[key] / t_at[key]
            claims[short] = {"measured": round(x, 2),
                             "paper": PAPER_FIG6[short],
                             "delta": round(x - PAPER_FIG6[short], 2)}
    return claims


def _coldstart_claims(base: dict, treat: dict) -> Dict[str, dict]:
    ti, bi = treat["single_deploy_ms"], base["single_deploy_ms"]
    return {
        "treatment_init_ms": {"measured": round(ti, 3),
                              "paper": PAPER_COLDSTART_JUNCTION_MS,
                              "delta": round(ti - PAPER_COLDSTART_JUNCTION_MS, 3)},
        "baseline_coldstart_ms": {"measured": round(bi, 3)},
        "coldstart_ratio": {"measured": round(bi / ti, 1)},
        "storm_speedup": {
            "measured": round(base["median_ms"] / treat["median_ms"], 1)},
    }


def _autoscale_claims(base: dict, treat: dict) -> Dict[str, dict]:
    """Scale-up reaction time (pressure onset -> new capacity ready): the
    control-plane metric the cold-start asymmetry buys (FaaSNet's
    provisioning-storm regime)."""
    b, t = base["autoscaler"], treat["autoscaler"]
    ratio = b["reaction_p50_ms"] / max(t["reaction_p50_ms"], 1e-9)
    return {
        "baseline_reaction_p50_ms": {"measured": round(b["reaction_p50_ms"], 3)},
        "treatment_reaction_p50_ms": {"measured": round(t["reaction_p50_ms"], 3)},
        "baseline_reaction_p99_ms": {"measured": round(b["reaction_p99_ms"], 3)},
        "treatment_reaction_p99_ms": {"measured": round(t["reaction_p99_ms"], 3)},
        "scaleup_reaction_ratio": {"measured": round(ratio, 1)},
        "baseline_cold_path_arrivals": {
            "measured": b["cold_path_arrivals"]},
        "treatment_cold_path_arrivals": {
            "measured": t["cold_path_arrivals"]},
    }


def _interference_claims(base: dict, treat: dict) -> Dict[str, dict]:
    """Warm-path P99 inflation while a provisioning storm shares the
    worker (cold/warm path coupling)."""
    b_inf, t_inf = base["warm_p99_inflation"], treat["warm_p99_inflation"]
    return {
        "baseline_warm_p99_inflation": {"measured": round(b_inf, 3)},
        "treatment_warm_p99_inflation": {"measured": round(t_inf, 3)},
        "interference_reduction": {"measured": round(b_inf / max(t_inf, 1e-9), 3)},
        "baseline_storm_total_ms": {
            "measured": round(base["storm_total_median_ms"], 3)},
        "treatment_storm_total_ms": {
            "measured": round(treat["storm_total_median_ms"], 3)},
    }


def _fleet_claims(base: dict, treat: dict) -> Dict[str, dict]:
    """FaaSNet-regime provisioning claim: tree distribution's
    time-to-full-capacity advantage over naive registry pulls during a
    fleet-wide storm, while warm-path P99 stays flat.  The headline
    speedup is the min over the claims pair — the gate holds for the
    *worst* of the two backends, not a favorable one."""
    b_fl, t_fl = base["fleet"], treat["fleet"]
    b_spd = b_fl.get("tree_provisioning_speedup", float("nan"))
    t_spd = t_fl.get("tree_provisioning_speedup", float("nan"))
    headline = min(b_spd, t_spd)

    def ttf(fl: dict, dist: str) -> float:
        v = next((v for v in fl["variants"]
                  if v["distribution"] == dist
                  and v["placement"] == fl["placement"]), None)
        return v.get("time_to_full_s", float("nan")) if v else float("nan")

    inflation = _finite_mean([base.get("warm_p99_inflation", float("nan")),
                              treat.get("warm_p99_inflation", float("nan"))])
    return {
        "fleet_tree_provisioning_speedup": {"measured": round(headline, 2)},
        "baseline_tree_speedup": {"measured": round(b_spd, 2)},
        "treatment_tree_speedup": {"measured": round(t_spd, 2)},
        "baseline_tree_time_to_full_s": {
            "measured": round(ttf(b_fl, "tree"), 4)},
        "baseline_naive_time_to_full_s": {
            "measured": round(ttf(b_fl, "naive"), 4)},
        "treatment_tree_time_to_full_s": {
            "measured": round(ttf(t_fl, "tree"), 4)},
        "treatment_naive_time_to_full_s": {
            "measured": round(ttf(t_fl, "naive"), 4)},
        "fleet_warm_p99_inflation": {"measured": round(inflation, 3)},
    }


def _chain_claims(base: dict, treat: dict) -> Dict[str, dict]:
    """Per-hop platform tax (hop latency minus exec span): the chain-tax
    claim is that the treatment's kernel-bypass datapath pays a fraction
    of the baseline's per-hop overhead, so deep pipelines compound the
    advantage."""
    b, t = base["chain"], treat["chain"]
    b_tax, t_tax = b["hop_tax_mean_ms"], t["hop_tax_mean_ms"]
    return {
        "baseline_hop_tax_ms": {"measured": round(b_tax, 4)},
        "treatment_hop_tax_ms": {"measured": round(t_tax, 4)},
        "chain_hop_tax_ratio": {"measured": round(b_tax / max(t_tax, 1e-9), 3)},
        "baseline_root_median_ms": {"measured": round(b["root_median_ms"], 4)},
        "treatment_root_median_ms": {"measured": round(t["root_median_ms"], 4)},
        "baseline_root_p99_ms": {"measured": round(b["root_p99_ms"], 4)},
        "treatment_root_p99_ms": {"measured": round(t["root_p99_ms"], 4)},
    }


def _chain_fusion_claims(base: dict, treat: dict) -> Dict[str, dict]:
    """Platform-side fusion claim: co-locating chain edges into the
    caller's sandbox removes per-hop gateway + netstack cost.  The
    headline improvement is measured on the *baseline* (containerd-class)
    backend, where per-hop overhead — and therefore the win — is
    largest."""
    b_f, t_f = base["fusion"], treat["fusion"]
    return {
        "chain_fusion_p99_improvement": {
            "measured": round(b_f["p99_improvement"], 3)},
        "treatment_fusion_p99_improvement": {
            "measured": round(t_f["p99_improvement"], 3)},
        "chain_fusion_pool_efficiency": {
            "measured": round(b_f["pool_efficiency"], 3)},
        "baseline_unfused_root_p99_ms": {
            "measured": round(base["chain"]["root_p99_ms"], 4)},
        "baseline_fused_root_p99_ms": {
            "measured": round(b_f["chain"]["root_p99_ms"], 4)},
        "baseline_median_improvement": {
            "measured": round(b_f["median_improvement"], 3)},
    }


_CLAIMS = {"fig5": _fig5_claims, "fig6": _fig6_claims,
           "coldstart": _coldstart_claims, "autoscale": _autoscale_claims,
           "interference": _interference_claims, "fleet": _fleet_claims,
           "chain": _chain_claims, "chain_fusion": _chain_fusion_claims}


def _claim_metric_rows(sc: Scenario, backends: Dict[str, dict],
                       claims: Dict[str, dict]) -> List[dict]:
    """Flat rows; names derive from the claims pair, so the default
    containerd/junctiond pair keeps the CSV metric names stable — with
    one deliberate rename: ``coldstart_junction_init`` is now
    ``coldstart_junctiond_init`` (pair-derived), so pre-rename artifacts
    need regenerating before they can serve as compare.py baselines."""
    base_name, treat_name = sc.claims_pair
    base, treat = backends[base_name], backends[treat_name]
    rows: List[dict] = []
    if sc.claims_kind == "fig5":
        rows += [
            metric_row(f"fig5_{base_name}_median",
                       base["median_ms"] * 1e3, "us e2e"),
            metric_row(f"fig5_{treat_name}_median",
                       treat["median_ms"] * 1e3, "us e2e"),
        ]
        for name, key in (("fig5_median_reduction", "e2e_median"),
                          ("fig5_p99_reduction", "e2e_p99"),
                          ("fig5_exec_median_reduction", "exec_median"),
                          ("fig5_exec_p99_reduction", "exec_p99")):
            cl = claims[f"{key}_reduction_pct"]
            rows.append(metric_row(name, cl["measured"],
                                   f"% vs paper {cl['paper']}%"))
    elif sc.claims_kind == "fig6":
        rows += [
            metric_row(f"fig6_{base_name}_sustainable_rps",
                       claims["baseline_knee_rps"]["measured"],
                       f"rps at p99<={sc.slo_p99_ms:.0f}ms"),
            metric_row(f"fig6_{treat_name}_sustainable_rps",
                       claims["treatment_knee_rps"]["measured"],
                       f"rps at p99<={sc.slo_p99_ms:.0f}ms"),
            metric_row("fig6_throughput_ratio",
                       claims["throughput_ratio"]["measured"], "x (paper ~10x)"),
        ]
        if "median_speedup" in claims:
            rows += [
                metric_row("fig6_median_speedup_at_load",
                           claims["median_speedup"]["measured"], "x (paper ~2x)"),
                metric_row("fig6_p99_speedup_at_load",
                           claims["p99_speedup"]["measured"], "x (paper ~3.5x)"),
            ]
    elif sc.claims_kind == "coldstart":
        rows += [
            metric_row(f"coldstart_{treat_name}_init",
                       claims["treatment_init_ms"]["measured"] * 1e3,
                       "us (paper 3.4ms)"),
            metric_row(f"coldstart_{base_name}",
                       claims["baseline_coldstart_ms"]["measured"] * 1e3, "us"),
            metric_row("coldstart_ratio",
                       claims["coldstart_ratio"]["measured"],
                       f"x {base_name}/{treat_name}"),
            metric_row("coldstart_storm_speedup",
                       claims["storm_speedup"]["measured"],
                       f"x, {treat['functions']} concurrent deploys"),
        ]
    elif sc.claims_kind == "autoscale":
        rows += [
            metric_row(f"autoscale_{base_name}_reaction",
                       claims["baseline_reaction_p50_ms"]["measured"],
                       "ms scale-up reaction p50"),
            metric_row(f"autoscale_{treat_name}_reaction",
                       claims["treatment_reaction_p50_ms"]["measured"],
                       "ms scale-up reaction p50"),
            metric_row("autoscale_reaction_ratio",
                       claims["scaleup_reaction_ratio"]["measured"],
                       f"x {base_name}/{treat_name}"),
        ]
    elif sc.claims_kind == "interference":
        rows += [
            metric_row(f"mixed_{base_name}_warm_p99_inflation",
                       claims["baseline_warm_p99_inflation"]["measured"],
                       "x warm p99 during/before storm"),
            metric_row(f"mixed_{treat_name}_warm_p99_inflation",
                       claims["treatment_warm_p99_inflation"]["measured"],
                       "x warm p99 during/before storm"),
            metric_row("mixed_interference_reduction",
                       claims["interference_reduction"]["measured"],
                       f"x {base_name}/{treat_name} p99 inflation"),
        ]
    elif sc.claims_kind == "chain":
        rows += [
            metric_row(f"chain_{base_name}_hop_tax",
                       claims["baseline_hop_tax_ms"]["measured"] * 1e3,
                       "us per-hop platform overhead"),
            metric_row(f"chain_{treat_name}_hop_tax",
                       claims["treatment_hop_tax_ms"]["measured"] * 1e3,
                       "us per-hop platform overhead"),
            metric_row("chain_hop_tax_ratio",
                       claims["chain_hop_tax_ratio"]["measured"],
                       f"x {base_name}/{treat_name} per-hop tax"),
        ]
    elif sc.claims_kind == "chain_fusion":
        rows += [
            metric_row("chain_fusion_p99_improvement",
                       claims["chain_fusion_p99_improvement"]["measured"],
                       f"x unfused/fused root p99 ({base_name})"),
            metric_row("chain_fusion_pool_efficiency",
                       claims["chain_fusion_pool_efficiency"]["measured"],
                       f"x unfused/fused pool busy-time ({base_name})"),
            metric_row(f"chain_fusion_{treat_name}_p99_improvement",
                       claims["treatment_fusion_p99_improvement"]["measured"],
                       "x unfused/fused root p99"),
        ]
    elif sc.claims_kind == "fleet":
        rows += [
            metric_row("fleet_tree_provisioning_speedup",
                       claims["fleet_tree_provisioning_speedup"]["measured"],
                       f"x naive/tree time-to-full, min over "
                       f"({base_name}, {treat_name})"),
            metric_row(f"fleet_{base_name}_tree_speedup",
                       claims["baseline_tree_speedup"]["measured"],
                       "x naive/tree time-to-full-capacity"),
            metric_row(f"fleet_{treat_name}_tree_speedup",
                       claims["treatment_tree_speedup"]["measured"],
                       "x naive/tree time-to-full-capacity"),
            metric_row("fleet_warm_p99_inflation",
                       claims["fleet_warm_p99_inflation"]["measured"],
                       "x warm p99 during/before the storm (tree, "
                       "pair mean)"),
        ]
    return rows


# ---------------------------------------------------------------------------


class ExperimentRunner:
    """Runs scenarios across the backend matrix, serially or in worker
    processes, and reduces results into one bench artifact."""

    def __init__(self, duration_scale: float = 1.0, smoke: bool = False,
                 workers: int = 0, verbose: bool = False):
        self.duration_scale = duration_scale
        self.smoke = smoke
        self.workers = workers
        self.verbose = verbose

    # -- execution --------------------------------------------------------
    def _execute(self, items: List[Tuple[Scenario, str, float, bool]]):
        if self.workers and self.workers > 1 and len(items) > 1:
            with multiprocessing.Pool(min(self.workers, len(items))) as pool:
                return pool.map(_run_backend, items)
        return [_run_backend(it) for it in items]

    def run_scenario(self, sc: Scenario) -> Dict[str, object]:
        doc = self.run_suite([sc], suite="adhoc")
        return doc["scenarios"][0]

    def run_suite(self, scenarios: Sequence[Scenario],
                  suite: str = "scenarios") -> Dict[str, object]:
        items = [(sc, backend, self.duration_scale, self.smoke)
                 for sc in scenarios for backend in sc.backends]
        # simlint: allow[wall-clock] suite wall_s measures host elapsed time
        t0 = time.time()
        raw = self._execute(items)
        by_name: Dict[str, Dict[str, dict]] = {}
        failures: List[Dict[str, str]] = []
        for name, backend, res, err in raw:
            if err is not None:
                failures.append({"scenario": name, "backend": backend,
                                 "error": err})
                if self.verbose:
                    print(f"  !! {name}/{backend} FAILED:\n{err}")
            else:
                by_name.setdefault(name, {})[backend] = res

        out_scenarios: List[Dict[str, object]] = []
        metrics: List[dict] = []
        for sc in scenarios:
            backends = by_name.get(sc.name, {})
            entry: Dict[str, object] = {
                "name": sc.name,
                "mode": sc.mode,
                "description": sc.description,
                "arrival_kind": sc.arrival.kind,
                "tags": list(sc.tags),
                "backend_set": sorted(sc.backends),
                "claims_pair": list(sc.claims_pair),
                "backends": backends,
            }
            if sc.autoscaler is not None:
                entry["autoscaler_spec"] = dataclasses.asdict(sc.autoscaler)
            pair_ok = all(b in backends for b in sc.claims_pair)
            if sc.claims_kind and pair_ok:
                base, treat = sc.claims_pair
                claims = _CLAIMS[sc.claims_kind](backends[base],
                                                 backends[treat])
                entry["claims"] = claims
                metrics.extend(_claim_metric_rows(sc, backends, claims))
            for backend, res in backends.items():
                if "median_ms" in res:
                    metrics.append(metric_row(
                        f"scn_{sc.name}_{backend}_median",
                        res["median_ms"] * 1e3, f"us ({sc.mode})"))
                    metrics.append(metric_row(
                        f"scn_{sc.name}_{backend}_p99",
                        res["p99_ms"] * 1e3, f"us ({sc.mode})"))
                if res.get("mode") == "open" and res.get("knee_rps"):
                    # knee-0 results (SLO infeasible at this duration,
                    # e.g. deep MMPP bursts in smoke windows) emit no row:
                    # a later nonzero knee would otherwise diff against a
                    # meaningless zero baseline, and a knee that *drops*
                    # to 0 shows up as a missing-metric regression anyway
                    metrics.append(metric_row(
                        f"scn_{sc.name}_{backend}_knee",
                        res["knee_rps"],
                        f"rps at p99<={sc.slo_p99_ms:g}ms"))
                if "autoscaler" in res:
                    metrics.append(metric_row(
                        f"scn_{sc.name}_{backend}_scaleup_reaction",
                        res["autoscaler"]["reaction_p50_ms"],
                        "ms pressure->capacity-ready p50"))
                if "redeploy_speedup" in res:
                    metrics.append(metric_row(
                        f"scn_{sc.name}_{backend}_redeploy_speedup",
                        res["redeploy_speedup"],
                        "x first-deploy/redeploy (snapshot restore)"))
                if res.get("mode") == "fleet":
                    fl = res["fleet"]
                    if "tree_provisioning_speedup" in fl:
                        metrics.append(metric_row(
                            f"scn_{sc.name}_{backend}_tree_provisioning"
                            f"_speedup",
                            fl["tree_provisioning_speedup"],
                            "x naive/tree storm time-to-full"))
                    for v in fl["variants"]:
                        primary = (v["placement"] == fl["placement"]
                                   and v["distribution"]
                                   == fl["distribution"])
                        # label each variant row by the axis it varies
                        label = (v["placement"]
                                 if v["placement"] != fl["placement"]
                                 else v["distribution"])
                        if "time_to_full_s" in v:
                            metrics.append(metric_row(
                                f"scn_{sc.name}_{backend}_"
                                f"{v['distribution']}_time_to_full",
                                v["time_to_full_s"] * 1e3,
                                "ms storm time to full capacity"))
                        if not primary and "time_to_full_s" not in v:
                            metrics.append(metric_row(
                                f"scn_{sc.name}_{backend}_{label}_p99",
                                v["p99_ms"] * 1e3, "us (fleet variant)"))
            probes = sum(res["search"]["n_probes"]
                         for res in backends.values() if "search" in res)
            if probes:
                # one row per scenario, not per backend: a benign +-1
                # probe shift on a 2-probe cell would trip compare.py's
                # relative threshold, while a systemic sampling-cost
                # change still moves the scenario total past it
                metrics.append(metric_row(
                    f"scn_{sc.name}_search_probes", probes,
                    "open-loop runs spent locating knees (all backends)"))
            out_scenarios.append(entry)

        meta = {
            "smoke": self.smoke,
            "workers": self.workers,
            # simlint: allow[wall-clock] wall_s reports host wall time
            "wall_s": round(time.time() - t0, 2),
            "n_scenarios": len(scenarios),
            "backends": sorted({b for sc in scenarios for b in sc.backends}),
        }
        return build_artifact(suite, out_scenarios, metrics, failures,
                              duration_scale=self.duration_scale, meta=meta)
