"""The port's six execution backends (``repro_torch.core``: containerd,
junctiond, quark, wasm, firecracker, gvisor) against the JAX package's
``repro.core``: the registry, the lifecycle conformance suite every backend
passes, the snapshot-cache contract of the backends that keep one, gVisor's
platform knob, the warm-latency and cold-start orderings, and the
property tests of ``tests/test_backend_properties.py``.  Then the port held
to the reference float for float on the same seeds, for every backend and
gVisor's ptrace platform: ``run_sequential``, ``drive`` on both engines, the
deploy/scale/query/remove timeline, and firecracker's snapshot cache.  Last,
the cases of ``tests/test_backends.py`` that run ``repro_torch.experiments``
over backend sets (the runner's matrix, the storm's redeploy wave, the
claims pair, the rate grids and the adaptive search, schemas v1-v6), each on
both packages and held equal; artifacts without the runner's host wall
times (``elapsed_s``, ``meta.wall_s``), which no seed fixes."""
import dataclasses
import json
import math
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_core_compare import (ENGINES, VARIANTS, both, counters, raised,  # noqa: E402
                                 records, runtime_of, same, same_runs, without_wall)

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import (ColdStartModel, FaasdRuntime, FunctionSpec,  # noqa: E402
                              LeadTimePolicy, PollingModel, QueueDepthPolicy, Simulator,
                              UnknownFunctionError, available_backends, get_backend_class,
                              register_backend, run_sequential)
from repro_torch.core.backends import _REGISTRY, SnapshotColdStartModel, resolve_backend  # noqa: E402
from repro_torch.core.firecracker import SnapshotCache  # noqa: E402
from repro_torch.core.gvisor import GVisor  # noqa: E402
from repro_torch.experiments import validate_artifact, write_artifact  # noqa: E402

ALL_BACKENDS = available_backends()
# the full isolation spectrum, ordered by warm-path latency
ORDERED = ("junctiond", "wasm", "containerd", "firecracker", "gvisor", "quark")
# the backends whose instances keep a per-function snapshot cache
SNAPSHOTTING = tuple(n for n in ALL_BACKENDS
                     if hasattr(get_backend_class(n)(Simulator()), "snapshots"))


def _drive(sim, gen):
    """Run one generator process to completion and return its result."""
    p = sim.process(gen)
    p.completion.callbacks.append(lambda _v: sim.stop())
    sim.run()
    assert p.done
    return p.result


def _runtime(backend, seed=0, **kw):
    return FaasdRuntime(Simulator(seed=seed), backend=backend, **kw)


# ---------------------------------------------------------------------------
# Registry.


def test_registry_contains_the_six_builtins():
    assert set(ALL_BACKENDS) >= set(ORDERED)
    assert SNAPSHOTTING == ("firecracker",)


def test_unknown_backend_name_lists_registered():
    with pytest.raises(ValueError, match="containerd.*junctiond"):
        get_backend_class("bogus")
    with pytest.raises(ValueError, match="unknown backend"):
        FaasdRuntime(Simulator(), backend="bogus")


def test_register_backend_rejects_duplicate_and_unnamed():
    containerd = get_backend_class("containerd")
    with pytest.raises(ValueError, match="already registered"):
        register_backend(type("Fake", (containerd,), {"name": "containerd"}))
    with pytest.raises(ValueError, match="non-empty"):
        register_backend(type("Anon", (containerd,), {"name": ""}))
    assert _REGISTRY["containerd"] is containerd    # registry unharmed


def test_custom_backend_registers_and_serves_traffic():
    wasm = get_backend_class("wasm")

    @register_backend
    class TurboTest(wasm):
        name = "turbo-test"
        coldstart = ColdStartModel(deploy_ms=0.1, scale_factor=0.5, query_ms=0.05)

        def __init__(self, sim, *, n_cores=4, polling_model=None):
            super().__init__(sim, n_cores=n_cores)

    try:
        assert "turbo-test" in available_backends()
        assert "turbo-test" not in jcore.available_backends()   # the registries are apart
        rt = _runtime("turbo-test")
        # the class's own constructor default wins when resolved by name
        assert rt.cores.n_cores == 4
        rt.deploy_blocking(FunctionSpec(name="f"))
        s = run_sequential(rt, "f", n=5)
        assert s.n == 5 and s.median_ms > 0
    finally:
        _REGISTRY.pop("turbo-test", None)


def test_runtime_accepts_backend_instance():
    sim = Simulator(seed=0)
    be = get_backend_class("containerd")(sim, n_cores=8)
    rt = FaasdRuntime(sim, backend=be)
    assert rt.backend is be and rt.manager is be
    assert rt.backend_name == "containerd"
    assert rt.cores.n_cores == 8
    assert resolve_backend(be, sim) is be


def test_backend_instance_must_match_simulator_and_config():
    sim = Simulator(seed=0)
    be = get_backend_class("containerd")(sim, n_cores=8)
    with pytest.raises(ValueError, match="different Simulator"):
        FaasdRuntime(Simulator(seed=1), backend=be)
    with pytest.raises(ValueError, match="configure the instance"):
        FaasdRuntime(sim, backend=be, n_cores=36)
    with pytest.raises(ValueError, match="configure the instance"):
        resolve_backend(be, sim, polling_model=PollingModel.CENTRALIZED)


# ---------------------------------------------------------------------------
# Lifecycle conformance: every registered backend, same semantics.


@pytest.mark.parametrize("name", ALL_BACKENDS)
def test_backend_declares_its_bundle(name):
    cls, ref = get_backend_class(name), jcore.get_backend_class(name)
    assert cls.name == name
    assert cls.runtime.name and cls.stack_costs.name
    assert cls.coldstart.deploy_ms > 0
    assert cls.coldstart.query_ms > 0
    # the same cost tables and cold-start class as the reference's
    same(cls.runtime, ref.runtime)
    same(cls.stack_costs, ref.stack_costs)
    same(cls.coldstart, ref.coldstart)


@pytest.mark.parametrize("name", ALL_BACKENDS)
def test_lifecycle_deploy_query_scale_remove(name):
    rt = _runtime(name)
    be, sim = rt.backend, rt.sim
    sched_before = len(be.scheduler.instances) if be.scheduler else None
    assert be.lookup("aes") is None

    rt.deploy_blocking(FunctionSpec(name="aes", scale=2))
    rec = be.lookup("aes")
    assert rec is not None and rec.ready and rec.replicas == 2
    assert be.deploys == 1

    t0 = sim.now
    assert _drive(sim, be.query("aes")) is rec
    assert sim.now - t0 == pytest.approx(be.coldstart.query_seconds)

    _drive(sim, be.scale("aes", 5))
    assert be.lookup("aes").replicas == 5
    _drive(sim, be.scale("aes", 1))
    assert be.lookup("aes").replicas == 1

    be.remove("aes")
    assert be.lookup("aes") is None
    assert _drive(sim, be.query("aes")) is None
    if sched_before is not None:
        assert len(be.scheduler.instances) == sched_before
    be.remove("aes")                      # idempotent teardown
    rt.deploy_blocking(FunctionSpec(name="aes"))
    assert be.lookup("aes").ready


@pytest.mark.parametrize("name", ALL_BACKENDS)
def test_redeploy_releases_old_resources(name):
    rt = _runtime(name)
    be = rt.backend
    sched_before = len(be.scheduler.instances) if be.scheduler else None
    rt.deploy_blocking(FunctionSpec(name="aes"))
    rt.deploy_blocking(FunctionSpec(name="aes", scale=2))
    assert be.deploys == 2
    assert be.lookup("aes").replicas == 2
    if sched_before is not None:
        assert len(be.scheduler.instances) == sched_before + 1


def test_junctiond_scale_to_zero_keeps_one_warm_uproc():
    rt = _runtime("junctiond")
    be = rt.backend
    rt.deploy_blocking(FunctionSpec(name="aes", scale=3))
    _drive(rt.sim, be.scale("aes", 0))
    rec = be.lookup("aes")
    assert rec.replicas == 0
    assert len(rec.instances[0].uprocs) == 1 and rec.ready


def test_junctiond_isolated_scale_reaps_sibling_instances():
    rt = _runtime("junctiond")
    be, sim = rt.backend, rt.sim
    base = len(be.scheduler.instances)
    _drive(sim, be.deploy("iso", scale=4, isolate_replicas=True))
    rec = be.lookup("iso")
    assert rec.isolated and len(rec.instances) == 4
    assert len(be.scheduler.instances) == base + 4

    t0 = sim.now
    _drive(sim, be.scale("iso", 1))
    assert rec.replicas == 1 and len(rec.instances) == 1
    assert len(be.scheduler.instances) == base + 1
    assert sim.now == t0                      # reaping costs no init time

    t0 = sim.now
    _drive(sim, be.scale("iso", 3))           # back up: full instance inits
    assert len(rec.instances) == 3 and rec.ready
    assert len(be.scheduler.instances) == base + 3
    assert sim.now - t0 == pytest.approx(2 * be.coldstart.deploy_seconds)

    be.remove("iso")
    assert len(be.scheduler.instances) == base


# ---------------------------------------------------------------------------
# Snapshot-cache lifecycle contract, for every backend that keeps one:
# deploy warms the snapshot, a redeploy restores from it, remove evicts it.


def _deploy_s(rt, fn="aes", **kw):
    t0 = rt.sim.now
    rt.deploy_blocking(FunctionSpec(name=fn, **kw))
    return rt.sim.now - t0


@pytest.mark.parametrize("name", SNAPSHOTTING)
def test_snapshot_deploy_warms_and_second_cold_start_is_cheaper(name):
    rt = _runtime(name)
    be = rt.backend
    assert "aes" not in be.snapshots
    first = _deploy_s(rt)
    assert "aes" in be.snapshots
    second = _deploy_s(rt)
    assert second < first
    assert be.lookup("aes").ready


@pytest.mark.parametrize("name", SNAPSHOTTING)
def test_snapshot_remove_evicts_and_redeploy_rewarms(name):
    rt = _runtime(name)
    be = rt.backend
    first = _deploy_s(rt)
    be.remove("aes")
    assert "aes" not in be.snapshots
    assert be.lookup("aes") is None
    again = _deploy_s(rt)
    assert again == pytest.approx(first)
    assert "aes" in be.snapshots
    second = _deploy_s(rt)
    assert second < again


@pytest.mark.parametrize("name", SNAPSHOTTING)
def test_snapshot_boot_pays_the_save_charge(name):
    rt = _runtime(name)
    cs = rt.backend.coldstart
    first = _deploy_s(rt)
    assert first == pytest.approx(cs.boot_seconds)
    assert cs.boot_seconds >= cs.deploy_seconds
    if cs.save_ms > 0:
        assert first > cs.deploy_seconds
        assert first == pytest.approx(cs.deploy_seconds + cs.save_seconds)
    second = _deploy_s(rt)
    assert second == pytest.approx(cs.restore_seconds)


def test_firecracker_restore_is_an_order_faster_than_boot():
    rt = _runtime("firecracker")
    boot = _deploy_s(rt)
    restore = _deploy_s(rt)
    assert boot / restore >= 10
    assert rt.backend.boots == 1 and rt.backend.restores == 1
    assert rt.backend.lookup("aes").restored


def test_firecracker_scale_up_restores_from_the_snapshot():
    rt = _runtime("firecracker")
    be, sim = rt.backend, rt.sim
    _deploy_s(rt)
    t0 = sim.now
    _drive(sim, be.scale("aes", 4))
    assert sim.now - t0 == pytest.approx(3 * be.coldstart.restore_seconds)
    assert be.lookup("aes").replicas == 4
    t0 = sim.now
    _drive(sim, be.scale("aes", 1))
    assert sim.now == t0
    assert be.lookup("aes").replicas == 1


def test_firecracker_snapshot_cache_capacity_evicts_lru():
    sim = Simulator(seed=0)
    be = get_backend_class("firecracker")(sim, snapshot_capacity=2)
    rt = FaasdRuntime(sim, backend=be)
    rt.deploy_blocking(FunctionSpec(name="a"))
    rt.deploy_blocking(FunctionSpec(name="b"))
    assert be.snapshots.get("a") is not None
    rt.deploy_blocking(FunctionSpec(name="c"))      # capacity 2: evicts b
    assert "a" in be.snapshots and "c" in be.snapshots
    assert "b" not in be.snapshots
    assert be.snapshots.evictions == 1
    t0 = sim.now
    _drive(sim, be.scale("b", 2))
    assert sim.now - t0 == pytest.approx(be.coldstart.boot_seconds)
    assert "b" in be.snapshots


def test_snapshot_cache_rejects_nonpositive_capacity():
    with pytest.raises(ValueError, match="capacity"):
        SnapshotCache(0)


def test_snapshot_coldstart_model_derives_scale_from_restore():
    m = SnapshotColdStartModel(deploy_ms=100.0, query_ms=1.0, restore_ms=4.0)
    assert m.scale_seconds == pytest.approx(m.restore_seconds) == 0.004
    assert m.scale_factor == pytest.approx(0.04)
    stale = SnapshotColdStartModel(deploy_ms=100.0, query_ms=1.0, restore_ms=4.0,
                                   scale_factor=0.6)
    assert stale.scale_factor == pytest.approx(0.04)
    with pytest.raises(ValueError, match="restore_ms"):
        SnapshotColdStartModel(deploy_ms=100.0, query_ms=1.0)
    with pytest.raises(ValueError, match="restore_ms"):
        SnapshotColdStartModel(deploy_ms=100.0, query_ms=1.0, restore_ms=200.0)
    assert tcore.SnapshotColdStartModel is SnapshotColdStartModel


def test_gvisor_platform_knob_selects_cost_tables():
    def median(platform):
        sim = Simulator(seed=0)
        rt = FaasdRuntime(sim, backend=GVisor(sim, platform=platform))
        rt.deploy_blocking(FunctionSpec(name="aes"))
        return run_sequential(rt, "aes", n=40).median_ms

    assert median("kvm") < median("ptrace")
    assert GVisor(Simulator(), platform="ptrace").runtime.name == "gvisor-ptrace"
    assert _runtime("gvisor").backend.runtime.name == "gvisor-kvm"
    with pytest.raises(ValueError, match="unknown gVisor platform"):
        GVisor(Simulator(), platform="hyperv")


@pytest.mark.parametrize("name", ALL_BACKENDS)
def test_scale_on_undeployed_raises_uniformly(name):
    rt = _runtime(name)
    with pytest.raises(UnknownFunctionError, match="ghost"):
        _drive(rt.sim, rt.backend.scale("ghost", 2))


@pytest.mark.parametrize("name", ALL_BACKENDS)
def test_warm_invocations_complete_with_ordered_timestamps(name):
    rt = _runtime(name)
    rt.deploy_blocking(FunctionSpec(name="aes"))
    run_sequential(rt, "aes", n=5)
    assert len(rt.records) == 5
    for r in rt.records:
        assert r.t_done > r.t_end_exec > r.t_start_exec > r.t_arrival


# ---------------------------------------------------------------------------
# Cross-backend orderings (the fig5-style sanity matrix).


def _fig5_median_ms(name, seeds=range(3), n=60):
    meds = []
    for seed in seeds:
        rt = _runtime(name, seed=seed)
        rt.deploy_blocking(FunctionSpec(name="aes"))
        meds.append(run_sequential(rt, "aes", n=n).median_ms)
    return float(np.mean(meds))


def test_fig5_style_warm_latency_ordering():
    med = {b: _fig5_median_ms(b) for b in ORDERED}
    assert (med["junctiond"] < med["wasm"] < med["containerd"]
            < med["firecracker"] < med["gvisor"] < med["quark"])


def test_coldstart_ordering_across_backends():
    def cold_s(name):
        rt = _runtime(name)
        t0 = rt.sim.now
        rt.deploy_blocking(FunctionSpec(name="f"))
        return rt.sim.now - t0

    cold = {b: cold_s(b) for b in ORDERED}
    assert cold["wasm"] < 1e-3
    assert (cold["wasm"] < cold["junctiond"] < cold["firecracker"]
            < cold["gvisor"] < cold["containerd"] < cold["quark"])
    assert cold["containerd"] / cold["junctiond"] > 50
    restore = get_backend_class("firecracker").coldstart.restore_seconds
    assert cold["junctiond"] < restore < cold["gvisor"]


# ---------------------------------------------------------------------------
# Properties (tests/test_backend_properties.py).


@pytest.mark.parametrize("name", ALL_BACKENDS)
def test_coldstart_timings_strictly_positive(name):
    cs = get_backend_class(name).coldstart
    assert cs.deploy_seconds > 0
    assert cs.scale_seconds > 0
    assert cs.query_seconds > 0
    if isinstance(cs, SnapshotColdStartModel):
        assert 0 < cs.restore_seconds < cs.deploy_seconds
        assert cs.scale_seconds == pytest.approx(cs.restore_seconds)


@pytest.mark.parametrize("name", ALL_BACKENDS)
def test_lead_time_period_in_band_for_every_registered_backend(name):
    pol = LeadTimePolicy()
    period = pol.control_period(get_backend_class(name).coldstart)
    assert pol.period_floor_s <= period <= pol.period_ceil_s
    assert period == jcore.LeadTimePolicy().control_period(
        jcore.get_backend_class(name).coldstart)


@settings(max_examples=30, deadline=None)
@given(name=st.sampled_from(ALL_BACKENDS), lo=st.integers(1, 6), extra=st.integers(0, 6),
       seed=st.integers(0, 1_000))
def test_property_scale_cost_monotone_in_replica_count(name, lo, extra, seed):
    """PROPERTY: scaling 1 -> lo never costs more than 1 -> lo + extra, and
    each cost equals the reference's."""
    hi = lo + extra

    def scale_cost(core, replicas):
        sim = core.Simulator(seed=seed)
        rt = core.FaasdRuntime(sim, backend=name)
        rt.deploy_blocking(core.FunctionSpec(name="f"))
        t0 = sim.now
        _drive(sim, rt.backend.scale("f", replicas))
        return sim.now - t0

    lo_s, hi_s = scale_cost(tcore, lo), scale_cost(tcore, hi)
    assert lo_s <= hi_s + 1e-12
    assert (lo_s, hi_s) == (scale_cost(jcore, lo), scale_cost(jcore, hi))


def _model(deploy_ms, scale_factor, query_ms):
    return ColdStartModel(deploy_ms=deploy_ms, scale_factor=scale_factor, query_ms=query_ms)


@settings(max_examples=200, deadline=None)
@given(deploy_ms=st.floats(1e-3, 1e6, allow_nan=False, allow_infinity=False),
       scale_factor=st.floats(0.0, 10.0, allow_nan=False),
       floor=st.floats(1e-4, 1.0, allow_nan=False),
       ceil_mult=st.floats(1.0, 1e3, allow_nan=False),
       lead_mult=st.floats(0.1, 10.0, allow_nan=False))
def test_property_lead_time_period_always_inside_clamp_band(
        deploy_ms, scale_factor, floor, ceil_mult, lead_mult):
    ceil = floor * ceil_mult
    pol = LeadTimePolicy(period_floor_s=floor, period_ceil_s=ceil, lead_mult=lead_mult)
    period = pol.control_period(_model(deploy_ms, scale_factor, 1.0))
    assert floor <= period <= ceil
    assert math.isfinite(period)


@settings(max_examples=200, deadline=None)
@given(deploy_ms=st.floats(1e-3, 1e6, allow_nan=False, allow_infinity=False),
       scale_factor=st.floats(0.0, 10.0, allow_nan=False),
       inflight=st.floats(0.0, 1e9, allow_nan=False),
       replicas=st.integers(0, 10_000),
       rate=st.floats(0.0, 1e6, allow_nan=False),
       min_replicas=st.integers(1, 8),
       extra=st.integers(0, 24),
       target=st.floats(0.1, 100.0, allow_nan=False))
def test_property_desired_replicas_always_clamped(
        deploy_ms, scale_factor, inflight, replicas, rate, min_replicas, extra, target):
    cs = _model(deploy_ms, scale_factor, 1.0)
    max_replicas = min_replicas + extra
    for pol in (QueueDepthPolicy(min_replicas=min_replicas, max_replicas=max_replicas,
                                 target_inflight_per_replica=target),
                LeadTimePolicy(min_replicas=min_replicas, max_replicas=max_replicas,
                               target_inflight_per_replica=target)):
        want = pol.desired(inflight=inflight, replicas=replicas, arrival_rate_rps=rate,
                           coldstart=cs)
        assert min_replicas <= want <= max_replicas


# ---------------------------------------------------------------------------
# The port against the reference, float for float, on every backend.


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("variant", VARIANTS)
def test_run_sequential_equals_repro_core(variant, seed):
    def run(core):
        rt = runtime_of(core, variant, seed=seed)
        rt.deploy_blocking(core.FunctionSpec("aes", work_us=81.3))
        return rt, core.run_sequential(rt, "aes", n=60)

    (jrt, js), (trt, ts) = run(jcore), run(tcore)
    same(ts, js)
    assert records(trt) == records(jrt) and ts.n == 60
    same(counters(trt), counters(jrt), "counters")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_drive_equals_repro_core(variant, engine):
    def run(core):
        rt = runtime_of(core, variant, seed=3)
        rt.deploy_blocking(core.FunctionSpec("aes"))
        rt.deploy_blocking(core.FunctionSpec("ep", work_us=900.0, payload_bytes=2048,
                                             response_bytes=4096))
        return rt, core.drive(rt, core.LoadSpec(
            arrivals=core.BurstyArrivals(base_rps=300.0, burst_rps=3000.0, mean_quiet_s=0.05,
                                         mean_burst_s=0.02),
            functions=("aes", "ep"), weights=(0.8, 0.2), duration_s=0.3, warmup_s=0.06),
            engine=engine)

    assert same_runs(run)["n"] > 50


def _timeline(core, variant):
    """Deploy, query, scale up and down, remove and redeploy, isolated
    replicas, and a warm call between: the clock after each step and the
    backend's record and counters."""
    rt = runtime_of(core, variant, seed=2)
    be, sim = rt.backend, rt.sim
    out = []

    def mark(label):
        rec = be.lookup("f")
        out.append((label, sim.now, None if rec is None else rec.replicas, be.deploys,
                    getattr(be, "boots", None), getattr(be, "restores", None)))

    rt.deploy_blocking(core.FunctionSpec("f", scale=2))
    mark("deploy")
    _drive(sim, be.query("f"))
    mark("query")
    for n in (5, 1, 3):
        _drive(sim, be.scale("f", n))
        mark(f"scale {n}")
    core.run_sequential(rt, "f", n=10)
    mark("warm")
    rt.deploy_blocking(core.FunctionSpec("f"))
    mark("redeploy")
    be.remove("f")
    mark("remove")
    rt.deploy_blocking(core.FunctionSpec("f", scale=3))
    mark("deploy again")
    _drive(sim, be.deploy("iso", scale=3, isolate_replicas=True))
    mark("isolated")
    return out, records(rt), counters(rt)


@pytest.mark.parametrize("variant", VARIANTS)
def test_lifecycle_timeline_equals_repro_core(variant):
    same(_timeline(tcore, variant), _timeline(jcore, variant))


def test_firecracker_snapshot_cache_equals_repro_core():
    """Capacity 2 under five functions: which boot, which restore, which
    snapshot each eviction drops, and when."""
    def run(core):
        sim = core.Simulator(seed=4)
        be = core.Firecracker(sim, snapshot_capacity=2)
        rt = core.FaasdRuntime(sim, backend=be)
        log = []
        for fn in ("a", "b", "a", "c", "b", "d", "a"):
            rt.deploy_blocking(core.FunctionSpec(fn))
            log.append((fn, sim.now, be.boots, be.restores, be.snapshots.evictions,
                        [f for f in "abcd" if f in be.snapshots], be.lookup(fn).restored))
        _drive(sim, be.scale("c", 3))
        be.remove("a")
        log.append(("end", sim.now, be.boots, be.restores, be.snapshots.evictions,
                    [f for f in "abcd" if f in be.snapshots], len(be.snapshots)))
        return log

    same(run(tcore), run(jcore))


# ---------------------------------------------------------------------------
# The experiments layer over arbitrary backend sets, against repro.experiments.

FOUR = ("containerd", "junctiond", "quark", "wasm")


def _suite_doc(make, smoke=True):
    """``make(experiments)`` -> scenario, run as a one-scenario suite on both
    packages; the artifacts held equal without the host wall times, the
    port's returned."""
    def run(p):
        ex = p.experiments
        return without_wall(ex.ExperimentRunner(smoke=smoke).run_suite([make(ex)],
                                                                        suite="unit"))
    return both(run)


def test_runner_four_backend_matrix_keeps_pair_claims(tmp_path):
    doc = _suite_doc(lambda ex: dataclasses.replace(
        ex.get_scenario("paper-fig5"), seeds=(0,), n_requests=25, backends=FOUR))
    validate_artifact(doc)
    entry = doc["scenarios"][0]
    assert set(entry["backends"]) == set(FOUR)
    assert entry["backend_set"] == sorted(FOUR)
    assert entry["claims_pair"] == ["containerd", "junctiond"]
    # paper-claim deltas still come from the baseline/treatment pair
    assert "e2e_median_reduction_pct" in entry["claims"]
    names = {m["name"] for m in doc["metrics"]}
    assert "fig5_median_reduction" in names
    for b in FOUR:                       # every backend lands in the flat table
        assert f"scn_paper-fig5_{b}_median" in names
    path = tmp_path / "BENCH_matrix.json"
    write_artifact(str(path), doc)
    validate_artifact(json.loads(path.read_text()))


def test_storm_measures_snapshot_restore_vs_full_boot():
    """The cold-start storm runs a redeploy wave: plain backends pay the
    same cold start again (speedup ~1x), firecracker restores from the
    snapshots the first wave warmed (>= 10x)."""
    doc = _suite_doc(lambda ex: dataclasses.replace(
        ex.get_scenario("cold-start-storm"), seeds=(0,), storm_functions=4,
        backends=("containerd", "firecracker")))
    assert not doc["failures"], doc["failures"]
    res = doc["scenarios"][0]["backends"]
    for r in res.values():
        assert r["redeploy_median_ms"] > 0
        assert r["single_redeploy_ms"] > 0
    assert res["containerd"]["redeploy_speedup"] == pytest.approx(1.0)
    assert res["firecracker"]["redeploy_speedup"] >= 10
    assert res["firecracker"]["single_redeploy_ms"] < res["containerd"]["single_redeploy_ms"]
    names = {m["name"]: m["value"] for m in doc["metrics"]}
    assert names["scn_cold-start-storm_firecracker_redeploy_speedup"] >= 10
    assert names["scn_cold-start-storm_containerd_redeploy_speedup"] == pytest.approx(1.0)


def test_runner_skips_claims_without_the_pair():
    doc = _suite_doc(lambda ex: dataclasses.replace(
        ex.get_scenario("paper-fig5"), seeds=(0,), n_requests=20, backends=("quark", "wasm")))
    validate_artifact(doc)
    entry = doc["scenarios"][0]
    assert set(entry["backends"]) == {"quark", "wasm"}
    assert "claims" not in entry
    assert all(not m["name"].startswith("fig5_") for m in doc["metrics"])


def test_open_mode_fails_loudly_without_a_rate_grid():
    """A *grid-mode* scenario (explicit ``rates``) run against a backend
    with neither an explicit grid nor a '*' fallback must fail its cell
    (caught in the artifact's failures) rather than emit a zero-sample
    result with NaN medians.  Search-mode scenarios never hit this: any
    backend can be searched."""
    def make(ex):
        anchor = ex.get_scenario("multi-tenant-mix")       # the pinned-grid anchor
        rates = {b: g for b, g in anchor.rates.items() if b != "*"}
        sc = dataclasses.replace(anchor, rates=rates, smoke_rates=None,
                                 backends=("containerd", "turbo"))
        assert sc.search_spec() is None                     # still grid mode
        return sc

    doc = _suite_doc(make)
    assert any(f["backend"] == "turbo" and "rate grid" in f["error"] for f in doc["failures"])


def test_validate_artifact_accepts_v1_and_v2_schemas():
    """Artifacts written by older commits (schema_version 1/2) must keep
    validating: they are the baselines of an artifact comparison."""
    def docs(p):
        ex = p.experiments
        v1 = ex.build_artifact("old", [{"name": "s", "mode": "closed",
                                        "description": "d", "backends": {}}],
                               [ex.metric_row("m", 1.0, "d")], [])
        v1["schema_version"] = 1
        v2 = dict(v1, schema_version=2)
        v2["scenarios"] = [dict(v1["scenarios"][0], backend_set=["containerd"])]
        return v1, [v2] + [dict(v2, schema_version=n) for n in (3, 4, 5, 6)]

    def run(p):
        v1, later = docs(p)
        p.experiments.validate_artifact(v1)          # no backend_set required
        for doc in later:
            p.experiments.validate_artifact(doc)
        return v1, later

    both(run)
    raised(ValueError, lambda p: p.experiments.validate_artifact(
        dict(docs(p)[0], schema_version=7)), "schema_version")


def test_rates_fall_back_to_wildcard_grid_with_warning():
    """The '*' fallback still works for unknown backends, but it is no
    longer silent when the scenario carries explicit per-backend grids: the
    warning names the backend that fell through."""
    def run(p):
        sc = p.experiments.get_scenario("multi-tenant-mix")
        assert sc.rates_for("junctiond") == (1500.0, 4000.0, 8000.0)
        with pytest.warns(RuntimeWarning, match="some-new-backend") as w1:
            assert sc.rates_for("some-new-backend") == sc.rates["*"]
        with pytest.warns(RuntimeWarning, match="multi-tenant-mix") as w2:
            assert sc.rates_for("some-new-backend", smoke=True) == sc.smoke_rates["*"]
        # fig6 carries no grids at all any more: the adaptive search is its
        # default, for every backend including unregistered future ones
        fig6 = p.experiments.get_scenario("paper-fig6")
        assert fig6.rates is None and fig6.search_spec() is not None
        return ([str(w.message) for w in w1], [str(w.message) for w in w2],
                fig6.search_spec(), sc.rates["*"], sc.smoke_rates["*"])

    both(run)


def test_wildcard_only_grid_stays_silent():
    """trace-replay's rate table is {'*': ...} by design (the trace fixes
    the rate); a deliberate one-grid-for-all must not warn."""
    def run(p):
        sc = p.experiments.get_scenario("trace-replay")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            return [sc.rates_for(b) for b in ORDERED]

    assert both(run) == [(0.0,)] * len(ORDERED)


@pytest.mark.parametrize("scenario", ["multi-tenant-mix", "mixed-cold-warm"])
def test_grid_scenarios_keep_knee_sized_backend_grids(scenario):
    """The two scenarios that still carry rate tables (the pinned-grid
    regression anchor and the mixed mode's warm rate) keep explicit
    per-backend entries sized to the measured knees instead of riding the
    '*' fallback (which reuses the containerd grid and often sits past
    quark's knee)."""
    def run(p):
        sc = p.experiments.get_scenario(scenario)
        return ({b: sc.rates_for(b) for b in ORDERED if b in sc.rates}, sc.rates,
                sc.smoke_rates)

    grids, rates, smoke_rates = both(run)
    for b in ("quark", "wasm", "firecracker", "gvisor"):
        assert b in rates, f"{scenario} missing explicit {b} grid"
        assert grids[b] != rates["*"]
        if smoke_rates:
            assert b in smoke_rates
    containerd = grids["containerd"]
    # interception/virtio taxes put every sandboxed knee at or below
    # containerd's on the same workload, with quark lowest of the four
    for b in ("quark", "firecracker", "gvisor"):
        assert max(grids[b]) <= max(containerd)
        assert min(grids[b]) <= min(containerd)
    assert max(grids["quark"]) < max(containerd)
    assert max(grids["gvisor"]) <= max(grids["firecracker"])


@pytest.mark.parametrize("scenario", ["paper-fig6", "bursty-burst",
                                      "diurnal-drift", "heavy-tail-mix",
                                      "autoscale-burst", "autoscale-diurnal"])
def test_open_scenarios_default_to_adaptive_search(scenario):
    """Every open-mode scenario except the pinned-grid anchor dropped its
    hand-sized six-backend grids: the adaptive knee search is the
    default, so registering backend #7 needs zero grid measurement."""
    def run(p):
        sc = p.experiments.get_scenario(scenario)
        assert sc.rates is None and sc.smoke_rates is None
        spec = sc.search_spec()
        assert spec is not None
        # trace replay stays grid-shaped by design: the trace fixes the rate
        assert p.experiments.get_scenario("trace-replay").search_spec() is None
        return spec, [spec.max_probes_for(smoke=s) for s in (True, False)], \
            [spec.rel_tol_for(smoke=s) for s in (True, False)]

    _, probes, tols = both(run)
    assert probes[0] <= probes[1]
    assert tols[0] >= tols[1]
