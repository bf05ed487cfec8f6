"""The port's control plane (``repro_torch.core.autoscaler`` and
``repro_torch.core.multitenant``) against the JAX package's: the policies
as pure functions, the autoscaler's backend-sourced replica truth and its
scale-event timeline, the per-backend reaction times, the driver's
observer hooks, multi-tenant hosting (``tests/test_multitenant_
autoscaler.py``), then the port's ``ScaleEvent`` lists, telemetry and
records under a burst on every backend, and ``run_zipf_workload``'s
results, equal to the reference's float for float on the same seeds.  Last,
the cases of ``tests/test_autoscaler.py`` that run ``repro_torch.experiments``
(``AutoscalerSpec``, schema v3, the ``autoscale-burst`` and
``mixed-cold-warm`` scenarios, the autoscale suite), each on both packages
and held equal; artifacts without the runner's host wall times
(``elapsed_s``, ``meta.wall_s``), which no seed fixes."""
import pytest

pytest.importorskip("torch")

from _torch_core_compare import (ENGINES, VARIANTS, both, raised, records,  # noqa: E402
                                 runtime_of, same, scale_events, without_wall)

import repro.core as jcore  # noqa: E402
import repro.core.multitenant as jmultitenant  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.multitenant as tmultitenant  # noqa: E402
from repro_torch.core import (Autoscaler, FaasdRuntime, FunctionSpec,  # noqa: E402
                              LeadTimePolicy, LoadSpec, PoissonArrivals, PollingModel,
                              QueueDepthPolicy, ScalePolicy, Simulator, available_backends,
                              drive, get_backend_class, run_sequential)
from repro_torch.core.multitenant import run_zipf_workload  # noqa: E402

ALL_BACKENDS = available_backends()
FOUR = ("containerd", "junctiond", "quark", "wasm")


def _runtime(backend, seed=0, **kw):
    return FaasdRuntime(Simulator(seed=seed), backend=backend, **kw)


def _autoscaled(backend, policy, fn="f", seed=0, **fn_kw):
    rt = _runtime(backend, seed=seed)
    rt.deploy_blocking(FunctionSpec(name=fn, **fn_kw))
    asc = Autoscaler(rt.sim, rt, policy)
    asc.run()
    return rt, asc


# ---------------------------------------------------------------------------
# Policies as pure functions.


def test_queue_depth_policy_hysteresis_band_holds_steady():
    pol = QueueDepthPolicy(target_inflight_per_replica=4.0, scale_down_hysteresis=0.5)
    cs = get_backend_class("junctiond").coldstart
    for load in (8, 12, 16):
        assert pol.desired(inflight=load, replicas=4, arrival_rate_rps=0.0, coldstart=cs) == 4
    assert pol.desired(inflight=17, replicas=4, arrival_rate_rps=0.0, coldstart=cs) == 8
    assert pol.desired(inflight=7, replicas=4, arrival_rate_rps=0.0, coldstart=cs) == 2


def test_policies_clamp_to_min_max():
    cs = get_backend_class("junctiond").coldstart
    for pol in (QueueDepthPolicy(min_replicas=2, max_replicas=4),
                LeadTimePolicy(min_replicas=2, max_replicas=4)):
        assert pol.desired(inflight=10_000, replicas=4, arrival_rate_rps=50_000.0,
                           coldstart=cs) == 4
        assert pol.desired(inflight=0, replicas=2, arrival_rate_rps=0.0, coldstart=cs) == 2
        assert isinstance(pol, ScalePolicy)


def test_lead_time_period_and_headroom_derive_from_coldstart():
    pol = LeadTimePolicy(target_inflight_per_replica=2.0)
    periods = {b: pol.control_period(get_backend_class(b).coldstart)
               for b in FOUR + ("firecracker", "gvisor")}
    assert periods["junctiond"] == periods["wasm"] == pol.period_floor_s
    assert periods["firecracker"] == pytest.approx(max(
        pol.period_floor_s,
        pol.lead_mult * get_backend_class("firecracker").coldstart.scale_seconds))
    assert periods["firecracker"] < pol.period_ceil_s
    assert periods["containerd"] == periods["quark"] == periods["gvisor"] == pol.period_ceil_s
    slow = get_backend_class("containerd").coldstart
    fast = get_backend_class("junctiond").coldstart
    want_slow = pol.desired(inflight=5, replicas=1, arrival_rate_rps=1000.0, coldstart=slow)
    want_fast = pol.desired(inflight=5, replicas=1, arrival_rate_rps=1000.0, coldstart=fast)
    assert want_slow == pol.max_replicas
    assert want_fast == 4               # ceil(5/2) + ceil(0.2/2) = 3 + 1


# ---------------------------------------------------------------------------
# Autoscaler: backend truth, state drift, off-critical-path scaling.


def test_replica_truth_comes_from_backend_lookup():
    rt, asc = _autoscaled("junctiond", QueueDepthPolicy(period_s=0.02))
    assert asc.replicas("f") == rt.backend.lookup("f").replicas == 1
    asc.inflight["f"] = 100
    rt.sim.run(until=0.5)
    assert asc.replicas("f") == rt.backend.lookup("f").replicas > 1
    assert asc.replicas("ghost") is None


def test_external_remove_produces_no_ghost_scale_events():
    rt, asc = _autoscaled("junctiond", QueueDepthPolicy(period_s=0.02))
    for _ in range(50):
        asc.on_arrival("f")
    rt.backend.remove("f")              # external remove, controller unaware
    rt.sim.run(until=0.2)
    assert asc.scale_events == []
    assert "f" not in asc.inflight
    assert "f" not in asc._pressure_t0
    rt.deploy_blocking(FunctionSpec(name="f"))
    for _ in range(50):
        asc.on_arrival("f")
    rt.sim.run(until=0.4)
    assert any(e.up for e in asc.scale_events)
    assert asc.replicas("f") == rt.backend.lookup("f").replicas


def test_scaling_stays_off_the_critical_path():
    def latencies(with_autoscaler):
        rt = _runtime("containerd", seed=3)
        rt.deploy_blocking(FunctionSpec(name="f"))
        if with_autoscaler:
            asc = Autoscaler(rt.sim, rt, QueueDepthPolicy(
                period_s=0.01, target_inflight_per_replica=0.5))
            asc.run()
            asc.inflight["f"] = 100
        run_sequential(rt, "f", n=40)
        return rt.latencies_ms()

    assert latencies(False) == latencies(True)


def test_scale_events_carry_request_decision_ready_timeline():
    rt, asc = _autoscaled("containerd", LeadTimePolicy(target_inflight_per_replica=2.0))
    sim = rt.sim
    t0 = sim.now
    for _ in range(10):
        asc.on_arrival("f")
    sim.run(until=t0 + 2.0)
    ups = [e for e in asc.scale_events if e.up]
    assert ups and ups[0].ready
    e = ups[0]
    assert e.t_request <= e.t_decision < e.t_ready
    assert e.t_decision == pytest.approx(t0 + 0.25)
    assert e.t_request == pytest.approx(t0)
    assert e.t_ready - e.t_decision == pytest.approx(rt.backend.coldstart.scale_seconds)
    assert e.cold_starts == e.to_replicas - e.from_replicas > 0
    tel = asc.telemetry()
    assert tel["policy"] == "lead-time"
    assert tel["n_scale_events"] == len(asc.scale_events)
    assert tel["cold_starts"] >= e.cold_starts
    assert tel["timeline"][0][2] == e.to_replicas


@pytest.mark.parametrize("name", ALL_BACKENDS)
def test_scale_up_reaction_time_tracks_coldstart_class(name):
    rt, asc = _autoscaled(name, LeadTimePolicy(target_inflight_per_replica=2.0), max_cores=8)
    asc.inflight["f"] = 3
    rt.sim.run(until=2.0)
    ups = [e for e in asc.scale_events if e.up and e.ready]
    assert len(ups) == 1
    assert ups[0].reaction_s == pytest.approx(
        rt.backend.coldstart.scale_seconds * ups[0].cold_starts)


def test_reaction_time_ordering_across_backends():
    def reaction_s(name):
        rt, asc = _autoscaled(name, LeadTimePolicy(target_inflight_per_replica=2.0),
                              max_cores=8)
        asc.inflight["f"] = 3
        rt.sim.run(until=2.0)
        return [e for e in asc.scale_events if e.up and e.ready][0].reaction_s

    r = {b: reaction_s(b) for b in FOUR + ("firecracker", "gvisor")}
    assert (r["junctiond"] < r["wasm"] < r["firecracker"]
            < r["gvisor"] < r["containerd"] <= r["quark"])
    assert r["containerd"] / r["junctiond"] > 100
    assert r["firecracker"] < 30 * r["junctiond"]
    assert r["containerd"] > 10 * r["firecracker"]


def test_reaction_time_not_inflated_by_stale_pressure():
    rt, asc = _autoscaled("junctiond", LeadTimePolicy(
        target_inflight_per_replica=2.0, max_replicas=2), max_cores=8)
    sim = rt.sim
    t0 = sim.now
    asc.inflight["f"] = 100
    sim.run(until=t0 + 0.2)
    asc.inflight["f"] = 0
    sim.run(until=t0 + 1.2)
    assert "f" not in asc._pressure_t0
    n_before = len(asc.scale_events)
    asc.inflight["f"] = 100
    sim.run(until=t0 + 1.5)
    ups = [e for e in asc.scale_events[n_before:] if e.up and e.ready]
    assert ups
    assert ups[0].reaction_s < 0.1


def test_cold_path_arrivals_counted_while_scaleup_in_flight():
    rt, asc = _autoscaled("containerd", LeadTimePolicy(target_inflight_per_replica=2.0))
    sim = rt.sim

    def load():
        for _ in range(40):
            asc.on_arrival("f")
            yield sim.timeout(0.02)

    sim.process(load())
    sim.run(until=2.0)
    assert any(e.up for e in asc.scale_events)
    assert asc.cold_path_arrivals > 0
    assert asc.cold_path_arrivals == asc.telemetry()["cold_path_arrivals"]


# ---------------------------------------------------------------------------
# Workload-driver hooks.


class _TapObserver:
    """Minimal SimObserver recording every hook dispatch."""

    def __init__(self):
        self.events = []

    def on_arrival(self, fn_name):
        self.events.append(("arr", fn_name))

    def on_done(self, fn_name):
        self.events.append(("done", fn_name))


def test_open_loop_drivers_feed_hooks_balanced():
    rt = _runtime("junctiond", seed=5)
    rt.deploy_blocking(FunctionSpec(name="f"))
    obs = _TapObserver()
    drive(rt, LoadSpec.single("f", 500.0, duration_s=0.3, warmup_s=0.1), observer=obs)
    arrs = [e for e in obs.events if e[0] == "arr"]
    dones = [e for e in obs.events if e[0] == "done"]
    assert len(arrs) > 50 and len(arrs) == len(dones)
    assert {fn for _, fn in obs.events} == {"f"}


def test_mixed_open_loop_hooks_see_the_picked_function():
    rt = _runtime("junctiond", seed=6)
    rt.deploy_blocking(FunctionSpec(name="a"))
    rt.deploy_blocking(FunctionSpec(name="b"))
    obs = _TapObserver()
    res = drive(rt, LoadSpec(PoissonArrivals(800.0), ("a", "b"), weights=(0.7, 0.3),
                             duration_s=0.3), observer=obs)
    counts = {}
    for kind, fn in obs.events:
        if kind == "arr":
            counts[fn] = counts.get(fn, 0) + 1
    assert set(counts) == {"a", "b"}
    assert counts["a"] > counts["b"]
    assert sum(counts.values()) >= res["n"]     # hooks fire pre-warmup too


# ---------------------------------------------------------------------------
# Multi-tenant hosting (tests/test_multitenant_autoscaler.py).


def test_centralized_hosts_more_functions_than_per_instance():
    cen = run_zipf_workload("junctiond", n_functions=64, total_rps=600, duration_s=0.4)
    per = run_zipf_workload("junctiond", n_functions=64, total_rps=600, duration_s=0.4,
                            polling=PollingModel.PER_INSTANCE)
    assert cen.hosted == 64
    assert per.hosted < 64
    assert cen.cores_for_work > per.cores_for_work


def test_cold_tier_latency_not_penalised():
    r = run_zipf_workload("junctiond", n_functions=32, total_rps=1000, duration_s=0.6)
    assert r.cold_tier.n > 0
    assert r.cold_tier.median_ms < r.overall.median_ms * 1.5


def test_autoscaler_scales_up_and_down():
    sim = Simulator(seed=0)
    rt = FaasdRuntime(sim, backend="junctiond")
    rt.deploy_blocking(FunctionSpec(name="f", work_us=2000.0, max_cores=8))
    asc = Autoscaler(sim, rt, QueueDepthPolicy(period_s=0.05, target_inflight_per_replica=2.0))
    asc.run()

    def burst():
        for _ in range(600):
            yield sim.timeout(0.0001)           # 10k rps burst of 2ms calls

            def one():
                asc.on_arrival("f")
                yield from rt.invoke("f")
                asc.on_done("f")

            sim.process(one())

    sim.process(burst())
    sim.run(until=1.0)
    ups = [e for e in asc.scale_events if e.up]
    downs = [e for e in asc.scale_events if not e.up]
    assert ups, "autoscaler never scaled up under a 2000rps burst"
    assert downs, "autoscaler never scaled back down after the burst"
    assert asc.replicas("f") == rt.backend.lookup("f").replicas >= 1
    for e in ups:
        if e.ready:
            assert e.t_ready >= e.t_decision >= e.t_request


def test_autoscaler_respects_bounds():
    sim = Simulator(seed=0)
    rt = FaasdRuntime(sim, backend="junctiond")
    rt.deploy_blocking(FunctionSpec(name="f"))
    asc = Autoscaler(sim, rt, QueueDepthPolicy(min_replicas=1, max_replicas=4, period_s=0.02))
    asc.run()
    asc.inflight["f"] = 10_000
    sim.run(until=1.0)
    assert asc.replicas("f") == rt.backend.lookup("f").replicas <= 4


# ---------------------------------------------------------------------------
# The port against the reference, float for float.


def _burst(core, variant, engine, policy_of):
    """A bursty load through ``drive`` with an autoscaler as its observer."""
    rt = runtime_of(core, variant, seed=11)
    rt.deploy_blocking(core.FunctionSpec("aes", work_us=90.0, max_cores=8))
    asc = core.Autoscaler(rt.sim, rt, policy_of(core))
    asc.run()
    res = core.drive(rt, core.LoadSpec(
        arrivals=core.BurstyArrivals(base_rps=300.0, burst_rps=12000.0, mean_quiet_s=0.1,
                                     mean_burst_s=0.03),
        functions=("aes",), duration_s=0.6, warmup_s=0.1), observer=asc, engine=engine)
    return res, scale_events(asc), asc.telemetry(), records(rt), rt.backend.lookup("aes").replicas


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_scale_events_under_a_burst_equal_repro_core(variant, engine):
    def lead(core):
        return core.LeadTimePolicy(target_inflight_per_replica=2.0)

    tres = _burst(tcore, variant, engine, lead)
    same(tres, _burst(jcore, variant, engine, lead))
    assert any(e["to_replicas"] > e["from_replicas"] for e in tres[1])


@pytest.mark.parametrize("backend", ["containerd", "junctiond"])
def test_queue_depth_scale_events_equal_repro_core(backend):
    def queue(core):
        return core.QueueDepthPolicy(period_s=0.02, target_inflight_per_replica=1.0)

    tres = _burst(tcore, backend, "events", queue)
    same(tres, _burst(jcore, backend, "events", queue))
    assert tres[1]


@pytest.mark.parametrize("polling", ["centralized", "per_instance"])
@pytest.mark.parametrize("backend", ["junctiond", "containerd", "wasm"])
def test_run_zipf_workload_equals_repro_core(backend, polling):
    kw = dict(n_functions=24, total_rps=800.0, duration_s=0.3, seed=2)
    tres = tmultitenant.run_zipf_workload(backend, polling=tcore.PollingModel(polling), **kw)
    jres = jmultitenant.run_zipf_workload(backend, polling=jcore.PollingModel(polling), **kw)
    same(tres, jres)
    assert tres.overall.n > 100


# ---------------------------------------------------------------------------
# AutoscalerSpec + schema v3, against repro.experiments.


def test_autoscaler_spec_builds_policies():
    def run(p):
        ex = p.experiments
        pol = ex.AutoscalerSpec(policy="queue-depth", period_s=0.1, max_replicas=8).build()
        assert isinstance(pol, p.core.QueueDepthPolicy)
        lead = ex.AutoscalerSpec(policy="lead-time", lead_mult=3.0).build()
        assert isinstance(lead, p.core.LeadTimePolicy)
        return vars(pol), vars(lead)

    pol, lead = both(run)
    assert pol["period_s"] == 0.1 and pol["max_replicas"] == 8
    assert lead["lead_mult"] == 3.0
    raised(ValueError, lambda p: p.experiments.AutoscalerSpec(policy="bogus").build(),
           "unknown autoscaler policy")


def test_schema_v3_validates_autoscaler_blocks():
    good_block = {"policy": "lead-time", "n_scale_events": 3,
                  "cold_starts": 2, "cold_path_arrivals": 5,
                  "reaction_p50_ms": 1.5}

    def doc(p, block, metrics=()):
        ex = p.experiments
        return ex.build_artifact("unit", [{
            "name": "s", "mode": "open", "description": "d",
            "backend_set": ["junctiond"],
            "backends": {"junctiond": {"autoscaler": block}}}],
            [ex.metric_row(*m) for m in metrics], [])

    def run(p):
        assert p.experiments.artifacts.SCHEMA_VERSION == 6
        good = doc(p, good_block, [("m", 1.0, "d")])
        p.experiments.validate_artifact(good)
        bad = doc(p, {"policy": "lead-time"})
        bad["schema_version"] = 2                 # v2 documents never required the keys
        p.experiments.validate_artifact(bad)
        return good, bad

    both(run)
    for version in (None, 3):
        def check(p, version=version):
            bad = doc(p, {"policy": "lead-time"})
            if version is not None:               # v3 documents require the block's keys too
                bad["schema_version"] = version
            p.experiments.validate_artifact(bad)
        raised(ValueError, check, "autoscaler missing")


def _smoke_scenario_doc(name):
    """One scenario at a third of its duration, smoke rates, on both
    packages; the artifacts held equal without the host wall times."""
    def run(p):
        ex = p.experiments
        doc = ex.ExperimentRunner(duration_scale=0.33, smoke=True).run_suite(
            [ex.get_scenario(name)], suite="unit")
        ex.validate_artifact(doc)
        return without_wall(doc)
    return both(run)


def test_autoscale_burst_claims_favor_junctiond():
    doc = _smoke_scenario_doc("autoscale-burst")
    assert not doc["failures"], doc["failures"]
    entry = doc["scenarios"][0]
    assert entry["autoscaler_spec"]["policy"] == "lead-time"
    for backend, res in entry["backends"].items():
        block = res["autoscaler"]
        assert block["n_scale_events"] > 0, f"{backend} never scaled"
        assert block["reactions_ms"]
        assert block["timeline"]
        assert any(r.get("scale_events") for r in res["curve"])
    claims = entry["claims"]
    assert claims["scaleup_reaction_ratio"]["measured"] > 1.0
    names = {m["name"]: m["value"] for m in doc["metrics"]}
    assert names["autoscale_reaction_ratio"] > 1.0
    assert "scn_autoscale-burst_junctiond_scaleup_reaction" in names


def test_mixed_cold_warm_measures_interference_with_telemetry():
    doc = _smoke_scenario_doc("mixed-cold-warm")
    assert not doc["failures"], doc["failures"]
    entry = doc["scenarios"][0]
    for res in entry["backends"].values():
        assert res["mode"] == "mixed"
        assert res["warm_p99_before_ms"] > 0
        assert res["warm_p99_during_ms"] > 0
        assert res["storm_deploy_median_ms"] > 0
        assert res["autoscaler"]["n_scale_events"] > 0
    claims = entry["claims"]
    assert claims["baseline_warm_p99_inflation"]["measured"] > 0
    # the storm itself resolves orders of magnitude faster on junctiond
    assert (claims["baseline_storm_total_ms"]["measured"]
            > 10 * claims["treatment_storm_total_ms"]["measured"])


def test_autoscale_suite_and_smoke_cover_the_new_scenarios():
    def run(p):
        ex = p.experiments
        trio = ex.get_suite("autoscale")
        assert all(s.autoscaler is not None for s in trio)
        return {s.name for s in ex.get_suite("smoke")}, trio

    smoke, trio = both(run)
    assert {"autoscale-burst", "autoscale-diurnal", "mixed-cold-warm"} <= smoke
    assert {s.mode for s in trio} == {"open", "mixed"}
