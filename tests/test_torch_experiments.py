"""The port's experiments tier (``repro_torch.experiments``: scenario specs,
the suites, the runner's modes and the artifact schema) against the JAX
package's ``repro.experiments``: the 14 cases of ``tests/test_experiments.py``,
each run on both packages and held equal float for float, then asserted as
the reference asserts them; every scenario of ``build_scenarios()`` equal to
the reference's, but the bodies of ``model-endpoint``, which are the
decode steps the H100 measured and no TPU figure.  The artifacts are
compared without the runner's host wall times (``elapsed_s``,
``meta.wall_s``), which no seed fixes, and with each failure's traceback cut
to its last line.  The whole smoke suite and the runner's worker pool are
in ``tests/test_torch_experiments_suite.py``."""
import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_core_compare import PKGS, both, raised, same, without_wall  # noqa: E402

import repro.experiments.suites as jsuites  # noqa: E402
import repro_torch.experiments.suites as tsuites  # noqa: E402

SUITES_PY = Path(tsuites.__file__)
# the decode steps of qwen3-1.7b and mixtral-8x7b (24 of 32 layers) that the
# port's ServingEngine measured at full width on an NVIDIA H100 80GB HBM3 at
# 700.00 W, each a replay of its captured CUDA graph (chip_smoke.py phases 5
# and 5b)
CARD_ENDPOINT_US = {"qwen3-1.7b": 5914.7, "mixtral-8x7b": 29577.0}


def _artifact(run):
    """``run(pkg)`` -> artifact on both packages, held equal without the
    host wall times; returns the port's."""
    return without_wall(both(lambda p: without_wall(run(p))))


# ---------------------------------------------------------------------------
# Arrival generators: fixed-seed determinism + shape of the stream.


def test_poisson_arrivals_deterministic_and_rate_correct():
    def run(p):
        pa = p.core.PoissonArrivals(2000.0)
        a = pa.times(np.random.default_rng(42), 2.0)
        b = pa.times(np.random.default_rng(42), 2.0)
        np.testing.assert_array_equal(a, b)
        return a.tolist(), pa.times(np.random.default_rng(43), 2.0).tolist()

    a, c = both(run)
    assert len(c) != len(a) or a != c
    assert 0.85 * 4000 <= len(a) <= 1.15 * 4000
    assert np.all(np.diff(a) >= 0) and a[-1] < 2.0


def test_bursty_arrivals_deterministic_and_burstier_than_poisson():
    def run(p):
        bp = p.core.BurstyArrivals(base_rps=200.0, burst_rps=8000.0)
        a = bp.times(np.random.default_rng(7), 2.0)
        np.testing.assert_array_equal(a, bp.times(np.random.default_rng(7), 2.0))
        pois = p.core.PoissonArrivals(bp.mean_rps()).times(np.random.default_rng(7), 2.0)
        return a.tolist(), pois.tolist()

    a, pois = both(run)
    # index of dispersion of interarrivals: MMPP >> Poisson (CV^2 = 1)
    gaps, gaps_p = np.diff(a), np.diff(pois)
    cv2_bursty = np.var(gaps) / np.mean(gaps) ** 2
    cv2_pois = np.var(gaps_p) / np.mean(gaps_p) ** 2
    assert cv2_bursty > 3.0 * cv2_pois


def test_diurnal_arrivals_follow_the_sinusoid():
    ts = np.array(both(lambda p: p.core.DiurnalArrivals(1000.0, amplitude=0.9, period_s=2.0)
                       .times(np.random.default_rng(0), 2.0).tolist()))
    # phase starts at the trough (t=0) and peaks mid-period (t=1): the
    # middle half of the window must carry most of the arrivals
    mid = int(np.sum((ts >= 0.5) & (ts < 1.5)))
    outer = len(ts) - mid
    assert mid > 2.0 * outer
    assert 0.8 * 2000 <= len(ts) <= 1.2 * 2000


def test_trace_replay_is_exact_and_clipped():
    def run(p):
        tr = p.core.TraceReplay((0.5, 0.1, 0.9, 1.4), time_scale=1.0)
        half = p.core.TraceReplay((0.5, 0.1, 0.9, 1.4), time_scale=0.5)
        return (tr.times(np.random.default_rng(0), 1.0).tolist(),
                half.times(np.random.default_rng(0), 1.0).tolist())

    full, half = both(run)
    np.testing.assert_allclose(full, [0.1, 0.5, 0.9])
    np.testing.assert_allclose(half, [0.05, 0.25, 0.45, 0.7])


def test_heavy_tailed_work_median_and_determinism():
    def run(p):
        s1 = p.core.heavy_tailed_work(np.random.default_rng(3), 100.0, alpha=1.5)
        xs = [s1() for _ in range(4000)]
        s2 = p.core.heavy_tailed_work(np.random.default_rng(3), 100.0, alpha=1.5)
        assert xs == [s2() for _ in range(4000)]
        return xs

    xs = np.array(both(run))
    assert 90.0 <= np.median(xs) <= 110.0
    assert xs.max() > 5 * np.median(xs)          # it is actually heavy-tailed
    assert xs.max() <= 100.0 * 200.0             # cap holds


# ---------------------------------------------------------------------------
# Mixed open-loop driver.


def test_mixed_open_loop_deterministic_and_per_fn():
    def once(p):
        rt = p.core.FaasdRuntime(p.core.Simulator(seed=11), backend="junctiond")
        rt.deploy_blocking(p.core.FunctionSpec(name="a"))
        rt.deploy_blocking(p.core.FunctionSpec(name="b"))
        return p.core.drive(rt, p.core.LoadSpec(p.core.PoissonArrivals(1200.0), ("a", "b"),
                                                weights=(0.8, 0.2), duration_s=0.4))

    def run(p):
        r1, r2 = once(p), once(p)
        same(r1, r2)
        return r1

    r1 = both(run)
    assert r1["n"] > 100
    assert set(r1["per_fn"]) == {"a", "b"}
    assert r1["per_fn"]["a"].n > r1["per_fn"]["b"].n
    assert r1["rejected"] == 0


def test_knee_of_curve_respects_slo_and_achieved():
    curve = [
        {"nominal_rps": 100.0, "offered_rps": 100, "achieved_rps": 99,
         "p99_ms": 2.0, "rejected": 0},
        {"nominal_rps": 200.0, "offered_rps": 200, "achieved_rps": 198,
         "p99_ms": 9.0, "rejected": 0},
        {"nominal_rps": 400.0, "offered_rps": 400, "achieved_rps": 120,
         "p99_ms": 5.0, "rejected": 0},        # fails achieved fraction
        {"nominal_rps": 800.0, "offered_rps": 800, "achieved_rps": 799,
         "p99_ms": 50.0, "rejected": 0},       # fails SLO
    ]
    assert both(lambda p: p.core.knee_of_curve(curve, slo_p99_ms=10.0)) == 200.0


# ---------------------------------------------------------------------------
# Artifact schema.


def test_artifact_schema_roundtrip(tmp_path):
    def run(p):
        ex = p.experiments
        sc = dataclasses.replace(ex.get_scenario("paper-fig5"), seeds=(0,), n_requests=30)
        doc = ex.ExperimentRunner(smoke=True).run_suite([sc], suite="unit")
        ex.validate_artifact(doc)
        path = tmp_path / f"BENCH_unit_{p.core.__name__}.json"
        ex.write_artifact(str(path), doc)
        loaded = json.loads(path.read_text())
        ex.validate_artifact(loaded)
        return loaded

    loaded = _artifact(run)
    assert loaded["suite"] == "unit"
    entry = loaded["scenarios"][0]
    assert entry["name"] == "paper-fig5"
    assert set(entry["backends"]) == {"containerd", "junctiond"}
    for res in entry["backends"].values():
        assert res["hist"]["counts"] and len(res["hist"]["edges_ms"]) == \
            len(res["hist"]["counts"]) + 1
    assert any(m["name"] == "fig5_median_reduction" for m in loaded["metrics"])
    assert loaded["failures"] == []


def test_validate_artifact_rejects_malformed():
    raised(ValueError, lambda p: p.experiments.validate_artifact({"schema_version": 1}),
           "missing top-level key")

    def doc(p, scenarios, metrics):
        return p.experiments.build_artifact("x", scenarios, metrics, [])

    raised(ValueError, lambda p: p.experiments.validate_artifact(
        doc(p, [{"name": "s"}], [p.experiments.metric_row("m", 1.0, "d")])), "missing 'mode'")
    raised(ValueError, lambda p: p.experiments.validate_artifact(
        doc(p, [], [{"name": "m"}])), "metrics")


def test_latency_histogram_handles_empty_and_counts():
    def run(p):
        return (p.experiments.latency_histogram([]),
                p.experiments.latency_histogram([0.1, 1.0, 10.0, 100.0], n_bins=8))

    empty, h = both(run)
    assert empty == {"edges_ms": [], "counts": []}
    assert sum(h["counts"]) == 4


# ---------------------------------------------------------------------------
# Runner modes + failure isolation.


def test_storm_mode_reports_deploy_and_invoke():
    def run(p):
        sc = dataclasses.replace(p.experiments.get_scenario("cold-start-storm"), seeds=(0,),
                                 storm_functions=4)
        return p.experiments.ExperimentRunner().run_scenario(sc)

    entry = _artifact(run)
    j = entry["backends"]["junctiond"]
    c = entry["backends"]["containerd"]
    assert j["n"] == c["n"] == 4
    assert j["single_deploy_ms"] == pytest.approx(3.4, rel=0.01)
    assert c["single_deploy_ms"] > 50 * j["single_deploy_ms"]
    assert entry["claims"]["storm_speedup"]["measured"] > 10


def test_runner_isolates_scenario_failures():
    def run(p):
        ex = p.experiments
        bad = dataclasses.replace(ex.get_scenario("paper-fig5"), name="bad",
                                  mode="bogus", seeds=(0,))  # unknown mode -> executor raises
        ok = dataclasses.replace(ex.get_scenario("paper-fig5"), seeds=(0,), n_requests=20)
        doc = ex.ExperimentRunner(smoke=True).run_suite([bad, ok], suite="unit")
        ex.validate_artifact(doc)
        return doc

    doc = _artifact(run)
    assert {f["scenario"] for f in doc["failures"]} == {"bad"}
    assert doc["scenarios"][1]["backends"]      # the good one still ran


def test_suite_registry_covers_required_scenarios():
    def run(p):
        reg = p.experiments.build_scenarios()
        names = {s.name for s in p.experiments.get_suite("scenarios")}
        return sorted(reg), sorted(names), [sorted(sc.backends)
                                            for sc in p.experiments.get_suite("smoke")]

    reg, names, smoke_backends = both(run)
    for required in ("paper-fig5", "paper-fig6", "cold-start-storm",
                     "multi-tenant-mix", "bursty-burst", "model-endpoint"):
        assert required in names and required in reg
    assert len(names) >= 6
    assert all(b == ["containerd", "junctiond"] for b in smoke_backends)


# ---------------------------------------------------------------------------
# Regression gate: the paper's headline throughput claim at smoke duration.


def test_fig6_throughput_ratio_regression_smoke():
    def run(p):
        ex = p.experiments
        return ex.ExperimentRunner(duration_scale=ex.SMOKE_DURATION_SCALE, smoke=True).run_suite(
            [ex.get_scenario("paper-fig6")], suite="unit")

    doc = _artifact(run)
    assert not doc["failures"], doc["failures"]
    ratio = next(m["value"] for m in doc["metrics"] if m["name"] == "fig6_throughput_ratio")
    assert ratio >= 5.0, f"fig6 throughput ratio regressed: {ratio}x < 5x"


# ---------------------------------------------------------------------------
# The scenarios, field for field; model-endpoint on the card's bodies.


def _scenario_names():
    return sorted(jsuites.build_scenarios())


@pytest.mark.parametrize("name", _scenario_names())
def test_scenario_equals_the_reference(name):
    """Every scenario is the reference's, field for field, but for
    ``model-endpoint``'s description and its two ``work_us``: the port's
    are the decode steps the card measured."""
    port = dataclasses.asdict(tsuites.build_scenarios()[name])
    ref = dataclasses.asdict(jsuites.build_scenarios()[name])
    assert sorted(tsuites.build_scenarios()) == _scenario_names()
    assert tsuites.SUITES == jsuites.SUITES
    assert tsuites.SMOKE_DURATION_SCALE == jsuites.SMOKE_DURATION_SCALE
    if name == "model-endpoint":
        assert [f["name"] for f in port["functions"]] == [f["name"] for f in ref["functions"]]
        assert {f["name"]: f["work_us"] for f in port["functions"]} == CARD_ENDPOINT_US
        for f in port["functions"] + ref["functions"]:
            del f["work_us"]
        del port["description"], ref["description"]
    same(port, ref, name)


def test_model_endpoint_takes_the_cards_bodies_and_no_tpu_figure():
    """No TPU number in the port's suites: no dry-run directory, no pod16x16
    record read, no analytic fallback table.  The two endpoint bodies are
    the card's, not the reference's TPU fallbacks (450 and 1800 us), and
    the table that holds them names the card and its power limit."""
    src = SUITES_PY.read_text()
    names = {n.id for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Name)}
    names |= {n.name for n in ast.walk(ast.parse(src)) if isinstance(n, ast.FunctionDef)}
    assert not names & {"_ENDPOINT_FALLBACK_US", "_DRYRUN_DIR", "_roofline_step_us"}
    assert "pod16x16" not in src and "dryrun" not in src
    assert "NVIDIA H100 80GB HBM3" in src and "700.00 W" in src
    port = {f.name: f.work_us for f in tsuites.get_scenario("model-endpoint").functions}
    ref = {f.name: f.work_us for f in jsuites.get_scenario("model-endpoint").functions}
    assert port == CARD_ENDPOINT_US
    assert all(port[n] != ref[n] for n in port), (port, ref)
    assert not hasattr(tsuites, "_ENDPOINT_FALLBACK_US")


def test_experiments_exports_match_the_reference():
    assert sorted(PKGS["torch"].experiments.__all__) == sorted(PKGS["jax"].experiments.__all__)
    assert sorted(PKGS["torch"].fleet.__all__) == sorted(PKGS["jax"].fleet.__all__)
