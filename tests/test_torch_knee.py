"""The port's SLO-knee search and sustainable throughput (``KneeSearch``,
``knee_of_curve``, ``knee_index_of_curve``, ``sustainable_throughput``: the
paper's Fig 6) against the JAX package's ``repro.core`` on the same seeds,
held to exact equality of every probe, trace, knee and curve row."""
import math

import pytest

pytest.importorskip("torch")

from _torch_core_compare import BACKENDS, CORES, same  # noqa: E402

from repro_torch.core import (FunctionSpec, KneeSearch,  # noqa: E402
                              knee_index_of_curve, knee_of_curve, sustainable_throughput)


def _synthetic_probe(true_knee, log):
    """An analytic curve with a sharp knee and the throughput collapse of
    deep overload; logs every probe."""
    def probe(rate, phase):
        over = rate > true_knee
        comp = min(rate, true_knee) if rate <= 2 * true_knee else 0.3 * true_knee
        log.append((rate, phase))
        return {"p99_ms": 2.0 if not over else 40.0 * rate / true_knee,
                "achieved_rps": min(rate, true_knee * 1.1), "completion_rps": comp,
                "completed_frac": 1.0 if not over else 0.4, "rejected": 0, "median_ms": 1.0}
    return probe


def _result(res):
    return {"knee": res.knee_rps, "lo": res.lo_rps, "hi": res.hi_rps,
            "n": res.n_probes, "converged": res.converged, "trace": res.trace,
            "knee_index": res.knee_trace_index()}


@pytest.mark.parametrize("kw", [
    dict(true_knee=230.0, rate0=500.0), dict(true_knee=1250.0, rate0=4000.0),
    dict(true_knee=12700.0, rate0=500.0), dict(true_knee=1250.0, rate0=100.0, max_probes=5),
    dict(true_knee=1250.0, rate0=800.0, max_probes=1),
    dict(true_knee=1e9, rate0=1000.0, rate_ceiling=8000.0),
    dict(true_knee=1.0, rate0=1000.0),
], ids=["low", "high-start", "far", "budget", "one-probe", "ceiling", "nothing"])
def test_knee_search_on_a_synthetic_curve_matches_repro_core(kw):
    kw = dict(kw)
    true_knee = kw.pop("true_knee")
    out, logs = {}, {}
    for name, core in CORES.items():
        logs[name] = []
        out[name] = _result(core.KneeSearch(_synthetic_probe(true_knee, logs[name]),
                                            slo_p99_ms=10.0, **kw).run())
    same(out["torch"], out["jax"])
    assert logs["torch"] == logs["jax"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_knee_search_with_a_drive_probe_matches_repro_core(backend):
    """The Fig 6 search: each probe a fresh runtime and one ``drive`` of
    Poisson AES, bracketing probes at half the duration."""
    out = {}
    for name, core in CORES.items():
        def probe(rate, phase, core=core):
            rt = core.FaasdRuntime(core.Simulator(seed=3), backend=backend, n_cores=10)
            rt.deploy_blocking(core.FunctionSpec(name="aes", max_cores=8))
            return core.drive(rt, core.LoadSpec.single(
                "aes", rate, duration_s=0.2 if phase == "bracket" else 0.4, warmup_frac=0.2))
        out[name] = _result(core.KneeSearch(probe, slo_p99_ms=10.0, rate0=2000.0,
                                            max_probes=8).run())
    same(out["torch"], out["jax"])
    assert out["torch"]["knee"] > 0


@pytest.mark.parametrize("kw", [
    dict(growth=1.0), dict(shrink=1.0), dict(shrink=0.0), dict(rel_tol=0.0),
    dict(max_probes=0), dict(rate_floor=0.0), dict(rate_floor=10.0, rate_ceiling=5.0),
])
def test_knee_search_validation_matches_repro_core(kw):
    errors = {}
    for name, core in CORES.items():
        with pytest.raises(ValueError) as err:
            core.KneeSearch(lambda r, p: {}, 10.0, **kw)
        errors[name] = str(err.value)
    assert errors["torch"] == errors["jax"]


CURVE = [
    {"nominal_rps": 250.0, "offered_rps": 251.0, "p99_ms": 3.0, "achieved_rps": 249.0,
     "rejected": 0},
    {"nominal_rps": 1000.0, "offered_rps": 990.0, "p99_ms": 9.0, "achieved_rps": 900.0,
     "rejected": 0},
    {"nominal_rps": 2000.0, "offered_rps": 2010.0, "p99_ms": 9.5, "achieved_rps": 1500.0,
     "rejected": 0},
    {"nominal_rps": 1500.0, "offered_rps": 1500.0, "p99_ms": 8.0, "achieved_rps": 1450.0,
     "rejected": 1},
    {"nominal_rps": 0.0, "offered_rps": 1200.0, "p99_ms": 7.0, "achieved_rps": 1190.0,
     "rejected": 0},
    {"nominal_rps": 4000.0, "offered_rps": 4000.0, "p99_ms": math.nan, "achieved_rps": 0.0,
     "rejected": 0},
]


@pytest.mark.parametrize("slo,frac", [(10.0, 0.85), (8.5, 0.85), (10.0, 0.5), (1.0, 0.85)])
def test_knee_of_curve_matches_repro_core(slo, frac):
    for name in ("knee_of_curve", "knee_index_of_curve"):
        got = {n: getattr(core, name)(CURVE, slo, frac) for n, core in CORES.items()}
        assert got["torch"] == got["jax"], name
    idx = knee_index_of_curve(CURVE, slo, frac)
    assert knee_of_curve(CURVE, slo, frac) == (0.0 if idx is None else
                                               CURVE[idx]["nominal_rps"] or
                                               CURVE[idx]["offered_rps"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_sustainable_throughput_matches_repro_core(backend):
    """Fig 6 as the paper runs it: AES's default 25 us body, the default
    grid of 250 to 24000 rps, a fresh runtime per rate, a 50 ms p99 SLO."""
    out = {name: core.sustainable_throughput(backend) for name, core in CORES.items()}
    same(out["torch"], out["jax"])
    assert out["torch"]["sustainable_rps"] == {"containerd": 1000, "junctiond": 12000}[backend]
    assert [r["offered_rps"] for r in out["torch"]["curve"]] == [
        250, 500, 1000, 2000, 4000, 8000, 12000, 16000, 20000, 24000]


@pytest.mark.parametrize("backend", BACKENDS)
def test_sustainable_throughput_of_a_measured_body_matches_repro_core(backend):
    """A body of the H100-measured size on a grid of a model endpoint's
    shape (rates from 0.1 to 0.6 of the cores' rate, an SLO of 2 x the
    body), as the chip smoke run's phase 8 sweeps them."""
    work_us, n_cores = 20000.0, 4
    rates = [round(f * n_cores / (work_us * 1e-6), 6) for f in (0.1, 0.2, 0.4, 0.6)]
    out = {name: core.sustainable_throughput(backend, core.FunctionSpec("m", work_us=work_us),
                                             slo_p99_ms=2 * work_us / 1e3, rates=rates,
                                             n_cores=n_cores, seed=1)
           for name, core in CORES.items()}
    same(out["torch"], out["jax"])
    assert out["torch"]["sustainable_rps"] > 0


def test_knee_search_repeats_and_a_100us_aes_body_keeps_the_knee():
    runs = [_result(KneeSearch(_synthetic_probe(900.0, []), 10.0, rate0=500.0).run())
            for _ in range(2)]
    same(runs[0], runs[1])
    assert sustainable_throughput("junctiond", FunctionSpec("aes", work_us=100.0),
                                  rates=[4000, 12000])["sustainable_rps"] == 12000
