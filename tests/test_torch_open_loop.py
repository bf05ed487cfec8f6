"""The port's open-loop driver (``repro_torch.core.drive`` on
``simulator.EventLoop`` and ``CorePool``'s event-heap path) against the JAX
package's ``repro.core`` on the same seeds: both engines, both backends,
every arrival process, a weighted mix, heavy-tailed work and overload with
rejections, held to exact equality of the result rows, the latencies, the
invocation records and the runtime's counters.  Then ``LoadSpec``'s
validation, ``drive`` on a fleet ``Cluster`` (the port's fleet driver,
equal to the JAX package's), ``SIM_CHECK`` (checked runs give the unchecked
records), the ``EventLoop`` merge of arrivals into the heap, and the
invariants of the heap path under mixed traffic and a fleet's telemetry
with the fused path on and off (the cases of
``tests/test_corepool_properties.py``)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_core_compare import (BACKENDS, CORES, ENGINES, both, counters, records,  # noqa: E402
                                 same, same_runs)

import repro.core as jcore  # noqa: E402
import repro.core.workload as jworkload  # noqa: E402
import repro_torch.core.workload as tworkload  # noqa: E402
from repro_torch.core import FaasdRuntime, FunctionSpec, LoadSpec, Simulator, drive  # noqa: E402
from repro_torch.core.backends import get_backend_class  # noqa: E402
from repro_torch.core.resources import CorePool  # noqa: E402

TRACE = np.sort(np.random.default_rng(5).uniform(0.0, 0.3, 240)).tolist()


def _arrivals(core, kind):
    """About 800 rps on average: below containerd's knee on 10 cores, with
    bursts above it."""
    return {"poisson": lambda: core.PoissonArrivals(800.0),
            "bursty": lambda: core.BurstyArrivals(base_rps=300.0, burst_rps=4000.0,
                                                  mean_quiet_s=0.05, mean_burst_s=0.02),
            "diurnal": lambda: core.DiurnalArrivals(800.0, amplitude=0.6, period_s=0.1),
            "trace": lambda: core.TraceReplay(TRACE)}[kind]()


def _open_loop(backend, engine, load_of, seed=3, n_cores=10, specs=None, provider_cache=True):
    """run(core) for ``same_runs``: a fresh runtime, its functions deployed,
    one ``drive`` of ``load_of(core)``."""
    def run(core):
        rt = core.FaasdRuntime(core.Simulator(seed=seed), backend=backend, n_cores=n_cores,
                               provider_cache=provider_cache)
        for spec in (specs(core) if specs else [core.FunctionSpec("aes")]):
            rt.deploy_blocking(spec)
        return rt, core.drive(rt, load_of(core), engine=engine)
    return run


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal", "trace"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_drive_matches_repro_core(backend, engine, kind):
    res = same_runs(_open_loop(backend, engine, lambda core: core.LoadSpec(
        arrivals=_arrivals(core, kind), functions=("aes",), duration_s=0.3, warmup_s=0.06)))
    assert res["n"] > 100


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_weighted_mix_matches_repro_core(backend, engine):
    """Three functions of different bodies and payloads, weighted 3:2:1."""
    res = same_runs(_open_loop(
        backend, engine,
        lambda core: core.LoadSpec(arrivals=core.PoissonArrivals(600.0),
                                   functions=("aes", "model", "tiny"), weights=(3, 2, 1),
                                   duration_s=0.3, warmup_frac=0.25),
        specs=lambda core: [core.FunctionSpec("aes"),
                            core.FunctionSpec("model", work_us=400.0, payload_bytes=2048,
                                              response_bytes=4096),
                            core.FunctionSpec("tiny", work_us=5.0)]))
    assert sorted(res["per_fn"]) == ["aes", "model", "tiny"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("backend,rate", [("containerd", 3000.0), ("junctiond", 20000.0)])
def test_overload_with_rejections_matches_repro_core(backend, rate, engine):
    """Far past the knee of four cores with a small admission bound: the
    runs reject, queue and thrash, and still agree to the bit."""
    res = same_runs(_open_loop(backend, engine, lambda core: core.LoadSpec.single(
        "aes", rate, duration_s=0.15, warmup_s=0.03, max_outstanding=40, drain_s=0.5),
        n_cores=4))
    assert res["rejected"] > 0 and res["n"] > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_heavy_tailed_work_matches_repro_core(engine):
    """Pareto work, one sampler per package from the same seed: the events
    engine draws it in batches, the process engine per call."""
    def specs(core):
        return [core.FunctionSpec("aes", work_us=core.heavy_tailed_work(
            np.random.default_rng(9), 60.0))]

    same_runs(_open_loop("junctiond", engine, lambda core: core.LoadSpec.single(
        "aes", 3000.0, duration_s=0.2, warmup_s=0.04), specs=specs))


@pytest.mark.parametrize("backend", BACKENDS)
def test_uncached_provider_falls_back_to_the_process_engine(backend):
    """Without the provider cache the event engine cannot represent the
    resolve path, so ``drive`` takes the process engine in both packages."""
    run = _open_loop(backend, "events", lambda core: core.LoadSpec.single(
        "aes", 1000.0, duration_s=0.2, warmup_s=0.04), provider_cache=False)
    res = same_runs(run)
    rt, _ = run(CORES["torch"])
    assert rt.cache_misses > 0 and res["n"] > 50


@pytest.mark.parametrize("backend", BACKENDS)
def test_unfused_fast_path_matches_repro_core(backend, monkeypatch):
    """With ``FUSED_FAST_PATH`` off in both packages every request walks the
    per-station machine, and the two still agree."""
    monkeypatch.setattr(jworkload, "FUSED_FAST_PATH", False)
    monkeypatch.setattr(tworkload, "FUSED_FAST_PATH", False)
    same_runs(_open_loop(backend, "events", lambda core: core.LoadSpec.single(
        "aes", 4000.0, duration_s=0.2, warmup_s=0.04)))


class _Log:
    """An observer that records its taps."""

    def __init__(self):
        self.taps = []

    def on_arrival(self, fn):
        self.taps.append(("arrival", fn))

    def on_done(self, fn):
        self.taps.append(("done", fn))


@pytest.mark.parametrize("engine", ENGINES)
def test_observer_sees_the_same_taps(engine):
    logs = {}
    for name, core in CORES.items():
        rt = core.FaasdRuntime(core.Simulator(seed=4), backend="containerd", n_cores=2)
        for fn in ("a", "b"):
            rt.deploy_blocking(core.FunctionSpec(fn))
        logs[name] = _Log()
        core.drive(rt, core.LoadSpec(core.PoissonArrivals(3000.0), ("a", "b"), weights=(1, 2),
                                     duration_s=0.1, max_outstanding=8),
                   observer=logs[name])
    assert logs["torch"].taps == logs["jax"].taps
    assert {t for t, _ in logs["torch"].taps} == {"arrival", "done"}


def test_a_runtime_reused_across_runs_matches_repro_core():
    """Two loads in a row on one runtime (what knee bracketing does): the
    second row reports its own rejections, the counters carry on."""
    rows, rts = {}, {}
    for name, core in CORES.items():
        rt = core.FaasdRuntime(core.Simulator(seed=0), backend="containerd", n_cores=4)
        rt.deploy_blocking(core.FunctionSpec("f"))
        first = core.drive(rt, core.LoadSpec.single("f", 2000.0, duration_s=0.2, warmup_s=0.05,
                                                    max_outstanding=1))
        second = core.drive(rt, core.LoadSpec.single("f", 50.0, duration_s=0.2, warmup_s=0.05))
        rows[name], rts[name] = (first, second), rt
    same(rows["torch"], rows["jax"])
    assert records(rts["torch"]) == records(rts["jax"])
    same(counters(rts["torch"]), counters(rts["jax"]))
    assert rows["torch"][0]["rejected"] > 0 and rows["torch"][1]["rejected"] == 0


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal", "trace"])
def test_arrival_streams_match_repro_core(kind):
    streams = {name: _arrivals(core, kind).times(np.random.default_rng(12), 0.3)
               for name, core in CORES.items()}
    assert streams["torch"].tolist() == streams["jax"].tolist()
    assert _arrivals(CORES["torch"], kind).mean_rps() == _arrivals(CORES["jax"], kind).mean_rps()


# ---------------------------------------------------------------------------
# LoadSpec's validation, and what raises until its item is ported


@pytest.mark.parametrize("kw", [
    dict(functions=()),
    dict(weights=(1.0, 2.0)),
    dict(weights=(-1.0,)),
    dict(weights=(0.0,)),
    dict(duration_s=0.0),
    dict(warmup_frac=1.0),
    dict(warmup_frac=-0.1),
    dict(warmup_s=2.0),
    dict(chains={"aes": ("not an edge",)}),
    dict(fusion="plan without chains"),
], ids=["no-functions", "weights-count", "negative-weight", "zero-weights", "duration",
        "warmup-frac-1", "warmup-frac-negative", "warmup-s", "chain-edge-type",
        "fusion-without-chains"])
def test_loadspec_validation_matches_repro_core(kw):
    errors = {}
    for name, core in CORES.items():
        spec = {"arrivals": core.PoissonArrivals(100.0), "functions": ("aes",), **kw}
        if kw.get("fusion"):
            spec["fusion"] = core.FusionPlan(edges=(("aes", "b"),))
        with pytest.raises(ValueError) as err:
            core.LoadSpec(**spec)
        errors[name] = str(err.value)
    assert errors["torch"] == errors["jax"]


def test_loadspec_fields_and_defaults_match_repro_core():
    """The ``spec-kwargs`` lint rule keys every ``LoadSpec`` by its name
    alone, so the port's must declare exactly the reference's fields."""
    import dataclasses
    fields = {name: [(f.name, f.default) for f in dataclasses.fields(core.LoadSpec)]
              for name, core in CORES.items()}
    assert fields["torch"] == fields["jax"]
    for name, core in CORES.items():
        load = core.LoadSpec.single("aes", 500.0, warmup_frac=0.25, weights=(2.0,))
        assert (load.effective_warmup_s, load.normalized_weights().tolist()) == (0.5, [1.0])


def test_drive_refuses_what_the_reference_refuses():
    rt = FaasdRuntime(Simulator(seed=0), backend="junctiond")
    rt.deploy_blocking(FunctionSpec("aes"))
    with pytest.raises(ValueError, match="unknown engine"):
        drive(rt, LoadSpec.single("aes", 100.0), engine="fast")
    with pytest.raises(KeyError, match="not deployed"):
        drive(rt, LoadSpec.single("other", 100.0))


def test_drive_on_a_cluster_equals_repro_fleet():
    """``drive`` hands a ``Cluster`` to the port's fleet driver: the row,
    every worker's records and counters equal the JAX package's."""
    def run(p):
        cl = p.fleet.Cluster(p.core.Simulator(seed=4), 3, backend="junctiond", n_cores=6)
        cl.deploy_blocking(p.core.FunctionSpec(name="aes"))
        res = p.core.drive(cl, p.core.LoadSpec.single("aes", 3000.0, duration_s=0.4))
        return res, [(records(w.runtime), counters(w.runtime)) for w in cl.workers]

    res, _ = both(run)
    assert res["n"] > 0 and res["fleet"]["n_workers"] == 3


@pytest.mark.parametrize("engine", ENGINES)
def test_sim_check_runs_checked_and_gives_the_unchecked_records(engine, monkeypatch):
    """``SIM_CHECK`` on: the event engine's fused admits call the
    sanitizer's check, and the run gives the row and the records of an
    unchecked run (and of the JAX package's)."""
    from repro_torch.analysis import sanitizer
    checks = []
    monkeypatch.setattr(sanitizer, "fused_admit_check", lambda *a: checks.append(a))

    def run(flag):
        monkeypatch.setattr(tworkload, "SIM_CHECK", flag)
        rt = FaasdRuntime(Simulator(seed=0), backend="junctiond")
        rt.deploy_blocking(FunctionSpec("aes"))
        return rt, drive(rt, LoadSpec.single("aes", 3000.0, duration_s=0.2), engine=engine)

    (urt, unchecked), (crt, checked) = run(False), run(True)
    same(checked, unchecked)
    assert records(crt) == records(urt)
    assert bool(checks) == (engine == "events")
    jrt = jcore.FaasdRuntime(jcore.Simulator(seed=0), backend="junctiond")
    jrt.deploy_blocking(jcore.FunctionSpec("aes"))
    same(checked, jcore.drive(jrt, jcore.LoadSpec.single("aes", 3000.0, duration_s=0.2),
                              engine=engine))
    assert records(crt) == records(jrt)


def test_the_deprecated_shims_stay_out_of_the_port():
    import repro_torch.core as tcore
    for name in ("run_open_loop", "run_mixed_open_loop"):
        assert not hasattr(tworkload, name) and not hasattr(tcore, name)


# ---------------------------------------------------------------------------
# EventLoop: a presorted arrival stream merged into the heap's time order


@pytest.mark.parametrize("until", [0.35, 0.5, 2.0])
def test_event_loop_merges_arrivals_like_repro_core(until):
    """Callbacks at, between and after the arrivals (ties: the arrival
    first), callbacks that schedule more, and a stop that ends the run."""
    logs = {}
    for name, core in CORES.items():
        sim = core.Simulator(seed=0)
        loop = core.EventLoop(sim)
        log = logs[name] = []

        def tick(tag, again=None):
            log.append(("event", tag, sim.now))
            if again is not None:
                loop.schedule(again, tick, tag + "+")

        def admit(i, t):
            log.append(("arrival", i, t, sim.now))
            if i == 4:
                loop.schedule(0.05, tick, "from-admit")

        for delay, tag, again in ((0.1, "a", 0.05), (0.2, "tie", None), (0.3, "b", 0.3),
                                  (0.45, "c", None), (1.5, "stop", None)):
            loop.schedule(delay, tick, tag, again)
        sim._schedule(1.5, sim.stop)
        n = loop.run(until, [0.05, 0.15, 0.2, 0.2, 0.25, 0.4, 0.9, 1.6], admit)
        log.append(("delivered", n, sim.now, len(sim._heap)))
    assert logs["torch"] == logs["jax"]
    ties = [e for e in logs["torch"] if e[:2] in (("arrival", 2), ("event", "tie"))]
    assert ties[0][0] == "arrival"


def test_event_loop_without_arrivals_moves_the_clock_to_until():
    sim = Simulator(seed=0)
    fired = []
    sim._schedule(0.2, fired.append, 1)
    assert tworkload.EventLoop(sim).run(1.0) == 0
    assert fired == [1] and sim.now == 1.0


# ---------------------------------------------------------------------------
# CorePool's event-heap path: invariants under mixed traffic


def _pool(n_cores: int):
    sim = Simulator(seed=0)
    costs = get_backend_class("containerd").runtime
    return sim, CorePool(sim, n_cores, costs)


# job: (kind, arrival_s, cpu_s, gap_s)
_JOB = st.tuples(st.sampled_from(["fast", "gen", "lazy"]),
                 st.floats(min_value=0.0, max_value=2.0),
                 st.floats(min_value=1e-6, max_value=0.3),
                 st.floats(min_value=0.0, max_value=0.1))


@given(st.lists(_JOB, min_size=1, max_size=40),
       st.integers(min_value=2, max_value=8))
@settings(max_examples=50, deadline=None)
def test_mixed_traffic_invariants(jobs, n_cores):
    """``acquire_fast``/``release_fast``, the generator ``consume`` and the
    lazy ``release_at`` share one pool and one waiter queue: ``busy``
    stays within [0, n_cores], the queued weight drains to zero and
    nothing is stranded."""
    sim, pool = _pool(n_cores)
    state = {"done": 0, "lazy": 0}
    expect_done = 0

    def check():
        assert 0 <= pool.busy <= pool.n_cores, (pool.busy, pool.n_cores)
        assert pool._queued_weight >= 0

    def fast(cpu, gap):
        def granted(start):
            check()
            eff = cpu * pool.thrash()
            sim._schedule(start + eff - sim.now, done, eff)

        def done(eff):
            pool.release_fast(eff)
            state["done"] += 1
            check()

        pool.acquire_fast(sim.now + gap, granted)

    def gen(cpu):
        def job():
            yield from pool.consume(cpu)
            state["done"] += 1
            check()
        sim.process(job())

    def lazy(cpu):
        if not pool._waiters and pool.busy < pool.n_cores:
            pool.busy += 1
            pool.release_at(sim.now + cpu)
            state["lazy"] += 1

    for kind, arrival, cpu, gap in jobs:
        if kind == "fast":
            expect_done += 1
            sim._schedule(arrival, fast, cpu, gap)
        elif kind == "gen":
            expect_done += 1
            sim._schedule(arrival, gen, cpu)
        else:
            sim._schedule(arrival, lazy, cpu)

    sim.run()
    assert state["done"] == expect_done
    assert len(pool._waiters) == 0
    assert pool._queued_weight == 0
    assert pool.served == expect_done
    pool._drain(float("inf"))
    assert pool.busy == 0
    assert not pool._off_pend


@given(st.lists(st.tuples(st.floats(min_value=0.0, max_value=0.5),
                          st.floats(min_value=1e-6, max_value=0.2),
                          st.floats(min_value=0.0, max_value=0.05)),
                min_size=1, max_size=30),
       st.integers(min_value=2, max_value=6))
@settings(max_examples=50, deadline=None)
def test_reservation_across_gap_never_strands_a_core(jobs, n_cores):
    """Holds that reserve a core through a future ``avail_t`` all complete
    and return the pool to empty, whatever the interleaving."""
    sim, pool = _pool(n_cores)
    done = []

    def hold(cpu):
        def granted(start):
            sim._schedule(start + cpu - sim.now, release)

        def release():
            pool.release_fast(cpu)
            done.append(sim.now)

        return granted

    for arrival, cpu, gap in jobs:
        sim._schedule(arrival, lambda c=cpu, g=gap: pool.acquire_fast(sim.now + g, hold(c)))

    sim.run()
    assert len(done) == len(jobs)
    assert pool.busy == 0
    assert len(pool._waiters) == 0
    assert pool._queued_weight == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heap_path_schedule_matches_repro_core(seed):
    """One random schedule of fast, generator and lazy holds on each
    package's pool: the same grant times, releases and totals."""
    rng = np.random.default_rng(seed)
    jobs = [(str(rng.choice(["fast", "gen", "lazy"])), float(rng.uniform(0, 0.5)),
             float(rng.uniform(1e-5, 0.1)), float(rng.uniform(0, 0.02))) for _ in range(60)]
    logs = {}
    for name, core in CORES.items():
        sim = core.Simulator(seed=seed)
        pool = core.CorePool(sim, 3, core.get_backend_class("containerd").runtime)
        log = logs[name] = []

        def fast(cpu, gap, sim=sim, pool=pool, log=log):
            def granted(start):
                eff = cpu * pool.thrash()
                log.append(("grant", start, eff))
                sim._schedule(start + eff - sim.now, pool.release_fast, eff)
            pool.acquire_fast(sim.now + gap, granted)

        def gen(cpu, sim=sim, pool=pool, log=log):
            def job():
                yield from pool.consume(cpu)
                log.append(("consumed", sim.now))
            sim.process(job())

        def lazy(cpu, sim=sim, pool=pool):
            if not pool._waiters and pool.busy < pool.n_cores:
                pool.busy += 1
                pool.release_at(sim.now + cpu)

        for kind, arrival, cpu, gap in jobs:
            sim._schedule(arrival, {"fast": fast, "gen": gen, "lazy": lazy}[kind],
                          *((cpu, gap) if kind == "fast" else (cpu,)))
        sim.run()
        log.append(("totals", pool.busy_time, pool.served, pool.busy, sim.now))
    assert logs["torch"] == logs["jax"]


def _drive_totals(fused: bool, monkeypatch, rate: float = 150.0, n_cores: int = 64):
    monkeypatch.setattr(tworkload, "FUSED_FAST_PATH", fused)
    rt = FaasdRuntime(Simulator(seed=11), backend="containerd", n_cores=n_cores)
    rt.deploy_blocking(FunctionSpec(name="aes"))
    res = drive(rt, LoadSpec.single("aes", rate, duration_s=1.0), engine="events")
    return res, rt.cores.busy_time, rt.cores.served


def test_fused_and_unfused_agree_when_uncontended(monkeypatch):
    """On a contention-free schedule (64 cores, light load) the fused fast
    path only saves events: per-request timelines, busy_time and served
    totals match the per-station machine."""
    res_f, busy_f, served_f = _drive_totals(True, monkeypatch)
    res_u, busy_u, served_u = _drive_totals(False, monkeypatch)
    assert served_f == served_u
    assert busy_f == pytest.approx(busy_u, rel=1e-9)
    assert res_f["n"] == res_u["n"]
    assert res_f["latencies_ms"] == pytest.approx(res_u["latencies_ms"], rel=1e-9)


@pytest.mark.parametrize("fused", [True, False])
def test_fused_toggle_does_not_change_fleet_telemetry_shape(fused, monkeypatch):
    monkeypatch.setattr(jworkload, "FUSED_FAST_PATH", fused)
    monkeypatch.setattr(tworkload, "FUSED_FAST_PATH", fused)

    def run(p):
        cl = p.fleet.Cluster(p.core.Simulator(seed=5), 4, backend="containerd")
        cl.deploy_blocking(p.core.FunctionSpec(name="aes"))
        res = p.core.drive(cl, p.core.LoadSpec.single("aes", 1500.0, duration_s=1.0))
        return res, [w.runtime.stack.hiccups for w in cl.workers]

    res, hiccups = both(run)
    rows = res["fleet"]["workers"]
    assert len(rows) == 4
    assert all(w["n"] > 0 for w in rows)
    if sum(hiccups) >= 4:
        # hiccups are apportioned across routed workers, not booked on
        # the reference worker alone
        assert sum(1 for h in hiccups if h > 0) > 1
