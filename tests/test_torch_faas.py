"""The port's copy of the faasd runtime (``repro_torch.core``) against the
JAX package's ``repro.core`` on the same seeds: the simulator is the same
numpy code in both, so every latency is held to exact equality."""
import itertools

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402

BACKENDS = ["containerd", "junctiond", "quark", "wasm", "firecracker", "gvisor"]


class _Work:
    """A per-invocation body time that varies from call to call, made anew
    for each package so both see the same sequence."""

    def __init__(self):
        self._i = itertools.count()

    def __call__(self):
        return 40.0 + 11.0 * (next(self._i) % 7)


def _run(core, backend, seed, work, n=60, **spec):
    sim = core.Simulator(seed=seed)
    rt = core.FaasdRuntime(sim, backend=backend)
    rt.deploy_blocking(core.FunctionSpec("fn", work_us=work() if work else 95.0, **spec))
    summary = core.run_sequential(rt, "fn", n=n)
    return rt, summary


@pytest.mark.parametrize("work", [None, _Work], ids=["95us", "callable"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", BACKENDS)
def test_run_sequential_matches_repro_core(backend, seed, work):
    jrt, js = _run(jcore, backend, seed, work)
    trt, ts = _run(tcore, backend, seed, work)
    assert [r.e2e for r in trt.records] == [r.e2e for r in jrt.records]
    assert trt.exec_latencies_ms() == jrt.exec_latencies_ms()
    assert ts.__dict__ == js.__dict__ and ts.n == 60
    assert (trt.cache_hits, trt.cache_misses) == (jrt.cache_hits, jrt.cache_misses)
    assert trt.cores.busy_time == jrt.cores.busy_time


@pytest.mark.parametrize("backend", BACKENDS)
def test_model_endpoint_spec_matches_repro_core(backend):
    """The spec the launcher deploys: a 2 KiB request, a 4 KiB response."""
    spec = dict(payload_bytes=2048, response_bytes=4096)
    _, js = _run(jcore, backend, 0, lambda: 1945.0, n=40, **spec)
    _, ts = _run(tcore, backend, 0, lambda: 1945.0, n=40, **spec)
    assert ts.__dict__ == js.__dict__


@pytest.mark.parametrize("backend,median_ms,p99_ms", [
    ("containerd", 0.9203, 3.4819),
    ("junctiond", 0.5734, 1.0583),
])
def test_paper_aes_function_latencies(backend, median_ms, p99_ms):
    """The AES function at the paper's 95 us body, ``Simulator(seed=1)``,
    100 sequential invocations: the simulated latencies of ``repro.core``."""
    sim = tcore.Simulator(seed=1)
    rt = tcore.FaasdRuntime(sim, backend=backend)
    rt.deploy_blocking(tcore.FunctionSpec("aes", work_us=tcore.AES_600B_WORK_US))
    s = tcore.run_sequential(rt, "aes", n=100)
    assert (round(s.median_ms, 4), round(s.p99_ms, 4), s.n) == (median_ms, p99_ms, 100)


def test_junctiond_cuts_the_median_as_the_paper_does():
    medians = {b: _run(tcore, b, 1, None, n=100)[1].median_ms for b in BACKENDS}
    cut = 1 - medians["junctiond"] / medians["containerd"]
    assert 0.36 < cut < 0.39           # paper: 37.33 %


def test_available_backends_equal_repro_core():
    assert tcore.available_backends() == jcore.available_backends() == tuple(sorted(BACKENDS))


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend 'nope'"):
        tcore.get_backend_class("nope")


@pytest.mark.parametrize("backend", BACKENDS)
def test_lifecycle_on_an_undeployed_function(backend):
    sim = tcore.Simulator(0)
    b = tcore.resolve_backend(backend, sim)
    with pytest.raises(tcore.UnknownFunctionError):
        next(b.scale("missing", 2))
    assert b.lookup("missing") is None
    b.remove("missing")                     # idempotent teardown


def test_junctiond_reserves_the_polling_core():
    sim = tcore.Simulator(0)
    j = tcore.resolve_backend("junctiond", sim, n_cores=10)
    c = tcore.resolve_backend("containerd", sim, n_cores=10)
    assert (j.cores.n_cores, j.scheduler.polling_cores_reserved) == (9, 1)
    assert c.cores.n_cores == 10 and c.scheduler is None
