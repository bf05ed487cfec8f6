"""Helpers of the tests of the port's simulator
(``tests/test_torch_{open_loop,chains,knee,backends,sanitizer,autoscaler}.py``):
run one scenario on the port's ``repro_torch.core`` and on the JAX
package's ``repro.core`` and hold the results to exact equality.  Both packages are the same numpy code
on the same RNG streams, so every float must match bit for bit."""
import dataclasses
import math

import repro.core as jcore
import repro_torch.core as tcore

CORES = {"jax": jcore, "torch": tcore}
BACKENDS = ("containerd", "junctiond")
ENGINES = ("events", "process")
SIX = ("containerd", "junctiond", "quark", "wasm", "firecracker", "gvisor")
# every backend, and gVisor once more on its ptrace platform's cost tables
VARIANTS = SIX + ("gvisor-ptrace",)


def runtime_of(core, variant, seed=0):
    """A fresh runtime on ``core`` for one of ``VARIANTS``."""
    sim = core.Simulator(seed=seed)
    if variant == "gvisor-ptrace":
        return core.FaasdRuntime(sim, backend=core.GVisor(sim, platform="ptrace"))
    return core.FaasdRuntime(sim, backend=variant)


def scale_events(asc):
    """An autoscaler's decisions, every field, in order."""
    return [dataclasses.asdict(e) for e in asc.scale_events]


def same(a, b, path="result"):
    """Assert ``a`` and ``b`` are equal: floats exactly (NaN equal to NaN),
    dicts key for key, sequences item for item, dataclasses (the summaries)
    field by field and of the same class name."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        same(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), f"{path}: keys {list(a)} != {list(b)}"
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), f"{path}: lengths differ"
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), f"{path}: nan != {b!r}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def records(rt):
    """Every field of a runtime's invocation records, in record order."""
    return [(r.fn, r.t_arrival, r.t_start_exec, r.t_end_exec, r.t_done, r.cold)
            for r in rt.records]


def counters(rt):
    """What a run leaves on the runtime, its core pool and its stack."""
    return {"cache_hits": rt.cache_hits, "cache_misses": rt.cache_misses,
            "rejected": rt.rejected, "busy_time": rt.cores.busy_time,
            "served": rt.cores.served, "busy": rt.cores.busy,
            "messages": rt.stack.messages, "stack_cpu": rt.stack.cpu_spent,
            "hiccups": rt.stack.hiccups, "now": rt.sim.now}


def same_runs(run):
    """``run(core)`` -> (runtime, result row) on each package; asserts the
    rows, the records and the runtime counters equal, and returns the
    port's row."""
    (jrt, jres), (trt, tres) = run(jcore), run(tcore)
    same(tres, jres)
    assert records(trt) == records(jrt)
    same(counters(trt), counters(jrt), "counters")
    return tres
