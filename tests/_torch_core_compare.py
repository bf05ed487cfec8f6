"""Helpers of the tests of the port's simulator
(``tests/test_torch_{open_loop,chains,knee,backends,sanitizer,autoscaler,
fleet,experiments,experiments_suite}.py``): run one scenario on the port's
``repro_torch.core``, ``.fleet`` and ``.experiments`` and on the JAX
package's ``repro.core``, ``.fleet`` and ``.experiments`` and hold the
results to exact equality.  Both packages are the same numpy code on the
same RNG streams, so every float must match bit for bit."""
import dataclasses
import math
import re
import types

import repro.core as jcore
import repro.core.workload as jworkload
import repro.experiments as jexperiments
import repro.experiments.runner as jrunner
import repro.fleet as jfleet
import repro_torch.core as tcore
import repro_torch.core.workload as tworkload
import repro_torch.experiments as texperiments
import repro_torch.experiments.runner as trunner
import repro_torch.fleet as tfleet

CORES = {"jax": jcore, "torch": tcore}
# each package's simulator tiers, by the same attribute names
PKGS = {"jax": types.SimpleNamespace(core=jcore, workload=jworkload, fleet=jfleet,
                                     experiments=jexperiments, runner=jrunner),
        "torch": types.SimpleNamespace(core=tcore, workload=tworkload, fleet=tfleet,
                                       experiments=texperiments, runner=trunner)}
# host wall times of the runner (``elapsed_s`` of a cell, ``meta.wall_s`` of
# an artifact): no seed fixes them, so the comparisons of artifacts leave
# them out, and only them
WALL_KEYS = ("elapsed_s", "wall_s")
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


def both(run):
    """``run(pkg)`` on the JAX package's tiers and on the port's
    (``PKGS``); asserts the two results equal and returns the port's."""
    j, t = run(PKGS["jax"]), run(PKGS["torch"])
    same(t, j)
    return t


def raised(exc, run, match):
    """``run(pkg)`` must raise ``exc`` in both packages, with one message
    that ``re.search(match, ...)`` finds; returns it."""
    msgs = []
    for pkg in PKGS.values():
        try:
            run(pkg)
        except exc as e:
            msgs.append(str(e))
        else:
            raise AssertionError(f"{pkg.core.__name__}: {exc.__name__} not raised")
    assert msgs[0] == msgs[1], msgs
    assert re.search(match, msgs[1]), (match, msgs[1])
    return msgs[1]


def without_wall(doc):
    """An artifact (or any part of one) without the keys ``WALL_KEYS``, and
    each failure's traceback cut to its last line, the exception and its
    message (the frames above it name each package's own files)."""
    if isinstance(doc, dict):
        out = {k: without_wall(v) for k, v in doc.items() if k not in WALL_KEYS}
        if "failures" in out:
            out["failures"] = [dict(f, error=f["error"].strip().splitlines()[-1])
                               for f in out["failures"]]
        return out
    if isinstance(doc, list):
        return [without_wall(x) for x in doc]
    return doc
