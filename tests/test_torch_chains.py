"""Function chains and fusion in the port's open loop (``ChainEdge``,
``FusionPlan``, the chain table and its expansion, the per-hop result
block) against the JAX package's ``repro.core`` on the same seeds: both
engines, both backends, with and without a fusion plan, held to exact
equality of the result rows (the ``chain`` block included), the latencies,
the invocation records and the runtime's counters.  Then chains across a
fleet (``repro_torch.fleet``): every hop re-enters the gateway, and a
fleet's chained run equals the JAX package's."""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_core_compare import BACKENDS, CORES, ENGINES, both, same, same_runs  # noqa: E402

import repro.core.workload as jworkload  # noqa: E402
import repro_torch.core.workload as tworkload  # noqa: E402
from repro_torch.core import ChainEdge, FusionPlan, LoadSpec, PoissonArrivals  # noqa: E402

WORKLOADS = {"jax": jworkload, "torch": tworkload}
PIPELINE = ("ingest", "transform", "store")


def _pipeline_load(core, rate=250.0, duration_s=0.4, fusion=None, p2=0.7, scale2=3.0, **kw):
    """ingest -> transform -> store, the second edge taken with
    probability ``p2`` and its payload scaled by ``scale2``; ``fusion``
    names the fused edges (``"first"``, ``"both"``) or None."""
    chains = {"ingest": (core.ChainEdge("transform"),),
              "transform": (core.ChainEdge("store", prob=p2, payload_scale=scale2),)}
    plan = {None: None,
            "empty": core.FusionPlan(edges=()),
            "first": core.FusionPlan(edges=(("ingest", "transform"),)),
            "both": core.FusionPlan(edges=(("ingest", "transform"), ("transform", "store"))),
            "containerd only": core.FusionPlan(edges=(("ingest", "transform"),),
                                               backends=("containerd",))}[fusion]
    return core.LoadSpec(arrivals=core.PoissonArrivals(rate), functions=("ingest",),
                         duration_s=duration_s, chains=chains, fusion=plan, **kw)


def _chain_run(backend, engine, seed=0, n_cores=8, **load_kw):
    def run(core):
        rt = core.FaasdRuntime(core.Simulator(seed=seed), backend=backend, n_cores=n_cores)
        for name in PIPELINE:
            rt.deploy_blocking(core.FunctionSpec(name=name, max_cores=8))
        return rt, core.drive(rt, _pipeline_load(core, **load_kw), engine=engine)
    return run


@pytest.mark.parametrize("fusion", [None, "empty", "first", "both", "containerd only"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_chain_run_matches_repro_core(backend, engine, fusion):
    res = same_runs(_chain_run(backend, engine, seed=2, fusion=fusion))
    chain = res["chain"]
    assert chain["n_roots"] > 50 and chain["roots_completed"] > 0
    fused = fusion in ("first", "both") or (fusion == "containerd only"
                                            and backend == "containerd")
    assert (chain["fused_members"] > 0) == fused


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_chain_hop_rejections_match_repro_core(backend, engine):
    """A small admission bound under a burst of roots: hops are refused at
    spawn and counted apart from the roots."""
    res = same_runs(_chain_run(backend, engine, seed=5, n_cores=2, rate=4000.0,
                               duration_s=0.1, max_outstanding=12, drain_s=0.5))
    assert res["rejected"] > 0


def test_chained_weighted_mix_matches_repro_core():
    """A chain root beside an unchained function in a weighted mix: the
    picks, the trigger draws and the hop rows line up in both packages."""
    def run(core):
        rt = core.FaasdRuntime(core.Simulator(seed=6), backend="junctiond", n_cores=8)
        for name in PIPELINE + ("solo",):
            rt.deploy_blocking(core.FunctionSpec(name=name))
        load = core.LoadSpec(arrivals=core.PoissonArrivals(800.0), functions=("ingest", "solo"),
                             weights=(1.0, 3.0), duration_s=0.3,
                             chains={"ingest": (core.ChainEdge("transform", prob=0.5),
                                                core.ChainEdge("store", payload_scale=0.5))},
                             fusion=core.FusionPlan(edges=(("ingest", "store"),)))
        return rt, core.drive(rt, load)
    res = same_runs(run)
    assert sorted(res["per_fn"]) == ["ingest", "solo", "transform"]


def _expand(core_name, seed, n_roots, p2, fusion=None):
    core = CORES[core_name]
    return WORKLOADS[core_name]._expand_chains(
        _pipeline_load(core, p2=p2, fusion=fusion), np.zeros(n_roots, dtype=np.intp),
        np.random.default_rng(seed), "containerd")


@pytest.mark.parametrize("fusion", [None, "first", "both"])
@pytest.mark.parametrize("seed,p2", [(7, 0.6), (3, 0.5), (11, 1.0)])
def test_expansion_matches_repro_core(seed, p2, fusion):
    tables = {name: _expand(name, seed, 40, p2, fusion) for name in CORES}
    fields = ("fn_names", "fidx", "scale", "depth", "root", "children", "members", "n_roots")
    for f in fields:
        same(getattr(tables["torch"], f), getattr(tables["jax"], f), f)
    t = tables["torch"]
    assert t.n_roots == 40 and sorted(c for kids in t.children for c in kids) == \
        list(range(40, len(t.fidx)))


def test_expansion_is_independent_of_the_fusion_plan():
    """The trigger draws do not depend on which edges fuse: the same seed
    expands the same tree, the fused hops living in ``members``."""
    plain, fused = _expand("torch", 3, 40, 0.5), _expand("torch", 3, 40, 0.5, "first")
    assert plain.depth.count(2) == fused.depth.count(2)
    assert sum(len(m) for m in fused.members) == 40


def test_no_chains_consume_no_draws():
    rng = np.random.default_rng(1)
    load = LoadSpec(arrivals=PoissonArrivals(10.0), functions=("a",))
    assert tworkload._expand_chains(load, np.zeros(5, dtype=np.intp), rng, "junctiond") is None
    assert rng.random() == np.random.default_rng(1).random()


@pytest.mark.parametrize("make", [
    lambda core: core.ChainEdge(""),
    lambda core: core.ChainEdge("f", prob=0.0),
    lambda core: core.ChainEdge("f", prob=1.5),
    lambda core: core.ChainEdge("f", payload_scale=0.0),
    lambda core: core.FusionPlan(edges=(("a", ""),)),
    lambda core: core.LoadSpec(arrivals=core.PoissonArrivals(10.0), functions=("a",),
                               chains={"a": (core.ChainEdge("b"),),
                                       "b": (core.ChainEdge("a"),)}),
    lambda core: core.LoadSpec(arrivals=core.PoissonArrivals(10.0), functions=("a",),
                               chains={"a": (core.ChainEdge("a"),)}),
    lambda core: core.LoadSpec(arrivals=core.PoissonArrivals(10.0), functions=("a",),
                               fusion=core.FusionPlan(edges=(("a", "b"),))),
], ids=["empty-target", "prob-0", "prob-past-1", "scale-0", "fusion-empty-callee",
        "cycle", "self-loop", "fusion-without-chains"])
def test_chain_validation_matches_repro_core(make):
    errors = {}
    for name, core in CORES.items():
        with pytest.raises(ValueError) as err:
            make(core)
        errors[name] = str(err.value)
    assert errors["torch"] == errors["jax"]


def test_fusion_plan_normalizes_and_matches():
    plan = FusionPlan(edges=(("a", "b"), ("a", "b"), ("b", "c")))
    assert plan.edges == (("a", "b"), ("b", "c"))
    assert plan.fuses("a", "b") and plan.fuses("b", "c") and not plan.fuses("b", "a")
    assert plan.applies_to("containerd")
    only = FusionPlan(edges=(("a", "b"),), backends=("containerd",))
    assert only.applies_to("containerd") and not only.applies_to("junctiond")
    e = ChainEdge("f", prob=0.5, payload_scale=2.0)
    assert (e.target, e.prob, e.payload_scale) == ("f", 0.5, 2.0)


# ---------------------------------------------------------------------------
# Fleet: gateway-routed hops across workers.


def _fleet_chain_run(p, seed=0, spy=False):
    class _SpyGateway(p.fleet.Gateway):
        """Records every routing decision: (fn, worker id)."""

        __slots__ = ("routed",)

        def __init__(self, cluster, policy, spill_load=None):
            super().__init__(cluster, policy, spill_load)
            self.routed = []

        def route(self, fn):
            w = super().route(fn)
            self.routed.append((fn, None if w is None else w.wid))
            return w

    cl = p.fleet.Cluster(p.core.Simulator(seed=seed), 4, backend="containerd", n_cores=8,
                         placement="round-robin")
    if spy:
        cl.gateway = _SpyGateway(cl, p.fleet.resolve_placement("round-robin"))
    for name in PIPELINE:
        cl.deploy_blocking(p.core.FunctionSpec(name=name, max_cores=8))
    load = _pipeline_load(p.core, rate=400.0, duration_s=0.6, p2=1.0, scale2=1.0)
    return cl, p.core.drive(cl, load)


def test_fleet_chain_same_seed_byte_identical():
    def run(p):
        _, a = _fleet_chain_run(p, seed=3)
        _, b = _fleet_chain_run(p, seed=3)
        assert a["latencies_ms"] == b["latencies_ms"]
        for key in ("chain", "fleet"):
            assert json.dumps(a[key], sort_keys=True) == json.dumps(b[key], sort_keys=True)
        return a

    both(run)


def test_fleet_chain_hops_route_cross_worker():
    def run(p):
        cl, res = _fleet_chain_run(p, seed=0, spy=True)
        return res, cl.gateway.routed

    res, routed = both(run)
    assert res["chain"]["n_roots"] > 50
    assert [h["hop"] for h in res["chain"]["hops"]] == [0, 1, 2]
    # every hop re-enters the gateway as a request of its own...
    assert {fn for fn, _ in routed} == {"ingest", "transform", "store"}
    # ...and round-robin spreads a root's hops across distinct workers
    assert len({wid for fn, wid in routed if fn == "transform"}) > 1
