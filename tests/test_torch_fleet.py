"""The port's fleet tier (``repro_torch.fleet``: cluster, gateway,
placement, image distribution and the fleet driver) against the JAX
package's ``repro.fleet``: the 28 cases of ``tests/test_fleet.py``, each run
on both packages and held equal float for float (the placements' picks,
``SharedLink``'s finish times, the storm records and their pull sources,
``drive(cluster, ...)``'s row and per-worker telemetry, the gateway's
routing and expansions, the trace split, the runner's fleet cell and the
schema-v5 checks), then asserted as the reference asserts them.  A case
that raises holds both packages to one message."""
import json

import pytest

pytest.importorskip("torch")

from _torch_core_compare import PKGS, both, counters, raised, records, same  # noqa: E402

# ---------------------------------------------------------------------------
# registries


def test_placement_registry():
    def run(p):
        pol = p.fleet.resolve_placement("round-robin")
        assert isinstance(pol, p.fleet.RoundRobinPlacement)
        # instances pass through; names mint fresh (stateful) instances
        assert p.fleet.resolve_placement(pol) is pol
        assert p.fleet.resolve_placement("round-robin") is not pol
        return p.fleet.available_placements()

    assert both(run) == ["least-loaded", "locality", "round-robin"]
    raised(ValueError, lambda p: p.fleet.resolve_placement("bogus"), "unknown placement")


def test_distribution_registry():
    def run(p):
        sim = p.core.Simulator()
        assert isinstance(p.fleet.resolve_distribution("naive", sim), p.fleet.NaiveRegistryPull)
        assert isinstance(p.fleet.resolve_distribution("tree", sim), p.fleet.FaasNetTree)
        return p.fleet.available_distributions()

    assert both(run) == ["naive", "tree"]
    raised(ValueError, lambda p: p.fleet.resolve_distribution("bogus", p.core.Simulator()),
           "unknown image distribution")


def test_distribution_parameter_validation():
    raised(ValueError, lambda p: p.fleet.SharedLink(p.core.Simulator(), 0.0), "bandwidth")
    raised(ValueError, lambda p: p.fleet.FaasNetTree(p.core.Simulator(), fanout=0), "fanout")
    raised(ValueError, lambda p: p.fleet.FaasNetTree(p.core.Simulator(), chunks=0), "chunks")


# ---------------------------------------------------------------------------
# SharedLink fluid model


def test_shared_link_alone_runs_at_line_rate():
    def run(p):
        sim = p.core.Simulator()
        link = p.fleet.SharedLink(sim, 8.0)            # 8 Gbps = 1e9 B/s
        done = []
        link.transfer(1e9).callbacks.append(lambda t: done.append(t))
        sim.run()
        return done

    assert both(run) == [pytest.approx(1.0)]


def test_shared_link_processor_sharing():
    def run(p):
        sim = p.core.Simulator()
        link = p.fleet.SharedLink(sim, 8.0)
        done = {}

        def start(name, delay, nbytes):
            def proc():
                if delay:
                    yield sim.timeout(delay)
                yield link.transfer(nbytes)
                done[name] = sim.now
            sim.process(proc())

        # a runs alone for 0.5s (0.5e9 done), then shares with b: each
        # drains at 0.5e9 B/s, so a lands at 1.5 and b runs the last
        # 0.5e9 alone, landing at 2.0
        start("a", 0.0, 1e9)
        start("b", 0.5, 1e9)
        sim.run()
        return done

    done = both(run)
    assert done["a"] == pytest.approx(1.5)
    assert done["b"] == pytest.approx(2.0)


def test_shared_link_rejects_empty_transfer():
    raised(ValueError, lambda p: p.fleet.SharedLink(p.core.Simulator(), 8.0).transfer(0.0),
           "transfer size")


# ---------------------------------------------------------------------------
# placement policies (unit: fake workers)


class _W:
    def __init__(self, wid, load=0.0):
        self.wid = wid
        self.load = load


def test_round_robin_cycles_per_function():
    def run(p):
        pol = p.fleet.RoundRobinPlacement()
        ready = [_W(0), _W(1), _W(2)]
        # an independent cursor per function
        return [pol.pick("f", ready).wid for _ in range(5)], pol.pick("g", ready).wid

    picks, g = both(run)
    assert picks == [0, 1, 2, 0, 1]
    assert g == 0


def test_least_loaded_prefers_min_load_and_rotates_ties():
    def run(p):
        pol = p.fleet.LeastLoadedPlacement()
        ready = [_W(0, 1.0), _W(1, 0.0), _W(2, 0.0)]
        return [pol.pick("f", ready).wid for _ in range(4)]

    picks = both(run)
    # never the loaded worker; the tie-break cursor rotates instead of
    # herding onto the lowest id
    assert 0 not in picks
    assert set(picks) == {1, 2}


def test_locality_is_sticky_until_spill():
    def run(p):
        pol = p.fleet.LocalityPlacement(spill_load=2.0)
        ready = [_W(0), _W(1), _W(2), _W(3)]
        home = pol.pick("fn-a", ready).wid
        sticky = [pol.pick("fn-a", ready).wid for _ in range(8)]
        # the zlib hash puts every name at the same home in both packages
        homes = [pol.pick(f"fn-{i}", ready).wid for i in range(32)]
        ready[home].load = 5.0                 # saturate the home worker
        return home, sticky, homes, pol.pick("fn-a", ready).wid

    home, sticky, homes, spilled = both(run)
    assert sticky == [home] * 8
    assert len(set(homes)) > 1                 # different functions, different homes
    assert spilled != home


# ---------------------------------------------------------------------------
# provisioning storms: tree vs naive


def _storm(p, distribution, n_workers=32, replicas=1000, seed=0, backend="containerd"):
    sim = p.core.Simulator(seed=seed)
    cl = p.fleet.Cluster(sim, n_workers, backend=backend, distribution=distribution)
    out = {}

    def go():
        rec = yield from cl.scale_out(p.core.FunctionSpec(name="storm-fn"), replicas)
        out.update(rec)
        sim.stop()

    sim.process(go())
    sim.run()
    assert out, "storm did not complete"
    return out


def test_tree_beats_naive_by_3x_at_storm_scale():
    tree = both(lambda p: _storm(p, "tree"))
    naive = both(lambda p: _storm(p, "naive"))
    assert tree["time_to_full_s"] > 0
    assert naive["time_to_full_s"] >= 3.0 * tree["time_to_full_s"], (
        tree["time_to_full_s"], naive["time_to_full_s"])


def test_storm_record_shape_and_pull_sources():
    rec = both(lambda p: _storm(p, "tree", n_workers=8, replicas=64))
    assert rec["n_workers"] == 8
    assert sum(w["replicas"] for w in rec["workers"]) == 64
    assert [w["worker"] for w in rec["workers"]] == list(range(8))
    assert all(w["pulled"] for w in rec["workers"])
    srcs = [pull["source"] for pull in rec["pulls"]]
    assert srcs.count("origin") == 1       # only the root hits the registry
    assert srcs.count("peer") == 7
    naive = both(lambda p: _storm(p, "naive", n_workers=8, replicas=64))
    assert all(pull["source"] == "origin" for pull in naive["pulls"])


def test_storm_is_deterministic():
    def run(p):
        a = _storm(p, "tree", n_workers=16, replicas=200, seed=3)
        b = _storm(p, "tree", n_workers=16, replicas=200, seed=3)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
        return json.dumps(a, sort_keys=True)

    both(run)


def test_scale_out_validates_replicas():
    raised(ValueError, lambda p: list(p.fleet.Cluster(p.core.Simulator(), 2).scale_out(
        p.core.FunctionSpec(name="f"), 0)), "total_replicas")


def test_warm_holders_seed_the_tree():
    """A fetch onto a fleet that already holds the image somewhere must
    stream from the warm peers, never the origin."""
    def run(p):
        sim = p.core.Simulator()
        cl = p.fleet.Cluster(sim, 4, distribution="tree")
        cl.deploy_blocking(p.core.FunctionSpec(name="aes"), workers=[0, 1])

        def go():
            yield from cl.provision(p.core.FunctionSpec(name="aes"), 2)
            sim.stop()

        sim.process(go())
        sim.run()
        return cl.distribution.pulls_for("aes"), sim.now

    pulls, _ = both(run)
    assert [pull["source"] for pull in pulls] == ["peer"]


# ---------------------------------------------------------------------------
# cluster + gateway


def test_cluster_validates_size():
    raised(ValueError, lambda p: p.fleet.Cluster(p.core.Simulator(), 0), "n_workers")


def test_deploy_blocking_marks_ready_without_pull_charge():
    def run(p):
        sim = p.core.Simulator()
        cl = p.fleet.Cluster(sim, 4)
        cl.deploy_blocking(p.core.FunctionSpec(name="aes"))
        assert isinstance(cl.reference_runtime("aes"), p.core.FaasdRuntime)
        return cl.ready["aes"], cl.holders("aes"), cl.distribution.pulls, sim.now

    ready, holders, pulls, _ = both(run)
    assert ready == [0, 1, 2, 3]
    assert holders == 4
    assert pulls == []                     # pre-pulled: no transfer cost


def test_route_needs_a_ready_worker():
    def run(p):
        cl = p.fleet.Cluster(p.core.Simulator(), 2)
        return cl.gateway.route("nope")

    assert both(run) is None
    raised(KeyError, lambda p: p.fleet.Cluster(p.core.Simulator(), 2).reference_runtime("nope"),
           "nope")


def test_gateway_routes_only_to_ready_subset_and_counts_placements():
    def run(p):
        cl = p.fleet.Cluster(p.core.Simulator(), 4, placement="round-robin", spill_load=None)
        cl.deploy_blocking(p.core.FunctionSpec(name="aes"), workers=[1, 3])
        wids = [cl.gateway.route("aes").wid for _ in range(6)]
        return wids, cl.gateway.placements

    wids, placements = both(run)
    assert set(wids) == {1, 3}
    assert placements == [0, 3, 0, 3]


def test_gateway_expands_under_pressure():
    def run(p):
        sim = p.core.Simulator()
        cl = p.fleet.Cluster(sim, 3, spill_load=1.0)
        cl.deploy_blocking(p.core.FunctionSpec(name="aes"), workers=[0])
        cl.workers[0].outstanding = 50         # saturate the only ready worker
        wid = cl.gateway.route("aes").wid
        sim.run()                              # let the expansion land
        return wid, cl.gateway.expansions, sorted(cl.ready["aes"]), sim.now

    wid, expansions, ready, _ = both(run)
    assert wid == 0                            # still served by the ready set
    assert len(expansions) == 1
    exp = expansions[0]
    assert exp["fn"] == "aes" and exp["worker"] in (1, 2)
    assert exp["pulled"] and exp["ready_ms"] > 0
    assert ready == [0, exp["worker"]]


# ---------------------------------------------------------------------------
# drive(cluster, load)


def _drive_fleet(p, seed=0, n_workers=4, placement="least-loaded", rate=400.0,
                 duration_s=1.0):
    sim = p.core.Simulator(seed=seed)
    cl = p.fleet.Cluster(sim, n_workers, placement=placement)
    cl.deploy_blocking(p.core.FunctionSpec(name="aes"))
    res = p.core.drive(cl, p.core.LoadSpec.single("aes", rate, duration_s=duration_s))
    return cl, res


def _worker_telemetry(cl):
    """What a drive leaves on each worker: its admissions and its runtime's
    records and counters."""
    return [{"wid": w.wid, "admitted": w.admitted, "outstanding": w.outstanding,
             "records": records(w.runtime), "counters": counters(w.runtime)}
            for w in cl.workers]


def test_drive_cluster_result_row_and_worker_telemetry():
    def run(p):
        cl, res = _drive_fleet(p)
        placed = sum(w["placements"] for w in res["fleet"]["workers"])
        assert placed == sum(w.admitted for w in cl.workers)
        return res, _worker_telemetry(cl)

    res, _ = both(run)
    fl = res["fleet"]
    assert fl["n_workers"] == 4
    assert fl["placement"] == "least-loaded"
    assert fl["distribution"] == "tree"
    assert len(fl["workers"]) == 4
    assert res["rejected"] == 0
    assert res["n"] > 0 and res["median_ms"] > 0
    # least-loaded keeps the fleet balanced: no worker starves
    assert all(w["n"] > 0 for w in fl["workers"])


def test_drive_cluster_same_seed_is_byte_identical():
    def run(p):
        _, a = _drive_fleet(p, seed=7)
        _, b = _drive_fleet(p, seed=7)
        assert a["latencies_ms"] == b["latencies_ms"]
        assert json.dumps(a["fleet"], sort_keys=True) == json.dumps(b["fleet"], sort_keys=True)
        return a

    both(run)


def test_drive_cluster_rejects_process_engine():
    def run(p):
        cl = p.fleet.Cluster(p.core.Simulator(), 2)
        cl.deploy_blocking(p.core.FunctionSpec(name="aes"))
        p.core.drive(cl, p.core.LoadSpec.single("aes", 100.0, duration_s=0.5),
                     engine="process")

    raised(ValueError, run, "event engine")


def test_drive_cluster_requires_deployed_functions():
    raised(KeyError, lambda p: p.core.drive(p.fleet.Cluster(p.core.Simulator(), 2),
                                            p.core.LoadSpec.single("aes", 100.0,
                                                                   duration_s=0.5)),
           "not deployed")


# ---------------------------------------------------------------------------
# trace replay split across N workers (gateway fan-out determinism)


_TRACE = [i * 0.004 + (0.0007 * (i % 5)) for i in range(240)]


def _spy_gateway(p):
    """A gateway of ``p``'s fleet that records every routing decision:
    (fn, arrival time, worker id)."""
    class _SpyGateway(p.fleet.Gateway):
        __slots__ = ("routed",)

        def __init__(self, cluster, policy, spill_load=None):
            super().__init__(cluster, policy, spill_load)
            self.routed = []

        def route(self, fn):
            w = super().route(fn)
            self.routed.append((fn, round(self.cluster.sim.now, 9),
                                None if w is None else w.wid))
            return w

    return _SpyGateway


def _drive_trace(p, seed=0, n_workers=4):
    """Replay a fixed trace over a small fleet, spying on the gateway to
    record the exact per-worker arrival streams."""
    sim = p.core.Simulator(seed=seed)
    cl = p.fleet.Cluster(sim, n_workers, placement="round-robin")
    cl.gateway = _spy_gateway(p)(cl, p.fleet.resolve_placement("round-robin"))
    for fn in ("t0", "t1"):
        cl.deploy_blocking(p.core.FunctionSpec(name=fn))
    load = p.core.LoadSpec(arrivals=p.workload.TraceReplay(trace_s=tuple(_TRACE)),
                           functions=("t0", "t1"), duration_s=1.2)
    t0 = sim.now                  # deploys already advanced the clock
    res = p.core.drive(cl, load)
    routed = [(fn, round(t - t0, 9), wid) for fn, t, wid in cl.gateway.routed]
    streams = {w.wid: [(fn, t) for fn, t, wid in routed if wid == w.wid] for w in cl.workers}
    return res, routed, streams


def test_trace_split_same_seed_identical_per_worker_streams():
    def run(p):
        _, routed_a, streams_a = _drive_trace(p, seed=5)
        _, routed_b, streams_b = _drive_trace(p, seed=5)
        assert routed_a == routed_b
        # byte-identical per-worker arrival streams, not just equal counts
        assert json.dumps(streams_a, sort_keys=True, default=list) == \
            json.dumps(streams_b, sort_keys=True, default=list)
        return routed_a, streams_a

    both(run)


def test_trace_split_no_duplicated_or_dropped_arrivals():
    res, routed, streams = both(_drive_trace)
    assert res["rejected"] == 0
    # every trace arrival admitted exactly once across the fleet
    assert len(routed) == len(_TRACE)
    assert sum(len(s) for s in streams.values()) == len(_TRACE)
    times = sorted(t for s in streams.values() for _, t in s)
    assert times == sorted(round(t, 9) for t in _TRACE)
    # the split is a partition: each worker's stream is time-ordered
    for s in streams.values():
        ts = [t for _, t in s]
        assert ts == sorted(ts)


# ---------------------------------------------------------------------------
# runner integration + schema v5


def _fleet_scenario(p, **fleet_kw):
    ex = p.experiments
    spec = ex.FleetSpec(n_workers=4, placement="least-loaded", distribution="tree",
                        compare_distributions=("naive",), storm_replicas=32,
                        storm_t_frac=0.25, **fleet_kw)
    return ex.Scenario(
        name="fleet-unit", description="unit fleet",
        mode="fleet", functions=(ex.FunctionProfile("aes"),),
        arrival=ex.ArrivalSpec("poisson"), fleet=spec,
        rates={"*": (200.0,)}, duration_s=1.0, warmup_frac=0.1,
        seeds=(0,), backends=("containerd",))


def test_exec_fleet_builds_variant_grid_with_speedup():
    res = both(lambda p: p.runner._exec_fleet(_fleet_scenario(p), "containerd",
                                              duration_scale=1.0, smoke=True))
    fl = res["fleet"]
    assert fl["n_workers"] == 4
    assert [v["distribution"] for v in fl["variants"]] == ["tree", "naive"]
    assert fl["tree_provisioning_speedup"] >= 1.0
    for var in fl["variants"]:
        assert len(var["workers"]) == 4
        assert all("placements" in w and "n" in w for w in var["workers"])
        assert var["time_to_full_s"] > 0
        assert var["storm"]["pulls"], "storm pull timeline missing"
        # the storm's per-worker merge lands in the worker blocks
        assert all("storm_replicas" in w for w in var["workers"])
    assert res["mode"] == "fleet" and res["n"] > 0


def test_fleet_spec_validation():
    raised(ValueError, lambda p: p.experiments.FleetSpec(n_workers=0), "n_workers")
    raised(ValueError, lambda p: p.experiments.FleetSpec(spread="uniform"), "spread")
    raised(ValueError, lambda p: p.experiments.FleetSpec(storm_t_frac=1.5), "storm_t_frac")

    def run(p):
        spec = p.experiments.FleetSpec(compare_placements=("round-robin",))
        return spec, spec.placements(), spec.distributions()

    _, placements, distributions = both(run)
    assert placements == ("least-loaded", "round-robin")
    assert distributions == ("tree",)


def _doc_with_fleet(p, fleet):
    return p.experiments.build_artifact("unit", [{
        "name": "s", "mode": "fleet", "description": "d",
        "backend_set": ["containerd"],
        "backends": {"containerd": {"fleet": fleet}}}], [], [])


def test_schema_v5_validates_fleet_blocks():
    good = {"n_workers": 2, "placement": "least-loaded",
            "distribution": "tree",
            "variants": [{"placement": "least-loaded",
                          "distribution": "tree",
                          "workers": [{"worker": 0, "n": 1,
                                       "placements": 1}]}]}
    for p in PKGS.values():
        p.experiments.validate_artifact(_doc_with_fleet(p, good))
    same(_doc_with_fleet(PKGS["torch"], good), _doc_with_fleet(PKGS["jax"], good))

    def check(fleet, match):
        raised(ValueError, lambda p: p.experiments.validate_artifact(_doc_with_fleet(p, fleet)),
               match)

    check({"n_workers": 2, "placement": "p", "distribution": "d"}, r"fleet missing 'variants'")
    check(dict(good, variants=[{"placement": "p"}]), r"variants\[0\] missing")
    check(dict(good, variants=[{"placement": "p", "distribution": "d",
                                "workers": [{"worker": 0}]}]), r"workers\[0\] must have")
    check([1, 2], "fleet must be an object")
