"""Multi-tenant workload (paper §1 motivation: "most functions are not
frequently invoked" [Shahrad et al.]) — a server hosting N functions with
Zipf-distributed popularity, where the polling-resource question decides
how many functions a worker can host at all.

For the DPDK-style per-instance polling model, hosting N isolated
functions burns N cores; the Junction centralized scheduler burns one.
This module drives both configurations with the same Zipf invocation
stream and reports per-popularity-tier latency + capacity.

The port's copy of the JAX package's ``core/multitenant.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.faas import FaasdRuntime, FunctionSpec
from repro_torch.core.scheduler import PollingModel
from repro_torch.core.simulator import Simulator
from repro_torch.core.workload import LatencySummary


@dataclasses.dataclass
class MultiTenantResult:
    n_functions: int
    hosted: int                  # functions actually deployable
    cores_for_work: int
    overall: LatencySummary
    hot_tier: LatencySummary     # top-10% functions
    cold_tier: LatencySummary    # bottom-50% functions


def run_zipf_workload(backend: str, *, n_functions: int = 64,
                      total_rps: float = 2000.0, duration_s: float = 1.0,
                      zipf_a: float = 1.5, n_cores: int = 36,
                      polling: PollingModel = PollingModel.CENTRALIZED,
                      seed: int = 0) -> MultiTenantResult:
    sim = Simulator(seed=seed)
    rt = FaasdRuntime(sim, backend=backend, n_cores=n_cores,
                      polling_model=polling)

    # deploy until cores run out (per-instance polling caps this)
    hosted = 0
    for i in range(n_functions):
        if rt.scheduler is not None and rt.cores.n_cores <= 1:
            break
        rt.deploy_blocking(FunctionSpec(name=f"f{i}"))
        hosted += 1

    ranks = np.arange(1, hosted + 1, dtype=np.float64)
    popularity = ranks ** (-zipf_a)
    popularity /= popularity.sum()

    per_fn_records: Dict[str, List[float]] = {f"f{i}": [] for i in range(hosted)}

    def arrivals():
        t_end = sim.now + duration_s
        while sim.now < t_end:
            yield sim.timeout(sim.exponential(1.0 / total_rps))
            fn = f"f{int(sim.rng.choice(hosted, p=popularity))}"

            def one(fn=fn):
                rec = yield from rt.invoke(fn)
                per_fn_records[fn].append(rec.e2e * 1e3)

            sim.process(one())

    sim.process(arrivals())
    sim.run(until=sim.now + duration_s + 1.5)

    all_lat = [l for ls in per_fn_records.values() for l in ls]
    hot = [l for i in range(max(1, hosted // 10))
           for l in per_fn_records[f"f{i}"]]
    cold = [l for i in range(hosted // 2, hosted)
            for l in per_fn_records[f"f{i}"]]
    return MultiTenantResult(
        n_functions=n_functions, hosted=hosted,
        cores_for_work=rt.cores.n_cores,
        overall=LatencySummary.of(all_lat),
        hot_tier=LatencySummary.of(hot),
        cold_tier=LatencySummary.of(cold or all_lat),
    )
