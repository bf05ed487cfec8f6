"""Reproduce the paper's Fig 6 load sweep and the section 3 polling-efficiency
argument in one script.  The PyTorch port's counterpart of
``examples/faas_comparison.py``.

    PYTHONPATH=src python examples/faas_comparison_torch.py [--device cpu] [--body-us US]

The AES function's body is measured first, as ``examples/quickstart_torch.py``
measures it: on the card by default (the median of 200 calls, printed with
the card's name and power limit), its plain version with ``--device cpu``,
or given by ``--body-us`` (95.0, the paper's host figure, gives the
reference example's lines after the first).  Without a card the default
raises.
"""
import argparse

from repro_torch.core import (FaasdRuntime, FunctionSpec, JunctionInstance, LoadSpec,
                              PollingModel, Simulator, drive)
from repro_torch.core.latency import JUNCTION_RUNTIME
from repro_torch.core.resources import CorePool
from repro_torch.core.scheduler import JunctionScheduler
from repro_torch.serving.aes_function import device_label, measure_body_us

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
ap.add_argument("--body-us", type=float, default=None)
args = ap.parse_args()
if args.body_us is None:
    body_us = measure_body_us(args.device)
    print(f"AES(600 B) body: {body_us:.1f} us, the median of 200 calls of the deployed "
          f"function on {device_label(args.device)}")
else:
    body_us = args.body_us
    print(f"AES(600 B) body: {body_us:.1f} us, given (not measured)")

print("open-loop load sweep (AES 600B), p99 vs offered rps:\n")
print(f"{'rate':>8} | {'containerd p99 (ms)':>20} | {'junctiond p99 (ms)':>19}")
for rate in (500, 1000, 1500, 4000, 8000, 12000):
    row = [f"{rate:8d}"]
    for backend in ("containerd", "junctiond"):
        sim = Simulator(seed=3)
        rt = FaasdRuntime(sim, backend=backend)
        rt.deploy_blocking(FunctionSpec(name="aes", max_cores=8, work_us=body_us))
        res = drive(rt, LoadSpec.single("aes", rate, duration_s=1.0))
        val = res["p99_ms"]
        row.append(f"{val:20.2f}" if val == val else f"{'collapsed':>20}")
    print(" | ".join(row))

print("\npaper: junctiond sustains ~10x the throughput at ~3.5x lower tail")

# polling efficiency: cores left for real work on a 36-core server
print("\ncores left for function work (36-core server):")
for n in (8, 32, 1000):
    rows = []
    for model in (PollingModel.CENTRALIZED, PollingModel.PER_INSTANCE):
        sim = Simulator()
        pool = CorePool(sim, 36, JUNCTION_RUNTIME)
        sched = JunctionScheduler(sim, pool, model)
        for i in range(n):
            inst = JunctionInstance(sim, f"f{i}")
            sched.register(inst)
            if pool.n_cores <= 0:
                break
        rows.append(pool.n_cores)
    print(f"  {n:5d} functions: centralized={rows[0]:2d}  per-instance(DPDK)={rows[1]:2d}")
