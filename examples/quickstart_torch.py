"""Quickstart: deploy the paper's AES(600 B) function on every registered
execution backend and invoke it 100 times: the Fig 5 experiment, widened to
the full backend matrix.  The PyTorch port's counterpart of
``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--body-us US]

The function's body is measured first: the deployed AES function
(``serving.AesFunction``) on the card, the median of 200 calls, printed with
the card's name and power limit; ``--device cpu`` measures its plain
version instead, and ``--body-us`` measures nothing and takes the body
given (95.0 is the paper's host figure, with which every line after the
first is the reference example's).  Without a card the default raises.
"""
import argparse

from repro_torch.core import (FaasdRuntime, FunctionSpec, LatencySummary,
                              Simulator, available_backends, run_sequential)
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

for backend in available_backends():
    sim = Simulator(seed=0)
    runtime = FaasdRuntime(sim, backend=backend)
    runtime.deploy_blocking(FunctionSpec(name="aes", work_us=body_us))   # vSwarm AES, 600 B
    summary = run_sequential(runtime, "aes", n=100)
    execs = LatencySummary.of(runtime.exec_latencies_ms())
    print(f"{backend:11s}: e2e median={summary.median_ms:.3f} ms "
          f"p99={summary.p99_ms:.3f} ms | exec median={execs.median_ms:.3f} ms")

print("\npaper (Fig 5): junctiond cuts median 37.33% and P99 63.42%")
