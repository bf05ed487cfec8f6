"""End-to-end serving driver: the PyTorch port's counterpart of
``examples/serve_e2e.py``.  A reduced float32 qwen3 model served with
batched requests through the port's pipeline --

  continuous batcher -> prefill -> decode loop (the card's kernels)
  measured per-step service times -> junctiond vs containerd invocation
  path -> latency report.

    PYTHONPATH=src python examples/serve_e2e_torch.py [--device cpu]

The model runs on the card unless ``--device cpu`` is given (the plain
versions of the kernels); without a card the default raises.  The decode
step it measures becomes the function's body.  The FaaS latencies are
simulated on the host from the paper's host costs; only the decode step is
measured.
"""
import argparse
import dataclasses

from repro_torch.config import get_arch, reduced
from repro_torch.core import FaasdRuntime, FunctionSpec, Simulator, run_sequential
from repro_torch.serving import ServingEngine
from repro_torch.serving.aes_function import device_label

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

cfg = dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="float32")
engine = ServingEngine(cfg, batch_slots=4, max_seq_len=48, device=args.device)
print(f"model: {cfg.name} ({cfg.n_layers}L d={cfg.d_model}, qk_norm={cfg.qk_norm}) on "
      f"{device_label(args.device)}")

# 1) real model serving: batched requests through the continuous batcher
prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [2, 4, 6, 8], [9, 7, 5, 3]]
outs = engine.generate(prompts, max_new_tokens=8)
print(f"generated {sum(len(o) for o in outs)} tokens across {len(outs)} requests")
svc_us = engine.mean_decode_step_us()
where = "the card" if engine.device.type == "cuda" else "CPU"
print(f"measured decode step: {svc_us:.0f} us ({where}, reduced model)")

# 2) deploy the endpoint as a junctiond function; drive the FaaS path
for backend in ("containerd", "junctiond"):
    sim = Simulator(seed=1)
    rt = FaasdRuntime(sim, backend=backend)
    rt.deploy_blocking(FunctionSpec(name="qwen3", work_us=svc_us,
                                    payload_bytes=2048, response_bytes=4096))
    s = run_sequential(rt, "qwen3", n=50)
    overhead_pct = 100 * (s.median_ms - svc_us / 1e3) / s.median_ms
    print(f"{backend:11s}: e2e median={s.median_ms:.3f} ms "
          f"(runtime overhead {overhead_pct:.1f}% of e2e), p99={s.p99_ms:.3f} ms")
