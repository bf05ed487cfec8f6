"""Serving launcher: build a model endpoint, measure its decode step and
deploy it behind the faasd runtime on containerd or junctiond.

``python -m repro_torch.launch.serve --arch <id> [--backend junctiond]
[--requests 40] [--device cpu]``

Counterpart of the JAX package's ``launch/serve.py`` and of its
``examples/serve_e2e.py``, with their defaults: a reduced float32 variant
of the architecture, ``--batch-slots`` prompts of 4 tokens, the measured
decode step as the function body of a ``FunctionSpec`` with a 2 KiB
request and a 4 KiB response, and ``--requests`` sequential invocations
through the simulated runtime (``Simulator(seed=0)``).  The model runs on
the card unless ``--device cpu`` is given; the FaaS latencies are simulated
on the host from the paper's host costs, with only the decode step measured.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--backend", default="junctiond",
                    choices=["junctiond", "containerd"])
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.config import get_arch, reduced
    from repro_torch.core import (FaasdRuntime, FunctionSpec, Simulator,
                                  run_sequential)
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(reduced(get_arch(args.arch)), dtype="float32")
    print(f"deploying {args.arch} (reduced, float32, on {args.device}) "
          f"behind {args.backend} ...")
    eng = ServingEngine(cfg, batch_slots=args.batch_slots, max_seq_len=64,
                        device=args.device)
    # measure the real decode step -> the function body cost
    prompts = [[1, 2, 3, 4]] * args.batch_slots
    eng.generate(prompts, max_new_tokens=args.max_new_tokens)
    svc_us = eng.mean_decode_step_us()
    print(f"measured prefill: {1e3 * eng.step_times_s[0]:.3f} ms; "
          f"decode step: {svc_us:.0f} us/batch ({args.batch_slots} slots)")

    sim = Simulator(seed=0)
    rt = FaasdRuntime(sim, backend=args.backend)
    rt.deploy_blocking(FunctionSpec(name=args.arch, work_us=svc_us,
                                    payload_bytes=2048, response_bytes=4096))
    summary = run_sequential(rt, args.arch, n=args.requests)
    print(f"{args.requests} invocations through the {args.backend} runtime "
          f"(simulated): median={summary.median_ms:.3f} ms  "
          f"p99={summary.p99_ms:.3f} ms")
    overhead = summary.median_ms - svc_us * 1e-3
    print(f"FaaS runtime overhead at median: {overhead:.3f} ms "
          f"({100 * overhead / summary.median_ms:.1f}% of e2e)")
    return summary


if __name__ == "__main__":
    main()
