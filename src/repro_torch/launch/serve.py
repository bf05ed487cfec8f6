"""Serving launcher: build a model endpoint and measure its prefill and
decode step.

``python -m repro_torch.launch.serve --arch <id> [--device cpu]``

Counterpart of the model half of the JAX package's ``launch/serve.py``,
with its defaults: a reduced float32 variant of the architecture,
``--batch-slots`` prompts of 4 tokens.  It runs on the card unless
``--device cpu`` is given.  Deploying the endpoint behind the FaaS runtime,
and with it the options ``--backend`` and ``--requests``, waits for the
port of the simulator.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.config import get_arch, reduced
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(reduced(get_arch(args.arch)), dtype="float32")
    print(f"serving {args.arch} (reduced, float32) on {args.device} ...")
    eng = ServingEngine(cfg, batch_slots=args.batch_slots, max_seq_len=64,
                        device=args.device)
    prompts = [[1, 2, 3, 4]] * args.batch_slots
    eng.generate(prompts, max_new_tokens=args.max_new_tokens)
    print(f"measured prefill: {1e3 * eng.step_times_s[0]:.3f} ms; "
          f"decode step: {eng.mean_decode_step_us():.0f} us/batch "
          f"({args.batch_slots} slots)")


if __name__ == "__main__":
    main()
