"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu|cuda]``.

Counterpart of the JAX package's ``launch/train.py``, with its defaults:
``SyntheticLM`` batches of ``--batch`` x ``--seq-len`` tokens, AdamW with
``--lr``, warmup over a tenth of the steps (at least 2) and cosine decay
over ``--steps``.  ``--smoke`` trains the reduced float32 variant of the
architecture; without it, the full config at its own dtype, which must fit
one card.  It trains on the card unless ``--device cpu`` is given, and
raises without a card rather than train on the CPU.  On the card the step
is captured as one CUDA graph and replayed.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced float32 config")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from repro_torch.config import get_arch, reduced
    from repro_torch.train import AdamWConfig, DataConfig, SyntheticLM, train

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    batch_size=args.batch)
    res = train(cfg, SyntheticLM(dc).batches(), steps=args.steps,
                opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                                    total_steps=args.steps),
                checkpoint_path=args.checkpoint,
                checkpoint_every=50 if args.checkpoint else 0, device=args.device)
    h = res["history"]
    print(f"\nfinal: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} over "
          f"{args.steps} steps ({h[-1]['elapsed_s']:.1f}s) on {args.device}")
    return res


if __name__ == "__main__":
    main()
