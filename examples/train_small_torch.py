"""Train a ~100M-parameter dense model for a few hundred steps on the
synthetic-but-learnable LM stream: the PyTorch port's counterpart of
``examples/train_small.py``, the same model, data and schedule.

    PYTHONPATH=src python examples/train_small_torch.py [--steps 300] [--device cpu]

It trains on the card unless ``--device cpu`` is given.  The checkpoint
goes to ``build/demo100m_torch.npz`` under the repository root, in the
JAX package's format.
"""
import argparse
from pathlib import Path

from repro_torch.config import ArchConfig, ArchType
from repro_torch.train import AdamWConfig, DataConfig, SyntheticLM, train

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--seq-len", type=int, default=256)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

# ~100M params: 12L, d=768, llama-style (GQA 12/4 heads, SwiGLU)
cfg = ArchConfig(
    name="demo-100m", arch_type=ArchType.DENSE, citation="[this-repo]",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
    vocab_size=32000, dtype="float32")
print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
      f"{args.steps} steps @ batch {args.batch} x seq {args.seq_len} on {args.device}")

ckpt = Path(__file__).resolve().parent.parent / "build" / "demo100m_torch.npz"
dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                batch_size=args.batch, seed=0)
res = train(cfg, SyntheticLM(dc).batches(), steps=args.steps,
            opt_cfg=AdamWConfig(lr=6e-4, warmup_steps=20,
                                total_steps=args.steps),
            log_every=20, checkpoint_path=str(ckpt),
            checkpoint_every=100, device=args.device)
h = res["history"]
print(f"\nloss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}; checkpoint at {ckpt}")
