"""Qwen3-1.7B — dense, GQA (kv=8), qk-norm, large vocab.
[hf:Qwen/Qwen3-8B]"""
from repro_torch.config import ArchConfig, ArchType, register


@register("qwen3-1.7b")
def qwen3_1p7b() -> ArchConfig:
    return ArchConfig(
        name="qwen3-1.7b",
        arch_type=ArchType.DENSE,
        citation="[hf:Qwen/Qwen3-8B]",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        head_dim=128,
        tie_embeddings=True,
    )
