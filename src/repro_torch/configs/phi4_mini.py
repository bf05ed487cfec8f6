"""Phi-4-mini 3.8B — dense, RoPE, SwiGLU, GQA.
[arXiv:2412.08905]"""
from repro_torch.config import ArchConfig, ArchType, register


@register("phi4-mini-3.8b")
def phi4_mini() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b",
        arch_type=ArchType.DENSE,
        citation="[arXiv:2412.08905]",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
