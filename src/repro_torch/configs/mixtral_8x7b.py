"""Mixtral-8x7B — MoE 8 experts top-2, GQA, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.config import ArchConfig, ArchType, MoEConfig, register


@register("mixtral-8x7b")
def mixtral_8x7b() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b",
        arch_type=ArchType.MOE,
        citation="[arXiv:2401.04088]",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        sliding_window=4096,
        rope_theta=1_000_000.0,
        moe=MoEConfig(num_experts=8, top_k=2),
    )
