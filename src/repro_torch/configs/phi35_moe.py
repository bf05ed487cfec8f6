"""Phi-3.5-MoE 42B (6.6B active) — MoE 16 experts top-2, GQA.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.config import ArchConfig, ArchType, MoEConfig, register


@register("phi3.5-moe-42b-a6.6b")
def phi35_moe() -> ArchConfig:
    return ArchConfig(
        name="phi3.5-moe-42b-a6.6b",
        arch_type=ArchType.MOE,
        citation="[hf:microsoft/Phi-3.5-MoE-instruct]",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        rope_theta=10_000.0,
        moe=MoEConfig(num_experts=16, top_k=2),
    )
