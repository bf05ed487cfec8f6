"""Jamba v0.1 52B — hybrid Mamba + attention (1 attn per 8 blocks), MoE 16e
top-2 on every other block. [arXiv:2403.19887]"""
from repro_torch.config import ArchConfig, ArchType, MambaConfig, MoEConfig, register


@register("jamba-v0.1-52b")
def jamba_v01() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b",
        arch_type=ArchType.HYBRID,
        citation="[arXiv:2403.19887]",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        moe=MoEConfig(num_experts=16, top_k=2),
        moe_every=2,          # MoE on every other block (Jamba e=2)
        attn_every=8,         # 1 attention layer per 8 (Mamba:attn 7:1)
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    )
