"""DeepSeek-67B — dense llama-architecture, deep (95L), GQA.
[arXiv:2401.02954]"""
from repro_torch.config import ArchConfig, ArchType, register


@register("deepseek-67b")
def deepseek_67b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-67b",
        arch_type=ArchType.DENSE,
        citation="[arXiv:2401.02954]",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        rope_theta=10_000.0,
    )
