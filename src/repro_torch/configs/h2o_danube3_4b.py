"""H2O-Danube-3 4B — dense llama+mistral mix, GQA, sliding-window attention.
[arXiv:2401.16818]"""
from repro_torch.config import ArchConfig, ArchType, register


@register("h2o-danube-3-4b")
def h2o_danube3() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b",
        arch_type=ArchType.DENSE,
        citation="[arXiv:2401.16818]",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        sliding_window=4096,
        rope_theta=10_000.0,
    )
