"""RWKV-6 (Finch) 1.6B — attention-free SSM with data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.config import ArchConfig, ArchType, RWKVConfig, register


@register("rwkv6-1.6b")
def rwkv6_1p6b() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-1.6b",
        arch_type=ArchType.SSM,
        citation="[arXiv:2404.05892]",
        n_layers=24,
        d_model=2048,
        n_heads=0,             # attention-free
        n_kv_heads=0,
        d_ff=7168,
        vocab_size=65536,
        rwkv=RWKVConfig(head_size=64),
    )
