"""Pixtral-12B — VLM: pixtral-ViT frontend (STUB) + mistral-nemo decoder.
The ViT vision encoder + projector is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings.
[hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.config import ArchConfig, ArchType, FrontendStub, register


@register("pixtral-12b")
def pixtral_12b() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b",
        arch_type=ArchType.VLM,
        citation="[hf:mistralai/Pixtral-12B-2409]",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1_000_000.0,
        head_dim=128,
        frontend=FrontendStub(kind="image_patches", num_tokens=1024, embed_dim=5120),
    )
