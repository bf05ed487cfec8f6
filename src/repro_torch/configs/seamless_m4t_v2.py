"""SeamlessM4T-Large v2 — encoder-decoder multimodal transformer backbone.
The mel-spectrogram + conv feature extractor frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed frame embeddings.
[arXiv:2308.11596]"""
from repro_torch.config import (ArchConfig, ArchType, EncDecConfig,
                                FrontendStub, register)


@register("seamless-m4t-large-v2")
def seamless_m4t_v2() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2",
        arch_type=ArchType.AUDIO,
        citation="[arXiv:2308.11596]",
        n_layers=24,              # decoder layers (backbone)
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,            # GQA kv=16 == MHA here
        d_ff=8192,
        vocab_size=256206,
        rope_theta=10_000.0,
        encdec=EncDecConfig(encoder_layers=24, max_source_positions=1500),
        frontend=FrontendStub(kind="audio_frames", num_tokens=1500, embed_dim=1024),
    )
