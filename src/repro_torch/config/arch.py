"""Architecture configuration dataclasses.

Every assigned architecture (and the paper's own AES benchmark function)
is expressed as an :class:`ArchConfig`.  The model zoo in
``repro_torch.models`` consumes only this dataclass — nothing architecture
specific leaks into the layer code.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class ArchType(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"          # attention-free (RWKV6)
    HYBRID = "hybrid"    # Mamba + attention interleave (Jamba)
    AUDIO = "audio"      # enc-dec transformer over audio-frame embeddings
    VLM = "vlm"          # decoder transformer over patch+text embeddings
    MICRO = "micro"      # non-LLM FaaS micro-function (paper's AES benchmark)


class BlockKind(str, enum.Enum):
    """Kind of a single residual block in the layer stack."""

    ATTN = "attn"        # attention + MLP (dense)
    ATTN_MOE = "attn_moe"
    MAMBA = "mamba"
    MAMBA_MOE = "mamba_moe"
    RWKV = "rwkv"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    # Router load-balancing auxiliary loss coefficient (Switch-style).
    aux_loss_coef: float = 0.01
    # Capacity factor used by the dispatch kernel / dropless fallback.
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64  # RWKV6 head size (d_model/head_size heads)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder split (seamless-m4t).  ``n_layers`` in ArchConfig is
    the *decoder* depth; the encoder consumes stub frame embeddings."""

    encoder_layers: int = 24
    # Max source positions (audio frames after the conv feature extractor).
    max_source_positions: int = 1500
    cross_attention: bool = True


@dataclasses.dataclass(frozen=True)
class FrontendStub:
    """Modality frontend carve-out: precomputed embeddings of this shape
    are produced by ``input_specs()`` instead of running a ViT/codec."""

    kind: str          # "audio_frames" | "image_patches"
    num_tokens: int    # frames or patches per item
    embed_dim: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: ArchType
    citation: str

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0              # 0 -> d_model // n_heads

    # Attention variants.
    sliding_window: Optional[int] = None   # SWA window (tokens), None = full
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    max_seq_len: int = 1 << 20

    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendStub] = None

    # HYBRID: one attention block every `attn_every` blocks (Jamba 1:7).
    attn_every: int = 0
    # MoE on every `moe_every`-th block (Jamba: every other block).
    moe_every: int = 1

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == ArchType.SSM

    @property
    def supports_long_context_natively(self) -> bool:
        """Sub-quadratic decode without any config override."""
        if self.arch_type in (ArchType.SSM, ArchType.HYBRID):
            return True
        return self.sliding_window is not None

    def block_kinds(self) -> Tuple[BlockKind, ...]:
        """The per-layer block pattern for the full stack."""
        kinds = []
        for i in range(self.n_layers):
            moe_here = self.moe is not None and (i % self.moe_every == (self.moe_every - 1))
            if self.arch_type == ArchType.SSM:
                kinds.append(BlockKind.RWKV)
            elif self.arch_type == ArchType.HYBRID:
                # Jamba: 1 attention layer per `attn_every` block group.
                is_attn = self.attn_every > 0 and (i % self.attn_every == (self.attn_every // 2))
                if is_attn:
                    kinds.append(BlockKind.ATTN_MOE if moe_here else BlockKind.ATTN)
                else:
                    kinds.append(BlockKind.MAMBA_MOE if moe_here else BlockKind.MAMBA)
            else:
                kinds.append(BlockKind.ATTN_MOE if moe_here else BlockKind.ATTN)
        return tuple(kinds)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        from repro_torch.models.flops import param_count  # local import, avoids cycle
        return param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.flops import active_param_count
        return active_param_count(self)

    def validate(self) -> None:
        if self.arch_type == ArchType.MICRO:
            return
        assert self.n_layers > 0 and self.d_model > 0 and self.vocab_size > 0
        if self.arch_type != ArchType.SSM:
            assert self.n_heads > 0 and self.n_kv_heads > 0
            assert self.n_heads % self.n_kv_heads == 0, "GQA requires n_heads % n_kv_heads == 0"
        if self.moe is not None:
            assert self.moe.top_k <= self.moe.num_experts


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 256,
            d_ff: int = 512, vocab_size: int = 512, max_experts: int = 4,
            seq_cap: int = 128) -> ArchConfig:
    """A smoke-test-sized variant of the same family (assignment: 2 layers,
    d_model<=512, <=4 experts)."""
    if cfg.arch_type == ArchType.MICRO:
        return cfg
    heads = max(1, min(cfg.n_heads, d_model // 64))
    kv = max(1, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, num_experts=min(cfg.moe.num_experts, max_experts),
                                  top_k=min(cfg.moe.top_k, min(cfg.moe.num_experts, max_experts)))
    encdec = None
    if cfg.encdec is not None:
        encdec = dataclasses.replace(cfg.encdec, encoder_layers=n_layers,
                                     max_source_positions=32)
    frontend = None
    if cfg.frontend is not None:
        frontend = dataclasses.replace(cfg.frontend, num_tokens=min(cfg.frontend.num_tokens, 16),
                                       embed_dim=d_model)
    attn_every = cfg.attn_every
    if attn_every:
        attn_every = min(attn_every, n_layers)  # keep >=1 attn layer in hybrid smoke
    sw = cfg.sliding_window
    if sw is not None:
        sw = min(sw, seq_cap)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=n_layers, d_model=d_model,
        n_heads=heads, n_kv_heads=kv, d_ff=d_ff, vocab_size=vocab_size,
        head_dim=0, moe=moe, encdec=encdec, frontend=frontend,
        attn_every=attn_every, sliding_window=sw, max_seq_len=seq_cap,
        mamba=cfg.mamba, rwkv=cfg.rwkv)
