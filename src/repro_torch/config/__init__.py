from repro_torch.config.arch import (ArchConfig, ArchType, BlockKind,
                                     EncDecConfig, FrontendStub, MambaConfig,
                                     MoEConfig, RWKVConfig, reduced,
                                     reduced_grouped)
from repro_torch.config.registry import get_arch, list_archs, register
from repro_torch.config.shapes import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                       PREFILL_32K, SHAPES, TRAIN_4K,
                                       InputShape, StepKind, get_shape)

__all__ = [
    "ArchConfig", "ArchType", "BlockKind", "EncDecConfig", "FrontendStub",
    "MambaConfig", "MoEConfig", "RWKVConfig", "reduced", "reduced_grouped",
    "get_arch", "list_archs", "register",
    "ALL_SHAPES", "SHAPES", "InputShape", "StepKind", "get_shape",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
