from repro_torch.config.arch import (ArchConfig, ArchType, BlockKind,
                                     EncDecConfig, FrontendStub, MambaConfig,
                                     MoEConfig, RWKVConfig, reduced)
from repro_torch.config.registry import get_arch, list_archs, register

__all__ = [
    "ArchConfig", "ArchType", "BlockKind", "EncDecConfig", "FrontendStub",
    "MambaConfig", "MoEConfig", "RWKVConfig", "reduced",
    "get_arch", "list_archs", "register",
]
