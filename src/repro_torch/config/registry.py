"""``--arch <id>`` registry.

Every module in ``repro_torch.configs`` registers its :class:`ArchConfig` here at
import time; ``get_arch()`` lazily imports the package so CLI entry points
can simply call ``get_arch("mixtral-8x7b")``.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List

from repro_torch.config.arch import ArchConfig

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}
_CACHE: Dict[str, ArchConfig] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        if name in _REGISTRY:
            raise ValueError(f"duplicate arch registration: {name}")
        _REGISTRY[name] = fn
        return fn
    return deco


def _ensure_loaded() -> None:
    importlib.import_module("repro_torch.configs")


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _CACHE:
        if name not in _REGISTRY:
            raise KeyError(f"unknown arch {name!r}; choose from {list_archs()}")
        cfg = _REGISTRY[name]()
        cfg.validate()
        _CACHE[name] = cfg
    return _CACHE[name]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)
