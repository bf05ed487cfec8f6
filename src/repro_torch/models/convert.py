"""Carry weights across from the JAX package.

The JAX model keeps its parameters as a pytree; ``repro/train/checkpoint.py``
flattens it to ``{"blocks/0/attn/wq": array, ...}``, where ``blocks/0`` is
the first in-group position of the stack plan and every array under it has
the layer axis first.  The port's tree has the same shape and layout, so
the bridge is a plain copy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tuples(node):
    """Turn every dict keyed "0".."n-1" into a tuple, as in the JAX tree."""
    if not isinstance(node, dict):
        return node
    out = {k: _tuples(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return tuple(out[str(i)] for i in range(len(out)))
    return out


def params_from_jax(flat: Dict[str, np.ndarray], device="cuda") -> dict:
    """The port's parameter tree, on ``device``, from a flattened JAX tree."""
    root: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = _tensor(arr).to(device)
    return _tuples(root)
