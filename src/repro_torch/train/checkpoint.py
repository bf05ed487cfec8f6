"""Checkpointing: flattened-tree .npz snapshots with step metadata.

Counterpart of the JAX package's ``train/checkpoint.py``, in its format:
the same keys (``params/<path>`` and ``opt/<path>``, a path's parts joined
by "/", dict keys as they are, tuple positions as numbers and the
``AdamWState`` fields as ``.step``, ``.mu`` and ``.nu``, the strings
``jax.tree_util.tree_flatten_with_path`` gives), the same ``__meta__``
JSON and the same arrays.  A bf16 tensor is written as the JAX package's
bfloat16 arrays land in the file, two raw bytes an element (numpy's
``V2``), and read back from that form.  So each package reads the other's
files.  Atomic: written to a temporary file, then renamed.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _items(tree, prefix: str = ""):
    """(key, tensor) for every leaf, keyed as ``checkpoint._flatten`` of
    the JAX package keys it."""
    if hasattr(tree, "_fields"):                       # a NamedTuple: attribute keys
        for name in tree._fields:
            yield from _items(getattr(tree, name), f"{prefix}.{name}/")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor of ``like``'s dtype on its device: a bf16 array
    (``V2``, or ml_dtypes' bfloat16) by its bits, anything else cast."""
    if (a.dtype.kind == "V" and a.dtype.itemsize == 2) or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in _items(tree)}


def save(path: str, params: Any, opt_state: Any = None, step: int = 0,
         extra: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"params/{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        payload.update({f"opt/{k}": v for k, v in _flatten(opt_state).items()})
    meta = json.dumps({"step": step, **(extra or {})})
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".npz")
    os.close(fd)
    np.savez(tmp, __meta__=np.frombuffer(meta.encode(), np.uint8), **payload)
    os.replace(tmp, path)


def _fill(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    if hasattr(template, "_fields"):
        return type(template)(*(_fill(getattr(template, n), flat, f"{prefix}.{n}/")
                                for n in template._fields))
    if isinstance(template, dict):
        return {k: _fill(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, tuple):
        return tuple(_fill(v, flat, f"{prefix}{i}/") for i, v in enumerate(template))
    key = prefix[:-1]
    arr = flat[key]
    assert arr.shape == tuple(template.shape), (key, arr.shape, tuple(template.shape))
    return _to_tensor(arr, template)


def restore(path: str, params_template: Any,
            opt_template: Any = None) -> Tuple[Any, Any, int]:
    """(params, opt state or None, step) in the templates' structure, each
    tensor in its template's dtype and on its device."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat_p = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
        flat_o = {k[len("opt/"):]: z[k] for k in z.files if k.startswith("opt/")}
    params = _fill(params_template, flat_p)
    opt = _fill(opt_template, flat_o) if (opt_template is not None and flat_o) else None
    return params, opt, int(meta["step"])
