"""The weights of a decoder configuration, drawn on the device from the seed.

The benchmark makes the weights itself and hands the same tensors to the
program (``ServingEngine(params=...)``, the training step) and to the plain
reference, so that neither takes anything the other made.  The tree has
the layout the port's models read (``repro_torch.models.transformer``:
weights ``(d_in, d_out)`` applied as ``x @ W``, every layer's tensor of one
kind stacked on a leading axis, the router in fp32, the experts stacked on
an axis after the layers).  Each leaf is one ``normal_`` call on the card
with a ``torch.Generator`` seeded from the seed, in the configuration's
``torch_dtype`` (bf16), the type the model is served in: about a dozen large calls for a model.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench.work.counts import dims

#: (path, shape, dtype, std); std None means ones (a norm's weight)
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], torch.dtype, object]


def layout(cfg: dict) -> List[Leaf]:
    m = dims(cfg)
    d, f, L, hd, E = m["d"], m["f"], m["L"], m["hd"], m["E"]
    bf = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["torch_dtype"]]
    leaves: List[Leaf] = [
        (("embed",), (m["v"], d), bf, 0.02),
        (("final_norm",), (d,), bf, None),
    ]
    if not cfg.get("tie_word_embeddings"):
        leaves.append((("lm_head",), (d, m["v"]), bf, d ** -0.5))
    blk = ("blocks", 0)
    leaves += [
        (blk + ("ln1",), (L, d), bf, None),
        (blk + ("attn", "wq"), (L, d, m["h"] * hd), bf, d ** -0.5),
        (blk + ("attn", "wk"), (L, d, m["kv"] * hd), bf, d ** -0.5),
        (blk + ("attn", "wv"), (L, d, m["kv"] * hd), bf, d ** -0.5),
        (blk + ("attn", "wo"), (L, m["h"] * hd, d), bf, (m["h"] * hd) ** -0.5),
        (blk + ("ln2",), (L, d), bf, None),
    ]
    if E:
        leaves += [
            (blk + ("moe", "router"), (L, d, E), torch.float32, d ** -0.5),
            (blk + ("moe", "w_gate"), (L, E, d, f), bf, d ** -0.5),
            (blk + ("moe", "w_up"), (L, E, d, f), bf, d ** -0.5),
            (blk + ("moe", "w_down"), (L, E, f, d), bf, f ** -0.5),
        ]
    else:
        leaves += [
            (blk + ("mlp", "w_gate"), (L, d, f), bf, d ** -0.5),
            (blk + ("mlp", "w_up"), (L, d, f), bf, d ** -0.5),
            (blk + ("mlp", "w_down"), (L, f, d), bf, f ** -0.5),
        ]
    return leaves


def make(cfg: dict, seed: int, device) -> dict:
    """The tree of ``layout(cfg)`` on ``device``, drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tree: Dict = {}
    for path, shape, dtype, std in layout(cfg):
        t = torch.empty(shape, dtype=dtype, device=device)
        if std is None:
            t.fill_(1.0)
        else:
            t.normal_(0.0, std, generator=gen)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    if "blocks" in tree:
        tree["blocks"] = tuple(tree["blocks"][i] for i in sorted(tree["blocks"]))
    return tree


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree in sorted-key order (the port's ``tree_leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [tree]

