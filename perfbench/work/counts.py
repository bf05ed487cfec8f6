"""Operations and bytes that one operation of a served or trained decoder
needs, from its configuration file's published keys and the shapes of the
inputs: the yardstick of every roofline and mfu share.

A frozen copy of the port's analytic arithmetic (``models/flops.py``:
2·N·D a forward, 6·N·D a training step, N the active parameters without
the embedding, causal attention counted over the pairs it attends), with
the bytes added.  Each input byte is counted read once and each output
byte written once, whatever a kernel reads again; where the work depends
on the data (routing), the count is what these inputs need: every token
at its ``num_experts_per_tok`` experts.  The peaks are the H100 SXM data
sheet's dense rates.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAK_FLOPS = 989e12      # bf16 dense, FLOP/s
PEAK_BYTES = 3.35e12     # HBM3, B/s
BF16, FP32 = 2, 4


def dims(cfg: dict) -> Dict[str, int]:
    """The sizes the counts use, from a configuration file's keys."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "f": cfg["intermediate_size"], "h": h,
            "kv": cfg["num_key_value_heads"], "hd": cfg.get("head_dim") or d // h,
            "v": cfg["vocab_size"], "L": cfg["num_hidden_layers"],
            "E": cfg.get("num_local_experts", 0), "k": cfg.get("num_experts_per_tok", 0)}


def window(cfg: dict) -> Optional[int]:
    return cfg.get("sliding_window")


def attended_pairs(q_start: int, n_q: int, win: Optional[int]) -> int:
    """(query, key) pairs that causal attention with a window ``win`` (None:
    none) takes for queries at positions q_start .. q_start + n_q - 1, each
    attending to itself and the keys before it."""
    if win is None:
        return sum(q + 1 for q in range(q_start, q_start + n_q))
    return sum(min(q + 1, win) for q in range(q_start, q_start + n_q))


def attention_fwd(cfg: dict, batch: int, q_start: int, n_q: int) -> Dict[str, float]:
    """One layer's attention core (scores and the weighted values), not the
    projections, for ``batch`` rows of ``n_q`` queries from ``q_start``:
    flops 4·h·hd a pair; bytes q and o once, and the keys and values the
    queries reach once (a prefill's S, a decode step's valid slots)."""
    m = dims(cfg)
    pairs = attended_pairs(q_start, n_q, window(cfg))
    keys = q_start + n_q if window(cfg) is None else min(q_start + n_q, window(cfg))
    flops = 4.0 * batch * m["h"] * m["hd"] * pairs
    qo = 2 * batch * n_q * m["h"] * m["hd"] * BF16
    kv = 2 * batch * keys * m["kv"] * m["hd"] * BF16
    return {"flops": flops, "bytes": float(qo + kv)}


def attention_bwd(cfg: dict, batch: int, seq: int) -> Dict[str, float]:
    """One layer's flash backward over a causal prompt of ``seq``: five
    products (scores again, dP, dV, dQ, dK) of 2·h·hd a pair; bytes q, k, v,
    o, dO and the row statistics read once, dq, dk, dv written once."""
    m = dims(cfg)
    pairs = attended_pairs(0, seq, window(cfg))
    flops = 10.0 * batch * m["h"] * m["hd"] * pairs
    qsize = batch * seq * m["h"] * m["hd"] * BF16
    kvsize = batch * seq * m["kv"] * m["hd"] * BF16
    lse = batch * seq * m["h"] * FP32
    return {"flops": flops, "bytes": float(3 * qsize + 2 * kvsize + lse + qsize + 2 * kvsize)}


def experts(cfg: dict, tokens: int, touched: Optional[int] = None) -> Dict[str, float]:
    """One layer's expert products (gate, up, down) for ``tokens`` tokens at
    ``num_experts_per_tok`` experts each: flops 6·d·f a pair; bytes the
    weights of ``touched`` experts (all, by default) and the pairs' rows in
    and out."""
    m = dims(cfg)
    pairs = tokens * m["k"]
    touched = m["E"] if touched is None else touched
    w = 3 * touched * m["d"] * m["f"] * BF16
    act = pairs * (2 * m["d"] + 3 * m["f"]) * BF16
    return {"flops": 6.0 * pairs * m["d"] * m["f"], "bytes": float(w + act)}


def layer_params(cfg: dict, active: bool) -> int:
    """Parameters of one layer: attention, norms, and the MLP or the router
    and the experts (``active``: the ``num_experts_per_tok`` a token uses)."""
    m = dims(cfg)
    attn = m["d"] * m["h"] * m["hd"] * 2 + m["d"] * m["kv"] * m["hd"] * 2
    norms = 2 * m["d"]
    if m["E"]:
        n = m["k"] if active else m["E"]
        return attn + norms + m["d"] * m["E"] + 3 * n * m["d"] * m["f"]
    return attn + norms + 3 * m["d"] * m["f"]


def weight_bytes(cfg: dict) -> float:
    """Every weight once: the layers, the embedding and the head (once
    where tied), the final norm; bf16, the router in fp32."""
    m = dims(cfg)
    per = layer_params(cfg, active=False) * BF16
    if m["E"]:
        per += m["d"] * m["E"] * (FP32 - BF16)
    emb = m["v"] * m["d"] * (1 if cfg.get("tie_word_embeddings") else 2)
    return float(m["L"] * per + (emb + m["d"]) * BF16)


def nonembedding_active(cfg: dict) -> int:
    return dims(cfg)["L"] * layer_params(cfg, active=True)


def prefill_step(cfg: dict, batch: int, seq: int) -> Dict[str, float]:
    """A prefill of ``batch`` prompts of ``seq`` tokens: 2·N_active a token,
    the attention over the causal pairs, the last position's logits; bytes
    every weight, the prompt's keys and values written to the cache, the
    logits."""
    m = dims(cfg)
    tokens = batch * seq
    attn = attention_fwd(cfg, batch, 0, seq)
    flops = 2.0 * nonembedding_active(cfg) * tokens + m["L"] * attn["flops"]
    flops += 2.0 * m["d"] * m["v"] * batch
    cache = m["L"] * 2 * tokens * m["kv"] * m["hd"] * BF16
    return {"flops": flops, "bytes": weight_bytes(cfg) + cache + batch * m["v"] * BF16}


def decode_step(cfg: dict, batch: int, pos: int) -> Dict[str, float]:
    """One decode step of ``batch`` rows at position ``pos``: 2·N_active a
    row, attention over the valid slots, the logits; bytes every weight
    (every expert: at these batches each is hit), the valid cache read and
    one slot written, the logits."""
    m = dims(cfg)
    attn = attention_fwd(cfg, batch, pos, 1)
    flops = 2.0 * nonembedding_active(cfg) * batch + m["L"] * attn["flops"]
    flops += 2.0 * m["d"] * m["v"] * batch
    return {"flops": flops,
            "bytes": weight_bytes(cfg) + m["L"] * attn["bytes"] + batch * m["v"] * BF16}


def train_step(cfg: dict, batch: int, seq: int) -> Dict[str, float]:
    """A training step on ``batch`` x ``seq`` tokens: 6·N_active a token,
    three times the forward attention, the head forward and backward
    (``models/flops.py``'s train count); bytes the weights read, their
    gradients written and read, and the optimizer's pass (``adamw``)."""
    m = dims(cfg)
    tokens = batch * seq
    attn = attention_fwd(cfg, batch, 0, seq)
    flops = 6.0 * nonembedding_active(cfg) * tokens + 3.0 * m["L"] * attn["flops"]
    flops += 6.0 * m["d"] * m["v"] * tokens
    n = param_count(cfg)
    return {"flops": flops, "bytes": float(n * BF16 * 2) + adamw(cfg)["bytes"]}


def param_count(cfg: dict) -> int:
    m = dims(cfg)
    emb = m["v"] * m["d"] * (1 if cfg.get("tie_word_embeddings") else 2)
    return m["L"] * layer_params(cfg, active=False) + emb + m["d"]


def adamw(cfg: dict) -> Dict[str, float]:
    """The AdamW update of every parameter: bf16 parameter read and written,
    bf16 gradient read, fp32 moments read and written (22 bytes a
    parameter); about 20 fp32 operations an element."""
    n = param_count(cfg)
    return {"flops": 20.0 * n, "bytes": float(n * (2 * BF16 + BF16 + 4 * FP32))}


def share(work: Dict[str, float], seconds: float) -> Optional[float]:
    """The least time the chip could take for ``work`` (the larger of its
    operations at the bf16 peak and its bytes at the HBM peak) as a
    percentage of ``seconds``; None where nothing ran."""
    if not seconds or seconds <= 0:
        return None
    least = max(work["flops"] / PEAK_FLOPS, work["bytes"] / PEAK_BYTES)
    return 100.0 * least / seconds


def add(*works: Dict[str, float]) -> Dict[str, float]:
    return {"flops": sum(w["flops"] for w in works), "bytes": sum(w["bytes"] for w in works)}
