"""The work counts against values worked by hand at both configurations'
shapes, and the rooflines' arithmetic."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from perfbench.work import counts

CONFIGS = Path(counts.__file__).resolve().parents[1] / "configs"
MIX = json.loads((CONFIGS / "mixtral-8x7b.json").read_text())
PHI = json.loads((CONFIGS / "phi4-mini-3.8b.json").read_text())


def test_parameters_by_hand():
    # phi4-mini: q, o 3072 x 3072; k, v 3072 x 1024; SwiGLU 3 x 3072 x 8192; two norms
    layer = 2 * 3072 * 3072 + 2 * 3072 * 1024 + 3 * 3072 * 8192 + 2 * 3072
    assert layer == 100_669_440
    assert counts.param_count(PHI) == 32 * layer + 200_064 * 3072 + 3072 == 3_836_021_760
    # mixtral: the same attention at 4096, 8 experts of 3 x 4096 x 14336, a router
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    full = dict(MIX, num_hidden_layers=32)
    per = attn + 8 * 3 * 4096 * 14336 + 4096 * 8 + 2 * 4096
    assert counts.param_count(full) == 32 * per + 2 * 32000 * 4096 + 4096 == 46_702_792_704
    active = attn + 2 * 3 * 4096 * 14336 + 4096 * 8 + 2 * 4096
    assert counts.nonembedding_active(full) == 32 * active == 12_617_777_152


def test_prefill_experts_and_attention_by_hand():
    # 4 prompts of 4096: 16384 tokens at 2 experts, 6 d f a pair
    e = counts.experts(MIX, 4 * 4096)
    assert e["flops"] == 6.0 * 32768 * 4096 * 14336 == 11_544_872_091_648
    assert e["bytes"] == 3 * 8 * 4096 * 14336 * 2 + 32768 * (2 * 4096 + 3 * 14336) * 2
    # causal pairs of 4096 queries over the full context: 4096 * 4097 / 2
    a = counts.attention_fwd(MIX, 4, 0, 4096)
    assert a["flops"] == 4.0 * 4 * 32 * 128 * (4096 * 4097 // 2)
    # a decode step at position 4100 sees all 4101 keys; under a 4096 window, 4096
    assert counts.attention_fwd(MIX, 4, 4100, 1)["bytes"] == 2 * 4 * 32 * 128 * 2 + 2 * 4 * 4101 * 8 * 128 * 2
    assert counts.attended_pairs(4100, 1, 4096) == 4096
    assert counts.attended_pairs(100, 1, 4096) == 101


def test_decode_step_bytes_by_hand():
    d = counts.decode_step(PHI, 32, 1000)
    kv = 32 * 2 * 32 * 1001 * 8 * 128 * 2
    qo = 32 * 2 * 32 * 24 * 128 * 2
    assert d["bytes"] == 3_836_021_760 * 2 + kv + qo + 32 * 200_064 * 2
    assert counts.adamw(PHI)["bytes"] == 3_836_021_760 * 22


def test_share_is_the_bound_over_the_time():
    work = {"flops": 989e12, "bytes": 3.35e12 / 2}
    assert counts.share(work, 2.0) == pytest.approx(50.0)
    assert counts.share(work, 0.0) is None
