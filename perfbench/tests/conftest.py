"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout, with tiny configurations of both families (a dense
decoder with a tied head, and one with routed experts under a window)
added as files and entries, as a later change would add a cell.

    PYTHONPATH=src python -m pytest -q perfbench/tests
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

MOE = {"name": "tiny-moe", "source": "test", "hidden_size": 64, "intermediate_size": 128,
       "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
       "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 256,
       "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "sliding_window": 24,
       "max_position_embeddings": 4096, "tie_word_embeddings": False,
       "torch_dtype": "float32", "moe_capacity_factor": 1.25, "reference": "decoder",
       "program": {"arch": "mixtral-8x7b", "n_layers": 2, "d_model": 64, "n_heads": 4,
                   "n_kv_heads": 2, "d_ff": 128, "vocab_size": 256, "sliding_window": 24,
                   "rope_theta": 10000.0, "dtype": "float32", "moe": {"num_experts": 4}}}
DENSE = {"name": "tiny-dense", "source": "test", "hidden_size": 96, "intermediate_size": 128,
         "num_attention_heads": 6, "num_key_value_heads": 2, "num_hidden_layers": 2,
         "vocab_size": 300, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
         "sliding_window": None, "tie_word_embeddings": True, "torch_dtype": "float32",
         "reference": "decoder",
         "program": {"arch": "phi4-mini-3.8b", "n_layers": 2, "d_model": 96, "n_heads": 6,
                     "n_kv_heads": 2, "d_ff": 128, "vocab_size": 300, "dtype": "float32"}}
SERVE = {"kind": "serve", "loop": "closed", "callers": 1, "batch": 3, "prompt_lens": [20, 30],
         "new_tokens": 5, "trace_invocations": 1, "check_invocations": 2,
         "why": "tiny"}
TRAIN = {"kind": "train", "batch": 2, "seq_len": 24, "lr_d_model": 2048, "lr": 3e-5,
         "warmup_steps": 1, "first_steps": 3, "trace_steps": 1, "why": "tiny"}
#: limits of the tiny cells, which run in fp32 on both sides
LIMITS = {"tiny-moe.serve": {"max_logit_gap": 1e-3, "mean_logit_gap": 1e-4},
          "tiny-dense.serve": {"max_logit_gap": 1e-3},
          "tiny-dense.train": {"grad_norm_gap": 1e-3, "change_norm_gap": 1e-2}}
CELLS = [("tiny-moe.serve", "tiny-moe", "tiny_serve"),
         ("tiny-dense.serve", "tiny-dense", "tiny_serve"),
         ("tiny-dense.train", "tiny-dense", "tiny_train")]


@pytest.fixture
def checkout(tmp_path):
    """(root, bench dir) of a temporary checkout holding the benchmark with
    the tiny cells added as new files and entries only."""
    bd = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bd, ignore=shutil.ignore_patterns("__pycache__"))
    for cfg in (MOE, DENSE):
        (bd / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (bd / "traffic" / "tiny_serve.json").write_text(json.dumps(SERVE))
    (bd / "traffic" / "tiny_train.json").write_text(json.dumps(TRAIN))
    for name, lim in LIMITS.items():
        (bd / "limits" / f"{name}.json").write_text(json.dumps(lim))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] += [{"name": c["name"], "source": "test", "reduced": [], "why": "tiny",
                          "file": f"perfbench/configs/{c['name']}.json"} for c in (MOE, DENSE)]
    bench["workloads"] += [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
                           for n, c, t in CELLS]
    reports = {"output_tokens_per_s": ["tiny-moe.serve", "tiny-dense.serve"],
               "invocation_ms_p95": ["tiny-moe.serve", "tiny-dense.serve"],
               "train_tokens_per_s": ["tiny-dense.train"]}
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += reports.get(m["name"], [])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, bd
