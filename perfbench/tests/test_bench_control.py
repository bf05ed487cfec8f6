"""The control of each served cell on the card, at the cell's own size:
the program's compared number stays within its limit and the control's
(the fp8 reference's first tokens) does not.  Needs a CUDA card; the
benchmark's own runs do not run it.

    PYTHONPATH=src python -m pytest -q -m gpu perfbench/tests/test_bench_control.py
"""
from __future__ import annotations

import pytest

from perfbench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["phi4-mini-3.8b.chat_decode", "mixtral-8x7b.chat_decode",
                                      "mixtral-8x7b.rag_prefill", "phi4-mini-3.8b.train_4k"])
def test_control_fails_and_program_passes(card, workload):
    r = harness.run_cell(workload, 2**31 + 911, 1.0, False, control=True)
    assert r["correct"], r["checks"]
    failed = [k for k, c in r["checks"].items()
              if r["readings"].get(f"fp8.{k}", r["readings"].get(f"control.{k}", 0)) > c["limit"]]
    assert failed, r["readings"]
