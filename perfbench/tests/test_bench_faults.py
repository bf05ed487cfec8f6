"""A run with the timed path broken underneath comes out not correct, for
each fault the cells can have: a token altered where it is produced (the
served cells), a step that leaves its state unchanged and half of the
batch left out of the mean (the training cell).  The cells run on one card
and have no exchange between chips to leave out.  The look for a card is
skipped: the tiny cells run on the CPU."""
from __future__ import annotations

import pytest
import torch

from perfbench import harness


def run(checkout, workload):
    root, bd = checkout
    return harness.run_cell(workload, 2**31 + 5, 0.3, False, device="cpu", root=root,
                            bench_dir=bd)


@pytest.mark.parametrize("workload", ["tiny-moe.serve", "tiny-dense.serve"])
def test_a_token_altered_where_produced(checkout, monkeypatch, workload):
    from repro_torch.serving import engine
    real = engine.sample

    def altered(logits, gen, temperature=0.0, top_k=0):
        tok = real(logits, gen, temperature, top_k)
        return (tok + 1) % logits.shape[-1]
    assert run(checkout, workload)["correct"]
    monkeypatch.setattr(engine, "sample", altered)
    assert not run(checkout, workload)["correct"]


def test_a_step_that_leaves_its_state_unchanged(checkout, monkeypatch):
    from repro_torch.train import train_loop

    def unchanged(cfg, params, grads, state):
        return params, state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}
    monkeypatch.setattr(train_loop, "apply_updates", unchanged)
    r = run(checkout, "tiny-dense.train")
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] > r["checks"]["change_norm_gap"]["limit"]


def test_half_of_the_batch_left_out(checkout, monkeypatch):
    from repro_torch.train import train_loop
    real = train_loop.cross_entropy

    def half(logits, labels, mask=None):
        keep = torch.zeros_like(labels, dtype=torch.float32)
        keep[: labels.shape[0] // 2] = 1.0
        return real(logits, labels, keep)
    monkeypatch.setattr(train_loop, "cross_entropy", half)
    assert not run(checkout, "tiny-dense.train")["correct"]
