"""The plain reference against the port's CPU path at tiny sizes of both
families, in fp32: the full forward's logits, a served batch's gaps, and
three training steps."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import decoder
from perfbench.tests.conftest import DENSE, MOE, TRAIN


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["dense", "moe"])
def test_forward_matches_the_port(cfg):
    from repro_torch.models import transformer as T
    arch = harness.program_arch(cfg)
    params = weights.make(cfg, 11, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (3, 40), generator=torch.Generator().manual_seed(1))
    logits, _ = T.forward(params, arch, {"tokens": tokens})
    # one dispatch of all 3 x 40 tokens, as the port's forward routes them
    hid = decoder.served_hidden(params, cfg, tokens, prompt_len=40)
    ref = hid[:, -1] @ decoder.head(params, cfg).float()
    torch.testing.assert_close(ref, logits[:, -1].float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["dense", "moe"])
def test_served_tokens_have_no_gap(cfg):
    from repro_torch.serving.engine import ServingEngine
    arch = harness.program_arch(cfg)
    params = weights.make(cfg, 12, "cpu")
    eng = ServingEngine(arch, batch_slots=4, max_seq_len=64, device="cpu", params=params)
    prompts = torch.randint(0, cfg["vocab_size"], (4, 30), generator=torch.Generator().manual_seed(2))
    served = torch.tensor(eng.generate(prompts.tolist(), max_new_tokens=8))
    gaps = decoder.served_gaps(params, cfg, prompts, served, others=("fp8",))
    assert float(gaps["gap"].max()) < 1e-4
    assert float(gaps["fp8_gap"].max()) > float(gaps["gap"].max())


def test_capacity_drops_pairs_in_token_order():
    cfg = dict(MOE, num_local_experts=2, num_experts_per_tok=1, moe_capacity_factor=1.0)
    router = torch.tensor([[1.0, -1.0]] * 4)
    h = torch.tensor([[1.0, 0, 0, 0]] * 3 + [[-1.0, 0, 0, 0]])
    group = torch.zeros(4, dtype=torch.long)
    expert, _, kept = decoder.route(h, router, cfg, group, torch.tensor([4]))
    # capacity 1 * 1 * 4 / 2 = 2: the first two tokens of expert 0 kept, the third dropped
    assert expert[:, 0].tolist() == [0, 0, 0, 1]
    assert kept[:, 0].tolist() == [True, True, False, True]


def test_training_steps_match_the_port():
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_loop import make_train_step
    from perfbench.traffic import Train
    cfg = DENSE
    arch = harness.program_arch(cfg)
    opt = harness.optimizer_config(cfg, TRAIN)
    gen = Train(TRAIN, 5, cfg["vocab_size"])
    batches = [gen.batch(i, "cpu") for i in range(3)]
    params = weights.make(cfg, 5, "cpu")
    for p in weights.leaves(params):
        p.requires_grad_(True)
    state = init_state(params)
    step = make_train_step(arch, AdamWConfig(**opt), remat=True)
    losses = [float(step(params, state, b)[2]["loss"]) for b in batches]
    r = decoder.train_steps(lambda: weights.make(cfg, 5, "cpu"), cfg, batches, opt)
    assert losses == pytest.approx(r["losses"], rel=1e-5)
    start = weights.leaves(weights.make(cfg, 5, "cpu"))
    change = [float((p.detach() - q).norm()) for p, q in zip(weights.leaves(params), start)]
    assert change == pytest.approx(r["change_norms"], rel=1e-3, abs=1e-7)
    assert dataclasses.is_dataclass(AdamWConfig)
