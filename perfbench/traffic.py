"""The one generator of every traffic mix: a mix file's parameters and the
seed give the inputs of each invocation or step.

Every seed gets the same amount of work, in another order: a served mix
runs through its ``prompt_lens`` in blocks that hold each length once, the
block's order drawn from the seed; the tokens of every prompt are drawn
from the seed and the invocation's index.  A training mix draws each
step's sequences from the seed and the step's index, so no two steps see
the same rows.
"""
from __future__ import annotations

from typing import List

import numpy as np


def _rng(seed: int, *index: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, *index])


class Serve:
    """Invocations of a served mix: ``lens(i)`` the prompt length of
    invocation i, ``prompts(i)`` its ``batch`` prompts of token ids below
    ``vocab``."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        if mix.get("loop") != "closed" or mix.get("callers") != 1:
            raise ValueError("a served mix is a closed loop of one caller")
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.batch, self.new_tokens = mix["batch"], mix["new_tokens"]
        self.lengths = list(mix["prompt_lens"])

    def lens(self, i: int) -> int:
        n = len(self.lengths)
        order = _rng(self.seed, 0, i // n).permutation(n)
        return self.lengths[order[i % n]]

    def prompts(self, i: int) -> List[List[int]]:
        toks = _rng(self.seed, 1, i).integers(0, self.vocab, (self.batch, self.lens(i)))
        return toks.tolist()

    def warm_prompts(self, length: int) -> List[List[int]]:
        return _rng(self.seed, 2, length).integers(0, self.vocab, (self.batch, length)).tolist()


class Train:
    """Steps of a training mix: ``batch(i)`` the (tokens, labels) of step i,
    ``batch`` sequences of ``seq_len`` tokens below ``vocab``."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab

    def batch(self, i: int, device) -> dict:
        """Drawn on ``device`` by a generator seeded from the seed and i, so
        that a step dispatched ahead never waits on a copy from the host."""
        import torch
        gen = torch.Generator(device=device)
        gen.manual_seed(int(_rng(self.seed, 3, i).integers(0, 2**62)))
        shape = (self.mix["batch"], self.mix["seq_len"] + 1)
        seq = torch.randint(0, self.vocab, shape, generator=gen, device=device)
        return {"tokens": seq[:, :-1].contiguous(), "labels": seq[:, 1:].contiguous()}
