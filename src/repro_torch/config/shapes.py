"""Assigned input shapes and the step function each one lowers.

A copy of the JAX package's ``config/shapes.py``."""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class StepKind(str, enum.Enum):
    TRAIN = "train_step"        # fwd + bwd + optimizer update
    PREFILL = "prefill_step"    # full-sequence forward, writes KV cache
    DECODE = "serve_step"       # ONE new token against a KV cache of seq_len


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    step: StepKind


TRAIN_4K = InputShape("train_4k", 4_096, 256, StepKind.TRAIN)
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, StepKind.PREFILL)
DECODE_32K = InputShape("decode_32k", 32_768, 128, StepKind.DECODE)
LONG_500K = InputShape("long_500k", 524_288, 1, StepKind.DECODE)

ALL_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def get_shape(name: str) -> InputShape:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown input shape {name!r}; choose from {sorted(SHAPES)}") from None
