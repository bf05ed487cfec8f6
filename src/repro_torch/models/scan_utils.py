"""Chunked diagonal-decay linear recurrences.

Counterpart of the JAX package's ``models/scan_utils.py``.  Both Mamba's
selective scan and RWKV6's wkv recurrence are instances of

    h_t = a_t * h_{t-1} + b_t          (a broadcast-diagonal over state)

which is associative.  ``linear_scan_emit`` runs a loop over chunks and,
inside each chunk, (1) builds a/b from factored inputs via ``make_ab``, (2)
runs an associative scan (a Hillis-Steele doubling over the chunk's steps,
JAX's ``associative_scan`` for the combine), and (3) immediately reduces
states to outputs via ``emit_fn``.  Live memory is O(chunk * state).  It
is plain PyTorch and differentiable by autograd; the port's models call
the scan kernels instead (``kernels.ops.mamba_scan``, ``ops.rwkv6_scan``),
and this module is the reference form of the recurrence they compute.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _associative_scan(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``_combine`` over axis 0: after it, (a_t, b_t) is
    the composition of steps 0..t, so that h_t = a_t h_{-1} + b_t."""
    n, shift = a.shape[0], 1
    while shift < n:
        a_new, b_new = _combine((a[:-shift], b[:-shift]), (a[shift:], b[shift:]))
        a = torch.cat([a[:shift], a_new])
        b = torch.cat([b[:shift], b_new])
        shift *= 2
    return a, b


def linear_scan_emit(inputs, h0: torch.Tensor, make_ab: Callable,
                     emit_fn: Callable, chunk: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t, chunk-factored.

    inputs: a tree of tensors (dicts, tuples) with leading time axis T.
    make_ab(chunk_inputs) -> (a, b) each (c, *state), built per chunk.
    emit_fn(h_prev (c,*state), h_post (c,*state), chunk_inputs) -> y (c, ...).
    Returns (y: (T, ...), h_T).
    """
    T = tree_leaves(inputs)[0].shape[0]

    def chunk_apply(h, cin):
        a, b = make_ab(cin)
        aa, bb = _associative_scan(a, b)
        hs = aa * h[None] + bb                       # states after each step
        h_prev = torch.cat([h[None], hs[:-1]], dim=0)
        return hs[-1], emit_fn(h_prev, hs, cin)

    if T <= chunk:
        h_last, y = chunk_apply(h0, inputs)
        return y, h_last
    if T % chunk:
        raise ValueError(f"linear_scan_emit: T={T} not divisible by chunk={chunk}")
    h, ys = h0, []
    for i in range(T // chunk):
        cin = tree_map(lambda x: x[i * chunk:(i + 1) * chunk], inputs)
        h, y = chunk_apply(h, cin)
        ys.append(y)
    return torch.cat(ys, dim=0), h


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential oracle for tests: returns all post-update states."""
    h, hs = h0, []
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        hs.append(h)
    return torch.stack(hs), h


def scan_chunk_count(T: int, chunk: int = 64) -> int:
    """Number of chunk iterations ``linear_scan_emit`` performs."""
    return 1 if T <= chunk else T // chunk
