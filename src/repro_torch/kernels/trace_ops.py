"""The two scans as single operators, for the dry run's trace on the meta
device.

The plain scans (``ref.mamba_scan_ref``, ``ref.rwkv6_scan_ref``) loop over
time, a few ops a step: at the dry run's lengths (4096 to 32768 steps, two
dozen layers, forward, recompute and backward) that is millions of ops to
trace.  On the card each scan is one kernel launch that reads its inputs and
writes its outputs once.  So ``kernels.ops`` hands a *meta* tensor (the
dry run's local shards, which hold no data) to the operators here: each is
one ``torch.library`` custom op whose meta kernel gives the outputs' shapes,
with the flop formula of the plain loop's products (``register_flop_formula``),
an autograd rule through a backward op of the same kind, and, registered by
``register_shardings`` when DTensor is in use, the placements they take: the
batch, or the channels (Mamba's d_inner, RWKV6's heads), sharded or not.
The trace then counts a scan as the kernel's one pass over its operands.
On a CPU tensor the ops run the plain versions, which the tests use.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import Tensor

from repro_torch.kernels import ref


@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=())
def mamba_scan(dt: Tensor, dtx: Tensor, Bm: Tensor, Cm: Tensor, A: Tensor,
               h0: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    y, h = ref.mamba_scan_ref(dt, dtx, Bm, Cm, A, h0)
    return y, h.clone()


@mamba_scan.register_fake
def _(dt, dtx, Bm, Cm, A, h0):
    B, _, di = dt.shape
    return dt.new_empty(dt.shape), dt.new_empty((B, di, Bm.shape[-1]), dtype=torch.float32)


@torch.library.custom_op("repro_torch::mamba_scan_bwd", mutates_args=())
def mamba_scan_bwd(dt: Tensor, dtx: Tensor, Bm: Tensor, Cm: Tensor, A: Tensor,
                   h0: Optional[Tensor], dy: Tensor, dh_last: Optional[Tensor]
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    return tuple(g.clone() for g in ref.mamba_scan_bwd_ref(dt, dtx, Bm, Cm, A, h0, dy,
                                                             dh_last))


@mamba_scan_bwd.register_fake
def _(dt, dtx, Bm, Cm, A, h0, dy, dh_last):
    B, _, di = dt.shape
    return (torch.empty_like(dt), torch.empty_like(dtx), torch.empty_like(Bm),
            torch.empty_like(Cm), torch.empty_like(A),
            dt.new_empty((B, di, Bm.shape[-1]), dtype=torch.float32))


@torch.library.custom_op("repro_torch::rwkv6_scan", mutates_args=())
def rwkv6_scan(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
               S0: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    o, S = ref.rwkv6_scan_ref(r, k, v, w, u, S0)
    return o, S.clone()


@rwkv6_scan.register_fake
def _(r, k, v, w, u, S0):
    B, _, H, hd = r.shape
    return r.new_empty(r.shape), r.new_empty((B, H, hd, hd), dtype=torch.float32)


@torch.library.custom_op("repro_torch::rwkv6_scan_bwd", mutates_args=())
def rwkv6_scan_bwd(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                   S0: Optional[Tensor], do: Tensor, dS_last: Optional[Tensor]
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    return tuple(g.clone() for g in ref.rwkv6_scan_bwd_ref(r, k, v, w, u, S0, do, dS_last))


@rwkv6_scan_bwd.register_fake
def _(r, k, v, w, u, S0, do, dS_last):
    B, _, H, hd = r.shape
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(w), torch.empty_like(u),
            r.new_empty((B, H, hd, hd), dtype=torch.float32))


# -- autograd: the backward op, its cotangents of the last state zero where unused


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*(t for t in inputs if t is not None))
    ctx.has_h0 = inputs[5] is not None


def _saved(ctx):
    saved = list(ctx.saved_tensors)
    h0 = saved.pop() if ctx.has_h0 else None
    return (*saved, h0)


def _mamba_bwd(ctx, dy, dh_last):
    grads = mamba_scan_bwd(*_saved(ctx), dy, dh_last)
    return (*grads[:5], grads[5] if ctx.has_h0 else None)


def _rwkv_bwd(ctx, do, dS_last):
    grads = rwkv6_scan_bwd(*_saved(ctx), do, dS_last)
    return (*grads[:5], grads[5] if ctx.has_h0 else None)


mamba_scan.register_autograd(_mamba_bwd, setup_context=_setup)
rwkv6_scan.register_autograd(_rwkv_bwd, setup_context=_setup)


# -- flops: the plain loops' products (y_t = h_t . C_t; o_t = r_t . (S + u k v));
# a backward does two such products a step, as autograd of the loop does


def _scan_flops(per_step: int, steps: int, factor: int) -> int:
    return factor * 2 * per_step * steps


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.mamba_scan)
    def _(dt_shape, dtx_shape, B_shape, C_shape, *args, **kwargs):
        B, S, di = dt_shape
        return _scan_flops(B * di * B_shape[-1], S, 1)

    @register_flop_formula(torch.ops.repro_torch.mamba_scan_bwd)
    def _(dt_shape, dtx_shape, B_shape, C_shape, *args, **kwargs):
        B, S, di = dt_shape
        return _scan_flops(B * di * B_shape[-1], S, 2)

    @register_flop_formula(torch.ops.repro_torch.rwkv6_scan)
    def _(r_shape, *args, **kwargs):
        B, T, H, hd = r_shape
        return _scan_flops(B * H * hd * hd, T, 1)

    @register_flop_formula(torch.ops.repro_torch.rwkv6_scan_bwd)
    def _(r_shape, *args, **kwargs):
        B, T, H, hd = r_shape
        return _scan_flops(B * H * hd * hd, T, 2)


_register_flops()


# -- DTensor: each scan runs on local shards of the batch or of its channels


@functools.cache
def register_shardings() -> None:
    """Register the scans' placements with DTensor (once a process).  On one
    mesh dimension the operands are all replicated, all sharded on the
    batch, or sharded on the channels, where the reductions of a backward
    over the other axis come out ``Partial``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R, P = Replicate(), Partial()

    def opt(x, placement):
        return None if x is None else placement

    @register_sharding(torch.ops.repro_torch.mamba_scan.default)
    def _(dt, dtx, Bm, Cm, A, h0):
        return [([R, R], [R, R, R, R, R, opt(h0, R)]),
                ([Shard(0), Shard(0)], [Shard(0)] * 4 + [R, opt(h0, Shard(0))]),
                ([Shard(2), Shard(1)], [Shard(2), Shard(2), R, R, Shard(0),
                                        opt(h0, Shard(1))])]

    @register_sharding(torch.ops.repro_torch.mamba_scan_bwd.default)
    def _(dt, dtx, Bm, Cm, A, h0, dy, dh_last):
        return [([R] * 6, [R] * 5 + [opt(h0, R), R, opt(dh_last, R)]),
                ([Shard(0)] * 4 + [P, Shard(0)],
                 [Shard(0)] * 4 + [R, opt(h0, Shard(0)), Shard(0), opt(dh_last, Shard(0))]),
                ([Shard(2), Shard(2), P, P, Shard(0), Shard(1)],
                 [Shard(2), Shard(2), R, R, Shard(0), opt(h0, Shard(1)), Shard(2),
                  opt(dh_last, Shard(1))])]

    @register_sharding(torch.ops.repro_torch.rwkv6_scan.default)
    def _(r, k, v, w, u, S0):
        return [([R, R], [R] * 5 + [opt(S0, R)]),
                ([Shard(0), Shard(0)], [Shard(0)] * 4 + [R, opt(S0, Shard(0))]),
                ([Shard(2), Shard(1)], [Shard(2)] * 4 + [Shard(0), opt(S0, Shard(1))])]

    @register_sharding(torch.ops.repro_torch.rwkv6_scan_bwd.default)
    def _(r, k, v, w, u, S0, do, dS_last):
        return [([R] * 6, [R] * 5 + [opt(S0, R), R, opt(dS_last, R)]),
                ([Shard(0)] * 4 + [P, Shard(0)],
                 [Shard(0)] * 4 + [R, opt(S0, Shard(0)), Shard(0), opt(dS_last, Shard(0))]),
                ([Shard(2)] * 4 + [Shard(0), Shard(1)],
                 [Shard(2)] * 4 + [Shard(0), opt(S0, Shard(1)), Shard(2),
                                   opt(dS_last, Shard(1))])]
