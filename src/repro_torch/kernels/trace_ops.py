"""The two scans and the AdamW update as single operators, for the dry
run's trace on the meta device.

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

The AdamW kernel is one pass as well: ``adamw_update`` here traces the
gradients' norm as one ``adamw_sumsq`` a leaf (a read of the gradient) and
each leaf's update as one ``adamw_leaf`` (p, g, m and v read, p, m and v
written), placed as their operands are.  The trace's tensors hold no data,
so the new values are not written back.

Below them, the placements of the model's ATen ops that torch 2.11's DTensor
places otherwise than 2.13's (or cannot place), written from 2.13's rules and
registered where torch has no such rules of its own
(``register_aten_shardings``).
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


# -- AdamW: the norm's sum of squares and each leaf's update, one op each


@torch.library.custom_op("repro_torch::adamw_sumsq", mutates_args=())
def adamw_sumsq(g: Tensor) -> Tensor:
    return g.float().square().sum()


@adamw_sumsq.register_fake
def _(g):
    return g.new_empty((), dtype=torch.float32)


@torch.library.custom_op("repro_torch::adamw_leaf", mutates_args=())
def adamw_leaf(p: Tensor, g: Tensor, m: Tensor, v: Tensor, scale: Tensor, lr: Tensor,
               b1c: Tensor, b2c: Tensor, b1: float, b2: float, eps: float,
               weight_decay: float) -> Tuple[Tensor, Tensor, Tensor]:
    """``ref.adamw_leaf_ref`` on copies: (p, m, v) after the step.
    ``weight_decay`` 0 for a leaf that does not decay."""
    m, v = m.clone(), v.clone()
    p = ref.adamw_leaf_ref(p, g, m, v, scale, lr, b1c, b2c, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay).to(p.dtype)
    return p, m, v


@adamw_leaf.register_fake
def _(p, g, m, v, *args):
    return torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)


def adamw_update(params, grads, mu, nu, step: Tensor, lr: Tensor, *, b1: float, b2: float,
                 eps: float, weight_decay: float, grad_clip: float) -> Tensor:
    """``ops.adamw_update`` as the trace counts it: the kernel's sums of
    squares and its one pass a leaf.  Returns the norm."""
    gnorm = torch.sqrt(sum(adamw_sumsq(g) for g in grads))
    scale, b1c, b2c = ref.adamw_scalars(gnorm, step, b1=b1, b2=b2, grad_clip=grad_clip)
    for p, g, m, v in zip(params, grads, mu, nu):
        adamw_leaf(p, g, m, v, scale, lr, b1c, b2c, b1, b2, eps,
                   weight_decay if p.dim() >= 2 else 0.0)
    return gnorm


# -- DTensor: each scan runs on local shards of the batch or of its channels


@functools.cache
def register_shardings() -> None:
    """Register the scans' placements with DTensor (once a process).  On one
    mesh dimension the operands are all replicated, all sharded on the
    batch, or sharded on the channels, where the reductions of a backward
    over the other axis come out ``Partial``.  AdamW's ops: a leaf's four
    tensors replicated or sharded alike (the scalars replicated), its
    sum of squares over a shard ``Partial``."""
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

    @register_sharding(torch.ops.repro_torch.adamw_sumsq.default)
    def _(g):
        return [([R], [R])] + [([P], [Shard(d)]) for d in range(len(g.shape))]

    @register_sharding(torch.ops.repro_torch.adamw_leaf.default)
    def _(p, g, m, v, *scalars):
        rest = [R] * 4 + [None] * (len(scalars) - 4)
        return [([R] * 3, [R] * 4 + rest)] + [([Shard(d)] * 3, [Shard(d)] * 4 + rest)
                                               for d in range(len(p.shape))]

    @register_sharding(torch.ops.repro_torch.rwkv6_scan_bwd.default)
    def _(r, k, v, w, u, S0, do, dS_last):
        return [([R] * 6, [R] * 5 + [opt(S0, R), R, opt(dS_last, R)]),
                ([Shard(0)] * 4 + [P, Shard(0)],
                 [Shard(0)] * 4 + [R, opt(S0, Shard(0)), Shard(0), opt(dS_last, Shard(0))]),
                ([Shard(2)] * 4 + [Shard(0), Shard(1)],
                 [Shard(2)] * 4 + [Shard(0), opt(S0, Shard(1)), Shard(2),
                                   opt(dS_last, Shard(1))])]


# -- DTensor: the model's ATen ops that torch 2.11 places otherwise than 2.13.
# Each rule is the strategy torch 2.13 has for the op on one mesh dimension,
# written here: a list of ([output placements], [input placements]), None for
# an argument that is not a tensor; DTensor expands it over the mesh and takes
# the cheapest redistribution, the first of equals, as 2.13 does.  As in 2.13,
# a rule that shards is offered only when an input is sharded already.


def _spec(a) -> bool:
    return hasattr(a, "placements")


def _sharded(*specs) -> bool:
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) for a in specs if _spec(a) for p in a.placements)


def _partial(p):
    from torch.distributed.tensor import Partial, Replicate
    return Replicate() if p is None else Partial(p)


# the partial sums (or means, maxima, minima) a pointwise op passes through:
# (output, *tensor inputs), None for a replicated input (torch 2.13's rules)
_LINEAR = (("sum", "sum"), ("avg", "avg"))
_ADDITIVE = (("sum", "sum", "sum"), ("avg", "avg", "avg"), ("avg", "avg", None),
             ("max", "max", None), ("min", "min", None), ("avg", None, "avg"))
_MUL = _LINEAR + (("sum", "sum", None), ("avg", "avg", None), ("sum", None, "sum"),
                  ("avg", None, "avg"))
_NON_DECREASING = (("max", "max"), ("min", "min"))


def pointwise_shardings(partials=()):
    """The rule of a pointwise op: replicated; sharded alike on any dimension
    of the broadcast result, an operand replicated where it broadcasts; or
    one of ``partials`` that fits the number of tensor operands."""
    def rule(*args, **_):
        from torch.distributed.tensor import Replicate, Shard
        tensors = [a for a in args if _spec(a)]
        common = torch.broadcast_shapes(*(tuple(a.shape) for a in tensors))

        def inputs(placement_of):
            return [placement_of(a) if _spec(a) else None for a in args]

        rules = [([Replicate()], inputs(lambda a: Replicate()))]
        for d in range(len(common) if _sharded(*tensors) else 0):
            def on_d(a, d=d):
                k = d - (len(common) - len(a.shape))
                return Shard(k) if k >= 0 and a.shape[k] == common[d] else Replicate()
            rules.append(([Shard(d)], inputs(on_d)))
        for out, *ins in partials:
            if len(ins) == len(tensors):
                it = iter(ins)
                rules.append(([_partial(out)], inputs(lambda a: _partial(next(it)))))
        return rules
    return rule


def index_shardings(x, indices):
    """``x[indices]`` (``index.Tensor``): replicated; ``x`` sharded on a
    dimension it is not indexed on, the indices replicated; the indices
    sharded on one dimension of their broadcast shape (replicated where they
    broadcast), ``x`` replicated; or ``x`` a partial sum or mean passed
    through."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    present = [i for i in indices if i is not None]
    indexed = [d for d, i in enumerate(indices) if i is not None]
    b_ndim = max(len(i.shape) for i in present)
    in_run = indexed[-1] - indexed[0] + 1 == len(indexed)
    insert = indexed[0] if in_run else 0
    rules = [([R], [R] * (1 + len(present)))]
    sharded = _sharded(x, *present)
    for d in range(len(x.shape) if sharded else 0):
        if d not in indexed:
            out = d if d < insert else d + b_ndim - sum(1 for i in indexed if d > i)
            rules.append(([Shard(out)], [Shard(d)] + [R] * len(present)))
    for bd in range(b_ndim if sharded else 0):
        dims = [(bd - (b_ndim - len(i.shape)), i.shape) for i in present]
        idx_pl = [Shard(td) if td >= 0 and shp[td] > 1 else R for td, shp in dims]
        if any(p != R for p in idx_pl):
            rules.append(([Shard(bd + insert)], [R] + idx_pl))
    rules += [([_partial(op)], [_partial(op)] + [R] * len(present)) for op in ("sum", "avg")]
    return rules


def index_put_shardings(x, indices, values, *_):
    """``x[indices] = values`` (``index_put``, ``index_put_``,
    ``_index_put_impl_``): every index replicated; ``x`` sharded on a
    dimension it is not indexed on and ``values`` on the dimension that lands
    there (replicated where it broadcasts); or all three a partial sum; or
    all replicated.  Indexed dimensions in one run put the broadcast index's
    dimensions in their place, else first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    R = Replicate()
    present = [i for i in indices if i is not None]
    indexed = [d for d, i in enumerate(indices) if i is not None]
    free = [d for d in range(len(x.shape)) if d not in indexed]
    b_ndim = len(torch.broadcast_shapes(*(tuple(i.shape) for i in present)))
    in_run = indexed[-1] - indexed[0] + 1 == len(indexed)
    lead = (b_ndim + len(free)) - len(values.shape)      # result dims values lacks
    rules = [([R], [R] * (len(present) + 2))]
    for n, d in enumerate(free if _sharded(x, values, *present) else ()):
        at = (d if d < indexed[0] else d - len(indexed) + b_ndim) if in_run else b_ndim + n
        vd = at - lead
        rules.append(([Shard(d)], [Shard(d)] + [R] * len(present)
                      + [R if vd < 0 or values.shape[vd] == 1 else Shard(vd)]))
    rules.append(([Partial()], [Partial()] + [R] * len(present) + [Partial()]))
    return rules


def scatter_shardings(x, dim, index, src):
    """``x.scatter(dim, index, src)``: replicated, or all sharded on a
    dimension other than ``dim`` where the three agree in size."""
    from torch.distributed.tensor import Replicate, Shard
    dim %= len(x.shape)
    rules = [([Replicate()], [Replicate(), None, Replicate(), Replicate()])]
    if len(x.shape) == len(index.shape):
        rules += [([Shard(d)], [Shard(d), None, Shard(d), Shard(d)])
                  for d in range(len(x.shape))
                  if d != dim and x.shape[d] == index.shape[d] == src.shape[d]]
    return rules


def roll_shardings(x, shifts, dims=()):
    """``torch.roll``: sharded on a dimension it does not roll (none when
    ``dims`` is empty: a flat roll), a partial value of any reduction passed
    through, or replicated."""
    from torch.distributed.tensor import Replicate, Shard
    n = len(x.shape)
    rolled = {d % n for d in dims} if dims else set(range(n))
    rules = [([Replicate()], [Replicate()])]
    rules += [([Shard(d)], [Shard(d)]) for d in range(n) if d not in rolled and _sharded(x)]
    rules += [([_partial(op)], [_partial(op)]) for op in ("sum", "avg", "max", "min")]
    return rules


def aten_shardings():
    """{ATen op: its rule}: every op whose placement in the port's traces
    differs between torch 2.11's DTensor and 2.13's."""
    aten = torch.ops.aten
    index_put = index_put_shardings
    rules = {aten.index.Tensor: index_shardings, aten.scatter.src: scatter_shardings,
             aten.index_put.default: index_put, aten.index_put_.default: index_put,
             aten._index_put_impl_.default: index_put, aten.roll.default: roll_shardings,
             aten.add.Tensor: pointwise_shardings(_ADDITIVE),
             aten.sub.Tensor: pointwise_shardings(_ADDITIVE),
             aten.mul.Tensor: pointwise_shardings(_MUL)}
    for op in (aten.exp.default, aten.relu.default, aten.sigmoid.default, aten.tanh.default):
        rules[op] = pointwise_shardings(_NON_DECREASING)
    for op in (aten.pow.Tensor_Scalar, aten.silu.default, aten.silu_backward.default,
               aten.softplus.default, aten.where.self, aten.clone.default):
        rules[op] = pointwise_shardings()
    return rules


def torch_has_aten_rules() -> bool:
    """Whether DTensor places ``aten_shardings``' ops by rules of its own
    (torch 2.13 on).  It takes those before a registered rule, so registering
    one there would only change the key of its cache: a registered rule is
    keyed on the tensors alone, ``roll``'s ``dims`` left out."""
    return tuple(int(v) for v in torch.__version__.split("+")[0].split(".")[:2]) >= (2, 13)


@functools.cache
def register_aten_shardings() -> None:
    """Register ``aten_shardings`` with DTensor where torch has no rules of
    its own for them (once a process): the trace then places every op as
    torch 2.13 does, whichever of the two is installed."""
    if torch_has_aten_rules():
        return
    from torch.distributed.tensor.experimental import register_sharding
    for op, rule in aten_shardings().items():
        register_sharding(op)(rule)
