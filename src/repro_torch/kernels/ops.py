"""Public kernel ops, dispatched by the device of the tensors.

Counterpart of the JAX package's ``kernels/ops.py``.  A CPU tensor goes to
the plain PyTorch version in :mod:`repro_torch.kernels.ref`; a CUDA tensor
goes to the hand-written kernel, which raises on anything it does not take.
There is no override and no fallback.

``LAUNCHES`` counts the kernel launches of each op, so that a run can show
that it went through the kernels; the plain versions do not count.
``ROUTE_LAUNCHES`` counts, for the ops with more than one design, the
launches of each design (``route`` in their wrappers), so that a run can
show which one it took; for ``adamw_update``, whose one call is several
launches (``LAUNCHES["adamw"]`` counts each), those of each of its kernels.

Gradients on the card: under grad mode, with an input requiring grad,
``flash_attention`` (with or without a key mask), ``moe_gmm``,
``mamba_scan`` and ``rwkv6_scan`` go through autograd functions whose
backward launches the kernel's backward entry points: flash's two
(``LAUNCHES["flash_attention_bwd"]`` one a backward, by kernel in
``ROUTE_LAUNCHES["flash_attention_bwd"]``: the pair of the forward's
route), ``moe_gmm``'s two products (``moe_gmm_bwd``, by product and route),
and the scans' one each (``mamba_scan_bwd``, ``rwkv6_scan_bwd``, by
design).  Each saves its inputs, not its outputs or states, returns each
gradient in its input's dtype, and takes a missing cotangent of the last
state (or of the output) as zeros.  ``decode_attention`` and ``aes_ctr``
have no backward kernel, since no training path reaches them, and raise
on a CUDA input that requires grad under grad mode, rather than return an
output cut off from the graph.  On the CPU the plain versions keep their
autograd.  Inside ``meta_trace`` (the dry run's trace, whose tensors are on
the meta device and hold no data) the ops take their plain versions too,
the scans as single operators (``kernels.trace_ops``); elsewhere the meta
device, as any other, has no implementation.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import aes_ctr as _aes
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _rwkv

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "decode_attention": 0, "aes_ctr": 0,
                            "moe_gmm": 0, "mamba_scan": 0, "rwkv6_scan": 0,
                            "flash_attention_bwd": 0, "moe_gmm_bwd": 0, "mamba_scan_bwd": 0,
                            "rwkv6_scan_bwd": 0, "adamw": 0}


#: launches by route of the ops with more than one design (the wrappers' counts)
ROUTE_LAUNCHES: Dict[str, Dict[str, int]] = {"flash_attention": _flash.LAUNCHES,
                                             "decode_attention": _decode.LAUNCHES,
                                             "aes_ctr": _aes.LAUNCHES,
                                             "moe_gmm": _gmm.LAUNCHES,
                                             "mamba_scan": _mamba.LAUNCHES,
                                             "rwkv6_scan": _rwkv.LAUNCHES,
                                             "flash_attention_bwd": _flash.BWD_LAUNCHES,
                                             "moe_gmm_bwd": _gmm.BWD_LAUNCHES,
                                             "mamba_scan_bwd": _mamba.BWD_LAUNCHES,
                                             "rwkv6_scan_bwd": _rwkv.BWD_LAUNCHES,
                                             "adamw": _adamw.LAUNCHES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in ROUTE_LAUNCHES.values():
        for r in counts:
            counts[r] = 0


def launch_counts() -> Dict[Tuple[str, Optional[str]], int]:
    """Every counter as it stands: ``(op, None)`` for ``LAUNCHES[op]``,
    ``(op, route)`` for ``ROUTE_LAUNCHES[op][route]``."""
    counts = {(op, None): n for op, n in LAUNCHES.items()}
    counts.update({(op, r): n for op, by_route in ROUTE_LAUNCHES.items()
                   for r, n in by_route.items()})
    return counts


def add_launches(counts: Dict[Tuple[str, Optional[str]], int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (keyed as :func:`launch_counts`) to the
    counters: a replayed CUDA graph launches again what its capture
    counted once (``graphs.CapturedStep``)."""
    for (op, r), n in counts.items():
        if r is None:
            LAUNCHES[op] += times * n
        else:
            ROUTE_LAUNCHES[op][r] += times * n


_META_TRACE = contextvars.ContextVar("meta_trace", default=False)


@contextlib.contextmanager
def meta_trace():
    """Within it a meta tensor takes the plain version, the scans their
    single trace operators (``kernels.trace_ops``): the dry run's
    shapes-only trace.  Outside it the meta device has no implementation."""
    token = _META_TRACE.set(True)
    try:
        yield
    finally:
        _META_TRACE.reset(token)


def _traced(t: torch.Tensor) -> bool:
    return t.device.type == "meta" and _META_TRACE.get()


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel); False on the CPU and, inside
    ``meta_trace``, on the meta device: the plain version."""
    if t.device.type == "cpu" or _traced(t):
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no implementation for device {t.device}")


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd would have to differentiate a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise on a CUDA call that autograd would have to differentiate: the
    op has no backward kernel, since no training path reaches it, and its
    output would be cut off from the graph."""
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel on the card, since no training path reaches this "
            "op; run it under torch.no_grad() or differentiate it on the CPU")


class _FlashAttention(torch.autograd.Function):
    """The flash kernel's forward (the route of the dtype and the key mask)
    and its backward kernels (the dq kernel, then the dkv kernel, in the
    design of ``bwd_route``, masked too under a key mask), which recompute
    the rows' softmax statistics from the saved q, k, v, output and mask;
    the ``wgmma_live`` pair (bf16 under a key mask) takes each row's
    log-sum-exp from the forward instead, saved beside them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, key_valid):
        lse = None
        if _flash.bwd_route(q.dtype, key_valid is not None) == "wgmma_live":
            out, lse = _flash.flash_attention(q, k, v, causal=causal, window=window,
                                              key_valid=key_valid, return_lse=True)
        else:
            out = _flash.flash_attention(q, k, v, causal=causal, window=window,
                                         key_valid=key_valid)
        ctx.save_for_backward(q, k, v, out, key_valid, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, key_valid, lse = ctx.saved_tensors
        dq, dk, dv = _flash.flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                                causal=ctx.causal, window=ctx.window,
                                                key_valid=key_valid, lse=lse)
        LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None


class _MoeGmm(torch.autograd.Function):
    """The expert matmul's forward (the route of its shape) and its backward
    (dx and dw, each on the route of its own product)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _gmm.moe_gmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _gmm.moe_gmm_bwd(x, w, dy.contiguous())
        if dy.numel():
            LAUNCHES["moe_gmm_bwd"] += 1
        return dx, dw


class _MambaScan(torch.autograd.Function):
    """The selective scan's forward (the route of its ds) and its backward
    kernel, which recomputes the states from the saved inputs."""

    @staticmethod
    def forward(ctx, dt, dtx, Bm, Cm, A, h0):
        ctx.save_for_backward(dt, dtx, Bm, Cm, A, h0)
        ctx.set_materialize_grads(False)
        return _mamba.mamba_scan(dt, dtx, Bm, Cm, A, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, dtx, Bm, Cm, A, h0 = ctx.saved_tensors
        dy = torch.zeros_like(dt) if dy is None else dy.contiguous()
        *grads, dh0 = _mamba.mamba_scan_bwd(dt, dtx, Bm, Cm, A, h0, dy,
                                            None if dh_last is None else dh_last.contiguous())
        if dt.numel():
            LAUNCHES["mamba_scan_bwd"] += 1
        return (*grads, dh0 if ctx.needs_input_grad[5] else None)


class _Rwkv6Scan(torch.autograd.Function):
    """The wkv recurrence's forward (the route of its hd) and its backward
    kernel, which recomputes the states from the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, S0):
        ctx.save_for_backward(r, k, v, w, u, S0)
        ctx.set_materialize_grads(False)
        return _rwkv.rwkv6_scan(r, k, v, w, u, S0)

    @staticmethod
    def backward(ctx, do, dS_last):
        r, k, v, w, u, S0 = ctx.saved_tensors
        do = torch.zeros_like(r) if do is None else do.contiguous()
        *grads, dS0 = _rwkv.rwkv6_scan_bwd(r, k, v, w, u, S0, do,
                                           None if dS_last is None else dS_last.contiguous())
        if r.numel():
            LAUNCHES["rwkv6_scan_bwd"] += 1
        return (*grads, dS0 if ctx.needs_input_grad[5] else None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Hq,S,d), k/v (B,Hkv,T,d), key_valid (B,T) bool or None ->
    (B,Hq,S,d)."""
    if not _on_cuda("flash_attention", q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       key_valid=key_valid)
    if _needs_grad(q, k, v):
        out = _FlashAttention.apply(q, k, v, causal, window, key_valid)
    else:
        out = _flash.flash_attention(q, k, v, causal=causal, window=window,
                                     key_valid=key_valid)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q (B,Hq,d), k/v (B,T,Hkv,d), valid (B,T) bool/int32 -> (B,Hq,d)."""
    if not _on_cuda("decode_attention", q):
        return ref.decode_attention_ref(q, k, v, valid)
    _refuse_grad("decode_attention", q, k, v)
    out = _decode.decode_attention(q, k, v, valid)
    LAUNCHES["decode_attention"] += 1
    return out


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Expert-batched matmul: x (E,C,D), w (E,D,F) -> (E,C,F) in x.dtype,
    summed in fp32.  An empty output launches nothing and counts nothing."""
    if not _on_cuda("moe_gmm", x):
        return ref.moe_gmm_ref(x, w)
    if _needs_grad(x, w):
        out = _MoeGmm.apply(x, w)
    else:
        out = _gmm.moe_gmm(x, w)
    if out.numel():
        LAUNCHES["moe_gmm"] += 1
    return out


def mamba_scan(dt: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, A: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan: dt, dtx (B,S,di), Bm, Cm (B,S,ds), A (di,ds), h0
    (B,di,ds) fp32 or None -> y (B,S,di) in dt.dtype, h_last (B,di,ds) fp32.
    An empty input launches nothing and counts nothing."""
    if _traced(dt):
        from repro_torch.kernels import trace_ops
        return trace_ops.mamba_scan(dt, dtx, Bm, Cm, A, h0)
    if not _on_cuda("mamba_scan", dt):
        return ref.mamba_scan_ref(dt, dtx, Bm, Cm, A, h0)
    if _needs_grad(dt, dtx, Bm, Cm, A, h0):
        out = _MambaScan.apply(dt, dtx, Bm, Cm, A, h0)
    else:
        out = _mamba.mamba_scan(dt, dtx, Bm, Cm, A, h0)
    if dt.numel():
        LAUNCHES["mamba_scan"] += 1
    return out


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, S0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """wkv recurrence: r, k, v, w (B,T,H,hd), u (H,hd), S0 (B,H,hd,hd) fp32 or
    None -> o (B,T,H,hd) in r.dtype, S_last (B,H,hd,hd) fp32.  An empty input
    launches nothing and counts nothing."""
    if _traced(r):
        from repro_torch.kernels import trace_ops
        return trace_ops.rwkv6_scan(r, k, v, w, u, S0)
    if not _on_cuda("rwkv6_scan", r):
        return ref.rwkv6_scan_ref(r, k, v, w, u, S0)
    if _needs_grad(r, k, v, w, u, S0):
        out = _Rwkv6Scan.apply(r, k, v, w, u, S0)
    else:
        out = _rwkv.rwkv6_scan(r, k, v, w, u, S0)
    if r.numel():
        LAUNCHES["rwkv6_scan"] += 1
    return out


def adamw_update(params, grads, mu, nu, step: torch.Tensor, lr: torch.Tensor, *,
                 b1: float, b2: float, eps: float, weight_decay: float,
                 grad_clip: float) -> torch.Tensor:
    """One AdamW step on the lists of leaves ``params`` (in place, each in its
    dtype), ``grads`` and the fp32 moments ``mu``, ``nu`` (in place), at the
    step counter ``step`` (() int32, already advanced to the step taken) and
    the learning rate ``lr`` (() fp32) -> the gradients' global norm before
    clipping (() fp32).  On the card: the AdamW kernel's launches, each
    counted."""
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, grad_clip=grad_clip)
    if _traced(params[0]):
        from repro_torch.kernels import trace_ops
        return trace_ops.adamw_update(params, grads, mu, nu, step, lr, **hyper)
    if not _on_cuda("adamw_update", params[0]):
        return ref.adamw_update_ref(params, grads, mu, nu, step, lr, **hyper)
    gnorm, launched = _adamw.adamw_update(params, grads, mu, nu, step, lr, **hyper)
    LAUNCHES["adamw"] += launched
    return gnorm


def aes_ctr_expanded(plaintext: torch.Tensor, round_keys: torch.Tensor, *,
                     nonce: int = 0) -> torch.Tensor:
    """AES-128-CTR under expanded round keys: plaintext (N, 16) int32 bytes,
    round keys (11, 16) int32 on the plaintext's device -> (N, 16) int32; the
    signature of the JAX package's Pallas ``aes_ctr``.  An empty plaintext
    launches nothing and counts nothing."""
    if not _on_cuda("aes_ctr", plaintext):
        return plaintext ^ ref.aes_ctr_keystream(plaintext.shape[0], round_keys, nonce)
    _refuse_grad("aes_ctr", plaintext, round_keys)
    out = _aes.aes_ctr(plaintext, round_keys, nonce=nonce)
    if plaintext.shape[0]:
        LAUNCHES["aes_ctr"] += 1
    return out


def aes_ctr(plaintext: torch.Tensor, key_bytes: torch.Tensor, *,
            nonce: int = 0) -> torch.Tensor:
    """AES-128-CTR: plaintext (N, 16) int32 bytes, key (16,) -> (N, 16) int32.

    The key schedule is plain torch, as in the JAX package, and lands on the
    plaintext's device as an (11, 16) int32 tensor on every call; a caller
    with a fixed key expands it once and calls :func:`aes_ctr_expanded`."""
    if not _on_cuda("aes_ctr", plaintext):
        return ref.aes_ctr_ref(plaintext, key_bytes, nonce)
    return aes_ctr_expanded(plaintext, ref.aes_key_expand(key_bytes).to(plaintext.device),
                            nonce=nonce)
