"""Plain PyTorch versions of the kernels.

Counterparts of ``flash_attention_ref``, ``decode_attention_ref``,
``mamba_scan_ref``, ``rwkv6_scan_ref``, ``moe_gmm_ref`` and the AES-128-CTR
oracles in the JAX package's ``kernels/ref.py``: same layouts, same fp32
softmax, same finite ``NEG_INF`` for masked scores, the same sequential
fp32 recurrences from an optional initial state, the same fp32 expert
matmul rounded once, the same table-based AES.  ``kernels.ops`` runs them for CPU tensors;
``chip_smoke.py`` and the GPU tests hold the CUDA kernels against them on
the card.  They run on any device.  ``flash_attention_bwd_ref``,
``mamba_scan_bwd_ref``, ``rwkv6_scan_bwd_ref`` and ``moe_gmm_bwd_ref`` are
the plain versions of the backward kernels, which the JAX package does not
have (it differentiates the plain code around its kernels): explicit
formulas, and reverse-time loops for the scans, in fp32.
``adamw_update_ref`` is the plain version of the AdamW kernel, which has no
TPU counterpart (XLA fuses the JAX package's ``apply_updates``): its global
norm and its loop over the leaves, an fp32 pass for each operation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None,
                        key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Hq, S, d); k, v: (B, Hkv, T, d); key_valid: (B, T) bool or
    None -> (B, Hq, S, d).  A masked key scores ``NEG_INF`` as a causal or
    window miss does, so a row with no key left averages v over T."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    mask = _attn_mask(S, T, causal, window, q.device)
    if key_valid is not None:
        mask = mask & key_valid.bool()[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def _attn_mask(S: int, T: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """(S, T) bool, True where query i (at position i + T - S) may see key j."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp + (T - S)     # allow prefix cache offset
    if window is not None:
        mask &= kp > qp + (T - S) - window
    return mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Hq, S) fp32: each query row's log-sum-exp of its allowed scores in
    log2 units (the scores times d**-0.5 log2(e)), -inf on a row with no
    allowed key: what the key-masked wgmma forward hands its backward
    (``flash_attention(..., return_lse=True)``)."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(Hq // Hkv, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * d ** -0.5
    mask = _attn_mask(S, T, causal, window, q.device)
    if key_valid is not None:
        mask = mask & key_valid.bool()[:, None, None, :]
    return torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1) * _LOG2E


_LOG2E = 1.4426950408889634


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            key_valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`flash_attention_ref` by q, k and v, from
    explicit formulas in fp32: with scale = d**-0.5 (the kernel's), P the
    softmax of the masked scores (causal, window and ``key_valid``, (B, T)
    bool or None), D = rowsum(dout * o) and dS = P (dout v^T - D) on the
    allowed pairs and 0 elsewhere, dq = scale dS k, dk = scale dS^T q and
    dv = P^T dout, dk and dv summed over each kv head's G query heads.  A
    row with no allowed key (none at all, or every one masked) has P = 1/T
    on every key (the softmax of equal ``NEG_INF`` scores: its output is the
    mean of v) and no score gradient, so it adds dout / T to dv of every key
    of its batch row.  o is the forward's output, dout (B, Hq, S, d) the
    gradient by it.  Each result is rounded once to its input's dtype."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = d ** -0.5
    qf, dof = q.float(), dout.float()
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    mask = _attn_mask(S, T, causal, window, q.device)
    if key_valid is not None:
        mask = mask & key_valid.bool()[:, None, None, :]
    s = torch.where(mask, torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 1.0 / T)   # the empty-row rule
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = torch.where(mask, p * (dp - delta), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(B, Hkv, G, T, d).sum(dim=2)
    dv = dv.reshape(B, Hkv, G, T, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, d); k, v: (B, T, Hkv, d); valid: (B, T) bool -> (B, Hq, d).

    A row with no valid slot averages v over the real T (softmax of equal
    scores), as the JAX oracle does.
    """
    B, Hq, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, Hkv, G, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    s = torch.where(valid.bool()[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(B, Hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba selective scan


def mamba_scan_ref(dt: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, dtx: (B, S, di); Bm, Cm: (B, S, ds); A: (di, ds); h0: (B, di, ds)
    or None (zeros).  A loop over time in fp32:
    h_t = exp(dt_t A) h_{t-1} + dtx_t B_t and y_t = h_t . C_t, the steps'
    outputs stacked at the end (no write into a slice of y, which a DTensor
    does not take).  Returns y (B, S, di) rounded once to dt.dtype, and h_S
    (B, di, ds) fp32."""
    Bsz, S, di = dt.shape
    ds = Bm.shape[-1]
    h = (torch.zeros((Bsz, di, ds), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float())
    dtf, dtxf, Bf, Cf, Af = (t.float() for t in (dt, dtx, Bm, Cm, A))
    ys = []
    for t in range(S):
        h = torch.exp(dtf[:, t, :, None] * Af) * h + dtxf[:, t, :, None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bde,be->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else dtf.new_zeros((Bsz, 0, di))
    return y.to(dt.dtype), h


def mamba_scan_bwd_ref(dt: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, A: torch.Tensor, h0: Optional[torch.Tensor],
                       dy: torch.Tensor, dh_last: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`mamba_scan_ref` by dt, dtx, Bm, Cm, A and h0,
    given dy (B, S, di), the cotangent of y, and dh_last (B, di, ds) fp32,
    that of the last state (None: zeros; h0 None: zeros too).

    The states are run forward once and kept; then a loop from the last step
    back carries lambda_t = dL/dh_t: with a_t = exp(dt_t A),
    lambda_t = dy_t C_t + a_{t+1} lambda_{t+1} (the second term dh_last at
    t = S), and dC_t = sum_i dy_t[i] h_t[i, :], ddtx_t = lambda_t . B_t,
    dB_t = sum_i lambda_t[i, :] dtx_t[i], ddt_t = sum_s lambda_t h_{t-1} a_t
    A, dA = sum_{b, t} lambda_t h_{t-1} a_t dt_t and dh0 = a_1 lambda_1.
    Returns (ddt, ddtx, dB, dC, dA, dh0), each rounded once to its input's
    dtype, dh0 fp32."""
    Bsz, S, di = dt.shape
    ds = Bm.shape[-1]
    f32 = torch.float32
    dtf, dtxf, Bf, Cf, Af, dyf = (t.float() for t in (dt, dtx, Bm, Cm, A, dy))
    h = torch.zeros((Bsz, di, ds), dtype=f32, device=dt.device) if h0 is None else h0.float()
    hs = [h]                                   # hs[t] = h_{t-1}; hs[t + 1] = h_t
    for t in range(S):
        h = torch.exp(dtf[:, t, :, None] * Af) * h + dtxf[:, t, :, None] * Bf[:, t, None, :]
        hs.append(h)
    carry = (torch.zeros((Bsz, di, ds), dtype=f32, device=dt.device) if dh_last is None
             else dh_last.float())
    ddt, ddtx = torch.empty_like(dtf), torch.empty_like(dtxf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    for t in reversed(range(S)):
        a = torch.exp(dtf[:, t, :, None] * Af)
        lam = dyf[:, t, :, None] * Cf[:, t, None, :] + carry
        dC[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], hs[t + 1])
        ddtx[:, t] = (lam * Bf[:, t, None, :]).sum(-1)
        dB[:, t] = torch.einsum("bdn,bd->bn", lam, dtxf[:, t])
        q = lam * hs[t] * a
        ddt[:, t] = (q * Af).sum(-1)
        dA += (q * dtf[:, t, :, None]).sum(0)
        carry = a * lam
    return (ddt.to(dt.dtype), ddtx.to(dtx.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype),
            dA.to(A.dtype), carry)


# ---------------------------------------------------------------------------
# RWKV6 wkv recurrence


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   S0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, T, H, hd); u: (H, hd); S0: (B, H, hd, hd) or None
    (zeros).  A loop over time in fp32, per head:
    o_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j]) and then
    S[i, j] = w_t[i] S[i, j] + k_t[i] v_t[j], the steps' outputs stacked at
    the end.  Returns o (B, T, H, hd) rounded once to r.dtype, and S_T fp32."""
    B, T, H, hd = r.shape
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if S0 is None else S0.float())
    rf, kf, vf, wf, uf = (t.float() for t in (r, k, v, w, u))
    os_ = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # (B,H,hd,hd)
        os_.append(torch.einsum("bhij,bhi->bhj", S + uf[None, :, :, None] * kv, rf[:, t]))
        S = wf[:, t, :, :, None] * S + kv
    o = torch.stack(os_, dim=1) if os_ else rf.new_zeros((B, 0, H, hd))
    return o.to(r.dtype), S


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, S0: Optional[torch.Tensor],
                       do: torch.Tensor, dS_last: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`rwkv6_scan_ref` by r, k, v, w, u and S0,
    given do (B, T, H, hd), the cotangent of o, and dS_last (B, H, hd, hd)
    fp32, that of the last state (None: zeros; S0 None: zeros too).

    The states are run forward once and kept; then a loop from the last step
    back carries Lambda_t = dL/dS_t, Lambda_T = dS_last and
    Lambda_{t-1} = diag(w_t) Lambda_t + r_t g_t^T (g = do), and per head
    dr_t = (S_{t-1} + diag(u) k_t v_t^T) g_t,
    dk_t = Lambda_t v_t + u r_t (v_t . g_t),
    dv_t = Lambda_t^T k_t + (r_t . (u k_t)) g_t,
    dw_t = sum_j Lambda_t[:, j] S_{t-1}[:, j],
    du = sum_{b, t} r_t k_t (v_t . g_t) and dS0 = Lambda_0.
    Returns (dr, dk, dv, dw, du, dS0), each rounded once to its input's
    dtype, dS0 fp32."""
    B, T, H, hd = r.shape
    f32 = torch.float32
    rf, kf, vf, wf, uf, gf = (t.float() for t in (r, k, v, w, u, do))
    S = torch.zeros((B, H, hd, hd), dtype=f32, device=r.device) if S0 is None else S0.float()
    Ss = []                                    # Ss[t] = S_{t-1}
    for t in range(T):
        Ss.append(S)
        S = wf[:, t, :, :, None] * S + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    lam = (torch.zeros((B, H, hd, hd), dtype=f32, device=r.device) if dS_last is None
           else dS_last.float())
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(T)):
        rt, kt, vt, wt, gt = rf[:, t], kf[:, t], vf[:, t], wf[:, t], gf[:, t]
        vg = (vt * gt).sum(-1, keepdim=True)                       # (B,H,1)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", Ss[t], gt) + uf * kt * vg
        dk[:, t] = torch.einsum("bhij,bhj->bhi", lam, vt) + uf * rt * vg
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", lam, kt)
                    + (rt * uf * kt).sum(-1, keepdim=True) * gt)
        dw[:, t] = (lam * Ss[t]).sum(-1)
        du += (rt * kt * vg).sum(0)
        lam = wt[..., None] * lam + rt[..., None] * gt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype), du.to(u.dtype),
            lam)


# ---------------------------------------------------------------------------
# MoE grouped matmul


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d); w: (E, d, f) -> (E, C, f), in fp32, rounded once to
    x.dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def moe_gmm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`moe_gmm_ref` by x and w, given dy (E, C, f):
    dx[e] = dy[e] w[e]^T and dw[e] = x[e]^T dy[e], in fp32, each rounded once
    to its input's dtype."""
    dyf = dy.float()
    return (torch.einsum("ecf,edf->ecd", dyf, w.float()).to(x.dtype),
            torch.einsum("ecd,ecf->edf", x.float(), dyf).to(w.dtype))


# ---------------------------------------------------------------------------
# AdamW


def global_norm(leaves) -> torch.Tensor:
    """The fp32 norm of every tensor of ``leaves`` taken together."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))


def adamw_scalars(gnorm: torch.Tensor, step: torch.Tensor, *, b1: float, b2: float,
                  grad_clip: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The clip scale of the norm ``gnorm`` and the bias corrections
    ``1 - b1^step``, ``1 - b2^step``, () fp32 tensors."""
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    return scale, 1 - b1 ** step.float(), 1 - b2 ** step.float()


def adamw_leaf_ref(p, g, m, v, scale, lr, b1c, b2c, *, b1: float, b2: float, eps: float,
                   weight_decay: float) -> torch.Tensor:
    """One leaf of the AdamW step: the fp32 moments ``m`` and ``v`` updated
    in place, the new parameter returned in fp32 (``weight_decay`` 0 for a
    leaf that does not decay)."""
    g = g.float() * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g.square())
    delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
    if weight_decay:
        delta = delta + weight_decay * p.float()
    return p.float() - lr * delta


@torch.no_grad()
def adamw_update_ref(params, grads, mu, nu, step: torch.Tensor, lr: torch.Tensor, *,
                     b1: float, b2: float, eps: float, weight_decay: float,
                     grad_clip: float) -> torch.Tensor:
    """One AdamW step on the leaves ``params`` (each updated in place, in its
    own dtype) from ``grads`` (each in its parameter's dtype), with the fp32
    moments ``mu`` and ``nu`` (in place): the gradients clipped by their
    global norm, the bias corrections of ``step`` (the step being taken,
    counted from 1), weight decay on the leaves with ``ndim >= 2`` (norms and
    embedding scales exempt), the learning rate ``lr`` (a () fp32 tensor).
    Returns the norm before clipping, a () fp32 tensor."""
    gnorm = global_norm(grads)
    scale, b1c, b2c = adamw_scalars(gnorm, step, b1=b1, b2=b2, grad_clip=grad_clip)
    for p, g, m, v in zip(params, grads, mu, nu):
        p.copy_(adamw_leaf_ref(p, g, m, v, scale, lr, b1c, b2c, b1=b1, b2=b2, eps=eps,
                               weight_decay=weight_decay if p.dim() >= 2 else 0.0))
    return gnorm


# ---------------------------------------------------------------------------
# AES-128-CTR (the paper's benchmark function) — table-based reference.
# The state is 16 bytes held as int32, in column-major order: byte 4*col + row.

SBOX = torch.tensor([
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
], dtype=torch.int32)
#: GF(2^8) doubling, for MixColumns
XTIME = torch.tensor([((i << 1) ^ (0x11b if i & 0x80 else 0)) for i in range(256)],
                     dtype=torch.int32)
RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1b, 0x36)
#: ShiftRows as a gather: out[4c + r] = in[4((c + r) % 4) + r]
SHIFT_ROWS = torch.tensor([0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11])


def aes_key_expand(key_bytes: torch.Tensor) -> torch.Tensor:
    """key: (16,) int32 bytes -> round keys (11, 16) int32 on the key's device.

    The 44-word schedule is sequential and tiny, so it runs on the host in
    Python integers and is placed on the device once."""
    key = [int(b) for b in key_bytes.reshape(-1).tolist()]
    if len(key) != 16 or not all(0 <= b < 256 for b in key):
        raise ValueError("aes_key_expand: the key is 16 bytes, each in [0, 256)")
    sbox = SBOX.tolist()
    w = [key[4 * i:4 * i + 4] for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = [sbox[b] for b in t[1:] + t[:1]]
            t[0] ^= RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return torch.tensor(w, dtype=torch.int32, device=key_bytes.device).reshape(11, 16)


def _mix_columns(s: torch.Tensor) -> torch.Tensor:
    """s: (..., 16) column-major AES state bytes (int64)."""
    s4 = s.reshape(s.shape[:-1] + (4, 4))          # (..., col, row)
    a0, a1, a2, a3 = s4.unbind(-1)
    xt = XTIME.to(s.device, torch.int64)
    x0, x1, x2, x3 = xt[a0], xt[a1], xt[a2], xt[a3]
    b0 = x0 ^ (a1 ^ x1) ^ a2 ^ a3
    b1 = a0 ^ x1 ^ (a2 ^ x2) ^ a3
    b2 = a0 ^ a1 ^ x2 ^ (a3 ^ x3)
    b3 = (a0 ^ x0) ^ a1 ^ a2 ^ x3
    return torch.stack([b0, b1, b2, b3], dim=-1).reshape(s.shape)


def aes_encrypt_block_ref(block: torch.Tensor, round_keys: torch.Tensor) -> torch.Tensor:
    """block: (..., 16) int32 bytes; round_keys (11, 16) -> (..., 16) int32."""
    sbox = SBOX.to(block.device, torch.int64)
    sr = SHIFT_ROWS.to(block.device)
    rk = round_keys.to(torch.int64)
    s = block.to(torch.int64) ^ rk[0]
    for rnd in range(1, 10):
        s = _mix_columns(sbox[s][..., sr]) ^ rk[rnd]
    s = sbox[s][..., sr] ^ rk[10]
    return s.to(torch.int32)


def aes_ctr_keystream(n: int, round_keys: torch.Tensor, nonce: int = 0) -> torch.Tensor:
    """The keystream of ``n`` counter blocks: block i is 12 zero bytes and
    then ``(i + nonce) mod 2**32`` as a big-endian 32-bit integer."""
    dev = round_keys.device
    ctr = (torch.arange(n, dtype=torch.int64, device=dev) + nonce) & 0xFFFFFFFF
    shifts = torch.arange(24, -1, -8, device=dev)
    blocks = torch.zeros((n, 16), dtype=torch.int64, device=dev)
    blocks[:, 12:] = (ctr[:, None] >> shifts) & 0xFF
    return aes_encrypt_block_ref(blocks, round_keys)


def aes_ctr_ref(plaintext: torch.Tensor, key_bytes: torch.Tensor,
                nonce: int = 0) -> torch.Tensor:
    """plaintext: (N, 16) int32 byte blocks -> ciphertext (N, 16) int32.

    The keystream is XORed with the whole int32 of each plaintext element,
    as the JAX oracle does; nothing is masked to a byte."""
    rk = aes_key_expand(key_bytes).to(plaintext.device)
    return plaintext ^ aes_ctr_keystream(plaintext.shape[0], rk, nonce)
