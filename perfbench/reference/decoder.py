"""Plain fp32 reference of a decoder with RoPE, GQA attention (causal, with
an optional sliding window), RMSNorm and SwiGLU, dense or with top-k
routed experts under a capacity dispatch.

It reads the configuration file's published keys and the weights the
benchmark made (``perfbench.weights``' layout), upcast to fp32 one layer
at a time, and imports nothing of the program.  Matrix products run in
fp32 with TF32 off (the caller's ``fp32_exact``).  The computation goes
layer by layer over every row, attention in blocks of queries, so that it
fits beside the weights.

``quant="fp8"`` computes every weight product with both operands rounded
to float8 e4m3 (activations scaled per row, weights per output column),
the products summed in fp32: the control, a precision below the bf16 that
the configurations state.  Attention's scores, softmax and the router
stay fp32 either way.

The routed experts follow the configuration's ``moe_capacity_factor``:
within one dispatch of T tokens each expert takes at most
C = max(1, int(factor * k * T / E)) of its (token, slot) pairs, in token
order, slot order within a token; later pairs are dropped and the kept
weights are not renormalised.  A served batch is dispatched as the program
serves it: the prompts' B x S tokens together, then each decode position's
B tokens together.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from perfbench.work.counts import dims

F8_MAX = 448.0


@contextlib.contextmanager
def fp32_exact():
    """fp32 products in fp32: TF32 off for matmuls and cuDNN, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _f8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with a scale per slice along ``dim`` (amax to
    448).  Under autograd the rounding passes the gradient through
    unchanged, in fp32, as fp8 training keeps its gradients wider."""
    with torch.no_grad():
        scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / F8_MAX
        q = (t / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach() if t.requires_grad else q


def mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """x (..., d_in) fp32 @ w (d_in, d_out) upcast to fp32; ``quant`` "fp8"
    rounds both operands to e4m3."""
    w = w.float()
    if quant is None:
        return x @ w
    if quant == "fp8":
        return _f8(x, -1) @ _f8(w, 0)
    raise ValueError(f"quant {quant!r}: None or 'fp8'")


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(n: int, hd: int, theta: float, device):
    """cos, sin (n, hd/2) of position p times theta^(-2i/hd), in float64."""
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=device) / hd)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return ang.cos().float(), ang.sin().float()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, n, heads, hd): the two halves of each head turned by the angles."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, win: Optional[int],
           chunk: int = 1024) -> torch.Tensor:
    """Causal GQA attention of one row: q (n, h, hd), k and v (n, kv, hd),
    query i seeing keys j with i - win < j <= i; in query blocks."""
    n, h, hd = q.shape
    kvh = k.shape[1]
    g = h // kvh
    out = torch.empty_like(q)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        lo = 0 if win is None else max(0, a - win + 1)
        qs = q[a:b].reshape(b - a, kvh, g, hd)
        s = torch.einsum("qkgd,tkd->kgqt", qs, k[lo:b]) / math.sqrt(hd)
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(lo, b, device=q.device)[None, :]
        ok = kj <= qi
        if win is not None:
            ok &= kj > qi - win
        p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
        out[a:b] = torch.einsum("kgqt,tkd->qkgd", p, v[lo:b]).reshape(b - a, h, hd)
    return out


def route(h: torch.Tensor, router: torch.Tensor, cfg: dict, group: torch.Tensor,
          group_tokens: torch.Tensor):
    """Top-k routing of tokens h (T, d) and the capacity rule per dispatch.

    ``group`` (T,) is each token's dispatch, numbered from 0 in token order
    within each; ``group_tokens`` (G,) the tokens of each dispatch.
    Returns (expert (T, k), weight (T, k), kept (T, k) bool)."""
    m = dims(cfg)
    E, k = m["E"], m["k"]
    probs = torch.softmax(h @ router.float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weight = top[:, :k] / top[:, :k].sum(-1, keepdim=True)
    expert = order[:, :k]
    # rank of each pair among the pairs of its dispatch and expert, in token order
    key = (group[:, None] * E + expert).reshape(-1)
    sk, perm = torch.sort(key, stable=True)
    counts = torch.bincount(sk, minlength=int(group_tokens.numel()) * E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(key)
    rank[perm] = torch.arange(key.numel(), device=h.device) - starts[sk]
    cap = torch.clamp((cfg["moe_capacity_factor"] * k * group_tokens.double() / E).floor(),
                      min=1).long()
    kept = rank.reshape(-1, k) < cap[group][:, None]
    return expert, weight, kept


def experts(h: torch.Tensor, p: dict, cfg: dict, group: torch.Tensor,
            group_tokens: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """The routed SwiGLU experts of one layer ``p`` on h (T, d), each on its
    kept pairs."""
    expert, weight, kept = route(h, p["router"], cfg, group, group_tokens)
    y = torch.zeros_like(h)
    for e in range(dims(cfg)["E"]):
        sel = kept & (expert == e)
        tok = sel.nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        xe = h[tok]
        a = F.silu(mm(xe, p["w_gate"][e], quant)) * mm(xe, p["w_up"][e], quant)
        out = mm(a, p["w_down"][e], quant)
        y.index_add_(0, tok, out * (weight * sel).sum(-1)[tok, None])
    return y


def mlp(h: torch.Tensor, p: dict, quant: Optional[str], rows: int = 8192) -> torch.Tensor:
    out = torch.empty_like(h)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    for a in range(0, h.shape[0], rows):
        x = h[a:a + rows]
        out[a:a + rows] = mm(F.silu(mm(x, wg, quant)) * mm(x, wu, quant), wd, quant)
    return out


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i`` of the stacked blocks (views)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return take(params["blocks"][0])


def layer(x: torch.Tensor, blk: dict, cfg: dict, cos, sin, group, group_tokens,
          quant: Optional[str]) -> torch.Tensor:
    """One block ``blk`` (``layer_params``) on x (B, n, d): attention, then
    the MLP or the experts."""
    m = dims(cfg)
    B, n, d = x.shape
    eps = cfg["rms_norm_eps"]
    h = rms(x, blk["ln1"], eps)
    a = blk["attn"]
    q = rotate(mm(h, a["wq"], quant).reshape(B, n, m["h"], m["hd"]), cos, sin)
    k = rotate(mm(h, a["wk"], quant).reshape(B, n, m["kv"], m["hd"]), cos, sin)
    v = mm(h, a["wv"], quant).reshape(B, n, m["kv"], m["hd"])
    del h
    o = torch.stack([attend(q[b], k[b], v[b], cfg.get("sliding_window")) for b in range(B)])
    del q, k, v
    x = x + mm(o.reshape(B, n, -1), a["wo"], quant)
    del o
    h = rms(x, blk["ln2"], eps).reshape(B * n, d)
    if m["E"]:
        y = experts(h, blk["moe"], cfg, group, group_tokens, quant)
    else:
        y = mlp(h, blk["mlp"], quant)
    return x + y.reshape(B, n, d)


def head(params: dict, cfg: dict) -> torch.Tensor:
    """The unembedding (d, V): the head, or the embedding's transpose where tied."""
    return params["embed"].T if cfg.get("tie_word_embeddings") else params["lm_head"]


@torch.no_grad()
def served_hidden(params: dict, cfg: dict, tokens: torch.Tensor, prompt_len: int,
                  quant: Optional[str] = None) -> torch.Tensor:
    """The final-normed hidden states (B, n, d) at positions prompt_len - 1
    .. L - 1 of ``tokens`` (B, L): a served batch's prompts followed by all
    but the last of its served tokens, dispatched as served."""
    m = dims(cfg)
    B, L = tokens.shape
    dev = tokens.device
    pos = torch.arange(L, device=dev)
    tgroup = torch.where(pos < prompt_len, 0, pos - prompt_len + 1)
    group = tgroup[None].expand(B, L).reshape(-1)
    group_tokens = torch.full((L - prompt_len + 1,), B, device=dev)
    group_tokens[0] = B * prompt_len
    cos, sin = rope(L, m["hd"], cfg["rope_theta"], dev)
    x = params["embed"][tokens].float()
    for i in range(m["L"]):
        x = layer(x, layer_params(params, i), cfg, cos, sin, group, group_tokens, quant)
    return rms(x[:, prompt_len - 1:], params["final_norm"], cfg["rms_norm_eps"])


@torch.no_grad()
def served_gaps(params: dict, cfg: dict, prompts: torch.Tensor, served: torch.Tensor,
                others: tuple = ()) -> dict:
    """Logit gaps of a served batch: prompts (B, S) and the tokens served
    after them (B, n), greedy.  At each served position, the reference's
    best logit minus its logit of the served token (``"gap"``, (B, n)).
    For each ``quant`` of ``others`` ("fp8": the control) also the gap of
    the token that computation puts first at the same positions
    (``"<quant>_gap"``)."""
    S = prompts.shape[1]
    tokens = torch.cat([prompts, served[:, :-1]], dim=1)
    with fp32_exact():
        hid = served_hidden(params, cfg, tokens, S)
        alt = {q: served_hidden(params, cfg, tokens, S, quant=q) for q in others}
        w = head(params, cfg).float()
        out = {k: [] for k in ["gap"] + [f"{q}_gap" for q in others]}
        for b in range(tokens.shape[0]):
            lg = hid[b] @ w
            best = lg.max(-1).values
            out["gap"].append(best - lg.gather(-1, served[b][:, None])[:, 0])
            for q, h in alt.items():
                first = mm(h[b], w, q).argmax(-1)
                out[f"{q}_gap"].append(best - lg.gather(-1, first[:, None])[:, 0])
        del w
    return {k: torch.stack(v) for k, v in out.items()}


def _unstack(params: dict, L: int) -> list:
    """The stacked blocks as one dict a layer, each leaf taken apart once
    (``unbind``), so that a layer's gradient is not a zero-filled stack."""
    def split(t):
        return {k: split(v) for k, v in t.items()} if isinstance(t, dict) else t.unbind(0)

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]
    parts = split(params["blocks"][0])
    return [pick(parts, i) for i in range(L)]


def loss(params: dict, cfg: dict, tokens: torch.Tensor, labels: torch.Tensor,
         quant: Optional[str] = None, z_coef: float = 1e-4, rows: int = 2048,
         counted: Optional[int] = None) -> torch.Tensor:
    """Mean over tokens of the cross-entropy plus ``z_coef`` lse^2, every
    layer recomputed in the backward (``torch.utils.checkpoint``).
    ``counted`` takes the mean over the first ``counted`` positions of each
    row only (a fault planted for the check's test)."""
    from torch.utils.checkpoint import checkpoint
    m = dims(cfg)
    if m["E"]:
        raise NotImplementedError("training reference: dense decoders only")
    B, S = tokens.shape
    cos, sin = rope(S, m["hd"], cfg["rope_theta"], tokens.device)
    x = params["embed"][tokens].float()
    none = torch.zeros(1, dtype=torch.long, device=tokens.device)
    for blk in _unstack(params, m["L"]):
        x = checkpoint(layer, x, blk, cfg, cos, sin, none, none, quant, use_reentrant=False)
    h = rms(x, params["final_norm"], cfg["rms_norm_eps"]).reshape(B * S, -1)
    w = head(params, cfg)
    if counted is not None:
        h = h.reshape(B, S, -1)[:, :counted].reshape(B * counted, -1)
        labels, S = labels[:, :counted], counted
    lab = labels.reshape(-1)
    total = 0.0

    def piece(hh, ll):
        lg = mm(hh, w, quant)
        lse = torch.logsumexp(lg, -1)
        return (lse - lg.gather(-1, ll[:, None])[:, 0] + z_coef * lse.square()).sum()
    for a in range(0, B * S, rows):
        total = total + checkpoint(piece, h[a:a + rows], lab[a:a + rows], use_reentrant=False)
    return total / (B * S)


def train_steps(initial, cfg: dict, batches, opt: dict, quant: Optional[str] = None,
                counted: Optional[int] = None, chunk: int = 1 << 26) -> dict:
    """The program's first training steps worked out again: the weights
    ``initial()`` makes (the benchmark's, drawn again), the same batches,
    AdamW as ``opt`` states it (fp32 moments, the gradients clipped by
    their global norm, decoupled decay on leaves of two or more dimensions,
    the rate warmed up over ``warmup_steps`` and then cosine-decayed to
    ``min_lr_ratio``).  Forward and backward in fp32; each parameter is
    stored in its own dtype (bf16) after each update, as the configuration
    states.  Returns each step's loss, each leaf's norm of the first step's
    clipped gradient, and each leaf's norm of its change after the steps
    (leaves in sorted-key order).  ``quant`` and ``counted`` as ``loss``
    takes them.  The update goes ``chunk`` elements at a time, so that its
    temporaries stay small beside the moments."""
    from perfbench.weights import leaves
    tree0 = initial()
    dtypes = [t.dtype for t in leaves(tree0)]
    p32 = [t.float() for t in leaves(tree0)]
    shapes = _like(tree0, iter([None] * len(p32)))      # the tree's structure alone
    del tree0
    mu = [torch.zeros_like(t) for t in p32]
    nu = [torch.zeros_like(t) for t in p32]
    b1, b2 = opt["b1"], opt["b2"]
    losses, grad_norms = [], None
    with fp32_exact():
        for step, batch in enumerate(batches, start=1):
            for p in p32:
                p.requires_grad_(True)
            lo = loss(_like(shapes, iter(p32)), cfg, batch["tokens"], batch["labels"], quant,
                      counted=counted)
            grads = list(torch.autograd.grad(lo, p32))
            losses.append(float(lo.detach()))
            del lo
            with torch.no_grad():
                norm = torch.sqrt(sum(g.square().sum() for g in grads))
                scale = torch.clamp(opt["grad_clip"] / (norm + 1e-9), max=1.0)
                if step == 1:
                    grad_norms = [float(g.norm() * scale) for g in grads]
                lr, c1, c2 = _lr(opt, step - 1), 1 - b1 ** step, 1 - b2 ** step
                decay = [opt["weight_decay"] if p.dim() >= 2 else 0.0 for p in p32]
                for i, p in enumerate(p32):
                    p.requires_grad_(False)
                    fp, fg, fm, fv = (t.view(-1) for t in (p, grads[i], mu[i], nu[i]))
                    for a in range(0, fp.numel(), chunk):
                        sl = slice(a, a + chunk)
                        g = fg[sl] * scale
                        fm[sl].mul_(b1).add_((1 - b1) * g)
                        fv[sl].mul_(b2).add_((1 - b2) * g.square())
                        delta = (fm[sl] / c1) / (torch.sqrt(fv[sl] / c2) + opt["eps"])
                        if decay[i]:
                            delta += decay[i] * fp[sl]
                        fp[sl] = (fp[sl] - lr * delta).to(dtypes[i]).float()
                    grads[i] = None
            del grads
    del mu, nu
    change = [float((p - q.float()).norm()) for p, q in zip(p32, leaves(initial()))]
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def _like(tree, it):
    if isinstance(tree, dict):
        filled = {k: _like(tree[k], it) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, tuple):
        return tuple(_like(v, it) for v in tree)
    return next(it)


def _lr(opt: dict, step: int) -> float:
    """The rate at the step counted from 0: linear warm-up, cosine decay."""
    warm = min((step + 1) / max(1, opt["warmup_steps"]), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(1, opt["total_steps"] - opt["warmup_steps"]), 0.0), 1.0)
    cos = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * cos
