"""The backward kernels of ``moe_gmm``, ``mamba_scan`` and ``rwkv6_scan`` on
the CPU.

* Their plain versions (``ref.moe_gmm_bwd_ref``, ``ref.mamba_scan_bwd_ref``,
  ``ref.rwkv6_scan_bwd_ref``) against ``jax.vjp`` of the JAX package's
  ``moe_gmm_ref``, ``mamba_scan_ref`` and ``rwkv6_scan_ref``, with and
  without an initial state and a cotangent of the last state, and against
  autograd of the port's plain forwards: fp32, each gradient within 1e-4 of
  its largest magnitude (the gradients that sum over batch rows, time or
  channels carry sums of hundreds of terms).
* A numpy model of each scan kernel's algorithm (checkpoints every
  ``BWD_CHUNK`` steps, each chunk's states recomputed from its checkpoint,
  the walk back, the xor-shuffle reductions with the lanes' index maps, the
  per-block partials and the second pass) against the plain version,
  including a sequence shorter than a chunk, one that is not a multiple of
  it, and a single step; and of ``moe_gmm``'s backward on transposed
  operands.
* The three autograd functions of ``kernels.ops`` driven on the CPU with the
  kernel entry points patched to the plain versions: every input gets its
  gradient, in its dtype (bf16 included), and a missing cotangent works.
* The backward routes as pure functions of dtype and shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import mamba_scan as tmamba  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as trwkv  # noqa: E402
from repro_torch.kernels._launch import ring_schedule  # noqa: E402

REL = 1e-4   # of each gradient's largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes are small: one intra-op thread, so that torch's thread
    pool does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, expect, name, rel=REL):
    got = np.asarray(got, dtype=np.float64)
    expect = np.asarray(expect, dtype=np.float64)
    assert got.shape == expect.shape, name
    scale = float(np.abs(expect).max()) if expect.size else 0.0
    err = float(np.abs(got - expect).max()) if expect.size else 0.0
    assert err <= rel * scale + 1e-7, f"{name}: max |diff| {err:.3g} of {scale:.3g}"


# ---------------------------------------------------------------------------
# inputs, from a seed with numpy


def _mamba_inputs(B, S, di, ds, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, di)))) * 0.1).astype(f)
    dtx = (rng.standard_normal((B, S, di)) * 0.1).astype(f)
    Bm, Cm = (rng.standard_normal((B, S, ds)).astype(f) for _ in range(2))
    A = (-np.exp(rng.standard_normal((di, ds)))).astype(f)
    h0 = rng.standard_normal((B, di, ds)).astype(f)
    dy = rng.standard_normal((B, S, di)).astype(f)
    dh = rng.standard_normal((B, di, ds)).astype(f)
    return dt, dtx, Bm, Cm, A, h0, dy, dh


def _rwkv_inputs(B, T, H, hd, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    r = rng.standard_normal((B, T, H, hd)).astype(f)
    k, v = ((rng.standard_normal((B, T, H, hd)) * 0.3).astype(f) for _ in range(2))
    w = (1 / (1 + np.exp(-(rng.standard_normal((B, T, H, hd)) * 0.5 + 2)))).astype(f)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(f)
    S0 = (rng.standard_normal((B, H, hd, hd)) * 0.3).astype(f)
    do = rng.standard_normal((B, T, H, hd)).astype(f)
    dS = rng.standard_normal((B, H, hd, hd)).astype(f)
    return r, k, v, w, u, S0, do, dS


def _gmm_inputs(E, C, D, F, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((E, C, D)).astype(f),
            (rng.standard_normal((E, D, F)) * D ** -0.5).astype(f),
            rng.standard_normal((E, C, F)).astype(f))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# the plain backward versions against jax.vjp and torch.autograd

MAMBA_CASES = [(2, 37, 24, 16), (1, 20, 10, 5), (2, 1, 8, 16)]
RWKV_CASES = [(2, 21, 2, 16), (1, 9, 3, 8), (2, 1, 1, 32)]
STATES = [(True, True), (False, False), (True, False), (False, True)]   # (h0, dh_last)


@pytest.mark.parametrize("with_h0,with_dh", STATES)
@pytest.mark.parametrize("case", MAMBA_CASES, ids=str)
def test_mamba_bwd_ref_matches_jax_vjp(case, with_h0, with_dh):
    dt, dtx, Bm, Cm, A, h0, dy, dh = _mamba_inputs(*case)
    h0 = h0 if with_h0 else None
    primals = [dt, dtx, Bm, Cm, A] + ([h0] if with_h0 else [])
    (y, h_last), vjp = jax.vjp(lambda *p: jref.mamba_scan_ref(*p), *map(jnp.asarray, primals))
    expect = vjp((jnp.asarray(dy), jnp.asarray(dh if with_dh else np.zeros_like(h_last))))
    got = tref.mamba_scan_bwd_ref(*_t(dt, dtx, Bm, Cm, A, h0, dy, dh if with_dh else None))
    for name, g, e in zip(("ddt", "ddtx", "dB", "dC", "dA", "dh0"), got, expect):
        assert g.dtype == torch.float32, name
        _close(g.numpy(), np.array(e), name)
    if not with_h0:
        # dh0 is still the cotangent of a zero initial state
        _close(got[5].numpy(), tref.mamba_scan_bwd_ref(
            *_t(dt, dtx, Bm, Cm, A, np.zeros_like(dh), dy, dh if with_dh else None))[5].numpy(),
            "dh0 from zeros")


@pytest.mark.parametrize("with_S0,with_dS", STATES)
@pytest.mark.parametrize("case", RWKV_CASES, ids=str)
def test_rwkv6_bwd_ref_matches_jax_vjp(case, with_S0, with_dS):
    r, k, v, w, u, S0, do, dS = _rwkv_inputs(*case)
    S0 = S0 if with_S0 else None
    primals = [r, k, v, w, u] + ([S0] if with_S0 else [])
    (o, S_last), vjp = jax.vjp(lambda *p: jref.rwkv6_scan_ref(*p), *map(jnp.asarray, primals))
    expect = vjp((jnp.asarray(do), jnp.asarray(dS if with_dS else np.zeros_like(S_last))))
    got = tref.rwkv6_scan_bwd_ref(*_t(r, k, v, w, u, S0, do, dS if with_dS else None))
    for name, g, e in zip(("dr", "dk", "dv", "dw", "du", "dS0"), got, expect):
        assert g.dtype == torch.float32, name
        _close(g.numpy(), np.array(e), name)


@pytest.mark.parametrize("case", [(3, 5, 12, 7), (2, 16, 32, 24), (1, 1, 8, 8)], ids=str)
def test_moe_gmm_bwd_ref_matches_jax_vjp(case):
    x, w, dy = _gmm_inputs(*case)
    _, vjp = jax.vjp(jref.moe_gmm_ref, jnp.asarray(x), jnp.asarray(w))
    got = tref.moe_gmm_bwd_ref(*_t(x, w, dy))
    for name, g, e in zip(("dx", "dw"), got, vjp(jnp.asarray(dy))):
        _close(g.numpy(), np.array(e), name)


@pytest.mark.parametrize("case", MAMBA_CASES[:2], ids=str)
def test_mamba_bwd_ref_matches_autograd_of_the_plain_forward(case):
    dt, dtx, Bm, Cm, A, h0, dy, dh = _mamba_inputs(*case, seed=3)
    leaves = [t.requires_grad_(True) for t in _t(dt, dtx, Bm, Cm, A, h0)]
    y, h_last = tref.mamba_scan_ref(*leaves)
    expect = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                                 + (h_last * torch.from_numpy(dh)).sum(), leaves)
    got = tref.mamba_scan_bwd_ref(*_t(dt, dtx, Bm, Cm, A, h0, dy, dh))
    for name, g, e in zip(("ddt", "ddtx", "dB", "dC", "dA", "dh0"), got, expect):
        _close(g.numpy(), e.numpy(), name)


@pytest.mark.parametrize("case", RWKV_CASES[:2], ids=str)
def test_rwkv6_bwd_ref_matches_autograd_of_the_plain_forward(case):
    r, k, v, w, u, S0, do, dS = _rwkv_inputs(*case, seed=3)
    leaves = [t.requires_grad_(True) for t in _t(r, k, v, w, u, S0)]
    o, S_last = tref.rwkv6_scan_ref(*leaves)
    expect = torch.autograd.grad((o * torch.from_numpy(do)).sum()
                                 + (S_last * torch.from_numpy(dS)).sum(), leaves)
    got = tref.rwkv6_scan_bwd_ref(*_t(r, k, v, w, u, S0, do, dS))
    for name, g, e in zip(("dr", "dk", "dv", "dw", "du", "dS0"), got, expect):
        _close(g.numpy(), e.numpy(), name)


def test_moe_gmm_bwd_ref_matches_autograd_of_the_plain_forward():
    x, w, dy = _gmm_inputs(4, 9, 16, 12, seed=3)
    tx, tw = (t.requires_grad_(True) for t in _t(x, w))
    expect = torch.autograd.grad(tref.moe_gmm_ref(tx, tw), (tx, tw), torch.from_numpy(dy))
    got = tref.moe_gmm_bwd_ref(*_t(x, w, dy))
    for name, g, e in zip(("dx", "dw"), got, expect):
        _close(g.numpy(), e.numpy(), name)


def test_bwd_refs_round_once_to_each_inputs_dtype():
    """bf16 inputs give bf16 gradients and an fp32 cotangent of the initial
    state, each within one bf16 rounding of the fp32 gradients."""
    dt, dtx, Bm, Cm, A, h0, dy, dh = _t(*_mamba_inputs(2, 12, 8, 4))
    bf = [t.bfloat16() for t in (dt, dtx, Bm, Cm, A)]
    got = tref.mamba_scan_bwd_ref(*bf, h0, dy.bfloat16(), dh)
    expect = tref.mamba_scan_bwd_ref(*[t.float() for t in bf], h0, dy.bfloat16().float(), dh)
    assert [g.dtype for g in got] == [torch.bfloat16] * 5 + [torch.float32]
    for g, e in zip(got, expect):
        assert torch.equal(g, e.to(g.dtype))
    x, w, dyg = _t(*_gmm_inputs(2, 3, 8, 8))
    dx, dw = tref.moe_gmm_bwd_ref(x.bfloat16(), w.bfloat16(), dyg.bfloat16())
    assert dx.dtype == dw.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# numpy models of the kernels' algorithms


def _halve_over_lanes(vals, rounds):
    """The xor-shuffle rounds of the kernels on a warp: ``vals`` (..., 32,
    n); in each round m a lane keeps half its values (the upper half if its
    bit m is set), sends the other half to lane ^ m and adds what it gets;
    once it holds one value, a round only adds the partner's.  Returns the
    values (..., 32, n'), the index of each lane's first value among the
    original n (``base``) and the lane bits whose partners hold the same
    sums (``dup``)."""
    lane = np.arange(32)
    base = np.zeros(32, dtype=np.int64)
    dup = 0
    for m in rounds:
        n = vals.shape[-1]
        partner = lane ^ m
        if n > 1:
            hi = ((lane & m) != 0)[:, None]
            lo_half, hi_half = vals[..., :n // 2], vals[..., n // 2:]
            keep = np.where(hi, hi_half, lo_half)
            send = np.where(hi, lo_half, hi_half)
            vals = keep + send[..., partner, :]
            base = base + np.where(hi[:, 0], n // 2, 0)
        else:
            vals = vals + vals[..., partner, :]
            dup |= m
    return vals, base, dup


def _lane_pair_sum(x):
    """The kernels' sum of a value over a row's (or channel's) 4 lanes, as
    the shuffles take it: (x0 + x2) + (x1 + x3); x (..., 4)."""
    return (x[..., 0] + x[..., 2]) + (x[..., 1] + x[..., 3])


def mamba_bwd_model(dt, dtx, Bm, Cm, A, h0, dy, dh_last, chunk=None, keep_a=False):
    """The ``ckpt`` design in numpy fp32: blocks of ``BWD_CHANNELS`` channels
    of 4 lanes, checkpoints every ``BWD_CHUNK`` steps, each chunk recomputed
    from its checkpoint and walked back, ddt and ddtx summed over a
    channel's lanes, dC and dB over each warp's 8 channels by the halving
    shuffles, then over the block's warps into (B, blocks, S, 32) partials,
    dA into per-batch-row partials; the second pass adds them in order.

    With ``chunk`` and ``keep_a`` it is the ``ring`` design: checkpoints
    every ``chunk`` steps; the recompute takes a_t once and keeps it beside
    h_{t-1}, the walk back takes no exponential and its h_t (towards dC) is
    the h_{t-1} it held a step before (the last step's: the recompute's
    final state)."""
    f = np.float32
    K, CH = chunk or tmamba.BWD_CHUNK, tmamba.BWD_CHANNELS
    Bsz, S, di = dt.shape
    ds = Bm.shape[2]
    nblk = -(-di // CH)
    dip = nblk * CH

    def pad_c(x):
        out = np.zeros(x.shape[:-1] + (dip,), f)
        out[..., :di] = x
        return out

    dtp, dtxp, dyp = pad_c(dt), pad_c(dtx), pad_c(dy)
    A16 = np.zeros((dip, 16), f)
    A16[:di, :ds] = A
    B16, C16 = np.zeros((Bsz, S, 16), f), np.zeros((Bsz, S, 16), f)
    B16[..., :ds], C16[..., :ds] = Bm, Cm
    h = np.zeros((Bsz, dip, 16), f)
    if h0 is not None:
        h[:, :di, :ds] = h0

    def decay(t):
        return np.exp(dtp[:, t, :, None] * A16).astype(f)

    n_chunks = -(-S // K)
    ckpt = np.zeros((Bsz, n_chunks, dip, 16), f)
    for j in range(n_chunks):            # the forward walk
        ckpt[:, j] = h
        for t in range(j * K, min(S, (j + 1) * K)):
            h = (decay(t) * h + dtxp[:, t, :, None] * B16[:, t, None, :]).astype(f)
    carry = np.zeros((Bsz, dip, 16), f)
    if dh_last is not None:
        carry[:, :di, :ds] = dh_last
    dA = np.zeros((Bsz, dip, 16), f)
    ddt, ddtx = np.zeros((Bsz, S, dip), f), np.zeros((Bsz, S, dip), f)
    part = np.zeros((Bsz, nblk, S, tmamba.BWD_SLOTS), f)
    warps = CH * 4 // 32
    for j in reversed(range(n_chunks)):  # the walk back
        t0 = j * K
        steps = min(K, S - t0)
        hist, kept, hp = [], [], ckpt[:, j]
        for s in range(steps):
            hist.append(hp)
            kept.append(decay(t0 + s))            # a_t, taken once (ring)
            hp = (kept[-1] * hp + dtxp[:, t0 + s, :, None] * B16[:, t0 + s, None, :]).astype(f)
        h_next = hp                               # h_t of the step walked (ring)
        red = np.zeros((Bsz, nblk, steps, warps, 32), f)
        for s in reversed(range(steps)):
            t = t0 + s
            e, hpv = (kept[s] if keep_a else decay(t)), hist[s]
            lam = (dyp[:, t, :, None] * C16[:, t, None, :] + carry).astype(f)
            qq = lam * hpv * e
            if keep_a:
                ht, h_next = h_next, hpv
            else:
                ht = e * hpv + dtxp[:, t, :, None] * B16[:, t, None, :]
            ddtx[:, t] = _lane_pair_sum((lam * B16[:, t, None, :]).reshape(Bsz, dip, 4, 4).sum(-1))
            ddt[:, t] = _lane_pair_sum((qq * A16).reshape(Bsz, dip, 4, 4).sum(-1))
            dA += qq * dtp[:, t, :, None]
            carry = (e * lam).astype(f)
            # lane 4 g' + q of a warp holds channel g' and states 4q .. 4q + 3
            v8 = np.concatenate([(dyp[:, t, :, None] * ht).reshape(Bsz, dip, 4, 4),
                                 (lam * dtxp[:, t, :, None]).reshape(Bsz, dip, 4, 4)], -1)
            v8 = v8.reshape(Bsz, nblk, warps, 32, 8)
            out, base, dup = _halve_over_lanes(v8, (16, 8, 4))
            assert dup == 0 and np.array_equal(base, np.arange(32) >> 2)
            lane = np.arange(32)
            red[:, :, s, :, (lane & 3) * 8 + (lane >> 2)] = np.moveaxis(out[..., 0], -1, 0)
        kk = np.arange(32)
        slot = (kk & 7) // 4 * 16 + 4 * (kk >> 3) + (kk & 3)
        for s in range(steps):
            acc = np.zeros((Bsz, nblk, 32), f)
            for wv in range(warps):
                acc += red[:, :, s, wv]
            part[:, :, t0 + s][..., slot] = acc
    assert sorted(slot) == list(range(32))
    dC = np.zeros((Bsz, S, ds), f)
    dB = np.zeros((Bsz, S, ds), f)
    for blk in range(nblk):               # the second pass, in block order
        dC += part[:, blk, :, :ds]
        dB += part[:, blk, :, 16:16 + ds]
    dAsum = np.zeros((dip, 16), f)
    for b in range(Bsz):
        dAsum += dA[b]
    return (ddt[..., :di], ddtx[..., :di], dB, dC, dAsum[:di, :ds], carry[:, :di, :ds],
            ckpt)


def rwkv_bwd_model(r, k, v, w, u, S0, do, dS_last):
    """The ``rows`` design in numpy fp32: thread (i, p) of a head's 4 hd
    threads holds columns 16 m + 4 p .. + 3 of row i; a forward sweep gives
    dr and checkpoints every ``BWD_CHUNK`` steps, the walk back recomputes
    each chunk and gives dk and dw (sums over a row's 4 lanes) and dv (the
    halving shuffles over each warp's 8 rows, then the warps in order); du
    per (batch row, head) partials, added in order by the second pass."""
    f = np.float32
    K = trwkv.BWD_CHUNK
    B, T, H, hd = r.shape
    cpt, W = hd // 4, hd // 8
    # cols[p, idx]: the column of a thread's value idx on lane p
    idx = np.arange(cpt)
    cols = 16 * (idx >> 2)[None, :] + 4 * np.arange(4)[:, None] + (idx & 3)[None, :]
    assert sorted(cols.ravel()) == list(range(hd))

    def by_thread(x):      # (..., hd) over columns -> (..., 4, cpt) by lane and value
        return x[..., cols]

    S = np.zeros((B, H, hd, hd), f) if S0 is None else S0.astype(f).copy()
    n_chunks = -(-T // K)
    ckpt = np.zeros((B, H, n_chunks, hd, hd), f)
    dr = np.zeros((B, T, H, hd), f)
    for c in range(n_chunks):            # the forward sweep
        ckpt[:, :, c] = S
        for t in range(c * K, min(T, (c + 1) * K)):
            g, vt, kt, wt = do[:, t], v[:, t], k[:, t], w[:, t]
            vg = (by_thread(vt) * by_thread(g)).sum(-1)                       # (B,H,4)
            part = (by_thread(S) * by_thread(g)[:, :, None]).sum(-1)          # (B,H,hd,4)
            part = part + (u * kt)[..., None] * vg[:, :, None, :]
            dr[:, t] = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
            S = (wt[..., None] * S + kt[..., None] * vt[:, :, None, :]).astype(f)
    L = np.zeros((B, H, hd, hd), f) if dS_last is None else dS_last.astype(f).copy()
    dk, dv, dw = (np.zeros((B, T, H, hd), f) for _ in range(3))
    du_acc = np.zeros((B, H, hd, 4), f)
    for c in reversed(range(n_chunks)):  # the walk back
        t0 = c * K
        steps = min(K, T - t0)
        hist, P = [], ckpt[:, :, c]
        for s in range(steps):
            hist.append(P)
            t = t0 + s
            P = (w[:, t][..., None] * P + k[:, t][..., None] * v[:, t][:, :, None, :]).astype(f)
        red = np.zeros((B, H, steps, W, hd), f)
        for s in reversed(range(steps)):
            t = t0 + s
            rt, kt, vt, wt, g = r[:, t], k[:, t], v[:, t], w[:, t], do[:, t]
            vg = (by_thread(vt) * by_thread(g)).sum(-1)                       # (B,H,4)
            pk = (by_thread(L) * by_thread(vt)[:, :, None]).sum(-1) \
                + (u * rt)[..., None] * vg[:, :, None, :]
            pw = (by_thread(L) * by_thread(hist[s])).sum(-1)
            du_acc += (rt * kt)[..., None] * vg[:, :, None, :]
            dk[:, t] = _lane_pair_sum(pk)
            dw[:, t] = _lane_pair_sum(pw)
            ruk = rt * u * kt
            dvp = by_thread(L) * kt[..., None, None] + ruk[..., None, None] \
                * by_thread(g)[:, :, None]                                    # (B,H,hd,4,cpt)
            # rows i = 8 warp + il on lanes 4 il + p
            out, base, dup = _halve_over_lanes(dvp.reshape(B, H, W, 32, cpt), (16, 8, 4))
            lane = np.arange(32)
            seen = np.zeros(hd, dtype=np.int64)
            for ln in lane[(lane & dup) == 0]:
                for kk in range(out.shape[-1]):
                    col = cols[ln & 3, base[ln] + kk]
                    red[:, :, s, :, col] = out[:, :, :, ln, kk]
                    seen[col] += 1
            assert (seen == 1).all()
            L = (wt[..., None] * L + rt[..., None] * g[:, :, None, :]).astype(f)
        for s in range(steps):
            acc = np.zeros((B, H, hd), f)
            for wv in range(W):
                acc += red[:, :, s, wv]
            dv[:, t0 + s] = acc
    du_part = _lane_pair_sum(du_acc)                                          # (B,H,hd)
    du = np.zeros((H, hd), f)
    for b in range(B):                   # the second pass, in batch order
        du += du_part[b]
    return dr, dk, dv, dw, du, L, ckpt


def rwkv_ring_model(r, k, v, w, u, S0, do, dS_last, chunk=None):
    """The ``ring`` design in numpy fp32: thread (i, p) of a head's hd * hd /
    8 holds 8 values of row i (``ring_owner``); a forward sweep only
    advances S and checkpoints it every ``chunk`` steps; the walk back takes
    each chunk's states in two levels (from the checkpoint S at steps 4, 8,
    12 and the last piece's states; then each earlier piece of 4 again from
    its first state, which must give the same states), and per step dr from
    S_{t-1}, dk, dw (the halving shuffles of [dk, dw, dr, 0] over the row's
    lanes, the u terms from v . g added by the lane that stores) and dv (the
    halving shuffles over each warp's rows, warp 0 adding (r . u k) g, then
    the warps in order); du per (batch row, head) partials added in batch
    order.  Returns the gradients, the checkpoints and the states each piece
    walked."""
    f = np.float32
    K, P = chunk or trwkv.RING_CHUNK, trwkv.RING_PIECE
    B, T, H, hd = r.shape
    geo = trwkv.ring_geometry(B, T, H, hd, 4, K)
    LPR, NT, V = geo.lanes, geo.block, 8
    NW = NT // 32
    owner = [trwkv.ring_owner(hd, tid) for tid in range(NT)]
    rows = np.array([i for i, _ in owner])
    cols = np.array([c for _, c in owner])                                  # (NT, V)
    held = np.zeros((hd, hd), np.int64)
    np.add.at(held, (np.repeat(rows, V), cols.ravel()), 1)
    assert (held == 1).all()

    def advance(S, t):
        return (w[:, t][..., None] * S + k[:, t][..., None] * v[:, t][:, :, None, :]).astype(f)

    S = np.zeros((B, H, hd, hd), f) if S0 is None else S0.astype(f).copy()
    n_ck = -(-T // K)
    ckpt = np.zeros((B, H, n_ck, hd, hd), f)
    for c in range(n_ck):                # the forward sweep
        ckpt[:, :, c] = S
        for t in range(c * K, min(T, (c + 1) * K)):
            S = advance(S, t)
    L = np.zeros((B, H, hd, hd), f) if dS_last is None else dS_last.astype(f).copy()
    dr, dk, dv, dw = (np.zeros((B, T, H, hd), f) for _ in range(4))
    du_part = np.zeros((B, H, hd), f)
    lane = np.arange(32)
    row_rounds = tuple(1 << b for b in reversed(range(LPR.bit_length() - 1)))   # LPR/2 .. 1
    dv_rounds = tuple(m for m in (16, 8, 4, 2) if m >= LPR)
    walked = {}
    for c in reversed(range(n_ck)):      # the walk back
        t0 = c * K
        steps = min(K, T - t0)
        last = (steps - 1) // P
        vg = (v[:, t0:t0 + steps] * do[:, t0:t0 + steps]).sum(-1, dtype=f)         # (B, s, H)
        rk = (r[:, t0:t0 + steps] * u * k[:, t0:t0 + steps]).sum(-1, dtype=f)
        level1, Pst = {}, ckpt[:, :, c]
        for s in range(steps - 1):
            Pst = advance(Pst, t0 + s)
            if (s + 1) % P == 0 or (s + 1) // P == last:
                level1[s + 1] = Pst
        for pc in reversed(range(last + 1)):
            pt0 = pc * P
            psteps = min(P, steps - pt0)
            states = [ckpt[:, :, c] if pc == 0 else level1[pt0]]
            for s in range(1, psteps):
                if pc == last:
                    states.append(level1[pt0 + s])
                else:                    # the second level
                    states.append(advance(states[-1], t0 + pt0 + s - 1))
            walked[t0 + pt0] = states
            red = np.zeros((B, H, psteps, NW, hd), f)
            for s in reversed(range(psteps)):
                t = t0 + pt0 + s
                Sp, Lt = states[s][:, :, rows[:, None], cols], L[:, :, rows[:, None], cols]
                vt, gt = v[:, t][:, :, cols], do[:, t][:, :, cols]                # (B,H,NT,8)
                ri, ki = r[:, t][:, :, rows], k[:, t][:, :, rows]                 # (B,H,NT)
                rs = np.stack([(Lt * vt).sum(-1), (Lt * Sp).sum(-1), (Sp * gt).sum(-1),
                               np.zeros_like(ri)], -1).astype(f)
                out, base, dup = _halve_over_lanes(rs.reshape(B, H, NW, 32, 4), row_rounds)
                seen = np.zeros((3, hd), np.int64)
                for ln in lane[(lane & dup) == 0]:
                    i_w = rows[np.arange(NW) * 32 + ln]                           # row, by warp
                    for kk in range(out.shape[-1]):
                        idx = base[ln] + kk
                        if idx < 3:
                            [dk, dw, dr][idx][:, t][:, :, i_w] = out[:, :, :, ln, kk]
                            seen[idx, i_w] += 1
                assert (seen == 1).all()
                dk[:, t] += u * r[:, t] * vg[:, s + pt0][..., None]
                dr[:, t] += u * k[:, t] * vg[:, s + pt0][..., None]
                du_part += r[:, t] * k[:, t] * vg[:, s + pt0][..., None]
                out, base, dup = _halve_over_lanes((Lt * ki[..., None]).reshape(B, H, NW, 32, V),
                                                   dv_rounds)
                seen = np.zeros(hd, np.int64)
                for ln in lane[(lane & dup) == 0]:
                    for kk in range(out.shape[-1]):
                        col = cols[ln, base[ln] + kk]                             # p = ln % LPR
                        red[:, :, s, :, col] = out[:, :, :, ln, kk]
                        red[:, :, s, 0, col] += rk[:, s + pt0] * do[:, t][:, :, col]
                        seen[col] += 1
                assert (seen == 1).all()
                L = (w[:, t][..., None] * L + r[:, t][..., None] * do[:, t][:, :, None, :]).astype(f)
            for s in range(psteps):
                acc = np.zeros((B, H, hd), f)
                for wv in range(NW):
                    acc += red[:, :, s, wv]
                dv[:, t0 + pt0 + s] = acc
    du = np.zeros((H, hd), f)
    for b in range(B):                   # the second pass, in batch order
        du += du_part[b]
    return (dr, dk, dv, dw, du, L), ckpt, walked


@pytest.mark.parametrize("case", [
    (2, 37, 100, 16),    # S not a multiple of the chunk; two blocks, the second ragged
    (1, 9, 64, 16),      # S below the chunk
    (2, 1, 70, 5),       # one step; ds below a lane's 4 on the second lane
    (1, 48, 24, 12),     # S a multiple of the chunk; ds 12
], ids=str)
def test_mamba_kernel_model_matches_the_plain_backward(case):
    dt, dtx, Bm, Cm, A, h0, dy, dh = _mamba_inputs(*case, seed=7)
    *got, ckpt = mamba_bwd_model(dt, dtx, Bm, Cm, A, h0, dy, dh)
    expect = tref.mamba_scan_bwd_ref(*_t(dt, dtx, Bm, Cm, A, h0, dy, dh))
    for name, g, e in zip(("ddt", "ddtx", "dB", "dC", "dA", "dh0"), got, expect):
        _close(g, e.numpy(), name)
    B, S, di, ds = case
    shapes = tmamba.bwd_scratch_shapes(B, S, di, ds)
    assert shapes["ckpt"][:3] == ckpt.shape[:2] + (di,)
    assert shapes["bc_part"] == (B, -(-di // tmamba.BWD_CHANNELS), S, tmamba.BWD_SLOTS)


def test_mamba_kernel_model_checkpoints_are_the_states():
    """Checkpoint j is the state before step 16 j, as the plain forward has
    it, and with no initial state the first is zero."""
    dt, dtx, Bm, Cm, A, _, dy, _ = _mamba_inputs(1, 40, 8, 16, seed=2)
    *_, ckpt = mamba_bwd_model(dt, dtx, Bm, Cm, A, None, dy, None)
    assert not ckpt[:, 0].any()
    for j in (1, 2):
        t = j * tmamba.BWD_CHUNK
        _, h = tref.mamba_scan_ref(*_t(dt[:, :t], dtx[:, :t], Bm[:, :t], Cm[:, :t], A))
        _close(ckpt[:, j, :8, :16], h.numpy(), f"checkpoint {j}")


@pytest.mark.parametrize("case", [
    (2, 21, 2, 16),      # T not a multiple of the chunk
    (1, 5, 1, 32),       # T below the chunk
    (1, 1, 2, 64),       # one step
    (1, 16, 1, 64),      # T a multiple of the chunk
], ids=str)
def test_rwkv6_kernel_model_matches_the_plain_backward(case):
    r, k, v, w, u, S0, do, dS = _rwkv_inputs(*case, seed=7)
    for S0_, dS_ in ((S0, dS), (None, None)):
        *got, ckpt = rwkv_bwd_model(r, k, v, w, u, S0_, do, dS_)
        expect = tref.rwkv6_scan_bwd_ref(*_t(r, k, v, w, u, S0_, do, dS_))
        for name, g, e in zip(("dr", "dk", "dv", "dw", "du", "dS0"), got, expect):
            _close(g, e.numpy(), name)
    assert ckpt.shape[2] == -(-case[1] // trwkv.BWD_CHUNK)


RING_STATES = [(True, True), (False, False)]   # (initial state and last cotangent) or none


@pytest.mark.parametrize("with_state", [True, False], ids=["state", "no_state"])
@pytest.mark.parametrize("chunk", tmamba.RING_CHUNKS)
@pytest.mark.parametrize("case", [
    (2, 37, 128, 16),    # S not a multiple of the chunk; two blocks
    (1, 9, 64, 16),      # S below the chunk
    (2, 1, 96, 8),       # one step; di not a multiple of 64; ds 8
    (1, 48, 64, 12),     # S a multiple of the chunk; ds 12: the fourth lane off
], ids=str)
def test_mamba_ring_model_matches_the_plain_backward(case, chunk, with_state):
    B, S, di, ds = case
    assert tmamba.bwd_route(torch.float32, ds, di) == "ring"
    dt, dtx, Bm, Cm, A, h0, dy, dh = _mamba_inputs(*case, seed=11)
    h0, dh = (h0, dh) if with_state else (None, None)
    *got, ckpt = mamba_bwd_model(dt, dtx, Bm, Cm, A, h0, dy, dh, chunk=chunk, keep_a=True)
    expect = tref.mamba_scan_bwd_ref(*_t(dt, dtx, Bm, Cm, A, h0, dy, dh))
    for name, g, e in zip(("ddt", "ddtx", "dB", "dC", "dA", "dh0"), got, expect):
        _close(g, e.numpy(), name)
    # a_t kept and h_t carried give the arithmetic of taking them again
    *again, _ = mamba_bwd_model(dt, dtx, Bm, Cm, A, h0, dy, dh, chunk=chunk)
    for name, g, e in zip(("ddt", "ddtx", "dB", "dC", "dA", "dh0"), got, again):
        assert np.array_equal(g, e), name
    assert ckpt.shape[:2] + (di,) == tmamba.bwd_scratch_shapes(B, S, di, ds, chunk)["ckpt"][:3]


@pytest.mark.parametrize("chunk", trwkv.RING_CHUNKS)
@pytest.mark.parametrize("case", [
    (2, 21, 2, 16),      # T not a multiple of the chunk; one warp
    (1, 5, 1, 32),       # T below the chunk; 4 lanes a row
    (1, 1, 2, 64),       # one step
    (1, 32, 1, 64),      # T a multiple of the chunk; 16 warps
    (2, 19, 1, 32),      # a last chunk of 3 steps, the piece below 4
], ids=str)
def test_rwkv6_ring_model_matches_the_plain_backward(case, chunk):
    r, k, v, w, u, S0, do, dS = _rwkv_inputs(*case, seed=13)
    for S0_, dS_ in ((S0, dS), (None, None)):
        got, ckpt, _ = rwkv_ring_model(r, k, v, w, u, S0_, do, dS_, chunk=chunk)
        expect = tref.rwkv6_scan_bwd_ref(*_t(r, k, v, w, u, S0_, do, dS_))
        for name, g, e in zip(("dr", "dk", "dv", "dw", "du", "dS0"), got, expect):
            _close(g, e.numpy(), name)
    B, T, H, hd = case
    assert ckpt.shape == trwkv.bwd_scratch_shapes(B, T, H, hd, "ring", chunk)["ckpt"]


@pytest.mark.parametrize("T", [1, 3, 4, 16, 17, 30, 48])
def test_rwkv6_ring_model_walks_each_step_from_its_own_state(T):
    """Each piece of the walk back starts at the state the forward had
    there, and its two-level recompute gives every state S_{t-1} exactly as
    one sequential pass does: every step once, in both spacings."""
    r, k, v, w, u, S0, do, dS = _rwkv_inputs(1, T, 1, 16, seed=5)
    f = np.float32
    seq = [S0.astype(f)]
    for t in range(T):
        seq.append((w[:, t][..., None] * seq[-1] + k[:, t][..., None]
                    * v[:, t][:, :, None, :]).astype(f))
    for chunk in trwkv.RING_CHUNKS:
        _, _, walked = rwkv_ring_model(r, k, v, w, u, S0, do, dS, chunk=chunk)
        covered = []
        for t0, states in walked.items():
            for s, St in enumerate(states):
                assert np.array_equal(St, seq[t0 + s]), (chunk, t0, s)
                covered.append(t0 + s)
        assert sorted(covered) == list(range(T))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 32])
def test_ring_schedule_stages_every_chunk_once(n):
    """The scan backwards' ring: the forward pass walks chunks 0 .. n - 1 and
    the walk back n - 1 .. 0, each chunk filled once a pass; a stage is
    refilled only once the chunk it held has been walked, a walk finds its
    chunk in its stage at the parity it waits for, and at most the stages'
    count are in flight."""
    stages = trwkv.RING_STAGES
    assert stages == tmamba.RING_STAGES
    held = {}                                    # stage -> (use, chunk, parity)
    walks, fills, started = [], [], -1
    for kind, use, chunk in ring_schedule(n, stages):
        st, parity = use % stages, (use // stages) & 1
        if kind == "fill":
            if st in held:                       # its chunk walked, and the walk done
                assert held[st][0] < started
            held[st] = (use, chunk, parity)
            fills.append((use, chunk))
        else:
            assert held[st] == (use, chunk, parity)
            assert sum(u > use for u, _ in fills) <= stages - 1
            walks.append(chunk)
            started = use
    assert walks == list(range(n)) + list(reversed(range(n)))
    assert sorted(fills) == [(u, c) for u, c in zip(range(2 * n), walks)]


def test_moe_gmm_bwd_on_transposed_operands_is_the_plain_backward():
    """The backward's two products as the forward kernel computes them, on
    the copies the wrapper makes: dx = dy @ (w laid out (E, F, D)) and dw =
    (x laid out (E, D, C)) @ dy, each summed in fp32 and rounded once."""
    x, w, dy = _t(*_gmm_inputs(3, 13, 24, 40, seed=4))
    for dt in (torch.float32, torch.bfloat16):
        xx, ww, dd = x.to(dt), w.to(dt), dy.to(dt)
        dx = tref.moe_gmm_ref(dd, ww.transpose(1, 2).contiguous())
        dw = tref.moe_gmm_ref(xx.transpose(1, 2).contiguous(), dd)
        ex, ew = tref.moe_gmm_bwd_ref(xx, ww, dd)
        assert torch.equal(dx, ex) and torch.equal(dw, ew)


@pytest.mark.parametrize("R,C", [(130, 70), (64, 64), (1, 200), (200, 1)])
def test_transpose_kernel_tiles_cover_every_element_once(R, C):
    """The transpose kernel's grid (64 x 64 tiles, 64 x 8 threads, each
    thread 8 rows of its tile, masked at the edges) reads and writes every
    element of an (R, C) matrix once, to its transposed place."""
    tile, rows = 64, 8
    src = np.arange(R * C).reshape(R, C)
    dst = np.full((C, R), -1)
    writes = np.zeros((C, R), dtype=np.int64)
    for bx in range(-(-C // tile)):
        for by in range(-(-R // tile)):
            for ty in range(rows):
                for i in range(ty, tile, rows):
                    for tx in range(tile):
                        c, r = bx * tile + i, by * tile + tx
                        if r < R and c < C:
                            dst[c, r] = src[r, c]
                            writes[c, r] += 1
    assert (writes == 1).all() and (dst == src.T).all()


# ---------------------------------------------------------------------------
# the autograd functions on the CPU, the kernels patched to the plain versions


@pytest.fixture
def plain_kernels(monkeypatch):
    monkeypatch.setattr(tgmm, "moe_gmm", tref.moe_gmm_ref)
    monkeypatch.setattr(tgmm, "moe_gmm_bwd", tref.moe_gmm_bwd_ref)
    monkeypatch.setattr(tmamba, "mamba_scan", tref.mamba_scan_ref)
    monkeypatch.setattr(tmamba, "mamba_scan_bwd", tref.mamba_scan_bwd_ref)
    monkeypatch.setattr(trwkv, "rwkv6_scan", tref.rwkv6_scan_ref)
    monkeypatch.setattr(trwkv, "rwkv6_scan_bwd", tref.rwkv6_scan_bwd_ref)
    ops.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_moe_gmm_function_gives_every_input_its_gradient(plain_kernels, dtype):
    x, w, dy = (t.to(dtype) for t in _t(*_gmm_inputs(2, 6, 16, 8)))
    x.requires_grad_(True)
    w.requires_grad_(True)
    out = ops._MoeGmm.apply(x, w)
    assert out.grad_fn is not None and out.dtype == dtype
    dx, dw = torch.autograd.grad(out, (x, w), dy)
    ex, ew = tref.moe_gmm_bwd_ref(x.detach(), w.detach(), dy)
    assert dx.dtype == dw.dtype == dtype
    assert torch.equal(dx, ex) and torch.equal(dw, ew)
    assert ops.LAUNCHES["moe_gmm_bwd"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_mamba_function_gives_every_input_its_gradient(plain_kernels, dtype):
    dt, dtx, Bm, Cm, A, h0, dy, dh = _t(*_mamba_inputs(2, 11, 8, 4))
    leaves = [t.to(dtype).requires_grad_(True) for t in (dt, dtx, Bm, Cm, A)]
    h0.requires_grad_(True)
    y, h_last = ops._MambaScan.apply(*leaves, h0)
    assert y.grad_fn is not None and h_last.grad_fn is not None
    grads = torch.autograd.grad((y.float() * dy).sum() + (h_last * dh).sum(), [*leaves, h0])
    expect = tref.mamba_scan_bwd_ref(*[t.detach() for t in leaves], h0.detach(),
                                     dy.to(dtype), dh)
    for g, e, t in zip(grads, expect, [*leaves, h0]):
        assert g.dtype == t.dtype
        torch.testing.assert_close(g, e, rtol=1e-2 if dtype == torch.bfloat16 else 1e-6,
                                   atol=1e-6)
    assert ops.LAUNCHES["mamba_scan_bwd"] == 1
    # no cotangent of the last state (None), and no initial state
    y, h_last = ops._MambaScan.apply(*leaves, None)
    grads = torch.autograd.grad(y.float().sum(), leaves)
    expect = tref.mamba_scan_bwd_ref(*[t.detach() for t in leaves], None,
                                     torch.ones_like(dy).to(dtype), None)
    for g, e in zip(grads, expect):
        torch.testing.assert_close(g, e, rtol=1e-2 if dtype == torch.bfloat16 else 1e-6,
                                   atol=1e-6)
    # only the last state's cotangent: y's is None
    (gdt,) = torch.autograd.grad(ops._MambaScan.apply(*leaves, None)[1].sum(), leaves[:1])
    assert gdt.shape == dt.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_rwkv6_function_gives_every_input_its_gradient(plain_kernels, dtype):
    r, k, v, w, u, S0, do, dS = _t(*_rwkv_inputs(2, 7, 2, 16))
    leaves = [t.to(dtype).requires_grad_(True) for t in (r, k, v, w, u)]
    S0.requires_grad_(True)
    o, S_last = ops._Rwkv6Scan.apply(*leaves, S0)
    grads = torch.autograd.grad((o.float() * do).sum() + (S_last * dS).sum(), [*leaves, S0])
    expect = tref.rwkv6_scan_bwd_ref(*[t.detach() for t in leaves], S0.detach(),
                                     do.to(dtype), dS)
    for g, e, t in zip(grads, expect, [*leaves, S0]):
        assert g.dtype == t.dtype
        torch.testing.assert_close(g, e, rtol=1e-2 if dtype == torch.bfloat16 else 1e-6,
                                   atol=1e-6)
    assert ops.LAUNCHES["rwkv6_scan_bwd"] == 1
    o, _ = ops._Rwkv6Scan.apply(*leaves, None)
    grads = torch.autograd.grad(o.float().sum(), leaves)
    assert all(g is not None and g.dtype == dtype for g in grads)


def test_ops_take_the_plain_versions_on_the_cpu_and_count_nothing():
    """On the CPU the ops run the plain versions, which keep their autograd,
    and no launch is counted."""
    ops.reset_launches()
    dt, dtx, Bm, Cm, A, h0, dy, dh = _t(*_mamba_inputs(1, 5, 8, 4))
    dt.requires_grad_(True)
    y, _ = ops.mamba_scan(dt, dtx, Bm, Cm, A)
    y.sum().backward()
    x, w, _ = _t(*_gmm_inputs(2, 3, 8, 8))
    w.requires_grad_(True)
    ops.moe_gmm(x, w).sum().backward()
    assert dt.grad is not None and w.grad is not None
    assert not any(ops.LAUNCHES.values())
    assert {"moe_gmm_bwd", "mamba_scan_bwd", "rwkv6_scan_bwd"} <= set(ops.ROUTE_LAUNCHES)


def test_the_wrappers_refuse_cpu_tensors():
    x, w, dy = _t(*_gmm_inputs(2, 3, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tgmm.moe_gmm_bwd(x, w, dy)
    with pytest.raises(ValueError, match="CUDA"):
        tmamba.mamba_scan_bwd(*_t(*_mamba_inputs(1, 3, 8, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        trwkv.rwkv6_scan_bwd(*_t(*_rwkv_inputs(1, 3, 1, 16)))


# ---------------------------------------------------------------------------
# routes


@pytest.mark.parametrize("C,D,F,expect", [
    # mixtral's training gate/up: w read transposed for dx, x for dw
    (1280, 4096, 14336, ("wgmma_nt", "wgmma_tn")),
    (1280, 14336, 4096, ("wgmma_nt", "wgmma_tn")),  # and down
    # jamba's gate/up and down: five row tiles of C, which do not pair, so
    # dx on the forward's design reading w transposed
    (640, 4096, 14336, ("wgmma_nt_fwd", "wgmma_tn")),
    (640, 14336, 4096, ("wgmma_nt_fwd", "wgmma_tn")),
    # C not a multiple of 8: dw contracts over it, and TMA zero-fills its tail
    (100, 4096, 14336, ("wgmma_nt_fwd", "wgmma_tn")),
    (200, 4096, 14336, ("wgmma_nt", "wgmma_tn")),
    (2, 4096, 14336, ("stream", "wgmma_tn")),    # a decode-sized C
    (32, 4096, 14336, ("mma_sync", "wgmma_tn")),  # C between the thresholds
    (1280, 4096, 100, ("mma_sync", "mma_sync")),  # F not a multiple of 8
    (1280, 32, 64, ("wgmma_nt", "mma_sync")),    # D below WGMMA_MIN_C: dw over a copy of x
])
def test_moe_gmm_bwd_route(C, D, F, expect):
    assert tgmm.bwd_route(torch.bfloat16, C, D, F) == expect
    assert tgmm.bwd_route(torch.float32, C, D, F) == ("mma_sync", "mma_sync")


def test_moe_gmm_bwd_at_the_training_shapes_copies_nothing(monkeypatch):
    """On the routes of the training shapes (``wgmma_nt``, ``wgmma_tn``) the
    backward hands the kernels x, w and dy where they lie: the transpose
    kernel is never launched, dx is dy w^T read with w's (E, D, F) strides
    and dw is x^T dy read with x's (E, C, D) strides, counted by route.  The
    entry points are stood in for by the plain products on the pointers they
    are given (the CPU has no kernel)."""
    x, w, dy = (t.to(torch.bfloat16) for t in _t(*_gmm_inputs(2, 200, 64, 72, seed=9)))
    tensors = {t.data_ptr(): t for t in (x, w, dy)}
    calls = []

    def entry(which):
        def run(a, b, out, E, C, D, F, stream):
            calls.append(which)
            A, B_ = tensors[a], tensors[b]
            # both entry points take (E, C, D, F), whichever product they make
            assert A.shape[:2] == (E, C) and B_.shape[0] == E
            assert tensors[out].shape == ((E, C, D) if which == "dx_wgmma_nt" else (E, D, F))
            got = (torch.einsum("ecf,edf->ecd", A.float(), B_.float()) if which == "dx_wgmma_nt"
                   else torch.einsum("ecd,ecf->edf", A.float(), B_.float()))
            tensors[out].copy_(got.to(torch.bfloat16))
            return 0
        return run

    real_empty = torch.empty

    def empty(*shape, **kw):   # the outputs, found again by their pointers
        t = real_empty(*shape, **{k: v for k, v in kw.items() if k != "device"})
        tensors[t.data_ptr()] = t
        return t

    def refuse(t):
        raise AssertionError("the transpose kernel was launched")

    monkeypatch.setattr(tgmm, "check_operands", lambda *a: None)
    monkeypatch.setattr(tgmm, "stream_handle", lambda dev: None)
    monkeypatch.setattr(tgmm, "_entry", entry)
    monkeypatch.setattr(tgmm, "_transpose", refuse)
    monkeypatch.setattr(tgmm.torch, "empty", empty)
    before = dict(tgmm.BWD_LAUNCHES)
    assert tgmm.bwd_route(torch.bfloat16, 200, 64, 72) == ("wgmma_nt", "wgmma_tn")
    dx, dw = tgmm.moe_gmm_bwd(x, w, dy)
    assert calls == ["dx_wgmma_nt", "dw_wgmma_tn"]
    ex, ew = tref.moe_gmm_bwd_ref(x, w, dy)
    assert torch.equal(dx, ex) and torch.equal(dw, ew)
    assert tgmm.BWD_LAUNCHES == {k: n + (k in ("dx_wgmma_nt", "dw_wgmma_tn"))
                                 for k, n in before.items()}


def test_scan_bwd_routes():
    """The backward routes as pure functions of dtype and shape, at every
    ds (1 .. 16) and hd the forwards take: Mamba on ``ring`` where di and ds
    times the element size are multiples of 16 bytes, else ``ckpt``; RWKV6
    on ``ring`` at every hd.  The previous designs keep their entry points."""
    for ds in range(1, 17):
        for di in (8192, 96, 64, 70, 333):
            for dt, size in ((torch.float32, 4), (torch.bfloat16, 2)):
                aligned = (di * size) % 16 == 0 and (ds * size) % 16 == 0
                assert tmamba.bwd_route(dt, ds, di) == ("ring" if aligned else "ckpt")
    assert tmamba.bwd_route(torch.bfloat16, 16, 8192) == "ring"     # Jamba's shape
    assert tmamba.bwd_route(torch.bfloat16, 12, 8192) == "ckpt"     # 24-byte rows of B_t
    for dt in (torch.float32, torch.bfloat16):
        assert [trwkv.bwd_route(dt, hd) for hd in (16, 32, 64)] == ["ring"] * 3
    for bad in (lambda: tmamba.bwd_route(torch.float32, 17, 64),
                lambda: tmamba.bwd_route(torch.float16, 16, 64),
                lambda: trwkv.bwd_route(torch.float32, 128)):
        with pytest.raises(ValueError):
            bad()
    assert set(tmamba.BWD_LAUNCHES) == {"ring", "ckpt"}
    assert set(trwkv.BWD_LAUNCHES) == {"ring", "rows"}
    for fn, inputs in ((tmamba.mamba_scan_bwd_ckpt, _mamba_inputs(1, 3, 8, 4)),
                       (tmamba.mamba_scan_bwd_ring, _mamba_inputs(1, 3, 8, 4)),
                       (trwkv.rwkv6_scan_bwd_rows, _rwkv_inputs(1, 3, 1, 16)),
                       (trwkv.rwkv6_scan_bwd_ring, _rwkv_inputs(1, 3, 1, 16))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*_t(*inputs))


def test_rwkv6_bwd_shared_memory_fits_two_blocks():
    """The backward's shared memory at each hd: 80 KB at hd 64, so that two
    blocks share an SM within Hopper's 227 KB."""
    assert trwkv.bwd_smem_bytes(64) == 81920
    assert all(2 * trwkv.bwd_smem_bytes(hd) <= trwkv.SMEM_LIMIT for hd in trwkv.HEAD_SIZES)


def test_rwkv6_bwd_ring_shared_memory_and_occupancy():
    """The ring design at each hd, dtype and spacing fits a block's 227 KB;
    at hd 64 one block of 512 threads an SM, 16 warps, at most 128 registers
    a thread; at RWKV6-1.6B's shape 256 blocks, 32 chunks of 16 steps."""
    for hd in trwkv.HEAD_SIZES:
        for itemsize in (4, 2):
            for chunk in trwkv.RING_CHUNKS:
                g = trwkv.ring_geometry(8, 512, 32, hd, itemsize, chunk)
                assert g.smem <= trwkv.SMEM_LIMIT and g.block == hd * hd // 8
    g = trwkv.ring_geometry(8, 512, 32, 64, 4)
    assert g == (8, 512, 256, 32, 176640)
    assert 2 * (g.smem + 1024) > 228 * 1024          # one block an SM
    assert g.block // 32 == 16 and 65536 // g.block == 128


def test_mamba_bwd_ring_shared_memory_and_occupancy():
    """The ring design's shared memory: chunks of 16 one block (8 warps) an
    SM, chunks of 8 two (16 warps) within the SM's 228 KB, each block
    reserving 1 KB."""
    for itemsize in (4, 2):
        one, two = (tmamba.ring_smem_bytes_model(itemsize, c) for c in (16, 8))
        assert one <= tmamba.SMEM_LIMIT < 2 * (one + 1024)
        assert 2 * (two + 1024) <= 228 * 1024
    assert tmamba.ring_smem_bytes_model(4, 8) == 113792


def test_rwkv6_bwd_scratch_agrees_with_the_source():
    """The checkpoints the wrapper allocates for each design are those the
    C entry points document and the models write: ceil(T / 4) for rows,
    ceil(T / chunk) for ring."""
    import pathlib
    import re
    src = (pathlib.Path(trwkv.__file__).parent.parent / "csrc" / "rwkv6_scan.cu").read_text()
    text = re.sub(r"\s*//\s*", " ", src)
    assert "ckpt (B, H, ceil(T / 4), hd, hd)" in text
    assert "ckpt (B, H, ceil(T / ck_steps), hd, hd)" in text
    assert f"constexpr int kChunk = {trwkv.BWD_CHUNK};" in src
    assert trwkv.bwd_scratch_shapes(2, 21, 3, 16, "rows")["ckpt"] == (2, 3, 6, 16, 16)
    for chunk in trwkv.RING_CHUNKS:
        assert trwkv.bwd_scratch_shapes(2, 21, 3, 16, "ring", chunk) == {
            "ckpt": (2, 3, -(-21 // chunk), 16, 16), "du_part": (2, 3, 16)}
    r, k, v, w, u, S0, do, dS = _rwkv_inputs(2, 21, 3, 16)
    *_, ckpt = rwkv_bwd_model(r, k, v, w, u, S0, do, dS)
    assert ckpt.shape == trwkv.bwd_scratch_shapes(2, 21, 3, 16, "rows")["ckpt"]
    with pytest.raises(ValueError):
        trwkv.bwd_scratch_shapes(1, 1, 1, 16, "ring", 8)


# ---------------------------------------------------------------------------
# How far a free-running train step parts from itself: why chip_smoke.py's
# phase 11c holds reduced RWKV6 step by step and the other two families along
# their whole 3-step trajectories, and phase 11e seamless (under its ragged
# enc_mask with a fully masked row) and pixtral (G 4, patch embeddings) too.
@pytest.mark.parametrize("arch,n_layers,sensitive", [
    ("rwkv6-1.6b", 2, True), ("mixtral-8x7b", 2, False), ("jamba-v0.1-52b", 8, False),
    ("seamless-m4t-large-v2", 2, False), ("pixtral-12b", 2, False),
])
def test_trajectory_sensitivity_to_a_weight_nudge(arch, n_layers, sensitive):
    """Three remat AdamW steps of phase 11c's (or 11e's) reduced float32
    model, from its weights and from the same weights times 1 + 1e-6, on the
    same 4 x 64-token batches.  Reduced RWKV6's third grad norm moves by more
    than 11c's 1e-4 (by 2.2e-3 of itself here), so the card's and the CPU's
    last-bit differences alone would part the two runs past it; mixtral's,
    Jamba's, seamless's and pixtral's stay within it."""
    import dataclasses

    from repro_torch.config import get_arch, reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map
    from repro_torch.train import AdamWConfig, DataConfig, SyntheticLM, make_train_step
    from repro_torch.train.optimizer import init_state

    cfg = dataclasses.replace(reduced(get_arch(arch), n_layers=n_layers), dtype="float32")
    if arch == "pixtral-12b":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    p0 = T.init_params(cfg, torch.Generator().manual_seed(0))
    it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4,
                                seed=0)).batches()
    rng = np.random.default_rng(12)

    def model_inputs(b):
        """11e's: stub frames under a ragged enc_mask, or patch embeddings."""
        if cfg.encdec is not None:
            return {**b, "enc_mask": np.arange(150)[None] < np.array([150, 0, 97, 31])[:, None],
                    "enc_embeds": rng.standard_normal((4, 150, cfg.d_model), np.float32)}
        if cfg.frontend is not None:
            return {"labels": b["labels"],
                    "embeds": rng.standard_normal((4, 64, cfg.d_model), np.float32)}
        return b

    batches = [{k: torch.from_numpy(v) for k, v in model_inputs(next(it)).items()}
               for _ in range(3)]
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
                           remat=True)

    def grad_norms(scale):
        params = tree_map(lambda p: (p.detach() * scale).requires_grad_(True), p0)
        state = init_state(params)
        norms = []
        for b in batches:
            params, state, m = step(params, state, b)
            norms.append(float(m["grad_norm"]))
        return norms

    base, nudged = grad_norms(1.0), grad_norms(1.0 + 1e-6)
    moved = [abs(a - b) / a for a, b in zip(base, nudged)]
    assert all(x < 1e-4 for x in moved[:2]), moved
    assert (moved[2] > 1e-4) == sensitive, moved
