"""The flash kernel's backward on the CPU: its plain version
``flash_attention_bwd_ref`` and autograd of the port's plain forward against
``jax.vjp`` of the JAX package's ``flash_attention_ref``, over the flash
sweep of ``tests/test_kernels.py`` and the cases the two CUDA kernels treat
apart (rows that see no key, d 120, a window, S != T), fp32 at the flash
limit of ``tests/test_kernels.py`` (atol = rtol = 3e-5).  Then a model of
the two kernels' tiling in torch (which tiles each block walks, the rows'
statistics handed from the first kernel to the second) against the plain
version, in fp32 for the simt pair and with the wgmma pair's bf16 operands
(P and dS split into a bf16 head and remainder) for bf16, and the
dispatch: ``bwd_route``, the wrapper refuses CPU tensors, and on the CPU
the op keeps its autograd."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)
CASES = [   # B, Hq, Hkv, S, T, d, causal, window
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 96, 96, 64, True, 32),       # SWA + padding
    (2, 2, 2, 64, 192, 32, True, None),    # prefix-cache offset
    (1, 4, 4, 128, 128, 128, False, None), # bidirectional MHA
    (1, 2, 1, 257, 257, 64, True, None),   # odd lengths
    (1, 4, 2, 70, 40, 32, True, None),     # S > T: rows that see no key
    (1, 4, 2, 70, 40, 32, False, 16),      # S > T, not causal, a window
    (1, 4, 2, 150, 150, 120, True, 64),    # d 120 under a window that bites
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes are small: one intra-op thread, so that torch's thread
    pool does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0):
    B, Hq, Hkv, S, T, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, S, d), (B, Hkv, T, d), (B, Hkv, T, d), (B, Hq, S, d))]


def _jax_vjp(q, k, v, dout, causal, window):
    out, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, causal=causal,
                                                                 window=window),
                       *map(jnp.asarray, (q, k, v)))
    return np.array(out), [np.array(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_ref_matches_jax_vjp(case):
    causal, window = case[6:]
    q, k, v, dout = _inputs(case)
    out, expect = _jax_vjp(q, k, v, dout, causal, window)
    got = tref.flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v, out, dout)),
                                       causal=causal, window=window)
    for name, g, e in zip("qkv", got, expect):
        assert g.dtype == torch.float32 and g.shape == e.shape, name
        np.testing.assert_allclose(g.numpy(), e, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_autograd_of_the_plain_forward_matches_jax_vjp(case):
    causal, window = case[6:]
    q, k, v, dout = _inputs(case, seed=1)
    out, expect = _jax_vjp(q, k, v, dout, causal, window)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(o.detach().numpy(), out, **TOL)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(dout))
    for name, g, e in zip("qkv", grads, expect):
        np.testing.assert_allclose(g.numpy(), e, **TOL, err_msg=f"d{name}")


def test_a_row_that_sees_no_key_spreads_dout_over_v():
    """Causal with S > T: the first S - T rows see no key.  Their output is
    the mean of v, so their dq is 0, they give nothing to dk, and each key's
    dv takes 1/T of their dout."""
    case = (1, 2, 1, 40, 24, 32, True, None)
    q, k, v, dout = _inputs(case, seed=2)
    dout[:, :, 16:] = 0.0                    # only the rows with no key
    o = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)))
    dq, dk, dv = tref.flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v)), o,
                                              torch.from_numpy(dout))
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0
    spread = dout[:, :, :16].sum(axis=(1, 2)) / 24
    np.testing.assert_allclose(dv.numpy()[0, 0], np.broadcast_to(spread[0], (24, 32)),
                               **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_ref_rounds_once_to_the_inputs_dtype(dtype):
    q, k, v, dout = (torch.from_numpy(a).to(dtype)
                     for a in _inputs((1, 4, 2, 64, 64, 32, True, None), seed=3))
    o = tref.flash_attention_ref(q, k, v)
    got = tref.flash_attention_bwd_ref(q, k, v, o, dout)
    fp32 = tref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o, dout)))
    for g, e in zip(got, fp32):
        assert g.dtype == dtype
        torch.testing.assert_close(g, e.to(dtype), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# The two kernels' tiling, modelled in torch: each block's loop bounds, the
# first kernel's per-row log-sum-exp and D handed to the second, and the
# rows that see no key, as in csrc/flash_attention.cu (namespace bwd).

TILE = 64


def _allowed(p, kp, causal, window):
    ok = torch.ones(p.shape[0], kp.shape[1], dtype=torch.bool)
    if causal:
        ok &= kp <= p
    if window is not None:
        ok &= kp > p - window
    return ok


def _key_tiles(q0, nq, off, T, causal, window):
    """The key tiles a 64-query tile sees: from the window's start of its
    first row that has a key to the causal bound of its last row."""
    lo, hi = 0, T - 1
    if causal:
        hi = min(hi, q0 + nq - 1 + off)
    if window is not None:
        first = max(q0 + off, 0) if causal else q0 + off
        lo = max(0, first - window + 1)
    return range((lo // TILE) * TILE, hi + 1, TILE)


def _query_tiles(t0, nt, off, S, causal, window):
    """The query tiles that see a 64-key tile: from the first row whose
    causal bound reaches it (row 0 when some rows see no key) to the last
    whose window still does."""
    i_lo = max(0, t0 - off) if causal else 0
    if causal and off < 0:
        i_lo = 0
    i_hi = S - 1 if window is None else min(S - 1, t0 + nt - 2 + window - off)
    return range((i_lo // TILE) * TILE, i_hi + 1, TILE)


def _dq_model(q, k, v, o, dout, causal, window):
    """dq, lse and D from the dq kernel's walk over ``_key_tiles``."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, off, scale = Hq // Hkv, T - S, d ** -0.5
    dq = torch.zeros_like(q)
    lse = torch.zeros(B, Hq, S)
    delta = (dout * o).sum(-1)
    for b in range(B):
        for h in range(Hq):
            kk, vv = k[b, h // G], v[b, h // G]
            for q0 in range(0, S, TILE):
                nq = min(TILE, S - q0)
                p = torch.arange(q0, q0 + nq)[:, None] + off
                tiles = _key_tiles(q0, nq, off, T, causal, window)
                qs = q[b, h, q0:q0 + nq] * scale
                m = torch.full((nq,), -1e30)
                l = torch.zeros(nq)
                for t0 in tiles:
                    kp = torch.arange(t0, min(t0 + TILE, T))[None]
                    s = torch.where(_allowed(p, kp, causal, window),
                                    qs @ kk[t0:t0 + TILE].T, -1e30)
                    m_new = torch.maximum(m, s.max(-1).values)
                    l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(-1)
                    m = m_new
                row_lse = m + torch.log(l)
                lse[b, h, q0:q0 + nq] = row_lse
                acc = torch.zeros(nq, d)
                for t0 in tiles:
                    kp = torch.arange(t0, min(t0 + TILE, T))[None]
                    ok = _allowed(p, kp, causal, window)
                    s = qs @ kk[t0:t0 + TILE].T
                    dp = dout[b, h, q0:q0 + nq] @ vv[t0:t0 + TILE].T
                    ds = torch.where(ok, torch.exp(s - row_lse[:, None])
                                     * (dp - delta[b, h, q0:q0 + nq, None]), 0.0)
                    acc += ds @ kk[t0:t0 + TILE]
                dq[b, h, q0:q0 + nq] = acc * scale
    return dq, lse, delta


def _dkv_model(q, k, v, dout, lse, delta, causal, window):
    """dk and dv from the dkv kernel's walk: a 64-key tile sums over the G
    query heads and its ``_query_tiles``."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, off, scale = Hq // Hkv, T - S, d ** -0.5
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(B):
        for hk in range(Hkv):
            for t0 in range(0, T, TILE):
                nt = min(TILE, T - t0)
                kp = torch.arange(t0, t0 + nt)[None]
                for g in range(G):
                    h = hk * G + g
                    for q0 in _query_tiles(t0, nt, off, S, causal, window):
                        nq = min(TILE, S - q0)
                        p = torch.arange(q0, q0 + nq)[:, None] + off
                        qs = q[b, h, q0:q0 + nq] * scale
                        do = dout[b, h, q0:q0 + nq]
                        s = qs @ k[b, hk, t0:t0 + nt].T
                        dp = do @ v[b, hk, t0:t0 + nt].T
                        ok = _allowed(p, kp, causal, window)
                        pw = torch.where(ok, torch.exp(s - lse[b, h, q0:q0 + nq, None]), 0.0)
                        ds = pw * (dp - delta[b, h, q0:q0 + nq, None])
                        if causal:
                            empty = (p < 0).expand_as(pw)
                            pw = torch.where(empty, 1.0 / T, pw)
                            ds = torch.where(empty, 0.0, ds)
                        dv[b, hk, t0:t0 + nt] += pw.T @ do
                        dk[b, hk, t0:t0 + nt] += ds.T @ qs
    return dk, dv


@pytest.mark.parametrize("case", CASES + [(1, 2, 1, 200, 130, 32, True, 50),
                                          (1, 2, 1, 130, 200, 32, False, 40)], ids=str)
def test_the_kernels_tiling_matches_the_plain_version(case):
    causal, window = case[6:]
    q, k, v, dout = map(torch.from_numpy, _inputs(case, seed=4))
    o = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    dq, lse, delta = _dq_model(q, k, v, o, dout, causal, window)
    dk, dv = _dkv_model(q, k, v, dout, lse, delta, causal, window)
    for name, g, e in zip("qkv", (dq, dk, dv),
                          tref.flash_attention_bwd_ref(q, k, v, o, dout, causal=causal,
                                                       window=window)):
        torch.testing.assert_close(g, e, **TOL, msg=f"d{name}")


# ---------------------------------------------------------------------------
# The wgmma pair (csrc/flash_attention.cu, namespace wgb) for bf16: the same
# walks, tensor-core operands in bf16 and sums in fp32.  Q, K, V and dO are
# the bf16 inputs as given; P and dS are split into a bf16 head and the bf16
# remainder, both multiplied; lse is in log2 units, as the kernels keep it.

BF16_TOL = dict(atol=1e-3, rtol=1e-2)     # one bf16 ulp, the card's limit
LOG2E = 1.4426950408889634
WGMMA_CASES = CASES + [
    (1, 2, 1, 512, 512, 120, True, 128),  # a window that bites, d 120
    (1, 2, 1, 512, 512, 64, True, 128),   # and d 64
    (1, 2, 1, 512, 512, 128, True, None), # qwen3-1.7b's head width and length
]


def _bf16_parts(x, split):
    """x as the A operands of a product: its bf16 head and bf16 remainder
    (both multiplied), or its bf16 copy alone."""
    head = x.to(torch.bfloat16).float()
    return [head, (x - head).to(torch.bfloat16).float()] if split else [head]


def _wgmma_dq_model(q, k, v, o, dout, causal, window, split_ds=True):
    """dq, lse (log2 units) and D from the wgmma dq kernel's walk: pass 1
    the rows' max and sum over ``_key_tiles``, pass 2 dS and dq += dS K."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, off, scale = Hq // Hkv, T - S, d ** -0.5
    scale_log2 = scale * LOG2E
    q, k, v, o, dout = (t.float() for t in (q, k, v, o, dout))
    dq = torch.zeros_like(q)
    lse = torch.zeros(B, Hq, S)
    delta = (dout * o).sum(-1)
    for b in range(B):
        for h in range(Hq):
            kk, vv = k[b, h // G], v[b, h // G]
            for q0 in range(0, S, TILE):
                nq = min(TILE, S - q0)
                p = torch.arange(q0, q0 + nq)[:, None] + off
                tiles = _key_tiles(q0, nq, off, T, causal, window)
                qs, dl = q[b, h, q0:q0 + nq], delta[b, h, q0:q0 + nq, None]
                m = torch.full((nq,), -1e30)
                l = torch.zeros(nq)
                for t0 in tiles:
                    kp = torch.arange(t0, min(t0 + TILE, T))[None]
                    s = torch.where(_allowed(p, kp, causal, window),
                                    (qs @ kk[t0:t0 + TILE].T) * scale_log2, -torch.inf)
                    m_new = torch.maximum(m, s.max(-1).values)
                    l = l * torch.exp2(m - m_new) + torch.exp2(s - m_new[:, None]).sum(-1)
                    m = m_new
                row_lse = m + torch.log2(l)   # -inf for a row with no key
                lse[b, h, q0:q0 + nq] = row_lse
                acc = torch.zeros(nq, d)
                for t0 in tiles:
                    kp = torch.arange(t0, min(t0 + TILE, T))[None]
                    s = qs @ kk[t0:t0 + TILE].T
                    dp = dout[b, h, q0:q0 + nq] @ vv[t0:t0 + TILE].T
                    pw = torch.where(_allowed(p, kp, causal, window),
                                     torch.exp2(s * scale_log2 - row_lse[:, None]), 0.0)
                    for part in _bf16_parts(pw * (dp - dl), split_ds):
                        acc += part @ kk[t0:t0 + TILE]
                dq[b, h, q0:q0 + nq] = acc * scale
    return dq, lse, delta


def _wgmma_dkv_model(q, k, v, dout, lse, delta, causal, window, split_p=True, split_ds=True):
    """dk and dv from the wgmma dkv kernel's walk: S^T = K Q^T and
    dP^T = V dO^T with keys as rows, lse and D along the columns."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, off, scale = Hq // Hkv, T - S, d ** -0.5
    scale_log2 = scale * LOG2E
    q, k, v, dout = (t.float() for t in (q, k, v, dout))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(B):
        for hk in range(Hkv):
            for t0 in range(0, T, TILE):
                nt = min(TILE, T - t0)
                kp = torch.arange(t0, t0 + nt)[:, None]
                for g in range(G):
                    h = hk * G + g
                    for q0 in _query_tiles(t0, nt, off, S, causal, window):
                        nq = min(TILE, S - q0)
                        p = torch.arange(q0, q0 + nq)[None] + off
                        qs, do = q[b, h, q0:q0 + nq], dout[b, h, q0:q0 + nq]
                        st = k[b, hk, t0:t0 + nt] @ qs.T
                        dpt = v[b, hk, t0:t0 + nt] @ do.T
                        ok = _allowed(p.T, kp.T, causal, window).T
                        pw = torch.where(ok, torch.exp2(st * scale_log2
                                                        - lse[b, h, None, q0:q0 + nq]), 0.0)
                        ds = pw * (dpt - delta[b, h, None, q0:q0 + nq])
                        if causal:
                            empty = (p < 0).expand_as(pw)
                            pw = torch.where(empty, 1.0 / T, pw)
                            ds = torch.where(empty, 0.0, ds)
                        for part in _bf16_parts(pw, split_p):
                            dv[b, hk, t0:t0 + nt] += part @ do
                        for part in _bf16_parts(ds, split_ds):
                            dk[b, hk, t0:t0 + nt] += part @ qs
    return dk * scale, dv


def _wgmma_pair(case, seed, split_p=True, split_ds=True):
    """The wgmma pair's model and the plain version on bf16 inputs: the
    model's (dq, dk, dv) rounded to bf16, and the plain version's."""
    causal, window = case[6:]
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(case, seed))
    o = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    dq, lse, delta = _wgmma_dq_model(q, k, v, o, dout, causal, window, split_ds)
    dk, dv = _wgmma_dkv_model(q, k, v, dout, lse, delta, causal, window, split_p, split_ds)
    got = [g.to(torch.bfloat16) for g in (dq, dk, dv)]
    return got, tref.flash_attention_bwd_ref(q, k, v, o, dout, causal=causal, window=window)


def _excess(got, expect):
    """The largest |got - expect| over BF16_TOL's allowance."""
    g, e = got.float(), expect.float()
    return float(((g - e).abs() / (BF16_TOL["atol"] + BF16_TOL["rtol"] * e.abs())).max())


@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_the_wgmma_pairs_arithmetic_matches_the_plain_version(case):
    for name, g, e in zip("qkv", *_wgmma_pair(case, seed=5)):
        assert g.dtype == e.dtype == torch.bfloat16
        torch.testing.assert_close(g, e, **BF16_TOL, msg=f"d{name}")


@pytest.mark.parametrize("single", ["P", "dS"])
def test_a_single_bf16_copy_of_p_or_ds_errs_past_the_limit(single):
    """Why the kernels split P and dS into a bf16 head and remainder: with
    one bf16 copy of P, dv errs past one ulp; with one of dS, dq and dk."""
    case = (2, 4, 2, 128, 128, 64, True, None)
    (dq, dk, dv), expect = _wgmma_pair(case, seed=4, split_p=single != "P",
                                       split_ds=single != "dS")
    if single == "P":
        assert _excess(dv, expect[2]) > 2
        assert max(_excess(dq, expect[0]), _excess(dk, expect[1])) <= 1
    else:
        assert min(_excess(dq, expect[0]), _excess(dk, expect[1])) > 1
        assert _excess(dv, expect[2]) <= 1


def test_the_wgmma_pair_keeps_a_row_with_no_key_out_of_dq_and_dk():
    """Causal with S > T: the rows that see no key get lse = -inf from the
    dq kernel, dq = 0, and the dkv kernel spreads their dO over dv at 1/T."""
    case = (1, 2, 1, 40, 24, 32, True, None)
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(case, seed=2))
    dout[:, :, 16:] = 0                      # only the rows with no key
    o = tref.flash_attention_ref(q, k, v)
    dq, lse, delta = _wgmma_dq_model(q, k, v, o, dout, True, None)
    assert bool(torch.isneginf(lse[:, :, :16]).all()) and float(dq.abs().max()) == 0.0
    dk, dv = _wgmma_dkv_model(q, k, v, dout, lse, delta, True, None)
    assert float(dk.abs().max()) == 0.0
    spread = dout[:, :, :16].float().sum(dim=(1, 2)) / 24
    torch.testing.assert_close(dv[0, 0], spread[0].expand(24, 32), **BF16_TOL)


# ---------------------------------------------------------------------------
# Dispatch

def test_bwd_route_sends_bf16_to_wgmma_and_the_rest_to_simt():
    assert tflash.bwd_route(torch.bfloat16) == "wgmma"
    for dt in (torch.float32, torch.float16, torch.float64):
        assert tflash.bwd_route(dt) == "simt"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["flash_attention_bwd", "flash_attention_bwd_simt"])
def test_the_backward_wrapper_refuses_cpu_tensors(fn, dtype):
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in _inputs(CASES[0]))
    before = dict(tflash.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(tflash, fn)(q, k, v, q, dout)
    with pytest.raises(ValueError, match="shaped as q"):
        getattr(tflash, fn)(q, k, v, q[:, :, :5], dout)
    assert tflash.BWD_LAUNCHES == before


def test_on_the_cpu_the_op_keeps_its_autograd_and_counts_nothing():
    ops.reset_launches()
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True) for a in _inputs(CASES[1]))
    out = ops.flash_attention(q, k, v, causal=True, window=32)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["flash_attention_bwd"] == 0
    assert ops.ROUTE_LAUNCHES["flash_attention_bwd"] == {
        "bwd_dq": 0, "bwd_dkv": 0, "bwd_dq_wgmma": 0, "bwd_dkv_wgmma": 0, "bwd_dq_masked": 0,
        "bwd_dkv_masked": 0, "bwd_dq_wgmma_masked": 0, "bwd_dkv_wgmma_masked": 0,
        "bwd_dq_wgmma_live": 0, "bwd_dkv_wgmma_live": 0}


def test_refuse_grad_names_the_item_and_spares_inference():
    """What the ops without a backward kernel (decode attention and AES,
    which no training path reaches) raise on the card under a gradient: the
    check itself, which needs no card."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no training path reaches this op"):
        ops._refuse_grad("decode_attention", x, None)
    with torch.no_grad():
        ops._refuse_grad("decode_attention", x)
    ops._refuse_grad("decode_attention", x.detach(), None)
