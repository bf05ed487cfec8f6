"""The backward of the flash kernel's key-masked routes on the CPU.

The plain version ``flash_attention_bwd_ref(key_valid=...)`` against torch
autograd of ``flash_attention_ref(key_valid=...)`` and against ``jax.vjp``
of the JAX package's ``gqa_attend`` under the same (B, S, T) mask, fp32 at
the flash limit of ``tests/test_kernels.py`` (atol = rtol = 3e-5), over
ragged masks with a fully masked row, dead tiles, rows whose valid keys lie
in their causal future or before their window, G 1, 2 and 4, d 32 to 128
and T = 1500.  The empty-row rule: a row with no allowed valid key outputs
the mean of v, so its dq is 0, it gives nothing to dk, and it adds dO / T to
dv of every key of its batch row.

Then a model of the masked designs of ``csrc/flash_attention.cu``: the
walks in numpy (which key tiles each dq block visits: the simt pair from the
row's first valid key to its last within its rows' union, the wgmma live
pair its segment of the batch row's list of live tiles, built once a call;
which dkv blocks walk their query tiles, which write zeros, and which carry
the 1/T term of the empty rows), and the arithmetic in torch over those
walks (lse = -inf for a row with no allowed valid key: the simt pair's dq
kernel computes it and hands it to the dkv kernel, the live pair takes it
from the masked wgmma forward's walk; the live pair in log2 units with P and
dS split into a bf16 head and remainder, and the empty rows' term taken from
the list's count where neither causal nor a window can empty a row), held
against the plain gradients: the simt pair in fp32 at 3e-5, the live pair's
arithmetic in fp32 at 3e-5 and on bf16 inputs at one bf16 ulp (atol 1e-3,
rtol 1e-2); the forward's lse against ``flash_attention_lse_ref``.  Then
the dispatch: ``bwd_route`` under a mask, the wrappers refuse CPU tensors,
and on the CPU the op keeps the plain autograd and counts no launch.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TILE = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634
F32_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=1e-3, rtol=1e-2)
PHASE3_LENGTHS = (1500, 0, 1306, 1209, 1112, 1015, 918, 821)   # chip_smoke.py 11f's mask

CASES = {   # B, Hq, Hkv, S, T, d, causal, window, mask
    "cross-T1500": (8, 1, 1, 40, 1500, 64, False, None, "phase3"),
    "ragged-G1-d120": (3, 2, 2, 70, 129, 120, False, None, "ragged"),
    "ragged-G4-d128": (2, 8, 2, 96, 200, 128, False, None, "ragged"),
    "holes-G2-d32": (4, 4, 2, 100, 700, 32, False, None, "holes"),
    "causal-future": (3, 4, 2, 200, 200, 64, True, None, "future"),
    "causal-window-S<T": (2, 4, 2, 160, 300, 120, True, 96, "future"),
    "window-holes": (2, 2, 1, 130, 700, 64, False, 200, "holes"),
    "causal-S>T": (2, 4, 2, 90, 60, 32, True, None, "ragged"),
    "causal-window-holes": (2, 2, 2, 300, 300, 32, True, 64, "holes"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes are small: one intra-op thread, so that torch's thread
    pool does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mask(kind, B, T, rng):
    """(B, T) bool key masks, a row each."""
    t = np.arange(T)
    rows = []
    for b in range(B):
        if kind == "phase3":        # ragged lengths, row 1 fully masked
            row = t < PHASE3_LENGTHS[b]
        elif kind == "ragged":      # prefixes: all, none, tile edges
            row = t < (T, 0, 64, 65)[b % 4]
        elif kind == "holes":       # dead tiles mid-row; keys only in the last tile
            if b % 2 == 0:
                row = rng.random(T) < 0.7
                for _ in range(2):
                    a = rng.integers(1, max(2, T // TILE - 2)) * TILE
                    row[a:a + TILE * int(rng.integers(1, 4))] = False
            else:
                row = t >= (T - 1) // TILE * TILE + 3
        else:                       # "future": keys past the early rows, or only early keys
            row = t >= 40 + 30 * b if b % 2 == 0 else t < 20 + 30 * b
        rows.append(row)
    return np.stack(rows)


def _inputs(name, seed=0):
    """q, k, v, dout (fp32 numpy) and the mask of case ``name``."""
    B, Hq, Hkv, S, T, d, causal, window, kind = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in ((B, Hq, S, d), (B, Hkv, T, d), (B, Hkv, T, d), (B, Hq, S, d)))
    return q, k, v, dout, _mask(kind, B, T, rng), causal, window


def _full_mask(valid, S, causal, window):
    """(B, S, T) bool: the pairs a query may see under the key mask."""
    T = valid.shape[1]
    return tref._attn_mask(S, T, causal, window, "cpu").numpy()[None] & valid[:, None, :]


# ---------------------------------------------------------------------------
# The plain version against autograd and JAX


@pytest.mark.parametrize("name", CASES)
def test_masked_bwd_ref_matches_autograd_of_the_plain_forward(name):
    q, k, v, dout, valid, causal, window = _inputs(name)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    kw = dict(causal=causal, window=window, key_valid=torch.from_numpy(valid))
    o = tref.flash_attention_ref(tq, tk, tv, **kw)
    expect = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(dout))
    got = tref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), o.detach(),
                                       torch.from_numpy(dout), **kw)
    for n, g, e in zip("qkv", got, expect):
        assert g.dtype == torch.float32 and g.shape == e.shape
        torch.testing.assert_close(g, e, **F32_TOL, msg=f"d{n}")


@pytest.mark.parametrize("name", CASES)
def test_masked_bwd_ref_matches_jax_vjp_of_gqa_attend(name):
    """``jax.vjp`` of ``gqa_attend`` (the JAX model's masked attention, in its
    (B, S, H, d) layout) under the (B, S, T) mask of the key mask and the
    causal and window masks, at the flash limit of tests/test_kernels.py."""
    q, k, v, dout, valid, causal, window = _inputs(name, seed=1)
    mask = jnp.asarray(_full_mask(valid, q.shape[2], causal, window))
    swap = lambda a: jnp.asarray(np.swapaxes(a, 1, 2))   # noqa: E731
    out, vjp = jax.vjp(lambda a, b, c: jattn.gqa_attend(a, b, c, mask),
                       swap(q), swap(k), swap(v))
    expect = [np.swapaxes(np.array(g), 1, 2) for g in vjp(swap(dout))]
    o = torch.from_numpy(np.swapaxes(np.array(out), 1, 2).copy())
    got = tref.flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v)), o,
                                       torch.from_numpy(dout), causal=causal, window=window,
                                       key_valid=torch.from_numpy(valid))
    for n, g, e in zip("qkv", got, expect):
        np.testing.assert_allclose(g.numpy(), e, **F32_TOL, err_msg=f"d{n}")


def test_a_fully_masked_row_spreads_dout_over_every_key():
    """Batch row 1 of the phase-3 mask has no valid key: its output is the
    mean of v, so its dq is 0, its dk is 0, and each of its 1500 keys' dv
    is the sum of its rows' dO over T, whatever tile the key sits in."""
    q, k, v, dout, valid, causal, window = _inputs("cross-T1500", seed=2)
    assert not valid[1].any() and valid[0].all()
    kw = dict(causal=False, key_valid=torch.from_numpy(valid))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    o = tref.flash_attention_ref(tq, tk, tv, **kw)
    torch.testing.assert_close(o[1], tv[1].mean(1, keepdim=True).expand(1, 40, 64), **F32_TOL)
    dq, dk, dv = tref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, **kw)
    assert float(dq[1].abs().max()) == 0.0 and float(dk[1].abs().max()) == 0.0
    spread = tdo[1].sum(dim=1, keepdim=True) / 1500
    torch.testing.assert_close(dv[1], spread.expand(1, 1500, 64), **F32_TOL)
    # the rows of the other batch rows keep their keys' gradients to themselves
    assert float(dk[2, :, 1306:].abs().max()) == 0.0
    assert float(dv[2, :, 1306:].abs().max()) == 0.0


def test_a_row_whose_valid_keys_lie_in_its_causal_future_is_empty_too():
    """Causal under a key mask: a row sees no allowed valid key when its
    valid keys all lie past its position; it takes the empty-row rule while
    a later row of the same batch row, which sees them, does not."""
    T = S = 64
    valid = torch.arange(T)[None] >= 40
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for s in ((1, 2, S, 32), (1, 1, T, 32), (1, 1, T, 32), (1, 2, S, 32)))
    o = tref.flash_attention_ref(q, k, v, causal=True, key_valid=valid)
    dq, dk, dv = tref.flash_attention_bwd_ref(q, k, v, o, dout, causal=True, key_valid=valid)
    # (row 40 sees key 40 alone: P = 1, so its dS is 0 but for rounding)
    assert float(dq[:, :, :40].abs().max()) == 0.0
    assert float(dq[:, :, 41:].abs().amax(-1).min()) > 0
    only_empty = tref.flash_attention_bwd_ref(
        q, k, v, o, torch.where(torch.arange(S)[:, None] < 40, dout, 0.0), causal=True,
        key_valid=valid)
    spread = dout[0, :, :40].sum(dim=(0, 1)) / T
    torch.testing.assert_close(only_empty[2][0, 0], spread.expand(T, 32), **F32_TOL)
    assert float(only_empty[1].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# The walks of the two masked designs, in numpy


def tile_word(row, t0):
    """Bit c is key t0 + c; 0 at or past T (km::tile_word)."""
    return sum(1 << c for c, ok in enumerate(row[t0:t0 + TILE].tolist()) if ok)


def dq_union(q0, nq, off, T, causal, window):
    """The closed form both dq kernels start from: the union of the allowed
    key ranges of the query tile's rows."""
    lo, hi = 0, T - 1
    if causal:
        hi = min(hi, q0 + nq - 1 + off)
    if window is not None:
        first = max(q0 + off, 0) if causal else q0 + off
        lo = max(0, first - window + 1)
    return lo, hi


def simt_dq_walk(row, q0, nq, off, causal, window):
    """The key tiles a simt masked dq block walks: the union cut to the
    batch row's first and last valid key (km::scan's fv, lv)."""
    T = len(row)
    lo, hi = dq_union(q0, nq, off, T, causal, window)
    keys = np.flatnonzero(row)
    if len(keys):
        lo, hi = max(lo, int(keys[0])), min(hi, int(keys[-1]))
    else:
        lo, hi = max(lo, T), -1
    return list(range(lo // TILE * TILE, hi + 1, TILE))


def live_tiles(row):
    """km::live_tiles_kernel for one batch row: each tile's valid word, the
    live tiles before each tile (and all of them last), the live tiles."""
    n_kt = -(-len(row) // TILE)
    words = [tile_word(row, i * TILE) for i in range(n_kt)]
    live = [i for i, w in enumerate(words) if w]
    prefix = [sum(1 for w in words[:i] if w) for i in range(n_kt + 1)]
    return words, live, prefix


def wgmma_dq_walk(row, q0, nq, off, causal, window):
    """The (t0, word) tiles a live-pair dq block walks: its segment of the
    batch row's list, prefix[lo] .. prefix[hi + 1] for the union of its
    rows' ranges (the live tiles of the union, each once)."""
    lo, hi = dq_union(q0, nq, off, len(row), causal, window)
    if hi < lo // TILE * TILE:
        return []
    words, live, prefix = live_tiles(row)
    return [(t * TILE, words[t]) for t in live[prefix[lo // TILE]:prefix[hi // TILE + 1]]]


FWD_TILE = 128   # queries a block of the wgmma forward


def fwd_walk(row, q0, nq, off, causal, window):
    """The key tiles a masked wgmma forward block (FWD_TILE queries) walks:
    the live tiles of its rows' union, or every tile of [0, T) when one of
    its rows has no allowed valid key (that row then averages v over T)."""
    T = len(row)
    allowed = _full_mask(row[None], T - off, causal, window)[0, q0:q0 + nq]
    if not allowed.any(-1).all():
        return list(range(0, T, TILE))
    lo, hi = 0, T - 1
    p_first, p_last = q0 + off, q0 + nq - 1 + off
    if not (causal and p_first < 0):
        if causal:
            hi = min(hi, p_last)
        if window is not None:
            lo = max(0, p_first - window + 1)
    return [t0 for t0 in range(lo // TILE * TILE, hi + 1, TILE) if tile_word(row, t0)]


def fwd_lse_model(q, k, valid, causal, window):
    """The lse the masked wgmma forward writes for the backward: over its
    walk, a masked score is NEG_INF and a key past T -inf, the row's max and
    sum run online in log2 units, and a row whose max stayed NEG_INF (every
    score it met was masked) gets -inf."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, off, unit = Hq // Hkv, T - S, d ** -0.5 * LOG2E
    q, k = q.float(), k.float()
    lse = torch.zeros(B, Hq, S)
    for b in range(B):
        row = valid[b].numpy()
        for q0 in range(0, S, FWD_TILE):
            nq = min(FWD_TILE, S - q0)
            p = torch.arange(q0, q0 + nq)[:, None] + off
            walk = fwd_walk(row, q0, nq, off, causal, window)
            for h in range(Hq):
                m, l = torch.full((nq,), NEG_INF), torch.zeros(nq)
                for t0 in walk:
                    nt = min(TILE, T - t0)
                    kp = torch.arange(t0, t0 + nt)[None]
                    ok = _allowed(p, kp, causal, window) & valid[b, t0:t0 + nt][None]
                    s = torch.where(ok, (q[b, h, q0:q0 + nq] @ k[b, h // G, t0:t0 + nt].T) * unit,
                                    NEG_INF)
                    m_new = torch.maximum(m, s.max(-1).values)
                    l = l * torch.exp2(m - m_new) + torch.exp2(s - m_new[:, None]).sum(-1)
                    m = m_new
                lse[b, h, q0:q0 + nq] = torch.where(m == NEG_INF, -torch.inf, m + torch.log2(l))
    return lse


def dkv_walk(row, t0, off, S, causal, window):
    """The query tiles a masked dkv block walks: none for a key tile with no
    valid key, else those whose rows can see the tile (no special case for
    rows at negative causal positions: the empty-row term carries them)."""
    T = len(row)
    if not tile_word(row, t0):
        return []
    nt = min(TILE, T - t0)
    i_lo = max(0, t0 - off) if causal else 0
    i_hi = S - 1 if window is None else min(S - 1, t0 + nt - 2 + window - off)
    return list(range(i_lo // TILE * TILE, i_hi + 1, TILE))


def dkv_blocks(row, S, causal, window):
    """Each dkv block of a batch row: ``walk`` (it walks query tiles),
    ``zeros`` (it walks none and has no empty row to carry: it writes 0),
    ``term`` (it walks none but carries the empty rows' dO / T) or
    ``walk+term`` (both)."""
    T = len(row)
    has_empty = not bool(_full_mask(row[None], S, causal, window)[0].any(-1).all())
    out = []
    for t0 in range(0, T, TILE):
        walks = bool(dkv_walk(row, t0, T - S, S, causal, window))
        out.append("+".join(["walk"] * walks + ["term"] * has_empty) or "zeros")
    return out


# ---------------------------------------------------------------------------
# The arithmetic over those walks, in torch


def _allowed(p, kp, causal, window):
    ok = torch.ones(p.shape[0], kp.shape[1], dtype=torch.bool)
    if causal:
        ok &= kp <= p
    if window is not None:
        ok &= kp > p - window
    return ok


def _bf16_parts(x, split):
    head = x.to(torch.bfloat16).float()
    return [head, (x - head).to(torch.bfloat16).float()] if split else [x]


def dq_model(q, k, v, o, dout, valid, causal, window, wgmma, lse=None, split=None):
    """dq, lse and D from each dq block's walk.  The simt pair: pass 1 a
    row's max and sum over its allowed valid keys (a disallowed pair scores
    -inf, so a row with none keeps a sum of 0 and lse = -inf), pass 2 dS and
    dq += dS K.  ``wgmma`` (the live pair): ``lse`` is the forward's (in
    log2 units), so only the second pass, over the live-tile walk; dS split
    into bf16 parts unless ``split`` is False."""
    split = wgmma if split is None else split
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, off, scale = Hq // Hkv, T - S, d ** -0.5
    unit = scale * LOG2E if wgmma else scale
    exp = torch.exp2 if wgmma else torch.exp
    log = torch.log2 if wgmma else torch.log
    fwd_lse = lse
    q, k, v, o, dout = (t.float() for t in (q, k, v, o, dout))
    dq = torch.zeros_like(q)
    lse = torch.zeros(B, Hq, S)
    delta = (dout * o).sum(-1)
    for b in range(B):
        row = valid[b].numpy()
        for q0 in range(0, S, TILE):
            nq = min(TILE, S - q0)
            walk = ([t0 for t0, _ in wgmma_dq_walk(row, q0, nq, off, causal, window)]
                    if wgmma else simt_dq_walk(row, q0, nq, off, causal, window))
            p = torch.arange(q0, q0 + nq)[:, None] + off
            for h in range(Hq):
                kk, vv = k[b, h // G], v[b, h // G]
                qs, dl = q[b, h, q0:q0 + nq], delta[b, h, q0:q0 + nq, None]
                m, l = torch.full((nq,), NEG_INF), torch.zeros(nq)
                oks = []
                for t0 in walk:
                    nt = min(TILE, T - t0)
                    kp = torch.arange(t0, t0 + nt)[None]
                    ok = _allowed(p, kp, causal, window) & valid[b, t0:t0 + nt][None]
                    oks.append(ok)
                    if wgmma:   # no first pass: lse is the forward's
                        continue
                    s = torch.where(ok, (qs @ kk[t0:t0 + nt].T) * unit, -torch.inf)
                    m_new = torch.maximum(m, s.max(-1).values)
                    l = l * exp(m - m_new) + exp(s - m_new[:, None]).sum(-1)
                    m = m_new
                row_lse = fwd_lse[b, h, q0:q0 + nq] if wgmma else m + log(l)
                lse[b, h, q0:q0 + nq] = row_lse
                acc = torch.zeros(nq, d)
                for t0, ok in zip(walk, oks):
                    nt = min(TILE, T - t0)
                    s = (qs @ kk[t0:t0 + nt].T) * unit
                    dp = dout[b, h, q0:q0 + nq] @ vv[t0:t0 + nt].T
                    ds = torch.where(ok, exp(s - row_lse[:, None]) * (dp - dl), 0.0)
                    for part in _bf16_parts(ds, split):
                        acc += part @ kk[t0:t0 + nt]
                dq[b, h, q0:q0 + nq] = acc * scale
    return dq, lse, delta


def dkv_model(q, k, v, dout, lse, delta, valid, causal, window, wgmma, split=None):
    """dk and dv from each dkv block: dv takes the empty rows' term (dO / T
    summed over the group's rows whose lse is -inf; the live pair, where
    neither causal nor a window can empty a row, over every row when the
    list has no live tile and none otherwise, lse unread), and the block
    walks ``dkv_walk``'s query tiles, P = exp(s - lse) and dS on the allowed
    valid pairs only.  ``wgmma``: log2 units, P and dS split unless
    ``split`` is False."""
    split = wgmma if split is None else split
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, off, scale = Hq // Hkv, T - S, d ** -0.5
    unit = scale * LOG2E if wgmma else scale
    exp = torch.exp2 if wgmma else torch.exp
    q, k, v, dout = (t.float() for t in (q, k, v, dout))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(B):
        row = valid[b].numpy()
        for hk in range(Hkv):
            heads = slice(hk * G, hk * G + G)
            empty = torch.isneginf(lse[b, heads])
            if wgmma and not causal and window is None:   # from the list's count
                empty = torch.full_like(empty, not live_tiles(row)[1])
            term = torch.where(empty[..., None], dout[b, heads], 0.0).sum(dim=(0, 1)) / T
            for t0 in range(0, T, TILE):
                nt = min(TILE, T - t0)
                kp = torch.arange(t0, t0 + nt)[None]
                dv[b, hk, t0:t0 + nt] = term
                for g in range(G):
                    h = hk * G + g
                    for q0 in dkv_walk(row, t0, off, S, causal, window):
                        nq = min(TILE, S - q0)
                        p = torch.arange(q0, q0 + nq)[:, None] + off
                        qs, do = q[b, h, q0:q0 + nq], dout[b, h, q0:q0 + nq]
                        ok = _allowed(p, kp, causal, window) & valid[b, t0:t0 + nt][None]
                        s = (qs @ k[b, hk, t0:t0 + nt].T) * unit
                        dp = do @ v[b, hk, t0:t0 + nt].T
                        pw = torch.where(ok, exp(s - lse[b, h, q0:q0 + nq, None]), 0.0)
                        ds = pw * (dp - delta[b, h, q0:q0 + nq, None])
                        for part in _bf16_parts(pw.T, split):
                            dv[b, hk, t0:t0 + nt] += part @ do
                        for part in _bf16_parts(ds.T, split):
                            dk[b, hk, t0:t0 + nt] += part @ qs
    return dk * scale, dv


def _model_pair(name, wgmma, seed, dt=None):
    """The modelled pair's gradients (the simt pair, or with ``wgmma`` the
    live pair from the forward model's lse) on inputs in ``dt`` (fp32 for
    simt, bf16 for the live pair unless given; in fp32 the live pair's
    arithmetic runs unsplit), the plain ones, the lse handed to the dkv
    kernel and the mask."""
    q, k, v, dout, valid, causal, window = _inputs(name, seed)
    dt = dt or (torch.bfloat16 if wgmma else torch.float32)
    split = wgmma and dt == torch.bfloat16
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dt) for a in (q, k, v, dout))
    tvalid = torch.from_numpy(valid)
    kw = dict(causal=causal, window=window, key_valid=tvalid)
    o = tref.flash_attention_ref(tq, tk, tv, **kw)
    fwd_lse = fwd_lse_model(tq, tk, tvalid, causal, window) if wgmma else None
    dq, lse, delta = dq_model(tq, tk, tv, o, tdo, tvalid, causal, window, wgmma, fwd_lse, split)
    dk, dv = dkv_model(tq, tk, tv, tdo, lse, delta, tvalid, causal, window, wgmma, split)
    got = [g.to(dt) for g in (dq, dk, dv)]
    return got, tref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, **kw), lse, valid


@pytest.mark.parametrize("name", CASES)
def test_the_simt_masked_pairs_walks_match_the_plain_gradients_in_fp32(name):
    got, expect, _, _ = _model_pair(name, wgmma=False, seed=4)
    for n, g, e in zip("qkv", got, expect):
        torch.testing.assert_close(g, e, **F32_TOL, msg=f"d{n}")


@pytest.mark.parametrize("name", CASES)
def test_the_wgmma_masked_pairs_walks_match_the_plain_gradients_in_bf16(name):
    got, expect, _, _ = _model_pair(name, wgmma=True, seed=5)
    for n, g, e in zip("qkv", got, expect):
        assert g.dtype == e.dtype == torch.bfloat16
        torch.testing.assert_close(g, e, **BF16_TOL, msg=f"d{n}")


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_gradients_from_the_forwards_lse_match_the_plain_ones(name, dtype):
    """The live pair's arithmetic with lse from the forward (no first pass)
    over its live-tile walks: fp32 inputs unsplit at 3e-5, bf16 inputs with
    P and dS split at (1e-3, 1e-2)."""
    got, expect, _, _ = _model_pair(name, wgmma=True, seed=7, dt=dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for n, g, e in zip("qkv", got, expect):
        assert g.dtype == e.dtype == dtype
        torch.testing.assert_close(g, e, **tol, msg=f"d{n}")


@pytest.mark.parametrize("name", CASES)
def test_the_forwards_saved_lse_is_the_plain_lse(name):
    """The lse the masked wgmma forward saves for the live pair (its walk:
    live tiles, or every tile when a row is empty; masked scores at NEG_INF)
    equals the plain log-sum-exp of the allowed scores in log2 units, with
    -inf exactly on the rows that have no allowed valid key."""
    q, k, v, dout, valid, causal, window = _inputs(name, seed=8)
    tq, tk, tvalid = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(valid)
    got = fwd_lse_model(tq, tk, tvalid, causal, window)
    expect = tref.flash_attention_lse_ref(tq, tk, causal=causal, window=window,
                                          key_valid=tvalid)
    B, Hq, S = got.shape
    has_key = _full_mask(valid, S, causal, window).any(-1)
    np.testing.assert_array_equal(torch.isneginf(got).numpy(),
                                  np.broadcast_to(~has_key[:, None], (B, Hq, S)))
    np.testing.assert_array_equal(torch.isneginf(expect).numpy(), torch.isneginf(got).numpy())
    fin = torch.isfinite(expect)
    torch.testing.assert_close(got[fin], expect[fin], **F32_TOL)


@pytest.mark.parametrize("name", CASES)
def test_lse_is_minus_inf_exactly_on_the_rows_with_no_allowed_valid_key(name):
    """What the dkv kernel reads: lse = -inf marks the empty rows, in both
    designs (the simt pair's dq kernel, the live pair's forward), and no
    other row."""
    B, Hq, Hkv, S = CASES[name][:4]
    for wgmma in (False, True):
        _, _, lse, valid = _model_pair(name, wgmma=wgmma, seed=6)
        has_key = _full_mask(valid, S, *CASES[name][6:8]).any(-1)
        np.testing.assert_array_equal(torch.isneginf(lse).numpy(),
                                      np.broadcast_to(~has_key[:, None], (B, Hq, S)))


@pytest.mark.parametrize("name", CASES)
def test_each_dq_walk_holds_every_allowed_valid_key_of_its_rows(name):
    """Both dq walks cover every allowed valid key of the block's rows; the
    live pair's walk (its segment of the list) takes only live tiles, each
    once, in order, the live tiles of the union and no other; and the simt
    walk stays within the row's first and last valid key."""
    B, Hq, Hkv, S, T, d, causal, window, kind = CASES[name]
    valid = _mask(kind, B, T, np.random.default_rng(0))
    allowed = _full_mask(valid, S, causal, window)
    for b in range(B):
        for q0 in range(0, S, TILE):
            nq = min(TILE, S - q0)
            keys = set(np.flatnonzero(allowed[b, q0:q0 + nq].any(0)).tolist())
            wg = wgmma_dq_walk(valid[b], q0, nq, T - S, causal, window)
            assert all(w for _, w in wg) and [t for t, _ in wg] == sorted({t for t, _ in wg})
            assert {k // TILE * TILE for k in keys} <= {t for t, _ in wg}
            lo, hi = dq_union(q0, nq, T - S, T, causal, window)
            assert wg == [(t0, tile_word(valid[b], t0))
                          for t0 in range(lo // TILE * TILE, hi + 1, TILE)
                          if tile_word(valid[b], t0)]
            simt = simt_dq_walk(valid[b], q0, nq, T - S, causal, window)
            assert {k // TILE * TILE for k in keys} <= set(simt)
            if valid[b].any() and simt:
                assert simt[0] >= np.flatnonzero(valid[b])[0] // TILE * TILE
                assert simt[-1] <= np.flatnonzero(valid[b])[-1]


def test_the_dkv_blocks_at_the_phase3_mask():
    """11f's cross shape (T 1500, 24 key tiles a batch row) under its ragged
    mask: each batch row's blocks of live tiles walk, the dead tiles of the
    rows with valid keys write zeros (3 + 5 + 6 + 8 + 9 + 11 of them), and
    all 24 blocks of the fully masked row 1 carry its rows' dO / T."""
    valid = _mask("phase3", 8, 1500, None)
    blocks = [dkv_blocks(valid[b], 512, False, None) for b in range(8)]
    assert [c.count("walk") for c in blocks] == [24, 0, 21, 19, 18, 16, 15, 13]
    assert not any("walk+term" in c for c in blocks)
    assert [c.count("zeros") for c in blocks] == [0, 0, 3, 5, 6, 8, 9, 11]
    assert blocks[1] == ["term"] * 24
    # and each batch row's dq blocks walk the same live tiles: 150 of 192,
    # the whole of each row's list; the fully masked row's list is empty,
    # which is how its dkv blocks know to carry the term without reading lse
    walks = [len(wgmma_dq_walk(valid[b], 0, 64, 1500 - 512, False, None)) for b in range(8)]
    assert walks == [24, 0, 21, 19, 18, 16, 15, 13] and math.ceil(1500 / TILE) == 24
    assert [live_tiles(valid[b])[2][-1] for b in range(8)] == walks


def test_causal_rows_at_negative_positions_take_the_term_not_a_walk():
    """S > T, causal: the first S - T rows sit at negative positions and see
    no key.  The unmasked dkv walk reaches back to query tile 0 for them;
    the masked one starts at the first row that sees the key tile, and the
    term carries the others' dO (their lse is -inf)."""
    valid = np.ones(60, dtype=bool)
    assert dkv_walk(valid, 0, 60 - 200, 200, True, None) == [128, 192]
    assert dkv_blocks(valid, 200, True, None) == ["walk+term"]
    assert dkv_blocks(valid, 60, True, None) == ["walk"]


# ---------------------------------------------------------------------------
# Dispatch


def test_bwd_route_under_a_key_mask():
    assert tflash.bwd_route(torch.bfloat16, True) == "wgmma_live"
    assert tflash.bwd_route(torch.bfloat16, False) == "wgmma"
    for dt in (torch.float32, torch.float16, torch.float64):
        assert tflash.bwd_route(dt, True) == "masked"
        assert tflash.bwd_route(dt) == "simt"
    assert tflash.BWD_PAIRS["masked"] == ("bwd_dq_masked", "bwd_dkv_masked")
    assert tflash.BWD_PAIRS["wgmma_masked"] == ("bwd_dq_wgmma_masked", "bwd_dkv_wgmma_masked")
    assert tflash.BWD_PAIRS["wgmma_live"] == ("bwd_dq_wgmma_live", "bwd_dkv_wgmma_live")
    assert set(tflash.BWD_LAUNCHES) == {n for pair in tflash.BWD_PAIRS.values() for n in pair}
    assert ops.ROUTE_LAUNCHES["flash_attention_bwd"] is tflash.BWD_LAUNCHES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["flash_attention_bwd", "flash_attention_bwd_masked_simt"])
def test_the_masked_backward_wrappers_refuse_cpu_tensors_and_a_bad_mask(fn, dtype):
    q, k, v, dout, valid, causal, window = _inputs("ragged-G4-d128")
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, dout))
    tvalid = torch.from_numpy(valid)
    before = dict(tflash.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(tflash, fn)(tq, tk, tv, tq, tdo, causal=causal, key_valid=tvalid)
    with pytest.raises(ValueError, match="key_valid"):
        getattr(tflash, fn)(tq, tk, tv, tq, tdo, causal=causal, key_valid=tvalid[:, :7])
    with pytest.raises(ValueError, match="key_valid"):
        tflash._bwd(tflash.bwd_route(dtype, True), tq, tk, tv, tq, tdo, causal, None)
    assert tflash.BWD_LAUNCHES == before


def test_on_the_cpu_a_masked_call_keeps_the_plain_autograd_and_counts_nothing():
    ops.reset_launches()
    q, k, v, dout, valid, causal, window = _inputs("causal-future")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    out = ops.flash_attention(tq, tk, tv, causal=causal, key_valid=tvalid)
    assert out.grad_fn is not None and "FlashAttention" not in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    expect = tref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                          out.detach(), torch.from_numpy(dout),
                                          causal=causal, key_valid=tvalid)
    for g, e in zip(grads, expect):
        torch.testing.assert_close(g, e, **F32_TOL)
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["flash_attention_bwd"] == 0
    assert all(n == 0 for n in ops.ROUTE_LAUNCHES["flash_attention_bwd"].values())
    assert all(n == 0 for n in ops.ROUTE_LAUNCHES["flash_attention"].values())
