"""The flash kernel's key-masked designs on the CPU.

A model in torch of what ``csrc/flash_attention.cu`` does under a (B, T)
key mask: the block-wide scan of the batch row's mask (``km::scan``: a
64-bit valid word a key tile, the row's first and last valid key, and
whether some query row has no allowed valid key), the simt design's early
stop (it walks from the row's first valid key to its last, within the union
of its rows' causal and window ranges) and the wgmma design's live-tile
walk (only tiles whose word is not 0; every tile of [0, T) when a row of
the 128-query block has no allowed valid key), with the online softmax over
64-key tiles in log2 units and P split into a bf16 head and remainder.
Held against the plain version ``flash_attention_ref`` and JAX's
``gqa_attend`` under a (B, S, T) mask, inputs from a numpy seed: fp32 at the
flash limit of ``tests/test_kernels.py`` (atol = rtol = 3e-5), bf16
operands with P split at one bf16 ulp (atol 1e-3, rtol 1e-2).  Then the
routes and the wrapper's refusal of CPU tensors.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TILE = 64            # keys a tile, bits a valid word
WG_BLOCK = 128       # queries a block of the wgmma design (two warpgroups of 64)
SIMT_BLOCK = 64      # queries a block of the simt design
NEG_INF = -1e30      # attn::kNegInf
LOG2E = 1.4426950408889634
ALL_ONES = (1 << TILE) - 1
F32_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=1e-3, rtol=1e-2)
PHASE3_LENGTHS = (1500, 0, 1306, 1209, 1112, 1015, 918, 821)   # chip_smoke.py phase 3

CASES = {   # B, Hq, Hkv, S, T, d, causal, window, mask
    "phase3": (8, 2, 1, 512, 1500, 64, False, None, "phase3"),
    "holes": (4, 4, 2, 100, 700, 32, False, None, "holes"),
    "holes-d120": (3, 2, 1, 70, 450, 120, False, None, "holes"),
    "ragged-d128": (2, 4, 4, 96, 200, 128, False, None, "ragged"),
    "ragged-d64-G4": (3, 8, 2, 40, 129, 64, False, None, "ragged"),
    "causal-future": (3, 4, 2, 200, 200, 64, True, None, "future"),
    "causal-prefix-offset": (2, 2, 1, 150, 330, 32, True, None, "holes"),
    "causal-S>T": (2, 2, 1, 90, 60, 32, True, None, "ragged"),
    "window": (2, 2, 1, 130, 700, 64, False, 200, "holes"),
    "causal-window": (3, 4, 2, 160, 300, 120, True, 96, "future"),
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
        if kind == "phase3":
            row = t < PHASE3_LENGTHS[b]
        elif kind == "ragged":      # prefixes: all, none, tile edges
            row = t < (T, 0, 64, 65, T - 1)[b % 5]
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
    B, Hq, Hkv, S, T, d, causal, window, kind = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, S, d), (B, Hkv, T, d), (B, Hkv, T, d)))
    return q, k, v, _mask(kind, B, T, rng), causal, window


# ---------------------------------------------------------------------------
# km::scan and the walks, as the kernels compute them


def tile_word(row, t0):
    """Bit c is key t0 + c; 0 at or past T (the producer's two ballots)."""
    return sum(1 << c for c, ok in enumerate(row[t0:t0 + TILE].tolist()) if ok)


def range_bits(t0, lo, hi):
    a, b = min(max(lo - t0, 0), TILE), min(max(hi - t0 + 1, 0), TILE)
    return ((1 << b) - 1) & ~((1 << a) - 1)


def rl(p, window):
    return max(0, p - window + 1) if window is not None else 0


def scan(row, p_first, nrows, causal, window, tile_lo, tile_hi):
    """km::scan: (fv, lv, live tiles of [tile_lo, tile_hi], any_empty)."""
    T = len(row)
    fv, lv, m0, live = T, -1, -1, 0
    for i in range(math.ceil(T / TILE)):
        t0 = i * TILE
        w = tile_word(row, t0)
        if not w:
            continue
        fv = min(fv, t0 + (w & -w).bit_length() - 1)
        lv = max(lv, t0 + w.bit_length() - 1)
        live += tile_lo <= i <= tile_hi
        before = w & range_bits(t0, rl(p_first, window), p_first - 1) if causal else 0
        if before:
            m0 = max(m0, t0 + before.bit_length() - 1)
    if not causal:
        return fv, lv, live, lv < rl(p_first + nrows - 1, window)
    # one ballot per warp of 32 rows: each warp's last valid row position,
    # then each row's last valid key at or before it
    rows = [r < nrows and 0 <= p_first + r and bool(row[p_first + r])
            for r in range(math.ceil(nrows / 32) * 32)]
    wlast = [max([p_first + r for r in range(32 * w, 32 * w + 32) if rows[r]], default=-1)
             for w in range(len(rows) // 32)]
    any_empty = False
    for r in range(nrows):
        p = p_first + r
        prev = max([m0] + wlast[:r // 32])
        upto = [p_first + j for j in range(r // 32 * 32, r + 1) if rows[j]]
        if upto:
            prev = upto[-1]
        any_empty |= p < 0 or prev < rl(p, window)
    return fv, lv, live, any_empty


def wgmma_walk(row, q0, S, causal, window):
    """The (t0, word) tiles a wgmma block walks, in order: BlockTiles'
    union, then scan_mask's rule, then the producer's loop."""
    T = len(row)
    off = T - S
    p_first, p_last = q0 + off, q0 + min(WG_BLOCK, S - q0) - 1 + off
    lo, hi = 0, T - 1
    if not (causal and p_first < 0):
        if causal:
            hi = min(hi, p_last)
        if window is not None:
            lo = max(0, p_first - window + 1)
    lo_tile = lo // TILE
    hi_tile = lo_tile + (hi - lo_tile * TILE) // TILE
    _, _, live, any_empty = scan(row, p_first, min(WG_BLOCK, S - q0), causal, window,
                                 lo_tile, hi_tile)
    if any_empty:
        return [(i * TILE, tile_word(row, i * TILE)) for i in range(math.ceil(T / TILE))]
    walk = [(i * TILE, tile_word(row, i * TILE)) for i in range(lo_tile, hi_tile + 1)]
    walk = [(t0, w) for t0, w in walk if w]
    assert len(walk) == live > 0       # producer and consumers agree; never zero tiles
    return walk


def simt_range(row, q0, S, causal, window):
    """The key range [key_lo, key_hi] a simt block walks (thread 0's union
    of its rows' ranges, then the row's first and last valid key)."""
    T = len(row)
    off, nq = T - S, min(SIMT_BLOCK, S - q0)
    fv, lv, _, empty = scan(row, q0 + off, nq, causal, window, 0, -1)
    lo, hi = T, -1
    for r in range(nq):
        p = q0 + r + off
        a, b = rl(p, window), min(T - 1, p) if causal else T - 1
        if a > b:
            empty = True
        else:
            lo, hi = min(lo, a), max(hi, b)
    return (0, T - 1) if empty else (max(lo, fv), min(hi, lv))


# ---------------------------------------------------------------------------
# The arithmetic of the two designs


def _allowed(p, kp, causal, window):
    ok = torch.ones(p.shape[0], kp.shape[1], dtype=torch.bool)
    if causal:
        ok &= kp <= p
    if window is not None:
        ok &= kp > p - window
    return ok


def _bits(word, n):
    return torch.tensor([(word >> c) & 1 for c in range(n)], dtype=torch.bool)[None]


def _bf16_parts(x, split):
    head = x.to(torch.bfloat16).float()
    return [head, (x - head).to(torch.bfloat16).float()] if split else [x]


def wgmma_model(q, k, v, valid, causal, window, split):
    """The wgmma design: each 128-query block walks ``wgmma_walk``; per
    64-row warpgroup the masking arithmetic runs only where a tile crosses
    T, the causal diagonal or the window's start, or its word is not all
    ones; scores in log2 units; P V with P split (bf16 operands) or whole."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, off = Hq // Hkv, T - S
    scale_log2 = d ** -0.5 * LOG2E
    q, k, v = q.float(), k.float(), v.float()
    out = torch.zeros(B, Hq, S, d)
    for b in range(B):
        for q0 in range(0, S, WG_BLOCK):
            walk = wgmma_walk(valid[b], q0, S, causal, window)
            for h in range(Hq):
                kk, vv = k[b, h // G], v[b, h // G]
                for c0 in range(q0, min(q0 + WG_BLOCK, S), 64):   # a warpgroup's rows
                    nq = min(64, S - c0)
                    p = torch.arange(c0, c0 + nq)[:, None] + off
                    pw_first = c0 + off
                    m, l, o = torch.full((nq,), NEG_INF), torch.zeros(nq), torch.zeros(nq, d)
                    for t0, word in walk:
                        nt = min(TILE, T - t0)
                        s = (q[b, h, c0:c0 + nq] @ kk[t0:t0 + nt].T) * scale_log2
                        need = (t0 + TILE > T or (causal and t0 + TILE - 1 > pw_first)
                                or (window is not None and t0 <= pw_first + 63 - window)
                                or word != ALL_ONES)
                        if need:
                            kp = torch.arange(t0, t0 + nt)[None]
                            s = torch.where(_allowed(p, kp, causal, window) & _bits(word, nt),
                                            s, NEG_INF)
                        m_new = torch.maximum(m, s.max(-1).values)
                        alpha = torch.exp2(m - m_new)
                        pr = torch.exp2(s - m_new[:, None])
                        l = l * alpha + pr.sum(-1)
                        o = o * alpha[:, None]
                        for part in _bf16_parts(pr, split):
                            o = o + part @ vv[t0:t0 + nt]
                        m = m_new
                    out[b, h, c0:c0 + nq] = o / torch.where(l == 0, 1.0, l)[:, None]
    return out


def simt_model(q, k, v, valid, causal, window):
    """The simt design (fp32): each 64-query block walks the 64-key tiles
    of ``simt_range``, every tile masked, natural-exp online softmax."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, off, scale = Hq // Hkv, T - S, d ** -0.5
    out = torch.zeros(B, Hq, S, d)
    for b in range(B):
        for q0 in range(0, S, SIMT_BLOCK):
            key_lo, key_hi = simt_range(valid[b], q0, S, causal, window)
            nq = min(SIMT_BLOCK, S - q0)
            p = torch.arange(q0, q0 + nq)[:, None] + off
            for h in range(Hq):
                kk, vv = k[b, h // G], v[b, h // G]
                m, l, o = torch.full((nq,), NEG_INF), torch.zeros(nq), torch.zeros(nq, d)
                for t0 in range(key_lo // TILE * TILE, key_hi + 1, TILE):
                    nt = min(TILE, T - t0)
                    kp = torch.arange(t0, t0 + nt)[None]
                    ok = _allowed(p, kp, causal, window) & valid[b, t0:t0 + nt][None]
                    s = torch.where(ok, (q[b, h, q0:q0 + nq] * scale) @ kk[t0:t0 + nt].T,
                                    NEG_INF)
                    m_new = torch.maximum(m, s.max(-1).values)
                    alpha = torch.exp(m - m_new)
                    pr = torch.exp(s - m_new[:, None])
                    l = l * alpha + pr.sum(-1)
                    o = o * alpha[:, None] + pr @ vv[t0:t0 + nt]
                    m = m_new
                out[b, h, q0:q0 + nq] = o / torch.where(l == 0, 1.0, l)[:, None]
    return out


def _jax_gqa(q, k, v, valid, causal, window):
    """JAX's gqa_attend under the (B, S, T) mask: the key mask and the
    causal and window masks of the plain version; (B, Hq, S, d)."""
    S, T = q.shape[2], k.shape[2]
    mask = tref._attn_mask(S, T, causal, window, "cpu").numpy()[None] & valid[:, None, :]
    out = jattn.gqa_attend(*(jnp.asarray(np.swapaxes(a, 1, 2)) for a in (q, k, v)),
                           jnp.asarray(mask))
    return torch.from_numpy(np.swapaxes(np.array(out), 1, 2))


def _brute_force(valid, S, causal, window):
    """(B, S) bool: which query rows have an allowed valid key."""
    T = valid.shape[1]
    return (tref._attn_mask(S, T, causal, window, "cpu")[None] & valid[:, None, :]).any(-1)


# ---------------------------------------------------------------------------
# The tests


@pytest.mark.parametrize("name", CASES)
def test_the_wgmma_masked_model_matches_the_plain_version_and_jax_in_fp32(name):
    q, k, v, valid, causal, window = _inputs(name)
    tq, tk, tv, tvalid = map(torch.from_numpy, (q, k, v, valid))
    got = wgmma_model(tq, tk, tv, tvalid, causal, window, split=False)
    plain = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                     key_valid=tvalid)
    torch.testing.assert_close(got, plain, **F32_TOL)
    torch.testing.assert_close(got, _jax_gqa(q, k, v, valid, causal, window), **F32_TOL)


@pytest.mark.parametrize("name", CASES)
def test_the_wgmma_masked_model_with_bf16_operands_and_p_split_is_within_one_ulp(name):
    q, k, v, valid, causal, window = _inputs(name, seed=1)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    got = wgmma_model(tq, tk, tv, tvalid, causal, window, split=True).to(torch.bfloat16)
    plain = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                     key_valid=tvalid)
    torch.testing.assert_close(got, plain, **BF16_TOL)
    jax_out = _jax_gqa(*(t.float().numpy() for t in (tq, tk, tv)), valid, causal, window)
    torch.testing.assert_close(got.float(), jax_out, **BF16_TOL)


@pytest.mark.parametrize("name", CASES)
def test_the_simt_masked_model_matches_the_plain_version(name):
    q, k, v, valid, causal, window = _inputs(name, seed=2)
    tq, tk, tv, tvalid = map(torch.from_numpy, (q, k, v, valid))
    got = simt_model(tq, tk, tv, tvalid, causal, window)
    torch.testing.assert_close(got, tref.flash_attention_ref(
        tq, tk, tv, causal=causal, window=window, key_valid=tvalid), **F32_TOL)


def test_a_fully_masked_row_averages_v_over_all_of_t():
    """Phase 3's row 1 has no valid key: its block walks all 24 tiles and
    its output is the mean of v over the 1500 keys."""
    q, k, v, valid, causal, window = _inputs("phase3", seed=3)
    assert not valid[1].any()
    assert len(wgmma_walk(valid[1], 0, 512, False, None)) == 24
    got = wgmma_model(*(torch.from_numpy(a[1:2]) for a in (q, k, v, valid)), causal, window,
                      split=False)
    mean = torch.from_numpy(v[1]).mean(1, keepdim=True).expand(2, 512, 64)
    torch.testing.assert_close(got[0], mean, **F32_TOL)


def test_the_live_walk_at_phase3_takes_150_of_192_tile_walks():
    """Seamless's cross prefill under phase 3's ragged mask (T 1500, 24
    tiles a row): 24 + 24 + 21 + 19 + 18 + 16 + 15 + 13 tiles, the fully
    masked row walking all of them; every query tile of a row alike."""
    valid = torch.from_numpy(_mask("phase3", 8, 1500, None))
    walks = [[len(wgmma_walk(valid[b], q0, 512, False, None)) for q0 in range(0, 512, 128)]
             for b in range(8)]
    assert [w[0] for w in walks] == [24, 24, 21, 19, 18, 16, 15, 13]
    assert all(len(set(w)) == 1 for w in walks)
    assert sum(w[0] for w in walks) == 150 and 8 * math.ceil(1500 / TILE) == 192


@pytest.mark.parametrize("name", CASES)
def test_the_walks_follow_the_empty_row_rule(name):
    """Both designs walk every tile of [0, T) exactly when some row of the
    block has no allowed valid key.  Otherwise the wgmma block walks the
    live tiles of its union, which hold every allowed valid key of its rows,
    and the simt block the range from the row's first valid key to its last
    within its union, which holds them too."""
    B, Hq, Hkv, S, T, d, causal, window, kind = CASES[name]
    valid = torch.from_numpy(_mask(kind, B, T, np.random.default_rng(0)))
    allowed = tref._attn_mask(S, T, causal, window, "cpu")[None] & valid[:, None, :]
    has_key = allowed.any(-1)
    n_tiles = math.ceil(T / TILE)
    for b in range(B):
        for block, walk_of in ((WG_BLOCK, wgmma_walk), (SIMT_BLOCK, simt_range)):
            for q0 in range(0, S, block):
                rows = slice(q0, min(q0 + block, S))
                empty = not bool(has_key[b, rows].all())
                keys = allowed[b, rows].any(0).nonzero().flatten().tolist()
                walk = walk_of(valid[b], q0, S, causal, window)
                if walk_of is simt_range:
                    if empty:
                        assert walk == (0, T - 1)
                    else:
                        assert walk[0] <= keys[0] and keys[-1] <= walk[1]
                        assert walk[0] >= int(valid[b].nonzero()[0])
                        assert walk[1] <= int(valid[b].nonzero()[-1])
                    continue
                tiles = [t0 // TILE for t0, _ in walk]
                if empty:
                    assert tiles == list(range(n_tiles))
                else:
                    assert all(w for _, w in walk) and tiles == sorted(set(tiles))
                    assert {t // TILE for t in keys} <= set(tiles)


def test_the_scan_finds_empty_rows_as_brute_force_does():
    """km::scan's rule (the last row decides when not causal; per row under
    causal, from m0, the warps' ballots and each earlier warp's last) on
    random masks with holes, causal or not, windows or not, S against T."""
    rng = np.random.default_rng(7)
    seen = set()
    for _ in range(300):
        T, S = int(rng.integers(1, 300)), int(rng.integers(1, 300))
        causal = bool(rng.integers(2))
        window = None if rng.integers(3) == 0 else int(rng.integers(1, 200))
        density = float(rng.choice([0.0, 0.02, 0.1, 0.6, 1.0]))
        valid = torch.from_numpy(rng.random((1, T)) < density)
        if rng.integers(2):        # a dead stretch
            a = int(rng.integers(0, T))
            valid[0, a:a + int(rng.integers(1, 150))] = False
        has_key = _brute_force(valid, S, causal, window)[0]
        for block in (WG_BLOCK, SIMT_BLOCK):
            for q0 in range(0, S, block):
                nrows = min(block, S - q0)
                _, _, _, empty = scan(valid[0], q0 + T - S, nrows, causal, window, 0, -1)
                assert empty == (not bool(has_key[q0:q0 + nrows].all())), (T, S, causal, window)
                seen.add((causal, window is not None, empty))
    assert len(seen) == 8          # every branch, empty or not


@pytest.mark.parametrize("dtype,expect", [(torch.bfloat16, "wgmma_masked"),
                                          (torch.float32, "masked")])
def test_route_under_a_key_mask(dtype, expect):
    assert tflash.route(dtype, True) == expect
    assert tflash.route(dtype, False) == ("wgmma" if dtype == torch.bfloat16 else "simt")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_masked_entry_points_refuse_cpu_tensors(dtype):
    """Both masked designs raise on CPU tensors before any build or launch;
    the op runs the plain version there and counts nothing."""
    q, k, v, valid, causal, window = _inputs("ragged-d64-G4")
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    ops.reset_launches()
    for fn in (tflash.flash_attention, tflash.flash_attention_masked_simt):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(tq, tk, tv, causal=causal, key_valid=tvalid)
    out = ops.flash_attention(tq, tk, tv, causal=causal, key_valid=tvalid)
    torch.testing.assert_close(out, tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                                             key_valid=tvalid))
    assert ops.ROUTE_LAUNCHES["flash_attention"] == {"wgmma": 0, "simt": 0, "masked": 0,
                                                     "wgmma_masked": 0}
