"""Decode attention's split design and head_dim 120, on the CPU.

- The plain decode attention against the JAX oracle and the Pallas kernel
  (``interpret=True``) on the masks the split design treats apart: a ring
  mask that wraps, a row with no valid slot, T not a multiple of the 64-slot
  tile, head_dim 120.
- The split design's algorithm, written out here in numpy (tiles flagged by
  their valid bytes, the live tiles dealt out evenly to the splits, an online
  softmax per split in log2 units, the splits combined by log-sum-exp in
  order, a split with no tile weighted 0), against the plain version: the
  CUDA kernel cannot run here, its arithmetic can.
- The routes of decode attention and the split count, pure functions of
  dtype and shape.
- A reduced ``h2o-danube-3-4b`` with its head width set to 120, as in the
  full model (d_model 3840 over 32 heads), against the JAX ``forward``,
  ``prefill`` and ``decode_step`` at float32, atol = rtol = 1e-4 as in
  ``tests/test_models.py``.

Inputs come from numpy seeds and are handed to both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import get_arch, reduced  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels._launch import HEAD_DIMS, check_head_dim  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)
NEG_INF = -1e30
TILE = tdecode.TILE


def _qkv(B, Hq, Hkv, T, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, d), (B, T, Hkv, d), (B, T, Hkv, d)))


def _masks(B, T, seed):
    """Masks by name: a contiguous prefix of 513 slots (a 512-token prompt
    and one new token), a ring that wraps (slots from 700 to T and from 0 to
    188), random with a row that has no valid slot, and one valid slot in
    the last, ragged tile."""
    rng = np.random.default_rng(seed)
    j = np.arange(T)
    rand = rng.random((B, T)) < 0.5
    rand[-1] = False
    last = np.zeros((B, T), bool)
    last[:, T - 1] = True
    return {"prefix": np.broadcast_to(j <= min(512, T - 1), (B, T)).copy(),
            "wrap": np.broadcast_to((j >= min(700, T - 1)) | (j < 189), (B, T)).copy(),
            "random_and_empty_row": rand,
            "last_slot": last}


# ---------------------------------------------------------------------------
# the plain version against JAX on the masks of the split design


@pytest.mark.parametrize("mask", ["prefix", "wrap", "random_and_empty_row", "last_slot"])
@pytest.mark.parametrize("B,Hq,Hkv,T,d", [
    (2, 4, 2, 1024, 64),     # T a multiple of the tile
    (3, 8, 2, 257, 32),      # one slot in the last tile
    (2, 4, 1, 300, 120),     # head_dim 120, T not a multiple of 64
])
def test_plain_decode_matches_jax_on_split_masks(B, Hq, Hkv, T, d, mask):
    q, k, v = _qkv(B, Hq, Hkv, T, d, 60)
    valid = _masks(B, T, 61)[mask]
    out = tref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, valid)))
    oracle = jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, valid)))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), **TOL)
    # the Pallas kernel averages a row with no valid slot over its padded
    # length; the other rows agree
    rows = valid.any(axis=1)
    pallas = pallas_decode(*map(jnp.asarray, (q, k, v, valid)), block_k=64, interpret=True)
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(pallas)[rows], **TOL)


def test_plain_decode_row_without_valid_slot_averages_v_at_head_dim_120():
    q, k, v = _qkv(2, 4, 2, 300, 120, 62)
    valid = np.ones((2, 300), bool)
    valid[1] = False
    out = tref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, valid)))
    np.testing.assert_allclose(out[1].numpy(), np.repeat(v[1].mean(axis=0), 2, axis=0), **TOL)


# ---------------------------------------------------------------------------
# the split design's algorithm, in numpy


def split_decode(q, k, v, valid, nsplit):
    """The arithmetic of ``decode_split_kernel`` in float64: returns
    (B, Hq, d)."""
    B, Hq, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = d ** -0.5 * np.log2(np.e)                # scores in log2 units
    n_tiles = -(-T // TILE)
    out = np.zeros((B, Hq, d))
    for b in range(B):
        row_any = valid[b].any()
        live = [i for i in range(n_tiles)
                if not row_any or valid[b, i * TILE:(i + 1) * TILE].any()]
        N = len(live)
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G].astype(np.float64) * scale
            parts = []
            for s in range(nsplit):
                m, l, acc = np.full(G, -np.inf), np.zeros(G), np.zeros((G, d))
                for t in live[s * N // nsplit:(s + 1) * N // nsplit]:
                    sl = slice(t * TILE, min(T, (t + 1) * TILE))
                    sc = qg @ k[b, sl, h].T.astype(np.float64)
                    sc = np.where(valid[b, sl], sc, NEG_INF)
                    mx = np.maximum(m, sc.max(axis=1))
                    alpha = np.where(m == -np.inf, 0.0, np.exp2(m - mx))
                    p = np.exp2(sc - mx[:, None])
                    l = l * alpha + p.sum(axis=1)
                    acc = acc * alpha[:, None] + p @ v[b, sl, h].astype(np.float64)
                    m = mx
                parts.append((m, l, acc))
            M = np.max([m for m, _, _ in parts], axis=0)
            assert np.isfinite(M).all()                # some split scored a slot
            L, A = np.zeros(G), np.zeros((G, d))
            for m, l, acc in parts:
                wt = np.where(m == -np.inf, 0.0, np.exp2(m - M))   # an empty split: 0
                L += l * wt
                A += acc * wt[:, None]
            out[b, h * G:(h + 1) * G] = A / L[:, None]
    return out


@pytest.mark.parametrize("mask", ["prefix", "wrap", "random_and_empty_row", "last_slot"])
@pytest.mark.parametrize("nsplit", [1, 2, 8])
@pytest.mark.parametrize("B,Hq,Hkv,T", [(2, 4, 2, 1024), (2, 8, 2, 257), (1, 2, 2, 1500)])
def test_split_design_matches_the_plain_version(B, Hq, Hkv, T, nsplit, mask):
    """8 splits of the 'last_slot' mask leave seven splits with no tile."""
    q, k, v = _qkv(B, Hq, Hkv, T, 32, 63)
    valid = _masks(B, T, 64)[mask]
    got = split_decode(q, k, v, valid, nsplit)
    expect = tref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, valid)))
    np.testing.assert_allclose(got, expect.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# routes and splits: pure functions of dtype and shape


@pytest.mark.parametrize("dtype,G,T,expect", [
    (torch.bfloat16, 2, 1024, "split"),      # qwen3-1.7b at the serving cache
    (torch.bfloat16, 4, 1024, "split"),      # mixtral-8x7b, jamba, h2o-danube-3-4b
    (torch.bfloat16, 1, 9, "split"),
    (torch.bfloat16, 8, 2 ** 20, "split"),   # the longest T of the split design
    (torch.bfloat16, 8, 2 ** 20 + 1, "simt"),
    (torch.bfloat16, 3, 1024, "split"),      # phi4-mini-3.8b: 24 query heads over 8
    (torch.bfloat16, 16, 1024, "simt"),
    (torch.float32, 2, 1024, "simt"),        # fp32 keeps the simt design
])
def test_decode_route(dtype, G, T, expect):
    assert tdecode.route(dtype, G, T) == expect


@pytest.mark.parametrize("B,Hkv,T,sms,expect", [
    (8, 8, 1024, 132, (2, 8)),       # the serving shape: 128 blocks on 132 SMs
    (1, 8, 1024, 132, (8, 2)),
    (3, 8, 257, 132, (5, 1)),        # one split per tile
    (1, 1, 9, 132, (1, 1)),
    (64, 8, 1024, 132, (1, 16)),     # more (row, head) pairs than SMs: no split
    (1, 1, 2 ** 20, 132, (8, 2048)),
    (8, 8, 2 ** 19, 132, (2, 4096)),       # long rows at the serving batch
    (17, 8, 131136, 132, (1, 2049)),       # B x Hkv past the SMs: one split of the row
    (133, 1, 2 ** 20, 132, (1, 16384)),    # the longest row in one split
])
def test_decode_splits(B, Hkv, T, sms, expect):
    nsplit, per = tdecode.splits(B, Hkv, T, sms)
    assert (nsplit, per) == expect
    n_tiles = -(-T // TILE)
    assert 1 <= nsplit <= tdecode.MAX_SPLITS and per <= tdecode.MAX_TILES_PER_SPLIT
    assert nsplit == -(-n_tiles // per)
    assert nsplit == 1 or B * Hkv * nsplit <= tdecode.BLOCKS_PER_SM * sms


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("B", [1, 8, 17, 64, 133, 65535])
def test_decode_split_route_takes_any_batch(B, sms):
    """Every shape routed to ``split`` gets a split count that the kernel's
    host check takes (T <= 2^20, 1 <= tiles per split <= the row's tiles,
    at most 8 splits covering the row), whatever B, Hkv and the card."""
    for Hkv in (1, 8, 64):
        for T in (1, 64, 65, 1024, 131072, 131136, 2 ** 19, 2 ** 20, 2 ** 20 + 1):
            if tdecode.route(torch.bfloat16, 2, T) != "split":
                assert T > tdecode.MAX_T
                continue
            nsplit, per = tdecode.splits(B, Hkv, T, sms)
            n_tiles = -(-T // TILE)
            assert 1 <= per <= min(n_tiles, tdecode.MAX_TILES_PER_SPLIT)
            assert 1 <= nsplit <= tdecode.MAX_SPLITS and nsplit == -(-n_tiles // per)


def test_decode_route_counts_ignore_cpu_tensors():
    ops.reset_launches()
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(2, 4, 2, 70, 32, 65))
    ops.decode_attention(q, k, v, torch.ones((2, 70), dtype=torch.bool))
    assert ops.ROUTE_LAUNCHES["decode_attention"] == {"split": 0, "simt": 0}


def test_decode_entry_points_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(2, 4, 2, 70, 32, 66))
    valid = torch.ones((2, 70), dtype=torch.bool)
    before = dict(tdecode.LAUNCHES)
    for fn in (tdecode.decode_attention, tdecode.decode_attention_simt):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(q, k, v, valid)
    assert tdecode.LAUNCHES == before


# ---------------------------------------------------------------------------
# head_dim 120


def test_head_dims_take_120():
    assert 120 in HEAD_DIMS
    check_head_dim("decode_attention", 120)
    with pytest.raises(ValueError, match="head_dim 112"):
        check_head_dim("decode_attention", 112)


def test_check_inputs_take_head_dim_120():
    q, k, v = (torch.zeros(s) for s in ((1, 4, 9, 120), (1, 2, 9, 120), (1, 2, 9, 120)))
    tflash.check_inputs(q, k, v, None)
    tflash.check_inputs(q, k, v, 4)
    dq, dk, dv = (torch.zeros(s) for s in ((2, 4, 120), (2, 9, 2, 120), (2, 9, 2, 120)))
    tdecode.check_inputs(dq, dk, dv, torch.ones((2, 9), dtype=torch.bool))


def _h2o_120(seed):
    """Reduced h2o-danube-3-4b (2 layers, d_model 256, 4 query and 4 kv heads,
    window 128) with its heads 120 wide, as in the full model, at float32."""
    kw = dict(dtype="float32", head_dim=120, n_kv_heads=2)
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch("h2o-danube-3-4b")), **kw)
    tcfg = dataclasses.replace(reduced(get_arch("h2o-danube-3-4b")), **kw)
    assert tcfg.resolved_head_dim == 120 != tcfg.d_model // tcfg.n_heads
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), device="cpu")


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=1e-4, rtol=1e-4)


def test_head_dim_120_forward_matches_jax():
    jcfg, tcfg, jparams, tparams = _h2o_120(70)
    toks = np.random.default_rng(70).integers(0, jcfg.vocab_size, (2, 11))
    jl, _ = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _ = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tparams["blocks"][0]["attn"]["wq"].shape[-1] == 4 * 120
    _close(tl, jl)


@pytest.mark.parametrize("B,S,seq_len", [
    (2, 9, 16),
    (2, 136, 144),     # past the 128-slot window: the ring wraps
])
def test_head_dim_120_prefill_and_decode_match_jax(B, S, seq_len):
    jcfg, tcfg, jparams, tparams = _h2o_120(71)
    toks = np.random.default_rng(71).integers(0, jcfg.vocab_size, (B, S + 3))
    jl, jc = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                        seq_len=seq_len)
    tl, tc = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        seq_len=seq_len)
    assert tc["layers"][0]["k"].shape[-1] == 120
    _close(tl, jl)
    for i in range(3):
        nxt = toks[:, S + i:S + i + 1]
        jl, jc = JT.decode_step(jparams, jcfg, jnp.asarray(nxt, jnp.int32),
                                jnp.int32(S + i), jc)
        tl, tc = TT.decode_step(tparams, tcfg, torch.from_numpy(nxt), S + i, tc)
        _close(tl, jl)
    _close(tc["layers"][0]["k"], jc["layers"][0]["k"])
