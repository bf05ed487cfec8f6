"""The port's plain attention versions against the JAX oracles in
``repro.kernels.ref`` and the Pallas kernels (``interpret=True``), over the
sweep of ``tests/test_kernels.py``, on the CPU; and the device dispatch of
``repro_torch.kernels.ops``.  Inputs come from a numpy seed and are handed
to both frameworks; bf16 inputs are the same rounded values in both.
Tolerances as in ``tests/test_kernels.py``: 3e-5 at fp32, 5e-2 at bf16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def tol(name):
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else dict(atol=3e-5, rtol=3e-5)


def _both(a, name):
    """One numpy array as a torch tensor and a jax array of the same dtype."""
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 96, 96, 64, True, 32),       # SWA + padding
    (2, 2, 2, 64, 192, 32, True, None),    # prefix-cache offset
    (1, 4, 4, 128, 128, 128, False, None), # bidirectional MHA
    (1, 2, 1, 257, 257, 64, True, None),   # odd lengths
]
DECODE_CASES = [(2, 8, 2, 300, 64), (1, 4, 4, 512, 128), (3, 16, 8, 257, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,T,d,causal,win", FLASH_CASES)
def test_flash_attention_ref_matches_jax(B, Hq, Hkv, S, T, d, causal, win, dtype):
    rng = np.random.default_rng(42)
    (tq, jq), (tk, jk), (tv, jv) = (
        _both(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, Hq, S, d), (B, Hkv, T, d), (B, Hkv, T, d)))
    out = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=win)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=win)
    pallas = pallas_flash(jq, jk, jv, causal=causal, window=win,
                          block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(oracle), **tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(pallas), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,d", DECODE_CASES)
def test_decode_attention_ref_matches_jax(B, Hq, Hkv, T, d, dtype):
    rng = np.random.default_rng(43)
    (tq, jq), (tk, jk), (tv, jv) = (
        _both(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, Hq, d), (B, T, Hkv, d), (B, T, Hkv, d)))
    valid = rng.random((B, T)) < 0.8
    valid[:, 0] = True
    out = tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(valid))
    assert out.dtype == tq.dtype and out.shape == tq.shape
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid))
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(valid), block_k=128, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(oracle), **tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(pallas), **tol(dtype))


def test_decode_row_without_valid_slot_averages_v_over_real_T():
    """A row with no valid slot, T not a block multiple: the port follows
    ``ref.py`` (the mean of v over the real T), not the Pallas kernel's
    mean over the zero-padded length."""
    rng = np.random.default_rng(44)
    B, Hq, Hkv, T, d = 2, 4, 2, 200, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, d), (B, T, Hkv, d), (B, T, Hkv, d)))
    valid = rng.random((B, T)) < 0.5
    valid[1] = False
    out = tref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, valid)))
    oracle = jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, valid)))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=3e-5, rtol=3e-5)
    mean_v = v[1].mean(axis=0)                              # (Hkv, d)
    np.testing.assert_allclose(out[1].numpy(), np.repeat(mean_v, Hq // Hkv, axis=0),
                               atol=3e-5, rtol=3e-5)


def test_flash_row_without_allowed_key_averages_v():
    """S > T under the causal mask: query 0 sits at a negative position and
    sees no key; like the oracle it averages v over the real T."""
    rng = np.random.default_rng(45)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 2, 6, 32), (1, 1, 4, 32), (1, 1, 4, 32)))
    out = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)))
    oracle = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(out[0, :, 0].numpy(), np.repeat(v[0].mean(axis=1), 2, 0),
                               atol=3e-5, rtol=3e-5)


def _key_valid(B, T, mask):
    """(B, T) bool: ragged valid prefixes, the second row fully masked under
    ``"masked_row"``."""
    lengths = np.array([T, T // 2 + 1, 3, T - 5][:B])
    valid = np.arange(T)[None] < lengths[:, None]
    if mask == "masked_row":
        valid[1] = False
    return valid


@pytest.mark.parametrize("mask", ["ragged", "masked_row"])
@pytest.mark.parametrize("B,Hq,Hkv,S,T,d", [
    (2, 4, 2, 9, 37, 32),       # a cross prefill: S < T, G 2
    (4, 4, 4, 70, 150, 64),     # G 1, ragged tiles of 64 keys
    (3, 8, 2, 5, 200, 128),
])
def test_flash_attention_ref_under_a_key_mask_matches_jax(B, Hq, Hkv, S, T, d, mask):
    """The plain version's key mask against the JAX model's cross-attention
    (``gqa_attend`` under the encoder mask, no causal bound): a fully masked
    row averages v over all of T in both."""
    from repro.models.attention import gqa_attend
    rng = np.random.default_rng(46)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, S, d), (B, Hkv, T, d), (B, Hkv, T, d)))
    valid = _key_valid(B, T, mask)
    out = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=False,
                                   key_valid=torch.from_numpy(valid))
    jmask = np.broadcast_to(valid[:, None, :], (B, S, T))
    oracle = gqa_attend(*(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
                        jnp.asarray(jmask))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle).transpose(0, 2, 1, 3),
                               atol=3e-5, rtol=3e-5)
    if mask == "masked_row":
        np.testing.assert_allclose(out[1].numpy(),
                                   np.repeat(v[1].mean(axis=1)[:, None], S, 1).repeat(
                                       Hq // Hkv, 0), atol=3e-5, rtol=3e-5)


def test_flash_attention_ref_all_valid_mask_equals_no_mask():
    rng = np.random.default_rng(47)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 11, 32), (2, 2, 23, 32), (2, 2, 23, 32)))
    for causal in (True, False):
        torch.testing.assert_close(
            tref.flash_attention_ref(q, k, v, causal=causal,
                                     key_valid=torch.ones((2, 23), dtype=torch.bool)),
            tref.flash_attention_ref(q, k, v, causal=causal), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# dispatch


def _flash_inputs(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((1, 4, 9, 32), generator=g).to(dtype),
            torch.randn((1, 2, 9, 32), generator=g).to(dtype),
            torch.randn((1, 2, 9, 32), generator=g).to(dtype))


def _decode_inputs():
    g = torch.Generator().manual_seed(1)
    return (torch.randn((2, 4, 32), generator=g), torch.randn((2, 9, 2, 32), generator=g),
            torch.randn((2, 9, 2, 32), generator=g), torch.rand((2, 9), generator=g) < 0.7)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    ops.reset_launches()
    q, k, v = _flash_inputs()
    out = ops.flash_attention(q, k, v, causal=True, window=4)
    torch.testing.assert_close(out, tref.flash_attention_ref(q, k, v, window=4),
                               atol=0, rtol=0)
    dq, dk, dv, valid = _decode_inputs()
    out = ops.decode_attention(dq, dk, dv, valid)
    torch.testing.assert_close(out, tref.decode_attention_ref(dq, dk, dv, valid),
                               atol=0, rtol=0)
    assert ops.LAUNCHES == {"flash_attention": 0, "decode_attention": 0, "aes_ctr": 0,
                            "moe_gmm": 0, "mamba_scan": 0, "rwkv6_scan": 0,
                            "flash_attention_bwd": 0, "moe_gmm_bwd": 0,
                            "mamba_scan_bwd": 0, "rwkv6_scan_bwd": 0, "adamw": 0}


def test_other_devices_raise():
    q, k, v = (t.to("meta") for t in _flash_inputs())
    with pytest.raises(ValueError, match="no implementation"):
        ops.flash_attention(q, k, v)
    dq, dk, dv, valid = (t.to("meta") for t in _decode_inputs())
    with pytest.raises(ValueError, match="no implementation"):
        ops.decode_attention(dq, dk, dv, valid)
    assert ops.LAUNCHES == {"flash_attention": 0, "decode_attention": 0, "aes_ctr": 0,
                            "moe_gmm": 0, "mamba_scan": 0, "rwkv6_scan": 0,
                            "flash_attention_bwd": 0, "moe_gmm_bwd": 0,
                            "mamba_scan_bwd": 0, "rwkv6_scan_bwd": 0, "adamw": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """Called directly, the CUDA wrappers raise before touching a CPU
    tensor: they never fall back to the plain version."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_attention(*_flash_inputs())
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdecode.decode_attention(*_decode_inputs())


@pytest.mark.parametrize("shapes", [
    ((1, 4, 9, 32), (1, 3, 9, 32), (1, 3, 9, 32)),    # Hq not a multiple of Hkv
    ((1, 4, 9, 32), (2, 2, 9, 32), (2, 2, 9, 32)),    # batch differs
    ((1, 4, 9, 48), (1, 2, 9, 48), (1, 2, 9, 48)),    # head_dim not instantiated
    ((1, 4, 9, 32), (1, 2, 9, 32), (1, 2, 8, 32)),    # k and v differ
    ((4, 9, 32), (1, 2, 9, 32), (1, 2, 9, 32)),       # q is not 4-D
])
def test_flash_check_inputs_rejects(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        tflash.check_inputs(q, k, v, None)


@pytest.mark.parametrize("key_valid", [
    torch.ones((1, 8), dtype=torch.bool),                 # T differs
    torch.ones((2, 9), dtype=torch.bool),                 # B differs
    torch.ones((1, 9), dtype=torch.int32),                # not bool
    torch.ones((1, 9), dtype=torch.bool, device="meta"),  # another device than q
])
def test_flash_check_inputs_rejects_a_bad_key_mask(key_valid):
    q, k, v = _flash_inputs()
    with pytest.raises(ValueError, match="key_valid"):
        tflash.check_inputs(q, k, v, None, key_valid)


def test_flash_check_inputs_rejects_bad_window():
    with pytest.raises(ValueError, match="window"):
        tflash.check_inputs(*_flash_inputs(), 0)


@pytest.mark.parametrize("case", ["heads", "valid_shape", "valid_dtype", "head_dim"])
def test_decode_check_inputs_rejects(case):
    q, k, v, valid = _decode_inputs()
    if case == "heads":
        q = torch.zeros((2, 3, 32))
    elif case == "valid_shape":
        valid = valid[:, :5]
    elif case == "valid_dtype":
        valid = valid.float()
    else:
        q, k, v = torch.zeros((2, 4, 40)), torch.zeros((2, 9, 2, 40)), torch.zeros((2, 9, 2, 40))
    with pytest.raises(ValueError):
        tdecode.check_inputs(q, k, v, valid)


# ---------------------------------------------------------------------------
# build


def _no_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("flash_attention",))


def test_build_skips_an_up_to_date_library(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    for name in _build.SOURCES:
        _build.library_path(name).write_bytes(b"")
    assert _build.build() == {}


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path("decode_attention")
    (csrc / "attn_common.cuh").write_text((csrc / "attn_common.cuh").read_text() + "\n")
    assert _build.library_path("decode_attention") != before


# ---------------------------------------------------------------------------
# routes: the design a CUDA call takes is fixed by dtype and shape before the
# launch, by pure functions that run here


@pytest.mark.parametrize("dtype,expect", [(torch.bfloat16, "wgmma"), (torch.float32, "simt")])
def test_flash_route(dtype, expect):
    assert tflash.route(dtype) == expect


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_route_under_a_key_mask(dtype):
    """A key mask takes the masked design of the dtype's route: bf16 the
    wgmma one, fp32 the simt one."""
    expect = "wgmma_masked" if dtype == torch.bfloat16 else "masked"
    assert tflash.route(dtype, True) == expect
    assert tflash.route(dtype, False) == tflash.route(dtype)


@pytest.mark.parametrize("E,C,D,F,dtype,expect", [
    (8, 1280, 4096, 14336, torch.bfloat16, "wgmma"),   # mixtral-8x7b prefill, gate and up
    (8, 1280, 14336, 4096, torch.bfloat16, "wgmma"),   # mixtral prefill, down
    (16, 640, 4096, 14336, torch.bfloat16, "wgmma"),   # jamba-v0.1-52b prefill, gate and up
    (16, 640, 14336, 4096, torch.bfloat16, "wgmma"),   # jamba prefill, down
    (8, 1280, 4096, 14336, torch.float32, "mma_sync"),  # fp32 stays off the tensor cores
    (8, 2, 4096, 14336, torch.bfloat16, "stream"),     # mixtral decode
    (16, 1, 14336, 4096, torch.bfloat16, "stream"),    # jamba decode
    (4, 1280, 96, 130, torch.bfloat16, "mma_sync"),    # F not a multiple of 8: no TMA stride
    (4, 1280, 100, 128, torch.bfloat16, "mma_sync"),   # D not a multiple of 8
    (8, 2, 14336, 4096, torch.bfloat16, "stream"),     # mixtral decode, down
    (16, 1, 4096, 14336, torch.bfloat16, "stream"),    # jamba decode, gate and up
    (8, 2, 4096, 14336, torch.float32, "mma_sync"),    # fp32 decode
    (8, 2, 4096, 130, torch.bfloat16, "mma_sync"),     # a decode shape with ragged F
    (8, 2, 100, 128, torch.bfloat16, "mma_sync"),      # a decode shape with ragged D
    (8, 32, 4096, 14336, torch.bfloat16, "mma_sync"),  # between the two thresholds
])
def test_moe_gmm_route(E, C, D, F, dtype, expect):
    from repro_torch.kernels import moe_gmm as tgmm
    assert tgmm.route(dtype, C, D, F) == expect


def test_moe_gmm_route_threshold():
    from repro_torch.kernels import moe_gmm as tgmm
    c = tgmm.WGMMA_MIN_C
    assert 2 < c <= 200
    assert tgmm.route(torch.bfloat16, c, 96, 72) == "wgmma"
    assert tgmm.route(torch.bfloat16, c - 1, 96, 72) == "mma_sync"


@pytest.mark.parametrize("dtype,expect_at,expect_past", [
    (torch.bfloat16, "stream", "mma_sync"), (torch.float32, "mma_sync", "mma_sync")])
def test_moe_gmm_stream_threshold(dtype, expect_at, expect_past):
    from repro_torch.kernels import moe_gmm as tgmm
    c = tgmm.STREAM_MAX_C
    assert 2 <= c <= tgmm.STREAM_KERNEL_MAX_C < tgmm.WGMMA_MIN_C
    assert tgmm.route(dtype, 1, 96, 72) == expect_at
    assert tgmm.route(dtype, c, 96, 72) == expect_at
    assert tgmm.route(dtype, c + 1, 96, 72) == expect_past


def test_route_counts_reset_and_ignore_cpu_tensors():
    ops.ROUTE_LAUNCHES["flash_attention"]["wgmma"] += 3
    ops.ROUTE_LAUNCHES["moe_gmm"]["mma_sync"] += 2
    ops.reset_launches()
    ops.flash_attention(*_flash_inputs(torch.bfloat16))
    g = torch.Generator().manual_seed(2)
    ops.moe_gmm(torch.randn((2, 64, 32), generator=g).bfloat16(),
                torch.randn((2, 32, 24), generator=g).bfloat16())
    ops.moe_gmm(torch.randn((2, 2, 32), generator=g).bfloat16(),
                torch.randn((2, 32, 24), generator=g).bfloat16())
    assert ops.ROUTE_LAUNCHES == {"flash_attention": {"wgmma": 0, "simt": 0, "masked": 0,
                                                      "wgmma_masked": 0},
                                  "decode_attention": {"split": 0, "simt": 0},
                                  "aes_ctr": {"ttable": 0, "simt": 0},
                                  "moe_gmm": {"stream": 0, "wgmma": 0, "mma_sync": 0},
                                  "mamba_scan": {"lanes": 0, "simt": 0},
                                  "rwkv6_scan": {"cols": 0, "simt": 0},
                                  "flash_attention_bwd": {"bwd_dq": 0, "bwd_dkv": 0,
                                                          "bwd_dq_wgmma": 0,
                                                          "bwd_dkv_wgmma": 0,
                                                          "bwd_dq_masked": 0,
                                                          "bwd_dkv_masked": 0,
                                                          "bwd_dq_wgmma_masked": 0,
                                                          "bwd_dkv_wgmma_masked": 0,
                                                          "bwd_dq_wgmma_live": 0,
                                                          "bwd_dkv_wgmma_live": 0},
                                  "moe_gmm_bwd": {"dx_wgmma_nt": 0, "dw_wgmma_tn": 0,
                                                  "dx_wgmma_nt_fwd": 0, "dx_stream": 0,
                                                  "dx_wgmma": 0,
                                                  "dx_mma_sync": 0, "dw_stream": 0,
                                                  "dw_wgmma": 0, "dw_mma_sync": 0},
                                  "mamba_scan_bwd": {"ring": 0, "ckpt": 0},
                                  "rwkv6_scan_bwd": {"ring": 0, "rows": 0},
                                  "adamw": {"sumsq": 0, "norm": 0, "update": 0}}


def test_every_entry_point_refuses_cpu_tensors():
    """The entry points of both designs raise on CPU tensors before any
    build or launch: they never fall back to the plain version."""
    from repro_torch.kernels import moe_gmm as tgmm
    before = dict(tflash.LAUNCHES), dict(tgmm.LAUNCHES)
    q, k, v = _flash_inputs(torch.bfloat16)
    for fn in (tflash.flash_attention, tflash.flash_attention_simt):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(q, k, v)
    x, w = torch.zeros((2, 64, 32), dtype=torch.bfloat16), torch.zeros((2, 32, 24),
                                                                       dtype=torch.bfloat16)
    for fn in (tgmm.moe_gmm, tgmm.moe_gmm_mma_sync, tgmm.moe_gmm_wgmma, tgmm.moe_gmm_stream):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(x, w)
    assert (tflash.LAUNCHES, tgmm.LAUNCHES) == before
