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
    assert ops.LAUNCHES == {"flash_attention": 0, "decode_attention": 0, "aes_ctr": 0}


def test_other_devices_raise():
    q, k, v = (t.to("meta") for t in _flash_inputs())
    with pytest.raises(ValueError, match="no implementation"):
        ops.flash_attention(q, k, v)
    dq, dk, dv, valid = (t.to("meta") for t in _decode_inputs())
    with pytest.raises(ValueError, match="no implementation"):
        ops.decode_attention(dq, dk, dv, valid)
    assert ops.LAUNCHES == {"flash_attention": 0, "decode_attention": 0, "aes_ctr": 0}


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
