"""The CUDA kernels against their plain versions on the card.

Marked ``gpu``; each test skips with a reason where there is no card.  Run
on a machine with one:  ``pytest -m gpu tests/test_torch_gpu.py``.  The
sweep is that of ``tests/test_kernels.py`` plus the serving path's shapes.
Kernels and plain versions both compute in fp32 and round once, so fp32 is
held at atol = rtol = 3e-5 and bf16 at atol 1e-3, rtol 1e-2 (one bf16 ulp
is at most 2**-7 of |x|).  AES-128-CTR is integer arithmetic and is held
bit-exact.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {"float32": (3e-5, 3e-5), "bfloat16": (1e-3, 1e-2)}   # (atol, rtol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _assert_close(out, expect, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), expect.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,T,d,causal,win", [
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 96, 96, 64, True, 32),
    (2, 2, 2, 64, 192, 32, True, None),
    (1, 4, 4, 128, 128, 128, False, None),
    (1, 2, 1, 257, 257, 64, True, None),
    (1, 4, 2, 70, 40, 32, True, None),      # S > T: rows with no allowed key
    (8, 16, 8, 512, 512, 128, True, None),  # the prefill of the serving path
])
def test_flash_attention_kernel(cuda, B, Hq, Hkv, S, T, d, causal, win, dtype):
    dt = getattr(torch, dtype)
    q = _randn(cuda, (B, Hq, S, d), dt)
    k, v = _randn(cuda, (B, Hkv, T, d), dt), _randn(cuda, (B, Hkv, T, d), dt)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    _assert_close(out, ref.flash_attention_ref(q, k, v, causal=causal, window=win), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,d", [
    (2, 8, 2, 300, 64), (1, 4, 4, 512, 128), (3, 16, 8, 257, 64),
    (8, 16, 8, 1024, 128),                  # a decode step of the serving path
])
def test_decode_attention_kernel(cuda, B, Hq, Hkv, T, d, dtype):
    dt = getattr(torch, dtype)
    q = _randn(cuda, (B, Hq, d), dt)
    k, v = _randn(cuda, (B, T, Hkv, d), dt), _randn(cuda, (B, T, Hkv, d), dt)
    valid = torch.rand((B, T), generator=cuda, device="cuda") < 0.8
    valid[:, 0] = True
    valid[-1] = False                       # a row with no valid slot
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, k, v, valid.int())
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    _assert_close(out, ref.decode_attention_ref(q, k, v, valid), dtype)


def test_kernel_refuses_strided_operands(cuda):
    q = _randn(cuda, (1, 4, 64, 64), torch.float32)
    k = _randn(cuda, (1, 2, 64, 64), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), k, k)


# ---------------------------------------------------------------------------
# AES-128-CTR

FIPS_KEY = list(range(16))
FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS_CT = "69c4e0d86a7b0430d8cdb78070b4c55a"


def _aes_key(cuda, which):
    if which == "fips":
        return torch.tensor(FIPS_KEY, dtype=torch.int32, device="cuda")
    return torch.randint(0, 256, (16,), generator=cuda, device="cuda", dtype=torch.int32)


def _int32_blocks(cuda, n):
    return torch.randint(-2**31, 2**31, (n, 16), generator=cuda, device="cuda",
                         dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("which", ["fips", "random"])
@pytest.mark.parametrize("nonce", [0, 7, 2**31 - 20])
@pytest.mark.parametrize("n", [1, 38, 40, 4096, 2**20])
def test_aes_ctr_kernel(cuda, n, nonce, which):
    key, pt = _aes_key(cuda, which), _int32_blocks(cuda, n)
    before = ops.LAUNCHES["aes_ctr"]
    out = ops.aes_ctr(pt, key, nonce=nonce)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["aes_ctr"] == before + 1
    assert torch.equal(out, ref.aes_ctr_ref(pt, key, nonce))
    assert torch.equal(ops.aes_ctr(out, key, nonce=nonce), pt)


def test_aes_fips197_vector(cuda):
    key = _aes_key(cuda, "fips")
    block = torch.tensor(list(FIPS_PT), dtype=torch.int32, device="cuda")
    assert bytes(ref.aes_encrypt_block_ref(block, ref.aes_key_expand(key)).tolist()).hex() \
        == FIPS_CT
    pt = block.repeat(38, 1)
    ct = ops.aes_ctr(pt, key)
    assert torch.equal(ct ^ pt, ref.aes_ctr_keystream(38, ref.aes_key_expand(key)))


def test_aes_ctr_kernel_on_an_empty_plaintext(cuda):
    before = ops.LAUNCHES["aes_ctr"]
    out = ops.aes_ctr(_int32_blocks(cuda, 0), _aes_key(cuda, "fips"))
    assert out.shape == (0, 16) and ops.LAUNCHES["aes_ctr"] == before


@pytest.mark.parametrize("case", ["dtype", "shape", "strided", "keys_shape"])
def test_aes_ctr_kernel_refuses_bad_operands(cuda, case):
    from repro_torch.kernels.aes_ctr import aes_ctr
    pt = _int32_blocks(cuda, 64)
    rk = ref.aes_key_expand(_aes_key(cuda, "fips"))
    if case == "dtype":
        pt = pt.long()
    elif case == "shape":
        pt = pt.reshape(128, 8)
    elif case == "strided":
        pt = _int32_blocks(cuda, 128)[::2]
    else:
        rk = rk.reshape(16, 11)
    with pytest.raises(ValueError, match="aes_ctr"):
        aes_ctr(pt, rk)
