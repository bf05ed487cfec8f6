"""The port's AES-128-CTR plain versions against the JAX oracles in
``repro.kernels.ref`` and the Pallas kernel (``interpret=True``), on the CPU;
the device dispatch of ``repro_torch.kernels.ops.aes_ctr``; the kernel
wrapper's operand checks; and the ``paper-aes-600b`` config.  Inputs come
from a numpy seed and are handed to both frameworks.  AES is integer
arithmetic, so every comparison is exact equality."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.aes_ctr import aes_ctr as pallas_aes_ctr  # noqa: E402
from repro_torch.config import ArchType, get_arch  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import aes_ctr as taes  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

FIPS_KEY = np.arange(16, dtype=np.int32)
FIPS_PT = np.array([0x00, 0x11, 0x22, 0x33, 0x44, 0x55, 0x66, 0x77,
                    0x88, 0x99, 0xaa, 0xbb, 0xcc, 0xdd, 0xee, 0xff], np.int32)
FIPS_CT = [0x69, 0xc4, 0xe0, 0xd8, 0x6a, 0x7b, 0x04, 0x30,
           0xd8, 0xcd, 0xb7, 0x80, 0x70, 0xb4, 0xc5, 0x5a]
NONCES = [0, 7, 2**31 - 20]          # the last crosses the int32 sign wrap at N >= 20


def _key(which):
    if which == "fips":
        return FIPS_KEY
    return np.random.default_rng(12).integers(0, 256, 16).astype(np.int32)


def _plaintext(n, seed=0):
    """Any int32, not only bytes: the keystream is XORed with the whole int32."""
    return np.random.default_rng(seed).integers(-2**31, 2**31, (n, 16)).astype(np.int32)


@pytest.mark.parametrize("which", ["fips", "random"])
def test_key_expand_matches_jax(which):
    key = _key(which)
    expect = np.asarray(jref.aes_key_expand(jnp.asarray(key)))
    got = tref.aes_key_expand(torch.from_numpy(key))
    assert got.dtype == torch.int32 and got.shape == (11, 16)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_key_expand_rejects_a_bad_key():
    with pytest.raises(ValueError, match="16 bytes"):
        tref.aes_key_expand(torch.arange(15, dtype=torch.int32))
    with pytest.raises(ValueError, match="16 bytes"):
        tref.aes_key_expand(torch.full((16,), 256, dtype=torch.int32))


def test_fips197_block():
    """FIPS-197 appendix C.1 known answer, as ``tests/test_kernels.py`` checks it."""
    rk = tref.aes_key_expand(torch.from_numpy(FIPS_KEY))
    ct = tref.aes_encrypt_block_ref(torch.from_numpy(FIPS_PT), rk)
    assert ct.tolist() == FIPS_CT
    jrk = jref.aes_key_expand(jnp.asarray(FIPS_KEY))
    jct = jref.aes_encrypt_block_ref(jnp.asarray(FIPS_PT), jrk)
    assert list(map(int, jct)) == FIPS_CT


@pytest.mark.parametrize("which", ["fips", "random"])
@pytest.mark.parametrize("nonce", NONCES)
@pytest.mark.parametrize("n", [1, 38, 40])
def test_aes_ctr_ref_matches_jax(n, nonce, which):
    key, pt = _key(which), _plaintext(n, seed=n)
    expect = np.asarray(jref.aes_ctr_ref(jnp.asarray(pt), jnp.asarray(key), nonce))
    got = tref.aes_ctr_ref(torch.from_numpy(pt), torch.from_numpy(key), nonce)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("nonce", NONCES)
@pytest.mark.parametrize("n", [1, 38, 40])
def test_aes_ctr_ref_matches_pallas_interpret(n, nonce):
    key, pt = _key("random"), _plaintext(n, seed=100 + n)
    rk = jref.aes_key_expand(jnp.asarray(key))
    expect = np.asarray(pallas_aes_ctr(jnp.asarray(pt), rk, nonce=nonce, block_n=16,
                                       interpret=True))
    got = tref.aes_ctr_ref(torch.from_numpy(pt), torch.from_numpy(key), nonce)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_keystream_is_ct_xor_pt():
    key, pt = _key("random"), _plaintext(38)
    ct = tref.aes_ctr_ref(torch.from_numpy(pt), torch.from_numpy(key), 7)
    ks = tref.aes_ctr_keystream(38, tref.aes_key_expand(torch.from_numpy(key)), 7)
    assert torch.equal(ct ^ torch.from_numpy(pt), ks)
    assert int(ks.min()) >= 0 and int(ks.max()) < 256


def test_round_trip_decrypts():
    key, pt = torch.from_numpy(_key("random")), torch.from_numpy(_plaintext(38))
    ct = tref.aes_ctr_ref(pt, key, 3)
    assert not torch.equal(ct, pt)
    assert torch.equal(tref.aes_ctr_ref(ct, key, 3), pt)


def test_empty_plaintext():
    out = ops.aes_ctr(torch.zeros((0, 16), dtype=torch.int32), torch.from_numpy(FIPS_KEY))
    assert out.shape == (0, 16) and out.dtype == torch.int32


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    ops.reset_launches()
    key, pt = torch.from_numpy(_key("random")), torch.from_numpy(_plaintext(40))
    out = ops.aes_ctr(pt, key, nonce=2**31 - 20)
    assert torch.equal(out, tref.aes_ctr_ref(pt, key, 2**31 - 20))
    assert ops.LAUNCHES == {"flash_attention": 0, "decode_attention": 0, "aes_ctr": 0,
                            "moe_gmm": 0, "mamba_scan": 0, "rwkv6_scan": 0,
                            "flash_attention_bwd": 0, "moe_gmm_bwd": 0, "mamba_scan_bwd": 0,
                            "rwkv6_scan_bwd": 0, "adamw": 0}


def test_other_devices_raise():
    pt = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ops.aes_ctr(pt, torch.from_numpy(FIPS_KEY))


@pytest.mark.parametrize("case", ["cpu", "dtype", "width", "rank", "keys"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Called directly, the CUDA wrapper raises before it launches; it never
    falls back to the plain version."""
    pt = torch.zeros((38, 16), dtype=torch.int32)
    rk = tref.aes_key_expand(torch.from_numpy(FIPS_KEY))
    if case == "dtype":
        pt = pt.long()
    elif case == "width":
        pt = torch.zeros((38, 12), dtype=torch.int32)
    elif case == "rank":
        pt = pt.reshape(-1)
    elif case == "keys":
        rk = rk[:10]
    with pytest.raises(ValueError, match="CUDA tensors" if case == "cpu" else "aes_ctr"):
        taes.aes_ctr(pt, rk)


def test_cuda_source_sbox_is_the_plain_sbox():
    """The kernel keeps the S-box packed four bytes to a word; it is the
    same table as the plain version's."""
    src = (_build.CSRC / "aes_ctr.cu").read_text()
    body = src.split("kSboxWords[64] = {")[1].split("};")[0]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
    sbox = tref.SBOX.tolist()
    assert words == [sbox[4 * q] | sbox[4 * q + 1] << 8 | sbox[4 * q + 2] << 16
                     | sbox[4 * q + 3] << 24 for q in range(64)]
    assert tref.SBOX.tolist() == np.asarray(jref.SBOX).tolist()
    assert tref.XTIME.tolist() == np.asarray(jref.XTIME).tolist()


def test_paper_aes_resolves_in_the_ports_registry():
    cfg = get_arch("paper-aes-600b")
    assert cfg.name == "paper-aes-600b" and cfg.arch_type == ArchType.MICRO
    assert "aes_ctr" in _build.SOURCES
