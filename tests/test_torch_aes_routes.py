"""AES-128-CTR's two kernel designs and the deployed function body, on the CPU.

Which design a call takes (``route``), the ttable design's launch geometry
(every counter block owned by exactly one thread), a plain-Python model of
the ttable design's arithmetic (its word table built from the S-box and
xtime, its byte order, the rotations that give the other three tables, the
round-1 lookups made once, the last round taken out of the same table)
against the plain keystream, ``ops.aes_ctr_expanded`` against the Pallas
kernel in interpret mode and ``ops.aes_ctr``, and the deployed body
(``AesFunction``), which expands its key once.  AES is integer arithmetic,
so every comparison is exact equality.  The kernels themselves run only on
the card (``tests/test_torch_gpu.py``).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.aes_ctr import aes_ctr as pallas_aes_ctr  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import aes_ctr as taes  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.serving import AesFunction  # noqa: E402

FIPS_KEY = np.arange(16, dtype=np.int32)
NONCES = [0, 7, 2**31 - 20]          # the last crosses the int32 sign wrap at N >= 20
SIZES = [0, 1, 38, 40]
H100_SMS = 132
M32 = 0xFFFFFFFF


def _key(which):
    if which == "fips":
        return FIPS_KEY
    return np.random.default_rng(12).integers(0, 256, 16).astype(np.int32)


def _plaintext(n, seed=0):
    """Any int32, not only bytes: the keystream is XORed with the whole int32."""
    return np.random.default_rng(seed).integers(-2**31, 2**31, (n, 16)).astype(np.int32)


# -- routes and geometry -----------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 37, 38, 39, 40, 255, 256, 1024, 4096, 2**20, 2**24])
def test_route(n):
    """Both designs timed in turns on the card at 1, 38 and 2**20 blocks:
    ttable was the faster at each, so every N takes it."""
    assert taes.route(n) == "ttable"


def test_ttable_constants_are_the_sources():
    src = (_build.CSRC / "aes_ctr.cu").read_text().split("namespace ttable {")[1]
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["THREADS"]) == taes.TTABLE_THREADS
    assert int(consts["BLOCKS"]) == taes.TTABLE_BLOCKS
    assert int(consts["CTAS_PER_SM"]) == taes.TTABLE_CTAS_PER_SM


@pytest.mark.parametrize("n", [1, 38, 40, 511, 513, 4096, 4097, 135167, 135169,
                               3 * 2**18 + 7, 2**20])
def test_ttable_grid_covers_every_block_once(n):
    """The kernel's walk over ``ttable_grid(n, 132)`` CTAs: each warp takes
    chunks of ``TTABLE_BLOCKS`` runs of 32 blocks, a grid stride apart, and a
    chunk the end cuts short run by run.  Every block 0..n-1 is encrypted by
    exactly one run, no warp takes more than one chunk more than another,
    and the grid fits the SMs."""
    grid = taes.ttable_grid(n, H100_SMS)
    cap = H100_SMS * taes.TTABLE_CTAS_PER_SM
    assert grid == min(-(-n // (taes.TTABLE_THREADS * taes.TTABLE_BLOCKS)), cap)
    stride = grid * taes.TTABLE_THREADS
    owned = np.zeros(n, np.int64)
    chunks = []
    for chunk in range(0, stride, 32):          # the first chunk of each warp
        mine = 0
        while chunk < n:
            if chunk + (taes.TTABLE_BLOCKS - 1) * stride < n:
                firsts = [chunk + b * stride for b in range(taes.TTABLE_BLOCKS)]
            else:
                firsts = range(chunk, n, stride)
            for first in firsts:
                owned[first:min(first + 32, n)] += 1
            chunk += taes.TTABLE_BLOCKS * stride
            mine += 1
        chunks.append(mine)
    assert (owned == 1).all()
    assert max(chunks) - min(chunks) <= 1


def test_a_warps_rows_are_its_blocks():
    """A warp moves its 32 blocks as four 512-byte rows of int4, lane l of row
    j holding int4 32 j + l; it reads its keystream word 32 j + l out of the 32
    threads' 16-byte blocks.  Both are column l % 4 of block 8 j + l / 4, so
    row-major plaintext and row-major keystream line up word for word."""
    pt = _plaintext(32, seed=5).reshape(128, 4)            # the int4s of 32 blocks
    ks = np.random.default_rng(6).integers(0, 2**32, (32, 4), dtype=np.uint64)
    words = ks.reshape(128)                                 # ks_w
    for j in range(4):
        for lane in range(32):
            i = 32 * j + lane
            block, col = 8 * j + lane // 4, lane % 4
            np.testing.assert_array_equal(pt[i], _plaintext(32, seed=5)[block, 4 * col:4 * col + 4])
            assert words[i] == ks[block, col]


def test_route_counts_ignore_cpu_tensors():
    ops.reset_launches()
    key, pt = torch.from_numpy(_key("random")), torch.from_numpy(_plaintext(40))
    ops.aes_ctr(pt, key)
    ops.aes_ctr_expanded(pt, tref.aes_key_expand(key))
    assert ops.ROUTE_LAUNCHES["aes_ctr"] == {"ttable": 0, "simt": 0}
    assert ops.LAUNCHES["aes_ctr"] == 0


def test_entry_points_refuse_cpu_tensors():
    """Each design's entry point raises on CPU tensors before any build or
    launch: none falls back to the plain version."""
    before = dict(taes.LAUNCHES)
    pt = torch.zeros((38, 16), dtype=torch.int32)
    rk = tref.aes_key_expand(torch.from_numpy(FIPS_KEY))
    for fn in (taes.aes_ctr, taes.aes_ctr_simt):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(pt, rk)
    assert taes.LAUNCHES == before


# -- a plain-Python model of the ttable design -------------------------------

def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of
    the eight bytes of y:x (x the low four)."""
    xy = (np.asarray(y, np.uint64) << 32) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(xy), np.uint64)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((xy >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _rotl(x, bits):
    x = np.asarray(x, np.uint64)
    return (((x << np.uint64(bits)) | (x >> np.uint64(32 - bits))) & np.uint64(M32)) \
        .astype(np.uint32) if bits else np.asarray(x, np.uint32)


def _t_table():
    """T[e] = (2 S[e], S[e], S[e], 3 S[e]) in bytes 0..3, from the plain S-box
    and xtime tables."""
    s = tref.SBOX.numpy().astype(np.uint32)
    x2 = tref.XTIME.numpy().astype(np.uint32)[s]
    return x2 | s << 8 | s << 16 | (x2 ^ s) << 24


def _ttable_keystream(n, round_keys, nonce):
    """The ttable kernel's arithmetic on n counter blocks: words with byte r
    of column c at bits 8 r, table lookups T[byte R] rotated left by 8 R."""
    T = _t_table()
    rk = round_keys.numpy().astype(np.uint32).reshape(11, 4, 4)
    k = rk[..., 0] | rk[..., 1] << 8 | rk[..., 2] << 16 | rk[..., 3] << 24   # (11, 4)

    def at(r, w):
        return T[(np.asarray(w, np.uint32) >> np.uint32(8 * r)) & np.uint32(0xFF)]

    def column(s, c):
        return (at(0, s[c]) ^ _rotl(at(1, s[(c + 1) % 4]), 8) ^ _rotl(at(2, s[(c + 2) % 4]), 16)
                ^ _rotl(at(3, s[(c + 3) % 4]), 24))

    k0, k1 = k[0], k[1]
    r1 = [at(0, k0[0]) ^ _rotl(at(1, k0[1]), 8) ^ _rotl(at(2, k0[2]), 16) ^ k1[0],
          at(0, k0[1]) ^ _rotl(at(1, k0[2]), 8) ^ _rotl(at(3, k0[0]), 24) ^ k1[1],
          at(0, k0[2]) ^ _rotl(at(2, k0[0]), 16) ^ _rotl(at(3, k0[1]), 24) ^ k1[2],
          _rotl(at(1, k0[0]), 8) ^ _rotl(at(2, k0[1]), 16) ^ _rotl(at(3, k0[2]), 24) ^ k1[3]]
    ctr = ((np.arange(n, dtype=np.int64) + nonce) & M32).astype(np.uint32)
    w3 = _byte_perm(ctr, 0, 0x0123) ^ k0[3]
    s = [r1[0] ^ _rotl(at(3, w3), 24), r1[1] ^ _rotl(at(2, w3), 16),
         r1[2] ^ _rotl(at(1, w3), 8), r1[3] ^ at(0, w3)]
    for rnd in range(2, 10):
        s = [column(s, c) ^ k[rnd][c] for c in range(4)]
    ks = []
    for c in range(4):
        lo = _byte_perm(at(0, s[c]), at(1, s[(c + 1) % 4]), 0x5151)
        hi = _byte_perm(at(2, s[(c + 2) % 4]), at(3, s[(c + 3) % 4]), 0x5151)
        ks.append(_byte_perm(lo, hi, 0x5410) ^ k[10][c])
    out = np.stack([_byte_perm(ks[c], 0, 0x4440 + r) for c in range(4) for r in range(4)], -1)
    return torch.from_numpy(out.astype(np.int32))


def test_t_table_is_subbytes_and_mixcolumns():
    """MixColumns of a column of S-box outputs S[x_0..3] is the XOR over rows
    r of T[x_r] rotated left by 8 r; S[x] is byte 1 of T[x]."""
    T = _t_table()
    x = np.random.default_rng(4).integers(0, 256, (64, 4))
    x[0], x[1] = 0, 255
    state = torch.zeros((64, 16), dtype=torch.int64)
    state[:, :4] = tref.SBOX.long()[torch.from_numpy(x)]
    col = tref._mix_columns(state)[:, :4].numpy()
    words = col[:, 0] | col[:, 1] << 8 | col[:, 2] << 16 | col[:, 3] << 24
    expect = np.zeros(64, np.uint32)
    for r in range(4):
        expect ^= _rotl(T[x[:, r]], 8 * r)
    np.testing.assert_array_equal(words.astype(np.uint32), expect)
    np.testing.assert_array_equal(T >> 8 & 0xFF, tref.SBOX.numpy())


@pytest.mark.parametrize("which", ["fips", "random"])
@pytest.mark.parametrize("nonce", NONCES + [-20, 2**32 - 20])
@pytest.mark.parametrize("n", [1, 38, 40, 300])
def test_ttable_model_gives_the_plain_keystream(n, nonce, which):
    rk = tref.aes_key_expand(torch.from_numpy(_key(which)))
    assert torch.equal(_ttable_keystream(n, rk, nonce), tref.aes_ctr_keystream(n, rk, nonce))


def test_counter_past_two_to_the_32_matches_jax():
    """A nonce of 2**32 - 20 wraps the counter within 40 blocks; JAX's int32
    counter takes the same nonce as -20."""
    key, pt = _key("random"), _plaintext(40, seed=3)
    rk = jref.aes_key_expand(jnp.asarray(key))
    expect = np.asarray(pallas_aes_ctr(jnp.asarray(pt), rk, nonce=-20, block_n=16,
                                       interpret=True))
    got = ops.aes_ctr_expanded(torch.from_numpy(pt), torch.from_numpy(np.array(rk)),
                               nonce=2**32 - 20)
    np.testing.assert_array_equal(got.numpy(), expect)


# -- aes_ctr_expanded and the deployed body ----------------------------------

@pytest.mark.parametrize("which", ["fips", "random"])
@pytest.mark.parametrize("nonce", NONCES)
@pytest.mark.parametrize("n", SIZES)
def test_aes_ctr_expanded_matches_pallas_and_aes_ctr(n, nonce, which):
    key, pt = _key(which), _plaintext(n, seed=200 + n)
    jrk = jref.aes_key_expand(jnp.asarray(key))
    rk = tref.aes_key_expand(torch.from_numpy(key))
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jrk))
    got = ops.aes_ctr_expanded(torch.from_numpy(pt), rk, nonce=nonce)
    assert got.dtype == torch.int32 and got.shape == (n, 16)
    assert torch.equal(got, ops.aes_ctr(torch.from_numpy(pt), torch.from_numpy(key), nonce=nonce))
    if n:
        expect = np.asarray(pallas_aes_ctr(jnp.asarray(pt), jrk, nonce=nonce, block_n=16,
                                           interpret=True))
        np.testing.assert_array_equal(got.numpy(), expect)


def test_aes_ctr_expanded_on_other_devices_raises():
    pt = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ops.aes_ctr_expanded(pt, tref.aes_key_expand(torch.from_numpy(FIPS_KEY)))


def test_deployed_body_expands_the_key_once(monkeypatch):
    calls = []
    expand = tref.aes_key_expand

    def counting(key_bytes):
        calls.append(1)
        return expand(key_bytes)

    monkeypatch.setattr(tref, "aes_key_expand", counting)
    key = torch.from_numpy(_key("random"))
    fn = AesFunction(key, device="cpu")
    assert len(calls) == 1 and fn.round_keys.shape == (11, 16)
    ops.reset_launches()
    for seed in range(5):
        payload = torch.from_numpy(_plaintext(38, seed=seed))
        assert torch.equal(fn(payload), payload ^ tref.aes_ctr_keystream(38, expand(key), 0))
    assert len(calls) == 1
    assert ops.LAUNCHES["aes_ctr"] == 0


def test_deployed_body_matches_the_plain_function():
    key = torch.from_numpy(_key("fips"))
    fn = AesFunction(key, device="cpu", nonce=7)
    payload = torch.from_numpy(_plaintext(38, seed=9))
    assert torch.equal(fn(payload), tref.aes_ctr_ref(payload, key, 7))
    assert torch.equal(AesFunction(key, device="cpu", nonce=7)(fn(payload)), payload)


def test_deployed_body_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AesFunction(torch.from_numpy(FIPS_KEY))
