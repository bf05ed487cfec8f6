"""Plain PyTorch versions of the kernels.

Counterparts of ``flash_attention_ref``, ``decode_attention_ref`` and the
AES-128-CTR oracles in the JAX package's ``kernels/ref.py``: same layouts,
same fp32 softmax, same finite ``NEG_INF`` for masked scores, the same
table-based AES.  ``kernels.ops`` runs them for CPU tensors;
``chip_smoke.py`` and the GPU tests hold the CUDA kernels against them on
the card.  They run on any device.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, S, d); k, v: (B, Hkv, T, d) -> (B, Hq, S, d)."""
    B, Hq, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp + (T - S)     # allow prefix cache offset
    if window is not None:
        mask &= kp > qp + (T - S) - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, d); k, v: (B, T, Hkv, d); valid: (B, T) bool -> (B, Hq, d).

    A row with no valid slot averages v over the real T (softmax of equal
    scores), as the JAX oracle does.
    """
    B, Hq, d = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, Hkv, G, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    s = torch.where(valid.bool()[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(B, Hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# AES-128-CTR (the paper's benchmark function) — table-based reference.
# The state is 16 bytes held as int32, in column-major order: byte 4*col + row.

SBOX = torch.tensor([
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
], dtype=torch.int32)
#: GF(2^8) doubling, for MixColumns
XTIME = torch.tensor([((i << 1) ^ (0x11b if i & 0x80 else 0)) for i in range(256)],
                     dtype=torch.int32)
RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1b, 0x36)
#: ShiftRows as a gather: out[4c + r] = in[4((c + r) % 4) + r]
SHIFT_ROWS = torch.tensor([0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11])


def aes_key_expand(key_bytes: torch.Tensor) -> torch.Tensor:
    """key: (16,) int32 bytes -> round keys (11, 16) int32 on the key's device.

    The 44-word schedule is sequential and tiny, so it runs on the host in
    Python integers and is placed on the device once."""
    key = [int(b) for b in key_bytes.reshape(-1).tolist()]
    if len(key) != 16 or not all(0 <= b < 256 for b in key):
        raise ValueError("aes_key_expand: the key is 16 bytes, each in [0, 256)")
    sbox = SBOX.tolist()
    w = [key[4 * i:4 * i + 4] for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = [sbox[b] for b in t[1:] + t[:1]]
            t[0] ^= RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return torch.tensor(w, dtype=torch.int32, device=key_bytes.device).reshape(11, 16)


def _mix_columns(s: torch.Tensor) -> torch.Tensor:
    """s: (..., 16) column-major AES state bytes (int64)."""
    s4 = s.reshape(s.shape[:-1] + (4, 4))          # (..., col, row)
    a0, a1, a2, a3 = s4.unbind(-1)
    xt = XTIME.to(s.device, torch.int64)
    x0, x1, x2, x3 = xt[a0], xt[a1], xt[a2], xt[a3]
    b0 = x0 ^ (a1 ^ x1) ^ a2 ^ a3
    b1 = a0 ^ x1 ^ (a2 ^ x2) ^ a3
    b2 = a0 ^ a1 ^ x2 ^ (a3 ^ x3)
    b3 = (a0 ^ x0) ^ a1 ^ a2 ^ x3
    return torch.stack([b0, b1, b2, b3], dim=-1).reshape(s.shape)


def aes_encrypt_block_ref(block: torch.Tensor, round_keys: torch.Tensor) -> torch.Tensor:
    """block: (..., 16) int32 bytes; round_keys (11, 16) -> (..., 16) int32."""
    sbox = SBOX.to(block.device, torch.int64)
    sr = SHIFT_ROWS.to(block.device)
    rk = round_keys.to(torch.int64)
    s = block.to(torch.int64) ^ rk[0]
    for rnd in range(1, 10):
        s = _mix_columns(sbox[s][..., sr]) ^ rk[rnd]
    s = sbox[s][..., sr] ^ rk[10]
    return s.to(torch.int32)


def aes_ctr_keystream(n: int, round_keys: torch.Tensor, nonce: int = 0) -> torch.Tensor:
    """The keystream of ``n`` counter blocks: block i is 12 zero bytes and
    then ``(i + nonce) mod 2**32`` as a big-endian 32-bit integer."""
    dev = round_keys.device
    ctr = (torch.arange(n, dtype=torch.int64, device=dev) + nonce) & 0xFFFFFFFF
    shifts = torch.arange(24, -1, -8, device=dev)
    blocks = torch.zeros((n, 16), dtype=torch.int64, device=dev)
    blocks[:, 12:] = (ctr[:, None] >> shifts) & 0xFF
    return aes_encrypt_block_ref(blocks, round_keys)


def aes_ctr_ref(plaintext: torch.Tensor, key_bytes: torch.Tensor,
                nonce: int = 0) -> torch.Tensor:
    """plaintext: (N, 16) int32 byte blocks -> ciphertext (N, 16) int32.

    The keystream is XORed with the whole int32 of each plaintext element,
    as the JAX oracle does; nothing is masked to a byte."""
    rk = aes_key_expand(key_bytes).to(plaintext.device)
    return plaintext ^ aes_ctr_keystream(plaintext.shape[0], rk, nonce)
