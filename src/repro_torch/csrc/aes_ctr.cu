// AES-128 in counter mode: the paper's benchmark function (vSwarm AES over a
// 600-byte input, 38 blocks of 16 bytes).
//
// Replaces the Pallas kernel `aes_ctr` (body `_aes_kernel`, `_shift_rows`) in
// src/repro/kernels/aes_ctr.py.  Plain version:
// repro_torch.kernels.ref.aes_ctr_keystream (and aes_ctr_ref around it).
//
// Layouts: plaintext and out (N, 16) int32, one byte value per element;
// round keys (11, 16) int32 bytes.  Counter block i is 12 zero bytes and then
// uint32(i + nonce) in big-endian bytes, and out = plaintext ^ keystream on
// the whole int32, as in the reference: the plaintext is not masked to a byte.
//
// What bounds it on this card: at the function's own size (N = 38) the launch
// itself, since 38 blocks are a fraction of one warp's work on one SM.  At a
// batch of blocks, either the bytes (64 B in and 64 B out per block, as int32)
// or the 160 S-box lookups per block at one conflict-free shared-memory load
// per clock per SM: at the card's clock the two are within a factor of two,
// and the bytes are the larger.
//
// What this simple design does about it: one thread per 16-byte block, so
// any N is covered by bounds, with no padding.  The counter is computed in the
// thread, never stored in device memory.  The state lives in four registers,
// one 32-bit word per column (byte r of column c at bits 8r), so ShiftRows is
// the choice of which column each byte is read from, and AddRoundKey and
// MixColumns work on whole words: MixColumns doubles four bytes at once in
// GF(2^8) with shifts and masks (the reference's xtime table, computed), so
// only the S-box is a table.  The S-box sits in shared memory in 32 copies,
// one per bank, so a warp's 32 lookups never conflict; the round keys sit
// there as 44 packed words.  Loads and stores are 16 bytes per thread.  Not
// done here: several blocks per thread to hide shared-memory latency, and
// T-tables that fold SubBytes and MixColumns into four lookups per column.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The S-box packed four bytes to a word, byte e at bits 8 * (e % 4) of word e / 4.
__constant__ uint32_t kSboxWords[64] = {
    0x7b777c63u, 0xc56f6bf2u, 0x2b670130u, 0x76abd7feu, 0x7dc982cau, 0xf04759fau,
    0xafa2d4adu, 0xc072a49cu, 0x2693fdb7u, 0xccf73f36u, 0xf1e5a534u, 0x1531d871u,
    0xc323c704u, 0x9a059618u, 0xe2801207u, 0x75b227ebu, 0x1a2c8309u, 0xa05a6e1bu,
    0xb3d63b52u, 0x842fe329u, 0xed00d153u, 0x5bb1fc20u, 0x39becb6au, 0xcf584c4au,
    0xfbaaefd0u, 0x85334d43u, 0x7f02f945u, 0xa89f3c50u, 0x8f40a351u, 0xf5389d92u,
    0x21dab6bcu, 0xd2f3ff10u, 0xec130ccdu, 0x1744975fu, 0x3d7ea7c4u, 0x73195d64u,
    0xdc4f8160u, 0x88902a22u, 0x14b8ee46u, 0xdb0b5edeu, 0x0a3a32e0u, 0x5c240649u,
    0x62acd3c2u, 0x79e49591u, 0x6d37c8e7u, 0xa94ed58du, 0xeaf4566cu, 0x08ae7a65u,
    0x2e2578bau, 0xc6b4a61cu, 0x1f74dde8u, 0x8a8bbd4bu, 0x66b53e70u, 0x0ef60348u,
    0xb9573561u, 0x9e1dc186u, 0x1198f8e1u, 0x948ed969u, 0xe9871e9bu, 0xdf2855ceu,
    0x0d89a18cu, 0x6842e6bfu, 0x0f2d9941u, 0x16bb54b0u};

// Byte r (0..3) of a word.
__device__ __forceinline__ uint32_t byte_of(uint32_t w, int r) { return (w >> (8 * r)) & 0xffu; }

// Doubling in GF(2^8) of each of the four bytes of a word.
__device__ __forceinline__ uint32_t xtime4(uint32_t x) {
  return ((x & 0x7f7f7f7fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1bu);
}

// MixColumns of one column: b_r = 2 a_r ^ 3 a_{r+1} ^ a_{r+2} ^ a_{r+3}.
__device__ __forceinline__ uint32_t mix_column(uint32_t a) {
  const uint32_t r1 = __funnelshift_r(a, a, 8);   // byte r holds a_{r+1}
  const uint32_t r2 = __funnelshift_r(a, a, 16);
  const uint32_t r3 = __funnelshift_r(a, a, 24);
  return xtime4(a ^ r1) ^ r1 ^ r2 ^ r3;
}

__global__ void __launch_bounds__(kThreads)
aes_ctr_kernel(const int4* __restrict__ pt, const int* __restrict__ round_keys,
               int4* __restrict__ out, long long n, uint32_t nonce) {
  // 32 copies of the S-box: copy l holds byte e at byte 4 * (32 * (e / 4) + l) + e % 4,
  // so every byte of copy l lies in bank l.
  __shared__ uint32_t sbox_s[64 * 32];
  __shared__ uint32_t rk_s[44];
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < 64 * 32; i += kThreads) sbox_s[i] = kSboxWords[i / 32];
  if (tid < 44) {
    const int* k = round_keys + 4 * tid;  // round tid / 4, column tid % 4
    rk_s[tid] = (uint32_t)(k[0] & 0xff) | (uint32_t)(k[1] & 0xff) << 8 |
                (uint32_t)(k[2] & 0xff) << 16 | (uint32_t)(k[3] & 0xff) << 24;
  }
  __syncthreads();
  const long long row = (long long)blockIdx.x * kThreads + tid;
  if (row >= n) return;

  const uint8_t* sbox = reinterpret_cast<const uint8_t*>(sbox_s) + 4 * lane;
  auto sub = [sbox](uint32_t e) -> uint32_t { return sbox[(e >> 2) * 128 + (e & 3)]; };
  // SubBytes then ShiftRows: byte r of column c comes from column (c + r) % 4.
  auto sub_shift = [&sub](const uint32_t* s, int c) -> uint32_t {
    return sub(byte_of(s[c], 0)) | sub(byte_of(s[(c + 1) & 3], 1)) << 8 |
           sub(byte_of(s[(c + 2) & 3], 2)) << 16 | sub(byte_of(s[(c + 3) & 3], 3)) << 24;
  };

  const uint32_t ctr = (uint32_t)row + nonce;  // wraps at 2^32
  uint32_t s[4] = {rk_s[0], rk_s[1], rk_s[2], __byte_perm(ctr, 0, 0x0123) ^ rk_s[3]};
#pragma unroll
  for (int rnd = 1; rnd < 10; ++rnd) {
    uint32_t t[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) t[c] = mix_column(sub_shift(s, c)) ^ rk_s[4 * rnd + c];
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = t[c];
  }
  uint32_t ks[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) ks[c] = sub_shift(s, c) ^ rk_s[40 + c];

  const int4* p = pt + 4 * row;
  int4* o = out + 4 * row;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int4 v = p[c];  // column c: bytes 4c .. 4c + 3
    v.x ^= (int)byte_of(ks[c], 0);
    v.y ^= (int)byte_of(ks[c], 1);
    v.z ^= (int)byte_of(ks[c], 2);
    v.w ^= (int)byte_of(ks[c], 3);
    o[c] = v;
  }
}

}  // namespace

// plaintext and out (n, 16) int32, round_keys (11, 16) int32, all on the device
// and 16-byte aligned; n > 0.  Returns cudaGetLastError() after the launch.
extern "C" int aes_ctr_fwd(const void* plaintext, const void* round_keys, void* out,
                           long long n, unsigned int nonce, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  aes_ctr_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int4*>(plaintext), static_cast<const int*>(round_keys),
      static_cast<int4*>(out), n, nonce);
  return (int)cudaGetLastError();
}
