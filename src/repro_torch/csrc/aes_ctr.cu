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
// batch of blocks, the bytes (64 B in and 64 B out per block, as int32): the
// 160 table lookups per block at one conflict-free 32-lane shared-memory load
// per clock per SM take half as long at the card's clock, and the
// instructions around each lookup are what a design has to keep few.
//
// What this design does about it, in two designs with one C entry point
// each.  Both hold the state in four registers, one 32-bit word per column
// (byte r of column c at bits 8r), so ShiftRows is the choice of which column
// each byte is read from, and keep every table in shared memory in 32 copies,
// one per bank (entry e of copy l at word 32 e + l), so a warp's 32 lookups
// never conflict.
//
// simt (aes_ctr_fwd), the first design: one thread per 16-byte block and a
// CTA per 256 blocks.  Only the S-box is a table (byte lookups, each packed
// back into its word); MixColumns is computed on whole words, doubling four
// bytes at once with shifts and masks: some 1,800 instructions a block.
//
// ttable (aes_ctr_ttable_fwd): one word lookup per state byte and round.
// T[x] = (2 S[x], S[x], S[x], 3 S[x]) in bytes 0..3 is SubBytes and the
// MixColumns column of a byte in row 0; rows 1..3 use T rotated left by 8 r
// bits, so a round is 16 lookups, 12 rotations and the XORs, and the index of
// a lookup is a shift and one and-or with the lane's copy.  The last round
// takes S[x], byte 1 of T[x], out of the same table.  Round 1's lookups of
// columns 0..2 read round key 0 alone, the same for every counter block, so
// each thread makes them once.  Each thread carries BLOCKS counter blocks
// through the rounds together, so that independent chains hide the
// shared-load latency, after it has issued their plaintext loads
// (non-coherent); the output goes out with streaming stores.  A warp loads
// and stores its 32 blocks' 2 KB as four coalesced 512-byte rows and hands
// each keystream column to the lane that holds it through shared memory: a
// thread's own 64 bytes as four 16-byte accesses, 64 bytes apart across the
// warp, cost the L1 pipe, which the table lookups share, four times the
// wavefronts.  The grid is persistent (at most CTAS_PER_SM CTAs an SM,
// walking the blocks with a grid stride), so each CTA builds its 32 KB table
// and passes its barrier once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // simt: a CTA per 256 blocks

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

// ---------------------------------------------------------------------------
// ttable design
namespace ttable {

constexpr int THREADS = 256;
constexpr int BLOCKS = 2;        // counter blocks a thread carries through the rounds
constexpr int CTAS_PER_SM = 2;   // the persistent grid's CTAs an SM

// T[x] as the bytes (2 S[x], S[x], S[x], 3 S[x]), from the packed S-box.
__device__ __forceinline__ uint32_t t_entry(int e) {
  const uint32_t s = (kSboxWords[e >> 2] >> (8 * (e & 3))) & 0xffu;
  const uint32_t s2 = (s << 1) ^ ((s >> 7) * 0x11bu);   // xtime, below 256
  return s2 | s << 8 | s << 16 | (s2 ^ s) << 24;
}

// The byte offset, in the table, of this lane's copy of the entry that byte R
// of w selects: 128 * byte + 4 * lane, a shift and one and-or.
template <int R>
__device__ __forceinline__ uint32_t offset_of(uint32_t w, uint32_t lane4) {
  const uint32_t sh = R == 0 ? w << 7 : w >> (8 * R - 7);
  return (sh & 0x7f80u) | lane4;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int bits) {
  return __funnelshift_l(x, x, bits);
}

struct Table {
  const char* base;
  uint32_t lane4;
  template <int R>
  __device__ __forceinline__ uint32_t at(uint32_t w) const {   // T[byte R of w]
    return *reinterpret_cast<const uint32_t*>(base + offset_of<R>(w, lane4));
  }
  // SubBytes, ShiftRows and MixColumns of output column c of the state s
  __device__ __forceinline__ uint32_t column(const uint32_t* s, int c) const {
    return at<0>(s[c]) ^ rotl(at<1>(s[(c + 1) & 3]), 8) ^ rotl(at<2>(s[(c + 2) & 3]), 16) ^
           rotl(at<3>(s[(c + 3) & 3]), 24);
  }
  // SubBytes and ShiftRows of output column c: S[x] is byte 1 of T[x]
  __device__ __forceinline__ uint32_t last_column(const uint32_t* s, int c) const {
    const uint32_t lo = __byte_perm(at<0>(s[c]), at<1>(s[(c + 1) & 3]), 0x5151);
    const uint32_t hi = __byte_perm(at<2>(s[(c + 2) & 3]), at<3>(s[(c + 3) & 3]), 0x5151);
    return __byte_perm(lo, hi, 0x5410);
  }
};

__device__ __forceinline__ int4 load_nc(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(int4* p, int4 v) {
  asm volatile("st.global.cs.v4.s32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// What a thread needs to encrypt its blocks, set up once per CTA.
struct Ctx {
  Table tab;
  uint32_t r1[4];         // round 1's lookups of columns 0..2, round key 1 added
  uint32_t k0w;           // column 3 of round key 0
  const uint4* rk;        // the packed round keys in shared memory
  uint4* ks;              // this thread's keystream block in shared memory
  const uint32_t* ks_w;   // the warp's 32 keystream blocks, as words
  int lane;
  const int4* pt;
  int4* out;
  long long n, stride;
  uint32_t nonce;
};

// Encrypt NB runs of 32 neighbouring blocks, the first at `first`, the next
// one grid stride on.  A warp loads and stores each run's 2 KB of plaintext as
// four 512-byte rows of int4: lane l of row j holds column l % 4 of block
// 8 j + l / 4.  Each thread computes the keystream of block first + lane and
// leaves it in shared memory, where the lane holding each column reads it.
template <int NB>
__device__ __forceinline__ void encrypt_runs(const Ctx& c, long long first) {
  const int lane = c.lane;
  int4 p[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long base = first + b * c.stride;
      if (base + 8 * j + lane / 4 < c.n) p[b][j] = load_nc(c.pt + 4 * base + 32 * j + lane);
    }
  }
  uint32_t s[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const uint32_t ctr = (uint32_t)(first + b * c.stride + lane) + c.nonce;   // wraps at 2^32
    const uint32_t w3 = __byte_perm(ctr, 0, 0x0123) ^ c.k0w;
    s[b][0] = c.r1[0] ^ rotl(c.tab.at<3>(w3), 24);
    s[b][1] = c.r1[1] ^ rotl(c.tab.at<2>(w3), 16);
    s[b][2] = c.r1[2] ^ rotl(c.tab.at<1>(w3), 8);
    s[b][3] = c.r1[3] ^ c.tab.at<0>(w3);
  }
#pragma unroll 1
  for (int rnd = 2; rnd < 10; ++rnd) {
    const uint4 k = c.rk[rnd];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint32_t t0 = c.tab.column(s[b], 0) ^ k.x, t1 = c.tab.column(s[b], 1) ^ k.y,
                     t2 = c.tab.column(s[b], 2) ^ k.z, t3 = c.tab.column(s[b], 3) ^ k.w;
      s[b][0] = t0;
      s[b][1] = t1;
      s[b][2] = t2;
      s[b][3] = t3;
    }
  }
  const uint4 k = c.rk[10];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const long long base = first + b * c.stride;
    __syncwarp();
    *c.ks = make_uint4(c.tab.last_column(s[b], 0) ^ k.x, c.tab.last_column(s[b], 1) ^ k.y,
                       c.tab.last_column(s[b], 2) ^ k.z, c.tab.last_column(s[b], 3) ^ k.w);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (base + 8 * j + lane / 4 < c.n) {
        const uint32_t ks = c.ks_w[32 * j + lane];   // column lane % 4 of block 8 j + lane / 4
        int4 v = p[b][j];
        v.x ^= (int)__byte_perm(ks, 0, 0x4440);
        v.y ^= (int)__byte_perm(ks, 0, 0x4441);
        v.z ^= (int)__byte_perm(ks, 0, 0x4442);
        v.w ^= (int)__byte_perm(ks, 0, 0x4443);
        store_stream(c.out + 4 * base + 32 * j + lane, v);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
kernel(const int4* __restrict__ pt, const int* __restrict__ round_keys,
       int4* __restrict__ out, long long n, uint32_t nonce) {
  __shared__ __align__(16) uint32_t tab_s[256 * 32];
  __shared__ uint4 rk_s[11];                       // round r: columns 0..3, packed
  __shared__ uint4 ks_s[THREADS];                  // each thread's keystream block
  const int tid = threadIdx.x, lane = tid & 31;
  // the table, four copies of one entry per 16-byte store
  for (int i = tid; i < 256 * 8; i += THREADS) {
    const uint32_t t = t_entry(i >> 3);
    reinterpret_cast<uint4*>(tab_s)[i] = make_uint4(t, t, t, t);
  }
  if (tid < 44) {
    const int* k = round_keys + 4 * tid;   // round tid / 4, column tid % 4
    reinterpret_cast<uint32_t*>(rk_s)[tid] =
        (uint32_t)(k[0] & 0xff) | (uint32_t)(k[1] & 0xff) << 8 |
        (uint32_t)(k[2] & 0xff) << 16 | (uint32_t)(k[3] & 0xff) << 24;
  }
  __syncthreads();

  Ctx c{{reinterpret_cast<const char*>(tab_s), 4u * lane}, {}, rk_s[0].w, rk_s, ks_s + tid,
        reinterpret_cast<const uint32_t*>(ks_s + (tid - lane)), lane, pt, out, n,
        (long long)gridDim.x * THREADS, nonce};
  // Round 1 of a counter block (k0.x, k0.y, k0.z, ctr ^ k0.w): the lookups of
  // columns 0..2, made once; column 3 adds one lookup to each output column.
  {
    const Table& tab = c.tab;
    const uint4 k0 = rk_s[0], k1 = rk_s[1];
    c.r1[0] = tab.at<0>(k0.x) ^ rotl(tab.at<1>(k0.y), 8) ^ rotl(tab.at<2>(k0.z), 16) ^ k1.x;
    c.r1[1] = tab.at<0>(k0.y) ^ rotl(tab.at<1>(k0.z), 8) ^ rotl(tab.at<3>(k0.x), 24) ^ k1.y;
    c.r1[2] = tab.at<0>(k0.z) ^ rotl(tab.at<2>(k0.x), 16) ^ rotl(tab.at<3>(k0.y), 24) ^ k1.z;
    c.r1[3] = rotl(tab.at<1>(k0.x), 8) ^ rotl(tab.at<2>(k0.y), 16) ^
              rotl(tab.at<3>(k0.z), 24) ^ k1.w;
  }
  // Each warp walks chunks of BLOCKS runs, a grid stride apart; a chunk that
  // the end of the input cuts short goes run by run.
  const long long step = BLOCKS * c.stride;
  for (long long chunk = (long long)blockIdx.x * THREADS + (tid - lane); chunk < n;
       chunk += step) {
    if (chunk + (BLOCKS - 1) * c.stride < n) {
      encrypt_runs<BLOCKS>(c, chunk);
    } else {
#pragma unroll 1
      for (long long first = chunk; first < n; first += c.stride) encrypt_runs<1>(c, first);
    }
  }
}

}  // namespace ttable

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

// The ttable design: the same operands, on a persistent grid of `grid` CTAs
// (at most CTAS_PER_SM an SM; the wrapper's ttable_grid).  Returns
// cudaGetLastError() after the launch.
extern "C" int aes_ctr_ttable_fwd(const void* plaintext, const void* round_keys, void* out,
                                  long long n, unsigned int nonce, int grid, void* stream) {
  ttable::kernel<<<grid, ttable::THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int4*>(plaintext), static_cast<const int*>(round_keys),
      static_cast<int4*>(out), n, nonce);
  return (int)cudaGetLastError();
}
