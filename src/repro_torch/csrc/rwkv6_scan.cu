// RWKV6's wkv recurrence: for every batch row b and head h, an fp32 state
// S (hd x hd) carried through time from an initial state S0 (zeros when none
// is given),
//     o_t[j]  = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j]),
//     S[i, j] = w_t[i] * S[i, j] + k_t[i] * v_t[j],
// returning o and the last state.
//
// Replaces the Pallas kernel `rwkv6_scan` (body `_wkv_kernel`) in
// src/repro/kernels/rwkv6_scan.py.  Plain version:
// repro_torch.kernels.ref.rwkv6_scan_ref.  Unlike the Pallas kernel it takes
// an initial state and any T (the Pallas grid asserts T % block_t == 0 and
// starts from zero), so the model's prefill and each one-token decode step
// both run through it.
//
// Layouts: r, k, v, w and o (B, T, H, hd); u (H, hd), all of one type, fp32
// or bf16, row-major and contiguous.  S0 and S_last (B, H, hd, hd) fp32,
// S[i, j] at i * hd + j; S_last may be S0 itself, since each thread reads its
// own part of S once before it writes it once.  The arithmetic and the state
// are fp32, and o is rounded once to the input type.
//
// What bounds it on this card: at RWKV6-1.6B's prefill (B 8, T 512, H 32,
// hd 64, fp32) the kernel must move 176 MB (r, k, v, w and o, 33.6 MB each,
// and the last state), 0.053 ms at 3.35 TB/s.  The function needs 5 fp32
// operations at each of the B * T * H * hd * hd = 537 M (i, j) updates (an FMA
// for o, since o_t[j] = sum_i r_i S[i, j] + v_j sum_i r_i u_i k_i, and a MUL
// and an FMA for S), 2.7 GFLOP, 0.041 ms at the 66.9 TFLOP/s of the CUDA
// cores: bound by the bytes.  The simt design spends 7 (it folds u_i k_i v_j
// into each term of o), cols 5.  At a decode step (T = 1) it is the state, 4.2 MB read and
// written, a few microseconds.
//
// What this design does about it: two designs, each its own C entry
// point, chosen before the launch by `route` in kernels/rwkv6_scan.py:
// `cols` (rwkv6_scan_cols_fwd) for every hd it takes, 16, 32 and 64; `simt`
// (rwkv6_scan_simt_fwd) stays reachable on its own entry point, to be timed
// beside it.
//
// simt, the first design: one block of hd threads per (batch row, head);
// thread j owns column j of S, hd floats in registers, so the output o_t[j]
// needs no reduction across threads and the update is local.  The time axis
// is cut into chunks of 2048 / hd steps.  For each chunk the block copies
// r_t, k_t, w_t and v_t into shared memory (thread j loads element j of each
// step), packing (r_i, k_i, w_i, u_i) into one float4 so that each i of a
// step is one broadcast 16-byte shared-memory load for all threads.  The sum
// over i runs in four partial sums.  What holds it back on this card: 256
// blocks of 2 warps at the serving shape, about 4 warps per SM, hide neither
// the shared loads nor the FMA chains at the prefill, nor hold enough loads
// in flight for the state at a decode step; and it spends 7 FLOP per (i, j).
//
// cols, the Hopper design: one block of 8 * hd / C threads per (batch row,
// head).  The rows i of S are cut into slices of 8, one slice per warp (two
// per warp at hd 16), and each thread holds its slice's 8 rows of C
// neighbouring columns (C = 2 at hd 64, else 1): 16 state values.  Each
// step a thread reads its 8 values of r, k and w (16-byte shared loads at
// one address for the whole warp: broadcasts) and its C of v, computes its
// slice's part of sum_i r_i S[i, j] and updates S[i, j] <- w_i S[i, j] + k_i
// v_j: 3 instructions per (i, j), the 5 FLOP the bound counts; the part goes
// to shared memory.  A chunk later each warp takes one step of the chunk:
// it sums r_i u_i k_i over the head with a shuffle reduction, and stores
// o_j = v_j * that + the slices' parts in whole rows, 2 columns a lane, so
// the u term is computed once per step and head.  The time axis is cut into
// chunks of 8 steps held in a ring of 4 stages (the chunk computed, the one
// summed, two in flight), filled by one thread with 4 TMA boxes (the head's
// rows of r, k, w, v for 8 steps; rows past the tensor's end come as zeros),
// counted on the stage's mbarrier, whose wait traps after 2^26 polls; the
// parts are double-buffered, so one block-wide barrier per chunk suffices.
// Splitting a column's i across the lanes of a warp instead (an xor-shuffle
// reduction of o per step) spends a non-uniform 16-byte shared load per 4
// rows per lane, which the shared-memory pipe cannot feed: at the serving
// prefill it ran slower than simt.
// Not done: the chunked matrix form on the tensor cores, whose per-channel
// decay needs cumulative products inside a chunk that underflow in fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"


namespace {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int HD, typename T>
__global__ void __launch_bounds__(HD)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ w, const T* __restrict__ u, const float* S0,
                  T* __restrict__ o, float* S_last, int T_len, int H) {
  constexpr int kChunk = 2048 / HD;
  __shared__ float4 rkwu_s[kChunk][HD];  // (r_i, k_i, w_i, u_i) of each staged step
  __shared__ float v_s[kChunk][HD];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const long long state = (long long)bh * HD * HD;

  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = S0 != nullptr ? S0[state + i * HD + j] : 0.f;
  const float u_j = load(u + h * HD + j);

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int steps = min(kChunk, T_len - t0);
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const long long off = (((long long)b * T_len + t0 + t) * H + h) * HD + j;
      rkwu_s[t][j] = make_float4(load(r + off), load(k + off), load(w + off), u_j);
      v_s[t][j] = load(v + off);
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float v_j = v_s[t][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float4 q = rkwu_s[t][i];  // the same address for every thread: a broadcast
        const float kv = q.y * v_j;
        acc[i & 3] = fmaf(q.x, fmaf(q.w, kv, S[i]), acc[i & 3]);
        S[i] = fmaf(q.z, S[i], kv);
      }
      const long long off = (((long long)b * T_len + t0 + t) * H + h) * HD + j;
      store(o + off, (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

#pragma unroll
  for (int i = 0; i < HD; ++i) S_last[state + i * HD + j] = S[i];
}

template <int HD, typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* S0, void* o, void* S_last, int B, int T_len, int H,
                   cudaStream_t stream) {
  rwkv6_scan_kernel<HD, T><<<B * H, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), static_cast<const float*>(S0),
      static_cast<T*>(o), static_cast<float*>(S_last), T_len, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* r, const void* k, const void* v, const void* w,
                      const void* u, const void* S0, void* o, void* S_last, int B, int T_len,
                      int H, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16, T>(r, k, v, w, u, S0, o, S_last, B, T_len, H, s);
    case 32: return launch<32, T>(r, k, v, w, u, S0, o, S_last, B, T_len, H, s);
    case 64: return launch<64, T>(r, k, v, w, u, S0, o, S_last, B, T_len, H, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The cols design (see the head of the file).

namespace cols {

constexpr int kUnroll = 4;   // steps unrolled in the inner loop
constexpr int kChunk = 8;    // time steps per stage of the ring
constexpr int kStages = 4;   // the chunk computed, the one summed, two in flight
constexpr int kRows = 8;     // rows i of S per thread

template <int HD>
struct Cfg {
  static constexpr int C = HD == 64 ? 2 : 1;  // neighbouring columns per thread
  static constexpr int CW = HD / C;           // threads per slice of rows
  static constexpr int NS = HD / kRows;       // slices of rows: their parts of o are summed
  static constexpr int NT = NS * CW;          // threads per block: 256, 128, 32 at hd 64, 32, 16
  static constexpr int NW = NT / 32;          // warps per block
  static constexpr int UPL = (HD + 31) / 32;  // values of i (and j) per lane in the sums
};

template <int HD, typename T>
struct Smem {
  alignas(128) T r[kStages][kChunk][HD];  // TMA writes whole boxes, 128-byte aligned
  alignas(128) T k[kStages][kChunk][HD];
  alignas(128) T w[kStages][kChunk][HD];
  alignas(128) T v[kStages][kChunk][HD];
  alignas(16) float part[2][Cfg<HD>::NS][kChunk][HD];  // each slice's part of o, double-buffered
  uint64_t full[kStages];                              // a stage's four boxes have landed
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The 8 values of a thread's rows: two 16-byte loads in fp32, one in bf16,
// each at the same address for the whole warp (a broadcast).
__device__ __forceinline__ void load_rows(const float* p, float (&x)[kRows]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p, float (&x)[kRows]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float2 f = hopper::unpack_bf16(words[n]);
    x[2 * n] = f.x, x[2 * n + 1] = f.y;
  }
}

// C neighbouring values (C = 1, 2 or 4; aligned to C elements).
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[C]) {
  if constexpr (C == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  } else if constexpr (C == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  } else {
    x[0] = *p;
  }
}
template <int C>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&x)[C]) {
  if constexpr (C == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const float2 lo = hopper::unpack_bf16(a.x), hi = hopper::unpack_bf16(a.y);
    x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
  } else if constexpr (C == 2) {
    const float2 a = hopper::unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
    x[0] = a.x, x[1] = a.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[C]) {
  if constexpr (C == 4) *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (C == 2) *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else *p = x[0];
}
template <int C>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p, const float (&x)[C]) {
  if constexpr (C == 2) *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(x[0], x[1]);
  else *p = __float2bfloat16(x[0]);
}

// Block (batch row * H + head); thread tid holds rows s * 8 .. s * 8 + 7 of
// columns C * l .. C * l + C - 1, s = tid / CW and l = tid % CW: a warp's
// threads share their rows, so every shared load of r, k and w is a
// broadcast.
template <int HD, typename T>
__global__ void __launch_bounds__(Cfg<HD>::NT, Cfg<HD>::NT >= 512 ? 1 : 512 / Cfg<HD>::NT)
rwkv6_scan_cols_kernel(const __grid_constant__ CUtensorMap tm_r,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_w, const T* __restrict__ u,
                       const float* S0, T* __restrict__ o, float* S_last, int T_len, int H) {
  using Cf = Cfg<HD>;
  constexpr int C = Cf::C, CW = Cf::CW, NS = Cf::NS, NT = Cf::NT, NW = Cf::NW;
  constexpr int UPL = Cf::UPL;
  // The kernel declares no static shared memory, so the dynamic block
  // starts at the block's window, aligned for TMA; a misaligned box would
  // fault, not pass silently.  (Rounding the pointer up at run time costs
  // every shared access a base register: a fifth of the prefill's time.)
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Smem<HD, T>& sm = *reinterpret_cast<Smem<HD, T>*>(smem_raw);
  const int tid = threadIdx.x, s = tid / CW, j0 = C * (tid % CW), i0 = s * kRows;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const long long state = (long long)bh * HD * HD;
  const long long row0 = (long long)b * T_len;  // (b, t = 0) in the (B * T) steps
  const int n_chunks = (T_len + kChunk - 1) / kChunk;

  // Chunk c into its stage: one thread asks TMA for four boxes, the head's
  // rows of r, k, w and v for kChunk steps (rows past the tensor's end come
  // as zeros and count too), all counted on the stage's barrier.
  auto fill = [&](int c) {
    if (tid == 0) {
      const int st = c % kStages, row = (int)(row0 + c * kChunk);
      hopper::mbar_arrive_expect_tx(&sm.full[st], 4 * kChunk * HD * sizeof(T));
      hopper::tma_load_3d(sm.r[st], &tm_r, &sm.full[st], 0, h, row);
      hopper::tma_load_3d(sm.k[st], &tm_k, &sm.full[st], 0, h, row);
      hopper::tma_load_3d(sm.w[st], &tm_w, &sm.full[st], 0, h, row);
      hopper::tma_load_3d(sm.v[st], &tm_v, &sm.full[st], 0, h, row);
    }
  };
  float uu[UPL];  // u_i for i = lane + 32 n, for the sums of r u k
#pragma unroll
  for (int n = 0; n < UPL; ++n) uu[n] = lane + 32 * n < HD ? to_f(u[h * HD + lane + 32 * n]) : 0.f;
  // o of a computed chunk, one step a warp at a time: the warp's own sum of
  // r_i u_i k_i, times v_j, plus the slices' parts; stored in whole rows, CO
  // neighbouring columns a lane.
  auto store_o = [&](int st, int buf, int t0, int steps) {
    constexpr int CO = HD >= 64 ? 2 : 1;
    for (int t = warp; t < steps; t += NW) {
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < UPL; ++n) {
        const int i = lane + 32 * n;
        if (i < HD) sum = fmaf(to_f(sm.r[st][t][i]) * uu[n], to_f(sm.k[st][t][i]), sum);
      }
#pragma unroll
      for (int m = 16; m >= 1; m /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
#pragma unroll
      for (int jj = CO * lane; jj < HD; jj += 32 * CO) {
        float acc[CO];
        load_cols<CO>(&sm.v[st][t][jj], acc);
#pragma unroll
        for (int m = 0; m < CO; ++m) acc[m] *= sum;
#pragma unroll
        for (int p = 0; p < NS; ++p) {
          float pv[CO];
          load_cols<CO>(&sm.part[buf][p][t][jj], pv);
#pragma unroll
          for (int m = 0; m < CO; ++m) acc[m] += pv[m];
        }
        store_cols<CO>(o + ((row0 + t0 + t) * H + h) * HD + jj, acc);
      }
    }
  };

  // Thread 0 sets up the barriers and starts the first chunks' TMA at once
  // (their latency leads a decode step); the state's loads go out meanwhile.
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&sm.full[st], 1);
    hopper::mbar_fence_init();
    for (int c = 0; c < kStages - 2 && c < n_chunks; ++c) fill(c);
  }
  float Sv[kRows][C];
#pragma unroll
  for (int e = 0; e < kRows; ++e)
#pragma unroll
    for (int m = 0; m < C; ++m)
      Sv[e][m] = S0 != nullptr ? S0[state + (long long)(i0 + e) * HD + j0 + m] : 0.f;
  __syncthreads();  // the barriers are set up before anyone waits on them

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, steps = min(kChunk, T_len - t0), st = c % kStages;
    hopper::mbar_wait(&sm.full[st], (c / kStages) & 1);  // chunk c has landed
    // Everyone is done computing chunk c - 1 and summing chunk c - 2, whose
    // stage is refilled now.
    __syncthreads();
    const int next = c + kStages - 2;
    if (next < n_chunks) fill(next);
    if (c > 0) store_o((c - 1) % kStages, (c - 1) & 1, t0 - kChunk, kChunk);
    float(*part)[kChunk][HD] = sm.part[c & 1];
#pragma unroll kUnroll
    for (int t = 0; t < steps; ++t) {
      float rv[kRows], kv[kRows], wv[kRows], vj[C];
      load_rows(&sm.r[st][t][i0], rv);
      load_rows(&sm.k[st][t][i0], kv);
      load_rows(&sm.w[st][t][i0], wv);
      load_cols<C>(&sm.v[st][t][j0], vj);
      float p0[C], p1[C];
#pragma unroll
      for (int m = 0; m < C; ++m) p0[m] = p1[m] = 0.f;
#pragma unroll
      for (int e = 0; e < kRows; ++e)
#pragma unroll
        for (int m = 0; m < C; ++m) {
          float& x = Sv[e][m];
          if (e & 1) p1[m] = fmaf(rv[e], x, p1[m]);
          else p0[m] = fmaf(rv[e], x, p0[m]);
          x = fmaf(wv[e], x, kv[e] * vj[m]);
        }
      float pv[C];
#pragma unroll
      for (int m = 0; m < C; ++m) pv[m] = p0[m] + p1[m];
      store_cols<C>(&part[s][t][j0], pv);
    }
  }
  __syncthreads();
  const int last = n_chunks - 1;
  store_o(last % kStages, last & 1, last * kChunk, T_len - last * kChunk);
#pragma unroll
  for (int e = 0; e < kRows; ++e)
#pragma unroll
    for (int m = 0; m < C; ++m) S_last[state + (long long)(i0 + e) * HD + j0 + m] = Sv[e][m];
}

template <int HD, typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* S0, void* o, void* S_last, int B, int T_len, int H,
                   cudaStream_t stream) {
  constexpr int bytes = sizeof(Smem<HD, T>);
  static const cudaError_t set = cudaFuncSetAttribute(
      rwkv6_scan_cols_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  // each (B * T, H, hd) tensor in boxes of one head's rows for kChunk steps
  CUtensorMap maps[4];
  const void* bases[4] = {r, k, v, w};
  for (int n = 0; n < 4; ++n)
    if (!hopper::encode_3d(&maps[n], sizeof(T), bases[n], HD, H, (uint64_t)B * T_len, HD,
                           (uint64_t)H * HD, HD, 1, kChunk, 0))
      return cudaErrorInvalidValue;
  rwkv6_scan_cols_kernel<HD, T><<<B * H, Cfg<HD>::NT, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(u),
      static_cast<const float*>(S0), static_cast<T*>(o), static_cast<float*>(S_last), T_len, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* r, const void* k, const void* v, const void* w,
                      const void* u, const void* S0, void* o, void* S_last, int B, int T_len,
                      int H, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16, T>(r, k, v, w, u, S0, o, S_last, B, T_len, H, s);
    case 32: return launch<32, T>(r, k, v, w, u, S0, o, S_last, B, T_len, H, s);
    case 64: return launch<64, T>(r, k, v, w, u, S0, o, S_last, B, T_len, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int smem_bytes(int hd) {
  return hd == 16 ? (int)sizeof(Smem<16, T>) : hd == 32 ? (int)sizeof(Smem<32, T>)
                                             : hd == 64 ? (int)sizeof(Smem<64, T>) : -1;
}

}  // namespace cols

}  // namespace

// r, k, v, w, o (B, T, H, hd); u (H, hd), contiguous on the device in one type
// (dtype 0 = float32, 1 = bfloat16); S0 (B, H, hd, hd) fp32 or null for zeros;
// S_last (B, H, hd, hd) fp32, which may be S0.  B, T, H > 0, B * H < 2**31,
// hd in {16, 32, 64}.  Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
extern "C" int rwkv6_scan_simt_fwd(const void* r, const void* k, const void* v, const void* w,
                                   const void* u, const void* S0, void* o, void* S_last, int B,
                                   int T_len, int H, int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>(r, k, v, w, u, S0, o, S_last, B, T_len, H, hd, s);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(r, k, v, w, u, S0, o, S_last, B, T_len, H, hd, s);
  return (int)cudaErrorInvalidValue;
}

// The cols design: the same arguments and the same hd.
extern "C" int rwkv6_scan_cols_fwd(const void* r, const void* k, const void* v, const void* w,
                                   const void* u, const void* S0, void* o, void* S_last, int B,
                                   int T_len, int H, int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)cols::launch_hd<float>(r, k, v, w, u, S0, o, S_last, B, T_len, H, hd, s);
  if (dtype == 1)
    return (int)cols::launch_hd<__nv_bfloat16>(r, k, v, w, u, S0, o, S_last, B, T_len, H, hd,
                                               s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block of the cols design (dtype 0 = float32, 1 =
// bfloat16; -1 for an hd it does not take), for the wrapper's launch
// geometry to be checked against.
extern "C" int rwkv6_scan_cols_smem_bytes(int hd, int dtype) {
  return dtype == 0 ? cols::smem_bytes<float>(hd) : cols::smem_bytes<__nv_bfloat16>(hd);
}
