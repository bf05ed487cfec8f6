// RWKV6's wkv recurrence: for every batch row b and head h, an fp32 state
// S (hd x hd) carried through time from an initial state S0 (zeros when none
// is given),
//     o_t[j]  = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j]),
//     S[i, j] = w_t[i] * S[i, j] + k_t[i] * v_t[j],
// returning o and the last state; and its backward in two designs (entries
// rwkv6_scan_bwd_ring, the route, and rwkv6_scan_bwd, the previous one,
// noted where they begin, below the two forward designs).
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

// ---------------------------------------------------------------------------
// The backward (entry rwkv6_scan_bwd): the gradients of the recurrence by r,
// k, v, w, u and S0, from g = do, the cotangent of o, and dS_last, that of
// the last state.  The JAX package has no Pallas backward (it differentiates
// its chunked linear_scan_emit); plain version:
// repro_torch.kernels.ref.rwkv6_scan_bwd_ref.  A walk back carries
// Lambda_t = dL/dS_t, Lambda_T = dS_last and Lambda_{t-1} = diag(w_t)
// Lambda_t + r_t g_t^T, and per head
//     dr_t = (S_{t-1} + diag(u) k_t v_t^T) g_t,   dk_t = Lambda_t v_t + u r_t (v_t . g_t),
//     dv_t = Lambda_t^T k_t + (r_t . (u k_t)) g_t,  dw_t[i] = sum_j Lambda_t[i, j] S_{t-1}[i, j],
//     du = sum_{b, t} r_t k_t (v_t . g_t),          dS0 = Lambda_0.
//
// What bounds it on this card: at RWKV6-1.6B's training shape (B 8, T 512,
// H 32, hd 64, fp32) the function must read r, k, v, w and do and write dr,
// dk, dv and dw, 33.6 MB each, about 302 MB, 0.090 ms at 3.35 TB/s; it needs
// about 10 fp32 operations at each of the B * T * H * hd * hd = 537 M (i, j)
// steps (the state and Lambda updated, a MUL and an FMA each; an FMA each
// for dr, dk, dv and dw), 5.4 GFLOP, 0.080 ms on the CUDA cores: about 0.09
// ms either way.
//
// What this design does about it (the simple design, `rows`): the state
// does not run backward either (S_{t-1} = (S_t - k_t v_t^T) / w_t, and w can
// be near 0), and the autograd function saves its inputs, not the states.
// One block of 4 hd threads per (batch row, head); thread (i, p) holds row i
// of S and of Lambda at the hd / 4 columns 16 m + 4 p .. + 3, so dr, dk and
// dw sum inside the thread and over its row's 4 lanes (2 shuffles each).
// A forward sweep carries S from S0, gives dr a step at a time and writes S
// every kChunk = 4 steps to a checkpoint buffer (B, H, T / 4, hd, hd) fp32
// (537 MB at the shape above); the walk back takes the chunks from the
// last, recomputes the chunk's 4 states S_{t-1} from its checkpoint into
// shared memory (4 x 16 KB at hd 64) and steps back through them.  dv sums
// over the rows: each step the warp's 8 rows are summed by xor-shuffles
// that halve the values a lane holds, and the warps' sums are added in a
// fixed order at the end of the chunk.  A chunk's r, k, v, w and do are
// staged in shared memory, its dr, dk, dw and dv stored a chunk at a time.
// du sums over batch rows and time: each block writes its (hd) partial and
// a second kernel adds the batch rows' in order; no atomics.  Chunks of 4
// keep a block's shared memory at 80 KB at hd 64, so two blocks of 256
// threads share an SM and the 256 blocks of the shape above run in one
// wave (chunks of 8, 160 KB, one block an SM and two waves: 2.05 ms on the
// H100).  Cost over the bound: the checkpoints written and read (1.07 GB),
// the states computed twice, a block-wide barrier and a staging load every
// 4 steps, and 16 warps an SM to hide the step's chains of FMAs and
// shuffles.

namespace bwd {

constexpr int kChunk = 4;   // steps between checkpoints, and recomputed at once
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Cfg {
  static constexpr int NT = 4 * HD;   // threads: 4 lanes a row
  static constexpr int CPT = HD / 4;  // columns a thread
  static constexpr int M = CPT / 4;   // float4s a thread
  static constexpr int W = NT / 32;   // warps, 8 rows each
};

template <int HD>
struct Smem {
  float k[kChunk][HD], v[kChunk][HD], w[kChunk][HD], g[kChunk][HD], r[kChunk][HD];
  float4 hist[kChunk][Cfg<HD>::M][Cfg<HD>::NT];  // S_{t-1} of each step of the chunk
  float red[kChunk][Cfg<HD>::W][HD];             // each warp's sums of dv
  float dr[kChunk][HD], dk[kChunk][HD], dw[kChunk][HD];
};

// A chunk's k, v, w, do (and r, for the walk back) into shared memory,
// zeros past T.
template <int HD, typename T>
__device__ __forceinline__ void stage(Smem<HD>& sm, const T* k, const T* v, const T* w,
                                      const T* g, const T* r, bool with_r, int b, int h,
                                      int H, int T_len, int t0, int steps) {
  float* dst = &sm.k[0][0];
  const int n_src = with_r ? 5 : 4;
  for (int e = threadIdx.x; e < n_src * kChunk * HD; e += Cfg<HD>::NT) {
    const int which = e / (kChunk * HD), rem = e - which * (kChunk * HD);
    const int s = rem / HD, col = rem - s * HD;
    const T* src = which == 0 ? k : which == 1 ? v : which == 2 ? w : which == 3 ? g : r;
    dst[which * kChunk * HD + rem] =
        s < steps ? load(src + (((long long)b * T_len + t0 + s) * H + h) * HD + col) : 0.f;
  }
}

// One round of the dv reduction over a warp's rows: with N > 1 values a
// lane keeps half (the upper half if its bit m is set), sends the other
// half to lane ^ m and adds what it gets; with one value it adds the
// partner's, and the pair holds the same sum (`dup`).  N is a template
// argument so that every index into the register array is a constant.
template <int N>
__device__ __forceinline__ void halve_rows(float* v, int lane, int m, int& base, int& dup) {
  if constexpr (N > 1) {
    const bool hi = lane & m;
#pragma unroll
    for (int kk = 0; kk < N / 2; ++kk) {
      const float send = hi ? v[kk] : v[kk + N / 2];
      const float keep = hi ? v[kk + N / 2] : v[kk];
      v[kk] = keep + __shfl_xor_sync(kFull, send, m);
    }
    base += hi ? N / 2 : 0;
  } else {
    v[0] += __shfl_xor_sync(kFull, v[0], m);
    dup |= m;
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(Cfg<HD>::NT, 2)
rwkv6_scan_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ w, const T* __restrict__ u,
                      const float* __restrict__ S0, const T* __restrict__ dout,
                      const float* __restrict__ dS_last, float* __restrict__ ckpt,
                      T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                      T* __restrict__ dw, float* __restrict__ du_part,
                      float* __restrict__ dS0, int T_len, int H) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int tid = threadIdx.x, i = tid >> 2, p = tid & 3, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  const long long row = (long long)bh * HD * HD + (long long)i * HD;  // row i of the state
  const float ui = load(u + h * HD + i);
  // this thread's float4 m of chunk c's checkpoint: ck[c * ck_stride + 4 m]
  float4* ck = reinterpret_cast<float4*>(ckpt) + ((long long)bh * n_chunks * HD + i) * (HD / 4) + p;
  constexpr long long ck_stride = (long long)HD * HD / 4;

  float4 Sv[C::M];
#pragma unroll
  for (int m = 0; m < C::M; ++m)
    Sv[m] = S0 != nullptr ? *reinterpret_cast<const float4*>(S0 + row + 16 * m + 4 * p)
                          : make_float4(0.f, 0.f, 0.f, 0.f);

  // the forward sweep: dr, and the state at the start of every chunk
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, steps = min(kChunk, T_len - t0);
    __syncthreads();
    stage<HD, T>(sm, k, v, w, dout, r, false, b, h, H, T_len, t0, steps);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < C::M; ++m) ck[c * ck_stride + 4 * m] = Sv[m];
    for (int s = 0; s < steps; ++s) {
      const float ki = sm.k[s][i], wi = sm.w[s][i];
      float part = 0.f, vg = 0.f;
#pragma unroll
      for (int m = 0; m < C::M; ++m) {
        const float4 v4 = *reinterpret_cast<const float4*>(&sm.v[s][16 * m + 4 * p]);
        const float4 g4 = *reinterpret_cast<const float4*>(&sm.g[s][16 * m + 4 * p]);
        float4& S = Sv[m];
        part = fmaf(S.x, g4.x, fmaf(S.y, g4.y, fmaf(S.z, g4.z, fmaf(S.w, g4.w, part))));
        vg = fmaf(v4.x, g4.x, fmaf(v4.y, g4.y, fmaf(v4.z, g4.z, fmaf(v4.w, g4.w, vg))));
        S.x = fmaf(wi, S.x, ki * v4.x);
        S.y = fmaf(wi, S.y, ki * v4.y);
        S.z = fmaf(wi, S.z, ki * v4.z);
        S.w = fmaf(wi, S.w, ki * v4.w);
      }
      part = fmaf(ui * ki, vg, part);
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      if (p == 0) sm.dr[s][i] = part;
    }
    __syncthreads();
    for (int e = tid; e < steps * HD; e += C::NT) {
      const int s = e / HD, col = e - s * HD;
      store(dr + (((long long)b * T_len + t0 + s) * H + h) * HD + col, sm.dr[s][col]);
    }
  }

  // the walk back
  float4 L[C::M];
#pragma unroll
  for (int m = 0; m < C::M; ++m)
    L[m] = dS_last != nullptr ? *reinterpret_cast<const float4*>(dS_last + row + 16 * m + 4 * p)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  float du_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, steps = min(kChunk, T_len - t0);
    __syncthreads();  // everyone is done with the previous chunk's shared memory
    stage<HD, T>(sm, k, v, w, dout, r, true, b, h, H, T_len, t0, steps);
    __syncthreads();
    float4 P[C::M];
#pragma unroll
    for (int m = 0; m < C::M; ++m) P[m] = ck[c * ck_stride + 4 * m];
    for (int s = 0; s < steps; ++s) {  // the chunk's states again: S_{t-1} of each step
      const float ki = sm.k[s][i], wi = sm.w[s][i];
#pragma unroll
      for (int m = 0; m < C::M; ++m) {
        sm.hist[s][m][tid] = P[m];
        const float4 v4 = *reinterpret_cast<const float4*>(&sm.v[s][16 * m + 4 * p]);
        P[m].x = fmaf(wi, P[m].x, ki * v4.x);
        P[m].y = fmaf(wi, P[m].y, ki * v4.y);
        P[m].z = fmaf(wi, P[m].z, ki * v4.z);
        P[m].w = fmaf(wi, P[m].w, ki * v4.w);
      }
    }
    for (int s = steps - 1; s >= 0; --s) {
      const float ri = sm.r[s][i], ki = sm.k[s][i], wi = sm.w[s][i];
      const float ruk = ri * ui * ki;
      float pk = 0.f, pw = 0.f, vg = 0.f, dvp[C::CPT];
#pragma unroll
      for (int m = 0; m < C::M; ++m) {
        const float4 v4 = *reinterpret_cast<const float4*>(&sm.v[s][16 * m + 4 * p]);
        const float4 g4 = *reinterpret_cast<const float4*>(&sm.g[s][16 * m + 4 * p]);
        const float4 Sp = sm.hist[s][m][tid];
        float4& Lm = L[m];
        vg = fmaf(v4.x, g4.x, fmaf(v4.y, g4.y, fmaf(v4.z, g4.z, fmaf(v4.w, g4.w, vg))));
        pk = fmaf(Lm.x, v4.x, fmaf(Lm.y, v4.y, fmaf(Lm.z, v4.z, fmaf(Lm.w, v4.w, pk))));
        pw = fmaf(Lm.x, Sp.x, fmaf(Lm.y, Sp.y, fmaf(Lm.z, Sp.z, fmaf(Lm.w, Sp.w, pw))));
        dvp[4 * m + 0] = fmaf(Lm.x, ki, ruk * g4.x);
        dvp[4 * m + 1] = fmaf(Lm.y, ki, ruk * g4.y);
        dvp[4 * m + 2] = fmaf(Lm.z, ki, ruk * g4.z);
        dvp[4 * m + 3] = fmaf(Lm.w, ki, ruk * g4.w);
        Lm.x = fmaf(wi, Lm.x, ri * g4.x);
        Lm.y = fmaf(wi, Lm.y, ri * g4.y);
        Lm.z = fmaf(wi, Lm.z, ri * g4.z);
        Lm.w = fmaf(wi, Lm.w, ri * g4.w);
      }
      pk = fmaf(ui * ri, vg, pk);
      du_acc = fmaf(ri * ki, vg, du_acc);
      {  // dk (lanes 0, 1) and dw (lanes 2, 3) over the row's 4 lanes
        const bool hi = p & 2;
        float t = (hi ? pw : pk) + __shfl_xor_sync(kFull, hi ? pk : pw, 2);
        t += __shfl_xor_sync(kFull, t, 1);
        if (p == 0) sm.dk[s][i] = t;
        if (p == 2) sm.dw[s][i] = t;
      }
      // dv over the warp's 8 rows (lane bits 2..4): halve the values a lane
      // holds while it holds more than one, then add what is left; the lane
      // ends with its values base .. base + n - 1 of the thread's columns
      int base = 0, dup = 0;
      constexpr int N1 = C::CPT > 1 ? C::CPT / 2 : 1, N2 = N1 > 1 ? N1 / 2 : 1;
      constexpr int NF = N2 > 1 ? N2 / 2 : 1;
      halve_rows<C::CPT>(dvp, lane, 16, base, dup);
      halve_rows<N1>(dvp, lane, 8, base, dup);
      halve_rows<N2>(dvp, lane, 4, base, dup);
      if (!(lane & dup)) {
#pragma unroll
        for (int kk = 0; kk < NF; ++kk) {
          const int idx = base + kk;
          sm.red[s][warp][16 * (idx >> 2) + 4 * p + (idx & 3)] = dvp[kk];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < steps * HD; e += C::NT) {
      const int s = e / HD, col = e - s * HD;
      float acc = 0.f;
#pragma unroll
      for (int wv = 0; wv < C::W; ++wv) acc += sm.red[s][wv][col];
      const long long off = (((long long)b * T_len + t0 + s) * H + h) * HD + col;
      store(dv + off, acc);
      store(dk + off, sm.dk[s][col]);
      store(dw + off, sm.dw[s][col]);
    }
  }
  if (dS0 != nullptr) {
#pragma unroll
    for (int m = 0; m < C::M; ++m)
      *reinterpret_cast<float4*>(dS0 + row + 16 * m + 4 * p) = L[m];
  }
  du_acc += __shfl_xor_sync(kFull, du_acc, 1);
  du_acc += __shfl_xor_sync(kFull, du_acc, 2);
  if (p == 0) du_part[(long long)bh * HD + i] = du_acc;
}

// The second pass: du at each (h, i), the batch rows' partials added in order.
template <typename T>
__global__ void __launch_bounds__(256)
rwkv6_scan_bwd_sum_kernel(const float* __restrict__ du_part, T* __restrict__ du, int B, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;   // h hd + i
  if (e >= n) return;
  float acc = 0.f;
  for (int bb = 0; bb < B; ++bb) acc += du_part[(long long)bb * n + e];
  store(du + e, acc);
}

template <int HD, typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* S0, const void* dout, const void* dS_last, void* ckpt,
                   void* du_part, void* dr, void* dk, void* dv, void* dw, void* du, void* dS0,
                   int B, int T_len, int H, cudaStream_t stream) {
  constexpr int bytes = sizeof(Smem<HD>);
  static const cudaError_t set = cudaFuncSetAttribute(
      rwkv6_scan_bwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  rwkv6_scan_bwd_kernel<HD, T><<<B * H, Cfg<HD>::NT, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), static_cast<const float*>(S0),
      static_cast<const T*>(dout), static_cast<const float*>(dS_last),
      static_cast<float*>(ckpt), static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<T*>(dw), static_cast<float*>(du_part),
      static_cast<float*>(dS0), T_len, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rwkv6_scan_bwd_sum_kernel<T><<<(H * HD + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<T*>(du), B, H * HD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* r, const void* k, const void* v, const void* w,
                      const void* u, const void* S0, const void* dout, const void* dS_last,
                      void* ckpt, void* du_part, void* dr, void* dk, void* dv, void* dw,
                      void* du, void* dS0, int B, int T_len, int H, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16, T>(r, k, v, w, u, S0, dout, dS_last, ckpt, du_part, dr, dk, dv,
                                  dw, du, dS0, B, T_len, H, s);
    case 32: return launch<32, T>(r, k, v, w, u, S0, dout, dS_last, ckpt, du_part, dr, dk, dv,
                                  dw, du, dS0, B, T_len, H, s);
    case 64: return launch<64, T>(r, k, v, w, u, S0, dout, dS_last, ckpt, du_part, dr, dk, dv,
                                  dw, du, dS0, B, T_len, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// The ring design of the backward (entry rwkv6_scan_bwd_ring), the route at
// every hd: the same gradients as `rows`, by another walk.
//
// What held `rows` back: a chunk's inputs staged through registers between
// two barriers every 4 steps, the checkpoint read waiting behind them, and
// only 2 blocks an SM to cover both; 1.07 GB of checkpoints written and read;
// dr taken in the forward sweep, so the state was walked three times at 4 FMA
// an (i, j) there; v . g summed again by every thread.
//
// What this design does: one block of hd * hd / 8 threads per (batch row,
// head), 512 at hd 64; thread (i, p) holds 8 values of row i of S and of its
// cotangent Lambda, columns 4p .. 4p + 3 and hd/2 + 4p .. + 3, so the row's
// hd / 8 lanes sum dr, dk and dw in log2(hd / 8) rounds of xor-shuffles that
// halve the values a lane holds ([dk, dw, dr, 0]: 4 shuffles at hd 64).
// - A ring of 3 stages, each one chunk of K = 16 steps of r, k, v, w and do
//   brought by TMA (k, v and w only in the forward sweep), filled by one
//   thread two chunks ahead, in time order for the sweep and in reverse for
//   the walk back, counted on the stage's mbarrier (whose wait traps after
//   2^26 polls).  The chunk's checkpoint comes by one bulk copy into one of
//   two buffers, one chunk ahead.
// - The forward sweep only advances S (2 operations an (i, j)) and writes it
//   every K = 16 steps: (B, H, ceil(T / 16), hd, hd) fp32, 134 MB each way
//   at the shape above, not 1.07 GB.
// - The walk back takes a chunk's 16 states in two levels: from the
//   checkpoint it recomputes S at steps 4, 8 and 12 (kept in shared memory,
//   48 KB at hd 64) and the last piece's states; each earlier piece of 4
//   steps is recomputed again from its first state.  A piece's three states
//   stay in registers (24 a thread), its 4 steps unrolled; sixteen states of
//   a head (256 KB at hd 64) would not fit a block.
// - dr_t = S_{t-1} g_t + u k_t (v_t . g_t) is taken in the walk back, from
//   the recomputed S_{t-1}; v_t . g_t and r_t . (u k_t) are summed once a
//   step by one warp, so that dv's u term is added once, by warp 0.
// - dv sums over the rows: each step a warp's 4 rows are summed by the
//   halving xor-shuffles (2 rounds at hd 64), each warp's sums go to shared
//   memory, double-buffered by piece, and are added in warp order after the
//   next piece's barrier: one block-wide barrier every 4 steps, which also
//   frees a chunk's stage and checkpoint buffer for the refill.
// Per (i, j) and step: 2 operations in the sweep, 3 in the two recomputes,
// 6 in the walk back (the dr, dk, dw and dv FMAs and Lambda's update), 11
// against rows' 13 and the bound's 10.  K = 4 (one level, the checkpoint
// spacing of rows) stays reachable through the same entry, for timing.
// Each full piece (and each full chunk's first level) runs its unrolled
// steps with no bound check between them, so that the compiler interleaves
// one step's shuffle sums with the next step's arithmetic.  What still holds
// it back: one block of 16 warps an SM, latency-bound, most of it in the
// lanes' shuffle sums of dk, dw, dr and dv a step.

namespace ring {

constexpr int kPiece = 4;   // steps recomputed at once into the history
constexpr int kStages = 3;  // the chunk walked, two in flight
constexpr int kIn = 5;      // r, k, v, w, do: a stage's boxes
enum { R_ = 0, K_ = 1, V_ = 2, W_ = 3, G_ = 4 };

// kRuns runs of 4 neighbouring columns a thread: 8 values, hd / 8 lanes a
// row.  (4 values, hd / 4 lanes and 32 warps an SM at hd 64, ran slower on
// the H100: the lanes' sums then take more shuffles than the warps hide.)
constexpr int kRuns = 2;

template <int HD>
struct Cfg {
  static constexpr int R = kRuns;
  static constexpr int V = 4 * R;                    // values a thread holds
  static constexpr int LPR = HD / V;                 // lanes of a row
  static constexpr int NT = HD * LPR;                // threads
  static constexpr int NW = NT / 32;                 // warps
  static constexpr int RPW = 32 / LPR;               // rows a warp
  static constexpr int RUN = HD / R;                 // from one run of columns to the next
  static constexpr int NR = LPR >= 4 ? 1 : 4 / LPR;  // row sums a lane holds after the halving
  static constexpr int DVN = V / RPW > 1 ? V / RPW : 1;  // dv values a lane holds after it
  static constexpr int UPL = (HD + 31) / 32;         // values of j per lane in v . g
};

template <int HD, typename T, int K>
struct Smem {
  static constexpr int NT = Cfg<HD>::NT;
  static constexpr int R = kRuns;
  static constexpr int NSUB = K / kPiece > 1 ? K / kPiece - 1 : 1;
  alignas(128) T in[kStages][kIn][K][HD];          // a chunk's rows of r, k, v, w, do (TMA)
  alignas(16) float ck[2][HD * HD];                 // a chunk's checkpoint, row-major (bulk copy)
  alignas(16) float4 sub[NSUB][R][NT];              // S at chunk steps 4, 8, 12, a thread's values
  alignas(16) float red[2][kPiece][Cfg<HD>::NW][HD];  // each warp's sums of dv, by piece
  float vg[kStages][K], rk[kStages][K];             // v . g and r . (u k) of each step
  uint64_t full[kStages], ckfull[2];
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = hopper::unpack_bf16(a.x), hi = hopper::unpack_bf16(a.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Halve N values over lane bits M, M / 2, .. STOP (bwd::halve_rows each round).
template <int N, int M, int STOP>
__device__ __forceinline__ void halve_bits(float* v, int lane, int& base, int& dup) {
  if constexpr (M >= STOP) {
    bwd::halve_rows<N>(v, lane, M, base, dup);
    halve_bits<(N > 1 ? N / 2 : 1), M / 2, STOP>(v, lane, base, dup);
  }
}

// A thread's R runs of 4 values of a row at columns c + RUN r, as floats.
template <int R, int RUN, typename T>
__device__ __forceinline__ void load_runs(const T* p, int c, float (&x)[4 * R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 a = ld4(p + c + RUN * r);
    x[4 * r] = a.x, x[4 * r + 1] = a.y, x[4 * r + 2] = a.z, x[4 * r + 3] = a.w;
  }
}
template <int R, int RUN>
__device__ __forceinline__ void store_runs(float* p, int c, const float (&x)[4 * R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float4*>(p + c + RUN * r) =
        make_float4(x[4 * r], x[4 * r + 1], x[4 * r + 2], x[4 * r + 3]);
}

// S <- diag(w_t) S + k_t v_t^T on a thread's values of row i.
template <int R, int RUN, typename T>
__device__ __forceinline__ void advance(float (&S)[4 * R], const T* kr, const T* wr, const T* vr,
                                        int i, int c) {
  const float ki = cols::to_f(kr[i]), wi = cols::to_f(wr[i]);
  float v[4 * R];
  load_runs<R, RUN>(vr, c, v);
#pragma unroll
  for (int e = 0; e < 4 * R; ++e) S[e] = fmaf(wi, S[e], ki * v[e]);
}

template <int HD, typename T, int K>
__global__ void __launch_bounds__(Cfg<HD>::NT, 1)
rwkv6_scan_bwd_ring_kernel(const __grid_constant__ CUtensorMap tm_r,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_w,
                           const __grid_constant__ CUtensorMap tm_g, const T* __restrict__ u,
                           const float* __restrict__ S0, const float* __restrict__ dS_last,
                           float* __restrict__ ckpt, T* __restrict__ dr, T* __restrict__ dk,
                           T* __restrict__ dv, T* __restrict__ dw, float* __restrict__ du_part,
                           float* __restrict__ dS0, int T_len, int H) {
  using C = Cfg<HD>;
  using Sm = Smem<HD, T, K>;
  constexpr int R = C::R, V = C::V, RUN = C::RUN;
  // no static shared memory: the dynamic block starts at the window, aligned for TMA
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x, i = tid / C::LPR, p = tid % C::LPR;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int n_ck = (T_len + K - 1) / K;
  const int c0 = 4 * p;  // the thread's first column; its runs at c0 + RUN r
  const long long row = (long long)bh * HD * HD + (long long)i * HD;  // row i of the state
  const long long bt0 = (long long)b * T_len;  // (b, t = 0) among the B * T steps
  const float* ck_src = ckpt + (long long)bh * n_ck * HD * HD;
  float* ck_dst = ckpt + (long long)bh * n_ck * HD * HD + (long long)i * HD;
  const float ui = cols::to_f(u[h * HD + i]);

  // Chunk c into stage `use` % kStages: one thread asks TMA for the head's
  // rows of K steps (past the tensor's end zeros, which count too).
  auto fill = [&](int use, int c, bool back) {
    const int st = use % kStages, rw = (int)(bt0 + (long long)c * K);
    hopper::mbar_arrive_expect_tx(&sm.full[st], (back ? 5 : 3) * K * HD * (int)sizeof(T));
    if (back) {
      hopper::tma_load_3d(sm.in[st][R_], &tm_r, &sm.full[st], 0, h, rw);
      hopper::tma_load_3d(sm.in[st][G_], &tm_g, &sm.full[st], 0, h, rw);
    }
    hopper::tma_load_3d(sm.in[st][K_], &tm_k, &sm.full[st], 0, h, rw);
    hopper::tma_load_3d(sm.in[st][V_], &tm_v, &sm.full[st], 0, h, rw);
    hopper::tma_load_3d(sm.in[st][W_], &tm_w, &sm.full[st], 0, h, rw);
  };
  // Checkpoint c into buffer q & 1 (the walk back's q-th chunk).
  auto fetch_ck = [&](int q, int c) {
    hopper::mbar_arrive_expect_tx(&sm.ckfull[q & 1], HD * HD * 4);
    hopper::bulk_load(sm.ck[q & 1], ck_src + (long long)c * HD * HD, HD * HD * 4,
                      &sm.ckfull[q & 1]);
  };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&sm.full[st], 1);
    hopper::mbar_init(&sm.ckfull[0], 1);
    hopper::mbar_init(&sm.ckfull[1], 1);
    hopper::mbar_fence_init();
    for (int c = 0; c < kStages - 1 && c < n_ck; ++c) fill(c, c, false);
  }
  float S[V] = {};
  if (S0 != nullptr) load_runs<R, RUN>(S0 + row, c0, S);
  __syncthreads();  // the barriers are set up before anyone waits on them

  // the forward sweep: S at the start of every chunk into the checkpoints
  for (int c = 0; c < n_ck; ++c) {
    const int st = c % kStages, steps = min(K, T_len - c * K);
    hopper::mbar_wait(&sm.full[st], (c / kStages) & 1);
    __syncthreads();  // everyone is done with chunk c - 1, whose stage is refilled
    if (tid == 0 && c + kStages - 1 < n_ck) fill(c + kStages - 1, c + kStages - 1, false);
    store_runs<R, RUN>(ck_dst + (long long)c * HD * HD, c0, S);
#pragma unroll 4
    for (int s = 0; s < steps; ++s)
      advance<R, RUN, T>(S, sm.in[st][K_][s], sm.in[st][W_][s], sm.in[st][V_][s], i, c0);
  }
  hopper::fence_proxy_async_global();  // the checkpoints, before bulk copies read them
  __syncthreads();
  if (tid == 0) {
    fill(n_ck, n_ck - 1, true);
    if (n_ck > 1) fill(n_ck + 1, n_ck - 2, true);
    fetch_ck(0, n_ck - 1);
  }

  // the walk back
  float L[V] = {};
  if (dS_last != nullptr) load_runs<R, RUN>(dS_last + row, c0, L);
  float uu[C::UPL];  // u_j for j = lane + 32 n, for r . (u k)
#pragma unroll
  for (int n = 0; n < C::UPL; ++n)
    uu[n] = lane + 32 * n < HD ? cols::to_f(u[h * HD + lane + 32 * n]) : 0.f;
  float du_acc = 0.f;
  int pend_t = 0, pend_n = 0, pend_buf = 0, n_piece = 0;  // the piece whose dv waits to be summed
  // dv of the pending piece: the warps' sums in warp order
  auto sum_dv = [&]() {
    for (int e = tid; e < pend_n * HD; e += C::NT) {
      const int s = e / HD, col = e - s * HD;
      float acc = 0.f;
#pragma unroll
      for (int wv = 0; wv < C::NW; ++wv) acc += sm.red[pend_buf][s][wv][col];
      store(dv + ((bt0 + pend_t + s) * H + h) * HD + col, acc);
    }
  };

  for (int q = 0; q < n_ck; ++q) {
    const int c = n_ck - 1 - q, use = n_ck + q, st = use % kStages;
    const int t0 = c * K, steps = min(K, T_len - t0), last = (steps - 1) / kPiece;
    T(*in)[K][HD] = sm.in[st];
    hopper::mbar_wait(&sm.full[st], (use / kStages) & 1);
    hopper::mbar_wait(&sm.ckfull[q & 1], (q / 2) & 1);
    // v . g and r . (u k) of each step, one warp a step
    for (int s = warp; s < steps; s += C::NW) {
      float a = 0.f, z = 0.f;
#pragma unroll
      for (int n = 0; n < C::UPL; ++n) {
        const int j = lane + 32 * n;
        if (j < HD) {
          a = fmaf(cols::to_f(in[V_][s][j]), cols::to_f(in[G_][s][j]), a);
          z = fmaf(cols::to_f(in[R_][s][j]) * uu[n], cols::to_f(in[K_][s][j]), z);
        }
      }
#pragma unroll
      for (int m = 16; m >= 1; m /= 2) {
        a += __shfl_xor_sync(bwd::kFull, a, m);
        z += __shfl_xor_sync(bwd::kFull, z, m);
      }
      if (lane == 0) sm.vg[st][s] = a, sm.rk[st][s] = z;
    }
    // the first level: S at steps 4, 8, 12 into shared memory, and the last
    // piece's states into registers (unrolled, so that every index is a
    // constant)
    const float* ckq = sm.ck[q & 1] + i * HD;
    float hs[kPiece - 1][V];  // S at the walked piece's steps 1 .. 3
    auto level1 = [&](auto full) {
      constexpr bool F = decltype(full)::value;
      float P[V];
      load_runs<R, RUN>(ckq, c0, P);
#pragma unroll
      for (int s = 0; s < K - 1; ++s) {
        if constexpr (!F)
          if (s + 1 >= steps) break;
        advance<R, RUN, T>(P, in[K_][s], in[W_][s], in[V_][s], i, c0);
        const int n = s + 1;  // P is S at chunk step n
        if (n % kPiece == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            sm.sub[n / kPiece - 1][r][tid] = make_float4(P[4 * r], P[4 * r + 1], P[4 * r + 2], P[4 * r + 3]);
        } else if (n / kPiece == (F ? (K - 1) / kPiece : last)) {
#pragma unroll
          for (int e = 0; e < V; ++e) hs[n % kPiece - 1][e] = P[e];
        }
      }
    };
    if (steps == K) level1(hopper::Full<true>{});
    else level1(hopper::Full<false>{});
    for (int pc = last; pc >= 0; --pc) {
      const int pt0 = pc * kPiece, psteps = min(kPiece, steps - pt0), buf = n_piece & 1;
      // The pending piece's dv sums are in; at the chunk's first piece
      // everyone is done with chunk q - 1, whose stage and checkpoint
      // buffer are refilled, and v . g and r . (u k) are in.
      __syncthreads();
      if (pc == last && tid == 0) {
        if (q + kStages - 1 < n_ck) fill(use + kStages - 1, c - (kStages - 1), true);
        if (q + 1 < n_ck) fetch_ck(q + 1, c - 1);
      }
      if (pend_n) sum_dv();
      float first[V];  // S at the piece's first step
      if (pc == 0) {
        load_runs<R, RUN>(ckq, c0, first);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 a = sm.sub[pc - 1][r][tid];
          first[4 * r] = a.x, first[4 * r + 1] = a.y, first[4 * r + 2] = a.z, first[4 * r + 3] = a.w;
        }
      }
      if (pc != last) {  // the second level: the piece's states 1 .. 3
        float P[V];
#pragma unroll
        for (int e = 0; e < V; ++e) P[e] = first[e];
#pragma unroll
        for (int s = 0; s < kPiece - 1; ++s) {
          advance<R, RUN, T>(P, in[K_][pt0 + s], in[W_][pt0 + s], in[V_][pt0 + s], i, c0);
#pragma unroll
          for (int e = 0; e < V; ++e) hs[s][e] = P[e];
        }
      }
      auto walk = [&](auto full) {
#pragma unroll
      for (int s = kPiece - 1; s >= 0; --s) {
        if constexpr (!decltype(full)::value)
          if (s >= psteps) continue;
        const int t = pt0 + s;
        const float ri = cols::to_f(in[R_][t][i]), ki = cols::to_f(in[K_][t][i]);
        const float wi = cols::to_f(in[W_][t][i]);
        float vv[V], gg[V];
        load_runs<R, RUN>(in[V_][t], c0, vv);
        load_runs<R, RUN>(in[G_][t], c0, gg);
        const float vg = sm.vg[st][t];
        float rs[4] = {0.f, 0.f, 0.f, 0.f}, dvp[V];  // dk, dw, dr parts; dv's
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float Sp = s == 0 ? first[e] : hs[s > 0 ? s - 1 : 0][e];  // S_{t-1}
          rs[0] = fmaf(L[e], vv[e], rs[0]);
          rs[1] = fmaf(L[e], Sp, rs[1]);
          rs[2] = fmaf(Sp, gg[e], rs[2]);
          dvp[e] = L[e] * ki;
          L[e] = fmaf(wi, L[e], ri * gg[e]);
        }
        du_acc = fmaf(ri * ki, vg, du_acc);
        {  // dk, dw, dr over the row's lanes
          int base = 0, dup = 0;
          halve_bits<4, C::LPR / 2, 1>(rs, lane, base, dup);
          const long long off = ((bt0 + t0 + t) * H + h) * HD + i;
#pragma unroll
          for (int kk = 0; kk < C::NR; ++kk) {
            const int idx = base + kk;  // 0: dk, 1: dw, 2: dr, 3: none
            T* dst = idx == 0 ? dk : idx == 1 ? dw : dr;
            const float uterm = idx == 0 ? ui * ri : idx == 2 ? ui * ki : 0.f;
            if (!(lane & dup) && idx < 3) store(dst + off, fmaf(uterm, vg, rs[kk]));
          }
        }
        {  // dv over the warp's rows, then into the warp's slot
          int base = 0, dup = 0;
          halve_bits<V, 16, C::LPR>(dvp, lane, base, dup);
          const float rk = warp == 0 ? sm.rk[st][t] : 0.f;  // (r . u k) g, added once
#pragma unroll
          for (int kk = 0; kk < C::DVN; ++kk) {
            const int idx = base + kk, col = (idx >> 2) * RUN + c0 + (idx & 3);
            const float x = fmaf(rk, cols::to_f(in[G_][t][col]), dvp[kk]);
            if (!(lane & dup)) sm.red[buf][s][warp][col] = x;
          }
        }
      }
      };
      if (psteps == kPiece) walk(hopper::Full<true>{});
      else walk(hopper::Full<false>{});
      pend_t = t0 + pt0, pend_n = psteps, pend_buf = buf, ++n_piece;
    }
  }
  __syncthreads();
  sum_dv();
  if (dS0 != nullptr) store_runs<R, RUN>(dS0 + row, c0, L);
  if (p == 0) du_part[(long long)bh * HD + i] = du_acc;
}

template <int HD, typename T, int K>
constexpr int smem_bytes() { return (int)sizeof(Smem<HD, T, K>); }

template <int HD, typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* S0, const void* dout, const void* dS_last, void* ckpt,
                   void* du_part, void* dr, void* dk, void* dv, void* dw, void* du, void* dS0,
                   int B, int T_len, int H, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD, T, K>();
  static const cudaError_t set = cudaFuncSetAttribute(
      rwkv6_scan_bwd_ring_kernel<HD, T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  // each (B * T, H, hd) tensor in boxes of one head's rows for K steps
  CUtensorMap maps[5];
  const void* bases[5] = {r, k, v, w, dout};
  for (int n = 0; n < 5; ++n)
    if (!hopper::encode_3d(&maps[n], sizeof(T), bases[n], HD, H, (uint64_t)B * T_len, HD,
                           (uint64_t)H * HD, HD, 1, K, 0))
      return cudaErrorInvalidValue;
  rwkv6_scan_bwd_ring_kernel<HD, T, K><<<B * H, Cfg<HD>::NT, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const T*>(u),
      static_cast<const float*>(S0), static_cast<const float*>(dS_last),
      static_cast<float*>(ckpt), static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dw), static_cast<float*>(du_part), static_cast<float*>(dS0), T_len, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd::rwkv6_scan_bwd_sum_kernel<T><<<(H * HD + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<T*>(du), B, H * HD);
  return cudaGetLastError();
}

// hd and K (steps between checkpoints: 16 the route, 4 for timing) to their
// instantiation.
template <typename T>
cudaError_t launch_design(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* S0, const void* dout, const void* dS_last,
                          void* ckpt, void* du_part, void* dr, void* dk, void* dv, void* dw,
                          void* du, void* dS0, int B, int T_len, int H, int hd, int K,
                          cudaStream_t s) {
#define RWKV_RING(HD_, K_)                                                                     \
  if (hd == HD_ && K == K_)                                                                    \
    return launch<HD_, T, K_>(r, k, v, w, u, S0, dout, dS_last, ckpt, du_part, dr, dk, dv, dw, \
                              du, dS0, B, T_len, H, s);
  RWKV_RING(16, 16) RWKV_RING(32, 16) RWKV_RING(64, 16)
  RWKV_RING(16, 4) RWKV_RING(32, 4) RWKV_RING(64, 4)
#undef RWKV_RING
  return cudaErrorInvalidValue;
}

template <typename T>
int smem_bytes_of(int hd, int K) {
#define RWKV_RING(HD_, K_) \
  if (hd == HD_ && K == K_) return smem_bytes<HD_, T, K_>();
  RWKV_RING(16, 16) RWKV_RING(32, 16) RWKV_RING(64, 16)
  RWKV_RING(16, 4) RWKV_RING(32, 4) RWKV_RING(64, 4)
#undef RWKV_RING
  return -1;
}

}  // namespace ring

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

// The backward, the rows design: r, k, v, w (B, T, H, hd) and u (H, hd) as
// for the forward, S0 (B, H, hd, hd) fp32 or null for zeros, dout (B, T, H,
// hd) in the input type, dS_last (B, H, hd, hd) fp32 or null for zeros;
// scratch: ckpt (B, H, ceil(T / 4), hd, hd) and du_part (B, H, hd), fp32;
// out: dr, dk, dv, dw (B, T, H, hd) and du (H, hd) in the input type, and
// dS0 (B, H, hd, hd) fp32 or null.  hd in {16, 32, 64}.  Returns
// cudaGetLastError() after the two launches (0 on success).
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* S0, const void* dout,
                              const void* dS_last, void* ckpt, void* du_part, void* dr, void* dk,
                              void* dv, void* dw, void* du, void* dS0, int B, int T_len, int H,
                              int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd::launch_hd<float>(r, k, v, w, u, S0, dout, dS_last, ckpt, du_part, dr, dk,
                                      dv, dw, du, dS0, B, T_len, H, hd, s);
  if (dtype == 1)
    return (int)bwd::launch_hd<__nv_bfloat16>(r, k, v, w, u, S0, dout, dS_last, ckpt, du_part,
                                              dr, dk, dv, dw, du, dS0, B, T_len, H, hd, s);
  return (int)cudaErrorInvalidValue;
}

// The backward, the ring design: the same arguments and ck_steps, the
// checkpoint spacing (16, the route; 4 reachable for timing), with ckpt (B,
// H, ceil(T / ck_steps), hd, hd) fp32.  Returns cudaGetLastError() after the
// two launches (0 on success).
extern "C" int rwkv6_scan_bwd_ring(const void* r, const void* k, const void* v, const void* w,
                                   const void* u, const void* S0, const void* dout,
                                   const void* dS_last, void* ckpt, void* du_part, void* dr,
                                   void* dk, void* dv, void* dw, void* du, void* dS0, int B,
                                   int T_len, int H, int hd, int dtype, int ck_steps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)ring::launch_design<float>(r, k, v, w, u, S0, dout, dS_last, ckpt, du_part, dr,
                                           dk, dv, dw, du, dS0, B, T_len, H, hd, ck_steps, s);
  if (dtype == 1)
    return (int)ring::launch_design<__nv_bfloat16>(r, k, v, w, u, S0, dout, dS_last, ckpt,
                                                   du_part, dr, dk, dv, dw, du, dS0, B, T_len, H,
                                                   hd, ck_steps, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block of the ring design (dtype 0 = float32, 1 =
// bfloat16; -1 for an hd or spacing it does not take), for the wrapper's
// launch geometry to be checked against.
extern "C" int rwkv6_scan_bwd_ring_smem_bytes(int hd, int dtype, int ck_steps) {
  return dtype == 0 ? ring::smem_bytes_of<float>(hd, ck_steps)
                    : ring::smem_bytes_of<__nv_bfloat16>(hd, ck_steps);
}
