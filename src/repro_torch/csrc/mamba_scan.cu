// Mamba's selective scan: for every batch row b and inner channel c, a
// diagonal linear recurrence over time with an fp32 state of ds values,
//     h_t[n] = exp(dt_t * A[c, n]) * h_{t-1}[n] + dtx_t * B_t[n],
//     y_t    = sum_n h_t[n] * C_t[n],
// from an initial state h0 (zeros when none is given), returning y and the
// last state; and its backward in two designs (entries mamba_scan_bwd_ring,
// the route, and mamba_scan_bwd, noted where they begin, below the two
// forward designs).
//
// Replaces the Pallas kernel `mamba_scan` (body `_scan_kernel`) in
// src/repro/kernels/mamba_scan.py.  Plain version:
// repro_torch.kernels.ref.mamba_scan_ref.  Unlike the Pallas kernel it takes
// an initial state and any S and di (the Pallas grid asserts di % block_d ==
// 0 and S % block_s == 0 and starts from zero), so the model's prefill and
// each one-token decode step both run through it.
//
// Layouts: dt, dtx and y (B, S, di); Bm, Cm (B, S, ds); A (di, ds), all of
// one type, fp32 or bf16, row-major and contiguous.  h0 and h_last (B, di,
// ds) fp32; h_last may be h0 itself, since each thread reads its own state
// once before it writes it once.  The arithmetic and the state are fp32, and
// y is rounded once to the input type.
//
// What bounds it on this card: at Jamba's prefill (B 8, S 512, di 8192, ds
// 16, fp32) the kernel must move 412 MB (dt, dtx and y, 134 MB each, and the
// last state), 0.123 ms at 3.35 TB/s, and take B * S * di * ds = 537 M
// exponentials, 0.128 ms at 16 per clock per SM on the special-function
// units: about 0.13 ms either way.  At a decode step (S = 1) it is the state,
// 4.2 MB read and written, a few microseconds.  The recurrence is sequential
// in time but independent across (b, c, n): B * di = 65536 independent
// chains at the serving shape.
//
// What this design does about it: two designs, each its own C entry
// point, chosen before the launch by `route` in kernels/mamba_scan.py:
// `lanes` (mamba_scan_lanes_fwd) for ds a multiple of 4, `simt`
// (mamba_scan_simt_fwd) for any other ds <= 16.
//
// simt, the first design: one thread per (batch row, inner channel) keeps
// its ds <= 16 state values and its row of A in registers and walks all of
// S, so the state never touches device memory between steps.  A block of
// 128 threads covers 128 channels of one batch row; the time axis is cut
// into chunks of 32 steps.  For each chunk, the block first copies its dt
// and dtx (each thread its own channel: coalesced, and 64 independent loads
// in flight per thread) and the chunk's B_t and C_t (shared by every channel
// of the row) into shared memory, then steps through the chunk from there;
// y is stored per step, coalesced along di.  Tails of di and S are masked by
// bounds.  `expf`, not `__expf`.  What holds it back on this card: a decode
// step loads the state and A with a 64-byte stride between neighbouring
// threads (32 lines per warp load); the loads of a chunk never overlap the
// arithmetic of the one before; each step takes 34 scalar shared-memory
// broadcasts per thread.
//
// lanes, the Hopper design: ds is split across L = 1, 2 or 4 neighbouring
// lanes (ds 4, 8, 12 or 16; at 12 the fourth lane holds zeros), and each
// lane holds 4 state values (and A) of 4 neighbouring channels, 16 values
// at ds 16.  So a warp's loads of h0 and A and its stores of h_last are
// whole 64-byte runs, and each shared load feeds 16 state updates: the
// lane's 4 channels of dt and of dtx in one 16-byte load each, its 4 values
// of B_t and of C_t in one each.  Each step a lane updates its 16 states and
// sums its parts of y across the L lanes in log2 L rounds of xor-shuffles
// that halve the values a lane holds (3 shuffles for 4 channels at L 4); a
// chunk's y is staged in shared memory and stored in whole rows, 16 bytes a
// thread.  A block of 32 L threads covers 128 channels of one batch row.
// The time axis is cut into chunks of 8 steps held in a ring of 3 stages,
// two chunks ahead of the one computed.  Where the rows are 16-byte aligned
// (di and ds times the element size multiples of 16: every model shape),
// warp 0 fills a stage with one bulk copy (cp.async.bulk) per row of dt and
// dtx and per run of B_t and C_t, counted on the stage's mbarrier, whose
// wait traps after 2^26 polls; any other shape (ragged di) takes 16-byte
// cp.async words from the word that holds each row's first element, zero-
// filled past the tensor's end, with scalar shared loads and stores.  TMA is
// not used: its 3-D boxes would need the same 16-byte strides and add the
// host's tensor maps.  One block-wide barrier per chunk publishes the chunk
// and frees the stage of the one before.  The exponential is ex2.approx of
// dt * A * log2(e), A prescaled once: one special-function op per state
// value and step, the bound; its error over 512 steps is checked on the CPU
// (tests/test_torch_scan_routes.py) and on the card against the plain
// version at 2e-4.  Blocks are held to 128 registers a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"


namespace {

constexpr int kThreads = 128;  // inner channels per block
constexpr int kMaxDS = 16;     // state values per channel held in registers
constexpr int kChunk = 32;     // time steps staged in shared memory at once

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ dt, const T* __restrict__ dtx,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const T* __restrict__ A, const float* h0, T* __restrict__ y,
                  float* h_last, int S, int di, int ds) {
  __shared__ float dt_s[kChunk][kThreads];
  __shared__ float dtx_s[kChunk][kThreads];
  __shared__ float b_s[kChunk][kMaxDS];
  __shared__ float c_s[kChunk][kMaxDS];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + tid;
  const bool live = c < di;
  const long long state = ((long long)b * di + c) * ds;

  float a[kMaxDS], h[kMaxDS];
#pragma unroll
  for (int n = 0; n < kMaxDS; ++n) {
    const bool on = live && n < ds;
    a[n] = on ? load(A + (long long)c * ds + n) : 0.f;
    h[n] = (on && h0 != nullptr) ? h0[state + n] : 0.f;
  }

  const long long row0 = (long long)b * S;  // row of (b, t = 0) in the (B * S) rows
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    __syncthreads();  // every thread is done with the previous chunk
    if (live) {
#pragma unroll 8
      for (int t = 0; t < steps; ++t) {
        const long long off = (row0 + t0 + t) * di + c;
        dt_s[t][tid] = load(dt + off);
        dtx_s[t][tid] = load(dtx + off);
      }
    }
    for (int i = tid; i < steps * ds; i += kThreads) {
      const int t = i / ds, n = i - t * ds;
      const long long off = (row0 + t0 + t) * ds + n;
      b_s[t][n] = load(Bm + off);
      c_s[t][n] = load(Cm + off);
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t) {
      const float d = dt_s[t][tid], x = dtx_s[t][tid];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxDS; ++n) {
        if (n < ds) {
          h[n] = expf(d * a[n]) * h[n] + x * b_s[t][n];
          acc += h[n] * c_s[t][n];
        }
      }
      store(y + (row0 + t0 + t) * di + c, acc);
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < kMaxDS; ++n)
      if (n < ds) h_last[state + n] = h[n];
  }
}

template <typename T>
cudaError_t launch(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                   const void* A, const void* h0, void* y, void* h_last, int B, int S,
                   int di, int ds, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  mamba_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(dtx), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(A), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_last), S, di, ds);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The lanes design (see the head of the file).

namespace lanes {

constexpr int kUnroll = 2;   // steps unrolled in the inner loop
constexpr int kTile = 128;   // inner channels per block
constexpr int kGroup = 4;    // neighbouring channels per lane
constexpr int kChunk = 8;    // time steps per stage of the ring
constexpr int kStages = 3;   // chunks held in shared memory: the one computed, two in flight
constexpr int kMaxDS = 16;

// A stage holds a chunk's dt and dtx, one row of channels per step, and its
// B_t and C_t as one run; each has a 16-byte word of slack, since a word
// copy starts at the word that holds the first element.
template <typename T>
struct Smem {
  static constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte word
  static constexpr int kRow = kTile + kVec;            // a step's channels, with the slack
  static constexpr int kRun = kChunk * kMaxDS + kVec;  // a chunk's B_t (or C_t), with the slack
  alignas(16) uint64_t full[kStages];  // bulk copies of a stage landed (aligned rows only)
  alignas(16) T dt[kStages][kChunk][kRow];
  alignas(16) T dtx[kStages][kChunk][kRow];
  alignas(16) T bm[kStages][kRun];
  alignas(16) T cm[kStages][kRun];
  alignas(16) float y[2][kChunk][kTile];  // the chunk's y, double-buffered
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four neighbouring values (16-byte aligned in fp32, 8-byte in bf16).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = hopper::unpack_bf16(u.x), hi = hopper::unpack_bf16(u.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(hopper::pack_bf16(v.x, v.y), hopper::pack_bf16(v.z, v.w));
}

// A lane's four channels of a row of dt or dtx in shared memory: one
// vector load on aligned rows (ALIGNED), else four scalar ones.
template <bool ALIGNED, typename T>
__device__ __forceinline__ float4 load_group(const T* p) {
  if constexpr (ALIGNED) return load4(p);
  return make_float4(to_f(p[0]), to_f(p[1]), to_f(p[2]), to_f(p[3]));
}

// Aligned rows (di and ds times the element size multiples of 16 bytes):
// warp 0 copies a chunk with one bulk copy per row of dt and of dtx (the
// block's channels of a step) and one per run of B_t and of C_t, all
// counted on the stage's barrier.
template <typename T>
__device__ __forceinline__ void fill_bulk(Smem<T>& sm, int st, const T* dt, const T* dtx,
                                          const T* Bm, const T* Cm, long long row0, int t0,
                                          int steps, int di, int ds, int c0) {
  const int lane = threadIdx.x;
  const uint32_t row = min(kTile, di - c0) * sizeof(T), run = steps * ds * sizeof(T);
  if (lane == 0) hopper::mbar_arrive_expect_tx(&sm.full[st], 2 * steps * row + 2 * run);
  __syncwarp();
  if (lane < 2 * steps) {
    const int which = lane >= steps, t = lane - which * steps;
    hopper::bulk_load((which ? sm.dtx : sm.dt)[st][t], (which ? dtx : dt) + (row0 + t0 + t) * di + c0,
                      row, &sm.full[st]);
  } else if (lane < 2 * steps + 2) {
    const int which = lane - 2 * steps;
    hopper::bulk_load((which ? sm.cm : sm.bm)[st], (which ? Cm : Bm) + (row0 + t0) * ds, run,
                      &sm.full[st]);
  }
}

// The 16-byte word of `base` starting at element `idx`, into `dst`; the
// part past `n` elements is zero-filled (nothing is read past the end).
template <typename T>
__device__ __forceinline__ void copy_word(T* dst, const T* base, long long idx, long long n) {
  const long long left = (n - idx) * (long long)sizeof(T);
  const int bytes = left <= 0 ? 0 : left >= 16 ? 16 : (int)left;
  hopper::cp_async_16(dst, bytes ? base + idx : base, bytes);
}

// Any other rows: every thread copies 16-byte words by cp.async, each row
// from the word that holds its first element.
template <typename T, int NT>
__device__ __forceinline__ void fill_words(Smem<T>& sm, int st, const T* dt, const T* dtx,
                                           const T* Bm, const T* Cm, long long row0, int t0,
                                           int steps, int di, int ds, int c0, long long n_x,
                                           long long n_bc) {
  constexpr int V = Smem<T>::kVec, RW = Smem<T>::kRow / V;  // words per row
  constexpr int PER = kChunk * RW;                           // words of a chunk of dt
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int k = 0; k < (2 * PER + NT - 1) / NT; ++k) {
    const int e = tid + k * NT;
    const int which = e >= PER, rem = e - which * PER, t = rem / RW, w = rem - t * RW;
    if (e < 2 * PER && t < steps) {
      const long long first = (row0 + t0 + t) * di + c0;
      const long long idx = (first & ~(long long)(V - 1)) + w * V;
      copy_word((which ? sm.dtx : sm.dt)[st][t] + w * V, which ? dtx : dt, idx, n_x);
    }
  }
  const long long first = (row0 + t0) * ds;
  const long long word0 = first & ~(long long)(V - 1);
  const int words = ((int)(first - word0) + steps * ds + V - 1) / V;
  for (int e = tid; e < 2 * words; e += NT) {
    const int which = e >= words, w = e - which * words;
    copy_word((which ? sm.cm : sm.bm)[st] + w * V, which ? Cm : Bm, word0 + (long long)w * V,
              n_bc);
  }
  hopper::cp_async_commit();
}

// Store a staged chunk of y: `steps` rows of the block's channels, whole
// rows at a time, four channels a store on aligned rows.
template <typename T, int NT, bool ALIGNED>
__device__ __forceinline__ void store_y(const float (*ys)[kTile], T* y, long long row, int steps,
                                        int di, int c0) {
  const int width = min(kTile, di - c0);
  constexpr int PER = ALIGNED ? 4 : 1;  // channels a store
#pragma unroll 4
  for (int k = 0; k < kChunk * kTile / PER / NT; ++k) {
    const int e = threadIdx.x + k * NT, t = e / (kTile / PER), c = PER * (e - t * (kTile / PER));
    if (t < steps && c < width) {
      if constexpr (ALIGNED)
        store4(y + (row + t) * di + c0 + c, *reinterpret_cast<const float4*>(&ys[t][c]));
      else
        store(y + (row + t) * di + c0 + c, ys[t][c]);
    }
  }
}

// Block (channel tile, batch row); thread tid is lane q = tid % L of the
// group of channels c0 + 4 (tid / L) .. + 3 and holds states 4q .. 4q + 3 of
// each of them: 16 state values at ds = 16.
template <typename T, int L, bool ALIGNED>
__global__ void __launch_bounds__(kTile / kGroup * L, 512 / (kTile / kGroup * L))
mamba_scan_lanes_kernel(const T* __restrict__ dt, const T* __restrict__ dtx,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        const T* __restrict__ A, const float* h0, T* __restrict__ y,
                        float* h_last, int S, int di, int ds, long long n_x, long long n_bc) {
  constexpr int NT = kTile / kGroup * L, V = Smem<T>::kVec, kRow = Smem<T>::kRow;
  __shared__ Smem<T> sm;
  const int tid = threadIdx.x, q = tid % L, g = tid / L;
  const int b = blockIdx.y, c0 = blockIdx.x * kTile;
  const bool on = 4 * q < ds;          // false only for the fourth lane at ds = 12
  const long long row0 = (long long)b * S;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  auto fill = [&](int i) {  // chunk i into its stage
    const int t0 = i * kChunk, steps = min(kChunk, S - t0);
    if constexpr (ALIGNED) {
      if (tid < 32) fill_bulk<T>(sm, i % kStages, dt, dtx, Bm, Cm, row0, t0, steps, di, ds, c0);
    } else {
      fill_words<T, NT>(sm, i % kStages, dt, dtx, Bm, Cm, row0, t0, steps, di, ds, c0, n_x,
                        n_bc);
    }
  };

  if constexpr (ALIGNED) {
    if (tid == 0) {
#pragma unroll
      for (int st = 0; st < kStages; ++st) hopper::mbar_init(&sm.full[st], 1);
      hopper::mbar_fence_init();
    }
    __syncthreads();
  }
  for (int i = 0; i < kStages - 1; ++i) {  // the first chunks in flight
    if (i < n_chunks) fill(i);
    else if (!ALIGNED) hopper::cp_async_commit();
  }
  float4 a[kGroup], h[kGroup];
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    const int c = c0 + kGroup * g + m;
    a[m] = h[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on && c < di) {
      constexpr float kLog2e = 1.4426950408889634f;
      const float4 v = load4(A + (long long)c * ds + 4 * q);
      a[m] = make_float4(v.x * kLog2e, v.y * kLog2e, v.z * kLog2e, v.w * kLog2e);
      if (h0 != nullptr)
        h[m] = *reinterpret_cast<const float4*>(h0 + ((long long)b * di + c) * ds + 4 * q);
    }
  }

  for (int i = 0; i < n_chunks; ++i) {
    const int t0 = i * kChunk, steps = min(kChunk, S - t0), st = i % kStages;
    if constexpr (ALIGNED)
      hopper::mbar_wait(&sm.full[st], (i / kStages) & 1);  // chunk i has landed
    else
      hopper::cp_async_wait<kStages - 2>();  // this thread's copies of chunk i have landed
    __syncthreads();  // everyone's have, and everyone is done with chunk i - 1
    const int next = i + kStages - 1;  // into the stage of chunk i - 1
    if (next < n_chunks) fill(next);
    else if (!ALIGNED) hopper::cp_async_commit();
    if (i > 0) store_y<T, NT, ALIGNED>(sm.y[(i - 1) & 1], y, row0 + t0 - kChunk, kChunk, di, c0);

    // each row's first element sits `off` elements into its first word
    // (always 0 on aligned rows)
    const unsigned first = (unsigned)((row0 + t0) * di + c0);
    const T* dts = &sm.dt[st][0][kGroup * g];
    const T* dtxs = &sm.dtx[st][0][kGroup * g];
    const int boff = (ALIGNED ? 0 : (int)(((row0 + t0) * ds) & (V - 1))) + 4 * q;
    const T* bms = &sm.bm[st][boff];
    const T* cms = &sm.cm[st][boff];
    float* ys = &sm.y[i & 1][0][kGroup * g + q * (kGroup / L)];
#pragma unroll kUnroll
    for (int t = 0; t < steps; ++t) {
      const int off = (ALIGNED ? 0 : (int)((first + (unsigned)t * (unsigned)di) & (V - 1))) +
                      t * kRow;
      const float4 d4 = load_group<ALIGNED>(dts + off), x4 = load_group<ALIGNED>(dtxs + off);
      const float d[kGroup] = {d4.x, d4.y, d4.z, d4.w}, x[kGroup] = {x4.x, x4.y, x4.z, x4.w};
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 bq = on ? load4(bms + t * ds) : zero;
      const float4 cq = on ? load4(cms + t * ds) : zero;
      float part[kGroup];
#pragma unroll
      for (int m = 0; m < kGroup; ++m) {
        float4& hm = h[m];
        hm.x = fmaf(hopper::exp2_approx(d[m] * a[m].x), hm.x, x[m] * bq.x);
        hm.y = fmaf(hopper::exp2_approx(d[m] * a[m].y), hm.y, x[m] * bq.y);
        hm.z = fmaf(hopper::exp2_approx(d[m] * a[m].z), hm.z, x[m] * bq.z);
        hm.w = fmaf(hopper::exp2_approx(d[m] * a[m].w), hm.w, x[m] * bq.w);
        part[m] = fmaf(hm.x, cq.x, fmaf(hm.y, cq.y, fmaf(hm.z, cq.z, hm.w * cq.w)));
      }
      // Sum each channel's parts over its L lanes, halving the values a lane
      // holds each round: lane q ends with the channels q * 4 / L .. + 4 / L - 1.
#pragma unroll
      for (int m = L / 2, n = kGroup; m >= 1; m /= 2, n /= 2) {
        const bool hi = q & m;
#pragma unroll
        for (int k = 0; k < n / 2; ++k) {
          const float send = hi ? part[k] : part[k + n / 2];
          const float keep = hi ? part[k + n / 2] : part[k];
          part[k] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup / L; ++k) ys[t * kTile + k] = part[k];
    }
  }
  __syncthreads();
  const int last = n_chunks - 1;
  store_y<T, NT, ALIGNED>(sm.y[last & 1], y, row0 + last * kChunk, S - last * kChunk, di, c0);
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    const int c = c0 + kGroup * g + m;
    if (on && c < di)
      *reinterpret_cast<float4*>(h_last + ((long long)b * di + c) * ds + 4 * q) = h[m];
  }
}

template <typename T, int L>
cudaError_t launch(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                   const void* A, const void* h0, void* y, void* h_last, int B, int S, int di,
                   int ds, cudaStream_t stream) {
  const dim3 grid((di + kTile - 1) / kTile, B);
  const long long n_x = (long long)B * S * di, n_bc = (long long)B * S * ds;
  const bool aligned = (di * sizeof(T)) % 16 == 0 && (ds * sizeof(T)) % 16 == 0;
  auto kernel = aligned ? mamba_scan_lanes_kernel<T, L, true> : mamba_scan_lanes_kernel<T, L, false>;
  kernel<<<grid, kTile / kGroup * L, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(dtx), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(A), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_last), S, di, ds, n_x, n_bc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ds(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                      const void* A, const void* h0, void* y, void* h_last, int B, int S,
                      int di, int ds, cudaStream_t s) {
  if (ds <= 4) return launch<T, 1>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, ds, s);
  if (ds <= 8) return launch<T, 2>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, ds, s);
  return launch<T, 4>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, ds, s);
}

}  // namespace lanes

// ---------------------------------------------------------------------------
// The backward (entry mamba_scan_bwd): the gradients of the scan by dt, dtx,
// Bm, Cm, A and h0, from dy, the cotangent of y, and dh_last, that of the
// last state.  The JAX package has no Pallas backward (it differentiates
// its chunked linear_scan_emit); plain version:
// repro_torch.kernels.ref.mamba_scan_bwd_ref.  With a_t = exp(dt_t A), a
// walk back carries lambda_t = dL/dh_t = dy_t C_t + a_{t+1} lambda_{t+1}
// (dh_last at t = S) and gives
//     ddtx_t = lambda_t . B_t,            ddt_t = sum_n lambda_t h_{t-1} a_t A,
//     dC_t   = sum_c dy_t[c] h_t[c, :],   dB_t  = sum_c lambda_t[c, :] dtx_t[c],
//     dA     = sum_{b,t} lambda_t h_{t-1} a_t dt_t,    dh0 = a_1 lambda_1.
//
// What bounds it on this card: at Jamba's training shape (B 8, S 512, di
// 8192, ds 16, fp32) the function must read dt, dtx and dy (134 MB each) and
// write ddt and ddtx (134 MB each), about 671 MB, 0.200 ms at 3.35 TB/s, and
// take the B * S * di * ds = 537 M exponentials of a_t once, 0.128 ms on the
// special-function units: bound by the bytes.
//
// What this design does about it (the simple design, `ckpt`): the states do
// not run backward (h_{t-1} = (h_t - dtx_t B_t) / a_t blows up where the
// decay is strong), and the autograd function saves its inputs, not the
// states.  So one kernel runs each channel forward once from h0, writing its
// state every kChunk = 16 steps to a checkpoint buffer (B, S/16, di, 16)
// fp32 (134 MB at the shape above, written and read by the same thread, the
// latest chunks still in L2 when the walk back reads them), then walks the
// chunks from the last: it recomputes the chunk's 16 states from its
// checkpoint into shared memory and steps back through them.  A channel's
// 16 state values sit on 4 neighbouring lanes, 4 each (ds below 16 masked),
// 64 channels a block of 256 threads; a chunk's dt, dtx, dy, B_t and C_t are
// staged in shared memory.  ddt and ddtx sum over the channel's 4 lanes (2
// shuffles), staged and stored a chunk at a time.  dB and dC sum over
// channels, which cross warps and blocks: each step the warp's 8 channels
// are summed by xor-shuffles that halve the 8 values a lane holds (7
// shuffles), the 8 warps' sums are added in a fixed order at the end of the
// chunk and written as the block's partial (B, di/64, S, 32) fp32; dA sums
// over the batch rows, each block writing its (di, ds) partial.  A second
// kernel adds the partials in a fixed order, so that runs repeat bit for
// bit: no atomics.  The exponential is expf of dt A, not the forward's
// ex2.approx of a prescaled A: lambda sums over up to S steps, and the
// prescale's rounding, amplified by |dt A|, put ddtx 5.5e-4 off the plain
// version at the shape above.  Cost over the bound: dt and dtx are read
// twice, the checkpoints and the partials (67 MB) are written and read once,
// and the exponentials are taken three times (the forward walk, the
// recompute, the walk back).

namespace bwd {

constexpr int kLanes = 4;                     // lanes of a channel, 4 state values each
constexpr int kChannels = 64;                 // channels per block
constexpr int kThreads = kChannels * kLanes;  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                    // steps between checkpoints
constexpr int kSlots = 32;                    // a step's partial: dC in 0..15, dB in 16..31
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  float dt[kChunk][kChannels];
  float dtx[kChunk][kChannels];
  float dy[kChunk][kChannels];
  float4 bm[kChunk][kLanes];          // B_t, padded to 16 with zeros
  float4 cm[kChunk][kLanes];          // C_t
  float4 hist[kChunk][kThreads];      // h_{t-1} of each step of the chunk, a thread's 4 values
  float red[kChunk][kWarps][kSlots];  // each warp's sums of dC and dB
  float ddt[kChunk][kChannels];
  float ddtx[kChunk][kChannels];
};

// A chunk's inputs into shared memory, zeros past S, di and ds; dy and C_t
// only for the walk back.
template <typename T>
__device__ __forceinline__ void stage(Smem& sm, const T* dt, const T* dtx, const T* dy,
                                      const T* Bm, const T* Cm, long long row0, int t0,
                                      int steps, int di, int ds, int c0, bool back) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kChunk * kChannels; e += kThreads) {
    const int s = e / kChannels, cc = e - s * kChannels;
    const bool on = s < steps && c0 + cc < di;
    const long long off = (row0 + t0 + s) * di + c0 + cc;
    sm.dt[s][cc] = on ? load(dt + off) : 0.f;
    sm.dtx[s][cc] = on ? load(dtx + off) : 0.f;
    if (back) sm.dy[s][cc] = on ? load(dy + off) : 0.f;
  }
  for (int e = tid; e < kChunk * 16; e += kThreads) {
    const int s = e >> 4, n = e & 15;
    const bool on = s < steps && n < ds;
    const long long off = (row0 + t0 + s) * ds + n;
    reinterpret_cast<float*>(&sm.bm[s][0])[n] = on ? load(Bm + off) : 0.f;
    if (back) reinterpret_cast<float*>(&sm.cm[s][0])[n] = on ? load(Cm + off) : 0.f;
  }
}

// Block (64 channels, batch row); thread tid is lane q = tid % 4 of channel
// c0 + tid / 4 and holds its states 4q .. 4q + 3.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mamba_scan_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ dtx,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const T* __restrict__ A, const float* __restrict__ h0,
                      const T* __restrict__ dy, const float* __restrict__ dh_last,
                      float* __restrict__ ckpt, float* __restrict__ bc_part,
                      float* __restrict__ dA_part, T* __restrict__ ddt, T* __restrict__ ddtx,
                      float* __restrict__ dh0, int S, int di, int ds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, q = tid & 3, g = tid >> 2, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, c0 = blockIdx.x * kChannels, c = c0 + g;
  const bool live = c < di;
  const long long row0 = (long long)b * S;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const long long state = ((long long)b * di + c) * ds;

  float Av[4], h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = 4 * q + i;
    const bool on = live && n < ds;
    Av[i] = on ? load(A + (long long)c * ds + n) : 0.f;
    h[i] = (on && h0 != nullptr) ? h0[state + n] : 0.f;
  }
  // this thread's checkpoint of chunk j: ck[j * ck_stride]
  float4* ck = reinterpret_cast<float4*>(ckpt) + ((long long)b * n_chunks * di + c) * kLanes + q;
  const long long ck_stride = (long long)di * kLanes;

  // the forward walk: the state at the start of every chunk
  for (int j = 0; j < n_chunks; ++j) {
    const int t0 = j * kChunk, steps = min(kChunk, S - t0);
    __syncthreads();
    stage<T>(sm, dt, dtx, dy, Bm, Cm, row0, t0, steps, di, ds, c0, false);
    __syncthreads();
    if (live) ck[j * ck_stride] = make_float4(h[0], h[1], h[2], h[3]);
    for (int s = 0; s < steps; ++s) {
      const float d = sm.dt[s][g], x = sm.dtx[s][g];
      const float4 bq = sm.bm[s][q];
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = fmaf(expf(d * Av[i]), h[i], x * bv[i]);
    }
  }

  // the walk back
  float carry[4], dA[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = 4 * q + i;
    carry[i] = (live && n < ds && dh_last != nullptr) ? dh_last[state + n] : 0.f;
    dA[i] = 0.f;
  }
  for (int j = n_chunks - 1; j >= 0; --j) {
    const int t0 = j * kChunk, steps = min(kChunk, S - t0);
    __syncthreads();  // everyone is done with the previous chunk's shared memory
    stage<T>(sm, dt, dtx, dy, Bm, Cm, row0, t0, steps, di, ds, c0, true);
    __syncthreads();
    float hp[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const float4 v = ck[j * ck_stride];
      hp[0] = v.x, hp[1] = v.y, hp[2] = v.z, hp[3] = v.w;
    }
    for (int s = 0; s < steps; ++s) {  // the chunk's states again: h_{t-1} of each step
      sm.hist[s][tid] = make_float4(hp[0], hp[1], hp[2], hp[3]);
      const float d = sm.dt[s][g], x = sm.dtx[s][g];
      const float4 bq = sm.bm[s][q];
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) hp[i] = fmaf(expf(d * Av[i]), hp[i], x * bv[i]);
    }
    for (int s = steps - 1; s >= 0; --s) {
      const float4 hv = sm.hist[s][tid], bq = sm.bm[s][q], cq = sm.cm[s][q];
      const float hpv[4] = {hv.x, hv.y, hv.z, hv.w};
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w}, cv[4] = {cq.x, cq.y, cq.z, cq.w};
      const float d = sm.dt[s][g], x = sm.dtx[s][g], gy = sm.dy[s][g];
      float p_dtx = 0.f, p_dt = 0.f, v8[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(d * Av[i]);
        const float lam = fmaf(gy, cv[i], carry[i]);
        const float qq = lam * hpv[i] * e;
        p_dtx = fmaf(lam, bv[i], p_dtx);
        p_dt = fmaf(qq, Av[i], p_dt);
        dA[i] = fmaf(qq, d, dA[i]);
        carry[i] = e * lam;
        v8[i] = gy * fmaf(e, hpv[i], x * bv[i]);  // dy_t h_t, towards dC
        v8[4 + i] = lam * x;                       // lambda_t dtx_t, towards dB
      }
      {  // ddtx (lanes 0, 1) and ddt (lanes 2, 3) over the channel's 4 lanes
        const bool hi = q & 2;
        float t = (hi ? p_dt : p_dtx) + __shfl_xor_sync(kFull, hi ? p_dtx : p_dt, 2);
        t += __shfl_xor_sync(kFull, t, 1);
        if (q == 0) sm.ddtx[s][g] = t;
        if (q == 2) sm.ddt[s][g] = t;
      }
      // dC and dB over the warp's 8 channels, halving the values a lane
      // holds each round: lane 4 g' + q ends with value g' (dC of state
      // 4q + g' for g' < 4, else dB of state 4q + g' - 4)
#pragma unroll
      for (int m = 16, n = 8; m >= 4; m /= 2, n /= 2) {
        const bool hi = lane & m;
#pragma unroll
        for (int k = 0; k < n / 2; ++k) {
          const float send = hi ? v8[k] : v8[k + n / 2];
          const float keep = hi ? v8[k + n / 2] : v8[k];
          v8[k] = keep + __shfl_xor_sync(kFull, send, m);
        }
      }
      sm.red[s][warp][q * 8 + (lane >> 2)] = v8[0];
    }
    __syncthreads();
    // the block's partial of dC and dB at each step: the warps' sums in order
    for (int e = tid; e < steps * kSlots; e += kThreads) {
      const int s = e / kSlots, kk = e - s * kSlots, qq = kk >> 3, gp = kk & 7;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += sm.red[s][w][kk];
      bc_part[(((long long)b * gridDim.x + blockIdx.x) * S + t0 + s) * kSlots + (gp >> 2) * 16 +
              4 * qq + (gp & 3)] = acc;
    }
    for (int e = tid; e < steps * kChannels; e += kThreads) {
      const int s = e / kChannels, cc = e - s * kChannels;
      if (c0 + cc < di) {
        const long long off = (row0 + t0 + s) * di + c0 + cc;
        store(ddt + off, sm.ddt[s][cc]);
        store(ddtx + off, sm.ddtx[s][cc]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = 4 * q + i;
    if (live && n < ds) {
      dA_part[state + n] = dA[i];
      if (dh0 != nullptr) dh0[state + n] = carry[i];
    }
  }
}

// The second pass: dC and dB at each (b, t, n), the blocks' partials added
// in block order, and dA at each (c, n), the batch rows' added in order.
template <typename T>
__global__ void __launch_bounds__(256)
mamba_scan_bwd_sum_kernel(const float* __restrict__ bc_part, const float* __restrict__ dA_part,
                          T* __restrict__ dB, T* __restrict__ dC, T* __restrict__ dA, int B,
                          int S, int di, int ds, int n_blocks) {
  const long long n_bc = (long long)B * S * ds, n_a = (long long)di * ds;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < 2 * n_bc + n_a;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < 2 * n_bc) {
      const int which = e >= n_bc;                  // 0: dC, 1: dB
      const long long r = e - which * n_bc;         // (b S + t) ds + n
      const long long bt = r / ds, bb = bt / S, t = bt - bb * S;
      const int n = (int)(r - bt * ds);
      float acc = 0.f;
      for (int k = 0; k < n_blocks; ++k)
        acc += bc_part[((bb * n_blocks + k) * S + t) * kSlots + which * 16 + n];
      store((which ? dB : dC) + r, acc);
    } else {
      const long long r = e - 2 * n_bc;             // c ds + n
      float acc = 0.f;
      for (int bb = 0; bb < B; ++bb) acc += dA_part[bb * n_a + r];
      store(dA + r, acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                   const void* A, const void* h0, const void* dy, const void* dh_last,
                   void* ckpt, void* bc_part, void* dA_part, void* ddt, void* ddtx, void* dB,
                   void* dC, void* dA, void* dh0, int B, int S, int di, int ds,
                   cudaStream_t stream) {
  constexpr int bytes = sizeof(Smem);
  static const cudaError_t set = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  mamba_scan_bwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(dtx), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(A), static_cast<const float*>(h0),
      static_cast<const T*>(dy), static_cast<const float*>(dh_last), static_cast<float*>(ckpt),
      static_cast<float*>(bc_part), static_cast<float*>(dA_part), static_cast<T*>(ddt),
      static_cast<T*>(ddtx), static_cast<float*>(dh0), S, di, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = 2LL * B * S * ds + (long long)di * ds;
  const int blocks = (int)((total + 255) / 256 < 1056 ? (total + 255) / 256 : 1056);
  mamba_scan_bwd_sum_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(bc_part), static_cast<const float*>(dA_part),
      static_cast<T*>(dB), static_cast<T*>(dC), static_cast<T*>(dA), B, S, di, ds, grid.x);
  return cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// The ring design of the backward (entry mamba_scan_bwd_ring), the route
// where the rows are 16-byte aligned (di and ds times the element size
// multiples of 16: every model shape); ckpt takes the others.
//
// What held `ckpt` back: expf three times per (channel, state, step) (the
// forward walk, the recompute, the walk back), most of its issue; each
// chunk staged through registers between two barriers, with the checkpoint
// read waiting behind it, in about 4 waves of 2 blocks an SM.
//
// What this design does: ckpt's threads (4 lanes a channel, 4 state values
// each, 64 channels a block of 256 threads) and its sums (ddt and ddtx over
// a channel's lanes, dC and dB by the halving shuffles over a warp's 8
// channels, then the warps in order into per-block partials, dA per batch
// row; the same second kernel).
// - A ring of 3 stages, each a chunk of K steps: one TMA box each of dt,
//   dtx and dy (the block's 64 channels for K steps; past di zeros), one
//   bulk copy per run of B_t and C_t, and one of the chunk's checkpoint (its
//   64 channels' states, 4 KB), issued by one thread two chunks ahead, in
//   time order for the forward walk (dt, dtx and B_t only) and in reverse
//   for the walk back, counted on the stage's mbarrier, whose wait traps
//   after 2^26 polls.  (A bulk copy per 256-byte row instead, 27 a chunk,
//   left the copy engine behind: the forward walk alone ran 35 % slower than
//   ckpt's.)  A landed chunk's B_t and C_t are widened to fp32 once, into
//   one of two buffers, not at every read by every lane.  One block-wide
//   barrier a chunk: each chunk's dC and dB partials are double-buffered and
//   added after the next chunk's barrier; ddt and ddtx are stored from
//   registers.
// - The recompute takes a_t = expf(dt_t A) once and keeps it in shared
//   memory beside h_{t-1}, so the walk back takes none: two exponentials a
//   (channel, state, step), not three.  h_t for dC is the state the walk
//   back held a step before.  expf stays: the forward's ex2.approx of a
//   prescaled A put ddtx 5.5e-4 past the limit (lambda sums over up to S
//   steps).
// - K = 8, the route (checkpoints 268 MB each way at Jamba's training shape,
//   h_{t-1} and a_t 64 KB: two blocks of 8 warps an SM), or K = 16 (134 MB,
//   128 KB: one block an SM, too few warps to cover the exponentials'
//   latency); both reachable through the entry, and without the reuse of
//   a_t, for timing.  A full chunk's steps are unrolled with no bound check
//   between them, in the three walks.

namespace ring {

constexpr int kStages = 3;  // the chunk walked, two in flight

using bwd::kChannels;
using bwd::kThreads;
using bwd::kWarps;
using bwd::kSlots;
using bwd::kFull;

template <typename T, int K>
struct Smem {
  alignas(128) T dt[kStages][K][kChannels];   // TMA boxes: 64 channels x K steps
  alignas(128) T dtx[kStages][K][kChannels];
  alignas(128) T dy[kStages][K][kChannels];
  alignas(16) T bm[kStages][K * 16];   // a chunk's B_t, ds values a step
  alignas(16) T cm[kStages][K * 16];   // and C_t
  alignas(16) float4 ck[kStages][kThreads];  // the chunk's checkpoint: a thread's 4 values
  alignas(16) float fb[2][K * 16], fc[2][K * 16];  // B_t and C_t in fp32, by chunk
  alignas(16) float4 hist[K - 1][kThreads];  // h_{t-1} at the chunk's steps 1 .. K - 1
  alignas(16) float4 av[K][kThreads];        // a_t = exp(dt_t A) at each step
  alignas(16) float red[2][K][kWarps][kSlots];  // each warp's sums of dC and dB, by chunk
  uint64_t full[kStages];
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) { return lanes::load4(p); }

// Block (64 channels, batch row); thread tid is lane q = tid % 4 of channel
// c0 + tid / 4 and holds its states 4q .. 4q + 3 (a lane past ds holds zeros).
template <typename T, int K, bool REUSE>
__global__ void __launch_bounds__(kThreads, K >= 16 ? 1 : 2)
mamba_scan_bwd_ring_kernel(const __grid_constant__ CUtensorMap tm_dt,
                           const __grid_constant__ CUtensorMap tm_dtx,
                           const __grid_constant__ CUtensorMap tm_dy,
                           const T* __restrict__ Bm, const T* __restrict__ Cm,
                           const T* __restrict__ A, const float* __restrict__ h0,
                           const float* __restrict__ dh_last, float* __restrict__ ckpt,
                           float* __restrict__ bc_part, float* __restrict__ dA_part,
                           T* __restrict__ ddt, T* __restrict__ ddtx, float* __restrict__ dh0,
                           int S, int di, int ds) {
  using Sm = Smem<T, K>;
  // no static shared memory: the dynamic block starts at the window, aligned for TMA
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x, q = tid & 3, g = tid >> 2, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, c0 = blockIdx.x * kChannels, c = c0 + g;
  const bool live = c < di, on = live && 4 * q < ds;
  const long long row0 = (long long)b * S;
  const int n_ck = (S + K - 1) / K;
  const uint32_t ck_bytes = min(kChannels, di - c0) * 16 * 4;  // a chunk's checkpoint
  // chunk j's checkpoint of the block's channels: ck_g + j * ck_stride
  float* ck_g = ckpt + ((long long)b * n_ck * di + c0) * 16;
  const long long ck_stride = (long long)di * 16;

  // Chunk j into stage `use` % kStages (one thread): a TMA box of dt, dtx
  // (and dy) each, the block's 64 channels for K steps (past the tensor's
  // end zeros, which count too), a bulk copy of the run of B_t (and C_t)
  // and, walking back, one of the checkpoint, all counted on the stage's
  // barrier.
  auto fill = [&](int use, int j, bool back) {
    const int st = use % kStages, t0 = j * K, steps = min(K, S - t0);
    const int rw = (int)(row0 + t0);
    const uint32_t run = steps * ds * sizeof(T), box = K * kChannels * sizeof(T);
    hopper::mbar_arrive_expect_tx(&sm.full[st], back ? 3 * box + 2 * run + ck_bytes : 2 * box + run);
    hopper::tma_load_3d(sm.dt[st], &tm_dt, &sm.full[st], c0, rw, 0);
    hopper::tma_load_3d(sm.dtx[st], &tm_dtx, &sm.full[st], c0, rw, 0);
    hopper::bulk_load(sm.bm[st], Bm + (row0 + t0) * ds, run, &sm.full[st]);
    if (back) {
      hopper::tma_load_3d(sm.dy[st], &tm_dy, &sm.full[st], c0, rw, 0);
      hopper::bulk_load(sm.cm[st], Cm + (row0 + t0) * ds, run, &sm.full[st]);
      hopper::bulk_load(sm.ck[st], ck_g + j * ck_stride, ck_bytes, &sm.full[st]);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&sm.full[st], 1);
    hopper::mbar_fence_init();
    for (int j = 0; j < kStages - 1 && j < n_ck; ++j) fill(j, j, false);
  }
  __syncthreads();  // the barriers are set up before anyone waits on them

  float Av[4] = {0.f, 0.f, 0.f, 0.f}, h[4] = {0.f, 0.f, 0.f, 0.f};
  const long long state = ((long long)b * di + c) * ds + 4 * q;
  if (on) {
    const float4 a4 = ld4(A + (long long)c * ds + 4 * q);
    Av[0] = a4.x, Av[1] = a4.y, Av[2] = a4.z, Av[3] = a4.w;
    if (h0 != nullptr) {
      const float4 v = ld4(h0 + state);
      h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
    }
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // A landed chunk's B_t (and C_t) once into fp32, into buffer `buf`: the
  // chunk two back used it, and everyone passed a barrier since.
  auto widen = [&](int st, int buf, int steps, bool back) {
    for (int e = tid; e < steps * ds; e += kThreads) {
      sm.fb[buf][e] = lanes::to_f(sm.bm[st][e]);
      if (back) sm.fc[buf][e] = lanes::to_f(sm.cm[st][e]);
    }
  };

  // the forward walk: the state at the start of every chunk
  for (int j = 0; j < n_ck; ++j) {
    const int st = j % kStages, steps = min(K, S - j * K);
    hopper::mbar_wait(&sm.full[st], (j / kStages) & 1);
    widen(st, j & 1, steps, false);
    __syncthreads();  // everyone is done with chunk j - 1, whose stage is refilled
    if (tid == 0 && j + kStages - 1 < n_ck) fill(j + kStages - 1, j + kStages - 1, false);
    if (live) reinterpret_cast<float4*>(ck_g + j * ck_stride)[tid] = make_float4(h[0], h[1], h[2], h[3]);
    auto advance = [&](auto full) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if constexpr (!decltype(full)::value)
          if (s >= steps) break;
        const float d = live ? lanes::to_f(sm.dt[st][s][g]) : 0.f;
        const float x = live ? lanes::to_f(sm.dtx[st][s][g]) : 0.f;
        const float4 bq = on ? ld4(&sm.fb[j & 1][s * ds + 4 * q]) : zero;
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int n = 0; n < 4; ++n) h[n] = fmaf(expf(d * Av[n]), h[n], x * bv[n]);
      }
    };
    if (steps == K) advance(hopper::Full<true>{});
    else advance(hopper::Full<false>{});
  }
  hopper::fence_proxy_async_global();  // the checkpoints, before bulk copies read them
  __syncthreads();
  if (tid == 0) {
    fill(n_ck, n_ck - 1, true);
    if (n_ck > 1) fill(n_ck + 1, n_ck - 2, true);
  }

  // the walk back
  float carry[4] = {0.f, 0.f, 0.f, 0.f}, dA[4] = {0.f, 0.f, 0.f, 0.f};
  if (on && dh_last != nullptr) {
    const float4 v = ld4(dh_last + state);
    carry[0] = v.x, carry[1] = v.y, carry[2] = v.z, carry[3] = v.w;
  }
  // the block's partial of dC and dB at each step of a walked chunk: the
  // warps' sums in order
  auto sum_bc = [&](int buf, int t0, int steps) {
    for (int e = tid; e < steps * kSlots; e += kThreads) {
      const int s = e / kSlots, kk = e - s * kSlots, qq = kk >> 3, gp = kk & 7;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += sm.red[buf][s][w][kk];
      bc_part[(((long long)b * gridDim.x + blockIdx.x) * S + t0 + s) * kSlots + (gp >> 2) * 16 +
              4 * qq + (gp & 3)] = acc;
    }
  };
  for (int qc = 0; qc < n_ck; ++qc) {
    const int j = n_ck - 1 - qc, use = n_ck + qc, st = use % kStages;
    const int t0 = j * K, steps = min(K, S - t0), buf = qc & 1;
    hopper::mbar_wait(&sm.full[st], (use / kStages) & 1);
    widen(st, use & 1, steps, true);
    // everyone is done with chunk qc - 1: its stage is refilled and its
    // partials added
    __syncthreads();
    if (tid == 0 && qc + kStages - 1 < n_ck) fill(use + kStages - 1, j - (kStages - 1), true);
    if (qc > 0) sum_bc(buf ^ 1, t0 + K, min(K, S - t0 - K));
    // the chunk's states again: h_{t-1} and a_t of each step
    float4 hp = live ? sm.ck[st][tid] : zero;
    const float4 first = hp;
    auto recompute = [&](auto full) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if constexpr (!decltype(full)::value)
          if (s >= steps) break;
        if (s > 0) sm.hist[s - 1][tid] = hp;
        const float d = live ? lanes::to_f(sm.dt[st][s][g]) : 0.f;
        const float x = live ? lanes::to_f(sm.dtx[st][s][g]) : 0.f;
        const float4 bq = on ? ld4(&sm.fb[use & 1][s * ds + 4 * q]) : zero;
        const float4 a = make_float4(expf(d * Av[0]), expf(d * Av[1]), expf(d * Av[2]),
                                     expf(d * Av[3]));
        if constexpr (REUSE) sm.av[s][tid] = a;
        hp = make_float4(fmaf(a.x, hp.x, x * bq.x), fmaf(a.y, hp.y, x * bq.y),
                         fmaf(a.z, hp.z, x * bq.z), fmaf(a.w, hp.w, x * bq.w));
      }
    };
    if (steps == K) recompute(hopper::Full<true>{});
    else recompute(hopper::Full<false>{});
    float hn[4] = {hp.x, hp.y, hp.z, hp.w};  // h_t of the step walked
    // the walk back: unrolled without a bound check on a full chunk (no
    // branch between the steps, so the compiler may interleave them)
    auto walk = [&](auto full) {
#pragma unroll
    for (int s = K - 1; s >= 0; --s) {
      if constexpr (!decltype(full)::value)
        if (s >= steps) continue;
      const float4 hv = s > 0 ? sm.hist[s > 0 ? s - 1 : 0][tid] : first;
      const float d = live ? lanes::to_f(sm.dt[st][s][g]) : 0.f;
      const float x = live ? lanes::to_f(sm.dtx[st][s][g]) : 0.f;
      const float gy = live ? lanes::to_f(sm.dy[st][s][g]) : 0.f;
      const float4 bq = on ? ld4(&sm.fb[use & 1][s * ds + 4 * q]) : zero;
      const float4 cq = on ? ld4(&sm.fc[use & 1][s * ds + 4 * q]) : zero;
      float4 a4;
      if constexpr (REUSE) a4 = sm.av[s][tid];
      else a4 = make_float4(expf(d * Av[0]), expf(d * Av[1]), expf(d * Av[2]), expf(d * Av[3]));
      const float hpv[4] = {hv.x, hv.y, hv.z, hv.w}, ev[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w}, cv[4] = {cq.x, cq.y, cq.z, cq.w};
      float p_dtx = 0.f, p_dt = 0.f, v8[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lam = fmaf(gy, cv[i], carry[i]);
        const float qq = lam * hpv[i] * ev[i];
        p_dtx = fmaf(lam, bv[i], p_dtx);
        p_dt = fmaf(qq, Av[i], p_dt);
        dA[i] = fmaf(qq, d, dA[i]);
        carry[i] = ev[i] * lam;
        v8[i] = gy * hn[i];   // dy_t h_t, towards dC
        v8[4 + i] = lam * x;  // lambda_t dtx_t, towards dB
        hn[i] = hpv[i];
      }
      {  // ddtx (lanes 0, 1) and ddt (lanes 2, 3) over the channel's 4 lanes
        const bool hi = q & 2;
        float t = (hi ? p_dt : p_dtx) + __shfl_xor_sync(kFull, hi ? p_dtx : p_dt, 2);
        t += __shfl_xor_sync(kFull, t, 1);
        const long long off = (row0 + t0 + s) * di + c;
        if (live && q == 0) store(ddtx + off, t);
        if (live && q == 2) store(ddt + off, t);
      }
      // dC and dB over the warp's 8 channels, as ckpt
#pragma unroll
      for (int m = 16, n = 8; m >= 4; m /= 2, n /= 2) {
        const bool hi = lane & m;
#pragma unroll
        for (int k = 0; k < n / 2; ++k) {
          const float send = hi ? v8[k] : v8[k + n / 2];
          const float keep = hi ? v8[k + n / 2] : v8[k];
          v8[k] = keep + __shfl_xor_sync(kFull, send, m);
        }
      }
      sm.red[buf][s][warp][q * 8 + (lane >> 2)] = v8[0];
    }
    };
    if (steps == K) walk(hopper::Full<true>{});
    else walk(hopper::Full<false>{});
  }
  __syncthreads();
  sum_bc((n_ck - 1) & 1, 0, min(K, S));
  if (on) {
    *reinterpret_cast<float4*>(dA_part + state) = make_float4(dA[0], dA[1], dA[2], dA[3]);
    if (dh0 != nullptr)
      *reinterpret_cast<float4*>(dh0 + state) = make_float4(carry[0], carry[1], carry[2], carry[3]);
  }
}

template <typename T, int K>
constexpr int smem_bytes() { return (int)sizeof(Smem<T, K>); }

template <typename T, int K, bool REUSE>
cudaError_t launch(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                   const void* A, const void* h0, const void* dy, const void* dh_last,
                   void* ckpt, void* bc_part, void* dA_part, void* ddt, void* ddtx, void* dB,
                   void* dC, void* dA, void* dh0, int B, int S, int di, int ds,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, K>();
  static const cudaError_t set = cudaFuncSetAttribute(
      mamba_scan_bwd_ring_kernel<T, K, REUSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (set != cudaSuccess) return set;
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  // each (B * S, di) tensor in boxes of 64 channels for K steps
  CUtensorMap maps[3];
  const void* bases[3] = {dt, dtx, dy};
  for (int n = 0; n < 3; ++n)
    if (!hopper::encode_3d(&maps[n], sizeof(T), bases[n], di, (uint64_t)B * S, 1, di,
                           (uint64_t)B * S * di, kChannels, K, 1, 0))
      return cudaErrorInvalidValue;
  mamba_scan_bwd_ring_kernel<T, K, REUSE><<<grid, kThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const T*>(A), static_cast<const float*>(h0),
      static_cast<const float*>(dh_last), static_cast<float*>(ckpt),
      static_cast<float*>(bc_part), static_cast<float*>(dA_part), static_cast<T*>(ddt),
      static_cast<T*>(ddtx), static_cast<float*>(dh0), S, di, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = 2LL * B * S * ds + (long long)di * ds;
  const int blocks = (int)((total + 255) / 256 < 1056 ? (total + 255) / 256 : 1056);
  bwd::mamba_scan_bwd_sum_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(bc_part), static_cast<const float*>(dA_part),
      static_cast<T*>(dB), static_cast<T*>(dC), static_cast<T*>(dA), B, S, di, ds, grid.x);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_design(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                          const void* A, const void* h0, const void* dy, const void* dh_last,
                          void* ckpt, void* bc_part, void* dA_part, void* ddt, void* ddtx,
                          void* dB, void* dC, void* dA, void* dh0, int B, int S, int di, int ds,
                          int chunk, int reuse, cudaStream_t s) {
  if (chunk == 16 && reuse)
    return launch<T, 16, true>(dt, dtx, Bm, Cm, A, h0, dy, dh_last, ckpt, bc_part, dA_part, ddt,
                               ddtx, dB, dC, dA, dh0, B, S, di, ds, s);
  if (chunk == 16)
    return launch<T, 16, false>(dt, dtx, Bm, Cm, A, h0, dy, dh_last, ckpt, bc_part, dA_part, ddt,
                                ddtx, dB, dC, dA, dh0, B, S, di, ds, s);
  if (chunk == 8 && reuse)
    return launch<T, 8, true>(dt, dtx, Bm, Cm, A, h0, dy, dh_last, ckpt, bc_part, dA_part, ddt,
                              ddtx, dB, dC, dA, dh0, B, S, di, ds, s);
  if (chunk == 8)
    return launch<T, 8, false>(dt, dtx, Bm, Cm, A, h0, dy, dh_last, ckpt, bc_part, dA_part, ddt,
                               ddtx, dB, dC, dA, dh0, B, S, di, ds, s);
  return cudaErrorInvalidValue;
}

}  // namespace ring

}  // namespace

// dt, dtx, y (B, S, di); Bm, Cm (B, S, ds); A (di, ds), contiguous on the
// device in one type (dtype 0 = float32, 1 = bfloat16); h0 (B, di, ds) fp32 or
// null for zeros; h_last (B, di, ds) fp32, which may be h0.  B, S, di > 0,
// B <= 65535, 0 < ds <= 16.  Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
extern "C" int mamba_scan_simt_fwd(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                                   const void* A, const void* h0, void* y, void* h_last,
                                   int B, int S, int di, int ds, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ds < 1 || ds > kMaxDS) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, ds, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, ds, s);
  return (int)cudaErrorInvalidValue;
}

// The lanes design: the same arguments, ds in {4, 8, 12, 16}.
extern "C" int mamba_scan_lanes_fwd(const void* dt, const void* dtx, const void* Bm,
                                    const void* Cm, const void* A, const void* h0, void* y,
                                    void* h_last, int B, int S, int di, int ds, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ds < 4 || ds > lanes::kMaxDS || ds % 4) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)lanes::launch_ds<float>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, ds, s);
  if (dtype == 1)
    return (int)lanes::launch_ds<__nv_bfloat16>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di,
                                                ds, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block of the lanes design (dtype 0 = float32, 1 =
// bfloat16), for the wrapper's launch geometry to be checked against.
extern "C" int mamba_scan_lanes_smem_bytes(int dtype) {
  return dtype == 0 ? (int)sizeof(lanes::Smem<float>) : (int)sizeof(lanes::Smem<__nv_bfloat16>);
}

// The backward, the ckpt design: dt, dtx, Bm, Cm, A as for the forward, h0 (B, di, ds) fp32 or
// null for zeros, dy (B, S, di) in the input type, dh_last (B, di, ds) fp32 or
// null for zeros; scratch: ckpt (B, ceil(S / 16), di, 16), bc_part (B,
// ceil(di / 64), S, 32) and dA_part (B, di, ds), fp32; out: ddt, ddtx (B, S,
// di), dB, dC (B, S, ds) and dA (di, ds) in the input type, and dh0 (B, di,
// ds) fp32 or null.  B, S, di > 0, B <= 65535, 0 < ds <= 16.  Returns
// cudaGetLastError() after the two launches (0 on success).
extern "C" int mamba_scan_bwd(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                              const void* A, const void* h0, const void* dy, const void* dh_last,
                              void* ckpt, void* bc_part, void* dA_part, void* ddt, void* ddtx,
                              void* dB, void* dC, void* dA, void* dh0, int B, int S, int di,
                              int ds, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ds < 1 || ds > bwd::kLanes * 4) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd::launch<float>(dt, dtx, Bm, Cm, A, h0, dy, dh_last, ckpt, bc_part, dA_part,
                                   ddt, ddtx, dB, dC, dA, dh0, B, S, di, ds, s);
  if (dtype == 1)
    return (int)bwd::launch<__nv_bfloat16>(dt, dtx, Bm, Cm, A, h0, dy, dh_last, ckpt, bc_part,
                                           dA_part, ddt, ddtx, dB, dC, dA, dh0, B, S, di, ds, s);
  return (int)cudaErrorInvalidValue;
}

// The backward, the ring design: the same arguments, with ckpt (B, ceil(S /
// chunk), di, 16); chunk 8 or 16 (steps between checkpoints), reuse 1 to keep
// a_t from the recompute for the walk back (the route: chunk 8, reuse 1), 0
// to take it again there.  Rows 16-byte aligned: di and ds times the element
// size multiples of 16.  Returns cudaGetLastError() after the two launches (0
// on success).
extern "C" int mamba_scan_bwd_ring(const void* dt, const void* dtx, const void* Bm,
                                   const void* Cm, const void* A, const void* h0, const void* dy,
                                   const void* dh_last, void* ckpt, void* bc_part, void* dA_part,
                                   void* ddt, void* ddtx, void* dB, void* dC, void* dA, void* dh0,
                                   int B, int S, int di, int ds, int dtype, int chunk, int reuse,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int size = dtype == 0 ? 4 : 2;
  if (ds < 1 || ds > 16 || (di * size) % 16 || (ds * size) % 16) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)ring::launch_design<float>(dt, dtx, Bm, Cm, A, h0, dy, dh_last, ckpt, bc_part,
                                           dA_part, ddt, ddtx, dB, dC, dA, dh0, B, S, di, ds,
                                           chunk, reuse, s);
  if (dtype == 1)
    return (int)ring::launch_design<__nv_bfloat16>(dt, dtx, Bm, Cm, A, h0, dy, dh_last, ckpt,
                                                   bc_part, dA_part, ddt, ddtx, dB, dC, dA, dh0,
                                                   B, S, di, ds, chunk, reuse, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block of the ring design (dtype 0 = float32, 1 =
// bfloat16; chunk 16 or 8; -1 otherwise), for the wrapper's launch geometry
// to be checked against.
extern "C" int mamba_scan_bwd_ring_smem_bytes(int dtype, int chunk) {
  if (chunk == 16) return dtype == 0 ? ring::smem_bytes<float, 16>() : ring::smem_bytes<__nv_bfloat16, 16>();
  if (chunk == 8) return dtype == 0 ? ring::smem_bytes<float, 8>() : ring::smem_bytes<__nv_bfloat16, 8>();
  return -1;
}
