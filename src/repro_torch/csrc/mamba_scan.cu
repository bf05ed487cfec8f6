// Mamba's selective scan: for every batch row b and inner channel c, a
// diagonal linear recurrence over time with an fp32 state of ds values,
//     h_t[n] = exp(dt_t * A[c, n]) * h_{t-1}[n] + dtx_t * B_t[n],
//     y_t    = sum_n h_t[n] * C_t[n],
// from an initial state h0 (zeros when none is given), returning y and the
// last state.
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
// What this simple design does about it: one thread per (batch row, inner
// channel) keeps its ds <= 16 state values and its row of A in registers and
// walks all of S, so the state never touches device memory between steps.
// A block of 128 threads covers 128 channels of one batch row; the time axis
// is cut into chunks of 32 steps.  For each chunk, the block first copies
// its dt and dtx (each thread its own channel: coalesced, and 64 independent
// loads in flight per thread) and the chunk's B_t and C_t (shared by every
// channel of the row) into shared memory, then steps through the chunk from
// there; y is stored per step, coalesced along di.  Tails of di and S are
// masked by bounds.  `expf`, not `__expf`: the error compounds over S steps.
// Not done here: a chunked parallel scan across time for long S with few
// channels, and splitting ds across lanes to cut registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// dt, dtx, y (B, S, di); Bm, Cm (B, S, ds); A (di, ds), contiguous on the
// device in one type (dtype 0 = float32, 1 = bfloat16); h0 (B, di, ds) fp32 or
// null for zeros; h_last (B, di, ds) fp32, which may be h0.  B, S, di > 0,
// B <= 65535, 0 < ds <= 16.  Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
extern "C" int mamba_scan_fwd(const void* dt, const void* dtx, const void* Bm, const void* Cm,
                              const void* A, const void* h0, void* y, void* h_last, int B,
                              int S, int di, int ds, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ds < 1 || ds > kMaxDS) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, ds, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(dt, dtx, Bm, Cm, A, h0, y, h_last, B, S, di, ds, s);
  return (int)cudaErrorInvalidValue;
}
