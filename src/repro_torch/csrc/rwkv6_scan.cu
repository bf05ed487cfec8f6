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
// own column once before it writes it once.  The arithmetic and the state are
// fp32, and o is rounded once to the input type.
//
// What bounds it on this card: at RWKV6-1.6B's prefill (B 8, T 512, H 32,
// hd 64, fp32) the kernel must move 176 MB (r, k, v, w and o, 33.6 MB each,
// and the last state), 0.053 ms at 3.35 TB/s.  The function needs 5 fp32
// operations at each of the B * T * H * hd * hd = 537 M (i, j) updates (an FMA
// for o, since o_t[j] = sum_i r_i S[i, j] + v_j sum_i r_i u_i k_i, and a MUL
// and an FMA for S), 2.7 GFLOP, 0.041 ms at the 66.9 TFLOP/s of the CUDA
// cores: bound by the bytes.  This kernel spends 7 (it folds u_i k_i v_j into
// each term of o).  At a decode step (T = 1) it is the state, 4.2 MB read and
// written, a few microseconds.
//
// What this simple design does about it: one block of hd threads per (batch
// row, head); thread j owns column j of S, hd floats in registers, so the
// output o_t[j] needs no reduction across threads and the update is local.
// The time axis is cut into chunks of 2048 / hd steps.  For each chunk the
// block copies r_t, k_t, w_t and v_t into shared memory (thread j loads
// element j of each step: coalesced, and many loads in flight), packing
// (r_i, k_i, w_i, u_i) into one float4 so that each i of a step is one
// broadcast 16-byte shared-memory load for all threads.  The sum over i runs
// in four partial sums, so that the chain of dependent adds is a quarter of
// hd long.  Any T is covered by bounds.  Not done here: more threads per head
// (i split across lanes with a shuffle reduction) to fill the card at small
// B * H, and the chunked matrix form of the recurrence on the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// r, k, v, w, o (B, T, H, hd); u (H, hd), contiguous on the device in one type
// (dtype 0 = float32, 1 = bfloat16); S0 (B, H, hd, hd) fp32 or null for zeros;
// S_last (B, H, hd, hd) fp32, which may be S0.  B, T, H > 0, B * H < 2**31,
// hd in {16, 32, 64}.  Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* S0, void* o, void* S_last, int B,
                              int T_len, int H, int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>(r, k, v, w, u, S0, o, S_last, B, T_len, H, hd, s);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(r, k, v, w, u, S0, o, S_last, B, T_len, H, hd, s);
  return (int)cudaErrorInvalidValue;
}
