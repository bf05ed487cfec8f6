// Prefill attention with online softmax, causal masking with a prefix
// offset, an optional sliding window and GQA head grouping.
//
// Replaces the Pallas kernel `flash_attention` (body `_attn_kernel`) in
// src/repro/kernels/flash_attention.py.  Plain version:
// repro_torch.kernels.ref.flash_attention_ref.
//
// Layouts: q (B, Hq, S, d); k, v (B, Hkv, T, d); out (B, Hq, S, d).  Query i
// sits at absolute position i + T - S; query head h reads kv head h / G.
// fp32 or bf16 in and out, fp32 inside.
//
// What bounds it on this card: a causal prefill does 2 * S^2 * d operations
// per query head for about 6 * S * d bytes of q, k, v and out in bf16 (with
// G = 2), so S / 3 operations per byte.  That passes the ~295 per byte at
// which an H100 turns from bound by bytes to bound by its 989 TFLOP/s tensor
// cores at S ~ 900: at the serving path's S = T = 512 the least time is still
// the bytes, and from S ~ 900 up it is the operations.  This version computes
// on the CUDA cores in fp32 (67 TFLOP/s), which is what limits it.
//
// What this simple design does about it: one block of 256 threads per
// 64-query tile and query head walks the key tiles in a loop (the TPU's
// sequential grid axis).  Q, K and V tiles sit in shared memory as fp32 and
// each thread computes a 4 x 4 block of scores and a 4 x (d/16) block of the
// output in registers, so every shared-memory value read feeds four
// multiply-adds.  Key tiles that no query of the block may see (above the
// causal diagonal, or before the window) are skipped, which halves the work of
// a causal prefill.  It runs on the CUDA cores in fp32: tensor cores (wgmma),
// TMA loads and warp specialisation are for a later version.
//
// Masking: a masked score is kNegInf, as in the JAX kernel.  Keys past T are
// excluded by bounds, not by padding.  A block holding a query with no
// allowed key at all walks every tile, so that row averages v over the real
// T, as the plain version does.
#include "attn_common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kPS = kBlockK + 1;

template <int D>
size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
                                  kBlockQ * kPS + 3 * kBlockQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
                       int S, int Tlen, int causal, int has_window, int window,
                       float scale) {
  constexpr int QS = D + 1, KS = D + 1;  // padded rows: no bank conflicts
  constexpr int CH = D / 8;              // 16-byte chunks per row
  constexpr int DJ = D / 16;             // output columns per thread
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(kBlockQ, S - q0);
  const int off = Tlen - S;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ float smem[];
  float* qs = smem;                    // kBlockQ x QS, pre-scaled
  float* ks = qs + kBlockQ * QS;       // kBlockK x KS
  float* vs = ks + kBlockK * KS;       // kBlockK x D
  float* ps = vs + kBlockK * D;        // kBlockQ x kPS: scores, then weights
  float* m_s = ps + kBlockQ * kPS;     // running max per query
  float* l_s = m_s + kBlockQ;          // running denominator
  float* a_s = l_s + kBlockQ;          // rescale of this tile
  __shared__ int key_lo, key_hi;

  const T* qb = q + (((size_t)b * Hq + h) * S + q0) * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)Tlen * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * (size_t)Tlen * D;

  for (int c = tid; c < kBlockQ * CH; c += kThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < nq) attn::load8(qb + (size_t)r * D + d0, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) qs[r * QS + d0 + i] = f[i] * scale;
  }
  for (int r = tid; r < kBlockQ; r += kThreads) {
    m_s[r] = attn::kNegInf;
    l_s[r] = 0.f;
  }
  if (tid == 0) {
    // union of the allowed key ranges of the block's queries
    int lo = Tlen, hi = -1;
    bool empty_row = false;
    for (int r = 0; r < nq; ++r) {
      const int p = q0 + r + off;
      int rl = 0, rh = Tlen - 1;
      if (causal) rh = min(rh, p);
      if (has_window) rl = max(rl, p - window + 1);
      if (rl > rh) {
        empty_row = true;
      } else {
        lo = min(lo, rl);
        hi = max(hi, rh);
      }
    }
    key_lo = empty_row ? 0 : lo;
    key_hi = empty_row ? Tlen - 1 : hi;
  }
  __syncthreads();
  const int t_begin = (key_lo / kBlockK) * kBlockK, t_end = key_hi;

  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;

  for (int t0 = t_begin; t0 <= t_end; t0 += kBlockK) {
    const int nt = min(kBlockK, Tlen - t0);
    for (int c = tid; c < nt * CH; c += kThreads) {
      const int t = c / CH, d0 = (c % CH) * 8;
      float f[8];
      attn::load8(kb + (size_t)(t0 + t) * D + d0, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) ks[t * KS + d0 + i] = f[i];
      attn::load8(vb + (size_t)(t0 + t) * D + d0, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) vs[t * D + d0 + i] = f[i];
    }
    __syncthreads();

    // scores for queries ty + 16 i and keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += a[i] * kk[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int p = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = t0 + c;
        float s = -INFINITY;  // past T: left out of the max, weight 0
        if (c < nt) {
          bool ok = true;
          if (causal) ok = ok && kp <= p;
          if (has_window) ok = ok && kp > p - window;
          s = ok ? sc[i][j] : attn::kNegInf;
        }
        ps[r * kPS + c] = s;
      }
    }
    __syncthreads();

    // online softmax: each warp owns 8 query rows, each lane two keys
    for (int rr = 0; rr < kBlockQ / 8; ++rr) {
      const int r = warp * (kBlockQ / 8) + rr;
      const float s0 = ps[r * kPS + lane];
      const float s1 = ps[r * kPS + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, attn::warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float sum = attn::warp_sum(p0 + p1);
      ps[r * kPS + lane] = p0;
      ps[r * kPS + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= alpha;
    }
    for (int t = 0; t < nt; ++t) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[t * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pw = ps[(ty + 16 * i) * kPS + t];
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] += pw * vv[j];
      }
    }
    __syncthreads();  // tiles and weights free for the next step
  }

  T* ob = out + (((size_t)b * Hq + h) * S + q0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    float l = l_s[r];
    if (l == 0.f) l = 1.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) attn::store(ob + (size_t)r * D + tx + 16 * j, o[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                   int Hkv, int S, int Tlen, int causal, int has_window, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hq, Hkv, S, Tlen, causal, has_window, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out, int B,
                     int Hq, int Hkv, int S, int Tlen, int causal, int has_window,
                     int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Hq, Hkv, S, Tlen, causal, has_window, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Hq, Hkv, S, Tlen, causal, has_window, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Hq, Hkv, S, Tlen, causal, has_window, window,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int S, int Tlen, int D,
                                   int causal, int has_window, int window, float scale,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, out, B, Hq, Hkv, S, Tlen, causal, has_window, window,
                           scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, B, Hq, Hkv, S, Tlen, causal,
                                   has_window, window, scale, s);
  return cudaErrorInvalidValue;
}
