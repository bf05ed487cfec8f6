// GQA decode attention: one query token per sequence against the KV cache.
//
// Replaces the Pallas kernel `decode_attention` (body `_decode_kernel`) in
// src/repro/kernels/decode_attention.py.  Plain version:
// repro_torch.kernels.ref.decode_attention_ref.
//
// Layouts: q (B, Hq, d); k, v (B, T, Hkv, d), the model's cache layout;
// valid (B, T) uint8; out (B, Hq, d).  fp32 or bf16 in and out, fp32 inside.
//
// What bounds it on this card: the KV bytes.  Each cache element is read
// once and used for G = Hq/Hkv multiply-adds per score and per output, far
// below the ~295 operations per byte at which an H100 stops being bound by
// memory, so the least time is the cache size over 3.35 TB/s.
//
// What this simple design does about it: one block per (kv head, batch row)
// walks the cache in tiles of 64 slots, in a loop that takes the place of the
// TPU's sequential grid axis.  Each tile of K and V is read from device
// memory exactly once, with 16-byte loads, into shared memory as fp32, and
// all G query heads of the kv head are scored against it, so the cache is
// read once and not G times.  The online softmax (running max, denominator
// and fp32 accumulator) lives in shared memory.  Not done here: splitting T
// across blocks (B x Hkv blocks leave SMs idle at small batch) and overlapping
// the next tile's loads with this tile's arithmetic.
//
// Masking: an invalid slot scores kNegInf, as in the JAX kernel.  Slots past
// T are excluded by bounds, not by padding, so a row with no valid slot
// averages v over the real T, as the plain version does.
#include "attn_common.cuh"

namespace {

constexpr int kBlockK = 64;     // cache slots per tile: two per lane
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int D>
__host__ __device__ constexpr int k_stride() { return D + 1; }  // no bank conflicts

template <int D>
size_t smem_bytes(int G) {
  return sizeof(float) * (size_t)(2 * G * D + kBlockK * k_stride<D>() + kBlockK * D +
                                  G * kBlockK + 3 * G);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const unsigned char* __restrict__ valid,
                        T* __restrict__ out, int Hq, int Hkv, int Tlen, float scale) {
  constexpr int KS = k_stride<D>();
  constexpr int CH = D / 8;  // 16-byte chunks per row
  const int G = Hq / Hkv;
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ float smem[];
  float* qs = smem;                   // G x D, pre-scaled
  float* ks = qs + G * D;             // kBlockK x KS
  float* vs = ks + kBlockK * KS;      // kBlockK x D
  float* ps = vs + kBlockK * D;       // G x kBlockK: scores, then weights
  float* acc = ps + G * kBlockK;      // G x D
  float* m_s = acc + G * D;           // G running max
  float* l_s = m_s + G;               // G running denominator
  float* a_s = l_s + G;               // G rescale of this tile

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int c = tid; c < G * CH; c += kThreads) {
    float f[8];
    attn::load8(qb + c * 8, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) qs[c * 8 + i] = f[i] * scale;
  }
  for (int e = tid; e < G * D; e += kThreads) acc[e] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = attn::kNegInf;
    l_s[g] = 0.f;
  }

  const size_t row = (size_t)Hkv * D;  // elements between consecutive slots
  const T* kb = k + (size_t)b * Tlen * row + (size_t)h * D;
  const T* vb = v + (size_t)b * Tlen * row + (size_t)h * D;
  const unsigned char* vab = valid + (size_t)b * Tlen;

  for (int t0 = 0; t0 < Tlen; t0 += kBlockK) {
    const int nt = min(kBlockK, Tlen - t0);
    __syncthreads();  // previous tile fully consumed (and q/acc set up)
    for (int c = tid; c < nt * CH; c += kThreads) {
      const int t = c / CH, d0 = (c % CH) * 8;
      float f[8];
      attn::load8(kb + (size_t)(t0 + t) * row + d0, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) ks[t * KS + d0 + i] = f[i];
      attn::load8(vb + (size_t)(t0 + t) * row + d0, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) vs[t * D + d0 + i] = f[i];
    }
    __syncthreads();

    // scores: one (head, slot) pair per thread and step
    for (int idx = tid; idx < G * kBlockK; idx += kThreads) {
      const int g = idx / kBlockK, t = idx % kBlockK;
      float s = -INFINITY;  // past T: left out of the max, weight 0
      if (t < nt) {
        s = attn::kNegInf;
        if (vab[t0 + t]) {
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += qs[g * D + d] * ks[t * KS + d];
          s = dot;
        }
      }
      ps[idx] = s;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = ps[g * kBlockK + lane];
      const float s1 = ps[g * kBlockK + lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, attn::warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float sum = attn::warp_sum(p0 + p1);
      ps[g * kBlockK + lane] = p0;
      ps[g * kBlockK + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * D; idx += kThreads) {
      const int g = idx / D, c = idx % D;
      float a = acc[idx] * a_s[g];
      for (int t = 0; t < nt; ++t) a += ps[g * kBlockK + t] * vs[t * D + c];
      acc[idx] = a;
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int idx = tid; idx < G * D; idx += kThreads) {
    float l = l_s[idx / D];
    if (l == 0.f) l = 1.f;
    attn::store(ob + idx, acc[idx] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid,
                   void* out, int B, int Hq, int Hkv, int Tlen, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(Hq / Hkv);
  auto kernel = decode_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(valid), static_cast<T*>(out), Hq, Hkv, Tlen, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* valid,
                     void* out, int B, int Hq, int Hkv, int Tlen, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, valid, out, B, Hq, Hkv, Tlen, scale, stream);
    case 64: return launch<T, 64>(q, k, v, valid, out, B, Hq, Hkv, Tlen, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, out, B, Hq, Hkv, Tlen, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, int B, int Hq, int Hkv,
                                    int Tlen, int D, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, valid, out, B, Hq, Hkv, Tlen, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, valid, out, B, Hq, Hkv, Tlen, scale, s);
  return cudaErrorInvalidValue;
}
