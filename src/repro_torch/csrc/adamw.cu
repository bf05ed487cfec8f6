// AdamW over every leaf of a model in one pass: the update of the jitted
// train step.
//
// Replaces the Pallas kernel: none, the JAX package has no kernel for it.
// Its trainer jits the whole step
// (src/repro/train/train_loop.py: jax.jit(make_train_step(...))), and XLA
// fuses the update of src/repro/train/optimizer.py (apply_updates: the global
// norm, the clip, the two moments, the bias corrections, the decay, the cast
// back) into one pass over each leaf.  Plain version:
// repro_torch.kernels.ref.adamw_update_ref (global_norm and the per-leaf loop).
//
// What bounds it on this card: the bytes.  A parameter in bf16 with fp32
// moments is read as p, g, m, v (12 bytes) and written as p, m, v (10
// bytes); the norm reads g once more (2 bytes).  The arithmetic (three
// divisions and a square root an element) is a few percent of the time
// those bytes take at 3.35 TB/s.
//
// What this design does about it.  Both passes walk a table of leaves passed
// by value in the launch's own parameters (as torch's multi_tensor_apply
// does), so that a launch touches no host memory and a CUDA graph captures
// it whole; a call with more leaves than a table holds is several launches.
// Each leaf is cut into tiles of THREADS x VEC elements, the tiles of a
// table numbered one after another; a persistent grid walks them with a
// grid stride, so each block finds its leaf by moving forward through the
// table.  A thread takes VEC = 8 consecutive elements of a tile with 16-byte
// vector loads and stores (one for 8 bf16 values, two for 8 fp32 values),
// neighbouring threads on neighbouring addresses; the tail of a leaf, and a
// leaf whose pointers are not all 16-byte aligned, go element by element.
//
//   adamw_sumsq: each block sums the squares of its tiles' gradients (fp32
//   over a thread's 8 elements, fp64 across them) and writes one partial;
//   one block then sums every partial in a fixed order and writes the global
//   norm, so that two calls on the same inputs give the same norm bit for bit.
//
//   adamw_update: reads the norm, the step counter (already advanced) and
//   the learning rate from the device, computes the clip scale and the bias
//   corrections there, and updates each element in the order of the plain
//   version, each operation rounded as there (the _rn intrinsics keep the
//   compiler from contracting them): g * scale, m = b1 m + (1 - b1) g,
//   v = b2 v + (1 - b2) g^2, delta = (m / b1c) / (sqrt(v / b2c) + eps),
//   + wd p where the leaf decays (ndim >= 2), p - lr delta, written back in
//   p's dtype with round-to-nearest-even.  m and v stay fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 64;   // leaves a table (a launch) holds
constexpr int THREADS = 256;
constexpr int VEC = 8;           // consecutive elements a thread a tile
constexpr long long TILE = THREADS * VEC;
constexpr int NORM_THREADS = 1024;

// flags of a leaf
constexpr int BF16 = 1;          // p and g in bf16 (else fp32)
constexpr int DECAY = 2;         // weight decay applies (ndim >= 2)
constexpr int ALIGNED = 4;       // p, g, m and v all 16-byte aligned

// The leaves of one launch.  The layout is mirrored by the ctypes structure
// of repro_torch/kernels/adamw.py (3344 bytes, under the 4 KB of a launch's
// parameters): tile_start[i] is the number of tiles of leaves 0..i-1.
struct Table {
  long long tile_start[MAX_LEAVES + 1];
  long long numel[MAX_LEAVES];
  const void* g[MAX_LEAVES];
  void* p[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  int n_leaves;
  int flags[MAX_LEAVES];
};
static_assert(sizeof(Table) == 3344, "Table must match repro_torch/kernels/adamw.py");

struct Hyper {
  float scale, lr, b1, b2, one_minus_b1, one_minus_b2, b1c, b2c, eps, wd;
};

__device__ __forceinline__ void load8(const void* base, long long e, bool bf16, float x[VEC]) {
  if (bf16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + e));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(base) + e);
    const float4 a = __ldg(q), b = __ldg(q + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

__device__ __forceinline__ float load1(const void* base, long long e, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[e])
              : static_cast<const float*>(base)[e];
}

// Sum over a block in a fixed order: down each warp, then across the warps.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warps[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? warps[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

__global__ void __launch_bounds__(THREADS) sumsq_kernel(const __grid_constant__ Table t,
                                                        double* __restrict__ partials) {
  double acc = 0.0;
  int leaf = 0;
  const long long tiles = t.tile_start[t.n_leaves];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    while (tile >= t.tile_start[leaf + 1]) ++leaf;
    const long long n = t.numel[leaf];
    const long long e = (tile - t.tile_start[leaf]) * TILE + threadIdx.x * VEC;
    const bool bf16 = t.flags[leaf] & BF16;
    float s = 0.f;
    if ((t.flags[leaf] & ALIGNED) && e + VEC <= n) {
      float x[VEC];
      load8(t.g[leaf], e, bf16, x);
#pragma unroll
      for (int k = 0; k < VEC; ++k) s = __fmaf_rn(x[k], x[k], s);
    } else {
      for (long long i = e; i < n && i < e + VEC; ++i) {
        const float x = load1(t.g[leaf], i, bf16);
        s = __fmaf_rn(x, x, s);
      }
    }
    acc += (double)s;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(NORM_THREADS) norm_kernel(const double* __restrict__ partials,
                                                            int n, float* __restrict__ gnorm) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += NORM_THREADS) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *gnorm = (float)sqrt(acc);
}

__device__ __forceinline__ void update1(float& p, float g, float& m, float& v, const Hyper& h,
                                        bool decay) {
  g = __fmul_rn(g, h.scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.one_minus_b2, __fmul_rn(g, g)));
  float delta = __fdiv_rn(__fdiv_rn(m, h.b1c),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.b2c)), h.eps));
  if (decay) delta = __fadd_rn(delta, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, delta));
}

__global__ void __launch_bounds__(THREADS) update_kernel(
    const __grid_constant__ Table t, const float* __restrict__ gnorm,
    const int* __restrict__ step, const float* __restrict__ lr, float b1, float b2,
    float one_minus_b1, float one_minus_b2, float eps, float wd, float clip) {
  Hyper h;
  // scale = min(1, clip / (gnorm + 1e-9)), NaN kept as torch.clamp keeps it
  const float s = __fdiv_rn(clip, __fadd_rn(*gnorm, 1e-9f));
  h.scale = s > 1.f ? 1.f : s;
  const float stepf = (float)*step;
  h.b1c = __fsub_rn(1.f, powf(b1, stepf));
  h.b2c = __fsub_rn(1.f, powf(b2, stepf));
  h.lr = *lr;
  h.b1 = b1; h.b2 = b2; h.one_minus_b1 = one_minus_b1; h.one_minus_b2 = one_minus_b2;
  h.eps = eps; h.wd = wd;

  int leaf = 0;
  const long long tiles = t.tile_start[t.n_leaves];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    while (tile >= t.tile_start[leaf + 1]) ++leaf;
    const long long n = t.numel[leaf];
    const long long e = (tile - t.tile_start[leaf]) * TILE + threadIdx.x * VEC;
    const int flags = t.flags[leaf];
    const bool bf16 = flags & BF16, decay = flags & DECAY;
    float* m = t.m[leaf];
    float* v = t.v[leaf];
    if ((flags & ALIGNED) && e + VEC <= n) {
      float p8[VEC], g8[VEC], m8[VEC], v8[VEC];
      load8(t.g[leaf], e, bf16, g8);
      float4* mq = reinterpret_cast<float4*>(m + e);
      float4* vq = reinterpret_cast<float4*>(v + e);
      const float4 ma = mq[0], mb = mq[1], va = vq[0], vb = vq[1];
      m8[0] = ma.x; m8[1] = ma.y; m8[2] = ma.z; m8[3] = ma.w;
      m8[4] = mb.x; m8[5] = mb.y; m8[6] = mb.z; m8[7] = mb.w;
      v8[0] = va.x; v8[1] = va.y; v8[2] = va.z; v8[3] = va.w;
      v8[4] = vb.x; v8[5] = vb.y; v8[6] = vb.z; v8[7] = vb.w;
      if (bf16) {
        uint4* pq = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(t.p[leaf]) + e);
        const uint4 raw = *pq;
        const __nv_bfloat162* ph = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int k = 0; k < VEC / 2; ++k) {
          const float2 f = __bfloat1622float2(ph[k]);
          p8[2 * k] = f.x;
          p8[2 * k + 1] = f.y;
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) update1(p8[k], g8[k], m8[k], v8[k], h, decay);
        uint4 out;
        __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int k = 0; k < VEC / 2; ++k) oh[k] = __floats2bfloat162_rn(p8[2 * k], p8[2 * k + 1]);
        *pq = out;
      } else {
        float4* pq = reinterpret_cast<float4*>(static_cast<float*>(t.p[leaf]) + e);
        const float4 pa = pq[0], pb = pq[1];
        p8[0] = pa.x; p8[1] = pa.y; p8[2] = pa.z; p8[3] = pa.w;
        p8[4] = pb.x; p8[5] = pb.y; p8[6] = pb.z; p8[7] = pb.w;
#pragma unroll
        for (int k = 0; k < VEC; ++k) update1(p8[k], g8[k], m8[k], v8[k], h, decay);
        pq[0] = make_float4(p8[0], p8[1], p8[2], p8[3]);
        pq[1] = make_float4(p8[4], p8[5], p8[6], p8[7]);
      }
      mq[0] = make_float4(m8[0], m8[1], m8[2], m8[3]);
      mq[1] = make_float4(m8[4], m8[5], m8[6], m8[7]);
      vq[0] = make_float4(v8[0], v8[1], v8[2], v8[3]);
      vq[1] = make_float4(v8[4], v8[5], v8[6], v8[7]);
    } else {
      for (long long i = e; i < n && i < e + VEC; ++i) {
        const float g = load1(t.g[leaf], i, bf16);
        float p = load1(t.p[leaf], i, bf16), mi = m[i], vi = v[i];
        update1(p, g, mi, vi, h, decay);
        if (bf16) static_cast<__nv_bfloat16*>(t.p[leaf])[i] = __float2bfloat16_rn(p);
        else static_cast<float*>(t.p[leaf])[i] = p;
        m[i] = mi;
        v[i] = vi;
      }
    }
  }
}

}  // namespace

// The global norm of the gradients of `n_tables` tables (host memory, each
// passed by value to its launch), launch i on a grid of grids[i] blocks
// writing its partials after those of launches 0..i-1 into `partials` (fp64,
// sum of grids entries); then one block sums the partials in order into
// `gnorm` (fp32, on the device).  Returns the first launch error, else 0.
extern "C" int adamw_sumsq(const void* tables, int n_tables, const int* grids, void* partials,
                           void* gnorm, void* stream) {
  const Table* t = static_cast<const Table*>(tables);
  double* out = static_cast<double*>(partials);
  int n = 0;
  for (int i = 0; i < n_tables; ++i) {
    sumsq_kernel<<<grids[i], THREADS, 0, (cudaStream_t)stream>>>(t[i], out + n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    n += grids[i];
  }
  norm_kernel<<<1, NORM_THREADS, 0, (cudaStream_t)stream>>>(out, n, static_cast<float*>(gnorm));
  return (int)cudaGetLastError();
}

// The update of every leaf of `n_tables` tables, launch i on grids[i]
// blocks, with the norm from adamw_sumsq, the step counter (int32, already
// advanced to the step being taken) and the learning rate (fp32), all three
// on the device.  Returns the first launch error, else 0.
extern "C" int adamw_update(const void* tables, int n_tables, const int* grids,
                            const void* gnorm, const void* step, const void* lr, double b1,
                            double b2, double eps, double weight_decay, double grad_clip,
                            void* stream) {
  const Table* t = static_cast<const Table*>(tables);
  for (int i = 0; i < n_tables; ++i) {
    update_kernel<<<grids[i], THREADS, 0, (cudaStream_t)stream>>>(
        t[i], static_cast<const float*>(gnorm), static_cast<const int*>(step),
        static_cast<const float*>(lr), (float)b1, (float)b2, (float)(1.0 - b1),
        (float)(1.0 - b2), (float)eps, (float)weight_decay, (float)grad_clip);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
