// GQA decode attention: one query token per sequence against the KV cache.
//
// Replaces the Pallas kernel `decode_attention` (body `_decode_kernel`) in
// src/repro/kernels/decode_attention.py.  Plain version:
// repro_torch.kernels.ref.decode_attention_ref.
//
// Layouts: q (B, Hq, d); k, v (B, T, Hkv, d), the model's cache layout;
// valid (B, T) uint8; out (B, Hq, d).  fp32 or bf16 in and out, fp32 inside.
// d is 32, 64, 120 or 128: a row of 120 bf16 values is 15 chunks of 16
// bytes, so every row and slot stays 16-byte aligned.
//
// What bounds it on this card: the KV bytes.  Each cache element is read
// once and used for G = Hq/Hkv multiply-adds per score and per output, far
// below the ~295 operations per byte at which an H100 stops being bound by
// memory, so the least time is the bytes of the valid slots over 3.35 TB/s
// (an invalid slot cannot change the output, so it need not be read).
//
// Two designs, one C entry point each; the wrapper picks the route from the
// dtype, G and T before the launch (kernels/decode_attention.py: route),
// never after a failure: bf16 with G in {1, 2, 4, 8} and T up to 2^20 ->
// "split" (decode_attention_split_fwd), everything else -> "simt"
// (decode_attention_fwd).  The simt design also takes bf16 through its own
// entry point, so the two can be timed against each other.
//
// What this design does about it (split, bf16; flash-decoding).  The
// previous design ran one block per (kv head, batch row), 64 blocks on 132
// SMs at the serving shape, read every slot valid or not, widened K and V to
// fp32 in shared memory and never overlapped a load with arithmetic.  Here:
// - A block first reads the row's T valid bytes (16 at a time) and flags
//   the 64-slot tiles that hold a valid slot; a tile with none is never
//   loaded.  A row with no valid slot at all flags every tile and scores
//   every slot kNegInf, so it averages v over the real T as before.
// - The live tiles of a (batch row, kv head) are dealt out in order and
//   evenly to up to eight splits, one block each, so the splits stream equal
//   bytes whatever the mask; the wrapper picks as many splits as keep the
//   blocks within one per SM.  Each block keeps its partial (m, l, acc[G][d])
//   in fp32 in shared memory.  The splits of a (row, head) are the blocks of
//   one thread block cluster: block 0 reads the others' partials through the
//   cluster's shared memory and combines them by log-sum-exp in split order,
//   so the result does not depend on timing, with no workspace and no
//   atomics.  A split that got no tile has m = -inf and l = 0 and weight 0,
//   never NaN.
// - One producer thread loads the split's tiles of K and V, bf16 as they are
//   in the cache, by TMA (a 3-D tensor map {d, Hkv, B*T}, box {d, 1, 64})
//   into a ring of three stages; mbarriers count the bytes and trap on a
//   wait that never ends.
// - Four consumer warps each take 16 slots of every tile, two (d > 64) or
//   more at a time: a lane owns 8 of the d columns of one slot, its part of
//   each of the G dots is summed over the 16 lanes of the slot by shuffles,
//   and it keeps l and acc over its own slots, so only the running max
//   crosses slots; the warps are merged in shared memory at the end.  No
//   block-wide barrier runs per tile.
// - The arithmetic stays on the CUDA cores, in fp32.  At G <= 8 each bf16
//   element of K or V feeds G multiply-adds, a few operations per byte, well
//   inside what the CUDA cores do while 3.35 TB/s streams in; the tensor
//   cores' smallest tile (64 rows by wgmma, 16 by mma.sync) would be 8 to 64
//   times larger than the G query rows, and pay only in work that is not done.
//
// The simt design (fp32): one block per (kv head, batch row) walks the cache
// in tiles of 64 slots.  Each tile of K and V is read from device memory
// once, with 16-byte loads, into shared memory as fp32, and all G query
// heads of the kv head are scored against it, so the cache is read once and
// not G times.  The online softmax lives in shared memory.
//
// Masking, both designs: an invalid slot scores kNegInf, as in the JAX
// kernel.  Slots past T are excluded by bounds, not by padding, so a row with
// no valid slot averages v over the real T, as the plain version does.
#include "attn_common.cuh"
#include "hopper.cuh"

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
    case 120: return launch<T, 120>(q, k, v, valid, out, B, Hq, Hkv, Tlen, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, out, B, Hq, Hkv, Tlen, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The split design (bf16)

namespace split {

constexpr int kTile = 64;                   // cache slots per tile
constexpr int kWarps = 4;                   // consumer warps, 16 slots of each tile each
constexpr int kSlotsPerWarp = kTile / kWarps;
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kMaxStages = 3;
constexpr int kMaxSplits = 8;               // splits of a (row, head): one cluster
constexpr int kMaxT = 1 << 20;              // cache slots of a row at most
constexpr int kMaxTiles = kMaxT / kTile;    // tiles of one split at most: a whole row

template <int D>
__host__ __device__ constexpr int tile_bytes() { return kTile * D * 2; }   // a K or V tile

// Dynamic shared memory: the ring of K and V tiles (1024-byte aligned), its
// mbarriers, the warps' partials (m, l and acc per head), the block's, the
// split's live tiles and a flag per tile of the row.
template <int D, int G>
constexpr size_t smem_bytes(int stages, int tiles, int n_tiles) {
  return 1024 + (size_t)stages * 2 * tile_bytes<D>() + 8 * 2 * kMaxStages +
         sizeof(float) * (kWarps + 1) * G * (D + 2) + sizeof(int) * tiles + n_tiles;
}
// The largest block (d = 128, G = 8, one split over a row of kMaxT slots)
// fits an SM, so every split count the wrapper picks for T <= kMaxT launches.
static_assert(smem_bytes<128, 8>(kMaxStages, kMaxTiles, kMaxTiles) <= 227 * 1024,
              "the split design's shared memory exceeds an SM's");

// A float in the shared memory of block `rank` of the cluster, at the place
// of `p` in this block's.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(hopper::cluster_addr(p, rank)) : "memory");
  return v;
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __nv_bfloat16* __restrict__ q,
                    const unsigned char* __restrict__ valid, __nv_bfloat16* __restrict__ out,
                    int Hkv, int Tlen, int tiles_per_split, int stages, float scale_log2) {
  constexpr int TB = tile_bytes<D>();
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x, Hq = Hkv * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * 2 * TB);
  uint64_t* empty = full + kMaxStages;
  float* w_ml = reinterpret_cast<float*>(empty + kMaxStages);   // [warp][g] (m, l)
  float* w_acc = w_ml + kWarps * G * 2;                          // [warp][g][D]
  float* b_ml = w_acc + kWarps * G * D;                          // the block's: [g] (m, l)
  float* b_acc = b_ml + G * 2;                                   // [g][D]
  int* live = reinterpret_cast<int*>(b_acc + G * D);             // the split's live tiles
  unsigned char* flag = reinterpret_cast<unsigned char*>(live + tiles_per_split);   // [tile]
  __shared__ int n_live_s;

  // ---- which tiles of the row hold a valid slot; the split's share of them
  const int n_tiles = (Tlen + kTile - 1) / kTile;
  const unsigned char* vrow = valid + (size_t)b * Tlen;
  for (int i = tid; i < n_tiles; i += kThreads) flag[i] = 0;
  __syncthreads();
  // the row's valid bytes, 16 at a time from the first 16-byte boundary
  int any = 0;
#define MARK(t)           \
  do {                    \
    any = 1;              \
    flag[(t) / kTile] = 1; \
  } while (0)
  const int head = min(Tlen, (int)((16 - (reinterpret_cast<uintptr_t>(vrow) & 15)) & 15));
  const int nvec = (Tlen - head) / 16;
  for (int t = tid; t < head; t += kThreads)
    if (vrow[t]) MARK(t);
  for (int i = tid; i < nvec; i += kThreads) {
    const uint4 w = reinterpret_cast<const uint4*>(vrow + head)[i];
    const int t = head + 16 * i;
    if ((w.x | w.y | w.z | w.w) == 0u) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t word = j < 4 ? w.x : j < 8 ? w.y : j < 12 ? w.z : w.w;
      if ((word >> (8 * (j & 3))) & 0xFFu) MARK(t + j);
    }
  }
  for (int t = head + 16 * nvec + tid; t < Tlen; t += kThreads)
    if (vrow[t]) MARK(t);
#undef MARK
  const int row_any = __syncthreads_or(any);
  if (warp == 0) {
    // The live tiles of the row, in order, are dealt out evenly: split s
    // takes those of rank [s N / nsplit, (s + 1) N / nsplit).  A row with no
    // valid slot skips nothing: every tile is live, and v is averaged over T.
    int total = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const int i = base + lane;
      total += __popc(__ballot_sync(0xffffffffu, i < n_tiles && (!row_any || flag[i])));
    }
    const int lo = split * total / nsplit, hi = (split + 1) * total / nsplit;
    for (int base = 0, seen = 0; base < n_tiles && seen < hi; base += 32) {
      const int i = base + lane;
      const bool on = i < n_tiles && (!row_any || flag[i]);
      const uint32_t m = __ballot_sync(0xffffffffu, on);
      const int r = seen + __popc(m & ((1u << lane) - 1u));
      if (on && r >= lo && r < hi) live[r - lo] = i;
      seen += __popc(m);
    }
    if (lane == 0) {
      n_live_s = hi - lo;
      for (int s = 0; s < kMaxStages; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], kWarps);
      }
      hopper::mbar_fence_init();
    }
  }
  __syncthreads();
  const int n_live = n_live_s;

  if (warp == kWarps) {
    // ---- producer: one thread loads the live tiles of K and V
    if (lane == 0 && n_live) {
      hopper::tma_prefetch_map(&tm_k);
      hopper::tma_prefetch_map(&tm_v);
      for (int i = 0; i < n_live; ++i) {
        const int st = i % stages;
        uint8_t* dst = ring + st * 2 * TB;
        const int row = b * Tlen + live[i] * kTile;   // slots past T are not used
        hopper::mbar_wait(&empty[st], ((i / stages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * TB);
        hopper::tma_load_3d(dst, &tm_k, &full[st], 0, h, row);
        hopper::tma_load_3d(dst + TB, &tm_v, &full[st], 0, h, row);
      }
    }
  } else {

    // ---- consumers: warp w scores slots 16w .. 16w + 15 of every tile,
    // SPS slots at a time: lane (sub, cl) takes slot sub of the step and
    // columns 8cl .. 8cl + 7, so a slot's dot is summed over the LPS lanes of
    // its group by log2(LPS) shuffles.  Each lane keeps l and acc over its own
    // slots; the groups are summed once, at the end.
    constexpr int LPS = D > 64 ? 16 : D / 8;   // lanes per slot (a power of 2)
    constexpr int SPS = 32 / LPS;               // slots per step
    const int sub = lane / LPS, cl = lane % LPS;
    const bool owns = cl * 8 < D;
    float qf[G][8], acc[G][8], m[G], l[G];
    const __nv_bfloat16* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (owns) u = *reinterpret_cast<const uint4*>(qb + g * D + cl * 8);
      const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = hopper::unpack_bf16(w4[i]);
        qf[g][2 * i] = f.x * scale_log2;
        qf[g][2 * i + 1] = f.y * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
      m[g] = -INFINITY;
      l[g] = 0.f;
    }

    for (int i = 0; i < n_live; ++i) {
      const int st = i % stages;
      hopper::mbar_wait(&full[st], (i / stages) & 1);
      // this warp's 16 slots of the tile's K and V
      const __nv_bfloat16* kw =
          reinterpret_cast<const __nv_bfloat16*>(ring + st * 2 * TB) + warp * kSlotsPerWarp * D;
      const __nv_bfloat16* vw = kw + kTile * D;
      const int t0 = live[i] * kTile + warp * kSlotsPerWarp;
      // bit j: slot t0 + j is valid (and below T)
      const int tl = t0 + (lane % kSlotsPerWarp);
      const uint32_t vbits = __ballot_sync(0xffffffffu, tl < Tlen && vrow[tl]);
      constexpr int NS = kSlotsPerWarp / SPS;   // steps over the warp's slots
      float s[NS][G];
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int j = k * SPS + sub;   // this lane's slot of the step
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (owns) u = *reinterpret_cast<const uint4*>(kw + j * D + cl * 8);
        const float2 k0 = hopper::unpack_bf16(u.x), k1 = hopper::unpack_bf16(u.y),
                     k2 = hopper::unpack_bf16(u.z), k3 = hopper::unpack_bf16(u.w);
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[k][g] = qf[g][0] * k0.x + qf[g][1] * k0.y + qf[g][2] * k1.x + qf[g][3] * k1.y +
                    qf[g][4] * k2.x + qf[g][5] * k2.y + qf[g][6] * k3.x + qf[g][7] * k3.y;
      }
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < NS; ++k)
#pragma unroll
          for (int g = 0; g < G; ++g) s[k][g] += __shfl_xor_sync(0xffffffffu, s[k][g], off);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int j = k * SPS + sub;
        const bool in = t0 + j < Tlen, ok = (vbits >> j) & 1u;
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[k][g] = ok ? s[k][g] : in ? attn::kNegInf : -INFINITY;   // past T: weight 0
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = s[0][g];
#pragma unroll
        for (int k = 1; k < NS; ++k) mx = fmaxf(mx, s[k][g]);
#pragma unroll
        for (int off = LPS; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        mx = fmaxf(mx, m[g]);
        // mx is -inf only while every slot so far lay past T
        const float alpha = mx == -INFINITY ? 1.f : hopper::exp2_approx(m[g] - mx);
        m[g] = mx;
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          s[k][g] = s[k][g] == -INFINITY ? 0.f : hopper::exp2_approx(s[k][g] - mx);
          sum += s[k][g];
        }
        l[g] = l[g] * alpha + sum;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[g][c] *= alpha;
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int j = k * SPS + sub;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (owns) u = *reinterpret_cast<const uint4*>(vw + j * D + cl * 8);
        const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 f = hopper::unpack_bf16(w4[c]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g][2 * c] += s[k][g] * f.x;
            acc[g][2 * c + 1] += s[k][g] * f.y;
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

    // ---- the groups of a warp summed (m is the same in all lanes), then the
    // four warps' partials into the block's, in warp order
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int off = LPS; off < 32; off <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], off);
      }
      if (lane == 0) {
        w_ml[(warp * G + g) * 2] = m[g];
        w_ml[(warp * G + g) * 2 + 1] = l[g];
      }
      if (sub == 0 && owns)
#pragma unroll
        for (int c = 0; c < 8; ++c) w_acc[(warp * G + g) * D + cl * 8 + c] = acc[g][c];
    }
    hopper::named_sync(1, kConsumers);
    for (int idx = tid; idx < G * D; idx += kConsumers) {
      const int g = idx / D, c = idx % D;
      float M = -INFINITY, L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_ml[(w * G + g) * 2]);
      if (M != -INFINITY)
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float wt = hopper::exp2_approx(w_ml[(w * G + g) * 2] - M);
          L += w_ml[(w * G + g) * 2 + 1] * wt;
          A += w_acc[(w * G + g) * D + c] * wt;
        }
      b_acc[idx] = A;
      if (c == 0) {
        b_ml[2 * g] = M;
        b_ml[2 * g + 1] = L;
      }
    }
  }   // consumers

  // ---- the splits of (b, h) are the blocks of one cluster: block 0 combines
  // their partials, read from their shared memory, in split order.  Some
  // split holds a scored slot, so M is finite; a split with m = -inf (every
  // tile skipped) has weight 0.  The second barrier keeps every block's
  // shared memory alive until block 0 has read it.
  hopper::cluster_sync();
  if (split == 0 && tid < kConsumers) {
    __nv_bfloat16* ob = out + ((size_t)b * Hq + (size_t)h * G) * D;
    for (int idx = tid; idx < G * D; idx += kConsumers) {
      const int g = idx / D;
      float M = -INFINITY, L = 0.f, A = 0.f;
      for (int sp = 0; sp < nsplit; ++sp) {
        const float ms = ld_cluster(b_ml + 2 * g, sp), ls = ld_cluster(b_ml + 2 * g + 1, sp);
        const float as = ld_cluster(b_acc + idx, sp);
        if (ms == -INFINITY) continue;
        const float mx = fmaxf(M, ms);
        const float a = hopper::exp2_approx(M - mx), wt = hopper::exp2_approx(ms - mx);
        L = L * a + ls * wt;
        A = A * a + as * wt;
        M = mx;
      }
      ob[idx] = __float2bfloat16_rn(A / L);
    }
  }
  hopper::cluster_sync();
}

template <int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* out,
                   int B, int Hkv, int Tlen, int nsplit, int tiles_per_split, float scale,
                   cudaStream_t stream) {
  const int n_tiles = (Tlen + kTile - 1) / kTile;
  if (Tlen > kMaxT || tiles_per_split < 1 || tiles_per_split > n_tiles ||
      nsplit > kMaxSplits ||
      nsplit != (n_tiles + tiles_per_split - 1) / tiles_per_split)
    return cudaErrorInvalidValue;
  // K and V as rows of D: {D, Hkv, B * T}, a box of one head's 64 slots
  CUtensorMap tk, tv;
  if (!hopper::encode_bf16_3d(&tk, k, D, Hkv, (uint64_t)B * Tlen, D, (uint64_t)Hkv * D, D, 1,
                              kTile, 0) ||
      !hopper::encode_bf16_3d(&tv, v, D, Hkv, (uint64_t)B * Tlen, D, (uint64_t)Hkv * D, D, 1,
                              kTile, 0))
    return cudaErrorInvalidValue;
  const int stages = tiles_per_split < kMaxStages ? tiles_per_split : kMaxStages;
  const size_t smem = smem_bytes<D, G>(stages, tiles_per_split, n_tiles);
  auto kernel = decode_split_kernel<D, G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tk, tv, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const unsigned char*>(valid),
                           static_cast<__nv_bfloat16*>(out), Hkv, Tlen, tiles_per_split, stages,
                           scale * 1.4426950408889634f);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v, const void* valid,
                     void* out, int B, int Hkv, int Tlen, int nsplit, int tps, float scale,
                     cudaStream_t s) {
  switch (G) {
    case 1: return launch<D, 1>(q, k, v, valid, out, B, Hkv, Tlen, nsplit, tps, scale, s);
    case 2: return launch<D, 2>(q, k, v, valid, out, B, Hkv, Tlen, nsplit, tps, scale, s);
    case 4: return launch<D, 4>(q, k, v, valid, out, B, Hkv, Tlen, nsplit, tps, scale, s);
    case 8: return launch<D, 8>(q, k, v, valid, out, B, Hkv, Tlen, nsplit, tps, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace split

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

// bf16 only: the split design, G = Hq / Hkv in {1, 2, 4, 8}, T <= 2^20,
// nsplit <= 8 splits of tiles_per_split 64-slot tiles covering T.  Returns
// cudaGetLastError() after the launch, or an error for a shape it does not
// take or a tensor map that cuTensorMapEncodeTiled refuses; the caller
// raises on anything but 0.
extern "C" int decode_attention_split_fwd(const void* q, const void* k, const void* v,
                                          const void* valid, void* out, int B, int Hq, int Hkv,
                                          int Tlen, int D, int nsplit, int tiles_per_split,
                                          float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  auto go = [&](auto launch_d) {
    return launch_d(G, q, k, v, valid, out, B, Hkv, Tlen, nsplit, tiles_per_split, scale, s);
  };
  switch (D) {
    case 32: return go(split::launch_g<32>);
    case 64: return go(split::launch_g<64>);
    case 120: return go(split::launch_g<120>);
    case 128: return go(split::launch_g<128>);
    default: return cudaErrorInvalidValue;
  }
}
