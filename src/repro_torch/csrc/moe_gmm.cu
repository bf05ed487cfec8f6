// Expert-batched matrix product of the MoE layer: y[e] = x[e] @ w[e] for
// every expert e, the inner loop of the capacity dispatch (gate, up and down
// projections of the experts' SwiGLU).
//
// Replaces the Pallas kernel `moe_gmm` (body `_gmm_kernel`) in
// src/repro/kernels/moe_gmm.py.  Plain version:
// repro_torch.kernels.ref.moe_gmm_ref.
//
// Layouts: x (E, C, D), w (E, D, F), y (E, C, F), row-major and contiguous.
// fp32 or bf16 in and out; the sum is kept in fp32 and rounded once on
// store, as in the plain version.
//
// What bounds it on this card: the product does 2 * C operations for every
// element of w it reads.  At a decode step of mixtral-8x7b (batch 8, so C = 2
// rows per expert) that is 1 operation per byte of bf16 weight, far below the
// ~295 per byte at which an H100 (SXM, 700 W) turns from bound by its
// 3.35 TB/s of memory to bound by its 989 TFLOP/s of bf16 tensor cores:
// there the least time is the bytes of w (0.94 GB, 0.28 ms for the gate of
// one layer).  At a prefill of 8 x 512 tokens (C = 1280) it is 1280
// operations per byte, and the least time is the operations (1.20 TFLOP,
// 1.22 ms).
//
// Three designs, one C entry point each; the wrapper picks the route from
// the dtype and shape before the launch (kernels/moe_gmm.py: route), never
// after a failure.  For bf16 with D and F multiples of 8 (TMA's 16-byte
// strides): C <= STREAM_MAX_C (6) -> "stream" (moe_gmm_stream_fwd), the
// decode shapes; C >= 64 -> "wgmma" (moe_gmm_wgmma_fwd), the prefill shapes.
// Everything else -> "mma_sync" (moe_gmm_fwd): C from 7 to 63, ragged D or
// F, and fp32, which that entry computes on the CUDA cores, never in TF32.
// No serving path has C from 3 to 63; chip_smoke.py times the three designs
// from C = 1 to 64.
//
// What this design does about it (stream, bf16, C <= 8): at C rows per
// expert every weight feeds C multiply-adds, so the kernel is a stream of w
// at the memory's rate and nothing else.  The mma_sync design lost a
// quarter of that rate at decode: 62 of its 64 tile rows were padding, a
// block had one 16 KB step of w in flight, and a grid of F/128 x E blocks
// ended in a part-empty wave.  Here w is cut into equal units, (expert, 128
// columns of F) over the whole of D, and one persistent block per SM walks
// every 132nd unit, so the blocks stream equal bytes to within one unit and
// D is never split (the sums keep one fixed order).  One producer thread loads 64 x 128
// tiles of w, and the matching 64 columns of x's C rows, by TMA into a ring
// of eight stages, 128 KB of w in flight per SM, and runs on into the next
// unit while the consumers finish this one.  The 256 consumer threads
// multiply on the CUDA cores in fp32: thread (cq, rg) keeps C x 4 sums of
// the columns 4cq .. 4cq + 3 over rows rg, rg + 8, ..., reading w as 8
// bytes of a 256-byte row (a warp reads one whole row) and x as a bf16
// broadcast; the 8 row groups are summed in a fixed order and rounded once.
// At C <= 6 that is at most 6 fused multiply-adds per 2-byte weight, 42 per
// clock per SM at 3.35 TB/s, inside the 128 of the CUDA cores (at C = 8 the
// issue of the multiply-adds and x's loads starts to bound it, which sets
// the threshold); a wgmma with the operands swapped (w^T as A, M = 64
// columns; x^T as B, N = 8) would do the same work on the tensor cores but
// needs w in the swizzled layout and gains nothing while the weights'
// bytes bound it.
//
// What this design does about it (wgmma, bf16, the prefill shapes): a
// persistent kernel, one block of 384 threads per SM walking 128 x 256
// output tiles, the row tiles of one column slab of w next to each other so
// that the blocks in flight share w in L2.  Warpgroup 0 is the producer: one
// thread loads x and w by TMA (3-D tensor maps with E outermost, so the
// tails of C and D are zero-filled per expert) into a ring of four stages of
// 128-byte swizzled tiles, 64 deep, with mbarriers counting the bytes; the
// next tile's loads run during the current tile's epilogue.  Warpgroups 1
// and 2 each own 64 rows and issue wgmma m64n256k16 from shared memory, x
// K-major and w MN-major through the transpose bit, keeping one group of
// products in flight while they wait for the next stage; fp32 sums are
// rounded once to bf16 on store.  setmaxnreg hands the producer's registers
// to them at run time; ptxas still compiles every thread against the 168
// registers of a 384-thread block, which the 128 accumulators fit.
//
// The mma_sync design: one block of 256 threads per (expert, 64-row C tile,
// 128-column F tile) loops over D (the TPU's sequential minor grid axis) in
// steps of BK.  Tiles of x and w are staged through shared memory; the next
// step's global loads are issued into registers before the current tiles
// are multiplied, so one step of loads is in flight behind the arithmetic.
// bf16: each of the 8 warps computes a 32 x 32 block with `mma.sync`
// m16n8k16 on the tensor cores, fp32 accumulators (products of bf16 values
// are exact in fp32).  fp32: the CUDA cores, 4 x 8 outputs per thread in
// fp32 multiply-adds.  The tails of C, D and F are masked by bounds, with no
// padded copy.  One C tile covers C <= 64, so at decode each element of w is
// read once.
//
// The backward (kernels/moe_gmm.py: moe_gmm_bwd): dx[e] = dy[e] w[e]^T and
// dw[e] = x[e]^T dy[e], summed in fp32 and rounded once, by the three
// designs above on transposed operands, each product routed at its own
// shape.  What bounds it at mixtral's training shape (C 1280): two
// products, 2.43 ms of bf16 operations.  What this simple design does
// about it: the forward's designs. dx at the training shapes runs the wgmma
// design with w read transposed (moe_gmm_wgmma_nt_fwd: w's (E, D, F) rows
// are K-major for the product, loaded as one 256-row TMA box a stage and
// multiplied without the transpose bit), so w is never copied; every other
// shape of dx, and dw, take the designs of `route` on operands copied by a
// tiled transpose kernel (moe_gmm_transpose: 64 x 64 tiles through shared
// memory, rows read and written whole): x laid out (E, D, C) for dw (0.08
// GB at mixtral's training shape), w laid out (E, F, D) for a dx off the
// wgmma route (as large as w).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;    // rows of C per block
constexpr int kBN = 128;   // columns of F per block

// Per-type tile depth and shared-memory row padding; elements are moved as
// raw bits, so a zero fill is the same for both types.
template <typename T> struct Tile;
template <> struct Tile<float> {
  using Bits = uint32_t;
  static constexpr int BK = 32, PAD = 4;
};
template <> struct Tile<__nv_bfloat16> {
  using Bits = uint16_t;
  static constexpr int BK = 64, PAD = 8;
};

// A ROWS x COLS tile of a row-major (nrows, ncols) matrix with leading
// dimension ld, held in registers as 16-byte chunks, zero outside bounds.
// kVec: ncols and ld are multiples of the chunk, so a chunk is wholly in or
// out of bounds and is loaded as one 16-byte access.
template <typename Bits, int ROWS, int COLS, bool kVec>
struct TileLoader {
  static constexpr int VEC = 16 / sizeof(Bits);
  static constexpr int CPR = COLS / VEC;            // chunks per row
  static constexpr int N = ROWS * CPR / kThreads;   // chunks per thread
  static_assert(ROWS * CPR % kThreads == 0, "the tile must split evenly over the threads");
  union Chunk {
    uint4 u;
    Bits b[VEC];
  };
  Chunk regs[N];

  __device__ __forceinline__ void load(const Bits* __restrict__ src, long long ld, int row0,
                                       int nrows, int col0, int ncols) {
#pragma unroll
    for (int p = 0; p < N; ++p) {
      const int idx = threadIdx.x + p * kThreads;
      const int r = row0 + idx / CPR, c = col0 + (idx % CPR) * VEC;
      if constexpr (kVec) {
        regs[p].u = (r < nrows && c < ncols)
                        ? *reinterpret_cast<const uint4*>(src + (long long)r * ld + c)
                        : make_uint4(0u, 0u, 0u, 0u);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          regs[p].b[i] = (r < nrows && c + i < ncols) ? src[(long long)r * ld + c + i] : Bits(0);
      }
    }
  }

  __device__ __forceinline__ void store(Bits* dst, int ld_s) const {
#pragma unroll
    for (int p = 0; p < N; ++p) {
      const int idx = threadIdx.x + p * kThreads;
      *reinterpret_cast<uint4*>(dst + (idx / CPR) * ld_s + (idx % CPR) * VEC) = regs[p].u;
    }
  }
};

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int C,
               int D, int F) {
  using Bits = typename Tile<T>::Bits;
  constexpr int BK = Tile<T>::BK;
  constexpr int LDA = BK + Tile<T>::PAD;    // padded rows: no bank conflicts
  constexpr int LDB = kBN + Tile<T>::PAD;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) Bits As[kBM * LDA];   // x tile, [c][d]
  __shared__ __align__(16) Bits Bs[BK * LDB];    // w tile, [d][f]

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const Bits* xe = reinterpret_cast<const Bits*>(x) + (long long)e * C * D;
  const Bits* we = reinterpret_cast<const Bits*>(w) + (long long)e * D * F;
  T* ye = y + (long long)e * C * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // bf16: warp (wm, wn) of a 2 x 4 grid owns rows wm*32.., columns wn*32..;
  // lane (g, t) holds the m16n8k16 fragments.  fp32: thread (tm, tn) of a
  // 16 x 16 grid owns rows tm*4.. and columns tn*4.. and 64 + tn*4...
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int tm = tid >> 4, tn = tid & 15;
  // bf16: acc[mi * 4 + ni] is the fragment of m-tile mi and n-tile ni.
  // fp32: acc[i * 2 + j / 4][j % 4] is row i, column j of the thread's 4 x 8.
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  TileLoader<Bits, kBM, BK, kVec> la;
  TileLoader<Bits, BK, kBN, kVec> lb;
  const int nk = (D + BK - 1) / BK;
  if (nk > 0) {
    la.load(xe, D, m0, C, 0, D);
    lb.load(we, F, 0, D, n0, F);
    la.store(As, LDA);
    lb.store(Bs, LDB);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) {  // the next step's loads, in flight during the arithmetic
      la.load(xe, D, m0, C, (kt + 1) * BK, D);
      lb.load(we, F, (kt + 1) * BK, D, n0, F);
    }
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const Bits* pa = As + (wm * 32 + mi * 16 + g) * LDA + kk + 2 * t;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(pa);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * LDA);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(pa + 8);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * LDA + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const Bits* pb = Bs + (kk + 2 * t) * LDB + wn * 32 + ni * 8 + g;
          const uint32_t b0 = (uint32_t)pb[0] | (uint32_t)pb[LDB] << 16;
          const uint32_t b1 = (uint32_t)pb[8 * LDB] | (uint32_t)pb[9 * LDB] << 16;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_bf16(acc[mi * 4 + ni], a[mi], b0, b1);
        }
      }
    } else {
      const float* Af = reinterpret_cast<const float*>(As);
      const float* Bf = reinterpret_cast<const float*>(Bs);
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Af[(tm * 4 + i) * LDA + k];
        const float4 b0 = *reinterpret_cast<const float4*>(Bf + k * LDB + tn * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bf + k * LDB + 64 + tn * 4);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i * 2 + (j >> 2)][j & 3] = fmaf(a[i], b[j], acc[i * 2 + (j >> 2)][j & 3]);
      }
    }
    __syncthreads();
    if (more) {
      la.store(As, LDA);
      lb.store(Bs, LDB);
    }
    __syncthreads();
  }

  if constexpr (kBf16) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int r = m0 + wm * 32 + mi * 16 + g + (h >> 1) * 8;
          const int c = n0 + wn * 32 + ni * 8 + 2 * t + (h & 1);
          if (r < C && c < F) store_out(ye + (long long)r * F + c, acc[mi * 4 + ni][h]);
        }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = m0 + tm * 4 + i;
        const int c = n0 + (j >> 2) * 64 + tn * 4 + (j & 3);
        if (r < C && c < F) store_out(ye + (long long)r * F + c, acc[i * 2 + (j >> 2)][j & 3]);
      }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int E, int C, int D, int F,
                   cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (D % vec == 0 && F % vec == 0)
    moe_gmm_kernel<T, true><<<grid, kThreads, 0, stream>>>(xp, wp, yp, C, D, F);
  else
    moe_gmm_kernel<T, false><<<grid, kThreads, 0, stream>>>(xp, wp, yp, C, D, F);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The wgmma design (bf16, large C)

namespace wg {

constexpr int kBM = 128;        // rows of C per tile: two consumer warpgroups of 64
constexpr int kBN = 256;        // columns of F per tile
constexpr int kBK = 64;         // depth of a stage: one 128-byte swizzled row of x
constexpr int kStages = 4;
constexpr int kThreads = 384;   // producer warpgroup, then two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // 128 * 40 + 256 * 232 <= 65536
constexpr int kSlab = 64;                         // columns of w per TMA box (128 bytes)
constexpr int A_BYTES = kBM * kBK * 2;            // x tile, [c][d]
constexpr int B_SLAB_BYTES = kBK * kSlab * 2;     // one slab of the w tile, [d][64 f]
constexpr int STAGE_BYTES = A_BYTES + (kBN / kSlab) * B_SLAB_BYTES;
constexpr int SMEM = kStages * STAGE_BYTES + 2 * kStages * 8 + 1024;

// BT: w is given transposed, (E, F, D) with D contiguous (K-major B, one
// 256-row TMA box a stage, no transpose bit); else (E, D, F) (MN-major B,
// 64-column slabs, the transpose bit).
template <bool BT>
__global__ void __launch_bounds__(kThreads, 1)
moe_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w, __nv_bfloat16* __restrict__ y,
                     int E, int C, int D, int F) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle phase is taken from the address bits
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * STAGE_BYTES);
  uint64_t* empty = full + kStages;

  const int nm = (C + kBM - 1) / kBM, nn = (F + kBN - 1) / kBN, nk = (D + kBK - 1) / kBK;
  const int n_tiles = E * nm * nn;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer: one thread issues every load
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_map(&tm_x);
      hopper::tma_prefetch_map(&tm_w);
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m = tile % nm, n = (tile / nm) % nn, e = tile / (nm * nn);
        // slabs wholly past F are not loaded: they feed only columns >= F,
        // which are not stored
        const int nslab = BT ? kBN / kSlab : min(kBN / kSlab, (F - n * kBN + kSlab - 1) / kSlab);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int st = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          uint8_t* a_s = smem + st * STAGE_BYTES;
          hopper::mbar_wait(&empty[st], ph ^ 1);
          hopper::mbar_arrive_expect_tx(&full[st], A_BYTES + nslab * B_SLAB_BYTES);
          hopper::tma_load_3d(a_s, &tm_x, &full[st], kb * kBK, m * kBM, e);
          if constexpr (BT) {
            hopper::tma_load_3d(a_s + A_BYTES, &tm_w, &full[st], kb * kBK, n * kBN, e);
          } else {
            for (int s = 0; s < nslab; ++s)
              hopper::tma_load_3d(a_s + A_BYTES + s * B_SLAB_BYTES, &tm_w, &full[st],
                                  n * kBN + s * kSlab, kb * kBK, e);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows 64c .. 64c + 63 of each tile
  hopper::regs_inc<kConsumerRegs>();
  const int c = wgi - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  float acc[kBN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m = tile % nm, n = (tile / nm) % nn, e = tile / (nm * nn);
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const uint32_t a_addr = hopper::smem_addr(smem + st * STAGE_BYTES) + c * 64 * 128;
      const uint32_t b_addr = hopper::smem_addr(smem + st * STAGE_BYTES + A_BYTES);
      hopper::mbar_wait(&full[st], ph);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // x: K-major, 16 elements = 32 bytes along the swizzled row; w:
        // MN-major, 16 rows of 128 bytes, slabs B_SLAB_BYTES apart (or, given
        // transposed, K-major as x)
        const uint64_t da = hopper::make_desc(a_addr + kk * 32, 16, 8 * 128, 128);
        const uint64_t db =
            BT ? hopper::make_desc(b_addr + kk * 32, 16, 8 * 128, 128)
               : hopper::make_desc(b_addr + kk * 16 * 128, B_SLAB_BYTES, 8 * 128, 128);
        hopper::wgmma_ss<BT ? 0 : 1>(acc, da, db, kb > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      // keep this stage's products in flight; the previous stage is done
      hopper::wgmma_wait<1>();
      if (kb > 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kStages]);

    // epilogue: rows r and r + 8, columns 8j + 2t, 8j + 2t + 1; F is even
    const int ra = m * kBM + c * 64 + warp * 16 + lane / 4, rb = ra + 8;
    __nv_bfloat16* ye = y + (long long)e * C * F;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n * kBN + 8 * j + 2 * (lane % 4);
      if (col < F) {
        if (ra < C)
          *reinterpret_cast<uint32_t*>(ye + (long long)ra * F + col) =
              hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
        if (rb < C)
          *reinterpret_cast<uint32_t*>(ye + (long long)rb * F + col) =
              hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// y (E, C, F) = x (E, C, D) @ w, w (E, D, F), or w (E, F, D) transposed (BT).
template <bool BT>
cudaError_t launch(const void* x, const void* w, void* y, int E, int C, int D, int F,
                   cudaStream_t stream) {
  if (C < 1 || D < 1 || F < 1 || D % 8 || F % 8) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  const bool w_ok =
      BT ? hopper::encode_bf16_3d(&tw, w, D, F, E, D, (uint64_t)F * D, kBK, kBN, 1, 128)
         : hopper::encode_bf16_3d(&tw, w, F, D, E, F, (uint64_t)D * F, kSlab, kBK, 1, 128);
  if (!hopper::encode_bf16_3d(&tx, x, D, C, E, D, (uint64_t)C * D, kBK, kBM, 1, 128) || !w_ok)
    return cudaErrorInvalidValue;
  const int sms = hopper::sm_count();
  if (!sms) return cudaErrorInvalidDevice;
  cudaError_t err = cudaFuncSetAttribute(moe_gmm_wgmma_kernel<BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const long long n_tiles =
      (long long)E * ((C + kBM - 1) / kBM) * ((F + kBN - 1) / kBN);
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  moe_gmm_wgmma_kernel<BT><<<grid, kThreads, SMEM, stream>>>(
      tx, tw, static_cast<__nv_bfloat16*>(y), E, C, D, F);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// The stream design (bf16, C <= 8: the decode shapes)

namespace streamed {

constexpr int kMaxC = 8;
constexpr int kBN = 128;            // columns of F per unit: 256 bytes of each row of w
constexpr int kBK = 64;             // rows of D per stage
constexpr int kStages = 8;          // 128 KB of w in flight per block (16 KB a stage)
constexpr int kBlocksPerSM = 1;
constexpr int kConsumers = 256;     // column quads x row groups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kWarps = kConsumers / 32;
constexpr int kQuads = kBN / 4;             // threads across a row of the tile
constexpr int kRowGroups = kConsumers / kQuads;
constexpr int W_BYTES = kBK * kBN * 2;      // one stage of w, [d][128 f]
constexpr int X_BYTES = kMaxC * kBK * 2;    // room for one stage of x, [c][64 d]
constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
constexpr int RED_FLOATS = kWarps * kMaxC * kBN;   // one buffer of the warps' sums
constexpr int SMEM = 1024 + kStages * STAGE_BYTES + 2 * RED_FLOATS * 4 + 2 * kStages * 8;

template <int C>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
moe_gmm_stream_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w, __nv_bfloat16* __restrict__ y,
                      int E, int D, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(ring + kStages * STAGE_BYTES);   // two buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * RED_FLOATS);
  uint64_t* empty = full + kStages;

  const int nslab = (F + kBN - 1) / kBN, nk = (D + kBK - 1) / kBK;
  const int n_units = E * nslab;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread streams w and x through the ring, unit after
    // unit, so the next unit's loads run during this one's epilogue
    if (threadIdx.x == kConsumers) {
      hopper::tma_prefetch_map(&tm_x);
      hopper::tma_prefetch_map(&tm_w);
      int it = 0;
      for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
        const int e = unit / nslab, n = unit % nslab;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int st = it % kStages;
          uint8_t* dst = ring + st * STAGE_BYTES;
          hopper::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[st], W_BYTES + C * kBK * 2);
          hopper::tma_load_3d(dst, &tm_w, &full[st], n * kBN, kb * kBK, e);
          hopper::tma_load_3d(dst + W_BYTES, &tm_x, &full[st], kb * kBK, 0, e);
        }
      }
    }
    return;
  }

  // ---- consumers: thread (cq, rg) sums columns 4cq .. 4cq + 3 over rows
  // rg, rg + kRowGroups, ... of every stage; a warp reads whole rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cq = tid % kQuads, rg = tid / kQuads;
  int it = 0, u = 0;
  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x, ++u) {
    const int e = unit / nslab, n = unit % nslab;
    float acc[C][4];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int st = it % kStages;
      hopper::mbar_wait(&full[st], (it / kStages) & 1);
      const uint8_t* ws = ring + st * STAGE_BYTES;
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(ws + W_BYTES);
#pragma unroll
      for (int i = 0; i < kBK / kRowGroups; ++i) {
        const int r = rg + kRowGroups * i;
        const uint2 wv = *reinterpret_cast<const uint2*>(ws + r * kBN * 2 + cq * 8);
        const float2 w01 = hopper::unpack_bf16(wv.x), w23 = hopper::unpack_bf16(wv.y);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float xv = __bfloat162float(xs[c * kBK + r]);
          acc[c][0] = fmaf(xv, w01.x, acc[c][0]);
          acc[c][1] = fmaf(xv, w01.y, acc[c][1]);
          acc[c][2] = fmaf(xv, w23.x, acc[c][2]);
          acc[c][3] = fmaf(xv, w23.y, acc[c][3]);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

    // epilogue: the row groups summed in a fixed order (first those of a
    // warp, by shuffles, then the eight warps through shared memory),
    // rounded once to bf16
    float* rb = red + (u & 1) * RED_FLOATS;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int off = kQuads; off < 32; off <<= 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] += __shfl_xor_sync(0xffffffffu, acc[c][j], off);
      if (lane < kQuads)
        *reinterpret_cast<float4*>(rb + (warp * C + c) * kBN + cq * 4) =
            make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    }
    hopper::named_sync(1, kConsumers);
    __nv_bfloat16* ye = y + (size_t)e * C * F;
    for (int idx = tid; idx < C * kBN; idx += kConsumers) {
      const int c = idx / kBN, col = idx % kBN, f = n * kBN + col;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += rb[(w * C + c) * kBN + col];
      if (f < F) ye[(size_t)c * F + f] = __float2bfloat16_rn(sum);
    }
  }
}

template <int C>
cudaError_t launch(const void* x, const void* w, void* y, int E, int D, int F,
                   cudaStream_t stream) {
  CUtensorMap tx, tw;
  if (!hopper::encode_bf16_3d(&tx, x, D, C, E, D, (uint64_t)C * D, kBK, C, 1, 0) ||
      !hopper::encode_bf16_3d(&tw, w, F, D, E, F, (uint64_t)D * F, kBN, kBK, 1, 0))
    return cudaErrorInvalidValue;
  const int sms = hopper::sm_count();
  if (!sms) return cudaErrorInvalidDevice;
  auto kernel = moe_gmm_stream_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const long long n_units = (long long)E * ((F + kBN - 1) / kBN);
  const int grid = (int)(n_units < kBlocksPerSM * sms ? n_units : kBlocksPerSM * sms);
  kernel<<<grid, kThreads, SMEM, stream>>>(tx, tw, static_cast<__nv_bfloat16*>(y), E, D, F);
  return cudaGetLastError();
}

cudaError_t launch_c(const void* x, const void* w, void* y, int E, int C, int D, int F,
                     cudaStream_t s) {
  if (E < 1 || D < 1 || F < 1 || D % 8 || F % 8) return cudaErrorInvalidValue;
  switch (C) {
    case 1: return launch<1>(x, w, y, E, D, F, s);
    case 2: return launch<2>(x, w, y, E, D, F, s);
    case 3: return launch<3>(x, w, y, E, D, F, s);
    case 4: return launch<4>(x, w, y, E, D, F, s);
    case 5: return launch<5>(x, w, y, E, D, F, s);
    case 6: return launch<6>(x, w, y, E, D, F, s);
    case 7: return launch<7>(x, w, y, E, D, F, s);
    case 8: return launch<8>(x, w, y, E, D, F, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace streamed

// ---------------------------------------------------------------------------
// The backward's transposes: dst (E, C, R) = src (E, R, C) per expert.

namespace transpose {

constexpr int kTile = 64;   // a 64 x 64 tile of elements a block
constexpr int kRows = 8;    // rows of threads: 512 threads, 8 elements each

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
transpose_kernel(const T* __restrict__ src, T* __restrict__ dst, int R, int C) {
  __shared__ T tile[kTile][kTile + 1];
  const long long base = (long long)blockIdx.z * R * C;
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < kTile; i += kRows) {  // rows of src, whole and in order
    const int r = r0 + i, c = c0 + tx;
    if (r < R && c < C) tile[i][tx] = src[base + (long long)r * C + c];
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kTile; i += kRows) {  // rows of dst
    const int c = c0 + i, r = r0 + tx;
    if (r < R && c < C) dst[base + (long long)c * R + r] = tile[tx][i];
  }
}

template <typename T>
cudaError_t launch(const void* src, void* dst, int E, int R, int C, cudaStream_t stream) {
  const dim3 grid((C + kTile - 1) / kTile, (R + kTile - 1) / kTile, E);
  transpose_kernel<T><<<grid, dim3(kTile, kRows), 0, stream>>>(static_cast<const T*>(src),
                                                               static_cast<T*>(dst), R, C);
  return cudaGetLastError();
}

}  // namespace transpose

}  // namespace

// x (E, C, D), w (E, D, F), y (E, C, F), contiguous and 16-byte aligned on the
// device; E, C, F > 0.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success); the caller raises on
// anything else.
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* y, int E, int C, int D, int F,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, y, E, C, D, F, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, y, E, C, D, F, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 only: the wgmma design, for D and F multiples of 8.  Returns
// cudaGetLastError() after the launch, or an error for a shape it does not
// take or a tensor map that cuTensorMapEncodeTiled refuses; the caller
// raises on anything but 0.
extern "C" int moe_gmm_wgmma_fwd(const void* x, const void* w, void* y, int E, int C, int D,
                                 int F, void* stream) {
  return (int)wg::launch<false>(x, w, y, E, C, D, F, static_cast<cudaStream_t>(stream));
}

// bf16 only: the wgmma design with w given transposed, y (E, C, F) = x (E, C,
// D) @ w[e]^T for w (E, F, D): the backward's dx = dy w^T without a copy of
// w.  D and F multiples of 8.  Returns cudaGetLastError() after the launch, or
// an error for a shape it does not take or a refused tensor map.
extern "C" int moe_gmm_wgmma_nt_fwd(const void* x, const void* w, void* y, int E, int C, int D,
                                    int F, void* stream) {
  return (int)wg::launch<true>(x, w, y, E, C, D, F, static_cast<cudaStream_t>(stream));
}

// bf16 only: the stream design, for 1 <= C <= 8 and D and F multiples of 8.
// Returns cudaGetLastError() after the launch, or an error for a shape it
// does not take or a tensor map that cuTensorMapEncodeTiled refuses; the
// caller raises on anything but 0.
extern "C" int moe_gmm_stream_fwd(const void* x, const void* w, void* y, int E, int C, int D,
                                  int F, void* stream) {
  return (int)streamed::launch_c(x, w, y, E, C, D, F, static_cast<cudaStream_t>(stream));
}

// The backward's transpose: dst (E, C, R) = src (E, R, C), contiguous on the
// device in one type (dtype 0 = float32, 1 = bfloat16); E, R, C > 0, E and
// R / 64 at most 65535.  Returns cudaGetLastError() after the launch.
extern "C" int moe_gmm_transpose(const void* src, void* dst, int E, int R, int C, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)transpose::launch<float>(src, dst, E, R, C, s);
  if (dtype == 1) return (int)transpose::launch<__nv_bfloat16>(src, dst, E, R, C, s);
  return (int)cudaErrorInvalidValue;
}
