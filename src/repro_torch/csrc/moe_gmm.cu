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
// dw[e] = x[e]^T dy[e], summed in fp32 and rounded once, each product
// routed at its own shape.  What bounds it at mixtral's training shape (C
// 1280): two products, 2.43 ms of bf16 operations.  Both products have a
// design of their own (namespace wgtn: moe_gmm_dx_wgmma_nt,
// moe_gmm_dw_wgmma_tn), a redesign of the forward's wgmma design over
// transposed operands.  What held the backward back on that design: dw ran
// over a copy of x; a short contraction (dw's C = 640 or 1280 against the
// forward's D = 4096: 10 or 20 stages a 128 x 256 tile) sat behind an
// epilogue that the next tile's products waited for (each thread storing
// its 128 sums from registers, a quad's 16 bytes a row); and each block
// moved 48 KB from L2 a 128 x 256 x 64 stage, which at the tensor cores'
// rate is more than the L2 gives (the forward reaches 0.72 of the peak).
// The design: every operand is read where it lies, x and dy for dw as
// MN-major operands through wgmma's transpose bits (64-column TMA boxes, C
// their outer coordinate, so that TMA zero-fills a ragged C and any C is
// taken), dy and w for dx K-major; two blocks a cluster take two row tiles
// that share a B tile (or, at an odd count of row tiles, two column tiles
// that share an A tile), each loads its half of it and TMA multicasts the
// half into both, so a block moves 32 KB a stage; each consumer warpgroup
// writes its sums into shared memory in the TMA store's 128-byte swizzle
// (conflict-free) and one thread stores them by TMA, so the next tile's
// products start while the stores drain; four stages of 48 KB.  dx takes it
// where its row tiles of C pair up; at an odd count (Jamba's C = 640: five)
// the pairing of column tiles lost to the forward's design on the H100, so
// dx stays there (moe_gmm_wgmma_nt_fwd: w's (E, D, F) rows K-major for the
// product, no copy of w).  Every other shape of dx, and a dw with D below 64
// or off bf16, take the designs of `route` on operands copied by a tiled
// transpose kernel (moe_gmm_transpose: 64 x 64 tiles through shared memory,
// rows read and written whole): x laid out (E, D, C) for such a dw, w laid
// out (E, F, D) for a dx off the wgmma route (as large as w).
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
// The backward's products on a design of their own (bf16): out[e] (M, N) =
// A[e] B[e] over K, for dw = x^T dy (DW: M = D, N = F, K = C; x and dy read
// MN-major where they lie, through the transpose bits) and dx = dy w^T (M =
// C, N = D, K = F; dy and w read K-major).  Two blocks a cluster take two
// tiles that share an operand tile; each loads its half of that tile, which
// TMA multicasts into both, so a block moves 32 KB from L2 a stage where the
// forward's design moves 48 KB.

namespace wgtn {

constexpr int kBM = 128;        // rows of M per tile: two consumer warpgroups of 64
constexpr int kBN = 256;        // columns of N per tile
constexpr int kBK = 64;         // depth of a stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kCluster = 2;     // blocks a cluster: two tiles that share an operand tile
constexpr int kThreads = 384;   // producer warpgroup, then two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kSlab = 64;                    // columns per TMA box (128 bytes)
constexpr int SLAB_BYTES = kBK * kSlab * 2;  // 64 rows of 128 bytes
constexpr int A_BYTES = kBM * kBK * 2;       // DW: two MN-major slabs; dx: 128 K-major rows
constexpr int B_BYTES = kBN * kBK * 2;       // DW: four slabs; dx: 256 K-major rows
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the epilogue's buffer: kOutSlabs 64 x 64 slabs a warpgroup, so that its
// 64 x 256 sums are stored in 4 / kOutSlabs parts (four stages leave room
// for two slabs a warpgroup)
constexpr int kOutSlabs = 2;
constexpr int SMEM = kStages * STAGE_BYTES + 2 * kOutSlabs * SLAB_BYTES + 2 * kStages * 8 + 1024;

// Persistent: cluster i walks tile pairs i, i + clusters, ...  The two
// blocks of a cluster take row tiles m, m + 1 of one column tile n and share
// B, or (PAIR_N: the row tiles odd in number and the column tiles not, so
// that no block idles on a pair's missing tile) column tiles n, n + 1 of one
// row tile and share A.  The shared operand is cut in halves: each block
// loads its half and TMA multicasts it into both; the other operand each
// block loads whole for itself.  Pairs run with the row index fastest when
// M_FAST (M <= N), else the column index, so that the clusters in flight
// share the smaller of A[e] and B[e] in L2 and stream the other.  (A version
// without PAIR_N, the same loads for the row pairs written as one loop, ran
// dw slower on the H100 in turns with this one: ptxas's schedule, not the
// loads, which are the same.)
template <bool DW, bool M_FAST, bool PAIR_N>
__global__ void __launch_bounds__(kThreads, 1)
moe_gmm_tn_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_out, int E, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* out = smem + kStages * STAGE_BYTES;   // 1024-aligned, as the TMA store's swizzle needs
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 2 * kOutSlabs * SLAB_BYTES);
  uint64_t* empty = full + kStages;

  const uint32_t rank = hopper::cluster_rank(), peer = rank ^ 1u;
  const int nm = (M + kBM - 1) / kBM, nn = (N + kBN - 1) / kBN, nk = (K + kBK - 1) / kBK;
  const int pm = PAIR_N ? nm : (nm + 1) / 2, pn = PAIR_N ? (nn + 1) / 2 : nn;
  const int n_pairs = E * pm * pn;
  const int first = (int)hopper::cluster_id(), step = (int)hopper::cluster_count();
  auto coords = [&](int pair, int& m, int& n, int& e) {
    e = pair / (pm * pn);
    const int r = pair % (pm * pn), i = M_FAST ? r % pm : r / pn, j = M_FAST ? r / pm : r % pn;
    m = PAIR_N ? i : 2 * i + (int)rank;
    n = PAIR_N ? 2 * j + (int)rank : j;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8 * kCluster);   // each consumer warp of both blocks
    }
    hopper::mbar_fence_init();
  }
  hopper::cluster_sync();   // both blocks' barriers live before either touches the other's

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer: one thread issues every load; boxes wholly past M or N
    // are not loaded (they feed only rows and columns that are not stored).
    // A stage is loaded again once both blocks' consumers are done with it.
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_map(&tm_a);
      hopper::tma_prefetch_map(&tm_b);
      int it = 0;
      for (int pair = first; pair < n_pairs; pair += step) {
        int m, n, e;
        coords(pair, m, n, e);
        // A in 64-row halves (DW: a 64-column slab of x; dx: 64 rows of dy),
        // B in 128-column halves (DW: two slabs of dy; dx: 128 rows of w)
        auto a_half = [&](int h) { return m < nm && m * kBM + h * kSlab < M; };
        auto b_slabs = [&](int h) {   // DW: slabs of B's half h within N
          const int lo = n * kBN + h * (kBN / 2);
          return n >= nn ? 0 : max(0, min(2, (N - lo + kSlab - 1) / kSlab));
        };
        auto b_half = [&](int h) { return n < nn && n * kBN + h * (kBN / 2) < N; };
        const uint32_t a_bytes = (a_half(0) + a_half(1)) * SLAB_BYTES;
        const uint32_t b_bytes =
            DW ? (b_slabs(0) + b_slabs(1)) * SLAB_BYTES : (b_half(0) + b_half(1)) * (B_BYTES / 2);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int st = it % kStages;
          uint8_t* a_s = smem + st * STAGE_BYTES;
          uint8_t* b_s = a_s + A_BYTES;
          hopper::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[st], a_bytes + b_bytes);
          // A: its half (PAIR_N, multicast) or both halves (alone)
          for (int h = PAIR_N ? (int)rank : 0; h < (PAIR_N ? (int)rank + 1 : 2); ++h) {
            if (!a_half(h)) continue;
            uint8_t* dst = a_s + h * SLAB_BYTES;
            const int c0 = DW ? m * kBM + h * kSlab : kb * kBK;
            const int c1 = DW ? kb * kBK : m * kBM + h * kSlab;
            if (PAIR_N)
              hopper::tma_load_3d_multicast(dst, &tm_a, &full[st], c0, c1, e, 0x3);
            else
              hopper::tma_load_3d(dst, &tm_a, &full[st], c0, c1, e);
          }
          // B: its half (multicast) or both halves (PAIR_N, alone)
          for (int h = PAIR_N ? 0 : (int)rank; h < (PAIR_N ? 2 : (int)rank + 1); ++h) {
            uint8_t* dst = b_s + h * (B_BYTES / 2);
            const int lo = n * kBN + h * (kBN / 2);
            if constexpr (DW) {
              for (int s = 0; s < b_slabs(h); ++s) {
                if (PAIR_N)
                  hopper::tma_load_3d(dst + s * SLAB_BYTES, &tm_b, &full[st], lo + s * kSlab,
                                      kb * kBK, e);
                else
                  hopper::tma_load_3d_multicast(dst + s * SLAB_BYTES, &tm_b, &full[st],
                                                lo + s * kSlab, kb * kBK, e, 0x3);
              }
            } else if (b_half(h)) {
              if (PAIR_N)
                hopper::tma_load_3d(dst, &tm_b, &full[st], kb * kBK, lo, e);
              else
                hopper::tma_load_3d_multicast(dst, &tm_b, &full[st], kb * kBK, lo, e, 0x3);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows 64c .. 64c + 63 of each tile,
    // and stores them through its own 32 KB of `out`
    hopper::regs_inc<kConsumerRegs>();
    const int c = wgi - 1;
    const int lane = threadIdx.x % 32;
    float acc[kBN / 2];
    int it = 0;
    for (int pair = first; pair < n_pairs; pair += step) {
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int st = it % kStages;
        const uint32_t stage = hopper::smem_addr(smem + st * STAGE_BYTES);
        hopper::mbar_wait(&full[st], (it / kStages) & 1);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          if constexpr (DW) {
            // both MN-major: 16 rows of K of 128 bytes a step; x's 64 columns
            // of the warpgroup are one slab, dy's slabs are SLAB_BYTES apart
            const uint64_t da = hopper::make_desc(stage + c * SLAB_BYTES + kk * 16 * 128,
                                                  SLAB_BYTES, 8 * 128, 128);
            const uint64_t db = hopper::make_desc(stage + A_BYTES + kk * 16 * 128, SLAB_BYTES,
                                                  8 * 128, 128);
            hopper::wgmma_ss<1, 1>(acc, da, db, kb > 0 || kk > 0);
          } else {
            // both K-major: 16 elements = 32 bytes along the swizzled rows
            const uint64_t da =
                hopper::make_desc(stage + c * 64 * 128 + kk * 32, 16, 8 * 128, 128);
            const uint64_t db = hopper::make_desc(stage + A_BYTES + kk * 32, 16, 8 * 128, 128);
            hopper::wgmma_ss<0, 0>(acc, da, db, kb > 0 || kk > 0);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (kb > 0) {   // the previous stage is done: released in both blocks
          __syncwarp();
          if (lane == 0) {
            hopper::mbar_arrive(&empty[(it - 1) % kStages]);
            hopper::mbar_arrive_remote(&empty[(it - 1) % kStages], peer);
          }
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_arrive(&empty[(it - 1) % kStages]);
        hopper::mbar_arrive_remote(&empty[(it - 1) % kStages], peer);
      }

      // epilogue: the warpgroup's 64 x 256 into `out` in the TMA store's
      // 128-byte swizzle (16-byte chunk j of a row at j ^ (row % 8): the
      // eight rows of a store land in eight chunks, no bank conflict),
      // kOutSlabs slabs a part, then one thread stores the part by TMA;
      // after the last part the warpgroup goes on to the next tile while the
      // stores drain.  The tile's coordinates are found only now, out of the
      // products' way.
      int m, n, e;
      coords(pair, m, n, e);
      const int row0 = m * kBM + c * kSlab;
      if (m >= nm || n >= nn || row0 >= M) continue;   // a pair's missing tile, rows past M
      const int tid = threadIdx.x % 128, r = tid / 32 * 16 + lane / 4;   // rows r and r + 8
      uint8_t* my_out = out + c * kOutSlabs * SLAB_BYTES;
      // bits 4-6 of the address hold r % 8, so XOR with 16 (j % 8) swizzles
      const uint32_t base =
          hopper::smem_addr(my_out) + r * 128 + (r % 8) * 16 + 4 * (lane % 4);
      const int nb = min(kBN / kSlab, (N - n * kBN + kSlab - 1) / kSlab);
#pragma unroll
      for (int part = 0; part < 4 / kOutSlabs; ++part) {
        if (tid == 0) hopper::bulk_wait_read<0>();   // the last store has read `out`
        hopper::named_sync(1 + c, 128);
#pragma unroll
        for (int j = part * kOutSlabs * 8; j < (part + 1) * kOutSlabs * 8; ++j) {
          const uint32_t a = (base + (j / 8 - part * kOutSlabs) * SLAB_BYTES) ^ ((j % 8) * 16);
          hopper::st_shared_u32(a, hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]));
          hopper::st_shared_u32(a + 8 * 128, hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
        }
        hopper::fence_proxy_async();
        hopper::named_sync(1 + c, 128);
        if (tid == 0) {
          for (int s = part * kOutSlabs; s < min(nb, (part + 1) * kOutSlabs); ++s)
            hopper::tma_store_3d(&tm_out, my_out + (s - part * kOutSlabs) * SLAB_BYTES,
                                 n * kBN + s * kSlab, row0, e);
          hopper::bulk_commit();
        }
      }
    }
    if (threadIdx.x % 128 == 0) hopper::bulk_wait<0>();   // every store done
  }
  hopper::cluster_sync();   // neither block leaves while the other may still reach its memory
}

// out (E, M, N) from A and B as laid out for DW (x (E, K, M), dy (E, K, N))
// or dx (dy (E, M, K), w (E, N, K)); M, N and K multiples of 8 where they are
// row strides, any elsewhere (TMA zero-fills the ragged tails).
// The launch configuration of moe_gmm_tn_kernel<DW, M_FAST, PAIR_N>, with `attr`
// its cluster's shape, and the clusters that fit the card at once (the
// cluster must sit within a GPC, so on a card whose GPCs hold odd SM counts
// fewer than half its SMs); 0 if the query fails.
template <bool DW, bool M_FAST, bool PAIR_N>
int clusters_that_fit(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1]) {
  auto kernel = moe_gmm_tn_kernel<DW, M_FAST, PAIR_N>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM) !=
      cudaSuccess)
    return 0;
  cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = SMEM;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(kCluster * 132);
  int fit = 0;
  return cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg) == cudaSuccess ? fit : 0;
}

template <bool DW, bool M_FAST, bool PAIR_N>
cudaError_t launch_k(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& to, int E,
                     int M, int N, int K, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int fit = clusters_that_fit<DW, M_FAST, PAIR_N>(cfg, attr);
  if (fit < 1) return cudaErrorInvalidConfiguration;
  cfg.stream = stream;
  // persistent: as many clusters as fit the card at once, at most one a pair
  const int nm = (M + kBM - 1) / kBM, nn = (N + kBN - 1) / kBN;
  const long long n_pairs =
      (long long)E * (PAIR_N ? nm : (nm + 1) / 2) * (PAIR_N ? (nn + 1) / 2 : nn);
  cfg.gridDim = dim3(kCluster * (int)(n_pairs < fit ? n_pairs : fit));
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, moe_gmm_tn_kernel<DW, M_FAST, PAIR_N>, ta, tb, to, E, M, N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool DW>
cudaError_t launch(const void* a, const void* b, void* out, int E, int M, int N, int K,
                   cudaStream_t stream) {
  if (E < 1 || M < 1 || N < 1 || K < 1 || N % 8 || (DW ? M % 8 : K % 8))
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb, to;
  const bool ok =
      DW ? hopper::encode_bf16_3d(&ta, a, M, K, E, M, (uint64_t)K * M, kSlab, kBK, 1, 128) &&
               hopper::encode_bf16_3d(&tb, b, N, K, E, N, (uint64_t)K * N, kSlab, kBK, 1, 128)
         : hopper::encode_bf16_3d(&ta, a, K, M, E, K, (uint64_t)M * K, kBK, kSlab, 1, 128) &&
               hopper::encode_bf16_3d(&tb, b, K, N, E, K, (uint64_t)N * K, kBK, kBN / 2, 1, 128);
  if (!ok || !hopper::encode_bf16_3d(&to, out, N, M, E, N, (uint64_t)M * N, kSlab, kSlab, 1, 128))
    return cudaErrorInvalidValue;
  // pair row tiles unless they are odd in number and the column tiles are not
  const int nm = (M + kBM - 1) / kBM, nn = (N + kBN - 1) / kBN;
  const bool pair_n = nm % 2 == 1 && nn % 2 == 0;
  if (M <= N)
    return pair_n ? launch_k<DW, true, true>(ta, tb, to, E, M, N, K, stream)
                  : launch_k<DW, true, false>(ta, tb, to, E, M, N, K, stream);
  return pair_n ? launch_k<DW, false, true>(ta, tb, to, E, M, N, K, stream)
                : launch_k<DW, false, false>(ta, tb, to, E, M, N, K, stream);
}

}  // namespace wgtn

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

// bf16 only: the backward's dw product, dw (E, D, F) = x^T dy for x (E, C,
// D) and dy (E, C, F), read in place (no copy of x), D and F multiples of 8,
// any C.  Returns cudaGetLastError() after the launch, or an error for a
// shape it does not take or a refused tensor map.
extern "C" int moe_gmm_dw_wgmma_tn(const void* x, const void* dy, void* dw, int E, int C, int D,
                                   int F, void* stream) {
  return (int)wgtn::launch<true>(x, dy, dw, E, D, F, C, static_cast<cudaStream_t>(stream));
}

// bf16 only: the backward's dx product on the same design, dx (E, C, D) = dy
// w^T for dy (E, C, F) and w (E, D, F), both read where they lie (K-major),
// D and F multiples of 8, any C (the route takes it where C's 128-row tiles
// pair up).  Returns as moe_gmm_dw_wgmma_tn.
extern "C" int moe_gmm_dx_wgmma_nt(const void* dy, const void* w, void* dx, int E, int C, int D,
                                   int F, void* stream) {
  return (int)wgtn::launch<false>(dy, w, dx, E, C, D, F, static_cast<cudaStream_t>(stream));
}

// The clusters of the backward's design (dw when `dw`, else dx) that fit
// the current card at once, each of two blocks on two SMs: the blocks its
// persistent grid has; 0 if the query fails.
extern "C" int moe_gmm_tn_clusters(int dw) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  return dw ? wgtn::clusters_that_fit<true, true, false>(cfg, attr)
            : wgtn::clusters_that_fit<false, true, false>(cfg, attr);
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
