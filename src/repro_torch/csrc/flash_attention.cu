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
// which an H100 (SXM, 700 W) turns from bound by its 3.35 TB/s of memory to
// bound by its 989 TFLOP/s of bf16 tensor cores at S ~ 900: at the serving
// path's S = T = 512, d = 128 the least time is the bytes (0.0150 ms), and
// from S ~ 900 up it is the operations.
//
// Two designs, each unmasked and under a key mask, one C entry point each;
// the wrapper picks the route from the dtype and the mask before the launch
// (kernels/flash_attention.py: route), never after a failure: bf16 ->
// "wgmma" (flash_attention_wgmma_fwd) or "wgmma_masked"
// (flash_attention_wgmma_masked_fwd), fp32 -> "simt" (flash_attention_fwd)
// or "masked" (flash_attention_masked_fwd), which stay on fp32 CUDA-core
// arithmetic, never TF32.  The simt entry points also take bf16, so that the
// designs can be timed against each other.
//
// What this design does about it (wgmma, bf16; the FlashAttention-3 shape,
// kept simple): a block of 288 threads per (128-query tile, query head,
// batch row).  One producer warp loads the Q tile once and then K and V
// tiles of 64 keys by TMA into a ring of three stages (mbarriers count the
// bytes), 3-D tensor maps per (batch x head, position, d) so that ragged S
// and T are zero-filled per head.  Two consumer warpgroups each own 64 query
// rows: S = Q K^T by wgmma from shared memory (both K-major, 128-byte
// swizzle), the online softmax in the accumulator's own layout (a row's max
// and sum by quad shuffles, no shared-memory round trip, no block barrier),
// then O += P V by wgmma with P from registers and V read through a
// transposed (MN-major) descriptor.  Tile t's Q K^T is issued together with
// tile t-1's P V, so the softmax of tile t runs while that product is on the
// tensor cores.  P is split into a bf16 head and the bf16 remainder, and both
// are multiplied: P V then keeps the plain version's fp32 accuracy at 1.5
// times the tensor work (a single bf16 P errs by up to 2^-9 of each weight,
// more than atol 1e-3 on a short causal row whose few terms cancel).  Key
// tiles above the causal
// diagonal or before the window are skipped, the masking arithmetic runs
// only on tiles that cross a boundary, and query tiles are issued last-first
// so that the longest causal rows start first.  Registers bound the tiles:
// ptxas compiles a block of 9 to 12 warps against 168 registers a thread
// whatever setmaxnreg asks for later (nvcc 12.9), so 64 keys a tile keep S,
// both halves of P and O within them without spilling.
//
// The simt design (fp32): one block of 256 threads per 64-query tile and
// query head walks the key tiles in a loop (the TPU's sequential grid axis).
// Q, K and V tiles sit in shared memory as fp32 and each thread computes a
// 4 x 4 block of scores and a 4 x (d/16) block of the output in registers,
// so every shared-memory value read feeds four multiply-adds; it is bound by
// the CUDA cores' 67 TFLOP/s.
//
// Masking, both designs: a masked score is kNegInf, as in the JAX kernel.
// Keys past T are excluded by bounds, not by padding.  A block holding a
// query with no allowed key at all walks every tile, so that row averages v
// over the real T, as the plain version does.
//
// The key mask (B, T) bytes of valid keys, the encoder mask of a cross
// prefill (JAX: gqa_attend under enc_mask, src/repro/models/transformer.py):
// a key whose byte is 0 scores kNegInf, like a causal or window miss.  All
// of a block's queries share batch row b, so one row of the mask decides its
// walk (km::scan, a block-wide pass over the row's bytes: ballots of 64 keys
// into a valid word a tile, reduced through shared memory).  If some row of
// the block has no allowed valid key (none at all, or all in its causal
// future or before its window), the block walks every tile of [0, T) with
// the mask applied, and that row averages v over the real T, as the plain
// version does; a row with a valid key then loses the dead tiles' terms
// exactly, as exp2(kNegInf - m) is 0.  Otherwise:
//   simt ("masked"): the block walks from the row's first valid key to its
//   last, within the union of its rows' causal and window ranges; each key
//   tile's valid bytes are staged in shared memory beside K and V.
//   wgmma ("wgmma_masked"): the block walks only the live tiles of that
//   union, those whose valid word is not 0.  The producer warp builds each
//   tile's word by ballot as it goes, skips the dead ones, and writes each
//   walked tile's t0 and word into its stage's slot before the arrival on
//   k_full; the consumers read them after their wait.  Producer and
//   consumers agree on the count (km::scan, before the walk), and stage and
//   parity count walks, not tile positions.  A tile whose word is not all
//   ones takes the masking arithmetic, as a tile that crosses T does.
//
// The backward (flash_attention_bwd_dq and flash_attention_bwd_dkv, fp32 and
// bf16, every head width the forward takes): the gradients dq, dk and dv of
// the unmasked routes.  The JAX package has no Pallas backward (its training
// differentiates the XLA attention); plain version:
// repro_torch.kernels.ref.flash_attention_bwd_ref.  With P the softmax of the
// scaled, masked scores, D = rowsum(dO o), dP = dO V^T and dS = P (dP - D) on
// the allowed pairs (0 elsewhere): dq = scale dS K, dk = scale dS^T Q and
// dv = P^T dO, summed over the G query heads of a kv head.  Five products of
// 2 S T d operations a query head (halved when causal) against q, k, v, o,
// dO, dq, dk and dv read or written once: the operations bound it.  This
// simple design is the simt one twice over, fp32 on the CUDA cores: the dq
// kernel (a block of 256 threads per 64-query tile and query head) walks
// the key tiles the tile's rows can see once for each row's max and sum,
// the forward's statistics recomputed so that the forward entry points stay
// as they are, then again for dS and dq, and writes each row's log-sum-exp
// and D (fp32) for the second kernel; the dkv kernel (a block per 64-key
// tile and kv head) walks the group's G query heads and the query tiles that
// can see the tile, and sums dk and dv in registers, so no atomics are
// needed.  Q, dO, K and V tiles sit in shared memory as fp32 (165 KB at
// d = 128, one block an SM), each thread holds 4 x 4 scores and a 4 x (d/16)
// block of each sum.  A row that sees no key (a causal row at a negative
// position) takes P = 1 / T on every key, as the plain version's softmax of
// equal scores does, and no score gradient: dq is 0 there and its dO is
// spread over dv.
//
// The backward of the key-masked routes (flash_attention_bwd_dq_masked and
// _dkv_masked, simt; flash_attention_bwd_dq_wgmma_masked and
// _dkv_wgmma_masked, bf16): the same kernels instantiated with MASKED, a key
// whose byte is 0 not allowed, like a causal or window miss.  A query row
// with no allowed valid key outputs the mean of v over all of T, so it has
// no score gradient and adds dO / T to dv of every key of its batch row,
// dead tiles and keys past its causal range included.  The dq kernel scores
// a disallowed pair -inf, so such a row keeps a running sum of 0 and gets
// lse = -inf; it walks only where a row can have an allowed valid key (simt:
// from the batch row's first valid key to its last, within the union of its
// rows' ranges; wgmma: the live tiles of that union, counted by km::scan
// and found by next_live in every thread alike, so that thread 0's loads
// and the warps' reads walk the same tiles; each finds the next load's tile
// while the current one is in flight).  The dkv kernel adds the empty rows'
// term to dv (bwd::empty_rows_term: dO / T summed over the rows of the
// group whose lse is -inf, after a coalesced pass over lse that asks whether
// there is one; the simt kernel before its walk, the wgmma kernel after it,
// so that none of its registers live across the walk), walks no query tile
// for a key tile with no valid key (then it writes only that term, or
// zeros), and otherwise walks the query tiles that can see the tile with the
// valid bits in its masking.
//
// The live pair (flash_attention_bwd_dq_wgmma_live and _dkv_wgmma_live,
// bf16; the route of a bf16 backward under a key mask), a redesign of the
// wgmma masked pair, which stays on its own entry points.  What held that
// pair back at seamless's cross-attention (d 64, T 1500, a ragged mask):
// its dq kernel walked every live tile twice (a first pass for each row's
// max and sum, which the forward had already had), one stage of K and V
// made every block wait for each load, and each of its blocks read the
// mask again (km::scan, then a ballot a tile in next_live), as did each
// dkv block (a ballot, and a pass over lse for the empty rows' term).  So:
// the masked wgmma forward writes each row's lse when autograd will need
// it (a null pointer otherwise: serving writes nothing more); a small
// kernel (km::live_tiles_kernel) builds each batch row's list of live key
// tiles with their valid words once a call; the dq kernel (dq_live_kernel)
// walks its segment of that list once, from the forward's lse, with two
// stages of K and V at d <= 64 (four blocks an SM, as before); the dkv
// kernel (dkv_kernel<D, true, true>) reads its tile's word from the list,
// streams Q and dO through three stages at d <= 64 (three blocks an SM, as
// before), and where neither causal nor a window can empty a row, takes
// the empty rows' term from the batch row's count of live tiles (none:
// every row is empty; some: none is) instead of a pass over lse.
#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// The key mask of a block's batch row, read by both masked designs

namespace km {

constexpr int kTile = 64;   // keys a tile, and bits a word

// The valid word of the key tile at t0: bit c is key t0 + c, 0 at or past
// Tlen.  Every lane of the warp calls it and gets the same word.
__device__ __forceinline__ uint64_t tile_word(const uint8_t* __restrict__ vrow, int t0, int Tlen,
                                              int lane) {
  const int a = t0 + lane, c = a + 32;
  const uint32_t lo = __ballot_sync(0xffffffffu, a < Tlen && vrow[a]);
  const uint32_t hi = __ballot_sync(0xffffffffu, c < Tlen && vrow[c]);
  return (uint64_t)hi << 32 | lo;
}

// Bits c of a word with lo <= t0 + c <= hi.
__device__ __forceinline__ uint64_t range_bits(int t0, int lo, int hi) {
  const int a = min(max(lo - t0, 0), kTile), b = min(max(hi - t0 + 1, 0), kTile);
  const uint64_t below_b = b == kTile ? ~0ull : (1ull << b) - 1;
  const uint64_t below_a = a == kTile ? ~0ull : (1ull << a) - 1;
  return below_b & ~below_a;
}

// The first and last valid key of the row (Tlen and -1 if none), by the
// ballots of km::scan's first loop.  Every one of the block's NT threads
// calls it (block barriers).
template <int NT>
__device__ __forceinline__ int2 valid_range(const uint8_t* __restrict__ vrow, int Tlen) {
  __shared__ int s_fv, s_lv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    s_fv = Tlen;
    s_lv = -1;
  }
  __syncthreads();
  int fv = Tlen, lv = -1;
  for (int i = warp; i * kTile < Tlen; i += NT / 32) {
    const uint64_t w = tile_word(vrow, i * kTile, Tlen, lane);
    if (!w) continue;
    fv = min(fv, i * kTile + __ffsll((long long)w) - 1);
    lv = max(lv, i * kTile + 63 - __clzll((long long)w));
  }
  if (lane == 0) {
    atomicMin(&s_fv, fv);
    atomicMax(&s_lv, lv);
  }
  __syncthreads();
  return make_int2(s_fv, s_lv);
}

struct Scan {
  int fv, lv;       // first and last valid key of the row (Tlen and -1 if none)
  int live;         // key tiles of [tile_lo, tile_hi] that hold a valid key
  bool any_empty;   // some query row has no allowed valid key
};

// Reads the block's batch row of the mask, `vrow` (Tlen bytes), for a query
// tile whose rows 0 .. nrows - 1 sit at positions p_first + r.  Every one of
// the block's NT threads calls it (it holds block barriers); rows go to
// threads 0 .. ROWS - 1, whole warps.  The words are built by ballots, one
// warp a tile, and reduced through shared memory, so no thread walks T.
//
// Row p may see keys [rl(p), rh(p)]: rl = max(0, p - window + 1) under a
// window, else 0; rh = p when causal (p <= Tlen - 1 always), else Tlen - 1.
// It has an allowed valid key iff the last valid key at or before rh(p) is
// at least rl(p).  Not causal, rh is Tlen - 1 for every row and rl grows
// with p, so the last row decides: lv >= rl(p_last).  Causal, each row asks
// for its own: the last valid key of [rl(p_first), p_first - 1] (m0, reduced
// with the words) or a later one among the tile's rows (a ballot per warp of
// rows, and each earlier warp's last).
template <int NT, int ROWS>
__device__ Scan scan(const uint8_t* __restrict__ vrow, int Tlen, int p_first, int nrows,
                     int causal, int has_window, int window, int tile_lo, int tile_hi) {
  __shared__ int s_fv, s_lv, s_m0, s_live, s_empty;
  __shared__ int s_wlast[ROWS / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    s_fv = Tlen;
    s_lv = -1;
    s_m0 = -1;
    s_live = 0;
    s_empty = 0;
  }
  __syncthreads();
  const int m0_lo = has_window ? max(0, p_first - window + 1) : 0, m0_hi = p_first - 1;
  int fv = Tlen, lv = -1, m0 = -1, live = 0;
  for (int i = warp; i * kTile < Tlen; i += NT / 32) {
    const int t0 = i * kTile;
    const uint64_t w = tile_word(vrow, t0, Tlen, lane);
    if (!w) continue;
    fv = min(fv, t0 + __ffsll((long long)w) - 1);
    lv = max(lv, t0 + 63 - __clzll((long long)w));
    live += i >= tile_lo && i <= tile_hi;
    const uint64_t before = causal ? w & range_bits(t0, m0_lo, m0_hi) : 0;
    if (before) m0 = max(m0, t0 + 63 - __clzll((long long)before));
  }
  if (lane == 0) {   // every lane holds the same values
    atomicMin(&s_fv, fv);
    atomicMax(&s_lv, lv);
    atomicMax(&s_m0, m0);
    atomicAdd(&s_live, live);
  }
  __syncthreads();
  Scan r{s_fv, s_lv, s_live, false};
  if (!causal) {
    const int p_last = p_first + nrows - 1;
    r.any_empty = r.lv < (has_window ? max(0, p_last - window + 1) : 0);
    return r;
  }
  const int p = p_first + tid;
  uint32_t bits = 0;
  if (tid < ROWS) {
    bits = __ballot_sync(0xffffffffu, tid < nrows && p >= 0 && vrow[p]);
    if (lane == 0) s_wlast[warp] = bits ? p_first + 32 * warp + 31 - __clz(bits) : -1;
  }
  __syncthreads();
  if (tid < nrows) {
    int prev = s_m0;
    for (int w = 0; w < warp; ++w) prev = max(prev, s_wlast[w]);
    const uint32_t upto = bits & (0xffffffffu >> (31 - lane));
    if (upto) prev = p_first + 32 * warp + 31 - __clz(upto);
    if (p < 0 || prev < (has_window ? max(0, p - window + 1) : 0)) s_empty = 1;
  }
  __syncthreads();
  r.any_empty = s_empty;
  return r;
}

// Each batch row's live key tiles (a valid word that is not 0), built once a
// backward call by one block a batch row and read by both kernels of the live
// pair in place of each block's own pass over the row: words[b][i] is the
// valid word of tile i, prefix[b][i] the number of live tiles before tile i
// (prefix[b][n_kt] all of them), live[b][j] the j-th live tile.  The words
// are built by ballots, a warp a tile; the live tiles are ranked by a ballot
// a warp and the warps' counts, kListThreads tiles a round.
constexpr int kListThreads = 256;

__global__ void __launch_bounds__(kListThreads)
live_tiles_kernel(const uint8_t* __restrict__ kvalid, int Tlen, int n_kt,
                  uint64_t* __restrict__ words, int* __restrict__ live,
                  int* __restrict__ prefix) {
  __shared__ uint64_t s_word[kListThreads];
  __shared__ int s_count[kListThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint8_t* vrow = kvalid + (size_t)b * Tlen;
  uint64_t* wrow = words + (size_t)b * n_kt;
  int* lrow = live + (size_t)b * n_kt;
  int* prow = prefix + (size_t)b * (n_kt + 1);
  int base = 0;   // live tiles before this round, the same in every thread
  for (int c0 = 0; c0 < n_kt; c0 += kListThreads) {
    for (int j = warp; j < kListThreads && c0 + j < n_kt; j += kListThreads / 32) {
      const uint64_t w = tile_word(vrow, (c0 + j) * kTile, Tlen, lane);
      if (lane == 0) s_word[j] = w;
    }
    __syncthreads();
    const int i = c0 + tid;
    const uint64_t w = i < n_kt ? s_word[tid] : 0ull;
    const uint32_t bal = __ballot_sync(0xffffffffu, w != 0ull);
    if (lane == 0) s_count[warp] = __popc(bal);
    __syncthreads();
    int before = base + __popc(bal & ((1u << lane) - 1u)), total = 0;
    for (int k = 0; k < kListThreads / 32; ++k) {
      before += k < warp ? s_count[k] : 0;
      total += s_count[k];
    }
    if (i < n_kt) {
      wrow[i] = w;
      prow[i] = before;
      if (w) lrow[before] = i;
    }
    base += total;
    __syncthreads();   // s_word and s_count are written again next round
  }
  if (tid == 0) prow[n_kt] = base;
}

}  // namespace km

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kPS = kBlockK + 1;

template <int D, bool MASKED>
size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
                                  kBlockQ * kPS + 3 * kBlockQ + (MASKED ? kBlockK : 0));
}

// MASKED: kvalid (B, Tlen) bytes, a key with 0 masked; otherwise unused.
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ kvalid,
                       T* __restrict__ out, int Hq, int Hkv, int S, int Tlen, int causal,
                       int has_window, int window, float scale) {
  constexpr int QS = D + 1, KS = D + 1;  // padded rows: no bank conflicts
  constexpr int CH = D / 8;              // 16-byte chunks per row
  constexpr int DJ = (D + 15) / 16;      // output columns per thread (the last
                                         // may fall past D, as at D = 120)
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
  float* kv_s = a_s + kBlockQ;         // MASKED: the key tile's valid bytes
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
  // MASKED: the block's rows share batch row b, so it walks from the row's
  // first valid key to its last, unless some row has no allowed valid key
  int fv = 0, lv = Tlen - 1;
  bool mask_empty = false;
  if constexpr (MASKED) {
    const km::Scan ms = km::scan<kThreads, kBlockQ>(kvalid + (size_t)b * Tlen, Tlen, q0 + off,
                                                    nq, causal, has_window, window, 0, -1);
    fv = ms.fv;
    lv = ms.lv;
    mask_empty = ms.any_empty;
  }
  if (tid == 0) {
    // union of the allowed key ranges of the block's queries
    int lo = Tlen, hi = -1;
    bool empty_row = mask_empty;
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
    key_lo = empty_row ? 0 : max(lo, fv);
    key_hi = empty_row ? Tlen - 1 : min(hi, lv);
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
    if (MASKED && tid < nt) kv_s[tid] = kvalid[(size_t)b * Tlen + t0 + tid] ? 1.f : 0.f;
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
          if (MASKED) ok = ok && kv_s[c] != 0.f;
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
      for (int j = 0; j < DJ; ++j) vv[j] = tx + 16 * j < D ? vs[t * D + tx + 16 * j] : 0.f;
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
    for (int j = 0; j < DJ; ++j)
      if (tx + 16 * j < D) attn::store(ob + (size_t)r * D + tx + 16 * j, o[i][j] / l);
  }
}

template <typename T, int D, bool MASKED>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* kvalid,
                   void* out, int B, int Hq, int Hkv, int S, int Tlen, int causal,
                   int has_window, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, MASKED>();
  auto kernel = flash_attention_kernel<T, D, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kvalid,
      static_cast<T*>(out), Hq, Hkv, S, Tlen, causal, has_window, window, scale);
  return cudaGetLastError();
}

template <typename T, bool MASKED>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const uint8_t* kvalid,
                     void* out, int B, int Hq, int Hkv, int S, int Tlen, int causal,
                     int has_window, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32, MASKED>(q, k, v, kvalid, out, B, Hq, Hkv, S, Tlen, causal,
                                   has_window, window, scale, stream);
    case 64:
      return launch<T, 64, MASKED>(q, k, v, kvalid, out, B, Hq, Hkv, S, Tlen, causal,
                                   has_window, window, scale, stream);
    case 120:
      return launch<T, 120, MASKED>(q, k, v, kvalid, out, B, Hq, Hkv, S, Tlen, causal,
                                    has_window, window, scale, stream);
    case 128:
      return launch<T, 128, MASKED>(q, k, v, kvalid, out, B, Hq, Hkv, S, Tlen, causal,
                                    has_window, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool MASKED>
cudaError_t launch_dtype(int dtype, int D, const void* q, const void* k, const void* v,
                         const uint8_t* kvalid, void* out, int B, int Hq, int Hkv, int S,
                         int Tlen, int causal, int has_window, int window, float scale,
                         cudaStream_t stream) {
  if (dtype == 0)
    return launch_d<float, MASKED>(D, q, k, v, kvalid, out, B, Hq, Hkv, S, Tlen, causal,
                                   has_window, window, scale, stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16, MASKED>(D, q, k, v, kvalid, out, B, Hq, Hkv, S, Tlen,
                                           causal, has_window, window, scale, stream);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// The wgmma design (bf16)

namespace wg {

constexpr int kBM = 128;            // queries per block: two consumer warpgroups of 64
constexpr int kBN = 64;             // keys per tile
constexpr int kStages = 3;          // K/V tiles in flight
constexpr int kConsumers = 256;     // two warpgroups, threads 0..255
constexpr int kThreads = kConsumers + 32;   // and one producer warp

// D is the true head width; DP, the width of the tiles in shared memory and
// of the products, rounds it up to whole slabs.  At D = 120 the tensor maps
// keep the true width, so TMA zero-fills columns 120..127 of Q, K and V:
// they add nothing to Q K^T, give zero columns of O, and are not stored.
template <int D>
struct Cfg {
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle = bytes of a slab's row
  static constexpr int DS = SW / 2;               // head elements per slab
  static constexpr int NSLAB = (D + DS - 1) / DS;
  static constexpr int DP = NSLAB * DS;
  static constexpr int KSTEP = DS / 16;           // 16-deep steps per slab
  static constexpr int Q_BYTES = kBM * DP * 2;
  static constexpr int KV_BYTES = kBN * DP * 2;   // one K or one V tile
  static constexpr int BARS = 1 + 3 * kStages;
  // the masked design's stage slots: each K tile's valid word and t0
  static constexpr int SLOT_BYTES = kStages * (8 + 4);
  static constexpr int SMEM = Q_BYTES + 2 * kStages * KV_BYTES + 8 * BARS + SLOT_BYTES + 1024;
};

// The block's query tile, kv head and range of key tiles.  MASKED: after
// scan_mask, the walk: n_tiles key tiles from tile_first on, every tile when
// walk_all, else only the live ones (a valid word that is not 0).
template <bool MASKED>
struct BlockTiles {
  int h, b, hk, q0, off, t_begin, n_tiles;
  int tile_first = 0;
  bool walk_all = false;

  __device__ __forceinline__ BlockTiles(int Hq, int Hkv, int S, int Tlen, int causal,
                                        int has_window, int window) {
    h = blockIdx.x;
    b = blockIdx.y;
    hk = h / (Hq / Hkv);
    q0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // the last query tile first
    off = Tlen - S;
    // Union of the allowed key ranges of the tile's queries, in closed form:
    // rows are consecutive positions.  A causal row at a negative position
    // has no allowed key; then every tile is walked.
    const int p_first = q0 + off, p_last = q0 + min(kBM, S - q0) - 1 + off;
    int lo = 0, hi = Tlen - 1;
    if (!(causal && p_first < 0)) {
      if (causal) hi = min(hi, p_last);
      if (has_window) lo = max(0, p_first - window + 1);
    }
    t_begin = (lo / kBN) * kBN;
    n_tiles = (hi - t_begin) / kBN + 1;
  }

  // Every thread of the block calls it: the live tiles of the union, or
  // every tile of [0, Tlen) when some row has no allowed valid key (that
  // row then averages v over all of T), so no block has zero tiles.
  __device__ __forceinline__ void scan_mask(const uint8_t* vrow, int S, int Tlen, int causal,
                                            int has_window, int window) {
    const int lo_tile = t_begin / kBN;
    const km::Scan ms = km::scan<kThreads, kBM>(vrow, Tlen, q0 + off, min(kBM, S - q0), causal,
                                                has_window, window, lo_tile,
                                                lo_tile + n_tiles - 1);
    walk_all = ms.any_empty;
    tile_first = walk_all ? 0 : lo_tile;
    n_tiles = walk_all ? (Tlen + kBN - 1) / kBN : ms.live;
  }
};

// One consumer warpgroup's state: 64 query rows, of which this thread holds
// two (r and r + 8) in the accumulator layout.
template <int D>
struct Rows {
  float o[Cfg<D>::DP / 2];
  float m0, m1, l0, l1;
  uint32_t phi[kBN / 16][4], plo[kBN / 16][4];   // P as bf16 head and remainder
};

// S = Q K^T for the tile in stage `k_addr`: 64 x kBN, both operands K-major.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint32_t q_addr, uint32_t k_addr) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    const uint32_t koff = (kk % C::KSTEP) * 32;   // 16 elements along a swizzled row
    const uint64_t da =
        hopper::make_desc(q_addr + (kk / C::KSTEP) * kBM * C::SW + koff, 16, 8 * C::SW, C::SW);
    const uint64_t db =
        hopper::make_desc(k_addr + (kk / C::KSTEP) * kBN * C::SW + koff, 16, 8 * C::SW, C::SW);
    hopper::wgmma_ss<0>(s, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// O += P V for the tile in stage `v_addr`: V is [key][d], read as an
// MN-major B through slabs of d; both halves of P are multiplied.
template <int D>
__device__ __forceinline__ void issue_pv(Rows<D>& R, uint32_t v_addr) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db =
        hopper::make_desc(v_addr + kk * 16 * C::SW, kBN * C::SW, 8 * C::SW, C::SW);
    hopper::wgmma_rs<1>(R.o, R.phi[kk], db, 1);
    hopper::wgmma_rs<1>(R.o, R.plo[kk], db, 1);
  }
  hopper::wgmma_commit();
}

// Scores of one tile to weights, in place: scale to log2 units, mask, update
// the running max and sum.  Returns the rescale of the rows' earlier terms.
// MASKED: `kbits` is the tile's valid word in shared memory; byte j holds
// keys 8j .. 8j + 7, and a key whose bit is 0 is masked like a causal miss.
template <bool MASKED>
__device__ __forceinline__ float2 softmax_tile(float (&s)[kBN / 2], float& m0, float& m1,
                                               float& l0, float& l1, bool need_mask, int t0,
                                               int col0, int pa, int pb, int Tlen, int causal,
                                               int has_window, int window, float scale_log2,
                                               const uint8_t* kbits) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    uint32_t valid = 3;   // this thread's two keys of the 8-column group
    if (MASKED && need_mask) valid = kbits[j] >> col0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = s[4 * j + i] * scale_log2;
      if (need_mask) {
        const int kp = t0 + 8 * j + col0 + (i & 1);
        const int p = i < 2 ? pa : pb;
        if (kp >= Tlen)
          x = -INFINITY;   // past T: out of the max, weight 0
        else if ((causal && kp > p) || (has_window && kp <= p - window) ||
                 !((valid >> (i & 1)) & 1))
          x = attn::kNegInf;
      }
      s[4 * j + i] = x;
    }
  }
  // each row lives in the four threads of a quad
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  const float2 alpha = make_float2(hopper::exp2_approx(m0 - mx0), hopper::exp2_approx(m1 - mx1));
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    s[4 * j] = hopper::exp2_approx(s[4 * j] - mx0);
    s[4 * j + 1] = hopper::exp2_approx(s[4 * j + 1] - mx0);
    s[4 * j + 2] = hopper::exp2_approx(s[4 * j + 2] - mx1);
    s[4 * j + 3] = hopper::exp2_approx(s[4 * j + 3] - mx1);
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * alpha.x + sum0;   // this thread's part; the quad is summed at the end
  l1 = l1 * alpha.y + sum1;
  return alpha;
}

// Rescale O and turn the weights into the A operands of P V.
template <int D>
__device__ __forceinline__ void rescale_and_pack(Rows<D>& R, const float (&s)[kBN / 2],
                                                 float2 alpha) {
#pragma unroll
  for (int j = 0; j < Cfg<D>::DP / 8; ++j) {
    R.o[4 * j] *= alpha.x;
    R.o[4 * j + 1] *= alpha.x;
    R.o[4 * j + 2] *= alpha.y;
    R.o[4 * j + 3] *= alpha.y;
  }
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 2 * kk + (r >> 1), i = (r & 1) * 2;
      const float x0 = s[4 * j + i], x1 = s[4 * j + i + 1];
      const uint32_t hv = hopper::pack_bf16(x0, x1);
      R.phi[kk][r] = hv;
      R.plo[kk][r] = hopper::pack_bf16(x0 - __uint_as_float(hv << 16),
                                       x1 - __uint_as_float(hv & 0xFFFF0000u));
    }
}

template <int D>
__device__ __forceinline__ void fence_pv(Rows<D>& R) {
  hopper::fence_regs(R.o);
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    hopper::fence_regs(R.phi[kk]);
    hopper::fence_regs(R.plo[kk]);
  }
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ kvalid,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv,
                   int S, int Tlen, int causal, int has_window, int window, float scale_log2) {
  using C = Cfg<D>;
  constexpr int SW = C::SW;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle phase is taken from the address bits
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                              // NSLAB slabs of kBM rows
  uint8_t* ks = qs + C::Q_BYTES;                   // kStages x NSLAB slabs of kBN rows
  uint8_t* vs = ks + kStages * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  // MASKED: the stage slots, written by the producer before the stage's
  // k_full arrival and read by the consumers after their wait on it
  uint64_t* slot_word = empty + kStages;
  int* slot_t0 = reinterpret_cast<int*>(slot_word + kStages);
  BlockTiles<MASKED> bt(Hq, Hkv, S, Tlen, causal, has_window, window);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == kConsumers) {   // the producer's first thread loads Q once
    hopper::tma_prefetch_map(&tm_q);
    hopper::tma_prefetch_map(&tm_k);
    hopper::tma_prefetch_map(&tm_v);
    hopper::mbar_arrive_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
    for (int s = 0; s < C::NSLAB; ++s)
      hopper::tma_load_3d(qs + s * kBM * SW, &tm_q, q_full, s * C::DS, bt.q0, bt.b * Hq + bt.h);
  }
  const uint8_t* vrow = MASKED ? kvalid + (size_t)bt.b * Tlen : nullptr;
  if constexpr (MASKED) bt.scan_mask(vrow, S, Tlen, causal, has_window, window);   // under Q's load

  // the producer's first thread: wait for stage it % kStages to be free,
  // then the K and V tiles at t0 of walk `it` into it
  auto wait_empty = [&](int it) {
    hopper::mbar_wait(&empty[it % kStages], ((it / kStages) & 1) ^ 1);
  };
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int it, int t0) {
    const int st = it % kStages;
    hopper::mbar_arrive_expect_tx(&k_full[st], C::KV_BYTES);
#pragma unroll
    for (int s = 0; s < C::NSLAB; ++s)
      hopper::tma_load_3d(ks + st * C::KV_BYTES + s * kBN * SW, map_k, &k_full[st], s * C::DS,
                          t0, bt.b * Hkv + bt.hk);
    hopper::mbar_arrive_expect_tx(&v_full[st], C::KV_BYTES);
#pragma unroll
    for (int s = 0; s < C::NSLAB; ++s)
      hopper::tma_load_3d(vs + st * C::KV_BYTES + s * kBN * SW, map_v, &v_full[st], s * C::DS,
                          t0, bt.b * Hkv + bt.hk);
  };

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: its first thread issues every load
    if constexpr (MASKED) {
      // the whole warp builds each tile's word; dead tiles are skipped
      // unless every tile is walked.  Stage and parity count walks.
      const int lane = threadIdx.x - kConsumers;
      for (int i = bt.tile_first, it = 0; it < bt.n_tiles; ++i) {
        const uint64_t word = km::tile_word(vrow, i * kBN, Tlen, lane);
        if (!word && !bt.walk_all) continue;
        if (lane == 0) {
          wait_empty(it);
          slot_word[it % kStages] = word;   // released by the arrival on k_full
          slot_t0[it % kStages] = i * kBN;
          load_kv(it, i * kBN);
        }
        __syncwarp();
        ++it;
      }
    } else if (threadIdx.x == kConsumers) {
      for (int it = 0; it < bt.n_tiles; ++it) {
        wait_empty(it);
        load_kv(it, bt.t_begin + it * kBN);
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns query rows 64c .. 64c + 63 of the tile
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r0 = c * 64 + warp * 16 + lane / 4;   // this thread's rows: r0 and r0 + 8
  const int pa = bt.q0 + r0 + bt.off, pb = pa + 8;   // their absolute positions
  const int pw_first = bt.q0 + c * 64 + bt.off;      // the warpgroup's first position
  const int col0 = 2 * (lane % 4);
  const uint32_t q_addr = hopper::smem_addr(qs) + c * 64 * SW;
  const uint32_t k_base = hopper::smem_addr(ks), v_base = hopper::smem_addr(vs);
  // a tile needs the masking arithmetic only where it crosses T, the causal
  // diagonal or the window's start for some row of the warpgroup, or (MASKED)
  // holds a masked key
  auto need_mask = [&](int t0, int st) {
    return t0 + kBN > Tlen || (causal && t0 + kBN - 1 > pw_first) ||
           (has_window && t0 <= pw_first + 63 - window) || (MASKED && slot_word[st] != ~0ull);
  };
  // the key position of walk `it`, read after the wait on its k_full
  auto tile_t0 = [&](int it) {
    return MASKED ? slot_t0[it % kStages] : bt.t_begin + it * kBN;
  };
  auto kbits = [&](int st) { return reinterpret_cast<const uint8_t*>(slot_word + st); };

  Rows<D> R;
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) R.o[i] = 0.f;
  R.m0 = R.m1 = attn::kNegInf;
  R.l0 = R.l1 = 0.f;
  float s[kBN / 2];
  hopper::mbar_wait(q_full, 0);

  // Tile it's scores are computed while tile it-1's P V runs on the tensor
  // cores, and the softmax of tile it overlaps that product.
  hopper::mbar_wait(&k_full[0], 0);
  int t0 = tile_t0(0);
  hopper::wgmma_fence();
  issue_qk<D>(s, q_addr, k_base);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  float2 alpha = softmax_tile<MASKED>(s, R.m0, R.m1, R.l0, R.l1, need_mask(t0, 0), t0, col0, pa,
                                      pb, Tlen, causal, has_window, window, scale_log2, kbits(0));
  rescale_and_pack(R, s, alpha);
  for (int it = 1; it < bt.n_tiles; ++it) {
    const int st = it % kStages, pst = (it - 1) % kStages;
    hopper::mbar_wait(&k_full[st], (it / kStages) & 1);
    t0 = tile_t0(it);
    hopper::wgmma_fence();
    issue_qk<D>(s, q_addr, k_base + st * C::KV_BYTES);
    hopper::mbar_wait(&v_full[pst], ((it - 1) / kStages) & 1);
    issue_pv(R, v_base + pst * C::KV_BYTES);
    hopper::wgmma_wait<1>();   // the scores; P V may still run
    hopper::fence_regs(s);
    alpha = softmax_tile<MASKED>(s, R.m0, R.m1, R.l0, R.l1, need_mask(t0, st), t0, col0, pa, pb,
                                 Tlen, causal, has_window, window, scale_log2, kbits(st));
    hopper::wgmma_wait<0>();
    fence_pv(R);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[pst]);
    rescale_and_pack(R, s, alpha);
  }
  {
    const int pst = (bt.n_tiles - 1) % kStages;
    hopper::mbar_wait(&v_full[pst], ((bt.n_tiles - 1) / kStages) & 1);
    hopper::wgmma_fence();
    issue_pv(R, v_base + pst * C::KV_BYTES);
    hopper::wgmma_wait<0>();
    fence_pv(R);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[pst]);
  }

  float l0 = R.l0, l1 = R.l1;
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  const int ra = bt.q0 + r0, rb = ra + 8;
  // MASKED, for the backward: each row's log-sum-exp (log2 units) over its
  // allowed scores, -inf where it has no allowed valid key (its max stayed
  // kNegInf: every score it met was masked)
  if (MASKED && lse != nullptr && lane % 4 == 0) {
    float* lb = lse + ((size_t)bt.b * Hq + bt.h) * S;
    if (ra < S) lb[ra] = R.m0 == attn::kNegInf ? -INFINITY : R.m0 + log2f(l0);
    if (rb < S) lb[rb] = R.m1 == attn::kNegInf ? -INFINITY : R.m1 + log2f(l1);
  }
  __nv_bfloat16* ob = out + ((size_t)bt.b * Hq + bt.h) * (size_t)S * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {   // the columns past D (zero) are not stored
    const int col = 8 * j + col0;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)ra * D + col) =
          hopper::pack_bf16(R.o[4 * j] * inv0, R.o[4 * j + 1] * inv0);
    if (rb < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)rb * D + col) =
          hopper::pack_bf16(R.o[4 * j + 2] * inv1, R.o[4 * j + 3] * inv1);
  }
}

// MASKED: kvalid (B, Tlen) bytes, a key with 0 masked, and lse (B, Hq, S)
// fp32 or null; otherwise both unused.
template <int D, bool MASKED>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* kvalid, void* out,
                   float* lse, int B, int Hq, int Hkv, int S, int Tlen, int causal,
                   int has_window, int window, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  if (!hopper::encode_bf16_3d(&tq, q, D, S, (uint64_t)B * Hq, D, (uint64_t)S * D, C::DS, kBM,
                              1, C::SW) ||
      !hopper::encode_bf16_3d(&tk, k, D, Tlen, (uint64_t)B * Hkv, D, (uint64_t)Tlen * D, C::DS,
                              kBN, 1, C::SW) ||
      !hopper::encode_bf16_3d(&tv, v, D, Tlen, (uint64_t)B * Hkv, D, (uint64_t)Tlen * D, C::DS,
                              kBN, 1, C::SW))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D, MASKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (S + kBM - 1) / kBM);
  kernel<<<grid, kThreads, C::SMEM, stream>>>(tq, tk, tv, kvalid,
                                              static_cast<__nv_bfloat16*>(out), lse, Hq, Hkv, S,
                                              Tlen, causal, has_window, window,
                                              scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <bool MASKED>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const uint8_t* kvalid,
                     void* out, float* lse, int B, int Hq, int Hkv, int S, int Tlen, int causal,
                     int has_window, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32, MASKED>(q, k, v, kvalid, out, lse, B, Hq, Hkv, S, Tlen, causal,
                                has_window, window, scale, stream);
    case 64:
      return launch<64, MASKED>(q, k, v, kvalid, out, lse, B, Hq, Hkv, S, Tlen, causal,
                                has_window, window, scale, stream);
    case 120:
      return launch<120, MASKED>(q, k, v, kvalid, out, lse, B, Hq, Hkv, S, Tlen, causal,
                                 has_window, window, scale, stream);
    case 128:
      return launch<128, MASKED>(q, k, v, kvalid, out, lse, B, Hq, Hkv, S, Tlen, causal,
                                 has_window, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// The backward (fp32 and bf16 I/O, fp32 inside)

namespace bwd {

constexpr int kTile = 64;       // queries or keys a tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 pairs each
constexpr int kPS = kTile + 1;

// MASKED: one more float a key of the tile, its valid byte
template <int D, bool MASKED>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + kTile * kPS + 4 * kTile +
                                  (MASKED ? kTile : 0));
}

template <int D, bool MASKED>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile +
                                  (MASKED ? kTile : 0));
}

__device__ __forceinline__ bool allowed(int p, int kp, int causal, int has_window, int window) {
  return (!causal || kp <= p) && (!has_window || kp > p - window);
}

// Under a key mask a row with no allowed valid key leaves the dq kernel
// with lse = -inf (its running sum stays 0); the dkv kernel reads that.
__device__ __forceinline__ bool empty_row(float lse) { return lse == -INFINITY; }

// The masked dkv kernels' term for the rows with no allowed valid key:
// each such row's output is the mean of v over all of T, so it adds dO / T
// to dv of every key of its batch row.  E (D floats at e_out) = inv_t times
// the sum of dO over the rows of the G query heads of kv head hk whose lse
// is -inf.  Every one of the block's NT threads calls it (block barriers);
// `part` is NT floats of scratch.  A first coalesced pass over lse asks
// whether there is any such row, so a batch row without one pays only that.
// `known`: -1 asks lse row by row; 0 says no row is empty and 1 that every
// row is (the caller knows it from the mask), and then lse is not read.
template <typename T, int D, int NT>
__device__ __forceinline__ void empty_rows_term(const T* __restrict__ dout,
                                                const float* __restrict__ lse, int b, int hk,
                                                int G, int Hq, int S, float inv_t, float* part,
                                                float* e_out, int known = -1) {
  const int tid = threadIdx.x;
  const size_t head0 = ((size_t)b * Hq + (size_t)hk * G) * S;   // the group's G heads, rows
  int any = known;
  if (known < 0) {
    any = 0;
    for (int r = tid; r < G * S; r += NT) any |= empty_row(lse[head0 + r]);
  }
  if (!__syncthreads_or(any)) {
    for (int c = tid; c < D; c += NT) e_out[c] = 0.f;
    __syncthreads();
    return;
  }
  constexpr int NG = NT / D;   // row groups of D threads, one column each
  const int col = tid % D, grp = tid / D;
  float e = 0.f;
  if (grp < NG) {
#pragma unroll 4
    for (int r = grp; r < G * S; r += NG) {
      const float x = attn::to_float(dout[(head0 + r) * D + col]);
      e += known > 0 || empty_row(lse[head0 + r]) ? x : 0.f;
    }
  }
  part[tid] = e;
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int g = 0; g < NG; ++g) s += part[g * D + tid];
    e_out[tid] = s * inv_t;
  }
  __syncthreads();
}

// Rows r < n of a (rows, D) tile at src into dst (fp32, stride D + 1) times
// mul; rows n .. kTile - 1 are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int n, float mul) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < kTile * CH; c += kThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < n) attn::load8(src + (size_t)r * D + d0, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[r * (D + 1) + d0 + i] = f[i] * mul;
  }
}

// a[i][j] = sum_d x1[(ty + 16 i) * RS + d] * y1[(tx + 16 j) * RS + d], and
// the same of (x2, y2) into c when TWO.
template <int D, bool TWO>
__device__ __forceinline__ void products(float (&a)[4][4], float (&c)[4][4], const float* x1,
                                         const float* y1, const float* x2, const float* y2,
                                         int ty, int tx) {
  constexpr int RS = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float u1[4], w1[4], u2[4], w2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u1[i] = x1[(ty + 16 * i) * RS + d];
      w1[i] = y1[(tx + 16 * i) * RS + d];
      if (TWO) {
        u2[i] = x2[(ty + 16 * i) * RS + d];
        w2[i] = y2[(tx + 16 * i) * RS + d];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[i][j] += u1[i] * w1[j];
        if (TWO) c[i][j] += u2[i] * w2[j];
      }
  }
}

// One block per (64-query tile, query head, batch row).  Writes dq, and each
// row's log-sum-exp of its allowed scores and D = rowsum(dO o).  MASKED:
// kvalid (B, Tlen) bytes, a key with 0 masked; the block walks from its
// batch row's first valid key to its last (km::valid_range) within its
// rows' union, and a row with no allowed valid key gets lse = -inf and dq 0.
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, const uint8_t* __restrict__ kvalid,
          T* __restrict__ dq, float* __restrict__ lse, float* __restrict__ delta, int Hq, int Hkv,
          int S, int Tlen, int causal, int has_window, int window, float scale) {
  constexpr int RS = D + 1;
  constexpr int DJ = (D + 15) / 16;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(kTile, S - q0);
  const int off = Tlen - S;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ float smem[];
  float* qs = smem;                 // kTile x RS, pre-scaled
  float* dos = qs + kTile * RS;     // kTile x RS
  float* ks = dos + kTile * RS;     // kTile x RS
  float* vs = ks + kTile * RS;      // kTile x RS
  float* ps = vs + kTile * RS;      // kTile x kPS: scores, then dS
  float* m_s = ps + kTile * kPS;    // running max of each row
  float* l_s = m_s + kTile;         // running sum
  float* lse_s = l_s + kTile;       // log-sum-exp
  float* dl_s = lse_s + kTile;      // D
  float* kv_s = dl_s + kTile;       // MASKED: the key tile's valid bytes
  // MASKED: a disallowed pair scores -inf, so that a row with no allowed
  // valid key keeps a running sum of 0
  constexpr float kMiss = MASKED ? -INFINITY : attn::kNegInf;
  const uint8_t* vrow = MASKED ? kvalid + (size_t)b * Tlen : nullptr;
  auto stage_valid = [&](int t0, int nt) {   // before the barrier that follows a tile's load
    if (MASKED && tid < kTile) kv_s[tid] = tid < nt && vrow[t0 + tid] ? 1.f : 0.f;
  };
  auto ok = [&](int p, int t0, int c) {
    return allowed(p, t0 + c, causal, has_window, window) && (!MASKED || kv_s[c] != 0.f);
  };

  const size_t row0 = ((size_t)b * Hq + h) * S + q0;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)Tlen * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * (size_t)Tlen * D;
  load_tile<T, D>(qs, q + row0 * D, nq, scale);
  load_tile<T, D>(dos, dout + row0 * D, nq, 1.f);
  if (tid < kTile) {
    m_s[tid] = attn::kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  // D of each row: a warp a row at a time, lanes across d
  for (int rr = 0; rr < kTile / 8; ++rr) {
    const int r = warp * (kTile / 8) + rr;
    float acc = 0.f;
    if (r < nq)
      for (int d = lane; d < D; d += 32)
        acc += dos[r * RS + d] * attn::to_float(o[(row0 + r) * D + d]);
    acc = attn::warp_sum(acc);
    if (lane == 0) dl_s[r] = acc;
  }

  // The union of the key ranges the tile's rows see, in closed form: a
  // causal row at a negative position sees none and needs no tile.
  const int p_first = q0 + off, p_last = q0 + nq - 1 + off;
  int lo = 0, hi = Tlen - 1;
  if (causal) hi = min(hi, p_last);
  if (has_window) lo = max(0, (causal ? max(p_first, 0) : p_first) - window + 1);
  if constexpr (MASKED) {   // and within the row's first and last valid key
    const int2 r = km::valid_range<kThreads>(vrow, Tlen);
    lo = max(lo, r.x);
    hi = min(hi, r.y);
  }
  const int t_begin = (lo / kTile) * kTile;

  // pass 1: each row's max and sum over its allowed keys, as in the forward
  for (int t0 = t_begin; t0 <= hi; t0 += kTile) {
    const int nt = min(kTile, Tlen - t0);
    load_tile<T, D>(ks, kb + (size_t)t0 * D, nt, 1.f);
    stage_valid(t0, nt);
    __syncthreads();
    float sc[4][4], unused[4][4];
    products<D, false>(sc, unused, qs, ks, nullptr, nullptr, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, p = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float s = -INFINITY;   // past T: out of the max, weight 0
        if (c < nt) s = ok(p, t0, c) ? sc[i][j] : kMiss;
        ps[r * kPS + c] = s;
      }
    }
    __syncthreads();
    for (int rr = 0; rr < kTile / 8; ++rr) {
      const int r = warp * (kTile / 8) + rr;
      const float s0 = ps[r * kPS + lane], s1 = ps[r * kPS + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, attn::warp_max(fmaxf(s0, s1)));
      const float sum = attn::warp_sum(expf(s0 - m_new) + expf(s1 - m_new));
      if (lane == 0) {
        l_s[r] = l_s[r] * expf(m_prev - m_new) + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
  }
  if (tid < kTile) lse_s[tid] = m_s[tid] + logf(l_s[tid]);
  __syncthreads();

  // pass 2: dS on the allowed pairs, then dq += dS K
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int t0 = t_begin; t0 <= hi; t0 += kTile) {
    const int nt = min(kTile, Tlen - t0);
    load_tile<T, D>(ks, kb + (size_t)t0 * D, nt, 1.f);
    load_tile<T, D>(vs, vb + (size_t)t0 * D, nt, 1.f);
    stage_valid(t0, nt);
    __syncthreads();
    float sc[4][4], dp[4][4];
    products<D, true>(sc, dp, qs, ks, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, p = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (c < nt && ok(p, t0, c)) ds = expf(sc[i][j] - lse_s[r]) * (dp[i][j] - dl_s[r]);
        ps[r * kPS + c] = ds;
      }
    }
    __syncthreads();
    for (int c = 0; c < nt; ++c) {
      float kk[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = tx + 16 * j < D ? ks[c * RS + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += w * kk[j];
      }
    }
    __syncthreads();   // tiles and dS free for the next step
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (tx + 16 * j < D) attn::store(dq + (row0 + r) * D + tx + 16 * j, acc[i][j] * scale);
  }
  if (tid < nq) {
    lse[row0 + tid] = lse_s[tid];
    delta[row0 + tid] = dl_s[tid];
  }
}

// One block per (64-key tile, kv head, batch row): dk and dv of the tile,
// summed over the G query heads of the kv head and the query tiles that can
// see the tile.  MASKED: kvalid (B, Tlen) bytes; a key with 0 is masked, a
// tile with no valid key walks no query tile, and the rows with no allowed
// valid key (lse -inf) add dO / T to every key's dv (empty_rows_term).
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const uint8_t* __restrict__ kvalid,
           const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
           T* __restrict__ dv, int Hq, int Hkv, int S, int Tlen, int causal, int has_window,
           int window, float scale) {
  constexpr int RS = D + 1;
  constexpr int DJ = (D + 15) / 16;
  const int t0 = blockIdx.x * kTile;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int nt = min(kTile, Tlen - t0);
  const int off = Tlen - S;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float inv_t = 1.f / (float)Tlen;

  extern __shared__ float smem[];
  float* ks = smem;                 // kTile x RS
  float* vs = ks + kTile * RS;      // kTile x RS
  float* qs = vs + kTile * RS;      // kTile x RS, pre-scaled
  float* dos = qs + kTile * RS;     // kTile x RS
  float* pt = dos + kTile * RS;     // kTile x kPS: P^T, key by query
  float* dst = pt + kTile * kPS;    // kTile x kPS: dS^T
  float* lse_s = dst + kTile * kPS;
  float* dl_s = lse_s + kTile;
  float* kv_s = dl_s + kTile;       // MASKED: the tile's valid bytes

  const size_t kv0 = ((size_t)b * Hkv + hk) * Tlen + t0;
  load_tile<T, D>(ks, k + kv0 * D, nt, 1.f);
  load_tile<T, D>(vs, v + kv0 * D, nt, 1.f);

  // The query rows that see a key of the tile: from the first whose causal
  // bound reaches it to the last whose window still does.  A causal row at a
  // negative position sees no key and spreads dO over all of T: with such
  // rows, every tile starts at row 0 (MASKED: empty_rows_term spreads it).
  int i_lo = causal ? max(0, t0 - off) : 0;
  if (!MASKED && causal && off < 0) i_lo = 0;
  int i_hi = has_window ? min(S - 1, t0 + nt - 2 + window - off) : S - 1;

  float ak[4][DJ], av[4][DJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < DJ; ++j) ak[a][j] = av[a][j] = 0.f;
  if constexpr (MASKED) {
    const int kvv = tid < nt && kvalid[(size_t)b * Tlen + t0 + tid];
    if (tid < kTile) kv_s[tid] = kvv ? 1.f : 0.f;
    if (!__syncthreads_or(kvv)) i_hi = -1;   // no valid key: no query tile to walk
    // dv starts from the empty rows' term (pt and dst are free until the walk)
    empty_rows_term<T, D, kThreads>(dout, lse, b, hk, G, Hq, S, inv_t, pt, dst);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < DJ; ++j) av[a][j] = tx + 16 * j < D ? dst[tx + 16 * j] : 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = (i_lo / kTile) * kTile; q0 <= i_hi; q0 += kTile) {
      const int nq = min(kTile, S - q0);
      const size_t row0 = ((size_t)b * Hq + h) * S + q0;
      load_tile<T, D>(qs, q + row0 * D, nq, scale);
      load_tile<T, D>(dos, dout + row0 * D, nq, 1.f);
      if (tid < kTile) {
        lse_s[tid] = tid < nq ? lse[row0 + tid] : 0.f;
        dl_s[tid] = tid < nq ? delta[row0 + tid] : 0.f;
      }
      __syncthreads();
      // keys ty + 16 a against queries tx + 16 c
      float st[4][4], dpt[4][4];
      products<D, true>(st, dpt, ks, qs, vs, dos, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int c = ty + 16 * a, kp = t0 + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j, p = q0 + r + off;
          float pw = 0.f, ds = 0.f;
          if (c < nt && r < nq) {
            if (!MASKED && causal && p < 0) {
              pw = inv_t;
            } else if (allowed(p, kp, causal, has_window, window) &&
                       (!MASKED || kv_s[c] != 0.f)) {
              pw = expf(st[a][j] - lse_s[r]);
              ds = pw * (dpt[a][j] - dl_s[r]);
            }
          }
          pt[c * kPS + r] = pw;
          dst[c * kPS + r] = ds;
        }
      }
      __syncthreads();
      for (int r = 0; r < nq; ++r) {
        float dov[DJ], qv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const bool in = tx + 16 * j < D;
          dov[j] = in ? dos[r * RS + tx + 16 * j] : 0.f;
          qv[j] = in ? qs[r * RS + tx + 16 * j] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float pw = pt[(ty + 16 * a) * kPS + r], ds = dst[(ty + 16 * a) * kPS + r];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            av[a][j] += pw * dov[j];
            ak[a][j] += ds * qv[j];
          }
        }
      }
      __syncthreads();   // tiles free for the next step
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = ty + 16 * a;
    if (c >= nt) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (tx + 16 * j < D) {
        attn::store(dk + (kv0 + c) * D + tx + 16 * j, ak[a][j]);
        attn::store(dv + (kv0 + c) * D + tx + 16 * j, av[a][j]);
      }
  }
}

// kvalid: the (B, Tlen) key mask of the masked kernels; null otherwise.
struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;
  int B, Hq, Hkv, S, Tlen, causal, has_window, window;
  float scale;
  const uint8_t* kvalid = nullptr;
  // the live pair's list of live key tiles (km::live_tiles_kernel)
  uint64_t* words = nullptr;
  int *live = nullptr, *prefix = nullptr;
};

template <typename T, int D, bool MASKED>
cudaError_t launch(const Args& a, bool dkv, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (!dkv) {
    constexpr size_t smem = dq_smem_bytes<D, MASKED>();
    auto kernel = dq_kernel<T, D, MASKED>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kTile - 1) / kTile, a.Hq, a.B);
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, static_cast<const T*>(a.o), dout,
                                             a.kvalid, static_cast<T*>(a.dq), a.lse, a.delta,
                                             a.Hq, a.Hkv, a.S, a.Tlen, a.causal, a.has_window,
                                             a.window, a.scale);
  } else {
    constexpr size_t smem = dkv_smem_bytes<D, MASKED>();
    auto kernel = dkv_kernel<T, D, MASKED>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Tlen + kTile - 1) / kTile, a.Hkv, a.B);
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, a.kvalid, a.lse, a.delta,
                                             static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Hq,
                                             a.Hkv, a.S, a.Tlen, a.causal, a.has_window,
                                             a.window, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, bool MASKED>
cudaError_t launch_d(int D, const Args& a, bool dkv, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, MASKED>(a, dkv, stream);
    case 64: return launch<T, 64, MASKED>(a, dkv, stream);
    case 120: return launch<T, 120, MASKED>(a, dkv, stream);
    case 128: return launch<T, 128, MASKED>(a, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool MASKED>
cudaError_t launch_dtype(int dtype, int D, const Args& a, bool dkv, cudaStream_t stream) {
  if (dtype == 0) return launch_d<float, MASKED>(D, a, dkv, stream);
  if (dtype == 1) return launch_d<__nv_bfloat16, MASKED>(D, a, dkv, stream);
  return cudaErrorInvalidValue;
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// The backward's wgmma design (bf16): the same two kernels and the same
// walks as namespace bwd, on Hopper's tensor cores.  Five products of
// 2 S T d operations a query head (halved when causal) bind the simt pair
// to the CUDA cores' 67 TFLOP/s; here every product is a wgmma, fed by TMA.
//
// Both kernels are blocks of one warpgroup (128 threads) that owns 64 rows.
// Its thread 0 issues the TMA loads (3-D tensor maps per (batch x head,
// position, d), 128-byte swizzle, the forward's Cfg slabs, so that at
// D = 120 TMA zero-fills columns 120..127) into a ring of stages counted by
// mbarriers, and reissues a stage once a block barrier shows every warp
// done with it.  A warpgroup waits for each product before its arithmetic,
// so the tensor cores are kept busy by the other blocks of the SM, and
// what bounds the blocks an SM is registers: the dkv kernel's two sums
// take 128 registers a thread at d = 128, and ptxas compiles a kernel for
// nine or more warps an SM against 168 (three warps share each of the
// SM's four register files).  So neither kernel has a producer warp: two
// dkv blocks of four warps fit an SM (two stages of Q and dO), and three dq
// blocks (one stage of K and V, to fit three in shared memory).
//
//   dq kernel, a block per (64-query tile, query head, batch row), the key
//   tiles the rows can see (bwd's closed form).  D = rowsum(dO o) from
//   global memory in the accumulator's layout.  Pass 1: S = Q K^T by
//   wgmma_ss, each row's max and sum in the accumulator's layout (quad
//   shuffles) -> lse.  Pass 2: S = Q K^T and dP = dO V^T by wgmma_ss (V's
//   tile [key][d] read K-major like K), dS = P (dP - D) in registers, then
//   dq += dS K by wgmma_rs with K read through the transposed (MN-major)
//   descriptor, as the forward reads V.
//   dkv kernel, a block per (64-key tile, kv head, batch row), the G query
//   heads and the query tiles that can see the tile (bwd's i_lo, i_hi).  K
//   and V are loaded once; Q and dO tiles stream through the ring, and the
//   block copies each query tile's lse and D into shared memory (in the
//   transposed products they vary along the columns).  S^T = K Q^T and
//   dP^T = V dO^T by wgmma_ss; P^T and dS^T, keys as rows, are the A
//   operands from registers of dV += P^T dO and dK += dS^T Q (dO and Q
//   MN-major).  dk and dv are summed in registers: no atomics, and the
//   result does not depend on the order of blocks.
//
// P and dS are each split into a bf16 head and the bf16 remainder and both
// are multiplied, as the forward does for P V: a single bf16 copy of either
// errs up to 6 times past atol 1e-3 + rtol 1e-2 (tests/test_torch_flash_bwd.py
// models both).  lse is kept in log2 units (scores times scale log2(e)), so
// P = exp2(s - lse) by ex2.approx.  A causal row at a negative position sees
// no key: the dq kernel gives it P = 0 and dq = 0, the dkv kernel P = 1 / T
// on every key and dS = 0, as the plain version's softmax of equal scores.

namespace wgb {

using wg::Cfg;
constexpr int kT = 64;               // rows of every tile: queries or keys
constexpr int kConsumers = 128;      // a block is one warpgroup
constexpr int kDqStages = 1;         // K and V tiles in flight: three dq blocks an SM
constexpr int kDkvStages = 2;        // Q and dO tiles in flight: two dkv blocks an SM
// The live pair's stages: at D <= 64 two of K and V (four dq blocks an SM,
// 49 KB each) and three of Q and dO (three dkv blocks, 67 KB each); wider
// heads keep the counts above, as their registers allow no more blocks
template <int D>
constexpr int kLiveDqStages = D <= 64 ? 2 : kDqStages;
template <int D>
constexpr int kLiveDkvStages = D <= 64 ? 3 : kDkvStages;

// Shared memory: the 64-row bf16 tiles (Cfg's KV_BYTES each; dq: Q, dO and
// a K and a V a stage; dkv: K, V and a Q and a dO a stage), the dkv
// kernel's lse and D of each stage, the barriers, and room to align.
template <int D, int STAGES = kDqStages>
constexpr int dq_smem() {
  return (2 + 2 * STAGES) * Cfg<D>::KV_BYTES + 8 * (1 + STAGES) + 1024;
}
template <int D, int STAGES = kDkvStages>
constexpr int dkv_smem() {
  return (2 + 2 * STAGES) * Cfg<D>::KV_BYTES + 2 * STAGES * kT * 4 + 8 * (1 + STAGES) + 1024;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// s = A B^T for two 64-row tiles whose rows run along d (both K-major):
// 64 x 64, uncommitted.
template <int D>
__device__ __forceinline__ void issue_abt(float (&s)[kT / 2], uint32_t a_addr, uint32_t b_addr) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    const uint32_t off = (kk / C::KSTEP) * kT * C::SW + (kk % C::KSTEP) * 32;
    const uint64_t da = hopper::make_desc(a_addr + off, 16, 8 * C::SW, C::SW);
    const uint64_t db = hopper::make_desc(b_addr + off, 16, 8 * C::SW, C::SW);
    hopper::wgmma_ss<0>(s, da, db, kk > 0);
  }
}

// acc += X B for X (64 x 64) in registers as bf16 head and remainder and B
// a 64-row tile [row][d] read MN-major through slabs of d; uncommitted.
template <int D>
__device__ __forceinline__ void issue_xb(float (&acc)[Cfg<D>::DP / 2], const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], uint32_t b_addr) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    const uint64_t db = hopper::make_desc(b_addr + kk * 16 * C::SW, kT * C::SW, 8 * C::SW, C::SW);
    hopper::wgmma_rs<1>(acc, hi[kk], db, 1);
    hopper::wgmma_rs<1>(acc, lo[kk], db, 1);
  }
}

// Two values as bf16 pairs: the head and the remainder.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = hopper::pack_bf16(x0, x1);
  lo = hopper::pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xFFFF0000u));
}

// A 64 x 64 accumulator as the A operands of the next product: bf16 head
// and bf16 remainder, 16 columns a step.
__device__ __forceinline__ void pack_split(const float (&x)[kT / 2], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 2 * kk + (r >> 1), i = (r & 1) * 2;
      split_bf16(x[4 * j + i], x[4 * j + i + 1], hi[kk][r], lo[kk][r]);
    }
}

__device__ __forceinline__ void fence_split(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    hopper::fence_regs(hi[kk]);
    hopper::fence_regs(lo[kk]);
  }
}

// Rows r and r + 8 (this thread's, at absolute row `row` of a (rows, D)
// tensor) of acc * mul into dst as bf16, for rows below n; the columns past
// D (zero) are not stored.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[Cfg<D>::DP / 2],
                                           int row, int n, int col0, float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (row < n)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * D + col) =
          hopper::pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (row + 8 < n)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(row + 8) * D + col) =
          hopper::pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The first live key tile (a valid word that is not 0) at or after tile i
// and at or before tile hi; hi + 1 if none.  Every lane of the warp calls it
// and gets the same answer, so every warp of a block that calls it with the
// same arguments walks the same tiles.
__device__ __forceinline__ int next_live(const uint8_t* __restrict__ vrow, int Tlen, int i,
                                         int hi) {
  for (; i <= hi && !km::tile_word(vrow, i * kT, Tlen, threadIdx.x % 32); ++i) {
  }
  return i;
}

// One block per (64-query tile, query head, batch row), the last tile
// first.  Writes dq, and each row's lse (log2 units) and D for the dkv kernel.
// MASKED: kvalid (B, Tlen) bytes, a key with 0 masked; the block walks only
// the live key tiles of its rows' union (km::scan counts them, next_live
// finds each, in every thread alike, so that thread 0's loads and the
// warps' reads agree), and a row with no allowed valid key gets lse = -inf
// and dq = 0.  At D <= 64 it keeps the unmasked kernel's four blocks an SM
// (128 registers: the tile words are read again where they are used, not
// carried across the loads).
template <int D, bool MASKED>
__global__ void __launch_bounds__(kConsumers, MASKED && D <= 64 ? 4 : 3)
dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
          const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
          const uint8_t* __restrict__ kvalid, __nv_bfloat16* __restrict__ dq,
          float* __restrict__ lse, float* __restrict__ delta, int Hq, int Hkv, int S, int Tlen,
          int causal, int has_window, int window, float scale) {
  using C = Cfg<D>;
  constexpr int TB = C::KV_BYTES;   // a 64-row bf16 tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + TB;
  uint8_t* ks = dos + TB;                  // kDqStages K tiles, then kDqStages V tiles
  uint8_t* vs = ks + kDqStages * TB;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kDqStages * TB);
  uint64_t* full = q_full + 1;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kT;
  const int hk = h / (Hq / Hkv);
  const int off = Tlen - S;
  const int nq = min(kT, S - q0);
  // the key tiles the rows see, as in bwd::dq_kernel: none for a tile whose
  // rows all sit at negative causal positions
  const int p_first = q0 + off, p_last = q0 + nq - 1 + off;
  int lo = 0, hi = Tlen - 1;
  if (causal) hi = min(hi, p_last);
  if (has_window) lo = max(0, (causal ? max(p_first, 0) : p_first) - window + 1);
  const int t_begin = (lo / kT) * kT;
  int n_tiles = hi < t_begin ? 0 : (hi - t_begin) / kT + 1;
  // MASKED: the tile of the load read in this iteration and of the next load
  const uint8_t* vrow = MASKED ? kvalid + (size_t)b * Tlen : nullptr;
  const int lo_tile = t_begin / kT, hi_tile = lo_tile + n_tiles - 1;
  int w_tile = lo_tile, n_tile = lo_tile;
  if constexpr (MASKED) {
    static_assert(kDqStages == 1, "the walk is one load ahead of the reads");
    n_tiles = km::scan<kConsumers, kT>(vrow, Tlen, p_first, nq, causal, has_window, window,
                                       lo_tile, hi_tile).live;
    w_tile = next_live(vrow, Tlen, lo_tile, hi_tile);
  }
  const int n_loads = 2 * n_tiles;   // pass 1 streams K tiles, pass 2 K and V tiles

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int g, int tile) {   // thread 0: the tiles of load g into its stage
    const int st = g % kDqStages;
    const bool pass2 = g >= n_tiles;
    const int t0 = tile * kT;
    hopper::mbar_arrive_expect_tx(&full[st], pass2 ? 2 * TB : TB);
#pragma unroll
    for (int s = 0; s < C::NSLAB; ++s) {
      hopper::tma_load_3d(ks + st * TB + s * kT * C::SW, &tm_k, &full[st], s * C::DS, t0,
                          b * Hkv + hk);
      if (pass2)
        hopper::tma_load_3d(vs + st * TB + s * kT * C::SW, &tm_v, &full[st], s * C::DS, t0,
                            b * Hkv + hk);
    }
  };
  // the key tile of load g: pass 1 walks the tiles, pass 2 walks them again
  auto tile_of = [&](int g) { return lo_tile + (g >= n_tiles ? g - n_tiles : g); };
  // MASKED: every thread finds load g + 1's tile (the next live one, or the
  // first again where pass 2 starts) while load g is in flight, and takes it
  // up at the end of iteration g
  auto look_ahead = [&](int g) {
    if (MASKED && g + 1 < n_loads)
      n_tile = next_live(vrow, Tlen, g + 1 == n_tiles ? lo_tile : w_tile + 1, hi_tile);
  };
  // MASKED: the valid word of the tile at t0
  auto word_at = [&](int t0) {
    return MASKED ? km::tile_word(vrow, t0, Tlen, threadIdx.x % 32) : ~0ull;
  };
  // after load g's tiles are read by every warp, the stage takes load g + kDqStages
  auto release = [&](int g) {
    if (g + kDqStages < n_loads) {
      __syncthreads();
      if (threadIdx.x == 0) issue(g + kDqStages, MASKED ? n_tile : tile_of(g + kDqStages));
    }
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    hopper::mbar_arrive_expect_tx(q_full, 2 * TB);
#pragma unroll
    for (int s = 0; s < C::NSLAB; ++s) {
      hopper::tma_load_3d(qs + s * kT * C::SW, &tm_q, q_full, s * C::DS, q0, b * Hq + h);
      hopper::tma_load_3d(dos + s * kT * C::SW, &tm_do, q_full, s * C::DS, q0, b * Hq + h);
    }
    for (int g = 0; g < min(kDqStages, n_loads); ++g) issue(g, MASKED ? w_tile : tile_of(g));
  }

  // this thread holds rows r0 and r0 + 8 of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  const int pa = q0 + r0 + off, pb = pa + 8;
  const float scale_log2 = scale * 1.4426950408889634f;
  const size_t row0 = ((size_t)b * Hq + h) * S + q0;

  // D of the two rows: each quad sums a row's products
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll 4
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (r0 < nq) {
      const float2 a = hopper::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(o + (row0 + r0) * D + col));
      const float2 g = hopper::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(dout + (row0 + r0) * D + col));
      dl0 += a.x * g.x + a.y * g.y;
    }
    if (r0 + 8 < nq) {
      const float2 a = hopper::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(o + (row0 + r0 + 8) * D + col));
      const float2 g = hopper::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(dout + (row0 + r0 + 8) * D + col));
      dl1 += a.x * g.x + a.y * g.y;
    }
  }
  dl0 = quad_sum(dl0);
  dl1 = quad_sum(dl1);

  const uint32_t q_addr = hopper::smem_addr(qs), do_addr = hopper::smem_addr(dos);
  const uint32_t k_base = hopper::smem_addr(ks), v_base = hopper::smem_addr(vs);
  auto need_mask = [&](int t0) {
    return t0 + kT > Tlen || (causal && t0 + kT - 1 > p_first) ||
           (has_window && t0 <= p_first + kT - 1 - window);
  };
  auto allowed = [&](int p, int kp) {
    return kp < Tlen && (!causal || kp <= p) && (!has_window || kp > p - window);
  };
  // MASKED: the valid bits of this thread's two keys of column group j
  auto valid2 = [&](uint64_t word, int j) {
    return MASKED ? (uint32_t)(word >> (8 * j)) >> col0 : 3u;
  };

  // pass 1: each row's max and sum over its allowed keys (log2 units)
  float m0 = attn::kNegInf, m1 = attn::kNegInf, l0 = 0.f, l1 = 0.f;
  float s[kT / 2];
  if (n_tiles > 0) hopper::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kDqStages, t0 = (MASKED ? w_tile : tile_of(it)) * kT;
    look_ahead(it);
    hopper::mbar_wait(&full[st], (it / kDqStages) & 1);
    hopper::wgmma_fence();
    issue_abt<D>(s, q_addr, k_base + st * TB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    release(it);
    const uint64_t word = word_at(t0);
    const bool mask = need_mask(t0) || (MASKED && word != ~0ull);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[4 * j + i] * scale_log2;
        if (mask && (!allowed(i < 2 ? pa : pb, t0 + 8 * j + col0 + (i & 1)) ||
                     !((valid2(word, j) >> (i & 1)) & 1)))
          x = -INFINITY;
        s[4 * j + i] = x;
        if (i < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      sum0 += hopper::exp2_approx(s[4 * j] - mx0) + hopper::exp2_approx(s[4 * j + 1] - mx0);
      sum1 += hopper::exp2_approx(s[4 * j + 2] - mx1) + hopper::exp2_approx(s[4 * j + 3] - mx1);
    }
    l0 = l0 * hopper::exp2_approx(m0 - mx0) + sum0;
    l1 = l1 * hopper::exp2_approx(m1 - mx1) + sum1;
    m0 = mx0;
    m1 = mx1;
    if constexpr (MASKED) w_tile = n_tile;
  }
  // a row with no allowed key has l = 0 and lse = -inf; it takes P = 0 below
  const float lse0 = m0 + log2f(quad_sum(l0)), lse1 = m1 + log2f(quad_sum(l1));

  // pass 2: dS on the allowed pairs, dq += dS K
  float acc[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int g = n_tiles + it, st = g % kDqStages, t0 = (MASKED ? w_tile : tile_of(g)) * kT;
    float dp[kT / 2];
    look_ahead(g);
    hopper::mbar_wait(&full[st], (g / kDqStages) & 1);
    hopper::wgmma_fence();
    issue_abt<D>(s, q_addr, k_base + st * TB);
    issue_abt<D>(dp, do_addr, v_base + st * TB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    const uint64_t word = word_at(t0);
    const bool mask = need_mask(t0) || (MASKED && word != ~0ull);
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool top = i < 2;
        float pw = hopper::exp2_approx(s[4 * j + i] * scale_log2 - (top ? lse0 : lse1));
        if (mask && (!allowed(top ? pa : pb, t0 + 8 * j + col0 + (i & 1)) ||
                     !((valid2(word, j) >> (i & 1)) & 1)))
          pw = 0.f;
        dp[4 * j + i] = pw * (dp[4 * j + i] - (top ? dl0 : dl1));
      }
    uint32_t dhi[4][4], dlo[4][4];
    pack_split(dp, dhi, dlo);
    hopper::wgmma_fence();
    issue_xb<D>(acc, dhi, dlo, k_base + st * TB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    fence_split(dhi, dlo);
    release(g);
    if constexpr (MASKED) w_tile = n_tile;
  }

  store_rows<D>(dq + row0 * D, acc, r0, nq, col0, scale);
  if (lane % 4 == 0) {
    if (r0 < nq) {
      lse[row0 + r0] = lse0;
      delta[row0 + r0] = dl0;
    }
    if (r0 + 8 < nq) {
      lse[row0 + r0 + 8] = lse1;
      delta[row0 + r0 + 8] = dl1;
    }
  }
}

// The live pair's dq kernel (bf16, under a key mask): one block per
// (64-query tile, query head, batch row), the last tile first, as dq_kernel
// but for three things.  lse is the forward's (flash_wgmma_kernel<D, true>
// writes it for autograd), so there is no first pass: one Q K^T and one load
// of each K tile.  The walk is the block's segment of its batch row's list
// of live tiles (km::live_tiles_kernel, built once a call): the live tiles of
// the union of its rows' ranges, prefix[lo] .. prefix[hi + 1], each with its
// valid word; no block reads the mask.  And, the walk known up front, K and V
// stream through kLiveDqStages<D> stages.  A row with no allowed valid key
// (lse -inf) gets dq = 0: each of its pairs is masked, so P = 0.
template <int D>
__global__ void __launch_bounds__(kConsumers, D <= 64 ? 4 : 3)
dq_live_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
               const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const uint64_t* __restrict__ words,
               const int* __restrict__ live, const int* __restrict__ prefix, int n_kt,
               __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int Hq, int Hkv, int S,
               int Tlen, int causal, int has_window, int window, float scale) {
  using C = Cfg<D>;
  constexpr int TB = C::KV_BYTES;   // a 64-row bf16 tile
  constexpr int NS = kLiveDqStages<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + TB;
  uint8_t* ks = dos + TB;                  // NS K tiles, then NS V tiles
  uint8_t* vs = ks + NS * TB;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + NS * TB);
  uint64_t* full = q_full + 1;
  // each stage's tile: its valid word and t0, written by thread 0 before the
  // load's arrival and read after the wait on it, so that no thread holds
  // the word in registers across the products
  uint64_t* slot_word = full + NS;
  int* slot_t0 = reinterpret_cast<int*>(slot_word + NS);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kT;
  const int hk = h / (Hq / Hkv);
  const int off = Tlen - S;
  const int nq = min(kT, S - q0);
  // the union of the rows' ranges, as in dq_kernel, then its live tiles
  const int p_first = q0 + off, p_last = q0 + nq - 1 + off;
  int lo = 0, hi = Tlen - 1;
  if (causal) hi = min(hi, p_last);
  if (has_window) lo = max(0, (causal ? max(p_first, 0) : p_first) - window + 1);
  const int lo_tile = lo / kT, hi_tile = hi / kT;
  const int* prow = prefix + (size_t)b * (n_kt + 1);
  const int j0 = hi < lo_tile * kT ? 0 : prow[lo_tile];
  const int n_tiles = hi < lo_tile * kT ? 0 : prow[hi_tile + 1] - j0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int g) {   // thread 0: the K and V tiles of walk g into its stage
    // the block's live tiles are live[b][j0 ..], in order
    const int st = g % NS, tile = live[(size_t)b * n_kt + j0 + g], t0 = tile * kT;
    slot_word[st] = words[(size_t)b * n_kt + tile];   // released by the arrival below
    slot_t0[st] = t0;
    hopper::mbar_arrive_expect_tx(&full[st], 2 * TB);
#pragma unroll
    for (int s = 0; s < C::NSLAB; ++s) {
      hopper::tma_load_3d(ks + st * TB + s * kT * C::SW, &tm_k, &full[st], s * C::DS, t0,
                          b * Hkv + hk);
      hopper::tma_load_3d(vs + st * TB + s * kT * C::SW, &tm_v, &full[st], s * C::DS, t0,
                          b * Hkv + hk);
    }
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    hopper::mbar_arrive_expect_tx(q_full, 2 * TB);
#pragma unroll
    for (int s = 0; s < C::NSLAB; ++s) {
      hopper::tma_load_3d(qs + s * kT * C::SW, &tm_q, q_full, s * C::DS, q0, b * Hq + h);
      hopper::tma_load_3d(dos + s * kT * C::SW, &tm_do, q_full, s * C::DS, q0, b * Hq + h);
    }
    for (int g = 0; g < min(NS, n_tiles); ++g) issue(g);
  }

  // this thread holds rows r0 and r0 + 8 of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  const int pa = q0 + r0 + off, pb = pa + 8;
  const float scale_log2 = scale * 1.4426950408889634f;
  const size_t row0 = ((size_t)b * Hq + h) * S + q0;
  // the forward's lse of the two rows; +inf past S, so that P is 0 there
  const float lse0 = r0 < nq ? lse[row0 + r0] : INFINITY;
  const float lse1 = r0 + 8 < nq ? lse[row0 + r0 + 8] : INFINITY;

  // D of the two rows: each quad sums a row's products
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll 4
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (r0 < nq) {
      const float2 a = hopper::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(o + (row0 + r0) * D + col));
      const float2 g = hopper::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(dout + (row0 + r0) * D + col));
      dl0 += a.x * g.x + a.y * g.y;
    }
    if (r0 + 8 < nq) {
      const float2 a = hopper::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(o + (row0 + r0 + 8) * D + col));
      const float2 g = hopper::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(dout + (row0 + r0 + 8) * D + col));
      dl1 += a.x * g.x + a.y * g.y;
    }
  }
  dl0 = quad_sum(dl0);
  dl1 = quad_sum(dl1);

  const uint32_t q_addr = hopper::smem_addr(qs), do_addr = hopper::smem_addr(dos);
  const uint32_t k_base = hopper::smem_addr(ks), v_base = hopper::smem_addr(vs);
  auto need_mask = [&](int t0) {
    return t0 + kT > Tlen || (causal && t0 + kT - 1 > p_first) ||
           (has_window && t0 <= p_first + kT - 1 - window);
  };
  auto allowed = [&](int p, int kp) {
    return kp < Tlen && (!causal || kp <= p) && (!has_window || kp > p - window);
  };

  // dS on the allowed valid pairs, dq += dS K
  float acc[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) acc[i] = 0.f;
  if (n_tiles > 0) hopper::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % NS;
    float s[kT / 2], dp[kT / 2];
    hopper::mbar_wait(&full[st], (it / NS) & 1);
    hopper::wgmma_fence();
    issue_abt<D>(s, q_addr, k_base + st * TB);
    issue_abt<D>(dp, do_addr, v_base + st * TB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    // byte j of the tile's word holds keys 8j .. 8j + 7
    const int t0 = slot_t0[st];
    const uint8_t* kbits = reinterpret_cast<const uint8_t*>(slot_word + st);
    const bool mask = need_mask(t0) || slot_word[st] != ~0ull;
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const uint32_t valid = (uint32_t)kbits[j] >> col0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool top = i < 2;
        float pw = hopper::exp2_approx(s[4 * j + i] * scale_log2 - (top ? lse0 : lse1));
        if (mask && (!allowed(top ? pa : pb, t0 + 8 * j + col0 + (i & 1)) ||
                     !((valid >> (i & 1)) & 1)))
          pw = 0.f;
        dp[4 * j + i] = pw * (dp[4 * j + i] - (top ? dl0 : dl1));
      }
    }
    uint32_t dhi[4][4], dlo[4][4];
    pack_split(dp, dhi, dlo);
    hopper::wgmma_fence();
    issue_xb<D>(acc, dhi, dlo, k_base + st * TB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    fence_split(dhi, dlo);
    if (it + NS < n_tiles) {   // every warp is done with the stage: it takes walk it + NS
      __syncthreads();
      if (threadIdx.x == 0) issue(it + NS);
    }
  }

  store_rows<D>(dq + row0 * D, acc, r0, nq, col0, scale);
  if (lane % 4 == 0) {
    if (r0 < nq) delta[row0 + r0] = dl0;
    if (r0 + 8 < nq) delta[row0 + r0 + 8] = dl1;
  }
}

// One block per (64-key tile, kv head, batch row), the first tile first:
// dk and dv of the tile, summed over the G query heads of the kv head and
// the query tiles that can see the tile.  MASKED: kvalid (B, Tlen) bytes; a
// key with 0 is masked, a tile with no valid key loads and walks nothing,
// and the rows with no allowed valid key (lse -inf) add dO / T to every
// key's dv (bwd::empty_rows_term, from dout in global memory).
// MASKED at D <= 64: three blocks an SM, as the unmasked kernel's registers
// allow (168: masked keys are moved past T rather than kept as bits, and
// the empty rows' term comes after the walk)
// LIVE (the live pair, MASKED too): the tile's word from the list of
// km::live_tiles_kernel (words, prefix: n_kt tiles a batch row), not from
// the mask; kLiveDkvStages<D> stages; and where neither causal nor a
// window can empty a row, the empty rows' term from the batch row's count of
// live tiles (none: every row is empty; some: none is), not a pass over lse.
template <int D, bool MASKED, bool LIVE = false>
__global__ void __launch_bounds__(kConsumers, MASKED && D <= 64 ? 3 : 2)
dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
           const __nv_bfloat16* __restrict__ dout, const uint8_t* __restrict__ kvalid,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const uint64_t* __restrict__ words, const int* __restrict__ prefix, int n_kt,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Hq, int Hkv,
           int S, int Tlen, int causal, int has_window, int window, float scale) {
  static_assert(MASKED || !LIVE, "the live pair is masked");
  using C = Cfg<D>;
  constexpr int TB = C::KV_BYTES;   // a 64-row bf16 tile
  constexpr int NS = LIVE ? kLiveDkvStages<D> : kDkvStages;   // Q and dO stages
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + TB;
  uint8_t* qs = vs + TB;                   // NS Q tiles, then NS dO tiles
  uint8_t* dos = qs + NS * TB;
  float* lse_s = reinterpret_cast<float*>(dos + NS * TB);   // NS x kT
  float* dl_s = lse_s + NS * kT;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + NS * kT);
  uint64_t* full = kv_full + 1;

  const int hk = blockIdx.x, b = blockIdx.y, t0 = blockIdx.z * kT;
  const int G = Hq / Hkv;
  const int off = Tlen - S;
  const int nt = min(kT, Tlen - t0);
  const int tid = threadIdx.x;
  // MASKED: the tile's valid word, the same in every warp
  const uint64_t word = LIVE     ? words[(size_t)b * n_kt + blockIdx.z]
                        : MASKED ? km::tile_word(kvalid + (size_t)b * Tlen, t0, Tlen, tid % 32)
                                 : ~0ull;
  // the query rows that see a key of the tile, as in bwd::dkv_kernel
  int i_lo = causal ? max(0, t0 - off) : 0;
  if (!MASKED && causal && off < 0) i_lo = 0;
  const int i_hi = has_window ? min(S - 1, t0 + nt - 2 + window - off) : S - 1;
  const int q_begin = (i_lo / kT) * kT;
  const int n_qt = i_hi < q_begin || word == 0 ? 0 : (i_hi - q_begin) / kT + 1;
  const int n_it = G * n_qt;

  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int it) {   // thread 0: the Q and dO tiles of iteration it
    const int st = it % NS, h = hk * G + it / n_qt, q0 = q_begin + (it % n_qt) * kT;
    hopper::mbar_arrive_expect_tx(&full[st], 2 * TB);
#pragma unroll
    for (int s = 0; s < C::NSLAB; ++s) {
      hopper::tma_load_3d(qs + st * TB + s * kT * C::SW, &tm_q, &full[st], s * C::DS, q0,
                          b * Hq + h);
      hopper::tma_load_3d(dos + st * TB + s * kT * C::SW, &tm_do, &full[st], s * C::DS, q0,
                          b * Hq + h);
    }
  };
  if (tid == 0 && n_it > 0) {
    hopper::mbar_arrive_expect_tx(kv_full, 2 * TB);
#pragma unroll
    for (int s = 0; s < C::NSLAB; ++s) {
      hopper::tma_load_3d(ks + s * kT * C::SW, &tm_k, kv_full, s * C::DS, t0, b * Hkv + hk);
      hopper::tma_load_3d(vs + s * kT * C::SW, &tm_v, kv_full, s * C::DS, t0, b * Hkv + hk);
    }
    for (int it = 0; it < min(NS, n_it); ++it) issue(it);
  }
  // threads 0..63 copy a query tile's lse, threads 64..127 its D
  float* stat_s = (tid < kT ? lse_s : dl_s) + tid % kT;
  const float* stat_g = tid < kT ? lse : delta;

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  // this thread's keys; MASKED: a masked key is moved past T, so that the
  // masking drops it as it drops the keys past T
  const int ka = t0 + r0 + (MASKED && !((word >> r0) & 1) ? Tlen : 0);
  const int kb = t0 + r0 + 8 + (MASKED && !((word >> (r0 + 8)) & 1) ? Tlen : 0);
  const bool partial = MASKED && word != ~0ull;   // the tile has a masked key
  const float scale_log2 = scale * 1.4426950408889634f;
  const float inv_t = 1.f / (float)Tlen;   // unmasked: P of a row with no key
  const uint32_t k_addr = hopper::smem_addr(ks), v_addr = hopper::smem_addr(vs);
  const uint32_t q_base = hopper::smem_addr(qs), do_base = hopper::smem_addr(dos);

  float acc_k[C::DP / 2], acc_v[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (n_it > 0) hopper::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % NS, q0 = q_begin + (it % n_qt) * kT;
    const int p0 = q0 + off;   // position of the tile's first query
    // this thread's lse or D of the tile, read now and stored while the
    // products run; a stage's slot is rewritten NS iterations later,
    // past the next iteration's barrier, so no thread still reads it
    const int qr = q0 + tid % kT;
    const float sv = qr < S ? stat_g[((size_t)b * Hq + hk * G + it / n_qt) * S + qr] : 0.f;
    float sc[kT / 2], dp[kT / 2];
    hopper::mbar_wait(&full[st], (it / NS) & 1);
    hopper::wgmma_fence();
    issue_abt<D>(sc, k_addr, q_base + st * TB);
    issue_abt<D>(dp, v_addr, do_base + st * TB);
    hopper::wgmma_commit();
    stat_s[st * kT] = sv;
    __syncthreads();   // the tile's lse and D in shared memory
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    // masking only where a pair of the tile is not plainly allowed
    const bool mask = t0 + kT > Tlen || q0 + kT > S || (causal && p0 < 0) ||
                      (causal && t0 + kT - 1 > p0) ||
                      (has_window && t0 <= p0 + kT - 1 - window) || partial;
    // P^T and dS^T, 8 query columns at a time, straight into the A operands
    const float2* ls = reinterpret_cast<const float2*>(lse_s + st * kT) + lane % 4;
    const float2* dls = reinterpret_cast<const float2*>(dl_s + st * kT) + lane % 4;
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float2 l = ls[4 * j], dl = dls[4 * j];   // columns 8j + col0 and + 1
      float pw[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * j + col0 + (i & 1);        // query column of the tile
        pw[i] = hopper::exp2_approx(sc[4 * j + i] * scale_log2 - ((i & 1) ? l.y : l.x));
        g[i] = pw[i] * (dp[4 * j + i] - ((i & 1) ? dl.y : dl.x));
        if (mask) {
          const int p = p0 + c, kp = i < 2 ? ka : kb;
          if (q0 + c >= S || kp >= Tlen) {
            pw[i] = g[i] = 0.f;
          } else if (!MASKED && causal && p < 0) {
            pw[i] = inv_t;   // a row with no key: the mean of v
            g[i] = 0.f;
          } else if ((causal && kp > p) || (has_window && kp <= p - window)) {
            pw[i] = g[i] = 0.f;
          }
        }
      }
      const int kk = j / 2, r = 2 * (j % 2);   // rows r0 then r0 + 8 of step kk
      split_bf16(pw[0], pw[1], phi[kk][r], plo[kk][r]);
      split_bf16(pw[2], pw[3], phi[kk][r + 1], plo[kk][r + 1]);
      split_bf16(g[0], g[1], dhi[kk][r], dlo[kk][r]);
      split_bf16(g[2], g[3], dhi[kk][r + 1], dlo[kk][r + 1]);
    }
    hopper::wgmma_fence();
    issue_xb<D>(acc_v, phi, plo, do_base + st * TB);
    issue_xb<D>(acc_k, dhi, dlo, q_base + st * TB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_v);
    hopper::fence_regs(acc_k);
    fence_split(phi, plo);
    fence_split(dhi, dlo);
    if (it + NS < n_it) {
      __syncthreads();   // every warp is done with the stage
      if (tid == 0) issue(it + NS);
    }
  }

  // MASKED: dv takes the empty rows' term.  lse_s and dl_s are its scratch:
  // its first block barrier follows every thread's last read of them
  if constexpr (MASKED) {
    static_assert(2 * NS * kT >= kConsumers + D, "scratch for empty_rows_term");
    const int known = LIVE && !causal && !has_window ? prefix[(size_t)b * (n_kt + 1) + n_kt] == 0
                                                     : -1;
    bwd::empty_rows_term<__nv_bfloat16, D, kConsumers>(dout, lse, b, hk, G, Hq, S,
                                                       1.f / (float)Tlen, lse_s,
                                                       lse_s + kConsumers, known);
#pragma unroll
    for (int j = 0; j < C::DP / 8; ++j) {
      const int col = 8 * j + col0;
      const float e0 = col < D ? lse_s[kConsumers + col] : 0.f;
      const float e1 = col + 1 < D ? lse_s[kConsumers + col + 1] : 0.f;
      acc_v[4 * j] += e0;
      acc_v[4 * j + 1] += e1;
      acc_v[4 * j + 2] += e0;
      acc_v[4 * j + 3] += e1;
    }
  }
  const size_t kv0 = ((size_t)b * Hkv + hk) * Tlen + t0;
  store_rows<D>(dk + kv0 * D, acc_k, r0, nt, col0, scale);
  store_rows<D>(dv + kv0 * D, acc_v, r0, nt, col0, 1.f);
}

template <int D, bool MASKED, bool LIVE = false>
cudaError_t launch(const bwd::Args& a, bool dkv, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t nq = (uint64_t)a.B * a.Hq, nkv = (uint64_t)a.B * a.Hkv;
  if (!hopper::encode_bf16_3d(&tq, a.q, D, a.S, nq, D, (uint64_t)a.S * D, C::DS, kT, 1, C::SW) ||
      !hopper::encode_bf16_3d(&tdo, a.dout, D, a.S, nq, D, (uint64_t)a.S * D, C::DS, kT, 1,
                              C::SW) ||
      !hopper::encode_bf16_3d(&tk, a.k, D, a.Tlen, nkv, D, (uint64_t)a.Tlen * D, C::DS, kT, 1,
                              C::SW) ||
      !hopper::encode_bf16_3d(&tv, a.v, D, a.Tlen, nkv, D, (uint64_t)a.Tlen * D, C::DS, kT, 1,
                              C::SW))
    return cudaErrorInvalidValue;
  const int n_kt = (a.Tlen + kT - 1) / kT;
  if (!dkv && LIVE) {
    // the list of live tiles, then the dq kernel that walks it
    constexpr int smem = dq_smem<D, kLiveDqStages<D>>() + 12 * kLiveDqStages<D>;   // + slots
    auto kernel = dq_live_kernel<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    km::live_tiles_kernel<<<a.B, km::kListThreads, 0, stream>>>(a.kvalid, a.Tlen, n_kt, a.words,
                                                                  a.live, a.prefix);
    const dim3 grid(a.Hq, a.B, (a.S + kT - 1) / kT);
    kernel<<<grid, kConsumers, smem, stream>>>(
        tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(a.o),
        static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.words, a.live, a.prefix, n_kt,
        static_cast<__nv_bfloat16*>(a.dq), a.delta, a.Hq, a.Hkv, a.S, a.Tlen, a.causal,
        a.has_window, a.window, a.scale);
  } else if (!dkv) {
    auto kernel = dq_kernel<D, MASKED>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
    if (err != cudaSuccess) return err;
    const dim3 grid(a.Hq, a.B, (a.S + kT - 1) / kT);
    kernel<<<grid, kConsumers, dq_smem<D>(), stream>>>(
        tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(a.o),
        static_cast<const __nv_bfloat16*>(a.dout), a.kvalid, static_cast<__nv_bfloat16*>(a.dq),
        a.lse, a.delta, a.Hq, a.Hkv, a.S, a.Tlen, a.causal, a.has_window, a.window, a.scale);
  } else {
    constexpr int smem = dkv_smem<D, LIVE ? kLiveDkvStages<D> : kDkvStages>();
    auto kernel = dkv_kernel<D, MASKED, LIVE>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.Hkv, a.B, n_kt);
    kernel<<<grid, kConsumers, smem, stream>>>(
        tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(a.dout), a.kvalid, a.lse, a.delta,
        a.words, a.prefix, n_kt, static_cast<__nv_bfloat16*>(a.dk),
        static_cast<__nv_bfloat16*>(a.dv), a.Hq, a.Hkv, a.S, a.Tlen, a.causal, a.has_window,
        a.window, a.scale);
  }
  return cudaGetLastError();
}

template <bool MASKED, bool LIVE = false>
cudaError_t launch_d(int D, const bwd::Args& a, bool dkv, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, MASKED, LIVE>(a, dkv, stream);
    case 64: return launch<64, MASKED, LIVE>(a, dkv, stream);
    case 120: return launch<120, MASKED, LIVE>(a, dkv, stream);
    case 128: return launch<128, MASKED, LIVE>(a, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wgb

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int S, int Tlen, int D,
                                   int causal, int has_window, int window, float scale,
                                   int dtype, void* stream) {
  return launch_dtype<false>(dtype, D, q, k, v, nullptr, out, B, Hq, Hkv, S, Tlen, causal,
                             has_window, window, scale, static_cast<cudaStream_t>(stream));
}

// The key-masked route: the simt design, with kvalid (B, Tlen) bytes (0 =
// masked key).  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch; the caller raises on anything but 0.
extern "C" int flash_attention_masked_fwd(const void* q, const void* k, const void* v,
                                          const uint8_t* kvalid, void* out, int B, int Hq,
                                          int Hkv, int S, int Tlen, int D, int causal,
                                          int has_window, int window, float scale, int dtype,
                                          void* stream) {
  return launch_dtype<true>(dtype, D, q, k, v, kvalid, out, B, Hq, Hkv, S, Tlen, causal,
                            has_window, window, scale, static_cast<cudaStream_t>(stream));
}

// bf16 only: the wgmma design.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a head dim it does not take or a tensor map
// that cuTensorMapEncodeTiled refuses; the caller raises on anything but 0.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* out,
                                         int B, int Hq, int Hkv, int S, int Tlen, int D,
                                         int causal, int has_window, int window, float scale,
                                         void* stream) {
  return wg::launch_d<false>(D, q, k, v, nullptr, out, nullptr, B, Hq, Hkv, S, Tlen, causal,
                             has_window, window, scale, static_cast<cudaStream_t>(stream));
}

// bf16 only: the wgmma design under kvalid (B, Tlen) bytes (0 = masked key),
// walking only the key tiles that hold a valid key.  lse: null, or (B, Hq, S)
// fp32 for each row's log-sum-exp in log2 units (-inf on a row with no
// allowed valid key), which flash_attention_bwd_dq_wgmma_live reads; a
// serving call passes null and writes nothing more.  Returns as
// flash_attention_wgmma_fwd.
extern "C" int flash_attention_wgmma_masked_fwd(const void* q, const void* k, const void* v,
                                                const uint8_t* kvalid, void* out, float* lse,
                                                int B, int Hq, int Hkv, int S, int Tlen, int D,
                                                int causal, int has_window, int window,
                                                float scale, void* stream) {
  return wg::launch_d<true>(D, q, k, v, kvalid, out, lse, B, Hq, Hkv, S, Tlen, causal,
                            has_window, window, scale, static_cast<cudaStream_t>(stream));
}

// The backward's first kernel: dq (B, Hq, S, D), and each row's log-sum-exp
// and D = rowsum(dO o) into lse and delta (B, Hq, S) fp32 for the second.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch; the caller raises on anything but 0.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, void* dq, float* lse,
                                      float* delta, int B, int Hq, int Hkv, int S, int Tlen,
                                      int D, int causal, int has_window, int window,
                                      float scale, int dtype, void* stream) {
  const bwd::Args a{q, k, v, o, dout, dq, nullptr, nullptr, lse, delta, B, Hq, Hkv, S, Tlen,
                    causal, has_window, window, scale};
  return bwd::launch_dtype<false>(dtype, D, a, false, static_cast<cudaStream_t>(stream));
}

// The backward's second kernel, after the first on the same stream: dk and
// dv (B, Hkv, Tlen, D) from lse and delta.  dtype: 0 = float32, 1 =
// bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int B, int Hq, int Hkv, int S,
                                       int Tlen, int D, int causal, int has_window, int window,
                                       float scale, int dtype, void* stream) {
  const bwd::Args a{q, k, v, nullptr, dout, nullptr, dk, dv, const_cast<float*>(lse),
                    const_cast<float*>(delta), B, Hq, Hkv, S, Tlen, causal, has_window,
                    window, scale};
  return bwd::launch_dtype<false>(dtype, D, a, true, static_cast<cudaStream_t>(stream));
}

// The wgmma design of the backward's first kernel (bf16 only): dq, and each
// row's lse (log2 units) and D = rowsum(dO o) into lse and delta (B, Hq, S)
// fp32 for flash_attention_bwd_dkv_wgmma, which alone reads them.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dim it does not take or a tensor map that cuTensorMapEncodeTiled refuses;
// the caller raises on anything but 0.
extern "C" int flash_attention_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, void* dq, float* lse,
                                            float* delta, int B, int Hq, int Hkv, int S, int Tlen,
                                            int D, int causal, int has_window, int window,
                                            float scale, void* stream) {
  const bwd::Args a{q, k, v, o, dout, dq, nullptr, nullptr, lse, delta, B, Hq, Hkv, S, Tlen,
                    causal, has_window, window, scale};
  return wgb::launch_d<false>(D, a, false, static_cast<cudaStream_t>(stream));
}

// The wgmma design of the backward's second kernel (bf16 only), after
// flash_attention_bwd_dq_wgmma on the same stream: dk and dv (B, Hkv, Tlen, D)
// from its lse and delta.  Returns as flash_attention_bwd_dq_wgmma.
extern "C" int flash_attention_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, void* dk, void* dv, int B, int Hq,
                                             int Hkv, int S, int Tlen, int D, int causal,
                                             int has_window, int window, float scale,
                                             void* stream) {
  const bwd::Args a{q, k, v, nullptr, dout, nullptr, dk, dv, const_cast<float*>(lse),
                    const_cast<float*>(delta), B, Hq, Hkv, S, Tlen, causal, has_window,
                    window, scale};
  return wgb::launch_d<false>(D, a, true, static_cast<cudaStream_t>(stream));
}

// The backward of the key-masked routes: the same two kernels as
// flash_attention_bwd_dq / _dkv (simt) and flash_attention_bwd_dq_wgmma /
// _dkv_wgmma (bf16 only), with kvalid (B, Tlen) bytes (0 = masked key).  The
// dq kernel writes lse = -inf for a row with no allowed valid key; the dkv
// kernel, after it on the same stream, spreads such a row's dO / T over dv
// of every key.  dtype: 0 = float32, 1 = bfloat16.  Each returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue, as the
// unmasked entry points); the caller raises on anything but 0.
extern "C" int flash_attention_bwd_dq_masked(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout,
                                             const uint8_t* kvalid, void* dq, float* lse,
                                             float* delta, int B, int Hq, int Hkv, int S,
                                             int Tlen, int D, int causal, int has_window,
                                             int window, float scale, int dtype, void* stream) {
  const bwd::Args a{q, k, v, o, dout, dq, nullptr, nullptr, lse, delta, B, Hq, Hkv, S, Tlen,
                    causal, has_window, window, scale, kvalid};
  return bwd::launch_dtype<true>(dtype, D, a, false, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dkv_masked(const void* q, const void* k, const void* v,
                                              const void* dout, const uint8_t* kvalid,
                                              const float* lse, const float* delta, void* dk,
                                              void* dv, int B, int Hq, int Hkv, int S, int Tlen,
                                              int D, int causal, int has_window, int window,
                                              float scale, int dtype, void* stream) {
  const bwd::Args a{q, k, v, nullptr, dout, nullptr, dk, dv, const_cast<float*>(lse),
                    const_cast<float*>(delta), B, Hq, Hkv, S, Tlen, causal, has_window,
                    window, scale, kvalid};
  return bwd::launch_dtype<true>(dtype, D, a, true, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dq_wgmma_masked(const void* q, const void* k, const void* v,
                                                   const void* o, const void* dout,
                                                   const uint8_t* kvalid, void* dq, float* lse,
                                                   float* delta, int B, int Hq, int Hkv, int S,
                                                   int Tlen, int D, int causal, int has_window,
                                                   int window, float scale, void* stream) {
  const bwd::Args a{q, k, v, o, dout, dq, nullptr, nullptr, lse, delta, B, Hq, Hkv, S, Tlen,
                    causal, has_window, window, scale, kvalid};
  return wgb::launch_d<true>(D, a, false, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dkv_wgmma_masked(const void* q, const void* k, const void* v,
                                                    const void* dout, const uint8_t* kvalid,
                                                    const float* lse, const float* delta,
                                                    void* dk, void* dv, int B, int Hq, int Hkv,
                                                    int S, int Tlen, int D, int causal,
                                                    int has_window, int window, float scale,
                                                    void* stream) {
  const bwd::Args a{q, k, v, nullptr, dout, nullptr, dk, dv, const_cast<float*>(lse),
                    const_cast<float*>(delta), B, Hq, Hkv, S, Tlen, causal, has_window,
                    window, scale, kvalid};
  return wgb::launch_d<true>(D, a, true, static_cast<cudaStream_t>(stream));
}

// The live pair (bf16 only), the backward of the key-masked route with the
// forward's lse: the first entry builds each batch row's list of live key
// tiles into words (B, n_kt) u64, live (B, n_kt) and prefix (B, n_kt + 1)
// int32 (n_kt = ceil(Tlen / 64)), then launches the dq kernel, which reads
// lse (B, Hq, S) fp32 as flash_attention_wgmma_masked_fwd wrote it and
// writes dq and delta; the second, after it on the same stream, writes dk
// and dv from lse, delta and the list.  Each returns cudaGetLastError()
// after its launches (or cudaErrorInvalidValue, as the other entry points);
// the caller raises on anything but 0.
extern "C" int flash_attention_bwd_dq_wgmma_live(const void* q, const void* k, const void* v,
                                                 const void* o, const void* dout,
                                                 const uint8_t* kvalid, const float* lse,
                                                 void* dq, float* delta, uint64_t* words,
                                                 int* live, int* prefix, int B, int Hq, int Hkv,
                                                 int S, int Tlen, int D, int causal,
                                                 int has_window, int window, float scale,
                                                 void* stream) {
  bwd::Args a{q, k, v, o, dout, dq, nullptr, nullptr, const_cast<float*>(lse), delta, B, Hq, Hkv,
              S, Tlen, causal, has_window, window, scale, kvalid};
  a.words = words;
  a.live = live;
  a.prefix = prefix;
  return wgb::launch_d<true, true>(D, a, false, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dkv_wgmma_live(const void* q, const void* k, const void* v,
                                                  const void* dout, const float* lse,
                                                  const float* delta, const uint64_t* words,
                                                  const int* prefix, void* dk, void* dv, int B,
                                                  int Hq, int Hkv, int S, int Tlen, int D,
                                                  int causal, int has_window, int window,
                                                  float scale, void* stream) {
  bwd::Args a{q, k, v, nullptr, dout, nullptr, dk, dv, const_cast<float*>(lse),
              const_cast<float*>(delta), B, Hq, Hkv, S, Tlen, causal, has_window, window, scale};
  a.words = const_cast<uint64_t*>(words);
  a.prefix = const_cast<int*>(prefix);
  return wgb::launch_d<true, true>(D, a, true, static_cast<cudaStream_t>(stream));
}
