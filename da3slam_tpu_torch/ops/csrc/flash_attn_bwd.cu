// Flash-attention backward (FlashAttention-2 style) for Hopper (sm_90a):
// two kernels, dq and dk/dv.
//
// Replaces the TPU kernels da3slam_tpu/ops/flash_attention.py:_bwd_dq_kernel
// and _bwd_dkv_kernel (reached through _flash_backward, the custom VJP of
// flash_attention under either forward: lse is the same quantity).
//
// Math (identical to the TPU kernels and to the plain versions in
// ops/flash_attention.py), base 2, with
//   q'_i  = round_to_T(q_i * log2(e)/sqrt(D))   (recomputed from q, as the forward rounds it)
//   s_ij  = q'_i . k_j  (f32),  p_ij = exp2(s_ij - lse_i)
//   dov_ij = dO_i . v_j (f32),  dz_ij = p_ij * (dov_ij - Delta_i),  Delta_i = dO_i . O_i
// the dq kernel computes   dq_i = (1/sqrt(D)) * sum_{j<S} round_to_T(dz_ij) k_j
// and the dk/dv kernel     dv_j = sum_{i<S} round_to_T(p_ij) dO_i
//                          dk_j = ln(2) * sum_{i<S} round_to_T(dz_ij) q'_i
// in f32 accumulators, written in T.  Keys j >= S drop out of dq and rows
// i >= S out of dk/dv by the loop bounds (the TPU got both from its NEG_INF
// bias lane and zero padding).
//
// Layout: q, k, v, dO, dq, dk, dv are [B, S, H, 64] contiguous (the model's
// layout); lse and Delta are [B*H, S] f32.  T is __nv_bfloat16 or float,
// picked by dtype alone; both run on the tensor cores (round_to_T is the
// identity in f32).
//
// What bounds it on an H100: work.  The two kernels each recompute s and
// dO.v^T, so the backward is 14*S^2*D FLOP per (b, h) (dq: 6, dk/dv: 8)
// against ~S*D*(7 tensors)*sizeof(T) bytes: compute-bound by orders of
// magnitude at every training and SLAM shape.  In bf16 the SLAM cross-view
// call (B=1, S=19515, H=6) is 0.89 + 1.18 ms of tensor-core time at 989
// TFLOP/s; beside it one exp2 per 384 (dq) or 512 (dk/dv) FLOP, half the
// forward's share.
//
// Design of the bf16 kernels (flash_bwd_dq_wgmma_kernel and
// flash_bwd_dkv_wgmma_kernel: one body, bwd_wgmma_body, since dk/dv is the
// transpose of dq; the building blocks are in flash_wgmma.cuh):
//   - A CTA owns 128 rows of one (b, h): q rows for dq, keys for dk/dv.  Their
//     two tensors (q' and dO, or K and V) arrive once by TMA into swizzled
//     shared memory and are the A operands of the score products.  Two
//     consumer warpgroups take 64 own rows each; one producer warp feeds a
//     64 KB ring with the other side's tiles (K and V, or q' and dO) through
//     TMA, a full/empty mbarrier pair a stage.  288 threads and no
//     setmaxnreg: ptxas grants such a kernel 168 registers a thread (it counts
//     whole warpgroups).  dq takes 64 keys a stage (four stages): S, dP and dq
//     are 3 x 32 accumulator registers.  dk/dv has two outputs, so with 64
//     rows a stage its accumulators alone are 128 registers and it spills;
//     it takes 32 q rows a stage (eight stages, m64n32k16 score products),
//     which costs shared-memory bandwidth instead: the 64 x 16 A slice is read
//     again for half as many columns.
//   - q' = round_bf16(q * log2(e)/sqrt(D)) is folded once by a pre-pass
//     (fold_q_kernel) into a bf16 scratch the wrapper allocates, with the
//     forward's own multiply and rounding, so that TMA can load it on either
//     side.  For dk/dv the pre-pass also lays lse and Delta out as (lse,
//     Delta) pairs in rows padded to whole tiles (pad_rows_kernel): [B*H, S]
//     rows start 4-byte aligned when S is odd, and the padded copy is what a
//     16-byte-aligned bulk copy can bring into the stage beside the tiles.
//   - Four products a tile, all wgmma.  S = own0.other0^T and dP =
//     own1.other1^T: m64nNk16 x 4 each (N the stage's rows), both operands
//     K-major in shared memory.  p = exp2(S - lse) and dz = p * (dP - Delta) are rounded to bf16
//     as A fragments in registers (the accumulator's layout is, 16 columns at
//     a time, the A-fragment layout) and multiply the SAME stage's tiles read
//     MN-major: dq += dz.K, or dv += p^T.dO and dk += dz^T.q'.  For dq, lse
//     and Delta are per accumulator row (two registers each); for dk/dv they
//     are per accumulator column, read from the stage's pairs.
//   - The products of tile j-1 run while the exp2 of tile j is taken: a
//     warpgroup starts S_j, dP_j and then the gradient products of tile j-1,
//     waits for the scores alone (wait_group 1) and writes tile j's fragments
//     to a second set of registers (the scores are only read: see
//     flash_attn_fwd.cu on ptxas and C7515).  The two sets take turns from one
//     tile to the next.  Copying the new set over the old at the end of a
//     step instead lets ptxas merge the two, and it then serializes every
//     wgmma of the kernel (C7513): 1.87 against 1.47 ms for dq.
//   - Ragged edges.  Rows past S arrive from TMA as zeros, so a padded row
//     multiplies nothing into a gradient; but its p = exp2(0 - lse) is not 0
//     and overflows where every logit of a row is below -128, and inf * 0 is
//     NaN.  So dq sets the scores of the last tile's columns >= S - k0 to
//     -inf before the exp2 (p = dz = 0), and the padded rows of dk/dv's pairs
//     carry lse = +inf (p = 0 exactly) and Delta = 0.  Own rows past S run on
//     zeros and are not stored.
//   - exp2 is ex2.approx.ftz, as in the forward.
// Measured (PERF.md, H100 at 700 W, the SLAM cross-view call): dq 1.48 ms, 590
// TFLOP/s, 60% of the tensor-core peak; dk/dv 2.60 ms, 450 TFLOP/s; from 31.7
// and 38.8 ms on the FMA pipes.  da3slam_tpu_torch/tools/flash_bwd_stages.py
// builds this file in changed copies (one fragment set, 64-row dk/dv tiles,
// no overlap, half the ring) and times them in turns.
// No atomics in either design: every output row is owned by one warpgroup
// thread quad, so the result is deterministic.
//
// The f32 kernels (flash_bwd_dq_tf32_kernel, flash_bwd_dkv_tf32_kernel: one
// body, bwd_tf32_body) take every product as error-compensated TF32 on wgmma
// (3xTF32, what CUTLASS's OpMultiplyAddFastF32 and so PyTorch's own f32
// attention backward do on mma.sync).  Each f32 operand x is split into
// hi = tf32_rna(x) and lo = tf32_rna(x - hi) (cvt.rna.tf32.f32), and a product
// is lo.hi + hi.lo + hi.hi in f32 accumulators, the small terms first: ~21
// bits where one TF32 product keeps ~11, whose error in s (2^-11 |q'||k|)
// would move p by ~0.4%.  TF32 flags (torch.backends) do not govern it.  What
// bounds it: 3 x 14*S^2*D FLOP at 495 TFLOP/s (train cross, (1, 5204, 6, 64):
// dq 0.378, dk/dv 0.504 ms, against 0.931 and 1.242 on the f32 FMA pipes).
//   - TF32 wgmma reads both shared-memory operands K-major only (no transpose
//     bit below 16 bits), so the gradient products' B operands are laid out
//     with the summed dimension contiguous: a pre-pass (split_tf32_kernel in
//     flash_tf32.cuh, shared with the f32 forwards) writes, per input
//     tensor, its split copy [bh][hi/lo][half][S_pad][32] (q' folded in, rows
//     padded with zeros to S_pad = ceil(S/64)*64) and, where a gradient
//     product needs it, the transposed split copy
//     [bh][hi/lo][64][S_pad]: Kᵀ for dq, q'ᵀ and dOᵀ for dk/dv.  An f32 row
//     of 64 is two 128-byte swizzle rows, so a tile is two [rows, 32] halves
//     of the head dim; a k8 step is 32 bytes, four a swizzle row, and step 4
//     starts on the second half (no leading byte offset is used).
//   - The A fragments of the gradient products (p and dz, split in registers)
//     come from the score accumulators with no shuffle.  The accumulator
//     holds columns 2t, 2t+1 of each 8 (t = lane % 4), the TF32 A fragment
//     takes inner indices t and t+4: so the transposed copies permute the
//     summed index inside each group of 8 (position p holds row
//     tf32_row_at(p)), which pairs each fragment value with its row.
//   - A CTA owns 64 rows (one consumer warpgroup; 160 threads, so ptxas may
//     grant 255 registers) and streams the other side 32 rows a stage.  The
//     own side, both tensors split, is 64 KB; a stage is 48 KB for dq (K and V
//     split, Kᵀ split) and 64 KB for dk/dv: 64 own rows and two stages fit in
//     227 KB, 128 rows do not.  A stage's natural tiles are free once tile
//     t's scores are, its transposed tiles only after tile t's gradient
//     products (which run beside tile t+1's scores): two rings of two stages,
//     with their own full/empty barriers, so that each load has a whole tile
//     step to land.
//   - The rest is the bf16 design: tile t's scores and tile t-1's gradient
//     products start together and the exp2 of tile t runs while the latter
//     finish; the fragments are split while no wgmma is in flight.  (Starting
//     tile t+1's scores before that split, to keep the tensor cores' queue
//     full, bought nothing and took dk/dv to 255 registers.)  dq masks
//     the last tile's padded keys to -inf, dk/dv's padded (lse, Delta) pairs
//     carry (+inf, 0); own rows past S are not stored.
//   - The tensor cores' f32 sum truncates each addition: over the S/8 x 3
//     additions of a gradient the bias reached 6e-5 of max|g| at S = 5204.
//     So the gradient products restart their accumulators every
//     kPromoteTiles tiles and each block is added, rounded to nearest, into
//     f32 sums in shared memory (3e-6; 2-3% of the time).
// Measured (PERF.md, H100 at 700 W, train cross): dq 0.921 ms, dk/dv 1.198,
// together ahead of the library's backward (3.38), from 2.581 + 2.639 on the
// FMA pipes (a thread pair a row; that design is gone).
// da3slam_tpu_torch/tools/flash_bwd_stages.py times changed copies (one TF32
// product, half the rings, no overlap, no promotion).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/flash_attention.py).

#include "flash_common.cuh"
#include "flash_tf32.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA ring
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int kWgRows = 64;  // own rows per consumer warpgroup (wgmma's M)
constexpr int kWgThreads = 128;
constexpr int kConsumers = 2;
constexpr int kOwnRows = kWgRows * kConsumers;
constexpr int kWgmmaThreads = kWgThreads * kConsumers + 32;  // + the producer warp
constexpr int kOwnBytes = kOwnRows * kRowBytes;              // one own tensor's tile: 16 KB
constexpr int kRingBytes = 65536;
constexpr int kPairTile = 64;  // the padded (lse, Delta) rows are whole multiples of this

// What differs between the two kernels.  kN: rows of the other side per ring
// stage (wgmma's N for the scores and the gradient products' inner dimension).
// dk/dv holds two output accumulators of 32 registers where dq holds one, so
// it takes the other side 32 rows at a time: with 64, scores and fragments
// need 96 more and ptxas, which grants a kernel of 288 threads 168, spills.
template <bool kDkv>
struct Tile {
  static constexpr int kN = kDkv ? 32 : 64;
  static constexpr int kTileBytes = kN * kRowBytes;  // one streamed tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 4 of 16 KB, 8 of 8 KB
  static constexpr int kPairBytes = kN * 8;                 // a stage's (lse, Delta) pairs
  // the own tiles, the ring, the pairs, a full and an empty barrier per stage
  // and the own tiles' barrier; 1024 more to align the tiles
  static constexpr int kSmemBytes =
      kGroupBytes + 2 * kOwnBytes + kRingBytes + kStages * kPairBytes + (2 * kStages + 1) * 8;
  static_assert(kStages >= 2, "a consumer holds tile j-1's stage while it waits for tile j's");
  static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
  static_assert(kPairTile % kN == 0, "a tile's pairs lie inside the padded row");
};

constexpr int kFoldThreads = 256;

// qs = round_bf16(q * scale), 8 elements a thread: the forward's fold, bit for bit
__global__ void __launch_bounds__(kFoldThreads)
fold_q_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ qs, size_t n_chunks,
              float scale) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (i >= n_chunks) return;
  float x[8];
  Vec16<__nv_bfloat16>::load(q + 8 * i, x);
  uint4 w;
  w.x = pack_bf16(x[0] * scale, x[1] * scale);
  w.y = pack_bf16(x[2] * scale, x[3] * scale);
  w.z = pack_bf16(x[4] * scale, x[5] * scale);
  w.w = pack_bf16(x[6] * scale, x[7] * scale);
  *reinterpret_cast<uint4*>(qs + 8 * i) = w;
}

// pairs[bh, i] = (lse, Delta)[bh, i] for i < S, (+inf, 0) for S <= i < S_pad
__global__ void __launch_bounds__(kFoldThreads)
pad_rows_kernel(const float* __restrict__ lse, const float* __restrict__ delta,
                float2* __restrict__ pairs, int S, int S_pad) {
  const int i = blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= S_pad) return;
  const size_t bh = blockIdx.y;
  const bool in = i < S;
  pairs[bh * S_pad + i] =
      make_float2(in ? lse[bh * S + i] : INFINITY, in ? delta[bh * S + i] : 0.f);
}

// One streamed tile's p and dz on a thread's 2 x kN/2 accumulator values (rows
// r = 0, 1: t/4 and + 8; x[4j + 2r + {0, 1}] at columns 8j + c2 + {0, 1}), as
// the A fragments of the gradient products.  dq (kDkv false): lse and Delta
// belong to the thread's two rows, and columns >= n_valid (keys past S) get p
// = dz = 0.  dk/dv: they belong to the columns and come from the stage's
// pairs, whose padded entries give p = 0.  s and dp are only read: a wgmma may
// be in flight.
template <bool kDkv, int kN = Tile<kDkv>::kN>
__device__ __forceinline__ void gradient_terms(const float (&s)[kN / 2], const float (&dp)[kN / 2],
                                               uint32_t (&pf)[kN / 4], uint32_t (&dzf)[kN / 4],
                                               const float (&lse_r)[2], const float (&delta_r)[2],
                                               const float4* pairs, int n_valid, int c2) {
  const bool ragged = !kDkv && n_valid < kN;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    float lse_c[2] = {0.f, 0.f}, delta_c[2] = {0.f, 0.f};
    if constexpr (kDkv) {
      const float4 x = pairs[(8 * j + c2) >> 1];  // columns 8j + c2 and + 1
      lse_c[0] = x.x;
      delta_c[0] = x.y;
      lse_c[1] = x.z;
      delta_c[1] = x.w;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p[2], dz[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * r + e;
        const float sc = ragged && 8 * j + c2 + e >= n_valid ? -INFINITY : s[idx];
        p[e] = ex2(sc - (kDkv ? lse_c[e] : lse_r[r]));
        dz[e] = p[e] * (dp[idx] - (kDkv ? delta_c[e] : delta_r[r]));
      }
      const int slot = 4 * (j >> 1) + 2 * (j & 1) + r;
      if constexpr (kDkv) pf[slot] = pack_bf16(p[0], p[1]);
      dzf[slot] = pack_bf16(dz[0], dz[1]);
    }
  }
}

__device__ __forceinline__ void score_wgmma(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  wgmma_m64n64k16_ss(d, a, b, acc);
}
__device__ __forceinline__ void score_wgmma(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  wgmma_m64n32k16_ss(d, a, b, acc);
}

// s = own0.other0^T and dp = own1.other1^T: the warpgroup's 64 own rows
// against the stage at `stage_addr` (other0's tile of kN rows, then other1's)
template <int kHalfN>
__device__ __forceinline__ void start_score_products(float (&s)[kHalfN], float (&dp)[kHalfN],
                                                     uint64_t own0_desc, uint64_t own1_desc,
                                                     uint32_t stage_addr) {
  const uint64_t b0 = tile_desc(stage_addr);
  const uint64_t b1 = tile_desc(stage_addr + 2 * kHalfN * kRowBytes);
#pragma unroll
  for (int i = 0; i < kHeadDim / 16; ++i) {
    score_wgmma(s, own0_desc + i * kDescKMajorStep, b0 + i * kDescKMajorStep, i != 0);
  }
#pragma unroll
  for (int i = 0; i < kHeadDim / 16; ++i) {
    score_wgmma(dp, own1_desc + i * kDescKMajorStep, b1 + i * kDescKMajorStep, i != 0);
  }
  wgmma_commit();
}

// acc0 += dz.other0 and, for dk/dv, acc1 += p.other1: the fragments against
// the stage's tiles read MN-major
template <bool kDkv, int kN = Tile<kDkv>::kN>
__device__ __forceinline__ void start_gradient_products(float (&acc0)[32], float (&acc1)[32],
                                                        const uint32_t (&dzf)[kN / 4],
                                                        const uint32_t (&pf)[kN / 4],
                                                        uint32_t stage_addr) {
  const uint64_t b0 = tile_desc(stage_addr);
#pragma unroll
  for (int i = 0; i < kN / 16; ++i) {
    wgmma_m64n64k16_rs(acc0, dzf + 4 * i, b0 + i * kDescMnMajorStep);
  }
  if constexpr (kDkv) {
    const uint64_t b1 = tile_desc(stage_addr + Tile<kDkv>::kTileBytes);
#pragma unroll
    for (int i = 0; i < kN / 16; ++i) {
      wgmma_m64n64k16_rs(acc1, pf + 4 * i, b1 + i * kDescMnMajorStep);
    }
  }
  wgmma_commit();
}

// rows row_lo and + 8 of a warpgroup's 64 x 64 accumulator, scaled, as bf16
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[32], float scale,
                                           size_t head_base, size_t row_stride, int row0, int S,
                                           int c2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + head_base + static_cast<size_t>(row) * row_stride + c2;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// dq (kDkv false): own = (q', dO) rows, other = (K, V) tiles, out0 = dq.
// dk/dv (kDkv true): own = (K, V) rows, other = (q', dO) tiles with their
// (lse, Delta) pairs, out0 = dk, out1 = dv.
template <bool kDkv>
__device__ __forceinline__ void bwd_wgmma_body(const CUtensorMap* own0_map,
                                               const CUtensorMap* own1_map,
                                               const CUtensorMap* other0_map,
                                               const CUtensorMap* other1_map,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               const float2* __restrict__ pairs,
                                               __nv_bfloat16* __restrict__ out0,
                                               __nv_bfloat16* __restrict__ out1, int S, int H,
                                               float scale0) {
  using T = Tile<kDkv>;
  constexpr int kN = T::kN;
  constexpr int kStages = T::kStages;
  constexpr int kStageBytes = T::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  // the tiles start on a 1024-byte boundary of the shared address space
  uint8_t* smem = smem_raw + ((kGroupBytes - (smem_addr(smem_raw) & (kGroupBytes - 1))) &
                              (kGroupBytes - 1));
  const uint32_t own = smem_addr(smem);
  const uint32_t ring = own + 2 * kOwnBytes;
  const uint8_t* pair_ring = smem + 2 * kOwnBytes + kRingBytes;
  const uint32_t full_bar = smem_addr(pair_ring + kStages * T::kPairBytes);
  const uint32_t empty_bar = full_bar + kStages * 8;
  const uint32_t own_bar = empty_bar + kStages * 8;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_tiles = (S + kN - 1) / kN;
  const int own_row0 = blockIdx.x * kOwnRows;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + st * 8, 1);                // the producer's arrive.expect_tx
      mbar_init(empty_bar + st * 8, 4 * kConsumers);  // one arrival a consumer warp
    }
    mbar_init(own_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == kConsumers) {
    // ---- producer: one thread loads the own tiles and keeps the ring full ----
    if (threadIdx.x != kConsumers * kWgThreads) return;
    mbar_arrive_expect_tx(own_bar, 2 * kOwnBytes);
    tma_load_4d(own, own0_map, own_bar, 0, h, own_row0, b);
    tma_load_4d(own + kOwnBytes, own1_map, own_bar, 0, h, own_row0, b);
    // this head's padded row of pairs
    const size_t pair_row = static_cast<size_t>(bh) * ((S + kPairTile - 1) / kPairTile) * kPairTile;
    int stage = 0;
    uint32_t parity = 1;  // of the release that frees a stage: none needed in round 0
    for (int t = 0; t < n_tiles; ++t) {
      if (t >= kStages) mbar_wait(empty_bar + stage * 8, parity);
      const uint32_t bar = full_bar + stage * 8;
      const uint32_t dst = ring + stage * kStageBytes;
      mbar_arrive_expect_tx(bar, kStageBytes + (kDkv ? T::kPairBytes : 0));
      tma_load_4d(dst, other0_map, bar, 0, h, t * kN, b);
      tma_load_4d(dst + T::kTileBytes, other1_map, bar, 0, h, t * kN, b);
      if constexpr (kDkv) {
        bulk_load_1d(smem_addr(pair_ring + stage * T::kPairBytes), pairs + pair_row + t * kN,
                     T::kPairBytes, bar);
      }
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    return;
  }

  // ---- consumers: 64 own rows a warpgroup ----
  const int tw = threadIdx.x % kWgThreads;
  const int lane = tw & 31;
  const int c2 = (lane & 3) * 2;
  const int row_lo = own_row0 + wg * kWgRows + 16 * (tw >> 5) + (lane >> 2);  // and + 8

  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if constexpr (!kDkv) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row_lo + 8 * r < S) {
        lse_r[r] = lse[static_cast<size_t>(bh) * S + row_lo + 8 * r];
        delta_r[r] = delta[static_cast<size_t>(bh) * S + row_lo + 8 * r];
      }
    }
  }
  auto stage_pairs = [&](int stage) {
    return reinterpret_cast<const float4*>(pair_ring + stage * T::kPairBytes);
  };

  // acc1 and the p fragments (dv and the rounded p) are dk/dv's alone.  Two
  // sets of fragments, a and b, take turns: the set being written while the
  // other feeds the products in flight must be other registers, and a copy
  // from one to the other at the end of a step lets ptxas merge them and
  // then serialize the wgmmas (C7513).
  float s[kN / 2], dp[kN / 2], acc0[32], acc1[32];
  uint32_t pf_a[kN / 4], dzf_a[kN / 4], pf_b[kN / 4], dzf_b[kN / 4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kN / 4; ++i) pf_a[i] = pf_b[i] = 0u;
  auto pin_gradients = [&](uint32_t (&dzf)[kN / 4], uint32_t (&pf)[kN / 4]) {
    pin(acc0);
    pin(dzf);
    if constexpr (kDkv) {
      pin(acc1);
      pin(pf);
    }
  };

  const uint64_t own0_desc = tile_desc(own + wg * kWgRows * kRowBytes);
  const uint64_t own1_desc = tile_desc(own + kOwnBytes + wg * kWgRows * kRowBytes);

  mbar_wait(own_bar, 0);
  mbar_wait(full_bar, 0);
  wgmma_fence();
  start_score_products(s, dp, own0_desc, own1_desc, ring);
  wgmma_wait<0>();
  pin(s);
  pin(dp);
  gradient_terms<kDkv>(s, dp, pf_a, dzf_a, lse_r, delta_r, stage_pairs(0), S, c2);

  int prev = 0;  // the stage whose tiles the pending fragments belong to
  uint32_t parity = 0;
  // tile t: its scores and the gradient products of tile t-1 (fragments
  // `*_in`) start together; tile t's fragments go to `*_out`
  auto tile_step = [&](int t, uint32_t (&dz_in)[kN / 4], uint32_t (&p_in)[kN / 4],
                       uint32_t (&dz_out)[kN / 4], uint32_t (&p_out)[kN / 4]) {
    int stage = prev + 1;
    if (stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
    mbar_wait(full_bar + stage * 8, parity);
    pin(s);
    pin(dp);
    pin_gradients(dz_in, p_in);
    wgmma_fence();
    start_score_products(s, dp, own0_desc, own1_desc, ring + stage * kStageBytes);
    start_gradient_products<kDkv>(acc0, acc1, dz_in, p_in, ring + prev * kStageBytes);
    // the scores are ready while the gradient products still run: the exp2 overlap them
    wgmma_wait<1>();
    pin(s);
    pin(dp);
    gradient_terms<kDkv>(s, dp, p_out, dz_out, lse_r, delta_r, stage_pairs(stage), S - t * kN,
                         c2);
    wgmma_wait<0>();
    pin_gradients(dz_in, p_in);
    if (lane == 0) mbar_arrive(empty_bar + prev * 8);  // tile t-1's stage is consumed
    prev = stage;
  };
  int t = 1;
#pragma unroll 1
  for (; t + 1 < n_tiles; t += 2) {
    tile_step(t, dzf_a, pf_a, dzf_b, pf_b);
    tile_step(t + 1, dzf_b, pf_b, dzf_a, pf_a);
  }
  if (t < n_tiles) {
    tile_step(t, dzf_a, pf_a, dzf_b, pf_b);
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      dzf_a[i] = dzf_b[i];
      if constexpr (kDkv) pf_a[i] = pf_b[i];
    }
  }
  pin_gradients(dzf_a, pf_a);
  wgmma_fence();
  start_gradient_products<kDkv>(acc0, acc1, dzf_a, pf_a, ring + prev * kStageBytes);
  wgmma_wait<0>();
  pin_gradients(dzf_a, pf_a);

  const size_t row_stride = static_cast<size_t>(H) * kHeadDim;
  const size_t head_base =
      static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kHeadDim;
  store_rows(out0, acc0, scale0, head_base, row_stride, row_lo, S, c2);
  if constexpr (kDkv) store_rows(out1, acc1, 1.f, head_base, row_stride, row_lo, S, c2);
}

__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qs_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int S, int H, float scale_dq) {
  bwd_wgmma_body<false>(&qs_map, &do_map, &k_map, &v_map, lse, delta, nullptr, dq, nullptr, S, H,
                        scale_dq);
}

__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap qs_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float2* __restrict__ pairs, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int S, int H, float scale_dk) {
  bwd_wgmma_body<true>(&k_map, &v_map, &qs_map, &do_map, nullptr, nullptr, pairs, dk, dv, S, H,
                       scale_dk);
}

cudaError_t launch_fold_q(const void* q, void* qs, int B, int S, int H, float scale_qk,
                          cudaStream_t stream) {
  const size_t n_chunks = static_cast<size_t>(B) * S * H * (kHeadDim / 8);
  const unsigned blocks = static_cast<unsigned>((n_chunks + kFoldThreads - 1) / kFoldThreads);
  fold_q_kernel<<<blocks, kFoldThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(q),
                                                     static_cast<__nv_bfloat16*>(qs), n_chunks,
                                                     scale_qk);
  return cudaGetLastError();
}

// the four tensor maps: the own side in boxes of 128 rows, the other in `tile_rows`
cudaError_t make_maps(CUtensorMap (&maps)[4], const void* own0, const void* own1,
                      const void* other0, const void* other1, int B, int S, int H,
                      int tile_rows) {
  cudaError_t err = make_head_tile_map(&maps[0], own0, B, S, H, kOwnRows);
  if (err == cudaSuccess) err = make_head_tile_map(&maps[1], own1, B, S, H, kOwnRows);
  if (err == cudaSuccess) err = make_head_tile_map(&maps[2], other0, B, S, H, tile_rows);
  if (err == cudaSuccess) err = make_head_tile_map(&maps[3], other1, B, S, H, tile_rows);
  return err;
}

cudaError_t launch_dq_wgmma(const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, const void* qs, int B, int S, int H,
                            float scale_dq, cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err = make_maps(maps, qs, dout, k, v, B, S, H, Tile<false>::kN);
  // above 48 KB the dynamic shared memory has to be asked for; per device, so per launch
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<false>::kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kOwnRows - 1) / kOwnRows, B * H);
  flash_bwd_dq_wgmma_kernel<<<grid, kWgmmaThreads, Tile<false>::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), S, H, scale_dq);
  return cudaGetLastError();
}

cudaError_t launch_dkv_wgmma(const void* k, const void* v, const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, const void* qs, void* pairs,
                             int B, int S, int H, float scale_dk, cudaStream_t stream) {
  const int S_pad = (S + kPairTile - 1) / kPairTile * kPairTile;
  pad_rows_kernel<<<dim3((S_pad + kFoldThreads - 1) / kFoldThreads, B * H), kFoldThreads, 0,
                    stream>>>(static_cast<const float*>(lse), static_cast<const float*>(delta),
                              static_cast<float2*>(pairs), S, S_pad);
  cudaError_t err = cudaGetLastError();
  CUtensorMap maps[4];
  if (err == cudaSuccess) err = make_maps(maps, k, v, qs, dout, B, S, H, Tile<true>::kN);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<true>::kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kOwnRows - 1) / kOwnRows, B * H);
  flash_bwd_dkv_wgmma_kernel<<<grid, kWgmmaThreads, Tile<true>::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float2*>(pairs),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H, scale_dk);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on wgmma, TMA rings of split and transposed copies
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;                     // own rows a CTA: one consumer warpgroup
constexpr int kF32N = 32;                        // rows of the other side a ring stage
constexpr int kF32Threads = kWgThreads + 32;     // + the producer warp
constexpr int kTf32Terms = 3;                    // lo·hi, hi·lo, hi·hi (the last kTf32Terms of them)
constexpr int kPromoteTiles = 8;                 // gradient tiles summed on the tensor cores at a time
constexpr int kF32OwnBytes = 4 * kF32Rows * kRowBytes;  // [hi/lo][half][64 rows][32 f32]: 32 KB
constexpr int kF32NatBytes = 4 * kF32N * kRowBytes;     // [hi/lo][half][32 rows][32 f32]: 16 KB
constexpr int kF32TrBytes = 2 * kHeadDim * kRowBytes;   // [hi/lo][64 dims][32 rows]: 16 KB
static_assert(kF32Rows == kPairTile && kF32Rows == kTf32Pad,
              "S is padded to whole own tiles, the pairs' and the split copies' padding");

// What differs between the two kernels: dk/dv streams two transposed tiles a
// stage (q'ᵀ and dOᵀ) and the (lse, Δ) pairs, dq one (Kᵀ).
template <bool kDkv>
struct F32Tile {
  static constexpr int kStages = 2;  // of each ring
  static constexpr int kTr = kDkv ? 2 : 1;
  static constexpr int kNatStage = 2 * kF32NatBytes;
  static constexpr int kTrStage = kTr * kF32TrBytes;
  static constexpr int kPairBytes = kDkv ? kF32N * 8 : 0;
  static constexpr int kOutputs = kDkv ? 2 : 1;
  static constexpr int kSumBytes = kOutputs * 32 * kWgThreads * 4;  // the promoted sums
  // own tiles, the natural ring, the transposed ring, the pairs, the
  // promoted sums, four barriers a stage and the own tiles' one; 1024 more
  // to align the tiles
  static constexpr int kSmemBytes = kGroupBytes + 2 * kF32OwnBytes +
                                    kStages * (kNatStage + kTrStage + kPairBytes) + kSumBytes +
                                    (4 * kStages + 1) * 8;
  static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
};

// s = own0·other0ᵀ and dp = own1·other1ᵀ in 3xTF32: the warpgroup's 64 own
// rows against the stage's kF32N rows (at `nat`: other0's split tile, then
// other1's).  The small terms first, hi·hi last, as CUTLASS's FastF32 does.
__device__ __forceinline__ void start_tf32_scores(float (&s)[16], float (&dp)[16], uint32_t own0,
                                                  uint32_t own1, uint32_t nat) {
#pragma unroll
  for (int term = 3 - kTf32Terms; term < 3; ++term) {
#pragma unroll
    for (int i = 0; i < kHeadDim / 8; ++i) {
      wgmma_m64n32k8_tf32_ss(s, nat_desc(own0, kF32Rows, term == 0, i),
                             nat_desc(nat, kF32N, term == 1, i), term != 3 - kTf32Terms || i != 0);
    }
  }
#pragma unroll
  for (int term = 3 - kTf32Terms; term < 3; ++term) {
#pragma unroll
    for (int i = 0; i < kHeadDim / 8; ++i) {
      wgmma_m64n32k8_tf32_ss(dp, nat_desc(own1, kF32Rows, term == 0, i),
                             nat_desc(nat + kF32NatBytes, kF32N, term == 1, i),
                             term != 3 - kTf32Terms || i != 0);
    }
  }
  wgmma_commit();
}

// acc0 += dz·tr0 and, for dk/dv, acc1 += p·tr1 in 3xTF32: the split
// fragments against the stage's transposed tiles (at `tr`).  fresh: the
// products start a new block of kPromoteTiles tiles (acc = the products).
template <bool kDkv>
__device__ __forceinline__ void start_tf32_gradients(float (&acc0)[32], float (&acc1)[32],
                                                     const uint32_t (&dz_hi)[16],
                                                     const uint32_t (&dz_lo)[16],
                                                     const uint32_t (&p_hi)[16],
                                                     const uint32_t (&p_lo)[16], uint32_t tr,
                                                     bool fresh) {
#pragma unroll
  for (int term = 3 - kTf32Terms; term < 3; ++term) {
#pragma unroll
    for (int j = 0; j < kF32N / 8; ++j) {
      const int accumulate = !fresh || term != 3 - kTf32Terms || j != 0;
      wgmma_m64n64k8_tf32_rs(acc0, (term == 0 ? dz_lo : dz_hi) + 4 * j, tr_desc(tr, term == 1, j),
                             accumulate);
      if constexpr (kDkv) {
        wgmma_m64n64k8_tf32_rs(acc1, (term == 0 ? p_lo : p_hi) + 4 * j,
                               tr_desc(tr + kF32TrBytes, term == 1, j), accumulate);
      }
    }
  }
  wgmma_commit();
}

// One streamed tile's p and dz from a thread's 2 x 16 score values, in the
// accumulator's order (x[4j + 2r + {0, 1}]: row t/4 + 8r, columns 8j + c2 +
// {0, 1}); lse and Δ as in gradient_terms.  s and dp are only read.
template <bool kDkv>
__device__ __forceinline__ void tf32_terms(const float (&s)[16], const float (&dp)[16],
                                           float (&p)[16], float (&dz)[16],
                                           const float (&lse_r)[2], const float (&delta_r)[2],
                                           const float4* pairs, int n_valid, int c2) {
  const bool ragged = !kDkv && n_valid < kF32N;
#pragma unroll
  for (int j = 0; j < kF32N / 8; ++j) {
    float lse_c[2] = {0.f, 0.f}, delta_c[2] = {0.f, 0.f};
    if constexpr (kDkv) {
      const float4 x = pairs[(8 * j + c2) >> 1];  // columns 8j + c2 and + 1
      lse_c[0] = x.x;
      delta_c[0] = x.y;
      lse_c[1] = x.z;
      delta_c[1] = x.w;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * r + e;
        const float sc = ragged && 8 * j + c2 + e >= n_valid ? -INFINITY : s[idx];
        const float pe = ex2(sc - (kDkv ? lse_c[e] : lse_r[r]));
        dz[idx] = pe * (dp[idx] - (kDkv ? delta_c[e] : delta_r[r]));
        if constexpr (kDkv) p[idx] = pe;
      }
    }
  }
}

// sum[i] += acc[i], this thread's 32 promoted sums (sum[i * kWgThreads])
__device__ __forceinline__ void promote(float* sum, const float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i * kWgThreads] += acc[i];
}

// rows row_lo and + 8 of the warpgroup's 64 x 64 output, sum + acc, scaled,
// as f32
__device__ __forceinline__ void store_rows_f32(float* out, const float (&acc)[32],
                                               const float* sum, float scale, size_t head_base,
                                               size_t row_stride, int row0, int S, int c2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    float* orow = out + head_base + static_cast<size_t>(row) * row_stride + c2;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2((sum[i * kWgThreads] + acc[i]) * scale,
                      (sum[(i + 1) * kWgThreads] + acc[i + 1]) * scale);
    }
  }
}

// dq (kDkv false): own = (q', dO), other = (K, V), tr0 = Kᵀ, out0 = dq.
// dk/dv (kDkv true): own = (K, V), other = (q', dO) with their (lse, Δ)
// pairs, tr0 = q'ᵀ, tr1 = dOᵀ, out0 = dk, out1 = dv.  Every map is over a
// split copy the pre-pass wrote (rows padded to S_pad with zeros).
template <bool kDkv>
__device__ __forceinline__ void bwd_tf32_body(
    const CUtensorMap* own0_map, const CUtensorMap* own1_map, const CUtensorMap* other0_map,
    const CUtensorMap* other1_map, const CUtensorMap* tr0_map, const CUtensorMap* tr1_map,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float2* __restrict__ pairs, float* __restrict__ out0, float* __restrict__ out1, int S,
    int H, float scale0) {
  using T = F32Tile<kDkv>;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kGroupBytes - (smem_addr(smem_raw) & (kGroupBytes - 1))) &
                              (kGroupBytes - 1));
  const uint32_t own = smem_addr(smem);
  const uint32_t nat_ring = own + 2 * kF32OwnBytes;
  const uint32_t tr_ring = nat_ring + kStages * T::kNatStage;
  const uint8_t* pair_ring = smem + 2 * kF32OwnBytes + kStages * (T::kNatStage + T::kTrStage);
  // The gradients' sums, f32 in shared memory, [output][i][thread]: the
  // tensor cores' f32 sum truncates each addition, an error that grows with
  // the number of additions (~S/8 of them a gradient, 6e-5 of max|g| at S =
  // 5204), so they add kPromoteTiles tiles at a time into the accumulators,
  // and each block is then added here, rounded to nearest.
  float* sums = reinterpret_cast<float*>(
      const_cast<uint8_t*>(pair_ring) + kStages * T::kPairBytes);
  // per stage: the natural tiles' full and empty barriers, the transposed
  // tiles' full and empty barriers; then the own tiles' barrier
  const uint32_t bars = smem_addr(pair_ring + kStages * T::kPairBytes + T::kSumBytes);
  auto full_nat = [&](int st) { return bars + st * 32; };
  auto empty_nat = [&](int st) { return bars + st * 32 + 8; };
  auto full_tr = [&](int st) { return bars + st * 32 + 16; };
  auto empty_tr = [&](int st) { return bars + st * 32 + 24; };
  const uint32_t own_bar = bars + kStages * 32;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_tiles = (S + kF32N - 1) / kF32N;
  const int own_row0 = blockIdx.x * kF32Rows;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_nat(st), 1);   // the producer's arrive.expect_tx
      mbar_init(empty_nat(st), 4);  // one arrival a consumer warp
      mbar_init(full_tr(st), 1);
      mbar_init(empty_tr(st), 4);
    }
    mbar_init(own_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kWgThreads) {
    // ---- producer: one thread loads the own tiles and keeps both rings full.
    // A stage's natural tiles are done with once tile t's scores are, its
    // transposed ones only after tile t's gradient products, which run beside
    // tile t+1's scores: two rings, so that neither waits for the other.
    if (threadIdx.x != kWgThreads) return;
    mbar_arrive_expect_tx(own_bar, 2 * kF32OwnBytes);
    tma_load_4d(own, own0_map, own_bar, 0, own_row0, 0, bh);
    tma_load_4d(own + kF32OwnBytes, own1_map, own_bar, 0, own_row0, 0, bh);
    const size_t pair_row = static_cast<size_t>(bh) * ((S + kPairTile - 1) / kPairTile) * kPairTile;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const uint32_t freed = ((t / kStages) - 1) & 1;  // the release of tile t - kStages
      if (t >= kStages) mbar_wait(empty_nat(st), freed);
      const uint32_t nat = nat_ring + st * T::kNatStage;
      mbar_arrive_expect_tx(full_nat(st), T::kNatStage + T::kPairBytes);
      tma_load_4d(nat, other0_map, full_nat(st), 0, t * kF32N, 0, bh);
      tma_load_4d(nat + kF32NatBytes, other1_map, full_nat(st), 0, t * kF32N, 0, bh);
      if constexpr (kDkv) {
        bulk_load_1d(smem_addr(pair_ring + st * T::kPairBytes), pairs + pair_row + t * kF32N,
                     T::kPairBytes, full_nat(st));
      }
      if (t >= kStages) mbar_wait(empty_tr(st), freed);
      const uint32_t tr = tr_ring + st * T::kTrStage;
      mbar_arrive_expect_tx(full_tr(st), T::kTrStage);
      tma_load_4d(tr, tr0_map, full_tr(st), t * kF32N, 0, 0, bh);
      if constexpr (kDkv) tma_load_4d(tr + kF32TrBytes, tr1_map, full_tr(st), t * kF32N, 0, 0, bh);
    }
    return;
  }

  // ---- the consumer warpgroup: 64 own rows ----
  const int tw = threadIdx.x;
  const int lane = tw & 31;
  const int c2 = (lane & 3) * 2;
  const int row_lo = own_row0 + 16 * (tw >> 5) + (lane >> 2);  // and + 8

  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if constexpr (!kDkv) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row_lo + 8 * r < S) {
        lse_r[r] = lse[static_cast<size_t>(bh) * S + row_lo + 8 * r];
        delta_r[r] = delta[static_cast<size_t>(bh) * S + row_lo + 8 * r];
      }
    }
  }
  auto stage_pairs = [&](int st) {
    return reinterpret_cast<const float4*>(pair_ring + st * T::kPairBytes);
  };

  // p, dz: the last tile's terms, in f32 (p is dk/dv's alone).  They are split
  // into the fragments while no wgmma is in flight, and the fragments then
  // stay untouched until the gradient products that read them have finished.
  float s[16], dp[16], acc0[32], acc1[32], p[16], dz[16];
  uint32_t dz_hi[16], dz_lo[16], p_hi[16], p_lo[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    p[i] = 0.f;
    p_hi[i] = p_lo[i] = 0u;
  }
  auto pin_gradients = [&] {
    pin(acc0);
    pin(dz_hi);
    pin(dz_lo);
    if constexpr (kDkv) {
      pin(acc1);
      pin(p_hi);
      pin(p_lo);
    }
  };
  // tile t_prev's fragments, ready to be multiplied into the gradients
  auto split_prev = [&](int t_prev) {
    split_fragments(dz, dz_hi, dz_lo);
    if constexpr (kDkv) split_fragments(p, p_hi, p_lo);
    mbar_wait(full_tr(t_prev % kStages), (t_prev / kStages) & 1);
    pin_gradients();
  };
  const uint32_t own1 = own + kF32OwnBytes;
  float* sum0 = sums + tw;
  float* sum1 = sums + 32 * kWgThreads + tw;
#pragma unroll
  for (int i = 0; i < 32 * T::kOutputs; ++i) sum0[i * kWgThreads] = 0.f;

  mbar_wait(own_bar, 0);
  mbar_wait(full_nat(0), 0);
  wgmma_fence();
  start_tf32_scores(s, dp, own, own1, nat_ring);
  wgmma_wait<0>();
  pin(s);
  pin(dp);
  tf32_terms<kDkv>(s, dp, p, dz, lse_r, delta_r, stage_pairs(0), S, c2);
  if (lane == 0) mbar_arrive(empty_nat(0));

#pragma unroll 1
  for (int t = 1; t < n_tiles; ++t) {
    // tile t's scores and tile t-1's gradient products start together
    const int st = t % kStages;
    const int prev = (t - 1) % kStages;
    split_prev(t - 1);
    mbar_wait(full_nat(st), (t / kStages) & 1);
    pin(s);
    pin(dp);
    wgmma_fence();
    start_tf32_scores(s, dp, own, own1, nat_ring + st * T::kNatStage);
    start_tf32_gradients<kDkv>(acc0, acc1, dz_hi, dz_lo, p_hi, p_lo, tr_ring + prev * T::kTrStage,
                               (t - 1) % kPromoteTiles == 0);
    wgmma_wait<1>();  // tile t's scores: their exp2 runs beside the gradient products
    pin(s);
    pin(dp);
    tf32_terms<kDkv>(s, dp, p, dz, lse_r, delta_r, stage_pairs(st), S - t * kF32N, c2);
    if (lane == 0) mbar_arrive(empty_nat(st));
    wgmma_wait<0>();
    pin_gradients();
    if (lane == 0) mbar_arrive(empty_tr(prev));
    if ((t - 1) % kPromoteTiles == kPromoteTiles - 1) {
      promote(sum0, acc0);
      if constexpr (kDkv) promote(sum1, acc1);
    }
  }
  split_prev(n_tiles - 1);
  wgmma_fence();
  start_tf32_gradients<kDkv>(acc0, acc1, dz_hi, dz_lo, p_hi, p_lo,
                             tr_ring + (n_tiles - 1) % kStages * T::kTrStage,
                             (n_tiles - 1) % kPromoteTiles == 0);
  wgmma_wait<0>();
  pin_gradients();

  const size_t row_stride = static_cast<size_t>(H) * kHeadDim;
  const size_t head_base =
      static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kHeadDim;
  store_rows_f32(out0, acc0, sum0, scale0, head_base, row_stride, row_lo, S, c2);
  if constexpr (kDkv) store_rows_f32(out1, acc1, sum1, 1.f, head_base, row_stride, row_lo, S, c2);
}

__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap qs_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap kt_map,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int S, int H, float scale_dq) {
  bwd_tf32_body<false>(&qs_map, &do_map, &k_map, &v_map, &kt_map, nullptr, lse, delta, nullptr,
                       dq, nullptr, S, H, scale_dq);
}

__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap qs_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap qst_map,
                          const __grid_constant__ CUtensorMap dot_map,
                          const float2* __restrict__ pairs, float* __restrict__ dk,
                          float* __restrict__ dv, int S, int H, float scale_dk) {
  bwd_tf32_body<true>(&k_map, &v_map, &qs_map, &do_map, &qst_map, &dot_map, nullptr, nullptr,
                      pairs, dk, dv, S, H, scale_dk);
}

cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, void* ws, int B, int S,
                           int H, float scale_qk, float scale_dq, cudaStream_t stream) {
  const size_t part = f32_part(B, S, H);
  float* qs = static_cast<float*>(ws);
  float* dos = qs + part;
  float* ks = qs + 2 * part;
  float* vs = qs + 3 * part;
  float* kt = qs + 4 * part;
  cudaError_t err = launch_split(q, qs, nullptr, B, S, H, scale_qk, stream);
  if (err == cudaSuccess) err = launch_split(dout, dos, nullptr, B, S, H, 1.f, stream);
  if (err == cudaSuccess) err = launch_split(k, ks, kt, B, S, H, 1.f, stream);
  if (err == cudaSuccess) err = launch_split(v, vs, nullptr, B, S, H, 1.f, stream);
  CUtensorMap maps[5];
  if (err == cudaSuccess) err = make_nat_map(&maps[0], qs, B, S, H, kF32Rows);
  if (err == cudaSuccess) err = make_nat_map(&maps[1], dos, B, S, H, kF32Rows);
  if (err == cudaSuccess) err = make_nat_map(&maps[2], ks, B, S, H, kF32N);
  if (err == cudaSuccess) err = make_nat_map(&maps[3], vs, B, S, H, kF32N);
  if (err == cudaSuccess) err = make_tr_map(&maps[4], kt, B, S, H, kF32N);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F32Tile<false>::kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kF32Rows - 1) / kF32Rows, B * H);
  flash_bwd_dq_tf32_kernel<<<grid, kF32Threads, F32Tile<false>::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), S, H, scale_dq);
  return cudaGetLastError();
}

cudaError_t launch_dkv_tf32(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, void* ws,
                            void* pairs, int B, int S, int H, float scale_qk, float scale_dk,
                            cudaStream_t stream) {
  const int S_pad = (S + kPairTile - 1) / kPairTile * kPairTile;
  pad_rows_kernel<<<dim3((S_pad + kFoldThreads - 1) / kFoldThreads, B * H), kFoldThreads, 0,
                    stream>>>(static_cast<const float*>(lse), static_cast<const float*>(delta),
                              static_cast<float2*>(pairs), S, S_pad);
  const size_t part = f32_part(B, S, H);
  float* ks = static_cast<float*>(ws);
  float* vs = ks + part;
  float* qs = ks + 2 * part;
  float* dos = ks + 3 * part;
  float* qst = ks + 4 * part;
  float* dot = ks + 5 * part;
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_split(k, ks, nullptr, B, S, H, 1.f, stream);
  if (err == cudaSuccess) err = launch_split(v, vs, nullptr, B, S, H, 1.f, stream);
  if (err == cudaSuccess) err = launch_split(q, qs, qst, B, S, H, scale_qk, stream);
  if (err == cudaSuccess) err = launch_split(dout, dos, dot, B, S, H, 1.f, stream);
  CUtensorMap maps[6];
  if (err == cudaSuccess) err = make_nat_map(&maps[0], ks, B, S, H, kF32Rows);
  if (err == cudaSuccess) err = make_nat_map(&maps[1], vs, B, S, H, kF32Rows);
  if (err == cudaSuccess) err = make_nat_map(&maps[2], qs, B, S, H, kF32N);
  if (err == cudaSuccess) err = make_nat_map(&maps[3], dos, B, S, H, kF32N);
  if (err == cudaSuccess) err = make_tr_map(&maps[4], qst, B, S, H, kF32N);
  if (err == cudaSuccess) err = make_tr_map(&maps[5], dot, B, S, H, kF32N);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F32Tile<true>::kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kF32Rows - 1) / kF32Rows, B * H);
  flash_bwd_dkv_tf32_kernel<<<grid, kF32Threads, F32Tile<true>::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<const float2*>(pairs),
      static_cast<float*>(dk), static_cast<float*>(dv), S, H, scale_dk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; both run on the tensor cores and take a
// workspace `ws` the caller allocates: in bf16 [B, S, H, 64] bf16 for the
// folded q', in f32 five split copies of f32_part() floats each (q', dO, K, V
// and Kᵀ; S_pad = ceil(S/64)*64).  scale_qk = log2(e)/sqrt(D) folds q into q';
// scale_dq = 1/sqrt(D).  Returns a cudaError_t (0 on success); the caller
// raises on anything else.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, void* ws, int B,
                                 int S, int H, int D, int dtype, float scale_qk, float scale_dq,
                                 void* stream) {
  if (D != kHeadDim || B <= 0 || S <= 0 || H <= 0 || B * H > 65535 || ws == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(
        launch_dq_tf32(q, k, v, dout, lse, delta, dq, ws, B, S, H, scale_qk, scale_dq, st));
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_fold_q(q, ws, B, S, H, scale_qk, st);
  if (err == cudaSuccess) {
    err = launch_dq_wgmma(k, v, dout, lse, delta, dq, ws, B, S, H, scale_dq, st);
  }
  return static_cast<int>(err);
}

// scale_dk = ln(2): dk = dz^T . q_orig / sqrt(D) = ln(2) * dz^T . q'.  `ws` as
// for dq, in f32 six copies (K, V, q', dO, q'ᵀ, dOᵀ); `pairs` is one more
// workspace: [B*H, ceil(S/64)*64, 2] f32.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  void* ws, void* pairs, int B, int S, int H, int D, int dtype,
                                  float scale_qk, float scale_dk, void* stream) {
  if (D != kHeadDim || B <= 0 || S <= 0 || H <= 0 || B * H > 65535 || ws == nullptr ||
      pairs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_dkv_tf32(q, k, v, dout, lse, delta, dk, dv, ws, pairs, B, S,
                                            H, scale_qk, scale_dk, st));
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_fold_q(q, ws, B, S, H, scale_qk, st);
  if (err == cudaSuccess) {
    err = launch_dkv_wgmma(k, v, dout, lse, delta, dk, dv, ws, pairs, B, S, H, scale_dk, st);
  }
  return static_cast<int>(err);
}
