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
// layout: no fold/transpose copies); lse and Delta are [B*H, S] f32.  T is
// __nv_bfloat16 (the tensor-core kernels) or float (the FMA kernels), picked
// by dtype alone.
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
// thread quad (bf16) or thread pair (f32), so the result is deterministic.
//
// The f32 kernels (flash_bwd_dq_kernel, flash_bwd_dkv_kernel) are the FMA-pipe
// design both types had before bf16 moved to the tensor cores, exact in f32
// (TF32 would keep ~10 bits of q' and k): one CTA per (b*h, 64-row tile),
// looping over the other side's tiles of 64 staged in shared memory as f32.
// A PAIR of adjacent threads owns one row, each thread half of the head dim
// in interleaved 4-wide chunks (thread h of the pair holds chunks 2m + h, m =
// 0..7), so a thread keeps three (dq: q', dO, dq) or four (dk/dv: k, v, dk,
// dv) 32-wide rows in registers, and the pair's two shared-memory reads of a
// row land in different banks.  The two half dot products meet by one
// __shfl_xor each.  Training in f32 and the f32 parity runs use them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/flash_attention.py).

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace flash;

constexpr int kTile = 64;              // rows per CTA, and rows per staged tile
constexpr int kThreads = 2 * kTile;    // a pair of threads per row
constexpr int kHalf = kHeadDim / 2;    // dims per thread
constexpr int kChunks = kHalf / 4;     // 4-wide chunks per thread

// chunk m of this thread's half: dims [8m + 4*half, 8m + 4*half + 4)
__device__ __forceinline__ int chunk_col(int m, int half) { return 8 * m + 4 * half; }

// this thread's half of one global row of T into f32 registers, each element
// as round_to<T>(x * scale)
template <typename T>
__device__ __forceinline__ void load_half(const T* row, int half, float scale, float* out) {
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    load4(row + chunk_col(m, half), out + 4 * m);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[4 * m + i] = round_to<T>(out[4 * m + i] * scale);
  }
}

template <typename T>
__device__ __forceinline__ void store_half(T* row, int half, float scale, const float* in) {
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = in[4 * m + i] * scale;
    store4(row + chunk_col(m, half), x);
  }
}

// the pair's full dot products of (a . tile_a[j]) and (b . tile_b[j])
__device__ __forceinline__ void pair_dots(const float* a, const float* b, const float* tile_a_row,
                                          const float* tile_b_row, int half, float& da,
                                          float& db) {
  const float4* ra = reinterpret_cast<const float4*>(tile_a_row);
  const float4* rb = reinterpret_cast<const float4*>(tile_b_row);
  float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const float4 x = ra[2 * m + half];
    const float4 y = rb[2 * m + half];
    a0 = fmaf(a[4 * m + 0], x.x, a0);
    a1 = fmaf(a[4 * m + 1], x.y, a1);
    a0 = fmaf(a[4 * m + 2], x.z, a0);
    a1 = fmaf(a[4 * m + 3], x.w, a1);
    b0 = fmaf(b[4 * m + 0], y.x, b0);
    b1 = fmaf(b[4 * m + 1], y.y, b1);
    b0 = fmaf(b[4 * m + 2], y.z, b0);
    b1 = fmaf(b[4 * m + 3], y.w, b1);
  }
  da = a0 + a1;
  db = b0 + b1;
  // x + y == y + x in IEEE: both threads of the pair get the same bits
  da += __shfl_xor_sync(0xffffffffu, da, 1);
  db += __shfl_xor_sync(0xffffffffu, db, 1);
}

// acc += w * tile_row (this thread's half)
__device__ __forceinline__ void axpy_half(float* acc, float w, const float* tile_row, int half) {
  const float4* r = reinterpret_cast<const float4*>(tile_row);
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const float4 x = r[2 * m + half];
    acc[4 * m + 0] = fmaf(w, x.x, acc[4 * m + 0]);
    acc[4 * m + 1] = fmaf(w, x.y, acc[4 * m + 1]);
    acc[4 * m + 2] = fmaf(w, x.z, acc[4 * m + 2]);
    acc[4 * m + 3] = fmaf(w, x.w, acc[4 * m + 3]);
  }
}

// dq: one CTA per (b*h, 64-row q tile), looping over key tiles
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int H,
                    float scale_qk, float scale_dq) {
  __shared__ __align__(16) float k_tile[kTile][kHeadDim];
  __shared__ __align__(16) float v_tile[kTile][kHeadDim];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * kTile + (threadIdx.x >> 1);
  const bool active = row < S;
  const size_t row_stride = static_cast<size_t>(H) * kHeadDim;
  const size_t head_base = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kHeadDim;

  // an inactive pair (row >= S) runs on zeros, finite throughout, and stores
  // nothing: every thread takes part in the shuffles and barriers
  float qr[kHalf], dor[kHalf], acc[kHalf];
  float lse_i = 0.f, d_i = 0.f;
  if (active) {
    const size_t off = head_base + static_cast<size_t>(row) * row_stride;
    load_half(q + off, half, scale_qk, qr);
    load_half(dout + off, half, 1.f, dor);
    lse_i = lse[static_cast<size_t>(bh) * S + row];
    d_i = delta[static_cast<size_t>(bh) * S + row];
  } else {
#pragma unroll
    for (int d = 0; d < kHalf; ++d) qr[d] = dor[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < kHalf; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int nk = min(kTile, S - k0);
    __syncthreads();  // the previous tile has been consumed
    stage_tile<T, kTile>(k_tile, k + head_base, row_stride, k0, nk, 1.f, threadIdx.x, kThreads);
    stage_tile<T, kTile>(v_tile, v + head_base, row_stride, k0, nk, 1.f, threadIdx.x, kThreads);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {  // keys past S are never visited
      float s, dov;
      pair_dots(qr, dor, k_tile[j], v_tile[j], half, s, dov);
      const float p = exp2f(s - lse_i);
      const float dz = p * (dov - d_i);
      axpy_half(acc, round_to<T>(dz), k_tile[j], half);
    }
  }
  if (active) {
    store_half(dq + head_base + static_cast<size_t>(row) * row_stride, half, scale_dq, acc);
  }
}

// dk/dv: one CTA per (b*h, 64-key tile), looping over q tiles
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int H, float scale_qk, float scale_dk) {
  __shared__ __align__(16) float q_tile[kTile][kHeadDim];
  __shared__ __align__(16) float do_tile[kTile][kHeadDim];
  __shared__ float lse_tile[kTile];
  __shared__ float d_tile[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int half = threadIdx.x & 1;
  const int col = blockIdx.x * kTile + (threadIdx.x >> 1);
  const bool active = col < S;
  const size_t row_stride = static_cast<size_t>(H) * kHeadDim;
  const size_t head_base = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kHeadDim;
  const float* lse_bh = lse + static_cast<size_t>(bh) * S;
  const float* delta_bh = delta + static_cast<size_t>(bh) * S;

  // an inactive pair (key >= S) runs on zeros and stores nothing; its values
  // may overflow (p = exp2(-lse)) but never leave its registers
  float kr[kHalf], vr[kHalf], dk_acc[kHalf], dv_acc[kHalf];
  if (active) {
    const size_t off = head_base + static_cast<size_t>(col) * row_stride;
    load_half(k + off, half, 1.f, kr);
    load_half(v + off, half, 1.f, vr);
  } else {
#pragma unroll
    for (int d = 0; d < kHalf; ++d) kr[d] = vr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < kHalf; ++d) dk_acc[d] = dv_acc[d] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    const int nq = min(kTile, S - q0);
    __syncthreads();  // the previous tile has been consumed
    // q' rounded to T as the forward folds it
    stage_tile<T, kTile>(q_tile, q + head_base, row_stride, q0, nq, scale_qk, threadIdx.x, kThreads);
    stage_tile<T, kTile>(do_tile, dout + head_base, row_stride, q0, nq, 1.f, threadIdx.x, kThreads);
    if (threadIdx.x < kTile) {
      const bool in = threadIdx.x < nq;
      lse_tile[threadIdx.x] = in ? lse_bh[q0 + threadIdx.x] : 0.f;
      d_tile[threadIdx.x] = in ? delta_bh[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {  // rows past S are never visited
      float s, dov;
      pair_dots(kr, vr, q_tile[i], do_tile[i], half, s, dov);
      const float p = exp2f(s - lse_tile[i]);
      const float dz = p * (dov - d_tile[i]);
      axpy_half(dv_acc, round_to<T>(p), do_tile[i], half);
      axpy_half(dk_acc, round_to<T>(dz), q_tile[i], half);
    }
  }
  if (active) {
    const size_t off = head_base + static_cast<size_t>(col) * row_stride;
    store_half(dk + off, half, scale_dk, dk_acc);
    store_half(dv + off, half, 1.f, dv_acc);
  }
}

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

}  // namespace

// dtype: 0 = float32 (the FMA kernels), 1 = bfloat16 (the tensor-core kernels,
// which need `qs`, a [B, S, H, 64] bf16 workspace for the folded q'; unused in
// f32).  scale_qk = log2(e)/sqrt(D) folds q into q'; scale_dq = 1/sqrt(D).
// Returns a cudaError_t (0 on success); the caller raises on anything else.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, void* qs, int B,
                                 int S, int H, int D, int dtype, float scale_qk, float scale_dq,
                                 void* stream) {
  if (D != kHeadDim || B <= 0 || S <= 0 || H <= 0 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (qs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = launch_fold_q(q, qs, B, S, H, scale_qk, st);
    if (err == cudaSuccess) {
      err = launch_dq_wgmma(k, v, dout, lse, delta, dq, qs, B, S, H, scale_dq, st);
    }
    return static_cast<int>(err);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_bwd_dq_kernel<float><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), S, H, scale_qk, scale_dq);
  return static_cast<int>(cudaGetLastError());
}

// scale_dk = ln(2): dk = dz^T . q_orig / sqrt(D) = ln(2) * dz^T . q'.  In bf16
// `pairs` is one more workspace: [B*H, ceil(S/64)*64, 2] f32.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  void* qs, void* pairs, int B, int S, int H, int D, int dtype,
                                  float scale_qk, float scale_dk, void* stream) {
  if (D != kHeadDim || B <= 0 || S <= 0 || H <= 0 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (qs == nullptr || pairs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = launch_fold_q(q, qs, B, S, H, scale_qk, st);
    if (err == cudaSuccess) {
      err = launch_dkv_wgmma(k, v, dout, lse, delta, dk, dv, qs, pairs, B, S, H, scale_dk, st);
    }
    return static_cast<int>(err);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  flash_bwd_dkv_kernel<float><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), S, H,
      scale_qk, scale_dk);
  return static_cast<int>(cudaGetLastError());
}
