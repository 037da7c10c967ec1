// Flash-attention forwards for Hopper (sm_90a): two modes, each as a bf16
// kernel on the tensor cores and an f32 kernel on the FMA pipes.
//
// Replaces the TPU kernels of da3slam_tpu/ops/flash_attention.py:
//   - _fwd_kernel_bound (reached through _flash_forward(stable=False)): the
//     max-free "bound" forward, which serves every attention call of the DA3
//     ViT encoder (C entry flash_attn_bound_fwd);
//   - _fwd_kernel (reached through _flash_forward(stable=True)): the online-
//     softmax forward of the public flash_attention's default mode, safe for
//     inputs of any norm, where the bound forward underflows (C entry
//     flash_attn_stable_fwd).
//
// Math (identical to the TPU kernels and to flash_attention_bound_reference /
// flash_attention_stable_reference):
//   q'_i  = round_to_T(q_i * log2(e)/sqrt(D))            (the TPU's _fold)
//   s_ij  = q'_i . k_j                                   (f32; keys j >= S get p = 0)
//   bound:  m_i = ||q'_i|| * max_j ||k_j||               (f32, from the rounded q')
//           p_ij = round_to_T(exp2(s_ij - m_i)),  acc = sum_j p_ij v_j,  l = sum_j p_ij
//   stable, per block of keys (128 in bf16, 16 in f32):
//           m_new = max(m, max_j s_ij)                   (m starts at -1e30)
//           alpha = exp2(m - m_new)
//           p_ij  = round_to_T(exp2(s_ij - m_new))
//           acc   = alpha * acc + sum_j p_ij v_j,  l = alpha * l + sum_j p_ij
//   O_i   = acc / max(l, 1e-30),  lse_i = m_i + log2(max(l, 1e-30))   (base 2)
// The bound m_i exceeds every logit (Cauchy-Schwarz), so p <= 1 and the bound
// mode needs no running max and no rescale.  The denominator sums the ROUNDED
// p, as the TPU's ones-column in V did.  The stable mode's result is the same
// at any block size (tests/test_flash_attention.py TestKSplits) up to where
// each p is rounded; the plain version rounds at the bf16 kernel's 128 keys
// (the TPU's block_k), and in f32, where p is not rounded, the block only
// reorders f32 sums.
//
// Layout: q, k, v and O are [B, S, H, 64] contiguous (the model's own layout:
// no fold/transpose copies); lse is [B*H, S] f32, the same quantity in either
// mode, so one backward serves both.
//
// What bounds it on an H100: the SMALL-tier cross-view call (B=1, S=19515,
// H=6 at chunk 15) is 4*S^2*D*H = 5.85e11 FLOP against ~28 MB of q/k/v/O
// traffic: operations, by four orders of magnitude; the intra-view call (B=15,
// S=1301) too.  In bf16 that is 0.59 ms of tensor-core time at 989 TFLOP/s,
// and beside it S^2*H = 2.3e9 exp2 at 16 a clock an SM, ~0.6 ms on the
// special-function units: at D = 64 the two are co-limiting, and whatever of
// the softmax does not overlap the products adds to them.
//
// Design of the bf16 kernel (flash_fwd_wgmma_kernel; the building blocks are
// in flash_wgmma.cuh):
//   - One CTA per (b*h, 128 query rows): two consumer warpgroups of 64 rows
//     each and one producer warpgroup, 384 threads, one CTA an SM.  setmaxnreg
//     hands the producer's registers to the consumers (24 / 240).
//   - K and V tiles of 128 keys travel through a ring of three shared-memory
//     stages (32 KB each).  One producer thread starts two TMA box loads a
//     stage from 4-D tensor maps over k and v, (64, H, S, B), into the
//     128-byte swizzle; a full/empty mbarrier pair per stage orders it against
//     the consumers, which share every stage.  Rows past S arrive as zeros.
//   - Both products are wgmma.  S = Q'.K^T: m64n128k16 x 4, q' and the K tile
//     both K-major in shared memory.  O += P.V: m64n64k16 x 8 with P in
//     registers (the score accumulator's layout is, 16 columns at a time, the
//     A-fragment layout: cvt.rn.bf16x2 pairs, no shuffle) and the V tile as
//     the MN-major B operand.  q' and p are bf16 operands, so the rounding
//     points above are the hardware's own types.
//   - l sums the converted p on the tensor cores too, as the TPU's ones-column
//     did: the same A fragments against a register fragment of ones
//     (mma.sync m16n8k16), each thread left with its rows' whole sums.
//   - exp2 is ex2.approx.ftz, the instruction inside exp2f without exp2f's
//     denormal rescale: a p below 2^-126 is 0.
//   - q cannot come by TMA: the consumers load their 64 rows, fold and round
//     them, write them swizzled to shared memory and leave m_i (bound mode)
//     per row beside them.
//   - A whole tile is multiplied, so in the ragged last tile the scores of
//     columns >= S - k0 are set to -inf before the max and the exp2: a
//     zero-filled key scores 0, and exp2(0 - m_i) is not 0.
//   - Per tile a warpgroup starts S_j and P_{j-1}.V_{j-1} together, waits for
//     S_j alone (wait_group 1) and takes max, exp2, convert and the row sums
//     while P.V runs, into a second set of fragment registers; then it waits
//     for P.V and rescales (stable mode: l and the 32 O registers, by the
//     quad-wide row max's move).  The scores are only read meanwhile: ptxas
//     puts the wait before the first write to any wgmma accumulator register
//     (or serialises the wgmmas, C7515), which undoes the overlap.
// Measured (PERF.md, H100 at 700 W): the cross call takes 1.4 ms, the
// library's time, ~43% of the tensor-core peak.  With the softmax cut out the
// products alone take 0.73 ms (the peak), with the products cut out the
// softmax alone 0.99 ms, so a third of a millisecond overlaps: the two
// warpgroups move in step, and the tensor cores idle while both take their
// exp2.  Starting S_{j+1} before the softmax of tile j needs two score buffers,
// 192 accumulator and fragment registers a thread, and spills at the 168 that
// 384 threads leave; the traffic of K/V from L2 is not a limit (a build that
// loads nothing after the ring's first fill is no faster).
// The f32 kernel (flash_fwd_f32_kernel) is the FMA-pipe design the bf16 path
// had before it moved to the tensor cores: one thread per query row, K/V
// tiles of 64 keys staged as f32, every product an fmaf, exact in f32 (TF32
// would keep ~10 bits of q' and k).  Training and the f32 parity runs use it.
//
// The FLASH_FWD_* macros exist for da3slam_tpu_torch/tools/flash_fwd_stages.py,
// which builds this file at earlier stages of the design (a ring too short to
// load ahead, one consumer warpgroup, no overlap) to time what each step
// bought; the library is always built with the defaults.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/flash_attention.py).

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

#ifndef FLASH_FWD_STAGES
#define FLASH_FWD_STAGES 3  // K/V ring depth
#endif
#ifndef FLASH_FWD_CONSUMERS
#define FLASH_FWD_CONSUMERS 2  // consumer warpgroups (64 query rows each) a CTA
#endif
#ifndef FLASH_FWD_OVERLAP
#define FLASH_FWD_OVERLAP 1  // softmax of tile j beside P.V of tile j-1
#endif

namespace {

using namespace flash;
using namespace hopper;

constexpr int kNormThreads = 256;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF, the stable m's start

// kmax[b*H + h] = max_j ||k[b, j, h, :]||  (f32): the bound mode's pre-pass
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
key_norm_max_kernel(const T* __restrict__ k, float* __restrict__ kmax, int S, int H) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row_stride = static_cast<size_t>(H) * kHeadDim;
  const T* base = k + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kHeadDim;
  float best = 0.f;
  for (int j = threadIdx.x; j < S; j += kNormThreads) {
    const T* row = base + static_cast<size_t>(j) * row_stride;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += Vec16<T>::kN) {
      float x[Vec16<T>::kN];
      Vec16<T>::load(row + d, x);
#pragma unroll
      for (int i = 0; i < Vec16<T>::kN; ++i) acc = fmaf(x[i], x[i], acc);
    }
    best = fmaxf(best, sqrtf(acc));
  }
  __shared__ float partial[kNormThreads / 32];
  best = warp_max(best);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x < 32) {
    best = threadIdx.x < kNormThreads / 32 ? partial[threadIdx.x] : 0.f;
    best = warp_max(best);
    if (threadIdx.x == 0) kmax[bh] = best;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA ring
// ---------------------------------------------------------------------------

constexpr int kTileK = 128;  // keys per ring stage = per online-softmax step
constexpr int kConsumers = FLASH_FWD_CONSUMERS;
constexpr int kStages = FLASH_FWD_STAGES;
constexpr bool kOverlap = FLASH_FWD_OVERLAP != 0;
constexpr int kQBarrier = 1;  // named barrier 1 + wg closes a warpgroup's q' tile (0: __syncthreads)
constexpr int kWgRows = 64;  // query rows per consumer warpgroup (wgmma's M)
constexpr int kWgThreads = 128;
constexpr int kRowsQ = kWgRows * kConsumers;
constexpr int kWgmmaThreads = kWgThreads * (kConsumers + 1);
constexpr int kTileBytes = kTileK * kRowBytes;  // one K or V tile: 16 KB
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kQBytes = kRowsQ * kRowBytes;
// q' tile, the ring, m per row, a full and an empty barrier per stage; 1024
// more to align the tiles
constexpr int kSmemBytes =
    kGroupBytes + kQBytes + kStages * kStageBytes + kRowsQ * 4 + 2 * kStages * 8;
static_assert(kConsumers == 1 || kConsumers == 2, "one or two consumer warpgroups");
// a consumer holds tile j-1's stage (V) while it waits for tile j's (K): with
// two stages the next load starts only when both are done with, with three it
// runs beside the arithmetic
static_assert(kStages >= 2, "the ring needs two stages");
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");

// One key tile's softmax step on a thread's 64 scores (rows r = 0, 1: t/4 and
// + 8; s[4j + 2r + {0, 1}] at columns 8j + c2 + {0, 1}): p = round_bf16(exp2(s
// - m)), 0 in columns >= n_valid (keys past S), as the A fragments of the P.V
// product: the score accumulator's layout is, 16 columns at a time, the
// A-fragment layout.  In the stable mode m moves to the running max and alpha
// = exp2(m_old - m_new) is what acc and l must be scaled by.  s is only read:
// a wgmma may be in flight, and ptxas serialises the wgmmas of a kernel that
// writes accumulator registers meanwhile (C7515).
template <bool kStable>
__device__ __forceinline__ void softmax_tile(const float (&s)[64], uint32_t (&p)[32],
                                             float (&m)[2], float (&alpha)[2], int n_valid,
                                             int c2) {
  const bool ragged = n_valid < kTileK;
  // column 8j + c2 + e of row r, or -inf past the last key
  auto score = [&](int j, int r, int e) {
    const float x = s[4 * j + 2 * r + e];
    return ragged && 8 * j + c2 + e >= n_valid ? -INFINITY : x;
  };
  if constexpr (kStable) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(score(j, 0, 0), score(j, 0, 1)));
      mx[1] = fmaxf(mx[1], fmaxf(score(j, 1, 0), score(j, 1, 1)));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's 128 scores are spread over the four threads of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      p[4 * (j >> 1) + 2 * (j & 1) + r] =
          pack_bf16(ex2(score(j, r, 0) - m[r]), ex2(score(j, r, 1) - m[r]));
    }
  }
}

// l += the row sums of the rounded p, taken on the tensor cores as the TPU
// kernel's ones-column in V did: P's A fragments (a warp's 16 rows) against a
// B fragment of ones, mma.sync m16n8k16 a 16-key slice.  Every column of the
// 16 x 8 result is the row sum: l[0] (l[1] its copy) for row t/4, l[2] (l[3])
// for row + 8, whole in every thread of the quad.  Summing the converted
// pairs by hand costs four f32-pipe instructions a pair.
__device__ __forceinline__ void add_row_sums(float (&l)[4], const uint32_t (&p)[32]) {
  constexpr uint32_t kOnes = 0x3f803f80u;  // bf16 (1, 1)
#pragma unroll
  for (int i = 0; i < kTileK / 16; ++i) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %8}, {%0, %1, %2, %3};\n"
        : "+f"(l[0]), "+f"(l[1]), "+f"(l[2]), "+f"(l[3])
        : "r"(p[4 * i]), "r"(p[4 * i + 1]), "r"(p[4 * i + 2]), "r"(p[4 * i + 3]), "r"(kOnes));
  }
}

// s = Q'.K^T: the warpgroup's 64 rows of q' against the K tile at `k_tile`
__device__ __forceinline__ void start_scores(float (&s)[64], uint64_t q_desc, uint32_t k_tile) {
  const uint64_t k_desc = tile_desc(k_tile);
#pragma unroll
  for (int i = 0; i < kHeadDim / 16; ++i) {
    wgmma_m64n128k16_ss(s, q_desc + i * kDescKMajorStep, k_desc + i * kDescKMajorStep, i != 0);
  }
  wgmma_commit();
}

// acc += P.V: p as A fragments against the V tile at `v_tile`
__device__ __forceinline__ void start_pv(float (&acc)[32], const uint32_t (&p)[32],
                                         uint32_t v_tile) {
  const uint64_t v_desc = tile_desc(v_tile);
#pragma unroll
  for (int i = 0; i < kTileK / 16; ++i) {
    wgmma_m64n64k16_rs(acc, p + 4 * i, v_desc + i * kDescMnMajorStep);
  }
  wgmma_commit();
}

template <bool kStable>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __nv_bfloat16* __restrict__ q, const float* __restrict__ kmax,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S, int H,
                       float scale) {
  extern __shared__ uint8_t smem_raw[];
  // the tiles start on a 1024-byte boundary of the shared address space
  uint8_t* smem = smem_raw + ((kGroupBytes - (smem_addr(smem_raw) & (kGroupBytes - 1))) &
                              (kGroupBytes - 1));
  uint8_t* q_tile = smem;
  const uint32_t ring = smem_addr(smem + kQBytes);
  float* m_row = reinterpret_cast<float*>(smem + kQBytes + kStages * kStageBytes);
  const uint32_t full_bar = smem_addr(m_row + kRowsQ);
  const uint32_t empty_bar = full_bar + kStages * 8;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_tiles = (S + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + st * 8, 1);                // the producer's arrive.expect_tx
      mbar_init(empty_bar + st * 8, 4 * kConsumers);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    if constexpr (kConsumers == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * kWgThreads) {
      int stage = 0;
      uint32_t parity = 1;  // of the release that frees a stage: none needed in round 0
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= kStages) mbar_wait(empty_bar + stage * 8, parity);
        const uint32_t bar = full_bar + stage * 8;
        const uint32_t dst = ring + stage * kStageBytes;
        mbar_arrive_expect_tx(bar, kStageBytes);
        tma_load_4d(dst, &k_map, bar, 0, h, t * kTileK, b);
        tma_load_4d(dst + kTileBytes, &v_map, bar, 0, h, t * kTileK, b);
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    // of the SM's 65,536 registers: 2 x 128 x 240 + 128 x 24
    if constexpr (kConsumers == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tw = threadIdx.x % kWgThreads;
    const int lane = tw & 31;
    const int c2 = (lane & 3) * 2;
    const int wg_row0 = wg * kWgRows;                    // in the CTA's q tile
    const int q_row0 = blockIdx.x * kRowsQ + wg_row0;    // in the sequence
    const size_t row_stride = static_cast<size_t>(H) * kHeadDim;
    const size_t head_base =
        static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kHeadDim;

    // q' = round_bf16(q * scale), swizzled into shared memory; 8 threads a row.
    // Rows past S are zeros (m = 0, p = 1: finite, never stored).
    const float kmax_bh = kStable ? 0.f : kmax[bh];
#pragma unroll
    for (int i = 0; i < kWgRows * 8 / kWgThreads; ++i) {
      const int idx = tw + kWgThreads * i;
      const int r = idx >> 3;
      const int chunk = idx & 7;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      float n2 = 0.f;
      if (q_row0 + r < S) {
        float x[8];
        Vec16<__nv_bfloat16>::load(
            q + head_base + static_cast<size_t>(q_row0 + r) * row_stride + chunk * 8, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[e] = pack_bf16(x[2 * e] * scale, x[2 * e + 1] * scale);
          const float lo = __uint_as_float(w[e] << 16);
          const float hi = __uint_as_float(w[e] & 0xffff0000u);
          n2 = fmaf(lo, lo, n2);
          n2 = fmaf(hi, hi, n2);
        }
      }
      *reinterpret_cast<uint4*>(q_tile + swizzled_chunk(wg_row0 + r, chunk)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      n2 += __shfl_xor_sync(0xffffffffu, n2, 1);
      n2 += __shfl_xor_sync(0xffffffffu, n2, 2);
      n2 += __shfl_xor_sync(0xffffffffu, n2, 4);
      if (chunk == 0) m_row[wg_row0 + r] = kStable ? kNegInf : sqrtf(n2) * kmax_bh;
    }
    fence_proxy_async();
    named_barrier_sync(kQBarrier + wg, kWgThreads);

    // this thread's two rows of the warpgroup's 64
    const int row_lo = 16 * (tw >> 5) + (lane >> 2);
    float m[2] = {m_row[wg_row0 + row_lo], m_row[wg_row0 + row_lo + 8]};
    float l[4] = {0.f, 0.f, 0.f, 0.f};  // the row sums: add_row_sums
    float alpha[2] = {1.f, 1.f};
    float s[64];
    float acc[32];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    const uint64_t q_desc = tile_desc(smem_addr(q_tile) + wg_row0 * kRowBytes);

    mbar_wait(full_bar, 0);
    wgmma_fence();
    start_scores(s, q_desc, ring);
    wgmma_wait<0>();
    pin(s);
    softmax_tile<kStable>(s, p, m, alpha, S, c2);
    add_row_sums(l, p);

    int prev = 0;  // the stage whose V tile the pending P belongs to
    uint32_t parity = 0;
    for (int t = 1; t < n_tiles; ++t) {
      int stage = prev + 1;
      if (stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
      mbar_wait(full_bar + stage * 8, parity);
      pin(s);
      pin(acc);
      pin(p);
      wgmma_fence();
      start_scores(s, q_desc, ring + stage * kStageBytes);
      start_pv(acc, p, ring + prev * kStageBytes + kTileBytes);
      // the scores are ready while P.V still runs: the exp2 overlap it
      wgmma_wait<kOverlap ? 1 : 0>();
      pin(s);
      uint32_t p_next[32];
      softmax_tile<kStable>(s, p_next, m, alpha, S - t * kTileK, c2);
      if constexpr (kStable) {
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i] *= alpha[i >> 1];
      }
      add_row_sums(l, p_next);
      wgmma_wait<0>();
      pin(acc);
      pin(p);
      if (lane == 0) mbar_arrive(empty_bar + prev * 8);  // K and V of tile t-1 are consumed
      if constexpr (kStable) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = p_next[i];
      prev = stage;
    }
    pin(acc);
    pin(p);
    wgmma_fence();
    start_pv(acc, p, ring + prev * kStageBytes + kTileBytes);
    wgmma_wait<0>();
    pin(acc);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lc = fmaxf(l[2 * r], 1e-30f);
      const int row = q_row0 + row_lo + 8 * r;
      if (row < S) {
        __nv_bfloat16* orow = o + head_base + static_cast<size_t>(row) * row_stride + c2;
#pragma unroll
        for (int j = 0; j < kHeadDim / 8; ++j) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(acc[4 * j + 2 * r] / lc, acc[4 * j + 2 * r + 1] / lc);
        }
        if ((lane & 3) == 0) lse[static_cast<size_t>(bh) * S + row] = m[r] + log2f(lc);
      }
    }
  }
}

template <bool kStable>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                         void* kmax, int B, int S, int H, float scale, cudaStream_t stream) {
  CUtensorMap k_map, v_map;
  cudaError_t err = make_head_tile_map(&k_map, k, B, S, H, kTileK);
  if (err == cudaSuccess) err = make_head_tile_map(&v_map, v, B, S, H, kTileK);
  // above 48 KB the dynamic shared memory has to be asked for; per device, so per launch
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<kStable>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRowsQ - 1) / kRowsQ, B * H);
  flash_fwd_wgmma_kernel<kStable><<<grid, kWgmmaThreads, kSmemBytes, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(kmax),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: FMA pipes, one thread per query row
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;  // query rows per CTA = threads per CTA
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kSub = 16;     // keys whose scores sit in registers at once

// kStable = false: the bound mode (m from kmax, fixed).  kStable = true: the
// online softmax (kmax unused, m the running max).
template <bool kStable>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ kmax,
                     float* __restrict__ o, float* __restrict__ lse, int S, int H, float scale) {
  __shared__ __align__(16) float k_tile[kBlockK][kHeadDim];
  __shared__ __align__(16) float v_tile[kBlockK][kHeadDim];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < S;
  const size_t row_stride = static_cast<size_t>(H) * kHeadDim;
  const size_t head_base = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kHeadDim;

  // q'_i in registers
  float qr[kHeadDim];
  float qn2 = 0.f;
  if (active) {
    const float* qrow = q + head_base + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4) {
      load4(qrow + d, qr + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qr[d + i] *= scale;
        qn2 = fmaf(qr[d + i], qr[d + i], qn2);
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) qr[d] = 0.f;
  }
  float m = kStable ? kNegInf : sqrtf(qn2) * kmax[bh];

  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  float l = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    const int nk = min(kBlockK, S - k0);
    __syncthreads();  // the previous tile has been consumed
    // rows nk..63 are zero-filled: the masked keys below multiply zeros
    stage_tile<float, kBlockK>(k_tile, k + head_base, row_stride, k0, nk, 1.f, threadIdx.x, kBlockQ);
    stage_tile<float, kBlockK>(v_tile, v + head_base, row_stride, k0, nk, 1.f, threadIdx.x, kBlockQ);
    __syncthreads();
    if (!active) continue;
    if constexpr (kStable) {
      for (int j0 = 0; j0 < nk; j0 += kSub) {
        float s[kSub];
        float m_blk = kNegInf;
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          // keys past S get p = 0 (the TPU's NEG_INF bias column).  Their
          // rows are zeros, so the score is taken unconditionally: a branch
          // around it raised the registers from 167 to 202-217 (ptxas)
          const float sc = score(qr, k_tile[j0 + jj]);
          s[jj] = (j0 + jj < nk) ? sc : -INFINITY;
          m_blk = fmaxf(m_blk, s[jj]);
        }
        const float m_new = fmaxf(m, m_blk);
        const float alpha = exp2f(m - m_new);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) acc[d] *= alpha;
        m = m_new;
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const float p = exp2f(s[jj] - m);
          l += p;
          accumulate(acc, p, v_tile[j0 + jj]);
        }
      }
    } else {
      // a fixed shift needs no scores held back: one key at a time.  Keys
      // j >= nk (past S) are never visited: their p is 0
      for (int j = 0; j < nk; ++j) {
        const float p = exp2f(score(qr, k_tile[j]) - m);
        l += p;
        accumulate(acc, p, v_tile[j]);
      }
    }
  }

  if (active) {
    const float lc = fmaxf(l, 1e-30f);
    float* orow = o + head_base + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) orow[d] = acc[d] / lc;
    lse[static_cast<size_t>(bh) * S + row] = m + log2f(lc);
  }
}

template <bool kStable>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       void* kmax, int B, int S, int H, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_f32_kernel<kStable><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(kmax), static_cast<float*>(o), static_cast<float*>(lse), S, H,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_key_norm_max(const void* k, void* kmax, int B, int S, int H,
                                cudaStream_t stream) {
  key_norm_max_kernel<T><<<B * H, kNormThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<float*>(kmax), S, H);
  return cudaGetLastError();
}

// by dtype alone: f32 on the FMA pipes, bf16 on the tensor cores
template <bool kStable>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, void* kmax,
             int B, int S, int H, int D, int dtype, float scale, void* stream) {
  if (D != kHeadDim || B <= 0 || S <= 0 || H <= 0 || B * H > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (!kStable) {
    const cudaError_t err = dtype == 0 ? launch_key_norm_max<float>(k, kmax, B, S, H, st)
                                       : launch_key_norm_max<__nv_bfloat16>(k, kmax, B, S, H, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(dtype == 0
                              ? launch_f32<kStable>(q, k, v, o, lse, kmax, B, S, H, scale, st)
                              : launch_wgmma<kStable>(q, k, v, o, lse, kmax, B, S, H, scale, st));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kmax is a [B*H] f32 workspace.
// Each returns a cudaError_t (0 on success); the caller raises on anything else.
extern "C" int flash_attn_bound_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, void* kmax, int B, int S, int H, int D,
                                    int dtype, float scale, void* stream) {
  return dispatch<false>(q, k, v, o, lse, kmax, B, S, H, D, dtype, scale, stream);
}

extern "C" int flash_attn_stable_fwd(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int S, int H, int D, int dtype,
                                     float scale, void* stream) {
  return dispatch<true>(q, k, v, o, lse, nullptr, B, S, H, D, dtype, scale, stream);
}
