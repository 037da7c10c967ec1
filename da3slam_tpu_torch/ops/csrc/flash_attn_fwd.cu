// Flash-attention forwards for Hopper (sm_90a): two modes, each as a bf16
// kernel and an f32 kernel, all four on the tensor cores.
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
//   stable, per block of keys (128 in bf16, 32 in f32):
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
// in flash_wgmma.cuh, the tile step it shares with the probe forwards in
// flash_fwd_tile.cuh):
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
//
// The f32 kernel (flash_fwd_tf32_kernel; training and the f32 parity runs use
// it) takes both products as error-compensated TF32 on wgmma, as the f32
// backward does (flash_attn_bwd.cu; the shared pieces are in flash_tf32.cuh):
// each f32 operand x is split into hi = tf32_rna(x) and lo = tf32_rna(x - hi),
// and a product is lo.hi + hi.lo + hi.hi in f32 accumulators, the small terms
// first: ~21 bits where one TF32 product keeps ~11, whose errors (2^-11
// |q'||k| in s, 2^-11 relative in P.V) would take O past the f32 bound.  TF32
// flags (torch.backends) do not govern it.  What bounds it: 3 x 4*S^2*D FLOP at 495
// TFLOP/s (train cross, (1, 5204, 6, 64): 0.252 ms, against 0.621 on the f32
// FMA pipes).
//   - A pre-pass (split_tf32_kernel) writes K split in its natural layout
//     [bh][hi/lo][half][S_pad][32] and V split and transposed, [bh][hi/lo][64]
//     [S_pad] with the keys permuted inside groups of 8, into a workspace the
//     wrapper allocates: TF32 wgmma reads shared-memory operands K-major only,
//     and P.V sums over the keys.  The permutation lets the score
//     accumulator's values be P's A fragments with no shuffle.
//   - One CTA per (b*h, 128 query rows): two consumer warpgroups of 64 rows
//     and a producer warp, 288 threads (ptxas grants such a kernel 168
//     registers).  Each warpgroup folds its 64 rows of q in f32, splits them
//     and writes them swizzled to shared memory ([hi/lo][half][64][32], 32
//     KB); m_i (bound mode) comes from the f32 q'.  The two warpgroups share
//     every stage: per query row and key 8 bytes of split K and V come from L2
//     (64-row CTAs would stream 16).
//   - K and Vᵀ tiles of 32 keys, 32 KB a stage, travel through a ring of four
//     stages (TMA, a full/empty mbarrier pair a stage).  A stage is held from
//     tile t's scores until tile t's P.V, which runs beside tile t+1's
//     scores, so four stages leave each load a whole tile step to land.
//   - S = Q'.K^T: m64n32k8 x 24 from shared memory, each half of the head dim
//     into its own accumulator, added in f32: each sums half as many
//     truncating additions (below), for the logits of the stable mode's 30x
//     input (|s| 100-200, an f32 ulp 1.5e-5, lse held to 2e-4).  O += P.V: m64n64k8 x 12 with
//     p split in registers as the A fragments.  l sums the f32 p on the FMA
//     pipes.
//   - Per tile a warpgroup splits the last tile's p into fragments, starts
//     S_t and P_{t-1}.V_{t-1} together, takes the softmax of tile t while
//     P.V runs (the scores are only read), then rescales (stable mode).
//   - The tensor cores' f32 sum truncates each addition; summed over the
//     3 x S/8 additions of P.V the bias grows with S, as it did in the f32
//     backward.  So P.V restarts its accumulator every kPromoteTiles tiles
//     and each block is added, rounded to nearest, into f32 sums in shared
//     memory; in the stable mode the sums keep the max they were last
//     brought to, and are rescaled only when they are added to.
//   - The ragged last tile is masked as in bf16; rows past S are not stored.
// Measured (PERF.md, H100 at 700 W, train cross): bound 0.526 ms, stable
// 0.546, from 1.839 / 2.096 on the FMA pipes and 3.2x ahead of the library's
// 1.68; 48% of the TF32 peak in 3xTF32 work.  One TF32 product takes 68% of
// that time, 64-row CTAs +35%, three stages as long as four; without the
// promotion the error at S = 5204 is 13x (6.8e-6).
//
// The FLASH_FWD_* macros exist for da3slam_tpu_torch/tools/flash_fwd_stages.py,
// which builds this file at earlier stages of the bf16 design (a ring too
// short to load ahead, one consumer warpgroup, no overlap) to time what each
// step bought, and times the f32 kernel in changed copies (one TF32 product,
// no promotion, 64-row CTAs, three stages); the library is always built as it
// stands.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/flash_attention.py).

#include "flash_common.cuh"
#include "flash_fwd_tile.cuh"
#include "flash_tf32.cuh"
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
// f32: 3xTF32 on wgmma, a TMA ring of split K and Vᵀ tiles
// ---------------------------------------------------------------------------

constexpr int kF32N = 32;            // keys a ring stage = per online-softmax step
constexpr int kF32Consumers = 2;     // consumer warpgroups (64 query rows each) a CTA
constexpr int kF32Stages = 4;        // ring depth
constexpr int kTf32Terms = 3;        // lo·hi, hi·lo, hi·hi (the last kTf32Terms of them)
constexpr int kPromoteTiles = 8;     // P·V tiles summed on the tensor cores at a time
constexpr int kF32Rows = kWgRows * kF32Consumers;
constexpr int kF32Threads = kWgThreads * kF32Consumers + 32;  // + the producer warp
constexpr int kF32QBytes = 4 * kWgRows * kRowBytes;   // a warpgroup's q' [hi/lo][half][64][32]: 32 KB
constexpr int kF32KBytes = 4 * kF32N * kRowBytes;     // K [hi/lo][half][32 keys][32]: 16 KB
constexpr int kF32VBytes = 2 * kHeadDim * kRowBytes;  // Vᵀ [hi/lo][64 dims][32 keys]: 16 KB
constexpr int kF32StageBytes = kF32KBytes + kF32VBytes;
constexpr int kF32SumFloats = 32 * kWgThreads;        // a warpgroup's promoted O sums
// q' tiles, the ring, the promoted sums, m per row, a full and an empty
// barrier per stage; 1024 more to align the tiles
constexpr int kF32SmemBytes = kGroupBytes + kF32Consumers * kF32QBytes +
                              kF32Stages * kF32StageBytes + kF32Consumers * kF32SumFloats * 4 +
                              kF32Rows * 4 + 2 * kF32Stages * 8;
static_assert(kF32Consumers == 1 || kF32Consumers == 2, "one or two consumer warpgroups");
static_assert(kF32Stages >= 2, "a consumer holds tile t-1's stage (Vᵀ) while it waits for tile t's");
static_assert(kF32SmemBytes <= 232448, "shared memory of one CTA");

// One key tile's softmax step on a thread's 2 x 16 scores, each the sum of the
// two half-dim accumulators s0 + s1 (rows r = 0, 1: t/4 and + 8; element
// 4j + 2r + {0, 1} at columns 8j + c2 + {0, 1}): p = exp2(s - m) in f32, 0 in
// columns >= n_valid (keys past S), and l (this thread's share of its rows'
// sums) += p.  In the stable mode m first moves to the running max, and l and
// what alpha = exp2(m_old - m_new) scales are brought along.  s0 and s1 are
// only read: a wgmma may be in flight.
template <bool kStable>
__device__ __forceinline__ void softmax_tile_f32(const float (&s0)[16], const float (&s1)[16],
                                                 float (&p)[16], float (&m)[2], float (&alpha)[2],
                                                 float (&l)[2], int n_valid, int c2) {
  const bool ragged = n_valid < kF32N;
  auto score = [&](int j, int r, int e) {
    const int i = 4 * j + 2 * r + e;
    return ragged && 8 * j + c2 + e >= n_valid ? -INFINITY : s0[i] + s1[i];
  };
  if constexpr (kStable) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kF32N / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], fmaxf(score(j, r, 0), score(j, r, 1)));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a row's 32 scores are spread over the four threads of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
  }
#pragma unroll
  for (int j = 0; j < kF32N / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        p[i] = ex2(score(j, r, e) - m[r]);
        l[r] += p[i];
      }
    }
  }
}

// s0 + s1 = Q'·Kᵀ in 3xTF32: the warpgroup's 64 rows of q' (split tile at
// `q`) against the stage's 32 keys (at `k`), the two halves of the head dim
// into their own accumulators (each sums half as many truncating additions).
// The small terms first, hi·hi last, as CUTLASS's FastF32 does.
__device__ __forceinline__ void start_scores_f32(float (&s0)[16], float (&s1)[16], uint32_t q,
                                                 uint32_t k) {
#pragma unroll
  for (int term = 3 - kTf32Terms; term < 3; ++term) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wgmma_m64n32k8_tf32_ss(s0, nat_desc(q, kWgRows, term == 0, i),
                             nat_desc(k, kF32N, term == 1, i), term != 3 - kTf32Terms || i != 0);
    }
#pragma unroll
    for (int i = 4; i < 8; ++i) {
      wgmma_m64n32k8_tf32_ss(s1, nat_desc(q, kWgRows, term == 0, i),
                             nat_desc(k, kF32N, term == 1, i), term != 3 - kTf32Terms || i != 4);
    }
  }
  wgmma_commit();
}

// acc (+)= P·V in 3xTF32: the split p fragments against the stage's Vᵀ tile
// (at `vt`).  fresh: the products start a new block of kPromoteTiles tiles
// (acc = the products).
__device__ __forceinline__ void start_pv_f32(float (&acc)[32], const uint32_t (&p_hi)[16],
                                             const uint32_t (&p_lo)[16], uint32_t vt, bool fresh) {
#pragma unroll
  for (int term = 3 - kTf32Terms; term < 3; ++term) {
#pragma unroll
    for (int j = 0; j < kF32N / 8; ++j) {
      wgmma_m64n64k8_tf32_rs(acc, (term == 0 ? p_lo : p_hi) + 4 * j, tr_desc(vt, term == 1, j),
                             !fresh || term != 3 - kTf32Terms || j != 0);
    }
  }
  wgmma_commit();
}

// sum[i * kWgThreads] (this thread's 32 promoted O sums) += acc, rounded to
// nearest.  Stable: the sums are kept at the scale of the max m_sum they last
// saw and are brought to the running max m first (acc is at m already).
template <bool kStable>
__device__ __forceinline__ void promote(float* sum, const float (&acc)[32], const float (&m)[2],
                                        float (&m_sum)[2]) {
  float f[2] = {1.f, 1.f};
  if constexpr (kStable) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      f[r] = ex2(m_sum[r] - m[r]);
      m_sum[r] = m[r];
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i * kWgThreads] = fmaf(sum[i * kWgThreads], f[(i >> 1) & 1], acc[i]);
}

// kStable = false: the bound mode (m from kmax, fixed).  kStable = true: the
// online softmax (kmax unused, m the running max).  k_map and vt_map are over
// the pre-pass's split copies: K natural, V transposed (split_tf32_kernel).
template <bool kStable>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap vt_map, const float* __restrict__ q,
                      const float* __restrict__ kmax, float* __restrict__ o,
                      float* __restrict__ lse, int S, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  // the tiles start on a 1024-byte boundary of the shared address space
  uint8_t* smem = smem_raw + ((kGroupBytes - (smem_addr(smem_raw) & (kGroupBytes - 1))) &
                              (kGroupBytes - 1));
  const uint32_t ring = smem_addr(smem + kF32Consumers * kF32QBytes);
  float* sums = reinterpret_cast<float*>(smem + kF32Consumers * kF32QBytes +
                                         kF32Stages * kF32StageBytes);
  float* m_row = sums + kF32Consumers * kF32SumFloats;
  const uint32_t full_bar = smem_addr(m_row + kF32Rows);
  const uint32_t empty_bar = full_bar + kF32Stages * 8;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_tiles = (S + kF32N - 1) / kF32N;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kF32Stages; ++st) {
      mbar_init(full_bar + st * 8, 1);                   // the producer's arrive.expect_tx
      mbar_init(empty_bar + st * 8, 4 * kF32Consumers);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == kF32Consumers) {
    // ---- producer: one thread keeps the ring full ----
    if (threadIdx.x != kF32Consumers * kWgThreads) return;
    int stage = 0;
    uint32_t parity = 1;  // of the release that frees a stage: none needed in round 0
    for (int t = 0; t < n_tiles; ++t) {
      if (t >= kF32Stages) mbar_wait(empty_bar + stage * 8, parity);
      const uint32_t bar = full_bar + stage * 8;
      const uint32_t dst = ring + stage * kF32StageBytes;
      mbar_arrive_expect_tx(bar, kF32StageBytes);
      tma_load_4d(dst, &k_map, bar, 0, t * kF32N, 0, bh);
      tma_load_4d(dst + kF32KBytes, &vt_map, bar, t * kF32N, 0, 0, bh);
      if (++stage == kF32Stages) {
        stage = 0;
        parity ^= 1;
      }
    }
    return;
  }

  // ---- consumers: 64 query rows a warpgroup ----
  const int tw = threadIdx.x % kWgThreads;
  const int lane = tw & 31;
  const int c2 = (lane & 3) * 2;
  const int wg_row0 = wg * kWgRows;                  // in the CTA's q tile
  const int q_row0 = blockIdx.x * kF32Rows + wg_row0;  // in the sequence
  const size_t row_stride = static_cast<size_t>(H) * kHeadDim;
  const size_t head_base =
      static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kHeadDim;
  uint8_t* q_tile = smem + wg * kF32QBytes;

  // q' = q * scale in f32, split into TF32 hi and lo and written swizzled into
  // the warpgroup's [hi/lo][half][64][32] tile; 16 threads a row, 4 f32 each.
  // m_i (bound mode) from the f32 q', not from its halves.  Rows past S are
  // zeros (m = 0, p = 1: finite, never stored).
  const float kmax_bh = kStable ? 0.f : kmax[bh];
#pragma unroll
  for (int i = 0; i < kWgRows * 16 / kWgThreads; ++i) {
    const int idx = tw + kWgThreads * i;
    const int r = idx >> 4;
    const int c = idx & 15;  // columns 4c .. 4c + 3
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q_row0 + r < S) {
      load4(q + head_base + static_cast<size_t>(q_row0 + r) * row_stride + 4 * c, x);
    }
    uint32_t hi[4], lo[4];
    float n2 = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] *= scale;
      n2 = fmaf(x[e], x[e], n2);
      split_tf32(x[e], hi[e], lo[e]);
    }
    const uint32_t at = swizzled_chunk(r, c & 7);
    const int half = c >> 3;
    *reinterpret_cast<uint4*>(q_tile + half * kWgRows * kRowBytes + at) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(q_tile + (2 + half) * kWgRows * kRowBytes + at) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, off);
    if (c == 0) m_row[wg_row0 + r] = kStable ? kNegInf : sqrtf(n2) * kmax_bh;
  }
  fence_proxy_async();
  named_barrier_sync(kQBarrier + wg, kWgThreads);

  // this thread's two rows of the warpgroup's 64
  const int row_lo = 16 * (tw >> 5) + (lane >> 2);
  float m[2] = {m_row[wg_row0 + row_lo], m_row[wg_row0 + row_lo + 8]};
  float m_sum[2] = {m[0], m[1]};  // the scale of the promoted sums (stable mode)
  float l[2] = {0.f, 0.f};        // this thread's share of its rows' sums of p
  float alpha[2] = {1.f, 1.f};
  // p: the last tile's probabilities in f32.  They are split into the
  // fragments while no wgmma is in flight, and the fragments then stay
  // untouched until the P·V products that read them have finished.
  float s0[16], s1[16], p[16], acc[32];
  uint32_t p_hi[16], p_lo[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float* sum = sums + wg * kF32SumFloats + tw;
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i * kWgThreads] = 0.f;
  const uint32_t q_addr = smem_addr(q_tile);

  mbar_wait(full_bar, 0);
  wgmma_fence();
  start_scores_f32(s0, s1, q_addr, ring);
  wgmma_wait<0>();
  pin(s0);
  pin(s1);
  softmax_tile_f32<kStable>(s0, s1, p, m, alpha, l, S, c2);

  int prev = 0;  // the stage whose Vᵀ tile the pending p belongs to
  uint32_t parity = 0;
#pragma unroll 1
  for (int t = 1; t < n_tiles; ++t) {
    int stage = prev + 1;
    if (stage == kF32Stages) {
      stage = 0;
      parity ^= 1;
    }
    split_fragments(p, p_hi, p_lo);
    mbar_wait(full_bar + stage * 8, parity);
    pin(s0);
    pin(s1);
    pin(acc);
    pin(p_hi);
    pin(p_lo);
    wgmma_fence();
    // tile t's scores and tile t-1's P·V start together
    start_scores_f32(s0, s1, q_addr, ring + stage * kF32StageBytes);
    start_pv_f32(acc, p_hi, p_lo, ring + prev * kF32StageBytes + kF32KBytes,
                 (t - 1) % kPromoteTiles == 0);
    wgmma_wait<1>();  // tile t's scores: their exp2 runs beside P·V
    pin(s0);
    pin(s1);
    softmax_tile_f32<kStable>(s0, s1, p, m, alpha, l, S - t * kF32N, c2);
    wgmma_wait<0>();
    pin(acc);
    pin(p_hi);
    pin(p_lo);
    if (lane == 0) mbar_arrive(empty_bar + prev * 8);  // K and Vᵀ of tile t-1 are consumed
    if constexpr (kStable) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    if ((t - 1) % kPromoteTiles == kPromoteTiles - 1) promote<kStable>(sum, acc, m, m_sum);
    prev = stage;
  }
  split_fragments(p, p_hi, p_lo);
  pin(acc);
  pin(p_hi);
  pin(p_lo);
  wgmma_fence();
  start_pv_f32(acc, p_hi, p_lo, ring + prev * kF32StageBytes + kF32KBytes,
               (n_tiles - 1) % kPromoteTiles == 0);
  wgmma_wait<0>();
  pin(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a row's sum of p is spread over the four threads of a quad
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float f = kStable ? ex2(m_sum[r] - m[r]) : 1.f;
    const float lc = fmaxf(l[r], 1e-30f);
    const int row = q_row0 + row_lo + 8 * r;
    if (row < S) {
      float* orow = o + head_base + static_cast<size_t>(row) * row_stride + c2;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(fmaf(sum[i * kWgThreads], f, acc[i]) / lc,
                        fmaf(sum[(i + 1) * kWgThreads], f, acc[i + 1]) / lc);
      }
      if ((lane & 3) == 0) lse[static_cast<size_t>(bh) * S + row] = m[r] + log2f(lc);
    }
  }
}

template <bool kStable>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, void* lse,
                        void* kmax, void* ws, int B, int S, int H, float scale,
                        cudaStream_t stream) {
  float* ks = static_cast<float*>(ws);
  float* vt = ks + f32_part(B, S, H);
  cudaError_t err = launch_split(k, ks, nullptr, B, S, H, 1.f, stream);
  if (err == cudaSuccess) err = launch_split(v, nullptr, vt, B, S, H, 1.f, stream);
  CUtensorMap k_map, vt_map;
  if (err == cudaSuccess) err = make_nat_map(&k_map, ks, B, S, H, kF32N);
  if (err == cudaSuccess) err = make_tr_map(&vt_map, vt, B, S, H, kF32N);
  // above 48 KB the dynamic shared memory has to be asked for; per device, so per launch
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<kStable>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kF32SmemBytes);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kF32Rows - 1) / kF32Rows, B * H);
  flash_fwd_tf32_kernel<kStable><<<grid, kF32Threads, kF32SmemBytes, stream>>>(
      k_map, vt_map, static_cast<const float*>(q), static_cast<const float*>(kmax),
      static_cast<float*>(o), static_cast<float*>(lse), S, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_key_norm_max(const void* k, void* kmax, int B, int S, int H,
                                cudaStream_t stream) {
  key_norm_max_kernel<T><<<B * H, kNormThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<float*>(kmax), S, H);
  return cudaGetLastError();
}

// by dtype alone; both run on the tensor cores
template <bool kStable>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, void* kmax,
             void* ws, int B, int S, int H, int D, int dtype, float scale, void* stream) {
  if (D != kHeadDim || B <= 0 || S <= 0 || H <= 0 || B * H > 65535 || (dtype != 0 && dtype != 1) ||
      (dtype == 0 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (!kStable) {
    const cudaError_t err = dtype == 0 ? launch_key_norm_max<float>(k, kmax, B, S, H, st)
                                       : launch_key_norm_max<__nv_bfloat16>(k, kmax, B, S, H, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(
      dtype == 0 ? launch_tf32<kStable>(q, k, v, o, lse, kmax, ws, B, S, H, scale, st)
                 : launch_wgmma<kStable>(q, k, v, o, lse, kmax, B, S, H, scale, st));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kmax is a [B*H] f32 workspace; ws (f32
// only, nullptr in bf16) the pre-pass's split copies of K (natural) and V
// (transposed), f32_part() floats each (S_pad = ceil(S/64)*64).  Each returns
// a cudaError_t (0 on success); the caller raises on anything else.
extern "C" int flash_attn_bound_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, void* kmax, void* ws, int B, int S, int H, int D,
                                    int dtype, float scale, void* stream) {
  return dispatch<false>(q, k, v, o, lse, kmax, ws, B, S, H, D, dtype, scale, stream);
}

extern "C" int flash_attn_stable_fwd(const void* q, const void* k, const void* v, void* o,
                                     void* lse, void* ws, int B, int S, int H, int D, int dtype,
                                     float scale, void* stream) {
  return dispatch<true>(q, k, v, o, lse, nullptr, ws, B, S, H, D, dtype, scale, stream);
}
