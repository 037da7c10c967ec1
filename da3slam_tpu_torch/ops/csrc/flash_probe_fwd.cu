// The flash-forward probe kernels for Hopper (sm_90a): one template on the
// tensor cores, three C entries.  They are instruments for the work on the
// production forwards (flash_attn_fwd.cu), not part of a user's path.
//
// Replaces the TPU probe kernels of the JAX package's tools:
//   - tools/flash_nomax_probe.py:_kernel   -> flash_probe_nomax
//     the ceiling of a max-free forward: a literal constant m = 15 in place of
//     the per-row norm bound, no scale, no mask, no lse;
//   - tools/flash_bound_bisect.py:_kernel  -> flash_probe_bisect
//     the steps from that ceiling to the production bound forward: an lse
//     output (A), m as a per-row input (B), and three ways of keeping the
//     padded keys [seq_k, Sk) out of the sums (C, D, E);
//   - tools/flash_lab.py:_kernel           -> flash_probe_lab
//     the online-softmax forward in its first form ("old": every key tested
//     against seq_k, the denominator summed from the unrounded f32 p) and its
//     current one ("new": only tiles that reach past seq_k are tested, the
//     denominator summed from the rounded p; "qs": the scale folded into q).
//
// Math.  q is [BH, Sq, 64], k and v are [BH, Sk, 64], bf16, already folded
// over (batch, head); Sq and Sk may differ.  Keys j >= seq_k are padding that
// the caller's arrays still hold.  s_ij = q_i . k_j in f32 from the bf16
// values.
//   const / row m (nomax, bisect):  p_ij = round_bf16(exp2(s_ij - m_i)),
//       m_i = 15 or m[bh, i];   acc = sum_j p_ij v_j,  l = sum_j p_ij
//       mask none:      every key of the array counts, padding included
//       mask last:      keys >= seq_k get p = 0, tested only in a tile that
//                       reaches past seq_k
//       mask every:     the same p, the test on every key of every tile
//       mask subtract:  every key counts, then l -= (Sk - seq_k) * exp2(-m_i):
//                       exact when the padded k rows are zeros (s = 0)
//   running m (lab), per tile of 128 keys, m from -1e30:
//       s_ij = round_f32(s_ij * log2(e)/sqrt(D)) (old, new: a multiply of its
//       own, not fused into the exp2's subtraction, so rounded twice as the
//       plain version rounds it), or q was folded to q' = round_bf16(q *
//       log2(e)/sqrt(D)) first (qs); keys >= seq_k: p = 0
//       m_new = max(m, max_j s_ij), alpha = exp2(m - m_new),
//       pf_ij = exp2(s_ij - m_new), p_ij = round_bf16(pf_ij),
//       acc = alpha*acc + sum_j p_ij v_j,
//       l = alpha*l + sum_j pf_ij (old)  or  sum_j p_ij (new, qs)
//   O_i = round_bf16(acc / max(l, 1e-30)),  lse_i = m_i + log2(max(l, 1e-30))
// In every mode the keys >= Sk (the zeros TMA fills the ragged last tile
// with) get p = 0, and p is rounded to bf16 before the PV sum, as the TPU
// kernels cast it for their matrix unit.  The TPU's ones-column in V, its
// 128-lane padding of the head dim and its lane-padded m and l scratch serve
// that machine's tiling and are not carried over.  The lab's 128-key tile is
// where p is rounded against the running max (ops/flash_probes.py:LAB_BLOCK_K,
// the TPU tool's bk = 128 in the tests).
//
// What bounds it on an H100: 4*Sq*Sk*64*BH FLOP (7.1e11 at the padded
// Sq = Sk = 21504, BH = 6: 0.72 ms at the 989 TFLOP/s bf16 peak) against ~66
// MB of q/k/v/O (0.02 ms at 3.35 TB/s): the operations, by a factor of ~36.
// Beside them Sq*Sk*BH exp2 on the special-function units (16 a clock an SM:
// the same 0.72 ms), as in the production forward.
//
// Design: the production bf16 forward's (flash_attn_fwd.cu,
// flash_fwd_wgmma_kernel), with its tile step (flash_fwd_tile.cuh) taking the
// variant's knobs.  One CTA per (bh, 128 query rows): two consumer
// warpgroups of 64 rows and a producer warpgroup (384 threads), K and V tiles
// of 128 keys through a three-stage TMA ring over tensor maps (64, 1, Sk,
// BH), S_j = Q.K_j^T (m64n128k16) started beside P_{j-1}.V_{j-1}
// (m64n64k16, p as register A fragments) and the softmax of tile j taken
// while P.V runs.  The grid and the store take Sq, the key loop Sk.  q comes
// by the consumers' loads: copied as it is, or folded (qs).  The rounded-p
// denominators sum on the tensor cores (add_row_sums); lab old sums its f32
// p on the FMA pipes, a partial sum per thread that is rescaled with acc and
// summed over the quad at the end.  The per-key test of mask "every" runs on
// every tile (a runtime bound the compiler cannot fold), against one
// per-thread limit: the column's own sum kept a register live and spilled
// (these kernels sit at the 168-register cap of 384 threads, as the
// production forward does).  `nh` only checks BH % nh: every CTA walks one
// head (the TPU's heads-per-call knob schedules that machine and does not
// change the result).
// Measured (H100 at 700 W, chip_smoke.py; PERF.md section 6): at the tools'
// shapes 1.6-1.75 ms for nomax and bisect A-E and 1.85-1.96 for the lab,
// from 30-37 on the f32 FMA pipes, beside SDPA's 1.5-1.7 and a 0.65-0.72 ms
// bound; the every-key test costs nothing measurable (D = C), and the lab's
// f32 sum on the FMA pipes (old) runs ~4% ahead of the rounded-p sum on
// mma.sync (new), which shares the tensor cores with the products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/flash_probes.py).

#include "flash_common.cuh"
#include "flash_fwd_tile.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace flash;
using namespace hopper;
using T = __nv_bfloat16;

constexpr int kConsumers = 2;   // consumer warpgroups (64 query rows each) a CTA
constexpr int kStages = 3;      // K/V ring depth
constexpr int kQBarrier = 1;    // named barrier 1 + wg closes a warpgroup's q tile
constexpr int kWgRows = 64;
constexpr int kWgThreads = 128;
constexpr int kRowsQ = kWgRows * kConsumers;
constexpr int kThreads = kWgThreads * (kConsumers + 1);
constexpr int kTileBytes = kTileK * kRowBytes;  // one K or V tile: 16 KB
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kQBytes = kRowsQ * kRowBytes;
// q tile, the ring, a full and an empty barrier per stage; 1024 more to align
constexpr int kSmemBytes = kGroupBytes + kQBytes + kStages * kStageBytes + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
constexpr float kNegInf = -1e30f;  // the lab's m before the first tile

enum MSource { kMConst, kMRow, kMRunning };
enum MaskMode { kMaskNone, kMaskLast, kMaskEvery, kMaskSubtract };
enum ScaleMode { kScaleNone, kScaleS, kScaleQ };

// One key tile of a probe: the softmax step (flash_fwd_tile.cuh) with the
// variant's knobs, then the denominator: rescaled by alpha (running m), plus
// the rounded p on the tensor cores or, for the f32 p (lab old), this
// thread's share on the FMA pipes.  Keys at n_valid and beyond get p = 0.
template <MSource kM, MaskMode kMask, ScaleMode kScale, bool kRoundedDenom>
__device__ __forceinline__ void probe_step(const float (&s)[64], uint32_t (&p)[32], float (&m)[2],
                                           float (&alpha)[2], float (&l)[4], float (&lf)[2],
                                           int n_valid, int c2, float scale) {
  constexpr bool kStable = kM == kMRunning;
  float psum[2];
  softmax_tile<kStable, kMask == kMaskEvery, kScale == kScaleS, !kRoundedDenom>(
      s, p, m, alpha, n_valid, c2, scale, psum);
  if constexpr (kStable) {
#pragma unroll
    for (int i = 0; i < 4; ++i) l[i] *= alpha[i >> 1];
  }
  if constexpr (kRoundedDenom) {
    add_row_sums(l, p);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) lf[r] = lf[r] * alpha[r] + psum[r];
  }
}

template <MSource kM, MaskMode kMask, ScaleMode kScale, bool kRoundedDenom>
__global__ void __launch_bounds__(kThreads, 1)
flash_probe_kernel(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const T* __restrict__ q,
                   const float* __restrict__ m_in, T* __restrict__ o, float* __restrict__ lse,
                   int Sq, int Sk, int seq_k, float scale, float m_const) {
  constexpr bool kStable = kM == kMRunning;
  constexpr bool kSumF32 = !kRoundedDenom;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kGroupBytes - (smem_addr(smem_raw) & (kGroupBytes - 1))) &
                              (kGroupBytes - 1));
  uint8_t* q_tile = smem;
  const uint32_t ring = smem_addr(smem + kQBytes);
  const uint32_t full_bar = ring + kStages * kStageBytes;
  const uint32_t empty_bar = full_bar + kStages * 8;

  const int bh = blockIdx.y;
  const int n_tiles = (Sk + kTileK - 1) / kTileK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + st * 8, 1);
      mbar_init(empty_bar + st * 8, 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * kWgThreads) {
      int stage = 0;
      uint32_t parity = 1;
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= kStages) mbar_wait(empty_bar + stage * 8, parity);
        const uint32_t bar = full_bar + stage * 8;
        const uint32_t dst = ring + stage * kStageBytes;
        mbar_arrive_expect_tx(bar, kStageBytes);
        tma_load_4d(dst, &k_map, bar, 0, 0, t * kTileK, bh);
        tma_load_4d(dst + kTileBytes, &v_map, bar, 0, 0, t * kTileK, bh);
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tw = threadIdx.x % kWgThreads;
    const int lane = tw & 31;
    const int c2 = (lane & 3) * 2;
    const int wg_row0 = wg * kWgRows;
    const int q_row0 = blockIdx.x * kRowsQ + wg_row0;
    const size_t head_base = static_cast<size_t>(bh) * Sq * kHeadDim;

    // q (qs: folded to round_bf16(q * scale)) swizzled into shared memory, 8
    // threads a row; rows past Sq are zeros (finite, never stored)
#pragma unroll
    for (int i = 0; i < kWgRows * 8 / kWgThreads; ++i) {
      const int idx = tw + kWgThreads * i;
      const int r = idx >> 3;
      const int chunk = idx & 7;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (q_row0 + r < Sq) {
        const T* src = q + head_base + static_cast<size_t>(q_row0 + r) * kHeadDim + chunk * 8;
        if constexpr (kScale == kScaleQ) {
          float x[8];
          Vec16<T>::load(src, x);
          w = make_uint4(pack_bf16(x[0] * scale, x[1] * scale),
                         pack_bf16(x[2] * scale, x[3] * scale),
                         pack_bf16(x[4] * scale, x[5] * scale),
                         pack_bf16(x[6] * scale, x[7] * scale));
        } else {
          w = *reinterpret_cast<const uint4*>(src);
        }
      }
      *reinterpret_cast<uint4*>(q_tile + swizzled_chunk(wg_row0 + r, chunk)) = w;
    }
    fence_proxy_async();
    named_barrier_sync(kQBarrier + wg, kWgThreads);

    // this thread's two rows of the warpgroup's 64
    const int row_lo = 16 * (tw >> 5) + (lane >> 2);
    float m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q_row0 + row_lo + 8 * r;
      if constexpr (kM == kMConst) m[r] = m_const;
      if constexpr (kM == kMRow) m[r] = row < Sq ? m_in[static_cast<size_t>(bh) * Sq + row] : 0.f;
      if constexpr (kM == kMRunning) m[r] = kNegInf;
    }
    float l[4] = {0.f, 0.f, 0.f, 0.f};  // rounded p: add_row_sums
    float lf[2] = {0.f, 0.f};           // f32 p (lab old): this thread's share
    float alpha[2] = {1.f, 1.f};
    float s[64];
    float acc[32];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    // keys of tile t below this many count; masks last and every test
    // against seq_k, the others only against the array's end
    const int key_end = kMask == kMaskLast || kMask == kMaskEvery ? seq_k : Sk;

    const uint64_t q_desc = tile_desc(smem_addr(q_tile) + wg_row0 * kRowBytes);

    mbar_wait(full_bar, 0);
    wgmma_fence();
    start_scores(s, q_desc, ring);
    wgmma_wait<0>();
    pin(s);
    probe_step<kM, kMask, kScale, kRoundedDenom>(s, p, m, alpha, l, lf, key_end, c2, scale);

    int prev = 0;
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
      wgmma_wait<1>();
      pin(s);
      uint32_t p_next[32];
      probe_step<kM, kMask, kScale, kRoundedDenom>(s, p_next, m, alpha, l, lf,
                                                  key_end - t * kTileK, c2, scale);
      wgmma_wait<0>();
      pin(acc);
      pin(p);
      if (lane == 0) mbar_arrive(empty_bar + prev * 8);
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
      float lr = l[2 * r];
      if constexpr (kSumF32) {
        // a row's sum is spread over the four threads of a quad
        lr = lf[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      }
      if constexpr (kMask == kMaskSubtract) lr -= static_cast<float>(Sk - seq_k) * exp2f(-m[r]);
      const float lc = fmaxf(lr, 1e-30f);
      const int row = q_row0 + row_lo + 8 * r;
      if (row < Sq) {
        T* orow = o + head_base + static_cast<size_t>(row) * kHeadDim + c2;
#pragma unroll
        for (int j = 0; j < kHeadDim / 8; ++j) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(acc[4 * j + 2 * r] / lc, acc[4 * j + 2 * r + 1] / lc);
        }
        if (lse != nullptr && (lane & 3) == 0) {
          lse[static_cast<size_t>(bh) * Sq + row] = m[r] + log2f(lc);
        }
      }
    }
  }
}

template <MSource kM, MaskMode kMask, ScaleMode kScale, bool kRoundedDenom>
int launch(const void* q, const void* k, const void* v, const void* m_in, void* o, void* lse,
           int BH, int Sq, int Sk, int seq_k, int nh, float scale, float m_const,
           void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || seq_k <= 0 || seq_k > Sk || nh <= 0 || BH % nh != 0 ||
      BH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // k and v as (64, 1, Sk, BH): the production forward's map with H = 1
  CUtensorMap k_map, v_map;
  cudaError_t err = make_head_tile_map(&k_map, k, BH, Sk, 1, kTileK);
  if (err == cudaSuccess) err = make_head_tile_map(&v_map, v, BH, Sk, 1, kTileK);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_probe_kernel<kM, kMask, kScale, kRoundedDenom>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kRowsQ - 1) / kRowsQ, BH);
  flash_probe_kernel<kM, kMask, kScale, kRoundedDenom>
      <<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      k_map, v_map, static_cast<const T*>(q), static_cast<const float*>(m_in),
      static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk, seq_k, scale, m_const);
  return static_cast<int>(cudaGetLastError());
}

constexpr float kProbeM = 15.f;  // the tools' literal stand-in for the norm bound

}  // namespace

// Every tensor is bf16, contiguous and 16-byte aligned; m and lse are f32
// [BH, Sq].  Each entry returns a cudaError_t (0 on success); the caller
// raises on anything else.

extern "C" int flash_probe_nomax(const void* q, const void* k, const void* v, void* o, int BH,
                                 int Sq, int Sk, void* stream) {
  return launch<kMConst, kMaskNone, kScaleNone, true>(q, k, v, nullptr, o, nullptr, BH, Sq, Sk,
                                                      Sk, 1, 1.f, kProbeM, stream);
}

// variant: 0 = A (constant m), 1 = B (m input), 2 = C (+ mask on the last
// tile), 3 = D (mask on every key), 4 = E (subtract the padding's share)
extern "C" int flash_probe_bisect(const void* q, const void* k, const void* v, const void* m,
                                  void* o, void* lse, int BH, int Sq, int Sk, int seq_k,
                                  int variant, void* stream) {
  switch (variant) {
    case 0:
      return launch<kMConst, kMaskNone, kScaleNone, true>(q, k, v, nullptr, o, lse, BH, Sq, Sk,
                                                          seq_k, 1, 1.f, kProbeM, stream);
    case 1:
      return launch<kMRow, kMaskNone, kScaleNone, true>(q, k, v, m, o, lse, BH, Sq, Sk, seq_k, 1,
                                                        1.f, 0.f, stream);
    case 2:
      return launch<kMRow, kMaskLast, kScaleNone, true>(q, k, v, m, o, lse, BH, Sq, Sk, seq_k, 1,
                                                        1.f, 0.f, stream);
    case 3:
      return launch<kMRow, kMaskEvery, kScaleNone, true>(q, k, v, m, o, lse, BH, Sq, Sk, seq_k,
                                                         1, 1.f, 0.f, stream);
    case 4:
      return launch<kMRow, kMaskSubtract, kScaleNone, true>(q, k, v, m, o, lse, BH, Sq, Sk,
                                                            seq_k, 1, 1.f, 0.f, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// variant: 0 = old, 1 = new, 2 = qs.  scale = log2(e)/sqrt(D).
extern "C" int flash_probe_lab(const void* q, const void* k, const void* v, void* o, int BH,
                               int Sq, int Sk, int seq_k, int variant, int nh, float scale,
                               void* stream) {
  switch (variant) {
    case 0:
      return launch<kMRunning, kMaskEvery, kScaleS, false>(q, k, v, nullptr, o, nullptr, BH, Sq,
                                                           Sk, seq_k, nh, scale, 0.f, stream);
    case 1:
      return launch<kMRunning, kMaskLast, kScaleS, true>(q, k, v, nullptr, o, nullptr, BH, Sq,
                                                         Sk, seq_k, nh, scale, 0.f, stream);
    case 2:
      return launch<kMRunning, kMaskLast, kScaleQ, true>(q, k, v, nullptr, o, nullptr, BH, Sq,
                                                         Sk, seq_k, nh, scale, 0.f, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
