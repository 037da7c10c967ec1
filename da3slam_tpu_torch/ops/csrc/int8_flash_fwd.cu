// The int8 flash-attention probe forward for Hopper (sm_90a): a running-max
// forward whose two products, Q.K^T and P.V, are integer products on the
// tensor cores (s8 wgmma, exact s32 sums).  It is an instrument for the work
// on the production forwards (flash_attn_fwd.cu), not part of a model's path.
//
// Replaces the TPU kernel tools/int8_flash_probe.py:_int8_kernel of the JAX
// package.  The quantization before it, the layout of V and the de-scale
// after it are plain tensor code (da3slam_tpu_torch/ops/int8_flash.py).
//
// Inputs, folded over (batch, head), Sk = nb * bk keys (S real ones, the rest
// zero rows):
//   q8  [BH, S, 64]   int8   q / max|q_row| * 127, rounded
//   k8  [BH, Sk, 64]  int8   k against its block's largest |k|
//   vt  [BH, 64, Sk]  int8   v against its channel's largest |v|, transposed
//                            (keys contiguous) and the keys permuted inside
//                            each group of 16: position 4c + i holds key
//                            2c + (i & 1) + 8 (i >> 1) (int8_flash.py:value_layout)
//   sq  [BH, S]   f32   max|q_row| / 127 * log2(e)/sqrt(D)
//   sk  [BH, nb]  f32   block max|k| / 127
// Output: o [BH, S, 64] bf16, still in units of v's channel scales.
//
// Math, per query row, block by block of bk keys (m from -1e30, acc = l = 0):
//   s_j   = float(q8 . k8_j) * (sq * sk_b)            int32 -> f32, one multiply
//   m_new = max(m, max_j s_j),  alpha = exp2(m - m_new)
//   p8_j  = trunc(exp2(s_j - m_new) * 127 + 0.5)      in 0..127
//   acc   = acc * alpha + float(sum_j p8_j * v8_j)    int32 over the block -> f32 once
//   l     = l * alpha + float(127 * sum_{j < S} p8_j)
//   O     = round_bf16(acc / max(l, 1e-30))
// bk is part of the function: it groups k's scales and it is the step of the
// running max, so every p8 of a block is rounded against the max over that
// whole block.  Keys in [S, Sk) are zero rows: their score is exactly 0 and
// joins the max, their v8 is 0, and they are kept out of l; that is what the
// TPU kernel's padding does.  The TPU's ones-column in V, its 128-lane padding
// of the head dim and its lane-padded scales serve that machine's tiling and
// are not carried over.  Every float step that the plain version takes
// separately is taken separately here (no fused multiply-add).
//
// What bounds it on an H100: 4*S^2*64*BH integer operations (6.66e11 at
// S = 20816, BH = 6: 0.336 ms at the 1979 TOP/s dense int8 peak) and S^2*BH
// exp2 on the special-function units (2.60e9: 0.673 ms at 16 a clock an SM),
// against ~40 MB of q8/k8/v8/O: the exp2, by a factor of two over the
// products.  The kernel walks each block twice, so its products are 6*S^2*D.
//
// Design: the production bf16 forward's structure (flash_attn_fwd.cu,
// flash_fwd_wgmma_kernel) with a third consumer warpgroup.  One CTA per (bh,
// 192 query rows): three consumer warpgroups of 64 rows and a producer
// warpgroup (512 threads).  One producer thread streams 64-key tiles (K alone
// for pass 1, K and V^T for pass 2; a tile never straddles two blocks)
// through a 128 KB ring by TMA.
//   pass 1: S = Q.K^T (m64n64k32 s8) per tile, only the integer row max kept
//           (no conversion, no exp2); m_new = max(m, float(s_max) * c), as
//           c >= 0;
//   pass 2: S again, p8 from it, and P.V (m64n64k32 s8, p8 as register A
//           fragments) into an s32 accumulator that carries over the block's
//           tiles and is converted once at the block's end; the p8 of tile t
//           are taken while P_{t-1}.V_{t-1} runs.
// The float work of a score, not the products, sets the pace, and three
// warps a sub-partition hide its latency better than two: 512 threads leave
// 128 registers a thread, which fit the 64-key tile's scores, P.V sums and two
// sets of p8 fragments because q8 is read once into registers as the A
// fragments of Q.K^T and the f32 carry, touched once a block, lives in shared
// memory.  Int8 rows of the head dim are 64 bytes: K and V^T tiles are [64, 64
// bytes] in the 64-byte swizzle (the 16-byte chunk c of row r at c ^ ((r >> 1)
// & 3)), which TMA writes and the descriptors below read.  8-bit wgmma reads
// both shared-memory operands K-major only, hence V^T.  The s32 accumulator
// gives thread c = lane % 4 the keys {2c, 2c+1, 8+2c, 9+2c} of each 16, and
// the s8 A fragment takes inner indices 4c..4c+3: with V^T's keys permuted to
// match, a thread's four p8 of one row pack into one A register by byte
// permutes, with no shuffle.  float(s) is the native conversion (I2FP, a
// full-rate pipe on sm_90); trunc(p) for x in [0.5, 127.5] is the low byte of
// round_toward_zero(x + 2^23), which keeps the conversion (F2I) off the
// quarter-rate pipe the exp2 needs.  l sums the integer p8 with __dp4a; the
// padded keys of the last block all score 0, so their p8 is one value and l
// takes out (Sk - S) copies of it, exactly.
// INT8_FLASH_* macros build cut-down or changed copies for
// da3slam_tpu_torch/tools/int8_flash_stages.py; the library sets none.
// Measured (H100 at 700 W, PERF.md section 6): 1.53-1.57 ms at the tool's shape
// (S = 20816, 6 heads, bk 3584) against the 0.673 ms exp2 floor.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/int8_flash.py).

#include <climits>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace flash;
using namespace hopper;

// consumer warpgroups (64 query rows each) a CTA
#ifndef INT8_FLASH_CONSUMERS
#define INT8_FLASH_CONSUMERS 3
#endif
constexpr int kConsumers = INT8_FLASH_CONSUMERS;
#ifdef INT8_FLASH_PRODUCER_WARP
constexpr int kProducerThreads = 32;  // changed copy: the producer one warp, no setmaxnreg
#else
constexpr int kProducerThreads = 128;
#endif
constexpr int kWgRows = 64;
constexpr int kWgThreads = 128;
constexpr int kRowsQ = kWgRows * kConsumers;
constexpr int kThreads = kWgThreads * kConsumers + kProducerThreads;
// registers a consumer thread may take (setmaxnreg) beside a 24-register
// producer warpgroup: 160 for three consumer warpgroups
constexpr int kFreeRegs = (65536 - kWgThreads * 24) / (kWgThreads * kConsumers) & ~7;
constexpr int kConsumerRegs = kFreeRegs < 240 ? kFreeRegs : 240;
constexpr int kRow8 = kHeadDim;  // bytes of an int8 row of the head dim
constexpr int kTile = 64;        // keys a ring stage; bk is a multiple of it
constexpr int kTileBytes = kTile * kRow8;  // a K tile [64][64 B] or a V^T tile [64][64 B]
constexpr int kStageBytes = 2 * kTileBytes;
#ifndef INT8_FLASH_RING_BYTES
#define INT8_FLASH_RING_BYTES 131072
#endif
constexpr int kStages = INT8_FLASH_RING_BYTES / kStageBytes;
static_assert((kStages & (kStages - 1)) == 0, "a power-of-two ring");
constexpr int kAlign = 1024;
constexpr int kAccBytes = kConsumers * kWgRows * kHeadDim * 4;  // the f32 carry, 16 KB a warpgroup
// the carry, the ring, a full and an empty barrier per stage; kAlign more to align
constexpr int kSmemBytes = kAlign + kAccBytes + kStages * kStageBytes + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
constexpr float kNegInf = -1e30f;
#ifdef INT8_FLASH_NO_PASS1
constexpr bool kPass1 = false;  // cut-down copy: m from the carry alone (wrong results)
#else
constexpr bool kPass1 = true;
#endif

// Descriptor of a [rows, 64 bytes] K-major tile in the 64-byte swizzle (the
// 16-byte chunk c of row r at c ^ ((r >> 1) & 3)) at shared address `addr`:
// leading byte offset 16 (unused: a k32 step lies inside the row), stride
// byte offset 512 (from one group of 8 rows to the next), layout type B64.
// The k32 step i starts 32*i bytes on.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (uint64_t{2} << 62);
}
constexpr uint64_t kDescK32Step = 32 >> 4;

// d[64 x 64] (+)= A[64 x 32] . B[64 x 32]^T, s8 in, s32 out (exact).  A is
// four registers of four s8: a[0] row t/4 at inner indices 4(t%4) .. + 3, a[1]
// row t/4 + 8, a[2] and a[3] the same rows 16 further in; B a K-major tile in
// shared memory.  accumulate = 0 overwrites d, whose layout is the f32
// accumulator's (flash_wgmma.cuh: wgmma_m64n64k16_ss).
__device__ __forceinline__ void igmma_rs(uint32_t (&d)[32], const uint32_t* a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : HOPPER_REP32(HOPPER_RW_R, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// s = Q.K^T: the warpgroup's 64 q rows, q8 as A fragments (qa[4kk + r]: row
// t/4 + 8(r & 1), bytes 32kk + 16(r >> 1) + 4(t%4) .. + 3), against the K tile
// at `k_tile`, committed as one group
__device__ __forceinline__ void start_scores(uint32_t (&s)[32], const uint32_t (&qa)[8],
                                             uint32_t k_tile) {
  const uint64_t k_desc = sw64_desc(k_tile);
#ifndef INT8_FLASH_NO_PRODUCTS
#pragma unroll
  for (int i = 0; i < kRow8 / 32; ++i) igmma_rs(s, qa + 4 * i, k_desc + i * kDescK32Step, i);
#endif
  wgmma_commit();
}

// pv (+)= P.V: p8 as A fragments against the V^T tile at `v_tile`, committed
// as one group; accumulate = 0 starts the block's sums
__device__ __forceinline__ void start_pv(uint32_t (&pv)[32], const uint32_t (&p)[8],
                                         uint32_t v_tile, int accumulate) {
  const uint64_t v_desc = sw64_desc(v_tile);
#ifndef INT8_FLASH_NO_PRODUCTS
#pragma unroll
  for (int i = 0; i < kTile / 32; ++i) {
    igmma_rs(pv, p + 4 * i, v_desc + i * kDescK32Step, accumulate | i);
  }
#endif
  wgmma_commit();
}

// p8 of one score: the low byte of the result, the rest of it ignored.  The
// float steps are the plain version's, each rounded on its own.
__device__ __forceinline__ uint32_t p8_bits(uint32_t si, float c, float m) {
#ifdef INT8_FLASH_PRODUCTS_ONLY
  return si;  // cut-down copy: no float work (wrong results)
#else
#ifdef INT8_FLASH_EXACT_I2F
  // float(s), exactly, by an integer and a float add: |s| < 2^22
  const float sf = __fsub_rn(__uint_as_float(si + 0x4B400000u), 12582912.f);
#else
  const float sf = __int2float_rn(static_cast<int>(si));  // I2FP: a full-rate pipe on sm_90
#endif
  const float e = ex2(__fsub_rn(__fmul_rn(sf, c), m));
  const float x = __fadd_rn(__fmul_rn(e, 127.f), 0.5f);
#ifdef INT8_FLASH_NATIVE_F2I
  return static_cast<uint32_t>(__float2int_rz(x));
#else
  // 2^23 + trunc(x): x in [0.5, 127.5], whose truncation is the low byte
  return __float_as_uint(__fadd_rz(x, 8388608.f));
#endif
#endif
}

// A tile's p8 as the A fragments of P.V (p[4kk + r]: row half r & 1, keys
// 32kk + 16(r >> 1) + {2c, 2c+1, 8+2c, 9+2c}, the V^T positions 4c .. 4c+3 of
// that group of 16), and this thread's share of each row's sum of p8
__device__ __forceinline__ void tile_p8(const uint32_t (&s)[32], uint32_t (&p)[8],
                                        const float (&c)[2], const float (&m)[2],
                                        int (&psum)[2]) {
#pragma unroll
  for (int kk = 0; kk < kTile / 32; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r & 1;
      const int j = 4 * kk + 2 * (r >> 1);
      const uint32_t b0 = p8_bits(s[4 * j + 2 * h], c[h], m[h]);
      const uint32_t b1 = p8_bits(s[4 * j + 2 * h + 1], c[h], m[h]);
      const uint32_t b2 = p8_bits(s[4 * j + 4 + 2 * h], c[h], m[h]);
      const uint32_t b3 = p8_bits(s[4 * j + 4 + 2 * h + 1], c[h], m[h]);
      const uint32_t w = __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                                     0x5410);
      p[4 * kk + r] = w;
      psum[h] = __dp4a(static_cast<int>(w), 0x01010101, psum[h]);
    }
  }
}

__device__ __forceinline__ int quad_max(int x) {
  x = max(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return max(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ int quad_sum(int x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(kThreads, 1)
int8_flash_kernel(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, const int8_t* __restrict__ q8,
                  const float* __restrict__ sq, const float* __restrict__ sk,
                  __nv_bfloat16* __restrict__ o, int S, int Sk, int bk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const uint32_t ring = smem_addr(smem + kAccBytes);
  const uint32_t full_bar = ring + kStages * kStageBytes;
  const uint32_t empty_bar = full_bar + kStages * 8;

  const int bh = blockIdx.y;
  const int nb = Sk / bk;
  const int nt = bk / kTile;

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
    // ---- producer: one thread keeps the ring full, block by block: pass 1's
    // K tiles, then pass 2's K and V^T tiles ----
    if constexpr (kProducerThreads == kWgThreads) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    }
    if (threadIdx.x == kConsumers * kWgThreads) {
      int stage = 0;
      uint32_t parity = 1;
      int n = 0;
      for (int b = 0; b < nb; ++b) {
        for (int pass = kPass1 ? 0 : 1; pass < 2; ++pass) {
          for (int t = 0; t < nt; ++t, ++n) {
            if (n >= kStages) mbar_wait(empty_bar + stage * 8, parity);
            const uint32_t bar = full_bar + stage * 8;
            const uint32_t dst = ring + stage * kStageBytes;
            const int key0 = b * bk + t * kTile;
            mbar_arrive_expect_tx(bar, pass ? kStageBytes : kTileBytes);
            tma_load_4d(dst, &k_map, bar, 0, key0, bh, 0);
            if (pass) tma_load_4d(dst + kTileBytes, &v_map, bar, key0, 0, bh, 0);
            if (++stage == kStages) {
              stage = 0;
              parity ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    if constexpr (kProducerThreads == kWgThreads) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    }
    const int tw = threadIdx.x % kWgThreads;
    const int lane = tw & 31;
    const int c2 = (lane & 3) * 2;
    const int q_row0 = blockIdx.x * kRowsQ + wg * kWgRows;
    // this thread's two rows of the warpgroup's 64
    const int row_lo = 16 * (tw >> 5) + (lane >> 2);

    // q8 as the A fragments of Q.K^T, straight from global memory; rows past
    // S are zeros (finite, never stored)
    uint32_t qa[8];
    float sq_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q_row0 + row_lo + 8 * r;
      const int8_t* qrow = q8 + (static_cast<size_t>(bh) * S + row) * kRow8 + 4 * (lane & 3);
#pragma unroll
      for (int g = 0; g < 4; ++g) {  // bytes 16g + 4c .. + 3: k32 step g / 2, group g % 2
        qa[4 * (g >> 1) + 2 * (g & 1) + r] =
            row < S ? *reinterpret_cast<const uint32_t*>(qrow + 16 * g) : 0u;
      }
      sq_r[r] = row < S ? sq[static_cast<size_t>(bh) * S + row] : 0.f;
    }
    // the f32 carry lives in shared memory (it is touched once a block):
    // element i of this thread at acc_s[i * kWgThreads]
    float* acc_s = reinterpret_cast<float*>(smem) + wg * 32 * kWgThreads + tw;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_s[i * kWgThreads] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    uint32_t s[32], pv[32], pa[8], pb[8];

    // ring step i (counted over the whole launch) sits in stage i % kStages
    // with full-barrier parity (i / kStages) & 1
    auto wait_full = [&](int i) { mbar_wait(full_bar + (i % kStages) * 8, (i / kStages) & 1); };
    auto release = [&](int i) {
      if (lane == 0) mbar_arrive(empty_bar + (i % kStages) * 8);
    };
    auto k_tile = [&](int i) { return ring + (i % kStages) * kStageBytes; };
    int n = 0;  // ring steps before this pass

    for (int b = 0; b < nb; ++b) {
      const float skb = sk[static_cast<size_t>(bh) * nb + b];
      const float c[2] = {__fmul_rn(sq_r[0], skb), __fmul_rn(sq_r[1], skb)};

      // pass 1: the block's largest integer score of each row.  c >= 0, so
      // the largest float(s) * c is float(largest s) * c.
      int s_max[2] = {INT_MIN, INT_MIN};
      if constexpr (kPass1) {
        for (int t = 0; t < nt; ++t) {
          wait_full(n + t);
          wgmma_fence();
          start_scores(s, qa, k_tile(n + t));
          wgmma_wait<0>();
          pin(s);
          release(n + t);
#ifndef INT8_FLASH_PRODUCTS_ONLY
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s_max[0] = max(s_max[0], max(static_cast<int>(s[4 * j]),
                                         static_cast<int>(s[4 * j + 1])));
            s_max[1] = max(s_max[1], max(static_cast<int>(s[4 * j + 2]),
                                         static_cast<int>(s[4 * j + 3])));
          }
#endif
        }
        n += nt;
      }
      float m_new[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float top = __fmul_rn(__int2float_rn(quad_max(s_max[r])), c[r]);
        m_new[r] = fmaxf(m[r], top);
        alpha[r] = exp2f(__fsub_rn(m[r], m_new[r]));
      }

      // pass 2: p8 against the block's max, and the integer P.V sums.  Step
      // t issues S_t and P_{t-1}.V_{t-1} and takes p8 of S_t while P.V runs.
      // The A fragments alternate between two sets (pa, pb): copying the next
      // tile's into the current one merges them, and ptxas then serializes
      // every wgmma (C7513).
      int psum[2] = {0, 0};
      wait_full(n);
      wgmma_fence();
      start_scores(s, qa, k_tile(n));
      wgmma_wait<0>();
      pin(s);
      tile_p8(s, pa, c, m_new, psum);
      auto step = [&](uint32_t (&p_cur)[8], uint32_t (&p_next)[8], int t) {
        wait_full(n + t);
        pin(s);
        pin(pv);
        pin(p_cur);
        wgmma_fence();
        start_scores(s, qa, k_tile(n + t));
        start_pv(pv, p_cur, k_tile(n + t - 1) + kTileBytes, t > 1);
        wgmma_wait<1>();
        pin(s);
        tile_p8(s, p_next, c, m_new, psum);
        wgmma_wait<0>();
        pin(pv);
        pin(p_cur);
        release(n + t - 1);
      };
      // the last tile's P.V
      auto finish = [&](uint32_t (&p_last)[8]) {
        pin(pv);
        pin(p_last);
        wgmma_fence();
        start_pv(pv, p_last, k_tile(n + nt - 1) + kTileBytes, nt > 1);
        wgmma_wait<0>();
        pin(pv);
        release(n + nt - 1);
      };
      int t = 1;
      for (; t + 1 < nt; t += 2) {
        step(pa, pb, t);
        step(pb, pa, t + 1);
      }
      if (t < nt) {
        step(pa, pb, t);
        finish(pb);
      } else {
        finish(pa);
      }
      n += nt;

      // int32 -> f32 once a block.  The last block's padded keys all score
      // exactly 0: l leaves out (Sk - S) copies of that p8.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int total = quad_sum(psum[r]);
        if (b == nb - 1 && Sk > S) {
          total -= (Sk - S) * static_cast<int>(p8_bits(0u, c[r], m_new[r]) & 0xffu);
        }
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), __int2float_rn(total * 127));
        m[r] = m_new[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc_s[i * kWgThreads] = __fadd_rn(__fmul_rn(acc_s[i * kWgThreads], alpha[(i >> 1) & 1]),
                                          __int2float_rn(static_cast<int>(pv[i])));
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lc = fmaxf(l[r], 1e-30f);
      const int row = q_row0 + row_lo + 8 * r;
      if (row < S) {
        __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * S + row) * kHeadDim + c2;
#pragma unroll
        for (int j = 0; j < kHeadDim / 8; ++j) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(__fdiv_rn(acc_s[(4 * j + 2 * r) * kWgThreads], lc),
                        __fdiv_rn(acc_s[(4 * j + 2 * r + 1) * kWgThreads], lc));
        }
      }
    }
  }
}

// Tensor map over a [BH, rows, inner] int8 array as (inner, rows, BH, 1),
// boxes of [64 rows, 64 bytes] in the 64-byte swizzle: k8 (inner 64, rows Sk)
// and vt (inner Sk, rows 64).
cudaError_t make_int8_tile_map(CUtensorMap* map, const void* base, int inner, int rows, int BH) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH), 1};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(inner);
  const cuuint64_t strides[3] = {row_bytes, row_bytes * rows, row_bytes * rows * BH};
  const cuuint32_t box[4] = {kTile, kTile, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims,
                              strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Every tensor is contiguous and 16-byte aligned; bk is a multiple of 64 and
// divides Sk; 127 * 127 * bk < 2^31 (the s32 sums are exact).  Returns a
// cudaError_t (0 on success); the caller raises on anything else.
extern "C" int int8_flash_fwd(const void* q8, const void* k8, const void* vt, const void* sq,
                              const void* sk, void* o, int BH, int S, int Sk, int bk,
                              void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || bk <= 0 || bk % kTile != 0 || bk > 131072 || Sk < S ||
      Sk % bk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap k_map, v_map;
  cudaError_t err = make_int8_tile_map(&k_map, k8, kRow8, Sk, BH);
  if (err == cudaSuccess) err = make_int8_tile_map(&v_map, vt, Sk, kHeadDim, BH);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(int8_flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRowsQ - 1) / kRowsQ, BH);
  int8_flash_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      k_map, v_map, static_cast<const int8_t*>(q8), static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<__nv_bfloat16*>(o), S, Sk, bk);
  return static_cast<int>(cudaGetLastError());
}
