// One 128-key tile of the bf16 flash forward on the tensor cores, shared by
// the production forwards (flash_attn_fwd.cu: flash_fwd_wgmma_kernel) and the
// probe forwards (flash_probe_fwd.cu: flash_probe_kernel): the score product
// S = Q'.K^T, the softmax step, the row sums of the rounded p, and O += P.V.
// A warpgroup owns 64 query rows; a K or V tile is [128 keys, 64] bf16 in the
// 128-byte swizzle (flash_wgmma.cuh).
//
// The softmax step's template knobs beyond kStable serve the probes only;
// their defaults are the production kernel's step, instruction for
// instruction.

#pragma once

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace flash {

constexpr int kTileK = 128;  // keys per ring stage = per online-softmax step

// One key tile's softmax step on a thread's 64 scores (rows r = 0, 1: t/4 and
// + 8; s[4j + 2r + {0, 1}] at columns 8j + c2 + {0, 1}): p = round_bf16(exp2(s
// - m)), 0 in columns >= n_valid (keys past S), as the A fragments of the P.V
// product: the score accumulator's layout is, 16 columns at a time, the
// A-fragment layout.  In the stable mode m moves to the running max and alpha
// = exp2(m_old - m_new) is what acc and l must be scaled by.  s is only read:
// a wgmma may be in flight, and ptxas serialises the wgmmas of a kernel that
// writes accumulator registers meanwhile (C7515).
//
// The probes' knobs:
//   kTestEvery  test every column against n_valid, whatever the tile (the
//               test otherwise runs only in a tile with fewer valid keys);
//   kScaleS     the score is round_f32(s * scale) (__fmul_rn: never fused
//               into the exp2's subtraction, so rounded twice, as the plain
//               version rounds it), before the max and the exp2;
//   kSumF32     psum[r] = this thread's sum of its row r's unrounded f32 p,
//               for a denominator taken on the FMA pipes.
template <bool kStable, bool kTestEvery = false, bool kScaleS = false, bool kSumF32 = false>
__device__ __forceinline__ void softmax_tile(const float (&s)[64], uint32_t (&p)[32],
                                             float (&m)[2], float (&alpha)[2], int n_valid,
                                             int c2, float scale = 1.f, float* psum = nullptr) {
  const bool ragged = n_valid < kTileK;
  // the every-key test against one per-thread limit: a register fewer live
  // through the step than the column's own sum (its kernels are at the
  // 168-register cap)
  const int lim = n_valid - c2;
  // column 8j + c2 + e of row r, or -inf past the last key
  auto score = [&](int j, int r, int e) {
    const float x = kScaleS ? __fmul_rn(s[4 * j + 2 * r + e], scale) : s[4 * j + 2 * r + e];
    if constexpr (kTestEvery) return 8 * j + e >= lim ? -INFINITY : x;
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
      alpha[r] = hopper::ex2(m[r] - m_new);
      m[r] = m_new;
    }
  }
  if constexpr (kSumF32) {
    psum[0] = 0.f;
    psum[1] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (kSumF32) {
        const float a = hopper::ex2(score(j, r, 0) - m[r]);
        const float b = hopper::ex2(score(j, r, 1) - m[r]);
        psum[r] += a;
        psum[r] += b;
        p[4 * (j >> 1) + 2 * (j & 1) + r] = hopper::pack_bf16(a, b);
      } else {
        p[4 * (j >> 1) + 2 * (j & 1) + r] = hopper::pack_bf16(
            hopper::ex2(score(j, r, 0) - m[r]), hopper::ex2(score(j, r, 1) - m[r]));
      }
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
  const uint64_t k_desc = hopper::tile_desc(k_tile);
#pragma unroll
  for (int i = 0; i < kHeadDim / 16; ++i) {
    hopper::wgmma_m64n128k16_ss(s, q_desc + i * hopper::kDescKMajorStep,
                                k_desc + i * hopper::kDescKMajorStep, i != 0);
  }
  hopper::wgmma_commit();
}

// acc += P.V: p as A fragments against the V tile at `v_tile`
__device__ __forceinline__ void start_pv(float (&acc)[32], const uint32_t (&p)[32],
                                         uint32_t v_tile) {
  const uint64_t v_desc = hopper::tile_desc(v_tile);
#pragma unroll
  for (int i = 0; i < kTileK / 16; ++i) {
    hopper::wgmma_m64n64k16_rs(acc, p + 4 * i, v_desc + i * hopper::kDescMnMajorStep);
  }
  hopper::wgmma_commit();
}

}  // namespace flash
