// The 3xTF32 pieces the f32 attention kernels share (the forwards in
// flash_attn_fwd.cu, dq and dk/dv in flash_attn_bwd.cu): the pre-pass that
// writes split and transposed copies of an operand into a workspace, the tensor
// maps and wgmma descriptors over those copies, and the split of a score
// accumulator's values into TF32 A fragments.
//
// Every product of those kernels is error-compensated TF32 (3xTF32): an f32 x
// is split into hi = tf32_rna(x) and lo = tf32_rna(x - hi) (split_tf32 in
// flash_wgmma.cuh), and a product is lo·hi + hi·lo + hi·hi in f32 accumulators,
// the small terms first: ~21 bits where one TF32 product keeps ~11.
//
// TF32 wgmma reads both shared-memory operands K-major only (no transpose bit
// below 16 bits), so an operand whose summed dimension is the sequence (V of
// P·V, K of dS·K, q' and dO of the dk/dv products) is laid out transposed, the
// sequence contiguous.  The A fragments of those products come from score
// accumulators with no shuffle: the accumulator holds columns 2t, 2t+1 of each
// 8 (t = lane % 4), the TF32 A fragment takes inner indices t and t+4, so the
// transposed copies permute the sequence inside each group of 8 (position p
// holds row tf32_row_at(p)), which pairs each fragment value with its row.

#pragma once

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace hopper {

constexpr int kTf32Pad = 64;       // every split copy pads S with zero rows to a multiple of this
constexpr int kSplitRows = 32;     // rows a CTA of the pre-pass
constexpr int kSplitThreads = 256;

// Position p of a group of 8 in the transposed copies holds row
// 8*(p/8) + tf32_row_at(p % 8): the accumulator element that the A fragment's
// inner index p % 8 takes (split_fragments) is that row's score.
__device__ __forceinline__ int tf32_row_at(int p) { return 2 * (p & 3) + (p >> 2); }

// x [B, S, H, 64] f32 times `scale`, split into TF32 hi and lo (split_tf32):
//   nat[bh][hi/lo][half][s][32]    s < S_pad, rows past S are 0: tiles whose
//                                  inner dimension is the head dim.  nullptr:
//                                  not written.
//   tr[bh][hi/lo][d][s']           the same transposed, s' permuted inside each
//                                  group of 8 (tf32_row_at): tiles whose inner
//                                  dimension is the sequence.  nullptr: not
//                                  written.
__global__ void __launch_bounds__(kSplitThreads)
split_tf32_kernel(const float* __restrict__ x, float* __restrict__ nat, float* __restrict__ tr,
                  int S, int H, int S_pad, float scale) {
  __shared__ float tile[2][flash::kHeadDim][kSplitRows + 1];
  constexpr int kD = flash::kHeadDim;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int s0 = blockIdx.x * kSplitRows;
  const size_t plane = static_cast<size_t>(S_pad) * kD;  // one of hi and lo
  for (int c = threadIdx.x; c < kSplitRows * kD / 4; c += kSplitThreads) {
    const int r = c / (kD / 4);
    const int col = 4 * (c % (kD / 4));
    const int s = s0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) {
      v = *reinterpret_cast<const float4*>(x + ((static_cast<size_t>(b) * S + s) * H + h) * kD + col);
    }
    const float in[4] = {v.x * scale, v.y * scale, v.z * scale, v.w * scale};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(in[i], hi[i], lo[i]);
    if (nat != nullptr) {
      float* dst = nat + static_cast<size_t>(bh) * 2 * plane +
                   (static_cast<size_t>(col / 32) * S_pad + s) * 32 + col % 32;
      *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + plane) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if (tr != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tile[0][col + i][r] = __uint_as_float(hi[i]);
        tile[1][col + i][r] = __uint_as_float(lo[i]);
      }
    }
  }
  if (tr == nullptr) return;  // the same for every thread of the block
  __syncthreads();
  float* tr_bh = tr + static_cast<size_t>(bh) * 2 * plane;
  for (int w = threadIdx.x; w < 2 * kD * kSplitRows / 4; w += kSplitThreads) {
    const int hl = w / (kD * kSplitRows / 4);
    const int d = (w / (kSplitRows / 4)) % kD;
    const int p0 = 4 * (w % (kSplitRows / 4));
    float out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + i;
      out[i] = tile[hl][d][(p & ~7) + tf32_row_at(p & 7)];
    }
    *reinterpret_cast<float4*>(tr_bh + (static_cast<size_t>(hl) * kD + d) * S_pad + s0 + p0) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
}

inline int tf32_padded(int S) { return (S + kTf32Pad - 1) / kTf32Pad * kTf32Pad; }

// The floats of one split copy (natural or transposed) of a [B, S, H, 64] tensor
inline size_t f32_part(int B, int S, int H) {
  return static_cast<size_t>(B) * H * tf32_padded(S) * 2 * flash::kHeadDim;
}

inline cudaError_t launch_split(const void* x, float* nat, float* tr, int B, int S, int H,
                                float scale, cudaStream_t stream) {
  const int S_pad = tf32_padded(S);
  split_tf32_kernel<<<dim3(S_pad / kSplitRows, B * H), kSplitThreads, 0, stream>>>(
      static_cast<const float*>(x), nat, tr, S, H, S_pad, scale);
  return cudaGetLastError();
}

// Maps over a natural split copy ([bh][4 = hi/lo x half][S_pad][32], boxes of
// `rows` rows: [4][rows][32]) and a transposed one ([bh][hi/lo][64][S_pad],
// boxes of `rows` sequence positions: [2][64][rows], rows <= 32)
inline cudaError_t make_nat_map(CUtensorMap* map, const float* ws, int B, int S, int H, int rows) {
  const cuuint64_t S_pad = tf32_padded(S);
  const cuuint64_t dims[4] = {32, S_pad, 4, static_cast<cuuint64_t>(B) * H};
  const cuuint64_t strides[3] = {kRowBytes, S_pad * kRowBytes, 4 * S_pad * kRowBytes};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 4, 1};
  return make_f32_tile_map(map, ws, dims, strides, box);
}

inline cudaError_t make_tr_map(CUtensorMap* map, const float* ws, int B, int S, int H, int rows) {
  const cuuint64_t S_pad = tf32_padded(S);
  constexpr cuuint64_t kD = flash::kHeadDim;
  const cuuint64_t dims[4] = {S_pad, kD, 2, static_cast<cuuint64_t>(B) * H};
  const cuuint64_t strides[3] = {S_pad * 4, kD * S_pad * 4, 2 * kD * S_pad * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(rows), static_cast<cuuint32_t>(kD), 2, 1};
  return make_f32_tile_map(map, ws, dims, strides, box);
}

// The slice of k-step i (8 inner f32) of split tile `tile` of `rows` rows:
// hi (lo = 0) or lo, half i / 4 of the head dim
__device__ __forceinline__ uint64_t nat_desc(uint32_t tile, int rows, int lo, int i) {
  return tile_desc(tile + (2 * lo + (i >> 2)) * rows * kRowBytes + (i & 3) * 32);
}
// k-step j (8 sequence positions) of a transposed tile [hi/lo][64 dims][32 positions]
__device__ __forceinline__ uint64_t tr_desc(uint32_t tile, int lo, int j) {
  return tile_desc(tile + lo * flash::kHeadDim * kRowBytes + j * 32);
}

// Accumulator-order values of one 32-column tile as the split A fragments of
// a product over those columns: slot e of k-step j takes element
// kFragFromAcc[e] of the same 8 columns.  The rows agree (slots 0, 2: row t/4;
// 1, 3: + 8), but the fragment's inner index t%4 (+4) gets column 2(t%4) (+1):
// tf32_row_at, which the pre-pass's transposed copies follow, pairs them up.
__device__ __forceinline__ void split_fragments(const float (&x)[16], uint32_t (&hi)[16],
                                                uint32_t (&lo)[16]) {
  constexpr int kFragFromAcc[4] = {0, 2, 1, 3};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[4 * j + kFragFromAcc[e]], hi[4 * j + e], lo[4 * j + e]);
  }
}

}  // namespace hopper
