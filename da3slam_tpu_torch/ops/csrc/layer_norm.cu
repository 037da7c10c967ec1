// LayerNorm of bf16 rows in one pass, for Hopper (sm_90a), and the same pass
// with VGGT's 2D RoPE as its epilogue (QK-norm).
//
// Replaces no TPU kernel.  The JAX package leaves LayerNorm to XLA, which
// fuses the f32 casts around it into the one pass; the eager port ran it as
// three (x.float(), F.layer_norm in f32, .to(bf16)) moving 20 bytes an element,
// and QK-norm with RoPE as about eleven.  This kernel moves 4: the bf16 row
// in, the bf16 row out.
//
// Math (that of models/vit.py:layer_norm and models/vggt.py:qk_norm_rope, the
// plain versions the wrapper runs off the card):
//   mean = sum(x) / W,  var = sum((x - mean)^2) / W,  in f32 over the row
//   y = (x - mean) * rsqrt(var + eps) * w + b          in f32, w and b f32
//   RoPE (W = 64, one head): within each 32-channel half (y half, x half),
//   channel j < 16 pairs with j + 16 at the row's position p:
//   (a, b) <- (a cos - b sin, b cos + a sin), cos and sin from the tables
//   [P, 2, 16] (models/vggt.py:rope_tables), in f32
//   then rounded once to bf16 (round to nearest even), as .to(bf16) rounds.
//
// The rows: row r is (i0, i1, i2), i2 fastest (sizes d0, d1, d2), at element
// i0*s0 + i1*s1 + i2*s2 of x; the last dimension is contiguous.  So a view
// whose last dimension is contiguous is read in place: the q or k third of a
// qkv projection [N, P, 3*H*64] as rows (n, p, h), or a DPT tap with its
// prefix tokens cut.  The RoPE position of a row is i1.  Out is contiguous
// [rows, W] (for QK-norm: [N, P, H, 64], the attention kernels' layout).
//
// What bounds it: bytes, at ~1 flop a byte.  A 19,515 x 1024 norm moves
// 80 MB (24 us at 3.35 TB/s); the q and k of a VGGT block 160 MB (48 us).
//
// Design: a row is held by kLanes lanes of one warp (8, 16 or 32, chosen by
// width), each lane kPerLane 16-byte vectors of 8 values kept in registers, so
// the row is read from memory once; the two sums are shuffles within the
// lane group (two passes over registers: the variance of the centred values);
// the f32 weights and bias are read directly (L1/L2-resident), so no
// per-call cast runs.  128 threads a CTA; no shared memory, no allocation.
// The RoPE epilogue (kLanes 8, kPerLane 1: lane l holds channels 8l..8l+7)
// takes the pair partner's values from lane l ^ 2 (16 channels away).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;  // bf16 values in 16 bytes
constexpr int kHead = 64;  // the RoPE epilogue's head width
constexpr int kQuarter = kHead / 4;
constexpr int kMaxPerLane = 8;
constexpr int kMaxWidth = 32 * kMaxPerLane * kVec;  // 2048

struct Rows {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  const float* w;
  const float* b;
  const float* cos_t;  // RoPE only: [positions, 2, kQuarter]
  const float* sin_t;
  long long rows, d1, d2;
  long long s0, s1, s2;  // element strides of i0, i1, i2
  int width;
  float eps;
};

__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec / 2; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec / 2; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  return raw;
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

// the sum over an aligned group of kLanes lanes (every lane of the warp calls it)
template <int kLanes>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <int kLanes, int kPerLane, bool kRope>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(const Rows p) {
  static_assert(32 % kLanes == 0 && kPerLane >= 1 && kPerLane <= kMaxPerLane, "row split");
  static_assert(!kRope || (kLanes * kVec == kHead && kPerLane == 1), "RoPE: one 64-wide head");
  constexpr int kRowsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int l = lane % kLanes;
  const long long row =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32) * kRowsPerWarp +
      lane / kLanes;
  // a lane past the last row still takes part in the shuffles, on zeros
  const bool live = row < p.rows;
  const int nvec = p.width / kVec;
  // 32-bit division (rows < 2^31, checked by the entry points)
  unsigned i1 = 0;
  long long at = 0;
  if (live) {
    const unsigned r = static_cast<unsigned>(row), d1 = static_cast<unsigned>(p.d1),
                   d2 = static_cast<unsigned>(p.d2);
    const unsigned i2 = r % d2, r01 = r / d2;
    i1 = r01 % d1;
    at = static_cast<long long>(r01 / d1) * p.s0 + static_cast<long long>(i1) * p.s1 +
         static_cast<long long>(i2) * p.s2;
  }

  float v[kPerLane][kVec];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = l + i * kLanes;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (live && c < nvec) raw = __ldg(reinterpret_cast<const uint4*>(p.x + at + c * kVec));
    unpack(raw, v[i]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) sum += v[i][e];
  }
  const float mean = group_sum<kLanes>(sum) / p.width;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    if (l + i * kLanes < nvec) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = v[i][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(group_sum<kLanes>(sq) / p.width + p.eps);

#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = l + i * kLanes;
    if (c >= nvec) continue;
    float w[kVec], b[kVec];
    load8(p.w + c * kVec, w);
    load8(p.b + c * kVec, b);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[i][e] = (v[i][e] - mean) * rstd * w[e] + b[e];
  }

  if constexpr (kRope) {
    // lane l: channels 8l..8l+7 of the head; half l / 4 (y, x), part (l / 2) % 2
    // (a: j < 16, b: j >= 16), j from 8 (l % 2); the partner is lane l ^ 2
    float partner[kVec], cs[kVec], sn[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) partner[e] = __shfl_xor_sync(0xffffffffu, v[0][e], 2);
    const long long t = (static_cast<long long>(i1) * 2 + l / 4) * kQuarter + (l % 2) * kVec;
    load8(p.cos_t + t, cs);
    load8(p.sin_t + t, sn);
    const bool part_b = (l / 2) % 2;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      v[0][e] = part_b ? v[0][e] * cs[e] + partner[e] * sn[e]
                       : v[0][e] * cs[e] - partner[e] * sn[e];
    }
  }

  if (!live) return;
  __nv_bfloat16* out = p.out + row * p.width;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = l + i * kLanes;
    if (c < nvec) *reinterpret_cast<uint4*>(out + c * kVec) = pack(v[i]);
  }
}

template <int kLanes, int kPerLane, bool kRope>
int launch(const Rows& p, cudaStream_t stream) {
  constexpr long long kRowsPerBlock = (kThreads / 32) * (32 / kLanes);
  const long long blocks = (p.rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  layer_norm_kernel<kLanes, kPerLane, kRope>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the fewest lanes a row (8, 16, 32) that hold it in at most kMaxPerLane vectors a lane
template <int kLanes>
int launch_lanes(const Rows& p, cudaStream_t stream) {
  switch ((p.width / kVec + kLanes - 1) / kLanes) {
    case 1: return launch<kLanes, 1, false>(p, stream);
    case 2: return launch<kLanes, 2, false>(p, stream);
    case 3: return launch<kLanes, 3, false>(p, stream);
    case 4: return launch<kLanes, 4, false>(p, stream);
    case 5: return launch<kLanes, 5, false>(p, stream);
    case 6: return launch<kLanes, 6, false>(p, stream);
    case 7: return launch<kLanes, 7, false>(p, stream);
    case 8: return launch<kLanes, 8, false>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid(const Rows& p) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.out) |
                          reinterpret_cast<uintptr_t>(p.w) | reinterpret_cast<uintptr_t>(p.b);
  return p.rows >= 0 && p.rows < (1LL << 31) && p.d1 > 0 && p.d2 > 0 && p.width > 0 &&
         p.width % kVec == 0 &&
         p.width <= kMaxWidth && align % 16 == 0 && (p.s0 | p.s1 | p.s2) % kVec == 0;
}

}  // namespace

// x bf16 rows (see Rows), out bf16 [rows, width] contiguous, w and b f32
// [width]; width % 8 == 0, at most 2048; every pointer 16-byte aligned and
// every stride a multiple of 8 elements.  Returns a cudaError_t (0 on success).
extern "C" int layer_norm_bf16(const void* x, void* out, const void* w, const void* b,
                               long long rows, long long d1, long long d2, long long s0,
                               long long s1, long long s2, int width, float eps, void* stream) {
  const Rows p{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
               static_cast<const float*>(w), static_cast<const float*>(b), nullptr, nullptr,
               rows, d1, d2, s0, s1, s2, width, eps};
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nvec = width / kVec;
  if (nvec <= 8 * kMaxPerLane) return launch_lanes<8>(p, s);
  if (nvec <= 16 * kMaxPerLane) return launch_lanes<16>(p, s);
  return launch_lanes<32>(p, s);
}

// QK-norm and 2D RoPE of 64-wide heads: rows (i0, i1, i2) = (view, position,
// head), cos and sin f32 [d1, 2, 16] contiguous; otherwise as layer_norm_bf16.
extern "C" int layer_norm_rope_bf16(const void* x, void* out, const void* w, const void* b,
                                    const void* cos_t, const void* sin_t, long long rows,
                                    long long d1, long long d2, long long s0, long long s1,
                                    long long s2, float eps, void* stream) {
  const Rows p{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
               static_cast<const float*>(w), static_cast<const float*>(b),
               static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
               rows, d1, d2, s0, s1, s2, kHead, eps};
  const uintptr_t tables = reinterpret_cast<uintptr_t>(cos_t) | reinterpret_cast<uintptr_t>(sin_t);
  if (!valid(p) || tables % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.rows == 0) return 0;
  return launch<kHead / kVec, 1, true>(p, static_cast<cudaStream_t>(stream));
}
