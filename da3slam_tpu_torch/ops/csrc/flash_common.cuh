// Helpers shared by the flash-attention kernels (flash_attn_*.cu,
// flash_probe_fwd.cu) and, for the type conversions, by conv3x3.cu.
//
// T is the tensors' element type: __nv_bfloat16 (the model's working type on
// the card) or float (training and the f32 parity runs).  Every kernel does
// its arithmetic in f32 and rounds to T only where the TPU kernels rounded
// (q', p and dz before a product, the outputs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace flash {

constexpr int kHeadDim = 64;  // every DA3 tier

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, returned as f32
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// 16 bytes of T (8 bf16 or 4 f32) from global memory into f32 registers
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an f32
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// 4 consecutive elements of T <-> f32 registers (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(r.x << 16);
  out[1] = __uint_as_float(r.x & 0xffff0000u);
  out[2] = __uint_as_float(r.y << 16);
  out[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* in) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(in[0], in[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(in[2], in[3]);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&a);
  r.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = r;
}

// Stage rows [r0, r0 + n) of one head (row stride `row_stride` elements) into
// a [kRows][kHeadDim] f32 shared-memory tile as round_to<T>(x * scale): the
// folded q' for scale log2(e)/sqrt(D), the values unchanged for scale 1
// (x is already a T).  Rows n..kRows-1 are zero-filled, so a masked row never
// multiplies stale or uninitialised shared memory.  All `threads` threads of
// the block call it.
template <typename T, int kRows>
__device__ __forceinline__ void stage_tile(float (*tile)[kHeadDim], const T* base,
                                           size_t row_stride, int r0, int n, float scale,
                                           int tid, int threads) {
  constexpr int kVec = Vec16<T>::kN;
  constexpr int kVecPerRow = kHeadDim / kVec;
  const int c = (tid % kVecPerRow) * kVec;
  for (int j = tid / kVecPerRow; j < kRows; j += threads / kVecPerRow) {
    float x[kVec];
    if (j < n) {
      Vec16<T>::load(base + static_cast<size_t>(r0 + j) * row_stride + c, x);
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = round_to<T>(x[i] * scale);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      *reinterpret_cast<float4*>(&tile[j][c + i]) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
  }
}

// s = q'_i . k_j in f32 (four partial sums), k_j a row of a shared-memory tile
__device__ __forceinline__ float score(const float* qr, const float* k_row) {
  const float4* kr = reinterpret_cast<const float4*>(k_row);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
    const float4 kk = kr[d4];
    s0 = fmaf(qr[4 * d4 + 0], kk.x, s0);
    s1 = fmaf(qr[4 * d4 + 1], kk.y, s1);
    s2 = fmaf(qr[4 * d4 + 2], kk.z, s2);
    s3 = fmaf(qr[4 * d4 + 3], kk.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// acc += p * v_j, v_j a row of a shared-memory tile
__device__ __forceinline__ void accumulate(float* acc, float p, const float* v_row) {
  const float4* vr = reinterpret_cast<const float4*>(v_row);
#pragma unroll
  for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
    const float4 vv = vr[d4];
    acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
    acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

}  // namespace flash
