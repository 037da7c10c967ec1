// Max-free ("bound") flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel da3slam_tpu/ops/flash_attention.py:_fwd_kernel_bound
// (reached through _flash_forward(stable=False)), which serves every attention
// call of the DA3 ViT encoder.
//
// Math (identical to the TPU kernel and to flash_attention_bound_reference):
//   q'_i  = round_to_T(q_i * log2(e)/sqrt(D))           (the TPU's _fold)
//   m_i   = ||q'_i|| * max_j ||k_j||                    (f32, from the rounded q')
//   p_ij  = round_to_T(exp2(q'_i . k_j - m_i))          (keys j >= S contribute 0)
//   O_i   = sum_j p_ij v_j / max(sum_j p_ij, 1e-30)     (f32 accumulation)
//   lse_i = m_i + log2(max(sum_j p_ij, 1e-30))          (base 2, kept for a backward)
// m_i bounds every logit (Cauchy-Schwarz), so p <= 1 and the accumulators need
// no running max and no rescale.  The denominator sums the ROUNDED p, as the
// TPU's ones-column in V did.
//
// Layout: q, k, v and O are [B, S, H, 64] contiguous (the model's own layout:
// no fold/transpose copies); lse is [B*H, S] f32.  T is __nv_bfloat16 (the
// model's working type on the card) or float (the f32 parity run).
//
// What bounds it on an H100: the SMALL-tier cross-view call (B=1, S=19515,
// H=6 at chunk 15) is 4*S^2*D*H = 5.85e11 FLOP per block with 6 cross blocks
// per chunk, against ~28 MB of q/k/v/O traffic: compute-bound by four orders
// of magnitude.  The intra-view call (B=15, S=1301) is compute-bound too.
//
// Design, and why it is enough for now: one CTA per (b*h, 64-row q tile), one
// thread per query row.  Each thread keeps its q' row and its [p.V | sum p]
// accumulator in registers; K/V tiles of 64 keys are staged in shared memory
// as f32 (converted once per CTA at load), and every thread reads each key
// row as a shared-memory broadcast.  The arithmetic runs on the f32 FMA pipes,
// not the tensor cores: every product is exact in f32, one code path serves
// both types, and the bound semantics need nothing but a sum per row.  That
// caps it at the card's f32 rate (67 TFLOP/s on the H100 SXM data sheet,
// against 989 TFLOP/s bf16 on the tensor cores), so it is the correct
// baseline, not the fast form.  The fast form is later work: wgmma on 64-row
// warpgroup tiles, K/V ring-buffered by TMA, P kept in registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kHeadDim = 64;  // every DA3 tier
constexpr int kBlockQ = 64;   // query rows per CTA = threads per CTA
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kNormThreads = 256;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// kmax[b*H + h] = max_j ||k[b, j, h, :]||  (f32)
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

template <typename T>
__global__ void __launch_bounds__(kBlockQ)
flash_bound_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ kmax,
                       T* __restrict__ o, float* __restrict__ lse, int S, int H,
                       float scale) {
  __shared__ __align__(16) float k_tile[kBlockK][kHeadDim];
  __shared__ __align__(16) float v_tile[kBlockK][kHeadDim];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < S;
  const size_t row_stride = static_cast<size_t>(H) * kHeadDim;
  const size_t head_base = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kHeadDim;

  // q'_i in registers, rounded to T exactly as the TPU fold did
  float qr[kHeadDim];
  float qn2 = 0.f;
  if (active) {
    const T* qrow = q + head_base + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += Vec16<T>::kN) {
      float x[Vec16<T>::kN];
      Vec16<T>::load(qrow + d, x);
#pragma unroll
      for (int i = 0; i < Vec16<T>::kN; ++i) {
        const float r = round_to<T>(x[i] * scale);
        qr[d + i] = r;
        qn2 = fmaf(r, r, qn2);
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) qr[d] = 0.f;
  }
  const float m = sqrtf(qn2) * kmax[bh];

  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  float l = 0.f;

  constexpr int kVec = Vec16<T>::kN;
  constexpr int kVecPerRow = kHeadDim / kVec;
  constexpr int kRowsPerPass = kBlockQ / kVecPerRow;
  const T* kb = k + head_base;
  const T* vb = v + head_base;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    const int nk = min(kBlockK, S - k0);
    __syncthreads();  // the previous tile has been consumed
    {
      const int c = (threadIdx.x % kVecPerRow) * kVec;
      for (int j = threadIdx.x / kVecPerRow; j < nk; j += kRowsPerPass) {
        const size_t off = static_cast<size_t>(k0 + j) * row_stride + c;
        Vec16<T>::load(kb + off, &k_tile[j][c]);
        Vec16<T>::load(vb + off, &v_tile[j][c]);
      }
    }
    __syncthreads();
    if (active) {
      // keys j >= nk (past S) are never visited: their p is 0
      for (int j = 0; j < nk; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(k_tile[j]);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
          const float4 kk = kr[d4];
          s0 = fmaf(qr[4 * d4 + 0], kk.x, s0);
          s1 = fmaf(qr[4 * d4 + 1], kk.y, s1);
          s2 = fmaf(qr[4 * d4 + 2], kk.z, s2);
          s3 = fmaf(qr[4 * d4 + 3], kk.w, s3);
        }
        const float s = (s0 + s1) + (s2 + s3);
        const float p = round_to<T>(exp2f(s - m));
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(v_tile[j]);
#pragma unroll
        for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
    }
  }

  if (active) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + head_base + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) orow[d] = from_f32<T>(acc[d] / lc);
    lse[static_cast<size_t>(bh) * S + row] = m + log2f(lc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   void* kmax, int B, int S, int H, float scale, cudaStream_t stream) {
  const int bh = B * H;
  key_norm_max_kernel<T><<<bh, kNormThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<float*>(kmax), S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, bh);
  flash_bound_fwd_kernel<T><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kmax), static_cast<T*>(o), static_cast<float*>(lse), S, H,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kmax is a [B*H] f32 workspace.
// Returns a cudaError_t (0 on success); the caller raises on anything else.
extern "C" int flash_attn_bound_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, void* kmax, int B, int S, int H, int D,
                                    int dtype, float scale, void* stream) {
  if (D != kHeadDim || B <= 0 || S <= 0 || H <= 0 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, o, lse, kmax, B, S, H, scale, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, o, lse, kmax, B, S, H, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
