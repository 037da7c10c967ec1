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
// float (training) or __nv_bfloat16.
//
// What bounds it on an H100: work.  The two kernels each recompute s and
// dO.v^T, so the backward is 14*S^2*D FLOP per (b, h) (dq: 6, dk/dv: 8)
// against ~S*D*(7 tensors)*sizeof(T) bytes: compute-bound by orders of
// magnitude at every training and SLAM shape.
//
// Design, and why it is enough for now: one CTA per (b*h, 64-row tile),
// looping over the other side's tiles of 64 staged in shared memory as f32
// (K/V for dq; q'/dO plus lse/Delta for dk/dv).  A PAIR of adjacent threads
// owns one row, each thread half of the head dim in interleaved 4-wide
// chunks (thread h of the pair holds chunks 2m + h, m = 0..7), so a thread
// keeps three (dq: q', dO, dq) or four (dk/dv: k, v, dk, dv) 32-wide rows in
// registers instead of 192 or 256 floats, and the pair's two shared-memory
// reads of a row land in different banks.  The two half dot products meet by
// one __shfl_xor each.  No atomics (every output row is owned by one pair),
// so the result is deterministic.  f32 FMA, no tensor cores: exact products
// and one code path for both types, which is the right first form; wgmma on
// 64-row tiles with TMA-fed K/V is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/flash_attention.py).

#include "flash_common.cuh"

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scale_qk = log2(e)/sqrt(D) folds q into
// q'; scale_dq = 1/sqrt(D).  Returns a cudaError_t (0 on success); the caller
// raises on anything else.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int S,
                                 int H, int D, int dtype, float scale_qk, float scale_dq,
                                 void* stream) {
  if (D != kHeadDim || B <= 0 || S <= 0 || H <= 0 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    flash_bwd_dq_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, dl, static_cast<float*>(dq), S, H, scale_qk, scale_dq);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    flash_bwd_dq_kernel<bf><<<grid, kThreads, 0, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), l, dl, static_cast<bf*>(dq), S, H, scale_qk, scale_dq);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// scale_dk = ln(2): dk = dz^T . q_orig / sqrt(D) = ln(2) * dz^T . q'
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int S, int H, int D, int dtype, float scale_qk, float scale_dk,
                                  void* stream) {
  if (D != kHeadDim || B <= 0 || S <= 0 || H <= 0 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    flash_bwd_dkv_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, dl, static_cast<float*>(dk), static_cast<float*>(dv),
        S, H, scale_qk, scale_dk);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    flash_bwd_dkv_kernel<bf><<<grid, kThreads, 0, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), l, dl, static_cast<bf*>(dk), static_cast<bf*>(dv), S, H,
        scale_qk, scale_dk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
