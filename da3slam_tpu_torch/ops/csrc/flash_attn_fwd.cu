// Flash-attention forwards for Hopper (sm_90a): one kernel, two modes.
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
//   stable, per block of 16 keys:
//           m_new = max(m, max_j s_ij)                   (m starts at -1e30)
//           alpha = exp2(m - m_new)
//           p_ij  = round_to_T(exp2(s_ij - m_new))
//           acc   = alpha * acc + sum_j p_ij v_j,  l = alpha * l + sum_j p_ij
//   O_i   = acc / max(l, 1e-30),  lse_i = m_i + log2(max(l, 1e-30))   (base 2)
// The bound m_i exceeds every logit (Cauchy-Schwarz), so p <= 1 and the bound
// mode needs no running max and no rescale.  The denominator sums the ROUNDED
// p, as the TPU's ones-column in V did.  The stable mode's blocks are 16 keys
// (the TPU's were block_k >= 128); the result is the same at any split
// (tests/test_flash_attention.py TestKSplits) up to where each p is rounded,
// and the plain version runs the same 16-key blocks.
//
// Layout: q, k, v and O are [B, S, H, 64] contiguous (the model's own layout:
// no fold/transpose copies); lse is [B*H, S] f32, the same quantity in either
// mode, so one backward serves both.  T is __nv_bfloat16 (the model's working
// type on the card) or float (training and the f32 parity runs).
//
// What bounds it on an H100: the SMALL-tier cross-view call (B=1, S=19515,
// H=6 at chunk 15) is 4*S^2*D*H = 5.85e11 FLOP per block with 6 cross blocks
// per chunk, against ~28 MB of q/k/v/O traffic: compute-bound by four orders
// of magnitude.  The intra-view call (B=15, S=1301) is compute-bound too.  The
// stable mode adds a max over each block of 16 scores and a rescale of the
// 64-wide accumulator, ~3% more FMA-pipe work per key.
//
// Design, and why it is enough for now: one CTA per (b*h, 64-row q tile), one
// thread per query row.  Each thread keeps its q' row and its [p.V | sum p]
// accumulator in registers; K/V tiles of 64 keys are staged in shared memory
// as f32 (converted once per CTA at load), and every thread reads each key
// row as a shared-memory broadcast (the stable mode scores 16 keys before it
// accumulates them, to take their max; the bound mode one at a time, which
// measured faster than holding 16 scores, PERF.md).  The arithmetic runs on
// the f32 FMA pipes, not the tensor cores: every product is exact in f32, and
// one code path serves both types and both modes.  That caps it at the card's
// f32 rate (67 TFLOP/s on the H100 SXM data sheet, against 989 TFLOP/s bf16
// on the tensor cores), so it is the correct baseline, not the fast form.
// The fast form is later work, for both modes at once: wgmma on 64-row
// warpgroup tiles, K/V ring-buffered by TMA, P kept in registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/flash_attention.py).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = 64;  // query rows per CTA = threads per CTA
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kSub = 16;     // keys whose scores sit in registers at once
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

// kStable = false: the bound mode (m from kmax, fixed).  kStable = true: the
// online softmax (kmax unused, m the running max).
template <typename T, bool kStable>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ kmax, T* __restrict__ o, float* __restrict__ lse,
                 int S, int H, float scale) {
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
  float m = kStable ? kNegInf : sqrtf(qn2) * kmax[bh];

  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  float l = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    const int nk = min(kBlockK, S - k0);
    __syncthreads();  // the previous tile has been consumed
    // rows nk..63 are zero-filled: the masked keys below multiply zeros
    stage_tile<T, kBlockK>(k_tile, k + head_base, row_stride, k0, nk, 1.f, threadIdx.x, kBlockQ);
    stage_tile<T, kBlockK>(v_tile, v + head_base, row_stride, k0, nk, 1.f, threadIdx.x, kBlockQ);
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
          const float p = round_to<T>(exp2f(s[jj] - m));
          l += p;
          accumulate(acc, p, v_tile[j0 + jj]);
        }
      }
    } else {
      // a fixed shift needs no scores held back: one key at a time.  Keys
      // j >= nk (past S) are never visited: their p is 0
      for (int j = 0; j < nk; ++j) {
        const float p = round_to<T>(exp2f(score(qr, k_tile[j]) - m));
        l += p;
        accumulate(acc, p, v_tile[j]);
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

template <typename T, bool kStable>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   void* kmax, int B, int S, int H, float scale, cudaStream_t stream) {
  const int bh = B * H;
  if constexpr (!kStable) {
    key_norm_max_kernel<T><<<bh, kNormThreads, 0, stream>>>(
        static_cast<const T*>(k), static_cast<float*>(kmax), S, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T, kStable><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kmax), static_cast<T*>(o), static_cast<float*>(lse), S, H,
      scale);
  return cudaGetLastError();
}

template <bool kStable>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, void* kmax,
             int B, int S, int H, int D, int dtype, float scale, void* stream) {
  if (D != kHeadDim || B <= 0 || S <= 0 || H <= 0 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch<float, kStable>(q, k, v, o, lse, kmax, B, S, H, scale, st));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch<__nv_bfloat16, kStable>(q, k, v, o, lse, kmax, B, S, H, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
