// The flash-forward probe kernels for Hopper (sm_90a): one template, three
// C entries.  They are instruments for the work on the production forwards
// (flash_attn_fwd.cu), not part of a user's path.
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
// over (batch, head); keys j >= seq_k are padding that the caller's arrays
// still hold.  s_ij = q_i . k_j in f32 from the bf16 values.
//   const / row m (nomax, bisect):  p_ij = round_bf16(exp2(s_ij - m_i)),
//       m_i = 15 or m[bh, i];   acc = sum_j p_ij v_j,  l = sum_j p_ij
//       mask none:      every key of the array counts, padding included
//       mask last:      keys >= seq_k get p = 0, tested only in a tile that
//                       reaches past seq_k
//       mask every:     the same p, the test on every key of every tile
//       mask subtract:  every key counts, then l -= (Sk - seq_k) * exp2(-m_i):
//                       exact when the padded k rows are zeros (s = 0)
//   running m (lab), per block of 16 keys, m from -1e30:
//       s_ij *= log2(e)/sqrt(D) in f32 (old, new), or q was folded to
//       q' = round_bf16(q * log2(e)/sqrt(D)) first (qs); keys >= seq_k: s = -1e30
//       m_new = max(m, max_j s_ij), alpha = exp2(m - m_new),
//       pf_ij = exp2(s_ij - m_new), p_ij = round_bf16(pf_ij),
//       acc = alpha*acc + sum_j p_ij v_j,
//       l = alpha*l + sum_j pf_ij (old)  or  sum_j p_ij (new, qs)
//   O_i = round_bf16(acc / max(l, 1e-30)),  lse_i = m_i + log2(max(l, 1e-30))
// p is rounded to bf16 before the PV sum in every variant, as the TPU kernels
// cast it for their matrix unit.  The TPU's ones-column in V (the denominator
// on the matrix unit), its 128-lane padding of the head dim and its
// lane-padded m and l scratch serve that machine's tiling and are not carried
// over: row sums stay in registers.  The TPU's block sizes only schedule it;
// the one place they changed the math, the padded key count, is Sk here.
//
// What bounds it on an H100: 4*S^2*64*BH FLOP (7.1e11 at the padded
// S = 21504, BH = 6: 0.72 ms at the 989 TFLOP/s bf16 peak) against ~66 MB of
// q/k/v/O (0.02 ms at 3.35 TB/s): the operations, by a factor of ~36.
//
// Design: the tiling of flash_fwd_kernel (one CTA per 64-row q tile and head,
// one thread per query row, K/V tiles of 64 keys in shared memory as f32, f32
// FMA), with template parameters for the source of m, the mask mode, where the
// scale goes and which p the denominator sums.  `nh` heads are walked by one
// CTA one after another (the TPU's heads-per-call knob).  Like the production
// kernel it is bounded by the f32 FMA pipes; the probes measure what each
// variation costs on top of that baseline, and move to the tensor cores
// together with the production forwards.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/flash_probes.py).

#include "flash_common.cuh"

namespace {

using namespace flash;
using T = __nv_bfloat16;

constexpr int kBlockQ = 64;  // query rows per CTA = threads per CTA
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kSub = 16;     // keys per online-softmax update
constexpr float kNegInf = -1e30f;

enum MSource { kMConst, kMRow, kMRunning };
enum MaskMode { kMaskNone, kMaskLast, kMaskEvery, kMaskSubtract };
enum ScaleMode { kScaleNone, kScaleS, kScaleQ };

template <MSource kM, MaskMode kMask, ScaleMode kScale, bool kRoundedDenom>
__global__ void __launch_bounds__(kBlockQ)
flash_probe_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ m_in, T* __restrict__ o, float* __restrict__ lse,
                   int Sq, int Sk, int seq_k, int nh, float scale, float m_const) {
  __shared__ __align__(16) float k_tile[kBlockK][kHeadDim];
  __shared__ __align__(16) float v_tile[kBlockK][kHeadDim];

  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < Sq;

  for (int hh = 0; hh < nh; ++hh) {
    const int bh = blockIdx.y * nh + hh;
    const T* kb = k + static_cast<size_t>(bh) * Sk * kHeadDim;
    const T* vb = v + static_cast<size_t>(bh) * Sk * kHeadDim;
    const size_t q_off = (static_cast<size_t>(bh) * Sq + row) * kHeadDim;

    float qr[kHeadDim];
    if (active) {
#pragma unroll
      for (int d = 0; d < kHeadDim; d += Vec16<T>::kN) {
        float x[Vec16<T>::kN];
        Vec16<T>::load(q + q_off + d, x);
#pragma unroll
        for (int i = 0; i < Vec16<T>::kN; ++i) {
          qr[d + i] = kScale == kScaleQ ? round_to<T>(x[i] * scale) : x[i];
        }
      }
    } else {
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) qr[d] = 0.f;
    }
    float m = kNegInf;
    if (kM == kMConst) m = m_const;
    if (kM == kMRow) m = active ? m_in[static_cast<size_t>(bh) * Sq + row] : 0.f;

    float acc[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
    float l = 0.f;

    for (int k0 = 0; k0 < Sk; k0 += kBlockK) {
      const int nk = min(kBlockK, Sk - k0);
      __syncthreads();  // the previous tile (or head) has been consumed
      stage_tile<T, kBlockK>(k_tile, kb, kHeadDim, k0, nk, 1.f, threadIdx.x, kBlockQ);
      stage_tile<T, kBlockK>(v_tile, vb, kHeadDim, k0, nk, 1.f, threadIdx.x, kBlockQ);
      __syncthreads();
      if (!active) continue;
      // does this tile test its keys against seq_k?
      const bool check = kMask == kMaskEvery || (kMask == kMaskLast && k0 + nk > seq_k);
      if constexpr (kM == kMRunning) {
        for (int j0 = 0; j0 < nk; j0 += kSub) {
          float s[kSub];
          float m_blk = kNegInf;
#pragma unroll
          for (int jj = 0; jj < kSub; ++jj) {
            // rows past nk are zeros: the score is taken unconditionally
            float sc = score(qr, k_tile[j0 + jj]);
            if (kScale == kScaleS) sc *= scale;
            const bool keep = (j0 + jj < nk) && (!check || k0 + j0 + jj < seq_k);
            s[jj] = keep ? sc : kNegInf;
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
            const float pf = exp2f(s[jj] - m);
            const float p = round_to<T>(pf);
            l += kRoundedDenom ? p : pf;
            accumulate(acc, p, v_tile[j0 + jj]);
          }
        }
      } else {
        for (int j = 0; j < nk; ++j) {
          float pf = exp2f(score(qr, k_tile[j]) - m);
          if (check && k0 + j >= seq_k) pf = 0.f;
          const float p = round_to<T>(pf);
          l += p;
          accumulate(acc, p, v_tile[j]);
        }
      }
    }

    if (active) {
      if (kMask == kMaskSubtract) l -= static_cast<float>(Sk - seq_k) * exp2f(-m);
      const float lc = fmaxf(l, 1e-30f);
      T* orow = o + q_off;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) orow[d] = from_f32<T>(acc[d] / lc);
      if (lse != nullptr) lse[static_cast<size_t>(bh) * Sq + row] = m + log2f(lc);
    }
  }
}

template <MSource kM, MaskMode kMask, ScaleMode kScale, bool kRoundedDenom>
int launch(const void* q, const void* k, const void* v, const void* m_in, void* o, void* lse,
           int BH, int Sq, int Sk, int seq_k, int nh, float scale, float m_const,
           void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || seq_k <= 0 || seq_k > Sk || nh <= 0 || BH % nh != 0 ||
      BH / nh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, BH / nh);
  flash_probe_kernel<kM, kMask, kScale, kRoundedDenom>
      <<<grid, kBlockQ, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const float*>(m_in), static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk,
          seq_k, nh, scale, m_const);
  return static_cast<int>(cudaGetLastError());
}

constexpr float kProbeM = 15.f;  // the tools' literal stand-in for the norm bound

}  // namespace

// Every tensor is bf16 and contiguous; m and lse are f32 [BH, Sq].  Each entry
// returns a cudaError_t (0 on success); the caller raises on anything else.

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
