// The int8 flash-attention probe forward for Hopper (sm_90a): a running-max
// forward whose two products, Q.K^T and P.V, are integer products.  It is an
// instrument for the work on the production forwards (flash_attn_fwd.cu), not
// part of a model's path.
//
// Replaces the TPU kernel tools/int8_flash_probe.py:_int8_kernel of the JAX
// package.  The quantization before it and the de-scale after it are plain
// tensor code there and in the port (da3slam_tpu_torch/ops/int8_flash.py).
//
// Inputs, folded over (batch, head), Sk = nb * bk keys (S real ones, the rest
// zero rows):
//   q8  [BH, S, 64]        int8   q / max|q_row| * 127, rounded
//   k8  [BH, Sk, 64]       int8   k against its block's largest |k|
//   v8p [BH, Sk/4, 64, 4]  int8   v against its channel's largest |v|, four
//                                 consecutive keys of one channel in one word
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
// whole block.  The kernel therefore walks each block twice: integer scores
// for the max, then again for p8 and the P.V sums (the int8 dot is cheap).
// Keys in [S, Sk) are zero rows: their score is exactly 0 and joins the max,
// their v8 is 0, and they are kept out of l; that is what the TPU kernel's
// padding does.  The TPU's ones-column in V, its 128-lane padding of the head
// dim and its lane-padded scales serve that machine's tiling and are not
// carried over: the row sum of p8 lives in a register.
//
// What bounds it on an H100: 4*S^2*64*BH integer operations (6.66e11 at
// S = 20816, BH = 6: 0.34 ms at the 1979 TOP/s dense int8 peak) against ~40 MB
// of q8/k8/v8/O: the operations.
//
// Design: the probes' tiling (one CTA per 64-row q tile and head, one thread
// per query row, tiles of 64 keys in shared memory) with both products on the
// integer dot-product unit: a q row is 16 packed words in registers and a
// score is 16 __dp4a against the key's 16 words; four p8 of consecutive keys
// are packed into one word and P.V is one __dp4a per channel against v8p's
// word of the same four keys.  The accumulators are int32 over a block.  It
// stays off the tensor cores (mma.sync / wgmma s8): a right kernel first.
// Every float step that the plain version takes separately is taken
// separately here (no fused multiply-add), so the two differ only where
// exp2f does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/int8_flash.py).

#include <climits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = 64;   // query rows per CTA = threads per CTA
constexpr int kTileK = 64;    // keys per shared-memory tile; bk is a multiple
constexpr int kWords = kHeadDim / 4;   // packed words in one q or k row
constexpr int kGroups = kTileK / 4;    // groups of four keys in one tile
constexpr float kNegInf = -1e30f;

// 4096 contiguous bytes of global memory into a shared-memory tile
__device__ __forceinline__ void stage_bytes(uint4* tile, const int8_t* src, int tid) {
  const uint4* g = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < kTileK * kHeadDim / 16 / kBlockQ; ++i) {
    tile[tid + i * kBlockQ] = g[tid + i * kBlockQ];
  }
}

__device__ __forceinline__ int dot64(const int* qr, const uint4* k_row) {
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWords / 4; ++w) {
    const uint4 kk = k_row[w];
    s = __dp4a(qr[4 * w + 0], static_cast<int>(kk.x), s);
    s = __dp4a(qr[4 * w + 1], static_cast<int>(kk.y), s);
    s = __dp4a(qr[4 * w + 2], static_cast<int>(kk.z), s);
    s = __dp4a(qr[4 * w + 3], static_cast<int>(kk.w), s);
  }
  return s;
}

__global__ void __launch_bounds__(kBlockQ)
int8_flash_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ v8p, const float* __restrict__ sq,
                  const float* __restrict__ sk, __nv_bfloat16* __restrict__ o, int S, int Sk,
                  int bk) {
  // k_tile[key][4 x uint4]: a key's 64 int8; v_tile[group][16 x uint4]: the
  // 64 channels' words of four keys
  __shared__ __align__(16) uint4 k_tile[kTileK * kHeadDim / 16];
  __shared__ __align__(16) uint4 v_tile[kTileK * kHeadDim / 16];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + tid;
  const bool active = row < S;
  const int nb = Sk / bk;
  const int8_t* kb = k8 + static_cast<size_t>(bh) * Sk * kHeadDim;
  const int8_t* vb = v8p + static_cast<size_t>(bh) * Sk * kHeadDim;

  int qr[kWords];
  float sq_row = 0.f;
  if (active) {
    const uint4* qg = reinterpret_cast<const uint4*>(
        q8 + (static_cast<size_t>(bh) * S + row) * kHeadDim);
#pragma unroll
    for (int w = 0; w < kWords / 4; ++w) {
      const uint4 x = qg[w];
      qr[4 * w + 0] = static_cast<int>(x.x);
      qr[4 * w + 1] = static_cast<int>(x.y);
      qr[4 * w + 2] = static_cast<int>(x.z);
      qr[4 * w + 3] = static_cast<int>(x.w);
    }
    sq_row = sq[static_cast<size_t>(bh) * S + row];
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) qr[w] = 0;
  }

  float m = kNegInf;
  float l = 0.f;
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;

  for (int b = 0; b < nb; ++b) {
    const int k_lo = b * bk;
    const float c = __fmul_rn(sq_row, sk[static_cast<size_t>(bh) * nb + b]);

    // pass 1: the block's largest integer score.  c >= 0, so the largest
    // float(s) * c is float(largest s) * c.
    int s_max = INT_MIN;
    for (int k0 = k_lo; k0 < k_lo + bk; k0 += kTileK) {
      __syncthreads();  // the previous tile has been consumed
      stage_bytes(k_tile, kb + static_cast<size_t>(k0) * kHeadDim, tid);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTileK; ++j) s_max = max(s_max, dot64(qr, &k_tile[j * 4]));
    }
    const float m_new = fmaxf(m, __fmul_rn(static_cast<float>(s_max), c));
    const float alpha = exp2f(__fsub_rn(m, m_new));

    // pass 2: p8 against the block's max, and the integer P.V sums
    int pv[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) pv[d] = 0;
    int p_sum = 0;
    for (int k0 = k_lo; k0 < k_lo + bk; k0 += kTileK) {
      __syncthreads();
      stage_bytes(k_tile, kb + static_cast<size_t>(k0) * kHeadDim, tid);
      stage_bytes(v_tile, vb + static_cast<size_t>(k0) * kHeadDim, tid);
      __syncthreads();
      for (int g = 0; g < kGroups; ++g) {
        unsigned packed = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int si = dot64(qr, &k_tile[(4 * g + t) * 4]);
          const float s = __fmul_rn(static_cast<float>(si), c);
          const float e = exp2f(__fsub_rn(s, m_new));
          const int p = __float2int_rz(__fadd_rn(__fmul_rn(e, 127.f), 0.5f));
          packed |= static_cast<unsigned>(p) << (8 * t);
          if (k0 + 4 * g + t < S) p_sum += p;  // padded keys stay out of l
        }
        const uint4* vg = &v_tile[g * (kHeadDim / 4)];
#pragma unroll
        for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
          const uint4 vv = vg[d4];
          pv[4 * d4 + 0] = __dp4a(static_cast<int>(packed), static_cast<int>(vv.x), pv[4 * d4 + 0]);
          pv[4 * d4 + 1] = __dp4a(static_cast<int>(packed), static_cast<int>(vv.y), pv[4 * d4 + 1]);
          pv[4 * d4 + 2] = __dp4a(static_cast<int>(packed), static_cast<int>(vv.z), pv[4 * d4 + 2]);
          pv[4 * d4 + 3] = __dp4a(static_cast<int>(packed), static_cast<int>(vv.w), pv[4 * d4 + 3]);
        }
      }
    }
    // int32 -> f32 once a block
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
      acc[d] = __fadd_rn(__fmul_rn(acc[d], alpha), static_cast<float>(pv[d]));
    }
    l = __fadd_rn(__fmul_rn(l, alpha), static_cast<float>(p_sum * 127));
    m = m_new;
  }

  if (active) {
    const float lc = fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * S + row) * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4) {
      const float x[4] = {__fdiv_rn(acc[d], lc), __fdiv_rn(acc[d + 1], lc),
                          __fdiv_rn(acc[d + 2], lc), __fdiv_rn(acc[d + 3], lc)};
      store4(orow + d, x);
    }
  }
}

}  // namespace

// Every tensor is contiguous and 16-byte aligned; bk is a multiple of 64 and
// divides Sk.  Returns a cudaError_t (0 on success); the caller raises on
// anything else.
extern "C" int int8_flash_fwd(const void* q8, const void* k8, const void* v8p, const void* sq,
                              const void* sk, void* o, int BH, int S, int Sk, int bk,
                              void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || bk <= 0 || bk % kTileK != 0 || Sk < S || Sk % bk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, BH);
  int8_flash_kernel<<<grid, kBlockQ, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8p), static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<__nv_bfloat16*>(o), S, Sk, bk);
  return static_cast<int>(cudaGetLastError());
}
