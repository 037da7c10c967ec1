// SAME-padded stride-1 3x3 convolution with fused bias and optional ReLU, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel da3slam_tpu/ops/conv3x3.py:_kernel (reached through
// conv3x3_fused), written for the DPT head's narrow-channel output stages.
//
// Math (identical to conv3x3_reference):
//   out[n, h, w, co] = act( bias[co] + sum_{dh, dw, c}
//       x[n, h + dh - 1, w + dw - 1, c] * round_to_T(kernel[dh, dw, c, co]) )
// with x zero outside the image, the HWIO kernel cast to x's type T, the sum
// and the f32 bias in f32, act = ReLU or the identity, and the result rounded
// to T.  Layouts: x and out NHWC, kernel [3, 3, C, COUT] f32, bias [COUT] f32.
//
// What is not carried over from the TPU kernel: its "dh-folded tap panel" (a
// [P, 3*COUT] f32 panel in scratch, then three shifted slice-adds), the
// channel padding to 128 and the width padding to a multiple of 8.  They fed
// a 128x128 matrix unit and its DMA tiling; here they would only move zeros.
// The height need not tile evenly either: the ragged edge in H and W is
// masked in the kernel.
//
// What bounds it on an H100 (N = 16, bf16): 504x504, 64 -> 32 channels is
// 1.5e11 FLOP against ~0.78 GB of x and out, so the memory (0.23 ms at
// 3.35 TB/s) binds it ahead of the bf16 tensor cores (0.15 ms); 288x288,
// 256 -> 128 is 7.8e11 FLOP against ~1.0 GB, so compute binds it (0.79 ms at
// 989 TFLOP/s).
//
// Design, and why it is enough for now: a direct convolution on the f32 FMA
// pipes.  One CTA per (frame, tile of 16 x 32 output pixels, strip of 32
// output channels), 256 threads.  The input tile with its one-pixel halo
// (18 x 34) and the weights are staged in shared memory as f32 in chunks of 8
// input channels, channel-major, so that a thread's reads of neighbouring
// pixels are 16-byte vectors without bank conflicts.  Each thread owns a
// 2 x 4 patch of pixels times 8 output channels: 64 f32 accumulators; per
// input channel it reads the patch's 4 x 6 input window once and each tap's 8
// weights as two broadcast vectors, 26 shared-memory loads for 576 FMAs.  Each
// input byte is read from device memory once per 32-channel output strip, the
// halo (19%) and the other strips' repeats coming from L2.  It is capped by
// the card's f32 rate (67 TFLOP/s), an order of magnitude under the bf16
// tensor cores: the correct baseline.  The fast form is an implicit GEMM on
// wgmma with the taps as nine accumulated products over shifted views of one
// staged tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/conv3x3.py).

#include "flash_common.cuh"

namespace {

using flash::from_f32;
using flash::round_to;
using flash::to_f32;
using flash::Vec16;

constexpr int kThreads = 256;
constexpr int kTileH = 16;     // output rows per CTA: 8 warps x 2 rows
constexpr int kTileW = 32;     // output columns per CTA: 8 lanes x 4 columns
constexpr int kCoutTile = 32;  // output channels per CTA: 4 lane groups x 8
constexpr int kCk = 8;         // input channels per staged chunk
constexpr int kInH = kTileH + 2;
constexpr int kInW = kTileW + 2;
constexpr int kInWPad = 36;    // row stride in floats: rows stay 16-byte aligned

// 8 consecutive channels of one pixel -> f32 (C % 8 == 0 keeps p 16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float* out) {
  Vec16<float>::load(p, out);
  Vec16<float>::load(p + 4, out + 4);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  Vec16<__nv_bfloat16>::load(p, out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out, int H, int W, int C,
               int COUT, int tiles_w, int relu) {
  __shared__ __align__(16) float x_s[kCk][kInH][kInWPad];
  __shared__ __align__(16) float w_s[9][kCk][kCoutTile];

  const int tid = threadIdx.x;
  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * kCoutTile;
  const int n = blockIdx.z;
  const int pr0 = (tid >> 5) * 2;        // the thread's two rows within the tile
  const int pc0 = (tid & 7) * 4;         // its four columns
  const int og = ((tid & 31) >> 3) * 8;  // its eight output channels within the strip
  const bool vec = (C % kCk) == 0;
  const T* xn = x + static_cast<size_t>(n) * H * W * C;

  float acc[2][4][8];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][b][c] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCk) {
    __syncthreads();  // the previous chunk has been consumed
    // the input tile and its halo; zeros outside the image and past C
    for (int idx = tid; idx < kInH * kInW; idx += kThreads) {
      const int r = idx / kInW;
      const int col = idx - r * kInW;
      const int h = h0 + r - 1;
      const int wc = w0 + col - 1;
      float v[kCk];
#pragma unroll
      for (int c = 0; c < kCk; ++c) v[c] = 0.f;
      if (h >= 0 && h < H && wc >= 0 && wc < W) {
        const T* p = xn + (static_cast<size_t>(h) * W + wc) * C + c0;
        if (vec) {
          load8(p, v);
        } else {
          for (int c = 0; c < kCk && c0 + c < C; ++c) v[c] = to_f32(p[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kCk; ++c) x_s[c][r][col] = v[c];
    }
    // the chunk's weights, rounded to T; zeros past C and COUT
    for (int idx = tid; idx < 9 * kCk * kCoutTile; idx += kThreads) {
      const int co = idx % kCoutTile;
      const int c = (idx / kCoutTile) % kCk;
      const int tap = idx / (kCoutTile * kCk);
      float v = 0.f;
      if (c0 + c < C && co0 + co < COUT) {
        v = round_to<T>(w[(static_cast<size_t>(tap) * C + c0 + c) * COUT + co0 + co]);
      }
      w_s[tap][c][co] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < kCk; ++c) {
      float xr[4][6];  // the 2 x 4 patch's input window
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&x_s[c][pr0 + r][pc0]);
        const float2 b = *reinterpret_cast<const float2*>(&x_s[c][pr0 + r][pc0 + 4]);
        xr[r][0] = a.x; xr[r][1] = a.y; xr[r][2] = a.z; xr[r][3] = a.w;
        xr[r][4] = b.x; xr[r][5] = b.y;
      }
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float4 wa = *reinterpret_cast<const float4*>(&w_s[dh * 3 + dw][c][og]);
          const float4 wb = *reinterpret_cast<const float4*>(&w_s[dh * 3 + dw][c][og + 4]);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
            for (int pc = 0; pc < 4; ++pc) {
              const float xv = xr[pr + dh][pc + dw];
#pragma unroll
              for (int co = 0; co < 8; ++co) acc[pr][pc][co] = fmaf(xv, wv[co], acc[pr][pc][co]);
            }
          }
        }
      }
    }
  }

  // bias, activation, rounding; the ragged edges in H, W and COUT are masked
  float bv[8];
#pragma unroll
  for (int co = 0; co < 8; ++co) bv[co] = co0 + og + co < COUT ? bias[co0 + og + co] : 0.f;
  const bool vec_out = (COUT % 8) == 0;
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    const int h = h0 + pr0 + pr;
    if (h >= H) continue;
#pragma unroll
    for (int pc = 0; pc < 4; ++pc) {
      const int wc = w0 + pc0 + pc;
      if (wc >= W) continue;
      float r[8];
#pragma unroll
      for (int co = 0; co < 8; ++co) {
        const float y = acc[pr][pc][co] + bv[co];
        r[co] = relu ? fmaxf(y, 0.f) : y;
      }
      T* p = out + ((static_cast<size_t>(n) * H + h) * W + wc) * COUT + co0 + og;
      if (vec_out) {
        if (co0 + og < COUT) {
          flash::store4(p, r);
          flash::store4(p + 4, r + 4);
        }
      } else {
        for (int co = 0; co < 8 && co0 + og + co < COUT; ++co) p[co] = from_f32<T>(r[co]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int N, int H, int W,
           int C, int COUT, int relu, void* stream) {
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const dim3 grid(tiles_h * tiles_w, (COUT + kCoutTile - 1) / kCoutTile, N);
  conv3x3_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), H, W, C, COUT, tiles_w, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out); w [3, 3, C, COUT] and bias
// [COUT] are f32.  Returns a cudaError_t (0 on success).
extern "C" int conv3x3_fwd(const void* x, const void* w, const void* bias, void* out, int N,
                           int H, int W, int C, int COUT, int dtype, int relu, void* stream) {
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || C <= 0 || COUT <= 0 ||
      (COUT + kCoutTile - 1) / kCoutTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch<float>(x, w, bias, out, N, H, W, C, COUT, relu, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, bias, out, N, H, W, C, COUT, relu, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
