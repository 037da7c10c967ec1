// SAME-padded stride-1 3x3 convolution with fused bias and optional ReLU, for
// Hopper (sm_90a): an implicit GEMM on wgmma for bf16, and a direct kernel on
// the FMA pipes for f32 and for bf16 inputs whose channel count TMA cannot
// stride over.
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
// masked in the kernels.
//
// What bounds it on an H100 (N = 16, bf16): 504x504, 64 -> 32 channels is
// 1.5e11 FLOP against ~0.78 GB of x and out, so the memory (0.23 ms at
// 3.35 TB/s) binds it ahead of the bf16 tensor cores (0.15 ms); 128 -> 32
// likewise (0.39 ms); 288x288, 256 -> 128 is 7.8e11 FLOP against ~1.0 GB, so
// compute binds it (0.79 ms at 989 TFLOP/s).
//
// Design of the bf16 kernel (conv3x3_wgmma_kernel<kN>): an implicit GEMM, M =
// output pixels, N = output channels (kN = 32 or 128 a CTA), K = 9 taps x C in
// steps of 16, both operands of every product in shared memory.
//   - Persistent CTAs, one an SM, walk units of (frame, tile of kPH x kPW
//     output pixels, strip of kN output channels), the strips of one pixel
//     tile next to each other; two consumer warpgroups and a producer warp
//     (288 threads).  A warpgroup owns kMT M-tiles of 64 pixels, each an 8 x
//     8 patch: the image sizes (504, 288) are multiples of 8, so no M row is
//     wasted inside the image.
//   - The input comes by TMA: per unit and chunk of 64 channels one box
//     (64, kInW, kPH + 2, 1) of a 4-D tensor map over NHWC (C, W, H, N),
//     started at (c0, w0 - 1, h0 - 1, n), kInW = kPW + 8 wide (the halo
//     rounded up to whole 8-pixel groups).  The hardware fills what lies
//     outside the image (and channels past C) with zeros: that is the SAME
//     padding, with no halo code.  A pixel is one 128-byte row of the
//     128-byte swizzle; the map's strides must be multiples of 16 bytes, so
//     C % 8 == 0.
//   - The taps are shifted views of that one staged tile: for tap (dh, dw)
//     and M-tile (mr, mc) the A operand is a descriptor starting at staged
//     pixel (8 mr + dh, 8 mc + dw), its 8-pixel groups kInW pixels apart (a
//     multiple of 1024 bytes, so every group sits at the same offset in its
//     swizzle atom).  A start one or two rows into an atom reads right with
//     the base-offset field at 0: the card swizzles by address bits.
//   - The weights are cast to bf16 once, by the wrapper, into the B layout
//     with the swizzle applied ([strip][chunk][tap][kN][64]: pack_weights in
//     ops/conv3x3.py), so one bulk copy a tap lands them ready; they stream
//     through a ring of kWStages slots, the input through kInStages, each
//     with a full/empty mbarrier pair and a producer thread of its own (one
//     ring never waits behind the other's free slot).
//   - Per tap a warpgroup issues 4 x kMT products (m64nKNk16) as one group
//     and waits for the tap before: the tensor cores always hold a tap's
//     work, and the weight slot of the tap before is handed back.  Every
//     chunk runs all four k16 steps: past C both operands are zeros, and a
//     step skipped by a test serializes every wgmma (ptxas C7520).
//   - Epilogue from the accumulators: f32 bias (staged in shared memory
//     once a CTA, at most 1024 channels), ReLU, one rounding to bf16, stores
//     masked at the ragged edges in H, W and COUT.
// Measured (H100 at 700 W, tools/conv3x3_stages.py; PERF.md section 6):
// 0.43 / 0.73 / 1.18 ms at head2-small / head2-large / head1-large against
// bounds of 0.233 / 0.388 / 0.792 and F.conv2d's 1.06 / 1.71 / 1.69 (from
// 4.0 / 7.6 / 18.9 on the FMA pipes).  The memory path alone (no products)
// takes 0.33 / 0.51 / 0.52, the products without loads after the rings'
// first fill 0.42 / 0.73 / 1.08: the head2 shapes are held by the products
// and the epilogue as much as by the bytes.  With the bias read from global
// memory in the epilogue the three took 0.57 / 0.85 / 1.48; with A from
// registers (ldmatrix) in place of the shifted views, 17-25% more.
// The direct kernel (conv3x3_kernel<T>) is the first design: one CTA per
// (frame, 16 x 32 pixels, 32 channels) on the f32 FMA pipes, the input tile
// with its halo and the weights staged in shared memory as f32 in chunks of 8
// channels, a 2 x 4 patch x 8 channels a thread.  It serves f32, and bf16
// when C % 8 != 0 (the wrapper's shape rule).
// Measured: PERF.md, section 6.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Bound to PyTorch with ctypes (da3slam_tpu_torch/ops/conv3x3.py).

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: implicit GEMM on wgmma
// ---------------------------------------------------------------------------

using hopper::kGroupBytes;
using hopper::kRowBytes;

constexpr int kChunk = 64;        // input channels a staged box: one 128-byte pixel row
constexpr int kGemmConsumers = 2;  // consumer warpgroups
constexpr int kGemmThreads = 128 * kGemmConsumers + 32;  // + the producer warp
constexpr int kInStages = 2;      // input ring depth
constexpr int kMaxCout = 1024;    // output channels (strips rounded up) the bias stage holds

// The CTA's tile for an output-channel strip of kN: kMT M-tiles (8 x 8
// pixels) a warpgroup over a kPH x kPW pixel tile, staged kInW pixels wide
// (the halo, rounded up to whole 8-pixel groups); kWStages weight slots.
template <int kN>
struct GemmTile;
template <>
struct GemmTile<32> {
  static constexpr int kMT = 4, kPH = 16, kPW = 32, kInW = kPW + 8, kWStages = 9;
};
template <>
struct GemmTile<128> {
  static constexpr int kMT = 2, kPH = 16, kPW = 16, kInW = kPW + 8, kWStages = 6;
};

// Descriptor of a K-major A view of the staged tile at shared address
// `addr`: 64 pixel rows of 128 bytes, 8-pixel groups kInW pixels apart (the
// stride byte offset), the 128-byte swizzle.  The view may start on any
// 128-byte row of a swizzle atom: the card applies the swizzle by the row's
// own address bits, so the base-offset field stays 0 (a base offset of
// (addr >> 7) & 7 reads wrong rows on an H100).
template <int kInW>
__device__ __forceinline__ uint64_t view_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>((kInW * kRowBytes) >> 4) << 32) | (uint64_t{1} << 62);
}

// d += A[64 x 16] . B[kN x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n32k16_ss(d, a, b, 1);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n128k16_ss(d, a, b, 1);
}

// The unit u of the walk: (frame, tile row, tile column, channel strip), the
// strips of one pixel tile next to each other (its input stays in L2)
struct Unit {
  int n, h0, w0, strip;
};
__device__ __forceinline__ Unit unit_of(int u, int tiles_h, int tiles_w, int strips, int ph,
                                        int pw) {
  Unit r;
  r.strip = u % strips;
  u /= strips;
  r.w0 = (u % tiles_w) * pw;
  u /= tiles_w;
  r.h0 = (u % tiles_h) * ph;
  r.n = u / tiles_h;
  return r;
}

template <int kN>
__global__ void __launch_bounds__(kGemmThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __nv_bfloat16* __restrict__ w_packed, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int H, int W, int C, int COUT, int tiles_h,
                     int tiles_w, int n_units, int relu) {
  using Tile = GemmTile<kN>;
  constexpr int kMT = Tile::kMT, kPH = Tile::kPH, kPW = Tile::kPW;
  constexpr int kWStages = Tile::kWStages;
  constexpr int kInW = Tile::kInW;
  constexpr int kBoxBytes = (kPH + 2) * kInW * kRowBytes;
  constexpr int kInBytes = (kBoxBytes + kGroupBytes - 1) / kGroupBytes * kGroupBytes;
  constexpr int kWBytes = kN * kRowBytes;  // one tap's [kN][64] slice
  constexpr int kTilesW = kPW / 8;         // M-tiles across the pixel tile
  static_assert(kPH / 8 * kTilesW == kGemmConsumers * kMT, "M-tiles cover the pixel tile");
  static_assert(kInW % 8 == 0, "8-pixel groups a whole number of swizzle atoms apart");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kGroupBytes - (hopper::smem_addr(smem_raw) & (kGroupBytes - 1))) &
                              (kGroupBytes - 1));
  const uint32_t in_ring = hopper::smem_addr(smem);
  const uint32_t w_ring = in_ring + kInStages * kInBytes;
  const uint32_t in_full = w_ring + kWStages * kWBytes;
  const uint32_t in_empty = in_full + kInStages * 8;
  const uint32_t w_full = in_empty + kInStages * 8;
  const uint32_t w_empty = w_full + kWStages * 8;
  float* bias_s = reinterpret_cast<float*>(smem + kInStages * kInBytes + kWStages * kWBytes +
                                           2 * (kInStages + kWStages) * 8);

  const int n_chunks = (C + kChunk - 1) / kChunk;
  const int strips = (COUT + kN - 1) / kN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kInStages; ++s) {
      hopper::mbar_init(in_full + s * 8, 1);
      hopper::mbar_init(in_empty + s * 8, 4 * kGemmConsumers);  // one arrival a consumer warp
    }
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(w_full + s * 8, 1);
      hopper::mbar_init(w_empty + s * 8, 4 * kGemmConsumers);
    }
    hopper::mbar_init_fence();
  }
  // the bias of every strip, zeros past COUT: read by the epilogues from
  // shared memory (from global memory its loads, after the last products,
  // took a quarter of the time at head1-large)
  for (int i = threadIdx.x; i < strips * kN; i += kGemmThreads) {
    bias_s[i] = i < COUT ? bias[i] : 0.f;
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kGemmConsumers) {
    // ---- producers: one thread a ring, each walking the same units ----
    const int lane = threadIdx.x - kGemmConsumers * 128;
    if (lane > 1) return;
    int fill = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const Unit t = unit_of(u, tiles_h, tiles_w, strips, kPH, kPW);
      for (int c = 0; c < n_chunks; ++c) {
        if (lane == 0) {
          // the input box of this unit and chunk
          const int s = fill % kInStages;
          if (fill >= kInStages) hopper::mbar_wait(in_empty + s * 8, ((fill / kInStages) + 1) & 1);
          hopper::mbar_arrive_expect_tx(in_full + s * 8, kBoxBytes);
          hopper::tma_load_4d(in_ring + s * kInBytes, &x_map, in_full + s * 8, c * kChunk,
                              t.w0 - 1, t.h0 - 1, t.n);
          ++fill;
          continue;
        }
        // the chunk's nine weight slices
        const __nv_bfloat16* wsrc =
            w_packed + (static_cast<size_t>(t.strip) * n_chunks + c) * 9 * kN * kChunk;
        for (int tap = 0; tap < 9; ++tap) {
          const int ws = fill % kWStages;
          if (fill >= kWStages) hopper::mbar_wait(w_empty + ws * 8, ((fill / kWStages) + 1) & 1);
          hopper::mbar_arrive_expect_tx(w_full + ws * 8, kWBytes);
          hopper::bulk_load_1d(w_ring + ws * kWBytes, wsrc + tap * kN * kChunk, kWBytes,
                               w_full + ws * 8);
          ++fill;
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int tw = threadIdx.x % 128;
  const int warp = tw >> 5;
  const int lane = tw & 31;
  int in_i = 0, w_i = 0;
  float acc[kMT][kN / 2];
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const Unit t = unit_of(u, tiles_h, tiles_w, strips, kPH, kPW);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) acc[i][e] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = in_i % kInStages;
      hopper::mbar_wait(in_full + s * 8, (in_i / kInStages) & 1);
      const uint32_t tile = in_ring + s * kInBytes;
      int prev_ws = -1;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int ws = w_i % kWStages;
        hopper::mbar_wait(w_full + ws * 8, (w_i / kWStages) & 1);
        const uint64_t w_desc = hopper::tile_desc(w_ring + ws * kWBytes);
        const int shift = (tap / 3) * kInW + tap % 3;
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks) {
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            const int mt = wg * kMT + i;
            const int pix = 8 * (mt / kTilesW) * kInW + 8 * (mt % kTilesW) + shift;
            wgmma_ss(acc[i], view_desc<kInW>(tile + pix * kRowBytes + ks * 32),
                     w_desc + ks * hopper::kDescKMajorStep);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (prev_ws >= 0 && lane == 0) hopper::mbar_arrive(w_empty + prev_ws * 8);
        prev_ws = ws;
        ++w_i;
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kMT; ++i) hopper::pin(acc[i]);
      if (lane == 0) {
        hopper::mbar_arrive(w_empty + prev_ws * 8);
        hopper::mbar_arrive(in_empty + s * 8);
      }
      ++in_i;
    }

    // bias, ReLU, one rounding; accumulator row 16*warp + lane/4 + 8r of an
    // M-tile is its pixel (2*warp + r, lane/4), column 8j + c2 (+1)
    const int c2 = (lane & 3) * 2;
    const int co0 = t.strip * kN;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int mt = wg * kMT + i;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = t.h0 + 8 * (mt / kTilesW) + 2 * warp + r;
        const int w = t.w0 + 8 * (mt % kTilesW) + (lane >> 2);
        if (h >= H || w >= W) continue;
        __nv_bfloat16* orow = out + ((static_cast<size_t>(t.n) * H + h) * W + w) * COUT;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const int co = co0 + 8 * j + c2;
          if (co >= COUT) continue;
          float y0 = acc[i][4 * j + 2 * r] + bias_s[co];
          float y1 = acc[i][4 * j + 2 * r + 1] + bias_s[co + 1];
          if (relu) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
          if ((COUT & 1) == 0) {
            *reinterpret_cast<uint32_t*>(orow + co) = hopper::pack_bf16(y0, y1);
          } else {
            orow[co] = __float2bfloat16_rn(y0);
            if (co + 1 < COUT) orow[co + 1] = __float2bfloat16_rn(y1);
          }
        }
      }
    }
  }
}

// Tensor map over NHWC bf16 x as (C, W, H, N), boxes of 64 channels x box_w
// x box_h pixels of one frame in the 128-byte swizzle; what lies outside the
// tensor (the halo past the image, channels past C) is filled with zeros.
// The strides must be multiples of 16 bytes: C % 8 == 0.
inline cudaError_t make_input_map(CUtensorMap* map, const void* x, int N, int H, int W, int C,
                                  int box_w, int box_h) {
  const hopper::EncodeTiledFn encode = hopper::encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = static_cast<cuuint64_t>(C) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const cuuint32_t box[4] = {kChunk, static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kN>
int launch_wgmma(const void* x, const void* w_packed, const void* bias, void* out, int N, int H,
                 int W, int C, int COUT, int relu, void* stream) {
  using Tile = GemmTile<kN>;
  constexpr int kBoxBytes = (Tile::kPH + 2) * Tile::kInW * kRowBytes;
  constexpr int kInBytes = (kBoxBytes + kGroupBytes - 1) / kGroupBytes * kGroupBytes;
  // the rings, the four barrier arrays, the bias; 1024 more to align the tiles
  constexpr int kSmemBytes = kGroupBytes + kInStages * kInBytes + Tile::kWStages * kN * kRowBytes +
                             2 * (kInStages + Tile::kWStages) * 8 + kMaxCout * 4;
  static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
  const int tiles_h = (H + Tile::kPH - 1) / Tile::kPH;
  const int tiles_w = (W + Tile::kPW - 1) / Tile::kPW;
  const int strips = (COUT + kN - 1) / kN;
  const long long units = static_cast<long long>(N) * tiles_h * tiles_w * strips;
  if (units > 0x7fffffff || strips * kN > kMaxCout) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map;
  cudaError_t err = make_input_map(&x_map, x, N, H, W, C, Tile::kInW, Tile::kPH + 2);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<kN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(units < sms ? units : sms);
  conv3x3_wgmma_kernel<kN><<<grid, kGemmThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, static_cast<const __nv_bfloat16*>(w_packed), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W, C, COUT, tiles_h, tiles_w,
      static_cast<int>(units), relu);
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

// x and out bf16 NHWC, C % 8 == 0, x 16-byte aligned; w_packed the weights
// as pack_weights (ops/conv3x3.py) lays them out for n_tile = 32 or 128
// output channels a strip, COUT rounded up to strips at most 1024; bias
// [COUT] f32.  Returns a cudaError_t (0 on success).
extern "C" int conv3x3_wgmma_fwd(const void* x, const void* w_packed, const void* bias, void* out,
                                 int N, int H, int W, int C, int COUT, int n_tile, int relu,
                                 void* stream) {
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || C <= 0 || C % 8 != 0 || COUT <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tile == 32) return launch_wgmma<32>(x, w_packed, bias, out, N, H, W, C, COUT, relu, stream);
  if (n_tile == 128) {
    return launch_wgmma<128>(x, w_packed, bias, out, N, H, W, C, COUT, relu, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
