// Hopper (sm_90a) building blocks of the tensor-core attention kernels: the
// mbarrier, TMA and wgmma (bf16 and TF32) instructions as inline PTX, the TF32
// split, the shared-memory matrix descriptor of a tile in the 128-byte
// swizzle, and the host's tensor-map encoders.  Nothing here is a kernel: flash_attn_fwd.cu and
// flash_attn_bwd.cu compose these.
//
// The one tile layout everything agrees on: a row is 64 bf16 = 128 bytes, rows
// are 128 bytes apart, the tile starts on a 1024-byte boundary, and the 16-byte
// chunk c of row r sits at chunk c ^ (r & 7) (CU_TENSOR_MAP_SWIZZLE_128B, the
// descriptor's layout type B128).  TMA writes it, wgmma reads it, and a thread
// that writes such a tile by hand (the folded q') uses swizzled_chunk().

#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types; the function is resolved at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

constexpr int kRowBytes = 128;       // 64 bf16: one swizzle row
constexpr int kGroupBytes = 1024;    // 8 rows: one swizzle atom, the descriptor's stride

// operand lists of inline asm over a register array
#define HOPPER_REP8(X, a, o) \
  X(a[o]), X(a[o + 1]), X(a[o + 2]), X(a[o + 3]), X(a[o + 4]), X(a[o + 5]), X(a[o + 6]), X(a[o + 7])
#define HOPPER_REP16(X, a) HOPPER_REP8(X, a, 0), HOPPER_REP8(X, a, 8)
#define HOPPER_REP32(X, a) \
  HOPPER_REP8(X, a, 0), HOPPER_REP8(X, a, 8), HOPPER_REP8(X, a, 16), HOPPER_REP8(X, a, 24)
#define HOPPER_REP64(X, a)                                                                     \
  HOPPER_REP32(X, a), HOPPER_REP8(X, a, 32), HOPPER_REP8(X, a, 40), HOPPER_REP8(X, a, 48), \
      HOPPER_REP8(X, a, 56)
#define HOPPER_RW_F(x) "+f"(x)
#define HOPPER_RW_R(x) "+r"(x)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` inside a swizzled tile
__device__ __forceinline__ uint32_t swizzled_chunk(int row, int chunk) {
  return static_cast<uint32_t>(row * kRowBytes + ((chunk ^ (row & 7)) << 4));
}

// ---- arithmetic ----------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pk = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pk);
}

// exp2 as the one special-function instruction exp2f is built around.  exp2f
// wraps it in a rescale that keeps results below 2^-126 as denormals (five
// more instructions a score, on the slots the exp2 itself competes for);
// here such a p is 0, 1e-38 from the plain version's.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival, and `bytes` of TMA traffic to wait for before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  A wait
// that lasts seconds is a deadlock (a whole launch is milliseconds): trap, so
// that the launch fails instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 8000000000LL) __trap();
  }
}

// ---- TMA --------------------------------------------------------------------

// one box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`.  Coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared memory,
// both 16-byte aligned; completion is counted in bytes on `bar`
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// shared-memory writes of this thread (generic proxy) become visible to wgmma
// and TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync over `threads` threads on named barrier `id` (0 is __syncthreads's)
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Descriptor of a swizzled [rows, 64] bf16 tile (or of a slice of it) at shared
// address `addr`: start address, leading byte offset 16 (not used by this
// layout: the tile is one swizzle atom wide), stride byte offset 1024 (from one
// group of 8 rows to the next), layout type B128.  The same descriptor serves
//   - a K-major operand (q' as A, k as B: the 64 columns are the product's
//     inner dimension; the slice for inner index 16*i starts 32*i bytes on),
//   - an MN-major B operand (v: the rows are the inner dimension, the
//     instruction's transpose-B bit set; the slice for inner index 16*i starts
//     16*i rows = 2048*i bytes on).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(kGroupBytes >> 4) << 32) | (uint64_t{1} << 62);
}
constexpr uint64_t kDescKMajorStep = 32 >> 4;           // 16 inner columns on
constexpr uint64_t kDescMnMajorStep = (16 * kRowBytes) >> 4;  // 16 inner rows on

// Orders this thread's register writes (accumulators, A fragments) before the
// wgmmas that follow.  The "+f"/"+r" operands tie the compiler's schedule to
// it: the asynchronous instructions read and write registers behind its back.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most kPending of the committed groups are still running afterwards
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// a register array is pinned at this point of the program: nothing that
// computes it moves below, nothing that reads it moves above
__device__ __forceinline__ void pin(float (&x)[64]) {
  asm volatile("" : HOPPER_REP64(HOPPER_RW_F, x)::"memory");
}
__device__ __forceinline__ void pin(float (&x)[32]) {
  asm volatile("" : HOPPER_REP32(HOPPER_RW_F, x)::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&x)[32]) {
  asm volatile("" : HOPPER_REP32(HOPPER_RW_R, x)::"memory");
}
__device__ __forceinline__ void pin(float (&x)[16]) {
  asm volatile("" : HOPPER_REP16(HOPPER_RW_F, x)::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&x)[16]) {
  asm volatile("" : HOPPER_REP16(HOPPER_RW_R, x)::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&x)[8]) {
  asm volatile("" : HOPPER_REP8(HOPPER_RW_R, x, 0)::"memory");
}

// d[64 x 128] (+)= A[64 x 16] · B[128 x 16]ᵀ, bf16 in, f32 out; A and B
// K-major tiles in shared memory.  accumulate = 0 overwrites d.  Thread t of
// warp w of the warpgroup holds rows 16w + t/4 (d[4j], d[4j+1]) and + 8
// (d[4j+2], d[4j+3]) at columns 8j + 2(t%4) + {0, 1}.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_REP64(HOPPER_RW_F, d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] · B[64 x 16]ᵀ: the same with 64 columns (d[4j ..
// 4j + 3] for j < 8).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_REP32(HOPPER_RW_F, d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 16] · B[32 x 16]ᵀ: 32 columns (d[4j .. 4j + 3] for j < 4)
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_REP16(HOPPER_RW_F, d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] · B[16 x 64]; A four registers of bf16 pairs in the
// layout the accumulator above has 16 columns at a time (a[0], a[1]: rows
// t/4 and + 8 at inner index 2(t%4) + {0, 1}; a[2], a[3]: the same rows 8
// further in), B an MN-major tile in shared memory (transpose-B).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_REP32(HOPPER_RW_F, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- TF32: the f32 backward's products --------------------------------------
//
// TF32 wgmma takes both shared-memory operands K-major only (the transpose
// bits exist for 16-bit types alone), 8 inner elements = 32 bytes a step: in
// a [rows, 32] f32 tile of the 128-byte swizzle (one swizzle row a tile row)
// the slice for inner index 8*i starts 32*i bytes on, as a bf16 k16 step does,
// so tile_desc() serves it unchanged.  An f32 row of 64 is two such tiles
// (halves of the head dim) side by side: step 4 starts on the second one.

// x rounded to TF32 (10 mantissa bits, nearest, ties away from zero), as f32
// bits with the 13 dropped bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both exact TF32 values: hi·hi + hi·lo + lo·hi
// keeps ~21 bits of a product where hi·hi keeps ~11
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d[64 x 32] (+)= A[64 x 8] · B[32 x 8]ᵀ, TF32 in, f32 out; A and B K-major
// tiles in shared memory.  d as wgmma_m64n32k16_ss's.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[16], uint64_t desc_a,
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : HOPPER_REP16(HOPPER_RW_F, d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 8] · B[64 x 8]ᵀ; A four registers of TF32 values: a[0]
// row t/4, a[1] row t/4 + 8, both at inner index t%4; a[2], a[3] the same rows
// at t%4 + 4 (not the accumulator's 2(t%4), 2(t%4) + 1: see flash_attn_bwd.cu);
// B a K-major tile in shared memory.  accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t* a,
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : HOPPER_REP32(HOPPER_RW_F, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// ---- the host's tensor map ----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the library is not linked
// against (no -lcuda), so the runtime hands out its address.  nullptr if it
// cannot.
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    const bool ok = err == cudaSuccess && status == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// Tensor map over one [B, S, H, 64] bf16 tensor as (64, H, S, B), a box of
// `rows` sequence positions of one head: [rows, 64] in the swizzled tile
// layout.  The sequence is a dimension of its own, so rows past S are filled
// with zeros by the hardware and never read the next batch element.
inline cudaError_t make_head_tile_map(CUtensorMap* map, const void* base, int B, int S, int H,
                                      int rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {kRowBytes, static_cast<cuuint64_t>(H) * kRowBytes,
                                 static_cast<cuuint64_t>(S) * H * kRowBytes};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map over a 4-D f32 array (dims innermost first, strides in bytes of
// dims 1-3), boxes of `box` in the 128-byte swizzle: box[0] must be 32 (one
// swizzle row).  The f32 backward's workspaces, whose shapes it chooses.
inline cudaError_t make_f32_tile_map(CUtensorMap* map, const void* base,
                                     const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
                                     const cuuint32_t (&box)[4]) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
