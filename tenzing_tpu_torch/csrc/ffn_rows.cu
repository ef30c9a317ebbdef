// ffn_rows: the gelu MLP of one token matrix,
//   y = gelu_tanh(x @ W1) @ W2
// for x (n, d), W1 (d, dff), W2 (dff, d), y (n, d), all float32, any n.
//
// Replaces the TPU kernel ffn_pallas (tenzing_tpu/ops/ffn_pallas.py:43, body
// _ffn_kernel at :32), the .pallas expert slot of the expert-parallel MoE
// layer (models/moe.py ExpertFFNPallas).  The TPU kernel runs one program per
// 512-row tile of x with both weight matrices whole in VMEM, and pads a
// ragged n up to the tile.  On Hopper neither weight matrix fits a block's
// shared memory (4 MB each at d=512, dff=2048), so the weights stream through
// shared memory in 32-deep chunks; a ragged n is masked in the kernel, with
// no padding copy.
//
// Bound on an H100 SXM at the slice's shape (one chunk of the layer at world
// size 1: n=2048, d=512, dff=2048): operations.  4*n*d*dff = 8.59 GFLOP as
// three TF32 products (the split) at 495 TFLOP/s is ~52 us (~128 us at the
// 67 TFLOP/s f32 peak outside the tensor cores); the bytes (x, W1, W2 and y
// once: 16.8 MB) take ~5 us at 3.35 TB/s.
//
// Design: ffn_tile.cuh's split-TF32 wgmma body at one expert, the
// arithmetic of ffn_expert.cu's kernel, through the caller's workspace h
// (n, dff).  At n=2048 the first launch is 16 row tiles x 16 column tiles
// (256 CTAs), the second 64 tiles split 2 ways over the hidden dimension.
//
// bf16 (tz_ffn_rows_bf16): x, W1, W2 and y in bf16, as the reference's
// _ffn_kernel computes them for a bf16 x: both products accumulate in f32,
// h = gelu_tanh(x @ W1) is rounded to bf16 between them, and y is rounded
// to bf16 when it is written.  Tensor cores through mma.sync m16n8k16 (bf16
// in, f32 accumulate), as attn_fold.cu's bf16 path.  A block owns 16 rows
// and all 512 output columns; its 8 warps loop over the hidden dimension in
// tiles of 64:
//   * the block's x rows sit in shared memory for the whole loop;
//   * per tile, W1[:, tile] and W2[tile, :] are staged transposed into shared
//     memory (16-byte global loads), so every mma B fragment is one 32-bit
//     shared load;
//   * warp w computes h[:, 8w:8w+8] over k = 512 (32 mma), applies the gelu
//     in f32, rounds to bf16 and writes it to shared memory; after a barrier
//     each warp adds h_tile @ W2[tile, 64w:64w+64] (4 k-steps x 8 n-tiles)
//     into its 16 x 64 f32 sum in registers;
//   * after the loop each warp rounds its sum to bf16 and stores it.
// Ragged n is masked (zero rows in, no store out); a d_ff that is not a
// multiple of 64 is masked by zero W1 columns and W2 rows (gelu(0) = 0).
// Bound at the slice's shape (n=2048, d=512, dff=2048): 8.59 GFLOP over the
// 989 TFLOP/s bf16 tensor-core peak is 8.7 us; the bytes (x, W1, W2 and y
// once in bf16: 8.4 MB) take 2.5 us at 3.35 TB/s, so the operations bound
// it.  This first version re-stages the weights in every block (from L2)
// and runs one block per SM; it is simple, not fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_tile.cuh"

namespace {

using namespace tz_ffn;

__global__ void __launch_bounds__(kThreads, 1)
ffn_rows_kernel(const __grid_constant__ Gemm g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_cta(g, smem_raw);
}

// -- bf16 ---------------------------------------------------------------------

constexpr int kBRows = 16;          // rows per block (one m16 tile)
constexpr int kBTile = 64;          // hidden tile
constexpr int kBWarps = 8;
constexpr int kBThreads = kBWarps * 32;
constexpr int kXLd = kD + 8;        // bf16 pitch of the x rows (bank spread)
constexpr int kW1Ld = kD + 8;       // W1 tile transposed: [hidden][k]
constexpr int kHLd = kBTile + 8;    // h tile: [row][hidden]
constexpr int kW2Ld = kBTile + 8;   // W2 tile transposed: [out column][hidden]
constexpr size_t kBSmemBytes =
    sizeof(__nv_bfloat16) *
    ((size_t)kBRows * kXLd + (size_t)kBTile * kW1Ld + (size_t)kBRows * kHLd +
     (size_t)kD * kW2Ld);

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b for one m16n8k16 tile: a row-major 16x16, b "col" 16x8, f32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment of rows [0, 16) and columns [k0, k0 + 16) of a row-major
// bf16 tile with pitch ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int k0, int g, int t) {
  a[0] = lds32(base + g * ld + k0 + 2 * t);
  a[1] = lds32(base + (g + 8) * ld + k0 + 2 * t);
  a[2] = lds32(base + g * ld + k0 + 8 + 2 * t);
  a[3] = lds32(base + (g + 8) * ld + k0 + 8 + 2 * t);
}

__global__ void __launch_bounds__(kBThreads, 1)
ffn_rows_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w1,
                     const __nv_bfloat16* __restrict__ w2,
                     __nv_bfloat16* __restrict__ y, int n, int dff) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w1t = xs + kBRows * kXLd;
  __nv_bfloat16* hs = w1t + kBTile * kW1Ld;
  __nv_bfloat16* w2t = hs + kBRows * kHLd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kBRows;

  // the block's x rows, zero past n (8 bf16 per 16-byte load)
  for (int i = tid; i < kBRows * (kD / 8); i += kBThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      v = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * kD + c);
    *reinterpret_cast<uint4*>(xs + r * kXLd + c) = v;
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int h0 = 0; h0 < dff; h0 += kBTile) {
    __syncthreads();  // the previous tile's readers are done
    // W1[:, h0:h0+64] -> w1t[hidden][k]; W2[h0:h0+64, :] -> w2t[col][hidden]
    for (int i = tid; i < kD * (kBTile / 8); i += kBThreads) {
      const int k = i / (kBTile / 8), c = (i % (kBTile / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (h0 + c < dff)
        v = *reinterpret_cast<const uint4*>(w1 + (size_t)k * dff + h0 + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) w1t[(c + q) * kW1Ld + k] = e[q];
    }
    for (int i = tid; i < kBTile * (kD / 8); i += kBThreads) {
      const int hr = i / (kD / 8), c = (i % (kD / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (h0 + hr < dff)
        v = *reinterpret_cast<const uint4*>(w2 + (size_t)(h0 + hr) * kD + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) w2t[(c + q) * kW2Ld + hr] = e[q];
    }
    __syncthreads();
    // h[:, 8w:8w+8] = gelu(x @ W1[:, tile]) in f32, rounded to bf16
    float hacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k0 = 0; k0 < kD; k0 += 16) {
      uint32_t a[4];
      load_a(a, xs, kXLd, k0, g, t);
      const __nv_bfloat16* b = w1t + (warp * 8 + g) * kW1Ld + k0 + 2 * t;
      mma_bf16(hacc, a, lds32(b), lds32(b + 8));
    }
    const int hc = warp * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(hs + g * kHLd + hc) =
        pack_bf16(gelu_tanh(hacc[0]), gelu_tanh(hacc[1]));
    *reinterpret_cast<uint32_t*>(hs + (g + 8) * kHLd + hc) =
        pack_bf16(gelu_tanh(hacc[2]), gelu_tanh(hacc[3]));
    __syncthreads();
    // y[:, 64w:64w+64] += h_tile @ W2[tile, 64w:64w+64]
#pragma unroll
    for (int k0 = 0; k0 < kBTile; k0 += 16) {
      uint32_t a[4];
      load_a(a, hs, kHLd, k0, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* b =
            w2t + (warp * 64 + j * 8 + g) * kW2Ld + k0 + 2 * t;
        mma_bf16(acc[j], a, lds32(b), lds32(b + 8));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = warp * 64 + j * 8 + 2 * t;
    if (r0 + g < n)
      *reinterpret_cast<uint32_t*>(y + (size_t)(r0 + g) * kD + c) =
          pack_bf16(acc[j][0], acc[j][1]);
    if (r0 + g + 8 < n)
      *reinterpret_cast<uint32_t*>(y + (size_t)(r0 + g + 8) * kD + c) =
          pack_bf16(acc[j][2], acc[j][3]);
  }
}

}  // namespace

// bf16: launch on `stream`; returns the launch's CUDA error.  d must be 512
// and dff a multiple of 8; pointers 16-byte aligned (the wrapper checks).
extern "C" int tz_ffn_rows_bf16(const void* x, const void* w1, const void* w2,
                                void* y, int64_t n, int64_t d, int64_t dff,
                                void* stream) {
  if (d != kD || n < 1 || dff < 8 || dff % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kBRows - 1) / kBRows;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_rows_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBSmemBytes);
  if (err != cudaSuccess) return (int)err;
  ffn_rows_bf16_kernel<<<(unsigned)blocks, kBThreads, kBSmemBytes,
                         (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<__nv_bfloat16*>(y),
      (int)n, (int)dff);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns the launches' first CUDA error (0 on
// success).  d must be 512 and dff a multiple of 4; h is a (n, dff) float32
// workspace; pointers 16-byte aligned (the wrapper checks).
extern "C" int tz_ffn_rows(const float* x, const float* w1, const float* w2,
                           float* y, float* h, int64_t n, int64_t d,
                           int64_t dff, void* stream) {
  if (d != kD || n < 1 || n > 0x7fffffff || dff < 4 || dff % 4 != 0 ||
      dff > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return run_ffn(ffn_rows_kernel, x, w1, w2, y, h, 1, n, dff,
                 (cudaStream_t)stream);
}
