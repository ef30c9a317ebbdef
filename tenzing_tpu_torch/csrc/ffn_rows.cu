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
// shared memory in chunks and the hidden dimension is split over a thread
// block cluster; a ragged n is masked in the kernel, with no padding copy.
//
// Bound on an H100 SXM at the slice's shape (one chunk of the layer at world
// size 1: n=2048, d=512, dff=2048): operations.  4*n*d*dff = 8.59 GFLOP over
// the 67 TFLOP/s f32 peak outside the tensor cores is ~128 us; the bytes
// (x, W1, W2 and y once: 16.8 MB) take ~5 us at 3.35 TB/s.
//
// Design: ffn_tile.cuh's tile body, the arithmetic of ffn_expert.cu's
// kernel.  The launch is a grid of (hidden splits, row tiles of 32) with a
// cluster of `splits` blocks along x: one cluster per row tile, no expert
// axis.  At n=2048 that is 64 row tiles x 8 splits = 512 blocks, two
// resident per SM.
//
// SIMT f32 FMAs only: no TF32, no tensor cores.  A bf16 x (the reference's
// h cast to x's dtype between the products) is not instantiated; wgmma and
// TMA come later.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_tile.cuh"

namespace {

using namespace tz_ffn;

__global__ void __launch_bounds__(kThreads, 2)
ffn_rows_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ w2, float* __restrict__ y, int n,
                int dff, int hs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());  // == blockIdx.x
  const int splits = static_cast<int>(gridDim.x);
  const int r0 = static_cast<int>(blockIdx.y) * kBM;
  ffn_tile(x, w1, w2, y, n, dff, r0, split, splits, hs, cluster, smem_raw);
}

}  // namespace

// Launch on `stream`; returns the launch's CUDA error (0 on success).  d must
// be 512 and dff a multiple of 4; pointers 16-byte aligned (the wrapper checks).
extern "C" int tz_ffn_rows(const float* x, const float* w1, const float* w2,
                           float* y, int64_t n, int64_t d, int64_t dff,
                           void* stream) {
  if (d != kD || n < 1 || dff < 4 || dff % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int splits = 1, hs = kBF;
  hidden_split(dff, &splits, &hs);
  const int64_t row_tiles = (n + kBM - 1) / kBM;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;  // grid y limit
  cudaError_t err = cudaFuncSetAttribute(
      ffn_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)row_tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ffn_rows_kernel, x, w1, w2, y, (int)n,
                           (int)dff, hs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
