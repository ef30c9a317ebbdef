// ffn_expert: the per-expert gelu MLP of the MoE pipeline,
//   y[e] = gelu_tanh(x[e] @ W1[e]) @ W2[e]
// for x (E, C, d), W1 (E, d, dff), W2 (E, dff, d), y (E, C, d), all float32.
//
// Replaces the TPU kernel ffn_pallas_batched (tenzing_tpu/ops/ffn_pallas.py:101,
// body _ffn_batched_kernel at :74).  The TPU kernel runs a grid of (expert,
// row tile of 256, hidden tile of 512) because a whole 512 x 2048 expert pair
// does not fit its 16 MB VMEM scope, and a TPU kernel can carry the output sum
// only through the sequential hidden axis of its grid.
//
// Bound on an H100 SXM at the main path's shapes (E=8, C=304, d=512,
// dff=2048): operations.  4*E*C*d*dff = 10.2 GFLOP per launch over the 67
// TFLOP/s f32 peak outside the tensor cores is ~152 us; the bytes (x, both
// weight stacks and y once: 77 MB) take ~23 us at 3.35 TB/s.
//
// Design.  One thread block owns 32 rows of one expert and one slice of the
// hidden dimension; the blocks of one (expert, row tile) form a thread block
// cluster over the hidden slices.  The tile body (hidden-tile loop with the
// output sum in registers, the gelu tile in shared memory only, cp.async
// streaming, masking of ragged rows and hidden columns, the cluster's
// deterministic sum over distributed shared memory) is ffn_tile.cuh's,
// shared with ffn_rows.cu.
// Occupancy: 8 experts x 10 row tiles is 80 blocks for 132 SMs.  So the
// hidden dimension is split over up to 8 blocks (256 hidden columns each at
// dff=2048): 640 blocks, two resident per SM.
//
// SIMT f32 FMAs only: no TF32, no tensor cores.  This is the simple first
// version; wgmma, TMA and a bf16 or TF32 tensor-core variant come later.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_tile.cuh"

namespace {

using namespace tz_ffn;

__global__ void __launch_bounds__(kThreads, 2)
ffn_expert_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ w2, float* __restrict__ y, int c,
                  int dff, int row_tiles, int splits, int hs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());  // == blockIdx.x % splits
  const int tile = blockIdx.x / splits;                      // (expert, row tile)
  const int e = tile / row_tiles;
  const int r0 = (tile % row_tiles) * kBM;
  ffn_tile(x + (int64_t)e * c * kD, w1 + (int64_t)e * kD * dff,
           w2 + (int64_t)e * dff * kD, y + (int64_t)e * c * kD, c, dff, r0,
           split, splits, hs, cluster, smem_raw);
}

}  // namespace

// Launch on `stream`; returns the launch's CUDA error (0 on success).  d must
// be 512 and dff a multiple of 4; pointers 16-byte aligned (the wrapper checks).
extern "C" int tz_ffn_batched(const float* x, const float* w1, const float* w2,
                              float* y, int64_t e, int64_t c, int64_t d,
                              int64_t dff, void* stream) {
  if (d != kD || e < 1 || c < 1 || dff < 4 || dff % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int splits = 1, hs = kBF;
  hidden_split(dff, &splits, &hs);
  const int row_tiles = (int)((c + kBM - 1) / kBM);
  const int64_t blocks = e * row_tiles * splits;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_expert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
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
  err = cudaLaunchKernelEx(&cfg, ffn_expert_kernel, x, w1, w2, y, (int)c,
                           (int)dff, row_tiles, splits, hs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
