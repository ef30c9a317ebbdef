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
// hidden dimension (split-K over dff):
//   * the hidden-tile loop (64 hidden columns a tile) runs inside the block,
//     and the block's (32 x 512) f32 output sum stays in registers across it
//     (64 per thread, 8 rows x 8 columns);
//   * each (32 x 64) gelu tile is computed from x and W1 chunks streamed
//     through shared memory, written to shared memory (transposed) and read
//     back by the second product: it never reaches device memory;
//   * x, W1 and W2 chunks stream through shared memory with cp.async, two
//     stages each;
//   * ragged rows (C = 304 is not a multiple of 32) and a ragged hidden
//     dimension are masked in the kernel: masked loads fill zeros (gelu(0) =
//     0 through zero W2 rows adds nothing) and masked rows are never stored.
//     Nothing is padded in device memory.
// Occupancy: 8 experts x 10 row tiles is 80 blocks for 132 SMs.  So the
// hidden dimension is split over up to 8 blocks (256 hidden columns each at
// dff=2048): 640 blocks, two resident per SM.  The blocks of one (expert,
// row tile) form a thread block cluster; each writes its partial sum to its
// own shared memory and, after a cluster barrier, each reduces a share of the
// output over the cluster's distributed shared memory in a fixed rank order.
// The result is deterministic, with no atomics, no workspace and no memset.
//
// SIMT f32 FMAs only: no TF32, no tensor cores.  This is the simple first
// version; wgmma, TMA and a bf16 or TF32 tensor-core variant come later.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 512;          // d_model: the kernel's one instantiation
constexpr int kBM = 32;          // rows (slots) per block
constexpr int kBF = 64;          // hidden tile: one gelu tile is kBM x kBF
constexpr int kKT = 32;          // k chunk of x @ W1
constexpr int kJT = 8;           // W2 rows per chunk of gelu @ W2
constexpr int kThreads = 256;
constexpr int kMaxSplits = 8;    // the portable cluster size limit
constexpr int kXStride = kKT + 4;  // padded row of the x chunk (bank spread)

struct Stages {
  float x[2][kBM][kXStride];     // x rows, one k chunk per stage
  float w1[2][kKT][kBF];         // W1[k chunk, hidden tile]
  float h[kBF][kBM];             // the gelu tile, transposed
  float w2[2][kJT][kD];          // W2[hidden rows, :]
};
// after the loop the same memory holds the block's (kBM x kD) partial sum
constexpr size_t kPartBytes = sizeof(float) * kBM * kD;
constexpr size_t kSmemBytes =
    sizeof(Stages) > kPartBytes ? sizeof(Stages) : kPartBytes;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the tanh form of gelu (jax.nn.gelu's default; torch's approximate="tanh")
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * v * (1.0f + tanhf(k0 * (v + k1 * v * v * v)));
}

__global__ void __launch_bounds__(kThreads, 2)
ffn_expert_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ w2, float* __restrict__ y, int c,
                  int dff, int row_tiles, int splits, int hs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stages& sm = *reinterpret_cast<Stages*>(smem_raw);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());  // == blockIdx.x % splits
  const int tile = blockIdx.x / splits;                      // (expert, row tile)
  const int e = tile / row_tiles;
  const int r0 = (tile % row_tiles) * kBM;
  const int h0 = split * hs;
  const int tid = threadIdx.x;

  const float* xe = x + (int64_t)e * c * kD;
  const float* w1e = w1 + (int64_t)e * kD * dff;
  const float* w2e = w2 + (int64_t)e * dff * kD;

  // x @ W1 mapping: 2 rows x 4 hidden columns per thread
  const int tr = tid >> 4, tc = tid & 15;
  // gelu @ W2 mapping: 8 rows x (4 + 4) output columns per thread
  const int rg = tid >> 6, cgp = tid & 63;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int f0 = h0; f0 < h0 + hs; f0 += kBF) {
    // ---- gelu tile: h = gelu(x[r0:r0+32, :] @ W1[:, f0:f0+64]) -------------
    auto issue_w1 = [&](int kc, int buf) {
      {  // x chunk: 32 rows x 32 k = 256 float4, one per thread
        const int row = tid >> 3, c4 = tid & 7;
        const bool ok = r0 + row < c;
        const float* src = ok ? xe + (int64_t)(r0 + row) * kD + kc * kKT + c4 * 4 : x;
        cp_async16(&sm.x[buf][row][c4 * 4], src, ok);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // W1 chunk: 32 k x 64 hidden = 512 float4
        const int idx = tid + q * kThreads;
        const int kk = idx >> 4, c4 = idx & 15;
        const int col = f0 + c4 * 4;
        const bool ok = col < dff;
        const float* src = ok ? w1e + (int64_t)(kc * kKT + kk) * dff + col : w1;
        cp_async16(&sm.w1[buf][kk][c4 * 4], src, ok);
      }
    };
    float a1[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a1[i][j] = 0.f;
    constexpr int nk = kD / kKT;
    issue_w1(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) issue_w1(kc + 1, (kc + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int buf = kc & 1;
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 4) {
        const float4 xa = *reinterpret_cast<const float4*>(&sm.x[buf][2 * tr][kk]);
        const float4 xb = *reinterpret_cast<const float4*>(&sm.x[buf][2 * tr + 1][kk]);
        const float xs[2][4] = {{xa.x, xa.y, xa.z, xa.w}, {xb.x, xb.y, xb.z, xb.w}};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w = *reinterpret_cast<const float4*>(&sm.w1[buf][kk + q][4 * tc]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            a1[i][0] = fmaf(xs[i][q], w.x, a1[i][0]);
            a1[i][1] = fmaf(xs[i][q], w.y, a1[i][1]);
            a1[i][2] = fmaf(xs[i][q], w.z, a1[i][2]);
            a1[i][3] = fmaf(xs[i][q], w.w, a1[i][3]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.h[4 * tc + j][2 * tr + i] = gelu_tanh(a1[i][j]);
    __syncthreads();

    // ---- acc += h @ W2[f0:f0+64, :] -----------------------------------------
    auto issue_w2 = [&](int jc, int buf) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // 8 rows x 512 = 1024 float4
        const int idx = tid + q * kThreads;
        const int jj = idx >> 7, c4 = idx & 127;
        const int hrow = f0 + jc * kJT + jj;
        const bool ok = hrow < dff;
        const float* src = ok ? w2e + (int64_t)hrow * kD + c4 * 4 : w2;
        cp_async16(&sm.w2[buf][jj][c4 * 4], src, ok);
      }
    };
    constexpr int nj = kBF / kJT;
    issue_w2(0, 0);
    cp_async_commit();
    for (int jc = 0; jc < nj; ++jc) {
      if (jc + 1 < nj) issue_w2(jc + 1, (jc + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int buf = jc & 1;
#pragma unroll
      for (int j = 0; j < kJT; ++j) {
        const float4 ha = *reinterpret_cast<const float4*>(&sm.h[jc * kJT + j][8 * rg]);
        const float4 hb = *reinterpret_cast<const float4*>(&sm.h[jc * kJT + j][8 * rg + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&sm.w2[buf][j][4 * cgp]);
        const float4 b1 = *reinterpret_cast<const float4*>(&sm.w2[buf][j][256 + 4 * cgp]);
        const float hv[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(hv[i], b0.x, acc[i][0]);
          acc[i][1] = fmaf(hv[i], b0.y, acc[i][1]);
          acc[i][2] = fmaf(hv[i], b0.z, acc[i][2]);
          acc[i][3] = fmaf(hv[i], b0.w, acc[i][3]);
          acc[i][4] = fmaf(hv[i], b1.x, acc[i][4]);
          acc[i][5] = fmaf(hv[i], b1.y, acc[i][5]);
          acc[i][6] = fmaf(hv[i], b1.z, acc[i][6]);
          acc[i][7] = fmaf(hv[i], b1.w, acc[i][7]);
        }
      }
      __syncthreads();
    }
  }

  // ---- the cluster's sum over its hidden slices, in rank order --------------
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem_raw);  // (kBM, kD)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = part + (8 * rg + i) * kD;
    *reinterpret_cast<float4*>(row + 4 * cgp) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 256 + 4 * cgp) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  cluster.sync();  // every partial written and visible to the cluster
  float* ye = y + (int64_t)e * c * kD;
  constexpr int n4 = kBM * kD / 4;
  for (int i = tid + split * kThreads; i < n4; i += kThreads * splits) {
    const int row = i / (kD / 4), c4 = i % (kD / 4);
    if (r0 + row >= c) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float4 p = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, r))[i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    *reinterpret_cast<float4*>(ye + (int64_t)(r0 + row) * kD + c4 * 4) = s;
  }
  cluster.sync();  // no block leaves while another still reads its memory
}

}  // namespace

// Launch on `stream`; returns the launch's CUDA error (0 on success).  d must
// be 512 and dff a multiple of 4; pointers 16-byte aligned (the wrapper checks).
extern "C" int tz_ffn_batched(const float* x, const float* w1, const float* w2,
                              float* y, int64_t e, int64_t c, int64_t d,
                              int64_t dff, void* stream) {
  if (d != kD || e < 1 || c < 1 || dff < 4 || dff % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)((dff + kBF - 1) / kBF);
  const int splits = tiles >= kMaxSplits ? kMaxSplits
                     : tiles >= 4       ? 4
                     : tiles >= 2       ? 2
                                        : 1;
  const int hs = kBF * ((tiles + splits - 1) / splits);
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
