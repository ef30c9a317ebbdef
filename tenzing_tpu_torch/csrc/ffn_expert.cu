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
// dff=2048): operations.  4*E*C*d*dff = 10.2 GFLOP per launch, computed as
// three TF32 products (the split) at 495 TFLOP/s, is ~62 us (~152 us at the
// 67 TFLOP/s f32 peak outside the tensor cores); the bytes (x, both weight
// stacks and y once: 77 MB) take ~23 us at 3.35 TB/s.
//
// Design: ffn_tile.cuh's split-TF32 wgmma body, shared with ffn_rows.cu: two
// launches of one GEMM body, the first with a gelu epilogue into the
// caller's workspace h (E, C, dff), the second from h.  At the main path's
// shapes the first launch is 8 experts x 3 row tiles of 128 x 16 column
// tiles of 128 = 384 CTAs, the second 96 tiles, unsplit (split_k: a split
// over the hidden dimension read slower at 96 tiles for 132 SMs).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_tile.cuh"

namespace {

using namespace tz_ffn;

__global__ void __launch_bounds__(kThreads, 1)
ffn_expert_kernel(const __grid_constant__ Gemm g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_cta(g, smem_raw);
}

}  // namespace

// Launch on `stream`; returns the launches' first CUDA error (0 on success).
// d must be 512 and dff a multiple of 4; h is a (e, c, dff) float32
// workspace; pointers 16-byte aligned (the wrapper checks).
extern "C" int tz_ffn_batched(const float* x, const float* w1, const float* w2,
                              float* y, float* h, int64_t e, int64_t c,
                              int64_t d, int64_t dff, void* stream) {
  if (d != kD || e < 1 || c < 1 || c > 0x7fffffff || dff < 4 || dff % 4 != 0 ||
      dff > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return run_ffn(ffn_expert_kernel, x, w1, w2, y, h, e, c, dff,
                 (cudaStream_t)stream);
}

// The f32 body's launch constants (tz_ffn::config).
extern "C" int tz_ffn_f32_config(int64_t* out) {
  config(out);
  return 0;
}

// The tiling of one launch of the body for (experts, m, n, k) on `sms` SMs:
// out = row tiles, column tiles, splits, chunks per split, CTAs.
extern "C" int tz_ffn_f32_plan(int64_t experts, int64_t m, int64_t n,
                               int64_t k, int64_t sms, int64_t* out) {
  Gemm g = {};
  g.m = (int)m;
  g.n = (int)n;
  g.k = (int)k;
  const int64_t blocks = plan(g, experts, (int)sms);
  out[0] = g.m_tiles;
  out[1] = g.n_tiles;
  out[2] = g.splits;
  out[3] = g.chunks_per_split;
  out[4] = blocks;
  return 0;
}
