// The gelu-MLP tile of one thread block, shared by ffn_expert_kernel
// (ffn_expert.cu: one expert's slot table per block row) and
// ffn_rows_kernel (ffn_rows.cu: the rows of one token matrix):
//
//     y[r0:r0+32, :] = sum over the cluster's hidden slices of
//                      gelu_tanh(x[r0:r0+32, :] @ W1[:, h0:h0+hs]) @ W2[h0:h0+hs, :]
//
// for x (c, 512), W1 (512, dff), W2 (dff, 512), y (c, 512), float32 with
// float32 accumulation.  The pointers are already offset to one expert (or
// to the one token matrix).
//
// One block owns 32 rows and one slice of the hidden dimension (split-K over
// dff):
//   * the hidden-tile loop (64 hidden columns a tile) runs inside the block,
//     and the block's (32 x 512) f32 output sum stays in registers across it
//     (64 per thread, 8 rows x 8 columns);
//   * each (32 x 64) gelu tile is computed from x and W1 chunks streamed
//     through shared memory, written to shared memory (transposed) and read
//     back by the second product: it never reaches device memory;
//   * x, W1 and W2 chunks stream through shared memory with cp.async, two
//     stages each;
//   * ragged rows (c not a multiple of 32) and a ragged hidden dimension are
//     masked in the kernel: masked loads fill zeros (gelu(0) = 0 through zero
//     W2 rows adds nothing) and masked rows are never stored.  Nothing is
//     padded in device memory.
// The blocks of one row tile form a thread block cluster of `splits` blocks,
// one per hidden slice; each writes its partial sum to its own shared memory
// and, after a cluster barrier, each reduces a share of the output over the
// cluster's distributed shared memory in a fixed rank order.  The result is
// deterministic, with no atomics, no workspace and no memset.
//
// SIMT f32 FMAs only: no TF32, no tensor cores.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tz_ffn {

namespace cg = cooperative_groups;

constexpr int kD = 512;          // d_model: the kernels' one instantiation
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

// The hidden split of a launch: (splits, hidden columns per split) for dff
// hidden columns.  8 splits where dff has 8 hidden tiles or more.
inline void hidden_split(int64_t dff, int* splits, int* hs) {
  const int tiles = (int)((dff + kBF - 1) / kBF);
  *splits = tiles >= kMaxSplits ? kMaxSplits
            : tiles >= 4       ? 4
            : tiles >= 2       ? 2
                               : 1;
  *hs = kBF * ((tiles + *splits - 1) / *splits);
}

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

// Rows [r0, r0 + kBM) of y = gelu(x @ W1) @ W2 over this block's hidden
// slice [split * hs, split * hs + hs), summed with the cluster's other
// `splits` slices.  Every thread of the block calls it, after the cluster
// is formed; smem_raw holds kSmemBytes of dynamic shared memory.
__device__ __forceinline__ void ffn_tile(
    const float* __restrict__ xe, const float* __restrict__ w1e,
    const float* __restrict__ w2e, float* __restrict__ ye, int c, int dff,
    int r0, int split, int splits, int hs, cg::cluster_group& cluster,
    unsigned char* smem_raw) {
  Stages& sm = *reinterpret_cast<Stages*>(smem_raw);
  const int h0 = split * hs;
  const int tid = threadIdx.x;

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
        const float* src = ok ? xe + (int64_t)(r0 + row) * kD + kc * kKT + c4 * 4 : xe;
        cp_async16(&sm.x[buf][row][c4 * 4], src, ok);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // W1 chunk: 32 k x 64 hidden = 512 float4
        const int idx = tid + q * kThreads;
        const int kk = idx >> 4, c4 = idx & 15;
        const int col = f0 + c4 * 4;
        const bool ok = col < dff;
        const float* src = ok ? w1e + (int64_t)(kc * kKT + kk) * dff + col : w1e;
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
        const float* src = ok ? w2e + (int64_t)hrow * kD + c4 * 4 : w2e;
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

}  // namespace tz_ffn
