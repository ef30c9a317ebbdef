// The f32 online-softmax fold of one tile of query rows, shared by the
// attn_fold_f32 kernel (attn_fold.cu) and the attn_fold body of the
// fused_region kernel (fused_region.cu).
//
// For each query row in [row0, min(row0 + kRows, n)):
//
//     s = q k^T * scale;  m' = max(m, rowmax s);  alpha = exp(m - m');
//     p = exp(s - m');    l' = l alpha + rowsum p;  acc' = acc alpha + p v
//
// over the nkv keys of k / v, the state written in place.  The pointers are
// already offset to one batch element (and, for k / v, to the block's first
// key); row strides are arguments, the last dim is contiguous.  m and l are
// carried broadcast along d: column 0 is read, every column is written.
//
// 256 threads on the SIMT units, no TF32, expf (not __expf).  The Q tile sits
// in shared memory; K and V stream through one shared 64-key tile (K for the
// first product, then V).  Thread (ty, tx) = (t / 16, t % 16) owns query rows
// ty + 16 i (i < 4) for both products, so its rows' m, l and acc[4][d/16]
// (columns tx + 16 j) stay in registers and the row reductions are
// half-warp shuffles.  Shared rows are padded by one float so the strided
// column reads of the first product are conflict-free: smem_bytes<128>() is
// 82,688 bytes, two blocks per SM.  m starts at -1e30 (the reference's init):
// alpha = expf(-1e30 - m') = 0, never NaN.  Masked query rows load zeros, stay
// finite and are never stored; masked keys get s = -inf, so p = 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tz_attn_f32 {

constexpr int kThreads = 256;
constexpr int kRows = 64;          // query rows per tile
constexpr int kKeys = 64;          // keys per shared K/V tile
constexpr int kRowsPerThread = 4;  // rows ty + 16 i
constexpr int kColsPerThread = 4;  // s columns tx + 16 j
constexpr int kLdP = kKeys + 1;

template <int kHeadDim>
constexpr int smem_bytes() {
  return (2 * kRows * (kHeadDim + 1) + kRows * kLdP) * (int)sizeof(float);
}

template <int kHeadDim>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int64_t row0,
                                          int64_t nrows) {
  constexpr int kLd = kHeadDim + 1;
  static_assert((kRows * kHeadDim) % kThreads == 0, "tile must split evenly");
#pragma unroll 8
  for (int it = 0; it < kRows * kHeadDim / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = e / kHeadDim;
    const int c = e - r * kHeadDim;
    dst[r * kLd + c] = row0 + r < nrows ? src[(row0 + r) * row_stride + c] : 0.0f;
  }
}

// Fold the nkv keys of k / v into the state of query rows [row0, row0 + kRows)
// below n.  Every thread of the block calls it; smem holds smem_bytes<kHeadDim>().
template <int kHeadDim>
__device__ __forceinline__ void fold_rows(
    float* __restrict__ smem, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ acc, float* __restrict__ m, float* __restrict__ l,
    int64_t row0, int64_t n, int64_t nkv, int64_t q_sr, int64_t k_sr,
    int64_t v_sr, int64_t st_sr, float scale) {
  constexpr int kLd = kHeadDim + 1;
  constexpr int kDCols = kHeadDim / 16;  // acc columns per thread
  float* qs = smem;                    // [kRows][kLd]
  float* kvs = qs + kRows * kLd;       // [kKeys][kLd]: K, then V
  float* ps = kvs + kKeys * kLd;       // [kRows][kLdP]
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  __syncthreads();  // a previous tile's readers of the shared tiles are done
  load_tile<kHeadDim>(qs, q, q_sr, row0, n);

  float m_r[kRowsPerThread], l_r[kRowsPerThread];
  float a_r[kRowsPerThread][kDCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = row0 + ty + 16 * i;
    const bool live = row < n;
    m_r[i] = live ? m[row * st_sr] : 0.0f;
    l_r[i] = live ? l[row * st_sr] : 0.0f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j)
      a_r[i][j] = live ? acc[row * st_sr + tx + 16 * j] : 0.0f;
  }

  for (int64_t kv0 = 0; kv0 < nkv; kv0 += kKeys) {
    __syncthreads();  // the previous tile's readers of kvs and ps are done
    load_tile<kHeadDim>(kvs, k, k_sr, kv0, nkv);
    __syncthreads();

    // s = q k^T * scale for rows ty + 16 i, keys tx + 16 j
    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < kHeadDim; ++d) {
      float qa[kRowsPerThread], kb[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qa[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) kb[j] = kvs[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

    // online softmax per row: the 16 threads of a row are one half-warp
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const bool valid = kv0 + tx + 16 * j < nkv;
        s[i][j] = valid ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDCols; ++j) a_r[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done with K; ps is complete
    load_tile<kHeadDim>(kvs, v, v_sr, kv0, nkv);
    __syncthreads();

    // acc += p v for rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float pa[kRowsPerThread], vb[kDCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pa[i] = ps[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int j = 0; j < kDCols; ++j) vb[j] = kvs[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kDCols; ++j) a_r[i][j] = fmaf(pa[i], vb[j], a_r[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) {
      const int64_t off = row * st_sr + tx + 16 * j;
      acc[off] = a_r[i][j];
      m[off] = m_r[i];
      l[off] = l_r[i];
    }
  }
}

}  // namespace tz_attn_f32
