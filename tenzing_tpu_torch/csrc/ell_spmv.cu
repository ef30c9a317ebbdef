// ell_spmv: y[i] = sum_j vals[i, j] * x[cols[i, j]] over an ELL slab.
//
// Replaces the TPU kernel ell_spmv_pallas (tenzing_tpu/ops/spmv_pallas.py:78).
// On the TPU, Mosaic cannot gather wider than one 128-lane vreg, so that kernel
// pads w to 128 and m to its row block, and sweeps x in 128-lane vregs with a
// masked in-vreg gather per vreg: work n/128 x m x w.  None of that carries
// over.  Here x (at most 4096 float32, 16 KB; the gate `supports`) is staged
// whole into shared memory once per block, and each row is summed by a group of
// G threads (G = the power of two >= w, at most 32) over its w columns,
// gathering from shared memory and reducing with warp shuffles.  Ragged m and
// any w are handled here; nothing is padded in device memory.
//
// Bound on an H100 SXM: bytes, vals and cols read once (8 bytes an entry), x
// read once and y written once, at 3.35 TB/s.  At the slab sizes of the SpMV
// iteration that is well under a microsecond, so launch overhead sets the time.
// The grid is at most two blocks per SM so that x is staged few times.
//
// The simple first version: no vectorized slab loads, no cache hints.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void ell_spmv_kernel(const float* __restrict__ vals,
                                const int* __restrict__ cols,
                                const float* __restrict__ x,
                                float* __restrict__ y, int64_t m, int64_t w,
                                int n) {
  extern __shared__ float xs[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = x[i];
  __syncthreads();
  const int lane = threadIdx.x % G;
  const int64_t rows_per_block = kThreads / G;
  const int64_t stride = (int64_t)gridDim.x * rows_per_block;
  // r0 is uniform over the block, so every thread of a warp runs the same
  // number of iterations and the shuffles below see the whole warp
  for (int64_t r0 = (int64_t)blockIdx.x * rows_per_block; r0 < m; r0 += stride) {
    const int64_t row = r0 + threadIdx.x / G;
    float acc = 0.0f;
    if (row < m) {
      const float* vr = vals + row * w;
      const int* cr = cols + row * w;
      for (int64_t j = lane; j < w; j += G) acc += vr[j] * xs[cr[j]];
    }
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2)
      acc += __shfl_down_sync(0xffffffffu, acc, off, G);
    if (row < m && lane == 0) y[row] = acc;
  }
}

int g_sms = 0;

template <int G>
int launch(const float* vals, const int* cols, const float* x, float* y,
           int64_t m, int64_t w, int n, cudaStream_t stream) {
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (g_sms < 1) g_sms = 1;
  }
  const int64_t rows_per_block = kThreads / G;
  int64_t blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks > 2 * (int64_t)g_sms) blocks = 2 * (int64_t)g_sms;
  if (blocks < 1) blocks = 1;
  ell_spmv_kernel<G><<<(unsigned)blocks, kThreads, (size_t)n * sizeof(float),
                       stream>>>(vals, cols, x, y, m, w, n);
  return (int)cudaGetLastError();
}

}  // namespace

// y (m) := the ELL product of vals (m, w) float32, cols (m, w) int32 and
// x (n <= 4096) float32, on `stream`; returns cudaGetLastError().
extern "C" int tz_ell_spmv(const void* vals, const void* cols, const void* x,
                           void* y, int64_t m, int64_t w, int64_t n,
                           void* stream) {
  const float* v = static_cast<const float*>(vals);
  const int* c = static_cast<const int*>(cols);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  cudaStream_t s = (cudaStream_t)stream;
  const int nn = (int)n;
  if (w <= 1) return launch<1>(v, c, xx, yy, m, w, nn, s);
  if (w <= 2) return launch<2>(v, c, xx, yy, m, w, nn, s);
  if (w <= 4) return launch<4>(v, c, xx, yy, m, w, nn, s);
  if (w <= 8) return launch<8>(v, c, xx, yy, m, w, nn, s);
  if (w <= 16) return launch<16>(v, c, xx, yy, m, w, nn, s);
  return launch<32>(v, c, xx, yy, m, w, nn, s);
}
