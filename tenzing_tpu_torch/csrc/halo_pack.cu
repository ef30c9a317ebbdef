// halo_pack: gather one halo face cut of the grid U into a contiguous buffer.
//
// Replaces the TPU kernels pack_face_pallas (tenzing_tpu/ops/halo_pallas.py:189),
// pack_face_pallas_batched (:266) and pack_face_flat_pallas (:385).  The three
// differ on the TPU only in DMA choreography (one aligned window per row, BX
// rows per step with a two-slot prefetch, or an in-VMEM relayout to the
// (rows, 128) staging layout); what they compute is the same gather:
//
//     out[((q*sx + i)*sy + j)*sz + k] = U[q, x0+i, y0+j, z0+k]
//
// The contiguous output IS the staging layout's first nq*sx*sy*sz elements, so
// the flat slot (.pallasf) passes the staging buffer and the other slots a 4D
// face tensor.  rows_per_block keeps each menu slot's blocking: blockIdx.y
// walks (q, batch of rows_per_block face rows), blockIdx.x splits the batch.
//
// Bound on an H100 SXM: data movement, 2 x nq*sx*sy*sz*4 bytes (each face
// element read once, written once) at 3.35 TB/s.  The writes are coalesced;
// the reads are coalesced along z for x- and y-faces, while a z-face reads 3
// consecutive floats of every 640-float grid row, so it moves whole 32-byte
// sectors for 12 useful bytes and stays far from the bound.
//
// The simple first version: one element per thread per step, 64-bit offsets
// (U at the 512^3 flagship is 2,068,684,800 bytes), no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElemsPerThread = 4;

__global__ void halo_pack_kernel(const float* __restrict__ u,
                                 float* __restrict__ out,
                                 int64_t X, int64_t Y, int64_t Z,
                                 int64_t x0, int64_t y0, int64_t z0,
                                 int64_t sx, int64_t sy, int64_t sz,
                                 int64_t rows_per_block) {
  const int64_t nb = sx / rows_per_block;
  const int64_t q = blockIdx.y / nb;
  const int64_t b = blockIdx.y - q * nb;
  const int64_t plane = sy * sz;
  const int64_t n = rows_per_block * plane;
  const int64_t row0 = b * rows_per_block;
  const int64_t out0 = (q * sx + row0) * plane;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += step) {
    const int64_t r = e / plane;
    const int64_t rem = e - r * plane;
    const int64_t j = rem / sz;
    const int64_t k = rem - j * sz;
    out[out0 + e] = u[((q * X + x0 + row0 + r) * Y + y0 + j) * Z + z0 + k];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, bounds and rows_per_block | sx before calling.
extern "C" int tz_halo_pack(const float* u, float* out,
                            int64_t nq, int64_t X, int64_t Y, int64_t Z,
                            int64_t x0, int64_t y0, int64_t z0,
                            int64_t sx, int64_t sy, int64_t sz,
                            int64_t rows_per_block, void* stream) {
  const int64_t n = rows_per_block * sy * sz;
  int64_t bx = (n + kThreads * kElemsPerThread - 1) / (kThreads * kElemsPerThread);
  if (bx < 1) bx = 1;
  if (bx > 65535) bx = 65535;
  dim3 grid((unsigned)bx, (unsigned)(nq * (sx / rows_per_block)));
  halo_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      u, out, X, Y, Z, x0, y0, z0, sx, sy, sz, rows_per_block);
  return (int)cudaGetLastError();
}
