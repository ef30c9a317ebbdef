// halo_unpack: scatter a received face into the ghost shell of the grid U, in
// place.
//
// Replaces the TPU kernels unpack_face_pallas (tenzing_tpu/ops/halo_pallas.py:221),
// unpack_face_pallas_batched (:318) and unpack_face_flat_pallas (:446).  On the
// TPU all three read-modify-write the tile-aligned window around the cut
// (halo_pallas.py:241-246); here the kernel writes exactly the cut:
//
//     U[q, x0+i, y0+j, z0+k] = face[((q*sx + i)*sy + j)*sz + k]
//
// Writing only the cut matters on CUDA: two unpacks may run at once on two
// lane streams, and a window read-modify-write would race on the elements the
// windows share.  The face is read from a contiguous buffer: the 4D face (or
// the first nq*sx*sy*sz elements of the (rows, 128) staging buffer for the flat
// slot).  rows_per_block keeps each menu slot's blocking, as in halo_pack.
//
// Bound on an H100 SXM: data movement, 2 x nq*sx*sy*sz*4 bytes at 3.35 TB/s.
// Reads are coalesced; writes are coalesced along z for x- and y-faces, while
// a z-face writes 3 floats of every 640-float grid row (partial sectors).
//
// The simple first version: one element per thread per step, 64-bit offsets,
// no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElemsPerThread = 4;

__global__ void halo_unpack_kernel(float* __restrict__ u,
                                   const float* __restrict__ face,
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
  const int64_t face0 = (q * sx + row0) * plane;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += step) {
    const int64_t r = e / plane;
    const int64_t rem = e - r * plane;
    const int64_t j = rem / sz;
    const int64_t k = rem - j * sz;
    u[((q * X + x0 + row0 + r) * Y + y0 + j) * Z + z0 + k] = face[face0 + e];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// checks shapes, bounds and rows_per_block | sx before calling.
extern "C" int tz_halo_unpack(float* u, const float* face,
                              int64_t nq, int64_t X, int64_t Y, int64_t Z,
                              int64_t x0, int64_t y0, int64_t z0,
                              int64_t sx, int64_t sy, int64_t sz,
                              int64_t rows_per_block, void* stream) {
  const int64_t n = rows_per_block * sy * sz;
  int64_t bx = (n + kThreads * kElemsPerThread - 1) / (kThreads * kElemsPerThread);
  if (bx < 1) bx = 1;
  if (bx > 65535) bx = 65535;
  dim3 grid((unsigned)bx, (unsigned)(nq * (sx / rows_per_block)));
  halo_unpack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      u, face, X, Y, Z, x0, y0, z0, sx, sy, sz, rows_per_block);
  return (int)cudaGetLastError();
}
