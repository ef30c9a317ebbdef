// ell_spmv: y[i] = sum_j vals[i, j] * x[cols[i, j]] over an ELL slab.
//
// Replaces the TPU kernel ell_spmv_pallas (tenzing_tpu/ops/spmv_pallas.py:78).
// On the TPU, Mosaic cannot gather wider than one 128-lane vreg, so that kernel
// pads w to 128 and m to its row block, and sweeps x in 128-lane vregs with a
// masked in-vreg gather per vreg: work n/128 x m x w.  None of that carries
// over.
//
// Bound on an H100 SXM: bytes, vals and cols read once (8 bytes an entry), x
// read once and y written once, at 3.35 TB/s: 0.445 us at the --m 8192
// path's (8192, 22) slab with x of 4093, far below the launch itself.  So
// the design cuts dependent round trips, not bytes:
// - One row a thread, 32 rows a warp, the slab covered in one wave
//   (kWarps warps a block: 128 blocks of 64 rows at m = 8192).
// - No copy of x: x (at most 4096 float32, the gate `supports`) is read-only
//   during the launch, so its gathers go through the L1 read-only path
//   (__ldg), kXBatch of them issued before the first is used.
// - A warp's 32 rows are one contiguous piece of the slab: its lanes copy
//   the piece's 16-byte aligned part into the warp's shared memory with
//   16-byte cp.async copies, every copy issued before the first wait, so the
//   slab costs one round trip to device memory.  A row that reaches outside
//   the aligned part (the last row of a ragged m where m w % 4 != 0), every
//   row wider than kSlabWidth and every row of a slab whose vals or cols
//   base is off 16 bytes (a view into a larger buffer) is read from global
//   memory by its thread.  (A warp's first row starts 32 w elements on, a
//   multiple of 4: it never reaches outside.)
//   Reading every row from global memory instead read 0.2-1.6 us slower
//   at m = 8192 under a write flush, 7.8-9.1 us against 7.4-7.6, in three
//   calls on different cards (bench/ell_spmv.py --ablate, unstaged;
//   PERF.md).
// - A row sums in ell_row.cuh's fixed order, shared with fused_region.cu's
//   ELL members, so two launches agree bit for bit.
// Ragged m and any w are handled here; nothing is padded in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"

namespace {

constexpr int kWarps = 2;        // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kSlabWidth = 32;   // widest row staged in shared memory
constexpr int kPieceFloats = 32 * kSlabWidth + 4;  // + 4: the aligned start
constexpr int kBlocksPerSm = 16; // grid cap: larger slabs loop over pieces
static_assert(kPieceFloats * 4 % 16 == 0, "pieces stay 16-byte aligned");

struct Piece {
  float vals[kPieceFloats];
  int cols[kPieceFloats];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    ell_spmv_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                    const float* __restrict__ x, float* __restrict__ y,
                    int64_t m, int64_t w, bool staged) {
  __shared__ __align__(16) Piece pieces[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Piece& pc = pieces[warp];
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t r0 = ((int64_t)blockIdx.x * kWarps + warp) * 32; r0 < m;
       r0 += step) {
    const int64_t r1 = r0 + 32 < m ? r0 + 32 : m;
    // the piece's elements [r0 w, r1 w): its aligned part [a0, a1), staged
    // from the float b0 on
    const int64_t b0 = (r0 * w) & ~(int64_t)3;
    const int64_t a0 = (r0 * w + 3) & ~(int64_t)3;
    int64_t a1 = (r1 * w) & ~(int64_t)3;
    if (!staged || a1 < a0) a1 = a0;
    for (int64_t q = a0 + 4 * lane; q < a1; q += 4 * 32) {
      cp_async16(&pc.vals[q - b0], vals + q);
      cp_async16(&pc.cols[q - b0], cols + q);
    }
    cp_async_wait_all();
    __syncwarp();
    const int64_t row = r0 + lane;
    if (row < m) {
      const int64_t e = row * w;
      y[row] = e >= a0 && e + w <= a1
                   ? tz_ell::row_sum<tz_ell::kShared, false>(
                         &pc.vals[e - b0], &pc.cols[e - b0], x, w)
                   : tz_ell::row_sum<tz_ell::kGlobal, false>(vals + e, cols + e,
                                                             x, w);
    }
    __syncwarp();  // the piece is read before the next one overwrites it
  }
}

// The empty launch of the kernel's grid: the floor under its time
// (bench/ell_spmv.py, chip_smoke.py).
__global__ void __launch_bounds__(kThreads) ell_spmv_empty_kernel() {}

int g_sms = 0;

// The kernel's grid at m rows: a block of kThreads rows each, at most
// kBlocksPerSm a SM.
unsigned grid_blocks(int64_t m) {
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (g_sms < 1) g_sms = 1;
  }
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kBlocksPerSm * (int64_t)g_sms) blocks = kBlocksPerSm * (int64_t)g_sms;
  return (unsigned)blocks;
}

}  // namespace

// y (m) := the ELL product of vals (m, w) float32, cols (m, w) int32 and
// x (n <= 4096) float32, on `stream`; returns cudaGetLastError().
extern "C" int tz_ell_spmv(const void* vals, const void* cols, const void* x,
                           void* y, int64_t m, int64_t w, int64_t n,
                           void* stream) {
  if (m < 1 || w < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const bool staged = w <= kSlabWidth &&
                      ((uintptr_t)vals | (uintptr_t)cols) % 16 == 0;
  ell_spmv_kernel<<<grid_blocks(m), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(vals), static_cast<const int*>(cols),
      static_cast<const float*>(x), static_cast<float*>(y), m, w, staged);
  return (int)cudaGetLastError();
}

// An empty kernel on tz_ell_spmv's grid at m rows, on `stream`.
extern "C" int tz_ell_spmv_floor(int64_t m, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  ell_spmv_empty_kernel<<<grid_blocks(m), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
