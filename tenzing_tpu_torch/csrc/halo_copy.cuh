// The halo face copy shared by halo_pack.cu (U -> face) and halo_unpack.cu
// (face -> U): the launch plan and the SIMT body.  The design and its bounds
// are described at the top of halo_pack.cu and halo_unpack.cu;
// tests/test_torch_halo_plan.py mirrors the plan in Python and reads the
// constants below from this file.
//
// The cut: U is a contiguous float32 (nq, X, Y, Z) grid, the cut starts at
// (0, x0, y0, z0) with sizes (nq, sx, sy, sz), and the face is the cut laid
// out contiguously: face[((q*sx + i)*sy + j)*sz + k] = U[q, x0+i, y0+j, z0+k].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tz_halo {

// The unpack's TMA body (halo_unpack.cu)
constexpr int kConsumerWarps = 4;   // warps that store a box out
constexpr int kTmaThreads = 32 * (1 + kConsumerWarps);  // + the producer warp
// picked on an H100 by bench/halo_kernels.py --sweep (PERF.md): many small
// boxes, all in flight at once, beat deep rings
constexpr int kBoxBytes = 8192;     // a box's target size
constexpr int kStages = 3;          // boxes in flight per block
constexpr int kBlocksPerSm = 8;     // TMA blocks per SM in the grid
constexpr int kMaxStages = 8;
constexpr int kMaxBoxDim = 256;     // TMA's limit on a box dimension
constexpr int kStageAlign = 128;    // a box's shared-memory alignment
constexpr int kSmemLimit = 232448;  // shared memory of one block
// The SIMT body (both kernels)
constexpr int kSimtThreads = 256;
constexpr int kSimtRuns = 4;        // runs in flight per thread
constexpr int kMaxDevices = 64;
// the ring's share: the block's limit less its barriers
constexpr int kRingLimit = kSmemLimit - 16 * kMaxStages;
static_assert(kStages >= 2 && kStages <= kMaxStages, "ring depth");

enum Body : int64_t { kAuto = 0, kTma = 1, kSimt = 2 };

struct Cut {
  int64_t nq, X, Y, Z, x0, y0, z0, sx, sy, sz;
};

// What one call launches (tz_halo_plan writes it out as kPlanFields int64s,
// in this order).  TMA: the box (bz, by, bx) in elements along z, y, x, the
// ring depth, the number of boxes.  SIMT: lanes per run (a power of two) and
// the number of runs (q, i, j).
struct Plan {
  int64_t body, bz, by, bx, stages, boxes, group, runs, grid, threads, smem;
};
constexpr int kPlanFields = 11;

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t clamp(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// TMA loads an unpack's face boxes: a 16-byte aligned face and rows of a
// multiple of 16 bytes.  U is written by plain stores, so its alignment does
// not matter; a pack has no TMA body.
inline bool tma_fits(const Cut& c, const void* face) {
  return (uintptr_t)face % 16 == 0 && c.sz % 4 == 0;
}

// Balanced extents: the fewest boxes of at most `cap` along a dim of `n`,
// all of one size.
inline int64_t balanced(int64_t n, int64_t cap) {
  return cdiv(n, cdiv(n, cap));
}

// The plan, all but the TMA body's grid (tma_grid: it needs the SM count,
// which the SIMT body does without).
inline int make_plan(const Cut& c, const void* face, bool pack, int64_t body,
                     Plan* p) {
  const int64_t lim = (int64_t)1 << 31;
  if (c.nq < 1 || c.sx < 1 || c.sy < 1 || c.sz < 1 || c.X >= lim ||
      c.Y >= lim || c.Z >= lim || c.nq >= lim || c.nq * c.sx * c.sy >= lim)
    return (int)cudaErrorInvalidValue;
  const bool fits = !pack && tma_fits(c, face);
  if (body == kAuto) body = fits ? kTma : kSimt;
  if ((body == kTma && !fits) || (body != kTma && body != kSimt))
    return (int)cudaErrorInvalidValue;
  memset(p, 0, sizeof *p);
  p->body = body;
  if (body == kSimt) {
    int64_t g = 1;
    while (g < c.sz && g < kSimtThreads) g *= 2;
    p->group = g;
    p->runs = c.nq * c.sx * c.sy;
    p->threads = kSimtThreads;
    p->grid = cdiv(p->runs, (kSimtThreads / g) * kSimtRuns);
    return 0;
  }
  p->stages = kStages;
  p->bz = cdiv(balanced(c.sz, kMaxBoxDim), 4) * 4;
  p->by = balanced(c.sy, clamp(kBoxBytes / (4 * p->bz), 1, kMaxBoxDim));
  p->bx =
      balanced(c.sx, clamp(kBoxBytes / (4 * p->bz * p->by), 1, kMaxBoxDim));
  p->boxes = cdiv(c.sz, p->bz) * cdiv(c.sy, p->by) * cdiv(c.sx, p->bx) * c.nq;
  p->threads = kTmaThreads;
  const int64_t stage =
      cdiv(4 * p->bz * p->by * p->bx, kStageAlign) * kStageAlign;
  p->smem = kStageAlign + p->stages * stage;
  if (p->smem > kRingLimit || p->boxes >= lim)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The TMA body's grid: one block per box, at most kBlocksPerSm per SM.
inline int tma_grid(Plan* p, int sms) {
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  p->grid = p->boxes < (int64_t)sms * kBlocksPerSm
                ? p->boxes
                : (int64_t)sms * kBlocksPerSm;
  return 0;
}

// The current device (-1 if it cannot be used here) and its SM count.
inline int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

inline int sm_count(int dev) {
  static int cached[kMaxDevices] = {0};
  if (dev < 0) return 0;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  return cached[dev];
}

// Checks a launch's arguments and makes its plan; `dev` is the current
// device where the plan is TMA (only its grid needs one), else -1.
inline int plan_launch(const Cut& c, const void* face, bool pack,
                       int64_t rows_per_block, int64_t body, int* dev,
                       Plan* p) {
  if (rows_per_block < 1 || c.sx % rows_per_block)
    return (int)cudaErrorInvalidValue;
  *dev = -1;
  const int err = make_plan(c, face, pack, body, p);
  if (err != 0 || p->body != kTma) return err;
  *dev = current_device();
  if (*dev < 0) return (int)cudaErrorInvalidDevice;
  return tma_grid(p, sm_count(*dev));
}

// -- device: the SIMT body

// Each thread copies element k0, k0 + group, ... of kSimtRuns runs (q, i, j)
// of sz elements, loads before stores; `group` lanes share a run.  One 32-bit
// division pair and one 64-bit base per run, 32-bit offsets inside it.
template <bool kPack>
__device__ __forceinline__ void simt_copy(
    float* __restrict__ u, float* __restrict__ face, int64_t X, int64_t Y,
    int64_t Z, int64_t x0, int64_t y0, int64_t z0, uint32_t sx, uint32_t sy,
    uint32_t sz, int group_log2, uint32_t runs) {
  const uint32_t lanes = kSimtThreads >> group_log2;  // runs side by side
  const uint32_t k0 = threadIdx.x & ((1u << group_log2) - 1);
  const uint32_t r0 =
      blockIdx.x * lanes * kSimtRuns + (threadIdx.x >> group_log2);
  int64_t uo[kSimtRuns], fo[kSimtRuns];
  bool live[kSimtRuns];
#pragma unroll
  for (int r = 0; r < kSimtRuns; ++r) {
    const uint32_t run = r0 + r * lanes;
    live[r] = run < runs;
    const uint32_t qi = run / sy, j = run - qi * sy;
    const uint32_t q = qi / sx, i = qi - q * sx;
    uo[r] = ((q * X + x0 + i) * Y + y0 + j) * Z + z0;
    fo[r] = (int64_t)run * sz;
  }
  for (uint32_t k = k0; k < sz; k += 1u << group_log2) {
    float v[kSimtRuns];
#pragma unroll
    for (int r = 0; r < kSimtRuns; ++r)
      if (live[r]) v[r] = kPack ? u[uo[r] + k] : face[fo[r] + k];
#pragma unroll
    for (int r = 0; r < kSimtRuns; ++r)
      if (live[r]) {
        if (kPack)
          face[fo[r] + k] = v[r];
        else
          u[uo[r] + k] = v[r];
      }
  }
}

// Launch `kernel` (a __global__ wrapper of simt_copy) for plan `p`.
template <typename Kernel>
int launch_simt(Kernel kernel, float* u, float* face, const Cut& c,
                const Plan& p, cudaStream_t stream) {
  int g = 0;
  while ((1 << g) < p.group) ++g;
  kernel<<<(unsigned)p.grid, kSimtThreads, 0, stream>>>(
      u, face, c.X, c.Y, c.Z, c.x0, c.y0, c.z0, (uint32_t)c.sx,
      (uint32_t)c.sy, (uint32_t)c.sz, g, (uint32_t)p.runs);
  return (int)cudaGetLastError();
}

}  // namespace tz_halo
