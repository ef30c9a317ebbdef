// fused_region: one precompiled kernel that runs a fused region's member ops in
// schedule order, from a descriptor table passed by value.
//
// Replaces the TPU kernel _region_call (tenzing_tpu/runtime/fused.py:358).
// There, each region is traced into its own pallas_call whose body re-applies
// the members' jax functions over VMEM blocks of a (tiles,) grid that runs in
// order on one core.  On Hopper no per-schedule compiler is involved: the
// region is lowered (runtime/fused.py, FusedRegionKernel) into a table of
// members, each a body kind with its buffer pointers and extents:
//
//   ELL row sum  y[i] = sum_j vals[i, j] * x[cols[i, j]]  (SpMVOp)
//   gather       out[i] = x[idx[i]]                        (Scatter)
//   add          out[i] = a[i] + b[i]                      (VectorAdd)
//   copy         out[i] = src[i]                           (LocalExchange)
//
// and a "barrier before me" flag, set where the member touches a buffer an
// earlier member of the region wrote (or writes one an earlier member read).
//
// The kernel is launched cooperatively, so every block is resident and the
// barriers cannot deadlock; the grid is bounded by the queried residency
// limit.  Its blocks split into `tiles` groups.  Group g owns the g-th row
// share of every row-tiled buffer of every member and reads full-view buffers
// (a gathered x) whole; a flagged barrier is scoped to the group.  The region's
// tiling rule (region_axes) guarantees that no buffer written in a tiled region
// is read whole, so groups never wait on each other; with tiles == 1 the group
// is the whole grid, which the reference's own SpMV region (the local exchange
// writes x_remote, the remote SpMV gathers it whole) needs.
//
// A barrier is a count and a generation per group in device memory (zeroed
// once when the executor provisions the region); the last block to arrive
// resets the count and advances the generation, so the pair needs no reset
// between launches.  Loads go through L2 (ld.global.cg): a block may read what
// another block wrote earlier in the same launch.
//
// Bound on an H100 SXM: bytes, each external input read once and each output
// written once, at 3.35 TB/s.  The simple first version: one member after
// another, no overlap across members, scalar loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 32;

enum Body : int32_t { kEll = 0, kGather = 1, kAdd = 2, kCopy = 3 };

// mirrors ops/fused_region.py _Member / _Table (ctypes), field for field
struct Member {
  int32_t kind;
  int32_t barrier;
  int64_t rows;   // extent of the member's row-tiled buffers
  int64_t width;  // ELL slab width (other bodies: 0)
  const void* a;  // ELL: vals   gather: x    add: a   copy: src
  const void* b;  // ELL: cols   gather: idx  add: b
  const void* c;  // ELL: x
  void* out;      // ELL: y      gather: out  add: out copy: dst
};

struct Table {
  int32_t n;
  int32_t tiles;
  Member m[kMaxMembers];
};

__device__ __forceinline__ void group_barrier(unsigned int* count,
                                              unsigned int* gen,
                                              unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* vgen = gen;
    const unsigned int g = *vgen;
    __threadfence();
    if (atomicAdd(count, 1u) == nblocks - 1u) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      while (*vgen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    fused_region_kernel(const __grid_constant__ Table t,
                        unsigned int* __restrict__ counters) {
  const int64_t bpg = gridDim.x / t.tiles;  // blocks per group
  const int64_t group = blockIdx.x / bpg;
  const int64_t gb = blockIdx.x % bpg;  // block index within the group
  unsigned int* count = counters + 2 * group;
  unsigned int* gen = count + 1;
  for (int k = 0; k < t.n; ++k) {
    const Member& mb = t.m[k];
    if (mb.barrier) group_barrier(count, gen, (unsigned int)bpg);
    const int64_t lo = group * mb.rows / t.tiles;
    const int64_t hi = (group + 1) * mb.rows / t.tiles;
    if (mb.kind == kEll) {
      const float* vals = static_cast<const float*>(mb.a);
      const int* cols = static_cast<const int*>(mb.b);
      const float* x = static_cast<const float*>(mb.c);
      float* y = static_cast<float*>(mb.out);
      const int64_t w = mb.width;
      int G = 1;
      while (G < w && G < 32) G <<= 1;
      const int lane = threadIdx.x % G;
      const int64_t rpb = kThreads / G;  // rows per block per step
      const int64_t stride = bpg * rpb;
      // r0 is uniform over the block: whole warps reach the shuffles
      for (int64_t r0 = lo + gb * rpb; r0 < hi; r0 += stride) {
        const int64_t row = r0 + threadIdx.x / G;
        float acc = 0.0f;
        if (row < hi) {
          for (int64_t j = lane; j < w; j += G)
            acc += __ldcg(vals + row * w + j) * __ldcg(x + __ldcg(cols + row * w + j));
        }
        for (int off = G / 2; off > 0; off >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, off, G);
        if (row < hi && lane == 0) y[row] = acc;
      }
    } else {
      const int64_t step = bpg * kThreads;
      const int64_t first = lo + gb * kThreads + threadIdx.x;
      float* out = static_cast<float*>(mb.out);
      if (mb.kind == kGather) {
        const float* x = static_cast<const float*>(mb.a);
        const int* idx = static_cast<const int*>(mb.b);
        for (int64_t i = first; i < hi; i += step) out[i] = __ldcg(x + __ldcg(idx + i));
      } else if (mb.kind == kAdd) {
        const float* a = static_cast<const float*>(mb.a);
        const float* b = static_cast<const float*>(mb.b);
        for (int64_t i = first; i < hi; i += step) out[i] = __ldcg(a + i) + __ldcg(b + i);
      } else {  // kCopy
        const float* src = static_cast<const float*>(mb.a);
        for (int64_t i = first; i < hi; i += step) out[i] = __ldcg(src + i);
      }
    }
  }
}

}  // namespace

// The most blocks of fused_region_kernel that can be resident at once on the
// current device (occupancy at kThreads threads x SMs): the bound of a
// cooperative grid.  Negative: -(cudaError).
extern "C" int tz_fused_region_max_blocks() {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_region_kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return 0;
  return per_sm * sms;
}

// Run the region `table` (a Table) on `stream` over `tiles` x
// `blocks_per_group` cooperative blocks; `counters` holds 2 x tiles zeroed
// unsigned ints.  Returns cudaGetLastError() after the launch.
extern "C" int tz_fused_region(const void* table, void* counters,
                               int64_t blocks_per_group, void* stream) {
  const Table t = *static_cast<const Table*>(table);
  if (t.n < 0 || t.n > kMaxMembers || t.tiles < 1 || blocks_per_group < 1)
    return (int)cudaErrorInvalidValue;
  unsigned int* cnt = static_cast<unsigned int*>(counters);
  void* args[] = {(void*)&t, (void*)&cnt};
  const dim3 grid((unsigned)(t.tiles * blocks_per_group));
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)fused_region_kernel,
                                              grid, dim3(kThreads), args, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
