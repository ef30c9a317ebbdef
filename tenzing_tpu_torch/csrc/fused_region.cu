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
//   attn fold    the online-softmax fold of nkv keys from key_off of K/V
//                into the (acc, m, l) state of the tile's query rows
//                (BlockAttnStep, BlockAttnSubFold; the split-TF32 wgmma
//                body of attn_fold_f32.cuh)
//   attn final   O = acc / l                               (FinalizeAttn)
//
// and a "barrier before me" flag, set where the member touches a buffer an
// earlier member of the region wrote (or writes one an earlier member read).
//
// Two instantiations, chosen per table: a table with an attention member
// runs fused_region_attn_kernel (the fold's 384 threads: two consumer
// warpgroups and a producer warpgroup, kSmemBytes of shared memory, one
// block per SM; the finalize runs on the consumers' 256 threads), any other
// table fused_region_kernel (256 threads, no shared memory, the SpMV
// bodies).  A table that mixes the two is refused.
//
// The kernel is launched cooperatively, so every block is resident and the
// barriers cannot deadlock; the grid is bounded by the queried residency
// limit of the table's instantiation.  Its blocks split into `tiles` groups.
// Group g owns the g-th share [g rows / tiles, (g + 1) rows / tiles) of the
// tiled axis of every row-tiled buffer of every member: axis 0 of the SpMV
// vectors and slabs, axis 1 of the (outer, rows, inner) attention buffers,
// where the share is a range of rows in each of the outer batch elements.
// Full-view buffers (a gathered x, the K/V block of a fold) are read whole; a
// flagged barrier is scoped to the group.  The region's tiling rule
// (region_axes) guarantees that no buffer written in a tiled region is read
// whole, so groups never wait on each other; with tiles == 1 the group is the
// whole grid, which the reference's own SpMV region (the local exchange
// writes x_remote, the remote SpMV gathers it whole) needs.
//
// A fold member splits its group's share into (batch element, 128-row tile)
// items (the last one masked where the share is not a multiple of 128),
// dealt to the group's blocks in the same order for every fold, so a block
// folds the same rows member after member.  The producer and the consumers
// walk the members and items in the same order, so the ring of K/V stages
// runs on across them; setmaxnreg splits the registers once, at the start.
//
// A barrier is a count and a generation per group in device memory (zeroed
// once when the executor provisions the region); the last block to arrive
// resets the count and advances the generation, so the pair needs no reset
// between launches.  Loads of what another block may have written in the
// same launch go through L2 (ld.global.cg).
//
// Bound on an H100 SXM: bytes for the SpMV bodies (each external input read
// once and each output written once, at 3.35 TB/s); operations for a region
// of attention folds (3 x 4 b n nkv d per fold, the split, at 495 TFLOP/s
// TF32).  One member after another, no overlap across members, the fold's
// state read and written in device memory by every member.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_fold_f32.cuh"

namespace {

constexpr int kThreads = 256;  // the SpMV instantiation
constexpr int kMaxMembers = 32;
constexpr int kHeadDim = tz_attn_f32::kHeadDim;  // the attention bodies' only one
constexpr int kAttnThreads = tz_attn_f32::kThreads;
constexpr int kFinalizeThreads = 128 * tz_attn_f32::kConsumers;

enum Body : int32_t {
  kEll = 0, kGather = 1, kAdd = 2, kCopy = 3, kAttnFold = 4, kAttnFinalize = 5
};

// mirrors ops/fused_region.py _Member / _Table (ctypes), field for field
struct Member {
  int32_t kind;
  int32_t barrier;
  int64_t rows;     // extent of the tiled axis of the row-tiled buffers
  int64_t width;    // ELL slab width (other bodies: 0)
  int64_t outer;    // attention: batch elements (SpMV: 1)
  int64_t inner;    // attention: head dim (SpMV: 1)
  int64_t kv_rows;  // attn fold: keys of K / V (their axis-1 extent)
  int64_t key_off;  // attn fold: the block's first key
  int64_t nkv;      // attn fold: the block's keys
  float scale;      // attn fold: softmax scale
  int32_t pad;
  // operands in the body's order (ops/fused_region.py OPERANDS):
  //   ELL: vals, cols, x, y   gather: x, idx, out   add: a, b, out
  //   copy: src, out   attn fold: q, k, v, acc, m, l   finalize: acc, l, o
  void* p[6];
};

struct Table {
  int32_t n;
  int32_t tiles;
  Member m[kMaxMembers];
};

constexpr bool attn_body(int32_t kind) {
  return kind == kAttnFold || kind == kAttnFinalize;
}

// 1: the table runs on fused_region_attn_kernel, 0: on fused_region_kernel,
// -1: it mixes attention and SpMV bodies.
int instantiation(const Table& t) {
  int attn = 0, other = 0;
  for (int k = 0; k < t.n && k < kMaxMembers; ++k)
    (attn_body(t.m[k].kind) ? attn : other) += 1;
  return attn && other ? -1 : attn > 0;
}

// A CTA-wide barrier that the producer and the consumer warps of the
// attention instantiation reach at different instructions (the unaligned
// form; __syncthreads is the aligned one).
__device__ __forceinline__ void cta_sync() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

// kAligned = false: the attention instantiation, whose warps reach it at
// different instructions.
template <bool kAligned = true>
__device__ __forceinline__ void group_barrier(unsigned int* count,
                                              unsigned int* gen,
                                              unsigned int nblocks) {
  if (kAligned) __syncthreads(); else cta_sync();
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
  if (kAligned) __syncthreads(); else cta_sync();
}

__global__ void __launch_bounds__(kThreads, 2)
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
      const float* vals = static_cast<const float*>(mb.p[0]);
      const int* cols = static_cast<const int*>(mb.p[1]);
      const float* x = static_cast<const float*>(mb.p[2]);
      float* y = static_cast<float*>(mb.p[3]);
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
      if (mb.kind == kGather) {
        const float* x = static_cast<const float*>(mb.p[0]);
        const int* idx = static_cast<const int*>(mb.p[1]);
        float* out = static_cast<float*>(mb.p[2]);
        for (int64_t i = first; i < hi; i += step) out[i] = __ldcg(x + __ldcg(idx + i));
      } else if (mb.kind == kAdd) {
        const float* a = static_cast<const float*>(mb.p[0]);
        const float* b = static_cast<const float*>(mb.p[1]);
        float* out = static_cast<float*>(mb.p[2]);
        for (int64_t i = first; i < hi; i += step) out[i] = __ldcg(a + i) + __ldcg(b + i);
      } else {  // kCopy
        const float* src = static_cast<const float*>(mb.p[0]);
        float* out = static_cast<float*>(mb.p[1]);
        for (int64_t i = first; i < hi; i += step) out[i] = __ldcg(src + i);
      }
    }
  }
}

// One warpgroup role's walk over the attention table: the producer
// (kProducer) fills the ring for every fold item, the consumers fold them
// and run the finalize; both take part in every group barrier.  Each role
// runs its own copy, so ptxas holds each to its setmaxnreg share.
template <bool kProducer>
__device__ __forceinline__ void walk_attn(const Table& t,
                                          const tz_attn_f32::Smem& sm,
                                          unsigned int* count,
                                          unsigned int* gen) {
  using namespace tz_attn_f32;
  const int64_t bpg = gridDim.x / t.tiles;  // blocks per group
  const int64_t group = blockIdx.x / bpg;
  const int64_t gb = blockIdx.x % bpg;  // block index within the group
  const int wg = threadIdx.x / 128;
  Ring kr, vr;
  for (int k = 0; k < t.n; ++k) {
    const Member& mb = t.m[k];
    if (mb.barrier) group_barrier<false>(count, gen, (unsigned int)bpg);
    const int64_t lo = group * mb.rows / t.tiles;
    const int64_t hi = (group + 1) * mb.rows / t.tiles;
    const int64_t d = mb.inner;
    if (mb.kind == kAttnFold) {
      // items (batch element, kRows-row tile of [lo, hi)), uniform over the block
      const int64_t tiles_b = (hi - lo + kRows - 1) / kRows;
      const int64_t st_b = mb.rows * d, kv_b = mb.kv_rows * d;
      for (int64_t it = gb; it < mb.outer * tiles_b; it += bpg) {
        const int64_t bi = it / tiles_b;
        if (kProducer) {
          produce<true>(sm, kr, vr,
                  static_cast<const float*>(mb.p[1]) + (mb.key_off + bi * mb.kv_rows) * d,
                  static_cast<const float*>(mb.p[2]) + (mb.key_off + bi * mb.kv_rows) * d,
                  d, d, (int)mb.nkv, threadIdx.x % 128);
        } else {
          consume<true>(sm, kr, vr, static_cast<const float*>(mb.p[0]) + bi * st_b,
                  static_cast<float*>(mb.p[3]) + bi * st_b,
                  static_cast<float*>(mb.p[4]) + bi * st_b,
                  static_cast<float*>(mb.p[5]) + bi * st_b,
                  lo + (it % tiles_b) * kRows, hi, (int)mb.nkv, d, d, mb.scale,
                  mb.scale * kLog2e, wg, threadIdx.x % 128);
        }
      }
    } else if (!kProducer) {  // kAttnFinalize, on the consumers' threads
      const int64_t share = (hi - lo) * d;  // elements of one batch element
      const float* acc = static_cast<const float*>(mb.p[0]);
      const float* l = static_cast<const float*>(mb.p[1]);
      float* o = static_cast<float*>(mb.p[2]);
      const int64_t step = bpg * kFinalizeThreads;
      for (int64_t i = gb * kFinalizeThreads + threadIdx.x; i < mb.outer * share;
           i += step) {
        const int64_t off = (i / share) * mb.rows * d + lo * d + i % share;
        o[off] = __ldcg(acc + off) / __ldcg(l + off);
      }
    }
  }
}

// The attention instantiation: fold and finalize members, one producer and
// two consumer warpgroups; all 384 threads take part in the group barriers.
__global__ void __launch_bounds__(kAttnThreads, 1)
    fused_region_attn_kernel(const __grid_constant__ Table t,
                             unsigned int* __restrict__ counters) {
  using namespace tz_attn_f32;
  extern __shared__ __align__(1024) unsigned char smem_attn[];
  const Smem sm = setup(smem_attn);
  __syncthreads();
  unsigned int* count = counters + 2 * (blockIdx.x / (gridDim.x / t.tiles));
  unsigned int* gen = count + 1;
  if (threadIdx.x / 128 == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    walk_attn<true>(t, sm, count, gen);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    walk_attn<false>(t, sm, count, gen);
  }
}

// Allow the attention instantiation's dynamic shared memory; once.
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(fused_region_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       tz_attn_f32::kSmemBytes);
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace

// Bytes of one Member and of one Table, for the ctypes mirror's check.
extern "C" int64_t tz_fused_region_member_size() { return (int64_t)sizeof(Member); }
extern "C" int64_t tz_fused_region_table_size() { return (int64_t)sizeof(Table); }

// The dynamic shared memory the region `table` (a Table) launches with: the
// attention instantiation's, 0 for the SpMV one; -1 for a mixed table.
extern "C" int64_t tz_fused_region_smem(const void* table) {
  const int inst = instantiation(*static_cast<const Table*>(table));
  return inst < 0 ? -1 : inst ? tz_attn_f32::kSmemBytes : 0;
}

// The threads per block the region `table` launches with (-1: mixed).
extern "C" int64_t tz_fused_region_threads(const void* table) {
  const int inst = instantiation(*static_cast<const Table*>(table));
  return inst < 0 ? -1 : inst ? kAttnThreads : kThreads;
}

// The most blocks of the instantiation that runs `table` that can be
// resident at once on the current device (occupancy at its threads and
// shared memory x SMs): the bound of a cooperative grid.  Negative:
// -(cudaError).
extern "C" int tz_fused_region_max_blocks(const void* table) {
  const int inst = instantiation(*static_cast<const Table*>(table));
  if (inst < 0) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = configure();
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = inst ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, fused_region_attn_kernel, kAttnThreads,
                   (size_t)tz_attn_f32::kSmemBytes)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, fused_region_kernel, kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return 0;
  return per_sm * sms;
}

// Run the region `table` (a Table) on `stream` over `tiles` x
// `blocks_per_group` cooperative blocks of its instantiation; `counters`
// holds 2 x tiles zeroed unsigned ints.  An attention member needs
// inner == 128 and 16-byte aligned buffers; a table may not mix attention
// and SpMV bodies.  Returns cudaGetLastError() after the launch.
extern "C" int tz_fused_region(const void* table, void* counters,
                               int64_t blocks_per_group, void* stream) {
  const Table t = *static_cast<const Table*>(table);
  if (t.n < 0 || t.n > kMaxMembers || t.tiles < 1 || blocks_per_group < 1)
    return (int)cudaErrorInvalidValue;
  const int inst = instantiation(t);
  if (inst < 0) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < t.n; ++k) {
    if (!attn_body(t.m[k].kind)) continue;
    uintptr_t ptrs = 0;
    for (int i = 0; i < 6; ++i) ptrs |= (uintptr_t)t.m[k].p[i];
    if (t.m[k].inner != kHeadDim || ptrs % 16 || t.m[k].nkv > (1 << 30))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  unsigned int* cnt = static_cast<unsigned int*>(counters);
  void* args[] = {(void*)&t, (void*)&cnt};
  const dim3 grid((unsigned)(t.tiles * blocks_per_group));
  if (inst)
    e = cudaLaunchCooperativeKernel((const void*)fused_region_attn_kernel, grid,
                                    dim3(kAttnThreads), args,
                                    (size_t)tz_attn_f32::kSmemBytes,
                                    (cudaStream_t)stream);
  else
    e = cudaLaunchCooperativeKernel((const void*)fused_region_kernel, grid,
                                    dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
