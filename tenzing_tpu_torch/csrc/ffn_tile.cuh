// The f32 gelu MLP on the tensor cores, split-TF32 on wgmma: the body shared
// by ffn_expert_kernel (ffn_expert.cu, tz_ffn_batched: E experts' slot
// tables) and ffn_rows_kernel (ffn_rows.cu, tz_ffn_rows: one token matrix,
// E = 1):
//
//     h[e] = gelu_tanh(x[e] @ W1[e]);   y[e] = h[e] @ W2[e]
//
// for x (E, c, 512), W1 (E, 512, dff), W2 (E, dff, 512), y (E, c, 512),
// float32 in and out, h float32 in a workspace the caller allocates (E, c,
// dff).  One entry point launches one GEMM body twice: the first launch
// with a gelu epilogue writes h (20 MB at the main path's shape, mostly
// L2-resident until the second launch reads it), the second reads h.
//
// Float32 accuracy on the tensor cores, as attn_fold_f32.cuh: every operand
// is split into hi = tf32_rna(v) and lo = tf32_rna(v - hi), and each product
// is hi hi + hi lo + lo hi (lo lo, ~2^-22 of a term, is dropped).  A single
// TF32 pass keeps ~3 decimal digits and fails FFN_TOL (bench/ffn_f32.py
// --ablate builds it as a control).  Each 32-deep chunk's 12 products are
// summed on the tensor cores into a zeroed t, which is then added to the
// output tile's sum with f32 adds: the tensor cores' accumulation rounds
// every add the same way (attn_fold_f32.cuh fold_pv), so it never carries
// the whole depth.
//
// One GEMM C[M x N] = A[M x K] @ B[K x N] (row-major, rows of K, N and N
// floats; K and N multiples of 4) per launch, tiled into CTAs of kRows x
// kCols outputs:
// - tf32 wgmma reads B K-major only, and both weight matrices are MN-major
//   (W1's rows are dff-contiguous with K = 512, W2's are 512-contiguous with
//   K = dff).  So B is split and stored transposed, 128-byte swizzled, as
//   attn_fold_f32.cuh stores V^T.  x and h are K-major as they stand: their
//   rows are split and swizzled as they are.  No per-call split pass; A and
//   B are read from device memory once a tile.
// - The raw f32 chunks arrive by TMA (3D tensor maps over (expert, rows,
//   columns); boxes past M, N or K read zeros) into kRawStages raw stages,
//   ahead of the split: with the loads in the producer's registers, W's
//   column reads (4 bytes a thread, one 128-byte line a warp and row) kept
//   the producer waiting on device memory (bench/ffn_f32.py).
// - Two producer warpgroups split a chunk: one A's rows (16 bytes a thread
//   and row), one B's columns (thread pt column col0 + pt); one warpgroup
//   doing both was the slower side (bench/ffn_f32.py).  Two consumer
//   warpgroups of 64 rows each (kRows = 128) share the B chunk; each runs
//   m64n128k8 wgmma with both operands in shared memory (the hi and lo
//   planes).  setmaxnreg gives the consumers kConsumerRegs (t and the
//   tile's sum, 64 registers each) and the producers kProducerRegs out of
//   the 128 a thread the 512-thread CTA holds; both return to 128 for the
//   epilogue they share.
// - kStages split stages of 32-deep chunks (A and B, hi and lo: 64 KB) in a
//   ring of full / empty mbarriers, and the raw stages (32 KB each):
//   kSmemBytes, one CTA per SM.
// - Occupancy: where a launch's tiles leave more than half the SMs idle
//   (row 13 f32's second product: 16 row tiles x 4 column tiles, 64 tiles
//   for 132 SMs), the depth is split over a thread block cluster of
//   `splits` CTAs (split_k): each sums a range of
//   chunks into its tile, writes the partial into its own shared memory,
//   and after a cluster barrier each CTA adds a share of the tile's rows
//   over the cluster's distributed shared memory in rank order, applies the
//   gelu (first launch) and stores it with 16-byte stores.  Deterministic:
//   a fixed order, no atomics, no memset.
// - Ragged M, N and K are masked in the kernel: masked loads read zeros
//   (gelu(0) = 0, and zero rows of W2 add nothing), masked rows and columns
//   are never stored; a warpgroup whose 64 rows all lie past M skips its
//   products.  Nothing is padded in device memory.
//
// Bound on an H100 SXM: operations, 3 x 4 E c 512 dff (the split) at 495
// TFLOP/s TF32 (61.8 us at 8 x 304 x 2048; 52.1 us at n = 2048); the SIMT
// f32 bound (67 TFLOP/s) 152.2 / 128.2 us.  A mbarrier wait that has not
// completed after ~2^32 cycles traps, so a fault in the ring's bookkeeping
// ends the launch with an error.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tz_ffn {

namespace cg = cooperative_groups;
using namespace tz_hopper;

constexpr int kD = 512;          // d_model: the kernels' one instantiation
constexpr int kConsumers = 2;    // warpgroups, 64 rows each
constexpr int kRows = 64 * kConsumers;            // output rows per CTA
constexpr int kCols = 128;       // output columns per CTA (the wgmma's N)
constexpr int kDepth = 32;       // K per chunk: one 128-byte swizzle row
constexpr int kStages = 2;      // split stages (hi and lo planes)
constexpr int kRawStages = 3;   // raw f32 stages the TMA fills
constexpr int kProducers = 2;    // warpgroups: A's split and B's
constexpr int kThreads = 128 * (kConsumers + kProducers);
constexpr int kProducerThreads = 128 * kProducers;  // arrivals that fill a stage
constexpr int kConsumerWarps = 4 * kConsumers;    // arrivals that free a stage
constexpr int kMaxSplits = 4;    // CTAs of a split-K cluster
constexpr int kAPlaneBytes = kRows * kDepth * 4;  // A's hi or lo of a chunk
constexpr int kBPlaneBytes = kCols * kDepth * 4;  // B^T's hi or lo
constexpr int kStageBytes = 2 * (kAPlaneBytes + kBPlaneBytes);
constexpr int kRawABytes = kAPlaneBytes;          // A's raw chunk, [kRows][kDepth]
constexpr int kRawBytes = kAPlaneBytes + kBPlaneBytes;  // + B's, [kDepth][kCols]
constexpr int kPartPitch = kCols + 8;  // floats a row of a CTA's partial sum
constexpr int kBarrierBytes = 64;
constexpr int kAlignBytes = 1024;  // the 128-byte swizzle's atom
constexpr int kSmemBytes = kAlignBytes + kStages * kStageBytes +
                           kRawStages * kRawBytes + kBarrierBytes;
static_assert(kDepth * 4 == 128, "a chunk row is one 128-byte swizzle row");
static_assert(kCols == 128, "a B producer thread per column");
// setmaxnreg moves registers between the warps of one CTA: the shares may
// not exceed what the CTA holds at launch, 128 a thread (65,536 / 512).
constexpr int kLaunchRegs = 128;
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 184;
static_assert(kProducerRegs * 128 * kProducers + kConsumerRegs * 128 * kConsumers <=
                  kLaunchRegs * kThreads,
              "register budget");
static_assert(kRows * kPartPitch * 4 <= kStages * kStageBytes,
              "the partial sum reuses the ring");
static_assert((2 * kStages + kRawStages) * 8 <= kBarrierBytes, "barriers");
static_assert(kSmemBytes <= 232448, "one block's shared memory");

// the tanh form of gelu (jax.nn.gelu's default; torch's approximate="tanh")
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * v * (1.0f + tanhf(k0 * (v + k1 * v * v * v)));
}

// One launch: C[e] = epilogue(A[e] @ B[e]) for e < experts (passed by
// value, a __grid_constant__ kernel parameter).
struct Gemm {
  CUtensorMap a_map;  // A (experts, m, k): boxes of kDepth x kRows x 1
  CUtensorMap b_map;  // B (experts, k, n): boxes of kCols x kDepth x 1
  float* c;
  int64_t c_batch;    // elements from one expert's C to the next
  int m, n, k;        // rows, columns, depth
  int m_tiles, n_tiles, splits;
  int chunks_per_split;
  int gelu;                           // apply gelu_tanh before the store
};

// The split of the depth over a cluster: none unless the tiles leave more
// than half the SMs idle (2 tiles <= sms); then the count in {1, 2, 4} with
// the fewest full-depth waves, ceil(tiles s / sms) / s (one CTA per SM),
// the smallest on a tie, at least 4 chunks a split.  The gate is measured:
// row 14's second launch (96 tiles) split 4 ways read 5-6 us slower than
// unsplit, row 13 f32's (64 tiles) split 2 ways 41 us faster
// (bench/ffn_f32.py --ablate, no-split and split-by-waves).  Mirrored by
// ops/ffn_kernels.py split_k.
inline int split_k(int64_t tiles, int64_t chunks, int sms) {
  if (2 * tiles > sms) return 1;
  int best = 1;
  int64_t best_waves = (tiles + sms - 1) / sms;  // in units of 1 / best
  for (int s = 2; s <= kMaxSplits; s *= 2) {
    if (chunks < 4 * s) break;
    const int64_t waves = (tiles * s + sms - 1) / sms;
    if (waves * best < best_waves * s) {
      best = s;
      best_waves = waves;
    }
  }
  return best;
}

// Fill the tiling of g for a launch on `sms` SMs; returns the CTA count.
inline int64_t plan(Gemm& g, int64_t experts, int sms) {
  g.m_tiles = (g.m + kRows - 1) / kRows;
  g.n_tiles = (g.n + kCols - 1) / kCols;
  const int64_t chunks = (g.k + kDepth - 1) / kDepth;
  const int64_t tiles = experts * g.m_tiles * g.n_tiles;
  g.splits = split_k(tiles, chunks, sms);
  g.chunks_per_split = (int)((chunks + g.splits - 1) / g.splits);
  return tiles * g.splits;
}

// -- wgmma, tf32, both operands in shared memory: d (+)= a b, 64 x 128 x 8

template <bool kAccumulate>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TZ_REGS64
        ", %64, %65, p, 1, 1;\n}\n"
        : TZ_ACC64("+f", d)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TZ_REGS64
        ", %64, %65, p, 1, 1;\n}\n"
        : TZ_ACC64("=f", d)
        : "l"(da), "l"(db), "r"(0));
  }
}

// Descriptor of k step kk (8 columns, 32 bytes) of a plane of 128-byte
// rows, 128-byte swizzled, K-major: the next 8 rows 1024 bytes on.
__device__ __forceinline__ uint64_t desc(uint32_t plane, int kk) {
  return desc_sw128(plane + kk * 32, 16, 1024);
}

// t = a b over one chunk (32 deep) for a warpgroup's 64 rows x kCols, as
// a_hi b_hi + a_hi b_lo + a_lo b_hi.
__device__ __forceinline__ void chunk_product(float (&t)[64], uint32_t ahi,
                                              uint32_t bhi) {
  const uint32_t alo = ahi + kAPlaneBytes, blo = bhi + kBPlaneBytes;
  wg_fence();
  mma<false>(t, desc(ahi, 0), desc(bhi, 0));
#pragma unroll
  for (int kk = 1; kk < kDepth / 8; ++kk) mma<true>(t, desc(ahi, kk), desc(bhi, kk));
#pragma unroll
  for (int kk = 0; kk < kDepth / 8; ++kk) mma<true>(t, desc(ahi, kk), desc(blo, kk));
#pragma unroll
  for (int kk = 0; kk < kDepth / 8; ++kk) mma<true>(t, desc(alo, kk), desc(bhi, kk));
  wg_commit();
  wg_wait_all();
  fence_regs(t);
}

// One box of a 3D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Chunk kc's raw A rows [row0, row0 + kRows) and B columns [col0, col0 +
// kCols) of expert e into a raw stage (one thread issues).
__device__ __forceinline__ void load_raw(const Gemm& g, unsigned char* raw,
                                         uint64_t* bar, int kc, int row0,
                                         int col0, int e) {
  mbar_expect_tx(bar, kRawBytes);
  tma_box(raw, &g.a_map, bar, kc * kDepth, row0, e);
  tma_box(raw + kRawABytes, &g.b_map, bar, col0, kc * kDepth, e);
}

// Synchronize the consumer warpgroups' threads (named barrier 2).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 2, %0;\n" :: "n"(128 * kConsumers) : "memory");
}

// Synchronize the producer warpgroups' threads (named barrier 1).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kProducerThreads) : "memory");
}

// The producer warpgroups: split the raw chunks [kc0, kc1) into the ring;
// warpgroup `role` 0 A's rows as they stand, 1 B's column pt as row pt of
// B^T, 128-byte swizzled (pt: the thread's index in its warpgroup).  Thread
// 0 of A's keeps kRawStages chunks' TMA loads in flight.
__device__ __forceinline__ void produce(const Gemm& g, int row0, int col0,
                                        int e, int kc0, int kc1,
                                        unsigned char* ring_base,
                                        unsigned char* raw_base, uint64_t* full,
                                        uint64_t* empty, uint64_t* raw_full,
                                        int role, int pt) {
  const bool issuer = role == 0 && pt == 0;
  if (issuer)
    for (int kc = kc0; kc < kc1 && kc < kc0 + kRawStages; ++kc)
      load_raw(g, raw_base + (kc - kc0) * kRawBytes, &raw_full[kc - kc0], kc,
               row0, col0, e);
  Ring r, rr;
  for (int kc = kc0; kc < kc1; ++kc) {
    mbar_wait(&raw_full[rr.stage], rr.phase);
    unsigned char* raw = raw_base + rr.stage * kRawBytes;
    float x[kDepth];  // A: 8 float4 of rows pt / 8 + 16 i; B: column pt
    if (role == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(&x[4 * i]) = *reinterpret_cast<const float4*>(
            raw + ((pt >> 3) + 16 * i) * (kDepth * 4) + (pt & 7) * 16);
    } else {
#pragma unroll
      for (int j = 0; j < kDepth; ++j)
        x[j] = reinterpret_cast<const float*>(raw + kRawABytes)[j * kCols + pt];
    }
    producer_sync();  // every producer thread has read the raw stage
    if (issuer && kc + kRawStages < kc1) {
      fence_proxy_async();  // the reads above before the TMA's writes
      load_raw(g, raw, &raw_full[rr.stage], kc + kRawStages, row0, col0, e);
    }
    rr.advance<kRawStages>();
    mbar_wait(&empty[r.stage], r.phase ^ 1u);
    unsigned char* st = ring_base + r.stage * kStageBytes;
    if (role == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int off = sw128((pt >> 3) + 16 * i, pt & 7);
        uint4 hi, lo;
        split4(*reinterpret_cast<const float4*>(&x[4 * i]), hi, lo);
        *reinterpret_cast<uint4*>(st + off) = hi;
        *reinterpret_cast<uint4*>(st + kAPlaneBytes + off) = lo;
      }
    } else {
      unsigned char* bt = st + 2 * kAPlaneBytes;
#pragma unroll
      for (int h = 0; h < kDepth / 4; ++h) {
        const int off = sw128(pt, h);
        uint4 hi, lo;
        split4(*reinterpret_cast<const float4*>(&x[4 * h]), hi, lo);
        *reinterpret_cast<uint4*>(bt + off) = hi;
        *reinterpret_cast<uint4*>(bt + kBPlaneBytes + off) = lo;
      }
    }
    fence_proxy_async();
    mbar_arrive(&full[r.stage]);
    r.advance<kStages>();
  }
}

// Consumer warpgroup wg: sum chunks [kc0, kc1) of its 64 rows x kCols into
// acc (the m64n128 accumulator layout: acc[4 j + 0..1] is row 16 warp + g,
// columns 8 j + 2 tq + {0, 1}; [4 j + 2..3] the same 8 rows on).
__device__ __forceinline__ void consume(float (&acc)[64], bool active,
                                        int kc0, int kc1, uint32_t ring_base,
                                        uint64_t* full, uint64_t* empty, int wg,
                                        int lane) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  Ring r;
  for (int kc = kc0; kc < kc1; ++kc) {
    mbar_wait(&full[r.stage], r.phase);
    if (active) {
      const uint32_t st = ring_base + r.stage * kStageBytes;
      float t[64];
      chunk_product(t, st + wg * (kAPlaneBytes / kConsumers), st + 2 * kAPlaneBytes);
      release(&empty[r.stage], lane);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += t[i];
    } else {
      release(&empty[r.stage], lane);
    }
    r.advance<kStages>();
  }
}

// The CTA blockIdx.x of launch g (every thread calls it; smem_raw holds
// kSmemBytes of dynamic shared memory).  The cluster's CTAs are the splits
// of one tile: blockIdx.x = split + splits (column tile + n_tiles (row tile
// + m_tiles expert)).
__device__ __forceinline__ void gemm_cta(const Gemm& g, unsigned char* smem_raw) {
  cg::cluster_group cluster = cg::this_cluster();
  unsigned char* base =
      smem_raw + ((kAlignBytes - (smem_u32(smem_raw) & (kAlignBytes - 1))) &
                  (kAlignBytes - 1));
  unsigned char* raw_base = base + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(raw_base + kRawStages * kRawBytes);
  uint64_t* empty = full + kStages;
  uint64_t* raw_full = empty + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducerThreads);
      mbar_init(&empty[s], kConsumerWarps);
    }
    for (int s = 0; s < kRawStages; ++s) mbar_init(&raw_full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int split = (int)(blockIdx.x % g.splits);  // == cluster.block_rank()
  int64_t tile = blockIdx.x / g.splits;
  const int col0 = (int)(tile % g.n_tiles) * kCols;
  tile /= g.n_tiles;
  const int row0 = (int)(tile % g.m_tiles) * kRows;
  const int e = (int)(tile / g.m_tiles);
  float* c = g.c + (int64_t)e * g.c_batch;
  const int chunks = (g.k + kDepth - 1) / kDepth;
  const int kc0 = split * g.chunks_per_split;
  const int kc1 = kc0 + g.chunks_per_split < chunks ? kc0 + g.chunks_per_split
                                                    : chunks;

  // the CTA's partial sum, (kRows, kPartPitch) floats over the split stages
  float* part = reinterpret_cast<float*>(base);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    produce(g, row0, col0, e, kc0, kc1, base, raw_base, full, empty, raw_full,
            wg - kConsumers, t);
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kLaunchRegs));
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const bool active = row0 + 64 * wg < g.m;
    float acc[64];
    consume(acc, active, kc0, kc1, smem_u32(base), full, empty, wg, t % 32);
    // every product has read its last stage (and every split store and TMA
    // load before it has landed): the split stages are free
    consumer_sync();
    if (active) {
      const int warp = t / 32, lane = t % 32;
      const int ra = 64 * wg + 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        *reinterpret_cast<float2*>(part + ra * kPartPitch + 8 * j + cq) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(part + (ra + 8) * kPartPitch + 8 * j + cq) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kLaunchRegs));
  }
  cluster.sync();  // every partial of the tile written and visible

  // this CTA's share of the tile's rows, summed over the cluster in rank order
  const int r_lo = split * kRows / g.splits, r_hi = (split + 1) * kRows / g.splits;
  for (int i = threadIdx.x; i < (r_hi - r_lo) * (kCols / 4); i += kThreads) {
    const int r = r_lo + i / (kCols / 4), c4 = 4 * (i % (kCols / 4));
    const int row = row0 + r, col = col0 + c4;
    if (row >= g.m || col >= g.n) continue;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < g.splits; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, q) + r * kPartPitch + c4);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    if (g.gelu) s = make_float4(gelu_tanh(s.x), gelu_tanh(s.y), gelu_tanh(s.z),
                                gelu_tanh(s.w));
    *reinterpret_cast<float4*>(c + (int64_t)row * g.n + col) = s;
  }
  cluster.sync();  // no CTA leaves while another still reads its memory
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  return sms;
}

// Launch `kernel` (a __global__ taking a Gemm that calls gemm_cta) for g
// over `experts` on `stream`.
template <typename Kernel>
cudaError_t launch_gemm(Kernel kernel, Gemm g, int64_t experts,
                        cudaStream_t stream) {
  const int64_t blocks = plan(g, experts, sm_count());
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A 3D tensor map over a contiguous float32 (experts, rows, cols) tensor,
// boxes of box_cols x box_rows x 1, no swizzle, zeros out of bounds.
inline int map_3d(CUtensorMap* map, const float* ptr, int64_t experts,
                  int64_t rows, int64_t cols, int box_cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)experts};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)(rows * cols * 4)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                  const_cast<float*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The launch C = A B for `experts` stacked (m, k) and (k, n) operands.
inline int gemm(Gemm& g, const float* a, const float* b, float* c,
                int64_t experts, int64_t m, int64_t n, int64_t k, int gelu) {
  g.c = c;
  g.c_batch = m * n;
  g.m = (int)m;
  g.n = (int)n;
  g.k = (int)k;
  g.gelu = gelu;
  int err = map_3d(&g.a_map, a, experts, m, k, kDepth, kRows);
  if (err == 0) err = map_3d(&g.b_map, b, experts, k, n, kCols, kDepth);
  return err;
}

// y = gelu_tanh(x @ W1) @ W2 for `experts` stacked problems of c rows, d =
// kD, through the workspace h (experts, c, dff): the two launches of one
// call.  Returns the first CUDA error.
template <typename Kernel>
int run_ffn(Kernel kernel, const float* x, const float* w1, const float* w2,
            float* y, float* h, int64_t experts, int64_t c, int64_t dff,
            cudaStream_t stream) {
  if (experts > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Gemm g1 = {}, g2 = {};
  int err = gemm(g1, x, w1, h, experts, c, dff, kD, 1);
  if (err == 0) err = gemm(g2, h, w2, y, experts, c, kD, dff, 0);
  if (err != 0) return err;
  err = (int)launch_gemm(kernel, g1, experts, stream);
  if (err != 0) return err;
  return (int)launch_gemm(kernel, g2, experts, stream);
}

// The launch constants, in order: rows and columns per CTA, chunk depth,
// split stages, raw stages, threads, shared-memory bytes, the largest split.
inline void config(int64_t* out) {
  out[0] = kRows;
  out[1] = kCols;
  out[2] = kDepth;
  out[3] = kStages;
  out[4] = kRawStages;
  out[5] = kThreads;
  out[6] = kSmemBytes;
  out[7] = kMaxSplits;
}

}  // namespace tz_ffn
