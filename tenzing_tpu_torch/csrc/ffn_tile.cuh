// The f32 gelu MLP on the tensor cores, split-TF32 on wgmma: the body shared
// by ffn_expert_kernel (ffn_expert.cu, tz_ffn_batched: E experts' slot
// tables) and ffn_rows_kernel (ffn_rows.cu, tz_ffn_rows: one token matrix,
// E = 1).  Its launch (GemmT, plan, split_k, launch_gemm, the tensor maps
// and the split-K epilogue store_partial / sum_store) is templated on the
// element type and the tile, and also carries ffn_rows.cu's bf16 body:
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
#include <cuda_bf16.h>
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

// The same function as v / (1 + exp(-2u)), u the tanh form's argument
// (0.5 (1 + tanh u) = 1 / (1 + exp(-2u))): one __expf and a division in
// place of tanhf, within ~1e-6 relative of it.  The bf16 body's epilogue
// uses it (its h is rounded to bf16, 2^-9 relative, right after); tanhf
// there read 1.1 us slower in a 37 us call (bench/ffn_bf16.py --ablate,
// tanh-gelu).
__device__ __forceinline__ float gelu_exp(float v) {
  const float k0 = 0.7978845608028654f;
  const float k1 = 0.044715f;
  return __fdividef(v, 1.0f + __expf(-2.0f * k0 * (v + k1 * v * v * v)));
}

// The gelu of four outputs of element type T: the tanh form for float32,
// the exp form for bf16.
template <typename T>
__device__ __forceinline__ float4 gelu4(float4 s) {
  if constexpr (sizeof(T) == 2)
    return make_float4(gelu_exp(s.x), gelu_exp(s.y), gelu_exp(s.z), gelu_exp(s.w));
  else
    return make_float4(gelu_tanh(s.x), gelu_tanh(s.y), gelu_tanh(s.z),
                       gelu_tanh(s.w));
}

// One launch: C[e] = epilogue(A[e] @ B[e]) for e < experts, C of element
// type T (passed by value, a __grid_constant__ kernel parameter).
template <typename T>
struct GemmT {
  CUtensorMap a_map;  // A (experts, m, k): boxes of depth x rows x 1
  CUtensorMap b_map;  // B (experts, k, n): boxes of box_cols x depth x 1
  T* c;
  int64_t c_batch;    // elements from one expert's C to the next
  int m, n, k;        // rows, columns, depth
  int m_tiles, n_tiles, splits;
  int chunks_per_split;
  int gelu;                           // apply gelu_tanh before the store
};
using Gemm = GemmT<float>;

// A body's tile and launch: output rows and columns per CTA, the depth of a
// chunk, B's TMA box width, threads and dynamic shared memory per CTA.
struct Body {
  int rows, cols, depth, box_cols, threads, smem_bytes;
};
constexpr Body kF32Body = {kRows, kCols, kDepth, kCols, kThreads, kSmemBytes};

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

// Fill the tiling of g for a launch of `body` on `sms` SMs; returns the CTA
// count.
template <typename T>
inline int64_t plan(GemmT<T>& g, int64_t experts, int sms,
                    const Body& body = kF32Body) {
  g.m_tiles = (g.m + body.rows - 1) / body.rows;
  g.n_tiles = (g.n + body.cols - 1) / body.cols;
  const int64_t chunks = (g.k + body.depth - 1) / body.depth;
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

// The tile's position: the cluster's CTAs are the splits of one tile,
// blockIdx.x = split + splits (column tile + n_tiles (row tile + m_tiles
// expert)).
struct TilePos {
  int split, row0, col0, e, kc0, kc1;
};
template <int kTileRows, int kTileCols, int kTileDepth, typename T>
__device__ __forceinline__ TilePos tile_pos(const GemmT<T>& g) {
  TilePos p;
  p.split = (int)(blockIdx.x % g.splits);  // == cluster.block_rank()
  int64_t tile = blockIdx.x / g.splits;
  p.col0 = (int)(tile % g.n_tiles) * kTileCols;
  tile /= g.n_tiles;
  p.row0 = (int)(tile % g.m_tiles) * kTileRows;
  p.e = (int)(tile / g.m_tiles);
  const int chunks = (g.k + kTileDepth - 1) / kTileDepth;
  p.kc0 = p.split * g.chunks_per_split;
  p.kc1 = p.kc0 + g.chunks_per_split < chunks ? p.kc0 + g.chunks_per_split
                                                : chunks;
  return p;
}

// A consumer warpgroup's m64nN accumulator (acc[4 j + 0..1]: row 16 warp +
// g, columns 8 j + 2 tq + {0, 1}; [4 j + 2..3] the same 8 rows on) into rows
// 64 wg .. of the CTA's partial sum, kPitch floats a row.
template <int kN, int kPitch>
__device__ __forceinline__ void store_partial(float* part,
                                              const float (&acc)[kN / 2],
                                              int wg, int t) {
  const int warp = t / 32, lane = t % 32;
  const int ra = 64 * wg + 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    *reinterpret_cast<float2*>(part + ra * kPitch + 8 * j + cq) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(part + (ra + 8) * kPitch + 8 * j + cq) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Four consecutive outputs: float32 as they are, bf16 rounded to nearest.
__device__ __forceinline__ void store4(float* p, float4 s) {
  *reinterpret_cast<float4*>(p) = s;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 s) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
}

// The split-K epilogue, after a cluster barrier that made every CTA's
// partial (kTileRows x kTileCols floats, kPitch a row, at `part`) visible: this
// CTA's share of the tile's rows summed over the cluster's distributed
// shared memory in rank order, the gelu (first launch), and the store, four
// columns a thread and step.  Deterministic: a fixed order, no atomics.
// Ends with the cluster barrier that keeps every CTA's memory alive until
// the last reader is done.
template <int kTileRows, int kTileCols, int kPitch, int kNThreads, typename T>
__device__ __forceinline__ void sum_store(const GemmT<T>& g,
                                          cg::cluster_group& cluster,
                                          float* part, const TilePos& p) {
  T* c = g.c + (int64_t)p.e * g.c_batch;
  const int r_lo = p.split * kTileRows / g.splits;
  const int r_hi = (p.split + 1) * kTileRows / g.splits;
  for (int i = threadIdx.x; i < (r_hi - r_lo) * (kTileCols / 4); i += kNThreads) {
    const int r = r_lo + i / (kTileCols / 4), c4 = 4 * (i % (kTileCols / 4));
    const int row = p.row0 + r, col = p.col0 + c4;
    if (row >= g.m || col >= g.n) continue;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < g.splits; ++q) {
      // (unsplit: this CTA's own shared memory, not the cluster window)
      const float* src = g.splits == 1 ? part : cluster.map_shared_rank(part, q);
      const float4 v = *reinterpret_cast<const float4*>(src + r * kPitch + c4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (g.gelu) s = gelu4<T>(s);
    store4(c + (int64_t)row * g.n + col, s);
  }
  cluster.sync();  // no CTA leaves while another still reads its memory
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

  const TilePos p = tile_pos<kRows, kCols, kDepth>(g);
  const int row0 = p.row0, col0 = p.col0, e = p.e, kc0 = p.kc0, kc1 = p.kc1;

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
    if (active) store_partial<kCols, kPartPitch>(part, acc, wg, t);
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kLaunchRegs));
  }
  cluster.sync();  // every partial of the tile written and visible
  sum_store<kRows, kCols, kPartPitch, kThreads>(g, cluster, part, p);
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

// Launch `kernel` (a __global__ taking a GemmT<T>: gemm_cta's or the bf16
// body's) of `body` for g over `experts` on `stream`.
template <typename Kernel, typename T>
cudaError_t launch_gemm(Kernel kernel, GemmT<T> g, int64_t experts,
                        cudaStream_t stream, const Body& body = kF32Body) {
  const int64_t blocks = plan(g, experts, sm_count(), body);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, body.smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(body.threads, 1, 1);
  cfg.dynamicSmemBytes = body.smem_bytes;
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

// A 3D tensor map over a contiguous (experts, rows, cols) tensor of T
// (float32: the f32 body's raw boxes, no swizzle; bf16: the bf16 body's
// boxes of one 128-byte row, 128-byte swizzled as wgmma reads them), boxes
// of box_cols x box_rows x 1, zeros out of bounds.
template <typename T>
inline int map_3d(CUtensorMap* map, const T* ptr, int64_t experts,
                  int64_t rows, int64_t cols, int box_cols, int box_rows) {
  constexpr bool kBf16 = sizeof(T) == 2;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)experts};
  const cuuint64_t strides[2] = {(cuuint64_t)(cols * sizeof(T)),
                                 (cuuint64_t)(rows * cols * sizeof(T))};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  3, const_cast<T*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  kBf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The launch C = A B of `body` for `experts` stacked (m, k) and (k, n)
// operands.
template <typename T>
inline int gemm(GemmT<T>& g, const T* a, const T* b, T* c, int64_t experts,
                int64_t m, int64_t n, int64_t k, int gelu,
                const Body& body = kF32Body) {
  g.c = c;
  g.c_batch = m * n;
  g.m = (int)m;
  g.n = (int)n;
  g.k = (int)k;
  g.gelu = gelu;
  int err = map_3d(&g.a_map, a, experts, m, k, body.depth, body.rows);
  if (err == 0) err = map_3d(&g.b_map, b, experts, k, n, body.box_cols, body.depth);
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
