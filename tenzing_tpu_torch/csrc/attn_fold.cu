// attn_fold: fold K/V keys into the online-softmax state (acc, m, l), in place.
//
// Replaces the TPU kernels attn_block_pallas (tenzing_tpu/ops/attention_pallas.py:66)
// and attn_fused_pallas (:165).  Both compute, per query row,
//
//     s = q k^T * scale;  m' = max(m, rowmax s);  alpha = exp(m - m');
//     p = exp(s - m');    l' = l alpha + rowsum p;  acc' = acc alpha + p v
//
// The TPU block kernel folds one K/V block per call with the state in HBM;
// the fused kernel keeps the state in VMEM scratch across a sequential kv
// grid axis, because on the TPU a sum can only be carried between grid steps.
// On Hopper the kv loop runs inside the thread block with the state in
// registers, so one kernel serves both: tz_attn_block folds one block of
// nkv keys, tz_attn_fused all of K/V, in one launch each.
//
// Layout: q (b, n, d) and acc/m/l (b, n, d) float32 with a contiguous last
// dim (batch and row strides are arguments); m and l are carried broadcast
// along d (the reference's layout): column 0 is read, every column is
// written.  Two kernels, both one CTA per (tile of query rows, batch element)
// with the kv loop inside and the state (acc, m, l) in registers:
//
// * attn_fold_f32 (f32 inputs), split-TF32 on wgmma: k/v float32 (b, nkv,
//   d) with batch and row strides, read in place.  Its body (producer and
//   consumer halves, attn_fold_f32.cuh, whose note gives the design) is the
//   one the fused_region kernel's attention members run too.  384 threads,
//   grid (ceil(n / 128), b), 230,528 bytes of shared memory: one CTA per SM.
//   The launcher refuses a pointer that is not 16-byte aligned or a stride
//   that is not a multiple of 4 floats (K rows move in 16-byte loads).
//
// * attn_fold_bf16 (bf16 inputs), designed for Hopper:
//   - K and V arrive as contiguous bfloat16 (b, nkv, d) copies that the
//     wrapper makes once per call (ops/attention_kernels.py cast_kv_bf16),
//     as the reference casts k/v before its Pallas call.  Q stays float32:
//     each CTA reads its 128 rows once and rounds them (__float2bfloat16_rn)
//     straight into the registers of the first product's A operand.
//   - Warp specialization: 384 threads, two consumer warpgroups (64 query
//     rows each, 128 per CTA) and one producer warpgroup whose first thread
//     issues every load; setmaxnreg moves registers from the producer (40)
//     to the consumers (232).  Grid (ceil(n / 128), b): 256 CTAs at the main
//     shape, one per SM at a time (~193 KB of shared memory).
//   - A ring of 128-key tiles in shared memory, filled by TMA
//     (cp.async.bulk.tensor, 3D maps over (d, nkv, b) so keys past nkv read
//     as zeros): kKStages K stages and kVStages V stages, each with a full
//     mbarrier (the producer's expect_tx plus the TMA bytes) and an empty
//     mbarrier (one arrival per consumer warp once its wgmma has read the
//     stage).  A tile's 128-wide rows are two 64-column boxes of 128 bytes,
//     stored with the 128-byte swizzle that the wgmma descriptors name.
//   - S = Q K^T with wgmma.m64n128k16 (A = Q from registers, B = the K tile,
//     K-major); P V with wgmma.m64n128k16 (A = p from registers, B = the V
//     tile read MN-major through the descriptor's transpose bit, so V needs
//     no transpose).  f32 accumulation throughout.
//   - Numerics of the reference's bf16 kernel: it rounds p = exp(s - m') to
//     bf16 against the running max after the *whole* kv block (bkv keys:
//     all nkv for tz_attn_block, the caller's bkv for tz_attn_fused), so the
//     kernel folds block by block in two passes over the block's K tiles.
//     Pass 1 streams K and finds the block's row max; then alpha and
//     acc *= alpha, once per block; pass 2 streams K and V, forms p against
//     the final m' (p in f32 for the row sum, rounded to bf16 as the A
//     operand of P V, the reference's p.astype(v.dtype)).  A one-pass
//     online fold over 128-key tiles would round p at another max and
//     differ from the reference by as much as leaving p unrounded.
//   - p = exp2f(s * (scale log2 e) - m' log2 e), one FMA and exp2f per
//     element, m kept in natural units; alpha (twice a row per block) is
//     expf(m - m').  Tiles wholly inside the block skip the key mask.  A
//     full-precision expf per element under the mask was the largest single
//     cost of this kernel's first version (bench/attn_bf16.py --ablate
//     times it); the exponent's error is a few ulp of |s * scale|, the size
//     of the f32 summation-order differences of s itself, which
//     BF16_STATE_TOL (ops/attention_kernels.py) is set for.
//
// The state is read and written in 8-byte vectors, a lane's column pair
// (the launcher refuses a state that is not 8-byte aligned).
//
// Precision (bf16 kernel): bf16 products, f32 sums.  m starts at -1e30:
// alpha = expf(-1e30 - m') = 0, never NaN.  Masked query rows (ragged n) load
// zeros, stay finite and are never stored; keys at or past the block's end
// get p = 0 (their V rows are zeros past nkv, finite inside it).
//
// Bound on an H100 SXM, bf16 inputs: operations, at 989 TFLOP/s.  The
// function's own count is 4*b*n*nkv*d (one-pass); this design does
// 6*b*n*nkv*d (Q K^T twice), 208 us at (4, 8192, 8192, 128).  For one
// 1024-key block the state's bytes (acc read and written, m and l written
// broadcast, at 3.35 TB/s) come out about equal to the operations.  f32
// inputs: 3 x 4*b*n*nkv*d (the split) at 495 TFLOP/s TF32.
//
// Within a warpgroup each product is waited for before the exp or the max
// that reads it; the two consumer warpgroups overlap each other.  Overlap
// inside a warpgroup was measured slower on the card and not kept: Q staged
// in shared memory with two score buffers in pass 1 spills at the 232
// registers setmaxnreg gives the consumers, and computing the next tile's
// exp while this tile's P V is in flight makes ptxas serialize the wgmmas
// (C7514, a non-wgmma instruction reading an accumulator inside a pipeline
// stage).  ptxas: 168 registers at entry, no spills.
//
// A mbarrier wait that has not completed after ~2^32 cycles traps, so a
// fault in the ring's parity bookkeeping ends the launch with an error
// instead of hanging the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fold_f32.cuh"
#include "hopper.cuh"

namespace {

// -- f32 inputs: split-TF32 wgmma (the body is attn_fold_f32.cuh) -----------

// One item per CTA: rows blockIdx.x * kRows .. of batch element blockIdx.y.
// kDense: q, K, V and state rows are contiguous (row stride d).
template <bool kDense>
__global__ void __launch_bounds__(tz_attn_f32::kThreads, 1)
attn_fold_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ acc,
              float* __restrict__ m, float* __restrict__ l, int n, int nkv,
              int64_t q_sb, int64_t q_sr, int64_t k_sb, int64_t k_sr,
              int64_t v_sb, int64_t v_sr, int64_t st_sb, int64_t st_sr,
              float scale, float scale2) {
  using namespace tz_attn_f32;
  extern __shared__ __align__(1024) unsigned char smem_f32[];
  const Smem sm = setup(smem_f32);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int64_t bi = blockIdx.y;
  Ring kr, vr;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    produce<kDense>(sm, kr, vr, k + bi * k_sb, v + bi * v_sb, k_sr, v_sr,
                    nkv, threadIdx.x % 128);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    consume<kDense>(sm, kr, vr, q + bi * q_sb, acc + bi * st_sb,
                    m + bi * st_sb, l + bi * st_sb,
                    (int64_t)blockIdx.x * kRows, n, nkv, q_sr, st_sr, scale,
                    scale2, wg, threadIdx.x % 128);
  }
}

// -- bf16 inputs: TMA ring, mbarriers, wgmma ----------------------------------

namespace bf16k {

using namespace tz_hopper;

constexpr int kHeadDim = 128;
constexpr int kConsumers = 2;                     // warpgroups, 64 rows each
constexpr int kRows = 64 * kConsumers;            // query rows per CTA
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kConsumerWarps = 4 * kConsumers;    // arrivals that free a stage
constexpr int kKeyTile = 128;                     // keys per K / V tile
constexpr int kKStages = 4;
constexpr int kVStages = 2;
constexpr int kHalfBytes = kKeyTile * 64 * 2;  // one 64-column (128-byte) box
constexpr int kTileBytes = 2 * kHalfBytes;     // 128 keys x 128 bf16
constexpr int kBarrierBytes = 128;
constexpr int kAlignBytes = 1024;  // the 128-byte swizzle's atom
constexpr int kSmemBytes =
    kAlignBytes + (kKStages + kVStages) * kTileBytes + kBarrierBytes;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536,
              "register budget");
static_assert(2 * (kKStages + kVStages) * 8 <= kBarrierBytes, "barriers");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- TMA: one box of a 3D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// -- wgmma

// d (+)= a b for a 64 x 128 x 16 step: a (64 x 16 bf16) from registers in
// the m16n8k16 A-fragment layout of each warp's 16 rows, b (16 x 128) from
// shared memory through `desc`; kTransB = 0 reads b K-major, 1 MN-major.
// kAccumulate = false overwrites d.
template <int kTransB, bool kAccumulate>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TZ_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : TZ_ACC64("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
          "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TZ_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : TZ_ACC64("=f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0),
          "n"(kTransB));
  }
}

// s = q k^T (unscaled) for this warpgroup's 64 rows x one 128-key K tile.
// The tile is two 64-column boxes [128 keys][64 d], 128-byte swizzled:
// k step kk (d 16 kk ..) is box kk / 4 at byte 32 (kk % 4) of each row; the
// next 8 keys are 1024 bytes on (SBO); LBO is unused for K-major swizzled
// operands.
__device__ __forceinline__ void scores(float (&s)[64],
                                       const uint32_t (&qf)[kHeadDim / 16][4],
                                       uint32_t ktile) {
  wg_fence();
  wgmma_rs<0, false>(s, qf[0], desc_sw128(ktile, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < kHeadDim / 16; ++kk)
    wgmma_rs<0, true>(s, qf[kk],
                      desc_sw128(ktile + (kk >> 2) * kHalfBytes + (kk & 3) * 32,
                                 16, 1024));
  wg_commit();
  wg_wait_all();
  fence_regs(s);
}

// o += p v for one 128-key V tile: k step kk (keys 16 kk ..) starts 2048
// bytes on; V is read MN-major (d contiguous): the next 8 keys are 1024
// bytes on (SBO), the next 64 columns are the other box (LBO).
__device__ __forceinline__ void fold_pv(float (&o)[64],
                                        const uint32_t (&pa)[kKeyTile / 16][4],
                                        uint32_t vtile) {
  fence_regs(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kKeyTile / 16; ++kk)
    wgmma_rs<1, true>(o, pa[kk], desc_sw128(vtile + kk * 2048, kHalfBytes, 1024));
  wg_commit();
  wg_wait_all();
  fence_regs(o);
}

// Row maxima of s * scale over the keys of one tile below `lim` (a row's
// 128 values sit in one quad: this thread's 32 of rows a and b).
// kMasked = false: the whole tile lies inside the block.
template <bool kMasked>
__device__ __forceinline__ void max_tile(const float (&s)[64], int lim, int tq,
                                         float scale, float& mx_a, float& mx_b) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (!kMasked || 8 * j + 2 * tq + c < lim) {
        mx_a = fmaxf(mx_a, __fmul_rn(s[4 * j + c], scale));
        mx_b = fmaxf(mx_b, __fmul_rn(s[4 * j + 2 + c], scale));
      }
    }
  }
}

// s := p = 2^(s scale2 - ml) in place (0 for keys at or past `lim`), and
// its row sums added to sum_a / sum_b.
template <bool kMasked>
__device__ __forceinline__ void exp_tile(float (&s)[64], int lim, int tq,
                                         float scale2, float ml_a, float ml_b,
                                         float& sum_a, float& sum_b) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool valid = !kMasked || 8 * j + 2 * tq + c < lim;
      float& xa = s[4 * j + c];
      float& xb = s[4 * j + 2 + c];
      xa = valid ? exp2f(__fmaf_rn(xa, scale2, -ml_a)) : 0.0f;
      xb = valid ? exp2f(__fmaf_rn(xb, scale2, -ml_b)) : 0.0f;
      sum_a += xa;
      sum_b += xb;
    }
  }
}

// The producer's half of one tile: wait for the stage to be free, arm its
// full barrier with the tile's bytes, and issue the two 64-column boxes.
template <int kStages>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          unsigned char* tiles, uint64_t* full,
                                          uint64_t* empty, Ring& r, int kv0,
                                          int bi) {
  mbar_wait(&empty[r.stage], r.phase ^ 1u);
  mbar_expect_tx(&full[r.stage], kTileBytes);
  unsigned char* dst = tiles + r.stage * kTileBytes;
  tma_load_3d(dst, map, &full[r.stage], 0, kv0, bi);
  tma_load_3d(dst + kHalfBytes, map, &full[r.stage], 64, kv0, bi);
  r.advance<kStages>();
}

__global__ void __launch_bounds__(kThreads, 1)
attn_fold_bf16(const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const float* __restrict__ q, float* __restrict__ acc,
               float* __restrict__ m, float* __restrict__ l, int n, int nkv,
               int bkv, int64_t q_sb, int64_t q_sr, int64_t st_sb,
               int64_t st_sr, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((kAlignBytes - (smem_u32(smem_raw) & (kAlignBytes - 1))) &
                  (kAlignBytes - 1));
  unsigned char* k_tiles = base;  // [kKStages][2 boxes][128 keys][64] bf16
  unsigned char* v_tiles = base + kKStages * kTileBytes;  // [kVStages][...]
  uint64_t* full_k =
      reinterpret_cast<uint64_t*>(v_tiles + kVStages * kTileBytes);
  uint64_t* empty_k = full_k + kKStages;
  uint64_t* full_v = empty_k + kKStages;
  uint64_t* empty_v = full_v + kVStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&empty_k[s], kConsumerWarps);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int bi = blockIdx.y;
  if (wg == kConsumers) {
    // -- producer: one thread walks the tile sequence the consumers expect
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      Ring kr, vr;
      for (int blk0 = 0; blk0 < nkv; blk0 += bkv) {
        const int blk1 = min(blk0 + bkv, nkv);
        for (int pass = 0; pass < 2; ++pass) {
          for (int kv0 = blk0; kv0 < blk1; kv0 += kKeyTile) {
            load_tile<kKStages>(&k_map, k_tiles, full_k, empty_k, kr, kv0, bi);
            if (pass == 1)
              load_tile<kVStages>(&v_map, v_tiles, full_v, empty_v, vr, kv0,
                                  bi);
          }
        }
      }
    }
  } else {
    // -- consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane >> 2;  // fragment row (and row + 8)
    const int tq = lane & 3;  // fragment column pair
    const int64_t ra = (int64_t)blockIdx.x * kRows + wg * 64 + warp * 16 + g;
    const int64_t rb = ra + 8;
    const bool la = ra < n, lb = rb < n;
    q += bi * q_sb;
    acc += bi * st_sb;
    m += bi * st_sb;
    l += bi * st_sb;

    // Q rows ra / rb as the A fragments of the 8 k steps, rounded to bf16
    uint32_t qf[kHeadDim / 16][4];
    {
      const float* qa = q + (la ? ra : 0) * q_sr;
      const float* qb = q + (lb ? rb : 0) * q_sr;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        const int c = 16 * kk + 2 * tq;
        qf[kk][0] = la ? pack_bf16(__ldg(qa + c), __ldg(qa + c + 1)) : 0u;
        qf[kk][1] = lb ? pack_bf16(__ldg(qb + c), __ldg(qb + c + 1)) : 0u;
        qf[kk][2] = la ? pack_bf16(__ldg(qa + c + 8), __ldg(qa + c + 9)) : 0u;
        qf[kk][3] = lb ? pack_bf16(__ldg(qb + c + 8), __ldg(qb + c + 9)) : 0u;
      }
    }
    // the state: o[4 j + 0..3] = acc (ra, 8 j + 2 tq + {0, 1}), (rb, ...)
    float m_a = la ? m[ra * st_sr] : 0.0f, m_b = lb ? m[rb * st_sr] : 0.0f;
    float l_a = la ? l[ra * st_sr] : 0.0f, l_b = lb ? l[rb * st_sr] : 0.0f;
    float o[64];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * tq;
      const float2 xa = la ? *reinterpret_cast<const float2*>(acc + ra * st_sr + c)
                           : make_float2(0.0f, 0.0f);
      const float2 xb = lb ? *reinterpret_cast<const float2*>(acc + rb * st_sr + c)
                           : make_float2(0.0f, 0.0f);
      o[4 * j + 0] = xa.x;
      o[4 * j + 1] = xa.y;
      o[4 * j + 2] = xb.x;
      o[4 * j + 3] = xb.y;
    }

    const uint32_t k_base = smem_u32(k_tiles), v_base = smem_u32(v_tiles);
    Ring kr, vr;
    for (int blk0 = 0; blk0 < nkv; blk0 += bkv) {
      const int blk1 = min(blk0 + bkv, nkv);

      // pass 1: the block's row max of s * scale (a row's 128 values of a
      // tile sit in one quad)
      float mx_a = -INFINITY, mx_b = -INFINITY;
      for (int kv0 = blk0; kv0 < blk1; kv0 += kKeyTile) {
        mbar_wait(&full_k[kr.stage], kr.phase);
        float s[64];
        scores(s, qf, k_base + kr.stage * kTileBytes);
        release(&empty_k[kr.stage], lane);
        kr.advance<kKStages>();
        const int lim = blk1 - kv0;  // keys of this tile inside the block
        if (lim >= kKeyTile)
          max_tile<false>(s, lim, tq, scale, mx_a, mx_b);
        else
          max_tile<true>(s, lim, tq, scale, mx_a, mx_b);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j + 0] *= al_a;
        o[4 * j + 1] *= al_a;
        o[4 * j + 2] *= al_b;
        o[4 * j + 3] *= al_b;
      }

      // pass 2: p = exp(s * scale - m'), its row sum in f32, o += bf16(p) v
      const float scale2 = scale * kLog2e;  // s * scale in log2 units
      const float ml_a = m_a * kLog2e, ml_b = m_b * kLog2e;
      float sum_a = 0.0f, sum_b = 0.0f;
      for (int kv0 = blk0; kv0 < blk1; kv0 += kKeyTile) {
        mbar_wait(&full_k[kr.stage], kr.phase);
        float s[64];
        scores(s, qf, k_base + kr.stage * kTileBytes);
        release(&empty_k[kr.stage], lane);
        kr.advance<kKStages>();
        const int lim = blk1 - kv0;
        if (lim >= kKeyTile)
          exp_tile<false>(s, lim, tq, scale2, ml_a, ml_b, sum_a, sum_b);
        else
          exp_tile<true>(s, lim, tq, scale2, ml_a, ml_b, sum_a, sum_b);
        // the s fragments of keys 16 kk .. 16 kk + 15 are the A fragment
        // of step kk, p rounded to bf16
        uint32_t pa[kKeyTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKeyTile / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        mbar_wait(&full_v[vr.stage], vr.phase);
        fold_pv(o, pa, v_base + vr.stage * kTileBytes);
        release(&empty_v[vr.stage], lane);
        vr.advance<kVStages>();
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
      }
      l_a = __fadd_rn(__fmul_rn(l_a, al_a), sum_a);
      l_b = __fadd_rn(__fmul_rn(l_b, al_b), sum_b);
    }

    // 8-byte stores of each lane's column pairs (scalar stores cost a
    // quarter of the one-block fold: bench/attn_bf16.py --ablate)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * tq;
      if (la) {
        *reinterpret_cast<float2*>(acc + ra * st_sr + c) =
            make_float2(o[4 * j + 0], o[4 * j + 1]);
        *reinterpret_cast<float2*>(m + ra * st_sr + c) = make_float2(m_a, m_a);
        *reinterpret_cast<float2*>(l + ra * st_sr + c) = make_float2(l_a, l_a);
      }
      if (lb) {
        *reinterpret_cast<float2*>(acc + rb * st_sr + c) =
            make_float2(o[4 * j + 2], o[4 * j + 3]);
        *reinterpret_cast<float2*>(m + rb * st_sr + c) = make_float2(m_b, m_b);
        *reinterpret_cast<float2*>(l + rb * st_sr + c) = make_float2(l_b, l_b);
      }
    }
  }
}

// -- host: tensor maps (encode_tiled: hopper.cuh)

// A 3D map over a contiguous bf16 (b, nkv, 128) tensor, boxes of
// 64 columns x kKeyTile keys x 1, 128-byte swizzle, zeros out of bounds.
int kv_map(CUtensorMap* map, const void* ptr, int64_t b, int64_t nkv) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)kHeadDim, (cuuint64_t)nkv,
                              (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)kHeadDim * 2,
                                 (cuuint64_t)(nkv * kHeadDim * 2)};
  const cuuint32_t box[3] = {64, (cuuint32_t)kKeyTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch(const float* q, const void* k, const void* v, float* acc, float* m,
           float* l, int64_t b, int64_t n, int64_t nkv, int64_t bkv,
           int64_t q_sb, int64_t q_sr, int64_t k_sb, int64_t k_sr,
           int64_t v_sb, int64_t v_sr, int64_t st_sb, int64_t st_sr,
           float scale, cudaStream_t stream) {
  // K and V: contiguous bf16 (b, nkv, 128)
  if (k_sr != kHeadDim || v_sr != kHeadDim || (b > 1 && (k_sb != nkv * kHeadDim ||
                                                          v_sb != nkv * kHeadDim)))
    return (int)cudaErrorInvalidValue;
  if (n > (1 << 30) || nkv > (1 << 30)) return (int)cudaErrorInvalidValue;
  // the state is read and written in 8-byte vectors
  if (((uintptr_t)acc | (uintptr_t)m | (uintptr_t)l) % 8 || st_sr % 2 ||
      (b > 1 && st_sb % 2))
    return (int)cudaErrorInvalidValue;
  if (bkv > nkv) bkv = nkv;
  CUtensorMap km, vm;
  int err = kv_map(&km, k, b, nkv);
  if (err == 0) err = kv_map(&vm, v, b, nkv);
  if (err != 0) return err;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fold_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((unsigned)((n + kRows - 1) / kRows), (unsigned)b);
  attn_fold_bf16<<<grid, kThreads, kSmemBytes, stream>>>(
      km, vm, q, acc, m, l, (int)n, (int)nkv, (int)bkv, q_sb, q_sr, st_sb,
      st_sr, scale);
  return (int)cudaGetLastError();
}

}  // namespace bf16k

// -- launch -----------------------------------------------------------------

int launch_f32(const float* q, const float* k, const float* v, float* acc,
               float* m, float* l, int64_t b, int64_t n, int64_t nkv,
               int64_t q_sb, int64_t q_sr, int64_t k_sb, int64_t k_sr,
               int64_t v_sb, int64_t v_sr, int64_t st_sb, int64_t st_sr,
               float scale, cudaStream_t stream) {
  using tz_attn_f32::kRows;
  using tz_attn_f32::kSmemBytes;
  if (n > (1 << 30) || nkv > (1 << 30)) return (int)cudaErrorInvalidValue;
  // K rows move in 16-byte loads and the state in 8-byte vectors: every
  // pointer 16-byte aligned, every row and batch stride a multiple of 4
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                         (uintptr_t)acc | (uintptr_t)m | (uintptr_t)l;
  const int64_t strides = q_sr | k_sr | v_sr | st_sr |
                          (b > 1 ? q_sb | k_sb | v_sb | st_sb : 0);
  if (ptrs % 16 || strides % 4) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {  // one attribute call each
    for (auto fn : {attn_fold_f32<true>, attn_fold_f32<false>}) {
      cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (err != cudaSuccess) return (int)err;
    }
    configured = true;
  }
  dim3 grid((unsigned)((n + kRows - 1) / kRows), (unsigned)b);
  constexpr int64_t d = tz_attn_f32::kHeadDim;
  auto fn = q_sr == d && k_sr == d && v_sr == d && st_sr == d
                ? attn_fold_f32<true>
                : attn_fold_f32<false>;
  fn<<<grid, tz_attn_f32::kThreads, kSmemBytes, stream>>>(
      q, k, v, acc, m, l, (int)n, (int)nkv, q_sb, q_sr, k_sb, k_sr, v_sb,
      v_sr, st_sb, st_sr, scale, scale * tz_attn_f32::kLog2e);
  return (int)cudaGetLastError();
}

int dispatch(const float* q, const void* k, const void* v, float* acc,
             float* m, float* l, int64_t b, int64_t n, int64_t nkv,
             int64_t bkv, int64_t d, int64_t q_sb, int64_t q_sr, int64_t k_sb,
             int64_t k_sr, int64_t v_sb, int64_t v_sr, int64_t st_sb,
             int64_t st_sr, float scale, int64_t bf16, void* stream) {
  if (d != 128 || bkv < 1) return (int)cudaErrorInvalidValue;
  if (bf16)
    return bf16k::launch(q, k, v, acc, m, l, b, n, nkv, bkv, q_sb, q_sr, k_sb,
                         k_sr, v_sb, v_sr, st_sb, st_sr, scale,
                         (cudaStream_t)stream);
  return launch_f32(q, static_cast<const float*>(k),
                    static_cast<const float*>(v), acc, m, l, b, n, nkv, q_sb,
                    q_sr, k_sb, k_sr, v_sb, v_sr, st_sb, st_sr, scale,
                    (cudaStream_t)stream);
}

}  // namespace

// Fold one K/V block of nkv keys into (acc, m, l) on `stream`; returns the
// launch's cudaError_t (0 on success).  With bf16 == 0, k and v are float32
// with the given strides; with bf16 != 0 they are contiguous bfloat16
// (b, nkv, d) copies (the strides must say so).  The caller checks dtypes,
// shapes, strides, d == 128 and b <= 65535 before calling.
extern "C" int tz_attn_block(const float* q, const void* k, const void* v,
                             float* acc, float* m, float* l,
                             int64_t b, int64_t n, int64_t nkv, int64_t d,
                             int64_t q_sb, int64_t q_sr, int64_t k_sb,
                             int64_t k_sr, int64_t v_sb, int64_t v_sr,
                             int64_t st_sb, int64_t st_sr, float scale,
                             int64_t bf16, void* stream) {
  return dispatch(q, k, v, acc, m, l, b, n, nkv, nkv, d, q_sb, q_sr, k_sb,
                  k_sr, v_sb, v_sr, st_sb, st_sr, scale, bf16, stream);
}

// Fold all nkv resident keys into (acc, m, l) in one launch, as consecutive
// blocks of bkv keys (the reference's kv block); the state stays in
// registers across the whole kv loop.  Same contract as tz_attn_block.
extern "C" int tz_attn_fused(const float* q, const void* k, const void* v,
                             float* acc, float* m, float* l,
                             int64_t b, int64_t n, int64_t nkv, int64_t bkv,
                             int64_t d,
                             int64_t q_sb, int64_t q_sr, int64_t k_sb,
                             int64_t k_sr, int64_t v_sb, int64_t v_sr,
                             int64_t st_sb, int64_t st_sr, float scale,
                             int64_t bf16, void* stream) {
  return dispatch(q, k, v, acc, m, l, b, n, nkv, bkv, d, q_sb, q_sr, k_sb,
                  k_sr, v_sb, v_sr, st_sb, st_sr, scale, bf16, stream);
}

// The bf16 kernel's launch constants, for the wrapper's launch plan to be
// held against: query rows per CTA, keys per tile, K stages, V stages,
// threads per CTA, dynamic shared memory bytes.
extern "C" int tz_attn_bf16_config(int64_t* out) {
  out[0] = bf16k::kRows;
  out[1] = bf16k::kKeyTile;
  out[2] = bf16k::kKStages;
  out[3] = bf16k::kVStages;
  out[4] = bf16k::kThreads;
  out[5] = bf16k::kSmemBytes;
  return 0;
}

// The f32 kernel's launch constants, in the order of tz_attn_bf16_config.
extern "C" int tz_attn_f32_config(int64_t* out) {
  out[0] = tz_attn_f32::kRows;
  out[1] = tz_attn_f32::kKeyTile;
  out[2] = tz_attn_f32::kKStages;
  out[3] = tz_attn_f32::kVStages;
  out[4] = tz_attn_f32::kThreads;
  out[5] = tz_attn_f32::kSmemBytes;
  return 0;
}
