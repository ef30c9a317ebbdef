// The f32 online-softmax fold, split-TF32 on wgmma: the body shared by the
// attn_fold_f32 kernel (attn_fold.cu) and the attention instantiation of
// the fused_region kernel (fused_region.cu).
//
// For each query row of an item (a tile of kRows query rows of one batch
// element) it computes, over the item's nkv keys,
//
//     s = q k^T * scale;  m' = max(m, rowmax s);  alpha = exp(m - m');
//     p = exp(s - m');    l' = l alpha + rowsum p;  acc' = acc alpha + p v
//
// one key tile at a time, with the state (acc, m, l) in registers and
// written back in place: (rows, d) float32 with a row stride, m and l
// broadcast along d (column 0 is read, every column is written).
//
// Float32 accuracy on the tensor cores.  Every operand x is split into
// hi = tf32_rna(x) and lo = tf32_rna(x - hi) (hopper.cuh), and each
// product is hi hi + hi lo + lo hi in f32 (lo lo, ~2^-22 of a term, is
// dropped): 3xTF32, the scheme of PyTorch's f32 memory-efficient attention,
// here on wgmma.  One TF32 pass alone keeps ~3 decimal digits and is a
// different result (bench/attn_f32.py --ablate builds it as a control).
// p = exp2f(s * (scale log2 e) - m' log2 e): one FMA and exp2f per element;
// alpha stays expf.  m starts at -1e30: alpha = expf(-1e30 - m') = 0, never
// NaN.  Masked query rows load zeros, stay finite and are never stored; keys
// past nkv read as zeros and get p = 0.
//
// What the card asks of the design (H100, sm_90a):
// - tf32 wgmma is m64nNk8: 8-deep reductions, and B is read K-major only
//   (the descriptor's transpose bit exists for 16-bit types alone).  For
//   S = Q K^T a K tile (keys x d, d contiguous) is K-major as it stands; for
//   P V the reduction runs over keys, so V is stored transposed in its stage
//   (d rows of kKeyTile keys).
// - 32-bit operands, and hi and lo, take four times the bf16 kernel's
//   bytes, so its plan does not fit.  This one: two consumer warpgroups of
//   64 rows (kRows = 128 a CTA) and a producer warpgroup (384 threads);
//   32-key tiles (S, P's hi and lo and a P V quarter 16 registers each, acc
//   64, added to in f32 outside the tensor cores: fold_pv); q_hi as
//   the register A operand (64 registers), q_lo in shared memory (32 KB per
//   warpgroup, the shared-memory A operand of q_lo k_hi); kKStages K and
//   kVStages V stages of 32 KB (hi + lo): kSmemBytes = 230,528 of the
//   232,448 one block may use, one CTA per SM.  setmaxnreg gives the
//   consumers kConsumerRegs and the producer kProducerRegs, out of the 168
//   a thread the CTA holds at launch (a setmaxnreg.inc beyond that waits
//   forever).
// - The split happens in the producer warpgroup: its 128 threads load raw
//   float32 K rows (16-byte loads) and V columns (4-byte loads, a warp
//   reading 128 contiguous bytes of one key row) through the caller's
//   pointers and row strides, split them, write them 128-byte swizzled into
//   the stage (V transposed), fence the async proxy and arrive on the
//   stage's full mbarrier (kProducerThreads arrivals).  So no tensor map
//   (fused_region's by-value member table has no room for one), K/V are
//   read once in f32 and no per-call split pass runs.  A consumer warp
//   arrives on the stage's empty mbarrier once its wgmma has read it.
// - P from the S accumulator is the A operand of P V without a shuffle:
//   a thread holds keys 2t, 2t+1 of each 8-key group where the A fragment
//   wants t and t+4, so the reduction runs over the keys of each group in
//   the order 0 2 4 6 1 3 5 7, and the producer stores V^T's keys in that
//   order (load_v).
//
// Within a warpgroup each product is waited for before the softmax or the
// store that reads it; the two consumer warpgroups overlap each other.
//
// Bound on an H100 SXM: operations, 3 x 4 b n nkv d (the split) at 495
// TFLOP/s TF32.  A mbarrier wait that has not completed after ~2^32 cycles
// traps, so a fault in the ring's bookkeeping ends the launch with an error.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tz_attn_f32 {

using namespace tz_hopper;

constexpr int kHeadDim = 128;
constexpr int kConsumers = 2;                     // warpgroups, 64 rows each
constexpr int kRows = 64 * kConsumers;            // query rows per item
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerThreads = 128;             // arrivals that fill a stage
constexpr int kConsumerWarps = 4 * kConsumers;    // arrivals that free a stage
constexpr int kKeyTile = 32;                      // keys per K / V tile
constexpr int kKStages = 3;
constexpr int kVStages = 2;
constexpr int kPlaneBytes = kKeyTile * kHeadDim * 4;  // the hi or lo of a tile
constexpr int kStageBytes = 2 * kPlaneBytes;
constexpr int kBoxBytes = kKeyTile * 128;  // K: 32 columns (128 B) of a tile
constexpr int kQBoxBytes = 64 * 128;       // q_lo: 32 columns of 64 rows
constexpr int kQloBytes = 64 * kHeadDim * 4;  // one warpgroup's q_lo
constexpr int kBarrierBytes = 128;
constexpr int kAlignBytes = 1024;  // the 128-byte swizzle's atom
constexpr int kSmemBytes = kAlignBytes + kConsumers * kQloBytes +
                           (kKStages + kVStages) * kStageBytes + kBarrierBytes;
constexpr float kLog2e = 1.4426950408889634f;
// setmaxnreg moves registers between the warps of one CTA: the shares may
// not exceed what the CTA holds at launch, 168 a thread (65,536 / 384, in
// steps of 8).  The producer keeps a tile's K (8 float4 loads a thread),
// then its V (32 scalar loads), in flight.
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                  kLaunchRegs * kThreads,
              "register budget");
static_assert(2 * (kKStages + kVStages) * 8 <= kBarrierBytes, "barriers");
static_assert(kSmemBytes <= 232448, "one block's shared memory");
static_assert(kKeyTile * 4 == 128, "a V^T row is one 128-byte swizzle row");

// The CTA's shared memory, carved from the dynamic allocation.
struct Smem {
  unsigned char* qlo;  // [kConsumers][4 boxes][64 rows][128 B]
  unsigned char* k;    // [kKStages][hi, lo][4 boxes][kKeyTile keys][128 B]
  unsigned char* v;    // [kVStages][hi, lo][kHeadDim rows][kKeyTile keys]
  uint32_t bar;  // shared address of the barriers: full K, empty K, full V,
                 // empty V, one per stage
  __device__ __forceinline__ uint32_t full_k(int s) const { return bar + 8 * s; }
  __device__ __forceinline__ uint32_t empty_k(int s) const {
    return bar + 8 * (kKStages + s);
  }
  __device__ __forceinline__ uint32_t full_v(int s) const {
    return bar + 8 * (2 * kKStages + s);
  }
  __device__ __forceinline__ uint32_t empty_v(int s) const {
    return bar + 8 * (2 * kKStages + kVStages + s);
  }
};

// Carve `raw` (kSmemBytes) and, on thread 0, initialize the barriers; the
// caller synchronizes the CTA before any thread uses them.
__device__ __forceinline__ Smem setup(unsigned char* raw) {
  unsigned char* base =
      raw + ((kAlignBytes - (smem_u32(raw) & (kAlignBytes - 1))) &
             (kAlignBytes - 1));
  Smem sm;
  sm.qlo = base;
  sm.k = base + kConsumers * kQloBytes;
  sm.v = sm.k + kKStages * kStageBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm.v + kVStages * kStageBytes);
  sm.bar = smem_u32(bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&bars[s], kProducerThreads);
      mbar_init(&bars[kKStages + s], kConsumerWarps);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&bars[2 * kKStages + s], kProducerThreads);
      mbar_init(&bars[2 * kKStages + kVStages + s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return sm;
}

// Make values computed by ordinary instructions ready before a wgmma fence.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// -- wgmma, tf32 (m64nNk8; the instruction has no transpose operands)

// d (+)= a b, 64 x 32 x 8: a from registers (m16n8k8 tf32 A fragments of
// each warp's 16 rows), b through `db`.
template <bool kAccumulate>
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " TZ_REGS16
        ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : TZ_ACC16("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " TZ_REGS16
        ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : TZ_ACC16("=f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
  }
}

// s += a b, 64 x 32 x 8, a through `da` (shared memory, K-major).
__device__ __forceinline__ void mma_s_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " TZ_REGS16
      ", %16, %17, p, 1, 1;\n}\n"
      : TZ_ACC16("+f", d)
      : "l"(da), "l"(db), "r"(1));
}

// Descriptors of k step kk (8 columns, 32 bytes) of a K plane, of a
// warpgroup's q_lo, and of a V^T plane: 128-byte swizzled, K-major, the
// next 8 rows 1024 bytes on (SBO); LBO is unused for these layouts.
__device__ __forceinline__ uint64_t k_desc(uint32_t plane, int kk) {
  return desc_sw128(plane + (kk >> 2) * kBoxBytes + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t q_desc(uint32_t qlo, int kk) {
  return desc_sw128(qlo + (kk >> 2) * kQBoxBytes + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t v_desc(uint32_t plane, int kk) {
  return desc_sw128(plane + kk * 32, 16, 1024);
}

// s = q k^T (unscaled) for this warpgroup's 64 rows x one key tile, as
// q_hi k_hi + q_hi k_lo + q_lo k_hi.
__device__ __forceinline__ void scores(float (&s)[16],
                                       const uint32_t (&qh)[kHeadDim / 8][4],
                                       uint32_t qlo, uint32_t khi) {
  const uint32_t klo = khi + kPlaneBytes;
  wg_fence();
  mma_rs<false>(s, qh[0], k_desc(khi, 0));
#pragma unroll
  for (int kk = 1; kk < kHeadDim / 8; ++kk) mma_rs<true>(s, qh[kk], k_desc(khi, kk));
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 8; ++kk) mma_rs<true>(s, qh[kk], k_desc(klo, kk));
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 8; ++kk)
    mma_s_ss(s, q_desc(qlo, kk), k_desc(khi, kk));
  wg_commit();
  wg_wait_all();
  fence_regs(s);
}

// o += p v for one V tile, as p_hi v_hi + p_hi v_lo + p_lo v_hi, in four
// 32-column quarters: each quarter's 12 products are summed on the tensor
// cores into a zeroed t, which is then added to o with f32 adds.  The
// tensor cores' adds into an accumulator lose up to an ulp of it each, all
// the same way: accumulating every tile into o (3072 adds over 8192 keys)
// read 5.5e-5 relative rms error on acc / l against the plain fold at the
// main shape on an H100, 27x the split's own 2.0e-6 (bench/attn_f32.py).
__device__ __forceinline__ void fold_pv(float (&o)[64],
                                        uint32_t (&ph)[kKeyTile / 8][4],
                                        uint32_t (&pl)[kKeyTile / 8][4],
                                        uint32_t vhi) {
  const uint32_t vlo = vhi + kPlaneBytes;
  fence_frags(ph);
  fence_frags(pl);
#pragma unroll
  for (int nq = 0; nq < kHeadDim / 32; ++nq) {
    const uint32_t ch = vhi + nq * 32 * 128, cl = vlo + nq * 32 * 128;
    float t[16];
    wg_fence();
    mma_rs<false>(t, ph[0], v_desc(ch, 0));
#pragma unroll
    for (int kk = 1; kk < kKeyTile / 8; ++kk) mma_rs<true>(t, ph[kk], v_desc(ch, kk));
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 8; ++kk) mma_rs<true>(t, ph[kk], v_desc(cl, kk));
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 8; ++kk) mma_rs<true>(t, pl[kk], v_desc(ch, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(t);
    // t[4 j + c] is o's column 32 nq + 8 j + 2 tq (+1): o[4 (4 nq + j) + c]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[4 * (4 * nq + j) + c] += t[4 * j + c];
  }
}

// Row maxima of s * scale over the tile's keys below `lim` (a row's 32
// values sit in one quad: this thread's 8 of rows a and b).  kMasked =
// false: the whole tile is inside nkv.
template <bool kMasked>
__device__ __forceinline__ void max_tile(const float (&s)[16], int lim, int tq,
                                         float scale, float& mx_a, float& mx_b) {
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (!kMasked || 8 * j + 2 * tq + c < lim) {
        mx_a = fmaxf(mx_a, __fmul_rn(s[4 * j + c], scale));
        mx_b = fmaxf(mx_b, __fmul_rn(s[4 * j + 2 + c], scale));
      }
    }
  }
}

// s := p = 2^(s scale2 - ml) in place (0 for keys at or past `lim`), its
// row sums added to sum_a / sum_b.
template <bool kMasked>
__device__ __forceinline__ void exp_tile(float (&s)[16], int lim, int tq,
                                         float scale2, float ml_a, float ml_b,
                                         float& sum_a, float& sum_b) {
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j) {
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

// Synchronize the 128 threads of consumer warpgroup `wg` (named barrier).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// K tile kv0: 16-byte chunk c (d 4c .. 4c+3) of key kv0 + r, a warp per
// key, into registers (zeros past nkv).
__device__ __forceinline__ void load_k(float4 (&x)[8], const float* __restrict__ k,
                                       int64_t k_sr, int kv0, int nkv, int pt) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = pt + kProducerThreads * i, r = e >> 5, c = e & 31;
    x[i] = kv0 + r < nkv
               ? __ldg(reinterpret_cast<const float4*>(
                           k + (int64_t)(kv0 + r) * k_sr) + c)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// V^T tile kv0: row pt (d), chunk h = positions 4h .. 4h+3 = keys
// 8 (h / 2) + 2 j + h % 2 of the tile, j < 4: each 8-key group in the
// order 0 2 4 6 1 3 5 7.
__device__ __forceinline__ void load_v(float (&x)[8][4], const float* __restrict__ v,
                                       int64_t v_sr, int kv0, int nkv, int pt) {
#pragma unroll
  for (int h = 0; h < 8; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kv0 + 8 * (h >> 1) + 2 * j + (h & 1);
      x[h][j] = key < nkv ? __ldg(v + (int64_t)key * v_sr + pt) : 0.0f;
    }
}

// Split a loaded K tile into the next K stage and mark it full.
__device__ __forceinline__ void store_k(const Smem& sm, Ring& kr,
                                        const float4 (&x)[8], int pt) {
  mbar_wait(sm.empty_k(kr.stage), kr.phase ^ 1u);
  unsigned char* hi = sm.k + kr.stage * kStageBytes;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = pt + kProducerThreads * i, r = e >> 5, c = e & 31;
    const int off = (c >> 3) * kBoxBytes + sw128(r, c & 7);
    uint4 h, l;
    split4(x[i], h, l);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(hi + kPlaneBytes + off) = l;
  }
  fence_proxy_async();
  mbar_arrive(sm.full_k(kr.stage));
  kr.advance<kKStages>();
}

// Split a loaded V tile into the next V stage (transposed) and mark it full.
__device__ __forceinline__ void store_v(const Smem& sm, Ring& vr,
                                        const float (&x)[8][4], int pt) {
  mbar_wait(sm.empty_v(vr.stage), vr.phase ^ 1u);
  unsigned char* hi = sm.v + vr.stage * kStageBytes;
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    const int off = sw128(pt, h);
    uint4 hv, lv;
    split4(make_float4(x[h][0], x[h][1], x[h][2], x[h][3]), hv, lv);
    *reinterpret_cast<uint4*>(hi + off) = hv;
    *reinterpret_cast<uint4*>(hi + kPlaneBytes + off) = lv;
  }
  fence_proxy_async();
  mbar_arrive(sm.full_v(vr.stage));
  vr.advance<kVStages>();
}

// The producer's half of one item: every thread of the producer warpgroup
// (pt its index, 0..127) splits and stores the K and V tiles of keys
// [0, nkv) of k / v (row strides k_sr, v_sr), in the consumers' order.
// kDense: K and V rows are kHeadDim floats apart (the strides are
// ignored), so every load of a tile is one base address and an immediate
// offset.
template <bool kDense>
__device__ __forceinline__ void produce(const Smem& sm, Ring& kr, Ring& vr,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        int64_t k_sr, int64_t v_sr, int nkv,
                                        int pt) {
  if (kDense) k_sr = v_sr = kHeadDim;
  for (int kv0 = 0; kv0 < nkv; kv0 += kKeyTile) {
    float4 xk[8];
    float xv[8][4];
    load_k(xk, k, k_sr, kv0, nkv, pt);
    store_k(sm, kr, xk, pt);
    load_v(xv, v, v_sr, kv0, nkv, pt);
    store_v(sm, vr, xv, pt);
  }
}

// The consumers' half of one item: fold the producer's tiles of nkv keys
// into the state of query rows [row0, row0 + kRows) below n (q, acc, m, l
// already offset to the item's batch element; row strides q_sr, st_sr);
// scale2 = scale log2 e, s * scale in log2 units.
// wg: this thread's consumer warpgroup, t: its index there (0..127).
// kDense: q and state rows are kHeadDim floats apart (the strides are
// ignored), so no row address need stay live across the kv loop.
template <bool kDense>
__device__ __forceinline__ void consume(const Smem& sm, Ring& kr, Ring& vr,
                                        const float* __restrict__ q,
                                        float* __restrict__ acc,
                                        float* __restrict__ m,
                                        float* __restrict__ l, int64_t row0,
                                        int64_t n, int nkv, int64_t q_sr,
                                        int64_t st_sr, float scale,
                                        float scale2, int wg,
                                        int t) {
  if (kDense) q_sr = st_sr = kHeadDim;
  const int warp = t / 32, lane = t % 32;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int tq = lane & 3;  // fragment column (pair)
  const int r_a = warp * 16 + g;  // row in the warpgroup's 64
  const int64_t ra = row0 + wg * 64 + r_a, rb = ra + 8;
  const bool la = ra < n, lb = rb < n;
  unsigned char* qlo = sm.qlo + wg * kQloBytes;

  // q rows ra / rb: hi as the A fragments of the 16 k steps ((g, t),
  // (g + 8, t), (g, t + 4), (g + 8, t + 4) of each), lo into shared memory
  wg_sync(wg);  // the warpgroup's reads of the last item's q_lo are done
  uint32_t qh[kHeadDim / 8][4];
  {
    const float* qa = q + (la ? ra : 0) * q_sr;
    const float* qb = q + (lb ? rb : 0) * q_sr;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 8; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 8 * kk + tq + 4 * half;
        const float xa = la ? __ldg(qa + c) : 0.0f;
        const float xb = lb ? __ldg(qb + c) : 0.0f;
        uint32_t lo_a, lo_b;
        split(xa, qh[kk][2 * half], lo_a);
        split(xb, qh[kk][2 * half + 1], lo_b);
        const int box = (c >> 5) * kQBoxBytes, in = (c & 3) * 4;
        *reinterpret_cast<uint32_t*>(qlo + box + sw128(r_a, (c & 31) >> 2) + in) = lo_a;
        *reinterpret_cast<uint32_t*>(qlo + box + sw128(r_a + 8, (c & 31) >> 2) + in) = lo_b;
      }
    }
  }
  fence_frags(qh);
  fence_proxy_async();
  wg_sync(wg);

  // the state: o[4 j + 0..1] = acc (ra, 8 j + 2 tq + {0, 1}), [+2..3] (rb)
  float m_a = la ? m[ra * st_sr] : 0.0f, m_b = lb ? m[rb * st_sr] : 0.0f;
  // l is summed per thread and over the quad at the end: the carried l
  // enters once
  float l_a = la && tq == 0 ? l[ra * st_sr] : 0.0f;
  float l_b = lb && tq == 0 ? l[rb * st_sr] : 0.0f;
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

  const uint32_t qlo_base = smem_u32(qlo);
  const uint32_t k_base = smem_u32(sm.k), v_base = smem_u32(sm.v);
  for (int kv0 = 0; kv0 < nkv; kv0 += kKeyTile) {
    mbar_wait(sm.full_k(kr.stage), kr.phase);
    // q_lo's descriptors are loop-invariant: an opaque base keeps the
    // compiler from holding all 16 in registers across the loop
    uint32_t qb = qlo_base;
    asm volatile("" : "+r"(qb));
    float s[16];
    scores(s, qh, qb, k_base + kr.stage * kStageBytes);
    release(sm.empty_k(kr.stage), lane);
    kr.advance<kKStages>();

    const int lim = nkv - kv0;  // keys of this tile inside nkv
    float mx_a = -INFINITY, mx_b = -INFINITY;
    if (lim >= kKeyTile)
      max_tile<false>(s, lim, tq, scale, mx_a, mx_b);
    else
      max_tile<true>(s, lim, tq, scale, mx_a, mx_b);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
    if (lim >= kKeyTile)
      exp_tile<false>(s, lim, tq, scale2, mn_a * kLog2e, mn_b * kLog2e, sum_a,
                      sum_b);
    else
      exp_tile<true>(s, lim, tq, scale2, mn_a * kLog2e, mn_b * kLog2e, sum_a,
                     sum_b);
    l_a = __fadd_rn(__fmul_rn(l_a, al_a), sum_a);
    l_b = __fadd_rn(__fmul_rn(l_b, al_b), sum_b);
    // after the first tiles a row's max rarely moves: skip the rescale
    // where it moved in no row of the warp (alpha is then exactly 1)
    if (!__all_sync(0xffffffffu, al_a == 1.0f && al_b == 1.0f))
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j + 0] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }
    // p's accumulator fragments as the A fragments of the 4 k steps (keys
    // 8 kk .. 8 kk + 7 in load_v's order), split
    uint32_t ph[kKeyTile / 8][4], pl[kKeyTile / 8][4];
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 8; ++kk) {
      split(s[4 * kk + 0], ph[kk][0], pl[kk][0]);  // (g, t)
      split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);  // (g + 8, t)
      split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);  // (g, t + 4)
      split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);  // (g + 8, t + 4)
    }
    mbar_wait(sm.full_v(vr.stage), vr.phase);
    fold_pv(o, ph, pl, v_base + vr.stage * kStageBytes);
    release(sm.empty_v(vr.stage), lane);
    vr.advance<kVStages>();
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }

  // 8-byte stores of each lane's column pairs
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

}  // namespace tz_attn_f32
