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
// Layout: q (b, n, d), k/v (b, nkv, d), acc/m/l (b, n, d), all float32 with a
// contiguous last dim; batch and row strides are arguments, so a K/V block
// sliced from the resident K/V is read in place.  m and l are carried
// broadcast along d (the reference's layout): column 0 is read, every column
// is written.
//
// Two kernels, both one CTA per (tile of query rows, batch element) with the
// kv loop inside and the state (acc, m, l) in registers:
//
// * attn_fold_f32 (f32 inputs; simple first version on the SIMT units, no
//   TF32): 256 threads, 64 query rows per CTA, K and V streamed through one
//   shared 64-key tile, the state in registers.  Its body is
//   tz_attn_f32::fold_rows (attn_fold_f32.cuh), which the fused_region
//   kernel's attn_fold member runs too.  ~82 KB of dynamic shared memory at
//   d = 128: two CTAs per SM.
// * attn_fold_bf16 (bf16 inputs): 8 warps (128 query rows per CTA, so each
//   staged K/V tile serves twice the rows of the f32 kernel's), each owning
//   16 query rows, on the
//   tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).  q, k, v
//   are rounded to bf16 as they are staged into shared memory
//   (__float2bfloat16_rn; V transposed, key-contiguous, as the B operand of
//   the second product); the warp's Q fragments stay in registers; the S
//   accumulator fragments become the A fragments of P V in registers, with p
//   rounded to bf16 there — the reference's p.astype(v.dtype).  The state
//   stays f32.  ~70 KB of shared memory at d = 128.
//   The reference rounds p = exp(s - m') with m' the running max after the
//   whole kv block (bkv keys: all nkv for the block kernel, 1024 in the fused
//   one), so this kernel folds block by block in two passes over the block's
//   K tiles: the first finds the block's row max, the second forms p against
//   the final m' and folds it.  A one-pass online softmax over 64-key tiles
//   would round each p at the max seen so far instead and differ from the
//   reference by as much as leaving p unrounded.  The f32 kernel rounds
//   nothing, so its one pass is the same fold up to f32 summation order.
//
// Precision: expf (not __expf), no TF32.  m starts at -1e30 (the reference's
// init): alpha = expf(-1e30 - m') = 0, never NaN.  Masked query rows (ragged
// n) load zeros, stay finite and are never stored; masked key columns get
// s = -inf, so p = 0.
//
// Bound on an H100 SXM: operations, 4*b*n*nkv*d FLOP at 67 TFLOP/s for f32
// inputs (outside the tensor cores); with bf16 inputs the 989 TFLOP/s
// tensor-core rate or, for one 1024-key block, the bytes (q, the keys, acc
// and column 0 of m and l in, acc/m/l out, at 3.35 TB/s).  wgmma, TMA,
// cp.async pipelining and warp specialization are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fold_f32.cuh"

namespace {

// -- f32 inputs: SIMT (the body is tz_attn_f32::fold_rows) -------------------

constexpr int kKeys = tz_attn_f32::kKeys;  // keys per tile, both kernels

template <int kHeadDim>
__global__ void __launch_bounds__(tz_attn_f32::kThreads, 2)
attn_fold_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ acc,
              float* __restrict__ m, float* __restrict__ l,
              int64_t n, int64_t nkv,
              int64_t q_sb, int64_t q_sr, int64_t k_sb, int64_t k_sr,
              int64_t v_sb, int64_t v_sr, int64_t st_sb, int64_t st_sr,
              float scale) {
  extern __shared__ float smem[];
  const int64_t bi = blockIdx.y;
  tz_attn_f32::fold_rows<kHeadDim>(
      smem, q + bi * q_sb, k + bi * k_sb, v + bi * v_sb, acc + bi * st_sb,
      m + bi * st_sb, l + bi * st_sb, (int64_t)blockIdx.x * tz_attn_f32::kRows,
      n, nkv, q_sr, k_sr, v_sr, st_sr, scale);
}

// -- bf16 inputs: tensor cores (mma.sync) -------------------------------------

constexpr int kMmaWarps = 8;  // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per CTA
constexpr int kLdV = kKeys + 8;  // bf16 row pitch of the transposed V tile

template <int kHeadDim>
constexpr int mma_smem_bytes() {
  return ((kMmaRows + kKeys) * (kHeadDim + 8) + kHeadDim * kLdV) *
         (int)sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b for one m16n8k16 tile: a row-major 16x16, b "col" 16x8, f32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + kTileRows) of src (f32, row stride row_stride) as bf16
// pairs into dst (row pitch ld); rows past nrows are zero
template <int kHeadDim, int kTileRows>
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* __restrict__ dst,
                                                int ld,
                                                const float* __restrict__ src,
                                                int64_t row_stride,
                                                int64_t row0, int64_t nrows) {
  constexpr int kPairs = kHeadDim / 2;
  static_assert((kTileRows * kPairs) % kMmaThreads == 0, "tile split");
#pragma unroll 8
  for (int it = 0; it < kTileRows * kPairs / kMmaThreads; ++it) {
    const int e = threadIdx.x + it * kMmaThreads;
    const int r = e / kPairs;
    const int c = 2 * (e - r * kPairs);
    float x0 = 0.0f, x1 = 0.0f;
    if (row0 + r < nrows) {
      const float* p = src + (row0 + r) * row_stride + c;
      x0 = p[0];
      x1 = p[1];
    }
    *reinterpret_cast<uint32_t*>(dst + r * ld + c) = pack_bf16(x0, x1);
  }
}

template <int kHeadDim>
__global__ void __launch_bounds__(kMmaThreads)
attn_fold_bf16(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ acc,
               float* __restrict__ m, float* __restrict__ l,
               int64_t n, int64_t nkv, int64_t bkv,
               int64_t q_sb, int64_t q_sr, int64_t k_sb, int64_t k_sr,
               int64_t v_sb, int64_t v_sr, int64_t st_sb, int64_t st_sr,
               float scale) {
  constexpr int kLd = kHeadDim + 8;  // bf16 row pitch of the Q and K tiles
  constexpr int kKSteps = kHeadDim / 16;  // k steps of q k^T (over d)
  constexpr int kSTiles = kKeys / 8;      // n tiles of s (over keys)
  constexpr int kOTiles = kHeadDim / 8;   // n tiles of acc (over d)
  static_assert((kKeys / 2 * kHeadDim) % kMmaThreads == 0, "V tile split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kMmaRows][kLd]
  __nv_bfloat16* ks = qs + kMmaRows * kLd;                         // [kKeys][kLd]
  __nv_bfloat16* vts = ks + kKeys * kLd;                           // [d][kLdV]

  const int64_t bi = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  q += bi * q_sb;
  k += bi * k_sb;
  v += bi * v_sb;
  acc += bi * st_sb;
  m += bi * st_sb;
  l += bi * st_sb;

  stage_rows_bf16<kHeadDim, kMmaRows>(qs, kLd, q, q_sr, row0, n);
  __syncthreads();
  uint32_t qf[kKSteps][4];  // this warp's 16 rows of Q as A fragments
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const __nv_bfloat16* p = qs + (warp * 16 + g) * kLd + kk * 16 + 2 * t;
    qf[kk][0] = lds32(p);
    qf[kk][1] = lds32(p + 8 * kLd);
    qf[kk][2] = lds32(p + 8);
    qf[kk][3] = lds32(p + 8 * kLd + 8);
  }

  // the state of rows ra = row g and rb = row g + 8 of this warp
  const int64_t ra = row0 + warp * 16 + g;
  const int64_t rb = ra + 8;
  const bool la = ra < n, lb = rb < n;
  float m_a = la ? m[ra * st_sr] : 0.0f, m_b = lb ? m[rb * st_sr] : 0.0f;
  float l_a = la ? l[ra * st_sr] : 0.0f, l_b = lb ? l[rb * st_sr] : 0.0f;
  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int c = j * 8 + 2 * t;
    o[j][0] = la ? acc[ra * st_sr + c] : 0.0f;
    o[j][1] = la ? acc[ra * st_sr + c + 1] : 0.0f;
    o[j][2] = lb ? acc[rb * st_sr + c] : 0.0f;
    o[j][3] = lb ? acc[rb * st_sr + c + 1] : 0.0f;
  }

  // s = q k^T * scale for this warp's 16 rows x the 64 keys staged in ks;
  // keys at or past `end` get -inf
  auto scores = [&](float (&s)[kSTiles][4], int64_t kv0, int64_t end) {
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const __nv_bfloat16* p = ks + (j * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(s[j], qf[kk], lds32(p), lds32(p + 8));
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool valid = kv0 + j * 8 + 2 * t + c < end;
        s[j][c] = valid ? s[j][c] * scale : -INFINITY;
        s[j][2 + c] = valid ? s[j][2 + c] * scale : -INFINITY;
      }
    }
  };

  for (int64_t blk0 = 0; blk0 < nkv; blk0 += bkv) {
    const int64_t blk1 = blk0 + bkv < nkv ? blk0 + bkv : nkv;

    // pass 1: the block's row max; a row's 64 values sit in a quad
    float mx_a = -INFINITY, mx_b = -INFINITY;
    for (int64_t kv0 = blk0; kv0 < blk1; kv0 += kKeys) {
      __syncthreads();  // the previous tile's readers of ks and vts are done
      stage_rows_bf16<kHeadDim, kKeys>(ks, kLd, k, k_sr, kv0, blk1);
      __syncthreads();
      float s[kSTiles][4];
      scores(s, kv0, blk1);
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
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
    for (int j = 0; j < kOTiles; ++j) {
      o[j][0] *= al_a;
      o[j][1] *= al_a;
      o[j][2] *= al_b;
      o[j][3] *= al_b;
    }

    // pass 2: p = exp(s - m'), its row sum, and acc += p v
    float sum_a = 0.0f, sum_b = 0.0f;
    for (int64_t kv0 = blk0; kv0 < blk1; kv0 += kKeys) {
      __syncthreads();  // the previous tile's readers of ks and vts are done
      stage_rows_bf16<kHeadDim, kKeys>(ks, kLd, k, k_sr, kv0, blk1);
      // V transposed: vts[c][key] for a pair of keys per 32-bit store
#pragma unroll 8
      for (int it = 0; it < kKeys / 2 * kHeadDim / kMmaThreads; ++it) {
        const int e = threadIdx.x + it * kMmaThreads;
        const int kp = e / kHeadDim;
        const int c = e - kp * kHeadDim;
        const int64_t key = kv0 + 2 * kp;
        const float x0 = key < blk1 ? v[key * v_sr + c] : 0.0f;
        const float x1 = key + 1 < blk1 ? v[(key + 1) * v_sr + c] : 0.0f;
        *reinterpret_cast<uint32_t*>(vts + c * kLdV + 2 * kp) = pack_bf16(x0, x1);
      }
      __syncthreads();
      float s[kSTiles][4];
      scores(s, kv0, blk1);
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[j][c] = expf(s[j][c] - mn_a);
          s[j][2 + c] = expf(s[j][2 + c] - mn_b);
          sum_a += s[j][c];
          sum_b += s[j][2 + c];
        }
      }
      // the s fragments of keys 16 kk .. 16 kk + 15 are the A fragment of
      // step kk, p rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < kOTiles; ++j) {
          const __nv_bfloat16* p = vts + (j * 8 + g) * kLdV + kk * 16 + 2 * t;
          mma_bf16(o[j], pa, lds32(p), lds32(p + 8));
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
  }

#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int c = j * 8 + 2 * t;
    if (la) {
      acc[ra * st_sr + c] = o[j][0];
      acc[ra * st_sr + c + 1] = o[j][1];
      m[ra * st_sr + c] = m[ra * st_sr + c + 1] = m_a;
      l[ra * st_sr + c] = l[ra * st_sr + c + 1] = l_a;
    }
    if (lb) {
      acc[rb * st_sr + c] = o[j][2];
      acc[rb * st_sr + c + 1] = o[j][3];
      m[rb * st_sr + c] = m[rb * st_sr + c + 1] = m_b;
      l[rb * st_sr + c] = l[rb * st_sr + c + 1] = l_b;
    }
  }
}

// -- launch -----------------------------------------------------------------

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int rows, int threads, int bytes, bool& configured,
           int64_t b, int64_t n, cudaStream_t stream, Args... args) {
  if (!configured) {  // one attribute call per kernel
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((unsigned)((n + rows - 1) / rows), (unsigned)b);
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int kHeadDim>
int launch_d(bool bf16, const float* q, const float* k, const float* v,
             float* acc, float* m, float* l, int64_t b, int64_t n,
             int64_t nkv, int64_t bkv, int64_t q_sb, int64_t q_sr,
             int64_t k_sb, int64_t k_sr, int64_t v_sb, int64_t v_sr,
             int64_t st_sb, int64_t st_sr, float scale, cudaStream_t stream) {
  static bool f32_configured = false, bf16_configured = false;
  if (bf16)
    return launch(attn_fold_bf16<kHeadDim>, kMmaRows, kMmaThreads,
                  mma_smem_bytes<kHeadDim>(), bf16_configured, b, n, stream,
                  q, k, v, acc, m, l, n, nkv, bkv, q_sb, q_sr, k_sb, k_sr,
                  v_sb, v_sr, st_sb, st_sr, scale);
  return launch(attn_fold_f32<kHeadDim>, tz_attn_f32::kRows,
                tz_attn_f32::kThreads, tz_attn_f32::smem_bytes<kHeadDim>(),
                f32_configured, b, n, stream, q, k, v, acc, m, l, n, nkv,
                q_sb, q_sr, k_sb, k_sr, v_sb, v_sr, st_sb, st_sr, scale);
}

int dispatch(const float* q, const float* k, const float* v, float* acc,
             float* m, float* l, int64_t b, int64_t n, int64_t nkv,
             int64_t bkv, int64_t d, int64_t q_sb, int64_t q_sr, int64_t k_sb,
             int64_t k_sr, int64_t v_sb, int64_t v_sr, int64_t st_sb,
             int64_t st_sr, float scale, int64_t bf16, void* stream) {
  if (d != 128 || bkv < 1) return (int)cudaErrorInvalidValue;
  return launch_d<128>(bf16 != 0, q, k, v, acc, m, l, b, n, nkv, bkv, q_sb,
                       q_sr, k_sb, k_sr, v_sb, v_sr, st_sb, st_sr, scale,
                       (cudaStream_t)stream);
}

}  // namespace

// Fold one K/V block of nkv keys into (acc, m, l) on `stream`; returns the
// launch's cudaError_t (0 on success).  The caller checks dtypes, shapes,
// strides, d == 128 and b <= 65535 before calling.
extern "C" int tz_attn_block(const float* q, const float* k, const float* v,
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
extern "C" int tz_attn_fused(const float* q, const float* k, const float* v,
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
