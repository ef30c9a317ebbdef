// ffn_rows: the gelu MLP of one token matrix,
//   y = gelu_tanh(x @ W1) @ W2
// for x (n, d), W1 (d, dff), W2 (dff, d), y (n, d), all float32 or all bf16,
// any n.
//
// Replaces the TPU kernel ffn_pallas (tenzing_tpu/ops/ffn_pallas.py:43, body
// _ffn_kernel at :32), the .pallas expert slot of the expert-parallel MoE
// layer (models/moe.py ExpertFFNPallas).  The TPU kernel runs one program per
// 512-row tile of x with both weight matrices whole in VMEM, and pads a
// ragged n up to the tile.  On Hopper neither weight matrix fits a block's
// shared memory (4 MB each in f32 at d=512, dff=2048), so the weights stream
// through shared memory in chunks of the depth; a ragged n is masked in the
// kernel, with no padding copy.
//
// float32 (tz_ffn_rows).  Bound on an H100 SXM at the slice's shape (one chunk of the layer at world
// size 1: n=2048, d=512, dff=2048): operations.  4*n*d*dff = 8.59 GFLOP as
// three TF32 products (the split) at 495 TFLOP/s is ~52 us (~128 us at the
// 67 TFLOP/s f32 peak outside the tensor cores); the bytes (x, W1, W2 and y
// once: 16.8 MB) take ~5 us at 3.35 TB/s.
//
// Design: ffn_tile.cuh's split-TF32 wgmma body at one expert, the
// arithmetic of ffn_expert.cu's kernel, through the caller's workspace h
// (n, dff).  At n=2048 the first launch is 16 row tiles x 16 column tiles
// (256 CTAs), the second 64 tiles split 2 ways over the hidden dimension.
//
// bf16 (tz_ffn_rows_bf16): x, W1, W2 and y in bf16, as the reference's
// _ffn_kernel computes them for a bf16 x: both products accumulate in f32,
// h = gelu_tanh(x @ W1) is rounded to bf16 between them, and y is rounded
// to bf16 when it is written.
//
// Bound at the slice's shape (n=2048, d=512, dff=2048): operations.
// 4*n*d*dff = 8.59 GFLOP at the 989 TFLOP/s bf16 tensor-core peak is 8.69 us;
// the bytes (x, W1, W2 and y once in bf16: 8.4 MB) take 2.5 us at 3.35 TB/s.
//
// Design: two launches of one bf16 GEMM body, as the f32 body (at d = 512 a
// CTA cannot hold a whole row tile of y in registers and still fill the
// SMs), through the caller's bf16 workspace h (n, dff): 8 MB at n = 2048,
// written by the first launch and read by the second mostly from L2.
//   * bf16 wgmma (m64nNk16, f32 accumulate) with both operands in shared
//     memory.  The ring holds kBStages stages of one 64-deep chunk: A's 128
//     rows (16 KB, K-major) and B's 64 rows of the tile's columns in
//     64-column boxes.  TMA fills both 128-byte swizzled, in the layout the
//     descriptors name; B = W1 or W2 goes in as it stands and is read
//     MN-major through wgmma's transpose bit (no transpose, no staging
//     pass).  Full / empty mbarriers; one producer thread issues every box;
//     two consumer warpgroups of 64 rows keep one chunk's products in
//     flight while they release the stage before it.  setmaxnreg gives the
//     consumers 232 registers (a 64 x 256 f32 sum is 128) and the producer
//     warpgroup 40, of the 168 a thread the 384-thread CTA holds.
//   * Tiles: 128 rows x kCols1 columns for the first product (x @ W1, K =
//     512), 128 x kCols2 for the second (h @ W2, K = dff).  At the slice's
//     shape kCols1 = 256 gives 128 CTAs, one wave on 132 SMs; the second
//     product's 64 tiles of 128 x 128 split their depth 2 ways over a
//     cluster (ffn_tile.cuh split_k and its fixed-order DSMEM sum), 128
//     CTAs.  That read 37.6-38.5 us for the call against 41.2-42.1 with
//     128 unsplit tiles of 128 x 64 (bench/ffn_bf16.py, H100 80GB HBM3,
//     700 W); tz_ffn_rows_bf16_ex runs any pair of 64, 128 and 256, and the
//     bench times the others beside the kernel's.
//   * Epilogue (ffn_tile.cuh store_partial / sum_store): the f32 sums into
//     shared memory, then the gelu in f32 (ffn_tile.cuh gelu_exp, the tanh
//     form written through exp) and the bf16 rounding (first launch: where
//     the reference rounds h), 8-byte stores.  The epilogue is the largest
//     part after the products: without it the call read 27.7-28.5 us
//     against 37.2-38.3 (bench/ffn_bf16.py --ablate, no-epilogue).
//     Starting the second launch early (programmatic dependent launch,
//     griddepcontrol) trapped on back-to-back calls and is not used.
// Ragged n, dff (a multiple of 8, for 16-byte rows) and K are masked in the
// kernel: TMA boxes past an edge read zeros (gelu(0) = 0, zero rows of W2
// add nothing), and masked rows and columns are never stored.  Nothing is
// padded in device memory.  Every box starts on a multiple of 64 elements
// (128 bytes) in its innermost dimension.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_tile.cuh"

namespace {

using namespace tz_ffn;

__global__ void __launch_bounds__(kThreads, 1)
ffn_rows_kernel(const __grid_constant__ Gemm g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gemm_cta(g, smem_raw);
}

// -- bf16 ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBRows = 128;       // output rows per CTA: two warpgroups of 64
constexpr int kBDepth = 64;       // K per stage: one 128-byte row of A
constexpr int kBBox = 64;         // B columns per TMA box (one 128-byte row)
constexpr int kBStages = 4;
constexpr int kBConsumers = 2;
constexpr int kBThreads = 128 * (kBConsumers + 1);  // + the producer warpgroup
constexpr int kBConsumerWarps = 4 * kBConsumers;    // arrivals that free a stage
constexpr int kBABytes = kBRows * kBDepth * 2;       // A's chunk, [128][64]
constexpr int kBLaunchRegs = 168;  // 65,536 / 384, rounded down to 8
constexpr int kBProducerRegs = 40;
constexpr int kBConsumerRegs = 232;
constexpr int kCols1 = 256;  // the first product's tile columns (x @ W1)
constexpr int kCols2 = 128;  // the second's (h @ W2)
static_assert(kBProducerRegs * 128 + kBConsumerRegs * 128 * kBConsumers <=
                  kBLaunchRegs * kBThreads,
              "register budget");
static_assert(2 * kBStages * 8 <= kBarrierBytes, "barriers");
static_assert(kBConsumers == kConsumers, "consumer_sync counts two warpgroups");

template <int kN>
struct BTile {
  static constexpr int kStageBytes = kBABytes + kBDepth * kN * 2;
  static constexpr int kPitch = kN + 8;  // floats a row of the partial sum
  static constexpr int kSmemBytes =
      kAlignBytes + kBStages * kStageBytes + kBarrierBytes;
  static_assert(kBRows * kPitch * 4 <= kBStages * kStageBytes,
                "the partial sum reuses the ring");
  static_assert(kSmemBytes <= 232448, "one block's shared memory");
  static constexpr Body kBody = {kBRows, kN, kBDepth, kBBox, kBThreads,
                                 kSmemBytes};
};

// The producer thread: chunks [kc0, kc1) of A's rows [row0, row0 + 128) and
// B's columns [col0, col0 + kN) into the ring.
template <int kN>
__device__ __forceinline__ void produce_bf16(const GemmT<bf16>& g,
                                             unsigned char* ring, uint64_t* full,
                                             uint64_t* empty, const TilePos& p) {
  Ring r;
  for (int kc = p.kc0; kc < p.kc1; ++kc) {
    mbar_wait(&empty[r.stage], r.phase ^ 1u);
    unsigned char* st = ring + r.stage * BTile<kN>::kStageBytes;
    mbar_expect_tx(&full[r.stage], BTile<kN>::kStageBytes);
    tma_box(st, &g.a_map, &full[r.stage], kc * kBDepth, p.row0, p.e);
#pragma unroll
    for (int j = 0; j < kN / kBBox; ++j)
      tma_box(st + kBABytes + j * (kBDepth * kBBox * 2), &g.b_map,
              &full[r.stage], p.col0 + j * kBBox, kc * kBDepth, p.e);
    r.advance<kBStages>();
  }
}

// Consumer warpgroup wg: the sum of chunks [kc0, kc1) for its 64 rows x kN
// in acc (the m64nN accumulator layout).  A chunk's four k steps are one
// wgmma group; the stage of chunk kc - 1 is released once only chunk kc's
// group is still in flight.
template <int kN>
__device__ __forceinline__ void consume_bf16(float (&acc)[kN / 2], bool active,
                                             int kc0, int kc1, uint32_t ring,
                                             uint64_t* full, uint64_t* empty,
                                             int wg, int lane) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.0f;
  Ring r, prev;
  for (int kc = kc0; kc < kc1; ++kc) {
    mbar_wait(&full[r.stage], r.phase);
    if (active) {
      const uint32_t st = ring + r.stage * BTile<kN>::kStageBytes;
      const uint32_t a = st + wg * (kBABytes / kBConsumers);
      const uint32_t b = st + kBABytes;
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBDepth / 16; ++kk)
        wgmma_ss<kN, 1>(acc, desc_sw128(a + kk * 32, 16, 1024),
                        desc_sw128(b + kk * 2048, kBDepth * kBBox * 2, 1024));
      wg_commit();
      wg_wait<1>();
      fence_regs(acc);
      if (kc > kc0) release(&empty[prev.stage], lane);
    } else {
      release(&empty[r.stage], lane);
    }
    prev = r;
    r.advance<kBStages>();
  }
  if (active) {
    wg_wait_all();
    fence_regs(acc);
    if (kc1 > kc0) release(&empty[prev.stage], lane);
  }
}

// One CTA of a bf16 launch with tiles of 128 x kN (blockIdx.x as gemm_cta's).
template <int kN>
__global__ void __launch_bounds__(kBThreads, 1)
ffn_rows_bf16_kernel(const __grid_constant__ GemmT<bf16> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  unsigned char* base =
      smem_raw + ((kAlignBytes - (smem_u32(smem_raw) & (kAlignBytes - 1))) &
                  (kAlignBytes - 1));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + kBStages * BTile<kN>::kStageBytes);
  uint64_t* empty = full + kBStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const TilePos p = tile_pos<kBRows, kN, kBDepth>(g);
  float* part = reinterpret_cast<float*>(base);  // the partial, over the ring
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == kBConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kBProducerRegs));
    if (t == 0) produce_bf16<kN>(g, base, full, empty, p);
    __syncwarp();  // converged again for the aligned setmaxnreg
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kBLaunchRegs));
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kBConsumerRegs));
    const bool active = p.row0 + 64 * wg < g.m;
    float acc[kN / 2];
    consume_bf16<kN>(acc, active, p.kc0, p.kc1, smem_u32(base), full, empty, wg,
                     t % 32);
    // both warpgroups' products have read their last stage, and every TMA
    // box has landed: the ring is free for the partial sum
    consumer_sync();
    if (active) store_partial<kN, BTile<kN>::kPitch>(part, acc, wg, t);
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kBLaunchRegs));
  }
  cluster.sync();  // every partial of the tile written and visible
  sum_store<kBRows, kN, BTile<kN>::kPitch, kBThreads>(g, cluster, part, p);
}

const Body* bf16_body(int64_t cols) {
  switch (cols) {
    case 64: return &BTile<64>::kBody;
    case 128: return &BTile<128>::kBody;
    case 256: return &BTile<256>::kBody;
    default: return nullptr;
  }
}

int launch_bf16(const GemmT<bf16>& g, int64_t cols, cudaStream_t stream) {
  switch (cols) {
    case 64:
      return (int)launch_gemm(ffn_rows_bf16_kernel<64>, g, 1, stream,
                              BTile<64>::kBody);
    case 128:
      return (int)launch_gemm(ffn_rows_bf16_kernel<128>, g, 1, stream,
                              BTile<128>::kBody);
    case 256:
      return (int)launch_gemm(ffn_rows_bf16_kernel<256>, g, 1, stream,
                              BTile<256>::kBody);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// y = gelu_tanh(x @ W1) @ W2 in bf16 through h, the first product in tiles
// of 128 x cols1, the second 128 x cols2.
int run_bf16(const bf16* x, const bf16* w1, const bf16* w2, bf16* y, bf16* h,
             int64_t n, int64_t dff, int64_t cols1, int64_t cols2,
             cudaStream_t stream) {
  const Body* b1 = bf16_body(cols1);
  const Body* b2 = bf16_body(cols2);
  if (b1 == nullptr || b2 == nullptr) return (int)cudaErrorInvalidValue;
  GemmT<bf16> g1 = {}, g2 = {};
  int err = gemm(g1, x, w1, h, 1, n, dff, kD, 1, *b1);
  if (err == 0) err = gemm(g2, h, w2, y, 1, n, kD, dff, 0, *b2);
  if (err == 0) err = launch_bf16(g1, cols1, stream);
  if (err == 0) err = launch_bf16(g2, cols2, stream);
  return err;
}

}  // namespace

// bf16: launch on `stream`; returns the launches' first CUDA error (0 on
// success).  d must be 512 and dff a multiple of 8; h is a (n, dff) bf16
// workspace; pointers 16-byte aligned (the wrapper checks).
extern "C" int tz_ffn_rows_bf16(const void* x, const void* w1, const void* w2,
                                void* y, void* h, int64_t n, int64_t d,
                                int64_t dff, void* stream) {
  if (d != kD || n < 1 || n > 0x7fffffff || dff < 8 || dff % 8 != 0 ||
      dff > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return run_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                  static_cast<const bf16*>(w2), static_cast<bf16*>(y),
                  static_cast<bf16*>(h), n, dff, kCols1, kCols2,
                  (cudaStream_t)stream);
}

// The same with the two launches' tile columns given (64, 128 or 256 each):
// the variants bench/ffn_bf16.py times beside the kernel's own pair.
extern "C" int tz_ffn_rows_bf16_ex(const void* x, const void* w1,
                                   const void* w2, void* y, void* h, int64_t n,
                                   int64_t d, int64_t dff, int64_t cols1,
                                   int64_t cols2, void* stream) {
  if (d != kD || n < 1 || n > 0x7fffffff || dff < 8 || dff % 8 != 0 ||
      dff > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return run_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                  static_cast<const bf16*>(w2), static_cast<bf16*>(y),
                  static_cast<bf16*>(h), n, dff, cols1, cols2,
                  (cudaStream_t)stream);
}

// The bf16 body's launch constants, in order: rows per CTA, the first and
// the second launch's columns per CTA, chunk depth, stages, threads, the
// two launches' shared-memory bytes, the largest split.
extern "C" int tz_ffn_bf16_config(int64_t* out) {
  out[0] = kBRows;
  out[1] = kCols1;
  out[2] = kCols2;
  out[3] = kBDepth;
  out[4] = kBStages;
  out[5] = kBThreads;
  out[6] = BTile<kCols1>::kSmemBytes;
  out[7] = BTile<kCols2>::kSmemBytes;
  out[8] = kMaxSplits;
  return 0;
}

// The tiling of one bf16 launch with tiles of 128 x cols for (m, n, k) on
// `sms` SMs: out = row tiles, column tiles, splits, chunks per split, CTAs.
extern "C" int tz_ffn_bf16_plan(int64_t m, int64_t n, int64_t k, int64_t cols,
                                int64_t sms, int64_t* out) {
  const Body* body = bf16_body(cols);
  if (body == nullptr) return (int)cudaErrorInvalidValue;
  GemmT<bf16> g = {};
  g.m = (int)m;
  g.n = (int)n;
  g.k = (int)k;
  const int64_t blocks = plan(g, 1, (int)sms, *body);
  out[0] = g.m_tiles;
  out[1] = g.n_tiles;
  out[2] = g.splits;
  out[3] = g.chunks_per_split;
  out[4] = blocks;
  return 0;
}

// Launch on `stream`; returns the launches' first CUDA error (0 on
// success).  d must be 512 and dff a multiple of 4; h is a (n, dff) float32
// workspace; pointers 16-byte aligned (the wrapper checks).
extern "C" int tz_ffn_rows(const float* x, const float* w1, const float* w2,
                           float* y, float* h, int64_t n, int64_t d,
                           int64_t dff, void* stream) {
  if (d != kD || n < 1 || n > 0x7fffffff || dff < 4 || dff % 4 != 0 ||
      dff > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return run_ffn(ffn_rows_kernel, x, w1, w2, y, h, 1, n, dff,
                 (cudaStream_t)stream);
}
