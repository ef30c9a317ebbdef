// Hopper building blocks shared by the attention folds (attn_fold.cu,
// attn_fold_f32.cuh), the f32 FFN (ffn_tile.cuh), the halo kernels
// (halo_copy.cuh) and the fused region's SpMV slab ring (fused_region.cu):
// tensor-map encoding, mbarriers, 1D bulk copies, the ring of shared-memory
// stages, wgmma's fences and its shared-memory matrix descriptor, and the
// split of a float32 operand into TF32 hi and lo parts with the 128-byte
// swizzle the split-TF32 bodies store them in.  Needs sm_90a.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tz_hopper {

// -- host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the library links only
// the runtime, so it is fetched through the runtime's entry-point query.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// (The barrier functions take a barrier's pointer or its shared-memory
// address.)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  mbar_arrive(smem_u32(bar));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed; trap after ~2^32
// cycles instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 32)) {
      __trap();
    }
  }
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// Make freshly initialized barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's plain shared-memory writes before later reads of the
// async proxy (wgmma) that a barrier hands them to.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Order generic-proxy writes to global memory (by any thread, ordered before
// this one by a barrier) before this thread's later bulk copies read it.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// -- 1D bulk copies (no tensor map).  Both addresses 16-byte aligned, the
// size a multiple of 16.

// global -> shared; completes `bytes` of `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A position in a ring of kStages stages: the stage and the parity of its
// current phase.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int kStages>
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// A consumer warp is done reading a stage.
__device__ __forceinline__ void release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  release(smem_u32(empty), lane);
}

// -- wgmma

// Shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the wgmma fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// -- split-TF32: a float32 operand as the sum of two TF32 values

// x = hi + lo, each rounded to TF32 (10 mantissa bits) to nearest with
// ties away from zero, as cvt.rna.tf32.f32 rounds.  hi on the integer
// units: half of the 13 dropped bits added to the magnitude, then cleared;
// for every finite x and every infinity this is the conversion's result,
// but the carry turns a NaN with its top mantissa bits set (0x7FFFFFFF, the
// card's canonical NaN) into a zero.  lo through the conversion, which
// keeps a NaN: x - hi is NaN for a NaN x, so lo carries it into the hi lo
// and lo hi products and the result is NaN, as in f32.  Both through the
// conversion read 5% slower in the f32 FFN body, both on the integer units
// with a select for non-finite values 10% slower, and this as fast as the
// integer rounding of both without it (bench/ffn_f32.py --ablate: cvt-split,
// select-split, unsafe-split).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(__fsub_rn(x, __uint_as_float(hi))));
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled
// region whose rows are 128 bytes (the region 1024-byte aligned).
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

}  // namespace tz_hopper

// wgmma operand lists: the accumulator registers of an asm statement whose
// first outputs are d, and its "+f" / "=f" constraints.
#define TZ_REGS16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define TZ_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define TZ_ACC8(c, x, i)                                                  \
  c(x[i]), c(x[i + 1]), c(x[i + 2]), c(x[i + 3]), c(x[i + 4]), c(x[i + 5]), \
      c(x[i + 6]), c(x[i + 7])
#define TZ_ACC64(c, x)                                                    \
  TZ_ACC8(c, x, 0), TZ_ACC8(c, x, 8), TZ_ACC8(c, x, 16), TZ_ACC8(c, x, 24), \
      TZ_ACC8(c, x, 32), TZ_ACC8(c, x, 40), TZ_ACC8(c, x, 48),             \
      TZ_ACC8(c, x, 56)
#define TZ_ACC16(c, x) TZ_ACC8(c, x, 0), TZ_ACC8(c, x, 8)

