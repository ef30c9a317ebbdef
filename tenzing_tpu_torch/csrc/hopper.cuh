// Hopper building blocks shared by the attention folds (attn_fold.cu,
// attn_fold_f32.cuh), the FFN bodies (ffn_tile.cuh, ffn_rows.cu), the halo
// kernels (halo_copy.cuh), the fused region's SpMV slab ring
// (fused_region.cu) and the mesh shift (rdma_shift.cu): driver entry points,
// tensor-map encoding, mbarriers, 1D bulk copies and 3D TMA boxes, the ring
// of shared-memory stages, wgmma's fences, its shared-memory matrix
// descriptor and its bf16 products (A from registers or from shared
// memory), and the split of a float32 operand into TF32 hi and lo parts with
// the 128-byte swizzle the split-TF32 bodies store them in.  Needs sm_90a.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// wgmma operand lists: the accumulator registers of an asm statement whose
// first outputs are d, and its "+f" / "=f" constraints.
#define TZ_REGS16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define TZ_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define TZ_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define TZ_REGS128                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "   \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "   \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "   \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "       \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "       \
  "%122, %123, %124, %125, %126, %127}"
#define TZ_ACC8(c, x, i)                                                  \
  c(x[i]), c(x[i + 1]), c(x[i + 2]), c(x[i + 3]), c(x[i + 4]), c(x[i + 5]), \
      c(x[i + 6]), c(x[i + 7])
#define TZ_ACC64(c, x)                                                    \
  TZ_ACC8(c, x, 0), TZ_ACC8(c, x, 8), TZ_ACC8(c, x, 16), TZ_ACC8(c, x, 24), \
      TZ_ACC8(c, x, 32), TZ_ACC8(c, x, 40), TZ_ACC8(c, x, 48),             \
      TZ_ACC8(c, x, 56)
#define TZ_ACC16(c, x) TZ_ACC8(c, x, 0), TZ_ACC8(c, x, 8)
#define TZ_ACC32(c, x) \
  TZ_ACC8(c, x, 0), TZ_ACC8(c, x, 8), TZ_ACC8(c, x, 16), TZ_ACC8(c, x, 24)
#define TZ_ACC128(c, x)                                                    \
  TZ_ACC64(c, x), TZ_ACC8(c, x, 64), TZ_ACC8(c, x, 72), TZ_ACC8(c, x, 80), \
      TZ_ACC8(c, x, 88), TZ_ACC8(c, x, 96), TZ_ACC8(c, x, 104),           \
      TZ_ACC8(c, x, 112), TZ_ACC8(c, x, 120)

namespace tz_hopper {

// -- host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The library links only the runtime, so a driver-API function is fetched
// through the runtime's entry-point query (its CUDA 12.0 form); nullptr
// when the driver has none of that name.
inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return p;
}

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr)
    fn = reinterpret_cast<EncodeTiledFn>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

// Two floats rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// One box of a 3D tensor map into shared memory at coordinates (c0, c1,
// c2), innermost first; completes its bytes on `bar` (one thread issues).
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
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
// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the wgmma fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// -- wgmma, bf16 in, f32 accumulate (m64nNk16)
//
// kTransB = 0 reads b K-major (its rows are the N index, K contiguous), 1
// MN-major (its rows are the K index, N contiguous): the transpose bit, so
// a row-major K x N operand needs no transpose.  A 128-byte-swizzled
// MN-major b of 64-column boxes [K rows][64] advances 16 rows (2048 bytes)
// a k step, the next 8 rows are SBO = 1024 bytes on and the next 64
// columns LBO = one box on; a K-major one advances 32 bytes a k step, the
// next 8 rows 1024 bytes on.

// d (+)= a b for a 64 x 128 x 16 step: a (64 x 16) from registers in the
// m16n8k16 A-fragment layout of each warp's 16 rows, b (16 x 128) from
// shared memory through `desc`.  kAccumulate = false overwrites d.
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

// d += a b for a 64 x kN x 16 step (kN 64, 128 or 256), both operands from
// shared memory: a (64 x 16) K-major through `da`, b (16 x kN) through
// `db`.  Always accumulates: the caller zeroes d first.
template <int kN, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[kN / 2], uint64_t da,
                                         uint64_t db) {
  static_assert(kN == 64 || kN == 128 || kN == 256, "wgmma_ss: N");
  if constexpr (kN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TZ_REGS32
        ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : TZ_ACC32("+f", d)
        : "l"(da), "l"(db), "r"(1), "n"(kTransB));
  } else if constexpr (kN == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TZ_REGS64
        ", %64, %65, p, 1, 1, 0, %67;\n}\n"
        : TZ_ACC64("+f", d)
        : "l"(da), "l"(db), "r"(1), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " TZ_REGS128
        ", %128, %129, p, 1, 1, 0, %131;\n}\n"
        : TZ_ACC128("+f", d)
        : "l"(da), "l"(db), "r"(1), "n"(kTransB));
  }
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
