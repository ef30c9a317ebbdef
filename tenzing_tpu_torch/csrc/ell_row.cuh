// One ELL row's sum, shared by ell_spmv.cu (tz_ell_spmv) and
// fused_region.cu (an ELL member of a fused region), so both kernels sum in
// one fixed order: entry j goes to partial sum j % kXBatch, and the kXBatch
// partials add up as a tree, so no term waits on a chain of w roundings and
// two launches agree bit for bit.  A thread issues its x gathers kXBatch at
// a time, before it uses the first.  The order's rounding bound,
// (ceil(w / kXBatch) + 3) 2^-24 sum_j |vals[j] x[cols[j]]| to first order,
// is ops/spmv_kernels.py row_sum_bound; tests/test_torch_spmv.py reads
// kXBatch from this file.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tz_ell {

constexpr int kXBatch = 8;  // x gathers a thread issues at once
static_assert((kXBatch & (kXBatch - 1)) == 0, "the partial sums add as a tree");

// A load from global memory: through L2 only (ld.global.cg) where an earlier
// part of the same launch wrote the buffer, through the read-only L1 path
// otherwise.
template <bool kCoherent, typename T>
__device__ __forceinline__ T ld(const T* p) {
  return kCoherent ? __ldcg(p) : __ldg(p);
}

// Where a row's vals and cols are read from: shared memory (a fused
// region's ring stage) or global memory, through L1 (kGlobal) or L2 only
// (kGlobalCg).
enum SlabSrc { kShared, kGlobal, kGlobalCg };

// sum_j v[j] x[c[j]] over the w entries of one row, in the fixed order; x
// through L2 only with kXCoherent.
template <int kSlab, bool kXCoherent>
__device__ __forceinline__ float row_sum(const float* v, const int* c,
                                         const float* __restrict__ x,
                                         int64_t w) {
  auto val = [&](int64_t j) {
    if constexpr (kSlab == kShared) return v[j];
    else return ld<kSlab == kGlobalCg>(v + j);
  };
  auto col = [&](int64_t j) {
    if constexpr (kSlab == kShared) return c[j];
    else return ld<kSlab == kGlobalCg>(c + j);
  };
  float acc[kXBatch];
#pragma unroll
  for (int u = 0; u < kXBatch; ++u) acc[u] = 0.0f;
  int64_t j = 0;
  for (; j + kXBatch <= w; j += kXBatch) {
    float xv[kXBatch];
#pragma unroll
    for (int u = 0; u < kXBatch; ++u) xv[u] = ld<kXCoherent>(x + col(j + u));
#pragma unroll
    for (int u = 0; u < kXBatch; ++u) acc[u] = fmaf(val(j + u), xv[u], acc[u]);
  }
#pragma unroll
  for (int u = 0; u < kXBatch; ++u)
    if (j + u < w) acc[u] = fmaf(val(j + u), ld<kXCoherent>(x + col(j + u)), acc[u]);
#pragma unroll
  for (int s = kXBatch / 2; s > 0; s /= 2)
#pragma unroll
    for (int u = 0; u < s; ++u) acc[u] += acc[u + s];
  return acc[0];
}

}  // namespace tz_ell
