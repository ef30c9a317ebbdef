// device_copy: device-to-device copy of a staging buffer, the transfer of the
// .rdma engine.
//
// Replaces the TPU kernels rdma_copy_fused_local (tenzing_tpu/ops/rdma.py:138)
// and the split loopback post/wait rdma_shift_post (:189) / rdma_shift_wait
// (:225), reached through rdma_start_loopback (:248) and rdma_wait_loopback
// (:256).  On one TPU chip these are a DMA-engine copy whose post and wait are
// separate kernels exchanging semaphores.  Here the post is this kernel's
// launch on the direction's transfer stream plus an event record, and the
// wait is that event (runtime/executor.py), so no wait kernel exists.
//
// Bound on an H100 SXM: data movement, 2 x n*4 bytes (read once, write once)
// at 3.35 TB/s.  A grid-stride loop moves 16 bytes per thread per step
// (float4), with a scalar loop for the n % 4 tail; the caller guarantees
// 16-byte-aligned pointers.
//
// The simple first version: no TMA bulk copy, no cache hints.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // H100 SXM: 132 SMs

__global__ void device_copy_kernel(const float* __restrict__ src,
                                   float* __restrict__ dst, int64_t n) {
  const int64_t n4 = n >> 2;
  const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src);
  float4* __restrict__ d4 = reinterpret_cast<float4*>(dst);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < n4; i += step) d4[i] = s4[i];
  for (int64_t i = (n4 << 2) + tid; i < n; i += step) dst[i] = src[i];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tz_device_copy(const float* src, float* dst, int64_t n,
                              void* stream) {
  int64_t blocks = ((n >> 2) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  device_copy_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      src, dst, n);
  return (int)cudaGetLastError();
}
