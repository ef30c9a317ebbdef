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
// It copies bytes, so one kernel serves every dtype (float32 halo faces,
// bfloat16 MoE staging buffers).  Bound on an H100 SXM: data movement,
// 2 x nbytes (read once, write once) at 3.35 TB/s.  A grid-stride loop moves
// 16 bytes per thread per step (uint4), with a byte loop for the nbytes % 16
// tail; the caller guarantees 16-byte-aligned pointers.
//
// The simple first version: no TMA bulk copy, no cache hints.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // H100 SXM: 132 SMs

__global__ void device_copy_kernel(const unsigned char* __restrict__ src,
                                   unsigned char* __restrict__ dst,
                                   int64_t nbytes) {
  const int64_t n16 = nbytes >> 4;
  const uint4* __restrict__ s16 = reinterpret_cast<const uint4*>(src);
  uint4* __restrict__ d16 = reinterpret_cast<uint4*>(dst);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < n16; i += step) d16[i] = s16[i];
  for (int64_t i = (n16 << 4) + tid; i < nbytes; i += step) dst[i] = src[i];
}

}  // namespace

// Copy `nbytes` bytes on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tz_device_copy(const void* src, void* dst, int64_t nbytes,
                              void* stream) {
  int64_t blocks = ((nbytes >> 4) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  device_copy_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      nbytes);
  return (int)cudaGetLastError();
}
