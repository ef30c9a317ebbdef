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
// 2 x nbytes (read once, write once) at 3.35 TB/s.  The caller guarantees
// 16-byte-aligned pointers.  A persistent grid of a few blocks per SM, each
// thread holding kUnroll independent 16-byte loads in flight (ld.global.cs,
// streaming: the source is read once) before it stores them, so the bytes in
// flight, not the thread count, set the rate; block 0 copies the nbytes % 16
// tail a byte a thread.  (A ring of 1D bulk copies through shared memory
// read the same; bench/device_copy.py builds it as a variant.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSms = 132;  // H100 SXM: the persistent grid's SM count
constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kBlocksPerSm = 4;

__global__ void __launch_bounds__(kThreads)
    device_copy_kernel(const unsigned char* __restrict__ src,
                       unsigned char* __restrict__ dst, int64_t nbytes) {
  const int64_t n16 = nbytes >> 4;
  const uint4* __restrict__ s16 = reinterpret_cast<const uint4*>(src);
  uint4* __restrict__ d16 = reinterpret_cast<uint4*>(dst);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * step < n16; i += kUnroll * step) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldcs(s16 + i + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d16[i + u * step] = r[u];
  }
  for (; i < n16; i += step) d16[i] = __ldcs(s16 + i);
  const int64_t tail = (n16 << 4) + threadIdx.x;
  if (blockIdx.x == 0 && tail < nbytes) dst[tail] = src[tail];
}

}  // namespace

// Copy `nbytes` bytes on `stream`; returns cudaGetLastError() (0 on
// success).  No device or occupancy query: the grid is fixed by the card's
// SM count.
extern "C" int tz_device_copy(const void* src, void* dst, int64_t nbytes,
                              void* stream) {
  if (nbytes < 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = ((nbytes >> 4) + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks > kSms * kBlocksPerSm) blocks = kSms * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  device_copy_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      nbytes);
  return (int)cudaGetLastError();
}
