// rdma_shift: the neighbour shift over a mesh axis, written by each rank's
// kernels straight into the +shift neighbour's receive buffer.
//
// Replaces the TPU kernels of tenzing_tpu/ops/rdma.py: rdma_shift_fused (:101,
// body _shift_fused_kernel at :84) and the split pair rdma_shift_post (:189,
// body _shift_post_kernel at :162) / rdma_shift_wait (:225, body
// _shift_wait_kernel at :178), the .rdma engine of the mesh halo exchange.
// On the TPU the post signals a barrier semaphore on both neighbours, waits
// for both, and starts a remote DMA of the local block into the +shift
// neighbour's output; the wait blocks on the DMA's send and receive
// semaphores.
//
// On CUDA the neighbours are other processes (one per rank).  Each rank
// exports its receive buffer and a block of flag words through CUDA IPC
// (cudaIpcGetMemHandle); each opens its neighbours' (cudaIpcOpenMemHandle)
// and passes the mapped pointers here.  On one card two processes map each
// other's memory the same way, with the kernels of the two contexts
// time-sliced.  Per collective id (one per halo direction, so six
// concurrent exchanges never read each other's flags) a rank's flag block
// holds three 64-bit words:
//   kFromBwd  the -shift neighbour entered its post of epoch e,
//   kFromFwd  the +shift neighbour entered its post of epoch e,
//   kArrival  the -shift neighbour's block has landed in my receive buffer.
// Epochs count each rank's posts per id, so they rise on every rank alike
// and a run never resets a flag.
//
// Post (tz_rdma_shift_post, on the direction's transfer stream), three
// launches in stream order:
//   1. barrier: one thread release-stores epoch e into the +shift
//      neighbour's kFromBwd and the -shift neighbour's kFromFwd, then spins
//      (acquire loads) until its own kFromBwd and kFromFwd reach e.  The
//      caller makes the transfer stream wait on this rank's earlier readers
//      of its own receive buffer first, so a neighbour's signal means its
//      receive buffer may be overwritten;
//   2. copy: a grid-stride copy of x into the neighbour's receive buffer
//      through the mapped pointer, 16 bytes a thread;
//   3. arrive: one thread, after the copy kernel in stream order, fences
//      (__threadfence_system) and release-stores e into the neighbour's
//      kArrival.
// Wait (tz_rdma_shift_wait, on the same stream at the await): one thread
// spins until its own kArrival reaches e.  The stream order behind the post
// also covers the send half (the copy out of x has finished).
//
// No hang: every spin reads the global nanosecond timer and gives up after
// kTimeoutNs.  It then writes an error code into a word of pinned host
// memory and traps; the context's sticky error makes the host's next
// synchronize raise, and the wrapper reports the code (ops/rdma.py).
//
// Bound: the bytes.  A face of the flagship halo (3 x 3 x 512 x 512 f32,
// 9.4 MB) is read once and written once: 18.9 MB at 3.35 TB/s, 5.6 us.
// Between two processes on one card the barrier waits for the other
// context's time slice, which no bound counts; over NVLink between cards
// the write would run at NVLink's rate instead.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kSlots = 4;  // words per collective id (the 4th pads to 32 B)
constexpr int kFromBwd = 0;
constexpr int kFromFwd = 1;
constexpr int kArrival = 2;
constexpr unsigned long long kTimeoutNs = 10ull * 1000ull * 1000ull * 1000ull;
constexpr int kCopyThreads = 256;

// error codes written into the host word before the trap
constexpr int kErrBarrier = 1;
constexpr int kErrArrival = 2;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release(long long* p, long long v) {
  asm volatile("st.release.sys.global.s64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ long long load_acquire(const long long* p) {
  long long v;
  asm volatile("ld.acquire.sys.global.s64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __noinline__ void fail(int* err, int code) {
  *reinterpret_cast<volatile int*>(err) = code;
  __threadfence_system();
  __trap();
}

__global__ void shift_barrier_kernel(long long* mine, long long* fwd,
                                     long long* bwd, int cid, long long epoch,
                                     int* err) {
  if (threadIdx.x != 0) return;
  store_release(fwd + cid * kSlots + kFromBwd, epoch);
  store_release(bwd + cid * kSlots + kFromFwd, epoch);
  const unsigned long long deadline = now_ns() + kTimeoutNs;
  while (load_acquire(mine + cid * kSlots + kFromBwd) < epoch ||
         load_acquire(mine + cid * kSlots + kFromFwd) < epoch) {
    if (now_ns() > deadline) fail(err, kErrBarrier);
    __nanosleep(256);
  }
}

__global__ void shift_copy_kernel(const uint4* __restrict__ src,
                                  uint4* __restrict__ dst, int64_t n16,
                                  const unsigned char* __restrict__ src_tail,
                                  unsigned char* __restrict__ dst_tail,
                                  int tail) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += stride)
    dst[i] = src[i];
  if (blockIdx.x == 0 && threadIdx.x < tail)
    dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

__global__ void shift_arrive_kernel(long long* fwd, int cid, long long epoch) {
  if (threadIdx.x != 0) return;
  __threadfence_system();
  store_release(fwd + cid * kSlots + kArrival, epoch);
}

__global__ void shift_wait_kernel(const long long* mine, int cid,
                                  long long epoch, int* err) {
  if (threadIdx.x != 0) return;
  const unsigned long long deadline = now_ns() + kTimeoutNs;
  while (load_acquire(mine + cid * kSlots + kArrival) < epoch) {
    if (now_ns() > deadline) fail(err, kErrArrival);
    __nanosleep(256);
  }
}

int copy_blocks(int64_t n16) {
  int64_t blocks = (n16 + kCopyThreads - 1) / kCopyThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;  // 8 blocks per SM, grid-stride
  return (int)blocks;
}

}  // namespace

// Words of one rank's flag block per collective id.
extern "C" int64_t tz_rdma_shift_slots() { return kSlots; }

// The barrier alone (step 1 of the post), for timing it by itself.
extern "C" int tz_rdma_shift_barrier(long long* mine, long long* fwd,
                                     long long* bwd, int64_t cid,
                                     int64_t epoch, int* err, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  shift_barrier_kernel<<<1, 32, 0, s>>>(mine, fwd, bwd, (int)cid, epoch, err);
  return (int)cudaGetLastError();
}

// Post: barrier, copy of `nbytes` from x into the neighbour's receive buffer
// `peer_y`, arrival signal; all on `stream`.  x and peer_y 16-byte aligned
// (the wrapper checks).
extern "C" int tz_rdma_shift_post(const void* x, void* peer_y, int64_t nbytes,
                                  long long* mine, long long* fwd,
                                  long long* bwd, int64_t cid, int64_t epoch,
                                  int* err, void* stream) {
  if (nbytes < 0 || cid < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  shift_barrier_kernel<<<1, 32, 0, s>>>(mine, fwd, bwd, (int)cid, epoch, err);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t n16 = nbytes / 16;
  const int tail = (int)(nbytes % 16);
  if (nbytes > 0) {
    const unsigned char* sb = static_cast<const unsigned char*>(x);
    unsigned char* db = static_cast<unsigned char*>(peer_y);
    shift_copy_kernel<<<copy_blocks(n16), kCopyThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(peer_y), n16,
        sb + n16 * 16, db + n16 * 16, tail);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  shift_arrive_kernel<<<1, 32, 0, s>>>(fwd, (int)cid, epoch);
  return (int)cudaGetLastError();
}

// Wait: spin on this rank's arrival word for `epoch` on `stream`.
extern "C" int tz_rdma_shift_wait(const long long* mine, int64_t cid,
                                  int64_t epoch, int* err, void* stream) {
  shift_wait_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(mine, (int)cid, epoch,
                                                        err);
  return (int)cudaGetLastError();
}

// -- CUDA IPC: the peer-memory handles --------------------------------------

// The 64-byte IPC handle of the allocation that starts at `base`.
extern "C" int tz_ipc_get_handle(void* base, void* handle_out) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaIpcGetMemHandle(&h, base);
  if (e != cudaSuccess) return (int)e;
  memcpy(handle_out, &h, sizeof(h));
  return 0;
}

// Map another process's allocation; its base lands in *ptr_out.
extern "C" int tz_ipc_open(const void* handle, void** ptr_out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr_out, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int tz_ipc_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int64_t tz_ipc_handle_size() {
  return (int64_t)sizeof(cudaIpcMemHandle_t);
}
