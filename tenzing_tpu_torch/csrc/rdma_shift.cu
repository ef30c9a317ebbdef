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
// Post (tz_rdma_shift_post, on the direction's transfer stream), in stream
// order:
//   1. barrier: epoch e into the +shift neighbour's kFromBwd and the -shift
//      neighbour's kFromFwd, then this rank's own kFromBwd and kFromFwd
//      waited for until they reach e.  The caller makes the transfer
//      stream wait on this rank's earlier readers of its own receive buffer
//      first, so a neighbour's signal means its receive buffer may be
//      overwritten;
//   2. copy: a grid-stride copy of x into the neighbour's receive buffer
//      through the mapped pointer, 16 bytes a thread;
//   3. arrive: e into the neighbour's kArrival, ordered after the copy's
//      writes.
// Wait (tz_rdma_shift_wait, on the same stream at the await): this rank's
// kArrival waited for until it reaches e.  The stream order behind the post
// also covers the send half (the copy out of x has finished).
//
// Who waits (the hand-off).  The kept design, the stream: every flag write
// is a cuStreamWriteValue64 (without CU_STREAM_WRITE_VALUE_NO_MEMORY_BARRIER,
// so the arrival follows the copy's writes) into the mapped words, and every
// wait a cuStreamWaitValue64(..., CU_STREAM_WAIT_VALUE_GEQ) on this rank's
// own words: the GPU's front end holds the stream, no SM spins.  The
// alternative, kept for timing (spin != 0), is the first version's: the
// barrier, the arrival and the wait are one-thread kernels that store with
// st.release.sys and spin on ld.acquire.sys loads.  A spinning kernel keeps
// its context busy, so on a card shared by two ranks' processes the other
// rank's context runs only when its time slice ends; a context whose
// stream waits on a semaphore lets the other run sooner.  Between two
// processes on one H100 (80GB HBM3, 700 W; parallel/dryrun.py time_shift,
// one x face of the flagship halo) the barrier alone read 0.29 ms with the
// stream's waits against 2.40 ms with the spin, a post and its wait 0.32
// against 2.43 ms, and the copy alone 10 us in both (PERF.md row 10).  On
// every card the spin would also hold an SM slot for the whole wait.
// Stream memory operations need
// CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, checked once; without
// it the stream design fails (no fall back to the spin).
//
// No hang.  A spin gives up after kTimeoutNs on the global nanosecond timer,
// writes an error code into a word of pinned host memory and traps; the
// context's sticky error makes the host's next synchronize raise.  A stream
// wait has no deadline of its own: the host keeps it (ops/rdma.py
// await_shift).  It polls an event recorded after the wait; past the
// deadline it reads this rank's flag words to tell the barrier from the
// arrival, writes that code into the same error word, releases the stuck
// wait by writing the epoch into this rank's own words from another stream
// (tz_rdma_shift_release), and the wrapper raises, naming the barrier or the
// arrival.
//
// Bound: the bytes.  A face of the flagship halo (3 x 3 x 512 x 512 f32,
// 9.4 MB) is read once and written once: 18.9 MB at 3.35 TB/s, 5.6 us.
// Between two processes on one card the hand-off waits for the other
// context to be scheduled, which no bound counts; over NVLink between cards
// the write would run at NVLink's rate instead.  tz_rdma_shift_copy times
// the copy alone, tz_rdma_shift_barrier the barrier alone.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

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

// -- the stream's hand-off: CUDA's stream memory operations

typedef CUresult (*StreamValue64Fn)(CUstream, CUdeviceptr, cuuint64_t,
                                    unsigned int);
typedef CUresult (*DeviceGetFn)(CUdevice*, int);
typedef CUresult (*DeviceGetAttributeFn)(int*, CUdevice_attribute, CUdevice);

StreamValue64Fn g_write = nullptr, g_wait = nullptr;

// 0 once the driver's entry points are found and the device supports 64-bit
// stream memory operations, else the CUDA error to report (checked once).
int memops_ready() {
  static int state = -1;
  if (state >= 0) return state;
  state = (int)cudaErrorNotSupported;
  g_write = reinterpret_cast<StreamValue64Fn>(
      tz_hopper::driver_entry("cuStreamWriteValue64"));
  g_wait = reinterpret_cast<StreamValue64Fn>(
      tz_hopper::driver_entry("cuStreamWaitValue64"));
  auto get = reinterpret_cast<DeviceGetFn>(tz_hopper::driver_entry("cuDeviceGet"));
  auto attr = reinterpret_cast<DeviceGetAttributeFn>(
      tz_hopper::driver_entry("cuDeviceGetAttribute"));
  int ordinal = 0, ok = 0;
  CUdevice dev;
  if (g_write == nullptr || g_wait == nullptr || get == nullptr ||
      attr == nullptr || cudaGetDevice(&ordinal) != cudaSuccess ||
      get(&dev, ordinal) != CUDA_SUCCESS ||
      attr(&ok, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, dev) !=
          CUDA_SUCCESS)
    return state;
  if (!ok) return state;
  // Load the kernels a post launches behind a stream wait now: a lazily
  // loaded kernel is loaded at its first launch, and that load waits for
  // the device, so behind a wait that never completes (a missing peer) the
  // host would block inside the launch, before any deadline could act.
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, shift_copy_kernel) != cudaSuccess) return state;
  state = 0;
  return state;
}

// (Both return the driver's CUresult, 0 on success.)
int write_word(long long* word, long long epoch, cudaStream_t s) {
  return (int)g_write((CUstream)s, (CUdeviceptr)word, (cuuint64_t)epoch,
                      CU_STREAM_WRITE_VALUE_DEFAULT);
}

int wait_word(const long long* word, long long epoch, cudaStream_t s) {
  return (int)g_wait((CUstream)s, (CUdeviceptr)word, (cuuint64_t)epoch,
                     CU_STREAM_WAIT_VALUE_GEQ);
}

// Step 1 of the post: the spin kernel, or the stream's writes and waits.
int barrier(long long* mine, long long* fwd, long long* bwd, int cid,
            long long epoch, int* err, int spin, cudaStream_t s) {
  if (spin) {
    shift_barrier_kernel<<<1, 32, 0, s>>>(mine, fwd, bwd, cid, epoch, err);
    return (int)cudaGetLastError();
  }
  int rc = memops_ready();
  if (rc == 0) rc = write_word(fwd + cid * kSlots + kFromBwd, epoch, s);
  if (rc == 0) rc = write_word(bwd + cid * kSlots + kFromFwd, epoch, s);
  if (rc == 0) rc = wait_word(mine + cid * kSlots + kFromBwd, epoch, s);
  if (rc == 0) rc = wait_word(mine + cid * kSlots + kFromFwd, epoch, s);
  return rc;
}

int copy_blocks(int64_t n16) {
  int64_t blocks = (n16 + kCopyThreads - 1) / kCopyThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;  // 8 blocks per SM, grid-stride
  return (int)blocks;
}

// Step 2 of the post: the copy of `nbytes` from x into `peer_y`.
int copy(const void* x, void* peer_y, int64_t nbytes, cudaStream_t s) {
  if (nbytes <= 0) return 0;
  const int64_t n16 = nbytes / 16;
  const int tail = (int)(nbytes % 16);
  const unsigned char* sb = static_cast<const unsigned char*>(x);
  unsigned char* db = static_cast<unsigned char*>(peer_y);
  shift_copy_kernel<<<copy_blocks(n16), kCopyThreads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(peer_y), n16,
      sb + n16 * 16, db + n16 * 16, tail);
  return (int)cudaGetLastError();
}

}  // namespace

// Words of one rank's flag block per collective id.
extern "C" int64_t tz_rdma_shift_slots() { return kSlots; }

// 0 when this device can run the stream's hand-off (64-bit stream memory
// operations), else the CUDA error the stream design's entry points return.
extern "C" int tz_rdma_shift_memops() { return memops_ready(); }

// The barrier alone (step 1 of the post), for timing it by itself.
extern "C" int tz_rdma_shift_barrier(long long* mine, long long* fwd,
                                     long long* bwd, int64_t cid,
                                     int64_t epoch, int* err, int64_t spin,
                                     void* stream) {
  if (cid < 0) return (int)cudaErrorInvalidValue;
  return barrier(mine, fwd, bwd, (int)cid, epoch, err, (int)spin,
                 (cudaStream_t)stream);
}

// The copy alone (step 2 of the post), for timing it by itself.
extern "C" int tz_rdma_shift_copy(const void* x, void* peer_y, int64_t nbytes,
                                  void* stream) {
  if (nbytes < 0) return (int)cudaErrorInvalidValue;
  return copy(x, peer_y, nbytes, (cudaStream_t)stream);
}

// Post: barrier, copy of `nbytes` from x into the neighbour's receive buffer
// `peer_y`, arrival signal; all on `stream`, the hand-off by the stream
// (spin == 0) or by the spin kernels.  x and peer_y 16-byte aligned (the
// wrapper checks).
extern "C" int tz_rdma_shift_post(const void* x, void* peer_y, int64_t nbytes,
                                  long long* mine, long long* fwd,
                                  long long* bwd, int64_t cid, int64_t epoch,
                                  int* err, int64_t spin, void* stream) {
  if (nbytes < 0 || cid < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = barrier(mine, fwd, bwd, (int)cid, epoch, err, (int)spin, s);
  if (rc == 0) rc = copy(x, peer_y, nbytes, s);
  if (rc != 0) return rc;
  if (spin) {
    shift_arrive_kernel<<<1, 32, 0, s>>>(fwd, (int)cid, epoch);
    return (int)cudaGetLastError();
  }
  return write_word(fwd + cid * kSlots + kArrival, epoch, s);
}

// Wait for this rank's arrival word to reach `epoch` on `stream`.
extern "C" int tz_rdma_shift_wait(const long long* mine, int64_t cid,
                                  int64_t epoch, int* err, int64_t spin,
                                  void* stream) {
  if (cid < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (spin) {
    shift_wait_kernel<<<1, 32, 0, s>>>(mine, (int)cid, epoch, err);
    return (int)cudaGetLastError();
  }
  const int rc = memops_ready();
  return rc != 0 ? rc : wait_word(mine + cid * kSlots + kArrival, epoch, s);
}

// Release a stuck stream wait of `epoch`: the epoch into this rank's own
// three words of `cid`, on `stream` (another stream than the stuck one).
extern "C" int tz_rdma_shift_release(long long* mine, int64_t cid,
                                     int64_t epoch, void* stream) {
  if (cid < 0) return (int)cudaErrorInvalidValue;
  int rc = memops_ready();
  cudaStream_t s = (cudaStream_t)stream;
  const int words[3] = {kFromBwd, kFromFwd, kArrival};
  for (int w : words)
    if (rc == 0) rc = write_word(mine + cid * kSlots + w, epoch, s);
  return rc;
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
