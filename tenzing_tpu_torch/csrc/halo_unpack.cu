// halo_unpack: scatter a received face into the ghost shell of the grid U, in
// place.
//
// Replaces the TPU kernels unpack_face_pallas (tenzing_tpu/ops/halo_pallas.py:221),
// unpack_face_pallas_batched (:319) and unpack_face_flat_pallas (:446).  On the
// TPU all three read-modify-write the tile-aligned window around the cut
// (halo_pallas.py:241-246); here the kernel writes exactly the cut:
//
//     U[q, x0+i, y0+j, z0+k] = face[((q*sx + i)*sy + j)*sz + k]
//
// Writing only the cut matters on CUDA: two unpacks may run at once on two
// lane streams, and a window read-modify-write would race on the elements the
// windows share.  The face is read from a contiguous buffer: the 4D face (or
// the first nq*sx*sy*sz elements of the (rows, 128) staging buffer for the flat
// slot).  rows_per_block is checked and otherwise ignored, as in halo_pack.
//
// Bound on an H100 SXM: data movement, 2 x nq*sx*sy*sz*4 bytes at 3.35 TB/s;
// a z face writes 12 bytes of every 2560-byte grid row, one 32-byte sector a
// run (halo_pack.cu states the numbers).
//
// The design, two bodies, picked by the entry point from the cut's shape and
// the face's address (halo_copy.cuh make_plan):
// - TMA body (halo_unpack_tma), where the face allows it (16-byte aligned,
//   sz a multiple of 4 floats): one producer thread per block loads boxes of
//   the face through its 4D tensor map (sz, sy, sx, nq), each starting on a
//   16-byte boundary, into a ring of kStages shared-memory stages with full
//   and empty mbarriers; kConsumerWarps warps store each box's rows to U with
//   plain stores, which hold no registers in flight.  kStages boxes of
//   ~kBoxBytes are in flight per block, kBlocksPerSm blocks per SM; no thread
//   divides per element.  Boxes: the fewest balanced extents of at most 256
//   floats along z (a multiple of 4), then y and x up to ~kBoxBytes.  The
//   stores write exactly the cut: a ragged last box is bounded by the
//   consumers' row and column checks, never by a clip that would touch the
//   ghost shell's neighbours or the interior, and U's start 12 bytes off a
//   16-byte boundary costs nothing but a partial sector.
// - SIMT body (halo_unpack_simt), for every other cut (the z faces, sz = 3;
//   a misaligned face): halo_pack's body with loads and stores swapped.
// A failed tensor-map encoding or launch returns its error (the wrapper
// raises).

#include <cuda.h>

#include <mutex>

#include "halo_copy.cuh"
#include "hopper.cuh"

namespace tz_halo {

using namespace tz_hopper;

constexpr int kMapSlots = 512;  // the tensor-map cache, direct-mapped

// -- host: tensor maps of the face, encoded once per (pointer, dims, box)

struct MapKey {
  const void* ptr;
  int64_t words[7];  // dims[4], box[3]
};

struct MapCache {
  std::mutex mu;
  MapKey keys[kMapSlots];
  CUtensorMap maps[kMapSlots];
  bool used[kMapSlots];
};

MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

// The face as a contiguous 4D float32 map (z, y, x, q) with no swizzle.
int face_map(CUtensorMap* out, const void* face, const int64_t dims[4],
             const int64_t box[3]) {
  MapKey key;
  memset(&key, 0, sizeof key);
  key.ptr = face;
  memcpy(key.words, dims, 4 * sizeof(int64_t));
  memcpy(key.words + 4, box, 3 * sizeof(int64_t));
  uint64_t h = (uint64_t)(uintptr_t)face;  // FNV-1a over the key's words
  for (int64_t w : key.words) h = (h ^ (uint64_t)w) * 1099511628211ull;
  const int slot = (int)((h ^ (h >> 29)) % kMapSlots);
  MapCache& cache = map_cache();
  std::lock_guard<std::mutex> lock(cache.mu);
  if (cache.used[slot] && memcmp(&cache.keys[slot], &key, sizeof key) == 0) {
    *out = cache.maps[slot];
    return 0;
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t gdim[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1],
                              (cuuint64_t)dims[2], (cuuint64_t)dims[3]};
  const cuuint64_t gstr[3] = {(cuuint64_t)(4 * dims[0]),
                              (cuuint64_t)(4 * dims[0] * dims[1]),
                              (cuuint64_t)(4 * dims[0] * dims[1] * dims[2])};
  const cuuint32_t bdim[4] = {(cuuint32_t)box[0], (cuuint32_t)box[1],
                              (cuuint32_t)box[2], 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUtensorMap map;
  CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                  const_cast<void*>(face), gdim, gstr, bdim, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  cache.keys[slot] = key;
  cache.maps[slot] = map;
  cache.used[slot] = true;
  *out = map;
  return 0;
}

// -- device: the TMA body

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The geometry of one TMA launch.  A box holds bx x by rows of bz floats
// (dense, z innermost); its face origin is (cz, cy, cx, q).
struct Geometry {
  int64_t X, Y, Z;  // U's extents
  int x0, y0, z0, sx, sy, sz;
  int bz, by, bx, nbz, nby, nbx, boxes;
  uint32_t box_bytes, stage_bytes;
};

}  // namespace tz_halo

// Block b copies boxes b, b + gridDim.x, ... through a ring of kStages
// shared-memory stages.  Warp 0's lane 0 loads box i into stage i % kStages
// by TMA once the stage is empty, completing on its full barrier; the
// consumer warps wait for it, store its rows to U with plain stores (each
// float exactly once, inside the cut) and free the stage.
__global__ void __launch_bounds__(tz_halo::kTmaThreads)
halo_unpack_tma(const __grid_constant__ CUtensorMap map, float* __restrict__ u,
                const tz_halo::Geometry g) {
  using namespace tz_halo;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t skip =
      ((raw + kStageAlign - 1) & ~(uint32_t)(kStageAlign - 1)) - raw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int first = blockIdx.x, step = gridDim.x;
  const int n = first < g.boxes ? (g.boxes - 1 - first) / step + 1 : 0;
  // the face origin of the block's box i
  auto origin = [&](int i, int& cz, int& cy, int& cx, int& q) {
    int b = first + i * step;
    cz = (b % g.nbz) * g.bz;
    b /= g.nbz;
    cy = (b % g.nby) * g.by;
    b /= g.nby;
    cx = (b % g.nbx) * g.bx;
    q = b / g.nbx;
  };
  if (warp == 0) {
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], (uint32_t)(((i / kStages) & 1) ^ 1));
        int cz, cy, cx, q;
        origin(i, cz, cy, cx, q);
        mbar_expect_tx(&full[s], g.box_bytes);
        tma_load_4d(raw + skip + s * g.stage_bytes, &map, smem_u32(&full[s]),
                    cz, cy, cx, q);
      }
    }
    return;
  }
  const int rows = g.by * g.bx;
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (uint32_t)((i / kStages) & 1));
    int cz, cy, cx, q;
    origin(i, cz, cy, cx, q);
    const float* box =
        reinterpret_cast<const float*>(smem_raw + skip + s * g.stage_bytes);
    const int kv = min(g.bz, g.sz - cz);
    for (int r = warp - 1; r < rows; r += kConsumerWarps) {
      const int ii = r / g.by, jj = r - ii * g.by;
      if (cy + jj >= g.sy || cx + ii >= g.sx) continue;
      const float* src = box + r * g.bz;
      const int64_t row =
          ((int64_t)q * g.X + g.x0 + cx + ii) * g.Y + g.y0 + cy + jj;
      float* out = u + row * g.Z + g.z0 + cz;
      for (int k = lane; k < kv; k += 32) out[k] = src[k];
    }
    release(&empty[s], lane);
  }
}

__global__ void __launch_bounds__(tz_halo::kSimtThreads)
halo_unpack_simt(float* __restrict__ u, float* __restrict__ face, int64_t X,
                 int64_t Y, int64_t Z, int64_t x0, int64_t y0, int64_t z0,
                 uint32_t sx, uint32_t sy, uint32_t sz, int group_log2,
                 uint32_t runs) {
  tz_halo::simt_copy<false>(u, face, X, Y, Z, x0, y0, z0, sx, sy, sz,
                            group_log2, runs);
}

static int unpack_launch(float* u, const float* face, const tz_halo::Cut& c,
                         int64_t rows_per_block, int64_t body, void* stream) {
  using namespace tz_halo;
  Plan p;
  int dev;
  int err = plan_launch(c, face, false, rows_per_block, body, &dev, &p);
  if (err != 0) return err;
  if (p.body == kSimt)
    return launch_simt(halo_unpack_simt, u, const_cast<float*>(face), c, p,
                       (cudaStream_t)stream);
  const int64_t dims[4] = {c.sz, c.sy, c.sx, c.nq};
  const int64_t box[3] = {p.bz, p.by, p.bx};
  CUtensorMap map;
  err = face_map(&map, face, dims, box);
  if (err != 0) return err;
  static bool configured[kMaxDevices] = {false};
  if (!configured[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        halo_unpack_tma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRingLimit);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  Geometry g;
  g.X = c.X;
  g.Y = c.Y;
  g.Z = c.Z;
  g.x0 = (int)c.x0;
  g.y0 = (int)c.y0;
  g.z0 = (int)c.z0;
  g.sx = (int)c.sx;
  g.sy = (int)c.sy;
  g.sz = (int)c.sz;
  g.bz = (int)p.bz;
  g.by = (int)p.by;
  g.bx = (int)p.bx;
  g.nbz = (int)cdiv(c.sz, p.bz);
  g.nby = (int)cdiv(c.sy, p.by);
  g.nbx = (int)cdiv(c.sx, p.bx);
  g.boxes = (int)p.boxes;
  g.box_bytes = (uint32_t)(4 * p.bz * p.by * p.bx);
  g.stage_bytes = (uint32_t)(cdiv(g.box_bytes, kStageAlign) * kStageAlign);
  halo_unpack_tma<<<(unsigned)p.grid, kTmaThreads, (size_t)p.smem,
                    (cudaStream_t)stream>>>(map, u, g);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns the launch's cudaError_t (0 on success).  The
// caller checks shapes, bounds and rows_per_block | sx before calling.
extern "C" int tz_halo_unpack(float* u, const float* face,
                              int64_t nq, int64_t X, int64_t Y, int64_t Z,
                              int64_t x0, int64_t y0, int64_t z0,
                              int64_t sx, int64_t sy, int64_t sz,
                              int64_t rows_per_block, void* stream) {
  return unpack_launch(u, face,
                       tz_halo::Cut{nq, X, Y, Z, x0, y0, z0, sx, sy, sz},
                       rows_per_block, tz_halo::kAuto, stream);
}

// tz_halo_unpack with the body forced (0 auto, 1 TMA, 2 SIMT; a TMA body the
// cut does not allow is an error).  For measurements and tests only.
extern "C" int tz_halo_unpack_ex(float* u, const float* face,
                                 int64_t nq, int64_t X, int64_t Y, int64_t Z,
                                 int64_t x0, int64_t y0, int64_t z0,
                                 int64_t sx, int64_t sy, int64_t sz,
                                 int64_t rows_per_block, int64_t body,
                                 void* stream) {
  return unpack_launch(u, face,
                       tz_halo::Cut{nq, X, Y, Z, x0, y0, z0, sx, sy, sz},
                       rows_per_block, body, stream);
}
