// halo_pack: gather one halo face cut of the grid U into a contiguous buffer.
//
// Replaces the TPU kernels pack_face_pallas (tenzing_tpu/ops/halo_pallas.py:189),
// pack_face_pallas_batched (:266) and pack_face_flat_pallas (:385).  The three
// differ on the TPU only in DMA choreography (one aligned window per row, BX
// rows per step with a two-slot prefetch, or an in-VMEM relayout to the
// (rows, 128) staging layout); what they compute is the same gather:
//
//     out[((q*sx + i)*sy + j)*sz + k] = U[q, x0+i, y0+j, z0+k]
//
// The contiguous output IS the staging layout's first nq*sx*sy*sz elements, so
// the flat slot (.pallasf) passes the staging buffer and the other slots a 4D
// face tensor.  The kernel ignores rows_per_block beyond checking that it
// divides sx: a slot's blocking on the TPU is its DMA schedule.
//
// Bound on an H100 SXM: data movement, 2 x nq*sx*sy*sz*4 bytes (each face
// element read once, written once) at 3.35 TB/s: 5.63 us for one x or y face
// of the 512^3 flagship (3 x 3 x 512 x 512 f32).  Reaching it takes tens of
// KB of loads in flight on every SM.  A z face (sz = 3) reads 12 useful
// bytes of each 2560-byte grid row: every run costs a 32-byte sector, so it
// is bound by 786432 x 32 + 9.44 MB of sectors, ~10.3 us.
//
// The design: one body, SIMT (halo_copy.cuh simt_copy).  `group` lanes share
// a run (q, i, j) of sz floats, each thread holds kSimtRuns runs with their
// loads in flight before its stores (the bytes in flight that one load
// feeding one store lacked); one 32-bit division pair and one 64-bit base per
// run, no division per element.  A body that loaded U's boxes by TMA into a
// ring of stages and stored them from shared memory read 2-5% slower than
// this one on the flagship's x and y faces (PERF.md).  A face's runs
// in U start 12 bytes off a 16-byte boundary (z0 = 3), and a TMA copy whose
// box starts off one in its innermost dimension faults with an illegal
// instruction (bench/tma_probe.py), so those boxes had to start 4 floats
// early and split each run in four, where the SIMT body reads each run
// once.  A failed launch returns its error (the wrapper raises).

#include "halo_copy.cuh"

__global__ void __launch_bounds__(tz_halo::kSimtThreads)
halo_pack_simt(float* __restrict__ u, float* __restrict__ face, int64_t X,
               int64_t Y, int64_t Z, int64_t x0, int64_t y0, int64_t z0,
               uint32_t sx, uint32_t sy, uint32_t sz, int group_log2,
               uint32_t runs) {
  tz_halo::simt_copy<true>(u, face, X, Y, Z, x0, y0, z0, sx, sy, sz,
                           group_log2, runs);
}

// Launch on `stream`; returns the launch's cudaError_t (0 on success).  The
// caller checks shapes, bounds and rows_per_block | sx before calling.
extern "C" int tz_halo_pack(const float* u, float* out,
                            int64_t nq, int64_t X, int64_t Y, int64_t Z,
                            int64_t x0, int64_t y0, int64_t z0,
                            int64_t sx, int64_t sy, int64_t sz,
                            int64_t rows_per_block, void* stream) {
  const tz_halo::Cut c{nq, X, Y, Z, x0, y0, z0, sx, sy, sz};
  tz_halo::Plan p;
  int dev;
  const int err = tz_halo::plan_launch(c, out, true, rows_per_block,
                                       tz_halo::kAuto, &dev, &p);
  if (err != 0) return err;
  return tz_halo::launch_simt(halo_pack_simt, const_cast<float*>(u), out, c,
                              p, (cudaStream_t)stream);
}

// The plan a pack (pack != 0) or an unpack of this cut from or into `face`
// launches with `body`, as tz_halo::kPlanFields int64s in tz_halo::Plan's
// order; returns cudaErrorInvalidValue where the call would be refused.
extern "C" int tz_halo_plan(const void* face,
                            int64_t nq, int64_t X, int64_t Y, int64_t Z,
                            int64_t x0, int64_t y0, int64_t z0,
                            int64_t sx, int64_t sy, int64_t sz, int64_t pack,
                            int64_t body, int64_t* out) {
  tz_halo::Plan p;
  int err = tz_halo::make_plan(
      tz_halo::Cut{nq, X, Y, Z, x0, y0, z0, sx, sy, sz}, face, pack != 0,
      body, &p);
  if (err == 0 && p.body == tz_halo::kTma)
    err = tz_halo::tma_grid(&p,
                            tz_halo::sm_count(tz_halo::current_device()));
  if (err != 0) return err;
  static_assert(sizeof(tz_halo::Plan) == tz_halo::kPlanFields * sizeof(int64_t),
                "plan fields");
  memcpy(out, &p, sizeof p);
  return 0;
}
