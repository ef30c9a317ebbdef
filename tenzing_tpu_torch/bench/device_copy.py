"""The ``.rdma`` engine's copy kernel (``device_copy``) on the card.

``python -m tenzing_tpu_torch.bench.device_copy [--parent DIR]
[--host-calls N] [--rounds N]``

1. prints the card's name and power limit (``nvidia-smi``);
2. builds ``csrc/device_copy.cu`` again with its body swapped for the
   variant in :data:`VARIANTS` (a text replacement: a ring of 1D bulk
   copies through shared memory, one thread a block, the source under an
   L2 ``evict_first`` policy), the control beside the register body the
   library keeps;
3. for each of the flagship halo's six staging buffers (one face of
   ``HaloArgs(3, 512, 512, 512, 3)`` in rows of 128 floats, as the halo
   path copies them), checks the wrapper and each variant bit for bit
   against ``copy_``, and prints the time of the wrapper, of each variant,
   of one ``copy_`` and, with ``--parent``, of an older checkout's kernel
   (its library built from its own sources), each after a write flush
   (``ms``, as chip_smoke.py times) and after a read flush (``clean_ms``;
   ``bench/halo_kernels.both_ms``), beside the bytes bound (read once,
   written once at 3.35 TB/s), in ``--rounds`` passes whose calls
   alternate in order, after the timer's floor (an empty kernel);
4. the wrapper's host time per call (``--host-calls`` calls, no sync after
   each; the stream drained every ``HOST_BLOCK`` calls, outside the timed
   calls) and the C entry point's alone, beside the older checkout's, in
   alternating blocks in one process.

One JSON object per line.  It needs a CUDA device; exits 1 if a copy
differs from ``copy_``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

from tenzing_tpu_torch.bench import attn_common as common
from tenzing_tpu_torch.bench.halo_kernels import (
    FLAGSHIP,
    FLUSH_FLOATS,
    HOST_BLOCK,
    _load,
    _timed_calls,
    both_ms,
    bound_ms,
    host_stats,
)
from tenzing_tpu_torch.utils.cli import write_line

# The bulk-copy ring: kStages stages of kStageBytes per block; the block's
# one thread loads a chunk (global -> shared, mbarrier complete_tx), stores
# it (shared -> global, a bulk group) and refills the stage once the store
# has read it, kStages - 1 loads in flight beside the stores.
BULK_RING = r"""
constexpr int kStageBytes = 8192;
constexpr int kStages = 4;

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ void bulk_load_hint(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(tz_hopper::smem_u32(dst)), "l"(src), "r"(bytes),
         "r"(tz_hopper::smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(tz_hopper::smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(32)
    device_copy_bulk(const unsigned char* __restrict__ src,
                     unsigned char* __restrict__ dst, int64_t nbytes) {
  __shared__ __align__(128) unsigned char ring[kStages][kStageBytes];
  __shared__ uint64_t full[kStages];
  const int64_t body = nbytes & ~(int64_t)15;
  if (blockIdx.x == 0 && body + threadIdx.x < nbytes)
    dst[body + threadIdx.x] = src[body + threadIdx.x];
  if (threadIdx.x != 0) return;
  const int64_t chunks = (body + kStageBytes - 1) / kStageBytes;
  if (blockIdx.x >= chunks) return;
  const int64_t mine = (chunks - 1 - blockIdx.x) / gridDim.x + 1;
  for (int s = 0; s < kStages; ++s) tz_hopper::mbar_init(&full[s], 1);
  tz_hopper::fence_barrier_init();
  const uint64_t policy = policy_evict_first();
  auto span = [&](int64_t i, int64_t* off) {
    *off = (blockIdx.x + i * gridDim.x) * (int64_t)kStageBytes;
    const int64_t left = body - *off;
    return (uint32_t)(left < kStageBytes ? left : kStageBytes);
  };
  auto load = [&](int64_t i) {
    int64_t off;
    const uint32_t bytes = span(i, &off);
    tz_hopper::mbar_expect_tx(&full[i % kStages], bytes);
    bulk_load_hint(ring[i % kStages], src + off, bytes, &full[i % kStages], policy);
  };
  for (int64_t i = 0; i < mine && i < kStages; ++i) load(i);
  for (int64_t i = 0; i < mine; ++i) {
    int64_t off;
    const uint32_t bytes = span(i, &off);
    tz_hopper::mbar_wait(&full[i % kStages], (uint32_t)((i / kStages) & 1));
    bulk_store(dst + off, ring[i % kStages], bytes);
    if (i >= 1 && i - 1 + kStages < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i - 1 + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace
"""

# name -> edits of csrc/device_copy.cu (attn_common.build_variants)
VARIANTS = {"bulk_ring": [
    ("#include <stdint.h>\n", '#include <stdint.h>\n\n#include "hopper.cuh"\n'),
    ("}  // namespace\n", BULK_RING),
    ("  int64_t blocks = ((nbytes >> 4) + kThreads * kUnroll - 1) / (kThreads * kUnroll);",
     "  int64_t blocks = ((nbytes & ~(int64_t)15) + kStageBytes - 1) / kStageBytes;"),
    ("  device_copy_kernel<<<(unsigned)blocks, kThreads, 0,",
     "  device_copy_bulk<<<(unsigned)blocks, 32, 0,")]}


def staging_buffers(torch, device):
    """(face name, staging buffer) of the six faces, random from seed 0."""
    from tenzing_tpu_torch.models.halo import DIRECTIONS, HaloArgs, _face_slices, dir_name

    args = HaloArgs(**FLAGSHIP)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = []
    for d in DIRECTIONS:
        _, sizes = _face_slices(args, d, "pack")
        n = 1
        for s in sizes:
            n *= int(s)
        out.append((dir_name(d), torch.rand(-(-n // 128), 128, device=device,
                                            generator=gen)))
    return out


def parent_rdma(root: str):
    """An older checkout's ops/rdma.py at ``root``, calling the kernel
    library built from that checkout's own sources; the kinds it registers
    are put back to this tree's."""
    from tenzing_tpu_torch.core import operation

    kinds = operation.kind_registry()
    klib = _load("parent_kernel_lib", f"{root}/tenzing_tpu_torch/ops/kernel_lib.py")
    mod = _load("parent_rdma", f"{root}/tenzing_tpu_torch/ops/rdma.py")
    operation._KIND_REGISTRY.clear()
    operation._KIND_REGISTRY.update(kinds)
    mod.kernel_lib = klib
    klib.lib()
    return mod


def variant_calls(torch, device, src, dst, libs) -> dict:
    """label -> a closure copying ``src`` into ``dst`` through each built
    variant's ``tz_device_copy`` on the current stream."""
    from tenzing_tpu_torch.ops import kernel_lib

    stream = torch.cuda.current_stream(device).cuda_stream
    nbytes = src.numel() * src.element_size()

    def call(lib):
        kernel_lib.check_launch("device_copy", lib.tz_device_copy(
            src.data_ptr(), dst.data_ptr(), nbytes, stream))

    return {name: (lambda lib=lib: call(lib)) for name, lib in libs.items()}


def face_rows(torch, device, libs, parent, rounds: int) -> list:
    from tenzing_tpu_torch.ops import rdma

    flush = torch.empty(FLUSH_FLOATS, device=device)
    floor = {"floor": "empty kernel", **both_ms(
        torch, lambda: torch.cuda._sleep(0), flush)}
    write_line(json.dumps(floor))
    rows = []
    for (name, src), rnd in itertools.product(staging_buffers(torch, device),
                                              range(rounds)):
        dst = torch.zeros_like(src)
        variants = variant_calls(torch, device, src, dst, libs)
        calls = {"kernel": lambda: rdma.device_copy(src, dst), **variants,
                 "copy_": lambda: dst.copy_(src)}
        if parent is not None:
            calls["parent"] = lambda: parent.device_copy(src, dst)
        row = {"face": name, "round": rnd, "shape": list(src.shape)}
        for label in ("kernel", *variants):
            dst.zero_()
            calls[label]()
            torch.cuda.synchronize()
            row[f"{label}_exact"] = torch.equal(dst, src)
        for label, fn in (calls.items() if rnd % 2 == 0
                          else list(calls.items())[::-1]):
            t = both_ms(torch, fn, flush)
            row[f"{label}_ms"], row[f"{label}_clean_ms"] = t["ms"], t["clean_ms"]
        row["bound_ms"] = bound_ms(2 * src.numel() * 4)
        rows.append(row)
        write_line(json.dumps(row))
    return rows


def host_rows(torch, device, calls: int, parent) -> dict:
    """Host time per call of the wrapper and of its C entry point, this
    tree's and (``parent``) the older checkout's, in alternating blocks of
    ``HOST_BLOCK`` calls."""
    from tenzing_tpu_torch.ops import rdma

    _, src = staging_buffers(torch, device)[0]
    dst = torch.zeros_like(src)
    stream = torch.cuda.current_stream(device).cuda_stream
    versions = {"this": rdma} | ({"parent": parent} if parent is not None else {})
    fns = {}
    for name, mod in versions.items():
        entry = mod.kernel_lib.lib().tz_device_copy
        fns[(name, "wrapper")] = lambda m=mod: m.device_copy(src, dst)
        fns[(name, "c_entry")] = lambda e=entry: e(
            src.data_ptr(), dst.data_ptr(), src.numel() * 4, stream)
    times = {k: [] for k in fns}
    for block in range(max(1, calls // HOST_BLOCK)):
        keys = list(fns) if block % 2 == 0 else list(fns)[::-1]
        for k in keys:
            times[k] += _timed_calls(torch, fns[k], HOST_BLOCK)
    torch.cuda.synchronize()
    row = {"host": "device_copy", "face": "x", "calls": calls}
    for (name, what), ts in times.items():
        row[f"{name}_{what}"] = host_stats(ts)
    write_line(json.dumps(row))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="an older checkout whose kernel and wrapper are "
                         "measured beside this one's")
    ap.add_argument("--host-calls", type=int, default=4000)
    ap.add_argument("--rounds", type=int, default=2,
                    help="passes over the faces, the calls in alternating "
                         "order")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("device_copy: no CUDA device\n")
        return 2
    from tenzing_tpu_torch.ops import kernel_lib

    common.device_line(torch)
    kernel_lib.lib()
    device = torch.device("cuda", 0)
    parent = parent_rdma(args.parent) if args.parent else None
    libs, reports = common.build_variants(
        "device_copy.cu", VARIANTS, "device_copy", source="device_copy.cu",
        entry_points=("tz_device_copy",))
    for r in reports:
        write_line(json.dumps(r))
    del libs["kernel"]  # the wrapper's own library is timed as "kernel"
    rows = face_rows(torch, device, libs, parent, args.rounds)
    host_rows(torch, device, args.host_calls, parent)
    failed = [f"{r['face']} {k[:-6]}" for r in rows for k, v in r.items()
              if k.endswith("_exact") and not v]
    write_line(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
