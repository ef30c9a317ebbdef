"""The SpMV instantiation of ``fused_region`` on the card: where a region's
time goes.

``python -m tenzing_tpu_torch.bench.fused_spmv [--ablate] [--parent DIR]
[--rounds N]``

1. prints the card's name and power limit (``nvidia-smi``);
2. lowers the spmv driver's naive host-exchange order at m=150000 and
   m=8192 (``driver.build_spmv``, ``models.spmv.fixed_orders``) into its two
   fused regions at one tile, and checks each region's kernel against the
   plain region (``REGION_TOL``) and two launches against each other (bit
   for bit);
3. per region: the kernel's time after a write flush (``ms``, as
   chip_smoke.py times) and after a read flush (``clean_ms``;
   ``bench/halo_kernels.both_ms``), and the same for a table of each member
   alone (one member kind at a time), each beside its bytes bound (its
   external inputs read once and outputs written once at 3.35 TB/s);
4. with ``--ablate``, ``csrc/fused_region.cu`` built again with one part
   of it or of ``csrc/ell_row.cuh`` (the row sum it shares with
   ``ell_spmv.cu``) changed (:data:`ABLATIONS`, each a text replacement;
   all ``nvcc`` processes started together) and every region timed
   through each variant: the group barriers removed (each block only
   syncs itself), the barrier's spin without ``__nanosleep``, the ELL
   body's x gather replaced by the column index (no load: the slab stream alone), and an
   empty launch of the same cooperative grid, table and shared memory (the
   launch floor); for this tree's kernel also the tuning variants (ring
   depth, gathers in flight, consumer warps, every x load through L2,
   chunks cut in even rounds of one a block instead of at most 128 rows,
   the slabs' bulk copies under an L2 evict_first policy, the gather, add
   and copy bodies a float a load instead of 16 bytes).  A
   variant that keeps the result (the tunings, the spin) is checked against
   the plain region too;
5. with ``--parent DIR``, steps 3-4 also for an older checkout's
   ``csrc/fused_region.cu`` (``git archive`` of the parent into a
   gitignored directory), in the same process, the versions in alternating
   rounds.  The descriptor table's layout is the same in both.

One JSON object per line.  It needs a CUDA device; exits 1 if a check
fails.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

from tenzing_tpu_torch.bench import attn_common as common
from tenzing_tpu_torch.bench.halo_kernels import FLUSH_FLOATS, both_ms
from tenzing_tpu_torch.utils.cli import write_line

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SIZES = (150_000, 8192)
ENTRY_POINTS = ("tz_fused_region", "tz_fused_region_max_blocks")

# the slabs' bulk copies with their source under an L2 evict_first policy
EVICT_FIRST_LOAD = r"""// -- the SpMV instantiation

__device__ __forceinline__ void bulk_load_evict_first(void* dst, const void* src,
                                                      uint32_t bytes, uint64_t* bar) {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(tz_hopper::smem_u32(dst)), "l"(src), "r"(bytes),
         "r"(tz_hopper::smem_u32(bar)), "l"(p) : "memory");
}
"""

# the files a build of the kernel reads from a version's csrc/ (an older
# checkout may lack the row sum's header)
FILES = ("fused_region.cu", "ell_row.cuh")
# name -> (alternative edit lists, keeps the result): the first list whose
# edits all apply to a version's files is used (the parent's ELL body and
# this tree's differ); an edit (old, new) replaces the first occurrence of
# old in the first file holding it.  A variant with no list that applies is
# skipped for that version.
Edits = List[Tuple[str, str]]
ABLATIONS: Dict[str, Tuple[List[Edits], bool]] = {
    "no_group_barriers": ([[(
        "  if (kAligned) __syncthreads(); else cta_sync();\n"
        "  if (threadIdx.x == 0) {",
        "  if (kAligned) __syncthreads(); else cta_sync();\n"
        "  if (false) {")]], False),
    "spin_without_nanosleep": ([[(
        "while (*vgen == g) __nanosleep(64);", "while (*vgen == g) {}")]], True),
    "x_gather_constant": ([
        [("__ldcg(x + __ldcg(cols + row * w + j))",
          "(float)__ldcg(cols + row * w + j)")],
        [("xv[u] = ld<kXCoherent>(x + col(j + u));", "xv[u] = (float)col(j + u);"),
         ("fmaf(val(j + u), ld<kXCoherent>(x + col(j + u)), acc[u])",
          "fmaf(val(j + u), (float)col(j + u), acc[u])")]], False),
    "empty_launch": ([[(
        "for (int k = 0; k < t.n; ++k) {", "for (int k = 0; k < 0; ++k) {")]],
        False),
    # this tree's tunings
    "stages_2": ([[("constexpr int kSlabStages = 3;",
                    "constexpr int kSlabStages = 2;")]], True),
    "stages_4": ([[("constexpr int kSlabStages = 3;",
                    "constexpr int kSlabStages = 4;")]], True),
    "x_batch_4": ([[("constexpr int kXBatch = 8;",
                     "constexpr int kXBatch = 4;")]], True),
    "x_batch_16": ([[("constexpr int kXBatch = 8;",
                      "constexpr int kXBatch = 16;")]], True),
    "consumer_warps_8": ([[("constexpr int kConsumerWarps = 4;",
                            "constexpr int kConsumerWarps = 8;")]], True),
    "x_through_l2": ([[("return kCoherent ? __ldcg(p) : __ldg(p);",
                        "return __ldcg(p);")]], True),
    "even_rounds": ([[(
        "  int64_t rows = ((n + bpg - 1) / bpg + 3) & ~(int64_t)3;\n"
        "  rows = rows < 32 ? 32 : rows > kChunkRows ? kChunkRows : rows;",
        "  const int64_t rounds = (n + bpg * kChunkRows - 1) / (bpg * kChunkRows);\n"
        "  int64_t rows = ((n + bpg * rounds - 1) / (bpg * rounds) + 3) & ~(int64_t)3;\n"
        "  if (rows < 32) rows = 32;")]], True),
    "slabs_evict_first": ([[
        ("// -- the SpMV instantiation\n", EVICT_FIRST_LOAD),
        ("tz_hopper::bulk_load(&sm.vals[", "bulk_load_evict_first(&sm.vals["),
        ("tz_hopper::bulk_load(&sm.cols[", "bulk_load_evict_first(&sm.cols[")]],
        True),
    "scalar_elementwise": ([[("const bool vec = ptrs % 16 == 0;",
                              "const bool vec = false;")]], True),
}


def bound_ms(nbytes: float) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def apply(texts: Dict[str, str], alternatives: List[Edits]):
    """``texts`` (file -> text) with the edits of the first alternative that
    applies (each edit's first occurrence replaced, in the first file that
    holds it), or None when none applies."""
    for edits in alternatives:
        if all(any(old in t for t in texts.values()) for old, _ in edits):
            out = dict(texts)
            for old, new in edits:
                f = next(f for f, t in out.items() if old in t)
                out[f] = out[f].replace(old, new, 1)
            return out
    return None


def build(csrc: Path, ablate: bool, tag: str) -> Dict[str, ctypes.CDLL]:
    """csrc/fused_region.cu of ``csrc`` as it is (``kernel``) and, with
    ``ablate``, each :data:`ABLATIONS` variant that applies to it, each a
    shared library built in a directory of its own holding that version of
    :data:`FILES` (the quoted includes find them there first and ``csrc``'s
    other headers through ``-I``), all ``nvcc`` processes started
    together."""
    from tenzing_tpu_torch.ops import kernel_lib

    texts = {f: (csrc / f).read_text() for f in FILES if (csrc / f).exists()}
    variants = {"kernel": texts}
    if ablate:
        for name, (alternatives, _) in ABLATIONS.items():
            edited = apply(texts, alternatives)
            if edited is not None:
                variants[name] = edited
    kernel_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"fused_spmv_{tag}_",
                                 dir=kernel_lib.BUILD_DIR))
    procs = {}
    for name, files in variants.items():
        (work / name).mkdir()
        for f, text in files.items():
            (work / name / f).write_text(text)
        so = work / name / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kernel_lib.nvcc(), *kernel_lib.ARCH_FLAGS, *kernel_lib.COMPILE_FLAGS,
             "-shared", "-I", str(csrc), str(work / name / "fused_region.cu"),
             "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} {name} failed to build:\n{out}")
        report = common.ptxas_report(out, "fused_region_kernel")
        write_line(json.dumps({"version": tag, "variant": name, "ptxas": report}))
        lib = ctypes.CDLL(str(so))
        for fn in ENTRY_POINTS:
            getattr(lib, fn).argtypes = kernel_lib.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(torch, lib, table, tiles: int, device):
    """A closure launching ``table`` (a ctypes Table) through ``lib`` on the
    current stream over the largest cooperative grid of at most two blocks
    per SM that ``lib`` reports resident, with zeroed counters of its own."""
    from tenzing_tpu_torch.ops import kernel_lib

    got = lib.tz_fused_region_max_blocks(ctypes.addressof(table))
    if got <= 0:
        raise RuntimeError(f"fused_spmv: occupancy query returned {got}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    bpg = min(got, 2 * sms) // tiles
    counters = torch.zeros(2 * tiles, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run():
        kernel_lib.check_launch("fused_region", lib.tz_fused_region(
            ctypes.addressof(table), counters.data_ptr(), bpg, stream))

    run.blocks = bpg * tiles
    return run


def regions(torch, device, m: int):
    """(buffers, [(label, RegionTable, region bytes), ...]) of the naive
    host-exchange order's fused regions at one tile, each table bound to
    the buffers, and one single-member table per member."""
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.spmv import fixed_orders
    from tenzing_tpu_torch.ops import fused_region as fr
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.runtime.fused import (
        FusedExecutor,
        FusedRegionOp,
        partition_regions,
        region_bytes,
    )

    g, tbufs, _, _ = driver.build_spmv(
        driver.DriverRequest(workload="spmv", m=m), device)
    kern = StreamExecutor(Platform.make_n_lanes(2), tbufs, device="cuda")
    seq = fixed_orders(g)["naive"]
    fseq = FusedExecutor(kern, tiles=1).fused_order(seq)
    kern.precompile(fseq)
    bufs = kern.init_bufs
    # what the host round trip would have delivered: a gather of real values
    bufs["x_remote"].copy_(bufs["x_local"][bufs["send_idx"].long()])
    nbytes = {k: v.numel() * v.element_size() for k, v in bufs.items()}
    segs = [s for k, s in partition_regions(seq.vector(), kern.host_names)
            if k == "region"]
    out = []
    for r, (op, seg) in enumerate(zip(
            [o for o in fseq if isinstance(o, FusedRegionOp)], segs)):
        k = op.unbound()
        k.apply(bufs, kern.ctx)  # binds the table
        out.append((f"region{r}", k.table, region_bytes(seg, nbytes),
                    "+".join(mm.name() for mm in seg.members)))
        for mb in k.table.members:
            one = fr.RegionTable([dataclasses.replace(mb, barrier=False)], 1)
            one.bind(bufs, kern.ctx.scratch[k._counters()])
            out.append((f"region{r}/{mb.body}", one,
                        sum(nbytes[n] for n in dict.fromkeys(mb.operands)),
                        mb.body))
    return kern, bufs, out


def check(torch, lib, table, bufs, device) -> dict:
    """The region through ``lib`` against the plain region on copies of the
    buffers (every output at REGION_TOL), and two launches bit for bit."""
    from tenzing_tpu_torch.ops import fused_region as fr

    outs = sorted({n for mb in table.members
                   for n, role in zip(mb.operands, fr.OPERANDS[mb.body])
                   if role in ("y", "out")})
    want = {k: v.clone() for k, v in bufs.items()}
    fr.region_plain(table.members, want, 1)
    run = launcher(torch, lib, table.tables[0], 1, device)
    run()
    first = {n: bufs[n].clone() for n in outs}
    run()
    torch.cuda.synchronize()
    ok = all(torch.allclose(bufs[n], want[n], **fr.REGION_TOL) for n in outs)
    same = all(torch.equal(bufs[n], first[n]) for n in outs)
    err = max(float((bufs[n] - want[n]).abs().max()) for n in outs)
    return {"within_tol": ok, "deterministic": same, "max_abs_err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ablate", action="store_true",
                    help="also time csrc/fused_region.cu's ablation variants")
    ap.add_argument("--parent", metavar="DIR",
                    help="an older checkout whose kernel is measured beside "
                         "this one's")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("fused_spmv: no CUDA device\n")
        return 2
    from tenzing_tpu_torch.ops import kernel_lib

    common.device_line(torch)
    kernel_lib.lib()
    device = torch.device("cuda", 0)
    versions = {"this": kernel_lib.CSRC}
    if args.parent:
        versions["parent"] = Path(args.parent) / "tenzing_tpu_torch" / "csrc"
    libs = {tag: build(csrc, args.ablate, tag) for tag, csrc in versions.items()}
    flush = torch.empty(FLUSH_FLOATS, device=device)
    failed = []
    for m in SIZES:
        kern, bufs, tables = regions(torch, device, m)
        for tag, vlibs in libs.items():
            for name, lib in vlibs.items():
                keeps = name == "kernel" or ABLATIONS[name][1]
                for label, table, _, members in tables:
                    if "/" in label or not keeps:
                        continue
                    row = {"check": label, "m": m, "version": tag,
                           "variant": name, "members": members,
                           **check(torch, lib, table, bufs, device)}
                    write_line(json.dumps(row))
                    if not (row["within_tol"] and row["deterministic"]):
                        failed.append(f"{tag}/{name}/m{m}/{label}")
        for rnd in range(args.rounds):
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for tag in order:
                for name, lib in libs[tag].items():
                    for label, table, nb, members in tables:
                        if "/" in label and name != "kernel":
                            continue  # one member kind at a time: the kernel
                        run = launcher(torch, lib, table.tables[0], 1, device)
                        t = both_ms(torch, run, flush)
                        b = bound_ms(nb)
                        write_line(json.dumps({
                            "m": m, "round": rnd, "version": tag,
                            "variant": name, "region": label,
                            "members": members, "blocks": run.blocks, **t,
                            "bytes": nb, "bound_ms": b,
                            "vs_bound": t["ms"] / b}))
        del kern, bufs, tables
        torch.cuda.empty_cache()
    write_line(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
