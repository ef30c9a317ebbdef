"""The halo pack and unpack kernels (``halo_pack``, ``halo_unpack``) on the card.

``python -m tenzing_tpu_torch.bench.halo_kernels [--sweep] [--host-calls N]
[--host-only] [--parent DIR]``

1. prints the card's name and power limit (``nvidia-smi``);
2. the timer's floor (an empty kernel, one contiguous ``copy_`` of a face's
   floats), then, at the flagship grid (``HaloArgs(3, 512, 512, 512, 3)``, U
   (3, 518, 520, 640) f32), for each of the six faces, each kernel slot on
   its menu and each body (the one the library plans, then SIMT forced on
   the unpacks that take TMA): checks the kernel bit-exact against the
   plain version and prints its time, the time of one ``copy_`` of the same
   cut, the bytes bound and, for z faces, the sector bound
   (:func:`sector_bytes`); beside them the body, the box, the ring depth,
   the grid and the bytes in flight per SM
   (:func:`ops.halo_kernels.halo_launch_plan`);
3. with ``--sweep``, the unpack's TMA body tuned: ``csrc/halo_unpack.cu``
   rebuilt with ``halo_copy.cuh``'s box bytes, ring depth and blocks per SM
   set to each point of :data:`SWEEP` whose blocks fit an SM (all ``nvcc``
   processes started together), and the x and y faces' flat-slot unpack
   timed and checked in each;
4. the wrappers' host time per call (``--host-calls`` calls, 1000 by
   default, none followed by a sync; the stream is drained every
   :data:`HOST_BLOCK` calls, outside the timed calls) and the C entry
   point's alone: median and 90th percentile, for a TMA cut and a SIMT cut;
   with ``--parent DIR``, an older checkout's wrappers and library in the
   same process, in alternating blocks.  ``--host-only`` runs 1 and 4
   alone.  In a checkout whose ops/halo_kernels.py has no ``launch_body``
   (before the TMA body), step 2 times the wrappers alone, so the same file
   measures the older kernels.

Times: CUDA events, the median of 15 single launches, each behind a spin
and after a 128 MB L2 flush: ``ms`` after a write flush, as chip_smoke.py
times, ``clean_ms`` after a read flush (:func:`cuda_ms`).  One JSON object
per line.  It needs a CUDA device; exits 1 if a kernel differs from its
plain version.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys
import time
from typing import Dict, List

import numpy as np

from tenzing_tpu_torch.bench import attn_common as common  # device_line
from tenzing_tpu_torch.utils.cli import write_line

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SECTOR = 32  # bytes: the unit in which the card's L2 moves device memory
FLAGSHIP = dict(nq=3, lx=512, ly=512, lz=512, radius=3)
# --sweep: box bytes x stages x blocks per SM
SWEEP = list(itertools.product((4096, 8192, 16384), (2, 3, 4), (4, 6, 8)))
SMEM_PER_SM = 228 * 1024
BLOCK_RESERVED_SMEM = 1024  # what the card keeps per resident block
FLUSH_FLOATS = 32 << 20  # 128 MB, > the 50 MB L2
# host timing: calls between two drains of the stream, few enough that the
# launch queue never holds the host back
HOST_BLOCK = 50
REPS = 15


def cuda_ms(torch, fn, flush_buf, write_flush: bool, reps: int = REPS) -> float:
    """Median CUDA-event time of single calls of ``fn``, each behind a spin
    that covers the enqueue and after a 128 MB flush of the L2: a write
    (``fill_``, as chip_smoke.py's Timer and :func:`attn_common.cuda_ms`
    flush, which leaves the L2 full of dirty lines that the call's own
    traffic must write back) or a read (``sum``, which leaves it clean)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        if write_flush:
            flush_buf.fill_(1.0)
        else:
            flush_buf.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def both_ms(torch, fn, flush_buf) -> dict:
    """:func:`cuda_ms` after a write flush (``ms``) and a read flush
    (``clean_ms``)."""
    return {"ms": cuda_ms(torch, fn, flush_buf, True),
            "clean_ms": cuda_ms(torch, fn, flush_buf, False)}


def bound_ms(nbytes: float) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def sector_bytes(u_shape, starts, sizes) -> int:
    """Bytes of device memory one copy of the cut moves when every run
    (q, i, j) of sz floats in U costs the whole 32-byte sectors it touches
    (U's base and rows 32-byte aligned), plus the contiguous face's bytes."""
    nq, sx, sy, sz = (int(v) for v in sizes)
    _, X, Y, Z = (int(v) for v in u_shape)
    _, x0, y0, z0 = (int(v) for v in starts)
    q = np.arange(nq, dtype=np.int64)[:, None, None]
    i = np.arange(sx, dtype=np.int64)[None, :, None]
    j = np.arange(sy, dtype=np.int64)[None, None, :]
    row = ((q * X + x0 + i) * Y + y0 + j) * Z * 4
    first = (row + z0 * 4) // SECTOR
    last = (row + (z0 + sz) * 4 - 1) // SECTOR
    return int((last - first + 1).sum()) * SECTOR + nq * sx * sy * sz * 4


def flagship(torch, device):
    """(args, U) of the flagship grid, U random from seed 0."""
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import _padded_shape

    args = HaloArgs(**FLAGSHIP)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return args, torch.rand(_padded_shape(args.local_shape()), device=device,
                            generator=gen)


def plan_summary(plan: Dict[str, object]) -> dict:
    """The plan's fields a report prints."""
    if plan["body"] == "simt":
        return {"body": "simt", "group": plan["group"], "runs": plan["runs"],
                "grid": plan["grid"], "threads": plan["threads"]}
    return {"body": "tma", "box_zyx": [plan["bz"], plan["by"], plan["bx"]],
            "box_bytes": 4 * plan["bz"] * plan["by"] * plan["bx"],
            "stages": plan["stages"], "boxes": plan["boxes"],
            "grid": plan["grid"], "smem_bytes": plan["smem_bytes"],
            "in_flight_per_sm": plan["in_flight_per_sm"]}


def face_rows(torch, device) -> List[dict]:
    """Step 2: every face, slot and body at the flagship shapes."""
    from tenzing_tpu_torch.models.halo import (
        DIRECTIONS,
        _face_slices,
        dir_name,
        face_view,
    )
    from tenzing_tpu_torch.ops import halo_kernels as hk

    args, u = flagship(torch, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    flush = torch.empty(FLUSH_FLOATS, device=device)
    legacy = not hasattr(hk, "launch_body")  # an older checkout: wrappers only

    def call(kind, u_, face_, starts, sizes, rpb, body):
        if legacy:
            (hk.halo_pack if kind == "pack" else hk.halo_unpack)(
                u_, face_, starts, sizes, rpb)
        else:
            hk.launch_body(kind, u_, face_, starts, sizes, rpb, body)

    # the timer's floor: a kernel that does nothing, and one contiguous
    # copy_ of a face's bytes
    n = int(np.prod(_face_slices(args, (1, 0, 0), "pack")[1]))
    a, b = torch.empty(n, device=device), torch.zeros(n, device=device)
    rows = [{"floor": "empty kernel", **both_ms(
                 torch, lambda: torch.cuda._sleep(0), flush)},
            {"floor": "contiguous copy_ of one x face's floats",
             "bound_ms": bound_ms(8 * n),
             **both_ms(torch, lambda: a.copy_(b), flush)}]
    del a, b
    for row in rows:
        write_line(json.dumps(row))
    for d in DIRECTIONS:
        name = dir_name(d)
        pstarts, sizes = _face_slices(args, d, "pack")
        ustarts, _ = _face_slices(args, d, "unpack")
        n = int(np.prod(sizes))
        slots = [c.name()[len(f"pack_{name}"):]
                 for c in hk.PackChoice(args, d).choices()]
        for slot, kind in itertools.product(slots, ("pack", "unpack")):
            if slot == ".xla":
                continue
            starts = pstarts if kind == "pack" else ustarts
            rpb = 1 if slot == ".pallas" else hk._rows_per_block(u, starts,
                                                                 sizes)
            face = torch.zeros(((-(-n // 128)) * 128 if slot == ".pallasf"
                                else n), device=device)
            hk.halo_pack_plain(u, face, pstarts, sizes)
            cut = face_view(u, starts, sizes)
            face4d = face[:n].view(tuple(sizes))
            bodies = ["auto"] + (["simt"] if not legacy and kind == "unpack"
                                 and hk.tma_fits(sizes, face.data_ptr())
                                 else [])
            for body in bodies:
                if kind == "pack":
                    got = torch.zeros_like(face)
                    call("pack", u, got, starts, sizes, rpb, body)
                    exact = torch.equal(got[:n], face[:n])
                    run = (lambda got=got, body=body: call(
                        "pack", u, got, starts, sizes, rpb, body))
                    lib = lambda: face4d.copy_(cut)  # noqa: E731
                else:
                    ug = u.clone()
                    call("unpack", ug, face, starts, sizes, rpb, body)
                    uw = u.clone()
                    hk.halo_unpack_plain(uw, face, starts, sizes)
                    exact = torch.equal(ug, uw)
                    del uw, ug
                    run = (lambda body=body: call(
                        "unpack", u, face, starts, sizes, rpb, body))
                    lib = lambda: cut.copy_(face4d)  # noqa: E731
                torch.cuda.synchronize()
                lib_t = both_ms(torch, lib, flush)
                row = {"kernel": f"halo_{kind}", "face": name, "slot": slot,
                       "forced": body != "auto", "exact": exact,
                       **both_ms(torch, run, flush),
                       "copy_ms": lib_t["ms"], "copy_clean_ms": lib_t["clean_ms"],
                       "bound_ms": bound_ms(8 * n)}
                if d[2]:
                    row["sector_bound_ms"] = bound_ms(
                        sector_bytes(u.shape, starts, sizes))
                if not legacy:
                    row.update(plan_summary(hk.halo_launch_plan(
                        u.shape, starts, sizes, kind == "pack",
                        face.data_ptr(), body, sms)))
                rows.append(row)
                write_line(json.dumps(row))
    return rows


def sweep_points() -> List[tuple]:
    """The points of :data:`SWEEP` whose ring and blocks fit one SM."""
    from tenzing_tpu_torch.ops import halo_kernels as hk

    return [(box, stages, per_sm) for box, stages, per_sm in SWEEP
            if per_sm * (hk.STAGE_ALIGN + stages * box + 16 * hk.MAX_STAGES
                         + BLOCK_RESERVED_SMEM) <= SMEM_PER_SM]


def sweep_edits(box: int, stages: int, per_sm: int) -> List[tuple]:
    """The edits of csrc/halo_copy.cuh that set the TMA body's tuning."""
    from tenzing_tpu_torch.ops import halo_kernels as hk

    return [(f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")
            for name, old, new in (("kBoxBytes", hk.BOX_BYTES, box),
                                   ("kStages", hk.STAGES, stages),
                                   ("kBlocksPerSm", hk.BLOCKS_PER_SM, per_sm))]


def sweep_rows(torch, device) -> List[dict]:
    """Step 3: the unpack's TMA body rebuilt at each point of the sweep,
    timed on the x and y faces' flat slot."""
    from tenzing_tpu_torch.models.halo import _face_slices
    from tenzing_tpu_torch.ops import halo_kernels as hk

    points = {f"box{b}-stages{s}-sm{p}": (b, s, p) for b, s, p in sweep_points()}
    libs, reports = common.build_variants(
        "halo_copy.cuh", {k: sweep_edits(*v) for k, v in points.items()},
        "halo_unpack_tma", source="halo_unpack.cu",
        entry_points=("tz_halo_unpack",))
    ptxas = {r["ablation"]: r["ptxas"] for r in reports}
    args, u = flagship(torch, device)
    flush = torch.empty(FLUSH_FLOATS, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _, X, Y, Z = u.shape
    rows = []
    for d in ((1, 0, 0), (0, 1, 0)):
        starts, _ = _face_slices(args, d, "unpack")
        _, sizes = _face_slices(args, d, "pack")
        n = int(np.prod(sizes))
        face = torch.rand(-(-n // 128) * 128, device=device)
        want = u.clone()
        hk.halo_unpack_plain(want, face, starts, sizes)
        rpb = hk._rows_per_block(u, starts, sizes)
        for name, lib in libs.items():
            cargs = (u.data_ptr(), face.data_ptr(), sizes[0], X, Y, Z,
                     *starts[1:], *sizes[1:], rpb, stream)

            def run(lib=lib, cargs=cargs):
                from tenzing_tpu_torch.ops import kernel_lib

                kernel_lib.check_launch("tz_halo_unpack",
                                        lib.tz_halo_unpack(*cargs))

            got = u.clone()
            run(cargs=(got.data_ptr(), *cargs[1:]))
            torch.cuda.synchronize()
            box, stages, per_sm = points.get(
                name, (hk.BOX_BYTES, hk.STAGES, hk.BLOCKS_PER_SM))
            row = {"sweep": "halo_unpack", "face": "x" if d[0] else "y",
                   "variant": name, "box_bytes": box, "stages": stages,
                   "blocks_per_sm": per_sm, "exact": torch.equal(got, want),
                   **both_ms(torch, run, flush),
                   "registers": ptxas[name].get("registers")}
            del got
            rows.append(row)
            write_line(json.dumps(row))
    return rows


def host_stats(times_us: List[float]) -> dict:
    times = sorted(times_us)
    return {"median_us": statistics.median(times),
            "p90_us": times[int(0.9 * len(times))]}


def _load(name: str, path: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_module(root: str):
    """An older checkout's ops/halo_kernels.py at ``root``, calling the kernel
    library built from that checkout's own sources (its kernel_lib.py)."""
    klib = _load("parent_kernel_lib",
                 f"{root}/tenzing_tpu_torch/ops/kernel_lib.py")
    mod = _load("parent_halo_kernels",
                f"{root}/tenzing_tpu_torch/ops/halo_kernels.py")
    mod.kernel_lib = klib
    klib.lib()
    return mod


def _timed_calls(torch, fn, calls: int) -> List[float]:
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        out.append((time.perf_counter_ns() - t0) / 1e3)
    return out


def host_rows(torch, device, calls: int, parent_root=None) -> List[dict]:
    """Step 4: host time per wrapper call, no sync after it, and of the C
    entry point alone (its arguments made once); with ``parent_root``, the
    older checkout's wrappers and library beside them, in alternating blocks
    of :data:`HOST_BLOCK` calls in this process."""
    from tenzing_tpu_torch.models.halo import _face_slices
    from tenzing_tpu_torch.ops import halo_kernels as hk

    versions = {"this": hk}
    if parent_root:
        versions["parent"] = parent_module(parent_root)
    args, u = flagship(torch, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = []
    for d, label in (((1, 0, 0), "x face, flat slot"),
                     ((0, 0, 1), "z face, per-row slot")):
        pstarts, sizes = _face_slices(args, d, "pack")
        ustarts, _ = _face_slices(args, d, "unpack")
        n = int(np.prod(sizes))
        face = torch.zeros(-(-n // 128) * 128, device=device)
        _, X, Y, Z = u.shape
        for kind, starts in (("pack", pstarts), ("unpack", ustarts)):
            calls_of = {}
            for name, mod in versions.items():
                wrapper = getattr(mod, f"halo_{kind}")
                entry = getattr(mod.kernel_lib.lib(), f"tz_halo_{kind}")
                cargs = (u.data_ptr(), face.data_ptr(), sizes[0], X, Y, Z,
                         *starts[1:], *sizes[1:], 1, stream)
                calls_of[name] = {
                    "wrapper": lambda w=wrapper: w(u, face, starts, sizes),
                    "c_entry": lambda e=entry, a=cargs: e(*a)}
                calls_of[name]["wrapper"]()  # the build and the first maps
            times = {(name, what): [] for name in versions
                     for what in ("wrapper", "c_entry")}
            for block in range(max(1, calls // HOST_BLOCK)):
                order = list(versions) if block % 2 == 0 else \
                    list(versions)[::-1]
                for name in order:
                    for what in ("wrapper", "c_entry"):
                        times[(name, what)] += _timed_calls(
                            torch, calls_of[name][what], HOST_BLOCK)
            torch.cuda.synchronize()
            row = {"host": f"halo_{kind}", "cut": label, "calls": calls}
            for (name, what), ts in times.items():
                row[f"{name}_{what}"] = host_stats(ts)
            rows.append(row)
            write_line(json.dumps(row))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also rebuild and time the unpack's TMA body at "
                         "each tuning")
    ap.add_argument("--host-calls", type=int, default=1000)
    ap.add_argument("--host-only", action="store_true",
                    help="only the wrappers' host time")
    ap.add_argument("--parent", metavar="DIR",
                    help="an older checkout whose wrappers' host time "
                         "step 4 measures beside this one's")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("halo_kernels: no CUDA device\n")
        return 2
    from tenzing_tpu_torch.ops import kernel_lib

    common.device_line(torch)
    kernel_lib.lib()
    device = torch.device("cuda", 0)
    failed = []
    if not args.host_only:
        rows = face_rows(torch, device)
        failed = [f"{r['kernel']} {r['face']}{r['slot']}"
                  f"{' simt' if r['forced'] else ''}"
                  for r in rows if not r.get("exact", True)]
        if args.sweep:
            failed += [f"sweep {r['variant']} {r['face']}"
                       for r in sweep_rows(torch, device) if not r["exact"]]
    host_rows(torch, device, args.host_calls, args.parent)
    write_line(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
