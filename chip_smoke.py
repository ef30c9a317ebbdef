#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, each printing one JSON line (details also go to
``chiprun_out/chip_smoke.jsonl``); any failure raises and exits non-zero
before the last line:

1. device   — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build    — builds the hand-written CUDA kernels from ``tenzing_tpu_torch/csrc``
              (ops/kernel_lib.py) and reports the build time;
3. kernels  — at the 512^3 flagship shapes, for each of the six faces and each
              kernel slot on its menu, ``halo_pack`` and ``halo_unpack`` against
              their plain PyTorch versions, and ``device_copy`` against
              ``copy_``: bit-exact (tolerance 0, pure data movement), with the
              kernel's, the plain version's and the library call's times and
              the bytes bound;
4. executor — the naive, greedy host/rdma/mixed, alias and all-kernel orders on
              8 lanes through ``StreamExecutor``: the final grid must be
              bit-identical to the same order run with every kernel replaced by
              its plain version on the card, and to the expected grid; timed
              runs must leave every buffer's ``data_ptr`` unchanged;
5. driver   — ``tenzing_tpu_torch.bench.driver.run`` at ``halo_n=512`` with a
              small budget; ``verified`` must be true and each kernel's launch
              count over this run must be > 0.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device it prints nothing
and exits 2.  Times are CUDA-event times on the card this runs on.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FLUSH_BYTES = 128 << 20  # > the 50 MB L2: each timed launch starts cold
REPS = 15

_log = None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    _log.write(line + "\n")
    _log.flush()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of single launches, each after an L2 flush.

    A spin kernel ahead of each timed launch keeps the card busy while the
    host enqueues the flush, the events and the launch, so the interval
    between the two events holds the launch's device time and not the
    host's Python overhead of issuing it."""

    SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: longer than enqueueing

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(FLUSH_BYTES // 4, device=device)

    def ms(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush_buf.fill_(1.0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def bound_ms(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def phase_kernels(torch, device, timer):
    """Every kernel slot at the flagship shapes against its plain version."""
    from tenzing_tpu_torch.models.halo import (
        DIRECTIONS,
        HaloArgs,
        _face_slices,
        dir_name,
        face_view,
    )
    from tenzing_tpu_torch.models.halo_pipeline import _padded_shape
    from tenzing_tpu_torch.ops import halo_kernels as hk
    from tenzing_tpu_torch.ops import rdma

    args = HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    u = torch.rand(_padded_shape(args.local_shape()), device=device,
                   generator=gen)
    summary = {"halo_pack": [], "halo_unpack": [], "device_copy": []}
    slots = {".pallas": (False, False), ".pallasb": (True, False),
             ".pallasf": (True, True)}  # suffix -> (batched, flat)
    for d in DIRECTIONS:
        name = dir_name(d)
        starts, sizes = _face_slices(args, d, "pack")
        ustarts, _ = _face_slices(args, d, "unpack")
        n = int(sizes[0] * sizes[1] * sizes[2] * sizes[3])
        rows = -(-n // 128)
        pack_menu = [c.name()[len(f"pack_{name}"):]
                     for c in hk.PackChoice(args, d).choices()]
        unpack_menu = [c.name()[len(f"unpack_{name}"):]
                       for c in hk.UnpackChoice(args, d).choices()]
        face_bytes = 2 * n * 4
        recv = None
        for suffix in pack_menu:
            if suffix not in slots:
                continue
            batched, flat = slots[suffix]
            rpb = hk._rows_per_block(u, starts, sizes) if batched else 1
            shape = (rows, 128) if flat else tuple(sizes)
            got = torch.zeros(shape, device=device)
            want = torch.zeros(shape, device=device)
            hk.halo_pack(u, got, starts, sizes, rpb)
            hk.halo_pack_plain(u, want, starts, sizes)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"halo_pack{suffix} {name}: differs from "
                                     f"its plain version (max abs err {err})")
            uview = face_view(u, starts, sizes)
            face4d = want.view(-1)[:n].view(tuple(sizes))
            row = {"kernel": "halo_pack", "face": name, "slot": suffix,
                   "rows_per_block": rpb, "shape": list(sizes), "exact": True,
                   "max_abs_err": err,
                   "ms": timer.ms(lambda: hk.halo_pack(u, got, starts, sizes, rpb)),
                   "plain_ms": timer.ms(
                       lambda: hk.halo_pack_plain(u, want, starts, sizes)),
                   "library_ms": timer.ms(lambda: face4d.copy_(uview)),
                   "bound_ms": bound_ms(face_bytes)}
            emit(row)
            summary["halo_pack"].append(row)
            recv = want.view(-1)[:n].clone()
        staging = torch.zeros(rows * 128, device=device)
        staging[:n] = recv
        for suffix in unpack_menu:
            if suffix not in slots:
                continue
            batched, _ = slots[suffix]
            rpb = hk._rows_per_block(u, ustarts, sizes) if batched else 1
            ug, uw = u.clone(), u.clone()
            hk.halo_unpack(ug, staging, ustarts, sizes, rpb)
            hk.halo_unpack_plain(uw, staging, ustarts, sizes)
            torch.cuda.synchronize()
            same = torch.equal(ug, uw)
            err = float((face_view(ug, ustarts, sizes)
                         - face_view(uw, ustarts, sizes)).abs().max())
            if not same:
                raise AssertionError(f"halo_unpack{suffix} {name}: differs "
                                     f"from its plain version (max abs err {err})")
            del uw
            uview = face_view(ug, ustarts, sizes)
            face4d = staging[:n].view(tuple(sizes))
            row = {"kernel": "halo_unpack", "face": name, "slot": suffix,
                   "rows_per_block": rpb, "shape": list(sizes), "exact": True,
                   "max_abs_err": err,
                   "ms": timer.ms(
                       lambda: hk.halo_unpack(ug, staging, ustarts, sizes, rpb)),
                   "plain_ms": timer.ms(
                       lambda: hk.halo_unpack_plain(ug, staging, ustarts, sizes)),
                   "library_ms": timer.ms(lambda: uview.copy_(face4d)),
                   "bound_ms": bound_ms(face_bytes)}
            emit(row)
            summary["halo_unpack"].append(row)
            del ug
        src = staging.view(rows, 128)
        dst = torch.zeros_like(src)
        rdma.device_copy(src, dst)
        ref = torch.zeros_like(src)
        rdma.device_copy_plain(src, ref)
        torch.cuda.synchronize()
        err = float((dst - ref).abs().max())
        if not torch.equal(dst, ref):
            raise AssertionError(f"device_copy {name}: differs from copy_")
        row = {"kernel": "device_copy", "face": name, "slot": ".rdma",
               "shape": [rows, 128], "exact": True, "max_abs_err": err,
               "ms": timer.ms(lambda: rdma.device_copy(src, dst)),
               "plain_ms": timer.ms(lambda: rdma.device_copy_plain(src, ref)),
               "library_ms": timer.ms(lambda: dst.copy_(src)),
               "bound_ms": bound_ms(2 * rows * 128 * 4)}
        emit(row)
        summary["device_copy"].append(row)
    del u
    torch.cuda.empty_cache()
    return summary


def phase_executor(torch, device):
    """Whole schedules through the stream executor, kernels vs plain."""
    from tenzing_tpu_torch.bench.driver import alias_unpack_choice
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import (
        HALO_PHASES,
        build_graph,
        greedy_overlap_order,
        host_buffer_names,
        make_pipeline_buffers,
        naive_order,
    )
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.solve.local import drive, phase_policy
    from tenzing_tpu_torch.verify import ScheduleVerifier

    args = HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3)
    t0 = time.time()
    bufs, want = make_pipeline_buffers(args, seed=0, with_expected=True)
    want_dev = torch.from_numpy(want).to(device)
    del want
    tbufs = buffers_from_numpy(bufs, device, host_buffer_names())
    del bufs
    setup_s = time.time() - t0
    plat = Platform.make_n_lanes(8)
    kern = StreamExecutor(plat, tbufs, device="cuda")
    plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
    choice_g = build_graph(args, impl_choice=True, xfer_choice=True)

    def prefer_alias(op_name, choices):
        if op_name.startswith("xfer_"):
            return next(c for c in choices if c.endswith(".rdma"))
        if op_name.startswith("unpack_"):
            return alias_unpack_choice(op_name, choices)
        return next(c for c in choices if c.endswith(".xla"))

    def prefer_kernels(op_name, choices):
        if op_name.startswith("xfer_"):
            return next(c for c in choices if c.endswith(".rdma"))
        for suffix in (".pallasf", ".pallasb", ".pallas"):
            hit = next((c for c in choices if c.endswith(suffix)), None)
            if hit is not None:
                return hit
        return None

    orders = {
        "naive": (naive_order(args, plat), build_graph(args)),
        "greedy-host-8l": (greedy_overlap_order(args, plat, "host"),
                           build_graph(args, engine="host")),
        "greedy-rdma-8l": (greedy_overlap_order(args, plat, "rdma"),
                           build_graph(args, engine="rdma")),
        "greedy-mixed-8l": (greedy_overlap_order(args, plat, "mixed"),
                            build_graph(args, engine="mixed")),
        "alias-8l": (drive(choice_g, plat, phase_policy(
            plat, HALO_PHASES, prefer_alias))[0], choice_g),
        "kernels-8l": (drive(choice_g, plat, phase_policy(
            plat, HALO_PHASES, prefer_kernels))[0], choice_g),
    }
    rows = []
    for label, (order, graph) in orders.items():
        if not ScheduleVerifier(graph)(order).ok:
            raise AssertionError(f"executor phase: {label} is not sound")
        t0 = time.time()
        out_k = kern.run(order)
        out_p = plain.run(order)
        same_plain = all(torch.equal(out_k[k], out_p[k]) for k in out_k)
        same_want = torch.equal(out_k["U"], want_dev)
        del out_k, out_p
        ptrs = {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        kern.prepare_n(order)(3)
        ptrs_ok = ptrs == {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        timed_ok = torch.equal(kern.init_bufs["U"], want_dev)
        row = {"phase": "executor", "order": label, "ops": len(order),
               "equal_plain": same_plain, "equal_expected": same_want,
               "data_ptr_unchanged": ptrs_ok, "timed_runs_expected": timed_ok,
               "wall_s": round(time.time() - t0, 3)}
        emit(row)
        rows.append(row)
        if not (same_plain and same_want and ptrs_ok and timed_ok):
            raise AssertionError(f"executor phase failed on {label}: {row}")
    del kern, plain, tbufs, want_dev
    torch.cuda.empty_cache()
    return {"setup_s": round(setup_s, 3), "orders": len(rows)}


def main() -> int:
    global _log
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device available\n")
        return 2
    sys.path.insert(0, REPO)
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.ops import halo_kernels as hk
    from tenzing_tpu_torch.ops import kernel_lib, rdma

    os.makedirs(OUT_DIR, exist_ok=True)
    _log = open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "w")
    t_start = time.time()
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
          "name": torch.cuda.get_device_name(0)})

    t0 = time.time()
    kernel_lib.lib()
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "compiled": kernel_lib.build_info.get("compiled"),
          "library": os.path.relpath(kernel_lib.build_info["path"], REPO)})
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(str(kernel_lib.build_info.get("ptxas", "(library was cached)")))

    timer = Timer(torch, device)
    t0 = time.time()
    summary = phase_kernels(torch, device, timer)
    emit({"phase": "kernels", "rows": sum(len(v) for v in summary.values()),
          "all_exact": True, "wall_s": round(time.time() - t0, 3)})

    t0 = time.time()
    ex_info = phase_executor(torch, device)
    emit({"phase": "executor", **ex_info, "wall_s": round(time.time() - t0, 3)})

    t0 = time.time()
    req = driver.DriverRequest(mcts_iters=12, iters=3, search_iters=2)
    for counts in (hk.LAUNCHES, rdma.LAUNCHES):
        for k in counts:
            counts[k] = 0
    result = driver.run(req, device="cuda")
    launches = {**hk.LAUNCHES, **rdma.LAUNCHES}
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    emit({"phase": "driver", "launches": launches,
          "verified": verdict.get("verified"),
          "wall_s": round(time.time() - t0, 3)})
    if verdict.get("metric") != "halo_iter_pct50_searched_n512":
        raise AssertionError(f"driver metric {verdict.get('metric')!r}")
    if verdict.get("verified") is not True:
        raise AssertionError(f"driver result not verified: {verdict}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")

    # one halo iteration's six faces at the batched blocking, per kernel
    def six_faces(rows, blocking):
        picked = [r for r in rows if r["slot"] == blocking or (
            blocking == ".pallasb" and r["slot"] == ".pallas"
            and not any(q["face"] == r["face"] and q["slot"] == ".pallasb"
                        for q in rows))]
        return {key: sum(r[key] for r in picked)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}

    sources = {
        "halo_pack": ("tenzing_tpu_torch/csrc/halo_pack.cu",
                      "tenzing_tpu/ops/halo_pallas.py:189",
                      ".pallasb"),
        "halo_unpack": ("tenzing_tpu_torch/csrc/halo_unpack.cu",
                        "tenzing_tpu/ops/halo_pallas.py:221",
                        ".pallasb"),
        "device_copy": ("tenzing_tpu_torch/csrc/device_copy.cu",
                        "tenzing_tpu/ops/rdma.py:138",
                        ".rdma"),
    }
    kernels = []
    for name, (src, replaces, blocking) in sources.items():
        rows = summary[name]
        agg = six_faces(rows, blocking)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "bound_by": "bytes",
            "library_ms": agg["library_ms"],
            "work": "six faces of one halo iteration, "
                    + ("staging copies" if name == "device_copy"
                       else "batched blocking (one row per block on x)"),
        })
    emit({"phase": "done", "wall_s": round(time.time() - t_start, 3)})
    _log.close()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
