"""Where one iteration's time goes on the card.

``python -m tenzing_tpu_torch.bench.breakdown [halo|attn|moe|spmv ...]``
(default: all four) builds the workload at its full size — the halo
pipeline (nQ=3, 512^3 cells, radius 3), blocked attention (batch 4, 8k
context in 8 blocks of 1024, head dim 128), the MoE pipeline (8 experts,
8192 tokens, d_model 512, d_ff 2048, 4 chunks) or the SpMV iteration (the
driver's graph at m=150000 and m=8192) — runs a few fixed schedules through
the stream executor (halo: naive, greedy host 8 lanes, greedy rdma 2 lanes,
alias 8 lanes; attn: naive all-``.xla``, the ``.pallas_bf16`` chain, the
fused kernel in f32 and bf16, and naive lowered into one ``fused_region``
kernel at one tile; moe on 2 lanes: naive, greedy overlap, greedy
bf16 and f32 device copy, the bf16 device-copy order with every expert
MLP on the ``ffn_batched`` kernel, and the f32 host-staged order with every
expert MLP unchunked and chunked 2 and 4 ways; spmv on 2 lanes: naive and the overlap
order at m=150000, each also lowered into ``fused_region`` kernels at one
tile, and naive and the all-kernel order at m=8192), and prints one JSON
line per schedule.  Each schedule runs on two executors over the same
buffers: one that replays it as CUDA graphs (the default, runtime/graphs.py)
and one that dispatches every op from Python (``graphs=False``).  The
line's top-level numbers are the graph executor's; ``eager`` holds the same
numbers without graphs, ``outputs_equal`` says whether one run of each left
the same buffers (bit for bit; ``outputs_max_abs_diff`` the largest
difference), and ``segments`` / ``graphs`` count the schedule's capture
segments and its graphs.

* ``wall_us`` — host wall time per iteration of ``run_n`` (what the driver's
  metric measures, fence included);
* ``device_busy_us`` — the union of all device activity (kernels and copies,
  on every stream) per iteration, from a ``torch.profiler`` trace of a
  separate run;
* ``idle_share`` — 1 - busy / wall over that traced run: how much of the
  iteration the card waits on the host;
* ``host_syncs_per_iter`` — the host blocks one iteration executed;
* ``overlap_us`` — device activity time beyond the union (two activities
  at once count once extra), and ``transfer_overlap_us`` the time a
  ``device_copy`` transfer kernel runs beside other device work, per
  iteration (with graphs: lanes overlapping across the host waits);
* ``top`` — device time per activity name, per iteration;
* ``attrib`` — the schedule run unit by unit
  (obs/attrib ``stepped_timeline``, 7 repeats; a fused order's regions as
  units) and analyzed against ``wall_us``: the stepped sum of parts, the
  critical path, the dispatch overhead, the overlap efficiency, the units
  and how they were timed, the fence overhead.

``python -m tenzing_tpu_torch.bench.breakdown [halo|attn|moe|spmv ...]``.
The card's name and power limit lead the output.  It needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

from tenzing_tpu_torch.utils.cli import write_line

ITERS = 50


@dataclass
class Opts:
    """How the workloads measure: ``iters`` timed iterations, the traced
    run (``profile``) and the stepped attribution (``attrib``) on or off,
    and where each row goes (``emit``; None: printed as a JSON line).
    ``chip_smoke.py``'s graphs phase turns the trace and the attribution
    off."""

    iters: int = ITERS
    profile: bool = True
    attrib: bool = True
    emit: Optional[Callable[[dict], None]] = None


def attrib_of(ex, order, wall_us: float) -> dict:
    """The stepped timeline of ``order`` on ``ex`` (a FusedExecutor steps
    its fused order on the executor under it), analyzed against
    ``wall_us``."""
    from tenzing_tpu_torch.obs import attrib

    inner = getattr(ex, "inner", None)
    stepper, seq = (inner, ex.fused_order(order)) if inner is not None \
        else (ex, order)
    tl = attrib.stepped_timeline(stepper, seq)
    doc = attrib.analyze(seq.vector(), tl, measured_us=wall_us).to_json(
        with_timeline=False)
    doc["timers"] = tl.timers()
    doc["fetch_overhead_us"] = tl.fetch_overhead_us
    return {k: doc[k] for k in (
        "n_timed", "sum_of_parts_us", "critical_path_us",
        "dispatch_overhead_us", "overlap_efficiency", "per_lane_busy_us",
        "timers", "fetch_overhead_us")}


def measure(ex, order, iters: int = ITERS, profile: bool = True) -> dict:
    """Wall and device-busy time per iteration of one order on ``ex`` (a
    StreamExecutor or a FusedExecutor over one), and the host blocks each
    iteration executed (``RunContext.host_syncs``); ``profile=False`` skips
    the traced run (no device-busy time or idle share)."""
    from torch.profiler import ProfilerActivity, profile

    from tenzing_tpu_torch.obs.attrib.xplane import busy as union
    from tenzing_tpu_torch.obs.attrib.xplane import device_intervals

    ctx = getattr(ex, "inner", ex).ctx
    run_n = ex.prepare_n(order)
    run_n(5)
    syncs0 = ctx.host_syncs
    t0 = time.perf_counter()
    run_n(iters)
    wall = (time.perf_counter() - t0) / iters
    syncs = (ctx.host_syncs - syncs0) / iters
    if not profile:
        return {"ops": len(order), "wall_us": wall * 1e6,
                "host_syncs_per_iter": syncs}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_n(iters)
        traced_wall = (time.perf_counter() - t0) / iters
    spans, by_name, names = device_intervals(prof)
    busy = union(spans) / iters  # us per iteration
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"ops": len(order), "wall_us": wall * 1e6,
            "traced_wall_us": traced_wall * 1e6,
            "device_busy_us": busy if spans else None,
            "idle_share": (1.0 - busy / (traced_wall * 1e6)) if spans else None,
            "device_activities": len(spans), "host_syncs_per_iter": syncs,
            "overlap_us": (sum(b - a for a, b in spans) / iters - busy)
            if spans else None,
            "transfer_overlap_us": transfer_overlap(spans, names) / iters,
            "top": {name: us / iters for name, us in top}}


def transfer_overlap(spans, names, transfer: str = "device_copy") -> float:
    """The time (µs) during which a ``transfer`` kernel runs beside any
    other device activity.  Every ``.rdma`` post runs after a host wait
    (the flush of the pending sync of the pack it copies), so with graphs
    this is device work of two segments overlapping across that wait."""
    from tenzing_tpu_torch.obs.attrib.xplane import merge_intervals

    copies = [s for s, n in zip(spans, names) if transfer in n]
    rest = merge_intervals([s for s, n in zip(spans, names)
                            if transfer not in n])
    total = 0.0
    for a, b in copies:
        for c, d in rest:
            if c >= b:
                break
            total += max(0.0, min(b, d) - max(a, c))
    return total


def executors(platform, bufs):
    """(graph executor, eager executor) over the same buffers."""
    from tenzing_tpu_torch.runtime.executor import StreamExecutor

    return (StreamExecutor(platform, bufs, graphs=True),
            StreamExecutor(platform, bufs, graphs=False))


def _max_abs_diff(a, b) -> float:
    """The largest elementwise difference over the buffers both hold."""
    worst = 0.0
    for k in a:
        if a[k].is_floating_point():
            d = (a[k].double() - b[k].double()).abs()
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
        elif not bool((a[k] == b[k]).all()):
            worst = float("inf")
    return worst


def _measure(workload: str, pair, orders, opts: Opts, wrap=None) -> None:
    """One row per order: wall and device-busy time per iteration on the
    graph executor (top level) and on the eager one (``eager``), from
    ``pair`` (:func:`executors`; ``wrap`` turns each into the runner, e.g.
    a FusedExecutor), one run's outputs compared, the capture segments,
    and the stepped attribution (units run alone: the same for both)."""
    import torch

    from tenzing_tpu_torch.runtime import graphs

    g_ex, e_ex = pair if wrap is None else (wrap(pair[0]), wrap(pair[1]))
    inner = pair[0]
    for label, order in orders.items():
        row = {"workload": workload, "order": label,
               **measure(g_ex, order, opts.iters, opts.profile)}
        run_order = g_ex.fused_order(order) if wrap is not None else order
        segs = graphs.plan_segments(run_order.vector(), inner.host_names,
                                    inner.ctx.defer_host_syncs)
        row["segments"] = len(segs)
        row["graphs"] = sum(1 for seg in segs if seg.streams)
        row["eager"] = measure(e_ex, order, opts.iters, opts.profile)
        out_g, out_e = g_ex.run(order), e_ex.run(order)
        row["outputs_equal"] = all(torch.equal(out_g[k], out_e[k])
                                   for k in out_g)
        row["outputs_max_abs_diff"] = _max_abs_diff(out_g, out_e)
        del out_g, out_e
        if opts.attrib:
            row["attrib"] = attrib_of(e_ex, order, row["wall_us"])
        if opts.emit is not None:
            opts.emit(row)
        else:
            write_line(json.dumps(row))


def _halo(dev, opts: Opts) -> None:
    from tenzing_tpu_torch.bench.driver import halo_alias_prefer
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
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    args = HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3)
    bufs, _ = make_pipeline_buffers(args, seed=0, with_expected=False)
    pair = executors(Platform.make_n_lanes(8),
                     buffers_from_numpy(bufs, dev, host_buffer_names()))
    del bufs

    plat8 = Platform.make_n_lanes(8)
    _measure("halo", pair, {
        "naive": naive_order(args, plat8),
        "greedy-host-8l": greedy_overlap_order(args, plat8, "host"),
        "greedy-rdma-2l": greedy_overlap_order(args, Platform.make_n_lanes(2),
                                               "rdma"),
        "alias-8l": drive(build_graph(args, impl_choice=True, xfer_choice=True),
                          plat8, phase_policy(plat8, HALO_PHASES,
                                              halo_alias_prefer))[0],
    }, opts)


def _attn(dev, opts: Opts) -> None:
    from tenzing_tpu_torch.bench.driver import DriverRequest, attn_args, attn_graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.ring_attention import (
        fixed_orders,
        make_blocked_buffers,
    )
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy
    from tenzing_tpu_torch.runtime.fused import FusedExecutor

    args = attn_args(DriverRequest(workload="attn"))
    bufs, _ = make_blocked_buffers(args, seed=0, with_expected=False)
    pair = executors(Platform.make_n_lanes(2), buffers_from_numpy(bufs, dev))
    del bufs
    orders = fixed_orders(attn_graph(args), args.n_devices)
    _measure("attn", pair, {label: orders[label] for label in (
        "naive", "pallas_bf16", "fused", "fused_bf16")}, opts)
    _measure("attn", pair, {"fused-naive-t1": orders["naive"]}, opts,
             wrap=lambda ex: FusedExecutor(ex, tiles=1))


def _moe(dev, opts: Opts) -> None:
    from tenzing_tpu_torch.bench.driver import DriverRequest, moe_args
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.moe_pipeline import (
        chunked_orders,
        fixed_orders,
        host_buffer_names,
        make_pipe_buffers,
    )
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    args = moe_args(DriverRequest(workload="moe"))
    bufs, _, cap = make_pipe_buffers(args, seed=0, with_expected=False,
                                     staging="choice")
    pair = executors(Platform.make_n_lanes(2), buffers_from_numpy(
        bufs, dev, host_buffer_names(args, "choice")))
    del bufs
    orders = fixed_orders(args, cap)
    _measure("moe", pair, {label: orders[label][0] for label in (
        "naive", "greedy-overlap", "greedy-bf16-rdma", "greedy-f32-rdma",
        "pallas-bf16-rdma")}, opts)
    chunked, _ = chunked_orders(args, cap)
    _measure("moe", pair, {f"f32-host-xla-{k}": v for k, v in chunked.items()},
             opts)


def _spmv(dev, opts: Opts) -> None:
    from tenzing_tpu_torch.bench.driver import DriverRequest, build_spmv
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.spmv import fixed_orders
    from tenzing_tpu_torch.runtime.fused import FusedExecutor

    for m, labels in ((150_000, ("naive", "overlap-2l")),
                      (8192, ("naive", "pallas-2l"))):
        g, bufs, _, _ = build_spmv(DriverRequest(workload="spmv", m=m), dev)
        pair = executors(Platform.make_n_lanes(2), bufs)
        orders = fixed_orders(g)
        _measure(f"spmv_m{m}", pair,
                 {label: orders[label] for label in labels}, opts)
        if m == 150_000:
            _measure(f"spmv_m{m}", pair, {
                f"fused-{label}-t1": orders[label] for label in labels}, opts,
                wrap=lambda ex: FusedExecutor(ex, tiles=1))
        del pair, bufs


WORKLOADS = {"halo": _halo, "attn": _attn, "moe": _moe, "spmv": _spmv}


def main(argv=None) -> int:
    import torch

    from tenzing_tpu_torch.runtime.executor import resolve_device

    workloads = (argv if argv is not None else sys.argv[1:]) or list(WORKLOADS)
    unknown = set(workloads) - set(WORKLOADS)
    if unknown:
        raise SystemExit(f"unknown workload(s) {sorted(unknown)}: "
                         + ", ".join(WORKLOADS))
    dev = resolve_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    write_line(smi)
    for w in workloads:
        WORKLOADS[w](dev, Opts())
        torch.cuda.empty_cache()
    write_line(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
