"""Where one iteration's time goes on the card.

``python -m tenzing_tpu_torch.bench.breakdown [halo|attn|moe ...]``
(default: all three) builds the workload at its full size — the halo
pipeline (nQ=3, 512^3 cells, radius 3), blocked attention (batch 4, 8k
context in 8 blocks of 1024, head dim 128) or the MoE pipeline (8 experts,
8192 tokens, d_model 512, d_ff 2048, 4 chunks) — runs a few fixed schedules
through the stream executor (halo: naive, greedy host 8 lanes, greedy rdma 2
lanes, alias 8 lanes; attn: naive all-``.xla``, the ``.pallas_bf16`` chain,
the fused kernel in f32 and bf16; moe on 2 lanes: naive, greedy overlap,
greedy bf16 and f32 device copy, and the bf16 device-copy order with every
expert MLP on the ``ffn_batched`` kernel), and prints one JSON line per
schedule:

* ``wall_us`` — host wall time per iteration of ``run_n`` (what the driver's
  metric measures, fence included);
* ``device_busy_us`` — the union of all device activity (kernels and copies,
  on every stream) per iteration, from a ``torch.profiler`` trace of a
  separate run;
* ``idle_share`` — 1 - busy / wall over that traced run: how much of the
  iteration the card waits on the host;
* ``top`` — device time per activity name, per iteration.

The card's name and power limit lead the output.  It needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Dict, List, Tuple

ITERS = 50


def _device_intervals(prof) -> Tuple[List[Tuple[float, float]], Dict[str, float]]:
    """(start, end) in microseconds of every device activity in the trace,
    and the summed duration per activity name."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        start, end = float(e.time_range.start), float(e.time_range.end)
        spans.append((start, end))
        name = _short(e.name)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    return spans, by_name


def _short(name: str) -> str:
    """A kernel's name without its return type, template and signature."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut]


def _union(spans: List[Tuple[float, float]]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _measure(workload: str, ex, orders) -> None:
    """One JSON line per order: wall and device-busy time per iteration."""
    from torch.profiler import ProfilerActivity, profile

    for label, order in orders.items():
        run_n = ex.prepare_n(order)
        run_n(5)
        t0 = time.perf_counter()
        run_n(ITERS)
        wall = (time.perf_counter() - t0) / ITERS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_n(ITERS)
            traced_wall = (time.perf_counter() - t0) / ITERS
        spans, by_name = _device_intervals(prof)
        busy = _union(spans) / ITERS  # us per iteration
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(json.dumps({
            "workload": workload, "order": label, "ops": len(order),
            "wall_us": wall * 1e6, "traced_wall_us": traced_wall * 1e6,
            "device_busy_us": busy if spans else None,
            "idle_share": (1.0 - busy / (traced_wall * 1e6)) if spans else None,
            "device_activities": len(spans),
            "top": {name: us / ITERS for name, us in top},
        }), flush=True)


def _halo(dev) -> None:
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
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    args = HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3)
    bufs, _ = make_pipeline_buffers(args, seed=0, with_expected=False)
    ex = StreamExecutor(Platform.make_n_lanes(8),
                        buffers_from_numpy(bufs, dev, host_buffer_names()))
    del bufs

    plat8 = Platform.make_n_lanes(8)
    _measure("halo", ex, {
        "naive": naive_order(args, plat8),
        "greedy-host-8l": greedy_overlap_order(args, plat8, "host"),
        "greedy-rdma-2l": greedy_overlap_order(args, Platform.make_n_lanes(2),
                                               "rdma"),
        "alias-8l": drive(build_graph(args, impl_choice=True, xfer_choice=True),
                          plat8, phase_policy(plat8, HALO_PHASES,
                                              halo_alias_prefer))[0],
    })


def _attn(dev) -> None:
    from tenzing_tpu_torch.bench.driver import DriverRequest, attn_args, attn_graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.ring_attention import (
        fixed_orders,
        make_blocked_buffers,
    )
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

    args = attn_args(DriverRequest(workload="attn"))
    bufs, _ = make_blocked_buffers(args, seed=0, with_expected=False)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(bufs, dev))
    del bufs
    orders = fixed_orders(attn_graph(args), args.n_devices)
    _measure("attn", ex, {label: orders[label] for label in (
        "naive", "pallas_bf16", "fused", "fused_bf16")})


def _moe(dev) -> None:
    from tenzing_tpu_torch.bench.driver import DriverRequest, moe_args
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.moe_pipeline import (
        fixed_orders,
        host_buffer_names,
        make_pipe_buffers,
    )
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

    args = moe_args(DriverRequest(workload="moe"))
    bufs, _, cap = make_pipe_buffers(args, seed=0, with_expected=False,
                                     staging="choice")
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(
        bufs, dev, host_buffer_names(args, "choice")))
    del bufs
    orders = fixed_orders(args, cap)
    _measure("moe", ex, {label: orders[label][0] for label in (
        "naive", "greedy-overlap", "greedy-bf16-rdma", "greedy-f32-rdma",
        "pallas-bf16-rdma")})


WORKLOADS = {"halo": _halo, "attn": _attn, "moe": _moe}


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
    print(smi, flush=True)
    for w in workloads:
        WORKLOADS[w](dev)
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
