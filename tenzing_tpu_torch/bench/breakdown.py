"""Where one halo iteration's time goes on the card.

``python -m tenzing_tpu_torch.bench.breakdown`` builds the flagship pipeline
(nQ=3, 512^3 cells, radius 3), runs a few fixed schedules through the stream
executor, and prints one JSON line per schedule:

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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    from tenzing_tpu_torch.runtime.executor import (
        StreamExecutor,
        buffers_from_numpy,
        resolve_device,
    )
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    dev = resolve_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    args = HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3)
    bufs, _ = make_pipeline_buffers(args, seed=0, with_expected=False)
    ex = StreamExecutor(Platform.make_n_lanes(8),
                        buffers_from_numpy(bufs, dev, host_buffer_names()))
    del bufs

    def prefer_alias(op_name, choices):
        if op_name.startswith("xfer_"):
            return next(c for c in choices if c.endswith(".rdma"))
        if op_name.startswith("unpack_"):
            return alias_unpack_choice(op_name, choices)
        return next(c for c in choices if c.endswith(".xla"))

    plat8 = Platform.make_n_lanes(8)
    orders = {
        "naive": naive_order(args, plat8),
        "greedy-host-8l": greedy_overlap_order(args, plat8, "host"),
        "greedy-rdma-2l": greedy_overlap_order(args, Platform.make_n_lanes(2),
                                               "rdma"),
        "alias-8l": drive(build_graph(args, impl_choice=True, xfer_choice=True),
                          plat8, phase_policy(plat8, HALO_PHASES,
                                              prefer_alias))[0],
    }
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
            "order": label, "ops": len(order), "wall_us": wall * 1e6,
            "traced_wall_us": traced_wall * 1e6,
            "device_busy_us": busy if spans else None,
            "idle_share": (1.0 - busy / (traced_wall * 1e6)) if spans else None,
            "device_activities": len(spans),
            "top": {name: us / ITERS for name, us in top},
        }), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
