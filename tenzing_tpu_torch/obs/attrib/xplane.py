"""Device-side profiling: a ``torch.profiler`` capture of a schedule and its
transfer/compute concurrency.

Counterpart of ``tenzing_tpu/obs/attrib/xplane.py``, whose reader parses a
TPU's xplane file; here the device activities come from ``torch.profiler``
(CUPTI) and this module is the one reader of them: ``bench/breakdown.py``
takes its intervals and union from here.  The stepped timeline
(timeline.py) is the attribution profiler's main source and is
single-device only; a capture works wherever the profiler attaches, and
attributes by kernel name instead of schedule position.

:func:`analyze_trace` classes each device activity by its name: transfers
(memcpy, the device copy kernel, the mesh shift, NCCL) and the rest, which
is compute.  Intervals are merged before they are intersected, so each
nanosecond counts once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence as Seq, Tuple

TRANSFER_KEYWORDS = ("memcpy", "memset", "device_copy", "rdma", "shift",
                     "nccl", "all_to_all", "alltoall", "allreduce",
                     "sendrecv", "gloo")


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and signature."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut]


def device_intervals(prof) -> Tuple[List[Tuple[float, float]],
                                    Dict[str, float], List[str]]:
    """``(intervals, per-name totals, names)`` of every device activity in a
    ``torch.profiler`` profile: (start, end) in microseconds, the summed
    duration per :func:`short_name`, and each interval's name."""
    from torch.autograd import DeviceType

    spans, by_name, names = [], {}, []
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        start, end = float(e.time_range.start), float(e.time_range.end)
        spans.append((start, end))
        name = short_name(e.name)
        names.append(name)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    return spans, by_name, names


def merge_intervals(ivs: Seq[Tuple[float, float]]) -> List[List[float]]:
    """Coalesce intervals so busy time and intersections count each instant
    once."""
    out: List[List[float]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy(ivs: Seq[Tuple[float, float]]) -> float:
    """The length of the union of ``ivs``."""
    return sum(b - a for a, b in merge_intervals(ivs))


def capture_trace(executor, order, iters: int = 3):
    """Run ``order`` ``iters`` times under ``torch.profiler`` (CPU and CUDA
    activities) after one warm run outside it; returns ``(profile, wall
    seconds)``."""
    import time

    from torch.profiler import ProfilerActivity, profile

    run_n = executor.prepare_n(order)
    run_n(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_n(iters)
        wall = time.perf_counter() - t0
    return prof, wall


def analyze_trace(prof) -> Dict[str, float]:
    """Transfer-vs-compute concurrency over the device activities of a
    capture (module docstring), in milliseconds."""
    spans, _, names = device_intervals(prof)
    xfers, computes = [], []
    for iv, nm in zip(spans, names):
        if iv[1] <= iv[0]:
            continue
        low = nm.lower()
        (xfers if any(k in low for k in TRANSFER_KEYWORDS)
         else computes).append(iv)
    overlap = 0.0
    computes_merged = merge_intervals(computes)
    for a, b in merge_intervals(xfers):
        for c, d in computes_merged:
            if c >= b:
                break
            lo, hi = max(a, c), min(b, d)
            if hi > lo:
                overlap += hi - lo
    return {
        "n_transfer_events": len(xfers),
        "n_compute_events": len(computes),
        "transfer_busy_ms": busy(xfers) / 1e3,
        "compute_busy_ms": busy(computes) / 1e3,
        "device_busy_ms": busy(spans) / 1e3,
        "transfer_concurrent_with_compute_ms": overlap / 1e3,
    }
