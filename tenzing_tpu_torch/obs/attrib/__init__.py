"""Schedule attribution: per-op timelines, critical path and overlap,
winner-vs-naive explanation.

Counterpart of ``tenzing_tpu/obs/attrib/``:

* :mod:`~tenzing_tpu_torch.obs.attrib.timeline` — the timed mode: every
  unit of a schedule run alone through ``StreamExecutor.op_stepped``, an
  :class:`OpTimeline` of (op, lane, start, duration) records;
* :mod:`~tenzing_tpu_torch.obs.attrib.analysis` — Gantt on the verifier's
  happens-before relation, critical path, overlap efficiency, dispatch
  overhead, the roofline join;
* :mod:`~tenzing_tpu_torch.obs.attrib.explain` — the winner-vs-naive
  decision diff, the three-term timing split, ``explain.json``, per-lane
  Perfetto tracks;
* :mod:`~tenzing_tpu_torch.obs.attrib.xplane` — a ``torch.profiler``
  capture and its transfer/compute concurrency.

The driver's ``--profile-winner`` writes the ``attrib`` block of its JSON
line (and with ``--trace-out`` the ``explain.json`` and the tracks).
"""

from tenzing_tpu_torch.obs.attrib.analysis import Attribution, analyze, lane_label
from tenzing_tpu_torch.obs.attrib.explain import (
    diff_schedules,
    explain,
    timeline_trace_events,
    write_explain,
)
from tenzing_tpu_torch.obs.attrib.timeline import (
    OpRecord,
    OpTimeline,
    fetch_overhead_us,
    stepped_timeline,
)
from tenzing_tpu_torch.obs.attrib.xplane import (
    analyze_trace,
    capture_trace,
    merge_intervals,
)

__all__ = [
    "Attribution",
    "OpRecord",
    "OpTimeline",
    "analyze",
    "analyze_trace",
    "capture_trace",
    "diff_schedules",
    "explain",
    "fetch_overhead_us",
    "lane_label",
    "merge_intervals",
    "stepped_timeline",
    "timeline_trace_events",
    "write_explain",
]
