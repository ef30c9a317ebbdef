"""Telemetry: span/event tracing, metrics, progress lines, export.

Counterpart of ``tenzing_tpu/obs/__init__.py``:

* :mod:`~tenzing_tpu_torch.obs.tracer` — nested spans and instant events,
  thread-safe, a no-op while disabled; every record carries the control
  plane's rank;
* :mod:`~tenzing_tpu_torch.obs.context` — the trace context stamped onto
  every record while it is ambient;
* :mod:`~tenzing_tpu_torch.obs.metrics` — counters, gauges and histograms
  with percentile summaries (``utils/counters.py`` mirrors the solvers'
  phase timings into it), and the ring of metric snapshots a long-lived
  process writes (with its SLO block);
* :mod:`~tenzing_tpu_torch.obs.progress` — progress lines that also go to
  the tracer's event stream;
* :mod:`~tenzing_tpu_torch.obs.export` — JSONL and Chrome trace-event sinks,
  and the cross-process stitcher (``python -m tenzing_tpu_torch.obs.export``);
* :mod:`~tenzing_tpu_torch.obs.causal` — each request's critical path rebuilt
  from the bundles, segment by segment (``python -m
  tenzing_tpu_torch.obs.causal``);
* :mod:`~tenzing_tpu_torch.obs.alerts` — the alert rules over status and
  snapshot documents, and their firing/resolved ledger (``python -m
  tenzing_tpu_torch.obs.alerts check``);
* :mod:`~tenzing_tpu_torch.obs.noise` — the host's measured latency floors;
* :mod:`~tenzing_tpu_torch.obs.report` — the corpus report and the
  regression check (``python -m tenzing_tpu_torch.obs.report``).

The driver writes them with ``--trace-out DIR`` (``trace.jsonl``,
``trace.json``) and ``--metrics-json PATH``.  Everything here is stdlib
only; :mod:`~tenzing_tpu_torch.obs.attrib` (the attribution profiler) is
imported on its own, since it needs torch.
"""

from tenzing_tpu_torch.obs.context import TraceContext, new_trace
from tenzing_tpu_torch.obs.export import (
    chrome_trace,
    read_jsonl,
    stitch,
    to_jsonl,
    write_chrome_trace,
    write_jsonl,
)
from tenzing_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    MetricsSnapshotWriter,
    SloConfig,
    get_metrics,
    latest_snapshots,
    set_metrics,
    snapshot_history,
)
from tenzing_tpu_torch.obs.progress import ProgressReporter, get_reporter, set_reporter
from tenzing_tpu_torch.obs.tracer import Event, Span, Tracer, configure, get_tracer, set_tracer

__all__ = [
    "Counter",
    "Event",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsSnapshotWriter",
    "ProgressReporter",
    "SloConfig",
    "Span",
    "TraceContext",
    "Tracer",
    "chrome_trace",
    "configure",
    "get_metrics",
    "get_reporter",
    "get_tracer",
    "latest_snapshots",
    "new_trace",
    "read_jsonl",
    "set_metrics",
    "set_reporter",
    "set_tracer",
    "snapshot_history",
    "stitch",
    "to_jsonl",
    "write_chrome_trace",
    "write_jsonl",
]
