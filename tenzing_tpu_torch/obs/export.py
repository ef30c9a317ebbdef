"""Trace sinks: JSONL for programs, Chrome trace-event JSON for people.

Counterpart of ``tenzing_tpu/obs/export.py`` without the cross-process
stitcher (it waits for the serve plane).

* :func:`to_jsonl` / :func:`write_jsonl` / :func:`read_jsonl` — one JSON
  record per line (spans and events, timestamp-ordered); the round trip
  the tests hold.
* :func:`chrome_trace` / :func:`write_chrome_trace` — the trace-event
  format Perfetto and ``chrome://tracing`` load: spans as complete events
  (``ph: "X"``), events as instants, one process row per rank, named thread
  rows, plus any pre-built events (the attribution profiler's per-lane
  tracks, obs/attrib/explain.py ``timeline_trace_events``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from tenzing_tpu_torch.obs.tracer import Tracer


def _snapshot(tracer: Tracer):
    """One consistent read of the tracer for both sinks.  Non-blocking
    (``block=False``): export also runs at exit, where an interrupted
    thread may hold the tracer lock.
    ``flush_open`` closes copies of all in-flight spans so an interrupted
    run's bundle keeps them (marked ``flushed: true``) and every exported
    ``parent`` id resolves to an exported span."""
    spans, events, open_spans = tracer.snapshot(block=False, flush_open=True)
    return spans + open_spans, events


def _records(tracer: Tracer) -> List[Dict[str, Any]]:
    spans, events = _snapshot(tracer)
    recs = [s.to_json() for s in spans]
    recs += [e.to_json() for e in events]
    recs.sort(key=lambda r: r["ts_us"])
    return recs


def to_jsonl(tracer: Tracer) -> str:
    """All records, one JSON object per line, timestamp-ordered."""
    return "".join(
        json.dumps(r, sort_keys=True, default=str) + "\n"
        for r in _records(tracer)
    )


def write_jsonl(tracer: Tracer, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_jsonl(tracer))


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL bundle back to record dicts (the round-trip contract)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


def _category(name: str) -> str:
    """Perfetto category = the subsystem prefix of the record name
    ("mcts.iter" -> "mcts"); names without a dot categorize as themselves."""
    return name.split(".", 1)[0]


def _track_name(tid: int, lanes: Dict[int, int]) -> str:
    """Human name of a thread track: spans that carried a ``lane``
    attribute name their track after the lane; plain threads keep a
    ``thread N`` label (tid 0 — the main thread everywhere in this
    codebase — reads as ``main``)."""
    if tid in lanes:
        return f"lane {lanes[tid]}"
    return "main" if tid == 0 else f"thread {tid}"


def chrome_trace(tracer: Tracer,
                 extra_events: List[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The trace as a Chrome trace-event object (see module docstring).

    Tracks are NAMED (``thread_name`` metadata per (pid, tid), on top of
    the per-rank ``process_name`` rows): a span whose attrs carry a
    ``lane`` names its track ``lane N``, so attribution timelines
    (obs/attrib/explain.py ``timeline_trace_events`` — passed in via
    ``extra_events``, which may carry their own ``M`` metadata) and the
    ordinary spans render as one grouped per-rank trace instead of flat
    anonymous thread rows."""
    trace_events: List[Dict[str, Any]] = []
    pids = set()
    tids = set()  # (pid, tid) pairs needing a thread_name row
    lane_of: Dict[int, int] = {}  # tid -> lane id, when a span declares one
    spans, events = _snapshot(tracer)
    for sp in spans:
        pids.add(sp.pid)
        tids.add((sp.pid, sp.tid))
        lane = sp.attrs.get("lane")
        if isinstance(lane, int):
            lane_of[sp.tid] = lane
        trace_events.append({
            "name": sp.name,
            "cat": _category(sp.name),
            "ph": "X",
            "ts": sp.ts_us,
            "dur": sp.dur_us,
            "pid": sp.pid,
            "tid": sp.tid,
            "args": sp.attrs,
        })
    for ev in events:
        pids.add(ev.pid)
        tids.add((ev.pid, ev.tid))
        trace_events.append({
            "name": ev.name,
            "cat": _category(ev.name),
            "ph": "i",
            "ts": ev.ts_us,
            "pid": ev.pid,
            "tid": ev.tid,
            "s": "t",  # thread-scoped instant
            "args": ev.attrs,
        })
    extra_meta: List[Dict[str, Any]] = []
    for e in extra_events or []:
        if e.get("ph") == "M":
            extra_meta.append(e)
            continue
        pids.add(e.get("pid", 0))
        trace_events.append(e)
    trace_events.sort(key=lambda e: e["ts"])
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": f"rank {pid}"}}
        for pid in sorted(pids)
    ]
    meta += [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": _track_name(tid, lane_of)}}
        for pid, tid in sorted(tids)
    ]
    meta += extra_meta
    return {"traceEvents": meta + trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: Tracer, path: str,
                       extra_events: List[Dict[str, Any]] = None) -> None:
    """Write the Perfetto-loadable trace; ``extra_events`` appends
    pre-built trace-event dicts (e.g. the attribution profiler's per-lane
    Gantt tracks) into the same bundle."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, extra_events=extra_events), f,
                  default=str)
