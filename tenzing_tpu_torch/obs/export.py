"""Trace sinks: JSONL for programs, Chrome trace-event JSON for people.

Counterpart of ``tenzing_tpu/obs/export.py``; what one package writes,
the other reads and stitches.

* :func:`to_jsonl` / :func:`write_jsonl` / :func:`read_jsonl` — one JSON
  record per line (spans and events, timestamp-ordered); the round trip
  the tests hold.
* :func:`chrome_trace` / :func:`write_chrome_trace` — the trace-event
  format Perfetto and ``chrome://tracing`` load: spans as complete events
  (``ph: "X"``), events as instants, one process row per rank, named thread
  rows, plus any pre-built events (the attribution profiler's per-lane
  tracks, obs/attrib/explain.py ``timeline_trace_events``).
* :func:`stitch` / ``python -m tenzing_tpu_torch.obs.export`` — the
  cross-process merge: each process's JSONL bundle (the listen loop's, a
  drain daemon's, a drain child's) becomes its own Perfetto process row,
  and records stamped with a ``trace_id`` (obs/context.py) are tied
  together with flow arrows, so one request reads as one line from the
  cold query through the subprocess drain to the store merge.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

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


# -- cross-process trace stitching ------------------------------------------

def stitch_records(
        bundles: List[Tuple[str, List[Dict[str, Any]]]],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Merge per-process JSONL record lists into one Chrome trace-event
    document (module docstring).  ``bundles`` is ``(label, records)``
    per process — each gets its own Perfetto pid (the in-bundle rank
    pids would collide: every fleet process is its own rank 0).

    Returns ``(chrome_doc, summary)``; the summary indexes every
    ``trace_id`` seen — which processes it touched, which span/event
    names carried it — and is what the CI smoke asserts the
    ingress→drain→store-merge linkage on."""
    events: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = []
    traces: Dict[str, Dict[str, Any]] = {}
    # (trace_id -> [(ts, pid, tid)]) anchors for the flow arrows
    flow_anchors: Dict[str, List[Tuple[float, int, int]]] = {}
    for pid, (label, recs) in enumerate(bundles):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": label}})
        lane_of: Dict[int, int] = {}
        tids = set()
        for r in recs:
            kind = r.get("kind")
            if kind not in ("span", "event"):
                continue
            attrs = r.get("attrs") or {}
            tid = int(r.get("tid", 0))
            tids.add(tid)
            lane = attrs.get("lane")
            if isinstance(lane, int):
                lane_of[tid] = lane
            ev: Dict[str, Any] = {
                "name": r.get("name", "?"),
                "cat": _category(r.get("name", "?")),
                "ts": r.get("ts_us", 0.0),
                "pid": pid,
                "tid": tid,
                "args": attrs,
            }
            if kind == "span":
                ev["ph"] = "X"
                ev["dur"] = r.get("dur_us", 0.0)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
            tid_trace = attrs.get("trace_id")
            if isinstance(tid_trace, str) and tid_trace:
                t = traces.setdefault(tid_trace, {
                    "processes": set(), "names": set(), "records": 0})
                t["processes"].add(label)
                t["names"].add(r.get("name", "?"))
                t["records"] += 1
                if kind == "span":
                    flow_anchors.setdefault(tid_trace, []).append(
                        (float(r.get("ts_us", 0.0)), pid, tid))
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
                  "args": {"name": _track_name(t, lane_of)}}
                 for t in sorted(tids)]
    # flow arrows: one s → t... → f chain per trace, anchored at the
    # start of each span that carried it, in timestamp order — Perfetto
    # draws the request's journey across the process rows
    flows: List[Dict[str, Any]] = []
    for trace_id, anchors in flow_anchors.items():
        anchors.sort()
        if len(anchors) < 2:
            continue
        for i, (ts, pid, tid) in enumerate(anchors):
            ph = "s" if i == 0 else ("f" if i == len(anchors) - 1 else "t")
            flow = {"name": f"trace {trace_id[:8]}", "cat": "trace",
                    "ph": ph, "id": trace_id, "ts": ts, "pid": pid,
                    "tid": tid}
            if ph == "f":
                flow["bp"] = "e"  # bind to the enclosing slice
            flows.append(flow)
    events.sort(key=lambda e: e["ts"])
    doc = {"traceEvents": meta + flows + events, "displayTimeUnit": "ms"}
    summary = {
        "bundles": [label for label, _ in bundles],
        "records": sum(len(r) for _, r in bundles),
        "traces": {
            tid: {
                "processes": sorted(t["processes"]),
                "n_processes": len(t["processes"]),
                "names": sorted(t["names"]),
                "records": t["records"],
            }
            for tid, t in sorted(traces.items())
        },
    }
    return doc, summary


def _bundle_labels(paths: List[str]) -> List[str]:
    """Unique human labels: the basename where unique; colliding groups
    grow leading path components until they separate (every drain child
    writes ``ckpt-<exact>/trace/trace.jsonl``, so one parent directory
    is NOT enough — identical labels would merge two processes' rows
    and undercount a trace's process span); pathologically identical
    paths fall back to an index prefix."""

    def suffix(p: str, depth: int) -> str:
        parts = os.path.normpath(p).split(os.sep)
        return "/".join(parts[-depth:] if depth < len(parts) else parts)

    labels = [os.path.basename(p) for p in paths]
    max_depth = max(len(os.path.normpath(p).split(os.sep)) for p in paths)
    depth = 2
    while len(set(labels)) < len(labels) and depth <= max_depth:
        dupes = {l for l in labels if labels.count(l) > 1}
        labels = [suffix(p, depth) if l in dupes else l
                  for l, p in zip(labels, paths)]
        depth += 1
    if len(set(labels)) < len(labels):
        labels = [f"{i}:{l}" for i, l in enumerate(labels)]
    return labels


def stitch(paths: List[str], out_path: Optional[str] = None,
           labels: Optional[List[str]] = None) -> Dict[str, Any]:
    """Stitch JSONL bundle files into one Perfetto trace (written to
    ``out_path`` when given); returns the per-trace summary.  Labels
    default to the bundles' basenames, grown with leading path
    components until unique (:func:`_bundle_labels`)."""
    if labels is None:
        labels = _bundle_labels(paths)
    bundles = [(label, read_jsonl(p)) for label, p in zip(labels, paths)]
    doc, summary = stitch_records(bundles)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(doc, f, default=str)
        summary["out"] = out_path
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tenzing_tpu_torch.obs.export",
        description="Stitch per-process telemetry JSONL bundles into one "
                    "Perfetto trace, grouped by trace_id.")
    ap.add_argument("bundles", nargs="+", metavar="GLOB",
                    help="JSONL bundle files (the driver's --trace-out, serve "
                         "listen --trace-out, daemon --trace-out)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the merged Perfetto trace here")
    args = ap.parse_args(argv)
    paths: List[str] = []
    for pat in args.bundles:
        hits = sorted(_glob.glob(pat))
        paths.extend(hits if hits else
                     ([pat] if os.path.exists(pat) else []))
    if not paths:
        sys.stderr.write("export: no bundles matched\n")
        return 2
    summary = stitch(paths, out_path=args.out)
    sys.stdout.write(json.dumps(summary, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
