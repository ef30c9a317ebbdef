"""Causal latency analysis: ``python -m tenzing_tpu_torch.obs.causal``.

Counterpart of ``tenzing_tpu/obs/causal.py``, the same segment taxonomy,
document (``CAUSAL_VERSION``) and exit codes.  One ``trace_id`` spans every
process a request touches (obs/context.py); this module rebuilds each
trace's timeline as an ordered chain of segments, gives every microsecond
to a named segment with an explicit ``unattributed`` residual, aggregates
over a corpus, and names the segment that moved between two measurement
documents.

**Segments** (the chain a cold request walks end to end)::

    ingress -> fingerprint -> cache_probe -> store_walk -> [enqueue]
            -> queue_wait -> drain(search/compile/measure) -> merge

* ``ingress`` — the ``serve.query`` span before its first named child:
  admission, envelope parse, dispatch.
* ``fingerprint`` / ``cache_probe`` / ``serialize`` — the resolver's and
  the transport's sub-spans, as they are.
* ``fast_path`` — a memoized exact hit's whole resolve.  The fast path
  emits its ``serve.query`` span afterwards with ~0 duration (the latency
  rides the ``resolve_us`` attribute, serve/resolver.py), so the interval
  is rebuilt from the attribute.
* ``store_walk`` — the rest of ``serve.query`` after its first named
  child: the store walk, the near tier's pricing, the cold enqueue write.
* ``enqueue`` — the ``serve.enqueue`` event, a zero-duration marker: the
  instant the work item became durable.
* ``queue_wait`` — from the enqueue event to the start of the
  ``daemon.drain`` span: the time the item sat in the queue before a
  daemon claimed it (obs/alerts.py ``queue_backlog_burn`` reads the same).
* ``search`` / ``compile`` / ``measure`` — the drain child's phases: the
  solver, executor and benchmarker spans, grouped by prefix.  The
  executor's span is ``executor.compile`` when it captures CUDA graphs and
  ``executor.build`` when it runs eagerly; both are ``compile``, as are
  ``pipeline.precompile`` and ``fused.plan``.
* ``merge`` — ``serve.store.flush``: the store merge that makes the answer
  queryable, the chain's servable point.
* ``drain`` — the rest of the ``daemon.drain`` span (claim, checkpoint
  bookkeeping, the subprocess's start).
* ``unattributed`` — time inside the trace's window that no record
  covers.  Always explicit: coverage = 1 - unattributed / window, and a
  low coverage is itself a finding (a span the code lacks, or records the
  tracer's rings dropped).

Overlapping records are resolved by a priority sweep (the specific beats
the broad: a ``bench.benchmark`` microsecond is ``measure``, not
``drain``), so every microsecond is counted once.

**Localization** (:func:`localize_phases` / :func:`localize_segments`):
given two replay documents (or two analyzed corpora), name the segment
that moved.  A segment moved only past a coarse bar — a pct99 ratio of at
least ``PHASE_REGRESSION_RATIO`` and an absolute delta above the measured
wake floor — since per-phase microsecond percentiles swing with host noise
far more than paired ratios.  The replay regression check
(obs/report.py ``check_serve_regression``) folds the result into its
reasons.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

from tenzing_tpu_torch.obs.export import read_jsonl
from tenzing_tpu_torch.utils.numeric import percentile

CAUSAL_VERSION = 1

# span name -> (segment, priority).  Higher priority wins a contested
# microsecond in the sweep; broad containers (daemon.drain) sit below
# their phase children, derived intervals (queue_wait, fast_path) sit
# between, and ingress/store_walk (derived from serve.query) at the
# bottom.
_PRIO_LEAF = 3       # named sub-spans: fingerprint, measure, merge, ...
_PRIO_DERIVED = 2    # queue_wait, fast_path
_PRIO_BROAD = 1      # drain remainder, ingress/store_walk remainder

SPAN_SEGMENTS: Dict[str, str] = {
    "serve.fingerprint": "fingerprint",
    "serve.cache_probe": "cache_probe",
    "serve.serialize": "serialize",
    "serve.store.flush": "merge",
    "serve.compaction": "merge",
    "learn.train": "search",
}

# prefix fallbacks for the drain child's solver/executor/benchmarker
# spans (one entry covers every mcts.iter etc. without enumerating)
PREFIX_SEGMENTS: List[Tuple[str, str]] = [
    ("mcts.", "search"),
    ("dfs.", "search"),
    ("learn.", "search"),
    ("executor.", "compile"),
    ("pipeline.", "compile"),
    ("fused.", "compile"),
    ("bench.", "measure"),
    ("attrib.", "measure"),
]

# localization bar (module docstring): phase percentiles are noisy
# microsecond quantities, so a phase is only *moved* past a 2x pct99
# ratio AND an absolute delta above the host's measured wake floor
# (fallback ABS floor when no host_noise block is recorded)
PHASE_REGRESSION_RATIO = 2.0
PHASE_ABS_FLOOR_US = 5.0
# percentiles over fewer than this many observations are not compared
MIN_PHASE_COUNT = 8


def _segment_of(name: str) -> Optional[str]:
    seg = SPAN_SEGMENTS.get(name)
    if seg is not None:
        return seg
    for prefix, s in PREFIX_SEGMENTS:
        if name.startswith(prefix):
            return s
    return None


def _trace_of(rec: Dict[str, Any]) -> Optional[str]:
    tid = (rec.get("attrs") or {}).get("trace_id")
    return tid if isinstance(tid, str) and tid else None


def group_by_trace(records: Iterable[Dict[str, Any]]
                   ) -> Dict[str, List[Dict[str, Any]]]:
    """Span/event records bucketed by the ``trace_id`` their attrs
    carry (obs/context.py stamps it while a context is ambient);
    records without one — process-local housekeeping — are dropped."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        if rec.get("kind") not in ("span", "event"):
            continue
        tid = _trace_of(rec)
        if tid is None:
            continue
        out.setdefault(tid, []).append(rec)
    return out


def _intervals_for(recs: List[Dict[str, Any]]
                   ) -> Tuple[List[Tuple[float, float, str, int]],
                              List[Dict[str, Any]],
                              Dict[str, Any]]:
    """One trace's attributable intervals ``(start, end, segment,
    priority)``, its zero-duration chain markers, and the metadata
    mined along the way (tier/workload/query count/servable end)."""
    intervals: List[Tuple[float, float, str, int]] = []
    markers: List[Dict[str, Any]] = []
    queries: List[Dict[str, Any]] = []
    drains: List[Tuple[float, float]] = []
    enqueues: List[float] = []
    merge_ends: List[float] = []
    meta: Dict[str, Any] = {"tiers": [], "workloads": [], "queries": 0}

    spans = [r for r in recs if r.get("kind") == "span"]
    events = [r for r in recs if r.get("kind") == "event"]
    for r in spans:
        name = r.get("name", "")
        try:
            ts = float(r.get("ts_us", 0.0))
            dur = max(0.0, float(r.get("dur_us", 0.0)))
        except (TypeError, ValueError):
            continue
        attrs = r.get("attrs") or {}
        if name == "serve.query":
            meta["queries"] += 1
            tier = attrs.get("tier")
            if tier and tier not in meta["tiers"]:
                meta["tiers"].append(tier)
            wl = attrs.get("workload")
            if wl and wl not in meta["workloads"]:
                meta["workloads"].append(wl)
            if attrs.get("fast_path"):
                # post-hoc span: ~0 duration by design, the latency
                # rides resolve_us (serve/resolver.py) — synthesize
                # the interval it would have covered
                try:
                    res_us = max(0.0, float(attrs.get("resolve_us", 0.0)))
                except (TypeError, ValueError):
                    res_us = 0.0
                end = ts + dur
                intervals.append((end - res_us, end, "fast_path",
                                  _PRIO_DERIVED))
            else:
                queries.append({"start": ts, "end": ts + dur})
        elif name == "daemon.drain":
            drains.append((ts, ts + dur))
            intervals.append((ts, ts + dur, "drain", _PRIO_BROAD))
        else:
            seg = _segment_of(name)
            if seg is not None and dur > 0:
                intervals.append((ts, ts + dur, seg, _PRIO_LEAF))
                if seg == "merge":
                    merge_ends.append(ts + dur)
    for r in events:
        name = r.get("name", "")
        try:
            ts = float(r.get("ts_us", 0.0))
        except (TypeError, ValueError):
            continue
        if name == "serve.enqueue":
            enqueues.append(ts)
            markers.append({"segment": "enqueue", "ts_us": ts})
        elif name in ("serve.shed", "serve.queue.torn_item"):
            markers.append({"segment": name.split(".")[-1], "ts_us": ts})

    # serve.query remainder: before the first leaf child -> ingress,
    # after it -> store_walk (walk + near pricing + cold enqueue write)
    for q in queries:
        children = [iv for iv in intervals
                    if iv[3] == _PRIO_LEAF
                    and iv[0] >= q["start"] and iv[1] <= q["end"]]
        first = min((iv[0] for iv in children), default=q["end"])
        if first > q["start"]:
            intervals.append((q["start"], first, "ingress", _PRIO_BROAD))
        if q["end"] > first:
            intervals.append((first, q["end"], "store_walk", _PRIO_BROAD))

    # queue wait: enqueue event -> the first drain claiming it after
    drains.sort()
    for te in sorted(enqueues):
        td = next((s for s, _ in drains if s >= te), None)
        if td is not None and td > te:
            intervals.append((te, td, "queue_wait", _PRIO_DERIVED))
        elif td is None and drains:
            # drains exist but all started before the enqueue: the item
            # is still waiting — leave the tail unattributed (visible)
            pass
    meta["servable_end"] = max(merge_ends) if merge_ends else None
    meta["pending"] = bool(enqueues) and not drains
    return intervals, markers, meta


def _sweep(intervals: List[Tuple[float, float, str, int]],
           t0: float, t1: float) -> List[Dict[str, Any]]:
    """Priority sweep over ``[t0, t1]``: each elementary slice goes to
    the highest-priority covering interval (ties to the later start —
    the more specific context); uncovered slices become explicit
    ``unattributed`` entries.  Adjacent same-segment slices merge, so
    the result is the ordered chain."""
    cuts = {t0, t1}
    for s, e, _, _ in intervals:
        if e > t0 and s < t1:
            cuts.add(min(max(s, t0), t1))
            cuts.add(min(max(e, t0), t1))
    points = sorted(cuts)
    chain: List[Dict[str, Any]] = []
    for a, b in zip(points, points[1:]):
        if b <= a:
            continue
        best = None
        for s, e, seg, prio in intervals:
            if s <= a and e >= b:
                if best is None or (prio, s) > (best[1], best[2]):
                    best = (seg, prio, s)
        seg = best[0] if best is not None else "unattributed"
        if chain and chain[-1]["segment"] == seg:
            chain[-1]["end_us"] = b
        else:
            chain.append({"segment": seg, "start_us": a, "end_us": b})
    return chain


def analyze_trace(trace_id: str,
                  recs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One trace's causal result: the ordered chain (absolute times
    rebased to the trace start), per-segment totals, the explicit
    unattributed residual, and the queue-wait-vs-service split."""
    intervals, markers, meta = _intervals_for(recs)
    if not intervals:
        return {"trace_id": trace_id, "error": "no attributable records",
                "records": len(recs)}
    t0 = min(s for s, _, _, _ in intervals)
    # the window ends at the servable point (last store merge) when the
    # trace has one — a daemon's post-merge housekeeping is not request
    # latency — else at the last record
    t_end = max(e for _, e, _, _ in intervals)
    t1 = meta["servable_end"] if meta["servable_end"] else t_end
    t1 = max(t1, t0)
    chain = _sweep(intervals, t0, t1)
    segments: Dict[str, float] = {}
    for c in chain:
        c["dur_us"] = round(c["end_us"] - c["start_us"], 2)
        segments[c["segment"]] = segments.get(c["segment"], 0.0) \
            + c["dur_us"]
        c["start_us"] = round(c["start_us"] - t0, 2)
        c["end_us"] = round(c["end_us"] - t0, 2)
    for m in markers:
        m["ts_us"] = round(m["ts_us"] - t0, 2)
    window = round(t1 - t0, 2)
    unattr = round(segments.get("unattributed", 0.0), 2)
    queue_wait = round(segments.get("queue_wait", 0.0), 2)
    tiers = meta["tiers"]
    return {
        "trace_id": trace_id,
        "tier": "+".join(sorted(tiers)) if tiers else "?",
        "workloads": meta["workloads"],
        "queries": meta["queries"],
        "window_us": window,
        "servable": meta["servable_end"] is not None,
        "pending": meta["pending"],
        "chain": chain,
        "markers": sorted(markers, key=lambda m: m["ts_us"]),
        "segments_us": {k: round(v, 2) for k, v in sorted(segments.items())
                        if k != "unattributed"},
        "unattributed_us": unattr,
        "coverage": round(1.0 - (unattr / window), 4) if window else 1.0,
        "queue_wait_us": queue_wait,
        "service_us": round(window - unattr - queue_wait, 2),
    }


def analyze_records(records: Iterable[Dict[str, Any]],
                    trace_id: Optional[str] = None,
                    tenants: Optional[Dict[str, str]] = None,
                    ) -> Dict[str, Dict[str, Any]]:
    """Causal results for every trace in ``records`` (or just
    ``trace_id``); ``tenants`` optionally maps trace_id -> tenant for
    the per-tenant aggregation (span attrs do not carry it — the
    exemplar header's request record does)."""
    grouped = group_by_trace(records)
    if trace_id is not None:
        grouped = {trace_id: grouped.get(trace_id, [])}
    out: Dict[str, Dict[str, Any]] = {}
    for tid, recs in sorted(grouped.items()):
        res = analyze_trace(tid, recs)
        if tenants and tid in tenants:
            res["tenant"] = tenants[tid]
        out[tid] = res
    return out


def analyze_bundles(paths: List[str],
                    trace_id: Optional[str] = None
                    ) -> Dict[str, Dict[str, Any]]:
    """Causal results over telemetry JSONL bundles — raw tracer bundles
    (``--trace-out``), checkpoint trace files, or exemplar bundles
    (serve/reqlog.py), whose line-0 header (``kind: "exemplar"``) supplies the
    tenant for the per-tenant breakdown."""
    records: List[Dict[str, Any]] = []
    tenants: Dict[str, str] = {}
    for path in paths:
        for rec in read_jsonl(path):
            if rec.get("kind") == "exemplar":
                tid = rec.get("trace_id")
                tenant = ((rec.get("record") or {}).get("tenant"))
                if isinstance(tid, str) and isinstance(tenant, str):
                    tenants[tid] = tenant
                continue
            records.append(rec)
    return analyze_records(records, trace_id=trace_id,
                           tenants=tenants or None)


# -- fleet-wide aggregation --------------------------------------------------

def _dist(xs: List[float]) -> Dict[str, Any]:
    s = sorted(xs)
    return {"count": len(s),
            "p50_us": round(percentile(s, 50), 2),
            "p99_us": round(percentile(s, 99), 2),
            "sum_us": round(sum(s), 1)}


def aggregate(traces: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The fleet-wide rollup (module docstring): per-tier and
    per-tenant segment breakdowns at p50/p99, the queue-wait-vs-service
    decomposition, and the "where the pct99 lives" ranking — segment
    shares summed over the tail traces (window >= the corpus p99)."""
    good = [t for t in traces.values() if "error" not in t]
    if not good:
        return {"n_traces": 0}

    def rollup(group: List[Dict[str, Any]]) -> Dict[str, Any]:
        segs: Dict[str, List[float]] = {}
        windows: List[float] = []
        unattr: List[float] = []
        for t in group:
            windows.append(t["window_us"])
            unattr.append(t["unattributed_us"])
            for seg, us in t["segments_us"].items():
                segs.setdefault(seg, []).append(us)
        return {
            "count": len(group),
            "window_us": _dist(windows),
            "unattributed_us": _dist(unattr),
            "segments_us": {seg: _dist(xs)
                            for seg, xs in sorted(segs.items())},
        }

    by_tier: Dict[str, List[Dict[str, Any]]] = {}
    by_tenant: Dict[str, List[Dict[str, Any]]] = {}
    for t in good:
        by_tier.setdefault(t.get("tier", "?"), []).append(t)
        by_tenant.setdefault(t.get("tenant", "?"), []).append(t)

    windows = sorted(t["window_us"] for t in good)
    p99_window = percentile(windows, 99)
    tail = [t for t in good if t["window_us"] >= p99_window] or \
        [max(good, key=lambda t: t["window_us"])]
    tail_segs: Dict[str, float] = {}
    for t in tail:
        for seg, us in t["segments_us"].items():
            tail_segs[seg] = tail_segs.get(seg, 0.0) + us
        tail_segs["unattributed"] = tail_segs.get("unattributed", 0.0) \
            + t["unattributed_us"]
    tail_total = sum(tail_segs.values()) or 1.0
    ranking = [{"segment": seg, "sum_us": round(us, 1),
                "share": round(us / tail_total, 4)}
               for seg, us in sorted(tail_segs.items(),
                                     key=lambda kv: -kv[1]) if us > 0]
    return {
        "n_traces": len(good),
        "by_tier": {k: rollup(v) for k, v in sorted(by_tier.items())},
        "by_tenant": {k: rollup(v) for k, v in sorted(by_tenant.items())},
        "decomposition": {
            "queue_wait_us": _dist([t["queue_wait_us"] for t in good]),
            "service_us": _dist([t["service_us"] for t in good]),
        },
        "pct99_window_us": round(p99_window, 2),
        "pct99_ranking": ranking,
    }


# -- differential localization -----------------------------------------------

def localize_segments(fresh: Dict[str, Dict[str, Any]],
                      base: Dict[str, Dict[str, Any]],
                      tol: float = 0.25,
                      floor_us: Optional[float] = None) -> Dict[str, Any]:
    """Which segment moved between two per-segment summary maps
    (``{segment: {"pct99_us", "count", ...}}``).  ``tol`` widens the
    coarse bar, never narrows it (module docstring); ``floor_us`` is
    the measured wake floor when available — deltas under the host's
    own noise floor are not movement."""
    ratio_bar = max(PHASE_REGRESSION_RATIO, 1.0 + tol)
    delta_floor = max(PHASE_ABS_FLOOR_US, floor_us or 0.0)
    moved: List[Dict[str, Any]] = []
    compared: List[Dict[str, Any]] = []
    skipped: List[str] = []
    for seg in sorted(set(fresh) | set(base)):
        f, b = fresh.get(seg) or {}, base.get(seg) or {}
        try:
            # replay phase summaries say pct99_us, the causal
            # aggregate says p99_us — compare either
            fp99 = float(f.get("pct99_us", f.get("p99_us")))
            bp99 = float(b.get("pct99_us", b.get("p99_us")))
        except (TypeError, ValueError):
            skipped.append(seg)
            continue
        if min(int(f.get("count", 0)), int(b.get("count", 0))) \
                < MIN_PHASE_COUNT or bp99 <= 0:
            skipped.append(seg)
            continue
        ratio = fp99 / bp99
        entry = {"segment": seg, "fresh_pct99_us": round(fp99, 2),
                 "baseline_pct99_us": round(bp99, 2),
                 "ratio": round(ratio, 2)}
        compared.append(entry)
        if ratio >= ratio_bar and (fp99 - bp99) >= delta_floor:
            moved.append(dict(entry, moved=True))
    moved.sort(key=lambda m: -m["ratio"])
    return {"moved": moved, "compared": compared, "skipped": skipped,
            "ratio_bar": round(ratio_bar, 2),
            "delta_floor_us": round(delta_floor, 2)}


def localize_phases(fresh_doc: Dict[str, Any], base_doc: Dict[str, Any],
                    tol: float = 0.25) -> Dict[str, Any]:
    """:func:`localize_segments` over two replay documents'
    per-phase samples (``segmented.phases_us``).  The wake floor
    comes from the fresh document's ``host_noise`` block when it
    carries one."""
    def phases(doc):
        return (doc.get("segmented") or {}).get("phases_us") or {}

    floor = None
    hn = fresh_doc.get("host_noise")
    if isinstance(hn, dict):
        try:
            floor = float((hn.get("timer_wake_us") or {}).get("p99_us"))
        except (TypeError, ValueError):
            floor = None
    return localize_segments(phases(fresh_doc), phases(base_doc),
                             tol=tol, floor_us=floor)


def localize_aggregates(fresh_agg: Dict[str, Any],
                        base_agg: Dict[str, Any], tol: float = 0.25,
                        tier: str = "exact") -> Dict[str, Any]:
    """:func:`localize_segments` over two :func:`aggregate` results
    (two trace corpora), comparing one tier's segment p99s."""
    def segs(agg):
        return ((agg.get("by_tier") or {}).get(tier) or {}).get(
            "segments_us") or {}

    return localize_segments(segs(fresh_agg), segs(base_agg), tol=tol)


# -- CLI ---------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tenzing_tpu_torch.obs.causal",
        description="Rebuild per-request critical paths from telemetry "
                    "bundles and aggregate where the latency lives.")
    ap.add_argument("bundles", nargs="*", metavar="GLOB",
                    help="telemetry JSONL bundles (tracer --trace-out, "
                         "checkpoint traces, exemplar bundles)")
    ap.add_argument("--trace-id", default=None,
                    help="analyze only this trace")
    ap.add_argument("--diff", nargs=2, default=None,
                    metavar=("FRESH", "BASELINE"),
                    help="localize which phase moved between two "
                         "replay documents instead of analyzing "
                         "bundles; exit 1 when a segment moved")
    ap.add_argument("--tol", type=float, default=0.25,
                    help="--diff tolerance (serve-gate default 0.25)")
    ap.add_argument("--out", default=None,
                    help="write the JSON result here (default stdout)")
    args = ap.parse_args(argv)

    if args.diff:
        try:
            with open(args.diff[0]) as f:
                fresh = json.load(f)
            with open(args.diff[1]) as f:
                base = json.load(f)
        except (OSError, ValueError) as e:
            sys.stderr.write(f"causal: {e}\n")
            return 2
        loc = localize_phases(fresh, base, tol=args.tol)
        doc: Dict[str, Any] = {"kind": "causal_diff",
                               "version": CAUSAL_VERSION,
                               "fresh": args.diff[0],
                               "baseline": args.diff[1], **loc}
        rc = 1 if loc["moved"] else 0
    else:
        paths: List[str] = []
        for pat in args.bundles:
            hits = sorted(_glob.glob(pat))
            paths.extend(hits if hits else
                         ([pat] if os.path.exists(pat) else []))
        if not paths:
            sys.stderr.write("causal: no bundles matched (and no --diff)\n")
            return 2
        traces = analyze_bundles(paths, trace_id=args.trace_id)
        doc = {"kind": "causal_analysis", "version": CAUSAL_VERSION,
               "bundles": paths, "n_traces": len(traces),
               "traces": traces, "aggregate": aggregate(traces)}
        rc = 0
    text = json.dumps(doc, indent=2, sort_keys=True) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        sys.stderr.write(f"causal: {args.out}\n")
    else:
        sys.stdout.write(text)
    return rc


if __name__ == "__main__":
    sys.exit(main())
