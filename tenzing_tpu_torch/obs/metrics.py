"""Metrics registry: counters, gauges, histograms with percentile summaries.

Counterpart of ``tenzing_tpu/obs/metrics.py``.  Where the tracer answers
"what happened when", the registry answers "how much / how often / how
slow".  One process-global registry (:func:`get_metrics`)
aggregates over a whole run — the solvers' phase timings (through
``utils/counters.py``), the benchmark cache's hit rate, measurement counts —
and serializes to one JSON document
(``python -m tenzing_tpu_torch.bench --metrics-json PATH``).

Histogram summaries use the nearest-rank percentile of ``BenchResult``
(utils/numeric.py ``percentile``) and keep raw observations up to a cap.

The streaming exporter (:class:`MetricsSnapshotWriter`) serves the
long-lived processes (the listen loop, the drain daemon): it writes atomic
metric-snapshot documents into a bounded ring of files beside the process's
``status-<owner>.json``, each with the whole registry read without
blocking, the tracer's retention tallies and, where configured, an SLO
block (:class:`SloConfig`: the exact tier's pct99 against a target and a
baseline, with the direction it burns).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from tenzing_tpu_torch.utils.numeric import percentile


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Distribution of observations with a percentile summary.

    Aggregates (count/sum/min/max) are exact and O(1) per observation; raw
    values are retained only up to ``max_raw`` for the percentile summary —
    a hot loop observing per-node timings (DFS enumeration) cannot grow
    memory without bound.  A truncated summary carries ``raw_retained`` and
    ``truncated: true`` so downstream tooling (e.g. the report CLI,
    obs/report.py) labels the percentiles prefix-only instead of silently
    treating them as full-series statistics.

    ``window=True`` retains the most RECENT ``max_raw`` observations
    instead of the first (a deque ring): the serving-latency series a
    live SLO block reads must reflect current traffic — first-N
    retention would freeze the pct99 at whatever the process saw before
    the cap filled, hiding every regression after warm-up.  Windowed
    summaries carry ``window: true`` (+ ``raw_retained``) instead of
    ``truncated``."""

    __slots__ = ("name", "_lock", "_values", "_count", "_sum", "_min",
                 "_max", "_max_raw", "_window")

    def __init__(self, name: str, max_raw: int = 65536,
                 window: bool = False):
        self.name = name
        self._lock = threading.Lock()
        self._window = bool(window)
        self._max_raw = max(1, max_raw)
        self._values = (deque(maxlen=self._max_raw) if self._window
                        else [])  # type: ignore[var-annotated]
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if self._window or len(self._values) < self._max_raw:
                self._values.append(value)  # deque evicts oldest itself

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return self._sum

    def values(self) -> List[float]:
        """The retained raw observations (all of them below ``max_raw``)."""
        with self._lock:
            return list(self._values)

    def summary(self, block: bool = True) -> Dict[str, float]:
        """count/sum/min/max/mean + nearest-rank p50/p90/p99.

        ``block=False`` is the async-signal-safe read (the driver's exit-path
        ``write_telemetry``): if the instrument lock cannot be acquired —
        the interrupted thread may hold it mid-``observe`` — the summary is
        computed from a GIL-atomic copy of the fields instead of blocking
        on a lock that will never be released."""
        acquired = self._lock.acquire(blocking=block)
        try:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
            xs = sorted(self._values)
        finally:
            if acquired:
                self._lock.release()
        if count == 0 or not xs:
            # xs can be empty at count > 0 only on a torn non-blocking read
            # (observe() bumps count before appending); report the exact
            # aggregates without percentiles rather than crash at exit
            return {"count": count, "sum": total}
        out = {
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
            "mean": total / count,
            "p50": percentile(xs, 50),
            "p90": percentile(xs, 90),
            "p99": percentile(xs, 99),
        }
        if len(xs) < count:
            # the retained-raw cap bounded the series: the percentiles
            # cover only ``raw_retained`` of ``count`` observations —
            # the FIRST raw_retained for plain histograms (``truncated``,
            # labeled "prefix-only" by the report CLI) or the most
            # RECENT for windowed ones (``window``, labeled
            # "recent-window").  Explicit markers so readers never have
            # to compare count vs raw_retained themselves.
            out["raw_retained"] = len(xs)
            if self._window:
                out["window"] = True
            else:
                out["truncated"] = True
        return out


class MetricsRegistry:
    """Get-or-create namespace of instruments; serializes to one JSON doc."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            inst = self._counters.get(name)
            if inst is None:
                inst = self._counters[name] = Counter(name)
            return inst

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            inst = self._gauges.get(name)
            if inst is None:
                inst = self._gauges[name] = Gauge(name)
            return inst

    def histogram(self, name: str, max_raw: Optional[int] = None,
                  window: bool = False) -> Histogram:
        """Get-or-create; ``max_raw`` / ``window`` shape the raw-series
        retention and apply only at creation (the first caller of a
        name decides: a long-lived process passes a small windowed cap
        for a latency series so live percentiles track current
        traffic)."""
        with self._lock:
            inst = self._histograms.get(name)
            if inst is None:
                kwargs: Dict[str, Any] = {"window": window}
                if max_raw is not None:
                    kwargs["max_raw"] = max_raw
                inst = self._histograms[name] = Histogram(name, **kwargs)
            return inst

    def histograms(self) -> Dict[str, Histogram]:
        """Snapshot of the registered histograms (name -> instrument)."""
        with self._lock:
            return dict(self._histograms)

    @contextmanager
    def timer(self, name: str):
        """Time a block into histogram ``name`` (seconds)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.histogram(name).observe(time.perf_counter() - t0)

    def to_json(self, block: bool = True) -> Dict[str, Any]:
        """Serialize every instrument.  ``block=False`` is the
        async-signal-safe variant (the driver's exit path,
        ``write_telemetry``): registry and per-histogram locks are taken
        non-blocking with GIL-atomic dict/list copies as the fallback, so a
        signal handler can archive metrics even while the interrupted
        thread holds an instrument lock."""
        acquired = self._lock.acquire(blocking=block)
        try:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        finally:
            if acquired:
                self._lock.release()
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.summary(block=block)
                           for n, h in sorted(histograms.items())},
        }

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_GLOBAL = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    """The process-global registry (always live — recording into it is cheap
    and reading it is opt-in, so there is no enabled flag to thread around)."""
    return _GLOBAL


def set_metrics(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous one."""
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, registry
    return prev


# -- the streaming snapshot exporter ------------------------------------------

SNAPSHOT_VERSION = 1


@dataclass
class SloConfig:
    """What healthy means for one latency series.  ``target_us`` is the
    operator's objective for the exact tier's pct99; ``baseline_pct99_us``
    anchors the burn direction, read from a serve-replay result with
    :func:`baseline_pct99_from` (a run of the same system on the same
    hardware: left unset, the block reports no direction)."""

    target_us: Optional[float] = None
    baseline_pct99_us: Optional[float] = None
    histogram: str = "serve.resolve_us.exact"
    # past this relative drift from the baseline the direction stops
    # reading "flat"
    drift_tol: float = 0.05

    def block(self, registry: "MetricsRegistry") -> Dict[str, Any]:
        """The SLO block of one snapshot: the configured histogram's current
        pct99 against the target and the baseline."""
        hist = registry.histograms().get(self.histogram)
        summary = hist.summary(block=False) if hist is not None else {}
        pct99 = summary.get("p99")
        out: Dict[str, Any] = {
            "histogram": self.histogram,
            "count": summary.get("count", 0),
            "pct99_us": pct99,
            "target_us": self.target_us,
            "baseline_pct99_us": self.baseline_pct99_us,
        }
        if pct99 is not None and self.target_us:
            out["within_target"] = bool(pct99 <= self.target_us)
        if pct99 is not None and self.baseline_pct99_us:
            ratio = pct99 / self.baseline_pct99_us
            out["vs_baseline"] = round(ratio, 4)
            out["burn"] = ("improving" if ratio < 1.0 - self.drift_tol
                           else "degrading" if ratio > 1.0 + self.drift_tol
                           else "flat")
        return out


def baseline_pct99_from(path: str) -> Optional[float]:
    """The exact tier's pct99 in a serve-replay result document (the
    reference's ``SERVE_BENCH_r*.json`` format); None when the file is
    unreadable or of another kind."""
    try:
        with open(path) as f:
            doc = json.load(f)
        exact = (doc.get("segmented") or {}).get("resolve_us", {}).get(
            "exact") or {}
        v = exact.get("pct99_us")
        return float(v) if v is not None else None
    except (OSError, ValueError, TypeError, AttributeError):
        return None


class MetricsSnapshotWriter:
    """Periodic atomic metric-snapshot documents, a bounded ring per owner.

    Files are ``metrics-<owner>-<k>.json`` with ``k = seq % ring``: a
    process that snapshots every heartbeat for a month leaves ``ring``
    files.  Each document carries its monotonic ``seq``, so readers order
    them without trusting mtimes.  Writes go through utils/atomic.py, and
    every read in the document is non-blocking: the writer is safe on a
    heartbeat thread."""

    def __init__(self, directory: str, owner: str, ring: int = 8,
                 slo: Optional[SloConfig] = None):
        self.dir = directory
        self.owner = owner
        self.ring = max(1, int(ring))
        self.slo = slo
        self.seq = 0

    def path_for(self, seq: int) -> str:
        return os.path.join(
            self.dir, f"metrics-{self.owner}-{seq % self.ring}.json")

    def build(self, state: str = "serving",
              extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The snapshot document, not written: also the listen protocol's
        ``metrics`` answer."""
        from tenzing_tpu_torch.obs.tracer import get_tracer

        registry = get_metrics()
        doc: Dict[str, Any] = {
            "version": SNAPSHOT_VERSION,
            "kind": "metrics_snapshot",
            "owner": self.owner,
            "seq": self.seq,
            "written_at": time.time(),
            "state": state,
            "metrics": registry.to_json(block=False),
            "tracer": get_tracer().retention(),
        }
        if self.slo is not None:
            doc["slo"] = self.slo.block(registry)
        if extra:
            doc.update(extra)
        return doc

    def write(self, state: str = "serving",
              extra: Optional[Dict[str, Any]] = None) -> str:
        from tenzing_tpu_torch.utils.atomic import atomic_dump_json

        doc = self.build(state=state, extra=extra)
        path = self.path_for(self.seq)
        os.makedirs(self.dir, exist_ok=True)
        atomic_dump_json(path, doc, prefix=".metrics.")
        self.seq += 1
        return path


def _snapshot_key(doc) -> tuple:
    try:
        at = float(doc.get("written_at", 0))
    except (TypeError, ValueError):
        at = 0.0
    return (at, doc.get("seq", -1))


def snapshot_history(directory: str) -> Dict[str, List[Dict[str, Any]]]:
    """Every readable snapshot document in ``directory``, grouped by owner
    and ordered oldest first by ``(written_at, seq)``: the ring as a short
    time series.  Wall clock first and seq second, since a restarted
    process starts over at seq 0 while the dead one's documents still hold
    the other slots.  Unreadable or foreign files are skipped."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("metrics-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if doc.get("kind") != "metrics_snapshot":
            continue
        out.setdefault(doc.get("owner", "?"), []).append(doc)
    for docs in out.values():
        docs.sort(key=_snapshot_key)
    return out


def latest_snapshots(directory: str) -> Dict[str, Dict[str, Any]]:
    """The newest snapshot document per owner in ``directory`` (the largest
    ``(written_at, seq)``; :func:`snapshot_history`)."""
    return {owner: docs[-1]
            for owner, docs in snapshot_history(directory).items() if docs}
