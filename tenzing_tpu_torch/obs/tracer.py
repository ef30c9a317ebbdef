"""Span/event tracer: the structured record of what a search did and when.

Counterpart of ``tenzing_tpu/obs/tracer.py``.  A :class:`Tracer` records

* **spans** — named intervals with attributes, nested per thread, opened
  with ``with tracer.span("mcts.iter", it=3) as sp:`` (``sp.set(k, v)``
  adds an attribute while the span is open);
* **events** — named instants with attributes
  (``tracer.event("bench.cache", hit=True)``).

Records carry a ``pid`` (the control plane's rank, so the ranks' traces
merge into one timeline) and a ``tid`` (a dense per-thread index).
Timestamps are unix-epoch microseconds from one ``perf_counter`` anchor per
tracer, so intervals are monotonic within a rank.

**Disabled is the default and costs almost nothing**: a disabled
``span()`` / ``event()`` returns a shared no-op at once (no allocation, no
lock, no timestamp).  :func:`configure` enables it process-wide, as
``python -m tenzing_tpu_torch.bench --trace-out DIR`` does.  While a trace
context is ambient (obs/context.py) every record is also stamped with its
``trace_id`` / ``parent_span``.  Retention is bounded: past ``max_spans``
/ ``max_events`` the oldest records are evicted and counted
(``dropped_spans`` / ``dropped_events``).
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional

from tenzing_tpu_torch.obs.context import current_trace_attrs

# the default span/event ring bounds: generous enough that every search
# bundle to date fits untruncated, small enough that a multi-hour serve
# loop stays O(100 MB) worst-case instead of unbounded
MAX_SPANS = 200_000
MAX_EVENTS = 200_000


def short_digest(payload: str) -> str:
    """12-hex sha1 of a serialized payload — THE schedule-id convention
    every telemetry emitter shares (bench.benchmark spans, executor.compile
    spans, bench.cache events), so trace records for the same schedule
    correlate byte-for-byte across subsystems and hosts."""
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


class Span:
    """One finished-or-open interval.  ``ts_us``/``dur_us`` are unix-epoch
    microseconds; ``attrs`` is a plain JSON-safe dict."""

    __slots__ = ("name", "ts_us", "dur_us", "pid", "tid", "span_id",
                 "parent_id", "attrs")

    def __init__(self, name: str, ts_us: float, pid: int, tid: int,
                 span_id: int, parent_id: Optional[int],
                 attrs: Dict[str, Any]):
        self.name = name
        self.ts_us = ts_us
        self.dur_us = 0.0
        self.pid = pid
        self.tid = tid
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs

    def set(self, key: str, value: Any) -> None:
        """Attach/overwrite one attribute (usable while the span is open)."""
        self.attrs[key] = value

    def to_json(self) -> Dict[str, Any]:
        return {
            "kind": "span",
            "name": self.name,
            "ts_us": self.ts_us,
            "dur_us": self.dur_us,
            "pid": self.pid,
            "tid": self.tid,
            "id": self.span_id,
            "parent": self.parent_id,
            "attrs": self.attrs,
        }


class Event:
    """One instant with attributes."""

    __slots__ = ("name", "ts_us", "pid", "tid", "attrs")

    def __init__(self, name: str, ts_us: float, pid: int, tid: int,
                 attrs: Dict[str, Any]):
        self.name = name
        self.ts_us = ts_us
        self.pid = pid
        self.tid = tid
        self.attrs = attrs

    def to_json(self) -> Dict[str, Any]:
        return {
            "kind": "event",
            "name": self.name,
            "ts_us": self.ts_us,
            "pid": self.pid,
            "tid": self.tid,
            "attrs": self.attrs,
        }


class _NullSpan:
    """The span handed out when tracing is disabled: every method a no-op."""

    __slots__ = ()

    def set(self, key: str, value: Any) -> None:
        return None


class _NullSpanCtx:
    """Reusable no-op context manager — the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL_SPAN

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()
_NULL_CTX = _NullSpanCtx()


class Tracer:
    """Thread-safe span/event recorder (see module docstring)."""

    def __init__(self, enabled: bool = True, rank: int = 0,
                 max_spans: int = MAX_SPANS, max_events: int = MAX_EVENTS):
        self.enabled = enabled
        self.rank = rank
        self._lock = threading.Lock()
        # bounded rings (module docstring): a full ring evicts oldest
        # and counts the drop — a long-lived process cannot grow without
        # bound
        self._spans: Deque[Span] = deque(maxlen=max(1, max_spans))
        self._events: Deque[Event] = deque(maxlen=max(1, max_events))
        self.dropped_spans = 0
        self.dropped_events = 0
        self._listeners: List[Callable[[str, Any], None]] = []
        self._local = threading.local()
        self._tids: Dict[int, int] = {}
        self._next_tid = 0
        # live per-thread open-span stacks, keyed by thread ident: the
        # export-time flush reads OTHER threads' stacks
        # to close in-flight spans, so the stacks must be reachable beyond
        # the owning thread's threading.local view
        self._open_stacks: Dict[int, List[Span]] = {}
        self._next_span_id = 0
        # one perf_counter anchor -> monotonic unix-us timestamps
        self._t0_unix = time.time()
        self._t0_perf = time.perf_counter()

    # -- plumbing ----------------------------------------------------------
    def _now_us(self) -> float:
        return (self._t0_unix + (time.perf_counter() - self._t0_perf)) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.get(ident)
                if tid is None:
                    # a monotonic counter, not len(): dead-thread idents
                    # are pruned at snapshot time, and a pruned-then-reused
                    # index would merge two different threads' tracks
                    tid = self._tids[ident] = self._next_tid
                    self._next_tid += 1
        return tid

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            with self._lock:
                self._open_stacks[threading.get_ident()] = stack
        return stack

    def set_rank(self, rank: int) -> None:
        """Tag subsequent records with this control-plane rank (pid)."""
        self.rank = int(rank)

    def add_listener(self, fn: Callable[[str, Any], None]) -> None:
        """``fn(kind, record)`` called on every finished span ("span") and
        emitted event ("event") while the tracer is enabled."""
        self._listeners.append(fn)

    def _notify(self, kind: str, record: Any) -> None:
        for fn in self._listeners:
            try:
                fn(kind, record)
            except Exception:
                pass  # a broken listener must not take down the search

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Context manager opening a nested span; yields the :class:`Span`."""
        if not self.enabled:
            return _NULL_CTX
        return self._span_ctx(name, attrs)

    @contextmanager
    def _span_ctx(self, name: str, attrs: Dict[str, Any]) -> Iterator[Span]:
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        trace = current_trace_attrs()
        if trace is not None:
            # stamp the ambient cross-process context (obs/context.py);
            # explicit attrs win, and nested spans need no parent_span —
            # their in-process parent chain already resolves
            if parent is not None:
                trace = {"trace_id": trace["trace_id"]}
            attrs = {**trace, **attrs}
        with self._lock:
            span_id = self._next_span_id
            self._next_span_id += 1
        sp = Span(name, self._now_us(), self.rank, self._tid(), span_id,
                  parent, attrs)
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.dur_us = self._now_us() - sp.ts_us
            stack.pop()
            with self._lock:
                if len(self._spans) == self._spans.maxlen:
                    self.dropped_spans += 1  # ring full: oldest evicts
                self._spans.append(sp)
            self._notify("span", sp)

    def event(self, name: str, **attrs: Any) -> None:
        """Record one instant event."""
        if not self.enabled:
            return
        trace = current_trace_attrs()
        if trace is not None:
            attrs = {"trace_id": trace["trace_id"], **attrs}
        ev = Event(name, self._now_us(), self.rank, self._tid(), attrs)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped_events += 1
            self._events.append(ev)
        self._notify("event", ev)

    # -- reading -----------------------------------------------------------
    def spans(self) -> List[Span]:
        """Snapshot of finished spans (completion order)."""
        with self._lock:
            return list(self._spans)

    def events(self) -> List[Event]:
        with self._lock:
            return list(self._events)

    def snapshot(self, block: bool = True, flush_open: bool = True):
        """(finished spans, events, flushed open spans) — THE export-time
        read (obs/export.py).

        ``block=False`` makes the read **async-signal-safe**: the lock is
        taken with ``blocking=False`` and, when it cannot be acquired (the
        interrupted thread may hold it — the Ctrl-C + ``--trace-out``
        deadlock this replaces), the lists are copied without it.  A bare
        ``list(x)`` of a list is atomic under the GIL, so the fallback
        yields a consistent prefix rather than a crash or a hang.

        ``flush_open`` closes a *copy* of every in-flight span (all
        threads) with duration up-to-now and a ``flushed: true`` attribute:
        an interrupted run's bundle keeps its open ``mcts.iter`` /
        ``bench.benchmark`` spans, and no exported record references a
        parent id that never exports (the dangling-parent gap)."""
        acquired = self._lock.acquire(blocking=block)
        try:
            # stacks first: a span closing concurrently then shows up in
            # both copies (filtered by span id below), never in neither
            stacks = [list(s) for s in list(self._open_stacks.values())]
            spans = list(self._spans)
            events = list(self._events)
            if acquired:
                # retention housekeeping (safe only under the real lock):
                # threads die but their ident keys do not, so the stack/tid
                # maps of DEAD threads with nothing in flight are pruned
                # here, the one periodic read every long-lived process
                # already performs
                live = {t.ident for t in threading.enumerate()}
                for ident in [i for i, s in self._open_stacks.items()
                              if not s and i not in live]:
                    del self._open_stacks[ident]
                    self._tids.pop(ident, None)
        finally:
            if acquired:
                self._lock.release()
        open_spans: List[Span] = []
        if flush_open:
            now = self._now_us()
            done_ids = {s.span_id for s in spans}
            for stack in stacks:
                for sp in stack:
                    if sp.span_id in done_ids:
                        continue
                    cp = Span(sp.name, sp.ts_us, sp.pid, sp.tid, sp.span_id,
                              sp.parent_id, dict(sp.attrs))
                    cp.dur_us = max(0.0, now - sp.ts_us)
                    cp.attrs["flushed"] = True
                    open_spans.append(cp)
        return spans, events, open_spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._events.clear()
            self.dropped_spans = 0
            self.dropped_events = 0

    def retention(self) -> Dict[str, int]:
        """Buffer occupancy + drop counts — what metric snapshots carry
        so ring eviction in a long-lived process is visible, never
        silent (obs/metrics.py ``MetricsSnapshotWriter``)."""
        return {
            "spans": len(self._spans),
            "events": len(self._events),
            "max_spans": self._spans.maxlen or 0,
            "max_events": self._events.maxlen or 0,
            "dropped_spans": self.dropped_spans,
            "dropped_events": self.dropped_events,
        }


# -- process-global tracer -------------------------------------------------

_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer (disabled until :func:`configure`)."""
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (tests); returns the previous one."""
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, tracer
    return prev


def configure(enabled: bool = True, rank: Optional[int] = None) -> Tracer:
    """Enable/disable the global tracer in place (records are kept)."""
    _GLOBAL.enabled = enabled
    if rank is not None:
        _GLOBAL.set_rank(rank)
    return _GLOBAL
