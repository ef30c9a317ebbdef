"""The long-lived serving loop: ``python -m tenzing_tpu_torch.serve listen``.

Counterpart of ``tenzing_tpu/serve/listen.py``, the same protocol, options,
counters, status document and snapshots.  It wraps one
:class:`~tenzing_tpu_torch.serve.service.ScheduleService` in a bounded
request loop that sheds load.  The loop never touches the device: the
service resolves from its store, and a cold request becomes a work item
that the drain daemon (serve/daemon.py) runs on the card.  The service's
``platform`` (the CLI's ``--platform``, default ``cuda``) enters every
fingerprint it resolves.

* **Transports** — newline-delimited JSON over **stdin/stdout** (the
  default) or a **unix domain socket** (``--socket PATH``; any number of
  connections, a reader thread each, responses written under a lock per
  connection).  One request a line, one response line a request, matched
  by the client's ``id``.
* **Protocol** — ``{"op": "query", "id": ..., "request": {DriverRequest
  fields}}`` resolves one request; ``{"op": "batch", "requests": [...]}``
  resolves many in one trip (one queue slot, one response line);
  ``stats``, ``ping`` and ``metrics`` answer probes.
* **Bounded queue, explicit shedding** — at most ``--max-pending``
  requests wait; past that the loop answers at once with ``{"shed": true,
  "retry_after": <secs>}`` and counts ``serve.shed``: a server that cannot
  keep up says so in microseconds rather than letting every client time
  out in line.
* **Per-tenant admission** — ``--tenant-max-pending`` (default half the
  global bound, 0 disables) caps each tenant's own in-flight count: an
  over-cap tenant sheds with ``{"shed": true, "reason": "tenant_cap"}``
  before its burst fills the global bound; ``serve.shed.<tenant>`` counts
  it.  Untagged requests see only the global bound.
* **Split resolve lock** — workers try the resolver's lock-free path first
  (:meth:`~tenzing_tpu_torch.serve.resolver.Resolver.resolve_fast`: exact
  hits resolve concurrently, memoized response and all); only the
  fallback — store walks, flag writes, cold enqueues, the near tier —
  takes the exclusive lock.
* **Per-request watchdog** — a request older than ``--request-timeout``
  is answered with a timeout classified transient (fault/errors.py) even
  while its worker is still busy; the worker's late result is dropped.
* **Graceful drain** — SIGTERM or SIGINT stops intake, drains what is
  queued, stamps the status document ``stopped`` and exits; a second
  signal abandons the drain.
* **Status and heartbeat** — ``status-<owner>.json`` beside the store,
  rewritten atomically every ``--heartbeat`` seconds with the state, queue
  depth, served counts per tier and shed and timeout tallies (the drain
  daemon's status contract).
* **Telemetry** — each request gets a trace context at ingress
  (obs/context.py; a client's ``trace`` key is adopted instead): it stamps
  every span and event of the resolution, rides a cold query's work item
  into the drain, and comes back as ``trace_id`` on every response.  The
  heartbeat also writes metric snapshots (obs/metrics.py
  ``MetricsSnapshotWriter``, a bounded ring beside the status document)
  with latency histograms per tier and tenant, queue-age and shed-rate
  gauges, and the SLO block (the exact tier's pct99 against
  ``--slo-target-us`` and ``--slo-baseline``); the ``metrics`` verb
  answers the same document on demand.
* **Recording** — ``--record DIR`` keeps a request log (serve/reqlog.py):
  one sampled, checksummed record per admitted request (its kwargs, tier,
  digests, latency phases, outcome), whole span bundles for the requests
  worth a look under ``DIR/exemplars/``, and a ``reqlog`` position block
  in every snapshot.

Every response carries ``resolve_us`` (the resolution's own latency,
without queue wait), so a client can build the latency distribution
without trusting the server's aggregates.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import signal
import socket as _socket
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from tenzing_tpu_torch.fault.errors import StoreReadonlyError, classify_error
from tenzing_tpu_torch.obs import context as obs_context
from tenzing_tpu_torch.serve.resolver import fp_cache_key
from tenzing_tpu_torch.serve.store import probe_store_writable, store_readonly
from tenzing_tpu_torch.obs.metrics import (
    MetricsSnapshotWriter,
    SloConfig,
    baseline_pct99_from,
    get_metrics,
)
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.utils.atomic import atomic_dump_json

STATUS_VERSION = 1
_OPS = ("query", "batch", "stats", "ping", "metrics")


@dataclass
class ListenOpts:
    """Knobs of one :class:`ServeLoop` (CLI flags map 1:1)."""

    max_pending: int = 64            # bounded queue: beyond this, shed
    workers: int = 2                 # resolution worker threads
    request_timeout_secs: float = 10.0   # per-request watchdog
    shed_retry_after_secs: float = 0.5   # the hint shed responses carry
    heartbeat_secs: float = 2.0      # status rewrite interval
    idle_exit_secs: Optional[float] = None  # exit after idling (CI)
    owner: str = ""                  # default: <host>-<pid>
    status_path: Optional[str] = None
    socket_path: Optional[str] = None
    handle_signals: bool = True
    # busy-poll workers: each worker spins on get_nowait() for up to this
    # many µs before the blocking wait — buys back the OS timer-wake floor
    # on the exact tier's tail at the cost of a core spinning while idle.
    # 0 = blocking waits.
    busy_poll_us: float = 0.0
    # -- telemetry --
    slo_target_us: Optional[float] = None    # exact-tier pct99 objective
    slo_baseline: Optional[str] = None       # a serve-replay result's path
    metrics_ring: int = 8                    # snapshot files per owner
    trace_out: Optional[str] = None          # JSONL bundle written on drain
    # distinct per-tenant histogram labels admitted before new tenants
    # aggregate under "other" — per-tenant series must not let a
    # client-controlled string grow the registry without bound
    tenant_cap: int = 16
    # per-tenant fair admission: at most this many
    # in-flight requests per tenant (batch members charged to their
    # effective tenants) — an over-cap tenant is shed with reason
    # "tenant_cap" BEFORE its burst can fill the global max_pending
    # bound and starve everyone else.  None derives
    # max(1, max_pending // 2), enforced work-conservingly (only once a
    # second distinct tenant is seen); 0 disables the cap; an explicit
    # value always applies.  Requests without a tenant tag see only the
    # global bound.
    tenant_max_pending: Optional[int] = None
    # -- watchtower: production traffic recording (serve/reqlog.py) --
    record_dir: Optional[str] = None     # enables the request log
    record_sample: float = 1.0           # deterministic per-trace draw
    record_segment_records: int = 256    # records per sealed segment
    record_retain: int = 16              # sealed segments kept (rotation)
    record_flush_secs: float = 30.0      # heartbeat-side publish cadence
    exemplar_k: int = 4                  # slowest-K bundles per window
    exemplar_cap: int = 64               # exemplar files kept


class _Pending:
    """One in-flight request: complete-once semantics — whoever gets
    there first (worker result, watchdog timeout, shutdown shed) writes
    the response; everyone else's attempt is a no-op."""

    __slots__ = ("rid", "payload", "respond", "enqueued_at", "deadline",
                 "ctx", "_done", "_lock")

    def __init__(self, rid, payload: Dict[str, Any],
                 respond: Callable[[Dict[str, Any]], None],
                 deadline: Optional[float], ctx=None):
        self.rid = rid
        self.payload = payload
        self.respond = respond
        self.enqueued_at = time.time()
        self.deadline = deadline
        self.ctx = ctx  # the request's TraceContext (minted at ingress)
        self._done = False
        self._lock = threading.Lock()

    def complete(self, doc: Dict[str, Any]) -> bool:
        with self._lock:
            if self._done:
                return False
            self._done = True
        out = dict(doc)
        if self.rid is not None:
            out["id"] = self.rid
        if self.ctx is not None and "trace_id" not in out:
            # every response names its trace — shed and watchdog answers
            # included, so a client can correlate even its non-answers
            out["trace_id"] = self.ctx.trace_id
        try:
            self.respond(out)
        except Exception:
            pass  # a vanished client must not take the loop down
        return True

    @property
    def done(self) -> bool:
        return self._done


class ServeLoop:
    """See module docstring.  Embeddable: tests drive :meth:`submit` /
    :meth:`start` / :meth:`drain` directly; the CLI runs
    :meth:`serve_stdin` or :meth:`serve_socket`."""

    def __init__(self, service, opts: Optional[ListenOpts] = None,
                 log: Optional[Callable[[str], None]] = None):
        self.service = service
        self.opts = opts or ListenOpts()
        self.owner = self.opts.owner or \
            f"{_socket.gethostname()}-{os.getpid()}"
        self._log_fn = log
        self.counters: Dict[str, int] = {
            k: 0 for k in ("requests", "batches", "served_exact",
                           "served_near", "served_cold", "shed",
                           "timeouts", "errors", "malformed", "signals")}
        # socket mode bumps counters from one reader thread per
        # connection plus the workers and the watchdog — unlocked
        # dict += would lose counts under interleaving, and these are
        # the economics the status doc reports
        self._count_lock = threading.Lock()
        self.started_at = time.time()
        self._stop = threading.Event()       # stop intake, drain
        self._abandon = threading.Event()    # second signal: stop now
        self._queue: "_queue.Queue[_Pending]" = _queue.Queue(
            maxsize=max(1, self.opts.max_pending))
        self._live: "set[_Pending]" = set()
        self._live_lock = threading.Lock()
        # per-tenant in-flight counts, maintained under _live_lock by
        # _live_add/_live_discard: the fair-admission check is O(1) and
        # ATOMIC with registration — concurrent submits from many
        # connection threads cannot race past the cap between a count
        # and an add
        self._tenant_live: Dict[str, int] = {}
        # resolution is serialized: the resolver's caches and the store
        # flag/enqueue writes are not thread-safe, and the hot path is a
        # dict probe — worker concurrency buys queueing, not resolution
        self._resolve_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._prev_handlers: Dict[int, Any] = {}
        self.last_request_at = time.time()
        store_path = getattr(self.service.store, "path", None)
        # the readonly-probe target (and the status doc's "store" key)
        self._store_path = store_path if isinstance(store_path, str) \
            else None
        base = (os.path.dirname(os.path.abspath(store_path))
                if isinstance(store_path, str) and store_path.endswith(
                    ".json")
                else store_path if isinstance(store_path, str)
                else ".")
        self.status_path = self.opts.status_path or os.path.join(
            base, f"status-{self.owner}.json")
        # the streaming metrics exporter (obs/metrics.py): a bounded
        # ring of snapshot documents next to the status doc, written on
        # every heartbeat and answered by the `metrics` protocol verb
        baseline = (baseline_pct99_from(self.opts.slo_baseline)
                    if self.opts.slo_baseline else None)
        self._snapshots = MetricsSnapshotWriter(
            os.path.dirname(os.path.abspath(self.status_path)), self.owner,
            ring=self.opts.metrics_ring,
            slo=SloConfig(target_us=self.opts.slo_target_us,
                          baseline_pct99_us=baseline))
        # tenants admitted to their own latency series; the cap guards
        # the registry against client-controlled label cardinality
        self._tenants: "set[str]" = set()
        self._shed_window = (time.time(), 0)  # (window start, sheds then)
        # -- watchtower (serve/reqlog.py): the production traffic
        # recorder and the tail-sampled exemplar store, both opt-in via
        # record_dir — every admitted request lands one sampled,
        # checksummed log record; interesting requests (slowest-K per
        # window, every shed/timeout/error/unverified) keep their full
        # span bundle keyed by trace_id
        self._reqlog = None
        self._exemplars = None
        self._last_record_flush = time.time()
        if self.opts.record_dir:
            from tenzing_tpu_torch.serve.reqlog import ExemplarStore, RequestLog

            self._reqlog = RequestLog(
                self.opts.record_dir, owner=self.owner,
                sample=self.opts.record_sample,
                segment_records=self.opts.record_segment_records,
                retain_segments=self.opts.record_retain, log=self._log)
            self._exemplars = ExemplarStore(
                os.path.join(self.opts.record_dir, "exemplars"),
                k=self.opts.exemplar_k, cap=self.opts.exemplar_cap,
                log=self._log)

    def _log(self, msg: str) -> None:
        if self._log_fn is not None:
            self._log_fn(msg)
        else:
            sys.stderr.write(f"serve[{self.owner}]: {msg}\n")

    def _bump(self, key: str, n: int = 1) -> None:
        with self._count_lock:
            self.counters[key] = self.counters.get(key, 0) + n

    # -- status --------------------------------------------------------------
    def _write_status(self, state: str) -> None:
        doc = {
            "version": STATUS_VERSION,
            "kind": "serve_loop",
            "owner": self.owner,
            "pid": os.getpid(),
            "host": _socket.gethostname(),
            "started_at": self.started_at,
            "heartbeat_at": time.time(),
            "uptime_s": round(time.time() - self.started_at, 1),
            "state": state,
            "queue_depth": self._queue.qsize(),
            "in_flight": len(self._live),
            "counters": dict(self.counters),
            "store": getattr(self.service.store, "path", None),
            "platform": getattr(self.service, "platform", None),
            "store_readonly": store_readonly(self._store_path),
            "socket": self.opts.socket_path,
        }
        try:
            atomic_dump_json(self.status_path, doc, prefix=".status.")
        except OSError as e:
            self._log(f"status write failed ({e})")

    # -- intake --------------------------------------------------------------
    def submit(self, payload: Dict[str, Any],
               respond: Callable[[Dict[str, Any]], None]) -> None:
        """One parsed request line: enqueue, or shed immediately when
        the bounded queue is full / the loop is draining."""
        rid = payload.get("id") if isinstance(payload, dict) else None
        self._bump("requests")
        self.last_request_at = time.time()
        if not isinstance(payload, dict) or \
                payload.get("op", "query") not in _OPS:
            self._bump("malformed")
            _Pending(rid, {}, respond, None).complete({
                "ok": False, "error": "malformed request "
                f"(op must be {'|'.join(_OPS)})",
                "error_class": "deterministic"})
            return
        # ingress: mint (or adopt the client's) cross-process trace
        # context — THE id that follows this request through resolution,
        # a cold enqueue, the daemon drain, and the store merge
        ctx = (obs_context.from_json(payload.get("trace"))
               or obs_context.new_trace())
        deadline = (time.time() + self.opts.request_timeout_secs
                    if self.opts.request_timeout_secs else None)
        pending = _Pending(rid, payload, respond, deadline, ctx=ctx)
        if self._stop.is_set():
            self._shed(pending, reason="draining")
            return
        # per-tenant fair admission, atomic with live registration: the
        # tenant's own in-flight count is bounded below the global one,
        # so one tenant's burst sheds against its own cap while everyone
        # else still has queue room.  Registered live BEFORE the
        # enqueue: a worker that grabs the item instantly must find it
        # registered, or the discard would lose to the add and leak a
        # ghost into the watchdog's view.
        admitted, over_tenant = self._live_add(pending)
        if not admitted:
            self._shed(pending, reason="tenant_cap", tenant=over_tenant)
            return
        try:
            self._queue.put_nowait(pending)
        except _queue.Full:
            self._live_discard(pending)
            self._shed(pending, reason="queue-full")
            return

    def _shed(self, pending: _Pending, reason: str,
              tenant: Optional[str] = None) -> None:
        self._bump("shed")
        reg = get_metrics()
        reg.counter("serve.shed").inc()
        # per-tenant shed counts, the fairness measurement — capped to
        # "other" exactly like the latency series.  ``tenant``
        # names the over-cap tenant for tenant_cap sheds (an untagged
        # batch shed for a MEMBER tenant must charge that tenant, not
        # nobody); other reasons attribute to the payload tenant.
        label = self._tenant_label(tenant if tenant is not None
                                   else self._tenant_of(pending.payload))
        if label is not None:
            reg.counter(f"serve.shed.{label}").inc()
        tr = get_tracer()
        if tr.enabled:
            tr.event("serve.shed", reason=reason,
                     depth=self._queue.qsize())
        doc = {
            "ok": False, "shed": True, "reason": reason,
            "retry_after": self.opts.shed_retry_after_secs,
            "error_class": "transient"}
        if pending.complete(doc):
            self._record(pending, doc)

    def _tenant_pending_cap(self) -> int:
        """The effective per-tenant in-flight bound (opts docstring):
        configured, or half the global bound; 0 = disabled."""
        cap = self.opts.tenant_max_pending
        if cap is None:
            return max(1, self.opts.max_pending // 2)
        return max(0, cap)

    @classmethod
    def _tenant_weights(cls, payload: Any) -> Dict[str, int]:
        """tenant -> request count a payload charges against the
        fair-admission cap.  Tenant tags are guarded to strings (client
        input — a non-string tenant must not crash admission on an
        unhashable dict key; it admits uncapped like an untagged
        request, same rule as ``_tenant_label``).  A batch charges each
        MEMBER to its own effective tenant — the same ``r.get("tenant",
        payload_tenant)`` rule execution and telemetry apply — so
        neither one batch slot nor member-level tagging can smuggle
        sub-requests past the starvation bound.  Pure payload
        arithmetic: add and discard recompute it identically, so no
        per-pending state is needed."""
        base = cls._tenant_of(payload)
        if not isinstance(base, str):
            base = None
        if not (isinstance(payload, dict)
                and payload.get("op") == "batch"):
            return {base: 1} if base else {}
        reqs = payload.get("requests")
        if not isinstance(reqs, list) or not reqs:
            return {base: 1} if base else {}
        weights: Dict[str, int] = {}
        for r in reqs:
            t = r.get("tenant", base) if isinstance(r, dict) else base
            if not isinstance(t, str):
                t = None
            if t:
                weights[t] = weights.get(t, 0) + 1
        return weights

    def _live_add(self, pending: _Pending):
        """Register a request in the live set, enforcing the per-tenant
        cap atomically in the same critical section.  Returns
        ``(admitted, over_tenant)``: ``(False, <tenant>)`` means that
        tenant is over cap and the request was NOT registered (the
        caller sheds with reason ``tenant_cap``, charged to that
        tenant; a batch admits or sheds whole — it occupies one queue
        slot).

        The DERIVED default cap (no explicit ``tenant_max_pending``) is
        work-conserving: it only bites once a second distinct tenant
        has been seen (``self._tenants`` — shed and resolution labeling
        both register tenants, so a starved newcomer activates the cap
        within one round-trip).  Fairness between tenants is vacuous
        with one tenant, and halving a sole tenant's capacity against
        nobody would be pure waste.  An explicit cap always applies."""
        weights = self._tenant_weights(pending.payload)
        for t in weights:
            # register at submission so a starved newcomer activates
            # the derived cap immediately, not only after it resolves
            self._tenant_label(t)
        cap = self._tenant_pending_cap()
        if cap and self.opts.tenant_max_pending is None and \
                len(self._tenants) < 2:
            cap = 0
        with self._live_lock:
            if cap:
                for tenant, weight in weights.items():
                    if self._tenant_live.get(tenant, 0) + weight > cap:
                        return False, tenant
            self._live.add(pending)
            for tenant, weight in weights.items():
                self._tenant_live[tenant] = \
                    self._tenant_live.get(tenant, 0) + weight
        return True, None

    def _live_discard(self, pending: _Pending) -> None:
        """Remove from the live set, keeping the per-tenant counts
        exact: both the worker and the watchdog discard the same
        pending, so only the acquisition that actually removes it may
        decrement."""
        with self._live_lock:
            if pending not in self._live:
                return
            self._live.discard(pending)
            for tenant, weight in \
                    self._tenant_weights(pending.payload).items():
                n = self._tenant_live.get(tenant, 0) - weight
                if n > 0:
                    self._tenant_live[tenant] = n
                else:
                    self._tenant_live.pop(tenant, None)

    # -- workers -------------------------------------------------------------
    @staticmethod
    def _tenant_of(payload: Any) -> Optional[str]:
        """The request's tenant tag — THE one extraction shed, timeout
        and recording all share (a payload is client input: any shape)."""
        return payload.get("tenant") if isinstance(payload, dict) else None

    def _tenant_label(self, tenant: Optional[str]) -> Optional[str]:
        """The bounded per-tenant histogram label: the first
        ``tenant_cap`` distinct tenants get their own series, later ones
        aggregate under ``other`` (still measured, never unbounded)."""
        if not tenant or not isinstance(tenant, str):
            return None
        if tenant in self._tenants:
            return tenant
        if len(self._tenants) < max(0, self.opts.tenant_cap):
            self._tenants.add(tenant)
            return tenant
        return "other"

    def _resolve_one(self, request: Dict[str, Any],
                     tenant: Optional[str] = None) -> Dict[str, Any]:
        # the split lock: exact hits
        # resolve lock-free against the resolver's immutable snapshot —
        # workers serve them CONCURRENTLY — and only the fallback
        # (store writes, cold enqueues, the near tier, cache refills)
        # takes the exclusive lock.  pct99 at high QPS is then bounded
        # by the hit's own microseconds, not by queue depth times the
        # slowest request ahead of it.
        # embedded/stub services without a resolver attribute keep the
        # pre-split behavior: everything through the exclusive lock
        resolver = getattr(self.service, "resolver", None)
        key = (fp_cache_key(request if request else {})
               if resolver is not None else None)
        t0 = time.perf_counter()
        res = resolver.resolve_fast(key) if resolver is not None else None
        if res is not None:
            dt_us = (time.perf_counter() - t0) * 1e6
        else:
            from tenzing_tpu_torch.bench.driver import DriverRequest

            with self._resolve_lock:
                # timed inside the lock: resolve_us is the resolution's
                # own latency (the serve.resolve_us series), not
                # queue/lock wait
                t0 = time.perf_counter()
                req = DriverRequest(**(request or {}))
                res = (self.service.query(req, fp_key=key)
                       if resolver is not None
                       else self.service.query(req))
                dt_us = (time.perf_counter() - t0) * 1e6
        # response serialization is a real phase of a hit: timed and
        # sub-spanned like the resolver's fingerprint and cache-probe
        # phases
        tr = get_tracer()
        t_ser = time.perf_counter()
        if tr.enabled:
            with tr.span("serve.serialize", tier=res.tier):
                out = res.to_json()
        else:
            out = res.to_json()
        ser_us = round((time.perf_counter() - t_ser) * 1e6, 2)
        out.setdefault("phase_us", {})["serialize"] = ser_us
        out["resolve_us"] = round(dt_us, 1)
        self._bump(f"served_{res.tier}")
        label = self._tenant_label(tenant)
        if label is not None:
            reg = get_metrics()
            reg.counter(f"serve.tenant.{label}.{res.tier}").inc()
            # small WINDOWED cap (obs/metrics.py): one long-lived loop
            # serves many tenants, and the snapshot percentiles must
            # cover the recent window, not the first 4096 ever seen
            reg.histogram(f"serve.tenant.{label}.resolve_us",
                          max_raw=4096, window=True).observe(dt_us)
        return out

    def _handle(self, pending: _Pending) -> Dict[str, Any]:
        payload = pending.payload
        op = payload.get("op", "query")
        if op == "ping":
            return {"ok": True, "pong": True, "owner": self.owner}
        if op == "metrics":
            # the on-demand twin of the heartbeat's snapshot documents
            return {"ok": True, "metrics": self._snapshots.build(
                state="serving", extra=self._snapshot_extra())}
        if op == "stats":
            with self._resolve_lock:
                return {"ok": True, "stats": self.service.stats()}
        tenant = payload.get("tenant")
        if op == "batch":
            reqs = payload.get("requests") or []
            self._bump("batches")
            get_metrics().counter("serve.listen.batches").inc()
            results = []
            for r in reqs:
                req = r.get("request", r) if isinstance(r, dict) else {}
                t = r.get("tenant", tenant) if isinstance(r, dict) else tenant
                try:
                    results.append(self._resolve_one(req, tenant=t))
                except StoreReadonlyError as e:
                    # degraded read-only: this member needed a store
                    # write (near/cold) — shed it explicitly; exact
                    # members of the same batch still answer above
                    self._bump("shed")
                    results.append(self._readonly_shed_doc(e))
                except Exception as e:
                    results.append({"error": str(e)[:500],
                                    "error_class": classify_error(e)})
            return {"ok": True, "results": results}
        try:
            return {"ok": True,
                    "result": self._resolve_one(payload.get("request") or {},
                                                tenant=tenant)}
        except StoreReadonlyError as e:
            self._bump("shed")
            return self._readonly_shed_doc(e)

    def _readonly_shed_doc(self, exc: BaseException) -> Dict[str, Any]:
        """The store-readonly shed response (the store's read-only latch,
        serve/store.py): transient by classification — the
        latch clears when a probe write lands, so retry-later is the
        honest hint.  Exact-tier traffic never sees this: the sealed
        cache keeps answering throughout the outage."""
        get_metrics().counter("serve.shed").inc()
        return {"ok": False, "shed": True, "reason": "store_readonly",
                "retry_after": self.opts.shed_retry_after_secs,
                "error": str(exc)[:300], "error_class": "transient"}

    def _next_pending(self):
        """One queue fetch: a bounded ``get_nowait()`` spin first
        (``busy_poll_us``), then the blocking wait.  A request landing
        during the spin window is picked up at sub-microsecond latency
        instead of paying the condition-variable wake floor; a quiet
        window degrades to exactly the old blocking behavior."""
        spin_s = self.opts.busy_poll_us / 1e6
        if spin_s > 0 and not self._stop.is_set():
            deadline = time.perf_counter() + spin_s
            while True:
                try:
                    return self._queue.get_nowait()
                except _queue.Empty:
                    if self._stop.is_set() or \
                            time.perf_counter() >= deadline:
                        break
        return self._queue.get(timeout=0.1)

    def _worker(self) -> None:
        while True:
            try:
                pending = self._next_pending()
            except _queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                if pending.done:
                    continue  # timed out while queued: already answered
                try:
                    # the request's trace context is ambient for the
                    # whole handling: resolution spans, a cold enqueue's
                    # envelope, and any store flush all stamp it
                    with obs_context.use(pending.ctx):
                        doc = self._handle(pending)
                except Exception as e:
                    self._bump("errors")
                    get_metrics().counter("serve.listen.errors").inc()
                    doc = {"ok": False, "error": str(e)[:500],
                           "error_class": classify_error(e)}
                # a late result loses to the watchdog silently: the
                # client already got its transient-classified timeout
                if pending.complete(doc):
                    self._record(pending, doc)
            finally:
                self._live_discard(pending)
                self._queue.task_done()

    def _watchdog(self) -> None:
        while not self._abandon.is_set():
            now = time.time()
            with self._live_lock:
                overdue = [p for p in self._live
                           if p.deadline is not None and now > p.deadline
                           and not p.done]
            for p in overdue:
                doc = {
                    "ok": False, "timed_out": True,
                    "error": (f"request exceeded "
                              f"{self.opts.request_timeout_secs}s "
                              "watchdog"),
                    "error_class": "transient",
                    "retry_after": self.opts.shed_retry_after_secs}
                if p.complete(doc):
                    self._bump("timeouts")
                    reg = get_metrics()
                    reg.counter("serve.listen.timeouts").inc()
                    # per-tenant timeout twin of serve.shed.<tenant>
                    label = self._tenant_label(self._tenant_of(p.payload))
                    if label is not None:
                        reg.counter(f"serve.timeout.{label}").inc()
                    self._record(p, doc)
                self._live_discard(p)
            # sleep on ABANDON, not stop: once stop is set (the whole
            # drain window) a stop.wait would return instantly and this
            # loop would spin a core while contending _live_lock
            if self._abandon.wait(0.05):
                return
            if self._stop.is_set() and not self._live and \
                    self._queue.empty():
                return

    # -- recording (serve/reqlog.py) -----------------------------------------
    def _record(self, pending: _Pending, doc: Dict[str, Any]) -> None:
        """Append this completed request to the request log and offer it
        to the exemplar store — one record per resolved request (batch
        members each get their own), carrying the request's own kwargs so
        the query stream can be issued again."""
        if self._reqlog is None:
            return
        from tenzing_tpu_torch.serve.reqlog import RECORD_VERSION

        payload = (pending.payload
                   if isinstance(pending.payload, dict) else {})
        op = payload.get("op", "query")
        if op not in ("query", "batch"):
            return
        trace_id = pending.ctx.trace_id if pending.ctx is not None else None
        tenant = self._tenant_of(payload)
        if doc.get("shed"):
            outcome = "shed"
        elif doc.get("timed_out"):
            outcome = "timeout"
        elif not doc.get("ok"):
            outcome = "error"
        else:
            outcome = "served"
        if op == "batch":
            reqs = payload.get("requests") or []
            results = doc.get("results") or [None] * len(reqs)
            triples = []
            for r, res in zip(reqs, results):
                req = r.get("request", r) if isinstance(r, dict) else {}
                t = (r.get("tenant", tenant)
                     if isinstance(r, dict) else tenant)
                triples.append((req, t, res))
        else:
            triples = [(payload.get("request") or {}, tenant,
                        doc.get("result"))]
        for req, t, res in triples:
            res = res if isinstance(res, dict) else {}
            # the whole-request outcome, refined per batch member: a
            # batch answered ok can still carry individual errors
            out = outcome
            if out == "served" and "tier" not in res:
                out = "error"
            rec: Dict[str, Any] = {
                "v": RECORD_VERSION,
                "ts": pending.enqueued_at,
                "trace_id": trace_id,
                "tenant": t,
                "op": op,
                "outcome": out,
                "request": req,
            }
            if out in ("error", "timeout", "shed"):
                rec["error_class"] = (res.get("error_class")
                                      or doc.get("error_class"))
            if "tier" in res:
                fp = res.get("fingerprint") or {}
                rec.update({
                    "tier": res.get("tier"),
                    "workload": fp.get("workload"),
                    "exact": fp.get("exact"),
                    "bucket": fp.get("bucket_digest"),
                    "resolve_us": res.get("resolve_us"),
                    "phase_us": res.get("phase_us"),
                })
            interesting = None
            if out in ("shed", "timeout", "error"):
                interesting = out
            elif (res.get("provenance") or {}).get("verified") is False:
                interesting = "unverified"
            try:
                # recording must never take the serving path down: a
                # full disk (or a record a caller made unserializable)
                # costs the record, not the response — and never the
                # worker/watchdog thread it would otherwise kill
                self._reqlog.append(rec)
                if self._exemplars is not None:
                    self._exemplars.offer(rec, interesting=interesting)
            except Exception as e:
                self._log(f"request-log append failed "
                          f"({type(e).__name__}: {e})")

    def _record_tick(self) -> None:
        """The heartbeat's recording housekeeping: publish the buffered
        log records every ``record_flush_secs`` (a SIGKILLed loop then
        loses at most one cadence window) and close the exemplar
        window (slowest-K per heartbeat window)."""
        if self._reqlog is None:
            return
        now = time.time()
        try:
            # sealed batches rotate on the request path with zero I/O;
            # THIS thread pays their fsyncs every heartbeat, and the
            # partial buffer every record_flush_secs
            self._reqlog.publish_pending()
            if now - self._last_record_flush >= \
                    self.opts.record_flush_secs:
                self._last_record_flush = now
                self._reqlog.flush()
        except OSError as e:
            self._log(f"request-log flush failed ({e})")
        if self._exemplars is not None:
            self._exemplars.roll()

    def _snapshot_extra(self) -> Dict[str, Any]:
        """The loop-level block metric snapshots carry beside the raw
        registry: the counters the status doc publishes, the derived
        queue-age / shed-rate gauges, the loop's uptime, and — so the
        recorder is itself observable — the request-log position."""
        out: Dict[str, Any] = {
            "counters": dict(self.counters),
            "queue_depth": self._queue.qsize(),
            "in_flight": len(self._live),
            "uptime_s": round(time.time() - self.started_at, 1)}
        ro = store_readonly(self._store_path)
        if ro is not None:
            # present while degraded, absent once the heartbeat's probe
            # write lands
            out["store_readonly"] = ro
        if self._reqlog is not None:
            out["reqlog"] = self._reqlog.position()
        return out

    def _observe_gauges(self) -> None:
        reg = get_metrics()
        reg.gauge("serve.queue_depth").set(float(self._queue.qsize()))
        # queue age: the oldest still-unanswered request's wait so far —
        # depth says how many, age says how badly they are aging
        now = time.time()
        with self._live_lock:
            oldest = min((p.enqueued_at for p in self._live
                          if not p.done), default=None)
        reg.gauge("serve.queue_age_s").set(
            round(now - oldest, 3) if oldest is not None else 0.0)
        # shed rate over the last heartbeat window (sheds/sec)
        t0, sheds0 = self._shed_window
        sheds = self.counters.get("shed", 0)
        dt = max(1e-6, now - t0)
        reg.gauge("serve.shed_rate").set(round((sheds - sheds0) / dt, 4))
        self._shed_window = (now, sheds)

    def _heartbeat(self) -> None:
        while not self._stop.wait(self.opts.heartbeat_secs):
            if self._store_path is not None and \
                    store_readonly(self._store_path) is not None:
                # degraded read-only: one tiny probe write per heartbeat
                # (through the same atomic seam real writes use) clears
                # the latch the moment the filesystem recovers — near/
                # cold resolution resumes without operator action
                if probe_store_writable(self._store_path):
                    self._log("store writable again — resuming "
                              "near/cold tiers")
            self._write_status("serving")
            self._observe_gauges()
            try:
                self._snapshots.write(state="serving",
                                      extra=self._snapshot_extra())
            except OSError as e:
                self._log(f"metrics snapshot failed ({e})")
            self._record_tick()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self.opts.trace_out:
            from tenzing_tpu_torch.obs.tracer import configure

            configure(enabled=True)
        for i in range(max(1, self.opts.workers)):
            t = threading.Thread(target=self._worker,
                                 name=f"serve-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        for fn, name in ((self._watchdog, "serve-watchdog"),
                         (self._heartbeat, "serve-heartbeat")):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        self._write_status("serving")

    def stop(self) -> None:
        """Stop intake; workers drain what is queued (the programmatic
        twin of SIGTERM)."""
        self._stop.set()

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait for queued + in-flight work to finish; True when fully
        drained."""
        self._stop.set()
        deadline = time.time() + timeout
        while time.time() < deadline and not self._abandon.is_set():
            with self._live_lock:
                live = len(self._live)
            if live == 0 and self._queue.empty():
                break
            time.sleep(0.02)
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.time()))
        ok = self._queue.empty()
        # seal the recording before the final snapshot so the position
        # block in the "stopped" snapshot reflects the published truth
        if self._exemplars is not None:
            self._exemplars.roll()
        if self._reqlog is not None:
            try:
                self._reqlog.flush()
            except OSError as e:
                self._log(f"request-log flush failed ({e})")
        self._write_status("stopped")
        self._observe_gauges()
        try:
            self._snapshots.write(state="stopped",
                                  extra=self._snapshot_extra())
        except OSError as e:
            self._log(f"metrics snapshot failed ({e})")
        if self.opts.trace_out:
            # the loop's own telemetry bundle
            from tenzing_tpu_torch.obs.export import write_jsonl
            from tenzing_tpu_torch.obs.tracer import get_tracer as _gt

            try:
                write_jsonl(_gt(), self.opts.trace_out)
                self._log(f"trace bundle: {self.opts.trace_out}")
            except OSError as e:
                self._log(f"trace bundle failed ({e})")
        return ok

    def _on_signal(self, signum, frame) -> None:
        self.counters["signals"] += 1
        if self.counters["signals"] >= 2:
            self._abandon.set()
        self._stop.set()

    def _install_signals(self) -> None:
        if not self.opts.handle_signals:
            return
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev_handlers[sig] = signal.signal(sig, self._on_signal)

    def _restore_signals(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (OSError, ValueError):
                pass
        self._prev_handlers.clear()

    def summary(self) -> Dict[str, Any]:
        out = {"owner": self.owner, "counters": dict(self.counters),
               "status": self.status_path,
               "wall_s": round(time.time() - self.started_at, 3)}
        if self._reqlog is not None:
            out["reqlog"] = self._reqlog.position()
        if self._exemplars is not None:
            out["exemplars"] = self._exemplars.written
        return out

    # -- transports ----------------------------------------------------------
    def serve_stdin(self, stdin=None, stdout=None) -> Dict[str, Any]:
        """JSONL over stdin/stdout until EOF or a signal; then drain."""
        stdin = stdin if stdin is not None else sys.stdin
        stdout = stdout if stdout is not None else sys.stdout
        out_lock = threading.Lock()

        def respond(doc: Dict[str, Any]) -> None:
            with out_lock:
                stdout.write(json.dumps(doc) + "\n")
                stdout.flush()

        self._install_signals()
        self.start()
        self._log(f"listening on stdin (status {self.status_path})")
        try:
            for line in stdin:
                if self._stop.is_set():
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    payload = json.loads(line)
                except ValueError as e:
                    self._bump("malformed")
                    respond({"ok": False,
                             "error": f"bad json: {str(e)[:200]}",
                             "error_class": "deterministic"})
                    continue
                self.submit(payload, respond)
        finally:
            self.drain()
            self._restore_signals()
        return self.summary()

    def serve_socket(self, path: Optional[str] = None) -> Dict[str, Any]:
        """JSONL over a unix domain socket until a signal (or
        ``idle_exit_secs`` of silence); concurrent connections each get
        a reader thread; responses serialize per connection."""
        path = path or self.opts.socket_path
        try:
            os.unlink(path)
        except OSError:
            pass
        srv = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        srv.bind(path)
        srv.listen(16)
        srv.settimeout(0.25)
        self._install_signals()
        self.start()
        self._log(f"listening on {path} (status {self.status_path})")
        conn_threads: List[threading.Thread] = []

        def client(conn: _socket.socket) -> None:
            wlock = threading.Lock()

            def respond(doc: Dict[str, Any]) -> None:
                data = (json.dumps(doc) + "\n").encode()
                with wlock:
                    conn.sendall(data)

            buf = b""
            try:
                conn.settimeout(0.25)
                while not self._abandon.is_set():
                    try:
                        chunk = conn.recv(1 << 16)
                    except _socket.timeout:
                        if self._stop.is_set():
                            break
                        continue
                    except OSError:
                        break
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        if not line.strip():
                            continue
                        try:
                            payload = json.loads(line)
                        except ValueError as e:
                            self._bump("malformed")
                            respond({"ok": False,
                                     "error": f"bad json: {str(e)[:200]}",
                                     "error_class": "deterministic"})
                            continue
                        self.submit(payload, respond)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

        try:
            while not self._stop.is_set():
                if (self.opts.idle_exit_secs is not None
                        and not self._live and self._queue.empty()
                        and time.time() - self.last_request_at
                        >= self.opts.idle_exit_secs):
                    self._log(f"idle for {self.opts.idle_exit_secs}s — "
                              "exiting")
                    break
                try:
                    conn, _ = srv.accept()
                except _socket.timeout:
                    continue
                except OSError:
                    break
                # prune dead readers so days of short-lived connections
                # don't accumulate one Thread object each
                conn_threads[:] = [t for t in conn_threads if t.is_alive()]
                t = threading.Thread(target=client, args=(conn,),
                                     daemon=True)
                t.start()
                conn_threads.append(t)
        finally:
            try:
                srv.close()
            except OSError:
                pass
            self.drain()
            for t in conn_threads:
                t.join(timeout=1.0)
            try:
                os.unlink(path)
            except OSError:
                pass
            self._restore_signals()
        return self.summary()
