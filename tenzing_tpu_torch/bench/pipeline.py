"""Async compile pipeline: overlap CUDA-graph capture with measurement.

Counterpart of ``tenzing_tpu/bench/pipeline.py``.  The port's compile stage
is the executor's capture of a schedule as CUDA graphs
(``StreamExecutor.precompile``, runtime/executor.py): host work that
otherwise runs inside the measurement path, on the schedule's first
``prepare_n``.  The solvers know (or can cheaply guess) their next
candidates, so :class:`PrefetchingBenchmarker` wraps the measurement
benchmarker and accepts **candidate hints**: ``prefetch(orders)`` starts
captures on a bounded background thread pool while the foreground measures.
An in-flight dedup map captures each schedule at most once; a foreground
``benchmark()`` for a schedule whose capture is still in flight joins it
(paying only the remainder) instead of capturing a duplicate.

A background capture touches nothing the foreground uses: it runs on
streams and events of its own (``CaptureContext``), in ``thread_local``
capture mode, and the foreground's device syncs fall back to stream syncs
while it runs (runtime/graphs.py ``device_sync``).

Fault discipline — background threads never raise into the search:

* a background capture failure is recorded (classified by
  ``fault/errors.classify_error`` for telemetry) and **surfaced on the
  foreground ``benchmark()`` call** for that schedule: the stored exception
  is raised once, on the caller's thread, exactly as an inline capture
  failure would be.  The raise consumes it, so a retry reaches a fresh
  foreground attempt.
* hints are *advisory*: they consume no solver RNG and touch no search
  state, and a full queue drops hints rather than blocking — with prefetch
  off (or every hint dropped) the search is the same.

Observability: ``pipeline.prefetch.issued`` / ``hits`` / ``wasted`` /
``failed`` / ``surfaced`` / ``dropped`` counters, a ``pipeline.queue_depth``
gauge, and a ``pipeline.precompile`` span per background capture (the
executor's ``executor.compile`` spans, ``aot: true``, give the capture
wall).

Shutdown: ``close()`` cancels queued captures and joins the workers (no
leaked threads); a SIGINT/SIGABRT trap handler (utils/trap.py) only flips
the closed flag — it must not touch pool locks the interrupted thread may
hold.

``rank`` (a learn/surrogate.py ``SurrogateBenchmarker``, the driver's
``--learn-screen`` model) orders each new hint batch by its predicted time,
fastest first, so the captures most likely to be measured start first.
Unlike the reference, which ignores a failed prediction there, the port
lets it raise (ROADMAP Queue 3).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import List, Optional

from tenzing_tpu_torch.bench.benchmarker import BenchOpts, BenchResult, schedule_id
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.utils import trap


class PrefetchingBenchmarker:
    """Candidate-hint capture prefetcher (see module docstring).

    ``executor`` is anything with ``precompile(order) -> bool`` (and
    optionally ``is_compiled(order) -> bool``): the ``StreamExecutor`` or
    ``FusedExecutor`` the measurement runs on, a fake in tests.
    ``workers`` bounds the pool; ``depth`` (default ``4 * workers``) bounds
    the in-flight queue — excess hints are dropped (re-hintable later),
    never queued unboundedly."""

    def __init__(self, inner, executor, workers: int = 2,
                 depth: Optional[int] = None, rank=None):
        self.inner = inner
        self.executor = executor
        self.workers = max(1, int(workers))
        self.depth = int(depth) if depth is not None else 4 * self.workers
        self.rank = rank
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="tz-prefetch")
        self._lock = threading.Lock()
        self._inflight: dict = {}   # schedule id -> Future
        self._failed: dict = {}     # schedule id -> background capture exc
        self._ready: set = set()    # captured, not yet consumed
        self._seen: set = set()     # ids ever submitted (dedup)
        self._closed = False
        # tallies mirrored into the metrics registry; read by the driver's
        # ``perf`` block and the pipeline tests
        self.issued = 0
        self.hits = 0
        self.failed = 0
        self.surfaced = 0
        self.dropped = 0
        # forward the batch protocol only when the wrapped benchmarker
        # offers it
        if hasattr(inner, "benchmark_batch_times"):
            self.benchmark_batch_times = self._batch_times
        self.rank_coherent = getattr(inner, "rank_coherent", False)
        self._wasted_counted = False
        self._trap_registered = True
        trap.register_handler(self._trap_cancel)

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "PrefetchingBenchmarker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _trap_cancel(self) -> None:
        """SIGINT/SIGABRT path: ONLY flip the closed flag — no pool calls
        (``ThreadPoolExecutor.shutdown`` takes the lock every ``submit()``
        holds, and the trap runs on the interrupted thread).  The flag
        stops new work; :meth:`close` cancels and joins."""
        self._closed = True

    def close(self) -> None:
        """Cancel queued captures and join the workers.  Idempotent; after
        close every hint is a no-op and ``wasted()`` is final."""
        self._closed = True
        if self._trap_registered:
            self._trap_registered = False
            trap.unregister_handler(self._trap_cancel)
        # cancel_futures drops queued work; the join waits for the captures
        # running now (a capture cannot be interrupted)
        self._pool.shutdown(wait=True, cancel_futures=True)
        if not self._wasted_counted:
            self._wasted_counted = True
            get_metrics().counter("pipeline.prefetch.wasted").inc(
                self.wasted())

    def wasted(self) -> int:
        """Schedules captured in the background that no foreground
        benchmark consumed (yet): the cost of speculation."""
        with self._lock:
            return len(self._ready)

    def stats(self) -> dict:
        """The driver's ``perf.prefetch`` block (the reference's keys)."""
        return {
            "workers": self.workers,
            "issued": self.issued,
            "hits": self.hits,
            "wasted": self.wasted(),
            "failed": self.failed,
            "surfaced": self.surfaced,
            "dropped": self.dropped,
        }

    # -- hinting ------------------------------------------------------------
    def prefetch(self, orders) -> int:
        """Accept candidate hints; returns how many background captures
        were issued.  Non-Sequence orders, duplicates, schedules already
        captured, and hints beyond the queue bound are skipped — dropped
        hints may be re-hinted later."""
        if self._closed:
            return 0
        cands: List[Sequence] = [o for o in orders
                                 if isinstance(o, Sequence)]
        # the live set is read without the lock: _seen is mutated only by
        # prefetch() itself, membership is GIL-atomic, and the re-check
        # under the lock below is authoritative
        cands = [o for o in cands if schedule_id(o) not in self._seen]
        if not cands:
            return 0
        if self.rank is not None and len(cands) > 1:
            cands = sorted(cands, key=lambda o: self.rank.predict(o)[0])
        reg = get_metrics()
        is_compiled = getattr(self.executor, "is_compiled", None)
        issued = 0
        for order in cands:
            key = schedule_id(order)
            with self._lock:
                if self._closed or key in self._seen:
                    continue
                if len(self._inflight) >= self.depth:
                    self.dropped += 1
                    reg.counter("pipeline.prefetch.dropped").inc()
                    continue
                if is_compiled is not None and is_compiled(order):
                    self._seen.add(key)  # nothing to do, ever
                    continue
                self._seen.add(key)
                try:
                    fut = self._pool.submit(self._compile_one, key, order)
                except RuntimeError:  # pool shut down
                    self._seen.discard(key)
                    break
                self._inflight[key] = fut
                depth = len(self._inflight)
            issued += 1
            self.issued += 1
            reg.counter("pipeline.prefetch.issued").inc()
            reg.gauge("pipeline.queue_depth").set(depth)
        return issued

    def _compile_one(self, key: str, order: Sequence) -> None:
        """Worker body: capture one schedule, record success or failure.
        Errors are stored for the foreground, never raised into the pool."""
        reg = get_metrics()
        tr = get_tracer()
        try:
            with tr.span("pipeline.precompile", schedule=key):
                self.executor.precompile(order)
            with self._lock:
                self._ready.add(key)
        except BaseException as e:  # noqa: BLE001 — classified + surfaced
            from tenzing_tpu_torch.fault.errors import classify_error

            reg.counter("pipeline.prefetch.failed").inc()
            if tr.enabled:
                tr.event("pipeline.precompile_failed", schedule=key,
                         error=type(e).__name__,
                         error_class=classify_error(e),
                         message=str(e)[:200])
            with self._lock:
                self.failed += 1
                self._failed[key] = e
        finally:
            with self._lock:
                self._inflight.pop(key, None)
                depth = len(self._inflight)
            reg.gauge("pipeline.queue_depth").set(depth)

    # -- foreground join ----------------------------------------------------
    def _join(self, order, cancel_queued: bool = True) -> None:
        """Settle any in-flight background capture for ``order``: one
        already running is waited on (the foreground pays only the
        remainder); with ``cancel_queued``, one still queued behind a
        backlog (more in flight than workers) is cancelled, and the
        foreground captures it inline."""
        with self._lock:
            fut = self._inflight.get(schedule_id(order))
            backlog = len(self._inflight) > self.workers
        if fut is None:
            return
        if cancel_queued and backlog and fut.cancel():
            with self._lock:
                self._inflight.pop(schedule_id(order), None)
                depth = len(self._inflight)
            get_metrics().gauge("pipeline.queue_depth").set(depth)
            return
        wait([fut])

    def _consume(self, order) -> None:
        """Count a prefetch hit and raise a stored background failure on the
        caller's thread, once (the raise consumes it)."""
        key = schedule_id(order)
        with self._lock:
            exc = self._failed.pop(key, None)
            hit = key in self._ready
            self._ready.discard(key)
        reg = get_metrics()
        if hit:
            self.hits += 1
            reg.counter("pipeline.prefetch.hits").inc()
        if exc is not None:
            self.surfaced += 1
            reg.counter("pipeline.prefetch.surfaced").inc()
            raise exc

    def benchmark(self, order, opts: Optional[BenchOpts] = None) -> BenchResult:
        if isinstance(order, Sequence):
            self._join(order)
            self._consume(order)
        return self.inner.benchmark(order, opts)

    def _batch_times(self, orders, opts: Optional[BenchOpts] = None,
                     seed: int = 0, **kw):
        """The batch protocol: the members are hinted (captured across the
        pool before the inner batch warms them), joined and consumed; a
        stored failure for any member surfaces here.  Extra keywords reach
        the inner batch only when given."""
        self.prefetch(orders)
        for o in orders:
            if isinstance(o, Sequence):
                self._join(o)
                self._consume(o)
        return self.inner.benchmark_batch_times(orders, opts, seed=seed,
                                                **kw)
