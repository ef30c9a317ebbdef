"""ResilientBenchmarker: soundness gate, watchdog, classified retry,
quarantine, rank agreement and degradation.

Counterpart of ``tenzing_tpu/fault/resilient.py``.  It wraps any
benchmarker (``benchmark(order, opts) -> BenchResult``;
``benchmark_batch_times`` where the wrapped one has it) with the
reference's fault policy:

* **soundness gate** — with a ``verifier``, every schedule is verified
  before anything is launched: an unsound one (a dropped or misplaced sync,
  from a solver bug or injected corruption) is quarantined and refused as
  ``UnsoundScheduleError``, without device time;
* **classification** (fault/errors.py) — transient: bounded retry with
  backoff and jitter; deterministic: persistent quarantine
  (fault/quarantine.py) and raise; device lost: degrade or raise;
* **rank agreement** — before and after each attempt every rank takes the
  maximum fault code over the ranks (``ControlPlane.agree_fault``), so the
  ranks retry, quarantine and escalate together;
* **degradation** — with a ``fallback`` benchmarker, a lost device turns
  every later query into a fallback answer (:meth:`was_degraded` marks
  them; the journal tags them ``degraded`` and never restores them), and
  ``on_degrade`` runs once (the driver closes the capture prefetcher, so
  nothing touches the device again).

Two things differ on the card, where a measurement holds the executor (its
buffers, its lanes' streams, its captured graphs):

* **the watchdog never leaves two measurements on the card.**  Each
  attempt runs on the benchmarker's one measurement thread inside a cancel
  scope (fault/cancel.py).  When ``timeout_secs`` passes, the token is set
  — the executor launches no further segment and an injected hang ends —
  and the next attempt starts only once the abandoned one has returned
  (within the drain bound, :data:`DRAIN_FLOOR_SECS` or the watchdog's own
  bound if that is longer) and ``quiesce`` (the driver's device sync,
  ``runtime/graphs.device_sync``) has returned.  A worker that does not
  return within the drain bound means the card is stuck: ``device_lost``.
  The reference abandons the worker and retries at once, which on the card
  would run the retry beside a live attempt.  An attempt's bound is
  ``timeout_secs`` (per schedule, for a batch, as the reference's) plus
  the time its options make it take (``bench.benchmarker.
  measurement_floor_s``; nothing for ``opts=None``), so a short bound
  catches a hang without cutting a final batch of 15 x 0.4 s a
  schedule.
* **a CUDA error never lets the process go on.**  A *sticky* error (an
  illegal address, a device-side assert, a launch failure) leaves the
  context unusable; it classifies ``device_lost``, and without a fallback
  ``DeviceLostError`` leaves the search — the journal and the quarantine
  are on disk by then, and ``--resume`` in a new process is the recovery.
  After any other failure ``quiesce`` runs before the error is handled: if
  the context is broken, the sync raises and the failure is a device loss.

``rank_coherent = True`` tells the solvers that a failure this layer
raised is the same on every rank, so they may reject the candidate and
search on (solve/mcts, solve/dfs, solve/local) — except ``DeviceLostError``,
which always propagates.
"""

from __future__ import annotations

import queue
import random as _random
import threading
import time
from typing import Callable, List, Optional

from tenzing_tpu_torch.bench.benchmarker import (
    BenchOpts,
    BenchResult,
    measurement_floor_s,
    schedule_id,
)
from tenzing_tpu_torch.fault import cancel
from tenzing_tpu_torch.fault.backoff import BackoffPolicy
from tenzing_tpu_torch.fault.errors import (
    DeviceLostError,
    FaultClass,
    MeasurementTimeout,
    QuarantinedScheduleError,
    UnsoundScheduleError,
    classify_error,
)
from tenzing_tpu_torch.fault.quarantine import Quarantine
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.progress import get_reporter
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.parallel.control_plane import ControlPlane, default_control_plane

# the least time an abandoned attempt gets to return after its token is set
# (a segment in flight, or a kernel, finishes within it); a longer watchdog
# bound drains for as long as it
DRAIN_FLOOR_SECS = 1.0


class _MeasureThread:
    """The one daemon thread every watched attempt runs on.  One thread for
    the benchmarker's life: a capture on it warms its cuBLAS handles once
    (runtime/graphs.py ``warm_stream``), and a stuck attempt blocks it, as
    it blocks the card, for good."""

    def __init__(self):
        self._jobs: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tz-measure")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            fn, token, out, done = self._jobs.get()
            try:
                with cancel.scope(token):
                    out["res"] = fn()
            except BaseException as e:  # noqa: BLE001 — handed to the caller
                out["exc"] = e
            finally:
                done.set()

    def submit(self, fn: Callable, token: threading.Event):
        out: dict = {}
        done = threading.Event()
        self._jobs.put((fn, token, out, done))
        return out, done


class ResilientBenchmarker:
    """The fault-policy wrapper (module docstring)."""

    rank_coherent = True

    def __init__(
        self,
        inner,
        control_plane: Optional[ControlPlane] = None,
        timeout_secs: Optional[float] = None,
        policy: Optional[BackoffPolicy] = None,
        quarantine: Optional[Quarantine] = None,
        fallback=None,
        sleep=time.sleep,
        seed: int = 0,
        verifier=None,
        quiesce: Optional[Callable[[], None]] = None,
        on_degrade: Optional[Callable[[], None]] = None,
    ):
        self.inner = inner
        self.cp = control_plane if control_plane is not None else (
            default_control_plane())
        self.timeout_secs = timeout_secs
        self.policy = policy if policy is not None else BackoffPolicy()
        self.quarantine = quarantine if quarantine is not None else Quarantine()
        self.fallback = fallback
        self.verifier = verifier
        self.quiesce = quiesce
        self.on_degrade = on_degrade
        self._sleep = sleep
        self._rng = _random.Random(seed)
        self._worker: Optional[_MeasureThread] = None
        self.degraded = False
        self._degraded_keys: set = set()
        if hasattr(inner, "benchmark_batch_times"):
            self.benchmark_batch_times = self._batch_times

    # -- provenance ------------------------------------------------------------
    def was_degraded(self, order) -> bool:
        """True if the fallback answered ``order`` after a device loss."""
        return schedule_id(order) in self._degraded_keys

    # -- the soundness gate ----------------------------------------------------
    def _check_sound(self, order) -> None:
        """Refuse an unsound schedule before anything launches: quarantine
        it and raise :class:`UnsoundScheduleError` with the witness."""
        if self.verifier is None:
            return
        verdict = self.verifier(order)
        if verdict.ok:
            return
        from tenzing_tpu_torch.verify.soundness import report_unsound

        report_unsound("resilient.benchmark", order, verdict)
        err = UnsoundScheduleError(
            f"schedule fails soundness verification: {verdict.witness()}")
        self.quarantine.add(order, err, FaultClass.DETERMINISTIC)
        raise err

    # -- the watchdog ------------------------------------------------------------
    def _call_with_timeout(self, timeout: Optional[float], fn):
        """``fn()`` bounded by ``timeout`` seconds (None: unbounded, on the
        caller's thread).  On timeout the attempt's token is set and this
        waits for it to return and for the device to go quiet before
        raising :class:`MeasurementTimeout`; an attempt that does not
        return within the drain bound raises ``DeviceLostError``."""
        if timeout is None:
            return fn()
        if self._worker is None:
            self._worker = _MeasureThread()
        token = threading.Event()
        out, done = self._worker.submit(fn, token)
        if not done.wait(timeout):
            token.set()
            get_metrics().counter("fault.watchdog.fired").inc()
            drain = max(timeout, DRAIN_FLOOR_SECS)
            if not done.wait(drain):
                get_metrics().counter("fault.watchdog.stuck").inc()
                raise DeviceLostError(
                    f"the measurement did not return within {drain}s of its "
                    f"{timeout}s watchdog: the device is stuck")
            if self.quiesce is not None:
                self.quiesce()
            raise MeasurementTimeout(
                f"measurement exceeded {timeout}s wall clock (watchdog; the "
                "attempt was cancelled and drained)")
        if "exc" in out:
            raise out["exc"]
        return out["res"]

    def _bound(self, opts, n_series: int, batch: bool) -> Optional[float]:
        """One attempt's watchdog bound (None: unbounded): ``timeout_secs``
        per series plus the measurement's own floor."""
        if self.timeout_secs is None:
            return None
        return (self.timeout_secs * n_series
                + measurement_floor_s(opts, n_series, batch))

    def _classify(self, exc: BaseException) -> int:
        """The fault code of a failed attempt.  A failure that is not
        already a device loss is followed by ``quiesce``: a sticky CUDA
        error shows there, and makes it one."""
        cls = classify_error(exc)
        if cls != FaultClass.DEVICE_LOST and self.quiesce is not None:
            try:
                self.quiesce()
            except Exception:  # noqa: BLE001 — the context is broken
                get_metrics().counter("fault.quiesce_failed").inc()
                cls = FaultClass.DEVICE_LOST
        return FaultClass.CODES[cls]

    # -- degradation -------------------------------------------------------------
    def _degrade_or_raise(self, exc: Optional[BaseException]) -> None:
        if self.fallback is None:
            get_metrics().counter("fault.device_lost_fatal").inc()
            err = DeviceLostError(
                "device lost and no fallback benchmarker configured"
                + (f" ({type(exc).__name__}: {str(exc)[:300]})"
                   if exc is not None else ""))
            if exc is not None:
                raise err from exc
            raise err
        if not self.degraded:
            self.degraded = True
            get_metrics().counter("fault.degraded").inc()
            if self.on_degrade is not None:
                self.on_degrade()
            tr = get_tracer()
            if tr.enabled:
                tr.event("fault.degraded",
                         error=type(exc).__name__ if exc else None,
                         message=str(exc)[:200] if exc else None)
            get_reporter().warn(
                "fault: device lost — degrading to the fallback benchmarker; "
                "later results carry degraded provenance",
                error=type(exc).__name__ if exc else None)

    def _answer_degraded(self, order, opts) -> BenchResult:
        res = self.fallback.benchmark(order, opts)
        self._degraded_keys.add(schedule_id(order))
        get_metrics().counter("fault.degraded_answers").inc()
        return res

    # -- the resilient measurement loop ------------------------------------------
    def benchmark(self, order, opts: Optional[BenchOpts] = None) -> BenchResult:
        if self.degraded:
            return self._answer_degraded(order, opts)
        rec = self.quarantine.check(order)
        if rec is not None:
            get_metrics().counter("fault.quarantine_hits").inc()
            tr = get_tracer()
            if tr.enabled:
                tr.event("fault.quarantine_hit",
                         schedule=self.quarantine.key(order),
                         error=rec.get("error"))
            raise QuarantinedScheduleError(
                f"schedule quarantined ({rec.get('error')}: "
                f"{rec.get('message', '')[:200]})")
        self._check_sound(order)
        tr = get_tracer()
        reg = get_metrics()
        attempts = self.policy.retries + 1
        for attempt in range(attempts):
            self.cp.agree_fault(0)
            res: Optional[BenchResult] = None
            exc: Optional[BaseException] = None
            code = 0
            try:
                res = self._call_with_timeout(
                    self._bound(opts, 1, False),
                    lambda: self.inner.benchmark(order, opts))
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                exc = e
                code = self._classify(e)
            agreed = int(self.cp.agree_fault(code))
            if agreed == FaultClass.CODES[FaultClass.OK]:
                return res  # type: ignore[return-value]
            cls = FaultClass.FROM_CODE.get(agreed, FaultClass.DETERMINISTIC)
            reg.counter(f"fault.errors.{cls}").inc()
            if tr.enabled:
                tr.event("fault.error", where="bench.benchmark",
                         schedule=schedule_id(order), attempt=attempt + 1,
                         error=type(exc).__name__ if exc else "peer-rank",
                         error_class=cls,
                         message=str(exc)[:200] if exc else None)
            if cls == FaultClass.DEVICE_LOST:
                self._degrade_or_raise(exc)
                return self._answer_degraded(order, opts)
            if cls == FaultClass.DETERMINISTIC:
                self.quarantine.add(
                    order, exc if exc is not None
                    else RuntimeError("peer-rank failure"), cls)
                if exc is not None:
                    raise exc
                raise QuarantinedScheduleError(
                    "deterministic failure on a peer rank")
            if attempt == attempts - 1:
                if exc is not None:
                    raise exc
                raise MeasurementTimeout(
                    "transient failure on a peer rank; retries exhausted")
            delay = self.policy.delay(attempt, self._rng)
            reg.counter("fault.retries").inc()
            if tr.enabled:
                tr.event("fault.retry", where="bench.benchmark",
                         schedule=schedule_id(order), attempt=attempt + 1,
                         error=type(exc).__name__ if exc else "peer-rank",
                         error_class=cls, delay_secs=round(delay, 4))
            if delay > 0.0:
                self._sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover

    # -- decorrelated batches ------------------------------------------------------
    def _batch_times(
        self,
        orders: List,
        opts: Optional[BenchOpts] = None,
        seed: int = 0,
        times_out: Optional[List[List[float]]] = None,
        group_seeds=None,
    ) -> List[List[float]]:
        """``benchmark_batch_times`` under the watchdog (scaled by the number
        of schedules) with transient retries; no quarantine (a batch failure
        cannot be pinned on one schedule), but every member passes the
        soundness gate first.  Each attempt measures into fresh lists; the
        caller's ``times_out`` is filled from a completed attempt only."""
        if self.degraded:
            raise DeviceLostError(
                "batch benchmarking unavailable in degraded mode")
        for order in orders:
            self._check_sound(order)
        timeout = self._bound(opts, max(1, len(orders)), True)
        tr = get_tracer()
        reg = get_metrics()
        kw = {} if group_seeds is None else {"group_seeds": group_seeds}
        attempts = self.policy.retries + 1
        for attempt in range(attempts):
            self.cp.agree_fault(0)
            exc = None
            code = 0
            out: Optional[List[List[float]]] = None
            try:
                out = self._call_with_timeout(
                    timeout, lambda: self.inner.benchmark_batch_times(
                        orders, opts, seed=seed, **kw))
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                exc = e
                code = self._classify(e)
            agreed = int(self.cp.agree_fault(code))
            if agreed == FaultClass.CODES[FaultClass.OK]:
                if times_out is None:
                    return out  # type: ignore[return-value]
                for dst, src in zip(times_out, out):
                    dst.clear()
                    dst.extend(src)
                return times_out
            cls = FaultClass.FROM_CODE.get(agreed, FaultClass.DETERMINISTIC)
            reg.counter(f"fault.errors.{cls}").inc()
            if tr.enabled:
                tr.event("fault.error", where="bench.batch",
                         attempt=attempt + 1,
                         error=type(exc).__name__ if exc else "peer-rank",
                         error_class=cls,
                         message=str(exc)[:200] if exc else None)
            if cls != FaultClass.TRANSIENT or attempt == attempts - 1:
                if cls == FaultClass.DEVICE_LOST:
                    self._degrade_or_raise(exc)
                    raise DeviceLostError(
                        "device lost mid-batch; a batch cannot degrade")
                if exc is not None:
                    raise exc
                raise MeasurementTimeout("peer-rank batch failure")
            if times_out is not None:
                for ts in times_out:
                    ts.clear()
            delay = self.policy.delay(attempt, self._rng)
            reg.counter("fault.retries").inc()
            if tr.enabled:
                tr.event("fault.retry", where="bench.batch",
                         attempt=attempt + 1, delay_secs=round(delay, 4),
                         error=type(exc).__name__ if exc else "peer-rank")
            if delay > 0.0:
                self._sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover
