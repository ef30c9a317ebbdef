"""Failure taxonomy of the measurement loop.

Counterpart of ``tenzing_tpu/fault/errors.py`` (:35-200), with the
serving plane's store errors (``StoreLockTimeout``, ``FencedWriteError``,
``StoreReadonlyError``) and its I/O predicates (:func:`is_unwritable_io`,
:func:`is_transient_io`).  A measurement — capture a candidate schedule
as CUDA graphs, replay it fenced on the card, reduce across ranks — fails in
three ways, and each calls for a different response:

* **transient** — *the measurement* failed, not the schedule: a process
  group timed out or lost a connection, the mesh shift's hand-off missed
  its host-side deadline (ops/rdma.py ``await_shift``, which releases the
  stuck wait, so the context stays usable).  Retrying is correct.
* **deterministic** — the *schedule* is broken: it cannot be captured, it
  does not fit in device memory, a shape contract is violated.  Retrying
  pays the same failure again.
* **device_lost** — the card's context is gone.  A *sticky* CUDA error (an
  illegal address or instruction, a launch failure or timeout, a
  misaligned address, a device-side assert, an uncorrectable ECC error)
  leaves every later call in the process failing; no retry can help.

:func:`classify_error` maps an exception to one of these classes: a
device loss first (the marker type, or a loss's message anywhere in the
chain of causes), then the marker types below by ``isinstance``, then
message patterns in the order capture, deterministic, transient.  On the
card:

* a capture error is **deterministic for that schedule** — the stream
  capture rejected one of its operations: ``cudaErrorStreamCaptureUnsupported``
  ("operation not permitted when stream is capturing"),
  ``cudaErrorStreamCaptureInvalidated``, ``cudaErrorStreamCaptureUnjoined``,
  ``cudaErrorStreamCaptureIsolation``, ``cudaErrorStreamCaptureImplicit``,
  ``cudaErrorCapturedEvent``, ``cudaErrorStreamCaptureWrongThread`` and
  ``runtime/executor.py``'s ``CaptureError``;
* the sticky errors above are **device_lost**, and so is **every other
  error of the CUDA runtime or its libraries** ("CUDA error: ...",
  ``CUBLAS_STATUS_*``) that is not a capture error, wherever it sits in the
  chain of causes (an op's error that ``CaptureError`` wraps included): the
  port never goes on in a process after one, however sticky it is, so a
  fault is never taken for a slow or a broken schedule;
* ``CUDA out of memory`` (the caching allocator's own error, raised
  before anything launches; the context stays usable) is deterministic;
* what is **transient**: process-group timeouts and connection errors
  (gloo, NCCL's watchdog), the shift's missed deadline ("timed out"), and
  ``OSError`` / ``TimeoutError`` / ``ConnectionError``.

Unknown errors default to **deterministic**: mistaking a transient for a
deterministic failure costs one candidate, the reverse costs a retry of a
failing schedule at every encounter.
"""

from __future__ import annotations

import errno as _errno


class FaultClass:
    """The three failure classes, ordered by severity (a rank-agreement
    protocol takes the maximum code over the ranks)."""

    OK = "ok"
    TRANSIENT = "transient"
    DETERMINISTIC = "deterministic"
    DEVICE_LOST = "device_lost"

    CODES = {OK: 0, TRANSIENT: 1, DETERMINISTIC: 2, DEVICE_LOST: 3}
    FROM_CODE = {v: k for k, v in CODES.items()}


class TransientError(RuntimeError):
    """A measurement attempt failed for reasons unrelated to the schedule;
    retry."""


class MeasurementTimeout(TransientError):
    """The watchdog's wall-clock bound fired (fault/resilient.py): the
    measurement hung.  Transient: the retry starts once the abandoned
    attempt has drained off the card."""


class StoreLockTimeout(TransientError):
    """The serving store's manifest lock stayed contended past the bounded
    backoff (the segmented store, serve/segments.py).  Transient: the
    rival writer finishes, and the operation is retried later."""


class DeterministicScheduleError(RuntimeError):
    """The schedule itself is broken (capture, shape, memory)."""


class QuarantinedScheduleError(DeterministicScheduleError):
    """Raised instead of measuring a schedule already quarantined."""


class UnsoundScheduleError(DeterministicScheduleError):
    """The independent soundness verifier (verify/) rejected the schedule:
    a data dependency is unordered or lanes race.  Quarantined and never
    measured."""


class DeviceLostError(RuntimeError):
    """The device is unrecoverable; escalate (degrade or abort)."""


class FencedWriteError(RuntimeError):
    """A write refused by the lease epoch fence (serve/lease.py): a rival
    claim with a newer epoch exists, so this holder is a zombie (reclaimed
    during a stall) and its write would be stale.  Classified transient
    (the item is in better hands, never evidence against the request); the
    daemon abandons the item without retrying or poisoning it."""


class StoreReadonlyError(TransientError):
    """The schedule store is latched read-only (ENOSPC / EROFS / quota:
    serve/store.py ``store_readonly``): a cold or near resolution would need
    a durable write that cannot land.  Transient: the latch clears on a
    successful probe write."""


# errno values that mean "the filesystem takes no more bytes": not a flake,
# not worth retries on a millisecond scale; the store latches read-only
_UNWRITABLE_ERRNOS = frozenset(
    getattr(_errno, name) for name in ("ENOSPC", "EDQUOT", "EROFS")
    if hasattr(_errno, name))


def is_unwritable_io(exc: BaseException) -> bool:
    """True iff ``exc`` is an OSError of the full-disk family (ENOSPC,
    EDQUOT, EROFS): the store degrades to read-only until a probe write
    succeeds."""
    return (isinstance(exc, OSError)
            and getattr(exc, "errno", None) in _UNWRITABLE_ERRNOS)


def is_transient_io(exc: BaseException) -> bool:
    """The retry predicate of durable store writes (fault/backoff.py): an
    I/O flake (EIO and the like) retries, the unwritable family does not."""
    return isinstance(exc, OSError) and not is_unwritable_io(exc)


# message fragments, checked lowercase, in this order (a sticky error
# message may also say "timed out": a launch timeout is a loss)
_DEVICE_LOST_PATTERNS = (
    "device lost",
    "device_lost",
    "illegal memory access",
    "illegal address",
    "illegal instruction",
    "unspecified launch failure",
    "launch failure",
    "launch timed out",
    "misaligned address",
    "device-side assert",
    "uncorrectable ecc",
    "hardware stack error",
    "invalid program counter",
    "gpu has fallen off the bus",
    "no cuda-capable device",
)
# the CUDA runtime's and its libraries' own errors, as torch words them
_CUDA_ERROR_PATTERNS = (
    "cuda error",
    "cudaerror",
    "cublas_status",
    "cusparse_status",
    "cusolver_status",
)
_CAPTURE_PATTERNS = (
    "streamcapture",
    "stream is capturing",
    "during capture",
    "capture sequence",
    "capturing stream",
    "capturing blocking stream",
    "uncaptured work",
    "capturedevent",
    "cannot capture",
)
_DETERMINISTIC_PATTERNS = (
    "out of memory",
    "invalid argument",
    "invalid_argument",
    "unimplemented",
    "not yet ported",
    "shape",
)
_TRANSIENT_PATTERNS = (
    "timed out",
    "timeout",
    "deadline",
    "connection reset",
    "connection refused",
    "connection closed",
    "broken pipe",
    "socket closed",
    "unavailable",
    "transient",
    "temporarily",
)


def _cuda_loss(exc: BaseException) -> bool:
    """True when ``exc`` or an exception in its chain of causes carries a
    device-lost message or a CUDA error that is not a capture error."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        msg = str(exc).lower()
        if any(p in msg for p in _DEVICE_LOST_PATTERNS):
            return True
        if (any(p in msg for p in _CUDA_ERROR_PATTERNS)
                and not any(p in msg for p in _CAPTURE_PATTERNS)):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def classify_error(exc: BaseException) -> str:
    """Map an exception to a :class:`FaultClass` string (module docstring)."""
    if isinstance(exc, DeviceLostError) or _cuda_loss(exc):
        return FaultClass.DEVICE_LOST
    if isinstance(exc, FencedWriteError):
        # a zombie's refused write: the rival that fenced it drains the item
        return FaultClass.TRANSIENT
    if isinstance(exc, DeterministicScheduleError):
        return FaultClass.DETERMINISTIC
    if isinstance(exc, TransientError):
        return FaultClass.TRANSIENT
    msg = str(exc).lower()
    for pat in _CAPTURE_PATTERNS + _DETERMINISTIC_PATTERNS:
        if pat in msg:
            return FaultClass.DETERMINISTIC
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return FaultClass.TRANSIENT
    for pat in _TRANSIENT_PATTERNS:
        if pat in msg:
            return FaultClass.TRANSIENT
    if isinstance(exc, OSError):
        return FaultClass.TRANSIENT
    return FaultClass.DETERMINISTIC


def fault_code(exc: BaseException) -> int:
    """Numeric severity code of an exception's class."""
    return FaultClass.CODES[classify_error(exc)]
