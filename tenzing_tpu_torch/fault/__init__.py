"""Fault tolerance of the measurement loop (counterpart of
``tenzing_tpu/fault``): a long search survives a failed measurement, a hung
one, a broken candidate, a lost device and a Ctrl-C without losing what it
measured.

* :mod:`~tenzing_tpu_torch.fault.errors` — the failure taxonomy
  (transient / deterministic / device lost) and :func:`classify_error`,
  with the serving plane's store errors (``FencedWriteError``,
  ``StoreReadonlyError``, ``StoreLockTimeout``);
* :mod:`~tenzing_tpu_torch.fault.backoff` — the bounded-retry helper;
* :mod:`~tenzing_tpu_torch.fault.quarantine` — the persistent quarantine of
  deterministically broken schedules;
* :mod:`~tenzing_tpu_torch.fault.resilient` — :class:`ResilientBenchmarker`:
  the soundness gate, the watchdog (with :mod:`~tenzing_tpu_torch.fault.cancel`,
  so a timed-out attempt launches nothing more), classified retry, rank
  agreement, degradation;
* :mod:`~tenzing_tpu_torch.fault.checkpoint` — the measurement journal and
  solver cursors (``--checkpoint DIR --resume``);
* :mod:`~tenzing_tpu_torch.fault.inject` — seeded chaos
  (``--inject-faults``);
* :mod:`~tenzing_tpu_torch.fault.fsinject` — seeded hostile-filesystem
  faults behind utils/atomic.py's seam (``$TENZING_FSINJECT``);
* :mod:`~tenzing_tpu_torch.fault.fschaos` — the serving plane's
  hostile-filesystem drill (``python -m tenzing_tpu_torch.fault.fschaos``).
"""

from tenzing_tpu_torch.fault.backoff import BackoffPolicy, retry_call
from tenzing_tpu_torch.fault.checkpoint import (
    CheckpointError,
    JournalingBenchmarker,
    SearchCheckpoint,
    atomic_write_json,
    read_checked_json,
)
from tenzing_tpu_torch.fault.errors import (
    DeterministicScheduleError,
    DeviceLostError,
    FaultClass,
    FencedWriteError,
    MeasurementTimeout,
    QuarantinedScheduleError,
    StoreLockTimeout,
    StoreReadonlyError,
    TransientError,
    UnsoundScheduleError,
    classify_error,
    fault_code,
    is_transient_io,
    is_unwritable_io,
)
from tenzing_tpu_torch.fault.inject import (
    FaultInjectingBenchmarker,
    InjectSpec,
    InjectedDeterministicError,
    InjectedTransientError,
    corrupt_schedule,
    parse_inject_specs,
)
from tenzing_tpu_torch.fault.quarantine import Quarantine
from tenzing_tpu_torch.fault.resilient import ResilientBenchmarker

__all__ = [
    "BackoffPolicy",
    "CheckpointError",
    "DeterministicScheduleError",
    "DeviceLostError",
    "FaultClass",
    "FaultInjectingBenchmarker",
    "FencedWriteError",
    "InjectSpec",
    "InjectedDeterministicError",
    "InjectedTransientError",
    "JournalingBenchmarker",
    "MeasurementTimeout",
    "Quarantine",
    "QuarantinedScheduleError",
    "ResilientBenchmarker",
    "SearchCheckpoint",
    "StoreLockTimeout",
    "StoreReadonlyError",
    "TransientError",
    "UnsoundScheduleError",
    "atomic_write_json",
    "classify_error",
    "corrupt_schedule",
    "fault_code",
    "is_transient_io",
    "is_unwritable_io",
    "parse_inject_specs",
    "read_checked_json",
    "retry_call",
]
