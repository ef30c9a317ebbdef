"""The measurement loop's failure taxonomy (counterpart of the part of
``tenzing_tpu/fault`` that the compile stage and the prefetch pipeline
need: fault/errors.py)."""

from tenzing_tpu_torch.fault.errors import (
    DeterministicScheduleError,
    DeviceLostError,
    FaultClass,
    TransientError,
    classify_error,
    fault_code,
)

__all__ = ["FaultClass", "TransientError", "DeterministicScheduleError",
           "DeviceLostError", "classify_error", "fault_code"]
