"""Device-side profiling under its old name: a shim over
:mod:`tenzing_tpu_torch.obs.attrib.xplane`.

Counterpart of ``tenzing_tpu/utils/profiling.py``, kept so that ``from
tenzing_tpu_torch.utils.profiling import analyze_trace`` works as the
reference's import does.  The port's reader classes a device activity by
its transfer keywords alone (the rest is compute), so the reference's
``COMPUTE_KEYWORDS`` and ``CONTROL_KEYWORDS`` have no counterpart here.
New code imports from ``obs/attrib``.
"""

from __future__ import annotations

from tenzing_tpu_torch.obs.attrib.xplane import (  # noqa: F401
    TRANSFER_KEYWORDS,
    analyze_trace,
    capture_trace,
    merge_intervals,
)

__all__ = [
    "TRANSFER_KEYWORDS",
    "analyze_trace",
    "capture_trace",
    "merge_intervals",
]
