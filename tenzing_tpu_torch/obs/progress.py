"""ProgressReporter: human-readable search progress over the telemetry stream.

Counterpart of ``tenzing_tpu/obs/progress.py``.  Every human-facing progress
line of library code flows through the process-global reporter, which

1. writes the line to its stream (stderr by default — progress is diagnostics,
   never the machine-readable stdout the drivers own), and
2. mirrors it as a ``progress.<level>`` event into the global tracer, so an
   archived telemetry bundle contains the exact narrative a human saw
   interleaved with the spans that explain it.

The stream can be silenced (``ProgressReporter(stream=None)``) without losing
the event record — the telemetry bundle stays complete either way.
"""

from __future__ import annotations

import sys
from typing import Any, Optional, TextIO

from tenzing_tpu_torch.obs.tracer import get_tracer


class ProgressReporter:
    """stderr narrative + tracer event stream, one call site (see module doc).

    ``stream=None`` silences the console copy; the default resolves to the
    CURRENT ``sys.stderr`` at emit time (so pytest capture and stream
    redirection keep working).
    """

    def __init__(self, stream: Optional[TextIO] = "stderr"):
        self._stream = stream

    def _emit(self, level: str, message: str, attrs: Any) -> None:
        get_tracer().event(f"progress.{level}", message=message, **attrs)
        stream = sys.stderr if self._stream == "stderr" else self._stream
        if stream is not None:
            try:
                stream.write(message.rstrip("\n") + "\n")
                stream.flush()
            except Exception:
                pass  # a closed/broken stream must not take down the search

    def info(self, message: str, **attrs: Any) -> None:
        self._emit("info", message, attrs)

    def warn(self, message: str, **attrs: Any) -> None:
        self._emit("warn", message, attrs)

    def error(self, message: str, **attrs: Any) -> None:
        self._emit("error", message, attrs)


_GLOBAL = ProgressReporter()


def get_reporter() -> ProgressReporter:
    """The process-global reporter every library call site uses."""
    return _GLOBAL


def set_reporter(reporter: ProgressReporter) -> ProgressReporter:
    """Swap the process-global reporter (tests); returns the previous one."""
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, reporter
    return prev
