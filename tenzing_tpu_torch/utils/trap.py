"""Signal trapping for partial-result dumps.

Counterpart of ``tenzing_tpu/utils/trap.py`` (reference ``src/trap.cpp:9-35``):
a SIGINT/SIGABRT handler so a wall-clock-limited job still dumps what it
explored before dying, and the prefetch pipeline (bench/pipeline.py) closes
its intake.

Callbacks registered here run *inside a signal handler*: they must not block
on locks the interrupted thread may hold, and one callback raising must not
silence the others (:func:`run_callbacks` isolates each).
"""

from __future__ import annotations

import signal
import sys
from typing import Callable, List

_callbacks: List[Callable[[], None]] = []
_prev_handlers: dict = {}


def run_callbacks() -> int:
    """Run every registered callback, isolating failures: a raising
    callback is reported on stderr and the rest still run.  Returns the
    number that failed.  Split out of the handler so it is testable without
    delivering a signal."""
    failed = 0
    for cb in list(_callbacks):
        try:
            cb()
        except Exception as e:
            failed += 1
            sys.stderr.write(f"trap: dump callback failed: {e}\n")
    return failed


def _handler(signum, frame):  # pragma: no cover - signal path
    run_callbacks()
    signal.signal(signum, signal.SIG_DFL)
    signal.raise_signal(signum)


def installed() -> bool:
    """True while the trap handler owns SIGINT/SIGABRT."""
    return bool(_prev_handlers)


def callbacks() -> List[Callable[[], None]]:
    """Snapshot of the registered callbacks (registration order)."""
    return list(_callbacks)


def register_handler(dump: Callable[[], None]) -> None:
    """Run ``dump`` on SIGINT/SIGABRT.  The handler is installed only from
    the main thread (Python allows no other); elsewhere the callback is
    still registered and :func:`run_callbacks` runs it."""
    _callbacks.append(dump)
    if not _prev_handlers:
        import threading

        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGABRT):
                _prev_handlers[sig] = signal.signal(sig, _handler)


def unregister_handler(dump: Callable[[], None]) -> None:
    """Remove a callback; the last removal restores the previous handlers."""
    if dump in _callbacks:
        _callbacks.remove(dump)
    if not _callbacks and _prev_handlers:
        for sig, prev in _prev_handlers.items():
            signal.signal(sig, prev)
        _prev_handlers.clear()
