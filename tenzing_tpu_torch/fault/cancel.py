"""The measurement cancel token: how a timed-out attempt stops launching.

A measurement the watchdog abandons (fault/resilient.py) still runs on its
worker thread, and on the card that thread holds the executor: its buffers,
its lanes' streams, its captured graphs.  Left alone it would go on
launching beside the retry.  So the watchdog runs each attempt inside a
:func:`scope` holding a fresh :class:`threading.Event`, sets the event when
the bound fires, and waits for the worker to return before the next attempt
starts.  Whatever launches on the worker's thread calls :func:`check` first
— the stream executor before each segment it replays and each eager run
(runtime/graphs.py, runtime/executor.py) — and an injected hang waits on
the token instead of sleeping (:func:`wait`, fault/inject.py), so a
cancelled attempt launches nothing more and returns.

Outside a scope :func:`check` is a no-op and :func:`wait` sleeps.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

_local = threading.local()


class MeasurementCancelled(RuntimeError):
    """Raised on a worker thread whose attempt the watchdog abandoned.  No
    caller sees it: the watchdog has already raised ``MeasurementTimeout``
    on the foreground."""


def current() -> Optional[threading.Event]:
    """The calling thread's cancel token, or None outside a scope."""
    return getattr(_local, "token", None)


@contextmanager
def scope(token: threading.Event):
    """Run the body with ``token`` as this thread's cancel token."""
    prev = current()
    _local.token = token
    try:
        yield token
    finally:
        _local.token = prev


def check() -> None:
    """Raise :class:`MeasurementCancelled` if this thread's attempt was
    cancelled; a no-op outside a scope."""
    token = current()
    if token is not None and token.is_set():
        raise MeasurementCancelled("measurement cancelled by the watchdog")


def wait(secs: float) -> None:
    """Sleep ``secs``, or until this thread's attempt is cancelled (then
    raise :class:`MeasurementCancelled`)."""
    token = current()
    if token is None:
        time.sleep(secs)
        return
    if token.wait(secs):
        raise MeasurementCancelled("measurement cancelled by the watchdog")
