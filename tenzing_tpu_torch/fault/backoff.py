"""Bounded retry with exponential backoff and jitter.

Counterpart of ``tenzing_tpu/fault/backoff.py``: callers describe what to
retry (:class:`BackoffPolicy`, a ``retry_on`` predicate) and
:func:`retry_call` runs the loop, the sleeps and the telemetry — each retry
is a ``fault.retry`` trace event (attempt, error class, delay) and a
``fault.retries`` counter bump.  The jitter is a +/- fraction of the
exponential delay drawn from the caller's RNG, so a seeded caller gets the
reference's delays; sleeping is injectable for the same reason.
"""

from __future__ import annotations

import random as _random
import time
from dataclasses import dataclass
from typing import Callable, Optional, TypeVar

from tenzing_tpu_torch.fault.errors import FaultClass, classify_error
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer

T = TypeVar("T")


@dataclass(frozen=True)
class BackoffPolicy:
    """``retries`` extra attempts after the first; retry ``k`` (0-based)
    sleeps ``min(base_secs * factor**k, max_secs)`` +/- a ``jitter``
    fraction of itself."""

    retries: int = 3
    base_secs: float = 0.5
    factor: float = 2.0
    max_secs: float = 30.0
    jitter: float = 0.25

    def delay(self, retry_index: int, rng: Optional[_random.Random] = None) -> float:
        d = min(self.base_secs * (self.factor ** retry_index), self.max_secs)
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)


def _default_retry_on(exc: BaseException) -> bool:
    """Retry the transient class only: a deterministic failure pays the
    same failure again, and a lost device escalates."""
    return classify_error(exc) == FaultClass.TRANSIENT


def retry_call(
    fn: Callable[[], T],
    *,
    policy: Optional[BackoffPolicy] = None,
    retry_on: Optional[Callable[[BaseException], bool]] = None,
    where: str = "",
    on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[_random.Random] = None,
) -> T:
    """Call ``fn()`` with bounded classified retries; return its result.
    ``retry_on(exc)`` gates each retry (default: the transient class);
    ``on_retry(exc, attempt, delay)`` runs before each sleep.  The last
    failure re-raises."""
    policy = policy if policy is not None else BackoffPolicy()
    retry_on = retry_on if retry_on is not None else _default_retry_on
    rng = rng if rng is not None else _random.Random()
    attempts = policy.retries + 1
    for attempt in range(attempts):
        try:
            return fn()
        except BaseException as e:
            if attempt == attempts - 1 or not retry_on(e):
                raise
            delay = policy.delay(attempt, rng)
            get_metrics().counter("fault.retries").inc()
            tr = get_tracer()
            if tr.enabled:
                tr.event(
                    "fault.retry", where=where, attempt=attempt + 1,
                    error=type(e).__name__, error_class=classify_error(e),
                    message=str(e)[:200], delay_secs=round(delay, 4),
                )
            if on_retry is not None:
                on_retry(e, attempt, delay)
            if delay > 0.0:
                sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
