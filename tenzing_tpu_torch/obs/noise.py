"""Measured host-noise floors: how much of a latency is the host's.

Counterpart of ``tenzing_tpu/obs/noise.py``, the same probes, block and
verdicts (``NOISE_VERSION``): a ``host_noise`` block either package writes
reads the same in the other.  A serving tail is only a serving fault when
it stands well above what the host itself costs, so this module makes that
floor a recorded quantity: two micro-probes, each sampled N times with the
benchmarker's noise rejection (bench/randomness.py runs test), summarized
into the ``host_noise`` block that ``serve/replay.py`` stamps into every
replay document.

* **timer-wake** — overshoot of a short ``time.sleep`` (requested against
  observed, in us): what a blocking wait costs on this host, the floor
  under any latency that includes a scheduler wake (condition variables,
  a bounded queue's hand-off, paced submission).
* **hot-spin** — overshoot of a busy-wait to a near deadline: the floor
  with the scheduler out of the picture, clock granularity plus
  preemption noise.

Readers (obs/report.py):

* the report renders the floor against the measured tail ("pct99 is 3.8x
  the wake floor — host-bound"), so a tail that sits on the floor is not
  taken for a serving fault;
* the replay regression check downgrades a comparison across hosts to
  ``inconclusive`` when the two documents' floors differ (:func:`floors_differ`):
  a slower host is not a regression.

Stdlib only; the probes take a ``clock`` and a ``sleeper``, so tests run
them against a scripted clock.
"""

from __future__ import annotations

import socket
import time
from typing import Any, Callable, Dict, List, Optional

from tenzing_tpu_torch.bench.randomness import runs_test_z
from tenzing_tpu_torch.utils.numeric import percentile

NOISE_VERSION = 1
DEFAULT_SAMPLES = 64
# requested sleep for the timer-wake probe: long enough that the request
# itself is not sub-granularity, short enough that 64 samples cost ~6ms
TIMER_SLEEP_US = 100.0
# busy-wait deadline for the hot-spin probe: a horizon near the short
# waits a serving hand-off makes
SPIN_TARGET_US = 20.0
# is_random's 95%-confidence default (bench/randomness.py)
RUNS_Z_CRIT = 1.96
# floors more than this factor apart (either direction) make two
# replay documents incomparable hosts (floors_differ)
FLOOR_DIFF_FACTOR = 2.0
# a measured tail within this factor of the wake floor is host-bound:
# the host's scheduler, not the serving path, owns the residual
HOST_BOUND_FACTOR = 5.0


def probe_timer_wake(samples: int = DEFAULT_SAMPLES,
                     sleep_us: float = TIMER_SLEEP_US,
                     clock: Optional[Callable[[], float]] = None,
                     sleeper: Optional[Callable[[float], None]] = None,
                     ) -> List[float]:
    """Overshoot (us) of ``samples`` short sleeps: observed minus
    requested, floored at 0 — the scheduler-wake latency floor."""
    clock = clock if clock is not None else time.perf_counter
    sleeper = sleeper if sleeper is not None else time.sleep
    req_s = sleep_us / 1e6
    out: List[float] = []
    for _ in range(max(1, int(samples))):
        t0 = clock()
        sleeper(req_s)
        out.append(max(0.0, (clock() - t0) * 1e6 - sleep_us))
    return out


def probe_hot_spin(samples: int = DEFAULT_SAMPLES,
                   target_us: float = SPIN_TARGET_US,
                   clock: Optional[Callable[[], float]] = None,
                   ) -> List[float]:
    """Overshoot (us) of ``samples`` busy-waits to a ``target_us``
    deadline — the no-scheduler floor (clock granularity + preemption)."""
    clock = clock if clock is not None else time.perf_counter
    out: List[float] = []
    for _ in range(max(1, int(samples))):
        t0 = clock()
        deadline = t0 + target_us / 1e6
        now = t0
        while now < deadline:
            now = clock()
        out.append(max(0.0, (now - t0) * 1e6 - target_us))
    return out


def series_summary(xs: List[float]) -> Dict[str, Any]:
    """p50/p99/mean/max over one probe series plus its runs-test verdict
    (``iid`` False flags drift/interference during the probe itself)."""
    s = sorted(xs)
    z = runs_test_z(xs)
    return {
        "count": len(s),
        "p50_us": round(percentile(s, 50), 2),
        "p99_us": round(percentile(s, 99), 2),
        "mean_us": round(sum(s) / len(s), 2),
        "max_us": round(s[-1], 2),
        "runs_z": round(z, 3),
        "iid": bool(abs(z) <= RUNS_Z_CRIT),
    }


def probe_host_noise(samples: int = DEFAULT_SAMPLES, retries: int = 1,
                     sleep_us: float = TIMER_SLEEP_US,
                     spin_target_us: float = SPIN_TARGET_US,
                     clock: Optional[Callable[[], float]] = None,
                     sleeper: Optional[Callable[[float], None]] = None,
                     ) -> Dict[str, Any]:
    """The ``host_noise`` block (module docstring): both probes, sampled
    ``samples`` times.  A series failing the runs test is re-probed (up
    to ``retries`` extra passes — the same reject-and-retry discipline
    bench/randomness.py gives measurements); the last pass is recorded
    either way, its ``iid`` flag telling the reader whether even the
    floor measurement was quiet."""
    attempts = 0
    wake = spin = None
    wake_s: Dict[str, Any] = {}
    spin_s: Dict[str, Any] = {}
    for attempt in range(max(0, int(retries)) + 1):
        attempts = attempt + 1
        wake = probe_timer_wake(samples, sleep_us, clock=clock,
                                sleeper=sleeper)
        spin = probe_hot_spin(samples, spin_target_us, clock=clock)
        wake_s, spin_s = series_summary(wake), series_summary(spin)
        if wake_s["iid"] and spin_s["iid"]:
            break
    return {
        "version": NOISE_VERSION,
        "samples": int(samples),
        "sleep_us": sleep_us,
        "spin_target_us": spin_target_us,
        "attempts": attempts,
        "timer_wake_us": wake_s,
        "hot_spin_us": spin_s,
        "host": socket.gethostname(),
        "measured_at": time.time(),
    }


def floors_differ(a: Optional[Dict[str, Any]], b: Optional[Dict[str, Any]],
                  factor: float = FLOOR_DIFF_FACTOR) -> Optional[str]:
    """Why two ``host_noise`` blocks are incomparable, or None when they
    are close enough (or either is missing — absence never *claims* a
    host difference).  Floors below 1us are clamped before the ratio so
    clock-granularity jitter cannot manufacture a 'different host'."""
    if not isinstance(a, dict) or not isinstance(b, dict):
        return None
    for key, label in (("timer_wake_us", "timer-wake"),
                       ("hot_spin_us", "hot-spin")):
        try:
            fa = max(1.0, float((a.get(key) or {}).get("p99_us")))
            fb = max(1.0, float((b.get(key) or {}).get("p99_us")))
        except (TypeError, ValueError):
            continue
        ratio = fa / fb if fa >= fb else fb / fa
        if ratio > factor:
            return (f"{label} p99 floor {fa:.1f}us vs {fb:.1f}us "
                    f"({ratio:.1f}x apart, > {factor:.1f}x)")
    return None


def floor_vs_tail(block: Optional[Dict[str, Any]], pct99_us: Optional[float],
                  host_bound_factor: float = HOST_BOUND_FACTOR,
                  ) -> Optional[Dict[str, Any]]:
    """The floor-vs-measured-tail verdict the report CLI renders: how
    many wake floors tall the measured pct99 is, and whether that makes
    the tail host-bound (the host's scheduler owns it) or serving-bound
    (the code does)."""
    if not isinstance(block, dict) or pct99_us is None:
        return None
    try:
        floor = float((block.get("timer_wake_us") or {}).get("p99_us"))
    except (TypeError, ValueError):
        return None
    ratio = float(pct99_us) / max(floor, 1e-9)
    host_bound = ratio <= host_bound_factor
    return {
        "wake_floor_p99_us": floor,
        "pct99_us": float(pct99_us),
        "ratio": round(ratio, 2),
        "host_bound": host_bound,
        "line": (f"pct99 {pct99_us:.1f}us is {ratio:.1f}x the measured "
                 f"wake floor ({floor:.1f}us) — "
                 f"{'host-bound' if host_bound else 'serving-bound'}"),
    }
