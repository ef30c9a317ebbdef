"""Seeded fault injection: the chaos harness for tests and chaos runs.

Counterpart of ``tenzing_tpu/fault/inject.py``, with its five kinds, its
grammar (``--inject-faults kind:rate:seed[,...]``) and its hash draws, so a
schedule that reaches both packages through serdes draws the same faults
and the same mutation in both:

* ``transient`` — raises :class:`InjectedTransientError` on a per-attempt
  draw (the resilient layer retries it);
* ``hang`` — stalls ``hang_secs`` on a per-attempt draw, then measures.
  The stall waits on the attempt's cancel token (fault/cancel.py): when the
  watchdog abandons the attempt the stall ends at once with
  ``MeasurementCancelled`` and the schedule is never measured on that
  thread, so an abandoned hang cannot measure beside the retry (the
  reference sleeps and then measures);
* ``deterministic`` — fails by schedule identity (a hash of the schedule id
  and the seed): the same ``rate`` fraction of candidates always fails,
  like a schedule that cannot be captured — the quarantine's target;
* ``device_lost`` — raises ``DeviceLostError`` on a per-attempt draw;
* ``corrupt`` — mutates the schedule by identity (drops or defers one sync
  op, :func:`corrupt_schedule`) before passing it on: what the soundness
  verifier exists to catch, so this injector sits *above* the resilient
  layer whose verifier must see the mutation.  Only mutations that
  ``unsound_check`` confirms count.

Per-attempt draws hash (kind, seed, schedule id, an attempt counter), not
process RNG state: every rank draws alike, and a restarted process that
re-asks the same queries draws the same faults.  The port counts attempts
per schedule *and fidelity* (``BenchOpts``), where the reference counts per
schedule: a resumed run answers every fidelity measured before from its
journal without asking the injector, so a per-schedule count would shift
the draws of a fidelity that failed before (a confirm whose retries ran
out) and measure it on resume.  A schedule asked at one fidelity draws as
in the reference.
"""

from __future__ import annotations

import hashlib
import random as _random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tenzing_tpu_torch.bench.benchmarker import BenchOpts, BenchResult, schedule_id
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.sync_ops import SyncOp
from tenzing_tpu_torch.fault import cancel
from tenzing_tpu_torch.fault.errors import (
    DeterministicScheduleError,
    DeviceLostError,
    TransientError,
)
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer

KINDS = ("transient", "hang", "deterministic", "device_lost", "corrupt")


class InjectedTransientError(TransientError):
    """A seeded injected transient failure."""


class InjectedDeterministicError(DeterministicScheduleError):
    """A seeded injected always-broken candidate."""


@dataclass(frozen=True)
class InjectSpec:
    """One injection channel: ``kind`` at probability ``rate`` from ``seed``."""

    kind: str
    rate: float
    seed: int


def parse_inject_specs(text: str) -> List[InjectSpec]:
    """Parse ``kind:rate:seed[,kind:rate:seed...]``.  Errors are loud: a
    mistyped spec that injected nothing would make a chaos run prove
    nothing."""
    specs: List[InjectSpec] = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) != 3:
            raise ValueError(
                f"--inject-faults spec {part!r}: want kind:rate:seed")
        kind, rate_s, seed_s = fields
        if kind not in KINDS:
            raise ValueError(
                f"--inject-faults kind {kind!r}: want one of {KINDS}")
        rate = float(rate_s)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"--inject-faults rate {rate!r} not in [0, 1]")
        specs.append(InjectSpec(kind=kind, rate=rate, seed=int(seed_s)))
    if not specs:
        raise ValueError("--inject-faults: empty spec")
    return specs


def _hash_draw(material: str) -> float:
    """A uniform [0, 1) draw from a content hash."""
    h = hashlib.sha256(material.encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


def _schedule_fails(sid: str, spec: InjectSpec) -> bool:
    """By schedule identity: hash(sid, seed) under the rate."""
    return _hash_draw(f"{sid}:{spec.seed}") < spec.rate


def _attempt_fires(sid: str, attempt: int, spec: InjectSpec) -> bool:
    """Per attempt: keyed on the channel, the schedule and its attempt
    counter."""
    return _hash_draw(f"{spec.kind}:{spec.seed}:{sid}:{attempt}") < spec.rate


def corrupt_schedule(
    order: Sequence,
    seed: int,
    unsound_check: Optional[Callable[[Sequence], bool]] = None,
) -> Optional[Sequence]:
    """A copy of ``order`` with one sync op dropped or deferred to the end,
    or None when no such mutation makes it detectably unsound.  Candidates
    are tried in a shuffle seeded by ``seed`` and the schedule id;
    ``unsound_check(mutated)`` decides which count (without one the first
    candidate is returned)."""
    ops = order.vector()
    sync_pos = [i for i, op in enumerate(ops) if isinstance(op, SyncOp)]
    if not sync_pos:
        return None
    cands = [("drop", i) for i in sync_pos]
    cands += [("defer", i) for i in sync_pos if i != len(ops) - 1]
    rng = _random.Random(f"{seed}:{schedule_id(order)}")
    rng.shuffle(cands)
    for kind, i in cands:
        if kind == "drop":
            mut = ops[:i] + ops[i + 1:]
        else:
            mut = ops[:i] + ops[i + 1:] + [ops[i]]
        seq = Sequence(mut)
        if unsound_check is None or unsound_check(seq):
            return seq
    return None


class FaultInjectingBenchmarker:
    """The chaos wrapper (module docstring).  ``injected`` counts injections
    by kind, ``calls`` the queries; ``corrupted`` maps each mutated
    schedule's id to its mutation's.  ``exempt_ids`` are spared the
    identity-keyed kinds (the driver's naive baseline); ``sleep`` stalls a
    hang (default: :func:`fault.cancel.wait`)."""

    def __init__(self, inner, specs: List[InjectSpec],
                 hang_secs: float = 60.0, sleep=cancel.wait,
                 unsound_check: Optional[Callable[[Sequence], bool]] = None,
                 exempt_ids: Optional[set] = None):
        self.inner = inner
        self.specs = list(specs)
        self.hang_secs = hang_secs
        self._sleep = sleep
        self._attempts: Dict[tuple, int] = {}  # (sid, opts) -> calls
        self.unsound_check = unsound_check
        self.exempt_ids: set = set(exempt_ids) if exempt_ids else set()
        self.calls = 0
        self.injected: Dict[str, int] = {k: 0 for k in KINDS}
        self.corrupted: Dict[str, str] = {}
        # batches are the verdict path, which chaos leaves alone
        if hasattr(inner, "benchmark_batch_times"):
            self.benchmark_batch_times = inner.benchmark_batch_times
        self.rank_coherent = getattr(inner, "rank_coherent", False)

    def was_degraded(self, order) -> bool:
        """Degraded provenance passes through the injector."""
        fn = getattr(self.inner, "was_degraded", None)
        return bool(fn(order)) if fn is not None else False

    def _record(self, kind: str, sid: str) -> None:
        self.injected[kind] += 1
        get_metrics().counter(f"fault.injected.{kind}").inc()
        tr = get_tracer()
        if tr.enabled:
            tr.event("fault.injected", kind=kind, schedule=sid)

    def benchmark(self, order, opts: Optional[BenchOpts] = None) -> BenchResult:
        self.calls += 1
        sid = schedule_id(order)
        key = (sid, None if opts is None else
               (opts.n_iters, opts.max_retries, opts.target_secs))
        attempt = self._attempts.get(key, 0)
        self._attempts[key] = attempt + 1
        for spec in self.specs:
            if spec.kind == "deterministic":
                if sid not in self.exempt_ids and _schedule_fails(sid, spec):
                    self._record("deterministic", sid)
                    raise InjectedDeterministicError(
                        f"injected deterministic failure (schedule {sid})")
            elif spec.kind == "corrupt":
                if (sid not in self.exempt_ids and _schedule_fails(sid, spec)
                        and isinstance(order, Sequence)):
                    mutated = corrupt_schedule(order, spec.seed,
                                               self.unsound_check)
                    if mutated is not None:
                        self._record("corrupt", sid)
                        self.corrupted[sid] = schedule_id(mutated)
                        order = mutated
            elif _attempt_fires(sid, attempt, spec):
                if spec.kind == "transient":
                    self._record("transient", sid)
                    raise InjectedTransientError(
                        f"injected transient failure (schedule {sid} "
                        f"attempt {attempt})")
                if spec.kind == "hang":
                    self._record("hang", sid)
                    self._sleep(self.hang_secs)
                elif spec.kind == "device_lost":
                    self._record("device_lost", sid)
                    raise DeviceLostError(
                        f"injected device loss (schedule {sid} "
                        f"attempt {attempt})")
        return self.inner.benchmark(order, opts)
