"""Empirical benchmarking of candidate schedules on the card.

Counterpart of ``tenzing_tpu/bench/benchmarker.py`` (reference
``include/tenzing/benchmarker.hpp`` / ``src/benchmarker.cpp``):

* ``BenchResult`` = percentiles 01/10/50/90/99 + stddev of per-iteration wall
  time (benchmarker.hpp:14-22).
* ``EmpiricalBenchmarker`` — the adaptive inner loop grows samples per
  measurement until one measurement takes >= ``target_secs``
  (benchmarker.cpp:83-119), ``n_iters`` measurements, and the whole set is
  re-measured if the runs test flags non-random structure (benchmarker.cpp:129-155).
* ``benchmark_batch_times`` — the decorrelated batch (benchmarker.cpp:21-76):
  iteration k visits every schedule once in a seeded random order, so paired
  per-iteration ratios cancel drift common to both schedules.
* ``benchmark_batch`` — the batch's times as one ``BenchResult`` a schedule.
* ``RepeatCallableRunner`` — named ``run_n(n)`` callables measured with the
  same protocol (a library call or a kernel alone beside the schedules).
* ``CachingBenchmarker`` — equivalence-keyed result cache.
* ``CsvBenchmarker`` — answers queries from a recorded search database
  (``result_row``'s format), matching schedules by equivalence
  (benchmarker.cpp:169-223): search experiments with no device.

Each measurement is ``wall(run_n(n)) - fence_overhead``: the executor's
``run_n`` runs the schedule n times on its streams and ends in one
``torch.cuda.synchronize()``, and the overhead is the median wall time of a
synchronize after one trivial launch (:meth:`EmpiricalBenchmarker._fetch_overhead`).

The control plane (parallel/control_plane.py) brackets each measurement as
the reference's does (tenzing_tpu/bench/benchmarker.py:163-170; original
tenzing benchmarker.cpp:43-60, 101, 145): a barrier before it, and the time
is the max over ranks, so every rank of a mesh schedule takes the same
decisions (sample growth, the runs test) and returns the same times.  At
world size 1 both are the identity.

Telemetry (obs/): ``bench.benchmark`` / ``bench.warm`` spans per schedule,
``bench.batch`` / ``bench.batch_warm`` per paired batch, ``bench.cache``
events, and the counters ``bench.benchmarks``, ``bench.measurements``,
``bench.runs_test_retries``, ``bench.cache.hits`` / ``.misses`` and the
``bench.cache.hit_rate`` gauge, at the reference's points.
"""

from __future__ import annotations

import json
import random as _random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tenzing_tpu_torch.bench.randomness import is_random
from tenzing_tpu_torch.core.sequence import Sequence, canonical_key
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer, short_digest
from tenzing_tpu_torch.parallel.control_plane import ControlPlane, default_control_plane
from tenzing_tpu_torch.utils.numeric import percentile, stddev


def schedule_id(order) -> str:
    """Short stable id of a schedule for telemetry (the reference's):
    ``short_digest`` of its schedule JSON, memoized on the sequence.  The
    same id in every span and event names the same schedule."""
    if isinstance(order, str):
        return order

    def derive() -> str:
        from tenzing_tpu_torch.core.serdes import sequence_to_json_str

        return short_digest(sequence_to_json_str(order))

    if isinstance(order, Sequence):
        return order.cached("schedule_id", derive)
    return derive()


def candidate_failed(where: str, order, exc: BaseException) -> None:
    """Record a candidate schedule whose measurement raised: a
    ``search.candidate_failed`` event (schedule id, exception class,
    message) and counter.  The caller then rejects the candidate and
    searches on where the benchmarker classified the failure
    (:func:`rejects_failures`), and re-raises otherwise."""
    get_metrics().counter("search.candidate_failed").inc()
    tr = get_tracer()
    if tr.enabled:
        tr.event("search.candidate_failed", where=where,
                 schedule=schedule_id(order), error=type(exc).__name__,
                 message=str(exc)[:200])


def rejects_failures(benchmarker, exc: BaseException) -> bool:
    """True when a search may take ``exc``, raised by ``benchmarker``, as a
    rejected candidate and search on: the benchmarker is rank-coherent
    (fault/resilient.py classified, agreed on and quarantined the failure)
    and the failure is not a device loss (``DeviceLostError``, or any CUDA
    error, fault/errors.py), which always leaves the search.  Any other
    failure propagates: without the resilient layer nothing established
    that the device is still usable."""
    from tenzing_tpu_torch.fault.errors import FaultClass, classify_error

    return (bool(getattr(benchmarker, "rank_coherent", False))
            and classify_error(exc) != FaultClass.DEVICE_LOST)


@dataclass
class BenchResult:
    """Percentile statistics of per-iteration wall time in seconds
    (reference Benchmark::Result, benchmarker.hpp:14-22).  ``times`` (the
    raw series) and ``fetch_overhead`` (what was subtracted per
    measurement) ride along and take no part in equality: a replayed result
    (:class:`CsvBenchmarker`) has no raw series."""

    pct01: float = 0.0
    pct10: float = 0.0
    pct50: float = 0.0
    pct90: float = 0.0
    pct99: float = 0.0
    stddev: float = 0.0
    times: Optional[List[float]] = field(default=None, compare=False,
                                         repr=False)
    fetch_overhead: Optional[float] = field(default=None, compare=False,
                                            repr=False)

    @staticmethod
    def from_times(times: List[float]) -> "BenchResult":
        s = sorted(times)
        return BenchResult(
            pct01=percentile(s, 1),
            pct10=percentile(s, 10),
            pct50=percentile(s, 50),
            pct90=percentile(s, 90),
            pct99=percentile(s, 99),
            stddev=stddev(s),
            times=list(times),
        )

    def to_json(self) -> dict:
        """The reference's JSON form (the checkpoint journal's ``result``):
        the percentiles, and ``times`` / ``fetch_overhead`` where present.
        Floats round-trip through JSON exactly."""
        out = {"pct01": self.pct01, "pct10": self.pct10, "pct50": self.pct50,
               "pct90": self.pct90, "pct99": self.pct99,
               "stddev": self.stddev}
        if self.times is not None:
            out["times"] = list(self.times)
        if self.fetch_overhead is not None:
            out["fetch_overhead"] = self.fetch_overhead
        return out


def fence_overhead_s(device) -> float:
    """Median wall time of the fence alone on ``device``: one trivial launch
    followed by the executor's device sync on the card
    (runtime/graphs.py ``device_sync``: ``torch.cuda.synchronize`` unless a
    capture is in progress), a trivial op on the CPU, over 7 calls after a
    first one excluded."""
    import torch

    from tenzing_tpu_torch.runtime.graphs import device_sync

    device = torch.device(device)
    x = torch.zeros((), device=device)

    def fence() -> None:
        x.add_(1.0)
        if device.type == "cuda":
            device_sync(device)

    fence()  # first launch excluded
    ts = []
    for _ in range(7):
        t0 = time.perf_counter()
        fence()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


@dataclass
class BenchOpts:
    """reference Benchmark::Opts (benchmarker.hpp:24-30)."""

    n_iters: int = 1000
    max_retries: int = 10
    target_secs: float = 0.01  # adaptive floor per measurement (benchmarker.cpp:85)


def measurement_floor_s(opts: Optional["BenchOpts"], n_series: int = 1,
                        batch: bool = False) -> float:
    """About twice the wall time a measurement at ``opts`` takes by design:
    ``n_series`` series (a batch's schedules) of ``n_iters`` measurements of
    at least ``target_secs`` each, and for a single schedule up to
    ``max_retries`` series (the runs test re-measures).  The watchdog adds
    it to each attempt's bound (fault/resilient.py), so the bound catches a
    hang without cutting a measurement that is long by its options (a
    final batch measures 15 iterations of 0.4 s per schedule)."""
    if opts is None:
        return 0.0
    series = n_series if batch else max(1, opts.max_retries) * n_series
    return 2.0 * series * opts.n_iters * opts.target_secs


class EmpiricalBenchmarker:
    """Times a schedule on the executor's device (reference EmpiricalBenchmarker).

    ``runner`` is the stream executor (runtime/executor.py): ``prepare_n(order)``
    returns ``run_n(n)``, which runs the schedule n times and returns once the
    device has finished.  ``runner.device`` says where it runs.
    ``control_plane`` defaults to ``default_control_plane()``."""

    def __init__(self, runner, control_plane: Optional[ControlPlane] = None):
        self.runner = runner
        self.cp = (control_plane if control_plane is not None
                   else default_control_plane())
        self._overhead: Optional[float] = None

    def _fetch_overhead(self) -> float:
        """The fence's overhead on the runner's device
        (:func:`fence_overhead_s`), measured once.  Subtracted from every
        measurement, each of which ends in one fence."""
        if self._overhead is None:
            self._overhead = fence_overhead_s(self.runner.device)
        return self._overhead

    # reference measure(), benchmarker.cpp:83-119
    def _measure(
        self,
        run_n: Callable[[int], None],
        n_samples: int,
        opts: BenchOpts,
    ) -> Tuple[float, int]:
        """One measurement: >= target_secs of device work past the fence
        overhead; returns (secs-per-sample, possibly-grown n_samples)."""
        overhead = self._fetch_overhead()
        while True:
            self.cp.barrier()
            t0 = time.perf_counter()
            run_n(n_samples)
            wall = time.perf_counter() - t0
            elapsed = self.cp.allreduce_max(wall - overhead)
            # the growth below must agree across ranks too
            wall = self.cp.allreduce_max(wall)
            if elapsed >= opts.target_secs:
                return elapsed / n_samples, n_samples
            # growth ratio from the raw wall time: overhead subtraction can
            # push elapsed to <= 0 at small n
            grow = max(
                n_samples * 2,
                int(n_samples * 1.5 * opts.target_secs / max(wall, 1e-9)),
            )
            if n_samples >= 1_000_000:
                # the cap is reached and elapsed still misses the floor:
                # return the raw wall time per sample, an honest
                # fence-dominated upper bound
                return wall / n_samples, n_samples
            n_samples = min(grow, 1_000_000)

    # reference benchmark(), benchmarker.cpp:121-167
    def benchmark(self, order: Sequence, opts: Optional[BenchOpts] = None) -> BenchResult:
        opts = opts if opts is not None else BenchOpts()
        tr = get_tracer()
        sid = schedule_id(order) if tr.enabled else None
        with tr.span("bench.benchmark", schedule=sid, n_iters=opts.n_iters,
                     target_secs=opts.target_secs) as sp:
            run_n = self.runner.prepare_n(order)
            with tr.span("bench.warm", schedule=sid):
                run_n(1)  # warmup: first launches and scratch allocation excluded
            n_samples = 1
            for attempt in range(opts.max_retries):
                times: List[float] = []
                for _ in range(opts.n_iters):
                    t, n_samples = self._measure(run_n, n_samples, opts)
                    times.append(t)
                if is_random(times) or attempt == opts.max_retries - 1:
                    res = BenchResult.from_times(times)
                    res.fetch_overhead = self._overhead
                    sp.set("pct50", res.pct50)
                    sp.set("n_samples", n_samples)
                    sp.set("fetch_overhead", self._overhead)
                    sp.set("attempts", attempt + 1)
                    reg = get_metrics()
                    reg.counter("bench.benchmarks").inc()
                    reg.counter("bench.measurements").inc(len(times))
                    if attempt:
                        reg.counter("bench.runs_test_retries").inc(attempt)
                    return res
        raise AssertionError("unreachable")  # pragma: no cover

    # reference batch benchmark(), benchmarker.cpp:21-76
    def benchmark_batch_times(
        self,
        orders: List[Sequence],
        opts: Optional[BenchOpts] = None,
        seed: int = 0,
        group_seeds: Optional[List[Tuple[int, int]]] = None,
    ) -> List[List[float]]:
        """Raw per-iteration times, aligned by iteration index: ``times[i][k]``
        is schedule i's secs-per-sample in iteration k, and iteration k visits
        every schedule once (shuffled by a seeded RNG) — so
        ``times[a][k] / times[b][k]`` is a *paired* comparison in which
        common-mode drift cancels (utils.numeric.paired_speedup).

        ``group_seeds`` (``[(n_orders, seed), ...]``, the reference's) cuts
        ``orders`` into consecutive non-empty groups, each shuffled within
        its own span by its own persistent ``Random(seed)``: a group's visit
        order is the one a solo call on ``(group_orders, seed)`` makes,
        whatever shares the round.  The search fleet's owner fuses
        candidates of several workers into one round this way
        (search/fleet.py).  ``None`` is one group ``(len(orders), seed)``."""
        opts = opts if opts is not None else BenchOpts()
        groups = (list(group_seeds) if group_seeds is not None
                  else [(len(orders), seed)])
        if (any(n <= 0 for n, _ in groups)
                or sum(n for n, _ in groups) != len(orders)):
            raise ValueError(
                "group_seeds must partition orders into non-empty runs: "
                f"{groups} vs {len(orders)} orders")
        rngs = [_random.Random(s) for _, s in groups]
        spans: List[range] = []
        at = 0
        for n, _ in groups:
            spans.append(range(at, at + n))
            at += n
        tr = get_tracer()
        with tr.span("bench.batch", n_orders=len(orders),
                     n_iters=opts.n_iters, seed=seed,
                     n_groups=len(groups)) as sp:
            runners = [self.runner.prepare_n(o) for o in orders]
            with tr.span("bench.batch_warm", n_orders=len(orders)):
                for r in runners:
                    r(1)  # warm every schedule before timing any
            n_samples = [1] * len(orders)
            times: List[List[float]] = [[] for _ in orders]
            for _ in range(opts.n_iters):
                for span, rng in zip(spans, rngs):
                    perm = list(span)
                    rng.shuffle(perm)
                    for i in perm:
                        t, n_samples[i] = self._measure(runners[i],
                                                        n_samples[i], opts)
                        times[i].append(t)
            sp.set("fetch_overhead", self._overhead)
            get_metrics().counter("bench.measurements").inc(
                opts.n_iters * len(orders))
        return times

    def benchmark_batch(
        self,
        orders: List[Sequence],
        opts: Optional[BenchOpts] = None,
        seed: int = 0,
    ) -> List[BenchResult]:
        """One :class:`BenchResult` per schedule of the decorrelated batch
        (:meth:`benchmark_batch_times`)."""
        return [
            BenchResult.from_times(ts)
            for ts in self.benchmark_batch_times(orders, opts, seed)
        ]


class RepeatCallableRunner:
    """A runner over named ``run_n(n)`` callables, for measuring something
    that is not a schedule (one library call, a kernel alone) with the
    schedules' protocol: the "order" is the callable's name.  Each
    ``run_n(n)`` runs n samples back to back; :meth:`prepare_n` ends it in
    the device sync the executor's ``run_n`` ends in (runtime/graphs.py
    ``device_sync`` on the card), so the benchmarker's wall-minus-fence
    measurement covers the device work.  The callable must keep the n
    samples live (each one's result feeding the next, or written where the
    next one reads)."""

    def __init__(self, run_ns: Dict[str, Callable[[int], None]],
                 device="cuda"):
        import torch

        self.run_ns = dict(run_ns)
        self.device = torch.device(device)

    def prepare_n(self, name: str) -> Callable[[int], None]:
        from tenzing_tpu_torch.runtime.graphs import device_sync

        fn = self.run_ns[name]
        device = self.device

        def run_n(n: int) -> None:
            fn(n)
            if device.type == "cuda":
                device_sync(device)

        return run_n

    def prepare(self, name: str) -> Callable[[], None]:
        run_n = self.prepare_n(name)
        return lambda: run_n(1)


class CachingBenchmarker:
    """Equivalence-keyed cache in front of any benchmarker: a schedule equal to
    an already-benchmarked one up to lane/event renaming reuses the recorded
    result (the CsvBenchmarker lookup, benchmarker.cpp:169-223, applied online).

    Lookup is an O(1) dict hit on (opts, ``canonical_key``), and a result
    recorded under one BenchOpts is never returned for another."""

    def __init__(self, inner):
        self.inner = inner
        self._cache: dict = {}
        self.hits = 0
        self.misses = 0
        # a cache in front of a rank-coherent benchmarker (fault/resilient.py)
        # is rank-coherent too: its hits agree rank to rank
        self.rank_coherent = getattr(inner, "rank_coherent", False)

    @staticmethod
    def _key(order: Sequence, opts: Optional[BenchOpts]) -> Tuple:
        ok = (opts.n_iters, opts.max_retries, opts.target_secs) if opts else None
        return (ok, canonical_key(order))

    @property
    def hit_rate(self) -> float:
        """Fraction of queries answered from the cache (0.0 when unqueried)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def benchmark(self, order: Sequence, opts: Optional[BenchOpts] = None) -> BenchResult:
        key = self._key(order, opts)
        hit = key in self._cache
        if hit:
            self.hits += 1
            res = self._cache[key]
        else:
            res = self.inner.benchmark(order, opts)
            self._cache[key] = res
            self.misses += 1
        reg = get_metrics()
        reg.counter("bench.cache.hits" if hit else "bench.cache.misses").inc()
        reg.gauge("bench.cache.hit_rate").set(self.hit_rate)
        tr = get_tracer()
        if tr.enabled:
            tr.event("bench.cache", hit=hit, schedule=schedule_id(order),
                     pct50=res.pct50)
        return res


# -- the search database (reference CsvBenchmarker, benchmarker.cpp:169-223) --

CSV_DELIM = "|"


def split_fidelity(cells: List[str]) -> Tuple[str, int]:
    """(fidelity, index of the first op cell) of a split CSV row: the one
    rule for the optional ``fid=<tag>`` cell between the stats and the ops
    (rows without one are "full")."""
    if len(cells) > 7 and cells[7].startswith("fid="):
        return cells[7][4:], 8
    return "full", 7


def result_row(idx: int, res, order, fidelity: Optional[str] = None) -> str:
    """One CSV row: ``idx|pct01|pct10|pct50|pct90|pct99|stddev|op-json|...``
    (the reference's mcts.cpp:13-31 / dfs.cpp:84-105 dump format).
    ``fidelity`` (e.g. "screen") inserts a ``fid=<tag>`` cell before the ops;
    a tag containing the delimiter is rejected."""
    if fidelity is not None and CSV_DELIM in fidelity:
        raise ValueError(f"fidelity tag {fidelity!r} contains the CSV delimiter")
    cells = [
        str(idx),
        # float() first: a numpy scalar's repr would not parse back
        repr(float(res.pct01)),
        repr(float(res.pct10)),
        repr(float(res.pct50)),
        repr(float(res.pct90)),
        repr(float(res.pct99)),
        repr(float(res.stddev)),
    ] + ([f"fid={fidelity}"] if fidelity is not None else []) + [
        # '|' can only occur inside JSON strings; the \\u007c escape keeps the
        # cell valid JSON while making the row safely splittable
        json.dumps(op.to_json()).replace(CSV_DELIM, "\\u007c")
        for op in order
    ]
    return CSV_DELIM.join(cells)


class CsvBenchmarker:
    """Answers benchmark queries from a recorded database by matching the
    query against the stored schedules under equivalence (reference
    benchmarker.cpp:169-223; ``tenzing_tpu/bench/benchmarker.py``
    ``CsvBenchmarker``).

    ``strict=False`` skips rows that are malformed or whose ops do not
    resolve against ``graph`` (recorded against another structural variant);
    their indices are kept in ``skipped``.  ``normalize=True`` matches
    modulo ``remove_redundant_syncs`` on both sides, so a database of raw
    DFS terminals answers the cleaned rollouts of MCTS.  ``entries`` holds
    every parsed row, ``fidelities`` their tags in parallel; only "full"
    rows answer queries, and for schedules recorded twice the first full
    row wins (the driver's dump puts the final batch's numbers first)."""

    def __init__(self, rows: List[str], graph, strict: bool = True,
                 normalize: bool = False):
        from tenzing_tpu_torch.core.schedule import remove_redundant_syncs
        from tenzing_tpu_torch.core.serdes import op_from_json

        self._normalize = remove_redundant_syncs if normalize else (lambda s: s)
        self.entries: List[Tuple[Sequence, BenchResult]] = []
        self.fidelities: List[str] = []
        self._by_canonical: dict = {}
        self.skipped: List[int] = []
        for i, row in enumerate(rows):
            if not row.strip():
                continue
            cells = row.split(CSV_DELIM)
            try:
                res = BenchResult(
                    pct01=float(cells[1]),
                    pct10=float(cells[2]),
                    pct50=float(cells[3]),
                    pct90=float(cells[4]),
                    pct99=float(cells[5]),
                    stddev=float(cells[6]),
                )
                fid, ops_at = split_fidelity(cells)
                ops = [op_from_json(json.loads(c), graph) for c in cells[ops_at:]]
            except (KeyError, TypeError, ValueError, IndexError):
                if strict:
                    raise
                self.skipped.append(i)
                continue
            seq = Sequence(ops)
            self.entries.append((seq, res))
            self.fidelities.append(fid)
            if fid == "full":
                self._by_canonical.setdefault(
                    canonical_key(self._normalize(seq)), res)

    @classmethod
    def from_file(cls, path: str, graph, strict: bool = True,
                  normalize: bool = False) -> "CsvBenchmarker":
        with open(path) as f:
            return cls(f.read().splitlines(), graph, strict=strict,
                       normalize=normalize)

    def benchmark(self, order: Sequence, opts: Optional[BenchOpts] = None) -> BenchResult:
        res = self._by_canonical.get(canonical_key(self._normalize(order)))
        if res is None:
            raise KeyError(f"no recorded schedule equivalent to: {order.desc()}")
        return res
