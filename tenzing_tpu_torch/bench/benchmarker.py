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
* ``CachingBenchmarker`` — equivalence-keyed result cache.

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
"""

from __future__ import annotations

import random as _random
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from tenzing_tpu_torch.bench.randomness import is_random
from tenzing_tpu_torch.core.sequence import Sequence, canonical_key
from tenzing_tpu_torch.parallel.control_plane import ControlPlane, default_control_plane
from tenzing_tpu_torch.utils.numeric import percentile, stddev


@dataclass
class BenchResult:
    """Percentile statistics of per-iteration wall time in seconds
    (reference Benchmark::Result, benchmarker.hpp:14-22)."""

    pct01: float = 0.0
    pct10: float = 0.0
    pct50: float = 0.0
    pct90: float = 0.0
    pct99: float = 0.0
    stddev: float = 0.0

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
        )


@dataclass
class BenchOpts:
    """reference Benchmark::Opts (benchmarker.hpp:24-30)."""

    n_iters: int = 1000
    max_retries: int = 10
    target_secs: float = 0.01  # adaptive floor per measurement (benchmarker.cpp:85)


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
        """Median wall time of the fence alone: one trivial launch followed by
        ``torch.cuda.synchronize()`` on the card (a trivial op on the CPU).
        Subtracted from every measurement, each of which ends in one fence."""
        if self._overhead is None:
            import torch

            device = torch.device(self.runner.device)
            x = torch.zeros((), device=device)

            def fence() -> None:
                x.add_(1.0)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)

            fence()  # first launch excluded
            ts = []
            for _ in range(7):
                t0 = time.perf_counter()
                fence()
                ts.append(time.perf_counter() - t0)
            ts.sort()
            self._overhead = ts[len(ts) // 2]
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
        run_n = self.runner.prepare_n(order)
        run_n(1)  # warmup: first launches and scratch allocation excluded
        n_samples = 1
        for attempt in range(opts.max_retries):
            times: List[float] = []
            for _ in range(opts.n_iters):
                t, n_samples = self._measure(run_n, n_samples, opts)
                times.append(t)
            if is_random(times) or attempt == opts.max_retries - 1:
                return BenchResult.from_times(times)
        raise AssertionError("unreachable")  # pragma: no cover

    # reference batch benchmark(), benchmarker.cpp:21-76
    def benchmark_batch_times(
        self,
        orders: List[Sequence],
        opts: Optional[BenchOpts] = None,
        seed: int = 0,
    ) -> List[List[float]]:
        """Raw per-iteration times, aligned by iteration index: ``times[i][k]``
        is schedule i's secs-per-sample in iteration k, and iteration k visits
        every schedule once (shuffled by a seeded RNG) — so
        ``times[a][k] / times[b][k]`` is a *paired* comparison in which
        common-mode drift cancels (utils.numeric.paired_speedup)."""
        opts = opts if opts is not None else BenchOpts()
        rng = _random.Random(seed)
        runners = [self.runner.prepare_n(o) for o in orders]
        for r in runners:
            r(1)  # warm every schedule before timing any
        n_samples = [1] * len(orders)
        times: List[List[float]] = [[] for _ in orders]
        for _ in range(opts.n_iters):
            perm = list(range(len(orders)))
            rng.shuffle(perm)
            for i in perm:
                t, n_samples[i] = self._measure(runners[i], n_samples[i], opts)
                times[i].append(t)
        return times


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

    @staticmethod
    def _key(order: Sequence, opts: Optional[BenchOpts]) -> Tuple:
        ok = (opts.n_iters, opts.max_retries, opts.target_secs) if opts else None
        return (ok, canonical_key(order))

    def benchmark(self, order: Sequence, opts: Optional[BenchOpts] = None) -> BenchResult:
        key = self._key(order, opts)
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        res = self.inner.benchmark(order, opts)
        self._cache[key] = res
        self.misses += 1
        return res
