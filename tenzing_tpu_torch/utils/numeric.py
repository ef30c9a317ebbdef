"""Numeric helpers the search and the paired verdict need.

Counterpart of ``tenzing_tpu/utils/numeric.py`` (reference
include/tenzing/numeric.hpp): avg/med/var/stddev, Pearson correlation (MCTS
strategies), nearest-rank percentiles, the paired bootstrap speedup the
driver's verdict is computed with, the tanh gelu of the host-side
expected outputs, the prime factors of the halo's device grid, and bf16
rounding without a bf16 numpy type."""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def avg(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs)


def med(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def var(xs: Sequence[float]) -> float:
    m = avg(xs)
    return sum((x - m) ** 2 for x in xs) / len(xs)


def stddev(xs: Sequence[float]) -> float:
    return math.sqrt(var(xs))


def corr(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Pearson correlation coefficient (reference numeric.hpp:57-109); 0 when
    either side is constant."""
    if len(xs) != len(ys) or not xs:
        raise ValueError("corr needs two equal-length non-empty series")
    mx, my = avg(xs), avg(ys)
    sx, sy = stddev(xs), stddev(ys)
    if sx == 0.0 or sy == 0.0:
        return 0.0
    n = len(xs)
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / n
    return cov / (sx * sy)


def gelu_tanh(x):
    """tanh-approximate gelu on a numpy array — matches ``jax.nn.gelu``'s
    default and torch's ``gelu(approximate="tanh")``, so host-side model
    references agree with the device path (the MoE expected output)."""
    import numpy as np

    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


def percentile(sorted_xs: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile over a pre-sorted series (reference
    benchmarker.cpp:157-166 indexing convention)."""
    if not sorted_xs:
        raise ValueError("empty series")
    i = min(len(sorted_xs) - 1, max(0, int(round(pct / 100.0 * (len(sorted_xs) - 1)))))
    return sorted_xs[i]


def paired_speedup(
    base: Sequence[float], cand: Sequence[float], seed: int = 0, n_boot: int = 2000
) -> tuple:
    """(median speedup, ci_lo, ci_hi): per-iteration paired speedup base/cand
    with a seeded bootstrap 95% CI over the iteration-aligned ratio series.

    Input series must be iteration-aligned (``EmpiricalBenchmarker.
    benchmark_batch_times``: iteration k visits every schedule once, in a
    shuffled order) so each ratio compares measurements taken back-to-back
    under the same system conditions — slow drift common to both schedules
    cancels instead of inflating the verdict's variance.  Extends the
    reference's decorrelation idea (benchmarker.cpp:21-76) from "shuffle the
    visit order" to "compare within the iteration"."""
    import random as _random

    if len(base) != len(cand) or not base:
        raise ValueError("paired_speedup needs two equal-length non-empty series")
    ratios = [b / c for b, c in zip(base, cand)]
    rng = _random.Random(seed)
    n = len(ratios)
    meds = sorted(med([ratios[rng.randrange(n)] for _ in range(n)]) for _ in range(n_boot))
    return med(ratios), percentile(meds, 2.5), percentile(meds, 97.5)


def prime_factors(n: int) -> List[int]:
    """Ascending prime factorization (reference numeric.cpp:11-33; used for
    the halo's device-grid layout, halo_run_strategy.hpp:80-98)."""
    out: List[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def round_bf16(a) -> np.ndarray:
    """``a`` rounded to bfloat16 (to nearest, ties to even), held in a
    float32 array.  Rounds through float32 first, as ``ml_dtypes``' cast to
    bfloat16 does, so the values are the reference's bf16 arrays' bit for
    bit; ``torch.from_numpy(r).to(torch.bfloat16)`` then is exact."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32)
