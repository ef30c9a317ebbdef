"""Statistical noise rejection for benchmark series.

Parity target: reference ``src/randomness.cpp:12-63``: the NIST runs-test over the
measurement series (binarized around the median); a series with too few or too
many runs (|Z| > 1.96, 95% confidence) indicates drift or interference rather than
i.i.d. noise, and the whole measurement set is rejected and retried."""

from __future__ import annotations

import math
from typing import Sequence

from tenzing_tpu_torch.utils.numeric import med


def runs_test_z(xs: Sequence[float]) -> float:
    """Z statistic of the runs test around the median (reference randomness.cpp:12-58)."""
    m = med(xs)
    signs = [x > m for x in xs if x != m]
    n = len(signs)
    if n < 2:
        return 0.0
    n1 = sum(signs)
    n2 = n - n1
    if n1 == 0 or n2 == 0:
        return 0.0
    runs = 1 + sum(1 for a, b in zip(signs, signs[1:]) if a != b)
    expected = 2.0 * n1 * n2 / n + 1.0
    variance = (2.0 * n1 * n2 * (2.0 * n1 * n2 - n)) / (n * n * (n - 1.0))
    if variance <= 0.0:
        return 0.0
    return (runs - expected) / math.sqrt(variance)


def is_random(xs: Sequence[float], z_crit: float = 1.96) -> bool:
    """True iff the series passes the runs test at the given confidence
    (reference compound_test, randomness.cpp:60-63)."""
    return abs(runs_test_z(xs)) <= z_crit
