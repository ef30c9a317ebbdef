"""MCTS selection strategies, pluggable into the solver.

Parity target: the reference strategy menu (one header each under
``tenzing-mcts/include/tenzing/mcts/``): Random, Unvisited, FastMin, AvgTime,
Coverage, AntiCorrelation, NormAntiCorr, NormRootCorr, BalanceHistogram.
Contract (mcts_strategy.hpp:13-27): a strategy provides ``Context`` (search-wide
state; the driver sets ``ctx.root``), per-node ``State`` (observations), a
``select(ctx, node) -> float`` exploitation term, and
``backprop(ctx, node, result)``.

Observations are the benchmarked pct10 time of each rollout through the node
(the statistic the reference strategies record, mcts_strategy_fast_min.hpp:63-64).
"""

from __future__ import annotations

import math
import random
from typing import List

from tenzing_tpu_torch.utils.numeric import avg, corr


class _Times:
    __slots__ = ("times",)

    def __init__(self) -> None:
        self.times: List[float] = []


def _histogram(times: List[float], lo: float, hi: float, bins: int = 10) -> List[float]:
    h = [0.0] * bins
    if hi <= lo:
        hi = lo + 1e-12
    for t in times:
        i = min(bins - 1, max(0, int((t - lo) / (hi - lo) * bins)))
        h[i] += 1.0
    return h


class StrategyBase:
    """Shared plumbing: times recorded on every node along the backprop path."""

    class Context:
        def __init__(self, seed: int = 0):
            self.root = None  # set by the driver
            self.rng = random.Random(seed)

    State = _Times

    @staticmethod
    def backprop(ctx, node, result) -> None:
        node.strat_state.times.append(result.pct10)

    @staticmethod
    def select(ctx, node) -> float:
        return 0.0

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _root_range(ctx):
        rt = ctx.root.strat_state.times
        if not rt:
            return 0.0, 1.0
        return min(rt), max(rt)


class Random(StrategyBase):
    """Uniformly random child preference (reference mcts_strategy_random.hpp:17-55)."""

    @staticmethod
    def select(ctx, node) -> float:
        return ctx.rng.random()


class Unvisited(StrategyBase):
    """Infinite preference for never-timed children
    (reference mcts_strategy_unvisited.hpp:14-38)."""

    @staticmethod
    def select(ctx, node) -> float:
        return math.inf if not node.strat_state.times else 0.0


class FastMin(StrategyBase):
    """1 - normalized distance of the child's best time from the root's best
    (reference mcts_strategy_fast_min.hpp:17-66)."""

    @staticmethod
    def select(ctx, node) -> float:
        ts = node.strat_state.times
        if not ts:
            return 0.0
        lo, hi = StrategyBase._root_range(ctx)
        if hi <= lo:
            return 1.0
        return 1.0 - (min(ts) - lo) / (hi - lo)


class AvgTime(StrategyBase):
    """Mean of the child's times normalized to the root's range
    (reference mcts_strategy_avg_time.hpp:18-60)."""

    @staticmethod
    def select(ctx, node) -> float:
        ts = node.strat_state.times
        if not ts:
            return 0.0
        lo, hi = StrategyBase._root_range(ctx)
        if hi <= lo:
            return 1.0
        return 1.0 - (avg(ts) - lo) / (hi - lo)


class Coverage(StrategyBase):
    """The child's time-range coverage of its parent's range
    (reference mcts_strategy_coverage.hpp:16-102)."""

    @staticmethod
    def select(ctx, node) -> float:
        ts = node.strat_state.times
        parent = node.parent
        if not ts or parent is None or not parent.strat_state.times:
            return 0.0
        plo, phi = min(parent.strat_state.times), max(parent.strat_state.times)
        if phi <= plo:
            return 0.0
        return (max(ts) - min(ts)) / (phi - plo)


class AntiCorrelation(StrategyBase):
    """Prefer children whose 10-bin time histogram anti-correlates with the
    parent's (reference mcts_strategy_anti_corr.hpp:15-90)."""

    @staticmethod
    def select(ctx, node) -> float:
        ts = node.strat_state.times
        parent = node.parent
        if not ts or parent is None or not parent.strat_state.times:
            return 0.0
        lo, hi = StrategyBase._root_range(ctx)
        ch = _histogram(ts, lo, hi)
        ph = _histogram(parent.strat_state.times, lo, hi)
        return (1.0 - corr(ch, ph)) / 2.0


class _SiblingNormalized(StrategyBase):
    """Shared shape of the sibling-normalized root-correlation strategies
    (reference mcts_strategy_norm_anti_corr.hpp / mcts_strategy_norm_root_corr.hpp)."""

    SIGN = 1.0

    @classmethod
    def _raw(cls, ctx, node) -> float:
        ts = node.strat_state.times
        if not ts or ctx.root is None or not ctx.root.strat_state.times:
            return 0.0
        lo, hi = StrategyBase._root_range(ctx)
        ch = _histogram(ts, lo, hi)
        rh = _histogram(ctx.root.strat_state.times, lo, hi)
        return (1.0 + cls.SIGN * -corr(ch, rh)) / 2.0

    @classmethod
    def select(cls, ctx, node) -> float:
        raw = cls._raw(ctx, node)
        parent = node.parent
        if parent is None:
            return raw
        mx = max((cls._raw(ctx, s) for s in parent.children), default=0.0)
        return raw / mx if mx > 0 else raw


class NormAntiCorr(_SiblingNormalized):
    """Sibling-normalized anti-correlation vs the root histogram
    (reference mcts_strategy_norm_anti_corr.hpp, 111 lines)."""

    SIGN = 1.0


class NormRootCorr(_SiblingNormalized):
    """Sibling-normalized positive correlation vs the root histogram
    (reference mcts_strategy_norm_root_corr.hpp, 111 lines)."""

    SIGN = -1.0


class BalanceHistogram(StrategyBase):
    """Prefer the child most likely to fill the parent's least-filled time bin
    (reference mcts_strategy_balance_hist.hpp, 204 lines)."""

    @staticmethod
    def select(ctx, node) -> float:
        ts = node.strat_state.times
        parent = node.parent
        if not ts or parent is None or not parent.strat_state.times:
            return 0.0
        lo, hi = StrategyBase._root_range(ctx)
        ph = _histogram(parent.strat_state.times, lo, hi)
        target = ph.index(min(ph))
        ch = _histogram(ts, lo, hi)
        return ch[target] / len(ts)


ALL_STRATEGIES = {
    "random": Random,
    "unvisited": Unvisited,
    "fast_min": FastMin,
    "avg_time": AvgTime,
    "coverage": Coverage,
    "anti_corr": AntiCorrelation,
    "norm_anti_corr": NormAntiCorr,
    "norm_root_corr": NormRootCorr,
    "balance_hist": BalanceHistogram,
}
