"""Phase-timing counters (reference counters.hpp:26-34 and the MCTS counters,
tenzing-mcts/include/tenzing/mcts/counters.hpp:16-27): accumulate wall time per
solver phase and report at the end of a search (mcts.hpp:311-320).

Counterpart of ``tenzing_tpu/utils/counters.py``: each ``Counters`` keeps a
private histogram per phase, and every ``phase()`` block

* observes its duration into that histogram (``seconds`` / ``counts`` /
  ``report()``),
* mirrors it into the process-global registry as
  ``<prefix>.<NAME>.seconds`` (obs/metrics.py), so ``--metrics-json``
  archives the solvers' phase timings, and
* opens a ``<prefix>.<NAME>`` span on the global tracer (obs/tracer.py),
  nested inside the iteration's span; a no-op while tracing is off.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

from tenzing_tpu_torch.obs.metrics import MetricsRegistry, get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer


class Counters:
    def __init__(self, prefix: str = "solver.phase",
                 mirror_global: bool = True) -> None:
        self._registry = MetricsRegistry()
        self._prefix = prefix
        self._mirror_global = mirror_global

    @contextmanager
    def phase(self, name: str, span: bool = True):
        """Time a block under phase ``name``.  ``span=False`` skips the
        tracer span (counters and metrics only), for per-node inner loops
        such as DFS enumeration, where a span per entry would flood the
        trace."""
        ctx = get_tracer().span(f"{self._prefix}.{name}") if span else None
        if ctx is not None:
            ctx.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if ctx is not None:
                ctx.__exit__(None, None, None)
            self._registry.histogram(name).observe(dt)
            if self._mirror_global:
                get_metrics().histogram(
                    f"{self._prefix}.{name}.seconds").observe(dt)

    @property
    def seconds(self) -> Dict[str, float]:
        """Accumulated wall seconds per phase."""
        return {name: h.total
                for name, h in self._registry.histograms().items()}

    @property
    def counts(self) -> Dict[str, int]:
        """Times each phase was entered."""
        return {name: h.count
                for name, h in self._registry.histograms().items()}

    def report(self) -> str:
        lines = ["phase counters:"]
        seconds, counts = self.seconds, self.counts
        for name in sorted(seconds, key=lambda n: -seconds[n]):
            lines.append(
                f"  {name:>16}: {seconds[name]:9.3f}s  x{counts[name]}"
            )
        return "\n".join(lines)
