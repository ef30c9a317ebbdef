"""Phase-timing counters (reference counters.hpp:26-34 and the MCTS counters,
tenzing-mcts/include/tenzing/mcts/counters.hpp:16-27): accumulate wall time per
solver phase and report at the end of a search (mcts.hpp:311-320).

Counterpart of ``tenzing_tpu/utils/counters.py`` without its telemetry mirror
(the port's observability layer comes with a later slice).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class Counters:
    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        """Time a block under phase ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0)
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["phase counters:"]
        for name in sorted(self.seconds, key=lambda n: -self.seconds[n]):
            lines.append(
                f"  {name:>16}: {self.seconds[name]:9.3f}s  x{self.counts[name]}"
            )
        return "\n".join(lines)
