"""The execution platform: the virtual lanes a schedule may use.

Counterpart of the lane half of ``tenzing_tpu/core/platform.py`` (reference
``include/tenzing/platform.hpp``: ``Platform::make_n_streams``,
platform.hpp:211-215).  The solvers only read ``platform.lanes``; the stream
executor (runtime/executor.py) owns the CUDA streams and events the lanes and
events map to.  The device mesh comes with the multi-device slice.
"""

from __future__ import annotations

from typing import List

from tenzing_tpu_torch.core.resources import Lane


class Platform:
    """Immutable execution context: the virtual lanes (reference Platform,
    platform.hpp:131-215)."""

    def __init__(self, lanes: List[Lane]):
        self.lanes = lanes

    @staticmethod
    def make_n_lanes(n: int) -> "Platform":
        """reference Platform::make_n_streams (platform.hpp:211-215)."""
        return Platform([Lane(i) for i in range(n)])
