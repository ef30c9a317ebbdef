"""tenzing_tpu_torch: the PyTorch/CUDA port of the schedule-search framework.

The JAX package ``tenzing_tpu`` is the reference; this package keeps its
module layout, op names and schedule JSON, and runs schedules on CUDA streams
with hand-written kernels (``csrc/``).  It imports neither JAX nor the
reference package.
"""

__version__ = "0.1.0"
