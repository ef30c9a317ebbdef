"""The native (C++) search core, bound through ctypes.

Counterpart of ``tenzing_tpu/native``: frontier and decision enumeration,
sync inference, equivalence-deduplicated DFS and random rollouts in C++17
(the repository's ``native/`` sources), built with ``g++`` into
``build/tenzing_tpu_torch/`` at first use.  The Python layer of
``tenzing_tpu_torch.core`` stays the semantic reference; the solvers call
the ``bridge.try_*`` helpers, which return ``None`` only for a graph the
core cannot represent (``NotLowerable``) or lanes that are not dense.

``TENZING_TPU_NATIVE=0`` turns the core off; ``1`` and ``auto`` (the
default) turn it on, and a build or load that fails raises.
"""

from tenzing_tpu_torch.native.bridge import (  # noqa: F401
    NativeError,
    NotLowerable,
    native_available,
    try_decisions,
    try_enumerate,
    try_rollout,
)
