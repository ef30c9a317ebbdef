"""The execution platform: the virtual lanes a schedule may use, and the mesh
of ranks its collectives run over.

Counterpart of ``tenzing_tpu/core/platform.py`` (reference
``include/tenzing/platform.hpp``: ``Platform::make_n_streams``,
platform.hpp:211-215).  The solvers only read ``platform.lanes``; the stream
executor (runtime/executor.py) owns the CUDA streams and events the lanes and
events map to, so the reference's ``ResourceMap`` / ``EventPool`` token
slots have no counterpart here.

The mesh is the port's own: not a ``jax.sharding.Mesh`` but a map from axis
name to :class:`MeshAxis` (the axis size, this rank's index along it and the
``torch.distributed`` process group of the axis), built by
``parallel/mesh.py`` ``init_mesh``.  A schedule on a mesh runs once per rank,
each rank on its own shard of the buffers.  Ranks lie on the mesh in
row-major order over its axes, as ``Mesh(devs.reshape(shape), names)`` lays
out devices in the reference.  ``specs`` are the port's own too: for each
buffer, the mesh axis that splits its dim 0, or a tuple with one entry per
leading dim (an axis name or ``None``, as a ``PartitionSpec`` lists them),
or ``None`` for a replicated buffer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from tenzing_tpu_torch.core.resources import Lane


@dataclass(frozen=True)
class MeshAxis:
    """One axis of the mesh: its size, this rank's index along it, and the
    process group its collectives run over (``None`` only at size 1 without
    a process group, where no collective needs one)."""

    size: int
    index: int
    group: Any = None


class Mesh:
    """Axis name -> :class:`MeshAxis`, in axis order.  ``shared_card``: the
    ranks share one CUDA device and are joined over gloo
    (parallel/launch.py), where a collective cannot move device tensors."""

    def __init__(self, axes: Dict[str, MeshAxis], shared_card: bool = False):
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        for name, ax in axes.items():
            if ax.size < 1 or not 0 <= ax.index < ax.size:
                raise ValueError(f"mesh axis {name!r}: index {ax.index} of "
                                 f"size {ax.size}")
        self.axes = dict(axes)
        self.shared_card = shared_card

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(ax.size for ax in self.axes.values())

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's index along each axis."""
        return tuple(ax.index for ax in self.axes.values())

    def size(self, axis: str) -> int:
        return self._axis(axis).size

    def index(self, axis: str) -> int:
        return self._axis(axis).index

    def group(self, axis: str):
        return self._axis(axis).group

    def _axis(self, axis: str) -> MeshAxis:
        if axis not in self.axes:
            raise KeyError(f"no mesh axis {axis!r} (have {self.axis_names})")
        return self.axes[axis]


class Platform:
    """Immutable execution context: the virtual lanes, the mesh and the
    buffers' specs (reference Platform, platform.hpp:131-215)."""

    def __init__(self, lanes: List[Lane], mesh: Optional[Mesh] = None,
                 specs: Optional[Dict[str, Any]] = None):
        self.lanes = lanes
        self.mesh = mesh
        self.specs = dict(specs) if specs else {}

    @staticmethod
    def make_n_lanes(n: int, mesh: Optional[Mesh] = None,
                     specs: Optional[Dict[str, Any]] = None
                     ) -> "Platform":
        """reference Platform::make_n_streams (platform.hpp:211-215)."""
        return Platform([Lane(i) for i in range(n)], mesh=mesh, specs=specs)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.mesh.axis_names if self.mesh is not None else ()

    def spec(self, name: str) -> Any:
        """Buffer ``name``'s spec (module docstring; None: replicated)."""
        return self.specs.get(name)
