"""3D halo exchange: the face geometry and the plain pack/unpack ops.

Counterpart of the single-device part of ``tenzing_tpu/models/halo.py``
(reference ``src/halo_exchange``: a ``nX x nY x nZ x nQ`` grid with ghost radius
``r``; per face direction Pack -> send -> wait -> Unpack,
``HaloExchange::add_to_graph``, ops_halo_exchange.cu:33-257).  The mesh
exchange and its synthesized plans come with the multi-device slice.

Buffers are torch tensors written in place: ``Pack`` copies the interior edge
of ``U`` into ``buf_<dir>``, ``Unpack`` copies ``recv_<dir>`` into the ghost
shell on the opposite side.  Both are single PyTorch indexing copies; the
staged pipeline (models/halo_pipeline.py) and the kernel menu
(ops/halo_kernels.py) build on them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from tenzing_tpu_torch.core.operation import DeviceOp

# the six face directions (reference loops dx,dy,dz with exactly_one,
# ops_halo_exchange.cu:29-31,57-144)
DIRECTIONS: List[Tuple[int, int, int]] = [
    (1, 0, 0),
    (-1, 0, 0),
    (0, 1, 0),
    (0, -1, 0),
    (0, 0, 1),
    (0, 0, -1),
]

_AXIS_NAMES = ("x", "y", "z")


def dir_name(d: Tuple[int, int, int]) -> str:
    """'px'/'mx'/'py'/... (the reference's dir_to_tag analog,
    ops_halo_exchange.cu:16-27)."""
    for i, v in enumerate(d):
        if v != 0:
            return ("p" if v > 0 else "m") + _AXIS_NAMES[i]
    raise ValueError(d)


@dataclass(frozen=True)
class HaloArgs:
    """Per-shard grid extents (reference HaloExchange::Args,
    ops_halo_exchange.hpp:33-55)."""

    nq: int = 3
    lx: int = 64
    ly: int = 64
    lz: int = 64
    radius: int = 3
    # grid element dtype, as a string so the dataclass stays hashable (the
    # sublane tile — and with it the kernel-menu gating — depends on itemsize)
    dtype: str = "float32"

    def local_shape(self) -> Tuple[int, int, int, int]:
        r = self.radius
        return (self.nq, self.lx + 2 * r, self.ly + 2 * r, self.lz + 2 * r)

    def itemsize(self) -> int:
        return np.dtype(self.dtype).itemsize


def sublane_tile(itemsize: int) -> int:
    """The reference's sublane tile for an element width (8 for 4-byte, 16 for
    2-byte, 32 for 1-byte).  The grid padding (halo_pipeline._padded_shape)
    and the kernel-menu gates (ops/halo_kernels.py) keep the reference's
    definition so a schedule means the same in both packages."""
    return {4: 8, 2: 16, 1: 32}.get(itemsize, 8)


def _face_slices(args: HaloArgs, d: Tuple[int, int, int], which: str):
    """Start indices + sizes of the face region along direction ``d``:
    ``which`` = 'pack' (interior edge) or 'unpack' (ghost shell)."""
    r = args.radius
    ext = [args.lx, args.ly, args.lz]
    starts = [0, r, r, r]
    sizes = [args.nq, ext[0], ext[1], ext[2]]
    for i, v in enumerate(d):
        if v == 0:
            continue
        sizes[1 + i] = r
        if which == "pack":
            # the interior edge facing the neighbor
            starts[1 + i] = ext[i] if v > 0 else r
        else:
            # the ghost shell on the OPPOSITE side (data arrives from -d)
            starts[1 + i] = 0 if v > 0 else ext[i] + r
    return starts, sizes


def face_view(u, starts, sizes):
    """The (strided) view of ``u`` covering the face cut at ``starts``."""
    return u[tuple(slice(s, s + n) for s, n in zip(starts, sizes))]


class Pack(DeviceOp):
    """Copy the interior edge for one direction into ``buf_<dir>`` (reference
    Pack, ops_halo_exchange.hpp:97-141)."""

    def __init__(self, args: HaloArgs, d: Tuple[int, int, int]):
        super().__init__(f"pack_{dir_name(d)}")
        self._args, self._d = args, d

    def reads(self):
        return ["U"]

    def writes(self):
        return [f"buf_{dir_name(self._d)}"]

    def apply(self, bufs, ctx):
        starts, sizes = _face_slices(self._args, self._d, "pack")
        bufs[f"buf_{dir_name(self._d)}"].copy_(face_view(bufs["U"], starts, sizes))


class Unpack(DeviceOp):
    """Write the received face into the ghost shell (reference Unpack,
    ops_halo_exchange.hpp:143-186)."""

    def __init__(self, args: HaloArgs, d: Tuple[int, int, int]):
        super().__init__(f"unpack_{dir_name(d)}")
        self._args, self._d = args, d

    def reads(self):
        return ["U", f"recv_{dir_name(self._d)}"]

    def writes(self):
        return ["U"]

    def apply(self, bufs, ctx):
        starts, sizes = _face_slices(self._args, self._d, "unpack")
        face_view(bufs["U"], starts, sizes).copy_(bufs[f"recv_{dir_name(self._d)}"])
