"""3D halo exchange over a mesh of ranks: the spatial-decomposition workload.

Counterpart of ``tenzing_tpu/models/halo.py`` (reference ``src/halo_exchange``:
a ``nX x nY x nZ x nQ`` grid with ghost radius ``r``; per face direction
Pack -> send -> wait -> Unpack, ``HaloExchange::add_to_graph``,
ops_halo_exchange.cu:33-257).

The grid, with its ghost shells, is split over a 3D mesh ``("x", "y",
"z")`` of ranks (parallel/mesh.py; spec ``(None, "x", "y", "z")``), and each
rank runs the schedule on its own block.  Per direction the DAG is
Pack -> post (the exchange along the face's mesh axis, periodic) ->
AwaitTransfer -> Unpack.  The post is ``PermuteStart`` (``.xla``: a
point-to-point shift over ``torch.distributed``) or ``RdmaShiftStart``
(``.rdma``: the hand-written shift kernel, which writes into the
neighbour's receive buffer through CUDA IPC; ops/rdma.py); with
``xfer_choice`` each post is an :class:`ExchangeChoice` over both.  The six
directions are independent, so the search places the posts and the waits.

Buffers are torch tensors written in place: ``Pack`` copies the interior edge
of ``U`` into ``buf_<dir>``, ``Unpack`` copies ``recv_<dir>`` into the ghost
shell on the opposite side.  Both are single PyTorch indexing copies; the
staged pipeline (models/halo_pipeline.py) and the kernel menu
(ops/halo_kernels.py) build on them.  Not ported yet: ``synth=True``, the
synthesized chunk-routed shifts (ROADMAP Queue 1 item 5), which raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import ChoiceOp, CompoundOp, DeviceOp

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


def _dir_axis_sign(d: Tuple[int, int, int]) -> Tuple[str, int]:
    """(mesh axis name, ±1) of a face direction."""
    i = [j for j, v in enumerate(d) if v != 0][0]
    return _AXIS_NAMES[i], (1 if sum(d) > 0 else -1)


def exchange_post(d: Tuple[int, int, int], engine: str = "xla"):
    """The host-posted exchange op for one direction: ``engine='xla'`` is a
    ``PermuteStart``, ``'rdma'`` a ``RdmaShiftStart`` with one collective id
    per direction, so six concurrent exchanges never share flags.  Both post
    the transfer and return with it in flight (the reference's Isend,
    ops_mpi.hpp:17-146); :func:`add_to_graph` wires the separate await."""
    from tenzing_tpu_torch.ops.comm_ops import PermuteStart
    from tenzing_tpu_torch.ops.rdma import RdmaShiftStart

    name = dir_name(d)
    axis, sign = _dir_axis_sign(d)
    if engine == "xla":
        return PermuteStart(f"exchange_{name}.xla", f"buf_{name}",
                            f"recv_{name}", axis=axis, shift=sign)
    if engine == "rdma":
        return RdmaShiftStart(f"exchange_{name}.rdma", f"buf_{name}",
                              f"recv_{name}", axis=axis, shift=sign,
                              collective_id=DIRECTIONS.index(tuple(d)))
    raise ValueError(f"unknown exchange engine {engine!r}")


def _unported_synth(what: str):
    return NotImplementedError(
        f"not yet ported: synthesized collectives ({what} synth=True; "
        "ROADMAP Queue 1 item 5)")


class ExchangeChoice(ChoiceOp):
    """``.xla`` (``PermuteStart``) vs ``.rdma`` (``RdmaShiftStart``) for one
    direction's exchange: the transfer-engine half of the searched menu.
    Either way the chosen op only posts; the graph's AwaitTransfer is the
    separate wait."""

    def __init__(self, d: Tuple[int, int, int], args: Optional[HaloArgs] = None,
                 synth: bool = False, synth_relax: bool = False):
        super().__init__(f"exchange_{dir_name(d)}")
        if synth or synth_relax:
            raise _unported_synth("ExchangeChoice")
        self._d = tuple(d)

    def choices(self):
        return [exchange_post(self._d, "xla"), exchange_post(self._d, "rdma")]


class HaloExchange(CompoundOp):
    """The whole 6-direction exchange as one compound op."""

    def __init__(self, args: HaloArgs, name: str = "halo_exchange"):
        super().__init__(name)
        self._args = args

    def graph(self) -> Graph:
        return add_to_graph(Graph(), self._args)

    def args(self) -> HaloArgs:
        return self._args


def add_to_graph(g: Graph, args: HaloArgs, preds: Optional[List] = None,
                 succs: Optional[List] = None, xfer_choice: bool = False,
                 synth: bool = False, synth_relax: bool = False) -> Graph:
    """The per-direction pack -> post -> await -> unpack chains (reference
    HaloExchange::add_to_graph, ops_halo_exchange.cu:33-257).  With
    ``xfer_choice`` each post is an :class:`ExchangeChoice`."""
    from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer

    if synth or synth_relax:
        raise _unported_synth("add_to_graph")
    preds = preds if preds is not None else [g.start()]
    succs = succs if succs is not None else [g.finish()]
    for d in DIRECTIONS:
        name = dir_name(d)
        exch = ExchangeChoice(d) if xfer_choice else exchange_post(d, "xla")
        await_ = AwaitTransfer(f"await_{name}", f"recv_{name}")
        pack, unpack = Pack(args, d), Unpack(args, d)
        for p in preds:
            g.then(p, pack)
        g.then(pack, exch)
        g.then(exch, await_)
        g.then(await_, unpack)
        for s in succs:
            g.then(unpack, s)
    return g


# the buffers' spec: the grid and the faces split along dims 1-3 over the
# mesh axes (the reference's P(None, "x", "y", "z"))
HALO_SPEC = (None, "x", "y", "z")


def _face_from(locs_of, args: HaloArgs, d, coords, mesh_shape) -> np.ndarray:
    """The face rank ``coords`` receives along ``d``: the interior edge of
    the rank it arrives from (periodic)."""
    src = tuple((c - v) % n for c, v, n in zip(coords, d, mesh_shape))
    ps, sz = _face_slices(args, d, "pack")
    return locs_of(src)[:, ps[1]:ps[1] + sz[1], ps[2]:ps[2] + sz[2],
                        ps[3]:ps[3] + sz[3]]


def _halo_global(mesh_shape, args: HaloArgs, seed: int) -> np.ndarray:
    mx, my, mz = mesh_shape
    rng = np.random.default_rng(seed)
    return rng.random((args.nq, mx * args.lx, my * args.ly, mz * args.lz),
                      dtype=np.float32)


def _local_grid(G: np.ndarray, args: HaloArgs, coords) -> np.ndarray:
    """Rank ``coords``' block with ghost shells, its interior filled."""
    r = args.radius
    i, j, k = coords
    loc = np.zeros(args.local_shape(), dtype=np.float32)
    loc[:, r:r + args.lx, r:r + args.ly, r:r + args.lz] = G[
        :, i * args.lx:(i + 1) * args.lx, j * args.ly:(j + 1) * args.ly,
        k * args.lz:(k + 1) * args.lz]
    return loc


def _filled(loc: np.ndarray, locs_of, args: HaloArgs, coords,
            mesh_shape) -> np.ndarray:
    """``loc`` with every ghost face filled from its periodic neighbour
    (edges and corners of the shells stay untouched)."""
    want = loc.copy()
    for d in DIRECTIONS:
        face = _face_from(locs_of, args, d, coords, mesh_shape)
        us, sz = _face_slices(args, d, "unpack")
        want[:, us[1]:us[1] + sz[1], us[2]:us[2] + sz[2],
             us[3]:us[3] + sz[3]] = face
    return want


def make_halo_buffers(mesh_shape: Tuple[int, int, int], args: HaloArgs,
                      seed: int = 0, synth: bool = False
                      ) -> Tuple[Dict[str, np.ndarray], Dict[str, tuple],
                                 np.ndarray]:
    """(global buffers, specs, expected U after one exchange): the
    reference's arrays for the same seed, bit for bit.  The global interior
    grid is periodic; the expected array has every rank's ghost faces filled
    from its periodic neighbours."""
    if synth:
        raise _unported_synth("make_halo_buffers")
    mx, my, mz = mesh_shape
    G = _halo_global(mesh_shape, args, seed)
    locs = np.zeros((mx, my, mz) + args.local_shape(), dtype=np.float32)
    for c in np.ndindex(mx, my, mz):
        locs[c] = _local_grid(G, args, c)
    want = np.zeros_like(locs)
    for c in np.ndindex(mx, my, mz):
        want[c] = _filled(locs[c], lambda q: locs[q], args, c, mesh_shape)

    def assemble(blocks):
        """(mx,my,mz, nq, X,Y,Z) -> global (nq, mx*X, my*Y, mz*Z) layout."""
        return np.concatenate([np.concatenate(
            [np.concatenate(list(blocks[i, j]), axis=3) for j in range(my)],
            axis=2) for i in range(mx)], axis=1)

    bufs = {"U": assemble(locs)}
    specs = {"U": HALO_SPEC}
    for d in DIRECTIONS:
        _, sz = _face_slices(args, d, "pack")
        buf = np.zeros((sz[0], mx * sz[1], my * sz[2], mz * sz[3]),
                       dtype=np.float32)
        bufs[f"buf_{dir_name(d)}"] = buf
        bufs[f"recv_{dir_name(d)}"] = buf.copy()
        specs[f"buf_{dir_name(d)}"] = HALO_SPEC
        specs[f"recv_{dir_name(d)}"] = HALO_SPEC
    return bufs, specs, assemble(want)


def make_local_halo_buffers(mesh_shape: Tuple[int, int, int], coords,
                            args: HaloArgs, seed: int = 0
                            ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """One rank's blocks of :func:`make_halo_buffers`' buffers and expected
    U, equal to them bit for bit, without assembling the global grids: at
    full width a rank's block is 1.67 GB, and the assembled globals would
    hold one such block per rank five times over."""
    G = _halo_global(mesh_shape, args, seed)
    loc = _local_grid(G, args, tuple(coords))

    def locs_of(q):
        return loc if tuple(q) == tuple(coords) else _local_grid(G, args, q)

    want = _filled(loc, locs_of, args, tuple(coords), mesh_shape)
    del G
    bufs = {"U": loc}
    for d in DIRECTIONS:
        _, sz = _face_slices(args, d, "pack")
        bufs[f"buf_{dir_name(d)}"] = np.zeros(sz, dtype=np.float32)
        bufs[f"recv_{dir_name(d)}"] = np.zeros(sz, dtype=np.float32)
    return bufs, want
