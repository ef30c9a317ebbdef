"""Single-device 3D halo-exchange pipeline: the default search workload.

Counterpart of ``tenzing_tpu/models/halo_pipeline.py`` (reference halo-exchange
benchmark graph, ``HaloExchange::add_to_graph``,
src/halo_exchange/ops_halo_exchange.cu:33-257, config nQ=3, 512^3 cells,
radius 3, halo_run_strategy.hpp:42-49).  Numerically this is the periodic
one-shard case: every ghost shell receives the shard's own opposite interior
face.

Per direction ``d`` the DAG is::

    pack_d (DeviceOp, lane-searched)      # interior face -> staging buf_d
      -> transfer                         # spill_d + fetch_d through pinned
                                          # host memory, or one device copy
      -> await_d (AwaitTransfer)          # the reference's Wait
      -> unpack_d (DeviceOp, lane-searched)  # staging recv_d -> ghost shell

The six chains are independent: the searched freedom is how the packs, posts,
waits and unpacks interleave across lanes, plus (with the menus on) which
pack/unpack kernel and which transfer engine each direction uses.

Every transfer moves the face in the dense ``(rows, 128)`` staging layout: the
face's elements in order, zero-padded to a multiple of 128.  The padding of
``U`` (``_padded_shape``) and the staging layout are the reference's, so the
port's buffers match it element by element and ``make_pipeline_buffers``
produces bit-identical data for the same seed.  (The reference's INDEX_TIE
ordering ties are an XLA workaround and have no counterpart here.)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import ChoiceOp, CompoundOp
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.models.halo import (
    DIRECTIONS,
    HaloArgs,
    Pack,
    Unpack,
    _face_slices,
    dir_name,
    face_view,
    sublane_tile,
)
from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer, HostFetchStart, HostSpillStart


def _flat_rows(sizes) -> int:
    """Rows of the (rows, 128) staging layout for a face of ``sizes``."""
    n = int(np.prod(sizes))
    return -(-n // 128)


def unflatten_face(flat, sizes):
    """The face-shaped view of a (rows, 128) staging buffer (no copy)."""
    n = int(np.prod(sizes))
    return flat.view(-1)[:n].view(tuple(sizes))


def flatten_face(face, sizes):
    """Face tensor -> a new (rows, 128) staging tensor, zero tail pad (the
    inverse of :func:`unflatten_face`)."""
    import torch

    flat = torch.zeros((_flat_rows(sizes), 128), dtype=face.dtype,
                       device=face.device)
    unflatten_face(flat, sizes).copy_(face)
    return flat


class PackFlat(Pack):
    """Pack into the staging buffer: one PyTorch indexing copy of the
    interior edge into the face-shaped view of ``buf_<dir>`` (the tail pad is
    never written and stays zero)."""

    def apply(self, bufs, ctx):
        starts, sizes = _face_slices(self._args, self._d, "pack")
        dst = unflatten_face(bufs[f"buf_{dir_name(self._d)}"], sizes)
        dst.copy_(face_view(bufs["U"], starts, sizes))


class UnpackRecv(Unpack):
    """Unpack reading the received staging buffer: one PyTorch indexing copy
    of its face-shaped view into the ghost shell."""

    def apply(self, bufs, ctx):
        starts, _ = _face_slices(self._args, self._d, "unpack")
        _, sizes = _face_slices(self._args, self._d, "pack")
        face = unflatten_face(bufs[f"recv_{dir_name(self._d)}"], sizes)
        face_view(bufs["U"], starts, sizes).copy_(face)


class HostRoundTrip(CompoundOp):
    """The host-staged transfer as one expandable vertex: post the
    device->host spill, then the host->device fetch, both on the direction's
    transfer channel — packaged so it can sit in a ChoiceOp next to the
    device-resident alternative."""

    def __init__(self, name: str, dname: str, buf: str, host: str, recv: str):
        super().__init__(name)
        self._dname = dname
        self._buf, self._host, self._recv = buf, host, recv

    def graph(self) -> Graph:
        g = Graph()
        spill = HostSpillStart(f"spill_{self._dname}", self._buf, self._host,
                               channel=self._dname)
        fetch = HostFetchStart(f"fetch_{self._dname}", self._host, self._recv,
                               channel=self._dname)
        g.start_then(spill)
        g.then(spill, fetch)
        g.then_finish(fetch)
        return g


class TransferChoice(ChoiceOp):
    """The transfer-engine menu for one direction: the host-staged round trip
    (PCIe + pinned host memory) vs a device-resident copy kernel.  Which
    engine, like which kernel, is the solver's question."""

    def __init__(self, d: Tuple[int, int, int]):
        name = dir_name(d)
        super().__init__(f"xfer_{name}")
        self._d = tuple(d)

    def choices(self) -> List:
        from tenzing_tpu_torch.ops.rdma import RdmaCopyStart

        name = dir_name(self._d)
        return [
            HostRoundTrip(
                f"xfer_{name}.host", name, f"buf_{name}", f"host_{name}",
                f"recv_{name}"
            ),
            RdmaCopyStart(f"xfer_{name}.rdma", f"buf_{name}", f"recv_{name}",
                          channel=name),
        ]


def direction_ops(args: HaloArgs, d: Tuple[int, int, int], impl_choice: bool = False,
                  xfer_choice: bool = False, engine: str = "host"):
    """The op chain for one face direction: (pack, transfer ops, await,
    unpack).  ``impl_choice`` turns pack/unpack into the kernel menu;
    ``xfer_choice`` turns the transfer into the engine menu; ``engine``
    ("host" | "rdma" | "mixed") wires one engine directly when no menu is
    wanted; "mixed" alternates engines across directions so both transfer
    paths run concurrently."""
    if engine not in ("host", "rdma", "mixed"):
        raise ValueError(f"unknown transfer engine {engine!r}")
    name = dir_name(d)
    if impl_choice:
        from tenzing_tpu_torch.ops.halo_kernels import PackChoice, UnpackChoice

        pack = PackChoice(args, d)
        unpack = UnpackChoice(args, d)
    else:
        pack = PackFlat(args, d)
        unpack = UnpackRecv(args, d)
    if engine == "mixed":
        engine = "rdma" if DIRECTIONS.index(tuple(d)) % 2 == 0 else "host"
    if xfer_choice:
        xfer: Tuple = (TransferChoice(d),)
    elif engine == "rdma":
        from tenzing_tpu_torch.ops.rdma import RdmaCopyStart

        xfer = (RdmaCopyStart(f"xfer_{name}.rdma", f"buf_{name}", f"recv_{name}",
                              channel=name),)
    else:
        xfer = (
            HostSpillStart(f"spill_{name}", f"buf_{name}", f"host_{name}",
                           channel=name),
            HostFetchStart(f"fetch_{name}", f"host_{name}", f"recv_{name}",
                           channel=name),
        )
    await_ = AwaitTransfer(f"await_{name}", f"recv_{name}")
    return (pack,) + xfer + (await_, unpack)


def add_to_graph(
    g: Graph,
    args: HaloArgs,
    preds: Optional[List] = None,
    succs: Optional[List] = None,
    impl_choice: bool = False,
    xfer_choice: bool = False,
    engine: str = "host",
) -> Graph:
    """Six independent pack -> transfer -> await -> unpack chains
    (reference HaloExchange::add_to_graph shape, ops_halo_exchange.cu:33-257)."""
    preds = preds if preds is not None else [g.start()]
    succs = succs if succs is not None else [g.finish()]
    for d in DIRECTIONS:
        ops = direction_ops(args, d, impl_choice, xfer_choice, engine)
        pack, unpack = ops[0], ops[-1]
        for p in preds:
            g.then(p, pack)
        for a, b in zip(ops, ops[1:]):
            g.then(a, b)
        for s in succs:
            g.then(unpack, s)
    return g


def build_graph(args: HaloArgs, impl_choice: bool = False,
                xfer_choice: bool = False, engine: str = "host") -> Graph:
    return add_to_graph(Graph(), args, impl_choice=impl_choice,
                        xfer_choice=xfer_choice, engine=engine)


# phase order of the pipeline's op-name prefixes (greedy incumbents and the
# rollout policy share it; covers both transfer engines)
HALO_PHASES = ("start", "pack", "spill", "fetch", "xfer", "await", "unpack",
               "finish")


def naive_priority():
    """Per-op priority of the naive order: direction by direction, each
    chain pack -> spill -> fetch -> await -> unpack completed before the
    next starts."""
    rank = {dir_name(d): i for i, d in enumerate(DIRECTIONS)}
    stages = ("pack", "spill", "fetch", "await", "unpack")

    def priority(name: str) -> int:
        if name == "start":
            return 0
        if name == "finish":
            return 10 * len(DIRECTIONS) + 1
        stage, d = name.split("_", 1)
        return 1 + 10 * rank[d.split(".", 1)[0]] + stages.index(stage)

    return priority


def naive_order(args: HaloArgs, platform) -> Sequence:
    """The naive sequential baseline: one lane, each direction's chain completed
    (post immediately awaited) before the next starts — the fully-synchronous
    program the search must beat.

    Derived through the SDP machinery, so the sync ops the order needs are
    inserted: the host waits for each pack before posting its spill, and for
    the last unpack before finishing.  The reference writes this order out
    by hand without them (tenzing_tpu/models/halo_pipeline.py:270), which its
    own verifier rejects (race:raw on buf_px: the spill is not ordered after
    the pack) and which is harmless only under XLA's SSA buffers; on CUDA the
    spill would read the staging buffer while the pack may still write it."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    one_lane = Platform([platform.lanes[0]])
    seq, _ = drive(build_graph(args), one_lane,
                   phase_policy(one_lane, HALO_PHASES, priority=naive_priority()))
    return seq


def greedy_overlap_order(args: HaloArgs, platform, engine: str = "host") -> Sequence:
    """The post-all-before-await-any heuristic schedule, derived through the
    SDP machinery so the required sync ops are inserted exactly as the solver
    would: packs round-robin across lanes, every transfer posted before any
    await, unpacks last (solve/greedy.py)."""
    from tenzing_tpu_torch.solve.greedy import greedy_phase_order

    return greedy_phase_order(build_graph(args, engine=engine), platform,
                              HALO_PHASES)


def paired_priority(engine: str = "mixed"):
    """Per-op priority for the PAIRED overlap discipline: all packs, all
    posts, then per-direction ``await_d -> unpack_d`` pairs — each face is
    unpacked as soon as ITS transfer lands.  Directions are visited
    fastest-engine-first: with ``engine='mixed'`` the device-copy directions
    (even DIRECTIONS indices) come first."""
    order = sorted(range(len(DIRECTIONS)),
                   key=lambda i: (i % 2 if engine == "mixed" else 0, i))
    rank = {dir_name(DIRECTIONS[i]): r for r, i in enumerate(order)}

    def priority(name: str) -> int:
        if name.startswith(("start",)):
            return 0
        if name.startswith("pack"):
            return 1
        if name.startswith(("spill", "fetch", "xfer")):
            return 2
        if name.startswith(("await", "unpack")):
            d = name.split("_", 1)[1].split(".", 1)[0]
            return 10 + 2 * rank[d] + (0 if name.startswith("await") else 1)
        return 99  # finish

    return priority


def paired_overlap_order(args: HaloArgs, platform, engine: str = "mixed") -> Sequence:
    """The paired await/unpack incumbent schedule (see :func:`paired_priority`),
    derived through the SDP machinery like the greedy incumbents."""
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    seq, _ = drive(
        build_graph(args, engine=engine), platform,
        phase_policy(platform, HALO_PHASES, priority=paired_priority(engine)),
    )
    return seq


def _padded_shape(shape: Tuple[int, int, int, int],
                  itemsize: int = 4) -> Tuple[int, int, int, int]:
    """U allocated with trailing dims padded as the reference pads them
    (sublane tile x 128): the padding lies outside every face cut, and keeping
    it makes the port's U element-for-element the reference's."""
    nq, x, y, z = shape
    st = sublane_tile(itemsize)
    return (nq, x, -(-y // st) * st, -(-z // 128) * 128)


def make_pipeline_buffers(
    args: HaloArgs, seed: int = 0, with_expected: bool = True
) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray]]:
    """(numpy buffers, expected U): ghost shells filled with the shard's own
    opposite interior faces (periodic 1-shard domain).  The same numpy
    generator calls as the reference, so ``U`` is bit-identical to its for the
    same seed.  ``with_expected=False`` skips the expected-U copy (a ~2 GB
    allocation at the reference bench config).  ``runtime.executor.
    buffers_from_numpy`` places the result on a device."""
    r = args.radius
    dtype = np.dtype(args.dtype)
    rng = np.random.default_rng(seed)
    U = np.zeros(_padded_shape(args.local_shape(), dtype.itemsize),
                 dtype=dtype)
    U[:, r : r + args.lx, r : r + args.ly, r : r + args.lz] = rng.random(
        (args.nq, args.lx, args.ly, args.lz), dtype=np.float32
    ).astype(dtype, copy=False)
    want = None
    if with_expected:
        want = U.copy()
        for d in DIRECTIONS:
            ps, sz = _face_slices(args, d, "pack")
            us, _ = _face_slices(args, d, "unpack")
            face = U[
                :, ps[1] : ps[1] + sz[1], ps[2] : ps[2] + sz[2], ps[3] : ps[3] + sz[3]
            ]
            want[
                :, us[1] : us[1] + sz[1], us[2] : us[2] + sz[2], us[3] : us[3] + sz[3]
            ] = face
    bufs: Dict[str, np.ndarray] = {"U": U}
    for d in DIRECTIONS:
        name = dir_name(d)
        _, sz = _face_slices(args, d, "pack")
        flat = np.zeros((_flat_rows(sz), 128), dtype=dtype)
        bufs[f"buf_{name}"] = flat
        bufs[f"host_{name}"] = flat.copy()  # pinned host memory on the card
        bufs[f"recv_{name}"] = flat.copy()
    return bufs, want


def host_buffer_names() -> List[str]:
    """Buffers that live in pinned host memory (``buffers_from_numpy``)."""
    return [f"host_{dir_name(d)}" for d in DIRECTIONS]
