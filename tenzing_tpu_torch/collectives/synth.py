"""Sketch synthesis: collectives as searchable point-to-point decompositions.

Counterpart of ``tenzing_tpu/collectives/synth.py``.  A sketch (ring,
reverse ring, recursive halving/doubling, chunked neighbour exchange,
staged host pipeline) instantiated per (collective, mesh axis, chunk count,
rotation) becomes a :class:`SynthCollectiveOp`: an ordinary ``CompoundOp``
whose sub-graph is chains of real transfer steps (``PermuteStart`` hops
between ranks, ``HostSpillStart`` / ``HostFetchStart`` through pinned host
memory, each with its ``AwaitTransfer``) and local combine steps
(``AddInto``, ``PlaceSlice``, ...).  The fixed chain and the surviving
instantiations are alternatives of one ``ChoiceOp``, so MCTS, DFS and the
hill-climb search them with no solver change, and the verifier certifies
them as it does any schedule.

The sketches:

* ``ring`` / ``ringr`` (all-reduce): each chunk's accumulator seeds from
  the local slice, then ``n-1`` hops each deliver a peer's slice to add;
* ``rhd`` (all-reduce, power-of-two axes): the accumulator itself shifts by
  ``1, 2, 4, ...`` and adds each arrival, ``log2(n)`` hops;
* ``ring`` (all-to-all): step ``s`` sends the row meant for the rank ``s``
  ahead in one hop and places what arrives at its sender's index;
* ``neighbor`` (the halo shift): the face splits into ``k`` chunk shifts
  whose awaits interleave;
* ``pipe`` (the host round trip): the payload goes device -> host ->
  device in ``k`` chunks, so chunk ``j``'s fetch overlaps chunk ``j+1``'s
  spill.

Each instantiation is priced by an alpha-beta walk over the
:mod:`~tenzing_tpu_torch.collectives.topology` links and pruned against the
fixed collective's one-post floor (``bench/roofline.prune_sketches``)
before it enters a menu.  Pure movement (``pipe``, ``neighbor``, the
all-to-all ring) is bit-identical to the fixed engine; the synthesized
all-reduces re-associate the sum and are held to the dryrun's tolerance.

In place, on the op's lane stream: a step op writes into its preallocated
buffer (``copy_``, ``add_``, ``torch.cat(..., out=)``) and never returns a
view, so no staging buffer aliases another.  ``RowPick`` / ``RowPlace``
read this rank's index and the axis size from the platform mesh
(``ctx.mesh``), where the reference reads ``lax.axis_index`` /
``lax.axis_size``.  The pipe's spill and fetch of one chunk post on one
transfer channel (the chunk's host piece), so the fetch never reads the
pinned piece before the spill has written it; the channel is not part of
the schedule JSON, which is the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence as Seq, Tuple

from tenzing_tpu_torch.collectives.topology import Topology
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import (
    ChoiceOp,
    CompoundOp,
    CpuOp,
    DeviceOp,
    OpBase,
    register_kind,
)
from tenzing_tpu_torch.ops.comm_ops import (
    ICI_KINDS,
    PCIE_KINDS,
    AwaitTransfer,
    HostFetchStart,
    HostSpillStart,
    PermuteStart,
)

# the directive marker: a SynthDirective is named
# f"{base}{SYNTH_MARK}{sketch}.c{k}".  learn/features.py keeps its own copy
# of this string and of the sketch tuple; tests/test_torch_collectives.py
# holds them equal.
SYNTH_MARK = ".synth."

#: The sketch vocabulary: nothing outside this tuple is instantiated.
SKETCHES = ("ring", "ringr", "rhd", "neighbor", "pipe")

#: What each sketch decomposes, for the provenance blocks.
COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "shift", "exchange")


@register_kind("synth")
class SynthDirective(CpuOp):
    """The executed synthesis directive: a host no-op named
    ``<base>.synth.<sketch>.c<K>`` that carries the chosen sketch and chunk
    count in the schedule (the twin of ``ChunkDirective`` and
    ``fuse_tile.tN``)."""

    def __init__(self, base: str, sketch: str, chunks: int):
        if sketch not in SKETCHES:
            raise ValueError(f"unknown sketch {sketch!r} (have {SKETCHES})")
        super().__init__(f"{base}{SYNTH_MARK}{sketch}.c{int(chunks)}")
        self._base = base
        self._sketch = sketch
        self._chunks = int(chunks)

    def base(self) -> str:
        return self._base

    def sketch(self) -> str:
        return self._sketch

    def chunks(self) -> int:
        return self._chunks

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "name": self.name(), "base": self._base,
                "sketch": self._sketch, "chunks": self._chunks}

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "SynthDirective":
        return cls(j["base"], j["sketch"], int(j["chunks"]))


# -- step ops: the local halves of a decomposition ---------------------------
#
# Row extents come from the runtime shape (each rank's block), so one graph
# runs on any dp split of the rows.


def _chunk_rows(name: str, rows: int, part: int, n: int) -> Tuple[int, int]:
    """(first row, rows) of chunk ``part`` of an ``n``-way split."""
    if rows % n:
        raise ValueError(f"{name}: {rows} runtime rows do not split {n} ways")
    sz = rows // n
    return part * sz, sz


class SlicePick(DeviceOp):
    """``dst = src[chunk j of k]`` along axis 0, copied into ``dst``: the
    chunk a hop sends.  ``k=1`` copies the whole buffer."""

    def __init__(self, name: str, src: str, dst: str, part: int, n_parts: int):
        super().__init__(name)
        self._src, self._dst = src, dst
        self._part, self._n = int(part), int(n_parts)

    def reads(self) -> List[str]:
        return [self._src]

    def writes(self) -> List[str]:
        return [self._dst]

    def apply(self, bufs, ctx):
        x = bufs[self._src]
        lo, sz = _chunk_rows(self.name(), x.shape[0], self._part, self._n)
        bufs[self._dst].copy_(x.narrow(0, lo, sz))


class PlaceSlice(DeviceOp):
    """``dst[chunk j of k] = piece`` along axis 0: the combine, each chain
    depositing its finished chunk (disjoint slices, any order)."""

    def __init__(self, name: str, piece: str, dst: str, part: int, n_parts: int):
        super().__init__(name)
        self._piece, self._dst = piece, dst
        self._part, self._n = int(part), int(n_parts)

    def reads(self) -> List[str]:
        return [self._piece, self._dst]

    def writes(self) -> List[str]:
        return [self._dst]

    def apply(self, bufs, ctx):
        dst = bufs[self._dst]
        lo, sz = _chunk_rows(self.name(), dst.shape[0], self._part, self._n)
        dst.narrow(0, lo, sz).copy_(bufs[self._piece])


class AddInto(DeviceOp):
    """``acc += piece``: the reduction step every all-reduce sketch folds
    its arriving hop into (re-associates the sum)."""

    def __init__(self, name: str, piece: str, acc: str):
        super().__init__(name)
        self._piece, self._acc = piece, acc

    def reads(self) -> List[str]:
        return [self._piece, self._acc]

    def writes(self) -> List[str]:
        return [self._acc]

    def apply(self, bufs, ctx):
        bufs[self._acc].add_(bufs[self._piece])


class ConcatPieces(DeviceOp):
    """``dst = concat(pieces, axis 0)``: the pipe sketch's reassembly of its
    staged chunks."""

    def __init__(self, name: str, pieces: Seq[str], dst: str):
        super().__init__(name)
        self._pieces = list(pieces)
        self._dst = dst

    def reads(self) -> List[str]:
        return list(self._pieces)

    def writes(self) -> List[str]:
        return [self._dst]

    def apply(self, bufs, ctx):
        import torch

        torch.cat([bufs[p] for p in self._pieces], 0, out=bufs[self._dst])


class StaticSlice(DeviceOp):
    """``dst = src[lo:lo+size]`` with bounds fixed at build time, copied into
    ``dst``: the pipe sketch's chunk, where an uneven split makes runtime
    division wrong."""

    def __init__(self, name: str, src: str, dst: str, lo: int, size: int):
        super().__init__(name)
        self._src, self._dst = src, dst
        self._lo, self._size = int(lo), int(size)

    def reads(self) -> List[str]:
        return [self._src]

    def writes(self) -> List[str]:
        return [self._dst]

    def apply(self, bufs, ctx):
        bufs[self._dst].copy_(bufs[self._src].narrow(0, self._lo, self._size))


def _peer_row(op: DeviceOp, ctx, axis: str, off: int) -> int:
    """``(this rank's index along axis + off) % axis size``, from the
    platform mesh."""
    mesh = getattr(ctx, "mesh", None)
    if mesh is None:
        raise RuntimeError(f"{op.name()}: a row of axis {axis!r} needs a "
                           "platform mesh")
    return (mesh.index(axis) + off) % mesh.size(axis)


class RowPick(DeviceOp):
    """``dst = src[(index + off) % n]`` (one peer row, kept 3-D): at ring
    step ``s`` every rank picks the row meant for the rank ``s`` ahead."""

    def __init__(self, name: str, src: str, dst: str, off: int, axis: str):
        super().__init__(name)
        self._src, self._dst = src, dst
        self._off, self._axis = int(off), axis

    def reads(self) -> List[str]:
        return [self._src]

    def writes(self) -> List[str]:
        return [self._dst]

    def apply(self, bufs, ctx):
        i = _peer_row(self, ctx, self._axis, self._off)
        bufs[self._dst].copy_(bufs[self._src].narrow(0, i, 1))


class RowPlace(DeviceOp):
    """``dst[(index + off) % n] = piece``: the ring all-to-all's receive,
    the row that came from ``-off`` hops back placed at its sender's index
    (disjoint rows across steps, any order)."""

    def __init__(self, name: str, piece: str, dst: str, off: int, axis: str):
        super().__init__(name)
        self._piece, self._dst = piece, dst
        self._off, self._axis = int(off), axis

    def reads(self) -> List[str]:
        return [self._piece, self._dst]

    def writes(self) -> List[str]:
        return [self._dst]

    def apply(self, bufs, ctx):
        i = _peer_row(self, ctx, self._axis, self._off)
        bufs[self._dst].narrow(0, i, 1).copy_(bufs[self._piece])


# -- plans: one instantiation = step chains + staging decls + a census -------
#
# A plan is the one source of both the graph's chains and the model's buffer
# builder's staging buffers, so names and shapes cannot drift apart.


@dataclass(frozen=True)
class BufDecl:
    """One staging buffer of a plan: this rank's shape; ``space="host"``
    is placed in pinned host memory by the model's buffer builder."""

    name: str
    shape: Tuple[int, ...]
    space: str = "device"


@dataclass
class SynthPlan:
    """One (collective, sketch, chunk count, rotation) instantiation."""

    base: str
    collective: str
    sketch: str
    chunks: int
    chains: List[List[OpBase]] = field(default_factory=list)
    combines: List[OpBase] = field(default_factory=list)
    buffers: List[BufDecl] = field(default_factory=list)
    engine: str = "ici"
    n_xfers: int = 0  # separately posted transfers
    xfer_bytes: float = 0.0  # total bytes across them

    def label(self) -> str:
        return f"{self.sketch}.c{self.chunks}"


def _chunk_ranges(length: int, k: int) -> List[Tuple[int, int]]:
    """``k`` contiguous [lo, hi) ranges covering ``length``, the remainder
    spread over the first chunks."""
    q, r = divmod(int(length), int(k))
    out, lo = [], 0
    for j in range(k):
        sz = q + (1 if j < r else 0)
        out.append((lo, lo + sz))
        lo += sz
    return out


def _nbytes(shape: Seq[int], itemsize: int) -> float:
    out = float(itemsize)
    for s in shape:
        out *= s
    return out


def plan_ring_all_reduce(base: str, src: str, dst: str, axis: str,
                         n_axis: int, part_shape: Seq[int], k: int,
                         itemsize: int = 4,
                         reverse: bool = False) -> SynthPlan:
    """Chunked ring all-reduce over one axis: chunk ``j``'s accumulator
    seeds from the local slice, then ``n-1`` rotating hops each deliver a
    peer's slice to add (``ringr`` rotates the other way)."""
    rows = int(part_shape[0])
    if k < 1 or rows % k:
        raise ValueError(f"{base}: {rows} rows do not split {k} ways")
    if n_axis < 2:
        raise ValueError(f"{base}: ring needs an axis extent >= 2")
    sketch = "ringr" if reverse else "ring"
    shift = -1 if reverse else 1
    pre = f"{base}.{sketch}{k}"
    cshape = (rows // k,) + tuple(int(s) for s in part_shape[1:])
    cbytes = _nbytes(cshape, itemsize)
    plan = SynthPlan(base, "all_reduce", sketch, k, engine="ici",
                     n_xfers=k * (n_axis - 1),
                     xfer_bytes=k * (n_axis - 1) * cbytes)
    for j in range(k):
        cur, acc = f"{pre}.x{j}.cur", f"{pre}.x{j}.acc"
        plan.buffers += [BufDecl(cur, cshape), BufDecl(acc, cshape)]
        chain: List[OpBase] = [
            SlicePick(f"{pre}.x{j}.pick", src, cur, j, k),
            SlicePick(f"{pre}.x{j}.seed", src, acc, j, k),
        ]
        prev = cur
        for s in range(1, n_axis):
            rot = f"{pre}.x{j}.rot{s}"
            plan.buffers.append(BufDecl(rot, cshape))
            chain += [
                PermuteStart(f"{pre}.x{j}.p{s}", prev, rot, axis, shift),
                AwaitTransfer(f"{pre}.x{j}.w{s}", rot),
                AddInto(f"{pre}.x{j}.add{s}", rot, acc),
            ]
            prev = rot
        chain.append(PlaceSlice(f"{pre}.x{j}.put", acc, dst, j, k))
        plan.chains.append(chain)
    return plan


def plan_rhd_all_reduce(base: str, src: str, dst: str, axis: str,
                        n_axis: int, part_shape: Seq[int],
                        itemsize: int = 4) -> SynthPlan:
    """Recursive halving/doubling all-reduce (power-of-two axes): the
    accumulator shifts by ``1, 2, 4, ...`` and adds each arrival; after
    ``log2(n)`` hops every rank holds the sum."""
    if n_axis < 2 or n_axis & (n_axis - 1):
        raise ValueError(f"{base}: rhd needs a power-of-two axis, got {n_axis}")
    pre = f"{base}.rhd1"
    cshape = tuple(int(s) for s in part_shape)
    hops = int(n_axis).bit_length() - 1
    plan = SynthPlan(base, "all_reduce", "rhd", 1, engine="ici",
                     n_xfers=hops, xfer_bytes=hops * _nbytes(cshape, itemsize))
    acc = f"{pre}.acc"
    plan.buffers.append(BufDecl(acc, cshape))
    chain: List[OpBase] = [SlicePick(f"{pre}.seed", src, acc, 0, 1)]
    s = 1
    while s < n_axis:
        rot = f"{pre}.rot{s}"
        plan.buffers.append(BufDecl(rot, cshape))
        chain += [
            PermuteStart(f"{pre}.p{s}", acc, rot, axis, s),
            AwaitTransfer(f"{pre}.w{s}", rot),
            AddInto(f"{pre}.add{s}", rot, acc),
        ]
        s *= 2
    chain.append(PlaceSlice(f"{pre}.put", acc, dst, 0, 1))
    plan.chains.append(chain)
    return plan


def plan_ring_all_to_all(base: str, src: str, dst: str, axis: str,
                         n_axis: int, row_shape: Seq[int],
                         itemsize: int = 4) -> SynthPlan:
    """Ring all-to-all over one axis: step ``s`` picks the row meant ``s``
    hops ahead, shifts it there in one hop and places it at the sender's
    index, ``n-1`` single-hop posts in place of the fused ``AllToAllStart``.
    Pure movement: row for row what the fused all-to-all gives."""
    if n_axis < 2:
        raise ValueError(f"{base}: a2a ring needs an axis extent >= 2")
    pre = f"{base}.ring1"
    rshape = (1,) + tuple(int(s) for s in row_shape)
    rbytes = _nbytes(rshape, itemsize)
    plan = SynthPlan(base, "all_to_all", "ring", 1, engine="ici",
                     n_xfers=n_axis - 1, xfer_bytes=(n_axis - 1) * rbytes)
    own = f"{pre}.x0.row"
    plan.buffers.append(BufDecl(own, rshape))
    plan.chains.append([
        RowPick(f"{pre}.x0.pick", src, own, 0, axis),
        RowPlace(f"{pre}.x0.put", own, dst, 0, axis),
    ])
    for s in range(1, n_axis):
        row, mv = f"{pre}.x{s}.row", f"{pre}.x{s}.mv"
        plan.buffers += [BufDecl(row, rshape), BufDecl(mv, rshape)]
        plan.chains.append([
            RowPick(f"{pre}.x{s}.pick", src, row, s, axis),
            PermuteStart(f"{pre}.x{s}.p", row, mv, axis, s),
            AwaitTransfer(f"{pre}.x{s}.w", mv),
            RowPlace(f"{pre}.x{s}.put", mv, dst, -s, axis),
        ])
    return plan


def plan_neighbor_shift(base: str, src: str, dst: str, axis: str,
                        shift: int, part_shape: Seq[int], k: int,
                        itemsize: int = 4) -> SynthPlan:
    """Chunked neighbour exchange (the halo shift): the face splits into
    ``k`` chunk shifts whose awaits interleave.  Pure movement."""
    rows = int(part_shape[0])
    if k < 1 or rows % k:
        raise ValueError(f"{base}: {rows} rows do not split {k} ways")
    pre = f"{base}.neighbor{k}"
    cshape = (rows // k,) + tuple(int(s) for s in part_shape[1:])
    plan = SynthPlan(base, "shift", "neighbor", k, engine="ici",
                     n_xfers=k, xfer_bytes=k * _nbytes(cshape, itemsize))
    for j in range(k):
        snd, mv = f"{pre}.x{j}.snd", f"{pre}.x{j}.mv"
        plan.buffers += [BufDecl(snd, cshape), BufDecl(mv, cshape)]
        plan.chains.append([
            SlicePick(f"{pre}.x{j}.pick", src, snd, j, k),
            PermuteStart(f"{pre}.x{j}.p", snd, mv, axis, shift),
            AwaitTransfer(f"{pre}.x{j}.w", mv),
            PlaceSlice(f"{pre}.x{j}.put", mv, dst, j, k),
        ])
    return plan


def plan_host_pipe(base: str, src: str, dst: str, length: int, k: int,
                   itemsize: int = 4) -> SynthPlan:
    """Staged host pipeline: the payload goes device -> host -> device in
    ``k`` chunks (an uneven remainder spread over the first chunks), each
    chunk's spill and fetch on one transfer channel, reassembled by one
    concat.  Pure movement."""
    if k < 1 or k > max(1, int(length)):
        raise ValueError(f"{base}: cannot pipe {length} rows in {k} chunks")
    pre = f"{base}.pipe{k}"
    plan = SynthPlan(base, "exchange", "pipe", k, engine="pcie",
                     n_xfers=2 * k, xfer_bytes=2.0 * length * itemsize)
    pieces: List[str] = []
    for j, (lo, hi) in enumerate(_chunk_ranges(length, k)):
        snd, hst, rcv = f"{pre}.x{j}.snd", f"{pre}.x{j}.hst", f"{pre}.x{j}.rcv"
        plan.buffers += [BufDecl(snd, (hi - lo,)),
                         BufDecl(hst, (hi - lo,), space="host"),
                         BufDecl(rcv, (hi - lo,))]
        plan.chains.append([
            StaticSlice(f"{pre}.x{j}.pick", src, snd, lo, hi - lo),
            HostSpillStart(f"{pre}.x{j}.spill", snd, hst, channel=hst),
            HostFetchStart(f"{pre}.x{j}.fetch", hst, rcv, channel=hst),
            AwaitTransfer(f"{pre}.x{j}.w", rcv),
        ])
        pieces.append(rcv)
    plan.combines.append(ConcatPieces(f"{pre}.cat", pieces, dst))
    return plan


# -- graph packaging: plan -> CompoundOp / ChoiceOp ---------------------------


class SynthCollectiveOp(CompoundOp):
    """One instantiated sketch as a CompoundOp: the ``synth.<sketch>.c<K>``
    directive fans out into the plan's chains (serial within a chain, free
    across chains), joined by the plan's combine ops.  ``est_us`` carries
    the alpha-beta estimate into ``perf.synth``."""

    def __init__(self, plan: SynthPlan, est_us: Optional[float] = None):
        super().__init__(f"{plan.base}.synthed.{plan.sketch}.c{plan.chunks}")
        self._plan = plan
        self.est_us = est_us

    def plan(self) -> SynthPlan:
        return self._plan

    def base(self) -> str:
        return self._plan.base

    def sketch(self) -> str:
        return self._plan.sketch

    def chunks(self) -> int:
        return self._plan.chunks

    def graph(self) -> Graph:
        p = self._plan
        g = Graph()
        d = SynthDirective(p.base, p.sketch, p.chunks)
        g.start_then(d)
        tails: List[OpBase] = []
        for chain in p.chains:
            prev: OpBase = d
            for op in chain:
                g.then(prev, op)
                prev = op
            tails.append(prev)
        if p.combines:
            prev_c: Optional[OpBase] = None
            for cop in p.combines:
                for t in tails:
                    g.then(t, cop)
                if prev_c is not None:
                    g.then(prev_c, cop)
                prev_c = cop
            g.then_finish(prev_c)
        else:
            for t in tails:
                g.then_finish(t)
        return g

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "name": self.name(),
                "base": self._plan.base, "sketch": self._plan.sketch,
                "chunks": self._plan.chunks}


class FixedCollective(CompoundOp):
    """The fixed-engine alternative of a :class:`SynthCollectiveChoice`: the
    site's own op chain (e.g. ``PsumStart -> AwaitTransfer``), serial and
    unchanged, so choosing it runs what the unsynthesized graph runs."""

    def __init__(self, base: str, ops: Seq[OpBase]):
        super().__init__(f"{base}.fixed")
        if not ops:
            raise ValueError(f"{base}: FixedCollective needs at least one op")
        self._ops = list(ops)

    def ops(self) -> List[OpBase]:
        return list(self._ops)

    def graph(self) -> Graph:
        g = Graph()
        prev: Optional[OpBase] = None
        for op in self._ops:
            if prev is None:
                g.start_then(op)
            else:
                g.then(prev, op)
            prev = op
        g.then_finish(prev)
        return g


class SynthCollectiveChoice(ChoiceOp):
    """The menu of a site with no engine choice of its own: the fixed chain
    and the surviving instantiations, named ``<base>.synth``.  A site that
    has an engine menu (the halo's ``ExchangeChoice``) appends
    :class:`SynthCollectiveOp` alternatives to it instead."""

    def __init__(self, base: str, fixed: FixedCollective,
                 variants: Seq[SynthCollectiveOp],
                 menu: Optional[Dict[str, Any]] = None):
        super().__init__(base + ".synth")
        self._fixed = fixed
        self._variants = list(variants)
        if menu is not None:
            self.synth_menu = menu

    def choices(self) -> List[OpBase]:
        return [self._fixed] + list(self._variants)


# -- pricing, menus and the read-back -----------------------------------------


def _engine_link(topo: Topology, engine: str):
    for lk in topo.links:
        if lk.engine == engine:
            return lk
    return None


def sketch_cost_us(plan: SynthPlan, topo: Topology) -> Optional[float]:
    """The alpha-beta cost of one instantiation: every posted transfer pays
    its link's alpha, every byte its beta (a serial walk; the pipelining
    credit is the prune rule's ``overlap``)."""
    link = _engine_link(topo, plan.engine)
    if link is None:
        return None
    return plan.n_xfers * link.alpha_us + plan.xfer_bytes * link.beta_us_per_byte


def synth_menu_info(base: str, collective: str, menu: Seq[str],
                    est_us: Dict[str, float], pruned: Dict[str, str],
                    fixed_floor_us: Optional[float],
                    note: str) -> Dict[str, Any]:
    """The ``synth_menu`` attribute a choice node carries: ``menu`` leads
    with ``"fixed"``; ``note`` is never empty (the driver's ``perf.synth``
    block prints it)."""
    return {"base": base, "collective": collective,
            "menu": ["fixed"] + [m for m in menu if m != "fixed"],
            "est_us": {k: float(v) for k, v in est_us.items()},
            "pruned": dict(pruned),
            "fixed_floor_us": (None if fixed_floor_us is None
                               else float(fixed_floor_us)),
            "note": note or "no candidates priced"}


def sketch_menu(plans: Seq[SynthPlan], topo: Topology, fixed_bytes: float,
                overlap_us: float = 0.0, relax: bool = False,
                collective: Optional[str] = None
                ) -> Tuple[List[SynthCollectiveOp], Dict[str, Any]]:
    """Price ``plans`` over ``topo``, prune them against the fixed
    collective's one-post floor (``roofline.prune_sketches``) and return
    (surviving alternatives, ``synth_menu`` dict).

    ``fixed_bytes`` is what the fixed engine moves in one post;
    ``overlap_us`` the neighbouring work a pipelined instantiation could
    hide under.  Each post after the first costs the card's measured
    dispatch, ``roofline.CHUNK_DISPATCH_US``.  ``relax=True``
    (the tests, the smoke) keeps every candidate searchable and still
    reports what the rule would have dropped."""
    from tenzing_tpu_torch.bench import roofline

    if not plans:
        return [], synth_menu_info(
            "", collective or "", [], {}, {}, None,
            "no sketch instantiations apply at this site")
    base = plans[0].base
    coll = collective or plans[0].collective
    est: Dict[str, float] = {}
    cands: Dict[str, Dict[str, Any]] = {}
    by_label: Dict[str, SynthPlan] = {}
    for p in plans:
        c = sketch_cost_us(p, topo)
        if c is None:
            continue
        est[p.label()] = c
        cands[p.label()] = {"est_us": c, "steps": p.n_xfers, "chunks": p.chunks}
        by_label[p.label()] = p
    link = _engine_link(topo, plans[0].engine)
    fixed_floor = link.cost_us(fixed_bytes) if link is not None else 0.0
    kept, pruned = roofline.prune_sketches(cands, fixed_floor,
                                           overlap_us=overlap_us,
                                           dispatch_us=roofline.CHUNK_DISPATCH_US)
    if relax:
        note = (f"relax: all {len(cands)} instantiation(s) kept searchable; "
                f"analytic prune vs the fixed floor ({fixed_floor:.1f}us) "
                f"would keep {len(kept)} — advisory reasons in 'pruned'")
        kept = list(cands)
    else:
        note = (f"{len(pruned)} of {len(cands)} instantiation(s) pruned vs "
                f"the fixed one-post floor ({fixed_floor:.1f}us); "
                f"{len(kept)} kept")
    variants = [SynthCollectiveOp(by_label[lbl], est_us=est.get(lbl))
                for lbl in kept]
    menu = synth_menu_info(base, coll, [v.plan().label() for v in variants],
                           est, pruned, fixed_floor, note)
    return variants, menu


def synths_of(order) -> Dict[str, Dict[str, Any]]:
    """The synthesized decompositions a schedule carries, by site base name
    (``{}`` for a fixed-engine schedule), parsed from its
    ``<base>.synth.<sketch>.c<K>`` directives (the twin of
    ``chunking.chunks_of``).  ``order`` holds ops or names."""
    out: Dict[str, Dict[str, Any]] = {}
    for op in order:
        name = op.name() if hasattr(op, "name") else str(op)
        i = name.rfind(SYNTH_MARK)
        if i < 0:
            continue
        sketch, sep, cpart = name[i + len(SYNTH_MARK):].rpartition(".c")
        if not sep or sketch not in SKETCHES:
            continue
        try:
            out[name[:i]] = {"sketch": sketch, "chunks": max(1, int(cpart))}
        except ValueError:
            continue
    return out


def synth_menus(graph: Graph) -> Dict[str, Dict[str, Any]]:
    """Every synthesized-collective menu a choice graph offers, by site base
    name: the ``synth_menu`` of each vertex, descending into compound
    sub-graphs and choice alternatives."""
    menus: Dict[str, Dict[str, Any]] = {}
    # every visited op stays referenced: choices() and graph() build fresh
    # objects, and a freed one's id could be reused by a later op
    seen: Dict[int, OpBase] = {}

    def visit(op: OpBase) -> None:
        if id(op) in seen:
            return
        seen[id(op)] = op
        menu = getattr(op, "synth_menu", None)
        if isinstance(menu, dict) and menu.get("base"):
            menus[menu["base"]] = menu
        if isinstance(op, CompoundOp):
            for v in op.graph().vertices():
                visit(v)
        if isinstance(op, ChoiceOp):
            for c in op.choices():
                visit(c)

    for v in graph.vertices():
        visit(v)
    return menus


def synth_hidden_comm_measured_us(ops, attrib) -> float:
    """The measured hidden comm of a synthesized schedule: the summed
    overlap, on the attribution timeline's Gantt (obs/attrib), between the
    chosen decomposition's transfer steps and every unit that is neither a
    step nor a transfer (the twin of ``chunking.hidden_comm_measured_us``).
    ``ops`` is the executed op list, ``attrib`` its ``Attribution``."""
    chosen = synths_of(ops)
    if not chosen:
        return 0.0
    ops = list(ops)
    step_prefixes = tuple(
        f"{base}.{v['sketch']}{v['chunks']}." for base, v in chosen.items())
    comm_kinds = set(ICI_KINDS) | set(PCIE_KINDS) | {
        "await_transfer", "multi_await"}

    def op_kind(pos: int) -> str:
        if pos >= len(ops):
            return ""
        op = ops[pos]
        base = op.unbound() if hasattr(op, "unbound") else op
        return getattr(base, "KIND", "") or ""

    xfers: List[Tuple[float, float]] = []
    compute: List[Tuple[float, float]] = []
    for rec in attrib.timeline.records:
        if rec.dur_us <= 0:
            continue
        is_step = rec.name.startswith(step_prefixes)
        is_comm = any(op_kind(p) in comm_kinds for p in rec.positions)
        if is_step and is_comm:
            xfers.append((rec.start_us, rec.end_us))
        elif not is_step and not is_comm:
            compute.append((rec.start_us, rec.end_us))
    total = 0.0
    for cs, ce in xfers:
        for ps, pe in compute:
            total += max(0.0, min(ce, pe) - max(cs, ps))
    return total


__all__ = [
    "SYNTH_MARK", "SKETCHES", "COLLECTIVES",
    "SynthDirective", "SynthPlan", "BufDecl",
    "SlicePick", "PlaceSlice", "AddInto", "ConcatPieces", "StaticSlice",
    "RowPick", "RowPlace",
    "plan_ring_all_reduce", "plan_rhd_all_reduce", "plan_ring_all_to_all",
    "plan_neighbor_shift", "plan_host_pipe",
    "SynthCollectiveOp", "FixedCollective", "SynthCollectiveChoice",
    "sketch_cost_us", "sketch_menu", "synth_menu_info",
    "synths_of", "synth_menus", "synth_hidden_comm_measured_us",
]
