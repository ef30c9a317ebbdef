"""Fused regions: lower a searched schedule into fused-region kernels with a
searchable tile count.

Counterpart of ``tenzing_tpu/runtime/fused.py``:

* :func:`partition_regions` cuts a complete schedule into **fusible
  regions**: maximal runs of fusible device ops between comm, host and sync
  boundaries.  A transfer or host op splits; a cross-lane sync splits; an
  ``EventRecord`` inside a region is deferred to just after the fused op (the
  snapshot then covers more work: downstream waits over-wait, never
  under-wait).  Within a region, ops on different lanes are data-independent
  by soundness (a cross-lane dependency carries a record/wait pair, which
  would have split the region).  Only ops that declare ``fusible()`` join,
  and never one whose slot launches a hand-written kernel (``uses_pallas``).
* :class:`FusedRegionOp` runs one region as ONE launch of the
  ``fused_region`` kernel (ops/fused_region.py, csrc/fused_region.cu) on the
  stream of its first lane.  It spans every member lane, as the reference's
  ``trace_fused`` does: before the launch the lead lane's stream waits on
  every other member lane's stream, after it every other member lane waits
  on the lead lane — a barrier across the lanes it absorbed.
* **Searchable tiling**: the kernel's blocks split into ``tiles`` groups
  along the region's declared row axes (``DeviceOp.fuse_tiling``).  Tile
  counts are decisions of the choice graph: :func:`with_tile_menu` plants a
  :class:`FuseTileChoice` after Start, the solvers resolve it like any other
  ChoiceOp, the executed :class:`FuseTile` directive rides the schedule, and
  :class:`FusedExecutor` reads it back.  ``bench/roofline.prune_tilings``
  prunes counts that cannot help.
* :class:`FusedExecutor` wraps a :class:`StreamExecutor` behind the same
  ``ScheduleRunner`` surface (``prepare_n`` / ``prepare`` / ``run`` /
  ``compile`` / ``precompile``), lowering through the fusion plan (cached per
  schedule x tiles).

Each region is lowered, once per (schedule, tiles), into the kernel's
descriptor table: the members in schedule order, each a body kind
(``FUSED_BODY``, ``fused_operands()`` and ``fused_params()`` on the op: the
SpMV iteration's four ops, the attention fold and sub-fold, the finalize)
with its extents and a barrier flag.  A region with more members than one
table holds runs as consecutive launches of the kernel on the same stream.
A fusible op without a body raises "not yet ported".  The barrier counters
are op scratch, allocated when the executor provisions the fused order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence as Seq, Tuple

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import (
    BoundDeviceOp,
    ChoiceOp,
    CpuOp,
    DeviceOp,
    OpBase,
    register_kind,
    unbound,
)
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.sync_ops import EventRecord, SyncOp
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.runtime.executor import evolve_host_space


# -- tile decision nodes (the choice-graph surface) --------------------------

TILE_PREFIX = "fuse_tile.t"


@register_kind("fuse_tile")
class FuseTile(CpuOp):
    """The executed tile directive: a no-op host op named ``fuse_tile.t<N>``
    whose only effect is to ride the schedule so the fusion backend can read
    the searched tile count back out."""

    def __init__(self, tiles: int):
        super().__init__(f"{TILE_PREFIX}{int(tiles)}")
        self._tiles = int(tiles)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "name": self.name(), "tiles": self._tiles}

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "FuseTile":
        return cls(int(j["tiles"]))


class FuseTileChoice(ChoiceOp):
    """The tile-count menu as an ordinary ChoiceOp: MCTS, DFS and the
    hill-climb search it through the ChooseOp decision."""

    def __init__(self, tile_counts: Seq[int], name: str = "fuse_tile"):
        super().__init__(name)
        self._tiles = [int(t) for t in tile_counts]
        if not self._tiles:
            raise ValueError("FuseTileChoice needs at least one tile count")

    def choices(self) -> List[OpBase]:
        return [FuseTile(t) for t in self._tiles]


def with_tile_menu(graph: Graph, tile_counts: Seq[int]) -> Graph:
    """Clone ``graph`` with a :class:`FuseTileChoice` planted between Start
    and the original entry ops: the directive always executes before any
    device op, and every complete schedule carries exactly one."""
    g = graph.clone()
    choice = FuseTileChoice(tile_counts)
    entries = [s for s in list(g.succs(g.start())) if s != g.finish()]
    g.then(g.start(), choice)
    for e in entries:
        g.then(choice, e)
    if not entries:  # degenerate start->finish graph: keep choice reachable
        g.then(choice, g.finish())
    return g


def tiles_of(order) -> int:
    """The tile count a schedule's :class:`FuseTile` directive requests (1
    when the schedule carries none)."""
    for op in order:
        name = op.name() if hasattr(op, "name") else ""
        if name.startswith(TILE_PREFIX):
            try:
                return max(1, int(name[len(TILE_PREFIX):]))
            except ValueError:
                continue
    return 1


# -- region model ------------------------------------------------------------


@dataclass
class Region:
    """One fusible region: the member ops in schedule order, plus the
    EventRecords deferred past the fused op."""

    members: List[BoundDeviceOp] = field(default_factory=list)
    deferred: List[OpBase] = field(default_factory=list)

    def lanes(self) -> List:
        seen, out = set(), []
        for op in self.members:
            lane = op.lane()
            if lane.id not in seen:
                seen.add(lane.id)
                out.append(lane)
        return out

    def reads_external(self) -> List[str]:
        """Buffers the region reads from outside (first touch is a read)."""
        written: set = set()
        out: List[str] = []
        for op in self.members:
            for n in op.reads():
                if n not in written and n not in out:
                    out.append(n)
            written.update(op.writes())
        return out

    def writes(self) -> List[str]:
        out: List[str] = []
        for op in self.members:
            for n in op.writes():
                if n not in out:
                    out.append(n)
        return out


def _op_fusible(op: OpBase, host_space: set) -> bool:
    """Region membership: an opt-in fusible BoundDeviceOp that launches no
    hand-written kernel of its own, moves nothing between memory spaces, and
    touches no host-resident buffer at this point of the schedule."""
    if not isinstance(op, BoundDeviceOp):
        return False
    if op.uses_pallas() or not op.fusible():
        return False
    if getattr(unbound(op), "DST_SPACE", None) is not None:
        return False
    if not op.writes():
        return False
    if any(n in host_space for n in list(op.reads()) + list(op.writes())):
        return False
    return True


def partition_regions(ops: List[OpBase],
                      host_space: Optional[set] = None) -> List[Tuple[str, Any]]:
    """Cut a complete schedule into segments: ``("region", Region)`` for each
    fusible run, ``("op", op)`` for everything else, in schedule order (deferred EventRecords re-emitted right
    after their region).  ``host_space``: the buffers host-resident at
    schedule start, evolved across transfer ops with the executor's
    :func:`~tenzing_tpu_torch.runtime.executor.evolve_host_space`."""
    host = set(host_space) if host_space else set()
    segments: List[Tuple[str, Any]] = []
    cur: List[Tuple[OpBase, bool]] = []  # (op, is_member)

    def flush() -> None:
        if not cur:
            return
        # a run starts with a member: deferred records only follow one
        region = Region(members=[op for op, m in cur if m],
                        deferred=[op for op, m in cur if not m])
        segments.append(("region", region))
        for op in region.deferred:
            segments.append(("op", op))
        cur.clear()

    for op in ops:
        if isinstance(op, SyncOp):
            if isinstance(op, EventRecord) and any(m for _, m in cur):
                # outgoing snapshot: defer past the fused op (conservative)
                cur.append((op, False))
                continue
            flush()
            segments.append(("op", op))
            continue
        if _op_fusible(op, host):
            cur.append((op, True))
            continue
        flush()
        segments.append(("op", op))
        evolve_host_space(host, op)
    flush()
    return segments


# -- tiling ------------------------------------------------------------------


def region_axes(region: Region) -> Optional[Dict[str, Optional[int]]]:
    """The region's common row decomposition: per buffer, the independence
    axis every touching member agrees on (``None`` = whole view).  ``None``
    — one tile only — when a member is untileable, members disagree on a
    buffer's axis, or a written buffer would need a whole view."""
    axes: Dict[str, Optional[int]] = {}
    for op in region.members:
        t = op.fuse_tiling()
        if t is None:
            return None
        for n in set(op.reads()) | set(op.writes()):
            a = t.get(n)
            if n in axes and axes[n] != a:
                return None
            axes[n] = a
    for op in region.members:
        for n in op.writes():
            if axes.get(n) is None:
                return None
    return axes


def region_tile_counts(region: Region, shapes: Dict[str, Tuple[int, ...]],
                       max_tiles: int = 64) -> List[int]:
    """Structurally valid tile counts for a region: powers of two dividing
    every tiled buffer's extent along its declared axis; ``[1]`` when the
    region admits no decomposition.  Pruning is the caller's."""
    axes = region_axes(region)
    if axes is None:
        return [1]
    tiled = [(n, a) for n, a in axes.items() if a is not None]
    if not tiled:
        return [1]
    for n, a in tiled:
        if n not in shapes or a >= len(shapes[n]):
            return [1]
    out = [1]
    t = 2
    while t <= max_tiles:
        if all(shapes[n][a] % t == 0 and shapes[n][a] >= t for n, a in tiled):
            out.append(t)
        t *= 2
    return out


def region_bytes(region: Region, nbytes: Dict[str, int]) -> int:
    """The region's traffic (external reads + writes), for the pruning."""
    names = set(region.reads_external()) | set(region.writes())
    return sum(int(nbytes.get(n, 0)) for n in names)


def region_full_bytes(region: Region, nbytes: Dict[str, int]) -> int:
    """The part of :func:`region_bytes` in whole-view buffers: every group
    reads them whole, so it does not shrink with the tile count."""
    axes = region_axes(region) or {}
    names = set(region.reads_external()) | set(region.writes())
    return sum(int(nbytes.get(n, 0)) for n in names if axes.get(n) is None)


# -- kernel lowering ---------------------------------------------------------


def lower_region(members: List[BoundDeviceOp],
                 shapes: Dict[str, Tuple[int, ...]], dtypes: Dict[str, Any]):
    """The kernel's member entries (ops/fused_region.py ``MemberBody``) for a
    region: each member's body, operands and parameters from its
    ``FUSED_BODY``, ``fused_operands()`` and ``fused_params()``, its extents
    checked against the buffers, and the barrier flags and the operands
    written earlier in the region from the members' reads and writes.  The
    kernel tiles a body's tiled operands along axis 0 (SpMV) or axis 1 (the
    attention bodies' query rows); a member whose ``fuse_tiling`` declares
    another axis for one of them raises, and so does a member without a
    body ("not yet ported")."""
    from tenzing_tpu_torch.ops import fused_region as fr

    reads = [list(m.reads()) for m in members]
    writes = [list(m.writes()) for m in members]
    flags = fr.barrier_flags(reads, writes)
    out = []
    for op, barrier, written in zip(members, flags,
                                    fr.written_flags(reads, writes)):
        base = unbound(op)
        body = getattr(base, "FUSED_BODY", None)
        if body is None:
            raise NotImplementedError(
                f"not yet ported: fused region member {type(base).__name__} "
                f"({op.name()})")
        operands = tuple(base.fused_operands())
        params = base.fused_params() if hasattr(base, "fused_params") else None
        tiling = base.fuse_tiling() or {}
        axis = 1 if body in fr.ATTN_BODIES else 0
        roles = dict(zip(fr.OPERANDS[body], operands))
        for role in fr.TILED[body]:
            if tiling and tiling.get(roles.get(role), axis) != axis:
                raise ValueError(f"{op.name()}: {roles[role]!r} is declared "
                                 f"tiled along axis {tiling[roles[role]]}, the "
                                 f"{body} body tiles axis {axis}")
        ext = fr.check_member(body, operands, shapes, dtypes, params)
        out.append(fr.MemberBody(
            body=body, operands=operands, barrier=barrier,
            written=tuple(n for n in operands if n in written), **ext))
    return out


class FusedRegionKernel(DeviceOp):
    """The unbound fused region: reads the region's external inputs, writes
    its outputs; ``apply`` is one launch of the ``fused_region`` kernel (its
    plain version under ``ctx.plain_kernels``)."""

    KIND = "fused_region"

    def __init__(self, name: str, members: List[BoundDeviceOp],
                 in_names: List[str], out_names: List[str], bodies, tiles: int):
        from tenzing_tpu_torch.ops.fused_region import RegionTable

        super().__init__(name)
        self._members = list(members)
        self._in = list(in_names)
        self._out = list(out_names)
        self._tiles = int(tiles)
        self.table = RegionTable(list(bodies), self._tiles)

    def bodies(self):
        return list(self.table.members)

    def reads(self) -> List[str]:
        return list(self._in)

    def writes(self) -> List[str]:
        return list(self._out)

    def _counters(self) -> str:
        return f"fused_barrier_{self.name()}"

    def scratch(self):
        # a count and a generation per group (csrc/fused_region.cu)
        return {self._counters(): ((2 * self._tiles,), "int32")}

    def apply(self, bufs: Dict[str, Any], ctx) -> None:
        from tenzing_tpu_torch.ops import fused_region as fr

        if ctx.plain_kernels:
            fr.region_plain(self.table.members, bufs, self._tiles)
        else:
            fr.fused_region(self.table, bufs, ctx.scratch.get(self._counters()))

    def uses_pallas(self) -> bool:
        return True

    def desc(self) -> str:
        return f"{self.name()}({'+'.join(m.name() for m in self._members)})"

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "name": self.name(),
                "members": [m.name() for m in self._members],
                "tiles": self._tiles}


class FusedRegionOp(BoundDeviceOp):
    """The bound fused region: launched on its first lane's stream, it spans
    every member lane (module docstring), so replacing the members can only
    add happens-before edges, never drop one."""

    def __init__(self, kernel: FusedRegionKernel, lanes: List):
        super().__init__(kernel, lanes[0])
        self._all_lanes = list(lanes)

    def lanes(self) -> List:
        return list(self._all_lanes)

    def execute(self, ctx) -> None:
        if not ctx.on_cuda:
            ctx.run_default(self)
            return
        import torch

        lead = ctx.lane_stream(self._all_lanes[0])
        others = [ctx.lane_stream(lane) for lane in self._all_lanes[1:]]
        for s in others:
            lead.wait_stream(s)
        with torch.cuda.stream(lead):
            self.apply(ctx.bufs, ctx)
        for s in others:
            s.wait_stream(lead)

    def to_json(self) -> Dict[str, Any]:
        j = self.unbound().to_json()
        j["lane"] = self.lane().id
        j["lanes"] = [lane.id for lane in self._all_lanes]
        return j


# -- the fusion plan + executor ----------------------------------------------


@dataclass
class RegionInfo:
    """Provenance for one lowered region (the ``perf.fused`` block)."""

    n_ops: int
    members: List[str]
    lanes: List[int]
    tiles: int
    valid_tiles: List[int]
    pruned_tiles: List[int]


@dataclass
class FusionPlan:
    """What :meth:`FusedExecutor.plan` decided for one schedule: the fused
    order (regions replaced by :class:`FusedRegionOp`) plus provenance."""

    fused_order: Sequence
    regions: List[RegionInfo]
    tiles_requested: int
    n_ops_total: int
    n_ops_fused: int

    @property
    def tile_menu(self) -> List[int]:
        """Tile counts worth searching: valid and unpruned for at least one
        region (always contains 1)."""
        menu = {1}
        for r in self.regions:
            menu.update(r.pruned_tiles)
        return sorted(menu)


class FusedExecutor:
    """The fusion path behind the ``ScheduleRunner`` surface: every
    ``prepare/prepare_n/run/compile/precompile`` lowers the schedule through
    its fusion plan and delegates to the wrapped :class:`StreamExecutor`.

    ``tiles=None`` reads the schedule's :class:`FuseTile` directive (the
    searched decision); an explicit ``tiles`` overrides it (the driver's
    tile-menu sweep).  A count a region does not admit falls back to that
    region's largest admitted divisor of it.

    The menu is pruned by ``bench/roofline.prune_tilings`` at its default
    floor."""

    def __init__(self, inner, tiles: Optional[int] = None):
        self.inner = inner
        self.tiles = tiles
        self._plans: Dict[Tuple, FusionPlan] = {}

    # -- delegated surface --------------------------------------------------
    @property
    def platform(self):
        return self.inner.platform

    @property
    def device(self):
        return self.inner.device

    @property
    def init_bufs(self):
        return self.inner.init_bufs

    @property
    def host_names(self) -> set:
        return self.inner.host_names

    # -- planning -----------------------------------------------------------
    def _host_space0(self) -> set:
        """The buffers that live in pinned host memory (the executor's
        ``host_names``): fusion must not touch them."""
        return set(self.inner.host_names)

    def _shapes_dtypes(self):
        bufs = self.inner.init_bufs
        shapes = {k: tuple(v.shape) for k, v in bufs.items()}
        dtypes = {k: v.dtype for k, v in bufs.items()}
        nbytes = {k: v.numel() * v.element_size() for k, v in bufs.items()}
        return shapes, dtypes, nbytes

    def _pruned_tiles(self, region: Region, valid: List[int],
                      nbytes: Dict[str, int]) -> List[int]:
        from tenzing_tpu_torch.bench import roofline

        cost = roofline.Cost(flops=0.0,
                             hbm_bytes=float(region_bytes(region, nbytes)))
        return roofline.prune_tilings(
            cost, valid, full_bytes=float(region_full_bytes(region, nbytes)))

    def plan(self, order: Sequence) -> FusionPlan:
        """The fusion plan for ``order`` (cached per schedule x tiles)."""
        from tenzing_tpu_torch.core.serdes import sequence_to_json_str

        tiles_req = self.tiles if self.tiles is not None else tiles_of(order)
        key = (sequence_to_json_str(order), int(tiles_req))
        hit = self._plans.get(key)
        if hit is not None:
            return hit
        ops = order.vector()
        shapes, dtypes, nbytes = self._shapes_dtypes()
        segments = partition_regions(ops, host_space=self._host_space0())
        fused_ops: List[OpBase] = []
        infos: List[RegionInfo] = []
        n_fused = 0
        with get_tracer().span("fused.plan", n_ops=len(ops),
                               tiles=int(tiles_req)):
            for kind, seg in segments:
                if kind == "op":
                    fused_ops.append(seg)
                    continue
                region: Region = seg
                valid = region_tile_counts(region, shapes)
                pruned = self._pruned_tiles(region, valid, nbytes)
                t = _best_divisor(int(tiles_req), pruned)
                bodies = lower_region(region.members, shapes, dtypes)
                idx = len(infos)
                kernel = FusedRegionKernel(
                    f"fused{idx}.t{t}", region.members,
                    region.reads_external(), region.writes(), bodies, t)
                fused_ops.append(FusedRegionOp(kernel, region.lanes()))
                infos.append(RegionInfo(
                    n_ops=len(region.members),
                    members=[m.name() for m in region.members],
                    lanes=[lane.id for lane in region.lanes()],
                    tiles=t, valid_tiles=valid, pruned_tiles=pruned))
                n_fused += len(region.members)
        plan = FusionPlan(fused_order=Sequence(fused_ops), regions=infos,
                          tiles_requested=int(tiles_req),
                          n_ops_total=len(ops), n_ops_fused=n_fused)
        get_metrics().counter("fused.plans").inc()
        get_metrics().counter("fused.regions").inc(len(infos))
        self._plans[key] = plan
        return plan

    def fused_order(self, order: Sequence) -> Sequence:
        return self.plan(order).fused_order

    # -- ScheduleRunner surface ---------------------------------------------
    def is_compiled(self, order: Sequence) -> bool:
        return self.inner.is_compiled(self.fused_order(order))

    def precompile(self, order: Sequence) -> bool:
        return self.inner.precompile(self.fused_order(order))

    def prepare(self, order: Sequence):
        return self.inner.prepare(self.fused_order(order))

    def prepare_n(self, order: Sequence):
        return self.inner.prepare_n(self.fused_order(order))

    def run(self, order: Sequence) -> Dict[str, Any]:
        return self.inner.run(self.fused_order(order))

    def compile(self, order: Sequence):
        return self.inner.compile(self.fused_order(order))


def _best_divisor(want: int, menu: List[int]) -> int:
    """The largest menu entry dividing ``want`` (1 always divides and is
    always on the menu): a region keeps the biggest decomposition the
    requested tile count admits."""
    best = 1
    for t in menu:
        if t <= want and want % t == 0 and t > best:
            best = t
    return best


def fused_summary(plan: FusionPlan) -> str:
    """One human line for stderr provenance."""
    return (f"{len(plan.regions)} region(s) over {plan.n_ops_fused}/"
            f"{plan.n_ops_total} ops, sizes "
            f"{[r.n_ops for r in plan.regions]}, tiles "
            f"{[r.tiles for r in plan.regions]}")


__all__ = [
    "FuseTile", "FuseTileChoice", "with_tile_menu", "tiles_of",
    "Region", "partition_regions", "region_axes", "region_tile_counts",
    "region_bytes", "region_full_bytes", "lower_region", "FusedRegionKernel", "FusedRegionOp",
    "RegionInfo", "FusionPlan", "FusedExecutor", "fused_summary",
]
