"""Independent schedule-soundness verification.

Counterpart of ``tenzing_tpu/verify/soundness.py``.  The search only ever emits
schedules the :class:`EventSynchronizer` declared legal, and
``remove_redundant_syncs`` then prunes sync ops it proves removable.  On CUDA an
under-synchronized schedule is a real data race, and a race can *benchmark
faster*, so the driver keeps this separate checker in front of every
measurement and at its integrity gate.

The verifier reconstructs the happens-before relation of a complete schedule
**from scratch**, using only the documented semantics of the five sync ops
(core/sync_ops.py) — deliberately *not* reusing any ``EventSynchronizer``
internals:

* **lane program order** — ops bound to the same lane run in stream order;
  ops on different lanes are unordered unless a sync joins them;
* **host chain** — host ops (CpuOp, Start/Finish) run in program order, and
  every device op is launched after the host reaches it;
* **sync edges** — ``EventRecord(lane, e)`` snapshots the lane into event
  ``e``; ``WaitEvent(lane, e)`` / ``EventSync(e)`` join the snapshot into the
  lane / host chain; ``LaneSync`` / ``LaneWait`` join whole lanes into the host
  / another lane.

Against that relation :func:`verify_schedule` checks that every graph data
dependency is ordered (an unordered edge whose endpoints conflict on a declared
buffer is reported as the matching ``race:raw``/``race:war``/``race:waw``),
reports dangling records and waits as warnings, and reports structural defects
(a missing, duplicated or unbound op).  The verdict carries a minimal witness
per violation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import (
    BoundDeviceOp,
    ChoiceOp,
    CompoundOp,
    DeviceOp,
    OpBase,
)
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.sync_ops import (
    EventRecord,
    EventSync,
    LaneSync,
    LaneWait,
    SyncOp,
    WaitEvent,
)


@dataclass(frozen=True)
class Violation:
    """One soundness violation: the earliest pair the happens-before
    relation fails to order (``kind``: ``dep`` or ``race:raw``/``race:war``/
    ``race:waw``), or a structural defect (``missing_op``/``duplicate_op``/
    ``unbound_op``)."""

    kind: str
    a: str  # desc of the op that must come first ("" for structural)
    b: str  # desc of the op that must come after / the defective op
    a_pos: int = -1
    b_pos: int = -1
    resource: Optional[str] = None  # conflicting buffer for race:* kinds

    def witness(self) -> str:
        if self.a_pos < 0:
            return f"{self.kind}: {self.b}"
        res = f" on {self.resource!r}" if self.resource else ""
        return (f"{self.kind}{res}: {self.a} [pos {self.a_pos}] not "
                f"happens-before {self.b} [pos {self.b_pos}]")

    def to_json(self) -> dict:
        return {"kind": self.kind, "a": self.a, "b": self.b,
                "a_pos": self.a_pos, "b_pos": self.b_pos,
                "resource": self.resource}


@dataclass
class Soundness:
    """The structured verdict of :func:`verify_schedule`."""

    ok: bool
    violations: List[Violation] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    n_ops: int = 0
    n_edges_checked: int = 0

    def witness(self) -> str:
        """The minimal witness: the first (earliest-position) violation."""
        if self.ok:
            return "sound"
        return self.violations[0].witness()

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "violations": [v.to_json() for v in self.violations],
            "warnings": list(self.warnings),
            "n_ops": self.n_ops,
            "n_edges_checked": self.n_edges_checked,
        }


def happens_before_masks(ops: List[OpBase],
                         warnings: Optional[List[str]] = None) -> List[int]:
    """``reach[i]`` = bitmask of positions that happen-before-or-equal
    position ``i``, reconstructed from lane/host program order and the five
    sync ops' token semantics (module docstring).  Every edge points from an
    earlier to a later position, so one forward pass closes the relation."""
    lane_head: Dict[int, int] = {}  # lane id -> last position on its chain
    ev_src: Dict[int, int] = {}  # event id -> position of latest record
    host_head: Optional[int] = None
    reach: List[int] = []

    def w(msg: str) -> None:
        if warnings is not None:
            warnings.append(msg)

    for i, op in enumerate(ops):
        preds: List[Optional[int]] = []
        if isinstance(op, EventRecord):
            # snapshot: event token := lane token; the lane chain itself
            # does not advance (executor record_event)
            preds.append(lane_head.get(op.lane().id))
            ev_src[op.event().id] = i
        elif isinstance(op, WaitEvent):
            src = ev_src.get(op.event().id)
            if src is None:
                w(f"dangling wait: {op.desc()} [pos {i}] waits on an event "
                  "recorded later or never")
            preds.append(src)
            preds.append(lane_head.get(op.lane().id))
            lane_head[op.lane().id] = i
        elif isinstance(op, EventSync):
            src = ev_src.get(op.event().id)
            if src is None:
                w(f"dangling wait: {op.desc()} [pos {i}] syncs an event "
                  "recorded later or never")
            preds.append(src)
            preds.append(host_head)
            host_head = i
        elif isinstance(op, LaneSync):
            preds.append(lane_head.get(op.lane().id))
            preds.append(host_head)
            host_head = i
        elif isinstance(op, LaneWait):
            preds.append(lane_head.get(op.waitee().id))
            preds.append(lane_head.get(op.waiter().id))
            lane_head[op.waiter().id] = i
        elif isinstance(op, BoundDeviceOp):
            # dispatch semantics: a device op joins its lane chain AND the
            # host chain at its dispatch point (runtime/executor.py
            # trace_default: tok_in = join(lane, host))
            preds.append(lane_head.get(op.lane().id))
            preds.append(host_head)
            lane_head[op.lane().id] = i
        else:
            # host op (CpuOp/Start/Finish): host program order only
            preds.append(host_head)
            host_head = i
        m = 1 << i
        for p in preds:
            if p is not None:
                m |= reach[p]
        reach.append(m)

    # dangling records: an event snapshot nobody ever consumes
    consumed = {op.event().id for op in ops
                if isinstance(op, (WaitEvent, EventSync))}
    for i, op in enumerate(ops):
        if isinstance(op, EventRecord) and op.event().id not in consumed:
            w(f"dangling record: {op.desc()} [pos {i}] is never waited on")
    return reach


def _resolved_choice(choice: ChoiceOp, names: frozenset) -> Optional[OpBase]:
    """The alternative of ``choice`` whose (possibly nested) ops were
    executed, found by name — the same name-anchored resolution the serdes
    layer uses, reimplemented over public surfaces only.

    The descent into a compound alternative skips its start/finish
    sentinels: every sub-graph carries the same ``start``/``finish`` NoOp
    names and every executed schedule contains them, so counting them as
    mentions would make EVERY compound alternative match and resolve each
    such choice to its first compound alternative regardless of what
    actually executed (observed as chunked-count misprojection: a
    ``.chunked.c4`` schedule projected as the ``.c2`` expansion, a false
    ``missing_op``).

    An alternative whose ops ALL executed wins over one that merely shares
    some executed names.  Sibling compounds may share op names: the MoE
    staging menu's ``chain_c.bf16-host`` and ``chain_c.bf16-rdma`` both hold
    ``pack16_c``, ``ffn16_c`` and ``combine16_c`` and differ only in the
    transfer ops.  The reference resolves by the first shared name, so it
    projects every ``-rdma`` chain onto its ``-host`` sibling and rejects it
    (``missing_op: spilld16_0``; ROADMAP Queue 3)."""

    def subverts(op: CompoundOp):
        sub = op.graph()
        sentinels = (id(sub.start()), id(sub.finish()))
        return [v for v in sub.vertices() if id(v) not in sentinels]

    def mentions(op: OpBase) -> bool:
        if op.name() in names:
            return True
        if isinstance(op, CompoundOp):
            return any(mentions(v) for v in subverts(op))
        if isinstance(op, ChoiceOp):
            return any(mentions(c) for c in op.choices())
        return False

    def covered(op: OpBase) -> bool:
        """Every op of this alternative executed (one alternative of each
        nested choice)."""
        if op.name() in names:
            return True
        if isinstance(op, CompoundOp):
            return all(covered(v) for v in subverts(op))
        if isinstance(op, ChoiceOp):
            return any(covered(c) for c in op.choices())
        return False

    for test in (covered, mentions):
        for c in choice.choices():
            if test(c):
                return c
    return None


def project_graph(graph: Graph, names: frozenset) -> Tuple[Graph, List[str]]:
    """The evolved graph a schedule executing ``names`` was built from:
    every CompoundOp inlined, every ChoiceOp replaced by the alternative the
    executed names identify.  Returns (graph, notes) — a choice none of
    whose alternatives was executed is left unresolved and noted (its edges
    then simply contribute no checks)."""
    notes: List[str] = []
    g = graph
    for _ in range(10_000):  # fixed point; bounded defensively
        comps = [v for v in g.vertices() if isinstance(v, CompoundOp)]
        if comps:
            g = g.clone_but_expand(comps[0])
            continue
        choices = [v for v in g.vertices() if isinstance(v, ChoiceOp)]
        progressed = False
        for c in choices:
            pick = _resolved_choice(c, names)
            if pick is not None:
                g = g.clone_but_replace(pick, c)
                progressed = True
                break
            notes.append(
                f"unresolved choice {c.name()!r}: no executed "
                "alternative found")
            # a pruned-out subtree contributes no deps; strip the vertex so
            # the loop terminates
            g = _drop_vertex(g, c)
            progressed = True
            break
        if not progressed:
            return g, notes
    raise RuntimeError("project_graph did not converge")  # pragma: no cover


def _drop_vertex(g: Graph, v: OpBase) -> Graph:
    """Clone ``g`` without vertex ``v`` (predecessors re-wired to
    successors, preserving the transitive relation through the hole)."""
    out = g.clone()
    vv = out.vertex(v)
    preds = list(out.preds_[vv])
    succs = list(out.succs_[vv])
    del out.succs_[vv]
    del out.preds_[vv]
    del out._canon[vv.eq_key()]
    for u in out.succs_:
        out.succs_[u] = [s for s in out.succs_[u] if s != vv]
        out.preds_[u] = [p for p in out.preds_[u] if p != vv]
    for p in preds:
        for s in succs:
            out.then(p, s)
    return out


def _conflict(a: OpBase, b: OpBase) -> Optional[Tuple[str, str]]:
    """(hazard kind, buffer) when ``a`` then ``b`` conflict on a declared
    resource — RAW preferred over WAW over WAR when several apply."""
    ar = set(a.reads() if hasattr(a, "reads") else [])
    aw = set(a.writes() if hasattr(a, "writes") else [])
    br = set(b.reads() if hasattr(b, "reads") else [])
    bw = set(b.writes() if hasattr(b, "writes") else [])
    raw = aw & br
    if raw:
        return "race:raw", sorted(raw)[0]
    waw = aw & bw
    if waw:
        return "race:waw", sorted(waw)[0]
    war = ar & bw
    if war:
        return "race:war", sorted(war)[0]
    return None


def verify_schedule(order: Sequence,
                    graph: Optional[Graph] = None,
                    projection_cache: Optional[Dict] = None) -> Soundness:
    """Verify one complete schedule (see module docstring).  ``graph`` is
    the workload's (choice) graph; without it only the happens-before
    reconstruction, structural checks and dangling-sync warnings run —
    dependency/race checking needs the graph's ground-truth relation.
    ``projection_cache`` (a plain dict, e.g. :class:`ScheduleVerifier`'s)
    memoizes the evolved-graph projection per structural variant — the one
    non-trivial cost, shared by every schedule resolving the same
    choices."""
    ops = list(order)
    warnings: List[str] = []
    violations: List[Violation] = []

    # structural: no unbound device ops, no duplicated executable ops
    pos: Dict[Tuple, int] = {}
    for i, op in enumerate(ops):
        if isinstance(op, DeviceOp) and not isinstance(op, BoundDeviceOp):
            violations.append(Violation(
                kind="unbound_op", a="", b=op.desc(), b_pos=i))
            continue
        if isinstance(op, SyncOp):
            continue
        k = op.eq_key()
        if k in pos:
            violations.append(Violation(
                kind="duplicate_op", a=op.desc(), b=op.desc(),
                a_pos=pos[k], b_pos=i))
        else:
            pos[k] = i

    reach = happens_before_masks(ops, warnings)

    n_edges = 0
    if graph is not None and not violations:
        names = frozenset(op.name() for op in ops
                          if not isinstance(op, SyncOp))
        hit = (projection_cache.get(names)
               if projection_cache is not None else None)
        if hit is None:
            hit = project_graph(graph, names)
            if projection_cache is not None:
                projection_cache[names] = hit
        evolved, notes = hit
        warnings.extend(notes)
        for u in evolved.vertices():
            if isinstance(u, (ChoiceOp, CompoundOp)):
                continue  # unresolved leftovers contribute nothing
            ku = u.eq_key()
            pu = pos.get(ku)
            if pu is None:
                violations.append(Violation(
                    kind="missing_op", a="", b=u.desc()))
                continue
            for v in evolved.succs(u):
                if isinstance(v, (ChoiceOp, CompoundOp)):
                    continue
                pv = pos.get(v.eq_key())
                if pv is None:
                    continue  # reported once as missing_op above/below
                n_edges += 1
                if pu != pv and not (reach[pv] >> pu) & 1:
                    kind, res = "dep", None
                    c = _conflict(ops[pu], ops[pv])
                    if c is not None:
                        kind, res = c
                    violations.append(Violation(
                        kind=kind, a=ops[pu].desc(), b=ops[pv].desc(),
                        a_pos=pu, b_pos=pv, resource=res))

    violations.sort(key=lambda v: (v.b_pos if v.b_pos >= 0 else 1 << 60,
                                   v.a_pos))
    return Soundness(ok=not violations, violations=violations,
                     warnings=warnings, n_ops=len(ops),
                     n_edges_checked=n_edges)


class ScheduleVerifier:
    """The deployable guard: ``verifier(order) -> Soundness`` bound to one
    workload graph, with verdicts cached by schedule identity and graph
    projections cached per structural variant (the expensive part — one
    clone chain per distinct choice resolution, shared by every schedule in
    that variant via :func:`verify_schedule`'s internal projection being
    re-run but the verdict cache making repeats free).

    Non-:class:`~tenzing_tpu_torch.core.sequence.Sequence` orders (e.g. the
    CallableRunner's plain string names) are vacuously sound — there is no
    schedule to check."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self._verdicts: Dict[Tuple, Soundness] = {}
        self._projections: Dict = {}
        self.checked = 0
        self.unsound = 0

    def __call__(self, order) -> Soundness:
        if not isinstance(order, Sequence):
            return Soundness(ok=True)
        from tenzing_tpu_torch.core.sequence import canonical_key

        key = canonical_key(order)
        got = self._verdicts.get(key)
        if got is None:
            got = verify_schedule(order, self.graph,
                                  projection_cache=self._projections)
            self._verdicts[key] = got
            self.checked += 1
            if not got.ok:
                self.unsound += 1
        return got



def report_unsound(where: str, order, verdict: Soundness) -> None:
    """The one ``verify.unsound`` record every guard shares (the
    reference's): a counter and a trace event with the schedule id and the
    witness."""
    from tenzing_tpu_torch.bench.benchmarker import schedule_id
    from tenzing_tpu_torch.obs.metrics import get_metrics
    from tenzing_tpu_torch.obs.tracer import get_tracer

    get_metrics().counter("verify.unsound").inc()
    tr = get_tracer()
    if tr.enabled:
        tr.event("verify.unsound", where=where, schedule=schedule_id(order),
                 witness=verdict.witness(),
                 n_violations=len(verdict.violations))
