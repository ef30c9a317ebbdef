"""Program DAG over operations.

Counterpart of ``tenzing_tpu/core/graph.py`` (reference
``include/tenzing/graph.hpp`` / ``src/graph.cpp``): adjacency maps keyed by op
identity, edge insertion ``then/start_then/then_finish``, ``clone``,
``clone_but_replace`` for lane-binding surgery, ``clone_but_expand`` for
CompoundOp inlining, ``frontier``, graphviz dump, whole-graph lane-assignment
enumeration, and graph equivalence under resource bijection.

Vertices are keyed by resource-insensitive op identity (operation.py
``eq_key``), so binding a DeviceOp to a Lane replaces the stored vertex object
but not its key.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence as Seq, Set, Tuple

from tenzing_tpu_torch.core.operation import (
    BoundDeviceOp,
    CompoundOp,
    DeviceOp,
    Finish,
    OpBase,
    Start,
)
from tenzing_tpu_torch.core.resources import Equivalence, Lane


class Graph:
    """A DAG of ops with Start/Finish sentinels (reference Graph<OpBase>)."""

    def __init__(self, start: Optional[OpBase] = None, finish: Optional[OpBase] = None):
        self.start_: OpBase = start if start is not None else Start()
        self.finish_: OpBase = finish if finish is not None else Finish()
        # insertion-ordered adjacency; the stored key object IS the graph vertex
        self.succs_: Dict[OpBase, List[OpBase]] = {}
        self.preds_: Dict[OpBase, List[OpBase]] = {}
        self._canon: Dict[Tuple, OpBase] = {}  # eq_key -> stored vertex object
        self._add_vertex(self.start_)
        self._add_vertex(self.finish_)

    # -- construction -----------------------------------------------------
    def _add_vertex(self, op: OpBase) -> OpBase:
        if op not in self.succs_:
            self.succs_[op] = []
            self.preds_[op] = []
            self._canon[op.eq_key()] = op
        return self._canon[op.eq_key()]

    def vertex(self, op: OpBase) -> OpBase:
        """Return the stored vertex object equal to ``op`` (O(1)) — the stored
        object carries the current resource binding (e.g. after
        clone_but_replace lane surgery)."""
        try:
            return self._canon[op.eq_key()]
        except KeyError:
            raise KeyError(f"op {op!r} not in graph") from None

    # backward-compatible private alias
    _vertex = vertex

    def then(self, a: OpBase, b: OpBase) -> OpBase:
        """Add edge a->b, inserting vertices as needed; returns b for chaining
        (reference graph.hpp:46-60)."""
        a = self._add_vertex(a)
        b = self._add_vertex(b)
        if b not in self.succs_[a]:
            self.succs_[a].append(b)
        if a not in self.preds_[b]:
            self.preds_[b].append(a)
        return b

    def start_then(self, b: OpBase) -> OpBase:
        return self.then(self.start_, b)

    def then_finish(self, a: OpBase) -> OpBase:
        return self.then(a, self.finish_)

    # -- queries ----------------------------------------------------------
    def vertices(self) -> List[OpBase]:
        return list(self.succs_.keys())

    def vertex_size(self) -> int:
        return len(self.succs_)

    def __contains__(self, op: OpBase) -> bool:
        return op in self.succs_

    def succs(self, op: OpBase) -> List[OpBase]:
        return self.succs_[op]

    def preds(self, op: OpBase) -> List[OpBase]:
        return self.preds_[op]

    def start(self) -> OpBase:
        return self.start_

    def finish(self) -> OpBase:
        return self.finish_

    def frontier(self, executed: Seq[OpBase]) -> List[OpBase]:
        """Ops whose predecessors have all executed and which have not themselves
        executed (reference graph.hpp:482-540).  ``executed`` may contain
        scheduler-inserted sync ops (not graph vertices) and bound versions of
        graph vertices — both handled by resource-insensitive identity."""
        done: Set[Tuple] = {op.eq_key() for op in executed}
        out: List[OpBase] = []
        for v in self.succs_:
            if v.eq_key() in done:
                continue
            if all(p.eq_key() in done for p in self.preds_[v]):
                out.append(v)
        return out

    # -- clone surgery ----------------------------------------------------
    def _clone_mapped(self, fn: Callable[[OpBase], OpBase]) -> "Graph":
        """Clone with every vertex passed through ``fn``."""
        g = Graph.__new__(Graph)
        mapped: Dict[OpBase, OpBase] = {v: fn(v) for v in self.succs_}
        keys = [m.eq_key() for m in mapped.values()]
        if len(set(keys)) != len(keys):
            raise ValueError("vertex substitution collides with an existing vertex")
        g.start_ = mapped[self.start_]
        g.finish_ = mapped[self.finish_]
        g.succs_ = {mapped[v]: [mapped[s] for s in ss] for v, ss in self.succs_.items()}
        g.preds_ = {mapped[v]: [mapped[p] for p in ps] for v, ps in self.preds_.items()}
        g._canon = {m.eq_key(): m for m in mapped.values()}
        return g

    def clone(self) -> "Graph":
        """Clone sharing op objects (ops are immutable values; reference
        graph.hpp:223-245 clones shared_ptrs for the same effect)."""
        return self._clone_mapped(lambda v: v)

    def clone_but_replace(self, new: OpBase, old: OpBase) -> "Graph":
        """Clone with vertex ``old`` replaced by ``new`` — lane binding keeps the
        identity key; ChooseOp substitution may change it (reference
        graph.hpp:130-158)."""
        old = self._vertex(old)
        return self._clone_mapped(lambda v: new if v == old else v)

    def clone_but_expand(self, compound: CompoundOp) -> "Graph":
        """Clone with ``compound`` inlined: its sub-graph's interior vertices are
        spliced in; preds(compound) -> succs(inner start); preds(inner finish) ->
        succs(compound) (reference graph.hpp:162-219)."""
        inner = compound.graph()
        comp = self._vertex(compound)
        g = self.clone()
        outer_preds = list(g.preds_[comp])
        outer_succs = list(g.succs_[comp])
        # remove compound vertex
        del g.succs_[comp]
        del g.preds_[comp]
        del g._canon[comp.eq_key()]
        for v in g.succs_:
            g.succs_[v] = [s for s in g.succs_[v] if s != comp]
            g.preds_[v] = [p for p in g.preds_[v] if p != comp]
        # splice interior vertices and edges
        interior = [v for v in inner.succs_ if v not in (inner.start_, inner.finish_)]
        for v in interior:
            if v in g:
                raise ValueError(
                    f"compound interior op {v!r} collides with an existing vertex"
                )
            g._add_vertex(v)
        for v in interior:
            for s in inner.succs_[v]:
                if s == inner.finish_:
                    continue
                g.then(v, s)
        entries = [s for s in inner.succs_[inner.start_] if s != inner.finish_]
        exits = [p for p in inner.preds_[inner.finish_] if p != inner.start_]
        for p in outer_preds:
            for e in entries:
                g.then(p, e)
            if not entries:
                for s in outer_succs:
                    g.then(p, s)
        for e in exits:
            for s in outer_succs:
                g.then(e, s)
        return g

    # -- whole-graph lane assignment (reference graph.cpp:42-234) ----------
    def device_vertices(self) -> List[OpBase]:
        return [
            v
            for v in self.succs_
            if isinstance(v, (DeviceOp, BoundDeviceOp))
        ]

    def apply_lane_assignment(self, assignment: Dict[OpBase, Lane]) -> "Graph":
        """Bind every DeviceOp per ``assignment`` (reference apply_assignment,
        graph.cpp:200-234)."""

        def fn(v: OpBase) -> OpBase:
            if v in assignment:
                lane = assignment[v]
                if isinstance(v, BoundDeviceOp):
                    return v.with_lane(lane)
                if isinstance(v, DeviceOp):
                    return v.bind(lane)
            return v

        return self._clone_mapped(fn)

    def use_lanes(self, lanes: Seq[Lane]) -> List["Graph"]:
        """Every total lane assignment of the graph's device ops (reference
        use_streams/use_streams2, graph.cpp:42-199)."""
        dops = self.device_vertices()
        out: List[Graph] = []
        for combo in itertools.product(lanes, repeat=len(dops)):
            out.append(self.apply_lane_assignment(dict(zip(dops, combo))))
        return out

    # -- visualization ----------------------------------------------------
    def dump_graphviz(self, path: Optional[str] = None) -> str:
        """Graphviz dot text (reference graph.cpp:13-40)."""
        ids = {v: i for i, v in enumerate(self.succs_)}
        lines = ["digraph G {"]
        for v, i in ids.items():
            lines.append(f'  n{i} [label="{v.desc()}"];')
        for v, ss in self.succs_.items():
            for s in ss:
                lines.append(f"  n{ids[v]} -> n{ids[s]};")
        lines.append("}")
        text = "\n".join(lines) + "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

# -- graph equivalence under resource bijection (reference graph.cpp:236-420) ----


def get_equivalence(a: Graph, b: Graph, base: Optional[Equivalence] = None) -> Equivalence:
    """An Equivalence witnessing that ``a`` and ``b`` are the same DAG up to a
    consistent renaming of lanes (events never appear as graph vertices), or a
    falsy Equivalence (reference get_equivalence, graph.cpp:348-420).  When
    ``base`` is given the renaming must consistently extend it (used by state
    equivalence, reference state.cpp:126-143)."""
    e = base.copy() if base is not None else Equivalence()
    if not e:
        return Equivalence.falsy()
    averts = {v.eq_key(): v for v in a.succs_}
    bverts = {v.eq_key(): v for v in b.succs_}
    if set(averts) != set(bverts):
        return Equivalence.falsy()
    for k, av in averts.items():
        bv = bverts[k]
        ab = isinstance(av, BoundDeviceOp)
        bb = isinstance(bv, BoundDeviceOp)
        if ab != bb:
            return Equivalence.falsy()
        if ab and not e.check_or_insert_lane(av.lane(), bv.lane()):
            return Equivalence.falsy()
    for v, ss in a.succs_.items():
        bss = b.succs_[bverts[v.eq_key()]]
        if {s.eq_key() for s in ss} != {s.eq_key() for s in bss}:
            return Equivalence.falsy()
    return e


def is_equivalent_lane_mapping(a: Graph, b: Graph) -> bool:
    """reference is_equivalent_stream_mapping, graph.cpp:236-346."""
    return bool(get_equivalence(a, b))
