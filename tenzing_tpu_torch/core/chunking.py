"""Op chunking: one op split into partial ops as a searchable decision.

Counterpart of ``tenzing_tpu/core/chunking.py``.  Whole-op scheduling lets a
transfer hide behind a neighbouring op, never behind the tail of its own
producer.  Splitting an audited op into ``n`` partials lets other work (a
transfer post, another chain's compute) run between them:

* **The protocol**: ``DeviceOp.chunkable()/chunk_counts()/split(n)``
  (core/operation.py).  The partials fold the combine into an accumulating
  read-modify-write (the attention sub-folds chain through the online-softmax
  state; the expert-MLP partials update their expert slice of the output).
  :class:`ChunkedOp` packages one expansion as an ordinary CompoundOp, which
  the scheduler inlines like any other.
* **Searchable counts**: a chunked expansion is one more alternative of an
  ordinary ChoiceOp (the models append :class:`ChunkedOp` variants to their
  kernel menus, or wrap a bare op in :class:`ChunkChoice`), so MCTS, DFS and
  the climb search chunk counts through the ChooseOp decision, and the
  verifier certifies chunked schedules through its projected graph.
* **The executed directive**: every expansion starts with a
  :class:`ChunkDirective` (``<base>.chunk.c<N>``), a host no-op that rides the
  schedule so the chosen count can be read back (:func:`chunks_of`).

``chunks=1`` is the op itself; ``chunks>1`` re-associates the accumulation
and is held to the driver's integrity gate like any other schedule.

The measured side: :func:`hidden_comm_measured_us` is the overlap of
transfers with the partials on the attribution profiler's timeline
(obs/attrib).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence as Seq

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import (
    ChoiceOp,
    CompoundOp,
    CpuOp,
    DeviceOp,
    OpBase,
    register_kind,
)
from tenzing_tpu_torch.ops.comm_ops import ICI_KINDS, PCIE_KINDS

# the directive marker: a ChunkDirective is named f"{base}{CHUNK_MARK}{n}"
CHUNK_MARK = ".chunk.c"


@register_kind("chunk")
class ChunkDirective(CpuOp):
    """The executed chunk directive: a host no-op named ``<base>.chunk.c<N>``
    whose only effect is to carry the chosen count in the schedule (the
    shape of the fusion backend's ``fuse_tile.tN``)."""

    def __init__(self, base: str, chunks: int):
        super().__init__(f"{base}{CHUNK_MARK}{int(chunks)}")
        self._base = base
        self._chunks = int(chunks)

    def base(self) -> str:
        return self._base

    def chunks(self) -> int:
        return self._chunks

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "name": self.name(),
                "base": self._base, "chunks": self._chunks}

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "ChunkDirective":
        return cls(j["base"], int(j["chunks"]))


class ChunkedOp(CompoundOp):
    """One chunked expansion of an audited op: the ``chunk.cN`` directive,
    then the op's ``split(n)`` partials chained serially.  ``est_hidden_us``
    carries the roofline's hidden-comm bound for this count
    (``bench/roofline.hidden_comm_bound_us``) into ``perf.chunked``; None
    when the menu was built unpriced."""

    def __init__(self, op: DeviceOp, chunks: int,
                 est_hidden_us: Optional[float] = None):
        super().__init__(f"{op.name()}.chunked.c{int(chunks)}")
        if int(chunks) < 2:
            raise ValueError("ChunkedOp needs chunks >= 2 (1 = the op itself)")
        if not op.chunkable():
            raise ValueError(f"op {op.name()!r} does not declare chunkable()")
        self._op = op
        self._chunks = int(chunks)
        self.est_hidden_us = est_hidden_us

    def base_op(self) -> DeviceOp:
        return self._op

    def chunks(self) -> int:
        return self._chunks

    def graph(self) -> Graph:
        g = Graph()
        prev: OpBase = ChunkDirective(self._op.name(), self._chunks)
        g.start_then(prev)
        for part in self._op.split(self._chunks):
            g.then(prev, part)
            prev = part
        g.then_finish(prev)
        return g

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "name": self.name(),
                "base": self._op.name(), "chunks": self._chunks}


class ChunkChoice(ChoiceOp):
    """The chunk-count menu of an op that has no kernel menu to extend: the
    op itself (chunks=1) or one of its expansions, named ``<op>.chunks``."""

    def __init__(self, op: DeviceOp, variants: Seq[ChunkedOp]):
        super().__init__(op.name() + ".chunks")
        self._op = op
        self._variants = list(variants)
        self.chunk_menu = menu_info(
            op.name(), [1] + [v.chunks() for v in self._variants],
            {v.chunks(): v.est_hidden_us for v in self._variants})

    def choices(self) -> List[OpBase]:
        return [self._op] + list(self._variants)


def menu_info(base: str, counts: Seq[int],
              est: Optional[Dict[int, Optional[float]]] = None
              ) -> Dict[str, Any]:
    """The ``chunk_menu`` a choice node carries: ``base`` (the name the
    chunked variants wrap, the key :func:`chunks_of` reads back), ``counts``
    (the pruned menu, 1 included) and ``est_hidden_us`` per count."""
    return {"base": base,
            "counts": sorted({int(c) for c in counts} | {1}),
            "est_hidden_us": {int(n): e for n, e in (est or {}).items()
                              if e is not None}}


def pow2_counts(extent: Optional[int], cap: int = 8) -> List[int]:
    """1 plus every power of two ``<= cap`` dividing ``extent``: the
    ``chunk_counts()`` rule of every audited op.  An unknown extent (None or
    0) gives ``[1]``."""
    out = [1]
    if not extent:
        return out
    n = 2
    while n <= cap and extent % n == 0:
        out.append(n)
        n *= 2
    return out


def chunk_variants(op: DeviceOp, counts: Seq[int],
                   est: Optional[Dict[int, float]] = None) -> List[ChunkedOp]:
    """:class:`ChunkedOp` alternatives of ``op`` for ``counts`` (entries
    ``<= 1`` skipped: 1 is the op itself)."""
    est = est or {}
    return [ChunkedOp(op, n, est_hidden_us=est.get(n))
            for n in sorted({int(c) for c in counts}) if n > 1]


def chunks_of(order) -> Dict[str, int]:
    """The chunk counts an executed schedule carries, by directive base name
    (``{}`` for an unchunked schedule)."""
    out: Dict[str, int] = {}
    for op in order:
        name = op.name() if hasattr(op, "name") else ""
        i = name.rfind(CHUNK_MARK)
        if i < 0:
            continue
        try:
            out[name[:i]] = max(1, int(name[i + len(CHUNK_MARK):]))
        except ValueError:
            continue
    return out


# the op kinds whose units move data between devices or through the host
# (ops/comm_ops.py ICI_KINDS and PCIE_KINDS) and the awaits
COMM_KINDS = frozenset(ICI_KINDS + PCIE_KINDS
                       + ("await_transfer", "multi_await"))


def hidden_comm_measured_us(ops, attrib) -> float:
    """The measured hidden comm of a chunked schedule (the driver's
    ``perf.chunked.hidden_comm_us.measured``; the reference's
    core/chunking.py:221): the summed overlap, on the attribution
    timeline's Gantt (obs/attrib: durations measured per unit, starts
    rebuilt from the happens-before relation), between transfer units and
    the chunk partials' units, i.e. the comm time that ran under a chunked
    op's partials.  ``ops`` is the executed op list, ``attrib`` the
    analyzed ``Attribution`` of the same schedule; 0.0 for an unchunked
    schedule or one without transfers."""
    chosen = chunks_of(ops)
    if not chosen:
        return 0.0
    ops = list(ops)
    part_prefixes = tuple(f"{base}.c{n}p" for base, n in chosen.items())

    def op_kind(pos: int) -> str:
        if pos >= len(ops):
            return ""
        op = ops[pos]
        base = op.unbound() if hasattr(op, "unbound") else op
        return getattr(base, "KIND", "") or ""

    parts, comms = [], []
    for rec in attrib.timeline.records:
        if rec.dur_us <= 0:
            continue
        if rec.name.startswith(part_prefixes):
            parts.append((rec.start_us, rec.end_us))
        elif any(op_kind(p) in COMM_KINDS for p in rec.positions):
            comms.append((rec.start_us, rec.end_us))
    total = 0.0
    for cs, ce in comms:
        for ps, pe in parts:
            total += max(0.0, min(ce, pe) - max(cs, ps))
    return total


def chunk_menus(graph: Graph) -> Dict[str, Dict[str, Any]]:
    """Every chunk menu a choice graph offers, by wrapped base op name: the
    ``chunk_menu`` of each vertex, descending into compound sub-graphs and
    choice alternatives."""
    menus: Dict[str, Dict[str, Any]] = {}
    # every visited op stays referenced: choices() and graph() build fresh
    # objects, and a freed one's id could be reused by a later op
    seen: Dict[int, OpBase] = {}

    def visit(op: OpBase) -> None:
        if id(op) in seen:
            return
        seen[id(op)] = op
        menu = getattr(op, "chunk_menu", None)
        if isinstance(menu, dict) and "base" in menu:
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


__all__ = [
    "CHUNK_MARK", "ChunkDirective", "ChunkedOp", "ChunkChoice",
    "chunk_variants", "chunks_of", "chunk_menus", "menu_info", "pow2_counts",
]
