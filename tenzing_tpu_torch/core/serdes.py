"""JSON serialization of schedules, anchored to a graph on deserialization.

Counterpart of ``tenzing_tpu/core/serdes.py`` (reference
``include/tenzing/operation_serdes.hpp``): ops serialize themselves
(``OpBase.to_json``); deserialization searches the graph (descending into
CompoundOp sub-graphs and ChoiceOp choices) for an op whose name matches,
rebinding device ops with the serialized lane; scheduler-inserted sync ops
absent from the graph are reconstructed from their ``kind`` field.

The port keeps the reference's op names, kind tags and JSON shape, so a
schedule written by the JAX package deserializes here and runs on CUDA.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core import sync_ops as _sync_ops  # noqa: F401 — registers the
# scheduler-inserted sync-op kinds; without this, resolving a serialized
# event_record/event_sync would depend on whether the caller happened to import
# sync_ops first
from tenzing_tpu_torch.core.operation import (
    ChoiceOp,
    CompoundOp,
    DeviceOp,
    OpBase,
    kind_registry,
)
from tenzing_tpu_torch.core.resources import Lane
from tenzing_tpu_torch.core.sequence import Sequence


def sequence_to_json(seq: Sequence) -> List[Dict[str, Any]]:
    return [op.to_json() for op in seq]


def sequence_to_json_str(seq: Sequence) -> str:
    """Serialized schedule, memoized on the sequence: the executor's program
    cache, schedule ids, and the journal all key on this string for the same
    object many times per search (``Sequence.cached`` invalidates on
    mutation).  The per-op dict list from :func:`sequence_to_json` is NOT
    memoized — callers may mutate it."""
    if isinstance(seq, Sequence):
        return seq.cached(
            "json_str", lambda: json.dumps(sequence_to_json(seq)))
    return json.dumps(sequence_to_json(seq))


def _name_index(graph: Graph) -> Dict[str, OpBase]:
    """The graph-anchored lookup (reference operation_serdes.cpp:14-56): every
    op name in ``graph``, descending uniformly into compound sub-graphs and
    choice alternatives whatever the nesting, mapped to the first op of
    that name in the reference's search order (a vertex, then its compound
    sub-graph, then its choice alternatives).  Kept on the graph while its
    vertex count stands (a graph only gains vertices), so reading a database
    of thousands of rows walks the graph once instead of once per op."""
    n = len(graph.vertices())
    cached = getattr(graph, "_serdes_index", None)
    if cached is not None and cached[0] == n:
        return cached[1]
    names: Dict[str, OpBase] = {}

    def walk(op: OpBase) -> None:
        names.setdefault(op.name(), op)
        if isinstance(op, CompoundOp):
            for v in op.graph().vertices():
                walk(v)
        if isinstance(op, ChoiceOp):
            for c in op.choices():
                walk(c)

    for v in graph.vertices():
        walk(v)
    graph._serdes_index = (n, names)
    return names


def op_from_json(j: Dict[str, Any], graph: Graph) -> OpBase:
    """Re-materialize one op against the local graph (reference
    operation_serdes.cpp:58-76)."""
    kind = j.get("kind")
    registry = kind_registry()
    cls = registry.get(kind)
    if cls is not None and hasattr(cls, "from_json"):
        # scheduler-inserted sync ops carry everything they need
        return cls.from_json(j)
    name = j["name"]
    op = _name_index(graph).get(name)
    if op is None:
        raise KeyError(f"op {name!r} not found in graph during deserialization")
    from tenzing_tpu_torch.core.operation import unbound

    base = unbound(op)
    if "lane" in j:
        if not isinstance(base, DeviceOp):
            raise TypeError(f"serialized lane on non-device op {name!r}")
        return base.bind(Lane(j["lane"]))
    return base


def sequence_from_json(j: List[Dict[str, Any]], graph: Graph) -> Sequence:
    return Sequence([op_from_json(oj, graph) for oj in j])


def sequence_from_json_str(s: str, graph: Graph) -> Sequence:
    return sequence_from_json(json.loads(s), graph)
