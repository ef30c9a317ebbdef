"""Sequential decision process over schedules.

Counterpart of ``tenzing_tpu/core/state.py`` (reference
``include/tenzing/state.hpp`` / ``src/state.cpp`` and
``include/tenzing/decision.hpp``).  A :class:`State` is (graph,
sequence-so-far).  ``get_decisions`` walks the graph frontier and emits per-op-kind
decisions (state.cpp:25-69); ``apply`` produces the successor state
(state.cpp:71-106); ``frontier`` is apply-all with equivalence dedup.

State equivalence = sequence equivalence and graph equivalence under mutually
consistent lane/event bijections (reference state.cpp:126-143).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from tenzing_tpu_torch.core import graph as graph_mod
from tenzing_tpu_torch.core import sequence as sequence_mod
from tenzing_tpu_torch.core.event_synchronizer import EventSynchronizer
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import (
    BoundOp,
    ChoiceOp,
    CompoundOp,
    DeviceOp,
    OpBase,
)
from tenzing_tpu_torch.core.resources import Equivalence, Lane
from tenzing_tpu_torch.core.sequence import Sequence


def _freeze(obj) -> Any:
    """JSON-able value -> hashable key with the same equality."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


class Decision:
    """Base decision (reference decision.hpp:13-20).

    Equality/hash is by JSON content (resource-sensitive: two syncs on
    different lanes are different decisions), via a key frozen once per
    instance — decisions are compared and deduped hot in the solvers."""

    _key: Optional[tuple] = None

    def desc(self) -> str:
        raise NotImplementedError

    def to_json(self) -> Dict[str, Any]:
        raise NotImplementedError

    def key(self) -> tuple:
        if self._key is None:
            self._key = (type(self).__name__, _freeze(self.to_json()))
        return self._key

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Decision) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self.desc()


class ExecuteOp(Decision):
    """Append an executable op to the sequence (reference decision.hpp:22-30)."""

    def __init__(self, op: BoundOp):
        self.op = op

    def desc(self) -> str:
        return f"Execute({self.op.desc()})"

    def to_json(self) -> Dict[str, Any]:
        return {"decision": "execute", "op": self.op.to_json()}


class AssignLane(Decision):
    """Bind a device op to a lane (reference AssignOpStream, decision.hpp:54-63)."""

    def __init__(self, op: DeviceOp, lane: Lane):
        self.op = op
        self.lane = lane

    def desc(self) -> str:
        return f"AssignLane({self.op.desc()},{self.lane!r})"

    def to_json(self) -> Dict[str, Any]:
        return {"decision": "assign_lane", "op": self.op.to_json(), "lane": self.lane.id}


class ExpandOp(Decision):
    """Inline a CompoundOp's sub-graph (reference decision.hpp:32-40)."""

    def __init__(self, op: CompoundOp):
        self.op = op

    def desc(self) -> str:
        return f"Expand({self.op.desc()})"

    def to_json(self) -> Dict[str, Any]:
        return {"decision": "expand", "op": self.op.to_json()}


class ChooseOp(Decision):
    """Replace a ChoiceOp with one of its choices (reference decision.hpp:42-52)."""

    def __init__(self, op: ChoiceOp, choice: OpBase):
        self.op = op
        self.choice = choice

    def desc(self) -> str:
        return f"Choose({self.op.desc()}->{self.choice.desc()})"

    def to_json(self) -> Dict[str, Any]:
        return {
            "decision": "choose",
            "op": self.op.to_json(),
            "choice": self.choice.to_json(),
        }


class State:
    """(graph, sequence) — a partial schedule (reference SDP::State, state.hpp:15-49)."""

    def __init__(self, graph: Graph, sequence: Optional[Sequence] = None):
        self.graph = graph
        self.sequence: Sequence = (
            sequence if sequence is not None else Sequence([graph.start()])
        )

    def is_terminal(self) -> bool:
        """Complete schedule: Finish executed."""
        return self.sequence.contains(self.graph.finish())

    def get_decisions(self, platform) -> List[Decision]:
        """Frontier -> decisions (reference state.cpp:25-69).  ``platform`` must
        expose ``lanes`` (list of Lane)."""
        decisions: List[Decision] = []
        for op in self.graph.frontier(self.sequence.vector()):
            if isinstance(op, BoundOp):
                syncs = EventSynchronizer.make_syncs(self.graph, self.sequence, op)
                if not syncs:
                    decisions.append(ExecuteOp(op))
                else:
                    decisions.extend(ExecuteOp(s) for s in syncs)
            elif isinstance(op, CompoundOp):
                decisions.append(ExpandOp(op))
            elif isinstance(op, ChoiceOp):
                decisions.extend(ChooseOp(op, c) for c in op.choices())
            elif isinstance(op, DeviceOp):
                decisions.extend(AssignLane(op, lane) for lane in platform.lanes)
            else:  # pragma: no cover - defensive
                raise TypeError(f"frontier op of unknown kind: {op!r}")
        # dedup identical decisions (e.g. the same sync demanded by two frontier ops)
        seen = set()
        out: List[Decision] = []
        for d in decisions:
            k = d.key()
            if k not in seen:
                seen.add(k)
                out.append(d)
        return out

    def apply(self, d: Decision) -> "State":
        """Successor state (reference state.cpp:71-106)."""
        if isinstance(d, ExecuteOp):
            seq = Sequence(self.sequence.vector())
            seq.push_back(d.op)
            return State(self.graph, seq)
        if isinstance(d, AssignLane):
            g = self.graph.clone_but_replace(d.op.bind(d.lane), d.op)
            return State(g, Sequence(self.sequence.vector()))
        if isinstance(d, ExpandOp):
            g = self.graph.clone_but_expand(d.op)
            return State(g, Sequence(self.sequence.vector()))
        if isinstance(d, ChooseOp):
            g = self.graph.clone_but_replace(d.choice, d.op)
            return State(g, Sequence(self.sequence.vector()))
        raise TypeError(f"unknown decision {d!r}")

    def frontier(self, platform, dedup: bool = True) -> List["State"]:
        """All successor states, deduplicated under resource-renaming equivalence
        (implements the dedup the reference left unimplemented, state.cpp:121).

        Candidates are bucketed by the sequence's O(1) ``canonical_key`` —
        states in different buckets cannot be equivalent (state equivalence
        requires sequence equivalence, which canonical keys decide exactly) —
        and only within a bucket does the full pairwise state check (sequence
        AND graph under one consistent bijection) run."""
        succs = [self.apply(d) for d in self.get_decisions(platform)]
        if not dedup:
            return succs
        out: List[State] = []
        buckets: Dict[tuple, List[State]] = {}
        for s in succs:
            key = sequence_mod.canonical_key(s.sequence)
            bucket = buckets.setdefault(key, [])
            if not any(get_equivalence(s, t) for t in bucket):
                bucket.append(s)
                out.append(s)
        return out

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"State(seq={self.sequence.desc()})"


def get_equivalence(a: State, b: State) -> Equivalence:
    """State equivalence: one consistent lane/event renaming must witness both the
    sequences and the graphs (reference state.cpp:126-143)."""
    e = sequence_mod.get_equivalence(a.sequence, b.sequence)
    if not e:
        return Equivalence.falsy()
    return graph_mod.get_equivalence(a.graph, b.graph, base=e)
