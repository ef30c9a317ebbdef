"""Policy-driven schedule construction: the ``drive`` / ``phase_policy`` part
of ``tenzing_tpu/solve/local.py``.

``drive`` runs a decision policy from ``State(graph)`` to a terminal state and
records the decision list; ``phase_policy`` is the phase-ordered discipline
the greedy incumbents, the paired incumbent and the MCTS rollout policy use.
The hill-climb that the reference module builds on top of these comes with a
later slice of the port.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence as Seq, Tuple

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.state import (
    AssignLane,
    ChooseOp,
    Decision,
    ExecuteOp,
    ExpandOp,
    State,
)


def phase_policy(platform, phases: Seq[str],
                 prefer: Optional[Callable[[str, List[str]], Optional[str]]] = None,
                 priority: Optional[Callable[[str], int]] = None):
    """A policy closure for :func:`drive`: expand compounds eagerly, resolve
    ChoiceOps via ``prefer(choice_op_name, choice_names) -> chosen name`` (or
    the first choice), round-robin lane bindings, and execute in ``phases``
    order with the sync-gating discipline of solve/greedy.py.

    ``priority`` (op name -> int) overrides the prefix-index phase of an op —
    finer-than-phase disciplines (e.g. the halo paired await/unpack interleave,
    models/halo_pipeline.paired_priority) express per-op orderings while
    reusing the same gating machinery."""
    from tenzing_tpu_torch.core.sync_ops import SyncOp

    lane_rr = [0]

    def phase(op) -> int:
        name = op.name()
        if priority is not None:
            return priority(name)
        for i, p in enumerate(phases):
            if name.startswith(p):
                return i
        return 0

    def policy(st: State, ds: List[Decision]) -> Decision:
        expands = [d for d in ds if isinstance(d, ExpandOp)]
        if expands:
            return expands[0]
        chooses = [d for d in ds if isinstance(d, ChooseOp)]
        if chooses:
            grp = sorted(
                (d for d in chooses if d.op.name() == chooses[0].op.name()),
                key=lambda d: d.choice.name(),
            )
            if prefer is not None:
                want = prefer(grp[0].op.name(), [d.choice.name() for d in grp])
                pick = next((d for d in grp if d.choice.name() == want), None)
                if pick is not None:
                    return pick
            return grp[0]
        assigns = sorted(
            (d for d in ds if isinstance(d, AssignLane)), key=lambda d: d.op.name()
        )
        if assigns:
            opname = assigns[0].op.name()
            lane = platform.lanes[lane_rr[0] % len(platform.lanes)]
            lane_rr[0] += 1
            return next(
                (d for d in assigns if d.op.name() == opname and d.lane == lane),
                assigns[0],
            )
        execs = [d for d in ds if isinstance(d, ExecuteOp)]
        real = sorted(
            (d for d in execs if not isinstance(d.op, SyncOp)),
            key=lambda d: (phase(d.op), d.op.name()),
        )
        syncs = sorted(
            (d for d in execs if isinstance(d.op, SyncOp)), key=lambda d: d.op.desc()
        )
        done = {op.name() for op in st.sequence}
        pending_min = min(
            (phase(v) for v in st.graph.vertices() if v.name() not in done),
            default=99,
        )
        if real and (not syncs or phase(real[0].op) <= pending_min):
            return real[0]
        return syncs[0]

    return policy


def drive(graph: Graph, platform, policy) -> Tuple[Sequence, List[Decision]]:
    """Run ``policy`` to a terminal state, recording the decision list."""
    st = State(graph)
    decisions: List[Decision] = []
    while not st.is_terminal():
        ds = st.get_decisions(platform)
        d = policy(st, ds)
        decisions.append(d)
        st = st.apply(d)
    return st.sequence, decisions

