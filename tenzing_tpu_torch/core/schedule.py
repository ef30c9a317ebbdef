"""Complete schedules and the redundant-sync peephole cleanup.

Counterpart of ``tenzing_tpu/core/schedule.py`` (reference
``include/tenzing/schedule.hpp`` / ``src/schedule.cpp``).
``remove_redundant_syncs`` is a fixed-point pass deleting (schedule.cpp:19-321):

1. EventRecords whose event is never consumed (schedule.cpp:68-94)
2. WaitEvents with no subsequent device op in the waiting lane (96-117)
3. duplicate same-lane LaneSyncs with no device op between (119-164)
4. duplicate EventRecords at the same lane point — consumers rewritten to the
   surviving event (171-235)
5. sync pairs made redundant by a later-recorded-but-earlier-waited event on the
   same lane (247-306)

A lane's "token" below is its stream's progress.

Also the whole-space enumerators ``make_schedules`` (every topological
order, schedule.cpp:327-390) and ``make_schedules_random`` (schedule.cpp:
395-529), the latter with an explicit seeded PRNG where the reference drew
from an unseeded ``rand()``.
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Optional, Tuple

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import BoundDeviceOp, OpBase
from tenzing_tpu_torch.core.resources import Event, Lane
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.sync_ops import (
    EventRecord,
    EventSync,
    LaneSync,
    LaneWait,
    WaitEvent,
)


def _event_consumers(order: List[OpBase], event: Event) -> List[int]:
    out = []
    for i, op in enumerate(order):
        if isinstance(op, WaitEvent) and op.event() == event:
            out.append(i)
        elif isinstance(op, EventSync) and op.event() == event:
            out.append(i)
    return out


def _lane_advances_between(order: List[OpBase], lane: Lane, lo: int, hi: int) -> bool:
    """True if the lane's token moves strictly between positions lo and hi: a
    device op runs on it, or a WaitEvent/LaneWait joins foreign work into it.
    Two EventRecords with no advance between capture the same progress."""
    for i in range(lo + 1, hi):
        op = order[i]
        if isinstance(op, BoundDeviceOp) and op.lane() == lane:
            return True
        if isinstance(op, WaitEvent) and op.lane() == lane:
            return True
        if isinstance(op, LaneWait) and op.waiter() == lane:
            return True
    return False


def _lane_token_consumed_after(order: List[OpBase], lane: Lane, pos: int) -> bool:
    """True if anything after ``pos`` observes the lane's token: a device op runs
    on the lane, an EventRecord snapshots it (transitive sync chains), or a
    LaneSync/LaneWait reads it."""
    for i in range(pos + 1, len(order)):
        op = order[i]
        if isinstance(op, BoundDeviceOp) and op.lane() == lane:
            return True
        if isinstance(op, EventRecord) and op.lane() == lane:
            return True
        if isinstance(op, LaneSync) and op.lane() == lane:
            return True
        if isinstance(op, LaneWait) and op.waitee() == lane:
            return True
    return False


def _rule_unconsumed_records(order: List[OpBase]) -> Optional[List[OpBase]]:
    """Rule 1 (schedule.cpp:68-94)."""
    for i, op in enumerate(order):
        if isinstance(op, EventRecord) and not _event_consumers(order, op.event()):
            return order[:i] + order[i + 1 :]
    return None


def _rule_wait_without_later_device(order: List[OpBase]) -> Optional[List[OpBase]]:
    """Rule 2 (schedule.cpp:96-117): a WaitEvent only matters if the waiting
    lane's token is observed afterwards (device op, record, or host sync on it)."""
    for i, op in enumerate(order):
        if isinstance(op, WaitEvent):
            if not _lane_token_consumed_after(order, op.lane(), i):
                return order[:i] + order[i + 1 :]
    return None


def _rule_duplicate_lane_syncs(order: List[OpBase]) -> Optional[List[OpBase]]:
    """Rule 3 (schedule.cpp:119-164): two LaneSyncs on one lane with no device op
    between — the later one is free."""
    for i, a in enumerate(order):
        if not isinstance(a, LaneSync):
            continue
        for j in range(i + 1, len(order)):
            b = order[j]
            if isinstance(b, LaneSync) and b.lane() == a.lane():
                if not _lane_advances_between(order, a.lane(), i, j):
                    return order[:j] + order[j + 1 :]
    return None


def _rule_duplicate_records(order: List[OpBase]) -> Optional[List[OpBase]]:
    """Rule 4 (schedule.cpp:171-235): two EventRecords at the same lane point
    record the same progress; rewrite consumers of the later event and drop it."""
    for i, a in enumerate(order):
        if not isinstance(a, EventRecord):
            continue
        for j in range(i + 1, len(order)):
            b = order[j]
            if isinstance(b, EventRecord) and b.lane() == a.lane():
                if _lane_advances_between(order, a.lane(), i, j):
                    break  # different lane point; later records are distinct
                out = order[:j] + order[j + 1 :]
                rewritten: List[OpBase] = []
                for op in out:
                    if isinstance(op, WaitEvent) and op.event() == b.event():
                        rewritten.append(WaitEvent(op.lane(), a.event()))
                    elif isinstance(op, EventSync) and op.event() == b.event():
                        rewritten.append(EventSync(a.event()))
                    else:
                        rewritten.append(op)
                return rewritten
    return None


def _rule_covered_pairs(order: List[OpBase]) -> Optional[List[OpBase]]:
    """Rule 5 (schedule.cpp:247-306): if event e2 is recorded at a later-or-equal
    point of the same lane than e1 but waited earlier by the same consumer chain,
    e1's wait adds nothing — drop e1's record+wait pair."""
    recs: Dict[Event, Tuple[int, Lane]] = {}
    for i, op in enumerate(order):
        if isinstance(op, EventRecord):
            recs[op.event()] = (i, op.lane())
    for e1, (p1, l1) in recs.items():
        cons1 = _event_consumers(order, e1)
        if not cons1:
            continue
        for e2, (p2, l2) in recs.items():
            # e2 recorded at a later-or-equal point of the same lane covers at
            # least all of e1's work
            if e1 == e2 or l1 != l2 or p2 < p1:
                continue
            cons2 = _event_consumers(order, e2)
            for c1 in cons1:
                o1 = order[c1]
                for c2 in cons2:
                    # e2's wait must itself be effective: after e2's record and
                    # at-or-before e1's wait
                    if c2 > c1 or c2 < p2:
                        continue
                    o2 = order[c2]
                    same_scope = (
                        isinstance(o1, WaitEvent)
                        and isinstance(o2, WaitEvent)
                        and o1.lane() == o2.lane()
                    ) or (isinstance(o1, EventSync) and isinstance(o2, EventSync))
                    if same_scope:
                        out = [
                            op
                            for k, op in enumerate(order)
                            if k != c1 and not (k == p1 and len(cons1) == 1)
                        ]
                        return out
    return None


def _rule_duplicate_consumers(order: List[OpBase]) -> Optional[List[OpBase]]:
    """Waiting twice on the same event in the same scope adds nothing — drop the
    later duplicate (arises when rule 4 rewrites consumers onto one event)."""
    seen: List[Tuple] = []
    for i, op in enumerate(order):
        if isinstance(op, WaitEvent):
            key = ("wait", op.lane(), op.event())
        elif isinstance(op, EventSync):
            key = ("sync", op.event())
        else:
            continue
        if key in seen:
            return order[:i] + order[i + 1 :]
        seen.append(key)
    return None


_RULES = (
    _rule_unconsumed_records,
    _rule_wait_without_later_device,
    _rule_duplicate_lane_syncs,
    _rule_duplicate_records,
    _rule_covered_pairs,
    _rule_duplicate_consumers,
)


def remove_redundant_syncs(order: Sequence) -> Sequence:
    """Fixed-point application of the five peephole rules (reference
    Schedule::remove_redundant_syncs, schedule.cpp:19-321)."""
    ops = order.vector()
    changed = True
    while changed:
        changed = False
        for rule in _RULES:
            out = rule(ops)
            if out is not None:
                ops = out
                changed = True
                break
    return Sequence(ops)


# -- whole-space enumerators (reference schedule.cpp:327-529) --------------------


def make_schedules(g: Graph, max_schedules: Optional[int] = None) -> List[Sequence]:
    """Every topological order of ``g`` (reference make_schedules,
    schedule.cpp:327-390), depth first.  No lane assignment or sync
    insertion: the raw order space."""
    out: List[Sequence] = []
    partials: List[List[OpBase]] = [[g.start()]]
    while partials:
        cur = partials.pop()
        frontier = g.frontier(cur)
        if not frontier:
            out.append(Sequence(cur))
            if max_schedules is not None and len(out) >= max_schedules:
                return out
            continue
        for op in frontier:
            partials.append(cur + [op])
    return out


def make_schedules_random(
    g: Graph, n: int, seed: int = 0
) -> List[Sequence]:
    """``n`` random topological orders, each step a uniform draw from the
    frontier through a PRNG seeded with ``seed`` (reference
    make_schedules_random, schedule.cpp:395-529)."""
    rng = _random.Random(seed)
    out: List[Sequence] = []
    for _ in range(n):
        cur: List[OpBase] = [g.start()]
        while True:
            frontier = g.frontier(cur)
            if not frontier:
                break
            cur.append(frontier[rng.randrange(len(frontier))])
        out.append(Sequence(cur))
    return out
