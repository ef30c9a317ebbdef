"""Timeline analysis: Gantt reconstruction, critical path, overlap
efficiency, dispatch overhead, roofline join.

Counterpart of ``tenzing_tpu/obs/attrib/analysis.py``.  Turns an
:class:`~tenzing_tpu_torch.obs.attrib.timeline.OpTimeline` (per-unit
durations, starts unassigned) and the schedule's op list into the numbers
the driver writes as its ``attrib`` block:

* **Gantt** — each unit starts at the latest end of its happens-before
  predecessors.  The relation is the verifier's
  (:func:`tenzing_tpu_torch.verify.soundness.happens_before_masks`: lane
  program order, host dispatch, the five sync ops), so a start respects
  lane order, host dispatch and every sync edge.  Scheduled as soon as
  possible under that relation, the makespan is the **critical path**.
* **overlap efficiency** = ``min(1, critical_path / measured)``: the share
  of the ordering's ideal makespan the whole schedule achieved.
* **dispatch overhead** = ``max(0, sum_of_parts - measured)``: each stepped
  unit pays a dispatch and a wait where the whole schedule pays them once
  and overlaps the rest; for the one-lane naive order the overlap term is
  about zero, so its number is the workload's dispatch overhead.
* **roofline join** — a workload :class:`~tenzing_tpu_torch.bench.roofline.Cost`
  gives the achieved fraction of the card's peaks at the measured time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tenzing_tpu_torch.obs.attrib.timeline import OpTimeline


@dataclass
class Attribution:
    """The analysis verdict for one schedule (see module docstring)."""

    timeline: OpTimeline  # starts filled in
    sum_of_parts_us: float = 0.0
    critical_path_us: float = 0.0
    critical_path: List[str] = field(default_factory=list)
    measured_us: Optional[float] = None
    dispatch_overhead_us: float = 0.0
    overlap_efficiency: Optional[float] = None
    per_lane_busy_us: Dict[str, float] = field(default_factory=dict)
    utilization: Optional[Dict[str, float]] = None
    per_op_utilization: Optional[Dict[str, Dict[str, float]]] = None

    def to_json(self, with_timeline: bool = True) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "schedule": self.timeline.schedule,
            "source": self.timeline.source,
            "n_ops": self.timeline.n_ops,
            "n_timed": len(self.timeline.timed()),
            "sum_of_parts_us": round(self.sum_of_parts_us, 3),
            "critical_path_us": round(self.critical_path_us, 3),
            "measured_us": (round(self.measured_us, 3)
                            if self.measured_us is not None else None),
            "dispatch_overhead_us": round(self.dispatch_overhead_us, 3),
            "overlap_efficiency": (round(self.overlap_efficiency, 4)
                                   if self.overlap_efficiency is not None
                                   else None),
            "critical_path": list(self.critical_path),
            "per_lane_busy_us": {k: round(v, 3)
                                 for k, v in self.per_lane_busy_us.items()},
        }
        if self.utilization is not None:
            out["utilization"] = self.utilization
        if self.per_op_utilization is not None:
            out["per_op_utilization"] = self.per_op_utilization
        if with_timeline:
            out["timeline"] = [r.to_json() for r in self.timeline.records]
        return out


def lane_label(lane: Optional[int]) -> str:
    return "host" if lane is None else f"lane {lane}"


def analyze(ops, timeline: OpTimeline, measured_us: Optional[float] = None,
            cost=None, per_op_costs: Optional[Dict[str, Any]] = None,
            ) -> Attribution:
    """Fill the timeline's starts from the happens-before relation and
    compute the attribution verdict.

    ``ops`` is the schedule's op list (``order.vector()`` — positions must
    match ``timeline.records[*].positions``); ``measured_us`` the
    whole-program measured iteration time (the driver's final pct50);
    ``cost`` an optional workload :class:`~tenzing_tpu_torch.bench.roofline.Cost`
    for the fraction-of-peak join; ``per_op_costs`` an optional
    ``unit name -> Cost`` map for per-unit utilization."""
    from tenzing_tpu_torch.verify.soundness import happens_before_masks

    ops = list(ops)
    reach = happens_before_masks(ops)
    units = timeline.records
    # one bitmask per unit: which positions it covers, and which positions
    # happen-before any of its members (the union over members keeps a
    # grouped post→await unit ordered after everything any member needs)
    unit_bits: List[int] = []
    unit_reach: List[int] = []
    for rec in units:
        bits = 0
        mask = 0
        for p in rec.positions:
            bits |= 1 << p
            mask |= reach[p]
        unit_bits.append(bits)
        unit_reach.append(mask)

    ends: List[float] = []
    preds: List[int] = []
    for k, rec in enumerate(units):
        start, pred = 0.0, -1
        for j in range(k):
            if unit_reach[k] & unit_bits[j] and ends[j] > start:
                start, pred = ends[j], j
        rec.start_us = start
        ends.append(start + rec.dur_us)
        preds.append(pred)

    sum_parts = sum(r.dur_us for r in units)
    makespan = max(ends, default=0.0)
    # critical path: walk the argmax-predecessor chain back from the unit
    # that finishes last; sync units (zero duration) are kept out of the
    # reported names but still route the walk
    path: List[str] = []
    k = max(range(len(units)), key=lambda i: ends[i], default=None) \
        if units else None
    while k is not None and k >= 0:
        if units[k].dur_us > 0.0:
            path.append(units[k].name)
        k = preds[k]
    path.reverse()

    dispatch = 0.0
    efficiency: Optional[float] = None
    if measured_us is not None and measured_us > 0:
        dispatch = max(0.0, sum_parts - measured_us)
        efficiency = min(1.0, makespan / measured_us) if makespan > 0 else 1.0

    per_lane: Dict[str, float] = {}
    for rec in units:
        if rec.dur_us > 0:
            lbl = lane_label(rec.lane)
            per_lane[lbl] = per_lane.get(lbl, 0.0) + rec.dur_us

    util = None
    if cost is not None:
        secs = (measured_us if measured_us is not None else makespan) * 1e-6
        if secs > 0:
            util = {k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in cost.utilization(secs).items()}
    per_op_util = None
    if per_op_costs:
        per_op_util = {}
        for rec in units:
            c = per_op_costs.get(rec.name)
            if c is not None and rec.dur_us > 0:
                per_op_util[rec.name] = {
                    k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in c.utilization(rec.dur_us * 1e-6).items()}

    return Attribution(
        timeline=timeline,
        sum_of_parts_us=sum_parts,
        critical_path_us=makespan,
        critical_path=path,
        measured_us=measured_us,
        dispatch_overhead_us=dispatch,
        overlap_efficiency=efficiency,
        per_lane_busy_us=per_lane,
        utilization=util,
        per_op_utilization=per_op_util,
    )
