"""Per-op timelines: the attribution profiler's measurement substrate.

Counterpart of ``tenzing_tpu/obs/attrib/timeline.py``.  An
:class:`OpTimeline` holds one (op, lane, start, duration) record per timed
unit of a schedule, produced by the **timed execution mode**
(:func:`stepped_timeline` over ``StreamExecutor.op_stepped``): each unit
runs alone, on an idle device, against the buffer state the previous units
left.

How a unit is timed (``OpRecord.timer``):

* ``"event"`` — a unit of one device op, on the card: the median of
  ``repeats`` CUDA-event pairs recorded on the op's lane stream around its
  dispatch.  The stream is idle when the first event is recorded, so the
  pair brackets the op's host dispatch as well as its kernels; an empty
  kernel reads about 5 µs this way on an H100.
* ``"host"`` — every other unit (transfer posts, awaits, the host ops, a
  grouped ``.rdma`` post and its await), and every unit on the CPU: the
  median host wall time of the unit followed by a device synchronize, less
  the benchmarker's fence overhead (:func:`fetch_overhead_us`).

What the durations mean: the units are serial, so the durations are
overlap-free parts.  The starts are not measured: the analysis
(analysis.py) rebuilds them from the happens-before relation.  Each unit
pays its own dispatch and wait, so the stepped sum over-counts what the ops
cost inside the whole schedule; the gap to the measured iteration is the
dispatch overhead.  Sync ops are zero-duration records.

The profiler capture (xplane.py) attributes by kernel name instead, on any
platform.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer

# floor (µs) for a unit the overhead subtraction pushed to <= 0: keeps every
# ratio downstream defined without inventing measurable time
MIN_DUR_US = 1e-3


@dataclass
class OpRecord:
    """One timed unit of a schedule: a single op, or a split ``.rdma``
    post with everything through its await (``positions`` then spans every
    member).  ``timer`` says how it was timed (module docstring); None for
    a sync record or a synthetic one."""

    name: str
    desc: str
    kind: str  # "device" | "host" | "sync"
    lane: Optional[int]  # lane id for device ops, None = host chain
    positions: Tuple[int, ...]
    dur_us: float = 0.0
    start_us: float = 0.0  # rebuilt by analysis.py, 0 until assigned
    timer: Optional[str] = None

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us

    def to_json(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "desc": self.desc,
            "kind": self.kind,
            "lane": self.lane,
            "positions": list(self.positions),
            "start_us": round(self.start_us, 4),
            "dur_us": round(self.dur_us, 4),
        }
        if self.timer is not None:
            out["timer"] = self.timer
        return out

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "OpRecord":
        return cls(name=j["name"], desc=j.get("desc", j["name"]),
                   kind=j["kind"], lane=j.get("lane"),
                   positions=tuple(j["positions"]),
                   dur_us=float(j.get("dur_us", 0.0)),
                   start_us=float(j.get("start_us", 0.0)),
                   timer=j.get("timer"))


@dataclass
class OpTimeline:
    """The (op, lane, start, duration) record set for one schedule."""

    records: List[OpRecord] = field(default_factory=list)
    schedule: str = ""  # bench/benchmarker.py schedule_id
    source: str = "stepped"  # "stepped" | "synthetic"
    n_ops: int = 0
    repeats: int = 0
    fetch_overhead_us: float = 0.0

    def timed(self) -> List[OpRecord]:
        """The non-sync records (the units that carry measured time)."""
        return [r for r in self.records if r.kind != "sync"]

    def timers(self) -> Dict[str, int]:
        """How many units each timer timed (``OpRecord.timer``)."""
        return {t: sum(1 for r in self.records if r.timer == t)
                for t in ("event", "host")}

    def to_json(self) -> Dict[str, Any]:
        return {
            "schedule": self.schedule,
            "source": self.source,
            "n_ops": self.n_ops,
            "repeats": self.repeats,
            "fetch_overhead_us": round(self.fetch_overhead_us, 4),
            "records": [r.to_json() for r in self.records],
        }

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "OpTimeline":
        return cls(records=[OpRecord.from_json(r) for r in j["records"]],
                   schedule=j.get("schedule", ""),
                   source=j.get("source", "stepped"),
                   n_ops=int(j.get("n_ops", 0)),
                   repeats=int(j.get("repeats", 0)),
                   fetch_overhead_us=float(j.get("fetch_overhead_us", 0.0)))


def _record_meta(ops, positions) -> Tuple[str, str, str, Optional[int]]:
    """(name, desc, kind, lane) of the unit covering ``positions``."""
    from tenzing_tpu_torch.core.operation import BoundDeviceOp

    members = [ops[p] for p in positions]
    non_sync = [o for o in members
                if not getattr(o, "is_sync", lambda: False)()]
    if not non_sync:
        op = members[0]
        lanes = op.lanes() if hasattr(op, "lanes") else []
        return op.desc(), op.desc(), "sync", (lanes[0].id if lanes else None)
    name = "+".join(o.name() for o in non_sync)
    desc = non_sync[0].desc() if len(non_sync) == 1 else name
    dev = next((o for o in non_sync if isinstance(o, BoundDeviceOp)), None)
    if dev is not None:
        return name, desc, "device", dev.lane().id
    return name, desc, "host", None


def fetch_overhead_us(device) -> float:
    """The benchmarker's fence overhead on ``device`` in µs
    (bench/benchmarker.py ``fence_overhead_s``: one trivial launch and a
    synchronize), so the profiler needs no benchmarker."""
    from tenzing_tpu_torch.bench.benchmarker import fence_overhead_s

    return fence_overhead_s(device) * 1e6


def stepped_timeline(executor, order, repeats: int = 7) -> OpTimeline:
    """Time every unit of ``order`` through the executor's stepped mode
    (``StreamExecutor.op_stepped``) and return the :class:`OpTimeline`,
    starts unassigned (run analysis.py over it).  Each unit is warmed once
    (excluded) and timed ``repeats`` times from the same state; its duration
    is the median, less the fence overhead where the host timed it, floored
    at ``MIN_DUR_US``.  ``attrib.profile`` and ``attrib.step`` spans and the
    ``attrib.profiles`` / ``attrib.steps`` counters record the work."""
    from tenzing_tpu_torch.bench.benchmarker import schedule_id

    tr = get_tracer()
    sid = schedule_id(order)
    with tr.span("attrib.profile", schedule=sid, repeats=repeats) as sp:
        steps = executor.op_stepped(order)
        ops = order.vector()
        overhead_us = fetch_overhead_us(executor.device)
        records: List[OpRecord] = []
        n_timed = 0
        for positions, fn in steps:
            name, desc, kind, lane = _record_meta(ops, positions)
            if fn is None:
                records.append(OpRecord(name=name, desc=desc, kind=kind,
                                        lane=lane, positions=positions))
                continue
            with tr.span("attrib.step", unit=name) as st:
                times, timer = fn(max(1, repeats))
                times.sort()
                med = times[len(times) // 2]
                dur_us = max(med - (overhead_us if timer == "host" else 0.0),
                             MIN_DUR_US)
                st.set("timer", timer)
                st.set("dur_us", dur_us)
            records.append(OpRecord(name=name, desc=desc, kind=kind,
                                    lane=lane, positions=positions,
                                    dur_us=dur_us, timer=timer))
            n_timed += 1
        sp.set("n_timed", n_timed)
        get_metrics().counter("attrib.profiles").inc()
        get_metrics().counter("attrib.steps").inc(n_timed)
    return OpTimeline(records=records, schedule=sid, source="stepped",
                      n_ops=len(ops), repeats=repeats,
                      fetch_overhead_us=overhead_us)
