"""Explain / diff: attribute a winner-vs-naive speedup to schedule decisions.

Counterpart of ``tenzing_tpu/obs/attrib/explain.py``.

The paired verdict says the winner is N× faster; this module says *why*, by
diffing the two schedules (and, when available, their analyzed timelines)
along the axes the search actually decides:

* **lane placement** — which ops moved off the naive single lane, how many
  lanes the winner spreads over;
* **reordering** — inversions between the two orders over the ops they
  share (normalized Kendall-style), plus the biggest movers;
* **sync removal** — sync ops per kind present in naive but pruned (or
  added) in the winner;
* **menu choices** — ops whose chosen alternative differs (the
  ``base.suffix`` naming convention of ChoiceOp alternatives), and ops
  that exist on only one side (structural restructure, e.g. a transfer
  compound expanding differently);
* **timing decomposition** — the exact three-term split of the measured
  delta:  ``naive_measured − winner_measured =
  (naive_measured − naive_sum_parts) + (naive_sum_parts −
  winner_sum_parts) + (winner_sum_parts − winner_measured)`` — i.e. what
  the naive program already hid, what cheaper parts (kernel/engine menu
  picks) bought, and what overlap + dispatch removal bought.

The structural half works on bare schedules (no device, no timing) — the
recorded-corpus golden tests drive it that way; ``explain`` adds the
timing terms when both sides carry an :class:`Attribution`.

Perfetto: :func:`timeline_trace_events` renders an analyzed timeline as
per-lane tracks (one named thread row per lane + one for the host chain)
through the chrome-trace path (``obs/export.py`` —
``write_chrome_trace(..., extra_events=...)``), so attribution Gantts and
the search's spans land in one grouped trace.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from tenzing_tpu_torch.obs.attrib.analysis import Attribution, lane_label

# tid block for synthetic per-lane tracks in the chrome trace: far above any
# real dense thread index, stable across runs; the host-chain track of a
# block sits at ``tid_base - 1``
LANE_TID_BASE = 1000


def _sync_counts(ops) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for op in ops:
        if getattr(op, "is_sync", lambda: False)():
            k = getattr(op, "KIND", "sync")
            out[k] = out.get(k, 0) + 1
    return out


def _lane_map(ops) -> Dict[str, Optional[int]]:
    """op name -> lane id (None = host) for the non-sync ops."""
    from tenzing_tpu_torch.core.operation import BoundDeviceOp

    out: Dict[str, Optional[int]] = {}
    for op in ops:
        if getattr(op, "is_sync", lambda: False)():
            continue
        out[op.name()] = op.lane().id if isinstance(op, BoundDeviceOp) else None
    return out


def _menu_base(name: str) -> str:
    """'unpack_x.pallas' -> 'unpack_x'; names without a menu suffix map to
    themselves (the ChoiceOp alternative naming convention)."""
    return name.rsplit(".", 1)[0] if "." in name else name


def diff_schedules(naive_ops, winner_ops) -> Dict[str, Any]:
    """Structure-only decision diff (no timing needed — see module doc)."""
    naive_ops, winner_ops = list(naive_ops), list(winner_ops)
    n_lanes = _lane_map(naive_ops)
    w_lanes = _lane_map(winner_ops)

    # lane placement
    n_used = sorted({l for l in n_lanes.values() if l is not None})
    w_used = sorted({l for l in w_lanes.values() if l is not None})
    moved = sorted(name for name in set(n_lanes) & set(w_lanes)
                   if n_lanes[name] != w_lanes[name])

    # reordering over shared names
    shared = [n for n in n_lanes if n in w_lanes]
    n_pos = {n: i for i, n in enumerate(
        op.name() for op in naive_ops
        if not getattr(op, "is_sync", lambda: False)())}
    w_pos = {n: i for i, n in enumerate(
        op.name() for op in winner_ops
        if not getattr(op, "is_sync", lambda: False)())}
    inversions = 0
    for i, a in enumerate(shared):
        for b in shared[i + 1:]:
            if (n_pos[a] - n_pos[b]) * (w_pos[a] - w_pos[b]) < 0:
                inversions += 1
    pairs = len(shared) * (len(shared) - 1) // 2
    movers = sorted(shared, key=lambda n: -abs(n_pos[n] - w_pos[n]))[:8]
    movers = [n for n in movers if n_pos[n] != w_pos[n]]

    # sync vocabulary
    ns, ws = _sync_counts(naive_ops), _sync_counts(winner_ops)
    removed = {k: ns.get(k, 0) - ws.get(k, 0)
               for k in set(ns) | set(ws)
               if ns.get(k, 0) != ws.get(k, 0)}

    # menu choices: same base, different chosen suffix
    n_by_base = {_menu_base(n): n for n in n_lanes}
    w_by_base = {_menu_base(n): n for n in w_lanes}
    changed = {b: {"naive": n_by_base[b], "winner": w_by_base[b]}
               for b in sorted(set(n_by_base) & set(w_by_base))
               if n_by_base[b] != w_by_base[b]}
    only_naive = sorted(b for b in n_by_base if b not in w_by_base)
    only_winner = sorted(b for b in w_by_base if b not in n_by_base)

    return {
        "lanes": {
            "naive_lanes": n_used,
            "winner_lanes": w_used,
            "ops_moved": moved,
            "n_ops_moved": len(moved),
        },
        "reorder": {
            "shared_ops": len(shared),
            "inversions": inversions,
            "normalized": round(inversions / pairs, 4) if pairs else 0.0,
            "top_movers": movers,
        },
        "sync": {
            "naive": ns,
            "winner": ws,
            "delta": removed,  # positive = removed by the winner
        },
        "menu": {
            "changed_choices": changed,
            "only_in_naive": only_naive,
            "only_in_winner": only_winner,
        },
    }


def explain(naive_ops, winner_ops,
            naive_attrib: Optional[Attribution] = None,
            winner_attrib: Optional[Attribution] = None) -> Dict[str, Any]:
    """The full explain document: the structural decision diff plus (when
    both analyses are given) the three-term timing decomposition."""
    doc: Dict[str, Any] = {"decisions": diff_schedules(naive_ops, winner_ops)}
    if naive_attrib is not None and winner_attrib is not None and \
            naive_attrib.measured_us and winner_attrib.measured_us:
        nm, wm = naive_attrib.measured_us, winner_attrib.measured_us
        ns, wsum = naive_attrib.sum_of_parts_us, winner_attrib.sum_of_parts_us
        doc["timing"] = {
            "naive_measured_us": round(nm, 3),
            "winner_measured_us": round(wm, 3),
            "speedup": round(nm / wm, 4) if wm > 0 else None,
            # exact decomposition: the three terms sum to naive - winner
            "delta_us": round(nm - wm, 3),
            "naive_hidden_us": round(nm - ns, 3),
            "faster_parts_us": round(ns - wsum, 3),
            "winner_hidden_us": round(wsum - wm, 3),
            "naive_overlap_efficiency": naive_attrib.overlap_efficiency,
            "winner_overlap_efficiency": winner_attrib.overlap_efficiency,
            "naive_critical_path_us": round(naive_attrib.critical_path_us, 3),
            "winner_critical_path_us": round(winner_attrib.critical_path_us, 3),
            "dispatch_overhead_us": round(
                winner_attrib.dispatch_overhead_us, 3),
        }
    return doc


def write_explain(path: str, doc: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)


def timeline_trace_events(attrib: Attribution, pid: int = 0,
                          t0_us: float = 0.0, label: str = "attrib",
                          tid_base: int = LANE_TID_BASE,
                          ) -> List[Dict[str, Any]]:
    """Chrome trace-event dicts rendering an analyzed timeline as per-lane
    tracks: complete events (``ph: "X"``) on one synthetic tid per lane
    (+ one for the host chain, at ``tid_base - 1``), each track named
    ``<label>/lane N`` via ``thread_name`` metadata.  Feed to
    ``obs.export.write_chrome_trace(..., extra_events=...)`` — the search's
    spans and these Gantt tracks then render as one grouped trace per
    rank.  Give each timeline its own ``tid_base`` block (winner vs naive)
    so their lane tracks don't collide."""
    events: List[Dict[str, Any]] = []
    tids: Dict[int, str] = {}
    host_tid = tid_base - 1
    for rec in attrib.timeline.records:
        if rec.dur_us <= 0:
            continue
        tid = host_tid if rec.lane is None else tid_base + rec.lane
        tids[tid] = f"{label}/{lane_label(rec.lane)}"
        events.append({
            "name": rec.name,
            "cat": "attrib",
            "ph": "X",
            "ts": t0_us + rec.start_us,
            "dur": rec.dur_us,
            "pid": pid,
            "tid": tid,
            "args": {"kind": rec.kind, "positions": list(rec.positions),
                     "schedule": attrib.timeline.schedule},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": nm}} for tid, nm in sorted(tids.items())]
    return meta + events
