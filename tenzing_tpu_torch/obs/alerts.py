"""SLO burn-rate alerting over the serving plane's telemetry documents:
``python -m tenzing_tpu_torch.obs.alerts check``.

Counterpart of ``tenzing_tpu/obs/alerts.py``, the same rule catalog,
ledger document and exit codes: a tree either package wrote gives the same
firing set in both.  A rule set is evaluated over the documents every
long-lived process publishes (``status-*.json``, ``metrics-*.json``, the
work queue's lease and poison files), a firing/resolved state machine is
kept in an atomic ``alerts-<owner>.json`` document, and the exit code is
one a CI job can gate on.

**Rules** (:data:`DEFAULT_RULES`; thresholds are overridden by a JSON file
or ``--set rule.param=value``):

* ``slo_burn`` — multi-window burn rate on the exact tier's pct99: the
  latest snapshot's SLO block gives the fast window (``pct99 / target``,
  or against the baseline when no target is set), the whole snapshot ring
  the slow one (the median burn across it).  Fires only when both exceed
  their thresholds: one noisy snapshot cannot page, and a real regression
  cannot hide behind one good heartbeat.
* ``shed_rate`` — the ``serve.shed_rate`` gauge (sheds a second over the
  last heartbeat window) above ``max_per_s``.
* ``queue_age`` — work items older than ``max_s`` (the drain daemons are
  not keeping up), and the listen loop's ``serve.queue_age_s`` gauge above
  ``max_wait_s`` (requests are aging in the bounded queue).
* ``stale_heartbeat`` — a status document whose ``heartbeat_at`` is older
  than ``max_age_s`` while its state is not ``stopped``: the process died
  without saying so (what a SIGKILLed loop or daemon leaves).
* ``poison`` — ``poison-*.json`` in a work queue: a request that kills its
  drain every time was quarantined, and someone should look at it.
* ``tracer_drops`` — a snapshot whose tracer block shows dropped spans or
  events: telemetry is being lost.
* ``tenant_shed`` — per-tenant fairness (``serve.shed.<tenant>`` /
  ``serve.timeout.<tenant>``): one tenant's sheds or timeouts grew across
  the snapshot ring beyond ``max_shed`` / ``max_timeout``.
* ``queue_backlog_burn`` — the arrival rate (request-log positions across
  the snapshot ring) against the daemons' measured drain rate (each item's
  wall clock from the daemons' status histories): when cold work arrives
  faster than it drains, the queue grows without bound, and the alert
  says how many daemons would balance it (:func:`backlog_summary`, also
  rendered by ``report --follow``).
* ``supervisor_crash_loop`` — a supervisor's status block names a member
  whose breaker is open: it crash-looped past its restart budget.
* ``store_unwritable`` — a store latched read-only (ENOSPC, EDQUOT,
  EROFS) rides a status or snapshot document.
* ``store_damage_rate`` — the store's checksum-skip and quarantine
  counters grew across the snapshot ring.

**State machine** (:class:`AlertBook`): alerts key on ``rule:subject``.  A
newly seen alert goes to ``firing`` (one transition, timestamped); seen
again while firing, it only refreshes ``last_seen_at`` and ``value``.  An
alert absent from an evaluation resolves only after ``resolve_hold_secs``
of continuous absence, so a rule oscillating around its threshold yields
one firing window.  Resolved entries are kept (bounded), so a re-fire is
visibly one (``count`` grows, the transition list grows).

**Exit codes**: 0 nothing firing, 1 at least one alert firing, 2 an
unreadable tree or a usage error.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from tenzing_tpu_torch.obs.metrics import snapshot_history
from tenzing_tpu_torch.utils.atomic import atomic_dump_json

ALERT_DOC_VERSION = 1
TRANSITIONS_CAP = 20        # per-alert transition history kept
ENTRIES_CAP = 200           # resolved entries retained in the doc

DEFAULT_RULES: Dict[str, Dict[str, Any]] = {
    "slo_burn": {"enabled": True, "severity": "page",
                 "fast_burn": 2.0, "slow_burn": 1.5, "min_window": 3},
    "shed_rate": {"enabled": True, "severity": "page", "max_per_s": 1.0},
    "queue_age": {"enabled": True, "severity": "ticket",
                  "max_s": 600.0, "max_wait_s": 30.0},
    "stale_heartbeat": {"enabled": True, "severity": "page",
                        "max_age_s": 60.0},
    "poison": {"enabled": True, "severity": "ticket"},
    "tracer_drops": {"enabled": True, "severity": "ticket",
                     "max_dropped": 0},
    # 0 = any per-tenant shed/timeout growth across the ring fires; a
    # busy fleet raises these to its tolerated per-tenant budget
    "tenant_shed": {"enabled": True, "severity": "ticket",
                    "max_shed": 0, "max_timeout": 0},
    # arrival must exceed drain by this factor (and by a non-trivial
    # absolute rate) with work actually queued before paging — a
    # momentarily idle fleet with an empty queue is not a backlog
    # max_daemons clamps the recommendation (and the supervisor's
    # scale-up bound): null = ~os.cpu_count(), 0 = unclamped
    "queue_backlog_burn": {"enabled": True, "severity": "page",
                           "burn_ratio": 1.2,
                           "min_arrival_per_s": 0.1,
                           "max_daemons": None},
    # fired from the supervisor's status-doc breaker block: a member
    # slot crash-looped past its restart budget and sits quarantined
    "supervisor_crash_loop": {"enabled": True, "severity": "page"},
    # the serve plane latched a store read-only (ENOSPC/EDQUOT/EROFS):
    # exact answers continue, near/cold tiers shed, the daemon pauses
    # claims.  Fires while the latch doc rides the status/snapshot
    # docs; resolves (via the ledger's hold) once a probe write lands
    # and the latch clears
    "store_unwritable": {"enabled": True, "severity": "page"},
    # segment damage economics: checksum-skip / quarantine counters
    # growing across the snapshot ring (0 = any growth fires) — the
    # store is taking damage faster than anyone runs fsck
    "store_damage_rate": {"enabled": True, "severity": "ticket",
                          "max_damage": 0},
}


class AlertTreeError(ValueError):
    """The fleet tree cannot be read (missing directory, unreadable
    rules file) — a *usage* error (exit 2), never a firing alert."""


@dataclass
class Alert:
    """One active condition from one evaluation pass."""

    rule: str
    subject: str            # which owner/queue/item the rule fired on
    severity: str
    value: Any              # the observed number the rule tripped on
    threshold: Any
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.subject}"

    def to_json(self) -> Dict[str, Any]:
        return {"rule": self.rule, "subject": self.subject,
                "severity": self.severity, "value": self.value,
                "threshold": self.threshold, "message": self.message}


def load_rules(path: Optional[str] = None,
               sets: Optional[List[str]] = None) -> Dict[str, Dict[str, Any]]:
    """The effective rule set: :data:`DEFAULT_RULES`, deep-merged with
    an optional JSON file (``{"rule": {"param": value}}``), then with
    ``--set rule.param=value`` overrides.  Unknown rules/params are a
    loud :class:`AlertTreeError` — a typo'd threshold must not silently
    evaluate the default."""
    rules = copy.deepcopy(DEFAULT_RULES)
    if path is not None:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise AlertTreeError(f"rules file {path}: {e}") from e
        if not isinstance(doc, dict):
            raise AlertTreeError(f"rules file {path}: not an object")
        for name, params in doc.items():
            if name not in rules:
                raise AlertTreeError(f"unknown rule {name!r} "
                                     f"(catalog: {sorted(rules)})")
            if not isinstance(params, dict):
                raise AlertTreeError(f"rule {name!r}: params not an object")
            for param in params:
                # same contract as --set: a typo'd param name must not
                # silently leave the real threshold at its default
                if param not in rules[name]:
                    raise AlertTreeError(
                        f"rule {name!r} has no param {param!r} "
                        f"(has {sorted(rules[name])})")
            rules[name].update(params)
    for spec in sets or []:
        name_param, _, raw = spec.partition("=")
        name, _, param = name_param.partition(".")
        if name not in rules or not param or not raw:
            raise AlertTreeError(
                f"--set {spec!r}: expected rule.param=value with rule in "
                f"{sorted(rules)}")
        if param not in rules[name]:
            raise AlertTreeError(
                f"--set {spec!r}: rule {name!r} has no param {param!r} "
                f"(has {sorted(rules[name])})")
        try:
            value: Any = json.loads(raw)
        except ValueError:
            value = raw
        rules[name][param] = value
    return rules


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def burn_of(slo: Dict[str, Any]) -> Optional[float]:
    """One snapshot's SLO burn: pct99 over the operator's target (or
    over the committed baseline when no target is set) — >1 means the
    latency objective is being burned, <=1 means healthy."""
    if not isinstance(slo, dict):
        return None
    pct99 = slo.get("pct99_us")
    denom = slo.get("target_us") or slo.get("baseline_pct99_us")
    if pct99 is None or not denom:
        return None
    return float(pct99) / float(denom)


def _status_docs(directory: str) -> List[Dict[str, Any]]:
    out = []
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("status-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict):
            doc["_file"] = name
            out.append(doc)
    return out


def evaluate(store_dirs: List[str], queue_dirs: List[str],
             rules: Optional[Dict[str, Dict[str, Any]]] = None,
             now: Optional[float] = None) -> List[Alert]:
    """One evaluation pass over the fleet tree (module docstring).
    Strictly read-only.  A named directory that does not exist raises
    :class:`AlertTreeError` — pointing the watchtower at a typo'd path
    must exit 2, not report a vacuously healthy fleet."""
    rules = rules if rules is not None else copy.deepcopy(DEFAULT_RULES)
    now = time.time() if now is None else now
    alerts: List[Alert] = []

    def on(name: str) -> Optional[Dict[str, Any]]:
        r = rules.get(name) or {}
        return r if r.get("enabled", True) else None

    # the latch doc appears on BOTH the owner's status doc and its
    # metric snapshots; one alert per owner, whichever surfaced first
    ro_fired: set = set()

    def ro_alert(owner: str, ro: Dict[str, Any],
                 r: Dict[str, Any]) -> None:
        if owner in ro_fired:
            return
        ro_fired.add(owner)
        alerts.append(Alert(
            "store_unwritable", owner, r["severity"],
            {"errno": ro.get("errno"), "reason": ro.get("reason")},
            None,
            f"store latched read-only ({ro.get('error', '?')}): exact "
            "answers continue, near/cold tiers shed, claims pause — "
            "clears when a probe write lands (free space / fix the "
            "mount)"))

    for d in list(store_dirs) + list(queue_dirs):
        if not os.path.isdir(d):
            raise AlertTreeError(f"fleet tree: {d} is not a directory")

    seen_status: List[Dict[str, Any]] = []
    for d in dict.fromkeys(list(store_dirs) + list(queue_dirs)):
        try:
            seen_status += _status_docs(d)
            history = snapshot_history(d)
        except OSError as e:
            # isdir passed but the scan failed (permissions, an NFS
            # hiccup): still an unreadable tree — usage error, never a
            # crash out of the follow view's render loop
            raise AlertTreeError(f"fleet tree: {d} unreadable "
                                 f"({e})") from e
        for owner, docs in sorted(history.items()):
            latest = docs[-1]
            if latest.get("state") == "stopped":
                continue  # a drained loop's ring is history, not health
            r = on("slo_burn")
            burns = [b for b in (burn_of(doc.get("slo")) for doc in docs)
                     if b is not None]
            fast = burn_of(latest.get("slo"))
            # min_window: with a 1-2 doc ring the slow median IS the
            # latest value, so the multi-window veto would degenerate —
            # a just-restarted loop's warm-up heartbeat must not page
            if r and fast is not None and \
                    len(burns) >= r.get("min_window", 1):
                slow = _median(burns)
                if fast >= r["fast_burn"] and slow >= r["slow_burn"]:
                    slo = latest["slo"]
                    alerts.append(Alert(
                        "slo_burn", owner, r["severity"],
                        {"fast": round(fast, 3), "slow": round(slow, 3)},
                        {"fast_burn": r["fast_burn"],
                         "slow_burn": r["slow_burn"]},
                        f"{slo.get('histogram', '?')} pct99 "
                        f"{slo.get('pct99_us')}us burning the SLO at "
                        f"{fast:.2f}x now / {slow:.2f}x over the ring "
                        f"(window of {len(burns)})"))
            gauges = (latest.get("metrics") or {}).get("gauges", {})
            r = on("shed_rate")
            shed = gauges.get("serve.shed_rate")
            if r and shed is not None and shed > r["max_per_s"]:
                alerts.append(Alert(
                    "shed_rate", owner, r["severity"], shed,
                    r["max_per_s"],
                    f"shedding {shed}/s (> {r['max_per_s']}/s): the "
                    "loop is refusing load"))
            r = on("queue_age")
            wait = gauges.get("serve.queue_age_s")
            if r and wait is not None and wait > r["max_wait_s"]:
                alerts.append(Alert(
                    "queue_age", f"{owner}:pending", r["severity"], wait,
                    r["max_wait_s"],
                    f"oldest pending request waited {wait}s "
                    f"(> {r['max_wait_s']}s) in the bounded queue"))
            r = on("tenant_shed")
            if r:
                # per-tenant fairness over the snapshot ring: growth of
                # the serve.shed.<tenant> / serve.timeout.<tenant>
                # counters the listen loop records (bounded label set — the
                # listen loop caps distinct tenants and aggregates the
                # rest under "other", so this iteration is bounded too)
                def ring_delta(prefix: str) -> Dict[str, int]:
                    def counters(doc):
                        return (doc.get("metrics") or {}).get(
                            "counters") or {}

                    new, old = counters(docs[-1]), counters(docs[0])
                    out: Dict[str, int] = {}
                    for key, val in new.items():
                        if not key.startswith(prefix):
                            continue
                        try:
                            delta = int(val) - int(old.get(key, 0))
                        except (TypeError, ValueError):
                            continue
                        # a negative delta means the counter reset
                        # (restart) inside the ring: the latest value
                        # IS the growth since then
                        out[key[len(prefix):]] = (delta if delta >= 0
                                                  else int(val))
                    return out

                sheds = ring_delta("serve.shed.")
                touts = ring_delta("serve.timeout.")
                for tenant in sorted(set(sheds) | set(touts)):
                    s, t = sheds.get(tenant, 0), touts.get(tenant, 0)
                    if s > r["max_shed"] or t > r["max_timeout"]:
                        alerts.append(Alert(
                            "tenant_shed", f"{owner}:{tenant}",
                            r["severity"],
                            {"shed": s, "timeout": t},
                            {"max_shed": r["max_shed"],
                             "max_timeout": r["max_timeout"]},
                            f"tenant {tenant!r}: {s} shed(s) / {t} "
                            f"timeout(s) across the snapshot ring "
                            f"(window of {len(docs)}) — one tenant is "
                            "eating the admission budget"))
            r = on("tracer_drops")
            tr = latest.get("tracer") or {}
            dropped = (int(tr.get("dropped_spans") or 0)
                       + int(tr.get("dropped_events") or 0))
            if r and dropped > r["max_dropped"]:
                alerts.append(Alert(
                    "tracer_drops", owner, r["severity"], dropped,
                    r["max_dropped"],
                    f"tracer dropped {dropped} record(s) "
                    f"({tr.get('dropped_spans', 0)} spans / "
                    f"{tr.get('dropped_events', 0)} events): telemetry "
                    "is being lost"))
            r = on("store_unwritable")
            ro = latest.get("store_readonly")
            if r and isinstance(ro, dict):
                ro_alert(owner, ro, r)
            r = on("store_damage_rate")
            if r:
                # segment-damage growth across the ring: the same
                # reset-tolerant delta trick as tenant_shed, over the
                # store's checksum-skip / quarantine counters
                def damage_ctr(doc: Dict[str, Any], key: str) -> int:
                    c = (doc.get("metrics") or {}).get("counters") or {}
                    try:
                        return int(c.get(key, 0))
                    except (TypeError, ValueError):
                        return 0

                damage, detail = 0, {}
                for key in ("serve.store.checksum_failed",
                            "serve.store.segment_quarantined",
                            "serve.store.manifest_quarantined"):
                    new = damage_ctr(docs[-1], key)
                    old = damage_ctr(docs[0], key)
                    delta = (new - old) if new >= old else new
                    if delta > 0:
                        detail[key.rsplit(".", 1)[-1]] = delta
                        damage += delta
                if damage > r["max_damage"]:
                    alerts.append(Alert(
                        "store_damage_rate", owner, r["severity"],
                        detail, r["max_damage"],
                        f"{damage} damaged store record(s) across the "
                        f"snapshot ring (window of {len(docs)}): "
                        f"{detail} — run `serve fsck` and check the "
                        "disk before the manifest rots further"))

    r = on("store_unwritable")
    if r:
        # daemons surface the latch on their status doc only (they
        # publish no snapshot ring) — catch those here
        for st in seen_status:
            if st.get("state") == "stopped":
                continue
            ro = st.get("store_readonly")
            if isinstance(ro, dict):
                ro_alert(str(st.get("owner", st.get("_file", "?"))),
                         ro, r)

    r = on("stale_heartbeat")
    if r:
        for st in seen_status:
            if st.get("state") == "stopped":
                continue  # said goodbye properly
            try:
                age = now - float(st.get("heartbeat_at", 0))
            except (TypeError, ValueError):
                continue
            if age > r["max_age_s"]:
                alerts.append(Alert(
                    "stale_heartbeat",
                    str(st.get("owner", st.get("_file", "?"))),
                    r["severity"], round(age, 1), r["max_age_s"],
                    f"{st.get('kind', 'daemon')} heartbeat is "
                    f"{age:.0f}s stale in state "
                    f"{st.get('state', '?')!r}: the process likely died "
                    "without stopping"))

    r = on("supervisor_crash_loop")
    if r:
        for st in seen_status:
            if st.get("kind") != "supervisor":
                continue
            sup = str(st.get("owner", st.get("_file", "?")))
            for member, b in sorted((st.get("breakers") or {}).items()):
                if not isinstance(b, dict) or \
                        b.get("state") not in ("open", "half_open"):
                    continue
                alerts.append(Alert(
                    "supervisor_crash_loop", member, r["severity"],
                    {"state": b.get("state"),
                     "restarts": b.get("restarts_in_window")},
                    {"max_restarts": b.get("max_restarts"),
                     "window_s": b.get("window_s")},
                    f"member {member!r} crash-looped "
                    f"({b.get('restarts_in_window')} restart(s) inside "
                    f"{b.get('window_s')}s): quarantined by {sup} with "
                    f"the breaker {b.get('state')} — the fleet is "
                    "degraded, not flapping"))

    for qd in dict.fromkeys(queue_dirs):
        try:
            names = sorted(os.listdir(qd))
        except OSError as e:
            raise AlertTreeError(f"fleet tree: {qd} unreadable "
                                 f"({e})") from e
        r = on("poison")
        if r:
            for name in names:
                if name.startswith("poison-") and name.endswith(".json"):
                    alerts.append(Alert(
                        "poison", name[len("poison-"):-len(".json")][:16],
                        r["severity"], 1, 0,
                        f"poisoned work item {name}: a request "
                        "deterministically fails its drain"))
        r = on("queue_age")
        if r:
            oldest: Optional[float] = None
            subject = None
            for name in names:
                if not (name.startswith("work-") and
                        name.endswith(".json")):
                    continue
                try:
                    age = now - os.path.getmtime(os.path.join(qd, name))
                except OSError:
                    continue
                if oldest is None or age > oldest:
                    oldest, subject = age, name
            if oldest is not None and oldest > r["max_s"]:
                alerts.append(Alert(
                    "queue_age", qd, r["severity"], round(oldest, 1),
                    r["max_s"],
                    f"work item {subject} has waited {oldest:.0f}s "
                    f"(> {r['max_s']}s): the drain fleet is not "
                    "keeping up"))

    r = on("queue_backlog_burn")
    if r:
        bl = backlog_summary(store_dirs, queue_dirs,
                             max_daemons=r.get("max_daemons"))
        arrival, drain = bl["arrival_per_s"], bl["drain_per_s"]
        burning = (arrival >= r["min_arrival_per_s"] and bl["depth"] > 0
                   and (drain <= 0 or arrival / drain >= r["burn_ratio"]))
        if burning:
            alerts.append(Alert(
                "queue_backlog_burn", "fleet", r["severity"],
                {"arrival_per_s": arrival, "drain_per_s": drain,
                 "depth": bl["depth"]},
                {"burn_ratio": r["burn_ratio"],
                 "min_arrival_per_s": r["min_arrival_per_s"]},
                f"cold work arrives at {arrival:.2f}/s but "
                f"{bl['daemons']} daemon(s) drain {drain:.2f}/s "
                f"(depth {bl['depth']}): the queue grows without bound "
                f"— run ~{bl['recommended_daemons']} daemon(s) to "
                "balance"))
    return alerts


def backlog_summary(store_dirs: List[str],
                    queue_dirs: List[str],
                    max_daemons: Optional[int] = None,
                    quarantined_owners: Optional[set] = None
                    ) -> Dict[str, Any]:
    """Arrival-vs-drain economics for the ``queue_backlog_burn`` rule
    and the follow view's ``burn`` line: arrival/s from reqlog position
    deltas across each live serve loop's snapshot ring (fallback: the
    served+shed+timeout counter deltas), fleet drain/s from each live
    daemon's measured per-item wall clock (status-doc history), queue
    depth from the work files themselves, and the daemon count that
    would balance the two.  ``recommended_daemons`` is clamped to
    ``max_daemons`` (``None`` = ~os.cpu_count(); ``0`` = unclamped —
    the raw figure stays in ``recommended_daemons_raw``) so one burst
    against a slow drain cannot recommend an absurd fleet for the
    host.  Member slots quarantined by a live supervisor's crash-loop
    breakers are excluded from capacity (their stale status docs would
    otherwise inflate it) and reported as ``quarantined_daemons``.
    ``quarantined_owners`` lets an in-process supervisor union its OWN
    in-memory open/half-open breaker owners into that exclusion — its
    breaker state is fresher than the published status snapshots (a
    member can trip between status publishes, and the supervisor's own
    doc write can lag), so the capacity estimate it scales on never
    counts a member it has itself quarantined.
    Read-only and damage-tolerant: unreadable pieces contribute zero,
    never raise."""
    arrival = 0.0
    for d in dict.fromkeys(store_dirs):
        if not os.path.isdir(d):
            continue
        try:
            history = snapshot_history(d)
        except OSError:
            continue
        for _owner, docs in sorted(history.items()):
            if docs[-1].get("state") == "stopped" or len(docs) < 2:
                continue

            def seen(doc) -> Optional[float]:
                rl = doc.get("reqlog")
                if isinstance(rl, dict) and rl.get("records") is not None:
                    try:
                        return float(rl["records"])
                    except (TypeError, ValueError):
                        return None
                c = doc.get("counters")
                if isinstance(c, dict):
                    try:
                        return float(
                            sum(v for k, v in c.items()
                                if k.startswith("served_")
                                or k in ("shed", "timeouts")))
                    except TypeError:
                        return None
                return None

            try:
                dt = float(docs[-1]["written_at"]) - \
                    float(docs[0]["written_at"])
            except (KeyError, TypeError, ValueError):
                continue
            n0, n1 = seen(docs[0]), seen(docs[-1])
            if dt > 0 and n0 is not None and n1 is not None and n1 > n0:
                arrival += (n1 - n0) / dt

    drain = 0.0
    daemons = 0
    quarantined = 0
    walls: List[float] = []
    for qd in dict.fromkeys(queue_dirs):
        if not os.path.isdir(qd):
            continue
        try:
            docs = _status_docs(qd)
        except OSError:
            continue
        # a live supervisor's open/half-open breakers name quarantined
        # member slots: a crash-looped member leaves a stale (never
        # "stopped") status doc behind, which must not count as drain
        # capacity — or recommended_daemons under-recommends exactly
        # while the fleet is degraded
        bad_members = set(str(o) for o in (quarantined_owners or ()))
        for st in docs:
            if st.get("kind") != "supervisor" or \
                    st.get("state") == "stopped":
                continue
            for member, b in (st.get("breakers") or {}).items():
                if isinstance(b, dict) and \
                        b.get("state") in ("open", "half_open"):
                    bad_members.add(str(member))
        for st in docs:
            # only drain daemons count toward fleet capacity — the
            # serve loop and the supervisor publish the same status
            # shape but drain nothing
            if st.get("kind") in ("serve_loop", "supervisor") or \
                    st.get("state") == "stopped":
                continue
            if str(st.get("owner", "")) in bad_members:
                quarantined += 1
                continue
            ws = []
            for h in st.get("history") or []:
                try:
                    w = float(h.get("wall_s"))
                except (TypeError, ValueError):
                    continue
                if w > 0 and h.get("outcome") == "completed":
                    ws.append(w)
            daemons += 1
            if ws:
                walls += ws
                drain += 1.0 / (sum(ws) / len(ws))

    depth = 0
    for qd in dict.fromkeys(queue_dirs):
        try:
            depth += sum(1 for n in os.listdir(qd)
                         if n.startswith("work-") and n.endswith(".json"))
        except OSError:
            pass

    per_item_s = (sum(walls) / len(walls)) if walls else None
    if arrival > 0 and per_item_s:
        recommended = max(1, int(math.ceil(arrival * per_item_s)))
    else:
        recommended = max(1, daemons)
    if max_daemons is None:
        max_daemons = os.cpu_count() or 4
    clamped = recommended if max_daemons <= 0 \
        else min(recommended, int(max_daemons))
    return {"arrival_per_s": round(arrival, 3),
            "drain_per_s": round(drain, 3),
            "daemons": daemons, "quarantined_daemons": quarantined,
            "depth": depth,
            "per_item_s": round(per_item_s, 3) if per_item_s else None,
            "recommended_daemons": clamped,
            "recommended_daemons_raw": recommended,
            "max_daemons": max_daemons if max_daemons > 0 else None}


# -- firing/resolved state machine -------------------------------------------

class AlertBook:
    """The persistent alert ledger (module docstring): load the previous
    ``alerts-<owner>.json``, :meth:`apply` one evaluation's active set,
    write the updated document atomically."""

    def __init__(self, path: str, owner: str = "alerts",
                 resolve_hold_secs: float = 0.0,
                 log: Optional[Callable[[str], None]] = None):
        self.path = path
        self.owner = owner
        self.resolve_hold_secs = float(resolve_hold_secs)
        self._log = log

    def load(self) -> Dict[str, Any]:
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and \
                    doc.get("version", 0) <= ALERT_DOC_VERSION and \
                    isinstance(doc.get("alerts"), dict):
                return doc
        except (OSError, ValueError):
            pass
        return {"version": ALERT_DOC_VERSION, "owner": self.owner,
                "alerts": {}}

    def apply(self, active: List[Alert],
              now: Optional[float] = None) -> Dict[str, Any]:
        now = time.time() if now is None else now
        doc = self.load()
        entries: Dict[str, Dict[str, Any]] = doc["alerts"]
        active_by_key = {a.key: a for a in active}
        for key, a in sorted(active_by_key.items()):
            e = entries.get(key)
            if e is None or e.get("state") != "firing":
                # (re-)fire: ONE transition, count incremented — a
                # resolved entry re-firing is visibly a re-fire
                prev_count = int(e.get("count", 0)) if e else 0
                transitions = list(e.get("transitions", [])) if e else []
                transitions.append({"to": "firing", "at": now})
                entries[key] = {
                    **a.to_json(),
                    "state": "firing",
                    "count": prev_count + 1,
                    "first_fired_at": (e or {}).get("first_fired_at", now),
                    "fired_at": now,
                    "last_seen_at": now,
                    "resolved_at": None,
                    "transitions": transitions[-TRANSITIONS_CAP:],
                }
                if self._log is not None:
                    self._log(f"alert firing: {key} — {a.message}")
            else:
                # dedup: still firing, refresh the observation only
                e.update(a.to_json())
                e["state"] = "firing"
                e["last_seen_at"] = now
        for key, e in entries.items():
            if key in active_by_key or e.get("state") != "firing":
                continue
            seen = float(e.get("last_seen_at") or e.get("fired_at") or 0)
            if now - seen >= self.resolve_hold_secs:
                # hysteresis: absent long enough — resolve (one
                # transition); inside the hold window it keeps firing,
                # so threshold oscillation cannot flap the ledger
                e["state"] = "resolved"
                e["resolved_at"] = now
                e.setdefault("transitions", []).append(
                    {"to": "resolved", "at": now})
                e["transitions"] = e["transitions"][-TRANSITIONS_CAP:]
                if self._log is not None:
                    self._log(f"alert resolved: {key}")
        # bound the ledger: drop the stalest RESOLVED entries beyond the
        # cap (firing entries are never dropped — they are the point)
        resolved = [(float(e.get("resolved_at") or 0), k)
                    for k, e in entries.items()
                    if e.get("state") == "resolved"]
        if len(entries) > ENTRIES_CAP:
            resolved.sort()
            for _, k in resolved[:len(entries) - ENTRIES_CAP]:
                entries.pop(k, None)
        doc.update({"version": ALERT_DOC_VERSION, "owner": self.owner,
                    "updated_at": now,
                    "firing": sorted(k for k, e in entries.items()
                                     if e.get("state") == "firing")})
        atomic_dump_json(self.path, doc, prefix=".alerts.")
        return doc


def firing_lines(store_dirs: List[str], queue_dirs: List[str],
                 rules: Optional[Dict[str, Dict[str, Any]]] = None
                 ) -> List[str]:
    """Live firing-alert lines for the follow view (obs/report.py
    ``--follow``): one read-only evaluation with the effective rules,
    nothing persisted; a missing directory renders as a line instead of
    raising — the fleet view must keep rendering through damage."""
    try:
        active = evaluate([d for d in store_dirs if os.path.isdir(d)],
                          [d for d in queue_dirs if os.path.isdir(d)],
                          rules=rules)
    except AlertTreeError as e:
        return [f"alert  evaluation failed: {e}"]
    return [f"ALERT  [{a.severity}] {a.rule} {a.subject}: {a.message}"
            for a in active]


# -- CLI ---------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tenzing_tpu_torch.obs.alerts",
        description="Evaluate the watchtower rule catalog over the "
                    "fleet's status/metric-snapshot documents and "
                    "persist the firing/resolved ledger.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("check", help="one evaluation pass; exit 0 "
                                      "healthy / 1 firing / 2 unreadable")
    pc.add_argument("--store", nargs="*", default=None, metavar="DIR",
                    help="segmented store directories (status docs + "
                         "metric-snapshot rings)")
    pc.add_argument("--queue-dir", nargs="*", default=None, metavar="DIR",
                    help="work-queue directories (daemon status docs, "
                         "poison quarantine, item ages)")
    pc.add_argument("--rules", default=None, metavar="PATH",
                    help="JSON rule overrides merged over the catalog")
    pc.add_argument("--set", dest="sets", action="append", default=None,
                    metavar="RULE.PARAM=VALUE",
                    help="one threshold override (repeatable)")
    pc.add_argument("--state", default=None, metavar="PATH",
                    help="alert ledger path (default alerts-<owner>.json "
                         "in the first --store/--queue-dir)")
    pc.add_argument("--owner", default="alerts",
                    help="ledger owner tag (one ledger per fleet tree)")
    pc.add_argument("--hold", type=float, default=0.0, metavar="SECS",
                    help="resolve hysteresis: an alert must stay absent "
                         "this long before firing -> resolved")
    args = ap.parse_args(argv)
    stores = args.store or []
    queues = args.queue_dir or []
    if not stores and not queues:
        ap.error("check needs --store and/or --queue-dir")
    state = args.state or os.path.join(
        (stores + queues)[0], f"alerts-{args.owner}.json")
    try:
        rules = load_rules(args.rules, args.sets)
        active = evaluate(stores, queues, rules=rules)
        book = AlertBook(state, owner=args.owner,
                         resolve_hold_secs=args.hold,
                         log=lambda m: sys.stderr.write(m + "\n"))
        # an unwritable ledger is a broken watchtower, not a firing
        # alert: it must exit 2 like any other unreadable-tree error so
        # a CI gate never mistakes the crash for a verdict
        doc = book.apply(active)
    except (AlertTreeError, OSError) as e:
        sys.stderr.write(f"alerts: {e}\n")
        return 2
    firing = [doc["alerts"][k] for k in doc.get("firing", [])]
    sys.stdout.write(json.dumps({
        "firing": [{k: e[k] for k in ("rule", "subject", "severity",
                                      "value", "message")}
                   for e in firing],
        "n_firing": len(firing),
        "n_resolved": sum(1 for e in doc["alerts"].values()
                          if e.get("state") == "resolved"),
        "state": state,
    }, sort_keys=True) + "\n")
    return 1 if firing else 0


if __name__ == "__main__":
    sys.exit(main())
