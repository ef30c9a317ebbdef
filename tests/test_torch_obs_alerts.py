"""The port's alert engine (tenzing_tpu_torch/obs/alerts.py) against the
JAX package's (tenzing_tpu/obs/alerts.py; reference tests
test_obs_alerts.py), test for test: the multi-window burn-rate math, every
rule of the catalog against doctored documents, the firing/resolved state
machine (dedup, transition timestamps, hysteresis), rule overrides, and the
``alerts check`` exit codes (0 nothing firing, 1 firing, 2 unreadable
tree).  Then across the packages: the same tree of status and snapshot
documents gives the same firing set, backlog summary and ``AlertBook``
document.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from tenzing_tpu.obs import alerts as ref_alerts
from tenzing_tpu_torch.obs.alerts import (
    Alert,
    AlertBook,
    AlertTreeError,
    DEFAULT_RULES,
    backlog_summary,
    burn_of,
    evaluate,
    firing_lines,
    load_rules,
)

NOW = 1_700_000_000.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def snap(d, owner, seq, pct99, target=100.0, baseline=None,
         state="serving", gauges=None, tracer=None, now=NOW):
    doc = {"kind": "metrics_snapshot", "owner": owner, "seq": seq,
           "written_at": now - (10 - seq), "state": state,
           "metrics": {"counters": {}, "gauges": gauges or {},
                       "histograms": {}},
           "tracer": tracer or {"dropped_spans": 0, "dropped_events": 0}}
    if pct99 is not None:
        doc["slo"] = {"histogram": "serve.resolve_us.exact",
                      "pct99_us": pct99, "target_us": target,
                      "baseline_pct99_us": baseline}
    json.dump(doc, open(os.path.join(d, f"metrics-{owner}-{seq}.json"),
                        "w"))


def status(d, owner, state="serving", hb_age=0.0, kind="serve_loop",
           now=NOW):
    json.dump({"kind": kind, "owner": owner, "state": state,
               "heartbeat_at": now - hb_age},
              open(os.path.join(d, f"status-{owner}.json"), "w"))


@pytest.fixture()
def tree(tmp_path):
    store = tmp_path / "store"
    queue = tmp_path / "queue"
    store.mkdir()
    queue.mkdir()
    return str(store), str(queue)


# -- burn-rate math ----------------------------------------------------------

def test_burn_of_golden():
    assert burn_of({"pct99_us": 420.0, "target_us": 100.0}) == 4.2
    # no target: the committed baseline anchors the burn
    assert burn_of({"pct99_us": 150.0, "target_us": None,
                    "baseline_pct99_us": 100.0}) == 1.5
    assert burn_of({"pct99_us": None, "target_us": 100.0}) is None
    assert burn_of({"pct99_us": 50.0}) is None


def test_slo_burn_multiwindow_golden(tree):
    store, queue = tree
    # sustained burn: ring [110, 120, 400, 420] vs target 100
    # fast = 4.2 (latest), slow = median([1.1, 1.2, 4.0, 4.2]) = 2.6
    for i, p in enumerate([110.0, 120.0, 400.0, 420.0]):
        snap(store, "burn", i, p)
    alerts = evaluate([store], [queue], now=NOW)
    assert [a.rule for a in alerts] == ["slo_burn"]
    a = alerts[0]
    assert a.subject == "burn" and a.severity == "page"
    assert a.value == {"fast": 4.2, "slow": 2.6}
    assert a.threshold == {"fast_burn": 2.0, "slow_burn": 1.5}


def test_slo_burn_single_spike_does_not_fire(tree):
    store, queue = tree
    # one bad heartbeat in an otherwise healthy ring: fast window fires,
    # slow window (median 1.0) vetoes — the multi-window no-flap point
    for i, p in enumerate([100.0, 100.0, 100.0, 400.0]):
        snap(store, "spike", i, p)
    assert evaluate([store], [queue], now=NOW) == []


def test_slo_burn_needs_min_window(tree):
    """With a 1-2 doc ring the slow median IS the latest value, so the
    multi-window veto would degenerate: a just-restarted loop's one
    warm-up heartbeat must not page.  Three docs restore the veto."""
    store, queue = tree
    snap(store, "fresh", 0, 400.0)
    assert evaluate([store], [queue], now=NOW) == []
    snap(store, "fresh", 1, 410.0)
    assert evaluate([store], [queue], now=NOW) == []
    snap(store, "fresh", 2, 420.0)  # sustained across >= min_window
    assert [a.rule for a in evaluate([store], [queue], now=NOW)] == \
        ["slo_burn"]


def test_slo_burn_stopped_owner_skipped(tree):
    store, queue = tree
    for i, p in enumerate([400.0, 420.0, 430.0, 440.0]):
        snap(store, "gone", i, p, state="stopped" if i == 3 else "serving")
    assert evaluate([store], [queue], now=NOW) == []


# -- the rest of the catalog -------------------------------------------------

def test_stale_heartbeat_rule(tree):
    store, queue = tree
    status(store, "dead", state="serving", hb_age=300.0)
    status(store, "fresh", state="serving", hb_age=1.0)
    status(queue, "done", state="stopped", hb_age=9999.0, kind=None)
    alerts = evaluate([store], [queue], now=NOW)
    assert [a.key for a in alerts] == ["stale_heartbeat:dead"]
    assert alerts[0].value == 300.0


def test_poison_and_queue_age_rules(tree):
    store, queue = tree
    json.dump({"kind": "poisoned_request"},
              open(os.path.join(queue, "poison-deadbeef01.json"), "w"))
    item = os.path.join(queue, "work-abc.json")
    json.dump({"kind": "search_request"}, open(item, "w"))
    os.utime(item, (NOW - 1000, NOW - 1000))
    alerts = evaluate([store], [queue], now=NOW)
    keys = sorted(a.key for a in alerts)
    assert keys == ["poison:deadbeef01", f"queue_age:{queue}"]
    age = next(a for a in alerts if a.rule == "queue_age")
    assert age.value == 1000.0 and age.threshold == 600.0


def test_shed_rate_queue_wait_and_tracer_drops(tree):
    store, queue = tree
    snap(store, "hot", 0, None,
         gauges={"serve.shed_rate": 3.5, "serve.queue_age_s": 45.0},
         tracer={"dropped_spans": 7, "dropped_events": 2})
    alerts = {a.rule: a for a in evaluate([store], [queue], now=NOW)}
    assert alerts["shed_rate"].value == 3.5
    assert alerts["queue_age"].subject == "hot:pending"
    assert alerts["tracer_drops"].value == 9


def _snap_raw(d, owner, seq, counters=None, reqlog=None, state="serving",
              now=NOW):
    doc = {"kind": "metrics_snapshot", "owner": owner, "seq": seq,
           "written_at": now - (10 - seq), "state": state,
           "metrics": {"counters": counters or {}, "gauges": {},
                       "histograms": {}},
           "tracer": {"dropped_spans": 0, "dropped_events": 0}}
    if reqlog is not None:
        doc["reqlog"] = reqlog
    json.dump(doc, open(os.path.join(d, f"metrics-{owner}-{seq}.json"),
                        "w"))


def test_tenant_shed_rule_fires_on_ring_growth(tree):
    store, queue = tree
    # tenant "acme" sheds grow 2 -> 9 across the ring, "other" (the
    # capped set's aggregate label) collects a timeout; "quiet" is flat
    _snap_raw(store, "loop", 0, counters={"serve.shed.acme": 2,
                                          "serve.shed.quiet": 5})
    _snap_raw(store, "loop", 3, counters={"serve.shed.acme": 9,
                                          "serve.shed.quiet": 5,
                                          "serve.timeout.other": 1})
    alerts = evaluate([store], [queue], now=NOW)
    assert sorted(a.key for a in alerts) == \
        ["tenant_shed:loop:acme", "tenant_shed:loop:other"]
    acme = next(a for a in alerts if a.subject == "loop:acme")
    assert acme.value == {"shed": 7, "timeout": 0}
    assert acme.severity == "ticket"
    assert "acme" in acme.message


def test_tenant_shed_counter_reset_and_thresholds(tree):
    store, queue = tree
    # a counter reset (restart inside the ring) must read as "latest
    # value since the reset", never a negative delta that hides growth
    _snap_raw(store, "loop", 0, counters={"serve.shed.acme": 50})
    _snap_raw(store, "loop", 3, counters={"serve.shed.acme": 3})
    alerts = evaluate([store], [queue], now=NOW)
    assert [a.key for a in alerts] == ["tenant_shed:loop:acme"]
    assert alerts[0].value == {"shed": 3, "timeout": 0}
    # a raised budget (--set tenant_shed.max_shed=5) tolerates it
    rules = load_rules(sets=["tenant_shed.max_shed=5"])
    assert evaluate([store], [queue], rules=rules, now=NOW) == []


def _daemon_status(qd, owner, history, state="draining", now=NOW):
    json.dump({"owner": owner, "pid": 1, "state": state,
               "heartbeat_at": now, "history": history},
              open(os.path.join(qd, f"status-{owner}.json"), "w"))


def test_backlog_summary_and_burn_rule(tree):
    store, queue = tree
    # arrival: the reqlog position advances 0 -> 30 records across a
    # 3s ring window -> 10/s
    _snap_raw(store, "loop", 0, reqlog={"records": 0, "segments": 1})
    _snap_raw(store, "loop", 3, reqlog={"records": 30, "segments": 1})
    # drain: one live daemon completing items in 2s each -> 0.5/s
    _daemon_status(queue, "d1", [
        {"exact": "e", "outcome": "completed", "wall_s": 2.0},
        {"exact": "e", "outcome": "completed", "wall_s": 2.0},
        {"exact": "e", "outcome": "failed", "wall_s": 99.0},  # excluded
    ])
    json.dump({"kind": "search_request"},
              open(os.path.join(queue, "work-x.json"), "w"))
    bl = backlog_summary([store], [queue], max_daemons=0)
    assert bl["arrival_per_s"] == 10.0
    assert bl["drain_per_s"] == 0.5
    assert bl["daemons"] == 1 and bl["depth"] == 1
    assert bl["per_item_s"] == 2.0
    assert bl["recommended_daemons"] == 20  # ceil(10/s * 2s/item)
    assert bl["recommended_daemons_raw"] == 20
    assert bl["max_daemons"] is None  # 0 = unclamped
    # default clamps to os.cpu_count(); explicit bound wins
    clamped = backlog_summary([store], [queue], max_daemons=3)
    assert clamped["recommended_daemons"] == 3
    assert clamped["recommended_daemons_raw"] == 20
    assert clamped["max_daemons"] == 3
    dflt = backlog_summary([store], [queue])
    assert dflt["max_daemons"] == (os.cpu_count() or 4)
    assert dflt["recommended_daemons"] == min(20, dflt["max_daemons"])
    rules = load_rules(
        sets=["queue_backlog_burn.max_daemons=0"])  # unclamped
    alerts = [a for a in evaluate([store], [queue], rules=rules, now=NOW)
              if a.rule == "queue_backlog_burn"]
    assert len(alerts) == 1
    a = alerts[0]
    assert a.subject == "fleet" and a.severity == "page"
    assert a.value["arrival_per_s"] == 10.0
    assert "~20 daemon(s)" in a.message


def test_backlog_burn_needs_depth_and_arrival(tree):
    store, queue = tree
    # arrival without queued work: the fleet is keeping up — no alert
    _snap_raw(store, "loop", 0, reqlog={"records": 0})
    _snap_raw(store, "loop", 3, reqlog={"records": 30})
    assert [a.rule for a in evaluate([store], [queue], now=NOW)] == []
    # queued work without measurable arrival: queue_age owns that
    # story, the burn rule stays silent
    for n in os.listdir(store):
        os.unlink(os.path.join(store, n))
    json.dump({"kind": "search_request"},
              open(os.path.join(queue, "work-x.json"), "w"))
    assert [a.rule for a in evaluate([store], [queue], now=NOW)] == []


def test_backlog_burn_balanced_fleet_does_not_fire(tree):
    store, queue = tree
    _snap_raw(store, "loop", 0, reqlog={"records": 0})
    _snap_raw(store, "loop", 3, reqlog={"records": 3})  # 1/s
    # two daemons at 1s/item drain 2/s > 1.2 * arrival — healthy
    _daemon_status(queue, "d1", [{"outcome": "completed", "wall_s": 1.0}])
    _daemon_status(queue, "d2", [{"outcome": "completed", "wall_s": 1.0}])
    json.dump({"kind": "search_request"},
              open(os.path.join(queue, "work-x.json"), "w"))
    assert [a.rule for a in evaluate([store], [queue], now=NOW)] == []
    # a stopped daemon stops counting toward the fleet's drain rate
    _daemon_status(queue, "d1", [{"outcome": "completed", "wall_s": 1.0}],
                   state="stopped")
    _daemon_status(queue, "d2", [{"outcome": "completed", "wall_s": 1.0}],
                   state="stopped")
    fired = [a.rule for a in evaluate([store], [queue], now=NOW)]
    assert "queue_backlog_burn" in fired


def test_missing_tree_is_usage_error(tmp_path):
    with pytest.raises(AlertTreeError):
        evaluate([str(tmp_path / "nope")], [])
    # the follow view renders through it instead of raising
    assert firing_lines([str(tmp_path / "nope")], []) == []


# -- rule configuration ------------------------------------------------------

def test_load_rules_overrides(tmp_path):
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"slo_burn": {"fast_burn": 9.0},
                             "poison": {"enabled": False}}))
    rules = load_rules(str(p), sets=["queue_age.max_s=5",
                                     "shed_rate.severity=ticket"])
    assert rules["slo_burn"]["fast_burn"] == 9.0
    assert rules["slo_burn"]["slow_burn"] == 1.5  # untouched default
    assert rules["poison"]["enabled"] is False
    assert rules["queue_age"]["max_s"] == 5
    assert rules["shed_rate"]["severity"] == "ticket"
    assert DEFAULT_RULES["slo_burn"]["fast_burn"] == 2.0  # no mutation
    with pytest.raises(AlertTreeError):
        load_rules(sets=["nope.max_s=5"])
    with pytest.raises(AlertTreeError):
        load_rules(sets=["slo_burn.nope=5"])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"not_a_rule": {}}))
    with pytest.raises(AlertTreeError):
        load_rules(str(bad))
    # a typo'd PARAM in the file is just as loud as a typo'd rule —
    # it must not silently leave the real threshold at its default
    typo = tmp_path / "typo.json"
    typo.write_text(json.dumps({"stale_heartbeat": {"max_age_sec": 5}}))
    with pytest.raises(AlertTreeError):
        load_rules(str(typo))


def test_disabled_rule_does_not_fire(tree):
    store, queue = tree
    status(store, "dead", state="serving", hb_age=300.0)
    rules = load_rules(sets=["stale_heartbeat.enabled=false"])
    assert evaluate([store], [queue], rules=rules, now=NOW) == []


# -- the firing/resolved state machine ---------------------------------------

def _alert(key="slo_burn:o1", value=4.0):
    rule, subject = key.split(":")
    return Alert(rule, subject, "page", value, 2.0, f"{subject} burning")


def test_state_machine_fire_dedup_resolve_refire(tmp_path):
    path = str(tmp_path / "alerts.json")
    book = AlertBook(path, owner="t", resolve_hold_secs=0.0)
    # fire
    doc = book.apply([_alert()], now=NOW)
    e = doc["alerts"]["slo_burn:o1"]
    assert doc["firing"] == ["slo_burn:o1"]
    assert e["state"] == "firing" and e["count"] == 1
    assert e["first_fired_at"] == NOW
    assert e["transitions"] == [{"to": "firing", "at": NOW}]
    # still firing: dedup — observation refreshed, NO new transition
    doc = book.apply([_alert(value=5.0)], now=NOW + 10)
    e = doc["alerts"]["slo_burn:o1"]
    assert e["count"] == 1 and len(e["transitions"]) == 1
    assert e["value"] == 5.0 and e["last_seen_at"] == NOW + 10
    assert e["first_fired_at"] == NOW
    # absent: resolved, timestamped
    doc = book.apply([], now=NOW + 20)
    e = doc["alerts"]["slo_burn:o1"]
    assert e["state"] == "resolved" and e["resolved_at"] == NOW + 20
    assert doc["firing"] == []
    assert [t["to"] for t in e["transitions"]] == ["firing", "resolved"]
    # re-fire: visibly a re-fire (count 2, first_fired_at preserved)
    doc = book.apply([_alert()], now=NOW + 30)
    e = doc["alerts"]["slo_burn:o1"]
    assert e["state"] == "firing" and e["count"] == 2
    assert e["first_fired_at"] == NOW
    assert [t["to"] for t in e["transitions"]] == \
        ["firing", "resolved", "firing"]
    # the ledger round-trips through disk (a fresh book sees the state)
    doc2 = AlertBook(path, owner="t").load()
    assert doc2["alerts"]["slo_burn:o1"]["count"] == 2


def test_state_machine_resolve_hysteresis_no_flap(tmp_path):
    book = AlertBook(str(tmp_path / "alerts.json"), resolve_hold_secs=60.0)
    book.apply([_alert()], now=NOW)
    # absent, but inside the hold window: keeps firing (no flap)
    doc = book.apply([], now=NOW + 30)
    assert doc["alerts"]["slo_burn:o1"]["state"] == "firing"
    # flapping back in is a dedup, not a transition
    doc = book.apply([_alert()], now=NOW + 40)
    e = doc["alerts"]["slo_burn:o1"]
    assert e["count"] == 1 and len(e["transitions"]) == 1
    # absent past the hold: resolved exactly once
    doc = book.apply([], now=NOW + 101)
    assert doc["alerts"]["slo_burn:o1"]["state"] == "resolved"


def test_state_machine_survives_torn_ledger(tmp_path):
    path = str(tmp_path / "alerts.json")
    open(path, "w").write('{"torn')
    doc = AlertBook(path).apply([_alert()], now=NOW)
    assert doc["firing"] == ["slo_burn:o1"]


# -- the check CLI (the CI gate) ---------------------------------------------

def _check(*args):
    return subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.obs.alerts", "check",
         *args], capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


def test_check_cli_exit_codes(tree, tmp_path):
    store, queue = tree
    now = time.time()
    snap(store, "ok", 0, 90.0, now=now)
    status(store, "ok", state="serving", hb_age=0.0, now=now)
    state = str(tmp_path / "ledger.json")
    r = _check("--store", store, "--queue-dir", queue, "--state", state)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["n_firing"] == 0
    # doctor the tree: pct99 10x over the SLO, sustained across the ring
    for i in range(4):
        snap(store, "ok", i, 1000.0, now=now)
    r = _check("--store", store, "--queue-dir", queue, "--state", state)
    assert r.returncode == 1, r.stdout
    out = json.loads(r.stdout)
    assert out["n_firing"] == 1
    assert out["firing"][0]["rule"] == "slo_burn"
    ledger = json.load(open(state))
    assert ledger["firing"] == ["slo_burn:ok"]
    # heal: the same ledger resolves the alert, exit back to 0
    for i in range(4):
        snap(store, "ok", i, 90.0, now=now)
    r = _check("--store", store, "--queue-dir", queue, "--state", state)
    assert r.returncode == 0, r.stdout
    ledger = json.load(open(state))
    assert ledger["alerts"]["slo_burn:ok"]["state"] == "resolved"
    # unreadable tree = usage error, not a verdict
    r = _check("--store", str(tmp_path / "missing"))
    assert r.returncode == 2
    assert "not a directory" in r.stderr
    # so is a malformed override
    r = _check("--store", store, "--set", "bogus.x=1")
    assert r.returncode == 2
    # and an unwritable ledger: a broken watchtower must never read as
    # "alerts firing" (exit 1) to the CI gate
    not_a_dir = str(tmp_path / "file")
    open(not_a_dir, "w").write("x")
    r = _check("--store", store, "--state",
               os.path.join(not_a_dir, "alerts.json"))
    assert r.returncode == 2, (r.returncode, r.stdout, r.stderr)


def test_follow_renders_firing_lines(tree):
    store, queue = tree
    for i, p in enumerate([400.0, 410.0, 420.0, 430.0]):
        snap(store, "burn", i, p)
    lines = firing_lines([store], [queue])
    assert len(lines) == 1
    assert lines[0].startswith("ALERT  [page] slo_burn burn:")


# -- hostile-filesystem rules -------------------------------------------------

RO = {"errno": 28, "error": "[Errno 28] injected enospc", "reason": "write",
      "latched_at": NOW}


def _ro_status(d, owner, state="paused", ro=RO, kind="drain_daemon",
               now=NOW):
    doc = {"kind": kind, "owner": owner, "state": state,
           "heartbeat_at": now}
    if ro is not None:
        doc["store_readonly"] = ro
    json.dump(doc, open(os.path.join(d, f"status-{owner}.json"), "w"))


def _ro_snap(d, owner, seq, ro=RO, now=NOW):
    doc = {"kind": "metrics_snapshot", "owner": owner, "seq": seq,
           "written_at": now - (10 - seq), "state": "serving",
           "metrics": {"counters": {}, "gauges": {}, "histograms": {}},
           "tracer": {"dropped_spans": 0, "dropped_events": 0}}
    if ro is not None:
        doc["store_readonly"] = ro
    json.dump(doc, open(os.path.join(d, f"metrics-{owner}-{seq}.json"),
                        "w"))


def test_store_unwritable_fires_from_daemon_status(tree):
    """Daemons publish no snapshot ring: the latch on their status doc
    alone must page."""
    store, queue = tree
    _ro_status(queue, "d1")
    alerts = evaluate([store], [queue], now=NOW)
    assert [a.key for a in alerts] == ["store_unwritable:d1"]
    a = alerts[0]
    assert a.severity == "page"
    assert a.value == {"errno": 28, "reason": "write"}
    assert "read-only" in a.message and "probe" in a.message


def test_store_unwritable_one_alert_per_owner(tree):
    """A latched serve loop carries the latch on BOTH its snapshot ring
    and its status doc — one alert, not two."""
    store, queue = tree
    _ro_snap(store, "loop", 0)
    _ro_status(store, "loop", state="serving", kind="serve_loop")
    alerts = [a for a in evaluate([store], [queue], now=NOW)
              if a.rule == "store_unwritable"]
    assert len(alerts) == 1 and alerts[0].subject == "loop"


def test_store_unwritable_stopped_owner_skipped(tree):
    store, queue = tree
    _ro_status(queue, "d1", state="stopped")
    _ro_snap(store, "loop", 0)
    _ro_snap(store, "loop", 1)
    json.dump(dict(json.load(open(os.path.join(
        store, "metrics-loop-1.json"))), state="stopped"),
        open(os.path.join(store, "metrics-loop-1.json"), "w"))
    assert evaluate([store], [queue], now=NOW) == []


def test_store_unwritable_fires_then_resolves_in_ledger(tree, tmp_path):
    """Latch -> fire; the probe write lands, the latch clears ->
    resolve."""
    store, queue = tree
    book = AlertBook(str(tmp_path / "alerts.json"), resolve_hold_secs=0.0)
    _ro_status(queue, "d1")
    doc = book.apply(evaluate([store], [queue], now=NOW), now=NOW)
    assert doc["firing"] == ["store_unwritable:d1"]
    _ro_status(queue, "d1", ro=None, state="idle")
    doc = book.apply(evaluate([store], [queue], now=NOW + 5), now=NOW + 5)
    assert doc["firing"] == []
    assert doc["alerts"]["store_unwritable:d1"]["state"] == "resolved"


def test_store_damage_rate_fires_on_ring_growth(tree):
    store, queue = tree
    _snap_raw(store, "loop", 0,
              counters={"serve.store.checksum_failed": 0})
    _snap_raw(store, "loop", 3,
              counters={"serve.store.checksum_failed": 4,
                        "serve.store.segment_quarantined": 1})
    alerts = evaluate([store], [queue], now=NOW)
    assert [a.key for a in alerts] == ["store_damage_rate:loop"]
    a = alerts[0]
    assert a.severity == "ticket"
    assert a.value == {"checksum_failed": 4, "segment_quarantined": 1}
    assert "fsck" in a.message


def test_store_damage_rate_flat_and_reset(tree):
    store, queue = tree
    # flat counters: old damage is not NEW damage
    _snap_raw(store, "loop", 0,
              counters={"serve.store.checksum_failed": 4})
    _snap_raw(store, "loop", 3,
              counters={"serve.store.checksum_failed": 4})
    assert evaluate([store], [queue], now=NOW) == []
    # a counter reset (restart inside the ring) reads as "growth since
    # the reset", same rule as tenant_shed
    _snap_raw(store, "loop", 3,
              counters={"serve.store.checksum_failed": 3})
    alerts = evaluate([store], [queue], now=NOW)
    assert [a.key for a in alerts] == ["store_damage_rate:loop"]
    assert alerts[0].value == {"checksum_failed": 3}


def test_backlog_summary_excludes_quarantined_members(tree):
    """A crash-looped member leaves a stale never-'stopped' status doc
    behind; the supervisor's open breaker names it, and its phantom
    capacity must not shrink the recommended fleet."""
    store, queue = tree
    json.dump({"kind": "supervisor", "owner": "fleet-0",
               "state": "supervising", "heartbeat_at": NOW,
               "breakers": {"w1": {"state": "open"},
                            "w2": {"state": "closed"}}},
              open(os.path.join(queue, "status-fleet-0.json"), "w"))
    _daemon_status(queue, "w1", [{"outcome": "completed", "wall_s": 1.0}])
    _daemon_status(queue, "w2", [{"outcome": "completed", "wall_s": 1.0}])
    bl = backlog_summary([store], [queue], max_daemons=0)
    assert bl["daemons"] == 1  # w2 only
    assert bl["quarantined_daemons"] == 1
    assert bl["drain_per_s"] == 1.0  # w1's stale doc contributes nothing


def test_backlog_summary_in_memory_quarantined_owners(tree):
    """The supervisor's IN-MEMORY breaker state is fresher than its
    published status doc: ``quarantined_owners`` must exclude a member the
    docs still show as healthy (no supervisor doc at all here — the
    pre-first-publish window) from drain capacity."""
    store, queue = tree
    _daemon_status(queue, "w1", [{"outcome": "completed", "wall_s": 1.0}])
    _daemon_status(queue, "w2", [{"outcome": "completed", "wall_s": 1.0}])
    bl = backlog_summary([store], [queue], max_daemons=0)
    assert bl["daemons"] == 2  # no breaker evidence on disk
    bl = backlog_summary([store], [queue], max_daemons=0,
                         quarantined_owners={"w1"})
    assert bl["daemons"] == 1
    assert bl["quarantined_daemons"] == 1
    assert bl["drain_per_s"] == 1.0


def test_supervisor_crash_loop_fires_on_open_breakers(tree):
    """A supervisor's status block naming a member whose breaker is open or
    half open fires one alert per member; a closed breaker and a
    non-supervisor document fire nothing."""
    store, queue = tree
    json.dump({"kind": "supervisor", "owner": "fleet-0",
               "state": "supervising", "heartbeat_at": NOW,
               "breakers": {"w1": {"state": "open", "restarts_in_window": 5,
                                   "max_restarts": 3, "window_s": 60},
                            "w2": {"state": "half_open"},
                            "w3": {"state": "closed"}, "w4": "torn"}},
              open(os.path.join(queue, "status-fleet-0.json"), "w"))
    json.dump({"kind": "serve_loop", "owner": "loop", "state": "serving",
               "heartbeat_at": NOW, "breakers": {"x": {"state": "open"}}},
              open(os.path.join(store, "status-loop.json"), "w"))
    alerts = [a for a in evaluate([store], [queue], now=NOW)
              if a.rule == "supervisor_crash_loop"]
    assert [a.subject for a in alerts] == ["w1", "w2"]
    assert alerts[0].value == {"state": "open", "restarts": 5}
    assert alerts[0].threshold == {"max_restarts": 3, "window_s": 60}
    assert "fleet-0" in alerts[0].message


# -- across the packages -------------------------------------------------------------

def _seeded_tree(seed, store, queue):
    """A tree with a bit of everything, drawn from ``seed``: snapshot rings
    (burning, spiking, shedding, dropping, tenant and damage counters,
    request-log positions, read-only latches, stopped owners), status
    documents (stale, fresh, stopped, daemons with histories, a
    supervisor), work items of several ages and poison files."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for o in range(int(rng.integers(1, 4))):
        owner = f"loop{o}"
        for i in range(int(rng.integers(1, 5))):
            gauges = {}
            if rng.random() < 0.4:
                gauges["serve.shed_rate"] = float(rng.integers(0, 4))
            if rng.random() < 0.4:
                gauges["serve.queue_age_s"] = float(rng.integers(0, 60))
            snap(store, owner, i, float(rng.integers(50, 600)),
                 target=float(rng.choice([100.0, 200.0])),
                 state="stopped" if rng.random() < 0.15 else "serving",
                 gauges=gauges, tracer={
                     "dropped_spans": int(rng.integers(0, 2)),
                     "dropped_events": 0})
        if rng.random() < 0.5:
            counters = {"serve.shed.acme": int(rng.integers(0, 9)),
                        "serve.timeout.other": int(rng.integers(0, 3)),
                        "serve.store.checksum_failed":
                            int(rng.integers(0, 3))}
            _snap_raw(store, f"raw{o}", 0, counters={
                k: max(0, v - 2) for k, v in counters.items()},
                reqlog={"records": 0})
            _snap_raw(store, f"raw{o}", 3, counters=counters,
                      reqlog={"records": int(rng.integers(0, 40))})
        status(store, owner, state=str(rng.choice(["serving", "stopped"])),
               hb_age=float(rng.integers(0, 200)))
    if rng.random() < 0.5:
        _ro_status(queue, "ro", state=str(rng.choice(["paused", "stopped"])))
    for d in range(int(rng.integers(0, 3))):
        _daemon_status(queue, f"d{d}", [
            {"exact": "e", "outcome": str(rng.choice(
                ["completed", "failed"])), "wall_s": float(
                rng.integers(1, 5))} for _ in range(3)],
            state=str(rng.choice(["draining", "stopped"])))
    if rng.random() < 0.5:
        json.dump({"kind": "supervisor", "owner": "sup", "state": "up",
                   "heartbeat_at": NOW,
                   "breakers": {"d0": {"state": "open"}}},
                  open(os.path.join(queue, "status-sup.json"), "w"))
    for w in range(int(rng.integers(0, 3))):
        item = os.path.join(queue, f"work-{seed}{w}.json")
        json.dump({"kind": "search_request"}, open(item, "w"))
        age = float(rng.integers(0, 2000))
        os.utime(item, (NOW - age, NOW - age))
    if rng.random() < 0.4:
        json.dump({"kind": "poisoned_request"}, open(os.path.join(
            queue, f"poison-{seed:04d}beef.json"), "w"))


@pytest.mark.parametrize("seed", range(8))
def test_firing_set_and_backlog_are_the_references(tmp_path, seed):
    store, queue = str(tmp_path / "s"), str(tmp_path / "q")
    os.makedirs(store)
    os.makedirs(queue)
    _seeded_tree(seed, store, queue)
    for sets in ([], ["queue_age.max_s=0", "queue_backlog_burn.max_daemons=0",
                      "tenant_shed.max_shed=3"]):
        rules = load_rules(sets=sets)
        mine = evaluate([store], [queue], rules=rules, now=NOW)
        ref = ref_alerts.evaluate([store], [queue],
                                  rules=ref_alerts.load_rules(sets=sets),
                                  now=NOW)
        assert [a.to_json() for a in mine] == [a.to_json() for a in ref]
    assert backlog_summary([store], [queue], max_daemons=0) == \
        ref_alerts.backlog_summary([store], [queue], max_daemons=0)
    assert backlog_summary([store], [queue], quarantined_owners={"d1"}) == \
        ref_alerts.backlog_summary([store], [queue],
                                   quarantined_owners={"d1"})
    # the follow view evaluates at the wall clock: ages masked
    import re

    def aged(lines):
        return [re.sub(r"\b\d+s\b", "Ns", ln) for ln in lines]

    assert aged(firing_lines([store], [queue])) == \
        aged(ref_alerts.firing_lines([store], [queue]))


@pytest.mark.parametrize("hold", [0.0, 15.0])
def test_alert_book_documents_are_the_references(tmp_path, hold):
    """The same evaluations applied at the same instants give the same
    ledger, and each package loads the other's."""
    import numpy as np

    rng = np.random.default_rng(int(hold))
    keys = ["slo_burn:o1", "poison:abc", "queue_age:q", "shed_rate:o2"]
    mine = AlertBook(str(tmp_path / "mine.json"), owner="t",
                     resolve_hold_secs=hold)
    ref = ref_alerts.AlertBook(str(tmp_path / "ref.json"), owner="t",
                               resolve_hold_secs=hold)
    for step in range(12):
        active = [k for k in keys if rng.random() < 0.5]
        now = NOW + 10 * step
        a = mine.apply([_alert(k, value=step) for k in active], now=now)
        b = ref.apply([ref_alerts.Alert(*k.split(":"), "page", step, 2.0,
                                        "m") for k in active], now=now)
        for doc in (a, b):
            for e in doc["alerts"].values():
                e["message"] = "m"
        assert a == b
    assert AlertBook(str(tmp_path / "ref.json")).load() == \
        ref_alerts.AlertBook(str(tmp_path / "ref.json")).load()
    assert ref_alerts.AlertBook(str(tmp_path / "mine.json")).load()[
        "firing"] == mine.load()["firing"]


def test_rule_catalog_and_overrides_are_the_references(tmp_path):
    assert DEFAULT_RULES == ref_alerts.DEFAULT_RULES
    assert len(DEFAULT_RULES) == 11
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"slo_burn": {"fast_burn": 9.0},
                             "poison": {"enabled": False}}))
    sets = ["queue_age.max_s=5", "shed_rate.severity=ticket",
            "queue_backlog_burn.max_daemons=null"]
    assert load_rules(str(p), sets) == ref_alerts.load_rules(str(p), sets)
    for slo in ({"pct99_us": 420.0, "target_us": 100.0},
                {"pct99_us": 150.0, "baseline_pct99_us": 100.0},
                {"pct99_us": None}, None, "x"):
        assert burn_of(slo) == ref_alerts.burn_of(slo)
