"""The port's fleet supervisor (tenzing_tpu_torch/serve/supervisor.py), unit
layer, against the reference's (test_supervisor.py): fake member handles
and a synthetic clock, no sleeps.

Each decision test drives the same tick sequence through both packages'
:class:`Supervisor` (or :class:`CrashLoopBreaker`) and holds them equal after
every step, exactly: each slot's fields and state, each breaker's document,
the counters, the scaling state, the active count and the signals each
fake member received.  Then the reference's own assertions are checked on
the port: the breaker's closed / open / half-open cycle and its sliding
window, restart backoff, quarantine and the ``supervisor_crash_loop`` page,
the wedged heartbeat, scaling hysteresis, cooldown and poison suppression,
adoption from live status documents, the retention GC, and the golden
member argv.  The port's own rule: ``max_daemons`` defaults to the visible
cards on ``cuda`` (ROADMAP Queue 3 item 21), and a ``cuda`` supervisor
without a card spawns nothing.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import pytest

from tenzing_tpu.fault.backoff import BackoffPolicy as RefBackoffPolicy
from tenzing_tpu.serve import supervisor as ref_sup
from tenzing_tpu_torch.bench.driver import DriverRequest
from tenzing_tpu_torch.fault.backoff import BackoffPolicy
from tenzing_tpu_torch.obs.alerts import evaluate
from tenzing_tpu_torch.serve import supervisor as port_sup
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of
from tenzing_tpu_torch.serve.store import WorkQueue
from tenzing_tpu_torch.serve.supervisor import (
    ALERTS_NAME,
    CrashLoopBreaker,
    MemberSlot,
    Supervisor,
    SupervisorOpts,
    _subprocess_member_spawn,
    gc_stale_artifacts,
    supervisor_exit_code,
)

LIMIT_S = 120  # each test's own time limit


@pytest.fixture(autouse=True)
def _limit():
    """A test past ``LIMIT_S`` fails with TimeoutError instead of holding
    its worker."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


# -- harness -----------------------------------------------------------------

class FakeHandle:
    """A member handle the test scripts: alive until ``die(rc)``."""

    def __init__(self, owner):
        self.owner = owner
        self.pid = 99999
        self.returncode = None
        self.signals = []
        self._alive = True

    def alive(self):
        return self._alive

    def send_signal(self, sig):
        self.signals.append(sig)

    def die(self, rc):
        self._alive, self.returncode = False, rc


def _sup(mod, root, spawn=None, **kw):
    """A supervisor of package ``mod`` over its own queue and store under
    ``root``; the port's drains on the CPU."""
    qdir = os.path.join(root, "q")
    store = os.path.join(root, "store")
    os.makedirs(qdir, exist_ok=True)
    os.makedirs(store, exist_ok=True)
    if mod is port_sup:
        kw.setdefault("device", "cpu")
    elif "backoff" in kw:
        b = kw["backoff"]
        kw["backoff"] = RefBackoffPolicy(
            retries=b.retries, base_secs=b.base_secs, factor=b.factor,
            max_secs=b.max_secs, jitter=b.jitter)
    opts = mod.SupervisorOpts(queue_dir=qdir, store_path=store,
                              handle_signals=False, compact_interval_secs=0,
                              gc_interval_secs=0, **kw)
    spawn = spawn or (lambda o, s: FakeHandle(s.owner))
    return mod.Supervisor(opts, spawn=spawn, log=lambda m: None)


def _snap(sup):
    """Everything a decision changes, comparable across the packages."""
    return {
        "slots": {k: {
            "owner": s.owner, "kind": s.kind, "alive": s.handle is not None,
            "adopted": s.adopted, "stopping": s.stopping,
            "wedged": s.wedged, "restarts": s.restarts,
            "clean_exits": s.clean_exits, "backoff_i": s.backoff_i,
            "next_spawn_at": s.next_spawn_at, "last_rc": s.last_rc,
            "started_at": s.started_at,
            "state": s.state(sup._breaker_of(s.owner)),
            "signals": list(getattr(s.handle, "signals", []))}
            for k, s in sorted(sup.slots.items())},
        "breakers": {o: b.to_json() for o, b in sorted(sup.breakers.items())},
        "counters": dict(sup.counters),
        "scaling": dict(sup._scaling_state),
        "active": sup._active_n(),
        "pending": (sup._pending_desired, sup._pending_ticks),
        "last_scale_at": sup._last_scale_at,
        "max_daemons": sup.max_daemons,
    }


class Pair:
    """The reference's and the port's supervisor, driven in step."""

    def __init__(self, tmp_path, **kw):
        self.ref = _sup(ref_sup, str(tmp_path / "ref"), **kw)
        self.port = _sup(port_sup, str(tmp_path / "port"), **kw)

    def both(self, fn):
        out = (fn(self.ref), fn(self.port))
        assert _snap(self.port) == _snap(self.ref)
        return out[1]

    def status_doc(self, owner, doc):
        for sup in (self.ref, self.port):
            with open(os.path.join(sup.opts.queue_dir,
                                   f"status-{owner}.json"), "w") as f:
                json.dump(doc, f)


def _breakers_step(fn):
    """Apply ``fn`` to a reference and a port breaker built alike; their
    results and documents must agree."""
    def run(kw):
        a, b = ref_sup.CrashLoopBreaker(**kw), CrashLoopBreaker(**kw)
        for step in fn:
            ra, rb = step(a), step(b)
            assert ra == rb, step
            assert a.to_json() == b.to_json()
            assert (a.probe_spawned, a.restarts) == (b.probe_spawned,
                                                     b.restarts)
        return b
    return run


# -- the breaker -------------------------------------------------------------

def test_breaker_open_half_open_close_cycle():
    t = 1000.0
    steps = [
        lambda br: br.allow_spawn(t),
        lambda br: br.record_crash(t),
        lambda br: br.record_crash(t + 1),
        lambda br: br.record_crash(t + 2),
        lambda br: br.allow_spawn(t + 50),
        lambda br: br.allow_spawn(t + 103),
        lambda br: br.spawned(t + 103),
        lambda br: br.allow_spawn(t + 104),
        lambda br: br.record_crash(t + 105),
        lambda br: br.allow_spawn(t + 106),
        lambda br: br.allow_spawn(t + 206),
        lambda br: br.spawned(t + 206),
        lambda br: br.note_healthy(t + 212),
        lambda br: br.record_crash(t + 300),
    ]
    br = CrashLoopBreaker(max_restarts=3, window_secs=60.0,
                          quarantine_secs=100.0, probe_ok_secs=5.0)
    got = [step(br) for step in steps]
    assert got[:4] == [True, "closed", "closed", "open"]
    assert got[4] is False and got[5] is True and got[7] is False
    assert got[8] == "open" and got[9] is False and got[10] is True
    assert got[13] == "closed" and br.state == "closed"
    _breakers_step(steps)(dict(max_restarts=3, window_secs=60.0,
                               quarantine_secs=100.0, probe_ok_secs=5.0))


def test_breaker_window_slides():
    steps = [lambda br, t=t: br.record_crash(t)
             for t in (0.0, 1.0, 12.0, 13.0, 14.0)]
    br = _breakers_step(steps)(dict(max_restarts=3, window_secs=10.0))
    assert br.state == "open"
    br2 = CrashLoopBreaker(max_restarts=3, window_secs=10.0)
    assert [br2.record_crash(t) for t in (0.0, 1.0, 12.0, 13.0, 14.0)] == \
        ["closed"] * 4 + ["open"]


# -- restart / quarantine / alert --------------------------------------------

def test_restart_backoff_quarantine_alert_and_recovery(tmp_path):
    p = Pair(tmp_path, breaker_max_restarts=3, breaker_window_secs=60.0,
             breaker_quarantine_secs=50.0,
             backoff=BackoffPolicy(retries=10**6, base_secs=0.5, factor=2.0,
                                   max_secs=30.0, jitter=0.25))
    t = 1000.0
    p.both(lambda s: s._scale_up(t))
    tick = lambda now: p.both(lambda s: s._member_tick(s.slots[0], now))  # noqa: E731
    die = lambda rc: p.both(lambda s: s.slots[0].handle.die(rc))  # noqa: E731
    sup = p.port
    slot = sup.slots[0]
    br = sup._breaker_of(slot.owner)
    assert slot.state(br) == "running"

    die(3)
    tick(t + 1)
    assert slot.handle is None and slot.restarts == 1
    assert slot.next_spawn_at == pytest.approx(t + 1.5)
    tick(t + 1.2)
    assert slot.handle is None and slot.state(br) == "restarting"
    tick(t + 1.6)
    assert slot.handle is not None

    die(1)
    tick(t + 2)
    assert slot.next_spawn_at == pytest.approx(t + 3.0)
    tick(t + 3.1)

    die(1)
    tick(t + 4)
    assert br.state == "open"
    assert slot.state(br) == "quarantined"
    assert slot.next_spawn_at == 0.0
    tick(t + 20)
    assert slot.handle is None

    p.both(lambda s: s._write_status("supervising"))
    doc = json.load(open(sup.status_path))
    assert doc["kind"] == "supervisor"
    assert doc["breakers"][slot.owner]["state"] == "open"
    assert doc["members"][0]["state"] == "quarantined"
    ref_doc = json.load(open(p.ref.status_path))
    skip = ("owner", "pid", "host", "started_at", "heartbeat_at", "uptime_s")
    assert {k: v for k, v in doc.items() if k not in skip} == \
        {k: v for k, v in ref_doc.items() if k not in skip}
    book = json.load(open(os.path.join(sup.opts.queue_dir, ALERTS_NAME)))
    entry = book["alerts"][f"supervisor_crash_loop:{slot.owner}"]
    assert entry["state"] == "firing" and entry["severity"] == "page"
    fired = [a for a in evaluate([sup.store_base], [sup.opts.queue_dir])
             if a.rule == "supervisor_crash_loop"]
    assert len(fired) == 1 and fired[0].subject == slot.owner

    tick(t + 56)
    assert slot.handle is not None and br.state == "half_open"
    tick(t + 62)
    assert br.state == "closed" and slot.backoff_i == 0
    p.both(lambda s: s._write_status("supervising"))
    book = json.load(open(os.path.join(sup.opts.queue_dir, ALERTS_NAME)))
    entry = book["alerts"][f"supervisor_crash_loop:{slot.owner}"]
    assert entry["state"] == "resolved"


def test_wedged_heartbeat_is_killed_then_restarted(tmp_path):
    p = Pair(tmp_path, stale_secs=10.0)
    t = 1000.0
    p.both(lambda s: s._scale_up(t))
    p.status_doc("fleet-0", {"owner": "fleet-0", "pid": 1,
                             "state": "draining", "heartbeat_at": t - 20})
    p.both(lambda s: s._member_tick(s.slots[0], t + 15))
    slot = p.port.slots[0]
    assert slot.wedged is True
    assert slot.handle.signals == [signal.SIGKILL]
    p.both(lambda s: s.slots[0].handle.die(-9))
    p.both(lambda s: s._member_tick(s.slots[0], t + 16))
    assert slot.restarts == 1 and slot.wedged is False
    assert p.port.counters["wedged"] == 1


def test_clean_exit_is_not_a_crash(tmp_path):
    p = Pair(tmp_path)
    t = 1000.0
    p.both(lambda s: s._scale_up(t))
    p.both(lambda s: s.slots[0].handle.die(0))
    p.both(lambda s: s._member_tick(s.slots[0], t + 1))
    slot = p.port.slots[0]
    assert slot.restarts == 0 and slot.clean_exits == 1
    assert p.port._breaker_of(slot.owner).restarts == []


# -- scaling policy ----------------------------------------------------------

def _fake_backlog(monkeypatch, rec):
    fake = (lambda stores, queues, max_daemons=None,
            quarantined_owners=None: {"recommended_daemons": rec["n"]})
    monkeypatch.setattr(ref_sup, "backlog_summary", fake)
    monkeypatch.setattr(port_sup, "backlog_summary", fake)


def test_scaling_hysteresis_cooldown_and_poison_suppression(
        tmp_path, monkeypatch):
    p = Pair(tmp_path, min_daemons=1, max_daemons=4, scale_hold_ticks=3,
             cooldown_secs=10.0)
    rec = {"n": 1}
    _fake_backlog(monkeypatch, rec)
    t = 1000.0
    scale = lambda dt: p.both(lambda s: s._scale_tick(t + dt))  # noqa: E731
    sup = p.port
    p.both(lambda s: s._scale_up(t))
    assert sup._active_n() == 1

    rec["n"] = 3
    scale(1)
    rec["n"] = 1
    for dt in (2, 3, 4):
        scale(dt)
    assert sup._active_n() == 1
    assert sup.counters["scale_up"] == 1

    rec["n"] = 3
    for dt in (5, 6, 7):
        scale(dt)
    assert sup._active_n() == 2
    for dt in (8, 9):
        scale(dt)
    assert sup._active_n() == 2
    for dt in (18, 19, 20):
        scale(dt)
    assert sup._active_n() == 3

    rec["n"] = 4
    for mod in (ref_sup, port_sup):
        monkeypatch.setattr(mod.Supervisor, "_poison_dominated",
                            lambda s: True)
    for dt in (31, 32, 33, 34):
        scale(dt)
    assert sup._active_n() == 3
    assert sup._scaling_state["suppressed_poison"] is True
    for mod in (ref_sup, port_sup):
        monkeypatch.setattr(mod.Supervisor, "_poison_dominated",
                            lambda s: False)

    rec["n"] = 1
    youngest = max((s for s in sup.slots.values()), key=lambda s: s.k)
    for dt in (45, 46, 47):
        scale(dt)
    assert youngest.stopping is True
    assert youngest.handle.signals == [signal.SIGTERM]
    assert all(not s.stopping for s in sup.slots.values()
               if s is not youngest)
    assert sup._scaling_state["desired"] >= 1


def test_recommendation_is_clamped_by_max_daemons(tmp_path, monkeypatch):
    p = Pair(tmp_path, min_daemons=1, max_daemons=2, scale_hold_ticks=1,
             cooldown_secs=0.0)
    fake = (lambda stores, queues, max_daemons=None,
            quarantined_owners=None: {
                "recommended_daemons": min(50, max_daemons or 50)})
    monkeypatch.setattr(ref_sup, "backlog_summary", fake)
    monkeypatch.setattr(port_sup, "backlog_summary", fake)
    t = 1000.0
    p.both(lambda s: s._scale_up(t))
    for dt in range(1, 6):
        p.both(lambda s: s._scale_tick(t + dt))
    assert p.port._active_n() == 2


def test_max_daemons_defaults_to_the_visible_cards_on_cuda(
        tmp_path, monkeypatch):
    """ROADMAP Queue 3 item 21: with no ``--max-daemons`` a ``cuda``
    supervisor sizes the fleet by the visible cards (faked here), a ``cpu``
    one by the host's cores as the reference does; an explicit value is
    honoured on either, and it clamps the recommendation."""
    monkeypatch.setattr(port_sup, "cuda_cards", lambda: 3)
    assert _sup(port_sup, str(tmp_path / "a"), device="cuda").max_daemons \
        == 3
    assert _sup(port_sup, str(tmp_path / "b"), device="cuda",
                max_daemons=7).max_daemons == 7
    cpu = _sup(port_sup, str(tmp_path / "c"), device="cpu")
    assert cpu.max_daemons == _sup(ref_sup, str(tmp_path / "d")).max_daemons
    assert cpu.max_daemons == (os.cpu_count() or 4)
    assert SupervisorOpts(queue_dir="q", store_path="s").device == "cuda"
    monkeypatch.setattr(port_sup, "cuda_cards", lambda: 1)
    one = _sup(port_sup, str(tmp_path / "e"), device="cuda",
               scale_hold_ticks=1, cooldown_secs=0.0)
    monkeypatch.setattr(port_sup, "backlog_summary",
                        lambda stores, queues, max_daemons=None,
                        quarantined_owners=None: {
                            "recommended_daemons": 8})
    one._scale_up(1000.0)
    for dt in range(1, 6):
        one._scale_tick(1000.0 + dt)
    assert one._active_n() == 1  # one measuring member on the one card


@pytest.mark.parametrize("visible, present, want", [
    (None, 2, 2), ("", 2, 0), ("-1", 2, 0), ("0", 2, 1), ("0,1", 2, 2),
    ("1,-1,0", 2, 1), ("0,5,1", 2, 1), ("3", 2, 0), ("0,1,2", 2, 2),
    ("GPU-8f6c,1", 2, 2), ("x", 1, 0), ("0", 0, 0)])
def test_visible_cards_read_like_the_cuda_runtime(visible, present, want):
    """The card count a ``cuda`` supervisor sizes its fleet by stops at the
    first entry of ``CUDA_VISIBLE_DEVICES`` that names no card, as the CUDA
    runtime does: ``-1`` hides every card."""
    from tenzing_tpu_torch.serve.daemon import visible_cards

    assert visible_cards(visible, present) == want


def test_cuda_supervisor_without_a_card_spawns_nothing(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(port_sup, "cuda_cards", lambda: 0)
    spawned = []
    sup = _sup(port_sup, str(tmp_path / "x"), device="cuda", max_daemons=1,
               spawn=lambda o, s: spawned.append(s) or FakeHandle(s.owner))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sup.run()
    assert spawned == []
    assert not os.path.exists(os.path.join(sup.opts.queue_dir,
                                           port_sup.LEASE_NAME))
    assert port_sup.main(["--queue", str(tmp_path / "q2"), "--store",
                          str(tmp_path / "s2")]) == 1


# -- adoption ----------------------------------------------------------------

def test_adoption_from_live_status_docs(tmp_path):
    p = Pair(tmp_path, owner_prefix="fleet")
    now = time.time()
    sleeper = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        def doc(owner, **kw):
            p.status_doc(owner, {"owner": owner, "pid": sleeper.pid,
                                 "state": "draining", "heartbeat_at": now,
                                 "started_at": now - 5, **kw})

        doc("fleet-0")
        doc("fleet-1", state="stopped")
        doc("fleet-2", heartbeat_at=now - 9999)
        doc("fleet-3", pid=2 ** 30)
        assert p.both(lambda s: s._adopt(now)) == 1
        sup = p.port
        assert sorted(sup.slots) == [0]
        slot = sup.slots[0]
        assert slot.adopted is True
        assert slot.handle.pid == sleeper.pid
        assert sup.counters["adopted"] == 1

        sleeper.kill()
        sleeper.wait()
        t = time.time()
        p.both(lambda s: s._member_tick(s.slots[0], t))
        assert slot.handle is None and slot.restarts == 1
    finally:
        if sleeper.poll() is None:
            sleeper.kill()
            sleeper.wait()


# -- scale-down under load: zero loss ----------------------------------------

def _stub_member_spawner(drain_secs):
    """Real in-process DrainDaemons on the CPU (the whole lease, claim and
    status protocol) with a fixed-cost stub drain."""
    from tenzing_tpu_torch.serve.daemon import DaemonOpts, DrainDaemon

    def runner(item_path, payload, timeout):
        time.sleep(drain_secs)
        return {"metric": "stub", "value": 1.0, "unit": "us"}

    class _Handle:
        def __init__(self, daemon):
            self._daemon = daemon
            self.returncode = None

            def go():
                daemon.run()
                self.returncode = 0

            self.thread = threading.Thread(target=go, daemon=True)
            self.thread.start()

        def stop(self):                              # the SIGTERM path
            self._daemon.stop()

    def spawn(opts, slot):
        d = DrainDaemon(DaemonOpts(
            queue_dir=opts.queue_dir, store_path=opts.store_path,
            owner=slot.owner, handle_signals=False, in_process=True,
            idle_exit_secs=opts.member_idle_exit_secs or 0.3,
            poll_secs=0.05, lease_ttl_secs=opts.member_lease_ttl_secs,
            heartbeat_secs=0.2, backoff_base_secs=0.01, device=opts.device),
            runner=runner, log=lambda m: None)
        return _Handle(d)

    return spawn


def test_scale_down_under_load_loses_nothing(tmp_path):
    """SIGTERM the youngest member while the queue still drains: every item
    completes exactly once, by the status-history audit."""
    sup = _sup(port_sup, str(tmp_path), spawn=_stub_member_spawner(0.3),
               min_daemons=2, max_daemons=2, tick_secs=0.05,
               heartbeat_secs=0.5, scale_hold_ticks=10**6,
               member_idle_exit_secs=0.4, drain_exit=True,
               max_run_secs=60.0)
    q = WorkQueue(sup.opts.queue_dir)
    fps = []
    for i in range(6):
        req = DriverRequest(workload="spmv", m=512 + 200 * i)
        fp = fingerprint_of(req, platform="cpu")
        q.enqueue(fp, req.to_json(), reason="cold")
        fps.append(fp.exact_digest)

    out = {}
    th = threading.Thread(target=lambda: out.update(sup.run()), daemon=True)
    th.start()
    t0 = time.time()
    while time.time() - t0 < 20.0:
        running = [s for s in sup.slots.values()
                   if s.handle is not None and not s.stopping]
        if len(running) == 2 and q.leases():
            break
        time.sleep(0.02)
    else:
        pytest.fail("two members never started draining")
    sup._scale_down(time.time())
    th.join(timeout=60.0)
    assert not th.is_alive(), "supervisor never drained"

    assert out["reason"] == "drained"
    assert out["double_runs"] == {}
    assert out["audit_complete"] is True
    assert out["queue_after"] == 0 and len(q) == 0
    assert sup.counters["scale_down"] == 1
    assert set(out["completed_by"]) == set(fps)
    assert all(len(v) == 1 for v in out["completed_by"].values())
    assert out["device"] == "cpu" and out["cuda_initialized"] is False
    assert supervisor_exit_code(out) == 0


# -- retention GC ------------------------------------------------------------

def _gc_tree(d, now):
    os.makedirs(d)
    old = now - 7200

    def status(owner, state, hb):
        with open(os.path.join(d, f"status-{owner}.json"), "w") as f:
            json.dump({"owner": owner, "state": state,
                       "heartbeat_at": hb}, f)

    def aged(path, text="{}"):
        with open(path, "w") as f:
            f.write(text)
        os.utime(path, (old, old))

    status("dead", "stopped", old)
    status("gone", "interrupted", old)
    status("fresh", "stopped", now - 10)
    status("wedged", "draining", old)
    status("keep-0", "stopped", old)
    aged(os.path.join(d, "metrics-dead-0.json"))
    aged(os.path.join(d, "metrics-dead-1.json"))
    aged(os.path.join(d, "metrics-wedged-0.json"))
    aged(os.path.join(d, "alerts-dead.json"),
         json.dumps({"alerts": {"x": {"state": "resolved"}}}))
    aged(os.path.join(d, "alerts-loud.json"),
         json.dumps({"alerts": {"x": {"state": "firing"}}}))
    os.makedirs(os.path.join(d, "exemplars"))
    aged(os.path.join(d, "exemplars", "exemplar-1.jsonl"))
    os.makedirs(os.path.join(d, "reqlog", "exemplars"))
    aged(os.path.join(d, "reqlog", "exemplars", "exemplar-2.jsonl"))


def test_gc_sweeps_dead_owners_never_live_ones(tmp_path):
    now = time.time()
    d, r = str(tmp_path / "q"), str(tmp_path / "ref")
    _gc_tree(d, now)
    shutil.copytree(d, r)
    counts = gc_stale_artifacts([d], retention_secs=3600.0, now=now,
                                keep_owners=["keep-0"])
    assert counts == ref_sup.gc_stale_artifacts(
        [r], retention_secs=3600.0, now=now, keep_owners=["keep-0"])
    assert counts == {"status": 2, "metrics": 2, "alerts": 1,
                      "exemplars": 2}
    left = sorted(os.listdir(d))
    assert left == sorted(os.listdir(r))
    assert "status-dead.json" not in left and "status-gone.json" not in left
    for kept in ("status-fresh.json", "status-wedged.json",
                 "status-keep-0.json", "metrics-wedged-0.json",
                 "alerts-loud.json"):
        assert kept in left
    assert not os.listdir(os.path.join(d, "exemplars"))
    again = gc_stale_artifacts([d], retention_secs=3600.0, now=now,
                               keep_owners=["keep-0"])
    assert sum(again.values()) == 0


# -- spawner argv (golden) ---------------------------------------------------

def _capture(monkeypatch, mod):
    captured = {}

    def fake_popen(cmd, **kw):
        captured["cmd"], captured["kw"] = cmd, kw
        raise RuntimeError("captured")

    monkeypatch.setattr(mod.subprocess, "Popen", fake_popen)
    return captured


def _argv(monkeypatch, mod, slot, **kw):
    cap = _capture(monkeypatch, mod)
    opts = mod.SupervisorOpts(queue_dir="/q", store_path="/s",
                              listen_socket="/tmp/x.sock",
                              listen_args=["--busy-poll-us", "50"], **kw)
    with pytest.raises(RuntimeError):
        mod._subprocess_member_spawn(opts, slot)
    assert cap["kw"]["start_new_session"] is True
    return cap["cmd"]


def _drop_pair(cmd, flag):
    i = cmd.index(flag)
    return cmd[:i] + cmd[i + 2:], cmd[i + 1]


@pytest.mark.parametrize("idle", [None, 1.5])
def test_member_spawn_argv_matches_reference(monkeypatch, idle):
    """Each member's argv is the reference's for the same options, less the
    module name and the device pair (the daemons' ``--device``, the listen
    loop's ``--platform``)."""
    kw = dict(member_idle_exit_secs=idle, overrides={"iters": 3})
    ref = _argv(monkeypatch, ref_sup, MemberSlot(k=0, owner="fleet-0"), **kw)
    for device in ("cuda", "cpu"):
        cmd, dev = _drop_pair(_argv(monkeypatch, port_sup,
                                    MemberSlot(k=0, owner="fleet-0"),
                                    device=device, **kw), "--device")
        assert dev == device
        assert cmd[2] == "tenzing_tpu_torch.serve.daemon"
        assert ref[2] == "tenzing_tpu.serve.daemon"
        assert cmd[:2] + cmd[3:] == ref[:2] + ref[3:]
    listen = MemberSlot(k=-1, owner="fleet-listen", kind="listen")
    ref = _argv(monkeypatch, ref_sup, listen)
    cmd, plat = _drop_pair(_argv(monkeypatch, port_sup, listen,
                                 device="cpu"), "--platform")
    assert plat == "cpu"
    assert cmd[2] == "tenzing_tpu_torch.serve" and ref[2] == \
        "tenzing_tpu.serve"
    assert cmd[:2] + cmd[3:] == ref[:2] + ref[3:]


def test_member_spawn_argv_golden(monkeypatch):
    listen = MemberSlot(k=-1, owner="fleet-listen", kind="listen")
    cmd = _argv(monkeypatch, port_sup, listen)
    assert cmd[1:4] == ["-m", "tenzing_tpu_torch.serve", "listen"]
    assert cmd[4:] == ["--store", "/s", "--queue", "/q",
                       "--socket", "/tmp/x.sock",
                       "--owner", "fleet-listen", "--platform", "cuda",
                       "--busy-poll-us", "50"]
    cmd = _argv(monkeypatch, port_sup, MemberSlot(k=0, owner="fleet-0"))
    assert "--idle-exit" not in cmd
    assert "tenzing_tpu_torch.serve.daemon" in cmd
    assert cmd[-2:] == ["--device", "cuda"]
    cmd = _argv(monkeypatch, port_sup, MemberSlot(k=0, owner="fleet-0"),
                member_idle_exit_secs=1.5)
    assert cmd[cmd.index("--idle-exit") + 1] == "1.5"
    cmd = _argv(monkeypatch, port_sup, MemberSlot(k=2, owner="fleet-2"),
                member_argv=[sys.executable, "-c", "print('{owner}')"])
    assert cmd[-1] == "print('fleet-2')"


def test_supervisor_exit_code_matches_reference():
    docs = [
        {"reason": "lease_held"}, {"reason": "lease_lost"},
        {"reason": "drained", "double_runs": {"x": ["a", "b"]}},
        {"reason": "drained", "breakers": {"f-0": {"state": "open"}}},
        {"reason": "drained", "breakers": {"f-0": {"state": "half_open"}}},
        {"reason": "drained", "breakers": {"f-0": {"state": "closed"}}},
        {"reason": "signal", "double_runs": {}, "breakers": {"f-0": None}},
    ]
    got = [supervisor_exit_code(d) for d in docs]
    assert got == [ref_sup.supervisor_exit_code(d) for d in docs]
    assert got == [3, 4, 1, 1, 1, 0, 0]
