"""The port's drain daemon (tenzing_tpu_torch/serve/daemon.py) against the
reference's tests (test_daemon.py), test for test: leased claims, lease
loss, transient retries, poison after deterministic failures across
restarts, device loss stopping the daemon, two daemons with no double run,
graceful stop, the override identity guard, the queue's visible state, torn
items, a malformed item poisoned through the real child, and trace-context
propagation.  The chaos test kills a real drain (a CPU spmv search) and
holds effects that are true whichever schedule wins; the reference's, which
needs some CPU schedule to beat naive, is not taken as ground truth (ROADMAP
Queue 3 item 3).  Then the device rules: a daemon without ``--device cpu``
on a machine with no card exits non-zero before it claims anything; a CUDA
error in a drain is a device loss and exit code 1; a drained record names
the device that measured it and lands under the fingerprint of that
platform.
"""

import collections
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from tenzing_tpu.serve import daemon as ref_daemon
from tenzing_tpu_torch.bench.driver import DriverConfigError, DriverRequest
from tenzing_tpu_torch.fault.checkpoint import atomic_write_json, read_checked_json
from tenzing_tpu_torch.fault.errors import (
    DeterministicScheduleError,
    DeviceLostError,
    TransientError,
)
from tenzing_tpu_torch.serve.daemon import (
    DaemonOpts,
    DrainDaemon,
    apply_overrides,
    parse_override,
)
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of
from tenzing_tpu_torch.serve.store import ScheduleStore, WorkQueue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _enqueue(qdir, m=512, **req_kw):
    q = WorkQueue(qdir)
    req = DriverRequest(workload="spmv", m=m, **req_kw)
    fp = fingerprint_of(req, platform="cpu")
    q.enqueue(fp, req.to_json(), reason="cold")
    return q, fp


def _opts(tmp_path, **kw):
    base = dict(queue_dir=str(tmp_path / "q"),
                store_path=str(tmp_path / "store.json"),
                once=True, handle_signals=False, heartbeat_secs=0.1,
                backoff_base_secs=0.01, owner="t", device="cpu")
    base.update(kw)
    return DaemonOpts(**base)


def _ok_verdict(*_a, **_k):
    return {"metric": "m", "value": 1.0, "unit": "us", "vs_baseline": 1.2}


def test_drain_completes_deletes_item_and_lease_after_merge(tmp_path):
    q, fp = _enqueue(str(tmp_path / "q"))
    d = DrainDaemon(_opts(tmp_path),
                    runner=lambda p, pl, t: _ok_verdict(), log=lambda m: None)
    s = d.run()
    assert s["drained"] == 1 and s["counters"]["completed"] == 1
    assert len(q) == 0
    assert not os.path.exists(q.lease_path_for(fp.exact_digest))
    assert not os.path.exists(q.fail_path_for(fp.exact_digest))
    # the store was flushed by the merge step (empty drain CSV → 0
    # records admitted, but the store file exists and loads)
    assert os.path.exists(str(tmp_path / "store.json"))
    h = d.history[-1]
    assert h["outcome"] == "completed" and h["resumed"] is False
    # status JSON: the liveness document a probe reads
    st = json.load(open(d.status_path))
    assert st["owner"] == "t" and st["state"] == "stopped"
    assert st["counters"]["completed"] == 1
    assert st["history"][-1]["exact"] == fp.exact_digest


def test_claim_is_exclusive_and_lease_heartbeat_renews(tmp_path):
    q, fp = _enqueue(str(tmp_path / "q"))
    a = DrainDaemon(_opts(tmp_path, owner="a"), runner=_ok_verdict,
                    log=lambda m: None)
    b = DrainDaemon(_opts(tmp_path, owner="b"), runner=_ok_verdict,
                    log=lambda m: None)
    exact = fp.exact_digest
    lease = a._claim(exact)
    assert lease is not None
    assert b._claim(exact) is None  # fresh lease: rival must lose
    before = os.path.getmtime(lease)
    time.sleep(0.05)
    assert a._renew(lease) is True
    assert os.path.getmtime(lease) >= before
    doc = json.load(open(lease))
    assert doc["owner"] == "a" and doc["exact"] == exact
    a._release(lease)
    assert not os.path.exists(lease)


def test_expired_lease_is_reclaimed_live_lease_is_not(tmp_path):
    q, fp = _enqueue(str(tmp_path / "q"))
    exact = fp.exact_digest
    lease = q.lease_path_for(exact)
    with open(lease, "w") as f:
        json.dump({"owner": "dead-worker"}, f)
    past = time.time() - 999
    os.utime(lease, (past, past))
    d = DrainDaemon(_opts(tmp_path, lease_ttl_secs=60),
                    runner=lambda p, pl, t: _ok_verdict(), log=lambda m: None)
    s = d.run()
    assert s["counters"]["reclaimed"] == 1 and s["counters"]["completed"] == 1
    # fresh lease: not reclaimable, item not claimable
    q2, fp2 = _enqueue(str(tmp_path / "q2"), m=500)
    l2 = q2.lease_path_for(fp2.exact_digest)
    with open(l2, "w") as f:
        json.dump({"owner": "alive"}, f)
    d2 = DrainDaemon(_opts(tmp_path, queue_dir=str(tmp_path / "q2"),
                           lease_ttl_secs=300),
                     runner=lambda p, pl, t: _ok_verdict(),
                     log=lambda m: None)
    s2 = d2.run()
    assert s2["counters"]["claimed"] == 0 and len(q2) == 1


def test_renew_detects_lost_lease_by_nonce(tmp_path):
    q, fp = _enqueue(str(tmp_path / "q"))
    d = DrainDaemon(_opts(tmp_path), runner=_ok_verdict, log=lambda m: None)
    lease = d._claim(fp.exact_digest)
    # a rival reclaims during our stall: same path, rival's claim nonce
    # (inode numbers recycle on unlink, so the payload nonce is the
    # lease identity)
    os.unlink(lease)
    with open(lease, "w") as f:
        json.dump({"owner": "rival", "nonce": "rival-1-2"}, f)
    assert d._renew(lease) is False
    assert d._lease_lost.is_set()
    # and release must NOT delete a lease that is no longer ours
    d._release(lease)
    assert os.path.exists(lease)


def test_transient_failure_retries_then_leaves_item(tmp_path):
    q, fp = _enqueue(str(tmp_path / "q"))
    calls = []

    def flaky(item_path, payload, timeout):
        calls.append(1)
        raise TransientError("tunnel reset")

    d = DrainDaemon(_opts(tmp_path, retries=2), runner=flaky,
                    log=lambda m: None)
    s = d.run()
    assert len(calls) == 3  # 1 + 2 bounded retries (fault/backoff.py)
    assert s["counters"]["retried"] == 2
    assert s["counters"]["failed_transient"] == 1
    assert s["counters"]["poisoned"] == 0
    assert len(q) == 1  # the item survives for a later pass / worker
    # the failure history records the transient (economics, not poison)
    fails = json.load(open(q.fail_path_for(fp.exact_digest)))
    assert fails["attempts"][-1]["error_class"] == "transient"


def test_poison_after_n_deterministic_failures_survives_restarts(tmp_path):
    q, fp = _enqueue(str(tmp_path / "q"))
    exact = fp.exact_digest

    def broken(item_path, payload, timeout):
        raise DeterministicScheduleError("bad request, forever")

    # two separate daemon processes-worth of attempts: the count is
    # persistent (fail-<exact>.json), not in-memory
    d1 = DrainDaemon(_opts(tmp_path, max_failures=2), runner=broken,
                     log=lambda m: None)
    assert d1.run()["counters"]["poisoned"] == 0
    assert os.path.exists(q.fail_path_for(exact))
    d2 = DrainDaemon(_opts(tmp_path, max_failures=2), runner=broken,
                     log=lambda m: None)
    s2 = d2.run()
    assert s2["counters"]["poisoned"] == 1
    poison = read_checked_json(q.poison_path_for(exact))
    assert poison["kind"] == "poisoned_request"
    assert len(poison["attempts"]) == 2
    assert all(a["error_class"] == "deterministic"
               for a in poison["attempts"])
    assert poison["exact"] == exact
    assert poison["request"]["workload"] == "spmv"
    # item + sidecar are gone; the queue never offers the item again
    assert len(q) == 0
    assert not os.path.exists(q.fail_path_for(exact))
    d3 = DrainDaemon(_opts(tmp_path, max_failures=2), runner=broken,
                     log=lambda m: None)
    assert d3.run()["counters"]["claimed"] == 0
    # and the rot is visible: queue stats carry the poison set
    st = q.stats()
    assert st["poisoned"] == [f"poison-{exact}.json"]


def test_device_lost_stops_the_daemon(tmp_path):
    qdir = str(tmp_path / "q")
    q, _ = _enqueue(qdir, m=500)
    _enqueue(qdir, m=512)

    def dead(item_path, payload, timeout):
        raise DeviceLostError("chip rebooted")

    d = DrainDaemon(_opts(tmp_path, once=False, idle_exit_secs=30),
                    runner=dead, log=lambda m: None)
    s = d.run()  # must stop after the FIRST device-lost, not spin
    assert d.history[-1]["outcome"] == "device_lost"
    assert s["counters"]["claimed"] == 1
    assert len(q) == 2  # nothing consumed


def test_two_concurrent_daemons_zero_double_runs(tmp_path):
    """The acceptance bullet: two daemons, one multi-item queue, every
    item drained exactly once."""
    qdir = str(tmp_path / "q")
    for m in (500, 512, 520, 540):
        _enqueue(qdir, m=m)
    runs = collections.Counter()
    lock = threading.Lock()

    def runner(item_path, payload, timeout):
        with lock:
            runs[item_path] += 1
        time.sleep(0.15)  # hold the lease long enough for real overlap
        return _ok_verdict()

    ds = [DrainDaemon(_opts(tmp_path, owner=o), runner=runner,
                      log=lambda m: None) for o in ("a", "b")]
    ts = [threading.Thread(target=d.run) for d in ds]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(runs) == 4 and all(v == 1 for v in runs.values()), runs
    assert sum(d.counters["completed"] for d in ds) == 4
    assert len(WorkQueue(qdir)) == 0


def test_graceful_stop_releases_lease_and_stamps_interrupted(tmp_path):
    q, fp = _enqueue(str(tmp_path / "q"))
    d = DrainDaemon(_opts(tmp_path, once=False), log=lambda m: None)

    def slow(item_path, payload, timeout):
        d.stop()  # a stop request lands mid-drain...
        return _ok_verdict()  # ...the in-flight item still finishes

    d._runner = slow
    s = d.run()
    assert s["counters"]["completed"] == 1
    assert not os.path.exists(q.lease_path_for(fp.exact_digest))
    st = json.load(open(d.status_path))
    assert st["state"] in ("stopped", "interrupted")


def test_override_identity_guard_and_parsing():
    req = DriverRequest(workload="spmv", m=512).to_json()
    # budget overrides pass and apply
    eff = apply_overrides(req, {"mcts_iters": 4, "climb_budget": 2})
    assert eff.mcts_iters == 4 and eff.m == 512
    # identity overrides refuse: the merged record would land under a
    # different fingerprint than the queued request's
    with pytest.raises(DriverConfigError):
        apply_overrides(req, {"m": 4096})
    with pytest.raises(DriverConfigError):
        apply_overrides(req, {"no_such_field": 1})
    assert parse_override("mcts_iters=8") == ("mcts_iters", 8)
    assert parse_override("inject_faults=transient:0.3:7") == \
        ("inject_faults", "transient:0.3:7")
    with pytest.raises(ValueError):
        parse_override("not-a-pair")


def test_queue_stats_and_status_mine_daemon_state(tmp_path):
    """What the report reads from a queue directory alone: the poison set,
    live leases with their owner and heartbeat age, the torn set, and the
    daemon's status document with its per-item drain history; then the
    port's ``queue_section`` renders them as the reference's does."""
    from tenzing_tpu.obs.report import queue_section as ref_queue_section
    from tenzing_tpu_torch.obs.report import queue_section

    qdir = str(tmp_path / "q")
    q, fp = _enqueue(qdir)

    def broken(item_path, payload, timeout):
        raise DeterministicScheduleError("always broken")

    d = DrainDaemon(_opts(tmp_path, max_failures=1), runner=broken,
                    log=lambda m: None)
    d.run()
    q2, fp2 = _enqueue(qdir, m=500)
    with open(q.lease_path_for(fp2.exact_digest), "w") as f:
        json.dump({"owner": "someone", "nonce": "x"}, f)
    with open(os.path.join(qdir, "work-torn.json"), "w") as f:
        f.write("{")
    st = q.stats()
    assert st["poisoned"] == [f"poison-{fp.exact_digest}.json"]
    assert [(l["owner"], l["exact"]) for l in st["leases"]] == \
        [("someone", fp2.exact_digest)]
    assert st["leases"][0]["age_s"] >= 0
    assert st["torn"] == ["work-torn.json"] and st["depth"] == 1
    status = json.load(open(os.path.join(qdir, "status-t.json")))
    assert status["owner"] == "t" and status["state"] == "stopped"
    assert status["history"][-1]["exact"] == fp.exact_digest
    assert status["history"][-1]["outcome"] == "poisoned"
    snaps = [n for n in os.listdir(qdir) if n.startswith("metrics-t-")]
    assert snaps  # the metric-snapshot ring beside the status document
    text = "\n".join(queue_section(qdir))
    assert "poisoned" in text and fp.exact_digest[:12] in text
    assert "someone" in text  # the lease owner with its heartbeat age
    assert "work-torn.json" in text
    assert "daemon `t`" in text  # the status document
    assert "| item | outcome |" in text  # per-item drain economics
    # the reference renders the same lines, less the heartbeat ages
    # (wall clock between the two reads)
    def aged(lines):
        import re

        return [re.sub(r"\d+\.\d+s ago|\| \d+\.\d+ \|$", "AGE", ln)
                for ln in lines]

    assert aged(queue_section(qdir)) == aged(ref_queue_section(qdir))


def test_torn_item_is_counted_and_visible(tmp_path):
    from tenzing_tpu_torch.obs.metrics import get_metrics

    qdir = str(tmp_path / "q")
    q, fp = _enqueue(qdir)
    with open(os.path.join(qdir, "work-torn.json"), "w") as f:
        f.write("{")
    before = get_metrics().counter("serve.queue.torn").value
    items = q.items()
    assert len(items) == 1  # the drainer still never crashes on it
    assert [os.path.basename(p) for p in q.torn_paths] == ["work-torn.json"]
    assert get_metrics().counter("serve.queue.torn").value == before + 1
    # re-scanning the SAME damage does not inflate the counter...
    q.items()
    assert get_metrics().counter("serve.queue.torn").value == before + 1
    # ...but a rewrite (new damage) counts again
    time.sleep(0.01)
    with open(os.path.join(qdir, "work-torn.json"), "w") as f:
        f.write("{{")
    os.utime(os.path.join(qdir, "work-torn.json"))
    q.items()
    assert get_metrics().counter("serve.queue.torn").value >= before + 1
    # the torn set rides queue stats (serve stats / report CLI)
    assert "work-torn.json" in q.stats()["torn"]


# -- the chaos acceptance (real driver, real subprocesses) -------------------

def _lines(path):
    """The journal's complete JSON lines (a killed writer's torn tail is
    skipped, as the loader does)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    except OSError:
        pass
    return out


def _wait(cond, timeout_s, what):
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _admitted(csv, req, topk=3):
    """What a re-warm from ``csv`` admits: distinct schedule keys among the
    rows ``scored_rows`` scores, at most ``topk``."""
    from tenzing_tpu_torch.bench.driver import graph_for
    from tenzing_tpu_torch.bench.recorded import scored_rows
    from tenzing_tpu_torch.serve.fingerprint import schedule_key

    scored, _ = scored_rows([csv], graph_for(req)[0])
    return min(topk, len({schedule_key(seq) for _, _, seq, _ in scored}))


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def test_chaos_sigkill_mid_item_reclaim_resume_exactly_once(tmp_path):
    """SIGKILL the daemon and its drain child mid-item (a CPU spmv search
    under injected transient faults); a restarted daemon reclaims the
    expired lease and completes the item from the journal.  Effects that
    hold whichever schedule wins: the item is deleted once, the lease and
    every sidecar are gone, the journal was replayed and nothing in it was
    measured twice, the store holds what the drain's own database admits,
    and the successor drained under the envelope's trace id."""
    from tenzing_tpu_torch.obs.context import new_trace
    from tenzing_tpu_torch.obs.export import read_jsonl
    from tenzing_tpu_torch.serve.resolver import Resolver

    qdir = str(tmp_path / "q")
    store = str(tmp_path / "store.json")
    q = WorkQueue(qdir)
    req = DriverRequest(workload="spmv", smoke=True, mcts_iters=32, iters=3,
                        search_iters=2, inject_faults="transient:0.2:7",
                        measure_timeout=120.0)
    fp = fingerprint_of(req, platform="cpu")
    ctx = new_trace()
    q.enqueue(fp, req.to_json(), reason="cold", trace=ctx)
    exact = fp.exact_digest
    ckpt = q.checkpoint_dir_for(exact)
    journal = os.path.join(ckpt, "measurements.jsonl")

    daemon = subprocess.Popen(
        [sys.executable, "-m", "tenzing_tpu_torch.serve.daemon",
         "--queue", qdir, "--store", store, "--device", "cpu",
         "--poll", "0.2", "--heartbeat", "0.3", "--lease-ttl", "2"],
        cwd=REPO, env=_env(), start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        prior = len(_wait(lambda: len(_lines(journal)) >= 3 and
                          _lines(journal), 120, "3 journal lines"))
    finally:
        os.killpg(daemon.pid, signal.SIGKILL)
        daemon.wait()
    assert os.path.exists(q.lease_path_for(exact))
    assert len(q) == 1, "the item must survive the kill"
    before = _lines(journal)
    _wait(lambda: time.time() - os.path.getmtime(
        q.lease_path_for(exact)) > 2.2, 10, "the lease to expire")

    bundle = str(tmp_path / "daemon.jsonl")
    r = subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.serve.daemon",
         "--queue", qdir, "--store", store, "--device", "cpu", "--once",
         "--lease-ttl", "2", "--trace-out", bundle],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.loads(r.stdout.splitlines()[-1])
    assert summary["counters"]["reclaimed"] == 1, summary
    assert summary["counters"]["completed"] == 1, summary

    log = open(os.path.join(ckpt, "drain.log")).read()
    resumes = [ln for ln in log.splitlines() if ln.startswith("resume: ")]
    assert resumes, "the restarted drain must resume from the journal"
    assert int(resumes[-1].split()[1]) >= sum(
        1 for d in before if "batch" not in d) >= 1
    verdict = json.load(open(os.path.join(ckpt, "verdict.json")))
    assert verdict["fault"]["resumed"] is True
    assert verdict["verified"] is True
    # the CPU runs each kernel's plain version, which counts no launch
    assert verdict["launches"] == {}
    # nothing measured twice: every complete journal line is a distinct
    # measurement (schedule and fidelity) or batch
    after = _lines(journal)
    assert after[:prior] == before[:prior]
    keys = [json.dumps(d.get("batch") or [d["ops"], d["opts"]],
                       sort_keys=True) for d in after]
    assert len(keys) == len(set(keys))

    # exactly once: item, lease and sidecars gone; the store holds what the
    # drain's own database admits, measured on the CPU
    assert len(q) == 0
    left = sorted(n for n in os.listdir(qdir)
                  if n.startswith(("work-", "lease-", "fail-", "poison-")))
    assert left == []
    st = ScheduleStore(store)
    assert len(st) == _admitted(os.path.join(ckpt, "drain.csv"), req)
    for rec in st.records():
        assert rec["exact"] == exact
        assert rec["provenance"]["device"] == "cpu"
        assert rec["fingerprint"]["platform"] == "cpu"
    if len(st):
        res = Resolver(st, platform="cpu").resolve(req)
        assert res.tier == "exact" and res.provenance["compiles"] == 0

    spans = [rec for rec in read_jsonl(bundle)
             if rec.get("name") in ("daemon.drain", "serve.store.flush")]
    assert {s["name"] for s in spans} == {"daemon.drain", "serve.store.flush"}
    assert all(s["attrs"]["trace_id"] == ctx.trace_id for s in spans)


def test_malformed_item_poisons_through_the_real_child(tmp_path):
    """A deterministic-failure item (unknown workload → DriverConfigError
    before any backend touch) lands in the poison quarantine through the
    real subprocess runner — the error class crosses the process
    boundary via the verdict report, not stderr scraping."""
    qdir = str(tmp_path / "q")
    store = str(tmp_path / "store.json")
    q = WorkQueue(qdir)
    good = DriverRequest(workload="spmv", m=512)
    fp = fingerprint_of(good, platform="cpu")
    bad = good.to_json()
    bad["workload"] = "bogus"
    os.makedirs(qdir, exist_ok=True)
    atomic_write_json(q.path_for(fp.exact_digest), {
        "kind": "search_request", "reason": "cold",
        "fingerprint": fp.to_json(), "request": bad,
        "checkpoint": q.checkpoint_dir_for(fp.exact_digest),
    })
    r = subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.serve.daemon",
         "--queue", qdir, "--store", store, "--once", "--max-failures", "1",
         "--device", "cpu"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.loads(r.stdout.splitlines()[-1])
    assert summary["counters"]["poisoned"] == 1, summary
    poison = read_checked_json(q.poison_path_for(fp.exact_digest))
    assert poison["attempts"][-1]["error_class"] == "deterministic"
    assert "bogus" in poison["attempts"][-1]["message"]
    assert len(q) == 0


# -- trace-context propagation ------------------------------------------------

def test_drain_runs_under_item_trace_context(tmp_path):
    """The trace context stamped into the work-item envelope at enqueue
    is ambient for the whole drain: the daemon.drain span AND the store
    merge's serve.warm / serve.store.flush spans carry its trace_id."""
    from tenzing_tpu_torch.obs.context import new_trace
    from tenzing_tpu_torch.obs.tracer import Tracer, set_tracer

    qdir = str(tmp_path / "q")
    q = WorkQueue(qdir)
    req = DriverRequest(workload="spmv", m=512)
    fp = fingerprint_of(req, platform="cpu")
    ctx = new_trace()
    q.enqueue(fp, req.to_json(), reason="cold", trace=ctx)
    item = read_checked_json(q.path_for(fp.exact_digest))
    assert item["trace"] == ctx.to_json()

    tr = Tracer(enabled=True)
    prev = set_tracer(tr)
    try:
        d = DrainDaemon(_opts(tmp_path),
                        runner=lambda p, pl, t: _ok_verdict(),
                        log=lambda m: None)
        s = d.run()
        assert s["counters"]["completed"] == 1
    finally:
        set_tracer(prev)
    spans = {s.name: s for s in tr.spans()}
    assert spans["daemon.drain"].attrs["trace_id"] == ctx.trace_id
    assert spans["serve.warm"].attrs["trace_id"] == ctx.trace_id
    assert spans["serve.store.flush"].attrs["trace_id"] == ctx.trace_id
    # an item enqueued WITHOUT a trace drains unstamped (no leakage of
    # the previous item's context through the process default)
    q.enqueue(fp, req.to_json(), reason="cold")
    tr2 = Tracer(enabled=True)
    prev = set_tracer(tr2)
    try:
        DrainDaemon(_opts(tmp_path),
                    runner=lambda p, pl, t: _ok_verdict(),
                    log=lambda m: None).run()
    finally:
        set_tracer(prev)
    drain2 = [s for s in tr2.spans() if s.name == "daemon.drain"]
    assert drain2 and "trace_id" not in drain2[0].attrs


def test_exec_item_adopts_envelope_then_env_and_restores(tmp_path,
                                                         monkeypatch):
    """exec_item prefers the envelope's trace (the SIGKILL-survivable
    copy), falls back to the env var, and restores the process default
    on the way out (the in-process drain loop must not leak item N's
    context into item N+1)."""
    from tenzing_tpu_torch.obs import context as obs_context
    from tenzing_tpu_torch.obs.context import TRACE_ENV, new_trace
    from tenzing_tpu_torch.serve import daemon as daemon_mod

    seen = {}

    def fake_run(req, device=None):
        seen["ctx"] = obs_context.current()
        seen["device"] = device

        class R:
            verdict = {"metric": "m", "value": 1.0}

        return R()

    import tenzing_tpu_torch.bench.driver as driver_mod

    monkeypatch.setattr(driver_mod, "run", fake_run)
    q = WorkQueue(str(tmp_path / "q"))
    req = DriverRequest(workload="spmv", m=512)
    fp = fingerprint_of(req, platform="cpu")
    env_ctx = new_trace()
    monkeypatch.setenv(TRACE_ENV, env_ctx.to_env_value())
    # envelope wins over env
    envelope_ctx = new_trace()
    path = q.enqueue(fp, req.to_json(), reason="cold", trace=envelope_ctx)
    daemon_mod.exec_item(read_checked_json(path), path)
    assert seen["ctx"].trace_id == envelope_ctx.trace_id
    assert seen["device"] == "cuda"  # the default: the card
    assert obs_context.current() is None  # restored
    # env is the fallback when the envelope has no trace
    path = q.enqueue(fp, req.to_json(), reason="cold")
    daemon_mod.exec_item(read_checked_json(path), path, device="cpu")
    assert seen["ctx"].trace_id == env_ctx.trace_id
    assert seen["device"] == "cpu"
    assert obs_context.current() is None


# -- the device ----------------------------------------------------------------------

def test_no_card_daemon_exits_before_claiming(tmp_path):
    """Without a card (hidden here even on a machine that has one), a daemon
    that is not told ``--device cpu`` exits non-zero before it claims: the
    item stays queued, no lease, no failure record, no poison."""
    qdir = str(tmp_path / "q")
    q, fp = _enqueue(qdir)
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    for extra in ([], ["--in-process"]):
        r = subprocess.run(
            [sys.executable, "-m", "tenzing_tpu_torch.serve.daemon",
             "--queue", qdir, "--store", str(tmp_path / "s.json"), "--once",
             *extra], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=120)
        assert r.returncode != 0, r.stdout
        assert "CUDA is not available" in r.stderr
        assert len(q) == 1
        assert sorted(os.listdir(qdir)) == [f"work-{fp.exact_digest}.json"]
    # the library raises the same way
    d = DrainDaemon(_opts(tmp_path, device="cuda"), runner=_ok_verdict,
                    log=lambda m: None)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            d.run()
        assert d.counters["claimed"] == 0 and len(q) == 1


def test_cuda_error_in_a_drain_is_device_lost_exit_1(tmp_path, monkeypatch,
                                                     capsys):
    """A CUDA error raised by the drain classifies as ``device_lost``: the
    daemon stops after that item with exit code 1 (the reference's terminal
    verdict), the item stays queued and is not poisoned."""
    import tenzing_tpu_torch.bench.driver as driver_mod
    from tenzing_tpu_torch.serve import daemon as daemon_mod

    def lost(req, device=None):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(driver_mod, "run", lost)
    qdir = str(tmp_path / "q")
    q, fp = _enqueue(qdir, m=500)
    _enqueue(qdir, m=512)
    rc = daemon_mod.main(["--queue", qdir, "--store",
                          str(tmp_path / "s.json"), "--in-process",
                          "--device", "cpu", "--idle-exit", "30",
                          "--poll", "0.1", "--owner", "t"])
    assert rc == 1
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["counters"]["claimed"] == 1
    assert len(q) == 2 and not q.poisoned()
    fails = [json.load(open(os.path.join(qdir, n)))
             for n in os.listdir(qdir) if n.startswith("fail-")]
    assert [a["error_class"] for f in fails for a in f["attempts"]] == \
        ["device_lost"]


def test_drained_records_name_their_device_and_platform(tmp_path):
    """An in-process CPU drain (the real driver): the records it merges sit
    under the ``cpu`` fingerprint and carry ``device: "cpu"``; their count
    is what ``scored_rows`` admits from the drain's own database; a ``cuda``
    resolver does not answer from them."""
    from tenzing_tpu_torch.serve.resolver import Resolver

    qdir = str(tmp_path / "q")
    q = WorkQueue(qdir)
    req = DriverRequest(workload="spmv", smoke=True)
    fp = fingerprint_of(req, platform="cpu")
    q.enqueue(fp, req.to_json(), reason="cold")
    d = DrainDaemon(_opts(tmp_path, in_process=True, overrides=dict(
        mcts_iters=4, iters=3, search_iters=2)), log=lambda m: None)
    s = d.run()
    assert s["counters"]["completed"] == 1 and len(q) == 0
    ckpt = q.checkpoint_dir_for(fp.exact_digest)
    st = ScheduleStore(str(tmp_path / "store.json"))
    eff = apply_overrides(req.to_json(), d.opts.overrides)
    assert len(st) == _admitted(os.path.join(ckpt, "drain.csv"), eff)
    assert d.history[-1]["merged"] == len(st)
    for rec in st.records():
        assert rec["exact"] == fp.exact_digest
        assert rec["provenance"]["device"] == "cpu"
        assert rec["provenance"]["tenant"] == "daemon"
    if len(st):
        assert Resolver(st, platform="cpu").resolve(req).tier == "exact"
    assert Resolver(st, platform="cuda").resolve(req).tier == "cold"


@pytest.mark.parametrize("item,daemon", [("cuda", "cpu"), ("cpu", "cuda")])
def test_item_of_another_platform_stays_unclaimed(tmp_path, monkeypatch,
                                                  item, daemon):
    """A daemon claims only the items queued under its own platform's
    fingerprint: its records would not answer another's, whose query would
    stay cold and queue the item again.  The other item stays queued with
    no lease, failure record or poison, and the runner never sees it (the
    ``cuda`` daemon's device check is passed over: no card here)."""
    monkeypatch.setattr(DrainDaemon, "check_device", lambda self: None)
    qdir = str(tmp_path / "q")
    q = WorkQueue(qdir)
    req = DriverRequest(workload="spmv", m=512)
    other = fingerprint_of(req, platform=item)
    own = fingerprint_of(DriverRequest(workload="spmv", m=700),
                         platform=daemon)
    q.enqueue(other, req.to_json(), reason="cold")
    q.enqueue(own, DriverRequest(workload="spmv", m=700).to_json(),
              reason="cold")
    seen = []

    def runner(path, payload, timeout):
        seen.append(q.exact_of(path))
        return {**_ok_verdict(), "device": {"type": daemon, "name": daemon}}

    d = DrainDaemon(_opts(tmp_path, device=daemon), runner=runner,
                    log=lambda m: None)
    s = d.run()
    assert seen == [own.exact_digest]
    assert s["counters"]["claimed"] == 1 and s["counters"]["completed"] == 1
    assert [q.exact_of(p) for p, _ in q.items()] == [other.exact_digest]
    assert sorted(n for n in os.listdir(qdir) if not n.startswith(
        ("status-", "metrics-", "ckpt-", "."))) == \
        [f"work-{other.exact_digest}.json"]


def test_merge_refuses_an_item_its_records_would_not_answer(tmp_path):
    """An item whose file name is not the digest its request re-warms under
    (here a request edited after queueing) fails deterministically at the
    merge, with nothing stored: its records would never answer it."""
    qdir = str(tmp_path / "q")
    q, fp = _enqueue(qdir)
    path = q.path_for(fp.exact_digest)
    doc = read_checked_json(path)
    doc["request"] = DriverRequest(workload="spmv", m=100_000).to_json()
    atomic_write_json(path, doc)
    d = DrainDaemon(_opts(tmp_path, max_failures=1), runner=_ok_verdict,
                    log=lambda m: None)
    s = d.run()
    assert s["counters"]["poisoned"] == 1 and len(q) == 0
    poison = read_checked_json(q.poison_path_for(fp.exact_digest))
    assert "re-warms under fingerprint" in poison["attempts"][-1]["message"]
    assert not os.path.exists(str(tmp_path / "store.json"))


def test_exec_item_child_reports_its_own_launches(tmp_path, monkeypatch):
    """The ``--exec-item`` child's verdict carries the kernel launches of
    its drain, counted from 0 (counts from before the drain excluded)."""
    import tenzing_tpu_torch.bench.driver as driver_mod
    from tenzing_tpu_torch.ops import spmv_kernels
    from tenzing_tpu_torch.serve import daemon as daemon_mod

    def run(req, device=None):
        spmv_kernels.LAUNCHES.hit("ell_spmv", 3)
        return driver_mod.DriverResult(verdict=_ok_verdict())

    monkeypatch.setattr(driver_mod, "run", run)
    monkeypatch.setitem(spmv_kernels.LAUNCHES, "ell_spmv", 5)
    q, fp = _enqueue(str(tmp_path / "q"))
    out = str(tmp_path / "verdict.json")
    assert daemon_mod._exec_item_main(q.path_for(fp.exact_digest), out, {},
                                      "cpu") == 0
    assert json.load(open(out))["launches"] == {"ell_spmv": 3}


def test_overrides_match_the_reference():
    req = DriverRequest(workload="spmv", m=512).to_json()
    for spec in ("mcts_iters=8", "inject_faults=transient:0.3:7",
                 "measure_timeout=1.5", "resume=true", "dump_csv=null"):
        assert parse_override(spec) == ref_daemon.parse_override(spec)
    eff = apply_overrides(req, {"mcts_iters": 4, "climb_budget": 2})
    ref_eff = ref_daemon.apply_overrides(req, {"mcts_iters": 4,
                                               "climb_budget": 2})
    assert eff.to_json() == ref_eff.to_json()


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the drain runs on the card)")
    return torch.device("cuda")


@pytest.mark.needs_cuda
def test_cuda_drain_names_the_card(tmp_path, cuda_device):
    """An in-process drain on the card (the spmv smoke, the cut budget):
    its records sit under the ``cuda`` fingerprint with the card's name in
    their provenance, and a ``cuda`` re-query answers exact while a ``cpu``
    one does not."""
    import torch

    from tenzing_tpu_torch.serve.resolver import Resolver

    qdir = str(tmp_path / "q")
    q = WorkQueue(qdir)
    req = DriverRequest(workload="spmv", smoke=True)
    fp = fingerprint_of(req, platform="cuda")
    q.enqueue(fp, req.to_json(), reason="cold")
    d = DrainDaemon(_opts(tmp_path, in_process=True, device="cuda",
                          overrides=dict(mcts_iters=4, iters=3,
                                         search_iters=2)),
                    log=lambda m: None)
    s = d.run()
    assert s["counters"]["completed"] == 1 and len(q) == 0
    st = ScheduleStore(str(tmp_path / "store.json"))
    ckpt = q.checkpoint_dir_for(fp.exact_digest)
    eff = apply_overrides(req.to_json(), d.opts.overrides)
    assert len(st) == _admitted(os.path.join(ckpt, "drain.csv"), eff)
    for rec in st.records():
        assert rec["fingerprint"]["platform"] == "cuda"
        assert rec["provenance"]["device"] == torch.cuda.get_device_name(0)
    if len(st):
        assert Resolver(st, platform="cuda").resolve(req).tier == "exact"
        assert Resolver(st, platform="cpu").resolve(req).tier == "cold"
