"""The port's fleet supervisor under chaos, as the reference's chaos layer
(test_supervisor.py) runs it: ``python -m tenzing_tpu_torch.serve.supervisor
--device cpu`` subprocesses over a real queue, items queued under the
``cpu`` fingerprint (a daemon claims only its own platform's items).

* a member SIGKILLed mid-drain (its whole process group: the daemon and its
  drain child) is restarted, reclaims the expired item lease, resumes from
  the journal, and the item's effect lands once;
* a SIGKILLed supervisor's successor adopts the still-running member
  instead of spawning another, a third contender is refused by the
  controller lease (exit 3), and shutdown reaps the adopted member;
* a member that exits 3 on every spawn trips the breaker: the run ends
  quarantined, ``supervisor_crash_loop`` firing, exit 1.

Every wait is on evidence (status documents, journal lines, a lease's age),
none on a bare sleep.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from tenzing_tpu_torch.bench.driver import DriverRequest
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of
from tenzing_tpu_torch.serve.store import WorkQueue
from tenzing_tpu_torch.serve.supervisor import (
    ALERTS_NAME,
    LEASE_NAME,
    supervisor_exit_code,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 240  # each test's own time limit


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


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _wait_for(pred, timeout_s, what):
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("TENZING_FSINJECT", None)
    return env


def _sup_cmd(qdir, store, *extra):
    return [sys.executable, "-m", "tenzing_tpu_torch.serve.supervisor",
            "--queue", qdir, "--store", store, "--device", "cpu",
            "--min-daemons", "1", "--max-daemons", "1",
            "--tick", "0.2", "--heartbeat", "0.3",
            "--compact-interval", "0", "--gc-interval", "0",
            "--scale-hold-ticks", "1000000", *extra]


def test_chaos_member_sigkill_restart_resume_exactly_once(tmp_path):
    """A member SIGKILLed mid-drain is restarted through backoff; the new
    member reclaims the expired item lease, resumes from the checkpoint
    journal, and the item completes once: exit 0, a clean audit."""
    qdir = str(tmp_path / "q")
    store = str(tmp_path / "store.json")
    q = WorkQueue(qdir)
    req = DriverRequest(workload="attn", smoke=True, mcts_iters=6,
                        climb_budget=6, search_iters=2, iters=6,
                        inject_faults="transient:0.3:7,hang:0.05:11",
                        inject_hang_secs=1.0, measure_timeout=300.0)
    fp = fingerprint_of(req, platform="cpu")
    q.enqueue(fp, req.to_json(), reason="cold")
    ckpt = q.checkpoint_dir_for(fp.exact_digest)
    jpath = os.path.join(ckpt, "measurements.jsonl")

    def journal_lines():
        if not os.path.exists(jpath):
            return 0
        with open(jpath) as f:
            return sum(1 for line in f if line.strip())

    proc = subprocess.Popen(
        _sup_cmd(qdir, store, "--member-lease-ttl", "2",
                 "--member-heartbeat", "0.3", "--member-poll", "0.2",
                 "--member-idle-exit", "1.0", "--backoff-base", "0.3",
                 "--drain-exit"),
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        member = _wait_for(
            lambda: _read_json(os.path.join(qdir, "status-fleet-0.json")),
            60.0, "the member's status doc")
        _wait_for(lambda: journal_lines() >= 2, 120.0,
                  "two journaled measurements")
        prior = journal_lines()
        os.killpg(int(member["pid"]), signal.SIGKILL)
        out, err = proc.communicate(timeout=200)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    summary = json.loads(out.splitlines()[-1])
    assert summary["reason"] == "drained"
    assert summary["counters"]["restarts"] == 1
    assert summary["double_runs"] == {} and summary["audit_complete"]
    assert summary["queue_after"] == 0 and len(q) == 0
    assert summary["device"] == "cpu" and not summary["cuda_initialized"]
    log = open(os.path.join(ckpt, "drain.log")).read()
    resumes = [line for line in log.splitlines()
               if line.startswith("resume: ")]
    assert resumes, "the restarted drain must resume from the journal"
    assert int(resumes[-1].split()[1]) >= prior >= 2
    verdict = json.load(open(os.path.join(ckpt, "verdict.json")))
    assert verdict["fault"]["resumed"] is True
    assert verdict["device"]["name"] == "cpu"


def test_chaos_supervisor_sigkill_successor_adopts(tmp_path):
    """The successor adopts the still-running member from its live status
    document (no second spawn), a third contender exits 3 on the controller
    lease, and shutdown reaps the adopted member."""
    qdir = str(tmp_path / "q")
    store = str(tmp_path / "store")
    os.makedirs(store)

    a = subprocess.Popen(
        _sup_cmd(qdir, store, "--owner", "supA", "--lease-ttl", "1.5",
                 "--member-heartbeat", "0.3"),
        cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    b = None
    member = None
    try:
        member = _wait_for(
            lambda: _read_json(os.path.join(qdir, "status-fleet-0.json")),
            60.0, "the member's status doc")
        member_pid = int(member["pid"])
        _wait_for(lambda: (_read_json(
            os.path.join(qdir, "status-supervisor.json")) or {}
        ).get("owner") == "supA", 30.0, "supA's heartbeat")
        a.send_signal(signal.SIGKILL)
        a.wait()
        assert _pid_alive(member_pid)                # the member survived
        lease = os.path.join(qdir, LEASE_NAME)
        _wait_for(lambda: time.time() - os.path.getmtime(lease) > 1.7,
                  30.0, "supA's lease to expire")

        b = subprocess.Popen(
            _sup_cmd(qdir, store, "--owner", "supB", "--lease-ttl", "1.5",
                     "--member-heartbeat", "0.3", "--max-run-secs", "6"),
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        _wait_for(lambda: (_read_json(
            os.path.join(qdir, "status-supervisor.json")) or {}
        ).get("owner") == "supB", 30.0, "supB's takeover heartbeat")
        c = subprocess.run(
            _sup_cmd(qdir, store, "--owner", "supC", "--max-run-secs", "1"),
            cwd=REPO, env=_env(), capture_output=True, text=True,
            timeout=60)
        assert c.returncode == 3, c.stdout + c.stderr
        assert json.loads(c.stdout.splitlines()[-1])["reason"] == \
            "lease_held"

        bout, berr = b.communicate(timeout=60)
        assert b.returncode == 0, berr[-2000:]
        summary = json.loads(bout.splitlines()[-1])
        assert summary["reason"] == "max_run_secs"
        assert summary["counters"]["adopted"] == 1
        assert summary["counters"].get("spawned", 0) == 0, \
            "adoption must not double-spawn"
        assert summary["members"]["fleet-0"]["adopted"] is True
        _wait_for(lambda: not _pid_alive(member_pid), 30.0,
                  "the adopted member to be reaped")
    finally:
        for p in (a, b):
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate()
        if member is not None and _pid_alive(int(member["pid"])):
            try:
                os.killpg(int(member["pid"]), signal.SIGKILL)
            except OSError:
                pass


def test_chaos_crash_loop_member_ends_quarantined_rc1(tmp_path):
    """A member that exits 3 on every spawn trips the breaker: breaker open,
    ``supervisor_crash_loop`` firing in the ledger, exit 1."""
    qdir = str(tmp_path / "q")
    store = str(tmp_path / "store")
    os.makedirs(qdir)
    os.makedirs(store)
    r = subprocess.run(
        _sup_cmd(qdir, store, "--tick", "0.05", "--heartbeat", "0.1",
                 "--backoff-base", "0.05", "--backoff-max", "0.1",
                 "--breaker-max-restarts", "2", "--breaker-window", "60",
                 "--breaker-quarantine", "300", "--drain-exit",
                 "--member-argv", json.dumps(
                     [sys.executable, "-c", "import sys; sys.exit(3)"])),
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stdout + r.stderr
    summary = json.loads(r.stdout.splitlines()[-1])
    assert summary["breakers"]["fleet-0"]["state"] == "open"
    assert summary["counters"]["quarantined"] == 1
    assert summary["counters"]["restarts"] == 2
    assert summary["double_runs"] == {}
    book = json.load(open(os.path.join(qdir, ALERTS_NAME)))
    entry = book["alerts"]["supervisor_crash_loop:fleet-0"]
    assert entry["state"] == "firing"
    assert supervisor_exit_code(summary) == 1
