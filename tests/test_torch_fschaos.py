"""The port's hostile-filesystem drill (tenzing_tpu_torch/fault/fschaos.py)
against the reference's tests (test_fschaos.py), on the CPU.

The ``store_unwritable`` drill (an ENOSPC burst latches the store
read-only, the alert fires, the daemon pauses its claims; space frees, the
probe clears the latch, the alert resolves) and the ``--quick`` fleet run
(the supervisor and two members under the seeded fsinject spec, a member's
process group SIGKILLed mid-drain) both run here in tier 1: the fleet run
takes about 20 s on the CPU (the reference marks its own slow).  The items
are queued under the ``cpu`` fingerprint by the drill itself (``--device
cpu``).  Without ``--device cpu`` the drill exits 1 on a machine with no
card.
"""

import json
import os
import signal
import subprocess
import sys

import pytest

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


def _fschaos(tmp_path, *argv, timeout=200):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("TENZING_FSINJECT", None)
    return subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.fault.fschaos",
         "--workdir", str(tmp_path / "chaos"), *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_unwritable_drill_fires_and_resolves(tmp_path):
    """ENOSPC burst -> read-only latch -> alert fires -> daemon pauses;
    space freed -> probe clears the latch -> alert resolves."""
    p = _fschaos(tmp_path, "--skip-fleet", "--device", "cpu",
                 "--seed", "4242")
    assert p.returncode == 0, p.stdout + p.stderr
    verdict = json.loads(p.stdout.strip().splitlines()[-1])
    assert verdict["kind"] == "fschaos_verdict" and verdict["ok"]
    assert verdict["device"] == "cpu" and verdict["runs"] == []
    drill = verdict["drill"]
    assert drill["fired"] and drill["resolved"]
    assert drill["probe_write_denials"] > 0
    assert drill["injected"]["enospc"] == 1
    assert all(verdict["invariants"].values())


def test_fleet_survives_hostile_fs_with_sigkill(tmp_path):
    """One seeded hostile-filesystem fleet run: exactly-once effect, the
    service answering throughout, the killed member's process group gone,
    at least one restart, and every record the drain acknowledged in the
    final store.  The drill requires a record for every fingerprint (its
    reference's rule); on the CPU lanes run in turn, so no schedule is
    faster than naive there but by timing noise, and a drain may rightly
    acknowledge none.  Then the run fails with exactly that violation
    (exit 1), and with no other; with a record it passes (exit 0)."""
    p = _fschaos(tmp_path, "--quick", "--device", "cpu", "--seed", "777")
    verdict = json.loads(p.stdout.strip().splitlines()[-1])
    inv = verdict["invariants"]
    assert inv["exactly_once"] and inv["service_answered"]
    assert inv["unwritable_fired_and_resolved"]
    assert verdict["workload"] == "attn"
    (run,) = verdict["runs"]
    assert run["member_sigkilled"] is True
    assert run["summary"]["reason"] == "drained"
    assert run["summary"]["counters"]["restarts"] >= 1
    assert run["fsck"]["errors"] == []
    assert run["probe"]["probes"] > 0
    # every acknowledged record is in the store; the drain ran on (and
    # every stored record names) the CPU
    for rec in run["records"].values():
        assert rec["stored"] >= rec["acknowledged"]
    assert all(d["device"] == "cpu" for d in run["drains"].values())
    assert set(run["devices"]) <= {"cpu"}
    assert sum(run["fault_evidence"].values()) > 0
    if all(rec["stored"] >= 1 for rec in run["records"].values()):
        assert p.returncode == 0, p.stdout + p.stderr[-3000:]
        assert run["ok"] and run["violations"] == []
        assert inv["no_record_loss"] is True and verdict["ok"]
    else:
        assert p.returncode == 1, p.stdout + p.stderr[-3000:]
        assert inv["no_record_loss"] is False and not verdict["ok"]
        assert len(run["violations"]) == 1
        assert run["violations"][0].startswith("no record for")


def test_cuda_drill_without_a_card_exits_1(tmp_path):
    """The default device is the card; here there is none, so the drill
    exits 1 before it enqueues or starts anything."""
    from tenzing_tpu_torch.serve.daemon import cuda_cards

    if cuda_cards():
        pytest.skip("a card is present: the cuda drill would run")
    p = _fschaos(tmp_path, "--skip-fleet")
    assert p.returncode == 1
    assert "CUDA is not available" in p.stderr
    assert not os.path.exists(tmp_path / "chaos" / "drill")
