"""The port's drain fleet (tenzing_tpu_torch/serve/fleet.py) against the
reference's tests (test_serve_fleet.py), test for test, and against the
reference's functions where both compute the same thing: the member argv
(the reference's, less the module name and the ``--device`` pair), the
exactly-once audit over the same status documents and the CLI's exit code
on the same fleet documents, all compared exactly.

Scaling runs through :func:`stub_spawner` with ``device="cpu"``: real
in-process daemons, the lease protocol real, fixed-cost drains.  Items are
queued under the ``cpu`` fingerprint, since a daemon claims only its own
platform's items.
"""

import json
import os
import signal
import sys

import pytest

from tenzing_tpu.serve import fleet as ref_fleet
from tenzing_tpu_torch.bench.driver import DriverRequest
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of
from tenzing_tpu_torch.serve.fleet import (
    FleetOpts,
    _daemon_cmd,
    audit_completions,
    copy_queue_items,
    fleet_exit_code,
    measure_scaling,
    run_fleet,
    stub_spawner,
)
from tenzing_tpu_torch.serve.store import WorkQueue

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


def _enqueue_n(qdir, n=4):
    """n distinct spmv work items (distinct m, distinct digests) under the
    cpu fingerprint."""
    q = WorkQueue(qdir)
    fps = []
    for i in range(n):
        req = DriverRequest(workload="spmv", m=512 + 200 * i)
        fp = fingerprint_of(req, platform="cpu")
        q.enqueue(fp, req.to_json(), reason="cold")
        fps.append(fp)
    return q, fps


def test_fleet_scaling_two_daemons_four_items(tmp_path):
    """2 daemons drain a 4-item queue with no double run and a drain rate
    >= 1.5x the single daemon's on the same items.  Correctness holds on
    every attempt; the wall-clock outcomes (both members took part, the
    speedup) may take up to 4 attempts on a loaded host, as the
    reference's test allows."""
    src = str(tmp_path / "src-q")
    _enqueue_n(src, n=4)
    opts = FleetOpts(queue_dir=src, store_path="",
                     idle_exit_secs=0.25, poll_secs=0.05,
                     heartbeat_secs=0.5, owner_prefix="t", device="cpu")
    for attempt in range(4):
        doc = measure_scaling(opts, [1, 2],
                              str(tmp_path / f"scale{attempt}"),
                              log=lambda m: None,
                              spawn=stub_spawner(1.0),
                              drain_label="stub:1.0s")
        assert doc["kind"] == "drain_fleet_scaling"
        assert doc["drain"] == "stub:1.0s"
        assert doc["double_runs_total"] == 0
        by_n = {r["n_daemons"]: r for r in doc["rungs"]}
        for n in (1, 2):
            r = by_n[n]
            assert r["drained"] == 4, r
            assert r["queue_after"] == 0, r
            assert r["double_runs"] == {}, r
            assert r["audit_complete"] is True
        two = by_n[2]
        owners = {o for owners_ in two["completed_by"].values()
                  for o in owners_}
        if len(owners) == 2 and two["speedup_vs_n1"] >= 1.5:
            break
    assert len(owners) == 2, two["completed_by"]
    assert two["speedup_vs_n1"] >= 1.5, doc


def test_fleet_single_run_audit_and_rates(tmp_path):
    qdir = str(tmp_path / "q")
    _enqueue_n(qdir, n=3)
    opts = FleetOpts(queue_dir=qdir,
                     store_path=str(tmp_path / "store.json"),
                     n=2, idle_exit_secs=0.25, poll_secs=0.05,
                     heartbeat_secs=0.1, owner_prefix="s", device="cpu")
    doc = run_fleet(opts, spawn=stub_spawner(0.2), log=lambda m: None)
    assert doc["items_before"] == 3 and doc["drained"] == 3
    assert doc["queue_after"] == 0
    assert doc["double_runs"] == {}
    assert doc["drain_rate_per_s"] > 0
    assert len(doc["daemons"]) == 2
    assert all(d["rc"] == 0 for d in doc["daemons"])
    assert sorted(doc["completed_by"]) == sorted(
        fp.exact_digest for fp in _enqueue_n(str(tmp_path / "ref"), 3)[1])
    assert all(len(v) == 1 for v in doc["completed_by"].values())
    # the reference's audit over the status documents this fleet wrote
    owners = ["s-0", "s-1"]
    assert audit_completions(qdir, owners) == \
        ref_fleet.audit_completions(qdir, owners)


def _status_docs(qdir, docs):
    os.makedirs(qdir, exist_ok=True)
    for owner, doc in docs.items():
        with open(os.path.join(qdir, f"status-{owner}.json"), "w") as f:
            json.dump(doc, f)


AUDIT_CASES = {
    "double": {
        "f-0": {"counters": {"completed": 1},
                "history": [{"exact": "deadbeef", "outcome": "completed"}]},
        "f-1": {"counters": {"completed": 1},
                "history": [{"exact": "deadbeef", "outcome": "completed"}]}},
    "window": {
        "f-0": {"counters": {"completed": 5},
                "history": [{"exact": "a", "outcome": "completed"},
                            {"exact": "b", "outcome": "failed"}]},
        "f-1": {"counters": {"completed": 1},
                "history": [{"exact": "c", "outcome": "completed"},
                            {"exact": "a", "outcome": "interrupted"}]}},
    "clean": {
        "f-0": {"counters": {"completed": 2},
                "history": [{"exact": "b", "outcome": "completed"},
                            {"exact": "a", "outcome": "completed"}]},
        "f-1": {"counters": {}, "history": []}},
}


@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_audit_matches_reference(tmp_path, case):
    """The same status documents give the reference's audit exactly, with a
    missing member's document among the owners."""
    qdir = str(tmp_path / "q")
    _status_docs(qdir, AUDIT_CASES[case])
    owners = sorted(AUDIT_CASES[case]) + ["f-9"]
    got = audit_completions(qdir, owners)
    assert got == ref_fleet.audit_completions(qdir, owners)
    assert got["audit_complete"] is False


def test_audit_flags_double_runs(tmp_path):
    """A fabricated pair of status documents claiming one digest completed
    twice surfaces in double_runs."""
    qdir = str(tmp_path / "q")
    _status_docs(qdir, AUDIT_CASES["double"])
    audit = audit_completions(qdir, ["f-0", "f-1"])
    assert audit["double_runs"] == {"deadbeef": ["f-0", "f-1"]}
    assert audit["audit_complete"] is True
    audit2 = audit_completions(qdir, ["f-0", "f-1", "f-2"])
    assert audit2["audit_complete"] is False


def test_copy_queue_items_copies_only_items(tmp_path):
    src = str(tmp_path / "src")
    _enqueue_n(src, n=2)
    for name in ("lease-aaa.json", "fail-bbb.json", "poison-ccc.json",
                 "status-x.json"):
        with open(os.path.join(src, name), "w") as f:
            f.write("{}")
    os.makedirs(os.path.join(src, "ckpt-ddd"))
    dst = str(tmp_path / "dst")
    assert copy_queue_items(src, dst) == 2
    names = sorted(os.listdir(dst))
    assert len(names) == 2 and all(n.startswith("work-") for n in names)
    assert len(WorkQueue(dst)) == 2
    # the reference's copy takes the same files
    dst2 = str(tmp_path / "dst2")
    assert ref_fleet.copy_queue_items(src, dst2) == 2
    assert sorted(os.listdir(dst2)) == names


def _strip_device(cmd):
    i = cmd.index("--device")
    return cmd[:i] + cmd[i + 2:], cmd[i + 1]


ARGV_CASES = {
    "golden": dict(n=2, overrides={"mcts_iters": 6}, idle_exit_secs=3.0,
                   trace=True),
    "item_timeout_zero": dict(item_timeout_secs=0.0),
    "item_timeout_none": dict(item_timeout_secs=None),
    "knobs": dict(owner_prefix="p", idle_exit_secs=0.5, poll_secs=0.1,
                  lease_ttl_secs=8.0, heartbeat_secs=0.3, topk=5,
                  overrides={"iters": 3, "smoke": True}),
}


@pytest.mark.parametrize("case", sorted(ARGV_CASES))
def test_daemon_cmd_matches_reference(tmp_path, case):
    """The member argv is the reference's for the same options, less the
    module name and the ``--device`` pair (the fleet's device)."""
    kw = dict(ARGV_CASES[case])
    if kw.pop("trace", False):
        kw["trace_dir"] = str(tmp_path / "tr")
    ref = ref_fleet._daemon_cmd(ref_fleet.FleetOpts(
        queue_dir="Q", store_path="S", **kw), 1)
    for device in ("cuda", "cpu"):
        cmd, dev = _strip_device(_daemon_cmd(FleetOpts(
            queue_dir="Q", store_path="S", device=device, **kw), 1))
        assert dev == device
        assert cmd[:3] == [sys.executable, "-m",
                           "tenzing_tpu_torch.serve.daemon"]
        assert ref[:3] == [sys.executable, "-m", "tenzing_tpu.serve.daemon"]
        assert cmd[3:] == ref[3:]


def test_daemon_cmd_golden(tmp_path):
    opts = FleetOpts(queue_dir="Q", store_path="S", n=2,
                     overrides={"mcts_iters": 6},
                     trace_dir=str(tmp_path / "tr"),
                     idle_exit_secs=3.0)
    joined = " ".join(_daemon_cmd(opts, 1))
    assert "-m tenzing_tpu_torch.serve.daemon" in joined
    assert "--queue Q" in joined and "--store S" in joined
    assert "--owner fleet-1" in joined
    assert "--idle-exit 3.0" in joined
    assert "--override mcts_iters=6" in joined
    assert f"--trace-out {tmp_path / 'tr'}/daemon-1.jsonl" in joined
    assert joined.endswith("--device cuda")  # the default is the card


def test_fleet_items_keep_trace_ids(tmp_path):
    from tenzing_tpu_torch.obs import context as obs_context
    from tenzing_tpu_torch.serve.fleet import _item_traces

    qdir = str(tmp_path / "q")
    q = WorkQueue(qdir)
    req = DriverRequest(workload="spmv", m=512)
    ctx = obs_context.new_trace()
    fp = fingerprint_of(req, platform="cpu")
    q.enqueue(fp, req.to_json(), reason="cold", trace=ctx)
    assert _item_traces(q) == {fp.exact_digest: ctx.trace_id}


EXIT_DOCS = {
    "ok": {"kind": "drain_fleet", "double_runs": {}, "queue_after": 3,
           "daemons": [{"rc": 0}, {"rc": 0}]},
    "double": {"kind": "drain_fleet", "double_runs": {"x": ["a", "b"]},
               "daemons": [{"rc": 0}]},
    "dead": {"kind": "drain_fleet", "double_runs": {},
             "daemons": [{"rc": 0}, {"rc": 1, "error": "boom"}]},
    "none_rc": {"kind": "drain_fleet", "double_runs": {},
                "daemons": [{"rc": None}]},
    "scale_ok": {"kind": "drain_fleet_scaling", "double_runs_total": 0,
                 "rungs": [{"daemons": [{"rc": 0}]},
                           {"daemons": [{"rc": 0}, {"rc": 0}]}]},
    "scale_double": {"kind": "drain_fleet_scaling", "double_runs_total": 1,
                     "rungs": []},
    "scale_dead": {"kind": "drain_fleet_scaling", "double_runs_total": 0,
                   "rungs": [{"daemons": [{"rc": -9}]},
                             {"daemons": [{"rc": 0}, {"rc": 0}]}]},
}


def test_fleet_exit_code_policy():
    """Nonzero on a double run or a dead member; undrained items are data.
    Every document gives the reference's code."""
    want = {"ok": 0, "double": 1, "dead": 1, "none_rc": 0, "scale_ok": 0,
            "scale_double": 1, "scale_dead": 1}
    for name, doc in EXIT_DOCS.items():
        assert fleet_exit_code(doc) == want[name], name
        assert ref_fleet.fleet_exit_code(doc) == want[name], name


def test_daemon_cmd_item_timeout_zero_passes_through(tmp_path):
    """--item-timeout 0 disables the daemon's watchdog, so it passes through;
    None leaves the flag out."""
    opts = FleetOpts(queue_dir="Q", store_path="S", item_timeout_secs=0.0)
    assert "--item-timeout 0.0" in " ".join(_daemon_cmd(opts, 0))
    none_opts = FleetOpts(queue_dir="Q", store_path="S",
                          item_timeout_secs=None)
    assert "--item-timeout" not in " ".join(_daemon_cmd(none_opts, 0))


def test_fleet_cli_stub_scaling_and_no_card(tmp_path):
    """``python -m tenzing_tpu_torch.serve.fleet`` through ``main``: a stub
    scaling run on the CPU writes its document and exits 0; without
    ``--device cpu`` on a machine with no card it exits 1 before it starts
    a member, leaving the queue as it was."""
    import contextlib
    import io

    from tenzing_tpu_torch.serve import fleet

    src = str(tmp_path / "src")
    _enqueue_n(src, n=2)
    out = str(tmp_path / "fleet.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fleet.main(["--queue", src, "--device", "cpu", "--scale", "1",
                         "--workdir", str(tmp_path / "wd"),
                         "--stub-drain-secs", "0.05", "--idle-exit", "0.25",
                         "--poll", "0.05", "--out", out])
    assert rc == 0
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert doc == json.load(open(out))
    assert doc["rungs"][0]["drained"] == 2 and doc["drain"] == "stub:0.05s"
    if fleet.cuda_cards() == 0:
        assert fleet.main(["--queue", src, "--store",
                           str(tmp_path / "s.json")]) == 1
        assert len(WorkQueue(src)) == 2
