"""The port's trace replay (tenzing_tpu_torch/serve/replay.py) against the
JAX package's (tenzing_tpu/serve/replay.py; reference tests
test_replay_recorded.py), test for test: the listen loop records every
admitted request (served, shed and timed-out outcomes, batch members one by
one, kwargs verbatim), the snapshot's uptime and request-log position, the
per-tenant shed and timeout counters under their cap, and the trace rebuilt
from a recorded log (mix, workloads, inter-arrival QPS, off-schema records
skipped).  Then the port's own: ``--platform`` required and carried into
the document, one end-to-end replay on a tiny CPU corpus (a few dozen
queries, 8 noise samples) with the reference's keys, and a recorded replay
of the replay's own traffic.  Across the packages: the same seed gives the
same trace, and a log either package wrote gives the same rebuilt trace and
``recorded`` block.
"""

import json
import os
import threading
import time

import pytest

from tenzing_tpu.serve import replay as ref_replay
from tenzing_tpu.serve import reqlog as ref_reqlog
from tenzing_tpu_torch.bench.driver import DriverRequest
from tenzing_tpu_torch.obs.metrics import MetricsRegistry, set_metrics
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of
from tenzing_tpu_torch.serve.listen import ListenOpts, ServeLoop
from tenzing_tpu_torch.serve.replay import (
    REPLAY_VERSION,
    build_trace,
    main,
    run_replay,
    trace_from_recorded,
)
from tenzing_tpu_torch.serve.reqlog import RequestLog, read_request_log
from tenzing_tpu_torch.serve.store import ScheduleStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REQ = DriverRequest(workload="spmv", m=512)


class _StubService:
    def __init__(self, delay=0.0):
        self.delay = delay
        self.store = ScheduleStore(None)

    def query(self, req):
        from tenzing_tpu_torch.serve.resolver import Resolution

        if self.delay:
            time.sleep(self.delay)
        return Resolution(tier="exact", fingerprint=fingerprint_of(REQ),
                          provenance={"stub": True})

    def stats(self):
        return {"stub": True}


def _collect():
    docs, lock = [], threading.Lock()

    def respond(doc):
        with lock:
            docs.append(doc)

    return docs, respond


def _loop(tmp_path, delay=0.0, **opts):
    defaults = dict(max_pending=8, workers=1, request_timeout_secs=60.0,
                    handle_signals=False,
                    status_path=str(tmp_path / "status.json"),
                    record_dir=str(tmp_path / "reqlog"),
                    record_segment_records=4)
    defaults.update(opts)
    return ServeLoop(_StubService(delay=delay), ListenOpts(**defaults))


# -- the listen loop records -------------------------------------------------

def test_served_and_shed_outcomes_recorded(tmp_path):
    loop = _loop(tmp_path)
    loop.start()
    docs, respond = _collect()
    for i in range(3):
        loop.submit({"op": "query", "id": i, "tenant": "t-a",
                     "request": {"workload": "spmv", "m": 512 + i}},
                    respond)
    loop.stop()
    # intake stopped: this one sheds — and is still recorded (offered
    # load is offered load)
    loop.submit({"op": "query", "id": 9,
                 "request": {"workload": "spmv", "m": 900}}, respond)
    loop.drain(timeout=10.0)
    data = read_request_log(str(tmp_path / "reqlog"))
    assert len(data["records"]) == 4
    by_outcome = {}
    for r in data["records"]:
        by_outcome.setdefault(r["outcome"], []).append(r)
    assert len(by_outcome["served"]) == 3
    served = by_outcome["served"][0]
    # everything --from-recorded needs: verbatim kwargs, tier, digests,
    # latency + phases, the response's own trace id
    assert served["request"] == {"workload": "spmv", "m": 512}
    assert served["tier"] == "exact"
    assert served["workload"] == "spmv"
    assert served["exact"] and served["bucket"]
    assert served["resolve_us"] > 0
    assert "serialize" in served["phase_us"]
    assert served["tenant"] == "t-a"
    resp = next(d for d in docs if d.get("id") == 0)
    assert served["trace_id"] == resp["trace_id"]
    shed = by_outcome["shed"][0]
    assert shed["request"] == {"workload": "spmv", "m": 900}
    assert "tier" not in shed


def test_timeout_outcome_recorded(tmp_path):
    loop = _loop(tmp_path, delay=1.0, request_timeout_secs=0.2)
    loop.start()
    docs, respond = _collect()
    loop.submit({"op": "query", "id": 1,
                 "request": {"workload": "spmv", "m": 512}}, respond)
    t0 = time.time()
    while not docs and time.time() - t0 < 5.0:
        time.sleep(0.02)
    loop.drain(timeout=10.0)
    data = read_request_log(str(tmp_path / "reqlog"))
    outcomes = [r["outcome"] for r in data["records"]]
    assert outcomes == ["timeout"]
    assert data["records"][0]["error_class"] == "transient"
    assert data["records"][0]["request"] == {"workload": "spmv", "m": 512}


def test_batch_members_recorded_individually(tmp_path):
    loop = _loop(tmp_path)
    loop.start()
    docs, respond = _collect()
    loop.submit({"op": "batch", "id": 1, "tenant": "t-b", "requests": [
        {"workload": "spmv", "m": 512},
        {"request": {"workload": "spmv", "m": 513}, "tenant": "t-c"}]},
        respond)
    loop.drain(timeout=10.0)
    data = read_request_log(str(tmp_path / "reqlog"))
    assert len(data["records"]) == 2
    assert [r["op"] for r in data["records"]] == ["batch", "batch"]
    assert sorted(r["request"]["m"] for r in data["records"]) == [512, 513]
    # the per-member tenant override sticks
    assert sorted(r["tenant"] for r in data["records"]) == ["t-b", "t-c"]


def test_snapshot_carries_uptime_and_reqlog_position(tmp_path):
    loop = _loop(tmp_path)
    loop.start()
    docs, respond = _collect()
    loop.submit({"op": "query", "id": 0,
                 "request": {"workload": "spmv", "m": 512}}, respond)
    loop.submit({"op": "metrics", "id": 1}, respond)
    loop.drain(timeout=10.0)
    m = next(d for d in docs if d.get("id") == 1)["metrics"]
    assert m["uptime_s"] >= 0
    rl = m["reqlog"]
    assert rl["dir"] == str(tmp_path / "reqlog")
    assert rl["records"] + rl["buffered"] + rl["dropped_sampling"] >= 1
    # the drain sealed the buffer: the final summary shows it published
    # (the metrics op itself is liveness probing, never traffic)
    s = loop.summary()
    assert s["reqlog"]["buffered"] == 0
    assert s["reqlog"]["records"] == 1


def test_recording_off_by_default(tmp_path):
    loop = ServeLoop(_StubService(), ListenOpts(
        max_pending=8, workers=1, handle_signals=False,
        status_path=str(tmp_path / "status.json")))
    loop.start()
    docs, respond = _collect()
    loop.submit({"op": "query", "id": 0,
                 "request": {"workload": "spmv", "m": 512}}, respond)
    loop.drain(timeout=10.0)
    assert "reqlog" not in loop.summary()
    assert not os.path.exists(str(tmp_path / "reqlog"))


# -- per-tenant shed/timeout counters ---------------------------------------

def test_tenant_shed_and_timeout_counters_capped(tmp_path):
    reg = MetricsRegistry()
    prev = set_metrics(reg)
    try:
        loop = _loop(tmp_path, delay=1.0, request_timeout_secs=0.2,
                     tenant_cap=1, max_pending=8)
        loop.start()
        docs, respond = _collect()
        # t-a times out (admitted first: owns a per-tenant series)
        loop.submit({"op": "query", "id": 0, "tenant": "t-a",
                     "request": {"workload": "spmv", "m": 512}}, respond)
        t0 = time.time()
        while not docs and time.time() - t0 < 5.0:
            time.sleep(0.02)
        loop.stop()
        # draining: everything sheds; t-z is over the cap -> "other"
        loop.submit({"op": "query", "id": 1, "tenant": "t-a",
                     "request": {"workload": "spmv", "m": 512}}, respond)
        loop.submit({"op": "query", "id": 2, "tenant": "t-z",
                     "request": {"workload": "spmv", "m": 512}}, respond)
        loop.drain(timeout=10.0)
        assert reg.counter("serve.timeout.t-a").value == 1
        assert reg.counter("serve.shed.t-a").value == 1
        assert reg.counter("serve.shed.other").value == 1
        assert "serve.shed.t-z" not in reg.to_json()["counters"]
    finally:
        set_metrics(prev)


# -- trace reconstruction ----------------------------------------------------

def test_trace_from_recorded_roundtrip(tmp_path):
    d = str(tmp_path / "rl")
    rl = RequestLog(d, owner="t1", segment_records=8)
    tiers = ["exact"] * 6 + ["near", "near", "cold", "exact"]
    for i, tier in enumerate(tiers):
        rl.append({"v": 1, "ts": 1000.0 + i * 0.01,
                   "trace_id": f"{i:016x}", "op": "query",
                   "outcome": "served", "tier": tier,
                   "workload": "spmv" if i % 2 else "halo",
                   "resolve_us": 100.0,
                   "request": {"workload": "spmv" if i % 2 else "halo",
                               "m": 500 + i}})
    rl.flush()
    trace, info = trace_from_recorded(d)
    assert len(trace) == 10
    # arrival order, kwargs verbatim, tier as the kind
    assert [t["request"]["m"] for t in trace] == list(range(500, 510))
    assert trace[0]["kind"] == "exact" and trace[8]["kind"] == "cold"
    assert info["records"] == 10
    assert info["mix"] == {"cold": 0.1, "exact": 0.7, "near": 0.2}
    assert info["workloads"] == ["halo", "spmv"]
    # 10 requests over 90ms of inter-arrival -> ~111 qps
    assert info["qps_estimate"] == pytest.approx(100.0, rel=0.2)
    assert info["outcomes"] == {"served": 10}
    assert info["dropped_sampling"] == 0


def test_trace_from_recorded_includes_shed_and_empty_kwargs(tmp_path):
    d = str(tmp_path / "rl")
    rl = RequestLog(d, owner="t1")
    rl.append({"v": 1, "ts": 1.0, "trace_id": "a" * 16, "op": "query",
               "outcome": "shed", "request": {"workload": "halo"}})
    # {"op": "query"} with no body: a valid all-defaults DriverRequest —
    # a log of default-shape queries must not reconstruct as empty
    rl.append({"v": 1, "ts": 2.0, "trace_id": "b" * 16, "op": "query",
               "outcome": "served", "tier": "exact", "request": {}})
    rl.flush()
    trace, info = trace_from_recorded(d)
    assert len(trace) == 2  # shed = offered load; {} = defaults
    assert [t["kind"] for t in trace] == ["shed", "exact"]
    assert info["outcomes"] == {"served": 1, "shed": 1}


def test_trace_from_recorded_slow_stream_qps_not_zeroed(tmp_path):
    """A trickle recorded over minutes must estimate a small nonzero
    QPS (3-decimal rounding), not a falsy 0.0 that would silently
    repace the replay at the synthetic default."""
    d = str(tmp_path / "rl")
    rl = RequestLog(d, owner="t1")
    for i in range(10):  # 9 intervals over 900s -> 0.01 qps
        rl.append({"v": 1, "ts": 1000.0 + i * 100.0,
                   "trace_id": f"{i:016x}", "op": "query",
                   "outcome": "served", "tier": "exact",
                   "request": {"workload": "spmv", "m": 512}})
    rl.flush()
    _, info = trace_from_recorded(d)
    assert info["qps_estimate"] == 0.01


def test_trace_from_recorded_skips_off_schema_kwargs(tmp_path):
    """A shed/errored request's kwargs were recorded verbatim WITHOUT
    ever passing DriverRequest validation — an off-schema record must
    be skipped and counted, never crash the whole replay."""
    d = str(tmp_path / "rl")
    rl = RequestLog(d, owner="t1")
    rl.append({"v": 1, "ts": 1.0, "trace_id": "a" * 16, "op": "query",
               "outcome": "served", "tier": "exact", "resolve_us": 50.0,
               "request": {"workload": "spmv", "m": 512}})
    rl.append({"v": 1, "ts": 2.0, "trace_id": "b" * 16, "op": "query",
               "outcome": "error",
               "request": {"workload": "halo", "bogus_flag": 1}})
    rl.flush()
    notes = []
    trace, info = trace_from_recorded(d, log=notes.append)
    assert len(trace) == 1 and trace[0]["kind"] == "exact"
    assert info["records"] == 1 and info["unreplayable"] == 1
    assert any("unreplayable" in n for n in notes)


def test_trace_from_recorded_empty_raises(tmp_path):
    d = str(tmp_path / "rl")
    os.makedirs(d)
    with pytest.raises(ValueError):
        trace_from_recorded(d)


# -- the port's replay ----------------------------------------------------------------

# the reference's result document's keys (serve/replay.py run_replay) for a
# run with host noise and no recorded trace or fleet document
REF_KEYS = {"kind", "version", "n", "qps", "seed", "mix", "workloads",
            "pacing", "warm", "host_noise", "monolithic", "segmented",
            "exact_pct99_speedup"}


@pytest.fixture
def tiny_halo(tmp_path):
    """The first rows of a committed halo database (row 0 its naive
    anchor): enough to warm the full-width halo request a few records."""
    src = os.path.join(REPO, "experiments", "halo_search_tpu_r5a.csv")
    with open(src) as f:
        lines = f.readlines()[:25]
    path = str(tmp_path / "halo_tiny.csv")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def test_replay_requires_a_platform(tiny_halo, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--halo-csv", tiny_halo, "--spmv-csv", "--n", "4"])
    assert e.value.code == 2
    assert "--platform" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["--platform", "tpu", "--halo-csv", tiny_halo])
    with pytest.raises(ValueError):
        run_replay({"halo": [tiny_halo]}, "tpu", n=4)


def test_end_to_end_replay_then_replay_of_its_recording(tmp_path, tiny_halo,
                                                        capsys):
    """A synthetic replay on the CPU (its segmented path recording what it
    serves), then a replay of that recording; the documents carry the
    reference's keys plus the platform, every warmed record is stored
    under the CPU's fingerprint, the serving path calls no verifier, and
    each document checks ``ok`` against itself."""
    from tenzing_tpu_torch.obs.report import main as report_main
    from tenzing_tpu_torch.serve.store import open_store

    rec, wd = str(tmp_path / "rec"), str(tmp_path / "wd")
    out = str(tmp_path / "replay.json")
    assert main(["--platform", "cpu", "--halo-csv", tiny_halo, "--spmv-csv",
                 "--n", "36", "--qps", "400", "--noise-samples", "8",
                 "--record", rec, "--workdir", wd, "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["platform"] == "cpu" and line["segmented_verifier_calls"] == 0
    doc = json.load(open(out))
    assert set(doc) == REF_KEYS | {"platform"}
    assert doc["kind"] == "serve_trace_replay"
    assert doc["version"] == REPLAY_VERSION == ref_replay.REPLAY_VERSION
    assert doc["platform"] == "cpu" and doc["workloads"] == ["halo"]
    assert doc["n"] == 36 and doc["host_noise"]["samples"] == 8
    assert "300" not in doc["pacing"]["sustained_note"]
    assert doc["pacing"]["source"] == "override"
    seg, mono = doc["segmented"], doc["monolithic"]
    assert seg["verifier_calls"] == 0 and seg["shed"] == 0
    assert seg["resolve_us"]["exact"]["count"] == \
        mono["resolve_us"]["exact"]["count"] > 0
    assert mono["verifier_calls"] >= mono["resolve_us"]["exact"]["count"]
    assert doc["warm"]["halo"]["seg"]["added"] >= 1
    records = open_store(os.path.join(wd, "seg")).records()
    assert records and {r["fingerprint"]["platform"] for r in records} == \
        {"cpu"}
    assert report_main(["--check", out, "--baseline", out,
                        "--out", str(tmp_path / "r.md")]) == 0

    fleet = str(tmp_path / "fleet.json")
    json.dump({"kind": "fleet_scaling", "rows": []}, open(fleet, "w"))
    out2 = str(tmp_path / "replay2.json")
    assert main(["--platform", "cpu", "--from-recorded", rec,
                 "--halo-csv", tiny_halo, "--spmv-csv", "--noise-samples",
                 "8", "--fleet-json", fleet, "--out", out2]) == 0
    doc2 = json.load(open(out2))
    assert set(doc2) == REF_KEYS | {"platform", "recorded", "fleet_scaling"}
    assert doc2["recorded"]["records"] == doc2["n"] == 36
    assert doc2["recorded"]["workloads"] == ["halo"]
    assert doc2["pacing"]["source"] == "recorded-estimate"
    assert doc2["segmented"]["resolve_us"]["exact"]["count"] == \
        seg["resolve_us"]["exact"]["count"]
    assert doc2["fleet_scaling"]["kind"] == "fleet_scaling"
    # unreadable inputs are usage errors
    assert main(["--platform", "cpu", "--fleet-json",
                 str(tmp_path / "missing.json")]) == 2
    os.makedirs(str(tmp_path / "empty"))
    assert main(["--platform", "cpu", "--from-recorded",
                 str(tmp_path / "empty")]) == 2


# -- across the packages -------------------------------------------------------------

@pytest.mark.parametrize("seed,n,mix", [
    (7, 120, {"exact": 0.8, "near": 0.15, "cold": 0.05}),
    (1, 50, {"exact": 0.5, "cold": 0.5}),
    (42, 200, {"near": 1.0})])
def test_build_trace_is_the_references(seed, n, mix):
    for workloads in (["halo", "spmv"], ["halo"], ["spmv"]):
        assert build_trace(workloads, n, seed, mix) == \
            ref_replay.build_trace(workloads, n, seed, mix)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_trace_from_recorded_is_the_references(tmp_path, writer):
    """A log with served, shed, timed-out, batch, default-kwargs and
    off-schema records, written by either package, rebuilds into the same
    trace and ``recorded`` block in both."""
    import numpy as np

    rng = np.random.default_rng(3)
    d = str(tmp_path / "rl")
    cls = RequestLog if writer == "port" else ref_reqlog.RequestLog
    rl = cls(d, owner=writer, segment_records=7)
    ts = 1000.0
    for i in range(40):
        ts += float(rng.exponential(0.02))
        outcome = str(rng.choice(["served", "served", "shed", "timeout"]))
        req = [{"workload": "spmv", "m": 8192}, {}, {"workload": "halo"},
               {"workload": "spmv", "m": 4096},
               {"workload": "halo", "bogus": 1}][int(rng.integers(0, 5))]
        rec = {"v": 1, "ts": ts, "trace_id": f"{i:016x}",
               "op": str(rng.choice(["query", "batch", "ping"])),
               "outcome": outcome, "request": req}
        if outcome == "served":
            rec["tier"] = str(rng.choice(["exact", "near", "cold"]))
            rec["workload"] = req.get("workload", "halo")
        rl.append(rec)
    rl.flush()
    notes, ref_notes = [], []
    mine = trace_from_recorded(d, log=notes.append)
    ref = ref_replay.trace_from_recorded(d, log=ref_notes.append)
    assert mine == ref and notes == ref_notes
    assert mine[1]["unreplayable"] > 0 and mine[1]["records"] > 10
