"""The port's report and regression check (tenzing_tpu_torch/obs/report.py)
against the JAX package's (tenzing_tpu/obs/report.py; reference tests: the
report tests of test_attrib.py, the regression and follow-view tests of
test_obs_context.py, the read-only store section of test_serve_segments.py),
test for test: driver verdicts loaded raw or wrapped, the noise-aware check
(ok, regression, inconclusive) for driver verdicts and replay documents,
the mixed-family usage error, truncated histograms labeled prefix-only, the
store section leaving a damaged tree as it was, the follow view.  The
driver verdicts here are made up or come from a CPU run of the port's
driver: no committed ``BENCH_*.json`` serves as a baseline.  Then across
the packages: the same driver JSONs and replay documents give the same
verdicts and reasons, and the same inputs (a CPU run's database, verdict,
journal, trace and metrics; a store and a queue written by either package)
the same markdown, less wall-clock ages and the port's own table of its
driver blocks.
"""

import json
import os
import random
import re
import time

import pytest

from tenzing_tpu.obs import report as ref_report
from tenzing_tpu_torch.obs.report import (
    check_regression,
    check_serve_regression,
    dr_lines,
    fleet_lines,
    load_driver_json,
    main,
    queue_section,
    store_section,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALO_R5 = os.path.join(REPO, "experiments", "halo_search_tpu_r5*.csv")
NOW = 1_700_000_000.0


def _verdict(vs=1.25, value=40.0, naive=50.0, times=None, **extra):
    """A driver verdict of the port's shape: the blocks both packages'
    verdicts carry and the port's own (device, reported_schedule, gate)."""
    d = {"metric": "halo_iter_pct50_searched_n512", "value": value,
         "unit": "us", "vs_baseline": vs, "naive_us": naive,
         "verified": True,
         "device": {"type": "cuda", "name": "NVIDIA H100 80GB HBM3"},
         "reported_schedule": "0123456789abcdef0123",
         "gate": {"winner": {"precision": "f32", "limit": {},
                             "buffers": {"O": {"ok": True},
                                         "acc/l_run": {"ok": True}}},
                  "naive": {"precision": "f32", "limit": {},
                            "buffers": {"O": {"ok": True},
                                        "acc/l_run": {"ok": False}}}},
         "perf": {"compile_secs": 1.5,
                  "prefetch": {"hits": 3, "issued": 5}},
         "attrib": {"overlap_efficiency": 0.8,
                    "dispatch_overhead_us": 12.0}}
    if times is not None:
        d["attrib"]["measured_times"] = times
    d.update(extra)
    return d


def _write(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


# -- driver verdicts and the regression check -----------------------------------------

def test_load_driver_json_wrapper_and_raw(tmp_path):
    d = _verdict()
    wrapped = _write(tmp_path / "wrapped.json", {"parsed": d, "rc": 0})
    assert load_driver_json(wrapped) == d
    raw = tmp_path / "raw.json"
    raw.write_text("stderr noise\n" + json.dumps(d) + "\n")
    assert load_driver_json(str(raw)) == d
    (tmp_path / "none.json").write_text("no verdict\n")
    with pytest.raises(ValueError):
        load_driver_json(str(tmp_path / "none.json"))


def test_regression_check_passes_unmodified_baseline():
    d = _verdict()
    v = check_regression(d, d)
    assert v["verdict"] == "ok" and not v["reasons"]


def test_regression_check_flags_synthetic_slowdown():
    base = _verdict()
    slow = dict(base, vs_baseline=base["vs_baseline"] * 0.8)
    v = check_regression(slow, base)
    assert v["verdict"] == "regression"
    assert any("vs_baseline" in r for r in v["reasons"])
    # a slower relative value (value / naive) flags on its own
    v2 = check_regression(dict(base, value=base["value"] * 1.2), base)
    assert v2["verdict"] == "regression"
    v3 = check_regression(dict(base, vs_baseline=base["vs_baseline"] * 0.97),
                          base, tol=0.05)
    assert v3["verdict"] == "ok"


def test_regression_check_noise_aware_inconclusive():
    from tenzing_tpu_torch.bench.randomness import is_random

    base = _verdict()
    # a drifting series (monotone: two runs) downgrades to inconclusive
    slow = _verdict(vs=base["vs_baseline"] * 0.8,
                    times=[1.0 + 0.01 * i for i in range(20)])
    assert check_regression(slow, base)["verdict"] == "inconclusive"
    rng = random.Random(0)
    noisy = [1.0 + rng.uniform(-0.01, 0.01) for _ in range(20)]
    assert is_random(noisy)
    slow2 = _verdict(vs=base["vs_baseline"] * 0.8, times=noisy)
    assert check_regression(slow2, base)["verdict"] == "regression"


def test_report_cli_end_to_end(tmp_path):
    base = _write(tmp_path / "base.json", _verdict())
    out = tmp_path / "report.md"
    rc = main(["--csv", HALO_R5, "--bench", base, "--check", base,
               "--baseline", base, "--out", str(out)])
    assert rc == 0
    text = out.read_text()
    assert "## Recorded search databases" in text
    assert "## Driver verdicts" in text
    assert "verdict: ok" in text
    slow = _write(tmp_path / "slow.json", _verdict(vs=0.6))
    assert main(["--check", slow, "--baseline", base,
                 "--out", str(tmp_path / "r2.md")]) == 1
    # --check without --baseline is a usage error (argparse exits 2)
    with pytest.raises(SystemExit) as e:
        main(["--check", slow])
    assert e.value.code == 2


def test_report_labels_truncated_histograms(tmp_path):
    mpath = _write(tmp_path / "metrics.json", {
        "counters": {}, "gauges": {},
        "histograms": {
            "long.series": {"count": 100000, "sum": 12.0, "p50": 1.0,
                            "p99": 2.0, "raw_retained": 65536,
                            "truncated": True},
            # a summary without the truncated flag: raw_retained alone
            # still labels it prefix-only
            "old.series": {"count": 500, "sum": 5.0, "p50": 1.0,
                           "p99": 2.0, "raw_retained": 100},
            "win.series": {"count": 50, "sum": 2.0, "p50": 1.0,
                           "p99": 2.0, "raw_retained": 8, "window": True},
            "short.series": {"count": 10, "sum": 1.0, "p50": 0.1,
                             "p99": 0.2},
        }})
    out = tmp_path / "m.md"
    assert main(["--metrics", mpath, "--out", str(out)]) == 0
    text = out.read_text()
    assert "prefix-only (65536/100000)" in text
    assert "prefix-only (100/500)" in text
    assert "recent-window (8/50)" in text
    assert "| short.series | 10 | 1 | 0.1 | 0.2 | full |" in text


def test_bench_section_renders_the_port_blocks(tmp_path):
    """The blocks only the port's verdicts carry get a table of their own;
    the table both packages render is the reference's, line for line."""
    from tenzing_tpu_torch.obs.report import bench_section

    p = _write(tmp_path / "v.json", _verdict())
    mine = bench_section([p])
    assert _strip_port_table(mine) == ref_report.bench_section([p])
    text = "\n".join(mine)
    assert "### Device, reported schedule and result gate" in text
    assert ("| v.json | cuda (NVIDIA H100 80GB HBM3) | `0123456789abcdef` "
            "| winner f32 2/2 within limit; naive f32 1/2 within limit |"
            ) in text
    # a verdict without those blocks renders none
    bare = _write(tmp_path / "bare.json", {"metric": "m", "value": 1.0})
    assert "### Device" not in "\n".join(bench_section([bare]))


# -- replay documents -----------------------------------------------------------------

def _replay_doc(pct99, verifier=0, shed=0, samples=None):
    if samples is None:
        rng = random.Random(0)  # i.i.d.-looking: passes the runs test
        samples = [pct99 + rng.uniform(-5, 5) for _ in range(64)]
    return {
        "kind": "serve_trace_replay",
        "segmented": {
            "resolve_us": {"exact": {"pct99_us": pct99, "count": 100}},
            "verifier_calls": verifier,
            "shed": shed,
            "exact_samples_us": samples,
        },
    }


def test_check_serve_regression_ok_and_flagged():
    base = _replay_doc(260.0)
    ok = check_serve_regression(_replay_doc(280.0), base, tol=0.25)
    assert ok["verdict"] == "ok" and not ok["reasons"]
    bad = check_serve_regression(_replay_doc(400.0), base, tol=0.25)
    assert bad["verdict"] == "regression"
    assert any("pct99" in r for r in bad["reasons"])
    ver = check_serve_regression(_replay_doc(261.0, verifier=3), base,
                                 tol=0.25)
    assert ver["verdict"] == "regression"
    assert any("verifier" in r for r in ver["reasons"])
    sh = check_serve_regression(_replay_doc(261.0, shed=5), base, tol=0.25)
    assert any("shed" in r for r in sh["reasons"])


def test_check_serve_regression_noise_downgrades():
    base = _replay_doc(260.0)
    drifty = _replay_doc(900.0, samples=[100.0 + 10 * i for i in range(64)])
    v = check_serve_regression(drifty, base, tol=0.25)
    assert v["verdict"] == "inconclusive"
    assert "runs_test_z" in v["checks"]


def test_mixed_family_regression_check_is_a_usage_error(tmp_path):
    serve_doc = _write(tmp_path / "serve.json", _replay_doc(260.0))
    bench_doc = _write(tmp_path / "bench.json",
                       {"metric": "m", "value": 1.0, "vs_baseline": 1.2})
    assert main(["--check", serve_doc, "--baseline", bench_doc]) == 2
    assert main(["--check", bench_doc, "--baseline", serve_doc]) == 2
    assert main(["--check", serve_doc, "--baseline", serve_doc]) == 0


# -- the live view ------------------------------------------------------------------

def _loop_status(store, owner="svc", now=None, state="serving"):
    now = time.time() if now is None else now
    _write(os.path.join(store, f"status-{owner}.json"), {
        "kind": "serve_loop", "owner": owner, "state": state,
        "heartbeat_at": now, "queue_depth": 2, "in_flight": 1,
        "counters": {"requests": 10, "served_exact": 8, "served_near": 1,
                     "served_cold": 1, "shed": 3, "timeouts": 0}})


def _snapshot(d, owner, seq=0, now=None, state="serving"):
    now = time.time() if now is None else now
    _write(os.path.join(d, f"metrics-{owner}-{seq}.json"), {
        "kind": "metrics_snapshot", "owner": owner, "seq": seq,
        "written_at": now - 1 + seq, "state": state, "uptime_s": 12.0,
        "metrics": {"counters": {"serve.memo.hits": 6,
                                 "serve.memo.misses": 2,
                                 "serve.fp_cache.hits": 7,
                                 "serve.fp_cache.misses": 1},
                    "gauges": {"serve.queue_age_s": 1.5,
                               "serve.shed_rate": 0.0},
                    "histograms": {}},
        "tracer": {"dropped_spans": 0, "dropped_events": 0},
        "slo": {"histogram": "serve.resolve_us.exact", "pct99_us": 42.0,
                "target_us": 100.0, "within_target": True},
        "reqlog": {"records": 10, "segments": 1, "bytes": 100,
                   "buffered": 0, "dropped_sampling": 0}})


def test_fleet_lines_renders_serve_and_daemon_state(tmp_path):
    store = tmp_path / "store"
    queue = tmp_path / "queue"
    store.mkdir()
    queue.mkdir()
    now = time.time()
    _loop_status(str(store), now=now)
    _snapshot(str(store), "svc", now=now)
    _write(queue / "status-d1.json", {
        "owner": "d1", "state": "draining", "heartbeat_at": now,
        "item": {"exact": "abcd" * 4, "since": now - 5},
        "counters": {"claimed": 3, "completed": 2, "retried": 1,
                     "poisoned": 0}})
    text = "\n".join(fleet_lines([str(store)], [str(queue)]))
    assert "serve  svc: serving" in text
    assert "mix exact:8 (80%)" in text
    assert "slo:" in text and "target 100us [OK]" in text
    assert "daemon d1: draining" in text
    assert "claimed 3, completed 2" in text
    assert "queue " in text and "depth 0" in text
    text2 = "\n".join(fleet_lines([], [str(tmp_path / "nope")]))
    assert "missing directory" in text2
    assert not (tmp_path / "nope").exists()


def test_follow_renders_until_max_ticks(tmp_path, capsys):
    store = tmp_path / "store"
    store.mkdir()
    _loop_status(str(store))
    assert main(["--follow", "--store", str(store), "--interval", "0",
                 "--max-ticks", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("# fleet @") == 2 and "serve  svc" in out
    with pytest.raises(SystemExit):
        main(["--follow"])


# -- stores and queues --------------------------------------------------------------

@pytest.fixture(scope="module")
def spmv():
    """(fingerprints of both packages, sequences) for a small spmv graph."""
    from tenzing_tpu.bench.driver import DriverRequest as RefRequest
    from tenzing_tpu.serve.fingerprint import fingerprint_of as ref_fp
    from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.core.state import State
    from tenzing_tpu_torch.serve.fingerprint import fingerprint_of

    req = DriverRequest(workload="spmv", m=512)
    g, _ = graph_for(req)

    def drive(picks):
        plat = Platform.make_n_lanes(2)
        st = State(g)
        i = 0
        while not st.is_terminal():
            ds = st.get_decisions(plat)
            st = st.apply(ds[picks[i % len(picks)] % len(ds)])
            i += 1
        return st.sequence

    fps = {"port": {m: fingerprint_of(DriverRequest(workload="spmv", m=m),
                                      platform="cpu") for m in (512, 500)},
           "ref": {m: ref_fp(RefRequest(workload="spmv", m=m))
                   for m in (512, 500)}}
    seqs = [drive(p) for p in ([1, 2, 0], [2, 1, 0], [1, 0, 2])]
    return fps, seqs


def _store(d, writer, spmv):
    from tenzing_tpu.serve import segments as ref_segments
    from tenzing_tpu_torch.serve.segments import SegmentedStore

    fps, seqs = spmv
    cls = SegmentedStore if writer == "port" else ref_segments.SegmentedStore
    s = cls(d)
    f = fps[writer]
    s.add(f[512], seqs[0], pct50_us=10.0, vs_naive=2.0, verified=True)
    s.add(f[512], seqs[1], pct50_us=11.0, vs_naive=1.8, verified=True)
    s.add(f[500], seqs[2], pct50_us=9.0, vs_naive=2.2, verified=True)
    s.flush()
    return s


def _tree(tmp_path, writer, spmv):
    """A store directory with what a serving host leaves in it (segments,
    a backup, an fsck stamp, a listen loop's status, snapshot ring and
    request log with an exemplar) and a work queue with a daemon's
    status, a poisoned item, a lease, a torn item and a drain journal."""
    from tenzing_tpu_torch.obs import context as obs_context
    from tenzing_tpu_torch.obs.tracer import Tracer
    from tenzing_tpu_torch.serve import dr
    from tenzing_tpu_torch.serve.reqlog import ExemplarStore, RequestLog
    from tenzing_tpu_torch.serve.store import WorkQueue

    store = str(tmp_path / f"store-{writer}")
    _store(store, writer, spmv)
    dr.backup_store(store, note="t")
    dr.fsck_store(store, stamp=True)
    _loop_status(store)
    _snapshot(store, "svc")
    rl = RequestLog(os.path.join(store, "reqlog"), owner="svc")
    tracer = Tracer(enabled=True)
    ctx = obs_context.new_trace()
    with obs_context.use(ctx):
        with tracer.span("serve.query", tier="exact"):
            with tracer.span("serve.fingerprint"):
                pass
    rec = {"v": 1, "ts": NOW, "trace_id": ctx.trace_id, "tenant": "t",
           "op": "query", "outcome": "served", "tier": "exact",
           "workload": "spmv", "resolve_us": 120.0,
           "request": {"workload": "spmv", "m": 512}}
    for i in range(5):
        rl.append(dict(rec, ts=NOW + i))
    rl.flush()
    ExemplarStore(os.path.join(store, "reqlog", "exemplars"),
                  tracer=tracer).offer(rec, interesting="timeout")
    queue = str(tmp_path / f"queue-{writer}")
    q = WorkQueue(queue)
    fps, _ = spmv
    fp = fps["port"][512]
    q.enqueue(fp, {"workload": "spmv", "m": 512}, reason="cold")
    _write(q.poison_path_for("deadbeef" * 8), {
        "exact": "deadbeef" * 8, "reason": "cold",
        "attempts": [{"error_class": "deterministic",
                      "message": "always broken"}]})
    _write(q.lease_path_for("feedface" * 8), {"owner": "someone",
                                              "nonce": "x"})
    with open(os.path.join(queue, "work-torn.json"), "w") as f:
        f.write("{")
    _write(os.path.join(queue, "status-d1.json"), {
        "owner": "d1", "state": "stopped", "heartbeat_at": time.time(),
        "counters": {"claimed": 2, "completed": 1, "retried": 0,
                     "poisoned": 1, "reclaimed": 0},
        "history": [{"exact": fp.exact_digest, "outcome": "completed",
                     "wall_s": 3.5, "attempts": 1, "merged": 2}]})
    ckpt = q.checkpoint_dir_for(fp.exact_digest)
    os.makedirs(ckpt, exist_ok=True)
    with open(os.path.join(ckpt, "measurements.jsonl"), "w") as f:
        f.write(json.dumps({"result": {"pct50": 1e-5}}) + "\n")
        f.write(json.dumps({"batch": 1}) + "\n{torn")
    return store, queue


def _aged(lines):
    """Lines less what the wall clock moves between two reads: ages, the
    follow view's clock, lease heartbeat ages."""
    out = []
    for ln in lines:
        ln = re.sub(r"\b\d+(\.\d+)?s\b", "AGEs", ln)
        ln = re.sub(r"# fleet @ \d\d:\d\d:\d\d", "# fleet @ CLOCK", ln)
        ln = re.sub(r"\| \d+\.\d+ \|$", "| AGE |", ln)
        out.append(ln)
    return out


def _strip_port_table(lines):
    """The markdown less the port's own table of its driver blocks."""
    out, skip = [], False
    for ln in lines:
        if ln.startswith("### Device, reported schedule and result gate"):
            skip = True
            continue
        if skip and (ln.startswith("#") and not ln.startswith("### Device")):
            skip = False
        if not skip:
            out.append(ln)
    return out


def test_store_section_leaves_a_damaged_tree_untouched(tmp_path, spmv):
    """The store section reads a damaged segmented store without moving,
    creating or rewriting anything in it."""
    import hashlib

    s = _store(str(tmp_path / "seg"), "port", spmv)
    segdir = os.path.join(s.dir, "segments")
    (name,) = sorted(n for n in os.listdir(segdir) if n.endswith(".jsonl"))
    text = open(os.path.join(segdir, name)).read()
    open(os.path.join(segdir, name), "w").write(text[:int(len(text) * 0.8)])
    open(os.path.join(s.dir, "manifest.json"), "w").write("{torn")

    def tree(d):
        return {os.path.relpath(os.path.join(r, f), d): hashlib.sha256(
            open(os.path.join(r, f), "rb").read()).hexdigest()
            for r, _, fs in os.walk(d) for f in fs}

    before = tree(s.dir)
    lines = store_section([s.dir])
    assert tree(s.dir) == before
    assert any("segments" in ln for ln in lines)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_store_queue_and_dr_lines_are_the_references(tmp_path, spmv,
                                                      writer):
    """A store and a queue written by either package render the same in
    both: the store, segment, listen-loop and request-log lines, the queue
    section and the disaster-recovery lines (at a fixed ``now``)."""
    store, queue = _tree(tmp_path, writer, spmv)
    mono = str(tmp_path / "mono.json")
    mine = store_section([store, mono], queue_dir=queue)
    ref = ref_report.store_section([store, mono], queue_dir=queue)
    assert _aged(mine) == _aged(ref)
    text = "\n".join(mine)
    for want in ("#### segments", "- service `svc`: serving",
                 "fast path: memo hit rate 75.0%", "- request log",
                 "| exemplar (worst requests)", "### work queue",
                 "| poisoned |", "work-torn.json", "daemon `d1`",
                 "- checkpoint journals:"):
        assert want in text, want
    assert "empty or missing store" in text  # the absent monolithic file
    later = NOW + 3600 * 24 * 400
    assert dr_lines(store, later) == ref_report.dr_lines(store, later)
    dl = dr_lines(store, later)
    assert dl[0].startswith(f"fsck   {store}: clean (rc 0), 3 record(s)")
    assert dl[1].startswith(f"backup {store}: 1 generation(s)")
    assert _aged(queue_section(queue)) == _aged(
        ref_report.queue_section(queue))
    assert _aged(fleet_lines([store], [queue])) == _aged(
        ref_report.fleet_lines([store], [queue]))


# -- a CPU run of the port's driver ----------------------------------------------------

@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """The files one CPU smoke run of the port's driver leaves: its
    verdict, database, checkpoint journal, trace bundle and metrics."""
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.obs.metrics import MetricsRegistry, set_metrics
    from tenzing_tpu_torch.obs.tracer import Tracer, set_tracer

    d = tmp_path_factory.mktemp("cpu_run")
    prev_t = set_tracer(Tracer(enabled=False))
    prev_m = set_metrics(MetricsRegistry())
    try:
        res = driver.run(driver.DriverRequest(
            workload="spmv", smoke=True, mcts_iters=4, iters=3,
            search_iters=2, dump_csv=str(d / "db.csv"),
            trace_out=str(d / "trace"), metrics_json=str(d / "metrics.json"),
            checkpoint=str(d / "ckpt")), device="cpu")
    finally:
        set_tracer(prev_t)
        set_metrics(prev_m)
    (d / "verdict.json").write_text(res.to_json_line() + "\n")
    return d


def _report_args(d, out):
    return ["--csv", str(d / "db.csv"), HALO_R5,
            "--bench", str(d / "verdict.json"),
            "--journal", str(d / "ckpt"),
            "--trace", str(d / "trace" / "trace.jsonl"),
            "--metrics", str(d / "metrics.json"),
            "--causal", str(d / "trace" / "trace.jsonl"),
            "--check", str(d / "verdict.json"),
            "--baseline", str(d / "verdict.json"),
            "--out", out]


def test_report_over_a_cpu_run_has_every_section(cpu_run, tmp_path):
    out = str(tmp_path / "r.md")
    assert main(_report_args(cpu_run, out)) == 0
    text = open(out).read()
    for head in ("# tenzing-tpu corpus report",
                 "## Recorded search databases", "## Driver verdicts",
                 "### Device, reported schedule and result gate",
                 "## Checkpoint journals", "## Telemetry bundles",
                 "## Metrics", "## Causal analysis", "## Regression check",
                 "**verdict: ok**"):
        assert head in text, head
    assert "| verdict.json | cpu (cpu) |" in text


def test_report_markdown_is_the_references(cpu_run, tmp_path, spmv):
    """The same inputs give the same markdown in both packages, less the
    wall-clock ages and the port's own table."""
    store, queue = _tree(tmp_path, "port", spmv)
    texts = []
    for fn in (main, ref_report.main):
        out = str(tmp_path / f"r{len(texts)}.md")
        assert fn(_report_args(cpu_run, out) + [
            "--store", store, "--queue-dir", queue]) == 0
        texts.append(open(out).read().splitlines())
    assert _aged(_strip_port_table(texts[0])) == _aged(texts[1])
    assert _strip_port_table(texts[0]) != texts[0]


# -- across the packages: verdicts -----------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_regression_verdicts_are_the_references(seed):
    rng = random.Random(seed)
    base = _verdict(vs=rng.uniform(1.0, 2.0), value=rng.uniform(10, 90),
                    naive=100.0)
    for _ in range(6):
        drift = rng.random() < 0.4
        times = ([1.0 + 0.01 * i for i in range(20)] if drift else
                 [1.0 + rng.uniform(-0.01, 0.01) for _ in range(20)])
        fresh = _verdict(vs=base["vs_baseline"] * rng.uniform(0.6, 1.1),
                         value=base["value"] * rng.uniform(0.9, 1.3),
                         naive=100.0,
                         times=times if rng.random() < 0.7 else None)
        for tol in (0.05, 0.25):
            assert check_regression(fresh, base, tol) == \
                ref_report.check_regression(fresh, base, tol)
    assert check_regression({}, {}) == ref_report.check_regression({}, {})


def _noise(p99):
    return {"version": 1, "samples": 64, "host": "h",
            "timer_wake_us": {"count": 64, "p50_us": p99 / 2,
                              "p99_us": p99, "runs_z": 0.1, "iid": True},
            "hot_spin_us": {"count": 64, "p50_us": 1.0, "p99_us": 2.0,
                            "runs_z": 0.1, "iid": True}}


@pytest.mark.parametrize("seed", range(6))
def test_serve_regression_verdicts_are_the_references(seed):
    rng = random.Random(100 + seed)

    def doc():
        d = _replay_doc(rng.uniform(50, 500), verifier=rng.choice([0, 0, 2]),
                        shed=rng.choice([0, 0, 3]),
                        samples=(None if rng.random() < 0.6 else
                                 [100.0 + 10 * i for i in range(64)]))
        if rng.random() < 0.7:
            d["segmented"]["phases_us"] = {
                s: {"count": rng.randint(1, 80), "pct50_us": 1.0,
                    "pct99_us": rng.uniform(1, 100)}
                for s in ("fingerprint", "cache_probe", "store_walk")}
        if rng.random() < 0.6:
            d["host_noise"] = _noise(rng.uniform(1, 60))
        return d

    for _ in range(8):
        fresh, base = doc(), doc()
        for tol in (0.1, 0.25):
            assert check_serve_regression(fresh, base, tol) == \
                ref_report.check_serve_regression(fresh, base, tol)
