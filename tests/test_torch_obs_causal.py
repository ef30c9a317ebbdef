"""The port's causal analysis and stitcher (tenzing_tpu_torch/obs/causal.py,
obs/export.py) against the JAX package's (reference tests
test_obs_causal.py and the stitch tests of test_obs_context.py), test for
test: hand-computed critical paths over synthetic bundles (a fast-path hit,
an exclusive-path hit, a cold item through queue wait, drain child and
merge, batch members sharing a trace), the explicit ``unattributed``
residual, the aggregation, the localizer's verdicts, the CLI; the stitcher's
grouping by trace, its labels for colliding paths, and a real cold query
drained by a daemon subprocess and its drain child, stitched across the
three processes.  Then across the packages: the same bundles give the same
causal JSON and the same stitched document and summary.
"""

import json
import os
import subprocess
import sys

import pytest

from tenzing_tpu.obs import causal as ref_causal
from tenzing_tpu.obs import export as ref_export
from tenzing_tpu_torch.obs import context as obs_context
from tenzing_tpu_torch.obs.causal import (
    CAUSAL_VERSION,
    aggregate,
    analyze_bundles,
    analyze_records,
    localize_aggregates,
    localize_phases,
    localize_segments,
    main as causal_main,
)
from tenzing_tpu_torch.obs.context import new_trace
from tenzing_tpu_torch.obs.export import (
    _bundle_labels,
    stitch,
    stitch_records,
    write_jsonl,
)
from tenzing_tpu_torch.obs.report import check_serve_regression
from tenzing_tpu_torch.obs.tracer import Tracer, set_tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def span(name, ts, dur, tid="t1", **attrs):
    return {"kind": "span", "name": name, "ts_us": float(ts),
            "dur_us": float(dur), "pid": 1, "tid": 1,
            "attrs": {"trace_id": tid, **attrs}}


def event(name, ts, tid="t1", **attrs):
    return {"kind": "event", "name": name, "ts_us": float(ts),
            "pid": 1, "tid": 1, "attrs": {"trace_id": tid, **attrs}}


def chain_of(trace):
    return [c["segment"] for c in trace["chain"]]


# -- golden critical paths ---------------------------------------------------

def test_exclusive_path_hit_golden():
    # serve.query [100, 400] wrapping fingerprint [110,150] and
    # cache_probe [160,260]: the remainder of the query window is
    # store_walk, the lead-in is ingress — every us attributed
    recs = [
        span("serve.query", 100, 300, tier="exact", workload="halo"),
        span("serve.fingerprint", 110, 40),
        span("serve.cache_probe", 160, 100),
    ]
    t = analyze_records(recs)["t1"]
    assert chain_of(t) == ["ingress", "fingerprint", "store_walk",
                           "cache_probe", "store_walk"]
    assert t["segments_us"] == {"ingress": 10.0, "fingerprint": 40.0,
                                "store_walk": 150.0, "cache_probe": 100.0}
    assert t["window_us"] == 300.0
    assert t["unattributed_us"] == 0.0 and t["coverage"] == 1.0
    assert t["tier"] == "exact" and t["queries"] == 1


def test_fast_path_hit_golden():
    # the fast path emits its span post-hoc with ~0 duration; the real
    # latency rides resolve_us — the analyzer synthesizes the interval
    recs = [span("serve.query", 500, 0, tier="exact", fast_path=True,
                 resolve_us=42)]
    t = analyze_records(recs)["t1"]
    assert chain_of(t) == ["fast_path"]
    assert t["segments_us"] == {"fast_path": 42.0}
    assert t["window_us"] == 42.0 and t["coverage"] == 1.0


def test_cold_item_through_queue_wait_drain_merge_golden():
    # the full cold chain: resolve [0,300] enqueues at 250, a daemon
    # claims at 1000 (queue wait 750), drains with compile/measure
    # children, merges [4500,4900] — the window ends at the servable
    # point, not at post-merge housekeeping
    recs = [
        span("serve.query", 0, 300, tier="cold", workload="spmv"),
        span("serve.fingerprint", 10, 40),
        span("serve.cache_probe", 60, 100),
        event("serve.enqueue", 250, exact="e1", reason="cold"),
        span("daemon.drain", 1000, 4500, exact="e1"),
        span("executor.compile", 1100, 900),
        span("bench.benchmark", 2100, 900),
        span("serve.store.flush", 4500, 400),
    ]
    t = analyze_records(recs)["t1"]
    assert chain_of(t) == [
        "ingress", "fingerprint", "store_walk", "cache_probe",
        "store_walk", "queue_wait", "drain", "compile", "drain",
        "measure", "drain", "merge"]
    assert t["segments_us"]["queue_wait"] == 750.0
    assert t["segments_us"]["merge"] == 400.0
    assert t["window_us"] == 4900.0  # ends at the merge, not drain end
    assert t["servable"] is True
    assert t["coverage"] == 1.0 and t["unattributed_us"] == 0.0
    assert t["markers"] == [{"segment": "enqueue", "ts_us": 250.0}]
    assert t["queue_wait_us"] == 750.0
    assert t["service_us"] == 4150.0  # window - queue wait (no residual)
    # enqueue -> queue wait -> drain -> merge in order, queue wait a
    # distinct segment, coverage >= 0.9
    segs = chain_of(t)
    assert [s for s in segs if s in ("queue_wait", "merge")] == \
        ["queue_wait", "merge"]
    assert segs.index("queue_wait") < segs.index("drain")
    assert t["coverage"] >= 0.9


def test_batch_members_share_trace_and_residual_accounts():
    # two queries in one trace with an uncovered gap between them: the
    # gap is explicit unattributed, and the books balance exactly —
    # sum(segments) + unattributed == window
    recs = [
        span("serve.query", 0, 100, tier="exact"),
        span("serve.fingerprint", 10, 80),
        span("serve.query", 300, 100, tier="exact"),
        span("serve.fingerprint", 310, 80),
    ]
    t = analyze_records(recs)["t1"]
    assert t["queries"] == 2
    assert chain_of(t) == ["ingress", "fingerprint", "store_walk",
                           "unattributed",
                           "ingress", "fingerprint", "store_walk"]
    assert t["window_us"] == 400.0
    assert t["unattributed_us"] == 200.0
    assert t["coverage"] == 0.5
    total = sum(t["segments_us"].values()) + t["unattributed_us"]
    assert abs(total - t["window_us"]) < 1e-6
    # and the chain itself tiles the window with no gaps or overlaps
    edges = [(c["start_us"], c["end_us"]) for c in t["chain"]]
    assert edges[0][0] == 0.0 and edges[-1][1] == t["window_us"]
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))


def test_traces_separated_and_housekeeping_dropped():
    recs = [
        span("serve.query", 0, 100, tid="a", tier="exact"),
        span("serve.query", 0, 200, tid="b", tier="near"),
        # no trace_id: process-local housekeeping, not request latency
        {"kind": "span", "name": "serve.query", "ts_us": 0.0,
         "dur_us": 999.0, "attrs": {}},
        {"kind": "other", "name": "noise"},
    ]
    out = analyze_records(recs)
    assert sorted(out) == ["a", "b"]
    assert out["a"]["window_us"] == 100.0
    assert out["b"]["tier"] == "near"


# -- aggregation -------------------------------------------------------------

def test_aggregate_rollup_and_pct99_ranking():
    recs = []
    # nine quick fast-path hits and one slow cold request: the tail
    # ranking must attribute the pct99 to the cold chain's segments
    for i in range(9):
        recs.append(span("serve.query", 1000 * i, 0, tid=f"f{i}",
                         tier="exact", fast_path=True, resolve_us=50))
    recs += [
        span("serve.query", 0, 300, tid="cold1", tier="cold"),
        event("serve.enqueue", 250, tid="cold1"),
        span("daemon.drain", 1000, 4000, tid="cold1"),
        span("serve.store.flush", 4500, 500, tid="cold1"),
    ]
    traces = analyze_records(recs)
    agg = aggregate(traces)
    assert agg["n_traces"] == 10
    assert agg["by_tier"]["exact"]["count"] == 9
    assert agg["by_tier"]["exact"]["segments_us"]["fast_path"][
        "p50_us"] == 50.0
    assert agg["by_tier"]["cold"]["count"] == 1
    top = agg["pct99_ranking"][0]
    assert top["segment"] in ("drain", "queue_wait")
    assert agg["decomposition"]["queue_wait_us"]["p99_us"] == 750.0


# -- differential localization -----------------------------------------------

def _phase(p99, count=64):
    return {"count": count, "pct50_us": p99 / 2, "pct99_us": p99,
            "sum_us": p99 * count}


def test_localizer_ok_when_nothing_moved():
    base = {"fingerprint": _phase(10.0), "cache_probe": _phase(20.0)}
    fresh = {"fingerprint": _phase(12.0), "cache_probe": _phase(21.0)}
    loc = localize_segments(fresh, base)
    assert loc["moved"] == []
    assert {c["segment"] for c in loc["compared"]} == \
        {"fingerprint", "cache_probe"}


def test_localizer_flags_the_moved_segment():
    base = {"fingerprint": _phase(10.0), "cache_probe": _phase(20.0)}
    fresh = {"fingerprint": _phase(11.0), "cache_probe": _phase(62.0)}
    loc = localize_segments(fresh, base)
    assert [m["segment"] for m in loc["moved"]] == ["cache_probe"]
    assert loc["moved"][0]["ratio"] == 3.1


def test_localizer_noise_guards():
    # a 3x ratio on a sub-floor phase is not movement (2us -> 6us sits
    # under the 5us absolute floor), nor is a thin sample (count < 8),
    # and a raised measured wake floor suppresses small deltas too
    base = {"tiny": _phase(2.0), "thin": _phase(10.0, count=3),
            "real": _phase(10.0)}
    fresh = {"tiny": _phase(6.0), "thin": _phase(90.0, count=3),
             "real": _phase(30.0)}
    loc = localize_segments(fresh, base)
    assert [m["segment"] for m in loc["moved"]] == ["real"]
    assert "thin" in loc["skipped"]
    # same data under a 25us measured floor: real's 20us delta is
    # within the host's own wake noise — nothing moved
    loc = localize_segments(fresh, base, floor_us=25.0)
    assert loc["moved"] == [] and loc["delta_floor_us"] == 25.0


def _serve_doc(pct99=100.0, phases=None, samples=None, noise_p99=None):
    doc = {
        "kind": "serve_trace_replay",
        "segmented": {
            "resolve_us": {"exact": {"count": 64, "pct50_us": 50.0,
                                     "pct99_us": pct99}},
            "verifier_calls": 0, "shed": 0,
            "exact_samples_us": samples or [],
            **({"phases_us": phases} if phases else {}),
        },
    }
    if noise_p99 is not None:
        doc["host_noise"] = {
            "version": 1, "samples": 64, "host": "h",
            "timer_wake_us": {"count": 64, "p50_us": noise_p99 / 2,
                              "p99_us": noise_p99, "runs_z": 0.1,
                              "iid": True},
            "hot_spin_us": {"count": 64, "p50_us": 1.0, "p99_us": 2.0,
                            "runs_z": 0.1, "iid": True},
        }
    return doc


def test_localize_phases_uses_fresh_doc_wake_floor():
    base = _serve_doc(phases={"cache_probe": _phase(10.0)})
    fresh = _serve_doc(phases={"cache_probe": _phase(30.0)},
                       noise_p99=25.0)
    # delta 20us < the recorded 25us wake floor: not movement
    assert localize_phases(fresh, base)["moved"] == []
    fresh = _serve_doc(phases={"cache_probe": _phase(120.0)},
                       noise_p99=25.0)
    assert [m["segment"] for m in localize_phases(fresh, base)["moved"]] \
        == ["cache_probe"]


def _iid_samples(n=64, seed=1):
    # seeded uniform jitter: passes the runs test (|Z| < 1.96), so the
    # noise downgrade stays out of the way of the verdict under test
    import random

    rng = random.Random(seed)
    return [90.0 + rng.random() * 2 for _ in range(n)]


def test_serve_gate_names_the_doctored_phase():
    # the check says which phase regressed, not just that a pct99 did
    samples = _iid_samples()
    base = _serve_doc(phases={"fingerprint": _phase(10.0),
                              "cache_probe": _phase(20.0)})
    fresh = _serve_doc(pct99=100.0,
                       phases={"fingerprint": _phase(10.5),
                               "cache_probe": _phase(65.0)},
                       samples=samples)
    verdict = check_serve_regression(fresh, base)
    assert verdict["verdict"] == "regression"
    assert any("phase 'cache_probe' pct99 regressed 3.2x" in r
               for r in verdict["reasons"])
    assert [m["segment"] for m in
            verdict["checks"]["segments"]["moved"]] == ["cache_probe"]


def test_serve_gate_downgrades_cross_host_comparison():
    # same doctored regression, but the fresh doc's measured floors are
    # 10x the baseline host's: the hosts are not comparable — verdict
    # downgrades to inconclusive instead of blaming the code
    samples = _iid_samples()
    base = _serve_doc(phases={"cache_probe": _phase(20.0)}, noise_p99=5.0)
    fresh = _serve_doc(pct99=400.0,
                       phases={"cache_probe": _phase(200.0)},
                       samples=samples, noise_p99=50.0)
    verdict = check_serve_regression(fresh, base)
    assert verdict["verdict"] == "inconclusive"
    assert any("hosts are not comparable" in r for r in verdict["reasons"])
    assert "timer-wake" in verdict["checks"]["host_floors"]
    # the floor-vs-tail read is recorded for the report to render
    assert verdict["checks"]["host_noise"]["ratio"] == 8.0
    assert "serving-bound" in verdict["checks"]["host_noise"]["line"]


def test_serve_gate_matching_hosts_do_not_downgrade():
    base = _serve_doc(noise_p99=10.0)
    fresh = _serve_doc(pct99=95.0, noise_p99=12.0)
    verdict = check_serve_regression(fresh, base)
    assert verdict["verdict"] == "ok"
    assert "host_floors" not in verdict["checks"]


# -- bundles + CLI -----------------------------------------------------------

def _write_bundle(path, recs, header=None):
    with open(path, "w") as f:
        if header is not None:
            f.write(json.dumps(header) + "\n")
        for r in recs:
            f.write(json.dumps(r) + "\n")


def test_analyze_bundles_exemplar_header_supplies_tenant(tmp_path):
    p = str(tmp_path / "exemplar-aa-slow-0.jsonl")
    _write_bundle(p, [span("serve.query", 0, 100, tid="aa", tier="exact"),
                      span("serve.fingerprint", 10, 80, tid="aa")],
                  header={"kind": "exemplar", "trace_id": "aa",
                          "record": {"tenant": "acme",
                                     "resolve_us": 100.0}})
    out = analyze_bundles([p])
    assert out["aa"]["tenant"] == "acme"
    agg = aggregate(out)
    assert agg["by_tenant"]["acme"]["count"] == 1


def test_causal_cli_analysis_and_diff(tmp_path):
    bundle = str(tmp_path / "trace.jsonl")
    _write_bundle(bundle, [
        span("serve.query", 0, 300, tier="cold"),
        event("serve.enqueue", 250),
        span("daemon.drain", 1000, 4000),
        span("serve.store.flush", 4500, 500),
    ])
    out = str(tmp_path / "causal.json")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.obs.causal", bundle,
         "--out", out], capture_output=True, text=True, timeout=120,
        env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    doc = json.load(open(out))
    assert doc["kind"] == "causal_analysis"
    assert doc["version"] == CAUSAL_VERSION
    t = doc["traces"]["t1"]
    assert t["coverage"] >= 0.9
    segs = [c["segment"] for c in t["chain"]]
    assert segs.index("queue_wait") < segs.index("drain") < \
        segs.index("merge")
    # --diff: doctored phase -> exit 1, names the segment
    base_doc = _serve_doc(phases={"cache_probe": _phase(20.0)})
    fresh_doc = _serve_doc(phases={"cache_probe": _phase(65.0)})
    fb, bb = str(tmp_path / "f.json"), str(tmp_path / "b.json")
    json.dump(fresh_doc, open(fb, "w"))
    json.dump(base_doc, open(bb, "w"))
    r = subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.obs.causal",
         "--diff", fb, bb], capture_output=True, text=True, timeout=120,
        env=env, cwd=REPO)
    assert r.returncode == 1, (r.stdout, r.stderr)
    diff = json.loads(r.stdout)
    assert diff["kind"] == "causal_diff"
    assert [m["segment"] for m in diff["moved"]] == ["cache_probe"]
    # clean pair -> exit 0
    json.dump(base_doc, open(fb, "w"))
    r = subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.obs.causal",
         "--diff", fb, bb], capture_output=True, text=True, timeout=120,
        env=env, cwd=REPO)
    assert r.returncode == 0, (r.stdout, r.stderr)
    # no bundles and no --diff: usage error
    r = subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.obs.causal"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 2


# -- the port's own span names ----------------------------------------------------

def test_port_executor_and_compile_spans_are_compile():
    """The port names its executor's span ``executor.compile`` with CUDA
    graphs and ``executor.build`` without; both, and ``pipeline.precompile``
    and ``fused.plan``, are the ``compile`` segment."""
    recs = [span("daemon.drain", 0, 1000),
            span("executor.compile", 100, 100),
            span("executor.build", 300, 100),
            span("pipeline.precompile", 500, 50),
            span("fused.plan", 600, 50),
            span("mcts.iter", 700, 100),
            span("bench.benchmark", 800, 100),
            span("serve.store.flush", 950, 50)]
    t = analyze_records(recs)["t1"]
    assert t["segments_us"] == {"compile": 300.0, "drain": 450.0,
                                "measure": 100.0, "merge": 50.0,
                                "search": 100.0}
    assert t["coverage"] == 1.0


# -- the stitcher ----------------------------------------------------------------

def test_stitch_groups_bundles_by_trace_id(tmp_path):
    ctx = new_trace()
    bundles = []
    for name, spans in (("ingress", ["serve.query"]),
                        ("daemon", ["daemon.drain", "serve.store.flush"])):
        tr = Tracer(enabled=True)
        with obs_context.use(ctx):
            for s in spans:
                with tr.span(s):
                    pass
        # one span without a context, which must not join the trace
        with tr.span("background"):
            pass
        p = str(tmp_path / f"{name}.jsonl")
        write_jsonl(tr, p)
        bundles.append(p)
    out = str(tmp_path / "merged.json")
    summary = stitch(bundles, out_path=out)
    t = summary["traces"][ctx.trace_id]
    assert t["n_processes"] == 2
    assert t["processes"] == ["daemon.jsonl", "ingress.jsonl"]
    assert set(t["names"]) == {"serve.query", "daemon.drain",
                               "serve.store.flush"}
    doc = json.load(open(out))
    evs = doc["traceEvents"]
    names = {e["args"]["name"] for e in evs if e.get("ph") == "M"
             and e["name"] == "process_name"}
    assert {"ingress.jsonl", "daemon.jsonl"} <= names
    pids = {e["pid"] for e in evs if e.get("ph") == "X"}
    assert len(pids) == 2
    # flow arrows tie the trace across processes (s first, f last)
    flows = [e for e in evs if e.get("cat") == "trace"
             and e.get("id") == ctx.trace_id]
    assert [f["ph"] for f in flows].count("s") == 1
    assert [f["ph"] for f in flows].count("f") == 1
    assert len(flows) == 3


def test_stitch_dedups_colliding_basenames(tmp_path):
    ctx = new_trace()
    paths = []
    for sub in ("a", "b"):
        d = tmp_path / sub
        d.mkdir()
        tr = Tracer(enabled=True)
        with obs_context.use(ctx):
            with tr.span("x"):
                pass
        p = str(d / "trace.jsonl")
        write_jsonl(tr, p)
        paths.append(p)
    summary = stitch(paths)
    assert summary["traces"][ctx.trace_id]["n_processes"] == 2
    assert sorted(summary["bundles"]) == ["a/trace.jsonl", "b/trace.jsonl"]


def test_stitch_labels_unique_for_identical_ckpt_layout(tmp_path):
    """Every drain child writes ``ckpt-<exact>/trace/trace.jsonl``: labels
    grow path components until the processes separate."""
    ctx = new_trace()
    paths = []
    for exact in ("ckpt-aaaa", "ckpt-bbbb"):
        d = tmp_path / exact / "trace"
        d.mkdir(parents=True)
        tr = Tracer(enabled=True)
        with obs_context.use(ctx):
            with tr.span("bench.benchmark"):
                pass
        p = str(d / "trace.jsonl")
        write_jsonl(tr, p)
        paths.append(p)
    summary = stitch(paths)
    assert summary["traces"][ctx.trace_id]["n_processes"] == 2
    assert sorted(summary["bundles"]) == [
        "ckpt-aaaa/trace/trace.jsonl", "ckpt-bbbb/trace/trace.jsonl"]


def test_export_cli_stitches_and_refuses_nothing(tmp_path, capsys):
    from tenzing_tpu_torch.obs.export import main as export_main

    ctx = new_trace()
    tr = Tracer(enabled=True)
    with obs_context.use(ctx):
        with tr.span("serve.query"):
            pass
    p = str(tmp_path / "one.jsonl")
    write_jsonl(tr, p)
    out = str(tmp_path / "merged.json")
    assert export_main([str(tmp_path / "*.jsonl"), "--out", out]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["out"] == out and summary["bundles"] == ["one.jsonl"]
    assert ctx.trace_id in summary["traces"]
    assert export_main([str(tmp_path / "none-*.jsonl")]) == 2


def test_cold_query_drained_by_a_daemon_subprocess_stitches(tmp_path):
    """A traced cold query's trace id rides the work item into a daemon
    subprocess and its ``--exec-item`` child: the three processes' bundles
    stitch into one trace, and its causal chain has search, measure and
    merge with the books balanced to the window."""
    from tenzing_tpu_torch.bench.driver import DriverRequest
    from tenzing_tpu_torch.serve.service import ScheduleService

    tr = Tracer(enabled=True)
    prev = set_tracer(tr)
    try:
        svc = ScheduleService(str(tmp_path / "store.json"),
                              queue_dir=str(tmp_path / "q"), platform="cpu")
        with obs_context.use(new_trace()):
            res = svc.query(DriverRequest(workload="spmv", smoke=True,
                                          m=512))
    finally:
        set_tracer(prev)
    assert res.tier == "cold"
    query_bundle = str(tmp_path / "query.jsonl")
    write_jsonl(tr, query_bundle)
    item = svc.queue.items()[0]
    assert item[1]["trace"]["trace_id"] == res.trace_id
    daemon_bundle = str(tmp_path / "daemon.jsonl")
    r = subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.serve.daemon",
         "--queue", str(tmp_path / "q"), "--store",
         str(tmp_path / "store.json"), "--once", "--device", "cpu",
         "--override", "mcts_iters=4", "--override", "iters=3",
         "--override", "search_iters=2", "--trace-out", daemon_bundle],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    ckpt = item[1]["checkpoint"]
    child_bundle = os.path.join(ckpt, "trace", "trace.jsonl")
    assert os.path.exists(child_bundle)
    bundles = [query_bundle, daemon_bundle, child_bundle]
    summary = stitch(bundles)
    t = summary["traces"][res.trace_id]
    assert t["n_processes"] == 3
    assert {"serve.query", "serve.enqueue", "daemon.drain",
            "serve.store.flush", "mcts.iter", "bench.benchmark"} <= \
        set(t["names"])
    c = analyze_bundles(bundles)[res.trace_id]
    assert c["servable"] is True and c["tier"] == "cold"
    assert all(c["segments_us"].get(k, 0) > 0
               for k in ("search", "measure", "merge", "queue_wait"))
    assert abs(sum(c["segments_us"].values()) + c["unattributed_us"]
               - c["window_us"]) < 1.0
    # the reference reads the port's bundles the same way
    assert ref_causal.analyze_bundles(bundles)[res.trace_id] == c
    assert ref_export.stitch(bundles) == summary


# -- across the packages -------------------------------------------------------------

_NAMES = ["serve.query", "serve.fingerprint", "serve.cache_probe",
          "serve.serialize", "daemon.drain", "mcts.iter", "dfs.iter",
          "executor.compile", "executor.build", "pipeline.precompile",
          "fused.plan", "bench.benchmark", "attrib.step", "learn.train",
          "serve.store.flush", "serve.compaction", "serve.warm", "other.x"]


def _corpus(seed, n_traces=12, n_recs=30):
    """Seeded synthetic records: spans of every named segment and some
    unknown names, events (enqueue, shed), fast-path queries, records with
    no trace id and malformed ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    recs = []
    for t in range(n_traces):
        tid = f"{seed:02d}{t:014x}"
        base = float(rng.integers(0, 10_000))
        for _ in range(int(rng.integers(1, n_recs))):
            name = _NAMES[int(rng.integers(0, len(_NAMES)))]
            ts = base + float(rng.integers(0, 20_000)) / 4
            dur = float(rng.integers(0, 4_000)) / 4
            attrs = {"trace_id": tid}
            if name == "serve.query":
                attrs["tier"] = ["exact", "near", "cold"][
                    int(rng.integers(0, 3))]
                attrs["workload"] = ["halo", "spmv"][int(rng.integers(0, 2))]
                if rng.random() < 0.3:
                    attrs.update(fast_path=True, resolve_us=float(
                        rng.integers(1, 200)))
            recs.append({"kind": "span", "name": name, "ts_us": ts,
                         "dur_us": dur, "pid": 0, "tid": int(
                             rng.integers(0, 3)), "attrs": attrs})
        for _ in range(int(rng.integers(0, 3))):
            recs.append({"kind": "event", "name": ["serve.enqueue",
                                                   "serve.shed"][
                int(rng.integers(0, 2))], "ts_us": base + float(
                rng.integers(0, 5_000)), "pid": 0, "tid": 0,
                "attrs": {"trace_id": tid}})
    recs.append({"kind": "span", "name": "serve.query", "ts_us": 1.0,
                 "dur_us": 5.0, "attrs": {}})
    recs.append({"kind": "span", "name": "mcts.iter", "ts_us": "x",
                 "dur_us": 1.0, "attrs": {"trace_id": "bad"}})
    return recs


@pytest.mark.parametrize("seed", range(6))
def test_causal_results_are_the_references(seed):
    recs = _corpus(seed)
    mine = analyze_records(recs)
    ref = ref_causal.analyze_records(recs)
    assert mine == ref
    assert aggregate(mine) == ref_causal.aggregate(ref)
    tenants = {tid: f"t{i % 3}" for i, tid in enumerate(sorted(mine))}
    assert analyze_records(recs, tenants=tenants) == \
        ref_causal.analyze_records(recs, tenants=tenants)
    tid = sorted(mine)[0]
    assert analyze_records(recs, trace_id=tid) == \
        ref_causal.analyze_records(recs, trace_id=tid)
    other = analyze_records(_corpus(seed + 10))
    for tier in ("exact", "near", "cold"):
        assert localize_aggregates(aggregate(mine), aggregate(other),
                                   tier=tier) == \
            ref_causal.localize_aggregates(aggregate(mine), aggregate(other),
                                           tier=tier)


@pytest.mark.parametrize("seed", range(4))
def test_localizers_are_the_references(seed):
    import numpy as np

    rng = np.random.default_rng(seed)

    def phases():
        return {s: _phase(float(rng.integers(1, 100)),
                          count=int(rng.integers(1, 80)))
                for s in ("fingerprint", "cache_probe", "store_walk",
                          "serialize") if rng.random() < 0.9}

    fresh, base = phases(), phases()
    for tol, floor in ((0.25, None), (1.5, None), (0.25, 30.0)):
        assert localize_segments(fresh, base, tol=tol, floor_us=floor) == \
            ref_causal.localize_segments(fresh, base, tol=tol,
                                         floor_us=floor)
    fd = _serve_doc(phases=fresh, noise_p99=float(rng.integers(1, 40)))
    bd = _serve_doc(phases=base)
    assert localize_phases(fd, bd) == ref_causal.localize_phases(fd, bd)


def test_causal_cli_documents_are_the_references(tmp_path, capsys):
    paths = []
    for i in range(3):
        p = str(tmp_path / f"b{i}.jsonl")
        _write_bundle(p, _corpus(20 + i), header=(
            {"kind": "exemplar", "trace_id": f"{20 + i:02d}{0:014x}",
             "record": {"tenant": "acme"}} if i == 1 else None))
        paths.append(p)
    outs = []
    for fn in (causal_main, ref_causal.main):
        out = str(tmp_path / f"out-{len(outs)}.json")
        assert fn([str(tmp_path / "b*.jsonl"), "--out", out]) == 0
        outs.append(json.load(open(out)))
    assert outs[0] == outs[1]
    assert outs[0]["traces"][f"{21:02d}{0:014x}"]["tenant"] == "acme"
    fb, bb = str(tmp_path / "f.json"), str(tmp_path / "b.json")
    json.dump(_serve_doc(phases={"cache_probe": _phase(65.0)}), open(fb, "w"))
    json.dump(_serve_doc(phases={"cache_probe": _phase(20.0)}), open(bb, "w"))
    capsys.readouterr()
    docs = []
    for fn in (causal_main, ref_causal.main):
        assert fn(["--diff", fb, bb]) == 1
        docs.append(json.loads(capsys.readouterr().out))
    assert docs[0] == docs[1]


@pytest.mark.parametrize("seed", range(3))
def test_stitched_documents_are_the_references(seed):
    # the stitcher takes a bundle's timestamps as numbers, as the
    # reference's does: the corpus's malformed record is left out
    bundles = [(f"p{i}", [r for r in _corpus(seed * 7 + i, n_traces=4)
                          if not isinstance(r.get("ts_us"), str)])
               for i in range(3)]
    assert stitch_records(bundles) == ref_export.stitch_records(bundles)


def test_bundle_labels_are_the_references():
    cases = [["a/trace.jsonl", "b/trace.jsonl"],
             ["x/ckpt-1/trace/trace.jsonl", "x/ckpt-2/trace/trace.jsonl",
              "serve_child.jsonl"],
             ["same.jsonl", "same.jsonl"],
             ["/abs/q/ckpt-a/trace/trace.jsonl", "/abs/q/ckpt-a/trace.jsonl",
              "/abs/listen/trace.jsonl"]]
    for paths in cases:
        assert _bundle_labels(paths) == ref_export._bundle_labels(paths)
