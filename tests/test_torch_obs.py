"""The port's telemetry (tenzing_tpu_torch/obs, utils/counters.py, the
driver's ``--trace-out`` / ``--metrics-json``): the tracer and metrics tests
of ``tests/test_obs.py`` that need no serve plane, run against the port's
modules, and a smoke driver run whose bundle loads and whose span and
metric names are the reference smoke run's, less those of layers the port
does not have (listed in ``NOT_IN_PORT``)."""

import io
import json
import time

import pytest

from tenzing_tpu_torch.obs.export import (
    chrome_trace,
    read_jsonl,
    to_jsonl,
    write_chrome_trace,
    write_jsonl,
)
from tenzing_tpu_torch.obs.metrics import MetricsRegistry, get_metrics, set_metrics
from tenzing_tpu_torch.obs.progress import ProgressReporter, set_reporter
from tenzing_tpu_torch.obs.tracer import Tracer, set_tracer
from tenzing_tpu_torch.utils.counters import Counters
from tenzing_tpu_torch.utils.numeric import percentile


@pytest.fixture
def tracer():
    """A fresh enabled tracer installed as the process-global one."""
    tr = Tracer(enabled=True)
    prev = set_tracer(tr)
    try:
        yield tr
    finally:
        set_tracer(prev)


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = set_metrics(reg)
    try:
        yield reg
    finally:
        set_metrics(prev)


# -- tracer ----------------------------------------------------------------

def test_span_nesting_and_attributes(tracer):
    with tracer.span("outer", a=1) as outer:
        with tracer.span("inner") as inner:
            inner.set("b", 2)
        outer.set("done", True)
    spans = {s.name: s for s in tracer.spans()}
    assert set(spans) == {"outer", "inner"}
    assert spans["inner"].parent_id == spans["outer"].span_id
    assert spans["outer"].parent_id is None
    assert spans["outer"].attrs == {"a": 1, "done": True}
    assert spans["inner"].attrs == {"b": 2}
    # inner closed first and fits inside outer
    assert spans["inner"].ts_us >= spans["outer"].ts_us
    assert spans["inner"].dur_us <= spans["outer"].dur_us


def test_sibling_spans_share_parent(tracer):
    with tracer.span("p") as p:
        with tracer.span("c1"):
            pass
        with tracer.span("c2"):
            pass
    spans = {s.name: s for s in tracer.spans()}
    assert spans["c1"].parent_id == spans["c2"].parent_id == p.span_id


def test_events_and_rank_tagging(tracer):
    tracer.set_rank(3)
    tracer.event("hello", x=1)
    with tracer.span("s"):
        pass
    assert tracer.events()[0].pid == 3
    assert tracer.spans()[0].pid == 3


def test_disabled_tracer_is_noop():
    tr = Tracer(enabled=False)
    with tr.span("x", a=1) as sp:
        sp.set("b", 2)  # must not raise
        tr.event("y")
    assert tr.spans() == [] and tr.events() == []
    # near-zero overhead: a disabled span is a shared constant, no recording
    t0 = time.perf_counter()
    for _ in range(10_000):
        with tr.span("hot"):
            pass
    assert time.perf_counter() - t0 < 1.0
    # the disabled path allocates nothing per call
    assert tr.span("a") is tr.span("b")


def test_exception_still_closes_span(tracer):
    with pytest.raises(ValueError):
        with tracer.span("boom"):
            raise ValueError("x")
    assert len(tracer.spans()) == 1
    assert tracer.spans()[0].dur_us >= 0


# -- JSONL sink ------------------------------------------------------------

def test_jsonl_round_trip(tracer, tmp_path):
    with tracer.span("s1", k="v"):
        tracer.event("e1", n=7)
    path = str(tmp_path / "trace.jsonl")
    write_jsonl(tracer, path)
    records = read_jsonl(path)
    # timestamp order: the span's ts is its START, before the event inside it
    assert [r["kind"] for r in records] == ["span", "event"]
    ev = next(r for r in records if r["kind"] == "event")
    sp = next(r for r in records if r["kind"] == "span")
    assert ev["name"] == "e1" and ev["attrs"] == {"n": 7}
    assert sp["name"] == "s1" and sp["attrs"] == {"k": "v"}
    assert sp["dur_us"] >= 0 and sp["parent"] is None
    # every line is independently parseable
    lines = to_jsonl(tracer).splitlines()
    assert all(json.loads(line) for line in lines)


# -- Chrome trace-event sink (Perfetto) ------------------------------------

def test_chrome_trace_schema(tracer, tmp_path):
    tracer.set_rank(1)
    with tracer.span("phase.outer", a=1):
        with tracer.span("phase.inner"):
            pass
        tracer.event("marker", m=2)
    doc = chrome_trace(tracer)
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    events = doc["traceEvents"]
    phs = {e["ph"] for e in events}
    assert phs == {"M", "X", "i"}
    for e in events:
        assert isinstance(e["name"], str) and e["name"]
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X":
            assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
            assert e["dur"] >= 0
            assert isinstance(e["args"], dict)
        if e["ph"] == "i":
            assert e["s"] in ("g", "p", "t")
        if e["ph"] == "M":
            # tracks are named: per-rank process rows plus a thread_name
            # row per (pid, tid)
            assert e["name"] in ("process_name", "thread_name")
            if e["name"] == "process_name":
                assert e["args"]["name"] == "rank 1"
            else:
                assert e["args"]["name"] in ("main", f"thread {e['tid']}")
    # the whole document serializes (what Perfetto actually loads)
    path = str(tmp_path / "trace.json")
    write_chrome_trace(tracer, path)
    loaded = json.load(open(path))
    assert len(loaded["traceEvents"]) == len(events)


def test_chrome_trace_nonfinite_attrs_serialize(tracer, tmp_path):
    with tracer.span("s", obj=object()):
        pass
    write_chrome_trace(tracer, str(tmp_path / "t.json"))  # default=str


# -- metrics ---------------------------------------------------------------

def test_counter_gauge_histogram():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(0.25)
    for v in [1.0, 2.0, 3.0, 4.0]:
        reg.histogram("h").observe(v)
    doc = reg.to_json()
    assert doc["counters"]["c"] == 5
    assert doc["gauges"]["g"] == 0.25
    h = doc["histograms"]["h"]
    assert h["count"] == 4 and h["sum"] == 10.0
    assert h["min"] == 1.0 and h["max"] == 4.0 and h["mean"] == 2.5
    assert json.dumps(doc)  # serializable as-is


def test_histogram_percentiles_match_numeric():
    reg = MetricsRegistry()
    xs = [float(i) for i in range(1, 101)]
    for v in xs:
        reg.histogram("h").observe(v)
    s = reg.histogram("h").summary()
    xs_sorted = sorted(xs)
    assert s["p50"] == percentile(xs_sorted, 50)
    assert s["p90"] == percentile(xs_sorted, 90)
    assert s["p99"] == percentile(xs_sorted, 99)


def test_empty_histogram_summary():
    assert MetricsRegistry().histogram("h").summary() == {"count": 0,
                                                          "sum": 0.0}


def test_registry_timer():
    reg = MetricsRegistry()
    with reg.timer("t.seconds"):
        pass
    s = reg.histogram("t.seconds").summary()
    assert s["count"] == 1 and s["sum"] >= 0


# -- utils.counters shim over obs.metrics ----------------------------------

def test_counters_shim_legacy_api(registry):
    c = Counters()
    with c.phase("SELECT"):
        pass
    with c.phase("SELECT"):
        pass
    with c.phase("BENCHMARK"):
        pass
    assert set(c.seconds) == {"SELECT", "BENCHMARK"}
    assert c.counts["SELECT"] == 2 and c.counts["BENCHMARK"] == 1
    assert all(v >= 0 for v in c.seconds.values())
    rep = c.report()
    assert rep.startswith("phase counters:")
    assert "SELECT" in rep and "x2" in rep


def test_counters_mirror_into_global_metrics(registry):
    c = Counters(prefix="mcts.phase")
    with c.phase("ROLLOUT"):
        pass
    doc = get_metrics().to_json()
    assert doc["histograms"]["mcts.phase.ROLLOUT.seconds"]["count"] == 1


def test_counters_phases_emit_spans_when_tracing(tracer, registry):
    c = Counters(prefix="dfs.phase")
    with c.phase("BENCHMARK"):
        pass
    with c.phase("DEDUP", span=False):  # hot-loop path stays spanless
        pass
    assert [s.name for s in tracer.spans()] == ["dfs.phase.BENCHMARK"]


def test_counters_isolated_between_instances(registry):
    a, b = Counters(), Counters()
    with a.phase("X"):
        pass
    assert "X" in a.seconds and "X" not in b.seconds


# -- progress reporter -----------------------------------------------------

def test_reporter_writes_stream_and_event_stream(tracer):
    buf = io.StringIO()
    rep = ProgressReporter(stream=buf)
    prev = set_reporter(rep)
    try:
        rep.warn("dfs budget exhausted", variants_left=2)
    finally:
        set_reporter(prev)
    assert buf.getvalue() == "dfs budget exhausted\n"
    evs = tracer.events()
    assert len(evs) == 1 and evs[0].name == "progress.warn"
    assert evs[0].attrs["message"] == "dfs budget exhausted"
    assert evs[0].attrs["variants_left"] == 2


def test_reporter_silent_stream_keeps_events(tracer):
    rep = ProgressReporter(stream=None)
    rep.info("quiet")
    assert tracer.events()[0].attrs["message"] == "quiet"


# -- solver integration: the event/span stream end to end ------------------

def _tiny_graph():
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.core.operation import NoOp

    g = Graph()
    a, b = NoOp("a"), NoOp("b")
    g.start_then(a)
    g.then(a, b)
    g.then_finish(b)
    return g


class _FakePlatform:
    def __init__(self, n=2):
        from tenzing_tpu_torch.core.resources import Lane

        self.lanes = [Lane(i) for i in range(n)]

    def provision_events(self, events):
        pass


class _FakeBench:
    def __init__(self):
        self.calls = 0

    def benchmark(self, order, opts=None):
        from tenzing_tpu_torch.bench.benchmarker import BenchResult

        self.calls += 1
        t = 1.0 / self.calls
        return BenchResult.from_times([t, t, t])


def test_dfs_explore_emits_counters_and_spans(tracer, registry, monkeypatch):
    """The tiny graph lowers, so its enumeration runs in the native core,
    whose whole wall is SELECT (it dedups inside): the phases equal the
    reference's with its native core on.  The Python walk's DEDUP phase:
    ``test_dfs_python_walk_counts_dedup``."""
    from tenzing_tpu.solve.dfs import DfsOpts as RefDfsOpts
    from tenzing_tpu.solve.dfs import explore as ref_explore
    from tenzing_tpu_torch.solve.dfs import DfsOpts, explore

    res = explore(_tiny_graph(), _FakePlatform(1), _FakeBench(),
                  DfsOpts(max_seqs=4))
    assert res.sims
    assert res.counters is not None
    assert "BENCHMARK" in res.counters.seconds
    assert "SELECT" in res.counters.seconds
    ref = ref_explore(_ref_tiny_graph(), _RefFakePlatform(1), _RefFakeBench(),
                      RefDfsOpts(max_seqs=4))
    # the reference also times its broadcast at world size 1 (BCAST), which
    # the port runs only over several ranks
    assert set(res.counters.seconds) == set(ref.counters.seconds) - {"BCAST"}
    names = [s.name for s in tracer.spans()]
    assert "dfs.explore" in names and "dfs.iter" in names
    iter_spans = [s for s in tracer.spans() if s.name == "dfs.iter"]
    assert all("schedule" in s.attrs and "pct50" in s.attrs
               for s in iter_spans)
    doc = get_metrics().to_json()
    assert doc["histograms"]["dfs.phase.BENCHMARK.seconds"]["count"] >= 1


def _ref_tiny_graph():
    from tenzing_tpu.core.graph import Graph
    from tenzing_tpu.core.operation import NoOp

    g = Graph()
    a, b = NoOp("a"), NoOp("b")
    g.start_then(a)
    g.then(a, b)
    g.then_finish(b)
    return g


class _RefFakePlatform:
    def __init__(self, n=2):
        from tenzing_tpu.core.resources import Lane

        self.lanes = [Lane(i) for i in range(n)]


class _RefFakeBench:
    def benchmark(self, order, opts=None):
        from tenzing_tpu.bench.benchmarker import BenchResult

        return BenchResult.from_times([1.0, 1.0, 1.0])


def test_dfs_python_walk_counts_dedup(registry):
    """The Python worklist (the path of a variant the native core does not
    take) times its dedup under DEDUP and its expansion under SELECT."""
    from tenzing_tpu_torch.solve.dfs import get_unique_sequences
    from tenzing_tpu_torch.utils.counters import Counters

    c = Counters(prefix="dfs.phase")
    assert get_unique_sequences(_tiny_graph(), _FakePlatform(1), 4,
                                counters=c)
    assert {"SELECT", "DEDUP"} <= set(c.seconds)


def test_mcts_explore_emits_iteration_spans(tracer, registry):
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore

    res = explore(_tiny_graph(), _FakePlatform(2), _FakeBench(),
                  MctsOpts(n_iters=6, seed=0, cache_benchmarks=False))
    assert res.sims
    iters = [s for s in tracer.spans() if s.name == "mcts.iter"]
    assert iters
    measured = [s for s in iters if "pct50" in s.attrs]
    assert measured
    assert all("schedule" in s.attrs for s in measured)
    assert any("tree_size" in s.attrs for s in iters)
    # the phase spans nest under the iteration span
    phase = [s for s in tracer.spans() if s.name.startswith("mcts.phase.")]
    ids = {s.span_id for s in iters}
    assert phase and all(s.parent_id in ids for s in phase)


def test_solver_run_exports_valid_bundle(tracer, registry, tmp_path):
    """End-to-end: a solver run's trace exports as schema-valid Chrome JSON
    + JSONL, and the metrics JSON carries solver phase timings — the same
    bundle the driver's ``--trace-out`` / ``--metrics-json`` write."""
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore

    explore(_tiny_graph(), _FakePlatform(2), _FakeBench(),
            MctsOpts(n_iters=4, seed=1, cache_benchmarks=False))
    write_chrome_trace(tracer, str(tmp_path / "trace.json"))
    doc = json.load(open(tmp_path / "trace.json"))
    assert doc["traceEvents"]
    for e in doc["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert "ts" in e and e["dur"] >= 0
    names = {e["name"] for e in doc["traceEvents"]}
    assert "mcts.explore" in names and "mcts.iter" in names
    write_jsonl(tracer, str(tmp_path / "trace.jsonl"))
    kinds = {r["kind"] for r in read_jsonl(str(tmp_path / "trace.jsonl"))}
    assert kinds == {"span"}  # this run emitted no instant events
    metrics = get_metrics().to_json()
    assert json.dumps(metrics)
    assert any(k.startswith("mcts.phase.") for k in metrics["histograms"])


def test_caching_benchmarker_cache_telemetry(tracer, registry):
    from tenzing_tpu_torch.bench.benchmarker import CachingBenchmarker
    from tenzing_tpu_torch.core.operation import NoOp
    from tenzing_tpu_torch.core.sequence import Sequence

    bench = CachingBenchmarker(_FakeBench())
    order = Sequence([NoOp("a")])
    bench.benchmark(order)
    bench.benchmark(order)
    assert bench.hits == 1 and bench.misses == 1
    assert bench.hit_rate == 0.5
    doc = get_metrics().to_json()
    assert doc["counters"]["bench.cache.hits"] == 1
    assert doc["counters"]["bench.cache.misses"] == 1
    assert doc["gauges"]["bench.cache.hit_rate"] == 0.5
    evs = [e for e in tracer.events() if e.name == "bench.cache"]
    assert [e.attrs["hit"] for e in evs] == [False, True]
    assert evs[0].attrs["schedule"] == evs[1].attrs["schedule"]


def test_bench_result_equality_ignores_provenance():
    from tenzing_tpu_torch.bench.benchmarker import BenchResult

    a = BenchResult.from_times([1.0, 1.0])
    b = BenchResult(pct01=1.0, pct10=1.0, pct50=1.0, pct90=1.0, pct99=1.0,
                    stddev=0.0)
    assert a == b


# -- export while a run is still open ---------------------------------------

def test_export_flushes_open_spans_and_resolves_parents(tracer):
    """An export taken mid-run must keep the in-flight spans — closed as
    copies with ``flushed: true`` — and emit no record whose parent id is
    missing from the bundle."""
    with tracer.span("mcts.explore"):
        with tracer.span("mcts.iter", it=3):
            with tracer.span("bench.benchmark"):
                text = to_jsonl(tracer)
    recs = [json.loads(line) for line in text.splitlines()]
    spans = {r["id"]: r for r in recs if r["kind"] == "span"}
    names = {r["name"] for r in spans.values()}
    assert {"mcts.explore", "mcts.iter", "bench.benchmark"} <= names
    for r in spans.values():
        assert r["attrs"].get("flushed") is True
        if r["parent"] is not None:
            assert r["parent"] in spans  # no dangling parent ids
    # flushed durations are up-to-now, monotone down the stack
    by_name = {r["name"]: r for r in spans.values()}
    assert by_name["mcts.explore"]["dur_us"] >= \
        by_name["mcts.iter"]["dur_us"] >= \
        by_name["bench.benchmark"]["dur_us"] >= 0


def test_flushed_span_not_duplicated_once_closed(tracer):
    with tracer.span("outer"):
        mid = to_jsonl(tracer)
    final = to_jsonl(tracer)
    assert sum(1 for line in mid.splitlines()
               if json.loads(line)["name"] == "outer") == 1
    outer = [json.loads(line) for line in final.splitlines()
             if json.loads(line)["name"] == "outer"]
    assert len(outer) == 1  # the finished record replaces the flushed copy
    assert "flushed" not in outer[0]["attrs"]


def test_export_flushes_other_threads_open_spans(tracer):
    """An export on the main thread still sees the in-flight spans of
    other threads."""
    import threading

    started = threading.Event()
    release = threading.Event()

    def worker():
        with tracer.span("bench.batch"):
            started.set()
            release.wait(5.0)

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert started.wait(5.0)
        recs = [json.loads(line) for line in to_jsonl(tracer).splitlines()]
        flushed = [r for r in recs if r["name"] == "bench.batch"]
        assert len(flushed) == 1 and flushed[0]["attrs"]["flushed"] is True
    finally:
        release.set()
        t.join(5.0)


def test_export_does_not_block_on_held_tracer_lock(tracer):
    """Exporting while another thread holds the tracer lock completes via
    the lock-free fallback instead of hanging."""
    import threading

    with tracer.span("held"):
        pass
    tracer._lock.acquire()
    try:
        out = {}

        def export():
            out["jsonl"] = to_jsonl(tracer)
            out["chrome"] = chrome_trace(tracer)

        t = threading.Thread(target=export, daemon=True)
        t.start()
        t.join(5.0)
        assert not t.is_alive(), "export deadlocked on the tracer lock"
    finally:
        tracer._lock.release()
    assert any(json.loads(line)["name"] == "held"
               for line in out["jsonl"].splitlines())
    assert any(e.get("name") == "held"
               for e in out["chrome"]["traceEvents"])


def test_metrics_to_json_does_not_block_on_held_locks(registry):
    import threading

    registry.counter("c").inc(3)
    h = registry.histogram("h")
    h.observe(1.0)
    h.observe(2.0)
    # both the registry lock and an instrument lock are held by "the
    # interrupted thread"
    registry._lock.acquire()
    h._lock.acquire()
    try:
        out = {}
        t = threading.Thread(
            target=lambda: out.update(doc=registry.to_json(block=False)),
            daemon=True)
        t.start()
        t.join(5.0)
        assert not t.is_alive(), "to_json deadlocked on instrument locks"
    finally:
        h._lock.release()
        registry._lock.release()
    assert out["doc"]["counters"]["c"] == 3
    assert out["doc"]["histograms"]["h"]["count"] == 2


def test_chrome_trace_includes_flushed_spans_with_valid_schema(tracer,
                                                               tmp_path):
    with tracer.span("open.one"):
        doc = chrome_trace(tracer)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert any(e["name"] == "open.one" and e["args"].get("flushed")
               for e in xs)
    for e in xs:
        assert e["dur"] >= 0 and isinstance(e["ts"], float)


# -- the driver's bundle ----------------------------------------------------

# what the reference's smoke run records (``bench.py --smoke --workload attn
# --trace-out D --metrics-json M --mcts-iters 4 --iters 3 --search-iters 2``)
REFERENCE_SMOKE_SPANS = {
    "bench.batch", "bench.batch_warm", "bench.benchmark", "bench.warm",
    "executor.build", "executor.compile", "mcts.explore", "mcts.iter",
    "mcts.phase.BACKPROP", "mcts.phase.BCAST", "mcts.phase.BENCHMARK",
    "mcts.phase.CONFIRM", "mcts.phase.EXPAND", "mcts.phase.REDUNDANT_SYNC",
    "mcts.phase.ROLLOUT", "mcts.phase.SELECT", "pipeline.precompile"}
REFERENCE_SMOKE_EVENTS = {"bench.cache"}
REFERENCE_SMOKE_COUNTERS = {
    "bench.benchmarks", "bench.cache.misses", "bench.measurements",
    "pipeline.prefetch.hits", "pipeline.prefetch.issued",
    "pipeline.prefetch.wasted"}
REFERENCE_SMOKE_GAUGES = {"bench.cache.hit_rate", "pipeline.queue_depth"}
# the records of layers the port does not have
NOT_IN_PORT = {
    # the compile stage is a CUDA-graph capture: on the CPU nothing is
    # captured and the executor records executor.build only
    "executor.compile",
    # the port's MCTS broadcasts only with more than one rank
    "mcts.phase.BCAST",
}
# what --profile-winner adds
PROFILE_SPANS = {"attrib.profile", "attrib.step"}


def test_driver_bundle_names_equal_reference(tmp_path, registry):
    from tenzing_tpu_torch.bench import driver

    prev = set_tracer(Tracer(enabled=False))
    try:
        res = driver.run(driver.DriverRequest(
            workload="attn", smoke=True, mcts_iters=4, iters=3,
            search_iters=2, profile_winner=True,
            trace_out=str(tmp_path / "trace"),
            metrics_json=str(tmp_path / "metrics.json")), device="cpu")
    finally:
        set_tracer(prev)
    line = json.loads(res.to_json_line())
    records = read_jsonl(str(tmp_path / "trace" / "trace.jsonl"))
    spans = {r["name"] for r in records if r["kind"] == "span"}
    events = {r["name"] for r in records if r["kind"] == "event"}
    assert spans == (REFERENCE_SMOKE_SPANS - NOT_IN_PORT) | PROFILE_SPANS
    assert events == REFERENCE_SMOKE_EVENTS
    doc = json.load(open(tmp_path / "trace" / "trace.json"))
    assert {"traceEvents", "displayTimeUnit"} == set(doc)
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert any(m["args"]["name"].startswith("attrib/winner/lane")
               for m in metas)
    metrics = json.load(open(tmp_path / "metrics.json"))
    assert set(metrics["counters"]) >= \
        REFERENCE_SMOKE_COUNTERS - NOT_IN_PORT
    assert set(metrics["gauges"]) == REFERENCE_SMOKE_GAUGES - NOT_IN_PORT
    assert {k for k in metrics["histograms"] if k.startswith("mcts.phase.")} \
        == {f"{n}.seconds" for n in REFERENCE_SMOKE_SPANS - NOT_IN_PORT
            if n.startswith("mcts.phase.")}
    assert metrics["counters"]["attrib.profiles"] >= 1
    explain = json.load(open(tmp_path / "trace" / "explain.json"))
    assert explain["attrib"]["n_timed"] == line["attrib"]["n_timed"] > 0
    a = line["attrib"]
    assert a["sum_of_parts_us"] >= a["critical_path_us"] > 0
    assert a["timers"]["host"] == a["n_timed"]  # the CPU times on the host
