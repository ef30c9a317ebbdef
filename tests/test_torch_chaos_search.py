"""Chaos, checkpoint and resume of the port's searches (the counterparts of
tests/test_chaos_search.py:206, :313, :374, :459, :572, :590), plus the two
properties the card adds: the watchdog never leaves two measurements
running at once, and an attempt that never returns is a device loss.

A seeded MCTS and DFS over a recorded corpus (the whole deduplicated
two-lane space of the SpMV compound, replayed through ``CsvBenchmarker``:
no device, every answer deterministic) run under seeded fault injection."""

import hashlib
import json
import threading
import time
from collections import Counter

import pytest

from tenzing_tpu_torch.bench.benchmarker import (
    BenchOpts,
    BenchResult,
    CachingBenchmarker,
    CsvBenchmarker,
    result_row,
    schedule_id,
)
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.schedule import remove_redundant_syncs
from tenzing_tpu_torch.core.sequence import canonical_key
from tenzing_tpu_torch.fault import (
    BackoffPolicy,
    DeviceLostError,
    FaultInjectingBenchmarker,
    InjectSpec,
    JournalingBenchmarker,
    Quarantine,
    QuarantinedScheduleError,
    ResilientBenchmarker,
    SearchCheckpoint,
    cancel,
)
from tenzing_tpu_torch.fault.inject import _schedule_fails
from tenzing_tpu_torch.models.spmv import SpMVCompound
from tenzing_tpu_torch.obs.export import to_jsonl
from tenzing_tpu_torch.obs.metrics import MetricsRegistry, set_metrics
from tenzing_tpu_torch.obs.tracer import Tracer, get_tracer, set_tracer
from tenzing_tpu_torch.solve.dfs import DfsOpts, enumerate_schedules
from tenzing_tpu_torch.solve.dfs import explore as dfs_explore
from tenzing_tpu_torch.solve.mcts import MctsOpts, explore
from tenzing_tpu_torch.utils import trap


@pytest.fixture
def tracer():
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


def _graph():
    g = Graph()
    g.start_then(SpMVCompound())
    g.then_finish(SpMVCompound())
    return g


def _key(order):
    return canonical_key(remove_redundant_syncs(order))


def _synth_result(seq) -> BenchResult:
    h = hashlib.sha256(repr(_key(seq)).encode()).digest()
    t = 1.0 + int.from_bytes(h[:8], "big") / float(1 << 64)
    return BenchResult.from_times([t, t, t])


@pytest.fixture(scope="module")
def corpus():
    states = enumerate_schedules(_graph(), Platform.make_n_lanes(2),
                                 max_seqs=10_000)
    assert 3 <= len(states) < 10_000
    rows = [result_row(i, _synth_result(st.sequence), st.sequence)
            for i, st in enumerate(states)]
    return rows, [st.sequence for st in states]


def mk_db(rows):
    return CsvBenchmarker(rows, _graph(), normalize=True)


class CountingInner:
    """Counts attempts and completions per (canonical key, opts) and per
    schedule id; optionally simulates a SIGINT mid-measurement after N
    attempts (the trap callbacks, then ``KeyboardInterrupt``)."""

    def __init__(self, db, interrupt_after=None, on_interrupt=None):
        self.db = db
        self.attempts = Counter()
        self.completed = Counter()
        self.by_sid = Counter()
        self.orders = {}
        self.total = 0
        self.interrupt_after = interrupt_after
        self.on_interrupt = on_interrupt

    def _k(self, order, opts):
        ok = (opts.n_iters, opts.max_retries, opts.target_secs) if opts \
            else None
        return (_key(order), ok)

    def benchmark(self, order, opts=None):
        self.total += 1
        self.attempts[self._k(order, opts)] += 1
        sid = schedule_id(order)
        self.by_sid[sid] += 1
        self.orders[sid] = order
        if self.interrupt_after is not None and \
                self.total >= self.interrupt_after:
            if self.on_interrupt is not None:
                self.on_interrupt()
            trap.run_callbacks()
            raise KeyboardInterrupt
        res = self.db.benchmark(order, opts)
        self.completed[self._k(order, opts)] += 1
        return res


def _fast_policy():
    return BackoffPolicy(retries=8, base_secs=0.0, jitter=0.0)


# the recorded corpus answers at any options; these add nothing to the
# watchdog's bound (fault/resilient.py adds each measurement's own floor)
CSV_OPTS = BenchOpts(n_iters=1, max_retries=1, target_secs=0.0)


def _best(sims):
    s = min(sims, key=lambda s: s.result.pct50)
    return _key(s.order), s.result.pct50


def _validate_bundle(text):
    recs = [json.loads(line) for line in text.splitlines()]
    spans = {r["id"]: r for r in recs if r["kind"] == "span"}
    for r in spans.values():
        assert r["dur_us"] >= 0
        if r["parent"] is not None:
            assert r["parent"] in spans, f"dangling parent in {r['name']}"
    flushed = {r["name"] for r in spans.values()
               if r["attrs"].get("flushed")}
    assert "mcts.explore" in flushed and "mcts.iter" in flushed
    return recs


DET_SPEC = InjectSpec("deterministic", 0.12, 5)
CHAOS_SPECS = [DET_SPEC,
               InjectSpec("transient", 0.25, 31),
               InjectSpec("hang", 0.05, 53)]


def _chaos_stack(rows, quarantine_path, ckpt=None, interrupt_after=None,
                 on_interrupt=None):
    inject = FaultInjectingBenchmarker(mk_db(rows), CHAOS_SPECS,
                                       hang_secs=2.5)
    counting = CountingInner(inject, interrupt_after=interrupt_after,
                             on_interrupt=on_interrupt)
    resilient = ResilientBenchmarker(
        counting, timeout_secs=1.0, policy=_fast_policy(),
        quarantine=Quarantine(quarantine_path), sleep=lambda s: None)
    layer = JournalingBenchmarker(resilient, ckpt) if ckpt else resilient
    return CachingBenchmarker(layer), counting, inject, resilient


def test_chaos_search_finds_clean_best_with_kill_and_resume(
        tmp_path, tracer, registry, corpus):
    rows, terminals = corpus
    plat = Platform.make_n_lanes(2)
    n_iters = 30
    mcts_clean = explore(_graph(), plat, mk_db(rows),
                         MctsOpts(n_iters=n_iters, seed=3,
                                  bench_opts=CSV_OPTS))
    dfs_clean = dfs_explore(_graph(), plat, mk_db(rows),
                            DfsOpts(max_seqs=10_000, bench_opts=CSV_OPTS))
    assert len(dfs_clean.sims) == len(terminals)
    clean_key, clean_pct50 = _best(mcts_clean.sims + dfs_clean.sims)
    best_raw = min(terminals, key=lambda s: _synth_result(s).pct50)
    for spelling in (best_raw, remove_redundant_syncs(best_raw)):
        assert not _schedule_fails(schedule_id(spelling), DET_SPEC)

    # phase A: injected faults, killed mid-measurement
    ckdir = str(tmp_path / "ckpt")
    qpath = str(tmp_path / "ckpt" / "quarantine.json")
    ckpt = SearchCheckpoint(ckdir)
    bundles = []
    bench_a, count_a, inject_a, _ = _chaos_stack(
        rows, qpath, ckpt=ckpt, interrupt_after=16,
        on_interrupt=lambda: bundles.append(to_jsonl(get_tracer())))
    with pytest.raises(KeyboardInterrupt):
        explore(_graph(), plat, bench_a,
                MctsOpts(n_iters=n_iters, seed=3, checkpoint=ckpt,
                         bench_opts=CSV_OPTS))
    _validate_bundle(bundles[0])
    assert SearchCheckpoint(ckdir).load_state()["mcts"]["interrupted"] is True

    # phase B: resume; the quarantine and the journal carry over
    ckpt2 = SearchCheckpoint(ckdir)
    bench_b, count_b, inject_b, _ = _chaos_stack(rows, qpath, ckpt=ckpt2)
    assert ckpt2.restore_into(bench_b, _graph()) > 0
    res_mcts = explore(_graph(), plat, bench_b,
                       MctsOpts(n_iters=n_iters, seed=3, checkpoint=ckpt2,
                                bench_opts=CSV_OPTS))
    res_dfs = dfs_explore(_graph(), plat, bench_b,
                          DfsOpts(max_seqs=10_000, checkpoint=ckpt2,
                                  bench_opts=CSV_OPTS))
    assert _best(res_mcts.sims + res_dfs.sims) == (clean_key, clean_pct50)
    for key in count_a.completed:
        assert count_b.completed[key] == 0

    calls = inject_a.calls + inject_b.calls
    transients = (inject_a.injected["transient"]
                  + inject_b.injected["transient"])
    hangs = inject_a.injected["hang"] + inject_b.injected["hang"]
    dets = (inject_a.injected["deterministic"]
            + inject_b.injected["deterministic"])
    assert calls > 50
    assert transients >= 0.2 * calls
    assert hangs >= 2 and dets >= 1

    errs = [e for e in tracer.events() if e.name == "fault.error"]
    assert len(errs) == transients + hangs + dets
    assert all(e.attrs["error_class"] in
               ("transient", "deterministic", "device_lost") for e in errs)
    assert any(e.attrs["error"] == "MeasurementTimeout" for e in errs)
    assert len([e for e in tracer.events()
                if e.name == "fault.retry"]) >= transients

    quar = Quarantine(qpath)
    assert len(quar) >= 1
    for sid in quar.entries:
        assert count_a.by_sid[sid] + count_b.by_sid[sid] <= 1
    qevents = [e for e in tracer.events() if e.name == "fault.quarantine"]
    assert {e.attrs["schedule"] for e in qevents} == set(quar.entries)
    sid = next(iter(quar.entries))
    order = {**count_a.orders, **count_b.orders}[sid]
    before = count_a.by_sid[sid] + count_b.by_sid[sid]
    with pytest.raises(QuarantinedScheduleError):
        bench_b.benchmark(order, None)
    assert count_a.by_sid[sid] + count_b.by_sid[sid] == before
    assert registry.counter("fault.quarantine_hits").value >= 1


def test_resume_after_interrupt_no_remeasure_and_same_best(
        tmp_path, tracer, corpus):
    rows, _ = corpus
    plat = Platform.make_n_lanes(2)
    opts = dict(n_iters=24, seed=3)
    ref_inner = CountingInner(mk_db(rows))
    ref = explore(_graph(), plat,
                  CachingBenchmarker(ResilientBenchmarker(
                      ref_inner, policy=_fast_policy())),
                  MctsOpts(**opts))
    assert ref_inner.total > 10

    ckdir = str(tmp_path / "ckpt")
    ckpt = SearchCheckpoint(ckdir)
    bundles = []
    inner1 = CountingInner(
        mk_db(rows), interrupt_after=9,
        on_interrupt=lambda: bundles.append(to_jsonl(get_tracer())))
    bench1 = CachingBenchmarker(JournalingBenchmarker(
        ResilientBenchmarker(inner1, policy=_fast_policy()), ckpt))
    with pytest.raises(KeyboardInterrupt):
        explore(_graph(), plat, bench1, MctsOpts(**opts, checkpoint=ckpt))
    _validate_bundle(bundles[0])

    ckpt2 = SearchCheckpoint(ckdir)
    inner2 = CountingInner(mk_db(rows))
    bench2 = CachingBenchmarker(JournalingBenchmarker(
        ResilientBenchmarker(inner2, policy=_fast_policy()), ckpt2))
    assert ckpt2.restore_into(bench2, _graph()) == \
        sum(inner1.completed.values()) > 0
    res = explore(_graph(), plat, bench2, MctsOpts(**opts, checkpoint=ckpt2))
    for key in inner1.completed:
        assert inner2.attempts[key] == 0
    combined = inner1.completed + inner2.completed
    assert combined and max(combined.values()) == 1
    assert _best(res.sims) == _best(ref.sims)
    assert [s.result.pct50 for s in res.sims] == \
        [s.result.pct50 for s in ref.sims]
    assert SearchCheckpoint(ckdir).load_state()["mcts"]["it"] == \
        opts["n_iters"] - 1


def test_resume_of_a_finished_chaos_run_measures_nothing_new(tmp_path,
                                                             corpus):
    """Resuming a finished chaos run replays it from the journal: a query
    whose retries ran out draws the same faults again, so nothing is
    measured and the search is the same.  The injector counts attempts per
    schedule and fidelity: counted per schedule (the reference's), a
    confirm at the full floor continues the count of the same schedule's
    screen measurement, runs out of retries on fresh draws, and on resume —
    its screen answer now from the journal — starts at attempt 0 and is
    measured."""
    rows, _ = corpus
    g, plat = _graph(), Platform.make_n_lanes(2)
    mopts = dict(n_iters=30, seed=3, bench_opts=CSV_OPTS, confirm_topk=8,
                 screen_opts=BenchOpts(n_iters=2, max_retries=1,
                                       target_secs=0.0))
    ckdir = str(tmp_path / "ckpt")

    def stack(ck):
        inj = FaultInjectingBenchmarker(mk_db(rows),
                                        [InjectSpec("transient", 0.6, 11)])
        counting = CountingInner(inj)
        rb = ResilientBenchmarker(
            counting, policy=BackoffPolicy(retries=1, base_secs=0.0),
            sleep=lambda s: None)
        return CachingBenchmarker(JournalingBenchmarker(rb, ck)), counting

    ck1 = SearchCheckpoint(ckdir)
    bench1, count1 = stack(ck1)
    res1 = explore(g, plat, bench1, MctsOpts(**mopts, checkpoint=ck1))
    # the chaos happened: queries ran out of retries and were rejected
    assert [k for k in count1.attempts if count1.completed[k] == 0]

    ck2 = SearchCheckpoint(ckdir)
    bench2, count2 = stack(ck2)
    assert ck2.restore_into(bench2, g) == sum(count1.completed.values())
    res2 = explore(g, plat, bench2, MctsOpts(**mopts, checkpoint=ck2))
    assert sum(count2.completed.values()) == 0
    assert [(_key(s.order), s.result.pct50) for s in res2.sims] == \
        [(_key(s.order), s.result.pct50) for s in res1.sims]


CORRUPT_SPEC = InjectSpec("corrupt", 0.25, 7)


def _oracle_unsound_check():
    """The original oracle (the reference's EventSynchronizer, through
    tests/test_verify.oracle_unsound_check) on the reference's copy of each
    schedule: the verifier under test never picks the mutations."""
    from tenzing_tpu.core.graph import Graph as RefGraph
    from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
    from tenzing_tpu.models.spmv import SpMVCompound as RefSpMV
    from tenzing_tpu.solve.dfs import expand_all as ref_expand_all
    from tenzing_tpu_torch.core.serdes import sequence_to_json

    from tests.test_verify import oracle_unsound_check

    rg = RefGraph()
    rg.start_then(RefSpMV())
    rg.then_finish(RefSpMV())
    evolved = ref_expand_all(rg.clone())
    check = oracle_unsound_check(evolved)
    return lambda seq: check(ref_from_json(sequence_to_json(seq), evolved))


def test_corruption_chaos_every_mutation_caught(tmp_path, tracer, registry,
                                                corpus):
    from tenzing_tpu_torch.verify import ScheduleVerifier, verify_schedule

    rows, terminals = corpus
    g = _graph()
    plat = Platform.make_n_lanes(2)
    mcts_clean = explore(g, plat, mk_db(rows), MctsOpts(n_iters=30, seed=3))
    dfs_clean = dfs_explore(g, plat, mk_db(rows), DfsOpts(max_seqs=10_000))
    clean = _best(mcts_clean.sims + dfs_clean.sims)
    best_raw = min(terminals, key=lambda s: _synth_result(s).pct50)
    for spelling in (best_raw, remove_redundant_syncs(best_raw)):
        assert not _schedule_fails(schedule_id(spelling), CORRUPT_SPEC)

    qpath = str(tmp_path / "quarantine.json")
    counting = CountingInner(mk_db(rows))
    quar = Quarantine(qpath)
    resilient = ResilientBenchmarker(
        counting, policy=_fast_policy(), quarantine=quar,
        verifier=ScheduleVerifier(g), sleep=lambda s: None)
    inject = FaultInjectingBenchmarker(resilient, [CORRUPT_SPEC],
                                       unsound_check=_oracle_unsound_check())
    bench = CachingBenchmarker(inject)
    res_mcts = explore(g, plat, bench, MctsOpts(n_iters=30, seed=3))
    res_dfs = dfs_explore(g, plat, bench, DfsOpts(max_seqs=10_000))

    assert inject.injected["corrupt"] >= 1
    assert len(inject.corrupted) >= 0.15 * len(terminals)
    measured = set(counting.by_sid)
    for orig, mutated in inject.corrupted.items():
        assert mutated in quar.entries, "a corruption escaped the verifier"
        assert mutated not in measured
    for order in counting.orders.values():
        assert verify_schedule(order, g).ok
    unsound = [e for e in tracer.events() if e.name == "verify.unsound"]
    assert len(unsound) >= len(inject.corrupted)
    assert registry.counter("verify.unsound").value >= len(inject.corrupted)
    assert _best(res_mcts.sims + res_dfs.sims) == clean


COMPILE_FAIL_SPEC = InjectSpec("deterministic", 0.1, 77)


def test_chaos_with_prefetch_matches_prefetch_off(tmp_path, tracer,
                                                  registry, corpus):
    """With the capture pipeline on, a seeded chaos search is the same as
    with it off; background capture failures classify and quarantine
    through the resilient layer; no pipeline thread leaks."""
    from tenzing_tpu_torch.bench.pipeline import PrefetchingBenchmarker

    from tests.test_torch_pipeline import FakeExecutor

    rows, terminals = corpus
    plat = Platform.make_n_lanes(2)

    def compile_fails(order) -> bool:
        return _schedule_fails(schedule_id(order), COMPILE_FAIL_SPEC)

    best_raw = min(terminals, key=lambda s: _synth_result(s).pct50)
    for spelling in (best_raw, remove_redundant_syncs(best_raw)):
        assert not compile_fails(spelling)
        assert not _schedule_fails(schedule_id(spelling), DET_SPEC)
    fails = [s for s in terminals if compile_fails(s)]
    assert fails

    class CaptureGate:
        """The foreground capture: the seeded subset cannot be captured."""

        def __init__(self, inner):
            self.inner = inner

        def benchmark(self, order, opts=None):
            if compile_fails(order):
                raise RuntimeError(
                    f"operation not permitted when stream is capturing "
                    f"(chaos {schedule_id(order)})")
            return self.inner.benchmark(order, opts)

    def run(qdir, prefetcher, counting):
        quar = Quarantine(str(tmp_path / qdir / "quarantine.json"))
        resilient = ResilientBenchmarker(
            prefetcher if prefetcher is not None else counting,
            timeout_secs=1.0, policy=_fast_policy(), quarantine=quar,
            sleep=lambda s: None)
        bench = CachingBenchmarker(resilient)
        mcts = explore(_graph(), plat, bench,
                       MctsOpts(n_iters=30, seed=3, prefetch=prefetcher,
                                bench_opts=CSV_OPTS))
        dfs = dfs_explore(_graph(), plat, bench,
                          DfsOpts(max_seqs=10_000, prefetch=prefetcher,
                                  bench_opts=CSV_OPTS))
        return mcts, dfs, quar

    off_count = CountingInner(CaptureGate(FaultInjectingBenchmarker(
        mk_db(rows), CHAOS_SPECS, hang_secs=2.5)))
    off_mcts, off_dfs, off_quar = run("off", None, off_count)

    ex = FakeExecutor(fail=lambda o: RuntimeError(
        f"operation not permitted when stream is capturing "
        f"(chaos {schedule_id(o)})") if compile_fails(o) else None)
    count_on = CountingInner(CaptureGate(FaultInjectingBenchmarker(
        mk_db(rows), CHAOS_SPECS, hang_secs=2.5)))
    p = PrefetchingBenchmarker(count_on, executor=ex, workers=2)
    try:
        p.prefetch([fails[0]])
        on_mcts, on_dfs, quar_on = run("on", p, count_on)
        assert p.issued > 0
    finally:
        p.close()

    sims_key = lambda res: [(_key(s.order), s.result.pct50)  # noqa: E731
                            for s in res.sims]
    assert sims_key(on_mcts) == sims_key(off_mcts)
    assert sims_key(on_dfs) == sims_key(off_dfs)
    assert _best(on_mcts.sims + on_dfs.sims) == \
        _best(off_mcts.sims + off_dfs.sims) == \
        (_key(best_raw), _synth_result(best_raw).pct50)
    assert p.failed >= 1 and p.surfaced >= 1
    pevs = [e for e in tracer.events()
            if e.name == "pipeline.precompile_failed"]
    assert pevs and all(
        e.attrs["error_class"] == "deterministic" for e in pevs)
    assert set(quar_on.entries) == set(off_quar.entries)
    for sid in quar_on.entries:
        assert count_on.by_sid[sid] <= 1 and off_count.by_sid[sid] <= 1
    assert not [t for t in threading.enumerate()
                if t.name.startswith("tz-prefetch") and t.is_alive()]


def test_device_lost_without_fallback_escalates_out_of_search(corpus):
    rows, _ = corpus
    plat = Platform.make_n_lanes(2)
    inject = FaultInjectingBenchmarker(
        mk_db(rows), [InjectSpec("device_lost", 1.0, 9)])
    rb = ResilientBenchmarker(inject, policy=_fast_policy(),
                              sleep=lambda s: None)
    with pytest.raises(DeviceLostError):
        explore(_graph(), plat, rb, MctsOpts(n_iters=5, seed=3))
    with pytest.raises(DeviceLostError):
        dfs_explore(_graph(), plat, rb, DfsOpts(max_seqs=10_000))


def test_device_lost_with_fallback_finishes_degraded(tmp_path, corpus,
                                                     tracer):
    """With a fallback the search finishes; every answer after the loss is
    marked degraded, journaled as such and never restored."""
    rows, _ = corpus
    plat = Platform.make_n_lanes(2)

    class Fallback:
        def benchmark(self, order, opts=None):
            return _synth_result(order)

    inner = CountingInner(mk_db(rows))
    calls = {"n": 0}

    class LoseAfter:
        def benchmark(self, order, opts=None):
            calls["n"] += 1
            if calls["n"] == 4:
                raise DeviceLostError("the card is gone")
            return inner.benchmark(order, opts)

    rb = ResilientBenchmarker(LoseAfter(), policy=_fast_policy(),
                              fallback=Fallback(), sleep=lambda s: None)
    ckpt = SearchCheckpoint(str(tmp_path / "ckpt"))
    res = explore(_graph(), plat,
                  CachingBenchmarker(JournalingBenchmarker(rb, ckpt)),
                  MctsOpts(n_iters=12, seed=3))
    assert rb.degraded and len(res.sims) == 12
    assert [s for s in res.sims if rb.was_degraded(s.order)]
    assert any(e.name == "fault.degraded" for e in tracer.events())
    provs = Counter(p for *_, p in ckpt.load_measurements(_graph()))
    assert provs["degraded"] > 0 and provs["measured"] == inner.total
    assert ckpt.restore_into(CachingBenchmarker(mk_db(rows)), _graph()) == \
        inner.total


# -- the card's properties: no overlap, a stuck attempt is a device loss ----------

class OverlapRecorder:
    """An inner benchmarker that records each call's entry and exit and the
    thread it ran on; it stalls ``stall`` seconds on the calls listed (on
    the cancel token, or ignoring it with ``honour_token=False``)."""

    def __init__(self, stall_calls=(), stall=5.0, honour_token=True):
        self.stall_calls = set(stall_calls)
        self.stall = stall
        self.honour_token = honour_token
        self.intervals = []
        self.threads = set()
        self._lock = threading.Lock()
        self._live = 0
        self.max_live = 0
        self.calls = 0

    def benchmark(self, order, opts=None):
        with self._lock:
            self.calls += 1
            n = self.calls
            self._live += 1
            self.max_live = max(self.max_live, self._live)
        t0 = time.monotonic()
        self.threads.add(threading.current_thread().name)
        try:
            if n in self.stall_calls:
                if self.honour_token:
                    cancel.wait(self.stall)
                else:
                    time.sleep(self.stall)
            cancel.check()  # what the executor does before each launch
            return _synth_result(order)
        finally:
            with self._lock:
                self._live -= 1
            self.intervals.append((t0, time.monotonic()))


@pytest.mark.parametrize("honour_token", [True, False])
def test_watchdog_never_overlaps_two_measurements(corpus, honour_token):
    """Timed-out attempts are drained before the retry starts: no two inner
    calls overlap, whether the stalled attempt ends on its cancel token or
    only when its own work finishes (within the drain bound); every call
    runs on the one measurement thread."""
    _, terminals = corpus
    inner = OverlapRecorder(stall_calls={2, 5, 6}, stall=0.4,
                            honour_token=honour_token)
    drained = []
    rb = ResilientBenchmarker(inner, timeout_secs=0.1,
                              policy=_fast_policy(), sleep=lambda s: None,
                              quiesce=lambda: drained.append(inner._live))
    for seq in terminals[:6]:
        rb.benchmark(seq, None)
    assert inner.calls == 9  # three timed out and were retried
    assert inner.max_live == 1
    spans = sorted(inner.intervals)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert inner.threads == {"tz-measure"}
    # the device was quiesced only once the abandoned attempt had returned
    assert drained and all(live == 0 for live in drained)


def test_watchdog_cancels_an_injected_hang_before_it_measures(corpus):
    """An injected hang waits on the cancel token: when the watchdog fires,
    the abandoned attempt never reaches the device."""
    _, terminals = corpus
    inner = OverlapRecorder()
    inj = FaultInjectingBenchmarker(inner, [InjectSpec("hang", 1.0, 1)],
                                    hang_secs=30.0)
    rb = ResilientBenchmarker(inj, timeout_secs=0.05,
                              policy=BackoffPolicy(retries=1, base_secs=0.0),
                              sleep=lambda s: None)
    t0 = time.monotonic()
    with pytest.raises(Exception) as ei:
        rb.benchmark(terminals[0], None)
    assert type(ei.value).__name__ == "MeasurementTimeout"
    assert time.monotonic() - t0 < 5.0
    assert inner.calls == 0 and inj.injected["hang"] == 2


def test_stuck_worker_is_a_device_loss_that_leaves_the_search(corpus,
                                                              registry):
    """An attempt that does not return within the drain bound after its
    watchdog fired means the card is stuck: ``DeviceLostError`` leaves the
    search, and nothing else is measured."""
    _, terminals = corpus
    release = threading.Event()

    class Stuck:
        calls = 0

        def benchmark(self, order, opts=None):
            Stuck.calls += 1
            if Stuck.calls == 3:
                release.wait(60.0)  # ignores its cancel token
            return _synth_result(order)

    rb = ResilientBenchmarker(Stuck(), timeout_secs=0.05,
                              policy=_fast_policy(), sleep=lambda s: None)
    try:
        with pytest.raises(DeviceLostError, match="did not return"):
            explore(_graph(), Platform.make_n_lanes(2),
                    CachingBenchmarker(rb),
                    MctsOpts(n_iters=20, seed=3, bench_opts=CSV_OPTS))
        assert Stuck.calls == 3
        assert registry.counter("fault.watchdog.stuck").value == 1
        assert registry.counter("fault.device_lost_fatal").value == 1
    finally:
        release.set()


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sticky error and the graph "
                    "replay run only on the card)")
    return torch.device("cuda")


STICKY_CHILD = r"""
import json, os, sys
import torch
from tenzing_tpu_torch.bench.benchmarker import BenchResult
from tenzing_tpu_torch.fault import DeviceLostError, ResilientBenchmarker
from tenzing_tpu_torch.runtime.graphs import device_sync

dev = torch.device("cuda", 0)

class Assert:
    def benchmark(self, order, opts=None):
        x = torch.zeros(4, device=dev)
        idx = torch.full((1,), 1 << 20, dtype=torch.long, device=dev)
        x[idx].sum().item()
        return BenchResult.from_times([1.0])

rb = ResilientBenchmarker(Assert(), quiesce=lambda: device_sync(dev))
try:
    rb.benchmark("sched")
except Exception as e:
    print(json.dumps({"error": type(e).__name__, "message": str(e)[:400],
                      "cause": type(e.__cause__).__name__}), flush=True)
    os._exit(3)
print(json.dumps({"error": None}), flush=True)
"""


@pytest.mark.needs_cuda
def test_cuda_sticky_error_is_a_device_loss_in_a_subprocess(cuda_device):
    """A device-side assert (an out-of-range CUDA index) is a sticky error:
    the resilient layer classifies it ``device_lost`` and raises
    ``DeviceLostError``; the process ends (a fresh one is the recovery)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", STICKY_CHILD], cwd=repo,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 3, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["error"] == "DeviceLostError"
    assert "device-side assert" in out["message"]


@pytest.mark.needs_cuda
def test_cuda_watchdog_drains_a_graph_replay_without_overlap(cuda_device):
    """A watchdog that fires while a measurement replays CUDA graphs (one
    that would replay for 30 s): the replay stops at its next segment (the
    cancel token), the attempt drains before the next starts, no two
    measurements overlap, and the card is usable after."""
    import torch

    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.bench.benchmarker import EmpiricalBenchmarker
    from tenzing_tpu_torch.fault import MeasurementTimeout
    from tenzing_tpu_torch.models.spmv import fixed_orders as spmv_orders
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.runtime.graphs import device_sync

    g, bufs, _, _ = driver.build_spmv(
        driver.DriverRequest(workload="spmv", m=8192), cuda_device)
    ex = StreamExecutor(Platform.make_n_lanes(2), bufs, device="cuda")
    order = spmv_orders(g)["pallas-2l"]
    emp = EmpiricalBenchmarker(ex)
    live, spans, replays = [0], [], [0]
    lock = threading.Lock()

    class Recorder:
        def benchmark(self, o, opts=None):
            with lock:
                live[0] += 1
                assert live[0] == 1, "two measurements at once"
            t0 = time.monotonic()
            try:
                if opts is not None:
                    return emp.benchmark(o, opts)
                run_n = ex.prepare_n(o)  # captured before the loop
                while time.monotonic() - t0 < 30.0:
                    run_n(1)
                    replays[0] += 1
                return BenchResult.from_times([1.0])
            finally:
                spans.append((t0, time.monotonic()))
                with lock:
                    live[0] -= 1

    emp.benchmark(order, BenchOpts(n_iters=2, target_secs=0.001))  # capture
    quiet = []
    rb = ResilientBenchmarker(
        Recorder(), timeout_secs=0.3,
        policy=BackoffPolicy(retries=2, base_secs=0.0), sleep=lambda s: None,
        quiesce=lambda: (device_sync(cuda_device), quiet.append(live[0])))
    t0 = time.monotonic()
    with pytest.raises(MeasurementTimeout):
        rb.benchmark(order, None)
    assert len(spans) == 3 and time.monotonic() - t0 < 3 * (0.3 + 1.0)
    assert replays[0] > 0
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(b - a < 0.3 + 1.0 for a, b in spans)  # drained promptly
    assert quiet and all(n == 0 for n in quiet)
    res = rb.benchmark(order, BenchOpts(n_iters=3, target_secs=0.001))
    assert res.pct50 > 0
    torch.cuda.synchronize()
