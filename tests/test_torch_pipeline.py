"""The port's capture prefetch pipeline (bench/pipeline.py), mirroring the
reference's tests/test_pipeline_bench.py with the port's benchmarkers and
solvers and a fake executor (``precompile`` / ``is_compiled``):

* the issued / hit / wasted accounting, hints for captured schedules
  skipped, the queue bound dropping hints;
* a background failure surfaced once on the foreground call and classified
  by the port's ``fault.errors.classify_error``; a transient one consumed
  by the raise, so the retry reaches the real attempt;
* the trap handler closing the intake, and no thread left after
  ``close()``;
* MCTS, DFS and the hill-climb bit-identical with the pipeline on and off
  (hints consume no search RNG);
* wall-clock overlap of the captures with the measurements (a sleeping
  fake);
* the schedule-identity memo the dedup relies on."""

import hashlib
import json
import threading
import time

import pytest

from tenzing_tpu_torch.bench.benchmarker import (
    BenchOpts,
    BenchResult,
    CachingBenchmarker,
    CsvBenchmarker,
    result_row,
    schedule_id,
)
from tenzing_tpu_torch.bench.pipeline import PrefetchingBenchmarker
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.schedule import remove_redundant_syncs
from tenzing_tpu_torch.core.sequence import canonical_key
from tenzing_tpu_torch.core.serdes import sequence_to_json
from tenzing_tpu_torch.fault.errors import (
    FaultClass,
    TransientError,
    classify_error,
)
from tenzing_tpu_torch.models.spmv import SpMVCompound
from tenzing_tpu_torch.obs.metrics import MetricsRegistry, set_metrics
from tenzing_tpu_torch.obs.tracer import Tracer, set_tracer
from tenzing_tpu_torch.solve.dfs import DfsOpts, enumerate_schedules
from tenzing_tpu_torch.solve.dfs import explore as dfs_explore
from tenzing_tpu_torch.solve.local import LocalOpts, hill_climb
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


def _synth_result(seq) -> BenchResult:
    key = canonical_key(remove_redundant_syncs(seq))
    h = hashlib.sha256(repr(key).encode()).digest()
    t = 1.0 + int.from_bytes(h[:8], "big") / float(1 << 64)
    return BenchResult.from_times([t, t, t])


@pytest.fixture(scope="module")
def corpus():
    """The deduplicated 2-lane SpMV space as recorded CSV rows:
    deterministic answers, no device."""
    states = enumerate_schedules(_graph(), Platform.make_n_lanes(2),
                                 max_seqs=10_000, log=lambda m: None)
    assert 6 <= len(states) < 10_000
    rows = [result_row(i, _synth_result(st.sequence), st.sequence)
            for i, st in enumerate(states)]
    return rows, [st.sequence for st in states]


def mk_db(rows):
    return CsvBenchmarker(rows, _graph(), normalize=True)


class FakeExecutor:
    """Capture stand-in: ``precompile`` / ``is_compiled`` against a set,
    with an optional sleep per capture (the overlap test) and an optional
    failure oracle."""

    def __init__(self, compile_secs: float = 0.0, fail=None):
        self.compile_secs = compile_secs
        self.fail = fail
        self.compiled = set()
        self.precompiles = 0
        self._lock = threading.Lock()

    def is_compiled(self, order) -> bool:
        with self._lock:
            return schedule_id(order) in self.compiled

    def precompile(self, order) -> bool:
        if self.fail is not None:
            exc = self.fail(order)
            if exc is not None:
                raise exc
        if self.compile_secs:
            time.sleep(self.compile_secs)
        with self._lock:
            sid = schedule_id(order)
            if sid in self.compiled:
                return False
            self.compiled.add(sid)
            self.precompiles += 1
            return True


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("tz-prefetch") and t.is_alive()]


def _sims_key(sims):
    return [(canonical_key(remove_redundant_syncs(s.order)),
             s.result.pct50) for s in sims]


def _wait_for(cond, secs: float = 10.0) -> None:
    deadline = time.time() + secs
    while not cond() and time.time() < deadline:
        time.sleep(0.01)


# -- accounting / fault surfacing -------------------------------------------


def test_prefetch_issue_hit_wasted_accounting(corpus, registry, tracer):
    rows, terminals = corpus
    ex = FakeExecutor()
    p = PrefetchingBenchmarker(mk_db(rows), executor=ex, workers=2)
    try:
        assert p.prefetch(terminals[:3]) == 3
        # re-hinting is deduplicated, non-Sequence orders are skipped
        assert p.prefetch(terminals[:3] + ["not-a-sequence"]) == 0
        for o in terminals[:2]:
            p.benchmark(o, None)
        assert p.hits == 2
        # let the third (speculative) capture land before close(), which
        # cancels queued work
        _wait_for(lambda: p.wasted() >= 1)
    finally:
        p.close()
    assert p.issued == 3 and p.wasted() == 1 and p.failed == 0
    assert registry.counter("pipeline.prefetch.issued").value == 3
    assert registry.counter("pipeline.prefetch.hits").value == 2
    assert registry.counter("pipeline.prefetch.wasted").value == 1
    spans = [s for s in tracer.spans() if s.name == "pipeline.precompile"]
    assert len(spans) == 3
    assert not _prefetch_threads()  # close() joined the workers
    # closed: hints are no-ops, benchmark still answers
    assert p.prefetch(terminals[3:4]) == 0
    assert p.benchmark(terminals[0], None) == mk_db(rows).benchmark(
        terminals[0], None)
    assert p.stats() == {"workers": 2, "issued": 3, "hits": 2, "wasted": 1,
                         "failed": 0, "surfaced": 0, "dropped": 0}


def test_already_compiled_hints_are_skipped(corpus, registry):
    rows, terminals = corpus
    ex = FakeExecutor()
    ex.precompile(terminals[0])
    p = PrefetchingBenchmarker(mk_db(rows), executor=ex, workers=1)
    try:
        assert p.prefetch(terminals[:1]) == 0  # is_compiled short-circuits
        assert ex.precompiles == 1
    finally:
        p.close()


def test_queue_bound_drops_excess_hints(corpus, registry):
    rows, terminals = corpus
    n = min(len(terminals), 8)
    ex = FakeExecutor(compile_secs=0.2)
    p = PrefetchingBenchmarker(mk_db(rows), executor=ex, workers=1, depth=2)
    try:
        p.prefetch(terminals[:n])
        # worker=1, depth=2: at most 2 in flight; the rest dropped (and
        # re-hintable later), never queued unboundedly
        assert p.issued <= 2
        assert p.dropped >= n - 2
        assert registry.counter("pipeline.prefetch.dropped").value \
            == p.dropped
    finally:
        p.close()


class CountingDb:
    def __init__(self, db):
        self.db = db
        self.by_sid = {}

    def benchmark(self, order, opts=None):
        sid = schedule_id(order)
        self.by_sid[sid] = self.by_sid.get(sid, 0) + 1
        return self.db.benchmark(order, opts)


def test_background_failure_surfaces_once_classified(corpus, registry,
                                                     tracer):
    """A background capture failure is stored and raised on the FOREGROUND
    benchmark() call for that schedule, once, before any measurement; the
    port's taxonomy classifies it (a capture error is deterministic)."""
    rows, terminals = corpus
    bad = terminals[0]
    bad_sid = schedule_id(bad)
    ex = FakeExecutor(fail=lambda o: RuntimeError(
        "CUDA error: operation not permitted when stream is capturing")
        if schedule_id(o) == bad_sid else None)
    counting = CountingDb(mk_db(rows))
    p = PrefetchingBenchmarker(counting, executor=ex, workers=1)
    try:
        assert p.prefetch([bad, terminals[1]]) == 2
        with pytest.raises(RuntimeError, match="stream is capturing") as ei:
            p.benchmark(bad, None)
        assert classify_error(ei.value) == FaultClass.DETERMINISTIC
        assert counting.by_sid.get(bad_sid, 0) == 0  # never measured
        assert p.failed == 1 and p.surfaced == 1
        evs = [e for e in tracer.events()
               if e.name == "pipeline.precompile_failed"]
        assert evs and evs[0].attrs["error_class"] == "deterministic"
        # the healthy hint still measures normally (and was a prefetch hit)
        p.benchmark(terminals[1], None)
        assert counting.by_sid[schedule_id(terminals[1])] == 1
        assert p.hits == 1
    finally:
        p.close()
    assert not _prefetch_threads()


class BatchDb:
    """CsvBenchmarker plus the batch protocol (``benchmark_batch_times``);
    records the keywords it was handed."""

    def __init__(self, db):
        self.db = db
        self.batch_calls = 0
        self.last_kw = None

    def benchmark(self, order, opts=None):
        return self.db.benchmark(order, opts)

    def benchmark_batch_times(self, orders, opts=None, seed=0, **kw):
        self.batch_calls += 1
        self.last_kw = kw
        return [[self.db.benchmark(o, opts).pct50] * 3 for o in orders]


def test_batched_round_full_queue_drops_hints_without_blocking(
        corpus, registry):
    """A batch over a saturated pipeline drops its members' hints and still
    runs: the round never blocks behind speculative work hinted earlier,
    and the shed hints land on ``dropped``."""
    rows, terminals = corpus
    gate = threading.Event()

    class GatedExecutor(FakeExecutor):
        def precompile(self, order):
            gate.wait(30.0)
            return super().precompile(order)

    inner = BatchDb(mk_db(rows))
    p = PrefetchingBenchmarker(inner, executor=GatedExecutor(), workers=1,
                               depth=2)
    try:
        p.prefetch(terminals[:4])  # 1 parked on the gate + 1 queued
        assert p.issued == 2 and p.dropped == 2
        members = terminals[4:6]
        t0 = time.time()
        times = p.benchmark_batch_times(members, None, seed=3,
                                        group_seeds=[(1, 5), (1, 7)])
        assert time.time() - t0 < 5.0 and not gate.is_set()
        assert inner.batch_calls == 1
        assert inner.last_kw == {"group_seeds": [(1, 5), (1, 7)]}
        db = mk_db(rows)
        assert times == [[db.benchmark(o, None).pct50] * 3 for o in members]
        assert p.dropped == 4
        assert registry.counter("pipeline.prefetch.dropped").value == 4
    finally:
        gate.set()
        p.close()
    assert not _prefetch_threads()


def test_batched_round_surfaces_stored_failure_exactly_once(
        corpus, registry):
    rows, terminals = corpus
    bad, good = terminals[0], terminals[1]
    bad_sid = schedule_id(bad)
    ex = FakeExecutor(fail=lambda o: RuntimeError("injected capture fault")
                      if schedule_id(o) == bad_sid else None)
    inner = BatchDb(mk_db(rows))
    p = PrefetchingBenchmarker(inner, executor=ex, workers=1)
    try:
        assert p.prefetch([bad]) == 1
        _wait_for(lambda: p.failed >= 1)
        assert p.failed == 1
        with pytest.raises(RuntimeError, match="injected"):
            p.benchmark_batch_times([bad, good], None, seed=1)
        assert p.surfaced == 1 and inner.batch_calls == 0
        times = p.benchmark_batch_times([bad, good], None, seed=1)
        assert len(times) == 2 and inner.batch_calls == 1
        assert p.surfaced == 1  # consumed: no stale re-raise
        assert registry.counter("pipeline.prefetch.surfaced").value == 1
        assert p.hits == 1  # the healthy member's hint landed meanwhile
    finally:
        p.close()
    assert not _prefetch_threads()


def test_transient_background_failure_retries_through_to_real_attempt(
        corpus, registry):
    """A surfaced TRANSIENT failure is consumed by the raise: a retry (the
    caller's, on the transient verdict) reaches the real attempt."""
    rows, terminals = corpus
    armed = {"on": True}

    def fail(order):
        if armed["on"]:
            armed["on"] = False
            return TransientError("injected background flake")
        return None

    p = PrefetchingBenchmarker(mk_db(rows), executor=FakeExecutor(fail=fail),
                               workers=1)
    try:
        p.prefetch(terminals[:1])
        attempts, res = 0, None
        while res is None:
            attempts += 1
            try:
                res = p.benchmark(terminals[0], None)
            except Exception as e:
                assert classify_error(e) == FaultClass.TRANSIENT
                assert attempts < 3
        assert attempts == 2
        assert res == _synth_result(terminals[0])
        assert p.surfaced == 1
    finally:
        p.close()


def test_trap_handler_cancels_pending_compiles(corpus):
    rows, terminals = corpus
    n = min(len(terminals), 6)
    ex = FakeExecutor(compile_secs=0.3)
    p = PrefetchingBenchmarker(mk_db(rows), executor=ex, workers=1, depth=n)
    try:
        p.prefetch(terminals[:n])
        assert p.issued >= 2
        trap.run_callbacks()  # what the real SIGINT handler does
        assert p.prefetch(terminals[:n]) == 0  # closed to new work
    finally:
        p.close()
    # cancel_futures dropped the queued captures: far fewer ran than issued
    assert ex.precompiles <= 2
    assert not _prefetch_threads()
    assert p._trap_cancel not in trap.callbacks()


# -- the same search with the pipeline on and off ------------------------------


def test_solvers_bit_identical_prefetch_on_vs_off(corpus, registry):
    rows, _ = corpus
    g = _graph()
    plat = Platform.make_n_lanes(2)

    def run_all(prefetcher):
        mcts = explore(g, plat, mk_db(rows),
                       MctsOpts(n_iters=24, seed=3, prefetch=prefetcher))
        dfs = dfs_explore(g, plat, mk_db(rows),
                          DfsOpts(max_seqs=10_000, prefetch=prefetcher))
        return mcts, dfs

    off_mcts, off_dfs = run_all(None)
    p = PrefetchingBenchmarker(mk_db(rows), executor=FakeExecutor(),
                               workers=2)
    try:
        on_mcts, on_dfs = run_all(p)
        assert p.issued > 0  # the hints actually flowed
    finally:
        p.close()
    assert _sims_key(on_mcts.sims) == _sims_key(off_mcts.sims)
    assert on_mcts.tree_size == off_mcts.tree_size
    assert _sims_key(on_dfs.sims) == _sims_key(off_dfs.sims)
    assert not _prefetch_threads()


class _Rigged:
    """A deterministic benchmarker: a hash of the schedule JSON, with the
    batch protocol (the paired climb)."""

    def benchmark(self, seq, opts=None):
        return BenchResult.from_times([self._cost(seq)] * 3)

    def benchmark_batch_times(self, orders, opts=None, seed=0):
        return [[self._cost(s)] * opts.n_iters for s in orders]

    @staticmethod
    def _cost(seq) -> float:
        js = json.dumps(sequence_to_json(seq), sort_keys=True)
        h = hashlib.sha256(js.encode()).digest()
        return 1e-3 * (1.0 + int.from_bytes(h[:4], "little") / 2.0 ** 32)


@pytest.mark.parametrize("paired", [False, True])
def test_hill_climb_bit_identical_prefetch_on_vs_off(paired):
    """The neighbour batch is built before the measure loop with prefetch
    on (a pure replay): the accepted chain and every measured neighbour are
    the same with and without it."""
    from tenzing_tpu_torch.bench.driver import halo_alias_prefer
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import HALO_PHASES, build_graph

    g = build_graph(HaloArgs(nq=2, lx=4, ly=4, lz=4, radius=1),
                    impl_choice=True, xfer_choice=True)

    def climb(prefetcher):
        return hill_climb(
            g, Platform.make_n_lanes(3), CachingBenchmarker(_Rigged()),
            HALO_PHASES, prefer=halo_alias_prefer,
            opts=LocalOpts(budget=18, bench_opts=BenchOpts(n_iters=2),
                           seed=3, paired=paired, prefetch=prefetcher))

    off = climb(None)
    p = PrefetchingBenchmarker(None, executor=FakeExecutor(), workers=2)
    try:
        on = climb(p)
        assert p.issued > 0
    finally:
        p.close()

    def key(r):
        return ([(canonical_key(s.order), s.result.pct50) for s in r.sims],
                canonical_key(r.final.order), r.final.result.pct50)

    assert key(on) == key(off)
    assert not _prefetch_threads()


# -- capture/measure overlap ----------------------------------------------------


def test_wall_clock_overlap_beats_serialized_compile_plus_measure(corpus):
    """For a batch of candidates the pipelined wall is below the serialized
    capture + measure.  Capture is simulated at 80 ms (a sleep releases the
    GIL, as the CUDA calls of a capture do), measurement at 30 ms."""
    rows, terminals = corpus
    n = min(len(terminals), 6)
    cands = terminals[:n]
    compile_s, measure_s = 0.08, 0.03

    class SlowDeviceBench:
        """Captures inline when the schedule is not captured yet, as
        ``StreamExecutor.prepare_n`` does."""

        def __init__(self, ex, db):
            self.ex, self.db = ex, db

        def benchmark(self, order, opts=None):
            if not self.ex.is_compiled(order):
                self.ex.precompile(order)
            time.sleep(measure_s)
            return self.db.benchmark(order, opts)

    ex_off = FakeExecutor(compile_secs=compile_s)
    bench_off = SlowDeviceBench(ex_off, mk_db(rows))
    t0 = time.perf_counter()
    for o in cands:
        bench_off.benchmark(o, None)
    serial_wall = time.perf_counter() - t0
    assert serial_wall >= n * (compile_s + measure_s) * 0.9

    ex_on = FakeExecutor(compile_secs=compile_s)
    p = PrefetchingBenchmarker(SlowDeviceBench(ex_on, mk_db(rows)),
                               executor=ex_on, workers=4, depth=n)
    try:
        t0 = time.perf_counter()
        p.prefetch(cands)
        for o in cands:
            p.benchmark(o, None)
        pipe_wall = time.perf_counter() - t0
    finally:
        p.close()
    assert p.hits == n
    assert pipe_wall < 0.75 * serial_wall, (pipe_wall, serial_wall)


# -- schedule identity --------------------------------------------------------------


def test_sequence_memo_stable_and_invalidated_on_mutation(corpus):
    from tenzing_tpu_torch.core.resources import Event
    from tenzing_tpu_torch.core.serdes import sequence_to_json_str
    from tenzing_tpu_torch.core.sync_ops import EventSync

    _, terminals = corpus
    seq = terminals[0][:]
    k1 = canonical_key(seq)
    assert canonical_key(seq) is k1
    j1 = sequence_to_json_str(seq)
    assert sequence_to_json_str(seq) is j1
    s1 = schedule_id(seq)
    assert schedule_id(seq) is s1
    seq.push_back(EventSync(Event(0)))
    assert canonical_key(seq) != k1
    assert sequence_to_json_str(seq) != j1
    assert schedule_id(seq) != s1
    assert sequence_to_json_str(seq) == sequence_to_json_str(
        type(seq)(seq.vector()))


def test_rank_keeps_its_place_and_is_refused():
    """``rank`` is ported: the hints of a batch are issued fastest
    predicted first; a prediction that fails raises (the reference's
    ``except: pass`` would hint in the given order; ROADMAP Queue 3)."""
    from tenzing_tpu_torch.core.resources import Event
    from tenzing_tpu_torch.core.sequence import Sequence
    from tenzing_tpu_torch.core.sync_ops import EventSync

    class Rank:
        def __init__(self, order):
            self.order = order

        def predict(self, seq):
            return float(self.order.index(schedule_id(seq))), 0.0

    class Ordered(FakeExecutor):
        def __init__(self):
            super().__init__()
            self.order = []

        def precompile(self, order):
            self.order.append(schedule_id(order))
            return super().precompile(order)

    seqs = [Sequence([EventSync(Event(i))]) for i in range(3)]
    ids = [schedule_id(s) for s in seqs]
    fake = Ordered()
    with PrefetchingBenchmarker(None, executor=fake, workers=1,
                                rank=Rank(ids[::-1])) as pf:
        assert pf.prefetch(seqs) == 3
        deadline = time.time() + 30
        while len(fake.order) < 3 and time.time() < deadline:
            time.sleep(0.01)
    # one worker takes the hints in the order they were issued
    assert fake.order == ids[::-1]

    class Broken:
        def predict(self, seq):
            raise RuntimeError("no model")

    with PrefetchingBenchmarker(None, executor=FakeExecutor(),
                                rank=Broken()) as pf:
        with pytest.raises(RuntimeError, match="no model"):
            pf.prefetch(seqs)
    assert not _prefetch_threads()


@pytest.mark.parametrize("message,want", [
    ("CUDA error: an illegal memory access was encountered",
     FaultClass.DEVICE_LOST),
    ("CUDA error: unspecified launch failure", FaultClass.DEVICE_LOST),
    ("CUDA error: an illegal instruction was encountered",
     FaultClass.DEVICE_LOST),
    ("CUDA error: the launch timed out and was terminated",
     FaultClass.DEVICE_LOST),
    ("CUDA error: operation not permitted when stream is capturing",
     FaultClass.DETERMINISTIC),
    ("CUDA error: operation failed due to a previous error during capture",
     FaultClass.DETERMINISTIC),
    ("CUDA error: capture sequence contains a fork that was not joined to "
     "the primary stream", FaultClass.DETERMINISTIC),
    ("CUDA out of memory. Tried to allocate 2.00 GiB",
     FaultClass.DETERMINISTIC),
    ("rdma shift on axis 'x', collective id 0: the neighbour barrier timed "
     "out", FaultClass.TRANSIENT),
    ("Connection reset by peer", FaultClass.TRANSIENT),
    ("something else", FaultClass.DETERMINISTIC),
])
def test_classify_error_card_classes(message, want):
    assert classify_error(RuntimeError(message)) == want
