"""The port's checkpoint layer (tenzing_tpu_torch.fault.checkpoint) against
the reference's units (tests/test_checkpoint.py), and the file format
against the reference itself: a checkpoint directory either package writes
on the spmv smoke graph reads in the other with the same ``BenchResult``s
bit for bit and the same quarantine keys."""

import hashlib
import json
import os

import pytest

from tenzing_tpu_torch.bench.benchmarker import (
    BenchOpts,
    BenchResult,
    CachingBenchmarker,
    schedule_id,
)
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.sequence import canonical_key
from tenzing_tpu_torch.fault import (
    CheckpointError,
    FaultClass,
    JournalingBenchmarker,
    Quarantine,
    SearchCheckpoint,
    atomic_write_json,
    read_checked_json,
)
from tenzing_tpu_torch.fault.checkpoint import (
    PROVENANCE_DEGRADED,
    PROVENANCE_MEASURED,
)
from tenzing_tpu_torch.models.spmv import SpMVCompound, make_spmv_buffers
from tenzing_tpu_torch.solve.dfs import enumerate_schedules


def _x_sizes():
    bufs, _ = make_spmv_buffers(m=512, nnz_per_row=10, bw=None, seed=0)
    return {"x_local": int(bufs["x_local"].shape[0]),
            "x_remote": int(bufs["x_remote"].shape[0])}


X_SIZES = _x_sizes()


def _graph():
    """The driver's spmv smoke graph (bench/driver.py ``build_spmv`` at
    m=512): Start -> SpMVCompound -> Finish, the kernel menu on."""
    g = Graph()
    g.start_then(SpMVCompound(impl_choice=True, x_sizes=X_SIZES,
                              exchange="host"))
    g.then_finish(SpMVCompound(impl_choice=True, x_sizes=X_SIZES,
                               exchange="host"))
    return g


def _ref_graph():
    from tenzing_tpu.core.graph import Graph as RefGraph
    from tenzing_tpu.models.spmv import SpMVCompound as RefSpMV

    g = RefGraph()
    g.start_then(RefSpMV(impl_choice=True, x_sizes=X_SIZES, exchange="host"))
    g.then_finish(RefSpMV(impl_choice=True, x_sizes=X_SIZES, exchange="host"))
    return g


@pytest.fixture(scope="module")
def seqs():
    states = enumerate_schedules(_graph(), Platform.make_n_lanes(2),
                                 max_seqs=6)
    assert len(states) >= 3
    return [st.sequence for st in states]


def _res(t):
    return BenchResult.from_times([t, t * 1.01, t * 0.99])


class CountingBench:
    def __init__(self):
        self.calls = 0

    def benchmark(self, order, opts=None):
        self.calls += 1
        return _res(5.0)


# -- the atomic envelope ----------------------------------------------------------

def test_atomic_write_round_trips(tmp_path):
    path = str(tmp_path / "state.json")
    atomic_write_json(path, {"a": 1, "nested": {"b": [1, 2]}})
    assert read_checked_json(path) == {"a": 1, "nested": {"b": [1, 2]}}
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []


@pytest.mark.parametrize("tamper,match", [
    (lambda doc: doc["payload"].__setitem__("a", 2), "digest"),
    (lambda doc: doc.__setitem__("version", 999), "version"),
])
def test_tampered_envelope_raises(tmp_path, tamper, match):
    path = str(tmp_path / "state.json")
    atomic_write_json(path, {"a": 1})
    doc = json.load(open(path))
    tamper(doc)
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(CheckpointError, match=match):
        read_checked_json(path)


def test_truncated_file_raises(tmp_path):
    path = tmp_path / "state.json"
    atomic_write_json(str(path), {"a": 1})
    path.write_text(path.read_text()[:-10])
    with pytest.raises(CheckpointError):
        read_checked_json(str(path))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_envelope_reads_in_both_packages(tmp_path, writer):
    from tenzing_tpu.fault import checkpoint as ref_ck

    path = str(tmp_path / "state.json")
    payload = {"config": {"workload": "spmv"}, "mcts": {"it": 3}}
    (atomic_write_json if writer == "port" else ref_ck.atomic_write_json)(
        path, payload)
    assert read_checked_json(path) == ref_ck.read_checked_json(path) == payload


# -- state snapshots -------------------------------------------------------------

def test_save_state_merge_semantics(tmp_path):
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    ck.save_state(config={"workload": "spmv"})
    ck.save_state(mcts={"it": 3})
    ck.save_state(mcts={"it": 4}, done=True)
    got = SearchCheckpoint(str(tmp_path / "ckpt")).load_state()
    assert got == {"config": {"workload": "spmv"}, "mcts": {"it": 4},
                   "done": True}


def test_load_state_absent_is_none(tmp_path):
    assert SearchCheckpoint(str(tmp_path / "ckpt")).load_state() is None


def test_fence_env_raises_until_the_lease_is_ported(tmp_path, monkeypatch,
                                                    seqs):
    """``$TENZING_FENCE`` (``<lease-path>:<epoch>``, serve/lease.py): a
    write raises ``FencedWriteError`` unless the epoch is the newest the
    lease's registry recorded — here none, then epoch 3."""
    from tenzing_tpu_torch.fault.checkpoint import FENCE_ENV
    from tenzing_tpu_torch.fault.errors import FencedWriteError
    from tenzing_tpu_torch.serve.lease import epoch_registry_of

    lease = str(tmp_path / "lease")
    monkeypatch.setenv(FENCE_ENV, lease + ":3")
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    with pytest.raises(FencedWriteError, match="registry newest: 0"):
        ck.record(seqs[0], None, _res(1.0))
    os.makedirs(epoch_registry_of(lease))
    open(os.path.join(epoch_registry_of(lease), "c-3"), "w").close()
    ck.record(seqs[0], None, _res(1.0))
    ck.save_state({"mcts": {"it": 1}})
    ck.close()
    assert len(SearchCheckpoint(str(tmp_path / "ckpt")).load_measurements(
        _graph())) == 1


# -- the measurement journal ------------------------------------------------------

def test_journal_round_trips_sequences_and_results(tmp_path, seqs):
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    opts = BenchOpts(n_iters=7, max_retries=2, target_secs=0.01)
    ck.record(seqs[0], opts, _res(1.0))
    ck.record(seqs[1], None, _res(2.0), provenance=PROVENANCE_DEGRADED)
    got = ck.load_measurements(_graph())
    assert len(got) == 2
    (s0, o0, r0, p0), (s1, o1, r1, p1) = got
    assert o0 == opts and o1 is None
    assert r0.pct50 == 1.0 and r1.pct50 == 2.0
    assert r0.times is not None
    assert p0 == PROVENANCE_MEASURED and p1 == PROVENANCE_DEGRADED
    assert canonical_key(s0) == canonical_key(seqs[0])


def test_journal_skips_torn_tail_line(tmp_path, seqs):
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    ck.record(seqs[0], None, _res(1.0))
    ck.close()
    with open(ck.journal_path, "a") as f:
        f.write('{"opts": null, "prov": "measured", "resu')
    notes = []
    got = ck.load_measurements(_graph(), log=notes.append)
    assert len(got) == 1
    assert notes and "skipped" in notes[0]


def test_restore_into_answers_without_device(tmp_path, seqs):
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    opts = BenchOpts(n_iters=3, max_retries=1, target_secs=0.001)
    ck.record(seqs[0], opts, _res(1.5))
    ck.record(seqs[1], opts, _res(2.5))
    inner = CountingBench()
    cache = CachingBenchmarker(inner)
    assert ck.restore_into(cache, _graph()) == 2
    assert cache.benchmark(seqs[0], opts).pct50 == 1.5
    assert cache.benchmark(seqs[1], opts).pct50 == 2.5
    assert inner.calls == 0
    cache.benchmark(seqs[0], BenchOpts(n_iters=99))
    assert inner.calls == 1
    cache.benchmark(seqs[2], opts)
    assert inner.calls == 2


def test_restore_skips_non_measured_provenance(tmp_path, seqs):
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    ck.record(seqs[0], None, _res(1.0), provenance=PROVENANCE_DEGRADED)
    ck.record(seqs[1], None, _res(2.0), provenance="model")
    ck.record(seqs[2], None, _res(3.0))
    cache = CachingBenchmarker(CountingBench())
    assert ck.restore_into(cache, _graph()) == 1


def test_later_journal_lines_supersede(tmp_path, seqs):
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    ck.record(seqs[0], None, _res(1.0))
    ck.record(seqs[0], None, _res(9.0))
    cache = CachingBenchmarker(CountingBench())
    ck.restore_into(cache, _graph())
    assert cache.benchmark(seqs[0], None).pct50 == 9.0


def test_journaling_benchmarker_records_each_measurement(tmp_path, seqs):
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    inner = CountingBench()
    jb = JournalingBenchmarker(inner, ck)
    jb.benchmark(seqs[0], BenchOpts())
    jb.benchmark(seqs[1], BenchOpts())
    assert inner.calls == 2
    got = ck.load_measurements(_graph())
    assert len(got) == 2
    assert all(p == PROVENANCE_MEASURED for *_, p in got)


def test_journaling_benchmarker_tags_degraded(tmp_path, seqs):
    class DegradedInner:
        def was_degraded(self, order):
            return True

        def benchmark(self, order, opts=None):
            return _res(4.0)

    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    JournalingBenchmarker(DegradedInner(), ck).benchmark(seqs[0], None)
    (_, _, _, prov), = ck.load_measurements(_graph())
    assert prov == PROVENANCE_DEGRADED


# -- the batch journal and resume --------------------------------------------------

class SynthBatchBench:
    """A device stand-in with the batch protocol (the port's signature):
    times are a function of the schedule's canonical identity, so a run
    and its resume compare bit for bit."""

    def __init__(self):
        self.calls = 0
        self.batch_calls = 0

    def _t(self, order):
        h = hashlib.sha256(repr(canonical_key(order)).encode()).digest()
        return 1.0 + int.from_bytes(h[:8], "big") / float(1 << 64)

    def benchmark(self, order, opts=None):
        self.calls += 1
        t = self._t(order)
        return BenchResult.from_times([t, t, t])

    def benchmark_batch_times(self, orders, opts=None, seed=0):
        self.batch_calls += 1
        return [[self._t(o)] * 4 for o in orders]


def test_batch_journal_round_trips(tmp_path):
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    opts = BenchOpts(n_iters=4)
    ck.record_batch(["ida", "idb"], opts, 17, [[1.0, 2.0], [3.0, 4.0]])
    ck.record_batch(["ida", "idb"], opts, 18, [[5.0], [6.0]])
    got = SearchCheckpoint(str(tmp_path / "ckpt")).load_batches()
    key = (("ida", "idb"), 17, (opts.n_iters, opts.max_retries,
                                opts.target_secs))
    assert got[key] == [[1.0, 2.0], [3.0, 4.0]]
    assert len(got) == 2
    assert SearchCheckpoint(str(tmp_path / "ckpt")).load_measurements(
        _graph()) == []


def test_journaling_batch_replayed_on_resume(tmp_path, seqs):
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    inner1 = SynthBatchBench()
    jb1 = JournalingBenchmarker(inner1, ck)
    opts = BenchOpts(n_iters=2)
    t1 = jb1.benchmark_batch_times(seqs[:2], opts, seed=9)
    assert inner1.batch_calls == 1
    assert jb1.benchmark_batch_times(seqs[:2], opts, seed=9) == t1
    assert inner1.batch_calls == 1 and jb1.batch_hits == 1
    jb1.benchmark_batch_times(seqs[:2], opts, seed=10)
    assert inner1.batch_calls == 2

    ck2 = SearchCheckpoint(str(tmp_path / "ckpt"))
    inner2 = SynthBatchBench()
    jb2 = JournalingBenchmarker(inner2, ck2)
    ck2.restore_into(CachingBenchmarker(jb2), _graph())
    out = jb2.benchmark_batch_times(seqs[:2], opts, seed=9,
                                    times_out=[[], []])
    assert out == t1 and inner2.batch_calls == 0


def test_resumed_paired_climb_runs_zero_batches(tmp_path):
    """A resumed paired hill-climb answers its incumbent from the journal
    and every accept batch from the batch journal, charging no budget for
    them, and rebuilds the same chain."""
    from tenzing_tpu_torch.solve.local import LocalOpts, hill_climb

    g = _graph()
    plat = Platform.make_n_lanes(2)
    phases = ("scatter", "exchange", "spmv", "y_add")
    lopts = dict(budget=200, paired=True, seed=11,
                 bench_opts=BenchOpts(n_iters=2))
    ckdir = str(tmp_path / "ckpt")
    ck1 = SearchCheckpoint(ckdir)
    inner1 = SynthBatchBench()
    res1 = hill_climb(g, plat,
                      CachingBenchmarker(JournalingBenchmarker(inner1, ck1)),
                      phases, opts=LocalOpts(checkpoint=ck1, **lopts))
    assert inner1.batch_calls > 0

    ck2 = SearchCheckpoint(ckdir)
    inner2 = SynthBatchBench()
    bench2 = CachingBenchmarker(JournalingBenchmarker(inner2, ck2))
    assert ck2.restore_into(bench2, g) > 0
    res2 = hill_climb(g, plat, bench2, phases,
                      opts=LocalOpts(checkpoint=ck2, **lopts))
    assert inner2.calls == 0 and inner2.batch_calls == 0
    assert canonical_key(res2.final.order) == canonical_key(res1.final.order)
    assert [s.result.pct50 for s in res2.sims] == \
        [s.result.pct50 for s in res1.sims]
    assert res2.spent == 0 and res1.spent > 0
    assert SearchCheckpoint(ckdir).load_state()["climb"]["n_sims"] == \
        len(res2.sims)


# -- the directory, across packages --------------------------------------------------

def _write_ref(directory, ref_seqs, opts_list):
    """A checkpoint directory written by the reference: a measured row and a
    degraded one per schedule, a batch line, two quarantine entries."""
    from tenzing_tpu.bench.benchmarker import BenchOpts as RefOpts
    from tenzing_tpu.bench.benchmarker import BenchResult as RefResult
    from tenzing_tpu.fault import Quarantine as RefQuarantine
    from tenzing_tpu.fault import SearchCheckpoint as RefCheckpoint
    from tenzing_tpu.fault.errors import FaultClass as RefFault

    ck = RefCheckpoint(directory)
    for i, (s, o) in enumerate(zip(ref_seqs, opts_list)):
        ro = None if o is None else RefOpts(*o)
        t = 1e-4 * (1.0 + i / 7.0)
        ck.record(s, ro, RefResult.from_times([t, t * 1.0001, t / 3.0]))
        ck.record(s, ro, RefResult.from_times([9.0]), provenance="degraded")
    ck.record_batch(["a1b2c3d4e5f6", "0123456789ab"], RefOpts(5, 2, 0.02), 3,
                    [[1e-4, 2e-4], [3e-4, 1.0 / 3.0]])
    ck.save_state(config={"workload": "spmv"}, done=True)
    ck.close()
    q = RefQuarantine(ck.quarantine_path)
    for s in ref_seqs[:2]:
        q.add(s, ValueError("broken"), RefFault.DETERMINISTIC)


def _write_port(directory, port_seqs, opts_list):
    ck = SearchCheckpoint(directory)
    for i, (s, o) in enumerate(zip(port_seqs, opts_list)):
        bo = None if o is None else BenchOpts(*o)
        t = 1e-4 * (1.0 + i / 7.0)
        ck.record(s, bo, BenchResult.from_times([t, t * 1.0001, t / 3.0]))
        ck.record(s, bo, BenchResult.from_times([9.0]),
                  provenance=PROVENANCE_DEGRADED)
    ck.record_batch(["a1b2c3d4e5f6", "0123456789ab"], BenchOpts(5, 2, 0.02), 3,
                    [[1e-4, 2e-4], [3e-4, 1.0 / 3.0]])
    ck.save_state(config={"workload": "spmv"}, done=True)
    ck.close()
    q = Quarantine(ck.quarantine_path)
    for s in port_seqs[:2]:
        q.add(s, ValueError("broken"), FaultClass.DETERMINISTIC)


def _read_ref(directory, rg):
    from tenzing_tpu.bench.benchmarker import schedule_id as ref_sid
    from tenzing_tpu.fault import Quarantine as RefQuarantine
    from tenzing_tpu.fault import SearchCheckpoint as RefCheckpoint

    ck = RefCheckpoint(directory)
    rows = [(ref_sid(s), None if o is None else
             (o.n_iters, o.max_retries, o.target_secs), r.to_json(), p)
            for s, o, r, p in ck.load_measurements(rg)]
    return (rows, ck.load_batches(), ck.load_state(),
            sorted(RefQuarantine(ck.quarantine_path).entries))


def _read_port(directory, pg):
    ck = SearchCheckpoint(directory)
    rows = [(schedule_id(s), None if o is None else
             (o.n_iters, o.max_retries, o.target_secs), r.to_json(), p)
            for s, o, r, p in ck.load_measurements(pg)]
    return (rows, ck.load_batches(), ck.load_state(),
            sorted(Quarantine(ck.quarantine_path).entries))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_directory_reads_in_both_packages(tmp_path, writer):
    """Written by one package on the spmv smoke graph, read by both: the
    same rows (schedule ids, fidelity keys, results bit for bit,
    provenance), batches, state and quarantine keys; and the port restores
    only the measured rows."""
    from tenzing_tpu.core.platform import Platform as RefPlatform
    from tenzing_tpu.core.serdes import sequence_to_json
    from tenzing_tpu.solve.dfs import enumerate_schedules as ref_enum
    from tenzing_tpu_torch.core.serdes import sequence_from_json

    rg, pg = _ref_graph(), _graph()
    ref_seqs = [st.sequence for st in ref_enum(rg, RefPlatform.make_n_lanes(2),
                                                max_seqs=4)]
    port_seqs = [sequence_from_json(sequence_to_json(s), pg)
                 for s in ref_seqs]
    opts_list = [(3, 2, 0.01), None, (5, 2, 0.002), (2, 2, 0.0005)][
        :len(ref_seqs)]
    d = str(tmp_path / "ckpt")
    (_write_ref if writer == "reference" else _write_port)(
        d, ref_seqs if writer == "reference" else port_seqs, opts_list)
    port_view, ref_view = _read_port(d, pg), _read_ref(d, rg)
    assert port_view == ref_view
    rows, batches, state, quarantined = port_view
    assert len(rows) == 2 * len(ref_seqs) and len(batches) == 1
    assert state == {"config": {"workload": "spmv"}, "done": True}
    assert quarantined == sorted(schedule_id(s) for s in port_seqs[:2])
    cache = CachingBenchmarker(CountingBench())
    assert SearchCheckpoint(d).restore_into(cache, pg) == len(ref_seqs)
    for i, (s, o) in enumerate(zip(port_seqs, opts_list)):
        got = cache.benchmark(s, None if o is None else BenchOpts(*o))
        t = 1e-4 * (1.0 + i / 7.0)
        assert got == BenchResult.from_times([t, t * 1.0001, t / 3.0])
        assert got.times == [t, t * 1.0001, t / 3.0]
    assert cache.inner.calls == 0
