"""The learned screen of the port (tenzing_tpu_torch/learn/, the solvers'
prescreen, the prefetcher's rank, the driver's ``--learn-*`` flags and the
degraded verdict) against the JAX package's (tenzing_tpu/learn/; reference
tests test_learn.py), test for test:

* **features** — the contract and its determinism, the per-engine bytes;
  ``FEATURE_NAMES`` is the reference's, and on the same schedules the
  port's vector equals the reference's given the reference's ``ModelEnv``;
* **dataset** — regime normalization and merging, anchorless and
  screen-anchor files skipped, trace joins; the corpus of
  ``experiments/halo_search_tpu_r4[ac].csv`` has the reference's rows and
  labels;
* **model** — the ridge ensemble's coefficients and predictions equal the
  reference's (the same numpy calls: bit for bit), a model the reference
  saved loads in the port and predicts the same, and the reverse;
* **screen** — the ranking and screening economy gates of the reference
  (Spearman >= 0.8; half the measurements, the same best), fidelity
  escalation, calibration, ``was_predicted``;
* **solvers** — DFS and the hill-climb prescreen; the prefetcher's rank;
* **driver** — ``--learn-train`` / ``--learn-screen`` on the CPU smoke,
  and the degraded verdict after an injected device loss with a fallback.
"""

import glob
import json
import math
import os
import random
from dataclasses import asdict

import numpy as np
import pytest

from tenzing_tpu.bench.benchmarker import result_row as ref_result_row
from tenzing_tpu.bench.model import ModelEnv as RefModelEnv
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu.learn import Corpus as RefCorpus
from tenzing_tpu.learn import RidgeEnsemble as RefRidge
from tenzing_tpu.learn import featurize as ref_featurize
from tenzing_tpu.learn import features as ref_features
from tenzing_tpu_torch.bench.benchmarker import (
    BenchOpts,
    BenchResult,
    result_row,
    schedule_id,
)
from tenzing_tpu_torch.bench.model import AnalyticBenchmarker, ModelEnv
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import DeviceOp, Finish, Start
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.resources import Lane
from tenzing_tpu_torch.core.sequence import Sequence, canonical_key
from tenzing_tpu_torch.core.serdes import sequence_to_json
from tenzing_tpu_torch.learn import (
    FEATURE_NAMES,
    Corpus,
    RidgeEnsemble,
    ScreeningBenchmarker,
    SurrogateBenchmarker,
    featurize,
    spearman,
)
from tenzing_tpu_torch.learn import features
from tenzing_tpu_torch.obs.metrics import MetricsRegistry, get_metrics, set_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ENV = ModelEnv(**asdict(RefModelEnv()))


class KOp(DeviceOp):
    """An independent device op reading one sized buffer."""

    def __init__(self, name, buf):
        super().__init__(name)
        self._buf = buf

    def reads(self):
        return [self._buf]

    def apply(self, bufs, ctx):
        return None


SIZES = [1, 3, 7, 13, 24, 40, 11, 29]  # MB per op's input buffer


def _mk_graph():
    g = Graph()
    nbytes, ops = {}, []
    for i, s in enumerate(SIZES):
        buf = f"buf{i}"
        nbytes[buf] = s << 20
        op = KOp(f"k{i}", buf)
        ops.append(op)
        g.start_then(op)
        g.then_finish(op)
    return g, ops, nbytes


def _random_schedules(ops, n, n_lanes=2, seed=0):
    rng = random.Random(seed)
    out, seen = [], set()
    while len(out) < n:
        perm = rng.sample(ops, len(ops))
        seq = Sequence([Start()] + [op.bind(Lane(rng.randrange(n_lanes)))
                                    for op in perm] + [Finish()])
        k = canonical_key(seq)
        if k not in seen:
            seen.add(k)
            out.append(seq)
    return out


def _res(t):
    t = float(t)
    return BenchResult(pct01=t, pct10=t, pct50=t, pct90=t, pct99=t, stddev=0.0)


def _write_db(path, naive_seq, naive_t, entries, regime, rng, noise=0.04,
              screen_rows=()):
    rows = [result_row(0, _res(naive_t * regime), naive_seq)]
    for j, (seq, t) in enumerate(entries):
        meas = t * regime * math.exp(rng.normal(0.0, noise))
        rows.append(result_row(j + 1, _res(meas), seq))
    for j, (seq, t) in enumerate(screen_rows):
        rows.append(result_row(len(entries) + 1 + j, _res(t), seq,
                               fidelity="screen"))
    path.write_text("\n".join(rows) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference test's world: a graph, 64 schedules, the analytic
    ground truth, a corpus in two regimes (1.0 and 1.4) and the surrogate
    trained on it."""
    tmp = tmp_path_factory.mktemp("learn_corpus")
    g, ops, nbytes = _mk_graph()
    seqs = _random_schedules(ops, 64, n_lanes=2, seed=0)
    ab = AnalyticBenchmarker(nbytes)
    truth = np.array([ab.makespan(s) for s in seqs])
    naive = Sequence([Start()] + [op.bind(Lane(0)) for op in ops] + [Finish()])
    naive_t = float(ab.makespan(naive))
    rng = np.random.RandomState(7)
    a = _write_db(tmp / "a.csv", naive, naive_t,
                  [(seqs[i], truth[i]) for i in range(0, 64, 2)], 1.0, rng)
    b = _write_db(tmp / "b.csv", naive, naive_t,
                  [(seqs[i], truth[i]) for i in range(1, 64, 2)]
                  + [(seqs[0], truth[0]), (seqs[2], truth[2])], 1.4, rng,
                  screen_rows=[(seqs[1], truth[1] * 0.01),
                               (seqs[3], truth[3] * 0.01)])
    corpus = Corpus.from_files([a, b], g)
    X, y = corpus.matrices(nbytes=nbytes)
    model = RidgeEnsemble(feature_names=list(FEATURE_NAMES)).fit(X, y)
    return {"graph": g, "ops": ops, "nbytes": nbytes, "seqs": seqs,
            "truth": truth, "naive": naive, "naive_t": naive_t,
            "corpus": corpus, "model": model, "paths": (a, b)}


@pytest.fixture
def fresh_metrics():
    prev = set_metrics(MetricsRegistry())
    yield get_metrics()
    set_metrics(prev)


# -- features --------------------------------------------------------------------


def test_feature_names_and_literals_are_the_references():
    from tenzing_tpu_torch.core.chunking import CHUNK_MARK
    from tenzing_tpu_torch.runtime.fused import TILE_PREFIX

    assert FEATURE_NAMES == ref_features.FEATURE_NAMES
    assert features._CHUNK_MARK == CHUNK_MARK == ref_features._CHUNK_MARK
    assert features._TILE_PREFIX == TILE_PREFIX == ref_features._TILE_PREFIX
    assert features._XFER_KINDS == ref_features._XFER_KINDS


def test_featurize_contract_and_determinism(world):
    s = world["seqs"][0]
    v1 = featurize(s, nbytes=world["nbytes"])
    assert v1 == featurize(s, nbytes=world["nbytes"])
    assert len(v1) == len(FEATURE_NAMES)
    names = dict(zip(FEATURE_NAMES, v1))
    assert names["n_device"] == len(SIZES) and names["n_lanes"] == 2.0
    assert names["analytic_makespan"] > 0.0
    nv = dict(zip(FEATURE_NAMES, featurize(world["naive"],
                                           nbytes=world["nbytes"])))
    assert nv["n_lanes"] == 1.0 and nv["serial_frac"] == 1.0
    assert nv["analytic_makespan"] > names["analytic_makespan"]


def test_featurize_comm_bytes_per_engine():
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import build_graph
    from tenzing_tpu_torch.solve.dfs import get_unique_sequences

    g = build_graph(HaloArgs(nq=1, lx=2, ly=2, lz=2, radius=1),
                    xfer_choice=True)
    seqs = [st.sequence for st in get_unique_sequences(
        g, Platform.make_n_lanes(2), max_seqs=6)]
    names = set()
    for s in seqs:
        for op in s:
            for f in ("reads", "writes"):
                fn = getattr(op, f, None)
                if callable(fn):
                    names.update(fn())
    vecs = [dict(zip(FEATURE_NAMES, featurize(s, nbytes={n: 4096 for n in names})))
            for s in seqs]
    assert any(v["ici_bytes"] > 0 or v["pcie_bytes"] > 0 for v in vecs)
    for v in vecs:
        assert v["n_sync"] == sum(v[f"n_{k}"] for k in (
            "event_record", "wait_event", "event_sync", "lane_sync",
            "lane_wait"))


@pytest.fixture(scope="module")
def halo_graphs():
    """The full-size halo driver graphs of both packages (no buffer)."""
    from tenzing_tpu.models import halo as rh
    from tenzing_tpu.models import halo_pipeline as rhp
    from tenzing_tpu_torch.models import halo_pipeline as hp
    from tenzing_tpu_torch.models.halo import HaloArgs

    full = dict(nq=3, lx=512, ly=512, lz=512, radius=3)
    return (hp.build_graph(HaloArgs(**full), impl_choice=True,
                           xfer_choice=True),
            rhp.build_graph(rh.HaloArgs(**full), impl_choice=True,
                            xfer_choice=True))


CORPUS_FILES = sorted(glob.glob(os.path.join(
    REPO, "experiments", "halo_search_tpu_r4[ac].csv")))


@pytest.fixture(scope="module")
def corpora(halo_graphs):
    """Both packages' corpora of ``CORPUS_FILES`` (TPU databases: valid
    inputs for parity, never the card's numbers), with a byte map over
    every buffer their rows touch."""
    from tenzing_tpu.core import serdes as ref_serdes

    g, rg = halo_graphs
    # the reference walks its graph once per op it reads back: memoized
    # per (graph, name), every graph kept alive so no id is reused
    # (tests/test_torch_recorded.py)
    find, memo, keep = ref_serdes._find_by_name, {}, []

    def memoized(graph, name):
        if (id(graph), name) not in memo:
            keep.append(graph)
            memo[(id(graph), name)] = find(graph, name)
        return memo[(id(graph), name)]

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_serdes, "_find_by_name", memoized)
    try:
        port = Corpus.from_files(CORPUS_FILES, g)
        ref = RefCorpus.from_files(CORPUS_FILES, rg)
    finally:
        mp.undo()
    names = sorted({n for r in port.rows for op in r.seq
                    for f in ("reads", "writes")
                    for n in (getattr(op, f)() if callable(
                        getattr(op, f, None)) else ())})
    nbytes = {n: 4096 * (1 + i % 7) for i, n in enumerate(names)}
    return port, ref, nbytes


def test_featurize_equals_reference_under_its_env(corpora):
    port, ref, nbytes = corpora
    for pr, rr in list(zip(port.rows, ref.rows))[::9]:
        assert featurize(pr.seq, nbytes=nbytes, env=REF_ENV) == \
            ref_featurize(rr.seq, nbytes=nbytes), pr.source


def test_featurize_defaults_are_the_cards(corpora):
    port, _, nbytes = corpora
    seq = port.rows[0].seq
    assert featurize(seq, nbytes=nbytes) == featurize(
        seq, nbytes=nbytes, env=ModelEnv())
    assert featurize(seq, nbytes=nbytes) != featurize(seq, nbytes=nbytes,
                                                      env=REF_ENV)


# -- dataset ---------------------------------------------------------------------


def test_corpus_of_the_recorded_databases_equals_reference(corpora):
    port, ref, _ = corpora
    assert len(port.rows) == len(ref.rows) > 100
    assert (port.n_files, port.n_skipped, port.n_screen, port.n_merged) == (
        ref.n_files, ref.n_skipped, ref.n_screen, ref.n_merged)
    for pr, rr in zip(port.rows, ref.rows):
        assert pr.label == rr.label and pr.pct50 == rr.pct50
        assert pr.anchor == rr.anchor and pr.schedules == rr.schedules
        assert json.dumps(sequence_to_json(pr.seq)) == json.dumps(
            ref_to_json(rr.seq))


def test_corpus_regime_normalization_and_merge(world):
    corpus = world["corpus"]
    assert len(corpus.rows) == 65
    assert corpus.n_merged == 3 and corpus.n_screen == 2
    row0 = next(r for r in corpus.rows
                if r.key == canonical_key(world["seqs"][0]))
    want = math.log(world["truth"][0] / world["naive_t"])
    assert abs(row0.label - want) < 0.15
    assert row0.ratio == pytest.approx(math.exp(-row0.label))


def test_corpus_skips_anchorless_and_screen_anchor_files(tmp_path, world):
    seqs, truth = world["seqs"], world["truth"]
    p1 = tmp_path / "noanchor.csv"
    p1.write_text(result_row(3, _res(truth[0]), seqs[0]) + "\n")
    p2 = tmp_path / "screenanchor.csv"
    p2.write_text(result_row(0, _res(world["naive_t"] * 0.01), world["naive"],
                             fidelity="screen") + "\n"
                  + result_row(1, _res(truth[1]), seqs[1]) + "\n")
    msgs = []
    corpus = Corpus.from_files([str(p1), str(p2)], world["graph"],
                               log=msgs.append)
    assert corpus.rows == []
    assert sum("no naive anchor" in m for m in msgs) == 2


def test_solver_dumps_are_anchorless(tmp_path, world):
    from tenzing_tpu_torch.bench.recorded import naive_anchor_of
    from tenzing_tpu_torch.solve.dfs import DfsResult
    from tenzing_tpu_torch.solve.dfs import SimResult as DfsSim
    from tenzing_tpu_torch.solve.mcts.mcts import MctsResult, SimResult

    seqs, truth = world["seqs"], world["truth"]
    p1 = tmp_path / "dfs.csv"
    DfsResult(sims=[DfsSim(order=s, result=_res(t))
                    for s, t in zip(seqs[:3], truth[:3])]).dump_csv(str(p1))
    p2 = tmp_path / "mcts.csv"
    MctsResult(sims=[SimResult(order=s, result=_res(t))
                     for s, t in zip(seqs[:3], truth[:3])]).dump_csv(str(p2))
    assert naive_anchor_of(str(p1)) is None and naive_anchor_of(str(p2)) is None
    msgs = []
    assert Corpus.from_files([str(p1), str(p2)], world["graph"],
                             log=msgs.append).rows == []
    assert sum("no naive anchor" in m for m in msgs) == 2


def test_merged_rows_join_traces_under_every_digest(tmp_path, world):
    ops = world["ops"]
    a_seq = Sequence([Start()] + [op.bind(Lane(i % 2))
                                  for i, op in enumerate(ops)] + [Finish()])
    b_seq = Sequence([Start()] + [op.bind(Lane((i + 1) % 2))
                                  for i, op in enumerate(ops)] + [Finish()])
    assert canonical_key(a_seq) == canonical_key(b_seq)
    assert schedule_id(a_seq) != schedule_id(b_seq)
    rng = np.random.RandomState(0)
    pa = _write_db(tmp_path / "a.csv", world["naive"], world["naive_t"],
                   [(a_seq, 1e-3)], 1.0, rng)
    pb = _write_db(tmp_path / "b.csv", world["naive"], world["naive_t"],
                   [(b_seq, 1e-3)], 1.0, rng)
    corpus = Corpus.from_files([pa, pb], world["graph"])
    row = next(r for r in corpus.rows if r.key == canonical_key(a_seq))
    assert set(row.schedules) == {schedule_id(a_seq), schedule_id(b_seq)}
    trace = tmp_path / "t.jsonl"
    trace.write_text(json.dumps(
        {"kind": "span", "name": "bench.benchmark", "ts_us": 1.0,
         "attrs": {"schedule": schedule_id(b_seq)}}) + "\n")
    assert corpus.attach_traces([str(trace)]) == 1
    assert row.n_trace_measurements == 1


def test_corpus_attach_traces(tmp_path, world):
    corpus = Corpus.from_files([world["paths"][0]], world["graph"])
    sid = corpus.rows[1].schedule
    assert sid == schedule_id(corpus.rows[1].seq)
    recs = [{"kind": "span", "name": "bench.benchmark", "ts_us": 1.0,
             "attrs": {"schedule": sid, "pct50": 0.5}},
            {"kind": "span", "name": "bench.benchmark", "ts_us": 2.0,
             "attrs": {"schedule": sid, "pct50": 0.5}},
            {"kind": "span", "name": "bench.warm", "ts_us": 3.0,
             "attrs": {"schedule": sid}},
            {"kind": "event", "name": "bench.cache", "ts_us": 4.0,
             "attrs": {"schedule": sid}}]
    trace = tmp_path / "trace.jsonl"
    trace.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert corpus.attach_traces([str(trace)]) == 2
    assert corpus.rows[1].n_trace_measurements == 2
    assert all(r.n_trace_measurements == 0
               for r in corpus.rows if r.schedule != sid)


def test_attach_traces_reads_the_ports_trace_bundle(tmp_path, world):
    """A ``--trace-out`` bundle the port wrote (obs/export.py) joins."""
    from tenzing_tpu_torch.obs import export
    from tenzing_tpu_torch.obs.tracer import Tracer

    corpus = Corpus.from_files([world["paths"][0]], world["graph"])
    tr = Tracer(enabled=True)
    with tr.span("bench.benchmark", schedule=corpus.rows[2].schedule):
        pass
    path = str(tmp_path / "trace.jsonl")
    export.write_jsonl(tr, path)
    assert corpus.attach_traces([path]) == 1


# -- model -----------------------------------------------------------------------


def test_model_equals_reference_bit_for_bit(world):
    X, y = world["corpus"].matrices(nbytes=world["nbytes"])
    port = RidgeEnsemble(feature_names=list(FEATURE_NAMES)).fit(X, y)
    ref = RefRidge(feature_names=list(FEATURE_NAMES)).fit(X, y)
    assert port.to_json() == ref.to_json()
    for a, b in zip(port.predict(X), ref.predict(X)):
        assert np.array_equal(a, b)


def test_models_move_between_the_packages(tmp_path, world):
    X, y = world["corpus"].matrices(nbytes=world["nbytes"])
    ref = RefRidge(feature_names=list(FEATURE_NAMES)).fit(X, y)
    path = str(tmp_path / "ref.json")
    ref.save(path)
    loaded = RidgeEnsemble.load(path, expect_features=list(FEATURE_NAMES))
    for a, b in zip(loaded.predict(X), ref.predict(X)):
        assert np.array_equal(a, b)
    back = str(tmp_path / "port.json")
    loaded.save(back)
    assert json.load(open(back)) == json.load(open(path))
    again = RefRidge.load(back, expect_features=list(FEATURE_NAMES))
    assert np.array_equal(again.predict(X)[0], ref.predict(X)[0])


def test_model_save_load_roundtrip(tmp_path, world):
    model = world["model"]
    path = str(tmp_path / "model.json")
    model.save(path)
    loaded = RidgeEnsemble.load(path, expect_features=list(FEATURE_NAMES))
    X, _ = world["corpus"].matrices(nbytes=world["nbytes"])
    m1, s1 = model.predict(X)
    m2, s2 = loaded.predict(X)
    assert np.allclose(m1, m2) and np.allclose(s1, s2)
    with pytest.raises(ValueError, match="feature contract"):
        RidgeEnsemble.load(path, expect_features=["bogus"])


def test_model_without_names_fails_contract_check(tmp_path, world):
    X, y = world["corpus"].matrices(nbytes=world["nbytes"])
    path = str(tmp_path / "anon.json")
    RidgeEnsemble().fit(X, y).save(path)
    RidgeEnsemble.load(path)
    with pytest.raises(ValueError, match="feature contract"):
        RidgeEnsemble.load(path, expect_features=list(FEATURE_NAMES))


def test_model_uncertainty_nonnegative_and_varies(world):
    X, _ = world["corpus"].matrices(nbytes=world["nbytes"])
    _, sd = world["model"].predict(X)
    assert (sd >= 0).all() and sd.max() > 0


def test_spearman_helper():
    assert spearman([1, 2, 3, 4], [10, 20, 30, 40]) == pytest.approx(1.0)
    assert spearman([1, 2, 3, 4], [40, 30, 20, 10]) == pytest.approx(-1.0)
    assert spearman([1, 1, 1, 1], [1, 2, 3, 4]) == 0.0


def test_train_from_corpus_equals_reference(tmp_path, world):
    from tenzing_tpu.learn import train_from_corpus as ref_train
    from tenzing_tpu_torch.learn import train_from_corpus
    from tenzing_tpu_torch.learn.train import MIN_TRAIN_ROWS

    assert MIN_TRAIN_ROWS == 4
    g, nbytes = world["graph"], world["nbytes"]
    model, info = train_from_corpus(list(world["paths"]), g, nbytes=nbytes)
    # the reference's graph: the same ops, read back through its serdes
    from tenzing_tpu.core.graph import Graph as RefGraph
    from tenzing_tpu.core.operation import DeviceOp as RefDeviceOp

    class RefKOp(RefDeviceOp):
        def __init__(self, name, buf):
            super().__init__(name)
            self._buf = buf

        def reads(self):
            return [self._buf]

        def apply(self, bufs, ctx):
            return {}

    rg = RefGraph()
    for i in range(len(SIZES)):
        op = RefKOp(f"k{i}", f"buf{i}")
        rg.start_then(op)
        rg.then_finish(op)
    rmodel, rinfo = ref_train(list(world["paths"]), rg, nbytes=nbytes)
    assert info["rows"] == rinfo["rows"] and info["files"] == rinfo["files"]
    # the features differ only in the analytic makespan's constants
    assert info["train_spearman"] > 0.8 and rinfo["train_spearman"] > 0.8
    small, sinfo = train_from_corpus([str(tmp_path / "none.csv")], g)
    assert small is None and "too small" in sinfo["error"]


# -- acceptance: ranking and the screen -----------------------------------------


def test_surrogate_ranks_with_spearman_ge_08(world):
    sur = SurrogateBenchmarker(world["model"], nbytes=world["nbytes"])
    pred = [sur.predict(s)[0] for s in world["seqs"]]
    assert spearman(pred, np.log(world["truth"])) >= 0.8


def test_surrogate_benchmark_protocol(world):
    sur = SurrogateBenchmarker(world["model"], nbytes=world["nbytes"],
                               anchor_s=world["naive_t"])
    res = sur.benchmark(world["seqs"][0], BenchOpts(n_iters=1))
    assert res.pct01 <= res.pct50 <= res.pct99 and res.pct50 > 0
    assert 0.5 * world["truth"][0] < res.pct50 < 2.0 * world["truth"][0]


class CountingBench:
    """An "empirical" benchmarker over the analytic truth at a third
    regime (1.3x), counting measurements."""

    def __init__(self, seqs, truth, regime=1.3):
        self._by_key = {canonical_key(s): float(t) * regime
                        for s, t in zip(seqs, truth)}
        self.calls = 0
        self.measured = {}

    def benchmark(self, order, opts=None):
        self.calls += 1
        t = self._by_key[canonical_key(order)]
        self.measured[canonical_key(order)] = t
        return _res(t)


def test_screening_half_measurements_same_best(world, fresh_metrics):
    seqs, truth = world["seqs"], world["truth"]
    inner = CountingBench(seqs, truth)
    scr = ScreeningBenchmarker(
        SurrogateBenchmarker(world["model"], nbytes=world["nbytes"]),
        inner, escalate_topk=4, z=2.0)
    for s in seqs:
        scr.benchmark(s)
    assert scr.hits + scr.escalations == len(seqs)
    assert inner.calls == scr.escalations <= len(seqs) // 2
    best_key = canonical_key(seqs[int(np.argmin(truth))])
    assert min(inner.measured, key=inner.measured.get) == best_key
    reg = get_metrics()
    assert reg.counter("learn.screen.escalations").value == scr.escalations
    assert reg.counter("learn.screen.surrogate_hits").value == scr.hits
    assert reg.histogram("learn.screen.abs_log_err").count == inner.calls


def test_screening_full_fidelity_always_escalates(world):
    seqs, truth = world["seqs"], world["truth"]
    screen_opts = BenchOpts(n_iters=2, target_secs=0.001)
    confirm_opts = BenchOpts(n_iters=20, target_secs=0.02)
    scr = ScreeningBenchmarker(
        SurrogateBenchmarker(world["model"], nbytes=world["nbytes"]),
        CountingBench(seqs, truth), escalate_topk=2, z=2.0,
        screen_only_opts=screen_opts)
    for s in seqs[:20]:
        scr.benchmark(s, screen_opts)
    hits = scr.hits
    assert hits > 0
    for s in seqs[:20]:
        scr.benchmark(s, confirm_opts)
    assert scr.hits == hits


def test_full_fidelity_escalations_do_not_pollute_calibration(world,
                                                              fresh_metrics):
    seqs, truth = world["seqs"], world["truth"]
    screen_opts = BenchOpts(n_iters=2, target_secs=0.001)
    confirm_opts = BenchOpts(n_iters=20, target_secs=0.02)
    keys = [canonical_key(s) for s in seqs]

    class RegimeBench:
        def benchmark(self, order, opts=None):
            t = float(truth[keys.index(canonical_key(order))])
            return _res(t * (100.0 if opts is confirm_opts else 1.0))

    scr = ScreeningBenchmarker(
        SurrogateBenchmarker(world["model"], nbytes=world["nbytes"]),
        RegimeBench(), escalate_topk=4, z=2.0, screen_only_opts=screen_opts)
    for s in seqs[:8]:
        scr.benchmark(s, screen_opts)
    deltas, emp = list(scr._deltas), list(scr._emp_logs)
    err_count = get_metrics().histogram("learn.screen.abs_log_err").count
    for s in seqs[:4]:
        scr.benchmark(s, confirm_opts)
    assert scr._deltas == deltas and scr._emp_logs == emp
    assert get_metrics().histogram("learn.screen.abs_log_err").count == err_count


def test_was_predicted_tracks_model_answered_queries(world):
    seqs, truth = world["seqs"], world["truth"]
    inner = CountingBench(seqs, truth)
    scr = ScreeningBenchmarker(
        SurrogateBenchmarker(world["model"], nbytes=world["nbytes"]),
        inner, escalate_topk=4, z=2.0)
    for s in seqs:
        scr.benchmark(s)
    assert scr.hits > 0 and scr.escalations > 0
    assert sum(scr.was_predicted(s) for s in seqs) == scr.hits
    for s in seqs:
        assert scr.was_predicted(s) == (canonical_key(s) not in inner.measured)


# -- the solvers' prescreen and the prefetcher's rank ---------------------------


class CountingAnalytic:
    def __init__(self, nbytes):
        self.ab = AnalyticBenchmarker(nbytes)
        self.calls = 0

    def benchmark(self, order, opts=None):
        self.calls += 1
        return _res(self.ab.makespan(order))


def test_dfs_prescreen_half_measurements_same_best(world, fresh_metrics):
    from tenzing_tpu_torch.solve.dfs import DfsOpts, explore

    g, nbytes = world["graph"], world["nbytes"]
    plat = Platform.make_n_lanes(2)
    pure_bench = CountingAnalytic(nbytes)
    pure = explore(g, plat, pure_bench, DfsOpts(max_seqs=24))
    assert pure_bench.calls == len(pure.sims) > 0
    sur = SurrogateBenchmarker(world["model"], nbytes=nbytes)
    screened_bench = CountingAnalytic(nbytes)
    screened = explore(g, plat, screened_bench,
                       DfsOpts(max_seqs=24, prescreen=sur,
                               prescreen_keep=len(pure.sims) // 2))
    assert screened_bench.calls <= pure_bench.calls // 2 and screened.sims
    assert (min(s.result.pct50 for s in screened.sims)
            == pytest.approx(min(s.result.pct50 for s in pure.sims)))
    assert get_metrics().counter("learn.prune.dfs_skipped").value == (
        pure_bench.calls - screened_bench.calls)


def test_local_prescreen_prunes_neighbors(world, fresh_metrics):
    from tenzing_tpu_torch.solve.local import LocalOpts, hill_climb

    g, nbytes = world["graph"], world["nbytes"]
    plat = Platform.make_n_lanes(2)

    def climb(prescreen):
        bench = CountingAnalytic(nbytes)
        res = hill_climb(g, plat, bench, phases=("k",),
                         opts=LocalOpts(budget=400,
                                        bench_opts=BenchOpts(n_iters=1),
                                        seed=5, prescreen=prescreen))
        return bench.calls, res

    calls_plain, _ = climb(None)
    calls_screened, res = climb(SurrogateBenchmarker(world["model"],
                                                     nbytes=nbytes))
    assert get_metrics().counter("learn.prune.local_skipped").value > 0
    assert calls_screened < calls_plain
    assert res.final.result.pct50 <= res.sims[0].result.pct50


def test_prefetch_rank_orders_hints_fastest_first(world):
    from tenzing_tpu_torch.bench.pipeline import PrefetchingBenchmarker

    sur = SurrogateBenchmarker(world["model"], nbytes=world["nbytes"])
    seqs = world["seqs"][:6]

    class Ordered:
        def __init__(self):
            self.order = []

        def precompile(self, order):
            self.order.append(schedule_id(order))
            return True

    fake = Ordered()
    with PrefetchingBenchmarker(None, executor=fake, workers=1, depth=8,
                                rank=sur) as pf:
        assert pf.prefetch(seqs) == 6
        import time

        deadline = time.time() + 30
        while len(fake.order) < 6 and time.time() < deadline:
            time.sleep(0.01)
    want = [schedule_id(s) for s in sorted(seqs,
                                           key=lambda s: sur.predict(s)[0])]
    assert fake.order == want


# -- the driver ------------------------------------------------------------------


SMALL = dict(smoke=True, mcts_iters=12, iters=3, search_iters=2)


@pytest.fixture(scope="module")
def halo_db(tmp_path_factory):
    """A smoke halo run's database and trace bundle, and the model trained
    on them through ``--learn-train``."""
    from tenzing_tpu_torch.bench import driver

    d = tmp_path_factory.mktemp("learn_driver")
    db, tr, model = str(d / "h.csv"), str(d / "trace"), str(d / "m.json")
    driver.run(driver.DriverRequest(dump_csv=db, trace_out=tr, **SMALL),
               device="cpu")
    out = driver.run(driver.DriverRequest(
        smoke=True, learn_train=[db], learn_trace=[tr + "/*.jsonl"],
        learn_model=model), device="cpu").verdict
    return db, model, out


def test_driver_learn_train(halo_db):
    db, model, out = halo_db
    assert out["metric"] == "learn_train_halo"
    assert out["files"] == 1 and out["rows"] >= 4
    assert "train_spearman" in out and out["model"] == model
    RidgeEnsemble.load(model, expect_features=list(FEATURE_NAMES))


def test_driver_learn_screen(halo_db, tmp_path):
    from tenzing_tpu_torch.bench import driver

    _, model, _ = halo_db
    dump = str(tmp_path / "s.csv")
    v = driver.run(driver.DriverRequest(learn_screen=True, learn_model=model,
                                        dump_csv=dump, **SMALL),
                   device="cpu").verdict
    assert v["verified"] is True and "fault" not in v
    assert v["learn"]["escalations"] > 0
    assert v["learn"]["train_rows"] >= 4


@pytest.mark.parametrize("override,match", [
    (dict(learn_screen=True), "requires --learn-model"),
    (dict(learn_trace=["t"]), "requires --learn-train"),
])
def test_driver_learn_flag_refusals(override, match):
    from tenzing_tpu_torch.bench import driver

    with pytest.raises(driver.DriverConfigError, match=match):
        driver.run(driver.DriverRequest(smoke=True, **override), device="cpu")


def test_driver_degraded_verdict_after_a_device_loss(halo_db, tmp_path):
    """With the model as the fallback, an injected device loss gives the
    degraded no-win verdict: the pre-loss naive number, ``vs_baseline``
    1.0, ``verified: false``, ``fault.degraded``; no row answered after the
    loss is archived as a measurement, and nothing is captured after it."""
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.bench.benchmarker import CsvBenchmarker

    _, model, _ = halo_db
    dump = str(tmp_path / "d.csv")
    v = driver.run(driver.DriverRequest(
        learn_screen=True, learn_model=model, dump_csv=dump,
        inject_faults="device_lost:0.3:2", **SMALL), device="cpu").verdict
    assert v["vs_baseline"] == 1.0 and v["verified"] is False
    assert v["value"] == v["naive_us"] and v["winner_label"] is None
    f = v["fault"]
    assert f["degraded"] is True and f["injected"] == {"device_lost": 1}
    assert f["error"] == "degraded: no device" and f["verified"] is False
    assert "gate" not in v
    rows = open(dump).read().splitlines()
    db = CsvBenchmarker(rows, driver.build_halo(
        driver.DriverRequest(smoke=True), "cpu")[0], strict=False)
    # naive, measured before the loss, is row 0 at full fidelity; the rows
    # the model answered after it are tagged, not archived as measurements
    assert db.fidelities[0] == "full"
    assert "degraded" in db.fidelities


def test_driver_device_loss_without_fallback_still_raises():
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.fault.errors import DeviceLostError

    with pytest.raises(DeviceLostError):
        driver.run(driver.DriverRequest(inject_faults="device_lost:0.3:2",
                                        **SMALL), device="cpu")
