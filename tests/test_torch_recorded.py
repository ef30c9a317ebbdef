"""The recorded warm start and the search database (bench/benchmarker.py
``CsvBenchmarker`` / ``result_row``, bench/recorded.py, the driver's
``--dump-csv`` / ``--seed-csv``) against the reference.

Every committed database the full-size driver reads
(``experiments/{halo,moe,attn}_search_tpu_r[45]*.csv``, 33 files) is read
by both packages' ``CsvBenchmarker(strict=False, normalize=True)`` against
the driver's full-size graphs: the same skipped rows, fidelities and
entries (as schedule JSON), the same answers, the same naive anchor; and
``rank_recorded(topk=3)`` picks the same schedules at the same ratios, each
of which the port's verifier passes.  The row format round-trips within the
port and across the packages.  The driver's side (the dump, the warm start)
is in test_torch_warm_start.py.  Mirrors ``tests/test_csv_roundtrip.py``,
``test_recorded_seed.py`` and ``test_recorded_search.py``."""

import glob
import json
import os
import random

import numpy as np
import pytest

from tenzing_tpu.bench import benchmarker as ref_bm
from tenzing_tpu.bench import recorded as ref_rec
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu_torch.bench import driver, recorded
from tenzing_tpu_torch.bench.benchmarker import (
    CSV_DELIM,
    BenchResult,
    CsvBenchmarker,
    result_row,
    split_fidelity,
)
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_to_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOADS = ("halo", "moe", "attn")
DATABASES = sorted(
    (w, os.path.relpath(p, REPO)) for w in WORKLOADS
    for p in glob.glob(os.path.join(REPO, driver.RECORDED_WARM_START[w])))


def test_the_committed_databases_are_all_there():
    assert len(DATABASES) == 33
    assert {w for w, _ in DATABASES} == set(WORKLOADS)


@pytest.fixture(scope="module", autouse=True)
def _reference_lookup_memoized():
    """The reference walks its graph once per op it reads back
    (``tenzing_tpu/core/serdes.py`` ``_find_by_name``); at 3,900 halo rows
    that is minutes.  Its answers for one top-level graph and name never
    change, so they are memoized here (the port indexes its graph once,
    core/serdes.py ``_name_index``)."""
    from tenzing_tpu.core import serdes as ref_serdes

    find = ref_serdes._find_by_name
    memo, keep = {}, []

    def memoized(graph, name):
        key = (id(graph), name)
        if key not in memo:
            keep.append(graph)
            memo[key] = find(graph, name)
        return memo[key]

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_serdes, "_find_by_name", memoized)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def graphs():
    """The full-size driver graphs of both packages, by workload (building a
    graph allocates no buffer but moe's, which needs the capacity)."""
    from tenzing_tpu.core.graph import Graph as RefGraph
    from tenzing_tpu.models import halo as rh
    from tenzing_tpu.models import halo_pipeline as rhp
    from tenzing_tpu.models import moe_pipeline as rmp
    from tenzing_tpu.models.ring_attention import BlockedAttention as RefBA
    from tenzing_tpu.models.ring_attention import RingAttnArgs as RefArgs
    from tenzing_tpu_torch.models import halo_pipeline as hp
    from tenzing_tpu_torch.models import moe_pipeline as mp
    from tenzing_tpu_torch.models.halo import HaloArgs

    full = dict(nq=3, lx=512, ly=512, lz=512, radius=3)
    out = {"halo": (hp.build_graph(HaloArgs(**full), impl_choice=True,
                                   xfer_choice=True),
                    rhp.build_graph(rh.HaloArgs(**full), impl_choice=True,
                                    xfer_choice=True))}
    margs = mp.MoEPipeArgs(tokens=8192)
    cap = mp.make_pipe_buffers(margs, seed=0, with_expected=False,
                               staging="choice")[2]
    out["moe"] = (mp.build_graph(margs, cap, impl_choice=True,
                                 staging="choice"),
                  rmp.build_graph(rmp.MoEPipeArgs(tokens=8192), cap,
                                  impl_choice=True, staging="choice"))
    aargs = driver.attn_args(driver.DriverRequest(workload="attn"))
    rg = RefGraph()
    op = RefBA(RefArgs(n_devices=8, batch=4, seq_local=1024, head_dim=128),
               impl_choice=True, fused_choice=True)
    rg.start_then(op)
    rg.then_finish(op)
    out["attn"] = (driver.attn_graph(aargs), rg)
    return out


@pytest.mark.parametrize("workload,path", DATABASES,
                         ids=[os.path.basename(p) for _, p in DATABASES])
def test_csv_benchmarker_equals_reference(graphs, workload, path):
    g, rg = graphs[workload]
    full = os.path.join(REPO, path)
    db = CsvBenchmarker.from_file(full, g, strict=False, normalize=True)
    rdb = ref_bm.CsvBenchmarker.from_file(full, rg, strict=False,
                                          normalize=True)
    assert db.skipped == rdb.skipped
    assert db.fidelities == rdb.fidelities
    assert len(db.entries) == len(rdb.entries) > 0
    for (seq, res), (rseq, rres) in zip(db.entries, rdb.entries):
        assert sequence_to_json(seq) == ref_to_json(rseq)
        assert (res.pct01, res.pct10, res.pct50, res.pct90, res.pct99,
                res.stddev) == (rres.pct01, rres.pct10, rres.pct50,
                                rres.pct90, rres.pct99, rres.stddev)
    # the same answers (first full row wins; screen rows answer nothing)
    for (seq, _), (rseq, _) in zip(db.entries[:25], rdb.entries[:25]):
        try:
            want = rdb.benchmark(rseq).pct50
        except KeyError:
            with pytest.raises(KeyError):
                db.benchmark(seq)
            continue
        assert db.benchmark(seq).pct50 == want
    assert recorded.naive_anchor_of(full) == ref_rec.naive_anchor_of(full)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_rank_recorded_equals_reference(graphs, workload):
    from tenzing_tpu_torch.verify import ScheduleVerifier

    g, rg = graphs[workload]
    paths = sorted(glob.glob(os.path.join(
        REPO, driver.RECORDED_WARM_START[workload])))
    logs, ref_logs = [], []
    picked = recorded.rank_recorded(paths, g, 3, log=logs.append)
    ref_picked = ref_rec.rank_recorded(paths, rg, 3, log=ref_logs.append)
    assert len(picked) == len(ref_picked) == 3
    assert [r for _, r in picked] == [r for _, r in ref_picked]
    assert [sequence_to_json(s) for s, _ in picked] == \
        [ref_to_json(s) for s, _ in ref_picked]
    # the same files, rows and skipped rows, in the same words
    assert logs == ref_logs and "carrying top 3" in logs[-1]
    verify = ScheduleVerifier(g)
    anchors = set()
    for p in paths:
        with open(p) as f:
            row0 = f.readline()
        anchors.add(row0.split(CSV_DELIM, 7)[-1])
    for seq, ratio in picked:
        assert ratio > 1.0
        assert verify(seq).ok
        # row 0 (the naive anchor) is never offered
        ops = CSV_DELIM.join(
            json.dumps(op.to_json()).replace(CSV_DELIM, "\\u007c")
            for op in seq)
        assert ops not in anchors


def _res(vals):
    p01, p10, p50, p90, p99, sd = vals
    return BenchResult(pct01=p01, pct10=p10, pct50=p50, pct90=p90,
                       pct99=p99, stddev=sd)


def _world(names):
    """A graph of one device op per name in each package."""
    from tenzing_tpu.core.graph import Graph as RefGraph
    from tenzing_tpu.core.operation import DeviceOp as RefDeviceOp
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.core.operation import DeviceOp

    class POp(DeviceOp):
        def apply(self, bufs, ctx):
            return None

    class ROp(RefDeviceOp):
        def apply(self, bufs, ctx):
            return {}

    g, rg = Graph(), RefGraph()
    ops = []
    for n in names:
        op, rop = POp(n), ROp(n)
        ops.append(op)
        g.start_then(op)
        g.then_finish(op)
        rg.start_then(rop)
        rg.then_finish(rop)
    return g, rg, ops


def test_result_row_round_trips_within_and_across_packages():
    """Seeded rows heavy on the delimiter, numpy-typed stats and fidelity
    tags: the port's rows equal the reference's byte for byte, and each
    package reads the other's dump back exactly."""
    from tenzing_tpu.bench.benchmarker import BenchResult as RefResult
    from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
    from tenzing_tpu_torch.core.resources import Lane
    from tenzing_tpu_torch.core.sequence import Sequence

    rng = random.Random(1234)
    alphabet = 'ab|"\\{}[]:,π \t'
    for trial in range(30):
        names = []
        while len(names) < rng.randint(1, 5):
            n = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 12)))
            if n not in names:
                names.append(n)
        g, rg, ops = _world(names)
        seq = Sequence([op.bind(Lane(rng.randrange(3))) for op in ops])
        vals = [rng.choice([1.0, 1e-30, 1e30, 3.141592653589793e-05,
                            float(np.float64(rng.random()))])
                for _ in range(6)]
        if trial % 2:
            vals = [np.float64(v) for v in vals]
        fidelity = rng.choice([None, "screen", "s2"])
        row = result_row(trial, _res(vals), seq, fidelity=fidelity)
        rseq = ref_from_json(sequence_to_json(seq), rg)
        rres = RefResult(*[float(v) for v in vals])
        assert row == ref_bm.result_row(trial, rres, rseq, fidelity=fidelity)
        assert split_fidelity(row.split(CSV_DELIM)) == \
            ref_bm.split_fidelity(row.split(CSV_DELIM))
        for reader, graph, to_json in (
                (CsvBenchmarker, g, sequence_to_json),
                (ref_bm.CsvBenchmarker, rg, ref_to_json)):
            db = reader([row], graph)
            (got, got_res), = db.entries
            assert to_json(got) == sequence_to_json(seq)
            assert [got_res.pct01, got_res.pct10, got_res.pct50,
                    got_res.pct90, got_res.pct99, got_res.stddev] == \
                [float(v) for v in vals]
            assert db.fidelities == [fidelity or "full"]
    with pytest.raises(ValueError, match="delimiter"):
        result_row(0, _res([1, 2, 3, 4, 5, 0]), seq, fidelity="a|b")


def test_naive_anchor_and_screen_rows(tmp_path):
    """Row 0 is the anchor only at full fidelity; a screen row never
    answers a query and never ranks; an unreadable file is logged."""
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import build_graph, naive_order
    from tenzing_tpu_torch.solve.dfs import get_all_sequences

    args = HaloArgs(nq=1, lx=4, ly=4, lz=4, radius=1)
    g = build_graph(args)
    naive = naive_order(args, Platform.make_n_lanes(1))
    seqs = [st.sequence for st in get_all_sequences(
        g, Platform.make_n_lanes(2), max_seqs=6)]
    rows = [result_row(0, _res([0.1] * 5 + [0]), naive),
            result_row(1, _res([0.02] * 5 + [0]), seqs[0], fidelity="screen"),
            result_row(2, _res([0.05] * 5 + [0]), seqs[1])]
    path = tmp_path / "db.csv"
    path.write_text("\n".join(rows) + "\n")
    assert recorded.naive_anchor_of(str(path)) == 0.1
    db = CsvBenchmarker.from_file(str(path), g)
    assert db.fidelities == ["full", "screen", "full"]
    with pytest.raises(KeyError):
        db.benchmark(seqs[0])
    picked = recorded.rank_recorded([str(path)], g, 5)
    assert [round(r, 6) for _, r in picked] == [2.0]
    screen0 = tmp_path / "screen0.csv"
    screen0.write_text(result_row(0, _res([0.1] * 5 + [0]), naive,
                                  fidelity="screen") + "\n")
    assert recorded.naive_anchor_of(str(screen0)) is None
    logs = []
    assert recorded.rank_recorded([str(tmp_path / "missing.csv")], g, 3,
                                  log=logs.append) == []
    assert any("unreadable" in m for m in logs)
