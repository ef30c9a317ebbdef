"""The port's DFS solver (tenzing_tpu_torch/solve/dfs.py), its CSV row writer
and the SpMV example programs, against the JAX package.

``enumerate_schedules`` on the SpMV graphs on 2 lanes gives the same number
of unique terminals and the same set of schedule JSONs in both packages,
under caps that truncate the fair share and under one that does not (the
reference may enumerate through its native core: its cap semantics equal the
Python worklist's).  ``explore`` measures every terminal on the CPU executor,
and the examples print the reference's CSV and ``best:`` line."""

import json

import numpy as np
import pytest
import torch

from tenzing_tpu.bench.benchmarker import BenchResult as RefBenchResult
from tenzing_tpu.bench.benchmarker import result_row as ref_result_row
from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu.models import spmv as ref_spmv
from tenzing_tpu.solve import dfs as ref_dfs
from tenzing_tpu_torch.bench.benchmarker import BenchOpts, BenchResult, EmpiricalBenchmarker
from tenzing_tpu_torch.bench.recorded import result_row
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_to_json
from tenzing_tpu_torch.examples import spmv_dfs, spmv_mcts
from tenzing_tpu_torch.models import spmv
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.solve import dfs

# the driver's smoke graph: m=512, both SpMVs on the kernel menu, host exchange
SMOKE_X = {"x_local": 512, "x_remote": 255}


def _graphs(kind):
    kw = {} if kind == "local" else dict(impl_choice=True, x_sizes=SMOKE_X,
                                         exchange="host")
    g, rg = Graph(), RefGraph()
    g.start_then(spmv.SpMVCompound(**kw))
    g.then_finish(spmv.SpMVCompound(**kw))
    rg.start_then(ref_spmv.SpMVCompound(**kw))
    rg.then_finish(ref_spmv.SpMVCompound(**kw))
    return g, rg


@pytest.mark.parametrize("kind,cap", [("local", 40), ("local", 1000),
                                      ("driver", 60), ("driver", 1000)])
def test_enumerate_schedules_equals_reference(kind, cap):
    g, rg = _graphs(kind)
    mine = dfs.enumerate_schedules(g, Platform.make_n_lanes(2), cap,
                                   log=lambda m: None)
    theirs = ref_dfs.enumerate_schedules(rg, RefPlatform.make_n_lanes(2), cap)
    assert len(mine) == len(theirs) <= cap
    a = sorted(json.dumps(sequence_to_json(s.sequence)) for s in mine)
    b = sorted(json.dumps(ref_to_json(s.sequence)) for s in theirs)
    assert a == b


def test_unique_terminal_counts_and_variants():
    g, rg = _graphs("local")
    two, rtwo = Platform.make_n_lanes(2), RefPlatform.make_n_lanes(2)
    # the examples' graph has 96 bijection-unique terminals on 2 lanes
    assert len(dfs.get_unique_sequences(g, two, 10_000)) == 96 == len(
        ref_dfs.get_unique_sequences(rg, rtwo, 10_000))
    assert len(dfs.get_all_sequences(g, two, 50)) == 50
    g2, rg2 = _graphs("driver")
    assert len(dfs.structural_variants(g2)) == len(
        ref_dfs.structural_variants(rg2)) == 4
    names = sorted(v.name() for v in dfs.expand_all(g2).vertices())
    assert names == sorted(v.name() for v in ref_dfs.expand_all(rg2).vertices())


def test_result_row_equals_reference():
    g, rg = _graphs("local")
    st = dfs.get_unique_sequences(g, Platform.make_n_lanes(2), 3)[2]
    rst = ref_dfs.get_unique_sequences(rg, RefPlatform.make_n_lanes(2), 3)[2]
    times = [3e-5, 1e-5, 2e-5, 4e-5]
    for fid in (None, "screen"):
        assert result_row(7, BenchResult.from_times(times), st.sequence, fid) == \
            ref_result_row(7, RefBenchResult.from_times(times), rst.sequence, fid)
    with pytest.raises(ValueError, match="delimiter"):
        result_row(0, BenchResult.from_times(times), st.sequence, "a|b")


def _executor(m=128):
    bufs, want = spmv.make_spmv_buffers(m=m, nnz_per_row=4, seed=0)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(bufs, "cpu"),
                        device="cpu")
    return ex, want


@pytest.mark.parametrize("batch", [False, True])
def test_explore_measures_every_terminal(batch, tmp_path):
    g, _ = _graphs("local")
    ex, want = _executor()
    path = tmp_path / "dfs.csv"
    res = dfs.explore(g, Platform.make_n_lanes(2), EmpiricalBenchmarker(ex),
                      dfs.DfsOpts(max_seqs=6, dump_csv_path=str(path),
                                  bench_opts=BenchOpts(n_iters=2, target_secs=0.0002),
                                  batch=batch))
    assert len(res.sims) == 6
    rows = path.read_text().splitlines()
    assert [r.split("|")[0] for r in rows] == [str(i) for i in range(1, 7)]
    assert res.best() is min(res.sims, key=lambda s: s.result.pct10)
    for s in res.sims:  # every measured schedule computes y
        np.testing.assert_allclose(ex.run(s.order)["y"].numpy(), want,
                                   rtol=1e-5, atol=1e-6)


def test_explore_verifies_and_refuses_unported_options(tmp_path):
    from tenzing_tpu_torch.fault import SearchCheckpoint
    from tenzing_tpu_torch.verify import ScheduleVerifier

    g, _ = _graphs("local")
    ex, _ = _executor()
    ckpt = SearchCheckpoint(str(tmp_path / "ckpt"))
    res = dfs.explore(g, Platform.make_n_lanes(2), EmpiricalBenchmarker(ex),
                      dfs.DfsOpts(max_seqs=4, verify=ScheduleVerifier(g),
                                  checkpoint=ckpt,
                                  bench_opts=BenchOpts(n_iters=2, target_secs=0.0002)))
    assert len(res.sims) == 4
    # checkpoint is ported: rank 0 snapshots the cursor at the last terminal
    assert ckpt.load_state()["dfs"] == {"i": 3, "n": 4, "n_sims": 4}
    # the fleet's subtree option, once refused, is ported: (k, n) keeps the
    # terminals k, k + n, ... of the enumeration
    half = [dfs.explore(g, Platform.make_n_lanes(2), EmpiricalBenchmarker(ex),
                        dfs.DfsOpts(max_seqs=4, subtree=(k, 2),
                                    bench_opts=BenchOpts(
                                        n_iters=2, target_secs=0.0002)))
            for k in (0, 1)]
    assert [len(h.sims) for h in half] == [2, 2]
    assert [sequence_to_json(s.order) for s in half[0].sims] == [
        sequence_to_json(s.order) for s in res.sims[0::2]]
    assert [sequence_to_json(s.order) for s in half[1].sims] == [
        sequence_to_json(s.order) for s in res.sims[1::2]]
    # prescreen is ported (tests/test_torch_learn.py): a surrogate keeps the
    # terminals it predicts fastest, here the first two in a tie

    from tenzing_tpu_torch.core.sequence import canonical_key

    class Flat:
        def predict(self, order):
            return 0.0, 0.0

    kept = dfs.explore(g, Platform.make_n_lanes(2), EmpiricalBenchmarker(ex),
                       dfs.DfsOpts(max_seqs=4, prescreen=Flat(),
                                   prescreen_keep=2,
                                   bench_opts=BenchOpts(n_iters=2,
                                                        target_secs=0.0002)))
    assert [canonical_key(s.order) for s in kept.sims] == [
        canonical_key(s.order) for s in res.sims[:2]]
    # prefetch is ported: the next terminals are hinted while one measures
    from tenzing_tpu_torch.bench.pipeline import PrefetchingBenchmarker

    fresh, _ = _executor()  # nothing provisioned yet: the hints issue
    with PrefetchingBenchmarker(EmpiricalBenchmarker(fresh),
                                executor=fresh) as p:
        res = dfs.explore(g, Platform.make_n_lanes(2), p, dfs.DfsOpts(
            max_seqs=3, prefetch=p,
            bench_opts=BenchOpts(n_iters=2, target_secs=0.0002)))
    assert len(res.sims) == 3 and p.issued >= 1
    assert dfs.DfsOpts().to_json() == ref_dfs.DfsOpts().to_json()


@pytest.mark.parametrize("module,extra", [
    (spmv_dfs, ["--max-seqs", "5"]),
    (spmv_mcts, ["--mcts-iters", "3", "--strategy", "Coverage"]),
])
def test_examples_print_csv_and_best_on_cpu(module, extra, capsys):
    assert module.main(["--cpu", "--matrix-m", "128", "--benchmark-iters", "2",
                        *extra]) == 0
    out, err = capsys.readouterr()
    rows = out.strip().splitlines()
    assert rows and all(r.split("|")[0].isdigit() for r in rows)
    json.loads(rows[0].split("|")[7])  # the first op cell is JSON
    assert "best: pct10=" in err


def test_examples_read_a_matrix_file(tmp_path, capsys):
    path = tmp_path / "m.mtx"
    lines = ["%%MatrixMarket matrix coordinate real general", "6 6 9"]
    lines += [f"{i} {i} {i}.5" for i in range(1, 7)] + ["1 6 2.0", "6 1 3.0", "3 4 1.0"]
    path.write_text("\n".join(lines) + "\n")
    assert spmv_dfs.main(["--cpu", "--matrix", str(path), "--max-seqs", "2",
                          "--benchmark-iters", "2"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_examples_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spmv_dfs.main(["--matrix-m", "64", "--max-seqs", "1"])
    # --dump-tree is an option (the reference's examples/_driver.py:39); it
    # does not change the device either
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spmv_mcts.main(["--matrix-m", "64", "--dump-tree"])
