"""The analytic cost model of the port (tenzing_tpu_torch/bench/model.py)
against the JAX package's (tenzing_tpu/bench/model.py; reference tests
test_model_benchmarker.py).

* given the reference's ``ModelEnv`` values, the port's makespan of every
  schedule (halo with its engine menu, the MoE layer, the irregular SpMV's
  exchange menu, the TP MLP) equals the reference's on the same schedule
  JSON, exactly: the same arithmetic in the same order;
* the kind sets are the reference's, and the chunk layer's ``COMM_KINDS``
  is built from them;
* the defaults are the card's (bench/roofline.py's constants), none a
  TPU's;
* under them the post-all-await-late halo order beats the one-lane naive
  order, an MCTS beats naive on halo and a DFS on MoE, the model is
  deterministic and its environment steers it, and the dryrun's modeled
  stage reports searched beating naive on halo and MoE.
"""

from dataclasses import asdict

import numpy as np
import pytest

from tenzing_tpu.bench import model as ref
from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu.models import halo as ref_halo
from tenzing_tpu.models import moe as ref_moe
from tenzing_tpu.models import spmv as ref_spmv
from tenzing_tpu.models import spmv_irregular as ref_irr
from tenzing_tpu.models import tp_mlp as ref_tp
from tenzing_tpu.solve import dfs as ref_dfs
from tenzing_tpu_torch.bench import model, roofline
from tenzing_tpu_torch.bench.benchmarker import BenchOpts
from tenzing_tpu_torch.core.chunking import COMM_KINDS
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json
from tenzing_tpu_torch.models import halo
from tenzing_tpu_torch.models.moe import MoEArgs
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.solve.local import first_decision_order

HALO = dict(nq=2, lx=8, ly=8, lz=8, radius=1)


def _halo_setup(pkg=halo, graph=Graph):
    """The reference test's halo graph (8^3, radius 1) and its face
    buffers' bytes."""
    hargs = pkg.HaloArgs(**HALO)
    g = pkg.add_to_graph(graph(), hargs)
    nbytes = {"U": int(np.prod(hargs.local_shape())) * 4}
    for d in pkg.DIRECTIONS:
        _, sz = pkg._face_slices(hargs, d, "pack")
        n = int(np.prod(sz)) * 4
        nbytes[f"buf_{pkg.dir_name(d)}"] = n
        nbytes[f"recv_{pkg.dir_name(d)}"] = n
    return g, nbytes


def _wrap(comp, g):
    g.start_then(comp)
    g.then_finish(comp)
    return g


def _cases():
    """(reference graph, port graph, nbytes) per workload."""
    hr, nb = _halo_setup(ref_halo, RefGraph)
    hx = ref_halo.add_to_graph(RefGraph(), ref_halo.HaloArgs(**HALO),
                               xfer_choice=True)
    px = halo.add_to_graph(Graph(), halo.HaloArgs(**HALO), xfer_choice=True)
    out = [(hr, _halo_setup()[0], nb), (hx, px, nb)]
    margs = MoEArgs(n_ep=4, tokens_per_shard=8, d_model=8, d_ff=16,
                    n_chunks=2)
    ra = ref_moe.MoEArgs(**asdict(margs))
    mb, _, _ = ref_moe.make_moe_buffers(ra, seed=0)
    out.append((_wrap(ref_moe.MoELayer(ra), RefGraph()),
                dryrun.layer_graph(margs),
                {k: v.nbytes for k, v in mb.items()}))
    spec = dict(kind="random", m=64, n=64, nnz=600, seed=1)
    a = ref_spmv.random_matrix(64, 64, 600, seed=1)
    ib, _, _, plan = ref_irr.make_irregular_spmv_buffers(a, 4, batch=2,
                                                         impl_choice=True)
    g, _, _, _, _, _ = dryrun.model_setup(
        "spmv_irregular", dict(matrix=spec, batch=2, impl_choice=True),
        {"sp": 4})
    out.append((_wrap(ref_irr.IrregularSpMV(plan.steps, widths=plan.widths,
                                            impl_choice=True), RefGraph()),
                g, {k: v.nbytes for k, v in ib.items()}))
    targs = dict(n_tp=2, n_layers=2, n_chunks=2, mb_size=2, d_model=8,
                 d_ff=16)
    tb, _, _ = ref_tp.make_tp_mlp_buffers(ref_tp.TpMlpArgs(**targs))
    g, _, _, _, _, _ = dryrun.model_setup("tp_mlp", targs, {})
    out.append((_wrap(ref_tp.TpMlp(ref_tp.TpMlpArgs(**targs)), RefGraph()),
                g, {k: v.nbytes for k, v in tb.items()}))
    return out


def test_makespan_equals_reference_given_its_env():
    env = model.ModelEnv(**asdict(ref.ModelEnv()))
    n = 0
    for rg, g, nbytes in _cases():
        rb = ref.AnalyticBenchmarker(nbytes)
        pb = model.AnalyticBenchmarker(nbytes, env)
        for lanes in (1, 2):
            for st in ref_dfs.enumerate_schedules(
                    rg, RefPlatform.make_n_lanes(lanes), max_seqs=12):
                js = ref_to_json(st.sequence)
                assert pb.makespan(sequence_from_json(js, g)) == \
                    rb.makespan(ref_from_json(js, rg))
                n += 1
    assert n >= 100


def test_kind_sets_and_card_defaults():
    assert model.ICI_KINDS == ref.ICI_KINDS
    assert model.PCIE_KINDS == ref.PCIE_KINDS
    assert COMM_KINDS == frozenset(model.ICI_KINDS + model.PCIE_KINDS + (
        "await_transfer", "multi_await"))
    env = model.ModelEnv()
    assert env.hbm_bw == roofline.H100_PEAK_HBM_BYTES == 3.35e12
    assert env.flops_peak == roofline.H100_PEAK_BF16_FLOPS == 989e12
    assert env.ici_bw == roofline.EXCHANGE_GBS * 1e9
    assert env.pcie_bw == roofline.XFER_GBS * 1e9
    assert env.op_overhead == env.ici_lat == roofline.CHUNK_DISPATCH_US * 1e-6
    theirs = asdict(ref.ModelEnv())
    assert all(asdict(env)[k] != theirs[k] for k in theirs)


def test_halo_overlap_order_beats_naive():
    from tenzing_tpu_torch.solve.greedy import greedy_phase_order

    g, nbytes = _halo_setup()
    bench = model.AnalyticBenchmarker(nbytes)
    naive = bench.makespan(first_decision_order(g, Platform.make_n_lanes(1)))
    overlap = bench.makespan(greedy_phase_order(
        g, Platform.make_n_lanes(2),
        ("start", "pack", "exchange", "await", "unpack", "finish")))
    assert overlap < naive, (overlap, naive)


def test_model_is_deterministic_and_env_steers_it():
    g, nbytes = _halo_setup()
    seq = first_decision_order(g, Platform.make_n_lanes(1))
    bench = model.AnalyticBenchmarker(nbytes)
    r1 = bench.benchmark(seq, BenchOpts(n_iters=3))
    r2 = bench.benchmark(seq, BenchOpts(n_iters=3))
    assert r1.pct50 == r2.pct50 == bench.makespan(seq)
    assert r1.stddev == 0.0
    fast = model.AnalyticBenchmarker(nbytes, model.ModelEnv(ici_bw=450e9))
    slow = model.AnalyticBenchmarker(nbytes, model.ModelEnv(ici_bw=4.5e9))
    assert slow.makespan(seq) > fast.makespan(seq)


def test_mcts_beats_naive_on_halo_and_dfs_on_moe():
    from tenzing_tpu_torch.solve.dfs import get_all_sequences
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore
    from tenzing_tpu_torch.solve.mcts.strategies import FastMin

    g, nbytes = _halo_setup()
    bench = model.AnalyticBenchmarker(nbytes)
    naive = bench.makespan(first_decision_order(g, Platform.make_n_lanes(1)))
    res = explore(g, Platform.make_n_lanes(2), bench,
                  MctsOpts(n_iters=24, bench_opts=BenchOpts(n_iters=1),
                           seed=0, cache_benchmarks=True),
                  strategy=FastMin)
    assert min(s.result.pct50 for s in res.sims) < naive
    margs = MoEArgs(n_ep=4, tokens_per_shard=8, d_model=8, d_ff=16,
                    n_chunks=2)
    from tenzing_tpu_torch.models.moe import make_moe_buffers

    mb, _, _ = make_moe_buffers(margs, seed=0)
    mg = dryrun.layer_graph(margs)
    bench = model.AnalyticBenchmarker({k: v.nbytes for k, v in mb.items()})
    naive = bench.makespan(first_decision_order(mg, Platform.make_n_lanes(1)))
    best = min(bench.makespan(st.sequence) for st in
               get_all_sequences(mg, Platform.make_n_lanes(2), 64))
    assert best < naive


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_modeled_stage(n):
    out = dryrun.modeled_main(n)
    assert [s["workload"] for s in out["stages"]] == ["halo", "moe"]
    for s in out["stages"]:
        assert s["searched_us"] < s["naive_us"] and s["ratio"] > 1.0
