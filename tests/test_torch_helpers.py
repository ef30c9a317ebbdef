"""The core, solver and example helpers the port took from the reference
(ROADMAP Queue 1 item 8e), against the reference's on the same graphs and
inputs, compared exactly:

* ``core/schedule.py`` — ``make_schedules`` gives the reference's schedules,
  schedule JSON equal and in order; ``make_schedules_random`` draws from a
  ``random.Random(seed)`` over the same frontier order in both packages, so
  the seeded generator is shared and the schedules are equal too;
* ``core/graph.py`` — ``vertex_size``, ``device_vertices``,
  ``apply_lane_assignment``, ``use_lanes``, ``dump_graphviz`` (the same dot
  text) and ``is_equivalent_lane_mapping``;
* ``core/sequence.py`` — ``contains_unbound``, ``find_unbound``,
  ``is_equivalent``; ``core/operation.py`` — ``make_lane_variations``,
  ``keep_uniques``;
* MCTS — ``Node.dump_graphviz`` of the same tree gives the same dot text,
  ``MctsOpts.to_json`` the same document, ``_dump_cadence`` the same
  iterations, and a search with ``dump_tree`` / ``dump_csv_path`` writes its
  dumps; the examples' ``--dump-tree``;
* ``bench/benchmarker.py`` — ``benchmark_batch`` and
  ``RepeatCallableRunner`` on the CPU;
* ``utils`` — ``round_up``, the init gate's one-shot notice, the reproduce
  stamp's keys (the reference's, with this package and torch in place of
  ``tenzing_tpu`` and ``jax``) and the profiling shim.
"""

import io
import json
import random

import pytest

from tenzing_tpu.core import graph as ref_graph
from tenzing_tpu.core import operation as ref_operation
from tenzing_tpu.core import schedule as ref_schedule
from tenzing_tpu.core import sequence as ref_sequence
from tenzing_tpu.core import serdes as ref_serdes
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.resources import Lane as RefLane
from tenzing_tpu.core.state import State as RefState
from tenzing_tpu.models import halo as ref_halo
from tenzing_tpu.models import halo_pipeline as ref_pipe
from tenzing_tpu.solve.mcts import mcts as ref_mcts
from tenzing_tpu.solve.mcts import node as ref_node
from tenzing_tpu.solve.mcts import strategies as ref_strategies
from tenzing_tpu.utils import initgate as ref_initgate
from tenzing_tpu.utils import numeric as ref_numeric
from tenzing_tpu.utils import reproduce as ref_reproduce
from tenzing_tpu_torch.core import graph as port_graph
from tenzing_tpu_torch.core import operation as port_operation
from tenzing_tpu_torch.core import schedule as port_schedule
from tenzing_tpu_torch.core import sequence as port_sequence
from tenzing_tpu_torch.core import serdes as port_serdes
from tenzing_tpu_torch.core.platform import Platform as PortPlatform
from tenzing_tpu_torch.core.resources import Lane as PortLane
from tenzing_tpu_torch.core.state import State as PortState
from tenzing_tpu_torch.models import halo as port_halo
from tenzing_tpu_torch.models import halo_pipeline as port_pipe
from tenzing_tpu_torch.solve.mcts import mcts as port_mcts
from tenzing_tpu_torch.solve.mcts import node as port_node
from tenzing_tpu_torch.solve.mcts import strategies as port_strategies
from tenzing_tpu_torch.utils import initgate, numeric, reproduce

SMOKE = dict(nq=2, lx=4, ly=4, lz=4, radius=1)

REF = dict(graph=ref_graph, operation=ref_operation, lane=RefLane,
           schedule=ref_schedule, sequence=ref_sequence, serdes=ref_serdes,
           state=RefState, platform=RefPlatform)
PORT = dict(graph=port_graph, operation=port_operation, lane=PortLane,
            schedule=port_schedule, sequence=port_sequence,
            serdes=port_serdes, state=PortState, platform=PortPlatform)


def _ops(pkg):
    class Dev(pkg["operation"].DeviceOp):
        pass

    return Dev


def _diamond(pkg):
    """start -> a(host) -> {b, c}(device) -> d(device) -> finish."""
    Dev = _ops(pkg)
    g = pkg["graph"].Graph()
    a = pkg["operation"].NoOp("a")
    b, c, d = Dev("b"), Dev("c"), Dev("d")
    g.start_then(a)
    g.then(a, b)
    g.then(a, c)
    g.then(b, d)
    g.then(c, d)
    g.then_finish(d)
    return g


def _wide(pkg):
    """Three independent device ops and a host op between start and
    finish: 4! orders."""
    Dev = _ops(pkg)
    g = pkg["graph"].Graph()
    for op in (Dev("x"), Dev("y"), Dev("z"), pkg["operation"].NoOp("h")):
        g.start_then(op)
        g.then_finish(op)
    return g


def _halo(pkg):
    if pkg is REF:
        return ref_pipe.build_graph(ref_halo.HaloArgs(**SMOKE),
                                    impl_choice=True, xfer_choice=True)
    return port_pipe.build_graph(port_halo.HaloArgs(**SMOKE),
                                 impl_choice=True, xfer_choice=True)


GRAPHS = {"diamond": _diamond, "wide": _wide, "halo": _halo}


def _seq_json(pkg, seqs):
    return [pkg["serdes"].sequence_to_json(s) for s in seqs]


def _op_json(op):
    return op.to_json() if hasattr(op, "to_json") else op.desc()


# -- core/schedule.py --------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_make_schedules_matches_reference(name):
    cap = 60 if name == "halo" else None
    r = ref_schedule.make_schedules(GRAPHS[name](REF), max_schedules=cap)
    p = port_schedule.make_schedules(GRAPHS[name](PORT), max_schedules=cap)
    assert _seq_json(PORT, p) == _seq_json(REF, r)
    assert len(p) == {"diamond": 2, "wide": 24, "halo": 60}[name]


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("seed", [0, 7])
def test_make_schedules_random_matches_reference(name, seed):
    """Both draw from ``random.Random(seed)`` over the same frontier order:
    the generator is shared, so the schedules are equal, in order."""
    r = ref_schedule.make_schedules_random(GRAPHS[name](REF), 12, seed=seed)
    p = port_schedule.make_schedules_random(GRAPHS[name](PORT), 12,
                                            seed=seed)
    assert _seq_json(PORT, p) == _seq_json(REF, r)
    assert len(p) == 12


# -- core/graph.py -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_helpers_match_reference(name):
    rg, pg = GRAPHS[name](REF), GRAPHS[name](PORT)
    assert pg.vertex_size() == rg.vertex_size()
    rdv, pdv = rg.device_vertices(), pg.device_vertices()
    assert [_op_json(v) for v in pdv] == [_op_json(v) for v in rdv]
    assert pg.dump_graphviz() == rg.dump_graphviz()
    if len(pdv) > 4:
        return  # the halo graph's 2^n assignments: the small graphs suffice
    lanes = 2
    rgs = rg.use_lanes([RefLane(i) for i in range(lanes)])
    pgs = pg.use_lanes([PortLane(i) for i in range(lanes)])
    assert len(pgs) == len(rgs) == lanes ** len(pdv)
    for a, b in zip(rgs, pgs):
        assert [_op_json(v) for v in b.vertices()] == \
            [_op_json(v) for v in a.vertices()]
        assert b.dump_graphviz() == a.dump_graphviz()
    # equivalence of every pair of assignments, as the reference decides it
    want = [[ref_graph.is_equivalent_lane_mapping(x, y) for y in rgs]
            for x in rgs]
    got = [[port_graph.is_equivalent_lane_mapping(x, y) for y in pgs]
           for x in pgs]
    assert got == want
    if len(pdv) > 1:  # one lane for all vs two apart: not equivalent
        assert any(not v for row in got for v in row)


def test_apply_lane_assignment_rebinds_bound_ops():
    for pkg in (REF, PORT):
        g = _diamond(pkg)
        L = pkg["lane"]
        d = {v.name(): v for v in g.device_vertices()}
        g1 = g.apply_lane_assignment({d["b"]: L(1), d["c"]: L(0)})
        b1 = {v.name(): v for v in g1.device_vertices()}["b"]
        assert b1.lane() == L(1)
        g2 = g1.apply_lane_assignment({b1: L(0)})
        assert {v.name(): v for v in g2.device_vertices()}["b"].lane() == \
            L(0)
    rg = _diamond(REF).apply_lane_assignment(
        {v: RefLane(1) for v in _diamond(REF).device_vertices()})
    pg = _diamond(PORT).apply_lane_assignment(
        {v: PortLane(1) for v in _diamond(PORT).device_vertices()})
    assert [_op_json(v) for v in pg.vertices()] == \
        [_op_json(v) for v in rg.vertices()]


# -- core/sequence.py and core/operation.py ----------------------------------

def _terminal(pkg, g, lanes, seed):
    rng = random.Random(seed)
    st, plat = pkg["state"](g), pkg["platform"].make_n_lanes(lanes)
    while not st.is_terminal():
        ds = st.get_decisions(plat)
        st = st.apply(ds[rng.randrange(len(ds))])
    return st.sequence


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sequence_helpers_match_reference(seed):
    rs = [_terminal(REF, _halo(REF), 2, s) for s in (seed, seed + 10)]
    ps = [_terminal(PORT, _halo(PORT), 2, s) for s in (seed, seed + 10)]
    assert _seq_json(PORT, ps) == _seq_json(REF, rs)
    rg, pg = _halo(REF), _halo(PORT)
    for rv, pv in zip(rg.vertices(), pg.vertices()):
        for r, p in zip(rs, ps):
            assert p.contains_unbound(pv) == r.contains_unbound(rv)
            rf, pf = r.find_unbound(rv), p.find_unbound(pv)
            assert (pf is None) == (rf is None)
            if pf is not None:
                assert _op_json(pf) == _op_json(rf)
    want = [[ref_sequence.is_equivalent(a, b) for b in rs] for a in rs]
    got = [[port_sequence.is_equivalent(a, b) for b in ps] for a in ps]
    assert got == want and got[0][0]


def test_find_unbound_is_lane_insensitive():
    for pkg in (REF, PORT):
        Dev, L = _ops(pkg), pkg["lane"]
        b = Dev("b")
        seq = pkg["sequence"].Sequence([pkg["operation"].NoOp("a"),
                                        b.bind(L(1))])
        assert seq.contains_unbound(b) and seq.contains_unbound(b.bind(L(0)))
        assert seq.find_unbound(b).lane() == L(1)
        assert seq.find_unbound(Dev("q")) is None


def test_operation_helpers_match_reference():
    def run(pkg):
        Dev, L = _ops(pkg), pkg["lane"]
        lanes = [L(i) for i in range(3)]
        op = pkg["operation"]
        vs = (op.make_lane_variations(Dev("k"), lanes)
              + op.make_lane_variations(Dev("k").bind(L(2)), lanes)
              + op.make_lane_variations(op.NoOp("h"), lanes))
        uniq = op.keep_uniques(vs + [Dev("m"), op.NoOp("h"), Dev("m")])
        return [_op_json(v) for v in vs], [_op_json(v) for v in uniq]

    assert run(PORT) == run(REF)
    vs, uniq = run(PORT)
    assert len(vs) == 7 and len(uniq) == 3


# -- MCTS ---------------------------------------------------------------------

def _tree(pkg_node, pkg_strategies, pkg):
    """A root expanded two levels with fixed visit counts: the same tree in
    both packages."""
    plat = pkg["platform"].make_n_lanes(2)
    root = pkg_node.Node(pkg["state"](_diamond(pkg)), pkg_strategies.FastMin)
    root.ensure_children(plat)
    for i, c in enumerate(root.children):
        c.n_ = i + 1
        c.ensure_children(plat)
        for j, cc in enumerate(c.children):
            cc.n_ = (i + j) % 3
    root.n_ = sum(c.n_ for c in root.children)
    root.children[-1].fully_visited_ = True
    return root


def test_node_dump_graphviz_matches_reference():
    r = _tree(ref_node, ref_strategies, REF)
    p = _tree(port_node, port_strategies, PORT)
    assert p.dump_graphviz() == r.dump_graphviz()
    assert p.dump_graphviz(max_nodes=2) == r.dump_graphviz(max_nodes=2)
    assert "digraph mcts" in p.dump_graphviz() and "\\nfull" in \
        p.dump_graphviz()


def test_mcts_opts_to_json_and_cadence_match_reference():
    for kw in ({}, dict(n_iters=12, expand_rollout=True, seed=3,
                        cache_benchmarks=False)):
        assert port_mcts.MctsOpts(**kw).to_json() == \
            ref_mcts.MctsOpts(**kw).to_json()
    its = range(0, 1001)
    assert [port_mcts._dump_cadence(i) for i in its] == \
        [ref_mcts._dump_cadence(i) for i in its]


class _FakePlatform:
    def __init__(self, n):
        self.lanes = [PortLane(i) for i in range(n)]

    def provision_events(self, events):
        return None


class _OverlapRewardBench:
    """Schedules using both lanes are faster: a deterministic stand-in."""

    def benchmark(self, order, opts=None):
        from tenzing_tpu_torch.bench.benchmarker import BenchResult
        from tenzing_tpu_torch.core.operation import BoundDeviceOp

        lanes = {op.lane().id for op in order
                 if isinstance(op, BoundDeviceOp)}
        t = 1.0 if len(lanes) > 1 else 2.0
        return BenchResult(t, t, t, t, t, 0.0)


def test_tree_dump_and_csv_dump(tmp_path):
    """The reference's test_tree_dump_and_counters on the port: dot dumps at
    the decaying cadence and the result's CSV at ``dump_csv_path``."""
    Dev = _ops(PORT)
    g = port_graph.Graph()
    a, b = Dev("a"), Dev("b")
    for op in (a, b):
        g.start_then(op)
        g.then_finish(op)
    opts = port_mcts.MctsOpts(
        n_iters=8, seed=0, dump_tree=True,
        dump_tree_prefix=str(tmp_path / "tree"),
        dump_csv_path=str(tmp_path / "mcts.csv"))
    res = port_mcts.explore(g, _FakePlatform(2), _OverlapRewardBench(), opts)
    dots = sorted(tmp_path.glob("tree_*.dot"))
    assert dots and all("digraph mcts" in d.read_text() for d in dots)
    assert [int(d.stem.split("_")[1]) for d in dots] == \
        [i for i in range(8) if port_mcts._dump_cadence(i)][:len(dots)]
    assert (tmp_path / "mcts.csv").read_text() == res.dump_csv()
    assert res.counters is not None and "SELECT" in res.counters.seconds


def test_examples_dump_tree(tmp_path, monkeypatch, capsys):
    """``--dump-tree`` on an example writes ``mcts_tree_*.dot`` into the
    working directory; the init gate's notice and the reproduce stamp go
    to stderr, the CSV rows to stdout."""
    from tenzing_tpu_torch.examples import spmv_mcts

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(initgate.ACK_ENV, raising=False)
    initgate._reset_for_tests()
    assert spmv_mcts.main(["--cpu", "--matrix-m", "256", "--mcts-iters", "3",
                           "--benchmark-iters", "3", "--dump-tree"]) == 0
    out, err = capsys.readouterr()
    dots = sorted(tmp_path.glob("mcts_tree_*.dot"))
    assert dots and "digraph mcts" in dots[0].read_text()
    assert initgate.ACK_ENV in err
    stamp = [json.loads(ln) for ln in err.splitlines()
             if ln.startswith('{"tenzing_tpu_torch"')]
    assert stamp and stamp[0]["argv"]
    assert out.strip() and not out.startswith("{")


# -- bench/benchmarker.py -----------------------------------------------------

def test_benchmark_batch_and_repeat_callable_runner():
    import torch

    from tenzing_tpu_torch.bench.benchmarker import (
        BenchOpts,
        BenchResult,
        EmpiricalBenchmarker,
        RepeatCallableRunner,
    )

    calls = {"a": [], "b": []}
    x = torch.zeros(8)

    def run_n(name):
        def run(n):
            calls[name].append(n)
            for _ in range(n):
                x.add_(1.0)
        return run

    runner = RepeatCallableRunner({k: run_n(k) for k in calls}, device="cpu")
    assert runner.device.type == "cpu"
    runner.prepare("a")()
    assert calls["a"] == [1]
    emp = EmpiricalBenchmarker(runner)
    opts = BenchOpts(n_iters=3, target_secs=0.0005)
    res = emp.benchmark_batch(["a", "b"], opts, seed=7)
    assert len(res) == 2 and all(isinstance(r, BenchResult) for r in res)
    assert all(r.pct50 > 0 for r in res)
    # warm-up, then 3 measurements each, each with as many calls as the
    # adaptive floor asked for
    assert len(calls["b"]) >= 4 and calls["b"][0] == 1
    one = emp.benchmark("a", opts)
    assert one.pct50 > 0


# -- utils --------------------------------------------------------------------

def test_round_up_matches_reference():
    for x in range(-5, 40):
        for m in (1, 2, 3, 8, 128):
            assert numeric.round_up(x, m) == ref_numeric.round_up(x, m)
    for bad in (0, -4):
        with pytest.raises(ValueError):
            numeric.round_up(3, bad)
        with pytest.raises(ValueError):
            ref_numeric.round_up(3, bad)


def test_init_notice_once_like_reference(monkeypatch):
    assert initgate.ACK_ENV == ref_initgate.ACK_ENV
    for gate in (initgate, ref_initgate):
        gate._reset_for_tests()
        monkeypatch.delenv(gate.ACK_ENV, raising=False)
        buf, buf2 = io.StringIO(), io.StringIO()
        gate.init(stream=buf)
        assert gate.ACK_ENV in buf.getvalue()
        gate.init(stream=buf2)
        assert buf2.getvalue() == ""
        assert gate.is_initialized() and gate.init_time() is not None
        gate._reset_for_tests()
        monkeypatch.setenv(gate.ACK_ENV, "1")
        buf3 = io.StringIO()
        gate.init(stream=buf3)
        assert buf3.getvalue() == ""
    assert "tenzing_tpu_torch is research software" in initgate.NOTICE


def test_reproduce_stamp_keys_match_reference():
    buf = io.StringIO()
    line = reproduce.dump_with_cli(["prog", "--flag"], stream=buf)
    d = json.loads(line)
    assert buf.getvalue().strip() == line
    ref = ref_reproduce.stamp(["prog", "--flag"])
    rename = {"tenzing_tpu": "tenzing_tpu_torch", "jax": "torch"}
    assert sorted(d) == sorted(rename.get(k, k) for k in ref)
    assert d["argv"] == ref["argv"] == ["prog", "--flag"]
    assert d["git"] == ref["git"]
    assert d["tenzing_tpu_torch"] == ref["tenzing_tpu"]
    import torch

    assert d["torch"] == torch.__version__


def test_profiling_shim_reexports_xplane():
    from tenzing_tpu_torch.obs.attrib import xplane
    from tenzing_tpu_torch.utils import profiling

    assert profiling.analyze_trace is xplane.analyze_trace
    assert profiling.capture_trace is xplane.capture_trace
    assert profiling.merge_intervals is xplane.merge_intervals
    assert profiling.TRANSFER_KEYWORDS is xplane.TRANSFER_KEYWORDS
