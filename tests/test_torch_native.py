"""The port's native enumerator (tenzing_tpu_torch/native/bridge.py) against
its own Python layer, as the reference's tests/test_native.py holds the
reference's, and against the reference's bridge on the same graphs and seeds.

The C++ core is the repository's ``native/`` sources, built by the port into
``build/tenzing_tpu_torch/``: decisions along random walks, full and capped
enumeration, the spmv counts, rollouts that are legal and vary with the
seed, the disabled mode, compounds resolved, pinned lanes.  A failed build
raises in the default mode, and the MCTS of both packages picks the same
rollouts on a graph that lowers.
"""

import random

import pytest

from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.operation import DeviceOp as RefDeviceOp
from tenzing_tpu.core.operation import NoOp as RefNoOp
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.resources import Lane as RefLane
from tenzing_tpu.core.state import State as RefState
from tenzing_tpu.models.spmv import SpMVCompound as RefSpMVCompound
from tenzing_tpu.native import bridge as ref_bridge
from tenzing_tpu_torch.core.event_synchronizer import EventSynchronizer
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import BoundDeviceOp, DeviceOp, NoOp
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.resources import Lane
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.sequence import get_equivalence as seq_equiv
from tenzing_tpu_torch.core.state import State
from tenzing_tpu_torch.models.spmv import SpMVCompound
from tenzing_tpu_torch.native import bridge
from tenzing_tpu_torch.solve import dfs


class Dev(DeviceOp):
    """A minimal device op (the reference test's)."""

    def apply(self, bufs, ctx):  # pragma: no cover - never run here
        return None


class RefDev(RefDeviceOp):
    def apply(self, bufs, ctx):  # pragma: no cover - never run here
        return {}


PKGS = {
    "port": (Graph, Dev, NoOp, SpMVCompound),
    "ref": (RefGraph, RefDev, RefNoOp, RefSpMVCompound),
}


def host_chain_graph(pkg="port"):
    G, _, Nop, _ = PKGS[pkg]
    g = G()
    a, b = Nop("a"), Nop("b")
    g.start_then(a)
    g.then(a, b)
    g.then_finish(b)
    return g


def device_diamond_graph(pkg="port"):
    """start -> {da, db} -> dc -> finish, all device ops."""
    G, D, _, _ = PKGS[pkg]
    g = G()
    da, db, dc = D("da"), D("db"), D("dc")
    g.start_then(da)
    g.start_then(db)
    g.then(da, dc)
    g.then(db, dc)
    g.then_finish(dc)
    return g


def mixed_graph(pkg="port"):
    """A device op feeding a host op (the device -> host sync case)."""
    G, D, Nop, _ = PKGS[pkg]
    g = G()
    d, h = D("d"), Nop("h")
    g.start_then(d)
    g.then(d, h)
    g.then_finish(h)
    return g


def spmv_graph(pkg="port"):
    return PKGS[pkg][3]().graph()


GRAPHS = [host_chain_graph, device_diamond_graph, mixed_graph, spmv_graph]
SMALL = [host_chain_graph, device_diamond_graph, mixed_graph]


def _js(items):
    return [x.to_json() for x in items]


@pytest.mark.parametrize("make", GRAPHS)
@pytest.mark.parametrize("n_lanes", [1, 2])
def test_decisions_agree_along_random_walks(make, n_lanes):
    plat = Platform.make_n_lanes(n_lanes)
    for seed in range(5):
        rng = random.Random(seed)
        st = State(make())
        while not st.is_terminal():
            py = st.get_decisions(plat)
            nat = bridge.try_decisions(st, plat)
            assert nat is not None
            assert _js(nat) == _js(py)
            st = st.apply(rng.choice(py))


@pytest.mark.parametrize("make", SMALL)
@pytest.mark.parametrize("n_lanes", [1, 2])
def test_enumeration_matches_python(make, n_lanes):
    g = make()
    plat = Platform.make_n_lanes(n_lanes)
    py = dfs.get_unique_sequences(g, plat, max_seqs=100000)
    nat = bridge.try_enumerate(g, plat, max_seqs=100000)
    assert nat is not None
    assert [_js(a.sequence) for a in nat] == [_js(b.sequence) for b in py]


@pytest.mark.parametrize("make", SMALL)
@pytest.mark.parametrize("cap", [1, 3, 7])
def test_capped_enumeration_matches_python(make, cap):
    """The same cap, the same terminal set in the same order: both paths
    count deduplicated terminals against it."""
    g = make()
    plat = Platform.make_n_lanes(2)
    py = dfs.get_unique_sequences(g, plat, max_seqs=cap)
    nat = bridge.try_enumerate(g, plat, max_seqs=cap)
    assert nat is not None
    assert len(nat) == len(py) <= cap
    assert [_js(a.sequence) for a in nat] == [_js(b.sequence) for b in py]


@pytest.mark.parametrize("n_lanes", [1, 2])
def test_enumeration_spmv_counts(n_lanes):
    """One lane: the same count as the Python path; two lanes: no two of
    the survivors equivalent under lane and event renaming."""
    g = spmv_graph()
    plat = Platform.make_n_lanes(n_lanes)
    if n_lanes == 1:
        py = dfs.get_unique_sequences(g, plat, max_seqs=100000)
        nat = bridge.try_enumerate(g, plat, max_seqs=100000)
        assert len(nat) == len(py)
        return
    nat2 = bridge.try_enumerate(g, plat, max_seqs=2000)
    for i in range(min(30, len(nat2))):
        for j in range(i + 1, min(30, len(nat2))):
            assert not seq_equiv(nat2[i].sequence, nat2[j].sequence)


def _assert_legal_complete(graph, seq: Sequence):
    """Every op synced where it stands, every vertex executed once."""
    bound = {op.unbound(): op.lane() for op in seq
             if isinstance(op, BoundDeviceOp)}
    g = graph.apply_lane_assignment(bound) if bound else graph
    seen = []
    for op in seq:
        assert EventSynchronizer.is_synced(g, Sequence(seen), op), (
            f"op {op!r} unsynced at position {len(seen)}")
        seen.append(op)
    executed = {op.eq_key() for op in seq}
    for v in g.vertices():
        assert v.eq_key() in executed


@pytest.mark.parametrize("make", GRAPHS)
def test_rollout_produces_legal_schedules(make):
    g = make()
    plat = Platform.make_n_lanes(2)
    for seed in range(8):
        seq = bridge.try_rollout(State(g), plat, seed)
        assert seq is not None
        _assert_legal_complete(g, seq)


def test_rollout_varies_with_seed():
    g = spmv_graph()
    plat = Platform.make_n_lanes(2)
    seqs = {tuple(op.desc() for op in bridge.try_rollout(State(g), plat, s))
            for s in range(16)}
    assert len(seqs) > 1


@pytest.mark.parametrize("value", ["0", "off", "false"])
def test_disabled_by_env(monkeypatch, value):
    monkeypatch.setenv("TENZING_TPU_NATIVE", value)
    plat = Platform.make_n_lanes(1)
    assert bridge.native_available() is False
    assert bridge.try_decisions(State(host_chain_graph()), plat) is None
    assert bridge.try_rollout(State(host_chain_graph()), plat, 1) is None
    assert bridge.try_enumerate(host_chain_graph(), plat, 10) is None


@pytest.mark.parametrize("n_lanes,count", [(1, None), (2, 96)])
def test_enumerate_schedules_resolves_compounds(n_lanes, count):
    """``enumerate_schedules`` expands compounds first and enumerates each
    variant natively; it matches the Python path that takes ExpandOp as a
    decision."""
    g = Graph()
    c = SpMVCompound()
    g.start_then(c)
    g.then_finish(c)
    plat = Platform.make_n_lanes(n_lanes)
    nat = dfs.enumerate_schedules(g, plat, 100000, log=lambda m: None)
    if count is not None:
        assert len(nat) == count
        return
    py = dfs.get_unique_sequences(g, plat, 100000)
    assert len(nat) == len(py)
    for st in nat:
        _js(st.sequence)


def test_enumerate_honors_pinned_lane_bindings():
    """Device ops the caller bound keep their lanes on the native path,
    matching the Python path exactly."""
    g = device_diamond_graph()
    pinned = g.apply_lane_assignment({g.device_vertices()[0]: Lane(1)})
    plat = Platform.make_n_lanes(2)
    py = dfs.get_unique_sequences(pinned, plat, max_seqs=100000)
    nat = bridge.try_enumerate(pinned, plat, max_seqs=100000)
    assert nat is not None
    assert [_js(a.sequence) for a in nat] == [_js(b.sequence) for b in py]
    for st in nat:
        for op in st.sequence:
            if isinstance(op, BoundDeviceOp) and op.name() == "da":
                assert op.lane().id == 1


def test_not_lowerable_and_sparse_lanes_take_the_python_path():
    """A graph with a compound op does not lower, and lanes that are not
    0..n-1 do not apply: both return None (a choice of structure, not a
    fallback from a failure)."""
    g = Graph()
    c = SpMVCompound()
    g.start_then(c)
    g.then_finish(c)
    plat = Platform.make_n_lanes(2)
    assert bridge.try_decisions(State(g), plat) is None
    assert bridge.try_enumerate(g, plat, 10) is None

    class Sparse:
        lanes = [Lane(0), Lane(2)]

    assert bridge.try_decisions(State(host_chain_graph()), Sparse()) is None


# -- against the reference's bridge -------------------------------------------


@pytest.mark.parametrize("make", GRAPHS)
@pytest.mark.parametrize("n_lanes", [1, 2])
def test_decisions_and_rollouts_equal_reference(make, n_lanes):
    plat, rplat = Platform.make_n_lanes(n_lanes), RefPlatform.make_n_lanes(n_lanes)
    for seed in range(6):
        mine = bridge.try_rollout(State(make()), plat, seed)
        theirs = ref_bridge.try_rollout(RefState(make("ref")), rplat, seed)
        assert _js(mine) == _js(theirs)
    rng = random.Random(1)
    st, rst = State(make()), RefState(make("ref"))
    while not st.is_terminal():
        mine = bridge.try_decisions(st, plat)
        theirs = ref_bridge.try_decisions(rst, rplat)
        assert _js(mine) == _js(theirs)
        k = rng.randrange(len(mine))
        st, rst = st.apply(mine[k]), rst.apply(theirs[k])


@pytest.mark.parametrize("make", GRAPHS)
@pytest.mark.parametrize("cap", [5, 100000])
def test_enumeration_equals_reference(make, cap):
    plat, rplat = Platform.make_n_lanes(2), RefPlatform.make_n_lanes(2)
    mine = bridge.try_enumerate(make(), plat, cap)
    theirs = ref_bridge.try_enumerate(make("ref"), rplat, cap)
    assert [_js(s.sequence) for s in mine] == [_js(s.sequence) for s in theirs]


def test_pinned_enumeration_equals_reference():
    g, rg = device_diamond_graph(), device_diamond_graph("ref")
    pinned = g.apply_lane_assignment({g.device_vertices()[0]: Lane(1)})
    rpinned = rg.apply_lane_assignment({rg.device_vertices()[0]: RefLane(1)})
    mine = bridge.try_enumerate(pinned, Platform.make_n_lanes(2), 1000)
    theirs = ref_bridge.try_enumerate(rpinned, RefPlatform.make_n_lanes(2),
                                      1000)
    assert [_js(s.sequence) for s in mine] == [_js(s.sequence) for s in theirs]


class _KeyBench:
    """Deterministic answers from a schedule's JSON, for either package."""

    def __init__(self, to_json, result_cls):
        self.to_json = to_json
        self.result_cls = result_cls

    def benchmark(self, order, opts=None):
        import hashlib
        import json

        h = hashlib.sha256(json.dumps(self.to_json(order)).encode()).digest()
        t = 1e-3 * (1.0 + h[0] / 256.0)
        return self.result_cls.from_times([t, t, t])


@pytest.mark.parametrize("make", [device_diamond_graph, mixed_graph,
                                  spmv_graph])
def test_mcts_rollouts_equal_reference(make):
    """On a graph that lowers, the port's MCTS draws each playout's native
    seed from its RNG as the reference's does, so the two search the same
    rollouts in the same order."""
    from tenzing_tpu.bench.benchmarker import BenchOpts as RefOpts
    from tenzing_tpu.bench.benchmarker import BenchResult as RefResult
    from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
    from tenzing_tpu.solve.mcts import mcts as ref_mcts
    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, BenchResult
    from tenzing_tpu_torch.core.serdes import sequence_to_json
    from tenzing_tpu_torch.solve.mcts import mcts

    mine = mcts.explore(make(), Platform.make_n_lanes(2),
                        _KeyBench(sequence_to_json, BenchResult),
                        mcts.MctsOpts(n_iters=12, seed=4,
                                      bench_opts=BenchOpts(n_iters=1)))
    theirs = ref_mcts.explore(make("ref"), RefPlatform.make_n_lanes(2),
                              _KeyBench(ref_to_json, RefResult),
                              ref_mcts.MctsOpts(n_iters=12, seed=4,
                                                bench_opts=RefOpts(n_iters=1)))
    assert len(mine.sims) == len(theirs.sims) > 0
    assert [sequence_to_json(s.order) for s in mine.sims] == \
        [ref_to_json(s.order) for s in theirs.sims]


# -- the build -----------------------------------------------------------------


def test_library_is_the_ports_own_build():
    """The port builds its own library from native/src into
    build/tenzing_tpu_torch/ and loads that, never the JAX package's."""
    assert bridge.native_available() is True
    path = bridge.library_path()
    assert path.parent == bridge.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "tenzing_tpu_torch")
    assert path.exists()
    assert bridge._lib._name == str(path)
    assert "tenzing_tpu/" not in bridge._lib._name.replace("tenzing_tpu_torch", "")


def test_build_failure_raises_in_auto(monkeypatch, tmp_path):
    """No silent fall back to Python: a compiler that fails makes every
    native call raise, in the default mode as with ``1``."""
    for mode in ("auto", "1"):
        monkeypatch.setenv("TENZING_TPU_NATIVE", mode)
        monkeypatch.setattr(bridge, "BUILD_DIR", tmp_path / mode)
        monkeypatch.setattr(bridge, "CXX", str(tmp_path / "no-such-compiler"))
        monkeypatch.setattr(bridge, "_lib", None)
        monkeypatch.setattr(bridge, "_lib_error", None)
        with pytest.raises(bridge.NativeError, match="native build"):
            bridge.native_available()
        with pytest.raises(bridge.NativeError, match="unavailable"):
            bridge.try_decisions(State(host_chain_graph()),
                                 Platform.make_n_lanes(1))
