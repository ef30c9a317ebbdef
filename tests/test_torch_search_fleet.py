"""The port's search fleet (tenzing_tpu_torch/search/fleet.py) against the
reference's tests/test_search_fleet.py, test for test, and against the JAX
package itself.

* grouped rounds: a fused round with ``group_seeds`` visits and times each
  group exactly as that group's solo ``benchmark_batch_times`` call does,
  and a partition that is not consecutive non-empty runs is refused;
* the file control plane's snapshots and claims, ``SharedSearchState``;
* the owner's fused round, its hints and singles, and an error's round trip
  with its fault class;
* MCTS subtree slices: disjoint, covering, never empty;
* ``run_serialized`` equal to the port's direct ``hill_climb`` and to the
  reference's ``run_serialized`` on the same jobs and answers;
* a two-worker fleet over the device-free spmv smoke graph, each worker
  reporting CUDA uninitialized, and a worker killed mid-job whose job the
  other adopts.
"""

import hashlib
import json
import os
import signal
import threading
import time

import pytest

from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.schedule import remove_redundant_syncs as ref_rrs
from tenzing_tpu.core.sequence import canonical_key as ref_canonical_key
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu.models.spmv import SpMVCompound as RefSpMVCompound
from tenzing_tpu.search import fleet as ref_fleet
from tenzing_tpu.solve.dfs import enumerate_schedules as ref_enumerate
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.bench.benchmarker import BenchOpts as RefBenchOpts
from tenzing_tpu.bench.benchmarker import BenchResult as RefBenchResult
from tenzing_tpu_torch.bench.benchmarker import (
    BenchOpts,
    BenchResult,
    CsvBenchmarker,
    EmpiricalBenchmarker,
    result_row,
    schedule_id,
)
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.schedule import remove_redundant_syncs
from tenzing_tpu_torch.core.sequence import canonical_key
from tenzing_tpu_torch.core.serdes import sequence_to_json
from tenzing_tpu_torch.core.state import State
from tenzing_tpu_torch.fault.errors import DeviceLostError
from tenzing_tpu_torch.models.spmv import SpMVCompound
from tenzing_tpu_torch.obs.metrics import MetricsRegistry, set_metrics
from tenzing_tpu_torch.parallel.control_plane import FileControlPlane
from tenzing_tpu_torch.search.fleet import (
    FleetBenchmarker,
    FleetJob,
    MeasureOwner,
    SharedSearchState,
    _opts_from_json,
    _opts_to_json,
    _result_from_json,
    _result_to_json,
    claim_key,
    resolve_prefer,
    run_fleet,
    run_serialized,
)
from tenzing_tpu_torch.solve.dfs import enumerate_schedules
from tenzing_tpu_torch.solve.local import LocalOpts, hill_climb
from tenzing_tpu_torch.solve.mcts.mcts import Node, prune_to_subtree
from tenzing_tpu_torch.solve.mcts.strategies import FastMin


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


def _ref_graph():
    g = RefGraph()
    g.start_then(RefSpMVCompound())
    g.then_finish(RefSpMVCompound())
    return g


def _synth_time(key) -> float:
    """A deterministic time per canonical schedule (the reference test's)."""
    h = hashlib.sha256(repr(key).encode()).digest()
    return 1.0 + int.from_bytes(h[:8], "big") / float(1 << 64)


def _synth_result(seq) -> BenchResult:
    t = _synth_time(canonical_key(remove_redundant_syncs(seq)))
    return BenchResult.from_times([t, t, t])


@pytest.fixture(scope="module")
def corpus():
    states = enumerate_schedules(_graph(), Platform.make_n_lanes(2),
                                 max_seqs=10_000, log=lambda m: None)
    assert 4 <= len(states) < 10_000
    return [st.sequence for st in states]


# -- identity and serialization ----------------------------------------------


def test_claim_key_canonical_and_stable(corpus):
    a, b = corpus[0], corpus[1]
    assert claim_key(a) == claim_key(a)
    assert len(claim_key(a)) == 32
    assert int(claim_key(a), 16) >= 0
    assert claim_key(a) != claim_key(b)
    assert claim_key(remove_redundant_syncs(a)) == claim_key(a)
    # the same digest as the reference's on the same schedules
    ref = ref_enumerate(_ref_graph(), RefPlatform.make_n_lanes(2),
                        max_seqs=10_000)
    mine = {json.dumps(sequence_to_json(s)): claim_key(s) for s in corpus}
    theirs = {json.dumps(ref_to_json(s.sequence)):
              ref_fleet.claim_key(s.sequence) for s in ref}
    assert mine == theirs


def test_json_round_trips():
    j = FleetJob(index=3, budget=17, seed=9, lanes=6,
                 phases=("pack", "unpack"), prefer="recorded",
                 chosen={"xfer_a": "xfer_a.rdma"}, kind="mcts",
                 subtree=(1, 4))
    assert FleetJob.from_json(j.to_json()) == j
    assert j.to_json() == ref_fleet.FleetJob(
        index=3, budget=17, seed=9, lanes=6, phases=("pack", "unpack"),
        prefer="recorded", chosen={"xfer_a": "xfer_a.rdma"}, kind="mcts",
        subtree=(1, 4)).to_json()
    assert FleetJob.from_json(FleetJob(index=0, budget=1,
                                       seed=2).to_json()).phases == ("",)
    opts = BenchOpts(n_iters=7, max_retries=3, target_secs=0.25)
    rt = _opts_from_json(_opts_to_json(opts))
    assert (rt.n_iters, rt.max_retries, rt.target_secs) == (7, 3, 0.25)
    assert _opts_to_json(opts) == ref_fleet._opts_to_json(
        RefBenchOpts(n_iters=7, max_retries=3, target_secs=0.25))
    res = BenchResult.from_times([0.5, 0.25, 0.75])
    assert _result_from_json(_result_to_json(res)) == res
    assert _result_to_json(res) == ref_fleet._result_to_json(
        RefBenchResult.from_times([0.5, 0.25, 0.75]))


def test_resolve_prefer_names_driver_policies():
    from tenzing_tpu_torch.bench import driver

    assert resolve_prefer(FleetJob(0, 1, 2)) is driver.generic_xla_prefer
    assert resolve_prefer(
        FleetJob(0, 1, 2, prefer="halo_alias")) is driver.halo_alias_prefer
    assert resolve_prefer(
        FleetJob(0, 1, 2, prefer="moe_bf16")) is driver.moe_bf16_prefer
    rec = resolve_prefer(FleetJob(0, 1, 2, prefer="recorded",
                                  chosen={"op": "op.host"}))
    assert rec("op", ["op.xla", "op.host"]) == "op.host"
    assert rec("other", ["other.xla", "other.host"]) == "other.xla"
    for choices in (["a.xla", "a.pallas"], ["a.pallas"], ["a.host", "a.xla"]):
        assert driver.generic_xla_prefer("a", choices) == \
            ref_fleet.resolve_prefer(ref_fleet.FleetJob(0, 1, 2))("a", choices)


# -- control plane and shared state ------------------------------------------


def test_file_control_plane_snapshots_and_claims(tmp_path):
    root = str(tmp_path / "ctrl")
    cp0 = FileControlPlane(root, 0, 2)
    cp1 = FileControlPlane(root, 1, 2)
    cp0.publish("incumbent", {"cost_s": 2.0})
    cp1.publish("incumbent", {"cost_s": 1.0})
    cp0.publish("incumbent", {"cost_s": 1.5})  # replaces rank 0's snapshot
    snaps = cp1.gather("incumbent")
    assert snaps == {0: {"cost_s": 1.5}, 1: {"cost_s": 1.0}}
    assert cp1.gather("incumbent", include_self=False) == {0: {"cost_s": 1.5}}
    # generation-stamped: the second publish of rank 0 is its generation 2
    with open(os.path.join(root, "incumbent.r0.json")) as f:
        assert json.load(f)["gen"] == 2
    assert cp0.claim("visited", "k1") is True
    assert cp1.claim("visited", "k1") is False
    assert cp1.claim("visited", "k2") is True
    assert cp0.claim_count("visited") == 2
    # the lockstep collectives are the identity
    cp0.barrier()
    assert cp0.bcast_json({"a": 1}) == {"a": 1}
    assert cp1.allreduce_max(3.5) == 3.5
    assert (cp1.rank(), cp1.size()) == (1, 2)


def test_shared_search_state_claims_and_incumbents(tmp_path, registry,
                                                   corpus):
    root = str(tmp_path / "ctrl")
    s0 = SharedSearchState(FileControlPlane(root, 0, 2))
    s1 = SharedSearchState(FileControlPlane(root, 1, 2))
    assert s0.claim(corpus[0]) is True
    assert s1.claim(corpus[0]) is False  # rank 0 already paid for it
    assert s1.claim(corpus[1]) is True
    assert (s0.claimed, s0.claim_misses) == (1, 0)
    assert (s1.claimed, s1.claim_misses) == (1, 1)
    assert registry.counter("search.fleet.claim_misses").value == 1
    s0.note_incumbent(2.0, corpus[0])
    s1.note_incumbent(1.0, corpus[1])
    s0.note_incumbent(3.0, corpus[2])  # worse: not published
    assert s0.cp.gather("incumbent")[0]["cost_s"] == 2.0
    assert s0.global_best() == (1, 1.0)


# -- grouped rounds -----------------------------------------------------------


class _Runner:
    """A runner whose ``run_n`` only names its schedule."""

    device = "cpu"

    def prepare_n(self, order):
        def run_n(n):
            pass

        run_n.key = schedule_id(order)
        return run_n


class VisitRecorder(EmpiricalBenchmarker):
    """The port's EmpiricalBenchmarker with the device replaced by a visit
    log: a time depends only on (schedule, its own visit count), so two
    calls give equal times iff they visit alike."""

    def __init__(self):
        super().__init__(_Runner())
        self.visits = []
        self._counts = {}
        self._overhead = 0.0

    def _measure(self, run_n, n_samples, opts):
        k = run_n.key
        c = self._counts[k] = self._counts.get(k, 0) + 1
        self.visits.append(k)
        h = int(hashlib.sha256(k.encode()).hexdigest()[:12], 16)
        return (h % 9973 + c) / 1e6, n_samples


def test_fused_group_seeds_bit_identical_to_solo(corpus):
    """A group's visit order (and so its times and accept decisions) depends
    only on its own (orders, seed), never on what shares the round."""
    ga, gb = corpus[:2], corpus[2:4]
    opts = BenchOpts(n_iters=4, max_retries=1)
    fused = VisitRecorder()
    t_fused = fused.benchmark_batch_times(
        ga + gb, opts, seed=5, group_seeds=[(2, 5), (2, 9)])
    solo_a, solo_b = VisitRecorder(), VisitRecorder()
    t_a = solo_a.benchmark_batch_times(ga, opts, seed=5)
    t_b = solo_b.benchmark_batch_times(gb, opts, seed=9)
    assert t_fused[:2] == t_a and t_fused[2:] == t_b
    keys_a = {schedule_id(o) for o in ga}
    assert [k for k in fused.visits if k in keys_a] == solo_a.visits
    assert [k for k in fused.visits if k not in keys_a] == solo_b.visits
    # None is one group: the same visits as before group_seeds existed
    one, whole = VisitRecorder(), VisitRecorder()
    assert one.benchmark_batch_times(ga + gb, opts, seed=5) == \
        whole.benchmark_batch_times(ga + gb, opts, seed=5,
                                    group_seeds=[(4, 5)])
    assert one.visits == whole.visits


def test_group_seeds_pass_through_the_driver_stack(tmp_path, corpus):
    """The owner's batcher as the driver's stack gives it (the cache's
    ``.inner``: journal, resilient layer, prefetcher, empirical): a fused
    round through it visits each group as that group's solo call does."""
    from tenzing_tpu_torch.bench.benchmarker import CachingBenchmarker
    from tenzing_tpu_torch.bench.pipeline import PrefetchingBenchmarker
    from tenzing_tpu_torch.fault import (
        JournalingBenchmarker,
        ResilientBenchmarker,
        SearchCheckpoint,
    )

    class Captures:
        def precompile(self, order):
            return True

    def stack(emp, name):
        pf = PrefetchingBenchmarker(emp, executor=Captures(), workers=1)
        journal = JournalingBenchmarker(ResilientBenchmarker(pf),
                                        SearchCheckpoint(str(tmp_path / name)))
        return CachingBenchmarker(journal), pf

    ga, gb = corpus[:2], corpus[2:4]
    opts = BenchOpts(n_iters=3, max_retries=1)
    fused = VisitRecorder()
    bench, pf = stack(fused, "fused")
    owner = MeasureOwner(str(tmp_path), _graph(), bench, measure_batch=4)
    t_fused = owner.batcher(ga + gb, opts, seed=5,
                            group_seeds=[(2, 5), (2, 9)])
    pf.close()
    solo_a, solo_b = VisitRecorder(), VisitRecorder()
    assert t_fused[:2] == solo_a.benchmark_batch_times(ga, opts, seed=5)
    assert t_fused[2:] == solo_b.benchmark_batch_times(gb, opts, seed=9)
    keys_a = {schedule_id(o) for o in ga}
    assert [k for k in fused.visits if k in keys_a] == solo_a.visits
    assert [k for k in fused.visits if k not in keys_a] == solo_b.visits


def test_bad_group_partition_rejected(corpus):
    with pytest.raises(ValueError, match="partition"):
        VisitRecorder().benchmark_batch_times(
            corpus[:3], BenchOpts(n_iters=1), group_seeds=[(2, 5)])
    with pytest.raises(ValueError, match="partition"):
        VisitRecorder().benchmark_batch_times(
            corpus[:2], BenchOpts(n_iters=1), group_seeds=[(2, 5), (0, 9)])


# -- the worker <-> owner file protocol ---------------------------------------


class SynthBench:
    """The owner's benchmark stack stand-in (the reference test's):
    deterministic answers per schedule, batch protocol included.  ``key``
    and ``result`` pick the package whose schedules it answers."""

    def __init__(self, fail=None, result=_synth_result, delay=0.0):
        self.fail = fail
        self.result = result
        self.delay = delay
        self.group_seeds_seen = []

    def benchmark(self, order, opts=None):
        if self.fail is not None:
            exc = self.fail(order)
            if exc is not None:
                raise exc
        return self.result(order)

    def benchmark_batch_times(self, orders, opts=None, seed=0,
                              times_out=None, group_seeds=None):
        self.group_seeds_seen.append(group_seeds)
        time.sleep(self.delay)
        n = (opts or BenchOpts()).n_iters
        return [[self.result(o).pct50] * n for o in orders]


def _mk_fleet_dir(tmp_path):
    d = str(tmp_path / "fleet")
    for sub in ("jobs", "mq", "ctrl"):
        os.makedirs(os.path.join(d, sub))
    return d


def test_owner_answers_fused_round_per_request(tmp_path, registry, corpus):
    d = _mk_fleet_dir(tmp_path)
    g = _graph()
    bench = SynthBench()
    owner = MeasureOwner(d, g, bench, measure_batch=4)
    owner.heartbeat()
    p1 = FleetBenchmarker(d, 1, g, timeout_secs=5.0)
    p2 = FleetBenchmarker(d, 2, g, timeout_secs=5.0)
    opts = BenchOpts(n_iters=3, max_retries=1)
    r1 = p1._submit("batch", corpus[:2], opts, seed=5)
    r2 = p2._submit("batch", corpus[2:4], opts, seed=9)
    owner.drain(busy_workers=2)
    assert owner.rounds == 1 and owner.fused_orders == 4
    assert owner.occupancy() == 1.0
    assert bench.group_seeds_seen == [[(2, 5), (2, 9)]]
    assert registry.counter("search.fleet.rounds").value == 1
    assert registry.counter("search.fleet.fused_orders").value == 4
    t1 = [list(ts) for ts in p1._await(r1)["times"]]
    t2 = [list(ts) for ts in p2._await(r2)["times"]]
    assert t1 == [[_synth_result(o).pct50] * 3 for o in corpus[:2]]
    assert t2 == [[_synth_result(o).pct50] * 3 for o in corpus[2:4]]
    r3 = p1._submit("batch", corpus[:1], opts, seed=1)
    owner.drain(busy_workers=1)  # every busy worker waiting: fires at 1
    out = p1._await(r3)
    assert [list(ts) for ts in out["times"]] == [
        [_synth_result(corpus[0]).pct50] * 3]
    assert owner.rounds == 2 and owner.occupancy() == 5 / 8
    assert owner.longest_round_s >= 0.0


def test_owner_forwards_hints_and_singles(tmp_path, registry, corpus):
    d = _mk_fleet_dir(tmp_path)
    g = _graph()

    class Prefetcher:
        def __init__(self):
            self.seen = []

        def prefetch(self, orders):
            self.seen.extend(orders)
            return len(orders)

    pf = Prefetcher()
    owner = MeasureOwner(d, g, SynthBench(), measure_batch=4, prefetcher=pf)
    owner.heartbeat()
    proxy = FleetBenchmarker(d, 0, g, timeout_secs=5.0)
    assert proxy.prefetch(corpus[:3]) == 3
    rid = proxy._submit("single", corpus[:1], BenchOpts(n_iters=2), 0)
    owner.drain(busy_workers=1)
    assert owner.hints == 3 and owner.singles == 1 and owner.rounds == 0
    assert [canonical_key(o) for o in pf.seen] == [
        canonical_key(o) for o in corpus[:3]]
    assert registry.counter("search.fleet.hints").value == 3
    assert registry.counter("search.fleet.singles").value == 1
    res = _result_from_json(proxy._await(rid)["result"])
    assert res == _synth_result(corpus[0])


def test_owner_error_round_trip_preserves_fault_class(tmp_path, registry,
                                                      corpus):
    d = _mk_fleet_dir(tmp_path)
    g = _graph()
    bench = SynthBench(fail=lambda o: ValueError("synthetic owner failure"))
    owner = MeasureOwner(d, g, bench, measure_batch=2)
    owner.heartbeat()
    proxy = FleetBenchmarker(d, 0, g, timeout_secs=5.0)
    rid = proxy._submit("single", corpus[:1], BenchOpts(n_iters=1), 0)
    owner.drain(busy_workers=1)
    with pytest.raises(RuntimeError, match=r"\[owner\] ValueError"):
        proxy._await(rid)
    # a device loss is fatal on both sides: the owner raises after
    # answering, and the worker rebuilds the DeviceLostError class
    bench.fail = lambda o: DeviceLostError("tunnel collapsed")
    rid = proxy._submit("single", corpus[:1], BenchOpts(n_iters=1), 0)
    with pytest.raises(DeviceLostError):
        owner.drain(busy_workers=1)
    with pytest.raises(DeviceLostError, match="tunnel collapsed"):
        proxy._await(rid)
    # so are an interrupt and an exit, from a fused round too
    for exc in (KeyboardInterrupt(), SystemExit(3)):
        bench.fail = None

        def boom(*a, exc=exc, **k):
            raise exc

        owner.batcher = boom
        rid = proxy._submit("batch", corpus[:2], BenchOpts(n_iters=1), 0)
        with pytest.raises(type(exc)):
            owner.drain(busy_workers=1)
        with pytest.raises(RuntimeError, match=type(exc).__name__):
            proxy._await(rid)


# -- subtree partitioning -----------------------------------------------------


def _first_branching_node(plat):
    """The first node of the deterministic decision tree with more than one
    child (the spmv root's only decision is the compound's expansion)."""
    node = Node(State(_graph()), FastMin)
    node.ensure_children(plat)
    while len(node.children) == 1:
        node = node.children[0]
        node.ensure_children(plat)
    assert len(node.children) >= 2
    return node


def test_mcts_subtree_slices_disjoint_covering_nonempty():
    plat = Platform.make_n_lanes(2)
    all_keys = [c.decision.key()
                for c in _first_branching_node(plat).children]
    seen = []
    for k in range(2):
        node = _first_branching_node(plat)
        prune_to_subtree(node, plat, (k, 2))
        keys = [c.decision.key() for c in node.children]
        assert keys  # never empty
        seen.extend(keys)
    assert sorted(seen) == sorted(all_keys)  # disjoint and covering
    # more ranks than children: the empty slice keeps one child
    for k in range(len(all_keys) + 2):
        node = _first_branching_node(plat)
        prune_to_subtree(node, plat, (k, len(all_keys) + 2))
        assert len(node.children) >= 1


def test_dfs_subtree_slices_partition_the_terminals(corpus):
    """``DfsOpts.subtree`` (k, n) keeps every n-th terminal from the k-th:
    the n slices cover the enumeration and never overlap."""
    from tenzing_tpu_torch.solve.dfs import DfsOpts, explore

    bench = SynthBench()
    got = []
    for k in range(3):
        r = explore(_graph(), Platform.make_n_lanes(2), bench,
                    DfsOpts(max_seqs=10_000, bench_opts=BenchOpts(n_iters=1),
                            subtree=(k, 3)))
        got.append([canonical_key(s.order) for s in r.sims])
        assert got[-1]
    flat = [key for keys in got for key in keys]
    assert len(flat) == len(set(flat)) == len(corpus)


# -- the serialized path ------------------------------------------------------


def test_run_serialized_bit_identical_to_legacy_climb(corpus):
    g = _graph()
    rows = [result_row(i, _synth_result(s), s)
            for i, s in enumerate(corpus)]
    opts = BenchOpts(n_iters=3, max_retries=1)
    jobs = [FleetJob(index=0, budget=5, seed=3, lanes=2),
            FleetJob(index=1, budget=4, seed=7, lanes=2)]
    fr = run_serialized(g, jobs, CsvBenchmarker(rows, g, normalize=True),
                        opts)
    assert fr.stats["workers"] == 1 and fr.stats["measure_batch"] == 1
    assert fr.stats["failed_jobs"] == 0
    assert fr.stats["distinct_candidates"] >= 1
    for j, jr in zip(jobs, fr.jobs):
        r = hill_climb(
            g, Platform.make_n_lanes(2),
            CsvBenchmarker(rows, g, normalize=True), j.phases,
            prefer=resolve_prefer(j),
            opts=LocalOpts(budget=j.budget, bench_opts=opts, seed=j.seed,
                           paired=True))
        assert [(canonical_key(s.order), s.result.pct50)
                for s in jr.sims] == [
            (canonical_key(s.order), s.result.pct50) for s in r.sims]
        assert canonical_key(jr.final.order) == canonical_key(r.final.order)
        assert jr.final.result == r.final.result


def _ref_synth_result(seq):
    t = _synth_time(ref_canonical_key(ref_rrs(seq)))
    return RefBenchResult.from_times([t, t, t])


def test_run_serialized_equals_reference():
    """The same jobs through the port's and the reference's
    ``run_serialized``, each answered by the reference test's deterministic
    bench over its own package's schedules: the same candidates in the same
    order, the same results, the same chain tips."""
    jobs = [dict(index=0, budget=6, seed=3, lanes=2),
            dict(index=1, budget=5, seed=7, lanes=2)]
    mine = run_serialized(_graph(), [FleetJob(**j) for j in jobs],
                          SynthBench(), BenchOpts(n_iters=3, max_retries=1))
    theirs = ref_fleet.run_serialized(
        _ref_graph(), [ref_fleet.FleetJob(**j) for j in jobs],
        SynthBench(result=_ref_synth_result),
        RefBenchOpts(n_iters=3, max_retries=1))
    assert len(mine.jobs) == len(theirs.jobs) == 2
    for a, b in zip(mine.jobs, theirs.jobs):
        assert a.failed is None and b.failed is None
        assert [(sequence_to_json(s.order), s.result.to_json())
                for s in a.sims] == [
            (ref_to_json(s.order), s.result.to_json()) for s in b.sims]
        assert sequence_to_json(a.final.order) == ref_to_json(b.final.order)
        assert a.final.result.to_json() == b.final.result.to_json()
    for key in ("candidates", "distinct_candidates", "best_cost_us",
                "failed_jobs", "jobs"):
        assert mine.stats[key] == theirs.stats[key], key


# -- the fleet end to end -----------------------------------------------------


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """Two worker subprocesses over the device-free spmv smoke graph, this
    process the owner."""
    from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for

    reg = MetricsRegistry()
    prev = set_metrics(reg)
    try:
        req = DriverRequest(workload="spmv", smoke=True)
        g, _ = graph_for(req)
        jobs = [FleetJob(index=0, budget=4, seed=2, lanes=2),
                FleetJob(index=1, budget=4, seed=3, lanes=2)]
        d = str(tmp_path_factory.mktemp("fleet") / "fleet")
        fr = run_fleet(g, req.to_json(), jobs, SynthBench(),
                       BenchOpts(n_iters=3, max_retries=1), n_workers=2,
                       measure_batch=4, verify=False, fleet_dir=d,
                       lease_ttl=5.0)
    finally:
        set_metrics(prev)
    return fr, jobs, d, reg


def test_fleet_end_to_end_two_workers(fleet_run):
    """Every job completes, at least one fused round fires, incumbents and
    claims cross the fleet, and the ``perf.distributed`` block is full."""
    fr, jobs, d, reg = fleet_run
    st = fr.stats
    assert st["failed_jobs"] == 0 and len(fr.jobs) == 2
    for jr in fr.jobs:
        assert jr.final is not None and jr.sims
        assert jr.worker in ("worker-r0", "worker-r1")
    assert st["rounds"] >= 1
    assert 0.0 < st["batch_occupancy"] <= 1.0
    assert st["candidates"] == sum(len(jr.sims) for jr in fr.jobs)
    assert 1 <= st["distinct_candidates"] <= st["candidates"]
    assert st["best_cost_us"] == pytest.approx(
        min(s.result.pct50 for jr in fr.jobs for s in jr.sims) * 1e6,
        rel=1e-6)
    assert st["claimed_keys"] >= 1
    assert st["incumbent_costs_s"]
    assert st["worker_restarts"] == 0
    assert reg.counter("search.fleet.rounds").value == st["rounds"]
    for j in jobs:
        assert os.path.exists(os.path.join(d, "jobs",
                                           f"job-{j.index}.done.json"))


def test_fleet_workers_leave_cuda_uninitialized(fleet_run):
    """Each worker reports CUDA uninitialized at its exit and in every done
    document it wrote."""
    fr, jobs, d, _ = fleet_run
    assert fr.stats["worker_cuda_initialized"] == {"0": False, "1": False}
    for j in jobs:
        with open(os.path.join(d, "jobs", f"job-{j.index}.done.json")) as f:
            assert json.load(f)["cuda_initialized"] is False


def test_killed_worker_job_is_adopted(tmp_path, registry):
    """A worker killed with SIGKILL in the middle of its job: the lease of
    the job expires and the other worker adopts and finishes it."""
    from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for

    req = DriverRequest(workload="spmv", smoke=True)
    g, _ = graph_for(req)
    jobs = [FleetJob(index=0, budget=3, seed=2, lanes=2),
            FleetJob(index=1, budget=3, seed=3, lanes=2)]
    d = str(tmp_path / "fleet")
    killed = {}

    def kill_first_holder():
        deadline = time.time() + 60
        while time.time() < deadline and not killed:
            for j in jobs:
                lease = os.path.join(d, "jobs", f"job-{j.index}.lease")
                busy = [n for n in os.listdir(os.path.join(d, "jobs"))
                        if n.startswith("busy-r")] if os.path.isdir(
                    os.path.join(d, "jobs")) else []
                try:
                    with open(lease) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    continue
                if busy:
                    os.kill(int(doc["pid"]), signal.SIGKILL)
                    killed.update(job=j.index, owner=doc["owner"])
                    return
            time.sleep(0.01)

    t = threading.Thread(target=kill_first_holder, daemon=True)
    t.start()
    fr = run_fleet(g, req.to_json(), jobs, SynthBench(delay=0.2),
                   BenchOpts(n_iters=3, max_retries=1), n_workers=2,
                   measure_batch=4, verify=False, fleet_dir=d,
                   lease_ttl=1.5)
    t.join()
    st = fr.stats
    assert killed, "no worker was killed"
    assert st["failed_jobs"] == 0
    assert st["reclaimed_subtrees"] >= 1
    assert st["worker_exits"] >= 1 and st["worker_restarts"] == 0
    adopted = next(jr for jr in fr.jobs if jr.index == killed["job"])
    assert adopted.reclaimed and adopted.worker != killed["owner"]
    assert adopted.final is not None and adopted.sims
    assert registry.counter("search.fleet.reclaimed_subtrees").value >= 1
