"""The port's compile stage: the CUDA-graph capture plan
(runtime/graphs.py), the executor's capture and replay, and the launch
counts a replay adds.

On the CPU: the plan's segments for the halo naive, greedy-rdma-2l and
alias-8l orders, an attention chunked order and the moe ``.rdma`` orders,
each at its count; a deferred ``EventSync`` does not split a segment and
``defer_host_syncs=False`` does; every op lands in exactly one segment; the
plan's host waits per run equal the executor's ``host_syncs``; the CPU
executor provisions without capturing.  The ``test_cuda_*`` tests need the
card (marker ``needs_cuda``): replay against eager on the same orders (bit
for bit for halo and SpMV data movement, within the stated tolerances for
attention and moe), ``run()`` after ``prepare_n``, a background capture
while the foreground replays, the launch counters equal under both, and a
schedule that cannot be captured raising with its op named."""

import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from tenzing_tpu_torch.bench.driver import attn_graph, halo_alias_prefer
from tenzing_tpu_torch.core.operation import DeviceOp, Finish, Start
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.resources import Lane
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.models import halo_pipeline as hp
from tenzing_tpu_torch.models import moe_pipeline as mp
from tenzing_tpu_torch.models.halo import HaloArgs
from tenzing_tpu_torch.models.ring_attention import RingAttnArgs, fixed_order
from tenzing_tpu_torch.ops import kernel_lib
from tenzing_tpu_torch.runtime import graphs
from tenzing_tpu_torch.runtime.executor import (
    CaptureError,
    StreamExecutor,
    buffers_from_numpy,
)
from tenzing_tpu_torch.solve.local import drive, phase_policy

SMOKE = dict(nq=2, lx=4, ly=4, lz=4, radius=1)


def _halo_orders(args):
    plat8 = Platform.make_n_lanes(8)
    choice_g = hp.build_graph(args, impl_choice=True, xfer_choice=True)
    return {
        "naive": hp.naive_order(args, plat8),
        "greedy-rdma-2l": hp.greedy_overlap_order(
            args, Platform.make_n_lanes(2), "rdma"),
        "alias-8l": drive(choice_g, plat8, phase_policy(
            plat8, hp.HALO_PHASES, halo_alias_prefer))[0],
    }


def _attn_chunked():
    a = RingAttnArgs(n_devices=4, batch=1, seq_local=16, head_dim=8)
    gc = attn_graph(a, chunk=True, chunk_relax=True)
    return fixed_order(gc, Platform.make_n_lanes(1),
                       kernel_of=lambda s: ".xla.chunked.c2")


MOE = mp.MoEPipeArgs(n_experts=4, tokens=32, d_model=8, d_ff=16, n_chunks=2)


def _moe_orders():
    _, _, cap = mp.make_pipe_buffers(MOE, seed=0, with_expected=False,
                                     staging="choice")
    return {k: v[0] for k, v in mp.fixed_orders(MOE, cap).items()}, cap


def _all_orders():
    out = {f"halo-{k}": (v, ()) for k, v in
           _halo_orders(HaloArgs(**SMOKE)).items()}
    out["attn-naive-c2"] = (_attn_chunked(), ())
    moe, _ = _moe_orders()
    host = mp.host_buffer_names(MOE, "choice")
    out.update({f"moe-{k}": (v, host) for k, v in moe.items()})
    return out


# (segments, segments with device work, host waits) at the default deferral
EXPECTED = {
    "halo-naive": (13, 13, 13),
    "halo-greedy-rdma-2l": (9, 4, 9),
    "halo-alias-8l": (13, 8, 13),
    "attn-naive-c2": (1, 1, 1),
    "moe-naive": (9, 9, 9),
    "moe-greedy-overlap": (9, 7, 9),
    "moe-greedy-bf16-rdma": (9, 7, 9),
    "moe-pallas-bf16-rdma": (9, 7, 9),
}


@pytest.mark.parametrize("label", sorted(EXPECTED))
def test_plan_segment_counts(label):
    order, host = _all_orders()[label]
    segs = graphs.plan_segments(order.vector(), host)
    want_n, want_dev, want_waits = EXPECTED[label]
    assert len(segs) == want_n
    assert sum(1 for s in segs if s.streams) == want_dev
    assert graphs.n_host_syncs(segs) == want_waits


@pytest.mark.parametrize("label", sorted(EXPECTED))
def test_plan_every_op_in_one_segment(label):
    order, host = _all_orders()[label]
    for defer in (True, False):
        segs = graphs.plan_segments(order.vector(), host, defer)
        got = [p for s in segs for p in s.positions]
        assert got == list(range(len(order)))
        # a segment ends at a host wait; only the last may end without one
        assert all(s.waits for s in segs[:-1])


def test_plan_halo_alias_waits_name_ops_and_events():
    """alias-8l: the packs on six lanes form one segment; each post waits
    (a flush) on its own pack's event only, and the awaits follow one by
    one, each naming its buffer."""
    order = _halo_orders(HaloArgs(**SMOKE))["alias-8l"]
    ops = order.vector()
    segs = graphs.plan_segments(ops)
    first = segs[0]
    assert {k for k, _ in first.streams} == {"lane"}
    assert len(first.streams) == 6
    flushes = [w for s in segs for w in s.waits if w.kind == "flush"]
    assert [len(w.what) for w in flushes[:6]] == [1] * 6
    for w in flushes[:6]:
        assert getattr(ops[w.at], "KIND", "") == "rdma_copy_start"
    awaits = [w for s in segs for w in s.waits if w.kind == "transfer"]
    assert [w.what[0] for w in awaits] == [ops[w.at].buf() for w in awaits]
    assert len(awaits) == 6


def test_deferred_event_sync_does_not_split_and_blocking_one_does():
    order = _attn_chunked()
    ops = order.vector()
    n_syncs = sum(1 for op in ops if getattr(op, "KIND", "") == "event_sync")
    assert n_syncs == 4
    deferred = graphs.plan_segments(ops)
    assert len(deferred) == 1
    assert [w.kind for w in deferred[0].waits] == ["flush"]
    blocking = graphs.plan_segments(ops, defer_host_syncs=False)
    assert len(blocking) == n_syncs + 1  # the finish after the last sync
    assert [w.kind for s in blocking for w in s.waits] == ["event"] * n_syncs
    for s in blocking:
        for w in s.waits:
            assert getattr(ops[w.at], "KIND", "") == "event_sync"
            assert w.at == s.positions[-1]


def test_plan_raises_on_await_without_post():
    from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer

    with pytest.raises(RuntimeError, match="no transfer in flight"):
        graphs.plan_segments([Start(), AwaitTransfer("await_x", "x"),
                              Finish()])


class _Write(DeviceOp):
    def __init__(self, name, buf):
        super().__init__(name)
        self._buf = buf

    def writes(self):
        return [self._buf]

    def apply(self, bufs, ctx):
        bufs[self._buf].fill_(1.0)


def test_await_with_nothing_in_flight_still_raises():
    """An await passes with nothing in flight only on a buffer a device op
    wrote since its last post (a synthesized exchange's destination,
    ``graphs.track_landed``), in the plan and in the executor alike; any
    other, or one posted since, still raises."""
    from tenzing_tpu_torch.core.sync_ops import EventRecord, EventSync
    from tenzing_tpu_torch.core.resources import Event
    from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer, HostFetchStart

    lane = Lane(0)
    landed = [Start(), _Write("w", "x").bind(lane),
              EventRecord(lane, Event(0)), EventSync(Event(0)),
              AwaitTransfer("await_x", "x"), Finish()]
    segs = graphs.plan_segments(landed)
    assert not [w for s in segs for w in s.waits if w.kind == "transfer"]
    ex = StreamExecutor(Platform.make_n_lanes(1),
                        {"x": torch.zeros(4), "h": torch.zeros(4)},
                        device="cpu")
    ex.run(Sequence(landed))
    for ops in ([Start(), AwaitTransfer("await_y", "x"), Finish()],
                [Start(), _Write("w", "x").bind(lane),
                 EventRecord(lane, Event(0)), EventSync(Event(0)),
                 HostFetchStart("f", "h", "x"), AwaitTransfer("a", "x"),
                 AwaitTransfer("again", "x"), Finish()]):
        with pytest.raises(RuntimeError, match="no transfer in flight"):
            graphs.plan_segments(ops)
        with pytest.raises(RuntimeError, match="no transfer in flight"):
            ex.run(Sequence(ops))


@pytest.mark.parametrize("defer", [True, False])
@pytest.mark.parametrize("label", ["naive", "alias-8l", "greedy-rdma-2l"])
def test_plan_host_waits_equal_executor_host_syncs(label, defer):
    """The plan's waits per run are the host blocks the executor counts
    (``RunContext.host_syncs``) running the same order on the CPU."""
    args = HaloArgs(**SMOKE)
    order = _halo_orders(args)[label]
    bufs, _ = hp.make_pipeline_buffers(args, seed=0, with_expected=False)
    ex = StreamExecutor(Platform.make_n_lanes(8),
                        buffers_from_numpy(bufs, "cpu"), device="cpu",
                        defer_host_syncs=defer)
    run_n = ex.prepare_n(order)
    before = ex.ctx.host_syncs
    run_n(2)
    segs = graphs.plan_segments(order.vector(), ex.host_names, defer)
    assert ex.ctx.host_syncs - before == 2 * graphs.n_host_syncs(segs)


def test_cpu_executor_provisions_without_capture():
    args = HaloArgs(**SMOKE)
    order = _halo_orders(args)["naive"]
    bufs, _ = hp.make_pipeline_buffers(args, seed=0, with_expected=False)
    ex = StreamExecutor(Platform.make_n_lanes(8),
                        buffers_from_numpy(bufs, "cpu"), device="cpu")
    assert ex.graphs is False
    assert not ex.is_compiled(order)
    assert ex.precompile(order) is True
    assert ex.is_compiled(order) and ex.precompile(order) is False
    assert ex.compile_count == 0 and ex.graph_stats()["schedules"] == 0


def test_launch_counts_recorded_under_capture_and_added_on_replay():
    counts = kernel_lib.LaunchCounts("test_graphs", {"k": 0})
    counts.hit("k")
    with kernel_lib.recording_launches() as tally:
        counts.hit("k", 2)
        seen = []
        t = threading.Thread(target=lambda: (counts.hit("k"),
                                             seen.append(counts["k"])))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    # the capturing thread's launches went to the tally; another thread's
    # counted as usual
    assert counts["k"] == 2 and seen == [2]
    assert dict(tally) == {("test_graphs", "k"): 2}
    kernel_lib.add_launches(tally, 3)
    assert counts["k"] == 8


def test_launch_counts_lose_no_update_under_threads():
    """Many threads counting at once (a background capture thread counts
    into its tally while the foreground's replays count globally): no
    update is lost."""
    import os
    import sys

    counts = kernel_lib.LaunchCounts("test_graphs_stress", {"k": 0})
    n_threads, n_hits = 2 * (os.cpu_count() or 4) + 2, 2000
    tallies = []

    def work(i):
        if i % 2:
            with kernel_lib.recording_launches() as tally:
                for _ in range(n_hits):
                    counts.hit("k")
            tallies.append(tally)
        else:
            for _ in range(n_hits):
                counts.hit("k")

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    n_global = (n_threads + 1) // 2
    assert counts["k"] == n_global * n_hits
    assert [dict(t) for t in tallies] == \
        [{("test_graphs_stress", "k"): n_hits}] * (n_threads // 2)
    for tally in tallies:
        kernel_lib.add_launches(tally)
    assert counts["k"] == n_threads * n_hits


class _Graph:
    """Stands in for a CUDA graph: records whether its owner thread was
    capturing when it was destroyed."""

    destroyed: list = []

    def __del__(self):
        _Graph.destroyed.append(graphs.capturing_here())


def _schedule():
    seg = graphs.CapturedSegment(graph=_Graph(), exec_handle=None,
                                 stream=None, waits=[])
    return graphs.CapturedSchedule([seg], [], Counter(), 0, 0)


@pytest.mark.parametrize("where", ["outside", "capturing", "nested",
                                   "other_thread"])
def test_schedule_freed_on_a_capturing_thread_is_released_after_capture(where):
    """A captured schedule finalized on a thread that is capturing (the
    garbage collector runs wherever Python allocates) keeps its graphs until
    that thread's last capture ends: destroying a graph mid-capture is not
    permitted and invalidates the capture.  Elsewhere it is freed at once."""
    _Graph.destroyed.clear()
    sched = _schedule()
    if where == "outside":
        del sched
        assert _Graph.destroyed == [False]
    elif where == "other_thread":
        with graphs.capturing():
            box = [sched]
            del sched
            worker = threading.Thread(target=box.clear)
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
        assert _Graph.destroyed == [False]
    else:
        with graphs.capturing():
            if where == "nested":
                with graphs.capturing():
                    del sched
                assert _Graph.destroyed == []  # still inside the outer one
            else:
                del sched
            assert _Graph.destroyed == []
            assert graphs._DEFERRED
        assert _Graph.destroyed == [False] and not graphs._DEFERRED


def test_op_streams():
    from tenzing_tpu_torch.core.resources import Event
    from tenzing_tpu_torch.core.sync_ops import (
        EventRecord,
        EventSync,
        LaneSync,
        LaneWait,
    )
    from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer, HostFetchStart

    assert graphs.op_streams(EventRecord(Lane(2), Event(0))) == {("lane", 2)}
    assert graphs.op_streams(LaneWait(Lane(1), Lane(3))) == {
        ("lane", 1), ("lane", 3)}
    assert graphs.op_streams(LaneSync(Lane(1))) == frozenset()
    assert graphs.op_streams(EventSync(Event(0))) == frozenset()
    assert graphs.op_streams(HostFetchStart("f", "h", "d")) == {
        ("channel", "d")}
    assert graphs.op_streams(AwaitTransfer("a", "d")) == frozenset()


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs are captured only on the "
                    "card)")
    return torch.device("cuda")


HALO_CARD = dict(nq=2, lx=64, ly=64, lz=128, radius=2)


def _pair(cuda_device, plat, bufs, host=()):
    tb = buffers_from_numpy(bufs, cuda_device, host)
    return (StreamExecutor(plat, tb, graphs=False),
            StreamExecutor(plat, tb, graphs=True))


def _launches():
    return {t: dict(c) for t, c in kernel_lib._TABLES.items()}


def _delta(a, b):
    return {(t, k): b[t][k] - a[t].get(k, 0) for t in b for k in b[t]
            if b[t][k] != a[t].get(k, 0)}


def _replay_vs_eager(eager, graph, order, n=3):
    """(run() outputs of both, init_bufs after n timed runs of both, the
    launches each counted over those runs)."""
    out_e, out_g = eager.run(order), graph.run(order)
    eager.prepare_n(order)
    graph.precompile(order)
    results = []
    for ex in (eager, graph):
        for name, t in ex.init_bufs.items():
            t.copy_(ex._initial[name])
        torch.cuda.synchronize()
        a = _launches()
        ex.prepare_n(order)(n)
        b = _launches()
        results.append(({k: v.clone() for k, v in ex.init_bufs.items()},
                        _delta(a, b)))
    return out_e, out_g, results


@pytest.mark.needs_cuda
@pytest.mark.parametrize("label", ["naive", "greedy-rdma-2l", "alias-8l"])
def test_cuda_halo_replay_equals_eager(cuda_device, label):
    args = HaloArgs(**HALO_CARD)
    order = _halo_orders(args)[label]
    bufs, want = hp.make_pipeline_buffers(args, seed=0, with_expected=True)
    eager, graph = _pair(cuda_device, Platform.make_n_lanes(8), bufs,
                         hp.host_buffer_names())
    out_e, out_g, ((st_e, l_e), (st_g, l_g)) = _replay_vs_eager(
        eager, graph, order)
    for k in out_e:
        assert torch.equal(out_e[k], out_g[k]), k
        assert torch.equal(st_e[k], st_g[k]), k
    assert np.array_equal(out_g["U"].cpu().numpy(), want)
    # every kernel counted under replay too (naive runs no kernel)
    assert l_e == l_g and bool(l_g) == (label != "naive")
    assert graph.is_compiled(order) and graph.compile_count == 1
    stats = graph.graph_stats()
    segs = graphs.plan_segments(order.vector(), graph.host_names)
    assert stats["graphs"] == sum(1 for s in segs if s.streams)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("m", [8192])
def test_cuda_spmv_replay_equals_eager(cuda_device, m):
    from tenzing_tpu_torch.bench.driver import DriverRequest, build_spmv
    from tenzing_tpu_torch.models.spmv import fixed_orders

    g, tb, _, _ = build_spmv(DriverRequest(workload="spmv", m=m),
                             cuda_device)
    plat = Platform.make_n_lanes(2)
    eager, graph = (StreamExecutor(plat, tb, graphs=False),
                    StreamExecutor(plat, tb, graphs=True))
    for label, order in fixed_orders(g).items():
        out_e, out_g, ((st_e, l_e), (st_g, l_g)) = _replay_vs_eager(
            eager, graph, order)
        for k in out_e:
            assert torch.equal(out_e[k], out_g[k]), (label, k)
            assert torch.equal(st_e[k], st_g[k]), (label, k)
        assert l_e == l_g, label


# the attention state against eager: the same kernels and PyTorch ops run,
# but PyTorch may pick other GEMM algorithms under capture
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.needs_cuda
def test_cuda_attn_replay_within_tolerance(cuda_device):
    from tenzing_tpu_torch.models.ring_attention import (
        fixed_orders,
        make_blocked_buffers,
    )

    a = RingAttnArgs(n_devices=4, batch=2, seq_local=256, head_dim=128)
    bufs, _ = make_blocked_buffers(a, seed=0, with_expected=False)
    eager, graph = _pair(cuda_device, Platform.make_n_lanes(2), bufs)
    orders = fixed_orders(attn_graph(a), a.n_devices)
    gc = attn_graph(a, chunk=True, chunk_relax=True)
    orders["naive-c2"] = fixed_order(gc, Platform.make_n_lanes(1),
                                     kernel_of=lambda s: ".xla.chunked.c2")
    for label, order in orders.items():
        out_e, out_g, ((st_e, l_e), (st_g, l_g)) = _replay_vs_eager(
            eager, graph, order)
        for k in out_e:
            torch.testing.assert_close(out_g[k], out_e[k], **ATTN_TOL,
                                       msg=f"{label} {k}")
        assert l_e == l_g, label


@pytest.mark.needs_cuda
def test_cuda_moe_replay_within_tolerance(cuda_device):
    m = mp.MoEPipeArgs(tokens=1024)
    bufs, _, cap = mp.make_pipe_buffers(m, seed=0, with_expected=False,
                                        staging="choice")
    eager, graph = _pair(cuda_device, Platform.make_n_lanes(2), bufs,
                         mp.host_buffer_names(m, "choice"))
    for label, (order, _) in mp.fixed_orders(m, cap).items():
        out_e, out_g, ((st_e, l_e), (st_g, l_g)) = _replay_vs_eager(
            eager, graph, order)
        torch.testing.assert_close(out_g["Y"], out_e["Y"], **MOE_TOL,
                                   msg=label)
        assert l_e == l_g, label


@pytest.mark.needs_cuda
def test_cuda_run_after_prepare_n(cuda_device):
    """``run()`` restores the buffers the timed runs left and replays the
    same graphs: its output is the single run's, not the n-th."""
    args = HaloArgs(**HALO_CARD)
    order = _halo_orders(args)["alias-8l"]
    bufs, want = hp.make_pipeline_buffers(args, seed=0, with_expected=True)
    tb = buffers_from_numpy(bufs, cuda_device, hp.host_buffer_names())
    ex = StreamExecutor(Platform.make_n_lanes(8), tb)
    ex.prepare_n(order)(5)
    n_before = ex.compile_count
    out = ex.run(order)
    assert ex.compile_count == n_before == 1
    assert np.array_equal(out["U"].cpu().numpy(), want)


@pytest.mark.needs_cuda
def test_cuda_background_capture_while_foreground_replays(cuda_device):
    args = HaloArgs(**HALO_CARD)
    orders = _halo_orders(args)
    bufs, want = hp.make_pipeline_buffers(args, seed=0, with_expected=True)
    tb = buffers_from_numpy(bufs, cuda_device, hp.host_buffer_names())
    ex = StreamExecutor(Platform.make_n_lanes(8), tb)
    fg = ex.prepare_n(orders["naive"])
    errors = []

    def bg():
        try:
            for label in ("alias-8l", "greedy-rdma-2l"):
                ex.precompile(orders[label])
        except BaseException as e:  # noqa: BLE001 - checked below
            errors.append(e)

    t = threading.Thread(target=bg)
    t.start()
    deadline = time.time() + 120
    while t.is_alive() and time.time() < deadline:
        fg(20)
    t.join(timeout=1)
    assert not t.is_alive() and not errors, errors
    assert ex.is_compiled(orders["alias-8l"])
    for label in ("alias-8l", "greedy-rdma-2l", "naive"):
        out = ex.run(orders[label])
        assert np.array_equal(out["U"].cpu().numpy(), want), label
    assert ex.compile_count == 3


class _SyncingOp(DeviceOp):
    """A device op that reads a value back to the host: legal when run,
    not under capture."""

    def __init__(self):
        super().__init__("readback")

    def reads(self):
        return ["x"]

    def writes(self):
        return ["x"]

    def apply(self, bufs, ctx):
        bufs["x"].add_(float(bufs["x"].sum().item()))


@pytest.mark.needs_cuda
def test_cuda_uncapturable_schedule_raises_naming_op(cuda_device):
    order = Sequence([Start(), _SyncingOp().bind(Lane(0)), Finish()])
    tb = {"x": torch.ones(4, device=cuda_device)}
    ex = StreamExecutor(Platform.make_n_lanes(1), tb)
    with pytest.raises(CaptureError, match="readback"):
        ex.precompile(order)
    assert not ex.is_compiled(order)
    # the same schedule runs without graphs, and the executor still works
    eager = StreamExecutor(Platform.make_n_lanes(1), tb, graphs=False)
    assert eager.run(order)["x"].tolist() == [5.0] * 4
    torch.cuda.synchronize()


_FRESH = r"""
import sys, threading
import numpy as np, torch
from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
from tenzing_tpu_torch.bench.pipeline import PrefetchingBenchmarker
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.models import halo_pipeline as hp
from tenzing_tpu_torch.models import moe_pipeline as mp
from tenzing_tpu_torch.models.halo import HaloArgs
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.bench.driver import halo_alias_prefer
from tenzing_tpu_torch.solve.local import drive, phase_policy

def first_use(ex, orders):
    p = PrefetchingBenchmarker(EmpiricalBenchmarker(ex), executor=ex)
    try:
        p.prefetch(orders)
        for o in orders:
            p.benchmark(o, BenchOpts(n_iters=2, target_secs=0.0005))
        assert p.hits == len(orders) and p.failed == 0, p.stats()
    finally:
        p.close()

args = HaloArgs(**%r)
bufs, want = hp.make_pipeline_buffers(args, seed=0, with_expected=True)
plat8 = Platform.make_n_lanes(8)
ex = StreamExecutor(plat8, buffers_from_numpy(
    bufs, "cuda", hp.host_buffer_names()))
order = drive(hp.build_graph(args, impl_choice=True, xfer_choice=True), plat8,
              phase_policy(plat8, hp.HALO_PHASES, halo_alias_prefer))[0]
first_use(ex, [order])
assert np.array_equal(ex.run(order)["U"].cpu().numpy(), want)
m = mp.MoEPipeArgs(tokens=1024)
mb, _, cap = mp.make_pipe_buffers(m, seed=0, with_expected=False,
                                  staging="choice")
mex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(
    mb, "cuda", mp.host_buffer_names(m, "choice")))
orders = mp.fixed_orders(m, cap)
first_use(mex, [orders[k][0] for k in ("pallas-bf16-rdma",
                                       "pallas-f32-rdma")])
print("FRESH-OK")
""" % (HALO_CARD,)


@pytest.mark.needs_cuda
def test_cuda_first_kernel_use_under_background_capture(cuda_device):
    """In a fresh process the first launch of each kernel (the library's
    load, each kernel's lazy load, ``cudaFuncSetAttribute``, cuBLAS's
    handle) happens inside a background capture of the prefetch pipeline:
    halo alias-8l (TMA unpacks, ``device_copy``) and the moe all-kernel
    orders (``ffn_batched``'s cluster launch), then a replay checked."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and "FRESH-OK" in out.stdout, \
        out.stderr[-3000:]
