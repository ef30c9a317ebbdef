"""The port's attribution layer (tenzing_tpu_torch/obs/attrib) against the
reference's (tenzing_tpu/obs/attrib).

The same schedules (one schedule JSON, read into each package's graph) with
the same synthetic durations give the same ``analyze`` and ``explain`` JSON
and the same per-lane Perfetto tracks, exactly: a halo naive order, a
greedy alias order (``.rdma`` posts grouped with their awaits), an attention
order and a moe order.  ``StreamExecutor.op_stepped`` cuts each into the
same units as the reference's ``TraceExecutor.op_stepped``.  On the CPU the
stepped timeline covers every position, and its units leave the buffers as
one run of the schedule does.  Mirrors ``tests/test_attrib.py:62-305``; its
report and regression tests are mirrored in ``test_torch_obs_report.py``."""

import json

import pytest

from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.obs import attrib as ref_attrib
from tenzing_tpu.obs.attrib.timeline import _record_meta as ref_record_meta
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_to_json
from tenzing_tpu_torch.obs import attrib
from tenzing_tpu_torch.obs.attrib.timeline import _record_meta
from tenzing_tpu_torch.runtime.executor import step_units

HALO = dict(nq=1, lx=4, ly=4, lz=4, radius=1)
MOE = dict(n_experts=4, tokens=32, d_model=8, d_ff=16, n_chunks=2)
ATTN = dict(n_devices=4, batch=1, seq_local=16, head_dim=8)


def _halo_graphs():
    from tenzing_tpu.models import halo as rh
    from tenzing_tpu.models import halo_pipeline as rp
    from tenzing_tpu_torch.models import halo_pipeline as pp
    from tenzing_tpu_torch.models.halo import HaloArgs

    g = pp.build_graph(HaloArgs(**HALO), impl_choice=True, xfer_choice=True)
    rg = rp.build_graph(rh.HaloArgs(**HALO), impl_choice=True, xfer_choice=True)
    return g, rg


def _halo_naive():
    from tenzing_tpu.models import halo as rh
    from tenzing_tpu.models import halo_pipeline as rp
    from tenzing_tpu_torch.models import halo_pipeline as pp
    from tenzing_tpu_torch.models.halo import HaloArgs

    seq = pp.naive_order(HaloArgs(**HALO), Platform.make_n_lanes(1))
    rg = rp.build_graph(rh.HaloArgs(**HALO))
    return seq, ref_from_json(sequence_to_json(seq), rg)


def _halo_alias():
    from tenzing_tpu_torch.bench.driver import halo_alias_prefer
    from tenzing_tpu_torch.models.halo_pipeline import HALO_PHASES
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    g, rg = _halo_graphs()
    plat = Platform.make_n_lanes(3)
    seq, _ = drive(g, plat, phase_policy(plat, HALO_PHASES, halo_alias_prefer))
    return seq, ref_from_json(sequence_to_json(seq), rg)


def _attn():
    from tenzing_tpu.core.graph import Graph as RefGraph
    from tenzing_tpu.models.ring_attention import BlockedAttention as RefBA
    from tenzing_tpu.models.ring_attention import RingAttnArgs as RefArgs
    from tenzing_tpu_torch.bench.driver import attn_graph
    from tenzing_tpu_torch.models.ring_attention import RingAttnArgs, fixed_order

    g = attn_graph(RingAttnArgs(**ATTN))
    rg = RefGraph()
    op = RefBA(RefArgs(**ATTN), impl_choice=True, fused_choice=True)
    rg.start_then(op)
    rg.then_finish(op)
    seq = fixed_order(g, Platform.make_n_lanes(2), lane_of=lambda s: s % 2)
    return seq, ref_from_json(sequence_to_json(seq), rg)


def _moe():
    from tenzing_tpu.models import moe_pipeline as rp
    from tenzing_tpu_torch.bench.driver import moe_bf16_prefer
    from tenzing_tpu_torch.models import moe_pipeline as pp
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    a = pp.MoEPipeArgs(**MOE)
    cap = pp.make_pipe_buffers(a, seed=0, with_expected=False)[2]
    g = pp.build_graph(a, cap, impl_choice=True, staging="choice")
    rg = rp.build_graph(rp.MoEPipeArgs(**MOE), cap, impl_choice=True,
                        staging="choice")
    plat = Platform.make_n_lanes(2)
    seq, _ = drive(g, plat, phase_policy(plat, pp.PHASES, moe_bf16_prefer))
    return seq, ref_from_json(sequence_to_json(seq), rg)


ORDERS = {"halo-naive": _halo_naive, "halo-alias": _halo_alias,
          "attn": _attn, "moe": _moe}


def _dur(p: int) -> float:
    return 1.0 + (p * 7919) % 23 + 0.25 * (p % 3)


def _timelines(seq, rseq):
    """The same synthetic timeline in each package: one record per unit of
    ``step_units`` (asserted equal to the reference's units), durations by
    the unit's first position."""
    ops, rops = seq.vector(), rseq.vector()
    tl = attrib.OpTimeline(schedule="s", source="synthetic", n_ops=len(ops))
    rtl = ref_attrib.OpTimeline(schedule="s", source="synthetic",
                                n_ops=len(rops))
    for positions in step_units(ops):
        name, desc, kind, lane = _record_meta(ops, positions)
        rname, rdesc, rkind, rlane = ref_record_meta(rops, positions)
        assert (name, desc, kind, lane) == (rname, rdesc, rkind, rlane)
        dur = 0.0 if kind == "sync" else _dur(positions[0])
        tl.records.append(attrib.OpRecord(name, desc, kind, lane, positions,
                                          dur_us=dur))
        rtl.records.append(ref_attrib.OpRecord(rname, rdesc, rkind, rlane,
                                               positions, dur_us=dur))
    return tl, rtl


def _ref_units(rseq, label):
    """The reference's ``TraceExecutor.op_stepped`` unit positions."""
    import jax.numpy as jnp

    from tenzing_tpu.core.platform import Platform as RefPlatform
    from tenzing_tpu.runtime.executor import TraceExecutor

    names = set()
    for op in rseq.vector():
        names.update(getattr(op, "reads", lambda: [])())
        names.update(getattr(op, "writes", lambda: [])())
    ex = TraceExecutor(RefPlatform.make_n_lanes(3),
                       {n: jnp.zeros((1,)) for n in names})
    return [positions for positions, _ in ex.op_stepped(rseq)]


@pytest.fixture(scope="module")
def orders():
    return {k: fn() for k, fn in ORDERS.items()}


@pytest.mark.parametrize("label", list(ORDERS))
def test_op_stepped_units_equal_reference(orders, label):
    seq, rseq = orders[label]
    units = step_units(seq.vector())
    assert units == _ref_units(rseq, label)
    assert sorted(p for u in units for p in u) == list(range(len(seq)))
    if label == "halo-alias":  # the .rdma posts grouped through their awaits
        grouped = [u for u in units if len(u) > 1]
        assert grouped
        for u in grouped:
            names = [seq.vector()[p].name() for p in u]
            assert names[0].endswith(".rdma")
            assert names[-1].startswith("await_")
        posts = {p for p, op in enumerate(seq.vector())
                 if op.name().endswith(".rdma")}
        assert len(posts) == 6
        assert posts <= {p for u in grouped for p in u}


@pytest.mark.parametrize("label", list(ORDERS))
@pytest.mark.parametrize("measured", [None, 40.0, 400.0])
def test_analyze_equals_reference(orders, label, measured):
    from tenzing_tpu.bench.roofline import Cost as RefCost
    from tenzing_tpu_torch.bench.roofline import Cost

    seq, rseq = orders[label]
    tl, rtl = _timelines(seq, rseq)
    at = attrib.analyze(seq.vector(), tl, measured_us=measured)
    rat = ref_attrib.analyze(rseq.vector(), rtl, measured_us=measured)
    assert at.to_json() == rat.to_json()
    assert at.sum_of_parts_us >= at.critical_path_us - 1e-9 > 0
    # the roofline joins: the same rates, against each package's own peaks
    unit = tl.records[1].name
    at = attrib.analyze(seq.vector(), tl, measured_us=measured,
                        cost=Cost(3e9, 5e6, 1e6),
                        per_op_costs={unit: Cost(1e6, 2e3)})
    rat = ref_attrib.analyze(rseq.vector(), rtl, measured_us=measured,
                             cost=RefCost(3e9, 5e6, 1e6),
                             per_op_costs={unit: RefCost(1e6, 2e3)})
    pairs = [(at.utilization, rat.utilization)]
    pairs += [(at.per_op_utilization[k], rat.per_op_utilization[k])
              for k in rat.per_op_utilization]
    for u, ru in pairs:
        for k in ("seconds", "tflops", "hbm_gbs", "xfer_gbs"):
            assert u.get(k) == ru.get(k)
        assert u["hbm_frac"] > 0


@pytest.mark.parametrize("winner", ["halo-alias"])
def test_explain_and_tracks_equal_reference(orders, winner):
    from tenzing_tpu.obs.export import chrome_trace as ref_chrome
    from tenzing_tpu.obs.tracer import Tracer as RefTracer
    from tenzing_tpu_torch.obs.export import chrome_trace
    from tenzing_tpu_torch.obs.tracer import Tracer

    n, rn = orders["halo-naive"]
    w, rw = orders[winner]
    ntl, rntl = _timelines(n, rn)
    wtl, rwtl = _timelines(w, rw)
    n_at = attrib.analyze(n.vector(), ntl, measured_us=300.0)
    w_at = attrib.analyze(w.vector(), wtl, measured_us=90.0)
    rn_at = ref_attrib.analyze(rn.vector(), rntl, measured_us=300.0)
    rw_at = ref_attrib.analyze(rw.vector(), rwtl, measured_us=90.0)
    doc = attrib.explain(n.vector(), w.vector(), naive_attrib=n_at,
                         winner_attrib=w_at)
    rdoc = ref_attrib.explain(rn.vector(), rw.vector(), naive_attrib=rn_at,
                              winner_attrib=rw_at)
    assert json.loads(json.dumps(doc)) == json.loads(json.dumps(rdoc))
    t = doc["timing"]
    assert t["naive_hidden_us"] + t["faster_parts_us"] + t["winner_hidden_us"] \
        == pytest.approx(t["delta_us"])
    assert attrib.diff_schedules(n.vector(), w.vector()) == \
        ref_attrib.diff_schedules(rn.vector(), rw.vector())
    for at, rat, kw in ((w_at, rw_at, dict(label="attrib/winner")),
                        (n_at, rn_at, dict(label="attrib/naive",
                                           tid_base=2000))):
        evs = attrib.timeline_trace_events(at, pid=0, t0_us=5.0, **kw)
        assert evs == ref_attrib.timeline_trace_events(rat, pid=0, t0_us=5.0,
                                                       **kw)
    # through each package's chrome-trace sink: the same per-lane rows
    evs = attrib.timeline_trace_events(w_at, label="attrib/winner")
    mine = chrome_trace(Tracer(enabled=True), extra_events=evs)
    ref = ref_chrome(RefTracer(enabled=True), extra_events=evs)
    assert mine == ref


@pytest.mark.parametrize("label", ["moe", "attn"])
def test_hidden_comm_measured_equals_reference(label):
    """A chunked order's comm hidden under its partials, on the same
    synthetic Gantt in both packages."""
    from tenzing_tpu.core.chunking import hidden_comm_measured_us as ref_hidden
    from tenzing_tpu_torch.core.chunking import chunks_of, hidden_comm_measured_us
    from tenzing_tpu_torch.core.state import ChooseOp, State

    if label == "moe":
        from tenzing_tpu.models import moe_pipeline as rp
        from tenzing_tpu_torch.models import moe_pipeline as pp

        a = pp.MoEPipeArgs(**MOE)
        cap = pp.make_pipe_buffers(a, seed=0, with_expected=False)[2]
        g = pp.build_graph(a, cap, chunk=True, chunk_relax=True)
        rg = rp.build_graph(rp.MoEPipeArgs(**MOE), cap, chunk=True,
                            chunk_relax=True)
    else:
        from tenzing_tpu.core.graph import Graph as RefGraph
        from tenzing_tpu.models.ring_attention import BlockedAttention as RefBA
        from tenzing_tpu.models.ring_attention import RingAttnArgs as RefArgs
        from tenzing_tpu_torch.bench.driver import attn_graph
        from tenzing_tpu_torch.models.ring_attention import RingAttnArgs

        g = attn_graph(RingAttnArgs(**ATTN), chunk=True, chunk_relax=True)
        rg = RefGraph()
        op = RefBA(RefArgs(**ATTN), impl_choice=True, fused_choice=True,
                   chunk=True, chunk_relax=True)
        rg.start_then(op)
        rg.then_finish(op)
    plat = Platform.make_n_lanes(2)
    st, i = State(g), 0
    while not st.is_terminal():  # the fold chain, and the last alternative
        ds = st.get_decisions(plat)  # (the largest chunk count) elsewhere
        chooses = [d for d in ds if isinstance(d, ChooseOp)]
        pick = [d for d in chooses if d.choice.name().endswith(".chain")]
        st = st.apply((pick or chooses)[-1] if chooses else ds[i % len(ds)])
        i += 1
    seq = st.sequence
    assert chunks_of(seq.vector())
    rseq = ref_from_json(sequence_to_json(seq), rg)
    tl, rtl = _timelines(seq, rseq)
    at = attrib.analyze(seq.vector(), tl, measured_us=100.0)
    rat = ref_attrib.analyze(rseq.vector(), rtl, measured_us=100.0)
    got = hidden_comm_measured_us(seq.vector(), at)
    assert got == ref_hidden(rseq.vector(), rat)
    if label == "moe":
        assert got > 0


def _cpu_executor(label):
    """A CPU stream executor and a schedule of the workload."""
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

    if label == "halo-alias":
        from tenzing_tpu_torch.models import halo_pipeline as pp
        from tenzing_tpu_torch.models.halo import HaloArgs

        bufs, _ = pp.make_pipeline_buffers(HaloArgs(**HALO), seed=0,
                                           with_expected=False)
        host = pp.host_buffer_names()
        seq = _halo_alias()[0]
    else:
        from tenzing_tpu_torch.models.ring_attention import (
            RingAttnArgs,
            make_blocked_buffers,
        )

        bufs, _ = make_blocked_buffers(RingAttnArgs(**ATTN), seed=0,
                                       with_expected=False)
        host = ()
        seq = _attn()[0]
    ex = StreamExecutor(Platform.make_n_lanes(3),
                        buffers_from_numpy(bufs, "cpu", host), device="cpu")
    return ex, seq


@pytest.mark.parametrize("label", ["halo-alias", "attn"])
def test_stepped_timeline_on_cpu(label):
    """Every position is covered once, sync records are zero, timed units
    are positive and host-timed on the CPU; the units, each repeated from
    the same state, leave the buffers as one run of the schedule does
    (attention's folds accumulate in place)."""
    import torch

    ex, seq = _cpu_executor(label)
    tl = attrib.stepped_timeline(ex, seq, repeats=3)
    assert sorted(p for r in tl.records for p in r.positions) == \
        list(range(len(seq)))
    assert [r.positions for r in tl.records] == step_units(seq.vector())
    for r in tl.records:
        if r.kind == "sync":
            assert r.dur_us == 0.0 and r.timer is None
        else:
            assert r.dur_us > 0.0 and r.timer == "host"
    stepped = dict(ex.ctx.bufs)
    want = ex.run(seq)
    for name, t in want.items():
        assert torch.equal(stepped[name], t), name
    at = attrib.analyze(seq.vector(), tl, measured_us=50.0)
    assert at.sum_of_parts_us >= at.critical_path_us - 1e-9 > 0
    back = attrib.OpTimeline.from_json(json.loads(json.dumps(tl.to_json())))
    assert [r.timer for r in back.records] == [r.timer for r in tl.records]


def test_stepped_rejects_mesh_platforms():
    ex, seq = _cpu_executor("attn")

    class FakeMeshPlat:
        mesh = object()

    ex.platform = FakeMeshPlat()
    with pytest.raises(RuntimeError, match="single-device"):
        ex.op_stepped(seq)


def test_xplane_merge_intervals_equals_reference():
    from tenzing_tpu.obs.attrib.xplane import merge_intervals as ref_merge

    ivs = [(5, 9), (1, 3), (2, 4), (9, 12), (20, 21), (0, 1)]
    assert attrib.merge_intervals(ivs) == ref_merge(ivs)


@pytest.mark.parametrize("fused", [False, True])
def test_breakdown_attrib_of(fused):
    """``bench/breakdown.py --profile``'s attribution of a fixed order: a
    fused order is stepped a region a unit on the executor under it."""
    from tenzing_tpu_torch.bench.breakdown import attrib_of
    from tenzing_tpu_torch.runtime.fused import FusedExecutor

    ex, seq = _cpu_executor("attn")
    runner = FusedExecutor(ex, tiles=1) if fused else ex
    row = attrib_of(runner, seq, 1e5)
    want = len(step_units(runner.fused_order(seq).vector() if fused
                          else seq.vector()))
    assert row["timers"]["host"] == row["n_timed"] <= want
    assert row["sum_of_parts_us"] >= row["critical_path_us"] > 0
    assert row["dispatch_overhead_us"] == 0.0  # the wall given is far above
    assert 0 < row["overlap_efficiency"] <= 1.0
