"""The synthesized collectives of the port (tenzing_tpu_torch/collectives/,
the models' ``synth=True`` paths, ``bench/roofline.prune_sketches``)
against the JAX package's (tenzing_tpu/collectives/; reference tests
test_collectives.py), class for class:

* **topology** — links, costs and hop counts; the port priced with the
  reference's ``ModelEnv`` gives the reference's links;
* **protocol** — directive names and JSON, ``synths_of``, the menu info,
  the featurizer's marker literals;
* **prune** — the goldens, and the kept sets, estimates and reasons of
  every model's plans equal the reference's under the reference's
  constants;
* **step ops and plans** — the in-place step ops against the reference's
  ``apply`` on the same arrays; each plan's census, chains and staging
  equal the reference's;
* **graphs** — the four models' synthesized graphs have the reference's op
  names and edges (every compound and alternative), the verifier and the
  original synchronizer certify both projections, the verifier fuzz finds
  no false positive, DFS / the hill-climb / MCTS each visit two or more
  sketch labels; every ``make_*_buffers(synth=True)`` is the reference's
  bit for bit;
* **executed numerics** — over gloo at 2 and 4 ranks the same schedule
  JSONs run through the reference's ``TraceExecutor`` on its CPU mesh and
  through the port's ranks: the TP all-reduce's ``.fixed``, ``ring.c1``,
  ``ring.c2``, ``ringr.c1`` and ``rhd.c1`` within ``PARITY_TOL`` of the
  reference and ``rtol=2e-4, atol=2e-5`` of float64; the MoE ring
  all-to-all bit-identical to the fixed one; the halo ``neighbor.c2``
  bit-identical to the fixed shift on (2,1,1) and (2,2,1); the SpMV pipe
  c2 and c4 bit-identical to the fixed round trip on one rank; the dryrun's
  ``tp_mlp_synth`` stage;
* **the card** (``needs_cuda``) — the pipe schedules bit-identical to the
  fixed exchange through the stream executor with graphs, ``ell_spmv``
  launched under them.
"""

import random
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tenzing_tpu.bench import roofline as ref_roofline
from tenzing_tpu.bench.model import ModelEnv as RefModelEnv
from tenzing_tpu.collectives import synth as ref_synth
from tenzing_tpu.collectives import topology as ref_topo
from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.models import halo as ref_halo
from tenzing_tpu.models import moe as ref_moe
from tenzing_tpu.models import spmv as ref_spmv
from tenzing_tpu.models import tp_mlp as ref_tp
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu_torch.bench import roofline
from tenzing_tpu_torch.bench.benchmarker import BenchOpts
from tenzing_tpu_torch.bench.model import AnalyticBenchmarker, ModelEnv
from tenzing_tpu_torch.collectives import synth as port_synth
from tenzing_tpu_torch.collectives.synth import (
    COLLECTIVES,
    SKETCHES,
    SYNTH_MARK,
    AddInto,
    ConcatPieces,
    PlaceSlice,
    RowPick,
    RowPlace,
    SlicePick,
    StaticSlice,
    SynthDirective,
    plan_host_pipe,
    plan_neighbor_shift,
    plan_rhd_all_reduce,
    plan_ring_all_reduce,
    plan_ring_all_to_all,
    sketch_cost_us,
    sketch_menu,
    synth_hidden_comm_measured_us,
    synth_menu_info,
    synth_menus,
    synths_of,
)
from tenzing_tpu_torch.collectives.topology import (
    host_topology,
    mesh_topology,
    ring_topology,
)
from tenzing_tpu_torch.core.event_synchronizer import EventSynchronizer
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Mesh, MeshAxis, Platform
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.core.state import State
from tenzing_tpu_torch.core.sync_ops import SyncOp
from tenzing_tpu_torch.models import halo, moe, spmv, tp_mlp
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.parallel.launch import launch
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.verify import ScheduleVerifier

SEED = 0
TIMEOUT_S = 120.0
# the port and the reference sum the same float32 products in different
# orders (BLAS blocking): tests/test_torch_tp_mlp.py's limit
PARITY_TOL = dict(rtol=1e-5, atol=1e-6)
TP = tp_mlp.TpMlpArgs(n_tp=4, n_layers=1, n_chunks=1, mb_size=2, d_model=8,
                      d_ff=16)
HALO = halo.HaloArgs(nq=2, lx=4, ly=4, lz=4, radius=1)
MOE = moe.MoEArgs(n_ep=4, tokens_per_shard=8, d_model=8, d_ff=16, n_chunks=2)
# the reference's machine constants, priced with the port's functions
REF_ENV = ModelEnv(**asdict(RefModelEnv()))
REF_DISPATCH_US = ref_roofline.CHUNK_DISPATCH_US


def _wrap(comp, g):
    g.start_then(comp)
    g.then_finish(comp)
    return g


def _tp_graph(args=TP, ref=False, relax=True):
    m = ref_tp if ref else tp_mlp
    a = m.TpMlpArgs(**asdict(args))
    return _wrap(m.TpMlp(a, synth=True, synth_relax=relax),
                 RefGraph() if ref else Graph())


def _spmv_graph(n_rem=8, ref=False):
    m = ref_spmv if ref else spmv

    def mk():
        return m.SpMVCompound(x_sizes={"x_remote": n_rem}, exchange="host",
                              synth=True, synth_relax=True)
    g = RefGraph() if ref else Graph()
    g.start_then(mk())
    g.then_finish(mk())
    return g


def _halo_graph(args=HALO, ref=False):
    if ref:
        return ref_halo.add_to_graph(RefGraph(), ref_halo.HaloArgs(**asdict(args)),
                                     synth=True, synth_relax=True)
    return halo.add_to_graph(Graph(), args, synth=True, synth_relax=True)


def _moe_graph(args=MOE, ref=False):
    m = ref_moe if ref else moe
    return _wrap(m.MoELayer(m.MoEArgs(**asdict(args)), synth=True,
                            synth_relax=True), RefGraph() if ref else Graph())


def _drive(g, plat, want_suffix=None):
    """First-decision serialization, taking the choice alternatives whose
    name ends with ``want_suffix`` (the reference test's ``_drive``)."""
    st = State(g)
    while not st.is_terminal():
        ds = st.get_decisions(plat)
        pick = None
        if want_suffix is not None:
            pick = next((d for d in ds
                         if getattr(d, "choice", None) is not None
                         and d.choice.name().endswith(want_suffix)), None)
        st = st.apply(pick or ds[0])
    return st


def synth_sound(graph, seq) -> bool:
    """The original synchronizer's judgment of a complete sequence: every
    non-sync op synced against the prefix before it."""
    ops = seq.vector()
    for i, op in enumerate(ops):
        if isinstance(op, SyncOp):
            continue
        if not EventSynchronizer.is_synced(graph, Sequence(ops[:i]), op):
            return False
    return True


def _deep_shape(g):
    """Every (graph, vertices, edges) reachable through compound sub-graphs
    and choice alternatives, by name."""
    out, seen = set(), {}

    def graph_shape(gr, label):
        names = tuple(sorted(v.name() for v in gr.vertices()))
        edges = tuple(sorted((a.name(), b.name()) for a in gr.vertices()
                             for b in gr.succs(a)))
        out.add((label, names, edges))
        for v in gr.vertices():
            visit(v)

    def visit(op):
        if op.name() in seen:
            return
        seen[op.name()] = op
        choices = getattr(op, "choices", None)
        if callable(getattr(op, "graph", None)) and not callable(choices):
            graph_shape(op.graph(), op.name())
        if callable(choices):
            out.add((op.name(), tuple(c.name() for c in op.choices()), ()))
            for c in op.choices():
                visit(c)

    graph_shape(g, "<top>")
    return out


def _menus_view(menus):
    return {b: (m["collective"], m["menu"]) for b, m in menus.items()}


# -- topology ------------------------------------------------------------------


class TestTopology:
    def test_ring_links_bidirectional(self):
        t = ring_topology("tp", 4)
        assert len(t.links) == 8
        assert t.link("tp0", "tp1").engine == "ici"
        assert t.link("tp3", "tp0") is not None
        assert t.link("tp0", "tp2") is None

    def test_link_cost_alpha_beta(self):
        lk = ring_topology("tp", 2).link("tp0", "tp1")
        assert lk.cost_us(0) == pytest.approx(lk.alpha_us)
        assert lk.cost_us(1 << 20) > lk.cost_us(1 << 10) > lk.cost_us(0)

    def test_host_topology_pcie(self):
        t = host_topology()
        assert t.link("d0", "host").engine == "pcie"
        assert t.link("host", "d0").engine == "pcie"

    def test_mesh_topology_merges_axes(self):
        t = mesh_topology({"x": 2, "y": 2}, host=False)
        assert t.link("x0", "x1") is not None and t.link("y0", "y1") is not None
        assert "pcie" not in t.engines()
        assert "pcie" in mesh_topology({"x": 2}, host=True).engines()

    def test_min_hops_on_ring(self):
        t = ring_topology("tp", 4)
        assert t.min_hops("tp0", "tp1") == 1
        assert t.min_hops("tp0", "tp2") == 2

    @pytest.mark.parametrize("axes,host", [({"tp": 4}, False),
                                           ({"x": 2, "y": 3}, True),
                                           ({"ep": 1}, True)])
    def test_links_equal_reference_under_its_env(self, axes, host):
        port = mesh_topology(axes, host=host, env=REF_ENV)
        ref = ref_topo.mesh_topology(axes, host=host)
        assert [asdict(lk) for lk in port.links] == [
            asdict(lk) for lk in ref.links]
        assert port.nodes() == ref.nodes()

    def test_default_links_are_the_cards(self):
        """The default prices are the card's ModelEnv, not the TPU's."""
        lk = ring_topology("tp", 2).link("tp0", "tp1")
        env = ModelEnv()
        assert lk.alpha_us == pytest.approx(env.ici_lat * 1e6)
        assert lk.alpha_us == pytest.approx(roofline.CHUNK_DISPATCH_US)
        assert lk.beta_us_per_byte == pytest.approx(1e6 / env.ici_bw)
        pc = host_topology().link("d0", "host")
        assert pc.beta_us_per_byte == pytest.approx(
            1e6 / (roofline.XFER_GBS * 1e9))


# -- protocol and serdes ---------------------------------------------------------


class TestProtocol:
    def test_marker_literals_agree_with_featurizer(self):
        from tenzing_tpu_torch.learn.features import _SYNTH_MARK, _SYNTH_SKETCHES

        assert _SYNTH_MARK == SYNTH_MARK == ref_synth.SYNTH_MARK
        assert _SYNTH_SKETCHES == SKETCHES == ref_synth.SKETCHES
        assert COLLECTIVES == ref_synth.COLLECTIVES

    def test_directive_name_and_roundtrip(self):
        d = SynthDirective("psum_0_0", "ring", 2)
        assert d.name() == "psum_0_0.synth.ring.c2"
        assert d.to_json() == ref_synth.SynthDirective(
            "psum_0_0", "ring", 2).to_json()
        d2 = SynthDirective.from_json(d.to_json())
        assert (d2.base(), d2.sketch(), d2.chunks()) == ("psum_0_0", "ring", 2)

    def test_directive_rejects_unknown_sketch(self):
        with pytest.raises(ValueError, match="sketch"):
            SynthDirective("a", "butterfly", 2)

    def test_synths_of_parses_ops_and_strings(self):
        items = [SynthDirective("x_exchange", "pipe", 4),
                 "psum_0_0.synth.ring.c2", "mlp_0_0", "start"]
        got = synths_of(items)
        assert got == {"x_exchange": {"sketch": "pipe", "chunks": 4},
                       "psum_0_0": {"sketch": "ring", "chunks": 2}}
        assert got == ref_synth.synths_of(
            [ref_synth.SynthDirective("x_exchange", "pipe", 4)] + items[1:])

    def test_synths_of_ignores_malformed(self):
        bad = ["a.synth.ring", "a.synth.butterfly.c2", "a.synth.ring.cX"]
        assert synths_of(bad) == {} == ref_synth.synths_of(bad)

    def test_menu_info_leads_with_fixed_and_note_nonempty(self):
        args = ("b", "all_reduce", ["ring.c1"], {"ring.c1": 2.0}, {}, 5.0, "")
        m = synth_menu_info(*args)
        assert m == ref_synth.synth_menu_info(*args)
        assert m["menu"][0] == "fixed" and m["note"]
        assert sketch_menu([], host_topology(), fixed_bytes=0.0)[1]["note"]

    def test_sketch_menu_relax_keeps_all_and_explains(self):
        plans = [plan_ring_all_reduce("b", "s", "d", "tp", 4, (2, 8), k)
                 for k in (1, 2)]
        variants, menu = sketch_menu(plans, mesh_topology({"tp": 4}, host=False),
                                     fixed_bytes=128.0, relax=True,
                                     collective="all_reduce")
        assert len(variants) == 2
        assert menu["menu"] == ["fixed", "ring.c1", "ring.c2"]
        assert "relax" in menu["note"]
        assert set(menu["est_us"]) == {"ring.c1", "ring.c2"}
        assert [v.name() for v in variants] == ["b.synthed.ring.c1",
                                                "b.synthed.ring.c2"]
        assert variants[0].to_json() == ref_synth.SynthCollectiveOp(
            ref_synth.plan_ring_all_reduce("b", "s", "d", "tp", 4, (2, 8),
                                           1)).to_json()

    def test_sketch_cost_prices_every_hop(self):
        p1 = plan_ring_all_reduce("b", "s", "d", "tp", 4, (2, 8), 1)
        p2 = plan_ring_all_reduce("b", "s", "d", "tp", 4, (2, 8), 2)
        topo = mesh_topology({"tp": 4}, host=False)
        assert p2.n_xfers == 2 * p1.n_xfers
        assert sketch_cost_us(p2, topo) > sketch_cost_us(p1, topo) > 0
        rtopo = ref_topo.mesh_topology({"tp": 4}, host=False)
        rp2 = ref_synth.plan_ring_all_reduce("b", "s", "d", "tp", 4, (2, 8), 2)
        assert sketch_cost_us(p2, mesh_topology({"tp": 4}, host=False,
                                                env=REF_ENV)) == \
            ref_synth.sketch_cost_us(rp2, rtopo)


# -- the roofline prune ----------------------------------------------------------


def _model_plan_sets():
    """(label, port plans, reference plans, topology axes or "host", fixed
    bytes, collective) of every model's sites at the dryrun's and the
    card's widths."""
    out = []
    for n_rem in (8, 3, 18_750, 1_024):
        out.append((f"spmv{n_rem}", spmv.spmv_synth_plans(n_rem),
                    ref_spmv.spmv_synth_plans(n_rem), "host",
                    2.0 * 4 * n_rem, "exchange"))
    for n_tp, mb, d in ((2, 2, 8), (4, 2, 8), (8, 2048, 512)):
        a = tp_mlp.TpMlpArgs(n_tp=n_tp, n_layers=1, n_chunks=1, mb_size=mb,
                             d_model=d, d_ff=16 * n_tp)
        out.append((f"tp{n_tp}", tp_mlp.tp_mlp_synth_plans(a, 0, 0),
                    ref_tp.tp_mlp_synth_plans(ref_tp.TpMlpArgs(**asdict(a)),
                                              0, 0),
                    {"tp": n_tp}, 2.0 * mb * d * 4, "all_reduce"))
    for hargs in (HALO, halo.HaloArgs(nq=2, lx=512, ly=512, lz=512, radius=3)):
        for d in halo.DIRECTIONS[::2]:
            sizes = halo._face_slices(hargs, d, "pack")[1]
            out.append((f"halo{hargs.lx}{d}", halo.halo_synth_plans(hargs, d),
                        ref_halo.halo_synth_plans(
                            ref_halo.HaloArgs(**asdict(hargs)), d),
                        {halo._dir_axis_sign(d)[0]: 2},
                        float(np.prod(sizes)) * 4, "shift"))
    for n_ep, t, dm in ((2, 8, 8), (4, 8, 8), (8, 8192, 512)):
        a = moe.MoEArgs(n_ep=n_ep, tokens_per_shard=t, d_model=dm,
                        d_ff=4 * dm, n_chunks=4 if t > 8 else 2)
        out.append((f"moe{n_ep}", moe.moe_synth_plans(a, 0, "disp"),
                    ref_moe.moe_synth_plans(ref_moe.MoEArgs(**asdict(a)), 0,
                                            "disp"),
                    {"ep": n_ep}, float(n_ep * a.chunk_tokens * dm * 4),
                    "all_to_all"))
    return out


PLAN_SETS = _model_plan_sets()


class TestPruneSketches:
    def test_keeps_only_below_floor(self):
        cands = {"ring.c1": {"est_us": 10.0, "steps": 1, "chunks": 1},
                 "rhd.c1": {"est_us": 40.0, "steps": 1, "chunks": 1}}
        kept, pruned = roofline.prune_sketches(cands, fixed_floor_us=20.0,
                                               dispatch_us=0.0)
        assert kept == ["ring.c1"]
        assert "rhd.c1" in pruned and "floor" in pruned["rhd.c1"]

    def test_extra_posts_pay_dispatch(self):
        cands = {"ring.c1": {"est_us": 10.0, "steps": 3, "chunks": 1}}
        kept, pruned = roofline.prune_sketches(cands, fixed_floor_us=20.0,
                                               dispatch_us=25.0)
        assert not kept and "dispatch" in pruned["ring.c1"]

    def test_overlap_credit_capped_by_head_chunk(self):
        cands = {"pipe.c2": {"est_us": 30.0, "steps": 1, "chunks": 2}}
        kept, _ = roofline.prune_sketches(cands, fixed_floor_us=16.0,
                                          overlap_us=1e9, dispatch_us=0.0)
        assert kept == ["pipe.c2"]
        kept2, _ = roofline.prune_sketches(cands, fixed_floor_us=14.0,
                                           overlap_us=1e9, dispatch_us=0.0)
        assert not kept2

    def test_rule_equals_reference_on_random_candidates(self):
        rng = random.Random(3)
        for _ in range(50):
            cands = {f"s.c{i}": {"est_us": rng.uniform(0, 200),
                                 "steps": rng.randint(1, 9),
                                 "chunks": rng.randint(1, 4)}
                     for i in range(4)}
            floor, ov = rng.uniform(0, 150), rng.choice([0.0, 30.0, 1e9])
            d = rng.choice([0.0, 25.0, 25.1])
            assert roofline.prune_sketches(cands, floor, ov, d) == \
                ref_roofline.prune_sketches(cands, floor, ov, d)

    def test_default_dispatch_is_the_cards(self):
        cands = {"x.c1": {"est_us": 0.0, "steps": 2, "chunks": 1}}
        _, pruned = roofline.prune_sketches(cands, fixed_floor_us=25.05)
        assert "@ 25" in pruned["x.c1"]
        assert roofline.prune_sketches(cands, fixed_floor_us=25.2)[0] == [
            "x.c1"]  # 25.1 < 25.2: the card's 25.1, not the TPU's 25.0

    @pytest.mark.parametrize("label,plans,rplans,axes,fixed,coll", PLAN_SETS,
                             ids=[p[0] for p in PLAN_SETS])
    def test_model_menus_equal_reference_under_its_constants(
            self, label, plans, rplans, axes, fixed, coll, monkeypatch):
        if axes == "host":
            topo, rtopo = host_topology(env=REF_ENV), ref_topo.host_topology()
        else:
            topo = mesh_topology(axes, host=False, env=REF_ENV)
            rtopo = ref_topo.mesh_topology(axes, host=False)
        monkeypatch.setattr(roofline, "CHUNK_DISPATCH_US", REF_DISPATCH_US)
        for relax in (False, True):
            got = sketch_menu(plans, topo, fixed_bytes=fixed, relax=relax,
                              collective=coll)
            want = ref_synth.sketch_menu(rplans, rtopo, fixed_bytes=fixed,
                                         relax=relax, collective=coll)
            assert got[1] == want[1], label
            assert [v.name() for v in got[0]] == [v.name() for v in want[0]]


# -- the step ops ----------------------------------------------------------------


class _Ctx:
    def __init__(self, index=0, size=1, axis="ep"):
        self.mesh = Mesh({axis: MeshAxis(size=size, index=index)})


def _port_apply(op, bufs, ctx=None):
    t = {k: torch.from_numpy(np.array(v)) for k, v in bufs.items()}
    op.apply(t, ctx)
    return {k: v.numpy() for k, v in t.items()}


def _ref_apply(op, bufs):
    out = dict(bufs)
    out.update(op.apply({k: jnp.asarray(v) for k, v in bufs.items()}, None))
    return {k: np.asarray(v) for k, v in out.items()}


class TestStepOps:
    def test_slice_pick_place_roundtrip(self):
        x = np.arange(12, dtype=np.float32).reshape(4, 3)
        bufs = {"x": x, "piece": np.zeros((2, 3), np.float32),
                "y": np.zeros((4, 3), np.float32)}
        for j in range(2):
            bufs = _port_apply(SlicePick(f"p{j}", "x", "piece", j, 2), bufs)
            bufs = _port_apply(PlaceSlice(f"q{j}", "piece", "y", j, 2), bufs)
        np.testing.assert_array_equal(bufs["y"], x)

    def test_slice_pick_rejects_uneven_runtime_rows(self):
        with pytest.raises(ValueError, match="split"):
            _port_apply(SlicePick("p", "x", "d", 0, 3),
                        {"x": np.zeros((4, 2), np.float32),
                         "d": np.zeros((1, 2), np.float32)})

    def test_add_into_accumulates(self):
        bufs = _port_apply(AddInto("a", "p", "acc"),
                           {"acc": np.ones((2, 2), np.float32),
                            "p": np.full((2, 2), 2.0, np.float32)})
        np.testing.assert_array_equal(bufs["acc"], np.full((2, 2), 3.0))

    def test_static_slice_concat_roundtrip_uneven(self):
        x = np.arange(7, dtype=np.float32)
        bufs = {"x": x, "a": np.zeros(4, np.float32),
                "b": np.zeros(3, np.float32), "y": np.zeros(7, np.float32)}
        bufs = _port_apply(StaticSlice("s0", "x", "a", 0, 4), bufs)
        bufs = _port_apply(StaticSlice("s1", "x", "b", 4, 3), bufs)
        bufs = _port_apply(ConcatPieces("c", ["a", "b"], "y"), bufs)
        np.testing.assert_array_equal(bufs["y"], x)

    def test_step_ops_equal_reference_apply(self):
        rng = np.random.default_rng(0)
        bufs = {"x": rng.standard_normal((6, 5)).astype(np.float32),
                "piece": rng.standard_normal((3, 5)).astype(np.float32),
                "acc": rng.standard_normal((3, 5)).astype(np.float32),
                "y": rng.standard_normal((6, 5)).astype(np.float32),
                "a": np.zeros((2, 5), np.float32)}
        pairs = [
            (SlicePick("p", "x", "piece", 1, 2),
             ref_synth.SlicePick("p", "x", "piece", 1, 2)),
            (PlaceSlice("q", "piece", "y", 1, 2),
             ref_synth.PlaceSlice("q", "piece", "y", 1, 2)),
            (AddInto("a", "piece", "acc"), ref_synth.AddInto("a", "piece", "acc")),
            (StaticSlice("s", "x", "a", 3, 2),
             ref_synth.StaticSlice("s", "x", "a", 3, 2)),
        ]
        for op, rop in pairs:
            assert op.reads() == rop.reads() and op.writes() == rop.writes()
            got, want = _port_apply(op, bufs), _ref_apply(rop, bufs)
            for k in op.writes():
                np.testing.assert_array_equal(got[k], want[k], err_msg=op.name())

    def test_picks_copy_never_alias(self):
        """A pick writes its own buffer: changing the source afterwards
        leaves the piece as it was."""
        x = torch.arange(8, dtype=torch.float32)
        bufs = {"x": x, "a": torch.zeros(4)}
        StaticSlice("s", "x", "a", 2, 4).apply(bufs, None)
        x.zero_()
        assert bufs["a"].tolist() == [2.0, 3.0, 4.0, 5.0]

    @pytest.mark.parametrize("index,size", [(0, 1), (1, 4), (3, 4)])
    def test_row_pick_place_follow_the_mesh(self, index, size):
        src = np.arange(size * 2 * 3, dtype=np.float32).reshape(size, 2, 3)
        bufs = {"src": src, "row": np.zeros((1, 2, 3), np.float32),
                "dst": np.zeros((size, 2, 3), np.float32)}
        ctx = _Ctx(index, size)
        for off in range(size):
            out = _port_apply(RowPick("p", "src", "row", off, "ep"), bufs, ctx)
            np.testing.assert_array_equal(out["row"][0],
                                          src[(index + off) % size])
            out = _port_apply(RowPlace("q", "row", "dst", -off, "ep"), out, ctx)
            np.testing.assert_array_equal(out["dst"][(index - off) % size],
                                          src[(index + off) % size])

    def test_row_ops_need_a_mesh(self):
        with pytest.raises(RuntimeError, match="mesh"):
            _port_apply(RowPick("p", "src", "row", 0, "ep"),
                        {"src": np.zeros((2, 1)), "row": np.zeros((1, 1))},
                        object())


# -- plans -----------------------------------------------------------------------


def _census(plan):
    return (plan.base, plan.collective, plan.sketch, plan.chunks, plan.engine,
            plan.n_xfers, plan.xfer_bytes, plan.label(),
            [asdict(d) for d in plan.buffers],
            [[(op.name(), type(op).__name__, op.to_json(),
               getattr(op, "reads", lambda: [])(),
               getattr(op, "writes", lambda: [])()) for op in ch]
             for ch in plan.chains],
            [(op.name(), op.reads(), op.writes()) for op in plan.combines])


PLANS = [
    ("ring", lambda m: m.plan_ring_all_reduce("b", "s", "d", "tp", 4, (4, 8), 2)),
    ("ringr", lambda m: m.plan_ring_all_reduce("b", "s", "d", "tp", 3, (4, 8),
                                               1, itemsize=2, reverse=True)),
    ("rhd", lambda m: m.plan_rhd_all_reduce("b", "s", "d", "tp", 8, (4, 8))),
    ("a2a", lambda m: m.plan_ring_all_to_all("b", "s", "d", "ep", 4, (3, 8))),
    ("neighbor", lambda m: m.plan_neighbor_shift("b", "s", "d", "x", -1,
                                                 (2, 1, 4, 4), 2)),
    ("pipe", lambda m: m.plan_host_pipe("b", "s", "d", 7, 4)),
]


class TestPlans:
    def test_ring_all_reduce_census(self):
        p = plan_ring_all_reduce("b", "s", "d", "tp", 4, (4, 8), 2)
        assert p.label() == "ring.c2"
        assert p.n_xfers == 2 * 3 and len(p.chains) == 2
        names = [d.name for d in p.buffers]
        assert len(names) == len(set(names))

    def test_reverse_ring_is_distinct_sketch(self):
        assert plan_ring_all_reduce("b", "s", "d", "tp", 4, (4, 8), 1,
                                    reverse=True).sketch == "ringr"

    def test_rhd_requires_power_of_two(self):
        with pytest.raises(ValueError, match="power"):
            plan_rhd_all_reduce("b", "s", "d", "tp", 3, (4, 8))
        assert plan_rhd_all_reduce("b", "s", "d", "tp", 8, (4, 8)).n_xfers == 3

    def test_a2a_ring_requires_extent(self):
        with pytest.raises(ValueError, match=">= 2"):
            plan_ring_all_to_all("b", "s", "d", "ep", 1, (4, 8))

    def test_host_pipe_declares_host_space(self):
        p = plan_host_pipe("b", "s", "d", 8, 2)
        assert p.engine == "pcie" and any(d.space == "host" for d in p.buffers)

    def test_host_pipe_posts_each_chunk_on_one_channel(self):
        """A chunk's fetch queues behind its spill: both post on the host
        piece's channel (not part of the JSON)."""
        p = plan_host_pipe("b", "s", "d", 8, 2)
        for j, chain in enumerate(p.chains):
            spill, fetch = chain[1], chain[2]
            assert spill.channel() == fetch.channel() == f"b.pipe2.x{j}.hst"

    @pytest.mark.parametrize("label,mk", PLANS, ids=[p[0] for p in PLANS])
    def test_census_chains_and_staging_equal_reference(self, label, mk):
        assert _census(mk(port_synth)) == _census(mk(ref_synth))


# -- the models' graphs and buffers ------------------------------------------------


GRAPHS = [("spmv", _spmv_graph), ("tp", _tp_graph), ("halo", _halo_graph),
          ("moe", _moe_graph)]


class TestGraphLevel:
    def _check(self, g, want_suffix, expect_sites, sketch):
        plat = Platform.make_n_lanes(1)
        st = _drive(g, plat, want_suffix)
        chosen = synths_of(st.sequence)
        assert len(chosen) == expect_sites, chosen
        assert all(v["sketch"] == sketch for v in chosen.values()), chosen
        stf = _drive(g, plat, ".fixed" if sketch != "neighbor" else ".xla")
        assert synths_of(stf.sequence) == {}
        for s in (st, stf):
            v = ScheduleVerifier(s.graph)(s.sequence)
            assert v.ok, f"false positive: {v.witness()}"
            assert synth_sound(s.graph, s.sequence)
        return st

    @pytest.mark.parametrize("label,mk", GRAPHS, ids=[g[0] for g in GRAPHS])
    def test_graph_equals_reference(self, label, mk):
        g, rg = mk(), mk(ref=True)
        assert _deep_shape(g) == _deep_shape(rg)
        assert _menus_view(synth_menus(g)) == _menus_view(
            ref_synth.synth_menus(rg))

    def test_spmv_pipe(self):
        g = _spmv_graph(n_rem=8)
        menus = synth_menus(g)
        assert set(menus) == {"x_exchange"}
        assert menus["x_exchange"]["menu"] == ["fixed", "pipe.c2", "pipe.c4"]
        self._check(g, "pipe.c2", 1, "pipe")

    def test_tp_mlp_all_reduce_menu(self):
        g = _tp_graph()
        menus = synth_menus(g)
        assert set(menus) == {"psum_0_0"}
        assert menus["psum_0_0"]["menu"] == [
            "fixed", "ring.c1", "ring.c2", "ringr.c1", "rhd.c1"]
        self._check(g, "rhd.c1", 1, "rhd")
        self._check(g, "ring.c2", 1, "ring")

    def test_halo_neighbor_all_faces(self):
        g = _halo_graph()
        menus = synth_menus(g)
        assert len(menus) == 6
        for m in menus.values():
            assert m["menu"] == ["fixed", "neighbor.c1", "neighbor.c2"]
        self._check(g, "neighbor.c2", 6, "neighbor")

    def test_moe_a2a_both_sites(self):
        g = _moe_graph()
        menus = synth_menus(g)
        assert set(menus) == {"a2a_disp_0", "a2a_comb_0", "a2a_disp_1",
                              "a2a_comb_1"}
        for m in menus.values():
            assert m["menu"] == ["fixed", "ring.c1"]
        self._check(g, "ring.c1", 4, "ring")

    def test_reference_schedule_json_runs_in_the_port(self):
        """A schedule the reference wrote, synth directives included,
        deserializes in the port, serializes back unchanged and verifies."""
        from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
        from tenzing_tpu.core.state import State as RefState

        for label, mk in GRAPHS:
            g, rg = mk(), mk(ref=True)
            st = RefState(rg)
            plat = RefPlatform.make_n_lanes(2)
            while not st.is_terminal():
                ds = st.get_decisions(plat)
                pick = next((d for d in ds if getattr(d, "choice", None)
                             is not None and ".synthed." in d.choice.name()),
                            ds[0])
                st = st.apply(pick)
            js = ref_to_json(st.sequence)
            seq = sequence_from_json(js, g)
            assert sequence_to_json(seq) == js, label
            assert synths_of(seq.vector()), label
            assert ScheduleVerifier(g)(seq).ok, label

    def test_spmv_menu_survives_a_full_prune(self):
        """At full size the card's constants prune both pipe
        instantiations: no choice is built (the reference's graph), and the
        compound still carries the menu with each reason (ROADMAP Queue 3
        item 16)."""
        xs = {"x_local": 150_000, "x_remote": 74_966}
        g = Graph()
        g.start_then(spmv.SpMVCompound(impl_choice=True, x_sizes=xs,
                                       exchange="host", synth=True))
        g.then_finish(spmv.SpMVCompound(impl_choice=True, x_sizes=xs,
                                         exchange="host", synth=True))
        plain = Graph()
        plain.start_then(spmv.SpMVCompound(impl_choice=True, x_sizes=xs,
                                           exchange="host"))
        plain.then_finish(spmv.SpMVCompound(impl_choice=True, x_sizes=xs,
                                            exchange="host"))
        assert _deep_shape(g) == _deep_shape(plain)
        menu = synth_menus(g)["x_exchange"]
        assert menu["menu"] == ["fixed"]
        assert set(menu["pruned"]) == {"pipe.c2", "pipe.c4"}
        assert all("cannot beat the fixed one-post floor" in r
                   for r in menu["pruned"].values())

    def test_world_size_one_offers_no_menu(self):
        one_tp = tp_mlp.TpMlpArgs(n_tp=1, n_layers=2, n_chunks=2, mb_size=2,
                                  d_model=8, d_ff=16)
        assert synth_menus(_wrap(tp_mlp.TpMlp(one_tp, synth=True),
                                 Graph())) == {}
        one_ep = moe.MoEArgs(n_ep=1, **dryrun.DRYRUN_ARGS)
        assert synth_menus(_wrap(moe.MoELayer(one_ep, synth=True),
                                 Graph())) == {}


def _equal_bufs(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def _norm(spec):
    if spec is None:
        return None
    if isinstance(spec, str):
        return (spec,)
    return tuple(None if a is None or a == () else
                 ((a,) if isinstance(a, str) else tuple(a)) for a in tuple(spec))


class TestSynthBuffers:
    @pytest.mark.parametrize("n_tp,n_dp", [(2, 1), (4, 1), (2, 2)])
    def test_tp_mlp(self, n_tp, n_dp):
        a = tp_mlp.TpMlpArgs(n_tp=n_tp, n_layers=2, n_chunks=2,
                             mb_size=2 * n_dp, d_model=8, d_ff=16 * n_tp)
        pb, ps, pw = tp_mlp.make_tp_mlp_buffers(a, seed=3, n_dp=n_dp, synth=True)
        rb, rs, rw = ref_tp.make_tp_mlp_buffers(ref_tp.TpMlpArgs(**asdict(a)),
                                                seed=3, n_dp=n_dp, synth=True)
        _equal_bufs(pb, rb)
        assert {k: _norm(v) for k, v in ps.items()} == {
            k: _norm(v) for k, v in rs.items()}
        assert np.array_equal(pw, rw)

    @pytest.mark.parametrize("n_ep", [2, 4])
    def test_moe(self, n_ep):
        a = moe.MoEArgs(n_ep=n_ep, **dryrun.DRYRUN_ARGS)
        pb, ps, pw = moe.make_moe_buffers(a, seed=1, synth=True)
        rb, _, rw = ref_moe.make_moe_buffers(ref_moe.MoEArgs(**asdict(a)),
                                             seed=1, synth=True)
        _equal_bufs(pb, rb)
        assert set(ps.values()) == {"ep"}
        assert np.array_equal(pw, rw)

    @pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 1)])
    def test_halo(self, shape):
        pb, ps, pw = halo.make_halo_buffers(shape, HALO, seed=2, synth=True)
        rb, rs, rw = ref_halo.make_halo_buffers(
            shape, ref_halo.HaloArgs(**asdict(HALO)), seed=2, synth=True)
        _equal_bufs(pb, rb)
        assert {k: _norm(v) for k, v in ps.items()} == {
            k: _norm(v) for k, v in rs.items()}
        assert np.array_equal(pw, rw)
        from tenzing_tpu_torch.parallel.mesh import coords_of

        for r in range(int(np.prod(shape))):
            c = coords_of(r, shape)
            lb, _ = halo.make_local_halo_buffers(shape, c, HALO, seed=2,
                                                 synth=True)
            assert lb.keys() == pb.keys()
            mesh = Mesh({ax: MeshAxis(size=n, index=i)
                         for ax, n, i in zip("xyz", shape, c)})
            from tenzing_tpu_torch.parallel.mesh import shard_of

            for k in pb:
                assert np.array_equal(lb[k], shard_of(pb[k], ps[k], mesh)), k

    @pytest.mark.parametrize("m", [64, 97])
    def test_spmv(self, m):
        pb, pw = spmv.make_spmv_buffers(m=m, synth=True)
        rb, rw = ref_spmv.make_spmv_buffers(m=m, synth=True)
        _equal_bufs(pb, rb)
        assert np.array_equal(pw, rw)
        n = len(pb["send_idx"])
        assert spmv.spmv_host_buffer_names(n, synth=True) == \
            ref_spmv.spmv_host_buffer_names(n, synth=True)


# -- the verifier fuzz and the solvers ------------------------------------------


class TestVerifierFuzz:
    @pytest.mark.parametrize("mk_graph,label", [(_spmv_graph, "spmv"),
                                                (_halo_graph, "halo")])
    def test_randomized_synth_rollouts_verify_clean(self, mk_graph, label):
        g = mk_graph()
        ver = ScheduleVerifier(g)
        rng = random.Random(17)
        n_synthed = 0
        for _ in range(10):
            st = State(g)
            while not st.is_terminal():
                ds = st.get_decisions(Platform.make_n_lanes(2))
                pick = next((d for d in ds
                             if getattr(d, "choice", None) is not None
                             and ".synthed." in d.choice.name()
                             and rng.random() < 0.7), None)
                st = st.apply(pick or ds[rng.randrange(len(ds))])
            v = ver(st.sequence)
            assert v.ok, f"false positive: {v.witness()}"
            assert synth_sound(st.graph, st.sequence)
            n_synthed += bool(synths_of(st.sequence))
        assert ver.unsound == 0
        assert n_synthed >= 3, f"{label} fuzz barely hit synth projections"


class TestSolversSearchSketches:
    def _bench(self):
        bufs, _, _ = tp_mlp.make_tp_mlp_buffers(TP, seed=0, synth=True)
        return AnalyticBenchmarker({k: v.nbytes for k, v in bufs.items()})

    def _seen(self, sims):
        seen = set()
        for s in sims:
            labels = {f"{v['sketch']}.c{v['chunks']}"
                      for v in synths_of(s.order).values()}
            seen.update(labels or {"fixed"})
        return seen

    def test_dfs_enumerates_sketches(self):
        from tenzing_tpu_torch.solve.dfs import DfsOpts, explore

        res = explore(_tp_graph(), Platform.make_n_lanes(1), self._bench(),
                      DfsOpts(max_seqs=24,
                              bench_opts=BenchOpts(n_iters=1, target_secs=0.0)))
        seen = self._seen(res.sims)
        assert "fixed" in seen and len(seen) >= 2, seen

    def test_hill_climb_searches_sketches(self):
        from tenzing_tpu_torch.solve.local import LocalOpts, hill_climb

        def prefer(op_name, choices):
            return next((c for c in choices if c.endswith(".fixed")), None)

        res = hill_climb(_tp_graph(), Platform.make_n_lanes(1), self._bench(),
                         phases=("mlp",), prefer=prefer,
                         opts=LocalOpts(budget=8, seed=0, bench_opts=BenchOpts(
                             n_iters=1, target_secs=0.0)))
        assert res.sims and len(self._seen(res.sims)) >= 2

    def test_mcts_searches_sketches(self):
        from tenzing_tpu_torch.solve.mcts import MctsOpts, explore

        res = explore(_tp_graph(), Platform.make_n_lanes(1), self._bench(),
                      MctsOpts(n_iters=16, seed=3,
                               bench_opts=BenchOpts(n_iters=1, target_secs=0.0),
                               screen_opts=BenchOpts(n_iters=1,
                                                     target_secs=0.0)))
        assert len(self._seen(res.sims)) >= 2


# -- the feature markers and the measured hidden comm ----------------------------


class TestFeatureMarkers:
    def test_synth_directives_counted(self):
        from tenzing_tpu_torch.learn.features import FEATURE_NAMES, featurize

        seq = Sequence([SynthDirective("a", "ring", 2),
                        SynthDirective("b", "pipe", 4),
                        SynthDirective("c", "ring", 1)])
        v = dict(zip(FEATURE_NAMES, featurize(seq)))
        assert v["n_synth_dir"] == 3.0 and v["n_synth_ring"] == 2.0
        assert v["n_synth_pipe"] == 1.0 and v["n_synth_neighbor"] == 0.0
        assert v["sum_synth_chunks"] == 7.0

    def test_step_names_do_not_count_as_directives(self):
        from tenzing_tpu_torch.learn.features import FEATURE_NAMES, featurize

        plan = plan_ring_all_reduce("b", "s", "d", "tp", 2, (2, 4), 2)
        seq = Sequence([op for chain in plan.chains for op in chain])
        assert dict(zip(FEATURE_NAMES, featurize(seq)))["n_synth_dir"] == 0.0

    def test_save_load_contract_rejects_pre_synth_model(self, tmp_path):
        from tenzing_tpu_torch.learn import RidgeEnsemble
        from tenzing_tpu_torch.learn.features import FEATURE_NAMES

        rng = np.random.default_rng(0)
        old_names = list(FEATURE_NAMES[:-7])
        old = RidgeEnsemble(feature_names=old_names).fit(
            rng.random((8, len(old_names))), rng.random(8))
        path = str(tmp_path / "pre_synth.json")
        old.save(path)
        with pytest.raises(ValueError, match="contract"):
            RidgeEnsemble.load(path, expect_features=list(FEATURE_NAMES))


class _FakeOp:
    def __init__(self, name, kind=""):
        self._name, self.KIND = name, kind

    def name(self):
        return self._name


class _FakeAttrib:
    def __init__(self, records):
        self.timeline = type("T", (), {"records": records})()


class TestHiddenCommMeasured:
    def test_overlap_interval_sum(self):
        from tenzing_tpu_torch.obs.attrib.timeline import OpRecord

        ops = [_FakeOp("ex.synth.neighbor.c2"),
               _FakeOp("ex.neighbor2.x0.p", kind="permute_start"),
               _FakeOp("compute_a"),
               _FakeOp("ex.neighbor2.x1.p", kind="permute_start"),
               _FakeOp("compute_b")]
        recs = [OpRecord("ex.neighbor2.x0.p", "", "device", 0, (1,),
                         dur_us=10.0, start_us=0.0),
                OpRecord("compute_a", "", "device", 1, (2,), dur_us=10.0,
                         start_us=5.0),
                OpRecord("ex.neighbor2.x1.p", "", "device", 0, (3,),
                         dur_us=4.0, start_us=15.0),
                OpRecord("compute_b", "", "device", 1, (4,), dur_us=2.0,
                         start_us=16.0)]
        assert synth_hidden_comm_measured_us(
            ops, _FakeAttrib(recs)) == pytest.approx(7.0)

    def test_zero_without_chosen_synth(self):
        assert synth_hidden_comm_measured_us([_FakeOp("compute_a")],
                                             _FakeAttrib([])) == 0.0


# -- executed numerics -----------------------------------------------------------


def _ref_mesh_run(make, ref_graph, axes, shape, jsons, out):
    bufs, specs, want = make()
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    plat = RefPlatform.make_n_lanes(2, mesh=JaxMesh(devs, axes), specs=specs)
    ex = TraceExecutor(plat, {k: jnp.asarray(v) for k, v in bufs.items()})
    return [np.asarray(ex.run(ref_from_json(js, ref_graph))[out])
            for js in jsons], want


TP_SUFFIXES = (".fixed", "ring.c1", "ring.c2", "ringr.c1", "rhd.c1")


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("n_tp", [2, 4])
def test_tp_all_reduce_sketches_over_gloo(n_tp, tmp_path):
    args = dict(n_tp=n_tp, n_layers=2, n_chunks=2, mb_size=2, d_model=8,
                d_ff=16)
    g, _, _, _, _, _ = dryrun.model_setup("tp_mlp_synth", args, {})
    plat = Platform.make_n_lanes(2)
    jsons = [sequence_to_json(_drive(g, plat, sfx).sequence)
             for sfx in TP_SUFFIXES]
    for js, sfx in zip(jsons, TP_SUFFIXES):
        got = {f"{v['sketch']}.c{v['chunks']}" for v in synths_of(
            sequence_from_json(js, g).vector()).values()}
        assert got == (set() if sfx == ".fixed" else {sfx}), (sfx, got)
    ra = ref_tp.TpMlpArgs(**args)
    ref_ys, want = _ref_mesh_run(
        lambda: ref_tp.make_tp_mlp_buffers(ra, seed=SEED, synth=True),
        _tp_graph(tp_mlp.TpMlpArgs(**args), ref=True), ("tp",), (n_tp,),
        jsons, "Y")
    port_ys = launch("tenzing_tpu_torch.parallel.dryrun:model_schedules",
                     n_tp, "cpu", dict(model="tp_mlp_synth", args=args,
                                       schedules=jsons, seed=SEED),
                     timeout_s=TIMEOUT_S, workdir=str(tmp_path),
                     mesh_axes=("tp",), mesh_shape=(n_tp,))[0]
    for py, ry, sfx in zip(port_ys, ref_ys, TP_SUFFIXES):
        np.testing.assert_allclose(py, ry, **PARITY_TOL, err_msg=sfx)
        np.testing.assert_allclose(py, want, **dryrun.ACT_TOL, err_msg=sfx)
        np.testing.assert_allclose(ry, want, **dryrun.ACT_TOL, err_msg=sfx)


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("n_ep", [2, 4])
def test_moe_ring_all_to_all_over_gloo(n_ep, tmp_path):
    a = moe.MoEArgs(n_ep=n_ep, **dryrun.DRYRUN_ARGS)
    g = _moe_graph(a)
    plat = Platform.make_n_lanes(2)
    jsons = [sequence_to_json(_drive(g, plat, sfx).sequence)
             for sfx in (".fixed", "ring.c1")]
    ra = ref_moe.MoEArgs(**asdict(a))
    ref_ys, want = _ref_mesh_run(
        lambda: ref_moe.make_moe_buffers(ra, seed=SEED, synth=True),
        _moe_graph(a, ref=True), ("ep",), (n_ep,), jsons, "Y")
    port_ys = launch("tenzing_tpu_torch.parallel.dryrun:run_schedules", n_ep,
                     "cpu", dict(args=asdict(a), schedules=jsons, seed=SEED,
                                 synth=True, synth_relax=True),
                     timeout_s=TIMEOUT_S, workdir=str(tmp_path),
                     mesh_axes=("ep",), mesh_shape=(n_ep,))[0]
    # pure movement: the ring's Y is the fixed all-to-all's, bit for bit
    np.testing.assert_array_equal(port_ys[1], port_ys[0])
    np.testing.assert_array_equal(ref_ys[1], ref_ys[0])
    for py, ry in zip(port_ys, ref_ys):
        np.testing.assert_allclose(py, ry, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(py, want, **dryrun.Y_TOL)


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 1)])
def test_halo_neighbor_shift_over_gloo(shape, tmp_path):
    g = _halo_graph()
    plat = Platform.make_n_lanes(2)
    jsons = [sequence_to_json(_drive(g, plat, sfx).sequence)
             for sfx in (".xla", "neighbor.c2", "neighbor.c1")]
    rargs = ref_halo.HaloArgs(**asdict(HALO))
    ref_us, want = _ref_mesh_run(
        lambda: ref_halo.make_halo_buffers(shape, rargs, seed=SEED, synth=True),
        _halo_graph(ref=True), dryrun.HALO_AXES, shape, jsons, "U")
    port_us = launch("tenzing_tpu_torch.parallel.dryrun:halo_schedules",
                     int(np.prod(shape)), "cpu",
                     dict(args=asdict(HALO), schedules=jsons, seed=SEED,
                          synth=True),
                     timeout_s=TIMEOUT_S, workdir=str(tmp_path),
                     mesh_axes=dryrun.HALO_AXES, mesh_shape=shape)[0]
    for pu, ru in zip(port_us, ref_us):
        np.testing.assert_array_equal(pu, want)
        np.testing.assert_array_equal(ru, want)


SPMV_M = 96


def _spmv_orders():
    bufs, _ = spmv.make_spmv_buffers(m=SPMV_M, synth=True)
    n_rem = len(bufs["send_idx"])
    xs = {"x_local": SPMV_M, "x_remote": n_rem}

    def mk(m):
        return m.SpMVCompound(impl_choice=True, x_sizes=xs, exchange="host",
                              synth=True, synth_relax=True)
    g, rg = Graph(), RefGraph()
    g.start_then(mk(spmv))
    g.then_finish(mk(spmv))
    rg.start_then(mk(ref_spmv))
    rg.then_finish(mk(ref_spmv))
    plat = Platform.make_n_lanes(2)
    return g, rg, n_rem, {sfx: _drive(g, plat, sfx).sequence
                          for sfx in (".fixed", "pipe.c2", "pipe.c4")}


def test_spmv_pipe_bit_identical_on_one_rank():
    g, _, n_rem, orders = _spmv_orders()
    bufs, want = spmv.make_spmv_buffers(m=SPMV_M, synth=True)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(
        bufs, "cpu", spmv.spmv_host_buffer_names(n_rem, synth=True)),
        device="cpu")
    outs = {k: {n: t.clone() for n, t in ex.run(o).items()}
            for k, o in orders.items()}
    for k in ("pipe.c2", "pipe.c4"):
        assert synths_of(orders[k].vector()) == {
            "x_exchange": {"sketch": "pipe", "chunks": int(k[-1])}}
        assert torch.equal(outs[k]["x_remote"], outs[".fixed"]["x_remote"])
        assert torch.equal(outs[k]["y"], outs[".fixed"]["y"])
    np.testing.assert_allclose(outs[".fixed"]["y"].numpy(), want, rtol=2e-6,
                               atol=1e-6)


@pytest.mark.needs_pinned_host
def test_spmv_pipe_equals_reference_executor():
    g, rg, n_rem, orders = _spmv_orders()
    bufs, _ = spmv.make_spmv_buffers(m=SPMV_M, synth=True)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(
        bufs, "cpu", spmv.spmv_host_buffer_names(n_rem, synth=True)),
        device="cpu")
    rbufs, _ = ref_spmv.make_spmv_buffers(m=SPMV_M, synth=True)
    rex = TraceExecutor(RefPlatform.make_n_lanes(2),
                        TraceExecutor.place_host_buffers(
                            rbufs, ref_spmv.spmv_host_buffer_names(
                                n_rem, synth=True)))
    for k, o in orders.items():
        got = ex.run(o)
        out = rex.run(ref_from_json(sequence_to_json(o), rg))
        np.testing.assert_array_equal(got["x_remote"].numpy(),
                                      np.asarray(out["x_remote"]), err_msg=k)
        np.testing.assert_allclose(got["y"].numpy(), np.asarray(out["y"]),
                                   rtol=2e-6, atol=1e-6, err_msg=k)


def test_dryrun_tp_mlp_synth_stage():
    """``python -m tenzing_tpu_torch.parallel.dryrun --model tp_mlp_synth
    --nproc 4 --device cpu``: every DFS schedule within the tolerance, the
    mesh MCTS visiting two or more sketch labels."""
    s = dryrun.models_main("tp_mlp_synth", 4, "cpu")
    (st,) = s["stages"]
    assert st["schedules"] and all(r["within_tol"] for r in st["schedules"])
    assert st["explore"]["rollouts"] == dryrun.SYNTH_MCTS_ITERS
    assert len(st["explore"]["sketches"]) >= 2, st["explore"]
    with pytest.raises(ValueError, match="2 or more ranks"):
        dryrun.model_cases(1, "tp_mlp_synth")


# -- the card --------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("m", [8192])
def test_cuda_spmv_pipe_bit_identical_with_ell_spmv(cuda_device, m):
    """Through the stream executor with graphs, at m=8192 where the kernel
    menu is on: the pipe schedules (every SpMV on the kernel) equal the
    fixed exchange's bit for bit, and ``ell_spmv`` is launched under each."""
    from tenzing_tpu_torch.bench.driver import DriverRequest, build_spmv
    from tenzing_tpu_torch.ops import spmv_kernels as sk

    g, tb, _, _ = build_spmv(DriverRequest(workload="spmv", m=m, smoke=True,
                                           synth_collectives=True),
                             cuda_device)
    plat = Platform.make_n_lanes(2)
    ex = StreamExecutor(plat, tb, graphs=True)
    outs = {}
    for sfx in (".fixed", "pipe.c2", "pipe.c4"):
        st = State(g)
        while not st.is_terminal():
            ds = st.get_decisions(plat)
            pick = next((d for d in ds if getattr(d, "choice", None) is not None
                         and (d.choice.name().endswith(sfx)
                              or d.choice.name().endswith(".pallas"))), ds[0])
            st = st.apply(pick)
        before = sk.LAUNCHES["ell_spmv"]
        outs[sfx] = {k: v.clone() for k, v in ex.run(st.sequence).items()}
        assert sk.LAUNCHES["ell_spmv"] > before, sfx
    for sfx in ("pipe.c2", "pipe.c4"):
        assert torch.equal(outs[sfx]["y"], outs[".fixed"]["y"])
        assert torch.equal(outs[sfx]["x_remote"], outs[".fixed"]["x_remote"])
