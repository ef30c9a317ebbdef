"""The port's fused regions (tenzing_tpu_torch/runtime/fused.py, the
``fused_region`` kernel's lowering and plain version in ops/fused_region.py)
against the JAX package's fusion backend.

The reference's own SpMV setups (tests/test_fused.py:406-469) and the
driver's host-exchange graph go through both ``FusedExecutor``s (the
reference's with ``min_tile_bytes=0``, the port's floor): the region partition, the members, the tile menu and
the tiles each region takes must be the same, and the fused outputs must
equal the stepped ones (the plain region applies the members' plain
functions, so on the CPU they agree bit for bit at one tile) and the
reference's fused outputs (at the ELL sums' tolerance).

The attention members (the fold, its chunked sub-folds and the finalize) go
through both packages the same way at ``RingAttnArgs(n_devices=4, batch=2,
seq_local=16, head_dim=8)``, the reference's ``FusedExecutor`` in interpret
mode: the same regions, members, tile menus and tiles, and fused outputs
within ``F32_STATE_TOL`` (m, l, acc / l; and O) of the stepped program and
of the reference's fused program.  ``batch = 2``: a tile's query rows are a
range in each batch element, which one element cannot show.

The ``test_cuda_*`` tests need the card (marker ``needs_cuda``)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenzing_tpu.bench.roofline import Cost as RefCost
from tenzing_tpu.bench.roofline import prune_tilings as ref_prune
from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.resources import Event as RefEvent
from tenzing_tpu.core.resources import Lane as RefLane
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.core.sync_ops import EventRecord as RefRecord
from tenzing_tpu.core.sync_ops import WaitEvent as RefWait
from tenzing_tpu.core.state import State as RefState
from tenzing_tpu.models import ring_attention as ref_ra
from tenzing_tpu.models import spmv as ref_spmv
from tenzing_tpu.runtime import fused as ref_fused
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu_torch.bench import roofline
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.resources import Event, Lane
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.core.state import State
from tenzing_tpu_torch.core.sync_ops import EventRecord, WaitEvent
from tenzing_tpu_torch.models import ring_attention as ra
from tenzing_tpu_torch.models import spmv
from tenzing_tpu_torch.ops import attention_kernels as ak
from tenzing_tpu_torch.ops import fused_region as fr
from tenzing_tpu_torch.ops.spmv_kernels import ELL_TOL
from tenzing_tpu_torch.runtime import fused
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.verify import ScheduleVerifier


def _graphs(**kw):
    g, rg = Graph(), RefGraph()
    g.start_then(spmv.SpMVCompound(**kw))
    g.then_finish(spmv.SpMVCompound(**kw))
    rg.start_then(ref_spmv.SpMVCompound(**kw))
    rg.then_finish(ref_spmv.SpMVCompound(**kw))
    return g, rg


def _walk(g, plat, rng=None):
    st = State(g)
    while not st.is_terminal():
        ds = st.get_decisions(plat)
        st = st.apply(ds[rng.randrange(len(ds))] if rng else ds[0])
    return st.sequence


def _executors(size, n_lanes, host=False):
    bufs, want = spmv.make_spmv_buffers(**size)
    names = spmv.spmv_host_buffer_names() if host else []
    ex = StreamExecutor(Platform.make_n_lanes(n_lanes),
                        buffers_from_numpy(bufs, "cpu", names), device="cpu")
    rbufs, _ = ref_spmv.make_spmv_buffers(**size)
    rex = TraceExecutor(
        RefPlatform.make_n_lanes(n_lanes),
        TraceExecutor.place_host_buffers(rbufs, names) if host
        else {k: jnp.asarray(v) for k, v in rbufs.items()})
    return ex, rex, want


def _compare(js, g, rg, ex, rex, want, tiles=None):
    """Plan and run one schedule JSON through both packages' FusedExecutor;
    returns the port's plan."""
    order, rorder = sequence_from_json(js, g), ref_from_json(js, rg)
    fex = fused.FusedExecutor(ex, tiles=tiles)
    rfex = ref_fused.FusedExecutor(rex, tiles=tiles, min_tile_bytes=0)
    plan, rplan = fex.plan(order), rfex.plan(rorder)
    assert plan.tile_menu == rplan.tile_menu
    assert [(r.members, r.lanes, r.tiles, r.valid_tiles, r.pruned_tiles)
            for r in plan.regions] == \
        [(r.members, r.lanes, r.tiles, r.valid_tiles, r.pruned_tiles)
         for r in rplan.regions]
    assert (plan.n_ops_total, plan.n_ops_fused) == \
        (rplan.n_ops_total, rplan.n_ops_fused)
    out_s, out_f = ex.run(order), fex.run(order)
    rout = rfex.run(rorder)
    for name in out_s:
        if name == "host_x":
            continue
        assert torch.equal(out_s[name], out_f[name]), name
        np.testing.assert_allclose(out_f[name].numpy(),
                                   np.asarray(jax.device_get(rout[name])),
                                   **ELL_TOL, err_msg=name)
    np.testing.assert_allclose(out_f["y"].numpy(), want, **ELL_TOL)
    return plan


def test_one_region_menu_collapses_to_single_tile():
    """The reference's test region: the local exchange writes x_remote tiled
    and spmv_remote gathers it whole, so the menu is [1] and the kernel
    needs its grid-wide barrier."""
    g, rg = _graphs(exchange="local")
    ex, rex, want = _executors(dict(m=64, nnz_per_row=4, seed=1), 1)
    js = sequence_to_json(_walk(g, Platform.make_n_lanes(1)))
    plan = _compare(js, g, rg, ex, rex, want)
    assert len(plan.regions) == 1 and plan.regions[0].n_ops == 5
    assert plan.tile_menu == [1]
    kernel = next(op for op in plan.fused_order
                  if isinstance(op, fused.FusedRegionOp)).unbound()
    assert [b.body for b in kernel.bodies()] == ["ell", "gather", "copy", "ell", "add"]
    assert [b.barrier for b in kernel.bodies()] == [False, False, True, True, True]


@pytest.mark.parametrize("trial", range(3))
def test_two_lane_random_schedules_fused_match(trial):
    g, rg = _graphs(exchange="local")
    ex, rex, want = _executors(dict(m=32, nnz_per_row=3, seed=2), 2)
    rng = random.Random(7 + trial)
    seq = _walk(g, Platform.make_n_lanes(2), rng)
    assert ScheduleVerifier(g)(seq).ok
    _compare(sequence_to_json(seq), g, rg, ex, rex, want)


DRIVER_KW = dict(impl_choice=True, x_sizes={"x_local": 512, "x_remote": 255},
                 exchange="host")


def _driver_orders():
    g, _ = _graphs(**DRIVER_KW)
    plat = Platform.make_n_lanes(2)
    out = [("naive", sequence_to_json(_walk(g, Platform.make_n_lanes(1))))]
    for k in range(3):
        out.append((f"random{k}", sequence_to_json(_walk(g, plat, random.Random(k)))))
    return out


@pytest.mark.needs_pinned_host
@pytest.mark.parametrize("label,js", _driver_orders(), ids=[o[0] for o in _driver_orders()])
@pytest.mark.parametrize("tiles", [1, 2, 8])
def test_host_exchange_regions_and_tiles_equal_reference(label, js, tiles):
    """The driver's smoke graph (m=512, the host exchange splits the
    iteration in two regions whose rows tile): every requested count
    resolves to the same per-region tiles in both packages."""
    g, rg = _graphs(**DRIVER_KW)
    ex, rex, want = _executors(dict(m=512, nnz_per_row=10, seed=0), 2, host=True)
    assert len(ex.init_bufs["x_remote"]) == DRIVER_KW["x_sizes"]["x_remote"]
    plan = _compare(js, g, rg, ex, rex, want, tiles=tiles)
    if label == "naive":
        assert [r.members for r in plan.regions] == [
            ["spmv_local.xla", "scatter"], ["spmv_remote.xla", "y_add"]]


def test_partitioner_boundaries_equal_reference():
    """Hand-built op lists over both packages' SpMV ops: an outgoing record
    is deferred past the region, an incoming wait splits it, a host transfer
    splits it, and a kernel slot never joins."""
    l0, l1 = Lane(0), Lane(1)
    r0, r1 = RefLane(0), RefLane(1)

    def both(build):
        return ([s for s in build(spmv, l0, l1, EventRecord, WaitEvent, Event)],
                [s for s in build(ref_spmv, r0, r1, RefRecord, RefWait, RefEvent)])

    def ops(mod, a, b, rec, wait, ev):
        e = ev(0)
        return [mod.SpMVOp("sa", "x", "y", "v", "c").bind(a), rec(a, e),
                mod.Scatter("sc", "x", "i", "s").bind(a), wait(b, e),
                mod.VectorAdd("ad", "y", "s", "o").bind(b),
                mod.SpMVPallasOp("sp.pallas", "x", "z", "v", "c").bind(b),
                mod.LocalExchange("ex", "s", "t").bind(b)]

    mine, theirs = both(ops)

    def shape(segs):
        return [(k, [m.name() for m in s.members] if k == "region" else s.name())
                for k, s in segs]

    assert shape(fused.partition_regions(mine)) == \
        shape(ref_fused.partition_regions(theirs))
    assert [k for k, _ in fused.partition_regions(mine)] == \
        ["region", "op", "op", "region", "op", "region"]


def test_prune_tilings_equals_reference_without_floor_or_ceiling():
    for hbm, full in ((8 * 2**20, 0.0), (3e6, 1e6), (1e9, 5e8), (100.0, 0.0)):
        counts = [1, 2, 4, 8, 16, 32, 64]
        for floor in (0, 2**20):
            mine = roofline.prune_tilings(roofline.Cost(0.0, hbm), counts,
                                          min_tile_bytes=floor, full_bytes=full)
            theirs = ref_prune(RefCost(0.0, hbm), counts, vmem_bytes=float("inf"),
                               min_tile_bytes=floor, full_bytes=full)
            assert mine == theirs
    # the card's default: no floor (no tile count measured slower on an
    # H100) and no working-set ceiling (all groups resident at once)
    assert roofline.MIN_TILE_BYTES == 0
    for hbm in (10.0, 8 * 2**20, 2e12):
        assert roofline.prune_tilings(roofline.Cost(0.0, hbm), [1, 2, 8, 64]) == \
            [1, 2, 8, 64]
    assert roofline.prune_tilings(roofline.Cost(0.0, 1e6), [0, 4, 2]) == [2, 4]


def test_tile_decision_nodes():
    g, _ = _graphs(exchange="local")
    tg = fused.with_tile_menu(g, [1, 2, 4])
    plat = Platform.make_n_lanes(1)
    st = State(tg)
    while not st.is_terminal():
        ds = st.get_decisions(plat)
        pick = next((d for d in ds if getattr(d, "choice", None) is not None
                     and d.choice.name().endswith(".t4")), ds[0])
        st = st.apply(pick)
    assert fused.tiles_of(st.sequence) == 4
    assert ScheduleVerifier(tg)(st.sequence).ok
    back = sequence_from_json(sequence_to_json(st.sequence), tg)
    assert fused.tiles_of(back) == 4
    assert [o.name() for o in fused.FuseTileChoice([1, 2, 8]).choices()] == \
        ["fuse_tile.t1", "fuse_tile.t2", "fuse_tile.t8"]
    with pytest.raises(ValueError):
        fused.FuseTileChoice([])
    assert fused.tiles_of(Sequence([])) == 1


def test_dfs_enumerates_the_planted_tiles():
    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
    from tenzing_tpu_torch.solve.dfs import DfsOpts, explore

    g, _ = _graphs(exchange="local")
    tg = fused.with_tile_menu(g, [1, 2, 4])
    ex, _, want = _executors(dict(m=64, nnz_per_row=4, seed=1), 1)
    bench = EmpiricalBenchmarker(fused.FusedExecutor(ex))
    res = explore(tg, Platform.make_n_lanes(1), bench,
                  DfsOpts(max_seqs=9, bench_opts=BenchOpts(n_iters=2,
                                                           target_secs=0.0002)))
    assert {fused.tiles_of(s.order) for s in res.sims} == {1, 2, 4}


def test_barrier_flags_follow_the_data_hazards():
    assert fr.barrier_flags([["x"], ["y"], ["x"]], [["y"], ["z"], ["w"]]) == \
        [False, True, False]
    # a write after an earlier member's read is a hazard too
    assert fr.barrier_flags([["x"], ["q"]], [["y"], ["x"]]) == [False, True]


def test_fused_order_writes_in_place_and_serializes():
    g, _ = _graphs(exchange="local")
    ex, _, want = _executors(dict(m=64, nnz_per_row=4, seed=1), 2)
    seq = _walk(g, Platform.make_n_lanes(2), random.Random(3))
    fex = fused.FusedExecutor(ex)
    fseq = fex.fused_order(seq)
    region = next(op for op in fseq if isinstance(op, fused.FusedRegionOp))
    j = region.to_json()
    assert j["kind"] == "fused_region" and j["lanes"] == [l.id for l in region.lanes()]
    assert fex.plan(seq) is fex.plan(seq)
    ptrs = {k: v.data_ptr() for k, v in ex.init_bufs.items()}
    fex.prepare_n(seq)(3)
    assert ptrs == {k: v.data_ptr() for k, v in ex.init_bufs.items()}
    np.testing.assert_allclose(ex.init_bufs["y"].numpy(), want, **ELL_TOL)
    scratch = [k for k in ex.ctx.scratch if k.startswith("fused_barrier_")]
    assert scratch and all(ex.ctx.scratch[k].dtype == torch.int32 for k in scratch)


def test_region_table_mirrors_the_kernel_layout():
    """The ctypes table is the C struct: 120-byte members (kind, barrier,
    seven int64 extents, the scale and its pad, six operand pointers) after
    an 8-byte header (csrc/fused_region.cu ``Member`` / ``Table``); a region
    of more members than a table holds takes several tables."""
    import ctypes

    assert ctypes.sizeof(fr._Member) == 120
    assert [f for f, _ in fr._Member._fields_] == [
        "kind", "barrier", "rows", "width", "outer", "inner", "kv_rows",
        "key_off", "nkv", "scale", "pad", "p"]
    assert fr._Member.p.offset == 72
    assert ctypes.sizeof(fr._Table) == 8 + 120 * fr.MAX_MEMBERS
    bodies = [fr.MemberBody("copy", ("a", "b"), 10, 0, False)]
    t = fr.RegionTable(bodies, 2)
    bufs = {"a": torch.zeros(10), "b": torch.zeros(10)}
    t.bind(bufs)
    assert t.tables[0].m[0].p[0] == bufs["a"].data_ptr()
    assert t.tables[0].m[0].p[1] == bufs["b"].data_ptr()
    assert t.bound is bufs
    with pytest.raises(ValueError, match="contiguous"):
        t.bind({"a": torch.zeros(20)[::2], "b": torch.zeros(10)})
    assert t.bound is None  # a failed bind leaves the table unbound
    many = fr.RegionTable([fr.MemberBody("copy", ("a", "b"), 10, 0, True)]
                          * (fr.MAX_MEMBERS + 1), 1)
    assert [tb.n for tb in many.tables] == [fr.MAX_MEMBERS, 1]
    # the launch boundary orders the second table: no barrier at its head
    assert many.tables[1].m[0].barrier == 0 and many.tables[0].m[1].barrier == 1
    with pytest.raises(ValueError):
        fr.RegionTable([], 1)
    with pytest.raises(TypeError, match="int32"):
        fr.check_member("gather", ("x", "i", "o"),
                        {"x": (4,), "i": (3,), "o": (3,)},
                        {"x": torch.float32, "i": torch.int64, "o": torch.float32})


def _attn_members(d=128):
    fold = fr.MemberBody("attn_fold", fr.OPERANDS["attn_fold"], 64, 0, False,
                         outer=2, inner=d, kv_rows=96, key_off=32, nkv=32,
                         scale=d ** -0.5)
    fin = fr.MemberBody("attn_finalize", ("acc", "l", "o"), 64, 0, True,
                        outer=2, inner=d)
    return [fold, fin]


def test_attention_table_selects_the_split_tf32_instantiation():
    """A table of attention members (folds and a finalize, or the finalize
    alone, as the last table of a long region) launches the f32 fold's
    warp-specialized block: its threads and shared memory (the plan of
    csrc/attn_fold_f32.cuh)."""
    want = {"kind": "attn", "threads": 384, "smem_bytes": 230_528}
    for members in (_attn_members(), _attn_members()[1:]):
        assert fr.instantiation(members) == want
        assert len(fr.RegionTable(members, 2).tables) == 1
    plan = ak.f32_launch_plan(2, 64, 32, 128)
    assert (want["threads"], want["smem_bytes"]) == (plan["threads"],
                                                     plan["smem_bytes"])


def test_spmv_table_keeps_the_simt_instantiation():
    """SpMV members keep the 256-thread instantiation without shared
    memory, and a table never mixes the two (the kernel refuses it)."""
    spmv = [fr.MemberBody("ell", fr.OPERANDS["ell"], 10, 3, False),
            fr.MemberBody("copy", ("a", "b"), 10, 0, True)]
    assert fr.instantiation(spmv) == {"kind": "spmv", "threads": 256,
                                      "smem_bytes": 0}
    assert len(fr.RegionTable(spmv, 1).tables) == 1
    with pytest.raises(ValueError, match="mix"):
        fr.RegionTable(spmv + _attn_members(), 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("tiles", [1, 2, 4, 16])
def test_cuda_region_matches_plain(cuda_device, tiles):
    g, _ = _graphs(**DRIVER_KW)
    bufs, want = spmv.make_spmv_buffers(m=512, nnz_per_row=10, seed=0)
    tb = buffers_from_numpy(bufs, cuda_device, spmv.spmv_host_buffer_names())
    plat = Platform.make_n_lanes(2)
    ex = StreamExecutor(plat, tb)
    plain = StreamExecutor(plat, tb, plain_kernels=True)
    for seed in range(3):
        seq = _walk(g, plat, random.Random(seed))
        before = fr.LAUNCHES["fused_region"]
        out_k = fused.FusedExecutor(ex, tiles=tiles).run(seq)
        out_p = fused.FusedExecutor(plain, tiles=tiles).run(seq)
        assert fr.LAUNCHES["fused_region"] > before
        for name in ("y", "y_local", "y_remote", "send_buf", "x_remote"):
            torch.testing.assert_close(out_k[name], out_p[name], **ELL_TOL)
        np.testing.assert_allclose(out_k["y"].cpu().numpy(), want, **ELL_TOL)


# -- the attention members ----------------------------------------------------

ATTN = dict(n_devices=4, batch=2, seq_local=16, head_dim=8)


def _attn_graphs(chunk=False):
    g, rg = Graph(), RefGraph()
    op = ra.BlockedAttention(ra.RingAttnArgs(**ATTN), impl_choice=True,
                             fused_choice=True, chunk=chunk, chunk_relax=chunk)
    rop = ref_ra.BlockedAttention(ref_ra.RingAttnArgs(**ATTN), impl_choice=True,
                                  fused_choice=True, chunk=chunk,
                                  chunk_relax=chunk)
    g.start_then(op)
    g.then_finish(op)
    rg.start_then(rop)
    rg.then_finish(rop)
    return g, rg


def _attn_executors(n_lanes):
    bufs, want = ra.make_blocked_buffers(ra.RingAttnArgs(**ATTN), seed=0)
    ex = StreamExecutor(Platform.make_n_lanes(n_lanes),
                        buffers_from_numpy(bufs, "cpu"), device="cpu")
    rbufs, _ = ref_ra.make_blocked_buffers(ref_ra.RingAttnArgs(**ATTN), seed=0)
    rex = TraceExecutor(RefPlatform.make_n_lanes(n_lanes),
                        {k: jnp.asarray(v) for k, v in rbufs.items()})
    return ex, rex, want


def _state_close(got, want):
    names = ("acc", "m_run", "l_run")
    ok, errs = ak.state_check([got[n] for n in names], [want[n] for n in names],
                              ak.F32_STATE_TOL)
    assert ok, errs
    torch.testing.assert_close(got["O"], want["O"], **ak.F32_STATE_TOL["acc/l"])


def _compare_attn(js, g, rg, ex, rex, want, tiles):
    """One attention schedule JSON through both packages' FusedExecutor:
    the same plan, fused outputs within F32_STATE_TOL of the stepped ones
    (bit for bit at one tile) and of the reference's fused ones."""
    order, rorder = sequence_from_json(js, g), ref_from_json(js, rg)
    fex = fused.FusedExecutor(ex, tiles=tiles)
    rfex = ref_fused.FusedExecutor(rex, tiles=tiles, min_tile_bytes=0)
    plan, rplan = fex.plan(order), rfex.plan(rorder)
    assert plan.tile_menu == rplan.tile_menu
    assert [(r.members, r.lanes, r.tiles, r.valid_tiles, r.pruned_tiles)
            for r in plan.regions] == \
        [(r.members, r.lanes, r.tiles, r.valid_tiles, r.pruned_tiles)
         for r in rplan.regions]
    assert (plan.n_ops_total, plan.n_ops_fused) == \
        (rplan.n_ops_total, rplan.n_ops_fused)
    out_s, out_f = ex.run(order), fex.run(order)
    rout = {k: torch.from_numpy(np.asarray(jax.device_get(v)).copy())
            for k, v in rfex.run(rorder).items()}
    if all(r.tiles == 1 for r in plan.regions):
        for name in out_s:
            assert torch.equal(out_s[name], out_f[name]), name
    _state_close(out_f, out_s)
    _state_close(out_f, rout)
    np.testing.assert_allclose(out_f["O"].numpy(), want, rtol=2e-4, atol=2e-5)
    return plan


def test_attention_naive_region_every_tile_count():
    """The naive all-.xla chain is one region of the four folds and the
    finalize; every count of its menu (1 .. 64: 64 query rows) lowers the
    same way in both packages."""
    g, rg = _attn_graphs()
    ex, rex, want = _attn_executors(1)
    js = sequence_to_json(ra.fixed_order(g, Platform.make_n_lanes(1)))
    menu = fused.FusedExecutor(ex).plan(sequence_from_json(js, g)).tile_menu
    assert menu == [1, 2, 4, 8, 16, 32, 64]
    for t in menu:
        plan = _compare_attn(js, g, rg, ex, rex, want, t)
        assert [r.n_ops for r in plan.regions] == [5]
    kernel = next(op for op in plan.fused_order
                  if isinstance(op, fused.FusedRegionOp)).unbound()
    bodies = kernel.bodies()
    assert [b.body for b in bodies] == ["attn_fold"] * 4 + ["attn_finalize"]
    assert [b.barrier for b in bodies] == [False, True, True, True, True]
    assert [(b.key_off, b.nkv) for b in bodies[:4]] == \
        [(0, 16), (16, 16), (32, 16), (48, 16)]
    assert {(b.outer, b.rows, b.inner) for b in bodies} == {(2, 64, 8)}
    assert {b.kv_rows for b in bodies[:4]} == {64}
    assert bodies[0].scale == pytest.approx(ra.RingAttnArgs(**ATTN).scale)


@pytest.mark.parametrize("trial", range(3))
def test_attention_two_lane_random_orders_fused_match(trial):
    """Random 2-lane completions of the driver's attention graph: their
    .xla runs fuse into the same regions as in the reference."""
    g, rg = _attn_graphs()
    ex, rex, want = _attn_executors(2)
    rng = random.Random(11 + trial)
    seq = ra.fixed_order(g, Platform.make_n_lanes(2),
                         lane_of=lambda s: rng.randrange(2))
    assert ScheduleVerifier(g)(seq).ok
    js = sequence_to_json(seq)
    for t in (1, 4):
        _compare_attn(js, g, rg, ex, rex, want, t)


@pytest.mark.parametrize("n", [2, 4])
def test_attention_chunked_sub_folds_fuse(n):
    """The naive order with every fold chunked n ways: the sub-folds are
    fold members with their own key offsets; each directive's host sync
    splits the chain into one region per block."""
    g, rg = _attn_graphs(chunk=True)
    ex, rex, want = _attn_executors(1)
    seq = ra.fixed_order(g, Platform.make_n_lanes(1),
                         kernel_of=lambda s: f".xla.chunked.c{n}")
    js = sequence_to_json(seq)
    for t in (1, 8):
        plan = _compare_attn(js, g, rg, ex, rex, want, t)
    assert [r.n_ops for r in plan.regions] == [n] * 3 + [n + 1]
    kernel = next(op for op in plan.fused_order
                  if isinstance(op, fused.FusedRegionOp)).unbound()
    assert [(b.key_off, b.nkv) for b in kernel.bodies()] == \
        [(j * 16 // n, 16 // n) for j in range(n)]


def test_attention_region_past_one_table_runs_in_launches():
    """A region of more members than one descriptor table holds (36 folds
    and the finalize on one lane) lowers into two tables and runs."""
    from tenzing_tpu_torch.core.operation import Finish, Start

    a = ra.RingAttnArgs(**ATTN)
    ex, _, _ = _attn_executors(1)
    lane = Lane(0)
    folds = [ra.BlockAttnStep(f"f{i}", i % 4, a).bind(lane) for i in range(36)]
    seq = Sequence([Start()] + folds + [ra.FinalizeAttn().bind(lane), Finish()])
    out_s = ex.run(seq)
    for t in (1, 4):
        fex = fused.FusedExecutor(ex, tiles=t)
        plan = fex.plan(seq)
        assert [r.n_ops for r in plan.regions] == [37]
        kernel = next(op for op in plan.fused_order
                      if isinstance(op, fused.FusedRegionOp)).unbound()
        assert [tb.n for tb in kernel.table.tables] == [32, 5]
        _state_close(fex.run(seq), out_s)


def test_lowering_rejects_a_tiling_the_body_does_not_take():
    class RowsOnAxis0(ra.BlockAttnStep):
        def fuse_tiling(self):
            return {"Q": 0, "acc": 0, "m_run": 0, "l_run": 0, "K": None,
                    "V": None}

    a = ra.RingAttnArgs(**ATTN)
    ex, _, _ = _attn_executors(1)
    shapes = {k: tuple(v.shape) for k, v in ex.init_bufs.items()}
    dtypes = {k: v.dtype for k, v in ex.init_bufs.items()}
    with pytest.raises(ValueError, match="axis 0"):
        fused.lower_region([RowsOnAxis0("x", 0, a).bind(Lane(0))], shapes, dtypes)
    with pytest.raises(ValueError, match="keys"):
        fr.check_member("attn_fold", ("Q", "K", "V", "acc", "m_run", "l_run"),
                        shapes, dtypes, {"key_off": 60, "nkv": 16, "scale": 1.0})


@pytest.mark.needs_cuda
def test_cuda_table_layout_matches_the_kernel(cuda_device):
    import ctypes

    assert fr.kernel_layout() == (ctypes.sizeof(fr._Member),
                                  ctypes.sizeof(fr._Table))


@pytest.mark.needs_cuda
def test_cuda_library_selects_the_same_instantiation(cuda_device):
    """The library's tz_fused_region_threads / _smem answer what
    fr.instantiation says, for attention and SpMV tables."""
    import ctypes

    from tenzing_tpu_torch.ops import kernel_lib

    lib = kernel_lib.lib()
    spmv = [fr.MemberBody("copy", ("a", "b"), 10, 0, False)]
    for members in (_attn_members(), spmv):
        t = fr.RegionTable(members, 1).tables[0]
        want = fr.instantiation(members)
        assert lib.tz_fused_region_threads(ctypes.addressof(t)) == want["threads"]
        assert lib.tz_fused_region_smem(ctypes.addressof(t)) == want["smem_bytes"]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("chunks", [None, 2])
@pytest.mark.parametrize("tiles", [1, 2, 8])
def test_cuda_attention_region_matches_plain(cuda_device, chunks, tiles):
    """The attention bodies at head dim 128 (the kernel's instantiation):
    the fused naive order, plain or with every fold chunked, against the
    same order with plain regions at F32_STATE_TOL."""
    a = ra.RingAttnArgs(n_devices=2, batch=2, seq_local=256, head_dim=128)
    g = Graph()
    op = ra.BlockedAttention(a, impl_choice=True, chunk=bool(chunks),
                             chunk_relax=True)
    g.start_then(op)
    g.then_finish(op)
    bufs, want = ra.make_blocked_buffers(a, seed=1)
    tb = buffers_from_numpy(bufs, cuda_device)
    plat = Platform.make_n_lanes(1)
    seq = ra.fixed_order(g, plat, kernel_of=(
        (lambda s: f".xla.chunked.c{chunks}") if chunks else None))
    before = fr.LAUNCHES["fused_region"]
    out_k = fused.FusedExecutor(StreamExecutor(plat, tb), tiles=tiles).run(seq)
    out_p = fused.FusedExecutor(StreamExecutor(plat, tb, plain_kernels=True),
                                tiles=tiles).run(seq)
    assert fr.LAUNCHES["fused_region"] > before
    _state_close(out_k, out_p)
    np.testing.assert_allclose(out_k["O"].cpu().numpy(), want, rtol=2e-4,
                               atol=2e-5)
