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


def _lowered(g, host_names=()):
    """The member entries of each region of ``g``'s naive order, lowered at
    m=64 (runtime/fused.py ``lower_region``)."""
    bufs, _ = spmv.make_spmv_buffers(m=64, nnz_per_row=4, seed=1)
    shapes = {k: v.shape for k, v in bufs.items()}
    dtypes = {k: torch.from_numpy(v).dtype for k, v in bufs.items()}
    seq = _walk(g, Platform.make_n_lanes(1))
    return [fused.lower_region(r.members, shapes, dtypes) for k, r in
            fused.partition_regions(seq.vector(), set(host_names))
            if k == "region"]


def test_written_flags_mark_what_an_earlier_member_of_the_launch_wrote():
    """The lowering names the operands an earlier member of the region
    wrote (the kernel loads them through L2, the rest through the read-only
    L1 path): in the local-exchange region the exchange's send_buf,
    spmv_remote's x_remote (the exchange writes it, the remote SpMV gathers
    it whole after the barrier) and the add's inputs; in both host-exchange
    regions no ELL member is flagged, only the add's y_remote.  The table
    packs them into Member.written, bit i for operand i."""
    g, _ = _graphs(exchange="local")
    (local,) = _lowered(g)
    assert [(b.body, b.written) for b in local] == [
        ("ell", ()), ("gather", ()), ("copy", ("send_buf",)),
        ("ell", ("x_remote",)), ("add", ("y_local", "y_remote"))]
    t = fr.RegionTable(local, 1).tables[0]
    assert [t.m[k].written for k in range(t.n)] == [0, 0, 1, 4, 3]
    g, _ = _graphs(**DRIVER_KW)
    host = _lowered(g, spmv.spmv_host_buffer_names())
    assert [[(b.body, b.written) for b in r] for r in host] == [
        [("ell", ()), ("gather", ())], [("ell", ()), ("add", ("y_remote",))]]
    assert fr.written_flags([["a"], ["a", "b"], ["c", "b", "b"]],
                            [["b"], ["c"], ["d"]]) == [(), ("b",), ("c", "b")]


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
    seven int64 extents, the scale, the written-operand bits in what was
    the scale's pad, six operand pointers) after an 8-byte header
    (csrc/fused_region.cu ``Member`` / ``Table``); a region of more members
    than a table holds takes several tables."""
    import ctypes

    assert ctypes.sizeof(fr._Member) == 120
    assert [f for f, _ in fr._Member._fields_] == [
        "kind", "barrier", "rows", "width", "outer", "inner", "kv_rows",
        "key_off", "nkv", "scale", "written", "p"]
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
    """SpMV members take the slab-ring instantiation (a producer warp and
    four consumer warps, 160 threads; three stages of 128 rows x 32 vals
    and cols, + 16 bytes each, and their full and empty mbarriers), and a
    table never mixes the two (the kernel refuses it)."""
    spmv = [fr.MemberBody("ell", fr.OPERANDS["ell"], 10, 3, False),
            fr.MemberBody("copy", ("a", "b"), 10, 0, True)]
    assert fr.instantiation(spmv) == {"kind": "spmv", "threads": 160,
                                      "smem_bytes": 98_448}
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


# the slab ring's edges: (m, w, tiles, x written inside the region, the
# slabs' offset in elements into a larger buffer).  A tile's first row lo
# makes a chunk's slab start 16-byte aligned only where lo * w % 4 == 0: at
# 16 tiles m=1000, w=29 starts group 1 at row 62 (62 * 29 % 4 == 2) and
# m=70000, w=26 at row 4375; w = 1 packs several rows into a bulk copy's 16
# bytes; rows wider than 32 never go through the ring; m=1000 is no multiple
# of a 128-row chunk; a copy member writing x before the ELL member gathers
# it takes the L2 path after the barrier (one tile: the ELL member reads x
# whole); slabs that start off 16 bytes (``slab[1:]`` at w=26 starts 104
# bytes in, one element 4 bytes in) are read from global memory.
RING_CASES = [(1000, 29, 16, False, 0), (70000, 26, 16, False, 0),
              (70000, 26, 1, False, 0), (777, 1, 3, False, 0),
              (300, 40, 1, False, 0), (5000, 33, 2, False, 0),
              (1000, 29, 1, True, 0), (4096, 7, 1, True, 0),
              (70000, 26, 16, False, 26), (1000, 29, 1, False, 1)]


def _slab(host, off, device):
    """``host`` on ``device`` as a view ``off`` elements into a larger
    buffer (its data pointer 4 x ``off`` bytes past the allocation's)."""
    flat = torch.zeros(host.size + off, dtype=torch.from_numpy(host).dtype,
                       device=device)
    flat[off:] = torch.from_numpy(host.ravel()).to(device)
    return flat[off:].view(host.shape)


def _ring_case(device, m, w, tiles, x_written, signed, off=0):
    """(members, tiles, buffers) of one ring case: vals and x uniform in
    [0, 1) as the spmv workload's (models/spmv.py), or standard normal
    (``signed``), cols over an x of 4093; the slabs ``off`` elements into
    larger buffers."""
    rng = np.random.default_rng(m + w + tiles)
    n = 4093
    draw = rng.standard_normal if signed else rng.random
    host = {"vals": draw((m, w)).astype(np.float32),
            "cols": rng.integers(0, n, size=(m, w)).astype(np.int32),
            "x": draw(n).astype(np.float32),
            "x_src": draw(n).astype(np.float32),
            "y": np.zeros(m, np.float32)}
    bufs = {k: (_slab(v, off, device) if k in ("vals", "cols")
                else torch.from_numpy(v).to(device)) for k, v in host.items()}
    ell = fr.MemberBody("ell", ("vals", "cols", "x", "y"), m, w, x_written,
                        written=("x",) if x_written else ())
    members = [fr.MemberBody("copy", ("x_src", "x"), n, 0, False), ell] \
        if x_written else [ell]
    return members, fr.RegionTable(members, tiles), bufs


def _run_twice(table, bufs, tiles, device):
    counters = torch.zeros(2 * tiles, dtype=torch.int32, device=device)
    fr.fused_region(table, bufs, counters)
    first = bufs["y"].clone()
    fr.fused_region(table, bufs, counters)
    torch.cuda.synchronize()
    return first


def _float64_bound(bufs, w):
    """y in float64 and the rounding bound of the kernel's order: a row's
    entries fold into 8 partial sums (ceil(w / 8) roundings each) added as
    a 3-level tree, so |y - y64| <= (ceil(w / 8) + 3) u sum |v x| to first
    order, u = 2^-24."""
    v = bufs["vals"].double()
    t = v * bufs["x"].double()[bufs["cols"].long()]
    return t.sum(1), (-(-w // 8) + 3) * 2.0 ** -24 * t.abs().sum(1)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("m,w,tiles,x_written,off", RING_CASES,
                         ids=[f"m{c[0]}-w{c[1]}-t{c[2]}" + ("-xw" if c[3] else "")
                              + (f"-off{c[4]}" if c[4] else "")
                              for c in RING_CASES])
def test_cuda_spmv_ring_edges_match_plain(cuda_device, m, w, tiles, x_written,
                                          off):
    """An ELL member (behind a copy member that writes its x, where
    ``x_written``) through the kernel against region_plain at REGION_TOL
    and against the float64 product within its rounding bound, and two
    launches bit for bit."""
    members, table, bufs = _ring_case(cuda_device, m, w, tiles, x_written,
                                      signed=False, off=off)
    want = {k: v.clone() for k, v in bufs.items()}
    fr.region_plain(members, want, tiles)
    first = _run_twice(table, bufs, tiles, cuda_device)
    torch.testing.assert_close(bufs["y"], want["y"], **fr.REGION_TOL)
    assert torch.equal(bufs["y"], first)
    assert torch.equal(bufs["x"], want["x"])
    y64, bound = _float64_bound(bufs, w)
    assert bool(((bufs["y"].double() - y64).abs() <= bound).all())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("m,w,tiles", [(70000, 26, 16), (5000, 33, 2)])
def test_cuda_spmv_ring_signed_rows_within_rounding_bound(cuda_device, m, w,
                                                          tiles):
    """Rows of signed products cancel: two float32 orders (the kernel's and
    region_plain's ``torch.sum``) then differ by a few ulps of the partial
    sums, above REGION_TOL's atol where a row sums near 0.  The kernel is
    held against the float64 product within its order's rounding bound,
    and two launches bit for bit."""
    _, table, bufs = _ring_case(cuda_device, m, w, tiles, False, signed=True)
    first = _run_twice(table, bufs, tiles, cuda_device)
    assert torch.equal(bufs["y"], first)
    y64, bound = _float64_bound(bufs, w)
    assert bool(((bufs["y"].double() - y64).abs() <= bound).all())


def _flat_views(bufs):
    """``bufs`` with ``vals_flat`` / ``cols_flat``: flat views of the slabs
    (sharing their storage), as the copy members write them."""
    return {**bufs, "vals_flat": bufs["vals"].view(-1),
            "cols_flat": bufs["cols"].view(-1)}


def _written_case(device, case):
    """(members, tiles, buffers) of a region whose ELL member reads what an
    earlier member of the launch wrote, the old contents left where a
    stale read would find them (vals and x uniform in [0, 1)).

    ``x_after_l1``: a gather of 200000 random entries of x (every block
    reads most of x's lines through the read-only L1 path), a copy member
    overwriting x, and the ELL member gathering the new x (``written``: it
    loads x through L2; one tile, as it reads x whole).
    ``slab_written``: copy members writing vals and cols over flat views of
    the slabs at 16 tiles (m a multiple of 16, so a group's copy covers
    its own ELL rows), then the ELL member bulk-copying them (``written``:
    a proxy fence first, edge rows through L2).

    On an H100 a build whose ELL member loads x through L1 whatever
    ``written`` says, and skips the proxy fence, passes both cases too (the
    group barrier's fences leave no stale line to read): they hold the
    order of the writes and the reads, the L2 path and the fence are what
    the memory model asks for."""
    rng = np.random.default_rng(11)
    m, w, n = 70000, 26, 4093
    cols = rng.integers(0, n, size=(m, w)).astype(np.int32)
    host = {"vals": rng.random((m, w)).astype(np.float32),
            "cols": cols,
            "vals_src": rng.random(m * w).astype(np.float32),
            "cols_src": rng.integers(0, n, size=m * w).astype(np.int32),
            "x": rng.random(n).astype(np.float32),
            "x_src": rng.random(n).astype(np.float32),
            "idx": rng.integers(0, n, size=200_000).astype(np.int32),
            "gathered": np.zeros(200_000, np.float32),
            "y": np.zeros(m, np.float32)}
    bufs = _flat_views({k: torch.from_numpy(v).to(device)
                        for k, v in host.items()})
    if case == "x_after_l1":
        tiles = 1
        members = [
            fr.MemberBody("gather", ("x", "idx", "gathered"), 200_000, 0, False),
            fr.MemberBody("copy", ("x_src", "x"), n, 0, True),
            fr.MemberBody("ell", ("vals", "cols", "x", "y"), m, w, True,
                          written=("x",))]
    else:
        tiles = 16
        members = [
            fr.MemberBody("copy", ("vals_src", "vals_flat"), m * w, 0, False),
            fr.MemberBody("copy", ("cols_src", "cols_flat"), m * w, 0, False),
            fr.MemberBody("ell", ("vals", "cols", "x", "y"), m, w, True,
                          written=("vals", "cols"))]
    return members, tiles, bufs


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", ["x_after_l1", "slab_written"])
def test_cuda_spmv_ring_reads_what_the_launch_wrote(cuda_device, case):
    """An ELL member reads operands an earlier member of the same launch
    overwrote: it must see the new values (against region_plain at
    REGION_TOL, which runs the members in order), not lines an earlier
    member left in L1 or the slab's old contents; two launches bit for
    bit."""
    members, tiles, bufs = _written_case(cuda_device, case)
    table = fr.RegionTable(members, tiles)
    want = _flat_views({k: v.clone() for k, v in bufs.items()
                        if not k.endswith("_flat")})
    fr.region_plain(members, want, tiles)
    first = _run_twice(table, bufs, tiles, cuda_device)
    torch.testing.assert_close(bufs["y"], want["y"], **fr.REGION_TOL)
    assert torch.equal(bufs["y"], first)
    for name in ("x", "vals", "cols"):
        assert torch.equal(bufs[name], want[name]), name


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
