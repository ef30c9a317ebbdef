"""The mesh halo exchange of the port (``tenzing_tpu_torch/models/halo.py``
over ``parallel/``) against the JAX package's (``tenzing_tpu/models/halo.py``).

* ``add_to_graph`` / ``HaloExchange`` give the reference's vertices and
  edges, with and without the engine menu; ``make_halo_buffers`` gives the
  reference's arrays bit for bit, and ``make_local_halo_buffers`` each
  rank's block of them;
* schedule JSON written by the reference (its DFS, and its all-``.rdma``
  choice of the engine menu) deserializes in the port, serializes back
  unchanged and verifies;
* over gloo (parallel/launch.py) at 2x2x2 (8 processes), 2x1x1 and 4x1x1,
  the same schedule JSONs run through the reference's ``TraceExecutor`` on
  its CPU mesh (its ``.rdma`` posts in interpret mode) and through the
  port's ranks; the gathered U must equal the reference's and the expected
  array exactly (tolerance 0: the exchange is pure data movement), for the
  ``.xla`` engine, the ``.rdma`` engine and both mixed;
* a 3-axis mesh builds each axis's group from the ranks on its line; a
  collective post raises on a mesh whose ranks share one card; a rank that
  raises with its transfers in flight fails the launch within its timeout.

The spawned ranks import only the port; the reference runs in this
process."""

import time
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu.core.state import ChooseOp as RefChooseOp
from tenzing_tpu.core.state import State as RefState
from tenzing_tpu.models import halo as ref
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu.solve.dfs import get_all_sequences as ref_all_sequences
from tenzing_tpu.solve.dfs import structural_variants as ref_variants
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Mesh, MeshAxis, Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.models import halo
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.parallel.launch import launch
from tenzing_tpu_torch.parallel.mesh import axis_lines, coords_of
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.solve.dfs import structural_variants
from tenzing_tpu_torch.verify import ScheduleVerifier

TIMEOUT_S = 120.0
SEED = 0
# the reference tests' widths (tests/test_halo.py, tests/test_rdma.py)
ARGS = dict(nq=2, lx=4, ly=4, lz=4, radius=1)
ARGS_1D = dict(nq=1, lx=4, ly=4, lz=4, radius=2)


def _shape(g):
    names = sorted(v.name() for v in g.vertices())
    edges = sorted((a.name(), b.name()) for a in g.vertices() for b in g.succs(a))
    return names, edges


def _ref_graph(args, xfer_choice=False):
    if xfer_choice:
        return ref.add_to_graph(RefGraph(), args, xfer_choice=True)
    g = RefGraph()
    comp = ref.HaloExchange(args)
    g.start_then(comp)
    g.then_finish(comp)
    return g


def _ref_executor(args, mesh_shape, lanes=2):
    bufs, specs, want = ref.make_halo_buffers(mesh_shape, args, seed=SEED)
    devs = np.array(jax.devices()[:int(np.prod(mesh_shape))]).reshape(mesh_shape)
    plat = RefPlatform.make_n_lanes(lanes, mesh=JaxMesh(devs, ("x", "y", "z")),
                                    specs=specs)
    return plat, TraceExecutor(plat, {k: jnp.asarray(v) for k, v in bufs.items()}), want


def _ref_choose_all(g, plat, pick):
    """The reference's schedule taking, at each exchange choice, the
    alternative ending in ``pick(choice name)`` (tests/test_rdma.py)."""
    st = RefState(g)
    while not st.is_terminal():
        ds = st.get_decisions(plat)
        chosen = next((d for d in ds if isinstance(d, RefChooseOp)
                       and d.choice.name().endswith(pick(d.op.name()))), ds[0])
        st = st.apply(chosen)
    return st.sequence


ENGINES = {"xla": lambda n: ".xla", "rdma": lambda n: ".rdma",
           "mixed": lambda n: ".rdma" if n.endswith("x") else ".xla",
           "mixed-yz": lambda n: ".xla" if n.endswith("x") else ".rdma"}

# mesh shape -> (args, the reference's schedules): "dfs" its first 3 DFS
# schedules of HaloExchange, an engine name its choice of the engine menu.
# The port runs them all against the graph with the menu, where the DFS
# schedules' ops resolve as the .xla alternatives.
RUNS = {
    (2, 2, 2): (ARGS, ["dfs"] + list(ENGINES)),
    (4, 1, 1): (ARGS_1D, ["dfs"]),
    (2, 1, 1): (ARGS, list(ENGINES)),
}


def _ref_schedules(shape):
    args, which = RUNS[shape]
    rargs = ref.HaloArgs(**args)
    orders = []
    plat, ex, want = _ref_executor(rargs, shape)
    for w in which:
        if w == "dfs":
            g = _ref_graph(rargs)
            orders += [(w, st.sequence)
                       for st in ref_all_sequences(g, plat, max_seqs=3)]
        else:
            g = _ref_graph(rargs, xfer_choice=True)
            orders.append((w, _ref_choose_all(g, plat, ENGINES[w])))
    return orders, [np.asarray(ex.run(o)["U"]) for _, o in orders], want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each mesh shape: its schedules' labels and reference JSONs, the
    reference's U of each, the expected U, and the port's gathered U of
    each."""
    out = {}
    for shape, (args, _) in RUNS.items():
        orders, ref_us, want = _ref_schedules(shape)
        jsons = [ref_to_json(o) for _, o in orders]
        port_us = launch("tenzing_tpu_torch.parallel.dryrun:halo_schedules",
                         int(np.prod(shape)), "cpu",
                         dict(args=args, schedules=jsons, seed=SEED,
                              xfer_choice=True),
                         timeout_s=TIMEOUT_S,
                         workdir=str(tmp_path_factory.mktemp("launch")),
                         mesh_axes=dryrun.HALO_AXES, mesh_shape=shape)[0]
        out[shape] = ([w for w, _ in orders], jsons, ref_us, want, port_us)
    return out


def _pick(run, which):
    labels, jsons, ref_us, want, port_us = run
    keep = [i for i, w in enumerate(labels) if w in which]
    return ([jsons[i] for i in keep], [ref_us[i] for i in keep], want,
            [port_us[i] for i in keep])


def _hold(run):
    jsons, ref_us, want, port_us = run
    assert len(port_us) == len(ref_us) == len(jsons) >= 1
    for pu, ru in zip(port_us, ref_us):
        np.testing.assert_array_equal(ru, want)
        np.testing.assert_array_equal(pu, want)


# -- graph, buffers, serdes ---------------------------------------------------------


def test_graph_shape():
    g = halo.add_to_graph(Graph(), halo.HaloArgs())
    # 6 directions x (pack, post, await, unpack) + start/finish: the post and
    # the wait are separate vertices (reference Isend/Wait split)
    assert len(g.vertices()) == 26
    for d in halo.DIRECTIONS:
        n = halo.dir_name(d)
        pack = [v for v in g.vertices() if v.name() == f"pack_{n}"][0]
        assert [s.name() for s in g.succs(pack)] == [f"exchange_{n}.xla"]
        post = g.succs(pack)[0]
        assert [s.name() for s in g.succs(post)] == [f"await_{n}"]
    assert _shape(g) == _shape(ref.add_to_graph(RefGraph(), ref.HaloArgs()))


@pytest.mark.parametrize("xfer_choice", [False, True])
def test_graph_and_variants_equal_reference(xfer_choice):
    a = halo.HaloArgs(**ARGS)
    g = dryrun.halo_graph(a, xfer_choice=xfer_choice)
    rg = _ref_graph(ref.HaloArgs(**ARGS), xfer_choice=xfer_choice)
    assert _shape(g) == _shape(rg)
    port = sorted(_shape(v) for v in structural_variants(g))
    refv = sorted(_shape(v) for v in ref_variants(rg))
    assert port == refv
    assert len(port) == (2 ** 6 if xfer_choice else 1)


def test_unported_synth_raises():
    """``synth=True`` is ported (tests/test_torch_collectives.py); what
    still raises is a synthesized menu without the grid's extents, as in
    the reference."""
    with pytest.raises(ValueError, match="needs HaloArgs"):
        halo.ExchangeChoice((1, 0, 0), synth=True)
    names = [c.name() for c in halo.ExchangeChoice(
        (1, 0, 0), args=halo.HaloArgs(**ARGS), synth=True,
        synth_relax=True).choices()]
    assert names[:2] == ["exchange_px.xla", "exchange_px.rdma"]
    assert names[2:] == ["exchange_px.synthed.neighbor.c1",
                         "exchange_px.synthed.neighbor.c2"]
    bufs, _, _ = halo.make_halo_buffers((1, 1, 1), halo.HaloArgs(**ARGS),
                                        synth=True)
    assert "exchange_px.neighbor1.x0.snd" in bufs


@pytest.mark.parametrize("mesh_shape,args", [
    ((2, 2, 2), ARGS), ((4, 1, 1), ARGS_1D), ((2, 1, 1), ARGS),
    ((1, 1, 1), dict(nq=3, lx=5, ly=4, lz=6, radius=2)),
    ((1, 3, 2), dict(nq=2, lx=3, ly=5, lz=4, radius=1))])
def test_buffers_equal_reference(mesh_shape, args):
    bufs, specs, want = halo.make_halo_buffers(mesh_shape, halo.HaloArgs(**args),
                                               seed=SEED)
    rbufs, rspecs, rwant = ref.make_halo_buffers(mesh_shape,
                                                 ref.HaloArgs(**args), seed=SEED)
    assert bufs.keys() == rbufs.keys() == specs.keys() == rspecs.keys()
    for k in bufs:
        assert bufs[k].dtype == rbufs[k].dtype and np.array_equal(bufs[k],
                                                                  rbufs[k]), k
        assert specs[k] == tuple(rspecs[k]) == halo.HALO_SPEC
    assert np.array_equal(want, rwant)
    # each rank's block, without the global arrays
    for r in range(int(np.prod(mesh_shape))):
        c = coords_of(r, mesh_shape)
        lbufs, lwant = halo.make_local_halo_buffers(mesh_shape, c,
                                                    halo.HaloArgs(**args), SEED)

        def block(a):
            e = [a.shape[1 + i] // mesh_shape[i] for i in range(3)]
            return a[:, c[0] * e[0]:(c[0] + 1) * e[0],
                     c[1] * e[1]:(c[1] + 1) * e[1],
                     c[2] * e[2]:(c[2] + 1) * e[2]]

        assert np.array_equal(lwant, block(want))
        for k in lbufs:
            assert np.array_equal(lbufs[k], block(bufs[k])), k


@pytest.mark.parametrize("engine", list(ENGINES))
def test_reference_rdma_mesh_schedule_json_round_trips(engine):
    a = ref.HaloArgs(**ARGS)
    rg = _ref_graph(a, xfer_choice=True)
    order = _ref_choose_all(rg, RefPlatform.make_n_lanes(2), ENGINES[engine])
    js = ref_to_json(order)
    g = dryrun.halo_graph(halo.HaloArgs(**ARGS), xfer_choice=True)
    seq = sequence_from_json(js, g)
    assert sequence_to_json(seq) == js
    assert ScheduleVerifier(g)(seq).ok
    posts = [j for j in js if j.get("name", "").startswith("exchange_")]
    assert len(posts) == 6
    if engine == "rdma":
        assert {j["kind"] for j in posts} == {"rdma_shift_start"}
        assert sorted(j["collective_id"] for j in posts) == list(range(6))
    # the reference verifier accepts it too (ExchangeChoice resolves by name)
    from tenzing_tpu.verify import ScheduleVerifier as RefVerifier

    assert RefVerifier(rg)(ref_from_json(js, rg)).ok


def test_reference_dfs_schedules_round_trip():
    rg = _ref_graph(ref.HaloArgs(**ARGS))
    g = dryrun.halo_graph(halo.HaloArgs(**ARGS))
    verifier = ScheduleVerifier(g)
    for st in ref_all_sequences(rg, RefPlatform.make_n_lanes(2), max_seqs=3):
        js = ref_to_json(st.sequence)
        seq = sequence_from_json(js, g)
        assert sequence_to_json(seq) == js and verifier(seq).ok
        assert {j["kind"] for j in js if j.get("name", "").startswith("exchange_")} \
            == {"permute_start"}


# -- gloo parity with the reference's CPU mesh ------------------------------------------


@pytest.mark.needs_shard_map
def test_halo_exchange_correct_2x2x2(runs):
    jsons, ref_us, want, port_us = _pick(runs[(2, 2, 2)], {"dfs"})
    _hold(([jsons[0]], ref_us[:1], want, port_us[:1]))


@pytest.mark.needs_shard_map
def test_halo_exchange_schedules_agree(runs):
    picked = _pick(runs[(2, 2, 2)], {"dfs"})
    assert len(picked[0]) == 3
    _hold(picked)


@pytest.mark.needs_shard_map
def test_halo_1d_mesh(runs):
    # degenerate 4x1x1 mesh: only x faces move data across ranks
    _hold(_pick(runs[(4, 1, 1)], {"dfs"}))


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 1, 1)],
                         ids=["2x2x2-menu", "2x1x1-menu"])
def test_halo_mesh_exchange_menu_both_engines_correct(shape, runs):
    """Both engines, and both mixes, fill every ghost face with the periodic
    neighbour's interior edge."""
    picked = _pick(runs[shape], set(ENGINES))
    jsons = picked[0]
    kinds = [{j["kind"] for j in js if j.get("name", "").startswith("exchange_")}
             for js in jsons]
    assert kinds[0] == {"permute_start"} and kinds[1] == {"rdma_shift_start"}
    assert kinds[2] == kinds[3] == {"permute_start", "rdma_shift_start"}
    _hold(picked)


# -- the mesh, the shared card, faults ---------------------------------------------------


def test_mesh_axis_groups_hold_the_lines(tmp_path):
    """Each axis of a 2x2x2 mesh has the group of the ranks that share the
    other two coordinates, in coordinate order; ranks lie row-major."""
    shape = (2, 2, 2)
    rows = launch("tenzing_tpu_torch.parallel.launch:probe_mesh", 8, "cpu",
                  timeout_s=TIMEOUT_S, workdir=str(tmp_path),
                  mesh_axes=dryrun.HALO_AXES, mesh_shape=shape)
    for rank, axes in rows:
        c = coords_of(rank, shape)
        for k, name in enumerate(dryrun.HALO_AXES):
            size, index, ranks = axes[name]
            assert (size, index) == (shape[k], c[k])
            line = next(ln for ln in axis_lines(shape, k) if rank in ln)
            assert ranks == line
    assert axis_lines(shape, 0) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert axis_lines(shape, 2) == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_mesh_size_one_axes_have_no_group(tmp_path):
    rows = launch("tenzing_tpu_torch.parallel.launch:probe_mesh", 2, "cpu",
                  timeout_s=TIMEOUT_S, workdir=str(tmp_path),
                  mesh_axes=dryrun.HALO_AXES, mesh_shape=(2, 1, 1))
    for rank, axes in rows:
        assert axes["x"] == (2, rank, [0, 1])
        assert axes["y"] == (1, 0, None) and axes["z"] == (1, 0, None)


def test_xla_post_raises_in_the_shared_card_mode():
    """On a mesh whose ranks share one card over gloo, a collective post
    raises instead of moving device tensors through the host."""
    a = halo.HaloArgs(**ARGS)
    bufs, want = halo.make_local_halo_buffers((1, 1, 1), (0, 0, 0), a, SEED)
    mesh = Mesh({n: MeshAxis(size=1, index=0) for n in dryrun.HALO_AXES},
                shared_card=True)
    plat = Platform.make_n_lanes(2, mesh=mesh)
    ex = StreamExecutor(plat, buffers_from_numpy(bufs, "cpu"), device="cpu")
    g = dryrun.halo_graph(a, xfer_choice=True)
    orders = dryrun.engine_orders(g, plat)
    with pytest.raises(RuntimeError, match="share one card"):
        ex.run(orders["xla"])
    # the .rdma engine is what such ranks exchange through
    out = ex.run(orders["rdma"])
    assert torch.equal(out["U"], torch.from_numpy(want))


def test_launch_modes_are_checked():
    with pytest.raises(ValueError, match="shared_card needs"):
        launch("tenzing_tpu_torch.parallel.launch:probe_mesh", 2, "cpu",
               shared_card=True)
    with pytest.raises(ValueError, match="does not hold"):
        launch("tenzing_tpu_torch.parallel.launch:probe_mesh", 2, "cpu",
               mesh_axes=dryrun.HALO_AXES, mesh_shape=(2, 2, 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="visible"):
            launch("tenzing_tpu_torch.parallel.launch:probe_mesh", 2, "cuda",
                   shared_card=True)


def test_rank_raising_mid_exchange_fails_the_launch(tmp_path):
    """Rank 1 posts its exchanges and raises before awaiting them; rank 0
    waits in the exchange.  The launch fails with rank 1's error well inside
    its timeout and leaves no rank running."""
    a = halo.HaloArgs(**ARGS)
    plat = Platform.make_n_lanes(2)
    order = dryrun.engine_orders(dryrun.halo_graph(a, xfer_choice=True),
                                 plat)["rdma"]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="un-awaited transfers"):
        launch("tenzing_tpu_torch.parallel.dryrun:halo_schedules", 2, "cpu",
               dict(args=asdict(a), schedules=[sequence_to_json(order)],
                    xfer_choice=True, fail_rank=1),
               timeout_s=TIMEOUT_S, workdir=str(tmp_path),
               mesh_axes=dryrun.HALO_AXES, mesh_shape=(2, 1, 1))
    assert time.monotonic() - t0 < TIMEOUT_S / 2
    assert not list(tmp_path.iterdir())


def test_dryrun_halo_stages_on_two_ranks():
    """``python -m tenzing_tpu_torch.parallel.dryrun --model halo`` on 2
    gloo ranks: the agreement, the search with the engine menu (both
    engines' U exact) and the ranks' search."""
    s = dryrun.halo_main(2, "cpu", mcts_iters=3)
    assert s["mesh"] == [2, 1, 1] and s["backend"] == "gloo"
    engines = {tuple(r["engines"]) for r in s["schedules"]}
    assert ("rdma",) * 6 in engines and ("xla",) * 6 in engines
    assert all(r["u_exact"] and r["verified"] for r in s["schedules"])
    assert s["explore_menu"]["rollouts"] == 3
    assert s["explore_ranks"]["ranks_agree"]
    assert dryrun.halo_mesh_shape(8) == (2, 2, 2)
    assert dryrun.halo_mesh_shape(12) == (2, 2, 3)
    assert dryrun.halo_mesh_shape(1) == (1, 1, 1)


# -- the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.needs_cuda
def test_cuda_mesh_halo_world_one(cuda_device):
    """World size 1 over NCCL: both engines (the .rdma one the loopback)
    exact at a small width, and the searches complete."""
    s = dryrun.world_one("cuda", {"args": ARGS, "mcts_iters": 3},
                         fn=dryrun.halo_rank_main, axes=dryrun.HALO_AXES)
    assert all(r["u_exact"] for r in s["schedules"])
    rdma_rows = [r for r in s["schedules"] if set(r["engines"]) == {"rdma"}]
    assert rdma_rows and all(r["launches"]["device_copy"] == 6
                             for r in rdma_rows)
