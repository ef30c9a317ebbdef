"""The irregular-exchange SpMV of the port
(tenzing_tpu_torch/models/spmv_irregular.py) against the JAX package's
(tenzing_tpu/models/spmv_irregular.py; reference tests
test_spmv_irregular.py), and ``AllToAllStart`` on every split axis.

* the negotiated plan (steps, widths, offsets, lists) and
  ``make_irregular_spmv_buffers`` are the reference's bit for bit, with and
  without ``impl_choice``, on random, band and diagonal matrices (the port
  renumbers the remote columns on whole arrays, the reference entry by
  entry);
* ``IrregularSpMV``'s vertices and edges, and those of every structural
  variant of its exchange menu, are the reference's; reference schedule
  JSON round-trips;
* over gloo on ``("dp", "sp")`` meshes of 1, 2 and 4 ranks the same
  schedule JSONs, one per exchange (permute, padded all-to-all, shift),
  run through the reference's ``TraceExecutor`` on the CPU mesh and
  through the port's ranks: Y agree within ``PARITY_TOL`` and each is
  within the reference's ``rtol=2e-3`` of the float64 host product;
* ``AllToAllStart`` at ``split_axis`` 0, 1 and 2 over 2 and 4 ranks equals
  the all-to-all computed with numpy, and on an axis of size 1 of a 2-D mesh
  it is a copy; a world of one rank posts the psum and the all-to-all
  through its group;
* the schedule space holds a compute between a post and its await.

``test_cuda_shift_distances`` (the shift kernel at shifts 1-3 between 4
ranks sharing the card, several collective ids) and
``test_cuda_exchanges_refuse_a_shared_card`` need the card."""

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
from tenzing_tpu.models import spmv as ref_spmv
from tenzing_tpu.models import spmv_irregular as ref
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu.solve import dfs as ref_dfs
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.models import spmv_irregular as irr
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.parallel.launch import launch
from tenzing_tpu_torch.solve.dfs import get_all_sequences, structural_variants
from tenzing_tpu_torch.verify import ScheduleVerifier

SEED = 0
TIMEOUT_S = 120.0
PARITY_TOL = dict(rtol=1e-5, atol=1e-6)

# (kind, size, nnz, seed): the reference tests' matrices
MATRICES = [("random", 64, 500, 3), ("random", 64, 600, 1),
            ("band", 64, 400, 2), ("band", 64, 200, 4),
            ("random", 32, 200, 7), ("random", 48, 300, 2)]


def _spec(kind, m, nnz, seed):
    """The dryrun's matrix entry; a band matrix has half-bandwidth 7 (the
    reference's band test) or 0 (its block-diagonal test)."""
    if kind == "band":
        return dict(kind="band", m=m, bw=7 if seed == 2 else 0, nnz=nnz,
                    seed=seed)
    return dict(kind="random", m=m, n=m, nnz=nnz, seed=seed)


def _ref_matrix(spec):
    if spec["kind"] == "band":
        return ref_spmv.random_band_matrix(spec["m"], spec["bw"], spec["nnz"],
                                           seed=spec["seed"])
    return ref_spmv.random_matrix(spec["m"], spec["n"], spec["nnz"],
                                  seed=spec["seed"])


def _norm(spec):
    return tuple(None if a is None or a == () else
                 ((a,) if isinstance(a, str) else tuple(a))
                 for a in tuple(spec))


def _wrap(comp, g):
    g.start_then(comp)
    g.then_finish(comp)
    return g


def _shape(g):
    names = sorted(v.name() for v in g.vertices())
    edges = sorted((a.name(), b.name()) for a in g.vertices()
                   for b in g.succs(a))
    return names, edges


@pytest.mark.parametrize("mat", MATRICES, ids=lambda m: f"{m[0]}{m[1]}s{m[3]}")
@pytest.mark.parametrize("nsp", [2, 4])
def test_plan_and_buffers_equal_reference(mat, nsp):
    spec = _spec(*mat)
    for ic in (False, True):
        rb, rs, rw, rp = ref.make_irregular_spmv_buffers(
            _ref_matrix(spec), nsp, batch=3, seed=SEED, impl_choice=ic)
        pb, ps, pw, pp = irr.make_irregular_spmv_buffers(
            dryrun.irregular_matrix(spec), nsp, batch=3, seed=SEED,
            impl_choice=ic)
        assert (rp.steps, rp.widths, rp.offsets, rp.halo_width) == (
            pp.steps, pp.widths, pp.offsets, pp.halo_width)
        for d in rp.steps:
            assert all(np.array_equal(a, b) for a, b in
                       zip(rp.send_lists[d], pp.send_lists[d]))
        assert rb.keys() == pb.keys() == rs.keys() == ps.keys()
        for k in rb:
            assert rb[k].dtype == pb[k].dtype and np.array_equal(rb[k],
                                                                 pb[k]), k
            assert _norm(rs[k]) == _norm(ps[k]), k
        assert np.array_equal(rw, pw)


def test_negotiation_covers_every_remote_column():
    a = dryrun.irregular_matrix(_spec("random", 64, 500, 3))
    plan = irr.negotiate_exchange(a, 4)
    for p in range(4):
        lo, hi = p * 16, (p + 1) * 16
        rows = a.retain_rows(lo, hi)
        remote = np.unique(rows.cols[(rows.cols < lo) | (rows.cols >= hi)])
        got = np.concatenate([plan.send_lists[d][p] for d in plan.steps]
                             + [np.array([], dtype=np.int64)])
        assert sorted(got) == sorted(remote.tolist())
        for d in plan.steps:
            assert all(plan.owner(c) == (p - d) % 4
                       for c in plan.send_lists[d][p])
            slots = plan.halo_slots(p, plan.send_lists[d][p])
            assert list(slots) == [plan.halo_slot(p, c)
                                   for c in plan.send_lists[d][p]]
    band = irr.negotiate_exchange(
        dryrun.irregular_matrix(_spec("band", 64, 400, 2)), 4)
    assert set(band.steps) <= {1, 3}
    assert irr.negotiate_exchange(
        dryrun.irregular_matrix(_spec("band", 64, 200, 4)), 4).steps == []


@pytest.mark.parametrize("impl_choice", [False, True])
def test_graph_and_schedule_json_equal_reference(impl_choice):
    spec = _spec("random", 64, 600, 1)
    plan = irr.negotiate_exchange(dryrun.irregular_matrix(spec), 4)
    assert plan.steps == [1, 2, 3]
    kw = dict(widths=plan.widths, impl_choice=impl_choice)
    g = _wrap(irr.IrregularSpMV(plan.steps, **kw), Graph())
    rg = _wrap(ref.IrregularSpMV(plan.steps, **kw), RefGraph())
    port = sorted(_shape(v) for v in structural_variants(g))
    refv = sorted(_shape(v) for v in ref_dfs.structural_variants(rg))
    assert port == refv and len(port) == (3 if impl_choice else 1)
    verifier = ScheduleVerifier(g)
    kinds = set()
    for st in ref_dfs.enumerate_schedules(rg, RefPlatform.make_n_lanes(2),
                                          max_seqs=9):
        js = ref_to_json(st.sequence)
        seq = sequence_from_json(js, g)
        assert sequence_to_json(seq) == js and verifier(seq).ok
        kinds |= {j["kind"] for j in js}
        assert all(j.get("split_axis", 1) == 1 for j in js
                   if j["kind"] == "all_to_all_start")
    assert ({"permute_start", "all_to_all_start", "rdma_shift_start"}
            <= kinds) == impl_choice


def _ref_run(args, shape, jsons, impl_choice):
    bufs, specs, want, plan = ref.make_irregular_spmv_buffers(
        _ref_matrix(args["matrix"]), shape[1], batch=args["batch"], seed=SEED,
        impl_choice=impl_choice)
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    plat = RefPlatform.make_n_lanes(2, mesh=JaxMesh(devs, ("dp", "sp")),
                                    specs=specs)
    ex = TraceExecutor(plat, {k: jnp.asarray(v) for k, v in bufs.items()})
    g = _wrap(ref.IrregularSpMV(plan.steps, widths=plan.widths,
                                impl_choice=impl_choice), RefGraph())
    return [np.asarray(ex.run(ref_from_json(js, g))["Y"]) for js in jsons], want


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2), (1, 4)],
                         ids=["1x1", "1x2", "2x2", "1x4"])
def test_gloo_exchanges_match_reference_mesh(shape, tmp_path):
    dp, sp = shape
    spec = _spec("random", 16 * sp, 40 * sp, 2)
    impl = sp > 1  # one rank exchanges nothing: no menu
    args = dict(matrix=spec, batch=2 * dp, impl_choice=impl)
    g, _, _, _, _, _ = dryrun.model_setup("spmv_irregular", args,
                                          {"sp": sp, "dp": dp})
    if impl:
        orders = dryrun.pick_model_schedules(g, Platform.make_n_lanes(2),
                                             "menu")
        assert [dryrun.exchange_of(o) for o in orders] == [
            "permute", "a2a", "rdma"]
    else:
        orders = [st.sequence for st in
                  get_all_sequences(g, Platform.make_n_lanes(2), 2)]
    jsons = [sequence_to_json(o) for o in orders]
    ref_ys, want = _ref_run(args, shape, jsons, impl)
    port_ys = launch("tenzing_tpu_torch.parallel.dryrun:model_schedules",
                     dp * sp, "cpu", dict(model="spmv_irregular", args=args,
                                          schedules=jsons, seed=SEED),
                     timeout_s=TIMEOUT_S, workdir=str(tmp_path),
                     mesh_axes=("dp", "sp"), mesh_shape=shape)[0]
    assert len(port_ys) == len(ref_ys) == len(jsons)
    for py, ry in zip(port_ys, ref_ys):
        np.testing.assert_allclose(py, ry, **PARITY_TOL)
        np.testing.assert_allclose(ry, want, **dryrun.SPMV_TOL)
        np.testing.assert_allclose(py, want, **dryrun.SPMV_TOL)


def _a2a_numpy(x, n, split):
    """The all-to-all of a global array stacked by rank along dim 0 (n
    blocks): block q of rank r's result along ``split`` is block r of rank
    q's input."""
    blocks = np.split(x, n, axis=0)
    parts = [np.split(b, n, axis=split) for b in blocks]
    return np.concatenate([np.concatenate([parts[q][r] for q in range(n)],
                                          axis=split) for r in range(n)],
                          axis=0)


@pytest.mark.parametrize("n", [2, 4])
def test_all_to_all_every_split_axis(n, tmp_path):
    rng = np.random.default_rng(n)
    cases, want = [], []
    for split in (0, 1, 2):
        shape = [3, 5, 2]
        shape[split] = 2 * n  # two rows per peer along the split axis
        x = rng.standard_normal((n * shape[0],) + tuple(shape[1:])).astype(
            np.float32)
        cases.append(dict(kind="a2a", axis="ep", spec=("ep",), x=x,
                          split_axis=split))
        want.append(_a2a_numpy(x, n, split))
    got = launch("tenzing_tpu_torch.parallel.dryrun:comm_cases", n, "cpu",
                 dict(cases=cases), timeout_s=TIMEOUT_S,
                 workdir=str(tmp_path))[0]
    for g_, w in zip(got, want):
        assert np.array_equal(g_, w)


def test_size_one_collectives_are_copies(tmp_path):
    """On a ``("dp", "sp")`` mesh of 2 x 1 the ``sp`` axis has size 1 and no
    group of its own: its all-to-all, psum and permute are copies (the
    default group would mix the dp ranks)."""
    x = np.arange(2 * 2 * 3 * 2, dtype=np.float32).reshape(4, 3, 2)
    cases = [dict(kind=k, axis="sp", spec=("dp",), x=x, split_axis=1)
             for k in ("a2a", "psum", "permute")]
    got = launch("tenzing_tpu_torch.parallel.dryrun:comm_cases", 2, "cpu",
                 dict(cases=cases), timeout_s=TIMEOUT_S,
                 workdir=str(tmp_path), mesh_axes=("dp", "sp"),
                 mesh_shape=(2, 1))[0]
    for g_ in got:
        assert np.array_equal(g_, x)


@pytest.mark.parametrize("kind", ["psum", "a2a0", "a2a1"])
def test_world_of_one_posts_through_its_group(kind, monkeypatch):
    """A world of one rank has a group (``init_mesh`` gives its axis the
    default group): the psum and the all-to-all are posted through it, as
    at any size; only an axis with no group of its own (a size-1 axis of a
    larger mesh) takes the copy."""
    import torch.distributed as dist

    from tenzing_tpu_torch.ops.comm_ops import AllToAllStart, Done, PsumStart
    from tenzing_tpu_torch.runtime.executor import BufferShapes

    calls = []

    def posted(name):
        def post(*args, group=None, async_op=False):
            calls.append((name, group))
            if name == "all_to_all_single":
                args[0].copy_(args[1])
            return Done()
        return post

    monkeypatch.setattr(dist, "all_reduce", posted("all_reduce"))
    monkeypatch.setattr(dist, "all_to_all_single",
                        posted("all_to_all_single"))
    x = torch.arange(24, dtype=torch.float32).reshape(1, 4, 6)
    if kind == "psum":
        op, scratch = PsumStart("p", "x", "y", "sp"), {}
    else:
        op = AllToAllStart("a", "x", "y", "sp", split_axis=int(kind[-1]))
        shapes = BufferShapes({"x": tuple(x.shape)}, {"x": "float32"})
        scratch = {n: torch.zeros(shape)
                   for n, (shape, _) in op.scratch_for(shapes).items()}
    world = object()
    for group in (world, None):
        bufs = {"x": x, "y": torch.zeros_like(x)}
        op.launch(bufs, group, 1, scratch).wait()
        assert torch.equal(bufs["y"], x)
    assert [g for _, g in calls] == [world]


def test_post_wait_overlap_orderings_exist():
    spec = _spec("random", 32, 200, 5)
    plan = irr.negotiate_exchange(dryrun.irregular_matrix(spec), 4)
    g = _wrap(irr.IrregularSpMV(plan.steps), Graph())
    found = False
    for st in get_all_sequences(g, Platform.make_n_lanes(1), 400):
        ops = [op.name() for op in st.sequence.vector()]
        for d in plan.steps:
            between = ops[ops.index(f"permute_{d}") + 1:ops.index(f"await_{d}")]
            if any(o.startswith(("spmv_local", "gather_")) for o in between):
                found = True
        if found:
            break
    assert found, "no schedule overlaps compute with an in-flight permute"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.needs_cuda
def test_cuda_shift_distances(cuda_device, tmp_path):
    """The shift kernel between 4 ranks sharing GPU 0 at shifts 1, 2 and 3,
    each with a collective id of its own, against ``np.roll`` of the
    blocks; every rank posts and waits each distance."""
    n = 4
    x = np.arange(n * 8 * 16, dtype=np.float32).reshape(n * 8, 16)
    cases = [dict(kind="rdma", axis="ep", spec=("ep",), x=x, shift=d)
             for d in (1, 2, 3, 1)]
    got = launch("tenzing_tpu_torch.parallel.dryrun:comm_cases", n, "cuda",
                 dict(cases=cases), timeout_s=TIMEOUT_S,
                 workdir=str(tmp_path), shared_card=True)[0]
    for c, g_ in zip(cases, got):
        want = np.roll(x.reshape(n, 8, 16), c["shift"], axis=0).reshape(x.shape)
        assert np.array_equal(g_, want), c["shift"]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("model,args", [
    ("spmv_dist", dict(n_sp=2, batch=1, rows_per_shard=64, nnz_per_row=4)),
    ("spmv_irregular", dict(matrix=dict(kind="random", m=32, n=32, nnz=80,
                                        seed=2), batch=1)),
], ids=["dist", "irregular"])
def test_cuda_exchanges_refuse_a_shared_card(model, args, cuda_device,
                                            tmp_path):
    """On ranks sharing one card the in-op exchanges (distributed SpMV) and
    the permute posts (irregular SpMV) raise: gloo cannot move device
    tensors, and nothing falls back."""
    g, _, _, _, _, _ = dryrun.model_setup(model, args, {"sp": 2, "dp": 1})
    order = get_all_sequences(g, Platform.make_n_lanes(2), 1)[0].sequence
    with pytest.raises(RuntimeError, match="share one card"):
        launch("tenzing_tpu_torch.parallel.dryrun:model_schedules", 2, "cuda",
               dict(model=model, args=args,
                    schedules=[sequence_to_json(order)]),
               timeout_s=TIMEOUT_S, workdir=str(tmp_path),
               mesh_axes=("dp", "sp"), mesh_shape=(1, 2), shared_card=True)

