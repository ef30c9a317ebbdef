"""The expert-parallel MoE layer of the port (tenzing_tpu_torch/models/moe.py,
parallel/) against the JAX package's (tenzing_tpu/models/moe.py).

* ``make_moe_buffers`` gives the reference's arrays bit for bit;
* ``MoELayer``'s vertices and edges, and those of every structural variant,
  are the reference's, with and without ``impl_choice`` and ``chunk``;
* reference schedule JSON deserializes in the port and serializes back
  unchanged, and the verifier accepts it;
* over gloo, at n_ep = 2 and 4 (and a mid size at 2), the same schedule
  JSONs run through the reference's ``TraceExecutor`` on the CPU mesh
  (tests/conftest.py; its ``.pallas`` slot in interpret mode) and through
  the port's ranks (parallel/launch.py); their gathered Y agree at
  ``rtol = atol = 1e-5`` (both sum in float32, in different orders) and each
  is within the reference's ``rtol=2e-4, atol=2e-5`` of the float64 dense
  evaluation (tests/test_moe.py);
* the chunked expert partials at n_ep = 4 (``chunk_relax=True``) agree the
  same way;
* a rank that raises while the others sit in a collective fails the launch
  within its timeout;
* a bf16 layer (``MoEArgs(dtype="bfloat16")``): its buffers are the
  reference's values, and at n_ep = 1 and 2 the port's Y (its ``.pallas``
  slot on the bf16 ``ffn_rows``) and the reference's (W1 / W2 cast to bf16
  on both sides) agree within ``dryrun.Y_TOL_BF16``, as each does with the
  float64 dense evaluation cast to bf16, while a control with one expert's
  output dropped fails it; at most 1% of Y's elements may differ from the
  reference's at all (each slot rounds where the reference rounds).

The spawned ranks import only the port; the reference runs in this
process.  ``test_cuda_layer_world_one`` needs the card (``needs_cuda``)."""

import time
from dataclasses import asdict

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu.models import moe as ref
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu.solve import dfs as ref_dfs
from tenzing_tpu_torch.core.chunking import chunks_of
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.models import moe
from tenzing_tpu_torch.ops.comm_ops import AllToAllStart
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.parallel.launch import launch
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.solve.dfs import enumerate_schedules, structural_variants
from tenzing_tpu_torch.verify import ScheduleVerifier

SEED = 1
TIMEOUT_S = 120.0
PARITY_TOL = dict(rtol=1e-5, atol=1e-5)


def _args(nep, **kw):
    return moe.MoEArgs(n_ep=nep, **{**dryrun.DRYRUN_ARGS, **kw})


def _ref_graph(args, **kw):
    g = RefGraph()
    layer = ref.MoELayer(ref.MoEArgs(**asdict(args)), **kw)
    g.start_then(layer)
    g.then_finish(layer)
    return g


def _shape(g):
    names = sorted(v.name() for v in g.vertices())
    edges = sorted((a.name(), b.name()) for a in g.vertices() for b in g.succs(a))
    return names, edges


def _ref_run(args, jsons, **kw):
    """The reference's Y for each schedule JSON, on an n_ep-device CPU mesh
    (a bf16 layer's float64 W1 / W2 cast to bf16, as the port places them)."""
    bufs, specs, want = ref.make_moe_buffers(ref.MoEArgs(**asdict(args)),
                                             seed=SEED)
    if args.dtype == "bfloat16":
        bufs = {k: v.astype(ml_dtypes.bfloat16) if v.dtype == np.float64
                else v for k, v in bufs.items()}
    mesh = JaxMesh(np.array(jax.devices()[:args.n_ep]), ("ep",))
    plat = RefPlatform.make_n_lanes(2, mesh=mesh, specs=specs)
    ex = TraceExecutor(plat, {k: jnp.asarray(v) for k, v in bufs.items()})
    g = _ref_graph(args, **kw)
    return [np.asarray(ex.run(ref_from_json(js, g))["Y"]) for js in jsons], want


def _port_run(args, jsons, tmp_path, **kw):
    return launch("tenzing_tpu_torch.parallel.dryrun:run_schedules",
                  args.n_ep, "cpu",
                  dict(args=asdict(args), schedules=jsons, seed=SEED, **kw),
                  timeout_s=TIMEOUT_S, workdir=str(tmp_path))[0]


def _hold(port_ys, ref_ys, want):
    assert len(port_ys) == len(ref_ys)
    for py, ry in zip(port_ys, ref_ys):
        np.testing.assert_allclose(py, ry, **PARITY_TOL)
        np.testing.assert_allclose(ry, want, **dryrun.Y_TOL)
        np.testing.assert_allclose(py, want, **dryrun.Y_TOL)


# -- buffers, graph, serdes -----------------------------------------------------


@pytest.mark.parametrize("nep", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_buffers_equal_reference(nep, seed):
    a = _args(nep)
    bufs, specs, want = moe.make_moe_buffers(a, seed=seed)
    rbufs, rspecs, rwant = ref.make_moe_buffers(ref.MoEArgs(**asdict(a)),
                                                seed=seed)
    assert bufs.keys() == rbufs.keys() == specs.keys() == rspecs.keys()
    for k in bufs:
        assert bufs[k].dtype == rbufs[k].dtype, k
        assert np.array_equal(bufs[k], rbufs[k]), k
        # every reference spec splits dim 0 over "ep"; the port says so
        assert tuple(rspecs[k])[0] == "ep" and specs[k] == "ep", k
    assert want.dtype == rwant.dtype and np.array_equal(want, rwant)


@pytest.mark.parametrize("impl_choice", [False, True])
@pytest.mark.parametrize("chunk", [False, True])
def test_graph_equals_reference(impl_choice, chunk):
    a = _args(4)
    kw = dict(impl_choice=impl_choice, chunk=chunk, chunk_relax=True)
    assert _shape(moe.MoELayer(a, **kw).graph()) == _shape(
        ref.MoELayer(ref.MoEArgs(**asdict(a)), **kw).graph())
    port = sorted(_shape(g) for g in structural_variants(
        dryrun.layer_graph(a, **kw)))
    refv = sorted(_shape(g) for g in ref_dfs.structural_variants(
        _ref_graph(a, **kw)))
    assert port == refv
    # per chunk: .xla (and .pallas), and the .xla chunked c2 and c4
    assert len(port) == ((2 if impl_choice else 1) + (2 if chunk else 0)) ** 2


def test_chunk_menu_and_unported_synth():
    full = moe.MoEArgs(n_ep=1, tokens_per_shard=8192, d_model=512, d_ff=2048,
                       n_chunks=4)
    assert moe.ffn_chunk_menu(full) == ([1], {})  # pow2_counts(1)
    a = _args(4)
    assert moe.ffn_chunk_menu(a, relax=True) == \
        ref.ffn_chunk_menu(ref.MoEArgs(**asdict(a)), relax=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        moe.MoELayer(a, synth=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        moe.make_moe_buffers(a, synth=True)


@pytest.mark.parametrize("impl_choice", [False, True])
def test_reference_schedule_json_round_trips(impl_choice):
    a = _args(2)
    rg = _ref_graph(a, impl_choice=impl_choice)
    states = ref_dfs.enumerate_schedules(rg, RefPlatform.make_n_lanes(2),
                                         max_seqs=6)
    g = dryrun.layer_graph(a, impl_choice=impl_choice)
    verifier = ScheduleVerifier(g)
    kinds = set()
    for st in states:
        js = ref_to_json(st.sequence)
        seq = sequence_from_json(js, g)
        assert sequence_to_json(seq) == js
        assert verifier(seq).ok
        kinds |= {j["kind"] for j in js}
        a2a = [j for j in js if j["kind"] == "all_to_all_start"]
        assert a2a and all(j["axis"] == "ep" and j["split_axis"] == 0
                           for j in a2a)
    assert {"all_to_all_start", "await_transfer"} <= kinds


def test_collective_needs_a_mesh():
    a = _args(1)
    bufs, _, _ = moe.make_moe_buffers(a, seed=0)
    bufs = {k: v.astype(np.float32) if v.dtype.kind == "f" else v
            for k, v in bufs.items()}
    plat = Platform.make_n_lanes(1)
    ex = StreamExecutor(plat, buffers_from_numpy(bufs, "cpu"), device="cpu")
    order = dryrun.pick_schedules(dryrun.layer_graph(a), plat, 1)[0]
    with pytest.raises(RuntimeError, match="needs a platform mesh"):
        ex.run(order)
    with pytest.raises(TypeError, match="post_collective"):
        AllToAllStart("a2a", "s", "d", "ep", split_axis=0).apply({}, None)


# -- gloo parity with the reference's CPU mesh --------------------------------------


# the reference dryrun's width, and a mid size
MID = dict(tokens_per_shard=64, d_model=64, d_ff=128)


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("nep,width", [(2, {}), (4, {}), (2, MID)],
                         ids=["n2-dryrun", "n4-dryrun", "n2-mid"])
def test_gloo_layer_matches_reference_mesh(nep, width, tmp_path):
    a = _args(nep, **width)
    orders = dryrun.pick_schedules(dryrun.layer_graph(a, impl_choice=True),
                                   Platform.make_n_lanes(2))
    slots = [dryrun.ffn_slots(o) for o in orders]
    assert len(orders) == 3 and {".xla", ".pallas"} <= {s for x in slots for s in x}
    jsons = [sequence_to_json(o) for o in orders]
    ref_ys, want = _ref_run(a, jsons, impl_choice=True)
    _hold(_port_run(a, jsons, tmp_path, impl_choice=True), ref_ys, want)


@pytest.mark.needs_shard_map
def test_gloo_chunked_partials_match_reference_mesh(tmp_path):
    a = _args(4)
    kw = dict(chunk=True, chunk_relax=True)
    g = dryrun.layer_graph(a, **kw)
    plat = Platform.make_n_lanes(2)
    states = enumerate_schedules(g, plat, max_seqs=len(structural_variants(g)),
                                 log=lambda m: None)
    picked = []
    for n in (2, 4):
        order = next(st.sequence for st in states
                     if set(chunks_of(st.sequence).values()) == {n}
                     and len(chunks_of(st.sequence)) == a.n_chunks)
        assert ScheduleVerifier(g)(order).ok
        picked.append(order)
    jsons = [sequence_to_json(o) for o in picked]
    ref_ys, want = _ref_run(a, jsons, **kw)
    _hold(_port_run(a, jsons, tmp_path, **kw), ref_ys, want)


def test_raising_rank_fails_the_launch_within_its_timeout(tmp_path):
    """Rank 0 cannot encode a set as JSON and raises; rank 1 waits in the
    broadcast.  The launch must fail with rank 0's error, long before the
    timeout, and leave no rank running."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="not JSON serializable"):
        launch("tenzing_tpu_torch.parallel.launch:probe_control_plane", 2,
               "cpu", dict(obj={1, 2}), timeout_s=TIMEOUT_S,
               workdir=str(tmp_path))
    assert time.monotonic() - t0 < TIMEOUT_S / 2
    assert not list(tmp_path.iterdir())  # the launch directory is gone


# -- bf16 -------------------------------------------------------------------------------


@pytest.mark.parametrize("nep", [1, 2])
def test_bf16_buffers_hold_the_reference_values(nep):
    a = _args(nep, dtype="bfloat16")
    bufs, specs, want = moe.make_moe_buffers(a, seed=SEED)
    rbufs, _, rwant = ref.make_moe_buffers(ref.MoEArgs(**asdict(a)), seed=SEED)
    assert bufs.keys() == rbufs.keys()
    for k in bufs:
        # numpy holds no bf16 here: the reference's bf16 arrays are float32
        # arrays of the same values in the port (W1 / W2 are float64 in both)
        want_dt = np.float32 if rbufs[k].dtype == ml_dtypes.bfloat16 \
            else rbufs[k].dtype
        assert bufs[k].dtype == want_dt, k
        assert np.array_equal(bufs[k], rbufs[k].astype(want_dt)), k
    assert np.array_equal(want, rwant.astype(np.float32))


def test_bf16_pallas_slot_declares_the_xla_slots_bf16_h():
    """The bf16 layer's .pallas slot declares a bf16 (n_ep * C, d_ff)
    workspace for the kernel's h, under the name, shape and dtype the bf16
    .xla slot gives its own bf16 h, so the two alternatives of a chunk share
    it; the f32 slots share their float32 ``moe_h_<c>`` the same way."""
    for dtype, name in (("bfloat16", "moe_hb_1"), ("float32", "moe_h_1")):
        a = _args(2, dtype=dtype)
        shapes = {"recv_disp_1": (2, 24, a.d_model),
                  "W1": (1, a.d_model, a.d_ff)}
        pal = moe.ExpertFFNPallas("ffn_1.pallas", 1, a).scratch_for(shapes)
        xla = moe.ExpertFFN("ffn_1.xla", 1, a).scratch_for(shapes)
        assert pal == {name: ((48, a.d_ff), dtype)}
        assert xla[name] == pal[name]


def _bf16_err(y, want):
    return dryrun.y_error(torch.from_numpy(np.asarray(y, np.float32)),
                          torch.from_numpy(np.asarray(want, np.float32)))


def _within_bf16(err):
    return (err["rel_rms"] <= dryrun.Y_TOL_BF16["rel_rms"]
            and err["max_abs"] <= dryrun.Y_TOL_BF16["max_abs"])


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("nep", [1, 2])
def test_gloo_bf16_layer_matches_reference_mesh(nep, tmp_path):
    a = _args(nep, dtype="bfloat16")
    orders = dryrun.pick_schedules(dryrun.layer_graph(a, impl_choice=True),
                                   Platform.make_n_lanes(2))
    slots = {s for o in orders for s in dryrun.ffn_slots(o)}
    assert {".xla", ".pallas"} <= slots
    jsons = [sequence_to_json(o) for o in orders]
    ref_ys, want = _ref_run(a, jsons, impl_choice=True)
    want = want.astype(np.float32)
    port_ys = _port_run(a, jsons, tmp_path, impl_choice=True)
    assert len(port_ys) == len(ref_ys) == len(orders)
    bufs, _, _ = moe.make_moe_buffers(a, seed=SEED)
    for py, ry in zip(port_ys, ref_ys):
        ry = ry.astype(np.float32)
        assert _within_bf16(_bf16_err(py, ry))
        # both slots round where the reference rounds: at most a summation
        # order's worth of elements may land one bf16 ulp apart (an .xla
        # slot that rounded x @ W1 to bf16 before the gelu moved ~half)
        assert np.count_nonzero(py != ry) <= 0.01 * py.size
        assert _within_bf16(_bf16_err(ry, want))
        assert _within_bf16(_bf16_err(py, want))
        # the control: every token routed to expert 0 loses its output
        ctl = py.copy()
        t, tc = a.tokens_per_shard, a.chunk_tokens
        for c in range(a.n_chunks):
            idx, w = bufs[f"disp_idx_{c}"], bufs[f"disp_w_{c}"]
            for s_ in range(a.n_ep):
                ctl[s_ * t + c * tc + idx[s_, 0][w[s_, 0] > 0]] = 0.0
        assert not _within_bf16(_bf16_err(ctl, want))


# -- the card -------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.needs_cuda
def test_cuda_layer_world_one(cuda_device):
    """The layer at world size 1 over NCCL at d_model 512 (the kernel's
    width): an .xla and a .pallas schedule within the tolerance, the
    .pallas one through ffn_rows."""
    summary = dryrun.world_one(
        "cuda", {"args": dict(n_ep=1, tokens_per_shard=256, d_model=512,
                              d_ff=2048, n_chunks=2),
                 "mcts_iters": 2})
    rows = summary["schedules"]
    assert all(r["within_tol"] for r in rows)
    assert any(".pallas" in r["ffn_slots"] and r["ffn_rows_launches"] > 0
               for r in rows)
    assert summary["explore"]["rollouts"] >= 1


@pytest.mark.needs_cuda
def test_cuda_bf16_layer_world_one(cuda_device):
    """The bf16 layer at world size 1 over NCCL at d_model 512: every
    schedule within the bf16 tolerance, the .pallas ones through the bf16
    ffn_rows."""
    from tenzing_tpu_torch.ops import ffn_kernels as fk

    before = fk.LAUNCHES["ffn_rows_bf16"]
    summary = dryrun.world_one(
        "cuda", {"args": dict(n_ep=1, tokens_per_shard=256, d_model=512,
                              d_ff=2048, n_chunks=2, dtype="bfloat16"),
                 "mcts_iters": 2})
    rows = summary["schedules"]
    assert all(r["within_tol"] and r["dtype"] == "bfloat16" for r in rows)
    assert fk.LAUNCHES["ffn_rows_bf16"] > before
