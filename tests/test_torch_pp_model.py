"""The pipeline-parallel forward and training step of the port
(tenzing_tpu_torch/models/pipeline.py) against the JAX package's
(tenzing_tpu/models/pipeline.py; reference tests test_pipeline.py).  (This
file's name keeps it apart from tests/test_torch_pipeline.py, which tests
bench/pipeline.py.)

* ``make_pipeline_buffers`` and ``make_train_buffers`` give the reference's
  arrays bit for bit;
* ``Pipeline`` (with and without ``chunk``) and ``PipelineTrain`` have the
  reference's vertices and edges; reference schedule JSON round-trips;
* over gloo at 1, 2 and 4 ``pp`` ranks the same DFS schedule JSONs run
  through the reference's ``TraceExecutor`` on the CPU mesh and through the
  port's ranks: Y agree within ``PARITY_TOL`` and within the reference
  dryrun's ``rtol=2e-4, atol=2e-5`` of the float64 stage stack; dW agree
  within ``TRAIN_PARITY_TOL`` (the port's gelu backward is
  ``aten.gelu_backward``, the reference's ``jax.vjp`` of the tanh gelu:
  the same derivative, other float32 steps) and within ``rtol=2e-3,
  atol=2e-5`` of the float64 backward, the port's also within
  ``dryrun.train_tol`` (which adds a relative rms limit);
* ``train_tol`` rejects a dW with one microbatch's gradient dropped and
  one rounded through float16, which the allclose alone accepts;
* the chunked stage partials match the float64 stack;
* dead slots: with every activation, gradient and output buffer NaN at the
  start, Y and dW are still the expected ones (a dead slot's result never
  reaches them).
"""

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
from tenzing_tpu.models import pipeline as ref
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu.solve import dfs as ref_dfs
from tenzing_tpu_torch.bench.gate import within
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.models import pipeline as pp
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.parallel.launch import launch
from tenzing_tpu_torch.solve.dfs import get_all_sequences, structural_variants
from tenzing_tpu_torch.verify import ScheduleVerifier

SEED = 0
TIMEOUT_S = 120.0
PARITY_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_PARITY_TOL = dict(rtol=1e-5, atol=1e-5)


def _args(n_pp, **kw):
    """The reference dryrun's pipeline widths."""
    return {**dict(n_pp=n_pp, n_microbatches=4, n_chains=2, mb_size=2,
                   d_model=8), **kw}


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


@pytest.mark.parametrize("n_pp", [1, 2, 4])
def test_buffers_equal_reference(n_pp):
    a = pp.PipelineArgs(**_args(n_pp, n_microbatches=8, mb_size=3))
    ra = ref.PipelineArgs(**asdict(a))
    for mk, rmk in ((pp.make_pipeline_buffers, ref.make_pipeline_buffers),
                    (pp.make_train_buffers, ref.make_train_buffers)):
        pb, ps, pw = mk(a, seed=2)
        rb, rs, rw = rmk(ra, seed=2)
        assert rb.keys() == pb.keys() == rs.keys() == ps.keys()
        for k in rb:
            assert rb[k].dtype == pb[k].dtype and np.array_equal(rb[k],
                                                                 pb[k]), k
            assert _norm(rs[k]) == _norm(ps[k]), k
        assert rw.dtype == pw.dtype and np.array_equal(rw, pw)


@pytest.mark.parametrize("which", ["forward", "chunked", "train"])
def test_graph_and_schedule_json_equal_reference(which):
    a = pp.PipelineArgs(**_args(2))
    ra = ref.PipelineArgs(**asdict(a))
    if which == "train":
        g = _wrap(pp.PipelineTrain(a), Graph())
        rg = _wrap(ref.PipelineTrain(ra), RefGraph())
    else:
        kw = dict(chunk=True, chunk_relax=True) if which == "chunked" else {}
        g = _wrap(pp.Pipeline(a, **kw), Graph())
        rg = _wrap(ref.Pipeline(ra, **kw), RefGraph())
    assert sorted(_shape(v) for v in structural_variants(g)) == sorted(
        _shape(v) for v in ref_dfs.structural_variants(rg))
    verifier = ScheduleVerifier(g)
    for st in ref_dfs.enumerate_schedules(rg, RefPlatform.make_n_lanes(2),
                                          max_seqs=4):
        js = ref_to_json(st.sequence)
        seq = sequence_from_json(js, g)
        assert sequence_to_json(seq) == js and verifier(seq).ok
    if which == "chunked":
        assert pp.stage_chunk_menu(a, relax=True) == ref.stage_chunk_menu(
            ra, relax=True)


def _ref_run(model, args, n, jsons):
    ra = ref.PipelineArgs(**args)
    if model == "pipeline":
        bufs, specs, want = ref.make_pipeline_buffers(ra, seed=SEED)
        comp, out = ref.Pipeline(ra), "Y"
    else:
        bufs, specs, want = ref.make_train_buffers(ra, seed=SEED)
        comp, out = ref.PipelineTrain(ra), "dW"
    plat = RefPlatform.make_n_lanes(
        2, mesh=JaxMesh(np.array(jax.devices()[:n]), ("pp",)), specs=specs)
    ex = TraceExecutor(plat, {k: jnp.asarray(v) for k, v in bufs.items()})
    g = _wrap(comp, RefGraph())
    return [np.asarray(ex.run(ref_from_json(js, g))[out]) for js in jsons], want


def _port_run(model, args, n, jsons, tmp_path, poison=()):
    return launch("tenzing_tpu_torch.parallel.dryrun:model_schedules", n,
                  "cpu", dict(model=model, args=args, schedules=jsons,
                              seed=SEED, poison=tuple(poison)),
                  timeout_s=TIMEOUT_S, workdir=str(tmp_path),
                  mesh_axes=("pp",), mesh_shape=(n,))[0]


def _dfs_jsons(model, args, n_sched=3):
    g, _, _, _, _, _ = dryrun.model_setup(model, args, {})
    return [sequence_to_json(st.sequence) for st in
            get_all_sequences(g, Platform.make_n_lanes(2), n_sched)]


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("model", ["pipeline", "pipeline_train"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_gloo_matches_reference_mesh(model, n, tmp_path):
    args = _args(n)
    jsons = _dfs_jsons(model, args, 2)
    ref_outs, want = _ref_run(model, args, n, jsons)
    port_outs = _port_run(model, args, n, jsons, tmp_path)
    tol = dryrun.ACT_TOL if model == "pipeline" else dryrun.TRAIN_TOL
    parity = PARITY_TOL if model == "pipeline" else TRAIN_PARITY_TOL
    assert len(port_outs) == len(ref_outs) == 2
    for po, ro in zip(port_outs, ref_outs):
        np.testing.assert_allclose(po, ro, **parity)
        np.testing.assert_allclose(ro, want, **tol)
        np.testing.assert_allclose(po, want, **tol)
        if model == "pipeline_train":
            ok, errs = within(torch.from_numpy(po), torch.from_numpy(want),
                              dryrun.train_tol(args, want))
            assert ok, errs


@pytest.mark.parametrize("n", [1, 2, 4])
def test_train_tol_rejects_the_controls(n):
    """dW's limit rejects one microbatch's gradient dropped and the
    expected dW rounded through float16; the float16 rounding is within
    ``TRAIN_TOL``'s allclose alone, so the relative rms is what holds it."""
    args = _args(n)
    controls = dryrun.train_controls(args)
    assert set(controls) == {"dropped_microbatch", "f16_rounded"}
    assert not any(c["within_tol"] for c in controls.values()), controls
    _, _, want = pp.make_train_buffers(pp.PipelineArgs(**args), seed=0)
    rounded = torch.from_numpy(want).to(torch.float16).double().numpy()
    np.testing.assert_allclose(rounded, want, **dryrun.TRAIN_TOL)
    assert controls["f16_rounded"]["rel_rms"] > dryrun.TRAIN_REL_RMS


def test_microbatch_gradients_sum_to_the_expected():
    """``microbatch_dw64`` summed over the microbatches is the expected dW
    (make_train_buffers is built on it)."""
    a = pp.PipelineArgs(**_args(2))
    bufs, _, want = pp.make_train_buffers(a, seed=0)
    w64 = bufs["W"].astype(np.float64)
    dw = sum(pp.microbatch_dw64(bufs[f"X_{c}"][j], w64,
                                bufs[f"target_{c}"][j])
             for j in range(a.chain_microbatches)
             for c in range(a.n_chains))
    np.testing.assert_allclose(dw, want, rtol=1e-6, atol=1e-7)


def test_gloo_chunked_stage_partials(tmp_path):
    """Every stage product split in 2 over its rows, at 2 ranks: Y within
    the dryrun's tolerance of the float64 stack."""
    args = dict(_args(2, mb_size=4), chunk=True)
    g, _, _, want, _, _ = dryrun.model_setup("pipeline", args, {})
    order = dryrun.engine_order(g, Platform.make_n_lanes(2),
                                lambda n: ".chunked.c2")
    ticks = pp.PipelineArgs(**_args(2, mb_size=4)).chain_ticks
    assert sum(op.name().endswith(".c2p1") for op in order) == 2 * ticks
    got = _port_run("pipeline", args, 2, [sequence_to_json(order)],
                    tmp_path)[0]
    np.testing.assert_allclose(got, want, **dryrun.ACT_TOL)


@pytest.mark.parametrize("model", ["pipeline", "pipeline_train"])
def test_dead_slots_never_reach_the_result(model, tmp_path):
    """Every buffer that only a dead slot reads before it is written starts
    as NaN on every rank; the collected Y and the accumulated dW are still
    the expected ones (4 ranks, 2 chains)."""
    args = _args(4)
    _, bufs, _, want, _, _ = dryrun.model_setup(model, args, {})
    poison = [k for k in bufs if k.startswith(("act_", "out_", "gout_"))]
    if model == "pipeline_train":
        poison += [k for k in bufs if k.startswith("stash_")]
    got = _port_run(model, args, 4, _dfs_jsons(model, args, 1), tmp_path,
                    poison)[0]
    tol = dryrun.ACT_TOL if model == "pipeline" else dryrun.TRAIN_TOL
    np.testing.assert_allclose(got, want, **tol)
