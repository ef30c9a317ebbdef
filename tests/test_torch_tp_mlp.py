"""The tensor-parallel MLP of the port (tenzing_tpu_torch/models/tp_mlp.py)
against the JAX package's (tenzing_tpu/models/tp_mlp.py; reference tests
test_tp_mlp.py).

* ``make_tp_mlp_buffers`` gives the reference's arrays bit for bit, on the
  ``("tp",)`` and the ``("dp", "tp")`` layouts;
* ``TpMlp``'s vertices and edges, and those of every structural variant
  with ``chunk=True``, are the reference's; reference schedule JSON
  round-trips; the chunk menu's counts are the reference's (its prices use
  the card's NVLink figure, not a v5e's), and at ``n_tp=1`` ``synth=True``
  offers no menu (tests/test_torch_collectives.py holds the synthesized
  all-reduces);
* over gloo at 1, 2 and 4 ``tp`` ranks, and on the 2 x 2 ``("dp", "tp")``
  mesh, the same DFS schedule JSONs run through the reference's
  ``TraceExecutor`` on the CPU mesh and through the port's ranks: Y agree
  within ``PARITY_TOL`` and each is within the reference dryrun's
  ``rtol=2e-4, atol=2e-5`` of the float64 layer stack;
* the chunked layer partials (every layer split in 2 and in 4) are held to
  the float64 stack at the same tolerance and to the unsplit schedule at
  :func:`summation_limit` (the reference's own fold test is not ground
  truth: it fails at ``rtol=1e-6``, ROADMAP Queue 3 item 3);
* a ``("dp", "tp")`` mesh of 2 x 1: the psum over the size-1 ``tp`` axis is
  a copy (no group of its own; the default group would sum the dp ranks).
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu.models import tp_mlp as ref
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu.solve import dfs as ref_dfs
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.models import tp_mlp
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.parallel.launch import launch
from tenzing_tpu_torch.solve.dfs import get_all_sequences, structural_variants
from tenzing_tpu_torch.utils.numeric import gelu_tanh
from tenzing_tpu_torch.verify import ScheduleVerifier

SEED = 0
TIMEOUT_S = 120.0
# both sum the same float32 products in different orders (BLAS blocking)
PARITY_TOL = dict(rtol=1e-5, atol=1e-6)
U32 = 2.0 ** -24  # float32 unit roundoff


def _args(n_tp, dp=1, **kw):
    """The reference dryrun's TP widths for ``n_tp`` ranks and ``dp`` rows
    per chunk; ``kw`` overrides (``n_dp`` for the dryrun's 2-D layout)."""
    base = dict(n_layers=2, n_chunks=2, mb_size=2 * dp, d_model=8,
                d_ff=16 * n_tp)
    return {**base, "n_tp": n_tp, **kw}


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


@pytest.mark.parametrize("n_tp,n_dp", [(1, 1), (2, 1), (4, 1), (2, 2), (1, 2)])
def test_buffers_equal_reference(n_tp, n_dp):
    a = tp_mlp.TpMlpArgs(**_args(n_tp, n_dp))  # n_dp rows per chunk
    rb, rs, rw = ref.make_tp_mlp_buffers(ref.TpMlpArgs(**asdict(a)), seed=3,
                                         n_dp=n_dp)
    pb, ps, pw = tp_mlp.make_tp_mlp_buffers(a, seed=3, n_dp=n_dp)
    assert rb.keys() == pb.keys() == rs.keys() == ps.keys()
    for k in rb:
        assert rb[k].dtype == pb[k].dtype and np.array_equal(rb[k], pb[k]), k
        assert _norm(rs[k]) == _norm(ps[k]), k
    assert rw.dtype == pw.dtype and np.array_equal(rw, pw)


@pytest.mark.parametrize("chunk", [False, True])
def test_graph_and_schedule_json_equal_reference(chunk):
    a = tp_mlp.TpMlpArgs(**_args(2))
    kw = dict(chunk=chunk, chunk_relax=chunk)
    g = _wrap(tp_mlp.TpMlp(a, **kw), Graph())
    rg = _wrap(ref.TpMlp(ref.TpMlpArgs(**asdict(a)), **kw), RefGraph())
    port = sorted(_shape(v) for v in structural_variants(g))
    refv = sorted(_shape(v) for v in ref_dfs.structural_variants(rg))
    assert port == refv
    verifier = ScheduleVerifier(g)
    for st in ref_dfs.enumerate_schedules(rg, RefPlatform.make_n_lanes(2),
                                          max_seqs=8):
        js = ref_to_json(st.sequence)
        seq = sequence_from_json(js, g)
        assert sequence_to_json(seq) == js and verifier(seq).ok


def test_chunk_menu_and_unported_synth():
    a = tp_mlp.TpMlpArgs(**_args(2, mb_size=8))
    ra = ref.TpMlpArgs(**asdict(a))
    assert tp_mlp.mlp_chunk_menu(a, relax=True) == ref.mlp_chunk_menu(
        ra, relax=True)
    counts, est = tp_mlp.mlp_chunk_menu(tp_mlp.TpMlpArgs(**dryrun.TP_FULL))
    assert counts[0] == 1 and all(n in (1, 2, 4) for n in counts)
    assert set(est) == set(counts) - {1}
    # at tp = 1 the all-reduce has no decomposition: no menu, no staging
    one = tp_mlp.TpMlpArgs(**_args(1))
    assert tp_mlp.tp_mlp_synth_plans(one, 0, 0) == []
    plain = _shape(_wrap(tp_mlp.TpMlp(one), Graph()))
    assert _shape(_wrap(tp_mlp.TpMlp(one, synth=True), Graph())) == plain
    assert (tp_mlp.make_tp_mlp_buffers(one, synth=True)[0].keys()
            == tp_mlp.make_tp_mlp_buffers(one)[0].keys())


def _ref_run(args, axes, shape, jsons, chunk=False):
    a = dict(args)
    n_dp = a.pop("n_dp", 1)
    ra = ref.TpMlpArgs(**a)
    bufs, specs, want = ref.make_tp_mlp_buffers(ra, seed=SEED, n_dp=n_dp)
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    plat = RefPlatform.make_n_lanes(2, mesh=JaxMesh(devs, axes), specs=specs)
    ex = TraceExecutor(plat, {k: jnp.asarray(v) for k, v in bufs.items()})
    g = _wrap(ref.TpMlp(ra, chunk=chunk, chunk_relax=chunk), RefGraph())
    return [np.asarray(ex.run(ref_from_json(js, g))["Y"]) for js in jsons], want


def _port_run(args, axes, shape, jsons, tmp_path):
    return launch("tenzing_tpu_torch.parallel.dryrun:model_schedules",
                  int(np.prod(shape)), "cpu",
                  dict(model="tp_mlp", args=args, schedules=jsons, seed=SEED),
                  timeout_s=TIMEOUT_S, workdir=str(tmp_path), mesh_axes=axes,
                  mesh_shape=shape)[0]


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("axes,shape", [(("tp",), (1,)), (("tp",), (2,)),
                                        (("tp",), (4,)),
                                        (("dp", "tp"), (2, 2))],
                         ids=["tp1", "tp2", "tp4", "dp2xtp2"])
def test_gloo_matches_reference_mesh(axes, shape, tmp_path):
    n_dp = shape[0] if len(shape) == 2 else 1
    args = _args(shape[-1], n_dp, **({"n_dp": n_dp} if n_dp > 1 else {}))
    g, _, _, _, _, _ = dryrun.model_setup("tp_mlp", args, {})
    orders = [st.sequence for st in
              get_all_sequences(g, Platform.make_n_lanes(2), 3)]
    jsons = [sequence_to_json(o) for o in orders]
    ref_ys, want = _ref_run(args, axes, shape, jsons)
    port_ys = _port_run(args, axes, shape, jsons, tmp_path)
    assert len(port_ys) == len(ref_ys) == 3
    for py, ry in zip(port_ys, ref_ys):
        np.testing.assert_allclose(py, ry, **PARITY_TOL)
        np.testing.assert_allclose(ry, want, **dryrun.ACT_TOL)
        np.testing.assert_allclose(py, want, **dryrun.ACT_TOL)


def summation_limit(args, seed=SEED) -> np.ndarray:
    """The largest change of the unsharded float32 layer stack's Y that
    summing its products in another order can make, to first order: a
    k-term float32 dot product moves by at most 2 (k - 1) u sum|terms|
    (u = 2^-24), so layer l adds ``2 (d - 1) u |x| |W1|`` through the tanh
    gelu (slope below 1.13) and ``2 (d_ff - 1) u |h| |W2|``, each carried
    through the later layers by ``|W1| * 1.13 * |W2|``; a row split reorders
    no more than that."""
    a = tp_mlp.TpMlpArgs(**args)
    bufs, _, _ = tp_mlp.make_tp_mlp_buffers(a, seed=seed)
    x = np.concatenate([bufs[f"X_{c}"] for c in range(a.n_chunks)])
    w1 = bufs["W1"].astype(np.float64)
    w2 = bufs["W2"].astype(np.float64)
    y = x.astype(np.float64)
    err = np.zeros_like(y)
    for layer in range(a.n_layers):
        pre = y @ w1[layer]
        h = gelu_tanh(pre)
        e_pre = err @ np.abs(w1[layer]) + 2 * (a.d_model - 1) * U32 * (
            np.abs(y) @ np.abs(w1[layer]))
        e_h = 1.13 * e_pre
        err = e_h @ np.abs(w2[layer]) + 2 * (a.d_ff - 1) * U32 * (
            np.abs(h) @ np.abs(w2[layer]))
        y = h @ w2[layer]
    return err


@pytest.mark.needs_shard_map
def test_gloo_chunked_partials(tmp_path):
    """Every layer split in 2 and in 4 over its batch rows, at 2 tp ranks:
    within the dryrun's tolerance of the float64 stack and of the
    reference's same schedule, and within :func:`summation_limit` of the
    unsplit schedule."""
    args = _args(2, mb_size=8)
    cargs = dict(args, chunk=True)
    g, _, _, _, _, _ = dryrun.model_setup("tp_mlp", cargs, {})
    plat = Platform.make_n_lanes(2)
    orders = [dryrun.engine_order(g, plat, lambda n, c=c: f".chunked.c{c}")
              for c in (2, 4)]
    for o, c in zip(orders, (2, 4)):
        assert sum(op.name().endswith(f".c{c}p0") for op in o) == 4, c
    # the unsplit alternative is named as the op itself
    orders.append(dryrun.engine_order(g, plat,
                                      lambda n: n[:-len(".chunks")]))
    assert not any(".c2p" in op.name() or ".c4p" in op.name()
                   for op in orders[-1])
    jsons = [sequence_to_json(o) for o in orders]
    ref_ys, want = _ref_run(args, ("tp",), (2,), jsons, chunk=True)
    port_ys = launch("tenzing_tpu_torch.parallel.dryrun:model_schedules", 2,
                     "cpu", dict(model="tp_mlp", args=cargs, schedules=jsons,
                                 seed=SEED),
                     timeout_s=TIMEOUT_S, workdir=str(tmp_path),
                     mesh_axes=("tp",), mesh_shape=(2,))[0]
    limit = np.tile(summation_limit(_args(1, mb_size=8, d_ff=32)), (2, 1))
    unsplit = port_ys[-1]
    for py, ry in zip(port_ys, ref_ys):
        np.testing.assert_allclose(py, want, **dryrun.ACT_TOL)
        np.testing.assert_allclose(ry, want, **dryrun.ACT_TOL)
        np.testing.assert_allclose(py, ry, **PARITY_TOL)
        assert np.all(np.abs(py - unsplit) <= limit)


def test_psum_on_a_size_one_axis_of_a_2d_mesh(tmp_path):
    """dp 2 x tp 1: each dp rank's Y is its own rows' stack, not the sum
    of both dp ranks' partials."""
    args = _args(1, 2, n_dp=2)
    g, _, _, want, _, _ = dryrun.model_setup("tp_mlp", args, {})
    jsons = [sequence_to_json(get_all_sequences(g, Platform.make_n_lanes(2),
                                                1)[0].sequence)]
    got = _port_run(args, ("dp", "tp"), (2, 1), jsons, tmp_path)
    np.testing.assert_allclose(got[0], want, **dryrun.ACT_TOL)
