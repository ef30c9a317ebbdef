"""The distributed SpMV of the port (tenzing_tpu_torch/models/spmv_dist.py,
its in-op neighbour exchanges, ops/comm_ops.py ``lane_permute``) against the
JAX package's (tenzing_tpu/models/spmv_dist.py; reference tests
test_multichip.py).

* ``make_dist_spmv_buffers`` gives the reference's arrays bit for bit (the
  port builds the slabs on whole arrays, the reference entry by entry);
* ``DistSpMV``'s vertices and edges are the reference's, and reference
  schedule JSON round-trips through the port;
* over gloo on ``("dp", "sp")`` meshes of 1, 2 and 4 ranks (1 x 1, 1 x 2,
  2 x 2) the same DFS schedule JSONs run through the reference's
  ``TraceExecutor`` on the CPU mesh and through the port's ranks; the
  gathered Y agree within ``PARITY_TOL`` (both sum float32 products of at
  most 2 * nnz_per_row terms, in different orders) and each is within the
  reference dryrun's ``rtol=2e-3`` of the float64 host product;
* on an axis of size 1 both exchanges give zeros (the open permutation has
  no pair), without a process group;
* an exchange on an axis of size > 1 refuses ranks that share one card;
* on the card (``needs_cuda``) the size-1 exchanges (the distributed
  SpMV's zero fills, the ring's) are captured as CUDA graphs and replay
  bit for bit as the eager run, and at size > 1 the capture raises
  ``CaptureError`` naming the op.

The ranks import only the port; the reference runs in this process."""

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
from tenzing_tpu.models import spmv_dist as ref
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu.solve.dfs import get_all_sequences as ref_sequences
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Mesh, MeshAxis, Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.models import spmv_dist
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.parallel.launch import launch
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.solve.dfs import get_all_sequences
from tenzing_tpu_torch.verify import ScheduleVerifier

SEED = 0
TIMEOUT_S = 120.0
PARITY_TOL = dict(rtol=1e-5, atol=1e-6)


def _graph(comp):
    """Start -> ``comp`` -> Finish, in ``comp``'s package."""
    port = comp.__class__.__module__.startswith("tenzing_tpu_torch")
    g = Graph() if port else RefGraph()
    g.start_then(comp)
    g.then_finish(comp)
    return g


def _shape(g):
    names = sorted(v.name() for v in g.vertices())
    edges = sorted((a.name(), b.name()) for a in g.vertices()
                   for b in g.succs(a))
    return names, edges


def _norm(spec):
    """A reference PartitionSpec or a port spec as one tuple of axis tuples
    per dim."""
    return tuple(None if a is None or a == () else
                 ((a,) if isinstance(a, str) else tuple(a))
                 for a in tuple(spec))


@pytest.mark.parametrize("args", [(1, 2, 64, 4, 0), (2, 4, 64, 4, 0),
                                  (4, 3, 32, 8, 5), (3, 1, 16, 2, 1)])
def test_buffers_equal_reference(args):
    rb, rs, rw = ref.make_dist_spmv_buffers(*args)
    pb, ps, pw = spmv_dist.make_dist_spmv_buffers(*args)
    assert rb.keys() == pb.keys() == rs.keys() == ps.keys()
    for k in rb:
        assert rb[k].dtype == pb[k].dtype and np.array_equal(rb[k], pb[k]), k
        assert _norm(rs[k]) == _norm(ps[k]), k
    assert rw.dtype == pw.dtype and np.array_equal(rw, pw)


def test_graph_and_schedule_json_equal_reference():
    assert _shape(spmv_dist.DistSpMV().graph()) == _shape(
        ref.DistSpMV().graph())
    rg = _graph(ref.DistSpMV())
    g = _graph(spmv_dist.DistSpMV())
    verifier = ScheduleVerifier(g)
    states = ref_sequences(rg, RefPlatform.make_n_lanes(2), max_seqs=8)
    assert len(states) == 8
    for st in states:
        js = ref_to_json(st.sequence)
        seq = sequence_from_json(js, g)
        assert sequence_to_json(seq) == js
        assert verifier(seq).ok


def _ref_run(args, shape, jsons):
    bufs, specs, want = ref.make_dist_spmv_buffers(**args, seed=SEED)
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    plat = RefPlatform.make_n_lanes(2, mesh=JaxMesh(devs, ("dp", "sp")),
                                    specs=specs)
    ex = TraceExecutor(plat, {k: jnp.asarray(v) for k, v in bufs.items()})
    g = _graph(ref.DistSpMV())
    return [np.asarray(ex.run(ref_from_json(js, g))["Y"]) for js in jsons], want


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2)],
                         ids=["1x1", "1x2", "2x2"])
def test_gloo_matches_reference_mesh(shape, tmp_path):
    dp, sp = shape
    args = dict(n_sp=sp, batch=2 * dp, rows_per_shard=64, nnz_per_row=4)
    g = _graph(spmv_dist.DistSpMV())
    orders = [st.sequence for st in
              get_all_sequences(g, Platform.make_n_lanes(2), 3)]
    jsons = [sequence_to_json(o) for o in orders]
    ref_ys, want = _ref_run(args, shape, jsons)
    port_ys = launch("tenzing_tpu_torch.parallel.dryrun:model_schedules",
                     dp * sp, "cpu", dict(model="spmv_dist", args=args,
                                          schedules=jsons, seed=SEED),
                     timeout_s=TIMEOUT_S, workdir=str(tmp_path),
                     mesh_axes=("dp", "sp"), mesh_shape=shape)[0]
    assert len(port_ys) == len(ref_ys) == 3
    for py, ry in zip(port_ys, ref_ys):
        np.testing.assert_allclose(py, ry, **PARITY_TOL)
        np.testing.assert_allclose(ry, want, **dryrun.SPMV_TOL)
        np.testing.assert_allclose(py, want, **dryrun.SPMV_TOL)


def _one_rank_executor(args, shared_card=False, size=1):
    """A single-rank executor on a hand-built mesh (no process group: an
    axis of size 1 needs none; a larger one is never reached here)."""
    bufs, specs, want = spmv_dist.make_dist_spmv_buffers(**args, seed=SEED)
    mesh = Mesh({"dp": MeshAxis(1, 0), "sp": MeshAxis(size, 0)},
                shared_card=shared_card)
    from tenzing_tpu_torch.parallel.mesh import shard_of

    local = {k: shard_of(v, specs[k], mesh) for k, v in bufs.items()}
    plat = Platform.make_n_lanes(2, mesh=mesh, specs=specs)
    ex = StreamExecutor(plat, buffers_from_numpy(local, "cpu"), device="cpu")
    return ex, want


def test_size_one_exchanges_are_zeros():
    args = dict(n_sp=1, batch=2, rows_per_shard=64, nnz_per_row=4)
    ex, want = _one_rank_executor(args)
    ex.init_bufs["x_left"].fill_(7.0)
    ex.init_bufs["x_right"].fill_(7.0)
    ex._initial = {k: t.clone() for k, t in ex.init_bufs.items()}
    order = get_all_sequences(_graph(spmv_dist.DistSpMV()),
                              Platform.make_n_lanes(2), 1)[0].sequence
    out = ex.run(order)
    assert not out["x_left"].any() and not out["x_right"].any()
    assert not out["Y_rem"].any()
    np.testing.assert_allclose(out["Y"].numpy(), want, **dryrun.SPMV_TOL)


@pytest.mark.parametrize("op", [spmv_dist.ExchangeLeft("exchange_left"),
                                spmv_dist.ExchangeRight("exchange_right")])
def test_exchange_refuses_a_shared_card(op):
    args = dict(n_sp=2, batch=2, rows_per_shard=16, nnz_per_row=2)
    ex, _ = _one_rank_executor(args, shared_card=True, size=2)
    ex.ctx.bufs = dict(ex.init_bufs)
    with pytest.raises(RuntimeError, match="share one card"):
        op.apply(ex.ctx.bufs, ex.ctx)
    with pytest.raises(RuntimeError, match="needs a platform mesh"):
        ex.ctx.mesh = None
        op.apply(ex.ctx.bufs, ex.ctx)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _cuda_executor(model, args, sizes, graphs):
    """One rank's executor on the card over a hand-built mesh of ``sizes``
    (no process group: a size-1 axis needs none, and a larger one raises
    before any message)."""
    from tenzing_tpu_torch.parallel.mesh import shard_of

    g, bufs, specs, want, out, tol = dryrun.model_setup(model, args, sizes)
    mesh = Mesh({k: MeshAxis(n, 0) for k, n in sizes.items()})
    local = {k: shard_of(v, specs[k], mesh) for k, v in bufs.items()}
    plat = Platform.make_n_lanes(2, mesh=mesh, specs=specs)
    ex = StreamExecutor(plat, buffers_from_numpy(local, "cuda"),
                        device="cuda", graphs=graphs)
    return g, ex, want, out


@pytest.mark.needs_cuda
@pytest.mark.parametrize("model,args,sizes", [
    ("spmv_dist", dict(n_sp=1, batch=2, rows_per_shard=64, nnz_per_row=4),
     {"dp": 1, "sp": 1}),
    ("ring", dict(n_devices=1, batch=1, seq_local=256, head_dim=128,
                  impl_choice=True), {"sp": 1}),
], ids=["dist", "ring"])
def test_cuda_size_one_exchanges_are_captured(model, args, sizes,
                                              cuda_device):
    """At size 1 the in-op exchanges (zero fills, a copy) stay capturable:
    the captured schedule's output equals the eager one's bit for bit."""
    g, ex, _, out = _cuda_executor(model, args, sizes, graphs=True)
    _, eager, _, _ = _cuda_executor(model, args, sizes, graphs=False)
    order = get_all_sequences(g, Platform.make_n_lanes(2), 1)[0].sequence
    assert ex.precompile(order)
    assert torch.equal(ex.run(order)[out], eager.run(order)[out])


@pytest.mark.needs_cuda
def test_cuda_exchange_on_a_larger_axis_refuses_capture(cuda_device):
    """At size > 1 an in-op exchange raises ``CaptureError`` naming the op
    (its sends and receives are issued from the host at the op)."""
    from tenzing_tpu_torch.runtime.executor import CaptureError

    args = dict(n_sp=2, batch=2, rows_per_shard=16, nnz_per_row=2)
    g, ex, _, _ = _cuda_executor("spmv_dist", args, {"dp": 1, "sp": 2},
                                 graphs=True)
    order = get_all_sequences(g, Platform.make_n_lanes(2), 1)[0].sequence
    with pytest.raises(CaptureError, match="exchange_(left|right)"):
        ex.precompile(order)
