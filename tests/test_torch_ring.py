"""The ring attention of the port (tenzing_tpu_torch/models/ring_attention.py:
``AttnStep``'s ring form, ``AttnStepPallas``, ``AttnStepPallasBf16``,
``AttnStepChoice``, ``RotateKV``, ``RingAttention``, ``make_ring_buffers``)
against the JAX package's (tenzing_tpu/models/ring_attention.py; reference
tests test_ring_attention.py).

* ``make_ring_buffers`` gives the reference's arrays bit for bit;
* ``RingAttention``'s vertices and edges, and those of every structural
  variant with ``impl_choice``, are the reference's; reference schedule
  JSON round-trips;
* over gloo at 1, 2 and 4 ``sp`` ranks, with every step on ``.xla``, on
  ``.pallas`` and on ``.pallas_bf16`` (the fold kernel's plain version on
  the CPU; the reference's Pallas kernel in interpret mode), the same
  schedule JSONs run through the reference's ``TraceExecutor`` on the CPU
  mesh and through the port's ranks (``RotateKV`` at 2 and 4 ranks): O
  agree within ``F32_TOL`` (``BF16_TOL`` with bf16 inputs, the reference's
  own ~8-bit bound) and each is within the reference's tolerance of the
  dense float64 attention;
* on an axis of size 1 ``RotateKV`` is a copy, without a process group.

``test_cuda_ring_kernels_match_plain`` (the ring's step kernels against
their plain versions at the 8k-key world-size-1 block) and
``test_cuda_rotate_refuses_a_shared_card`` need the card."""

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
from tenzing_tpu.models import ring_attention as ref
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu.solve import dfs as ref_dfs
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Mesh, MeshAxis, Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.models import ring_attention as ring
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.parallel.launch import launch
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.solve.dfs import structural_variants
from tenzing_tpu_torch.verify import ScheduleVerifier

SEED = 0
TIMEOUT_S = 120.0
# the reference's own bounds (test_ring_attention.py:76, :121, :210)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
SLOTS = (".xla", ".pallas", ".pallas_bf16")


def _args(n, **kw):
    """The reference dryrun's ring widths."""
    return {**dict(n_devices=n, batch=2, seq_local=8, head_dim=8), **kw}


def _wrap(comp, g):
    g.start_then(comp)
    g.then_finish(comp)
    return g


def _shape(g):
    names = sorted(v.name() for v in g.vertices())
    edges = sorted((a.name(), b.name()) for a in g.vertices()
                   for b in g.succs(a))
    return names, edges


@pytest.mark.parametrize("n", [1, 2, 4])
def test_buffers_equal_reference(n):
    a = ring.RingAttnArgs(**_args(n, seq_local=16))
    pb, ps, pw = ring.make_ring_buffers(a, seed=1)
    rb, rs, rw = ref.make_ring_buffers(ref.RingAttnArgs(**asdict(a)), seed=1)
    assert rb.keys() == pb.keys() == rs.keys() == ps.keys()
    for k in rb:
        assert rb[k].dtype == pb[k].dtype and np.array_equal(rb[k], pb[k]), k
        assert tuple(rs[k]) == ps[k] == (None, "sp", None), k
    assert np.array_equal(rw, pw)
    assert ring.make_ring_buffers(a, seed=1, with_expected=False)[2] is None


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("impl_choice", [False, True])
def test_graph_and_schedule_json_equal_reference(n, impl_choice):
    a = ring.RingAttnArgs(**_args(n))
    g = _wrap(ring.RingAttention(a, impl_choice=impl_choice), Graph())
    rg = _wrap(ref.RingAttention(ref.RingAttnArgs(**asdict(a)),
                                 impl_choice=impl_choice), RefGraph())
    port = sorted(_shape(v) for v in structural_variants(g))
    assert port == sorted(_shape(v) for v in ref_dfs.structural_variants(rg))
    assert len(port) == (3 ** n if impl_choice else 1)
    verifier = ScheduleVerifier(g)
    for st in ref_dfs.enumerate_schedules(rg, RefPlatform.make_n_lanes(2),
                                          max_seqs=6):
        js = ref_to_json(st.sequence)
        seq = sequence_from_json(js, g)
        assert sequence_to_json(seq) == js and verifier(seq).ok


def _slot_orders(n):
    """One schedule per slot, every step on it (dryrun's ``"slots"``)."""
    g, _, _, _, _, _ = dryrun.model_setup("ring", _args(n, impl_choice=True),
                                          {})
    return [dryrun.engine_order(g, Platform.make_n_lanes(2),
                                lambda name, s=s: s) for s in SLOTS]


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("n", [1, 2, 4])
def test_gloo_matches_reference_mesh(n, tmp_path):
    args = _args(n, impl_choice=True)
    orders = _slot_orders(n)
    assert [dryrun.step_slots(o) for o in orders] == [[s] * n for s in SLOTS]
    rotates = sum(op.name().startswith("rotate_") for op in orders[0])
    assert rotates == n - 1
    jsons = [sequence_to_json(o) for o in orders]
    ra = ref.RingAttnArgs(**_args(n))
    bufs, specs, want = ref.make_ring_buffers(ra, seed=SEED)
    plat = RefPlatform.make_n_lanes(
        2, mesh=JaxMesh(np.array(jax.devices()[:n]), ("sp",)), specs=specs)
    ex = TraceExecutor(plat, {k: jnp.asarray(v) for k, v in bufs.items()})
    rg = _wrap(ref.RingAttention(ra, impl_choice=True), RefGraph())
    ref_os = [np.asarray(ex.run(ref_from_json(js, rg))["O"]) for js in jsons]
    port_os = launch("tenzing_tpu_torch.parallel.dryrun:model_schedules", n,
                     "cpu", dict(model="ring", args=args, schedules=jsons,
                                 seed=SEED),
                     timeout_s=TIMEOUT_S, workdir=str(tmp_path),
                     mesh_axes=("sp",), mesh_shape=(n,))[0]
    for slot, po, ro in zip(SLOTS, port_os, ref_os):
        bf16 = slot == ".pallas_bf16"
        np.testing.assert_allclose(po, ro, **(BF16_TOL if bf16 else F32_TOL))
        tol = BF16_TOL if bf16 else dryrun.ACT_TOL
        np.testing.assert_allclose(ro, want, **tol)
        np.testing.assert_allclose(po, want, **tol)


def test_size_one_rotate_is_a_copy():
    a = ring.RingAttnArgs(**_args(1))
    bufs, specs, _ = ring.make_ring_buffers(a, seed=SEED, with_expected=False)
    mesh = Mesh({"sp": MeshAxis(1, 0)})
    plat = Platform.make_n_lanes(1, mesh=mesh, specs=specs)
    ex = StreamExecutor(plat, buffers_from_numpy(bufs, "cpu"), device="cpu")
    ex.ctx.bufs = dict(ex.init_bufs)
    ring.RotateKV("rotate_0", 0).apply(ex.ctx.bufs, ex.ctx)
    assert torch.equal(ex.ctx.bufs["K1"], ex.ctx.bufs["K0"])
    assert torch.equal(ex.ctx.bufs["V1"], ex.ctx.bufs["V0"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_ring_kernels_match_plain(cuda_device, bf16):
    """A ring step at world size 1 folds all of its keys as one block: the
    fold kernel on a 4096-key block (batch 1) against its plain version, as
    m, l and acc / l (ops/attention_kernels.py state tolerances)."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    a = ring.RingAttnArgs(n_devices=1, batch=1, seq_local=4096, head_dim=128)
    bufs, _, _ = ring.make_ring_buffers(a, seed=SEED, with_expected=False)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in bufs.items()}
    ref_state = [t[k].clone() for k in ("acc", "m_run", "l_run")]
    ak.attn_block_plain(t["Q"], t["K0"], t["V0"], *ref_state, a.scale, bf16)
    before = dict(ak.LAUNCHES)
    ak.attn_block(t["Q"], t["K0"], t["V0"], t["acc"], t["m_run"], t["l_run"],
                  a.scale, bf16_inputs=bf16)
    key = "attn_block_bf16" if bf16 else "attn_block"
    assert ak.LAUNCHES[key] == before[key] + 1
    tol = ak.BF16_STATE_TOL if bf16 else ak.F32_STATE_TOL
    ok, errs = ak.state_check((t["acc"], t["m_run"], t["l_run"]),
                              tuple(ref_state), tol)
    assert ok, errs


@pytest.mark.needs_cuda
def test_cuda_rotate_refuses_a_shared_card(cuda_device, tmp_path):
    """RotateKV on 2 ranks sharing one card raises (gloo cannot move device
    tensors); nothing falls back."""
    orders = _slot_orders(2)
    with pytest.raises(RuntimeError, match="share one card"):
        launch("tenzing_tpu_torch.parallel.dryrun:model_schedules", 2, "cuda",
               dict(model="ring", args=_args(2, impl_choice=True),
                    schedules=[sequence_to_json(orders[0])]),
               timeout_s=TIMEOUT_S, workdir=str(tmp_path), mesh_axes=("sp",),
               mesh_shape=(2,), shared_card=True)
