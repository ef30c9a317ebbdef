"""The port's blocked attention against the JAX package.

The fold kernels: on the CPU the port's wrappers run their plain PyTorch
versions; the reference's Pallas kernels run in the Pallas interpreter
(``interpret=True``), as tests/test_ring_attention.py runs them.  The same
seeded numpy inputs feed both.  Tolerances are the reference's own: rtol and
atol 2e-5 for float32 (test_ring_attention.py:210), 3e-2 for bf16 inputs
(:121, ~8-bit mantissa).

The workload: the same schedule JSONs run through the reference
``TraceExecutor`` and the port's ``StreamExecutor(device="cpu")``; acc,
m_run, l_run and O must agree, and O must agree with the dense float64
expected attention (rtol 2e-4 / atol 2e-5 for f32, 3e-2 with bf16 inputs, the
reference's test_ring_attention.py:76 and :121).

``test_cuda_kernels_match_plain`` needs the card (marker ``needs_cuda``)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu.core.state import State as RefState
from tenzing_tpu.models import ring_attention as ref_attn
from tenzing_tpu.ops.attention_pallas import attn_block_pallas, attn_fused_pallas
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu_torch.bench.driver import attn_graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.core.state import State
from tenzing_tpu_torch.models import ring_attention as attn
from tenzing_tpu_torch.ops import attention_kernels as ak
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
SMALL = dict(n_devices=4, batch=2, seq_local=8, head_dim=8)

# (b, n, d, nkv, bkv): the reference's ragged case (test_ring_attention.py:185)
# and an even one
SHAPES = {"ragged": (1, 24, 16, 64, 16), "even": (2, 32, 8, 32, 8)}


def _inputs(shape, seed, mid_state):
    """Seeded q, k, v and a state: the initial one (acc 0, m -1e30, l 0) or a
    mid-chain one (a finite running max and sum)."""
    b, n, d, nkv, _ = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, n, d), (b, nkv, d), (b, nkv, d)))
    if mid_state:
        acc = rng.standard_normal((b, n, d)).astype(np.float32)
        m = np.broadcast_to(rng.standard_normal((b, n, 1)),
                            (b, n, d)).astype(np.float32)
        l = np.broadcast_to(rng.uniform(1, 4, (b, n, 1)),
                            (b, n, d)).astype(np.float32)
    else:
        acc = np.zeros((b, n, d), np.float32)
        m = np.full((b, n, d), -1e30, np.float32)
        l = np.zeros((b, n, d), np.float32)
    return q, k, v, acc, m, l


def _ref_fold(kernel, bf16, q, k, v, acc, m, l, scale, bkv):
    cast = (lambda x: jnp.asarray(x).astype(jnp.bfloat16)) if bf16 else jnp.asarray
    args = (cast(q), cast(k), cast(v), jnp.asarray(acc), jnp.asarray(m),
            jnp.asarray(l), scale)
    if kernel == "block":
        out = attn_block_pallas(*args, interpret=True)
    else:
        out = attn_fused_pallas(*args, bkv=bkv, interpret=True)
    return [np.asarray(o, np.float32) for o in out]


@pytest.mark.parametrize("mid_state", [False, True], ids=["init", "mid"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["block", "fused"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fold_matches_reference_kernel(shape, kernel, bf16, mid_state):
    sh = SHAPES[shape]
    q, k, v, acc, m, l = _inputs(sh, seed=7, mid_state=mid_state)
    bkv = sh[4]
    if kernel == "block":  # one block of the keys, a view as in the chain
        k, v = k[:, bkv:2 * bkv], v[:, bkv:2 * bkv]
    scale = 1.0 / np.sqrt(sh[2])
    want = _ref_fold(kernel, bf16, q, k, v, acc, m, l, scale, bkv)
    ts = [torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v, acc, m, l)]
    if kernel == "block":
        ak.attn_block(*ts, scale, bf16_inputs=bf16)
    else:
        ak.attn_fused(*ts, scale, bkv=bkv, bf16_inputs=bf16)
    tol = BF16_TOL if bf16 else F32_TOL
    for name, got, w in zip(("acc", "m", "l"), ts[3:], want):
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_equals_chained(bf16):
    """attn_fused == attn_block over consecutive bkv-key blocks, in the port."""
    sh = SHAPES["ragged"]
    _, _, d, nkv, bkv = sh
    q, k, v, acc, m, l = (torch.from_numpy(x) for x in _inputs(sh, 3, False))
    chained = [acc.clone(), m.clone(), l.clone()]
    for j in range(0, nkv, bkv):
        ak.attn_block(q, k[:, j:j + bkv], v[:, j:j + bkv], *chained, d ** -0.5,
                      bf16_inputs=bf16)
    ak.attn_fused(q, k, v, acc, m, l, d ** -0.5, bkv=bkv, bf16_inputs=bf16)
    for a, b in zip((acc, m, l), chained):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32_TOL)


def test_plain_xla_fold_allocates_into_scratch_only():
    """The .xla fold writes only into the declared scratch and the state."""
    sh = SHAPES["even"]
    b, n, d, nkv, _ = sh
    q, k, v, acc, m, l = (torch.from_numpy(x) for x in _inputs(sh, 5, True))
    work = {name: torch.empty(shape) for name, (shape, _) in
            ak.fold_scratch(b, n, nkv, d).items()}
    ptrs = [t.data_ptr() for t in (acc, m, l, *work.values())]
    want = [t.clone() for t in (acc, m, l)]
    ak.attn_block_plain(q, k, v, *want, d ** -0.5)
    ak.fold_into(q, k, v, acc, m, l, d ** -0.5, work["attn_s"], work["attn_row"],
                 work["attn_mnew"])
    assert ptrs == [t.data_ptr() for t in (acc, m, l, *work.values())]
    for a, w in zip((acc, m, l), want):
        np.testing.assert_array_equal(a.numpy(), w.numpy())


def test_wrappers_reject_what_the_kernel_does_not_take():
    q, k, v, acc, m, l = (torch.from_numpy(x)
                          for x in _inputs(SHAPES["even"], 1, False))
    with pytest.raises(TypeError, match="float32"):
        ak.attn_block(q.double(), k, v, acc, m, l, 0.3)
    with pytest.raises(ValueError, match="do not match"):
        ak.attn_block(q, k[:, :, :4], v, acc, m, l, 0.3)
    with pytest.raises(ValueError, match="contiguous"):
        ak.attn_block(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                      acc, m, l, 0.3)
    with pytest.raises(ValueError, match="does not divide"):
        ak.attn_fused(q, k, v, acc, m, l, 0.3, bkv=12)
    with pytest.raises(ValueError, match="q's shape"):
        ak.attn_fused(q, k, v, acc[:, :4], m, l, 0.3)


def test_cpu_wrappers_do_not_count_launches():
    before = dict(ak.LAUNCHES)
    ts = [torch.from_numpy(x) for x in _inputs(SHAPES["even"], 2, False)]
    ak.attn_block(*ts, 0.3, bf16_inputs=True)
    ak.attn_fused(*ts, 0.3, bkv=8)
    assert dict(ak.LAUNCHES) == before


@pytest.mark.parametrize("kw,seed", [
    (SMALL, 0), (dict(n_devices=4, batch=1, seq_local=16, head_dim=8), 5),
    (dict(n_devices=2, batch=3, seq_local=8, head_dim=16), 11)])
def test_blocked_buffers_bit_identical_to_reference(kw, seed):
    mine, want_m = attn.make_blocked_buffers(attn.RingAttnArgs(**kw), seed=seed)
    ref, want_r = ref_attn.make_blocked_buffers(ref_attn.RingAttnArgs(**kw),
                                                seed=seed)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(mine[k], ref[k])
    np.testing.assert_array_equal(want_m, want_r)
    skip, none = attn.make_blocked_buffers(attn.RingAttnArgs(**kw), seed=seed,
                                           with_expected=False)
    assert none is None
    placed = buffers_from_numpy(skip, "cpu")
    for k in ref:
        np.testing.assert_array_equal(placed[k].numpy(), ref[k])


def _ref_graph(kw):
    g = RefGraph()
    op = ref_attn.BlockedAttention(ref_attn.RingAttnArgs(**kw), impl_choice=True,
                                   fused_choice=True)
    g.start_then(op)
    g.then_finish(op)
    return g


@pytest.mark.parametrize("seed", range(6))
def test_decision_lists_match_reference(seed):
    """A seeded walk over BlockedAttention(impl_choice, fused_choice): at
    every step both packages offer the same decisions, in the same order."""
    mine = State(attn_graph(attn.RingAttnArgs(**SMALL)))
    ref = RefState(_ref_graph(SMALL))
    plat, rplat = Platform.make_n_lanes(2), RefPlatform.make_n_lanes(2)
    rng = random.Random(seed)
    steps = 0
    while not ref.is_terminal():
        ds, rds = mine.get_decisions(plat), ref.get_decisions(rplat)
        assert [d.to_json() for d in ds] == [d.to_json() for d in rds]
        i = rng.randrange(len(rds))
        mine, ref = mine.apply(ds[i]), ref.apply(rds[i])
        steps += 1
    assert mine.is_terminal() and steps > 5


def _ref_schedule_json(seed):
    """A complete reference schedule, chosen by a seeded walk."""
    st = RefState(_ref_graph(SMALL))
    rng = random.Random(seed)
    while not st.is_terminal():
        ds = st.get_decisions(RefPlatform.make_n_lanes(2))
        st = st.apply(ds[rng.randrange(len(ds))])
    return ref_to_json(st.sequence)


@pytest.mark.parametrize("seed", range(4))
def test_reference_schedule_json_deserializes(seed):
    js = _ref_schedule_json(seed)
    order = sequence_from_json(js, attn_graph(attn.RingAttnArgs(**SMALL)))
    assert sequence_to_json(order) == js


ORDERS = list(attn.fixed_orders(attn_graph(attn.RingAttnArgs(**SMALL)),
                                SMALL["n_devices"]))


@pytest.mark.parametrize("label", ORDERS)
def test_port_executor_matches_reference_executor(label):
    args = attn.RingAttnArgs(**SMALL)
    order = attn.fixed_orders(attn_graph(args), args.n_devices)[label]
    js = sequence_to_json(order)
    bufs, want = attn.make_blocked_buffers(args, seed=5)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(bufs, "cpu"),
                        device="cpu")
    got = ex.run(order)
    ref_bufs, _ = ref_attn.make_blocked_buffers(ref_attn.RingAttnArgs(**SMALL),
                                                seed=5)
    rex = TraceExecutor(RefPlatform.make_n_lanes(2),
                        {k: jnp.asarray(v) for k, v in ref_bufs.items()})
    ref_out = rex.run(ref_from_json(js, _ref_graph(SMALL)))
    bf16 = "bf16" in label or "mixed" in label
    for name in ("acc", "m_run", "l_run", "O"):
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(jax.device_get(ref_out[name])),
            err_msg=name, **(BF16_TOL if bf16 else dict(rtol=2e-4, atol=2e-5)))
    np.testing.assert_allclose(
        got["O"].numpy(), want,
        **(BF16_TOL if bf16 else dict(rtol=2e-4, atol=2e-5)))


def test_timed_runs_write_in_place_and_plain_mode_agrees():
    """prepare_n updates the executor's own buffers (every data_ptr kept);
    the plain-kernel executor computes the same state."""
    args = attn.RingAttnArgs(**SMALL)
    orders = attn.fixed_orders(attn_graph(args), args.n_devices)
    bufs, want = attn.make_blocked_buffers(args, seed=2)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(bufs, "cpu"),
                        device="cpu")
    plain = StreamExecutor(Platform.make_n_lanes(2),
                           buffers_from_numpy(bufs, "cpu"), device="cpu",
                           plain_kernels=True)
    for label in ("naive", "mixed-2l", "fused"):
        ptrs = {k: v.data_ptr() for k, v in ex.init_bufs.items()}
        ex.prepare_n(orders[label])(1)
        assert {k: v.data_ptr() for k, v in ex.init_bufs.items()} == ptrs
        a, b = ex.run(orders[label]), plain.run(orders[label])
        for name in a:
            np.testing.assert_array_equal(a[name].numpy(), b[name].numpy())
    assert set(ex.ctx.scratch) == {"attn_s", "attn_row", "attn_mnew"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def card_fold_errors(device, d):
    """Both kernels on ``device``, f32 and bf16, from the initial and a
    mid-chain state, ragged n, each held against its plain version on the
    same inputs with ``ak.state_check`` (m, l and acc / l at
    ``F32_STATE_TOL`` / ``BF16_STATE_TOL``).  Returns (label, ok, errors)."""
    sh = (2, 200, d, 256, 64)
    out = []
    for mid in (False, True):
        host = _inputs(sh, 9, mid)
        for bf16 in (False, True):
            for kernel in ("block", "fused"):
                got = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                       for x in host]
                want = [t.clone() for t in got]
                if kernel == "block":
                    ak.attn_block(*got, d ** -0.5, bf16_inputs=bf16)
                    ak.attn_block_plain(*want, d ** -0.5, bf16_inputs=bf16)
                else:
                    ak.attn_fused(*got, d ** -0.5, bkv=64, bf16_inputs=bf16)
                    ak.attn_fused_plain(*want, d ** -0.5, 64, bf16)
                torch.cuda.synchronize()
                tol = ak.BF16_STATE_TOL if bf16 else ak.F32_STATE_TOL
                ok, errs = ak.state_check(got[3:], want[3:], tol)
                label = (f"{kernel}-{'bf16' if bf16 else 'f32'}-"
                         f"{'mid' if mid else 'init'}")
                out.append((label, ok, errs))
    return out


@pytest.mark.needs_cuda
@pytest.mark.parametrize("d", ak.KERNEL_HEAD_DIMS)
def test_cuda_kernels_match_plain(cuda_device, d):
    """Both kernels on the card, f32 and bf16, ragged n, against their plain
    versions on the same inputs."""
    failed = [(label, errs) for label, ok, errs in card_fold_errors(cuda_device, d)
              if not ok]
    assert not failed, failed
