"""The port's per-expert MLP (``ops/ffn_kernels.py``) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version; the reference's Pallas
kernel ``ffn_pallas_batched`` runs in the Pallas interpreter
(``interpret=True``), as tests/test_moe_pipeline.py reaches it.  The same
seeded numpy inputs feed both.

Tolerance: ``ops.ffn_kernels.FFN_TOL`` (rtol = atol = 1e-4).  Both sides
sum in float32 over d and then d_ff terms in different orders; at these
shapes the two agree to ~1e-6, and on the card the kernel and the plain
version agree to 8e-6 at full width (d=512, d_ff=2048; PERF.md).  The
erf gelu in place of the tanh form moves y by ~5e-4 and must fail it.

``test_cuda_kernel_matches_plain`` needs the card (marker ``needs_cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenzing_tpu.ops.ffn_pallas import ffn_pallas_batched
from tenzing_tpu_torch.ops import ffn_kernels as fk

FFN_TOL = fk.FFN_TOL

# (E, C, d, dff): ragged rows across the reference's 256-row tile and more
# than one (ragged) 512-wide hidden tile; a small even case; one slot
SHAPES = {"ragged": (2, 300, 64, 1030), "even": (3, 16, 32, 64),
          "one_slot": (1, 1, 8, 16)}


def _inputs(shape, seed):
    e, c, d, dff = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w1 = (rng.standard_normal((e, d, dff)) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((e, dff, d)) / np.sqrt(dff)).astype(np.float32)
    return x, w1, w2


def _reference(x, w1, w2):
    return np.asarray(ffn_pallas_batched(jnp.asarray(x), jnp.asarray(w1),
                                         jnp.asarray(w2), interpret=True))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_reference_kernel(shape):
    x, w1, w2 = _inputs(SHAPES[shape], seed=3)
    want = _reference(x, w1, w2)
    got = fk.ffn_batched(*(torch.from_numpy(t) for t in (x, w1, w2)))
    np.testing.assert_allclose(got.numpy(), want, **FFN_TOL)


def test_erf_gelu_control_fails_the_tolerance():
    x, w1, w2 = _inputs(SHAPES["ragged"], seed=3)
    want = _reference(x, w1, w2)
    ctl = fk.ffn_batched_plain(*(torch.from_numpy(t) for t in (x, w1, w2)),
                               approximate="none")
    assert not np.allclose(ctl.numpy(), want, **FFN_TOL)


def test_wrapper_writes_into_out():
    x, w1, w2 = (torch.from_numpy(t) for t in _inputs(SHAPES["even"], seed=4))
    out = torch.full_like(x, float("nan"))
    assert fk.ffn_batched(x, w1, w2, out=out) is out
    torch.testing.assert_close(out, fk.ffn_batched_plain(x, w1, w2))


def test_cpu_wrapper_does_not_count_launches():
    before = dict(fk.LAUNCHES)
    x, w1, w2 = (torch.from_numpy(t) for t in _inputs(SHAPES["even"], seed=5))
    fk.ffn_batched(x, w1, w2)
    assert fk.LAUNCHES == before


@pytest.mark.parametrize("bad", ["bf16", "f64", "shape", "out", "noncontig"])
def test_wrapper_rejects_bad_arguments(bad):
    x, w1, w2 = (torch.from_numpy(t) for t in _inputs(SHAPES["even"], seed=6))
    out = None
    if bad == "bf16":
        x = x.to(torch.bfloat16)
    elif bad == "f64":
        w1 = w1.double()
    elif bad == "shape":
        w2 = w2[:, :-1]
    elif bad == "out":
        out = torch.zeros(x.shape[0], x.shape[1] + 1, x.shape[2])
    else:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        fk.ffn_batched(x, w1, w2, out=out)


def test_bounds_at_full_width():
    """The main path's launch (8 experts x 304 slots, d=512, d_ff=2048) is
    bound by operations: 10.2 GFLOP at 67 TFLOP/s vs 77 MB at 3.35 TB/s."""
    e, c, d, dff = 8, 304, 512, 2048
    assert fk.ffn_flops(e, c, d, dff) == pytest.approx(10.2e9, rel=2e-3)
    assert fk.ffn_flops(e, c, d, dff) / 67e12 > fk.ffn_bytes(e, c, d, dff) / 3.35e12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", [(8, 304, 512, 2048), (2, 257, 512, 520),
                                   (1, 1, 512, 64)])
def test_cuda_kernel_matches_plain(cuda_device, shape):
    x, w1, w2 = (torch.from_numpy(t).to(cuda_device)
                 for t in _inputs(shape, seed=7))
    before = fk.LAUNCHES["ffn_batched"]
    got = fk.ffn_batched(x, w1, w2)
    want = fk.ffn_batched_plain(x, w1, w2)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["ffn_batched"] == before + 1
    torch.testing.assert_close(got, want, **FFN_TOL)
    assert not torch.allclose(
        fk.ffn_batched_plain(x, w1, w2, approximate="none"), want, **FFN_TOL)
