"""The port's gelu MLPs (``ops/ffn_kernels.py``: the per-expert
``ffn_batched`` and the row-tiled ``ffn_rows``) against the JAX package.

On the CPU a wrapper runs its plain PyTorch version; the reference's Pallas
kernels ``ffn_pallas_batched`` and ``ffn_pallas`` run in the Pallas
interpreter (``interpret=True``), as tests/test_moe_pipeline.py and
tests/test_moe.py reach them.  The same seeded numpy inputs feed both.

Tolerance: ``ops.ffn_kernels.FFN_TOL`` (rtol = atol = 1e-4).  Both sides
sum in float32 over d and then d_ff terms in different orders; at these
shapes the two agree to ~1e-6, and on the card the kernel and the plain
version agree to 8e-6 at full width (d=512, d_ff=2048; PERF.md).  The
erf gelu in place of the tanh form moves y by ~5e-4 and must fail it.

bf16 ``ffn_rows``: the same bf16 inputs (float32 numpy rounded to bf16 the
same way on both sides) through ``ffn_pallas(interpret=True)`` and the
plain version, at ``FFN_BF16_TOL`` (rtol = atol = 2^-7, two bf16 ulps at
|y| ~ 1: the bf16 rounding of h and y, after float32 sums in different
orders, may land one ulp apart).  A control with W1's last 64 hidden
columns zeroed (a skipped hidden tile) must fail it.

``test_cuda_kernel_matches_plain``, ``test_cuda_rows_kernel_matches_plain``
and ``test_cuda_rows_bf16_kernel_matches_plain`` need the card (marker
``needs_cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenzing_tpu.ops.ffn_pallas import ffn_pallas, ffn_pallas_batched
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


# -- ffn_rows: the MoE layer's .pallas slot ---------------------------------------

# (n, d, dff): n ragged against the reference's 512-row tile (one tile, and
# more than one), a small and a ragged hidden width
ROWS = [(37, 64, 16), (37, 64, 520), (600, 64, 16), (600, 64, 520)]


def _rows_inputs(n, d, dff, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, dff)) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((dff, d)) / np.sqrt(dff)).astype(np.float32)
    return x, w1, w2


@pytest.mark.parametrize("shape", ROWS, ids=[f"n{n}-d{d}-dff{f}"
                                             for n, d, f in ROWS])
def test_rows_plain_matches_reference_kernel(shape):
    x, w1, w2 = _rows_inputs(*shape, seed=11)
    want = np.asarray(ffn_pallas(jnp.asarray(x), jnp.asarray(w1),
                                 jnp.asarray(w2), interpret=True))
    got = fk.ffn_rows(*(torch.from_numpy(t) for t in (x, w1, w2)))
    np.testing.assert_allclose(got.numpy(), want, **FFN_TOL)
    ctl = fk.ffn_rows_plain(*(torch.from_numpy(t) for t in (x, w1, w2)),
                            approximate="none")
    assert not np.allclose(ctl.numpy(), want, **FFN_TOL)


def test_rows_wrapper_writes_into_out_and_counts_no_cpu_launch():
    x, w1, w2 = (torch.from_numpy(t) for t in _rows_inputs(37, 32, 64, 12))
    before = dict(fk.LAUNCHES)
    out = torch.full_like(x, float("nan"))
    assert fk.ffn_rows(x, w1, w2, out=out) is out
    torch.testing.assert_close(out, fk.ffn_rows_plain(x, w1, w2))
    assert fk.LAUNCHES == before


@pytest.mark.parametrize("bad", ["bf16", "f64", "shape", "out", "noncontig",
                                 "3d"])
def test_rows_wrapper_rejects_bad_arguments(bad):
    x, w1, w2 = (torch.from_numpy(t) for t in _rows_inputs(37, 32, 64, 13))
    out = None
    if bad == "bf16":
        # a bf16 x takes bf16 weights: mixed dtypes are refused
        with pytest.raises(TypeError, match="like x"):
            fk.ffn_rows(x.to(torch.bfloat16), w1, w2)
        return
    if bad == "f64":
        w1 = w1.double()
    elif bad == "shape":
        w2 = w2[:-1]
    elif bad == "out":
        out = torch.zeros(x.shape[0] + 1, x.shape[1])
    elif bad == "noncontig":
        x = x.t().contiguous().t()
    else:
        x = x[None]
    with pytest.raises((TypeError, ValueError)):
        fk.ffn_rows(x, w1, w2, out=out)


def test_rows_bound_at_the_slice_shape():
    """One chunk of the MoE layer at world size 1 (n=2048, d=512,
    dff=2048) is bound by operations: 8.59 GFLOP at 67 TFLOP/s is 128.2 us;
    x, W1, W2 and y (16.8 MB) take 5.0 us at 3.35 TB/s."""
    n, d, dff = 2048, 512, 2048
    flops, nbytes = fk.ffn_flops(1, n, d, dff), fk.ffn_bytes(1, n, d, dff)
    assert flops == pytest.approx(8.59e9, rel=1e-3)
    assert flops / 67e12 * 1e6 == pytest.approx(128.2, abs=0.1)
    assert nbytes == pytest.approx(16.8e6, rel=1e-2)
    assert nbytes / 3.35e12 * 1e6 == pytest.approx(5.0, abs=0.05)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", [(2048, 512, 2048), (2047, 512, 2048),
                                   (37, 512, 520)])
def test_cuda_rows_kernel_matches_plain(cuda_device, shape):
    x, w1, w2 = (torch.from_numpy(t).to(cuda_device)
                 for t in _rows_inputs(*shape, seed=14))
    before = fk.LAUNCHES["ffn_rows"]
    got = fk.ffn_rows(x, w1, w2)
    again = fk.ffn_rows(x, w1, w2)
    want = fk.ffn_rows_plain(x, w1, w2)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["ffn_rows"] == before + 2
    torch.testing.assert_close(got, want, **FFN_TOL)
    assert torch.equal(got, again)
    assert not torch.allclose(
        fk.ffn_rows_plain(x, w1, w2, approximate="none"), want, **FFN_TOL)


# -- ffn_rows in bf16 (the reference's kernel with a bf16 x) ---------------------

FFN_BF16_TOL = fk.FFN_BF16_TOL


def _bf16_inputs(n, d, dff, seed):
    return [torch.from_numpy(t).to(torch.bfloat16)
            for t in _rows_inputs(n, d, dff, seed)]


def _tile_dropped(w1):
    """W1 with its last 64 hidden columns zeroed: a skipped hidden tile."""
    w1 = w1.clone()
    w1[:, -min(64, w1.shape[1]):] = 0
    return w1


@pytest.mark.parametrize("shape", ROWS + [(300, 512, 2048)],
                         ids=[f"n{n}-d{d}-dff{f}"
                              for n, d, f in ROWS + [(300, 512, 2048)]])
def test_rows_bf16_plain_matches_reference_kernel(shape):
    x, w1, w2 = _bf16_inputs(*shape, seed=11)
    want = ffn_pallas(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                        for t in (x, w1, w2)), interpret=True)
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    got = fk.ffn_rows(x, w1, w2)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, **FFN_BF16_TOL)
    ctl = fk.ffn_rows_plain(x, _tile_dropped(w1), w2)
    assert not torch.allclose(ctl.float(), want, **FFN_BF16_TOL)


def test_rows_bf16_plain_rounds_h_and_y():
    """The plain version rounds h to bf16 between the products and y at the
    end, as the reference's kernel: not the same as carrying h in float32."""
    x, w1, w2 = _bf16_inputs(300, 512, 2048, seed=15)
    got = fk.ffn_rows_plain(x, w1, w2)
    h = torch.nn.functional.gelu(x.float() @ w1.float(), approximate="tanh")
    unrounded = (h @ w2.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert not torch.equal(got, unrounded)
    torch.testing.assert_close(got.float(), unrounded.float(), **FFN_BF16_TOL)


def test_rows_bf16_wrapper_writes_into_out_and_counts_no_cpu_launch():
    x, w1, w2 = _bf16_inputs(37, 32, 64, 12)
    before = dict(fk.LAUNCHES)
    out = torch.full_like(x, float("nan"))
    assert fk.ffn_rows(x, w1, w2, out=out) is out
    assert torch.equal(out, fk.ffn_rows_plain(x, w1, w2))
    assert fk.LAUNCHES == before


def test_rows_bf16_bound_at_the_slice_shape():
    """In bf16 the same chunk is bound by operations at the tensor cores'
    989 TFLOP/s: 8.7 us; its bytes (8.4 MB) take 2.5 us."""
    n, d, dff = 2048, 512, 2048
    flops = fk.ffn_flops(1, n, d, dff)
    nbytes = fk.ffn_bytes(1, n, d, dff, itemsize=2)
    assert flops / 989e12 * 1e6 == pytest.approx(8.69, abs=0.01)
    assert nbytes / 3.35e12 * 1e6 == pytest.approx(2.50, abs=0.01)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", [(2048, 512, 2048), (2047, 512, 2048),
                                   (37, 512, 520)])
def test_cuda_rows_bf16_kernel_matches_plain(cuda_device, shape):
    x, w1, w2 = (t.to(cuda_device) for t in _bf16_inputs(*shape, seed=16))
    before = dict(fk.LAUNCHES)
    got = fk.ffn_rows(x, w1, w2)
    again = fk.ffn_rows(x, w1, w2)
    want = fk.ffn_rows_plain(x, w1, w2)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["ffn_rows_bf16"] == before["ffn_rows_bf16"] + 2
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **FFN_BF16_TOL)
    assert torch.equal(got, again)
    assert not torch.allclose(fk.ffn_rows_plain(x, _tile_dropped(w1), w2)
                              .float(), want.float(), **FFN_BF16_TOL)
