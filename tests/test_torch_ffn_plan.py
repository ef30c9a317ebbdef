"""The Python around the FFN bodies, on the CPU: the f32 one
(csrc/ffn_tile.cuh: split-TF32 on ``wgmma``, two launches of one GEMM body
behind ``ffn_batched`` and ``ffn_rows``) with a plain emulation of the
kernel's arithmetic against the JAX reference and the single-TF32-pass
control; the bf16 one (csrc/ffn_rows.cu ``tz_ffn_rows_bf16``: bf16
``wgmma``, two launches through a bf16 h); each launch plan and its
constants against the source, the workspaces, and the ablation edits of
``bench/ffn_f32.py`` and ``bench/ffn_bf16.py``.  The kernels themselves run
only on the card (the ``needs_cuda`` tests below and in
tests/test_torch_ffn_kernels.py)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenzing_tpu.ops.ffn_pallas import ffn_pallas, ffn_pallas_batched
from tenzing_tpu_torch.bench import ffn_bf16, ffn_f32
from tenzing_tpu_torch.ops import ffn_kernels as fk

CSRC = Path(__file__).resolve().parents[1] / "tenzing_tpu_torch" / "csrc"
HEADER = (CSRC / "ffn_tile.cuh").read_text()
ROWS_SRC = (CSRC / "ffn_rows.cu").read_text()
FFN_TOL = fk.FFN_TOL

# (E, C, dff): row 14's main shape, row 13 f32's (one expert of n = 2048),
# and ragged rows and hidden widths
PLAN_SHAPES = {"row14": (8, 304, 2048), "row13": (1, 2048, 2048),
               "c1": (8, 1, 2048), "c257": (8, 257, 2048),
               "c303": (8, 303, 2048), "c305": (8, 305, 2048),
               "dff520": (8, 304, 520), "rows-37": (1, 37, 520),
               "one-slot": (1, 1, 4)}
SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may use
SM_SHARED = 233_472   # shared memory of one SM (228 KB) for resident blocks


def _constexpr(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", HEADER)
    assert found, name
    return int(found.group(1))


def _inputs(e, c, d, dff, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w1 = (rng.standard_normal((e, d, dff)) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((e, dff, d)) / np.sqrt(dff)).astype(np.float32)
    return x, w1, w2


# (E, C, d, dff): ragged rows against the reference's tiles and a ragged
# hidden width; a small even case
EMU_SHAPES = [(2, 300, 64, 1030), (3, 16, 32, 64)]


@pytest.mark.parametrize("shape", EMU_SHAPES,
                         ids=[f"e{e}-c{c}-d{d}-dff{f}" for e, c, d, f in EMU_SHAPES])
def test_split_emulation_matches_batched_reference_and_one_pass_does_not(shape):
    """The kernel's arithmetic (three TF32 passes per product) agrees with
    ffn_pallas_batched in the Pallas interpreter at FFN_TOL; one pass
    (hi hi alone) does not."""
    x, w1, w2 = _inputs(*shape, seed=21)
    want = np.asarray(ffn_pallas_batched(jnp.asarray(x), jnp.asarray(w1),
                                         jnp.asarray(w2), interpret=True))
    tx, tw1, tw2 = (torch.from_numpy(t) for t in (x, w1, w2))
    three = ffn_f32.tf32_ffn_plain(torch, tx, tw1, tw2, 3).numpy()
    one = ffn_f32.tf32_ffn_plain(torch, tx, tw1, tw2, 1).numpy()
    np.testing.assert_allclose(three, want, **FFN_TOL)
    assert not np.allclose(one, want, **FFN_TOL)
    # three passes sit far inside the tolerance, one pass far outside
    assert np.abs(three - want).max() < FFN_TOL["atol"] / 10
    assert np.abs(one - want).max() > 4 * FFN_TOL["atol"]


@pytest.mark.parametrize("n,dff", [(37, 520), (600, 16)])
def test_split_emulation_matches_rows_reference_and_one_pass_does_not(n, dff):
    x, w1, w2 = (t[0] for t in _inputs(1, n, 64, dff, seed=22))
    want = np.asarray(ffn_pallas(jnp.asarray(x), jnp.asarray(w1),
                                 jnp.asarray(w2), interpret=True))
    tx, tw1, tw2 = (torch.from_numpy(t) for t in (x, w1, w2))
    np.testing.assert_allclose(
        ffn_f32.tf32_ffn_plain(torch, tx, tw1, tw2, 3).numpy(), want, **FFN_TOL)
    assert not np.allclose(ffn_f32.tf32_ffn_plain(torch, tx, tw1, tw2, 1).numpy(),
                           want, **FFN_TOL)


@pytest.mark.parametrize("label", list(PLAN_SHAPES))
def test_launch_plan_fits_the_card(label):
    e, c, dff = PLAN_SHAPES[label]
    plan = fk.ffn_launch_plan(e, c, dff)
    assert plan == fk.ffn_launch_plan(e, c, dff)  # a pure function
    assert plan["threads"] == 512 and plan["threads"] % 128 == 0
    # one block fits, a second does not (one CTA per SM)
    assert plan["smem_bytes"] <= SMEM_LIMIT < 2 * plan["smem_bytes"]
    assert 2 * plan["smem_bytes"] > SM_SHARED
    assert plan["work_bytes"] == 4 * e * c * dff
    for (m, n, k), lp in zip(((c, dff, 512), (c, 512, dff)), plan["launches"]):
        assert lp["m_tiles"] == -(-m // 128) and lp["n_tiles"] == -(-n // 128)
        assert lp["splits"] in (1, 2, 4)  # a portable cluster
        assert lp["ctas"] == e * lp["m_tiles"] * lp["n_tiles"] * lp["splits"]
        assert lp["ctas"] % lp["splits"] == 0 and lp["ctas"] < 2 ** 31
        chunks = -(-k // 32)
        assert lp["chunks_per_split"] * lp["splits"] >= chunks
        assert lp["chunks_per_split"] * (lp["splits"] - 1) < chunks
        # every split but a ragged last one sums at least 4 chunks
        assert lp["splits"] == 1 or lp["chunks_per_split"] >= 4


def test_main_shapes_plan_numbers():
    """Row 14: 384 CTAs, then 96 tiles unsplit (more than half the SMs
    busy); row 13 f32: 256, then 64 tiles split 2 ways."""
    r14 = fk.ffn_launch_plan(*PLAN_SHAPES["row14"])["launches"]
    assert [(lp["ctas"], lp["splits"]) for lp in r14] == [(384, 1), (96, 1)]
    r13 = fk.ffn_launch_plan(*PLAN_SHAPES["row13"])["launches"]
    assert [(lp["ctas"], lp["splits"]) for lp in r13] == [(256, 1), (128, 2)]
    assert fk.F32_SMEM_BYTES == 230_464


def test_split_k_takes_the_fewest_full_depth_waves():
    for tiles in range(1, 700, 7):
        for chunks in (1, 4, 8, 16, 64):
            s = fk.split_k(tiles, chunks)

            def waves(k):
                return -(-tiles * k // 132) / k

            if 2 * tiles > 132:  # at most half the SMs idle: no split
                assert s == 1
                continue
            valid = [k for k in (1, 2, 4) if k == 1 or chunks >= 4 * k]
            assert s in valid
            assert waves(s) == min(waves(k) for k in valid)
            assert all(waves(k) > waves(s) for k in valid if k < s)


def test_plan_constants_match_the_kernel_source():
    """The plan's constants are the kernel's (the library's own report and
    its tiling are checked against the plan on the card by chip_smoke.py
    and bench/ffn_f32.py)."""
    assert 64 * _constexpr("kConsumers") == fk.F32_ROWS
    assert _constexpr("kCols") == fk.F32_COLS
    assert _constexpr("kDepth") == fk.F32_DEPTH
    assert _constexpr("kStages") == fk.F32_STAGES
    assert _constexpr("kRawStages") == fk.F32_RAW_STAGES
    assert _constexpr("kMaxSplits") == fk.F32_MAX_SPLITS
    assert 128 * (_constexpr("kConsumers") + _constexpr("kProducers")) \
        == fk.F32_THREADS
    assert _constexpr("kD") in fk.KERNEL_D_MODELS
    # setmaxnreg moves registers between the CTA's own warps: the shares may
    # not exceed what the CTA holds at launch (65,536 / 512 = 128 a thread)
    assert _constexpr("kLaunchRegs") == 65536 // fk.F32_THREADS == 128
    assert (_constexpr("kProducerRegs") * _constexpr("kProducers")
            + _constexpr("kConsumerRegs") * _constexpr("kConsumers")) * 128 \
        <= _constexpr("kLaunchRegs") * fk.F32_THREADS
    assert _constexpr("kProducerRegs") % 8 == 0
    assert _constexpr("kConsumerRegs") % 8 == 0
    # the consumers hold t and the tile's sum (64 registers each)
    assert _constexpr("kConsumerRegs") >= 2 * 64 + 24


def test_ablation_edits_apply_to_the_source():
    for name, edits in ffn_f32.ABLATIONS.items():
        for old, new in edits:
            assert HEADER.count(old) == 1, (name, old)
            assert old != new
    for old, new in ffn_f32.CYCLE_EDITS:  # --cycles' counters
        assert HEADER.count(old) == 1, old
    assert set(ffn_f32.CHECKED_ABLATIONS) <= set(ffn_f32.ABLATIONS)
    assert set(ffn_f32.KEEPING_ABLATIONS) <= set(ffn_f32.ABLATIONS)
    assert "no-lo" in ffn_f32.CHECKED_ABLATIONS


def test_workspace_is_checked():
    x, w1, w2 = (torch.from_numpy(t) for t in _inputs(2, 5, 8, 12, seed=23))
    good = torch.empty(2, 5, 12)
    torch.testing.assert_close(fk.ffn_batched(x, w1, w2, work=good),
                               fk.ffn_batched_plain(x, w1, w2))
    for bad in (torch.empty(2, 5, 13), torch.empty(2, 5, 12).double(),
                torch.empty(2, 12, 5).transpose(1, 2)):
        with pytest.raises(ValueError, match="work"):
            fk.ffn_batched(x, w1, w2, work=bad)
    with pytest.raises(ValueError, match="work"):
        fk.ffn_rows(x[0], w1[0], w2[0], work=torch.empty(5, 11))
    torch.testing.assert_close(fk.ffn_rows(x[0], w1[0], w2[0],
                                           work=torch.empty(5, 12)),
                               fk.ffn_rows_plain(x[0], w1[0], w2[0]))


def test_models_give_the_kernel_slot_its_workspace():
    """The layer's .pallas slot declares the h workspace the kernel writes
    between its launches: float32 ``moe_h_<c>``, or in bf16 ``moe_hb_<c>``
    (the bf16 .xla slot's own h, so the two alternatives share it)."""
    from tenzing_tpu_torch.models import moe

    args = moe.MoEArgs(n_ep=2, tokens_per_shard=64, d_model=32, d_ff=48,
                       n_chunks=2)
    shapes = {"recv_disp_0": (2, 12, 32), "W1": (1, 32, 48)}
    op = moe.ExpertFFNPallas("ffn_0.pallas", 0, args)
    assert op.scratch_for(shapes) == {"moe_h_0": ((24, 48), "float32")}
    b16 = moe.MoEArgs(n_ep=2, tokens_per_shard=64, d_model=32, d_ff=48,
                      n_chunks=2, dtype="bfloat16")
    assert moe.ExpertFFNPallas("ffn_0.pallas", 0, b16).scratch_for(shapes) \
        == {"moe_hb_0": ((24, 48), "bfloat16")}


# -- the bf16 body (csrc/ffn_rows.cu) ------------------------------------------

# (n, dff): row 13 bf16's shape and the ragged ones the card checks
BF16_SHAPES = {"row13": (2048, 2048), "n2047": (2047, 2048),
               "n37": (37, 2048), "n1": (1, 2048), "dff2040": (2048, 2040),
               "dff8": (300, 8)}


def _rows_constexpr(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", ROWS_SRC)
    assert found, name
    return int(found.group(1))


def test_bf16_plan_at_the_slice_shape():
    """Row 13 bf16 (n 2048, d 512, d_ff 2048): 16 x 8 tiles of 128 x 256,
    unsplit, then 16 x 4 tiles of 128 x 128 split 2 ways over a cluster,
    each one wave of 128 CTAs on 132 SMs; the 8 MB bf16 workspace."""
    plan = fk.bf16_launch_plan(2048, 2048)
    l1, l2 = plan["launches"]
    assert (l1["m_tiles"], l1["n_tiles"], l1["splits"], l1["ctas"],
            l1["cols"]) == (16, 8, 1, 128, 256)
    assert (l2["m_tiles"], l2["n_tiles"], l2["splits"], l2["ctas"],
            l2["cols"]) == (16, 4, 2, 128, 128)
    assert l1["chunks_per_split"] == 512 // 64 and l2["chunks_per_split"] == 16
    assert all(-(-lp["ctas"] // fk.H100_SMS) == 1 for lp in (l1, l2))
    assert plan["threads"] == 384
    assert plan["work_bytes"] == 2 * 2048 * 2048


@pytest.mark.parametrize("label", list(BF16_SHAPES))
def test_bf16_plan_covers_every_output(label):
    """At every shape each launch's tiles cover its output, a split covers
    the depth, and every CTA fits the card's shared memory."""
    n, dff = BF16_SHAPES[label]
    plan = fk.bf16_launch_plan(n, dff)
    for lp, (m, nn, k) in zip(plan["launches"],
                              ((n, dff, 512), (n, 512, dff))):
        assert lp["m_tiles"] * fk.BF16_ROWS >= m > (lp["m_tiles"] - 1) * 128
        assert lp["n_tiles"] * lp["cols"] >= nn > (lp["n_tiles"] - 1) * lp["cols"]
        chunks = -(-k // fk.BF16_DEPTH)
        assert lp["chunks_per_split"] * lp["splits"] >= chunks
        assert lp["ctas"] == lp["m_tiles"] * lp["n_tiles"] * lp["splits"]
        assert lp["smem_bytes"] <= SMEM_LIMIT
        assert lp["splits"] == fk.split_k(lp["m_tiles"] * lp["n_tiles"], chunks)


@pytest.mark.parametrize("cols,tiles,splits",
                         [(64, 128, 1), (128, 64, 2), (256, 32, 4)])
def test_bf16_second_product_occupancy_variants(cols, tiles, splits):
    """The second product (h @ W2, 512 columns) at n 2048: 64-column tiles
    fill one wave unsplit; 128 or 256 columns leave more than half the SMs
    idle, so the depth splits over a cluster (split_k)."""
    lp = fk.bf16_launch_plan(2048, 2048, cols=(256, cols))["launches"][1]
    assert lp["m_tiles"] * lp["n_tiles"] == tiles
    assert lp["splits"] == splits


def test_bf16_plan_constants_match_the_kernel_source():
    assert _rows_constexpr("kBRows") == fk.BF16_ROWS
    assert (_rows_constexpr("kCols1"), _rows_constexpr("kCols2")) \
        == fk.BF16_COLS
    assert _rows_constexpr("kBDepth") == fk.BF16_DEPTH
    assert _rows_constexpr("kBStages") == fk.BF16_STAGES
    assert 128 * (_rows_constexpr("kBConsumers") + 1) == fk.BF16_THREADS
    assert set(fk.BF16_COLS) <= set(fk.BF16_TILE_COLS)
    for cols in fk.BF16_TILE_COLS:
        assert f"case {cols}:" in ROWS_SRC
    # a 128-byte swizzle row of bf16 is the depth and B's box width
    assert _rows_constexpr("kBDepth") * 2 == 128 == _rows_constexpr("kBBox") * 2
    # setmaxnreg moves registers within what the 384-thread CTA holds
    launch = _rows_constexpr("kBLaunchRegs")
    assert launch == (65536 // fk.BF16_THREADS) // 8 * 8 == 168
    assert (_rows_constexpr("kBProducerRegs")
            + 2 * _rows_constexpr("kBConsumerRegs")) * 128 \
        <= launch * fk.BF16_THREADS
    # a 64 x 256 f32 sum is 128 registers a consumer thread
    assert _rows_constexpr("kBConsumerRegs") >= 128 + 64


@pytest.mark.parametrize("cols", fk.BF16_TILE_COLS)
def test_bf16_ring_holds_the_partial_sum(cols):
    """The partial sum (128 rows of cols + 8 floats) reuses the ring, and a
    CTA fits one block's shared memory."""
    ring = fk.BF16_STAGES * 2 * fk.BF16_DEPTH * (fk.BF16_ROWS + cols)
    assert fk.BF16_ROWS * (cols + 8) * 4 <= ring
    assert fk.bf16_smem_bytes(cols) == 1024 + ring + 64 <= SMEM_LIMIT


def test_bf16_ablation_edits_apply_to_the_source():
    for name, edits in ffn_bf16.ABLATIONS.items():
        for old, new in edits:
            assert ROWS_SRC.count(old) == 1, (name, old)
            assert old != new
    for name, edits in ffn_bf16.TILE_ABLATIONS.items():
        for old, new in edits:
            assert HEADER.count(old) == 1, (name, old)
            assert old != new
    assert set(ffn_bf16.KEEPING_ABLATIONS) <= set(ffn_bf16.ABLATIONS) | set(
        ffn_bf16.TILE_ABLATIONS)
    assert set(ffn_bf16.SHAPES.values()) == set(BF16_SHAPES.values())
    assert tuple(fk.BF16_COLS) in ffn_bf16.TILE_VARIANTS
    assert (256, 128) in ffn_bf16.TILE_VARIANTS  # the cluster split
    for name, mangled in ffn_bf16.KERNELS.items():
        assert mangled.startswith("ffn_rows_bf16_kernelILi")


def test_bf16_workspace_is_checked():
    """A bf16 x takes a bf16 (n, dff) workspace: a float32 one, or one of
    another shape, is refused."""
    x, w1, w2 = (torch.from_numpy(t[0]).to(torch.bfloat16)
                 for t in _inputs(1, 5, 8, 16, seed=27))
    want = fk.ffn_rows_plain(x, w1, w2)
    good = torch.empty(5, 16, dtype=torch.bfloat16)
    assert torch.equal(fk.ffn_rows(x, w1, w2, work=good), want)
    for bad in (torch.empty(5, 16), torch.empty(5, 17, dtype=torch.bfloat16),
                torch.empty(16, 5, dtype=torch.bfloat16).t()):
        with pytest.raises(ValueError, match="work"):
            fk.ffn_rows(x, w1, w2, work=bad)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# (n, dff): ragged n around the body's 128-row tile and 64-row warpgroups,
# a ragged d_ff
RAGGED_ROWS = [(1, 2048), (257, 2048), (303, 2048), (305, 2048), (305, 520)]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n,dff", RAGGED_ROWS,
                         ids=[f"n{n}-dff{f}" for n, f in RAGGED_ROWS])
def test_cuda_rows_ragged_match_plain_and_repeat_bitwise(cuda_device, n, dff):
    x, w1, w2 = (torch.from_numpy(t[0]).to(cuda_device)
                 for t in _inputs(1, n, 512, dff, seed=24))
    got = fk.ffn_rows(x, w1, w2)
    again = fk.ffn_rows(x, w1, w2, work=torch.full((n, dff), float("nan"),
                                                   device=cuda_device))
    want = fk.ffn_rows_plain(x, w1, w2)
    one = ffn_f32.tf32_ffn_plain(torch, x, w1, w2, 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FFN_TOL)
    assert torch.equal(got, again)
    assert not torch.allclose(one, want, **FFN_TOL)


# a NaN as f32 arithmetic on the card makes it: all mantissa bits set
CARD_NAN = float(np.array([0x7FFFFFFF], np.uint32).view(np.float32)[0])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("entry", ["rows", "batched"])
def test_cuda_nan_in_x_reaches_its_rows_of_y(cuda_device, entry):
    """A NaN in x (the card's 0x7FFFFFFF) makes its row of y NaN and leaves
    every other row finite, as in the plain version: the TF32 split keeps
    it (rounding its bits as a finite value's would give a zero)."""
    x, w1, w2 = (torch.from_numpy(t).to(cuda_device)
                 for t in _inputs(2, 257, 512, 2048, seed=26))
    x[1, 200, 7] = CARD_NAN
    if entry == "rows":
        x, w1, w2 = x[1:], w1[1], w2[1]  # one expert's rows, as (1, C, d)
        got = fk.ffn_rows(x[0], w1, w2)[None]
        want = fk.ffn_rows_plain(x[0], w1, w2)[None]
    else:
        got, want = fk.ffn_batched(x, w1, w2), fk.ffn_batched_plain(x, w1, w2)
    torch.cuda.synchronize()
    nan_rows = torch.isnan(got).any(-1)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(nan_rows.sum()) == 1
    assert bool(torch.isnan(got[-1, 200]).all())
    assert bool(torch.isfinite(got[~nan_rows]).all())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("c", [1, 257, 303, 305])
def test_cuda_batched_ragged_slots_match_plain(cuda_device, c):
    x, w1, w2 = (torch.from_numpy(t).to(cuda_device)
                 for t in _inputs(8, c, 512, 520, seed=25))
    got = fk.ffn_batched(x, w1, w2)
    again = fk.ffn_batched(x, w1, w2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fk.ffn_batched_plain(x, w1, w2), **FFN_TOL)
    assert torch.equal(got, again)


@pytest.mark.needs_cuda
def test_cuda_library_reports_the_plan(cuda_device):
    assert ffn_f32.plan_mismatch() == {}


@pytest.mark.needs_cuda
def test_cuda_library_reports_the_bf16_plan(cuda_device):
    assert ffn_bf16.plan_mismatch() == {}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("cols", ffn_bf16.TILE_VARIANTS,
                         ids=["%dx%d" % c for c in ffn_bf16.TILE_VARIANTS])
def test_cuda_bf16_tile_variants_match_plain(cuda_device, cols):
    """Every pair of tile widths the bench times (the second product split
    over a cluster or not) gives y within FFN_BF16_TOL of the plain
    version."""
    from tenzing_tpu_torch.ops import kernel_lib

    x, w1, w2 = ffn_bf16.inputs(torch, cuda_device, 2047, 2048, seed=28)
    y = torch.empty_like(x)
    h = torch.empty(2047, 2048, dtype=torch.bfloat16, device=cuda_device)
    ffn_bf16.ex_call(torch, kernel_lib.lib(), x, w1, w2, y, h, cols)()
    want = fk.ffn_rows_plain(x, w1, w2)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), want.float(), **fk.FFN_BF16_TOL)


@pytest.mark.needs_cuda
def test_cuda_bf16_back_to_back_calls_repeat_bitwise(cuda_device):
    """Sixteen calls enqueued back to back on one stream, sharing one
    workspace, give the first call's bits."""
    x, w1, w2 = ffn_bf16.inputs(torch, cuda_device, 2048, 2048, seed=30)
    first = fk.ffn_rows(x, w1, w2)
    torch.cuda.synchronize()
    y = torch.empty_like(first)
    h = torch.empty(2048, 2048, dtype=torch.bfloat16, device=cuda_device)
    for _ in range(16):
        fk.ffn_rows(x, w1, w2, out=y, work=h)
    torch.cuda.synchronize()
    assert torch.equal(y, first)


@pytest.mark.needs_cuda
def test_cuda_bf16_nan_in_x_reaches_its_row_of_y(cuda_device):
    """A NaN in one x row makes that row of y NaN and leaves every other
    row finite, as in the plain version."""
    x, w1, w2 = ffn_bf16.inputs(torch, cuda_device, 257, 2048, seed=29)
    x[200, 7] = float("nan")
    got = fk.ffn_rows(x, w1, w2)
    want = fk.ffn_rows_plain(x, w1, w2)
    torch.cuda.synchronize()
    nan_rows = torch.isnan(got).any(-1)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert nan_rows.nonzero().flatten().tolist() == [200]
    assert bool(torch.isfinite(got[~nan_rows]).all())
