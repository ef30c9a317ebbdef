"""The Python around the f32 attention fold kernel (csrc/attn_fold_f32.cuh,
split-TF32 on ``wgmma``), on the CPU: its launch plan, the TF32 split, a
plain emulation of the kernel's arithmetic against the JAX reference, the
single-TF32-pass control, the stress cases and the ablation edits of
``bench/attn_f32.py``.  The kernel itself runs only on the card
(tests/test_torch_attention.py, marker ``needs_cuda``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenzing_tpu.ops.attention_pallas import attn_block_pallas
from tenzing_tpu_torch.bench import attn_f32
from tenzing_tpu_torch.ops import attention_kernels as ak

CSRC = Path(__file__).resolve().parents[1] / "tenzing_tpu_torch" / "csrc"
HEADER = (CSRC / "attn_fold_f32.cuh").read_text()

# (b, n, nkv, d): the attention workload's fused fold and one block of its
# chain, the smoke's ragged block, a chunked sub-fold, the card tests' shape
PLAN_SHAPES = {
    "fused-main": (4, 8192, 8192, 128),
    "block-main": (4, 8192, 1024, 128),
    "block-ragged": (1, 1000, 1024, 128),
    "subfold-main": (4, 8192, 512, 128),
    "card-ragged": (2, 200, 256, 128),
}
SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may use
SM_SHARED = 233_472  # shared memory of one SM (228 KB) for resident blocks


def _constexpr(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", HEADER)
    assert found, name
    return int(found.group(1))


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_launch_plan_fits_the_card(shape):
    b, n, nkv, d = PLAN_SHAPES[shape]
    plan = ak.f32_launch_plan(b, n, nkv, d)
    assert plan == ak.f32_launch_plan(b, n, nkv, d)  # a pure function
    assert plan["grid"] == (-(-n // 128), b)
    assert plan["grid"][1] <= ak.GRID_Y_LIMIT
    assert plan["threads"] == 384 and plan["threads"] % 128 == 0
    assert plan["key_tile"] == 32 and plan["rows_per_cta"] == 128
    # the ring (3 K + 2 V stages of 32 keys, TF32 hi and lo), both consumer
    # warpgroups' q_lo, the alignment slack and the barriers: one block fits,
    # a second does not (one CTA per SM)
    assert plan["smem_bytes"] == (1024 + 2 * 64 * 128 * 4
                                  + 5 * 2 * 32 * 128 * 4 + 128)
    assert plan["smem_bytes"] <= SMEM_LIMIT < 2 * plan["smem_bytes"]
    assert 2 * plan["smem_bytes"] > SM_SHARED
    assert plan["key_tiles"] == -(-nkv // 32)


def test_main_shape_plan_numbers():
    plan = ak.f32_launch_plan(*PLAN_SHAPES["fused-main"])
    assert plan["grid"] == (64, 4)  # 256 CTAs on 132 SMs
    assert plan["key_tiles"] == 256
    assert (plan["k_stages"], plan["v_stages"]) == (3, 2)
    assert plan["smem_bytes"] == ak.F32_SMEM_BYTES == 230_528


def test_plan_constants_match_the_kernel_source():
    """The plan's constants are the kernel's (the library's own report is
    checked against the plan on the card by chip_smoke.py)."""
    assert _constexpr("kKeyTile") == ak.F32_KEY_TILE
    assert _constexpr("kKStages") == ak.F32_K_STAGES
    assert _constexpr("kVStages") == ak.F32_V_STAGES
    assert _constexpr("kHeadDim") in ak.KERNEL_HEAD_DIMS
    assert 64 * _constexpr("kConsumers") == ak.F32_ROWS
    assert 128 * (_constexpr("kConsumers") + 1) == ak.F32_THREADS
    # setmaxnreg moves registers between the CTA's own warps: the shares may
    # not exceed what the CTA holds at launch (65,536 / 384 threads, in
    # steps of 8: 168 a thread), or the consumers' increase waits forever
    assert _constexpr("kLaunchRegs") == 65536 // ak.F32_THREADS // 8 * 8 == 168
    assert (_constexpr("kProducerRegs")
            + _constexpr("kConsumerRegs") * _constexpr("kConsumers")) * 128 \
        <= _constexpr("kLaunchRegs") * ak.F32_THREADS
    assert _constexpr("kProducerRegs") % 8 == 0
    assert _constexpr("kConsumerRegs") % 8 == 0


def _awkward_values(rng, size):
    """Normal values with TF32 rounding ties, values one ulp beside them,
    subnormals, signed zeros and large exponents."""
    x = rng.standard_normal(size).astype(np.float32)
    bits = x.view(np.uint32)
    bits[0::9] = (bits[0::9] & 0xFFFFE000) | 0x1000  # exact ties
    bits[1::9] = (bits[1::9] & 0xFFFFE000) | 0x1001  # just above a tie
    bits[2::9] = (bits[2::9] & 0xFFFFE000) | 0x0FFF  # just below a tie
    x[3::11] *= np.float32(1e30)
    x[4::11] *= np.float32(1e-40)  # float32 subnormals
    x[5::13] = 0.0
    x[6::13] = -0.0
    x[7::17] = np.float32(3e38)
    return x


def _split(x):
    hi, lo = attn_f32.split_tf32(torch, torch.from_numpy(x))
    return hi.numpy(), lo.numpy()


def test_split_hi_and_lo_have_tf32_mantissas():
    x = _awkward_values(np.random.default_rng(1), 4096)
    hi, lo = _split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.array_equal(np.signbit(hi[x == 0]), np.signbit(x[x == 0]))


def test_split_keeps_infinities_and_nans():
    """A NaN with its top mantissa bits set (0x7FFFFFFF, the card's own)
    carries into a zero under hi's add-and-clear rounding; lo is rounded as
    cvt.rna.tf32.f32 rounds, which keeps it, so every NaN x has a NaN lo and
    its products are NaN.  Infinities stay in hi (lo = inf - inf is NaN, as
    with the conversion), and a value that rounds past the largest float
    gives an infinite hi, as the conversion does."""
    nans = np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0x7F801000],
                    np.uint32).view(np.float32)
    hi, lo = _split(nans)
    assert np.isnan(lo).all()
    assert np.isnan(hi[2:]).all() and (hi[:2] == 0).all()
    infs = np.array([np.inf, -np.inf], np.float32)
    hi, lo = _split(infs)
    assert np.array_equal(hi, infs) and np.isnan(lo).all()
    big = np.array([3.4028235e38, -3.4028235e38], np.float32)  # rounds past max
    hi, lo = _split(big)
    assert np.array_equal(hi, [np.inf, -np.inf])
    assert np.array_equal(lo, [-np.inf, np.inf])


def test_split_rounds_ties_away_from_zero():
    base = np.array([1.0, 1.5, 3.0, 1e-3, 7e20], np.float32)
    for sign in (1, -1):
        x = (sign * base).astype(np.float32)
        tie = ((x.view(np.uint32) & 0xFFFFE000) | 0x1000).view(np.float32)
        hi, _ = _split(tie)
        up = ((tie.view(np.uint32) & 0xFFFFE000) + 0x2000).view(np.float32)
        assert np.array_equal(hi, up)  # away from zero for either sign
        assert (np.abs(hi) > np.abs(tie)).all()
        below = ((x.view(np.uint32) & 0xFFFFE000) | 0x0FFF).view(np.float32)
        assert np.array_equal(_split(below)[0],
                              (below.view(np.uint32) & 0xFFFFE000).view(np.float32))


def test_split_reconstructs_to_two_to_the_minus_22():
    x = _awkward_values(np.random.default_rng(2), 8192)
    hi, lo = _split(x)
    err = np.abs(x.astype(np.float64) - (hi.astype(np.float64) + lo))
    # relative 2^-22, or half TF32's subnormal spacing (2^-137)
    assert (err <= 2.0 ** -22 * np.abs(x.astype(np.float64)) + 2.0 ** -137).all()
    assert np.isfinite(hi).all() and np.isfinite(lo).all()


def _ref_block(q, k, v, acc, m, l, scale):
    out = attn_block_pallas(*(jnp.asarray(t) for t in (q, k, v, acc, m, l)),
                            scale, interpret=True)
    return [torch.from_numpy(np.array(o, np.float32)) for o in out]


def _fold_inputs(seed, mid):
    b, n, nkv, d = 2, 96, 80, 128
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, n, d), (b, nkv, d), (b, nkv, d)))
    if mid:
        acc = rng.standard_normal((b, n, d)).astype(np.float32)
        m = np.broadcast_to(rng.standard_normal((b, n, 1)), (b, n, d)).astype(np.float32)
        l = np.broadcast_to(rng.uniform(1, 4, (b, n, 1)), (b, n, d)).astype(np.float32)
    else:
        acc = np.zeros((b, n, d), np.float32)
        m = np.full((b, n, d), -1e30, np.float32)
        l = np.zeros((b, n, d), np.float32)
    return q, k, v, acc, m, l


@pytest.mark.parametrize("mid", [False, True], ids=["init", "mid"])
def test_split_fold_matches_reference_and_single_pass_does_not(mid):
    """The kernel's arithmetic (three TF32 passes) agrees with the JAX
    reference's f32 fold (interpret mode) at ``F32_STATE_TOL``; one TF32
    pass is rejected, by the relative-rms limit on acc / l among others."""
    host = _fold_inputs(11, mid)
    scale = 128 ** -0.5
    want = _ref_block(*host, scale)
    q, k, v = (torch.from_numpy(x) for x in host[:3])
    results = {}
    for passes in (3, 1):
        st = [torch.from_numpy(x.copy()) for x in host[3:]]
        attn_f32.tf32_fold_plain(torch, q, k, v, st, scale, passes)
        results[passes] = ak.state_check(st, want, ak.F32_STATE_TOL)
    ok3, errs3 = results[3]
    ok1, errs1 = results[1]
    limit = ak.F32_STATE_TOL["rel_rms"]
    assert ok3, errs3
    assert errs3["acc/l"]["rel_rms"] < limit / 4
    assert not ok1
    assert errs1["acc/l"]["rel_rms"] > 4 * limit


def test_f32_state_tolerance_keeps_its_allclose_limits():
    """The relative-rms limit tightens the f32 state check; the allclose
    limits stay the reference's f32 ones (tests/test_ring_attention.py:76)."""
    for key in ("acc/l", "m", "l"):
        assert ak.F32_STATE_TOL[key] == dict(rtol=2e-4, atol=2e-5)
    assert 0 < ak.F32_STATE_TOL["rel_rms"] < ak.BF16_STATE_TOL["rel_rms"]


@pytest.mark.parametrize("name", list(attn_f32.STRESS_CASES))
def test_stress_cases_run_on_the_cpu(name):
    """Each stress case's inputs are well formed and its plain fold (what
    the wrapper runs on the CPU) is finite, changes the state and passes
    its own check."""
    kernel, b, n, nkv, bkv, state, layout = attn_f32.STRESS_CASES[name]
    q, k, v, st = attn_f32.case_inputs(torch, torch.device("cpu"), b, n, nkv,
                                       state, layout)
    assert q.shape == (b, n, 128) and k.shape == v.shape == (b, nkv, 128)
    assert nkv % bkv == 0 or kernel == "block"
    ok, info = attn_f32.run_case(torch, torch.device("cpu"), name)
    assert ok and info["finite"], info
    before = [t.clone() for t in st]
    if kernel == "block":
        ak.attn_block(q, k, v, *st, 128 ** -0.5)
    else:
        ak.attn_fused(q, k, v, *st, 128 ** -0.5, bkv=bkv)
    assert not torch.equal(before[2], st[2])


def test_stress_cases_cover_the_ragged_edges():
    cases = attn_f32.STRESS_CASES.values()
    assert any(n % ak.F32_ROWS for _, _, n, _, _, _, _ in cases)
    assert any(nkv % ak.F32_KEY_TILE for _, _, _, nkv, _, _, _ in cases)
    assert {"strided", "x8"} <= {layout for *_, layout in cases}
    assert any(state == "init" for *_, state, _ in cases)
    assert attn_f32.REGION_CASE["key_off"] > 0


def test_region_case_runs_and_rejects_its_control_on_the_cpu():
    ok, info = attn_f32.run_region_case(torch, torch.device("cpu"))
    assert ok, info
    assert info["kernel"]["within_tol"] and not info["control"]["within_tol"]


@pytest.mark.parametrize("name", list(attn_f32.ABLATIONS))
def test_ablation_edits_apply_to_the_source(name):
    for old, new in attn_f32.ABLATIONS[name]:
        assert HEADER.count(old) == 1 or (name in ("no-exp", "expf")
                                          and HEADER.count(old) >= 1), old
        assert old != new
    assert set(attn_f32.CHECKED_ABLATIONS) <= set(attn_f32.ABLATIONS)


def test_ptxas_reports_read_both_instantiations():
    text = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113attn_fold_f32ILb1EEvPKfS2_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 3 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113attn_fold_f32ILb0EEvPKfS2_' for 'sm_90a'",
        "    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 168 registers, used 3 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_124fused_region_attn_kernelE5Table' for 'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 168 registers, used 3 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119fused_region_kernelE5Table' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
    ])
    rep = attn_f32.ptxas_reports(text)
    dense, strided = (rep[name] for name in attn_f32.KERNELS[:2])
    assert dense["registers"] == strided["registers"] == 168
    assert dense["spill_store_bytes"] == 0
    assert strided["spill_store_bytes"] == 16
    assert rep["fused_region_attn_kernel"]["spill_store_bytes"] == 8


def _sass(name, body):
    """A cuobjdump -sass listing of one function: (address, instruction)."""
    lines = [f"\t\tFunction : {name}"]
    lines += [f"        /*{a:04x}*/                   {i} ;  /* 0x0 */"
              for a, i in body]
    return "\n".join(lines)


def test_spill_placement_counts_each_loop():
    """bench/attn_common.spill_placement: the consumers' loop holds every
    HGMMA, the producer's the LDG and STS; a spill is counted by its
    innermost loop, and a loop around both counts as around them."""
    from tenzing_tpu_torch.bench import attn_common

    body = [(0x00, "STL [R1], R2"),  # straight
            (0x10, "MOV R0, RZ"),  # the item loop starts
            (0x20, "HGMMA.64x32x8.F32.TF32 R24, gdesc[UR4], RZ"),
            (0x30, "@P0 LDL.LU R2, [R1]"),  # consumer loop
            (0x40, "HGMMA.64x32x8.F32.TF32 R24, gdesc[UR8], R24"),
            (0x50, "@P1 BRA 0x20"),
            (0x60, "STL [R1+0x4], R3"),  # around the loops
            (0x70, "LDG.E.128 R4, desc[UR4][R8.64]"),
            (0x80, "STL [R1+0x8], R4"),  # producer loop
            (0x90, "STS.128 [R9], R4"),
            (0xa0, "@!P2 BRA 0x70"),
            (0xb0, "BRA 0x10"),
            (0xc0, "LDL R5, [R1+0x8]"),  # straight
            (0xd0, "EXIT")]
    text = "\n".join([_sass("_Z5otherv", [(0, "STL [R1], R0")]),
                      _sass("_ZN1_13attn_fold_f32ILb1EEvPKf", body)])
    rep = attn_common.spill_placement(text, "attn_fold_f32ILb1")
    assert rep["found"] and rep["hgmma"] == 2
    assert rep["consumer_loop"]["at"] == ["00020", "00050"]
    assert rep["producer_loop"]["at"] == ["00070", "000a0"]
    assert rep["spills"] == {"consumer_loop": 1, "producer_loop": 1,
                             "around_loops": 1, "other_loop": 0,
                             "straight": 2}
    assert rep["listed"]["consumer_loop"] == ["@P0 LDL.LU R2, [R1]"]
    assert not attn_common.spill_placement(text, "fused_region_attn")["found"]


def test_dense_o_matches_the_plain_fold():
    q, k, v, st = attn_f32.case_inputs(torch, torch.device("cpu"), 2, 64, 96,
                                       "init", "dense", seed=3)
    ak.attn_fused_plain(q, k, v, *st, 128 ** -0.5, 32)
    o = attn_f32.dense_o_f64(torch, q, k, v, 128 ** -0.5)
    torch.testing.assert_close(st[0] / st[2], o, rtol=2e-4, atol=2e-5)
