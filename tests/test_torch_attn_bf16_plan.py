"""The Python around the bf16 attention fold kernel (csrc/attn_fold.cu,
``attn_fold_bf16``), on the CPU: its launch plan, the wrapper's K/V cast,
the float64 fold the card diagnostics hold it against, and the ablation
edits of ``bench/attn_bf16.py``.  The kernel itself runs only on the card
(tests/test_torch_attention.py, marker ``needs_cuda``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tenzing_tpu_torch.bench import attn_bf16
from tenzing_tpu_torch.ops import attention_kernels as ak

SOURCE = (Path(__file__).resolve().parents[1] / "tenzing_tpu_torch" / "csrc"
          / "attn_fold.cu").read_text()

# (b, n, nkv, bkv, d): the attention workload's fused fold (8192 keys in
# blocks of 1024) and one block of its chain, the smoke's ragged block, a
# chunked sub-fold, and the card tests' shapes
PLAN_SHAPES = {
    "fused-main": (4, 8192, 8192, 1024, 128),
    "block-main": (4, 8192, 1024, 1024, 128),
    "block-ragged": (1, 1000, 1024, 1024, 128),
    "subfold-main": (4, 8192, 512, 512, 128),
    "card-bkv64": (2, 200, 256, 64, 128),
    "card-bkv200": (1, 300, 1000, 200, 128),
}


def _constexpr(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found, name
    return int(found.group(1))


SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may use


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_launch_plan_fits_the_card(shape):
    b, n, nkv, bkv, d = PLAN_SHAPES[shape]
    plan = ak.bf16_launch_plan(b, n, nkv, bkv, d)
    assert plan == ak.bf16_launch_plan(b, n, nkv, bkv, d)  # a pure function
    assert plan["grid"] == (-(-n // 128), b)
    assert plan["grid"][1] <= ak.GRID_Y_LIMIT
    assert plan["threads"] == 384 and plan["threads"] % 128 == 0
    assert plan["key_tile"] == 128 and plan["rows_per_cta"] == 128
    # every tile of the ring (128 keys x 128 bf16), plus the alignment
    # slack and the barriers, within what one block may use
    assert plan["smem_bytes"] == 1024 + 6 * 128 * 128 * 2 + 128 <= SMEM_LIMIT
    assert plan["kv_blocks"] == -(-nkv // min(bkv, nkv))


def test_main_shape_plan_numbers():
    plan = ak.bf16_launch_plan(*PLAN_SHAPES["fused-main"])
    assert plan["grid"] == (64, 4)  # 256 CTAs on 132 SMs
    assert plan["kv_blocks"] == 8
    assert (plan["k_stages"], plan["v_stages"]) == (4, 2)
    assert plan["smem_bytes"] == 197_760  # one CTA per SM


def test_plan_constants_match_the_kernel_source():
    """The plan's constants are the kernel's (the library's own report is
    checked against the plan on the card by chip_smoke.py)."""
    assert _constexpr("kKeyTile") == ak.BF16_KEY_TILE
    assert _constexpr("kKStages") == ak.BF16_K_STAGES
    assert _constexpr("kVStages") == ak.BF16_V_STAGES
    assert 64 * _constexpr("kConsumers") == ak.BF16_ROWS
    assert 128 * (_constexpr("kConsumers") + 1) == ak.BF16_THREADS
    assert (_constexpr("kProducerRegs")
            + _constexpr("kConsumerRegs") * _constexpr("kConsumers")) * 128 <= 65536


def _awkward_values(rng, shape):
    """Normal values with rounding ties, values one ulp beside them, huge
    and tiny magnitudes and infinities mixed in."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    bits = flat.view(np.uint32)
    bits[0::7] = (bits[0::7] & 0xFFFF0000) | 0x8000  # exact ties
    bits[1::7] = (bits[1::7] & 0xFFFF0000) | 0x8001  # just above a tie
    bits[2::7] = (bits[2::7] & 0xFFFF0000) | 0x7FFF  # just below a tie
    flat[3::11] *= 1e30
    flat[4::11] *= 1e-40  # float32 subnormals
    flat[5::97] = np.inf
    flat[6::97] = -np.inf
    return x


@pytest.mark.parametrize("layout", ["dense", "strided"])
def test_cast_kv_bf16_equals_round_bf16_bitwise(layout):
    rng = np.random.default_rng(5)
    if layout == "dense":
        k = torch.from_numpy(_awkward_values(rng, (2, 96, 128)))
        v = torch.from_numpy(_awkward_values(rng, (2, 96, 128)))
    else:  # a key range of a longer K/V with rows of 256, as the chain passes
        k = torch.from_numpy(_awkward_values(rng, (2, 288, 256)))[:, 96:192, :128]
        v = torch.from_numpy(_awkward_values(rng, (2, 288, 256)))[:, 96:192, 128:]
    kv = ak.cast_kv_bf16(k, v)
    assert kv.dtype == torch.bfloat16 and kv.shape == (2, 2, 96, 128)
    assert kv.is_contiguous()
    for got, src in zip(kv, (k, v)):
        want = ak._round_bf16(src)
        assert torch.equal(got.float().view(torch.int32), want.view(torch.int32))


def test_float64_fold_agrees_with_the_plain_fold():
    """bench/attn_bf16.fold_f64, which the card report holds the kernel and
    the plain version against, is the plain bf16 fold in float64."""
    q, k, v, st = attn_bf16.case_inputs(torch, torch.device("cpu"), 2, 64, 96,
                                        "mid", "dense", seed=3)
    want = [t.clone() for t in st]
    ak.attn_fused_plain(q, k, v, *want, 128 ** -0.5, 32, True)
    exact = attn_bf16.fold_f64(torch, q, k, v, st, 128 ** -0.5, 32)
    ok, errs = ak.state_check([t.double() for t in want], exact,
                              ak.BF16_STATE_TOL)
    assert ok, errs


@pytest.mark.parametrize("name", list(attn_bf16.STRESS_CASES))
def test_stress_cases_run_on_the_cpu(name):
    """Each stress case's inputs are well formed and its plain fold (what
    the wrapper runs on the CPU) is finite and changes the state."""
    kernel, b, n, nkv, bkv, state, layout = attn_bf16.STRESS_CASES[name]
    q, k, v, st = attn_bf16.case_inputs(torch, torch.device("cpu"), b, n, nkv,
                                        state, layout)
    assert q.shape == (b, n, 128) and k.shape == v.shape == (b, nkv, 128)
    assert nkv % bkv == 0 or kernel == "block"
    before = [t.clone() for t in st]
    if kernel == "block":
        ak.attn_block(q, k, v, *st, 128 ** -0.5, bf16_inputs=True)
    else:
        ak.attn_fused(q, k, v, *st, 128 ** -0.5, bkv=bkv, bf16_inputs=True)
    assert all(bool(torch.isfinite(t).all()) for t in st)
    assert not torch.equal(before[2], st[2])


@pytest.mark.parametrize("name", list(attn_bf16.ABLATIONS))
def test_ablation_edits_apply_to_the_source(name):
    for old, new in attn_bf16.ABLATIONS[name]:
        assert SOURCE.count(old) >= 1, old
        assert old != new


def test_ptxas_report_reads_one_kernel():
    text = "\n".join([
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 40 registers, 16 bytes smem",
        "ptxas info    : Compiling entry function '_ZN5bf16k14attn_fold_bf16E' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas warning : (C7508) setmaxnreg ignored",
    ])
    rep = attn_bf16.ptxas_report(text)
    assert rep["found"] and rep["registers"] == 168
    assert rep["spill_store_bytes"] == rep["spill_load_bytes"] == 0
    assert rep["static_smem_bytes"] == 0
    assert rep["warnings"] == ["ptxas warning : (C7508) setmaxnreg ignored"]
    assert not attn_bf16.ptxas_report("(library was cached)")["found"]


def test_cast_kv_bf16_writes_the_given_scratch():
    rng = np.random.default_rng(8)
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, 128)).astype(np.float32))
            for _ in range(2))
    shape, dtype = ak.kv_scratch_spec(2, 40, 128)
    out = torch.zeros(shape, dtype=getattr(torch, dtype))
    ptr = out.data_ptr()
    got = ak.cast_kv_bf16(k, v, out)
    assert got is out and out.data_ptr() == ptr
    assert torch.equal(out[1].float(), ak._round_bf16(v))
    with pytest.raises(ValueError):
        ak.cast_kv_bf16(k, v, torch.zeros((2, 2, 41, 128), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ak.cast_kv_bf16(k, v, torch.zeros(shape, dtype=torch.float32))
