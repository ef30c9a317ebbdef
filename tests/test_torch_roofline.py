"""The port's per-workload cost models (tenzing_tpu_torch/bench/roofline.py)
against the reference's: the same FLOPs and bytes at several shapes; the
fraction-of-peak report against the H100's peaks; the driver's
``workload_cost`` against the reference's for the shapes its builders give.
Mirrors the cost-model tests of ``tests/test_roofline.py``."""

import pytest

from tenzing_tpu.bench import roofline as ref
from tenzing_tpu_torch.bench import roofline

SHAPES = {
    "attention_cost": [dict(batch=2, seq=1024, head_dim=128),
                       dict(batch=4, seq=8192, head_dim=128),
                       dict(batch=1, seq=64, head_dim=8, bytes_per_el=2)],
    "moe_cost": [dict(tokens=1024, d_model=64, d_ff=256),
                 dict(tokens=8192, d_model=512, d_ff=2048, staged=True),
                 dict(tokens=32, d_model=8, d_ff=16, staged=True, n_experts=4,
                      bytes_per_el=2)],
    "halo_cost": [dict(nq=3, lx=512, ly=512, lz=512, radius=3),
                  dict(nq=2, lx=4, ly=4, lz=4, radius=1, staged=False),
                  dict(nq=1, lx=8, ly=64, lz=128, radius=2, bytes_per_el=8)],
    "spmv_cost": [dict(m=1000, nnz=10_000), dict(m=150_000, nnz=1_500_000),
                  dict(m=8192, nnz=81_920, bytes_per_el=8)],
}
CASES = [(fn, kw) for fn, kws in SHAPES.items() for kw in kws]


@pytest.mark.parametrize("fn,kw", CASES,
                         ids=[f"{fn}-{i}" for i, (fn, _) in enumerate(CASES)])
def test_cost_models_equal_reference(fn, kw):
    mine, theirs = getattr(roofline, fn)(**kw), getattr(ref, fn)(**kw)
    assert (mine.flops, mine.hbm_bytes, mine.xfer_bytes) == \
        (theirs.flops, theirs.hbm_bytes, theirs.xfer_bytes)


def test_utilization_against_the_h100_peaks():
    c = roofline.attention_cost(batch=2, seq=1024, head_dim=128)
    u = c.utilization(1e-3)
    ru = ref.attention_cost(batch=2, seq=1024, head_dim=128).utilization(1e-3)
    for k in ("seconds", "tflops", "hbm_gbs", "xfer_gbs"):
        assert u[k] == ru[k]
    assert u["f32_frac"] == pytest.approx(
        c.flops / 1e-3 / roofline.H100_PEAK_F32_FLOPS, rel=1e-12)
    assert u["bf16_frac"] == pytest.approx(
        c.flops / 1e-3 / roofline.H100_PEAK_BF16_FLOPS, rel=1e-12)
    assert u["hbm_frac"] == pytest.approx(
        c.hbm_bytes / 1e-3 / roofline.H100_PEAK_HBM_BYTES, rel=1e-12)


def test_halo_cost_is_byte_bound():
    c = roofline.halo_cost(nq=3, lx=512, ly=512, lz=512, radius=3)
    faces = 2 * 3 * (512 * 512 * 3) * 3
    assert c.flops == 0.0
    assert c.hbm_bytes == 4.0 * faces * 4 and c.xfer_bytes == 2.0 * faces * 4


@pytest.mark.parametrize("workload", ["halo", "attn", "moe", "spmv"])
def test_workload_cost_equals_reference(workload):
    """The driver's cost of one iteration, from the fourth value its
    builders return, at the full-size shapes."""
    from tenzing_tpu.bench.driver import workload_cost as ref_workload_cost
    from tenzing_tpu_torch.bench import driver

    if workload == "halo":
        from tenzing_tpu.models.halo import HaloArgs as RefArgs
        from tenzing_tpu_torch.models.halo import HaloArgs

        kw = dict(nq=3, lx=512, ly=512, lz=512, radius=3)
        wargs, rargs = HaloArgs(**kw), RefArgs(**kw)
    elif workload == "attn":
        from tenzing_tpu.models.ring_attention import RingAttnArgs as RefArgs

        wargs = driver.attn_args(driver.DriverRequest(workload="attn"))
        rargs = RefArgs(n_devices=8, batch=4, seq_local=1024, head_dim=128)
    elif workload == "moe":
        from tenzing_tpu.models.moe_pipeline import MoEPipeArgs as RefArgs

        wargs = (driver.moe_args(driver.DriverRequest(workload="moe")), 0)
        rargs = (RefArgs(tokens=8192), 0)
    else:
        wargs = rargs = 150_000
    mine = driver.workload_cost(workload, wargs)
    theirs = ref_workload_cost(workload, (None, None, None, rargs))
    assert (mine.flops, mine.hbm_bytes, mine.xfer_bytes) == \
        (theirs.flops, theirs.hbm_bytes, theirs.xfer_bytes)
