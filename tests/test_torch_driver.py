"""The port's driver (tenzing_tpu_torch.bench.driver): the smoke search end
to end on the CPU, the reference's request/metric contract, and the
not-yet-ported flags."""

import dataclasses
import json

import pytest
import torch

from tenzing_tpu.bench import driver as ref_driver
from tenzing_tpu_torch.bench import driver

FAST = dict(smoke=True, mcts_iters=4, iters=3, search_iters=2)


def test_request_fields_and_defaults_equal_reference():
    mine = {f.name: f.default for f in dataclasses.fields(driver.DriverRequest)}
    ref = {f.name: f.default for f in dataclasses.fields(ref_driver.DriverRequest)}
    assert mine == ref


def test_smoke_driver_on_cpu_verified():
    res = driver.run(driver.DriverRequest(**FAST), device="cpu")
    line = json.loads(res.to_json_line())
    assert line["metric"] == ref_driver.metric_for(
        "halo", ref_driver.DriverRequest(smoke=True))
    assert line["unit"] == "us" and line["value"] > 0
    assert line["vs_baseline"] >= 1.0
    assert line["verified"] is True
    assert line["device"]["type"] == "cpu"
    # the smoke runs no climbs and reads no recorded warm starts, as in the
    # reference: nothing is skipped
    assert line["not_ported"] == {}
    assert line["climbs"] == []


def test_smoke_attn_driver_on_cpu():
    """The attn search on the CPU: the reference's metric; verified, or a
    winner demoted only for the bf16 rounding of acc and O (the gate's
    tolerance is the reference's)."""
    res = driver.run(driver.DriverRequest(workload="attn", **FAST),
                     device="cpu")
    line = json.loads(res.to_json_line())
    assert line["metric"] == ref_driver.metric_for(
        "attn", ref_driver.DriverRequest(workload="attn", smoke=True))
    assert line["unit"] == "us" and line["value"] > 0
    assert line["not_ported"] == {}
    if not line["verified"]:
        assert set(line["diverged"]) <= {"acc", "O"}, line
        assert res.demoted is not None


@pytest.mark.parametrize("workload", ["halo", "attn", "moe"])
def test_metric_and_lanes_equal_reference(workload):
    for smoke in (True, False):
        req = driver.DriverRequest(workload=workload, smoke=smoke)
        ref = ref_driver.DriverRequest(workload=workload, smoke=smoke)
        assert driver.metric_for(workload, req) == ref_driver.metric_for(
            workload, ref)
        assert driver.search_lanes(req) == ref_driver.search_lanes(ref)


@pytest.mark.parametrize("override", [
    dict(workload="spmv"), dict(workload="attn", chunk=True), dict(fuse_winner=True), dict(chunk=True),
    dict(synth_collectives=True), dict(learn_screen=True),
    dict(checkpoint="ckpt"), dict(inject_faults="flaky:0.1"),
    dict(profile_winner=True), dict(search_workers=2), dict(seed_csv="x.csv"),
    dict(prefetch_compiles=4), dict(workload="moe", chunk=True), dict(dump_csv="out.csv"),
])
def test_unported_flags_raise(override):
    with pytest.raises(driver.DriverConfigError, match="not yet ported"):
        driver.run(driver.DriverRequest(smoke=True, **override), device="cpu")


def test_default_device_is_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.run(driver.DriverRequest(**FAST))


def test_attn_default_device_is_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.run(driver.DriverRequest(workload="attn", **FAST))


def test_cli_prints_one_json_line(capsys):
    assert driver.main(["--smoke", "--device", "cpu", "--mcts-iters", "2",
                        "--iters", "3", "--search-iters", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0])["verified"] is True


def test_smoke_moe_driver_on_cpu():
    """The moe search on the CPU: the reference's ``_t32`` metric, verified
    (the smoke is the f32 host chain with no menus, as in the reference)."""
    res = driver.run(driver.DriverRequest(workload="moe", **FAST), device="cpu")
    line = json.loads(res.to_json_line())
    assert line["metric"] == ref_driver.metric_for(
        "moe", ref_driver.DriverRequest(workload="moe", smoke=True))
    assert line["metric"] == "moe_pipe_pct50_searched_t32"
    assert line["unit"] == "us" and line["value"] > 0
    assert line["verified"] is True
    assert line["not_ported"] == {} and line["climbs"] == []


@pytest.mark.parametrize("budget", [0, 8, 44])
def test_climb_budget_is_accepted(budget):
    for workload in driver.WORKLOADS:
        driver.check_request(driver.DriverRequest(workload=workload,
                                                  climb_budget=budget))
    res = driver.run(driver.DriverRequest(climb_budget=budget, **FAST),
                     device="cpu")
    assert res.verdict["verified"] is True


@pytest.mark.parametrize("workload", ["halo", "attn", "moe"])
def test_not_ported_names_the_recorded_warm_start(workload):
    """A full-size request reports the recorded warm start the reference
    would have read (its glob matches the committed databases); a smoke or
    seed_topk=0 request skips nothing."""
    import glob
    import os

    req = driver.DriverRequest(workload=workload)
    driver.check_request(req)
    meta = driver.not_ported_meta(req)
    pat = f"experiments/{workload}_search_tpu_r[45]*.csv"
    assert meta == {"recorded_warm_start": pat}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert glob.glob(os.path.join(repo, pat))
    assert driver.not_ported_meta(driver.DriverRequest(workload=workload,
                                                       smoke=True)) == {}
    assert driver.not_ported_meta(driver.DriverRequest(workload=workload,
                                                       seed_topk=0)) == {}


def test_moe_labels_name_staging_and_engine():
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models import moe_pipeline as pipe

    a = pipe.MoEPipeArgs(n_experts=4, tokens=32, d_model=8, d_ff=16,
                         n_chunks=2)
    cap = pipe.make_pipe_buffers(a, seed=0, with_expected=False)[2]
    plat = Platform.make_n_lanes(2)
    for st, en in (("f32", "host"), ("bf16", "rdma"), ("f32", "rdma"),
                   ("bf16", "host")):
        seq = pipe.greedy_overlap_order(a, cap, plat, staging=st, engine=en)
        assert driver.moe_staging_of(seq) == f"{st}-{en}"
    g = pipe.build_graph(a, cap, impl_choice=True, staging="choice")
    incumbents, seeds, policy = driver.moe_incumbents(g, plat, a, cap, False)
    assert [label for label, _ in incumbents] == [
        "greedy-overlap", "greedy-overlap-bf16", "greedy-bf16-rdma",
        "greedy-f32-rdma", "greedy-bf16-rdma-pallas"]
    kernel = incumbents[-1][1]
    assert driver.moe_staging_of(kernel) == "bf16-rdma"
    assert sum(op.name().endswith(".pallas") for op in kernel.vector()) == 2
    assert len(seeds) == 1 and policy is not None
