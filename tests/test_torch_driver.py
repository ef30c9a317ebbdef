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
    assert line["not_ported"] == {"climb_budget": 44}


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


@pytest.mark.parametrize("workload", ["halo", "attn"])
def test_metric_and_lanes_equal_reference(workload):
    for smoke in (True, False):
        req = driver.DriverRequest(workload=workload, smoke=smoke)
        ref = ref_driver.DriverRequest(workload=workload, smoke=smoke)
        assert driver.metric_for(workload, req) == ref_driver.metric_for(
            workload, ref)
        assert driver.search_lanes(req) == ref_driver.search_lanes(ref)


@pytest.mark.parametrize("override", [
    dict(workload="moe"), dict(workload="attn", chunk=True), dict(fuse_winner=True), dict(chunk=True),
    dict(synth_collectives=True), dict(learn_screen=True),
    dict(checkpoint="ckpt"), dict(inject_faults="flaky:0.1"),
    dict(profile_winner=True), dict(search_workers=2), dict(seed_csv="x.csv"),
    dict(prefetch_compiles=4), dict(climb_budget=8), dict(dump_csv="out.csv"),
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
