"""The integrity gate, split by buffer role (bench/gate.py; ROADMAP Queue 3
item 4, a recorded deviation from the reference).

Result buffers are held to the float64 result at the tolerance of the
precision each schedule ran: attention's O at ``F32_O_TOL`` /
``BF16_O_TOL``, the MoE pipeline's Y at ``F32_Y_TOL`` / ``BF16_Y_TOL``.
Every other buffer keeps the reference's comparison with naive; halo and
spmv keep it for every buffer.  The faulty controls (a perturbed O or Y, a
perturbed input, a dropped expert, a corrupted schedule) must fail.

``BF16_O_TOL`` (largest error 1e-3, relative rms 7e-3) is a limit for the
driver's width: O averages over 8192 keys there, and the bf16 rounding of
q/k/v and p moves it by 4.9e-4 largest, 3.4e-3 relative rms on an H100
(PERF.md).  At the 64-key smoke width |O| is about 1 and the same rounding
reads 3.4e-3 largest, so the bf16 orders are held at a width of 4096 keys
(head dim 128, the driver's), where it reads 7.5e-4 largest, 3.3e-3
relative rms; at the smoke width the test pins that they fail (the limit is
not widened for them)."""

import pytest
import torch

from tenzing_tpu_torch.bench import driver, gate
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.models import moe_pipeline as mp
from tenzing_tpu_torch.models.ring_attention import (
    RingAttnArgs,
    fixed_orders,
    make_blocked_buffers,
)
from tenzing_tpu_torch.ops.attention_kernels import BF16_O_TOL, F32_O_TOL
from tenzing_tpu_torch.ops.ffn_kernels import BF16_Y_TOL, F32_Y_TOL
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.verify import ScheduleVerifier

SMOKE_ATTN = driver.attn_args(driver.DriverRequest(smoke=True,
                                                   workload="attn"))
# 4096 keys in 8 blocks, head dim 128 (the driver's), one batch element
WIDE_ATTN = RingAttnArgs(n_devices=8, batch=1, seq_local=512, head_dim=128)
TOL = driver.DriverRequest().verify_tol


def _attn(aargs):
    g = driver.attn_graph(aargs)
    bufs, _ = make_blocked_buffers(aargs, seed=0, with_expected=False)
    ex = StreamExecutor(Platform.make_n_lanes(2),
                        buffers_from_numpy(bufs, "cpu"), device="cpu")
    return g, ex, fixed_orders(g, aargs.n_devices)


@pytest.fixture(scope="module")
def attn_smoke():
    g, ex, orders = _attn(SMOKE_ATTN)
    outs = {k: ex.run(o) for k, o in orders.items()}
    return g, orders, outs, gate.attn_gate(outs["naive"], SMOKE_ATTN.scale)


@pytest.fixture(scope="module")
def attn_wide():
    g, ex, orders = _attn(WIDE_ATTN)
    outs = {k: ex.run(orders[k]) for k in ("naive", "fused_bf16",
                                           "pallas_bf16")}
    return g, orders, outs, gate.attn_gate(outs["naive"], WIDE_ATTN.scale)


@pytest.fixture(scope="module")
def moe_smoke():
    margs = driver.moe_args(driver.DriverRequest(smoke=True, workload="moe"))
    bufs, want64, cap = mp.make_pipe_buffers(margs, seed=0, staging="choice",
                                             expected_float64=True)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(
        bufs, "cpu", mp.host_buffer_names(margs, "choice")), device="cpu")
    orders = mp.fixed_orders(margs, cap)
    outs = {k: ex.run(o) for k, (o, _) in orders.items()}
    skip = (set(ex.host_names) | set(mp.host_buffer_names(margs, "choice"))
            | set(mp.transport_buffer_names(margs, "choice")))
    return (margs, bufs, orders, outs, skip,
            gate.moe_gate(want64, margs.n_chunks, "cpu"))


def _verdict(out_n, out_w, naive, winner, rg, skip=()):
    return gate.gate_outputs(out_n, out_w, naive, winner, TOL, skip, rg)


# -- the limits live once, in the package, at chip_smoke.py's values -------------

def test_limits_are_the_measured_ones():
    assert F32_O_TOL == dict(rtol=2e-4, atol=2e-5)
    assert BF16_O_TOL == {"rel_rms": 7e-3, "max_abs": 1e-3}
    assert F32_Y_TOL == dict(rtol=1e-4, atol=2e-5)
    assert BF16_Y_TOL == {"rel_rms": 5e-3, "max_abs": 3e-2}


def test_chip_smoke_takes_its_limits_from_the_package():
    import pathlib

    src = (pathlib.Path(__file__).resolve().parents[1]
           / "chip_smoke.py").read_text()
    for name in ("F32_O_TOL", "BF16_O_TOL", "F32_Y_TOL", "BF16_Y_TOL"):
        assert f"\n{name} = " not in src, f"chip_smoke.py defines {name}"
        assert name in src


# -- attention ----------------------------------------------------------------------

@pytest.mark.parametrize("label", ["naive", "pallas-2l", "fused"])
def test_attn_f32_orders_pass_at_the_smoke_width(attn_smoke, label):
    g, orders, outs, rg = attn_smoke
    bad, block = _verdict(outs["naive"], outs[label], orders["naive"],
                          orders[label], rg)
    assert bad == [] and block["winner"]["precision"] == "f32"
    assert block["winner"]["limit"] == F32_O_TOL
    errs = block["winner"]["buffers"]["O"]
    assert errs["ok"] and errs["max_abs"] < 1e-6
    assert ScheduleVerifier(g)(orders[label]).ok


@pytest.mark.parametrize("label", ["fused_bf16", "pallas_bf16"])
def test_attn_bf16_orders_pass_at_4096_keys(attn_wide, label):
    g, orders, outs, rg = attn_wide
    bad, block = _verdict(outs["naive"], outs[label], orders["naive"],
                          orders[label], rg)
    assert bad == [] and block["winner"]["precision"] == "bf16"
    assert block["winner"]["limit"] == BF16_O_TOL
    assert block["naive"]["precision"] == "f32"
    o = block["winner"]["buffers"]["O"]
    assert 1e-4 < o["max_abs"] <= BF16_O_TOL["max_abs"]
    assert 1e-3 < o["rel_rms"] <= BF16_O_TOL["rel_rms"]
    # the reference's raw comparison demotes the same winner
    assert gate.mismatched_outputs(outs["naive"], outs[label], TOL)


@pytest.mark.parametrize("label", ["fused_bf16", "pallas_bf16", "mixed-2l"])
def test_attn_bf16_orders_exceed_the_limit_at_the_smoke_width(attn_smoke,
                                                              label):
    """64 keys: bf16 rounding alone is above ``BF16_O_TOL``, and the limit
    is not widened for it, so a bf16 winner is demoted at this width."""
    _, orders, outs, rg = attn_smoke
    bad, block = _verdict(outs["naive"], outs[label], orders["naive"],
                          orders[label], rg)
    assert block["winner"]["precision"] == "bf16"
    assert "O" in bad
    assert 1e-3 < block["winner"]["buffers"]["O"]["max_abs"] < 1e-2


@pytest.mark.parametrize("fault", ["O+1e-2", "O nan", "acc*1.01", "Q+1",
                                   "V+0.5"])
def test_attn_faulty_controls_fail(attn_smoke, fault):
    _, orders, outs, rg = attn_smoke
    out = {k: v.clone() for k, v in outs["fused"].items()}
    if fault == "O+1e-2":
        out["O"][0, 3, 1] += 1e-2
    elif fault == "O nan":
        out["O"][0, 0, 0] = float("nan")
    elif fault == "acc*1.01":
        out["acc"] *= 1.01
    elif fault == "Q+1":
        out["Q"][0, 5, 2] += 1.0
    else:
        out["V"][0, 7, 0] += 0.5
    bad, _ = _verdict(outs["naive"], out, orders["naive"], orders["fused"],
                      rg)
    want = {"O+1e-2": {"O"}, "O nan": {"O"}, "acc*1.01": {"acc/l_run"},
            "Q+1": {"Q"}, "V+0.5": {"V"}}[fault]
    assert want <= set(bad)


def test_attn_bf16_bias_fails_on_its_relative_rms(attn_wide):
    """A bias of 2e-4 in every element of a bf16 O at 4096 keys: its largest
    error stays under ``BF16_O_TOL``'s, its relative rms does not, and the
    gate fails it (chip_smoke.py holds the same control at full width)."""
    g, orders, outs, rg = attn_wide
    out = {k: v.clone() for k, v in outs["fused_bf16"].items()}
    out["O"] += 2e-4
    bad, block = _verdict(outs["naive"], out, orders["naive"],
                          orders["fused_bf16"], rg)
    o = block["winner"]["buffers"]["O"]
    assert o["max_abs"] <= BF16_O_TOL["max_abs"]
    assert o["rel_rms"] > BF16_O_TOL["rel_rms"]
    assert "O" in bad and not o["ok"]


def test_attn_faulty_naive_fails_too(attn_smoke):
    """Both runs are held to float64: a wrong naive fails the gate."""
    _, orders, outs, rg = attn_smoke
    bad_naive = {k: v.clone() for k, v in outs["naive"].items()}
    bad_naive["O"] += 1e-3
    bad, block = _verdict(bad_naive, outs["fused"], orders["naive"],
                          orders["fused"], rg)
    assert "O" in bad and not block["naive"]["buffers"]["O"]["ok"]
    assert block["winner"]["buffers"]["O"]["ok"]


def test_corrupted_winner_fails_the_verifier(attn_smoke):
    """A winner with a sync op dropped or deferred (``corrupt_schedule``,
    what the chaos harness injects) fails the gate's verifier."""
    from tenzing_tpu_torch.fault import corrupt_schedule

    g, orders, _, _ = attn_smoke
    ver = ScheduleVerifier(g)
    n = 0
    for label in ("pallas-2l", "mixed-2l"):
        mut = corrupt_schedule(orders[label], seed=3,
                               unsound_check=lambda s: not ver(s).ok)
        if mut is not None:
            n += 1
            assert not ver(mut).ok
    assert n >= 1


# -- the MoE pipeline --------------------------------------------------------------

@pytest.mark.parametrize("label,precision", [
    ("greedy-overlap", "f32"), ("greedy-f32-rdma", "f32"),
    ("pallas-f32-rdma", "f32"), ("greedy-overlap-bf16", "bf16"),
    ("greedy-bf16-rdma", "bf16"), ("pallas-bf16-rdma", "bf16"),
])
def test_moe_orders_pass_at_the_smoke_width(moe_smoke, label, precision):
    margs, _, orders, outs, skip, rg = moe_smoke
    bad, block = _verdict(outs["naive"], outs[label], orders["naive"][0],
                          orders[label][0], rg, skip)
    assert bad == [] and block["winner"]["precision"] == precision
    assert block["winner"]["limit"] == (BF16_Y_TOL if precision == "bf16"
                                        else F32_Y_TOL)
    assert set(block["winner"]["buffers"]) == {"Y"} | {
        f"Y_{c}" for c in range(margs.n_chunks)}
    if precision == "bf16":
        # the reference's raw comparison demotes the same winner
        assert gate.mismatched_outputs(outs["naive"], outs[label], TOL,
                                         skip=skip)


def _drop_expert(bufs, margs, y, expert=0):
    out = y.clone()
    tc = margs.chunk_tokens
    for c in range(margs.n_chunks):
        w = torch.as_tensor(bufs[f"w_{c}"][expert])
        rows = torch.as_tensor(bufs[f"idx_{c}"][expert])[w > 0].long()
        out[c * tc + rows] = 0.0
    return out


@pytest.mark.parametrize("fault", ["dropped expert", "Y+0.05", "Y_1+0.05",
                                   "X+1", "W1*2"])
def test_moe_faulty_controls_fail(moe_smoke, fault):
    margs, bufs, orders, outs, skip, rg = moe_smoke
    label = "pallas-bf16-rdma"
    out = {k: v.clone() for k, v in outs[label].items()}
    if fault == "dropped expert":
        out["Y"] = _drop_expert(bufs, margs, out["Y"])
    elif fault == "Y+0.05":
        out["Y"][3, 2] += 0.05
    elif fault == "Y_1+0.05":
        out["Y_1"][0, 0] += 0.05
    elif fault == "X+1":
        out["X"][1, 1] += 1.0
    else:
        out["W1"] *= 2.0
    bad, _ = _verdict(outs["naive"], out, orders["naive"][0],
                      orders[label][0], rg, skip)
    want = {"dropped expert": {"Y"}, "Y+0.05": {"Y"}, "Y_1+0.05": {"Y_1"},
            "X+1": {"X"}, "W1*2": {"W1"}}[fault]
    assert want <= set(bad)


def test_y_check_matches_the_gate(moe_smoke):
    margs, bufs, orders, outs, skip, rg = moe_smoke
    y = outs["greedy-bf16-rdma"]["Y"]
    ok, errs = gate.within(y, rg.expected["Y"], BF16_Y_TOL)
    entry = rg.check(outs["greedy-bf16-rdma"],
                     orders["greedy-bf16-rdma"][0])[1]["buffers"]["Y"]
    assert ok and entry == {**errs, "ok": True}
    dropped = _drop_expert(bufs, margs, y)
    assert not gate.within(dropped, rg.expected["Y"], BF16_Y_TOL)[0]


# -- halo and spmv: the reference's verdicts, unchanged ---------------------------------

def _halo():
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import (
        greedy_overlap_order,
        host_buffer_names,
        make_pipeline_buffers,
        naive_order,
    )

    hargs = HaloArgs(nq=2, lx=4, ly=4, lz=4, radius=1)
    bufs, _ = make_pipeline_buffers(hargs, seed=0, with_expected=False)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(
        bufs, "cpu", host_buffer_names()), device="cpu")
    plat = Platform.make_n_lanes(2)
    orders = {"naive": naive_order(hargs, Platform.make_n_lanes(1)),
              "greedy-host": greedy_overlap_order(hargs, plat, "host"),
              "greedy-rdma": greedy_overlap_order(hargs, plat, "rdma")}
    return ex, orders, "U", set(ex.host_names) | set(host_buffer_names())


def _spmv():
    from tenzing_tpu_torch.models.spmv import (
        fixed_orders as spmv_orders,
        spmv_host_buffer_names,
    )

    g, bufs, _, _ = driver.build_spmv(
        driver.DriverRequest(smoke=True, workload="spmv"), "cpu")
    ex = StreamExecutor(Platform.make_n_lanes(2), bufs, device="cpu")
    return (ex, spmv_orders(g), "y",
            set(ex.host_names) | set(spmv_host_buffer_names()))


@pytest.mark.parametrize("workload", ["halo", "spmv"])
def test_halo_and_spmv_verdicts_are_unchanged(workload):
    ex, orders, result, skip = {"halo": _halo, "spmv": _spmv}[workload]()
    outs = {k: ex.run(o) for k, o in orders.items()}
    n = 0
    for label, order in orders.items():
        for perturb in (False, True):
            out = {k: v.clone() for k, v in outs[label].items()}
            if perturb:
                out[result].view(-1)[0] += 1.0
            bad, block = gate.gate_outputs(outs["naive"], out,
                                           orders["naive"], order, TOL, skip,
                                           None)
            assert block is None
            assert bad == gate.mismatched_outputs(outs["naive"], out, TOL,
                                                    skip=skip)
            assert (bad == []) == (not perturb)
            n += 1
    assert n >= 4
