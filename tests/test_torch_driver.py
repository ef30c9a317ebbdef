"""The port's driver (tenzing_tpu_torch.bench.driver): the smoke search end
to end on the CPU, the reference's request/metric contract, and the
not-yet-ported flags.  The recorded warm start, the database dump and the
telemetry flags have their own files (test_torch_recorded.py,
test_torch_obs.py, test_torch_attrib.py)."""

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
    assert "not_ported" not in line and "recorded" not in line
    assert line["climbs"] == [] and line["recorded_seeds"] == 0


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
    assert "not_ported" not in line
    if not line["verified"]:
        assert set(line["diverged"]) <= {"acc", "O"}, line
        assert res.demoted is not None


@pytest.mark.parametrize("workload", ["halo", "attn", "moe", "spmv"])
def test_metric_and_lanes_equal_reference(workload):
    for smoke in (True, False):
        for extra in ({}, dict(m=8192), dict(spmv_bw=64)):
            req = driver.DriverRequest(workload=workload, smoke=smoke, **extra)
            ref = ref_driver.DriverRequest(workload=workload, smoke=smoke,
                                           **extra)
            assert driver.metric_for(workload, req) == ref_driver.metric_for(
                workload, ref)
            assert driver.search_lanes(req) == ref_driver.search_lanes(ref)


@pytest.mark.parametrize("override", [
    dict(workload="attn", search_workers=2), dict(workload="moe",
                                                   measure_batch=2),
    dict(synth_collectives=True, search_workers=2),
    dict(learn_screen=True, learn_model="m.json", measure_batch=2),
    dict(workload="attn", synth_collectives=True, measure_batch=4),
    dict(workload="spmv", learn_screen=True, learn_model="m.json",
         search_workers=2),
    dict(search_workers=2), dict(measure_batch=4),
    dict(workload="spmv", learn_model="m.json", search_workers=4),
    dict(workload="moe", learn_model="m.json", measure_batch=2),
    dict(learn_train=["a.csv"], search_workers=2),
    dict(workload="spmv", learn_train=["a.csv"], learn_trace=["t"],
         measure_batch=2),
])
def test_unported_flags_raise(override):
    """The fleet's flags, once refused as not yet ported, now pass the
    request check, also beside the synth and learn flags (the refusals that
    remain: ``test_fault_flag_refusals``); the fleet itself runs in
    ``test_fleet_flags_run_on_cpu``."""
    driver.check_request(driver.DriverRequest(smoke=True, **override))
    assert not hasattr(driver, "_UNPORTED")


@pytest.mark.parametrize("workers,batch", [(1, 1), (2, 4)])
def test_fleet_flags_run_on_cpu(workers, batch):
    """``--search-workers N --measure-batch K`` on the spmv smoke: with no
    climb configs the two ``generic_xla`` jobs split the climb budget;
    ``(1, 1)`` runs them inline, ``(2, 4)`` over two workers with fused
    rounds; ``perf.distributed`` carries the fleet's block."""
    res = driver.run(driver.DriverRequest(
        workload="spmv", climb_budget=4, search_workers=workers,
        measure_batch=batch, **FAST), device="cpu")
    v = res.verdict
    st = v["perf"]["distributed"]
    assert v["verified"] is True
    assert (st["workers"], st["measure_batch"]) == (workers, batch)
    assert st["jobs"] == 2 and st["failed_jobs"] == 0
    assert st["candidates"] >= 2
    if workers > 1:
        assert st["rounds"] >= 1 and 0 < st["batch_occupancy"] <= 1
        assert st["worker_cuda_initialized"] == {"0": False, "1": False}
    else:
        assert st["rounds"] == 0 and st["batch_occupancy"] is None


def test_no_fleet_block_without_the_flags():
    """(0, 0) keeps the climb loop: no ``perf.distributed``."""
    v = driver.run(driver.DriverRequest(workload="spmv", climb_budget=4,
                                        **FAST), device="cpu").verdict
    assert "distributed" not in v["perf"]


@pytest.mark.parametrize("override,match", [
    (dict(resume=True), "requires --checkpoint"),
    (dict(workload="spmv", resume=True), "requires --checkpoint"),
    (dict(inject_faults="corrupt:0.5:1", no_verify=True),
     "requires the soundness verifier"),
    (dict(inject_faults="flaky:0.1"), "kind:rate:seed"),
    (dict(inject_faults="bogus:0.1:1"), "want one of"),
    (dict(measure_timeout=0.0), "positive"),
])
def test_fault_flag_refusals(override, match):
    """The reference's refusals of the fault flags (bench/driver.py:652-655,
    :930-934): a resume with nothing to resume, corruption without the
    verifier, a malformed chaos spec; and a watchdog bound that is not
    positive."""
    with pytest.raises(driver.DriverConfigError, match=match):
        driver.run(driver.DriverRequest(**{**FAST, **override}), device="cpu")


SPMV_CHAOS = dict(workload="spmv", measure_timeout=30.0,
                  inject_faults="transient:0.3:1,deterministic:0.2:3,"
                                "corrupt:0.3:4")


def _measured_lines(ckdir):
    with open(f"{ckdir}/measurements.jsonl") as f:
        return [line for line in f if '"batch"' not in line]


def test_fault_block_checkpoint_and_resume(tmp_path):
    """--checkpoint with --inject-faults: the reference's fault block
    (degraded, quarantined, resumed, injected), a journal and a quarantine
    on disk.  --resume of the finished run restores every journaled row,
    measures nothing (no measured line is appended) and reports the same
    schedule and value; a resume under another chaos spec is refused."""
    ckdir = str(tmp_path / "ckpt")
    first = driver.run(driver.DriverRequest(checkpoint=ckdir, **FAST,
                                            **SPMV_CHAOS), device="cpu").verdict
    fault = first["fault"]
    assert set(fault) == {"degraded", "quarantined", "resumed", "injected",
                          "failures"}
    assert fault["degraded"] is False and fault["resumed"] is False
    assert fault["injected"]["transient"] > 0
    assert fault["failures"]["fault.errors.transient"] > 0
    assert fault["failures"]["fault.retries"] > 0
    assert fault["quarantined"] >= 1 and first["verified"] is True
    lines = _measured_lines(ckdir)
    state = json.load(open(f"{ckdir}/state.json"))["payload"]
    assert state["done"] is True and state["inject"] == SPMV_CHAOS[
        "inject_faults"]
    assert state["config"]["metric"] == first["metric"]

    again = driver.run(driver.DriverRequest(checkpoint=ckdir, resume=True,
                                            **FAST, **SPMV_CHAOS),
                       device="cpu").verdict
    assert again["fault"]["resumed"] is True
    assert _measured_lines(ckdir) == lines
    for key in ("value", "vs_baseline", "winner_label", "naive_us",
                "verified"):
        assert again[key] == first[key], key
    assert again["perf"]["prefetch"]["workers"] == 0  # off under --resume

    with pytest.raises(driver.DriverConfigError, match="disagrees"):
        driver.run(driver.DriverRequest(
            checkpoint=ckdir, resume=True, **FAST,
            **{**SPMV_CHAOS, "inject_faults": "transient:0.3:2"}),
            device="cpu")


def test_no_fault_block_on_a_clean_run():
    r = driver.run(driver.DriverRequest(**FAST), device="cpu").verdict
    assert "fault" not in r and "gate" not in r


def _fail_at(monkeypatch, k: int, exc: BaseException):
    """Make the k-th measurement of the run raise ``exc`` (no fault flag)."""
    from tenzing_tpu_torch.bench.benchmarker import EmpiricalBenchmarker

    real, calls = EmpiricalBenchmarker.benchmark, [0]

    def benchmark(self, order, opts=None):
        calls[0] += 1
        if calls[0] == k:
            raise exc
        return real(self, order, opts)

    monkeypatch.setattr(EmpiricalBenchmarker, "benchmark", benchmark)
    return calls


def test_a_failure_searched_past_is_reported(monkeypatch):
    """A measurement that fails in a run with no fault flag: the schedule is
    quarantined and the search goes on, and the ``fault`` block counts the
    failure, so the run is not taken for a clean one."""
    _fail_at(monkeypatch, 3, ValueError("operand shape mismatch"))
    r = driver.run(driver.DriverRequest(**FAST), device="cpu").verdict
    fault = r["fault"]
    assert fault["quarantined"] == 1 and "injected" not in fault
    assert fault["failures"]["fault.errors.deterministic"] == 1
    assert fault["failures"]["search.candidate_failed"] >= 1


@pytest.mark.parametrize("message", [
    "CUDA error: invalid argument",
    "CUDA error: an illegal memory access was encountered"])
def test_a_cuda_error_ends_the_run(monkeypatch, message):
    """Any CUDA error, sticky or not, leaves the run as ``DeviceLostError``:
    no search goes on in the process after one."""
    from tenzing_tpu_torch.fault import DeviceLostError

    calls = _fail_at(monkeypatch, 3, RuntimeError(message))
    with pytest.raises(DeviceLostError, match="CUDA error"):
        driver.run(driver.DriverRequest(**FAST), device="cpu")
    assert calls[0] == 3


@pytest.mark.parametrize("n", [0, 1, 3])
def test_prefetch_compiles_any_n(n):
    """--prefetch-compiles N runs for any N >= 0 (bench/pipeline.py under
    the cache; 0 leaves it out) and stamps the reference's perf keys; a
    negative N is refused."""
    r = driver.run(driver.DriverRequest(prefetch_compiles=n, **FAST),
                   device="cpu").verdict
    pf = r["perf"]["prefetch"]
    assert set(pf) == {"workers", "issued", "hits", "wasted", "failed",
                       "surfaced", "dropped"}
    assert pf["workers"] == n and (pf["issued"] > 0) == (n > 0)
    assert pf["hits"] > 0 or n == 0
    # the CPU captures nothing: compiled_programs counts CUDA graphs
    assert r["perf"]["compiled_programs"] == 0
    assert r["perf"]["compile_secs"] >= 0.0


def test_prefetch_compiles_negative_refused():
    with pytest.raises(driver.DriverConfigError, match=">= 0"):
        driver.run(driver.DriverRequest(smoke=True, prefetch_compiles=-1),
                   device="cpu")


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
    assert "not_ported" not in line and line["climbs"] == []


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
    """The recorded warm start is ported: a full-size request reads the
    databases the reference reads (its glob, resolved against the
    repository's root, matches the committed files), and the flags that
    select or dump a database no longer raise."""
    import glob
    import os

    req = driver.DriverRequest(workload=workload)
    driver.check_request(req)
    pat = f"experiments/{workload}_search_tpu_r[45]*.csv"
    assert driver.RECORDED_WARM_START[workload] == pat
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert driver.REPO_ROOT == repo
    assert glob.glob(os.path.join(repo, pat))
    for flags in (dict(seed_csv="x.csv"), dict(dump_csv="out.csv"),
                  dict(seed_topk=0)):
        driver.check_request(driver.DriverRequest(workload=workload, **flags))


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


SPMV_FLAGS = [{}, dict(fuse_winner=True), dict(fuse_search_tiles=True),
              dict(fuse_winner=True, fuse_search_tiles=True)]


@pytest.mark.parametrize("flags", SPMV_FLAGS,
                         ids=["plain", "fuse-winner", "fuse-search-tiles", "both"])
def test_smoke_spmv_driver_on_cpu(flags):
    """The spmv search on the CPU at the reference's smoke size (m=512, both
    SpMVs offer the kernel): the reference's metric, verified; the fusion
    flags add their ``perf`` blocks, the fused program gated against the
    stepped one."""
    res = driver.run(driver.DriverRequest(workload="spmv", **FAST, **flags),
                     device="cpu")
    line = json.loads(res.to_json_line())
    assert line["metric"] == "spmv_iter_pct50_searched_m512" == \
        ref_driver.metric_for("spmv", ref_driver.DriverRequest(workload="spmv",
                                                               smoke=True))
    assert line["unit"] == "us" and line["value"] > 0
    assert line["verified"] is True and line["climbs"] == []
    perf = line.get("perf", {})
    if flags.get("fuse_winner"):
        f = perf["fused"]
        assert f["verified"] is True and f["regions"] >= 1
        assert f["compiled_programs"] == 0 and f["fused_ops"] >= 2
        assert set(f["tiles"]["by_tiles_us"]) == {str(t) for t in f["tiles"]["menu"]}
        for k in ("dispatch_overhead_us", "sum_of_parts_us"):
            assert set(f[k]) == {"before", "after"}
            assert f[k]["before"] >= 0 and f[k]["after"] >= 0
        assert f["sum_of_parts_us"]["before"] > 0
    else:
        assert "fused" not in perf
    assert "not_ported" not in line
    if flags.get("fuse_search_tiles"):
        t = perf["fuse_search_tiles"]
        assert t["planted"] is True and t["menu"][0] == 1 and len(t["menu"]) > 1
        assert t["chosen"] in t["menu"]


def test_spmv_incumbent_and_naive():
    """Naive is the first decision at every step (all .xla on one lane); the
    port's own incumbent takes the kernel where the menu offers it: both
    SpMVs at m=512, only spmv_remote at m=8192 (x_remote 4093 <= 4096),
    none at m=150000."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.solve.local import first_decision_order

    plat = Platform.make_n_lanes(2)
    want = {512: 2, 8192: 1, 150_000: 0}
    for m, n_kernels in want.items():
        req = driver.DriverRequest(workload="spmv", m=m)
        g, bufs, metric, got_m = driver.build_spmv(req, "cpu")
        assert got_m == m and metric == f"spmv_iter_pct50_searched_m{m}"
        assert bufs["host_x"].device.type == "cpu"
        naive = first_decision_order(g, Platform.make_n_lanes(1))
        assert not any(op.name().endswith(".pallas") for op in naive.vector())
        inc = driver.spmv_incumbents(g, plat)
        if n_kernels == 0:
            assert inc == []
            continue
        (label, seq), = inc
        assert label == "naive-pallas"
        assert sum(op.name().endswith(".pallas") for op in seq.vector()) == n_kernels


def test_spmv_not_ported_reads_no_database():
    """The reference reads no recorded database for spmv
    (bench/driver.py:1283-1288), and neither does the port."""
    assert "spmv" not in driver.RECORDED_WARM_START


@pytest.mark.parametrize("workload", ["halo", "moe"])
def test_fuse_winner_finds_no_region_without_fusible_ops(workload):
    """Halo and moe declare no fusible op, so the fused program is the
    stepped one: zero regions and a one-tile menu, as in the reference."""
    res = driver.run(driver.DriverRequest(workload=workload, fuse_winner=True,
                                          fuse_search_tiles=True, **FAST),
                     device="cpu")
    perf = res.verdict["perf"]
    assert perf["fused"]["regions"] == 0 and perf["fused"]["verified"] is True
    assert perf["fused"]["tiles"]["menu"] == [1]
    assert perf["fuse_search_tiles"] == {"menu": [1], "planted": False,
                                         "chosen": 1}


def test_smoke_attn_fuse_driver_on_cpu():
    """``--workload attn --fuse-winner --fuse-search-tiles``: the naive
    chain's region menu is planted in the graph, the reported schedule is
    lowered and gated; the fused block is verified or carries the
    reference's divergence report (the port raises only when the members'
    own tolerance fails)."""
    res = driver.run(driver.DriverRequest(workload="attn", fuse_winner=True,
                                          fuse_search_tiles=True, **FAST),
                     device="cpu")
    line = json.loads(res.to_json_line())
    perf = line["perf"]
    t = perf["fuse_search_tiles"]
    assert t["planted"] is True and t["menu"] == [1, 2, 4, 8, 16, 32, 64]
    assert t["chosen"] in t["menu"]
    f = perf["fused"]
    assert set(f["tiles"]["by_tiles_us"]) == {str(x) for x in f["tiles"]["menu"]}
    assert f["verified"] is True or (f["error"].startswith("fused outputs diverge")
                                     and f["diverged"])
    if line["winner_label"] is None:  # naive reported: its one region
        assert f["regions"] == 1 and f["region_sizes"] == [5]
    assert f["sum_of_parts_us"]["before"] > 0 and f["sum_of_parts_us"]["after"] > 0
    assert "not_ported" not in line
    if not line["verified"]:
        assert set(line["diverged"]) <= {"acc", "O"}, line


@pytest.mark.parametrize("workload", ["attn", "moe"])
def test_smoke_chunk_driver_on_cpu(workload):
    """``--chunk`` on the smoke: every structurally valid count is on the
    menus (the reference's chunk_relax), the search visits chunked
    candidates, and ``perf.chunked`` reports menus, visits and the choice,
    with the hidden comm measured on the stepped timeline (0.0 for an
    unchunked winner, which hides nothing behind partials)."""
    res = driver.run(driver.DriverRequest(workload=workload, chunk=True,
                                          **dict(FAST, mcts_iters=8)),
                     device="cpu")
    line = json.loads(res.to_json_line())
    c = line["perf"]["chunked"]
    # the attn smoke graph has the kernel menus: the chunked entries wrap
    # each block's .xla slot; the moe smoke wraps the bare expert MLP
    bases = ({f"attn_{s}.xla" for s in range(4)} if workload == "attn"
             else {"ffn_0", "ffn_1"})
    assert set(c["menus"]) == bases
    assert all(m["counts"] == [1, 2, 4] for m in c["menus"].values())
    assert c["n_candidates_chunked"] >= 1 and set(c["searched_counts"]) <= {2, 4}
    assert set(c["chosen"]) <= bases
    measured = c["hidden_comm_us"]["measured"]
    assert isinstance(measured, float) and measured >= 0 and "note" not in c
    if not c["chosen"]:
        assert measured == 0.0
    assert "not_ported" not in line
    if workload == "moe":
        assert line["verified"] is True


def test_chunk_is_a_noted_no_op_without_chunkable_ops():
    """Halo and spmv declare no chunkable op: --chunk runs and says so."""
    from tenzing_tpu_torch.core.chunking import chunk_menus

    res = driver.run(driver.DriverRequest(workload="spmv", chunk=True, **FAST),
                     device="cpu")
    c = res.verdict["perf"]["chunked"]
    assert c["menus"] == {} and c["chosen"] == {}
    assert c["note"].startswith("workload offers no chunkable-op menus")
    halo_req = driver.DriverRequest(chunk=True, **FAST)
    driver.check_request(halo_req)
    assert chunk_menus(driver.build_halo(halo_req, "cpu")[0]) == {}


def test_full_size_attn_chunk_menu_is_pruned_with_a_note():
    """At full size the blocked fold has no transfer to hide: the menus hold
    [1] and perf.chunked says the roofline pruned every chunking."""
    from tenzing_tpu_torch.core.chunking import chunk_menus
    from tenzing_tpu_torch.models.ring_attention import RingAttnArgs

    a = RingAttnArgs(n_devices=8, batch=4, seq_local=1024, head_dim=128)
    g = driver.attn_graph(a, chunk=True)
    menus = chunk_menus(g)
    assert set(menus) == {f"attn_{s}.xla" for s in range(8)}
    assert all(m["counts"] == [1] for m in menus.values())
    from tenzing_tpu_torch.core.sequence import Sequence

    block = driver.chunked_block(g, [], Sequence([]), lambda m: None)
    assert block["note"].startswith("roofline pruned every chunking")


def test_fuse_gate_reports_divergence_and_raises_on_member_tolerance():
    """The fuse gate: a divergence at ``verify_tol`` is reported in the block
    as the reference reports it and the run goes on; a failure at the
    members' own tolerance raises."""
    from tenzing_tpu_torch.bench.benchmarker import BenchOpts
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.ring_attention import fixed_order
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.verify import ScheduleVerifier

    req = driver.DriverRequest(workload="attn", **FAST)
    g, bufs, _, _ = driver.build_attn(req, "cpu")
    ex = StreamExecutor(Platform.make_n_lanes(1), bufs, device="cpu")
    seq = fixed_order(g, Platform.make_n_lanes(1))
    opts = BenchOpts(n_iters=2, target_secs=0.0002)
    check = driver.fused_member_check(req, seq)
    # a stepped acc 1e-5 off: outside the gate at 1e-6, inside F32_STATE_TOL
    # (its relative-rms limit on acc / l is 2e-5)
    out = ex.run(seq)
    stepped = dict(out, acc=out["acc"] * (1 + 1e-5))
    block = driver.fuse_reported(ex, seq, stepped, opts, 1.0, 1e-6, set(),
                                 ScheduleVerifier(g), lambda m: None, check)
    assert block["verified"] is False and block["regions"] == 1
    assert block["diverged"] == ["acc"]
    assert block["error"] == "fused outputs diverge on ['acc']"
    with pytest.raises(RuntimeError, match="members' own tolerance"):
        driver.fuse_reported(ex, seq, None, opts, 1.0, 0.02, set(),
                             ScheduleVerifier(g), lambda m: None,
                             lambda out_s, out_f, skip: ["acc"])
    # the attention check itself: equal states pass, a moved acc fails
    assert check(out, out, set()) == []
    moved = dict(out, acc=out["acc"] * 1.01)
    assert check(out, moved, set()) == ["acc", "m_run", "l_run"]
    bf16 = fixed_order(g, Platform.make_n_lanes(1), ".fused_bf16")
    assert driver.fused_member_check(req, bf16) is not check


SYNTH_SMOKE = dict(smoke=True, workload="spmv", synth_collectives=True,
                   mcts_iters=6, iters=3, search_iters=2)


def test_synth_collectives_block():
    """``--synth-collectives`` on the spmv smoke: the exchange's pipe menu
    (every instantiation kept at the smoke, each with the reason the prune
    would drop it for), what the search visited, the reference's keys."""
    v = driver.run(driver.DriverRequest(**SYNTH_SMOKE), device="cpu").verdict
    assert v["verified"] is True
    block = v["perf"]["synth"]
    assert set(block) == {"menus", "searched_sketches", "n_candidates_synth",
                          "chosen", "est_comm_us", "measured_hidden_us",
                          "verified", "note"}
    menu = block["menus"]["x_exchange"]
    assert menu["menu"] == ["fixed", "pipe.c2", "pipe.c4"]
    assert set(menu["pruned"]) <= {"pipe.c2", "pipe.c4"}
    assert "relax" in menu["note"] and block["n_candidates_synth"] >= 1
    assert set(block["searched_sketches"]) <= {"pipe.c2", "pipe.c4"}


def test_synth_block_raises_where_the_reference_catches(monkeypatch):
    """A failure of the ``perf.synth`` block ends the run (the reference
    catches it into ``{"error": ...}``; ROADMAP Queue 3 item 16)."""
    from tenzing_tpu_torch.collectives import synth

    def broken(graph):
        raise RuntimeError("synth menus unreadable")

    monkeypatch.setattr(synth, "synth_menus", broken)
    with pytest.raises(RuntimeError, match="synth menus unreadable"):
        driver.run(driver.DriverRequest(**SYNTH_SMOKE), device="cpu")
