"""The driver's search database and recorded warm start on the CPU
(tenzing_tpu_torch/bench/driver.py ``--dump-csv``, ``--seed-csv``,
``warm_start``, the recorded climb): a smoke run dumps its database, which
the reference's reader parses too, and a second run warm-starts from it and
climbs from the best row; a row the verifier rejects is counted and never
measured; the recorded climb's policy is the reference's.  The readers and
the ranking are held against the reference in test_torch_recorded.py."""

import pytest

from tenzing_tpu.bench import benchmarker as ref_bm
from tenzing_tpu_torch.bench import driver
from tenzing_tpu_torch.bench.benchmarker import (
    CSV_DELIM,
    BenchResult,
    result_row,
    split_fidelity,
)
from tenzing_tpu_torch.core.platform import Platform


def _res(vals):
    p01, p10, p50, p90, p99, sd = vals
    return BenchResult(pct01=p01, pct10=p10, pct50=p50, pct90=p90,
                       pct99=p99, stddev=sd)


FAST = dict(smoke=True, mcts_iters=4, iters=3, search_iters=2)


@pytest.mark.parametrize("workload", ["halo", "moe"])
def test_smoke_dump_then_warm_start_from_it(tmp_path, workload):
    """``--dump-csv`` writes naive as row 0 at full fidelity and one row per
    measured schedule, which the reference's reader parses too; a second run
    given the dump (``--seed-csv``) measures the rows it picks and climbs
    from the best one.  The dump's anchor is raised before the second run so
    that every row beats it: the ranking itself is held against the
    reference above, the warm start's plumbing here."""
    dump = tmp_path / "dump.csv"
    res = driver.run(driver.DriverRequest(workload=workload,
                                          dump_csv=str(dump), **FAST),
                     device="cpu")
    assert res.verdict["verified"] is True
    rows = dump.read_text().splitlines()
    assert rows[0].startswith("0|") and split_fidelity(
        rows[0].split(CSV_DELIM))[0] == "full"
    assert len(rows) >= 1 + len(res.verdict["climbs"])
    assert [int(r.split(CSV_DELIM, 1)[0]) for r in rows] == list(range(len(rows)))
    if workload == "halo":
        from tenzing_tpu.models import halo as rh
        from tenzing_tpu.models import halo_pipeline as rhp

        rg = rhp.build_graph(rh.HaloArgs(nq=2, lx=4, ly=4, lz=4, radius=1))
    else:
        from tenzing_tpu.models import moe_pipeline as rmp

        a = rmp.MoEPipeArgs(n_experts=4, tokens=32, d_model=8, d_ff=16,
                            n_chunks=2)
        rg = rmp.build_graph(a, rmp.make_pipe_buffers(
            a, seed=0, with_expected=False)[2])
    assert len(ref_bm.CsvBenchmarker.from_file(str(dump), rg).entries) == \
        len(rows)
    cells = rows[0].split(CSV_DELIM)
    slow = max(float(r.split(CSV_DELIM)[3]) for r in rows) * 4
    rows[0] = CSV_DELIM.join(cells[:1] + [repr(slow)] * 5 + cells[6:])
    seed = tmp_path / "seed.csv"
    seed.write_text("\n".join(rows) + "\n")
    res2 = driver.run(driver.DriverRequest(workload=workload,
                                           seed_csv=str(seed), climb_budget=6,
                                           **FAST), device="cpu")
    v = res2.verdict
    rec = v["recorded"]
    assert rec["files"] == 1 and rec["rows"] == len(rows) and rec["skipped"] == 0
    assert rec["picked"] == 3 and rec["rejected"] == 0
    assert len(rec["measured"]) == 3 == v["recorded_seeds"]
    for m in rec["measured"]:
        assert m["recorded_ratio"] > 1.0 and m["pct50_us"] > 0
    (climb,) = v["climbs"]
    assert climb["seed"] == "recorded" and climb["spent"] > 0
    assert v["verified"] is True


def test_warm_start_counts_rejected_rows(tmp_path):
    """A picked row the port's verifier rejects is counted and never
    measured."""
    from tenzing_tpu_torch.bench.benchmarker import BenchOpts
    from tenzing_tpu_torch.core.sequence import Sequence
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import build_graph, naive_order
    from tenzing_tpu_torch.verify import ScheduleVerifier

    args = HaloArgs(nq=1, lx=4, ly=4, lz=4, radius=1)
    g = build_graph(args)
    naive = naive_order(args, Platform.make_n_lanes(1))
    ops = naive.vector()
    unsynced = Sequence([op for op in ops
                         if not getattr(op, "is_sync", lambda: False)()])
    assert not ScheduleVerifier(g)(unsynced).ok
    path = tmp_path / "db.csv"
    path.write_text("\n".join([result_row(0, _res([1.0] * 5 + [0]), naive),
                               result_row(1, _res([0.5] * 5 + [0]), unsynced)])
                    + "\n")

    class NoBench:
        def benchmark(self, order, opts=None):
            raise AssertionError("a rejected row was measured")

    sims, block = driver.warm_start(str(path), 3, g, NoBench(),
                                    ScheduleVerifier(g), BenchOpts(),
                                    lambda s: s, lambda m: None)
    assert sims == [] and block["picked"] == 1 and block["rejected"] == 1
    assert block["measured"] == []


@pytest.mark.parametrize("chosen,op,choices,want", [
    ({"unpack_x": ".pallas"}, "unpack_x", ["unpack_x.xla", "unpack_x.pallas"],
     "unpack_x.pallas"),
    ({}, "xfer_px", ["xfer_px.rdma", "xfer_px.host"], "xfer_px.host"),
    ({}, "pack_py", ["pack_py.pallas", "pack_py.xla"], "pack_py.xla"),
    ({"chain_0": ".bf16-rdma"}, "chain_0",
     ["chain_0.f32-host", "chain_0.bf16-rdma"], "chain_0.bf16-rdma"),
])
def test_recorded_prefer_equals_reference(chosen, op, choices, want):
    from tenzing_tpu.bench.driver import recorded_prefer as ref_prefer

    assert driver.recorded_prefer(chosen)(op, choices) == want == \
        ref_prefer(chosen)(op, choices)
