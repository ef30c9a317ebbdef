"""The port's MoE, halo and replay examples on the CPU
(tenzing_tpu_torch/examples/{moe_mcts,halo_mcts,mcts_replay}.py).

``moe_mcts`` and ``halo_mcts`` (world size 1 in the process, and two gloo
ranks through parallel/launch.py) print their CSV rows and the ``best:``
line; ``mcts_replay`` over a recorded database prints, for each strategy,
exactly what the reference's ``examples/mcts_replay.py`` prints for the same
database and seed, and over a full DFS dump of the SpMV space finds the
database's best with no miss.  Mirrors ``tests/test_replay_search.py``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tenzing_tpu_torch.examples import halo_mcts, mcts_replay, moe_mcts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows_and_best(capsys, n):
    out, err = capsys.readouterr()
    rows = out.strip().splitlines()
    assert len(rows) == n, out
    assert [int(r.split("|")[0]) for r in rows] == list(range(1, n + 1))
    for r in rows:
        cells = r.split("|")
        assert all(float(c) > 0 for c in cells[1:6])
        json.loads(cells[7])  # the first op cell is JSON
    best = [line for line in err.splitlines() if line.startswith("best:")]
    assert len(best) == 1 and f"over {n} schedules" in best[0]
    return rows


def test_moe_mcts_prints_csv_and_best(capsys, tmp_path):
    dump = tmp_path / "moe.csv"
    assert moe_mcts.main(["--cpu", "--tokens", "32", "--experts", "4",
                          "--d-model", "8", "--d-ff", "16", "--chunks", "2",
                          "--mcts-iters", "4", "--benchmark-iters", "2",
                          "--dump-csv", str(dump)]) == 0
    rows = _rows_and_best(capsys, 4)
    assert dump.read_text().strip().splitlines() == rows


@pytest.mark.parametrize("nproc", [1, 2])
def test_halo_mcts_prints_csv_and_best(capsys, nproc):
    assert halo_mcts.main(["--cpu", "--nq", "2", "--cells", "4", "--radius",
                           "1", "--mcts-iters", "3", "--benchmark-iters", "2",
                           "--nproc", str(nproc)]) == 0
    rows = _rows_and_best(capsys, 3)
    names = {json.loads(c).get("name") for r in rows for c in r.split("|")[7:]}
    assert {f"exchange_{d}.xla" for d in ("px", "mx")} <= names


def test_halo_mcts_shared_card_graph_posts_rdma_only():
    """Ranks sharing one card exchange only through the ``.rdma`` shift, so
    their graph has no other post."""
    from tenzing_tpu_torch.models.halo import HaloArgs

    args = HaloArgs(nq=2, lx=4, ly=4, lz=4, radius=1)
    posts = [v.name() for v in halo_mcts.halo_graph(args, "rdma").vertices()
             if v.name().startswith("exchange_")]
    assert len(posts) == 6 and all(p.endswith(".rdma") for p in posts)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 16, 30])
def test_mesh_shape_equals_reference(n):
    sys.path.insert(0, REPO)
    try:
        from examples.halo_mcts import mesh_shape_for as ref_shape
    finally:
        sys.path.remove(REPO)
    assert halo_mcts.mesh_shape_for(n) == ref_shape(n)


def test_examples_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        moe_mcts.main(["--tokens", "32", "--mcts-iters", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        halo_mcts.main(["--cells", "4", "--mcts-iters", "1"])


@pytest.mark.parametrize("csv", ["halo_search_tpu_r4k.csv",
                                 "halo_search_tpu_r3c.csv"])
def test_mcts_replay_prints_what_the_reference_prints(capsys, csv):
    """Over a recorded halo database: the database line (schedules, rows
    unmatchable, best pct50) and each strategy's best, rollouts, misses and
    whether it reached the recorded optimum equal the reference's."""
    path = os.path.join(REPO, "experiments", csv)
    args = ["--csv", path, "--workload", "halo", "--mcts-iters", "12",
            "--strategies", "FastMin,Random,Coverage", "--seed", "3"]
    assert mcts_replay.main(args) == 0
    out, err = capsys.readouterr()
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "mcts_replay.py"),
         *args, "--cpu"], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert out == ref.stdout
    assert out.count("\n") == 3
    db_line = [line for line in err.splitlines() if line.startswith("database:")]
    assert db_line and db_line[0] in ref.stderr


def test_mcts_replay_over_a_full_dfs_dump_finds_the_best(capsys, tmp_path):
    """A database covering the whole 2-lane space of the examples' SpMV
    graph (a DFS dump): every rollout resolves, none misses, and the best
    found never beats the recorded best."""
    from tenzing_tpu_torch.examples import spmv_dfs

    dump = tmp_path / "dfs.csv"
    assert spmv_dfs.main(["--cpu", "--matrix-m", "64", "--nnz-per-row", "3",
                          "--max-seqs", "10000", "--benchmark-iters", "2",
                          "--dump-csv", str(dump)]) == 0
    capsys.readouterr()
    best = mcts_replay.recorded_best(str(dump))
    assert mcts_replay.main(["--csv", str(dump), "--workload", "spmv",
                             "--mcts-iters", "40",
                             "--strategies", "FastMin,Random"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 2
    for line in lines:
        assert "unrecorded" not in line
        got = float(line.split("best ")[1].split("us")[0])
        assert got >= round(best * 1e6, 1) - 0.05
    assert f"best pct50 {best * 1e6:.1f}us" in err
    with pytest.raises(SystemExit, match="resolves"):
        mcts_replay.main(["--csv", str(dump), "--workload", "halo"])
