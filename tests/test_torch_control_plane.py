"""The port's control plane (tenzing_tpu_torch/parallel/control_plane.py)
against the reference's contract (tenzing_tpu/parallel/control_plane.py):
the identity at world size 1, and over gloo at world size 2 a broadcast from
rank 0, a max over ranks, a rank-coherent fault code and a barrier.  Then a
search at world size 2: MCTS and DFS ``explore`` of the MoE layer through
the control plane, whose two ranks must measure the same schedules, in the
same order, with the same (max-reduced) times.

The ranks are separate processes that import only the port
(parallel/launch.py); each launch has a timeout."""

from tenzing_tpu.parallel.control_plane import ControlPlane as RefControlPlane
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.parallel.control_plane import ControlPlane, default_control_plane
from tenzing_tpu_torch.parallel.launch import launch

TIMEOUT_S = 120.0


def test_world_one_is_the_identity_as_in_the_reference():
    ref, cp = RefControlPlane(), ControlPlane()
    obj = {"order": [1, 2], "stop": False}
    for c in (ref, cp):
        assert (c.rank(), c.size()) == (0, 1)
        assert c.barrier() is None
        assert c.bcast_json(obj) == obj
        assert c.allreduce_max(2.5) == 2.5
        assert c.agree_fault(3) == 3
    # no process group in this process: the default is the identity
    assert type(default_control_plane()) is ControlPlane


def test_world_two_operations(tmp_path):
    obj = {"schedule": [{"kind": "chunk", "chunks": 2}], "stop": False}
    out = launch("tenzing_tpu_torch.parallel.launch:probe_control_plane", 2,
                 "cpu", dict(obj=obj, code=3), timeout_s=TIMEOUT_S,
                 workdir=str(tmp_path))
    # (rank, size, bcast_json from rank 0, max of the ranks, worst fault)
    assert out == [(0, 2, obj, 1.0, 3), (1, 2, obj, 1.0, 3)]


def test_world_two_search_measures_the_same_schedules(tmp_path):
    ranks = launch("tenzing_tpu_torch.parallel.dryrun:search_ranks", 2, "cpu",
                   dict(args=dict(n_ep=2, **dryrun.DRYRUN_ARGS), mcts_iters=4,
                        dfs_max_seqs=3),
                   timeout_s=TIMEOUT_S, workdir=str(tmp_path))
    r0, r1 = ranks
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for solver in ("mcts", "dfs"):
        assert r0[solver], solver
        # the same schedules, in the same order, with the same times
        assert r0[solver] == r1[solver], solver
    assert len(r0["mcts"]) == 4 and len(r0["dfs"]) == 3
