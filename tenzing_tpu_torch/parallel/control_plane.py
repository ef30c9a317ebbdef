"""Host-side coordination of a search over several ranks: the control plane.

Counterpart of ``tenzing_tpu/parallel/control_plane.py`` (the original
tenzing's second use of MPI, SURVEY.md §5): schedule broadcast
(sequence.cpp:88-125 ``mpi_bcast``), stop-flag broadcast (mcts.hpp:148-151,
dfs.hpp:66-69), and the benchmark barriers and max-over-ranks reductions
(benchmarker.cpp:43-60, 101, 145).

:class:`ControlPlane` is world size 1, where every operation is the
identity.  :class:`DistControlPlane` is the ``JaxControlPlane`` counterpart
over ``torch.distributed``; it needs an initialized default process group
(parallel/mesh.py ``init_mesh``) and runs over the group it is given —
``parallel/mesh.py`` ``control_group`` gives a gloo group, so the control
plane waits on the host even when the data plane runs over NCCL.  Every rank
must call its methods in the same order from one host thread.
``FileControlPlane`` (the search fleet's) is not ported yet (ROADMAP Queue
1).
"""

from __future__ import annotations

import json
from typing import Any


class ControlPlane:
    """Single-rank control plane (world size 1): the default."""

    def rank(self) -> int:
        return 0

    def size(self) -> int:
        return 1

    def barrier(self) -> None:
        return None

    def bcast_json(self, obj: Any) -> Any:
        """Broadcast a JSON-serializable object from rank 0 (reference
        mpi_bcast, sequence.cpp:88-125)."""
        return obj

    def allreduce_max(self, x: float) -> float:
        """Max over ranks (reference MPI_Allreduce MAX, benchmarker.cpp:101,
        145)."""
        return x

    def agree_fault(self, code: int) -> int:
        """Rank-coherent failure agreement: each rank contributes its local
        fault code (0 = healthy, larger = worse) and every rank receives the
        worst code seen anywhere, so a failure on one rank becomes a failure
        on all ranks at the same point instead of a hang in the next
        collective.  Expressed over :meth:`allreduce_max`."""
        return int(self.allreduce_max(float(code)))


class DistControlPlane(ControlPlane):
    """Multi-rank control plane over ``torch.distributed``: ``group`` (None:
    the default group).  A gloo group keeps every operation on the host; on
    an NCCL group the reductions run on the current CUDA device."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistControlPlane needs an initialized process "
                               "group (parallel/mesh.py init_mesh)")
        self._dist = dist
        self._group = group

    def rank(self) -> int:
        return self._dist.get_rank(self._group)

    def size(self) -> int:
        return self._dist.get_world_size(self._group)

    def barrier(self) -> None:
        self._dist.barrier(group=self._group)

    def bcast_json(self, obj: Any) -> Any:
        """The JSON text of rank 0's ``obj``, parsed on every rank (rank 0
        too, as the reference's length + bytes protocol does)."""
        payload = [json.dumps(obj) if self.rank() == 0 else None]
        self._dist.broadcast_object_list(
            payload, src=self._dist.get_global_rank(self._group, 0)
            if self._group is not None else 0, group=self._group)
        return json.loads(payload[0])

    def allreduce_max(self, x: float) -> float:
        import torch

        dev = ("cuda" if self._dist.get_backend(self._group) == "nccl"
               else "cpu")
        t = torch.tensor([float(x)], dtype=torch.float64, device=dev)
        self._dist.all_reduce(t, op=self._dist.ReduceOp.MAX, group=self._group)
        return float(t.item())


def default_control_plane() -> ControlPlane:
    """:class:`DistControlPlane` over the default group when a process group
    of more than one rank is initialized, else :class:`ControlPlane` (the
    reference's rule: multi-host under ``jax.distributed``, else the
    identity)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return DistControlPlane()
    return ControlPlane()
