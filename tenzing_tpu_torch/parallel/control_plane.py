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
:class:`FileControlPlane` is the search fleet's (search/fleet.py): processes
on one host exchanging snapshots and claims through a shared directory.
"""

from __future__ import annotations

import json
import os
from typing import Any

from tenzing_tpu_torch.utils.atomic import atomic_dump_json, read_json


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


class FileControlPlane(ControlPlane):
    """The search fleet's control plane over a shared directory (the
    reference's ``FileControlPlane``): N worker processes and one
    measurement owner on one host, in no process group.

    Two non-blocking primitives:

    * ``publish`` / ``gather``: each rank atomically replaces its own
      generation-stamped ``<tag>.r<rank>.json``, and ``gather`` reads the
      snapshots that exist now; the reader reduces (the best incumbent).
    * ``claim``: a winner-takes-all registry (an ``O_EXCL`` create): the
      first rank to claim a key owns it, every later claim is refused.

    The lockstep collectives keep the identity semantics of
    :class:`ControlPlane`: a fleet member can be killed and its job adopted
    mid-run, so a blocking rendezvous would hang the survivors."""

    def __init__(self, root: str, rank: int, size: int):
        self.root = root
        self._rank = int(rank)
        self._size = int(size)
        self._gen = 0
        os.makedirs(root, exist_ok=True)

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._size

    def publish(self, tag: str, obj: Any) -> None:
        """Atomically replace this rank's snapshot under ``tag``."""
        self._gen += 1
        atomic_dump_json(os.path.join(self.root, f"{tag}.r{self._rank}.json"),
                         {"gen": self._gen, "rank": self._rank, "data": obj})

    def gather(self, tag: str, include_self: bool = True) -> dict:
        """``{rank: data}`` of every snapshot of ``tag`` there is now; a
        missing or unreadable file is skipped (a snapshot is a hint)."""
        out = {}
        prefix, suffix = f"{tag}.r", ".json"
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not (name.startswith(prefix) and name.endswith(suffix)):
                continue
            try:
                rank = int(name[len(prefix):-len(suffix)])
            except ValueError:
                continue
            if not include_self and rank == self._rank:
                continue
            try:
                out[rank] = read_json(os.path.join(self.root, name))["data"]
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return out

    def claim(self, tag: str, key: str) -> bool:
        """True iff this rank is the first to claim ``key`` under ``tag``.
        Where the registry cannot be written the claim is granted: a double
        measurement costs budget, a wrongly skipped candidate coverage."""
        d = os.path.join(self.root, f"claims-{tag}")
        try:
            os.makedirs(d, exist_ok=True)
            fd = os.open(os.path.join(d, key),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        except OSError:
            return True
        try:
            os.write(fd, str(self._rank).encode())
        except OSError:
            pass
        finally:
            os.close(fd)
        return True

    def claim_count(self, tag: str) -> int:
        """How many keys the fleet has claimed under ``tag``."""
        try:
            return len(os.listdir(os.path.join(self.root, f"claims-{tag}")))
        except OSError:
            return 0


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
