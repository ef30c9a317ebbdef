"""Placing a schedule's buffers on the ranks of a mesh: the port's stand-in
for ``shard_map``'s buffer placement.

The reference runs a mesh schedule as one SPMD program under ``shard_map``
(tenzing_tpu/runtime/executor.py): every buffer is a global array with a
``PartitionSpec``, and each op sees its device's block.  The port runs the
schedule once per rank, in one process per rank joined by
``torch.distributed``, each on its own block:

* :func:`init_mesh` joins the process group (NCCL on the card, gloo on the
  CPU) and returns the one-axis :class:`~tenzing_tpu_torch.core.platform.Mesh`;
* :func:`shard_buffers` gives each rank its block of dim 0 of every buffer
  whose spec names an axis (a replicated buffer whole);
* :func:`gather_buffer` puts a buffer's blocks back together on every rank,
  for the checks.

Every group is made with a timeout, so a rank that raises while the others
sit in a collective ends them within it instead of hanging them.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Dict, Optional

import numpy as np

from tenzing_tpu_torch.core.platform import Mesh, MeshAxis

# seconds a collective may wait for its peers before the group fails
GROUP_TIMEOUT_S = 120.0


def init_mesh(axis: str, backend: str, init_method: str, rank: int,
              world_size: int, timeout_s: float = GROUP_TIMEOUT_S) -> Mesh:
    """Join the default process group (``init_method``: ``file://...`` or
    ``tcp://localhost:<port>``) unless it is joined already, and return the
    one-axis mesh over it.  On NCCL the caller selects this rank's CUDA
    device first."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(backend=backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
    if dist.get_world_size() != world_size or dist.get_rank() != rank:
        raise RuntimeError(
            f"process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, asked for {rank} of {world_size}")
    return Mesh({axis: MeshAxis(size=world_size, index=rank,
                                group=dist.group.WORLD)})


def control_group():
    """A process group for the control plane that waits on the host: the
    default group when it is gloo, else a new gloo group over the same
    ranks (every rank must call this at the same point)."""
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo",
                          timeout=timedelta(seconds=GROUP_TIMEOUT_S))


def close_mesh() -> None:
    """Leave the default process group (after a barrier: no rank leaves
    while another is still in a collective)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def shard_of(arr: np.ndarray, spec: Optional[str], mesh: Mesh) -> np.ndarray:
    """This rank's block of a global array: rows ``[i*L/n, (i+1)*L/n)`` of
    dim 0 along axis ``spec`` (size n, index i), or the whole array for a
    replicated buffer."""
    if spec is None:
        return arr
    n, i = mesh.size(spec), mesh.index(spec)
    rows = arr.shape[0]
    if rows % n:
        raise ValueError(f"dim 0 of extent {rows} does not split {n} ways "
                         f"along {spec!r}")
    return arr[i * rows // n:(i + 1) * rows // n]


def shard_buffers(global_bufs: Dict[str, np.ndarray],
                  specs: Dict[str, Optional[str]], mesh: Mesh, device):
    """This rank's blocks of the global numpy buffers, as the port's tensors
    on ``device`` (runtime/executor.py ``buffers_from_numpy``)."""
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    local = {k: shard_of(v, specs.get(k), mesh) for k, v in global_bufs.items()}
    return buffers_from_numpy(local, device)


def gather_buffer(name: str, local, specs: Dict[str, Optional[str]],
                  mesh: Mesh):
    """The global buffer ``name`` from every rank's block ``local`` (a
    collective: every rank calls it), on ``local``'s device."""
    import torch
    import torch.distributed as dist

    spec = specs.get(name)
    if spec is None:
        return local.clone()
    parts = [torch.empty_like(local) for _ in range(mesh.size(spec))]
    dist.all_gather(parts, local.contiguous(), group=mesh.group(spec))
    return torch.cat(parts, 0)
