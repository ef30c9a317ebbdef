"""Placing a schedule's buffers on the ranks of a mesh: the port's stand-in
for ``shard_map``'s buffer placement.

The reference runs a mesh schedule as one SPMD program under ``shard_map``
(tenzing_tpu/runtime/executor.py): every buffer is a global array with a
``PartitionSpec``, and each op sees its device's block.  The port runs the
schedule once per rank, in one process per rank joined by
``torch.distributed``, each on its own block:

* :func:`init_mesh` joins the process group (NCCL on the card, gloo on the
  CPU or between ranks that share one card) and returns the
  :class:`~tenzing_tpu_torch.core.platform.Mesh`: one axis over the whole
  world, or several axes of a given shape, ranks in row-major order over
  them, each axis with a process group per line of ranks that share the
  other coordinates (:func:`axis_lines`);
* :func:`shard_buffers` gives each rank its block of every dim its spec
  splits (a replicated buffer whole);
* :func:`gather_buffer` puts a buffer's blocks back together on every rank,
  for the checks.

Every group is made with a timeout, so a rank that raises while the others
sit in a collective ends them within it instead of hanging them.
"""

from __future__ import annotations

import itertools
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from tenzing_tpu_torch.core.platform import Mesh, MeshAxis

# seconds a collective may wait for its peers before the group fails
GROUP_TIMEOUT_S = 120.0


def rank_of(coords: Sequence[int], shape: Sequence[int]) -> int:
    """The rank at ``coords`` of a mesh of ``shape`` (row-major)."""
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + c
    return r


def coords_of(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """The coordinates of ``rank`` on a mesh of ``shape`` (row-major)."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def axis_lines(shape: Sequence[int], k: int) -> List[List[int]]:
    """The lines of axis ``k``: for each choice of the other coordinates (in
    row-major order), the ranks along axis ``k`` in coordinate order.  Axis
    ``k``'s collectives run over the line holding the calling rank."""
    others = [range(n) if i != k else range(1) for i, n in enumerate(shape)]
    lines = []
    for base in itertools.product(*others):
        c = list(base)
        line = []
        for j in range(shape[k]):
            c[k] = j
            line.append(rank_of(c, shape))
        lines.append(line)
    return lines


def init_mesh(axes: Union[str, Sequence[str]], backend: str, init_method: str,
              rank: int, world_size: int, timeout_s: float = GROUP_TIMEOUT_S,
              shape: Optional[Sequence[int]] = None,
              shared_card: bool = False) -> Mesh:
    """Join the default process group (``init_method``: ``file://...`` or
    ``tcp://localhost:<port>``) unless it is joined already, and return the
    mesh over it: one axis ``axes`` over the whole world, or the axes
    ``axes`` of ``shape`` (whose product is the world size).  Each axis gets
    the default group when its line is the whole world, no group at size 1,
    and otherwise a new group per line (:func:`axis_lines`): every rank
    creates every line's group, in the same order, or the creation hangs.
    On NCCL the caller selects this rank's CUDA device first."""
    import torch.distributed as dist

    if isinstance(axes, str):
        axes, shape = (axes,), (world_size,)
    axes = tuple(axes)
    shape = tuple(int(n) for n in (shape if shape is not None
                                   else (world_size,)))
    if len(shape) != len(axes) or int(np.prod(shape)) != world_size:
        raise ValueError(f"mesh shape {shape} over axes {axes} does not hold "
                         f"{world_size} ranks")
    if not dist.is_initialized():
        dist.init_process_group(backend=backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
    if dist.get_world_size() != world_size or dist.get_rank() != rank:
        raise RuntimeError(
            f"process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, asked for {rank} of {world_size}")
    coords = coords_of(rank, shape)
    out = {}
    for k, name in enumerate(axes):
        group: Any = None
        if shape[k] == world_size:
            group = dist.group.WORLD
        elif shape[k] > 1:
            for line in axis_lines(shape, k):
                g = dist.new_group(ranks=line,
                                   timeout=timedelta(seconds=timeout_s))
                if rank in line:
                    group = g
        out[name] = MeshAxis(size=shape[k], index=coords[k], group=group)
    return Mesh(out, shared_card=shared_card)


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
    """Unmap the peers' memory this rank mapped for the mesh shift
    (ops/rdma.py), then leave the default process group after a barrier: no
    rank leaves, or frees memory a peer still maps, while another is still
    in a collective."""
    import torch.distributed as dist

    from tenzing_tpu_torch.ops.rdma import close_ipc

    close_ipc()
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _dim_axes(spec: Any) -> Tuple[Optional[str], ...]:
    """A spec as one entry per leading dim: an axis name or None."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    return tuple(spec)


def shard_of(arr: np.ndarray, spec: Any, mesh: Mesh) -> np.ndarray:
    """This rank's block of a global array: along each dim its spec names an
    axis of (size n, index i), rows ``[i*L/n, (i+1)*L/n)``; the whole array
    for a replicated buffer."""
    idx = []
    for dim, axis in enumerate(_dim_axes(spec)):
        if axis is None:
            idx.append(slice(None))
            continue
        n, i = mesh.size(axis), mesh.index(axis)
        ext = arr.shape[dim]
        if ext % n:
            raise ValueError(f"dim {dim} of extent {ext} does not split {n} "
                             f"ways along {axis!r}")
        idx.append(slice(i * ext // n, (i + 1) * ext // n))
    return arr[tuple(idx)]


def shard_buffers(global_bufs: Dict[str, np.ndarray],
                  specs: Dict[str, Any], mesh: Mesh, device):
    """This rank's blocks of the global numpy buffers, as the port's tensors
    on ``device`` (runtime/executor.py ``buffers_from_numpy``)."""
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    local = {k: shard_of(v, specs.get(k), mesh) for k, v in global_bufs.items()}
    return buffers_from_numpy(local, device)


def gather_buffer(name: str, local, specs: Dict[str, Any], mesh: Mesh):
    """The global buffer ``name`` from every rank's block ``local`` (a
    collective: every rank calls it), on ``local``'s device.  A spec of one
    axis gathers over that axis's group; a spec over several gathers every
    rank's block over the default group and places each at its rank's
    coordinates.  Over gloo a device block goes through host memory."""
    import torch
    import torch.distributed as dist

    dims = _dim_axes(specs.get(name))
    if not any(a is not None for a in dims):
        return local.clone()
    if len(dims) == 1:
        if mesh.size(dims[0]) == 1:
            return local.clone()
        group = mesh.group(dims[0])
        parts = _all_gather(local, mesh.size(dims[0]), group)
        return torch.cat(parts, 0)
    names = mesh.axis_names
    parts = _all_gather(local, dist.get_world_size(), None)
    out_shape = list(local.shape)
    for dim, axis in enumerate(dims):
        if axis is not None:
            out_shape[dim] *= mesh.size(axis)
    out = torch.empty(out_shape, dtype=local.dtype, device=local.device)
    for r, part in enumerate(parts):
        c = dict(zip(names, coords_of(r, mesh.shape)))
        idx = [slice(None)] * local.dim()
        for dim, axis in enumerate(dims):
            if axis is not None:
                ext = local.shape[dim]
                idx[dim] = slice(c[axis] * ext, (c[axis] + 1) * ext)
        out[tuple(idx)] = part
    return out


def _all_gather(local, n: int, group) -> list:
    """``dist.all_gather`` of ``local`` over ``group`` (None: the default
    group), staged through host memory when the group is gloo and ``local``
    lies on a CUDA device."""
    import torch
    import torch.distributed as dist

    via_host = local.device.type == "cuda" and \
        dist.get_backend(group) == "gloo"
    src = local.contiguous().cpu() if via_host else local.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(local.device) for p in parts] if via_host else parts
