"""Async transfer ops: the post/wait split, as schedulable vertices.

Counterpart of the single-device part of ``tenzing_tpu/ops/comm_ops.py``
(reference ``include/tenzing/mpi/ops_mpi.hpp`` Isend / Irecv / Wait / MultiWait,
:17-146).  The split between *posting* a transfer and *waiting* for it is the
overlap the search exists to exploit.

On CUDA (runtime/executor.py ``RunContext.post_transfer``):

* a **start op** is a host op that enqueues its copy on a transfer stream —
  one stream per ``channel``, created once per executor — records an event
  after it, and returns with the copy in flight.  A start writing a device
  buffer stores that event in ``ctx.inflight[dst]``;
* an **AwaitTransfer** blocks the host on the event (``MPI_Wait``): every op
  scheduled after it, on any lane, is launched after the copy finished.  It
  raises if no post is in flight for its buffer.  ``MultiAwait`` waits a set.

The host round trip posts the spill and the fetch on the SAME channel, so the
fetch never reads the pinned host buffer before the spill has written it: the
graph has no await between them (on the TPU the order came from SSA).

A **collective** start (``AllToAllStart``, ``PermuteStart``, ``PsumStart``)
is posted the same way, over the ``torch.distributed`` process group of its
mesh axis (``RunContext.post_collective``): the work it returns is in flight
until its AwaitTransfer, which blocks the host until it has finished.  A
collective's ``launch`` takes the buffers, the axis group and the axis size.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Sequence as Seq

from tenzing_tpu_torch.core.operation import CpuOp, register_kind


class CommStart(CpuOp):
    """Base: a host-posted async transfer ``src -> dst`` (reference
    Isend/Irecv shape).  ``DST_SPACE`` says where ``dst`` lives ("host" or
    "device"); only device-space destinations are awaited.  ``channel`` names
    the transfer stream the copy is enqueued on (default: ``dst``); it is not
    part of the schedule JSON, which matches the reference's."""

    DST_SPACE = "device"

    def __init__(self, name: str, src: str, dst: str,
                 channel: Optional[str] = None):
        super().__init__(name)
        self._src = src
        self._dst = dst
        self._channel = channel if channel is not None else dst

    def src(self) -> str:
        return self._src

    def dst(self) -> str:
        return self._dst

    def channel(self) -> str:
        return self._channel

    def reads(self) -> List[str]:
        return [self._src]

    def writes(self) -> List[str]:
        return [self._dst]

    def apply(self, bufs: Dict[str, Any], ctx) -> None:
        """Enqueue the copy on the current (transfer) stream."""
        bufs[self._dst].copy_(bufs[self._src], non_blocking=True)

    def execute(self, ctx) -> None:
        ctx.post_transfer(self)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "name": self.name(), "src": self._src, "dst": self._dst}


@register_kind("host_spill_start")
class HostSpillStart(CommStart):
    """Post an async device->host copy of ``src`` into the pinned host buffer
    ``dst``."""

    DST_SPACE = "host"


@register_kind("host_fetch_start")
class HostFetchStart(CommStart):
    """Post an async host->device copy of the pinned host buffer ``src`` into
    device buffer ``dst``."""


@register_kind("await_transfer")
class AwaitTransfer(CpuOp):
    """Wait for an in-flight buffer (reference Wait, ops_mpi.hpp:121-131): the
    host blocks on the posted copy's event.  Ops ordered after this observe
    the transfer as done; ops between the post and this op overlap it."""

    def __init__(self, name: str, buf: str):
        super().__init__(name)
        self._buf = buf

    def buf(self) -> str:
        return self._buf

    def reads(self) -> List[str]:
        return [self._buf]

    def execute(self, ctx) -> None:
        ctx.await_transfer(self._buf)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "name": self.name(), "buf": self._buf}


@register_kind("multi_await")
class MultiAwait(CpuOp):
    """Wait for a set of in-flight buffers (reference MultiWait/OwningWaitall,
    ops_mpi.hpp:133-146)."""

    def __init__(self, name: str, bufs: Seq[str]):
        super().__init__(name)
        self._bufs = list(bufs)

    def bufs(self) -> List[str]:
        return list(self._bufs)

    def reads(self) -> List[str]:
        return list(self._bufs)

    def execute(self, ctx) -> None:
        for b in self._bufs:
            ctx.await_transfer(b)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "name": self.name(), "bufs": list(self._bufs)}


class Collective(CommStart):
    """Base of the collective starts: a transfer over the process group of
    mesh axis ``axis``, posted by ``RunContext.post_collective`` through
    :meth:`launch`."""

    def __init__(self, name: str, src: str, dst: str, axis: str):
        super().__init__(name, src, dst)
        self._axis = axis

    def axis(self) -> str:
        return self._axis

    def execute(self, ctx) -> None:
        ctx.post_collective(self)

    def apply(self, bufs: Dict[str, Any], ctx) -> None:
        raise TypeError(f"{self.name()}: a collective is posted through "
                        "RunContext.post_collective, not applied")

    def launch(self, bufs: Dict[str, Any], group, size: int):
        """Start the collective on the current stream; returns its work
        (anything with a ``wait()``)."""
        raise NotImplementedError


class Works:
    """Several ``async_op`` works waited as one."""

    def __init__(self, works):
        self.works = list(works)

    def wait(self) -> None:
        for w in self.works:
            w.wait()


class Done:
    """The work of a collective that completed when it was posted."""

    def wait(self) -> None:
        return None


def p2p_tag(name: str) -> int:
    """A message tag that is the same on every rank for one buffer name, so
    concurrent point-to-point exchanges of different buffers never match
    each other's messages (gloo honours tags; NCCL orders by call)."""
    return zlib.crc32(name.encode()) & 0x7FFF


def shift_exchange(src, dst, group, size: int, shift: int, tag: int):
    """Post ``dst`` <- the ``src`` of the rank ``shift`` places behind along
    the group (group rank order is the axis coordinate), sending ``src`` to
    the rank ``shift`` places ahead: ``dist.batch_isend_irecv`` of one send
    and one receive; returns their works."""
    import torch.distributed as dist

    me = dist.get_rank(group)
    fwd = dist.get_global_rank(group, (me + shift) % size)
    bwd = dist.get_global_rank(group, (me - shift) % size)
    return Works(dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, fwd, group, tag),
        dist.P2POp(dist.irecv, dst, bwd, group, tag)]))


@register_kind("permute_start")
class PermuteStart(Collective):
    """Post a neighbour shift of ``src`` over mesh axis ``axis`` into ``dst``
    (reference ``PermuteStart``, tenzing_tpu/ops/comm_ops.py:140, a
    ``lax.ppermute`` with perm ``[(i, (i + shift) % n)]``): rank i's ``dst``
    receives the ``src`` of rank ``(i - shift) % n`` along the axis, through
    ``dist.batch_isend_irecv`` over the axis group.

    On an axis of size 1 the permutation is ``[(0, 0)]``: the identity, so
    the post is a copy ``dst <- src`` on the transfer stream and no message
    is sent.  That is decided by the axis size alone, on every backend: NCCL
    takes a send and a receive to the rank itself (probed on the H100,
    parallel/ipc_probe.py), gloo refuses one, and a size-1 axis of a larger
    mesh has no group of its own."""

    def __init__(self, name: str, src: str, dst: str, axis: str,
                 shift: int = 1):
        super().__init__(name, src, dst, axis)
        self._shift = int(shift)

    def shift(self) -> int:
        return self._shift

    def launch(self, bufs: Dict[str, Any], group, size: int):
        src, dst = bufs[self._src], bufs[self._dst]
        if size == 1:
            dst.copy_(src, non_blocking=True)
            return Done()
        return shift_exchange(src, dst, group, size, self._shift % size,
                              p2p_tag(self._dst))

    def to_json(self) -> Dict[str, Any]:
        j = super().to_json()
        j.update(axis=self._axis, shift=self._shift)
        return j


@register_kind("psum_start")
class PsumStart(Collective):
    """Post an all-reduce (sum) of ``src`` over mesh axis ``axis`` into
    ``dst`` (reference ``PsumStart``, tenzing_tpu/ops/comm_ops.py:194, a
    ``lax.psum``): ``dst <- src``, then ``dist.all_reduce(dst,
    async_op=True)`` over the axis group."""

    def launch(self, bufs: Dict[str, Any], group, size: int):
        import torch.distributed as dist

        dst = bufs[self._dst]
        dst.copy_(bufs[self._src], non_blocking=True)
        return dist.all_reduce(dst, group=group, async_op=True)

    def to_json(self) -> Dict[str, Any]:
        j = super().to_json()
        j.update(axis=self._axis)
        return j


@register_kind("all_to_all_start")
class AllToAllStart(Collective):
    """Post a width-padded all-to-all of ``src`` into ``dst`` over mesh axis
    ``axis`` (reference ``AllToAllStart``, tenzing_tpu/ops/comm_ops.py:164;
    the original tenzing's ``Ialltoallv``, ops_mpi.hpp:82-119).  The per-rank
    buffers' ``split_axis`` indexes the peer rank: ``dst``'s block q is what
    rank q sent here.  For ``split_axis=0`` that is
    ``dist.all_to_all_single(dst, src, group, async_op=True)``; other split
    axes are not on a ported path and raise."""

    def __init__(self, name: str, src: str, dst: str, axis: str,
                 split_axis: int = 1):
        super().__init__(name, src, dst, axis)
        self._split = int(split_axis)

    def split_axis(self) -> int:
        return self._split

    def launch(self, bufs: Dict[str, Any], group, size: int):
        """Start the exchange on the current stream; returns its work."""
        import torch.distributed as dist

        if self._split != 0:
            raise NotImplementedError(
                f"not yet ported: all_to_all_start with split_axis="
                f"{self._split} ({self.name()})")
        return dist.all_to_all_single(bufs[self._dst], bufs[self._src],
                                      group=group, async_op=True)

    def to_json(self) -> Dict[str, Any]:
        j = super().to_json()
        j.update(axis=self._axis, split_axis=self._split)
        return j
