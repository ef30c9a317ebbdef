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

A **collective** start (``AllToAllStart``) is posted the same way, over the
``torch.distributed`` process group of its mesh axis
(``RunContext.post_collective``): the work it returns is in flight until its
AwaitTransfer, which blocks the host until it has finished.
``PermuteStart`` and ``PsumStart`` are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

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


@register_kind("all_to_all_start")
class AllToAllStart(CommStart):
    """Post a width-padded all-to-all of ``src`` into ``dst`` over mesh axis
    ``axis`` (reference ``AllToAllStart``, tenzing_tpu/ops/comm_ops.py:164;
    the original tenzing's ``Ialltoallv``, ops_mpi.hpp:82-119).  The per-rank
    buffers' ``split_axis`` indexes the peer rank: ``dst``'s block q is what
    rank q sent here.  For ``split_axis=0`` that is
    ``dist.all_to_all_single(dst, src, group, async_op=True)``; other split
    axes are not on a ported path and raise."""

    def __init__(self, name: str, src: str, dst: str, axis: str,
                 split_axis: int = 1):
        super().__init__(name, src, dst)
        self._axis = axis
        self._split = int(split_axis)

    def axis(self) -> str:
        return self._axis

    def split_axis(self) -> int:
        return self._split

    def execute(self, ctx) -> None:
        ctx.post_collective(self)

    def apply(self, bufs: Dict[str, Any], ctx) -> None:
        raise TypeError(f"{self.name()}: a collective is posted through "
                        "RunContext.post_collective, not applied")

    def launch(self, bufs: Dict[str, Any], group):
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
