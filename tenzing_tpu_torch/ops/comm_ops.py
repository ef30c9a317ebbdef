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

The mesh collectives (``PermuteStart``, ``AllToAllStart``, ``PsumStart``) come
with the multi-device slice.
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
