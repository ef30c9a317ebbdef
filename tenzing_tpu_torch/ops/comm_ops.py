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
collective's ``launch`` takes the buffers, the axis group, the axis size and
the executor's scratch.  A size-1 axis of a larger mesh has no group of
its own (the default group would reach the ranks of the other axes): there
the psum and the all-to-all are what their definitions say for one rank (a
copy), posted without a message.  A world of one rank keeps its group, so
they go through the process group as at any size.

An **in-op exchange** (:func:`lane_permute`) is a ``lax.ppermute`` inside a
device op's ``apply`` (the reference's ``ExchangeLeft`` / ``ExchangeRight``
of models/spmv_dist.py and ``RotateKV`` of models/ring_attention.py): its
sends and receives are issued on the op's lane stream and the lane waits
for them there, with no host wait.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Sequence as Seq

from tenzing_tpu_torch.core.operation import CpuOp, register_kind

# The transfer posts by the engine that carries them (bench/model.py's cost
# model; the chunk layer's COMM_KINDS, core/chunking.py): "ici" moves data
# between ranks (the collectives and the mesh shifts of ops/rdma.py), "pcie"
# through pinned host memory.
ICI_KINDS = ("permute_start", "all_to_all_start", "psum_start",
             "rdma_copy_start", "rdma_shift_start")
PCIE_KINDS = ("host_spill_start", "host_fetch_start")


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

    def launch(self, bufs: Dict[str, Any], group, size: int,
               scratch: Optional[Dict[str, Any]] = None):
        """Start the collective on the current stream; returns its work
        (anything with a ``wait()``).  ``scratch`` is the executor's (what
        :meth:`scratch_for` declared)."""
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


class Then:
    """A work followed by a step the host runs after it: ``wait()`` waits the
    work, then calls ``after`` (on CUDA under the stream the wait was issued
    on, so the step is ordered after the collective there)."""

    def __init__(self, work, after):
        self.work, self.after = work, after

    def wait(self) -> None:
        self.work.wait()
        self.after()


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


def lane_permute(ctx, op, axis: str, perm_of, pairs) -> None:
    """The in-op exchange: a ``lax.ppermute`` of each ``(src, dst)`` buffer
    name pair of ``pairs`` over mesh axis ``axis`` with the permutation
    ``perm_of(n)`` (a list of ``(from, to)`` axis indices for an axis of
    size n), written into ``ctx.bufs`` in place.  A rank that no pair sends
    to gets zeros (an open permutation's edge), as ``lax.ppermute`` gives.

    The group, size and index come from ``ctx.exchange_group``, which
    refuses a shared card and a capture on an axis of size > 1.  A pair
    whose source and destination are this rank is a copy; the rest is one
    ``dist.batch_isend_irecv`` whose works are waited on the current stream:
    on CUDA that is the op's lane stream, so NCCL orders after the lane's
    work and the lane after NCCL's with no host wait; on gloo the wait
    blocks.  Each destination has its own tag (:func:`p2p_tag`)."""
    import torch.distributed as dist

    group, size, me = ctx.exchange_group(op, axis)
    perm = list(perm_of(size))
    sends = [t for f, t in perm if f == me]
    recvs = [f for f, t in perm if t == me]
    p2p = []
    for src_name, dst_name in pairs:
        src, dst = ctx.bufs[src_name], ctx.bufs[dst_name]
        if not recvs:
            dst.zero_()
        tag = p2p_tag(dst_name)
        for t in sends:
            if t == me:
                dst.copy_(src)
            else:
                p2p.append(dist.P2POp(dist.isend, src,
                                      dist.get_global_rank(group, t), group,
                                      tag))
        for f in recvs:
            if f != me:
                p2p.append(dist.P2POp(dist.irecv, dst,
                                      dist.get_global_rank(group, f), group,
                                      tag))
    if p2p:
        for w in dist.batch_isend_irecv(p2p):
            w.wait()


def open_shift(step: int):
    """The open permutation of a neighbour exchange, ``step`` = +1: index i
    sends to i + 1 (``[(i, i + 1) for i in range(n - 1)]``, the reference's
    ``ExchangeLeft``); -1: i + 1 sends to i (``ExchangeRight``)."""
    if step == 1:
        return lambda n: [(i, i + 1) for i in range(n - 1)]
    if step == -1:
        return lambda n: [(i + 1, i) for i in range(n - 1)]
    raise ValueError(f"open_shift: step {step} is not +1 or -1")


def cyclic_shift(n: int):
    """The cyclic permutation ``[(i, (i + 1) % n)]`` (``RotateKV``)."""
    return [(i, (i + 1) % n) for i in range(n)]


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

    def launch(self, bufs: Dict[str, Any], group, size: int,
               scratch: Optional[Dict[str, Any]] = None):
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
    async_op=True)`` over the axis group; the copy alone on an axis with
    no group of its own (a size-1 axis of a larger mesh)."""

    def launch(self, bufs: Dict[str, Any], group, size: int,
               scratch: Optional[Dict[str, Any]] = None):
        import torch.distributed as dist

        dst = bufs[self._dst]
        dst.copy_(bufs[self._src], non_blocking=True)
        if group is None:
            return Done()
        return dist.all_reduce(dst, group=group, async_op=True)

    def to_json(self) -> Dict[str, Any]:
        j = super().to_json()
        j.update(axis=self._axis)
        return j


@register_kind("all_to_all_start")
class AllToAllStart(Collective):
    """Post a width-padded all-to-all of ``src`` into ``dst`` over mesh axis
    ``axis`` (reference ``AllToAllStart``, tenzing_tpu/ops/comm_ops.py:164, a
    ``lax.all_to_all`` with ``split_axis`` as both split and concat axis;
    the original tenzing's ``Ialltoallv``, ops_mpi.hpp:82-119).  The
    per-rank buffers' ``split_axis`` indexes the peer rank: ``src``'s block
    q along it goes to rank q, and ``dst``'s block q is what rank q sent
    here.

    For ``split_axis=0`` that is ``dist.all_to_all_single(dst, src, group,
    async_op=True)``.  For another split axis the post copies ``src`` with
    that axis moved to the front into contiguous staging scratch
    (:meth:`scratch_for`), exchanges it into a second staging buffer, and
    the await's wait moves the axis back into ``dst`` (:class:`Then`, on
    the transfer stream on CUDA).  On an axis with no group of its own (a
    size-1 axis of a larger mesh) the post is the copy ``dst <- src``."""

    def __init__(self, name: str, src: str, dst: str, axis: str,
                 split_axis: int = 1):
        super().__init__(name, src, dst, axis)
        self._split = int(split_axis)

    def split_axis(self) -> int:
        return self._split

    def _stage_names(self):
        return f"a2a_stage_in_{self._dst}", f"a2a_stage_out_{self._dst}"

    def scratch_for(self, shapes):
        """The two staging buffers of a split axis other than 0: ``src``'s
        shape with that axis first, in ``src``'s dtype (``shapes.dtypes``,
        which the executor passes)."""
        if self._split == 0:
            return {}
        shape = list(shapes[self._src])
        shape.insert(0, shape.pop(self._split))
        dtype = shapes.dtypes[self._src]
        return {n: (tuple(shape), dtype) for n in self._stage_names()}

    def launch(self, bufs: Dict[str, Any], group, size: int,
               scratch: Optional[Dict[str, Any]] = None):
        """Start the exchange on the current stream; returns its work."""
        import torch.distributed as dist

        src, dst = bufs[self._src], bufs[self._dst]
        if group is None:
            dst.copy_(src, non_blocking=True)
            return Done()
        if self._split == 0:
            return dist.all_to_all_single(dst, src, group=group,
                                          async_op=True)
        names = self._stage_names()
        if scratch is None or names[0] not in scratch:
            raise RuntimeError(f"{self.name()}: the staging scratch of "
                               f"split_axis={self._split} was not provisioned")
        stage_in, stage_out = scratch[names[0]], scratch[names[1]]
        stage_in.copy_(src.movedim(self._split, 0))
        work = dist.all_to_all_single(stage_out, stage_in, group=group,
                                      async_op=True)
        return Then(work, lambda: dst.copy_(stage_out.movedim(0, self._split)))

    def to_json(self) -> Dict[str, Any]:
        j = super().to_json()
        j.update(axis=self._axis, split_axis=self._split)
        return j
