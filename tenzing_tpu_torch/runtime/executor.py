"""Schedule execution on CUDA streams: the ``StreamExecutor``.

Counterpart of ``tenzing_tpu/runtime/executor.py``.  The reference traces a
schedule into one XLA program whose lane and event "tokens" are data ties,
because XLA strips barriers (executor.py:25-37).  On CUDA the schedule runs the
way the original tenzing ran it (SURVEY.md §3.3, §7.0):

* **lanes** — one ``torch.cuda.Stream`` per lane, created once per executor;
  a device op runs under ``torch.cuda.stream(lane stream)``;
* **events** — one ``torch.cuda.Event`` per event id; the five sync ops map to
  ``event.record(stream)``, ``stream.wait_event(event)``,
  ``event.synchronize()``, ``stream.synchronize()`` and
  ``waiter.wait_stream(waitee)`` (core/sync_ops.py);
* **host ops** run on the host thread in sequence order, so a device op is
  launched only after every host op before it — including the blocking
  waits — has returned;
* **transfers** — each channel (one per halo direction) has its own transfer
  stream, created once.  A post enqueues its copy there and records an event;
  a device-space destination's event goes into ``inflight`` and the matching
  AwaitTransfer blocks the host on it (ops/comm_ops.py).

Buffers are written in place.  No op allocates while a schedule runs: every op
writes into the buffers of the initial dict or into scratch declared by the
op (``DeviceOp.scratch``), allocated once before the first run.  (A tensor the
caching allocator handed out on one lane's stream and another lane then read
would be a use-after-free waiting to happen.)  Host buffers must be pinned: a
non-blocking copy from pageable memory is silently synchronous and would hide
the overlap the search measures.

**Host syncs that no host work needs are deferred.**  The synchronizer puts
an ``EventRecord`` / ``EventSync`` pair before every host op with a device
op among its graph predecessors, also before the host ops that touch no
buffer: the chunk directive (core/chunking.py ``ChunkDirective``) of an op
whose predecessor is a device op, as in attention's fold chain.  On the TPU these syncs are value ties that
cost nothing; a blocking ``event.synchronize()`` before every chunked block
would cost the port a host round trip the reference does not pay.  So an
``EventSync`` does not block when it runs: its event stays *pending*, and

* before each later device op, each of the op's lane streams waits on every
  pending event (``stream.wait_event``);
* before each later host op that reads or writes a buffer (a transfer post
  or await among them), the host waits on every pending event;
* at the end of the schedule, the host waits on every pending event.

A host op that touches no buffer cannot observe the device, and every later
op is ordered after the event as before, so this is sound; the schedule JSON
and the synchronizer's output are unchanged.  ``defer_host_syncs=False``
blocks at every ``EventSync`` instead (the before/after measurement of
``chip_smoke.py``'s ``host_syncs`` phase).  ``RunContext.host_syncs`` counts the
host blocks executed.

**Collectives** (``AllToAllStart``, ``PermuteStart``, ``PsumStart``,
ops/comm_ops.py) are posted like a transfer: on the channel's transfer
stream, over the process group of the platform mesh's axis
(core/platform.py ``Mesh``), with ``async_op=True``; the returned work is in
flight until its ``AwaitTransfer``, which blocks the host until it has
finished, on NCCL as on gloo.  Each rank runs the same schedule on its own
shard of the buffers (parallel/mesh.py).  On a mesh whose ranks share one
card over gloo a collective post raises: gloo does not move device tensors.

**The mesh shift** (``RdmaShiftStart`` on an axis of size > 1, ops/rdma.py)
is posted by :meth:`RunContext.post_shift`: the channel's transfer stream
first waits on this rank's earlier readers of its own ``dst`` (the
neighbour's post writes into it, so it must not land while an unpack of
the previous run still reads it: the device ops that read a shift
destination record an event after them; the schedule's last sync before
``finish`` already makes the host wait for a run's device ops before the
next run's posts, and the stream wait keeps the order where no host wait
lies between them), then runs ``rdma_shift_post``;
the await enqueues ``rdma_shift_wait`` on the same stream and blocks the
host on an event after it, with a deadline (``rdma.await_shift``).  An event on the post alone would not do: the bytes
that land in ``dst`` come from the neighbour's kernel, so only this rank's
arrival flag shows they landed.  On an axis of size 1 the shift is the
loopback copy, posted like any transfer.  With ``device="cpu"``, or under
``plain_kernels``, the shift is its plain version over the axis group.

**An await with nothing in flight** raises, except on a buffer that a
device op wrote since its last post (:func:`graphs.track_landed`): a
synthesized exchange (collectives/synth.py) delivers the destination with
its own posts, awaits and a final device step, and the graph keeps the
site's await after it (the halo's ``await_<dir>`` after an
``ExchangeChoice`` alternative, as in the reference, whose await of such a
buffer is a no-op).  The synchronizer has ordered that await after the
device step, so there is nothing left to wait for.

**Stepped execution** (:meth:`StreamExecutor.op_stepped`, the attribution
profiler's timed mode, obs/attrib/timeline.py) runs a schedule one unit at a
time from a copy of the initial buffers, each unit alone on an idle device;
see the method.

**CUDA graphs** (runtime/graphs.py), the counterpart of the reference's
compile step: with ``graphs`` on (the default on CUDA), :meth:`precompile
<StreamExecutor.precompile>` captures each *segment* of a schedule — the
device work between two points where the host blocks (an AwaitTransfer, a
LaneSync, a flush of the pending syncs, a blocking EventSync, the end) —
once, against the executor's own buffers, as a ``torch.cuda.CUDAGraph``,
and caches them under the schedule's JSON (LRU, bounded by count and by the
graphs' pool bytes).  ``prepare_n`` then replays the graphs n times with
the plan's host waits between them, and synchronizes the device once.  A
capture runs through a :class:`CaptureContext`: streams and internal events
of its own, so a capture on a background thread (bench/pipeline.py) never
touches the streams the foreground runs on; every host block becomes a
recorded wait.  A schedule that cannot be captured (a collective or a mesh
shift: a host-side wait or a host counter would be frozen into the graph)
raises from ``precompile`` naming its op; such a schedule runs on an
executor built with ``graphs=False``, which runs every op from Python as
before.  :meth:`op_stepped <StreamExecutor.op_stepped>` stays eager.

With ``device="cpu"`` — only when asked, as the tests do — sync ops are no-ops
and ops run in sequence order, so outputs stay checkable without a card.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from tenzing_tpu_torch.core.operation import BoundDeviceOp, OpBase, unbound
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.resources import Event, Lane
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.serdes import sequence_to_json_str
from tenzing_tpu_torch.core.sync_ops import EventRecord
from tenzing_tpu_torch.fault.cancel import check as check_cancelled
from tenzing_tpu_torch.fault.errors import DeterministicScheduleError
from tenzing_tpu_torch.ops.comm_ops import Done
from tenzing_tpu_torch.runtime import graphs


def resolve_device(device: Optional[str] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller passes
    ``"cpu"``.  Raises when CUDA is asked for (the default) and absent — an
    entry point never carries on quietly on the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass(frozen=True)
class ZerosSpec:
    """A zero-filled buffer given by shape and torch dtype name, for a dtype
    numpy has no type for (``"bfloat16"``: the MoE's half-width staging
    buffers; the reference builds those with ``ml_dtypes``)."""

    shape: Tuple[int, ...]
    dtype: str

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=getattr(torch, self.dtype))


def buffers_from_numpy(bufs: Dict[str, Union[np.ndarray, ZerosSpec]], device,
                       host_names: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """The reference's numpy buffer dict (e.g. ``make_pipeline_buffers``) as
    the port's tensors: ``host_names`` stay in host memory — pinned when the
    device is CUDA — and the rest move to ``device``.  A :class:`ZerosSpec`
    value becomes a zero tensor of its dtype.  Counterpart of
    ``TraceExecutor.place_host_buffers`` (tenzing_tpu/runtime/executor.py:340)."""
    dev = torch.device(device)
    host_names = set(host_names)
    out: Dict[str, torch.Tensor] = {}
    for k, v in bufs.items():
        t = (v.zeros() if isinstance(v, ZerosSpec)
             else torch.from_numpy(np.ascontiguousarray(v)))
        if k in host_names:
            if dev.type == "cuda":
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                out[k] = pinned.copy_(t)
            else:
                out[k] = t.clone()
        else:
            out[k] = t.to(dev, copy=True)
    return out


def _copy_buffers(bufs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Same-placement copies of a buffer dict (host copies stay pinned)."""
    out = {}
    for k, v in bufs.items():
        if v.device.type == "cpu" and v.is_pinned():
            out[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v)
        else:
            out[k] = v.clone()
    return out


class BufferShapes(dict):
    """Buffer name -> shape, what ``scratch_for`` receives; ``dtypes`` maps
    each name to its torch dtype name, for scratch in a buffer's type."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]],
                 dtypes: Dict[str, str]):
        super().__init__(shapes)
        self.dtypes = dtypes


class _Collective:
    """An in-flight collective: its ``async_op`` work and, on CUDA, the
    transfer stream it was posted under."""

    def __init__(self, work, stream):
        self.work, self.stream = work, stream

    def wait(self, event) -> None:
        """Block the host until the collective has finished.  On gloo
        ``work.wait()`` blocks; on NCCL it only makes the current stream
        wait, so it is issued on the transfer stream and the host then waits
        on an event recorded there."""
        if self.stream is None:
            self.work.wait()
            return
        with torch.cuda.stream(self.stream):
            self.work.wait()
        event.record(self.stream)
        event.synchronize()


class _Shift:
    """An in-flight mesh shift: what its wait kernel needs."""

    def __init__(self, peers, cid: int, epoch: int, stream):
        self.peers, self.cid, self.epoch, self.stream = (peers, cid, epoch,
                                                         stream)

    def wait(self, event) -> None:
        """Enqueue ``rdma_shift_wait`` on the post's stream and block the
        host until it has passed (``rdma.await_shift``: a deadline, since a
        stream wait has none); a stuck hand-off raises with its reason."""
        from tenzing_tpu_torch.ops import rdma

        with torch.cuda.stream(self.stream):
            rdma.rdma_shift_wait(self.peers.flags, self.cid, self.epoch,
                                 self.peers.err)
        event.record(self.stream)
        try:
            rdma.await_shift(event, self.peers.flags, self.cid, self.epoch,
                             self.peers.err)
        except RuntimeError as e:
            why = rdma.shift_error(self.peers.err)
            if why is None:
                raise
            raise RuntimeError(f"rdma shift on axis {self.peers.axis!r}, "
                               f"collective id {self.cid}: {why}") from e


class RunContext:
    """What ops see while a schedule runs: the buffers, the scratch, the lane
    and transfer streams, the events, and the in-flight transfers.  Owned by
    one :class:`StreamExecutor`; the streams and events live as long as it."""

    def __init__(self, device: torch.device, plain_kernels: bool = False,
                 mesh=None, defer_host_syncs: bool = True):
        self.device = device
        self.on_cuda = device.type == "cuda"
        # True: every kernel wrapper is replaced by its plain PyTorch version
        # (the reference run that chip_smoke.py compares the kernels with)
        self.plain_kernels = plain_kernels
        # the platform's mesh (core/platform.py Mesh): collectives' groups
        self.mesh = mesh
        self.defer_host_syncs = defer_host_syncs
        self.bufs: Dict[str, torch.Tensor] = {}
        self.scratch: Dict[str, torch.Tensor] = {}
        self.host_names: set = set()
        self.inflight: Dict[str, Any] = {}
        # the buffers a device op wrote since their last post
        # (graphs.track_landed; module docstring)
        self.landed: set = set()
        # events of EventSyncs not waited on yet, and the (lane, event)
        # stream waits already issued for them (module docstring)
        self.pending: List[Event] = []
        self._pending_waited: set = set()
        # host blocks executed: an EventSync that blocks, a flush of the
        # pending ones, a LaneSync, an AwaitTransfer
        self.host_syncs = 0
        self._lanes: Dict[int, Any] = {}
        self._events: Dict[int, Any] = {}
        self._channels: Dict[str, Any] = {}
        self._post_events: Dict[str, Any] = {}
        # the mesh shift: one ShiftPeers per axis, the destinations posted so
        # far, and per destination an event after each lane's last reader
        self.generation = 0
        self._peers: Dict[str, Any] = {}
        self._shift_dsts: set = set()
        self._readers: Dict[str, Dict[int, Any]] = {}

    # -- resources (created once, on first use) -------------------------
    def lane_stream(self, lane: Lane):
        s = self._lanes.get(lane.id)
        if s is None:
            s = self._lanes[lane.id] = torch.cuda.Stream(device=self.device)
        return s

    def event(self, event: Event):
        e = self._events.get(event.id)
        if e is None:
            e = self._events[event.id] = torch.cuda.Event()
        return e

    def channel_stream(self, channel: str):
        s = self._channels.get(channel)
        if s is None:
            s = self._channels[channel] = torch.cuda.Stream(device=self.device)
        return s

    def _post_event(self, dst: str):
        e = self._post_events.get(dst)
        if e is None:
            e = self._post_events[dst] = torch.cuda.Event()
        return e

    # -- running one op -------------------------------------------------
    def run(self, op: OpBase) -> None:
        """Execute ``op``, first settling the pending host syncs it depends
        on (module docstring): a device op's lanes wait on them, a host op
        that touches a buffer waits for them on the host."""
        if self.pending:
            if isinstance(op, BoundDeviceOp):
                for lane in op.lanes():
                    self.wait_pending(lane)
            elif graphs.flushes_pending(op, {e.id for e in self.pending}):
                self.flush_pending()
        op.execute(self)
        graphs.track_landed(op, self.landed)

    def wait_pending(self, lane: Lane) -> None:
        """Make ``lane``'s stream wait on every pending event."""
        for e in self.pending:
            if (lane.id, e.id) not in self._pending_waited:
                self._pending_waited.add((lane.id, e.id))
                self.wait_event(lane, e)

    def flush_pending(self) -> None:
        """Block the host on every pending event (one host sync)."""
        if not self.pending:
            return
        self.host_syncs += 1
        for e in self.pending:
            self.host_wait_event(e)
        self.pending = []
        self._pending_waited = set()

    # -- op hooks ---------------------------------------------------------
    def run_default(self, op: OpBase) -> None:
        if self.on_cuda and isinstance(op, BoundDeviceOp):
            stream = self.lane_stream(op.lane())
            with torch.cuda.stream(stream):
                op.apply(self.bufs, self)
            for buf in self._shift_dsts.intersection(op.reads()):
                ev = self._readers.setdefault(buf, {}).get(op.lane().id)
                if ev is None:
                    ev = self._readers[buf][op.lane().id] = torch.cuda.Event()
                ev.record(stream)
        else:
            op.apply(self.bufs, self)

    def post_transfer(self, op) -> None:
        """Enqueue ``op``'s copy on its channel's transfer stream and, for a
        device-space destination, mark it in flight (comm_ops.CommStart)."""
        dst = op.dst()
        awaited = op.DST_SPACE != "host"
        if awaited and dst in self.inflight:
            raise RuntimeError(f"{op.name()}: a transfer into {dst!r} is "
                               "already in flight")
        if not self.on_cuda:
            op.apply(self.bufs, self)
            if awaited:
                self.inflight[dst] = True
            return
        stream = self.channel_stream(op.channel())
        with torch.cuda.stream(stream):
            op.apply(self.bufs, self)
        if awaited:
            ev = self._post_event(dst)
            ev.record(stream)
            self.inflight[dst] = ev

    def post_collective(self, op) -> None:
        """Post ``op``'s collective (``op.launch(bufs, group, size,
        scratch)``, which returns the ``async_op`` work) over the process
        group of its mesh axis; on CUDA under the channel's transfer stream,
        which NCCL's stream waits on at the call.  The work is in flight
        until its await."""
        dst = op.dst()
        if dst in self.inflight:
            raise RuntimeError(f"{op.name()}: a transfer into {dst!r} is "
                               "already in flight")
        if self.mesh is None:
            raise RuntimeError(f"{op.name()}: a collective over axis "
                               f"{op.axis()!r} needs a platform mesh")
        if self.mesh.shared_card:
            raise RuntimeError(
                f"{op.name()}: the ranks share one card over gloo, which "
                "cannot move device tensors; only the .rdma shift exchanges "
                "data between them")
        group, size = self.mesh.group(op.axis()), self.mesh.size(op.axis())
        if not self.on_cuda:
            self.inflight[dst] = _Collective(
                op.launch(self.bufs, group, size, self.scratch), None)
            return
        stream = self.channel_stream(op.channel())
        with torch.cuda.stream(stream):
            work = op.launch(self.bufs, group, size, self.scratch)
        self.inflight[dst] = _Collective(work, stream)

    def exchange_group(self, op, axis: str):
        """(group, size, this rank's index) of mesh axis ``axis`` for an
        in-op exchange (ops/comm_ops.py ``lane_permute``): it needs a mesh,
        and on an axis of size > 1 it refuses ranks that share one card
        (gloo cannot move device tensors; only the ``.rdma`` shift exchanges
        data between them)."""
        if self.mesh is None:
            raise RuntimeError(f"{op.name()}: an exchange over axis {axis!r} "
                               "needs a platform mesh")
        size = self.mesh.size(axis)
        if size > 1 and self.mesh.shared_card:
            raise RuntimeError(
                f"{op.name()}: the ranks share one card over gloo, which "
                "cannot move device tensors; only the .rdma shift exchanges "
                "data between them")
        return self.mesh.group(axis), size, self.mesh.index(axis)

    def post_shift(self, op) -> None:
        """Post a mesh shift (ops/rdma.py ``RdmaShiftStart``; module
        docstring): the loopback on an axis of size 1 (or without a mesh, as
        the reference's), else the shift kernel's post half, or the plain
        shift on the CPU and under ``plain_kernels``."""
        from tenzing_tpu_torch.ops import rdma

        size = (self.mesh.size(op.axis())
                if self.mesh is not None and op.axis() in self.mesh.axes
                else 1)
        if size == 1:
            self.post_transfer(op)
            return
        dst = op.dst()
        if dst in self.inflight:
            raise RuntimeError(f"{op.name()}: a transfer into {dst!r} is "
                               "already in flight")
        group = self.mesh.group(op.axis())
        x, y = self.bufs[op.src()], self.bufs[dst]
        if not self.on_cuda or self.plain_kernels:
            rdma.rdma_shift_plain(x, y, group, size, op.shift(), op.tag())
            self.inflight[dst] = _Collective(Done(), None)
            return
        peers = self._peers.get(op.axis())
        if peers is None:
            peers = self._peers[op.axis()] = rdma.ShiftPeers(
                op.axis(), group, size, self.device)
        shift = op.shift() % size
        peer_y = peers.peer_recv(dst, y, shift, self.generation)
        self._shift_dsts.add(dst)
        stream = self.channel_stream(op.channel())
        for ev in self._readers.get(dst, {}).values():
            stream.wait_event(ev)
        cid = op.collective_id()
        epoch = peers.next_epoch(cid)
        with torch.cuda.stream(stream):
            rdma.rdma_shift_post(x, peer_y, peers.flags,
                                 peers.flag_block(shift),
                                 peers.flag_block(-shift), cid, epoch,
                                 peers.err)
        self.inflight[dst] = _Shift(peers, cid, epoch, stream)

    def await_transfer(self, buf: str) -> None:
        """Block the host until the transfer into ``buf`` has landed.  A
        host-space buffer has nothing to await (the reference's
        AwaitTransfer skips host-space buffers too)."""
        if buf in self.host_names:
            return
        if buf not in self.inflight:
            if buf in self.landed:
                return
            raise RuntimeError(f"await on {buf!r}: no transfer in flight")
        entry = self.inflight.pop(buf)
        self.host_syncs += 1
        if isinstance(entry, _Shift):
            entry.wait(self._post_event(buf))
        elif isinstance(entry, _Collective):
            entry.wait(self._post_event(buf) if entry.stream is not None
                       else None)
        elif self.on_cuda:
            entry.synchronize()

    def record_event(self, lane: Lane, event: Event) -> None:
        if self.on_cuda:
            self.event(event).record(self.lane_stream(lane))

    def wait_event(self, lane: Lane, event: Event) -> None:
        if self.on_cuda:
            self.lane_stream(lane).wait_event(self.event(event))

    def sync_event_host(self, event: Event) -> None:
        """The ``EventSync`` hook: the event becomes pending (module
        docstring), or the host waits on it now with ``defer_host_syncs``
        off."""
        if not self.defer_host_syncs:
            self.host_syncs += 1
            self.host_wait_event(event)
        elif all(e.id != event.id for e in self.pending):
            self.pending.append(event)

    def host_wait_event(self, event: Event) -> None:
        """Block the host until ``event``'s snapshot has completed."""
        if self.on_cuda:
            self.event(event).synchronize()

    def sync_lane_host(self, lane: Lane) -> None:
        self.host_syncs += 1
        if self.on_cuda:
            self.lane_stream(lane).synchronize()

    def wait_lane(self, waiter: Lane, waitee: Lane) -> None:
        if self.on_cuda:
            self.lane_stream(waiter).wait_stream(self.lane_stream(waitee))

    def streams(self) -> List[Any]:
        """Every lane and transfer stream created so far."""
        return list(self._lanes.values()) + list(self._channels.values())


class CaptureError(DeterministicScheduleError):
    """A schedule that cannot be captured as CUDA graphs; the message names
    the op."""


class CaptureContext(RunContext):
    """What ops see while :meth:`StreamExecutor.precompile` captures a
    schedule (module docstring; runtime/graphs.py).  It runs the ops the way
    :class:`RunContext` does, over the executor's buffers and scratch, with

    * streams of its own (``graphs.STREAMS``), one per lane and channel,
      each joining a segment's capture at its first use there: it waits on
      the segment's origin stream and on its own external tail event;
    * internal events of its own, for the orders inside one segment, and
      the schedule's *external* events (created before the capture, in
      :meth:`prepare`): one per schedule event id, re-recorded at each
      ``EventRecord``; one per transfer destination, recorded after its
      post; one tail per stream, recorded at the end of each segment that
      touches it;
    * host blocks recorded in :attr:`waits` as ``(kind, what, events)``
      (graphs.HostWait's kinds) instead of performed.

    A collective or a mesh shift raises :class:`CaptureError`: its host
    wait (an NCCL work, the shift's flag deadline) and its host-side epoch
    cannot live in a graph."""

    def __init__(self, owner: RunContext, bufs: Dict[str, torch.Tensor]):
        super().__init__(owner.device, plain_kernels=owner.plain_kernels,
                         mesh=owner.mesh,
                         defer_host_syncs=owner.defer_host_syncs)
        self.bufs, self.scratch = bufs, owner.scratch
        self.host_names = owner.host_names
        self.origin = None
        self.waits: List[Tuple[str, Tuple, List[Any]]] = []
        self._joined: Dict[Tuple[str, Any], Any] = {}
        self._recorded: set = set()
        self.ext_events: Dict[int, Any] = {}
        self.posts: Dict[str, Any] = {}
        self.tails: Dict[Tuple[str, Any], Any] = {}

    def prepare(self, ops: List[OpBase], keys: Iterable) -> None:
        """Before the capture: take a stream for each of the stream
        ``keys`` (graphs.op_streams over ``ops``) and warm its library
        handles (graphs.warm_stream), and create the external events of
        ``ops`` and the keys' tails, each recorded once on a stream of its
        own, so the capture finds every one made (a wait on an event never
        recorded would add no node)."""
        setup = graphs.STREAMS.take(self.device)

        def ext(table, key):
            if key not in table:
                ev = table[key] = torch.cuda.Event(external=True)
                ev.record(setup)

        for op in ops:
            if isinstance(op, EventRecord):
                ext(self.ext_events, op.event().id)
            elif getattr(unbound(op), "DST_SPACE", None) == "device":
                ext(self.posts, op.dst())
        for key in keys:
            ext(self.tails, key)
            table = self._lanes if key[0] == "lane" else self._channels
            s = table[key[1]] = graphs.STREAMS.take(self.device)
            graphs.warm_stream(s)
        setup.synchronize()
        graphs.STREAMS.give([setup])

    def release(self) -> None:
        """Give the capture streams back to the pool."""
        graphs.STREAMS.give(list(self._lanes.values())
                            + list(self._channels.values()))
        self._lanes, self._channels = {}, {}

    def begin_segment(self, origin) -> None:
        self.origin, self.waits = origin, []
        self._joined, self._recorded = {}, set()

    def end_segment(self) -> None:
        """Inside the capture: record each joined stream's tail and join it
        back to the origin."""
        for key, s in self._joined.items():
            self.tails[key].record(s)
            self.origin.wait_stream(s)

    def segment_waits(self) -> List[Tuple[str, Tuple, List[Any]]]:
        """The segment's host waits, a lane wait resolved to the lane's
        tail (its last record so far; none where the lane never runs)."""
        return [(kind, what, evs if kind != "lane" else
                 [self.tails.get(("lane", what[0]))])
                for kind, what, evs in self.waits]

    def _join(self, key, table: Dict[Any, Any], name) -> Any:
        s = self._joined.get(key)
        if s is not None:
            return s
        if self.origin is None:
            raise CaptureError(f"stream {key} used outside a capture")
        s = table.get(name)
        if s is None:
            raise CaptureError(f"stream {key} is not in the capture plan")
        s.wait_stream(self.origin)
        self.tails[key].wait(s)
        self._joined[key] = s
        return s

    def lane_stream(self, lane: Lane):
        return self._join(("lane", lane.id), self._lanes, lane.id)

    def channel_stream(self, channel: str):
        return self._join(("channel", channel), self._channels, channel)

    def record_event(self, lane: Lane, event: Event) -> None:
        s = self.lane_stream(lane)
        self.event(event).record(s)
        self.ext_events[event.id].record(s)
        self._recorded.add(event.id)

    def wait_event(self, lane: Lane, event: Event) -> None:
        s = self.lane_stream(lane)
        if event.id in self._recorded:
            s.wait_event(self.event(event))
        elif event.id in self.ext_events:
            self.ext_events[event.id].wait(s)

    def _host_events(self, ids) -> List[Any]:
        return [self.ext_events[i] for i in ids if i in self.ext_events]

    def flush_pending(self) -> None:
        if not self.pending:
            return
        ids = tuple(e.id for e in self.pending)
        self.waits.append(("flush", ids, self._host_events(ids)))
        self.pending = []
        self._pending_waited = set()

    def sync_event_host(self, event: Event) -> None:
        if self.defer_host_syncs:
            super().sync_event_host(event)
            return
        self.waits.append(("event", (event.id,),
                           self._host_events([event.id])))

    def sync_lane_host(self, lane: Lane) -> None:
        self.waits.append(("lane", (lane.id,), []))

    def post_transfer(self, op) -> None:
        dst = op.dst()
        awaited = op.DST_SPACE != "host"
        if awaited and dst in self.inflight:
            raise RuntimeError(f"{op.name()}: a transfer into {dst!r} is "
                               "already in flight")
        stream = self.channel_stream(op.channel())
        with torch.cuda.stream(stream):
            op.apply(self.bufs, self)
        if awaited:
            self.posts[dst].record(stream)
            self.inflight[dst] = self.posts[dst]

    def await_transfer(self, buf: str) -> None:
        if buf in self.host_names:
            return
        if buf not in self.inflight:
            if buf in self.landed:
                return
            raise RuntimeError(f"await on {buf!r}: no transfer in flight")
        self.waits.append(("transfer", (buf,), [self.inflight.pop(buf)]))

    def post_collective(self, op) -> None:
        raise CaptureError(
            f"{op.name()}: a collective cannot be captured (its await waits "
            "on the process group's work from the host); run this schedule "
            "on an executor with graphs=False")

    def exchange_group(self, op, axis: str):
        got = super().exchange_group(op, axis)
        if got[1] > 1:
            raise CaptureError(
                f"{op.name()}: an exchange inside a device op cannot be "
                "captured (its sends and receives are issued from the host "
                "at the op); run this schedule on an executor with "
                "graphs=False")
        return got

    def post_shift(self, op) -> None:
        size = (self.mesh.size(op.axis())
                if self.mesh is not None and op.axis() in self.mesh.axes
                else 1)
        if size > 1:
            raise CaptureError(
                f"{op.name()}: the mesh shift cannot be captured (its epoch "
                "is a host counter and its await a host-side deadline); run "
                "this schedule on an executor with graphs=False")
        self.post_transfer(op)


def _is_sync(op: OpBase) -> bool:
    return getattr(op, "is_sync", lambda: False)()


def step_units(ops: List[OpBase]) -> List[Tuple[int, ...]]:
    """The positions of each unit of :meth:`StreamExecutor.op_stepped`, in
    order: a split ``.rdma`` post with every op through its matching await
    (the reference's grouping), a sync op outside such a group alone, every
    other op alone; an un-awaited tail is one unit."""
    units: List[Tuple[int, ...]] = []
    cur: List[int] = []
    pending: set = set()
    for p, op in enumerate(ops):
        if _is_sync(op):
            if cur:
                cur.append(p)
            else:
                units.append((p,))
            continue
        cur.append(p)
        kind = getattr(op, "KIND", "")
        if kind in ("rdma_copy_start", "rdma_shift_start"):
            pending.update(op.writes())
        elif kind == "await_transfer":
            pending.discard(op.buf())
        elif kind == "multi_await":
            pending.difference_update(op.bufs())
        if not pending:
            units.append(tuple(cur))
            cur = []
    if cur:
        units.append(tuple(cur))
    return units


def evolve_host_space(names: set, op: OpBase) -> None:
    """Apply ONE op's transfer semantics to a set of host-resident buffer
    names, in place: an op declaring ``DST_SPACE`` (ops/comm_ops.py) moves
    its writes into ("host") or out of ("device") host memory; every other op
    leaves the set alone.  The one copy of the rule, shared with the fusion
    partitioner (runtime/fused.py ``partition_regions``) — the reference's
    ``evolve_host_space`` (tenzing_tpu/runtime/executor.py:278)."""
    dst_space = getattr(unbound(op), "DST_SPACE", None)
    if dst_space is not None:
        for w in op.writes():
            if dst_space == "host":
                names.add(w)
            else:
                names.discard(w)


class StreamExecutor:
    """Runs schedules on CUDA streams (the ``ScheduleRunner`` the benchmarker
    calls: ``prepare``, ``prepare_n``, ``run``, ``compile``, ``precompile``,
    ``is_compiled``).

    ``init_bufs`` are the schedule's buffers, already placed
    (:func:`buffers_from_numpy`; on a mesh, this rank's shards from
    parallel/mesh.py ``shard_buffers``); timed runs update them in place.  A copy of
    their initial contents is kept so :meth:`run` can start every validation
    run from the same state.  ``device`` defaults to ``cuda``.

    ``graphs`` (default True) captures each schedule as CUDA graphs on CUDA
    (module docstring); False runs every op from Python, for the
    before/after measurement, the plain-kernel reference executor and the
    mesh schedules.  On the CPU nothing is captured.  The graph cache holds
    at most :attr:`MAX_GRAPHS` schedules and, past the first, at most
    1/:attr:`POOL_SHARE` of the card's memory in their pools (the
    attention naive chain's score temporaries are large, and a search
    captures hundreds of schedules); the least recently used schedule goes
    first (``graph_evictions`` counts them).  ``compile_count`` and
    ``compile_secs`` tally the captures (the reference's compile tallies,
    tenzing_tpu/runtime/executor.py:324-337), under a lock: the prefetch
    pipeline captures on background threads.
    """

    MAX_GRAPHS = 256
    POOL_SHARE = 4

    def __init__(self, platform: Platform, init_bufs: Dict[str, torch.Tensor],
                 device: Optional[str] = None, plain_kernels: bool = False,
                 defer_host_syncs: bool = True, graphs: bool = True):
        self.platform = platform
        self.device = resolve_device(device)
        self.init_bufs = dict(init_bufs)
        for name, t in self.init_bufs.items():
            if t.device.type == "cpu" and self.device.type == "cuda":
                if not t.is_pinned():
                    raise ValueError(
                        f"host buffer {name!r} is not pinned: a non-blocking "
                        "copy from pageable memory is synchronous")
            elif t.device.type != self.device.type:
                raise ValueError(f"buffer {name!r} is on {t.device}, the "
                                 f"executor on {self.device}")
        self.ctx = RunContext(self.device, plain_kernels=plain_kernels,
                              mesh=platform.mesh,
                              defer_host_syncs=defer_host_syncs)
        self.ctx.host_names = {k for k, t in self.init_bufs.items()
                               if t.device.type == "cpu"
                               and self.device.type == "cuda"}
        self._initial = _copy_buffers(self.init_bufs)
        self._prepared: set = set()
        self.graphs = bool(graphs) and self.ctx.on_cuda
        self.graph_bytes = (torch.cuda.get_device_properties(
            self.device).total_memory // self.POOL_SHARE
            if self.graphs else None)
        self._graphs: "OrderedDict[str, graphs.CapturedSchedule]" = \
            OrderedDict()
        self._capturing: Dict[str, threading.Event] = {}
        self._launch_streams: List[Any] = []
        self._lock = threading.Lock()
        self._provision_lock = threading.Lock()
        self.compile_count = 0
        self.compile_secs = 0.0
        self.graph_evictions = 0

    @property
    def host_names(self) -> set:
        """Names of the buffers that live in (pinned) host memory."""
        return set(self.ctx.host_names)

    # -- provisioning -------------------------------------------------------
    def _provision(self, ops: List[OpBase]) -> None:
        """Allocate the scratch the ops declare (on the current stream, before
        any run), then wait for that stream: the lane streams do not order
        themselves after it."""
        shapes = BufferShapes(
            {k: tuple(t.shape) for k, t in self.init_bufs.items()},
            {k: str(t.dtype).replace("torch.", "")
             for k, t in self.init_bufs.items()})
        with self._provision_lock:
            for op in ops:
                declared = (op.scratch_for(shapes)
                            if hasattr(op, "scratch_for") else {})
                for name, (shape, dtype) in declared.items():
                    have = self.ctx.scratch.get(name)
                    if have is not None and tuple(have.shape) == tuple(shape):
                        continue
                    if have is not None:
                        raise ValueError(
                            f"scratch {name!r} declared with shapes "
                            f"{tuple(have.shape)} and {tuple(shape)}")
                    self.ctx.scratch[name] = torch.zeros(
                        shape, dtype=getattr(torch, dtype), device=self.device)
            if self.ctx.on_cuda:
                torch.cuda.current_stream(self.device).synchronize()

    def _run_ops(self, ops: List[OpBase], bufs: Dict[str, torch.Tensor]) -> None:
        ctx = self.ctx
        if bufs is not ctx.bufs:
            # a new buffer dict: the mesh shift maps its peers' anew
            ctx.generation += 1
        ctx.bufs = bufs
        ctx.inflight, ctx.landed = {}, set()
        ctx.pending, ctx._pending_waited = [], set()
        for op in ops:
            ctx.run(op)
        ctx.flush_pending()
        if ctx.inflight:
            raise ValueError(
                "schedule ended with un-awaited transfers into "
                f"{sorted(ctx.inflight)}; every post needs a matching await")

    def _fence(self) -> None:
        """Wait for everything this executor enqueued (runtime/graphs.py
        ``device_sync``: the device, or, while a capture is in progress,
        each of the executor's streams)."""
        if self.ctx.on_cuda:
            graphs.device_sync(self.device,
                               self.ctx.streams() + self._launch_streams)

    # -- capture (the compile stage) ------------------------------------------
    def _launch_stream(self, k: int):
        with self._lock:
            while len(self._launch_streams) <= k:
                self._launch_streams.append(graphs.STREAMS.take(self.device))
            return self._launch_streams[k]

    def _capture(self, order: Sequence) -> "graphs.CapturedSchedule":
        """Capture ``order``'s segments (module docstring).  Raises
        :class:`CaptureError` naming the op a capture failed at."""
        from collections import Counter

        from tenzing_tpu_torch.ops import kernel_lib

        ops = order.vector()
        plan = graphs.plan_segments(ops, self.ctx.host_names,
                                    self.ctx.defer_host_syncs)
        cap = CaptureContext(self.ctx, self.init_bufs)
        cap.prepare(ops, set().union(*(seg.streams for seg in plan)))
        origin = graphs.STREAMS.take(self.device)
        reserved0 = torch.cuda.memory_reserved(self.device)
        segments: List[graphs.CapturedSegment] = []
        launches: Counter = Counter()
        try:
            for k, seg in enumerate(plan):
                cap.begin_segment(origin)
                graph = None
                with kernel_lib.recording_launches() as tally:
                    if seg.streams:
                        graph = self._capture_segment(cap, origin, ops, seg)
                    else:  # host waits only: nothing to capture
                        self._run_segment(cap, ops, seg)
                launches.update(tally)
                waits = cap.segment_waits()
                got = [(kind, what) for kind, what, _ in waits]
                want = [(w.kind, w.what) for w in seg.waits]
                if got != want:
                    raise RuntimeError(
                        f"capture plan disagrees with the executor at segment "
                        f"{k}: planned waits {want}, executed {got}")
                handles = [ev._as_parameter_.value  # the cudaEvent_t
                           for _, _, evs in waits for ev in evs
                           if ev is not None]
                segments.append(graphs.CapturedSegment(
                    graph, graph.raw_cuda_graph_exec() if graph is not None
                    else None,
                    self._launch_stream(k) if graph is not None else None,
                    handles))
        finally:
            cap.release()
            graphs.STREAMS.give([origin])
        events = (list(cap.ext_events.values()) + list(cap.posts.values())
                  + list(cap.tails.values()))
        pool = max(0, torch.cuda.memory_reserved(self.device) - reserved0)
        return graphs.CapturedSchedule(segments, events, launches, pool,
                                       graphs.n_host_syncs(plan))

    @staticmethod
    def _run_segment(cap: "CaptureContext", ops: List[OpBase],
                     seg: "graphs.Segment") -> None:
        """Run one segment's ops through the capture context, naming the op
        that fails, then the flush its waits end with."""
        for p in seg.positions:
            try:
                cap.run(ops[p])
            except CaptureError:
                raise
            except Exception as e:
                raise CaptureError(
                    f"cannot capture op {ops[p].name()!r} (position {p}): "
                    f"{type(e).__name__}: {e}") from e
        if any(w.kind == "flush" for w in seg.waits):
            cap.flush_pending()

    def _capture_segment(self, cap: "CaptureContext", origin, ops, seg):
        """One segment as a CUDA graph, captured from ``origin`` in
        ``thread_local`` mode (a device-wide sync on another thread would
        otherwise invalidate it; graphs.capturing() holds those off)."""
        graph = torch.cuda.CUDAGraph()
        with graphs.capturing(), torch.cuda.stream(origin):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._run_segment(cap, ops, seg)
                cap.end_segment()
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:
                    pass  # the capture was invalidated: the op's error stands
                raise
            try:
                graph.capture_end()
            except Exception as e:
                raise CaptureError(
                    f"capture of ops {seg.positions[0]}-{seg.positions[-1]} "
                    f"({ops[seg.positions[0]].name()!r} .. "
                    f"{ops[seg.positions[-1]].name()!r}) failed: {e}") from e
        return graph

    def _compile(self, order: Sequence, aot: bool) -> bool:
        """Provision ``order`` and, with graphs, capture it into the cache;
        True when this call did the work.  Another thread capturing the
        same schedule is waited for."""
        key = sequence_to_json_str(order)
        with self._lock:
            if key in self._graphs or (not self.graphs
                                       and key in self._prepared):
                if key in self._graphs:
                    self._graphs.move_to_end(key)
                return False
            waiter = self._capturing.get(key)
            mine = waiter is None
            if mine:
                waiter = self._capturing[key] = threading.Event()
        if not mine:
            waiter.wait()
            return False
        from tenzing_tpu_torch.obs.tracer import get_tracer, short_digest

        try:
            t0 = time.perf_counter()
            with get_tracer().span(
                    "executor.compile" if self.graphs else "executor.build",
                    schedule=short_digest(key), n_ops=len(order),
                    aot=aot) as sp:
                self._provision(order.vector())
                entry = self._capture(order) if self.graphs else None
                if entry is not None:
                    sp.set("segments", len(entry.segments))
                    sp.set("graphs", entry.n_graphs)
            secs = time.perf_counter() - t0
            with self._lock:
                if entry is None:
                    self._prepared.add(key)
                    return True
                self.compile_count += 1
                self.compile_secs += secs
                self._graphs[key] = entry
                self._evict()
            return True
        finally:
            with self._lock:
                self._capturing.pop(key).set()

    def _evict(self) -> None:
        """Drop least recently used schedules past the cache's bounds (held
        under the lock; a schedule a caller still replays stays alive
        through its reference until that caller's fence)."""
        from tenzing_tpu_torch.obs.metrics import get_metrics

        def over() -> bool:
            if len(self._graphs) > self.MAX_GRAPHS:
                return True
            total = sum(e.pool_bytes for e in self._graphs.values())
            return (self.graph_bytes is not None and len(self._graphs) > 1
                    and total > self.graph_bytes)

        while over():
            self._graphs.popitem(last=False)
            self.graph_evictions += 1
            get_metrics().counter("executor.graph_evictions").inc()

    def _entry(self, order: Sequence) -> "graphs.CapturedSchedule":
        """``order``'s captured graphs, captured now when missing."""
        key = sequence_to_json_str(order)
        while True:
            self._compile(order, aot=False)
            with self._lock:
                entry = self._graphs.get(key)
            if entry is not None:
                return entry

    # -- ScheduleRunner surface -------------------------------------------
    def is_compiled(self, order: Sequence) -> bool:
        """True once :meth:`precompile` (or a prepare) captured ``order``
        (provisioned it, without graphs)."""
        key = sequence_to_json_str(order)
        return key in self._graphs if self.graphs else key in self._prepared

    def precompile(self, order: Sequence) -> bool:
        """Capture ``order`` as CUDA graphs ahead of its first run (with
        ``graphs`` off, or on the CPU: provision its scratch); returns True
        when this call did the work.  Thread-safe: the prefetch pipeline
        calls it on background threads, and a capture there runs on
        streams of its own and records no event the foreground waits on
        before the graphs replay (the reference's promise that a
        speculative precompile touches no platform state).  An
        ``executor.compile`` span (``executor.build`` without graphs)
        records it, ``aot=True``.  A schedule that cannot be captured
        raises :class:`CaptureError` naming the op."""
        return self._compile(order, aot=True)

    def compile(self, order: Sequence) -> Callable[[], Dict[str, torch.Tensor]]:
        """Precompile ``order`` and return a runner that executes it once
        from the initial state (:meth:`run`)."""
        self._compile(order, aot=False)
        return lambda: self.run(order)

    def prepare(self, order: Sequence) -> Callable[[], None]:
        """Run-once callable on the executor's buffers, fenced."""
        run_n = self.prepare_n(order)
        return lambda: run_n(1)

    def prepare_n(self, order: Sequence) -> Callable[[int], None]:
        """``run_n(n)``: the schedule n times back to back over the
        executor's buffers — its graphs replayed, or every op dispatched on
        the persistent streams without graphs — then one device
        synchronize."""
        if self.graphs:
            entry = self._entry(order)
            ctx = self.ctx

            def replay_n(n: int) -> None:
                entry.replay(n)
                ctx.host_syncs += entry.n_syncs * n
                self._fence()

            return replay_n
        ops = order.vector()
        self._compile(order, aot=False)
        bufs = self.init_bufs

        def run_n(n: int) -> None:
            for _ in range(n):
                check_cancelled()  # fault/cancel.py: a cancelled attempt stops
                self._run_ops(ops, bufs)
            self._fence()

        return run_n

    def _restore(self) -> None:
        """The executor's buffers back to their initial contents (on the
        current stream, then waited for)."""
        for name, t in self.init_bufs.items():
            t.copy_(self._initial[name])
        torch.cuda.current_stream(self.device).synchronize()

    def graph_stats(self) -> Dict[str, int]:
        """The graph cache: schedules held, their graphs and pool bytes, the
        evictions so far."""
        with self._lock:
            held = list(self._graphs.values())
        return {"schedules": len(held),
                "graphs": sum(e.n_graphs for e in held),
                "pool_bytes": sum(e.pool_bytes for e in held),
                "evictions": self.graph_evictions}

    # -- timed execution mode (the attribution profiler's entry point) ------
    def op_stepped(self, order: Sequence) -> List[Tuple[Tuple[int, ...],
                                                        Optional[Callable]]]:
        """The schedule as units run one at a time: ``[(positions, fn)]``
        covering every position in order (the reference's
        ``TraceExecutor.op_stepped``, tenzing_tpu/runtime/executor.py:642).

        * A sync op outside a group is its own unit with ``fn=None``: every
          unit ends with the device idle, so it has nothing to order.
        * A transfer post of the ``.rdma`` engine (``rdma_copy_start``,
          ``rdma_shift_start``) is grouped with every op up to its matching
          await, sync ops included, into one unit (the reference's grouping
          of split posts).  Every other op is a unit of its own.

        The units run from a copy of the initial buffers, in order: each
        ``fn(repeats)`` runs its unit alone against the state the previous
        units left, once to warm and ``repeats`` more times, each time from
        that same state (the buffers the unit writes and the transfers in
        flight are restored before each run), so the state advances by one
        application.  It returns ``(times in µs, timer)``: with
        ``timer == "event"`` (a unit of one device op, on the card) each
        time is a pair of CUDA events recorded on the op's lane stream
        around its dispatch; with ``"host"`` (every other unit, and every
        unit on the CPU) the host wall time of the unit followed by a
        device synchronize.  Mesh platforms are rejected, as in the
        reference."""
        if self.platform.mesh is not None:
            raise RuntimeError(
                "op_stepped: per-op stepped profiling is single-device only "
                "(obs/attrib/xplane.py's profiler capture works on a mesh)")
        self._provision(order.vector())
        ops = order.vector()
        ctx = self.ctx
        ctx.bufs = _copy_buffers(self._initial)
        ctx.generation += 1
        ctx.inflight, ctx.landed = {}, set()
        self._fence()
        steps: List[Tuple[Tuple[int, ...], Optional[Callable]]] = []
        for positions in step_units(ops):
            members = [ops[p] for p in positions]
            if all(_is_sync(op) for op in members):
                steps.append((positions, None))
            else:
                steps.append((positions, self._unit_fn(members)))
        return steps

    def _unit_fn(self, members: List[OpBase]) -> Callable:
        """The runner of one stepped unit (:meth:`op_stepped`)."""
        ctx = self.ctx
        work = [op for op in members if not _is_sync(op)]
        lane = (work[0].lane() if ctx.on_cuda and len(members) == 1
                and isinstance(work[0], BoundDeviceOp) else None)

        def fn(repeats: int) -> Tuple[List[float], str]:
            written = dict.fromkeys(n for op in work for n in op.writes())
            saved = {n: ctx.bufs[n].clone() for n in written if n in ctx.bufs}
            inflight0 = dict(ctx.inflight)
            times: List[float] = []
            for r in range(repeats + 1):
                if r:
                    for n, t in saved.items():
                        ctx.bufs[n].copy_(t)
                    ctx.inflight = dict(inflight0)
                self._fence()
                ctx.pending, ctx._pending_waited = [], set()
                if lane is not None:
                    stream = ctx.lane_stream(lane)
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record(stream)
                    ctx.run(members[0])
                    b.record(stream)
                    b.synchronize()
                    t = a.elapsed_time(b) * 1e3
                else:
                    t0 = time.perf_counter()
                    for op in members:
                        ctx.run(op)
                    ctx.flush_pending()
                    self._fence()
                    t = (time.perf_counter() - t0) * 1e6
                if r:
                    times.append(t)
            return times, "event" if lane is not None else "host"

        return fn

    def run(self, order: Sequence) -> Dict[str, torch.Tensor]:
        """Execute once from the initial buffer contents and return copies of
        the outputs (the integrity gate compares two schedules this way).
        With graphs, the executor's buffers are restored from the initial
        contents, the graphs the measurement replayed run on them (a graph
        is bound to the buffers it was captured on), and the buffers are
        restored again after the copies (an executor sharing them, built
        after this call, starts from the same state); without, the
        schedule runs on fresh copies and the buffers are left alone."""
        if self.graphs:
            entry = self._entry(order)
            self._fence()
            self._restore()
            entry.replay(1)
            self.ctx.host_syncs += entry.n_syncs
            self._fence()
            out = _copy_buffers(self.init_bufs)
            self._restore()
            return out
        self._compile(order, aot=False)
        bufs = _copy_buffers(self._initial)
        self._fence()
        self._run_ops(order.vector(), bufs)
        self._fence()
        return bufs
