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
the await runs ``rdma_shift_wait`` on the same stream and blocks the host
on an event after it.  An event on the post alone would not do: the bytes
that land in ``dst`` come from the neighbour's kernel, so only this rank's
arrival flag shows they landed.  On an axis of size 1 the shift is the
loopback copy, posted like any transfer.  With ``device="cpu"``, or under
``plain_kernels``, the shift is its plain version over the axis group.

``prepare_n`` runs the schedule n times back to back on the persistent
streams and synchronizes the device once; there is no CUDA-graph capture,
since LaneSync, AwaitTransfer and the host ops' pending syncs block the host.

With ``device="cpu"`` — only when asked, as the tests do — sync ops are no-ops
and ops run in sequence order, so outputs stay checkable without a card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from tenzing_tpu_torch.core.operation import BoundDeviceOp, OpBase, unbound
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.resources import Event, Lane
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.serdes import sequence_to_json_str
from tenzing_tpu_torch.core.sync_ops import EventRecord, SyncOp
from tenzing_tpu_torch.ops.comm_ops import Done


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
        """Launch ``rdma_shift_wait`` on the post's stream and block the host
        until it returns; a kernel timeout raises with its reason."""
        from tenzing_tpu_torch.ops import rdma

        with torch.cuda.stream(self.stream):
            rdma.rdma_shift_wait(self.peers.flags, self.cid, self.epoch,
                                 self.peers.err)
        event.record(self.stream)
        try:
            event.synchronize()
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
            elif isinstance(op, EventRecord):
                if any(e.id == op.event().id for e in self.pending):
                    self.flush_pending()  # re-recording a pending event
            elif not isinstance(op, SyncOp) and (op.reads() or op.writes()):
                self.flush_pending()
        op.execute(self)

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
        """Post ``op``'s collective (``op.launch(bufs, group)``, which returns
        the ``async_op`` work) over the process group of its mesh axis; on
        CUDA under the channel's transfer stream, which NCCL's stream waits
        on at the call.  The work is in flight until its await."""
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
                op.launch(self.bufs, group, size), None)
            return
        stream = self.channel_stream(op.channel())
        with torch.cuda.stream(stream):
            work = op.launch(self.bufs, group, size)
        self.inflight[dst] = _Collective(work, stream)

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
    """

    def __init__(self, platform: Platform, init_bufs: Dict[str, torch.Tensor],
                 device: Optional[str] = None, plain_kernels: bool = False,
                 defer_host_syncs: bool = True):
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

    @property
    def host_names(self) -> set:
        """Names of the buffers that live in (pinned) host memory."""
        return set(self.ctx.host_names)

    # -- provisioning -------------------------------------------------------
    def _provision(self, ops: List[OpBase]) -> None:
        """Allocate the scratch the ops declare (on the current stream, before
        any run), then wait for the device: the lane streams do not order
        themselves after the default stream."""
        shapes = {k: tuple(t.shape) for k, t in self.init_bufs.items()}
        for op in ops:
            declared = (op.scratch_for(shapes) if hasattr(op, "scratch_for")
                        else {})
            for name, (shape, dtype) in declared.items():
                have = self.ctx.scratch.get(name)
                if have is not None and tuple(have.shape) == tuple(shape):
                    continue
                if have is not None:
                    raise ValueError(f"scratch {name!r} declared with shapes "
                                     f"{tuple(have.shape)} and {tuple(shape)}")
                self.ctx.scratch[name] = torch.zeros(
                    shape, dtype=getattr(torch, dtype), device=self.device)
        if self.ctx.on_cuda:
            torch.cuda.synchronize(self.device)

    def _run_ops(self, ops: List[OpBase], bufs: Dict[str, torch.Tensor]) -> None:
        ctx = self.ctx
        if bufs is not ctx.bufs:
            # a new buffer dict: the mesh shift maps its peers' anew
            ctx.generation += 1
        ctx.bufs = bufs
        ctx.inflight = {}
        ctx.pending, ctx._pending_waited = [], set()
        for op in ops:
            ctx.run(op)
        ctx.flush_pending()
        if ctx.inflight:
            raise ValueError(
                "schedule ended with un-awaited transfers into "
                f"{sorted(ctx.inflight)}; every post needs a matching await")

    def _fence(self) -> None:
        if self.ctx.on_cuda:
            torch.cuda.synchronize(self.device)

    # -- ScheduleRunner surface -------------------------------------------
    def is_compiled(self, order: Sequence) -> bool:
        """True once :meth:`precompile` (or a prepare) provisioned ``order``."""
        return sequence_to_json_str(order) in self._prepared

    def precompile(self, order: Sequence) -> bool:
        """Provision ``order``'s scratch, streams and events ahead of its first
        run; returns True when this call did the work.  There is nothing to
        compile: the kernels are built once per process (ops/kernel_lib.py)."""
        key = sequence_to_json_str(order)
        if key in self._prepared:
            return False
        self._provision(order.vector())
        self._prepared.add(key)
        return True

    def compile(self, order: Sequence) -> Callable[[], Dict[str, torch.Tensor]]:
        """No compile step exists on CUDA: provisions ``order`` and returns a
        runner that executes it once from the initial state (:meth:`run`)."""
        self.precompile(order)
        return lambda: self.run(order)

    def prepare(self, order: Sequence) -> Callable[[], None]:
        """Run-once callable on the executor's buffers, fenced."""
        run_n = self.prepare_n(order)
        return lambda: run_n(1)

    def prepare_n(self, order: Sequence) -> Callable[[int], None]:
        """``run_n(n)``: the schedule n times back to back on the persistent
        streams over the executor's buffers, then one device synchronize."""
        ops = order.vector()
        self.precompile(order)
        bufs = self.init_bufs

        def run_n(n: int) -> None:
            for _ in range(n):
                self._run_ops(ops, bufs)
            self._fence()

        return run_n

    def run(self, order: Sequence) -> Dict[str, torch.Tensor]:
        """Execute once from the initial buffer contents, on fresh copies, and
        return them (the integrity gate compares two schedules this way)."""
        self.precompile(order)
        bufs = _copy_buffers(self._initial)
        self._fence()
        self._run_ops(order.vector(), bufs)
        self._fence()
        return bufs
