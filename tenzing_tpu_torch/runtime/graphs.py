"""CUDA-graph capture of a schedule: the plan, the device-sync guard, and
the captured schedule's replay.

Counterpart of the reference's compile stage
(``TraceExecutor.precompile``, tenzing_tpu/runtime/executor.py:601-640),
which turns a schedule into one XLA program.  On CUDA the schedule's
counterpart of a program is a set of CUDA graphs: the executor captures the
device work between the points where it must block the host, and a run
replays those graphs with the host waits between them.

**The capture plan** (:func:`plan_segments`, no device needed) splits a
schedule's op list into *segments*.  A segment ends where the executor
blocks the host (runtime/executor.py ``RunContext``):

* an ``AwaitTransfer`` / ``MultiAwait`` on a device-space buffer (the host
  waits on the transfer's event);
* a flush of the pending host syncs, before a host op that reads or writes
  a buffer, or before an ``EventRecord`` that re-records a pending event
  (:func:`flushes_pending`, the one copy of the rule, which
  ``RunContext.run`` calls too);
* a ``LaneSync`` (the host waits for the lane);
* an ``EventSync`` when host syncs are not deferred (``defer_host_syncs``
  off); a deferred one only adds its event to the pending set and does not
  split a segment;
* the end of the schedule (the pending events are flushed).

Each segment carries its ops' positions, the streams its ops touch (lanes
and transfer channels, :func:`op_streams`) and the host waits that follow
it, each naming its op position and what it waits for.  Every op lands in
exactly one segment.

**Dependencies between graphs.**  A graph launch completes as a whole, so a
host wait on one event must not wait for the rest of its graph, and a later
graph must wait only for what the schedule orders it after.  Each segment
is captured from an origin stream that forks to every lane and channel
stream it touches and joins them at the end; inside the capture

* every ``EventRecord`` also records an *external* event
  (``torch.cuda.Event(external=True)``: an event record node, visible
  outside the graph), and a transfer post records one after its copy;
* at the end of the segment each touched stream records an external *tail*
  event;
* the first use of a stream in a segment waits (an external event wait
  node) on that stream's tail from the segment before that touched it, and
  a wait on a schedule event recorded in an earlier segment waits on its
  external event.

A replay launches segment k's graph on a launch stream of its own (so it is
not ordered after graph k-1 as a whole), then blocks the host on exactly the
external events the plan's waits name.  An event wait node takes the
event's last record at launch, as ``cudaStreamWaitEvent`` does, so the
order between graphs is the schedule's stream order and event order and
nothing more.

**The device-sync guard.**  ``cudaDeviceSynchronize`` fails while any
thread captures (checked on the H100 with ``capture_error_mode=
"thread_local"``), and the prefetch pipeline (bench/pipeline.py) captures
on background threads while the foreground measures.  Every device-wide
sync of the measurement path goes through :func:`device_sync`: with no
capture in progress it synchronizes the device (and holds off new captures
meanwhile); during one it synchronizes the streams the caller names.

**Graphs freed during a capture.**  Destroying a CUDA graph on a thread
that is capturing is not permitted (``cudaGraphExecDestroy`` fails with
"operation not permitted when stream is capturing") and invalidates that
thread's capture; a later allocator call then fails inside a destructor
and aborts the process.  The garbage collector runs wherever Python
allocates, so an unreachable executor's graphs can be freed on a prefetch
worker mid-capture (seen on the H100 in a driver run right after another).
A :class:`CapturedSchedule` finalized on a capturing thread therefore
hands its graphs and events to :data:`_DEFERRED`, and the thread releases
them when its last capture ends.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, FrozenSet, Iterable, List, Optional, Tuple

from tenzing_tpu_torch.core.operation import BoundDeviceOp, OpBase, unbound
from tenzing_tpu_torch.core.sync_ops import (
    EventRecord,
    EventSync,
    LaneSync,
    LaneWait,
    SyncOp,
    WaitEvent,
)

# -- the plan ------------------------------------------------------------------

StreamKey = Tuple[str, Any]  # ("lane", lane id) or ("channel", channel name)


@dataclass(frozen=True)
class HostWait:
    """One host block at a segment's end.  ``kind``: ``"flush"`` (the
    pending events ``what``, before the op at ``at``), ``"event"`` (a
    blocking ``EventSync`` of event ``what[0]``), ``"transfer"`` (the
    transfer into buffer ``what[0]``) or ``"lane"`` (lane ``what[0]``).
    ``at`` is the position of the op that waits (a flush: of the op it
    precedes; the end of the schedule: ``len(ops)``).  Each counts one
    host sync, as ``RunContext.host_syncs`` does."""

    kind: str
    at: int
    what: Tuple


@dataclass(frozen=True)
class Segment:
    """The ops at ``positions`` (consecutive), the streams they touch, and
    the host waits after them, in order."""

    positions: Tuple[int, ...]
    streams: FrozenSet[StreamKey]
    waits: Tuple[HostWait, ...]


def flushes_pending(op: OpBase, pending_ids) -> bool:
    """True when the host must wait on the pending events before ``op``
    runs (``pending_ids`` non-empty): a host op that reads or writes a
    buffer (a transfer post or await among them), or an ``EventRecord``
    that re-records a pending event.  A device op's lanes wait on the
    pending events on the device instead."""
    if not pending_ids or isinstance(op, BoundDeviceOp):
        return False
    if isinstance(op, EventRecord):
        return op.event().id in pending_ids
    return not isinstance(op, SyncOp) and bool(op.reads() or op.writes())


def op_streams(op: OpBase) -> FrozenSet[StreamKey]:
    """The streams ``op`` enqueues work on or orders: a device op's lanes,
    an event record's or wait's lane, both lanes of a ``LaneWait``, a
    transfer post's channel.  Host waits (``LaneSync``, ``EventSync``,
    awaits) and host-only ops touch none."""
    if isinstance(op, BoundDeviceOp):
        return frozenset(("lane", lane.id) for lane in op.lanes())
    if isinstance(op, (EventRecord, WaitEvent)):
        return frozenset({("lane", op.lane().id)})
    if isinstance(op, LaneWait):
        return frozenset({("lane", op.waiter().id), ("lane", op.waitee().id)})
    channel = getattr(unbound(op), "channel", None)
    if channel is not None and getattr(unbound(op), "DST_SPACE", None):
        return frozenset({("channel", channel())})
    return frozenset()


def track_landed(op: OpBase, landed: set) -> None:
    """Keep ``landed``, the buffers a device op wrote since their last
    post, up to date after ``op``: an await of one of them, with nothing in
    flight, is a no-op (runtime/executor.py's module docstring)."""
    if isinstance(op, BoundDeviceOp):
        landed.update(op.writes())
    elif getattr(unbound(op), "DST_SPACE", None) == "device":
        landed.discard(op.dst())


def plan_segments(ops: List[OpBase], host_names: Iterable[str] = (),
                  defer_host_syncs: bool = True) -> List[Segment]:
    """Split ``ops`` into capture segments (module docstring).
    ``host_names`` are the buffers in host memory (an await on one does not
    block); ``defer_host_syncs`` as the executor's.  Raises, as the
    executor does, on an await with nothing in flight and on transfers
    left un-awaited at the end."""
    host = set(host_names)
    segments: List[Segment] = []
    pending: List[int] = []
    inflight: set = set()
    landed: set = set()
    cur: List[int] = []
    streams: set = set()

    def close(waits: Tuple[HostWait, ...]) -> None:
        nonlocal cur, streams
        if not cur and segments:  # a wait right after another boundary
            last = segments[-1]
            segments[-1] = Segment(last.positions, last.streams,
                                   last.waits + waits)
        elif cur or waits:
            segments.append(Segment(tuple(cur), frozenset(streams), waits))
        cur, streams = [], set()

    for p, op in enumerate(ops):
        if flushes_pending(op, pending):
            close((HostWait("flush", p, tuple(pending)),))
            pending = []
        cur.append(p)
        streams |= op_streams(op)
        kind = getattr(op, "KIND", "")
        if isinstance(op, EventSync):
            if defer_host_syncs:
                if op.event().id not in pending:
                    pending.append(op.event().id)
            else:
                close((HostWait("event", p, (op.event().id,)),))
        elif isinstance(op, LaneSync):
            close((HostWait("lane", p, (op.lane().id,)),))
        elif kind in ("await_transfer", "multi_await"):
            bufs = [op.buf()] if kind == "await_transfer" else op.bufs()
            waits = []
            for b in bufs:
                if b in host or (b not in inflight and b in landed):
                    continue
                if b not in inflight:
                    raise RuntimeError(f"await on {b!r}: no transfer in "
                                       "flight")
                inflight.discard(b)
                waits.append(HostWait("transfer", p, (b,)))
            if waits:
                close(tuple(waits))
        elif getattr(unbound(op), "DST_SPACE", None) == "device":
            dst = op.dst()
            if dst in inflight:
                raise RuntimeError(f"{op.name()}: a transfer into {dst!r} "
                                   "is already in flight")
            inflight.add(dst)
        track_landed(op, landed)
    close((HostWait("flush", len(ops), tuple(pending)),) if pending else ())
    if inflight:
        raise ValueError("schedule ended with un-awaited transfers into "
                         f"{sorted(inflight)}; every post needs a matching "
                         "await")
    return segments


def n_host_syncs(segments: List[Segment]) -> int:
    """The host blocks one run of the planned schedule executes."""
    return sum(len(s.waits) for s in segments)


# -- the device-sync guard -------------------------------------------------------


# the graphs and events of schedules finalized on a capturing thread,
# released when that thread's last capture ends (module docstring)
_DEFERRED: List[Any] = []
_THREAD = threading.local()


def capturing_here() -> bool:
    """True while the calling thread is inside :func:`capturing`."""
    return getattr(_THREAD, "depth", 0) > 0


def _release_deferred() -> None:
    """Drop the deferred graphs and events, one at a time (``pop`` is
    atomic, so two threads never release the same one)."""
    while _DEFERRED:
        try:
            _DEFERRED.pop()
        except IndexError:
            break


class _SyncGuard:
    """Keeps device-wide syncs and captures apart (module docstring)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._captures = 0
        self._syncing = 0

    @contextmanager
    def capturing(self):
        with self._cv:
            while self._syncing:
                self._cv.wait()
            self._captures += 1
        _THREAD.depth = getattr(_THREAD, "depth", 0) + 1
        try:
            yield
        finally:
            _THREAD.depth -= 1
            with self._cv:
                self._captures -= 1
                self._cv.notify_all()
            if _THREAD.depth == 0:
                _release_deferred()

    def device_sync(self, device, streams: Iterable = ()) -> None:
        import torch

        with self._cv:
            free = self._captures == 0
            if free:
                self._syncing += 1
        if free:
            try:
                torch.cuda.synchronize(device)
            finally:
                with self._cv:
                    self._syncing -= 1
                    self._cv.notify_all()
            return
        for s in streams:
            s.synchronize()
        torch.cuda.current_stream(device).synchronize()


_GUARD = _SyncGuard()


def capturing():
    """Held around a capture: device-wide syncs wait for none, and fall
    back to stream syncs while one is held."""
    return _GUARD.capturing()


def device_sync(device, streams: Iterable = ()) -> None:
    """Wait for the device: ``torch.cuda.synchronize`` when no capture is
    in progress, else a sync of each of ``streams`` and of the current
    stream (module docstring)."""
    _GUARD.device_sync(device, streams)


# -- the CUDA runtime calls of the replay loop -----------------------------------

_CUDART: Optional[ctypes.CDLL] = None


def cudart() -> ctypes.CDLL:
    """The CUDA runtime PyTorch loaded (its soname; loading it again returns
    the same library), for the calls the replay loop makes without
    PyTorch's per-call overhead."""
    global _CUDART
    if _CUDART is None:
        import torch

        major = (torch.version.cuda or "12").split(".")[0]
        lib = ctypes.CDLL(f"libcudart.so.{major}")
        for name, args in (
                ("cudaStreamCreateWithFlags", [ctypes.c_void_p, ctypes.c_uint]),
                ("cudaGraphLaunch", [ctypes.c_void_p, ctypes.c_void_p]),
                ("cudaEventSynchronize", [ctypes.c_void_p]),
                ("cudaGetErrorString", [ctypes.c_int])):
            getattr(lib, name).argtypes = args
        lib.cudaGetErrorString.restype = ctypes.c_char_p
        _CUDART = lib
    return _CUDART


def _check(call: str, err: int) -> None:
    if err:
        why = cudart().cudaGetErrorString(err).decode()
        raise RuntimeError(f"{call}: CUDA error {err} ({why})")


def new_stream(device):
    """A non-blocking CUDA stream of its own (``cudaStreamCreateWithFlags``),
    as a ``torch.cuda.ExternalStream``.  ``torch.cuda.Stream()`` hands out
    the 32 streams of PyTorch's pool in turn, so a capture stream taken
    from it could be a lane stream the foreground is running on."""
    import torch

    with torch.cuda.device(device):
        handle = ctypes.c_void_p()
        _check("cudaStreamCreateWithFlags",
               cudart().cudaStreamCreateWithFlags(ctypes.byref(handle), 1))
    return torch.cuda.ExternalStream(handle.value, device=device)


class StreamPool:
    """Streams made by :func:`new_stream`, reused: a capture takes what it
    needs and gives them back when it ends (CUDA streams are never
    destroyed here: a process makes a few dozen)."""

    def __init__(self):
        self._free: List[Any] = []
        self._lock = threading.Lock()

    def take(self, device):
        with self._lock:
            if self._free:
                return self._free.pop()
        return new_stream(device)

    def give(self, streams: Iterable) -> None:
        with self._lock:
            self._free.extend(streams)


STREAMS = StreamPool()

# (thread, stream) pairs whose cuBLAS handle and workspace exist
_WARMED: set = set()


def warm_stream(stream) -> None:
    """Create this thread's cuBLAS / cuBLASLt handles and their workspaces
    for ``stream`` before a capture uses it: PyTorch creates them at a
    thread's first matmul on a stream, and ``cublasCreate`` fails under
    capture (``CUBLAS_STATUS_NOT_INITIALIZED``, seen on the H100).  Tiny
    f32 and bf16 products on ``stream``, once per (thread, stream)."""
    import torch

    key = (threading.get_ident(), stream.cuda_stream)
    if key in _WARMED:
        return
    with torch.cuda.stream(stream):
        torch.cuda.current_blas_handle()
        dev = stream.device
        for dt in (torch.float32, torch.bfloat16):
            a = torch.ones(16, 16, dtype=dt, device=dev)
            torch.addmm(a[0], a, a)
            torch.bmm(a[None], a[None])
            torch.nn.functional.linear(a, a, a[0])
    stream.synchronize()
    _WARMED.add(key)


# -- the captured schedule -------------------------------------------------------


@dataclass
class CapturedSegment:
    """One segment as replayed: its graph (None: no device work), the
    stream it launches on, and the external events the host then waits on
    (one handle per host wait; None where a lane never ran)."""

    graph: Any
    exec_handle: Optional[int]
    stream: Any
    waits: List[Optional[Any]]


class CapturedSchedule:
    """A schedule's graphs, the external events they record and wait on
    (kept alive here: the graphs' event nodes name them), and the kernel
    launches one run holds (ops/kernel_lib.py ``LaunchCounts``), added on
    every replay so the launch counters count replays as eager runs."""

    def __init__(self, segments: List[CapturedSegment], events: List[Any],
                 launches: Counter, pool_bytes: int, n_syncs: int):
        self.segments = segments
        self.events = events
        self.launches = launches
        self.pool_bytes = pool_bytes
        self.n_syncs = n_syncs

    def __del__(self):
        # on a capturing thread the graphs may not be destroyed: they wait
        # for the end of its capture (module docstring)
        if capturing_here():
            _DEFERRED.append((self.segments, self.events))

    @property
    def n_graphs(self) -> int:
        return sum(1 for s in self.segments if s.graph is not None)

    def replay(self, n: int) -> None:
        """Run the schedule ``n`` times: launch each segment's graph, then
        block the host on its waits' events (no fence at the end).  Each
        segment's launch first checks the thread's cancel token
        (fault/cancel.py): an attempt the watchdog abandoned launches
        nothing more."""
        from tenzing_tpu_torch.fault.cancel import check
        from tenzing_tpu_torch.ops.kernel_lib import add_launches

        rt = cudart()
        launch, sync = rt.cudaGraphLaunch, rt.cudaEventSynchronize
        plan = [(s.exec_handle, s.stream.cuda_stream if s.graph is not None
                 else None, [w for w in s.waits if w is not None])
                for s in self.segments]
        done = 0
        try:
            for done in range(n):
                for handle, stream, waits in plan:
                    check()
                    if handle is not None:
                        _check("cudaGraphLaunch", launch(handle, stream))
                    for ev in waits:
                        _check("cudaEventSynchronize", sync(ev))
            done = n
        finally:
            add_launches(self.launches, done)


__all__ = [
    "HostWait", "Segment", "flushes_pending", "op_streams", "plan_segments",
    "n_host_syncs", "capturing", "capturing_here", "device_sync", "cudart",
    "new_stream",
    "StreamPool", "STREAMS", "CapturedSegment", "CapturedSchedule",
]
