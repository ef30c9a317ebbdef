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

``prepare_n`` runs the schedule n times back to back on the persistent
streams and synchronizes the device once; there is no CUDA-graph capture,
since EventSync, LaneSync and AwaitTransfer block the host.

With ``device="cpu"`` — only when asked, as the tests do — sync ops are no-ops
and ops run in sequence order, so outputs stay checkable without a card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from tenzing_tpu_torch.core.operation import BoundDeviceOp, OpBase
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.resources import Event, Lane
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.serdes import sequence_to_json_str


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


class RunContext:
    """What ops see while a schedule runs: the buffers, the scratch, the lane
    and transfer streams, the events, and the in-flight transfers.  Owned by
    one :class:`StreamExecutor`; the streams and events live as long as it."""

    def __init__(self, device: torch.device, plain_kernels: bool = False):
        self.device = device
        self.on_cuda = device.type == "cuda"
        # True: every kernel wrapper is replaced by its plain PyTorch version
        # (the reference run that chip_smoke.py compares the kernels with)
        self.plain_kernels = plain_kernels
        self.bufs: Dict[str, torch.Tensor] = {}
        self.scratch: Dict[str, torch.Tensor] = {}
        self.host_names: set = set()
        self.inflight: Dict[str, Any] = {}
        self._lanes: Dict[int, Any] = {}
        self._events: Dict[int, Any] = {}
        self._channels: Dict[str, Any] = {}
        self._post_events: Dict[str, Any] = {}

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

    # -- op hooks ---------------------------------------------------------
    def run_default(self, op: OpBase) -> None:
        if self.on_cuda and isinstance(op, BoundDeviceOp):
            with torch.cuda.stream(self.lane_stream(op.lane())):
                op.apply(self.bufs, self)
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

    def await_transfer(self, buf: str) -> None:
        """Block the host until the transfer into ``buf`` has landed.  A
        host-space buffer has nothing to await (the reference's
        AwaitTransfer skips host-space buffers too)."""
        if buf in self.host_names:
            return
        if buf not in self.inflight:
            raise RuntimeError(f"await on {buf!r}: no transfer in flight")
        ev = self.inflight.pop(buf)
        if self.on_cuda:
            ev.synchronize()

    def record_event(self, lane: Lane, event: Event) -> None:
        if self.on_cuda:
            self.event(event).record(self.lane_stream(lane))

    def wait_event(self, lane: Lane, event: Event) -> None:
        if self.on_cuda:
            self.lane_stream(lane).wait_event(self.event(event))

    def sync_event_host(self, event: Event) -> None:
        if self.on_cuda:
            self.event(event).synchronize()

    def sync_lane_host(self, lane: Lane) -> None:
        if self.on_cuda:
            self.lane_stream(lane).synchronize()

    def wait_lane(self, waiter: Lane, waitee: Lane) -> None:
        if self.on_cuda:
            self.lane_stream(waiter).wait_stream(self.lane_stream(waitee))


class StreamExecutor:
    """Runs schedules on CUDA streams (the ``ScheduleRunner`` the benchmarker
    calls: ``prepare``, ``prepare_n``, ``run``, ``compile``, ``precompile``,
    ``is_compiled``).

    ``init_bufs`` are the schedule's buffers, already placed
    (:func:`buffers_from_numpy`); timed runs update them in place.  A copy of
    their initial contents is kept so :meth:`run` can start every validation
    run from the same state.  ``device`` defaults to ``cuda``.
    """

    def __init__(self, platform: Platform, init_bufs: Dict[str, torch.Tensor],
                 device: Optional[str] = None, plain_kernels: bool = False):
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
        self.ctx = RunContext(self.device, plain_kernels=plain_kernels)
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
        for op in ops:
            for name, (shape, dtype) in getattr(op, "scratch", dict)().items():
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
        ctx.bufs = bufs
        ctx.inflight = {}
        for op in ops:
            op.execute(ctx)
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
