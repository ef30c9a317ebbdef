"""Synchronization ops: the vocabulary the scheduler inserts to make cross-lane
orders legal.

Counterpart of ``tenzing_tpu/core/sync_ops.py`` (reference
``include/tenzing/cuda/ops_cuda.hpp``: CudaEventRecord -> :class:`EventRecord`,
CudaStreamWaitEvent -> :class:`WaitEvent`, CudaEventSync -> :class:`EventSync`,
StreamSync -> :class:`LaneSync`, StreamWait -> :class:`LaneWait`).

On CUDA these are the original tenzing's calls again (runtime/executor.py):

* ``EventRecord(lane, e)``    : ``event.record(lane stream)``
* ``WaitEvent(lane, e)``      : ``lane stream.wait_event(event)``
* ``EventSync(e)``            : ``event.synchronize()`` (blocks the host)
* ``LaneSync(lane)``          : ``lane stream.synchronize()`` (blocks the host)
* ``LaneWait(waiter, waitee)``: ``waiter stream.wait_stream(waitee stream)``

Sync ops compare equal per *kind* regardless of lane/event ids (reference
ops_cuda.hpp:15-20): the search must not distinguish schedules that differ only in
which fresh event id a sync uses — resource renaming is handled by the bijection
equivalence (core/sequence.py, core/resources.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from tenzing_tpu_torch.core.operation import BoundOp, register_kind
from tenzing_tpu_torch.core.resources import Event, Lane


class SyncOp(BoundOp):
    """Base for scheduler-inserted synchronization ops."""

    def is_sync(self) -> bool:
        return True

    def eq_key(self) -> Tuple:
        return ("sync", self.KIND)


@register_kind("event_record")
class EventRecord(SyncOp):
    """Record lane progress into an event (reference CudaEventRecord)."""

    def __init__(self, lane: Lane, event: Event):
        super().__init__(f"er-{lane.id}-{event.id}")
        self._lane = lane
        self._event = event

    def lane(self) -> Lane:
        return self._lane

    def event(self) -> Event:
        return self._event

    def lanes(self) -> List[Lane]:
        return [self._lane]

    def events(self) -> List[Event]:
        return [self._event]

    def desc(self) -> str:
        return f"EventRecord({self._lane!r},{self._event!r})"

    def execute(self, ctx) -> None:
        ctx.record_event(self._lane, self._event)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "lane": self._lane.id, "event": self._event.id}

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "EventRecord":
        return cls(Lane(j["lane"]), Event(j["event"]))


@register_kind("wait_event")
class WaitEvent(SyncOp):
    """Make a lane wait for an event (reference CudaStreamWaitEvent)."""

    def __init__(self, lane: Lane, event: Event):
        super().__init__(f"we-{lane.id}-{event.id}")
        self._lane = lane
        self._event = event

    def lane(self) -> Lane:
        return self._lane

    def event(self) -> Event:
        return self._event

    def lanes(self) -> List[Lane]:
        return [self._lane]

    def events(self) -> List[Event]:
        return [self._event]

    def desc(self) -> str:
        return f"WaitEvent({self._lane!r},{self._event!r})"

    def execute(self, ctx) -> None:
        ctx.wait_event(self._lane, self._event)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "lane": self._lane.id, "event": self._event.id}

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "WaitEvent":
        return cls(Lane(j["lane"]), Event(j["event"]))


@register_kind("event_sync")
class EventSync(SyncOp):
    """Make the host chain wait for an event (reference CudaEventSync)."""

    def __init__(self, event: Event):
        super().__init__(f"es-{event.id}")
        self._event = event

    def event(self) -> Event:
        return self._event

    def events(self) -> List[Event]:
        return [self._event]

    def desc(self) -> str:
        return f"EventSync({self._event!r})"

    def execute(self, ctx) -> None:
        ctx.sync_event_host(self._event)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "event": self._event.id}

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "EventSync":
        return cls(Event(j["event"]))


@register_kind("lane_sync")
class LaneSync(SyncOp):
    """Make the host chain wait for a whole lane (reference StreamSync)."""

    def __init__(self, lane: Lane):
        super().__init__(f"ls-{lane.id}")
        self._lane = lane

    def lane(self) -> Lane:
        return self._lane

    def lanes(self) -> List[Lane]:
        return [self._lane]

    def desc(self) -> str:
        return f"LaneSync({self._lane!r})"

    def execute(self, ctx) -> None:
        ctx.sync_lane_host(self._lane)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "lane": self._lane.id}

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "LaneSync":
        return cls(Lane(j["lane"]))


@register_kind("lane_wait")
class LaneWait(SyncOp):
    """Make one lane wait for another (reference StreamWait)."""

    def __init__(self, waiter: Lane, waitee: Lane):
        super().__init__(f"lw-{waiter.id}-{waitee.id}")
        self._waiter = waiter
        self._waitee = waitee

    def waiter(self) -> Lane:
        return self._waiter

    def waitee(self) -> Lane:
        return self._waitee

    def lanes(self) -> List[Lane]:
        return [self._waiter, self._waitee]

    def desc(self) -> str:
        return f"LaneWait({self._waiter!r}<-{self._waitee!r})"

    def execute(self, ctx) -> None:
        ctx.wait_lane(self._waiter, self._waitee)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "waiter": self._waiter.id, "waitee": self._waitee.id}

    @classmethod
    def from_json(cls, j: Dict[str, Any]) -> "LaneWait":
        return cls(Lane(j["waiter"]), Lane(j["waitee"]))
