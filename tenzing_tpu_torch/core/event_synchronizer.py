"""The correctness oracle: which sync ops must precede an op for a schedule to be
legal.

Counterpart of ``tenzing_tpu/core/event_synchronizer.py`` (reference
``include/tenzing/event_synchronizer.hpp``).  The case analysis over predecessor
x op kind (event_synchronizer.hpp:183-242), with HOST the host thread and lanes
CUDA streams:

===========  ===========  ================================================
pred         op           required ordering
===========  ===========  ================================================
host         host         free (host program order)
host         device lane  free (the host launches in sequence order)
device lane  same lane    free (stream order)
device lane  other lane   EventRecord(pred.lane, e) ... WaitEvent(op.lane, e)
device lane  host         EventRecord(pred.lane, e) ... EventSync(e)
===========  ===========  ================================================

``is_synced`` checks the executed sequence for the required record/wait pairs;
``make_syncs`` emits the *next* missing sync op for each unsynced predecessor —
first an EventRecord on a fresh event, then the matching WaitEvent/EventSync —
deduplicating identical syncs (event_synchronizer.hpp:246-329).

On CUDA an under-synchronized schedule is a real race, so a schedule only
becomes executable through these checks, and the driver's integrity gate
re-checks the winner with the independent verifier (verify/soundness.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence as Seq

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import BoundDeviceOp, BoundOp, OpBase
from tenzing_tpu_torch.core.resources import Event, Lane
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.sync_ops import EventRecord, EventSync, LaneSync, SyncOp, WaitEvent


def _index_of(seq: Sequence, op: OpBase) -> Optional[int]:
    for i, o in enumerate(seq):
        if o == op:
            return i
    return None


def _sync_attr_eq(a: SyncOp, b: SyncOp) -> bool:
    """Attribute-level equality (sync-op ``eq`` is kind-only by design)."""
    return type(a) is type(b) and a.to_json() == b.to_json()


class EventSynchronizer:
    """All-static oracle (reference EventSynchronizer)."""

    # -- is_synced ---------------------------------------------------------
    @staticmethod
    def _find_record_after(seq: Sequence, pos: int, lane: Lane) -> Optional[EventRecord]:
        for i in range(pos + 1, len(seq)):
            op = seq[i]
            if isinstance(op, EventRecord) and op.lane() == lane:
                return op
        return None

    @staticmethod
    def _device_then_device_synced(seq: Sequence, pred: BoundDeviceOp, op: BoundDeviceOp) -> bool:
        """reference is_synced_gpu_then_gpu, event_synchronizer.hpp:29-65."""
        if pred.lane() == op.lane():
            return True
        pi = _index_of(seq, pred)
        assert pi is not None, f"pred {pred!r} not executed"
        for i in range(pi + 1, len(seq)):
            rec = seq[i]
            if isinstance(rec, EventRecord) and rec.lane() == pred.lane():
                for j in range(i + 1, len(seq)):
                    w = seq[j]
                    if (
                        isinstance(w, WaitEvent)
                        and w.lane() == op.lane()
                        and w.event() == rec.event()
                    ):
                        return True
        return False

    @staticmethod
    def _device_then_host_synced(seq: Sequence, pred: BoundDeviceOp) -> bool:
        """reference is_synced GPU-then-CPU case, event_synchronizer.cpp:3-27."""
        pi = _index_of(seq, pred)
        assert pi is not None, f"pred {pred!r} not executed"
        for i in range(pi + 1, len(seq)):
            rec = seq[i]
            if isinstance(rec, LaneSync) and rec.lane() == pred.lane():
                return True
            if isinstance(rec, EventRecord) and rec.lane() == pred.lane():
                for j in range(i + 1, len(seq)):
                    s = seq[j]
                    if isinstance(s, EventSync) and s.event() == rec.event():
                        return True
        return False

    @staticmethod
    def is_synced(graph: Graph, seq: Sequence, op: BoundOp) -> bool:
        """True iff every graph predecessor of ``op`` is provably ordered before
        it (reference event_synchronizer.hpp:183-242)."""
        if isinstance(op, SyncOp) or op not in graph:
            return True  # scheduler-inserted syncs are freely placeable
        for pred in graph.preds(op):
            if not isinstance(pred, BoundDeviceOp):
                continue  # host -> anything is free
            if isinstance(op, BoundDeviceOp):
                if not EventSynchronizer._device_then_device_synced(seq, pred, op):
                    return False
            else:
                if not EventSynchronizer._device_then_host_synced(seq, pred):
                    return False
        return True

    # -- make_syncs --------------------------------------------------------
    @staticmethod
    def _fresh_event(seq: Sequence, pending: Seq[SyncOp]) -> Event:
        """Smallest event id free in the sequence *and* the syncs pending in this
        call (delegates to Sequence.new_unique_event, sequence.hpp:77-93)."""
        return Sequence(list(seq) + list(pending)).new_unique_event()

    @staticmethod
    def make_syncs(graph: Graph, seq: Sequence, op: BoundOp) -> List[SyncOp]:
        """The next missing sync op(s) before ``op`` is executable; empty iff
        already synced (reference event_synchronizer.hpp:246-329)."""
        syncs: List[SyncOp] = []

        def emit(s: SyncOp) -> None:
            if not any(_sync_attr_eq(s, t) for t in syncs):
                syncs.append(s)

        if isinstance(op, SyncOp) or op not in graph:
            return syncs
        for pred in graph.preds(op):
            if not isinstance(pred, BoundDeviceOp):
                continue
            if isinstance(op, BoundDeviceOp):
                if EventSynchronizer._device_then_device_synced(seq, pred, op):
                    continue
            else:
                if EventSynchronizer._device_then_host_synced(seq, pred):
                    continue
            pi = _index_of(seq, pred)
            assert pi is not None, f"pred {pred!r} not executed"
            rec = EventSynchronizer._find_record_after(seq, pi, pred.lane())
            if rec is None:
                # also covered if an identical record is already pending this call
                pending = next(
                    (
                        s
                        for s in syncs
                        if isinstance(s, EventRecord) and s.lane() == pred.lane()
                    ),
                    None,
                )
                if pending is None:
                    emit(EventRecord(pred.lane(), EventSynchronizer._fresh_event(seq, syncs)))
            else:
                if isinstance(op, BoundDeviceOp):
                    emit(WaitEvent(op.lane(), rec.event()))
                else:
                    emit(EventSync(rec.event()))
        return syncs
