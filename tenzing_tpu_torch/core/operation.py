"""Operation model: the vertices of the program DAG.

Counterpart of ``tenzing_tpu/core/operation.py`` (reference
``include/tenzing/operation.hpp`` OpBase/ChoiceOp/BoundOp/CpuOp/Start/Finish/NoOp
and ``cuda/ops_cuda.hpp:194-238`` GpuOp/BoundGpuOp):

* A **DeviceOp** works on named device buffers (``reads()`` / ``writes()`` /
  ``apply()``); it must be bound to a virtual :class:`Lane` before it is
  executable.  Binding produces a :class:`BoundDeviceOp`.  The stream executor
  (runtime/executor.py) runs ``apply`` on the CUDA stream of the op's lane.
  ``apply`` writes in place into the buffers it declares in ``writes()``.
* A **CpuOp** runs on the host thread in sequence order (the implicit HOST
  lane of the event-synchronizer case table).
* Equality is *resource-insensitive*: a BoundDeviceOp compares equal to its
  unbound DeviceOp and to a binding on any other lane.  Scheduler-inserted sync
  ops compare equal per *kind* regardless of lane/event ids.

Identity and ordering come from ``eq_key()``: ``__eq__``/``__hash__``/``__lt__``
all derive from it, so ops can key dicts (the Graph adjacency maps) and sort
stably.  The registry below is this package's own: the JAX package keeps a
separate one, so registering a kind here never touches the reference's serdes.
"""

from __future__ import annotations

import copy
from typing import TYPE_CHECKING, Any, Dict, Iterable, List, Optional, Sequence as Seq, Tuple

from tenzing_tpu_torch.core.resources import Lane

if TYPE_CHECKING:  # pragma: no cover
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.runtime.executor import RunContext


# Registry of op kinds for serdes (kind tag -> class).  Scheduler-inserted sync ops
# are reconstructed from their kind; workload ops are looked up in the graph by name
# (reference operation_serdes.cpp:14-76).
_KIND_REGISTRY: Dict[str, type] = {}


def register_kind(kind: str):
    def deco(cls):
        cls.KIND = kind
        _KIND_REGISTRY[kind] = cls
        return cls

    return deco


def kind_registry() -> Dict[str, type]:
    return dict(_KIND_REGISTRY)


class OpBase:
    """Abstract DAG vertex (reference OpBase, operation.hpp:20-32)."""

    KIND = "op"

    def __init__(self, name: str):
        self._name = name

    # -- identity ---------------------------------------------------------
    def name(self) -> str:
        return self._name

    def desc(self) -> str:
        """Human-readable description including resource bindings."""
        return self._name

    def eq_key(self) -> Tuple:
        """Resource-insensitive identity key; drives __eq__/__hash__/__lt__."""
        return ("named", self._name)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, OpBase) and self.eq_key() == other.eq_key()

    def __ne__(self, other: object) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return hash(self.eq_key())

    def __lt__(self, other: "OpBase") -> bool:
        return self.eq_key() < other.eq_key()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}({self.desc()})"

    # -- structure --------------------------------------------------------
    def clone(self) -> "OpBase":
        return copy.copy(self)

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "name": self._name}


class BoundOp(OpBase):
    """An executable op: all resource choices made (reference operation.hpp:96-99)."""

    def reads(self) -> List[str]:
        """Names of buffers this op reads."""
        return []

    def writes(self) -> List[str]:
        """Names of buffers this op writes (in place)."""
        return []

    def execute(self, ctx: "RunContext") -> None:
        """Run this op inside a schedule.  Default: ``ctx.run_default``, which
        runs ``apply`` on the op's lane stream (device ops) or on the host
        thread (host ops).  Sync and transfer ops override it."""
        ctx.run_default(self)

    def apply(self, bufs: Dict[str, Any], ctx: "RunContext") -> None:
        """The op's work on the named buffers, written in place."""
        return None


class CpuOp(BoundOp):
    """A host-side op; occupies the implicit HOST lane (reference operation.hpp:102-111)."""

    KIND = "cpu"

    def is_host(self) -> bool:
        return True


@register_kind("start")
class Start(CpuOp):
    """Graph entry sentinel (reference operation.hpp:114-124)."""

    def __init__(self):
        super().__init__("start")

    def eq_key(self) -> Tuple:
        return ("start",)


@register_kind("finish")
class Finish(CpuOp):
    """Graph exit sentinel (reference operation.hpp:127-136)."""

    def __init__(self):
        super().__init__("finish")

    def eq_key(self) -> Tuple:
        return ("finish",)


@register_kind("noop")
class NoOp(CpuOp):
    """A do-nothing named CPU op, the unit test workhorse (reference operation.hpp:141-157)."""


class ChoiceOp(OpBase):
    """A non-executable op standing for a set of implementation choices
    (reference operation.hpp:90-93).  The scheduler replaces it in the graph with
    one of ``choices()`` via a ChooseOp decision (state.cpp:61-65)."""

    KIND = "choice"

    def choices(self) -> List[OpBase]:
        raise NotImplementedError


class CompoundOp(OpBase):
    """An op that packages a whole sub-graph (reference operation_compound.hpp:1-13).

    The scheduler inlines it via Graph.clone_but_expand (ExpandOp decision).
    """

    KIND = "compound"

    def graph(self) -> "Graph":
        raise NotImplementedError


class DeviceOp(OpBase):
    """A device computation that must be bound to a Lane before execution
    (reference GpuOp, ops_cuda.hpp:194-197).

    Subclasses implement reads()/writes()/apply().  ``scratch()`` declares
    device work buffers the op needs beyond the schedule's buffers; the
    executor allocates them once, before any timed run, so no op allocates
    while a schedule runs.
    """

    KIND = "device"

    def reads(self) -> List[str]:
        return []

    def writes(self) -> List[str]:
        return []

    def scratch(self) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        """Scratch buffers: name -> (shape, dtype name).  Default: none."""
        return {}

    def scratch_for(self, shapes: Dict[str, Tuple[int, ...]]
                    ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        """Scratch whose shape follows the schedule's buffers (``shapes``:
        buffer name -> shape).  Default: :meth:`scratch`."""
        return self.scratch()

    def apply(self, bufs: Dict[str, Any], ctx: "RunContext") -> None:
        raise NotImplementedError

    def bind(self, lane: Lane) -> "BoundDeviceOp":
        return BoundDeviceOp(self, lane)

    # -- fused-region protocol (runtime/fused.py) -------------------------
    def uses_pallas(self) -> bool:
        """True when this op's slot launches a hand-written kernel (the
        reference's Pallas slots: ``.pallas*``, ``.fused*``, and a fused
        region itself).  Such an op never joins a fused region."""
        return False

    def fusible(self) -> bool:
        """True when the op may run as a member of a fused region: a pure
        buffer -> buffer device computation, no transfer or host semantics.
        Opt-in per op class, so an un-audited op never lands in a region."""
        return False

    def fuse_tiling(self) -> Optional[Dict[str, Optional[int]]]:
        """Row decomposition for fused-region tiling: over this op's reads
        and writes, the axis along which it is independent (``None`` value:
        the op needs the whole buffer, e.g. a gathered x).  ``None`` return:
        not tileable; the op still fuses, its region offers one tile only."""
        return None

    # -- op-chunking protocol (core/chunking.py) ---------------------------
    def chunkable(self) -> bool:
        """True when this op can expand into ``n`` partial ops through
        :meth:`split`.  Opt-in per op class, so chunked variants only enter a
        menu for ops that declare it and an un-audited op is never silently
        re-associated."""
        return False

    def chunk_counts(self) -> List[int]:
        """Structurally valid chunk counts (always containing 1): the counts
        :meth:`split` accepts.  Validity only; whether a count can help is
        ``bench/roofline.prune_chunkings``'s question."""
        return [1]

    def split(self, n: int) -> List["DeviceOp"]:
        """This op as ``n`` partial ops, run in list order: every partial
        reads the buffer version its predecessor wrote (an accumulating
        read-modify-write), so ``ChunkedOp`` chains them serially and other
        ops may interleave between them."""
        raise NotImplementedError(
            f"{type(self).__name__} declares no split(): chunkable() ops "
            "must implement the chunking protocol")


class BoundDeviceOp(BoundOp):
    """DeviceOp + Lane = executable (reference BoundGpuOp, ops_cuda.hpp:202-238).

    Identity delegates to the wrapped op (lane-insensitive equality), so a graph
    vertex keeps its key across lane-assignment surgery
    (Graph.clone_but_replace, reference graph.hpp:130-158).
    """

    KIND = "bound_device"

    def __init__(self, op: DeviceOp, lane: Lane):
        super().__init__(op.name())
        self._op = op
        self._lane = lane

    def unbound(self) -> DeviceOp:
        return self._op

    def lane(self) -> Lane:
        return self._lane

    def lanes(self) -> List[Lane]:
        """Resource introspection (reference HasStream, ops_cuda.hpp:24-31)."""
        return [self._lane]

    def with_lane(self, lane: Lane) -> "BoundDeviceOp":
        return BoundDeviceOp(self._op, lane)

    def desc(self) -> str:
        return f"{self._op.desc()}@{self._lane!r}"

    def eq_key(self) -> Tuple:
        return self._op.eq_key()

    def reads(self) -> List[str]:
        return self._op.reads()

    def writes(self) -> List[str]:
        return self._op.writes()

    def scratch(self) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        return self._op.scratch()

    def scratch_for(self, shapes: Dict[str, Tuple[int, ...]]
                    ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        return self._op.scratch_for(shapes)

    def apply(self, bufs: Dict[str, Any], ctx: "RunContext") -> None:
        self._op.apply(bufs, ctx)

    def uses_pallas(self) -> bool:
        return self._op.uses_pallas()

    def fusible(self) -> bool:
        return self._op.fusible()

    def fuse_tiling(self) -> Optional[Dict[str, Optional[int]]]:
        return self._op.fuse_tiling()

    def chunkable(self) -> bool:
        return self._op.chunkable()

    def chunk_counts(self) -> List[int]:
        return self._op.chunk_counts()

    def split(self, n: int) -> List[DeviceOp]:
        return self._op.split(n)

    def to_json(self) -> Dict[str, Any]:
        j = self._op.to_json()
        j["lane"] = self._lane.id
        return j


# -- helpers (reference operation.cpp:36-100) ------------------------------------


def make_lane_variations(op: OpBase, lanes: Seq[Lane]) -> List[OpBase]:
    """All lane bindings of ``op`` (reference make_platform_variations,
    operation.cpp:36-49).  Non-device ops pass through unchanged."""
    if isinstance(op, BoundDeviceOp):
        return [op.with_lane(lane) for lane in lanes]
    if isinstance(op, DeviceOp):
        return [op.bind(lane) for lane in lanes]
    return [op]


def unbound(op: OpBase) -> OpBase:
    """Strip a lane binding if present (reference BoundGpuOp::unbound)."""
    if isinstance(op, BoundDeviceOp):
        return op.unbound()
    return op


def keep_uniques(ops: Iterable[OpBase]) -> List[OpBase]:
    """Order-preserving dedup by op equality (reference keep_uniques,
    operation.cpp:51-62)."""
    seen = set()
    out: List[OpBase] = []
    for op in ops:
        k = op.eq_key()
        if k not in seen:
            seen.add(k)
            out.append(op)
    return out
