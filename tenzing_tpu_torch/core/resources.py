"""Virtual execution resources: lanes, events, and resource bijections.

Counterpart of ``tenzing_tpu/core/resources.py`` (reference virtual
``Stream``/``Event`` handles, include/tenzing/platform.hpp:22-86, and the
``Bijection`` that proves two schedules identical up to resource renaming,
include/tenzing/bijection.hpp:3-47).

A **Lane** is a virtual execution lane; the stream executor gives each lane one
CUDA stream.  An **Event** is a virtual cross-lane ordering event; the executor
gives each one CUDA event.  Both are small integer ids bound late: the search
manipulates ids only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Generic, Iterator, Tuple, TypeVar


@dataclass(frozen=True, order=True)
class Lane:
    """Virtual execution lane id (reference Stream, platform.hpp:22-52)."""

    id: int = 0

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"lane{self.id}"


@dataclass(frozen=True, order=True)
class Event:
    """Virtual cross-lane ordering event id (reference Event, platform.hpp:54-86)."""

    id: int = 0

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"event{self.id}"


T = TypeVar("T")


class Bijection(Generic[T]):
    """A growable one-to-one mapping used for resource-renaming equivalence.

    ``check_or_insert(a, b)`` succeeds iff adding the pair (a, b) keeps the mapping
    a bijection.  Mirrors the reference's ``Bijection<T>`` (bijection.hpp:3-47).
    """

    def __init__(self) -> None:
        self._fwd: Dict[T, T] = {}
        self._rev: Dict[T, T] = {}

    def check_or_insert(self, a: T, b: T) -> bool:
        if a in self._fwd:
            return self._fwd[a] == b
        if b in self._rev:
            return self._rev[b] == a
        self._fwd[a] = b
        self._rev[b] = a
        return True

    def __contains__(self, a: T) -> bool:
        return a in self._fwd

    def __getitem__(self, a: T) -> T:
        return self._fwd[a]

    def __len__(self) -> int:
        return len(self._fwd)

    def items(self) -> Iterator[Tuple[T, T]]:
        return iter(self._fwd.items())

    def copy(self) -> "Bijection[T]":
        out: Bijection[T] = Bijection()
        out._fwd = dict(self._fwd)
        out._rev = dict(self._rev)
        return out

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Bijection({self._fwd})"


class Equivalence:
    """A pair of bijections (lanes, events) witnessing that two schedules are
    identical up to resource renaming (reference Equivalence, platform.hpp:248-270).

    Truthy iff it represents a discovered equivalence; ``Equivalence.falsy()``
    is the "not equivalent" witness.
    """

    def __init__(self, ok: bool = True) -> None:
        self.lanes: Bijection[Lane] = Bijection()
        self.events: Bijection[Event] = Bijection()
        self._ok = ok

    @staticmethod
    def falsy() -> "Equivalence":
        return Equivalence(ok=False)

    def __bool__(self) -> bool:
        return self._ok

    def check_or_insert_lane(self, a: Lane, b: Lane) -> bool:
        return self.lanes.check_or_insert(a, b)

    def check_or_insert_event(self, a: Event, b: Event) -> bool:
        return self.events.check_or_insert(a, b)

    def copy(self) -> "Equivalence":
        out = Equivalence(ok=self._ok)
        out.lanes = self.lanes.copy()
        out.events = self.events.copy()
        return out

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Equivalence(ok={self._ok}, lanes={self.lanes}, events={self.events})"
