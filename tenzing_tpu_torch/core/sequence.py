"""Ordered (partial or total) schedules.

Counterpart of ``tenzing_tpu/core/sequence.py`` (reference
``include/tenzing/sequence.hpp`` / ``src/sequence.cpp``): a vector of ops with
bound/unbound matching, smallest-free virtual event allocation
(``new_unique_event``), sequence equivalence under lane/event bijection, and the
canonical key that decides that equivalence in O(1) per lookup.
"""

from __future__ import annotations

from typing import Generic, Iterable, Iterator, List, Optional, TypeVar

from tenzing_tpu_torch.core.operation import BoundDeviceOp, OpBase, unbound
from tenzing_tpu_torch.core.resources import Equivalence, Event

OpT = TypeVar("OpT", bound=OpBase)


class Sequence(Generic[OpT]):
    """An ordered list of ops (reference Sequence<OpType>)."""

    def __init__(self, ops: Optional[Iterable[OpT]] = None):
        self._ops: List[OpT] = list(ops) if ops is not None else []
        # derived-value memo (canonical key, serialized JSON, schedule id):
        # every benchmark/cache/verify/journal/injection lookup re-derives
        # one of these from the same op list, and a search queries the same
        # schedule through many layers.  Entries are (version, value) and a
        # mutation bumps the version, so a mutated sequence can never serve
        # a stale value; ops themselves are immutable (bind() returns a new
        # BoundDeviceOp), so the op list is the only invalidation source.
        self._version = 0
        self._memo: dict = {}

    def cached(self, key: str, compute):
        """Memoize ``compute()`` under ``key`` until this sequence mutates.

        Safe under concurrent readers (worst case: both recompute — dict
        get/set are GIL-atomic), which the background compile-prefetch
        threads (bench/pipeline.py) rely on."""
        ent = self._memo.get(key)
        if ent is not None and ent[0] == self._version:
            return ent[1]
        # capture the version BEFORE computing: a mutation racing compute()
        # then leaves a stale-versioned entry (recomputed on the next read)
        # instead of a fresh-versioned stale value (served forever)
        version = self._version
        val = compute()
        self._memo[key] = (version, val)
        return val

    # -- list protocol ----------------------------------------------------
    def __len__(self) -> int:
        return len(self._ops)

    def __iter__(self) -> Iterator[OpT]:
        return iter(self._ops)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Sequence(self._ops[i])
        return self._ops[i]

    def push_back(self, op: OpT) -> None:
        self._ops.append(op)
        self._version += 1  # invalidate cached() derivations

    def vector(self) -> List[OpT]:
        return list(self._ops)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Sequence) and self._ops == other._ops

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Sequence([{', '.join(op.desc() for op in self._ops)}])"

    # -- bound/unbound matching (reference sequence.hpp:48-75) -------------
    def contains(self, op: OpBase) -> bool:
        return any(o == op for o in self._ops)

    def contains_unbound(self, op: OpBase) -> bool:
        """True if the sequence contains ``op`` or a lane-bound version of it
        (reference contains_unbound; with resource-insensitive identity this is
        plain equality)."""
        target = unbound(op)
        return any(unbound(o) == target for o in self._ops)

    def find_unbound(self, op: OpBase) -> Optional[OpBase]:
        """The sequence entry matching ``op`` modulo lane binding, or None
        (reference find_unbound, sequence.cpp:140-167)."""
        target = unbound(op)
        for o in self._ops:
            if unbound(o) == target:
                return o
        return None

    # -- event allocation (reference sequence.hpp:77-93) -------------------
    def new_unique_event(self) -> Event:
        """Smallest virtual Event id not used by any op in the sequence."""
        used = set()
        for op in self._ops:
            events = getattr(op, "events", None)
            if events is not None:
                used.update(e.id for e in events())
        i = 0
        while i in used:
            i += 1
        return Event(i)

    def desc(self, delim: str = ", ") -> str:
        return delim.join(op.desc() for op in self._ops)


def get_equivalence(a: Sequence, b: Sequence, base: Optional[Equivalence] = None) -> Equivalence:
    """Equivalence of two sequences up to a consistent renaming of lanes and
    events (reference sequence.cpp:21-86): ops must match pairwise in order by
    resource-insensitive identity, and their lane/event uses must admit mutually
    consistent bijections (extending ``base`` when given)."""
    if len(a) != len(b):
        return Equivalence.falsy()
    e = base.copy() if base is not None else Equivalence()
    if not e:
        return Equivalence.falsy()
    for x, y in zip(a, b):
        if x.eq_key() != y.eq_key():
            return Equivalence.falsy()
        xl = x.lanes() if hasattr(x, "lanes") else []
        yl = y.lanes() if hasattr(y, "lanes") else []
        if len(xl) != len(yl):
            return Equivalence.falsy()
        for la, lb in zip(xl, yl):
            if not e.check_or_insert_lane(la, lb):
                return Equivalence.falsy()
        xe = x.events() if hasattr(x, "events") else []
        ye = y.events() if hasattr(y, "events") else []
        if len(xe) != len(ye):
            return Equivalence.falsy()
        for ea, eb in zip(xe, ye):
            if not e.check_or_insert_event(ea, eb):
                return Equivalence.falsy()
    return e


def is_equivalent(a: Sequence, b: Sequence) -> bool:
    return bool(get_equivalence(a, b))


def canonical_key(seq: Sequence) -> tuple:
    """A hashable canonical form of ``seq`` under lane/event renaming:
    per op, (eq_key, lanes relabeled in first-use order, events likewise).

    Two sequences are bijection-equivalent (``get_equivalence`` with no base)
    iff their canonical keys are equal: a consistent bijection must map the
    i-th distinct lane of one to the i-th distinct lane of the other (at each
    first use, injectivity in both directions forces fresh->fresh), so a
    bijection exists exactly when the first-use-relabeled streams coincide.
    This is the O(1)-lookup replacement for pairwise bijection scans (the
    same canonicalization the native core's canonical_key uses,
    native/src/core.cpp) — ``get_equivalence`` remains the semantic ground
    truth and the cross-check test asserts agreement.

    Memoized on the sequence (``Sequence.cached``): the solvers' dedup
    loops, the benchmark cache, the verifier cache, and the journal all key
    on the canonical form of the same object, and the relabeling walk is
    O(n) per query.  A mutation (``push_back``) invalidates.
    """
    if isinstance(seq, Sequence):
        return seq.cached("canonical_key", lambda: _canonical_key_of(seq))
    return _canonical_key_of(seq)


def _canonical_key_of(seq: Sequence) -> tuple:
    lanes: dict = {}
    events: dict = {}
    items = []
    for op in seq:
        ls = tuple(
            lanes.setdefault(l.id, len(lanes))
            for l in (op.lanes() if hasattr(op, "lanes") else [])
        )
        es = tuple(
            events.setdefault(e.id, len(events))
            for e in (op.events() if hasattr(op, "events") else [])
        )
        items.append((op.eq_key(), ls, es))
    return tuple(items)
