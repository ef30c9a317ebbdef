"""ctypes bridge to the native search core (the repository's ``native/``).

Counterpart of ``tenzing_tpu/native/bridge.py``.  Lowering: a graph whose
vertices are all ``Start`` / ``Finish`` / ``CpuOp`` / ``DeviceOp`` /
``BoundDeviceOp`` (compound and choice ops already expanded) maps to the
native description: ops numbered in vertex-insertion order, their kinds, the
edge list in insertion order (decision enumeration must match the Python
layer's order exactly).  Schedules cross the boundary as ``(tag, a, b)``
int32 triples (``native/include/tznative/core.hpp`` ``Tag``).

The library is built here, never by the repository's make rules (their
output is a file of the JAX package): ``g++ -O2 -std=c++17 -fPIC -shared`` over
``native/src/*.cpp`` with ``native/include``, into
``build/tenzing_tpu_torch/libtznative-<digest>.so``, the digest taken over
the sources and flags, under a file lock (as ``ops/kernel_lib.py`` builds
the kernels).  Unlike the reference, a build or load that fails raises in
the default mode too: there is no silent fall back to the Python path.  The
Python path is taken only where the core cannot apply: a graph that does not
lower, or lanes that are not ``0..n-1``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import (
    BoundDeviceOp,
    BoundOp,
    CpuOp,
    DeviceOp,
    Finish,
    OpBase,
    Start,
)
from tenzing_tpu_torch.core.resources import Event, Lane
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.state import AssignLane, Decision, ExecuteOp, State
from tenzing_tpu_torch.core.sync_ops import (
    EventRecord,
    EventSync,
    LaneSync,
    SyncOp,
    WaitEvent,
)

# kinds and tags: native/include/tznative/core.hpp
KIND_HOST, KIND_DEVICE, KIND_START, KIND_FINISH = 0, 1, 2, 3
TAG_EXEC, TAG_RECORD, TAG_WAIT, TAG_SYNC_EVENT, TAG_SYNC_LANE, TAG_ASSIGN = range(6)

TZ_ERROR = -1000000000
ABI_VERSION = 2

REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO_ROOT / "native"
BUILD_DIR = REPO_ROOT / "build" / "tenzing_tpu_torch"
SOURCES = ("src/core.cpp", "src/capi.cpp")
HEADERS = ("include/tznative/core.hpp",)
CXX = "g++"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[BaseException] = None


class NotLowerable(Exception):
    """The graph or sequence holds an op the native core cannot represent."""


class NativeError(RuntimeError):
    """The native library failed to build, load or answer."""


def _mode() -> str:
    return os.environ.get("TENZING_TPU_NATIVE", "auto").lower()


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join([CXX] + CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtznative-{_digest()}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.  A file
    lock serializes concurrent builders (parallel tests, fleet workers)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".libtznative-",
                                   suffix=".so")
        os.close(fd)
        try:
            cmd = [CXX, *CXX_FLAGS, "-I", str(NATIVE_DIR / "include"),
                   "-shared", "-o", tmp,
                   *[str(NATIVE_DIR / s) for s in SOURCES]]
            try:
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=300)
            except OSError as e:
                raise NativeError(f"native build failed to start: {e}") from e
            if p.returncode != 0:
                raise NativeError(
                    f"native build failed:\n{p.stdout}\n{p.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def _bind(lib: ctypes.CDLL) -> None:
    i32, i64, p32 = ctypes.c_int32, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
    lib.tz_last_error.restype = ctypes.c_char_p
    lib.tz_graph_create.restype = ctypes.c_void_p
    lib.tz_graph_create.argtypes = [i32, p32, i32, p32]
    lib.tz_graph_destroy.argtypes = [ctypes.c_void_p]
    lib.tz_decisions.restype = i64
    lib.tz_decisions.argtypes = [ctypes.c_void_p, i32, p32, i32, p32, p32, i64]
    lib.tz_rollout.restype = i64
    lib.tz_rollout.argtypes = [ctypes.c_void_p, i32, p32, i32, p32,
                               ctypes.c_uint64, p32, i64]
    lib.tz_enum_run.restype = i64
    lib.tz_enum_run.argtypes = [ctypes.c_void_p, i32, p32, i32, i32, p32]
    lib.tz_enum_fetch.restype = i64
    lib.tz_enum_fetch.argtypes = [p32, i64]


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None only where the
    mode turns the core off.  A failed build or load raises, and raises
    again at every later call without rebuilding."""
    global _lib, _lib_error
    if _mode() in ("0", "off", "false"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise NativeError(f"native library unavailable: {_lib_error}")
        try:
            lib = ctypes.CDLL(str(build()))
            lib.tz_abi_version.restype = ctypes.c_int32
            abi = lib.tz_abi_version()
            if abi != ABI_VERSION:
                raise NativeError(f"native ABI version {abi}, want "
                                  f"{ABI_VERSION}")
            _bind(lib)
        except Exception as e:
            _lib_error = e
            raise
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the core is on (it is then built and loaded)."""
    return _load() is not None


# -- lowering -----------------------------------------------------------------


def _kind_of(v: OpBase) -> int:
    if isinstance(v, Start):
        return KIND_START
    if isinstance(v, Finish):
        return KIND_FINISH
    if isinstance(v, (DeviceOp, BoundDeviceOp)):
        return KIND_DEVICE
    if isinstance(v, CpuOp):
        return KIND_HOST
    raise NotLowerable(f"vertex {v!r} (expand compound and choice ops first)")


class LoweredGraph:
    """A graph lowered to a native handle, with the vertex table that maps
    results back to op objects."""

    def __init__(self, graph: Graph, lib: ctypes.CDLL):
        self._lib = lib
        self.vertices: List[OpBase] = graph.vertices()
        self.index: Dict[Tuple, int] = {}
        kinds = []
        for i, v in enumerate(self.vertices):
            kinds.append(_kind_of(v))
            self.index[v.eq_key()] = i
        edges: List[int] = []
        for v in self.vertices:
            for s in graph.succs(v):
                edges += [self.index[v.eq_key()], self.index[s.eq_key()]]
        self.n = len(self.vertices)
        self.handle = lib.tz_graph_create(
            self.n, (ctypes.c_int32 * len(kinds))(*kinds), len(edges) // 2,
            (ctypes.c_int32 * max(1, len(edges)))(*edges))
        if not self.handle:
            raise NativeError(lib.tz_last_error().decode())

    def __del__(self):
        h = getattr(self, "handle", None)
        if h:
            self._lib.tz_graph_destroy(h)
            self.handle = None

    # -- python -> native ----------------------------------------------------
    def bindings_of(self, graph: Graph):
        """Each op's lane binding in ``graph`` (a re-bound clone of the
        lowered structure), -1 where unbound."""
        b = [-1] * self.n
        for v in graph.vertices():
            i = self.index.get(v.eq_key())
            if i is None:
                raise NotLowerable(f"graph vertex {v!r} absent from the "
                                   "lowered structure")
            if isinstance(v, BoundDeviceOp):
                b[i] = v.lane().id
        return (ctypes.c_int32 * self.n)(*b)

    def lower_sequence(self, seq: Sequence):
        items: List[int] = []
        for op in seq:
            if isinstance(op, EventRecord):
                items += [TAG_RECORD, op.lane().id, op.event().id]
            elif isinstance(op, WaitEvent):
                items += [TAG_WAIT, op.lane().id, op.event().id]
            elif isinstance(op, EventSync):
                items += [TAG_SYNC_EVENT, op.event().id, -1]
            elif isinstance(op, LaneSync):
                items += [TAG_SYNC_LANE, op.lane().id, -1]
            elif isinstance(op, SyncOp):
                raise NotLowerable(f"sync op {op!r} has no native form")
            else:
                i = self.index.get(op.eq_key())
                if i is None:
                    raise NotLowerable(f"sequence op {op!r} is not a vertex")
                lane = op.lane().id if isinstance(op, BoundDeviceOp) else -1
                items += [TAG_EXEC, i, lane]
        return len(items) // 3, (ctypes.c_int32 * max(1, len(items)))(*items)

    # -- native -> python ----------------------------------------------------
    def item_to_op(self, tag: int, a: int, b: int) -> OpBase:
        if tag == TAG_EXEC:
            v = self.vertices[a]
            if b >= 0:
                if isinstance(v, BoundDeviceOp):
                    return v if v.lane().id == b else v.with_lane(Lane(b))
                assert isinstance(v, DeviceOp), v
                return v.bind(Lane(b))
            return v
        if tag == TAG_RECORD:
            return EventRecord(Lane(a), Event(b))
        if tag == TAG_WAIT:
            return WaitEvent(Lane(a), Event(b))
        if tag == TAG_SYNC_EVENT:
            return EventSync(Event(a))
        if tag == TAG_SYNC_LANE:
            return LaneSync(Lane(a))
        raise NativeError(f"unexpected item tag {tag}")

    def items_to_sequence(self, flat, n_items: int) -> Sequence:
        return Sequence(
            self.item_to_op(flat[3 * i], flat[3 * i + 1], flat[3 * i + 2])
            for i in range(n_items))

    def decision_of(self, tag: int, a: int, b: int, graph: Graph) -> Decision:
        if tag == TAG_ASSIGN:
            v = graph.vertex(self.vertices[a])
            assert isinstance(v, DeviceOp) and not isinstance(v, BoundDeviceOp), v
            return AssignLane(v, Lane(b))
        if tag == TAG_EXEC:
            # the graph's own vertex carries the current binding
            v = graph.vertex(self.vertices[a])
            assert isinstance(v, BoundOp), v
            return ExecuteOp(v)
        return ExecuteOp(self.item_to_op(tag, a, b))


# A search lowers thousands of states whose graphs are re-bound clones of a
# few structures (eq_key ignores bindings): the handle and vertex table are
# reused, and only the bindings and the sequence are lowered per call.
_LG_CACHE: Dict[Tuple, LoweredGraph] = {}
_LG_CACHE_LOCK = threading.Lock()
_LG_CACHE_MAX = 128


def lowered_graph_for(graph: Graph) -> LoweredGraph:
    """The cached lowering of ``graph``'s structure (binding-insensitive)."""
    lib = _load()
    if lib is None:
        raise NativeError("the native core is off (TENZING_TPU_NATIVE=0)")
    verts = graph.vertices()
    idx = {v.eq_key(): i for i, v in enumerate(verts)}
    key = (
        tuple(v.eq_key() for v in verts),
        tuple(_kind_of(v) for v in verts),
        tuple(tuple(idx[s.eq_key()] for s in graph.succs(v)) for v in verts),
    )
    with _LG_CACHE_LOCK:
        lg = _LG_CACHE.get(key)
        if lg is None:
            if len(_LG_CACHE) >= _LG_CACHE_MAX:
                _LG_CACHE.clear()
            lg = LoweredGraph(graph, lib)
            _LG_CACHE[key] = lg
        return lg


def _lanes_are_dense(platform) -> bool:
    """The core numbers lanes 0..n-1; other lane ids take the Python path."""
    return [ln.id for ln in platform.lanes] == list(range(len(platform.lanes)))


def _lower_state(state: State):
    lg = lowered_graph_for(state.graph)
    bindings = lg.bindings_of(state.graph)
    seq_len, seq_arr = lg.lower_sequence(state.sequence)
    return lg, bindings, seq_len, seq_arr


def _call_sized(fn, cap: int):
    """``fn(out, cap)`` with a buffer of ``cap`` int32s, once more at the size
    a negative answer asks for; returns ``(out, n)``."""
    out = (ctypes.c_int32 * cap)()
    n = fn(out, cap)
    if n == TZ_ERROR:
        return out, n
    if n < 0:
        out = (ctypes.c_int32 * (-n))()
        n = fn(out, -n)
    return out, n


# -- solver entry points ------------------------------------------------------


def try_decisions(state: State, platform) -> Optional[List[Decision]]:
    """The core's ``get_decisions``, or None where it does not apply."""
    if _load() is None or not _lanes_are_dense(platform):
        return None
    try:
        lg, bindings, seq_len, seq_arr = _lower_state(state)
    except NotLowerable:
        return None
    n_lanes = len(platform.lanes)
    out, n = _call_sized(
        lambda buf, cap: lg._lib.tz_decisions(lg.handle, n_lanes, bindings,
                                              seq_len, seq_arr, buf, cap),
        (lg.n * max(1, n_lanes) + 16) * 3)
    if n < 0:
        raise NativeError(lg._lib.tz_last_error().decode())
    return [lg.decision_of(out[3 * i], out[3 * i + 1], out[3 * i + 2],
                           state.graph) for i in range(n // 3)]


def try_rollout(state: State, platform, seed: int) -> Optional[Sequence]:
    """A uniform-random playout of the core to a terminal sequence, or None
    where it does not apply."""
    if _load() is None or not _lanes_are_dense(platform):
        return None
    try:
        lg, bindings, seq_len, seq_arr = _lower_state(state)
    except NotLowerable:
        return None
    n_lanes = len(platform.lanes)
    seed &= 0xFFFFFFFFFFFFFFFF
    out, n = _call_sized(
        lambda buf, cap: lg._lib.tz_rollout(lg.handle, n_lanes, bindings,
                                            seq_len, seq_arr, seed, buf, cap),
        (lg.n * 8 + 64) * 3)
    if n < 0:
        raise NativeError(lg._lib.tz_last_error().decode())
    return lg.items_to_sequence(out, n // 3)


def try_enumerate(graph: Graph, platform, max_seqs: int,
                  dedup_terminals: bool = True) -> Optional[List[State]]:
    """The core's exhaustive enumeration as states with lane-bound graphs,
    or None where it does not apply.  Lanes the caller pinned in ``graph``
    stay pinned."""
    if _load() is None or not _lanes_are_dense(platform):
        return None
    try:
        lg = lowered_graph_for(graph)
        bindings = lg.bindings_of(graph)
    except NotLowerable:
        return None
    n_seqs = ctypes.c_int32(0)
    # two phases: run, then fetch into a buffer of exactly the result's size
    total = lg._lib.tz_enum_run(lg.handle, len(platform.lanes), bindings,
                                max_seqs, 1 if dedup_terminals else 0,
                                ctypes.byref(n_seqs))
    if total == TZ_ERROR:
        raise NativeError(lg._lib.tz_last_error().decode())
    out = (ctypes.c_int32 * max(1, total))()
    n = lg._lib.tz_enum_fetch(out, total)
    if n != total:
        raise NativeError(f"native enumeration fetched {n} of {total} items")
    states: List[State] = []
    w = 0
    for _ in range(n_seqs.value):
        n_items = out[w]
        w += 1
        ops = [lg.item_to_op(out[w + 3 * i], out[w + 3 * i + 1],
                             out[w + 3 * i + 2]) for i in range(n_items)]
        w += 3 * n_items
        assignment = {op.unbound(): op.lane() for op in ops
                      if isinstance(op, BoundDeviceOp)}
        bound = graph.apply_lane_assignment(assignment) if assignment else graph
        states.append(State(bound, Sequence(ops)))
    return states
