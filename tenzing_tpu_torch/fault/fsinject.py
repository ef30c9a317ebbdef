"""Seeded hostile-filesystem fault injection: the storage plane's chaos.

Counterpart of ``tenzing_tpu/fault/fsinject.py``, with its six kinds, its
grammar (``TENZING_FSINJECT=kind:rate:seed[:param]``, comma-separated to
compose) and its draws, so one spec fires on the same calls in both
packages.  ``fault/inject.py`` injects at the benchmark layer; this module
injects at the filesystem layer, through the one write seam every durable
writer of the port goes through (utils/atomic.py):

* ``eio`` — raises ``OSError(EIO)`` on a write or fsync (a flaky disk, a
  dropped NFS call).  Classified transient (fault/errors.py): the hardened
  writers retry through fault/backoff.py.
* ``enospc`` — raises ``OSError(ENOSPC)`` on a write (a full disk).  Not
  retryable: the serving plane latches the store read-only
  (serve/store.py ``mark_store_unwritable``).
* ``torn_rename`` — SIGKILLs the process between the fsynced temp file and
  the link or replace that publishes it, the crash the sealed formats must
  survive.  ``param=1`` raises :class:`InjectedTornRename` instead (for
  tests in one process).
* ``stale_read`` — a read of a just-replaced file returns the previous
  complete content, once (NFS attribute-cache staleness): the lie the lease
  protocol's epoch fencing exists to survive (serve/lease.py).
* ``mtime_skew`` — observed mtimes shift ``param`` seconds into the past
  (default 2.0): a skewed clock ages a live rival's heartbeat.
* ``mtime_coarse`` — observed mtimes floor to ``param``-second granularity
  (default 1.0): coarse timestamps, the same hole by truncation.

Draws are keyed by identity, as in inject.py: each checked operation draws
from ``hash(kind:seed:basename:op-counter)`` with a counter per (kind,
file), not from process RNG, so the same write to the same file fails again
after a restart and a chaos run replays under its seed.  For ``eio``,
``enospc`` and ``stale_read`` an integer ``param`` bounds the total fires
(0: unlimited), a burst and then recovery.

Install in the process with :func:`install`, or export ``TENZING_FSINJECT``
before starting a subprocess: utils/atomic.py installs from the environment
at its first use.  The lease protocol's epoch registry (O_EXCL directory
entries, not file content) is outside the seam on purpose: it is the layer
the chaos must not be able to lie to.
"""

from __future__ import annotations

import errno
import json
import os
import signal
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

from tenzing_tpu_torch.fault.inject import _hash_draw
from tenzing_tpu_torch.utils import atomic as _atomic

FS_KINDS = ("eio", "enospc", "torn_rename", "stale_read", "mtime_skew",
            "mtime_coarse")
# the seam operations each kind can fire on (utils/atomic.py's checks)
_OPS_OF = {
    "eio": ("write", "fsync"),
    "enospc": ("write",),
    "torn_rename": ("link", "replace"),
}
FSINJECT_ENV = _atomic.FSINJECT_ENV


class InjectedTornRename(OSError):
    """The raising torn rename (``torn_rename`` with ``param=1``): the
    publish failed after the temp bytes landed.  An OSError, so the
    classifier calls it transient and the caller's retry publishes again."""

    def __init__(self, msg: str):
        super().__init__(errno.EIO, msg)


@dataclass(frozen=True)
class FsInjectSpec:
    """One filesystem-fault channel: ``kind`` at probability ``rate`` from
    ``seed``; ``param`` depends on the kind (module docstring)."""

    kind: str
    rate: float
    seed: int
    param: float = 0.0


def parse_fs_specs(text: str) -> List[FsInjectSpec]:
    """Parse ``kind:rate:seed[:param]`` (comma-separated).  Errors are loud:
    a mistyped spec that injected nothing would make a chaos run prove
    nothing."""
    specs: List[FsInjectSpec] = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (3, 4):
            raise ValueError(
                f"fsinject spec {part!r}: want kind:rate:seed[:param]")
        kind, rate_s, seed_s = fields[:3]
        if kind not in FS_KINDS:
            raise ValueError(
                f"fsinject kind {kind!r}: want one of {FS_KINDS}")
        rate = float(rate_s)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fsinject rate {rate!r} not in [0, 1]")
        param = float(fields[3]) if len(fields) == 4 else 0.0
        specs.append(FsInjectSpec(kind=kind, rate=rate, seed=int(seed_s),
                                  param=param))
    if not specs:
        raise ValueError("fsinject: empty spec")
    return specs


def format_fs_specs(specs: List[FsInjectSpec]) -> str:
    """The variable's form of ``specs`` (the inverse of
    :func:`parse_fs_specs`)."""
    parts = []
    for s in specs:
        part = f"{s.kind}:{s.rate}:{s.seed}"
        if s.param:
            part += f":{s.param:g}"
        parts.append(part)
    return ",".join(parts)


class FsInjectBackend:
    """The I/O backend utils/atomic.py consults (module docstring).
    ``injected`` counts the fires per kind, so a chaos test can show that
    its run went through the fault paths."""

    def __init__(self, specs: List[FsInjectSpec]):
        self.specs = list(specs)
        self.injected: Dict[str, int] = {k: 0 for k in FS_KINDS}
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], int] = {}
        self._fires: Dict[int, int] = {}   # spec index -> fires so far
        self._prev: Dict[str, str] = {}    # path -> content before replace
        self._snapshot = any(s.kind == "stale_read" for s in self.specs)

    def _draw(self, spec: FsInjectSpec, idx: int, base: str) -> bool:
        """One coin flip keyed by identity: counts the (kind, file)
        operation and honours the channel's bound on fires."""
        with self._lock:
            n = self._counters.get((spec.kind, base), 0)
            self._counters[(spec.kind, base)] = n + 1
            if spec.param and spec.kind in ("eio", "enospc", "stale_read") \
                    and self._fires.get(idx, 0) >= int(spec.param):
                return False  # the burst is spent: quiet from here on
            if _hash_draw(f"{spec.kind}:{spec.seed}:{base}:{n}") >= spec.rate:
                return False
            self._fires[idx] = self._fires.get(idx, 0) + 1
        self._record(spec.kind, base)
        return True

    def _record(self, kind: str, base: str) -> None:
        self.injected[kind] += 1
        try:
            from tenzing_tpu_torch.obs.metrics import get_metrics
            from tenzing_tpu_torch.obs.tracer import get_tracer

            get_metrics().counter(f"fault.fsinjected.{kind}").inc()
            tr = get_tracer()
            if tr.enabled:
                tr.event("fault.fsinjected", kind=kind, file=base)
        except Exception:
            pass  # telemetry must never turn an injected fault into a real one

    def check(self, op: str, path: str) -> None:
        """The write path's check: ``op`` is about to run against the final
        ``path``.  May raise OSError (EIO, ENOSPC), raise
        :class:`InjectedTornRename`, or SIGKILL this process."""
        base = os.path.basename(path)
        if self._snapshot and op in ("link", "replace"):
            self._snapshot_prev(path)
        for idx, spec in enumerate(self.specs):
            if op not in _OPS_OF.get(spec.kind, ()):
                continue
            if not self._draw(spec, idx, base):
                continue
            if spec.kind == "torn_rename":
                if spec.param:
                    raise InjectedTornRename(
                        f"injected torn rename (fsinject {base})")
                # die with the temp bytes on disk and the publish not yet
                # linked: the successor finds the torn state
                os.kill(os.getpid(), signal.SIGKILL)
            code = errno.ENOSPC if spec.kind == "enospc" else errno.EIO
            raise OSError(code, f"injected {spec.kind} (fsinject {base} "
                                f"op {op})")

    def _snapshot_prev(self, path: str) -> None:
        """Keep the content a replace is about to supersede: the stale
        version a later read may be served."""
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            return  # a first publish: nothing older to serve
        with self._lock:
            self._prev[path] = text

    def maybe_stale_json(self, path: str) -> Optional[Any]:
        """The read path's check: the previous complete JSON content of
        ``path``, served at most once per superseded version when a
        ``stale_read`` draw fires, else None (read the real file)."""
        if not self._snapshot or path not in self._prev:
            return None
        base = os.path.basename(path)
        for idx, spec in enumerate(self.specs):
            if spec.kind != "stale_read":
                continue
            if not self._draw(spec, idx, base):
                continue
            with self._lock:
                text = self._prev.pop(path, None)
            if text is None:
                return None
            try:
                return json.loads(text)
            except ValueError:
                return None  # the stale version was torn: read the real one
        return None

    def observe_mtime(self, path: str, mtime: float) -> float:
        """The clock's check: the mtime a lease-expiry check observes for
        ``path``, skewed or coarsened when draws fire."""
        base = os.path.basename(path)
        out = mtime
        for idx, spec in enumerate(self.specs):
            if spec.kind == "mtime_coarse":
                if self._draw(spec, idx, base):
                    gran = spec.param or 1.0
                    out = (out // gran) * gran
            elif spec.kind == "mtime_skew":
                if self._draw(spec, idx, base):
                    out -= (spec.param or 2.0)
        return out


def install(specs: Union[str, List[FsInjectSpec]]) -> FsInjectBackend:
    """Install a hostile-filesystem backend behind utils/atomic.py's seam;
    returns it (tests read ``backend.injected``)."""
    if isinstance(specs, str):
        specs = parse_fs_specs(specs)
    backend = FsInjectBackend(specs)
    _atomic.set_io_backend(backend)
    return backend


def uninstall() -> None:
    """Restore the well-behaved filesystem."""
    _atomic.set_io_backend(None)


def installed() -> Optional[FsInjectBackend]:
    return _atomic.io_backend()


def install_from_env() -> Optional[FsInjectBackend]:
    """Install from ``$TENZING_FSINJECT`` (what a subprocess inherits;
    utils/atomic.py calls this at its first use)."""
    text = os.environ.get(FSINJECT_ENV)
    if not text:
        return None
    return install(text)
