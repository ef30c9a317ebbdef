"""The fleet supervisor: one controller that owns the serving fleet and
acts on its telemetry, ``python -m tenzing_tpu_torch.serve.supervisor``.

Counterpart of ``tenzing_tpu/serve/supervisor.py``, with its options, CLI
flags, status and summary documents, counters and exit codes:

* **members** — drain daemons (serve/fleet.py's argv and pipe pump), an
  optional ``serve listen`` loop (``--listen-socket``) and a periodic
  offline ``serve compact`` pass over a segmented store.
* **autoscaling** — each tick takes the clamped ``recommended_daemons`` of
  :func:`~tenzing_tpu_torch.obs.alerts.backlog_summary`, with hysteresis
  (the desire must persist ``scale_hold_ticks`` ticks), a cooldown between
  actions and ``--min-daemons`` / ``--max-daemons`` bounds.  Scale-up adds
  one member; scale-down SIGTERMs the youngest, whose in-flight item the
  daemon's lease and checkpoint protect.  Scale-up is suppressed while the
  backlog is mostly poison.
* **self-healing** — a dead member, or one whose status heartbeat is
  stale past ``--stale-secs`` (SIGKILLed first as wedged), restarts
  through fault/backoff.py's bounded exponential backoff.  K crash
  restarts inside a sliding window trip the slot's
  :class:`CrashLoopBreaker`: the slot is quarantined (breaker ``open``),
  a ``supervisor_crash_loop`` page fires through the alert ledger, and
  after the quarantine one probe member is admitted (``half_open``); a
  healthy probe closes the breaker, a dead one opens it again.
* **single controller** — the supervisor holds a lease
  (serve/lease.py; a second supervisor on the queue exits 3) and writes
  ``status-supervisor.json`` heartbeats and metric snapshots.  A successor
  adopts the live members it finds in their status documents (fresh
  heartbeat, live pid) instead of spawning twice; an incumbent that loses
  its lease stands down without touching them (exit 4).
* **retention GC** — status, metrics and alert documents and exemplar
  bundles of owners that stopped longer than ``--gc-retention`` ago are
  swept; a live heartbeat, even a stale one, is never touched.

Members run in sessions of their own (``start_new_session``): a signal to
the supervisor's group does not reach them, and ``os.killpg`` on a member
takes its ``--exec-item`` drain child, which holds the card's context,
with it.  The supervisor itself never initializes CUDA: it spawns, watches
and audits.  On ``cuda`` (the default) it counts the visible cards without
creating a context and, unless ``--max-daemons`` says otherwise, sizes the
fleet to them: members that share a card measure each other, and the
store serves what they measure.  The reference sizes it by the host's
cores, as the port does on ``cpu``.  Without a card a ``cuda`` supervisor
exits 1 before it spawns anything.

Run it::

    python -m tenzing_tpu_torch.serve.supervisor --queue QDIR --store STORE \\
        --min-daemons 1 --max-daemons 1 [--device cpu] [--listen-socket S] \\
        [--drain-exit] [--override mcts_iters=6 ...]

**Exit codes**: 0 = drained or stopped healthy, 1 = degraded (an open
breaker, a double run) or no card, 3 = another supervisor holds the
controller lease, 4 = the lease was lost mid-run (a successor adopted the
fleet).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from tenzing_tpu_torch.fault.backoff import BackoffPolicy
from tenzing_tpu_torch.obs.alerts import Alert, AlertBook, backlog_summary
from tenzing_tpu_torch.obs.metrics import MetricsSnapshotWriter, get_metrics
from tenzing_tpu_torch.serve.daemon import cuda_cards
from tenzing_tpu_torch.serve.fleet import (
    FleetOpts,
    _daemon_cmd,
    _ProcHandle,
    audit_completions,
)
from tenzing_tpu_torch.serve.lease import LeaseFile
from tenzing_tpu_torch.serve.store import WorkQueue
from tenzing_tpu_torch.utils.atomic import atomic_dump_json

SUPERVISOR_VERSION = 1
LEASE_NAME = "supervisor.lease"       # NOT lease-*.json: item leases only
STATUS_NAME = "status-supervisor.json"
ALERTS_NAME = "alerts-supervisor.json"

RC_OK = 0
RC_DEGRADED = 1
RC_LEASE_HELD = 3
RC_LEASE_LOST = 4


def default_max_daemons(device: str) -> int:
    """The fleet ceiling when ``--max-daemons`` is not given: the visible
    cards on ``cuda`` (one measuring member a card), the host's cores on
    ``cpu`` as in the reference."""
    if device == "cuda":
        return cuda_cards()
    return os.cpu_count() or 4


def cuda_initialized() -> bool:
    """Whether this process created a CUDA context (it never should)."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


# -- crash-loop circuit breaker ----------------------------------------------

class CrashLoopBreaker:
    """Per-member-slot crash-loop protection: ``closed`` (normal
    restarts-with-backoff) → ``open`` after ``max_restarts`` crash
    restarts inside a ``window_secs`` sliding window (the slot is
    quarantined, nothing is spawned) → ``half_open`` after
    ``quarantine_secs`` (exactly one probe member is admitted) →
    ``closed`` again if the probe stays healthy for ``probe_ok_secs``
    (or exits clean), back to ``open`` if the probe crashes."""

    def __init__(self, max_restarts: int = 3, window_secs: float = 60.0,
                 quarantine_secs: float = 120.0,
                 probe_ok_secs: float = 5.0):
        self.max_restarts = int(max_restarts)
        self.window_secs = float(window_secs)
        self.quarantine_secs = float(quarantine_secs)
        self.probe_ok_secs = float(probe_ok_secs)
        self.state = "closed"
        self.restarts: List[float] = []
        self.opened_at: Optional[float] = None
        self.probe_spawned = False

    def prune(self, now: float) -> None:
        self.restarts = [t for t in self.restarts
                         if now - t <= self.window_secs]

    def record_crash(self, now: float) -> str:
        """One crash restart; returns the state AFTER recording."""
        if self.state == "half_open":
            # the probe itself died: the slot is still poisoned
            self.state, self.opened_at = "open", now
            self.probe_spawned = False
            self.restarts.append(now)
            return self.state
        self.prune(now)
        self.restarts.append(now)
        if self.state == "closed" and \
                len(self.restarts) >= self.max_restarts:
            self.state, self.opened_at = "open", now
        return self.state

    def allow_spawn(self, now: float) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            if self.opened_at is not None and \
                    now - self.opened_at >= self.quarantine_secs:
                self.state = "half_open"
                self.probe_spawned = False
                return True
            return False
        return not self.probe_spawned  # half_open: one probe only

    def spawned(self, now: float) -> None:
        if self.state == "half_open":
            self.probe_spawned = True

    def note_healthy(self, now: float) -> None:
        """The member ran ``probe_ok_secs`` (or exited clean): a
        half-open probe succeeded — close and forget the window."""
        if self.state == "half_open" and self.probe_spawned:
            self.state = "closed"
            self.restarts, self.opened_at = [], None
            self.probe_spawned = False

    def to_json(self) -> Dict[str, Any]:
        return {"state": self.state,
                "restarts_in_window": len(self.restarts),
                "max_restarts": self.max_restarts,
                "window_s": self.window_secs,
                "opened_at": self.opened_at}


# -- member handles ----------------------------------------------------------

class AdoptedHandle:
    """A member inherited from a dead predecessor: we hold its pid (from
    its status doc), not its pipes.  Liveness is ``kill(pid, 0)``;
    signals go to the pid; the exit code is unknowable (``rc: None`` —
    clean-vs-crash is then decided from the member's own status doc)."""

    def __init__(self, owner: str, pid: int):
        self.owner = owner
        self.pid = int(pid)

    def alive(self) -> bool:
        try:
            os.kill(self.pid, 0)
            return True
        except OSError:
            return False

    def send_signal(self, sig: int) -> None:
        os.kill(self.pid, sig)

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        deadline = time.time() + (timeout or 0.0)
        while self.alive() and time.time() < deadline:
            time.sleep(0.05)
        return {"owner": self.owner, "rc": None, "adopted": True}


def _handle_alive(handle: Any) -> bool:
    if handle is None:
        return False
    proc = getattr(handle, "proc", None)
    if proc is not None:
        return proc.poll() is None
    fn = getattr(handle, "alive", None)
    if callable(fn):
        try:
            return bool(fn())
        except OSError:
            return False
    thread = getattr(handle, "thread", None)
    return thread.is_alive() if thread is not None else False


def _handle_rc(handle: Any) -> Optional[int]:
    proc = getattr(handle, "proc", None)
    if proc is not None:
        return proc.returncode
    return getattr(handle, "returncode", None)


def _handle_pid(handle: Any) -> Optional[int]:
    proc = getattr(handle, "proc", None)
    if proc is not None:
        return proc.pid
    pid = getattr(handle, "pid", None)
    return int(pid) if pid is not None else None


def _handle_signal(handle: Any, sig: int) -> None:
    try:
        proc = getattr(handle, "proc", None)
        if proc is not None:
            proc.send_signal(sig)
            return
        fn = getattr(handle, "send_signal", None)
        if callable(fn):
            fn(sig)
        elif sig in (signal.SIGTERM, signal.SIGINT) and \
                callable(getattr(handle, "stop", None)):
            handle.stop()  # in-process test members
    except (OSError, ValueError):
        pass


@dataclass
class MemberSlot:
    """One supervised member slot (slot index is stable: a quarantined
    slot keeps its index and breaker while empty)."""

    k: int
    owner: str
    kind: str = "daemon"              # "daemon" | "listen"
    handle: Any = None
    started_at: float = 0.0
    adopted: bool = False
    stopping: bool = False            # SIGTERM sent (scale-down/shutdown)
    wedged: bool = False              # SIGKILLed for heartbeat staleness
    restarts: int = 0                 # lifetime crash restarts
    clean_exits: int = 0
    backoff_i: int = 0
    next_spawn_at: float = 0.0
    last_rc: Optional[int] = None

    def state(self, breaker: CrashLoopBreaker) -> str:
        if self.handle is not None:
            return "stopping" if self.stopping else "running"
        if breaker.state in ("open", "half_open"):
            return "quarantined"
        return "restarting" if self.next_spawn_at else "empty"


# -- options -----------------------------------------------------------------

@dataclass
class SupervisorOpts:
    """Knobs of one supervisor run (CLI flags map 1:1)."""

    queue_dir: str
    store_path: str
    min_daemons: int = 1
    # None -> the visible cards on cuda, the host's cores on cpu
    # (default_max_daemons); a default, not a cap
    max_daemons: Optional[int] = None
    owner_prefix: str = "fleet"
    owner: str = ""                     # supervisor id (default host-pid)
    tick_secs: float = 1.0
    heartbeat_secs: float = 2.0
    lease_ttl_secs: float = 30.0        # single-controller lease
    stale_secs: float = 60.0            # stale_heartbeat criterion
    # scaling policy
    scale_hold_ticks: int = 3           # hysteresis: ticks of persistence
    cooldown_secs: float = 15.0         # between scaling actions
    # restart policy
    backoff: BackoffPolicy = field(default_factory=lambda: BackoffPolicy(
        retries=1_000_000, base_secs=0.5, factor=2.0, max_secs=30.0,
        jitter=0.25))
    breaker_max_restarts: int = 3
    breaker_window_secs: float = 60.0
    breaker_quarantine_secs: float = 120.0
    breaker_probe_ok_secs: float = 5.0
    # member daemon knobs (FleetOpts pass-through)
    member_idle_exit_secs: Optional[float] = None   # None: never idle-exit
    member_poll_secs: float = 0.25
    member_lease_ttl_secs: float = 60.0
    member_heartbeat_secs: float = 1.0
    member_item_timeout_secs: Optional[float] = 3600.0
    topk: int = 3
    overrides: Dict[str, Any] = field(default_factory=dict)
    # test/CI chaos hook: replace the daemon argv ({owner} substituted)
    member_argv: Optional[List[str]] = None
    # optional listen-loop member
    listen_socket: Optional[str] = None
    listen_args: List[str] = field(default_factory=list)
    # periodic offline compaction (segmented stores; 0 disables)
    compact_interval_secs: float = 300.0
    # retention GC (0 disables)
    gc_interval_secs: float = 60.0
    gc_retention_secs: float = 3600.0
    # CI mode: exit once the queue is drained and every member has
    # idle-exited (or every slot is quarantined — the degraded exit)
    drain_exit: bool = False
    handle_signals: bool = True
    max_run_secs: Optional[float] = None  # hard wall-clock stop (tests)
    # where the members drain ("cuda" or "cpu"): the daemons' --device
    # and the listen member's --platform
    device: str = "cuda"


def _store_base(store_path: str) -> str:
    """The directory the serve loop's status/metrics docs live in: the
    segmented store dir itself, or the monolithic json's parent."""
    if os.path.isdir(store_path) or not store_path.endswith(".json"):
        return store_path
    return os.path.dirname(os.path.abspath(store_path))


# -- retention GC ------------------------------------------------------------

_METRICS_RE = re.compile(r"^metrics-(.+)-(\d+)\.json$")
_STATUS_RE = re.compile(r"^status-(.+)\.json$")
_ALERTS_RE = re.compile(r"^alerts-(.+)\.json$")


def gc_stale_artifacts(dirs: List[str], retention_secs: float,
                       now: Optional[float] = None,
                       keep_owners: Optional[List[str]] = None,
                       log: Optional[Callable[[str], None]] = None,
                       ) -> Dict[str, int]:
    """One retention sweep over the fleet's telemetry artifacts.

    Removed: status docs in ``state: stopped``/``interrupted`` whose
    heartbeat is older than ``retention_secs`` (they said goodbye
    properly and nobody follows them anymore), metric-snapshot rings
    whose owner has no status doc left, alert ledgers with nothing
    firing and no writes inside the window, and exemplar bundles older
    than the window.  NEVER removed: anything owned by ``keep_owners``
    (the live fleet), any status doc that did *not* stop — a stale
    live heartbeat is the ``stale_heartbeat`` page's evidence — and
    anything younger than the window.  Returns per-class removal
    counts."""
    now = time.time() if now is None else now
    keep = set(keep_owners or [])
    counts = {"status": 0, "metrics": 0, "alerts": 0, "exemplars": 0}

    def _unlink(path: str, what: str) -> None:
        try:
            os.unlink(path)
            counts[what] += 1
        except OSError:
            pass

    for d in dict.fromkeys(d for d in dirs if d and os.path.isdir(d)):
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        for name in names:
            m = _STATUS_RE.match(name)
            if not m or m.group(1) in keep:
                continue
            path = os.path.join(d, name)
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if doc.get("state") not in ("stopped", "interrupted"):
                continue
            try:
                age = now - float(doc.get("heartbeat_at") or 0)
            except (TypeError, ValueError):
                continue
            if age > retention_secs:
                _unlink(path, "status")
        # metric rings: orphaned once their owner's status doc is gone
        try:
            remaining = sorted(os.listdir(d))
        except OSError:
            remaining = []
        owners_left = {m.group(1)
                       for m in map(_STATUS_RE.match, remaining) if m}
        for name in names:
            m = _METRICS_RE.match(name)
            if not m or m.group(1) in keep or m.group(1) in owners_left:
                continue
            path = os.path.join(d, name)
            try:
                if now - os.path.getmtime(path) > retention_secs:
                    _unlink(path, "metrics")
            except OSError:
                pass
        for name in names:
            m = _ALERTS_RE.match(name)
            if not m or m.group(1) in keep:
                continue
            path = os.path.join(d, name)
            try:
                if now - os.path.getmtime(path) <= retention_secs:
                    continue
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            firing = any((e or {}).get("state") == "firing"
                         for e in (doc.get("alerts") or {}).values())
            if not firing:
                _unlink(path, "alerts")
        # exemplar bundles (serve/reqlog.py tail-sampled spans)
        for sub in (d, os.path.join(d, "exemplars"),
                    os.path.join(d, "reqlog", "exemplars")):
            if not os.path.isdir(sub):
                continue
            try:
                for name in sorted(os.listdir(sub)):
                    if not (name.startswith("exemplar-")
                            and name.endswith(".jsonl")):
                        continue
                    path = os.path.join(sub, name)
                    try:
                        if now - os.path.getmtime(path) > retention_secs:
                            _unlink(path, "exemplars")
                    except OSError:
                        pass
            except OSError:
                pass
    removed = sum(counts.values())
    if removed and log:
        log(f"supervisor: gc removed {removed} stale artifact(s) "
            f"({counts})")
    return counts


# -- the supervisor ----------------------------------------------------------

class Supervisor:
    """The controller (module docstring).  ``spawn(opts, slot)`` is
    injectable for tests — anything returning a handle with the
    :func:`_handle_alive`/``send_signal`` duck type; the default
    spawns real subprocess members via fleet.py's argv builder."""

    def __init__(self, opts: SupervisorOpts,
                 spawn: Optional[Callable[["SupervisorOpts", MemberSlot],
                                          Any]] = None,
                 log: Optional[Callable[[str], None]] = None):
        self.opts = opts
        self.owner = opts.owner or \
            f"supervisor-{socket.gethostname()}-{os.getpid()}"
        self._spawn_fn = spawn or _subprocess_member_spawn
        self._log_fn = log
        self.queue = WorkQueue(opts.queue_dir)
        self.store_base = _store_base(opts.store_path)
        self.max_daemons = int(opts.max_daemons
                               or default_max_daemons(opts.device))
        self.started_at = time.time()
        self.slots: Dict[int, MemberSlot] = {}
        self.listen_slot: Optional[MemberSlot] = None
        self.breakers: Dict[str, CrashLoopBreaker] = {}
        self.counters: Dict[str, int] = {}
        self.gc_counts: Dict[str, int] = {"status": 0, "metrics": 0,
                                          "alerts": 0, "exemplars": 0}
        self.all_owners: List[str] = []
        self.lease = LeaseFile(
            os.path.join(opts.queue_dir, LEASE_NAME), self.owner,
            ttl_secs=opts.lease_ttl_secs, log=self._log)
        self.status_path = os.path.join(opts.queue_dir, STATUS_NAME)
        self._snapshots = MetricsSnapshotWriter(
            opts.queue_dir, "supervisor")
        self._book = AlertBook(
            os.path.join(opts.queue_dir, ALERTS_NAME), owner="supervisor",
            log=self._log)
        self._stop = False
        self._signals = 0
        self._desired = max(1, opts.min_daemons)
        self._pending_desired: Optional[int] = None
        self._pending_ticks = 0
        self._last_scale_at = 0.0
        self._last_heartbeat_at = 0.0
        self._last_gc_at = time.time()
        self._last_compact_at = time.time()
        self._compact_handle: Optional[_ProcHandle] = None
        self._last_summary: Dict[str, Any] = {}
        self._scaling_state: Dict[str, Any] = {}
        self._ticks = 0
        self._prev_handlers: Dict[int, Any] = {}

    # -- plumbing ------------------------------------------------------------

    def _log(self, msg: str) -> None:
        if self._log_fn is not None:
            self._log_fn(msg)
        else:
            sys.stderr.write(msg + "\n")

    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        get_metrics().counter(f"supervisor.{name}").inc(n)

    def _breaker_of(self, owner: str) -> CrashLoopBreaker:
        br = self.breakers.get(owner)
        if br is None:
            o = self.opts
            br = self.breakers[owner] = CrashLoopBreaker(
                max_restarts=o.breaker_max_restarts,
                window_secs=o.breaker_window_secs,
                quarantine_secs=o.breaker_quarantine_secs,
                probe_ok_secs=o.breaker_probe_ok_secs)
        return br

    def _status_doc_of(self, slot: MemberSlot) -> Optional[Dict[str, Any]]:
        d = self.store_base if slot.kind == "listen" else \
            self.opts.queue_dir
        try:
            with open(os.path.join(d, f"status-{slot.owner}.json")) as f:
                doc = json.load(f)
            return doc if isinstance(doc, dict) else None
        except (OSError, ValueError):
            return None

    # -- member lifecycle ----------------------------------------------------

    def _spawn(self, slot: MemberSlot, now: float) -> None:
        br = self._breaker_of(slot.owner)
        slot.handle = self._spawn_fn(self.opts, slot)
        slot.started_at = now
        slot.next_spawn_at = 0.0
        slot.stopping = slot.wedged = False
        br.spawned(now)
        if slot.owner not in self.all_owners:
            self.all_owners.append(slot.owner)
        self._count("spawned")
        probe = " (breaker probe)" if br.state == "half_open" else ""
        self._log(f"supervisor: spawned {slot.owner} "
                  f"pid {_handle_pid(slot.handle)}{probe}")

    def _adopt(self, now: float) -> int:
        """Discover the predecessor's still-running members from their
        live status docs and adopt them instead of double-spawning."""
        adopted = 0
        pat = re.compile(
            rf"^status-({re.escape(self.opts.owner_prefix)}-(\d+))\.json$")
        try:
            names = sorted(os.listdir(self.opts.queue_dir))
        except OSError:
            names = []
        for name in names:
            m = pat.match(name)
            if not m:
                continue
            owner, k = m.group(1), int(m.group(2))
            slot = MemberSlot(k=k, owner=owner, kind="daemon")
            doc = self._status_doc_of(slot)
            if not self._adoptable(doc, now):
                continue
            slot.handle = AdoptedHandle(owner, int(doc["pid"]))
            slot.adopted = True
            slot.started_at = float(doc.get("started_at") or now)
            self.slots[k] = slot
            if owner not in self.all_owners:
                self.all_owners.append(owner)
            adopted += 1
            self._count("adopted")
            self._log(f"supervisor: adopted {owner} "
                      f"pid {doc['pid']} (uptime "
                      f"{doc.get('uptime_s', '?')}s)")
        if self.opts.listen_socket:
            slot = MemberSlot(k=-1, owner=self._listen_owner(),
                              kind="listen")
            doc = self._status_doc_of(slot)
            if self._adoptable(doc, now):
                slot.handle = AdoptedHandle(slot.owner, int(doc["pid"]))
                slot.adopted = True
                slot.started_at = float(doc.get("started_at") or now)
                self.listen_slot = slot
                adopted += 1
                self._count("adopted")
                self._log(f"supervisor: adopted {slot.owner} "
                          f"pid {doc['pid']}")
        return adopted

    def _adoptable(self, doc: Optional[Dict[str, Any]],
                   now: float) -> bool:
        if not doc or doc.get("state") in ("stopped", "interrupted"):
            return False
        try:
            hb_age = now - float(doc.get("heartbeat_at") or 0)
            pid = int(doc["pid"])
        except (KeyError, TypeError, ValueError):
            return False
        if hb_age > self.opts.stale_secs or pid == os.getpid():
            return False
        try:
            os.kill(pid, 0)
        except OSError:
            return False
        return True

    def _listen_owner(self) -> str:
        return f"{self.opts.owner_prefix}-listen"

    def _member_tick(self, slot: MemberSlot, now: float) -> None:
        """Reap/heal one slot: respawn after backoff, quarantine on a
        tripped breaker, SIGKILL a wedged heartbeat, reset backoff on a
        healthy run."""
        br = self._breaker_of(slot.owner)
        br.prune(now)
        if slot.handle is None:
            if slot.stopping or now < slot.next_spawn_at:
                return
            if self.opts.drain_exit and slot.kind == "daemon" and \
                    slot.clean_exits and not len(self.queue):
                return  # drained fleet: a clean-exited member stays down
            if br.allow_spawn(now):
                self._spawn(slot, now)
            return
        if _handle_alive(slot.handle):
            uptime = now - slot.started_at
            doc = self._status_doc_of(slot)
            hb_age = None
            if doc is not None:
                try:
                    hb_age = now - float(doc.get("heartbeat_at") or 0)
                except (TypeError, ValueError):
                    hb_age = None
            if not slot.stopping and not slot.wedged and \
                    hb_age is not None and hb_age > self.opts.stale_secs \
                    and uptime > self.opts.stale_secs:
                # alive but silent past the stale_heartbeat criterion:
                # wedged — kill it and let the death path restart it
                self._log(f"supervisor: {slot.owner} heartbeat "
                          f"{hb_age:.0f}s stale — killing wedged member")
                slot.wedged = True
                self._count("wedged")
                _handle_signal(slot.handle, signal.SIGKILL)
                return
            if uptime >= br.probe_ok_secs:
                slot.backoff_i = 0
                br.note_healthy(now)
            return
        # dead: clean exit, scale-down completion, or crash
        rc = _handle_rc(slot.handle)
        slot.last_rc = rc
        doc = self._status_doc_of(slot)
        said_goodbye = bool(doc) and \
            doc.get("state") in ("stopped", "interrupted")
        clean = (not slot.wedged) and \
            (rc == 0 or (rc is None and said_goodbye))
        slot.handle = None
        if slot.stopping:
            self._log(f"supervisor: {slot.owner} stopped (rc {rc})")
            self._reap_slot(slot)
            return
        if clean:
            slot.clean_exits += 1
            self._count("clean_exits")
            br.note_healthy(now)
            slot.backoff_i = 0
            slot.next_spawn_at = now + self.opts.tick_secs
            self._log(f"supervisor: {slot.owner} exited clean (rc {rc})")
            return
        slot.restarts += 1
        slot.wedged = False
        self._count("restarts")
        state = br.record_crash(now)
        if state == "open":
            slot.next_spawn_at = 0.0  # quarantined, not restarting
            self._count("quarantined")
            self._log(f"supervisor: {slot.owner} crash-looped "
                      f"({len(br.restarts)} restart(s) in "
                      f"{br.window_secs:.0f}s) — breaker OPEN, slot "
                      "quarantined")
            return
        delay = self.opts.backoff.delay(slot.backoff_i)
        slot.backoff_i += 1
        slot.next_spawn_at = now + delay
        self._log(f"supervisor: {slot.owner} died (rc {rc}) — restart "
                  f"in {delay:.1f}s (attempt {slot.restarts})")

    def _reap_slot(self, slot: MemberSlot) -> None:
        if slot.kind == "listen":
            self.listen_slot = None
        else:
            self.slots.pop(slot.k, None)

    # -- autoscaling ---------------------------------------------------------

    def _active_n(self) -> int:
        return sum(1 for s in self.slots.values()
                   if not s.stopping and
                   (s.handle is not None or s.next_spawn_at))

    def _poison_dominated(self) -> bool:
        poisoned = len(self.queue.poisoned())
        return poisoned > 0 and poisoned >= len(self.queue)

    def _scale_tick(self, now: float) -> None:
        # pass the IN-MEMORY open/half-open breaker owners explicitly: the
        # summary's own status-doc scan only sees breaker state as of the
        # last publish, and a member that crash-looped since then must not
        # count as drain capacity in the estimate this tick scales on
        bl = backlog_summary([self.store_base], [self.opts.queue_dir],
                             max_daemons=self.max_daemons,
                             quarantined_owners={
                                 o for o, b in self.breakers.items()
                                 if b.state in ("open", "half_open")})
        self._last_summary = bl
        desired = max(self.opts.min_daemons,
                      min(bl["recommended_daemons"], self.max_daemons))
        active = self._active_n()
        suppressed = False
        if desired > active and self._poison_dominated():
            desired, suppressed = active, True
        self._scaling_state = {
            "recommended": bl["recommended_daemons"],
            "desired": desired, "active": active,
            "suppressed_poison": suppressed,
            "last_action_at": self._last_scale_at or None}
        if desired == self._pending_desired:
            self._pending_ticks += 1
        else:
            self._pending_desired, self._pending_ticks = desired, 1
        if desired == active or \
                self._pending_ticks < self.opts.scale_hold_ticks or \
                now - self._last_scale_at < self.opts.cooldown_secs:
            return
        if desired > active:
            self._scale_up(now)
        else:
            self._scale_down(now)
        self._last_scale_at = now
        self._pending_ticks = 0

    def _scale_up(self, now: float) -> None:
        k = 0
        while k in self.slots:
            k += 1
        owner = f"{self.opts.owner_prefix}-{k}"
        slot = MemberSlot(k=k, owner=owner)
        self.slots[k] = slot
        self._count("scale_up")
        self._log(f"supervisor: scale-up -> spawning {owner} "
                  f"(active {self._active_n() - 1} < desired "
                  f"{self._pending_desired})")
        self._spawn(slot, now)

    def _scale_down(self, now: float) -> None:
        running = [s for s in self.slots.values()
                   if s.handle is not None and not s.stopping]
        if not running:
            return
        youngest = max(running, key=lambda s: s.started_at)
        youngest.stopping = True
        self._count("scale_down")
        self._log(f"supervisor: scale-down -> SIGTERM {youngest.owner} "
                  "(youngest; its in-flight item is lease-protected)")
        _handle_signal(youngest.handle, signal.SIGTERM)

    # -- periodic compaction -------------------------------------------------

    def _compact_tick(self, now: float) -> None:
        if self._compact_handle is not None:
            if _handle_alive(self._compact_handle):
                return
            rc = _handle_rc(self._compact_handle)
            self._count("compactions")
            if rc not in (0, None):
                self._count("compact_failures")
                self._log(f"supervisor: compact pass failed (rc {rc})")
            self._compact_handle = None
        if not self.opts.compact_interval_secs or \
                not os.path.isdir(self.opts.store_path) or \
                now - self._last_compact_at < \
                self.opts.compact_interval_secs:
            return
        self._last_compact_at = now
        cmd = [sys.executable, "-m", "tenzing_tpu_torch.serve", "compact",
               "--store", self.opts.store_path,
               "--owner", f"{self.owner}-compact"]
        self._compact_handle = _ProcHandle(
            f"{self.owner}-compact",
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True))
        self._log("supervisor: compact pass started")

    # -- heartbeat / telemetry -----------------------------------------------

    def _member_json(self, slot: MemberSlot) -> Dict[str, Any]:
        return {"slot": slot.k, "owner": slot.owner, "kind": slot.kind,
                "state": slot.state(self._breaker_of(slot.owner)),
                "pid": _handle_pid(slot.handle),
                "adopted": slot.adopted, "restarts": slot.restarts,
                "started_at": round(slot.started_at, 3) or None,
                "last_rc": slot.last_rc}

    def _write_status(self, state: str) -> None:
        now = time.time()
        members = [self._member_json(s)
                   for _, s in sorted(self.slots.items())]
        if self.listen_slot is not None:
            members.append(self._member_json(self.listen_slot))
        doc = {
            "version": SUPERVISOR_VERSION,
            "kind": "supervisor",
            "owner": self.owner,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "started_at": self.started_at,
            "heartbeat_at": now,
            "uptime_s": round(now - self.started_at, 1),
            "state": state,
            "n_members": self._active_n(),
            "desired_n": self._pending_desired or self._desired,
            "members": members,
            "breakers": {o: b.to_json()
                         for o, b in sorted(self.breakers.items())
                         if b.state != "closed" or b.restarts},
            "scaling": dict(self._scaling_state,
                            cooldown_s=self.opts.cooldown_secs,
                            hold_ticks=self.opts.scale_hold_ticks,
                            min_daemons=self.opts.min_daemons,
                            max_daemons=self.max_daemons),
            "backlog": self._last_summary or None,
            "counters": dict(self.counters),
            "gc": dict(self.gc_counts),
        }
        try:
            atomic_dump_json(self.status_path, doc, prefix=".status.")
        except OSError as e:
            self._log(f"supervisor: status write failed ({e})")
        try:
            self._snapshots.write(state=state, extra={
                "counters": dict(self.counters),
                "n_members": self._active_n(),
                "uptime_s": round(now - self.started_at, 1)})
        except OSError:
            pass
        # the alert ledger: open/half-open breakers fire the
        # supervisor_crash_loop page until the slot recovers
        active = [Alert(
            "supervisor_crash_loop", owner, "page",
            {"state": b.state, "restarts": len(b.restarts)},
            {"max_restarts": b.max_restarts, "window_s": b.window_secs},
            f"member {owner!r} crash-looped; breaker {b.state}")
            for owner, b in sorted(self.breakers.items())
            if b.state in ("open", "half_open")]
        try:
            self._book.apply(active, now=now)
        except OSError:
            pass

    def _gc_tick(self, now: float) -> None:
        if not self.opts.gc_interval_secs or \
                now - self._last_gc_at < self.opts.gc_interval_secs:
            return
        self._last_gc_at = now
        keep = ["supervisor", self.owner] + \
            [s.owner for s in self.slots.values()]
        if self.listen_slot is not None:
            keep.append(self.listen_slot.owner)
        counts = gc_stale_artifacts(
            [self.opts.queue_dir, self.store_base],
            self.opts.gc_retention_secs, now=now, keep_owners=keep,
            log=self._log)
        for k, v in counts.items():
            if v:
                self.gc_counts[k] += v
                self._count(f"gc.{k}", v)

    # -- drain-exit / shutdown -----------------------------------------------

    def _drained(self) -> bool:
        """drain-exit: the queue is empty (no live work, no leases) and
        no member is running — either every slot idle-exited clean, or
        what remains is quarantined (the degraded exit)."""
        if not self.opts.drain_exit:
            return False
        if len(self.queue) or self.queue.leases():
            # members still draining (or a crashed member's lease is
            # aging toward reclaim — not drained either way)
            running = any(s.handle is not None
                          for s in self.slots.values())
            restartable = any(
                s.handle is None and not s.stopping and
                self._breaker_of(s.owner).state == "closed"
                for s in self.slots.values())
            if running or restartable:
                return False
            # nothing left that could drain it: all quarantined
            return bool(self.slots) and not running
        return not any(s.handle is not None or
                       (s.next_spawn_at and not s.clean_exits)
                       for s in self.slots.values())

    def _shutdown_members(self, grace_secs: float = 20.0) -> None:
        stoppers = [s for s in self.slots.values()
                    if s.handle is not None]
        if self.listen_slot is not None and \
                self.listen_slot.handle is not None:
            stoppers.append(self.listen_slot)
        for s in stoppers:
            s.stopping = True
            _handle_signal(s.handle, signal.SIGTERM)
        deadline = time.time() + grace_secs
        for s in stoppers:
            while _handle_alive(s.handle) and time.time() < deadline:
                time.sleep(0.1)
            if _handle_alive(s.handle):
                self._log(f"supervisor: {s.owner} ignored SIGTERM — "
                          "killing")
                _handle_signal(s.handle, signal.SIGKILL)
        if self._compact_handle is not None and \
                _handle_alive(self._compact_handle):
            _handle_signal(self._compact_handle, signal.SIGTERM)

    def _install_signals(self) -> None:
        if not self.opts.handle_signals:
            return

        def handler(signum, frame):
            self._signals += 1
            self._stop = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):
                pass

    def _restore_signals(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()

    def stop(self) -> None:
        """Programmatic twin of SIGTERM."""
        self._stop = True

    # -- the run loop --------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        """Supervise until stopped, drained (``drain_exit``), out of time
        (``max_run_secs``) or out of the lease; returns the summary the CLI
        prints.  Raises before it claims the lease when the device is
        absent: without a card a ``cuda`` fleet spawns nothing."""
        o = self.opts
        if o.device == "cuda" and not cuda_cards():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to drain on the CPU")
        now = time.time()
        if self.lease.claim(extra={"kind": "supervisor"}) is None:
            self._log("supervisor: controller lease is held by a live "
                      "rival — standing down")
            return self._summary("lease_held")
        self._install_signals()
        reason = "stopped"
        try:
            adopted = self._adopt(now)
            if adopted:
                self._log(f"supervisor: adopted {adopted} live "
                          "member(s) from a predecessor")
            # fill up to min_daemons with fresh members (adopted slots
            # count — adoption must not double-spawn)
            while self._active_n() < max(1, o.min_daemons):
                self._scale_up(time.time())
            if o.listen_socket and self.listen_slot is None:
                self.listen_slot = MemberSlot(
                    k=-1, owner=self._listen_owner(), kind="listen")
                self._spawn(self.listen_slot, time.time())
            self._write_status("supervising")
            while not self._stop:
                now = time.time()
                self._ticks += 1
                if not self.lease.renew():
                    self._count("lease_lost")
                    self._log("supervisor: lease renewal lost — a "
                              "successor owns the fleet; standing down "
                              "without touching its members")
                    reason = "lease_lost"
                    break
                for _, slot in sorted(self.slots.items()):
                    self._member_tick(slot, now)
                if self.listen_slot is not None:
                    self._member_tick(self.listen_slot, now)
                self._scale_tick(now)
                self._compact_tick(now)
                self._gc_tick(now)
                if now - self._last_heartbeat_at >= o.heartbeat_secs:
                    self._last_heartbeat_at = now
                    self._write_status("supervising")
                if self._drained():
                    reason = "drained"
                    break
                if o.max_run_secs is not None and \
                        now - self.started_at >= o.max_run_secs:
                    reason = "max_run_secs"
                    break
                time.sleep(o.tick_secs)
            else:
                reason = "signal"
        finally:
            self._restore_signals()
        if reason != "lease_lost":
            # successor owns the members on lease loss; otherwise they
            # are ours to stop
            if reason in ("signal", "stopped", "max_run_secs",
                          "drained"):
                self._shutdown_members()
            self._write_status("stopped")
            self.lease.release()
        return self._summary(reason)

    def _summary(self, reason: str) -> Dict[str, Any]:
        audit = audit_completions(self.opts.queue_dir,
                                  sorted(self.all_owners)) \
            if self.all_owners else {"completed_by": {},
                                     "double_runs": {},
                                     "audit_complete": True}
        doc = {
            "kind": "supervisor",
            "version": SUPERVISOR_VERSION,
            "owner": self.owner,
            "reason": reason,
            "wall_s": round(time.time() - self.started_at, 3),
            "ticks": self._ticks,
            "members": {s.owner: {"restarts": s.restarts,
                                  "clean_exits": s.clean_exits,
                                  "adopted": s.adopted,
                                  "last_rc": s.last_rc}
                        for s in list(self.slots.values()) +
                        ([self.listen_slot] if self.listen_slot else [])},
            "breakers": {o: b.to_json()
                         for o, b in sorted(self.breakers.items())},
            "counters": dict(self.counters),
            "gc": dict(self.gc_counts),
            "queue_after": len(self.queue),
            "double_runs": audit["double_runs"],
            "completed_by": audit["completed_by"],
            "audit_complete": audit["audit_complete"],
            # the members' device, and whether this process ever created a
            # CUDA context (it must not: the card is the members')
            "device": self.opts.device,
            "cuda_initialized": cuda_initialized(),
        }
        if audit["double_runs"]:
            self._log(f"supervisor: DOUBLE RUNS detected: "
                      f"{audit['double_runs']}")
        return doc


def _subprocess_member_spawn(opts: SupervisorOpts,
                             slot: MemberSlot) -> _ProcHandle:
    """The production spawner: fleet.py's daemon argv (one source of
    truth) with the supervisor's lifetime knobs, or the listen loop's argv
    for the ``listen`` slot."""
    if slot.kind == "listen":
        cmd = [sys.executable, "-m", "tenzing_tpu_torch.serve", "listen",
               "--store", opts.store_path, "--queue", opts.queue_dir,
               "--socket", opts.listen_socket or "",
               "--owner", slot.owner,
               "--platform", opts.device] + list(opts.listen_args)
    elif opts.member_argv:
        cmd = [a.replace("{owner}", slot.owner)
               for a in opts.member_argv]
    else:
        fo = FleetOpts(
            queue_dir=opts.queue_dir, store_path=opts.store_path,
            owner_prefix=opts.owner_prefix,
            idle_exit_secs=opts.member_idle_exit_secs
            if opts.member_idle_exit_secs is not None else 0.0,
            poll_secs=opts.member_poll_secs,
            lease_ttl_secs=opts.member_lease_ttl_secs,
            heartbeat_secs=opts.member_heartbeat_secs,
            item_timeout_secs=opts.member_item_timeout_secs,
            topk=opts.topk, overrides=opts.overrides, device=opts.device)
        cmd = _daemon_cmd(fo, slot.k)
        if opts.member_idle_exit_secs is None:
            # a supervised member never idle-exits on its own: strip the
            # flag _daemon_cmd always emits
            i = cmd.index("--idle-exit")
            cmd = cmd[:i] + cmd[i + 2:]
    # a session of its own: a signal to the supervisor's group does not
    # reach the members (the supervisor owns their shutdown), and killpg of
    # one member takes its drain child with it
    return _ProcHandle(slot.owner,
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE,
                                        text=True, start_new_session=True))


def supervisor_exit_code(doc: Dict[str, Any]) -> int:
    """The CLI's verdict: the lease codes first, then the exactly-once
    contract and the breakers: a fleet that ends with a slot quarantined,
    or with a double run, does not report success."""
    if doc.get("reason") == "lease_held":
        return RC_LEASE_HELD
    if doc.get("reason") == "lease_lost":
        return RC_LEASE_LOST
    if doc.get("double_runs"):
        return RC_DEGRADED
    if any((b or {}).get("state") in ("open", "half_open")
           for b in (doc.get("breakers") or {}).values()):
        return RC_DEGRADED
    return RC_OK


def main(argv: Optional[List[str]] = None) -> int:
    from tenzing_tpu_torch.serve.daemon import parse_override

    ap = argparse.ArgumentParser(
        prog="python -m tenzing_tpu_torch.serve.supervisor",
        description="Fleet supervisor: an autoscaling drain fleet with "
                    "crash-loop breakers, adoption on restart and "
                    "graceful degradation.")
    ap.add_argument("--queue", required=True, metavar="DIR")
    ap.add_argument("--store", required=True, metavar="PATH")
    ap.add_argument("--min-daemons", type=int, default=1)
    ap.add_argument("--max-daemons", type=int, default=None,
                    help="fleet ceiling (default: the visible cards on "
                         "cuda, the host's cores on cpu; shared with the "
                         "backlog recommendation clamp)")
    ap.add_argument("--owner-prefix", default="fleet")
    ap.add_argument("--owner", default=None,
                    help="supervisor id (default host-pid)")
    ap.add_argument("--tick", type=float, default=1.0, metavar="SECS")
    ap.add_argument("--heartbeat", type=float, default=2.0,
                    metavar="SECS")
    ap.add_argument("--lease-ttl", type=float, default=30.0,
                    metavar="SECS",
                    help="single-controller lease TTL (a successor "
                         "reclaims after this much supervisor silence)")
    ap.add_argument("--stale-secs", type=float, default=60.0,
                    help="member heartbeat staleness before a wedged "
                         "member is killed (the stale_heartbeat "
                         "criterion)")
    ap.add_argument("--scale-hold-ticks", type=int, default=3,
                    help="hysteresis: ticks a scaling desire must "
                         "persist before acting")
    ap.add_argument("--cooldown", type=float, default=15.0,
                    metavar="SECS", help="between scaling actions")
    ap.add_argument("--breaker-max-restarts", type=int, default=3)
    ap.add_argument("--breaker-window", type=float, default=60.0,
                    metavar="SECS")
    ap.add_argument("--breaker-quarantine", type=float, default=120.0,
                    metavar="SECS")
    ap.add_argument("--backoff-base", type=float, default=0.5,
                    metavar="SECS")
    ap.add_argument("--backoff-max", type=float, default=30.0,
                    metavar="SECS")
    ap.add_argument("--member-idle-exit", type=float, default=None,
                    metavar="SECS",
                    help="members exit after idling this long (default: "
                         "never — the supervisor owns their lifetime; "
                         "set it with --drain-exit for CI)")
    ap.add_argument("--member-poll", type=float, default=0.25,
                    metavar="SECS")
    ap.add_argument("--member-lease-ttl", type=float, default=60.0,
                    metavar="SECS")
    ap.add_argument("--member-heartbeat", type=float, default=1.0,
                    metavar="SECS")
    ap.add_argument("--item-timeout", type=float, default=3600.0,
                    metavar="SECS")
    ap.add_argument("--topk", type=int, default=3)
    ap.add_argument("--override", action="append", default=[],
                    metavar="K=V",
                    help="request-budget override for every member "
                         "(serve/daemon.py semantics)")
    ap.add_argument("--listen-socket", default=None, metavar="PATH",
                    help="also supervise a serve listen loop on this "
                         "unix socket")
    ap.add_argument("--listen-arg", action="append", default=[],
                    metavar="ARG",
                    help="extra argv appended to the listen member "
                         "(repeatable, e.g. --listen-arg=--busy-poll-us "
                         "--listen-arg=50)")
    ap.add_argument("--compact-interval", type=float, default=300.0,
                    metavar="SECS",
                    help="periodic offline compaction pass over a "
                         "segmented store (0 disables)")
    ap.add_argument("--gc-interval", type=float, default=60.0,
                    metavar="SECS")
    ap.add_argument("--gc-retention", type=float, default=3600.0,
                    metavar="SECS",
                    help="stale-artifact retention window (0 disables "
                         "the sweep)")
    ap.add_argument("--drain-exit", action="store_true",
                    help="exit once the queue is drained and every "
                         "member idle-exited (CI mode)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the members drain (default: the card; "
                         "without one the supervisor exits 1 before it "
                         "spawns anything)")
    ap.add_argument("--max-run-secs", type=float, default=None,
                    help=argparse.SUPPRESS)
    # chaos hook for tests and drills: replace the member daemon argv
    # entirely ({owner} substituted); not for operators
    ap.add_argument("--member-argv", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        overrides = dict(parse_override(s) for s in args.override)
    except ValueError as e:
        ap.error(str(e))
    member_argv = None
    if args.member_argv:
        try:
            member_argv = json.loads(args.member_argv)
            assert isinstance(member_argv, list)
        except (ValueError, AssertionError):
            ap.error("--member-argv: expected a JSON list of strings")
    opts = SupervisorOpts(
        queue_dir=args.queue, store_path=args.store,
        min_daemons=args.min_daemons, max_daemons=args.max_daemons,
        owner_prefix=args.owner_prefix, owner=args.owner or "",
        tick_secs=args.tick, heartbeat_secs=args.heartbeat,
        lease_ttl_secs=args.lease_ttl, stale_secs=args.stale_secs,
        scale_hold_ticks=args.scale_hold_ticks,
        cooldown_secs=args.cooldown,
        backoff=BackoffPolicy(retries=1_000_000,
                              base_secs=args.backoff_base,
                              factor=2.0, max_secs=args.backoff_max,
                              jitter=0.25),
        breaker_max_restarts=args.breaker_max_restarts,
        breaker_window_secs=args.breaker_window,
        breaker_quarantine_secs=args.breaker_quarantine,
        member_idle_exit_secs=args.member_idle_exit,
        member_poll_secs=args.member_poll,
        member_lease_ttl_secs=args.member_lease_ttl,
        member_heartbeat_secs=args.member_heartbeat,
        member_item_timeout_secs=args.item_timeout,
        topk=args.topk, overrides=overrides, member_argv=member_argv,
        listen_socket=args.listen_socket, listen_args=args.listen_arg,
        compact_interval_secs=args.compact_interval,
        gc_interval_secs=args.gc_interval,
        gc_retention_secs=args.gc_retention,
        drain_exit=args.drain_exit, max_run_secs=args.max_run_secs,
        device=args.device)
    if args.device == "cuda" and not cuda_cards():
        sys.stderr.write("supervisor: CUDA is not available; pass --device "
                         "cpu to drain on the CPU\n")
        return RC_DEGRADED
    doc = Supervisor(opts).run()
    sys.stdout.write(json.dumps(doc) + "\n")
    return supervisor_exit_code(doc)


if __name__ == "__main__":
    sys.exit(main())
