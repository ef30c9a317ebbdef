"""The drain daemon: leased cold-queue claims, crash-resume, poison
quarantine — the half of the serve → search → serve loop that measures.

Counterpart of ``tenzing_tpu/serve/daemon.py``, with its item, lease,
status and failure file formats.  The resolver's cold tier enqueues
checkpointed :class:`~tenzing_tpu_torch.bench.driver.DriverRequest` work
items (serve/store.py ``WorkQueue``); this daemon drains each through
``bench/driver.py:run`` on its device (``--device``, default ``cuda``) and
re-warms the store from the run's own database under the fingerprint of
that platform, so the next query of the fingerprint answers exact with no
compile.  Each record it merges names the device that measured it in its
provenance (``device``: the card's name, or ``"cpu"``).  It claims only the
items queued under its own platform's fingerprint (:func:`item_platform`);
another platform's item stays in the queue, unclaimed.

* **Leased claims** (serve/lease.py) — a worker claims ``work-<exact>.json``
  by publishing ``lease-<exact>.json`` (hard link: one of any number of
  rivals wins); a heartbeat thread renews its mtime; an expired lease is
  reclaimed by rename, so a SIGKILLed worker's item is never lost and two
  daemons never drain one item twice.  A renew that finds the lease
  reclaimed stops the drain.
* **Crash-resume** — each item drains under its ``SearchCheckpoint``
  directory (``ckpt-<exact>/``), whose journal is appended as each
  measurement lands and fenced by the lease's epoch (``$TENZING_FENCE``),
  so a successor resumes with nothing measured twice.
* **Classified failures** (fault/errors.py ``classify_error``) — transients
  retry through fault/backoff.py; a per-item watchdog kills a hung
  subprocess drain; ``device_lost`` (every CUDA error) stops the daemon
  with exit code 1; deterministic failures accumulate in
  ``fail-<exact>.json`` and after ``max_failures`` move the item to the
  poison quarantine (``poison-<exact>.json``).
* **Exactly-once effect** — item and lease are deleted only after the store
  merge lands; a crash in between re-drains, but the journal answers its
  measurements and the merge is idempotent.

Graceful SIGTERM / SIGINT, ``--once`` / ``--max-items`` / ``--idle-exit``,
a status document (``status-<owner>.json``) and ``daemon.*`` telemetry as
the reference.  Without the card a ``cuda`` daemon raises before it claims
anything (:meth:`DrainDaemon.check_device`); nothing falls back to the CPU.

Run it::

    python -m tenzing_tpu_torch.serve.daemon --queue QDIR --store S.json
    python -m tenzing_tpu_torch.serve.daemon --queue QDIR --store S.json \
        --device cpu --in-process --once

The default runner drains each item in a **subprocess** (``--exec-item``):
the watchdog can kill a hang, a sticky CUDA error dies with the child, and
a SIGKILL of the daemon's process group takes the drain with it.
``--in-process`` trades that for no process overhead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from tenzing_tpu_torch.fault.backoff import BackoffPolicy, retry_call
from tenzing_tpu_torch.fault.checkpoint import (
    FENCE_ENV,
    atomic_write_json,
    read_checked_json,
)
from tenzing_tpu_torch.fault.errors import (
    DeterministicScheduleError,
    DeviceLostError,
    FaultClass,
    FencedWriteError,
    MeasurementTimeout,
    StoreReadonlyError,
    TransientError,
    classify_error,
    is_transient_io,
    is_unwritable_io,
)
from tenzing_tpu_torch.obs import context as obs_context
from tenzing_tpu_torch.obs.metrics import MetricsSnapshotWriter, get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.serve.lease import LeaseFile
from tenzing_tpu_torch.serve.store import (
    WorkQueue,
    mark_store_unwritable,
    probe_store_writable,
    store_readonly,
)
from tenzing_tpu_torch.utils.atomic import atomic_dump_json

STATUS_VERSION = 1
FAIL_VERSION = 1
# set (to the daemon's choice) when the daemon itself traces: the drain
# child reads it and archives its own bundle under the item's checkpoint
# directory, linked to the item's trace
TRACE_CHILD_ENV = "TENZING_TRACE_CHILD"
# a long-lived daemon visits items forever; every in-memory / on-disk
# accumulation is bounded (consumers only ever read the tail anyway)
HISTORY_CAP = 200
FAIL_ATTEMPT_CAP = 50


class _Interrupted(BaseException):
    """Control flow only: the daemon was asked to stop mid-drain (the
    child has checkpointed and died); never a failure verdict."""


class _LeaseLost(BaseException):
    """Control flow only: the heartbeat found our lease reclaimed (or
    gone) — the item belongs to someone else now; abandon it without
    merging and without releasing what is no longer ours."""


def drain_checkpoint_of(payload: Dict[str, Any], item_path: str) -> str:
    """The item's checkpoint directory: the enqueue-time suggestion, or
    (for hand-written items that lack one) the queue's own convention
    next to the item file."""
    ckpt = payload.get("checkpoint")
    if ckpt:
        return ckpt
    return os.path.join(os.path.dirname(os.path.abspath(item_path)),
                        f"ckpt-{WorkQueue.exact_of(item_path)}")


def item_platform(payload: Dict[str, Any]) -> Optional[str]:
    """The platform of the fingerprint an item was queued under (None for
    an item whose fingerprint names none, as the reference's do)."""
    fp = payload.get("fingerprint")
    return fp.get("platform") if isinstance(fp, dict) else None


def drain_csv_path(ckpt_dir: str) -> str:
    """Where the drain's recorded database lands (the re-warm source)."""
    return os.path.join(ckpt_dir, "drain.csv")


def drain_verdict_path(ckpt_dir: str) -> str:
    """Where the drain's driver-JSON verdict lands (merge provenance,
    and the child→parent error report on failure)."""
    return os.path.join(ckpt_dir, "verdict.json")


def visible_cards(visible: Optional[str], present: int) -> int:
    """The cards the CUDA runtime exposes of ``present`` under
    ``CUDA_VISIBLE_DEVICES`` = ``visible``: all of them when it is unset,
    else the entries before the first one that names no card (an index
    that is negative or out of range, or not an index: ``-1`` hides every
    card); a UUID (``GPU-...``, ``MIG-...``) counts as one."""
    if visible is None:
        return present
    n = 0
    for entry in visible.split(","):
        entry = entry.strip()
        if not entry.startswith(("GPU-", "MIG-")):
            try:
                index = int(entry)
            except ValueError:
                break
            if not 0 <= index < present:
                break
        n += 1
    return min(n, present)


def cuda_cards() -> int:
    """The number of CUDA cards this process may use, without torch and
    without a CUDA context (:func:`visible_cards` over NVML's count): a
    launcher that only spawns and watches daemons leaves the card to them.
    0 where the driver's library is absent (a machine with no card).  A
    daemon itself checks its device with :meth:`DrainDaemon.check_device`."""
    import ctypes

    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return 0
    count = ctypes.c_uint(0)
    if nvml.nvmlInit_v2() != 0:
        return 0
    try:
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            return 0
    finally:
        nvml.nvmlShutdown()
    return visible_cards(os.environ.get("CUDA_VISIBLE_DEVICES"),
                         int(count.value))


def parse_override(spec: str) -> tuple:
    """``key=value`` → (key, typed value): values parse as JSON when they
    can (``8`` → int, ``true`` → bool, ``null`` → None) and stay strings
    otherwise — the same forgiving rule for the CLI and work-item tests."""
    if "=" not in spec:
        raise ValueError(f"override {spec!r} is not key=value")
    key, _, raw = spec.partition("=")
    try:
        return key, json.loads(raw)
    except ValueError:
        return key, raw


def apply_overrides(request: Dict[str, Any],
                    overrides: Optional[Dict[str, Any]]):
    """The item's request with budget overrides applied, **identity
    guarded**: an override may change search budgets (``mcts_iters``,
    ``climb_budget``, …) but must not change what the request *is* — the
    merged record is keyed by the original request's fingerprint, so an
    override that moves the fingerprint would warm the wrong slot.
    Returns the effective :class:`DriverRequest`."""
    from tenzing_tpu_torch.bench.driver import DriverConfigError, DriverRequest

    known = {f.name for f in dataclasses.fields(DriverRequest)}
    req_d = dict(request)
    for k, v in (overrides or {}).items():
        if k not in known:
            raise DriverConfigError(f"unknown override field {k!r}")
        req_d[k] = v
    req = DriverRequest(**req_d)
    if overrides:
        from tenzing_tpu_torch.serve.fingerprint import fingerprint_of

        try:
            base_digest = fingerprint_of(DriverRequest(**request)).exact_digest
            new_digest = fingerprint_of(req).exact_digest
        except DriverConfigError:
            raise
        except Exception:
            # identity not computable here (e.g. a malformed workload):
            # let run() raise its own config error, classified normally
            return req
        if base_digest != new_digest:
            raise DriverConfigError(
                "override changes the request fingerprint "
                f"({base_digest} -> {new_digest}); budget fields only")
    return req


def exec_item(payload: Dict[str, Any], item_path: str,
              overrides: Optional[Dict[str, Any]] = None,
              device: str = "cuda") -> Dict[str, Any]:
    """The drain step: ``run(DriverRequest(**item["request"]),
    device=device)`` under the item's checkpoint directory, resuming from
    any journal a previous (killed) drain left, dumping the recorded
    database the re-warm mines.  The device is the daemon's, never the
    request's, so it cannot move the item's fingerprint.  Returns the
    driver verdict dict; raises a classified error on failure (a verdict
    that carries an ``error`` is a :class:`TransientError`, not an
    answer)."""
    # adopt the originating query's trace context — the envelope copy
    # first (SIGKILL-survivable: a successor daemon re-reads it from
    # disk), the env var as the live-parent fallback — as the process
    # default, so every span the drive emits (any thread) links back to
    # the query.  Restored on the way out: the in-process runner drains
    # many items in one process, and item N's context must not bleed
    # into item N+1.
    ctx = (obs_context.from_json(payload.get("trace"))
           or obs_context.from_env())
    prev_ctx = obs_context.set_process_default(ctx) if ctx is not None \
        else None
    try:
        return _exec_item(payload, item_path, overrides, device)
    finally:
        if ctx is not None:
            obs_context.set_process_default(prev_ctx)


def _exec_item(payload: Dict[str, Any], item_path: str,
               overrides: Optional[Dict[str, Any]],
               device: str) -> Dict[str, Any]:
    from tenzing_tpu_torch.bench.driver import run

    req = apply_overrides(payload["request"], overrides)
    ckpt = drain_checkpoint_of(payload, item_path)
    os.makedirs(ckpt, exist_ok=True)
    req.checkpoint = ckpt
    if os.environ.get(TRACE_CHILD_ENV) and not req.trace_out:
        # the tracing daemon asked its children to archive their own
        # bundles: one directory per item, next to the drain journal
        req.trace_out = os.path.join(ckpt, "trace")
    # resume iff a previous drain already journaled state there: the
    # successor of a SIGKILLed worker replays every landed measurement
    # instead of re-paying the device (fault/checkpoint.py)
    req.resume = (os.path.exists(os.path.join(ckpt, "measurements.jsonl"))
                  or os.path.exists(os.path.join(ckpt, "state.json")))
    if not req.dump_csv:
        req.dump_csv = drain_csv_path(ckpt)
    verdict = run(req, device=device).verdict
    if "error" in verdict:
        raise TransientError(verdict["error"])
    return verdict


def _exec_item_main(item_path: str, out_path: str,
                    overrides: Optional[Dict[str, Any]], device: str) -> int:
    """The subprocess entry (``--exec-item``): drain one item, write the
    verdict, with the drain's kernel launches under ``launches``, (or a
    classified error report) to ``out_path``.  Exit 0 on
    success; 3 on failure — the parent reads the report and re-raises the
    class, so the daemon's retry/poison policy never depends on parsing
    stderr."""
    # the report write retries transients in-process (same shared-backoff
    # rule as store and checkpoint writes): this is the child's ONLY way
    # to tell the parent what happened, a fresh child replays the same
    # injected-fault schedule, and "exited with no error report" is
    # classified deterministic — a drained item would poison on a
    # bounded write burst after the work already succeeded
    def report(doc: Dict[str, Any]) -> None:
        retry_call(
            lambda: atomic_dump_json(out_path, doc, prefix=".verdict."),
            policy=BackoffPolicy(retries=4, base_secs=0.05, factor=2.0,
                                 max_secs=0.5),
            retry_on=is_transient_io, where="serve.drain.report")

    from tenzing_tpu_torch.ops import kernel_lib

    try:
        payload = read_checked_json(item_path)
        kernel_lib.reset_launch_counts()
        verdict = exec_item(payload, item_path, overrides, device)
        # the kernels this drain launched (ops/kernel_lib.py launch counts;
        # the child drains one item, so its counts are the drain's)
        verdict["launches"] = {k: n for k, n in
                               kernel_lib.launch_counts().items() if n}
    except BaseException as e:
        report({
            "error": str(e)[:2000],
            "error_class": classify_error(e),
            "error_type": type(e).__name__,
        })
        return 3
    report(verdict)
    return 0


@dataclass
class DaemonOpts:
    """Knobs of one :class:`DrainDaemon` (CLI flags map 1:1)."""

    queue_dir: str
    store_path: str
    owner: str = ""                  # default: <host>-<pid>
    tenant: str = "daemon"
    lease_ttl_secs: float = 60.0     # mtime older than this = expired
    heartbeat_secs: float = 5.0      # lease renewal + status rewrite
    poll_secs: float = 2.0           # queue re-scan interval when idle
    item_timeout_secs: Optional[float] = 3600.0  # per-attempt watchdog
    retries: int = 2                 # transient retries per item visit
    backoff_base_secs: float = 1.0
    max_failures: int = 3            # deterministic failures before poison
    stop_grace_secs: float = 20.0    # SIGINT→SIGKILL window on shutdown
    once: bool = False               # one scan pass, then exit
    max_items: Optional[int] = None  # stop after draining this many
    idle_exit_secs: Optional[float] = None  # exit after idling this long
    topk: int = 3                    # winners admitted per re-warm
    train: bool = False              # retrain the near-tier surrogate
    in_process: bool = False         # no subprocess, no hard watchdog
    status_path: Optional[str] = None  # default: <queue>/status-<owner>.json
    model_path: Optional[str] = None
    handle_signals: bool = True      # SIGTERM/SIGINT graceful stop
    overrides: Dict[str, Any] = field(default_factory=dict)
    # enable tracing and write this daemon's JSONL bundle here on exit;
    # drain children then archive their own bundles under each item's
    # ckpt-<exact>/trace/
    trace_out: Optional[str] = None
    metrics_ring: int = 8            # metric-snapshot ring per owner
    # where drains run and what the store's records are for: "cuda" (the
    # card; the daemon refuses to start without one) or "cpu"
    device: str = "cuda"


class DrainDaemon:
    """See module docstring.  ``runner(item_path, payload, timeout)`` is
    injectable for tests; the default is the subprocess runner (or the
    in-process one under ``opts.in_process``)."""

    def __init__(self, opts: DaemonOpts,
                 runner: Optional[Callable] = None,
                 log: Optional[Callable[[str], None]] = None):
        self.opts = opts
        self.owner = opts.owner or f"{socket.gethostname()}-{os.getpid()}"
        self.queue = WorkQueue(opts.queue_dir)
        self._log_fn = log
        self._runner = runner or (self._run_in_process if opts.in_process
                                  else self._run_subprocess)
        self.status_path = opts.status_path or os.path.join(
            opts.queue_dir, f"status-{self.owner}.json")
        # streaming metric snapshots next to the status doc (bounded
        # ring, obs/metrics.py) — written on every status rewrite, read
        # by a status reader beside the status document
        self._snapshots = MetricsSnapshotWriter(
            os.path.dirname(os.path.abspath(self.status_path)), self.owner,
            ring=opts.metrics_ring)
        self.counters: Dict[str, int] = {
            k: 0 for k in ("claimed", "completed", "retried", "poisoned",
                           "reclaimed", "released", "failed_transient",
                           "failed_deterministic", "lease_lost", "fenced",
                           "store_unwritable", "signals")}
        self.history: List[Dict[str, Any]] = []
        self.device_lost = False
        self.started_at = time.time()
        self._stop = threading.Event()
        self._lease_lost = threading.Event()
        self._lease: Optional[LeaseFile] = None
        self._child: Optional[subprocess.Popen] = None
        self._depth = 0
        self._prev_handlers: Dict[int, Any] = {}

    def _log(self, msg: str) -> None:
        if self._log_fn is not None:
            self._log_fn(msg)
        else:
            sys.stderr.write(f"daemon[{self.owner}]: {msg}\n")

    # -- lease protocol (serve/lease.py — THE shared implementation) ---------
    def _claim(self, exact: str) -> Optional[str]:
        """Claim ``exact``'s item; None when a rival holds a fresh lease
        or wins either race (serve/lease.py for the protocol)."""
        lease = LeaseFile(self.queue.lease_path_for(exact), self.owner,
                          ttl_secs=self.opts.lease_ttl_secs)
        info = lease.claim(extra={"exact": exact})
        if info is None:
            return None
        if info.reclaimed:
            self.counters["reclaimed"] += 1
            get_metrics().counter("daemon.reclaimed").inc()
            tr = get_tracer()
            if tr.enabled:
                tr.event("daemon.reclaim", exact=exact,
                         prev_owner=info.prev_owner, age_s=info.age_s)
            self._log(f"reclaimed expired lease for {exact[:12]} "
                      f"(owner {info.prev_owner}, {info.age_s:.1f}s stale)")
        self._lease = lease
        self._lease_lost.clear()
        self.counters["claimed"] += 1
        get_metrics().counter("daemon.claimed").inc()
        return lease.path

    def _renew(self, lease: str) -> bool:
        """Heartbeat: renew the claim's mtime (serve/lease.py — nonce
        re-read, never an inode check).  A failed renew means a rival
        reclaimed it during a stall; flag it so the drain aborts instead
        of double-running."""
        lf = self._lease
        if lf is None or lf.path != lease or not lf.renew():
            self._lease_lost.set()
            return False
        return True

    def _release(self, lease: str) -> None:
        """Release the claim iff still ours — the grab-inspect-release
        discipline lives in :meth:`LeaseFile.release`; a rival's live
        lease is restored, never deleted."""
        lf = self._lease
        if lf is None or lf.path != lease:
            return
        if lf.release():
            self.counters["released"] += 1
        self._lease = None

    # -- status / liveness ---------------------------------------------------
    def _write_status(self, state: str,
                      item: Optional[Dict[str, Any]] = None) -> None:
        doc = {
            "version": STATUS_VERSION,
            "owner": self.owner,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "started_at": self.started_at,
            "heartbeat_at": time.time(),
            "uptime_s": round(time.time() - self.started_at, 1),
            "state": state,
            "item": item,
            "queue_depth": self._depth,
            "counters": dict(self.counters),
            # the read-only degradation latch (serve/store.py): non-None
            # while claims are paused because store writes cannot land
            "store_readonly": store_readonly(self.opts.store_path),
            # bounded per-item drain economics, mined by the report CLI
            "history": self.history[-20:],
        }
        try:
            atomic_dump_json(self.status_path, doc, prefix=".status.")
        except OSError as e:
            self._log(f"status write failed ({e})")
        try:
            self._snapshots.write(state=state, extra={
                "counters": dict(self.counters),
                "queue_depth": self._depth,
                "uptime_s": round(time.time() - self.started_at, 1)})
        except OSError as e:
            self._log(f"metrics snapshot failed ({e})")

    # -- failure history / poison -------------------------------------------
    def _load_fail_doc(self, exact: str) -> Dict[str, Any]:
        try:
            with open(self.queue.fail_path_for(exact)) as f:
                doc = json.load(f)
            if doc.get("version") != FAIL_VERSION:
                return {}
            return doc
        except (OSError, ValueError):
            return {}

    def _load_failures(self, exact: str) -> List[Dict[str, Any]]:
        return list(self._load_fail_doc(exact).get("attempts", []))

    def _record_failure(self, exact: str, exc: BaseException,
                        error_class: str) -> int:
        """Append one failed drain to the persistent sidecar; returns the
        deterministic-failure count so far (the poison trigger).  The
        attempt list keeps only the newest ``FAIL_ATTEMPT_CAP`` entries —
        a transient-failing item is revisited every poll, forever — but
        the deterministic count persists separately so trimming can never
        reset poison progress."""
        doc = self._load_fail_doc(exact)
        attempts = list(doc.get("attempts", []))
        det = doc.get("det_count")
        if det is None:  # pre-det_count sidecar: recover from the list
            det = sum(1 for a in attempts
                      if a.get("error_class") == FaultClass.DETERMINISTIC)
        if error_class == FaultClass.DETERMINISTIC:
            det += 1
        attempts.append({
            "at": time.time(),
            "owner": self.owner,
            "error": type(exc).__name__,
            "error_class": error_class,
            "message": str(exc)[:500],
        })
        try:
            atomic_dump_json(self.queue.fail_path_for(exact), {
                "version": FAIL_VERSION, "exact": exact, "det_count": det,
                "attempts": attempts[-FAIL_ATTEMPT_CAP:],
            }, prefix=".fail.")
        except OSError as e:
            # a full/hostile filesystem must not turn a failure *record*
            # into a daemon crash — the item stays queued either way; the
            # only cost is poison progress not advancing this visit
            if is_unwritable_io(e):
                mark_store_unwritable(self.opts.store_path, e)
            self._log(f"failure sidecar write failed for {exact[:12]} ({e})")
        return det

    def _poison(self, item_path: str, payload: Dict[str, Any],
                exact: str) -> None:
        """Move the item to the poison quarantine: the original payload
        plus its whole failure history, in the same digest-checked
        envelope, then remove item + sidecar so the queue never offers
        it again (the scan also skips items with a poison marker)."""
        attempts = self._load_failures(exact)
        atomic_write_json(self.queue.poison_path_for(exact), {
            "kind": "poisoned_request",
            "exact": exact,
            "reason": payload.get("reason"),
            "fingerprint": payload.get("fingerprint"),
            "request": payload.get("request"),
            "checkpoint": payload.get("checkpoint"),
            "attempts": attempts,
            "poisoned_by": self.owner,
            "poisoned_at": time.time(),
        })
        for p in (item_path, self.queue.fail_path_for(exact)):
            try:
                os.unlink(p)
            except OSError:
                pass
        self.counters["poisoned"] += 1
        get_metrics().counter("daemon.poisoned").inc()
        tr = get_tracer()
        if tr.enabled:
            tr.event("daemon.poison", exact=exact, attempts=len(attempts))
        self._log(f"poisoned {exact[:12]} after {len(attempts)} failed "
                  f"attempt(s)")

    # -- runners -------------------------------------------------------------
    def _run_in_process(self, item_path: str, payload: Dict[str, Any],
                        timeout: Optional[float]) -> Dict[str, Any]:
        """No subprocess, no hard watchdog (a hung in-process drain
        cannot be killed — the resilient layer's per-measurement
        watchdog, ``measure_timeout`` on the request, is the only hang
        bound here).  The production path is the subprocess runner."""
        fence = self._fence_token()
        prev = os.environ.get(FENCE_ENV)
        if fence is not None:
            os.environ[FENCE_ENV] = fence
        try:
            return exec_item(payload, item_path, self.opts.overrides,
                             self.opts.device)
        finally:
            if fence is not None:
                if prev is None:
                    os.environ.pop(FENCE_ENV, None)
                else:
                    os.environ[FENCE_ENV] = prev

    def _fence_token(self) -> Optional[str]:
        """``<lease-path>:<epoch>`` for the current claim, or None when
        the claim stands unfenced (registry write failed — serve/lease.py
        degrades to nonce checks).  Exported to the drain runner so the
        checkpoint journal refuses a zombie's late appends
        (fault/checkpoint.py ``FENCE_ENV``)."""
        lf = self._lease
        if lf is None or lf.epoch is None:
            return None
        return f"{lf.path}:{lf.epoch}"

    def _run_subprocess(self, item_path: str, payload: Dict[str, Any],
                        timeout: Optional[float]) -> Dict[str, Any]:
        """Drain in a child interpreter (``--exec-item``): the watchdog
        SIGKILLs a hang, a graceful daemon stop SIGINTs the child (its
        driver trap checkpoints + stamps ``interrupted``), and the child
        shares our process group so a SIGKILL of the daemon's group
        cannot orphan a drain behind a reclaimable lease."""
        ckpt = drain_checkpoint_of(payload, item_path)
        os.makedirs(ckpt, exist_ok=True)
        out = drain_verdict_path(ckpt)
        try:
            os.unlink(out)
        except OSError:
            pass
        cmd = [sys.executable, "-m", "tenzing_tpu_torch.serve.daemon",
               "--exec-item", item_path, "--verdict-out", out,
               "--device", self.opts.device]
        for k, v in self.opts.overrides.items():
            cmd += ["--override", f"{k}={json.dumps(v)}"]
        log_path = os.path.join(ckpt, "drain.log")
        deadline = (time.time() + timeout) if timeout else None
        # the child inherits the item's trace context via the
        # environment (obs/context.py TRACE_ENV; the envelope's `trace`
        # key is the redundant, SIGKILL-survivable copy) and — when this
        # daemon traces — the ask to archive its own bundle
        env = obs_context.to_env(
            dict(os.environ),
            obs_context.from_json(payload.get("trace")))
        if self.opts.trace_out:
            env[TRACE_CHILD_ENV] = "1"
        fence = self._fence_token()
        if fence is not None:
            # the child's checkpoint journal checks our lease epoch on
            # every append: if a rival fences us mid-drain, the zombie
            # child's late writes die there instead of landing stale
            env[FENCE_ENV] = fence
        with open(log_path, "ab") as log_f:
            proc = subprocess.Popen(cmd, stdout=log_f, stderr=log_f,
                                    env=env)
            self._child = proc
            try:
                rc = self._wait_child(proc, deadline)
            finally:
                self._child = None
        if rc == 0:
            with open(out) as f:
                return json.load(f)
        if rc < 0:
            if self._stop.is_set():
                raise _Interrupted()
            raise TransientError(
                f"drain child died with signal {-rc} (see {log_path})")
        if self._stop.is_set():
            # our SIGINT may have landed before the child's driver trap
            # was armed (it dies through the generic KeyboardInterrupt
            # path, rc != 0) — a stop is never a failure verdict
            raise _Interrupted()
        try:
            with open(out) as f:
                report = json.load(f)
        except (OSError, ValueError):
            # the child crashed before it could report: unknown leans
            # deterministic (fault/errors.py) — poison is bounded and
            # visible, an unbounded retry loop is neither
            raise DeterministicScheduleError(
                f"drain child exited rc={rc} with no error report "
                f"(see {log_path})")
        msg = f"{report.get('error_type', 'Error')}: {report.get('error')}"
        cls = report.get("error_class")
        if cls == FaultClass.TRANSIENT:
            raise TransientError(msg)
        if cls == FaultClass.DEVICE_LOST:
            raise DeviceLostError(msg)
        raise DeterministicScheduleError(msg)

    def _wait_child(self, proc: subprocess.Popen,
                    deadline: Optional[float]) -> int:
        interrupted_at = None
        while True:
            try:
                return proc.wait(timeout=0.25)
            except subprocess.TimeoutExpired:
                pass
            if self._lease_lost.is_set():
                proc.kill()
                proc.wait()
                raise _LeaseLost()
            if self._stop.is_set():
                if interrupted_at is None:
                    interrupted_at = time.time()
                    # graceful: the child's driver trap checkpoints +
                    # stamps interrupted, then the process dies (SIG_DFL)
                    proc.send_signal(signal.SIGINT)
                elif time.time() - interrupted_at > self.opts.stop_grace_secs:
                    proc.kill()
            elif deadline is not None and time.time() > deadline:
                # the per-item watchdog: a hung drain (stuck collective,
                # a copy that never completes) is killed and classified
                # transient — the retry gets a fresh dispatch and the
                # journal keeps everything already measured
                proc.kill()
                proc.wait()
                raise MeasurementTimeout(
                    f"drain exceeded {self.opts.item_timeout_secs}s watchdog")

    # -- merge ---------------------------------------------------------------
    def _merge(self, item_path: str, payload: Dict[str, Any],
               verdict: Dict[str, Any]) -> int:
        """Re-warm the store from the drain's recorded database + verdict
        provenance — the same admission rule as ``serve warm``
        (bench/recorded.py ``scored_rows``), so a drained answer and a
        hand-warmed one can never disagree about what counts.  Returns
        the number of records admitted."""
        from tenzing_tpu_torch.serve.fingerprint import fingerprint_of
        from tenzing_tpu_torch.serve.service import ScheduleService

        req = apply_overrides(payload["request"], self.opts.overrides)
        exact = self.queue.exact_of(item_path)
        warmed = fingerprint_of(req, platform=self.opts.device).exact_digest
        if warmed != exact:
            # the records would land where the item's query never looks,
            # and it would stay cold and queue the item again
            raise DeterministicScheduleError(
                f"item {exact} re-warms under fingerprint {warmed} "
                f"(platform {self.opts.device})")
        ckpt = drain_checkpoint_of(payload, item_path)
        # the override-applied request decides where the drain dumped its
        # database (exec_item honors the same overrides) — the raw item
        # request may name a different, never-written path
        csv = req.dump_csv or drain_csv_path(ckpt)
        svc = ScheduleService(self.opts.store_path, queue_dir=None,
                              model_path=self.opts.model_path,
                              tenant=self.opts.tenant, log=self._log_fn,
                              platform=self.opts.device)
        summary = svc.warm(req, [csv],
                           bench_globs=[drain_verdict_path(ckpt)],
                           topk=self.opts.topk, train=self.opts.train,
                           provenance={"device": self._measured_on(verdict)})
        return int(summary.get("added", 0))

    def _measured_on(self, verdict: Dict[str, Any]) -> str:
        """The name of the device the drain measured on: the verdict's
        (the driver's ``device.name``), else the daemon's device's."""
        dev = verdict.get("device")
        if isinstance(dev, dict) and dev.get("name"):
            return str(dev["name"])
        if self.opts.device == "cpu":
            return "cpu"
        import torch

        return torch.cuda.get_device_name(0)

    def check_device(self) -> None:
        """Raise unless the daemon's device is present: without a card a
        ``cuda`` daemon claims nothing, and the queue stays as it is."""
        from tenzing_tpu_torch.runtime.executor import resolve_device

        resolve_device(self.opts.device)

    # -- one item ------------------------------------------------------------
    def _journal_lines(self, ckpt_dir: str) -> int:
        try:
            with open(os.path.join(ckpt_dir, "measurements.jsonl")) as f:
                return sum(1 for line in f if line.strip())
        except OSError:
            return 0

    def _drain_one(self, item_path: str, payload: Dict[str, Any],
                   lease: str) -> str:
        """Drain one claimed item end to end; returns the outcome tag.
        Raises :class:`_Interrupted` through (the run loop stops)."""
        exact = self.queue.exact_of(item_path)
        ckpt = drain_checkpoint_of(payload, item_path)
        prior = self._journal_lines(ckpt)
        t0 = time.time()
        attempts = {"n": 1}
        hb_stop = threading.Event()

        def heartbeat():
            while not hb_stop.wait(self.opts.heartbeat_secs):
                self._renew(lease)
                self._write_status("draining", item={
                    "exact": exact, "path": item_path,
                    "since": t0, "attempts": attempts["n"]})

        hb = threading.Thread(target=heartbeat, name="daemon-heartbeat",
                              daemon=True)
        hb.start()
        self._write_status("draining", item={"exact": exact,
                                             "path": item_path, "since": t0})
        outcome, merged, err = "completed", 0, None
        try:
            def on_retry(e, attempt, delay):
                # `attempt` is the 0-based index of the attempt that just
                # failed; the invocation about to run is number attempt+2
                attempts["n"] = attempt + 2
                self.counters["retried"] += 1
                get_metrics().counter("daemon.retried").inc()
                self._log(f"retrying {exact[:12]} after transient "
                          f"({type(e).__name__}: {str(e)[:120]})")

            verdict = retry_call(
                lambda: self._runner(item_path, payload,
                                     self.opts.item_timeout_secs),
                policy=BackoffPolicy(retries=self.opts.retries,
                                     base_secs=self.opts.backoff_base_secs),
                where="daemon.drain", on_retry=on_retry)
            # the epoch fence: if a rival reclaimed us during a stall
            # (coarse/skewed mtimes can make our lease look expired while
            # our own clock says it is fresh), the registry holds a newer
            # epoch and this raises — the stale merge never starts
            if self._lease is not None and self._lease.path == lease:
                self._lease.check_fence()
            merged = self._merge(item_path, payload, verdict)
            # the merge has landed (flushed under the store flock):
            # ONLY NOW may item + sidecar + lease disappear — a crash
            # before this line re-drains, a crash after loses nothing
            for p in (item_path, self.queue.fail_path_for(exact)):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            if self._lease is not None and self._lease.path == lease:
                # effects landed: retire the fencing epochs so the
                # registry stays bounded (serve/lease.py EPOCH_KEEP)
                self._lease.purge_epochs()
            self.counters["completed"] += 1
            get_metrics().counter("daemon.completed").inc()
            self._log(f"completed {exact[:12]} ({merged} record(s) merged, "
                      f"{time.time() - t0:.1f}s)")
        except _Interrupted:
            outcome = "interrupted"
            raise
        except KeyboardInterrupt:
            # an in-process drain's Ctrl-C is a stop request, never a
            # failure verdict (the classifier would call it deterministic)
            outcome = "interrupted"
            self._stop.set()
            raise _Interrupted() from None
        except _LeaseLost:
            outcome = "lease_lost"
            self.counters["lease_lost"] += 1
            self._log(f"lease for {exact[:12]} reclaimed by a rival — "
                      "abandoning (no merge)")
        except FencedWriteError as e:
            # a rival holds a newer epoch: we are the zombie the fence
            # exists for.  Abandon without merging, without a failure
            # record (the item is in better hands, never evidence
            # against the request), and without releasing a lease that
            # is no longer ours
            outcome = "fenced"
            self.counters["fenced"] += 1
            get_metrics().counter("daemon.fenced").inc()
            self._log(f"fenced on {exact[:12]}: {e} — abandoning (no merge)")
        except BaseException as e:
            err = e
            if isinstance(e, StoreReadonlyError) or is_unwritable_io(e):
                # the store cannot take the merge (ENOSPC/EROFS/quota):
                # latch read-only and leave the item queued — NOT a
                # failure of the request, so no fail sidecar, no poison
                # progress; the run loop pauses claims until a probe
                # write succeeds
                outcome = "store_unwritable"
                self.counters["store_unwritable"] += 1
                mark_store_unwritable(self.opts.store_path, e)
                get_metrics().counter("daemon.store_unwritable").inc()
                self._log(f"store unwritable on {exact[:12]} ({e}) — "
                          "pausing claims until writable")
                return outcome
            if not os.path.exists(item_path):
                # a rival completed + deleted the item between our queue
                # scan and this drain (the lease was already gone, so the
                # claim looked fresh) — the failure is an artifact of
                # draining a ghost, never evidence against the request
                outcome = "vanished"
                self._log(f"item {exact[:12]} vanished mid-drain "
                          "(completed by a rival) — abandoning")
                return outcome
            cls = classify_error(e)
            if cls == FaultClass.DEVICE_LOST:
                outcome = "device_lost"
                self.device_lost = True
                self._record_failure(exact, e, cls)
                self._log(f"device lost draining {exact[:12]}: {e}")
                self._stop.set()
            elif cls == FaultClass.TRANSIENT:
                # retries exhausted: leave the item for a later pass /
                # another worker; the journal keeps what already landed
                outcome = "transient"
                self.counters["failed_transient"] += 1
                self._record_failure(exact, e, cls)
                self._log(f"transient drain failure on {exact[:12]} "
                          f"(retries exhausted): {e}")
            else:
                outcome = "failed"
                self.counters["failed_deterministic"] += 1
                n_det = self._record_failure(exact, e, cls)
                get_metrics().counter("daemon.failed").inc()
                self._log(f"deterministic drain failure {n_det}/"
                          f"{self.opts.max_failures} on {exact[:12]}: {e}")
                if n_det >= self.opts.max_failures:
                    self._poison(item_path, payload, exact)
                    outcome = "poisoned"
        finally:
            hb_stop.set()
            hb.join(timeout=5.0)
            if outcome not in ("lease_lost", "fenced"):
                # fenced = a rival holds a newer claim under our old
                # name: what's on disk is theirs, not ours to delete
                self._release(lease)
            else:
                self._lease = None
            after = self._journal_lines(ckpt)
            self.history.append({
                "exact": exact,
                "outcome": outcome,
                "wall_s": round(time.time() - t0, 3),
                "attempts": attempts["n"],
                "journal_lines_prior": prior,
                "journal_lines_after": after,
                "resumed": prior > 0,
                "merged": merged,
                **({"error": f"{type(err).__name__}: {str(err)[:200]}"}
                   if err is not None else {}),
                "ended_at": time.time(),
            })
            del self.history[:-HISTORY_CAP]
        return outcome

    # -- main loop -----------------------------------------------------------
    def _observe_queue(self) -> List:
        items = self.queue.items()
        self._depth = len(items)
        reg = get_metrics()
        reg.gauge("daemon.queue_depth").set(float(len(items)))
        # queue age: how long the oldest still-queued item has waited —
        # the fleet-sizing signal (depth alone hides a stuck old item
        # behind a churning queue)
        now = time.time()
        ages = []
        for path, _ in items:
            try:
                ages.append(now - os.path.getmtime(path))
            except OSError:
                pass  # claimed + deleted mid-scan
        reg.gauge("daemon.item_age_s").set(
            round(max(ages), 3) if ages else 0.0)
        leases = self.queue.leases()
        if leases:
            reg.gauge("daemon.lease_age_s").set(
                max(l["age_s"] for l in leases))
        return items

    def stop(self) -> None:
        """Ask the daemon to stop after the in-flight item checkpoints
        (the programmatic twin of SIGTERM)."""
        self._stop.set()

    def _on_signal(self, signum, frame) -> None:
        self.counters["signals"] += 1
        self._stop.set()
        if self.counters["signals"] >= 2 and self._child is not None:
            # second signal: the operator means NOW
            try:
                self._child.kill()
            except OSError:
                pass

    def _install_signals(self) -> None:
        if not self.opts.handle_signals:
            return
        if threading.current_thread() is not threading.main_thread():
            return  # embedded in a worker thread: caller drives stop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev_handlers[sig] = signal.signal(sig, self._on_signal)

    def _restore_signals(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (OSError, ValueError):
                pass
        self._prev_handlers.clear()

    def run(self) -> Dict[str, Any]:
        """Drain until stopped (or ``--once`` / ``--max-items`` /
        ``--idle-exit`` says done); returns the summary dict the CLI
        prints as its one JSON line.  Raises before it claims anything when
        the daemon's device is absent (:meth:`check_device`)."""
        self.check_device()
        self._install_signals()
        if self.opts.trace_out:
            from tenzing_tpu_torch.obs.tracer import configure

            configure(enabled=True)
        tr = get_tracer()
        drained = 0
        idle_since: Optional[float] = None
        interrupted = False
        self._write_status("idle")
        try:
            while not self._stop.is_set():
                if store_readonly(self.opts.store_path) is not None:
                    # degraded read-only: merges cannot land, so claiming
                    # would only churn leases and burn drain work.  Pause
                    # (visible in the status doc) and probe each poll —
                    # the latch clears itself the moment a write lands.
                    if not probe_store_writable(self.opts.store_path):
                        self._observe_queue()
                        self._write_status("paused")
                        self._stop.wait(self.opts.poll_secs)
                        if self.opts.once:
                            break
                        continue
                    self._log("store writable again — resuming claims")
                    # rewrite the status doc NOW: the paused doc (with
                    # its latch block) is what keeps store_unwritable
                    # firing, and an idle daemon may not write another
                    # status until it exits
                    self._write_status("idle")
                items = self._observe_queue()
                processed = progressed = 0
                for path, payload in items:
                    if self._stop.is_set():
                        break
                    if (self.opts.max_items is not None
                            and drained >= self.opts.max_items):
                        self._stop.set()
                        break
                    exact = self.queue.exact_of(path)
                    if os.path.exists(self.queue.poison_path_for(exact)):
                        continue  # quarantined: never re-claimed
                    if item_platform(payload) != self.opts.device:
                        # queued under another platform's fingerprint: the
                        # records this daemon measures would not answer it,
                        # so the item waits, unclaimed, for that platform's
                        continue
                    lease = self._claim(exact)
                    if lease is None:
                        continue
                    if not os.path.exists(path):
                        # completed + deleted by a rival after our scan:
                        # the fresh-looking claim was for a ghost
                        self._release(lease)
                        continue
                    processed += 1
                    try:
                        # the item's trace context (stamped at enqueue
                        # by the query that went cold) is ambient for
                        # the whole drain: the daemon.drain span, the
                        # store merge, and — via env + envelope — the
                        # subprocess's own spans all carry its trace_id
                        with obs_context.use(
                                obs_context.from_json(
                                    payload.get("trace"))), \
                                tr.span("daemon.drain", exact=exact,
                                        owner=self.owner) as sp:
                            outcome = self._drain_one(path, payload, lease)
                            sp.set("outcome", outcome)
                    except _Interrupted:
                        interrupted = True
                        break
                    if outcome in ("completed", "poisoned"):
                        drained += 1
                        progressed += 1
                if self.opts.once:
                    break
                if processed:
                    idle_since = None
                    if progressed:
                        continue  # more work may have arrived while draining
                    # every visit failed (transient exhaustion, lost
                    # leases): wait a poll before re-claiming the same
                    # items, or a down device turns into a spawn spin
                    self._stop.wait(self.opts.poll_secs)
                    continue
                if idle_since is None:
                    idle_since = time.time()
                if (self.opts.idle_exit_secs is not None
                        and time.time() - idle_since
                        >= self.opts.idle_exit_secs):
                    self._log(f"idle for {self.opts.idle_exit_secs}s — "
                              "exiting")
                    break
                self._stop.wait(self.opts.poll_secs)
        finally:
            interrupted = interrupted or (self._stop.is_set()
                                          and self.counters["signals"] > 0)
            state = "interrupted" if interrupted else "stopped"
            self._observe_queue()
            self._write_status(state)
            self._restore_signals()
            if self.opts.trace_out:
                from tenzing_tpu_torch.obs.export import write_jsonl

                try:
                    write_jsonl(tr, self.opts.trace_out)
                    self._log(f"trace bundle: {self.opts.trace_out}")
                except OSError as e:
                    self._log(f"trace bundle failed ({e})")
        return {
            "owner": self.owner,
            "state": state,
            "drained": drained,
            "queue_depth": self._depth,
            "counters": dict(self.counters),
            "status": self.status_path,
        }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tenzing_tpu_torch.serve.daemon",
        description="Drain the cold-request work queue through "
                    "bench/driver.py:run and re-warm the schedule store.")
    ap.add_argument("--queue", metavar="DIR",
                    help="work-queue directory (serve/store.py WorkQueue)")
    ap.add_argument("--store", metavar="PATH",
                    help="schedule store JSON to re-warm")
    ap.add_argument("--owner", default=None,
                    help="worker id for leases/status (default host-pid)")
    ap.add_argument("--tenant", default="daemon",
                    help="provenance tenant for re-warmed records")
    ap.add_argument("--once", action="store_true",
                    help="one queue pass, then exit")
    ap.add_argument("--max-items", type=int, default=None,
                    help="stop after draining (completing/poisoning) N items")
    ap.add_argument("--idle-exit", type=float, default=None, metavar="SECS",
                    help="exit after the queue stays empty this long")
    ap.add_argument("--poll", type=float, default=2.0, metavar="SECS",
                    help="queue re-scan interval when idle")
    ap.add_argument("--lease-ttl", type=float, default=60.0, metavar="SECS",
                    help="lease heartbeat age after which a rival may "
                         "reclaim the claim")
    ap.add_argument("--heartbeat", type=float, default=5.0, metavar="SECS",
                    help="lease-renewal / status-write interval")
    ap.add_argument("--item-timeout", type=float, default=3600.0,
                    metavar="SECS",
                    help="per-attempt drain watchdog (0 disables)")
    ap.add_argument("--retries", type=int, default=2,
                    help="bounded transient retries per item visit")
    ap.add_argument("--max-failures", type=int, default=3,
                    help="deterministic failures before poison quarantine")
    ap.add_argument("--topk", type=int, default=3,
                    help="winners admitted into the store per drain")
    ap.add_argument("--train", action="store_true",
                    help="retrain the near-tier surrogate on each re-warm")
    ap.add_argument("--in-process", action="store_true",
                    help="drain in this process (no hard watchdog; "
                         "tests, embedded drains)")
    ap.add_argument("--status", default=None, metavar="PATH",
                    help="status JSON path (default "
                         "<queue>/status-<owner>.json)")
    ap.add_argument("--model", default=None, metavar="PATH",
                    help="surrogate model path for --train "
                         "(default <store>.model.json)")
    ap.add_argument("--override", action="append", default=[],
                    metavar="K=V",
                    help="request-budget override applied to every drained "
                         "item (e.g. mcts_iters=8); identity fields refuse")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable tracing; write this daemon's telemetry "
                         "JSONL bundle here on exit (drain children "
                         "archive theirs under each item's ckpt dir)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where drains run and what the re-warmed records "
                         "are for (default: the card; without one the "
                         "daemon exits before claiming anything)")
    # the subprocess entry — not for operators (the daemon spawns it)
    ap.add_argument("--exec-item", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--verdict-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        overrides = dict(parse_override(s) for s in args.override)
    except ValueError as e:
        ap.error(str(e))
    if args.exec_item:
        if not args.verdict_out:
            ap.error("--exec-item requires --verdict-out")
        return _exec_item_main(args.exec_item, args.verdict_out, overrides,
                               args.device)
    if not args.queue or not args.store:
        ap.error("--queue and --store are required")
    opts = DaemonOpts(
        queue_dir=args.queue, store_path=args.store,
        owner=args.owner or "", tenant=args.tenant,
        lease_ttl_secs=args.lease_ttl, heartbeat_secs=args.heartbeat,
        poll_secs=args.poll,
        item_timeout_secs=args.item_timeout or None,
        retries=args.retries, max_failures=args.max_failures,
        once=args.once, max_items=args.max_items,
        idle_exit_secs=args.idle_exit, topk=args.topk, train=args.train,
        in_process=args.in_process, status_path=args.status,
        model_path=args.model, overrides=overrides,
        trace_out=args.trace_out, device=args.device)
    daemon = DrainDaemon(opts)
    try:
        daemon.check_device()
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"daemon: {e}\n")
        return 1
    summary = daemon.run()
    sys.stdout.write(json.dumps(summary) + "\n")
    # device loss is the one terminal verdict: the queue cannot drain on
    # a dead device, so the exit code tells the supervisor not to just
    # restart into the same wall
    return 1 if daemon.device_lost else 0


if __name__ == "__main__":
    sys.exit(main())
