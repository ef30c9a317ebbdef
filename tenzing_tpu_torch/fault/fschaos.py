"""The serving plane's hostile-filesystem drill: ``python -m
tenzing_tpu_torch.fault.fschaos``.

Counterpart of ``tenzing_tpu/fault/fschaos.py``, with its flags, phases,
invariants and ``fschaos_verdict`` line; exit 0 iff every invariant held.

**Phase 1 — fleet chaos runs.**  Per run (``--runs``, each under its own
derived seed): cold work items are enqueued under the fingerprint of the
members' platform (``--device``, default ``cuda``), the supervisor
(serve/supervisor.py) runs as a subprocess in ``--drain-exit`` mode, and
its members get a hostile filesystem: the seeded fsinject spec
(fault/fsinject.py) rides into each member through an ``env``-wrapped
``--member-argv``, so the daemons and their drain children see injected
EIO, ENOSPC, torn renames, stale reads and skewed lease clocks, while the
supervisor and this harness see the true disk.  Mid-drain the harness
SIGKILLs one member's process group (the daemon and its drain child).  The
run's audit:

* **no acknowledged record lost** — every enqueued fingerprint answers
  from a record in the final store, with at least as many records as its
  drain acknowledged (the ``merged`` count in the members' status
  histories), and ``fsck`` over it reports no error.  A drain that found
  nothing faster than naive acknowledges no record, and the run fails: it
  could not see a record lost;
* **exactly-once drain effect** — the status-history audit
  (serve/fleet.py ``audit_completions``) finds no double run, with the
  members' lease clocks skewed and coarsened (epoch fencing,
  serve/lease.py);
* **no work left behind** — supervisor rc 0, reason ``drained``, an empty
  queue, nothing poisoned;
* **the service answers throughout** — a probe thread resolves the
  enqueued fingerprints against the store for the whole run; a degraded
  shed (``StoreReadonlyError``) is an answer, any other exception a
  violation, and at the end every fingerprint resolves exact.

**Phase 2 — the ``store_unwritable`` drill.**  In-process, through the
real code paths: an injected ENOSPC latches the store read-only
(serve/store.py ``guarded_store_write``); a full disk under the store's
directory only keeps the daemon's probe failing, so the drain daemon
pauses its claims (status ``paused`` with the latch); the alert evaluator
fires ``store_unwritable``; once the disk frees, the daemon's next probe
clears the latch and the alert resolves.

On the card the members drain there (``--device cuda``, the default) and
each drained record names the card in its provenance; ``--device cpu``
runs the whole drill on the CPU.  Without a card a ``cuda`` drill exits 1
before it starts.  The work items are the reference's attn smoke items on
the CPU; on the card their search has no kernel to try and acknowledges no
record, so there they are halo smoke items (``_workload``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import tenzing_tpu_torch

REPO = os.path.abspath(os.path.join(
    os.path.dirname(tenzing_tpu_torch.__file__), ".."))

# the default hostile mount, parameterized by the run's seed: transient
# EIO bursts (retried), a rare single-fire ENOSPC (degrade + recover —
# the deterministic latch drill is phase 2; at a high rate the drain
# child's own checkpoint writes fail identically on every retry and the
# item is *correctly* poisoned, which is not the invariant under test),
# raise-mode torn renames (param=1 — the harness supplies the hard
# deaths itself via SIGKILL), NFS-style stale re-reads, and skewed +
# coarsened lease clocks (the epoch-fencing gauntlet)
DEFAULT_FAULTS = ("eio:0.08:{s}:3,enospc:0.02:{s}:1,torn_rename:0.03:{s}:1,"
                  "stale_read:0.3:{s}:4,mtime_skew:0.35:{s}:2.5,"
                  "mtime_coarse:0.6:{s}:2")


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _wait_for(pred: Callable[[], Any], timeout_s: float, what: str):
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        v = pred()
        if v:
            return v
        time.sleep(0.1)
    raise RuntimeError(f"timed out waiting for {what}")


def _group_live(pgid: int) -> List[int]:
    """The pids of process group ``pgid`` that still run (zombies, which
    hold nothing, excluded), read from ``/proc``."""
    live = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        # after the command: state, ppid, pgrp, ...
        if int(fields[2]) == pgid and fields[0] not in ("Z", "X"):
            live.append(int(name))
    return live


def _workload(device: str) -> str:
    """The work items' workload: the reference's attn smoke items on the
    CPU.  On the card their head dimension (8) has no kernel instantiation
    (ops/attention_kernels.py ``KERNEL_HEAD_DIMS``), so their search
    measures naive alone and the drain acknowledges no record; there the
    items are halo smoke items, whose overlapped orders beat naive's one
    lane by a margin that holds on a card other processes share (the SpMV
    kernel's gain at the spmv smoke is a few percent there)."""
    return "attn" if device == "cpu" else "halo"


def _requests(n: int, workload: str = "attn") -> List[Any]:
    """``n`` distinct smoke work items of ``workload`` under the
    reference's budget, with distinct lane counts for distinct exact
    fingerprints (the lane count is part of the fingerprint)."""
    from tenzing_tpu_torch.bench.driver import DriverRequest

    return [DriverRequest(workload=workload, smoke=True, lanes=2 * (i + 1),
                          mcts_iters=4, climb_budget=4, search_iters=2,
                          iters=4, measure_timeout=300.0)
            for i in range(n)]


def _member_argv(queue_dir: str, store: str, fault_spec: str,
                 device: str = "cuda") -> List[str]:
    """The chaos member: the stock drain daemon argv, env-wrapped so the
    member process (and every drain child it spawns) inherits the hostile
    filesystem through ``TENZING_FSINJECT`` (fault/fsinject.py), while the
    supervisor itself never writes through the inject seam."""
    return ["env", f"TENZING_FSINJECT={fault_spec}",
            sys.executable, "-m", "tenzing_tpu_torch.serve.daemon",
            "--queue", queue_dir, "--store", store, "--owner", "{owner}",
            # TTL sized ABOVE the worst-case injected timestamp error
            # (skew 2.5s + coarse 2s from DEFAULT_FAULTS): the run's
            # lesson is that a lease TTL below the filesystem's clock
            # error LIVELOCKS the fleet — rivals reclaim live leases
            # forever, every reclaim aborts a real drain attempt, and
            # epoch fencing keeps it correct-but-starving.  A SIGKILLed
            # member's item is still reclaimed within ~8s.
            "--idle-exit", "1.0", "--poll", "0.2", "--lease-ttl", "8",
            "--heartbeat", "0.3", "--topk", "3", "--item-timeout", "300",
            "--retries", "3", "--max-failures", "6", "--device", device]


def _sup_cmd(queue_dir: str, store: str, member_argv: List[str],
             daemons: int, device: str = "cuda") -> List[str]:
    return [sys.executable, "-m", "tenzing_tpu_torch.serve.supervisor",
            "--queue", queue_dir, "--store", store,
            "--min-daemons", str(daemons), "--max-daemons", str(daemons),
            "--tick", "0.2", "--heartbeat", "0.3",
            "--compact-interval", "0", "--gc-interval", "0",
            "--scale-hold-ticks", "1000000",
            "--member-lease-ttl", "8", "--member-heartbeat", "0.3",
            "--member-poll", "0.2", "--backoff-base", "0.3",
            "--breaker-max-restarts", "6",
            "--drain-exit", "--device", device,
            "--member-argv", json.dumps(member_argv)]


class _Probe(threading.Thread):
    """Service-continuity probe: resolve every enqueued fingerprint
    against the store, clean-env, for the whole run, under the fingerprint
    of the members' platform.  A degraded shed counts as an answer; any
    other exception is a violation."""

    def __init__(self, store: str, reqs: List[Any], platform: str):
        super().__init__(daemon=True)
        self.store = store
        self.reqs = reqs
        self.platform = platform
        self.stop = threading.Event()
        self.probes = 0
        self.degraded = 0
        self.tiers: Dict[str, str] = {}
        self.violations: List[str] = []

    def _pass(self) -> None:
        from tenzing_tpu_torch.fault.errors import StoreReadonlyError
        from tenzing_tpu_torch.serve.fingerprint import fingerprint_of
        from tenzing_tpu_torch.serve.service import ScheduleService

        svc = ScheduleService(self.store, queue_dir=None, verify=True,
                              platform=self.platform)
        for req in self.reqs:
            self.probes += 1
            exact = fingerprint_of(req, platform=self.platform).exact_digest
            try:
                res = svc.query(req)
                self.tiers[exact] = res.tier
            except StoreReadonlyError:
                self.degraded += 1  # an honest degraded answer
            except Exception as e:  # noqa: BLE001 — the audit ledger
                self.violations.append(f"probe {exact[:12]}: "
                                       f"{type(e).__name__}: {e}")

    def run(self) -> None:
        while not self.stop.is_set():
            try:
                self._pass()
            except Exception as e:  # noqa: BLE001
                self.violations.append(f"probe pass: {type(e).__name__}: {e}")
            self.stop.wait(0.5)
        self._pass()  # the post-drain pass: everything must be exact now


def _fault_evidence(queue_dir: str) -> Dict[str, int]:
    """Best-effort ``fault.fsinjected.*`` totals from the members'
    metric-snapshot rings — proof the run exercised the fault paths."""
    totals: Dict[str, int] = {}

    def walk(obj: Any) -> None:
        if isinstance(obj, dict):
            for k, v in obj.items():
                if isinstance(k, str) and k.startswith("fault.fsinjected.") \
                        and isinstance(v, (int, float)):
                    totals[k] = totals.get(k, 0) + int(v)
                else:
                    walk(v)
        elif isinstance(obj, list):
            for v in obj:
                walk(v)

    for path in glob.glob(os.path.join(queue_dir, "metrics-*.json")):
        doc = _read_json(path)
        if doc:
            walk(doc)
    return totals


def _acknowledged(queue_dir: str, owners: List[str]) -> Dict[str, int]:
    """exact digest -> the records the members acknowledged for it: the
    ``merged`` count of each completion in their status documents'
    histories (serve/daemon.py).  A status document the injected faults
    kept from landing counts nothing, so this is a floor."""
    acked: Dict[str, int] = {}
    for owner in owners:
        doc = _read_json(os.path.join(queue_dir, f"status-{owner}.json"))
        for h in (doc or {}).get("history", []):
            if h.get("outcome") == "completed":
                e = h.get("exact", "?")
                acked[e] = max(acked.get(e, 0), int(h.get("merged") or 0))
    return acked


def _chaos_run(workdir: str, run: int, seed: int, items: int,
               faults: str, daemons: int, timeout_s: float,
               log: Callable[[str], None],
               device: str = "cuda") -> Dict[str, Any]:
    from tenzing_tpu_torch.serve import dr
    from tenzing_tpu_torch.serve.fingerprint import fingerprint_of
    from tenzing_tpu_torch.serve.fleet import audit_completions
    from tenzing_tpu_torch.serve.store import WorkQueue, open_store

    rdir = os.path.join(workdir, f"run-{run}")
    queue_dir = os.path.join(rdir, "q")
    store = os.path.join(rdir, "store")
    os.makedirs(store, exist_ok=True)
    spec = faults.format(s=seed)
    doc: Dict[str, Any] = {"run": run, "seed": seed, "faults": spec,
                           "violations": []}
    bad = doc["violations"].append

    q = WorkQueue(queue_dir)
    reqs = _requests(items, _workload(device))
    exacts = []
    for req in reqs:
        # under the members' platform: a daemon claims only the items of
        # its own platform's fingerprint
        fp = fingerprint_of(req, platform=device)
        exacts.append(fp.exact_digest)
        q.enqueue(fp, req.to_json(), reason="cold")

    probe = _Probe(store, reqs, device)
    probe.start()
    env = dict(os.environ)
    env.pop("TENZING_FSINJECT", None)  # the controller stays truthful
    proc = subprocess.Popen(
        _sup_cmd(queue_dir, store,
                 _member_argv(queue_dir, store, spec, device), daemons,
                 device),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    killed = False
    try:
        # SIGKILL one member's whole session (daemon AND drain child)
        # once it has claimed work — the exactly-once half of the drill
        try:
            member = _wait_for(
                lambda: _read_json(
                    os.path.join(queue_dir, "status-fleet-0.json")),
                60.0, "the first member's status doc")
            _wait_for(
                lambda: glob.glob(os.path.join(queue_dir, "lease-*.json")),
                60.0, "a claimed lease")
            try:
                os.killpg(int(member["pid"]), signal.SIGKILL)
                killed = True
                log(f"run {run}: SIGKILLed member pg {member['pid']}")
            except (ProcessLookupError, PermissionError):
                killed = True  # already dead: an injected torn publish won
            # the member's drain child (the one holding the card's context)
            # dies with it: no process of the group outlives the kill
            try:
                _wait_for(lambda: not _group_live(int(member["pid"])), 10.0,
                          "the killed member's process group to die")
            except RuntimeError as e:
                bad(f"orphan after the kill: {e}")
        except RuntimeError as e:
            bad(f"chaos setup: {e}")
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        bad(f"supervisor did not drain within {timeout_s:.0f}s")
    finally:
        probe.stop.set()
        probe.join(timeout=30.0)

    doc["member_sigkilled"] = killed
    doc["supervisor_rc"] = proc.returncode
    summary: Dict[str, Any] = {}
    try:
        summary = json.loads(out.splitlines()[-1])
    except (IndexError, ValueError):
        bad("supervisor printed no summary line")
    doc["summary"] = {k: summary.get(k) for k in
                      ("reason", "counters", "double_runs",
                       "audit_complete", "queue_after")}

    if proc.returncode != 0:
        bad(f"supervisor rc {proc.returncode}: {err[-800:]}")
    if summary.get("reason") != "drained":
        bad(f"supervisor reason {summary.get('reason')!r}, want 'drained'")
    if summary.get("double_runs"):
        bad(f"double runs: {summary['double_runs']}")
    if len(q) != 0:
        bad(f"{len(q)} items left in the queue")
    poison = glob.glob(os.path.join(queue_dir, "poison-*.json"))
    if poison:
        bad(f"poisoned items: {[os.path.basename(p) for p in poison]}")

    # the harness's own exactly-once audit, over every fleet owner that
    # ever wrote a status doc (restarted incarnations share the owner)
    owners = sorted(
        os.path.basename(p)[len("status-"):-len(".json")]
        for p in glob.glob(os.path.join(queue_dir, "status-fleet-*.json")))
    audit = audit_completions(queue_dir, owners)
    doc["audit"] = audit
    if audit["double_runs"]:
        bad(f"status-history double runs: {audit['double_runs']}")

    # zero acknowledged-record loss: every fingerprint answers from the
    # final store, with at least the records its drain acknowledged, and a
    # deep fsck walk finds no damage.  A drain whose search found nothing
    # faster than naive acknowledges no record; its fingerprint then has
    # nothing whose loss the run could see, and that fails the run too
    st = open_store(store)
    have = {e: sum(1 for r in st.records() if r.get("exact") == e)
            for e in exacts}
    acked = _acknowledged(queue_dir, owners)
    doc["records"] = {e[:12]: {"acknowledged": acked.get(e, 0),
                               "stored": have[e]} for e in exacts}
    none = [e for e in exacts if not have[e] and not acked.get(e, 0)]
    lost = [e for e in exacts if e not in none and (
        have[e] < acked.get(e, 0) or st.best(e) is None)]
    if lost:
        bad(f"records lost for {[e[:12] for e in lost]}")
    if none:
        bad(f"no record for {[e[:12] for e in none]}: the drain "
            "acknowledged none (its search found nothing faster than "
            "naive), so the run cannot see a record lost")
    # what measured the records (the card's name, or "cpu"), and what each
    # drain ran on and launched (its --exec-item child's verdict)
    doc["devices"] = sorted({str((r.get("provenance") or {}).get("device"))
                             for r in st.records()})
    doc["drains"] = {}
    for e in exacts:
        v = _read_json(os.path.join(q.checkpoint_dir_for(e),
                                    "verdict.json")) or {}
        doc["drains"][e[:12]] = {
            "device": (v.get("device") or {}).get("name"),
            "vs_baseline": v.get("vs_baseline"),
            "launches": v.get("launches")}
    fsck = dr.fsck_store(store, check_backups=False)
    doc["fsck"] = {"rc": fsck["rc"], "errors": fsck["errors"],
                   "warnings": fsck.get("warnings", [])}
    if fsck["errors"]:
        bad(f"fsck errors: {fsck['errors']}")

    # service answered throughout, and everything resolves exact now (a
    # fingerprint with no record, cold: its violation is the one above)
    doc["probe"] = {"probes": probe.probes, "degraded": probe.degraded,
                    "violations": probe.violations}
    doc["violations"].extend(probe.violations)
    not_exact = [e for e in exacts if probe.tiers.get(e)
                 != ("cold" if e in none else "exact")]
    if not_exact:
        bad(f"final probe tier not exact for {[e[:12] for e in not_exact]}")

    doc["fault_evidence"] = _fault_evidence(queue_dir)
    doc["ok"] = not doc["violations"]
    log(f"run {run}: {'ok' if doc['ok'] else 'FAILED'} "
        f"(probes {probe.probes}, degraded {probe.degraded}, "
        f"injected {doc['fault_evidence']})")
    return doc


class _ScopedEnospc:
    """A full disk under ONE directory tree: the seam backend the drill
    installs so every store write (including the recovery probe) keeps
    failing ENOSPC while daemon status/queue writes land normally.
    chmod can't play this role — the harness may run as root, and root
    ignores permission bits."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root) + os.sep
        self.fires = 0

    def check(self, op: str, path: str) -> None:
        import errno

        if op == "write" and os.path.abspath(path).startswith(self.root):
            self.fires += 1
            raise OSError(errno.ENOSPC,
                          f"injected enospc (fschaos drill {path})")

    def maybe_stale_json(self, path: str):
        return None

    def observe_mtime(self, path: str, mtime: float) -> float:
        return mtime


def _unwritable_drill(workdir: str, seed: int,
                      log: Callable[[str], None],
                      device: str = "cuda") -> Dict[str, Any]:
    """Phase 2 (module docstring): ENOSPC latch -> daemon pauses ->
    ``store_unwritable`` fires -> probe write lands -> daemon resumes ->
    the alert resolves.  Every step through the production code path."""
    from tenzing_tpu_torch.fault import fsinject
    from tenzing_tpu_torch.obs.alerts import AlertBook, evaluate
    from tenzing_tpu_torch.serve.daemon import DaemonOpts, DrainDaemon
    from tenzing_tpu_torch.serve.store import (
        clear_store_unwritable,
        guarded_store_write,
        store_readonly,
    )
    from tenzing_tpu_torch.utils.atomic import atomic_dump_json
    from tenzing_tpu_torch.utils.atomic import set_io_backend as _atomic_set_backend

    ddir = os.path.join(workdir, "drill")
    queue_dir = os.path.join(ddir, "q")
    store = os.path.join(ddir, "store")
    os.makedirs(queue_dir, exist_ok=True)
    os.makedirs(store, exist_ok=True)
    doc: Dict[str, Any] = {"violations": []}
    bad = doc["violations"].append
    status_path = os.path.join(queue_dir, "status-drill.json")
    book = AlertBook(os.path.join(ddir, "alerts.json"),
                     resolve_hold_secs=0.0)

    def alert_entry() -> Optional[Dict[str, Any]]:
        entries = book.apply(evaluate([store], [queue_dir]))["alerts"]
        for key, e in entries.items():
            if key.startswith("store_unwritable:"):
                return e
        return None

    # first, prove the seeded spec grammar drives the same latch: one
    # bounded ENOSPC burst through the real fsinject backend
    backend = fsinject.install(f"enospc:1.0:{seed}:1")
    try:
        try:
            guarded_store_write(
                store, lambda: atomic_dump_json(
                    os.path.join(store, "drill.json"), {"n": 1}))
            bad("injected ENOSPC did not surface through the guard")
        except OSError:
            pass  # the expected degradation
    finally:
        fsinject.uninstall()
    doc["injected"] = dict(backend.injected)
    if store_readonly(store) is None:
        bad("store did not latch read-only on ENOSPC")

    # then hold the disk full for the store tree only, so the daemon's
    # recovery probe keeps failing while its status writes land
    scoped = _ScopedEnospc(store)
    _atomic_set_backend(scoped)
    d = DrainDaemon(
        DaemonOpts(queue_dir=queue_dir, store_path=store, owner="drill",
                   in_process=True, handle_signals=False, poll_secs=0.1,
                   heartbeat_secs=0.2, lease_ttl_secs=2.0,
                   status_path=status_path, device=device),
        runner=lambda path, payload, timeout: {},
        log=None)
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    try:
        _wait_for(
            lambda: (_read_json(status_path) or {}).get("state") == "paused"
            and (_read_json(status_path) or {}).get("store_readonly"),
            20.0, "the daemon's paused status doc")
        e = alert_entry()
        doc["fired"] = bool(e and e.get("state") == "firing")
        if not doc["fired"]:
            bad("store_unwritable did not fire while latched")
        else:
            log("drill: store_unwritable firing (daemon paused)")

        _atomic_set_backend(None)  # "the operator freed space"
        _wait_for(
            lambda: not (_read_json(status_path) or {}).get("store_readonly"),
            20.0, "the probe write to clear the latch")
        e = alert_entry()
        doc["resolved"] = bool(e and e.get("state") == "resolved")
        if not doc["resolved"]:
            bad("store_unwritable did not resolve after the probe landed")
        else:
            log("drill: store_unwritable resolved (claims resumed)")
    except RuntimeError as err:
        bad(str(err))
    finally:
        _atomic_set_backend(None)
        clear_store_unwritable(store)
        d.stop()
        t.join(timeout=20.0)
    doc["probe_write_denials"] = scoped.fires
    doc["ok"] = not doc["violations"]
    return doc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tenzing_tpu_torch.fault.fschaos",
        description="hostile-filesystem chaos acceptance for the serve "
                    "plane (module docstring)")
    ap.add_argument("--workdir", required=True,
                    help="scratch root for queues/stores/alert books")
    ap.add_argument("--runs", type=int, default=3,
                    help="fleet chaos runs (each under a derived seed)")
    ap.add_argument("--items", type=int, default=2,
                    help="cold work items per run")
    ap.add_argument("--daemons", type=int, default=2,
                    help="fleet members per run")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--faults", default=DEFAULT_FAULTS,
                    help="fsinject spec template; {s} is the run seed")
    ap.add_argument("--run-timeout", type=float, default=540.0,
                    help="per-run supervisor drain budget (seconds)")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke: one run, one item")
    ap.add_argument("--skip-fleet", action="store_true",
                    help="phase 2 drill only (no subprocess fleet)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the members and the drill's daemon drain "
                         "(default: the card; without one the drill exits "
                         "1 before it starts)")
    args = ap.parse_args(argv)
    if args.quick:
        args.runs, args.items = 1, 1
    if args.device == "cuda":
        from tenzing_tpu_torch.serve.daemon import cuda_cards

        if not cuda_cards():
            sys.stderr.write("fschaos: CUDA is not available; pass "
                             "--device cpu to drill on the CPU\n")
            return 1

    log = lambda m: sys.stderr.write(m + "\n")  # noqa: E731
    os.makedirs(args.workdir, exist_ok=True)
    runs: List[Dict[str, Any]] = []
    if not args.skip_fleet:
        for r in range(args.runs):
            runs.append(_chaos_run(args.workdir, r, args.seed + r,
                                   args.items, args.faults, args.daemons,
                                   args.run_timeout, log, args.device))
    drill = _unwritable_drill(args.workdir, args.seed, log, args.device)

    verdict = {
        "kind": "fschaos_verdict",
        "seed": args.seed,
        "device": args.device,
        "workload": _workload(args.device),
        "runs": runs,
        "drill": drill,
        "invariants": {
            "no_record_loss": all(r["ok"] for r in runs),
            "exactly_once": all(not r.get("audit", {}).get("double_runs")
                                for r in runs),
            "service_answered": all(not r["probe"]["violations"]
                                    for r in runs),
            "unwritable_fired_and_resolved": drill["ok"],
        },
        "ok": all(r["ok"] for r in runs) and drill["ok"],
    }
    sys.stdout.write(json.dumps(verdict) + "\n")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
