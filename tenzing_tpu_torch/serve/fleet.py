"""The drain fleet: N drain daemons work-stealing one queue.

Counterpart of ``tenzing_tpu/serve/fleet.py``, with its options, CLI flags,
document keys and exit codes.  The daemons' lease protocol already makes
rivals safe (one winner per claim, expired leases reclaimed by rename, a
commutative flock-serialized store merge), so a fleet is N unchanged
daemons on one queue directory.  This module launches them and audits
what they did:

* **launch** — N ``python -m tenzing_tpu_torch.serve.daemon`` subprocesses
  on one queue and store, each with its own ``--owner`` (``<prefix>-<k>``),
  the fleet's ``--device`` and an optional ``--trace-out`` bundle; each
  one's one-line JSON summary is collected when it exits (``--idle-exit``
  ends a drained fleet).
* **double-run audit** (:func:`audit_completions`) — from the members'
  ``status-<owner>.json`` histories: an exact digest completed by more
  than one owner is a ``double_runs`` entry.  ``audit_complete`` is false
  where a member's bounded history holds fewer completions than its
  counter.
* **drain-rate scaling** (:func:`measure_scaling`) — the same items
  against fleets of growing N, a fresh queue copy and store per rung,
  items per second per rung and the speedup over N = 1.
* **stitched traces** — with ``--trace-dir`` every member writes its
  bundle and its drain children archive theirs under each item's
  ``ckpt-<exact>/trace/``; the fleet stitches them (obs/export.py) and
  reports, per item that carried a trace context, whether its
  ``trace_id`` reaches a ``daemon.drain`` span.

Members that share one card time their schedules beside each other, so a
store that serves their numbers wants one measuring member a card.  The
scaling curve is therefore measured with :func:`stub_spawner` (fixed-cost
drains, the whole lease protocol real), never with real drains on one
card.

Run it::

    python -m tenzing_tpu_torch.serve.fleet --queue QDIR --store STORE \\
        --n 2 --idle-exit 3 [--device cpu] [--override mcts_iters=6 ...]
    python -m tenzing_tpu_torch.serve.fleet --queue QDIR --device cpu \\
        --scale 1,2 --workdir WDIR --stub-drain-secs 1 --out fleet.json

Without ``--device cpu`` it exits 1 on a machine with no card, before it
starts a member.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from tenzing_tpu_torch.serve.daemon import cuda_cards
from tenzing_tpu_torch.serve.store import WorkQueue

FLEET_VERSION = 1


@dataclass
class FleetOpts:
    """Knobs of one fleet launch (CLI flags map 1:1; the daemon knobs pass
    straight through to every member)."""

    queue_dir: str
    store_path: str
    n: int = 2
    owner_prefix: str = "fleet"
    idle_exit_secs: float = 3.0       # a drained fleet exits by itself
    poll_secs: float = 0.25
    lease_ttl_secs: float = 60.0
    heartbeat_secs: float = 1.0
    item_timeout_secs: Optional[float] = 3600.0
    topk: int = 3
    overrides: Dict[str, Any] = field(default_factory=dict)
    trace_dir: Optional[str] = None   # per-daemon bundles + stitch here
    wait_timeout_secs: float = 1800.0
    # where the members drain ("cuda" or "cpu"): their --device
    device: str = "cuda"


def _daemon_cmd(opts: FleetOpts, k: int) -> List[str]:
    """The member daemon's argv, in one place, so the subprocess launcher
    and anyone reproducing a member by hand agree."""
    cmd = [sys.executable, "-m", "tenzing_tpu_torch.serve.daemon",
           "--queue", opts.queue_dir, "--store", opts.store_path,
           "--owner", f"{opts.owner_prefix}-{k}",
           "--idle-exit", str(opts.idle_exit_secs),
           "--poll", str(opts.poll_secs),
           "--lease-ttl", str(opts.lease_ttl_secs),
           "--heartbeat", str(opts.heartbeat_secs),
           "--topk", str(opts.topk)]
    if opts.item_timeout_secs is not None:
        # 0 passes through: to the daemon 0 disables the watchdog, and
        # leaving the flag out would bring back its 3600 s default
        cmd += ["--item-timeout", str(opts.item_timeout_secs)]
    for key, v in opts.overrides.items():
        cmd += ["--override", f"{key}={json.dumps(v)}"]
    if opts.trace_dir:
        cmd += ["--trace-out",
                os.path.join(opts.trace_dir, f"daemon-{k}.jsonl")]
    cmd += ["--device", opts.device]
    return cmd


class _ProcHandle:
    """One spawned member: ``wait()`` returns its summary dict (the
    daemon's one JSON stdout line), with ``rc`` and the tail of its stderr
    on failure.

    The pipes are pumped by a thread started at spawn: members are waited
    on one at a time, and a member whose unread stderr filled its pipe
    mid-drain would block in ``write()``, age its lease past the TTL and
    hand its item to a rival, a double run made by the harness itself."""

    def __init__(self, owner: str, proc: subprocess.Popen):
        self.owner = owner
        self.proc = proc
        self._out: Optional[str] = None
        self._err: Optional[str] = None

        def pump():
            self._out, self._err = proc.communicate()

        self._pump = threading.Thread(target=pump, daemon=True,
                                      name=f"fleet-pump-{owner}")
        self._pump.start()

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        self._pump.join(timeout=timeout)
        if self._pump.is_alive():
            self.proc.kill()
            self._pump.join(timeout=10)
            return {"owner": self.owner, "rc": -9,
                    "error": "fleet wait timeout — member killed",
                    "stderr": (self._err or "")[-2000:]}
        doc: Dict[str, Any] = {"owner": self.owner,
                               "rc": self.proc.returncode}
        for line in reversed((self._out or "").splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    doc.update(json.loads(line))
                    break
                except ValueError:
                    continue
        if self.proc.returncode != 0:
            doc.setdefault("stderr", (self._err or "")[-2000:])
        return doc


def _subprocess_spawn(opts: FleetOpts, k: int) -> _ProcHandle:
    if opts.trace_dir:
        os.makedirs(opts.trace_dir, exist_ok=True)
    return _ProcHandle(
        f"{opts.owner_prefix}-{k}",
        subprocess.Popen(_daemon_cmd(opts, k), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True))


def stub_spawner(drain_secs: float) -> Callable:
    """A spawner whose members are in-process :class:`DrainDaemon` threads
    on ``opts.device`` with a fixed-cost drain (``time.sleep``): the lease,
    claim, status and merge protocol runs for real, only the search is a
    constant.  It measures what the fleet layer adds; ``--stub-drain-secs``
    marks such a curve, which is never a real-drain measurement."""
    from tenzing_tpu_torch.serve.daemon import DaemonOpts, DrainDaemon

    def runner(item_path, payload, timeout):
        time.sleep(drain_secs)
        return {"metric": "stub", "value": 1.0, "unit": "us"}

    class _ThreadHandle:
        def __init__(self, daemon):
            self.summary: Optional[Dict[str, Any]] = None

            def go():
                self.summary = daemon.run()

            self.thread = threading.Thread(target=go, daemon=True)
            self.thread.start()

        def wait(self, timeout=None):
            self.thread.join(timeout=timeout)
            if self.summary is None:
                return {"rc": -1, "error": "member never finished"}
            return dict(self.summary, rc=0)

    def spawn(opts: FleetOpts, k: int):
        d = DrainDaemon(DaemonOpts(
            queue_dir=opts.queue_dir, store_path=opts.store_path,
            owner=f"{opts.owner_prefix}-{k}", handle_signals=False,
            in_process=True, idle_exit_secs=opts.idle_exit_secs,
            poll_secs=opts.poll_secs,
            lease_ttl_secs=opts.lease_ttl_secs,
            heartbeat_secs=opts.heartbeat_secs,
            backoff_base_secs=0.01, device=opts.device),
            runner=runner, log=lambda m: None)
        return _ThreadHandle(d)

    return spawn


def audit_completions(queue_dir: str,
                      owners: List[str]) -> Dict[str, Any]:
    """The exactly-once audit over the fleet's status documents: which
    owner completed which exact digest, and every digest completed more
    than once (``double_runs``).  ``audit_complete`` is false when a
    member's status document is missing or its history window holds fewer
    completions than its counter (the audit is then a sample)."""
    completed_by: Dict[str, List[str]] = {}
    complete = True
    for owner in owners:
        path = os.path.join(queue_dir, f"status-{owner}.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            complete = False
            continue
        history = doc.get("history", [])
        if doc.get("counters", {}).get("completed", 0) > len(
                [h for h in history if h.get("outcome") == "completed"]):
            complete = False  # history window smaller than completions
        for h in history:
            if h.get("outcome") == "completed":
                completed_by.setdefault(h.get("exact", "?"),
                                        []).append(owner)
    double = {exact: owners_ for exact, owners_ in completed_by.items()
              if len(owners_) > 1}
    return {"completed_by": {k: sorted(v)
                             for k, v in sorted(completed_by.items())},
            "double_runs": dict(sorted(double.items())),
            "audit_complete": complete}


def _item_traces(queue: WorkQueue) -> Dict[str, Optional[str]]:
    """exact digest -> the trace_id its envelope carries (None when the
    enqueuer had no trace context)."""
    out: Dict[str, Optional[str]] = {}
    for path, payload in queue.items():
        out[WorkQueue.exact_of(path)] = (
            payload.get("trace") or {}).get("trace_id")
    return out


def _stitch_fleet(opts: FleetOpts,
                  item_traces: Dict[str, Optional[str]],
                  log: Callable[[str], None]) -> Optional[Dict[str, Any]]:
    """Stitch every member bundle and every drain child's archived bundle
    into one Perfetto file; report per item whether its trace_id reached a
    ``daemon.drain`` span."""
    import glob as _glob

    from tenzing_tpu_torch.obs.export import stitch

    paths = sorted(
        _glob.glob(os.path.join(opts.trace_dir, "daemon-*.jsonl")))
    paths += sorted(_glob.glob(
        os.path.join(opts.queue_dir, "ckpt-*", "trace", "trace.jsonl")))
    if not paths:
        return None
    out_path = os.path.join(opts.trace_dir, "fleet.json")
    try:
        summary = stitch(paths, out_path=out_path)
    except (OSError, ValueError) as e:
        log(f"fleet: stitch failed ({e})")
        return None
    traces = summary.get("traces", {})
    items = {}
    for exact, tid in item_traces.items():
        if tid is None:
            items[exact] = {"trace_id": None, "stitched": None}
            continue
        t = traces.get(tid) or {}
        items[exact] = {
            "trace_id": tid,
            "stitched": "daemon.drain" in (t.get("names") or []),
            "n_processes": t.get("n_processes"),
        }
    return {"out": out_path, "bundles": len(paths), "items": items}


def run_fleet(opts: FleetOpts,
              spawn: Optional[Callable[[FleetOpts, int], Any]] = None,
              log: Optional[Callable[[str], None]] = None,
              drain_label: str = "real") -> Dict[str, Any]:
    """Launch N members on one queue, wait, audit and measure (module
    docstring).  ``spawn(opts, k)`` returns anything with ``wait() ->
    summary dict``; the default spawns daemon subprocesses."""
    log = log or (lambda m: sys.stderr.write(m + "\n"))
    spawn = spawn or _subprocess_spawn
    queue = WorkQueue(opts.queue_dir)
    item_traces = _item_traces(queue)
    depth_before = len(item_traces)
    owners = [f"{opts.owner_prefix}-{k}" for k in range(opts.n)]
    log(f"fleet: launching {opts.n} daemon(s) on {opts.queue_dir} "
        f"({depth_before} item(s))")
    t0 = time.time()
    handles = [spawn(opts, k) for k in range(opts.n)]
    # one shared deadline: the members run side by side, so waiting on
    # them in turn must not give each a full timeout of its own
    deadline = t0 + opts.wait_timeout_secs
    summaries = [h.wait(timeout=max(1.0, deadline - time.time()))
                 for h in handles]
    wall = time.time() - t0
    drained = sum(s.get("counters", {}).get("completed", 0)
                  for s in summaries)
    audit = audit_completions(opts.queue_dir, owners)
    doc: Dict[str, Any] = {
        "kind": "drain_fleet",
        "version": FLEET_VERSION,
        # "real" (driver searches) or "stub:<secs>" (stub_spawner)
        "drain": drain_label,
        "n_daemons": opts.n,
        "items_before": depth_before,
        "drained": drained,
        "queue_after": len(queue),
        "wall_s": round(wall, 3),
        "drain_rate_per_s": round(drained / wall, 4) if wall else None,
        "double_runs": audit["double_runs"],
        "completed_by": audit["completed_by"],
        "audit_complete": audit["audit_complete"],
        "daemons": [{
            "owner": s.get("owner"),
            "rc": s.get("rc", 0),
            "drained": s.get("drained"),
            "counters": s.get("counters"),
            **({"error": s["error"]} if "error" in s else {}),
        } for s in summaries],
    }
    if opts.trace_dir:
        stitched = _stitch_fleet(opts, item_traces, log)
        if stitched is not None:
            doc["stitched"] = stitched
    if audit["double_runs"]:
        log(f"fleet: DOUBLE RUNS detected: {audit['double_runs']}")
    log(f"fleet: drained {drained}/{depth_before} in {wall:.1f}s "
        f"({doc['drain_rate_per_s']}/s) across {opts.n} daemon(s)")
    return doc


def copy_queue_items(src_queue: str, dst_queue: str) -> int:
    """Copy the work items of one queue, and only the items (no leases,
    failure sidecars, checkpoints or status documents), into a fresh
    directory: each rung of :func:`measure_scaling` drains the same
    untouched work."""
    os.makedirs(dst_queue, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src_queue)):
        if name.startswith("work-") and name.endswith(".json"):
            shutil.copy2(os.path.join(src_queue, name),
                         os.path.join(dst_queue, name))
            n += 1
    return n


def measure_scaling(opts: FleetOpts, ns: List[int], workdir: str,
                    log: Optional[Callable[[str], None]] = None,
                    spawn: Optional[Callable] = None,
                    drain_label: str = "real") -> Dict[str, Any]:
    """Drain rate against fleet size: for each N in ``ns``, the source
    queue's items copied into a fresh queue, a fresh store, one fleet run.
    Each rung's speedup over the N = 1 rung is the scaling curve."""
    log = log or (lambda m: sys.stderr.write(m + "\n"))
    rungs: List[Dict[str, Any]] = []
    for n in ns:
        qdir = os.path.join(workdir, f"q-n{n}")
        copied = copy_queue_items(opts.queue_dir, qdir)
        rung_opts = FleetOpts(
            **{**opts.__dict__,
               "queue_dir": qdir,
               "store_path": os.path.join(workdir, f"store-n{n}"),
               "n": n,
               "owner_prefix": f"{opts.owner_prefix}-n{n}",
               "trace_dir": (os.path.join(opts.trace_dir, f"n{n}")
                             if opts.trace_dir else None)})
        log(f"fleet: scaling rung n={n} ({copied} item(s))")
        rungs.append(run_fleet(rung_opts, spawn=spawn, log=log,
                               drain_label=drain_label))
    base = next((r for r in rungs if r["n_daemons"] == 1), None)
    base_rate = (base or {}).get("drain_rate_per_s")
    for r in rungs:
        rate = r.get("drain_rate_per_s")
        r["speedup_vs_n1"] = (round(rate / base_rate, 3)
                              if rate and base_rate else None)
    return {
        "kind": "drain_fleet_scaling",
        "version": FLEET_VERSION,
        "drain": drain_label,
        "ns": list(ns),
        "rungs": rungs,
        "double_runs_total": sum(len(r["double_runs"]) for r in rungs),
    }


def fleet_exit_code(doc: Dict[str, Any]) -> int:
    """The CLI's verdict: 1 on a double run or on any member that exited
    non-zero; undrained items are data, not failure (a transient-failing
    item waits in ``queue_after`` for a later pass)."""
    if doc.get("kind") == "drain_fleet_scaling":
        if doc.get("double_runs_total"):
            return 1
        members = [d for r in doc.get("rungs", [])
                   for d in r.get("daemons", [])]
    else:
        if doc.get("double_runs"):
            return 1
        members = doc.get("daemons", [])
    return 1 if any(d.get("rc") not in (0, None) for d in members) else 0


def main(argv: Optional[List[str]] = None) -> int:
    from tenzing_tpu_torch.serve.daemon import parse_override

    ap = argparse.ArgumentParser(
        prog="python -m tenzing_tpu_torch.serve.fleet",
        description="Launch N drain daemons work-stealing one queue, "
                    "audit exactly-once completion, measure drain-rate "
                    "scaling.")
    ap.add_argument("--queue", required=True, metavar="DIR",
                    help="work-queue directory (the scaling mode treats "
                         "it as a read-only item template)")
    ap.add_argument("--store", metavar="PATH",
                    help="schedule store to re-warm (required unless "
                         "--scale, which uses per-rung stores)")
    ap.add_argument("--n", type=int, default=2,
                    help="fleet size (ignored under --scale)")
    ap.add_argument("--scale", default=None, metavar="N1,N2,...",
                    help="measure drain-rate scaling across these fleet "
                         "sizes (fresh queue copy + store per rung)")
    ap.add_argument("--workdir", default=None, metavar="DIR",
                    help="scaling mode: where per-rung queues/stores "
                         "live (required with --scale)")
    ap.add_argument("--owner-prefix", default="fleet")
    ap.add_argument("--idle-exit", type=float, default=3.0, metavar="SECS")
    ap.add_argument("--poll", type=float, default=0.25, metavar="SECS")
    ap.add_argument("--lease-ttl", type=float, default=60.0,
                    metavar="SECS")
    ap.add_argument("--heartbeat", type=float, default=1.0, metavar="SECS")
    ap.add_argument("--item-timeout", type=float, default=3600.0,
                    metavar="SECS")
    ap.add_argument("--topk", type=int, default=3)
    ap.add_argument("--override", action="append", default=[],
                    metavar="K=V",
                    help="request-budget override for every member "
                         "(serve/daemon.py semantics)")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="per-daemon telemetry bundles + the stitched "
                         "fleet trace land here")
    ap.add_argument("--stub-drain-secs", type=float, default=None,
                    metavar="SECS",
                    help="replace the real drain with a fixed-cost sleep "
                         "(in-process members, full lease protocol): "
                         "measures the fleet layer itself and marks the "
                         "result 'drain: stub:<secs>'")
    ap.add_argument("--wait-timeout", type=float, default=1800.0,
                    metavar="SECS")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the result document here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the members drain (default: the card; "
                         "without one the fleet exits 1 before it starts "
                         "a member)")
    args = ap.parse_args(argv)
    try:
        overrides = dict(parse_override(s) for s in args.override)
    except ValueError as e:
        ap.error(str(e))
    if args.scale and not args.workdir:
        ap.error("--scale requires --workdir")
    if not args.scale and not args.store:
        ap.error("--store is required (unless --scale)")
    if args.stub_drain_secs is not None and args.trace_dir:
        # stub members are threads sharing one process tracer: their
        # bundles would all hold the same records, with no drain children
        ap.error("--trace-dir requires real subprocess members "
                 "(omit --stub-drain-secs)")
    if args.device == "cuda" and not cuda_cards():
        sys.stderr.write("fleet: CUDA is not available; pass --device cpu "
                         "to drain on the CPU\n")
        return 1
    opts = FleetOpts(
        queue_dir=args.queue, store_path=args.store or "",
        n=args.n, owner_prefix=args.owner_prefix,
        idle_exit_secs=args.idle_exit, poll_secs=args.poll,
        lease_ttl_secs=args.lease_ttl, heartbeat_secs=args.heartbeat,
        item_timeout_secs=args.item_timeout, topk=args.topk,
        overrides=overrides, trace_dir=args.trace_dir,
        wait_timeout_secs=args.wait_timeout, device=args.device)
    spawn = None
    drain_label = "real"
    if args.stub_drain_secs is not None:
        spawn = stub_spawner(args.stub_drain_secs)
        drain_label = f"stub:{args.stub_drain_secs}s"
    if args.scale:
        ns = [int(x) for x in args.scale.split(",") if x.strip()]
        doc = measure_scaling(opts, ns, args.workdir, spawn=spawn,
                              drain_label=drain_label)
    else:
        doc = run_fleet(opts, spawn=spawn, drain_label=drain_label)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
    sys.stdout.write(json.dumps(doc) + "\n")
    return fleet_exit_code(doc)


if __name__ == "__main__":
    sys.exit(main())
