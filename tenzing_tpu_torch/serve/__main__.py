"""``python -m tenzing_tpu_torch.serve`` — the schedule-serving CLI.

Counterpart of ``tenzing_tpu/serve/__main__.py``.  Each subcommand prints
one JSON line on stdout:

* ``warm`` — mine recorded search databases into the store (and train the
  near tier's surrogate):
  ``python -m tenzing_tpu_torch.serve warm --store S.json --workload halo
  --csv D.csv``
* ``query`` — resolve one request through the exact / near / cold tiers:
  ``python -m tenzing_tpu_torch.serve query --store S.json --queue QDIR``
* ``merge`` — fold other stores in:
  ``python -m tenzing_tpu_torch.serve merge --store S.json --from O.json``
* ``stats`` — store and queue occupancy.
* ``listen`` — the long-lived service loop (serve/listen.py): JSONL queries
  over stdin or a unix socket, a bounded queue that sheds, a watchdog per
  request, a graceful drain on SIGTERM, ``status-<owner>.json``.
  ``python -m tenzing_tpu_torch.serve --listen ...`` is the same mode.
* ``compact`` — one compaction pass over a segmented store directory
  (serve/segments.py): merge buckets of several segments, adopt orphans,
  reclaim; safe against a crash at any instant, exclusive by lease.
* ``backup`` / ``restore`` / ``fsck`` — disaster recovery (serve/dr.py):
  hard-linked point-in-time generations with a checksummed catalog, a
  restore that merges into a live store, and a read-only integrity walk
  whose exit code is 0 clean, 1 damaged, 2 unreadable.

``--platform {cuda,cpu}`` names the device the store's records are for and
enters every fingerprint, so a record stored for one platform never answers
another's query exact.  ``query``, ``merge`` and ``stats`` default to
``cuda``; ``warm`` requires it, because a recorded database does not say
which device measured it (a driver JSON given with ``--bench`` does, and
one of another platform is refused).  ``--store`` takes both backends: a
``*.json`` path is the monolithic store, any other path a segmented store
directory (serve/store.py ``open_store``).

The shape flags (``--halo-n`` / ``--m`` / ``--spmv-bw`` / ``--moe-tokens`` /
``--lanes`` / ``--smoke``) mirror the driver CLI: a query is a
:class:`~tenzing_tpu_torch.bench.driver.DriverRequest`, which is also what a
cold query's work item holds.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from tenzing_tpu_torch.bench.driver import DriverRequest
from tenzing_tpu_torch.serve.service import ScheduleService


def _request_of(args) -> DriverRequest:
    return DriverRequest(
        workload=args.workload, smoke=args.smoke, halo_n=args.halo_n,
        m=args.m, spmv_bw=args.spmv_bw, moe_tokens=args.moe_tokens,
        lanes=args.lanes)


def _service_of(args) -> ScheduleService:
    return ScheduleService(
        args.store, queue_dir=args.queue, model_path=args.model,
        tenant=args.tenant, verify=not getattr(args, "no_verify", False),
        near_max_sigma=getattr(args, "near_max_sigma", 0.75),
        log=lambda m: sys.stderr.write(m + "\n"), platform=args.platform)


def _emit(doc) -> None:
    sys.stdout.write(json.dumps(doc) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--listen" in argv:
        # `python -m tenzing_tpu_torch.serve --listen` is the listen
        # subcommand
        argv = ["listen"] + [a for a in argv if a != "--listen"]
    ap = argparse.ArgumentParser(
        prog="python -m tenzing_tpu_torch.serve",
        description="Schedule-serving store/resolver CLI (docs/serving.md)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, platform_required: bool = False):
        p.add_argument("--store", required=True,
                       help="store path: *.json (monolithic) or a "
                            "directory (segmented); created on first flush")
        p.add_argument("--queue", default=None, metavar="DIR",
                       help="cold/refinement work-queue directory")
        p.add_argument("--model", default=None,
                       help="surrogate model JSON (default: "
                            "<store>.model.json)")
        p.add_argument("--tenant", default="local",
                       help="provenance tenant tag for records added "
                            "through this process")
        p.add_argument("--trace-out", default=None, metavar="PATH",
                       help="enable tracing; write this process's "
                            "telemetry JSONL bundle here")
        p.add_argument("--platform", choices=("cuda", "cpu"),
                       required=platform_required,
                       default=None if platform_required else "cuda",
                       help="the device the store's records are for (it "
                            "enters every fingerprint); the same choice "
                            "the driver's --device makes")

    def request_flags(p):
        p.add_argument("--workload",
                       choices=("halo", "spmv", "attn", "moe"),
                       default="halo")
        p.add_argument("--smoke", action="store_true",
                       help="the tiny CPU config's fingerprint")
        p.add_argument("--halo-n", type=int, default=512)
        p.add_argument("--m", type=int, default=None)
        p.add_argument("--spmv-bw", type=int, default=None)
        p.add_argument("--moe-tokens", type=int, default=8192)
        p.add_argument("--lanes", type=int, default=None)

    pw = sub.add_parser("warm", help="mine recorded corpora into the store")
    # a recorded database names no device: the caller says which measured it
    common(pw, platform_required=True)
    request_flags(pw)
    pw.add_argument("--csv", nargs="+", required=True, metavar="GLOB",
                    help="recorded search databases (bench.py --dump-csv)")
    pw.add_argument("--bench", nargs="*", default=None, metavar="GLOB",
                    help="driver JSON verdicts to stamp as provenance")
    pw.add_argument("--topk", type=int, default=3,
                    help="distinct winners to store per warm")
    pw.add_argument("--no-train", action="store_true",
                    help="skip training the near-tier surrogate")

    pq = sub.add_parser("query", help="resolve one request")
    common(pq)
    request_flags(pq)
    pq.add_argument("--no-verify", action="store_true",
                    help="skip exact-hit re-verification (not "
                         "recommended; docs/serving.md)")
    pq.add_argument("--near-max-sigma", type=float, default=0.75,
                    help="near-miss uncertainty gate (log-space ensemble "
                         "spread ceiling)")

    pm = sub.add_parser("merge", help="merge other stores into --store")
    common(pm)
    pm.add_argument("--from", dest="from_stores", nargs="+", required=True,
                    metavar="STORE", help="store files to fold in")

    ps = sub.add_parser("stats", help="store/queue occupancy")
    common(ps)

    pl = sub.add_parser("listen",
                        help="long-lived service loop (docs/serving.md "
                             "'Listen mode')")
    common(pl)
    pl.add_argument("--socket", default=None, metavar="PATH",
                    help="serve a unix domain socket instead of "
                         "stdin/stdout JSONL")
    pl.add_argument("--max-pending", type=int, default=64,
                    help="bounded request queue; beyond this, shed with "
                         "retry_after")
    pl.add_argument("--workers", type=int, default=2,
                    help="resolution worker threads")
    pl.add_argument("--request-timeout", type=float, default=10.0,
                    metavar="SECS",
                    help="per-request watchdog (0 disables)")
    pl.add_argument("--tenant-max-pending", type=int, default=None,
                    help="per-tenant in-flight cap: an over-cap tenant "
                         "is shed with reason tenant_cap before the "
                         "global bound fills (default max-pending/2; "
                         "0 disables)")
    pl.add_argument("--shed-retry-after", type=float, default=0.5,
                    metavar="SECS",
                    help="retry_after hint carried by shed responses")
    pl.add_argument("--busy-poll-us", type=float, default=0.0,
                    metavar="US",
                    help="worker busy-poll window: spin this many µs "
                         "for the next request before blocking — buys "
                         "back the OS wake floor on the exact-tier "
                         "tail at the cost of an idle-spinning core "
                         "(0 = blocking waits)")
    pl.add_argument("--heartbeat", type=float, default=2.0, metavar="SECS",
                    help="status-document rewrite interval")
    pl.add_argument("--idle-exit", type=float, default=None, metavar="SECS",
                    help="socket mode: exit after this much silence (CI)")
    pl.add_argument("--owner", default=None,
                    help="worker id for the status doc (default host-pid)")
    pl.add_argument("--status", default=None, metavar="PATH",
                    help="status JSON path (default "
                         "status-<owner>.json next to the store)")
    pl.add_argument("--no-verify", action="store_true",
                    help="skip lazy re-verification of unstamped records")
    pl.add_argument("--near-max-sigma", type=float, default=0.75,
                    help="near-miss uncertainty gate")
    pl.add_argument("--slo-target-us", type=float, default=None,
                    help="exact-tier pct99 objective for the SLO block "
                         "in metric snapshots (docs/observability.md)")
    pl.add_argument("--slo-baseline", default=None, metavar="PATH",
                    help="committed SERVE_BENCH_r*.json anchoring the "
                         "SLO burn direction")
    pl.add_argument("--metrics-ring", type=int, default=8,
                    help="metric-snapshot files kept per owner")
    pl.add_argument("--record", default=None, metavar="DIR",
                    help="record admitted traffic into this request-log "
                         "directory (serve/reqlog.py)")
    pl.add_argument("--record-sample", type=float, default=1.0,
                    help="request-log sampling rate (deterministic per "
                         "trace_id; dropped requests are counted)")
    pl.add_argument("--record-retain", type=int, default=16,
                    help="sealed request-log segments kept (rotation)")
    pl.add_argument("--exemplar-k", type=int, default=4,
                    help="slowest-K span bundles kept per heartbeat "
                         "window (shed/timeout/error always kept)")
    pl.add_argument("--exemplar-cap", type=int, default=64,
                    help="exemplar bundles kept before oldest-first "
                         "eviction")

    pc = sub.add_parser("compact",
                        help="one offline compaction pass over a "
                             "segmented store directory")
    pc.add_argument("--store", required=True,
                    help="segmented store directory (serve/segments.py)")
    pc.add_argument("--owner", default=None,
                    help="compactor id for the lease (default host-pid)")
    pc.add_argument("--min-segments", type=int, default=2,
                    help="segments per bucket before a merge-rewrite")
    pc.add_argument("--lease-ttl", type=float, default=60.0, metavar="SECS",
                    help="compaction lease TTL (expired leases reclaim)")
    pc.add_argument("--grace", type=float, default=60.0, metavar="SECS",
                    help="age before stale temp droppings are collected")
    # chaos hook for the crash-consistency tests/CI: SIGKILL this process
    # at a chosen publish boundary — not for operators
    pc.add_argument("--crash-after", choices=("segment", "manifest"),
                    default=None, help=argparse.SUPPRESS)

    pb = sub.add_parser("backup",
                        help="one point-in-time backup generation "
                             "(docs/robustness.md 'Disaster recovery')")
    pb.add_argument("--store", required=True,
                    help="store path (segmented directory or *.json)")
    pb.add_argument("--out", default=None, metavar="DIR",
                    help="generations root (default <store>/backups)")
    pb.add_argument("--note", default="",
                    help="free-form tag stamped into the catalog")

    pr = sub.add_parser("restore",
                        help="catalog-verified point-in-time restore "
                             "(verbatim into an empty store, "
                             "superset-safe merge into a live one)")
    pr.add_argument("--store", required=True)
    pr.add_argument("--from", dest="generation", default=None,
                    metavar="GEN",
                    help="generation directory (default: the latest "
                         "under <store>/backups)")
    pr.add_argument("--out", default=None, metavar="DIR",
                    help="generations root searched when --from is "
                         "omitted")
    pr.add_argument("--force", action="store_true",
                    help="restore the intact files of a generation "
                         "that fails catalog verification")

    pf = sub.add_parser("fsck",
                        help="deep read-only integrity walk; exit 0 "
                             "clean / 1 damaged / 2 unreadable")
    pf.add_argument("--store", required=True)
    pf.add_argument("--adopt", action="store_true",
                    help="index orphan segments into the manifest "
                         "(the only write fsck can do)")
    pf.add_argument("--stamp", action="store_true",
                    help="record the verdict to <store>/fsck.json for "
                         "report --follow")
    pf.add_argument("--no-backups", action="store_true",
                    help="skip the backup-generation census")

    args = ap.parse_args(argv)
    if args.cmd in ("backup", "restore", "fsck"):
        from tenzing_tpu_torch.serve import dr

        log = lambda m: sys.stderr.write(m + "\n")  # noqa: E731
        try:
            if args.cmd == "backup":
                _emit(dr.backup_store(args.store, out_dir=args.out,
                                      note=args.note, log=log))
                return 0
            if args.cmd == "restore":
                gen = args.generation or dr.latest_generation(
                    args.out or dr.backups_root(args.store))
                if gen is None:
                    raise dr.DrError(
                        f"no backup generations found for {args.store}")
                _emit(dr.restore_store(args.store, gen,
                                       force=args.force, log=log))
                return 0
            doc = dr.fsck_store(args.store, adopt=args.adopt,
                                stamp=args.stamp,
                                check_backups=not args.no_backups,
                                log=log)
            _emit(doc)
            return doc["rc"]
        except dr.DrError as e:
            sys.stderr.write(f"serve {args.cmd}: {e}\n")
            return 2
    if args.cmd == "compact":
        from tenzing_tpu_torch.serve.segments import Compactor

        _emit(Compactor(args.store, owner=args.owner or "",
                        min_segments=args.min_segments,
                        lease_ttl_secs=args.lease_ttl,
                        grace_secs=args.grace,
                        log=lambda m: sys.stderr.write(m + "\n"),
                        crash_after=args.crash_after).run())
        return 0
    trace_out = getattr(args, "trace_out", None)
    if trace_out:
        from tenzing_tpu_torch import obs

        obs.configure(enabled=True)
    svc = _service_of(args)
    if args.cmd == "warm":
        _emit(svc.warm(_request_of(args), args.csv,
                       bench_globs=args.bench, topk=args.topk,
                       train=not args.no_train))
    elif args.cmd == "query":
        _emit(svc.query(_request_of(args)).to_json())
    elif args.cmd == "merge":
        out = [svc.merge(p) for p in args.from_stores]
        _emit({"merged": out, "records": len(svc.store)})
    elif args.cmd == "stats":
        _emit(svc.stats())
    elif args.cmd == "listen":
        from tenzing_tpu_torch.serve.listen import ListenOpts, ServeLoop

        opts = ListenOpts(
            max_pending=args.max_pending, workers=args.workers,
            tenant_max_pending=args.tenant_max_pending,
            request_timeout_secs=args.request_timeout or 0.0,
            shed_retry_after_secs=args.shed_retry_after,
            busy_poll_us=args.busy_poll_us,
            heartbeat_secs=args.heartbeat,
            idle_exit_secs=args.idle_exit, owner=args.owner or "",
            status_path=args.status, socket_path=args.socket,
            slo_target_us=args.slo_target_us,
            slo_baseline=args.slo_baseline,
            metrics_ring=args.metrics_ring, trace_out=trace_out,
            record_dir=args.record, record_sample=args.record_sample,
            record_retain=args.record_retain,
            exemplar_k=args.exemplar_k, exemplar_cap=args.exemplar_cap)
        loop = ServeLoop(svc, opts,
                         log=lambda m: sys.stderr.write(m + "\n"))
        if args.socket:
            _emit(loop.serve_socket(args.socket))
        else:
            _emit(loop.serve_stdin())
        return 0
    if trace_out:
        # one-shot subcommands archive their bundle after the verdict
        # line (the listen loop writes its own on drain)
        from tenzing_tpu_torch import obs

        obs.write_jsonl(obs.get_tracer(), trace_out)
        sys.stderr.write(f"trace bundle: {trace_out}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
