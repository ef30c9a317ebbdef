"""Trace-replay serving benchmark: ``python -m tenzing_tpu_torch.serve.replay``.

Counterpart of ``tenzing_tpu/serve/replay.py``, the same trace, document
(``REPLAY_VERSION``, ``kind: "serve_trace_replay"``), flags and exit codes,
plus ``--platform``, which it requires: the records it warms from a CSV are
stored under that platform's fingerprint, as ``serve warm`` stores them, and
the document names it.  A seeded synthetic query trace (a workload and
shape mix over recorded halo / spmv databases) is replayed against two
resolution paths over identically warmed stores:

* **monolithic-legacy** — the monolithic JSON store, no exact-answer
  cache, admission stamps ignored, every exact hit rebuilt and verified
  again (``Resolver(serve_cache=False, legacy_verify=True)``);
* **segmented** — the segmented store, admission-time verification, the
  sealed in-memory exact cache, all driven through the real
  :class:`~tenzing_tpu_torch.serve.listen.ServeLoop` at a paced QPS, so
  sheds and timeouts are measured.

Both paths get one uncounted warmup pass per distinct request shape (the
graph and verifier caches hot on both sides), so the comparison isolates
the per-query serving work.  Latencies are grouped by resolved tier; the
headline is the exact tier's pct99 ratio, with the segmented path's
per-query verifier calls beside it (zero by design).  The result is one
JSON document (``--out``) and one summary line on stdout.  A ``host_noise``
block (obs/noise.py) records this host's latency floors, measured before
anything is warmed, so the regression check can tell a slower host from a
slower server.

The trace is deterministic: ``random.Random(seed)`` draws a workload and a
tier class per query from the mix; "near" shapes sit in the warmed shape's
bucket (power-of-two bucketing, serve/fingerprint.py), "cold" shapes in
other buckets.

**Recorded traffic**: ``--record DIR`` has the segmented path's listen loop
record what it serves (serve/reqlog.py), and ``--from-recorded DIR``
replays a recorded log's mix instead of the synthetic one — request kwargs
verbatim, the mix and the paced QPS rebuilt from the recorded stream's
inter-arrival times (``--qps`` still overrides).  The document then carries
a ``recorded`` block (coverage, mix, QPS estimate).  Replay resolves on the
host only: it builds no executor and leaves CUDA uninitialized.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from tenzing_tpu_torch.bench.driver import DriverRequest
from tenzing_tpu_torch.learn import FEATURE_NAMES, RidgeEnsemble
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.noise import probe_host_noise
from tenzing_tpu_torch.serve.listen import ListenOpts, ServeLoop
from tenzing_tpu_torch.serve.reqlog import read_request_log
from tenzing_tpu_torch.serve.resolver import Resolver
from tenzing_tpu_torch.serve.service import ScheduleService
from tenzing_tpu_torch.serve.store import ScheduleStore, WorkQueue
from tenzing_tpu_torch.utils.numeric import percentile

REPLAY_VERSION = 5
# raw exact-tier latency series retained in the result document (replay
# order preserved): the regression check's noise rule runs the
# bench/randomness.py runs test over it, and 512 points bound the
# document's size
EXACT_SAMPLES_CAP = 512
# the synthetic generator's default pace (the reference's).  It claims
# nothing about a host: what one sustains is measured into the document
# (``segmented.qps_effective``), and a pace above it queues work the
# serving path never caused.  ``--qps`` overrides; ``--from-recorded``
# paces at the recorded stream's inter-arrival estimate.
DEFAULT_QPS = 300.0
# the platforms a fingerprint names (serve/fingerprint.py PLATFORMS)
PLATFORM_CHOICES = ("cuda", "cpu")

# per-workload shape knob: (field, near value, cold values) — "exact"
# queries use the warmed default shape; "near" sits in its power-of-two
# bucket with a different exact digest (halo: n 500 vs 512 both bucket
# 512; spmv: m 200000 vs 150000 both bucket 262144 with bw in bucket
# 32768), "cold" in other buckets.  Golden-checked against
# serve/fingerprint.py's shape_bucket boundaries.
_SHAPE_KNOBS: Dict[str, Tuple[str, int, List[int]]] = {
    "halo": ("halo_n", 500, [1024, 2048]),
    "spmv": ("m", 200000, [100000, 60000]),
}


def _req_kwargs(workload: str, kind: str, i: int = 0) -> Dict[str, Any]:
    field, near, colds = _SHAPE_KNOBS[workload]
    if kind == "exact":
        return {"workload": workload}
    if kind == "near":
        return {"workload": workload, field: near}
    # a couple of distinct cold shapes per workload: exercises more than
    # one cold digest without paying a fresh graph build per query (the
    # resolver's graph cache covers them)
    return {"workload": workload, field: colds[i % len(colds)]}


def build_trace(workloads: List[str], n: int, seed: int,
                mix: Dict[str, float]) -> List[Dict[str, Any]]:
    """The deterministic query stream: ``n`` request-kwarg dicts drawn
    from the workload set and the exact/near/cold mix."""
    rng = random.Random(seed)
    kinds = sorted(mix)
    weights = [mix[k] for k in kinds]
    out = []
    for i in range(n):
        wl = rng.choice(workloads)
        kind = rng.choices(kinds, weights=weights, k=1)[0]
        out.append({"kind": kind, "request": _req_kwargs(wl, kind, i)})
    return out


def trace_from_recorded(directory: str,
                        log=None) -> Tuple[List[Dict[str, Any]],
                                           Dict[str, Any]]:
    """The query trace reconstructed from a recorded request log
    (serve/reqlog.py; module docstring): every replayable record —
    query/batch with its verbatim request kwargs — becomes one trace
    entry in arrival order, its ``kind`` the tier it resolved to (or
    the shed/timeout outcome for requests that never resolved; offered
    load is offered load).  Returns ``(trace, info)`` where ``info`` is
    the ``recorded`` provenance block: empirical tier mix, workloads,
    the inter-arrival QPS estimate, and the log's coverage/damage
    tallies."""
    data = read_request_log(directory, log=log)
    # an EMPTY kwargs dict stays in: {"op": "query"} with no body is a
    # valid all-defaults DriverRequest, and a log dominated by
    # default-shape queries must not silently reconstruct as empty
    recs = [r for r in data["records"]
            if r.get("op") in ("query", "batch")
            and isinstance(r.get("request"), dict)]
    trace: List[Dict[str, Any]] = []
    mix_n: Dict[str, int] = {}
    outcomes: Dict[str, int] = {}
    workloads: set = set()
    unreplayable = 0
    for r in list(recs):
        try:
            # the log records kwargs verbatim, validated or not — a shed
            # or errored request never reached DriverRequest, so an
            # off-schema record must be skipped (and counted), not crash
            # the whole replay at reconstruction time
            DriverRequest(**r["request"])
        except TypeError:
            unreplayable += 1
            recs.remove(r)
            continue
        kind = r.get("tier") or r.get("outcome") or "recorded"
        trace.append({"kind": kind, "request": r["request"]})
        mix_n[kind] = mix_n.get(kind, 0) + 1
        outcomes[r.get("outcome", "?")] = \
            outcomes.get(r.get("outcome", "?"), 0) + 1
        wl = r.get("workload") or r["request"].get("workload")
        if wl:
            workloads.add(wl)
    if not trace:
        raise ValueError(f"{directory}: no replayable request records")
    if unreplayable and log is not None:
        log(f"replay: skipped {unreplayable} unreplayable record(s) "
            "(off-schema request kwargs)")
    ts = [r["ts"] for r in recs if isinstance(r.get("ts"), (int, float))]
    qps = None
    if len(ts) >= 2 and ts[-1] > ts[0]:
        # 3 decimals, not 1: a trickle recorded over an hour must not
        # round to a falsy 0.0 and silently repace at the synthetic
        # default — slow truth beats fast fiction (--qps overrides)
        qps = round((len(ts) - 1) / (ts[-1] - ts[0]), 3)
    n = len(recs)
    info = {
        "dir": directory,
        "records": n,
        "mix": {k: round(v / n, 4) for k, v in sorted(mix_n.items())},
        "outcomes": dict(sorted(outcomes.items())),
        "workloads": sorted(workloads),
        "qps_estimate": qps,
        "unreplayable": unreplayable,
        "segments": data["segments"],
        "damaged_segments": data["damaged"],
        "checksum_failed": data["checksum_failed"],
        "dropped_sampling": data["dropped_sampling"],
    }
    return trace, info


def _series(lat_by_tier: Dict[str, List[float]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for tier, xs in sorted(lat_by_tier.items()):
        if not xs:
            continue
        s = sorted(xs)
        out[tier] = {
            "count": len(s),
            "pct50_us": round(percentile(s, 50), 1),
            "pct99_us": round(percentile(s, 99), 1),
            "max_us": round(s[-1], 1),
            "mean_us": round(sum(s) / len(s), 1),
        }
    return out


def _phase_series(phase_lat: Dict[str, List[float]]) -> Dict[str, Any]:
    """Per-phase latency summary (fingerprint / cache_probe /
    store_walk / serialize — the resolver's and the transport's phase
    stamps): the exact tier's profile, which obs/causal.py
    ``localize_phases`` compares between two documents."""
    out: Dict[str, Any] = {}
    for phase, xs in sorted(phase_lat.items()):
        if not xs:
            continue
        s = sorted(xs)
        out[phase] = {
            "count": len(s),
            "pct50_us": round(percentile(s, 50), 2),
            "pct99_us": round(percentile(s, 99), 2),
            "sum_us": round(sum(s), 1),
        }
    return out


def _warm_stores(workdir: str, csv_globs: Dict[str, List[str]],
                 topk: int, log, platform: str) -> Dict[str, Any]:
    """Warm a monolithic and a segmented store identically from the
    given corpora, under ``platform``'s fingerprints; returns paths and
    per-workload warm summaries."""
    mono_path = os.path.join(workdir, "mono.json")
    seg_path = os.path.join(workdir, "seg")
    summaries: Dict[str, Any] = {}
    # one surrogate per store (the near tier's pricing model): train it
    # from the richest corpus only — a later warm with train=True would
    # overwrite it with the last workload's model
    primary = "halo" if "halo" in csv_globs else sorted(csv_globs)[0]
    for store_path, tag in ((mono_path, "mono"), (seg_path, "seg")):
        svc = ScheduleService(store_path,
                              queue_dir=os.path.join(workdir, f"q-{tag}"),
                              tenant=f"replay-{tag}", log=log,
                              platform=platform)
        for wl, globs in sorted(csv_globs.items()):
            s = svc.warm(DriverRequest(workload=wl), globs, topk=topk,
                         train=(wl == primary))
            summaries.setdefault(wl, {})[tag] = {
                "added": s["added"], "rows": s["rows"],
                "admission": s.get("admission"),
            }
    return {"mono": mono_path, "seg": seg_path, "warm": summaries}


def _replay_legacy(mono_path: str, queue_dir: str, model_path: str,
                   trace: List[Dict[str, Any]], log,
                   platform: str) -> Dict[str, Any]:
    """The uncached path, sequentially (a process per query has no queue
    to shed from): every query rebuilt and verified, no cache."""
    store = ScheduleStore(mono_path, log=log)
    model = None
    if os.path.exists(model_path):
        model = RidgeEnsemble.load(model_path,
                                   expect_features=list(FEATURE_NAMES))
    resolver = Resolver(store, queue=WorkQueue(queue_dir), model=model,
                        serve_cache=False, legacy_verify=True, log=log,
                        platform=platform)
    reqs = [DriverRequest(**t["request"]) for t in trace]
    for kw in {json.dumps(t["request"], sort_keys=True)
               for t in trace}:
        resolver.resolve(DriverRequest(**json.loads(kw)))  # warmup
    fallback0 = get_metrics().counter("serve.verify_fallback").value
    lat: Dict[str, List[float]] = {}
    phases: Dict[str, List[float]] = {}
    t_start = time.perf_counter()
    for req in reqs:
        t0 = time.perf_counter()
        res = resolver.resolve(req)
        lat.setdefault(res.tier, []).append(
            (time.perf_counter() - t0) * 1e6)
        if res.tier == "exact":
            for phase, us in res.phase_us.items():
                phases.setdefault(phase, []).append(us)
    wall = time.perf_counter() - t_start
    return {
        "mode": "monolithic-legacy",
        "resolve_us": _series(lat),
        "phases_us": _phase_series(phases),
        "verifier_calls": get_metrics().counter(
            "serve.verify_fallback").value - fallback0,
        "wall_s": round(wall, 3),
        "qps_effective": round(len(reqs) / wall, 1) if wall else None,
    }


def _replay_segmented(seg_path: str, queue_dir: str,
                      trace: List[Dict[str, Any]], qps: float,
                      max_pending: int, workers: int,
                      request_timeout: float, log, platform: str,
                      record_dir: Optional[str] = None,
                      busy_poll_us: float = 0.0) -> Dict[str, Any]:
    """The serving path through the real ServeLoop, paced at the target
    QPS: shed and timeout counts are measured behavior.  With
    ``record_dir`` the loop also records the replayed traffic
    (serve/reqlog.py), the source for ``--from-recorded``."""
    svc = ScheduleService(seg_path, queue_dir=queue_dir,
                          tenant="replay-seg", log=log, platform=platform)
    for kw in {json.dumps(t["request"], sort_keys=True) for t in trace}:
        svc.query(DriverRequest(**json.loads(kw)))  # warmup
    reg = get_metrics()
    fallback0 = reg.counter("serve.verify_fallback").value
    # fast-path economics: deltas over the replay window for the memo
    # and fingerprint caches
    fast0 = {name: reg.counter(name).value for name in (
        "serve.memo.hits", "serve.memo.misses",
        "serve.memo.invalidations",
        "serve.fp_cache.hits", "serve.fp_cache.misses")}
    loop = ServeLoop(svc, ListenOpts(
        max_pending=max_pending, workers=workers,
        request_timeout_secs=request_timeout,
        status_path=os.path.join(seg_path, "status-replay.json"),
        owner="replay", handle_signals=False,
        busy_poll_us=busy_poll_us,
        record_dir=record_dir), log=log)
    loop.start()
    results: List[Dict[str, Any]] = []
    lock = threading.Lock()

    def respond(doc: Dict[str, Any]) -> None:
        with lock:
            results.append(doc)

    t_start = time.perf_counter()
    for i, t in enumerate(trace):
        target = t_start + i / qps
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        loop.submit({"op": "query", "id": i, "request": t["request"]},
                    respond)
    loop.drain(timeout=max(30.0, request_timeout * 2))
    wall = time.perf_counter() - t_start
    lat: Dict[str, List[float]] = {}
    phases: Dict[str, List[float]] = {}
    exact_samples: List[float] = []
    shed = timeouts = errors = cache_hits = 0
    for doc in results:
        if doc.get("shed"):
            shed += 1
        elif doc.get("timed_out"):
            timeouts += 1
        elif not doc.get("ok"):
            errors += 1
        else:
            r = doc["result"]
            lat.setdefault(r["tier"], []).append(r["resolve_us"])
            if r["tier"] == "exact":
                # the exact tier's per-phase profile and a bounded raw
                # series (replay order) for the noise-aware regression
                # check (obs/report.py check_serve_regression)
                for phase, us in (r.get("phase_us") or {}).items():
                    phases.setdefault(phase, []).append(us)
                if len(exact_samples) < EXACT_SAMPLES_CAP:
                    exact_samples.append(r["resolve_us"])
            if r.get("provenance", {}).get("cache_hit"):
                cache_hits += 1
    out_reqlog = (loop.summary().get("reqlog")
                  if record_dir is not None else None)
    fast = {name: reg.counter(name).value - v0
            for name, v0 in fast0.items()}
    memo_served = fast["serve.memo.hits"] + fast["serve.memo.misses"]
    fp_probed = fast["serve.fp_cache.hits"] + fast["serve.fp_cache.misses"]
    return {
        "mode": "segmented",
        "busy_poll_us": busy_poll_us,
        **({"reqlog": out_reqlog} if out_reqlog else {}),
        "resolve_us": _series(lat),
        "phases_us": _phase_series(phases),
        "exact_samples_us": exact_samples,
        "memo": {
            "hits": fast["serve.memo.hits"],
            "misses": fast["serve.memo.misses"],
            "invalidations": fast["serve.memo.invalidations"],
            "hit_rate": (round(fast["serve.memo.hits"] / memo_served, 4)
                         if memo_served else None),
        },
        "fp_cache": {
            "hits": fast["serve.fp_cache.hits"],
            "misses": fast["serve.fp_cache.misses"],
            "hit_rate": (round(fast["serve.fp_cache.hits"] / fp_probed, 4)
                         if fp_probed else None),
        },
        "verifier_calls": reg.counter(
            "serve.verify_fallback").value - fallback0,
        "shed": shed,
        "timeouts": timeouts,
        "errors": errors,
        "exact_cache_hits": cache_hits,
        "wall_s": round(wall, 3),
        "qps_effective": round(len(trace) / wall, 1) if wall else None,
        "counters": dict(loop.counters),
    }


def run_replay(csv_globs: Dict[str, List[str]], platform: str,
               n: int = 1200,
               qps: float = DEFAULT_QPS, seed: int = 7,
               mix: Optional[Dict[str, float]] = None, topk: int = 3,
               workdir: Optional[str] = None, keep_workdir: bool = False,
               max_pending: int = 256, workers: int = 2,
               request_timeout: float = 30.0,
               record_dir: Optional[str] = None,
               trace: Optional[List[Dict[str, Any]]] = None,
               recorded: Optional[Dict[str, Any]] = None,
               pacing: Optional[Dict[str, Any]] = None,
               fleet_scaling: Optional[Dict[str, Any]] = None,
               noise_samples: int = 64,
               busy_poll_us: float = 0.0,
               log=None) -> Dict[str, Any]:
    """The whole benchmark; returns the result document (see module
    docstring).  ``platform`` (``"cuda"`` or ``"cpu"``) names the
    device the corpora were measured on: every fingerprint warmed and
    resolved carries it.  ``trace`` (with its ``recorded`` block, from
    :func:`trace_from_recorded`) replaces the synthetic generator;
    ``record_dir`` records the segmented path's traffic;
    ``fleet_scaling`` embeds a drain-fleet scaling document, so one
    document carries resolution latency and drain throughput."""
    if platform not in PLATFORM_CHOICES:
        raise ValueError(f"platform {platform!r}: want one of "
                         f"{PLATFORM_CHOICES}")
    mix = mix or {"exact": 0.8, "near": 0.15, "cold": 0.05}
    workloads = sorted(csv_globs)
    # measure the host's latency floors before the replay warms anything:
    # the quietest read of what a scheduler wake costs here, recorded so
    # the regression check can tell a slower host from a slower server
    # (obs/noise.py)
    host_noise = None
    if noise_samples > 0:
        host_noise = probe_host_noise(samples=noise_samples)
        if log:
            w = host_noise["timer_wake_us"]
            s = host_noise["hot_spin_us"]
            log(f"replay: host noise floors — timer-wake p50 "
                f"{w['p50_us']:.1f}us p99 {w['p99_us']:.1f}us, hot-spin "
                f"p50 {s['p50_us']:.1f}us p99 {s['p99_us']:.1f}us")
    own_workdir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="tz_serve_replay.")
    try:
        stores = _warm_stores(workdir, csv_globs, topk, log, platform)
        if trace is None:
            trace = build_trace(workloads, n, seed, mix)
        else:
            n = len(trace)
            mix = (recorded or {}).get("mix", mix)
        legacy = _replay_legacy(
            stores["mono"], os.path.join(workdir, "q-mono"),
            stores["mono"] + ".model.json", trace, log, platform)
        seg = _replay_segmented(
            stores["seg"], os.path.join(workdir, "q-seg"), trace, qps,
            max_pending, workers, request_timeout, log, platform,
            record_dir=record_dir, busy_poll_us=busy_poll_us)
        speedup = None
        le = legacy["resolve_us"].get("exact")
        se = seg["resolve_us"].get("exact")
        if le and se and se["pct99_us"] > 0:
            speedup = round(le["pct99_us"] / se["pct99_us"], 2)
        return {
            "kind": "serve_trace_replay",
            "version": REPLAY_VERSION,
            "platform": platform,
            "n": n, "qps": qps, "seed": seed, "mix": mix,
            "workloads": workloads,
            # pacing provenance: where the paced rate came from; what
            # this host sustains is measured, not assumed
            "pacing": dict({"qps": qps, "default_qps": DEFAULT_QPS,
                            "sustained_note":
                                "the default pace asserts no host's "
                                "rate; this host's sustained rate is "
                                "segmented.qps_effective"},
                           **(pacing or {})),
            "warm": stores["warm"],
            **({"host_noise": host_noise} if host_noise else {}),
            **({"recorded": recorded} if recorded else {}),
            "monolithic": legacy,
            "segmented": seg,
            **({"fleet_scaling": fleet_scaling} if fleet_scaling else {}),
            "exact_pct99_speedup": speedup,
        }
    finally:
        if own_workdir and not keep_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tenzing_tpu_torch.serve.replay",
        description="Replay a synthetic high-QPS query trace against the "
                    "legacy monolithic and the segmented serving paths.")
    ap.add_argument("--platform", required=True, choices=PLATFORM_CHOICES,
                    help="the device the corpora were measured on; every "
                         "fingerprint warmed and resolved carries it (a "
                         "CSV does not say where it was measured)")
    ap.add_argument("--halo-csv", nargs="*", default=None, metavar="GLOB",
                    help="halo recorded databases (default: the "
                         "committed experiments/halo_search_tpu_r[45]* "
                         "corpus)")
    ap.add_argument("--spmv-csv", nargs="*", default=None, metavar="GLOB",
                    help="spmv recorded databases (default: the "
                         "committed experiments/spmv_search_tpu.csv)")
    ap.add_argument("--n", type=int, default=1200,
                    help="queries in the trace")
    ap.add_argument("--qps", type=float, default=None,
                    help="paced submission rate for the segmented path "
                         f"(default {DEFAULT_QPS:.0f}, or the recorded "
                         "stream's inter-arrival estimate under "
                         "--from-recorded)")
    ap.add_argument("--fleet-json", default=None, metavar="PATH",
                    help="embed a drain-fleet scaling document (a JSON "
                         "file) as the result's fleet_scaling section")
    ap.add_argument("--record", default=None, metavar="DIR",
                    help="record the segmented path's replayed traffic "
                         "into this request-log directory "
                         "(serve/reqlog.py)")
    ap.add_argument("--from-recorded", dest="from_recorded", default=None,
                    metavar="DIR",
                    help="replay the empirical mix reconstructed from a "
                         "recorded request log instead of the synthetic "
                         "generator")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--mix", default="exact=0.8,near=0.15,cold=0.05",
                    help="tier-class mix, k=v comma list")
    ap.add_argument("--topk", type=int, default=3,
                    help="winners warmed per workload")
    ap.add_argument("--max-pending", type=int, default=256)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--busy-poll-us", type=float, default=0.0,
                    help="segmented-path worker busy-poll window in µs "
                         "(serve listen --busy-poll-us; 0 = blocking "
                         "waits) — recorded in the result's segmented "
                         "block")
    ap.add_argument("--request-timeout", type=float, default=30.0)
    ap.add_argument("--noise-samples", type=int, default=64,
                    help="host-noise floor probe samples stamped into "
                         "the result's host_noise block (0 disables; "
                         "obs/noise.py)")
    ap.add_argument("--workdir", default=None,
                    help="keep stores/queues here (default: temp, "
                         "removed)")
    ap.add_argument("--out", default=None,
                    help="write the result document here")
    args = ap.parse_args(argv)
    mix: Dict[str, float] = {}
    for part in args.mix.split(","):
        k, _, v = part.partition("=")
        mix[k.strip()] = float(v)
    csv_globs: Dict[str, List[str]] = {}
    halo = (args.halo_csv if args.halo_csv is not None
            else ["experiments/halo_search_tpu_r[45]*.csv"])
    spmv = (args.spmv_csv if args.spmv_csv is not None
            else ["experiments/spmv_search_tpu.csv"])
    if halo:
        csv_globs["halo"] = halo
    if spmv:
        csv_globs["spmv"] = spmv
    def log(m):
        sys.stderr.write(m + "\n")

    trace = recorded = None
    qps = args.qps if args.qps is not None else DEFAULT_QPS
    pacing_source = "override" if args.qps is not None else "default"
    if args.from_recorded:
        try:
            trace, recorded = trace_from_recorded(args.from_recorded,
                                                  log=log)
        except (OSError, ValueError) as e:
            sys.stderr.write(f"replay: {e}\n")
            return 2
        est = recorded.get("qps_estimate")
        if args.qps is None and est is not None and est > 0:
            # pace like the recorded stream unless the operator says so
            qps = est
            pacing_source = "recorded-estimate"
        sys.stderr.write(
            f"replay: recorded trace {recorded['records']} request(s), "
            f"mix {recorded['mix']}, qps~{recorded['qps_estimate']}\n")
    fleet_scaling = None
    if args.fleet_json:
        try:
            with open(args.fleet_json) as f:
                fleet_scaling = json.load(f)
        except (OSError, ValueError) as e:
            sys.stderr.write(f"replay: unreadable --fleet-json "
                             f"{args.fleet_json} ({e})\n")
            return 2
    doc = run_replay(csv_globs, args.platform, n=args.n, qps=qps, seed=args.seed,
                     mix=mix, topk=args.topk, workdir=args.workdir,
                     keep_workdir=args.workdir is not None,
                     max_pending=args.max_pending, workers=args.workers,
                     request_timeout=args.request_timeout,
                     record_dir=args.record, trace=trace,
                     recorded=recorded,
                     pacing={"source": pacing_source},
                     fleet_scaling=fleet_scaling,
                     noise_samples=args.noise_samples,
                     busy_poll_us=args.busy_poll_us, log=log)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        sys.stderr.write(f"replay: {args.out}\n")
    sys.stdout.write(json.dumps({
        "platform": doc["platform"],
        "exact_pct99_speedup": doc["exact_pct99_speedup"],
        "monolithic_exact": doc["monolithic"]["resolve_us"].get("exact"),
        "segmented_exact": doc["segmented"]["resolve_us"].get("exact"),
        "segmented_verifier_calls": doc["segmented"]["verifier_calls"],
        "memo_hit_rate": doc["segmented"]["memo"]["hit_rate"],
        "fp_cache_hit_rate": doc["segmented"]["fp_cache"]["hit_rate"],
        "shed": doc["segmented"]["shed"],
        "timeouts": doc["segmented"]["timeouts"],
        **({"recorded_mix": doc["recorded"]["mix"]}
           if "recorded" in doc else {}),
        **({"reqlog": doc["segmented"]["reqlog"]}
           if "reqlog" in doc["segmented"] else {}),
    }) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
