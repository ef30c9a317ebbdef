"""The search fleet: sharded solvers and fused measurement rounds.

Counterpart of ``tenzing_tpu/search/fleet.py``, with its names, JSON
documents and stderr lines.  One **measurement owner** (the driver process:
it holds the executor, the benchmark stack and the prefetcher) serves N
**search worker** processes:

* Workers run the solvers: hill-climbs from the driver's climb configs, or
  MCTS / DFS shards over rank-agreed disjoint subtrees (``MctsOpts.subtree``
  / ``DfsOpts.subtree``).  A worker never touches the card: it rebuilds the
  choice graph with ``driver.graph_for`` (no CUDA context), verifies its own
  candidates with the device-free verifier and measures through a
  :class:`FleetBenchmarker` proxy that speaks a file protocol to the owner.
  Before it writes a job's done document it checks that CUDA is still
  uninitialized in its process; where it is not, the job fails.
* The owner packs up to K pending requests into one fused device round
  (``benchmark_batch_times`` with per-request ``group_seeds``, so each
  worker's paired batch keeps the visit order, and so the accept decisions,
  it would have had alone) and answers every request from that round.
  ``prefetch`` hints go to the owner's ``PrefetchingBenchmarker``: the next
  round's candidates capture while this round measures.
* Liveness reuses the serving plane's lease protocol (serve/lease.py): each
  job is claimed by hard link and heartbeated by mtime, and the job of a
  killed worker is adopted by a survivor once its lease expires
  (``search.fleet.reclaimed_subtrees``).  Incumbents and claims go through
  :class:`~tenzing_tpu_torch.parallel.control_plane.FileControlPlane`.

Fleet directory layout (one ``tempfile.mkdtemp`` a run)::

    spec.json            request + bench opts + fleet shape (owner writes)
    jobs/job-<k>.json    one solver job (owner writes)
    jobs/job-<k>.lease   worker's claim, lease-protocol heartbeat
    jobs/job-<k>.done.json  the job's sims/final/wall (worker writes)
    jobs/busy-r<rank>    "this worker is inside a job" marker
    jobs/exit-r<rank>.json  the worker's exit report (CUDA state, jobs run)
    mq/req-r<rank>-<n>.json  measurement request (worker writes)
    mq/res-<id>.json     the answer (owner writes)
    ctrl/                FileControlPlane snapshots + claim registry
    owner.hb             owner heartbeat (workers abort if it goes stale)
    stop                 owner's shutdown flag

``--search-workers 1 --measure-batch 1`` is :func:`run_serialized`: the
same jobs inline, each the driver's own ``hill_climb`` call, so that path is
the climb loop's by construction.

Workers start as ``python -m tenzing_tpu_torch.search.fleet DIR RANK``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from tenzing_tpu_torch.bench.benchmarker import BenchOpts, BenchResult
from tenzing_tpu_torch.core.sequence import canonical_key
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.parallel.control_plane import FileControlPlane
from tenzing_tpu_torch.serve.lease import LeaseFile
from tenzing_tpu_torch.utils.atomic import atomic_dump_json, read_json

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def claim_key(seq) -> str:
    """The claim registry's key of a schedule: a digest of its canonical
    (bijection-equivalence) form, the same in every process."""
    return hashlib.sha256(repr(canonical_key(seq)).encode()).hexdigest()[:32]


def _opts_to_json(opts: BenchOpts) -> Dict[str, Any]:
    return {"n_iters": opts.n_iters, "max_retries": opts.max_retries,
            "target_secs": opts.target_secs}


def _opts_from_json(j: Dict[str, Any]) -> BenchOpts:
    return BenchOpts(n_iters=int(j["n_iters"]),
                     max_retries=int(j["max_retries"]),
                     target_secs=float(j["target_secs"]))


def _result_to_json(res: BenchResult) -> Dict[str, Any]:
    return res.to_json()


def _result_from_json(j: Dict[str, Any]) -> BenchResult:
    return BenchResult(
        pct01=j["pct01"], pct10=j["pct10"], pct50=j["pct50"],
        pct90=j["pct90"], pct99=j["pct99"], stddev=j["stddev"],
        times=list(j["times"]) if j.get("times") is not None else None,
        fetch_overhead=j.get("fetch_overhead"))


@dataclass
class FleetJob:
    """One solver job: the unit of lease-claimed, adoptable work.

    ``prefer`` names a policy of ``bench.driver`` (``halo_alias``,
    ``moe_bf16``, ``recorded`` with ``chosen``, the recorded schedule's
    suffix map, or ``generic_xla``), so a worker process can rebuild it.
    ``kind`` picks the solver: ``climb`` (``hill_climb``), ``mcts`` or
    ``dfs`` (sharded by ``subtree``)."""

    index: int
    budget: int
    seed: int
    lanes: int = 2
    phases: Tuple[str, ...] = ("",)
    prefer: str = "generic_xla"
    chosen: Optional[Dict[str, str]] = None
    kind: str = "climb"
    subtree: Optional[Tuple[int, int]] = None

    def to_json(self) -> Dict[str, Any]:
        return {"index": self.index, "budget": self.budget,
                "seed": self.seed, "lanes": self.lanes,
                "phases": list(self.phases), "prefer": self.prefer,
                "chosen": self.chosen, "kind": self.kind,
                "subtree": list(self.subtree) if self.subtree else None}

    @staticmethod
    def from_json(j: Dict[str, Any]) -> "FleetJob":
        return FleetJob(
            index=int(j["index"]), budget=int(j["budget"]),
            seed=int(j["seed"]), lanes=int(j.get("lanes", 2)),
            phases=tuple(j.get("phases") or ("",)),
            prefer=j.get("prefer", "generic_xla"),
            chosen=j.get("chosen"), kind=j.get("kind", "climb"),
            subtree=tuple(j["subtree"]) if j.get("subtree") else None)


def resolve_prefer(job: FleetJob):
    """The job's choice policy, rebuilt from its name: the driver's own
    functions, so a worker and the inline path decide alike."""
    from tenzing_tpu_torch.bench import driver as _driver

    if job.prefer == "halo_alias":
        return _driver.halo_alias_prefer
    if job.prefer == "moe_bf16":
        return _driver.moe_bf16_prefer
    if job.prefer == "recorded":
        return _driver.recorded_prefer(dict(job.chosen or {}))
    return _driver.generic_xla_prefer


@dataclass
class FleetJobResult:
    index: int
    sims: List = field(default_factory=list)      # SimResult entries
    final: Optional[object] = None                # SimResult | None
    wall_s: float = 0.0
    worker: Optional[str] = None
    reclaimed: bool = False
    failed: Optional[str] = None


@dataclass
class FleetResult:
    jobs: List[FleetJobResult] = field(default_factory=list)
    stats: Dict[str, Any] = field(default_factory=dict)

    def sims(self) -> List:
        return [s for jr in self.jobs for s in jr.sims]

    def finals(self) -> List:
        return [jr.final for jr in self.jobs if jr.final is not None]


class SharedSearchState:
    """A worker's side of the fleet's exchange (``LocalOpts.shared``):
    schedule claims through the control plane's winner-takes-all registry,
    and the incumbent published whenever it improves.  Every rank reads
    every other's latest snapshot; the reader takes the minimum
    (:meth:`global_best`)."""

    def __init__(self, cp: FileControlPlane):
        self.cp = cp
        self.claimed = 0
        self.claim_misses = 0
        self._best: Optional[float] = None

    def claim(self, seq) -> bool:
        ok = self.cp.claim("visited", claim_key(seq))
        if ok:
            self.claimed += 1
        else:
            self.claim_misses += 1
            get_metrics().counter("search.fleet.claim_misses").inc()
        return ok

    def note_incumbent(self, cost_s: float, seq) -> None:
        if self._best is not None and cost_s >= self._best:
            return
        self._best = cost_s
        from tenzing_tpu_torch.core.serdes import sequence_to_json

        self.cp.publish("incumbent", {
            "cost_s": cost_s, "seq": sequence_to_json(seq),
            "claimed": self.claimed, "claim_misses": self.claim_misses})

    def global_best(self) -> Optional[Tuple[int, float]]:
        """(rank, cost_s) of the best incumbent any rank has published."""
        best = None
        for rank, snap in self.cp.gather("incumbent").items():
            try:
                c = float(snap["cost_s"])
            except (KeyError, TypeError, ValueError):
                continue
            if best is None or c < best[1]:
                best = (rank, c)
        return best


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


class FleetBenchmarker:
    """The worker's benchmarker: each ``benchmark`` /
    ``benchmark_batch_times`` / ``prefetch`` call is a request file the
    owner answers.  It offers exactly what the solvers look for
    (``hill_climb`` finds ``benchmark_batch_times`` by getattr, a solver's
    ``prefetch`` option needs ``.prefetch``), so they run unchanged.
    ``rank_coherent`` is the owner's stack's: an error the owner answers was
    classified there, and a solver may reject the candidate and go on
    (``bench.benchmarker.rejects_failures``), as the reference's does."""

    def __init__(self, fleet_dir: str, rank: int, graph,
                 timeout_secs: float = 900.0,
                 owner_stale_secs: float = 60.0,
                 rank_coherent: bool = False):
        self.dir = fleet_dir
        self.rank = int(rank)
        self.graph = graph
        self.timeout_secs = timeout_secs
        self.owner_stale_secs = owner_stale_secs
        self.rank_coherent = bool(rank_coherent)
        self._n = 0

    def _submit(self, kind: str, orders, opts: Optional[BenchOpts],
                seed: int) -> str:
        from tenzing_tpu_torch.core.serdes import sequence_to_json

        self._n += 1
        rid = f"r{self.rank}-{self._n}"
        atomic_dump_json(
            os.path.join(self.dir, "mq", f"req-{rid}.json"),
            {"id": rid, "kind": kind,
             "orders": [sequence_to_json(o) for o in orders],
             "seed": int(seed),
             "opts": _opts_to_json(opts if opts is not None else BenchOpts())})
        return rid

    def _await(self, rid: str) -> Dict[str, Any]:
        res_path = os.path.join(self.dir, "mq", f"res-{rid}.json")
        hb = os.path.join(self.dir, "owner.hb")
        deadline = time.time() + self.timeout_secs
        while True:
            if os.path.exists(res_path):
                out = read_json(res_path)
                try:
                    os.unlink(res_path)
                except OSError:
                    pass
                err = out.get("error")
                if err is not None:
                    self._raise(err)
                return out
            if os.path.exists(os.path.join(self.dir, "stop")):
                raise RuntimeError("fleet owner requested stop mid-request")
            try:
                stale = time.time() - os.path.getmtime(hb)
            except OSError:
                stale = 0.0
            if stale > self.owner_stale_secs:
                raise RuntimeError(
                    f"fleet owner heartbeat stale ({stale:.0f}s) — "
                    "measurement owner presumed dead")
            if time.time() > deadline:
                raise RuntimeError(f"fleet measurement request {rid} timed "
                                   f"out after {self.timeout_secs:.0f}s")
            time.sleep(0.005)

    @staticmethod
    def _raise(err: Dict[str, Any]):
        from tenzing_tpu_torch.fault.errors import DeviceLostError

        msg = f"[owner] {err.get('type', '?')}: {err.get('msg', '')}"
        if err.get("class") == "device_lost":
            raise DeviceLostError(msg)
        raise RuntimeError(msg)

    # -- the benchmarker protocol -------------------------------------------
    def benchmark(self, order, opts: Optional[BenchOpts] = None) -> BenchResult:
        rid = self._submit("single", [order], opts, 0)
        return _result_from_json(self._await(rid)["result"])

    def benchmark_batch_times(self, orders, opts: Optional[BenchOpts] = None,
                              seed: int = 0, times_out=None):
        rid = self._submit("batch", orders, opts, seed)
        times = [list(ts) for ts in self._await(rid)["times"]]
        if times_out is not None:
            for dst, src in zip(times_out, times):
                dst.clear()
                dst.extend(src)
            return times_out
        return times

    def prefetch(self, orders) -> int:
        """Capture hints, sent and not waited for: the owner forwards them
        to its prefetcher, so the next round's candidates capture while
        this round holds the card."""
        orders = [o for o in orders]
        if orders:
            self._submit("hint", orders, None, 0)
        return len(orders)


def _renewer(lease: LeaseFile, stop: threading.Event,
             lost: threading.Event, period: float) -> threading.Thread:
    def loop():
        while not stop.wait(period):
            if not lease.renew():
                lost.set()
                return

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


def _run_job(job: FleetJob, graph, proxy: FleetBenchmarker,
             shared: SharedSearchState, opts: BenchOpts, verify: bool):
    """Run one solver job against the proxy; returns (sims, final)."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.verify import ScheduleVerifier

    platform = Platform.make_n_lanes(job.lanes)
    verifier = ScheduleVerifier(graph) if verify else None
    if job.kind == "mcts":
        from tenzing_tpu_torch.solve.mcts.mcts import MctsOpts, explore

        r = explore(graph, platform, proxy,
                    MctsOpts(n_iters=job.budget, bench_opts=opts,
                             seed=job.seed, verify=verifier,
                             subtree=job.subtree, prefetch=proxy))
        return r.sims, r.best()
    if job.kind == "dfs":
        from tenzing_tpu_torch.solve.dfs import DfsOpts, explore

        r = explore(graph, platform, proxy,
                    DfsOpts(max_seqs=job.budget, bench_opts=opts,
                            batch=True, batch_seed=job.seed,
                            verify=verifier, subtree=job.subtree))
        return r.sims, r.best()
    from tenzing_tpu_torch.solve.local import LocalOpts, hill_climb

    r = hill_climb(
        graph, platform, proxy, job.phases, prefer=resolve_prefer(job),
        opts=LocalOpts(budget=job.budget, bench_opts=opts, seed=job.seed,
                       paired=True, verify=verifier, prefetch=proxy,
                       shared=shared))
    return r.sims, r.final


def cuda_initialized() -> bool:
    """True when this process has created a CUDA context (torch's view)."""
    import torch

    return bool(torch.cuda.is_initialized())


def worker_main(fleet_dir: str, rank: int) -> int:
    """The worker process: claim jobs by lease (adopting expired rivals'),
    run the solver against the measurement proxy, publish incumbents and
    write each job's done document.  Returns a process exit code."""
    from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
    from tenzing_tpu_torch.core.serdes import sequence_to_json

    spec = read_json(os.path.join(fleet_dir, "spec.json"))
    graph, _ = graph_for(DriverRequest(**spec["request"]))
    if spec.get("tile_menu"):
        # the owner's graph carries the planted tile menu (--fuse-search-
        # tiles): every candidate must carry its directive too
        from tenzing_tpu_torch.runtime.fused import with_tile_menu

        graph = with_tile_menu(graph, spec["tile_menu"])
    opts = _opts_from_json(spec["bench_opts"])
    ttl = float(spec.get("lease_ttl", 15.0))
    wid = f"worker-r{rank}"
    jobs = [FleetJob.from_json(read_json(p)) for p in sorted(
        os.path.join(fleet_dir, "jobs", n)
        for n in os.listdir(os.path.join(fleet_dir, "jobs"))
        if n.startswith("job-") and n.endswith(".json")
        and ".done." not in n)]
    proxy = FleetBenchmarker(fleet_dir, rank, graph,
                             rank_coherent=bool(spec.get("rank_coherent")))
    cp = FileControlPlane(os.path.join(fleet_dir, "ctrl"), rank,
                          int(spec.get("n_workers", 1)))
    shared = SharedSearchState(cp)
    busy_marker = os.path.join(fleet_dir, "jobs", f"busy-r{rank}")

    def done_path(j: FleetJob) -> str:
        return os.path.join(fleet_dir, "jobs", f"job-{j.index}.done.json")

    def stopped() -> bool:
        return os.path.exists(os.path.join(fleet_dir, "stop"))

    ran = 0
    while not stopped():
        claimed = None
        for j in jobs:
            if os.path.exists(done_path(j)):
                continue
            lease = LeaseFile(
                os.path.join(fleet_dir, "jobs", f"job-{j.index}.lease"),
                owner=wid, ttl_secs=ttl)
            info = lease.claim()
            if info is not None:
                claimed = (j, lease, info)
                break
        if claimed is None:
            if all(os.path.exists(done_path(j)) for j in jobs):
                break
            # every remaining job is leased by a live rival: wait for it to
            # finish, or for its lease to expire so it can be adopted
            time.sleep(min(1.0, ttl / 4))
            continue
        j, lease, info = claimed
        if info.reclaimed:
            sys.stderr.write(
                f"fleet {wid}: adopted job {j.index} from "
                f"{info.prev_owner} (lease {info.age_s}s stale)\n")
        with open(busy_marker, "w") as f:
            f.write(str(j.index))
        stop_renew, lost = threading.Event(), threading.Event()
        _renewer(lease, stop_renew, lost, max(0.2, ttl / 3))
        t0 = time.time()
        doc: Dict[str, Any] = {
            "index": j.index, "worker": wid,
            "reclaimed": bool(info.reclaimed)}
        try:
            sims, final = _run_job(j, graph, proxy, shared, opts,
                                   verify=bool(spec.get("verify", True)))
            if cuda_initialized():
                raise RuntimeError("the worker initialized CUDA: workers "
                                   "measure only through the owner")
            doc["sims"] = [
                {"seq": sequence_to_json(s.order),
                 "result": _result_to_json(s.result)} for s in sims]
            doc["final"] = (
                {"seq": sequence_to_json(final.order),
                 "result": _result_to_json(final.result)}
                if final is not None else None)
            ran += 1
        except BaseException as e:  # a failed job must not stall the fleet
            doc["failed"] = f"{type(e).__name__}: {str(e)[:300]}"
            sys.stderr.write(f"fleet {wid}: job {j.index} failed "
                             f"({doc['failed']})\n")
        finally:
            stop_renew.set()
            doc["wall_s"] = round(time.time() - t0, 3)
            doc["cuda_initialized"] = cuda_initialized()
            try:
                os.unlink(busy_marker)
            except OSError:
                pass
        if lost.is_set() or not lease.owns():
            # a rival adopted this job during a stall: its result (the same
            # seed, the same job) stands, and this one is dropped
            sys.stderr.write(
                f"fleet {wid}: lost job {j.index} lease mid-run; "
                "dropping result\n")
            continue
        atomic_dump_json(done_path(j), doc)
        lease.release()
    atomic_dump_json(os.path.join(fleet_dir, "jobs", f"exit-r{rank}.json"),
                     {"rank": rank, "worker": wid, "jobs_run": ran,
                      "cuda_initialized": cuda_initialized()})
    return 0


# ---------------------------------------------------------------------------
# owner side
# ---------------------------------------------------------------------------


@dataclass
class _Pending:
    rid: str
    orders: List
    seed: int
    opts_key: Tuple
    opts: BenchOpts
    at: float


class MeasureOwner:
    """The owner's serve loop: drain the workers' requests, fuse up to
    ``measure_batch`` candidate orders into one grouped device round,
    answer each request, forward prefetch hints, and keep the
    ``search.fleet.*`` counters.  ``longest_round_s`` is the wall of the
    longest fused round (the heartbeat is written only between rounds)."""

    def __init__(self, fleet_dir: str, graph, bench, measure_batch: int,
                 prefetcher=None, grace_secs: float = 0.75, log=None):
        self.dir = fleet_dir
        self.graph = graph
        self.bench = bench
        self.k = max(1, int(measure_batch))
        self.prefetcher = prefetcher
        self.grace = grace_secs
        self.log = log or (lambda m: sys.stderr.write(m + "\n"))
        # the batch protocol is found as hill_climb finds it: the cache does
        # not offer it, its ``.inner`` (journal, resilient, ...) does
        self.batcher = getattr(bench, "benchmark_batch_times", None)
        if self.batcher is None:
            inner = getattr(bench, "inner", None)
            self.batcher = getattr(inner, "benchmark_batch_times", None)
        if self.batcher is None:
            raise RuntimeError(
                "fleet owner needs a benchmark stack exposing "
                "benchmark_batch_times")
        self.rounds = 0
        self.fused_orders = 0
        self.singles = 0
        self.hints = 0
        self.longest_round_s = 0.0
        self._queue: List[_Pending] = []

    # -- protocol plumbing ---------------------------------------------------
    def _respond(self, rid: str, doc: Dict[str, Any]) -> None:
        atomic_dump_json(os.path.join(self.dir, "mq", f"res-{rid}.json"), doc)

    def _error_doc(self, e: BaseException) -> Dict[str, Any]:
        from tenzing_tpu_torch.fault.errors import classify_error

        return {"error": {"type": type(e).__name__,
                          "class": classify_error(e),
                          "msg": str(e)[:300]}}

    def heartbeat(self) -> None:
        with open(os.path.join(self.dir, "owner.hb"), "w") as f:
            f.write(str(os.getpid()))

    def drain(self, busy_workers: int) -> None:
        """One serve tick: take in new requests (hints and singles answered
        at once: a single is a worker's blocking incumbent measurement),
        then fire a fused round if the packing rule says so."""
        from tenzing_tpu_torch.core.serdes import sequence_from_json

        mq = os.path.join(self.dir, "mq")
        try:
            names = sorted(n for n in os.listdir(mq) if n.startswith("req-"))
        except OSError:
            names = []
        for name in names:
            path = os.path.join(mq, name)
            try:
                req = read_json(path)
            except (OSError, ValueError):
                continue
            try:
                os.unlink(path)
            except OSError:
                pass
            try:
                orders = [sequence_from_json(oj, self.graph)
                          for oj in req["orders"]]
            except Exception as e:
                self._respond(req.get("id", name), self._error_doc(e))
                continue
            kind = req.get("kind", "batch")
            if kind == "hint":
                self.hints += len(orders)
                get_metrics().counter("search.fleet.hints").inc(len(orders))
                if self.prefetcher is not None:
                    self.prefetcher.prefetch(orders)
                continue
            opts = _opts_from_json(req["opts"])
            if kind == "single":
                self.singles += 1
                get_metrics().counter("search.fleet.singles").inc()
                try:
                    res = self.bench.benchmark(orders[0], opts)
                    self._respond(req["id"], {"result": _result_to_json(res)})
                except BaseException as e:
                    self._respond(req["id"], self._error_doc(e))
                    self._check_fatal(e)
                continue
            self._queue.append(_Pending(
                rid=req["id"], orders=orders, seed=int(req.get("seed", 0)),
                opts_key=(opts.n_iters, opts.max_retries, opts.target_secs),
                opts=opts, at=time.time()))
        self._maybe_fire(busy_workers)

    def _maybe_fire(self, busy_workers: int) -> None:
        if not self._queue:
            return
        # pack requests of one fidelity (opts) in arrival order until the
        # round holds K orders; an oversized request rides alone
        head_key = self._queue[0].opts_key
        packed: List[_Pending] = []
        orders_n = 0
        for p in self._queue:
            if p.opts_key != head_key:
                continue
            if packed and orders_n + len(p.orders) > self.k:
                break
            packed.append(p)
            orders_n += len(p.orders)
            if orders_n >= self.k:
                break
        oldest = min(p.at for p in packed)
        # fire when the round is full, when every busy worker has a request
        # waiting (nothing more can come until one is answered), or when the
        # oldest request has waited out the grace window
        if (orders_n < self.k and len(packed) < max(1, busy_workers)
                and time.time() - oldest < self.grace):
            return
        for p in packed:
            self._queue.remove(p)
        all_orders = [o for p in packed for o in p.orders]
        group_seeds = [(len(p.orders), p.seed) for p in packed]
        self.rounds += 1
        self.fused_orders += len(all_orders)
        reg = get_metrics()
        reg.counter("search.fleet.rounds").inc()
        reg.counter("search.fleet.fused_orders").inc(len(all_orders))
        reg.gauge("search.fleet.batch_occupancy").set(self.occupancy())
        tr = get_tracer()
        if tr.enabled:
            tr.event("fleet.round", n_requests=len(packed),
                     n_orders=len(all_orders), k=self.k)
        t0 = time.time()
        try:
            times = self.batcher(all_orders, packed[0].opts,
                                 seed=packed[0].seed,
                                 group_seeds=group_seeds)
        except BaseException as e:
            for p in packed:
                self._respond(p.rid, self._error_doc(e))
            self._check_fatal(e)
            return
        finally:
            self.longest_round_s = max(self.longest_round_s, time.time() - t0)
        off = 0
        for p in packed:
            self._respond(p.rid, {
                "times": [list(ts) for ts in times[off:off + len(p.orders)]]})
            off += len(p.orders)

    def _check_fatal(self, e: BaseException) -> None:
        from tenzing_tpu_torch.fault.errors import DeviceLostError

        if isinstance(e, (KeyboardInterrupt, SystemExit, DeviceLostError)):
            raise e

    def occupancy(self) -> float:
        return (self.fused_orders / (self.rounds * self.k)
                if self.rounds else 0.0)


def _spawn_worker(fleet_dir: str, rank: int) -> subprocess.Popen:
    """A worker process on this interpreter, its output on our stderr, the
    port's package on its path whatever the working directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)
    try:
        out = sys.stderr.fileno()
    except (AttributeError, OSError, ValueError):
        out = None
    return subprocess.Popen(
        [sys.executable, "-m", "tenzing_tpu_torch.search.fleet",
         fleet_dir, str(rank)],
        stdout=out, stderr=out, env=env)


def _load_done(fleet_dir: str, graph, jobs: List[FleetJob]
               ) -> List[FleetJobResult]:
    from tenzing_tpu_torch.core.serdes import sequence_from_json
    from tenzing_tpu_torch.solve.mcts.mcts import SimResult

    def sim_of(sj):
        return SimResult(order=sequence_from_json(sj["seq"], graph),
                         result=_result_from_json(sj["result"]))

    out = []
    for j in jobs:
        path = os.path.join(fleet_dir, "jobs", f"job-{j.index}.done.json")
        jr = FleetJobResult(index=j.index)
        try:
            doc = read_json(path)
        except (OSError, ValueError):
            jr.failed = "no result (worker never completed the job)"
            out.append(jr)
            continue
        jr.worker = doc.get("worker")
        jr.reclaimed = bool(doc.get("reclaimed"))
        jr.wall_s = float(doc.get("wall_s", 0.0))
        jr.failed = doc.get("failed")
        if jr.failed is None:
            jr.sims = [sim_of(sj) for sj in doc.get("sims", [])]
            if doc.get("final") is not None:
                jr.final = sim_of(doc["final"])
        out.append(jr)
    return out


def _worker_cuda(fleet_dir: str) -> Dict[str, bool]:
    """``{rank: cuda_initialized}`` from the workers' exit reports (a killed
    worker writes none)."""
    out: Dict[str, bool] = {}
    d = os.path.join(fleet_dir, "jobs")
    for name in sorted(os.listdir(d)):
        if name.startswith("exit-r") and name.endswith(".json"):
            try:
                doc = read_json(os.path.join(d, name))
            except (OSError, ValueError):
                continue
            out[str(doc.get("rank"))] = bool(doc.get("cuda_initialized"))
    return out


def run_fleet(graph, request_json: Dict[str, Any], jobs: List[FleetJob],
              bench, opts: BenchOpts, n_workers: int, measure_batch: int,
              prefetcher=None, verify: bool = True,
              fleet_dir: Optional[str] = None, lease_ttl: float = 15.0,
              grace_secs: float = 0.75, max_restarts: int = 2,
              tile_menu: Optional[List[int]] = None,
              log=None) -> FleetResult:
    """Run ``jobs`` over ``n_workers`` worker processes with this process as
    the measurement owner; returns once every job has a done document (or
    the fleet cannot go on), with the merged results and the
    ``perf.distributed`` stats block.  ``tile_menu`` is the fused-region
    tile menu the driver planted in ``graph`` (``runtime/fused.py``
    ``with_tile_menu``), which the workers plant in theirs."""
    log = log or (lambda m: sys.stderr.write(m + "\n"))
    own_dir = fleet_dir is None
    fleet_dir = fleet_dir or tempfile.mkdtemp(prefix="tenzing-fleet-")
    for sub in ("jobs", "mq", "ctrl"):
        os.makedirs(os.path.join(fleet_dir, sub), exist_ok=True)
    atomic_dump_json(os.path.join(fleet_dir, "spec.json"), {
        "request": request_json, "bench_opts": _opts_to_json(opts),
        "n_workers": int(n_workers), "measure_batch": int(measure_batch),
        "lease_ttl": lease_ttl, "verify": bool(verify),
        "rank_coherent": bool(getattr(bench, "rank_coherent", False)),
        "tile_menu": list(tile_menu) if tile_menu else None})
    for j in jobs:
        atomic_dump_json(
            os.path.join(fleet_dir, "jobs", f"job-{j.index}.json"),
            j.to_json())
    owner = MeasureOwner(fleet_dir, graph, bench, measure_batch,
                         prefetcher=prefetcher, grace_secs=grace_secs,
                         log=log)
    owner.heartbeat()
    t0 = time.time()
    procs: Dict[int, subprocess.Popen] = {
        r: _spawn_worker(fleet_dir, r) for r in range(n_workers)}
    restarts = 0
    worker_exits = 0

    def all_done() -> bool:
        return all(os.path.exists(os.path.join(
            fleet_dir, "jobs", f"job-{j.index}.done.json")) for j in jobs)

    def busy_workers() -> int:
        live = {r for r, p in procs.items() if p.poll() is None}
        n = 0
        try:
            for name in os.listdir(os.path.join(fleet_dir, "jobs")):
                if name.startswith("busy-r"):
                    try:
                        if int(name[6:]) in live:
                            n += 1
                    except ValueError:
                        pass
        except OSError:
            pass
        return n

    last_hb = 0.0
    try:
        while not all_done():
            now = time.time()
            if now - last_hb > 1.0:
                owner.heartbeat()
                last_hb = now
            live = [r for r, p in procs.items() if p.poll() is None]
            for r, p in list(procs.items()):
                rc = p.poll()
                if rc is not None and rc != 0:
                    worker_exits += 1
                    del procs[r]
            if not live and not all_done():
                if restarts >= max_restarts:
                    log("fleet: no live workers and restart budget "
                        "exhausted — finishing with partial results")
                    break
                restarts += 1
                log(f"fleet: all workers dead with jobs remaining — "
                    f"restart {restarts}/{max_restarts}")
                r = max(procs.keys(), default=-1) + 1 + n_workers
                procs[r] = _spawn_worker(fleet_dir, r)
            owner.drain(busy_workers())
            time.sleep(0.005)
        owner.drain(busy_workers())  # answer any last request in flight
    finally:
        with open(os.path.join(fleet_dir, "stop"), "w") as f:
            f.write("done")
        deadline = time.time() + 10.0
        for p in procs.values():
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.02)
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    job_results = _load_done(fleet_dir, graph, jobs)
    reclaimed = sum(1 for jr in job_results if jr.reclaimed)
    get_metrics().counter("search.fleet.reclaimed_subtrees").inc(reclaimed)
    cp = FileControlPlane(os.path.join(fleet_dir, "ctrl"), -1, n_workers)
    incumbents = {r: snap.get("cost_s")
                  for r, snap in cp.gather("incumbent").items()}
    candidates = sum(len(jr.sims) for jr in job_results)
    distinct, best = _coverage(job_results)
    stats = {
        "workers": int(n_workers),
        "measure_batch": owner.k,
        "jobs": len(jobs),
        "failed_jobs": sum(1 for jr in job_results if jr.failed),
        "wall_s": round(wall, 3),
        "candidates": candidates,
        "distinct_candidates": distinct,
        "best_cost_us": best,
        "candidates_per_s": round(candidates / wall, 3) if wall else 0.0,
        "rounds": owner.rounds,
        "singles": owner.singles,
        "hints": owner.hints,
        "batch_occupancy": round(owner.occupancy(), 3),
        "longest_round_s": round(owner.longest_round_s, 3),
        "reclaimed_subtrees": reclaimed,
        "worker_exits": worker_exits,
        "worker_restarts": restarts,
        "worker_cuda_initialized": _worker_cuda(fleet_dir),
        "claimed_keys": cp.claim_count("visited"),
        "job_wall_s": [jr.wall_s for jr in job_results],
        "job_candidates": [len(jr.sims) for jr in job_results],
        "scaling_factor": (
            round(sum(jr.wall_s for jr in job_results) / wall, 2)
            if wall else 0.0),
        "incumbent_costs_s": incumbents,
    }
    if own_dir:
        import shutil

        shutil.rmtree(fleet_dir, ignore_errors=True)
    return FleetResult(jobs=job_results, stats=stats)


def _coverage(job_results: List[FleetJobResult]):
    """(distinct canonical candidates measured, best pct50 in µs) over every
    job's sims: the serialized path re-measures neighbours two jobs share,
    the fleet's claim registry measures each once."""
    keys = set()
    best = None
    for jr in job_results:
        for s in jr.sims:
            keys.add(claim_key(s.order))
            if best is None or s.result.pct50 < best:
                best = s.result.pct50
    return len(keys), (round(best * 1e6, 3) if best is not None else None)


def run_serialized(graph, jobs: List[FleetJob], bench, opts: BenchOpts,
                   surrogate=None, ckpt=None, verifier=None,
                   prefetcher=None) -> FleetResult:
    """``--search-workers 1 --measure-batch 1``: the same jobs inline, one
    ``hill_climb`` a job with the climb loop's own arguments (benchmark
    stack, prescreen, checkpoint, verifier, prefetcher, seeds), so its
    incumbents are the loop's, and its wall is the serialized baseline."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.solve.local import LocalOpts, hill_climb

    out = FleetResult()
    t_all = time.time()
    for j in jobs:
        t0 = time.time()
        jr = FleetJobResult(index=j.index, worker="inline")
        try:
            r = hill_climb(
                graph, Platform.make_n_lanes(j.lanes), bench, j.phases,
                prefer=resolve_prefer(j),
                opts=LocalOpts(budget=j.budget, bench_opts=opts,
                               seed=j.seed, paired=True,
                               prescreen=surrogate, checkpoint=ckpt,
                               verify=verifier, prefetch=prefetcher))
            jr.sims, jr.final = r.sims, r.final
        except RuntimeError as e:
            from tenzing_tpu_torch.fault.errors import DeviceLostError

            if isinstance(e, DeviceLostError):
                raise
            jr.failed = f"{type(e).__name__}: {str(e)[:300]}"
        jr.wall_s = round(time.time() - t0, 3)
        out.jobs.append(jr)
    wall = time.time() - t_all
    candidates = sum(len(jr.sims) for jr in out.jobs)
    distinct, best = _coverage(out.jobs)
    out.stats = {
        "workers": 1, "measure_batch": 1, "jobs": len(jobs),
        "failed_jobs": sum(1 for jr in out.jobs if jr.failed),
        "wall_s": round(wall, 3),
        "candidates": candidates,
        "distinct_candidates": distinct,
        "best_cost_us": best,
        "candidates_per_s": round(candidates / wall, 3) if wall else 0.0,
        "rounds": 0, "singles": 0, "hints": 0,
        "batch_occupancy": None, "reclaimed_subtrees": 0,
        "worker_exits": 0, "worker_restarts": 0,
        "job_wall_s": [jr.wall_s for jr in out.jobs],
        "job_candidates": [len(jr.sims) for jr in out.jobs],
        "scaling_factor": 1.0,
        "incumbent_costs_s": {},
    }
    return out


if __name__ == "__main__":  # pragma: no cover - run as a subprocess
    sys.exit(worker_main(sys.argv[1], int(sys.argv[2])))
