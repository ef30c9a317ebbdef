"""Exhaustive depth-first schedule enumeration and benchmarking.

Counterpart of ``tenzing_tpu/solve/dfs.py`` (reference ``tenzing-dfs``,
dfs.hpp/dfs.cpp): ``get_all_sequences`` is a worklist DFS over
``State.frontier`` with equivalence-class dedup at each expansion
(dfs.cpp:16-82); ``explore`` enumerates, dedups completed schedules under
resource bijection (dfs.hpp:88-113), benchmarks each one and collects the
results.

Each structural variant's order x lane space is enumerated by the native
C++ core (native/bridge.py) where the variant lowers, else by the Python
worklist (:func:`_dfs_terminals`); both count unique terminals against
``max_seqs``, so the terminal set is the same.  With a ``control_plane``
of more than one rank, rank 0 enumerates and verifies, and the count and
every schedule are broadcast as JSON (reference dfs.py:289-370,
dfs.hpp:50-70, 145-167); every rank measures every schedule, one at a time
(``batch`` is ignored, as in the reference).  A measurement that raises is recorded
(``search.candidate_failed``) and skips the terminal where the benchmarker
is rank-coherent (the resilient layer classified it) and the device was not
lost; otherwise it propagates, as in the port's MCTS.  With ``checkpoint``
rank 0 snapshots the cursor (every 25 terminals, after a batch, and on an
interrupt), as the reference does.  Telemetry: ``dfs.explore``,
``dfs.enumerate``, ``dfs.enumerate_variant`` and a ``dfs.iter`` span per
schedule measured one at a time, as in the reference.  Compile prefetching
is the reference's: with ``prefetch`` (a bench/pipeline.py
``PrefetchingBenchmarker``) the next ``prefetch_lookahead`` terminals are
hinted while terminal i measures (the batch path needs no hint: a
prefetcher in the benchmark stack hints the whole batch itself).  With
``prescreen`` (a learn/surrogate.py ``SurrogateBenchmarker``) and
``prescreen_keep`` > 0, rank 0 measures only the ``prescreen_keep``
terminals the surrogate ranks fastest (``learn.prune.dfs_skipped`` counts
the rest), as the reference does.  With ``subtree`` ``(k, n)`` (the search
fleet's) rank 0 keeps every n-th terminal from the k-th, as the reference
does.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List, Optional

from tenzing_tpu_torch.bench.benchmarker import (
    BenchOpts,
    BenchResult,
    candidate_failed,
    rejects_failures,
    result_row,
    schedule_id,
)
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import ChoiceOp, CompoundOp
from tenzing_tpu_torch.core.sequence import Sequence, canonical_key
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.core.state import State
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.progress import get_reporter
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.parallel.control_plane import ControlPlane, default_control_plane
from tenzing_tpu_torch.utils import trap
from tenzing_tpu_torch.utils.counters import Counters


@dataclass
class DfsOpts:
    """reference dfs::Opts (dfs.hpp:30-40; the maxSeqs cap from
    examples/spmv.cu:117).

    ``batch=True`` benchmarks the whole enumerated set through
    ``benchmark_batch_times`` — every schedule visited once per iteration in
    a fresh random order (reference batch benchmark, benchmarker.cpp:21-76) —
    so slow drift decorrelates from schedule identity.  ``verify`` (a
    ``verify.ScheduleVerifier``) checks every terminal before it is
    measured; an unsound one is skipped.  ``prefetch`` hints the next
    ``prefetch_lookahead`` terminals to a capture prefetcher.
    ``checkpoint`` (a ``fault.checkpoint.SearchCheckpoint``) gets the
    cursor.  ``prescreen`` (a surrogate with ``predict(order) -> (mean,
    std)``) keeps the ``prescreen_keep`` terminals it predicts fastest.
    ``subtree`` ``(k, n)`` keeps the terminals ``k % n, k % n + n, ...``
    after the prescreen (the fleet's slice; an empty slice keeps terminal
    ``k % len``)."""

    max_seqs: int = 15000
    bench_opts: BenchOpts = field(default_factory=BenchOpts)
    dump_csv_path: Optional[str] = None
    batch: bool = False
    batch_seed: int = 0
    verify: Optional[object] = None
    prescreen: Optional[object] = None
    prescreen_keep: int = 0
    checkpoint: Optional[object] = None
    prefetch: Optional[object] = None
    prefetch_lookahead: int = 4
    subtree: Optional[tuple] = None

    def to_json(self) -> dict:
        """Provenance stamp of the options (reference dfs.cpp:11-14)."""
        return {"max_seqs": self.max_seqs, "n_iters": self.bench_opts.n_iters,
                "batch": self.batch, "batch_seed": self.batch_seed}


@dataclass
class SimResult:
    """One benchmarked schedule (reference SimResult, dfs.hpp:20-28)."""

    order: Sequence
    result: BenchResult


@dataclass
class DfsResult:
    """reference dfs::Result (dfs.hpp:74-76, dump_csv dfs.cpp:84-105)."""

    sims: List[SimResult] = field(default_factory=list)
    counters: Optional[Counters] = None

    def dump_csv(self, path: Optional[str] = None) -> str:
        # numbered from 1: row 0 is reserved for the naive schedule at final
        # fidelity in the driver's dumps, and a solver dump has no such anchor
        rows = [result_row(i, s.result, s.order)
                for i, s in enumerate(self.sims, start=1)]
        text = "\n".join(rows) + ("\n" if rows else "")
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def best(self) -> Optional[SimResult]:
        if not self.sims:
            return None
        return min(self.sims, key=lambda s: s.result.pct10)


def _dfs_terminals(graph: Graph, platform, max_seqs: int, dedup_terminals: bool,
                   counters: Optional[Counters] = None) -> List[State]:
    """Worklist DFS over ``State.frontier`` (reference get_all_sequences,
    dfs.cpp:16-82; the per-expansion dedup is dfs.cpp:46-58).  With
    ``dedup_terminals`` the cap counts bijection-unique terminals, recognized
    by ``canonical_key``."""
    c = counters if counters is not None else Counters(mirror_global=False)
    terminals: List[State] = []
    seen_keys: set = set()
    stack: List[State] = [State(graph)]
    while stack and len(terminals) < max_seqs:
        st = stack.pop()
        if st.is_terminal():
            if dedup_terminals:
                with c.phase("DEDUP", span=False):
                    key = canonical_key(st.sequence)
                    dup = key in seen_keys
                    seen_keys.add(key)
                if dup:
                    continue
            terminals.append(st)
            continue
        with c.phase("SELECT", span=False):
            stack.extend(st.frontier(platform))
    return terminals


def get_all_sequences(graph: Graph, platform, max_seqs: int = 15000,
                      counters: Optional[Counters] = None) -> List[State]:
    """All complete schedules reachable from the initial state (terminal
    duplicates across converging DFS paths included; ``max_seqs`` caps raw
    terminals)."""
    return _dfs_terminals(graph, platform, max_seqs, dedup_terminals=False,
                          counters=counters)


def get_unique_sequences(graph: Graph, platform, max_seqs: int = 15000,
                         counters: Optional[Counters] = None) -> List[State]:
    """Like :func:`get_all_sequences`, but terminals are deduplicated under
    resource bijection as they are found and ``max_seqs`` counts unique
    terminals (the reference's native enumerator's cap semantics)."""
    return _dfs_terminals(graph, platform, max_seqs, dedup_terminals=True,
                          counters=counters)


def expand_all(graph: Graph) -> Graph:
    """Inline every CompoundOp.  An ExpandOp is the only decision available
    for a frontier compound and commutes with execution order, so eager
    expansion keeps the terminal-schedule space (reference state.cpp:82-87)."""
    while True:
        comps = [v for v in graph.vertices() if isinstance(v, CompoundOp)]
        if not comps:
            return graph
        graph = graph.clone_but_expand(comps[0])


def structural_variants(graph: Graph) -> List[Graph]:
    """All graphs reachable by compound expansion and choice substitution —
    the structural half of the decision space, taken eagerly."""
    graph = expand_all(graph)
    choices = [v for v in graph.vertices() if isinstance(v, ChoiceOp)]
    if not choices:
        return [graph]
    out: List[Graph] = []
    for c in choices[0].choices():
        out.extend(structural_variants(graph.clone_but_replace(c, choices[0])))
    return out


def enumerate_schedules(graph: Graph, platform, max_seqs: int = 15000,
                        counters: Optional[Counters] = None,
                        log=None) -> List[State]:
    """Terminal states with per-expansion and terminal dedup applied.
    Structural decisions are resolved eagerly into graph variants, and each
    variant's order x lane space is enumerated in turn; the ``max_seqs``
    budget is fair-shared across variants (unused share flows to later
    ones).  A variant the native core lowers is enumerated there (its wall
    counted as the ``SELECT`` phase, as in the reference)."""
    from tenzing_tpu_torch.native import bridge

    log = log if log is not None else (lambda m: sys.stderr.write(m + "\n"))
    variants = structural_variants(graph)
    out: List[State] = []
    for k, g in enumerate(variants):
        remaining = max_seqs - len(out)
        if remaining <= 0:
            log(f"dfs: budget exhausted; {len(variants) - k} structural "
                "variant(s) not enumerated (raise max_seqs)")
            break
        share = -(-remaining // (len(variants) - k))  # ceil fair share
        with get_tracer().span("dfs.enumerate_variant", variant=k,
                               share=share) as sp:
            c = counters if counters is not None else Counters(
                mirror_global=False)
            with c.phase("SELECT", span=False):
                nat = bridge.try_enumerate(g, platform, share,
                                           dedup_terminals=True)
            if nat is None:
                nat = get_unique_sequences(g, platform, share,
                                           counters=counters)
            sp.set("n_terminals", len(nat))
        if len(nat) >= share and k + 1 < len(variants):
            log(f"dfs: variant {k} truncated at its fair share ({share} "
                "schedules)")
        out.extend(nat)
    return out


def explore(graph: Graph, platform, benchmarker,
            opts: Optional[DfsOpts] = None,
            control_plane: Optional[ControlPlane] = None) -> DfsResult:
    """Enumerate, dedup and benchmark every schedule (reference dfs::explore,
    dfs.hpp:78-178).  ``control_plane`` defaults to
    ``default_control_plane()``."""
    opts = opts if opts is not None else DfsOpts()
    cp = control_plane if control_plane is not None else default_control_plane()
    counters = Counters(prefix="dfs.phase")
    result = DfsResult(counters=counters)
    mark = opts.checkpoint is not None and cp.rank() == 0

    def interrupted() -> None:
        opts.checkpoint.save_state(
            dfs={"n_sims": len(result.sims), "interrupted": True})

    if mark:
        trap.register_handler(interrupted)
    try:
        with get_tracer().span("dfs.explore", max_seqs=opts.max_seqs,
                               batch=opts.batch):
            _explore(graph, platform, benchmarker, opts, cp, counters, result)
    finally:
        if mark:
            trap.unregister_handler(interrupted)
    if opts.dump_csv_path and cp.rank() == 0:
        result.dump_csv(opts.dump_csv_path)
    return result


def _measure_one(benchmarker, order, opts: DfsOpts, counters: Counters,
                 i: int, result: DfsResult, ahead=(), n: int = 0,
                 lead: bool = True) -> None:
    """Measure one schedule under a ``dfs.iter`` span, first hinting the
    schedules ``ahead`` to the prefetcher; then snapshot the cursor (terminal
    ``i`` of ``n``) every 25 terminals and at the last."""
    tr = get_tracer()
    with tr.span("dfs.iter", i=i) as sp:
        if opts.prefetch is not None and ahead:
            # frontier slice: the next terminals are known — capture them
            # while this one measures.  Re-offering the window each
            # iteration is cheap (id dedup) and lets hints dropped at a
            # full queue resubmit.
            opts.prefetch.prefetch(ahead)
        with counters.phase("BENCHMARK"):
            try:
                res = benchmarker.benchmark(order, opts.bench_opts)
            except Exception as e:
                candidate_failed("dfs.benchmark", order, e)
                if not rejects_failures(benchmarker, e):
                    raise
                sys.stderr.write(f"dfs: terminal rejected ({type(e).__name__}:"
                                 f" {str(e)[:200]})\n")
                res = None
        if res is not None:
            if tr.enabled:
                sp.set("schedule", schedule_id(order))
                sp.set("pct50", res.pct50)
            result.sims.append(SimResult(order=order, result=res))
    if opts.checkpoint is not None and lead and (i % 25 == 0 or i == n - 1):
        opts.checkpoint.save_state(dfs={"i": i, "n": n,
                                        "n_sims": len(result.sims)})


def _explore(graph: Graph, platform, benchmarker, opts: DfsOpts, cp,
             counters: Counters, result: DfsResult) -> None:
    """The body of :func:`explore`: fills ``result``."""
    lead = cp.rank() == 0
    states = []
    if lead:
        with get_tracer().span("dfs.enumerate"):
            states = enumerate_schedules(graph, platform, opts.max_seqs,
                                         counters=counters)
        states = _prescreened(states, opts)
        if opts.subtree is not None and states:
            sk, sn = int(opts.subtree[0]), max(1, int(opts.subtree[1]))
            states = states[sk % sn::sn] or [states[sk % len(states)]]
    orders = [st.sequence for st in states]
    if opts.verify is not None:
        kept = []
        for o in orders:
            verdict = opts.verify(o)
            if verdict.ok:
                kept.append(o)
            else:
                sys.stderr.write("dfs: terminal rejected by the soundness "
                                 f"verifier ({verdict.witness()})\n")
        orders = kept
    if cp.size() > 1:
        if opts.batch and lead:
            sys.stderr.write("dfs: batch=True ignored (multi-rank control "
                             "plane); one at a time\n")
        with counters.phase("BCAST"):
            n = cp.bcast_json(len(orders))
        for i in range(n):
            with counters.phase("BCAST"):
                payload = cp.bcast_json(
                    sequence_to_json(orders[i]) if lead else None)
            o = orders[i] if lead else sequence_from_json(payload, graph)
            _measure_one(benchmarker, o, opts, counters, i, result,
                         _window(orders, i, opts) if lead else (), n, lead)
        return
    batch_times = getattr(benchmarker, "benchmark_batch_times", None)
    if opts.batch and batch_times is None:
        sys.stderr.write(f"dfs: batch=True ignored ({type(benchmarker).__name__} "
                         "has no benchmark_batch_times); one at a time\n")
    if opts.batch and batch_times is not None:
        with counters.phase("BENCHMARK"):
            times = batch_times(orders, opts.bench_opts, seed=opts.batch_seed)
        result.sims = [SimResult(order=o, result=BenchResult.from_times(ts))
                       for o, ts in zip(orders, times)]
        if opts.checkpoint is not None:
            opts.checkpoint.save_state(
                dfs={"batch_done": True, "n_sims": len(result.sims)})
    else:
        for i, o in enumerate(orders):
            _measure_one(benchmarker, o, opts, counters, i, result,
                         _window(orders, i, opts), len(orders))


def _prescreened(states, opts: DfsOpts):
    """The learned triage (reference dfs.py:331-350): the
    ``prescreen_keep`` terminals the surrogate predicts fastest, a stable
    sort keeping the enumeration order among equal predictions."""
    if (opts.prescreen is None or opts.prescreen_keep <= 0
            or len(states) <= opts.prescreen_keep):
        return states
    with get_tracer().span("learn.prescreen", n_in=len(states),
                           keep=opts.prescreen_keep):
        ranked = sorted(range(len(states)), key=lambda i: opts.prescreen.predict(
            states[i].sequence)[0])
        kept = [states[i] for i in ranked[:opts.prescreen_keep]]
    skipped = len(states) - len(kept)
    get_metrics().counter("learn.prune.dfs_skipped").inc(skipped)
    get_reporter().info(f"tenzing-tpu: dfs prescreen kept {len(kept)}/"
                        f"{len(states)} terminals", kept=len(kept),
                        skipped=skipped)
    return kept


def _window(orders, i: int, opts: DfsOpts) -> list:
    """The ``prefetch_lookahead`` terminals after terminal ``i``."""
    return list(orders[i + 1:i + 1 + opts.prefetch_lookahead])
