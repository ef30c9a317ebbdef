"""MCTS search driver.

Counterpart of ``tenzing_tpu/solve/mcts/mcts.py`` (reference
``tenzing-mcts/include/tenzing/mcts/mcts.hpp`` ``explore``, mcts.hpp:154-327):
per iteration — select, expand, rollout to a complete schedule,
``remove_redundant_syncs``, verify, benchmark, backprop — stopping when the
root is fully visited.  Kept from the reference: decision-path seeds consumed
as the first iterations, informed (policy) rollouts, the equivalence-keyed
benchmark cache, the soundness gate, the multi-fidelity screen/confirm
split, the periodic graphviz tree dump (``dump_tree``, decaying cadence,
mcts.hpp:52-127, 302-309) and the CSV dump (``dump_csv_path``), and the
multi-rank protocol (reference mcts.py:264-530, mcts.hpp:129-152,
244): with a ``control_plane`` of more than one rank, rank 0 owns the tree,
and the stop flag and every schedule to measure are broadcast as JSON; every
rank measures every schedule (the benchmarker's barrier and max-reduction
keep their times equal).  At world size 1 no broadcast runs.  Compile
prefetching is the reference's (``MctsOpts.prefetch``, a
bench/pipeline.py ``PrefetchingBenchmarker``): the seeds' terminal
schedules before the first iteration, ``prefetch_rollouts`` speculative
completions of each expanded node's other children (throwaway States, a
forked RNG: the search is the same with the pipeline on and off), and the
confirm queue.  Checkpointing is the reference's (``MctsOpts.checkpoint``:
rank 0 snapshots the cursor after every measured iteration, and the trap
marks an interrupt).  The fleet's subtree slicing is the reference's
(``MctsOpts.subtree``, :func:`prune_to_subtree`).  A measurement that
raises is recorded (``search.candidate_failed``); where the benchmarker is
rank-coherent (the resilient layer classified the failure) the candidate is
rejected with a penalty and the search goes on, as in the reference, unless
the device was lost; otherwise the failure propagates on every rank.

Telemetry (obs/): an ``mcts.explore`` span around the search and an
``mcts.iter`` span per iteration (``seeded``, ``selected``, ``schedule``,
``pct50``, ``fidelity``, ``unsound`` / ``rejected``, ``tree_size``), with
the ``mcts.phase.*`` spans of ``utils/counters.py`` nested inside.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Type

from tenzing_tpu_torch.bench.benchmarker import (
    BenchOpts,
    BenchResult,
    CachingBenchmarker,
    candidate_failed,
    rejects_failures,
    schedule_id,
)
from tenzing_tpu_torch.core.schedule import remove_redundant_syncs
from tenzing_tpu_torch.core.sequence import Sequence, canonical_key
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.core.state import State
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.solve.mcts.node import Node
from tenzing_tpu_torch.solve.mcts.strategies import FastMin
from tenzing_tpu_torch.parallel.control_plane import ControlPlane, default_control_plane
from tenzing_tpu_torch.utils import trap
from tenzing_tpu_torch.utils.counters import Counters


@dataclass
class MctsOpts:
    """reference mcts::Opts (mcts.hpp:42-50)."""

    n_iters: int = 300
    bench_opts: BenchOpts = field(default_factory=BenchOpts)
    # multi-fidelity split: when ``screen_opts`` is set, every rollout is
    # measured at that CHEAP floor (search-time numbers only steer the tree),
    # and after the loop the ``confirm_topk`` best distinct schedules are
    # re-measured at the full ``bench_opts`` floor
    screen_opts: Optional[BenchOpts] = None
    confirm_topk: int = 6
    # informed playouts (Node.get_rollout): complete each rollout with this
    # ``(state, decisions) -> decision`` policy instead of uniform random,
    # taking a random decision with probability ``rollout_eps`` per step
    rollout_policy: Optional[object] = None
    rollout_eps: float = 0.15
    expand_rollout: bool = False
    # graphviz dumps of the tree (Node.dump_graphviz) to
    # ``<dump_tree_prefix>_<it>.dot`` at a decaying cadence (_dump_cadence)
    dump_tree: bool = False
    dump_tree_prefix: str = "mcts_tree"
    # the result's CSV (MctsResult.dump_csv) written here at the end, and on
    # an interrupt what was measured so far
    dump_csv_path: Optional[str] = None
    seed: int = 0
    cache_benchmarks: bool = True
    # fault.checkpoint.SearchCheckpoint: rank 0 snapshots the cursor
    # (iteration, sims, tree size) after every measured iteration, and the
    # trap writes an interrupted snapshot; resume re-runs the seeded search
    # against the journal-restored cache, rebuilding the tree exactly
    checkpoint: Optional[object] = None
    # independent soundness gate (verify.ScheduleVerifier): an unsound
    # rollout is rejected with a penalty backprop and never measured
    verify: Optional[object] = None
    # capture prefetcher (bench.pipeline.PrefetchingBenchmarker): candidate
    # hints — the seeds' terminal schedules up front, ``prefetch_rollouts``
    # speculative completions of each expanded node's other children, the
    # confirm queue — are captured in the background.  Hints consume no
    # search RNG: None (the default) gives the same search.
    prefetch: Optional[object] = None
    prefetch_rollouts: int = 2
    # the fleet's slice ``(k, n)`` (search/fleet.py): search only the k-th
    # of n slices of the root's children (:func:`prune_to_subtree`).  None
    # searches the whole tree.
    subtree: Optional[Tuple[int, int]] = None

    def to_json(self) -> dict:
        return {
            "n_iters": self.n_iters,
            "expand_rollout": self.expand_rollout,
            "seed": self.seed,
            "cache_benchmarks": self.cache_benchmarks,
        }


@dataclass
class SimResult:
    order: Sequence
    result: BenchResult
    # which measurement floor produced ``result``: "full" or "screen"
    fidelity: str = "full"


@dataclass
class MctsResult:
    sims: List[SimResult] = field(default_factory=list)
    tree_size: int = 0
    counters: Optional[Counters] = None

    def dump_csv(self, path: Optional[str] = None) -> str:
        """The reference's dump (bench/benchmarker.py ``result_row``): one row
        per rollout, numbered from 1 (row 0 is the driver's naive anchor);
        only screened rows carry a fidelity cell."""
        from tenzing_tpu_torch.bench.benchmarker import result_row

        rows = [result_row(i, s.result, s.order,
                           fidelity=None if s.fidelity == "full" else s.fidelity)
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


def _dump_cadence(it: int) -> bool:
    """Decaying dump cadence (reference mcts.hpp:302-309): every iteration up
    to 10, then every 10th up to 100, then every 100th."""
    if it < 10:
        return True
    if it < 100:
        return it % 10 == 0
    return it % 100 == 0


def _materialize_seed(root: Node, path) -> tuple:
    """Walk ``path`` (a decision list from ``solve.local.drive``) down the
    tree, creating ONLY the matching child per step; returns (deepest matched
    node, the terminal state reached by applying the FULL path).  Decisions
    match by content key, so a path recorded on an independent State chain of
    the same graph lands on the same tree nodes."""
    node, st = root, root.state
    matched = True
    for d in path:
        st = st.apply(d)
        if matched:
            nxt = next(
                (c for c in node.children
                 if c.decision is not None and c.decision.key() == d.key()),
                None,
            )
            if nxt is None and not node.expanded_ and not node.is_terminal():
                # pre-create just this child; expanded_ stays False so the
                # node's remaining decisions enumerate on first real visit
                nxt = Node(st, node.strategy, d, node)
                node.children.append(nxt)
            if nxt is None:
                matched = False
            else:
                node = nxt
    return node, st


def _seed_orders(graph, seeds, limit: int) -> list:
    """The terminal schedules of the first ``limit`` seed paths, known
    before the first iteration, so their captures can prefetch while the
    first measurements run: pure replay on fresh States, no tree, no RNG.
    ``limit`` (the prefetcher's queue bound) caps the replay work."""
    orders = []
    for path in seeds:
        if len(orders) >= limit:
            break
        st = State(graph)
        for d in path:
            st = st.apply(d)
        if st.is_terminal():
            orders.append(st.sequence)
    return orders


def _speculative_completions(node: Node, platform, prng, k: int,
                             skip: Optional[Node] = None) -> list:
    """Up to ``k`` plausible future rollouts for the prefetcher: the
    unplayed children of the just-expanded node completed to terminal
    schedules on throwaway States with a forked RNG (``prng``).  The tree,
    the search RNG and the (possibly stateful) rollout policy are never
    touched — uniform-random completion only."""
    hints = []
    kids = [c for c in node.children
            if c.n_ == 0 and c is not skip] or [node]
    for child in kids[:k]:
        st = child.state
        while not st.is_terminal():
            ds = st.get_decisions(platform)
            if not ds:
                break
            st = st.apply(prng.choice(ds))
        if st.is_terminal():
            hints.append(remove_redundant_syncs(st.sequence))
    return hints


def prune_to_subtree(root: Node, platform, subtree: Tuple[int, int]) -> None:
    """Keep the k-th of n slices of ``root``'s children (``MctsOpts.subtree``,
    the reference's): the children's enumeration is deterministic, so n
    workers agree on the slices from their ranks alone; child i stays where
    ``i % n == k % n``.  An empty slice keeps the one child
    ``k % len(children)``, so no worker is left with nothing to search."""
    k, n = int(subtree[0]), max(1, int(subtree[1]))
    root.ensure_children(platform)
    kids = root.children
    if not kids:
        return
    keep = [c for i, c in enumerate(kids) if i % n == k % n]
    root.children = keep if keep else [kids[k % len(kids)]]


def explore(
    graph,
    platform,
    benchmarker,
    opts: Optional[MctsOpts] = None,
    strategy: Optional[Type] = None,
    seeds=None,
    control_plane: Optional[ControlPlane] = None,
) -> MctsResult:
    """Run the MCTS search (reference mcts::explore, mcts.hpp:154-327).

    ``seeds`` (optional): decision paths consumed as the FIRST iterations —
    each is materialized as a tree path, benchmarked like any rollout and
    backpropagated, warm-starting the selection statistics.
    ``control_plane`` defaults to ``default_control_plane()``; every rank
    calls ``explore`` with the same graph, options and seeds."""
    opts = opts if opts is not None else MctsOpts()
    strategy = strategy if strategy is not None else FastMin
    cp = control_plane if control_plane is not None else default_control_plane()
    rng = _random.Random(opts.seed)
    counters = Counters(prefix="mcts.phase")
    result = MctsResult(counters=counters)
    if opts.cache_benchmarks and not isinstance(benchmarker, CachingBenchmarker):
        # local on every rank: the broadcast order is identical on all of
        # them, so hits and misses agree rank to rank
        benchmarker = CachingBenchmarker(benchmarker)
    tr = get_tracer()

    def interrupted() -> None:
        # the SIGINT snapshot: what was measured so far to dump_csv_path
        # (reference mcts.hpp:174-179, which prints it to stdout without a
        # path: here nothing is written where none was asked for), and the
        # cursor, while the journal already holds every measurement
        if opts.dump_csv_path:
            result.dump_csv(opts.dump_csv_path)
        if opts.checkpoint is not None:
            opts.checkpoint.save_state(
                mcts={"n_sims": len(result.sims), "interrupted": True})

    mark = (opts.checkpoint is not None or opts.dump_csv_path) \
        and cp.rank() == 0
    if mark:
        trap.register_handler(interrupted)
    try:
        with tr.span("mcts.explore", n_iters=opts.n_iters,
                     seed=opts.seed) as sp:
            _explore(graph, platform, benchmarker, opts, strategy, seeds, cp,
                     rng, counters, result, tr)
            sp.set("n_sims", len(result.sims))
            sp.set("tree_size", result.tree_size)
        if opts.dump_csv_path and cp.rank() == 0:
            result.dump_csv(opts.dump_csv_path)
    finally:
        if mark:
            trap.unregister_handler(interrupted)
    return result


def _explore(graph, platform, benchmarker, opts: MctsOpts, strategy, seeds,
             cp, rng, counters: Counters, result: MctsResult, tr) -> None:
    """The body of :func:`explore`: fills ``result``."""
    multi = cp.size() > 1
    lead = cp.rank() == 0
    ctx = strategy.Context(seed=opts.seed)
    root = Node(State(graph), strategy) if lead else None
    ctx.root = root
    if root is not None and opts.subtree is not None:
        prune_to_subtree(root, platform, opts.subtree)
    seed_iter = iter(seeds if seeds is not None else ())
    if opts.prefetch is not None and lead and seeds:
        # the seed queue's terminal schedules are known now: capture them
        # in the background while the first iterations measure
        opts.prefetch.prefetch(_seed_orders(
            graph, seeds, getattr(opts.prefetch, "depth", 8)))
    failed_keys: set = set()  # negative cache for unsound schedules
    ropts = opts.screen_opts if opts.screen_opts is not None else opts.bench_opts
    fidelity = "screen" if opts.screen_opts is not None else "full"
    for it in range(opts.n_iters):
        with tr.span("mcts.iter", it=it) as it_sp:
            stop, order, endpoint = False, None, None
            if lead:
                path = next(seed_iter, None)
                if path is not None:
                    it_sp.set("seeded", True)
                    with counters.phase("SEED"):
                        endpoint, st = _materialize_seed(root, path)
                        if st.is_terminal():
                            # benchmarked AS RECORDED (no redundant-sync cleanup)
                            order = st.sequence
                        else:  # defensive: complete the path
                            _, order = endpoint.get_rollout(
                                platform, rng, policy=opts.rollout_policy,
                                policy_eps=opts.rollout_eps)
                elif root.fully_visited_:
                    stop = True
                else:
                    with counters.phase("SELECT"):
                        leaf = root.select(ctx, platform, rng)
                    with counters.phase("EXPAND"):
                        child = leaf.expand(platform, rng)
                    with counters.phase("ROLLOUT"):
                        endpoint, order = child.get_rollout(
                            platform, rng, opts.expand_rollout,
                            policy=opts.rollout_policy,
                            policy_eps=opts.rollout_eps)
                    with counters.phase("REDUNDANT_SYNC"):
                        order = remove_redundant_syncs(order)
                    if opts.prefetch is not None:
                        # speculative completions of the leaf's other
                        # unplayed children capture in the background while
                        # this rollout measures (forked RNG, throwaway
                        # States: the search itself is untouched)
                        opts.prefetch.prefetch(_speculative_completions(
                            leaf, platform,
                            _random.Random(f"prefetch:{opts.seed}:{it}"),
                            opts.prefetch_rollouts, skip=child))
                    if tr.enabled and child.decision is not None:
                        it_sp.set("selected", child.decision.desc())
            if multi:  # stop-flag + schedule broadcast (mcts.hpp:129-152, 244)
                with counters.phase("BCAST"):
                    stop = cp.bcast_json(stop)
                    if not stop:
                        payload = cp.bcast_json(
                            sequence_to_json(order) if lead else None)
                        if not lead:
                            order = sequence_from_json(payload, graph)
            if stop:
                break
            key = canonical_key(order)
            if tr.enabled:
                it_sp.set("schedule", schedule_id(order))
            if key not in failed_keys and opts.verify is not None:
                # deterministic and device-free: every rank reaches the same
                # verdict, so the coherent skip needs no agreement round
                if not opts.verify(order).ok:
                    it_sp.set("unsound", True)
                    failed_keys.add(key)
            if key in failed_keys:
                # backprop a penalty (2x the worst time seen) so the tree
                # learns to avoid the region; no sim is recorded
                it_sp.set("rejected", True)
                if lead:
                    worst = max((s.result.pct50 for s in result.sims),
                                default=1.0)
                    with counters.phase("BACKPROP"):
                        endpoint.backprop(
                            ctx, BenchResult.from_times([2.0 * worst]))
                continue
            with counters.phase("BENCHMARK"):
                try:
                    res = benchmarker.benchmark(order, ropts)
                except Exception as e:
                    candidate_failed("mcts.rollout", order, e)
                    if not rejects_failures(benchmarker, e):
                        raise
                    res = None
            if res is None:
                # a failed candidate (quarantined or unsound, on every
                # rank): a penalty as for an unsound one, never measured
                # again in this search
                failed_keys.add(key)
                it_sp.set("rejected", True)
                if lead:
                    worst = max((s.result.pct50 for s in result.sims),
                                default=1.0)
                    with counters.phase("BACKPROP"):
                        endpoint.backprop(
                            ctx, BenchResult.from_times([2.0 * worst]))
                continue
            if tr.enabled:
                it_sp.set("pct50", res.pct50)
                it_sp.set("fidelity", fidelity)
            result.sims.append(SimResult(order=order, result=res,
                                         fidelity=fidelity))
            if lead:
                with counters.phase("BACKPROP"):
                    endpoint.backprop(ctx, res)
                if tr.enabled:
                    it_sp.set("tree_size", root.size())
                if opts.dump_tree and _dump_cadence(it):
                    path = f"{opts.dump_tree_prefix}_{it:06d}.dot"
                    with open(path, "w") as f:
                        f.write(root.dump_graphviz())
                if opts.checkpoint is not None:
                    opts.checkpoint.save_state(
                        mcts={"it": it, "n_sims": len(result.sims),
                              "tree_size": root.size()})
    # multi-fidelity confirm: the top-k distinct screened schedules are
    # re-measured at the full bench_opts floor, on every rank
    if opts.screen_opts is not None and result.sims:
        finals: List[Sequence] = []
        seen_keys: set = set()
        for s in sorted(result.sims, key=lambda s: s.result.pct50):
            k = canonical_key(s.order)
            if k in seen_keys:
                continue
            seen_keys.add(k)
            finals.append(s.order)
            if len(finals) >= opts.confirm_topk:
                break
        if opts.prefetch is not None:
            # confirm-queue lookahead: finalists were captured when they
            # were screened, unless evicted since
            opts.prefetch.prefetch(finals)
        for order in finals:
            with counters.phase("CONFIRM"):
                try:
                    res = benchmarker.benchmark(order, opts.bench_opts)
                except Exception as e:
                    candidate_failed("mcts.confirm", order, e)
                    if not rejects_failures(benchmarker, e):
                        raise
                    continue
            result.sims.append(SimResult(order=order, result=res,
                                         fidelity="full"))
    result.tree_size = root.size() if lead else 0
