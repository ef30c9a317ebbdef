"""Neighborhood search over schedules: hill-climbing in decision space.

Counterpart of ``tenzing_tpu/solve/local.py``.  ``drive`` runs a decision
policy from ``State(graph)`` to a terminal state and records the decision
list; ``phase_policy`` is the phase-ordered discipline the greedy incumbents,
the paired incumbent and the MCTS rollout policy use.  ``hill_climb`` refines
the phase-policy incumbent: a neighbor substitutes ONE decision (a lane
binding, an implementation choice, an execution-order pick) and completes the
rest by following the original plan where it still applies
(``replay_with_substitution``); first-improvement moves are accepted under a
benchmark budget, on a paired comparison with the incumbent when asked.

The climb draws from ``random.Random(seed)`` in the reference's order, so the
two packages climb the same chain for the same measurements.  Left out, with
their subsystems: the learned prescreen, checkpointing, compile prefetching
and the fleet's shared claim registry.  A measurement that raises propagates,
as in the port's MCTS: on CUDA there is no compile step that can legitimately
fail, so a failure is not a neighbor's verdict.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence as Seq, Tuple

from tenzing_tpu_torch.bench.benchmarker import BenchOpts
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.state import (
    AssignLane,
    ChooseOp,
    Decision,
    ExecuteOp,
    ExpandOp,
    State,
)


def phase_policy(platform, phases: Seq[str],
                 prefer: Optional[Callable[[str, List[str]], Optional[str]]] = None,
                 priority: Optional[Callable[[str], int]] = None):
    """A policy closure for :func:`drive`: expand compounds eagerly, resolve
    ChoiceOps via ``prefer(choice_op_name, choice_names) -> chosen name`` (or
    the first choice), round-robin lane bindings, and execute in ``phases``
    order with the sync-gating discipline of solve/greedy.py.

    ``priority`` (op name -> int) overrides the prefix-index phase of an op —
    finer-than-phase disciplines (e.g. the halo paired await/unpack interleave,
    models/halo_pipeline.paired_priority) express per-op orderings while
    reusing the same gating machinery."""
    from tenzing_tpu_torch.core.sync_ops import SyncOp

    lane_rr = [0]

    def phase(op) -> int:
        name = op.name()
        if priority is not None:
            return priority(name)
        for i, p in enumerate(phases):
            if name.startswith(p):
                return i
        return 0

    def policy(st: State, ds: List[Decision]) -> Decision:
        expands = [d for d in ds if isinstance(d, ExpandOp)]
        if expands:
            return expands[0]
        chooses = [d for d in ds if isinstance(d, ChooseOp)]
        if chooses:
            grp = sorted(
                (d for d in chooses if d.op.name() == chooses[0].op.name()),
                key=lambda d: d.choice.name(),
            )
            if prefer is not None:
                want = prefer(grp[0].op.name(), [d.choice.name() for d in grp])
                pick = next((d for d in grp if d.choice.name() == want), None)
                if pick is not None:
                    return pick
            return grp[0]
        assigns = sorted(
            (d for d in ds if isinstance(d, AssignLane)), key=lambda d: d.op.name()
        )
        if assigns:
            opname = assigns[0].op.name()
            lane = platform.lanes[lane_rr[0] % len(platform.lanes)]
            lane_rr[0] += 1
            return next(
                (d for d in assigns if d.op.name() == opname and d.lane == lane),
                assigns[0],
            )
        execs = [d for d in ds if isinstance(d, ExecuteOp)]
        real = sorted(
            (d for d in execs if not isinstance(d.op, SyncOp)),
            key=lambda d: (phase(d.op), d.op.name()),
        )
        syncs = sorted(
            (d for d in execs if isinstance(d.op, SyncOp)), key=lambda d: d.op.desc()
        )
        done = {op.name() for op in st.sequence}
        pending_min = min(
            (phase(v) for v in st.graph.vertices() if v.name() not in done),
            default=99,
        )
        if real and (not syncs or phase(real[0].op) <= pending_min):
            return real[0]
        return syncs[0]

    return policy


def drive(graph: Graph, platform, policy) -> Tuple[Sequence, List[Decision]]:
    """Run ``policy`` to a terminal state, recording the decision list."""
    st = State(graph)
    decisions: List[Decision] = []
    while not st.is_terminal():
        ds = st.get_decisions(platform)
        d = policy(st, ds)
        decisions.append(d)
        st = st.apply(d)
    return st.sequence, decisions


def replay_with_substitution(
    graph: Graph, platform, decisions: List[Decision], i: int,
    alt: Decision, fallback,
) -> Tuple[Sequence, List[Decision]]:
    """The neighbor: apply ``decisions[:i]``, then ``alt`` instead of
    ``decisions[i]``, then complete by taking any still-offered decision from
    the original plan (earliest-planned first) and falling back to
    ``fallback`` when the plan no longer applies (e.g. after an
    implementation-choice flip invalidated downstream ops)."""
    st = State(graph)
    taken: List[Decision] = []
    for d in decisions[:i]:
        st = st.apply(d)
        taken.append(d)
    st = st.apply(alt)
    taken.append(alt)
    plan = list(decisions[i + 1:])
    while not st.is_terminal():
        ds = st.get_decisions(platform)
        offered = {d.key(): d for d in ds}
        pick = None
        for j, p in enumerate(plan):
            got = offered.get(p.key())
            if got is not None:
                pick = got
                del plan[j]
                break
        if pick is None:
            pick = fallback(st, ds)
        st = st.apply(pick)
        taken.append(pick)
    return st.sequence, taken


@dataclass
class LocalOpts:
    """``budget`` counts benchmarked DISTINCT schedules: canonical-key dedup
    skips no-op neighbors (a substitution that rebuilds the identical
    schedule) without charging the budget, and a neighbor already measured
    through a shared ``CachingBenchmarker`` (a cache hit, no device time) is
    free too.

    ``paired=True`` makes each accept decision drift-immune: the neighbor and
    the incumbent are measured back to back as one decorrelated 2-schedule
    batch, and the move is taken only when the paired ratio's bootstrap CI
    clears 1.0.  It needs a benchmarker with ``benchmark_batch_times``
    (``EmpiricalBenchmarker``, directly or as the ``.inner`` of a
    ``CachingBenchmarker``).

    ``verify`` (a ``verify.ScheduleVerifier``) checks the incumbent and every
    neighbor before it is measured; an unsound neighbor is rejected without
    device time."""

    budget: int = 24
    bench_opts: BenchOpts = field(default_factory=BenchOpts)
    seed: int = 0
    max_alts_per_step: int = 3
    paired: bool = False
    verify: Optional[object] = None


@dataclass
class LocalResult:
    sims: List = field(default_factory=list)  # SimResult entries
    final: object = None  # the accepted chain tip (the climb's official output)
    spent: int = 0  # budget charged
    accepted: int = 0  # moves taken

    def best(self):
        return min(self.sims, key=lambda s: s.result.pct50) if self.sims else None


def hill_climb(
    graph: Graph, platform, benchmarker, phases: Seq[str],
    prefer=None, opts: Optional[LocalOpts] = None,
) -> LocalResult:
    """First-improvement hill climbing from the phase-policy incumbent."""
    import sys

    from tenzing_tpu_torch.core.sequence import canonical_key
    from tenzing_tpu_torch.solve.mcts.mcts import SimResult

    opts = opts if opts is not None else LocalOpts()
    rng = _random.Random(opts.seed)
    # a FRESH policy per drive/replay: phase_policy carries a round-robin
    # lane counter, and sharing one closure would make the schedule a given
    # (position, alternative) neighbor maps to depend on how many fallback
    # assignments happened earlier in the run
    fresh = lambda: phase_policy(platform, phases, prefer)  # noqa: E731
    result = LocalResult()

    def unsound(seq_) -> bool:
        """True (and reported) when the soundness gate rejects ``seq_``."""
        if opts.verify is None:
            return False
        verdict = opts.verify(seq_)
        if verdict.ok:
            return False
        sys.stderr.write("hill-climb: schedule rejected by the soundness "
                         f"verifier ({verdict.witness()})\n")
        return True

    def measured(seq_):
        """Benchmark + record; returns (result | None, charge), ``charge``
        False for a cache hit.  None: rejected by the verifier."""
        if unsound(seq_):
            return None, False
        pre_hits = getattr(benchmarker, "hits", None)
        res = benchmarker.benchmark(seq_, opts.bench_opts)
        result.sims.append(SimResult(order=seq_, result=res))
        return res, pre_hits is None or benchmarker.hits == pre_hits

    batch_owner = benchmarker
    batcher = getattr(benchmarker, "benchmark_batch_times", None)
    if batcher is None:
        batch_owner = getattr(benchmarker, "inner", None)
        batcher = getattr(batch_owner, "benchmark_batch_times", None)
    use_paired = opts.paired and batcher is not None

    def paired_step(cur_seq, cand_seq):
        """(candidate BenchResult | None, accept, charge) from one
        decorrelated 2-schedule batch: accept only when the paired cur/cand
        ratio's CI clears 1.0."""
        from tenzing_tpu_torch.bench.benchmarker import BenchResult
        from tenzing_tpu_torch.utils.numeric import paired_speedup

        pair_seed = rng.randrange(1 << 30)
        if unsound(cand_seq):
            return None, False, False
        times = batcher([cur_seq, cand_seq], opts.bench_opts, seed=pair_seed)
        m, lo, _ = paired_speedup(times[0], times[1], seed=pair_seed + 1)
        res = BenchResult.from_times(times[1])
        result.sims.append(SimResult(order=cand_seq, result=res))
        return res, (m > 1.0 and lo > 1.0), True

    seq, decisions = drive(graph, platform, fresh())
    cur, charge = measured(seq)
    if cur is None:
        raise RuntimeError("hill-climb incumbent schedule is unsound — "
                           "nothing to climb from")
    seen = {canonical_key(seq)}
    spent = 1 if charge else 0
    accepted = 0

    def sweep_order(decs):
        """Shuffled positions, structural decisions (implementation choices,
        lane bindings) first — they are sparse in the list but carry the
        biggest schedule differences."""
        struct = [i for i, d in enumerate(decs)
                  if isinstance(d, (ChooseOp, AssignLane))]
        struct_set = set(struct)
        rest = [i for i in range(len(decs)) if i not in struct_set]
        rng.shuffle(struct)
        rng.shuffle(rest)
        return struct + rest

    improved = True
    while spent < opts.budget and improved:
        improved = False
        for i in sweep_order(decisions):
            # re-derive the state at position i to enumerate alternatives
            st = State(graph)
            for d in decisions[:i]:
                st = st.apply(d)
            ds = st.get_decisions(platform)
            alts = [d for d in ds if d.key() != decisions[i].key()]
            rng.shuffle(alts)
            # replayed lazily: a first-improvement break pays for no
            # neighbor it never visits
            neighbors = (
                (alt, *replay_with_substitution(
                    graph, platform, decisions, i, alt, fresh()))
                for alt in alts[: opts.max_alts_per_step]
            )
            for alt, cand_seq, cand_dec in neighbors:
                key = canonical_key(cand_seq)
                if key in seen:
                    # a no-op neighbor (e.g. swapping which of two Expands
                    # goes first yields the identical schedule): skipped
                    # without charging the budget
                    continue
                seen.add(key)
                if use_paired:
                    res, accept, charge = paired_step(seq, cand_seq)
                else:
                    res, charge = measured(cand_seq)
                    accept = res is not None and res.pct50 < cur.pct50
                if charge:
                    spent += 1
                if accept:  # first improvement: move
                    cur, seq, decisions = res, cand_seq, cand_dec
                    improved = True
                    accepted += 1
                    break
                if spent >= opts.budget:
                    break
            if improved or spent >= opts.budget:
                break
    result.final = SimResult(order=seq, result=cur)
    result.spent, result.accepted = spent, accepted
    return result
