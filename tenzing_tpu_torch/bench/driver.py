"""The driver: the halo and blocked-attention searches end to end on CUDA.

Counterpart of the halo and attn paths of ``tenzing_tpu/bench/driver.py``.
:func:`run` builds the request's workload at the reference size with its menus
on — the 3D halo exchange (nQ=3, 512^3 cells, radius 3; the default) or, with
``workload="attn"``, single-device blocked attention at 8k context (batch 4,
8 K/V blocks of 1024, head dim 128) — then

1. measures the one-lane naive order (halo: the reference's hand-written
   order; attn: the first decision at every step, the all-``.xla`` chain);
2. measures the incumbents: for halo the greedy and paired ones over
   ``engine in {host, rdma, mixed, alias}`` on 8 lanes (and the engine-fixed
   incumbents at 2, 3 and 6 lanes); for attn the bf16 kernel chain and the
   fused bf16 kernel, both on one lane;
3. runs FastMin MCTS (halo: seeded with the incumbents' decision paths, with
   the alias discipline as rollout policy; attn: unseeded, random rollouts) at
   a cheap screen floor and a confirm pass at the search floor;
4. ranks the distinct candidates against naive in a paired decorrelated
   screen, then re-measures naive and the top 3 in a longer paired final;
5. re-runs the winner beside naive from the same initial buffers as an
   integrity gate: outputs must agree and the independent verifier must pass
   it;
6. returns the JSON line (``metric``, ``value``, ``unit``, ``vs_baseline``,
   ``verified``, plus the measurement regime).

:class:`DriverRequest` is a copy of the reference's, field for field, with the
same defaults.  A request that sets a flag this port does not implement yet
raises :exc:`DriverConfigError` ("... not yet ported"); nothing is silently
ignored.  Hill-climbs come with a later slice: the default request's
``climb_budget`` is reported as skipped in the halo JSON, and any other
positive value raises (the reference runs no climbs for attn).

Entry point: ``python -m tenzing_tpu_torch.bench`` (``--device cpu`` runs on
the CPU; the default is the card).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class DriverConfigError(ValueError):
    """An invalid or not-yet-ported :class:`DriverRequest`."""


@dataclass
class DriverRequest:
    """The driver's typed request — a copy of the reference's
    (``tenzing_tpu.bench.driver.DriverRequest``), field for field, with
    identical defaults."""

    smoke: bool = False
    workload: str = "halo"
    moe_tokens: int = 8192
    m: Optional[int] = None
    spmv_bw: Optional[int] = None
    halo_n: int = 512
    lanes: Optional[int] = None
    mcts_iters: int = 56
    iters: int = 20
    search_iters: int = 6
    climb_budget: int = 44
    prefetch_compiles: int = 2
    dump_csv: Optional[str] = None
    trace_out: Optional[str] = None
    metrics_json: Optional[str] = None
    seed_csv: Optional[str] = None
    seed_topk: int = 3
    learn_train: Optional[List[str]] = None
    learn_trace: Optional[List[str]] = None
    learn_model: Optional[str] = None
    learn_screen: bool = False
    checkpoint: Optional[str] = None
    resume: bool = False
    measure_timeout: Optional[float] = None
    inject_faults: Optional[str] = None
    inject_hang_secs: float = 60.0
    profile_winner: bool = False
    profile_repeats: int = 7
    fuse_winner: bool = False
    fuse_search_tiles: bool = False
    chunk: bool = False
    synth_collectives: bool = False
    no_verify: bool = False
    verify_tol: float = 0.02
    search_workers: int = 0
    measure_batch: int = 0

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class DriverResult:
    """What :func:`run` returns: the verdict dict whose ``json.dumps`` is the
    driver JSON line, and — when the integrity gate demoted a winner — that
    schedule (``demoted``, not serialized), so a caller can inspect it."""

    verdict: Dict[str, Any] = field(default_factory=dict)
    demoted: Optional[Any] = None

    def to_json_line(self) -> str:
        return json.dumps(self.verdict)


# fields whose non-default values select features this port does not have
# yet; ``run`` raises on them instead of ignoring them
_UNPORTED = ("dump_csv", "trace_out", "metrics_json", "seed_csv",
             "learn_train", "learn_trace", "learn_model", "learn_screen",
             "checkpoint", "resume", "measure_timeout", "inject_faults",
             "profile_winner", "fuse_winner", "fuse_search_tiles", "chunk",
             "synth_collectives", "search_workers", "measure_batch")
_DEFAULTS = DriverRequest()


WORKLOADS = ("halo", "attn")


def check_request(req: DriverRequest) -> None:
    """Raise :exc:`DriverConfigError` for a request this slice cannot run."""
    if req.workload not in WORKLOADS:
        raise DriverConfigError(
            f"--workload {req.workload}: not yet ported (have {WORKLOADS})")
    for name in _UNPORTED:
        if getattr(req, name) != getattr(_DEFAULTS, name):
            flag = "--" + name.replace("_", "-")
            raise DriverConfigError(f"{flag}: not yet ported")
    # the default 2 is accepted: CUDA has no compile step to prefetch
    if req.prefetch_compiles not in (0, _DEFAULTS.prefetch_compiles):
        raise DriverConfigError("--prefetch-compiles > 0: not yet ported")
    if req.workload == "halo" and \
            req.climb_budget not in (0, _DEFAULTS.climb_budget):
        raise DriverConfigError("--climb-budget: hill-climbs not yet ported")
    if req.halo_n < 1:
        raise DriverConfigError("--halo-n must be positive")


# the per-face aliased-unpack recipe of the reference (its ALIAS_UNPACK):
# one slot per face axis, shared by the greedy seeding and the rollout policy
ALIAS_UNPACK = {"x": ".pallas", "y": ".pallasf", "z": ".pallasb"}


def alias_unpack_choice(op_name, choices):
    """The alias-recipe kernel for an ``unpack_*`` op from the menu, or None
    when it is off-menu."""
    want = ALIAS_UNPACK[op_name[-1]]
    return next((c for c in choices if c.endswith(want)), None)


def metric_for(workload: str, args) -> str:
    """The metric name: the reference's, so the two series line up."""
    if workload == "halo":
        return f"halo_iter_pct50_searched_n{4 if args.smoke else args.halo_n}"
    n_ctx = 4 * 16 if args.smoke else 8 * 1024
    return f"attn_blockwise_pct50_searched_n{n_ctx}"


def search_lanes(req: DriverRequest) -> int:
    """8 lanes for full-size halo, else 2, unless overridden."""
    if req.lanes:
        return req.lanes
    return 8 if req.workload == "halo" and not req.smoke else 2


def build_halo(args, device):
    """(graph, placed buffers, metric, HaloArgs) at the request's size."""
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import (
        build_graph,
        host_buffer_names,
        make_pipeline_buffers,
    )
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    if args.smoke:
        hargs = HaloArgs(nq=2, lx=4, ly=4, lz=4, radius=1)
    else:
        n = args.halo_n
        hargs = HaloArgs(nq=3, lx=n, ly=n, lz=n, radius=3)
    bufs, _ = make_pipeline_buffers(hargs, seed=0, with_expected=False)
    tbufs = buffers_from_numpy(bufs, device, host_buffer_names())
    del bufs
    # the menus as the reference offers them: on for the full-size search,
    # off for the smoke configuration
    menus = not args.smoke
    g = build_graph(hargs, impl_choice=menus, xfer_choice=menus)
    return g, tbufs, metric_for("halo", args), hargs


def attn_args(args):
    """The request's attention configuration: the reference's full size (8k
    context in 8 K/V blocks of 1024, batch 4, head dim 128) or its smoke."""
    from tenzing_tpu_torch.models.ring_attention import RingAttnArgs

    if args.smoke:
        return RingAttnArgs(n_devices=4, batch=1, seq_local=16, head_dim=8)
    return RingAttnArgs(n_devices=8, batch=4, seq_local=1024, head_dim=128)


def attn_graph(aargs):
    """Start -> BlockedAttention (kernel and granularity menus) -> Finish."""
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.models.ring_attention import BlockedAttention

    g = Graph()
    op = BlockedAttention(aargs, impl_choice=True, fused_choice=True)
    g.start_then(op)
    g.then_finish(op)
    return g


def build_attn(args, device):
    """(graph, placed buffers, metric, RingAttnArgs) at the request's size;
    the dense expected O is skipped (make_blocked_buffers(with_expected=False))."""
    from tenzing_tpu_torch.models.ring_attention import make_blocked_buffers
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    aargs = attn_args(args)
    bufs, _ = make_blocked_buffers(aargs, seed=0, with_expected=False)
    tbufs = buffers_from_numpy(bufs, device)
    del bufs
    return attn_graph(aargs), tbufs, metric_for("attn", args), aargs


def halo_incumbents(g, plat, hargs, smoke: bool):
    """(labelled incumbent orders, MCTS seed decision paths, rollout policy)
    of the halo search: the greedy overlap order for the smoke; at full size
    the greedy and paired disciplines over the four transfer engines, the
    engine-fixed ones at 2, 3 and 6 lanes, and the alias discipline as the
    rollout policy (the reference's, bench/driver.py:1145-1260)."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.halo import DIRECTIONS, dir_name
    from tenzing_tpu_torch.models.halo_pipeline import (
        HALO_PHASES,
        greedy_overlap_order,
        paired_overlap_order,
        paired_priority,
    )
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    if smoke:
        return [("greedy-overlap", greedy_overlap_order(hargs, plat))], [], None
    dirs = [dir_name(d) for d in DIRECTIONS]

    def mk_prefer(engine):
        def prefer(op_name, choices):
            if op_name.startswith("xfer_"):
                i = dirs.index(op_name.split("_", 1)[1])
                want = {"host": ".host", "rdma": ".rdma",
                        "alias": ".rdma"}.get(
                    engine, ".rdma" if i % 2 == 0 else ".host")
                return next((c for c in choices if c.endswith(want)), None)
            if engine == "alias" and op_name.startswith("unpack_"):
                hit = alias_unpack_choice(op_name, choices)
                if hit is not None:
                    return hit
            return next((c for c in choices if c.endswith(".xla")), None)

        return prefer

    greedy_seqs, seed_paths = [], []
    for label, engine, pri in (
        ("greedy-host-8l", "host", None),
        ("greedy-rdma-8l", "rdma", None),
        ("greedy-mixed-8l", "mixed", None),
        ("greedy-paired-8l", "mixed", paired_priority("mixed")),
        ("greedy-alias-8l", "alias", None),
    ):
        seq, decs = drive(g, plat, phase_policy(
            plat, HALO_PHASES, mk_prefer(engine), priority=pri))
        greedy_seqs.append((label, seq))
        seed_paths.append(decs)
    for label, engine, nl in (("greedy-rdma-2l", "rdma", 2),
                              ("greedy-rdma-3l", "rdma", 3),
                              ("greedy-mixed-6l", "mixed", 6)):
        greedy_seqs.append((label, greedy_overlap_order(
            hargs, Platform.make_n_lanes(nl), engine=engine)))
    greedy_seqs.append(("greedy-paired-6l", paired_overlap_order(
        hargs, Platform.make_n_lanes(6), engine="mixed")))
    for label, nl in (("greedy-alias-3l", 3), ("greedy-alias-6l", 6)):
        plat_a = Platform.make_n_lanes(nl)
        seq, decs = drive(g, plat_a, phase_policy(
            plat_a, HALO_PHASES, mk_prefer("alias")))
        greedy_seqs.append((label, seq))
        seed_paths.append(decs)
    rollout_policy = phase_policy(plat, HALO_PHASES, mk_prefer("alias"))
    return greedy_seqs, seed_paths, rollout_policy


def mismatched_outputs(out_a, out_b, tol: float, skip=()) -> List[str]:
    """The integrity gate's agreement policy: names (shared by both output
    dicts, minus ``skip``) whose tensors differ in shape or fail
    ``allclose(rtol=tol, atol=tol*1e-3, equal_nan=True)`` in float64.

    The driver skips the pinned host staging buffers: they are the host
    engine's transport scratch, which a device-engine schedule never
    touches, so comparing them would fail every winner whose engine differs
    from naive's (the reference's gate compares them and does;
    ROADMAP.md, Queue 3)."""
    import torch

    bad = []
    for name in sorted((set(out_a) & set(out_b)) - set(skip)):
        a, b = out_a[name], out_b[name]
        if a.shape != b.shape or not torch.allclose(
                a.double(), b.double(), rtol=tol, atol=tol * 1e-3,
                equal_nan=True):
            bad.append(name)
    return bad


def run(req: DriverRequest, device: Optional[str] = None) -> DriverResult:
    """Execute the whole search -> gate -> verdict loop for ``req`` on
    ``device`` (default ``cuda``; raises when no card is present unless
    ``device="cpu"``)."""
    args = dataclasses.replace(req)
    check_request(args)
    from tenzing_tpu_torch.runtime.executor import resolve_device

    dev = resolve_device(device)
    import torch

    log = lambda m: sys.stderr.write(m + "\n")  # noqa: E731
    if dev.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(dev)}")
    # the reference runs hill-climbs for halo only (bench/driver.py:1457-1495)
    climbs_skipped = args.workload == "halo" and args.climb_budget > 0
    if climbs_skipped:
        log(f"hill-climbs (climb_budget={args.climb_budget}): not yet "
            "ported, skipped")

    from itertools import chain

    from tenzing_tpu_torch.bench.benchmarker import (
        BenchOpts,
        BenchResult,
        CachingBenchmarker,
        EmpiricalBenchmarker,
    )
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.core.sequence import canonical_key
    from tenzing_tpu_torch.models.halo_pipeline import naive_order
    from tenzing_tpu_torch.models.ring_attention import fixed_order
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.solve.mcts import MctsOpts, SimResult, explore
    from tenzing_tpu_torch.solve.mcts.strategies import FastMin
    from tenzing_tpu_torch.utils.numeric import paired_speedup
    from tenzing_tpu_torch.verify import ScheduleVerifier

    halo = args.workload == "halo"
    build = build_halo if halo else build_attn
    g, bufs, metric, wargs = build(args, dev)
    plat = Platform.make_n_lanes(search_lanes(args))
    if args.smoke:
        args.mcts_iters = min(args.mcts_iters, 12)
    ex = StreamExecutor(plat, bufs, device=str(dev))
    del bufs
    emp = EmpiricalBenchmarker(ex)
    bench = CachingBenchmarker(emp)
    verifier = None if args.no_verify else ScheduleVerifier(g)

    # the reference's measurement floors (bench/driver.py:1037-1047)
    opts = BenchOpts(n_iters=max(5, args.iters), max_retries=2,
                     target_secs=0.002 if args.smoke else 0.02)
    search_opts = BenchOpts(n_iters=max(3, args.search_iters), max_retries=2,
                            target_secs=0.002 if args.smoke else 0.01)

    naive_plat = Platform.make_n_lanes(1)
    # attn: the first decision at every step (reference driver.py:1060-1064)
    naive_seq = (naive_order(wargs, naive_plat) if halo
                 else fixed_order(g, naive_plat))
    t0 = time.time()
    naive = bench.benchmark(naive_seq, opts)
    log(f"naive: pct50={naive.pct50*1e6:.1f}us (wall {time.time()-t0:.0f}s)")

    incumbents: List[SimResult] = []
    labels: Dict[int, str] = {}
    seed_paths = []
    rollout_policy = None
    if halo:
        greedy_seqs, seed_paths, rollout_policy = halo_incumbents(
            g, plat, wargs, args.smoke)
    elif not args.smoke:
        # the reference's kernel incumbents (bench/driver.py:1104-1144): the
        # per-block chain on the bf16 kernel and the fused bf16 kernel, both
        # on one lane.  A failed launch raises; it is never skipped.
        greedy_seqs = [
            ("bf16-kernel", fixed_order(g, naive_plat, ".chain",
                                        kernel_of=lambda s: ".pallas_bf16")),
            ("fused-bf16", fixed_order(g, naive_plat, ".fused_bf16")),
        ]
    else:
        greedy_seqs = []
    for label, seq in greedy_seqs:
        t0 = time.time()
        res_i = bench.benchmark(seq, search_opts)
        log(f"{label} incumbent: pct50={res_i.pct50*1e6:.1f}us "
            f"(wall {time.time()-t0:.0f}s)")
        sim = SimResult(order=seq, result=res_i)
        labels[id(sim)] = label
        incumbents.append(sim)

    # directed search: cheap screen floor for rollouts, confirm at 10x the
    # search floor (the reference's multi-fidelity split)
    t0 = time.time()
    mcts_screen = BenchOpts(n_iters=2, max_retries=2,
                            target_secs=0.0005 if args.smoke else 0.001)
    mcts_confirm = BenchOpts(n_iters=max(5, args.iters), max_retries=2,
                             target_secs=search_opts.target_secs * 10)
    res = explore(
        g, plat, bench,
        MctsOpts(n_iters=args.mcts_iters, bench_opts=mcts_confirm,
                 screen_opts=mcts_screen, confirm_topk=4, seed=0,
                 rollout_policy=rollout_policy, verify=verifier),
        strategy=FastMin, seeds=seed_paths,
    )
    confirmed = [s for s in res.sims if s.fidelity == "full"]
    log(f"mcts wall {time.time()-t0:.0f}s, tree={res.tree_size}, "
        f"{len(res.sims)} rollouts ({len(seed_paths)} seeded, "
        f"{len(confirmed)} confirmed)")
    log(res.counters.report())
    log(f"bench cache: {bench.hits} hits / {bench.misses} misses")

    def batch_paired(seqs, bopts, seed):
        times = emp.benchmark_batch_times([naive_seq] + list(seqs), bopts,
                                          seed=seed)
        results = [BenchResult.from_times(ts) for ts in times]
        paired = [paired_speedup(times[0], ts, seed=seed + 1) for ts in times[1:]]
        return results, paired

    def label_of(s) -> str:
        base = labels.get(id(s), "mcts")
        if base != "mcts":
            return base
        names = [op.desc() for op in s.order.vector()]
        if halo:
            return f"mcts/{'rdma' if any('.rdma' in n for n in names) else 'host'}"
        engine = next((e for e in (".fused_bf16", ".fused")
                       if any(e in n for n in names)), ".chain")
        return f"mcts/{engine[1:]}"

    # distinct candidates: every incumbent, then the confirmed MCTS pool
    inc_ids = {id(s) for s in incumbents}
    pool = sorted((s for s in res.sims if id(s) not in inc_ids
                   and s.fidelity == "full"), key=lambda s: s.result.pct50)
    seen, cands = set(), []
    for s in chain(incumbents, pool):
        key = canonical_key(s.order)
        if key not in seen:
            seen.add(key)
            cands.append(s)
    cands = cands[: max(8, len(incumbents) + 4) if not args.smoke else 4]

    screen_opts = dataclasses.replace(opts, target_secs=5 * opts.target_secs)
    fin_opts = dataclasses.replace(opts, n_iters=3 * opts.n_iters,
                                   target_secs=20 * opts.target_secs)
    vs, value_us, finals, top, best_i = 1.0, naive.pct50 * 1e6, [], [], 0
    if cands:
        t0 = time.time()
        _, screen = batch_paired([s.order for s in cands], screen_opts, seed=1)
        log("screen (paired vs naive, wall %.0fs): %s" % (
            time.time() - t0,
            ", ".join("%s=%.4f" % (label_of(s), p[0])
                      for s, p in zip(cands, screen))))
        ranked = sorted(zip(cands, screen), key=lambda sp: sp[1][0],
                        reverse=True)
        top = [s for s, p in ranked if p[0] > 1.0][:3]
    if top:
        t0 = time.time()
        finals, paired = batch_paired([s.order for s in top], fin_opts, seed=3)
        fin_naive, fin_cands = finals[0], finals[1:]
        log("final batch (wall %.0fs): naive=%.1fus candidates=[%s]us" % (
            time.time() - t0, fin_naive.pct50 * 1e6,
            ", ".join("%.1f" % (r.pct50 * 1e6) for r in fin_cands)))
        best_i = max(range(len(paired)), key=lambda i: paired[i][0])
        m, lo, hi = paired[best_i]
        log("paired speedup vs naive: best=%.4f [%.4f, %.4f] 95%% CI" % (m, lo, hi))
        # a win requires the bootstrap CI to exclude 1.0
        if m > 1.0 and lo > 1.0:
            value_us, vs = fin_cands[best_i].pct50 * 1e6, m
        else:
            value_us = fin_naive.pct50 * 1e6

    # result-integrity gate: the reported schedule re-executes next to naive
    # from the same initial buffers; outputs must agree and the independent
    # verifier must pass it, or the run is demoted to no-win
    winner = top[best_i] if top and finals and vs > 1.0 else None
    winner_seq = winner.order if winner is not None else naive_seq
    gate_verifier = verifier if verifier is not None else ScheduleVerifier(g)
    verdict = gate_verifier(winner_seq)
    t0 = time.time()
    out_w = ex.run(winner_seq)
    out_n = out_w if winner_seq is naive_seq else ex.run(naive_seq)
    mismatched = mismatched_outputs(out_n, out_w, args.verify_tol,
                                    skip=ex.host_names)
    del out_w, out_n
    verified = bool(verdict.ok and not mismatched)
    log("integrity gate: winner-vs-naive outputs "
        f"{'DIVERGE on ' + str(mismatched[:4]) if mismatched else 'agree'}, "
        f"verifier {'ok' if verdict.ok else 'UNSOUND'} "
        f"(wall {time.time()-t0:.0f}s)")
    demoted = None
    if not verified and vs > 1.0:
        log("integrity gate FAILED — demoting the winner to no-win")
        value_us = (finals[0].pct50 if finals else naive.pct50) * 1e6
        demoted = winner
        vs, winner = 1.0, None

    meta = {
        "verified": verified,
        "device": {"type": dev.type,
                   "name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")},
        "naive_us": round((finals[0].pct50 if finals else naive.pct50) * 1e6, 2),
        "search_floor_s": search_opts.target_secs,
        "screen_floor_s": screen_opts.target_secs,
        "final_floor_s": fin_opts.target_secs,
        "mcts_screen_floor_s": mcts_screen.target_secs,
        "winner_label": label_of(winner) if winner is not None else None,
        "mcts": {"iters": args.mcts_iters, "tree_size": res.tree_size,
                 "sims": len(res.sims), "seeded": len(seed_paths)},
        "not_ported": {"climb_budget": args.climb_budget} if climbs_skipped
        else {},
    }
    if demoted is not None:
        meta["demoted_label"] = label_of(demoted)
    if not verdict.ok:
        meta["verdict"] = verdict.witness()
    if mismatched:
        meta["diverged"] = mismatched
    return DriverResult(verdict={
        "metric": metric,
        "value": round(value_us, 2),
        "unit": "us",
        "vs_baseline": round(vs, 4),
        **meta,
    }, demoted=demoted.order if demoted is not None else None)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m tenzing_tpu_torch.bench [--smoke] [--halo-n N] ...``
    prints the driver's JSON line."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m tenzing_tpu_torch.bench")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    for f in dataclasses.fields(DriverRequest):
        flag = "--" + f.name.replace("_", "-")
        default = getattr(_DEFAULTS, f.name)
        if isinstance(default, bool):
            p.add_argument(flag, action="store_true", default=default)
        elif f.name in ("learn_train", "learn_trace"):
            p.add_argument(flag, nargs="+", default=default)
        else:
            typ = {"m": int, "spmv_bw": int, "lanes": int,
                   "measure_timeout": float}.get(f.name, type(default)
                                                 if default is not None else str)
            p.add_argument(flag, type=typ, default=default)
    ns = vars(p.parse_args(argv))
    device = ns.pop("device")
    try:
        result = run(DriverRequest(**ns), device=device)
    except DriverConfigError as e:
        p.error(str(e))
    print(result.to_json_line())
    return 0
