"""The driver: the halo, blocked-attention and MoE searches end to end on CUDA.

Counterpart of the halo, attn and moe paths of ``tenzing_tpu/bench/driver.py``.
:func:`run` builds the request's workload at the reference size with its menus
on — the 3D halo exchange (nQ=3, 512^3 cells, radius 3; the default),
single-device blocked attention at 8k context (``workload="attn"``: batch 4,
8 K/V blocks of 1024, head dim 128) or the MoE dispatch/combine pipeline
(``workload="moe"``: 8 experts, 8192 tokens, d_model 512, d_ff 2048, 4
chunks, with the staging x engine and expert-MLP kernel menus) — then

1. measures the one-lane naive order (halo and moe: each chain completed in
   turn; attn: the first decision at every step, the all-``.xla`` chain);
2. measures the incumbents: for halo the greedy and paired ones over
   ``engine in {host, rdma, mixed, alias}`` on 8 lanes (and the engine-fixed
   incumbents at 2, 3 and 6 lanes); for attn the bf16 kernel chain and the
   fused bf16 kernel, both on one lane; for moe the greedy overlap order with
   f32 and bf16 staging, the bf16 and f32 device-copy orders, and (the
   port's own) the bf16 device-copy order with the expert MLP on the kernel;
3. runs FastMin MCTS (halo: seeded with the incumbents' decision paths, with
   the alias discipline as rollout policy; moe: seeded with the bf16-rdma
   discipline, which is also its rollout policy; attn: unseeded, random
   rollouts) at a cheap screen floor and a confirm pass at the search floor;
4. hill-climbs (halo: the alias discipline on 3 and 6 lanes, the budget split
   4:3; moe: the bf16-rdma discipline over the whole budget), paired, at 10x
   the search floor; the climbs' candidates and chain tips join the pool;
5. ranks the distinct candidates against naive in a paired decorrelated
   screen, then re-measures naive and the top 3 in a longer paired final;
6. re-runs the winner beside naive from the same initial buffers as an
   integrity gate: outputs must agree and the independent verifier must pass
   it;
7. returns the JSON line (``metric``, ``value``, ``unit``, ``vs_baseline``,
   ``verified``, plus the measurement regime).

:class:`DriverRequest` is a copy of the reference's, field for field, with the
same defaults.  A request that sets a flag this port does not implement yet
raises :exc:`DriverConfigError` ("... not yet ported"); nothing is silently
ignored.  What a default request would have done and the port skips is named
in the JSON's ``not_ported``: at full size the recorded warm starts (the
experiments/*_search_tpu_r[45]*.csv databases the reference reads), and
therefore the climb the reference seeds from them.

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


WORKLOADS = ("halo", "attn", "moe")

# the recorded search databases the reference reads as warm starts on a
# full-size run (its bench/driver.py:1283-1288)
RECORDED_WARM_START = {
    "halo": "experiments/halo_search_tpu_r[45]*.csv",
    "moe": "experiments/moe_search_tpu_r[45]*.csv",
    "attn": "experiments/attn_search_tpu_r[45]*.csv",
}


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
    if req.climb_budget < 0:
        raise DriverConfigError("--climb-budget must be >= 0")
    if req.halo_n < 1:
        raise DriverConfigError("--halo-n must be positive")


def not_ported_meta(req: DriverRequest) -> Dict[str, Any]:
    """What the reference would have done for ``req`` that the port skips
    (the JSON's ``not_ported``): on a full-size run with ``seed_topk > 0``,
    the recorded warm starts — the glob the reference would have read — and
    with them the climb it seeds from the best recorded schedule."""
    if req.smoke or req.seed_topk <= 0:
        return {}
    return {"recorded_warm_start": RECORDED_WARM_START[req.workload]}


# the per-face aliased-unpack recipe of the reference (its ALIAS_UNPACK):
# one slot per face axis, shared by the greedy seeding and the rollout policy
ALIAS_UNPACK = {"x": ".pallas", "y": ".pallasf", "z": ".pallasb"}


def alias_unpack_choice(op_name, choices):
    """The alias-recipe kernel for an ``unpack_*`` op from the menu, or None
    when it is off-menu."""
    want = ALIAS_UNPACK[op_name[-1]]
    return next((c for c in choices if c.endswith(want)), None)


def halo_alias_prefer(op_name, choices):
    """The halo climb policy: all-rdma transfers with the aliased-unpack
    kernel map (the reference's ``halo_alias_prefer``)."""
    if op_name.startswith("xfer_"):
        return next((c for c in choices if c.endswith(".rdma")), None)
    if op_name.startswith("unpack_"):
        hit = alias_unpack_choice(op_name, choices)
        if hit is not None:
            return hit
    return next((c for c in choices if c.endswith(".xla")), None)


def moe_bf16_prefer(op_name, choices):
    """The moe seed, rollout and climb policy: every chain on bf16 staging
    through the device-resident copy, the expert MLP on ``.xla`` (the
    reference's ``moe_bf16_prefer`` / ``moe_seed_prefer``)."""
    return next(
        (c for c in choices if c.endswith(".bf16-rdma")),
        next((c for c in choices if c.endswith(".xla")), None),
    )


def metric_for(workload: str, args) -> str:
    """The metric name: the reference's, so the two series line up."""
    if workload == "halo":
        return f"halo_iter_pct50_searched_n{4 if args.smoke else args.halo_n}"
    if workload == "moe":
        t = 32 if args.smoke else args.moe_tokens
        return f"moe_pipe_pct50_searched_t{t}"
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


def moe_args(args):
    """The request's MoE configuration: the reference's ``MoEPipeArgs`` at
    ``moe_tokens`` (8 experts, d_model 512, d_ff 2048, 4 chunks) or its
    smoke."""
    from tenzing_tpu_torch.models.moe_pipeline import MoEPipeArgs

    if args.smoke:
        return MoEPipeArgs(n_experts=4, tokens=32, d_model=8, d_ff=16,
                           n_chunks=2)
    return MoEPipeArgs(tokens=args.moe_tokens)


def moe_staging(args) -> str:
    """The staging menu: both precisions x engines at full size, the f32
    host chain for the smoke (the reference's choice)."""
    return "f32" if args.smoke else "choice"


def build_moe(args, device):
    """(graph, placed buffers, metric, (MoEPipeArgs, capacity)) at the
    request's size: the staging and expert-MLP menus on at full size, off for
    the smoke (the reference's build_moe, bench/driver.py:354-378)."""
    from tenzing_tpu_torch.models.moe_pipeline import (
        build_graph,
        host_buffer_names,
        make_pipe_buffers,
    )
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    margs, staging = moe_args(args), moe_staging(args)
    bufs, _, cap = make_pipe_buffers(margs, seed=0, with_expected=False,
                                     staging=staging)
    tbufs = buffers_from_numpy(bufs, device,
                               host_buffer_names(margs, staging=staging))
    del bufs
    g = build_graph(margs, cap, impl_choice=not args.smoke, staging=staging)
    return g, tbufs, metric_for("moe", args), (margs, cap)


def moe_kernel_prefer(op_name, choices):
    """The bf16-rdma discipline with the expert MLP on the ``.pallas``
    kernel."""
    want = ".bf16-rdma" if op_name.startswith("chain_") else ".pallas"
    return next((c for c in choices if c.endswith(want)), None)


def moe_incumbents(g, plat, margs, cap, smoke: bool):
    """(labelled incumbent orders, MCTS seed decision paths, rollout policy)
    of the moe search: the greedy overlap order, and at full size its bf16
    staging, bf16 device-copy and f32 device-copy variants; the seed path and
    the rollout policy follow :func:`moe_bf16_prefer` (the reference's,
    bench/driver.py:1233-1256 and :1342-1355).

    One incumbent is the port's own: ``greedy-bf16-rdma-pallas``, the
    bf16-rdma discipline with every expert MLP on the ``ffn_batched`` kernel,
    driven on the choice graph.  The reference's four are all ``.xla``, and a
    short search (12 MCTS iterations, a climb budget of 4) does not reach the
    kernel slot, so without it the kernel would not run on the main path (the
    attn search has its kernel incumbents for the same reason)."""
    from tenzing_tpu_torch.models.moe_pipeline import PHASES, greedy_overlap_order
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    greedy = [("greedy-overlap", greedy_overlap_order(margs, cap, plat))]
    if smoke:
        return greedy, [], None
    greedy += [
        ("greedy-overlap-bf16",
         greedy_overlap_order(margs, cap, plat, staging="bf16")),
        ("greedy-bf16-rdma",
         greedy_overlap_order(margs, cap, plat, staging="bf16", engine="rdma")),
        ("greedy-f32-rdma", greedy_overlap_order(margs, cap, plat, engine="rdma")),
        ("greedy-bf16-rdma-pallas",
         drive(g, plat, phase_policy(plat, PHASES, moe_kernel_prefer))[0]),
    ]
    _, decs = drive(g, plat, phase_policy(plat, PHASES, moe_bf16_prefer))
    return greedy, [decs], phase_policy(plat, PHASES, moe_bf16_prefer)


def climb_configs(args, plat):
    """The hill-climbs of a full-size run: (platform, phases, prefer,
    budget) each.  Halo: the alias discipline on 3 and 6 lanes, the budget
    split 4:3; moe: the bf16-rdma discipline over the whole budget.  The
    reference also climbs from the best recorded schedule (its ``b_rec``
    share), which is 0 here: the recorded warm starts are not ported
    (``not_ported_meta``).  Attn and the smoke run no climbs (reference
    bench/driver.py:1457-1495)."""
    from tenzing_tpu_torch.core.platform import Platform

    if args.smoke or args.climb_budget <= 0:
        return []
    if args.workload == "halo":
        from tenzing_tpu_torch.models.halo_pipeline import HALO_PHASES

        rest = args.climb_budget
        b1 = (rest * 4) // 7
        return [(Platform.make_n_lanes(3), HALO_PHASES, halo_alias_prefer, b1),
                (Platform.make_n_lanes(6), HALO_PHASES, halo_alias_prefer,
                 rest - b1)]
    if args.workload == "moe":
        from tenzing_tpu_torch.models.moe_pipeline import PHASES

        return [(plat, PHASES, moe_bf16_prefer, args.climb_budget)]
    return []


def moe_staging_of(seq) -> str:
    """The staging of a moe schedule's chains, ``<prec>-<engine>``
    (``bf16-rdma``, ``f32-host``, ...), or ``mixed`` when its chains differ."""
    names = [op.name() for op in seq.vector()]
    chains = set()
    for n in names:
        if n.startswith("pack"):
            s, c = n[len("pack"):].split("_", 1)
            rdma = f"xferd{s}_{c}.rdma" in names
            chains.add(f"{'bf16' if s else 'f32'}-{'rdma' if rdma else 'host'}")
    return chains.pop() if len(chains) == 1 else "mixed"


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
        if engine == "alias":
            return halo_alias_prefer

        def prefer(op_name, choices):
            if op_name.startswith("xfer_"):
                i = dirs.index(op_name.split("_", 1)[1])
                want = {"host": ".host", "rdma": ".rdma"}.get(
                    engine, ".rdma" if i % 2 == 0 else ".host")
                return next((c for c in choices if c.endswith(want)), None)
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
    rollout_policy = phase_policy(plat, HALO_PHASES, halo_alias_prefer)
    return greedy_seqs, seed_paths, rollout_policy


def mismatched_outputs(out_a, out_b, tol: float, skip=()) -> List[str]:
    """The integrity gate's agreement policy: names (shared by both output
    dicts, minus ``skip``) whose tensors differ in shape or fail
    ``allclose(rtol=tol, atol=tol*1e-3, equal_nan=True)`` in float64.

    The driver skips the pinned host staging buffers: they are the host
    engine's transport scratch, which a device-engine schedule never
    touches, so comparing them would fail every winner whose engine differs
    from naive's (the reference's gate compares them and does;
    ROADMAP.md, Queue 3).  For moe it also skips the device-side staging
    buffers of both staging sets (``transport_buffer_names``): a schedule
    leaves the set its chains did not pick untouched, and a bf16 set holds
    rounded copies — transport, not results."""
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
    not_ported = not_ported_meta(args)
    for name, what in not_ported.items():
        log(f"{name} ({what}): not yet ported, skipped")

    from itertools import chain, zip_longest

    from tenzing_tpu_torch.bench.benchmarker import (
        BenchOpts,
        BenchResult,
        CachingBenchmarker,
        EmpiricalBenchmarker,
    )
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.core.sequence import canonical_key
    from tenzing_tpu_torch.models import halo_pipeline, moe_pipeline
    from tenzing_tpu_torch.models.ring_attention import fixed_order
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.solve.local import LocalOpts, hill_climb
    from tenzing_tpu_torch.solve.mcts import MctsOpts, SimResult, explore
    from tenzing_tpu_torch.solve.mcts.strategies import FastMin
    from tenzing_tpu_torch.utils.numeric import paired_speedup
    from tenzing_tpu_torch.verify import ScheduleVerifier

    halo, moe = args.workload == "halo", args.workload == "moe"
    build = {"halo": build_halo, "attn": build_attn,
             "moe": build_moe}[args.workload]
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
    if halo:
        naive_seq = halo_pipeline.naive_order(wargs, naive_plat)
    elif moe:
        naive_seq = moe_pipeline.naive_order(*wargs, naive_plat)
    else:  # attn: the first decision at every step (reference driver.py:1060-1064)
        naive_seq = fixed_order(g, naive_plat)
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
    elif moe:
        greedy_seqs, seed_paths, rollout_policy = moe_incumbents(
            g, plat, *wargs, args.smoke)
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
    sims = list(res.sims)

    # neighborhood search from the workload's best discipline: paired
    # hill-climbs at 10x the search floor (reference bench/driver.py:1524-1613)
    climb_opts = dataclasses.replace(search_opts, n_iters=8,
                                     target_secs=10 * search_opts.target_secs)
    climbs = []
    for ci, (cplat, cphases, cprefer, cbudget) in enumerate(
            climb_configs(args, plat)):
        t0 = time.time()
        lres = hill_climb(g, cplat, bench, cphases, prefer=cprefer,
                          opts=LocalOpts(budget=cbudget, bench_opts=climb_opts,
                                         seed=2 + ci, paired=True,
                                         verify=verifier))
        log(f"hill-climb[{ci}] ({len(cplat.lanes)} lanes): "
            f"{len(lres.sims)} candidates, {lres.accepted} moves accepted, "
            f"best pct50={lres.best().result.pct50*1e6:.1f}us "
            f"(wall {time.time()-t0:.0f}s)")
        climbs.append({"lanes": len(cplat.lanes), "budget": cbudget,
                       "spent": lres.spent, "accepted": lres.accepted,
                       "candidates": len(lres.sims)})
        for s in lres.sims:
            labels[id(s)] = "climb"
        # the accepted chain tip always advances to the paired screen
        labels[id(lres.final)] = "climb-tip"
        incumbents.append(lres.final)
        sims += lres.sims + [lres.final]

    def batch_paired(seqs, bopts, seed):
        times = emp.benchmark_batch_times([naive_seq] + list(seqs), bopts,
                                          seed=seed)
        results = [BenchResult.from_times(ts) for ts in times]
        paired = [paired_speedup(times[0], ts, seed=seed + 1) for ts in times[1:]]
        return results, paired

    def label_of(s) -> str:
        """An incumbent's label; for an MCTS or climb candidate its base
        with the schedule's transfer engine (halo), staging (moe) or fold
        granularity (attn)."""
        base = labels.get(id(s), "mcts")
        if base not in ("mcts", "climb", "climb-tip"):
            return base
        names = [op.desc() for op in s.order.vector()]
        if halo:
            return f"{base}/{'rdma' if any('.rdma' in n for n in names) else 'host'}"
        if moe:
            return f"{base}/{moe_staging_of(s.order)}"
        engine = next((e for e in (".fused_bf16", ".fused")
                       if any(e in n for n in names)), ".chain")
        return f"{base}/{engine[1:]}"

    # distinct candidates: every incumbent (climb tips included), then the
    # climb and confirmed MCTS pools, each sorted within itself and
    # interleaved (the reference's ranking, bench/driver.py:1660-1698)
    inc_ids = {id(s) for s in incumbents}
    others = [s for s in sims if id(s) not in inc_ids and s.fidelity == "full"]
    pools = {label: sorted((s for s in others
                            if labels.get(id(s), "mcts") == label),
                           key=lambda s: s.result.pct50)
             for label in ("climb", "mcts")}
    interleaved = [s for pair in zip_longest(pools["climb"], pools["mcts"])
                   for s in pair if s is not None]
    seen, cands = set(), []
    for s in chain(incumbents, interleaved):
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
    skip = set(ex.host_names)
    if moe:  # the staging sets' transport scratch, host and device side
        staging = moe_staging(args)
        skip.update(moe_pipeline.host_buffer_names(wargs[0], staging))
        skip.update(moe_pipeline.transport_buffer_names(wargs[0], staging))
    mismatched = mismatched_outputs(out_n, out_w, args.verify_tol, skip=skip)
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
        "climbs": climbs,
        "not_ported": not_ported,
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
