"""The driver: the halo, blocked-attention, MoE and SpMV searches end to end on
CUDA.

Counterpart of the single-device paths of ``tenzing_tpu/bench/driver.py``.
:func:`run` builds the request's workload at the reference size with its menus
on — the 3D halo exchange (nQ=3, 512^3 cells, radius 3; the default),
single-device blocked attention at 8k context (``workload="attn"``: batch 4,
8 K/V blocks of 1024, head dim 128), the MoE dispatch/combine pipeline
(``workload="moe"``: 8 experts, 8192 tokens, d_model 512, d_ff 2048, 4
chunks, with the staging x engine and expert-MLP kernel menus) or one SpMV
iteration (``workload="spmv"``: a band matrix of m=150000 rows, 10 nonzeros a
row, the x exchange a host round trip, the SpMV kernel menu) — then

1. measures the one-lane naive order (halo and moe: each chain completed in
   turn; attn and spmv: the first decision at every step);
2. measures the incumbents (and, at full size, the best rows of the
   recorded search databases: the warm start, :func:`warm_start`): for halo
   the greedy and paired ones over
   ``engine in {host, rdma, mixed, alias}`` on 8 lanes (and the engine-fixed
   incumbents at 2, 3 and 6 lanes); for attn the bf16 kernel chain and the
   fused bf16 kernel, both on one lane; for moe the greedy overlap order with
   f32 and bf16 staging, the bf16 and f32 device-copy orders, and (the
   port's own) the bf16 device-copy order with the expert MLP on the kernel;
   for spmv (the port's own; the reference has none) the naive walk with
   every SpMV on the kernel where the menu offers it;
3. runs FastMin MCTS (halo: seeded with the incumbents' decision paths, with
   the alias discipline as rollout policy; moe: seeded with the bf16-rdma
   discipline, which is also its rollout policy; attn and spmv: unseeded,
   random rollouts) at a cheap screen floor and a confirm pass at the search
   floor;
4. hill-climbs (halo: the alias discipline on 3 and 6 lanes, the budget split
   4:3; moe: the bf16-rdma discipline over the whole budget; with recorded
   rows, first a climb from the best one's menu choices, on a third of the
   halo budget or half the moe budget), paired, at 10x the search floor;
   the climbs' candidates and chain tips join the pool.  With
   ``--search-workers N --measure-batch K`` the same climbs run as jobs of
   the search fleet (search/fleet.py; where a workload has none, two
   ``generic_xla`` jobs split the budget): inline at ``(1, 1)``, else over
   N worker processes measured in fused rounds of up to K candidates, the
   stats in ``perf.distributed``;
5. ranks the distinct candidates against naive in a paired decorrelated
   screen, then re-measures naive and the top 3 in a longer paired final;
6. re-runs the winner beside naive from the same initial buffers as an
   integrity gate: the independent verifier must pass it, the result buffers
   of both runs (attention's O, the MoE pipeline's Y) must lie within the
   tolerance of their precision of the float64 result, and every other
   buffer must agree with naive's (bench/gate.py); with ``profile_winner`` the reported schedule (and naive) run unit by
   unit for the attribution block (``attrib``: sum of parts, critical path,
   dispatch overhead, overlap efficiency, the decision diff; obs/attrib);
7. with ``fuse_winner``, lowers the reported schedule into fused regions
   (runtime/fused.py), measures each tile count of the menu, gates the best
   fused program against the stepped one and re-verifies the schedule
   (``perf.fused``); with ``fuse_search_tiles`` the tile menu is a decision
   of the searched graph from the start (``perf.fuse_search_tiles``);
8. with ``chunk``, the attn and moe menus offer the chunked expansions of
   the ``.xla`` fold and expert MLP (core/chunking.py), and ``perf.chunked``
   reports the pruned menus, what the search visited and what it chose, and
   the comm measured hidden under the partials; with ``synth_collectives``
   the spmv exchange is also offered as a host pipeline in chunks
   (collectives/synth.py), and ``perf.synth`` reports the priced and pruned
   menus, what the search visited and chose, the estimated comm and, with
   ``profile_winner``, the comm measured hidden;
9. with ``dump_csv`` writes the run's search database (naive as row 0, the
   final batch's numbers first), which ``seed_csv`` reads back;
10. returns the JSON line (``metric``, ``value``, ``unit``, ``vs_baseline``,
    ``verified``, the ``gate`` block, the ``fault`` block, plus the
    measurement regime), and with ``trace_out`` / ``metrics_json`` writes the
    telemetry bundle (obs/).

Every measurement goes through the reference's fault stack (fault/), from
the inside out: the ``EmpiricalBenchmarker``; with ``--inject-faults`` a
``FaultInjectingBenchmarker`` for the measurement kinds; the
``PrefetchingBenchmarker`` (``--prefetch-compiles``, off under
``--resume``); the ``ResilientBenchmarker`` (the soundness gate, the
``--measure-timeout`` watchdog, classified retry, the quarantine); an
injector for ``corrupt`` above it, where the verifier sees its mutations;
with ``--checkpoint DIR`` the ``JournalingBenchmarker``; and the
``CachingBenchmarker``, which ``--resume`` fills from the journal.  Without a
learned model a lost device raises ``DeviceLostError`` out of the run: the
journal and the quarantine are on disk, and ``--resume`` in a new process is
the recovery.  With ``--learn-screen --learn-model PATH`` the model
(learn/) is the resilient layer's fallback: after a device loss every query
is a model answer tagged ``degraded``, the driver touches the device no
more (no climbs, no paired screen or final batch, no gate, no profile, no
fused run) and reports the pre-loss naive pct50 with ``vs_baseline`` 1.0 and
``verified: false`` (``fault.error``: "degraded: no device").  The same
model screens the MCTS rollouts (learn/surrogate.py
``ScreeningBenchmarker``), prunes the climbs' neighbours and orders the
prefetcher's hints; ``--learn-train`` trains it offline from search
databases.  Every
error of the CUDA runtime counts as a lost device (fault/errors.py), so no
run goes on in a process after one.  A failure the solvers search past (a
quarantined schedule, a retried attempt) is counted in the ``fault`` block's
``failures``, which a run whose every measurement succeeded does not have.

:class:`DriverRequest` is a copy of the reference's, field for field, with the
same defaults, and every field runs; a workload the port does not have
raises :exc:`DriverConfigError` ("... not yet ported"), so nothing is
silently ignored.  Deviations from the reference: a recorded row is measured only
after the port's verifier passes it (a rejected row is counted in the
``recorded`` block); a failed recorded row or profile raises (the reference
retries, drops or catches it into an error field); the smoke reads a
database it is given (``--seed-csv``) and climbs from it, where the
reference's smoke ignores the flag; the integrity gate holds result buffers
to the float64 result (bench/gate.py, ROADMAP Queue 3 item 4); an
incumbent whose measurement the resilient layer rejects is dropped, as the
reference drops attention's; and with ``--checkpoint`` the screen and final
batches are journaled too, so a resumed run that had finished reports the
same verdict bit for bit (the integrity gate re-runs both schedules every
time); the ``perf.synth`` block raises where it fails (the reference's
catches the failure into an ``error`` field, ROADMAP Queue 3); and
``--learn-screen`` without ``--learn-model``, or ``--learn-trace`` without
``--learn-train``, is refused (the reference runs without the screen, or
ignores the traces).

Entry point: ``python -m tenzing_tpu_torch.bench`` (``--device cpu`` runs on
the CPU; the default is the card).  The serving plane (serve/) keys and
resolves requests with :func:`workload_shape` and :func:`graph_for`, which
open no device.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tenzing_tpu_torch.bench.gate import (
    attn_gate,
    gate_outputs,
    mismatched_outputs,
    moe_gate,
)
from tenzing_tpu_torch.utils.cli import write_line


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


_DEFAULTS = DriverRequest()
# the spmv workload's nonzeros a row (the reference's)
SPMV_NNZ_PER_ROW = 10


WORKLOADS = ("halo", "attn", "moe", "spmv")

# the repository's root: the default warm-start globs are relative to it
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the recorded search databases a full-size run reads as warm starts by
# default (the reference's bench/driver.py:1283-1288); ``--seed-csv GLOB``
# names others, ``--seed-topk 0`` turns the warm start off
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
    if req.learn_screen and not req.learn_model:
        raise DriverConfigError("--learn-screen requires --learn-model PATH")
    if req.learn_trace and not req.learn_train:
        raise DriverConfigError("--learn-trace requires --learn-train GLOB")
    if req.resume and not req.checkpoint:
        # resuming nothing would re-measure the search while the JSON
        # claims a resume
        raise DriverConfigError("--resume requires --checkpoint DIR")
    if req.measure_timeout is not None and req.measure_timeout <= 0:
        raise DriverConfigError("--measure-timeout must be positive")
    if req.inject_faults:
        from tenzing_tpu_torch.fault.inject import parse_inject_specs

        try:
            specs = parse_inject_specs(req.inject_faults)
        except ValueError as e:
            raise DriverConfigError(str(e)) from e
        if req.no_verify and any(s.kind == "corrupt" for s in specs):
            # corruption without the verifier would measure broken schedules
            raise DriverConfigError(
                "--inject-faults corrupt: requires the soundness verifier "
                "(drop --no-verify)")
    if req.prefetch_compiles < 0:
        raise DriverConfigError("--prefetch-compiles must be >= 0")
    if req.climb_budget < 0:
        raise DriverConfigError("--climb-budget must be >= 0")
    if req.halo_n < 1:
        raise DriverConfigError("--halo-n must be positive")
    if req.m is not None and req.m < 2:
        raise DriverConfigError("--m must be at least 2")


# the per-face aliased-unpack recipe of the reference (its ALIAS_UNPACK):
# one slot per face axis, shared by the greedy seeding and the rollout policy
ALIAS_UNPACK = {"x": ".pallas", "y": ".pallasf", "z": ".pallasb"}


def alias_unpack_choice(op_name, choices):
    """The alias-recipe kernel for an ``unpack_*`` op from the menu, or None
    when it is off-menu."""
    want = ALIAS_UNPACK[op_name[-1]]
    return next((c for c in choices if c.endswith(want)), None)


def generic_xla_prefer(op_name, choices):
    """The workload-agnostic policy: the ``.xla`` alternative where the menu
    has one (the reference's; the fleet's synthesized climb jobs use it)."""
    return next((c for c in choices if c.endswith(".xla")), None)


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
    if workload == "spmv":
        sfx = f"_bw{args.spmv_bw}" if args.spmv_bw is not None else ""
        return f"spmv_iter_pct50_searched_m{spmv_m(args)}{sfx}"
    n_ctx = 4 * 16 if args.smoke else 8 * 1024
    return f"attn_blockwise_pct50_searched_n{n_ctx}"


def search_lanes(req: DriverRequest) -> int:
    """8 lanes for full-size halo, else 2, unless overridden."""
    if req.lanes:
        return req.lanes
    return 8 if req.workload == "halo" and not req.smoke else 2


def workload_shape(req: DriverRequest) -> Dict[str, int]:
    """The request's exact shape parameters, as the builders resolve them:
    what the serving fingerprint keys on (serve/fingerprint.py; the
    reference's, bench/driver.py:419-451).  Request arithmetic only: no
    buffers, no device."""
    w = req.workload
    if w == "halo":
        h = halo_args(req)
        return {"nq": h.nq, "n": h.lx, "radius": h.radius}
    if w == "spmv":
        m = spmv_m(req)
        # bw as make_spmv_buffers resolves it: a default request and an
        # explicit --spmv-bw of that value build the same matrix
        bw = req.spmv_bw if req.spmv_bw is not None else max(1, m // 8)
        return {"m": m, "nnz_per_row": SPMV_NNZ_PER_ROW, "bw": bw}
    if w == "moe":
        if not req.smoke:
            return {"tokens": req.moe_tokens}
        a = moe_args(req)
        return {"n_experts": a.n_experts, "tokens": a.tokens,
                "d_model": a.d_model, "d_ff": a.d_ff, "n_chunks": a.n_chunks}
    if w == "attn":
        a = attn_args(req)
        return {"n_devices": a.n_devices, "batch": a.batch,
                "seq_local": a.seq_local, "head_dim": a.head_dim}
    raise DriverConfigError(f"unknown workload {w!r}")


def _host_nbytes(v) -> int:
    """The bytes of a host buffer of a builder's dict; a ZerosSpec (the
    bf16 staging) counts what its tensor will hold."""
    from tenzing_tpu_torch.runtime.executor import ZerosSpec

    if isinstance(v, ZerosSpec):
        n = 1
        for d in v.shape:
            n *= int(d)
        return n * (2 if v.dtype in ("bfloat16", "float16") else 4)
    return int(getattr(v, "nbytes", 0))


def graph_for(req: DriverRequest):
    """``(graph, nbytes)`` for ``req`` without a device: the choice graph
    :func:`run` searches (the same ``build_graph`` and menus as
    :func:`build_halo`, :func:`build_spmv`, :func:`build_moe`,
    :func:`build_attn`), which recorded and stored schedules deserialize
    and verify against, and a buffer-size map for the surrogate's features
    (the reference's, bench/driver.py:463-551).  ``nbytes`` is ``{}`` for
    the full-size halo (its 2 GB grid is not built to read a size); the
    other workloads build their host buffers once, because spmv's graph
    depends on them (``x_sizes`` comes from the band matrix's split).
    Opens no CUDA context."""
    w = req.workload
    if w == "halo":
        from tenzing_tpu_torch.models.halo_pipeline import make_pipeline_buffers

        hargs = halo_args(req)
        nbytes: Dict[str, int] = {}
        if req.smoke:
            bufs, _ = make_pipeline_buffers(hargs, seed=0, with_expected=False)
            nbytes = {k: _host_nbytes(v) for k, v in bufs.items()}
        return halo_graph(hargs, req.smoke), nbytes
    if w == "spmv":
        bufs, x_sizes = spmv_host_buffers(req)
        g = spmv_graph(x_sizes, bool(req.synth_collectives), req.smoke)
        return g, {k: _host_nbytes(v) for k, v in bufs.items()}
    if w == "moe":
        from tenzing_tpu_torch.models.moe_pipeline import (
            build_graph,
            make_pipe_buffers,
        )

        margs, staging = moe_args(req), moe_staging(req)
        bufs, _, cap = make_pipe_buffers(margs, seed=0, with_expected=False,
                                         staging=staging)
        g = build_graph(margs, cap, impl_choice=not req.smoke, staging=staging,
                        chunk=req.chunk, chunk_relax=req.smoke)
        return g, {k: _host_nbytes(v) for k, v in bufs.items()}
    if w == "attn":
        from tenzing_tpu_torch.models.ring_attention import make_blocked_buffers

        aargs = attn_args(req)
        bufs, _ = make_blocked_buffers(aargs, seed=0, with_expected=False)
        g = attn_graph(aargs, chunk=req.chunk, chunk_relax=req.smoke)
        return g, {k: _host_nbytes(v) for k, v in bufs.items()}
    raise DriverConfigError(f"unknown workload {w!r}")


def halo_args(args):
    """The request's halo grid: the reference's full size (3 quantities,
    ``halo_n`` cubed, radius 3) or its smoke."""
    from tenzing_tpu_torch.models.halo import HaloArgs

    if args.smoke:
        return HaloArgs(nq=2, lx=4, ly=4, lz=4, radius=1)
    n = args.halo_n
    return HaloArgs(nq=3, lx=n, ly=n, lz=n, radius=3)


def halo_graph(hargs, smoke: bool):
    """The halo pipeline's graph with the menus as the reference offers
    them: on for the full-size search, off for the smoke configuration."""
    from tenzing_tpu_torch.models.halo_pipeline import build_graph

    menus = not smoke
    return build_graph(hargs, impl_choice=menus, xfer_choice=menus)


def build_halo(args, device):
    """(graph, placed buffers, metric, HaloArgs) at the request's size."""
    from tenzing_tpu_torch.models.halo_pipeline import (
        host_buffer_names,
        make_pipeline_buffers,
    )
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    hargs = halo_args(args)
    bufs, _ = make_pipeline_buffers(hargs, seed=0, with_expected=False)
    tbufs = buffers_from_numpy(bufs, device, host_buffer_names())
    del bufs
    return halo_graph(hargs, args.smoke), tbufs, metric_for("halo", args), hargs


def attn_args(args):
    """The request's attention configuration: the reference's full size (8k
    context in 8 K/V blocks of 1024, batch 4, head dim 128) or its smoke."""
    from tenzing_tpu_torch.models.ring_attention import RingAttnArgs

    if args.smoke:
        return RingAttnArgs(n_devices=4, batch=1, seq_local=16, head_dim=8)
    return RingAttnArgs(n_devices=8, batch=4, seq_local=1024, head_dim=128)


def attn_graph(aargs, chunk: bool = False, chunk_relax: bool = False):
    """Start -> BlockedAttention (kernel and granularity menus, and with
    ``chunk`` the sub-fold menus) -> Finish."""
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.models.ring_attention import BlockedAttention

    g = Graph()
    op = BlockedAttention(aargs, impl_choice=True, fused_choice=True,
                          chunk=chunk, chunk_relax=chunk_relax)
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
    # the chunk menus pruned by the roofline at full size, every valid count
    # for the smoke (the reference's chunk_relax=args.smoke)
    g = attn_graph(aargs, chunk=args.chunk, chunk_relax=args.smoke)
    return g, tbufs, metric_for("attn", args), aargs


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
    """(graph, placed buffers, metric, (MoEPipeArgs, capacity, float64
    expected Y)) at the request's size: the staging and expert-MLP menus on
    at full size, off for the smoke (the reference's build_moe,
    bench/driver.py:354-378); the expected Y is what the integrity gate
    holds the result to (bench/gate.py ``moe_gate``)."""
    from tenzing_tpu_torch.models.moe_pipeline import (
        build_graph,
        host_buffer_names,
        make_pipe_buffers,
    )
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    margs, staging = moe_args(args), moe_staging(args)
    bufs, want64, cap = make_pipe_buffers(margs, seed=0, staging=staging,
                                          expected_float64=True)
    tbufs = buffers_from_numpy(bufs, device,
                               host_buffer_names(margs, staging=staging))
    del bufs
    g = build_graph(margs, cap, impl_choice=not args.smoke, staging=staging,
                    chunk=args.chunk, chunk_relax=args.smoke)
    return g, tbufs, metric_for("moe", args), (margs, cap, want64)


def spmv_m(args) -> int:
    """The request's SpMV rows: ``--m``, else the reference's 150000 (512
    for the smoke)."""
    return args.m if args.m is not None else (512 if args.smoke else 150_000)


def build_spmv(args, device):
    """(graph, placed buffers, metric, m) at the request's size: the band
    matrix of :func:`spmv_host_buffers` placed, and :func:`spmv_graph` (the
    reference's build_spmv, bench/driver.py:319-351)."""
    from tenzing_tpu_torch.models.spmv import spmv_host_buffer_names
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    synth = bool(args.synth_collectives)
    bufs, x_sizes = spmv_host_buffers(args)
    tbufs = buffers_from_numpy(bufs, device, spmv_host_buffer_names(
        x_sizes["x_remote"], synth=synth))
    del bufs
    g = spmv_graph(x_sizes, synth, args.smoke)
    return g, tbufs, metric_for("spmv", args), spmv_m(args)


def spmv_host_buffers(args):
    """(host buffers, x sizes) of the request's band matrix: m rows of
    ``SPMV_NNZ_PER_ROW`` nonzeros, band ``--spmv-bw`` (default m/8); the x
    sizes come from the matrix's local/remote split."""
    from tenzing_tpu_torch.models.spmv import make_spmv_buffers

    bufs, _ = make_spmv_buffers(m=spmv_m(args), nnz_per_row=SPMV_NNZ_PER_ROW,
                                bw=args.spmv_bw, seed=0,
                                synth=bool(args.synth_collectives))
    x_sizes = {"x_local": int(bufs["x_local"].shape[0]),
               "x_remote": int(bufs["x_remote"].shape[0])}
    return bufs, x_sizes


def spmv_graph(x_sizes, synth: bool, relax: bool):
    """Start -> SpMVCompound -> Finish (the reference's two equal compounds
    being one vertex): the kernel menu with the x sizes known, the host
    round trip as the x exchange, and with ``synth`` its pipe menu, every
    instantiation kept under ``relax`` (the smoke), the roofline's prune
    otherwise (the reference's ``synth_relax=args.smoke``)."""
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.models.spmv import SpMVCompound

    def mk():
        return SpMVCompound(impl_choice=True, x_sizes=x_sizes, exchange="host",
                            synth=synth, synth_relax=relax)

    g = Graph()
    g.start_then(mk())
    g.then_finish(mk())
    return g


def spmv_incumbents(g, plat):
    """The port's own spmv incumbent (the reference has none,
    bench/driver.py:1145): the first-decision walk with every SpMV on the
    ``ell_spmv`` kernel where the menu offers it.  Without it a short search
    may never launch the kernel.  Empty when no SpMV offers the kernel (the
    walk would be the naive order)."""
    from tenzing_tpu_torch.solve.local import first_decision_order

    seq = first_decision_order(g, plat, ".pallas")
    if not any(op.name().endswith(".pallas") for op in seq.vector()):
        return []
    return [("naive-pallas", seq)]


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


def recorded_prefer(chosen: Dict[str, str]):
    """The climb policy replicating a recorded schedule's menu choices
    (``chosen``: base op name -> ``".suffix"``; the reference's
    ``recorded_prefer``).  Off the map, a transfer takes ``.host`` (a
    recorded host-staged transfer leaves no ``xfer_*`` vertex: the
    round-trip compound expands into spill and fetch) and anything else
    ``.xla``."""

    def prefer(op_name, choices):
        want = chosen.get(op_name)
        if want is not None:
            c = next((c for c in choices if c.endswith(want)), None)
            if c is not None:
                return c
        if op_name.startswith("xfer_"):
            return next((c for c in choices if c.endswith(".host")), None)
        return next((c for c in choices if c.endswith(".xla")), None)

    return prefer


def recorded_chosen_and_lanes(seq):
    """(chosen, lanes) of a recorded schedule: its menu choices (base op name
    -> ``".suffix"``) and the lanes it used (2 when it binds none)."""
    from tenzing_tpu_torch.core.serdes import sequence_to_json

    js = sequence_to_json(seq)
    chosen: Dict[str, str] = {}
    for j in js:
        n = j.get("name", "")
        if "." in n:
            base, suffix = n.rsplit(".", 1)
            chosen.setdefault(base, "." + suffix)
    lanes_used = [j.get("lane") for j in js if j.get("lane") is not None]
    return chosen, (max(lanes_used) + 1 if lanes_used else 2)


def recorded_prefer_and_lanes(seq):
    """(prefer, lanes) of the climb seeded from a recorded schedule: its
    menu choices (:func:`recorded_prefer`) on as many lanes as it used
    (the reference's ``recorded_prefer_and_lanes``)."""
    chosen, lanes = recorded_chosen_and_lanes(seq)
    return recorded_prefer(chosen), lanes


def climb_configs(args, plat, recorded=()):
    """The hill-climbs of a full-size run: (label, platform, phases, prefer,
    budget) each.  Halo: the alias discipline on 3 and 6 lanes, the budget
    split 4:3; moe: the bf16-rdma discipline over the whole budget.  With
    ``recorded`` schedules (the warm start's, best measured first) a climb
    seeded from the first one's menu choices comes first and takes a third
    of the halo budget, half of the moe budget (the reference's ``b_rec``).
    Attn and spmv run no climbs, and neither does the smoke (reference
    bench/driver.py:1457-1495), but for the recorded one where the smoke
    was given a database (``--seed-csv``)."""
    from tenzing_tpu_torch.core.platform import Platform

    if args.climb_budget <= 0 or args.workload not in ("halo", "moe"):
        return []
    if args.smoke and not recorded:
        return []
    if args.workload == "halo":
        from tenzing_tpu_torch.models.halo_pipeline import HALO_PHASES as phases

        b_rec = args.climb_budget // 3 if recorded else 0
        rest = args.climb_budget - b_rec
        b1 = (rest * 4) // 7
        out = [("halo_alias", Platform.make_n_lanes(3), phases,
                halo_alias_prefer, b1),
               ("halo_alias", Platform.make_n_lanes(6), phases,
                halo_alias_prefer, rest - b1)]
    else:
        from tenzing_tpu_torch.models.moe_pipeline import PHASES as phases

        b_rec = args.climb_budget // 2 if recorded else 0
        out = [("moe_bf16", plat, phases, moe_bf16_prefer,
                args.climb_budget - b_rec)]
    if args.smoke:  # the smoke climbs only from the database it was given
        out = []
    if b_rec:
        prefer, n_lanes = recorded_prefer_and_lanes(recorded[0])
        out.insert(0, ("recorded", Platform.make_n_lanes(n_lanes), phases,
                       prefer, b_rec))
    return out


def fleet_jobs(args, plat, cfgs, recorded=()):
    """The fleet's jobs (search/fleet.py ``FleetJob``) for the climb
    configurations ``cfgs`` (:func:`climb_configs`), each with its label as
    the prefer policy's name and the recorded schedule's choices where it
    climbs from one.  Where there are none but a climb budget (the smoke,
    attn, spmv), two ``generic_xla`` jobs split the budget, as the
    reference's do: the jobs depend on the request only, never on N or K."""
    from tenzing_tpu_torch.search.fleet import FleetJob

    if args.climb_budget <= 0:
        return []
    if not cfgs:
        if args.workload == "halo":
            from tenzing_tpu_torch.models.halo_pipeline import HALO_PHASES as ph
        elif args.workload == "moe":
            from tenzing_tpu_torch.models.moe_pipeline import PHASES as ph
        else:
            ph = ("",)
        half = max(1, args.climb_budget // 2)
        cfgs = [("generic_xla", plat, ph, generic_xla_prefer, half)] * 2
    chosen = recorded_chosen_and_lanes(recorded[0])[0] if recorded else None
    return [FleetJob(index=ci, budget=cbudget, seed=2 + ci,
                     lanes=len(cplat.lanes), phases=tuple(cphases),
                     prefer=clabel,
                     chosen=chosen if clabel == "recorded" else None)
            for ci, (clabel, cplat, cphases, _, cbudget) in enumerate(cfgs)]


def run_climb_fleet(args, g, jobs, bench, climb_opts, surrogate, ckpt,
                    verifier, prefetcher, tile_menu, resilient, log):
    """Run ``jobs`` inline (``(1, 1)``: search/fleet.py ``run_serialized``)
    or over ``--search-workers`` processes with fused rounds of up to
    ``--measure-batch`` candidates (``run_fleet``); logs the reference's
    ``fleet:`` line.  Returns the ``FleetResult``, or None where the device
    was lost inside the climbs (the resilient layer then degraded)."""
    from tenzing_tpu_torch.fault.errors import DeviceLostError
    from tenzing_tpu_torch.search.fleet import run_fleet, run_serialized

    n_w = max(1, int(args.search_workers))
    k_fuse = max(1, int(args.measure_batch))
    t0 = time.time()
    try:
        if n_w == 1 and k_fuse == 1:
            fres = run_serialized(g, jobs, bench, climb_opts,
                                  surrogate=surrogate, ckpt=ckpt,
                                  verifier=verifier, prefetcher=prefetcher)
        else:
            fres = run_fleet(g, args.to_json(), jobs, bench, climb_opts, n_w,
                             k_fuse, prefetcher=prefetcher,
                             verify=not args.no_verify, tile_menu=tile_menu,
                             log=log)
    except DeviceLostError:
        if not resilient.degraded:
            raise
        log("fleet: ended (device lost)")
        return None
    st = fres.stats
    log(f"fleet: {st['workers']}w K={st['measure_batch']}: "
        f"{st['candidates']} candidates / {st['jobs']} jobs in "
        f"{st['wall_s']}s ({st['rounds']} fused rounds, occupancy "
        f"{st['batch_occupancy']}, {st['singles']} singles, "
        f"{st['reclaimed_subtrees']} reclaimed, scaling "
        f"{st['scaling_factor']}x, wall {time.time()-t0:.0f}s)")
    return fres


def warm_start(pattern: str, topk: int, g, bench, verifier, opts, with_tile1,
               log, prefetcher=None):
    """The recorded warm start (the reference's bench/driver.py:1275-1340):
    rank the rows of the databases ``pattern`` matches (a glob, relative to
    :data:`REPO_ROOT` unless absolute) by their in-file ratio
    (bench/recorded.py ``rank_recorded``), check each of the ``topk`` picked
    rows with the port's verifier and measure the sound ones at ``opts``.
    Returns ``(sims, block)``: a ``SimResult`` per measured row, best
    recorded ratio first, and the JSON's ``recorded`` block.

    Row 0 of a database is its naive anchor and is never picked (it never
    beats itself).  A picked row the verifier rejects is counted and
    skipped; a row that does not resolve against the graph was skipped by
    the reader and is counted too.  A measurement that fails raises.  The
    picked rows are hinted to ``prefetcher`` (or None) before the first is
    measured."""
    import glob

    from tenzing_tpu_torch.bench.recorded import rank_recorded
    from tenzing_tpu_torch.solve.mcts import SimResult

    full = pattern if os.path.isabs(pattern) else os.path.join(REPO_ROOT,
                                                               pattern)
    paths = sorted(glob.glob(full))
    if not paths:
        log(f"recorded db: no files match {full!r}")
    block: Dict[str, Any] = {"glob": pattern}
    picked = rank_recorded(paths, g, topk, log=log, stats=block)
    block.update(picked=len(picked), rejected=0, measured=[])
    if prefetcher is not None:
        prefetcher.prefetch([with_tile1(s) for s, _ in picked])
    sims = []
    for ri, (seq, ratio) in enumerate(picked):
        seq = with_tile1(seq)
        verdict = verifier(seq)
        if not verdict.ok:
            block["rejected"] += 1
            log(f"recorded[{ri}] rejected by the verifier "
                f"({verdict.witness()})")
            continue
        t0 = time.time()
        meas = bench.benchmark(seq, opts)
        log(f"recorded[{ri}] candidate: pct50={meas.pct50*1e6:.1f}us "
            f"(recorded ratio {ratio:.3f}, wall {time.time()-t0:.0f}s)")
        block["measured"].append({"label": f"recorded[{ri}]",
                                  "recorded_ratio": round(ratio, 4),
                                  "pct50_us": round(meas.pct50 * 1e6, 2)})
        sims.append(SimResult(order=seq, result=meas))
    return sims, block


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


# the counters of failed measurement attempts and rejected candidates: none
# moves in a run whose every measurement succeeded, and the ``fault`` block
# reports each that moved, so a failure the solvers searched past is seen
FAILURE_COUNTERS = ("fault.errors.transient", "fault.errors.deterministic",
                    "fault.errors.device_lost", "fault.retries",
                    "fault.watchdog.fired", "fault.quarantine_hits",
                    "search.candidate_failed")


def failure_counts() -> Dict[str, int]:
    """The :data:`FAILURE_COUNTERS` as they stand now."""
    from tenzing_tpu_torch.obs.metrics import get_metrics

    reg = get_metrics()
    return {n: reg.counter(n).value for n in FAILURE_COUNTERS}


@dataclass
class FaultStack:
    """The run's measurement stack (:func:`fault_stack`): ``bench`` is the
    cache every search measures through; ``batcher`` runs the screen and
    final batches (the journal, else the resilient layer)."""

    bench: Any
    batcher: Any
    resilient: Any
    prefetcher: Any
    quarantine: Any
    ckpt: Any
    injectors: List[Any]


def fault_stack(args: DriverRequest, g, metric: str, emp, measure_ex,
                verifier, dev, scope: "_RunScope", log,
                surrogate=None) -> FaultStack:
    """Build the reference's measurement stack around ``emp``
    (bench/driver.py:893-1031 there), from the inside out:
    ``[FaultInjectingBenchmarker]`` for the measurement kinds,
    ``[PrefetchingBenchmarker]`` (off under ``--resume``: journaled answers
    capture nothing), ``ResilientBenchmarker``, ``[FaultInjectingBenchmarker]``
    for ``corrupt`` (above the verifier gate), ``[JournalingBenchmarker]``,
    ``CachingBenchmarker``; with ``--checkpoint``, load the state (refusing a
    resume under another ``--inject-faults`` spec), restore the journal on
    ``--resume`` and register the done and interrupted snapshots.  A
    ``surrogate`` (``--learn-screen``) orders the prefetcher's hints and is
    the resilient layer's fallback after a device loss, when the prefetcher
    is closed so that no capture touches the device again."""
    from tenzing_tpu_torch.bench.benchmarker import CachingBenchmarker
    from tenzing_tpu_torch.fault import (
        FaultInjectingBenchmarker,
        JournalingBenchmarker,
        Quarantine,
        ResilientBenchmarker,
        SearchCheckpoint,
        parse_inject_specs,
    )

    specs = parse_inject_specs(args.inject_faults) if args.inject_faults else []
    inner_specs = [s for s in specs if s.kind != "corrupt"]
    corrupt_specs = [s for s in specs if s.kind == "corrupt"]
    if specs:
        log(f"chaos: injecting {args.inject_faults}")
    injectors = []
    measured = emp
    if inner_specs:
        measured = FaultInjectingBenchmarker(emp, inner_specs,
                                             hang_secs=args.inject_hang_secs)
        injectors.append(measured)
    prefetcher = None
    if args.prefetch_compiles > 0 and args.resume:
        log("prefetch: disabled under --resume (journaled answers never "
            "compile)")
    elif args.prefetch_compiles > 0:
        from tenzing_tpu_torch.bench.pipeline import PrefetchingBenchmarker

        measured = prefetcher = PrefetchingBenchmarker(
            measured, executor=measure_ex, workers=args.prefetch_compiles,
            rank=surrogate)
        # should the run raise, queued captures are cancelled rather than
        # drained (close() is idempotent)
        scope.on_exit(prefetcher.close)
    ckpt = SearchCheckpoint(args.checkpoint) if args.checkpoint else None
    quar = Quarantine(ckpt.quarantine_path if ckpt else None, log=log)
    if len(quar):
        log(f"quarantine: {len(quar)} schedule(s) carried from earlier runs "
            "will not be measured")
    quiesce = None
    if dev.type == "cuda":
        from tenzing_tpu_torch.runtime.graphs import device_sync

        def quiesce() -> None:
            device_sync(dev)
    resilient = ResilientBenchmarker(
        measured, timeout_secs=args.measure_timeout, quarantine=quar,
        fallback=surrogate, verifier=verifier, quiesce=quiesce,
        on_degrade=prefetcher.close if prefetcher is not None else None)
    guarded = resilient
    if corrupt_specs:
        guarded = FaultInjectingBenchmarker(
            resilient, corrupt_specs,
            unsound_check=lambda o: not verifier(o).ok)
        injectors.append(guarded)
    journal = JournalingBenchmarker(guarded, ckpt) if ckpt else None
    bench = CachingBenchmarker(journal if journal is not None else guarded)
    if ckpt is not None:
        config = {"workload": args.workload, "metric": metric,
                  "smoke": bool(args.smoke), "seed_topk": args.seed_topk}
        prior = None
        try:
            prior = ckpt.load_state()
        except Exception as e:  # a corrupt snapshot: the journal still applies
            log(f"checkpoint: state unreadable ({e}); journal and quarantine "
                "still apply")
        if prior is not None and prior.get("config") not in (None, config):
            log(f"checkpoint: recorded config differs from this run "
                f"({prior.get('config')} vs {config}); journal rows that do "
                "not resolve against this workload are skipped")
        want_inject = args.inject_faults or None
        if args.resume and prior is not None and prior.get("inject") != want_inject:
            # journaled answers from another fault universe would diverge
            # from both the original run and a clean one
            raise DriverConfigError(
                f"--resume: this run's --inject-faults ({want_inject!r}) "
                "disagrees with the checkpoint's recorded spec "
                f"({prior.get('inject')!r}); use the same spec or a fresh "
                "checkpoint directory")
        if args.resume:
            restored = ckpt.restore_into(bench, g, log=log)
            log(f"resume: {restored} recorded measurement(s) restored — "
                "schedules measured before will not touch the device")
        ckpt.save_state(config=config, inject=want_inject)
        scope.on_exit(lambda: ckpt.save_state(done=True))
        scope.on_trap(lambda: ckpt.save_state(interrupted=True))
        scope.on_exit(ckpt.close)
    return FaultStack(bench=bench,
                      batcher=journal if journal is not None else resilient,
                      resilient=resilient, prefetcher=prefetcher,
                      quarantine=quar, ckpt=ckpt, injectors=injectors)


class _RunScope:
    """The run's exit and interrupt handlers (the reference's): each exit
    handler runs once when :func:`run` returns or raises (and at interpreter
    exit should the process end first), each interrupt handler on
    SIGINT/SIGABRT while the run is live; all are unregistered on close."""

    def __init__(self):
        self._finalizers: list = []
        self._traps: list = []

    def on_exit(self, fn) -> None:
        import atexit

        atexit.register(fn)
        self._finalizers.append(fn)

    def on_trap(self, fn) -> None:
        from tenzing_tpu_torch.utils import trap

        trap.register_handler(fn)
        self._traps.append(fn)

    def close(self) -> None:
        import atexit

        from tenzing_tpu_torch.utils import trap

        for fn in reversed(self._finalizers):
            try:
                fn()
            except Exception as e:  # must not mask the run's own outcome
                sys.stderr.write(f"driver: finalizer failed "
                                 f"({type(e).__name__}: {str(e)[:120]})\n")
            atexit.unregister(fn)
        for fn in self._traps:
            trap.unregister_handler(fn)
        self._finalizers.clear()
        self._traps.clear()


def run(req: DriverRequest, device: Optional[str] = None) -> DriverResult:
    """Execute the whole search -> gate -> verdict loop for ``req`` on
    ``device`` (default ``cuda``; raises when no card is present unless
    ``device="cpu"``)."""
    args = dataclasses.replace(req)
    check_request(args)
    from tenzing_tpu_torch.runtime.executor import resolve_device

    dev = resolve_device(device)
    scope = _RunScope()
    try:
        return _run(args, dev, scope)
    finally:
        scope.close()
        # the run's executor, graphs and pinned buffers sit in reference
        # cycles (the benchmarkers keep bound methods of themselves):
        # collect them now, with no capture running, not at some collection
        # during a later run's captures (runtime/graphs.py)
        gc.collect()


def _run(args: DriverRequest, dev, scope: _RunScope) -> DriverResult:
    """The body of :func:`run` on the resolved device ``dev``."""
    import torch

    log = lambda m: sys.stderr.write(m + "\n")  # noqa: E731
    if dev.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(dev)}")
    # --trace-out / --metrics-json: the bundle is written on the success
    # path and, should the run raise, at exit
    attrib_extra: List[Dict[str, Any]] = []
    write_telemetry = telemetry_writer(args, attrib_extra, log)
    if args.trace_out:
        from tenzing_tpu_torch import obs

        obs.configure(enabled=True)
    if args.trace_out or args.metrics_json:
        import atexit

        atexit.register(write_telemetry)
    from itertools import chain, zip_longest

    from tenzing_tpu_torch.bench.benchmarker import (
        BenchOpts,
        BenchResult,
        EmpiricalBenchmarker,
        rejects_failures,
        schedule_id,
    )
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.core.sequence import canonical_key
    from tenzing_tpu_torch.fault.errors import DeviceLostError
    from tenzing_tpu_torch.models import halo_pipeline, moe_pipeline
    from tenzing_tpu_torch.models.ring_attention import fixed_order
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.solve.local import LocalOpts, hill_climb
    from tenzing_tpu_torch.solve.mcts import MctsOpts, SimResult, explore
    from tenzing_tpu_torch.solve.mcts.strategies import FastMin
    from tenzing_tpu_torch.utils.numeric import paired_speedup
    from tenzing_tpu_torch.verify import ScheduleVerifier

    halo, moe = args.workload == "halo", args.workload == "moe"
    spmv = args.workload == "spmv"
    build = {"halo": build_halo, "attn": build_attn, "moe": build_moe,
             "spmv": build_spmv}[args.workload]
    g, bufs, metric, wargs = build(args, dev)
    # the buffers' sizes feed the surrogate's byte and makespan features,
    # the same map for training and for the screen (learn/features.py)
    learn_nbytes = {k: int(getattr(v, "nbytes", 0)) for k, v in bufs.items()}
    if args.learn_train:
        del bufs
        return DriverResult(verdict=learn_train(args, g, learn_nbytes, log,
                                                write_telemetry))
    surrogate = None
    if args.learn_screen:
        from tenzing_tpu_torch.learn import (
            FEATURE_NAMES,
            RidgeEnsemble,
            SurrogateBenchmarker,
        )

        model = RidgeEnsemble.load(args.learn_model,
                                   expect_features=list(FEATURE_NAMES))
        surrogate = SurrogateBenchmarker(model, nbytes=learn_nbytes)
        log(f"learn screen: {args.learn_model} ({model.n_train} training "
            "rows)")
    plat = Platform.make_n_lanes(search_lanes(args))
    if args.smoke:
        args.mcts_iters = min(args.mcts_iters, 12)
    ex = StreamExecutor(plat, bufs, device=str(dev))
    del bufs
    # --fuse-search-tiles: plant the fused-region tile menu as a decision of
    # the graph before the verifier and the search are built, so every
    # measurement lowers through the schedule's fuse_tile.tN directive (the
    # reference's bench/driver.py:835-891).
    measure_ex, tile_menu, tile_planted = ex, None, False
    if args.fuse_search_tiles:
        from tenzing_tpu_torch.runtime.fused import FusedExecutor, with_tile_menu
        from tenzing_tpu_torch.solve.local import first_decision_order

        probe = first_decision_order(g, Platform.make_n_lanes(1))
        tile_menu = FusedExecutor(ex).plan(probe).tile_menu
        if len(tile_menu) > 1:
            g = with_tile_menu(g, tile_menu)
            measure_ex = FusedExecutor(ex)
            tile_planted = True
            log(f"fuse-search-tiles: menu {tile_menu} planted in the choice "
                "graph; measurements lower through the searched directive")
        else:
            log("fuse-search-tiles: tile menu is [1] (no fusible "
                "decomposition survived pruning); nothing to search")

    def with_tile1(seq):
        """An order built outside the planted graph (naive, the greedy
        helpers) completed with the ``fuse_tile.t1`` directive after Start,
        which the planted choice requires."""
        if not tile_planted:
            return seq
        from tenzing_tpu_torch.core.sequence import Sequence
        from tenzing_tpu_torch.runtime.fused import TILE_PREFIX, FuseTile

        ops_ = list(seq.vector())
        if any(op.name().startswith(TILE_PREFIX) for op in ops_):
            return seq
        at = 1 if ops_ and ops_[0].name() == "start" else 0
        return Sequence(ops_[:at] + [FuseTile(1)] + ops_[at:])

    emp = EmpiricalBenchmarker(measure_ex)
    verifier = None if args.no_verify else ScheduleVerifier(g)
    gate_verifier = verifier if verifier is not None else ScheduleVerifier(g)
    stack = fault_stack(args, g, metric, emp, measure_ex, verifier, dev,
                        scope, log, surrogate=surrogate)
    bench, resilient, prefetcher = stack.bench, stack.resilient, stack.prefetcher
    failures0 = failure_counts()

    # the reference's measurement floors (bench/driver.py:1037-1047)
    opts = BenchOpts(n_iters=max(5, args.iters), max_retries=2,
                     target_secs=0.002 if args.smoke else 0.02)
    search_opts = BenchOpts(n_iters=max(3, args.search_iters), max_retries=2,
                            target_secs=0.002 if args.smoke else 0.01)

    naive_plat = Platform.make_n_lanes(1)
    if halo:
        naive_seq = halo_pipeline.naive_order(wargs, naive_plat)
    elif moe:
        naive_seq = moe_pipeline.naive_order(*wargs[:2], naive_plat)
    elif spmv:  # the first decision at every step (reference driver.py:1060-1064)
        from tenzing_tpu_torch.solve.local import first_decision_order

        naive_seq = first_decision_order(g, naive_plat)
    else:  # attn: the same walk, which picks the all-.xla chain
        naive_seq = fixed_order(g, naive_plat)
    naive_seq = with_tile1(naive_seq)
    # the baseline is not a search candidate: spared the identity-keyed
    # kinds (deterministic, corrupt), which would end the run under a rate
    # of the seeds before the search starts
    for inj in stack.injectors:
        inj.exempt_ids.add(schedule_id(naive_seq))
    if prefetcher is not None:
        # hint the baseline itself: its capture starts on a worker and the
        # foreground join consumes it (every run exercises the pipeline's
        # hit path on the real executor)
        prefetcher.prefetch([naive_seq])
    t0 = time.time()
    naive = bench.benchmark(naive_seq, opts)
    if resilient.degraded:
        # the verdict's number is the pre-loss naive measurement: a model
        # answer must never stand in for it
        raise DeviceLostError("device lost while the naive baseline was "
                              "measured: no measurement to report")
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
            g, plat, *wargs[:2], args.smoke)
    elif spmv:
        greedy_seqs = spmv_incumbents(g, plat)
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
    greedy_seqs = [(label, with_tile1(seq)) for label, seq in greedy_seqs]
    if prefetcher is not None:
        # the incumbent grid is known up front: incumbent k+1 captures in
        # the background while incumbent k measures
        prefetcher.prefetch([s for _, s in greedy_seqs])
    for label, seq in greedy_seqs:
        t0 = time.time()
        try:
            res_i = bench.benchmark(seq, search_opts)
        except Exception as e:
            if not rejects_failures(bench, e):
                raise
            log(f"{label} incumbent rejected ({type(e).__name__}: "
                f"{str(e)[:160]})")
            continue
        log(f"{label} incumbent: pct50={res_i.pct50*1e6:.1f}us "
            f"(wall {time.time()-t0:.0f}s)")
        sim = SimResult(order=seq, result=res_i)
        labels[id(sim)] = label
        incumbents.append(sim)

    # the recorded warm start: the best distinct schedules of earlier runs'
    # databases join the candidates, and the best measured one seeds a climb
    recorded, recorded_block = [], None
    # a full-size run reads the committed databases; the smoke reads only
    # one it is given (the reference's smoke ignores --seed-csv)
    seed_glob = (args.seed_csv if args.seed_csv is not None
                 else RECORDED_WARM_START.get(args.workload, ""))
    if seed_glob and args.seed_topk > 0 and (
            args.seed_csv is not None or not args.smoke):
        rec_sims, recorded_block = warm_start(
            seed_glob, args.seed_topk, g, bench, gate_verifier, search_opts,
            with_tile1, log, prefetcher)
        for sim, entry in zip(rec_sims, recorded_block["measured"]):
            labels[id(sim)] = entry["label"]
            incumbents.append(sim)
        recorded = [s.order for s in sorted(rec_sims,
                                            key=lambda s: s.result.pct50)]

    # directed search: cheap screen floor for rollouts, confirm at 10x the
    # search floor (the reference's multi-fidelity split)
    t0 = time.time()
    mcts_screen = BenchOpts(n_iters=2, max_retries=2,
                            target_secs=0.0005 if args.smoke else 0.001)
    mcts_confirm = BenchOpts(n_iters=max(5, args.iters), max_retries=2,
                             target_secs=search_opts.target_secs * 10)
    search_bench = bench
    if surrogate is not None:
        # the learned screen: rollouts at the screen floor may be answered
        # by the model, the confirm pass and every other query always
        # reach the device (the reference's bench/driver.py:1374-1398)
        from tenzing_tpu_torch.learn import ScreeningBenchmarker

        search_bench = ScreeningBenchmarker(
            surrogate, bench, escalate_topk=max(4, args.seed_topk + 1),
            screen_only_opts=mcts_screen)
    res = explore(
        g, plat, search_bench,
        MctsOpts(n_iters=args.mcts_iters, bench_opts=mcts_confirm,
                 screen_opts=mcts_screen, confirm_topk=4, seed=0,
                 rollout_policy=rollout_policy, verify=verifier,
                 prefetch=prefetcher, checkpoint=stack.ckpt),
        strategy=FastMin, seeds=seed_paths,
    )
    learn_block = None
    if surrogate is not None:
        learn_block = {"model": args.learn_model,
                       "train_rows": surrogate.model.n_train,
                       "surrogate_hits": search_bench.hits,
                       "escalations": search_bench.escalations}
        log(f"learn screen: {search_bench.hits} surrogate answers / "
            f"{search_bench.escalations} escalations")
    confirmed = [s for s in res.sims if s.fidelity == "full"]
    log(f"mcts wall {time.time()-t0:.0f}s, tree={res.tree_size}, "
        f"{len(res.sims)} rollouts ({len(seed_paths)} seeded, "
        f"{len(confirmed)} confirmed)")
    log(res.counters.report())
    log(f"bench cache: {bench.hits} hits / {bench.misses} misses")
    # every measured schedule, in the order the database dump writes them
    sims = list(incumbents) + list(res.sims)

    # neighborhood search from the workload's best discipline: paired
    # hill-climbs at 10x the search floor (reference bench/driver.py:1524-1613)
    climb_opts = dataclasses.replace(search_opts, n_iters=8,
                                     target_secs=10 * search_opts.target_secs)
    climbs = []
    cfgs = climb_configs(args, plat, recorded)
    distributed_stats = None
    if args.search_workers > 0 or args.measure_batch > 0:
        # the search fleet (--search-workers N --measure-batch K, the
        # reference's bench/driver.py:1496-1580): (1, 1) runs the same jobs
        # inline, anything larger spawns N workers measuring through fused
        # rounds of up to K candidates; (0, 0) is the loop below
        jobs = fleet_jobs(args, plat, cfgs, recorded)
        fres = None
        if jobs and resilient.degraded:
            log("fleet: skipped (device lost)")
        elif jobs:
            fres = run_climb_fleet(
                args, g, jobs, bench, climb_opts, surrogate, stack.ckpt,
                verifier, prefetcher, tile_menu if tile_planted else None,
                resilient, log)
        if fres is not None:
            distributed_stats = fres.stats
            for jr in fres.jobs:
                if jr.failed:
                    log(f"fleet job {jr.index}: FAILED ({jr.failed})")
                    continue
                for s in jr.sims:
                    labels[id(s)] = "climb"
                sims += jr.sims
                if jr.final is not None:
                    # the chain tip always advances to the paired screen
                    labels[id(jr.final)] = "climb-tip"
                    incumbents.append(jr.final)
                    sims += [jr.final]
    else:
        for ci, (clabel, cplat, cphases, cprefer, cbudget) in enumerate(cfgs):
            if resilient.degraded:
                # a climb compares paired batches on the device
                log(f"hill-climb[{ci}] ({clabel}): skipped (device lost)")
                continue
            t0 = time.time()
            try:
                lres = hill_climb(
                    g, cplat, bench, cphases, prefer=cprefer,
                    opts=LocalOpts(budget=cbudget, bench_opts=climb_opts,
                                   seed=2 + ci, paired=True,
                                   prescreen=surrogate, verify=verifier,
                                   prefetch=prefetcher, checkpoint=stack.ckpt))
            except DeviceLostError:
                if not resilient.degraded:
                    raise
                # the device was lost inside the climb: its paired batch
                # cannot degrade, and the climbs end with it
                log(f"hill-climb[{ci}] ({clabel}): ended (device lost)")
                continue
            log(f"hill-climb[{ci}] ({clabel}, {len(cplat.lanes)} lanes): "
                f"{len(lres.sims)} candidates, {lres.accepted} moves "
                f"accepted, best pct50={lres.best().result.pct50*1e6:.1f}us "
                f"(wall {time.time()-t0:.0f}s)")
            climbs.append({"seed": clabel, "lanes": len(cplat.lanes),
                           "budget": cbudget,
                           "spent": lres.spent, "accepted": lres.accepted,
                           "candidates": len(lres.sims)})
            for s in lres.sims:
                labels[id(s)] = "climb"
            # the accepted chain tip always advances to the paired screen
            labels[id(lres.final)] = "climb-tip"
            incumbents.append(lres.final)
            sims += lres.sims + [lres.final]
    # the search is done: close the pipeline (joins the workers, finalizes
    # the wasted tally) before the screen, the gate and the profiles
    if prefetcher is not None:
        prefetcher.close()
    log(f"compiled programs: {ex.compile_count} ({ex.compile_secs:.1f}s "
        "capture wall)")
    if prefetcher is not None:
        log("prefetch: %(issued)d issued / %(hits)d hits / %(wasted)d "
            "wasted / %(failed)d failed / %(dropped)d dropped"
            % prefetcher.stats())

    def batch_paired(seqs, bopts, seed):
        """Naive and ``seqs`` as one decorrelated batch through the resilient
        layer (the watchdog and transient retries), and the journal where
        there is one."""
        times = stack.batcher.benchmark_batch_times(
            [naive_seq] + list(seqs), bopts, seed=seed)
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
        if spmv:
            kern = any(n.split("@")[0].endswith(".pallas") for n in names)
            return f"{base}/{'pallas' if kern else 'xla'}"
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
    degraded = resilient.degraded
    if degraded:
        # the device was lost and the model answered since (the reference's
        # bench/driver.py:1704-1713): no paired screen or final batch, no
        # gate, no profile, no fused run; the verdict is the pre-loss naive
        # measurement, never a predicted number
        log("degraded: device lost mid-search — skipping the paired "
            "screen/final, the gate and every later device phase; "
            "reporting no-win with degraded provenance")
        cands = []

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
    verdict = gate_verifier(winner_seq)
    skip = set(ex.host_names)
    if moe:  # the staging sets' transport scratch, host and device side
        staging = moe_staging(args)
        skip.update(moe_pipeline.host_buffer_names(wargs[0], staging))
        skip.update(moe_pipeline.transport_buffer_names(wargs[0], staging))
    if spmv:  # the host round trip's pinned staging buffers
        from tenzing_tpu_torch.models.spmv import spmv_host_buffer_names

        skip.update(spmv_host_buffer_names(
            int(ex.init_bufs["x_remote"].shape[0]),
            synth=args.synth_collectives))
    mismatched, gate_block, out_w = [], None, None
    if not degraded:
        t0 = time.time()
        out_w = ex.run(winner_seq)
        out_n = out_w if winner_seq is naive_seq else ex.run(naive_seq)
        result_gate = None
        if args.workload == "attn":
            result_gate = attn_gate(out_n, wargs.scale)
        elif moe:
            result_gate = moe_gate(wargs[2], wargs[0].n_chunks, dev)
        mismatched, gate_block = gate_outputs(out_n, out_w, naive_seq,
                                              winner_seq, args.verify_tol,
                                              skip, result_gate)
        del out_n, result_gate
        log("integrity gate: winner-vs-naive outputs "
            f"{'DIVERGE on ' + str(mismatched[:4]) if mismatched else 'agree'}"
            f", verifier {'ok' if verdict.ok else 'UNSOUND'} "
            f"(wall {time.time()-t0:.0f}s)")
    verified = bool(verdict.ok and not mismatched and not degraded)
    demoted = None
    if not verified and vs > 1.0:
        log("integrity gate FAILED — demoting the winner to no-win")
        value_us = (finals[0].pct50 if finals else naive.pct50) * 1e6
        demoted = winner
        vs, winner = 1.0, None
    # the schedule whose number the JSON reports, after any demotion
    reported_seq = winner.order if winner is not None else naive_seq
    stepped_out = out_w if reported_seq is winner_seq else None
    del out_w

    # --profile-winner: the reported schedule's stepped timeline, and
    # naive's for the decision diff (the reference's bench/driver.py:
    # 1878-1960); a failure raises (the reference catches it into the block)
    cost = workload_cost(args.workload, wargs)
    attrib_block, profiled = None, None
    if args.profile_winner and degraded:
        log("profile-winner: skipped (device lost)")
    elif args.profile_winner:
        fin_res = (finals[1 + best_i] if winner is not None
                   else (finals[0] if finals else naive))
        attrib_block, profiled = profile_reported(
            ex, reported_seq, naive_seq, value_us,
            (finals[0].pct50 if finals else naive.pct50) * 1e6, cost,
            args.profile_repeats, args.trace_out, attrib_extra, fin_res, log)

    # capture provenance (the reference's perf block, bench/driver.py:
    # 2318-2330): schedules captured as CUDA graphs and the capture wall,
    # the pipeline's tallies
    perf: Dict[str, Any] = {
        "compiled_programs": ex.compile_count,
        "compile_secs": round(ex.compile_secs, 3),
        "prefetch": (prefetcher.stats() if prefetcher is not None else
                     {"workers": 0, "issued": 0, "hits": 0, "wasted": 0,
                      "failed": 0, "surfaced": 0, "dropped": 0}),
        "graphs": ex.graph_stats(),
    }
    if distributed_stats is not None:
        # the fleet's block (the reference's perf.distributed): present iff
        # --search-workers / --measure-batch ran it
        perf["distributed"] = distributed_stats
    if args.fuse_winner and degraded:
        log("fuse-winner: skipped (device lost)")
        perf["fused"] = {"error": "degraded: no device"}
    elif args.fuse_winner:
        perf["fused"] = fuse_reported(
            ex, reported_seq, stepped_out, opts, value_us, args.verify_tol,
            skip, gate_verifier, log,
            member_check=fused_member_check(args, reported_seq),
            profile_repeats=args.profile_repeats, cost=cost,
            profiled=profiled)
    del stepped_out
    if tile_menu is not None:
        from tenzing_tpu_torch.runtime.fused import tiles_of

        perf["fuse_search_tiles"] = {"menu": list(tile_menu),
                                     "planted": tile_planted,
                                     "chosen": tiles_of(reported_seq)}
    if args.chunk:
        perf["chunked"] = chunked_block(g, res.sims, reported_seq, log)
        if not degraded:
            perf["chunked"]["hidden_comm_us"]["measured"] = round(
                chunked_hidden_measured(ex, reported_seq, value_us, profiled,
                                        args.profile_repeats, log), 2)
    if args.synth_collectives:
        perf["synth"] = synth_block(
            g, res.sims, reported_seq, verified,
            None if degraded else (ex, value_us, profiled,
                                   args.profile_repeats), log)
    if args.dump_csv:
        dump_database(args.dump_csv, naive_seq, naive, sims, finals, top, log,
                      predicted=(search_bench.was_predicted
                                 if surrogate is not None else None),
                      degraded=resilient.was_degraded)

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
        # the id (bench/benchmarker.py schedule_id) of the schedule whose
        # number this reports: a resumed run names the same one
        "reported_schedule": schedule_id(reported_seq),
        "mcts": {"iters": args.mcts_iters, "tree_size": res.tree_size,
                 "sims": len(res.sims), "seeded": len(seed_paths)},
        "climbs": climbs,
        "recorded_seeds": len(recorded),
    }
    if recorded_block is not None:
        meta["recorded"] = recorded_block
    if attrib_block is not None:
        meta["attrib"] = attrib_block
    if learn_block is not None:
        meta["learn"] = learn_block
    if demoted is not None:
        meta["demoted_label"] = label_of(demoted)
    if not verdict.ok:
        meta["verdict"] = verdict.witness()
    if mismatched:
        meta["diverged"] = mismatched
    if gate_block is not None:
        meta["gate"] = gate_block
    meta["perf"] = perf
    injected: Dict[str, int] = {}
    for inj in stack.injectors:
        for k, v in inj.injected.items():
            if v:
                injected[k] = injected.get(k, 0) + v
    failures = {n: v - failures0[n] for n, v in failure_counts().items()
                if v != failures0[n]}
    if (resilient.degraded or len(stack.quarantine) or args.resume or injected
            or failures):
        # the reference's fault block (bench/driver.py:2376-2397), and the
        # attempts that failed in this run
        meta["fault"] = {"degraded": resilient.degraded,
                         "quarantined": len(stack.quarantine),
                         "resumed": bool(args.resume),
                         **({"injected": injected} if injected else {}),
                         **({"failures": failures} if failures else {}),
                         **({"verified": False,
                             "error": "degraded: no device"}
                            if degraded else {})}
    write_telemetry()
    return DriverResult(verdict={
        "metric": metric,
        "value": round(value_us, 2),
        "unit": "us",
        "vs_baseline": round(vs, 4),
        **meta,
    }, demoted=demoted.order if demoted is not None else None)


def telemetry_writer(args, attrib_extra, log):
    """The writer of ``--trace-out DIR`` (``trace.jsonl``, and ``trace.json``
    in the Chrome trace-event format with ``attrib_extra``'s per-lane
    tracks) and ``--metrics-json PATH`` (the metrics registry); it writes
    once, however often it is called (the reference's
    bench/driver.py:686-741)."""
    done = [False]

    def write() -> None:
        from tenzing_tpu_torch import obs

        if done[0]:
            return
        done[0] = True
        if args.trace_out:
            os.makedirs(args.trace_out, exist_ok=True)
            obs.write_jsonl(obs.get_tracer(),
                            os.path.join(args.trace_out, "trace.jsonl"))
            obs.write_chrome_trace(obs.get_tracer(),
                                   os.path.join(args.trace_out, "trace.json"),
                                   extra_events=attrib_extra or None)
            log(f"trace bundle: {args.trace_out}")
        if args.metrics_json:
            with open(args.metrics_json, "w") as f:
                json.dump(obs.get_metrics().to_json(block=False), f, indent=2,
                          sort_keys=True)
            log(f"metrics: {args.metrics_json}")

    return write


def workload_cost(workload: str, wargs):
    """One iteration's roofline cost of the workload (bench/roofline.py; the
    reference's ``workload_cost``): ``wargs`` is the fourth value the
    ``build_*`` functions return."""
    from tenzing_tpu_torch.bench import roofline

    if workload == "halo":
        return roofline.halo_cost(wargs.nq, wargs.lx, wargs.ly, wargs.lz,
                                  wargs.radius)
    if workload == "spmv":
        return roofline.spmv_cost(wargs, nnz=10 * wargs)
    if workload == "moe":
        margs = wargs[0]
        return roofline.moe_cost(margs.tokens, margs.d_model, margs.d_ff,
                                 staged=True, n_experts=margs.n_experts)
    return roofline.attention_cost(wargs.batch,
                                   wargs.n_devices * wargs.seq_local,
                                   wargs.head_dim)


def profile_reported(ex, seq, naive_seq, measured_us: float, naive_us: float,
                     cost, repeats: int, trace_out, attrib_extra, fin_res,
                     log):
    """``--profile-winner`` (the reference's bench/driver.py:1878-1960): the
    stepped timeline of ``seq`` (obs/attrib), analyzed against its measured
    ``measured_us``, and where ``seq`` is not naive, naive's too and the
    decision diff.  Returns ``(attrib block, the Attribution)``; with
    ``trace_out`` writes ``explain.json`` there and adds the per-lane tracks
    to ``attrib_extra``."""
    from tenzing_tpu_torch.obs import attrib

    t0 = time.time()
    w_tl = attrib.stepped_timeline(ex, seq, repeats=repeats)
    w_at = attrib.analyze(seq.vector(), w_tl, measured_us=measured_us,
                          cost=cost)
    block = w_at.to_json()
    block["fetch_overhead_us"] = round(w_tl.fetch_overhead_us, 3)
    block["timers"] = w_tl.timers()
    expl, n_at = None, None
    if seq is not naive_seq:
        n_tl = attrib.stepped_timeline(ex, naive_seq, repeats=repeats)
        n_at = attrib.analyze(naive_seq.vector(), n_tl, measured_us=naive_us,
                              cost=cost)
        expl = attrib.explain(naive_seq.vector(), seq.vector(),
                              naive_attrib=n_at, winner_attrib=w_at)
        block["explain"] = expl.get("timing", {})
    if fin_res.times:
        block["measured_times"] = [round(t, 9) for t in fin_res.times]
    if trace_out:
        os.makedirs(trace_out, exist_ok=True)
        doc = dict(expl) if expl is not None else {}
        doc["attrib"] = block
        path = os.path.join(trace_out, "explain.json")
        attrib.write_explain(path, doc)
        t0_us = time.time() * 1e6
        attrib_extra.extend(attrib.timeline_trace_events(
            w_at, t0_us=t0_us, label="attrib/winner"))
        if n_at is not None:
            attrib_extra.extend(attrib.timeline_trace_events(
                n_at, t0_us=t0_us, label="attrib/naive", tid_base=2000))
        log(f"explain: {path}")
    eff = block["overlap_efficiency"]
    log("profile-winner: %d units stepped, sum-of-parts %.1fus, critical path "
        "%.1fus, dispatch overhead %.1fus, overlap efficiency %s, fence "
        "%.1fus (wall %.0fs)" % (
            block["n_timed"], block["sum_of_parts_us"],
            block["critical_path_us"], block["dispatch_overhead_us"],
            f"{eff:.3f}" if eff is not None else "n/a",
            w_tl.fetch_overhead_us, time.time() - t0))
    return block, w_at


def chunked_hidden_measured(ex, seq, measured_us: float, profiled, repeats: int,
                            log) -> float:
    """``perf.chunked.hidden_comm_us.measured`` (the reference's
    bench/driver.py:2132-2148): the transfer time that ran under the chunk
    partials on the stepped timeline (core/chunking.py
    ``hidden_comm_measured_us``), reusing ``--profile-winner``'s analysis
    where there is one.  An unchunked schedule hides nothing behind
    partials: 0.0 without a profile."""
    from tenzing_tpu_torch.core.chunking import chunks_of, hidden_comm_measured_us

    if not chunks_of(seq.vector()):
        return 0.0
    from tenzing_tpu_torch.obs import attrib

    t0 = time.time()
    at = profiled
    if at is None:
        at = attrib.analyze(seq.vector(), attrib.stepped_timeline(
            ex, seq, repeats=repeats), measured_us=measured_us)
    measured = hidden_comm_measured_us(seq.vector(), at)
    log("chunked: hidden comm measured %.1fus (wall %.0fs)"
        % (measured, time.time() - t0))
    return measured


def dump_database(path, naive_seq, naive, sims, finals, top, log,
                  predicted=None, degraded=None) -> None:
    """``--dump-csv``: the run's search database (the reference's
    bench/driver.py:2257-2315), one row per measured schedule, naive as row
    0 at full fidelity.  The final batch's results supersede the search-time
    rows of naive and the finalists (``CsvBenchmarker`` answers from the
    first full row, so the verdict is replayable); MCTS rollouts measured at
    the screen floor carry ``fid=screen``.  A screen row the learned screen
    answered from its model (``predicted(order)``) carries ``fid=model``,
    and a row the fallback answered after a device loss (``degraded(order)``)
    ``fid=degraded``: every reader passes over both, so no prediction is
    archived as a measurement."""
    from tenzing_tpu_torch.bench.benchmarker import result_row

    results = [naive] + [s.result for s in sims]
    fids = ["full"] + [s.fidelity for s in sims]
    if finals:
        results[0] = finals[0]
        for r, s in zip(finals[1:], top):
            # identity, not ==: sync ops compare by kind alone
            idx = next(i for i, s2 in enumerate(sims) if s2 is s)
            results[1 + idx] = r
            fids[1 + idx] = "full"
    for i, s in enumerate(sims):
        if predicted is not None and fids[1 + i] == "screen" and predicted(
                s.order):
            fids[1 + i] = "model"
        if degraded is not None and degraded(s.order):
            fids[1 + i] = "degraded"
    orders = [naive_seq] + [s.order for s in sims]
    rows = [result_row(i, r, o, fidelity=None if f == "full" else f)
            for i, (r, o, f) in enumerate(zip(results, orders, fids))]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    log(f"csv: {path} ({len(rows)} rows)")


def learn_train(args, g, nbytes, log, write_telemetry) -> Dict[str, Any]:
    """``--learn-train GLOB... [--learn-trace GLOB...] [--learn-model
    PATH]``: train the surrogate offline on the databases the globs match,
    against the workload's graph and buffer sizes, save it, and return the
    verdict (``metric: learn_train_<workload>``, files, rows, and the
    in-sample Spearman; the reference's bench/driver.py:772-802).  Nothing
    is measured."""
    import glob

    from tenzing_tpu_torch import obs
    from tenzing_tpu_torch.learn import train_from_corpus

    paths = sorted(p for pat in args.learn_train for p in glob.glob(pat))
    with obs.get_tracer().span("learn.train", n_files=len(paths)):
        tpaths = (sorted(p for pat in args.learn_trace
                         for p in glob.glob(pat))
                  if args.learn_trace else None)
        model, info = train_from_corpus(paths, g, nbytes=nbytes,
                                        trace_paths=tpaths, log=log)
        out = {"metric": f"learn_train_{args.workload}", **info}
        if model is not None and args.learn_model:
            model.save(args.learn_model)
            out["model"] = args.learn_model
            log(f"learn model: {args.learn_model} ({info['rows']} rows, "
                f"train spearman {out['train_spearman']})")
    write_telemetry()
    return out


def synth_block(g, sims, seq, verified: bool, measure, log) -> Dict[str, Any]:
    """The ``perf.synth`` block (the reference's bench/driver.py:2165-2256):
    the priced and pruned sketch menus the graph offers, the sketches the
    search visited, how many candidates were synthesized, what the reported
    schedule ``seq`` chose, its estimated comm and the gate's verdict.
    ``measure`` is ``(executor, measured µs, the --profile-winner
    attribution or None, repeats)``, or None after a device loss: where
    ``seq`` chose a decomposition, its comm measured hidden under the other
    work (collectives/synth.py ``synth_hidden_comm_measured_us``) on the
    stepped timeline.  A failure raises (the reference catches it into an
    ``error`` field)."""
    from tenzing_tpu_torch.collectives.synth import (
        synth_hidden_comm_measured_us,
        synth_menus,
        synths_of,
    )

    menus = synth_menus(g)
    chosen = synths_of(seq.vector())
    searched, n_synth = set(), 0
    for sim in sims:
        sm = synths_of(sim.order.vector())
        if sm:
            n_synth += 1
            searched.update(f"{v['sketch']}.c{v['chunks']}" for v in sm.values())
    est = sum(float(menus[b].get("est_us", {}).get(
        f"{v['sketch']}.c{v['chunks']}", 0.0))
        for b, v in chosen.items() if b in menus)
    block: Dict[str, Any] = {
        "menus": {b: {"menu": list(m["menu"]),
                      "est_us": {k: round(float(v), 3)
                                 for k, v in m.get("est_us", {}).items()},
                      "pruned": dict(m.get("pruned", {})),
                      "note": m.get("note", "")}
                  for b, m in sorted(menus.items())},
        "searched_sketches": sorted(searched),
        "n_candidates_synth": n_synth,
        "chosen": {b: f"{v['sketch']}.c{v['chunks']}"
                   for b, v in sorted(chosen.items())},
        "est_comm_us": round(est, 3),
        "measured_hidden_us": None,
        "verified": bool(verified),
    }
    if not menus:
        block["note"] = ("workload offers no synthesized-collective menus "
                         "(--synth-collectives is a no-op for it)")
    elif all(len(m.get("menu", [])) <= 1 for m in menus.values()):
        block["note"] = ("roofline pruned every sketch instantiation: no "
                         "decomposition whose alpha-beta estimate beats the "
                         "fixed engine's one-post floor on this "
                         "workload/hardware (bench/roofline.py::"
                         "prune_sketches)")
    else:
        block["note"] = "; ".join(f"{b}: {m.get('note', '')}"
                                  for b, m in sorted(menus.items()))
    if chosen and measure is not None:
        from tenzing_tpu_torch.obs import attrib

        ex, value_us, profiled, repeats = measure
        t0 = time.time()
        at = profiled
        if at is None:
            at = attrib.analyze(seq.vector(), attrib.stepped_timeline(
                ex, seq, repeats=repeats), measured_us=value_us)
        hidden = synth_hidden_comm_measured_us(seq.vector(), at)
        block["measured_hidden_us"] = round(hidden, 2)
        log("synth: winner uses %s; est comm %.1fus / hidden measured %.1fus "
            "(wall %.0fs)" % (block["chosen"], est, hidden, time.time() - t0))
    else:
        log(f"synth: {len(menus)} menu(s), {n_synth} synthesized "
            "candidate(s) searched, winner fixed-engine")
    return block


def chunked_block(g, sims, seq, log) -> Dict[str, Any]:
    """The ``perf.chunked`` block (the reference's bench/driver.py:2080-2165):
    the chunk menus the graph offers, the counts the search visited, how many
    candidates were chunked and what the reported schedule chose, with the
    roofline's estimate of the hidden comm.  The measured hidden comm is
    filled in by the caller (:func:`chunked_hidden_measured`)."""
    from tenzing_tpu_torch.core.chunking import chunk_menus, chunks_of

    menus = chunk_menus(g)
    chosen = chunks_of(seq.vector())
    searched, n_chunked = set(), 0
    for s in sims:
        cm = chunks_of(s.order.vector())
        if cm:
            n_chunked += 1
            searched.update(cm.values())
    est = sum(float(menus[b].get("est_hidden_us", {}).get(n, 0.0))
              for b, n in chosen.items() if b in menus)
    block: Dict[str, Any] = {
        "menus": {b: {"counts": list(m["counts"]),
                      "est_hidden_us": {str(k): round(float(v), 2)
                                        for k, v in m["est_hidden_us"].items()}}
                  for b, m in sorted(menus.items())},
        "searched_counts": sorted(int(c) for c in searched),
        "n_candidates_chunked": n_chunked,
        "chosen": {b: int(n) for b, n in sorted(chosen.items())},
        "hidden_comm_us": {"estimated": round(est, 2), "measured": None},
    }
    if menus and all(not [c for c in m["counts"] if c > 1]
                     for m in menus.values()):
        block["note"] = ("roofline pruned every chunking: no transfer whose "
                         "hidden-comm bound beats the dispatch+combine cost on "
                         "this workload/hardware (bench/roofline.py::"
                         "prune_chunkings)")
    elif not menus:
        block["note"] = ("workload offers no chunkable-op menus (--chunk is a "
                         "no-op for it)")
    log(f"chunked: {len(menus)} menu(s), {n_chunked} chunked candidate(s) "
        f"searched, winner chose {block['chosen'] or 'no chunking'}")
    return block


def fused_member_check(args, seq):
    """How the fused program is held to its members' own tolerance: for
    attention the state (m, l, acc / l) and O at ``F32_STATE_TOL``, or at
    ``BF16_STATE_TOL`` where ``seq`` also runs a bf16 kernel slot (its
    rounding of p may flip where the fused fold's state differs in the last
    bit); for every other workload each compared buffer at ``REGION_TOL``
    (ops/fused_region.py).  Returns ``check(out_stepped, out_fused, skip) ->
    names that fail``."""
    import torch

    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.ops import fused_region as fr

    if args.workload == "attn":
        bf16 = any(op.name().endswith("_bf16")
                   for op in seq.vector())
        tol = ak.BF16_STATE_TOL if bf16 else ak.F32_STATE_TOL

        def check(out_s, out_f, skip):
            names = ("acc", "m_run", "l_run")
            ok, _ = ak.state_check([out_f[n] for n in names],
                                   [out_s[n] for n in names], tol)
            bad = [] if ok else list(names)
            if not torch.allclose(out_f["O"], out_s["O"], **tol["acc/l"]):
                bad.append("O")
            return bad
        return check

    def check(out_s, out_f, skip):
        return [n for n in sorted((set(out_s) & set(out_f)) - set(skip))
                if out_s[n].shape != out_f[n].shape or not torch.allclose(
                    out_s[n].double(), out_f[n].double(), **fr.REGION_TOL)]
    return check


def fuse_reported(ex, seq, stepped_out, opts, stepped_us: float, tol: float,
                  skip, verifier, log, member_check, profile_repeats: int = 7,
                  cost=None, profiled=None) -> Dict[str, Any]:
    """The ``--fuse-winner`` phase (the reference's bench/driver.py:1961-2078):
    lower ``seq`` into fused regions, measure every tile count of the pruned
    menu with a fresh benchmarker each, run the best fused program beside
    the stepped one from the same initial buffers and re-verify the
    schedule.  Returns the ``perf.fused`` block.

    The fused outputs meet two tests.  The reference's gate, ``allclose``
    at ``tol`` against the stepped program: where it fails, the block says
    so as the reference's does (``verified: false``, ``error``,
    ``diverged``) and the run goes on.  And ``member_check``, the members'
    own tolerance (:func:`fused_member_check`): where it fails, the kernel is
    wrong and this raises.  A region that fails to build or launch raises
    too; nothing is caught into the block.

    The block's ``dispatch_overhead_us`` and ``sum_of_parts_us`` come as
    ``before`` / ``after`` pairs (the reference's :2040-2056): the stepped
    timeline (obs/attrib) of ``seq`` against ``stepped_us`` (``profiled``,
    ``--profile-winner``'s analysis of the same schedule, where there is
    one) and of the fused program, a unit per region, against its
    measured time."""
    from tenzing_tpu_torch.bench.benchmarker import EmpiricalBenchmarker
    from tenzing_tpu_torch.runtime.fused import FusedExecutor, fused_summary

    t0 = time.time()
    compiled0 = ex.compile_count
    menu = FusedExecutor(ex).plan(seq).tile_menu
    by_tiles: Dict[str, float] = {}
    best_t, best_us, best_fex = 1, None, None
    for t in menu:
        # a fresh benchmarker per count: a shared cache keys by canonical
        # schedule and would hand back the stepped measurement
        fex_t = FusedExecutor(ex, tiles=t)
        us = EmpiricalBenchmarker(fex_t).benchmark(seq, opts).pct50 * 1e6
        by_tiles[str(t)] = round(us, 2)
        if best_us is None or us < best_us:
            best_t, best_us, best_fex = t, us, fex_t
    plan = best_fex.plan(seq)
    out_f = best_fex.run(seq)
    out_s = stepped_out if stepped_out is not None else ex.run(seq)
    wrong = member_check(out_s, out_f, skip)
    if wrong:
        raise RuntimeError(f"fuse-winner: the fused program's outputs are "
                           f"outside the members' own tolerance on {wrong[:4]}")
    mismatched = mismatched_outputs(out_s, out_f, tol, skip=skip)
    del out_s, out_f
    re_verdict = verifier(seq)
    from tenzing_tpu_torch.obs import attrib

    at_b = profiled
    if at_b is None:
        at_b = attrib.analyze(seq.vector(), attrib.stepped_timeline(
            ex, seq, repeats=profile_repeats), measured_us=stepped_us,
            cost=cost)
    fseq = best_fex.fused_order(seq)
    at_a = attrib.analyze(fseq.vector(), attrib.stepped_timeline(
        ex, fseq, repeats=profile_repeats), measured_us=best_us, cost=cost)
    block = {
        "regions": len(plan.regions),
        "region_sizes": [r.n_ops for r in plan.regions],
        "fused_ops": plan.n_ops_fused,
        "n_ops_total": plan.n_ops_total,
        "tiles": {"chosen": best_t, "menu": menu,
                  "per_region": [r.tiles for r in plan.regions],
                  "by_tiles_us": by_tiles},
        "measured_us": {"stepped": round(stepped_us, 2),
                        "fused": round(best_us, 2)},
        # the fused orders captured for this block (one per tile count)
        "compiled_programs": ex.compile_count - compiled0,
        "verified": bool(re_verdict.ok and not mismatched),
        "dispatch_overhead_us": {
            "before": round(at_b.dispatch_overhead_us, 3),
            "after": round(at_a.dispatch_overhead_us, 3)},
        "sum_of_parts_us": {"before": round(at_b.sum_of_parts_us, 3),
                            "after": round(at_a.sum_of_parts_us, 3)},
    }
    if mismatched:
        block["error"] = f"fused outputs diverge on {mismatched[:4]}"
        block["diverged"] = mismatched
    if not re_verdict.ok:
        block["verdict"] = re_verdict.witness()
    log("fuse-winner: %s; tiles %s -> best t=%d %.1fus (stepped %.1fus); "
        "dispatch overhead %.1f -> %.1fus; %s (wall %.0fs)" % (
            fused_summary(plan), by_tiles, best_t, best_us, stepped_us,
            block["dispatch_overhead_us"]["before"],
            block["dispatch_overhead_us"]["after"],
            "verified" if block["verified"] else "GATE FAILED",
            time.time() - t0))
    return block


# the reference's help text of the fleet's flags (bench.py there)
FLAG_HELP = {
    "search_workers": dict(metavar="N", help=(
        "distributed search fleet (docs/performance.md, 'Distributed "
        "search'): run the climb jobs across N solver worker processes over "
        "the file control plane, with this process as the single "
        "measurement owner; 1 (with --measure-batch 1) is the serialized "
        "inline path, bit-identical to the legacy climb loop; 0 disables "
        "the fleet entirely")),
    "measure_batch": dict(metavar="K", help=(
        "fuse up to K candidate schedules from distinct workers into one "
        "device measurement round (grouped batch seeds keep each worker's "
        "paired permutation stream intact), with prefetch hints compiling "
        "round i+1 during round i; 0 disables the fleet")),
}


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
            p.add_argument(flag, type=typ, default=default,
                           **FLAG_HELP.get(f.name, {}))
    ns = vars(p.parse_args(argv))
    device = ns.pop("device")
    try:
        result = run(DriverRequest(**ns), device=device)
    except DriverConfigError as e:
        p.error(str(e))
    write_line(result.to_json_line())
    return 0
