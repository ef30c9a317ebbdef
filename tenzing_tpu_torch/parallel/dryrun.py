"""The multi-device models on N ranks: ``python -m
tenzing_tpu_torch.parallel.dryrun [--model M] --nproc N [--device cpu]
[--shared-card]``, M one of ``moe`` (the default), ``halo``,
``spmv_dist``, ``spmv_irregular``, ``ring``, ``pipeline``,
``pipeline_train``, ``tp_mlp``, ``tp_mlp_synth`` and ``modeled``.

The port's counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` (its
``_agree_schedules`` protocol, :23-47), stage by stage.

**MoE** (``--model moe``, the default).  Each rank
builds ``models/moe.py``'s ``MoELayer(impl_choice=True)`` and its block of
``make_moe_buffers``' arrays, then:

1. **agreement** — rank 0 picks up to 3 DFS schedules, at least one with
   every expert MLP on the ``.xla`` slot and one with every MLP on the
   ``.pallas`` kernel, and broadcasts them as JSON; every rank verifies and
   runs each, the ranks gather Y, and Y must be within ``Y_TOL`` of the
   float64 dense routed evaluation (on the card, a ``.pallas`` schedule must
   have launched ``ffn_rows``);
2. **search** — a short MCTS ``explore`` through the control plane: rank 0
   owns the tree, every rank measures every schedule;
3. rank 0 prints one JSON line.

**Halo** (``--model halo``; reference ``__graft_entry__.py:282-330`` and
``_multiprocess_mesh_search``, :144-204).  The ranks form an ``("x", "y",
"z")`` mesh from the prime factors of N (:func:`halo_mesh_shape`), each with
its block of ``make_halo_buffers``' arrays (``make_local_halo_buffers``):

1. **agreement** — up to 3 schedules of ``HaloExchange`` (every post
   ``.xla``), then 3 of the graph with the engine menu (every post ``.xla``,
   every post ``.rdma``, and the two mixed), each verified and run; every
   rank's U must equal its block of the expected array exactly (pure data
   movement);
2. **search on the mesh** — an MCTS ``explore`` (FastMin) over the graph
   with the engine menu through the control plane, every rollout's U exact,
   the engines explored reported;
3. **the ranks' search** — an MCTS ``explore`` of ``HaloExchange`` through
   the control plane (the reference's two-process stage): every rank must
   have measured the same schedules, in the same order, each with U exact.

With ``--shared-card`` (``cuda`` only) the N ranks share GPU 0 over gloo
(parallel/launch.py); a collective post raises there, so only schedules
whose every post is ``.rdma`` run, and the shift kernel carries the faces
along every axis of size > 1 (:func:`halo_shared_main`).

**The other models** (:data:`MODELS`; reference :262-276, :353-462): the
distributed SpMV on the ``("dp", "sp")`` mesh (:func:`sp_mesh_shape`), the
irregular SpMV on the same mesh (its DFS schedules, then one schedule per
exchange of its menu: permute, padded all-to-all, shift), the ring
attention (DFS, then every step on ``.xla`` and every step on ``.pallas``),
the pipeline and its training step on ``("pp",)``, and the TP MLP on
``("tp",)`` and on ``("dp", "tp")``.  Each stage is the agreement above
(:func:`agree_model`), its output held to the reference dryrun's tolerance.
``tp_mlp_synth`` (reference :466-505; two or more ranks) is the TP MLP
with its all-reduces offered as synthesized ring, reverse-ring and
recursive halving/doubling decompositions (collectives/synth.py): the
agreement, then a mesh MCTS of 5 iterations (FastMin, seed 1) through the
control plane whose every rollout's Y must be within the same tolerance,
and which must visit at least two sketch labels (``fixed`` counts as one;
:func:`synth_explore`).
``--shared-card`` runs the irregular SpMV with only its ``exchange.rdma``
schedules, every distance's shift between ranks on GPU 0, and times each
distance's shift (:func:`model_shared_main`).

**Modeled** (``--model modeled``; reference :318-351): the one-lane naive
order against a short MCTS on two lanes, both scored by the analytic model
(bench/model.py), on the halo graph and the MoE layer; the searched must
beat the naive (no ranks, no device).

It runs on ``cuda`` over NCCL (rank r on GPU r; more ranks than visible
GPUs are refused) unless ``--device cpu`` is given, which runs over gloo.
``--nproc 1`` runs in this process; more start one process per rank
(parallel/launch.py).  The width is the reference dryrun's on the CPU
(``DRYRUN_ARGS``, ``HALO_DRYRUN_ARGS``, :func:`model_cases`) and the full one
on the card (``FULL_ARGS``, ``HALO_FULL_ARGS``, :func:`full_cases`), which
``chip_smoke.py`` drives too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tenzing_tpu_torch.core.operation import DeviceOp
from tenzing_tpu_torch.models.moe import MoEArgs, MoELayer, make_moe_buffers
from tenzing_tpu_torch.utils.cli import write_line
from tenzing_tpu_torch.utils.numeric import round_bf16

# the reference dryrun's MoE width (__graft_entry__.py: tokens_per_shard=8,
# d_model=8, d_ff=16, n_chunks=2): the CPU's
DRYRUN_ARGS = dict(tokens_per_shard=8, d_model=8, d_ff=16, n_chunks=2)
# the width of the repo's MoE model (MoEPipeArgs: d_model 512, d_ff 2048,
# 8192 tokens, 4 chunks), per rank: the card's, where the .pallas slot's
# ffn_rows kernel is instantiated for d_model 512
FULL_ARGS = dict(tokens_per_shard=8192, d_model=512, d_ff=2048, n_chunks=4)
# Y against the float64 dense evaluation: the reference's MoE tolerance
# (tests/test_moe.py)
Y_TOL = dict(rtol=2e-4, atol=2e-5)
# a bf16 layer's Y against the float64 dense evaluation cast to bf16 (the
# reference: "~0.4% relative at bf16", tenzing_tpu/models/moe.py:511-513).
# bf16 keeps 8 significant bits, a unit roundoff u = 2^-9 = 1.95e-3; Y
# carries four roundings the dense evaluation does not (h, the expert
# output, the gate product, and the expected value's own cast), so its
# relative rms error is about 2u (0.35-0.48% measured on the CPU at the
# dryrun's and the kernel's widths).  The limits: a relative rms of 1e-2
# (5u) and a largest error of 3e-2, two bf16 ulps at |Y| up to 4.  Dropping
# one expert's output moves the relative rms to about 0.4.
Y_TOL_BF16 = {"rel_rms": 1e-2, "max_abs": 3e-2}


def y_error(y, want) -> Dict[str, float]:
    """Relative rms and largest absolute error of ``y`` against ``want``,
    in float32."""
    d = (y.float() - want.float())
    return {"rel_rms": float(d.pow(2).mean().sqrt()
                             / want.float().pow(2).mean().sqrt()),
            "max_abs": float(d.abs().max())}


def y_within(y, want, dtype: str) -> bool:
    """Whether ``y`` is within the layer's tolerance of ``want``: ``Y_TOL``
    elementwise in float32, ``Y_TOL_BF16`` in bf16."""
    import torch

    if dtype == "bfloat16":
        err = y_error(y, want)
        return (err["rel_rms"] <= Y_TOL_BF16["rel_rms"]
                and err["max_abs"] <= Y_TOL_BF16["max_abs"])
    return bool(torch.allclose(y, want, **Y_TOL))


def layer_graph(args: MoEArgs, **kw):
    """Start -> MoELayer(args, **kw) -> Finish."""
    from tenzing_tpu_torch.core.graph import Graph

    g = Graph()
    layer = MoELayer(args, **kw)
    g.start_then(layer)
    g.then_finish(layer)
    return g


def ffn_slots(order) -> List[str]:
    """The expert-MLP slot of each chunk the schedule runs, in order:
    ``.pallas`` or ``.xla`` (a chunked ``.xla`` partial counts once per
    chunk)."""
    slots: Dict[str, str] = {}
    for op in order:
        name = op.name()
        if name.startswith("ffn_"):
            chunk = name.split(".")[0]
            slots.setdefault(chunk, ".pallas" if ".pallas" in name else ".xla")
    return [slots[k] for k in sorted(slots)]


def pick_schedules(graph, platform, n_sched: int = 3):
    """Up to ``n_sched`` DFS schedules of ``graph``: the first with every
    expert MLP on ``.xla``, the first with every one on ``.pallas``, then
    the first mixed one, then the rest in enumeration order."""
    from tenzing_tpu_torch.solve.dfs import enumerate_schedules, structural_variants

    states = enumerate_schedules(graph, platform,
                                 max_seqs=len(structural_variants(graph)),
                                 log=lambda msg: None)
    orders = [st.sequence for st in states]

    def kind(order) -> str:
        s = set(ffn_slots(order))
        return s.pop() if len(s) == 1 else "mixed"

    picked = []
    for want in (".xla", ".pallas", "mixed"):
        hit = next((o for o in orders if kind(o) == want and o not in picked),
                   None)
        if hit is not None:
            picked.append(hit)
    picked += [o for o in orders if o not in picked]
    return picked[:n_sched]


@dataclass
class Layer:
    """One rank's MoE layer: its graph, platform, executor and expected Y."""

    args: MoEArgs
    mesh: Any
    graph: Any
    platform: Any
    executor: Any
    specs: Dict[str, Optional[str]]
    want: Any  # the global expected Y, a tensor on the executor's device


def build_layer(mesh, device, args: MoEArgs, seed: int = 0,
                **graph_kw) -> Layer:
    """This rank's executor on 2 lanes over its block of
    ``make_moe_buffers(args, seed)``, and the layer's graph (``graph_kw``:
    ``MoELayer`` options; with ``synth`` the buffers carry the ring
    all-to-alls' staging)."""
    import torch

    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.parallel.mesh import shard_buffers
    from tenzing_tpu_torch.runtime.executor import StreamExecutor

    bufs, specs, want = make_moe_buffers(args, seed=seed,
                                         synth=graph_kw.get("synth", False))
    # W1 / W2 come out float64 under NumPy 2's promotion (float32 array /
    # numpy float64 scalar), as the reference's do; JAX places them as
    # float32 (x64 off), and so does the port.  A bf16 layer places every
    # float buffer as bf16 (the reference's arrays for it are bf16, its
    # W1 / W2 cast to bf16 likewise)
    bf16 = args.dtype == "bfloat16"
    dt = np.dtype(np.float32 if bf16 else args.dtype)
    bufs = {k: (round_bf16(v) if bf16 else v.astype(dt))
            if v.dtype.kind == "f" else v for k, v in bufs.items()}
    local = shard_buffers(bufs, specs, mesh, device)
    want_t = torch.from_numpy(want).to(device)
    if bf16:
        local = {k: t.to(torch.bfloat16) if t.is_floating_point() else t
                 for k, t in local.items()}
        want_t = want_t.to(torch.bfloat16)
    plat = Platform.make_n_lanes(2, mesh=mesh, specs=specs)
    # a mesh schedule runs without CUDA graphs: its collectives and the mesh
    # shift wait from the host (runtime/executor.py CaptureContext)
    ex = StreamExecutor(plat, local, device=torch.device(device).type,
                        graphs=False)
    return Layer(args=args, mesh=mesh, graph=layer_graph(args, **graph_kw),
                 platform=plat, executor=ex, specs=specs, want=want_t)


def run_gathered(layer: Layer, order):
    """Run ``order`` once from the initial buffers on every rank; the global
    Y gathered from the ranks (a collective)."""
    from tenzing_tpu_torch.parallel.mesh import gather_buffer

    out = layer.executor.run(order)
    return gather_buffer("Y", out["Y"], layer.specs, layer.mesh)


def agree_schedules(layer: Layer, cp):
    """The reference's ``_agree_schedules`` on the mesh: rank 0 picks 3
    schedules (:func:`pick_schedules`) and broadcasts them; every rank
    verifies and runs each; the gathered Y must be within ``Y_TOL`` of the
    expected, on every schedule.  Returns (one row per schedule, the
    schedules); raises on a disagreement, an unsound schedule, a missing
    slot, or (on the card) a ``.pallas`` schedule that never launched
    ``ffn_rows``."""
    import torch

    from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
    from tenzing_tpu_torch.ops import ffn_kernels as fk
    from tenzing_tpu_torch.verify import ScheduleVerifier

    picked = (pick_schedules(layer.graph, layer.platform)
              if cp.rank() == 0 else [])
    jsons = cp.bcast_json([sequence_to_json(o) for o in picked]
                          if cp.rank() == 0 else None)
    verifier = ScheduleVerifier(layer.graph)
    rows, bad = [], []
    orders = [sequence_from_json(js, layer.graph) for js in jsons]
    for i, order in enumerate(orders):
        verdict = verifier(order)
        if not verdict.ok:
            raise AssertionError(f"schedule {i} is unsound: {verdict.witness()}")
        before = fk.LAUNCHES["ffn_rows"]
        y = run_gathered(layer, order)
        launches = fk.LAUNCHES["ffn_rows"] - before
        ok = y_within(y, layer.want, layer.args.dtype)
        slots = ffn_slots(order)
        err = y_error(y, layer.want)
        row = {"schedule": i, "ops": len(order), "ffn_slots": slots,
               "dtype": layer.args.dtype, "y_max_abs_err": err["max_abs"],
               "y_rel_rms_err": err["rel_rms"],
               "within_tol": ok, "ffn_rows_launches": launches}
        rows.append(row)
        if not ok:
            bad.append(i)
        if (layer.executor.device.type == "cuda" and ".pallas" in slots
                and launches <= 0):
            raise AssertionError(f"schedule {i} has a .pallas slot but "
                                 "never launched ffn_rows")
    have = {s for r in rows for s in r["ffn_slots"]}
    if not {".xla", ".pallas"} <= have:
        raise AssertionError(f"the schedules cover slots {sorted(have)}; "
                             "both .xla and .pallas are needed")
    if bad:
        tol = Y_TOL_BF16 if layer.args.dtype == "bfloat16" else Y_TOL
        raise AssertionError(f"Y of schedules {bad} is not within {tol} of "
                             f"the expected: {rows}")
    return rows, orders


def explore_layer(layer: Layer, cp, iters: int) -> dict:
    """A short MCTS search over the layer through the control plane; the
    rollouts measured and the winner (its FFN slots and pct50)."""
    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore
    from tenzing_tpu_torch.verify import ScheduleVerifier

    bench = EmpiricalBenchmarker(layer.executor, control_plane=cp)
    opts = MctsOpts(n_iters=iters,
                    bench_opts=BenchOpts(n_iters=3, target_secs=0.01),
                    verify=ScheduleVerifier(layer.graph))
    res = explore(layer.graph, layer.platform, bench, opts, control_plane=cp)
    best = res.best()
    return {"rollouts": len(res.sims), "tree_size": res.tree_size,
            "winner_ffn_slots": ffn_slots(best.order) if best else None,
            "winner_pct50_s": best.result.pct50 if best else None,
            "pct50_s": [s.result.pct50 for s in res.sims]}


def run_schedules(mesh, device, args: Dict[str, Any], schedules: List[list],
                  seed: int = 0, **graph_kw) -> Optional[List[np.ndarray]]:
    """Launch task: run each schedule JSON once on the mesh, from the
    initial buffers; rank 0 returns the gathered Y of each (numpy; a bf16 Y
    as the float32 array of its values), the others None."""
    from tenzing_tpu_torch.core.serdes import sequence_from_json

    layer = build_layer(mesh, device, MoEArgs(**args), seed=seed, **graph_kw)
    out = [run_gathered(layer, sequence_from_json(js, layer.graph)).cpu()
           .float().numpy() for js in schedules]
    return out if mesh.index("ep") == 0 else None


def search_ranks(mesh, device, args: Dict[str, Any], mcts_iters: int,
                 dfs_max_seqs: int) -> dict:
    """Launch task: an MCTS ``explore`` and a DFS ``explore`` of the layer
    through the control plane; on every rank, the schedules it measured (as
    JSON text) and their pct50s, so the caller can hold the ranks to the
    same ones."""
    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
    from tenzing_tpu_torch.core.serdes import sequence_to_json_str
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import control_group
    from tenzing_tpu_torch.solve import dfs
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore

    cp = DistControlPlane(control_group())
    layer = build_layer(mesh, device, MoEArgs(**args), impl_choice=True)
    bench = EmpiricalBenchmarker(layer.executor, control_plane=cp)
    bopts = BenchOpts(n_iters=3, target_secs=0.002)
    m = explore(layer.graph, layer.platform, bench,
                MctsOpts(n_iters=mcts_iters, bench_opts=bopts),
                control_plane=cp)
    d = dfs.explore(layer.graph, layer.platform, bench,
                    dfs.DfsOpts(max_seqs=dfs_max_seqs, bench_opts=bopts),
                    control_plane=cp)
    return {"rank": cp.rank(),
            "mcts": [(sequence_to_json_str(s.order), s.result.pct50)
                     for s in m.sims],
            "dfs": [(sequence_to_json_str(s.order), s.result.pct50)
                    for s in d.sims]}


def rank_main(mesh, device, args: Dict[str, Any],
              mcts_iters: int) -> Optional[dict]:
    """One rank of the dryrun (the launch task): agreement, then the search;
    rank 0 returns the summary, the others None."""
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import control_group

    margs = MoEArgs(**args)
    cp = DistControlPlane(control_group())
    layer = build_layer(mesh, device, margs, impl_choice=True)
    rows, _ = agree_schedules(layer, cp)
    search = explore_layer(layer, cp, mcts_iters)
    if cp.rank() != 0:
        return None
    import torch.distributed as dist

    return {"dryrun": "moe", "n_ep": margs.n_ep, "args": asdict(margs),
            "device": str(device), "backend": dist.get_backend(),
            "schedules": rows, "explore": search}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=("moe", "halo") + MODELS
                   + MULTI_RANK_MODELS + ("modeled",), default="moe")
    p.add_argument("--nproc", type=int, default=1)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--mcts-iters", type=int, default=8)
    p.add_argument("--shared-card", action="store_true",
                   help="halo, spmv_irregular: all ranks on GPU 0, joined "
                        "over gloo")
    a = p.parse_args(argv)
    if a.shared_card and (a.model not in ("halo", "spmv_irregular")
                          or a.device != "cuda"):
        p.error("--shared-card runs the halo or the irregular SpMV on cuda")
    if a.model == "halo":
        summary = halo_main(a.nproc, a.device, a.mcts_iters, a.shared_card)
    elif a.model == "modeled":
        summary = modeled_main(a.nproc)
    elif a.model in MODELS + MULTI_RANK_MODELS:
        summary = models_main(a.model, a.nproc, a.device, a.shared_card)
    else:
        width = DRYRUN_ARGS if a.device == "cpu" else FULL_ARGS
        kwargs = {"args": dict(n_ep=a.nproc, **width),
                  "mcts_iters": a.mcts_iters}
        if a.nproc == 1:
            summary = world_one(a.device, kwargs)
        else:
            from tenzing_tpu_torch.parallel.launch import launch

            summary = launch("tenzing_tpu_torch.parallel.dryrun:rank_main",
                             a.nproc, a.device, kwargs, timeout_s=600.0)[0]
    write_line(json.dumps(summary))
    return 0


def world_one(device: str, kwargs: Dict[str, Any],
              fn=None, axes=("ep",)) -> Any:
    """World size 1 in this process: NCCL on GPU 0, or gloo on the CPU;
    runs ``fn(mesh, device, **kwargs)`` (default: the MoE ``rank_main``)
    on a mesh of ``axes``, each of size 1."""
    import torch

    from tenzing_tpu_torch.parallel.mesh import close_mesh, init_mesh
    from tenzing_tpu_torch.runtime.executor import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="tz_dryrun_") as d:
        mesh = init_mesh(tuple(axes), "nccl" if dev.type == "cuda" else "gloo",
                         "file://" + os.path.join(d, "rendezvous"), 0, 1,
                         shape=(1,) * len(axes))
        try:
            return (fn or rank_main)(mesh, dev, **kwargs)
        finally:
            close_mesh()


# -- the halo exchange on a mesh ----------------------------------------------

# the reference dryrun's halo width (__graft_entry__.py:288): the CPU's
HALO_DRYRUN_ARGS = dict(nq=2, lx=4, ly=4, lz=4, radius=1)
# the repo's halo configuration per rank (reference halo_run_strategy.hpp:
# 42-49; PERF.md section 4): the card's
HALO_FULL_ARGS = dict(nq=3, lx=512, ly=512, lz=512, radius=3)
HALO_AXES = ("x", "y", "z")


def halo_mesh_shape(nproc: int) -> Tuple[int, int, int]:
    """The device grid from the prime factors of ``nproc``, dealt round the
    three axes (reference halo_run_strategy.hpp:80-98,
    ``__graft_entry__.py:282-287``)."""
    from tenzing_tpu_torch.utils.numeric import prime_factors

    grid = [1, 1, 1]
    for i, f in enumerate(prime_factors(nproc)):
        grid[i % 3] *= f
    return tuple(grid)


@dataclass
class HaloMesh:
    """One rank's halo exchange: its platform, executor and expected U."""

    args: Any
    mesh: Any
    platform: Any
    executor: Any
    want: Any  # this rank's block of the expected U, on the device


def build_halo(mesh, device, args, seed: int = 0, lanes: int = 2,
               extra: Optional[Dict[str, np.ndarray]] = None,
               synth: bool = False) -> HaloMesh:
    """This rank's executor on ``lanes`` lanes over its block of
    ``make_halo_buffers(mesh shape, args, seed)`` (plus ``extra`` buffers;
    with ``synth`` the synthesized shifts' staging)."""
    import torch

    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.halo import HALO_SPEC, make_local_halo_buffers
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

    bufs, want = make_local_halo_buffers(mesh.shape, mesh.coords, args, seed,
                                         synth=synth)
    bufs.update(extra or {})
    local = buffers_from_numpy(bufs, device)
    del bufs
    plat = Platform.make_n_lanes(lanes, mesh=mesh,
                                 specs={k: HALO_SPEC for k in local})
    ex = StreamExecutor(plat, local, device=torch.device(device).type,
                        graphs=False)
    return HaloMesh(args=args, mesh=mesh, platform=plat, executor=ex,
                    want=torch.from_numpy(want).to(device))


def halo_graph(args, xfer_choice: bool = False, synth: bool = False):
    """Start -> the halo exchange -> Finish: the ``HaloExchange`` compound,
    or with ``xfer_choice`` the chains with the engine menu (the
    reference's ``add_to_graph(Graph(), args, xfer_choice=True)``), with
    ``synth`` the engine menu and every synthesized shift (``synth_relax``:
    none pruned)."""
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.models.halo import HaloExchange, add_to_graph

    if synth:
        return add_to_graph(Graph(), args, synth=True, synth_relax=True)
    if xfer_choice:
        return add_to_graph(Graph(), args, xfer_choice=True)
    g = Graph()
    comp = HaloExchange(args)
    g.start_then(comp)
    g.then_finish(comp)
    return g


def engines(order) -> List[str]:
    """The engine of each exchange post the schedule runs, by direction."""
    return [op.name().split(".")[-1] for op in order
            if op.name().startswith("exchange_")]


def engine_order(graph, platform, pick):
    """The first decision at every step, except that each exchange choice
    takes the alternative ending in ``pick(choice name)``."""
    from tenzing_tpu_torch.core.state import ChooseOp, State

    st = State(graph)
    while not st.is_terminal():
        ds = st.get_decisions(platform)
        chosen = ds[0]
        for dcs in ds:
            if isinstance(dcs, ChooseOp) and dcs.choice.name().endswith(
                    pick(dcs.op.name())):
                chosen = dcs
                break
        st = st.apply(chosen)
    return st.sequence


def engine_orders(graph, platform) -> Dict[str, Any]:
    """Schedules of the graph with the engine menu: every post ``.xla``,
    every post ``.rdma``, and mixed (the x faces on ``.rdma``, the rest on
    ``.xla``)."""
    return {
        "xla": engine_order(graph, platform, lambda n: ".xla"),
        "rdma": engine_order(graph, platform, lambda n: ".rdma"),
        "mixed": engine_order(graph, platform,
                              lambda n: ".rdma" if n.endswith("x") else ".xla"),
    }


def u_exact(h: HaloMesh, u, cp) -> bool:
    """Whether every rank's U equals its block of the expected array bit for
    bit (a collective over the control plane)."""
    import torch

    bad = 0 if torch.equal(u, h.want) else 1
    return cp.agree_fault(bad) == 0


def run_checked(h: HaloMesh, order, cp, label: str) -> dict:
    """Run ``order`` once from the initial buffers and hold U to the
    expected exactly; the row for it, with the shift and copy kernels it
    launched on this rank."""
    from tenzing_tpu_torch.ops import rdma

    before = dict(rdma.LAUNCHES)
    out = h.executor.run(order)
    exact = u_exact(h, out["U"], cp)
    launched = {k: rdma.LAUNCHES[k] - before[k] for k in rdma.LAUNCHES}
    del out
    return {"schedule": label, "ops": len(order), "engines": engines(order),
            "u_exact": exact, "launches": launched}


def agree_halo(h: HaloMesh, cp, shared_card: bool = False) -> List[dict]:
    """The agreement stage: up to 3 schedules of ``HaloExchange`` (all
    ``.xla``; none on a shared card, where ``.xla`` raises) and the engine
    menu's all-``.xla``, all-``.rdma`` and mixed orders (only all-``.rdma``
    on a shared card), each verified, run and held to the expected U;
    raises on an unsound schedule or a U that differs."""
    from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
    from tenzing_tpu_torch.solve.dfs import get_all_sequences
    from tenzing_tpu_torch.verify import ScheduleVerifier

    rows = []
    plans = []
    if not shared_card:
        g = halo_graph(h.args)
        picked = ([st.sequence for st in get_all_sequences(g, h.platform, 3)]
                  if cp.rank() == 0 else [])
        plans.append(("halo_exchange", g, picked))
    mg = halo_graph(h.args, xfer_choice=True)
    menu = engine_orders(mg, h.platform) if cp.rank() == 0 else {}
    keep = ("rdma",) if shared_card else ("xla", "rdma", "mixed")
    plans.append(("engine_menu", mg, [menu[k] for k in keep]
                  if cp.rank() == 0 else []))
    for label, g, picked in plans:
        jsons = cp.bcast_json([sequence_to_json(o) for o in picked])
        verifier = ScheduleVerifier(g)
        for i, js in enumerate(jsons):
            order = sequence_from_json(js, g)
            verdict = verifier(order)
            if not verdict.ok:
                raise AssertionError(f"{label} schedule {i} is unsound: "
                                     f"{verdict.witness()}")
            row = run_checked(h, order, cp, f"{label}/{i}")
            row["verified"] = True
            rows.append(row)
            if not row["u_exact"]:
                raise AssertionError(f"{label} schedule {i}: U differs from "
                                     f"the expected: {row}")
    return rows


def explore_halo(h: HaloMesh, cp, iters: int, xfer_choice: bool = True
                 ) -> dict:
    """An MCTS ``explore`` (FastMin) of the halo graph through the control
    plane; every rollout's U held to the expected exactly, and every rank
    must have measured the same schedules in the same order."""
    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
    from tenzing_tpu_torch.core.serdes import sequence_to_json_str
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore
    from tenzing_tpu_torch.solve.mcts.strategies import FastMin

    g = halo_graph(h.args, xfer_choice=xfer_choice)
    bench = EmpiricalBenchmarker(h.executor, control_plane=cp)
    res = explore(g, h.platform, bench,
                  MctsOpts(n_iters=iters, seed=0,
                           bench_opts=BenchOpts(n_iters=2, target_secs=1e-4)),
                  strategy=FastMin, control_plane=cp)
    seen = set()
    for s in res.sims:
        seen.add("rdma" if "rdma" in engines(s.order) else "xla")
        out = h.executor.run(s.order)
        if not u_exact(h, out["U"], cp):
            raise AssertionError("a rollout's U differs from the expected")
        del out
    fp = "&".join(sequence_to_json_str(s.order) for s in res.sims)
    if cp.agree_fault(int(cp.bcast_json(fp) != fp)):
        raise AssertionError("the ranks measured different schedules")
    return {"rollouts": len(res.sims), "tree_size": res.tree_size,
            "engines_explored": sorted(seen),
            "pct50_s": [s.result.pct50 for s in res.sims],
            "ranks_agree": True}


def halo_rank_main(mesh, device, args: Dict[str, Any], mcts_iters: int,
                   seed: int = 0) -> Optional[dict]:
    """One rank of the halo dryrun (the launch task): agreement, the search
    on the mesh with the engine menu, the ranks' search; rank 0 returns the
    summary, the others None."""
    import torch.distributed as dist

    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import control_group

    cp = DistControlPlane(control_group())
    h = build_halo(mesh, device, HaloArgs(**args), seed=seed)
    rows = agree_halo(h, cp)
    menu = explore_halo(h, cp, mcts_iters, xfer_choice=True)
    ranks = explore_halo(h, cp, 3, xfer_choice=False)
    if cp.rank() != 0:
        return None
    return {"dryrun": "halo", "mesh": list(mesh.shape), "args": args,
            "device": str(device), "backend": dist.get_backend(),
            "schedules": rows, "explore_menu": menu, "explore_ranks": ranks}


def halo_schedules(mesh, device, args: Dict[str, Any], schedules: List[list],
                   seed: int = 0, xfer_choice: bool = False,
                   fail_rank: Optional[int] = None,
                   synth: bool = False) -> Optional[list]:
    """Launch task: run each schedule JSON of the halo graph once on the
    mesh, from the initial buffers; rank 0 returns the gathered U of each
    (numpy), the others None.  ``fail_rank`` runs only the first schedule's
    ops before its first await on that rank, which then raises with its
    transfers in flight while the others wait in the exchange."""
    from tenzing_tpu_torch.core.serdes import sequence_from_json
    from tenzing_tpu_torch.models.halo import HALO_SPEC, HaloArgs
    from tenzing_tpu_torch.parallel.mesh import coords_of, gather_buffer

    h = build_halo(mesh, device, HaloArgs(**args), seed=seed, synth=synth)
    g = halo_graph(h.args, xfer_choice=xfer_choice, synth=synth)
    if fail_rank is not None and mesh.coords == coords_of(fail_rank,
                                                          mesh.shape):
        order = sequence_from_json(schedules[0], g)
        ops = order.vector()
        first = next(i for i, op in enumerate(ops)
                     if op.name().startswith("await_"))
        h.executor.precompile(order)
        h.executor._run_ops(ops[:first], dict(h.executor.init_bufs))
    out = []
    for js in schedules:
        u = h.executor.run(sequence_from_json(js, g))["U"]
        out.append(gather_buffer("U", u, {"U": HALO_SPEC}, mesh)
                   .cpu().numpy())
    return out if mesh.coords == (0,) * len(mesh.coords) else None


def comm_cases(mesh, device, cases: List[Dict[str, Any]]) -> List[np.ndarray]:
    """Launch task: for each case, post one transfer of this rank's block of
    the global ``x`` (split by ``spec``) over mesh axis ``axis`` and await
    it, through the stream executor: ``kind`` is ``"permute"``
    (``PermuteStart``), ``"rdma"`` (``RdmaShiftStart``), ``"psum"``
    (``PsumStart``) or ``"a2a"`` (``AllToAllStart``), with ``shift``
    (default 1) and ``split_axis`` (default 1); returns the gathered
    destinations (numpy) on every rank."""
    import torch

    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.ops.comm_ops import (
        AllToAllStart,
        AwaitTransfer,
        PermuteStart,
        PsumStart,
    )
    from tenzing_tpu_torch.ops.rdma import RdmaShiftStart
    from tenzing_tpu_torch.parallel.mesh import gather_buffer, shard_buffers
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.solve.local import first_decision_order

    out = []
    for i, c in enumerate(cases):
        axis, shift, spec = c["axis"], c.get("shift", 1), tuple(c["spec"])
        post = {"permute": lambda: PermuteStart("post", "src", "dst", axis,
                                                shift),
                "rdma": lambda: RdmaShiftStart("post", "src", "dst", axis,
                                               shift, i % 16),
                "psum": lambda: PsumStart("post", "src", "dst", axis),
                "a2a": lambda: AllToAllStart("post", "src", "dst", axis,
                                             c.get("split_axis", 1)),
                }[c["kind"]]()
        g = Graph()
        g.start_then(post)
        wait = AwaitTransfer("await", "dst")
        g.then(post, wait)
        g.then_finish(wait)
        specs = {"src": spec, "dst": spec}
        local = shard_buffers({"src": c["x"], "dst": np.zeros_like(c["x"])},
                              specs, mesh, device)
        plat = Platform.make_n_lanes(1, mesh=mesh, specs=specs)
        ex = StreamExecutor(plat, local, device=torch.device(device).type,
                            graphs=False)
        got = ex.run(first_decision_order(g, plat))["dst"]
        if c["kind"] == "psum":
            # the sum is replicated along the axis: gather the other axes
            specs = {"dst": tuple(None if a == axis else a for a in spec)}
        out.append(gather_buffer("dst", got, specs, mesh).cpu().numpy())
    return out


# -- the shift kernel between ranks that share one card -------------------------

# cycles a Delay op sleeps on its lane before an unpack (~2 ms on an H100):
# it holds the unpack back long enough that a neighbour's next post would
# land in the receive buffer first if nothing ordered it after the unpack
WAR_DELAY_CYCLES = 4_000_000


class BumpInterior(DeviceOp):
    """Add 1 to every interior cell of U: each run of the probe starts from
    a changed interior."""

    def __init__(self, args):
        super().__init__("bump_interior")
        self._args = args

    def reads(self):
        return ["U"]

    def writes(self):
        return ["U"]

    def apply(self, bufs, ctx):
        r, a = self._args.radius, self._args
        bufs["U"][:, r:r + a.lx, r:r + a.ly, r:r + a.lz].add_(1.0)


class Delay(DeviceOp):
    """Sleep ``cycles`` on the lane (nothing on the CPU)."""

    def __init__(self, name: str, cycles: int):
        super().__init__(name)
        self._cycles = cycles

    def reads(self):
        return []

    def writes(self):
        return []

    def apply(self, bufs, ctx):
        if ctx.on_cuda:
            import torch

            torch.cuda._sleep(self._cycles)


class AccumulateU(DeviceOp):
    """ACC += U: every run's U, ghosts included, leaves its trace."""

    def __init__(self):
        super().__init__("accumulate_u")

    def reads(self):
        return ["U", "ACC"]

    def writes(self):
        return ["ACC"]

    def apply(self, bufs, ctx):
        bufs["ACC"].add_(bufs["U"])


def war_graph(args, delay_cycles: int = WAR_DELAY_CYCLES):
    """The write-after-read probe: bump the interior, exchange every face
    with the ``.rdma`` engine, sleep on the lane before each unpack, then
    accumulate U.  Run back to back, a neighbour's next post that landed in
    a receive buffer before this rank's delayed unpack read it would put the
    next run's face into this run's U, and ACC would show it."""
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.models.halo import (
        DIRECTIONS,
        Pack,
        Unpack,
        dir_name,
        exchange_post,
    )
    from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer

    g = Graph()
    bump, acc = BumpInterior(args), AccumulateU()
    g.start_then(bump)
    for d in DIRECTIONS:
        name = dir_name(d)
        chain = [Pack(args, d), exchange_post(d, "rdma"),
                 AwaitTransfer(f"await_{name}", f"recv_{name}"),
                 Delay(f"delay_{name}", delay_cycles), Unpack(args, d)]
        g.then(bump, chain[0])
        for a, b in zip(chain, chain[1:]):
            g.then(a, b)
        g.then(chain[-1], acc)
    g.then_finish(acc)
    return g


def war_expected(mesh_shape, coords, args, seed: int, runs: int) -> np.ndarray:
    """ACC after ``runs`` back-to-back runs of :func:`war_graph` on rank
    ``coords``, from ACC = 0: the same float32 additions on the host, with
    every rank's interior bumped once per run."""
    from tenzing_tpu_torch.models.halo import (
        DIRECTIONS,
        _face_slices,
        _halo_global,
        _local_grid,
    )

    G = _halo_global(mesh_shape, args, seed)
    coords = tuple(coords)
    srcs = {d: tuple((c - v) % n for c, v, n in zip(coords, d, mesh_shape))
            for d in DIRECTIONS}
    grids = {q: _local_grid(G, args, q) for q in {coords, *srcs.values()}}
    del G
    r, one = args.radius, np.float32(1.0)
    u = grids[coords]
    acc = np.zeros_like(u)
    for _ in range(runs):
        for grid in grids.values():
            grid[:, r:r + args.lx, r:r + args.ly, r:r + args.lz] += one
        for d in DIRECTIONS:
            ps, sz = _face_slices(args, d, "pack")
            us, _ = _face_slices(args, d, "unpack")
            u[:, us[1]:us[1] + sz[1], us[2]:us[2] + sz[2],
              us[3]:us[3] + sz[3]] = grids[srcs[d]][
                :, ps[1]:ps[1] + sz[1], ps[2]:ps[2] + sz[2],
                ps[3]:ps[3] + sz[3]]
        acc += u
    return acc


def war_check(mesh, device, args, cp, seed: int = 0, runs: int = 3,
              delay_cycles: int = WAR_DELAY_CYCLES) -> dict:
    """Run :func:`war_graph` ``runs`` times back to back (one fence at the
    end) on one lane; every rank's ACC must equal :func:`war_expected`
    exactly."""
    import torch

    from tenzing_tpu_torch.solve.local import first_decision_order
    from tenzing_tpu_torch.verify import ScheduleVerifier

    acc0 = np.zeros(args.local_shape(), dtype=np.float32)
    h = build_halo(mesh, device, args, seed=seed, lanes=1,
                   extra={"ACC": acc0})
    g = war_graph(args, delay_cycles)
    order = first_decision_order(g, h.platform)
    verdict = ScheduleVerifier(g)(order)
    if not verdict.ok:
        raise AssertionError(f"the probe schedule is unsound: "
                             f"{verdict.witness()}")
    h.executor.prepare_n(order)(runs)
    want = torch.from_numpy(war_expected(mesh.shape, mesh.coords, args, seed,
                                         runs)).to(device)
    got = h.executor.init_bufs["ACC"]
    exact = cp.agree_fault(0 if torch.equal(got, want) else 1) == 0
    err = float((got - want).abs().max())
    del h, want, got
    return {"runs": runs, "delay_cycles": delay_cycles, "acc_exact": exact,
            "acc_max_abs_err": err}


def _time_post_wait(peers, x, peer_y, stream, handoff: str, reps: int,
                    shift: int, cid: int, times: Dict[str, list]) -> None:
    """``reps`` posts and waits of the shift by ``shift`` on collective id
    ``cid`` with the hand-off ``handoff``, each timed with CUDA events on
    ``stream``; the milliseconds of the post, the wait and both go into
    ``times``' lists ``post``, ``wait`` and ``both``."""
    import torch

    from tenzing_tpu_torch.ops import rdma

    def ev():
        return torch.cuda.Event(enable_timing=True)

    for _ in range(reps):
        e = peers.next_epoch(cid)
        t0, t1, t2 = ev(), ev(), ev()
        with torch.cuda.stream(stream):
            t0.record(stream)
            rdma.rdma_shift_post(x, peer_y, peers.flags,
                                 peers.flag_block(shift),
                                 peers.flag_block(-shift), cid, e, peers.err,
                                 handoff)
            t1.record(stream)
            rdma.rdma_shift_wait(peers.flags, cid, e, peers.err, handoff)
            t2.record(stream)
        rdma.await_shift(t2, peers.flags, cid, e, peers.err)
        times["post"].append(t0.elapsed_time(t1))
        times["wait"].append(t1.elapsed_time(t2))
        times["both"].append(t0.elapsed_time(t2))


def _time_handoff(peers, x, peer_y, stream, handoff: str, reps: int,
                  times: Dict[str, list]) -> None:
    """One round of ``time_shift`` with the hand-off ``handoff``: ``reps``
    posts and waits (:func:`_time_post_wait`, shift 1 on collective id 0),
    ``reps`` barriers alone (their own collective id) and ``reps`` copies
    alone, each timed with CUDA events on ``stream``; the milliseconds go
    into ``times``' lists."""
    import torch

    from tenzing_tpu_torch.ops import rdma

    bar_cid = rdma.MAX_COLLECTIVE_IDS - 1

    def ev():
        return torch.cuda.Event(enable_timing=True)

    _time_post_wait(peers, x, peer_y, stream, handoff, reps, 1, 0, times)
    for _ in range(reps):
        e = peers.next_epoch(bar_cid)
        t0, t1 = ev(), ev()
        with torch.cuda.stream(stream):
            t0.record(stream)
            rdma.rdma_shift_barrier(peers.flags, peers.flag_block(1),
                                    peers.flag_block(-1), bar_cid, e,
                                    peers.err, handoff)
            t1.record(stream)
        rdma.await_shift(t1, peers.flags, bar_cid, e, peers.err)
        times["barrier"].append(t0.elapsed_time(t1))
    for _ in range(reps):
        t0, t1 = ev(), ev()
        with torch.cuda.stream(stream):
            t0.record(stream)
            rdma.rdma_shift_copy(x, peer_y)
            t1.record(stream)
        t1.synchronize()
        times["copy"].append(t0.elapsed_time(t1))


def time_shift(mesh, device, x, y, cp, axis: str = "x", reps: int = 20
               ) -> dict:
    """The shift of one face along ``axis`` timed on this rank with CUDA
    events, every rank running the same loops: the post alone, the wait
    after it, the post and wait together, the barrier alone (its own
    collective id) and the copy kernel alone, for each hand-off of
    ``rdma.HANDOFFS`` (the kept one's at the top level, both under
    ``handoffs``), in turns (kept, other, other, kept); the plain shift
    (host-staged gloo) by the host clock; and the kernel's y against
    ``torch.roll`` of the gathered x."""
    import time

    import torch

    from tenzing_tpu_torch.models.halo import HALO_SPEC
    from tenzing_tpu_torch.ops import rdma
    from tenzing_tpu_torch.parallel.mesh import gather_buffer

    n, group = mesh.size(axis), mesh.group(axis)
    peers = rdma.ShiftPeers(axis, group, n, device)
    peer_y = peers.peer_recv("timing", y, 1, 0)
    stream = torch.cuda.Stream(device=device)
    before = dict(rdma.LAUNCHES)
    other = next(h for h in rdma.HANDOFFS if h != rdma.HANDOFF)
    times = {h: {k: [] for k in ("post", "wait", "both", "barrier", "copy")}
             for h in rdma.HANDOFFS}
    y.zero_()
    torch.cuda.synchronize(device)
    for handoff in (rdma.HANDOFF, other, other, rdma.HANDOFF):
        cp.barrier()
        _time_handoff(peers, x, peer_y, stream, handoff, max(1, reps // 2),
                      times[handoff])
    for k in rdma.LAUNCHES:  # timing launches do not count
        rdma.LAUNCHES[k] = before[k]
    specs = {"x": HALO_SPEC, "y": HALO_SPEC}
    gx = gather_buffer("x", x, specs, mesh)
    gy = gather_buffer("y", y, specs, mesh)
    dim = 1 + HALO_SPEC[1:].index(axis)
    blocks = gx.reshape(gx.shape[:dim] + (n, gx.shape[dim] // n)
                        + gx.shape[dim + 1:])
    want = rdma.shift_roll(blocks, 1, dim).reshape(gx.shape)
    err = float((gy - want).abs().max())
    exact = cp.agree_fault(0 if torch.equal(gy, want) else 1) == 0
    y_plain = torch.empty_like(y)
    plain = []
    for _ in range(max(3, reps // 4)):
        cp.barrier()
        t = time.perf_counter()
        rdma.rdma_shift_plain(x, y_plain, group, n, 1)
        torch.cuda.synchronize(device)
        plain.append((time.perf_counter() - t) * 1e3)
    plain_exact = cp.agree_fault(0 if torch.equal(y_plain, y) else 1) == 0

    def median(v):
        v = sorted(v)
        return v[len(v) // 2]

    nbytes = 2 * x.numel() * x.element_size()
    by = {h: {"post_ms": median(t["post"]), "wait_ms": median(t["wait"]),
              "post_wait_ms": median(t["both"]),
              "barrier_ms": median(t["barrier"]), "copy_ms": median(t["copy"])}
          for h, t in times.items()}
    return {"axis": axis, "face_shape": list(x.shape), "reps": reps,
            "handoff": rdma.HANDOFF, **by[rdma.HANDOFF], "handoffs": by,
            "plain_ms": median(plain), "bytes": nbytes,
            "exact_vs_roll": exact, "max_abs_err": err,
            "plain_exact": plain_exact}


def halo_shared_main(mesh, device, args: Dict[str, Any], seed: int = 0,
                     war_runs: int = 3, time_reps: int = 20) -> dict:
    """One rank of the shared-card halo (the launch task; ranks on GPU 0
    over gloo): the agreement stage's all-``.rdma`` schedule with U exact,
    the shift kernels' launches on this rank, the write-after-read probe,
    and the x face's shift timed; every rank returns its row."""
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.ops import rdma
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import control_group

    cp = DistControlPlane(control_group())
    hargs = HaloArgs(**args)
    h = build_halo(mesh, device, hargs, seed=seed)
    for k in rdma.LAUNCHES:
        rdma.LAUNCHES[k] = 0
    rows = agree_halo(h, cp, shared_card=True)
    launches = dict(rdma.LAUNCHES)
    war = war_check(mesh, device, hargs, cp, seed=seed, runs=war_runs)
    launches_war = {k: rdma.LAUNCHES[k] - launches[k] for k in launches}
    timing = None
    if device.type == "cuda":
        timing = time_shift(mesh, device, h.executor.init_bufs["buf_px"],
                            h.executor.init_bufs["recv_px"], cp,
                            reps=time_reps)
    return {"rank": cp.rank(), "coords": list(mesh.coords),
            "mesh": list(mesh.shape), "schedules": rows,
            "launches": launches, "war": war, "launches_war": launches_war,
            "timing": timing}


def halo_main(nproc: int, device: str, mcts_iters: int,
              shared_card: bool = False) -> dict:
    """The halo dryrun on ``nproc`` ranks (module docstring)."""
    width = HALO_DRYRUN_ARGS if device == "cpu" else HALO_FULL_ARGS
    shape = halo_mesh_shape(nproc)
    if shared_card:
        from tenzing_tpu_torch.parallel.launch import launch

        return launch("tenzing_tpu_torch.parallel.dryrun:halo_shared_main",
                      nproc, "cuda", {"args": width}, timeout_s=600.0,
                      mesh_axes=HALO_AXES, mesh_shape=shape,
                      shared_card=True)[0]
    kwargs = {"args": width, "mcts_iters": mcts_iters}
    if nproc == 1:
        return world_one(device, kwargs, fn=halo_rank_main, axes=HALO_AXES)
    from tenzing_tpu_torch.parallel.launch import launch

    return launch("tenzing_tpu_torch.parallel.dryrun:halo_rank_main", nproc,
                  device, kwargs, timeout_s=600.0, mesh_axes=HALO_AXES,
                  mesh_shape=shape)[0]


# -- the other multi-device models --------------------------------------------
#
# The distributed and irregular SpMV, the ring attention, the pipeline and its
# training step, and the TP MLP, each on the reference dryrun's protocol
# (``_agree_schedules``, __graft_entry__.py:23-47): rank 0 picks schedules and
# broadcasts their JSON, every rank verifies and runs each on its block, the
# gathered output must be within the reference's tolerance of the expected.

# the models of ``--model`` beside moe and halo
MODELS = ("spmv_dist", "spmv_irregular", "ring", "pipeline", "pipeline_train",
          "tp_mlp")
# the models that need two or more ranks
MULTI_RANK_MODELS = ("tp_mlp_synth",)
# the synth stage's mesh MCTS (the reference's n_iters=5, seed=1)
SYNTH_MCTS_ITERS = 5
# the reference dryrun's tolerances against the expected output
# (__graft_entry__.py:274-276, :362-366, :408-433, :460-462)
SPMV_TOL = dict(rtol=2e-3, atol=0.0)
ACT_TOL = dict(rtol=2e-4, atol=2e-5)
TRAIN_TOL = dict(rtol=2e-3, atol=2e-5)
# dW's rms error relative to its rms: the card's float32 training step read
# 1.7e-7 at 8 x 2048 rows and d 512 (PERF.md); a dW rounded through
# float16 reads about 3e-4, one microbatch's gradient dropped far more
TRAIN_REL_RMS = 2e-6


def train_tol(args: Dict[str, Any], want: np.ndarray) -> Dict[str, float]:
    """dW's tolerance: ``TRAIN_TOL``, its atol raised to the rounding of
    float32 sums at this width, and ``TRAIN_REL_RMS`` over the whole
    tensor.  Each element of dW sums k = mb_size * n_microbatches products
    whose partial sums reach max|dW|; float32 rounds each addition by up to
    u max|dW| (u = 2^-24), and k of them random in sign move the sum by
    about sqrt(k) u max|dW|.  At the reference dryrun's width that is below
    2e-5 and the atol is the reference's; at 8 x 2048 rows and d 512
    (max|dW| 1716) it is 1.3e-2, where an element that cancels to near
    zero carries errors far above 2e-5 in any float32 summation order.
    That bounds each element, not the tensor; the relative rms holds the
    tensor (the wrong dW of :func:`train_controls` must fail it)."""
    k = args["mb_size"] * args["n_microbatches"]
    atol = float(np.sqrt(k) * 2.0 ** -24 * np.abs(want).max())
    return dict(TRAIN_TOL, atol=max(TRAIN_TOL["atol"], atol),
                rel_rms=TRAIN_REL_RMS)


def train_controls(args: Dict[str, Any], seed: int = 0) -> Dict[str, dict]:
    """Two wrong dW that :func:`train_tol` must reject, each held to it
    against the expected dW of ``args`` (a ``PipelineArgs`` dict): the
    expected without microbatch 0's gradient (``dropped_microbatch``), and
    the expected rounded through float16 (``f16_rounded``: each element
    within 2^-11 of its value, so inside ``TRAIN_TOL``'s allclose alone; a
    bf16 rounding errs 8 times more).  Host float64; returns ``{name:
    {"within_tol", "max_abs", "rel_rms"}}``."""
    import torch

    from tenzing_tpu_torch.bench.gate import within
    from tenzing_tpu_torch.models import pipeline as pp

    bufs, _, want = pp.make_train_buffers(pp.PipelineArgs(**args), seed=seed)
    tol = train_tol(args, want)
    w64 = bufs["W"].astype(np.float64)
    mb0 = pp.microbatch_dw64(bufs["X_0"][0], w64, bufs["target_0"][0])
    want_t = torch.from_numpy(want)
    wrong = {"dropped_microbatch": torch.from_numpy(want - mb0),
             "f16_rounded": want_t.to(torch.float16).double()}
    out = {}
    for name, got in wrong.items():
        ok, errs = within(got, want_t, tol)
        out[name] = {"within_tol": ok, **errs}
    return out
# a model stage's executor lanes, its schedules per stage (the most DFS or
# rdma schedules picked), and the timed shifts per distance on a shared card
MODEL_LANES = 2
N_SCHED = 3
DISTANCE_REPS = 10
# the card's full widths (PERF.md section 4's configurations; chip_smoke.py)
SPMV_DIST_FULL = dict(n_sp=1, batch=1, rows_per_shard=150_000, nnz_per_row=10)
# the spmv workload's band matrix (bench/driver.py build_spmv), and a
# uniform random one of the same size and nonzeros
IRR_BAND_FULL = dict(kind="band", m=150_000, bw=18_750, nnz=1_500_000, seed=0)
IRR_RANDOM_FULL = dict(kind="random", m=150_000, n=150_000, nnz=1_500_000,
                       seed=0)
RING_FULL = dict(n_devices=1, batch=4, seq_local=8192, head_dim=128)
TP_FULL = dict(n_tp=1, n_layers=2, n_chunks=4, mb_size=2048, d_model=512,
               d_ff=2048)
PIPE_FULL = dict(n_pp=1, n_microbatches=8, n_chains=2, mb_size=2048,
                 d_model=512)


def sp_mesh_shape(nproc: int) -> Tuple[int, int]:
    """The reference dryrun's ``("dp", "sp")`` mesh: dp 2 when N is even and
    at least 4, else 1 (__graft_entry__.py:262-264)."""
    dp = 2 if nproc % 2 == 0 and nproc >= 4 else 1
    return dp, nproc // dp


def model_cases(nproc: int, model: str) -> List[Dict[str, Any]]:
    """The reference dryrun's stages of ``model`` on N ranks at its CPU
    widths: each a dict of the model, its mesh axes and shape, its args and
    the schedules to run (``"dfs"``: up to 3 DFS schedules; ``"menu"``: one
    per alternative of its menu)."""
    dp, sp = sp_mesh_shape(nproc)
    dp2 = 2 if nproc % 2 == 0 else 1
    tp2 = nproc // dp2
    if model == "spmv_dist":
        return [dict(model=model, axes=("dp", "sp"), shape=(dp, sp),
                     args=dict(n_sp=sp, batch=2 * dp, rows_per_shard=64,
                               nnz_per_row=4), pick="dfs")]
    if model == "spmv_irregular":
        # the menu needs a distance to exchange: none at sp = 1
        mat = dict(kind="random", m=16 * sp, n=16 * sp, nnz=40 * sp, seed=2)
        return [dict(model=model, axes=("dp", "sp"), shape=(dp, sp),
                     args=dict(matrix=mat, batch=2 * dp), pick="dfs")] + [
                dict(model=model, axes=("dp", "sp"), shape=(dp, sp),
                     args=dict(matrix=mat, batch=2 * dp, impl_choice=True),
                     pick="menu")] * (sp > 1)
    if model == "ring":
        args = dict(n_devices=nproc, batch=2, seq_local=8, head_dim=8)
        return [dict(model=model, axes=("sp",), shape=(nproc,), args=args,
                     pick="dfs"),
                dict(model=model, axes=("sp",), shape=(nproc,),
                     args=dict(args, impl_choice=True), pick="f32_slots")]
    if model in ("pipeline", "pipeline_train"):
        return [dict(model=model, axes=("pp",), shape=(nproc,),
                     args=dict(n_pp=nproc, n_microbatches=4, n_chains=2,
                               mb_size=2, d_model=8), pick="dfs")]
    if model == "tp_mlp":
        return [dict(model=model, axes=("tp",), shape=(nproc,),
                     args=dict(n_tp=nproc, n_layers=2, n_chunks=2, mb_size=2,
                               d_model=8, d_ff=16), pick="dfs"),
                dict(model=model, axes=("dp", "tp"), shape=(dp2, tp2),
                     args=dict(n_tp=tp2, n_layers=2, n_chunks=2,
                               mb_size=2 * dp2, d_model=8, d_ff=16 * tp2,
                               n_dp=dp2), pick="dfs")]
    if model == "tp_mlp_synth":
        if nproc < 2:
            raise ValueError("tp_mlp_synth needs 2 or more ranks: at tp=1 "
                             "the all-reduce has no decomposition")
        return [dict(model=model, axes=("tp",), shape=(nproc,),
                     args=dict(n_tp=nproc, n_layers=2, n_chunks=2, mb_size=2,
                               d_model=8, d_ff=16), pick="dfs")]
    raise ValueError(f"unknown model {model!r} (have "
                     f"{MODELS + MULTI_RANK_MODELS})")


def irregular_matrix(spec: Dict[str, Any]):
    """The CSR matrix a ``matrix`` args entry names."""
    from tenzing_tpu_torch.models.spmv import random_band_matrix, random_matrix

    if spec["kind"] == "band":
        return random_band_matrix(spec["m"], spec["bw"], spec["nnz"],
                                  seed=spec["seed"])
    return random_matrix(spec["m"], spec["n"], spec["nnz"], seed=spec["seed"])


def model_setup(model: str, args: Dict[str, Any], n_ranks: Dict[str, int],
                seed: int = 0, with_expected: bool = True):
    """(graph, global buffers, specs, expected output or None, output name,
    tolerance) of ``model`` with ``args`` (``n_ranks``: the mesh's axis
    sizes, for the models whose args do not carry them).  Besides the
    model's own fields ``args`` may hold ``impl_choice`` (the irregular
    SpMV's exchange menu, the ring's step menu) and ``chunk`` (the TP MLP's
    and the pipeline forward's chunk menus, every valid count kept)."""
    from tenzing_tpu_torch.core.graph import Graph

    a = dict(args)
    impl = a.pop("impl_choice", False)
    chunk = a.pop("chunk", False)
    g = Graph()
    if model == "spmv_dist":
        from tenzing_tpu_torch.models.spmv_dist import DistSpMV, make_dist_spmv_buffers

        bufs, specs, want = make_dist_spmv_buffers(**a, seed=seed)
        comp, out, tol = DistSpMV(), "Y", SPMV_TOL
    elif model == "spmv_irregular":
        from tenzing_tpu_torch.models.spmv_irregular import (
            IrregularSpMV,
            make_irregular_spmv_buffers,
        )

        bufs, specs, want, plan = make_irregular_spmv_buffers(
            irregular_matrix(a["matrix"]), n_sp=n_ranks["sp"],
            batch=a["batch"], seed=seed, impl_choice=impl)
        comp = IrregularSpMV(plan.steps, widths=plan.widths,
                             impl_choice=impl)
        out, tol = "Y", SPMV_TOL
    elif model == "ring":
        from tenzing_tpu_torch.models.ring_attention import (
            RingAttention,
            RingAttnArgs,
            make_ring_buffers,
        )

        ra = RingAttnArgs(**a)
        bufs, specs, want = make_ring_buffers(ra, seed=seed,
                                              with_expected=with_expected)
        comp, out, tol = RingAttention(ra, impl_choice=impl), "O", ACT_TOL
    elif model in ("pipeline", "pipeline_train"):
        from tenzing_tpu_torch.models import pipeline as pp

        pa = pp.PipelineArgs(**a)
        if model == "pipeline":
            bufs, specs, want = pp.make_pipeline_buffers(pa, seed=seed)
            comp = pp.Pipeline(pa, chunk=chunk, chunk_relax=chunk)
            out, tol = "Y", ACT_TOL
        else:
            bufs, specs, want = pp.make_train_buffers(pa, seed=seed)
            comp, out, tol = pp.PipelineTrain(pa), "dW", train_tol(a, want)
    elif model in ("tp_mlp", "tp_mlp_synth"):
        from tenzing_tpu_torch.models.tp_mlp import TpMlp, TpMlpArgs, make_tp_mlp_buffers

        synth = model == "tp_mlp_synth"
        n_dp = a.pop("n_dp", 1)
        ta = TpMlpArgs(**a)
        bufs, specs, want = make_tp_mlp_buffers(ta, seed=seed, n_dp=n_dp,
                                                synth=synth)
        comp = TpMlp(ta, chunk=chunk, chunk_relax=chunk, synth=synth,
                     synth_relax=synth)
        out, tol = "Y", ACT_TOL
    else:
        raise ValueError(f"unknown model {model!r} (have {MODELS})")
    g.start_then(comp)
    g.then_finish(comp)
    return g, bufs, specs, want, out, tol


@dataclass
class ModelRun:
    """One rank's model: its graph, platform, executor, specs, the output's
    name, its expected value (global, on the device) and tolerance."""

    model: str
    mesh: Any
    graph: Any
    platform: Any
    executor: Any
    specs: Dict[str, Any]
    out: str
    want: Any
    tol: Dict[str, float]


def build_model(mesh, device, model: str, args: Dict[str, Any],
                seed: int = 0) -> ModelRun:
    """This rank's executor on ``MODEL_LANES`` lanes over its block of the model's
    buffers (float buffers placed as float32: the reference's float64
    weights are placed as float32, as jax does with x64 off).  A ring built
    without an expected O gets the dense float64 O on the device
    (bench/gate.py ``dense_attention64``), which at 8k context the host
    cannot hold."""
    import torch

    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.parallel.mesh import shard_buffers
    from tenzing_tpu_torch.runtime.executor import StreamExecutor

    sizes = {n: mesh.size(n) for n in mesh.axis_names}
    big_ring = model == "ring" and torch.device(device).type == "cuda"
    g, bufs, specs, want, out, tol = model_setup(
        model, args, sizes, seed, with_expected=not big_ring)
    bufs = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in bufs.items()}
    if want is None:
        from tenzing_tpu_torch.bench.gate import dense_attention64
        from tenzing_tpu_torch.models.ring_attention import RingAttnArgs

        ra = RingAttnArgs(**{k: v for k, v in args.items()
                             if k != "impl_choice"})
        qkv = [torch.from_numpy(bufs[k]).to(device) for k in ("Q", "K0", "V0")]
        want_t = dense_attention64(*qkv, ra.scale)
        del qkv
    else:
        want_t = torch.from_numpy(want).to(device)
    local = shard_buffers(bufs, specs, mesh, device)
    del bufs
    plat = Platform.make_n_lanes(MODEL_LANES, mesh=mesh, specs=specs)
    # collectives and in-op exchanges wait from the host: no CUDA graphs
    ex = StreamExecutor(plat, local, device=torch.device(device).type,
                        graphs=False)
    return ModelRun(model=model, mesh=mesh, graph=g, platform=plat,
                    executor=ex, specs=specs, out=out, want=want_t, tol=tol)


def run_model(m: ModelRun, order):
    """Run ``order`` once from the initial buffers; the gathered output (a
    collective)."""
    from tenzing_tpu_torch.parallel.mesh import gather_buffer

    got = m.executor.run(order)[m.out]
    return gather_buffer(m.out, got, m.specs, m.mesh)


def exchange_of(order) -> str:
    """The irregular SpMV exchange a schedule runs: permute, a2a or rdma."""
    names = [op.name() for op in order]
    if any(n.startswith("a2a_") for n in names):
        return "a2a"
    if any(n.startswith("rdma_") for n in names):
        return "rdma"
    return "permute"


def step_slots(order) -> List[str]:
    """The slot of each ring step a schedule runs, in step order."""
    slots = {}
    for op in order:
        name = op.name()
        if name.startswith("attn_") and "." in name:
            step, slot = name.split(".", 1)
            slots[int(step[5:])] = "." + slot
    return [slots[k] for k in sorted(slots)]


def pick_model_schedules(graph, platform, pick: str):
    """The schedules of a stage: ``"dfs"``, up to ``N_SCHED`` DFS schedules
    of the graph; ``"menu"``, per exchange of the irregular SpMV's menu the
    first DFS schedule; ``"rdma"``, up to ``N_SCHED`` DFS schedules whose
    exchange is ``exchange.rdma``; ``"f32_slots"`` / ``"slots"``, one
    schedule per ring step slot (``.xla``, ``.pallas``, and with
    ``"slots"`` ``.pallas_bf16``) with every step on it; ``"chunked"``, the
    first-decision order with every TP layer split in 2."""
    from tenzing_tpu_torch.solve.dfs import (
        enumerate_schedules,
        get_all_sequences,
        structural_variants,
    )

    if pick == "dfs":
        return [st.sequence for st in
                get_all_sequences(graph, platform, N_SCHED)]
    if pick in ("menu", "rdma"):
        nv = len(structural_variants(graph))
        orders = [st.sequence for st in enumerate_schedules(
            graph, platform, max_seqs=nv * N_SCHED,
            log=lambda msg: None)]
        if pick == "rdma":
            return [o for o in orders if exchange_of(o) == "rdma"][:N_SCHED]
        out = []
        for kind in ("permute", "a2a", "rdma"):
            hit = next((o for o in orders if exchange_of(o) == kind), None)
            if hit is None:
                raise AssertionError(f"no {kind} schedule enumerated")
            out.append(hit)
        return out
    if pick in ("slots", "f32_slots"):
        slots = (".xla", ".pallas") + ((".pallas_bf16",) if pick == "slots"
                                       else ())
        return [engine_order(graph, platform, lambda n, s=s: s)
                for s in slots]
    if pick == "chunked":
        return [engine_order(graph, platform, lambda n: ".chunked.c2")]
    raise ValueError(f"unknown pick {pick!r}")


def model_tol(m: ModelRun, order) -> Dict[str, float]:
    """The tolerance a schedule's output is held to: the model's, or for a
    ring schedule with a bf16 step ``BF16_O_TOL`` (ops/attention_kernels.py)."""
    if m.model == "ring" and any(op.name().endswith(".pallas_bf16")
                                 for op in order):
        from tenzing_tpu_torch.ops.attention_kernels import BF16_O_TOL

        return BF16_O_TOL
    return m.tol


def agree_model(m: ModelRun, cp, pick: str = "dfs",
                label: str = "") -> List[dict]:
    """The agreement stage of one model: rank 0 picks the schedules
    (:func:`pick_model_schedules`) and broadcasts them; every rank verifies
    and runs each; the gathered output must be within the tolerance of the
    expected on every schedule.  Raises on an unsound schedule or an
    output out of tolerance; returns one row per schedule (its ops, largest
    error and relative rms, kernel launches on this rank, wall seconds)."""
    import time

    from tenzing_tpu_torch.bench.gate import within
    from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.ops import rdma
    from tenzing_tpu_torch.verify import ScheduleVerifier

    picked = (pick_model_schedules(m.graph, m.platform, pick)
              if cp.rank() == 0 else [])
    jsons = cp.bcast_json([sequence_to_json(o) for o in picked]
                          if cp.rank() == 0 else None)
    if not jsons:
        raise AssertionError(f"{m.model} {label}: no schedule picked")
    verifier = ScheduleVerifier(m.graph)
    rows = []
    for i, js in enumerate(jsons):
        order = sequence_from_json(js, m.graph)
        verdict = verifier(order)
        if not verdict.ok:
            raise AssertionError(f"{m.model} {label} schedule {i} is "
                                 f"unsound: {verdict.witness()}")
        before = {**dict(ak.LAUNCHES), **dict(rdma.LAUNCHES)}
        t0 = time.perf_counter()
        got = run_model(m, order)
        wall = time.perf_counter() - t0
        after = {**dict(ak.LAUNCHES), **dict(rdma.LAUNCHES)}
        tol = model_tol(m, order)
        ok, errs = within(got, m.want, tol)
        del got
        row = {"stage": label, "schedule": i, "ops": len(order),
               "max_abs_err": errs["max_abs"], "rel_rms_err": errs["rel_rms"],
               "tol": tol, "within_tol": ok, "wall_s": wall,
               "launches": {k: after[k] - before[k] for k in after
                            if after[k] != before[k]}}
        if m.model == "spmv_irregular":
            row["exchange"] = exchange_of(order)
        if m.model == "ring":
            row["slots"] = step_slots(order)
        rows.append(row)
        if not ok:
            raise AssertionError(f"{m.model} {label} schedule {i}: "
                                 f"{m.out} is not within {tol} of the "
                                 f"expected: {row}")
    return rows


def model_rank_main(mesh, device, model: str, args: Dict[str, Any],
                    pick: str = "dfs", seed: int = 0,
                    label: str = "") -> Optional[dict]:
    """One rank of a model stage (the launch task): the agreement; rank 0
    returns its rows, the others None."""
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import control_group

    cp = DistControlPlane(control_group())
    m = build_model(mesh, device, model, args, seed=seed)
    rows = agree_model(m, cp, pick, label)
    search = synth_explore(m, cp) if model == "tp_mlp_synth" else None
    if cp.rank() != 0:
        return None
    out = {"model": model, "stage": label, "mesh": dict(
        zip(mesh.axis_names, mesh.shape)), "args": args, "schedules": rows}
    if search is not None:
        out["explore"] = search
    return out


def synth_explore(m: ModelRun, cp, iters: int = SYNTH_MCTS_ITERS) -> dict:
    """The synth stage's search (reference __graft_entry__.py:487-505): an
    MCTS of ``iters`` iterations (FastMin, seed 1) on the mesh through the
    control plane; every rollout is run again from the initial buffers and
    its Y held to the model's tolerance, and the rollouts must visit at
    least two sketch labels (``fixed`` for a rollout with none).  Raises
    otherwise; returns the labels seen, the rollouts and the tree size."""
    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
    from tenzing_tpu_torch.bench.gate import within
    from tenzing_tpu_torch.collectives.synth import synths_of
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore
    from tenzing_tpu_torch.solve.mcts.strategies import FastMin

    bench = EmpiricalBenchmarker(m.executor, control_plane=cp)
    res = explore(m.graph, m.platform, bench,
                  MctsOpts(n_iters=iters, seed=1,
                           bench_opts=BenchOpts(n_iters=1, target_secs=1e-4)),
                  strategy=FastMin, control_plane=cp)
    seen = set()
    for i, sim in enumerate(res.sims):
        chosen = synths_of(sim.order.vector())
        seen.update(f"{v['sketch']}.c{v['chunks']}" for v in chosen.values())
        if not chosen:
            seen.add("fixed")
        ok, errs = within(run_model(m, sim.order), m.want, m.tol)
        if not ok:
            raise AssertionError(f"synth rollout {i}: {m.out} is not within "
                                 f"{m.tol} of the expected: {errs}")
    if len(seen) < 2:
        raise AssertionError(f"the synth MCTS visited {sorted(seen)}: fewer "
                             "than two sketch labels")
    return {"rollouts": len(res.sims), "tree_size": res.tree_size,
            "sketches": sorted(seen)}


def model_shared_main(mesh, device, model: str, args: Dict[str, Any],
                      seed: int = 0, label: str = "") -> dict:
    """One rank of the irregular SpMV on ranks sharing one card (the launch
    task): only the ``exchange.rdma`` schedules, each held to the expected
    Y; then each distance's shift timed alone on this rank (post, wait and
    both, CUDA events, every rank running the same loop).  Every rank
    returns its row, with the shift kernels it launched."""
    from tenzing_tpu_torch.ops import rdma
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import control_group

    cp = DistControlPlane(control_group())
    m = build_model(mesh, device, model, args, seed=seed)
    for k in rdma.LAUNCHES:
        rdma.LAUNCHES[k] = 0
    rows = agree_model(m, cp, "rdma", label)
    launches = dict(rdma.LAUNCHES)
    timing = time_distances(m, cp)
    return {"rank": cp.rank(), "mesh": dict(zip(mesh.axis_names, mesh.shape)),
            "args": args, "schedules": rows, "launches": launches,
            "timing": timing}


def model_shared_cases_main(mesh, device, cases: List[Dict[str, Any]],
                            seed: int = 0) -> List[dict]:
    """One rank of several shared-card cases on one mesh (the launch task
    of :func:`models_main` with ``shared_card``): :func:`model_shared_main`
    for each case (``model``, ``args``, ``label``) in turn; returns this
    rank's row per case."""
    return [model_shared_main(mesh, device, c["model"], c["args"], seed=seed,
                              label=c["label"])
            for c in cases]


def halo_then_models_shared_main(mesh, device, args: Dict[str, Any],
                                 cases: List[Dict[str, Any]],
                                 time_reps: int = 20,
                                 seed: int = 0) -> dict:
    """One rank of the shared-card halo (:func:`halo_shared_main`), then of
    the shared-card model cases on the same ranks and process group, each
    over its own mesh (``axes``, ``shape``; :func:`shared_cases`): the
    ranks start and reach the card once for both.  Returns this rank's
    ``halo`` row and its row per case (``models``)."""
    import torch.distributed as dist

    from tenzing_tpu_torch.parallel.mesh import init_mesh

    halo = halo_shared_main(mesh, device, args, seed=seed,
                            time_reps=time_reps)
    rows = []
    for c in cases:
        # the process group is joined: init_mesh only lays the axes on it
        m = init_mesh(c["axes"], "gloo", "", dist.get_rank(),
                      dist.get_world_size(), shape=c["shape"],
                      shared_card=True)
        rows.append(model_shared_main(m, device, c["model"], c["args"],
                                      seed=seed, label=c["label"]))
    return {"halo": halo, "models": rows}


def time_distances(m: ModelRun, cp) -> Dict[str, dict]:
    """Each kept distance's shift of ``send_<d>`` into ``recv_<d>`` timed on
    this rank with CUDA events (:func:`_time_post_wait`, ``DISTANCE_REPS``
    times; median post, wait, post + wait in ms), collective id d for
    distance d, every rank running the same loop; the timing launches are
    not counted."""
    import torch

    from tenzing_tpu_torch.ops import rdma

    mesh, bufs = m.mesh, m.executor.init_bufs
    n, group = mesh.size("sp"), mesh.group("sp")
    peers = rdma.ShiftPeers("sp", group, n, m.executor.device)
    stream = torch.cuda.Stream(device=m.executor.device)
    before = dict(rdma.LAUNCHES)
    out = {}
    steps = sorted(int(k[5:]) for k in bufs if k.startswith("send_")
                   and k[5:].isdigit())
    for d in steps:
        x, y = bufs[f"send_{d}"], bufs[f"recv_{d}"]
        peer_y = peers.peer_recv(f"timing_{d}", y, d, 0)
        times = {"post": [], "wait": [], "both": []}
        cp.barrier()
        _time_post_wait(peers, x, peer_y, stream, rdma.HANDOFF,
                        DISTANCE_REPS, d, d, times)
        out[str(d)] = {k + "_ms": sorted(v)[len(v) // 2]
                       for k, v in times.items()}
        out[str(d)]["bytes"] = x.numel() * x.element_size()
    for k in rdma.LAUNCHES:
        rdma.LAUNCHES[k] = before[k]
    cp.barrier()
    return out


def model_schedules(mesh, device, model: str, args: Dict[str, Any],
                    schedules: List[list], seed: int = 0,
                    poison: Tuple[str, ...] = ()) -> Optional[list]:
    """Launch task: run each schedule JSON of ``model`` once from the
    initial buffers; rank 0 returns the gathered output of each (numpy),
    the others None.  ``poison`` names buffers whose initial contents are
    NaN on every rank (the pipeline's dead-slot check: what only a dead
    slot reads must not reach the output)."""
    from tenzing_tpu_torch.core.serdes import sequence_from_json

    m = build_model(mesh, device, model, args, seed=seed)
    for name in poison:
        for bufs in (m.executor.init_bufs, m.executor._initial):
            bufs[name].fill_(float("nan"))
    out = [run_model(m, sequence_from_json(js, m.graph)).cpu().numpy()
           for js in schedules]
    return out if mesh.coords == (0,) * len(mesh.coords) else None


def models_main(model: str, nproc: int, device: str,
                shared_card: bool = False) -> dict:
    """The dryrun of ``model`` on ``nproc`` ranks: every stage of
    :func:`model_cases` on the CPU, or at the card's widths
    (:func:`full_cases`) on CUDA; one summary."""
    from tenzing_tpu_torch.parallel.launch import launch

    if shared_card:
        # every case of one rank count shares its mesh: one launch runs them
        # all, so the ranks start (and reach the card) once
        cases = shared_cases(nproc)
        ranks = launch("tenzing_tpu_torch.parallel.dryrun:"
                       "model_shared_cases_main", nproc, "cuda",
                       {"cases": [{k: c[k] for k in ("model", "args",
                                                      "label")}
                                  for c in cases]}, timeout_s=600.0,
                       mesh_axes=cases[0]["axes"],
                       mesh_shape=cases[0]["shape"], shared_card=True)
        stages = [{"stage": c["label"], "ranks": [r[i] for r in ranks]}
                  for i, c in enumerate(cases)]
        return {"dryrun": model, "nproc": nproc, "shared_card": True,
                "stages": stages}
    cases = (model_cases(nproc, model) if device == "cpu"
             else full_cases(nproc, model))
    stages = []
    for c in cases:
        kwargs = {"model": c["model"], "args": c["args"], "pick": c["pick"],
                  "label": f"{c['model']}/{c['pick']}"}
        if nproc == 1:
            stages.append(world_one(device, kwargs, fn=model_rank_main,
                                    axes=c["axes"]))
        else:
            stages.append(launch("tenzing_tpu_torch.parallel.dryrun:"
                                 "model_rank_main", nproc, device, kwargs,
                                 timeout_s=600.0, mesh_axes=c["axes"],
                                 mesh_shape=c["shape"])[0])
    return {"dryrun": model, "nproc": nproc, "device": device,
            "stages": stages}


def full_cases(nproc: int, model: str) -> List[Dict[str, Any]]:
    """The card's stages of ``model`` (world size 1 over NCCL): the full
    widths (module constants), the picks chip_smoke.py runs."""
    if nproc != 1:
        raise ValueError("on the card the models run at world size 1 (or "
                         "the irregular SpMV with --shared-card)")
    one = dict(axes=("sp",), shape=(1,))
    if model == "spmv_dist":
        return [dict(model=model, axes=("dp", "sp"), shape=(1, 1),
                     args=SPMV_DIST_FULL, pick="dfs")]
    if model == "spmv_irregular":
        return [dict(model=model, axes=("dp", "sp"), shape=(1, 1),
                     args=dict(matrix=IRR_BAND_FULL, batch=1), pick="dfs")]
    if model == "ring":
        return [dict(model=model, **one,
                     args=dict(RING_FULL, impl_choice=True), pick="slots")]
    if model in ("pipeline", "pipeline_train"):
        return [dict(model=model, axes=("pp",), shape=(1,), args=PIPE_FULL,
                     pick="dfs")]
    if model == "tp_mlp_synth":
        raise ValueError("tp_mlp_synth has no menu at world size 1 (tp=1); "
                         "its decompositions run over gloo on the CPU")
    if model == "tp_mlp":
        return [dict(model=model, axes=("tp",), shape=(1,), args=TP_FULL,
                     pick="dfs"),
                dict(model=model, axes=("tp",), shape=(1,),
                     args=dict(TP_FULL, chunk=True), pick="chunked")]
    raise ValueError(f"unknown model {model!r} (have {MODELS})")


def shared_cases(nproc: int) -> List[Dict[str, Any]]:
    """The irregular SpMV on ranks sharing one card: the spmv workload's
    band matrix, and on 4 ranks also the uniform random matrix (every
    distance)."""
    out = [dict(model="spmv_irregular", axes=("dp", "sp"), shape=(1, nproc),
                args=dict(matrix=IRR_BAND_FULL, batch=1, impl_choice=True),
                label=f"band/{nproc}")]
    if nproc >= 3:
        out.append(dict(model="spmv_irregular", axes=("dp", "sp"),
                        shape=(1, nproc),
                        args=dict(matrix=IRR_RANDOM_FULL, batch=1,
                                  impl_choice=True),
                        label=f"random/{nproc}"))
    return out


# -- the modeled stage --------------------------------------------------------


def modeled_ratio(label: str, graph, nbytes: Dict[str, int],
                  n_iters: int = 24) -> dict:
    """The reference dryrun's modeled stage (__graft_entry__.py:318-351):
    the first-decision order on one lane against an MCTS (FastMin) on two
    lanes, both scored by the analytic model (bench/model.py, the card's
    defaults); raises unless the searched beats the naive."""
    from tenzing_tpu_torch.bench.benchmarker import BenchOpts
    from tenzing_tpu_torch.bench.model import AnalyticBenchmarker
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.solve.local import first_decision_order
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore
    from tenzing_tpu_torch.solve.mcts.strategies import FastMin

    bench = AnalyticBenchmarker(nbytes)
    naive = bench.makespan(first_decision_order(graph,
                                                Platform.make_n_lanes(1)))
    res = explore(graph, Platform.make_n_lanes(2), bench,
                  MctsOpts(n_iters=n_iters, bench_opts=BenchOpts(n_iters=1),
                           seed=0),
                  strategy=FastMin)
    best = min(s.result.pct50 for s in res.sims)
    if not best < naive:
        raise AssertionError(f"modeled {label}: the searched schedule "
                             f"({best}) does not beat naive ({naive})")
    return {"workload": label, "naive_us": naive * 1e6,
            "searched_us": best * 1e6, "ratio": naive / best,
            "rollouts": len(res.sims)}


def modeled_main(nproc: int) -> dict:
    """The modeled stage on the halo graph of an N-rank mesh and the MoE
    layer of N experts, at the reference dryrun's widths."""
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.models.halo import HaloArgs, add_to_graph, make_halo_buffers

    hargs = HaloArgs(**HALO_DRYRUN_ARGS)
    hbufs, _, _ = make_halo_buffers(halo_mesh_shape(nproc), hargs, seed=0)
    halo = modeled_ratio("halo", add_to_graph(Graph(), hargs),
                         {k: v.nbytes for k, v in hbufs.items()})
    margs = MoEArgs(n_ep=nproc, **DRYRUN_ARGS)
    mbufs, _, _ = make_moe_buffers(margs, seed=0)
    moe = modeled_ratio("moe", layer_graph(margs),
                        {k: v.nbytes for k, v in mbufs.items()})
    return {"dryrun": "modeled", "nproc": nproc, "stages": [halo, moe]}

if __name__ == "__main__":
    sys.exit(main())
