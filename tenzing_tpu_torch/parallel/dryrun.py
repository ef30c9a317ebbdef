"""The multi-device models on N ranks: ``python -m
tenzing_tpu_torch.parallel.dryrun [--model moe|halo] --nproc N [--device
cpu] [--shared-card]``.

The port's counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` (its
``_agree_schedules`` protocol, :23-47): the MoE stages and the halo stages
(the distributed SpMV stage waits for ``models/spmv_dist.py``, ROADMAP
Queue 1 item 5).

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

It runs on ``cuda`` over NCCL (rank r on GPU r; more ranks than visible
GPUs are refused) unless ``--device cpu`` is given, which runs over gloo.
``--nproc 1`` runs in this process; more start one process per rank
(parallel/launch.py).  The width is the reference dryrun's on the CPU
(``DRYRUN_ARGS``, ``HALO_DRYRUN_ARGS``) and the full one on the card
(``FULL_ARGS``, ``HALO_FULL_ARGS``), which ``chip_smoke.py`` drives too.
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
    ``MoELayer`` options)."""
    import torch

    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.parallel.mesh import shard_buffers
    from tenzing_tpu_torch.runtime.executor import StreamExecutor

    bufs, specs, want = make_moe_buffers(args, seed=seed)
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
    ex = StreamExecutor(plat, local, device=torch.device(device).type)
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
    p.add_argument("--model", choices=("moe", "halo"), default="moe")
    p.add_argument("--nproc", type=int, default=1)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--mcts-iters", type=int, default=8)
    p.add_argument("--shared-card", action="store_true",
                   help="halo: all ranks on GPU 0, joined over gloo")
    a = p.parse_args(argv)
    if a.shared_card and (a.model != "halo" or a.device != "cuda"):
        p.error("--shared-card runs the halo model on cuda")
    if a.model == "halo":
        summary = halo_main(a.nproc, a.device, a.mcts_iters, a.shared_card)
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
    print(json.dumps(summary), flush=True)
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
               extra: Optional[Dict[str, np.ndarray]] = None) -> HaloMesh:
    """This rank's executor on ``lanes`` lanes over its block of
    ``make_halo_buffers(mesh shape, args, seed)`` (plus ``extra`` buffers)."""
    import torch

    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.halo import HALO_SPEC, make_local_halo_buffers
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

    bufs, want = make_local_halo_buffers(mesh.shape, mesh.coords, args, seed)
    bufs.update(extra or {})
    local = buffers_from_numpy(bufs, device)
    del bufs
    plat = Platform.make_n_lanes(lanes, mesh=mesh,
                                 specs={k: HALO_SPEC for k in local})
    ex = StreamExecutor(plat, local, device=torch.device(device).type)
    return HaloMesh(args=args, mesh=mesh, platform=plat, executor=ex,
                    want=torch.from_numpy(want).to(device))


def halo_graph(args, xfer_choice: bool = False):
    """Start -> the halo exchange -> Finish: the ``HaloExchange`` compound,
    or with ``xfer_choice`` the chains with the engine menu (the
    reference's ``add_to_graph(Graph(), args, xfer_choice=True)``)."""
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.models.halo import HaloExchange, add_to_graph

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
                   fail_rank: Optional[int] = None) -> Optional[list]:
    """Launch task: run each schedule JSON of the halo graph once on the
    mesh, from the initial buffers; rank 0 returns the gathered U of each
    (numpy), the others None.  ``fail_rank`` runs only the first schedule's
    ops before its first await on that rank, which then raises with its
    transfers in flight while the others wait in the exchange."""
    from tenzing_tpu_torch.core.serdes import sequence_from_json
    from tenzing_tpu_torch.models.halo import HALO_SPEC, HaloArgs
    from tenzing_tpu_torch.parallel.mesh import coords_of, gather_buffer

    h = build_halo(mesh, device, HaloArgs(**args), seed=seed)
    g = halo_graph(h.args, xfer_choice=xfer_choice)
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
    (``PermuteStart``), ``"rdma"`` (``RdmaShiftStart``) or ``"psum"``
    (``PsumStart``), with ``shift`` (default 1); returns the gathered
    destinations (numpy) on every rank."""
    import torch

    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer, PermuteStart, PsumStart
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
                "psum": lambda: PsumStart("post", "src", "dst", axis)
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
        ex = StreamExecutor(plat, local, device=torch.device(device).type)
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


def time_shift(mesh, device, x, y, cp, axis: str = "x", reps: int = 20
               ) -> dict:
    """The shift of one face along ``axis`` timed on this rank with CUDA
    events, every rank running the same loop: the post alone, the wait
    after it, the post and wait together, and the barrier alone (its own
    collective id); the plain shift (host-staged gloo) by the host clock;
    and the kernel's y against ``torch.roll`` of the gathered x."""
    import time

    import torch

    from tenzing_tpu_torch.models.halo import HALO_SPEC
    from tenzing_tpu_torch.ops import rdma
    from tenzing_tpu_torch.parallel.mesh import gather_buffer

    n, group = mesh.size(axis), mesh.group(axis)
    peers = rdma.ShiftPeers(axis, group, n, device)
    peer_y = peers.peer_recv("timing", y, 1, 0)
    stream = torch.cuda.Stream(device=device)
    cid, bar_cid = 0, rdma.MAX_COLLECTIVE_IDS - 1
    before = dict(rdma.LAUNCHES)

    def ev():
        return torch.cuda.Event(enable_timing=True)

    post, wait, both, barrier = [], [], [], []
    y.zero_()
    torch.cuda.synchronize(device)
    cp.barrier()
    for _ in range(reps):
        e = peers.next_epoch(cid)
        t0, t1, t2 = ev(), ev(), ev()
        with torch.cuda.stream(stream):
            t0.record(stream)
            rdma.rdma_shift_post(x, peer_y, peers.flags, peers.flag_block(1),
                                 peers.flag_block(-1), cid, e, peers.err)
            t1.record(stream)
            rdma.rdma_shift_wait(peers.flags, cid, e, peers.err)
            t2.record(stream)
        t2.synchronize()
        post.append(t0.elapsed_time(t1))
        wait.append(t1.elapsed_time(t2))
        both.append(t0.elapsed_time(t2))
    for _ in range(reps):
        e = peers.next_epoch(bar_cid)
        t0, t1 = ev(), ev()
        with torch.cuda.stream(stream):
            t0.record(stream)
            rdma.rdma_shift_barrier(peers.flags, peers.flag_block(1),
                                    peers.flag_block(-1), bar_cid, e,
                                    peers.err)
            t1.record(stream)
        t1.synchronize()
        barrier.append(t0.elapsed_time(t1))
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
    return {"axis": axis, "face_shape": list(x.shape), "reps": reps,
            "post_ms": median(post), "wait_ms": median(wait),
            "post_wait_ms": median(both), "barrier_ms": median(barrier),
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


if __name__ == "__main__":
    sys.exit(main())
