"""The expert-parallel MoE layer on N ranks: ``python -m
tenzing_tpu_torch.parallel.dryrun --nproc N [--device cpu]``.

The port's counterpart of the MoE part of ``__graft_entry__.py``'s
``dryrun_multichip`` (its ``_agree_schedules`` protocol, :23-47).  Each rank
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

It runs on ``cuda`` over NCCL (rank r on GPU r; more ranks than visible
GPUs are refused) unless ``--device cpu`` is given, which runs over gloo.
``--nproc 1`` runs in this process; more start one process per rank
(parallel/launch.py).  The layer's width is the reference dryrun's on the
CPU (``DRYRUN_ARGS``) and the full one on the card (``FULL_ARGS``), which
``chip_smoke.py`` drives too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from tenzing_tpu_torch.models.moe import MoEArgs, MoELayer, make_moe_buffers

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
    # float32 (x64 off), and so does the port
    dt = np.dtype(args.dtype)
    bufs = {k: v.astype(dt) if v.dtype.kind == "f" else v
            for k, v in bufs.items()}
    local = shard_buffers(bufs, specs, mesh, device)
    plat = Platform.make_n_lanes(2, mesh=mesh, specs=specs)
    ex = StreamExecutor(plat, local, device=torch.device(device).type)
    return Layer(args=args, mesh=mesh, graph=layer_graph(args, **graph_kw),
                 platform=plat, executor=ex, specs=specs,
                 want=torch.from_numpy(want).to(device))


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
        ok = bool(torch.allclose(y, layer.want, **Y_TOL))
        slots = ffn_slots(order)
        row = {"schedule": i, "ops": len(order), "ffn_slots": slots,
               "y_max_abs_err": float((y - layer.want).abs().max()),
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
        raise AssertionError(f"Y of schedules {bad} is not within {Y_TOL} of "
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
    initial buffers; rank 0 returns the gathered Y of each (numpy), the
    others None."""
    from tenzing_tpu_torch.core.serdes import sequence_from_json

    layer = build_layer(mesh, device, MoEArgs(**args), seed=seed, **graph_kw)
    out = [run_gathered(layer, sequence_from_json(js, layer.graph)).cpu().numpy()
           for js in schedules]
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
    p.add_argument("--nproc", type=int, default=1)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--mcts-iters", type=int, default=8)
    a = p.parse_args(argv)
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


def world_one(device: str, kwargs: Dict[str, Any]) -> dict:
    """World size 1 in this process: NCCL on GPU 0, or gloo on the CPU."""
    import torch

    from tenzing_tpu_torch.parallel.mesh import close_mesh, init_mesh
    from tenzing_tpu_torch.runtime.executor import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="tz_dryrun_") as d:
        mesh = init_mesh("ep", "nccl" if dev.type == "cuda" else "gloo",
                         "file://" + os.path.join(d, "rendezvous"), 0, 1)
        try:
            return rank_main(mesh, dev, **kwargs)
        finally:
            close_mesh()


if __name__ == "__main__":
    sys.exit(main())
