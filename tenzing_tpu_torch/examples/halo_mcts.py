"""MCTS schedule search on the 3D halo exchange over a mesh of ranks.

Counterpart of ``examples/halo_mcts.py`` (reference
``tenzing-mcts/examples/halo_{min_time,coverage,anticorr,balance}.cu`` via
``halo_run_strategy.hpp``: nQ=3, 512^3 cells a rank, radius 3, 2 streams; the
rank grid from the prime factors of the world size), with ``--strategy``
picking the search strategy.  The mesh halo is models/halo.py's
``HaloExchange``, one process a rank (parallel/launch.py):

* ``--nproc 1`` (the default) runs world size 1 in this process: NCCL on
  the card, gloo with ``--cpu``;
* ``--nproc N`` starts N ranks: on the card one GPU each, on the CPU over
  gloo;
* ``--shared-card`` puts every rank on GPU 0 (over gloo, the only way two
  ranks fit on one card); there only the ``.rdma`` shift exchanges data, so
  every post is one, where elsewhere every post is a ``PermuteStart``
  (``.xla``), as in the reference example.

Rank 0 prints the CSV rows on stdout and the best schedule on stderr.
``python -m tenzing_tpu_torch.examples.halo_mcts [--cpu] [--nproc N] ...``.
"""

import argparse
import sys

from tenzing_tpu_torch.examples import _driver

AXES = ("x", "y", "z")


def mesh_shape_for(n: int):
    """Near-cubic 3D factorization of the rank count (reference
    halo_run_strategy.hpp:80-98, the reference example's ``mesh_shape_for``)."""
    from tenzing_tpu_torch.utils.numeric import prime_factors

    dims = [1, 1, 1]
    for f in sorted(prime_factors(n), reverse=True):
        dims[dims.index(min(dims))] *= f
    return tuple(sorted(dims, reverse=True))


def halo_graph(hargs, engine: str):
    """``HaloExchange`` with every post on ``engine``: the compound itself
    for ``"xla"`` (the reference example's graph), the same chains with
    ``.rdma`` shifts otherwise."""
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.models.halo import HaloExchange, add_to_graph

    if engine != "xla":
        return add_to_graph(Graph(), hargs, engine=engine)
    g = Graph()
    he = HaloExchange(hargs)
    g.start_then(he)
    g.then_finish(he)
    return g


def rank_search(mesh, device, args, engine: str, lanes: int, mcts_iters: int,
                benchmark_iters: int, strategy: str, expand_rollout: bool,
                seed: int = 0, dump_tree: bool = False):
    """One rank's search (a parallel/launch.py task): every rank measures
    every schedule through the control plane; rank 0 returns ``(CSV text,
    best pct10, best pct50, schedules)``, the others None."""
    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.dryrun import build_halo
    from tenzing_tpu_torch.parallel.mesh import control_group
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore, strategies

    cp = DistControlPlane(control_group())
    hargs = HaloArgs(**args)
    h = build_halo(mesh, device, hargs, seed=seed, lanes=lanes)
    res = explore(
        halo_graph(hargs, engine), h.platform,
        EmpiricalBenchmarker(h.executor, control_plane=cp),
        MctsOpts(n_iters=mcts_iters,
                 bench_opts=BenchOpts(n_iters=benchmark_iters),
                 expand_rollout=expand_rollout, dump_tree=dump_tree,
                 seed=seed),
        strategy=getattr(strategies, strategy), control_plane=cp)
    if cp.rank() != 0:
        return None
    best = res.best()
    return (res.dump_csv(), best.result.pct10 if best else None,
            best.result.pct50 if best else None, len(res.sims))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    _driver.add_common_args(ap)
    _driver.add_mcts_args(ap)
    ap.add_argument("--nq", type=int, default=3)
    ap.add_argument("--cells", type=int, default=512,
                    help="cells per rank per axis (reference 512)")
    ap.add_argument("--radius", type=int, default=3, help="ghost radius")
    ap.add_argument("--nproc", type=int, default=1, help="ranks")
    ap.add_argument("--shared-card", action="store_true",
                    help="every rank on GPU 0, every exchange the .rdma shift")
    args = ap.parse_args(argv)
    _driver.setup(args)

    device = _driver.device_of(args)
    kwargs = dict(args={"nq": args.nq, "lx": args.cells, "ly": args.cells,
                        "lz": args.cells, "radius": args.radius},
                  engine="rdma" if args.shared_card else "xla",
                  lanes=args.lanes,
                  mcts_iters=args.mcts_iters,
                  benchmark_iters=args.benchmark_iters,
                  strategy=args.strategy,
                  expand_rollout=not args.no_expand_rollout, seed=args.seed,
                  dump_tree=args.dump_tree)
    if args.nproc == 1 and not args.shared_card:
        from tenzing_tpu_torch.parallel.dryrun import world_one

        out = world_one(device, kwargs, fn=rank_search, axes=AXES)
    else:
        from tenzing_tpu_torch.parallel.launch import launch

        out = launch("tenzing_tpu_torch.examples.halo_mcts:rank_search",
                     args.nproc, device.split(":")[0], kwargs,
                     timeout_s=3000.0, mesh_axes=AXES,
                     mesh_shape=mesh_shape_for(args.nproc),
                     shared_card=args.shared_card)[0]
    text, pct10, pct50, n = out
    if args.dump_csv:
        with open(args.dump_csv, "w") as f:
            f.write(text)
    sys.stdout.write(text)
    if pct10 is not None:
        sys.stderr.write(f"best: pct10={pct10 * 1e6:.2f}us "
                         f"pct50={pct50 * 1e6:.2f}us over {n} schedules\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
