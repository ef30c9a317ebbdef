"""Shared CLI of the example programs.

Counterpart of ``examples/_driver.py`` (reference
``tenzing-mcts/examples/spmv_run_strategy.cuh``): argparse CLI, graph build,
platform, solver run, pipe-delimited CSV to stdout and the best schedule to
stderr.  ``--device`` picks where the schedules run (``cuda`` by default);
``--cpu`` means ``--device cpu``.  Each example calls :func:`setup` first:
the init gate's one-shot notice and the reproduce stamp, on stderr, as the
reference's drivers do.
"""

from __future__ import annotations

import argparse
import sys


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--benchmark-iters", type=int, default=50,
                    help="measurements per schedule (reference bench nIters=50)")
    ap.add_argument("--lanes", type=int, default=2, help="virtual lanes (streams)")
    ap.add_argument("--dump-csv", default=None, help="also write results to this path")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    ap.add_argument("--seed", type=int, default=0)


def add_mcts_args(ap: argparse.ArgumentParser) -> None:
    from tenzing_tpu_torch.solve.mcts import strategies

    ap.add_argument("--mcts-iters", type=int, default=300,
                    help="search iterations (reference spmv_run_strategy.cuh:125)")
    ap.add_argument("--strategy", default="FastMin",
                    choices=[s for s in dir(strategies)
                             if isinstance(getattr(strategies, s), type)
                             and issubclass(getattr(strategies, s), strategies.StrategyBase)
                             and s not in ("StrategyBase", "_SiblingNormalized")])
    ap.add_argument("--no-expand-rollout", action="store_true",
                    help="do not materialize rollout paths in the tree")
    ap.add_argument("--dump-tree", action="store_true",
                    help="periodic graphviz dumps of the search tree "
                         "(mcts_tree_<iteration>.dot in the working "
                         "directory)")


def setup(args) -> None:
    """The init gate and the reproduce stamp (reference drivers call
    tenzing::init + reproduce::dump_with_cli first,
    halo_run_strategy.hpp:23-27), both on stderr."""
    from tenzing_tpu_torch.utils import initgate, reproduce

    initgate.init()
    reproduce.dump_with_cli()


def device_of(args) -> str:
    """The device the example runs on: ``--cpu`` / ``--device``, else cuda
    (which raises without a card: ``resolve_device``)."""
    from tenzing_tpu_torch.runtime.executor import resolve_device

    if args.cpu and args.device not in (None, "cpu"):
        raise SystemExit("--cpu and --device disagree")
    return str(resolve_device("cpu" if args.cpu else args.device))


def spmv_setup(args):
    """(graph, platform, stream executor) of the examples' SpMV iteration:
    ``SpMVCompound()`` (the local exchange, no kernel menu) over the band
    matrix of ``--matrix-m`` rows or the ``--matrix`` .mtx file."""
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.spmv import (
        SpMVCompound,
        make_spmv_buffers,
        read_matrix_market,
    )
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

    device = device_of(args)
    mat = read_matrix_market(args.matrix) if args.matrix else None
    bufs, _ = make_spmv_buffers(m=args.matrix_m, nnz_per_row=args.nnz_per_row,
                                seed=args.seed, matrix=mat)
    g = Graph()
    g.start_then(SpMVCompound())
    g.then_finish(SpMVCompound())
    plat = Platform.make_n_lanes(args.lanes)
    ex = StreamExecutor(plat, buffers_from_numpy(bufs, device), device=device)
    return g, plat, ex


def emit(result, dump_csv_path=None) -> None:
    """Pipe-delimited rows to stdout (reference CSV dump), best to stderr."""
    text = result.dump_csv(dump_csv_path)
    sys.stdout.write(text)
    best = result.best()
    if best is not None:
        sys.stderr.write(
            f"best: pct10={best.result.pct10 * 1e6:.2f}us "
            f"pct50={best.result.pct50 * 1e6:.2f}us over {len(result.sims)} schedules\n"
        )
