"""MCTS schedule search on the single-device SpMV iteration DAG.

Counterpart of ``examples/spmv_mcts.py`` (reference
``tenzing-mcts/examples/spmv_{min_time,coverage,random}.cu`` via
``spmv_run_strategy.cuh``: band matrix m=150000, nnz=10m, 2 streams, MCTS
nIters=300), one program parametrized by ``--strategy``.
``python -m tenzing_tpu_torch.examples.spmv_mcts [--cpu] ...``.
"""

import argparse
import sys

from tenzing_tpu_torch.examples import _driver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    _driver.add_common_args(ap)
    _driver.add_mcts_args(ap)
    ap.add_argument("--matrix-m", type=int, default=150_000,
                    help="rows (reference spmv_run_strategy.cuh:44)")
    ap.add_argument("--nnz-per-row", type=int, default=10)
    ap.add_argument("--matrix", default=None,
                    help="MatrixMarket .mtx input instead of the random band "
                         "matrix (reference spmv.cu:35-37)")
    args = ap.parse_args(argv)
    _driver.setup(args)

    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore, strategies

    g, plat, ex = _driver.spmv_setup(args)
    res = explore(
        g, plat, EmpiricalBenchmarker(ex),
        MctsOpts(n_iters=args.mcts_iters,
                 bench_opts=BenchOpts(n_iters=args.benchmark_iters),
                 expand_rollout=not args.no_expand_rollout,
                 dump_tree=args.dump_tree, seed=args.seed),
        strategy=getattr(strategies, args.strategy),
    )
    _driver.emit(res, args.dump_csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
