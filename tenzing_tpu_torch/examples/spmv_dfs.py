"""Exhaustive DFS schedule enumeration on the SpMV iteration DAG.

Counterpart of ``examples/spmv_dfs.py`` (reference ``tenzing-dfs/examples/spmv.cu``:
maxSeqs=15000 cap, band matrix, benchmark every deduplicated complete
schedule).  ``python -m tenzing_tpu_torch.examples.spmv_dfs [--cpu] ...``.
"""

import argparse
import sys

from tenzing_tpu_torch.examples import _driver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    _driver.add_common_args(ap)
    ap.add_argument("--matrix-m", type=int, default=150_000)
    ap.add_argument("--nnz-per-row", type=int, default=10)
    ap.add_argument("--max-seqs", type=int, default=15_000,
                    help="enumeration cap (reference spmv.cu:117)")
    ap.add_argument("--matrix", default=None,
                    help="MatrixMarket .mtx input instead of the random band "
                         "matrix (reference spmv.cu:35-37)")
    ap.add_argument("--batch", action="store_true",
                    help="decorrelated batch benchmarking: every schedule "
                         "visited once per iteration in random order "
                         "(reference benchmarker.cpp:21-76)")
    args = ap.parse_args(argv)
    _driver.setup(args)

    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
    from tenzing_tpu_torch.solve.dfs import DfsOpts, explore

    g, plat, ex = _driver.spmv_setup(args)
    res = explore(
        g, plat, EmpiricalBenchmarker(ex),
        DfsOpts(max_seqs=args.max_seqs,
                bench_opts=BenchOpts(n_iters=args.benchmark_iters),
                batch=args.batch, batch_seed=args.seed),
    )
    _driver.emit(res, args.dump_csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
