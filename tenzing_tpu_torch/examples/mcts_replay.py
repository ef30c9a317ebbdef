"""Replay-driven MCTS: search a recorded result database instead of a device.

Counterpart of ``examples/mcts_replay.py`` (reference
``tenzing-mcts/examples/mcts_csv_*.cu``, built on CsvBenchmarker,
benchmarker.cpp:169-223): each strategy runs MCTS against the recorded
timings, and the report says how quickly it found the database's best
schedule.  Rollouts are matched modulo redundant-sync cleanup
(``CsvBenchmarker(normalize=True)``); a rollout that lands on an unrecorded
schedule scores as the database's worst full-fidelity result, and the misses
are counted.

The graphs: ``--workload halo`` is the driver's full-size halo graph (nQ=3,
512^3, radius 3, kernel and transfer-engine menus), so a database the driver
dumped (``python -m tenzing_tpu_torch.bench --dump-csv PATH``) replays here;
``--workload spmv`` is the SpMV examples' graph.  No device is used.
``python -m tenzing_tpu_torch.examples.mcts_replay --csv PATH [--workload halo]``.
"""

import argparse
import sys

from tenzing_tpu_torch.examples import _driver
from tenzing_tpu_torch.utils.cli import write_line


def replay_graph(workload: str):
    """The graph a database's rows resolve against (module docstring)."""
    from tenzing_tpu_torch.core.graph import Graph

    if workload == "halo":
        from tenzing_tpu_torch.models.halo import HaloArgs
        from tenzing_tpu_torch.models.halo_pipeline import build_graph

        return build_graph(HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3),
                           impl_choice=True, xfer_choice=True)
    from tenzing_tpu_torch.models.spmv import SpMVCompound

    g = Graph()
    g.start_then(SpMVCompound())
    g.then_finish(SpMVCompound())
    return g


def recorded_best(path: str) -> float:
    """The least pct50 over the full-fidelity rows of the file, read as
    numbers: rows that do not resolve against the graph still count, so the
    optimum cannot improve because its row is unmatchable."""
    from tenzing_tpu_torch.bench.benchmarker import CSV_DELIM, split_fidelity

    def row_pct50(line):
        parts = line.split(CSV_DELIM)
        try:
            if split_fidelity(parts)[0] != "full":
                return float("inf")
            return float(parts[3])
        except (IndexError, ValueError):
            return float("inf")

    with open(path) as f:
        return min((row_pct50(line) for line in f if line.strip()),
                   default=float("inf"))


class PessimisticReplay:
    """A recorded database as a benchmarker: an unrecorded schedule scores
    as the worst full-fidelity result, and is counted in ``misses``."""

    def __init__(self, inner):
        self.inner = inner
        full = [r for (_, r), f in zip(inner.entries, inner.fidelities)
                if f == "full"] or [r for _, r in inner.entries]
        self.worst = max(full, key=lambda r: r.pct50)
        self.misses = 0

    def benchmark(self, order, opts=None):
        try:
            return self.inner.benchmark(order, opts)
        except KeyError:
            self.misses += 1
            return self.worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    _driver.add_common_args(ap)
    ap.add_argument("--csv", required=True, help="recorded result database")
    ap.add_argument("--workload", choices=("spmv", "halo"), default="spmv",
                    help="the graph the database rows resolve against")
    ap.add_argument("--mcts-iters", type=int, default=64)
    ap.add_argument("--strategies", default="Random,FastMin,Coverage,AntiCorrelation",
                    help="comma-separated strategy names to compare")
    args = ap.parse_args(argv)
    _driver.setup(args)

    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, CsvBenchmarker
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore, strategies

    g = replay_graph(args.workload)
    db = CsvBenchmarker.from_file(args.csv, g, normalize=True, strict=False)
    if not db.entries:
        raise SystemExit(
            f"no row of {args.csv} resolves against the --workload "
            f"{args.workload} graph ({len(db.skipped)} skipped)")
    best = recorded_best(args.csv)
    skipped = f", {len(db.skipped)} rows unmatchable for replay" if db.skipped else ""
    sys.stderr.write(f"database: {len(db.entries)} schedules{skipped}, best "
                     f"pct50 {best*1e6:.1f}us\n")
    plat = Platform.make_n_lanes(args.lanes)
    for name in args.strategies.split(","):
        replay = PessimisticReplay(db)
        res = explore(g, plat, replay,
                      MctsOpts(n_iters=args.mcts_iters, bench_opts=BenchOpts(),
                               seed=args.seed),
                      strategy=getattr(strategies, name))
        best_so_far, hit_at = float("inf"), None
        for i, s in enumerate(res.sims):
            best_so_far = min(best_so_far, s.result.pct50)
            if hit_at is None and best_so_far <= best:
                hit_at = i
        miss = f", {replay.misses} unrecorded rollouts" if replay.misses else ""
        write_line(f"{name}: best {best_so_far*1e6:.1f}us over {len(res.sims)} "
                   f"benchmarked rollouts{miss}; recorded optimum "
                   f"{'hit at iter %d' % hit_at if hit_at is not None else 'not reached'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
