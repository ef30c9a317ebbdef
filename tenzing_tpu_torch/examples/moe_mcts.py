"""MCTS schedule search on the single-device MoE dispatch/combine pipeline.

Counterpart of ``examples/moe_mcts.py``: routed tokens staged through async
host round trips to the resident experts (models/moe_pipeline.py), searched
over order x lane x expert-kernel across the independent chunk chains, on
the reference's per-workload driver shape
(tenzing-mcts/examples/spmv_run_strategy.cuh) with ``--strategy`` picking the
search strategy.  The expert-MLP menu's ``.pallas`` slot is the
``ffn_batched`` kernel (csrc/ffn_expert.cu).
``python -m tenzing_tpu_torch.examples.moe_mcts [--cpu] ...``.
"""

import argparse
import sys

from tenzing_tpu_torch.examples import _driver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    _driver.add_common_args(ap)
    _driver.add_mcts_args(ap)
    ap.add_argument("--tokens", type=int, default=8192)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--d-ff", type=int, default=2048)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--no-impl-choice", action="store_true",
                    help="drop the expert-MLP kernel menu")
    args = ap.parse_args(argv)
    _driver.setup(args)

    from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.moe_pipeline import (
        MoEPipeArgs,
        build_graph,
        host_buffer_names,
        make_pipe_buffers,
    )
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore, strategies

    device = _driver.device_of(args)
    margs = MoEPipeArgs(n_experts=args.experts, tokens=args.tokens,
                        d_model=args.d_model, d_ff=args.d_ff,
                        n_chunks=args.chunks)
    bufs, _, cap = make_pipe_buffers(margs, seed=args.seed, with_expected=False)
    g = build_graph(margs, cap, impl_choice=not args.no_impl_choice)
    plat = Platform.make_n_lanes(args.lanes)
    ex = StreamExecutor(plat, buffers_from_numpy(bufs, device,
                                                 host_buffer_names(margs)),
                        device=device)
    del bufs
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
