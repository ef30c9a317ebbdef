#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, each printing one JSON line (details also go to
``chiprun_out/chip_smoke.jsonl``); any failure raises and exits non-zero
before the last line:

1. device   — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build    — builds the hand-written CUDA kernels from ``tenzing_tpu_torch/csrc``
              (ops/kernel_lib.py) and reports the build time;
3. kernels  — at the 512^3 flagship shapes, for each of the six faces and each
              kernel slot on its menu, ``halo_pack`` and ``halo_unpack`` against
              their plain PyTorch versions, and ``device_copy`` against
              ``copy_``: bit-exact (tolerance 0, pure data movement), with the
              kernel's, the plain version's and the library call's times and
              the bytes bound;
4. executor — the naive, greedy host/rdma/mixed, alias and all-kernel orders on
              8 lanes through ``StreamExecutor``: the final grid must be
              bit-identical to the same order run with every kernel replaced by
              its plain version on the card, and to the expected grid; timed
              runs must leave every buffer's ``data_ptr`` unchanged;
5. driver   — ``tenzing_tpu_torch.bench.driver.run`` at ``halo_n=512`` with a
              small budget; ``verified`` must be true and each halo kernel's
              launch count over this run must be > 0;
6. attn kernels  — at the full-width attention shapes (batch 4, 8192
              queries, head dim 128): ``attn_block`` (f32 and bf16 inputs) on a
              1024-key block from the initial state and from the state after
              three folds, ``attn_fused`` (f32 and bf16) over all 8192 keys,
              and a ragged block (1 x 1000 queries): each against its plain
              PyTorch version on the card, as m, l and acc / l, at
              ``F32_STATE_TOL`` / ``BF16_STATE_TOL`` (ops/attention_kernels.py);
              every bf16 row also holds three deliberately faulty plain folds
              (p left unrounded, V truncated, nothing rounded) against the
              same plain version and fails if the tolerance accepts any of
              them; the fused rows hold O = acc / l against the dense float64
              attention (``F32_O_TOL`` / ``BF16_O_TOL``; the controls' O is
              reported beside it).  Each row carries the kernel's, the plain
              version's and (fused) ``scaled_dot_product_attention``'s times
              and the bound;
7. attn executor — the naive (all ``.xla``), ``.pallas`` on 2 lanes,
              ``.pallas_bf16``, ``.fused``, ``.fused_bf16`` and a mixed order
              at full width through ``StreamExecutor``, each against the same
              order with plain kernels and against the dense float64 expected
              O (the same tolerances); timed runs must keep every
              ``data_ptr``;
8. attn driver   — ``run`` with ``workload="attn"`` at full width and a small
              budget: the metric must be ``attn_blockwise_pct50_searched_n8192``,
              both attention kernels must launch > 0 times, and the result is
              verified or its winner was demoted with only ``acc``/``O``
              diverging (bf16 rounding against the f32 naive chain; the
              demoted schedule's O must then be within ``BF16_O_TOL`` of the
              expected);
9.  moe kernels  — ``ffn_batched`` at the main path's shapes (chunk 0's slot
              table of the full-width pipeline: 8 experts x 304 slots, d 512,
              d_ff 2048) and at ragged ones (1 slot, 257 slots, d_ff 520)
              against its plain version on the card at ``FFN_TOL``; the erf
              gelu control must be rejected, a second launch must give the
              same bits; the kernel's, the plain version's and the
              ``bmm -> gelu -> bmm`` three-call times beside the bound;
10. moe executor — naive, the four greedy incumbents and two all-``.pallas``
              completions of the choice graph (f32 and bf16 device-copy
              staging) at full width on 2 lanes through ``StreamExecutor``: Y
              against the same order with plain kernels and against the
              float64 dense expected output (``F32_Y_TOL``, or
              ``BF16_Y_TOL`` for bf16 staging, which must reject a control
              with one expert's gate weights dropped); timed runs keep every
              ``data_ptr`` and allocate nothing;
11. moe driver   — ``run`` with ``workload="moe"`` at full width and a small
              budget with climbs: the metric must be
              ``moe_pipe_pct50_searched_t8192``, ``ffn_batched`` and
              ``device_copy`` must launch > 0 times, the climb must have
              spent budget, and the result is verified or its winner was
              demoted with only Y / Y_c diverging and the demoted schedule's
              Y within ``BF16_Y_TOL`` of the expected;
12. spmv kernels — ``ell_spmv`` at the ``--m 8192`` path's ``spmv_remote``
              shapes (a (8192, 22) slab, x of 4093) and at ragged ones (m not
              a multiple of a block, w = 1, n = 1, n = 4096, w above a warp)
              against its plain version at ``ELL_TOL``; a control with one
              slab column dropped must be rejected, a second launch must give
              the same bits; the kernel's, the plain version's and cuSPARSE's
              (``torch.sparse_csr_tensor @ x``) times beside the bound;
13. spmv executor — naive, the 2-lane overlap order and the all-kernel
              order at m=8192, naive and the overlap order at m=150000,
              through ``StreamExecutor``: y against the same order with plain
              kernels and against the float64 product, ``data_ptr``s kept, no
              allocation in timed runs;
14. fused   — every tile count on the pruned menu of the naive and overlap
              orders at m=150000 (the host exchange: two regions), and the
              examples' local-exchange graph (one five-member region with a
              grid-wide barrier), through ``FusedExecutor`` with the
              ``fused_region`` kernel against the plain region at
              ``REGION_TOL`` and against the float64 product; a control with
              one remote slab column dropped must be rejected; each region's
              kernel, plain and stepped-members times beside the bound;
15. fused sweep — every structurally valid tile count of the naive
              order's regions at m=150000 and m=8192: the fused
              order against plain regions and the float64 product, and each
              region's kernel time beside its tile's share of the traffic
              (the rows ``bench/roofline.MIN_TILE_BYTES`` is set from);
16. spmv driver — ``run`` with ``workload="spmv"`` at m=150000 with
              ``fuse_winner`` and ``fuse_search_tiles``: verified, the fused
              program verified with at least one region, ``fused_region``
              launched > 0 times; then at ``m=8192``: verified, ``ell_spmv``
              launched > 0 times;
17. dfs example — ``python -m tenzing_tpu_torch.examples.spmv_dfs`` at
              ``--matrix-m 150000`` with a cap of 12 schedules: it must measure
              at least one and print ``best:``, and the count of unique
              terminals the same enumeration gives is printed beside it.

Run after the attn driver (phase 8):

8a. attn fused — the attention members of ``fused_region`` at full width:
              the naive ``.xla`` order (one region: 8 folds + finalize), a
              2-lane order, and the naive order with every fold chunked 2
              and 4 ways, at every tile count of their menus, against the
              plain region (m, l, acc / l and O at ``F32_STATE_TOL``) and
              the dense expected O (``F32_O_TOL``); two launches must be
              bitwise equal, and a fold member whose key offset is one block
              off must be rejected; each naive region's kernel time at every
              tile count, and each region's at one tile beside the stepped
              members, the plain region and the operations bound, with one
              f32 ``scaled_dot_product_attention`` as the yardstick;
8b. attn fused driver — ``run`` with ``workload="attn"``,
              ``fuse_winner`` and ``fuse_search_tiles``: ``perf.fused`` and
              a planted ``perf.fuse_search_tiles``, ``fused_region``
              launched > 0 times; the fused block verified, or reported as
              diverged by the reference's gate (the run raises if the fused
              outputs fail the members' own tolerance); the result verified
              or demoted as in phase 8.

Run after the moe driver (phase 11):

11a. chunk  — at full width, the chunked orders against the unchunked ones
              at every valid count: attention's naive order with sub-folds
              (``F32_STATE_TOL``, O against the expected), the moe orders
              with expert partials under f32 and bf16 staging (Y within one
              f32 / bf16 ulp of the unchunked Y and within ``F32_Y_TOL`` /
              ``BF16_Y_TOL`` of the expected), each verified; then the
              full-size pruned menus and the card's chunk constants of
              ``bench/roofline.py`` measured: the stream executor's per-op
              host dispatch and the pinned host <-> device copy rate;
11b. host syncs — the moe pipeline's chunked and unchunked orders (f32 chains
              on the host and on the device copy) and attention's naive
              order with its folds unchunked and chunked 2 and 4 ways, each
              with every EventSync blocking the host and with the host syncs
              deferred (runtime/executor.py): outputs bit-equal, in turns
              each one's wall, ``breakdown.py``'s idle share and the host
              blocks per iteration;
11c. chunk driver — ``run`` with ``chunk`` on attn and moe: a
              ``perf.chunked`` block with menus, verified or demoted as the
              plain runs may be;
11d. moe layer kernels — ``ffn_rows`` at one chunk of the expert-parallel
              MoE layer at world size 1 (n 2048, d 512, d_ff 2048) and at
              ragged n (2047, 37) against its plain version at ``FFN_TOL``,
              the erf control rejected, two launches bit-equal; the
              kernel's, the plain version's and the three-call times beside
              the bound;
11e. moe layer — the layer (models/moe.py) at full width on a world-size-1
              NCCL group made here: the dryrun's agreement protocol
              (parallel/dryrun.py; an all-``.xla``, an all-``.pallas`` and a
              mixed schedule within ``rtol=2e-4, atol=2e-5`` of the float64
              Y, ``ffn_rows`` launched), a dropped-expert control that must
              be rejected, the self all-to-all's time per chunk, and a
              12-iteration ``explore`` through ``DistControlPlane``; then
              the same layer in bf16: the agreement within
              ``dryrun.Y_TOL_BF16`` of the float64 Y cast to bf16, the bf16
              ``ffn_rows`` launched, the dropped-expert control rejected
              (11d also holds the bf16 ``ffn_rows`` against its plain
              version at ``FFN_BF16_TOL``, with a skipped-hidden-tile
              control, and times it);
11f. mesh halo — the mesh halo exchange (models/halo.py) at the flagship
              width per rank (nQ 3, 512^3, radius 3) on a world-size-1 NCCL
              group and a 1x1x1 mesh: the dryrun's agreement (three
              ``HaloExchange`` schedules, then the engine menu's all-``.xla``,
              all-``.rdma`` and mixed orders), U bit-exact against
              ``make_halo_buffers``' expected array, then a 12-iteration
              MCTS on the engine menu; the engines explored and each
              iteration's time;
11g. mesh halo shared — two ranks on GPU 0 over gloo (parallel/launch.py
              ``shared_card``), a 2x1x1 mesh, every exchange ``.rdma``: the
              x faces through the ``rdma_shift_post`` / ``rdma_shift_wait``
              kernels (CUDA IPC between the two processes), y and z through
              the loopback; each rank's U bit-exact, both kernels launched
              on both ranks (each rank zeroes its counts before the run and
              reads them after), the write-after-read probe (three runs back
              to back, the interior bumped each run and a delay before each
              unpack) exact, and one x face's shift timed (post, wait, both,
              the barrier alone, the plain host-staged shift) and held
              against ``torch.roll`` of the gathered faces.

The halo and attn driver phases run with ``climb_budget=4`` (the halo climbs
run; the reference runs none for attn).  Each driver phase sets every
kernel's launch count to 0 just before it and reads the counts just after.  Then the ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device it prints nothing and exits 2.  Times are CUDA-event times on the
card this runs on.
"""

import json
import os
import subprocess
import sys
import time
from dataclasses import asdict

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores (data sheet)
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores (data sheet)
# O against the dense float64 attention: f32 inputs at the reference's f32
# tolerance (tests/test_ring_attention.py:76); bf16 inputs at twice the
# error that rounding q/k/v and p gives at this size (PERF.md, PR 2).  The
# rounding itself dominates there, so the faults the bf16 state tolerance
# catches do not show in this check: it catches gross ones.
F32_O_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_O_TOL = dict(rtol=0.0, atol=1e-3)
# Y of the MoE pipeline against the float64 dense expected output.  f32
# staging: within 8.2e-6 of float64 at full width on an H100 (PERF.md).
# bf16 staging rounds the dispatched tokens and the expert outputs: there Y
# read a relative rms error of 2.4e-3 and a largest error of 1.2e-2
# (PERF.md); the limits sit at about 2x and 2.5x those, and a control with
# one expert's gate weights dropped (rel rms ~0.38) must fail them.
F32_Y_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_Y_TOL = {"rel_rms": 5e-3, "max_abs": 3e-2}
# Y of one order with kernels against the same order with plain kernels:
# f32 at the kernel's tolerance; bf16 within one bf16 ulp of the expert
# outputs (an f32 summation difference can flip an output's rounding)
F32_PLAIN_Y_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_PLAIN_Y_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
# The expert-parallel MoE layer's configuration on one card (models/moe.py):
# the width of the repo's MoE model (MoEPipeArgs: d_model 512, d_ff 2048,
# 8192 tokens, 4 chunks) at world size 1, where every token routes to the one
# expert and each chunk's expert MLP is ffn_rows at n = 2048
MOE_LAYER = dict(n_ep=1, tokens_per_shard=8192, d_model=512, d_ff=2048,
                 n_chunks=4)  # parallel/dryrun.py FULL_ARGS at n_ep 1
MOE_LAYER_ITERS = 12  # the layer's explore through DistControlPlane
MESH_HALO_ITERS = 12  # the mesh halo's MCTS on the engine menu
HOST_SYNC_ITERS = 15  # iterations per measurement of the host_syncs phase
FLUSH_BYTES = 128 << 20  # > the 50 MB L2: each timed launch starts cold
REPS = 15

_log = None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    _log.write(line + "\n")
    _log.flush()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of single launches, each after an L2 flush.

    A spin kernel ahead of each timed launch keeps the card busy while the
    host enqueues the flush, the events and the launch, so the interval
    between the two events holds the launch's device time and not the
    host's Python overhead of issuing it."""

    SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: longer than enqueueing

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(FLUSH_BYTES // 4, device=device)

    def ms(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush_buf.fill_(1.0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def bound_ms(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def attn_bound(nbytes: float, flops: float, bf16: bool):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _launch_counts():
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.ops import ffn_kernels as fk
    from tenzing_tpu_torch.ops import fused_region as fr
    from tenzing_tpu_torch.ops import halo_kernels as hk
    from tenzing_tpu_torch.ops import rdma
    from tenzing_tpu_torch.ops import spmv_kernels as sk

    return (hk.LAUNCHES, rdma.LAUNCHES, ak.LAUNCHES, fk.LAUNCHES, sk.LAUNCHES,
            fr.LAUNCHES)


def reset_launches():
    for counts in _launch_counts():
        for k in counts:
            counts[k] = 0


def all_launches():
    out = {}
    for counts in _launch_counts():
        out.update(counts)
    return out


def phase_kernels(torch, device, timer):
    """Every kernel slot at the flagship shapes against its plain version."""
    from tenzing_tpu_torch.models.halo import (
        DIRECTIONS,
        HaloArgs,
        _face_slices,
        dir_name,
        face_view,
    )
    from tenzing_tpu_torch.models.halo_pipeline import _padded_shape
    from tenzing_tpu_torch.ops import halo_kernels as hk
    from tenzing_tpu_torch.ops import rdma

    args = HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    u = torch.rand(_padded_shape(args.local_shape()), device=device,
                   generator=gen)
    summary = {"halo_pack": [], "halo_unpack": [], "device_copy": []}
    slots = {".pallas": (False, False), ".pallasb": (True, False),
             ".pallasf": (True, True)}  # suffix -> (batched, flat)
    for d in DIRECTIONS:
        name = dir_name(d)
        starts, sizes = _face_slices(args, d, "pack")
        ustarts, _ = _face_slices(args, d, "unpack")
        n = int(sizes[0] * sizes[1] * sizes[2] * sizes[3])
        rows = -(-n // 128)
        pack_menu = [c.name()[len(f"pack_{name}"):]
                     for c in hk.PackChoice(args, d).choices()]
        unpack_menu = [c.name()[len(f"unpack_{name}"):]
                       for c in hk.UnpackChoice(args, d).choices()]
        face_bytes = 2 * n * 4
        recv = None
        for suffix in pack_menu:
            if suffix not in slots:
                continue
            batched, flat = slots[suffix]
            rpb = hk._rows_per_block(u, starts, sizes) if batched else 1
            shape = (rows, 128) if flat else tuple(sizes)
            got = torch.zeros(shape, device=device)
            want = torch.zeros(shape, device=device)
            hk.halo_pack(u, got, starts, sizes, rpb)
            hk.halo_pack_plain(u, want, starts, sizes)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"halo_pack{suffix} {name}: differs from "
                                     f"its plain version (max abs err {err})")
            uview = face_view(u, starts, sizes)
            face4d = want.view(-1)[:n].view(tuple(sizes))
            row = {"kernel": "halo_pack", "face": name, "slot": suffix,
                   "rows_per_block": rpb, "shape": list(sizes), "exact": True,
                   "max_abs_err": err,
                   "ms": timer.ms(lambda: hk.halo_pack(u, got, starts, sizes, rpb)),
                   "plain_ms": timer.ms(
                       lambda: hk.halo_pack_plain(u, want, starts, sizes)),
                   "library_ms": timer.ms(lambda: face4d.copy_(uview)),
                   "bound_ms": bound_ms(face_bytes)}
            emit(row)
            summary["halo_pack"].append(row)
            recv = want.view(-1)[:n].clone()
        staging = torch.zeros(rows * 128, device=device)
        staging[:n] = recv
        for suffix in unpack_menu:
            if suffix not in slots:
                continue
            batched, _ = slots[suffix]
            rpb = hk._rows_per_block(u, ustarts, sizes) if batched else 1
            ug, uw = u.clone(), u.clone()
            hk.halo_unpack(ug, staging, ustarts, sizes, rpb)
            hk.halo_unpack_plain(uw, staging, ustarts, sizes)
            torch.cuda.synchronize()
            same = torch.equal(ug, uw)
            err = float((face_view(ug, ustarts, sizes)
                         - face_view(uw, ustarts, sizes)).abs().max())
            if not same:
                raise AssertionError(f"halo_unpack{suffix} {name}: differs "
                                     f"from its plain version (max abs err {err})")
            del uw
            uview = face_view(ug, ustarts, sizes)
            face4d = staging[:n].view(tuple(sizes))
            row = {"kernel": "halo_unpack", "face": name, "slot": suffix,
                   "rows_per_block": rpb, "shape": list(sizes), "exact": True,
                   "max_abs_err": err,
                   "ms": timer.ms(
                       lambda: hk.halo_unpack(ug, staging, ustarts, sizes, rpb)),
                   "plain_ms": timer.ms(
                       lambda: hk.halo_unpack_plain(ug, staging, ustarts, sizes)),
                   "library_ms": timer.ms(lambda: uview.copy_(face4d)),
                   "bound_ms": bound_ms(face_bytes)}
            emit(row)
            summary["halo_unpack"].append(row)
            del ug
        src = staging.view(rows, 128)
        dst = torch.zeros_like(src)
        rdma.device_copy(src, dst)
        ref = torch.zeros_like(src)
        rdma.device_copy_plain(src, ref)
        torch.cuda.synchronize()
        err = float((dst - ref).abs().max())
        if not torch.equal(dst, ref):
            raise AssertionError(f"device_copy {name}: differs from copy_")
        row = {"kernel": "device_copy", "face": name, "slot": ".rdma",
               "shape": [rows, 128], "exact": True, "max_abs_err": err,
               "ms": timer.ms(lambda: rdma.device_copy(src, dst)),
               "plain_ms": timer.ms(lambda: rdma.device_copy_plain(src, ref)),
               "library_ms": timer.ms(lambda: dst.copy_(src)),
               "bound_ms": bound_ms(2 * rows * 128 * 4)}
        emit(row)
        summary["device_copy"].append(row)
    del u
    torch.cuda.empty_cache()
    return summary


def phase_executor(torch, device):
    """Whole schedules through the stream executor, kernels vs plain."""
    from tenzing_tpu_torch.bench.driver import halo_alias_prefer
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import (
        HALO_PHASES,
        build_graph,
        greedy_overlap_order,
        host_buffer_names,
        make_pipeline_buffers,
        naive_order,
    )
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.solve.local import drive, phase_policy
    from tenzing_tpu_torch.verify import ScheduleVerifier

    args = HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3)
    t0 = time.time()
    bufs, want = make_pipeline_buffers(args, seed=0, with_expected=True)
    want_dev = torch.from_numpy(want).to(device)
    del want
    tbufs = buffers_from_numpy(bufs, device, host_buffer_names())
    del bufs
    setup_s = time.time() - t0
    plat = Platform.make_n_lanes(8)
    kern = StreamExecutor(plat, tbufs, device="cuda")
    plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
    choice_g = build_graph(args, impl_choice=True, xfer_choice=True)

    def prefer_kernels(op_name, choices):
        if op_name.startswith("xfer_"):
            return next(c for c in choices if c.endswith(".rdma"))
        for suffix in (".pallasf", ".pallasb", ".pallas"):
            hit = next((c for c in choices if c.endswith(suffix)), None)
            if hit is not None:
                return hit
        return None

    orders = {
        "naive": (naive_order(args, plat), build_graph(args)),
        "greedy-host-8l": (greedy_overlap_order(args, plat, "host"),
                           build_graph(args, engine="host")),
        "greedy-rdma-8l": (greedy_overlap_order(args, plat, "rdma"),
                           build_graph(args, engine="rdma")),
        "greedy-mixed-8l": (greedy_overlap_order(args, plat, "mixed"),
                            build_graph(args, engine="mixed")),
        "alias-8l": (drive(choice_g, plat, phase_policy(
            plat, HALO_PHASES, halo_alias_prefer))[0], choice_g),
        "kernels-8l": (drive(choice_g, plat, phase_policy(
            plat, HALO_PHASES, prefer_kernels))[0], choice_g),
    }
    rows = []
    for label, (order, graph) in orders.items():
        if not ScheduleVerifier(graph)(order).ok:
            raise AssertionError(f"executor phase: {label} is not sound")
        t0 = time.time()
        out_k = kern.run(order)
        out_p = plain.run(order)
        same_plain = all(torch.equal(out_k[k], out_p[k]) for k in out_k)
        same_want = torch.equal(out_k["U"], want_dev)
        del out_k, out_p
        ptrs = {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        kern.prepare_n(order)(3)
        ptrs_ok = ptrs == {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        timed_ok = torch.equal(kern.init_bufs["U"], want_dev)
        row = {"phase": "executor", "order": label, "ops": len(order),
               "equal_plain": same_plain, "equal_expected": same_want,
               "data_ptr_unchanged": ptrs_ok, "timed_runs_expected": timed_ok,
               "wall_s": round(time.time() - t0, 3)}
        emit(row)
        rows.append(row)
        if not (same_plain and same_want and ptrs_ok and timed_ok):
            raise AssertionError(f"executor phase failed on {label}: {row}")
    del kern, plain, tbufs, want_dev
    torch.cuda.empty_cache()
    return {"setup_s": round(setup_s, 3), "orders": len(rows)}


def attn_full_args():
    from tenzing_tpu_torch.bench.driver import DriverRequest, attn_args

    return attn_args(DriverRequest(workload="attn"))


def dense_o(torch, q, k, v, scale):
    """Softmax attention of (b, n, d) q/k/v in float64 on the card, one batch
    element at a time (the reference's dense expected O,
    ring_attention.py:593-598)."""
    outs = []
    for i in range(q.shape[0]):
        qi, ki, vi = (t[i].to(torch.float64) for t in (q, k, v))
        p = torch.softmax((qi @ ki.T) * scale, dim=-1)
        outs.append((p @ vi).float())
        del qi, ki, vi, p
    return torch.stack(outs)


CONTROLS = ("p_unrounded", "v_truncated", "f32")


def control_fold(torch, ak, q, k, v, state, scale, bkv, fault):
    """The plain bf16 fold of q/k/v into ``state`` (in place, ``bkv`` keys at
    a time) with one deliberate fault, a control that the bf16 tolerance
    must reject: ``p_unrounded`` keeps p in f32 for p v, ``v_truncated``
    rounds V toward zero instead of to nearest, ``f32`` rounds nothing."""
    if fault != "f32":
        q, k = (t.to(torch.bfloat16).float() for t in (q, k))
        v = ((v.view(torch.int32) & -65536).view(torch.float32)
             if fault == "v_truncated" else v.to(torch.bfloat16).float())
    b, n, d = q.shape
    for j in range(0, k.shape[1], bkv):
        kb, vb = k[:, j:j + bkv], v[:, j:j + bkv]
        work = [torch.empty(shape, device=q.device) for shape, _ in
                ak.fold_scratch(b, n, kb.shape[1], d).values()]
        ak.fold_into(q, kb, vb, *state, scale, *work,
                     bf16_p=fault == "v_truncated")


def phase_attn_kernels(torch, device, timer):
    """Both attention kernels at the full-width shapes against their plain
    versions, with controls, times and bounds."""
    import torch.nn.functional as F

    from tenzing_tpu_torch.ops import attention_kernels as ak

    a = attn_full_args()
    b, n, d, blk = a.batch, a.n_devices * a.seq_local, a.head_dim, a.seq_local
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    q, k, v = (torch.randn(b, n, d, device=device, generator=gen)
               for _ in range(3))
    want_o = dense_o(torch, q, k, v, a.scale)

    def init_state(bb, nn):
        return [torch.zeros(bb, nn, d, device=device),
                torch.full((bb, nn, d), -1e30, device=device),
                torch.zeros(bb, nn, d, device=device)]

    mid = init_state(b, n)  # the state after three f32 folds
    for s in range(3):
        ak.attn_block_plain(q, k[:, s * blk:(s + 1) * blk],
                            v[:, s * blk:(s + 1) * blk], *mid, a.scale)
    cases = []  # (label, kernel, bf16, q, k, v, state, library call)
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        cases.append((f"block-{tag}-init", "attn_block", bf16, q,
                      k[:, :blk], v[:, :blk], init_state(b, n), None))
        cases.append((f"block-{tag}-after3", "attn_block", bf16, q,
                      k[:, 3 * blk:4 * blk], v[:, 3 * blk:4 * blk],
                      [t.clone() for t in mid], None))
        # the library yardstick: one scaled_dot_product_attention call over
        # (batch, 1 head, n, d) views, in the inputs' type
        lq, lk, lv = ((t.to(torch.bfloat16) if bf16 else t).unsqueeze(1)
                      for t in (q, k, v))
        cases.append((f"fused-{tag}", "attn_fused", bf16, q, k, v,
                      init_state(b, n),
                      lambda lq=lq, lk=lk, lv=lv:
                      F.scaled_dot_product_attention(lq, lk, lv)))
        cases.append((f"block-{tag}-ragged", "attn_block", bf16,
                      q[:1, :1000], k[:1, :blk], v[:1, :blk],
                      init_state(1, 1000), None))
    rows, failed = [], []
    for label, kernel, bf16, cq, ck, cv, st, library in cases:
        kern = getattr(ak, kernel)
        plain = getattr(ak, kernel + "_plain")
        kw = {"bkv": blk} if kernel == "attn_fused" else {}
        got, want = [t.clone() for t in st], [t.clone() for t in st]
        kern(cq, ck, cv, *got, a.scale, bf16_inputs=bf16, **kw)
        plain(cq, ck, cv, *want, a.scale, bf16_inputs=bf16, **kw)
        torch.cuda.synchronize()
        tol = ak.BF16_STATE_TOL if bf16 else ak.F32_STATE_TOL
        o_tol = BF16_O_TOL if bf16 else F32_O_TOL
        ok, errs = ak.state_check(got, want, tol)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        nb, nq, nkv = cq.shape[0], cq.shape[1], ck.shape[1]
        bound, bound_by = attn_bound(ak.fold_bytes(nb, nq, nkv, d),
                                     ak.attention_flops(nb, nq, nkv, d), bf16)
        row = {"phase": "attn_kernels", "case": label, "kernel": kernel,
               "bf16_inputs": bf16, "shape": [nb, nq, nkv, d],
               "max_abs_err": max(e["max_abs"] for e in errs.values()),
               "errors": errs, "within_tol": ok, "finite": finite,
               "tolerance": tol}
        states = {"kernel": got, "plain": want}
        if bf16:
            row["controls"] = {}
            for fault in CONTROLS:
                ctl = [t.clone() for t in st]
                control_fold(torch, ak, cq, ck, cv, ctl, a.scale,
                             ck.shape[1] if kernel == "attn_block" else blk,
                             fault)
                c_ok, c_errs = ak.state_check(ctl, want, tol)
                row["controls"][fault] = {"errors": c_errs, "within_tol": c_ok}
                states[fault] = ctl
            row["controls_rejected"] = not any(
                c["within_tol"] for c in row["controls"].values())
        if kernel == "attn_fused":  # from the initial state: O = acc / l
            row["o_vs_expected"] = {}
            for who, (acc, _, l) in states.items():
                o = acc / l
                row["o_vs_expected"][who] = {
                    "max_abs": float((o - want_o).abs().max()),
                    "within_tol": torch.allclose(o, want_o, **o_tol)}
            row["o_tolerance"] = o_tol
        del states
        row.update({
            "ms": timer.ms(lambda: kern(cq, ck, cv, *got, a.scale,
                                        bf16_inputs=bf16, **kw)),
            "plain_ms": timer.ms(lambda: plain(cq, ck, cv, *want, a.scale,
                                               bf16_inputs=bf16, **kw)),
            "library_ms": timer.ms(library) if library else None,
            "bound_ms": bound, "bound_by": bound_by})
        emit(row)
        rows.append(row)
        o_ok = row.get("o_vs_expected", {}).get("kernel", {}).get("within_tol",
                                                                   True)
        if not (ok and finite and o_ok and row.get("controls_rejected", True)):
            failed.append(label)
        del got, want
    del q, k, v, mid, cases, want_o
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"attn kernels phase failed on {failed}")
    return rows


def phase_attn_executor(torch, device):
    """The fixed attention orders through the stream executor at full width,
    kernels vs plain kernels vs the dense expected O."""
    from tenzing_tpu_torch.bench.driver import attn_graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.ring_attention import (
        fixed_orders,
        make_blocked_buffers,
    )
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.verify import ScheduleVerifier

    a = attn_full_args()
    t0 = time.time()
    bufs, _ = make_blocked_buffers(a, seed=0, with_expected=False)
    tbufs = buffers_from_numpy(bufs, device)
    del bufs
    want_o = dense_o(torch, tbufs["Q"], tbufs["K"], tbufs["V"], a.scale)
    setup_s = time.time() - t0
    plat = Platform.make_n_lanes(2)
    kern = StreamExecutor(plat, tbufs, device="cuda")
    plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
    g = attn_graph(a)
    rows, failed = [], []
    for label, order in fixed_orders(g, a.n_devices).items():
        if not ScheduleVerifier(g)(order).ok:
            raise AssertionError(f"attn executor phase: {label} is not sound")
        t0 = time.time()
        f32 = label in ("naive", "pallas-2l", "fused")
        tol = ak.F32_STATE_TOL if f32 else ak.BF16_STATE_TOL
        o_tol = F32_O_TOL if f32 else BF16_O_TOL
        out_k = kern.run(order)
        out_p = plain.run(order)
        names = ("acc", "m_run", "l_run")
        ok_plain, errs = ak.state_check([out_k[x] for x in names],
                                        [out_p[x] for x in names], tol)
        ok_plain = ok_plain and torch.allclose(out_k["O"], out_p["O"],
                                               **tol["acc/l"])
        err_o = float((out_k["O"] - want_o).abs().max())
        ok_want = torch.allclose(out_k["O"], want_o, **o_tol)
        del out_k, out_p
        ptrs = {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        run_n = kern.prepare_n(order)
        run_n(1)
        allocs0 = torch.cuda.memory_stats(device)["allocation.all.allocated"]
        run_n(3)
        allocs = (torch.cuda.memory_stats(device)["allocation.all.allocated"]
                  - allocs0)
        ptrs_ok = ptrs == {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        row = {"phase": "attn_executor", "order": label, "ops": len(order),
               "tolerance": tol, "vs_plain": errs, "within_tol_plain": ok_plain,
               "o_tolerance": o_tol, "o_vs_expected_max_abs_err": err_o,
               "within_tol_expected": ok_want, "data_ptr_unchanged": ptrs_ok,
               "allocations_in_3_timed_runs": allocs,
               "wall_s": round(time.time() - t0, 3)}
        emit(row)
        rows.append(row)
        if not (ok_plain and ok_want and ptrs_ok):
            failed.append(label)
    del kern, plain, tbufs
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"attn executor phase failed on {failed}")
    return want_o, {"setup_s": round(setup_s, 3), "orders": len(rows)}


def phase_attn_driver(torch, device, want_o):
    """The attention search at full width; returns the launch counts."""
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.ring_attention import make_blocked_buffers
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

    t0 = time.time()
    req = driver.DriverRequest(workload="attn", mcts_iters=12, iters=3,
                               search_iters=2, climb_budget=4)
    reset_launches()
    result = driver.run(req, device="cuda")
    launches = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    row = {"phase": "attn_driver", "launches": launches,
           "verified": verdict.get("verified"),
           "diverged": verdict.get("diverged"),
           "demoted_label": verdict.get("demoted_label"),
           "wall_s": round(time.time() - t0, 3)}
    if verdict.get("metric") != "attn_blockwise_pct50_searched_n8192":
        raise AssertionError(f"attn driver metric {verdict.get('metric')!r}")
    missing = [k for k in ("attn_block", "attn_fused")
               if launches[k] + launches[k + "_bf16"] <= 0]
    if missing:
        raise AssertionError(f"the attn path never launched {missing}")
    if verdict.get("verified") is not True:
        diverged = set(verdict.get("diverged") or ())
        if result.demoted is None or not diverged or not diverged <= {"acc", "O"}:
            raise AssertionError(f"attn driver result not verified: {verdict}")
        # the demoted winner: its O against the dense expected, at the bf16
        # tolerance (the gate compared it with the f32 naive chain)
        bufs, _ = make_blocked_buffers(driver.attn_args(req), seed=0,
                                       with_expected=False)
        ex = StreamExecutor(Platform.make_n_lanes(driver.search_lanes(req)),
                            buffers_from_numpy(bufs, device))
        o = ex.run(result.demoted)["O"]
        row["demoted_o_vs_expected_max_abs_err"] = float((o - want_o).abs().max())
        row["demoted_o_within_tol"] = torch.allclose(o, want_o, **BF16_O_TOL)
        del ex, o, bufs
        if not row["demoted_o_within_tol"]:
            raise AssertionError(f"the demoted attn winner's O is wrong: {row}")
    emit(row)
    torch.cuda.empty_cache()
    return launches


def moe_full():
    """(MoEPipeArgs, numpy buffers with both staging sets, capacity) of the
    full-width pipeline (the driver's moe configuration)."""
    from tenzing_tpu_torch.bench.driver import DriverRequest, moe_args
    from tenzing_tpu_torch.models.moe_pipeline import make_pipe_buffers

    a = moe_args(DriverRequest(workload="moe"))
    bufs, _, cap = make_pipe_buffers(a, seed=0, with_expected=False,
                                     staging="choice")
    return a, bufs, cap


def dense_moe_y(torch, bufs, a):
    """The dense routed evaluation in float64 on the card (the reference's
    expected Y, moe_pipeline.py:570-580): every routed token through its
    expert's tanh-gelu MLP, scaled by its gate weight.  The routing comes from
    the slot tables (idx_c, w_c), whose gate weights are float32."""
    w1, w2 = bufs["W1"].double(), bufs["W2"].double()
    tc = a.chunk_tokens
    want = torch.zeros(a.tokens, a.d_model, dtype=torch.float64,
                       device=w1.device)
    for c in range(a.n_chunks):
        xc = bufs["X"][c * tc:(c + 1) * tc].double()
        idx, w = bufs[f"idx_{c}"].long(), bufs[f"w_{c}"].double()
        for e in range(a.n_experts):
            real = w[e] > 0
            rows = idx[e][real]
            h = xc[rows] @ w1[e]
            h = 0.5 * h * (1.0 + torch.tanh((2.0 / torch.pi) ** 0.5
                                            * (h + 0.044715 * h ** 3)))
            want[c * tc + rows] = w[e][real, None] * (h @ w2[e])
    return want


def y_check(got, want, bf16: bool):
    """Y against the float64 expected: (ok, errors) at ``BF16_Y_TOL`` (largest
    error and relative rms error) or ``F32_Y_TOL`` (allclose)."""
    import torch

    d = got.double() - want
    errs = {"max_abs": float(d.abs().max()),
            "rel_rms": float(d.square().mean().sqrt()
                             / want.square().mean().sqrt())}
    if bf16:
        ok = (errs["rel_rms"] <= BF16_Y_TOL["rel_rms"]
              and errs["max_abs"] <= BF16_Y_TOL["max_abs"])
    else:
        ok = bool(torch.allclose(got.double(), want, **F32_Y_TOL))
    return ok, errs


def dropped_expert(bufs, y, a, expert: int = 0):
    """The control: Y with every token routed to ``expert`` zeroed, as if
    that expert's gate weights were dropped."""
    out = y.clone()
    tc = a.chunk_tokens
    for c in range(a.n_chunks):
        w = bufs[f"w_{c}"][expert]
        out[c * tc + bufs[f"idx_{c}"][expert][w > 0].long()] = 0.0
    return out


def phase_moe_kernels(torch, device, timer):
    """``ffn_batched`` at the main path's shapes and at ragged ones against
    its plain version, with the erf control, times and the bound."""
    import torch.nn.functional as F

    from tenzing_tpu_torch.ops import ffn_kernels as fk

    a, bufs, cap = moe_full()
    # the main path's launch: chunk 0's slot table through the experts
    x_tok = torch.from_numpy(bufs["X"][:a.chunk_tokens]).to(device)
    idx = torch.from_numpy(bufs["idx_0"]).to(device).long().view(-1)
    x0 = x_tok[idx].view(a.n_experts, cap, a.d_model).contiguous()
    w1 = torch.from_numpy(bufs["W1"]).to(device)
    w2 = torch.from_numpy(bufs["W2"]).to(device)
    del bufs, x_tok
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def rand_case(e, c, dff):
        d = a.d_model
        return (torch.randn(e, c, d, device=device, generator=gen),
                torch.randn(e, d, dff, device=device, generator=gen) / d ** 0.5,
                torch.randn(e, dff, d, device=device, generator=gen) / dff ** 0.5)

    cases = [("full", (x0, w1, w2)),
             ("ragged-c1", rand_case(a.n_experts, 1, a.d_ff)),
             ("ragged-c257", rand_case(a.n_experts, 257, a.d_ff)),
             ("ragged-dff520", rand_case(a.n_experts, cap, 520))]
    rows, failed = [], []
    for label, (x, cw1, cw2) in cases:
        e, c, d = x.shape
        dff = cw1.shape[2]
        got = fk.ffn_batched(x, cw1, cw2)
        again = fk.ffn_batched(x, cw1, cw2)
        want = fk.ffn_batched_plain(x, cw1, cw2)
        ctl = fk.ffn_batched_plain(x, cw1, cw2, approximate="none")
        torch.cuda.synchronize()
        flops, nbytes = fk.ffn_flops(e, c, d, dff), fk.ffn_bytes(e, c, d, dff)
        bound, bound_by = attn_bound(nbytes, flops, bf16=False)
        row = {"phase": "moe_kernels", "case": label, "kernel": "ffn_batched",
               "shape": [e, c, d, dff], "tolerance": fk.FFN_TOL,
               "max_abs_err": float((got - want).abs().max()),
               "within_tol": bool(torch.allclose(got, want, **fk.FFN_TOL)),
               "deterministic": bool(torch.equal(got, again)),
               "finite": bool(torch.isfinite(got).all()),
               "erf_control_max_abs_err": float((ctl - want).abs().max()),
               "erf_control_rejected": not torch.allclose(ctl, want,
                                                           **fk.FFN_TOL),
               "y_max_abs": float(want.abs().max()),
               "flops": flops, "bytes": nbytes,
               "bound_ms": bound, "bound_by": bound_by}
        del again, ctl
        if label == "full":
            row.update({
                "ms": timer.ms(lambda: fk.ffn_batched(x, cw1, cw2, out=got)),
                "plain_ms": timer.ms(lambda: fk.ffn_batched_plain(x, cw1, cw2)),
                # no single PyTorch call computes the function: three calls
                "library_calls_ms": timer.ms(lambda: torch.bmm(F.gelu(
                    torch.bmm(x, cw1), approximate="tanh"), cw2)),
                "library_calls": "torch.bmm -> gelu(tanh) -> torch.bmm"})
        emit(row)
        rows.append(row)
        if not (row["within_tol"] and row["deterministic"] and row["finite"]
                and row["erf_control_rejected"]):
            failed.append(label)
        del got, want
    del cases, x0, w1, w2
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"moe kernels phase failed on {failed}")
    return rows


def phase_moe_executor(torch, device):
    """The fixed moe orders through the stream executor at full width:
    kernels vs plain kernels vs the float64 expected Y."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.moe_pipeline import fixed_orders, host_buffer_names
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.verify import ScheduleVerifier

    t0 = time.time()
    a, bufs, cap = moe_full()
    tbufs = buffers_from_numpy(bufs, device, host_buffer_names(a, "choice"))
    del bufs
    want = dense_moe_y(torch, tbufs, a)
    setup_s = time.time() - t0
    plat = Platform.make_n_lanes(2)
    kern = StreamExecutor(plat, tbufs, device="cuda")
    plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
    rows, failed = [], []
    for label, (order, graph) in fixed_orders(a, cap).items():
        if not ScheduleVerifier(graph)(order).ok:
            raise AssertionError(f"moe executor phase: {label} is not sound")
        t0 = time.time()
        bf16 = "bf16" in label
        out_k = kern.run(order)
        out_p = plain.run(order)
        tol = BF16_PLAIN_Y_TOL if bf16 else F32_PLAIN_Y_TOL
        ok_plain = all(torch.allclose(out_k[n], out_p[n], **tol)
                       for n in ["Y"] + [f"Y_{c}" for c in range(a.n_chunks)])
        err_plain = float((out_k["Y"] - out_p["Y"]).abs().max())
        ok_want, errs = y_check(out_k["Y"], want, bf16)
        row = {"phase": "moe_executor", "order": label, "ops": len(order),
               "bf16_staging": bf16, "plain_tolerance": tol,
               "vs_plain_max_abs_err": err_plain, "within_tol_plain": ok_plain,
               "y_tolerance": BF16_Y_TOL if bf16 else F32_Y_TOL,
               "vs_expected": errs, "within_tol_expected": ok_want}
        if bf16:  # the tolerance must reject one expert's tokens dropped
            c_ok, c_errs = y_check(dropped_expert(tbufs, out_k["Y"], a), want,
                                   True)
            row["dropped_expert_control"] = {"errors": c_errs,
                                             "within_tol": c_ok}
            ok_want = ok_want and not c_ok
        del out_k, out_p
        ptrs = {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        run_n = kern.prepare_n(order)
        run_n(1)
        allocs0 = torch.cuda.memory_stats(device)["allocation.all.allocated"]
        run_n(3)
        allocs = (torch.cuda.memory_stats(device)["allocation.all.allocated"]
                  - allocs0)
        ptrs_ok = ptrs == {k: v.data_ptr() for k, v in kern.init_bufs.items()}
        timed_ok, _ = y_check(kern.init_bufs["Y"], want, bf16)
        row.update({"data_ptr_unchanged": ptrs_ok,
                    "allocations_in_3_timed_runs": allocs,
                    "timed_runs_within_tol": timed_ok,
                    "wall_s": round(time.time() - t0, 3)})
        emit(row)
        rows.append(row)
        if not (ok_plain and ok_want and ptrs_ok and allocs == 0 and timed_ok):
            failed.append(label)
    del kern, plain, tbufs
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"moe executor phase failed on {failed}")
    return want, {"setup_s": round(setup_s, 3), "orders": len(rows)}


def phase_moe_driver(torch, device, want_y):
    """The MoE search at full width with climbs; returns the launch counts."""
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.moe_pipeline import (
        host_buffer_names,
        make_pipe_buffers,
    )
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

    t0 = time.time()
    req = driver.DriverRequest(workload="moe", mcts_iters=12, iters=3,
                               search_iters=2, climb_budget=4)
    reset_launches()
    result = driver.run(req, device="cuda")
    launches = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    row = {"phase": "moe_driver", "launches": launches,
           "verified": verdict.get("verified"),
           "winner_label": verdict.get("winner_label"),
           "climbs": verdict.get("climbs"),
           "diverged": verdict.get("diverged"),
           "demoted_label": verdict.get("demoted_label"),
           "wall_s": round(time.time() - t0, 3)}
    if verdict.get("metric") != "moe_pipe_pct50_searched_t8192":
        raise AssertionError(f"moe driver metric {verdict.get('metric')!r}")
    missing = [k for k in ("ffn_batched", "device_copy") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the moe path never launched {missing}")
    if not verdict.get("climbs") or verdict["climbs"][0]["spent"] <= 0:
        raise AssertionError(f"the moe climb did not run: {verdict}")
    if verdict.get("verified") is not True:
        diverged = set(verdict.get("diverged") or ())
        outputs = {"Y"} | {f"Y_{c}" for c in range(4)}
        if result.demoted is None or not diverged or not diverged <= outputs:
            raise AssertionError(f"moe driver result not verified: {verdict}")
        # the demoted winner: its Y against the dense expected, at the bf16
        # staging tolerance (the gate compared it with the f32 naive chain)
        a = driver.moe_args(req)
        bufs, _, _ = make_pipe_buffers(a, seed=0, with_expected=False,
                                       staging="choice")
        ex = StreamExecutor(Platform.make_n_lanes(driver.search_lanes(req)),
                            buffers_from_numpy(bufs, device,
                                               host_buffer_names(a, "choice")))
        y = ex.run(result.demoted)["Y"]
        ok, errs = y_check(y, want_y, True)
        row["demoted_y_vs_expected"] = errs
        row["demoted_y_within_tol"] = ok
        del ex, y, bufs
        if not ok:
            raise AssertionError(f"the demoted moe winner's Y is wrong: {row}")
    emit(row)
    torch.cuda.empty_cache()
    return launches


def spmv_setup(torch, device, m: int, exchange: str = "host"):
    """(graph, placed buffers, float64 expected y on the card) of the spmv
    iteration at m rows: the driver's graph (``exchange="host"``, kernel
    menu) or the examples' (``exchange="local"``, no menu)."""
    import numpy as np

    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.models import spmv
    from tenzing_tpu_torch.runtime.executor import buffers_from_numpy

    if exchange == "host":
        g, tbufs, _, _ = driver.build_spmv(
            driver.DriverRequest(workload="spmv", m=m), device)
    else:
        bufs, _ = spmv.make_spmv_buffers(m=m, nnz_per_row=10, seed=0)
        tbufs = buffers_from_numpy(bufs, device)
        g = Graph()
        g.start_then(spmv.SpMVCompound())
        g.then_finish(spmv.SpMVCompound())
    a = spmv.random_band_matrix(m, max(1, m // 8), 10 * m, seed=0)
    x = tbufs["x_local"].cpu().numpy().astype(np.float64)
    rows = np.repeat(np.arange(m), a.row_widths())
    want = np.bincount(rows, weights=a.vals.astype(np.float64) * x[a.cols],
                       minlength=m)
    return g, tbufs, torch.from_numpy(want).to(device)


def y_close(torch, got, want, tol) -> bool:
    return bool(torch.allclose(got.double(), want.double(), **tol))


def phase_spmv_kernels(torch, device, timer):
    """``ell_spmv`` at the main path's shapes and ragged ones against its
    plain version, with the dropped-column control, the times and the
    bound."""
    import numpy as np

    from tenzing_tpu_torch.models import spmv
    from tenzing_tpu_torch.ops import spmv_kernels as sk

    m = 8192
    bufs, _ = spmv.make_spmv_buffers(m=m, nnz_per_row=10, seed=0)
    a = spmv.random_band_matrix(m, m // 8, 10 * m, seed=0)
    remote = spmv.split_local_remote(a, 0, m // 2).remote
    x_remote = bufs["x_local"][bufs["send_idx"]]
    rng = np.random.default_rng(0)

    def rand_case(mm, w, n):
        return (rng.standard_normal((mm, w)).astype(np.float32),
                rng.integers(0, n, size=(mm, w)).astype(np.int32),
                rng.standard_normal(n).astype(np.float32))

    cases = [("m8192-spmv_remote", (bufs["A_rem_vals"], bufs["A_rem_cols"],
                                    x_remote))]
    cases += [(f"ragged-m{mm}-w{w}-n{n}", rand_case(mm, w, n)) for mm, w, n in
              ((1000, 23, 4093), (37, 5, 300), (64, 1, 50), (50, 7, 1),
               (513, 12, 4096), (9, 40, 128))]
    rows, failed = [], []
    for label, arrays in cases:
        vals, cols, x = (torch.from_numpy(np.ascontiguousarray(t)).to(device)
                         for t in arrays)
        mm, w = vals.shape
        got = sk.ell_spmv(vals, cols, x)
        again = sk.ell_spmv(vals, cols, x)
        want = sk.ell_spmv_plain(vals, cols, x)
        ctl = sk.ell_spmv_plain(vals[:, :-1].contiguous(),
                                cols[:, :-1].contiguous(), x) if w > 1 else \
            torch.zeros_like(want)
        torch.cuda.synchronize()
        nbytes, flops = sk.ell_bytes(mm, w, x.shape[0]), sk.ell_flops(mm, w)
        bound, bound_by = attn_bound(nbytes, flops, bf16=False)
        row = {"phase": "spmv_kernels", "case": label, "kernel": "ell_spmv",
               "shape": [mm, w, int(x.shape[0])], "tolerance": sk.ELL_TOL,
               "max_abs_err": float((got - want).abs().max()),
               "within_tol": bool(torch.allclose(got, want, **sk.ELL_TOL)),
               "deterministic": bool(torch.equal(got, again)),
               "finite": bool(torch.isfinite(got).all()),
               "control_max_abs_err": float((ctl - want).abs().max()),
               "control_rejected": not torch.allclose(ctl, want, **sk.ELL_TOL),
               "bytes": nbytes, "flops": flops,
               "bound_ms": bound, "bound_by": bound_by}
        if label.startswith("m8192"):
            # the library yardstick: cuSPARSE SpMV of the same matrix, the
            # product alone timed
            csr = torch.sparse_csr_tensor(
                torch.from_numpy(remote.indptr.astype(np.int64)),
                torch.from_numpy(remote.cols.astype(np.int64)),
                torch.from_numpy(remote.vals), size=(remote.m, remote.n)).to(device)
            lib_y = csr.matmul(x)
            torch.cuda.synchronize()
            row.update({
                "ms": timer.ms(lambda: sk.ell_spmv(vals, cols, x, out=got)),
                "plain_ms": timer.ms(lambda: sk.ell_spmv_plain(vals, cols, x)),
                "library_ms": timer.ms(lambda: csr.matmul(x)),
                "library_call": "torch.sparse_csr_tensor(...).matmul(x) (cuSPARSE)",
                "library_max_abs_err": float((lib_y - want).abs().max())})
        emit(row)
        rows.append(row)
        if not (row["within_tol"] and row["deterministic"] and row["finite"]
                and row["control_rejected"]):
            failed.append(label)
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"spmv kernels phase failed on {failed}")
    return rows


def phase_spmv_executor(torch, device):
    """The fixed spmv orders through the stream executor at m=8192 and
    m=150000: kernels vs plain kernels vs the float64 product."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.spmv import fixed_orders
    from tenzing_tpu_torch.ops.spmv_kernels import ELL_TOL
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.verify import ScheduleVerifier

    rows, failed = [], []
    for m, labels in ((8192, ("naive", "overlap-2l", "pallas-2l")),
                      (150_000, ("naive", "overlap-2l"))):
        g, tbufs, want = spmv_setup(torch, device, m)
        plat = Platform.make_n_lanes(2)
        kern = StreamExecutor(plat, tbufs, device="cuda")
        plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
        orders = fixed_orders(g)
        for label in labels:
            order = orders[label]
            if not ScheduleVerifier(g)(order).ok:
                raise AssertionError(f"spmv executor phase: {label} is not sound")
            t0 = time.time()
            out_k, out_p = kern.run(order), plain.run(order)
            ok_plain = all(torch.allclose(out_k[n], out_p[n], **ELL_TOL)
                           for n in ("y", "y_local", "y_remote", "x_remote"))
            ok_want = y_close(torch, out_k["y"], want, ELL_TOL)
            err = float((out_k["y"].double() - want).abs().max())
            del out_k, out_p
            ptrs = {k: v.data_ptr() for k, v in kern.init_bufs.items()}
            run_n = kern.prepare_n(order)
            run_n(1)
            allocs0 = torch.cuda.memory_stats(device)["allocation.all.allocated"]
            run_n(3)
            allocs = (torch.cuda.memory_stats(device)["allocation.all.allocated"]
                      - allocs0)
            ptrs_ok = ptrs == {k: v.data_ptr() for k, v in kern.init_bufs.items()}
            timed_ok = y_close(torch, kern.init_bufs["y"], want, ELL_TOL)
            row = {"phase": "spmv_executor", "m": m, "order": label,
                   "ops": len(order), "kernels": sum(
                       op.name().endswith(".pallas") for op in order.vector()),
                   "tolerance": ELL_TOL, "within_tol_plain": ok_plain,
                   "vs_float64_max_abs_err": err, "within_tol_expected": ok_want,
                   "data_ptr_unchanged": ptrs_ok,
                   "allocations_in_3_timed_runs": allocs,
                   "timed_runs_within_tol": timed_ok,
                   "wall_s": round(time.time() - t0, 3)}
            emit(row)
            rows.append(row)
            if not (ok_plain and ok_want and ptrs_ok and allocs == 0 and timed_ok):
                failed.append(f"m{m}/{label}")
        del kern, plain, tbufs
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"spmv executor phase failed on {failed}")
    return {"orders": len(rows)}


def phase_fused(torch, device, timer):
    """Every tile count on the menu through the ``fused_region`` kernel
    against the plain region and the float64 product, the dropped-column
    control, and each region's times beside its bound."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.spmv import fixed_orders
    from tenzing_tpu_torch.ops import fused_region as fr
    from tenzing_tpu_torch.ops.spmv_kernels import ell_spmv_plain
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.runtime.fused import (
        FusedExecutor,
        FusedRegionOp,
        region_bytes,
        partition_regions,
    )
    from tenzing_tpu_torch.solve.local import first_decision_order

    m = 150_000
    rows, failed, timing = [], [], []
    for exchange in ("host", "local"):
        g, tbufs, want = spmv_setup(torch, device, m, exchange)
        plat = Platform.make_n_lanes(2)
        kern = StreamExecutor(plat, tbufs, device="cuda")
        plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
        if exchange == "host":
            orders = {k: v for k, v in fixed_orders(g).items() if k != "pallas-2l"}
        else:  # the examples' graph: one five-member region, menu [1]
            orders = {"naive": first_decision_order(g, Platform.make_n_lanes(1))}
        # the control: y with spmv_remote's last slab column dropped
        ctl = (ell_spmv_plain(tbufs["A_rem_vals"][:, :-1].contiguous(),
                              tbufs["A_rem_cols"][:, :-1].contiguous(),
                              tbufs["x_local"][tbufs["send_idx"].long()])
               + ell_spmv_plain(tbufs["A_loc_vals"], tbufs["A_loc_cols"],
                                tbufs["x_local"]))
        for label, seq in orders.items():
            menu = FusedExecutor(kern).plan(seq).tile_menu
            for t in menu:
                t0 = time.time()
                fk_ex = FusedExecutor(kern, tiles=t)
                plan = fk_ex.plan(seq)
                out_k = fk_ex.run(seq)
                again = fk_ex.run(seq)["y"]
                out_p = FusedExecutor(plain, tiles=t).run(seq)
                names = ("y", "y_local", "y_remote", "x_remote", "send_buf")
                errs = {n: float((out_k[n] - out_p[n]).abs().max()) for n in names}
                ok_plain = all(torch.allclose(out_k[n], out_p[n], **fr.REGION_TOL)
                               for n in names)
                ok_want = y_close(torch, out_k["y"], want, fr.REGION_TOL)
                ctl_rejected = not torch.allclose(ctl, out_k["y"], **fr.REGION_TOL)
                row = {"phase": "fused", "exchange": exchange, "order": label,
                       "tiles": t, "menu": menu,
                       "regions": [r.members for r in plan.regions],
                       "region_tiles": [r.tiles for r in plan.regions],
                       "tolerance": fr.REGION_TOL, "vs_plain": errs,
                       "within_tol_plain": ok_plain,
                       "vs_float64_max_abs_err": float(
                           (out_k["y"].double() - want).abs().max()),
                       "within_tol_expected": ok_want,
                       "deterministic": bool(torch.equal(out_k["y"], again)),
                       "control_rejected": ctl_rejected,
                       "wall_s": round(time.time() - t0, 3)}
                del out_k, out_p, again
                emit(row)
                rows.append(row)
                if not (ok_plain and ok_want and ctl_rejected
                        and row["deterministic"] and plan.regions):
                    failed.append(f"{exchange}/{label}/t{t}")
            if exchange == "host" and label != "naive":
                continue
            # each region of the naive order at one tile: kernel, plain
            # region and the stepped members, beside the bytes bound
            fex = FusedExecutor(kern, tiles=1)
            fseq = fex.fused_order(seq)
            kern.precompile(fseq)
            kern.precompile(seq)  # the members' own scratch, for stepping
            segs = [s for k, s in partition_regions(seq.vector(),
                                                    kern.host_names) if k == "region"]
            nbytes = {k: v.numel() * v.element_size()
                      for k, v in kern.init_bufs.items()}
            bufs, ctx = kern.init_bufs, kern.ctx
            for op, region in zip([o for o in fseq if isinstance(o, FusedRegionOp)],
                                  segs):
                k = op.unbound()
                members = region.members
                nb = region_bytes(region, nbytes)
                trow = {"phase": "fused_timing", "exchange": exchange,
                        "members": [mm.name() for mm in members], "tiles": 1,
                        "ms": timer.ms(lambda: k.apply(bufs, ctx)),
                        "plain_ms": timer.ms(
                            lambda: fr.region_plain(k.bodies(), bufs, 1)),
                        "stepped_ms": timer.ms(
                            lambda: [mm.apply(bufs, ctx) for mm in members]),
                        "bytes": nb, "bound_ms": bound_ms(nb), "bound_by": "bytes"}
                emit(trow)
                timing.append(trow)
        del kern, plain, tbufs, ctl
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"fused phase failed on {failed}")
    return rows, timing


def phase_fused_sweep(torch, device, timer):
    """Every structurally valid tile count of the spmv naive order's regions
    at m=150000 and m=8192: each region's kernel time
    beside its tile's share of the tiled traffic and its time at one tile,
    and the fused order against the same order with plain regions.  The
    pruning floor ``bench/roofline.MIN_TILE_BYTES`` is read from these rows."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.spmv import fixed_orders
    from tenzing_tpu_torch.ops import fused_region as fr
    from tenzing_tpu_torch.runtime.executor import StreamExecutor
    from tenzing_tpu_torch.runtime.fused import (
        FusedExecutor,
        FusedRegionOp,
        partition_regions,
        region_bytes,
        region_full_bytes,
        region_tile_counts,
    )

    rows, failed = [], []
    for m in (150_000, 8192):
        g, tbufs, want = spmv_setup(torch, device, m)
        plat = Platform.make_n_lanes(2)
        kern = StreamExecutor(plat, tbufs, device="cuda")
        plain = StreamExecutor(plat, tbufs, device="cuda", plain_kernels=True)
        seq = fixed_orders(g)["naive"]
        shapes = {k: tuple(v.shape) for k, v in kern.init_bufs.items()}
        nbytes = {k: v.numel() * v.element_size() for k, v in kern.init_bufs.items()}
        regions = [s for k, s in partition_regions(seq.vector(), kern.host_names)
                   if k == "region"]
        counts = sorted({t for r in regions for t in region_tile_counts(r, shapes)})
        at_one, seen = {}, set()
        for t in counts:
            fex = FusedExecutor(kern, tiles=t)
            plan = fex.plan(seq)
            out_k = fex.run(seq)
            out_p = FusedExecutor(plain, tiles=t).run(seq)
            ok = all(torch.allclose(out_k[n], out_p[n], **fr.REGION_TOL)
                     for n in ("y", "y_local", "y_remote", "x_remote", "send_buf"))
            ok = ok and y_close(torch, out_k["y"], want, fr.REGION_TOL)
            del out_k, out_p
            ops = [o for o in plan.fused_order if isinstance(o, FusedRegionOp)]
            for k, (op, region, info) in enumerate(zip(ops, regions, plan.regions)):
                if (k, info.tiles) in seen:  # a region whose menu stops short
                    continue
                seen.add((k, info.tiles))
                ker = op.unbound()
                tiled = region_bytes(region, nbytes) - region_full_bytes(region, nbytes)
                ms = timer.ms(lambda: ker.apply(kern.init_bufs, kern.ctx))
                at_one.setdefault(k, ms)
                row = {"phase": "fused_sweep", "m": m, "region": k,
                       "members": info.members, "tiles": info.tiles,
                       "valid_tiles": info.valid_tiles,
                       "tile_tiled_bytes": tiled / info.tiles,
                       "blocks_per_group": ker.table.blocks_per_group,
                       "ms": ms, "vs_one_tile": ms / at_one[k],
                       "within_tol": ok}
                emit(row)
                rows.append(row)
            if not ok:
                failed.append(f"m{m}/t{t}")
        del kern, plain, tbufs
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"fused sweep failed on {failed}")
    return rows


def phase_spmv_driver(torch, device):
    """The spmv search at m=150000 with the fused regions, then at m=8192;
    returns the launch counts of each run."""
    from tenzing_tpu_torch.bench import driver

    runs = {}
    for m, flags in ((150_000, dict(fuse_winner=True, fuse_search_tiles=True)),
                     (8192, {})):
        t0 = time.time()
        req = driver.DriverRequest(workload="spmv", m=m, mcts_iters=12, iters=3,
                                   search_iters=2, **flags)
        reset_launches()
        result = driver.run(req, device="cuda")
        launches = all_launches()
        verdict = result.verdict
        print(result.to_json_line(), flush=True)
        fused = verdict.get("perf", {}).get("fused")
        row = {"phase": "spmv_driver", "m": m, "launches": launches,
               "verified": verdict.get("verified"),
               "winner_label": verdict.get("winner_label"),
               "vs_baseline": verdict.get("vs_baseline"),
               "fused": fused, "fuse_search_tiles": verdict.get(
                   "perf", {}).get("fuse_search_tiles"),
               "wall_s": round(time.time() - t0, 3)}
        emit(row)
        if verdict.get("metric") != f"spmv_iter_pct50_searched_m{m}":
            raise AssertionError(f"spmv driver metric {verdict.get('metric')!r}")
        if verdict.get("verified") is not True:
            raise AssertionError(f"spmv driver result not verified: {verdict}")
        if flags:
            if not fused or fused["verified"] is not True or fused["regions"] < 1:
                raise AssertionError(f"the fused spmv program failed: {fused}")
            if launches["fused_region"] <= 0:
                raise AssertionError("the fused spmv path never launched fused_region")
        elif launches["ell_spmv"] <= 0:
            raise AssertionError("the m=8192 spmv path never launched ell_spmv")
        runs[m] = launches
        torch.cuda.empty_cache()
    return runs


def phase_attn_fused(torch, device, timer, want_o):
    """The attention members of ``fused_region`` at full width: the naive
    ``.xla`` order, a 2-lane order and the naive order with every fold chunked
    2 and 4 ways, at every tile count of their menus, against the plain
    region (the state at ``F32_STATE_TOL``, O beside it) and the dense
    expected O; two launches bitwise equal; a fold member whose key offset is
    one block off must be rejected.  Times each region of the naive order
    (every tile count) and of the chunked orders (one tile) beside the
    stepped members, the plain region and the operations bound."""
    import dataclasses

    from tenzing_tpu_torch.bench.driver import attn_graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.ring_attention import (
        fixed_order,
        make_blocked_buffers,
    )
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.ops import fused_region as fr
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.runtime.fused import FusedExecutor, FusedRegionOp
    from tenzing_tpu_torch.verify import ScheduleVerifier

    a = attn_full_args()
    bufs, _ = make_blocked_buffers(a, seed=0, with_expected=False)
    tbufs = buffers_from_numpy(bufs, device)
    del bufs
    names = ("acc", "m_run", "l_run")
    one, two = Platform.make_n_lanes(1), Platform.make_n_lanes(2)
    kern = StreamExecutor(two, tbufs, device="cuda")
    plain = StreamExecutor(two, tbufs, device="cuda", plain_kernels=True)
    g, gc = attn_graph(a), attn_graph(a, chunk=True, chunk_relax=True)
    orders = {
        "naive": (fixed_order(g, one), g),
        "2-lane": (fixed_order(g, two, lane_of=lambda s: s // 4), g),
        "naive-c2": (fixed_order(gc, one, kernel_of=lambda s: ".xla.chunked.c2"), gc),
        "naive-c4": (fixed_order(gc, one, kernel_of=lambda s: ".xla.chunked.c4"), gc),
    }
    rows, timing, failed = [], [], []
    for label, (seq, graph) in orders.items():
        if not ScheduleVerifier(graph)(seq).ok:
            raise AssertionError(f"attn fused phase: {label} is not sound")
        menu = FusedExecutor(kern).plan(seq).tile_menu
        for t in menu:
            t0 = time.time()
            fex = FusedExecutor(kern, tiles=t)
            plan = fex.plan(seq)
            out_k = fex.run(seq)
            again = fex.run(seq)
            out_p = FusedExecutor(plain, tiles=t).run(seq)
            ok_plain, errs = ak.state_check([out_k[n] for n in names],
                                            [out_p[n] for n in names],
                                            ak.F32_STATE_TOL)
            err_o = float((out_k["O"] - out_p["O"]).abs().max())
            ok_plain = ok_plain and torch.allclose(out_k["O"], out_p["O"],
                                                   **ak.F32_STATE_TOL["acc/l"])
            ok_want = torch.allclose(out_k["O"], want_o, **F32_O_TOL)
            same = all(torch.equal(out_k[n], again[n]) for n in names + ("O",))
            row = {"phase": "attn_fused", "order": label, "tiles": t,
                   "menu": menu, "regions": [r.members for r in plan.regions],
                   "region_tiles": [r.tiles for r in plan.regions],
                   "tolerance": ak.F32_STATE_TOL, "vs_plain": errs,
                   "o_vs_plain_max_abs_err": err_o, "within_tol_plain": ok_plain,
                   "o_vs_expected_max_abs_err": float(
                       (out_k["O"] - want_o).abs().max()),
                   "within_tol_expected": ok_want, "deterministic": same}
            if label == "naive" and t == 1:
                # the control: the first fold reads the next block's keys
                k = next(o for o in plan.fused_order
                         if isinstance(o, FusedRegionOp)).unbound()
                span = a.n_devices * a.seq_local
                bad = [dataclasses.replace(b, key_off=(b.key_off + a.seq_local) % span)
                       if i == 0 else b for i, b in enumerate(k.bodies())]
                cbufs = {n: v.clone() for n, v in kern.init_bufs.items()}
                for n in names:
                    cbufs[n].copy_(kern._initial[n])
                fr.fused_region(fr.RegionTable(bad, 1), cbufs,
                                torch.zeros(2, dtype=torch.int32, device=device))
                c_ok, c_errs = ak.state_check([cbufs[n] for n in names],
                                              [out_p[n] for n in names],
                                              ak.F32_STATE_TOL)
                row["key_offset_control"] = {"errors": c_errs, "within_tol": c_ok}
                ok_plain = ok_plain and not c_ok
                del cbufs
            row["wall_s"] = round(time.time() - t0, 3)
            emit(row)
            rows.append(row)
            del out_k, out_p, again
            if not (ok_plain and ok_want and same and plan.regions):
                failed.append(f"{label}/t{t}")
        if label == "2-lane":
            continue
        # each region's kernel beside the plain region and the stepped
        # members: every tile count of the naive order, one tile otherwise
        kern.precompile(seq)  # the members' own scratch, for stepping
        bufs_, ctx = kern.init_bufs, kern.ctx
        for t in (menu if label == "naive" else [1]):
            fex = FusedExecutor(kern, tiles=t)
            fseq = fex.fused_order(seq)
            kern.precompile(fseq)
            regs = [o for o in fseq if isinstance(o, FusedRegionOp)]
            for op, info in zip(regs, fex.plan(seq).regions):
                k = op.unbound()
                members = k._members
                ms = timer.ms(lambda: k.apply(bufs_, ctx))  # binds the table
                trow = {"phase": "attn_fused_timing", "order": label,
                        "members": info.members, "tiles": t,
                        "blocks_per_group": k.table.blocks_per_group, "ms": ms}
                if t == 1:
                    trow["plain_ms"] = timer.ms(
                        lambda: fr.region_plain(k.bodies(), bufs_, 1))
                    trow["stepped_ms"] = timer.ms(
                        lambda: [mm.apply(bufs_, ctx) for mm in members])
                keys = sum(b.nkv for b in k.bodies() if b.body == "attn_fold")
                ops = 4.0 * a.batch * a.n_devices * a.seq_local * keys * a.head_dim
                trow["bound_ms"] = ops / PEAK_F32_FLOPS * 1e3
                trow["bound_by"] = "operations"
                emit(trow)
                timing.append(trow)
    # the library yardstick: one f32 scaled_dot_product_attention call over
    # (batch, 1 head, n, d) views, as the attn kernels phase times it
    import torch.nn.functional as F

    q, kk, v = (kern.init_bufs[n].unsqueeze(1) for n in ("Q", "K", "V"))
    sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(q, kk, v))
    emit({"phase": "attn_fused_library", "sdpa_f32_ms": sdpa_ms})
    del kern, plain, tbufs, q, kk, v
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"attn fused phase failed on {failed}")
    return rows, timing, sdpa_ms


def phase_attn_fused_driver(torch, device):
    """``--workload attn --fuse-winner --fuse-search-tiles`` at full width
    with the cut budget; returns the launch counts."""
    from tenzing_tpu_torch.bench import driver

    t0 = time.time()
    req = driver.DriverRequest(workload="attn", fuse_winner=True,
                               fuse_search_tiles=True, mcts_iters=12, iters=3,
                               search_iters=2)
    reset_launches()
    result = driver.run(req, device="cuda")
    launches = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    perf = verdict.get("perf", {})
    row = {"phase": "attn_fused_driver", "launches": launches,
           "verified": verdict.get("verified"), "diverged": verdict.get("diverged"),
           "winner_label": verdict.get("winner_label"),
           "vs_baseline": verdict.get("vs_baseline"),
           "fused": perf.get("fused"),
           "fuse_search_tiles": perf.get("fuse_search_tiles"),
           "wall_s": round(time.time() - t0, 3)}
    emit(row)
    if verdict.get("metric") != "attn_blockwise_pct50_searched_n8192":
        raise AssertionError(f"attn fused driver metric {verdict.get('metric')!r}")
    fused, tiles = perf.get("fused"), perf.get("fuse_search_tiles")
    if not fused or not tiles or not tiles.get("planted"):
        raise AssertionError(f"attn fused driver: no perf.fused / planted "
                             f"tile menu: {perf}")
    # the reference's gate may report the fused program as diverged (the
    # fused fold sums in another order); the members' own tolerance raised
    # inside the run if the kernel were wrong
    if fused.get("verified") is not True and not fused.get("diverged"):
        raise AssertionError(f"attn fused driver: fused block not verified "
                             f"and no divergence reported: {fused}")
    if verdict.get("verified") is not True:
        diverged = set(verdict.get("diverged") or ())
        if result.demoted is None or not diverged or not diverged <= {"acc", "O"}:
            raise AssertionError(f"attn fused driver not verified: {verdict}")
    if launches["fused_region"] <= 0:
        raise AssertionError("the fused attn path never launched fused_region")
    torch.cuda.empty_cache()
    return launches


def drive_to(g, plat, picks):
    """A complete schedule of ``g`` on ``plat`` taking, at every choice, the
    alternative whose name ends with ``picks(op_name)`` (None: the first
    offered), every other decision the phase policy's."""
    from tenzing_tpu_torch.models.moe_pipeline import PHASES
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    def prefer(op_name, choices):
        want = picks(op_name)
        return next((c for c in choices if want and c.endswith(want)), None)

    return drive(g, plat, phase_policy(plat, PHASES, prefer))[0]


def phase_chunk(torch, device, timer, want_o, want_y):
    """The chunked orders at full width against the unchunked ones at every
    structurally valid count: attention's naive order with every fold split
    into sub-folds (``F32_STATE_TOL``), the moe greedy orders with every
    expert MLP split into expert partials, f32 and bf16 staging (one f32 /
    bf16 ulp from the unchunked Y; Y against the float64 expected).  Then the
    full-size pruned menus, and the two card constants of
    ``bench/roofline.py`` measured: the stream executor's per-op host
    dispatch and the pinned host <-> device copy rate."""
    from tenzing_tpu_torch.bench import roofline
    from tenzing_tpu_torch.bench.driver import attn_graph
    from tenzing_tpu_torch.core.chunking import chunks_of
    from tenzing_tpu_torch.core.operation import Finish, Start
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.core.sequence import Sequence
    from tenzing_tpu_torch.models.moe_pipeline import (
        build_graph,
        ffn_chunk_menu,
        host_buffer_names,
    )
    from tenzing_tpu_torch.models.ring_attention import (
        fixed_order,
        fold_chunk_menu,
        make_blocked_buffers,
    )
    from tenzing_tpu_torch.models.spmv import VectorAdd
    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
    from tenzing_tpu_torch.verify import ScheduleVerifier

    rows, failed = [], []
    a = attn_full_args()
    bufs, _ = make_blocked_buffers(a, seed=0, with_expected=False)
    tbufs = buffers_from_numpy(bufs, device)
    del bufs
    one = Platform.make_n_lanes(1)
    ex = StreamExecutor(one, tbufs, device="cuda")
    gc = attn_graph(a, chunk=True, chunk_relax=True)
    names = ("acc", "m_run", "l_run")
    base = ex.run(fixed_order(gc, one))
    for n in [c for c in fold_chunk_menu(a, relax=True)[0] if c > 1]:
        seq = fixed_order(gc, one, kernel_of=lambda s: f".xla.chunked.c{n}")
        out = ex.run(seq)
        ok, errs = ak.state_check([out[x] for x in names], [base[x] for x in names],
                                  ak.F32_STATE_TOL)
        ok = ok and torch.allclose(out["O"], base["O"], **ak.F32_STATE_TOL["acc/l"])
        ok_want = torch.allclose(out["O"], want_o, **F32_O_TOL)
        verified = ScheduleVerifier(gc)(seq).ok
        row = {"phase": "chunk", "workload": "attn", "chunks": n,
               "chosen": sorted(set(chunks_of(seq.vector()).values())),
               "vs_unchunked": errs, "within_tol": ok,
               "o_vs_expected_max_abs_err": float((out["O"] - want_o).abs().max()),
               "within_tol_expected": ok_want, "verified": verified}
        emit(row)
        rows.append(row)
        if not (ok and ok_want and verified):
            failed.append(f"attn/c{n}")
        del out
    del ex, tbufs, base
    torch.cuda.empty_cache()

    m, mbufs, cap = moe_full()
    tb = buffers_from_numpy(mbufs, device, host_buffer_names(m, "choice"))
    del mbufs
    two = Platform.make_n_lanes(2)
    ex = StreamExecutor(two, tb, device="cuda")
    gm = build_graph(m, cap, impl_choice=True, staging="choice", chunk=True,
                     chunk_relax=True)
    counts = [c for c in ffn_chunk_menu(m, cap, relax=True)[0] if c > 1]
    for staging in ("f32", "bf16"):
        bf16 = staging == "bf16"
        chain = f".{staging}-host"

        def picks(op, n=None):
            if op.startswith("chain_"):
                return chain
            return ".xla" if n is None else f".xla.chunked.c{n}"

        y0 = ex.run(drive_to(gm, two, picks))["Y"]
        for n in counts:
            seq = drive_to(gm, two, lambda op: picks(op, n))
            y = ex.run(seq)["Y"]
            tol = BF16_PLAIN_Y_TOL if bf16 else F32_PLAIN_Y_TOL
            ok = torch.allclose(y, y0, **tol)
            ok_want, errs = y_check(y, want_y, bf16)
            verified = ScheduleVerifier(gm)(seq).ok
            row = {"phase": "chunk", "workload": "moe", "staging": staging,
                   "chunks": n,
                   "chosen": sorted(set(chunks_of(seq.vector()).values())),
                   "tolerance": tol,
                   "vs_unchunked_max_abs_err": float((y - y0).abs().max()),
                   "within_tol": ok, "vs_expected": errs,
                   "within_tol_expected": ok_want, "verified": verified}
            emit(row)
            rows.append(row)
            if not (ok and ok_want and verified and row["chosen"] == [n]):
                failed.append(f"moe/{staging}/c{n}")
    del ex, tb
    torch.cuda.empty_cache()

    # the card's constants: one more op's host time on the stream executor
    # (a one-lane chain of 200 small adds, run 20 times), and the pinned copy
    # rate of one moe slot table, both directions
    k_ops, reps = 200, 20
    vec = {n: torch.rand(4096, device=device) for n in ("a", "b", "o")}
    lane = one.lanes[0]
    chain_seq = Sequence([Start()] + [VectorAdd(f"add{i}", "a", "b", "o").bind(lane)
                                      for i in range(k_ops)] + [Finish()])
    dex = StreamExecutor(one, vec, device="cuda")
    run_n = dex.prepare_n(chain_seq)
    run_n(2)
    per_op = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_n(reps)
        per_op.append((time.perf_counter() - t0) / (reps * k_ops) * 1e6)
    per_op.sort()
    dispatch_us = per_op[len(per_op) // 2]
    table = m.n_experts * cap * m.d_model * 4
    host = torch.empty(table // 4, pin_memory=True)
    dbuf = torch.empty(table // 4, device=device)
    h2d = timer.ms(lambda: dbuf.copy_(host, non_blocking=True))
    d2h = timer.ms(lambda: host.copy_(dbuf, non_blocking=True))
    rate_gbs = (table / (h2d * 1e-3) + table / (d2h * 1e-3)) / 2 / 1e9
    menus = {"attn": fold_chunk_menu(a), "moe": ffn_chunk_menu(m, cap)}
    const = {"phase": "chunk_constants",
             "dispatch_us_measured": dispatch_us,
             "dispatch_us_samples": per_op,
             "CHUNK_DISPATCH_US": roofline.CHUNK_DISPATCH_US,
             "slot_table_bytes": table, "h2d_ms": h2d, "d2h_ms": d2h,
             "xfer_gbs_measured": rate_gbs, "XFER_GBS": roofline.XFER_GBS,
             "full_size_menus": {k: {"counts": v[0], "est_hidden_us": v[1]}
                                 for k, v in menus.items()}}
    emit(const)
    del vec, dex, host, dbuf
    if failed:
        raise AssertionError(f"chunk phase failed on {failed}")
    return rows, const


def phase_chunk_driver(torch, device):
    """``--chunk`` on attn and moe at full width with the cut budget: the
    ``perf.chunked`` block, verified or demoted as the plain runs may be;
    returns the launch counts of each run."""
    from tenzing_tpu_torch.bench import driver

    runs = {}
    for workload in ("attn", "moe"):
        t0 = time.time()
        extra = dict(climb_budget=4) if workload == "moe" else {}
        req = driver.DriverRequest(workload=workload, chunk=True, mcts_iters=12,
                                   iters=3, search_iters=2, **extra)
        reset_launches()
        result = driver.run(req, device="cuda")
        launches = all_launches()
        verdict = result.verdict
        print(result.to_json_line(), flush=True)
        chunked = verdict.get("perf", {}).get("chunked")
        row = {"phase": "chunk_driver", "workload": workload,
               "launches": launches, "verified": verdict.get("verified"),
               "diverged": verdict.get("diverged"),
               "winner_label": verdict.get("winner_label"),
               "vs_baseline": verdict.get("vs_baseline"), "chunked": chunked,
               "wall_s": round(time.time() - t0, 3)}
        emit(row)
        if not chunked or "menus" not in chunked or not chunked["menus"]:
            raise AssertionError(f"{workload} --chunk: no perf.chunked menus: {chunked}")
        allowed = {"acc", "O"} if workload == "attn" else \
            {"Y"} | {f"Y_{c}" for c in range(4)}
        if verdict.get("verified") is not True:
            diverged = set(verdict.get("diverged") or ())
            if result.demoted is None or not diverged or not diverged <= allowed:
                raise AssertionError(f"{workload} --chunk not verified: {verdict}")
        runs[workload] = launches
        torch.cuda.empty_cache()
    return runs


def _host_sync_row(torch, exs, workload, label, order, out_name):
    """One order with every EventSync blocking the host and with the host
    syncs deferred (runtime/executor.py): the outputs bit for bit, and in
    turns (blocking, deferred, deferred, blocking) each one's wall and
    breakdown.py's idle share per iteration and the host blocks it
    executed."""
    from tenzing_tpu_torch.bench.breakdown import measure

    outs = {mode: ex.run(order)[out_name] for mode, ex in exs.items()}
    equal = bool(torch.equal(outs["blocking"], outs["deferred"]))
    del outs
    runs = {}
    for mode in ("blocking", "deferred", "deferred", "blocking"):
        runs.setdefault(mode, []).append(measure(exs[mode], order,
                                                 iters=HOST_SYNC_ITERS))
    row = {"phase": "host_syncs", "workload": workload, "order": label,
           "ops": len(order), "out": out_name, "bit_equal": equal}
    for mode, ms in runs.items():
        row[mode] = {"wall_us": [m["wall_us"] for m in ms],
                     "idle_share": [m["idle_share"] for m in ms],
                     "host_syncs_per_iter": [m["host_syncs_per_iter"]
                                             for m in ms]}
    emit(row)
    return row


def phase_host_syncs(torch, device):
    """The chunk directive's host wait, blocking and deferred: the moe
    pipeline's chunked orders (every expert MLP on .xla, unchunked and
    chunked 2 and 4 ways, f32 chains on the host and on the device copy, 2
    lanes) and attention's naive order with every fold unchunked and
    chunked 2 and 4 ways (1 lane), each run with every EventSync blocking
    and with the host syncs deferred.  The outputs must be bit-equal; the
    chunked attention orders must execute fewer host blocks deferred (an
    EventSync precedes each chunked block but the first); the moe orders
    the same number (their directive follows the dispatch await, a host
    op)."""
    from tenzing_tpu_torch.bench.driver import attn_graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.models.moe_pipeline import chunked_orders, host_buffer_names
    from tenzing_tpu_torch.models.ring_attention import fixed_order, make_blocked_buffers
    from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

    def executors(plat, bufs):
        return {mode: StreamExecutor(plat, bufs, device="cuda",
                                     defer_host_syncs=mode == "deferred")
                for mode in ("blocking", "deferred")}

    rows, failed = [], []
    m, mbufs, cap = moe_full()
    tb = buffers_from_numpy(mbufs, device, host_buffer_names(m, "choice"))
    del mbufs
    exs = executors(Platform.make_n_lanes(2), tb)
    for chain in (".f32-host", ".f32-rdma"):
        orders, _ = chunked_orders(m, cap, chain=chain)
        for label, order in orders.items():
            row = _host_sync_row(torch, exs, "moe", f"{chain[1:]}/{label}", order,
                             "Y")
            rows.append(row)
            if not (row["bit_equal"] and row["deferred"]["host_syncs_per_iter"]
                    == row["blocking"]["host_syncs_per_iter"]):
                failed.append(row["order"])
    del exs, tb
    torch.cuda.empty_cache()

    a = attn_full_args()
    bufs, _ = make_blocked_buffers(a, seed=0, with_expected=False)
    tb = buffers_from_numpy(bufs, device)
    del bufs
    one = Platform.make_n_lanes(1)
    exs = executors(one, tb)
    gc = attn_graph(a, chunk=True, chunk_relax=True)
    for n in (1, 2, 4):
        order = (fixed_order(gc, one) if n == 1 else
                 fixed_order(gc, one, kernel_of=lambda s, n=n: f".xla.chunked.c{n}"))
        row = _host_sync_row(torch, exs, "attn", f"naive/c{n}", order, "O")
        rows.append(row)
        fewer = (row["deferred"]["host_syncs_per_iter"][0]
                 < row["blocking"]["host_syncs_per_iter"][0])
        if not (row["bit_equal"] and (fewer if n > 1 else True)):
            failed.append(f"attn/c{n}")
    del exs, tb
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"host_syncs phase failed on {failed}")
    return rows


def phase_moe_layer_kernels(torch, device, timer):
    """``ffn_rows`` at the layer's chunk shape (chunk 0's received slot
    table at world size 1: n = 2048, d 512, d_ff 2048) and at ragged n
    (2047, 37) against its plain version at ``FFN_TOL``; the erf gelu control
    must be rejected and two launches must give the same bits; the kernel's,
    the plain version's and the ``matmul -> gelu -> matmul`` three-call times
    beside the bound."""
    import numpy as np
    import torch.nn.functional as F

    from tenzing_tpu_torch.models.moe import MoEArgs, make_moe_buffers
    from tenzing_tpu_torch.ops import ffn_kernels as fk

    a = MoEArgs(**MOE_LAYER)
    bufs, _, _ = make_moe_buffers(a, seed=0)
    idx = torch.from_numpy(bufs["disp_idx_0"][0].reshape(-1)).long()
    x0 = torch.from_numpy(bufs["X"][:a.chunk_tokens])[idx].contiguous().to(device)
    w1 = torch.from_numpy(bufs["W1"][0].astype(np.float32)).to(device)
    w2 = torch.from_numpy(bufs["W2"][0].astype(np.float32)).to(device)
    del bufs
    gen = torch.Generator(device=device)
    gen.manual_seed(1)

    def rand_case(n):
        return torch.randn(n, a.d_model, device=device, generator=gen), w1, w2

    def bf16(case):
        return tuple(t.to(torch.bfloat16) for t in case)

    cases = [("chunk", (x0, w1, w2)), ("ragged-n2047", rand_case(2047)),
             ("ragged-n37", rand_case(37)), ("chunk-bf16", bf16((x0, w1, w2))),
             ("ragged-n2047-bf16", bf16(rand_case(2047))),
             ("ragged-n37-bf16", bf16(rand_case(37)))]
    rows, failed = [], []
    for label, (x, cw1, cw2) in cases:
        n, d = x.shape
        dff = cw1.shape[1]
        is16 = x.dtype == torch.bfloat16
        tol = fk.FFN_BF16_TOL if is16 else fk.FFN_TOL
        got = fk.ffn_rows(x, cw1, cw2)
        again = fk.ffn_rows(x, cw1, cw2)
        want = fk.ffn_rows_plain(x, cw1, cw2)
        if is16:
            # a skipped hidden tile: W1's last 64 columns zeroed (the erf
            # gelu moves y by less than a bf16 ulp)
            w1c = cw1.clone()
            w1c[:, -64:] = 0
            ctl = fk.ffn_rows_plain(x, w1c, cw2)
            del w1c
        else:
            ctl = fk.ffn_rows_plain(x, cw1, cw2, approximate="none")
        torch.cuda.synchronize()
        flops = fk.ffn_flops(1, n, d, dff)
        nbytes = fk.ffn_bytes(1, n, d, dff, itemsize=x.element_size())
        bound, bound_by = attn_bound(nbytes, flops, bf16=is16)
        g32, w32 = got.float(), want.float()
        row = {"phase": "moe_layer_kernels", "case": label, "kernel": "ffn_rows",
               "dtype": str(x.dtype).replace("torch.", ""),
               "shape": [n, d, dff], "tolerance": tol,
               "max_abs_err": float((g32 - w32).abs().max()),
               "within_tol": bool(torch.allclose(g32, w32, **tol)),
               "deterministic": bool(torch.equal(got, again)),
               "finite": bool(torch.isfinite(g32).all()),
               "control": "skipped_hidden_tile" if is16 else "erf_gelu",
               "control_max_abs_err": float((ctl.float() - w32).abs().max()),
               "control_rejected": not torch.allclose(ctl.float(), w32,
                                                      **tol),
               "y_max_abs": float(w32.abs().max()),
               "flops": flops, "bytes": nbytes,
               "bound_ms": bound, "bound_by": bound_by}
        del again, ctl, g32, w32
        if label.startswith("chunk"):
            row.update({
                "ms": timer.ms(lambda: fk.ffn_rows(x, cw1, cw2, out=got)),
                "plain_ms": timer.ms(lambda: fk.ffn_rows_plain(x, cw1, cw2)),
                # no single PyTorch call computes the function: three calls
                "library_calls_ms": timer.ms(lambda: torch.matmul(F.gelu(
                    torch.matmul(x, cw1), approximate="tanh"), cw2)),
                "library_calls": "torch.matmul -> gelu(tanh) -> torch.matmul"})
        emit(row)
        rows.append(row)
        if not (row["within_tol"] and row["deterministic"] and row["finite"]
                and row["control_rejected"]):
            failed.append(label)
        del got, want
    del cases, x0, w1, w2
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"moe layer kernels phase failed on {failed}")
    return rows


def _drop_expert(torch, y, bufs, a, expert: int = 0):
    """The control: the gathered Y with every token routed to ``expert``
    zeroed, as if that expert's output were dropped."""
    out = y.clone()
    t, tc = a.tokens_per_shard, a.chunk_tokens
    for c in range(a.n_chunks):
        idx, w = bufs[f"disp_idx_{c}"], bufs[f"disp_w_{c}"]
        for s in range(a.n_ep):
            rows = s * t + c * tc + idx[s, expert][w[s, expert] > 0]
            out[torch.from_numpy(rows.astype("int64")).to(out.device)] = 0.0
    return out


def phase_moe_layer(torch, device, timer):
    """The expert-parallel MoE layer (models/moe.py) at full width on a
    world-size-1 NCCL group initialised here through a ``file://``
    rendezvous and torn down at the end: the dryrun's agreement protocol
    (parallel/dryrun.py: an all-.xla, an all-.pallas and a mixed schedule,
    Y within ``dryrun.Y_TOL`` of the float64 expected, ``ffn_rows`` launched
    by the .pallas ones), a control with expert 0's output dropped that
    must be rejected, the self all-to-all's time per chunk, and a short
    ``explore`` through ``DistControlPlane``.  Returns the launch counts of
    the agreement and the search."""
    import tempfile

    import torch.distributed as dist

    from tenzing_tpu_torch.models.moe import MoEArgs, make_moe_buffers
    from tenzing_tpu_torch.parallel import dryrun
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import close_mesh, control_group, init_mesh

    t0 = time.time()
    a = MoEArgs(**MOE_LAYER)
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="tz_moe_layer_") as d:
        mesh = init_mesh("ep", "nccl", "file://" + os.path.join(d, "rv"), 0, 1)
        try:
            cp = DistControlPlane(control_group())
            layer = dryrun.build_layer(mesh, device, a, seed=0,
                                       impl_choice=True)
            setup_s = time.time() - t0
            reset_launches()
            rows, orders = dryrun.agree_schedules(layer, cp)
            search = dryrun.explore_layer(layer, cp, MOE_LAYER_ITERS)
            launches = all_launches()
            for r in rows:
                emit({"phase": "moe_layer", "y_tolerance": dryrun.Y_TOL, **r})
            pallas = next(o for o, r in zip(orders, rows)
                          if set(r["ffn_slots"]) == {".pallas"})
            y = dryrun.run_gathered(layer, pallas)
            bufs, _, _ = make_moe_buffers(a, seed=0)
            ctl = _drop_expert(torch, y, bufs, a)
            del bufs
            ctl_ok = bool(torch.allclose(ctl, layer.want, **dryrun.Y_TOL))
            # the exchange of one chunk's slot table, as the layer posts it,
            # beside a plain device copy of the same bytes
            ex_bufs = layer.executor.init_bufs
            src, dst = ex_bufs["send_disp_0"], ex_bufs["recv_disp_0"]
            group = mesh.group("ep")
            a2a_ms = timer.ms(lambda: dist.all_to_all_single(dst, src,
                                                             group=group))
            copy_ms = timer.ms(lambda: dst.copy_(src))
            nbytes = 2 * src.numel() * src.element_size()
            row = {"phase": "moe_layer_summary", "args": MOE_LAYER,
                   "schedules": len(rows),
                   "dropped_expert_control": {
                       "max_abs_err": float((ctl - layer.want).abs().max()),
                       "within_tol": ctl_ok},
                   "self_a2a_per_chunk_ms": a2a_ms, "copy_per_chunk_ms": copy_ms,
                   "a2a_bytes": nbytes, "a2a_bound_ms": bound_ms(nbytes),
                   "explore": {k: v for k, v in search.items() if k != "pct50_s"},
                   "explore_pct50_s": search["pct50_s"],
                   "launches": launches, "setup_s": round(setup_s, 3),
                   "wall_s": round(time.time() - t0, 3)}
            emit(row)
            del layer, y, ctl, src, dst, ex_bufs
            torch.cuda.empty_cache()
            # the same layer in bf16: its .pallas slot is the bf16 ffn_rows
            a16 = MoEArgs(**MOE_LAYER, dtype="bfloat16")
            layer16 = dryrun.build_layer(mesh, device, a16, seed=0,
                                         impl_choice=True)
            reset_launches()
            rows16, orders16 = dryrun.agree_schedules(layer16, cp)
            launches16 = all_launches()
            for r in rows16:
                emit({"phase": "moe_layer_bf16",
                      "y_tolerance": dryrun.Y_TOL_BF16, **r})
            pallas16 = next(o for o, r in zip(orders16, rows16)
                            if set(r["ffn_slots"]) == {".pallas"})
            y16 = dryrun.run_gathered(layer16, pallas16)
            bufs16, _, _ = make_moe_buffers(a16, seed=0)
            ctl16 = _drop_expert(torch, y16, bufs16, a16)
            del bufs16
            ctl16_ok = dryrun.y_within(ctl16, layer16.want, "bfloat16")
            row16 = {"phase": "moe_layer_bf16_summary", "args": asdict(a16),
                     "schedules": len(rows16),
                     "dropped_expert_control": {
                         **dryrun.y_error(ctl16, layer16.want),
                         "within_tol": ctl16_ok},
                     "launches": launches16,
                     "wall_s": round(time.time() - t0, 3)}
            emit(row16)
            del layer16, y16, ctl16
        finally:
            close_mesh()
    torch.cuda.empty_cache()
    if ctl_ok or ctl16_ok:
        raise AssertionError("a dropped-expert control passed the Y "
                             f"tolerance (f32 {ctl_ok}, bf16 {ctl16_ok})")
    if launches["ffn_rows"] <= 0:
        raise AssertionError("the moe layer never launched ffn_rows")
    if launches16["ffn_rows_bf16"] <= 0:
        raise AssertionError("the bf16 moe layer never launched ffn_rows in "
                             "bf16")
    if search["rollouts"] < 1:
        raise AssertionError(f"the moe layer search measured nothing: {search}")
    return launches, rows, row, launches16


def phase_mesh_halo(torch, device):
    """The mesh halo exchange at the flagship width per rank on a
    world-size-1 NCCL group and a 1x1x1 mesh: the dryrun's agreement
    (parallel/dryrun.py ``agree_halo``: U bit-exact on every schedule, the
    engine menu's all-``.xla``, all-``.rdma`` and mixed orders among them)
    and an MCTS on the engine menu; returns the launch counts and the
    summary row."""
    import tempfile

    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.parallel import dryrun
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import close_mesh, control_group, init_mesh

    t0 = time.time()
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="tz_mesh_halo_") as d:
        mesh = init_mesh(dryrun.HALO_AXES, "nccl",
                         "file://" + os.path.join(d, "rv"), 0, 1,
                         shape=(1, 1, 1))
        try:
            cp = DistControlPlane(control_group())
            h = dryrun.build_halo(mesh, device,
                                  HaloArgs(**dryrun.HALO_FULL_ARGS), seed=0)
            setup_s = time.time() - t0
            reset_launches()
            rows = dryrun.agree_halo(h, cp)
            search = dryrun.explore_halo(h, cp, MESH_HALO_ITERS)
            launches = all_launches()
            for r in rows:
                emit({"phase": "mesh_halo", **r})
            row = {"phase": "mesh_halo_summary",
                   "args": dryrun.HALO_FULL_ARGS, "mesh": [1, 1, 1],
                   "schedules": len(rows),
                   "engines_scheduled": sorted({e for r in rows
                                                for e in r["engines"]}),
                   "explore": {k: v for k, v in search.items()
                               if k != "pct50_s"},
                   "iteration_pct50_ms": [t * 1e3 for t in search["pct50_s"]],
                   "launches": launches, "setup_s": round(setup_s, 3),
                   "wall_s": round(time.time() - t0, 3)}
            emit(row)
            del h
        finally:
            close_mesh()
    torch.cuda.empty_cache()
    whole = {tuple(sorted(set(r["engines"]))) for r in rows}
    if not {("xla",), ("rdma",)} <= whole:
        raise AssertionError(f"the mesh halo agreement lacks an all-.xla or "
                             f"an all-.rdma schedule: {whole}")
    if search["rollouts"] < 1:
        raise AssertionError(f"the mesh halo search measured nothing: {search}")
    if launches["device_copy"] <= 0:
        raise AssertionError("the mesh halo's .rdma loopback never launched "
                             "device_copy")
    return launches, row


def phase_mesh_halo_shared(torch):
    """Two ranks on GPU 0 over gloo, a 2x1x1 mesh, every exchange ``.rdma``
    (parallel/dryrun.py ``halo_shared_main``): per rank, U exact, both shift
    kernels launched, the write-after-read probe exact, and one x face's
    shift timed and held against ``torch.roll``; returns the ranks' rows."""
    from tenzing_tpu_torch.parallel import dryrun
    from tenzing_tpu_torch.parallel.launch import launch

    t0 = time.time()
    ranks = launch("tenzing_tpu_torch.parallel.dryrun:halo_shared_main", 2,
                   "cuda", {"args": dryrun.HALO_FULL_ARGS, "time_reps": 20},
                   timeout_s=600.0, mesh_axes=dryrun.HALO_AXES,
                   mesh_shape=(2, 1, 1), shared_card=True)
    bad = []
    for r in ranks:
        emit({"phase": "mesh_halo_shared", "args": dryrun.HALO_FULL_ARGS, **r})
        t = r["timing"]
        if not (all(s["u_exact"] for s in r["schedules"])
                and r["launches"]["rdma_shift_post"] > 0
                and r["launches"]["rdma_shift_wait"] > 0
                and r["war"]["acc_exact"] and t["exact_vs_roll"]
                and t["plain_exact"]):
            bad.append(r["rank"])
    emit({"phase": "mesh_halo_shared_summary", "ranks": len(ranks),
          "wall_s": round(time.time() - t0, 3)})
    if bad:
        raise AssertionError(f"the shared-card mesh halo failed on ranks {bad}")
    return ranks


def phase_dfs_example(torch):
    """The DFS example at the reference's size with a small cap."""
    import contextlib
    import io

    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.examples import spmv_dfs
    from tenzing_tpu_torch.models.spmv import SpMVCompound
    from tenzing_tpu_torch.solve.dfs import enumerate_schedules

    t0 = time.time()
    cap = 12
    path = os.path.join(OUT_DIR, "spmv_dfs.csv")
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        rc = spmv_dfs.main(["--matrix-m", "150000", "--max-seqs", str(cap),
                            "--benchmark-iters", "10", "--dump-csv", path])
        # the example's enumeration again (it is deterministic), for its count
        g = Graph()
        g.start_then(SpMVCompound())
        g.then_finish(SpMVCompound())
        n_terminals = len(enumerate_schedules(g, Platform.make_n_lanes(2), cap))
    with open(path) as f:
        n_rows = sum(1 for line in f if line.strip())
    best = [line for line in err.getvalue().splitlines() if line.startswith("best:")]
    row = {"phase": "dfs_example", "rc": rc, "schedules_measured": n_rows,
           "unique_terminals_enumerated": n_terminals, "cap": cap,
           "best": best[0] if best else None, "wall_s": round(time.time() - t0, 3)}
    emit(row)
    if rc != 0 or n_rows < 1 or n_terminals < n_rows or not best:
        raise AssertionError(f"the dfs example failed: {row}")
    torch.cuda.empty_cache()
    return row


def main() -> int:
    global _log
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device available\n")
        return 2
    sys.path.insert(0, REPO)
    from tenzing_tpu_torch.bench import driver
    from tenzing_tpu_torch.ops import kernel_lib

    os.makedirs(OUT_DIR, exist_ok=True)
    _log = open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "w")
    t_start = time.time()
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    precision = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "float32_matmul_precision": torch.get_float32_matmul_precision()}
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
          "name": torch.cuda.get_device_name(0), **precision})
    if precision != {"allow_tf32": False, "float32_matmul_precision": "highest"}:
        raise AssertionError(f"float32 matmuls must not use TF32: {precision}")

    t0 = time.time()
    kernel_lib.lib()
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "compiled": kernel_lib.build_info.get("compiled"),
          "sources": list(kernel_lib.SOURCES),
          "library": os.path.relpath(kernel_lib.build_info["path"], REPO)})
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(str(kernel_lib.build_info.get("ptxas", "(library was cached)")))

    timer = Timer(torch, device)
    t0 = time.time()
    summary = phase_kernels(torch, device, timer)
    emit({"phase": "kernels", "rows": sum(len(v) for v in summary.values()),
          "all_exact": True, "wall_s": round(time.time() - t0, 3)})

    t0 = time.time()
    ex_info = phase_executor(torch, device)
    emit({"phase": "executor", **ex_info, "wall_s": round(time.time() - t0, 3)})

    t0 = time.time()
    req = driver.DriverRequest(mcts_iters=12, iters=3, search_iters=2,
                               climb_budget=4)
    reset_launches()
    result = driver.run(req, device="cuda")
    launches = all_launches()
    verdict = result.verdict
    print(result.to_json_line(), flush=True)
    emit({"phase": "driver", "launches": launches,
          "verified": verdict.get("verified"), "climbs": verdict.get("climbs"),
          "wall_s": round(time.time() - t0, 3)})
    if verdict.get("metric") != "halo_iter_pct50_searched_n512":
        raise AssertionError(f"driver metric {verdict.get('metric')!r}")
    if verdict.get("verified") is not True:
        raise AssertionError(f"driver result not verified: {verdict}")
    if not verdict.get("climbs") or not all(c["spent"] > 0
                                            for c in verdict["climbs"]):
        raise AssertionError(f"the halo climbs did not run: {verdict}")
    missing = [k for k in ("halo_pack", "halo_unpack", "device_copy")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")

    t0 = time.time()
    attn_rows = phase_attn_kernels(torch, device, timer)
    emit({"phase": "attn_kernels", "rows": len(attn_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    want_o, attn_ex = phase_attn_executor(torch, device)
    emit({"phase": "attn_executor", **attn_ex,
          "wall_s": round(time.time() - t0, 3)})
    attn_launches = phase_attn_driver(torch, device, want_o)
    t0 = time.time()
    afused_rows, afused_timing, sdpa_ms = phase_attn_fused(torch, device, timer,
                                                           want_o)
    emit({"phase": "attn_fused", "rows": len(afused_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    afused_launches = phase_attn_fused_driver(torch, device)
    emit({"phase": "attn_fused_driver", "wall_s": round(time.time() - t0, 3)})

    t0 = time.time()
    moe_rows = phase_moe_kernels(torch, device, timer)
    emit({"phase": "moe_kernels", "rows": len(moe_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    want_y, moe_ex = phase_moe_executor(torch, device)
    emit({"phase": "moe_executor", **moe_ex,
          "wall_s": round(time.time() - t0, 3)})
    moe_launches = phase_moe_driver(torch, device, want_y)
    t0 = time.time()
    chunk_rows, chunk_const = phase_chunk(torch, device, timer, want_o,
                                          want_y)
    emit({"phase": "chunk", "rows": len(chunk_rows), "all_within_tol": True,
          "wall_s": round(time.time() - t0, 3)})
    del want_y, want_o
    t0 = time.time()
    sync_rows = phase_host_syncs(torch, device)
    emit({"phase": "host_syncs", "rows": len(sync_rows), "all_bit_equal": True,
          "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    chunk_launches = phase_chunk_driver(torch, device)
    emit({"phase": "chunk_driver", "wall_s": round(time.time() - t0, 3)})

    t0 = time.time()
    layer_rows = phase_moe_layer_kernels(torch, device, timer)
    emit({"phase": "moe_layer_kernels", "rows": len(layer_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    layer_launches, _, layer_summary, layer16_launches = phase_moe_layer(
        torch, device, timer)
    mesh_launches, mesh_summary = phase_mesh_halo(torch, device)
    shared_ranks = phase_mesh_halo_shared(torch)

    t0 = time.time()
    spmv_rows = phase_spmv_kernels(torch, device, timer)
    emit({"phase": "spmv_kernels", "rows": len(spmv_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    spmv_ex = phase_spmv_executor(torch, device)
    emit({"phase": "spmv_executor", **spmv_ex,
          "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    fused_rows, fused_timing = phase_fused(torch, device, timer)
    emit({"phase": "fused", "rows": len(fused_rows), "all_within_tol": True,
          "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    sweep = phase_fused_sweep(torch, device, timer)
    emit({"phase": "fused_sweep", "rows": len(sweep), "all_within_tol": True,
          "wall_s": round(time.time() - t0, 3)})
    spmv_launches = phase_spmv_driver(torch, device)
    phase_dfs_example(torch)

    # one halo iteration's six faces at the batched blocking, per kernel
    def six_faces(rows, blocking):
        picked = [r for r in rows if r["slot"] == blocking or (
            blocking == ".pallasb" and r["slot"] == ".pallas"
            and not any(q["face"] == r["face"] and q["slot"] == ".pallasb"
                        for q in rows))]
        return {key: sum(r[key] for r in picked)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}

    sources = {
        "halo_pack": ("tenzing_tpu_torch/csrc/halo_pack.cu",
                      "tenzing_tpu/ops/halo_pallas.py:189",
                      ".pallasb"),
        "halo_unpack": ("tenzing_tpu_torch/csrc/halo_unpack.cu",
                        "tenzing_tpu/ops/halo_pallas.py:221",
                        ".pallasb"),
        "device_copy": ("tenzing_tpu_torch/csrc/device_copy.cu",
                        "tenzing_tpu/ops/rdma.py:138",
                        ".rdma"),
    }
    kernels = []
    for name, (src, replaces, blocking) in sources.items():
        rows = summary[name]
        agg = six_faces(rows, blocking)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            # device_copy also runs on the moe path's .rdma chains
            "launches": launches[name] + (moe_launches[name]
                                          if name == "device_copy" else 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "bound_by": "bytes",
            "library_ms": agg["library_ms"],
            "work": "six faces of one halo iteration, "
                    + ("staging copies" if name == "device_copy"
                       else "batched blocking (one row per block on x)"),
        })
        if name == "device_copy":
            kernels[-1]["launches_by_path"] = {"halo": launches[name],
                                               "moe": moe_launches[name]}
    # the attention kernels: the f32 row at the main path's shapes, the bf16
    # row beside it; launches count both input types
    for name, case, replaces, work in (
            ("attn_block", "block-{}-init",
             "tenzing_tpu/ops/attention_pallas.py:66",
             "one 1024-key block into the (4, 8192, 128) state"),
            ("attn_fused", "fused-{}",
             "tenzing_tpu/ops/attention_pallas.py:165",
             "all 8192 keys into the (4, 8192, 128) state")):
        by_case = {r["case"]: r for r in attn_rows}
        f32, bf16 = by_case[case.format("f32")], by_case[case.format("bf16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tenzing_tpu_torch/csrc/attn_fold.cu",
            "replaces": replaces,
            "launches": attn_launches[name] + attn_launches[name + "_bf16"],
            "max_abs_err": max(r["max_abs_err"] for r in attn_rows
                               if r["kernel"] == name and not r["bf16_inputs"]),
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "work": work + ", f32 inputs",
            "launches_bf16_inputs": attn_launches[name + "_bf16"],
            "bf16": {key: bf16[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")} | {
                "max_abs_err": max(r["max_abs_err"] for r in attn_rows
                                   if r["kernel"] == name and r["bf16_inputs"])},
        })
    # the expert MLP at the main path's shapes (one chunk's slot table)
    full = next(r for r in moe_rows if r["case"] == "full")
    e, c, d, dff = full["shape"]
    kernels.append({
        "name": "ffn_batched", "route": "cuda",
        "source": "tenzing_tpu_torch/csrc/ffn_expert.cu",
        "replaces": "tenzing_tpu/ops/ffn_pallas.py:101",
        "launches": moe_launches["ffn_batched"],
        "max_abs_err": max(r["max_abs_err"] for r in moe_rows),
        "ms": full["ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it
        "library_calls_ms": full["library_calls_ms"],
        "library_calls": full["library_calls"],
        "work": f"one chunk's expert MLP: {e} experts x {c} slots, d {d}, "
                f"d_ff {dff}, f32",
    })
    # the MoE layer's .pallas expert MLP at one chunk's shape, f32 and bf16
    for dt, case, name, launched in (
            ("float32", "chunk", "ffn_rows", layer_launches["ffn_rows"]),
            ("bfloat16", "chunk-bf16", "ffn_rows_bf16",
             layer16_launches["ffn_rows_bf16"])):
        lrow = next(r for r in layer_rows if r["case"] == case)
        n, d, dff = lrow["shape"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tenzing_tpu_torch/csrc/ffn_rows.cu",
            "replaces": "tenzing_tpu/ops/ffn_pallas.py:43",
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for r in layer_rows
                               if r["dtype"] == dt),
            "ms": lrow["ms"], "plain_ms": lrow["plain_ms"],
            "bound_ms": lrow["bound_ms"], "bound_by": lrow["bound_by"],
            "library_ms": None,  # no single PyTorch call computes it
            "library_calls_ms": lrow["library_calls_ms"],
            "library_calls": lrow["library_calls"],
            "work": f"one chunk's expert MLP of the MoE layer at world size "
                    f"1: n {n}, d {d}, d_ff {dff}, {dt}",
        })
    kernels[-2]["self_a2a_per_chunk_ms"] = layer_summary[
        "self_a2a_per_chunk_ms"]
    # the mesh shift: one x face of the flagship halo between two ranks on
    # one card (time-sliced contexts, not NVLink); the slower rank's times
    timing = [r["timing"] for r in shared_ranks]
    face_bytes = timing[0]["bytes"]
    for name, key, replaces, nbytes in (
            ("rdma_shift_post", "post_ms", "tenzing_tpu/ops/rdma.py:189",
             face_bytes),
            ("rdma_shift_wait", "wait_ms", "tenzing_tpu/ops/rdma.py:225", 8)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tenzing_tpu_torch/csrc/rdma_shift.cu",
            "replaces": replaces,
            "launches": sum(r["launches"][name] for r in shared_ranks),
            "launches_by_rank": [r["launches"][name] for r in shared_ranks],
            "max_abs_err": max(t["max_abs_err"] for t in timing),
            "ms": max(t[key] for t in timing),
            "plain_ms": max(t["plain_ms"] for t in timing),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None,  # NCCL refuses two ranks on one device
            "by_rank_ms": [t[key] for t in timing],
            "post_wait_ms": max(t["post_wait_ms"] for t in timing),
            "barrier_ms": max(t["barrier_ms"] for t in timing),
            "work": "one x face (3, 3, 512, 512) f32 of the flagship halo "
                    "between two ranks sharing one card through CUDA IPC "
                    "(time-sliced contexts, not NVLink)",
        })
    next(k for k in kernels if k["name"] == "device_copy")[
        "launches_mesh_halo"] = mesh_launches["device_copy"]
    # the SpMV kernel at the --m 8192 path's spmv_remote shapes
    main_row = next(r for r in spmv_rows if r["case"].startswith("m8192"))
    kernels.append({
        "name": "ell_spmv", "route": "cuda",
        "source": "tenzing_tpu_torch/csrc/ell_spmv.cu",
        "replaces": "tenzing_tpu/ops/spmv_pallas.py:78",
        "launches": spmv_launches[8192]["ell_spmv"],
        "max_abs_err": max(r["max_abs_err"] for r in spmv_rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_call": main_row["library_call"],
        "work": "spmv_remote at m=8192: a (%d, %d) slab, x of %d" % tuple(
            main_row["shape"]),
    })
    # the fused regions of the m=150000 naive order (host exchange), at one
    # tile: no single library call computes a region; the stepped members'
    # summed time stands beside it
    host_t = [r for r in fused_timing if r["exchange"] == "host"]
    kernels.append({
        "name": "fused_region", "route": "cuda",
        "source": "tenzing_tpu_torch/csrc/fused_region.cu",
        "replaces": "tenzing_tpu/runtime/fused.py:358",
        "launches": spmv_launches[150_000]["fused_region"],
        "max_abs_err": max(max(r["vs_plain"].values()) for r in fused_rows),
        "ms": sum(r["ms"] for r in host_t),
        "plain_ms": sum(r["plain_ms"] for r in host_t),
        "bound_ms": sum(r["bound_ms"] for r in host_t), "bound_by": "bytes",
        "library_ms": None,
        "stepped_members_ms": sum(r["stepped_ms"] for r in host_t),
        "work": "the two regions of the m=150000 naive order, one tile: "
                + "; ".join("+".join(r["members"]) for r in host_t),
    })
    # the attention members of the same kernel: the naive .xla order's one
    # region (8 folds + finalize) at one tile; one f32
    # scaled_dot_product_attention call computes its O
    naive_t = next(r for r in afused_timing
                   if r["order"] == "naive" and r["tiles"] == 1)
    kernels.append({
        "name": "fused_region_attn", "route": "cuda",
        "source": "tenzing_tpu_torch/csrc/fused_region.cu",
        "replaces": "tenzing_tpu/runtime/fused.py:358",
        "launches": afused_launches["fused_region"],
        "max_abs_err": max(max(v["max_abs"] for v in r["vs_plain"].values())
                           for r in afused_rows),
        "ms": naive_t["ms"], "plain_ms": naive_t["plain_ms"],
        "bound_ms": naive_t["bound_ms"], "bound_by": naive_t["bound_by"],
        "library_ms": sdpa_ms,
        "stepped_members_ms": naive_t["stepped_ms"],
        "by_tiles_ms": {str(r["tiles"]): r["ms"] for r in afused_timing
                        if r["order"] == "naive"},
        "work": "the naive .xla attention order's region at one tile: "
                + "+".join(naive_t["members"]),
        "chunk_constants": {k: chunk_const[k] for k in (
            "dispatch_us_measured", "CHUNK_DISPATCH_US", "xfer_gbs_measured",
            "XFER_GBS")},
        "launches_chunk_driver": {w: c["fused_region"]
                                  for w, c in chunk_launches.items()},
    })
    emit({"phase": "done", "wall_s": round(time.time() - t_start, 3)})
    _log.close()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
