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
              Y within ``BF16_Y_TOL`` of the expected.

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
    from tenzing_tpu_torch.ops import halo_kernels as hk
    from tenzing_tpu_torch.ops import rdma

    return (hk.LAUNCHES, rdma.LAUNCHES, ak.LAUNCHES, fk.LAUNCHES)


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
    moe_rows = phase_moe_kernels(torch, device, timer)
    emit({"phase": "moe_kernels", "rows": len(moe_rows),
          "all_within_tol": True, "wall_s": round(time.time() - t0, 3)})
    t0 = time.time()
    want_y, moe_ex = phase_moe_executor(torch, device)
    emit({"phase": "moe_executor", **moe_ex,
          "wall_s": round(time.time() - t0, 3)})
    moe_launches = phase_moe_driver(torch, device, want_y)
    del want_y

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
