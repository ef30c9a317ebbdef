"""Single-device MoE dispatch/combine pipeline: the ``--workload moe`` search.

Counterpart of ``tenzing_tpu/models/moe_pipeline.py``.  Routed tokens travel
to the resident experts and back through a transfer hop — the host round trip
through pinned memory (``HostSpillStart`` -> ``HostFetchStart``) or a
device-resident copy (``RdmaCopyStart``, the ``.rdma`` engine) — the
one-device analog of an expert-parallel deployment's dispatch and combine
all-to-alls.  Numerically it is the one-shard case: Y equals the dense routed
evaluation whatever the schedule.

Per microbatch chunk ``c`` the DAG is::

    pack_c (gather routed tokens into the slot table, staged as (rows, 128))
      -> spilld_c -> fetchd_c | xferd_c.rdma -> awaitd_c   # dispatch hop
      -> ffn_c (per-expert gelu MLP; the .xla / .pallas menu)
      -> spillc_c -> fetchc_c | xferc_c.rdma -> awaitc_c   # combine hop
      -> combine_c (gate-weighted scatter-add into Y_c)
    all combine_c -> concat -> finish

The ``n_chunks`` chains are independent.  With ``staging="choice"`` each
chain is a :class:`StagingChoice` over f32 / bf16 transfers x host / rdma
engine; bf16 chains carry a ``16`` suffix on their op and buffer names.  Op
names, menu suffixes, kind tags and schedule JSON are the reference's.

Differences from the reference, on purpose:

* **In place.**  Ops write into their output buffers or into declared op
  scratch (``DeviceOp.scratch``, per chunk, since chunks run on different
  lanes at once): the gather is ``index_select(out=)``, the bf16 cast a
  ``copy_`` into the staging view, the MLP ``bmm(out=)`` around an in-place
  gelu, the combine ``mul(out=)`` and ``index_add_``, the concat
  ``cat(out=)``.  A timed run allocates nothing.
* **bf16 buffers** are ``torch.bfloat16`` tensors: :func:`make_pipe_buffers`
  describes them as ``ZerosSpec`` (numpy has no bfloat16 without
  ``ml_dtypes``) and ``buffers_from_numpy`` creates them.
* **The naive order is derived through the synchronizer** (an EventSync
  before each host hop that reads a device op's output), as the port's halo
  naive order is: the reference writes it by hand without sync ops, which is
  a race on CUDA (ROADMAP Queue 3 item 1).
* **Each host round trip posts its spill and fetch on one transfer channel**,
  so the fetch never reads pinned memory before the spill has written it.

Not in this slice: ``ExpertFFNPipePartial`` and ``ffn_chunk_menu`` (the
chunked expert MLP of ``--chunk``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import ChoiceOp, CompoundOp, DeviceOp, OpBase
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.models.halo_pipeline import unflatten_face
from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer, HostFetchStart, HostSpillStart
from tenzing_tpu_torch.runtime.executor import ZerosSpec
from tenzing_tpu_torch.utils.numeric import gelu_tanh


@dataclass(frozen=True)
class MoEPipeArgs:
    n_experts: int = 8
    tokens: int = 8192  # total tokens on the device
    d_model: int = 512
    d_ff: int = 2048
    n_chunks: int = 4  # independent dispatch->expert->combine chains
    dtype: str = "float32"

    @property
    def chunk_tokens(self) -> int:
        assert self.tokens % self.n_chunks == 0
        return self.tokens // self.n_chunks


def _slot_shape(args: MoEPipeArgs, cap: int) -> Tuple[int, int, int]:
    return (args.n_experts, cap, args.d_model)


def _sfx(prec: str) -> str:
    """The op/buffer name suffix of a staging precision."""
    return "16" if prec == "bf16" else ""


class DispatchPackPipe(DeviceOp):
    """Gather chunk ``c``'s routed tokens into the capacity-padded slot table,
    written into the (rows, 128) staging buffer ``send<s>_c``.  With
    ``prec="bf16"`` the staging buffer is bfloat16: the gather lands in f32
    scratch and is rounded to nearest-even as it is copied in."""

    def __init__(self, name: str, c: int, args: MoEPipeArgs, cap: int,
                 prec: str = "f32"):
        super().__init__(name)
        self._c, self._args, self._cap = c, args, cap
        self._sfx = _sfx(prec)

    def reads(self):
        return ["X", f"idx_{self._c}"]

    def writes(self):
        return [f"send{self._sfx}_{self._c}"]

    def scratch(self):
        a = self._args
        if not self._sfx:
            return {}
        return {f"moe_slots_{self._c}": ((a.n_experts * self._cap, a.d_model),
                                         "float32")}

    def apply(self, bufs, ctx):
        import torch

        a, tc_ = self._args, self._args.chunk_tokens
        xc = bufs["X"][self._c * tc_:(self._c + 1) * tc_]  # (Tc, d)
        idx = bufs[f"idx_{self._c}"].view(-1)
        dst = unflatten_face(bufs[f"send{self._sfx}_{self._c}"],
                             (a.n_experts * self._cap, a.d_model))
        if not self._sfx:
            torch.index_select(xc, 0, idx, out=dst)
            return
        slots = ctx.scratch[f"moe_slots_{self._c}"]
        torch.index_select(xc, 0, idx, out=slots)
        dst.copy_(slots)


class ExpertFFNPipe(DeviceOp):
    """Run every resident expert's gelu MLP over its received slots with
    plain PyTorch (the reference's XLA einsums; the ``.xla`` slot): two
    ``bmm(out=)`` around an in-place tanh gelu, the hidden activations in
    per-chunk scratch.  A bf16 chain converts the received slots to f32
    scratch first and rounds the f32 result into ``out16_c``."""

    def __init__(self, name: str, c: int, args: MoEPipeArgs, cap: int,
                 prec: str = "f32"):
        super().__init__(name)
        self._c, self._args, self._cap = c, args, cap
        self._sfx = _sfx(prec)

    def reads(self):
        return [f"recv{self._sfx}_{self._c}", "W1", "W2"]

    def writes(self):
        return [f"out{self._sfx}_{self._c}"]

    def scratch(self):
        a, c = self._args, self._c
        out = {f"moe_h_{c}": ((a.n_experts, self._cap, a.d_ff), "float32")}
        if self._sfx:
            shape = _slot_shape(a, self._cap)
            out[f"moe_x_{c}"] = (shape, "float32")
            out[f"moe_y_{c}"] = (shape, "float32")
        return out

    def _mlp(self, x3, w1, w2, y3, ctx) -> None:
        """y3 := gelu_tanh(x3 @ w1) @ w2, per expert, in place."""
        import torch

        h = ctx.scratch[f"moe_h_{self._c}"]
        torch.bmm(x3, w1, out=h)
        torch.ops.aten.gelu_(h, approximate="tanh")
        torch.bmm(h, w2, out=y3)

    def apply(self, bufs, ctx):
        shape = _slot_shape(self._args, self._cap)
        x3 = unflatten_face(bufs[f"recv{self._sfx}_{self._c}"], shape)
        out3 = unflatten_face(bufs[f"out{self._sfx}_{self._c}"], shape)
        if not self._sfx:
            self._mlp(x3, bufs["W1"], bufs["W2"], out3, ctx)
            return
        xs = ctx.scratch[f"moe_x_{self._c}"]
        ys = ctx.scratch[f"moe_y_{self._c}"]
        xs.copy_(x3)
        self._mlp(xs, bufs["W1"], bufs["W2"], ys, ctx)
        out3.copy_(ys)


class ExpertFFNPipePallas(ExpertFFNPipe):
    """The same per-expert MLP through the ``ffn_batched`` kernel
    (reference: the Pallas kernel ffn_pallas_batched); the plain version
    under ``ctx.plain_kernels``."""

    def scratch(self):
        out = dict(super().scratch())
        out.pop(f"moe_h_{self._c}")  # the gelu tile never leaves the kernel
        return out

    def _mlp(self, x3, w1, w2, y3, ctx) -> None:
        from tenzing_tpu_torch.ops import ffn_kernels as fk

        if ctx.plain_kernels:
            y3.copy_(fk.ffn_batched_plain(x3, w1, w2))
        else:
            fk.ffn_batched(x3, w1, w2, out=y3)


class ExpertFFNPipeChoice(ChoiceOp):
    """The expert-MLP kernel menu of one chunk: ``.xla`` / ``.pallas``."""

    def __init__(self, name: str, c: int, args: MoEPipeArgs, cap: int,
                 prec: str = "f32"):
        super().__init__(name)
        self._c, self._args, self._cap, self._prec = c, args, cap, prec

    def choices(self) -> List[OpBase]:
        return [
            ExpertFFNPipe(self.name() + ".xla", self._c, self._args, self._cap,
                          self._prec),
            ExpertFFNPipePallas(self.name() + ".pallas", self._c, self._args,
                                self._cap, self._prec),
        ]


class CombinePipe(DeviceOp):
    """Scatter-add the returned expert outputs into token order, scaled by
    the gate weights (padding slots carry weight 0): ``Y_c`` is zeroed and
    ``index_add_`` adds w * vals from per-chunk scratch."""

    def __init__(self, name: str, c: int, args: MoEPipeArgs, cap: int,
                 prec: str = "f32"):
        super().__init__(name)
        self._c, self._args, self._cap = c, args, cap
        self._sfx = _sfx(prec)

    def reads(self):
        return [f"ret{self._sfx}_{self._c}", f"idx_{self._c}", f"w_{self._c}"]

    def writes(self):
        return [f"Y_{self._c}"]

    def scratch(self):
        a = self._args
        return {f"moe_wv_{self._c}": ((a.n_experts * self._cap, a.d_model),
                                      "float32")}

    def apply(self, bufs, ctx):
        import torch

        a = self._args
        vals = unflatten_face(bufs[f"ret{self._sfx}_{self._c}"],
                              (a.n_experts * self._cap, a.d_model))
        wv = ctx.scratch[f"moe_wv_{self._c}"]
        torch.mul(vals, bufs[f"w_{self._c}"].view(-1, 1), out=wv)
        y = bufs[f"Y_{self._c}"]
        y.zero_()
        y.index_add_(0, bufs[f"idx_{self._c}"].view(-1), wv)


class ConcatPipe(DeviceOp):
    def __init__(self, name: str, args: MoEPipeArgs):
        super().__init__(name)
        self._args = args

    def reads(self):
        return [f"Y_{c}" for c in range(self._args.n_chunks)]

    def writes(self):
        return ["Y"]

    def apply(self, bufs, ctx):
        import torch

        torch.cat([bufs[f"Y_{c}"] for c in range(self._args.n_chunks)], dim=0,
                  out=bufs["Y"])


def chunk_ops(args: MoEPipeArgs, c: int, cap: int, impl_choice: bool = False,
              prec: str = "f32", engine: str = "host"):
    """The op chain for one microbatch chunk.  ``prec="bf16"`` routes the
    staged transfers through the half-width bfloat16 buffer set (op and
    buffer names carry a ``16`` suffix so both variants can coexist in one
    choice graph); ``engine="rdma"`` replaces each host round trip with a
    device-resident copy (ops/rdma.py; the host buffers stay declared but
    untouched)."""
    if engine not in ("host", "rdma"):
        raise ValueError(f"unknown transfer engine {engine!r}")
    s = _sfx(prec)
    mk = ExpertFFNPipeChoice if impl_choice else ExpertFFNPipe
    pack = DispatchPackPipe(f"pack{s}_{c}", c, args, cap, prec)
    if engine == "rdma":
        from tenzing_tpu_torch.ops.rdma import RdmaCopyStart

        xfer_d = (RdmaCopyStart(f"xferd{s}_{c}.rdma", f"send{s}_{c}",
                                f"recv{s}_{c}", channel=f"d{s}_{c}"),)
        xfer_c = (RdmaCopyStart(f"xferc{s}_{c}.rdma", f"out{s}_{c}",
                                f"ret{s}_{c}", channel=f"c{s}_{c}"),)
    else:
        xfer_d = (
            HostSpillStart(f"spilld{s}_{c}", f"send{s}_{c}", f"hdisp{s}_{c}",
                           channel=f"d{s}_{c}"),
            HostFetchStart(f"fetchd{s}_{c}", f"hdisp{s}_{c}", f"recv{s}_{c}",
                           channel=f"d{s}_{c}"),
        )
        xfer_c = (
            HostSpillStart(f"spillc{s}_{c}", f"out{s}_{c}", f"hcomb{s}_{c}",
                           channel=f"c{s}_{c}"),
            HostFetchStart(f"fetchc{s}_{c}", f"hcomb{s}_{c}", f"ret{s}_{c}",
                           channel=f"c{s}_{c}"),
        )
    awaitd = AwaitTransfer(f"awaitd{s}_{c}", f"recv{s}_{c}")
    ffn = mk(f"ffn{s}_{c}", c, args, cap, prec)
    awaitc = AwaitTransfer(f"awaitc{s}_{c}", f"ret{s}_{c}")
    comb = CombinePipe(f"combine{s}_{c}", c, args, cap, prec)
    return (pack,) + xfer_d + (awaitd, ffn) + xfer_c + (awaitc, comb)


class ChunkChain(CompoundOp):
    """One chunk's whole dispatch->expert->combine chain as a compound, at a
    fixed staging precision and engine — the unit the staging ChoiceOp
    selects."""

    def __init__(self, c: int, args: MoEPipeArgs, cap: int,
                 impl_choice: bool, prec: str, engine: str = "host"):
        super().__init__(f"chain_{c}.{prec}-{engine}")
        self._c, self._args, self._cap = c, args, cap
        self._impl_choice, self._prec, self._engine = impl_choice, prec, engine

    def graph(self) -> Graph:
        g = Graph()
        ops = chunk_ops(self._args, self._c, self._cap, self._impl_choice,
                        self._prec, self._engine)
        g.start_then(ops[0])
        for a, b in zip(ops, ops[1:]):
            g.then(a, b)
        g.then_finish(ops[-1])
        return g


class StagingChoice(ChoiceOp):
    """The staging menu of one chunk: f32 vs half-width bf16 transfers, each
    through the host round trip or the device-resident copy.  bf16 staging
    rounds the dispatched tokens and the returned expert outputs; whether the
    halved bytes win is the solver's question."""

    def __init__(self, c: int, args: MoEPipeArgs, cap: int, impl_choice: bool):
        super().__init__(f"chain_{c}")
        self._c, self._args, self._cap = c, args, cap
        self._impl_choice = impl_choice

    def choices(self) -> List[OpBase]:
        return [
            ChunkChain(self._c, self._args, self._cap, self._impl_choice,
                       prec, engine)
            for prec in ("f32", "bf16")
            for engine in ("host", "rdma")
        ]


PHASES = ("start", "pack", "spilld", "fetchd", "xferd", "awaitd", "ffn",
          "spillc", "fetchc", "xferc", "awaitc", "combine", "concat", "finish")


def build_graph(args: MoEPipeArgs, cap: int, impl_choice: bool = False,
                staging: str = "f32", engine: str = "host") -> Graph:
    """``n_chunks`` independent chains joined by the final concat.
    ``staging``: "f32" or "bf16" wires that variant directly (with
    ``engine``); "choice" wraps each chunk's chain in a
    :class:`StagingChoice` (buffers from ``make_pipe_buffers(...,
    staging="choice")``)."""
    g = Graph()
    cat = ConcatPipe("concat", args)
    for c in range(args.n_chunks):
        if staging == "choice":
            chain = StagingChoice(c, args, cap, impl_choice)
            g.start_then(chain)
            g.then(chain, cat)
            continue
        ops = chunk_ops(args, c, cap, impl_choice, prec=staging, engine=engine)
        g.start_then(ops[0])
        for a, b in zip(ops, ops[1:]):
            g.then(a, b)
        g.then(ops[-1], cat)
    g.then_finish(cat)
    return g


_STAGES = ("pack", "spilld", "fetchd", "awaitd", "ffn", "spillc", "fetchc",
           "awaitc", "combine")


def naive_priority(args: MoEPipeArgs):
    """Per-op priority of the naive order: chunk by chunk, each chain
    completed (posts immediately awaited) before the next starts."""
    last = 10 * args.n_chunks

    def priority(name: str) -> int:
        if name == "start":
            return 0
        if name == "concat":
            return last + 1
        if name == "finish":
            return last + 2
        stage, c = name.split(".", 1)[0].rsplit("_", 1)
        return 1 + 10 * int(c) + _STAGES.index(stage)

    return priority


def naive_order(args: MoEPipeArgs, cap: int, platform) -> Sequence:
    """The naive sequential baseline on one lane: each chunk's chain (f32
    staging, host engine, plain MLP) completed before the next starts.
    Derived through the SDP machinery, so the host waits for each device op
    whose output a host hop reads (the reference's hand-written order omits
    those syncs)."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    one_lane = Platform([platform.lanes[0]])
    seq, _ = drive(build_graph(args, cap), one_lane,
                   phase_policy(one_lane, PHASES, priority=naive_priority(args)))
    return seq


def greedy_overlap_order(args: MoEPipeArgs, cap: int, platform,
                         staging: str = "f32", engine: str = "host") -> Sequence:
    """Phase-ordered incumbent: all packs, all dispatch posts, ... — the
    software-pipelined discipline, via the shared greedy (solve/greedy.py).
    ``staging="bf16"`` yields the half-width-transfer incumbent;
    ``engine="rdma"`` the device-resident-transfer incumbent."""
    from tenzing_tpu_torch.solve.greedy import greedy_phase_order

    return greedy_phase_order(
        build_graph(args, cap, staging=staging, engine=engine), platform,
        PHASES)


def route_tokens(
    x: np.ndarray, wg: np.ndarray, args: MoEPipeArgs
) -> Tuple[int, Dict[str, np.ndarray]]:
    """Host-side top-1 routing into per-chunk capacity-padded slot tables
    (idx_{c} (E, C) int32, w_{c} (E, C) float32); returns (capacity,
    tables).  The reference's function, line for line."""
    from tenzing_tpu_torch.models.moe import top1_route

    e_, tc_ = args.n_experts, args.chunk_tokens
    expert, gate = top1_route(x, wg)

    cap = 1
    for c in range(args.n_chunks):
        e_blk = expert[c * tc_:(c + 1) * tc_]
        cap = max(cap, int(np.bincount(e_blk, minlength=e_).max()))
    tables: Dict[str, np.ndarray] = {}
    for c in range(args.n_chunks):
        idx = np.zeros((e_, cap), dtype=np.int32)
        w = np.zeros((e_, cap), dtype=np.dtype(args.dtype))
        fill = [0] * e_
        for j in range(tc_):
            e = int(expert[c * tc_ + j])
            idx[e, fill[e]] = j
            w[e, fill[e]] = gate[c * tc_ + j]
            fill[e] += 1
        tables[f"idx_{c}"] = idx
        tables[f"w_{c}"] = w
    return cap, tables


_SUFFIXES = {"f32": ("",), "bf16": ("16",), "choice": ("", "16")}


def make_pipe_buffers(
    args: MoEPipeArgs, seed: int = 0, with_expected: bool = True,
    staging: str = "f32"
) -> Tuple[Dict[str, Union[np.ndarray, ZerosSpec]], Optional[np.ndarray], int]:
    """(buffers, expected Y or None, capacity): the reference's buffers for
    the same seed — the same numpy generator calls, so X, the weights and
    the routing tables are bit-identical — with each bfloat16 staging buffer
    given as a :class:`ZerosSpec` (``runtime.executor.buffers_from_numpy``
    creates it).  The expected Y is the dense routed evaluation in float64.
    ``staging`` declares the transfer buffer set(s) to match
    :func:`build_graph`: "f32", "bf16", or "choice" (both)."""
    rng = np.random.default_rng(seed)
    e_, t, d, dff = args.n_experts, args.tokens, args.d_model, args.d_ff
    dt = np.dtype(args.dtype)
    x = rng.standard_normal((t, d)).astype(dt)
    wg = rng.standard_normal((d, e_)).astype(dt)
    w1 = (rng.standard_normal((e_, d, dff)) / np.sqrt(d)).astype(dt)
    w2 = (rng.standard_normal((e_, dff, d)) / np.sqrt(dff)).astype(dt)
    cap, tables = route_tokens(x, wg, args)

    bufs: Dict[str, Union[np.ndarray, ZerosSpec]] = {
        "X": x, "W1": w1, "W2": w2, "Y": np.zeros((t, d), dt)}
    bufs.update(tables)
    rows = -(-int(np.prod(_slot_shape(args, cap))) // 128)
    flat = np.zeros((rows, 128), dt)
    flat16 = ZerosSpec((rows, 128), "bfloat16")
    for c in range(args.n_chunks):
        for s in _SUFFIXES[staging]:
            for nm in (f"send{s}_{c}", f"hdisp{s}_{c}", f"recv{s}_{c}",
                       f"out{s}_{c}", f"hcomb{s}_{c}", f"ret{s}_{c}"):
                bufs[nm] = flat16 if s else flat.copy()
        bufs[f"Y_{c}"] = np.zeros((args.chunk_tokens, d), dt)

    want = None
    if with_expected:
        from tenzing_tpu_torch.models.moe import top1_route

        expert, gate = top1_route(x, wg)
        want64 = np.zeros((t, d), np.float64)
        for e in range(e_):
            sel = expert == e
            h = gelu_tanh(x[sel].astype(np.float64) @ w1[e].astype(np.float64))
            want64[sel] = gate[sel, None] * (h @ w2[e].astype(np.float64))
        want = want64.astype(dt)  # the workload dtype
    return bufs, want, cap


def host_buffer_names(args: MoEPipeArgs, staging: str = "f32") -> List[str]:
    """Buffers that live in pinned host memory (``buffers_from_numpy``)."""
    suffixes = _SUFFIXES[staging]
    return [f"hdisp{s}_{c}" for c in range(args.n_chunks) for s in suffixes] + [
        f"hcomb{s}_{c}" for c in range(args.n_chunks) for s in suffixes
    ]


def transport_buffer_names(args: MoEPipeArgs, staging: str = "f32") -> List[str]:
    """The device-side staging buffers of each staging set (``send``,
    ``recv``, ``out``, ``ret``): transport scratch, not results.  A schedule
    never touches the set its chains did not pick, so the integrity gate
    skips them all, as it skips the pinned host buffers."""
    return [f"{kind}{s}_{c}" for c in range(args.n_chunks)
            for s in _SUFFIXES[staging]
            for kind in ("send", "recv", "out", "ret")]


def fixed_orders(args: MoEPipeArgs, cap: int,
                 n_lanes: int = 2) -> Dict[str, Tuple[Sequence, Graph]]:
    """(order, the graph it was built on) of the fixed schedules the chip
    smoke checks and the breakdown times: naive, the reference's four greedy
    incumbents, and the all-``.pallas`` completions of the choice graph with
    f32 and with bf16 device-copy staging, on ``n_lanes`` lanes."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.solve.local import drive, phase_policy

    plat = Platform.make_n_lanes(n_lanes)
    choice_g = build_graph(args, cap, impl_choice=True, staging="choice")

    def all_pallas(staging: str) -> Sequence:
        def prefer(op_name, choices):
            want = staging if op_name.startswith("chain_") else ".pallas"
            return next(c for c in choices if c.endswith(want))

        return drive(choice_g, plat, phase_policy(plat, PHASES, prefer))[0]

    orders = {"naive": (naive_order(args, cap, plat), build_graph(args, cap))}
    for label, st, en in (("greedy-overlap", "f32", "host"),
                          ("greedy-overlap-bf16", "bf16", "host"),
                          ("greedy-bf16-rdma", "bf16", "rdma"),
                          ("greedy-f32-rdma", "f32", "rdma")):
        orders[label] = (greedy_overlap_order(args, cap, plat, staging=st,
                                              engine=en),
                         build_graph(args, cap, staging=st, engine=en))
    orders["pallas-f32-rdma"] = (all_pallas(".f32-rdma"), choice_g)
    orders["pallas-bf16-rdma"] = (all_pallas(".bf16-rdma"), choice_g)
    return orders
