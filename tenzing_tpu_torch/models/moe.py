"""The expert-parallel MoE layer as a searchable op DAG, over
``torch.distributed``.

Counterpart of ``tenzing_tpu/models/moe.py``: tokens are routed to experts
that live on other ranks, so the layer is dispatch (all-to-all) -> expert
MLP -> combine (all-to-all back), the original tenzing's ``Ialltoallv``
pattern (ops_mpi.hpp:82-119) with compute between the two exchanges.  Per
microbatch chunk ``c`` the chain is::

    pack_c -> a2a_disp_c (post) -> await_disp_c -> ffn_c
           -> a2a_comb_c (post) -> await_comb_c -> combine_c
    all combine_c -> moe_concat

* **Routing is host-side setup** (:func:`make_moe_buffers`): top-1 gating
  over a fixed gate matrix gives the static per-(rank, expert) slot tables
  ``disp_idx_c`` (which local token fills each capacity slot) and
  ``disp_w_c`` (its gate weight; 0 marks padding), every (src, dst) pair
  padded to the common capacity.
* **Each rank runs the schedule on its own block** of every buffer
  (parallel/mesh.py ``shard_buffers``): X and Y (t, d), the slot tables
  (1, n, cap), W1 / W2 (1, d, dff) / (1, dff, d) — the rank's expert — and
  the slot buffers (n, cap, d), whose row q is what goes to (or came from)
  rank q.  The exchanges are ``AllToAllStart`` (ops/comm_ops.py) over the
  ``ep`` axis of the platform's mesh.
* **The expert MLP has a kernel menu**: ``.xla``, two ``torch.matmul`` s
  around the tanh gelu (the reference computes it outside Pallas), and
  ``.pallas``, the hand-written ``ffn_rows`` kernel (ops/ffn_kernels.py,
  csrc/ffn_rows.cu; the reference's ``ffn_pallas``).  With ``chunk=True``
  the ``.xla`` MLP also offers its chunked expansions over the source-rank
  rows of the slot table (core/chunking.py).

Ops write in place into their output buffers or declared scratch, so a
timed run allocates nothing.  Op names, kind tags and schedule JSON are the
reference's; its specs become the port's (``"ep"`` for every buffer: each is
split along dim 0).  With ``synth=True`` and ``n_ep >= 2`` each exchange
is also offered as a ring all-to-all of ``n_ep - 1`` single-hop shifts
(collectives/synth.py, :func:`moe_synth_plans`); at ``n_ep = 1`` there is no
menu.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import ChoiceOp, CompoundOp, DeviceOp, OpBase
from tenzing_tpu_torch.ops.comm_ops import AllToAllStart, AwaitTransfer
from tenzing_tpu_torch.utils.numeric import gelu_tanh as _gelu
from tenzing_tpu_torch.utils.numeric import round_bf16

AXIS = "ep"


def _itemsize(dtype: str) -> int:
    """Bytes per element of a layer dtype (numpy has no bfloat16 here)."""
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


@dataclass(frozen=True)
class MoEArgs:
    n_ep: int  # expert-parallel ranks == experts (one expert per rank)
    tokens_per_shard: int = 16
    d_model: int = 8
    d_ff: int = 16
    n_chunks: int = 2  # microbatch chunks (the pipelining freedom)
    dtype: str = "float32"

    @property
    def chunk_tokens(self) -> int:
        assert self.tokens_per_shard % self.n_chunks == 0
        return self.tokens_per_shard // self.n_chunks


def top1_route(x: np.ndarray, wg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Top-1 gating in float64: (expert index, softmax gate weight) per
    token — the one source of the routing rule for the MoE buffer builders
    (this layer and models/moe_pipeline.py) and their expected outputs."""
    logits = x.astype(np.float64) @ wg.astype(np.float64)  # (T, E)
    expert = np.argmax(logits, axis=1)
    pz = np.exp(logits - logits.max(axis=1, keepdims=True))
    pz /= pz.sum(axis=1, keepdims=True)
    gate = pz[np.arange(len(x)), expert]
    return expert, gate


class DispatchPack(DeviceOp):
    """Fill chunk ``c``'s capacity-padded send buffer from the local tokens
    the router assigned to each expert: ``index_select`` of the chunk's
    tokens by the rank's slot table, straight into ``send_disp_c``."""

    def __init__(self, name: str, c: int, args: MoEArgs):
        super().__init__(name)
        self._c = c
        self._args = args

    def reads(self):
        return ["X", f"disp_idx_{self._c}"]

    def writes(self):
        return [f"send_disp_{self._c}"]

    def apply(self, bufs, ctx):
        import torch

        tc_ = self._args.chunk_tokens
        xc = bufs["X"][self._c * tc_:(self._c + 1) * tc_]  # (Tc, d)
        idx = bufs[f"disp_idx_{self._c}"][0].reshape(-1)  # (n_ep * C,)
        send = bufs[f"send_disp_{self._c}"]  # (n_ep, C, d)
        torch.index_select(xc, 0, idx, out=send.view(-1, send.shape[-1]))


class ExpertFFN(DeviceOp):
    """Run the resident expert's gelu MLP over every received slot (``.xla``:
    two ``torch.matmul(out=)`` around an in-place tanh gelu, the hidden
    activations in per-chunk scratch).  Padding slots carry real numbers
    but the combine multiplies them by weight 0.

    In bf16 it computes what the reference's does (``_mlp``: both products
    accumulate in float32, the gelu acts on the float32 product, h is
    rounded to bf16 between them): x and W1 are widened into float32
    scratch for the first product, whose float32 result takes the gelu and
    is then rounded into bf16 scratch for the second.  A bf16 product
    straight into bf16 would round the pre-activation before the gelu."""

    def __init__(self, name: str, c: int, args: MoEArgs):
        super().__init__(name)
        self._c = c
        self._args = args

    def reads(self):
        return [f"recv_disp_{self._c}", "W1", "W2"]

    def writes(self):
        return [f"ffn_out_{self._c}"]

    def scratch_for(self, shapes):
        n, cap, d = shapes[f"recv_disp_{self._c}"]
        dff = shapes["W1"][-1]
        if self._args.dtype != "bfloat16":
            return {f"moe_h_{self._c}": ((n * cap, dff), self._args.dtype)}
        return {f"moe_h_{self._c}": ((n * cap, dff), "float32"),
                f"moe_hb_{self._c}": ((n * cap, dff), "bfloat16"),
                f"moe_x32_{self._c}": ((n * cap, d), "float32"),
                # per op: concurrent partials of one chunk each widen W1
                f"moe_w1f_{self.name()}": ((d, dff), "float32")}

    def _rows(self, n: int) -> slice:
        """The source-rank rows of the slot table this op runs: all."""
        return slice(0, n)

    def _mlp(self, x2d, w1, w2, y2d, ctx, rows: slice, cap: int) -> None:
        import torch

        span = slice(rows.start * cap, rows.stop * cap)
        h = ctx.scratch[f"moe_h_{self._c}"][span]
        if self._args.dtype != "bfloat16":
            torch.matmul(x2d, w1, out=h)
            torch.ops.aten.gelu_(h, approximate="tanh")
            torch.matmul(h, w2, out=y2d)
            return
        x32 = ctx.scratch[f"moe_x32_{self._c}"][span]
        w1f = ctx.scratch[f"moe_w1f_{self.name()}"]
        x32.copy_(x2d)
        w1f.copy_(w1)
        torch.matmul(x32, w1f, out=h)
        torch.ops.aten.gelu_(h, approximate="tanh")
        hb = ctx.scratch[f"moe_hb_{self._c}"][span]
        hb.copy_(h)
        torch.matmul(hb, w2, out=y2d)

    def apply(self, bufs, ctx):
        x = bufs[f"recv_disp_{self._c}"]  # (n_ep, C, d) rows by source rank
        y = bufs[f"ffn_out_{self._c}"]
        w1, w2 = bufs["W1"][0], bufs["W2"][0]  # this rank's expert
        n, cap, d = x.shape
        rows = self._rows(n)
        self._mlp(x[rows].reshape(-1, d), w1, w2, y[rows].view(-1, d), ctx,
                  rows, cap)

    # -- op-chunking protocol (core/chunking.py): the expert MLP splits over
    # the source-rank rows of the received slot table, each partial writing
    # its row slice of the output, so the combine all-to-all (or another
    # chunk's dispatch) can post between the partials.  The kernel slot owns
    # its blocking and never splits.
    def chunkable(self) -> bool:
        return True

    def chunk_counts(self) -> List[int]:
        from tenzing_tpu_torch.core.chunking import pow2_counts

        return pow2_counts(self._args.n_ep)

    def split(self, n: int) -> List["ExpertFFNPartial"]:
        e = self._args.n_ep
        if n < 1 or e % n:
            raise ValueError(f"{e} slot-table rows do not split {n} ways")
        return [ExpertFFNPartial(f"{self.name()}.c{n}p{j}", self._c,
                                 self._args, j, n)
                for j in range(n)]


class ExpertFFNPartial(ExpertFFN):
    """Partial ``j`` of an ``n``-way split of :class:`ExpertFFN`: the MLP of
    its source-rank row slice into that slice of the output (the
    reference's read-modify-write slice update, written in place; it reads
    the output too, so the partials chain through the buffer)."""

    def __init__(self, name: str, c: int, args: MoEArgs, part: int,
                 n_parts: int):
        super().__init__(name, c, args)
        self._part, self._n_parts = part, n_parts

    def chunkable(self) -> bool:
        return False  # a partial never re-splits

    def reads(self):
        return super().reads() + [f"ffn_out_{self._c}"]

    def _rows(self, n: int) -> slice:
        if n % self._n_parts:
            raise ValueError(f"{self.name()}: {n} slot-table rows do not "
                             f"split {self._n_parts} ways")
        per = n // self._n_parts
        return slice(self._part * per, (self._part + 1) * per)


class ExpertFFNPallas(ExpertFFN):
    """The same MLP through the hand-written ``ffn_rows`` kernel (the
    reference's Pallas ``ffn_pallas``); its plain version under
    ``ctx.plain_kernels``."""

    def _work(self) -> str:
        """The kernel's h workspace: float32 ``moe_h_<c>``, or in bf16
        ``moe_hb_<c>`` (the name and shape the bf16 ``.xla`` slot's own h
        has, so the two alternatives of a chunk share it as the f32 ones
        share ``moe_h_<c>``)."""
        bf16 = self._args.dtype == "bfloat16"
        return f"moe_hb_{self._c}" if bf16 else f"moe_h_{self._c}"

    def scratch_for(self, shapes):
        n, cap, _ = shapes[f"recv_disp_{self._c}"]
        return {self._work(): ((n * cap, shapes["W1"][-1]), self._args.dtype)}

    def _mlp(self, x2d, w1, w2, y2d, ctx, rows: slice, cap: int) -> None:
        from tenzing_tpu_torch.ops import ffn_kernels as fk

        if ctx.plain_kernels:
            y2d.copy_(fk.ffn_rows_plain(x2d, w1, w2))
        else:
            span = slice(rows.start * cap, rows.stop * cap)
            fk.ffn_rows(x2d, w1, w2, out=y2d,
                        work=ctx.scratch[self._work()][span])

    def uses_pallas(self) -> bool:
        return True

    def chunkable(self) -> bool:
        return False  # the kernel owns its blocking


def ffn_chunk_menu(args: MoEArgs, relax: bool = False):
    """(pruned counts, {count: est hidden µs}) for one chunk's expert MLP
    (bench/roofline.chunk_menu).  The neighbouring transfer is the combine
    all-to-all returning the expert outputs, priced at
    ``roofline.EXCHANGE_GBS`` (the reference priced it at a v5e's ICI rate);
    ``relax=True`` (tests, small shapes) keeps every structurally valid
    count."""
    from tenzing_tpu_torch.bench import roofline

    bpe = _itemsize(args.dtype)
    cap = args.chunk_tokens  # capacity upper bound per (src, dst) pair
    slots = float(args.n_ep * cap)
    d, dff = args.d_model, args.d_ff
    table = slots * d * bpe  # one slot-table pass (the a2a payload)
    cost = roofline.Cost(flops=4.0 * slots * d * dff,
                         hbm_bytes=2.0 * table + float(2 * d * dff * bpe))
    return roofline.chunk_menu(
        ExpertFFN("probe", 0, args).chunk_counts(), cost,
        comm_us=table / (roofline.EXCHANGE_GBS * 1e9) * 1e6,
        combine_bytes=2.0 * table, relax=relax)


class ExpertFFNChoice(ChoiceOp):
    """Kernel menu for chunk ``c``'s expert MLP: ``.xla`` / ``.pallas``, and
    the chunked expansions of ``.xla`` for ``chunk_counts`` > 1."""

    def __init__(self, name: str, c: int, args: MoEArgs,
                 chunk_counts=(), chunk_est=None):
        super().__init__(name)
        self._c = c
        self._args = args
        self._chunks = tuple(int(n) for n in chunk_counts if int(n) > 1)
        self._chunk_est = dict(chunk_est or {})
        if chunk_counts:
            from tenzing_tpu_torch.core.chunking import menu_info

            self.chunk_menu = menu_info(name + ".xla", chunk_counts,
                                        self._chunk_est)

    def choices(self) -> List[OpBase]:
        from tenzing_tpu_torch.core.chunking import ChunkedOp

        out: List[OpBase] = [
            ExpertFFN(self.name() + ".xla", self._c, self._args),
            ExpertFFNPallas(self.name() + ".pallas", self._c, self._args),
        ]
        out += [ChunkedOp(ExpertFFN(self.name() + ".xla", self._c, self._args),
                          n, est_hidden_us=self._chunk_est.get(n))
                for n in self._chunks]
        return out


class CombineScatter(DeviceOp):
    """Scatter-add the returned expert outputs back into token order, scaled
    by the gate weights (padding slots have weight 0): ``Y_c`` is zeroed
    and ``index_add_`` adds w * vals from per-chunk scratch."""

    def __init__(self, name: str, c: int, args: MoEArgs):
        super().__init__(name)
        self._c = c
        self._args = args

    def reads(self):
        return [f"recv_comb_{self._c}", f"disp_idx_{self._c}",
                f"disp_w_{self._c}"]

    def writes(self):
        return [f"Y_{self._c}"]

    def scratch_for(self, shapes):
        n, cap, d = shapes[f"recv_comb_{self._c}"]
        return {f"moe_wv_{self._c}": ((n * cap, d), self._args.dtype)}

    def apply(self, bufs, ctx):
        import torch

        vals = bufs[f"recv_comb_{self._c}"]  # (n_ep, C, d) rows by expert
        d = vals.shape[-1]
        idx = bufs[f"disp_idx_{self._c}"][0].reshape(-1)  # (n_ep * C,)
        w = bufs[f"disp_w_{self._c}"][0].reshape(-1, 1)  # (n_ep * C, 1)
        wv = ctx.scratch[f"moe_wv_{self._c}"]
        torch.mul(vals.view(-1, d), w, out=wv)
        y = bufs[f"Y_{self._c}"]
        y.zero_()
        y.index_add_(0, idx, wv)


# -- synthesized all-to-all (collectives/synth.py) ----------------------------


def moe_synth_plans(args: MoEArgs, c: int, site: str, cap: int = None):
    """The ring all-to-all instantiations of chunk ``c``'s dispatch or
    combine exchange (``site`` in ``{"disp", "comb"}``): ``n_ep - 1``
    single-hop rotations in place of the fused ``AllToAllStart``; none at
    ``n_ep < 2``.  ``cap`` is the slot-table width: the graph prices at its
    bound ``chunk_tokens``, the buffer builder passes the routed capacity."""
    from tenzing_tpu_torch.collectives.synth import plan_ring_all_to_all

    if args.n_ep < 2:
        return []
    cap = int(args.chunk_tokens if cap is None else cap)
    src = f"send_disp_{c}" if site == "disp" else f"ffn_out_{c}"
    dst = f"recv_disp_{c}" if site == "disp" else f"recv_comb_{c}"
    return [plan_ring_all_to_all(
        f"a2a_{site}_{c}", src, dst, AXIS, args.n_ep,
        (cap, args.d_model), itemsize=_itemsize(args.dtype))]


class ConcatChunks(DeviceOp):
    """Stitch the per-chunk outputs back into the token-order output."""

    def __init__(self, name: str, args: MoEArgs):
        super().__init__(name)
        self._args = args

    def reads(self):
        return [f"Y_{c}" for c in range(self._args.n_chunks)]

    def writes(self):
        return ["Y"]

    def apply(self, bufs, ctx):
        import torch

        torch.cat([bufs[f"Y_{c}"] for c in range(self._args.n_chunks)], 0,
                  out=bufs["Y"])


class MoELayer(CompoundOp):
    """The whole EP layer as one compound: ``n_chunks`` independent
    dispatch -> expert -> combine chains joined by the final concat.  With
    ``impl_choice`` each chunk's MLP kernel is searched; ``chunk=True``
    adds chunked expert-MLP alternatives to the menus (pruned by
    :func:`ffn_chunk_menu`; ``chunk_relax`` skips the pruning, the tests'
    mode).  ``synth=True`` puts the ring all-to-all of
    :func:`moe_synth_plans` beside each chunk's fused exchange in one choice
    (``n_ep >= 2``; ``synth_relax`` keeps what the prune drops)."""

    def __init__(self, args: MoEArgs, name: str = "moe",
                 impl_choice: bool = False, chunk: bool = False,
                 chunk_relax: bool = False, synth: bool = False,
                 synth_relax: bool = False):
        super().__init__(name)
        self._args = args
        self._impl_choice = impl_choice
        self._chunk = chunk
        self._chunk_relax = chunk_relax
        self._synth = synth
        self._synth_relax = synth_relax

    def args(self) -> MoEArgs:
        return self._args

    def graph(self) -> Graph:
        g = Graph()
        cat = ConcatChunks("moe_concat", self._args)
        counts, est = ((), None)
        if self._chunk:
            counts, est = ffn_chunk_menu(self._args, relax=self._chunk_relax)
        if self._impl_choice:
            def mk(name, c_, a_):
                return ExpertFFNChoice(name, c_, a_, chunk_counts=counts,
                                       chunk_est=est)
        elif any(int(n) > 1 for n in counts):
            from tenzing_tpu_torch.core.chunking import ChunkChoice, chunk_variants

            def mk(name, c_, a_):
                op = ExpertFFN(name, c_, a_)
                return ChunkChoice(op, chunk_variants(op, counts, est))
        else:
            mk = ExpertFFN

        def a2a(base, src, dst, prev, nxt, c):
            start = AllToAllStart(base, src, dst, AXIS, split_axis=0)
            await_ = AwaitTransfer(f"await_{base[4:]}", dst)
            node = self._synth_choice(base, c, start, await_)
            if node is not None:
                g.then(prev, node)
                g.then(node, nxt)
                return
            g.then(prev, start)
            g.then(start, await_)
            g.then(await_, nxt)

        for c in range(self._args.n_chunks):
            pack = DispatchPack(f"pack_{c}", c, self._args)
            ffn = mk(f"ffn_{c}", c, self._args)
            scat = CombineScatter(f"combine_{c}", c, self._args)
            g.start_then(pack)
            a2a(f"a2a_disp_{c}", f"send_disp_{c}", f"recv_disp_{c}", pack,
                ffn, c)
            a2a(f"a2a_comb_{c}", f"ffn_out_{c}", f"recv_comb_{c}", ffn, scat,
                c)
            g.then(scat, cat)
        g.then_finish(cat)
        return g

    def _synth_choice(self, base: str, c: int, start, await_):
        """The exchange's ``SynthCollectiveChoice``, or None without
        ``synth``, at ``n_ep < 2`` or where no instantiation survives."""
        a = self._args
        if not self._synth or a.n_ep < 2:
            return None
        from tenzing_tpu_torch.collectives.synth import (
            FixedCollective,
            SynthCollectiveChoice,
            sketch_menu,
        )
        from tenzing_tpu_torch.collectives.topology import mesh_topology

        bpe = _itemsize(a.dtype)
        site = "disp" if "disp" in base else "comb"
        variants, menu = sketch_menu(
            moe_synth_plans(a, c, site),
            mesh_topology({AXIS: a.n_ep}, host=False),
            # the capacity's bound prices the fused post
            fixed_bytes=float(a.n_ep * a.chunk_tokens * a.d_model * bpe),
            relax=self._synth_relax, collective="all_to_all")
        if not variants:
            return None
        return SynthCollectiveChoice(base, FixedCollective(base, [start, await_]),
                                     variants, menu)


def make_moe_buffers(args: MoEArgs, seed: int = 0, synth: bool = False
                     ) -> Tuple[Dict[str, np.ndarray], Dict[str, Optional[str]],
                                np.ndarray]:
    """(global buffers, specs, expected Y) for the EP layer on a one-axis
    ``"ep"`` mesh: the reference's arrays for the same seed, bit for bit.
    Every spec is ``"ep"`` (dim 0 split over the ranks).  Routing (top-1
    gating) runs here, on the host, against a fixed random gate matrix; the
    expected Y is the dense routed evaluation in float64, cast to the
    layer's dtype (as the reference's).  numpy has no bfloat16 here, so for
    ``dtype="bfloat16"`` each array the reference holds in bf16 is a float32
    array of the same values (``round_bf16``); the caller places it as
    bf16 (parallel/dryrun.py ``build_layer``).  With ``synth`` the buffers
    include the ring all-to-alls' staging at the routed capacity
    (:func:`moe_synth_plans`)."""
    rng = np.random.default_rng(seed)
    n, t, d, dff = args.n_ep, args.tokens_per_shard, args.d_model, args.d_ff
    tc_ = args.chunk_tokens
    bf16 = args.dtype == "bfloat16"
    dt = np.dtype(np.float32 if bf16 else args.dtype)

    def cast(a):
        return round_bf16(a) if bf16 else a.astype(dt)

    x = cast(rng.standard_normal((n * t, d)))
    wg = cast(rng.standard_normal((d, n)))
    w1 = cast(rng.standard_normal((n, d, dff))) / np.sqrt(d)
    w2 = cast(rng.standard_normal((n, dff, d))) / np.sqrt(dff)

    expert, gate = top1_route(x, wg)

    # capacity: max tokens any (rank, chunk) sends to any expert
    cap = 1
    for s in range(n):
        for c in range(args.n_chunks):
            lo = s * t + c * tc_
            e_blk = expert[lo:lo + tc_]
            if len(e_blk):
                cap = max(cap, int(np.bincount(e_blk, minlength=n).max()))

    bufs: Dict[str, np.ndarray] = {
        "X": x, "W1": w1, "W2": w2, "Y": np.zeros((n * t, d), dt)}
    for c in range(args.n_chunks):
        idx = np.zeros((n, n, cap), dtype=np.int32)
        w = np.zeros((n, n, cap), dtype=dt)
        for s in range(n):
            lo = s * t + c * tc_
            fill = [0] * n
            for j in range(tc_):
                e = int(expert[lo + j])
                idx[s, e, fill[e]] = j
                w[s, e, fill[e]] = gate[lo + j]
                fill[e] += 1
        bufs[f"disp_idx_{c}"] = idx
        bufs[f"disp_w_{c}"] = cast(w)
        for nm in (f"send_disp_{c}", f"recv_disp_{c}", f"ffn_out_{c}",
                   f"recv_comb_{c}"):
            bufs[nm] = np.zeros((n * n, cap, d), dt)
        bufs[f"Y_{c}"] = np.zeros((n * tc_, d), dt)
        if not synth:
            continue
        for site in ("disp", "comb"):
            for plan in moe_synth_plans(args, c, site, cap=cap):
                for decl in plan.buffers:
                    if decl.name not in bufs:
                        bufs[decl.name] = np.zeros(
                            (n * decl.shape[0],) + tuple(decl.shape[1:]), dt)
    specs: Dict[str, Optional[str]] = {k: AXIS for k in bufs}

    x64 = x.astype(np.float64)
    want = np.zeros((n * t, d), np.float64)
    for e in range(n):
        sel = expert == e
        h = _gelu(x64[sel] @ w1[e].astype(np.float64))
        want[sel] = gate[sel, None] * (h @ w2[e].astype(np.float64))
    return bufs, specs, cast(want)
