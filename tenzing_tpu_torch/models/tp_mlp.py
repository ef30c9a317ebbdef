"""Tensor parallelism: a Megatron-style sharded MLP as a searchable op DAG.

Counterpart of ``tenzing_tpu/models/tp_mlp.py``.  Each layer's first matrix
is column-sharded over mesh axis ``"tp"`` and the second row-sharded, so
every rank computes a *partial* layer output that an all-reduce completes::

    h_p    = gelu(x @ W1[:, p-th column block])
    part_p = h_p @ W2[p-th row block]
    y      = sum_p part_p                            (PsumStart + await)

The all-reduce is the schedulable transfer: ``PsumStart`` posts it over the
``tp`` group and ``AwaitTransfer`` waits for it (ops/comm_ops.py).  Within a
chain the layers are serial, so the freedom is across ``n_chunks``
independent microbatch chains: one chain's all-reduce can hide behind
another's products.  With ``chunk=True`` each layer's local half may also
split over its batch rows (:class:`TpLayerRowsPartial`, core/chunking.py),
so the post can follow the last partial.

In place: the products go through ``torch.matmul(out=)`` with the hidden
activations in per-chunk scratch (``tp_h_<c>``: a chain's layers and a
layer's partials are serial, chains may run side by side) and the tanh gelu
(``jax.nn.gelu``'s default) applied in place.  Float32 products run in full
float32 (no TF32).  With ``n_dp > 1`` (:func:`make_tp_mlp_buffers`) the
mesh is ``("dp", "tp")``: batch rows split over ``dp``, the all-reduce stays
on ``tp``.  With ``synth=True`` each layer's all-reduce is also offered
as ring, reverse-ring and recursive halving/doubling decompositions
(collectives/synth.py, :func:`tp_mlp_synth_plans`); at ``n_tp < 2`` there is
nothing to decompose and no menu.  Op names, kind tags and schedule JSON are
the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import CompoundOp, DeviceOp
from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer, PsumStart
from tenzing_tpu_torch.utils.numeric import gelu_tanh

AXIS = "tp"


@dataclass(frozen=True)
class TpMlpArgs:
    n_tp: int  # tensor-parallel shards
    n_layers: int = 2
    n_chunks: int = 2  # independent microbatch chains (the searched freedom)
    mb_size: int = 4  # rows per chunk
    d_model: int = 8
    d_ff: int = 16  # global hidden width (sharded n_tp ways)
    dtype: str = "float32"


class TpLayerPartial(DeviceOp):
    """One layer's local half: gelu(x @ W1 column block) @ W2 row block into
    this rank's partial output ``part_<c>_<l>``."""

    def __init__(self, name: str, c: int, layer: int, mb_rows: int = None):
        super().__init__(name)
        self._c, self._l = c, layer
        self._mb = mb_rows  # per-chunk batch rows, for chunk_counts

    def _in(self) -> str:
        return f"X_{self._c}" if self._l == 0 else f"sum_{self._c}_{self._l - 1}"

    def reads(self):
        return [self._in(), "W1", "W2"]

    def writes(self):
        return [f"part_{self._c}_{self._l}"]

    def scratch_for(self, shapes):
        rows = shapes[f"X_{self._c}"][0]
        return {f"tp_h_{self._c}": ((rows, shapes["W1"][2]), "float32")}

    def _rows(self, rows: int) -> slice:
        """The batch rows this op computes: all."""
        return slice(0, rows)

    def apply(self, bufs, ctx):
        import torch

        x = bufs[self._in()]  # (B, d), the same on every tp rank
        w1 = bufs["W1"][self._l]  # (d, dff_local): this rank's columns
        w2 = bufs["W2"][self._l]  # (dff_local, d): this rank's rows
        rows = self._rows(x.shape[0])
        h = ctx.scratch[f"tp_h_{self._c}"][rows]
        torch.matmul(x[rows], w1, out=h)
        torch.ops.aten.gelu_(h, approximate="tanh")
        torch.matmul(h, w2, out=bufs[f"part_{self._c}_{self._l}"][rows])

    # -- op-chunking protocol (core/chunking.py): the layer's two products
    # split over the batch rows into n partials, each writing its row slice
    # of the partial output, so the all-reduce post can follow the last
    def chunkable(self) -> bool:
        return True

    def chunk_counts(self) -> List[int]:
        # an op built without mb_rows is not chunkable: never guess
        from tenzing_tpu_torch.core.chunking import pow2_counts

        return pow2_counts(self._mb)

    def split(self, n: int) -> List["TpLayerRowsPartial"]:
        rows = self._mb
        if rows is None:
            raise ValueError(
                f"{self.name()}: split() needs the mb_rows extent")
        if n < 1 or rows % n:
            raise ValueError(f"{rows} batch rows do not split {n} ways")
        return [TpLayerRowsPartial(f"{self.name()}.c{n}p{j}", self._c,
                                   self._l, j, n, mb_rows=rows)
                for j in range(n)]


class TpLayerRowsPartial(TpLayerPartial):
    """Partial ``j`` of an ``n``-way batch-row split of
    :class:`TpLayerPartial`: both products over its row slice, written into
    that slice of the partial output (the reference's read-modify-write
    slice update; it reads the output too, so the partials chain)."""

    def __init__(self, name: str, c: int, layer: int, part: int,
                 n_parts: int, mb_rows: int = None):
        super().__init__(name, c, layer, mb_rows=mb_rows)
        self._part, self._n_parts = part, n_parts

    def chunkable(self) -> bool:
        return False  # a partial never re-splits

    def reads(self):
        return super().reads() + [f"part_{self._c}_{self._l}"]

    def _rows(self, rows: int) -> slice:
        if rows % self._n_parts:
            # validity was checked against the build-time mb_rows; a dp
            # split can hand this op fewer rows
            raise ValueError(f"{self.name()}: {rows} runtime rows do not "
                             f"split {self._n_parts} ways")
        per = rows // self._n_parts
        return slice(self._part * per, (self._part + 1) * per)


def mlp_chunk_menu(args: TpMlpArgs, relax: bool = False):
    """(pruned counts, {count: est hidden µs}) for one chunk-layer's local
    half (bench/roofline.chunk_menu).  The neighbouring transfer is the
    layer's all-reduce, which moves about twice the partial output, priced
    at ``roofline.EXCHANGE_GBS`` (the reference priced it at a v5e's staging
    rate); ``relax=True`` keeps every structurally valid count."""
    from tenzing_tpu_torch.bench import roofline

    bpe = np.dtype(args.dtype).itemsize
    b, d = args.mb_size, args.d_model
    dffl = args.d_ff // args.n_tp  # this rank's hidden columns
    part = float(b * d * bpe)  # the partial output (the psum payload)
    cost = roofline.Cost(flops=4.0 * b * d * dffl,
                         hbm_bytes=2.0 * part + float(2 * d * dffl * bpe))
    return roofline.chunk_menu(
        TpLayerPartial("probe", 0, 0, mb_rows=args.mb_size).chunk_counts(),
        cost, comm_us=2.0 * part / (roofline.EXCHANGE_GBS * 1e9) * 1e6,
        combine_bytes=2.0 * part, relax=relax)


# -- synthesized all-reduce (collectives/synth.py) ---------------------------


def tp_mlp_synth_counts(args: TpMlpArgs, n_dp: int = 1) -> List[int]:
    """Ring chunk counts that split one chunk's rows on a rank: {1, 2}
    where they divide (c1 is the classic ring, c2 two interleaving
    chains)."""
    rows = args.mb_size // max(1, n_dp)
    return [k for k in (1, 2) if 1 <= k <= rows and rows % k == 0]


def tp_mlp_synth_plans(args: TpMlpArgs, c: int, layer: int, n_dp: int = 1):
    """Every sketch instantiation of layer ``layer``'s all-reduce for chunk
    ``c``: ``ring.c{k}`` forward, ``ringr.c1`` reverse, and ``rhd.c1`` where
    the tp extent is a power of two; none at ``n_tp < 2``.  Shapes are a
    rank's: ``mb_size // n_dp`` rows of ``d_model``."""
    from tenzing_tpu_torch.collectives.synth import (
        plan_rhd_all_reduce,
        plan_ring_all_reduce,
    )

    if args.n_tp < 2:
        return []
    rows = args.mb_size // max(1, n_dp)
    shape = (rows, args.d_model)
    bpe = int(np.dtype(args.dtype).itemsize)
    base = f"psum_{c}_{layer}"
    src, dst = f"part_{c}_{layer}", f"sum_{c}_{layer}"
    plans = [plan_ring_all_reduce(base, src, dst, AXIS, args.n_tp, shape, k,
                                  itemsize=bpe)
             for k in tp_mlp_synth_counts(args, n_dp)]
    plans.append(plan_ring_all_reduce(base, src, dst, AXIS, args.n_tp, shape,
                                      1, itemsize=bpe, reverse=True))
    if args.n_tp & (args.n_tp - 1) == 0:
        plans.append(plan_rhd_all_reduce(base, src, dst, AXIS, args.n_tp,
                                         shape, itemsize=bpe))
    return plans


class ConcatOut(DeviceOp):
    """Stack the chunks' final reduced outputs back into batch order."""

    def __init__(self, name: str, args: TpMlpArgs):
        super().__init__(name)
        self._args = args

    def reads(self):
        last = self._args.n_layers - 1
        return [f"sum_{c}_{last}" for c in range(self._args.n_chunks)]

    def writes(self):
        return ["Y"]

    def apply(self, bufs, ctx):
        import torch

        torch.cat([bufs[n] for n in self.reads()], 0, out=bufs["Y"])


class TpMlp(CompoundOp):
    """The TP forward as one compound: ``n_chunks`` independent layer chains
    (partial -> psum post -> await per layer), joined by the concat.
    ``chunk=True`` wraps each layer's local half in a ``ChunkChoice`` of its
    batch-row splits (pruned by :func:`mlp_chunk_menu`; ``chunk_relax``
    keeps every valid count, the tests' mode).  ``synth=True`` wraps each
    layer's all-reduce in a ``SynthCollectiveChoice``: the fixed ``PsumStart
    -> AwaitTransfer`` chain against the decompositions of
    :func:`tp_mlp_synth_plans` over the tp ring, priced per link and pruned
    against the psum's one-post floor (``synth_relax`` keeps every one);
    ``synth_dp`` is the dp extent the rows are split over."""

    def __init__(self, args: TpMlpArgs, name: str = "tp_mlp",
                 chunk: bool = False, chunk_relax: bool = False,
                 synth: bool = False, synth_relax: bool = False,
                 synth_dp: int = 1):
        super().__init__(name)
        self._args = args
        self._chunk = chunk
        self._chunk_relax = chunk_relax
        self._synth = synth
        self._synth_relax = synth_relax
        self._synth_dp = max(1, synth_dp)

    def args(self) -> TpMlpArgs:
        return self._args

    def graph(self) -> Graph:
        a = self._args
        g = Graph()
        counts, est = ((), None)
        if self._chunk:
            counts, est = mlp_chunk_menu(a, relax=self._chunk_relax)

        def mk(cc, ll):
            step = TpLayerPartial(f"mlp_{cc}_{ll}", cc, ll, mb_rows=a.mb_size)
            if any(int(n) > 1 for n in counts):
                from tenzing_tpu_torch.core.chunking import ChunkChoice, chunk_variants

                return ChunkChoice(step, chunk_variants(step, counts, est))
            return step

        cat = ConcatOut("tp_concat", a)
        for c in range(a.n_chunks):
            prev = None
            for layer in range(a.n_layers):
                mlp = mk(c, layer)
                post = PsumStart(f"psum_{c}_{layer}", f"part_{c}_{layer}",
                                 f"sum_{c}_{layer}", AXIS)
                await_ = AwaitTransfer(f"await_{c}_{layer}",
                                       f"sum_{c}_{layer}")
                if prev is None:
                    g.start_then(mlp)
                else:
                    g.then(prev, mlp)
                choice = self._synth_choice(c, layer, post, await_)
                if choice is not None:
                    g.then(mlp, choice)
                    prev = choice
                else:
                    g.then(mlp, post)
                    g.then(post, await_)
                    prev = await_
            g.then(prev, cat)
        g.then_finish(cat)
        return g


    def _synth_choice(self, c: int, layer: int, post, await_):
        """The layer's ``SynthCollectiveChoice``, or None without ``synth``
        or where no instantiation survives."""
        if not self._synth:
            return None
        from tenzing_tpu_torch.collectives.synth import (
            FixedCollective,
            SynthCollectiveChoice,
            sketch_menu,
        )
        from tenzing_tpu_torch.collectives.topology import mesh_topology

        a = self._args
        bpe = np.dtype(a.dtype).itemsize
        part_bytes = (a.mb_size // self._synth_dp) * a.d_model * bpe
        variants, menu = sketch_menu(
            tp_mlp_synth_plans(a, c, layer, n_dp=self._synth_dp),
            mesh_topology({AXIS: a.n_tp}, host=False),
            # the psum's floor: a ring all-reduce moves about twice the
            # partial's bytes in one post
            fixed_bytes=2.0 * part_bytes,
            relax=self._synth_relax, collective="all_reduce")
        if not variants:
            return None
        base = f"psum_{c}_{layer}"
        return SynthCollectiveChoice(base, FixedCollective(base, [post, await_]),
                                     variants, menu)


def make_tp_mlp_buffers(
    args: TpMlpArgs, seed: int = 0, n_dp: int = 1, synth: bool = False
) -> Tuple[Dict[str, np.ndarray], Dict[str, object], np.ndarray]:
    """(buffers, specs, expected Y) for the TP forward: the reference's
    arrays for the same seed, bit for bit.  W1 is column-sharded and W2
    row-sharded over ``tp``; chunk inputs are replicated over ``tp``; the
    written activations are stacked per tp rank (every tp rank's block of a
    reduced sum is the same).  With ``n_dp > 1`` the specs target a
    ``("dp", "tp")`` mesh: each chunk's rows split over ``dp`` as well,
    weights replicated over it.  The expected Y is the float64 layer stack,
    laid out as the device blocks are (per tp copy, each dp rank's rows of
    every chunk in chunk order), in the workload's dtype.  With ``synth``
    the buffers include the staging of every sketch of
    :func:`tp_mlp_synth_plans`, stacked over ``(tp, dp)`` as the other
    written activations."""
    rng = np.random.default_rng(seed)
    L, v = args.n_layers, args.n_chunks
    b, d, dff = args.mb_size, args.d_model, args.d_ff
    assert dff % args.n_tp == 0, "d_ff must divide across tp shards"
    assert b % n_dp == 0, "mb_size must divide across dp shards"
    dt = np.dtype(args.dtype)
    x = rng.standard_normal((v * b, d)).astype(dt)
    w1 = rng.standard_normal((L, d, dff)).astype(dt) / np.sqrt(d)
    w2 = rng.standard_normal((L, dff, d)).astype(dt) / np.sqrt(dff)

    y = x.astype(np.float64)
    for layer in range(L):
        y = (gelu_tanh(y @ w1[layer].astype(np.float64))
             @ w2[layer].astype(np.float64))

    dp = ("dp",) if n_dp > 1 else ()
    bufs: Dict[str, np.ndarray] = {
        "W1": w1,
        "W2": w2,
        "Y": np.zeros((args.n_tp * v * b, d), dt),
    }
    specs: Dict[str, object] = {
        "W1": (None, None, AXIS),  # column-sharded, dp-replicated
        "W2": (None, AXIS, None),  # row-sharded, dp-replicated
        "Y": ((AXIS,) + dp, None),
    }
    for c in range(v):
        bufs[f"X_{c}"] = x[c * b:(c + 1) * b]
        specs[f"X_{c}"] = (dp if dp else None, None)
        for layer in range(L):
            for nm in (f"part_{c}_{layer}", f"sum_{c}_{layer}"):
                bufs[nm] = np.zeros((args.n_tp * b, d), dt)
                specs[nm] = ((AXIS,) + dp, None)
            if not synth:
                continue
            for plan in tp_mlp_synth_plans(args, c, layer, n_dp=n_dp):
                for decl in plan.buffers:
                    if decl.name in bufs:
                        continue
                    bufs[decl.name] = np.zeros(
                        (args.n_tp * n_dp * decl.shape[0],)
                        + tuple(decl.shape[1:]), dt)
                    specs[decl.name] = ((AXIS,) + dp, None)
    bs = b // n_dp
    per_tp = np.concatenate([
        np.concatenate([y[c * b + j * bs:c * b + (j + 1) * bs]
                        for c in range(v)])
        for j in range(n_dp)
    ])
    want = np.tile(per_tp.astype(dt), (args.n_tp, 1))
    return bufs, specs, want
