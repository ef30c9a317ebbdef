"""Attention as searchable op DAGs: the ring over a mesh axis, and blocked
(flash) attention on one device.

Counterpart of ``tenzing_tpu/models/ring_attention.py``.

**The ring** (:class:`RingAttention`).  The sequence is split over mesh
axis ``"sp"``: each rank holds its queries Q and one K/V block.  At step s
the block in ``K<s%2>`` / ``V<s%2>`` folds into the online-softmax state
(acc, m_run, l_run), and ``rotate_s`` sends it one hop round the ring into
the other pair (double buffering: ``attn_s`` and ``rotate_s`` are
independent, and the write-after-read edge ``attn_{s-1} -> rotate_s``
keeps the pair being overwritten free).  The rotate is an in-op exchange
(ops/comm_ops.py ``lane_permute``, the cyclic permutation) on the op's
lane.  On an axis of size 1 the ring is one fold and no rotate.  Each
step's implementation is a menu with ``impl_choice`` (:class:`AttnStepChoice`:
``.xla``, ``.pallas``, ``.pallas_bf16``).

**Blocked attention** (:class:`BlockedAttention`): queries Q and the whole
K/V are resident; ``args.n_devices`` K/V blocks of ``seq_local`` keys fold
one after another into the state, and ``attn_finalize`` writes
O = acc / l_run.  Its searched freedom: the lane of every op, which fold
implementation each block uses (``attn_<s>.xla`` / ``.pallas`` /
``.pallas_bf16``), and the granularity (``attn_blocks.chain`` of per-block
folds vs the fused single-kernel ``attn_blocks.fused`` / ``.fused_bf16``).

Op names, menu suffixes and kind tags are the reference's, so a schedule
JSON written by the JAX package deserializes and runs here.

Buffers are torch tensors updated in place; no op allocates while a schedule
runs.  The ``.xla`` fold's (b, n, seq_local) score matrix and its two small
work buffers are declared op scratch (``DeviceOp.scratch``): the folds of a
chain are serialized by the state, so they share one set (the sub-folds of
one key count share another).  A block's K/V is a view of the resident K/V
(blocked) or the ring's current pair.  The ``.pallas`` slots run the fold
kernel ``tz_attn_block`` (ops/attention_kernels.py, csrc/attn_fold.cu; its
plain version under ``plain_kernels`` and on the CPU).  The bf16 slots cast
the block's K/V into a bf16 copy per launch
(``ops/attention_kernels.cast_kv_bf16``) held in op scratch (``attn_kv_bf16``
for the chain's folds, serialized by the state like the ``.xla`` set;
``attn_kv_bf16_all`` for the fused fold), and the kernel rounds Q as it
loads it: no bf16 copy of Q exists.

With ``chunk=True`` each block's ``.xla`` fold also offers its chunked
expansions (core/chunking.py): ``n`` :class:`BlockAttnSubFold` s of
``seq_local / n`` keys each, chained through the state, priced and pruned by
:func:`fold_chunk_menu`.  The blocked ``.xla`` folds (sub-folds included)
and the finalize declare fused-region bodies (``FUSED_BODY``,
``fused_operands``, ``fused_params``): runtime/fused.py lowers them into
members of the ``fused_region`` kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import ChoiceOp, CompoundOp, DeviceOp, OpBase
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.ops import attention_kernels as ak
from tenzing_tpu_torch.ops.comm_ops import cyclic_shift, lane_permute

AXIS = "sp"


@dataclass(frozen=True)
class RingAttnArgs:
    n_devices: int  # ring size; the block count of BlockedAttention
    batch: int = 1
    seq_local: int = 128  # queries per device; keys per block
    head_dim: int = 128
    dtype: str = "float32"

    @property
    def scale(self) -> float:
        return 1.0 / float(np.sqrt(self.head_dim))


def _kv(s: int) -> Tuple[str, str]:
    """Buffer names holding the K/V block the ring folds at step ``s``."""
    return f"K{s % 2}", f"V{s % 2}"


class AttnStep(DeviceOp):
    """Ring step ``s``: fold the K/V pair ``_kv(s)`` into the local queries'
    online-softmax state with plain PyTorch (the reference's XLA einsum
    fold, ``AttnStep._update``; the ``.xla`` slot).  :class:`BlockAttnStep`
    folds a block of the resident K/V instead."""

    def __init__(self, name: str, s: int, args: RingAttnArgs):
        super().__init__(name)
        self._s = s
        self._args = args

    def reads(self):
        k, v = _kv(self._s)
        return ["Q", k, v, "acc", "m_run", "l_run"]

    def writes(self):
        return ["acc", "m_run", "l_run"]

    def _queries(self) -> int:
        """The local queries fold against each block."""
        return self._args.seq_local

    def _kv_block(self, bufs):
        k, v = _kv(self._s)
        return bufs[k], bufs[v]

    def _tag(self) -> str:
        """Suffix of this fold's scratch names ("": the full-block set)."""
        return ""

    def scratch(self):
        a = self._args
        return ak.fold_scratch(a.batch, self._queries(), a.seq_local,
                               a.head_dim, self._tag())

    def _update(self, q, k, v, acc, m, l, ctx) -> None:
        """(acc, m, l) := the fold of k/v, in place, into the declared scratch
        (reference AttnStep._update, ring_attention.py:79-94)."""
        sc, t = ctx.scratch, self._tag()
        ak.fold_into(q, k, v, acc, m, l, self._args.scale, sc["attn_s" + t],
                     sc["attn_row" + t], sc["attn_mnew" + t])

    def apply(self, bufs, ctx):
        k, v = self._kv_block(bufs)
        self._update(bufs["Q"], k, v, bufs["acc"], bufs["m_run"],
                     bufs["l_run"], ctx)

    # fused-region protocol (runtime/fused.py), as the reference declares
    # it: the online-softmax update is row-independent along the query axis
    # (axis 1 of the (b, n, d) state); the K/V block stays whole.  The kernel
    # subclasses inherit this but never join a region (uses_pallas).
    def fusible(self) -> bool:
        return True

    def fuse_tiling(self):
        t = {"Q": 1, "acc": 1, "m_run": 1, "l_run": 1}
        for n in self.reads():
            t.setdefault(n, None)  # the K/V pair, whatever its names
        return t


class FinalizeAttn(DeviceOp):
    """O = acc / l (the denominator division deferred past the folds)."""

    def __init__(self, name: str = "attn_finalize"):
        super().__init__(name)

    def reads(self):
        return ["acc", "l_run"]

    def writes(self):
        return ["O"]

    def apply(self, bufs, ctx):
        import torch

        torch.div(bufs["acc"], bufs["l_run"], out=bufs["O"])

    # fused-region protocol: elementwise over the (b, n, d) state
    def fusible(self) -> bool:
        return True

    def fuse_tiling(self):
        return {"acc": 1, "l_run": 1, "O": 1}

    # the fused_region body (ops/fused_region.py): O = acc / l over the tile
    FUSED_BODY = "attn_finalize"

    def fused_operands(self):
        return ("acc", "l_run", "O")


class AttnStepPallas(AttnStep):
    """The ring step through the fold kernel (reference: the Pallas MXU
    kernel ``attn_block_pallas``) on float32 inputs; its plain version
    under ``ctx.plain_kernels``."""

    BF16 = False

    def scratch(self):
        return {}

    def uses_pallas(self) -> bool:
        return True

    def chunkable(self) -> bool:
        return False  # the kernel owns its blocking

    def _update(self, q, k, v, acc, m, l, ctx) -> None:
        if ctx.plain_kernels:
            ak.attn_block_plain(q, k, v, acc, m, l, self._args.scale, self.BF16)
            return
        ak.attn_block(q, k, v, acc, m, l, self._args.scale,
                      bf16_inputs=self.BF16,
                      kv_scratch=ctx.scratch.get("attn_kv_bf16"))


class AttnStepPallasBf16(AttnStepPallas):
    """The ring step through the fold kernel on bfloat16-rounded q/k/v (the
    reference casts them before its bf16 Pallas call); the kernel reads the
    pair cast into the ``attn_kv_bf16`` scratch."""

    BF16 = True

    def scratch(self):
        a = self._args
        return {"attn_kv_bf16": ak.kv_scratch_spec(a.batch, a.seq_local,
                                                   a.head_dim)}


class AttnStepChoice(ChoiceOp):
    """The implementation menu of one ring step: plain PyTorch, or the fold
    kernel on float32 or bfloat16 inputs."""

    def __init__(self, name: str, s: int, args: RingAttnArgs):
        super().__init__(name)
        self._s = s
        self._args = args

    def choices(self) -> List[OpBase]:
        return [
            AttnStep(self.name() + ".xla", self._s, self._args),
            AttnStepPallas(self.name() + ".pallas", self._s, self._args),
            AttnStepPallasBf16(self.name() + ".pallas_bf16", self._s,
                               self._args),
        ]


class RotateKV(DeviceOp):
    """Send step ``s``'s K/V pair one hop round the ring into the other pair
    (rank i's goes to rank i + 1): an in-op exchange of the cyclic
    permutation on the op's lane (reference ``RotateKV``, a ``lax.ppermute``
    in the op).  On an axis of size 1 it is a copy."""

    def __init__(self, name: str, s: int):
        super().__init__(name)
        self._s = s

    def reads(self):
        return list(_kv(self._s))

    def writes(self):
        return list(_kv(self._s + 1))

    def apply(self, bufs, ctx):
        lane_permute(ctx, self, AXIS, cyclic_shift,
                     list(zip(_kv(self._s), _kv(self._s + 1))))


class RingAttention(CompoundOp):
    """The whole ring as one compound op: n_devices steps chained through
    the softmax state, n_devices - 1 rotates chained through the K/V pairs,
    the write-after-read edges attn_{s-1} -> rotate_s, the finalize last.
    With ``impl_choice`` each step is an :class:`AttnStepChoice`."""

    def __init__(self, args: RingAttnArgs, name: str = "ring_attention",
                 impl_choice: bool = False):
        super().__init__(name)
        self._args = args
        self._impl_choice = impl_choice

    def args(self) -> RingAttnArgs:
        return self._args

    def graph(self) -> Graph:
        g = Graph()
        n = self._args.n_devices
        mk = AttnStepChoice if self._impl_choice else AttnStep
        attns = [mk(f"attn_{s}", s, self._args) for s in range(n)]
        rots = [RotateKV(f"rotate_{s}", s) for s in range(n - 1)]
        g.start_then(attns[0])
        for s in range(1, n):
            g.then(attns[s - 1], attns[s])
            g.then(rots[s - 1], attns[s])
        for s in range(1, n - 1):
            g.then(rots[s - 1], rots[s])
        if rots:
            g.start_then(rots[0])
        for s in range(1, n - 1):
            # WAR: rotate_s overwrites the pair attn_{s-1} reads
            g.then(attns[s - 1], rots[s])
        fin = FinalizeAttn()
        g.then(attns[-1], fin)
        g.then_finish(fin)
        return g


class BlockAttnStep(AttnStep):
    """Fold K/V block ``s`` sliced from the resident K/V (a view: keys
    s*seq_local .. (s+1)*seq_local) into the state."""

    def reads(self):
        return ["Q", "K", "V", "acc", "m_run", "l_run"]

    def _queries(self) -> int:
        """All n_devices * seq_local queries fold against each block."""
        return self._args.n_devices * self._args.seq_local

    def _kv_block(self, bufs):
        blk = self._args.seq_local
        sl = slice(self._s * blk, (self._s + 1) * blk)
        return bufs["K"][:, sl], bufs["V"][:, sl]

    # the fused_region body (ops/fused_region.py): the same fold over the
    # tile's query rows against this block's keys, read whole
    FUSED_BODY = "attn_fold"

    def fused_operands(self):
        return ("Q", "K", "V", "acc", "m_run", "l_run")

    def fused_params(self):
        blk = self._args.seq_local
        return {"key_off": self._s * blk, "nkv": blk, "scale": self._args.scale}

    # -- op-chunking protocol (core/chunking.py): the fold splits along its
    # K/V block into n sub-folds of seq_local / n keys; a sub-fold is a finer
    # BlockAttnStep and the online-softmax state chain is the combine.  The
    # kernel slots own their blocking and never split.
    def chunkable(self) -> bool:
        return True

    def chunk_counts(self) -> List[int]:
        from tenzing_tpu_torch.core.chunking import pow2_counts

        return pow2_counts(self._args.seq_local)

    def split(self, n: int) -> List["BlockAttnSubFold"]:
        from dataclasses import replace

        blk = self._args.seq_local
        if n < 1 or blk % n:
            raise ValueError(f"{blk} K/V columns do not split {n} ways")
        sub = replace(self._args, seq_local=blk // n)
        # sub-fold j of block s reads keys s*blk + j*(blk/n): block s*n + j
        # at the finer size
        return [BlockAttnSubFold(f"{self.name()}.c{n}p{j}", self._s * n + j,
                                 sub, self._queries())
                for j in range(n)]


class BlockAttnSubFold(BlockAttnStep):
    """One sub-fold of :meth:`BlockAttnStep.split`: the fold of
    ``args.seq_local`` keys (block ``s`` at that size) into all ``queries``
    query rows.  It never splits again."""

    def __init__(self, name: str, s: int, args: RingAttnArgs, queries: int):
        super().__init__(name, s, args)
        self._nq = queries

    def _queries(self) -> int:
        return self._nq

    def _tag(self) -> str:
        return f"_k{self._args.seq_local}"

    def chunkable(self) -> bool:
        return False


class BlockAttnStepPallas(BlockAttnStep):
    """Blocked step with the fold kernel (reference: the Pallas MXU kernel
    attn_block_pallas) on float32 inputs."""

    BF16 = False
    scratch = AttnStepPallas.scratch
    uses_pallas = AttnStepPallas.uses_pallas
    chunkable = AttnStepPallas.chunkable
    _update = AttnStepPallas._update


class BlockAttnStepPallasBf16(BlockAttnStepPallas):
    """Blocked step with the fold kernel on bfloat16-rounded q/k/v (the
    reference casts them before its bf16 Pallas call); the kernel reads the
    block's K/V cast into the ``attn_kv_bf16`` scratch."""

    BF16 = True

    def scratch(self):
        a = self._args
        return {"attn_kv_bf16": ak.kv_scratch_spec(a.batch, a.seq_local,
                                                   a.head_dim)}


def fold_chunk_menu(args: RingAttnArgs, relax: bool = False):
    """(pruned counts, {count: est hidden µs}) for one block fold
    (bench/roofline.chunk_menu).  The one-device blocked fold has no
    neighbouring transfer to hide (``comm_us=0``), so at full size every
    n > 1 is pruned and ``perf.chunked`` says so; ``relax`` (the smoke and
    the tests) keeps every structurally valid count."""
    from tenzing_tpu_torch.bench import roofline

    bpe = np.dtype(args.dtype).itemsize
    b, d, blk = args.batch, args.head_dim, args.seq_local
    nq = args.n_devices * blk  # all queries fold against each block
    state = 6.0 * b * nq * d * bpe  # read + write acc, m_run, l_run
    cost = roofline.Cost(flops=4.0 * b * nq * blk * d,
                         hbm_bytes=state + 2.0 * b * blk * d * bpe)
    # every extra sub-fold re-presents the whole state (the combine)
    return roofline.chunk_menu(
        BlockAttnStep("probe", 0, args).chunk_counts(), cost,
        comm_us=0.0, combine_bytes=state, relax=relax)


class BlockAttnChoice(ChoiceOp):
    """The fold implementation menu of one block, with the chunked
    expansions of the ``.xla`` fold for ``chunk_counts`` > 1."""

    def __init__(self, name: str, s: int, args: RingAttnArgs,
                 chunk_counts=(), chunk_est=None):
        super().__init__(name)
        self._s = s
        self._args = args
        self._chunks = tuple(int(c) for c in chunk_counts if int(c) > 1)
        self._chunk_est = dict(chunk_est or {})
        if chunk_counts:
            from tenzing_tpu_torch.core.chunking import menu_info

            self.chunk_menu = menu_info(name + ".xla", chunk_counts,
                                        self._chunk_est)

    def choices(self) -> List[OpBase]:
        from tenzing_tpu_torch.core.chunking import ChunkedOp

        out: List[OpBase] = [
            BlockAttnStep(self.name() + ".xla", self._s, self._args),
            BlockAttnStepPallas(self.name() + ".pallas", self._s, self._args),
            BlockAttnStepPallasBf16(self.name() + ".pallas_bf16", self._s,
                                    self._args),
        ]
        out += [ChunkedOp(BlockAttnStep(self.name() + ".xla", self._s,
                                        self._args),
                          n, est_hidden_us=self._chunk_est.get(n))
                for n in self._chunks]
        return out


class FusedBlockAttn(DeviceOp):
    """All K/V blocks folded in one launch of the fused kernel (reference:
    attn_fused_pallas, whose state lives in VMEM across the kv grid axis;
    here it stays in registers across the kernel's kv loop)."""

    BF16 = False

    def __init__(self, name: str, args: RingAttnArgs):
        super().__init__(name)
        self._args = args

    def reads(self):
        return ["Q", "K", "V", "acc", "m_run", "l_run"]

    def writes(self):
        return ["acc", "m_run", "l_run"]

    def uses_pallas(self) -> bool:
        return True

    def apply(self, bufs, ctx):
        args = (bufs["Q"], bufs["K"], bufs["V"], bufs["acc"], bufs["m_run"],
                bufs["l_run"], self._args.scale)
        if ctx.plain_kernels:
            ak.attn_fused_plain(*args, bkv=self._args.seq_local,
                                bf16_inputs=self.BF16)
            return
        ak.attn_fused(*args, bkv=self._args.seq_local, bf16_inputs=self.BF16,
                      kv_scratch=ctx.scratch.get("attn_kv_bf16_all"))


class FusedBlockAttnBf16(FusedBlockAttn):
    """The fused kernel on bfloat16-rounded q/k/v; it reads all of K/V cast
    into the ``attn_kv_bf16_all`` scratch."""

    BF16 = True

    def scratch(self):
        a = self._args
        return {"attn_kv_bf16_all": ak.kv_scratch_spec(
            a.batch, a.n_devices * a.seq_local, a.head_dim)}


def _mk_block_step(name: str, s: int, args: RingAttnArgs, impl_choice: bool,
                   chunk_counts=(), chunk_est=None) -> OpBase:
    """One block fold vertex: the kernel ChoiceOp (with the chunked
    expansions of chunk_counts > 1), a bare step in a ``ChunkChoice`` when
    only chunking is searched, or the bare plain-PyTorch step."""
    if impl_choice:
        return BlockAttnChoice(name, s, args, chunk_counts=chunk_counts,
                               chunk_est=chunk_est)
    step = BlockAttnStep(name, s, args)
    counts = [c for c in (chunk_counts or ()) if int(c) > 1]
    if counts:
        from tenzing_tpu_torch.core.chunking import ChunkChoice, chunk_variants

        return ChunkChoice(step, chunk_variants(step, counts, chunk_est))
    return step


class BlockChain(CompoundOp):
    """The per-block fold chain as one expandable vertex — the staged
    alternative the fused kernel competes with inside
    :class:`AttnEngineChoice`."""

    def __init__(self, name: str, args: RingAttnArgs, impl_choice: bool,
                 chunk_counts=(), chunk_est=None):
        super().__init__(name)
        self._args = args
        self._impl_choice = impl_choice
        self._chunk_counts = tuple(chunk_counts)
        self._chunk_est = dict(chunk_est or {})

    def graph(self) -> Graph:
        g = Graph()
        n = self._args.n_devices
        attns = [_mk_block_step(f"attn_{s}", s, self._args, self._impl_choice,
                                self._chunk_counts, self._chunk_est)
                 for s in range(n)]
        g.start_then(attns[0])
        for s in range(1, n):
            g.then(attns[s - 1], attns[s])
        g.then_finish(attns[-1])
        return g


class AttnEngineChoice(ChoiceOp):
    """Granularity menu for the whole blocked fold: the per-block chain vs
    the fused single-kernel flash (f32 or bf16 inputs)."""

    def __init__(self, args: RingAttnArgs, impl_choice: bool,
                 chunk_counts=(), chunk_est=None):
        super().__init__("attn_blocks")
        self._args = args
        self._impl_choice = impl_choice
        self._chunk_counts = tuple(chunk_counts)
        self._chunk_est = dict(chunk_est or {})

    def choices(self) -> List[OpBase]:
        return [
            BlockChain("attn_blocks.chain", self._args, self._impl_choice,
                       self._chunk_counts, self._chunk_est),
            FusedBlockAttn("attn_blocks.fused", self._args),
            FusedBlockAttnBf16("attn_blocks.fused_bf16", self._args),
        ]


class BlockedAttention(CompoundOp):
    """Single-device blockwise attention over ``args.n_devices`` K/V blocks:
    the folds chain through the softmax state; the per-block kernel is a
    ChoiceOp when ``impl_choice``; with ``fused_choice`` the whole chain also
    competes with the fused kernel (:class:`AttnEngineChoice`).

    ``chunk=True`` adds the chunked sub-fold expansions of each block's
    ``.xla`` fold to the menus, pruned by :func:`fold_chunk_menu`
    (``chunk_relax`` keeps every valid count: the smoke and the tests)."""

    def __init__(self, args: RingAttnArgs, name: str = "blocked_attention",
                 impl_choice: bool = False, fused_choice: bool = False,
                 chunk: bool = False, chunk_relax: bool = False):
        super().__init__(name)
        self._args = args
        self._impl_choice = impl_choice
        self._fused_choice = fused_choice
        self._chunk = chunk
        self._chunk_relax = chunk_relax

    def args(self) -> RingAttnArgs:
        return self._args

    def graph(self) -> Graph:
        g = Graph()
        n = self._args.n_devices
        counts, est = ((), None)
        if self._chunk:
            counts, est = fold_chunk_menu(self._args, relax=self._chunk_relax)
        fin = FinalizeAttn()
        if self._fused_choice:
            eng = AttnEngineChoice(self._args, self._impl_choice, counts, est)
            g.start_then(eng)
            g.then(eng, fin)
        else:
            attns = [_mk_block_step(f"attn_{s}", s, self._args,
                                    self._impl_choice, counts, est)
                     for s in range(n)]
            g.start_then(attns[0])
            for s in range(1, n):
                g.then(attns[s - 1], attns[s])
            g.then(attns[-1], fin)
        g.then_finish(fin)
        return g


def fixed_order(g: Graph, platform, engine: str = ".chain",
                kernel_of: Optional[Callable[[int], str]] = None,
                lane_of: Optional[Callable[[int], int]] = None) -> Sequence:
    """A complete schedule of ``g`` (Start -> BlockedAttention -> Finish with
    ``fused_choice``) that picks ``attn_blocks<engine>``, the kernel slot
    ``kernel_of(s)`` for block s (default ``.xla``) and lane ``lane_of(s)``
    for block s's fold (default: the first lane); every other decision is
    the first one offered.  With the defaults it is the first-decision walk,
    the driver's naive order (reference bench/driver.py:1060-1064); the
    reference's kernel incumbents pick by engine and kernel suffix the same
    way (bench/driver.py:1113-1126)."""
    from tenzing_tpu_torch.core.state import AssignLane, ChooseOp, State

    def block(name: str) -> Optional[int]:
        """s of a block fold ``attn_<s>`` / ``attn_<s>.<slot>``, else None."""
        head = name.split(".")[0]
        return int(head[5:]) if head[5:].isdigit() else None

    st = State(g)
    while not st.is_terminal():
        ds = st.get_decisions(platform)
        pick = ds[0]
        for d in ds:
            if isinstance(d, ChooseOp):
                op = d.op.name()
                want = (op + engine if op == "attn_blocks" else
                        op + (kernel_of(block(op)) if kernel_of else ".xla"))
                if d.choice.name() == want:
                    pick = d
                    break
            elif (isinstance(d, AssignLane) and lane_of is not None
                  and block(d.op.name()) is not None
                  and d.lane.id == lane_of(block(d.op.name()))):
                pick = d
                break
        st = st.apply(pick)
    return st.sequence


def fixed_orders(g: Graph, n_blocks: int) -> Dict[str, Sequence]:
    """The fixed schedules the executor checks and the breakdown time: naive
    (all ``.xla``, one lane), the chain on ``.pallas`` alternating two lanes,
    the chain on ``.pallas_bf16``, the fused kernel (f32 and bf16), and a
    mixed chain (``.xla`` / ``.pallas`` / ``.pallas_bf16`` by block, two
    lanes)."""
    from tenzing_tpu_torch.core.platform import Platform

    one, two = Platform.make_n_lanes(1), Platform.make_n_lanes(2)
    slots = (".xla", ".pallas", ".pallas_bf16")
    alternate = lambda s: s % 2  # noqa: E731
    return {
        "naive": fixed_order(g, one),
        "pallas-2l": fixed_order(g, two, kernel_of=lambda s: ".pallas",
                                 lane_of=alternate),
        "pallas_bf16": fixed_order(g, one, kernel_of=lambda s: ".pallas_bf16"),
        "fused": fixed_order(g, one, ".fused"),
        "fused_bf16": fixed_order(g, one, ".fused_bf16"),
        "mixed-2l": fixed_order(g, two, kernel_of=lambda s: slots[s % 3],
                                lane_of=alternate),
    }


def make_ring_buffers(
    args: RingAttnArgs, seed: int = 0, with_expected: bool = True
) -> Tuple[Dict[str, np.ndarray], Dict[str, object], Optional[np.ndarray]]:
    """(buffers, specs, expected O) for a ring over ``args.n_devices`` ranks:
    the reference's arrays for the same seed, bit for bit.  Every buffer is
    split along its sequence axis (spec ``(None, "sp", None)``).  The
    expected O is dense softmax attention in float64 on the host, in the
    same sequence order; ``with_expected=False`` skips it (at 8k context it
    builds two (b, n, n) float64 arrays) and returns None."""
    rng = np.random.default_rng(seed)
    b, nl, d, nsp = args.batch, args.seq_local, args.head_dim, args.n_devices
    n = nl * nsp
    dt = np.dtype(args.dtype)
    q = rng.standard_normal((b, n, d)).astype(dt)
    k = rng.standard_normal((b, n, d)).astype(dt)
    v = rng.standard_normal((b, n, d)).astype(dt)
    want = None
    if with_expected:
        s_ = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                       k.astype(np.float64))
        s_ *= args.scale
        p = np.exp(s_ - s_.max(axis=2, keepdims=True))
        p /= p.sum(axis=2, keepdims=True)
        want = np.einsum("bqk,bkd->bqd", p,
                         v.astype(np.float64)).astype(np.float32)
    shape = (b, n, d)
    bufs = {
        "Q": q,
        "K0": k,
        "V0": v,
        "K1": np.zeros_like(k),
        "V1": np.zeros_like(v),
        "acc": np.zeros(shape, np.float32),
        "m_run": np.full(shape, -1e30, np.float32),
        "l_run": np.zeros(shape, np.float32),
        "O": np.zeros(shape, np.float32),
    }
    spec = (None, AXIS, None)
    return bufs, {name: spec for name in bufs}, want


def make_blocked_buffers(
    args: RingAttnArgs, seed: int = 0, with_expected: bool = True
) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray]]:
    """(buffers, expected O) for single-device blockwise attention: the
    reference's arrays for the same seed, bit for bit (its
    ``make_blocked_buffers`` via ``make_ring_buffers``): the ring's first
    K/V pair as the resident K/V."""
    ring, _specs, want = make_ring_buffers(args, seed, with_expected)
    bufs = {"Q": ring["Q"], "K": ring["K0"], "V": ring["V0"]}
    bufs.update({k: ring[k] for k in ("acc", "m_run", "l_run", "O")})
    return bufs, want
