"""Blocked (flash) attention on one device as a searchable op DAG.

Counterpart of the single-device part of ``tenzing_tpu/models/ring_attention.py``:
queries Q and the whole K/V are resident; ``args.n_devices`` K/V blocks of
``seq_local`` keys fold one after another into the online-softmax state
(acc, m_run, l_run), and ``attn_finalize`` writes O = acc / l_run.

The searched freedom: the lane of every op, which fold implementation each
block uses (``attn_<s>.xla`` / ``.pallas`` / ``.pallas_bf16``), and the
granularity (``attn_blocks.chain`` of per-block folds vs the fused
single-kernel ``attn_blocks.fused`` / ``.fused_bf16``).  Op names, menu
suffixes and kind tags are the reference's, so a schedule JSON written by the
JAX package deserializes and runs here.

Buffers are torch tensors updated in place; no op allocates while a schedule
runs.  The ``.xla`` fold's (b, n, seq_local) score matrix and its two small
work buffers are declared op scratch (``DeviceOp.scratch``): the folds of a
chain are serialized by the state, so they share one set.  A block's K/V is
a view of the resident K/V; the bf16 slots round inside the kernel, so no
bf16 copy of Q/K/V exists.

Left for later slices: the mesh ring (``RingAttention``, ``RotateKV``,
``AttnStepChoice``) and the chunked sub-folds (``BlockAttnSubFold``,
``fold_chunk_menu``, the ``ChunkedOp`` menu entries).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import ChoiceOp, CompoundOp, DeviceOp, OpBase
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.ops import attention_kernels as ak


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


class AttnStep(DeviceOp):
    """Fold K/V block ``s`` into the online-softmax state with plain PyTorch
    (the reference's XLA einsum fold, ``AttnStep._update``; the ``.xla``
    slot).  Subclasses say which block and how many query rows:
    :class:`BlockAttnStep` here; the mesh ring's step comes with the
    multi-device slice."""

    def __init__(self, name: str, s: int, args: RingAttnArgs):
        super().__init__(name)
        self._s = s
        self._args = args

    def writes(self):
        return ["acc", "m_run", "l_run"]

    def scratch(self):
        a = self._args
        return ak.fold_scratch(a.batch, self._queries(), a.seq_local,
                               a.head_dim)

    def _update(self, q, k, v, acc, m, l, ctx) -> None:
        """(acc, m, l) := the fold of k/v, in place, into the declared scratch
        (reference AttnStep._update, ring_attention.py:79-94)."""
        sc = ctx.scratch
        ak.fold_into(q, k, v, acc, m, l, self._args.scale, sc["attn_s"],
                     sc["attn_row"], sc["attn_mnew"])

    def apply(self, bufs, ctx):
        k, v = self._kv_block(bufs)
        self._update(bufs["Q"], k, v, bufs["acc"], bufs["m_run"],
                     bufs["l_run"], ctx)


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


class BlockAttnStepPallas(BlockAttnStep):
    """Blocked step with the fold kernel (reference: the Pallas MXU kernel
    attn_block_pallas) on float32 inputs."""

    BF16 = False

    def scratch(self):
        return {}

    def _update(self, q, k, v, acc, m, l, ctx) -> None:
        fold = ak.attn_block_plain if ctx.plain_kernels else ak.attn_block
        fold(q, k, v, acc, m, l, self._args.scale, bf16_inputs=self.BF16)


class BlockAttnStepPallasBf16(BlockAttnStepPallas):
    """Blocked step with the fold kernel on bfloat16-rounded q/k/v (the
    reference casts them before its bf16 Pallas call)."""

    BF16 = True


class BlockAttnChoice(ChoiceOp):
    """The fold implementation menu of one block."""

    def __init__(self, name: str, s: int, args: RingAttnArgs):
        super().__init__(name)
        self._s = s
        self._args = args

    def choices(self) -> List[OpBase]:
        return [
            BlockAttnStep(self.name() + ".xla", self._s, self._args),
            BlockAttnStepPallas(self.name() + ".pallas", self._s, self._args),
            BlockAttnStepPallasBf16(self.name() + ".pallas_bf16", self._s,
                                    self._args),
        ]


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

    def apply(self, bufs, ctx):
        fold = ak.attn_fused_plain if ctx.plain_kernels else ak.attn_fused
        fold(bufs["Q"], bufs["K"], bufs["V"], bufs["acc"], bufs["m_run"],
             bufs["l_run"], self._args.scale, bkv=self._args.seq_local,
             bf16_inputs=self.BF16)


class FusedBlockAttnBf16(FusedBlockAttn):
    BF16 = True


def _mk_block_step(name: str, s: int, args: RingAttnArgs,
                   impl_choice: bool) -> OpBase:
    """One block fold vertex: the kernel ChoiceOp, or the bare plain-PyTorch
    step when the menu is off."""
    if impl_choice:
        return BlockAttnChoice(name, s, args)
    return BlockAttnStep(name, s, args)


class BlockChain(CompoundOp):
    """The per-block fold chain as one expandable vertex — the staged
    alternative the fused kernel competes with inside
    :class:`AttnEngineChoice`."""

    def __init__(self, name: str, args: RingAttnArgs, impl_choice: bool):
        super().__init__(name)
        self._args = args
        self._impl_choice = impl_choice

    def graph(self) -> Graph:
        g = Graph()
        n = self._args.n_devices
        attns = [_mk_block_step(f"attn_{s}", s, self._args, self._impl_choice)
                 for s in range(n)]
        g.start_then(attns[0])
        for s in range(1, n):
            g.then(attns[s - 1], attns[s])
        g.then_finish(attns[-1])
        return g


class AttnEngineChoice(ChoiceOp):
    """Granularity menu for the whole blocked fold: the per-block chain vs
    the fused single-kernel flash (f32 or bf16 inputs)."""

    def __init__(self, args: RingAttnArgs, impl_choice: bool):
        super().__init__("attn_blocks")
        self._args = args
        self._impl_choice = impl_choice

    def choices(self) -> List[OpBase]:
        return [
            BlockChain("attn_blocks.chain", self._args, self._impl_choice),
            FusedBlockAttn("attn_blocks.fused", self._args),
            FusedBlockAttnBf16("attn_blocks.fused_bf16", self._args),
        ]


class BlockedAttention(CompoundOp):
    """Single-device blockwise attention over ``args.n_devices`` K/V blocks:
    the folds chain through the softmax state; the per-block kernel is a
    ChoiceOp when ``impl_choice``; with ``fused_choice`` the whole chain also
    competes with the fused kernel (:class:`AttnEngineChoice`)."""

    def __init__(self, args: RingAttnArgs, name: str = "blocked_attention",
                 impl_choice: bool = False, fused_choice: bool = False):
        super().__init__(name)
        self._args = args
        self._impl_choice = impl_choice
        self._fused_choice = fused_choice

    def args(self) -> RingAttnArgs:
        return self._args

    def graph(self) -> Graph:
        g = Graph()
        n = self._args.n_devices
        fin = FinalizeAttn()
        if self._fused_choice:
            eng = AttnEngineChoice(self._args, self._impl_choice)
            g.start_then(eng)
            g.then(eng, fin)
        else:
            attns = [_mk_block_step(f"attn_{s}", s, self._args,
                                    self._impl_choice)
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


def make_blocked_buffers(
    args: RingAttnArgs, seed: int = 0, with_expected: bool = True
) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray]]:
    """(buffers, expected O) for single-device blockwise attention: the
    reference's arrays for the same seed, bit for bit (its
    ``make_blocked_buffers`` via ``make_ring_buffers``).  The expected O is
    dense softmax attention in float64 on the host; ``with_expected=False``
    skips it (at 8k context it builds two (b, n, n) float64 arrays) and
    returns None."""
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
        "K": k,
        "V": v,
        "acc": np.zeros(shape, np.float32),
        "m_run": np.full(shape, -1e30, np.float32),
        "l_run": np.zeros(shape, np.float32),
        "O": np.zeros(shape, np.float32),
    }
    return bufs, want
