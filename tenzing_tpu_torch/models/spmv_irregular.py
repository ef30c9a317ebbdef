"""Distributed SpMV with a general irregular remote-column exchange.

Counterpart of ``tenzing_tpu/models/spmv_irregular.py`` (reference
``RowPartSpmv`` for arbitrary sparsity: the local / remote split and the
negotiated per-rank send and receive lists, row_part_spmv.cuh:259-423, then
PostSend / PostRecv / WaitRecv beside the local SpMV, ops_spmv.cuh:217-304).

* **Setup** (:func:`negotiate_exchange`, host numpy).  For every requester
  shard p and cyclic distance d, ``send_lists[d][p]`` is the sorted set of
  global columns that p's rows reference and shard ``(p - d) % n_sp`` owns.
  Distances with empty lists everywhere are dropped; the remote columns are
  renumbered into one contiguous halo, distance by distance
  (split_mat.hpp:22-136).
* **Data plane.**  For each kept distance d: ``gather_d`` packs the
  requested x entries into the padded send buffer, a post shifts it d hops
  over ``sp``, ``await_d`` waits for it; ``spmv_halo`` runs against the
  received segments side by side.  With ``impl_choice`` the exchange is a
  menu (:class:`ExchangeChoice`): per-distance ``PermuteStart`` chains
  (``exchange.permute``), one padded ``AllToAllStart`` on ``split_axis=1``
  (``exchange.a2a``), or per-distance ``RdmaShiftStart`` chains with
  ``shift=d, collective_id=d`` (``exchange.rdma``: ops/rdma.py, the
  ``rdma_shift`` kernels between ranks that share one card).

Graph shape (the reference SpMV compound, ops_spmv.cuh:306-436)::

    start -> spmv_local ----------------------------> y_add -> finish
    start -> gather_d -> permute_d -> await_d -+
                          (one chain per d)    +-> spmv_halo -> y_add

Op names, kind tags and schedule JSON are the reference's.  Ops write in
place into their buffers or declared scratch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import ChoiceOp, CompoundOp, DeviceOp, OpBase
from tenzing_tpu_torch.models.spmv import CsrMat
from tenzing_tpu_torch.models.spmv_dist import (
    AXIS,
    AddShards,
    SpMVLocalShard,
    ell_batched,
    slabs,
    split_rows,
)
from tenzing_tpu_torch.ops.comm_ops import AllToAllStart, AwaitTransfer, PermuteStart


@dataclass
class ExchangePlan:
    """The negotiated exchange (the product of the reference's setup
    handshake, row_part_spmv.cuh:259-423), computed on the host.

    ``send_lists[d][p]``: sorted global columns shard p receives from shard
    ``(p - d) % n_sp`` at distance d (the sender's send list is the same
    array read from the other side)."""

    n_sp: int
    block: int
    steps: List[int] = field(default_factory=list)
    widths: Dict[int, int] = field(default_factory=dict)
    send_lists: Dict[int, List[np.ndarray]] = field(default_factory=dict)
    offsets: Dict[int, int] = field(default_factory=dict)
    halo_width: int = 0

    def owner(self, col: int) -> int:
        return min(int(col) // self.block, self.n_sp - 1)

    def halo_slot(self, p: int, col: int) -> int:
        """Position of global column ``col`` in requester p's halo."""
        q = self.owner(col)
        d = (p - q) % self.n_sp
        lst = self.send_lists[d][p]
        j = int(np.searchsorted(lst, col))
        assert j < len(lst) and lst[j] == col, (p, col, d)
        return self.offsets[d] + j

    def halo_slots(self, p: int, cols: np.ndarray) -> np.ndarray:
        """:meth:`halo_slot` of every column of ``cols`` (remote to p)."""
        owners = np.minimum(cols // self.block, self.n_sp - 1)
        dist = (p - owners) % self.n_sp
        out = np.empty(len(cols), dtype=np.int64)
        for d in np.unique(dist):
            lst = self.send_lists[int(d)][p]
            sel = dist == d
            j = np.searchsorted(lst, cols[sel])
            if np.any(j >= len(lst)) or np.any(lst[np.minimum(
                    j, len(lst) - 1)] != cols[sel]):
                raise AssertionError(f"shard {p}: a remote column at "
                                     f"distance {int(d)} is not in its list")
            out[sel] = self.offsets[int(d)] + j
        return out


def negotiate_exchange(a: CsrMat, n_sp: int) -> ExchangePlan:
    """Per-(requester, distance) column lists for arbitrary sparsity (the
    host-side product of the reference's Isend / Probe / Recv handshake)."""
    assert a.m % n_sp == 0, "rows must divide evenly across sp shards"
    block = a.m // n_sp
    plan = ExchangePlan(n_sp=n_sp, block=block)
    needed: List[List[np.ndarray]] = [[np.array([], dtype=np.int64)] * n_sp
                                      for _ in range(n_sp)]  # [d][p]
    for p in range(n_sp):
        lo, hi = p * block, (p + 1) * block
        rows = a.retain_rows(lo, hi)
        cols = np.unique(rows.cols.astype(np.int64))
        remote = cols[(cols < lo) | (cols >= hi)]
        owners = np.minimum(remote // block, n_sp - 1)
        for q in np.unique(owners):
            d = (p - int(q)) % n_sp
            needed[d][p] = remote[owners == q]  # sorted (np.unique order)
    off = 0
    for d in range(1, n_sp):
        w = max((len(needed[d][p]) for p in range(n_sp)), default=0)
        if w == 0:
            continue
        plan.steps.append(d)
        plan.widths[d] = w
        plan.send_lists[d] = needed[d]
        plan.offsets[d] = off
        off += w
    plan.halo_width = max(1, off)
    return plan


class GatherSend(DeviceOp):
    """Pack the x entries the distance-``d`` receiver asked for into the
    padded send buffer (reference Scatter, ops_spmv.cuh:194-215):
    ``index_select`` of the x block by this shard's list."""

    def __init__(self, name: str, d: int):
        super().__init__(name)
        self._d = d

    def reads(self):
        return ["X", f"send_idx_{self._d}"]

    def writes(self):
        return [f"send_{self._d}"]

    def apply(self, bufs, ctx):
        import torch

        idx = bufs[f"send_idx_{self._d}"][0]  # (w_d,) this shard's list
        torch.index_select(bufs["X"], 1, idx, out=bufs[f"send_{self._d}"])


class SpMVHaloIrregular(DeviceOp):
    """Y_rem against the received halo segments side by side (reference yr
    SpMVKernel over the renumbered remote matrix, ops_spmv.cuh:398-401)."""

    def __init__(self, name: str, steps: List[int]):
        super().__init__(name)
        self._steps = list(steps)

    def reads(self):
        return [f"recv_{d}" for d in self._steps] + ["A_rem_vals", "A_rem_cols"]

    def writes(self):
        return ["Y_rem"]

    def scratch_for(self, shapes):
        b = shapes["X"][0]
        w = sum(shapes[f"recv_{d}"][1] for d in self._steps)
        return {"irr_halo": ((b, w), "float32"),
                "irr_prod_rem": ((b,) + tuple(shapes["A_rem_vals"]),
                                 "float32")}

    def apply(self, bufs, ctx):
        import torch

        halo = ctx.scratch["irr_halo"]
        torch.cat([bufs[f"recv_{d}"] for d in self._steps], 1, out=halo)
        ell_batched(halo, bufs["A_rem_vals"], bufs["A_rem_cols"],
                    ctx.scratch["irr_prod_rem"], bufs["Y_rem"])


class GatherAll(DeviceOp):
    """Pack every receiver's requested entries into the (n_sp, w_max) send
    matrix the all-to-all ships (the Scatter of the Ialltoallv path)."""

    def reads(self):
        return ["X", "send_idx_all"]

    def writes(self):
        return ["send_all"]

    def apply(self, bufs, ctx):
        import torch

        idx = bufs["send_idx_all"][0]  # (n_sp, w_max) this shard's lists
        out = bufs["send_all"]  # (b, n_sp, w_max)
        torch.index_select(bufs["X"], 1, idx.view(-1),
                           out=out.view(out.shape[0], -1))


class UnpackA2A(DeviceOp):
    """Split the all-to-all result back into the per-distance receive
    buffers, so the ops after it are the permute path's (same halo
    layout): ``recv_d`` <- the first ``w_d`` entries of the row shard
    ``(p - d) % n_sp`` sent."""

    def __init__(self, name: str, steps: List[int], widths: Dict[int, int]):
        super().__init__(name)
        self._steps = list(steps)
        self._widths = dict(widths)

    def reads(self):
        return ["recv_a2a"]

    def writes(self):
        return [f"recv_{d}" for d in self._steps]

    def apply(self, bufs, ctx):
        out = bufs["recv_a2a"]  # (b, n_sp, w_max): row q = sent by shard q
        p, n = ctx.mesh.index(AXIS), ctx.mesh.size(AXIS)
        for d in self._steps:
            bufs[f"recv_{d}"].copy_(out[:, (p - d) % n, :self._widths[d]])


def _add_distance_chain(g: Graph, d: int, preds: List, succs: List) -> None:
    """Wire one gather -> permute-start -> await chain for distance ``d``
    between ``preds`` and ``succs``."""
    gather = GatherSend(f"gather_{d}", d)
    post = PermuteStart(f"permute_{d}", f"send_{d}", f"recv_{d}", axis=AXIS,
                        shift=d)
    await_ = AwaitTransfer(f"await_{d}", f"recv_{d}")
    for p in preds:
        g.then(p, gather)
    g.then(gather, post)
    g.then(post, await_)
    for s in succs:
        g.then(await_, s)


class PermuteExchange(CompoundOp):
    """Exchange via one gather -> permute-start -> await chain per kept
    cyclic distance (per-neighbour Isend / Irecv)."""

    def __init__(self, steps: List[int], name: str = "exchange.permute"):
        super().__init__(name)
        self._steps = list(steps)

    def graph(self) -> Graph:
        g = Graph()
        for d in self._steps:
            _add_distance_chain(g, d, [g.start()], [g.finish()])
        return g


class A2AExchange(CompoundOp):
    """Exchange via one padded all-to-all (the reference Ialltoallv,
    ops_mpi.hpp:82-119): gather-all -> a2a-start -> await -> unpack."""

    def __init__(self, steps: List[int], widths: Dict[int, int],
                 name: str = "exchange.a2a"):
        super().__init__(name)
        self._steps = list(steps)
        self._widths = dict(widths)

    def graph(self) -> Graph:
        g = Graph()
        gather = GatherAll("gather_all")
        post = AllToAllStart("a2a_post", "send_all", "recv_a2a", axis=AXIS)
        await_ = AwaitTransfer("a2a_await", "recv_a2a")
        unpack = UnpackA2A("a2a_unpack", self._steps, self._widths)
        g.start_then(gather)
        g.then(gather, post)
        g.then(post, await_)
        g.then(await_, unpack)
        g.then_finish(unpack)
        return g


class RdmaExchange(CompoundOp):
    """Exchange via one gather -> shift-start -> await chain per kept cyclic
    distance: each shard writes its negotiated block into its ``+d``
    neighbour's receive buffer (ops/rdma.py ``RdmaShiftStart``, collective
    id d)."""

    def __init__(self, steps: List[int], name: str = "exchange.rdma"):
        super().__init__(name)
        self._steps = list(steps)

    def graph(self) -> Graph:
        from tenzing_tpu_torch.ops.rdma import RdmaShiftStart

        g = Graph()
        for d in self._steps:
            gather = GatherSend(f"gather_{d}", d)
            post = RdmaShiftStart(f"rdma_{d}", f"send_{d}", f"recv_{d}",
                                  axis=AXIS, shift=d, collective_id=d)
            await_ = AwaitTransfer(f"await_{d}", f"recv_{d}")
            g.start_then(gather)
            g.then(gather, post)
            g.then(post, await_)
            g.then_finish(await_)
        return g


class ExchangeChoice(ChoiceOp):
    """The exchange menu: per-distance permutes, one padded all-to-all, or
    per-distance shifts."""

    def __init__(self, steps: List[int], widths: Dict[int, int],
                 name: str = "exchange"):
        super().__init__(name)
        self._steps = list(steps)
        self._widths = dict(widths)

    def choices(self) -> List[OpBase]:
        return [
            PermuteExchange(self._steps),
            A2AExchange(self._steps, self._widths),
            RdmaExchange(self._steps),
        ]


class IrregularSpMV(CompoundOp):
    """The irregular-exchange SpMV iteration as one compound op.
    ``steps`` / ``widths`` must match the plan the buffers were built with.
    With ``impl_choice=True`` the exchange is a ChoiceOp (the buffers need
    ``impl_choice=True`` too)."""

    def __init__(self, steps: List[int], name: str = "irr_spmv",
                 widths: Optional[Dict[int, int]] = None,
                 impl_choice: bool = False):
        super().__init__(name)
        self._steps = list(steps)
        self._widths = dict(widths) if widths else {}
        self._impl_choice = impl_choice
        if impl_choice and steps and not self._widths:
            raise ValueError(
                "impl_choice=True needs widths=plan.widths (the a2a unpack "
                "slices each distance's segment by its negotiated width)")

    def graph(self) -> Graph:
        g = Graph()
        loc = SpMVLocalShard("spmv_local")
        add = AddShards("y_add")
        if not self._steps:  # block-diagonal matrix: nothing to exchange
            g.start_then(loc)
            g.then(loc, add)  # Y_rem stays the declared zero buffer
            g.then_finish(add)
            return g
        halo = SpMVHaloIrregular("spmv_halo", self._steps)
        g.start_then(loc)
        if self._impl_choice:
            exch = ExchangeChoice(self._steps, self._widths)
            g.start_then(exch)
            g.then(exch, halo)
        else:
            for d in self._steps:
                _add_distance_chain(g, d, [g.start()], [halo])
        g.then(loc, add)
        g.then(halo, add)
        g.then_finish(add)
        return g


def make_irregular_spmv_buffers(
    a: CsrMat,
    n_sp: int,
    batch: int = 8,
    seed: int = 0,
    impl_choice: bool = False,
) -> Tuple[Dict[str, np.ndarray], Dict[str, object], np.ndarray, ExchangePlan]:
    """(buffers, specs, expected Y, plan) for a square matrix of any
    sparsity row-partitioned over ``n_sp`` shards on a ("dp", "sp") mesh:
    the reference's arrays for the same seed, bit for bit.  The local slab
    gathers from the owned x block; the remote slab's columns are
    renumbered into the halo layout the kept distances deliver
    (:meth:`ExchangePlan.halo_slots`)."""
    assert a.m == a.n, "square matrix (y and x share the row partition)"
    plan = negotiate_exchange(a, n_sp)
    block = plan.block

    loc_slabs, rem_slabs = [], []
    for p in range(n_sp):
        lo, hi = p * block, (p + 1) * block
        loc, rem = split_rows(a.retain_rows(lo, hi), lo, hi,
                              lambda c, p=p: plan.halo_slots(p, c),
                              plan.halo_width)
        loc_slabs.append(loc)
        rem_slabs.append(rem)
    lv, lc = slabs(loc_slabs)
    rv, rc = slabs(rem_slabs)

    rng = np.random.default_rng(seed + 1)
    X = rng.random((batch, a.m), dtype=np.float32)
    want = np.stack([a.matvec(X[b]) for b in range(batch)])

    bufs: Dict[str, np.ndarray] = {
        "X": X,
        "A_loc_vals": lv,
        "A_loc_cols": lc,
        "A_rem_vals": rv,
        "A_rem_cols": rc,
        "Y_loc": np.zeros_like(X),
        "Y_rem": np.zeros_like(X),
        "Y": np.zeros_like(X),
    }
    specs: Dict[str, object] = {
        "X": ("dp", AXIS),
        "A_loc_vals": (AXIS, None),
        "A_loc_cols": (AXIS, None),
        "A_rem_vals": (AXIS, None),
        "A_rem_cols": (AXIS, None),
        "Y_loc": ("dp", AXIS),
        "Y_rem": ("dp", AXIS),
        "Y": ("dp", AXIS),
    }
    for d in plan.steps:
        w = plan.widths[d]
        idx = np.zeros((n_sp, w), dtype=np.int32)
        for q in range(n_sp):
            # sender q serves receiver (q + d) % n_sp: that receiver's list,
            # all owned by q, out of q's x block
            lst = plan.send_lists[d][(q + d) % n_sp]
            idx[q, :len(lst)] = lst - q * block
        bufs[f"send_idx_{d}"] = idx
        bufs[f"send_{d}"] = np.zeros((batch, n_sp * w), dtype=np.float32)
        bufs[f"recv_{d}"] = np.zeros((batch, n_sp * w), dtype=np.float32)
        specs[f"send_idx_{d}"] = (AXIS, None)
        specs[f"send_{d}"] = ("dp", AXIS)
        specs[f"recv_{d}"] = ("dp", AXIS)
    if impl_choice and plan.steps:
        # the padded all-to-all alternative: per-pair lists in one
        # (n_sp, w_max) send matrix per shard
        wmax = max(plan.widths[d] for d in plan.steps)
        idx_all = np.zeros((n_sp, n_sp, wmax), dtype=np.int32)
        for q in range(n_sp):
            for r in range(n_sp):
                d = (r - q) % n_sp
                if d not in plan.widths:
                    continue
                lst = plan.send_lists[d][r]  # what q ships to r (owned by q)
                idx_all[q, r, :len(lst)] = lst - q * block
        bufs["send_idx_all"] = idx_all
        bufs["send_all"] = np.zeros((batch, n_sp * n_sp, wmax),
                                    dtype=np.float32)
        bufs["recv_a2a"] = np.zeros((batch, n_sp * n_sp, wmax),
                                    dtype=np.float32)
        specs["send_idx_all"] = (AXIS, None, None)
        specs["send_all"] = ("dp", AXIS, None)
        specs["recv_a2a"] = ("dp", AXIS, None)
    return bufs, specs, want, plan
