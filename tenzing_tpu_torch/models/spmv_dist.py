"""Distributed SpMV over a ``("dp", "sp")`` mesh: a row-partitioned band
matrix whose remote columns come from the two neighbouring row shards.

Counterpart of ``tenzing_tpu/models/spmv_dist.py`` (reference
``RowPartSpmv``, row_part_spmv.cuh:105-445): ``sp`` splits the matrix rows
and the x block, ``dp`` a batch of right-hand sides.  The half-bandwidth is
below the block size, so every remote column lives in an adjacent ``sp``
shard and the negotiated exchange is two neighbour exchanges:
``exchange_left`` (shard p receives shard p-1's x block; shard 0 zeros) and
``exchange_right`` (shard p+1's; the last shard zeros).  Each is an in-op
exchange (ops/comm_ops.py ``lane_permute``) on the op's lane, which the
solver places beside the local SpMV.

Graph shape (the reference compound, ops_spmv.cuh:394-417)::

    start -> {spmv_local, exchange_left, exchange_right}
    {exchange_left, exchange_right} -> spmv_halo
    {spmv_local, spmv_halo} -> y_add -> finish

Each rank runs the schedule on its block of every buffer (parallel/mesh.py
``shard_buffers``; the specs are the reference's ``PartitionSpec`` s as
tuples).  The SpMVs are batched ELL products: ``index_select`` of the x
block (or the halo, the two received blocks side by side) by the int32
column slab into scratch, times the value slab, summed over the row width.
Ops write in place; a timed run allocates nothing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import CompoundOp, DeviceOp
from tenzing_tpu_torch.models.spmv import CooMat, CsrMat, random_band_matrix
from tenzing_tpu_torch.ops.comm_ops import lane_permute, open_shift

AXIS = "sp"


def ell_batched(x, vals, cols, prod, out) -> None:
    """out (b, r) = sum_w vals[r, w] * x[:, cols[r, w]], through ``prod``
    (b, r, w) scratch: the reference's ``einsum("rw,brw->br", vals,
    x[:, cols])``."""
    import torch

    torch.index_select(x, 1, cols.view(-1), out=prod.view(prod.shape[0], -1))
    prod.mul_(vals)
    torch.sum(prod, dim=2, out=out)


def _prod_spec(shapes, x: str, vals: str) -> Tuple[Tuple[int, ...], str]:
    """(shape, dtype) of the gathered products of a batched ELL product."""
    return (shapes[x][0],) + tuple(shapes[vals]), "float32"


class ExchangeLeft(DeviceOp):
    """Receive the left neighbour's x block (shard p gets shard p-1's block;
    the edge shard receives zeros): the open permutation ``[(i, i + 1)]``
    over ``sp``."""

    def reads(self):
        return ["X"]

    def writes(self):
        return ["x_left"]

    def apply(self, bufs, ctx):
        lane_permute(ctx, self, AXIS, open_shift(1), [("X", "x_left")])


class ExchangeRight(DeviceOp):
    """Receive the right neighbour's x block (shard p gets shard p+1's
    block; the last shard receives zeros): ``[(i + 1, i)]``."""

    def reads(self):
        return ["X"]

    def writes(self):
        return ["x_right"]

    def apply(self, bufs, ctx):
        lane_permute(ctx, self, AXIS, open_shift(-1), [("X", "x_right")])


class SpMVLocalShard(DeviceOp):
    """Y_loc = local-slab SpMV against the owned x block."""

    def reads(self):
        return ["X", "A_loc_vals", "A_loc_cols"]

    def writes(self):
        return ["Y_loc"]

    def scratch_for(self, shapes):
        return {"dist_prod_loc": _prod_spec(shapes, "X", "A_loc_vals")}

    def apply(self, bufs, ctx):
        ell_batched(bufs["X"], bufs["A_loc_vals"], bufs["A_loc_cols"],
                    ctx.scratch["dist_prod_loc"], bufs["Y_loc"])


class SpMVHaloShard(DeviceOp):
    """Y_rem = halo-slab SpMV against [x_left ++ x_right] (remote columns),
    the two blocks side by side in scratch."""

    def reads(self):
        return ["x_left", "x_right", "A_rem_vals", "A_rem_cols"]

    def writes(self):
        return ["Y_rem"]

    def scratch_for(self, shapes):
        b, w = shapes["x_left"]
        return {"dist_halo": ((b, 2 * w), "float32"),
                "dist_prod_rem": _prod_spec(shapes, "x_left", "A_rem_vals")}

    def apply(self, bufs, ctx):
        import torch

        halo = ctx.scratch["dist_halo"]
        torch.cat([bufs["x_left"], bufs["x_right"]], 1, out=halo)
        ell_batched(halo, bufs["A_rem_vals"], bufs["A_rem_cols"],
                    ctx.scratch["dist_prod_rem"], bufs["Y_rem"])


class AddShards(DeviceOp):
    """Y = Y_loc + Y_rem (the reference's VectorAdd, implemented)."""

    def reads(self):
        return ["Y_loc", "Y_rem"]

    def writes(self):
        return ["Y"]

    def apply(self, bufs, ctx):
        import torch

        torch.add(bufs["Y_loc"], bufs["Y_rem"], out=bufs["Y"])


class DistSpMV(CompoundOp):
    def __init__(self, name: str = "dist_spmv"):
        super().__init__(name)

    def graph(self) -> Graph:
        g = Graph()
        loc = SpMVLocalShard("spmv_local")
        exl = ExchangeLeft("exchange_left")
        exr = ExchangeRight("exchange_right")
        halo = SpMVHaloShard("spmv_halo")
        add = AddShards("y_add")
        g.start_then(loc)
        g.start_then(exl)
        g.start_then(exr)
        g.then(exl, halo)
        g.then(exr, halo)
        g.then(loc, add)
        g.then(halo, add)
        g.then_finish(add)
        return g


def split_rows(rows: CsrMat, lo: int, hi: int, remote_slot, halo: int):
    """The rows of one shard (``rows``: its CSR row slice, global columns)
    as (local CSR, remote CSR of ``halo`` columns): local columns renumbered
    ``c - lo``, remote ones ``remote_slot(c)``, each in CSR order.  The reference builds the
    same COO lists entry by entry (spmv_dist.py:150-167,
    spmv_irregular.py:371-383); this does it on whole arrays."""
    r = np.repeat(np.arange(rows.m, dtype=np.int64), rows.row_widths())
    c = rows.cols.astype(np.int64)
    v = rows.vals
    here = (c >= lo) & (c < hi)
    loc = CooMat(rows.m, hi - lo, r[here], c[here] - lo,
                 v[here].astype(np.float32))
    rem = CooMat(rows.m, halo, r[~here], remote_slot(c[~here]),
                 v[~here].astype(np.float32))
    return loc.to_csr(), rem.to_csr()


def slabs(mats):
    """The concatenated ELL slabs (vals, int32 cols) of per-shard CSR
    matrices, padded to their common width (at least 1)."""
    w = max(1, max(int(s.row_widths().max(initial=0)) for s in mats))
    parts = [s.to_slab(w) for s in mats]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]).astype(np.int32))


def make_dist_spmv_buffers(
    n_sp: int,
    batch: int = 8,
    rows_per_shard: int = 256,
    nnz_per_row: int = 8,
    seed: int = 0,
) -> Tuple[Dict[str, np.ndarray], Dict[str, object], np.ndarray]:
    """(buffers, specs, expected Y) for a mesh with ``n_sp`` row shards: the
    reference's arrays for the same seed, bit for bit.  The global band
    matrix has half-bandwidth < rows_per_shard, so all remote columns are
    in adjacent shards; a remote column of the left block goes to halo slot
    ``c - (lo - B)``, of the right block to ``B + (c - hi)``."""
    m = n_sp * rows_per_shard
    bw = max(1, rows_per_shard // 2)
    a = random_band_matrix(m, bw, nnz_per_row * m, seed=seed)

    loc_slabs, rem_slabs = [], []
    for p in range(n_sp):
        lo, hi = p * rows_per_shard, (p + 1) * rows_per_shard

        def slot(c, lo=lo, hi=hi):
            return np.where(c < lo, c - (lo - rows_per_shard),
                            rows_per_shard + (c - hi))

        loc, rem = split_rows(a.retain_rows(lo, hi), lo, hi, slot,
                              2 * rows_per_shard)
        loc_slabs.append(loc)
        rem_slabs.append(rem)
    lv, lc = slabs(loc_slabs)
    rv, rc = slabs(rem_slabs)

    rng = np.random.default_rng(seed + 1)
    X = rng.random((batch, m), dtype=np.float32)
    want = np.stack([a.matvec(X[b]) for b in range(batch)])

    bufs = {
        "X": X,
        "A_loc_vals": lv,
        "A_loc_cols": lc,
        "A_rem_vals": rv,
        "A_rem_cols": rc,
        "x_left": np.zeros_like(X),
        "x_right": np.zeros_like(X),
        "Y_loc": np.zeros_like(X),
        "Y_rem": np.zeros_like(X),
        "Y": np.zeros_like(X),
    }
    specs = {
        "X": ("dp", AXIS),
        "A_loc_vals": (AXIS, None),
        "A_loc_cols": (AXIS, None),
        "A_rem_vals": (AXIS, None),
        "A_rem_cols": (AXIS, None),
        "x_left": ("dp", AXIS),
        "x_right": ("dp", AXIS),
        "Y_loc": ("dp", AXIS),
        "Y_rem": ("dp", AXIS),
        "Y": ("dp", AXIS),
    }
    return bufs, specs, want
