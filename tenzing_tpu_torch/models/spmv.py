"""Single-device SpMV iteration: y = A @ x, row-partitioned, local/remote split.

Counterpart of ``tenzing_tpu/models/spmv.py`` (reference ``include/tenzing/spmv/``
+ ``src/spmv/``): the CSR/COO host structures, the random band matrix, the 1-D
row partition helpers, the local/remote column split with renumbering, the
device ops SpMV / Scatter / VectorAdd / LocalExchange and the ``SpMVCompound``
that wires one iteration.  The host structures are numpy and give the same
arrays, bit for bit, as the reference's.

A CSR matrix is lowered once, on the host, to a dense ELL slab (values padded
to a fixed row width, with a companion int32 column slab); the SpMV is then
``y[i] = sum_j vals[i, j] * x[cols[i, j]]``.  The remote half runs against the
renumbered remote columns, as the reference's split SpMV does.

Device ops write in place: the ``.xla`` SpMV gathers into declared scratch
(``index_select`` with the int32 columns, no int64 copy), multiplies and sums
into ``y``; Scatter is an ``index_select(out=)``, VectorAdd an ``add(out=)``,
LocalExchange a ``copy_``.  A timed run allocates nothing.  The ``.pallas``
slot runs the ``ell_spmv`` kernel (ops/spmv_kernels.py).

Differences from the reference, on purpose:

* ``SpMVPallasOp`` raises when x is too long for the kernel, where the
  reference's quietly runs the ``.xla`` path (its models/spmv.py:314-315).
  The gate ``supports`` is kept, so a menu built with known ``x_sizes``
  never offers the slot there.
* The host exchange (``exchange="host"``) posts its spill and fetch on one
  transfer channel, so the fetch never reads the pinned ``host_x`` before
  the spill has written it (the graph has no await between them).

With ``synth=True`` (``exchange="host"`` only) the round trip is one
alternative of a ``SynthCollectiveChoice`` whose others pipe the payload
through the host in 2 or 4 chunks (collectives/synth.py, the ``pipe``
sketch; :func:`spmv_synth_plans` is the one source of the graph's chains
and the buffers' staging, whose ``.hst`` pieces live in pinned host
memory).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.operation import ChoiceOp, CompoundOp, DeviceOp, OpBase

if TYPE_CHECKING:  # pragma: no cover
    from tenzing_tpu_torch.core.sequence import Sequence


# -- host-side matrix structures (reference coo_mat.hpp / csr_mat.hpp) -----------


@dataclass
class CooMat:
    """Coordinate-format host matrix (reference CooMat, coo_mat.hpp:12-76)."""

    m: int
    n: int
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    def nnz(self) -> int:
        return len(self.vals)

    def to_csr(self) -> "CsrMat":
        order = np.lexsort((self.cols, self.rows))
        rows, cols, vals = self.rows[order], self.cols[order], self.vals[order]
        indptr = np.zeros(self.m + 1, dtype=np.int32)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)
        return CsrMat(self.m, self.n, indptr, cols.astype(np.int32), vals)


@dataclass
class CsrMat:
    """CSR host matrix (reference CsrMat<host>, csr_mat.hpp:34-155)."""

    m: int
    n: int
    indptr: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    def nnz(self) -> int:
        return len(self.vals)

    def retain_rows(self, lo: int, hi: int) -> "CsrMat":
        """Row slice [lo, hi) (reference retain_rows, csr_mat.hpp:101-155)."""
        a, b = self.indptr[lo], self.indptr[hi]
        return CsrMat(
            hi - lo,
            self.n,
            (self.indptr[lo : hi + 1] - a).astype(np.int32),
            self.cols[a:b],
            self.vals[a:b],
        )

    def row_widths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_slab(self, width: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Lower to a dense (m, width) ELL slab: (vals, cols), zero-padded.
        Padded entries point at column 0 with value 0 so the gather stays in
        bounds and contributes nothing."""
        wmax = int(self.row_widths().max(initial=0))
        w = int(width) if width is not None else max(1, wmax)
        if w < wmax:
            raise ValueError(
                f"slab width {w} would truncate rows (widest row has {wmax} nonzeros)"
            )
        vals = np.zeros((self.m, w), dtype=self.vals.dtype)
        cols = np.zeros((self.m, w), dtype=np.int32)
        if self.nnz():
            rows = np.repeat(np.arange(self.m), self.row_widths())
            pos = np.arange(self.nnz()) - self.indptr[rows]
            vals[rows, pos] = self.vals
            cols[rows, pos] = self.cols
        return vals, cols

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host-side reference y = A @ x, summed in float64 (no dense
        materialization)."""
        if not self.nnz():
            return np.zeros(self.m, dtype=self.vals.dtype)
        rows = np.repeat(np.arange(self.m), self.row_widths())
        prods = (self.vals.astype(np.float64)) * x.astype(np.float64)[self.cols]
        return np.bincount(rows, weights=prods, minlength=self.m).astype(self.vals.dtype)

    def toarray(self) -> np.ndarray:
        """Dense form — small matrices / tests only."""
        out = np.zeros((self.m, self.n), dtype=self.vals.dtype)
        for i in range(self.m):
            for j in range(self.indptr[i], self.indptr[i + 1]):
                out[i, self.cols[j]] += self.vals[j]
        return out


def random_band_matrix(
    m: int, bw: int, nnz: int, seed: int = 0, dtype=np.float32
) -> CsrMat:
    """Random square band matrix: nnz entries within ``bw`` of the diagonal
    (reference random_band_matrix, csr_mat.hpp:335-369)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=nnz)
    offs = rng.integers(-bw, bw + 1, size=nnz)
    cols = np.clip(rows + offs, 0, m - 1)
    vals = rng.random(nnz, dtype=np.float64).astype(dtype)
    return CooMat(m, m, rows, cols, vals).to_csr()


def random_matrix(m: int, n: int, nnz: int, seed: int = 0, dtype=np.float32) -> CsrMat:
    """Uniform random sparse matrix (reference random_matrix, csr_mat.hpp:299-333)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    vals = rng.random(nnz, dtype=np.float64).astype(dtype)
    return CooMat(m, n, rows, cols, vals).to_csr()


def read_matrix_market(path: str, dtype=np.float32) -> CsrMat:
    """Load a MatrixMarket coordinate file (the reference reads .mtx inputs,
    tenzing-dfs/examples/spmv.cu:23,35-37).

    Supports ``coordinate`` matrices with field real/integer/pattern and
    symmetry general/symmetric/skew-symmetric (off-diagonal entries mirrored,
    skew negated).  Indices in the file are 1-based per the format."""
    with open(path) as f:
        header = f.readline().split()
        if (
            len(header) < 5
            or header[0] != "%%MatrixMarket"
            or header[1].lower() != "matrix"
            or header[2].lower() != "coordinate"
        ):
            raise ValueError(f"{path}: not a MatrixMarket coordinate file: {header}")
        field, symmetry = header[3].lower(), header[4].lower()
        if field not in ("real", "integer", "pattern"):
            raise ValueError(f"{path}: unsupported field {field!r}")
        if symmetry not in ("general", "symmetric", "skew-symmetric"):
            raise ValueError(f"{path}: unsupported symmetry {symmetry!r}")
        line = f.readline()
        while line and (line.lstrip().startswith("%") or not line.strip()):
            line = f.readline()
        if not line:
            raise ValueError(f"{path}: truncated file (no size line)")
        m, n, nnz = (int(t) for t in line.split())
        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        vals = np.ones(nnz, dtype=dtype)
        k = 0
        for line in f:
            t = line.split()
            if not t or t[0].startswith("%"):
                continue
            rows[k], cols[k] = int(t[0]) - 1, int(t[1]) - 1
            if field != "pattern":
                vals[k] = float(t[2])
            k += 1
        if k != nnz:
            raise ValueError(f"{path}: header promised {nnz} entries, found {k}")
    if symmetry != "general":
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, (sign * vals[off]).astype(dtype)]),
        )
    return CooMat(m, n, rows, cols, vals).to_csr()


# -- partition helpers (reference partition.hpp:11-75) ---------------------------


def part_by_rows(m: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous 1-D row partition: ``parts`` (lo, hi) ranges."""
    base, rem = divmod(m, parts)
    out = []
    lo = 0
    for p in range(parts):
        hi = lo + base + (1 if p < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def get_owner(m: int, parts: int, row: int) -> int:
    """Owning partition of a row (reference get_owner, partition.hpp:43-75)."""
    for p, (lo, hi) in enumerate(part_by_rows(m, parts)):
        if lo <= row < hi:
            return p
    raise IndexError(row)


# -- local/remote split (reference split_mat.hpp:22-136) -------------------------


@dataclass
class SplitMat:
    """A row-partition's matrix split by column ownership: ``local`` covers
    owned columns (renumbered to local x indices), ``remote`` covers off-part
    columns renumbered densely; ``remote_cols`` maps the dense remote index back
    to the global column."""

    local: CsrMat
    remote: CsrMat
    remote_cols: np.ndarray  # global column of each renumbered remote column


def split_local_remote(a: CsrMat, col_lo: int, col_hi: int) -> SplitMat:
    """Split by column range ownership, renumbering both halves
    (reference split_local_remote, split_mat.hpp:22-136).  Vectorized; the
    entries keep the reference's row-major order, so the arrays are the
    same."""
    rows = np.repeat(np.arange(a.m, dtype=np.int64), a.row_widths())
    cols = a.cols.astype(np.int64)
    own = (cols >= col_lo) & (cols < col_hi)
    rem = ~own
    uniq = np.unique(cols[rem])
    local = CooMat(a.m, col_hi - col_lo, rows[own], cols[own] - col_lo,
                   a.vals[own]).to_csr()
    remote = CooMat(a.m, max(1, len(uniq)), rows[rem],
                    np.searchsorted(uniq, cols[rem]).astype(np.int64),
                    a.vals[rem]).to_csr()
    return SplitMat(local=local, remote=remote, remote_cols=uniq)


# -- device ops ------------------------------------------------------------------


class SpMVOp(DeviceOp):
    """ELL-slab SpMV with plain PyTorch: y = sum(vals * x[cols], axis=1)
    (reference SpMVKernel, ops_spmv.cuh:61-163; the ``.xla`` slot).  The
    gathered products live in scratch of the slab's shape."""

    FUSED_BODY = "ell"  # the fused-region kernel body (runtime/fused.py)

    def __init__(self, name: str, x: str, y: str, vals: str, cols: str):
        super().__init__(name)
        self._x, self._y, self._vals, self._cols = x, y, vals, cols

    def reads(self):
        return [self._x, self._vals, self._cols]

    def writes(self):
        return [self._y]

    def fused_operands(self) -> Tuple[str, ...]:
        """Buffer names in the fused body's operand order: vals, cols, x, y."""
        return (self._vals, self._cols, self._x, self._y)

    def _scratch_name(self) -> str:
        return f"spmv_prod_{self._vals}"

    def scratch_for(self, shapes):
        return {self._scratch_name(): (tuple(shapes[self._vals]), "float32")}

    def apply(self, bufs, ctx):
        import torch

        vals, cols = bufs[self._vals], bufs[self._cols]
        prod = ctx.scratch[self._scratch_name()]
        torch.index_select(bufs[self._x], 0, cols.view(-1), out=prod.view(-1))
        prod.mul_(vals)
        torch.sum(prod, dim=1, out=bufs[self._y])

    # fused-region tiling (runtime/fused.py): rows are independent — the
    # slab and output decompose along axis 0; the gathered x must stay whole
    def fusible(self) -> bool:
        return True

    def fuse_tiling(self):
        return {self._vals: 0, self._cols: 0, self._y: 0, self._x: None}


class SpMVPallasOp(SpMVOp):
    """ELL-slab SpMV through the ``ell_spmv`` kernel (reference: the Pallas
    masked vreg-gather kernel, ops/spmv_pallas.py).  Raises when x is longer
    than the kernel takes (``supports``); the plain version under
    ``ctx.plain_kernels``."""

    def scratch_for(self, shapes):
        return {}

    def apply(self, bufs, ctx):
        from tenzing_tpu_torch.ops import spmv_kernels as sk

        x = bufs[self._x]
        if not sk.supports(x.shape[0]):
            raise ValueError(
                f"{self.name()}: x has {x.shape[0]} entries, more than the "
                f"ell_spmv kernel takes ({sk.MAX_X}); use the .xla slot")
        fn = sk.ell_spmv_plain if ctx.plain_kernels else sk.ell_spmv
        fn(bufs[self._vals], bufs[self._cols], x, out=bufs[self._y])

    def uses_pallas(self) -> bool:
        return True


class SpMVImplChoice(ChoiceOp):
    """Implementation menu for one SpMV: ``.xla`` (plain PyTorch gather) vs
    ``.pallas`` (the ``ell_spmv`` kernel) (reference ChoiceOp,
    operation.hpp:90-93).

    When the x-vector length is known at graph construction (``x_size``), the
    kernel is offered only if it supports that length."""

    def __init__(self, name: str, x: str, y: str, vals: str, cols: str,
                 x_size: Optional[int] = None):
        super().__init__(name)
        self._args = (x, y, vals, cols)
        self._x_size = x_size

    def choices(self) -> List[OpBase]:
        from tenzing_tpu_torch.ops.spmv_kernels import supports

        x, y, vals, cols = self._args
        out: List[OpBase] = [SpMVOp(self.name() + ".xla", x, y, vals, cols)]
        if self._x_size is None or supports(self._x_size):
            out.append(SpMVPallasOp(self.name() + ".pallas", x, y, vals, cols))
        return out


class Scatter(DeviceOp):
    """Gather owned x entries into a contiguous send buffer (reference Scatter,
    ops_spmv.cuh:194-215)."""

    FUSED_BODY = "gather"

    def __init__(self, name: str, x: str, idx: str, out: str):
        super().__init__(name)
        self._x, self._idx, self._out = x, idx, out

    def reads(self):
        return [self._x, self._idx]

    def writes(self):
        return [self._out]

    def fused_operands(self) -> Tuple[str, ...]:
        """x, idx, out."""
        return (self._x, self._idx, self._out)

    def apply(self, bufs, ctx):
        import torch

        torch.index_select(bufs[self._x], 0, bufs[self._idx], out=bufs[self._out])

    # fusion: each gathered entry depends only on its own index row
    def fusible(self) -> bool:
        return True

    def fuse_tiling(self):
        return {self._x: None, self._idx: 0, self._out: 0}


class VectorAdd(DeviceOp):
    """y = yl + yr (reference VectorAdd — a no-op there,
    src/spmv/ops_spmv.cu:44-46; implemented, as the JAX package does)."""

    FUSED_BODY = "add"

    def __init__(self, name: str, a: str, b: str, out: str):
        super().__init__(name)
        self._a, self._b, self._out = a, b, out

    def reads(self):
        return [self._a, self._b]

    def writes(self):
        return [self._out]

    def fused_operands(self) -> Tuple[str, ...]:
        """a, b, out."""
        return (self._a, self._b, self._out)

    def apply(self, bufs, ctx):
        import torch

        torch.add(bufs[self._a], bufs[self._b], out=bufs[self._out])

    # fusion: elementwise
    def fusible(self) -> bool:
        return True

    def fuse_tiling(self):
        return {self._a: 0, self._b: 0, self._out: 0}


class LocalExchange(DeviceOp):
    """Single-device stand-in for the exchange: copies the scattered send
    buffer into the remote-x buffer (the multi-device exchange comes with the
    mesh layer)."""

    FUSED_BODY = "copy"

    def __init__(self, name: str, src: str, dst: str):
        super().__init__(name)
        self._src, self._dst = src, dst

    def reads(self):
        return [self._src]

    def writes(self):
        return [self._dst]

    def fused_operands(self) -> Tuple[str, ...]:
        """src, dst."""
        return (self._src, self._dst)

    def apply(self, bufs, ctx):
        bufs[self._dst].copy_(bufs[self._src])

    # fusion: a device-local copy, trivially row-independent
    def fusible(self) -> bool:
        return True

    def fuse_tiling(self):
        return {self._src: 0, self._dst: 0}


# -- synthesized exchange (collectives/synth.py) -------------------------------

#: The synth site of the host x exchange: its directive runs as
#: ``x_exchange.synth.pipe.c<K>``.
SPMV_SYNTH_BASE = "x_exchange"


def spmv_synth_counts(n_remote: Optional[int]) -> List[int]:
    """The pipe chunk counts of an ``n_remote``-entry payload: 2 and 4 where
    they fit (one chunk is the fixed round trip).  An unknown payload has
    none."""
    return [k for k in (2, 4) if 2 <= k <= int(n_remote or 0)]


def spmv_synth_plans(n_remote: Optional[int]):
    """The pipe instantiations of the host x exchange: the one source of the
    graph's chains and the buffer builder's staging."""
    from tenzing_tpu_torch.collectives.synth import plan_host_pipe

    return [plan_host_pipe(SPMV_SYNTH_BASE, "send_buf", "x_remote",
                           int(n_remote), k)
            for k in spmv_synth_counts(n_remote)]


class SpMVCompound(CompoundOp):
    """The whole SpMV iteration as one compound op (reference SpMV CompoundOp,
    ops_spmv.cuh:306-436): start -> {local spmv, scatter -> exchange}; exchange
    -> remote spmv; {local, remote} -> add -> finish.

    With ``impl_choice=True`` the two SpMVs become implementation ChoiceOps
    (``.xla`` vs the ``ell_spmv`` kernel), searched alongside order and lanes.

    ``exchange`` picks the single-device stand-in for the reference's MPI x
    exchange (PostSend/WaitRecv ops, ops_spmv.cuh:217-304):

    * ``"local"`` (default) — a device-to-device copy;
    * ``"host"`` — an async host round trip with the post/wait split
      (spill_x -> fetch_x -> await_x) over ops/comm_ops.py, both posts on
      one transfer channel; the search can hide it behind the local SpMV.

    ``synth=True`` (with ``exchange="host"``) makes the round trip one
    alternative of a ``SynthCollectiveChoice`` whose others pipe the payload
    through the host in chunks (:func:`spmv_synth_plans`); the remote x
    length must be known (``x_sizes["x_remote"]``), an unknown payload is
    never synthesized.  ``synth_relax`` keeps every instantiation, those the
    roofline prune drops too (the tests, the smoke).  The compound carries
    the site's ``synth_menu`` itself, so where the prune drops every
    instantiation (no choice is built) the menu and its reasons still reach
    ``perf.synth``; the reference loses them there."""

    def __init__(self, name: str = "spmv", impl_choice: bool = False,
                 x_sizes: Optional[Dict[str, int]] = None,
                 exchange: str = "local", synth: bool = False,
                 synth_relax: bool = False):
        super().__init__(name)
        self._impl_choice = impl_choice
        # buffer-name -> x length, when known (prunes unsupported kernel choices)
        self._x_sizes = dict(x_sizes) if x_sizes else {}
        if exchange not in ("local", "host"):
            raise ValueError(f"exchange must be 'local' or 'host', got {exchange!r}")
        if synth and exchange != "host":
            raise ValueError("synth=True needs the exchange='host' round trip "
                             "(the host link is what the pipe sketch routes)")
        self._exchange = exchange
        self._synth = synth
        self._synth_relax = synth_relax
        if synth:
            self.synth_menu = self._synth_menu()[1]

    def graph(self) -> Graph:
        g = Graph()
        if self._impl_choice:
            def mk(name, x, y, vals, cols):
                return SpMVImplChoice(name, x, y, vals, cols,
                                      x_size=self._x_sizes.get(x))
        else:
            mk = SpMVOp
        yl = mk("spmv_local", "x_local", "y_local", "A_loc_vals", "A_loc_cols")
        scatter = Scatter("scatter", "x_local", "send_idx", "send_buf")
        yr = mk("spmv_remote", "x_remote", "y_remote", "A_rem_vals", "A_rem_cols")
        add = VectorAdd("y_add", "y_local", "y_remote", "y")
        g.start_then(yl)
        g.start_then(scatter)
        if self._exchange == "host":
            from tenzing_tpu_torch.ops.comm_ops import (
                AwaitTransfer,
                HostFetchStart,
                HostSpillStart,
            )

            # one channel for the round trip: the fetch reads host_x, which
            # the un-awaited spill writes, so it queues behind it
            spill = HostSpillStart("spill_x", "send_buf", "host_x", channel="x")
            fetch = HostFetchStart("fetch_x", "host_x", "x_remote", channel="x")
            await_ = AwaitTransfer("await_x", "x_remote")
            choice = self._synth_choice(spill, fetch, await_)
            if choice is not None:
                g.then(scatter, choice)
                g.then(choice, yr)
            else:
                g.then(scatter, spill)
                g.then(spill, fetch)
                g.then(fetch, await_)
                g.then(await_, yr)
        else:
            exch = LocalExchange("exchange", "send_buf", "x_remote")
            g.then(scatter, exch)
            g.then(exch, yr)
        g.then(yl, add)
        g.then(yr, add)
        g.then_finish(add)
        return g


    def _synth_choice(self, spill, fetch, await_):
        """The exchange's ``SynthCollectiveChoice``, or None without
        ``synth`` or where no instantiation survives."""
        if not self._synth:
            return None
        from tenzing_tpu_torch.collectives.synth import (
            FixedCollective,
            SynthCollectiveChoice,
        )

        variants, menu = self._synth_menu()
        if not variants:
            return None
        return SynthCollectiveChoice(
            SPMV_SYNTH_BASE,
            FixedCollective(SPMV_SYNTH_BASE, [spill, fetch, await_]),
            variants, menu)


    def _synth_menu(self):
        """(surviving pipe alternatives, the site's ``synth_menu``)."""
        from tenzing_tpu_torch.collectives.synth import sketch_menu
        from tenzing_tpu_torch.collectives.topology import host_topology

        n_rem = self._x_sizes.get("x_remote")
        return sketch_menu(
            spmv_synth_plans(n_rem), host_topology(),
            # the fixed floor: the round trip's bytes in one post (spill and
            # fetch move them twice)
            fixed_bytes=2.0 * 4 * int(n_rem or 0),
            relax=self._synth_relax, collective="exchange")


# the phase order of the fixed 2-lane schedules: the exchange is posted first
# and hidden behind the local SpMV on the other lane
SPMV_PHASES = ("scatter", "spill_x", "fetch_x", "spmv_local", "await_x",
               "spmv_remote", "y_add")


def fixed_orders(g: Graph) -> Dict[str, "Sequence"]:
    """The fixed schedules of the executor checks and the breakdown, over
    the driver's graph (``impl_choice``, ``exchange="host"``): ``naive`` (the
    first decision at every step, one lane, all ``.xla``), ``overlap-2l``
    (the exchange hidden behind the local SpMV on a second lane, ``.xla``)
    and ``pallas-2l`` (the same with every SpMV on the kernel where the menu
    offers it)."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.solve.local import drive, first_decision_order, phase_policy

    def prefer(suffix):
        def pick(op_name, choices):
            return next((c for c in choices if c.endswith(suffix)),
                        next((c for c in choices if c.endswith(".xla")), None))
        return pick

    two = Platform.make_n_lanes(2)
    return {
        "naive": first_decision_order(g, Platform.make_n_lanes(1)),
        "overlap-2l": drive(g, two, phase_policy(two, SPMV_PHASES,
                                                 prefer(".xla")))[0],
        "pallas-2l": drive(g, two, phase_policy(two, SPMV_PHASES,
                                                prefer(".pallas")))[0],
    }


def make_spmv_buffers(
    m: int = 4096,
    nnz_per_row: int = 10,
    bw: Optional[int] = None,
    seed: int = 0,
    slab_width: Optional[int] = None,
    matrix: Optional[CsrMat] = None,
    synth: bool = False,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The buffer dict of the single-device SpMV slice and the expected y
    (``CsrMat.matvec``, summed in float64).  The matrix is split at the column
    midpoint to mimic the distributed local/remote structure (reference
    spmv_run_strategy.cuh:44-47: m rows, nnz=10*m, band bw).  Pass ``matrix``
    (e.g. from ``read_matrix_market``) to use a concrete input instead of the
    random band matrix (reference spmv.cu:35-37).  ``synth=True`` adds the
    pipe sketch's staging (:func:`spmv_synth_plans`)."""
    if matrix is not None:
        if matrix.m != matrix.n:
            raise ValueError(f"SpMV slice needs a square matrix, got {matrix.m}x{matrix.n}")
        a, m = matrix, matrix.m
    else:
        bw = bw if bw is not None else max(1, m // 8)
        a = random_band_matrix(m, bw, nnz_per_row * m, seed=seed)
    half = m // 2
    sp = split_local_remote(a, 0, half)
    lv, lc = sp.local.to_slab(slab_width)
    rv, rc = sp.remote.to_slab(slab_width)
    rng = np.random.default_rng(seed + 1)
    x = rng.random(m, dtype=np.float32)
    # remote x entries come from the "other rank"'s region via scatter+exchange
    send_idx = sp.remote_cols.astype(np.int32)
    if len(send_idx) == 0:  # degenerate split: keep buffer shapes static
        send_idx = np.zeros(1, dtype=np.int32)
    bufs = {
        "x_local": x,  # this slice owns columns [0, half) but keeps full x for the gather
        "A_loc_vals": lv,
        "A_loc_cols": lc,
        "A_rem_vals": rv,
        "A_rem_cols": rc,
        "send_idx": send_idx,
        "send_buf": np.zeros(len(send_idx), dtype=np.float32),
        # staging buffer of the exchange="host" round trip (pinned host
        # memory, spmv_host_buffer_names); unused by exchange="local"
        "host_x": np.zeros(len(send_idx), dtype=np.float32),
        "x_remote": np.zeros(len(send_idx), dtype=np.float32),
        "y_local": np.zeros(m, dtype=np.float32),
        "y_remote": np.zeros(m, dtype=np.float32),
        "y": np.zeros(m, dtype=np.float32),
    }
    if synth:
        for plan in spmv_synth_plans(len(send_idx)):
            for d in plan.buffers:
                bufs[d.name] = np.zeros(d.shape, dtype=np.float32)
    want = a.matvec(x)
    return bufs, want


def spmv_host_buffer_names(n_remote: Optional[int] = None,
                           synth: bool = False) -> List[str]:
    """Buffers that live in pinned host memory for ``exchange="host"``
    (``buffers_from_numpy``'s ``host_names``).  With ``synth=True`` the pipe
    sketch's ``.hst`` pieces too (``n_remote``: the ``send_idx`` extent the
    buffers were built with), so every spill is an asynchronous copy into
    pinned memory."""
    out = ["host_x"]
    if synth:
        for plan in spmv_synth_plans(n_remote):
            out += [d.name for d in plan.buffers if d.space == "host"]
    return out
