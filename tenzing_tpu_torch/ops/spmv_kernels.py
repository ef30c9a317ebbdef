"""The ELL-slab SpMV kernel: ``ell_spmv``.

Counterpart of ``tenzing_tpu/ops/spmv_pallas.py``'s ``ell_spmv_pallas``::

    y[i] = sum_j vals[i, j] * x[cols[i, j]]

for vals (m, w) float32, cols (m, w) int32 and x (n) float32 with
n <= ``MAX_X``.  On Hopper it is hand-written CUDA (csrc/ell_spmv.cu): one
row a thread, the slab covered in one wave; each warp copies its 32 rows'
piece of the slab into shared memory with 16-byte copies, all issued
before the first wait, and x is gathered through the read-only L1 path
(no copy of x); each row sums in csrc/ell_row.cuh's fixed order, shared
with the fused region's ELL members (its rounding bound is
:func:`row_sum_bound`).  :func:`ell_row_plan` mirrors which rows the
kernel reads from shared memory and which from global memory.  The gate
``supports`` is the reference's (4096 = 32 vregs of 128 lanes), so the SpMV menu offers the
slot for the same x lengths in both packages.

``ell_spmv`` launches the kernel for CUDA tensors and runs
:func:`ell_spmv_plain` for CPU tensors; there is no other path.
``LAUNCHES["ell_spmv"]`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from tenzing_tpu_torch.ops import kernel_lib

# kernel launches (CUDA path only; the plain version and CPU tensors do not
# count)
LAUNCHES = kernel_lib.LaunchCounts("spmv", {"ell_spmv": 0})

LANES = 128
# n/128 vregs above which the reference's masked-gather sweep loses to the
# gather path; it offers the kernel only up to here (spmv_pallas.py:43-50)
MAX_X_BLOCKS = 32
MAX_X = LANES * MAX_X_BLOCKS  # 4096 float32 (16 KB)

# y against the plain version: both sum w float32 products per row, in
# different orders, so they agree to a few ulps of the row sum, not bitwise.
# A control that drops one slab column moves y by a whole product (PERF.md).
ELL_TOL = dict(rtol=1e-5, atol=1e-6)

# the kernel's constants (csrc/ell_spmv.cu)
ROWS_PER_WARP = 32    # one row a thread
SLAB_WIDTH = 32       # widest row staged in shared memory
# x gathers in flight a thread, and the partial sums of a row
# (csrc/ell_row.cuh kXBatch)
X_BATCH = 8


def ell_row_plan(m: int, w: int, vals_off: int = 0, cols_off: int = 0):
    """Where csrc/ell_spmv.cu reads each row's vals and cols: a list of
    (r0, r1, b0, a0, a1, rows) per warp piece of rows [r0, r1), whose
    16-byte aligned elements [a0, a1) are copied into shared memory from
    float b0 on, and ``rows[i]`` True where row r0 + i is read from there
    (False: from global memory).  ``vals_off`` / ``cols_off``: the slabs'
    data pointers modulo 16 bytes (a view into a larger buffer); the
    allocation itself is 16-byte aligned."""
    staged = w <= SLAB_WIDTH and (vals_off | cols_off) % 16 == 0
    out = []
    for r0 in range(0, m, ROWS_PER_WARP):
        r1 = min(r0 + ROWS_PER_WARP, m)
        b0, a0 = (r0 * w) & ~3, (r0 * w + 3) & ~3
        a1 = (r1 * w) & ~3
        if not staged or a1 < a0:
            a1 = a0
        rows = [a0 <= r * w and r * w + w <= a1 for r in range(r0, r1)]
        out.append((r0, r1, b0, a0, a1, rows))
    return out


def row_sum_bound(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                  x_batch: int = X_BATCH):
    """(y in float64, the rounding bound of the kernels' order): a row's
    entries fold into ``x_batch`` partial sums (ceil(w / x_batch) roundings
    each) added as a log2(x_batch)-level tree, so |y - y64| <=
    (ceil(w / x_batch) + log2(x_batch)) u sum |v x| to first order,
    u = 2^-24."""
    t = vals.double() * x.double()[cols.long()]
    w = vals.shape[1]
    levels = x_batch.bit_length() - 1
    return t.sum(1), ((-(-w // x_batch) + levels) * 2.0 ** -24
                      * t.abs().sum(1))


def supports(n: int, max_blocks: int = MAX_X_BLOCKS) -> bool:
    """Whether the kernel takes an x vector of length ``n`` (reference
    spmv_pallas.supports)."""
    return n <= LANES * max_blocks


def ell_spmv_plain(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: ``sum(vals * x[cols], 1)`` into ``out``
    (allocated when None).  It allocates its temporaries: it is the
    reference the kernel is held against, not a timed path."""
    y = torch.sum(vals * torch.index_select(x, 0, cols.reshape(-1)).view(
        vals.shape), dim=1)
    if out is None:
        return y
    out.copy_(y)
    return out


def ell_bytes(m: int, w: int, n: int) -> float:
    """Bytes one call must move: vals and cols read once (4 + 4 bytes an
    entry), x read once, y written once."""
    return float(8 * m * w + 4 * n + 4 * m)


def ell_flops(m: int, w: int) -> float:
    """Operations of one call: a multiply and an add per slab entry."""
    return 2.0 * m * w


def _check(vals, cols, x, out) -> None:
    if vals.dtype != torch.float32 or x.dtype != torch.float32 \
            or out.dtype != torch.float32:
        raise TypeError("ell_spmv: vals, x and out must be float32 (got "
                        f"{vals.dtype}, {x.dtype}, {out.dtype})")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_spmv: cols must be int32 (got {cols.dtype})")
    for key, t in (("vals", vals), ("cols", cols), ("x", x), ("out", out)):
        if t.device != vals.device:
            raise ValueError(f"ell_spmv: {key} on {t.device}, vals on {vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"ell_spmv: {key} must be contiguous")
    if vals.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"ell_spmv: vals {tuple(vals.shape)} and cols "
                         f"{tuple(cols.shape)} must be one (m, w) shape")
    if x.dim() != 1 or out.shape != (vals.shape[0],):
        raise ValueError(f"ell_spmv: x must be 1-D and out ({vals.shape[0]},) "
                         f"(got {tuple(x.shape)}, {tuple(out.shape)})")
    if not 1 <= x.shape[0] or not supports(x.shape[0]):
        raise ValueError(f"ell_spmv: x has {x.shape[0]} entries; the kernel "
                         f"takes 1 to {MAX_X}")
    if vals.shape[1] < 1:
        raise ValueError("ell_spmv: the slab has no columns")


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = sum_j vals[i, j] * x[cols[i, j]]`` on the current stream:
    the ``tz_ell_spmv`` kernel for CUDA tensors, :func:`ell_spmv_plain` for
    CPU tensors.  Writes into ``out`` (allocated when None) and returns it.
    Every column index must lie in [0, len(x))."""
    if out is None:
        out = torch.empty(vals.shape[0], dtype=vals.dtype, device=vals.device)
    _check(vals, cols, x, out)
    if vals.device.type == "cpu":
        return ell_spmv_plain(vals, cols, x, out=out)
    if vals.device.type != "cuda":
        raise ValueError(f"ell_spmv: unsupported device {vals.device}")
    m, w = vals.shape
    err = kernel_lib.lib().tz_ell_spmv(
        vals.data_ptr(), cols.data_ptr(), x.data_ptr(), out.data_ptr(), m, w,
        x.shape[0], torch.cuda.current_stream(vals.device).cuda_stream)
    kernel_lib.check_launch("ell_spmv", err)
    LAUNCHES.hit("ell_spmv")
    return out


def ell_floor(m: int, device) -> None:
    """An empty launch of the kernel's grid at m rows on the current stream:
    the floor under its time (not a launch of ``ell_spmv``; not counted)."""
    err = kernel_lib.lib().tz_ell_spmv_floor(
        m, torch.cuda.current_stream(device).cuda_stream)
    kernel_lib.check_launch("ell_spmv floor", err)
