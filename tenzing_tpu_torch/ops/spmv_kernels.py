"""The ELL-slab SpMV kernel: ``ell_spmv``.

Counterpart of ``tenzing_tpu/ops/spmv_pallas.py``'s ``ell_spmv_pallas``::

    y[i] = sum_j vals[i, j] * x[cols[i, j]]

for vals (m, w) float32, cols (m, w) int32 and x (n) float32 with
n <= ``MAX_X``.  On Hopper it is hand-written CUDA (csrc/ell_spmv.cu): x is
staged whole into shared memory once per block and each row is summed by a
group of threads over its w columns.  The gate ``supports`` is the
reference's (4096 = 32 vregs of 128 lanes), so the SpMV menu offers the slot
for the same x lengths in both packages.

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
LAUNCHES = {"ell_spmv": 0}

LANES = 128
# n/128 vregs above which the reference's masked-gather sweep loses to the
# gather path; it offers the kernel only up to here (spmv_pallas.py:43-50)
MAX_X_BLOCKS = 32
MAX_X = LANES * MAX_X_BLOCKS  # 4096 float32: 16 KB of shared memory

# y against the plain version: both sum w float32 products per row, in
# different orders, so they agree to a few ulps of the row sum, not bitwise.
# A control that drops one slab column moves y by a whole product (PERF.md).
ELL_TOL = dict(rtol=1e-5, atol=1e-6)


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
    LAUNCHES["ell_spmv"] += 1
    return out
