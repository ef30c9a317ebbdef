"""The gelu MLPs of the MoE models: ``ffn_batched`` and ``ffn_rows``.

``ffn_batched`` is the counterpart of ``tenzing_tpu/ops/ffn_pallas.py``'s
``ffn_pallas_batched`` (its body ``_ffn_batched_kernel``), the per-expert
MLP of the MoE pipeline::

    y[e] = gelu_tanh(x[e] @ W1[e]) @ W2[e]

for x (E, C, d), W1 (E, d, dff), W2 (E, dff, d), accumulated in float32.
``ffn_rows`` is the counterpart of ``ffn_pallas`` (its body ``_ffn_kernel``),
the ``.pallas`` expert slot of the expert-parallel MoE layer
(models/moe.py): the same MLP over one token matrix x (n, d) of any n.  The
gelu is the tanh form, ``jax.nn.gelu``'s default (``approximate="tanh"`` in
PyTorch).

On Hopper it is hand-written CUDA (csrc/ffn_expert.cu): the hidden-tile loop
runs inside the thread block with the output sum in registers, each gelu tile
lives in shared memory only, and the hidden dimension is split over a thread
block cluster whose blocks sum their partials over distributed shared memory,
so 8 experts of 304 slots still fill the card.  ``ffn_rows``
(csrc/ffn_rows.cu) runs the same tile body (csrc/ffn_tile.cuh) over row
tiles of one matrix, masking a ragged n in the kernel.  The kernels are
instantiated for d = 512 (the reference's ``MoEPipeArgs`` and the MoE
layer's slice configuration) and take float32 only: the pipe converts a
bf16-staged chain to float32 before the MLP, as the reference does, and a
bf16 x for ``ffn_rows`` (the reference casts h to x's dtype between the
products) raises ``TypeError`` (ROADMAP Queue 2).

Each wrapper launches its kernel for CUDA tensors and runs its plain version
(:func:`ffn_batched_plain`, :func:`ffn_rows_plain`) for CPU tensors; there
is no other path.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from tenzing_tpu_torch.ops import kernel_lib

# kernel launches (CUDA path only; the plain version and CPU tensors do not
# count)
LAUNCHES = {"ffn_batched": 0, "ffn_rows": 0}

# d_model values the CUDA kernels are instantiated for (csrc/ffn_tile.cuh)
KERNEL_D_MODELS = (512,)

# y against the plain version: both sum in float32 over d and then d_ff
# terms, in different orders.  On an H100 at full width (8 x 304 slots,
# d=512, d_ff=2048) the two differ by at most 8e-6 with |y| up to 3.4, and
# the erf gelu in place of the tanh form moves y by 4.8e-4 to 7.4e-4
# (PERF.md): this rejects it and sits 12x above the kernel's error.
FFN_TOL = dict(rtol=1e-4, atol=1e-4)


def ffn_batched_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                      approximate: str = "tanh") -> torch.Tensor:
    """The plain PyTorch version: two einsums around the tanh gelu (returns
    a new tensor).  ``approximate="none"`` (the erf gelu) is a deliberately
    wrong control for the tests and the chip smoke."""
    h = torch.einsum("ecd,edf->ecf", x, w1)
    h = torch.nn.functional.gelu(h, approximate=approximate)
    return torch.einsum("ecf,efd->ecd", h, w2)


def ffn_flops(e: int, c: int, d: int, dff: int) -> float:
    """Operations of one call: two products of 2*E*C*d*dff each."""
    return 4.0 * e * c * d * dff


def ffn_bytes(e: int, c: int, d: int, dff: int, itemsize: int = 4) -> float:
    """Bytes one call must move: x, W1 and W2 read once, y written once."""
    return float(itemsize) * (2 * e * c * d + 2 * e * d * dff)


def _check(x, w1, w2, out) -> None:
    ts = {"x": x, "w1": w1, "w2": w2, "out": out}
    for key, t in ts.items():
        if t.dtype != torch.float32:
            raise TypeError(f"ffn_batched: {key} must be float32 (got {t.dtype})")
        if t.device != x.device:
            raise ValueError(f"ffn_batched: {key} on {t.device}, x on {x.device}")
        if t.dim() != 3:
            raise ValueError(f"ffn_batched: {key} must be 3D")
        if not t.is_contiguous():
            raise ValueError(f"ffn_batched: {key} must be contiguous")
    e, c, d = x.shape
    dff = w1.shape[2]
    if w1.shape != (e, d, dff) or w2.shape != (e, dff, d):
        raise ValueError(f"ffn_batched: w1 {tuple(w1.shape)} / w2 "
                         f"{tuple(w2.shape)} do not match x {tuple(x.shape)}")
    if out.shape != x.shape:
        raise ValueError(f"ffn_batched: out {tuple(out.shape)} must be x's "
                         f"shape {tuple(x.shape)}")
    if c < 1 or dff < 1:
        raise ValueError(f"ffn_batched: empty call (C={c}, dff={dff})")


def ffn_batched(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[e] = gelu_tanh(x[e] @ w1[e]) @ w2[e]`` on the current stream:
    the ``tz_ffn_batched`` kernel for CUDA tensors, :func:`ffn_batched_plain`
    for CPU tensors.  Writes into ``out`` (allocated when None) and returns
    it; ``out`` must not overlap x."""
    if out is None:
        out = torch.empty_like(x)
    _check(x, w1, w2, out)
    if x.device.type == "cpu":
        out.copy_(ffn_batched_plain(x, w1, w2))
        return out
    if x.device.type != "cuda":
        raise ValueError(f"ffn_batched: unsupported device {x.device}")
    e, c, d = x.shape
    dff = w1.shape[2]
    if d not in KERNEL_D_MODELS:
        raise ValueError(f"ffn_batched: d_model {d} has no kernel "
                         f"instantiation (have {KERNEL_D_MODELS})")
    if dff % 4:
        raise ValueError(f"ffn_batched: d_ff {dff} must be a multiple of 4 "
                         "(16-byte rows)")
    if any(t.data_ptr() % 16 for t in (x, w1, w2, out)):
        raise ValueError("ffn_batched: pointers must be 16-byte aligned")
    err = kernel_lib.lib().tz_ffn_batched(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), e, c, d,
        dff, torch.cuda.current_stream(x.device).cuda_stream)
    kernel_lib.check_launch("ffn_batched", err)
    LAUNCHES["ffn_batched"] += 1
    return out


# -- ffn_rows: one token matrix (the MoE layer's .pallas slot) ---------------


def ffn_rows_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   approximate: str = "tanh") -> torch.Tensor:
    """The plain PyTorch version of :func:`ffn_rows`: two matmuls around the
    tanh gelu (returns a new tensor).  ``approximate="none"`` (the erf gelu)
    is a deliberately wrong control for the tests and the chip smoke."""
    h = torch.nn.functional.gelu(torch.matmul(x, w1), approximate=approximate)
    return torch.matmul(h, w2)


def _check_rows(x, w1, w2, out) -> None:
    if x.dtype == torch.bfloat16:
        raise TypeError("ffn_rows: a bfloat16 x is not ported yet (the "
                        "reference casts h to x's dtype; ROADMAP Queue 2)")
    ts = {"x": x, "w1": w1, "w2": w2, "out": out}
    for key, t in ts.items():
        if t.dtype != torch.float32:
            raise TypeError(f"ffn_rows: {key} must be float32 (got {t.dtype})")
        if t.device != x.device:
            raise ValueError(f"ffn_rows: {key} on {t.device}, x on {x.device}")
        if t.dim() != 2:
            raise ValueError(f"ffn_rows: {key} must be 2D")
        if not t.is_contiguous():
            raise ValueError(f"ffn_rows: {key} must be contiguous")
    n, d = x.shape
    dff = w1.shape[1]
    if w1.shape != (d, dff) or w2.shape != (dff, d):
        raise ValueError(f"ffn_rows: w1 {tuple(w1.shape)} / w2 "
                         f"{tuple(w2.shape)} do not match x {tuple(x.shape)}")
    if out.shape != x.shape:
        raise ValueError(f"ffn_rows: out {tuple(out.shape)} must be x's "
                         f"shape {tuple(x.shape)}")
    if n < 1 or dff < 1:
        raise ValueError(f"ffn_rows: empty call (n={n}, dff={dff})")


def ffn_rows(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = gelu_tanh(x @ w1) @ w2`` on the current stream: the
    ``tz_ffn_rows`` kernel for CUDA tensors, :func:`ffn_rows_plain` for CPU
    tensors.  Writes into ``out`` (allocated when None) and returns it;
    ``out`` must not overlap x."""
    if out is None:
        out = torch.empty_like(x)
    _check_rows(x, w1, w2, out)
    if x.device.type == "cpu":
        out.copy_(ffn_rows_plain(x, w1, w2))
        return out
    if x.device.type != "cuda":
        raise ValueError(f"ffn_rows: unsupported device {x.device}")
    n, d = x.shape
    dff = w1.shape[1]
    if d not in KERNEL_D_MODELS:
        raise ValueError(f"ffn_rows: d_model {d} has no kernel "
                         f"instantiation (have {KERNEL_D_MODELS})")
    if dff % 4:
        raise ValueError(f"ffn_rows: d_ff {dff} must be a multiple of 4 "
                         "(16-byte rows)")
    if any(t.data_ptr() % 16 for t in (x, w1, w2, out)):
        raise ValueError("ffn_rows: pointers must be 16-byte aligned")
    err = kernel_lib.lib().tz_ffn_rows(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), n, d, dff,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernel_lib.check_launch("ffn_rows", err)
    LAUNCHES["ffn_rows"] += 1
    return out
