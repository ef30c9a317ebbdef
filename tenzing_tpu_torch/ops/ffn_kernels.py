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

On Hopper the float32 MLP is hand-written CUDA on the tensor cores,
split-TF32 on ``wgmma`` (csrc/ffn_tile.cuh, behind both csrc/ffn_expert.cu
and csrc/ffn_rows.cu): every operand is split into TF32 hi and lo parts and
each product is hi hi + hi lo + lo hi, float32 accuracy at three TF32
passes.  One call is two launches of one GEMM body: the first writes
h = gelu_tanh(x @ W1) into a float32 workspace (``work``, (E, C, dff) or
(n, dff); allocated when the caller passes none), the second computes
h @ W2.  Ragged C / n and d_ff (a multiple of 4) are masked in the kernel,
with no padding copy; where the tiles do not fill the card the depth is
split over a thread block cluster whose CTAs sum their partials over
distributed shared memory in a fixed order, so two launches agree bit for
bit.  :func:`ffn_launch_plan` mirrors the launches' tiling.  The kernels
are instantiated for d = 512 (the reference's ``MoEPipeArgs`` and the MoE
layer's slice configuration).  ``ffn_batched`` takes float32 only: the
pipe converts a bf16-staged chain to float32 before the MLP, as the
reference does.  ``ffn_rows`` also takes bf16 x, W1, W2 and out, as the
reference's kernel computes a bf16 x: both products accumulate in float32,
h is rounded to bf16 between them and y is written in bf16
(csrc/ffn_rows.cu ``tz_ffn_rows_bf16``: bf16 ``wgmma`` with both operands
brought into shared memory by TMA, W1 and W2 read as they stand through
the transpose bit, two launches through a bf16 workspace h (n, dff);
:func:`bf16_launch_plan` mirrors its tiling).

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
LAUNCHES = kernel_lib.LaunchCounts("ffn", {
    "ffn_batched": 0, "ffn_rows": 0, "ffn_rows_bf16": 0})

# d_model values the CUDA kernels are instantiated for (csrc/ffn_tile.cuh)
KERNEL_D_MODELS = (512,)

# y against the plain version: both sum in float32 over d and then d_ff
# terms, in different orders (the kernel's products as three TF32 passes).
# On an H100 at full width (8 x 304 slots, d=512, d_ff=2048) the two differ
# by at most 9.7e-6 with |y| up to 3.4, while the erf gelu in place of the
# tanh form moves y by 4.8e-4 to 7.4e-4 and one TF32 pass per product by
# 1.4e-3 (PERF.md): this rejects both and sits 10x above the kernel's error.
FFN_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 y against the plain version on the same bf16 inputs.  Both round h to
# bf16 (8 significant bits: a half ulp is 2^-9 of the value) after f32 sums
# taken in different orders, so an h near a rounding boundary can round the
# other way, and y is rounded to bf16 once more.  The limit is two bf16
# ulps of |y| (2^-7 relative) plus an absolute floor for y near 0 of two
# ulps at the typical |y| of 1 (2^-7); the erf gelu (which moves y by about
# 5e-4) is not a bf16-visible control, so the bf16 checks drop an expert's
# weights or rows instead.
FFN_BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
# Y of the MoE pipeline against the float64 routed result (what the
# integrity gate holds a driver run to, bench/gate.py, and chip_smoke.py
# each fixed order).  f32 staging: within 8.2e-6 of float64 at full width on
# an H100 (PERF.md).  bf16 staging rounds the dispatched tokens and the
# expert outputs: there Y read a relative rms error of 2.4e-3 and a largest
# error of 1.2e-2 (PERF.md); the limits sit at about 2x and 2.5x those, and
# a control with one expert's gate weights dropped (rel rms ~0.38) must fail
# them.  FFN_BF16_TOL above holds one expert MLP against its plain version
# on the same bf16 inputs, not a bf16 pipeline against float64.
F32_Y_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_Y_TOL = {"rel_rms": 5e-3, "max_abs": 3e-2}


# the f32 body's launch constants (csrc/ffn_tile.cuh; the library reports
# them through tz_ffn_f32_config, in this order)
F32_ROWS = 128        # output rows per CTA: two consumer warpgroups of 64
F32_COLS = 128        # output columns per CTA (the wgmma's N)
F32_DEPTH = 32        # K per ring stage
F32_STAGES = 2        # split stages (TF32 hi and lo planes of A and B^T)
F32_RAW_STAGES = 3    # raw f32 stages the TMA fills ahead of the split
F32_THREADS = 512     # two consumer warpgroups and two producer warpgroups
F32_MAX_SPLITS = 4    # CTAs of a split-K cluster
# the 1024-byte alignment slack, the split stages (A and B^T chunks, hi and
# lo), the raw stages (A and B chunks) and the ring's barriers
F32_SMEM_BYTES = (1024 + F32_STAGES * 2 * (F32_ROWS + F32_COLS) * F32_DEPTH * 4
                  + F32_RAW_STAGES * (F32_ROWS + F32_COLS) * F32_DEPTH * 4 + 64)
F32_CONFIG_KEYS = ("rows", "cols", "depth", "stages", "raw_stages", "threads",
                   "smem_bytes", "max_splits")
H100_SMS = 132


# the bf16 body's launch constants (csrc/ffn_rows.cu; the library reports
# them through tz_ffn_bf16_config, in this order)
BF16_ROWS = 128       # output rows per CTA: two consumer warpgroups of 64
BF16_COLS = (256, 128)  # columns per CTA of the first (x @ W1) and second launch
BF16_TILE_COLS = (64, 128, 256)  # the widths the library is instantiated for
BF16_DEPTH = 64       # K per ring stage (one 128-byte row of A)
BF16_STAGES = 4
BF16_THREADS = 384    # two consumer warpgroups and one producer warpgroup
BF16_CONFIG_KEYS = ("rows", "cols1", "cols2", "depth", "stages", "threads",
                    "smem_bytes1", "smem_bytes2", "max_splits")


def bf16_smem_bytes(cols: int) -> int:
    """Dynamic shared memory of a bf16 CTA of 128 x ``cols``: the 1024-byte
    alignment slack, the ring's stages (A's 128 x 64 chunk and B's 64 x
    ``cols``, bf16) and its barriers."""
    return 1024 + BF16_STAGES * 2 * BF16_DEPTH * (BF16_ROWS + cols) + 64


def split_k(tiles: int, chunks: int, sms: int = H100_SMS) -> int:
    """The depth split of one launch (csrc/ffn_tile.cuh ``split_k``): 1
    unless the tiles leave more than half the SMs idle (2 tiles <= sms);
    then the count in {1, 2, 4} with the fewest full-depth waves
    ceil(tiles s / sms) / s (one CTA per SM), the smallest on a tie, at
    least 4 chunks a split."""
    if 2 * tiles > sms:
        return 1
    best, best_waves = 1, -(-tiles // sms)
    s = 2
    while s <= F32_MAX_SPLITS and chunks >= 4 * s:
        waves = -(-tiles * s // sms)
        if waves * best < best_waves * s:
            best, best_waves = s, waves
        s *= 2
    return best


def gemm_plan(experts: int, m: int, n: int, k: int, sms: int = H100_SMS,
              rows: int = F32_ROWS, cols: int = F32_COLS,
              depth: int = F32_DEPTH) -> dict:
    """The tiling of one launch for ``experts`` problems C[M x N] = A[M x K]
    @ B[K x N] in tiles of ``rows`` x ``cols`` and chunks ``depth`` deep
    (csrc/ffn_tile.cuh ``plan``; the f32 body's by default, reported by the
    library's ``tz_ffn_f32_plan``, the bf16 body's by ``tz_ffn_bf16_plan``)."""
    m_tiles, n_tiles = -(-m // rows), -(-n // cols)
    chunks = -(-k // depth)
    tiles = experts * m_tiles * n_tiles
    splits = split_k(tiles, chunks, sms)
    return {"m_tiles": m_tiles, "n_tiles": n_tiles, "splits": splits,
            "chunks_per_split": -(-chunks // splits),
            "ctas": tiles * splits}


def ffn_launch_plan(e: int, c: int, dff: int, d: int = 512,
                    sms: int = H100_SMS) -> dict:
    """Both launches of one f32 call (``ffn_batched`` at (e, c, dff),
    ``ffn_rows`` at (1, n, dff)): h = gelu(x @ W1), then y = h @ W2; the
    threads and shared memory of every CTA, the cluster of each launch
    (its splits) and the workspace h's bytes."""
    return {"threads": F32_THREADS, "smem_bytes": F32_SMEM_BYTES,
            "launches": [gemm_plan(e, c, dff, d, sms),
                         gemm_plan(e, c, d, dff, sms)],
            "work_bytes": 4 * e * c * dff}


def bf16_launch_plan(n: int, dff: int, d: int = 512, sms: int = H100_SMS,
                     cols: tuple = BF16_COLS) -> dict:
    """Both launches of one bf16 ``ffn_rows`` call at (n, dff): h = gelu(x @
    W1) in tiles of 128 x ``cols[0]``, then y = h @ W2 in tiles of 128 x
    ``cols[1]``; each launch's tiling, columns and shared memory, the
    threads of every CTA and the bf16 workspace h's bytes."""
    launches = []
    for (m, nn, k), c in zip(((n, dff, d), (n, d, dff)), cols):
        lp = gemm_plan(1, m, nn, k, sms, BF16_ROWS, c, BF16_DEPTH)
        lp.update(cols=c, smem_bytes=bf16_smem_bytes(c))
        launches.append(lp)
    return {"threads": BF16_THREADS, "launches": launches,
            "work_bytes": 2 * n * dff}


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


def _check_work(work, shape, x, who: str) -> None:
    """Raise unless ``work`` can be the kernels' h workspace: contiguous, of
    ``shape``, on x's device and of x's dtype (float32 h for the f32 body,
    bf16 h for the bf16 one)."""
    if work.dtype != x.dtype or tuple(work.shape) != tuple(shape) \
            or work.device != x.device or not work.is_contiguous():
        raise ValueError(f"{who}: work must be a contiguous {x.dtype} "
                         f"{tuple(shape)} tensor on {x.device} (got "
                         f"{work.dtype} {tuple(work.shape)} on {work.device})")


def ffn_batched(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                out: Optional[torch.Tensor] = None,
                work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[e] = gelu_tanh(x[e] @ w1[e]) @ w2[e]`` on the current stream:
    the ``tz_ffn_batched`` kernel for CUDA tensors, :func:`ffn_batched_plain`
    for CPU tensors.  Writes into ``out`` (allocated when None) and returns
    it; ``out`` must not overlap x.  ``work`` is the kernel's h, a float32
    (E, C, dff) workspace overlapping none of the others (checked when
    given; allocated when None on the card; the CPU path does not use it)."""
    if out is None:
        out = torch.empty_like(x)
    _check(x, w1, w2, out)
    if work is not None:
        _check_work(work, (x.shape[0], x.shape[1], w1.shape[2]), x,
                    "ffn_batched")
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
    if work is None:
        work = torch.empty(e, c, dff, dtype=torch.float32, device=x.device)
    if any(t.data_ptr() % 16 for t in (x, w1, w2, out, work)):
        raise ValueError("ffn_batched: pointers must be 16-byte aligned")
    err = kernel_lib.lib().tz_ffn_batched(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(),
        work.data_ptr(), e, c, d, dff,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernel_lib.check_launch("ffn_batched", err)
    LAUNCHES.hit("ffn_batched")
    return out


# -- ffn_rows: one token matrix (the MoE layer's .pallas slot) ---------------


def ffn_rows_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   approximate: str = "tanh") -> torch.Tensor:
    """The plain PyTorch version of :func:`ffn_rows`: two matmuls around the
    tanh gelu (returns a new tensor).  For bf16 inputs, as the reference's
    kernel: the products in float32, h rounded to bf16 between them, y
    rounded to bf16.  ``approximate="none"`` (the erf gelu) is a
    deliberately wrong control for the tests and the chip smoke."""
    if x.dtype == torch.bfloat16:
        h = torch.nn.functional.gelu(torch.matmul(x.float(), w1.float()),
                                     approximate=approximate)
        y = torch.matmul(h.to(torch.bfloat16).float(), w2.float())
        return y.to(torch.bfloat16)
    h = torch.nn.functional.gelu(torch.matmul(x, w1), approximate=approximate)
    return torch.matmul(h, w2)


def _check_rows(x, w1, w2, out) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ffn_rows: x must be float32 or bfloat16 (got "
                        f"{x.dtype})")
    ts = {"x": x, "w1": w1, "w2": w2, "out": out}
    for key, t in ts.items():
        if t.dtype != x.dtype:
            raise TypeError(f"ffn_rows: {key} must be {x.dtype} like x (got "
                            f"{t.dtype})")
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
             out: Optional[torch.Tensor] = None,
             work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = gelu_tanh(x @ w1) @ w2`` on the current stream, in float32 or
    bf16 (all four tensors of one dtype): the ``tz_ffn_rows`` /
    ``tz_ffn_rows_bf16`` kernel for CUDA tensors, :func:`ffn_rows_plain` for
    CPU tensors.  Writes into ``out`` (allocated when None) and returns it;
    ``out`` must not overlap x.  ``work`` is the kernel's h, an (n, dff)
    workspace of x's dtype overlapping none of the others (checked when
    given; allocated when None on the card; the CPU path does not use it).
    Both dtypes count as launches of ``ffn_rows``; bf16 ones also as
    ``ffn_rows_bf16``."""
    if out is None:
        out = torch.empty_like(x)
    _check_rows(x, w1, w2, out)
    if work is not None:
        _check_work(work, (x.shape[0], w1.shape[1]), x, "ffn_rows")
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
    bf16 = x.dtype == torch.bfloat16
    per16 = 8 if bf16 else 4
    if dff % per16:
        raise ValueError(f"ffn_rows: d_ff {dff} must be a multiple of "
                         f"{per16} (16-byte rows)")
    if work is None:
        work = torch.empty(n, dff, dtype=x.dtype, device=x.device)
    if any(t.data_ptr() % 16 for t in (x, w1, w2, out, work)):
        raise ValueError("ffn_rows: pointers must be 16-byte aligned")
    entry = (kernel_lib.lib().tz_ffn_rows_bf16 if bf16
             else kernel_lib.lib().tz_ffn_rows)
    err = entry(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(),
                work.data_ptr(), n, d, dff,
                torch.cuda.current_stream(x.device).cuda_stream)
    kernel_lib.check_launch("ffn_rows", err)
    LAUNCHES.hit("ffn_rows")
    if bf16:
        LAUNCHES.hit("ffn_rows_bf16")
    return out
