"""Online-softmax attention folds: the per-block and the fused kernel.

Counterpart of ``tenzing_tpu/ops/attention_pallas.py``.  Both TPU kernels
compute the same fold of K/V keys into the running (acc, m, l) state
(attention_pallas.py:39-62)::

    s     = q k^T * scale              (f32 accumulation)
    m'    = max(m, rowmax(s))
    alpha = exp(m - m')
    p     = exp(s - m')
    l'    = l * alpha + rowsum(p)
    acc'  = acc * alpha + p v          (p rounded to v's type first)

``attn_block_pallas`` folds one K/V block per call; ``attn_fused_pallas``
folds the whole resident K/V with the state held in VMEM across the kv grid
axis.  On Hopper both are hand-written CUDA (csrc/attn_fold.cu) whose kv loop
runs inside the thread block with the state in registers, each a
warp-specialized kernel that streams K/V tiles through a shared-memory ring
into ``wgmma``: for f32 inputs split-TF32 (every operand split into a TF32
hi and lo, three products per product), the producer warpgroup splitting
the K/V rows it loads (launch constants in :func:`f32_launch_plan`); for
bf16 inputs a TMA-filled ring (:func:`bf16_launch_plan`).  The two C entry
points differ only in how many keys one launch folds.

Differences from the reference, on purpose:

* **In place.**  The reference returns new (acc, m, l) arrays; the port
  updates ``acc``, ``m`` and ``l`` in place (no op allocates while a
  schedule runs).
* **bf16 inputs are a flag.**  The reference casts q/k/v to bfloat16 before
  the call; the port passes the float32 tensors with ``bf16_inputs=True``.
  The wrapper casts K and V once per call into one contiguous bfloat16
  tensor (:func:`cast_kv_bf16`: the caller's ``kv_scratch``, which the
  schedule's ops declare, or one the wrapper allocates), which the kernel's
  TMA loads read; Q stays float32 and the
  kernel rounds it as each CTA loads its rows once (so a chain of block folds
  never casts all of Q per block).  p is rounded before the second product.

m and l are carried broadcast along d, as in the reference: the kernel reads
column 0 and writes the value to every column.

``attn_block`` / ``attn_fused`` launch the kernel for CUDA tensors and run
:func:`attn_block_plain` / :func:`attn_fused_plain` for CPU tensors; there is
no other path.  Each keeps a launch count in ``LAUNCHES``, one key per
kernel: ``attn_block`` / ``attn_fused`` for f32 inputs (``attn_fold_f32``),
``attn_block_bf16`` / ``attn_fused_bf16`` for bf16 inputs
(``attn_fold_bf16``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tenzing_tpu_torch.ops import kernel_lib

# kernel launches (CUDA path only; plain versions and CPU tensors do not count)
LAUNCHES = kernel_lib.LaunchCounts("attention", {
    "attn_block": 0, "attn_fused": 0, "attn_block_bf16": 0,
    "attn_fused_bf16": 0})

# head dims the CUDA kernel is instantiated for (csrc/attn_fold.cu)
KERNEL_HEAD_DIMS = (128,)


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (nearest even) and back to float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def fold_scratch(b: int, n: int, nkv: int, d: int,
                 tag: str = "") -> Dict[str, tuple]:
    """The work buffers :func:`fold_into` needs for a fold of ``nkv`` keys
    into a (b, n, d) state: name -> (shape, dtype name).  ``tag`` suffixes
    the names, so folds of another key count declare their own set."""
    return {"attn_s" + tag: ((b, n, nkv), "float32"),
            "attn_row" + tag: ((b, n, 1), "float32"),
            "attn_mnew" + tag: ((b, n, d), "float32")}


def fold_into(q, k, v, acc, m, l, scale: float, s, row, mnew,
              bf16_p: bool = False) -> None:
    """One fold of the keys ``k``/``v`` into (acc, m, l), in place, with the
    reference's arithmetic and order (ring_attention.py:79-94), writing only
    into the given work buffers: ``s`` (b, n, nkv), ``row`` (b, n, 1) and
    ``mnew`` (b, n, d).  ``bf16_p`` rounds p to bfloat16 before p v."""
    torch.bmm(q, k.transpose(1, 2), out=s)
    s.mul_(scale)
    torch.amax(s, dim=2, keepdim=True, out=row)
    torch.maximum(m, row.expand_as(m), out=mnew)  # m'
    m.sub_(mnew).exp_()  # m now holds alpha = exp(m - m')
    s.sub_(mnew[..., :1]).exp_()  # s now holds p
    torch.sum(s, dim=2, keepdim=True, out=row)
    l.mul_(m).add_(row)
    acc.mul_(m)
    if bf16_p:
        s.copy_(_round_bf16(s))
    acc.baddbmm_(s, v)
    m.copy_(mnew)


def attn_block_plain(q, k, v, acc, m, l, scale: float,
                     bf16_inputs: bool = False) -> None:
    """The plain PyTorch version of :func:`attn_block`: fold the keys of
    ``k``/``v`` (b, nkv, d) into (acc, m, l) (b, n, d), in place.  With
    ``bf16_inputs`` q/k/v and p are rounded to bfloat16 as the reference's
    bf16 kernel sees them.  Allocates its work buffers."""
    b, n, d = q.shape
    nkv = k.shape[1]
    if bf16_inputs:
        q, k, v = _round_bf16(q), _round_bf16(k), _round_bf16(v)
    work = {name: torch.empty(shape, dtype=getattr(torch, dt), device=q.device)
            for name, (shape, dt) in fold_scratch(b, n, nkv, d).items()}
    fold_into(q, k, v, acc, m, l, scale, work["attn_s"], work["attn_row"],
              work["attn_mnew"], bf16_p=bf16_inputs)


def attn_fused_plain(q, k, v, acc, m, l, scale: float, bkv: int = 1024,
                     bf16_inputs: bool = False) -> None:
    """The plain PyTorch version of :func:`attn_fused`: the reference's fused
    kernel folds ``bkv`` keys per kv grid step, so this is
    :func:`attn_block_plain` over consecutive ``bkv``-key blocks."""
    nkv = k.shape[1]
    bkv = min(bkv, nkv)
    for j in range(0, nkv, bkv):
        attn_block_plain(q, k[:, j:j + bkv], v[:, j:j + bkv], acc, m, l,
                         scale, bf16_inputs)


# -- the kernels' launches -------------------------------------------------------

# launch constants of attn_fold_f32 (csrc/attn_fold_f32.cuh, namespace
# tz_attn_f32), which the fused_region kernel's attention instantiation runs
# too; chip_smoke.py holds them against the library's tz_attn_f32_config
F32_ROWS = 128  # query rows per CTA: two consumer warpgroups of 64
F32_KEY_TILE = 32  # keys per K / V tile
F32_K_STAGES = 3
F32_V_STAGES = 2
F32_THREADS = 384  # two consumer warpgroups + the producer warpgroup


def f32_launch_plan(b: int, n: int, nkv: int, d: int) -> dict:
    """The launch of ``attn_fold_f32`` for a fold of ``nkv`` keys into a
    (b, n, d) state: grid, threads, tile sizes, ring stages and dynamic
    shared memory (bytes).  The ring's stages hold a tile's TF32 hi and lo
    (K as keys x d, V transposed); each consumer warpgroup keeps its 64
    rows' q_lo in shared memory (q_hi lives in registers)."""
    stage = 2 * F32_KEY_TILE * d * 4  # hi + lo, 32-bit
    q_lo = F32_ROWS * d * 4
    # 1024 bytes of alignment slack (the 128-byte swizzle's atom) and 128 of
    # mbarriers
    smem = 1024 + q_lo + (F32_K_STAGES + F32_V_STAGES) * stage + 128
    return {"grid": (-(-n // F32_ROWS), b), "threads": F32_THREADS,
            "rows_per_cta": F32_ROWS, "key_tile": F32_KEY_TILE,
            "k_stages": F32_K_STAGES, "v_stages": F32_V_STAGES,
            "smem_bytes": smem, "key_tiles": -(-nkv // F32_KEY_TILE)}


F32_SMEM_BYTES = f32_launch_plan(1, 1, 1, 128)["smem_bytes"]

# launch constants of attn_fold_bf16 (csrc/attn_fold.cu, namespace bf16k);
# chip_smoke.py holds them against the library's tz_attn_bf16_config
BF16_ROWS = 128  # query rows per CTA: two consumer warpgroups of 64
BF16_KEY_TILE = 128  # keys per K / V tile
BF16_K_STAGES = 4
BF16_V_STAGES = 2
BF16_THREADS = 384  # two consumer warpgroups + the producer warpgroup
GRID_Y_LIMIT = 65_535


def bf16_launch_plan(b: int, n: int, nkv: int, bkv: int, d: int) -> dict:
    """The launch of ``attn_fold_bf16`` for a fold of ``nkv`` keys in blocks
    of ``bkv`` (``nkv`` for ``tz_attn_block``) into a (b, n, d) state: grid,
    threads, tile sizes, ring stages and dynamic shared memory (bytes)."""
    tile_bytes = BF16_KEY_TILE * d * 2  # bf16
    # the ring, 1024 bytes of alignment slack (the 128-byte swizzle's atom)
    # and 128 of mbarriers; Q lives in registers
    smem = 1024 + (BF16_K_STAGES + BF16_V_STAGES) * tile_bytes + 128
    return {"grid": (-(-n // BF16_ROWS), b), "threads": BF16_THREADS,
            "rows_per_cta": BF16_ROWS, "key_tile": BF16_KEY_TILE,
            "k_stages": BF16_K_STAGES, "v_stages": BF16_V_STAGES,
            "smem_bytes": smem, "kv_blocks": -(-nkv // min(bkv, nkv))}


def kv_scratch_spec(b: int, nkv: int, d: int) -> tuple:
    """(shape, dtype name) of the bf16 K/V copy a bf16 fold of ``nkv`` keys
    casts into: what an op declares as scratch to pass as ``kv_scratch``."""
    return (2, b, nkv, d), "bfloat16"


def cast_kv_bf16(k: torch.Tensor, v: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k and v (b, nkv, d), float32, possibly strided views, rounded to
    bfloat16 (nearest even) into one contiguous (2, b, nkv, d) tensor:
    ``[0]`` is k, ``[1]`` is v.  The bf16 kernel's TMA loads read it.
    ``out`` (of :func:`kv_scratch_spec`'s shape and type) is written in
    place; without it a new tensor is allocated."""
    shape = (2,) + tuple(k.shape)
    if out is None:
        out = torch.empty(shape, dtype=torch.bfloat16, device=k.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.bfloat16
          or out.device != k.device or not out.is_contiguous()):
        raise ValueError(f"cast_kv_bf16: out must be contiguous bfloat16 "
                         f"{shape} on {k.device} (got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device})")
    out[0].copy_(k)
    out[1].copy_(v)
    return out


# -- kernel wrappers -----------------------------------------------------------


def _live_strides(t: torch.Tensor) -> tuple:
    """``t``'s strides, with those of size-1 dims (never stepped) as 0."""
    return tuple(st if sz > 1 else 0 for st, sz in zip(t.stride(), t.shape))


def _check(name: str, q, k, v, acc, m, l) -> None:
    """Validate one fold call: dtypes, devices, shapes and strides."""
    ts = {"q": q, "k": k, "v": v, "acc": acc, "m": m, "l": l}
    for key, t in ts.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32 (got {t.dtype}); "
                            "bf16 inputs are a flag (bf16_inputs=True)")
        if t.device != q.device:
            raise ValueError(f"{name}: {key} on {t.device}, q on {q.device}")
        if t.dim() != 3:
            raise ValueError(f"{name}: {key} must be 3D (b, rows, d)")
        if t.stride(2) != 1:
            raise ValueError(f"{name}: {key}'s last dim must be contiguous")
    b, n, d = q.shape
    nkv = k.shape[1]
    if k.shape != (b, nkv, d) or v.shape != (b, nkv, d):
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    for key in ("acc", "m", "l"):
        if ts[key].shape != q.shape:
            raise ValueError(f"{name}: {key} {tuple(ts[key].shape)} must be "
                             f"q's shape {tuple(q.shape)}")
    live = [_live_strides(t) for t in (acc, m, l)]
    if live[1] != live[0] or live[2] != live[0]:
        raise ValueError(f"{name}: acc, m and l must share strides")
    if n < 1 or nkv < 1:
        raise ValueError(f"{name}: empty fold (n={n}, nkv={nkv})")


def _launch(fn_name: str, q, k, v, acc, m, l, scale: float,
            bf16_inputs: bool, bkv=None, kv_scratch=None) -> None:
    """Launch ``fn_name``; ``bkv`` (tz_attn_fused only) is the kv block the
    bf16 kernel takes each block's row max over before it rounds p.  With
    bf16 inputs, K and V go to the kernel as :func:`cast_kv_bf16`'s copy,
    into ``kv_scratch`` when given."""
    b, n, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{fn_name}: head_dim {d} has no kernel instantiation "
                         f"(have {KERNEL_HEAD_DIMS})")
    if b > GRID_Y_LIMIT:
        raise ValueError(f"{fn_name}: batch {b} exceeds the grid's y limit")
    if bf16_inputs:
        if (any(t.data_ptr() % 8 for t in (acc, m, l)) or acc.stride(1) % 2
                or (b > 1 and acc.stride(0) % 2)):
            raise ValueError(f"{fn_name}: the bf16 kernel needs acc, m and l "
                             "8-byte aligned with even strides")
        kv = cast_kv_bf16(k, v, kv_scratch)
        k, v = kv[0], kv[1]
    fn = getattr(kernel_lib.lib(), fn_name)
    sizes = (b, n, k.shape[1]) + (() if bkv is None else (bkv,)) + (d,)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
             m.data_ptr(), l.data_ptr(), *sizes,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), acc.stride(0), acc.stride(1),
             float(scale), int(bool(bf16_inputs)),
             torch.cuda.current_stream(q.device).cuda_stream)
    kernel_lib.check_launch(fn_name, err)


def attn_block(q, k, v, acc, m, l, scale: float, bf16_inputs: bool = False,
               kv_scratch: Optional[torch.Tensor] = None) -> None:
    """Fold one K/V block (b, nkv, d) into the online-softmax state (acc, m,
    l) (b, n, d), in place, on the current stream: the ``tz_attn_block``
    kernel for CUDA tensors, :func:`attn_block_plain` for CPU tensors.  k and v
    may be strided views (batch and row strides; last dim contiguous); the
    f32 kernel needs every tensor 16-byte aligned and every stride a
    multiple of 4 (it moves K rows in 16-byte loads), and the launch raises
    otherwise.  With
    bf16 inputs the kernel reads a bf16 copy of k and v, cast into
    ``kv_scratch`` (:func:`kv_scratch_spec`) or, without it, into a tensor
    the wrapper allocates, and it needs acc, m and l 8-byte aligned with
    even strides (it moves the state in float2s)."""
    _check("attn_block", q, k, v, acc, m, l)
    if q.device.type == "cpu":
        attn_block_plain(q, k, v, acc, m, l, scale, bf16_inputs)
        return
    if q.device.type != "cuda":
        raise ValueError(f"attn_block: unsupported device {q.device}")
    _launch("tz_attn_block", q, k, v, acc, m, l, scale, bf16_inputs,
            kv_scratch=kv_scratch)
    LAUNCHES.hit("attn_block_bf16" if bf16_inputs else "attn_block")


def attn_fused(q, k, v, acc, m, l, scale: float, bkv: int = 1024,
               bf16_inputs: bool = False,
               kv_scratch: Optional[torch.Tensor] = None) -> None:
    """Fold the whole resident K/V (b, nkv, d) into (acc, m, l) in one launch,
    in place, on the current stream: the ``tz_attn_fused`` kernel for CUDA
    tensors, :func:`attn_fused_plain` for CPU tensors.  ``bkv`` is the
    reference's kv block and must divide nkv (its assert): with bf16 inputs p
    is rounded against the running max after each block, as the reference
    rounds it; the kernel's own key tile is internal.  ``kv_scratch`` as
    for :func:`attn_block`."""
    _check("attn_fused", q, k, v, acc, m, l)
    nkv = k.shape[1]
    bkv_eff = min(bkv, nkv)
    if bkv_eff < 1 or nkv % bkv_eff:
        raise ValueError(f"attn_fused: bkv={bkv} does not divide nkv={nkv}")
    if q.device.type == "cpu":
        attn_fused_plain(q, k, v, acc, m, l, scale, bkv, bf16_inputs)
        return
    if q.device.type != "cuda":
        raise ValueError(f"attn_fused: unsupported device {q.device}")
    _launch("tz_attn_fused", q, k, v, acc, m, l, scale, bf16_inputs, bkv_eff,
            kv_scratch)
    LAUNCHES.hit("attn_fused_bf16" if bf16_inputs else "attn_fused")


def attention_flops(b: int, n: int, nkv: int, d: int) -> float:
    """Operations of one fold of nkv keys into n queries: two products of
    2*b*n*nkv*d each (bench/roofline.py's 4*b*n^2*d for nkv = n)."""
    return 4.0 * b * n * nkv * d


def fold_bytes(b: int, n: int, nkv: int, d: int, itemsize: int = 4) -> float:
    """Bytes one fold must move: q, the k/v keys and acc read once, one value
    per row of m and l read (column 0 of the broadcast state), and acc, m and
    l written once (m and l broadcast along d, the reference's layout)."""
    return float(itemsize) * (5 * b * n * d + 2 * b * nkv * d + 2 * b * n)


# -- holding a state against another ------------------------------------------

# A state is held as m, l and acc / l (what O becomes), each within
# allclose's rtol / atol: acc is an unnormalized sum whose rounding scales
# with l (~10^2 to 10^3 at full width).  f32 inputs: the reference's own f32
# tolerance (tests/test_ring_attention.py:76).  bf16 inputs, a kernel against
# its plain version (both round q/k/v and p the same way): the two differ by
# f32 summation order, which flips a rare p across a bf16 rounding boundary,
# so the largest error is set by a few such flips while the error over all
# elements stays small.  ``rel_rms`` bounds acc / l's rms error relative to
# acc / l's own rms: a fault spread over every element (p left unrounded, V
# rounded the wrong way, nothing rounded) raises it far above the flips'
# level, while the largest-error limit catches a fault confined to a few
# rows or keys.  Chosen from full-width H100 readings of chip_smoke.py
# (PERF.md, PR 2): sound rel_rms <= 4.6e-5 and largest acc / l error
# <= 2.9e-4; the faulty controls' rel_rms >= 7.9e-4.  f32 inputs also bound
# rel_rms: the f32 kernel computes each product as three TF32 products, and
# a single TF32 pass (about three decimal digits) can stay inside the
# allclose limits while being a different result.  From full-width H100
# readings of chip_smoke.py and bench/attn_f32.py (PERF.md, §6): the
# split kernel 2.7e-6 to 3.1e-6 (its stress cases <= 4.0e-6), one TF32
# pass 2.6e-4 to 5.3e-4.
F32_STATE_TOL = {"acc/l": dict(rtol=2e-4, atol=2e-5),
                 "m": dict(rtol=2e-4, atol=2e-5),
                 "l": dict(rtol=2e-4, atol=2e-5), "rel_rms": 2e-5}
BF16_STATE_TOL = {"acc/l": dict(rtol=0.0, atol=1e-3),
                  "m": dict(rtol=2e-5, atol=2e-5),
                  "l": dict(rtol=2e-5, atol=0.0), "rel_rms": 2e-4}

# O against the dense float64 attention (what the integrity gate holds a
# driver run to, bench/gate.py, and chip_smoke.py each fixed order): f32
# inputs at the reference's f32 tolerance (tests/test_ring_attention.py:76);
# bf16 inputs at about twice the error that rounding q/k/v and p gives at
# full width on an H100 (PERF.md: largest 4.87e-4, relative rms 3.37e-3),
# held on both: the largest error catches a gross fault in a few elements,
# the relative rms one spread thin over all of them (a bias of 2e-4 in
# every element stays under the largest-error limit and fails this one;
# chip_smoke.py holds that control).  The rounding itself dominates there,
# so the faults the bf16 state tolerance catches do not show in this check.
# The state tolerances above hold a kernel against its plain version on the
# same rounded inputs and do not fit this comparison: bf16 rounding of q
# and k alone moves m by about 2^-9 of itself.
F32_O_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_O_TOL = {"rel_rms": 7e-3, "max_abs": 1e-3}


def state_check(got, want, tol) -> tuple:
    """Hold the state ``got`` = (acc, m, l) against ``want`` at ``tol`` (one of
    the ``*_STATE_TOL`` dicts).  Returns (ok, errors): per quantity the
    largest absolute error, for l also the largest relative one, for acc / l
    also the relative rms error."""
    (acc_g, m_g, l_g), (acc_w, m_w, l_w) = got, want
    pairs = {"acc/l": (acc_g / l_w, acc_w / l_w), "m": (m_g, m_w),
             "l": (l_g, l_w)}
    errs, ok = {}, True
    for name, (a, b) in pairs.items():
        diff = (a - b).abs()
        errs[name] = {"max_abs": float(diff.max())}
        ok = ok and bool(torch.allclose(a, b, **tol[name]))
    errs["l"]["max_rel"] = float(((l_g - l_w).abs() / l_w.abs()).max())
    o_g, o_w = pairs["acc/l"]
    errs["acc/l"]["rel_rms"] = float((o_g - o_w).square().mean().sqrt()
                                     / o_w.square().mean().sqrt())
    if tol["rel_rms"] is not None:
        ok = ok and errs["acc/l"]["rel_rms"] <= tol["rel_rms"]
    return ok, errs
