"""The f32 FFN body (csrc/ffn_tile.cuh: split-TF32 on ``wgmma``, two
launches of one GEMM body) on the card, behind ``tz_ffn_batched`` (row 14)
and ``tz_ffn_rows`` (row 13 f32).

``python -m tenzing_tpu_torch.bench.ffn_f32 [--sass] [--ablate] [--cycles]
[--parent DIR] [--rounds N]``

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernel library and prints what ``ptxas -v`` reported for
   ``ffn_expert_kernel`` and ``ffn_rows_kernel`` (registers, spills), and
   holds the launch constants and both launches' tiling of
   :func:`ops.ffn_kernels.ffn_launch_plan` against the library's
   ``tz_ffn_f32_config`` / ``tz_ffn_f32_plan`` at :data:`SHAPES`;
3. at row 14's shape (8 experts x 304 slots, d 512, d_ff 2048) and row 13
   f32's (n 2048): the kernel against the plain version at ``FFN_TOL``,
   two launches bit for bit, the erf-gelu control and a plain emulation
   with one TF32 pass per product (:func:`tf32_ffn_plain`, ``passes=1``)
   rejected, the three-pass emulation accepted;
4. times, after a 128 MB write flush (as chip_smoke.py's timer), at both
   shapes: the kernel, the three library calls (``bmm -> gelu(tanh) ->
   bmm``), the plain version and, with ``--parent DIR``, an older
   checkout's kernels (``git archive`` of the parent into a gitignored
   directory) in the same process, the versions in alternating rounds;
5. with ``--sass``, the HGMMA and spill instructions of both kernels'
   SASS (``cuobjdump -sass``; :func:`attn_common.spill_placement`);
6. with ``--ablate``, csrc/ffn_tile.cuh built again with one part changed
   (:data:`ABLATIONS`): one TF32 pass (no lo terms; held against the plain
   version and must fail), the chunks summed on the tensor cores into the
   tile's sum (no f32 adds), no tensor-core products (the ring and the
   producer alone), no TMA loads (the raw stages' arrivals alone), one raw
   stage instead of three (and with it three split stages instead of two),
   no split over a cluster, the split by the fewest waves at every tile
   count (no half-idle gate), the first launch not storing h, each launch
   alone, the TF32 split's hi and lo both through ``cvt.rna.tf32.f32`` or
   both on the integer units, with or without a select that keeps NaNs;
   each variant's ptxas report and its times at both shapes
   through ``tz_ffn_batched`` (row 13 as one expert: the same body and
   plan);
7. with ``--cycles``, the body built again with ``clock64`` counters
   (:data:`CYCLE_EDITS`) in the producers' and consumers' chunk loops:
   cycles a chunk in each phase (the producers: waiting for the TMA's
   bytes, reading the raw stage, their barrier, reaching and waiting for a
   free stage, splitting and storing, fence and arrival; the consumers:
   waiting for a full stage, the products), summed over every CTA of five
   calls at both shapes, beside the instrumented build's time.

One JSON object per line.  It needs a CUDA device; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

from tenzing_tpu_torch.bench import attn_common as common
from tenzing_tpu_torch.bench.attn_f32 import split_tf32
from tenzing_tpu_torch.utils.cli import write_line

KERNELS = ("ffn_expert_kernel", "ffn_rows_kernel")
# label -> (E, C, dff): rows 14 and 13 f32 of PERF.md's kernel table, and
# the ragged shapes the plan test covers
SHAPES = {"row14": (8, 304, 2048), "row13": (1, 2048, 2048),
          "ragged-c1": (8, 1, 2048), "ragged-c257": (8, 257, 2048),
          "ragged-dff520": (8, 304, 520), "rows-ragged": (1, 37, 520)}
MAIN = ("row14", "row13")

_LOOP_HI_LO = """#pragma unroll
  for (int kk = 0; kk < kDepth / 8; ++kk) mma<true>(t, desc(ahi, kk), desc(blo, kk));
#pragma unroll
  for (int kk = 0; kk < kDepth / 8; ++kk) mma<true>(t, desc(alo, kk), desc(bhi, kk));
"""
_CHUNK_CALL = ("      chunk_product(t, st + wg * (kAPlaneBytes / kConsumers), "
               "st + 2 * kAPlaneBytes);")
_ADD_T = """#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += t[i];
"""
_TMA_BOX = "// Chunk kc's raw A rows [row0, row0 + kRows) and B columns [col0, col0 +\n"
def _split_fn(tag: str, hi: str, lo: str) -> str:
    """A split4 variant, split4_<tag>: per element, h from v (its bits u),
    then l from r = v - h (its bits ur), each a C expression."""
    return f"""__device__ __forceinline__ void split4_{tag}(const float4& x, uint4& hi, uint4& lo) {{
  const float v4[4] = {{x.x, x.y, x.z, x.w}};
  uint32_t h4[4], l4[4];
  for (int i = 0; i < 4; ++i) {{
    const float v = v4[i];
    const uint32_t u = __float_as_uint(v);
    uint32_t h;
    {hi}
    const float r = __fsub_rn(v, __uint_as_float(h));
    const uint32_t ur = __float_as_uint(r);
    uint32_t l;
    {lo}
    h4[i] = h;
    l4[i] = l;
  }}
  hi = make_uint4(h4[0], h4[1], h4[2], h4[3]);
  lo = make_uint4(l4[0], l4[1], l4[2], l4[3]);
}}

"""


_CVT = 'asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"({0}) : "f"({1}));'
_INT = "{0} = ({1} + 0x1000u) & 0xFFFFE000u;"
_SEL = ("{0} = ({1} & 0x7F800000u) == 0x7F800000u ? {1} "
        ": ({1} + 0x1000u) & 0xFFFFE000u;")
# tag -> (h, l), against the kernel's integer hi and converted lo: both
# through the conversion instruction; both on the integer units, a NaN
# 0x7FFFFFFF carried into a zero in both (NaN-unsafe); both on the integer
# units with a select that passes infinities and NaNs
SPLITS = {"cvt": (_CVT.format("h", "v"), _CVT.format("l", "r")),
          "unsafe": (_INT.format("h", "u"), _INT.format("l", "ur")),
          "select": (_SEL.format("h", "u"), _SEL.format("l", "ur"))}


def _split_edits(tag: str) -> List[Tuple[str, str]]:
    return [(_TMA_BOX, _split_fn(tag, *SPLITS[tag]) + _TMA_BOX)] + [
        (f"        split4(*reinterpret_cast<const float4*>(&x[4 * {i}]), hi, lo);",
         f"        split4_{tag}(*reinterpret_cast<const float4*>(&x[4 * {i}]), hi, lo);")
        for i in ("i", "h")]


_STORE = "    store4(c + (int64_t)row * g.n + col, s);"

# --ablate: name -> [(text of csrc/ffn_tile.cuh, its replacement)]
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    "no-lo": [(_LOOP_HI_LO, "")],
    # every chunk's products summed on the tensor cores into the tile's sum
    "tc-accumulate": [("  mma<false>(t, desc(ahi, 0), desc(bhi, 0));",
                       "  mma<true>(t, desc(ahi, 0), desc(bhi, 0));"),
                      ("      float t[64];", "      float (&t)[64] = acc;"),
                      (_ADD_T, "")],
    "no-mma": [(_CHUNK_CALL, "      for (int i = 0; i < 64; ++i) "
                             "t[i] = __uint_as_float(st & 0xff) * i;")],
    # no TMA loads: the raw stages' arrivals alone (their contents stale)
    "no-loads": [("""  mbar_expect_tx(bar, kRawBytes);
  tma_box(raw, &g.a_map, bar, kc * kDepth, row0, e);
  tma_box(raw + kRawABytes, &g.b_map, bar, col0, kc * kDepth, e);
""", "  mbar_arrive(bar);\n")],
    "raw-stages-1": [("constexpr int kRawStages = 3;",
                      "constexpr int kRawStages = 1;")],
    # the split through the conversion instruction, cvt.rna.tf32.f32
    "cvt-split": _split_edits("cvt"),
    "unsafe-split": _split_edits("unsafe"),
    "select-split": _split_edits("select"),
    "stages-3-raw-1": [("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
                       ("constexpr int kRawStages = 3;",
                        "constexpr int kRawStages = 1;")],
    "no-split": [("  for (int s = 2; s <= kMaxSplits; s *= 2) {",
                  "  for (int s = 2; s <= 1; s *= 2) {")],
    # the split by the fewest waves at any tile count (4 ways at row 14)
    "split-by-waves": [("  if (2 * tiles > sms) return 1;\n", "")],
    "no-h-store": [(_STORE, "    if (!g.gelu || s.x == 12345.0f)\n" + _STORE)],
    "first-launch": [("  return (int)launch_gemm(kernel, g2, experts, stream);",
                      "  return 0;")],
    "second-launch": [("  err = (int)launch_gemm(kernel, g1, experts, stream);",
                       "  err = 0;")],
}
# --cycles: clock64 counters around each phase of the chunk loops, summed
# into g_cycles (producer role r at 8 r, consumer warpgroup w at 16 + 8 w;
# slot 7 counts chunks), read and cleared by tz_ffn_cycles
CYCLE_EDITS: List[Tuple[str, str]] = [
    ("namespace tz_ffn {\n",
     "namespace tz_ffn {\n__device__ unsigned long long g_cycles[32];\n"),
    ("  Ring r, rr;\n  for (int kc = kc0; kc < kc1; ++kc) {\n"
     "    mbar_wait(&raw_full[rr.stage], rr.phase);\n",
     "  Ring r, rr;\n  long long P[8] = {};\n  for (int kc = kc0; kc < kc1; ++kc) {\n"
     "    long long c0 = clock64();\n    mbar_wait(&raw_full[rr.stage], rr.phase);\n"
     "    long long c1 = clock64();\n"),
    ("    producer_sync();  // every producer thread has read the raw stage\n",
     "    long long c2 = clock64();\n    producer_sync();\n    long long c3 = clock64();\n"),
    ("    mbar_wait(&empty[r.stage], r.phase ^ 1u);\n    unsigned char* st = ring_base",
     "    long long c4 = clock64();\n    mbar_wait(&empty[r.stage], r.phase ^ 1u);\n"
     "    long long c5 = clock64();\n    unsigned char* st = ring_base"),
    ("    fence_proxy_async();\n    mbar_arrive(&full[r.stage]);\n"
     "    r.advance<kStages>();\n  }\n}\n",
     "    long long c6 = clock64();\n    fence_proxy_async();\n"
     "    mbar_arrive(&full[r.stage]);\n    long long c7 = clock64();\n"
     "    P[0] += c1 - c0; P[1] += c2 - c1; P[2] += c3 - c2; P[3] += c4 - c3;\n"
     "    P[4] += c5 - c4; P[5] += c6 - c5; P[6] += c7 - c6; P[7] += 1;\n"
     "    r.advance<kStages>();\n  }\n"
     "  if (pt == 0) for (int i = 0; i < 8; ++i)\n"
     "    atomicAdd(&g_cycles[role * 8 + i], (unsigned long long)P[i]);\n}\n"),
    ("  Ring r;\n  for (int kc = kc0; kc < kc1; ++kc) {\n"
     "    mbar_wait(&full[r.stage], r.phase);\n    if (active) {\n"
     "      const uint32_t st = ring_base + r.stage * kStageBytes;\n"
     "      float t[64];\n" + _CHUNK_CALL + "\n",
     "  Ring r;\n  long long Q[8] = {};\n  for (int kc = kc0; kc < kc1; ++kc) {\n"
     "    long long d0 = clock64();\n    mbar_wait(&full[r.stage], r.phase);\n"
     "    long long d1 = clock64();\n    Q[0] += d1 - d0;\n    Q[7] += 1;\n"
     "    if (active) {\n      const uint32_t st = ring_base + r.stage * kStageBytes;\n"
     "      float t[64];\n" + _CHUNK_CALL + "\n      Q[1] += clock64() - d1;\n"),
    ("    r.advance<kStages>();\n  }\n}\n\n// The tile's position",
     "    r.advance<kStages>();\n  }\n"
     "  if (lane == 0 && threadIdx.x % 128 == 0) for (int i = 0; i < 8; ++i)\n"
     "    atomicAdd(&g_cycles[16 + wg * 8 + i], (unsigned long long)Q[i]);\n}\n"
     "\n// The tile's position"),
]
CYCLES_ENTRY = """
extern "C" int tz_ffn_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tz_ffn::g_cycles,
                                         sizeof(unsigned long long) * 32);
  const unsigned long long zero[32] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(tz_ffn::g_cycles, zero, sizeof(zero));
  return (int)err;
}
"""
PRODUCER_PHASES = ("wait_raw", "read_raw", "barrier", "to_stage",
                   "wait_stage", "split_store", "fence_arrive")
CONSUMER_PHASES = ("wait_full", "products")


# the variants whose outputs are held against the plain version (and must
# fail FFN_TOL)
CHECKED_ABLATIONS = ("no-lo",)
# the variants that keep the result (held against it, must pass)
KEEPING_ABLATIONS = ("tc-accumulate", "no-split", "split-by-waves",
                     "raw-stages-1", "stages-3-raw-1", "cvt-split",
                     "unsafe-split", "select-split")


def tf32_ffn_plain(torch, x, w1, w2, passes: int = 3):
    """The kernel's arithmetic in plain PyTorch, batched (E, C, d) or one
    matrix (n, d): each product with its operands split into TF32 parts,
    ``passes`` = 3 (hi hi + hi lo + lo hi, what the kernel computes) or 1
    (hi hi alone: the single-TF32 control).  The split products are exact in
    float32 and summed in float32 (no TF32 in the matmuls themselves)."""
    def prod(a, b):
        ah, al = split_tf32(torch, a)
        bh, bl = split_tf32(torch, b)
        out = torch.matmul(ah, bh)
        if passes == 3:
            out += torch.matmul(ah, bl)
            out += torch.matmul(al, bh)
        return out

    h = torch.nn.functional.gelu(prod(x, w1), approximate="tanh")
    return prod(h, w2)


def inputs(torch, device, e: int, c: int, dff: int, d: int = 512, seed=0):
    """x standard normal, W1 and W2 scaled by 1/sqrt(fan-in) (h and y of
    order 1), from a seeded generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return (torch.randn(e, c, d, device=device, generator=gen),
            torch.randn(e, d, dff, device=device, generator=gen) / d ** 0.5,
            torch.randn(e, dff, d, device=device, generator=gen) / dff ** 0.5)


def library_plan(e: int, c: int, dff: int, d: int = 512) -> dict:
    """The library's constants and both launches' tiling at (e, c, dff),
    in :func:`ffn_launch_plan`'s form."""
    import torch

    from tenzing_tpu_torch.ops import ffn_kernels as fk
    from tenzing_tpu_torch.ops import kernel_lib

    lib = kernel_lib.lib()
    conf = (ctypes.c_int64 * len(fk.F32_CONFIG_KEYS))()
    lib.tz_ffn_f32_config(conf)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launches = []
    for m, n, k in ((c, dff, d), (c, d, dff)):
        out = (ctypes.c_int64 * 5)()
        lib.tz_ffn_f32_plan(e, m, n, k, sms, out)
        launches.append(dict(zip(("m_tiles", "n_tiles", "splits",
                                  "chunks_per_split", "ctas"), list(out))))
    return {"config": dict(zip(fk.F32_CONFIG_KEYS, list(conf))),
            "launches": launches, "sms": sms}


def plan_mismatch() -> dict:
    """Where the library and :func:`ffn_launch_plan` disagree, per shape."""
    from tenzing_tpu_torch.ops import ffn_kernels as fk

    want_conf = {"rows": fk.F32_ROWS, "cols": fk.F32_COLS,
                 "depth": fk.F32_DEPTH, "stages": fk.F32_STAGES,
                 "raw_stages": fk.F32_RAW_STAGES,
                 "threads": fk.F32_THREADS, "smem_bytes": fk.F32_SMEM_BYTES,
                 "max_splits": fk.F32_MAX_SPLITS}
    out = {}
    for label, (e, c, dff) in SHAPES.items():
        got = library_plan(e, c, dff)
        want = fk.ffn_launch_plan(e, c, dff, sms=got["sms"])
        bad = {k: (want_conf[k], v) for k, v in got["config"].items()
               if want_conf[k] != v}
        if got["launches"] != want["launches"]:
            bad["launches"] = (want["launches"], got["launches"])
        if bad:
            out[label] = bad
    return out


def check(torch, device, label: str) -> Tuple[bool, dict]:
    """The kernel at SHAPES[label] against the plain version, with the erf
    and single-pass controls and the three-pass emulation."""
    from tenzing_tpu_torch.ops import ffn_kernels as fk

    e, c, dff = SHAPES[label]
    x, w1, w2 = inputs(torch, device, e, c, dff)
    if e == 1:
        x, w1, w2 = x[0], w1[0], w2[0]
        run = fk.ffn_rows
        plain = fk.ffn_rows_plain
    else:
        run, plain = fk.ffn_batched, fk.ffn_batched_plain
    got, again = run(x, w1, w2), run(x, w1, w2)
    want = plain(x, w1, w2)
    ctrl = {"erf": plain(x, w1, w2, approximate="none"),
            "tf32_1pass": tf32_ffn_plain(torch, x, w1, w2, 1),
            "tf32_3pass": tf32_ffn_plain(torch, x, w1, w2, 3)}
    torch.cuda.synchronize()

    def errs(t):
        d = (t - want).abs()
        return {"max_abs_err": float(d.max()),
                "rel_rms": float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()),
                "within_tol": bool(torch.allclose(t, want, **fk.FFN_TOL))}

    info = {"shape": [e, c, 512, dff], "kernel": errs(got),
            "deterministic": bool(torch.equal(got, again)),
            "finite": bool(torch.isfinite(got).all()),
            **{k: errs(v) for k, v in ctrl.items()},
            "y_max_abs": float(want.abs().max())}
    ok = (info["kernel"]["within_tol"] and info["deterministic"]
          and info["finite"] and not info["erf"]["within_tol"]
          and not info["tf32_1pass"]["within_tol"]
          and info["tf32_3pass"]["within_tol"])
    return ok, info


def build(csrc: Path, sources: Tuple[str, ...], signatures: Dict[str, list],
          tag: str) -> ctypes.CDLL:
    """``sources`` of ``csrc`` built into one library (all ``nvcc``
    processes started together), ``signatures`` bound."""
    from tenzing_tpu_torch.ops import kernel_lib

    kernel_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"ffn_f32_{tag}_",
                                 dir=kernel_lib.BUILD_DIR))
    procs = []
    for src in sources:
        obj = work / (src + ".o")
        procs.append((obj, subprocess.Popen(
            [kernel_lib.nvcc(), *kernel_lib.ARCH_FLAGS,
             *kernel_lib.COMPILE_FLAGS, "-c", str(csrc / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for obj, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed:\n{out}")
    so = work / f"{tag}.so"
    subprocess.run([kernel_lib.nvcc(), *kernel_lib.ARCH_FLAGS, "-shared", "-o",
                    str(so), *[str(o) for o, _ in procs]], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def parent_calls(torch, lib, x, w1, w2, y):
    """A closure calling an older checkout's f32 entry point (one without
    the workspace argument) at x's shape; raises when the entry point
    refuses the call, as one with another signature does."""
    stream = torch.cuda.current_stream().cuda_stream
    entry = lib.tz_ffn_batched if x.dim() == 3 else lib.tz_ffn_rows
    ptrs = (x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr())

    def run():
        err = entry(*ptrs, *x.shape, w1.shape[-1], stream)
        if err:
            raise RuntimeError(f"ffn_f32: the parent's launch failed with "
                               f"cudaError {err}")
    return run


def batched_call(torch, lib, x, w1, w2, y, h):
    """A closure calling ``lib``'s ``tz_ffn_batched`` (this tree's
    signature) on (E, C, d) tensors."""
    stream = torch.cuda.current_stream().cuda_stream
    e, c, d = x.shape

    def run():
        err = lib.tz_ffn_batched(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                                 y.data_ptr(), h.data_ptr(), e, c, d,
                                 w1.shape[-1], stream)
        if err:
            raise RuntimeError(f"ffn_f32: launch failed with cudaError {err}")
    return run


def times(torch, device, parent, rounds: int) -> List[dict]:
    """Each timed call at both shapes, in alternating rounds."""
    import torch.nn.functional as F

    from tenzing_tpu_torch.ops import ffn_kernels as fk

    rows = []
    for label in MAIN:
        e, c, dff = SHAPES[label]
        x, w1, w2 = inputs(torch, device, e, c, dff)
        y = torch.empty_like(x)
        h = torch.empty(e, c, dff, device=device)
        x2, w12, w22, y2, h2 = (t[0] for t in (x, w1, w2, y, h))
        if e == 1:
            calls = {"kernel": lambda: fk.ffn_rows(x2, w12, w22, out=y2, work=h2),
                     "plain": lambda: fk.ffn_rows_plain(x2, w12, w22),
                     "library_calls": lambda: torch.matmul(F.gelu(
                         torch.matmul(x2, w12), approximate="tanh"), w22)}
        else:
            calls = {"kernel": lambda: fk.ffn_batched(x, w1, w2, out=y, work=h),
                     "plain": lambda: fk.ffn_batched_plain(x, w1, w2),
                     "library_calls": lambda: torch.bmm(F.gelu(
                         torch.bmm(x, w1), approximate="tanh"), w2)}
        if parent is not None:
            calls["parent"] = (parent_calls(torch, parent, x2, w12, w22, y2)
                               if e == 1 else
                               parent_calls(torch, parent, x, w1, w2, y))
        flops = fk.ffn_flops(e, c, 512, dff)
        for rnd in range(rounds):
            names = list(calls) if rnd % 2 == 0 else list(calls)[::-1]
            for name in names:
                ms = common.cuda_ms(torch, calls[name])
                rows.append({"shape": label, "round": rnd, "call": name,
                             "ms": ms, "tflops": flops / ms * 1e-9})
        del x, w1, w2, y, h
        torch.cuda.empty_cache()
    return rows


def ablate(torch, device, rounds: int) -> List[dict]:
    """Build each :data:`ABLATIONS` variant of csrc/ffn_tile.cuh (with
    ffn_expert.cu), check the checked and keeping ones against the plain
    version at row 14's shape, and time every variant at both shapes."""
    from tenzing_tpu_torch.ops import ffn_kernels as fk

    libs, rows = common.build_variants("ffn_tile.cuh", ABLATIONS, KERNELS[0],
                                       source="ffn_expert.cu",
                                       entry_points=("tz_ffn_batched",))
    e, c, dff = SHAPES["row14"]
    x, w1, w2 = inputs(torch, device, e, c, dff)
    want = fk.ffn_batched_plain(x, w1, w2)
    for name in CHECKED_ABLATIONS + KEEPING_ABLATIONS:
        y = torch.empty_like(x)
        h = torch.empty(e, c, dff, device=device)
        batched_call(torch, libs[name], x, w1, w2, y, h)()
        torch.cuda.synchronize()
        d = (y - want).abs()
        rows.append({"ablation": name, "check": "vs plain",
                     "must_pass": name in KEEPING_ABLATIONS,
                     "max_abs_err": float(d.max()),
                     "rel_rms": float(d.pow(2).mean().sqrt()
                                      / want.pow(2).mean().sqrt()),
                     "within_tol": bool(torch.allclose(y, want, **fk.FFN_TOL))})
    del x, w1, w2, want
    for rnd in range(rounds):
        for label in MAIN:
            e, c, dff = SHAPES[label]
            x, w1, w2 = inputs(torch, device, e, c, dff)
            y = torch.empty_like(x)
            h = torch.empty(e, c, dff, device=device)
            names = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for name in names:
                rows.append({"ablation": name, "shape": label, "round": rnd,
                             "ms": common.cuda_ms(torch, batched_call(
                                 torch, libs[name], x, w1, w2, y, h))})
            del x, w1, w2, y, h
    return rows


def cycles(torch, device) -> List[dict]:
    """Build the body with :data:`CYCLE_EDITS` (ffn_expert.cu alone, with
    ``tz_ffn_cycles``) and report the cycles a chunk of each phase, summed
    over every CTA of five calls, at both shapes."""
    from tenzing_tpu_torch.ops import kernel_lib

    csrc = kernel_lib.CSRC
    kernel_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ffn_f32_cycles_",
                                 dir=kernel_lib.BUILD_DIR))
    (work / "ffn_tile.cuh").write_text(common.apply_edits(
        (csrc / "ffn_tile.cuh").read_text(), CYCLE_EDITS, "cycles"))
    (work / "ffn_expert.cu").write_text((csrc / "ffn_expert.cu").read_text()
                                        + CYCLES_ENTRY)
    so = work / "cycles.so"
    subprocess.run([kernel_lib.nvcc(), *kernel_lib.ARCH_FLAGS,
                    *kernel_lib.COMPILE_FLAGS, "-shared", "-I", str(csrc),
                    str(work / "ffn_expert.cu"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.tz_ffn_batched.argtypes = kernel_lib.SIGNATURES["tz_ffn_batched"]
    lib.tz_ffn_batched.restype = ctypes.c_int
    lib.tz_ffn_cycles.argtypes = [ctypes.c_void_p]
    rows = []
    for label in MAIN:
        e, c, dff = SHAPES[label]
        x, w1, w2 = inputs(torch, device, e, c, dff)
        y = torch.empty_like(x)
        h = torch.empty(e, c, dff, device=device)
        run = batched_call(torch, lib, x, w1, w2, y, h)
        out = (ctypes.c_ulonglong * 32)()
        run()
        torch.cuda.synchronize()
        lib.tz_ffn_cycles(out)  # cleared
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        if lib.tz_ffn_cycles(out):
            raise RuntimeError("ffn_f32: reading the cycle counters failed")
        v = list(out)
        row = {"shape": label, "ms": common.cuda_ms(torch, run)}
        for name, at, phases in (("producer_a", 0, PRODUCER_PHASES),
                                 ("producer_b", 8, PRODUCER_PHASES),
                                 ("consumer_0", 16, CONSUMER_PHASES),
                                 ("consumer_1", 24, CONSUMER_PHASES)):
            n = max(v[at + 7], 1)
            row[name] = {p: v[at + i] / n for i, p in enumerate(phases)}
            row[name]["chunks"] = v[at + 7]
        rows.append(row)
        del x, w1, w2, y, h
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ablate", action="store_true",
                    help="also time csrc/ffn_tile.cuh's ablation variants")
    ap.add_argument("--sass", action="store_true",
                    help="also count HGMMA and spill instructions in SASS")
    ap.add_argument("--cycles", action="store_true",
                    help="also count the cycles of each phase of the "
                         "chunk loops")
    ap.add_argument("--parent", metavar="DIR",
                    help="an older checkout whose kernels are timed beside "
                         "this one's")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("ffn_f32: no CUDA device\n")
        return 2
    from tenzing_tpu_torch.ops import kernel_lib

    common.device_line(torch)
    kernel_lib.lib()
    report = {k: common.ptxas_report(str(kernel_lib.build_info.get("ptxas", "")), k)
              for k in KERNELS}
    mismatch = plan_mismatch()
    write_line(json.dumps({"build_s": kernel_lib.build_info.get("seconds"),
                           "ptxas": report, "plan": library_plan(*SHAPES["row14"]),
                           "plan_mismatch": mismatch}))
    failed = ["plan"] if mismatch else []
    if args.sass:
        sass = common.sass_spills(KERNELS)
        write_line(json.dumps({"sass": sass}))
        failed += [f"no HGMMA in {k}" for k, v in sass.items()
                   if not v.get("hgmma")]
    device = torch.device("cuda", 0)
    common.run_checks([(label, lambda label=label: check(torch, device, label))
                       for label in SHAPES], failed)
    parent = None
    if args.parent:
        old = {"tz_ffn_batched": [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4
               + [ctypes.c_void_p],
               "tz_ffn_rows": [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
               + [ctypes.c_void_p]}
        parent = build(Path(args.parent) / "tenzing_tpu_torch" / "csrc",
                       ("ffn_expert.cu", "ffn_rows.cu"), old, "parent")
    for row in times(torch, device, parent, args.rounds):
        write_line(json.dumps(row))
    if args.ablate:
        for row in ablate(torch, device, args.rounds):
            write_line(json.dumps(row))
            if row.get("check") and row["within_tol"] != row["must_pass"]:
                failed.append(f"ablation {row['ablation']}")
    if args.cycles:
        for row in cycles(torch, device):
            write_line(json.dumps({"cycles": row}))
    write_line(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
