"""The bf16 ``ffn_rows`` body (csrc/ffn_rows.cu ``tz_ffn_rows_bf16``: bf16
``wgmma`` on TMA-filled, 128-byte-swizzled stages, two launches through a
bf16 h workspace) on the card: row 13 bf16 of PERF.md's kernel table.

``python -m tenzing_tpu_torch.bench.ffn_bf16 [--sass] [--ablate]
[--parent DIR] [--rounds N]``

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernel library, prints what ``ptxas -v`` reported for each
   instantiation of ``ffn_rows_bf16_kernel`` (64, 128 and 256 columns:
   registers, spills, ptxas's ``wgmma`` serialization notes) and holds the
   launch constants and both launches' tiling of
   :func:`ops.ffn_kernels.bf16_launch_plan` against the library's
   ``tz_ffn_bf16_config`` / ``tz_ffn_bf16_plan`` at :data:`SHAPES`;
3. at every shape of :data:`SHAPES` (the slice's n 2048, ragged n 2047,
   37 and 1, d_ff 2040 and 8): the kernel against the plain version at
   ``FFN_BF16_TOL``, eight calls back to back bit for bit with the first, y
   finite, and a plain
   version with W1's last 64 hidden columns zeroed (a skipped hidden tile)
   rejected;
4. times, after a 128 MB write flush (as chip_smoke.py's timer), at the
   slice's shape: the kernel, the three library calls (``matmul ->
   gelu(tanh) -> matmul`` in bf16), the plain version, each pair of tile
   widths of :data:`TILE_VARIANTS` (``tz_ffn_rows_bf16_ex``: the second
   product in 64-column tiles, 128 tiles on one wave, or in 128-column
   tiles split 2 ways over a cluster) and, with ``--parent DIR``, an older
   checkout's bf16 kernel (``git archive`` of the parent into a gitignored
   directory) in the same process, the calls in alternating rounds, each
   beside the operations bound;
5. with ``--sass``, the HGMMA, ``mma.sync`` (HMMA) and spill instructions
   of each instantiation's SASS (``cuobjdump -sass``);
6. with ``--ablate``, csrc/ffn_rows.cu built again with one part changed
   (:data:`ABLATIONS`: every chunk's products waited for before the next,
   three stages instead of four, no products, no TMA loads, the consumers
   given 240 registers, every CTA returning after its set-up, no epilogue,
   the tensor maps prefetched, each launch alone), and csrc/ffn_tile.cuh
   likewise (:data:`TILE_ABLATIONS`:
   the epilogue without its gelu, its gelu through ``tanhf``), each timed
   beside the kernel.

One JSON object per line.  It needs a CUDA device; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from tenzing_tpu_torch.bench import attn_common as common
from tenzing_tpu_torch.bench.ffn_f32 import build

SOURCE = "ffn_rows.cu"
# the kernel's instantiations, by their mangled names' template argument
KERNELS = {f"ffn_rows_bf16_kernel<{c}>": f"ffn_rows_bf16_kernelILi{c}E"
           for c in (64, 128, 256)}
# label -> (n, dff): row 13 bf16's shape (one chunk of the MoE layer at world
# size 1) and the ragged shapes the card tests cover
SHAPES = {"row13": (2048, 2048), "n2047": (2047, 2048), "n37": (37, 2048),
          "n1": (1, 2048), "dff2040": (2048, 2040), "dff8": (300, 8)}
MAIN = "row13"
D_MODEL = 512
# (first, second) launch's tile columns timed beside the kernel's own
TILE_VARIANTS = ((256, 64), (256, 128), (256, 256), (128, 64), (128, 128))

# --ablate: name -> [(text of csrc/ffn_rows.cu, its replacement)]
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    "wait-each-chunk": [("      wg_wait<1>();\n", "      wg_wait<0>();\n")],
    "stages-3": [("constexpr int kBStages = 4;", "constexpr int kBStages = 3;")],
    "no-mma": [("""        wgmma_ss<kN, 1>(acc, desc_sw128(a + kk * 32, 16, 1024),
                        desc_sw128(b + kk * 2048, kBDepth * kBBox * 2, 1024));
""", "        acc[kk] += __uint_as_float(a & 0xff);\n")],
    "no-loads": [("""    mbar_expect_tx(&full[r.stage], BTile<kN>::kStageBytes);
    tma_box(st, &g.a_map, &full[r.stage], kc * kBDepth, p.row0, p.e);
#pragma unroll
    for (int j = 0; j < kN / kBBox; ++j)
      tma_box(st + kBABytes + j * (kBDepth * kBBox * 2), &g.b_map,
              &full[r.stage], p.col0 + j * kBBox, kc * kBDepth, p.e);
""", "    mbar_arrive(&full[r.stage]);\n    (void)st;\n")],
    # setmaxnreg's shares: the consumers 240, the producer warpgroup 24
    "regs-240": [("constexpr int kBProducerRegs = 40;",
                  "constexpr int kBProducerRegs = 24;"),
                 ("constexpr int kBConsumerRegs = 232;",
                  "constexpr int kBConsumerRegs = 240;")],
    # the kernel's setup alone: every CTA returns after its barriers
    "empty": [("  const TilePos p = tile_pos<kBRows, kN, kBDepth>(g);\n",
               "  if (g.m > 0) return;\n"
               "  const TilePos p = tile_pos<kBRows, kN, kBDepth>(g);\n")],
    # no epilogue: the sums neither staged in shared memory nor stored
    "no-epilogue": [("    if (active) store_partial<kN, BTile<kN>::kPitch>(part, acc, wg, t);\n",
                     "    if (active && acc[0] == 12345.0f) part[t] = acc[1];\n"),
                    ("  sum_store<kBRows, kN, BTile<kN>::kPitch, kBThreads>(g, cluster, part, p);\n",
                     "  cluster.sync();\n")],
    # the tensor maps prefetched by the producer before its first box
    "prefetch-maps": [("    if (t == 0) produce_bf16<kN>(g, base, full, empty, p);\n",
                       "    if (t == 0) {\n"
                       "      asm volatile(\"prefetch.tensormap [%0];\" :: \"l\"(&g.a_map) : \"memory\");\n"
                       "      asm volatile(\"prefetch.tensormap [%0];\" :: \"l\"(&g.b_map) : \"memory\");\n"
                       "      produce_bf16<kN>(g, base, full, empty, p);\n"
                       "    }\n")],
    # each launch alone
    "first-launch": [("  if (err == 0) err = launch_bf16(g2, cols2, stream);\n", "")],
    "second-launch": [("  if (err == 0) err = launch_bf16(g1, cols1, stream);\n", "")],
}
_SUM_LOOP = ("  for (int i = threadIdx.x; i < (r_hi - r_lo) * (kTileCols / 4); "
             "i += kNThreads) {\n")
# --ablate, the shared header: name -> [(text of csrc/ffn_tile.cuh, its
# replacement)], built with ffn_rows.cu beside the edited header
TILE_ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    # the epilogue without its gelu
    "no-gelu": [("    if (g.gelu) s = gelu4<T>(s);", "    if (g.gelu < 0) s = gelu4<T>(s);")],
    # the epilogue's loop unrolled, several rows' loads in flight a thread
    "epilogue-unroll4": [(_SUM_LOOP, "#pragma unroll 4\n" + _SUM_LOOP)],
    "epilogue-unroll8": [(_SUM_LOOP, "#pragma unroll 8\n" + _SUM_LOOP)],
    # the bf16 epilogue's gelu through tanhf (the f32 body's form)
    "tanh-gelu": [("  if constexpr (sizeof(T) == 2)\n", "  if constexpr (sizeof(T) == 0)\n")],
}
# the variants that keep the result (held against the plain version)
KEEPING_ABLATIONS = ("wait-each-chunk", "stages-3", "regs-240",
                     "prefetch-maps", "tanh-gelu", "epilogue-unroll4",
                     "epilogue-unroll8")


def inputs(torch, device, n: int, dff: int, seed: int = 0):
    """x standard normal, W1 and W2 scaled by 1/sqrt(fan-in) (h and y of
    order 1), from a seeded generator on ``device``, rounded to bf16."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(n, D_MODEL, device=device, generator=gen)
    w1 = torch.randn(D_MODEL, dff, device=device, generator=gen) / D_MODEL ** 0.5
    w2 = torch.randn(dff, D_MODEL, device=device, generator=gen) / dff ** 0.5
    return tuple(t.to(torch.bfloat16) for t in (x, w1, w2))


def skipped_tile(w1):
    """W1 with its last 64 hidden columns zeroed: a skipped hidden tile."""
    w1 = w1.clone()
    w1[:, -min(64, w1.shape[1]):] = 0
    return w1


def library_plan(n: int, dff: int) -> dict:
    """The library's constants and both launches' tiling at (n, dff), in
    :func:`bf16_launch_plan`'s form."""
    import torch

    from tenzing_tpu_torch.ops import ffn_kernels as fk
    from tenzing_tpu_torch.ops import kernel_lib

    lib = kernel_lib.lib()
    conf = (ctypes.c_int64 * len(fk.BF16_CONFIG_KEYS))()
    lib.tz_ffn_bf16_config(conf)
    config = dict(zip(fk.BF16_CONFIG_KEYS, list(conf)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launches = []
    for (m, nn, k), cols, smem in (
            ((n, dff, D_MODEL), config["cols1"], config["smem_bytes1"]),
            ((n, D_MODEL, dff), config["cols2"], config["smem_bytes2"])):
        out = (ctypes.c_int64 * 5)()
        lib.tz_ffn_bf16_plan(m, nn, k, cols, sms, out)
        launches.append(dict(zip(("m_tiles", "n_tiles", "splits",
                                  "chunks_per_split", "ctas"), list(out)),
                             cols=cols, smem_bytes=smem))
    return {"config": config, "launches": launches, "sms": sms}


def plan_mismatch() -> dict:
    """Where the library and :func:`bf16_launch_plan` disagree, per shape."""
    from tenzing_tpu_torch.ops import ffn_kernels as fk

    want_conf = {"rows": fk.BF16_ROWS, "cols1": fk.BF16_COLS[0],
                 "cols2": fk.BF16_COLS[1], "depth": fk.BF16_DEPTH,
                 "stages": fk.BF16_STAGES, "threads": fk.BF16_THREADS,
                 "smem_bytes1": fk.bf16_smem_bytes(fk.BF16_COLS[0]),
                 "smem_bytes2": fk.bf16_smem_bytes(fk.BF16_COLS[1]),
                 "max_splits": fk.F32_MAX_SPLITS}
    out = {}
    for label, (n, dff) in SHAPES.items():
        got = library_plan(n, dff)
        want = fk.bf16_launch_plan(n, dff, sms=got["sms"])
        bad = {k: (want_conf[k], v) for k, v in got["config"].items()
               if want_conf[k] != v}
        if got["launches"] != want["launches"]:
            bad["launches"] = (want["launches"], got["launches"])
        if bad:
            out[label] = bad
    return out


def check(torch, device, label: str) -> Tuple[bool, dict]:
    """The kernel at SHAPES[label] against the plain version, with the
    skipped-hidden-tile control."""
    from tenzing_tpu_torch.ops import ffn_kernels as fk

    n, dff = SHAPES[label]
    x, w1, w2 = inputs(torch, device, n, dff)
    got = fk.ffn_rows(x, w1, w2)
    again = torch.empty_like(got)
    work = torch.full((n, dff), float("nan"), dtype=torch.bfloat16,
                      device=device)
    for _ in range(8):  # back to back on one stream, no host wait between
        fk.ffn_rows(x, w1, w2, out=again, work=work)
    want = fk.ffn_rows_plain(x, w1, w2).float()
    ctl = fk.ffn_rows_plain(x, skipped_tile(w1), w2).float()
    torch.cuda.synchronize()
    g = got.float()
    info = {"shape": [n, D_MODEL, dff],
            "max_abs_err": float((g - want).abs().max()),
            "within_tol": bool(torch.allclose(g, want, **fk.FFN_BF16_TOL)),
            "deterministic": bool(torch.equal(got, again)),
            "finite": bool(torch.isfinite(g).all()),
            "control_max_abs_err": float((ctl - want).abs().max()),
            "control_rejected": not torch.allclose(ctl, want,
                                                   **fk.FFN_BF16_TOL),
            "y_max_abs": float(want.abs().max())}
    ok = (info["within_tol"] and info["deterministic"] and info["finite"]
          and info["control_rejected"])
    return ok, info


def ex_call(torch, lib, x, w1, w2, y, h, cols: Tuple[int, int]):
    """A closure calling ``lib``'s ``tz_ffn_rows_bf16_ex`` with the two
    launches' tile columns ``cols``."""
    stream = torch.cuda.current_stream().cuda_stream
    n, d = x.shape

    def run():
        err = lib.tz_ffn_rows_bf16_ex(x.data_ptr(), w1.data_ptr(),
                                      w2.data_ptr(), y.data_ptr(),
                                      h.data_ptr(), n, d, w1.shape[1],
                                      cols[0], cols[1], stream)
        if err:
            raise RuntimeError(f"ffn_bf16: launch failed with cudaError {err}")
    return run


def parent_call(torch, lib, x, w1, w2, y):
    """A closure calling an older checkout's bf16 entry point (no
    workspace argument)."""
    stream = torch.cuda.current_stream().cuda_stream
    n, d = x.shape

    def run():
        err = lib.tz_ffn_rows_bf16(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                                   y.data_ptr(), n, d, w1.shape[1], stream)
        if err:
            raise RuntimeError(f"ffn_bf16: the parent's launch failed with "
                               f"cudaError {err}")
    return run


def variant_checks(torch, device) -> List[dict]:
    """Each tile pair of :data:`TILE_VARIANTS` against the plain version at
    the slice's shape."""
    from tenzing_tpu_torch.ops import ffn_kernels as fk
    from tenzing_tpu_torch.ops import kernel_lib

    n, dff = SHAPES[MAIN]
    x, w1, w2 = inputs(torch, device, n, dff)
    want = fk.ffn_rows_plain(x, w1, w2).float()
    rows = []
    for cols in TILE_VARIANTS:
        y = torch.empty_like(x)
        h = torch.empty(n, dff, dtype=torch.bfloat16, device=device)
        ex_call(torch, kernel_lib.lib(), x, w1, w2, y, h, cols)()
        torch.cuda.synchronize()
        rows.append({"tiles": list(cols), "check": "vs plain",
                     "max_abs_err": float((y.float() - want).abs().max()),
                     "within_tol": bool(torch.allclose(y.float(), want,
                                                       **fk.FFN_BF16_TOL))})
    return rows


def times(torch, device, parent, rounds: int) -> List[dict]:
    """Each timed call at the slice's shape, in alternating rounds."""
    import torch.nn.functional as F

    from tenzing_tpu_torch.ops import ffn_kernels as fk
    from tenzing_tpu_torch.ops import kernel_lib

    n, dff = SHAPES[MAIN]
    x, w1, w2 = inputs(torch, device, n, dff)
    y = torch.empty_like(x)
    h = torch.empty(n, dff, dtype=torch.bfloat16, device=device)
    flops = fk.ffn_flops(1, n, D_MODEL, dff)
    bound = flops / 989e12 * 1e3
    calls = {"kernel": lambda: fk.ffn_rows(x, w1, w2, out=y, work=h),
             "library_calls": lambda: torch.matmul(F.gelu(
                 torch.matmul(x, w1), approximate="tanh"), w2),
             "plain": lambda: fk.ffn_rows_plain(x, w1, w2)}
    for cols in TILE_VARIANTS:
        calls["tiles-%dx%d" % cols] = ex_call(torch, kernel_lib.lib(), x, w1,
                                              w2, y, h, cols)
    if parent is not None:
        calls["parent"] = parent_call(torch, parent, x, w1, w2, y)
    rows = []
    for rnd in range(rounds):
        names = list(calls) if rnd % 2 == 0 else list(calls)[::-1]
        for name in names:
            ms = common.cuda_ms(torch, calls[name])
            rows.append({"shape": MAIN, "round": rnd, "call": name, "ms": ms,
                         "tflops": flops / ms * 1e-9, "bound_ms": bound,
                         "vs_bound": ms / bound})
    return rows


def hmma_counts(kernels: Dict[str, str]) -> Dict[str, dict]:
    """Each instantiation's HGMMA, HMMA (``mma.sync``) and spill
    instructions in the built library's SASS."""
    from tenzing_tpu_torch.ops import kernel_lib

    so = kernel_lib.build()
    tool = Path(kernel_lib.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs = re.split(r"\n\s*Function : ", "\n" + sass)
    out = {}
    for name, mangled in kernels.items():
        body = next((f for f in funcs[1:] if mangled in f.split("\n", 1)[0]),
                    None)
        if body is None:
            out[name] = {"found": False}
            continue
        info = common.spill_placement("Function : " + body, mangled)
        info.pop("listed", None)
        info["hmma"] = len(re.findall(r"\bHMMA\b", body))
        out[name] = info
    return out


def ablate(torch, device, rounds: int) -> List[dict]:
    """Build each :data:`ABLATIONS` variant of csrc/ffn_rows.cu, check the
    keeping ones against the plain version and time every variant at the
    slice's shape."""
    from tenzing_tpu_torch.ops import ffn_kernels as fk

    libs, rows = common.build_variants(SOURCE, ABLATIONS,
                                       KERNELS["ffn_rows_bf16_kernel<64>"],
                                       source=SOURCE,
                                       entry_points=("tz_ffn_rows_bf16_ex",))
    tile_libs, tile_rows = common.build_variants(
        "ffn_tile.cuh", TILE_ABLATIONS, KERNELS["ffn_rows_bf16_kernel<64>"],
        source=SOURCE, entry_points=("tz_ffn_rows_bf16_ex",))
    libs.update((k, v) for k, v in tile_libs.items() if k != "kernel")
    rows += [r for r in tile_rows if r["ablation"] != "kernel"]
    n, dff = SHAPES[MAIN]
    x, w1, w2 = inputs(torch, device, n, dff)
    want = fk.ffn_rows_plain(x, w1, w2).float()
    y = torch.empty_like(x)
    h = torch.empty(n, dff, dtype=torch.bfloat16, device=device)
    cols = tuple(fk.BF16_COLS)
    for name in KEEPING_ABLATIONS:
        ex_call(torch, libs[name], x, w1, w2, y, h, cols)()
        torch.cuda.synchronize()
        rows.append({"ablation": name, "check": "vs plain", "must_pass": True,
                     "max_abs_err": float((y.float() - want).abs().max()),
                     "within_tol": bool(torch.allclose(y.float(), want,
                                                       **fk.FFN_BF16_TOL))})
    for rnd in range(rounds):
        names = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for name in names:
            rows.append({"ablation": name, "round": rnd, "ms": common.cuda_ms(
                torch, ex_call(torch, libs[name], x, w1, w2, y, h, cols))})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ablate", action="store_true",
                    help="also time csrc/ffn_rows.cu's ablation variants")
    ap.add_argument("--sass", action="store_true",
                    help="also count HGMMA, HMMA and spill instructions")
    ap.add_argument("--parent", metavar="DIR",
                    help="an older checkout whose bf16 kernel is timed "
                         "beside this one's")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("ffn_bf16: no CUDA device\n")
        return 2
    from tenzing_tpu_torch.ops import kernel_lib

    common.device_line(torch)
    kernel_lib.lib()
    ptxas = str(kernel_lib.build_info.get("ptxas", ""))
    report = {k: common.ptxas_report(ptxas, m) for k, m in KERNELS.items()}
    mismatch = plan_mismatch()
    print(json.dumps({"build_s": kernel_lib.build_info.get("seconds"),
                      "ptxas": report, "plan": library_plan(*SHAPES[MAIN]),
                      "plan_mismatch": mismatch}), flush=True)
    failed = ["plan"] if mismatch else []
    if args.sass:
        sass = hmma_counts(KERNELS)
        print(json.dumps({"sass": sass}), flush=True)
        for k, v in sass.items():
            spills = sum(v.get("spills", {}).values())
            if not v.get("hgmma") or v.get("hmma") or spills:
                failed.append(f"sass {k}")
    device = torch.device("cuda", 0)
    common.run_checks([(label, lambda label=label: check(torch, device, label))
                       for label in SHAPES], failed)
    for row in variant_checks(torch, device):
        print(json.dumps(row), flush=True)
        if not row["within_tol"]:
            failed.append("tiles %dx%d" % tuple(row["tiles"]))
    parent = None
    if args.parent:
        old = {"tz_ffn_rows_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
               + [ctypes.c_void_p]}
        parent = build(Path(args.parent) / "tenzing_tpu_torch" / "csrc",
                       (SOURCE,), old, "parent_bf16")
    for row in times(torch, device, parent, args.rounds):
        print(json.dumps(row), flush=True)
    if args.ablate:
        for row in ablate(torch, device, args.rounds):
            print(json.dumps(row), flush=True)
            if row.get("check") and row["within_tol"] != row["must_pass"]:
                failed.append(f"ablation {row['ablation']}")
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
