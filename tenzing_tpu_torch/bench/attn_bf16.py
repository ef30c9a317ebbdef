"""The bf16 attention fold kernel (``attn_fold_bf16``) on the card.

``python -m tenzing_tpu_torch.bench.attn_bf16 [--ablate]``

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernel library and prints what ``ptxas -v`` reported for
   ``attn_fold_bf16`` (registers, spills, the ``setmaxnreg`` warnings and
   ptxas's notes that it serialized ``wgmma`` instructions), and holds the
   launch constants of :func:`ops.attention_kernels.bf16_launch_plan`
   against the library's ``tz_attn_bf16_config``;
3. runs every case of :data:`STRESS_CASES` (the card tests run the same
   ones) against the plain version on the same inputs, at
   ``BF16_STATE_TOL``, and reports :func:`x8qk_vs_f64`;
4. with ``--ablate``, where the kernel's time goes at the main path's
   shapes (4, 8192 queries, 8192 keys in blocks of 1024, and one 1024-key
   block): the source built again with one part changed
   (:data:`ABLATIONS`: the first version's full-precision ``expf`` per
   element, the first version's scalar loads and stores of the state, no
   exp at all, no pass 1, no P V — the last three compute wrong numbers and
   are timed only), each variant's time beside the kernel's,
   K/V already cast, in alternating rounds in one process (CUDA events, the
   median of single launches, each after a 128 MB L2 flush).

One JSON object per line.  It needs a CUDA device; exits 1 if a case fails.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from typing import Dict, List, Tuple

# name -> (kernel, b, n, nkv, bkv, state, layout): kernel "block" folds all
# nkv keys as one block, "fused" in blocks of bkv; state "init" or "mid";
# layout "dense", "strided" (Q, K and V are views with row strides of 2 d and
# K/V a key range of a longer tensor, as the block chain passes them) or
# "x8" (q scaled by 8, so s spans 8 times its range: the max and exp path at
# large exponents).  With q and k both scaled (s at 64 times its range) the
# f32 summation-order differences of s alone exceed l's rtol between any
# two correct folds; :func:`x8qk_vs_f64` reports that case against a float64
# fold instead.
STRESS_CASES: Dict[str, Tuple[str, int, int, int, int, str, str]] = {
    "tile-128": ("block", 1, 128, 128, 128, "init", "dense"),
    "nkv-not-tile": ("block", 2, 256, 1000, 1000, "mid", "dense"),
    "n-not-128": ("block", 2, 200, 384, 384, "mid", "dense"),
    "fused-bkv256": ("fused", 2, 256, 1024, 256, "init", "dense"),
    "fused-bkv200": ("fused", 1, 300, 1000, 200, "mid", "dense"),
    "fused-bkv64": ("fused", 2, 200, 256, 64, "mid", "dense"),
    "strided": ("block", 2, 256, 512, 512, "mid", "strided"),
    "fused-strided": ("fused", 2, 256, 1024, 256, "init", "strided"),
    "x8": ("fused", 2, 256, 1024, 256, "mid", "x8"),
}
HEAD_DIM = 128

# --ablate: name -> [(text of csrc/attn_fold.cu, its replacement)]
ABLATIONS = {
    "expf": [(f"exp2f(__fmaf_rn(x{r}, scale2, -ml_{r}))",
              f"expf(__fsub_rn(__fmul_rn(x{r}, scale2 / kLog2e), "
              f"ml_{r} / kLog2e))") for r in "ab"],
    "no-exp": [(f"exp2f(__fmaf_rn(x{r}, scale2, -ml_{r}))",
                f"__fmaf_rn(x{r}, scale2, -ml_{r})") for r in "ab"],
    "no-pass1": [("float mx_a = -INFINITY, mx_b = -INFINITY;\n"
                  "      for (int kv0 = blk0; kv0 < blk1;",
                  "float mx_a = 0.0f, mx_b = 0.0f;\n"
                  "      for (int kv0 = blk0; kv0 < blk0;"),
                 ("for (int pass = 0; pass < 2; ++pass)",
                  "for (int pass = 1; pass < 2; ++pass)")],
    "scalar-state": [
        ("""      const float2 xa = la ? *reinterpret_cast<const float2*>(acc + ra * st_sr + c)
                           : make_float2(0.0f, 0.0f);
      const float2 xb = lb ? *reinterpret_cast<const float2*>(acc + rb * st_sr + c)
                           : make_float2(0.0f, 0.0f);""",
         """      const float2 xa = la ? make_float2(acc[ra * st_sr + c], acc[ra * st_sr + c + 1])
                           : make_float2(0.0f, 0.0f);
      const float2 xb = lb ? make_float2(acc[rb * st_sr + c], acc[rb * st_sr + c + 1])
                           : make_float2(0.0f, 0.0f);"""),
        ("""        *reinterpret_cast<float2*>(acc + ra * st_sr + c) =
            make_float2(o[4 * j + 0], o[4 * j + 1]);
        *reinterpret_cast<float2*>(m + ra * st_sr + c) = make_float2(m_a, m_a);
        *reinterpret_cast<float2*>(l + ra * st_sr + c) = make_float2(l_a, l_a);""",
         """        acc[ra * st_sr + c] = o[4 * j + 0];
        acc[ra * st_sr + c + 1] = o[4 * j + 1];
        m[ra * st_sr + c] = m[ra * st_sr + c + 1] = m_a;
        l[ra * st_sr + c] = l[ra * st_sr + c + 1] = l_a;"""),
        ("""        *reinterpret_cast<float2*>(acc + rb * st_sr + c) =
            make_float2(o[4 * j + 2], o[4 * j + 3]);
        *reinterpret_cast<float2*>(m + rb * st_sr + c) = make_float2(m_b, m_b);
        *reinterpret_cast<float2*>(l + rb * st_sr + c) = make_float2(l_b, l_b);""",
         """        acc[rb * st_sr + c] = o[4 * j + 2];
        acc[rb * st_sr + c + 1] = o[4 * j + 3];
        m[rb * st_sr + c] = m[rb * st_sr + c + 1] = m_b;
        l[rb * st_sr + c] = l[rb * st_sr + c + 1] = l_b;""")],
    "no-pv": [("fold_pv(o, pa, v_base + vr.stage * kTileBytes);",
               "{ uint32_t x = 0;\n"
               "  for (int i = 0; i < kKeyTile / 16; ++i)\n"
               "    x ^= pa[i][0] ^ pa[i][1] ^ pa[i][2] ^ pa[i][3];\n"
               "  o[0] += __uint_as_float(x & 0x3f800000u); }")],
}


def case_inputs(torch, device, b, n, nkv, state, layout, seed=0):
    """Seeded q, k, v and a state (acc, m, l) on ``device``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    d = HEAD_DIM

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    if layout == "strided":  # rows of 2 d, keys [nkv, 2 nkv) of 3 nkv
        q = randn(b, n, 2 * d)[:, :, d:]
        k = randn(b, 3 * nkv, 2 * d)[:, nkv:2 * nkv, :d]
        v = randn(b, 3 * nkv, 2 * d)[:, nkv:2 * nkv, d:]
    else:
        q, k, v = randn(b, n, d), randn(b, nkv, d), randn(b, nkv, d)
        if layout == "x8":
            q = q * 8
        elif layout == "x8qk":
            q, k = q * 8, k * 8
    if state == "mid":
        acc = randn(b, n, d)
        m = randn(b, n, 1).expand(b, n, d).contiguous()
        l = (1 + 3 * torch.rand(b, n, 1, generator=gen)).to(device)
        l = l.expand(b, n, d).contiguous()
    else:
        acc = torch.zeros(b, n, d, device=device)
        m = torch.full((b, n, d), -1e30, device=device)
        l = torch.zeros(b, n, d, device=device)
    return q, k, v, [acc, m, l]


def run_case(torch, device, name: str) -> Tuple[bool, dict]:
    """One stress case: the kernel against its plain version, held at
    ``BF16_STATE_TOL``.  Returns (ok, errors)."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    kernel, b, n, nkv, bkv, state, layout = STRESS_CASES[name]
    q, k, v, st = case_inputs(torch, device, b, n, nkv, state, layout)
    got, want = [t.clone() for t in st], [t.clone() for t in st]
    scale = HEAD_DIM ** -0.5
    if kernel == "block":
        ak.attn_block(q, k, v, *got, scale, bf16_inputs=True)
        ak.attn_block_plain(q, k, v, *want, scale, bf16_inputs=True)
    else:
        ak.attn_fused(q, k, v, *got, scale, bkv=bkv, bf16_inputs=True)
        ak.attn_fused_plain(q, k, v, *want, scale, bkv, True)
    torch.cuda.synchronize()
    ok, errs = ak.state_check(got, want, ak.BF16_STATE_TOL)
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    return ok and finite, {"errors": errs, "finite": finite}


def fold_f64(torch, q, k, v, state, scale: float, bkv: int):
    """The bf16 fold in float64: q, k, v and p rounded to bf16 as the
    reference rounds them, every other step exact to float64."""
    q, k, v = (t.to(torch.bfloat16).double() for t in (q, k, v))
    acc, m, l = (t[..., :1].double() if i else t.double()
                 for i, t in enumerate(state))
    for j in range(0, k.shape[1], bkv):
        s = q @ k[:, j:j + bkv].transpose(1, 2) * scale
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mn)
        p = torch.exp(s - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).double() @ v[:, j:j + bkv]
        m = mn
    return [acc, m.expand_as(acc), l.expand_as(acc)]


def x8qk_vs_f64(torch, device) -> dict:
    """q and k scaled by 8 (the "fused-bkv256" shape, a mid-chain state):
    the kernel and the plain version each held against :func:`fold_f64`,
    and against each other; a report, not a check."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    b, n, nkv, bkv = 2, 256, 1024, 256
    q, k, v, st = case_inputs(torch, device, b, n, nkv, "mid", "x8qk")
    scale = HEAD_DIM ** -0.5
    got, want = [t.clone() for t in st], [t.clone() for t in st]
    ak.attn_fused(q, k, v, *got, scale, bkv=bkv, bf16_inputs=True)
    ak.attn_fused_plain(q, k, v, *want, scale, bkv, True)
    exact = fold_f64(torch, q, k, v, st, scale, bkv)
    torch.cuda.synchronize()
    tol = ak.BF16_STATE_TOL
    out = {"case": "x8qk", "shape": [b, n, nkv, HEAD_DIM], "bkv": bkv}
    for label, a, w in (("kernel_vs_plain", got, want),
                        ("kernel_vs_f64", [t.double() for t in got], exact),
                        ("plain_vs_f64", [t.double() for t in want], exact)):
        ok, errs = ak.state_check(a, w, tol)
        out[label] = {"within_bf16_state_tol": ok, "errors": errs}
    return out


def ptxas_report(text: str, kernel: str = "attn_fold_bf16") -> dict:
    """What ``ptxas -v`` said about ``kernel`` in the build's report:
    registers, spill bytes, stack, and any lines that warn about it."""
    lines = text.splitlines()
    out: dict = {"found": False, "warnings": []}
    inside = False
    for line in lines:
        if "Compiling entry function" in line:
            inside = kernel in line
            out["found"] = out["found"] or inside
            continue
        if not inside:
            continue
        mm = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", line)
        if mm:
            out.update(stack_bytes=int(mm.group(1)),
                       spill_store_bytes=int(mm.group(2)),
                       spill_load_bytes=int(mm.group(3)))
        mm = re.search(r"Used (\d+) registers", line)
        if mm:
            out["registers"] = int(mm.group(1))
            mm = re.search(r"(\d+) bytes smem", line)
            out["static_smem_bytes"] = int(mm.group(1)) if mm else 0
    out["warnings"] = [ln.strip() for ln in lines
                       if ("warning" in ln.lower() and ("setmaxnreg" in ln
                                                        or "wgmma" in ln))
                       or "Potential Performance Loss" in ln]
    return out


def library_config() -> dict:
    """The bf16 kernel's launch constants as the built library reports."""
    import ctypes

    from tenzing_tpu_torch.ops import kernel_lib

    out = (ctypes.c_int64 * 6)()
    kernel_lib.lib().tz_attn_bf16_config(out)
    keys = ("rows_per_cta", "key_tile", "k_stages", "v_stages", "threads",
            "smem_bytes")
    return dict(zip(keys, list(out)))


def config_mismatch(b, n, nkv, bkv) -> dict:
    """Keys where :func:`bf16_launch_plan` and the library disagree."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    plan = ak.bf16_launch_plan(b, n, nkv, bkv, HEAD_DIM)
    return {k: (plan[k], v) for k, v in library_config().items()
            if plan[k] != v}


def cuda_ms(torch, fn, reps: int = 15) -> float:
    """Median CUDA-event time of single calls of ``fn``, each after a 128 MB
    write that flushes the L2 and a spin that covers the enqueue."""
    flush = torch.empty(32 << 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _main_shape_calls(torch, device, lib):
    """(fused, block) closures calling ``lib``'s entry points directly on
    the main path's shapes with K/V already cast, for the ablation."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    b, n, nkv, blk, d = 4, 8192, 8192, 1024, HEAD_DIM
    q, k, v, st = case_inputs(torch, device, b, n, nkv, "init", "dense")
    kv_all = ak.cast_kv_bf16(k, v)
    kv_blk = ak.cast_kv_bf16(k[:, :blk], v[:, :blk])
    stream = torch.cuda.current_stream(device).cuda_stream
    acc, m, l = (t.clone() for t in st)

    def call(kv, nk, fused):
        head = (q.data_ptr(), kv[0].data_ptr(), kv[1].data_ptr(),
                acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, n, nk)
        tail = (d, q.stride(0), q.stride(1), nk * d, d, nk * d, d,
                acc.stride(0), acc.stride(1), d ** -0.5, 1, stream)
        if fused:
            err = lib.tz_attn_fused(*head, blk, *tail)
        else:
            err = lib.tz_attn_block(*head, *tail)
        if err:
            raise RuntimeError(f"ablation launch failed with cudaError {err}")

    return (lambda: call(kv_all, nkv, True)), (lambda: call(kv_blk, blk, False))


def ablate(torch, device, rounds: int = 2) -> List[dict]:
    """Build each :data:`ABLATIONS` variant of csrc/attn_fold.cu beside the
    source as it is and time all of them at the main path's shapes."""
    import ctypes
    import tempfile
    from pathlib import Path

    from tenzing_tpu_torch.ops import kernel_lib

    src = (kernel_lib.CSRC / "attn_fold.cu").read_text()
    kernel_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=kernel_lib.BUILD_DIR))
    procs = {}
    for name, edits in {"kernel": [], **ABLATIONS}.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ablation {name}: source text not found")
            text = text.replace(old, new)
        cu, so = work / f"{name}.cu", work / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [kernel_lib.nvcc(), *kernel_lib.ARCH_FLAGS,
             *kernel_lib.COMPILE_FLAGS, "-shared", "-I", str(kernel_lib.CSRC),
             str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablation {name} failed to build:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn in ("tz_attn_fused", "tz_attn_block"):
            getattr(lib, fn).argtypes = kernel_lib.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    rows = []
    for rnd in range(rounds):
        for name, lib in libs.items():
            fused, block = _main_shape_calls(torch, device, lib)
            rows.append({"ablation": name, "round": rnd,
                         "fused_ms": cuda_ms(torch, fused),
                         "block_ms": cuda_ms(torch, block)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ablate", action="store_true",
                    help="also time the source's ablation variants")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("attn_bf16: no CUDA device\n")
        return 2
    from tenzing_tpu_torch.ops import kernel_lib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    kernel_lib.lib()
    report = ptxas_report(str(kernel_lib.build_info.get("ptxas", "")))
    mismatch = config_mismatch(4, 8192, 8192, 1024)
    print(json.dumps({"build_s": kernel_lib.build_info.get("seconds"),
                      "ptxas": report, "config": library_config(),
                      "config_mismatch": mismatch}), flush=True)
    device = torch.device("cuda", 0)
    failed = [] if not mismatch else ["config"]
    for name in STRESS_CASES:
        ok, info = run_case(torch, device, name)
        print(json.dumps({"case": name, "ok": ok, **info}), flush=True)
        if not ok:
            failed.append(name)
    print(json.dumps(x8qk_vs_f64(torch, device)), flush=True)
    if args.ablate:
        for row in ablate(torch, device):
            print(json.dumps(row), flush=True)
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
