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
   are timed only), each variant's ptxas report and time beside the
   kernel's, K/V already cast, in alternating rounds in one process (CUDA events, the
   median of single launches, each after a 128 MB L2 flush).

One JSON object per line.  It needs a CUDA device; exits 1 if a case fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from tenzing_tpu_torch.bench import attn_common as common
from tenzing_tpu_torch.bench.attn_common import HEAD_DIM, case_inputs
from tenzing_tpu_torch.utils.cli import write_line

KERNEL = "attn_fold_bf16"
CONFIG_ENTRY = "tz_attn_bf16_config"

# name -> (kernel, b, n, nkv, bkv, state, layout) of
# :func:`attn_common.run_case`: "x8" scales q by 8, so s spans 8 times its
# range (the max and exp path at large exponents).  With q and k both scaled (s at 64 times its range) the
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


def run_case(torch, device, name: str) -> Tuple[bool, dict]:
    """One stress case against the plain version at ``BF16_STATE_TOL``."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    return common.run_case(torch, device, STRESS_CASES[name],
                           ak.BF16_STATE_TOL, bf16=True)


def ptxas_report(text: str) -> dict:
    """:func:`attn_common.ptxas_report` of ``attn_fold_bf16``."""
    return common.ptxas_report(text, KERNEL)


def library_config() -> dict:
    """The bf16 kernel's launch constants as the built library reports."""
    return common.library_config(CONFIG_ENTRY)


def config_mismatch(b, n, nkv, bkv) -> dict:
    """Keys where :func:`bf16_launch_plan` and the library disagree."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    return common.config_mismatch(
        ak.bf16_launch_plan(b, n, nkv, bkv, HEAD_DIM), CONFIG_ENTRY)


def ablate(torch, device, rounds: int = 2) -> List[dict]:
    """Build each :data:`ABLATIONS` variant of csrc/attn_fold.cu beside the
    source as it is; their ptxas reports, then their times at the main
    path's shapes with K/V already cast."""
    libs, rows = common.build_variants("attn_fold.cu", ABLATIONS, KERNEL)
    return rows + common.time_variants(torch, device, libs, True, rounds)


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

    common.device_line(torch)
    kernel_lib.lib()
    report = ptxas_report(str(kernel_lib.build_info.get("ptxas", "")))
    mismatch = config_mismatch(*common.MAIN_SHAPE)
    write_line(json.dumps({"build_s": kernel_lib.build_info.get("seconds"),
                           "ptxas": report, "config": library_config(),
                           "config_mismatch": mismatch}))
    device = torch.device("cuda", 0)
    failed = [] if not mismatch else ["config"]
    common.run_checks([(name, lambda name=name: run_case(torch, device, name))
                       for name in STRESS_CASES], failed)
    write_line(json.dumps(x8qk_vs_f64(torch, device)))
    if args.ablate:
        for row in ablate(torch, device):
            write_line(json.dumps(row))
    write_line(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
