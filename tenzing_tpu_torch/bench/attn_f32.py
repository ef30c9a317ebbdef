"""The f32 attention fold kernel (``attn_fold_f32``, split-TF32 on ``wgmma``)
on the card.

``python -m tenzing_tpu_torch.bench.attn_f32 [--sass] [--ablate]``

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernel library and prints what ``ptxas -v`` reported for
   ``attn_fold_f32`` and for ``fused_region``'s attention instantiation
   (registers, spills, ``setmaxnreg`` warnings and ptxas's notes that it
   serialized ``wgmma`` instructions), and holds the launch constants of
   :func:`ops.attention_kernels.f32_launch_plan` against the library's
   ``tz_attn_f32_config``;
3. runs every case of :data:`STRESS_CASES` (the card tests run the same
   ones) and :func:`run_region_case` against the plain versions on the same
   inputs at ``F32_STATE_TOL``;
4. at the main path's shape (4, 8192 queries, 8192 keys, d 128) holds the
   kernel, :func:`tf32_fold_plain` with three passes and with one pass (the
   single-TF32 control, which must fail) against the plain fold, and O
   against the dense float64 attention;
5. with ``--sass``, where the spill instructions (STL / LDL) of each
   instantiation sit in its SASS: inside the consumers' key-tile loop (the
   innermost loop that holds every ``HGMMA``), in a loop around it, in
   another loop, or outside all loops (:func:`attn_common.spill_placement`);
6. with ``--ablate``, where the kernel's time goes at the main path's
   shapes (all 8192 keys, and one 1024-key block): the source built again
   with one part changed (:data:`ABLATIONS`: no lo terms, i.e. one TF32
   pass, which is also held against the plain fold and must fail; no P V;
   no exp; ``expf`` per element; no tensor-core products at all; the
   producer storing zeros instead of loading K / V; the registers split
   224 / 56 between the consumer and producer warps instead of 216 / 72; a
   tile's V loads in flight beside its K), each variant's time and ptxas
   report beside the kernel's,
   in alternating rounds in one process (CUDA events, the median of single
   launches, each after a 128 MB L2 flush).

One JSON object per line.  It needs a CUDA device; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from tenzing_tpu_torch.bench import attn_common as common
from tenzing_tpu_torch.bench.attn_common import HEAD_DIM, MAIN_SHAPE, case_inputs
from tenzing_tpu_torch.utils.cli import write_line

# the dense and the strided instantiation of attn_fold_f32, and the fused
# region's attention kernel, as their names appear in ptxas's and
# cuobjdump's reports
KERNELS = ("attn_fold_f32ILb1", "attn_fold_f32ILb0", "fused_region_attn_kernel")
CONFIG_ENTRY = "tz_attn_f32_config"

# name -> (kernel, b, n, nkv, bkv, state, layout) of
# :func:`attn_common.run_case`:
# one key tile from the -1e30 init, nkv not a multiple of the 32-key tile,
# n not a multiple of the CTA's 128 rows, both ragged, several kv blocks,
# strided views (Q/K/V with row strides of 2 d, K/V a key range of a longer
# tensor) and q scaled by 8
STRESS_CASES: Dict[str, Tuple[str, int, int, int, int, str, str]] = {
    "tile-32-init": ("block", 1, 128, 32, 32, "init", "dense"),
    "nkv-not-tile": ("block", 2, 256, 1000, 1000, "mid", "dense"),
    "n-not-128": ("block", 2, 200, 384, 384, "mid", "dense"),
    "ragged-both": ("block", 1, 1000, 1000, 1000, "init", "dense"),
    "fused-bkv256": ("fused", 2, 256, 1024, 256, "init", "dense"),
    "strided": ("block", 2, 256, 512, 512, "mid", "strided"),
    "fused-strided": ("fused", 2, 256, 1024, 256, "init", "strided"),
    "x8": ("fused", 2, 256, 1024, 256, "mid", "x8"),
}

# a fused-region fold whose keys start at key_off (not a tile boundary of
# the region's K/V) over a share of rows that is not a multiple of 128
REGION_CASE = dict(b=2, n=300, kv_rows=1024, key_off=384, nkv=300, tiles=2)

# --ablate: name -> [(text of csrc/attn_fold_f32.cuh, its replacement)]
ABLATIONS = {
    "no-lo": [
        ("""#pragma unroll
  for (int kk = 0; kk < kHeadDim / 8; ++kk) mma_rs<true>(s, qh[kk], k_desc(klo, kk));
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 8; ++kk)
    mma_s_ss(s, q_desc(qlo, kk), k_desc(khi, kk));
""", ""),
        ("""#pragma unroll
    for (int kk = 0; kk < kKeyTile / 8; ++kk) mma_rs<true>(t, ph[kk], v_desc(cl, kk));
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 8; ++kk) mma_rs<true>(t, pl[kk], v_desc(ch, kk));
""", "")],
    # the registers split 224 / 56 between consumer and producer warps
    "regs-224": [("constexpr int kProducerRegs = 72;",
                  "constexpr int kProducerRegs = 56;"),
                 ("constexpr int kConsumerRegs = 216;",
                  "constexpr int kConsumerRegs = 224;")],
    # a tile's V loads in flight with its K (before the K stores), the
    # registers split 208 / 88
    "v-early": [("""    store_k(sm, kr, xk, pt);
    load_v(xv, v, v_sr, kv0, nkv, pt);""", """    load_v(xv, v, v_sr, kv0, nkv, pt);
    store_k(sm, kr, xk, pt);"""),
                ("constexpr int kProducerRegs = 72;",
                 "constexpr int kProducerRegs = 88;"),
                ("constexpr int kConsumerRegs = 216;",
                 "constexpr int kConsumerRegs = 208;")],
    # no S = Q K^T and no P V on the tensor cores: the ring and the softmax
    "no-mma": [("    scores(s, qh, qb, k_base + kr.stage * kStageBytes);",
                "    for (int i = 0; i < 16; ++i) s[i] = __uint_as_float(qb & 0xff) * i;"),
               ("fold_pv(o, ph, pl, v_base + vr.stage * kStageBytes);",
                "{ uint32_t x = 0;\n"
                "  for (int i = 0; i < kKeyTile / 8; ++i)\n"
                "    x ^= ph[i][0] ^ ph[i][1] ^ ph[i][2] ^ ph[i][3] ^ pl[i][0];\n"
                "  o[0] += __uint_as_float(x & 0x3f800000u); }")],
    # the producer stores zeros instead of loading K / V
    "no-kv-loads": [
        ("""    x[i] = kv0 + r < nkv
               ? __ldg(reinterpret_cast<const float4*>(
                           k + (int64_t)(kv0 + r) * k_sr) + c)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);""",
         """    x[i] = make_float4(0.0f, 0.0f, 0.0f, (float)(kv0 + r));"""),
        ("""      x[h][j] = key < nkv ? __ldg(v + (int64_t)key * v_sr + pt) : 0.0f;""",
         """      x[h][j] = (float)key;""")],
    "no-pv": [("fold_pv(o, ph, pl, v_base + vr.stage * kStageBytes);",
               "{ uint32_t x = 0;\n"
               "  for (int i = 0; i < kKeyTile / 8; ++i)\n"
               "    x ^= ph[i][0] ^ ph[i][1] ^ ph[i][2] ^ ph[i][3] ^ pl[i][0];\n"
               "  o[0] += __uint_as_float(x & 0x3f800000u); }")],
    "no-exp": [(f"exp2f(__fmaf_rn(x{r}, scale2, -ml_{r}))",
                f"__fmaf_rn(x{r}, scale2, -ml_{r})") for r in "ab"],
    "expf": [(f"exp2f(__fmaf_rn(x{r}, scale2, -ml_{r}))",
              f"expf(__fsub_rn(__fmul_rn(x{r}, scale2 / kLog2e), "
              f"ml_{r} / kLog2e))") for r in "ab"],
}
# the variants whose outputs are held against the plain fold (and must fail)
CHECKED_ABLATIONS = ("no-lo",)


def split_tf32(torch, x):
    """(hi, lo) of float32 ``x`` as the kernel splits it (csrc/hopper.cuh
    ``split``): hi = x rounded to TF32 (10 mantissa bits, to nearest with
    ties away from zero: add half of the 13 dropped bits to the magnitude,
    then clear them; the carry turns a NaN whose top mantissa bits are set
    into a zero), lo = x - hi rounded the same way but with infinities and
    NaNs unchanged (cvt.rna.tf32.f32), so a NaN x has a NaN lo.  Integer
    operations on the bits, so it holds on any device."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        out = (bits + 0x1000) & -0x2000  # 0xFFFFE000 as an int32
        return out, bits

    hi, _ = rna(x)
    hi = hi.view(torch.float32)
    lo, bits = rna(x - hi)
    lo = torch.where(bits & 0x7F800000 == 0x7F800000, bits, lo)
    return hi, lo.view(torch.float32)


def tf32_fold_plain(torch, q, k, v, state, scale: float, passes: int = 3):
    """The kernel's arithmetic in plain PyTorch: the fold of all keys of
    k / v into ``state`` (acc, m, l), in place, with every product split
    into TF32 parts, ``passes`` = 3 (hi hi + hi lo + lo hi, what the kernel
    computes) or 1 (hi hi alone: the single-TF32 control).  The split
    products are exact in float32 and summed in float32 (no TF32 in the
    matmuls themselves)."""
    acc, m, l = state

    def prod(a, b):
        ah, al = split_tf32(torch, a)
        bh, bl = split_tf32(torch, b)
        out = torch.bmm(ah, bh)
        if passes == 3:
            out += torch.bmm(ah, bl)
            out += torch.bmm(al, bh)
        return out

    s = prod(q, k.transpose(1, 2).contiguous()).mul_(scale)
    mn = torch.maximum(m[..., :1], s.amax(-1, keepdim=True))
    alpha = torch.exp(m[..., :1] - mn)
    s.sub_(mn).exp_()  # p
    l_new = l[..., :1] * alpha + s.sum(-1, keepdim=True)
    acc_new = acc * alpha + prod(s, v.contiguous())
    del s
    acc.copy_(acc_new)
    m.copy_(mn.expand_as(m))
    l.copy_(l_new.expand_as(l))


def run_case(torch, device, name: str) -> Tuple[bool, dict]:
    """One stress case against the plain version at ``F32_STATE_TOL``."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    return common.run_case(torch, device, STRESS_CASES[name],
                           ak.F32_STATE_TOL, bf16=False)


def region_members(b, n, kv_rows, key_off, nkv, d=HEAD_DIM):
    """A fused region of one fold (keys key_off .. key_off + nkv of a
    (b, kv_rows, d) K/V into a (b, n, d) state) and the finalize."""
    from tenzing_tpu_torch.ops.fused_region import OPERANDS, MemberBody

    fold = MemberBody("attn_fold", OPERANDS["attn_fold"], n, 0, False, outer=b,
                      inner=d, kv_rows=kv_rows, key_off=key_off, nkv=nkv,
                      scale=d ** -0.5)
    fin = MemberBody("attn_finalize", ("acc", "l", "o"), n, 0, True, outer=b,
                     inner=d)
    return [fold, fin]


def run_region_case(torch, device) -> Tuple[bool, dict]:
    """:data:`REGION_CASE` through ``fused_region`` against the plain region
    at ``F32_STATE_TOL`` (state and O), and against a control whose keys
    start one tile later (it must fail)."""
    import dataclasses

    from tenzing_tpu_torch.ops import attention_kernels as ak
    from tenzing_tpu_torch.ops import fused_region as fr

    c = REGION_CASE
    q, k, v, st = case_inputs(torch, device, c["b"], c["n"], c["kv_rows"],
                              "mid", "dense", seed=4)
    bufs = {"q": q.contiguous(), "k": k, "v": v, "acc": st[0], "m": st[1],
            "l": st[2], "o": torch.zeros_like(st[0])}
    members = region_members(c["b"], c["n"], c["kv_rows"], c["key_off"], c["nkv"])
    control = [dataclasses.replace(members[0], key_off=c["key_off"] + 32),
               members[1]]
    outs = {}
    for label, mbs, plain in (("kernel", members, False),
                              ("plain", members, True),
                              ("control", control, False)):
        b = {n: (t.clone() if n in ("acc", "m", "l", "o") else t)
             for n, t in bufs.items()}
        table = fr.RegionTable(mbs, c["tiles"])
        if plain:
            fr.region_plain(table.members, b, table.tiles)
        else:
            counters = (torch.zeros(2 * c["tiles"], dtype=torch.int32,
                                    device=device)
                        if device.type == "cuda" else None)
            fr.fused_region(table, b, counters)
        outs[label] = b
    if device.type == "cuda":
        torch.cuda.synchronize()
    names = ("acc", "m", "l")
    res = {}
    for label in ("kernel", "control"):
        ok, errs = ak.state_check([outs[label][n] for n in names],
                                  [outs["plain"][n] for n in names],
                                  ak.F32_STATE_TOL)
        ok = ok and bool(torch.allclose(outs[label]["o"], outs["plain"]["o"],
                                        **ak.F32_STATE_TOL["acc/l"]))
        res[label] = {"within_tol": ok, "errors": errs}
    good = res["kernel"]["within_tol"] and not res["control"]["within_tol"]
    return good, res


def main_shape_check(torch, device) -> Tuple[bool, dict]:
    """The fused fold at the main path's shape: the kernel and the
    three-pass emulation must be within ``F32_STATE_TOL`` of the plain fold,
    the single-pass emulation must not be; O = acc / l of each beside the
    dense float64 attention."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    b, n, nkv, bkv = MAIN_SHAPE
    q, k, v, st = case_inputs(torch, device, b, n, nkv, "init", "dense")
    scale = HEAD_DIM ** -0.5
    want = [t.clone() for t in st]
    ak.attn_fused_plain(q, k, v, *want, scale, bkv)
    states = {}
    got = [t.clone() for t in st]
    ak.attn_fused(q, k, v, *got, scale, bkv=bkv)
    states["kernel"] = got
    for passes in (3, 1):
        emu = [t.clone() for t in st]
        tf32_fold_plain(torch, q, k, v, emu, scale, passes)
        states[f"tf32_{passes}pass"] = emu
    exact = dense_o_f64(torch, q, k, v, scale)
    torch.cuda.synchronize()
    out = {}
    for label, s in states.items():
        ok, errs = ak.state_check(s, want, ak.F32_STATE_TOL)
        o = s[0] / s[2]
        out[label] = {"within_tol": ok, "errors": errs,
                      "o_vs_f64_max_abs": float((o - exact).abs().max())}
    good = (out["kernel"]["within_tol"] and out["tf32_3pass"]["within_tol"]
            and not out["tf32_1pass"]["within_tol"])
    return good, out


def dense_o_f64(torch, q, k, v, scale):
    """Softmax attention in float64, one batch element at a time."""
    outs = []
    for i in range(q.shape[0]):
        qi, ki, vi = (t[i].double() for t in (q, k, v))
        outs.append((torch.softmax(qi @ ki.T * scale, -1) @ vi).float())
    return torch.stack(outs)


def library_config() -> dict:
    """The f32 kernel's launch constants as the built library reports."""
    return common.library_config(CONFIG_ENTRY)


def config_mismatch(b, n, nkv) -> dict:
    """Keys where :func:`f32_launch_plan` and the library disagree."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    return common.config_mismatch(ak.f32_launch_plan(b, n, nkv, HEAD_DIM),
                                  CONFIG_ENTRY)


def ptxas_reports(text: str) -> dict:
    """:func:`attn_common.ptxas_report` of each f32 instantiation."""
    return {name: common.ptxas_report(text, name) for name in KERNELS}


def ablate(torch, device, rounds: int = 2) -> List[dict]:
    """Build each :data:`ABLATIONS` variant of csrc/attn_fold_f32.cuh (with
    attn_fold.cu beside it): their ptxas reports, the
    :data:`CHECKED_ABLATIONS` held against the plain fold, then all the
    variants' times at the main path's shapes."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    libs, rows = common.build_variants("attn_fold_f32.cuh", ABLATIONS,
                                       KERNELS[0])
    for name in CHECKED_ABLATIONS:
        _, _, fold_all, (q, k, v, st) = common.main_shape_calls(
            torch, device, libs[name], bf16=False)
        got, want = [t.clone() for t in st], [t.clone() for t in st]
        fold_all(got)
        ak.attn_fused_plain(q, k, v, *want, HEAD_DIM ** -0.5, MAIN_SHAPE[3])
        torch.cuda.synchronize()
        ok, errs = ak.state_check(got, want, ak.F32_STATE_TOL)
        rows.append({"ablation": name, "check": "vs plain fold",
                     "within_tol": ok, "errors": errs})
        del got, want, q, k, v, st
    return rows + common.time_variants(torch, device, libs, False, rounds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ablate", action="store_true",
                    help="also time the source's ablation variants")
    ap.add_argument("--sass", action="store_true",
                    help="also report where each instantiation's spill "
                         "instructions sit in its SASS (cuobjdump)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("attn_f32: no CUDA device\n")
        return 2
    from tenzing_tpu_torch.ops import kernel_lib

    common.device_line(torch)
    kernel_lib.lib()
    report = ptxas_reports(str(kernel_lib.build_info.get("ptxas", "")))
    mismatch = config_mismatch(*MAIN_SHAPE[:3])
    write_line(json.dumps({"build_s": kernel_lib.build_info.get("seconds"),
                           "ptxas": report, "config": library_config(),
                           "config_mismatch": mismatch}))
    if args.sass:
        write_line(json.dumps({"sass_spills": common.sass_spills(KERNELS)}))
    device = torch.device("cuda", 0)
    failed = [] if not mismatch else ["config"]
    common.run_checks(
        [(name, lambda name=name: run_case(torch, device, name))
         for name in STRESS_CASES]
        + [("region-key-off", lambda: run_region_case(torch, device)),
           ("main-shape", lambda: main_shape_check(torch, device))], failed)
    if args.ablate:
        for row in ablate(torch, device):
            write_line(json.dumps(row))
            if row.get("check") and row["within_tol"]:
                failed.append(f"ablation {row['ablation']} passed the check")
    write_line(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
