"""The ELL SpMV kernel (csrc/ell_spmv.cu, row 15) on the card: its time,
the floor under it, and where the rest goes.

``python -m tenzing_tpu_torch.bench.ell_spmv [--ablate] [--parent DIR]
[--rounds N]``

1. prints the card's name and power limit (``nvidia-smi``);
2. checks the kernel at the ``--m 8192`` path's ``spmv_remote`` slab (a
   (8192, 22) slab, x of 4093: the driver's buffers) and at :data:`CASES`
   (ragged m, w from 1 to 40, n = 1, 4093, 4096, signed values, slab views
   4 and 104 bytes off 16): y against the float64 product within the
   rounding bound of the kernel's order (``row_sum_bound``) and against the
   plain version at ``ELL_TOL`` (reported; the main slab must pass it), two
   launches bit for bit, and a control with one slab column dropped
   rejected by both;
3. times at the main shape, after a 128 MB write flush (``ms``, as
   chip_smoke.py's timer) and after a read flush (``clean_ms``;
   ``bench/halo_kernels.both_ms``), and warm (no flush, ``warm_ms``): the
   kernel, an empty launch of its grid (``tz_ell_spmv_floor``: the floor),
   cuSPARSE (``torch.sparse_csr_tensor(...).matmul(x)``) and, with
   ``--parent DIR``, an older checkout's kernel (``git archive`` of the
   parent into a gitignored directory), in alternating rounds, beside the
   bytes bound;
4. with ``--ablate``, csrc/ell_spmv.cu built again with one part of it or
   of csrc/ell_row.cuh changed (:data:`ABLATIONS`): 16 or 32 x gathers in
   flight, one or four warps a block, no staging (every row read from
   global memory), x through L2 (``ld.global.cg``) instead of the
   read-only path; each checked and timed the same way.

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
from tenzing_tpu_torch.bench.halo_kernels import FLUSH_FLOATS, both_ms
from tenzing_tpu_torch.utils.cli import write_line

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
MAIN_M = 8192
# (m, w, n, slab offset in floats): ragged m, w = 1 ... 40 (a warp's piece
# ragged, rows wider than the staged width), n = 1 and the gate's edge,
# slab views 4 and 104 bytes off a 16-byte boundary
CASES = [(1000, 23, 4093, 0), (37, 5, 300, 0), (64, 1, 50, 0), (50, 7, 1, 0),
         (513, 12, 4096, 0), (9, 40, 128, 0), (1001, 22, 4093, 0),
         (777, 32, 4096, 0), (300, 33, 4093, 0), (1000, 22, 4093, 1),
         (1000, 26, 4093, 26)]

# the files a build of the kernel reads: the source and the row sum's header
FILES = ("ell_spmv.cu", "ell_row.cuh")
# --ablate: name -> [(file, its text, the replacement)]
ABLATIONS: Dict[str, List[Tuple[str, str, str]]] = {
    "x_batch_16": [("ell_row.cuh", "constexpr int kXBatch = 8;",
                    "constexpr int kXBatch = 16;")],
    "x_batch_32": [("ell_row.cuh", "constexpr int kXBatch = 8;",
                    "constexpr int kXBatch = 32;")],
    "warps_1": [("ell_spmv.cu", "constexpr int kWarps = 2;",
                 "constexpr int kWarps = 1;")],
    "warps_4": [("ell_spmv.cu", "constexpr int kWarps = 2;",
                 "constexpr int kWarps = 4;")],
    # every row read from global memory (no staging in shared memory)
    "unstaged": [("ell_spmv.cu", "  const bool staged = w <= kSlabWidth &&",
                  "  const bool staged = false && w <= kSlabWidth &&")],
    "x_through_l2": [("ell_spmv.cu", "tz_ell::row_sum<tz_ell::kShared, false>",
                      "tz_ell::row_sum<tz_ell::kShared, true>"),
                     ("ell_spmv.cu", "tz_ell::row_sum<tz_ell::kGlobal, false>",
                      "tz_ell::row_sum<tz_ell::kGlobal, true>")],
}
# the variants that change the summation order (checked against the
# float64 bound of their own order)
X_BATCH = {"x_batch_16": 16, "x_batch_32": 32}


def bound_ms(nbytes: float) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def warm_ms(torch, fn, reps: int = 15) -> float:
    """Median CUDA-event time of single calls of ``fn`` behind a spin, with
    no flush: the inputs stay in L2 from the call before."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def main_slab(torch, device):
    """(vals, cols, x, csr) of the --m 8192 path's spmv_remote member: the
    driver's slab and its x_remote, and the same matrix as CSR."""
    import numpy as np

    from tenzing_tpu_torch.models import spmv

    bufs, _ = spmv.make_spmv_buffers(m=MAIN_M, nnz_per_row=10, seed=0)
    a = spmv.random_band_matrix(MAIN_M, MAIN_M // 8, 10 * MAIN_M, seed=0)
    remote = spmv.split_local_remote(a, 0, MAIN_M // 2).remote
    x = bufs["x_local"][bufs["send_idx"]]
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(remote.indptr.astype(np.int64)),
        torch.from_numpy(remote.cols.astype(np.int64)),
        torch.from_numpy(remote.vals), size=(remote.m, remote.n)).to(device)
    vals, cols, xt = (torch.from_numpy(np.ascontiguousarray(t)).to(device)
                      for t in (bufs["A_rem_vals"], bufs["A_rem_cols"], x))
    return vals, cols, xt, csr


def case_inputs(torch, device, m, w, n, off, seed=0):
    """Signed standard-normal vals and x, uniform cols, the slab ``off``
    floats into larger buffers (its data pointer 4 off bytes in)."""
    import numpy as np

    rng = np.random.default_rng(seed + m + w + n)
    vals = rng.standard_normal((m, w)).astype(np.float32)
    cols = rng.integers(0, n, size=(m, w)).astype(np.int32)
    x = rng.standard_normal(n).astype(np.float32)

    def placed(host):
        flat = torch.zeros(host.size + off, dtype=torch.from_numpy(host).dtype,
                           device=device)
        flat[off:] = torch.from_numpy(host.ravel()).to(device)
        return flat[off:].view(host.shape)

    return placed(vals), placed(cols), torch.from_numpy(x).to(device)


def call(torch, lib, vals, cols, x, y):
    """A closure running ``lib``'s ``tz_ell_spmv`` (or the wrapper, for
    lib None) into y."""
    from tenzing_tpu_torch.ops import spmv_kernels as sk

    if lib is None:
        return lambda: sk.ell_spmv(vals, cols, x, out=y)
    stream = torch.cuda.current_stream().cuda_stream
    m, w = vals.shape

    def run():
        err = lib.tz_ell_spmv(vals.data_ptr(), cols.data_ptr(), x.data_ptr(),
                              y.data_ptr(), m, w, x.shape[0], stream)
        if err:
            raise RuntimeError(f"ell_spmv: launch failed with cudaError {err}")
    return run


def check_case(torch, run_lib, label, vals, cols, x, x_batch=8) -> dict:
    """y of ``run_lib`` against the float64 bound and the plain version,
    two launches, the dropped-column control."""
    from tenzing_tpu_torch.ops import spmv_kernels as sk

    y = torch.empty(vals.shape[0], device=vals.device)
    again = torch.empty_like(y)
    call(torch, run_lib, vals, cols, x, y)()
    call(torch, run_lib, vals, cols, x, again)()
    want = sk.ell_spmv_plain(vals, cols, x)
    y64, bound = sk.row_sum_bound(vals, cols, x, x_batch)
    w = vals.shape[1]
    ctl = (sk.ell_spmv_plain(vals[:, :-1].contiguous(), cols[:, :-1].contiguous(), x)
           if w > 1 else torch.zeros_like(want))
    torch.cuda.synchronize()
    within = bool(((y.double() - y64).abs() <= bound).all())
    return {"case": label, "shape": [*vals.shape, int(x.shape[0])],
            "slab_ptr_mod_16": vals.data_ptr() % 16,
            "finite": bool(torch.isfinite(y).all()),
            "max_abs_err": float((y - want).abs().max()),
            "within_ell_tol": bool(torch.allclose(y, want, **sk.ELL_TOL)),
            "within_f64_bound": within,
            "f64_max_abs_err": float((y.double() - y64).abs().max()),
            "deterministic": bool(torch.equal(y, again)),
            "control_rejected": not bool(((ctl.double() - y64).abs() <= bound).all())
            and not torch.allclose(ctl, want, **sk.ELL_TOL)}


def build(csrc: Path, ablations: Dict[str, List[Tuple[str, str, str]]],
          tag: str) -> Dict[str, ctypes.CDLL]:
    """csrc/ell_spmv.cu of ``csrc`` as it is (``kernel``) and with each of
    ``ablations``, each a shared library of its own built from a directory
    holding that version of :data:`FILES` (an older checkout may lack the
    header), all ``nvcc`` processes started together."""
    from tenzing_tpu_torch.ops import kernel_lib

    texts = {f: (csrc / f).read_text() for f in FILES if (csrc / f).exists()}
    kernel_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"ell_spmv_{tag}_",
                                 dir=kernel_lib.BUILD_DIR))
    procs = {}
    for name, edits in {"kernel": [], **ablations}.items():
        (work / name).mkdir()
        for f, text in texts.items():
            text = common.apply_edits(
                text, [(old, new) for ef, old, new in edits if ef == f], name)
            (work / name / f).write_text(text)
        src = work / name / "ell_spmv.cu"
        so = work / name / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kernel_lib.nvcc(), *kernel_lib.ARCH_FLAGS, *kernel_lib.COMPILE_FLAGS,
             "-shared", str(src), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} {name} failed to build:\n{out}")
        write_line(json.dumps({"version": tag, "variant": name,
                               "ptxas": common.ptxas_report(out, "ell_spmv_kernel")}))
        lib = ctypes.CDLL(str(so))
        lib.tz_ell_spmv.argtypes = kernel_lib.SIGNATURES["tz_ell_spmv"]
        lib.tz_ell_spmv.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ablate", action="store_true",
                    help="also check and time csrc/ell_spmv.cu's variants")
    ap.add_argument("--parent", metavar="DIR",
                    help="an older checkout whose kernel is timed beside "
                         "this one's")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("ell_spmv: no CUDA device\n")
        return 2
    from tenzing_tpu_torch.ops import kernel_lib
    from tenzing_tpu_torch.ops import spmv_kernels as sk

    common.device_line(torch)
    kernel_lib.lib()
    device = torch.device("cuda", 0)
    failed = []
    variants = {"this": None}  # the wrapper
    if args.ablate:
        variants.update({f"this/{k}": v for k, v in build(
            kernel_lib.CSRC, ABLATIONS, "this").items() if k != "kernel"})
    if args.parent:
        variants["parent"] = build(Path(args.parent) / "tenzing_tpu_torch"
                                   / "csrc", {}, "parent")["kernel"]
    vals, cols, x, csr = main_slab(torch, device)
    inputs = [("m8192-spmv_remote", vals, cols, x)]
    inputs += [(f"m{m}-w{w}-n{n}" + (f"-off{o}" if o else ""),
                *case_inputs(torch, device, m, w, n, o)) for m, w, n, o in CASES]
    for tag, lib in variants.items():
        xb = X_BATCH.get(tag.split("/")[-1], 8)
        for label, v, c, xx in inputs:
            row = {"version": tag, **check_case(torch, lib, label, v, c, xx, xb)}
            write_line(json.dumps(row))
            main_bad = label.startswith("m8192") and not row["within_ell_tol"]
            bad = not (row["within_f64_bound"] and row["deterministic"]
                       and row["control_rejected"]) or main_bad
            if bad and tag != "parent":  # the parent's order is its own
                failed.append(f"{tag}/{label}")
    m, w = vals.shape
    nbytes = sk.ell_bytes(m, w, x.shape[0])
    y = torch.empty(m, device=device)
    flush = torch.empty(FLUSH_FLOATS, device=device)
    calls = {tag: call(torch, lib, vals, cols, x, y)
             for tag, lib in variants.items()}
    calls["floor"] = lambda: sk.ell_floor(m, device)
    calls["cusparse"] = lambda: csr.matmul(x)
    for rnd in range(args.rounds):
        names = list(calls) if rnd % 2 == 0 else list(calls)[::-1]
        for name in names:
            t = both_ms(torch, calls[name], flush)
            write_line(json.dumps({"round": rnd, "call": name, "shape": [m, w, int(x.shape[0])],
                                   **t, "warm_ms": warm_ms(torch, calls[name]),
                                   "bytes": nbytes, "bound_ms": bound_ms(nbytes)}))
    write_line(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
