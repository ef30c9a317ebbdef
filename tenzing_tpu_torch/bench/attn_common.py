"""What the attention fold benches (``bench/attn_bf16.py``,
``bench/attn_f32.py``) share: seeded inputs, the stress-case runner, the
``ptxas -v`` and SASS reports, the launch-constant check against the
library, and the ablation machinery (build variants of one source file,
time them at the main path's shapes).  Nothing here runs at import time;
everything that touches the card takes ``torch`` and a device."""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

from tenzing_tpu_torch.utils.cli import write_line

HEAD_DIM = 128
MAIN_SHAPE = (4, 8192, 8192, 1024)  # b, n, nkv, the block chain's keys
CONFIG_KEYS = ("rows_per_cta", "key_tile", "k_stages", "v_stages", "threads",
               "smem_bytes")  # out[] of tz_attn_{bf16,f32}_config


def case_inputs(torch, device, b, n, nkv, state, layout, seed=0):
    """Seeded q, k, v and a state (acc, m, l) on ``device``.  ``state``:
    "init" (acc 0, m -1e30, l 0) or "mid" (random, l in [1, 4)).
    ``layout``: "dense", "strided" (Q, K and V are views with row strides of
    2 d and K/V a key range of a longer tensor, as the block chain passes
    them), "x8" (q scaled by 8) or "x8qk" (q and k scaled by 8)."""
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


def run_case(torch, device, case: Tuple, tol: dict,
             bf16: bool) -> Tuple[bool, dict]:
    """One stress case ``(kernel, b, n, nkv, bkv, state, layout)``: the
    wrapper (``kernel`` "block" folds all nkv keys as one block, "fused" in
    blocks of bkv) against its plain version on the same inputs, held at
    ``tol``.  Returns (ok, errors)."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    kernel, b, n, nkv, bkv, state, layout = case
    q, k, v, st = case_inputs(torch, device, b, n, nkv, state, layout)
    got, want = [t.clone() for t in st], [t.clone() for t in st]
    scale = HEAD_DIM ** -0.5
    if kernel == "block":
        ak.attn_block(q, k, v, *got, scale, bf16_inputs=bf16)
        ak.attn_block_plain(q, k, v, *want, scale, bf16_inputs=bf16)
    else:
        ak.attn_fused(q, k, v, *got, scale, bkv=bkv, bf16_inputs=bf16)
        ak.attn_fused_plain(q, k, v, *want, scale, bkv, bf16_inputs=bf16)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ok, errs = ak.state_check(got, want, tol)
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    return ok and finite, {"errors": errs, "finite": finite}


def ptxas_report(text: str, kernel: str) -> dict:
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


_SASS_INST = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_BRA = re.compile(r"\bBRA(?:\.\w+)*\s+(?:.*?)0x([0-9a-f]+)")
_SASS_SPILL = re.compile(r"^(?:@!?U?P[T\d]+\s+)?(STL|LDL)\b")


def spill_placement(sass: str, kernel: str) -> dict:
    """Where the local-memory spill instructions (STL / LDL) of ``kernel``
    sit in ``cuobjdump -sass`` text.  A loop is a backward branch and the
    instructions between its target and it.  The consumers' key-tile loop
    is the innermost loop that holds every ``HGMMA`` of the function; the
    producer's is the innermost loop without ``HGMMA`` that holds both
    global loads (``LDG``) and shared stores (``STS``).  Each spill
    instruction is counted by its innermost enclosing loop: ``consumer_loop``
    or ``producer_loop`` (those loops themselves), ``around_loops`` (a loop
    holding one of them: once per pass of it, e.g. per item or member),
    ``other_loop`` or ``straight`` (in no loop)."""
    funcs = re.split(r"\n\s*Function : ", "\n" + sass)
    body = next((f for f in funcs[1:] if kernel in f.split("\n", 1)[0]), None)
    out = {"found": body is not None}
    if body is None:
        return out
    insts = [(int(m.group(1), 16), m.group(2))
             for m in map(_SASS_INST.match, body.split("\n")) if m]
    loops = set()
    for a, i in insts:
        m = _SASS_BRA.search(i)
        if m and int(m.group(1), 16) <= a:
            loops.add((int(m.group(1), 16), a))

    def count(lp, pattern):
        return sum(1 for a, i in insts
                   if lp[0] <= a <= lp[1] and re.search(pattern, i))

    def innermost(cands):
        return min(cands, key=lambda lp: lp[1] - lp[0], default=None)

    hgmma = [a for a, i in insts if "HGMMA" in i]
    consumer = innermost(lp for lp in loops if hgmma and lp[0] <= min(hgmma)
                         and max(hgmma) <= lp[1])
    producer = innermost(lp for lp in loops if not count(lp, r"HGMMA")
                         and count(lp, r"\bLDG") and count(lp, r"\bSTS"))
    counts = dict.fromkeys(("consumer_loop", "producer_loop", "around_loops",
                            "other_loop", "straight"), 0)
    listed: Dict[str, List[str]] = {"consumer_loop": [], "producer_loop": []}
    for a, i in insts:
        if not _SASS_SPILL.match(i):
            continue
        inner = innermost(lp for lp in loops if lp[0] <= a <= lp[1])
        if inner is None:
            where = "straight"
        elif inner == consumer:
            where = "consumer_loop"
        elif inner == producer:
            where = "producer_loop"
        elif any(lp and inner[0] <= lp[0] and lp[1] <= inner[1]
                 for lp in (consumer, producer)):
            where = "around_loops"
        else:
            where = "other_loop"
        counts[where] += 1
        if where in listed:
            listed[where].append(i)

    def span(lp):
        return None if lp is None else {
            "at": ["%05x" % x for x in lp],
            "instructions": count(lp, r"."), "hgmma": count(lp, r"HGMMA")}

    out.update(instructions=len(insts), hgmma=len(hgmma),
               consumer_loop=span(consumer), producer_loop=span(producer),
               spills=counts, listed=listed)
    return out


def sass_spills(kernels: Sequence[str]) -> Dict[str, dict]:
    """:func:`spill_placement` of each of ``kernels`` in the built kernel
    library (``cuobjdump -sass``, from the toolkit that holds ``nvcc``)."""
    from tenzing_tpu_torch.ops import kernel_lib

    so = kernel_lib.build()
    tool = Path(kernel_lib.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {name: spill_placement(sass, name) for name in kernels}


def library_config(entry: str) -> dict:
    """A fold kernel's launch constants as the built library reports them
    (``entry``: ``tz_attn_bf16_config`` or ``tz_attn_f32_config``)."""
    from tenzing_tpu_torch.ops import kernel_lib

    out = (ctypes.c_int64 * len(CONFIG_KEYS))()
    getattr(kernel_lib.lib(), entry)(out)
    return dict(zip(CONFIG_KEYS, list(out)))


def config_mismatch(plan: dict, entry: str) -> dict:
    """Keys where the launch ``plan`` and the library's ``entry`` disagree."""
    return {k: (plan[k], v) for k, v in library_config(entry).items()
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


def device_line(torch) -> None:
    """Print the card's name and power limit and the versions, one JSON
    object."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    write_line(json.dumps({"device": smi, "torch": torch.__version__,
                           "cuda": torch.version.cuda}))


def apply_edits(text: str, edits: List[Tuple[str, str]], name: str) -> str:
    """``text`` with each (old, new) of an ablation replaced; raises when an
    ``old`` is not in it."""
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"ablation {name}: source text not found")
        text = text.replace(old, new)
    return text


def build_variants(edited: str, ablations: Dict[str, List[Tuple[str, str]]],
                   kernel: str, source: str = "attn_fold.cu",
                   entry_points: Sequence[str] = ("tz_attn_fused",
                                                  "tz_attn_block"),
                   ) -> Tuple[Dict[str, ctypes.CDLL], List[dict]]:
    """Build ``csrc/<source>`` once as it is (``kernel``) and once per
    entry of ``ablations`` with the file ``edited`` of csrc/ changed by that
    entry's edits, each variant in a directory of its own under the build
    directory (the .cu's quoted includes find an edited header beside it
    first), all ``nvcc`` processes started together.  Returns the loaded
    libraries by name, with ``entry_points`` bound, and each variant's
    :func:`ptxas_report` of ``kernel``."""
    from tenzing_tpu_torch.ops import kernel_lib

    base = (kernel_lib.CSRC / edited).read_text()
    text = (kernel_lib.CSRC / source).read_text()
    kernel_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=kernel_lib.BUILD_DIR))
    procs = {}
    for name, edits in {"kernel": [], **ablations}.items():
        vdir = work / name
        vdir.mkdir()
        (vdir / source).write_text(text)
        (vdir / edited).write_text(apply_edits(base, edits, name))
        so = vdir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kernel_lib.nvcc(), *kernel_lib.ARCH_FLAGS,
             *kernel_lib.COMPILE_FLAGS, "-shared", "-I", str(kernel_lib.CSRC),
             str(vdir / source), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, rows = {}, []
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablation {name} failed to build:\n{out}")
        rows.append({"ablation": name, "ptxas": ptxas_report(out, kernel)})
        lib = ctypes.CDLL(str(so))
        for fn in entry_points:
            getattr(lib, fn).argtypes = kernel_lib.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, rows


def main_shape_calls(torch, device, lib, bf16: bool):
    """Closures calling ``lib``'s entry points directly at
    :data:`MAIN_SHAPE`: (fused over all keys, one block of the chain,
    ``fold_all(state)`` folding all keys into a given state, the inputs
    (q, k, v, state)).  For bf16, K and V are cast once here, outside the
    timed calls."""
    from tenzing_tpu_torch.ops import attention_kernels as ak

    b, n, nkv, blk = MAIN_SHAPE
    d = HEAD_DIM
    q, k, v, st = case_inputs(torch, device, b, n, nkv, "init", "dense")
    if bf16:
        kv_all = ak.cast_kv_bf16(k, v)
        kv_blk = ak.cast_kv_bf16(k[:, :blk], v[:, :blk])
    else:
        kv_all = kv_blk = (k, v)
    stream = torch.cuda.current_stream(device).cuda_stream
    work = [t.clone() for t in st]

    def call(kv, nk, state, fused):
        head = (q.data_ptr(), kv[0].data_ptr(), kv[1].data_ptr(),
                *(t.data_ptr() for t in state), b, n, nk)
        tail = (d, q.stride(0), q.stride(1), kv[0].stride(0), kv[0].stride(1),
                kv[1].stride(0), kv[1].stride(1), state[0].stride(0),
                state[0].stride(1), d ** -0.5, int(bf16), stream)
        err = (lib.tz_attn_fused(*head, blk, *tail) if fused
               else lib.tz_attn_block(*head, *tail))
        if err:
            raise RuntimeError(f"ablation launch failed with cudaError {err}")

    return ((lambda: call(kv_all, nkv, work, True)),
            (lambda: call(kv_blk, blk, work, False)),
            (lambda state: call(kv_all, nkv, state, True)),
            (q, k, v, st))


def time_variants(torch, device, libs: Dict[str, ctypes.CDLL], bf16: bool,
                  rounds: int = 2) -> List[dict]:
    """Each library's fused and block time at the main path's shapes, the
    variants in alternating rounds in one process (:func:`cuda_ms`)."""
    rows = []
    for rnd in range(rounds):
        for name, lib in libs.items():
            fused, block, _, _ = main_shape_calls(torch, device, lib, bf16)
            rows.append({"ablation": name, "round": rnd,
                         "fused_ms": cuda_ms(torch, fused),
                         "block_ms": cuda_ms(torch, block)})
    return rows


def run_checks(checks: List[Tuple[str, Callable[[], Tuple[bool, dict]]]],
               failed: List[str]) -> None:
    """Run each named check, print its row, and add the failures' names to
    ``failed``."""
    for name, check in checks:
        ok, info = check()
        write_line(json.dumps({"case": name, "ok": ok, **info}))
        if not ok:
            failed.append(name)
