"""Build and load the port's hand-written CUDA kernels.

The sources under ``tenzing_tpu_torch/csrc/`` have a plain C interface.  At
first use, ``nvcc`` compiles each source for ``sm_90a`` (all started together,
one process per source) and links them into one shared library under
``build/tenzing_tpu_torch/`` in the repository checkout; ``ctypes`` loads it,
with every pointer and the stream passed as ``c_void_p``.  The library's file
name carries a digest of the sources and flags, so an edited source rebuilds
and an unchanged one loads the existing build.

Nothing here runs at import time: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tenzing_tpu_torch"
SOURCES = ("halo_pack.cu", "halo_unpack.cu", "device_copy.cu", "attn_fold.cu",
           "ffn_expert.cu", "ffn_rows.cu", "ell_spmv.cu", "fused_region.cu",
           "rdma_shift.cu")
HEADERS = ("attn_fold_f32.cuh", "ffn_tile.cuh")  # included by the sources above
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_i64 = ctypes.c_int64
_c_ptr = ctypes.c_void_p
# C entry point -> argument types (restype is int: cudaGetLastError())
SIGNATURES = {
    "tz_halo_pack": [_c_ptr, _c_ptr] + [_c_i64] * 11 + [_c_ptr],
    "tz_halo_unpack": [_c_ptr, _c_ptr] + [_c_i64] * 11 + [_c_ptr],
    "tz_device_copy": [_c_ptr, _c_ptr, _c_i64, _c_ptr],
    # q, k, v, acc, m, l; b, n, nkv, (fused: bkv,) d; 8 batch/row strides;
    # scale; bf16; stream
    "tz_attn_block": [_c_ptr] * 6 + [_c_i64] * 12
    + [ctypes.c_float, _c_i64, _c_ptr],
    "tz_attn_fused": [_c_ptr] * 6 + [_c_i64] * 13
    + [ctypes.c_float, _c_i64, _c_ptr],
    # x, w1, w2, y; e, c, d, dff; stream
    "tz_ffn_batched": [_c_ptr] * 4 + [_c_i64] * 4 + [_c_ptr],
    # x, w1, w2, y; n, d, dff; stream
    "tz_ffn_rows": [_c_ptr] * 4 + [_c_i64] * 3 + [_c_ptr],
    "tz_ffn_rows_bf16": [_c_ptr] * 4 + [_c_i64] * 3 + [_c_ptr],
    # vals, cols, x, y; m, w, n; stream
    "tz_ell_spmv": [_c_ptr] * 4 + [_c_i64] * 3 + [_c_ptr],
    # descriptor table (host), barrier counters; blocks per group; stream
    "tz_fused_region": [_c_ptr, _c_ptr, _c_i64, _c_ptr],
    # dynamic shared memory per block
    "tz_fused_region_max_blocks": [_c_i64],
    # descriptor table (host)
    "tz_fused_region_smem": [_c_ptr],
    "tz_fused_region_member_size": [],
    "tz_fused_region_table_size": [],
    # x, peer y; bytes; my, +shift, -shift flag blocks; id, epoch; error
    # word; stream
    "tz_rdma_shift_post": [_c_ptr, _c_ptr, _c_i64, _c_ptr, _c_ptr, _c_ptr,
                           _c_i64, _c_i64, _c_ptr, _c_ptr],
    # my, +shift, -shift flag blocks; id, epoch; error word; stream
    "tz_rdma_shift_barrier": [_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64, _c_ptr,
                              _c_ptr],
    # my flag block; id, epoch; error word; stream
    "tz_rdma_shift_wait": [_c_ptr, _c_i64, _c_i64, _c_ptr, _c_ptr],
    "tz_rdma_shift_slots": [],
    # allocation base, handle out (64 bytes)
    "tz_ipc_get_handle": [_c_ptr, _c_ptr],
    # handle (64 bytes), base out
    "tz_ipc_open": [_c_ptr, ctypes.POINTER(ctypes.c_void_p)],
    "tz_ipc_close": [_c_ptr],
    "tz_ipc_handle_size": [],
}
# entry points that return an int64 instead of a cudaError_t
RESTYPES = {"tz_fused_region_smem": _c_i64,
            "tz_fused_region_member_size": _c_i64,
            "tz_fused_region_table_size": _c_i64,
            "tz_rdma_shift_slots": _c_i64,
            "tz_ipc_handle_size": _c_i64}

_lib: Optional[ctypes.CDLL] = None
# what the last build() did: seconds, whether it compiled, nvcc's -v report
build_info: Dict[str, object] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$NVCC``, ``nvcc`` on PATH, or the toolkit's
    default location.  Raises when none exists."""
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set NVCC or put the CUDA toolkit's bin on PATH)")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtenzing_kernels-{_digest()}.so"


def build() -> Path:
    """Compile and link the kernel library if it is not built yet; returns its
    path.  A file lock serializes concurrent builders."""
    so = library_path()
    t0 = time.perf_counter()
    if so.exists():
        build_info.update(seconds=0.0, compiled=False, path=str(so))
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            build_info.update(seconds=time.perf_counter() - t0,
                              compiled=False, path=str(so))
            return so
        cc = nvcc()
        work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            procs = []
            for name in SOURCES:
                obj = work / (name + ".o")
                cmd = [cc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(CSRC / name),
                       "-o", str(obj)]
                procs.append((name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            reports = []
            failed = []
            for name, _, p in procs:
                out, _ = p.communicate()
                reports.append(f"== {name}\n{out}")
                if p.returncode != 0:
                    failed.append(name)
            if failed:
                raise RuntimeError(
                    f"nvcc failed on {failed}:\n" + "\n".join(reports))
            tmp_so = work / so.name
            link = subprocess.run(
                [cc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
                 *[str(obj) for _, obj, _ in procs]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
            os.replace(tmp_so, so)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, compiled=True,
                      path=str(so), ptxas="\n".join(reports))
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        for fn, argtypes in SIGNATURES.items():
            f = getattr(loaded, fn)
            f.argtypes = argtypes
            f.restype = RESTYPES.get(fn, ctypes.c_int)
        _lib = loaded
    return _lib


def check_launch(name: str, err: int) -> None:
    """Raise when a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
