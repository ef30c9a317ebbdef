"""Run one function of the port on N ranks, one process each.

:func:`launch` starts ``nproc`` interpreters (``python -m
tenzing_tpu_torch.parallel.launch <dir> <rank>``), which join one process
group through a ``file://`` rendezvous in a fresh temporary directory (no
port to collide with other runs on the host), build the mesh (one axis
``"ep"`` over all ranks, or the axes and shape the caller names), call
the task's function as ``fn(mesh=..., device=..., **kwargs)`` and hand its
result back through a pickle in that directory.  The workers import only
the port: the task names its function as ``"module:function"`` inside
``tenzing_tpu_torch``.

Nothing can hang: every process group has a timeout
(parallel/mesh.py ``GROUP_TIMEOUT_S``), and the parent polls its children
against a deadline.  When one child fails, or the deadline passes, the
parent kills the others and raises with the failed ranks' error output, so a
rank that raises while the rest sit in a collective fails the launch at
once.

On ``cuda`` rank r runs on GPU r over NCCL (the launch refuses more ranks
than visible GPUs); on ``cpu`` the ranks run over gloo with one thread each.
With ``shared_card=True`` on ``cuda`` every rank runs on GPU 0 and the ranks
join over gloo: the one way several ranks fit on one card, since NCCL
refuses two ranks on one device.  Their mesh is marked ``shared_card``: a
collective post raises there (gloo cannot move device tensors, and a
silent round trip through the host would be a fallback), so only the
``.rdma`` shift (ops/rdma.py), which writes into the peer's memory through
CUDA IPC, exchanges data between them.
"""

from __future__ import annotations

import importlib
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from tenzing_tpu_torch.parallel.mesh import GROUP_TIMEOUT_S

PACKAGE = "tenzing_tpu_torch"
# the mesh axis when the caller names none (models/moe.py AXIS)
MESH_AXIS = "ep"
REPO = Path(__file__).resolve().parents[2]


def _resolve(fn: str):
    module, _, name = fn.partition(":")
    if not module.startswith(PACKAGE + ".") or not name:
        raise ValueError(f"task function {fn!r} must be 'module:function' "
                         f"inside {PACKAGE}")
    return getattr(importlib.import_module(module), name)


def launch(fn: str, nproc: int, device: str = "cuda",
           kwargs: Optional[Dict[str, Any]] = None,
           timeout_s: float = 300.0, workdir: Optional[str] = None,
           mesh_axes: Sequence[str] = (MESH_AXIS,),
           mesh_shape: Optional[Sequence[int]] = None,
           shared_card: bool = False) -> List[Any]:
    """Run ``fn(mesh=, device=, **kwargs)`` on ``nproc`` ranks of a mesh
    with axes ``mesh_axes`` of ``mesh_shape`` (default: one axis over all
    ranks); returns the ranks' results in rank order.  ``shared_card``: all
    ranks on GPU 0 over gloo (module docstring).  Raises ``RuntimeError``
    when a rank fails and ``TimeoutError`` when the ranks outlast
    ``timeout_s``; either way no child is left running."""
    if nproc < 1:
        raise ValueError(f"nproc must be >= 1 (got {nproc})")
    _resolve(fn)  # fail here, not in every child
    shape = tuple(mesh_shape) if mesh_shape is not None else (nproc,)
    if len(shape) != len(tuple(mesh_axes)) or \
            int(math.prod(shape)) != nproc:
        raise ValueError(f"mesh shape {shape} over axes {tuple(mesh_axes)} "
                         f"does not hold {nproc} ranks")
    if shared_card and device != "cuda":
        raise ValueError("shared_card needs device='cuda'")
    if device == "cuda":
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need = 1 if shared_card else nproc
        if need > have:
            raise RuntimeError(f"{nproc} ranks on cuda need {need} visible "
                               f"GPUs; {have} are visible")
    elif device != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    with tempfile.TemporaryDirectory(dir=workdir, prefix="tz_launch_") as d:
        task = {"fn": fn, "kwargs": dict(kwargs or {}), "device": device,
                "world": nproc, "axes": tuple(mesh_axes), "shape": shape,
                "shared_card": shared_card,
                "init": "file://" + os.path.join(d, "rendezvous"),
                "group_timeout_s": min(float(timeout_s), GROUP_TIMEOUT_S)}
        with open(os.path.join(d, "task.pkl"), "wb") as f:
            pickle.dump(task, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        # one host: gloo connects over the loopback interface
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs = []
        try:
            for r in range(nproc):
                log = open(os.path.join(d, f"rank{r}.log"), "w")
                procs.append((subprocess.Popen(
                    [sys.executable, "-m", "tenzing_tpu_torch.parallel.launch",
                     d, str(r)], cwd=str(REPO), env=env, stdout=log,
                    stderr=subprocess.STDOUT), log))
            _wait(procs, d, time.monotonic() + timeout_s, timeout_s)
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        out = []
        for r in range(nproc):
            with open(os.path.join(d, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def probe_control_plane(mesh, device, obj: Any = None, code: int = 0):
    """The launch's self-check task: every control-plane operation once over
    the gloo control group.  Returns (rank, size, ``bcast_json(obj)`` from
    rank 0, ``allreduce_max`` of the rank, ``agree_fault`` of ``code`` on
    the last rank and 0 elsewhere)."""
    from tenzing_tpu_torch.parallel.control_plane import DistControlPlane
    from tenzing_tpu_torch.parallel.mesh import control_group

    cp = DistControlPlane(control_group())
    r, n = cp.rank(), cp.size()
    cp.barrier()
    got = cp.bcast_json(obj if r == 0 else None)
    top = cp.allreduce_max(float(r))
    fault = cp.agree_fault(code if r == n - 1 else 0)
    cp.barrier()
    return r, n, got, top, fault


def probe_mesh(mesh, device):
    """The launch's mesh check: for each axis, (size, this rank's index, the
    global ranks of its group, or None where the axis has none)."""
    import torch.distributed as dist

    out = {}
    for name, ax in mesh.axes.items():
        ranks = (dist.get_process_group_ranks(ax.group)
                 if ax.group is not None else None)
        out[name] = (ax.size, ax.index, ranks)
    return dist.get_rank(), out


def _tail(d: str, r: int, n: int = 4000) -> str:
    with open(os.path.join(d, f"rank{r}.log")) as f:
        return f.read()[-n:]


def _wait(procs, d: str, deadline: float, timeout_s: float) -> None:
    """Poll the children until all exit 0; on the first failure or at the
    deadline, raise (the caller kills the survivors)."""
    while True:
        codes = [p.poll() for p, _ in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            for _, log in procs:
                log.flush()
            msg = "\n".join(f"--- rank {r} (exit {codes[r]}):\n{_tail(d, r)}"
                            for r in bad)
            raise RuntimeError(f"{len(bad)} of {len(procs)} ranks failed:\n"
                               + msg)
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            alive = [r for r, c in enumerate(codes) if c is None]
            raise TimeoutError(f"ranks {alive} still running after "
                               f"{timeout_s} s")
        time.sleep(0.05)


def _child(d: str, rank: int) -> None:
    import torch

    from tenzing_tpu_torch.parallel.mesh import close_mesh, init_mesh

    with open(os.path.join(d, "task.pkl"), "rb") as f:
        task = pickle.load(f)
    device = task["device"]
    if device == "cuda":
        gpu = 0 if task["shared_card"] else rank
        torch.cuda.set_device(gpu)
        dev = torch.device("cuda", gpu)
        backend = "gloo" if task["shared_card"] else "nccl"
    else:
        torch.set_num_threads(1)
        dev, backend = torch.device("cpu"), "gloo"
    mesh = init_mesh(task["axes"], backend, task["init"], rank, task["world"],
                     timeout_s=task["group_timeout_s"], shape=task["shape"],
                     shared_card=task["shared_card"])
    result = _resolve(task["fn"])(mesh=mesh, device=dev, **task["kwargs"])
    close_mesh()
    tmp = os.path.join(d, f"result{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(d, f"result{rank}.pkl"))


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
