"""Probe what the mesh shift needs from the card: ``python -m
tenzing_tpu_torch.parallel.ipc_probe``.

Prints one JSON line per check:

* ``compute_mode`` — ``nvidia-smi --query-gpu=compute_mode``: two processes
  can hold contexts on GPU 0 only in the Default mode;
* ``ipc`` — two ranks on GPU 0 joined over gloo (parallel/launch.py
  ``shared_card``): each fills a tensor with its rank, exports the block
  holding it (``cudaIpcGetMemHandle``, ops/rdma.py ``export_tensor``), the
  ranks exchange handles, and each maps the other's
  (``cudaIpcOpenMemHandle``) and reads it back through the mapping;
* ``nccl_self_permute`` — at world size 1 over NCCL, whether
  ``dist.batch_isend_irecv`` takes a send and a receive to the rank itself.

It exits non-zero when a check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

from tenzing_tpu_torch.utils.cli import write_line


def _mapped(ptr: int, numel: int, device):
    """A float32 tensor over ``numel`` elements at device address ``ptr``
    (the probe's read-back only)."""
    import torch

    class _View:
        __cuda_array_interface__ = {"shape": (numel,), "typestr": "<f4",
                                    "data": (ptr, False), "version": 3}

    return torch.as_tensor(_View(), device=device)


def ipc_task(mesh, device, numel: int = 1 << 20) -> dict:
    """Launch task: export, exchange, map and read back (module docstring)."""
    import torch
    import torch.distributed as dist

    from tenzing_tpu_torch.ops import rdma

    me = dist.get_rank()
    mine = torch.full((numel,), float(me + 1), device=device)
    torch.cuda.synchronize(device)
    theirs: list = [None] * dist.get_world_size()
    dist.all_gather_object(theirs, rdma.export_tensor(mine))
    peer = (me + 1) % dist.get_world_size()
    ptr = rdma.open_peer(*theirs[peer])
    got = _mapped(ptr, numel, device).clone()
    ok = bool(torch.all(got == float(peer + 1)))
    dist.barrier()
    return {"rank": me, "peer": peer, "offset": theirs[peer][1],
            "handle_bytes": len(theirs[peer][0]), "read_back_ok": ok}


def nccl_self_permute() -> dict:
    """A send and a receive to the rank itself at world size 1 over NCCL."""
    import torch
    import torch.distributed as dist

    from tenzing_tpu_torch.parallel.mesh import close_mesh, init_mesh

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="tz_probe_") as d:
        init_mesh("x", "nccl", "file://" + os.path.join(d, "rv"), 0, 1)
        try:
            src = torch.arange(1024, dtype=torch.float32, device="cuda")
            dst = torch.zeros_like(src)
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src, 0), dist.P2POp(dist.irecv, dst, 0)])
            for w in works:
                w.wait()
            torch.cuda.synchronize()
            return {"accepted": True, "equal": bool(torch.equal(src, dst))}
        except Exception as e:  # the probe reports what NCCL said
            return {"accepted": False, "error": f"{type(e).__name__}: {e}"}
        finally:
            close_mesh()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("ipc_probe: no CUDA device\n")
        return 2
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    write_line(json.dumps({"check": "compute_mode", "nvidia_smi": mode}))
    from tenzing_tpu_torch.parallel.launch import launch

    rows = launch("tenzing_tpu_torch.parallel.ipc_probe:ipc_task", 2, "cuda",
                  timeout_s=300.0, shared_card=True)
    write_line(json.dumps({"check": "ipc", "ranks": rows}))
    nccl = nccl_self_permute()
    write_line(json.dumps({"check": "nccl_self_permute", **nccl}))
    ok = "Default" in mode and all(r["read_back_ok"] for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
