"""Device-resident transfer: the ``.rdma`` engine and its copy kernel.

Counterpart of the loopback part of ``tenzing_tpu/ops/rdma.py``.  On one TPU
chip ``RdmaCopyStart`` posts a DMA-engine copy whose wait is a second kernel
(``rdma_start_loopback`` / ``rdma_wait_loopback``).  On CUDA the post is the
hand-written ``device_copy`` kernel (csrc/device_copy.cu) launched on the
direction's transfer stream plus an event record, and the wait is that event
(comm_ops.AwaitTransfer) — no wait kernel.  The mesh shift (``RdmaShiftStart``)
comes with the multi-device slice.

``device_copy`` runs the kernel for CUDA tensors and its plain PyTorch version
(``copy_``) for CPU tensors; there is no other path.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from tenzing_tpu_torch.core.operation import register_kind
from tenzing_tpu_torch.ops import kernel_lib
from tenzing_tpu_torch.ops.comm_ops import CommStart

# launches of the device_copy kernel (CUDA path only; the plain version and
# CPU tensors do not count)
LAUNCHES = {"device_copy": 0}


def device_copy_plain(src: torch.Tensor, dst: torch.Tensor) -> None:
    """The plain PyTorch version: ``dst.copy_(src)``."""
    dst.copy_(src)


def _check_copy(src: torch.Tensor, dst: torch.Tensor) -> None:
    if src.dtype != dst.dtype:
        raise TypeError(f"device_copy: dtypes differ ({src.dtype}, {dst.dtype})")
    if src.device != dst.device:
        raise ValueError(f"device_copy: src on {src.device}, dst on {dst.device}")
    if src.shape != dst.shape:
        raise ValueError(f"device_copy: shape {tuple(src.shape)} vs {tuple(dst.shape)}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("device_copy: src and dst must be contiguous")


def device_copy(src: torch.Tensor, dst: torch.Tensor) -> None:
    """``dst[:] = src`` on the current stream, for any dtype (the kernel
    copies ``numel * element_size`` bytes): the device_copy kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_copy(src, dst)
    if src.device.type == "cpu":
        device_copy_plain(src, dst)
        return
    if src.device.type != "cuda":
        raise ValueError(f"device_copy: unsupported device {src.device}")
    if (src.data_ptr() | dst.data_ptr()) % 16:
        raise ValueError("device_copy: pointers must be 16-byte aligned")
    err = kernel_lib.lib().tz_device_copy(
        src.data_ptr(), dst.data_ptr(), src.numel() * src.element_size(),
        torch.cuda.current_stream(src.device).cuda_stream)
    kernel_lib.check_launch("device_copy", err)
    LAUNCHES["device_copy"] += 1


@register_kind("rdma_copy_start")
class RdmaCopyStart(CommStart):
    """Post a device-resident copy ``src -> dst`` (the CUDA-aware-MPI analog,
    SURVEY §7.0): the searchable alternative to the host-staged round trip
    (``HostSpillStart`` + ``HostFetchStart``) in the transfer-engine menu."""

    def apply(self, bufs: Dict[str, Any], ctx) -> None:
        copy = device_copy_plain if ctx.plain_kernels else device_copy
        copy(bufs[self._src], bufs[self._dst])
