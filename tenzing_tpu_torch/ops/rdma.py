"""Device-resident transfer: the ``.rdma`` engine, its copy kernel and the
mesh neighbour shift.

Counterpart of ``tenzing_tpu/ops/rdma.py``.

* **Loopback** (``RdmaCopyStart``, and ``RdmaShiftStart`` on an axis of size
  1).  On one TPU chip the post is a DMA-engine copy whose wait is a second
  kernel (``rdma_start_loopback`` / ``rdma_wait_loopback``).  On CUDA the
  post is the hand-written ``device_copy`` kernel (csrc/device_copy.cu)
  launched on the direction's transfer stream plus an event record, and the
  wait is that event (comm_ops.AwaitTransfer) — no wait kernel.
* **Mesh shift** (``RdmaShiftStart`` on an axis of size n > 1; the
  reference's ``rdma_shift_post`` / ``rdma_shift_wait``): rank i's ``dst``
  receives the ``src`` of rank ``(i - shift) % n`` along the axis.  On CUDA
  the ranks are processes that map each other's receive buffers and flag
  blocks through CUDA IPC (:class:`ShiftPeers`); the post launches
  ``rdma_shift_post`` (csrc/rdma_shift.cu: a flag barrier with both
  neighbours, the copy into the +shift neighbour's receive buffer, an
  arrival flag) on the direction's transfer stream, and the await launches
  ``rdma_shift_wait``, which spins until this rank's arrival flag shows the
  -shift neighbour's block landed, and blocks the host on it
  (runtime/executor.py ``RunContext.post_shift``).  Nothing else moves the
  bytes: no NCCL, no ``cudaMemcpyPeer``, no ``copy_`` of a mapped tensor.

Each kernel wrapper runs its kernel for CUDA tensors; the plain versions
(:func:`device_copy_plain`, :func:`rdma_shift_plain`, and
:func:`shift_roll`, the definition the tests and the chip smoke check
against) are what CPU tensors get, and what the executor runs under
``plain_kernels``.  There is no other path.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Tuple

import torch

from tenzing_tpu_torch.core.operation import register_kind
from tenzing_tpu_torch.ops import kernel_lib
from tenzing_tpu_torch.ops.comm_ops import CommStart, p2p_tag, shift_exchange

# kernel launches (CUDA path only; the plain versions and CPU tensors do not
# count)
LAUNCHES = {"device_copy": 0, "rdma_shift_post": 0, "rdma_shift_wait": 0}


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


# -- the mesh shift -------------------------------------------------------------

# collective ids a flag block has room for (the halo uses 0-5, one per
# direction, as the reference: tenzing_tpu/models/halo.py:163-167)
MAX_COLLECTIVE_IDS = 16
# the error codes csrc/rdma_shift.cu writes before it traps
SHIFT_ERRORS = {1: "the neighbour barrier timed out (a neighbour never "
                   "posted this shift)",
                2: "the arrival wait timed out (the -shift neighbour's "
                   "block never landed)"}


def shift_roll(blocks: torch.Tensor, shift: int, dim: int = 0) -> torch.Tensor:
    """The shift's definition on the gathered blocks: block i of the result
    is block ``(i - shift) % n`` along ``dim`` (``torch.roll``)."""
    return torch.roll(blocks, shifts=shift, dims=dim)


def rdma_shift_plain(x: torch.Tensor, y: torch.Tensor, group, size: int,
                     shift: int, tag: int = 0) -> None:
    """The plain version of the shift: ``y`` <- the ``x`` of the rank
    ``shift`` places behind along the axis group, through
    ``isend``/``irecv`` over the group (gloo), blocking.  A device tensor
    goes through host memory (gloo moves host tensors only)."""
    if size == 1:
        y.copy_(x)
        return
    xs = x.contiguous().cpu() if x.device.type == "cuda" else x
    ys = torch.empty_like(xs) if x.device.type == "cuda" else y
    shift_exchange(xs, ys, group, size, shift % size, tag).wait()
    if ys is not y:
        y.copy_(ys)


def _check_shift_src(x: torch.Tensor, peer_y: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"rdma_shift_post: x on {x.device}; the kernel "
                         "takes a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("rdma_shift_post: x must be contiguous")
    if x.data_ptr() % 16 or peer_y % 16:
        raise ValueError("rdma_shift_post: pointers must be 16-byte aligned")


def rdma_shift_post(x: torch.Tensor, peer_y: int, flags: torch.Tensor,
                    fwd_flags: int, bwd_flags: int, cid: int, epoch: int,
                    err: torch.Tensor) -> None:
    """Launch the post half on the current stream: the flag barrier with
    both neighbours (``flags`` is this rank's block, ``fwd_flags`` /
    ``bwd_flags`` the mapped blocks of the +shift / -shift neighbours), the
    copy of ``x`` into the +shift neighbour's receive buffer at the mapped
    address ``peer_y``, and the arrival flag of ``epoch`` in the neighbour's
    block.  ``err`` is a pinned host word the kernel writes a code into
    before it traps on a timeout."""
    _check_shift_src(x, peer_y)
    if not 0 <= cid < MAX_COLLECTIVE_IDS:
        raise ValueError(f"rdma_shift_post: collective id {cid} outside "
                         f"[0, {MAX_COLLECTIVE_IDS})")
    rc = kernel_lib.lib().tz_rdma_shift_post(
        x.data_ptr(), peer_y, x.numel() * x.element_size(), flags.data_ptr(),
        fwd_flags, bwd_flags, cid, epoch, err.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernel_lib.check_launch("rdma_shift_post", rc)
    LAUNCHES["rdma_shift_post"] += 1


def rdma_shift_wait(flags: torch.Tensor, cid: int, epoch: int,
                    err: torch.Tensor) -> None:
    """Launch the wait half on the current stream: spin until this rank's
    arrival flag for ``cid`` reaches ``epoch``."""
    if flags.device.type != "cuda":
        raise ValueError(f"rdma_shift_wait: flags on {flags.device}")
    rc = kernel_lib.lib().tz_rdma_shift_wait(
        flags.data_ptr(), cid, epoch, err.data_ptr(),
        torch.cuda.current_stream(flags.device).cuda_stream)
    kernel_lib.check_launch("rdma_shift_wait", rc)
    LAUNCHES["rdma_shift_wait"] += 1


def rdma_shift_barrier(flags: torch.Tensor, fwd_flags: int, bwd_flags: int,
                       cid: int, epoch: int, err: torch.Tensor) -> None:
    """The post's barrier alone (not counted as a launch of either half):
    the chip smoke times it by itself."""
    rc = kernel_lib.lib().tz_rdma_shift_barrier(
        flags.data_ptr(), fwd_flags, bwd_flags, cid, epoch, err.data_ptr(),
        torch.cuda.current_stream(flags.device).cuda_stream)
    kernel_lib.check_launch("rdma_shift_barrier", rc)


def shift_error(err: torch.Tensor) -> Optional[str]:
    """What the kernels reported through the error word, if anything."""
    code = int(err[0])
    return SHIFT_ERRORS.get(code, f"error code {code}") if code else None


# -- CUDA IPC ----------------------------------------------------------------

_driver_range = None
# handle bytes -> the mapped base in this process (a handle opens once per
# process); (base, size) -> this process's exported handle
_OPENED: Dict[bytes, int] = {}
_EXPORTED: Dict[Tuple[int, int], bytes] = {}


def _alloc_range(ptr: int) -> Tuple[int, int]:
    """(base, size) of the ``cudaMalloc`` allocation holding ``ptr``, from
    the CUDA driver API (``cuMemGetAddressRange``): PyTorch's caching
    allocator puts a tensor at an offset inside a larger block, and an IPC
    handle names the whole block."""
    global _driver_range
    if _driver_range is None:
        f = ctypes.CDLL("libcuda.so.1").cuMemGetAddressRange_v2
        f.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                      ctypes.POINTER(ctypes.c_size_t), ctypes.c_uint64]
        f.restype = ctypes.c_int
        _driver_range = f
    base, size = ctypes.c_uint64(), ctypes.c_size_t()
    rc = _driver_range(ctypes.byref(base), ctypes.byref(size), ptr)
    if rc != 0:
        raise RuntimeError(f"cuMemGetAddressRange failed with CUresult {rc}")
    return int(base.value), int(size.value)


def export_tensor(t: torch.Tensor) -> Tuple[bytes, int]:
    """(IPC handle of the block holding ``t``, ``t``'s byte offset in it)."""
    base, size = _alloc_range(t.data_ptr())
    h = _EXPORTED.get((base, size))
    if h is None:
        lib = kernel_lib.lib()
        buf = ctypes.create_string_buffer(int(lib.tz_ipc_handle_size()))
        kernel_lib.check_launch("cudaIpcGetMemHandle",
                                lib.tz_ipc_get_handle(base, buf))
        h = _EXPORTED[(base, size)] = buf.raw
    return h, t.data_ptr() - base


def open_peer(handle: bytes, offset: int) -> int:
    """This process's address of a peer's exported tensor."""
    base = _OPENED.get(handle)
    if base is None:
        out = ctypes.c_void_p()
        rc = kernel_lib.lib().tz_ipc_open(handle, ctypes.byref(out))
        kernel_lib.check_launch("cudaIpcOpenMemHandle", rc)
        base = _OPENED[handle] = int(out.value)
    return base + offset


def close_ipc() -> None:
    """Unmap every peer block this process opened (before its peers may free
    them: parallel/mesh.py ``close_mesh`` calls this ahead of its barrier)."""
    if not _OPENED:
        return
    torch.cuda.synchronize()
    lib = kernel_lib.lib()
    for base in _OPENED.values():
        kernel_lib.check_launch("cudaIpcCloseMemHandle",
                                lib.tz_ipc_close(base))
    _OPENED.clear()


class ShiftPeers:
    """One rank's side of the shifts along one mesh axis of size > 1, for
    one run context: its flag block (exported through IPC), its
    neighbours' mapped flag blocks, the error word, the epoch of each
    collective id, and its neighbours' mapped receive buffers for each
    buffer dict the context runs (``generation``).  Every exchange of
    handles is an ``all_gather_object`` over the axis group, which every
    rank on the line reaches at the same post of the same schedule."""

    def __init__(self, axis: str, group, size: int, device: torch.device):
        import torch.distributed as dist

        self.axis, self.group, self.size = axis, group, size
        self.me = dist.get_rank(group)
        slots = int(kernel_lib.lib().tz_rdma_shift_slots())
        self.flags = torch.zeros(MAX_COLLECTIVE_IDS * slots,
                                 dtype=torch.int64, device=device)
        self.err = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        torch.cuda.synchronize(device)  # zeros in place before peers map them
        self.epochs: Dict[int, int] = {}
        theirs = self._all_gather(export_tensor(self.flags))
        self._flag_blocks = {j: open_peer(*theirs[j])
                             for j in range(size) if j != self.me}
        self._recv: Dict[Tuple[str, int, int], int] = {}

    def _all_gather(self, obj) -> List[Any]:
        import torch.distributed as dist

        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def neighbour(self, shift: int) -> int:
        return (self.me + shift) % self.size

    def flag_block(self, shift: int) -> int:
        return self._flag_blocks[self.neighbour(shift)]

    def next_epoch(self, cid: int) -> int:
        e = self.epochs.get(cid, 0) + 1
        self.epochs[cid] = e
        return e

    def peer_recv(self, dst: str, local: torch.Tensor, shift: int,
                  generation: int) -> int:
        """The +shift neighbour's ``dst`` of this generation, mapped (an
        exchange at its first post in a generation)."""
        key = (dst, shift, generation)
        ptr = self._recv.get(key)
        if ptr is None:
            theirs = self._all_gather(export_tensor(local))
            ptr = self._recv[key] = open_peer(*theirs[self.neighbour(shift)])
        return ptr


@register_kind("rdma_copy_start")
class RdmaCopyStart(CommStart):
    """Post a device-resident copy ``src -> dst`` (the CUDA-aware-MPI analog,
    SURVEY §7.0): the searchable alternative to the host-staged round trip
    (``HostSpillStart`` + ``HostFetchStart``) in the transfer-engine menu."""

    def uses_pallas(self) -> bool:
        return True

    def apply(self, bufs: Dict[str, Any], ctx) -> None:
        copy = device_copy_plain if ctx.plain_kernels else device_copy
        copy(bufs[self._src], bufs[self._dst])


@register_kind("rdma_shift_start")
class RdmaShiftStart(CommStart):
    """Post a neighbour shift of ``src`` over mesh axis ``axis`` into ``dst``
    (reference ``RdmaShiftStart``, tenzing_tpu/ops/rdma.py:293): the menu
    alternative to ``PermuteStart``.  ``collective_id`` keeps the flags of
    concurrent shifts apart (one per halo direction).  On an axis of size 1
    the shift is the loopback copy (``device_copy`` plus an event), as in
    the reference (rdma.py:39-41); otherwise the executor posts
    ``rdma_shift_post`` and the await runs ``rdma_shift_wait``
    (``RunContext.post_shift``)."""

    def __init__(self, name: str, src: str, dst: str, axis: str,
                 shift: int = 1, collective_id: int = 0):
        super().__init__(name, src, dst)
        self._axis = axis
        self._shift = int(shift)
        self._cid = int(collective_id)

    def axis(self) -> str:
        return self._axis

    def shift(self) -> int:
        return self._shift

    def collective_id(self) -> int:
        return self._cid

    def uses_pallas(self) -> bool:
        return True

    def execute(self, ctx) -> None:
        ctx.post_shift(self)

    def apply(self, bufs: Dict[str, Any], ctx) -> None:
        """The loopback (an axis of size 1)."""
        copy = device_copy_plain if ctx.plain_kernels else device_copy
        copy(bufs[self._src], bufs[self._dst])

    def tag(self) -> int:
        return p2p_tag(self._dst)

    def to_json(self) -> Dict[str, Any]:
        j = super().to_json()
        j.update(axis=self._axis, shift=self._shift,
                 collective_id=self._cid)
        return j
