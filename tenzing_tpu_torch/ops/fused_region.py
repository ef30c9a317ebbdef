"""The fused-region kernel: ``fused_region``.

Counterpart of ``tenzing_tpu/runtime/fused.py``'s ``_region_call``, the one
``pallas_call`` per fusible region whose body re-applies the members' functions
in schedule order over a ``(tiles,)`` grid along their declared row axes.  On
Hopper it is one precompiled CUDA kernel (csrc/fused_region.cu) that reads the
region from a descriptor table: one entry per member, with its body kind, its
buffer pointers, its extents and a "barrier before me" flag.
``runtime/fused.py`` lowers each region into :class:`MemberBody` entries once
per (schedule, tiles); :class:`RegionTable` holds them as the kernel's table
and fills in the pointers once per buffer set (the executor's buffers are
updated in place, never rebound, so the timed runs launch with no refill).

The bodies are those of the SpMV iteration's four device ops:

* ``ell``    — ``y[i] = sum_j vals[i, j] * x[cols[i, j]]`` (operands vals,
  cols, x, y; vals/cols/y row-tiled, x whole);
* ``gather`` — ``out[i] = x[idx[i]]`` (x, idx, out);
* ``add``    — ``out[i] = a[i] + b[i]`` (a, b, out);
* ``copy``   — ``out[i] = src[i]`` (src, out).

Values are float32, indices int32.  ``fused_region`` launches the kernel for
CUDA tensors and runs :func:`region_plain` (the members' plain PyTorch
functions in order over each tile's row slices) for CPU tensors.
``LAUNCHES["fused_region"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from tenzing_tpu_torch.ops import kernel_lib
from tenzing_tpu_torch.ops.spmv_kernels import ELL_TOL, ell_spmv_plain

LAUNCHES = {"fused_region": 0}

BODIES = {"ell": 0, "gather": 1, "add": 2, "copy": 3}
# operand names of each body, in its operand order (csrc/fused_region.cu)
OPERANDS = {"ell": ("vals", "cols", "x", "y"), "gather": ("x", "idx", "out"),
            "add": ("a", "b", "out"), "copy": ("src", "out")}
# which operands are row-tiled (the rest are read whole)
TILED = {"ell": ("vals", "cols", "y"), "gather": ("idx", "out"),
         "add": ("a", "b", "out"), "copy": ("src", "out")}
MAX_MEMBERS = 32  # kMaxMembers in csrc/fused_region.cu

# the fused region against its plain version: the ELL rows sum in another
# order (ops/spmv_kernels.py); gather, add and copy are exact
REGION_TOL = ELL_TOL


class _Member(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("barrier", ctypes.c_int32),
                ("rows", ctypes.c_int64), ("width", ctypes.c_int64),
                ("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("c", ctypes.c_void_p), ("out", ctypes.c_void_p)]


class _Table(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int32), ("tiles", ctypes.c_int32),
                ("m", _Member * MAX_MEMBERS)]


@dataclass(frozen=True)
class MemberBody:
    """One region member as the kernel sees it: its body kind, its buffer
    names in the body's operand order, the extent of its row-tiled buffers,
    the ELL slab width (0 for other bodies), and whether a barrier precedes
    it."""

    body: str
    operands: Tuple[str, ...]
    rows: int
    width: int
    barrier: bool


def check_member(body: str, operands: Tuple[str, ...],
                 shapes: Dict[str, Tuple[int, ...]],
                 dtypes: Dict[str, torch.dtype]) -> Tuple[int, int]:
    """(rows, width) of a member from the buffers' shapes and dtypes; raises
    when the kernel's body does not take them."""
    if body not in BODIES:
        raise ValueError(f"fused_region: unknown body {body!r}")
    names = dict(zip(OPERANDS[body], operands))
    if len(operands) != len(OPERANDS[body]):
        raise ValueError(f"fused_region: {body} takes {OPERANDS[body]}, "
                         f"got {operands}")
    for role, n in names.items():
        want = torch.int32 if role in ("cols", "idx") else torch.float32
        if dtypes[n] != want:
            raise TypeError(f"fused_region: {body} operand {role} ({n}) must "
                            f"be {want}, is {dtypes[n]}")
    if body == "ell":
        vshape = shapes[names["vals"]]
        if len(vshape) != 2 or shapes[names["cols"]] != vshape \
                or shapes[names["y"]] != (vshape[0],) \
                or len(shapes[names["x"]]) != 1 or vshape[1] < 1:
            raise ValueError(f"fused_region: ell shapes {[shapes[n] for n in operands]}")
        return vshape[0], vshape[1]
    tiled = [shapes[names[r]] for r in TILED[body]]
    if any(len(s) != 1 or s != tiled[0] for s in tiled):
        raise ValueError(f"fused_region: {body} shapes {[shapes[n] for n in operands]}")
    if body == "gather" and len(shapes[names["x"]]) != 1:
        raise ValueError("fused_region: gather x must be 1-D")
    return tiled[0][0], 0


def barrier_flags(reads: List[List[str]], writes: List[List[str]]) -> List[bool]:
    """Per member: True when it reads or writes a buffer an earlier member
    wrote, or writes one an earlier member read (the region's data hazards;
    the kernel's groups must all have finished the earlier member)."""
    written: set = set()
    read: set = set()
    out = []
    for r, w in zip(reads, writes):
        out.append(bool((set(r) | set(w)) & written or set(w) & read))
        written.update(w)
        read.update(r)
    return out


class RegionTable:
    """The kernel's descriptor table for one lowered region (a ctypes copy of
    ``Table`` in csrc/fused_region.cu), built once; :meth:`bind` writes the
    buffer pointers of one buffer dict into it."""

    def __init__(self, members: List[MemberBody], tiles: int):
        if not 1 <= len(members) <= MAX_MEMBERS:
            raise ValueError(f"fused_region: {len(members)} members; the "
                             f"kernel takes 1 to {MAX_MEMBERS}")
        self.members = list(members)
        self.tiles = int(tiles)
        self.table = _Table()
        self.table.n = len(members)
        self.table.tiles = self.tiles
        self.bound: Optional[Dict[str, torch.Tensor]] = None
        self.counters: Optional[torch.Tensor] = None
        self.blocks_per_group = 0
        for k, mb in enumerate(members):
            e = self.table.m[k]
            e.kind, e.barrier = BODIES[mb.body], int(mb.barrier)
            e.rows, e.width = mb.rows, mb.width

    def bind(self, bufs: Dict[str, torch.Tensor],
             counters: Optional[torch.Tensor] = None) -> None:
        """Write the pointers of ``bufs`` (the shapes and dtypes the region
        was lowered with, checked then) into the table; raises on a buffer
        that is not contiguous or not on the first operand's device.  On the
        card it also checks ``counters`` (2 x tiles int32, the group
        barriers) and sizes the grid.  The table keeps both as :attr:`bound`
        and :attr:`counters`: :func:`fused_region` rebinds only when another
        dict or counter tensor comes."""
        self.bound = self.counters = None  # unbound until every check passed
        dev = bufs[self.members[0].operands[0]].device
        if dev.type == "cuda":
            if counters is None or counters.device != dev \
                    or counters.dtype != torch.int32 \
                    or counters.numel() < 2 * self.tiles:
                raise ValueError("fused_region: needs 2 x tiles int32 barrier "
                                 "counters on the buffers' device")
            self.blocks_per_group = blocks_per_group(self.tiles, dev)
        elif dev.type != "cpu":
            raise ValueError(f"fused_region: unsupported device {dev}")
        for k, mb in enumerate(self.members):
            e = self.table.m[k]
            ts = [bufs[n] for n in mb.operands]
            if any(t.device != dev or not t.is_contiguous() for t in ts):
                raise ValueError(f"fused_region: the {mb.body} operands "
                                 f"{mb.operands} must be contiguous on {dev}")
            ptrs = [t.data_ptr() for t in ts]
            if mb.body == "ell":
                e.a, e.b, e.c, e.out = ptrs
            elif mb.body == "copy":
                e.a, e.b, e.c, e.out = ptrs[0], None, None, ptrs[1]
            else:
                e.a, e.b, e.c, e.out = ptrs[0], ptrs[1], None, ptrs[2]
        self.bound, self.counters = bufs, counters


def region_plain(members: List[MemberBody], bufs: Dict[str, torch.Tensor],
                 tiles: int) -> None:
    """The plain version: for each tile in turn, the members' plain PyTorch
    functions in schedule order over the tile's row slices (full-view
    operands whole).  It allocates temporaries: it is the reference the
    kernel is held against."""
    for g in range(tiles):
        for mb in members:
            lo, hi = g * mb.rows // tiles, (g + 1) * mb.rows // tiles
            t = dict(zip(OPERANDS[mb.body], (bufs[n] for n in mb.operands)))
            if mb.body == "ell":
                ell_spmv_plain(t["vals"][lo:hi], t["cols"][lo:hi], t["x"],
                               out=t["y"][lo:hi])
            elif mb.body == "gather":
                torch.index_select(t["x"], 0, t["idx"][lo:hi],
                                   out=t["out"][lo:hi])
            elif mb.body == "add":
                torch.add(t["a"][lo:hi], t["b"][lo:hi], out=t["out"][lo:hi])
            else:
                t["out"][lo:hi].copy_(t["src"][lo:hi])


_max_blocks: Dict[int, int] = {}


def blocks_per_group(tiles: int, device: torch.device) -> int:
    """Blocks of each tile's group: at most two blocks per SM in all, and
    never more than the queried co-residency limit of the cooperative grid
    allows (``tz_fused_region_max_blocks``)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _max_blocks:
        with torch.cuda.device(idx):
            got = kernel_lib.lib().tz_fused_region_max_blocks()
        if got < 0:
            raise RuntimeError(f"fused_region: occupancy query failed with "
                               f"cudaError {-got}")
        if got == 0:
            raise RuntimeError("fused_region: the device has no cooperative launch")
        _max_blocks[idx] = got
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    total = min(_max_blocks[idx], 2 * sms)
    if total < tiles:
        raise ValueError(f"fused_region: {tiles} tiles need at least {tiles} "
                         f"resident blocks; the grid holds {total}")
    return total // tiles


def fused_region(table: RegionTable, bufs: Dict[str, torch.Tensor],
                 counters: Optional[torch.Tensor]) -> None:
    """Run the region on the current stream: the ``tz_fused_region`` kernel
    when its buffers are CUDA tensors (``counters``: 2 x tiles zeroed int32
    on the card, the group barriers), :func:`region_plain` when they are CPU
    tensors."""
    if table.counters is None or bufs is not table.bound \
            or counters is not table.counters:
        if bufs[table.members[0].operands[0]].device.type == "cpu":
            region_plain(table.members, bufs, table.tiles)
            return
        table.bind(bufs, counters)
    err = kernel_lib.lib().tz_fused_region(
        ctypes.addressof(table.table), table.counters.data_ptr(),
        table.blocks_per_group,
        torch.cuda.current_stream(table.counters.device).cuda_stream)
    kernel_lib.check_launch("fused_region", err)
    LAUNCHES["fused_region"] += 1
