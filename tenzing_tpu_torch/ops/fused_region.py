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

The bodies are those of the SpMV iteration's four device ops and of the
blocked attention's fold and finalize:

* ``ell``    — ``y[i] = sum_j vals[i, j] * x[cols[i, j]]`` (operands vals,
  cols, x, y; vals/cols/y row-tiled, x whole);
* ``gather`` — ``out[i] = x[idx[i]]`` (x, idx, out);
* ``add``    — ``out[i] = a[i] + b[i]`` (a, b, out);
* ``copy``   — ``out[i] = src[i]`` (src, out);
* ``attn_fold`` — the online-softmax fold of keys ``key_off .. key_off+nkv``
  of k / v into the state (acc, m, l) of the tile's query rows (q, k, v,
  acc, m, l; all (outer, rows, inner) but k / v (outer, kv_rows, inner),
  tiled along axis 1, k / v read whole);
* ``attn_finalize`` — ``o = acc / l`` (acc, l, o; tiled along axis 1).

SpMV values are float32 and indices int32; the attention bodies take float32
with head dim 128 on the card (any on the CPU).  A table runs on one of two
instantiations of the kernel (:func:`instantiation`): attention members on
the split-TF32 ``wgmma`` fold's warp-specialized block (384 threads, one
block per SM), SpMV members on a block of a producer warp and four consumer
warps that streams the ELL slabs through a ring of shared-memory stages
(160 threads, two blocks per SM); a table never mixes them.  A member's
``written`` operands (those an earlier member of the region writes) are
loaded through L2 only, the others through the read-only L1 path.  A
region with more members than one table holds (``MAX_MEMBERS``) runs as
consecutive launches on the same stream, each a table of at most
``MAX_MEMBERS`` members: the members of
a region are one lane's ops in order, so the launch boundary is a barrier
like any other.  ``fused_region`` launches the kernel for CUDA tensors and
runs :func:`region_plain` (the members' plain PyTorch functions in order over
each tile's slices) for CPU tensors.  ``LAUNCHES["fused_region"]`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from tenzing_tpu_torch.ops import attention_kernels as ak
from tenzing_tpu_torch.ops import kernel_lib
from tenzing_tpu_torch.ops.spmv_kernels import ELL_TOL, ell_spmv_plain

LAUNCHES = kernel_lib.LaunchCounts("fused_region", {"fused_region": 0})

BODIES = {"ell": 0, "gather": 1, "add": 2, "copy": 3, "attn_fold": 4,
          "attn_finalize": 5}
# operand names of each body, in its operand order (csrc/fused_region.cu)
OPERANDS = {"ell": ("vals", "cols", "x", "y"), "gather": ("x", "idx", "out"),
            "add": ("a", "b", "out"), "copy": ("src", "out"),
            "attn_fold": ("q", "k", "v", "acc", "m", "l"),
            "attn_finalize": ("acc", "l", "o")}
# which operands are tiled (the rest are read whole): along axis 0 for the
# SpMV bodies, along axis 1 (query rows) for the attention bodies
TILED = {"ell": ("vals", "cols", "y"), "gather": ("idx", "out"),
         "add": ("a", "b", "out"), "copy": ("src", "out"),
         "attn_fold": ("q", "acc", "m", "l"),
         "attn_finalize": ("acc", "l", "o")}
ATTN_BODIES = ("attn_fold", "attn_finalize")
MAX_MEMBERS = 32  # kMaxMembers in csrc/fused_region.cu
# the SpMV instantiation (fused_region_kernel): kThreads, and the bytes of its
# SpmvSmem (3 stages x (vals + cols) x (128 rows x 32 + 4) x 4 bytes, and
# the stages' full and empty mbarriers)
SPMV_THREADS = 160
SPMV_SMEM_BYTES = 3 * 2 * (128 * 32 + 4) * 4 + 2 * 3 * 8

# the fused region against its plain version: the ELL rows sum in another
# order (ops/spmv_kernels.py); gather, add and copy are exact.  A region of
# attention members is held as a state, at ``ak.F32_STATE_TOL`` (the fold
# sums in another order than the plain fold's products).
REGION_TOL = ELL_TOL


class _Member(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("barrier", ctypes.c_int32),
                ("rows", ctypes.c_int64), ("width", ctypes.c_int64),
                ("outer", ctypes.c_int64), ("inner", ctypes.c_int64),
                ("kv_rows", ctypes.c_int64), ("key_off", ctypes.c_int64),
                ("nkv", ctypes.c_int64), ("scale", ctypes.c_float),
                ("written", ctypes.c_int32), ("p", ctypes.c_void_p * 6)]


class _Table(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int32), ("tiles", ctypes.c_int32),
                ("m", _Member * MAX_MEMBERS)]


@dataclass(frozen=True)
class MemberBody:
    """One region member as the kernel sees it: its body kind, its buffer
    names in the body's operand order, the extent of its tiled axis, the ELL
    slab width (0 for other bodies), whether a barrier precedes it, for
    the attention bodies the batch and head dims, the keys of K / V, and
    the fold's first key, key count and scale, and the operands it reads
    that an earlier member of the region wrote (:func:`written_flags`)."""

    body: str
    operands: Tuple[str, ...]
    rows: int
    width: int
    barrier: bool
    outer: int = 1
    inner: int = 1
    kv_rows: int = 0
    key_off: int = 0
    nkv: int = 0
    scale: float = 0.0
    written: Tuple[str, ...] = ()


def check_member(body: str, operands: Tuple[str, ...],
                 shapes: Dict[str, Tuple[int, ...]],
                 dtypes: Dict[str, torch.dtype],
                 params: Optional[Dict] = None) -> Dict[str, object]:
    """The extents of a member (``MemberBody``'s fields past ``barrier``,
    and ``rows`` / ``width``) from the buffers' shapes and dtypes and the
    op's ``params`` (a fold's ``key_off``, ``nkv`` and ``scale``); raises
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
        return {"rows": vshape[0], "width": vshape[1]}
    tiled = [shapes[names[r]] for r in TILED[body]]
    if body in ATTN_BODIES:
        if any(len(s) != 3 or s != tiled[0] for s in tiled):
            raise ValueError(f"fused_region: {body} shapes {[shapes[n] for n in operands]}")
        b, n, d = tiled[0]
        out = {"rows": n, "width": 0, "outer": b, "inner": d}
        if body == "attn_fold":
            kv = shapes[names["k"]]
            p = dict(params or {})
            key_off, nkv = int(p.get("key_off", -1)), int(p.get("nkv", 0))
            if len(kv) != 3 or kv[0] != b or kv[2] != d \
                    or shapes[names["v"]] != kv or nkv < 1 or key_off < 0 \
                    or key_off + nkv > kv[1]:
                raise ValueError(f"fused_region: attn_fold keys {key_off}+{nkv} "
                                 f"of k/v {kv} against q {tiled[0]}")
            out.update(kv_rows=kv[1], key_off=key_off, nkv=nkv,
                       scale=float(p["scale"]))
        return out
    if any(len(s) != 1 or s != tiled[0] for s in tiled):
        raise ValueError(f"fused_region: {body} shapes {[shapes[n] for n in operands]}")
    if body == "gather" and len(shapes[names["x"]]) != 1:
        raise ValueError("fused_region: gather x must be 1-D")
    return {"rows": tiled[0][0], "width": 0}


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


def written_flags(reads: List[List[str]],
                  writes: List[List[str]]) -> List[Tuple[str, ...]]:
    """Per member: the buffers it reads that an earlier member wrote, in
    its read order.  The kernel loads those through L2 only (another block
    may have stored them in the same launch) and the rest through the
    read-only L1 path; a region's flags cover every table it splits into,
    which is never less than one launch needs."""
    written: set = set()
    out = []
    for r, w in zip(reads, writes):
        out.append(tuple(dict.fromkeys(n for n in r if n in written)))
        written.update(w)
    return out


def instantiation(members: List[MemberBody]) -> Dict[str, object]:
    """The kernel instantiation a table of ``members`` launches: ``attn``
    where any member is an attention body (the f32 fold's threads and
    shared memory, :func:`ak.f32_launch_plan`), else ``spmv``
    (:data:`SPMV_THREADS`, :data:`SPMV_SMEM_BYTES`: the slab ring).  Raises
    for a table that mixes the two, which the kernel refuses.  The launch
    itself takes the library's answer (``tz_fused_region_threads`` /
    ``_max_blocks``); this statement of the rule is what the CPU refuses
    by and what the card tests hold the library's answer against."""
    attn = [mb.body in ATTN_BODIES for mb in members]
    if any(attn) and not all(attn):
        raise ValueError("fused_region: a table cannot mix attention and "
                         f"SpMV bodies: {[mb.body for mb in members]}")
    if any(attn):
        return {"kind": "attn", "threads": ak.F32_THREADS,
                "smem_bytes": ak.F32_SMEM_BYTES}
    return {"kind": "spmv", "threads": SPMV_THREADS,
            "smem_bytes": SPMV_SMEM_BYTES}


class RegionTable:
    """The kernel's descriptor tables for one lowered region (ctypes copies
    of ``Table`` in csrc/fused_region.cu), built once: one table per
    ``MAX_MEMBERS`` members, launched in order.  :meth:`bind` writes the
    buffer pointers of one buffer dict into them."""

    def __init__(self, members: List[MemberBody], tiles: int):
        if not members:
            raise ValueError("fused_region: a region needs a member")
        self.members = list(members)
        self.tiles = int(tiles)
        instantiation(self.members)  # refuses a mixed table
        self.tables: List[_Table] = []
        for at in range(0, len(members), MAX_MEMBERS):
            part = members[at:at + MAX_MEMBERS]
            t = _Table()
            t.n, t.tiles = len(part), self.tiles
            for k, mb in enumerate(part):
                e = t.m[k]
                e.kind = BODIES[mb.body]
                # a launch boundary already orders a table after the last
                e.barrier = int(mb.barrier and k > 0)
                e.rows, e.width = mb.rows, mb.width
                e.outer, e.inner, e.kv_rows = mb.outer, mb.inner, mb.kv_rows
                e.key_off, e.nkv, e.scale = mb.key_off, mb.nkv, mb.scale
                e.written = sum(1 << i for i, n in enumerate(mb.operands)
                                if n in mb.written)
            self.tables.append(t)
        self.bound: Optional[Dict[str, torch.Tensor]] = None
        self.counters: Optional[torch.Tensor] = None
        self.blocks_per_group = 0

    def bind(self, bufs: Dict[str, torch.Tensor],
             counters: Optional[torch.Tensor] = None) -> None:
        """Write the pointers of ``bufs`` (the shapes and dtypes the region
        was lowered with, checked then) into the tables; raises on a buffer
        that is not contiguous or not on the first operand's device.  On the
        card it also checks ``counters`` (2 x tiles int32, the group
        barriers) and the attention members' head dim and 16-byte
        alignment, and sizes the grid for the table's instantiation
        (:func:`instantiation`).  The table keeps both as
        :attr:`bound` and :attr:`counters`: :func:`fused_region` rebinds
        only when another dict or counter tensor comes."""
        self.bound = self.counters = None  # unbound until every check passed
        dev = bufs[self.members[0].operands[0]].device
        if dev.type == "cuda":
            if counters is None or counters.device != dev \
                    or counters.dtype != torch.int32 \
                    or counters.numel() < 2 * self.tiles:
                raise ValueError("fused_region: needs 2 x tiles int32 barrier "
                                 "counters on the buffers' device")
            for mb in self.members:
                if mb.body in ATTN_BODIES and mb.inner not in ak.KERNEL_HEAD_DIMS:
                    raise ValueError(f"fused_region: {mb.body} head dim "
                                     f"{mb.inner} has no kernel instantiation "
                                     f"(have {ak.KERNEL_HEAD_DIMS})")
                if mb.body in ATTN_BODIES and any(
                        bufs[n].data_ptr() % 16 for n in mb.operands):
                    raise ValueError(f"fused_region: the {mb.body} operands "
                                     f"{mb.operands} must be 16-byte aligned")
            self.blocks_per_group = blocks_per_group(self.tiles, dev,
                                                     self.tables[0])
        elif dev.type != "cpu":
            raise ValueError(f"fused_region: unsupported device {dev}")
        for k, mb in enumerate(self.members):
            e = self.tables[k // MAX_MEMBERS].m[k % MAX_MEMBERS]
            ts = [bufs[n] for n in mb.operands]
            if any(t.device != dev or not t.is_contiguous() for t in ts):
                raise ValueError(f"fused_region: the {mb.body} operands "
                                 f"{mb.operands} must be contiguous on {dev}")
            for i, t in enumerate(ts):
                e.p[i] = t.data_ptr()
        self.bound, self.counters = bufs, counters


def region_plain(members: List[MemberBody], bufs: Dict[str, torch.Tensor],
                 tiles: int) -> None:
    """The plain version: for each tile in turn, the members' plain PyTorch
    functions in schedule order over the tile's slices (full-view operands
    whole): a fold is ``attention_kernels.fold_into`` over the tile's query
    rows against its K/V block.  It allocates temporaries: it is the
    reference the kernel is held against."""
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
            elif mb.body == "copy":
                t["out"][lo:hi].copy_(t["src"][lo:hi])
            elif mb.body == "attn_fold":
                keys = slice(mb.key_off, mb.key_off + mb.nkv)
                ak.attn_block_plain(t["q"][:, lo:hi], t["k"][:, keys],
                                    t["v"][:, keys], t["acc"][:, lo:hi],
                                    t["m"][:, lo:hi], t["l"][:, lo:hi], mb.scale)
            else:  # attn_finalize
                torch.div(t["acc"][:, lo:hi], t["l"][:, lo:hi],
                          out=t["o"][:, lo:hi])


_max_blocks: Dict[Tuple[int, int], int] = {}


def blocks_per_group(tiles: int, device: torch.device, table: _Table) -> int:
    """Blocks of each tile's group: at most two blocks per SM in all, and
    never more than the queried co-residency limit of the cooperative grid
    of the instantiation that runs ``table``
    (``tz_fused_region_max_blocks``)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    lib = kernel_lib.lib()
    key = (idx, int(lib.tz_fused_region_threads(ctypes.addressof(table))))
    if key not in _max_blocks:
        with torch.cuda.device(idx):
            got = lib.tz_fused_region_max_blocks(ctypes.addressof(table))
        if got < 0:
            raise RuntimeError(f"fused_region: occupancy query failed with "
                               f"cudaError {-got}")
        if got == 0:
            raise RuntimeError("fused_region: the device has no cooperative launch")
        _max_blocks[key] = got
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    total = min(_max_blocks[key], 2 * sms)
    if total < tiles:
        raise ValueError(f"fused_region: {tiles} tiles need at least {tiles} "
                         f"resident blocks; the grid holds {total}")
    return total // tiles


def kernel_layout() -> Tuple[int, int]:
    """(sizeof Member, sizeof Table) as the compiled kernel has them: the
    ctypes mirror must match (``ctypes.sizeof(_Member)``, ``_Table``)."""
    lib = kernel_lib.lib()
    return lib.tz_fused_region_member_size(), lib.tz_fused_region_table_size()


def fused_region(table: RegionTable, bufs: Dict[str, torch.Tensor],
                 counters: Optional[torch.Tensor]) -> None:
    """Run the region on the current stream: the ``tz_fused_region`` kernel
    (one launch per table) when its buffers are CUDA tensors (``counters``:
    2 x tiles zeroed int32 on the card, the group barriers),
    :func:`region_plain` when they are CPU tensors."""
    if table.counters is None or bufs is not table.bound \
            or counters is not table.counters:
        if bufs[table.members[0].operands[0]].device.type == "cpu":
            region_plain(table.members, bufs, table.tiles)
            return
        table.bind(bufs, counters)
    stream = torch.cuda.current_stream(table.counters.device).cuda_stream
    for t in table.tables:
        err = kernel_lib.lib().tz_fused_region(
            ctypes.addressof(t), table.counters.data_ptr(),
            table.blocks_per_group, stream)
        kernel_lib.check_launch("fused_region", err)
        LAUNCHES.hit("fused_region")
