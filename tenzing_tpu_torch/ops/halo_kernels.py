"""Halo pack/unpack kernels and the kernel menu.

Counterpart of ``tenzing_tpu/ops/halo_pallas.py``.  The reference offers, per
face, an XLA slice (``.xla``) and three Pallas kernels that differ only in DMA
choreography: one aligned window per face row (``.pallas``), BX rows per step
with a two-slot prefetch (``.pallasb``), and the batched kernel reading or
writing the dense (rows, 128) staging layout directly (``.pallasf``).  On
Hopper they are two hand-written CUDA kernels (csrc/halo_pack.cu,
csrc/halo_unpack.cu) whose ``rows_per_block`` keeps each slot's blocking:

=============  ===========================================  ===============
slot           pack                                          rows_per_block
=============  ===========================================  ===============
``.xla``       PyTorch indexing copy into the staging view   —
``.pallas``    halo_pack -> 4D face, then a flatten copy     1
``.pallasb``   halo_pack -> 4D face, then a flatten copy     ``_batch_rows``
``.pallasf``   halo_pack straight into the staging buffer    ``_batch_rows``
=============  ===========================================  ===============

(unpack mirrors it; its face is a view of the staging buffer, so no unflatten
copy exists.)  The flatten copy after ``.pallas``/``.pallasb`` is the XLA
flatten the reference runs outside its kernel, so each slot does the work it
does on the TPU and the search space keeps its meaning.

The menu gates (``_tile_window``, ``_batch_rows``, ``_face_bx``,
``_flat_ok``) are the reference's, unchanged: they define the search space,
and a schedule JSON must mean the same thing in both packages.

``halo_pack`` / ``halo_unpack`` launch the CUDA kernel for CUDA tensors and
run their plain PyTorch version (indexing plus ``copy_``) for CPU tensors;
there is no other path.  Each keeps a launch count in ``LAUNCHES``, in total
and by the body the library launched (``.tma`` or ``.simt``; a pack has
only the SIMT body): the library's own plan for the call
(:func:`library_plan`, asked once per face buffer and row length).
:func:`halo_launch_plan` mirrors the library's launch plan (the body, the
box, the ring, the grid, the tensor map) and :func:`tma_box_walk` the TMA
body's box walk; tests/test_torch_halo_plan.py holds them against the
source, and the card tests hold the library's plan against them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import torch

from tenzing_tpu_torch.core.operation import ChoiceOp, OpBase
from tenzing_tpu_torch.models.halo import (
    HaloArgs,
    _face_slices,
    dir_name,
    face_view,
    sublane_tile,
)
from tenzing_tpu_torch.models.halo_pipeline import (
    PackFlat,
    UnpackRecv,
    _padded_shape,
    unflatten_face,
)
from tenzing_tpu_torch.ops import kernel_lib

# kernel launches (CUDA path only; plain versions and CPU tensors do not count),
# in total and by body
LAUNCHES = kernel_lib.LaunchCounts("halo", {
    "halo_pack": 0, "halo_unpack": 0, "halo_pack.simt": 0,
    "halo_unpack.tma": 0, "halo_unpack.simt": 0})

# csrc/halo_copy.cuh's launch constants (tests/test_torch_halo_plan.py reads
# them from the source)
CONSUMER_WARPS = 4
TMA_THREADS = 32 * (1 + CONSUMER_WARPS)
BOX_BYTES = 8192
STAGES = 3
BLOCKS_PER_SM = 8
MAX_STAGES = 8
MAX_BOX_DIM = 256
STAGE_ALIGN = 128
SMEM_LIMIT = 232_448
SIMT_THREADS = 256
SIMT_RUNS = 4
H100_SMS = 132
BODIES = {"auto": 0, "tma": 1, "simt": 2}
PLAN_FIELDS = ("body", "bz", "by", "bx", "stages", "boxes", "group", "runs",
               "grid", "threads", "smem_bytes")


# -- menu gates (the reference's, tenzing_tpu/ops/halo_pallas.py:156-183,
# :544-562, :605-612) ----------------------------------------------------------


def _tile_window(y0: int, sy: int, z0: int, sz: int,
                 Y: int, Z: int, itemsize: int = 4) -> Tuple[int, int, int, int]:
    """(wy0, WH, wz0, WW): the tile-aligned bounding window of the face cut,
    clamped to the plane extents — the window the reference's kernels DMA.
    Here it only sizes ``_batch_rows``."""
    st = sublane_tile(itemsize)
    wy0 = (y0 // st) * st
    wy1 = min(-(-(y0 + sy) // st) * st, Y)
    wz0 = (z0 // 128) * 128
    wz1 = min(-(-(z0 + sz) // 128) * 128, Z)
    return wy0, wy1 - wy0, wz0, wz1 - wz0


def _batch_rows(sx: int, row_bytes: int, cap: int = 2_500_000) -> int:
    """Rows per block of the batched slots: the largest divisor of ``sx``
    whose window fits the reference's per-slot budget.  1 means the batched
    slot degenerates to the per-row one."""
    best = 1
    for b in range(1, sx + 1):
        if sx % b == 0 and b * row_bytes <= cap:
            best = b
    return best


def _face_bx(args: HaloArgs, d, which: str = "pack") -> int:
    """The batched slots' rows per block for this face (1 keeps ``.pallasb``
    off the menu).  ``which`` picks the pack (interior edge) or unpack (ghost
    shell) window, which can span a different number of sublane tiles."""
    itemsize = args.itemsize()
    starts, sizes = _face_slices(args, d, "pack")
    if which == "unpack":
        starts, _ = _face_slices(args, d, "unpack")
    _, sx, sy, sz = sizes
    _, _, y0, z0 = starts
    _, _, Y, Z = _padded_shape(args.local_shape(), itemsize)
    _, WH, _, WW = _tile_window(y0, sy, z0, sz, Y, Z, itemsize)
    return _batch_rows(sx, WH * WW * itemsize)


def _flat_ok(args: HaloArgs, d) -> bool:
    """Whether the direct-flat slot is on the menu: the face's trailing dim
    must be a multiple of 128 (the reference's gate; z-faces fail it)."""
    _, sizes = _face_slices(args, d, "pack")
    return sizes[3] % 128 == 0


def _rows_per_block(u: torch.Tensor, starts: Seq[int], sizes: Seq[int]) -> int:
    """``_batch_rows`` for the window of this cut in this grid — what the
    reference's batched kernels compute from their operands."""
    _, sx, sy, sz = sizes
    _, _, y0, z0 = starts
    _, WH, _, WW = _tile_window(y0, sy, z0, sz, u.shape[2], u.shape[3],
                                u.element_size())
    return _batch_rows(sx, WH * WW * u.element_size())


# -- kernel wrappers -----------------------------------------------------------


def _check_face_args(name: str, u: torch.Tensor, face: torch.Tensor,
                     starts: Seq[int], sizes: Seq[int], rows_per_block: int) -> int:
    """Validate one pack/unpack call; returns the face's element count."""
    if u.dtype != torch.float32 or face.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only (got {u.dtype}, {face.dtype})")
    if u.device != face.device:
        raise ValueError(f"{name}: U on {u.device}, face on {face.device}")
    if u.dim() != 4 or len(starts) != 4 or len(sizes) != 4:
        raise ValueError(f"{name}: U, starts and sizes must be 4D")
    if not (u.is_contiguous() and face.is_contiguous()):
        raise ValueError(f"{name}: U and the face buffer must be contiguous")
    for s, n, ext in zip(starts, sizes, u.shape):
        if s < 0 or n < 1 or s + n > ext:
            raise ValueError(f"{name}: cut {tuple(starts)}+{tuple(sizes)} "
                             f"outside U {tuple(u.shape)}")
    if starts[0] != 0:
        raise ValueError(f"{name}: the cut must start at q=0")
    nq, sx, sy, sz = (int(v) for v in sizes)
    if rows_per_block < 1 or sx % rows_per_block:
        raise ValueError(f"{name}: rows_per_block {rows_per_block} must divide "
                         f"sx={sx}")
    n = nq * sx * sy * sz
    if face.numel() < n:
        raise ValueError(f"{name}: face buffer holds {face.numel()} < {n} elements")
    return n


def halo_pack_plain(u: torch.Tensor, out: torch.Tensor, starts: Seq[int],
                    sizes: Seq[int]) -> None:
    """The plain PyTorch version of halo_pack: the first nq*sx*sy*sz
    elements of ``out`` := the face cut of ``u``, in order."""
    n = int(sizes[0] * sizes[1] * sizes[2] * sizes[3])
    out.view(-1)[:n].view(tuple(sizes)).copy_(face_view(u, starts, sizes))


def halo_unpack_plain(u: torch.Tensor, face: torch.Tensor, starts: Seq[int],
                      sizes: Seq[int]) -> None:
    """The plain PyTorch version of halo_unpack: the face cut of ``u`` := the
    first nq*sx*sy*sz elements of ``face``, in order."""
    n = int(sizes[0] * sizes[1] * sizes[2] * sizes[3])
    face_view(u, starts, sizes).copy_(face.view(-1)[:n].view(tuple(sizes)))


# -- the launch plan (the mirror of csrc/halo_copy.cuh's make_plan) ------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _balanced(n: int, cap: int) -> int:
    """The fewest boxes of at most ``cap`` along ``n``, all of one size."""
    return _cdiv(n, _cdiv(n, cap))


def tma_fits(sizes: Seq[int], face_ptr: int = 0) -> bool:
    """Whether an unpack of the cut can take the TMA body: a 16-byte aligned
    face and rows (sz) of a multiple of 4 floats."""
    return face_ptr % 16 == 0 and sizes[3] % 4 == 0


def halo_launch_plan(u_shape: Seq[int], starts: Seq[int], sizes: Seq[int],
                     pack: bool, face_ptr: int = 0, body: str = "auto",
                     sms: int = H100_SMS) -> Dict[str, object]:
    """What one pack (``pack``) or unpack of the cut launches: the library's
    fields (:data:`PLAN_FIELDS`, body as a name) and, for the TMA body, the
    face map it loads (``map``: dims and byte strides innermost first, the
    box) and the bytes in flight per SM when every block's ring is full.
    Raises ValueError where the library refuses the call."""
    nq, sx, sy, sz = (int(v) for v in sizes)
    _, X, Y, Z = (int(v) for v in u_shape)
    lim = 1 << 31
    if (min(sms, nq, sx, sy, sz) < 1
            or max(X, Y, Z, nq, nq * sx * sy) >= lim):
        raise ValueError(f"halo plan: cut {tuple(sizes)} out of range")
    fits = not pack and tma_fits(sizes, face_ptr)
    if body == "auto":
        body = "tma" if fits else "simt"
    if body not in ("tma", "simt") or (body == "tma" and not fits):
        raise ValueError(f"halo plan: body {body!r} cannot take the cut")
    plan: Dict[str, object] = dict.fromkeys(PLAN_FIELDS, 0)
    plan["body"] = body
    if body == "simt":
        g = 1
        while g < sz and g < SIMT_THREADS:
            g *= 2
        runs = nq * sx * sy
        plan.update(group=g, runs=runs, threads=SIMT_THREADS,
                    grid=_cdiv(runs, (SIMT_THREADS // g) * SIMT_RUNS))
        return plan
    bz = _cdiv(_balanced(sz, MAX_BOX_DIM), 4) * 4
    by = _balanced(sy, min(max(BOX_BYTES // (4 * bz), 1), MAX_BOX_DIM))
    bx = _balanced(sx, min(max(BOX_BYTES // (4 * bz * by), 1), MAX_BOX_DIM))
    boxes = _cdiv(sz, bz) * _cdiv(sy, by) * _cdiv(sx, bx) * nq
    stage = _cdiv(4 * bz * by * bx, STAGE_ALIGN) * STAGE_ALIGN
    smem = STAGE_ALIGN + STAGES * stage
    grid = min(boxes, sms * BLOCKS_PER_SM)
    if smem > SMEM_LIMIT - 16 * MAX_STAGES or boxes >= lim:
        raise ValueError(f"halo plan: a ring of {smem} bytes does not fit")
    plan.update(bz=bz, by=by, bx=bx, stages=STAGES, boxes=boxes, grid=grid,
                threads=TMA_THREADS, smem_bytes=smem)
    plan["map"] = {"dims": (sz, sy, sx, nq),
                   "strides": (4 * sz, 4 * sy * sz, 4 * sx * sy * sz),
                   "box": (bz, by, bx, 1)}
    plan["in_flight_per_sm"] = (grid / sms * min(STAGES, _cdiv(boxes, grid))
                                * 4 * bz * by * bx)
    return plan


def tma_box_walk(plan: Dict[str, object],
                 sizes: Seq[int]) -> List[List[Tuple[int, int, int, int]]]:
    """The TMA body's walk: per block, in the order it copies them (box
    b = block, block + grid, ...; z fastest, then y, x, q), each box's face
    origin (k, j, i, q), which is also the coordinate its load asks of the
    face map (innermost first)."""
    nq, sx, sy, sz = (int(v) for v in sizes)
    bz, by, bx = plan["bz"], plan["by"], plan["bx"]
    nbz, nby, nbx = _cdiv(sz, bz), _cdiv(sy, by), _cdiv(sx, bx)
    walk = []
    for blk in range(plan["grid"]):
        boxes = []
        for b in range(blk, plan["boxes"], plan["grid"]):
            cz, t = (b % nbz) * bz, b // nbz
            cy, t = (t % nby) * by, t // nby
            cx, q = (t % nbx) * bx, t // nbx
            boxes.append((cz, cy, cx, q))
        walk.append(boxes)
    return walk


def library_plan(u: torch.Tensor, face: torch.Tensor, starts: Seq[int],
                 sizes: Seq[int], pack: bool,
                 body: str = "auto") -> Dict[str, object]:
    """The built library's own plan for this call (``tz_halo_plan``), in
    :data:`PLAN_FIELDS` (body as a name); raises where it refuses."""
    _, X, Y, Z = u.shape
    out = (ctypes.c_int64 * len(PLAN_FIELDS))()
    err = kernel_lib.lib().tz_halo_plan(
        face.data_ptr(), int(sizes[0]), X, Y, Z, int(starts[1]),
        int(starts[2]), int(starts[3]), int(sizes[1]), int(sizes[2]),
        int(sizes[3]), int(pack), BODIES[body], out)
    kernel_lib.check_launch("tz_halo_plan", err)
    plan = dict(zip(PLAN_FIELDS, list(out)))
    plan["body"] = {v: k for k, v in BODIES.items()}[plan["body"]]
    return plan


def _launch(fn: str, u: torch.Tensor, face: torch.Tensor, starts: Seq[int],
            sizes: Seq[int], rows_per_block: int, extra: tuple = ()) -> None:
    """Call the C entry point ``fn`` on CUDA tensors."""
    _, X, Y, Z = u.shape
    err = getattr(kernel_lib.lib(), fn)(
        u.data_ptr(), face.data_ptr(), int(sizes[0]), X, Y, Z, int(starts[1]),
        int(starts[2]), int(starts[3]), int(sizes[1]), int(sizes[2]),
        int(sizes[3]), int(rows_per_block), *extra,
        torch.cuda.current_stream(u.device).cuda_stream)
    kernel_lib.check_launch(fn, err)


# (kind, face address, sz) -> the LAUNCHES key of the body the library picks
_LAUNCHED: Dict[tuple, str] = {}


def _launched(key: tuple, u: torch.Tensor, face: torch.Tensor,
              starts: Seq[int], sizes: Seq[int]) -> str:
    """The ``LAUNCHES`` key of the body the library launched for the call
    that ``key`` (kind, face address, sz) names: the body its own plan
    names (:func:`library_plan`), asked once per key.  These are all that
    the library's choice of body reads; the card tests hold
    :func:`halo_launch_plan`'s choice against the library's on every cut."""
    if len(_LAUNCHED) >= 4096:  # buffers come and go off the main path
        _LAUNCHED.clear()
    name = _LAUNCHED[key] = f"halo_{key[0]}." + library_plan(
        u, face, starts, sizes, key[0] == "pack")["body"]
    return name


def launch_body(kind: str, u: torch.Tensor, face: torch.Tensor,
                starts: Seq[int], sizes: Seq[int], rows_per_block: int = 1,
                body: str = "auto") -> None:
    """``kind`` ("pack" or "unpack") on CUDA tensors, not counted in
    ``LAUNCHES``: for the card tests and bench/halo_kernels.py, never the
    main path.  An unpack runs with the body named (``tz_halo_unpack_ex``;
    the library refuses a TMA body the cut does not allow); a pack has one
    body, SIMT, so ``body`` "tma" is refused here."""
    _check_face_args(f"halo_{kind}", u, face, starts, sizes, rows_per_block)
    if u.device.type != "cuda":
        raise ValueError(f"launch_body: CUDA tensors only (got {u.device})")
    if kind == "pack":
        if body == "tma":
            raise ValueError("launch_body: a pack has no TMA body")
        _launch("tz_halo_pack", u, face, starts, sizes, rows_per_block)
    else:
        _launch("tz_halo_unpack_ex", u, face, starts, sizes, rows_per_block,
                (BODIES[body],))


def halo_pack(u: torch.Tensor, out: torch.Tensor, starts: Seq[int],
              sizes: Seq[int], rows_per_block: int = 1) -> None:
    """Gather the face cut ``starts``+``sizes`` of ``u`` into the first
    nq*sx*sy*sz elements of the contiguous ``out`` (a 4D face or a staging
    buffer), on the current stream: the halo_pack kernel for CUDA tensors,
    :func:`halo_pack_plain` for CPU tensors."""
    _check_face_args("halo_pack", u, out, starts, sizes, rows_per_block)
    if u.device.type == "cpu":
        halo_pack_plain(u, out, starts, sizes)
        return
    if u.device.type != "cuda":
        raise ValueError(f"halo_pack: unsupported device {u.device}")
    _launch("tz_halo_pack", u, out, starts, sizes, rows_per_block)
    LAUNCHES.hit("halo_pack")
    key = ("pack", out.data_ptr(), sizes[3])
    LAUNCHES.hit(_LAUNCHED.get(key)
                 or _launched(key, u, out, starts, sizes))


def halo_unpack(u: torch.Tensor, face: torch.Tensor, starts: Seq[int],
                sizes: Seq[int], rows_per_block: int = 1) -> None:
    """Scatter the first nq*sx*sy*sz elements of the contiguous ``face`` into
    the cut ``starts``+``sizes`` of ``u``, in place, on the current stream:
    the halo_unpack kernel for CUDA tensors, :func:`halo_unpack_plain` for CPU
    tensors."""
    _check_face_args("halo_unpack", u, face, starts, sizes, rows_per_block)
    if u.device.type == "cpu":
        halo_unpack_plain(u, face, starts, sizes)
        return
    if u.device.type != "cuda":
        raise ValueError(f"halo_unpack: unsupported device {u.device}")
    _launch("tz_halo_unpack", u, face, starts, sizes, rows_per_block)
    LAUNCHES.hit("halo_unpack")
    key = ("unpack", face.data_ptr(), sizes[3])
    LAUNCHES.hit(_LAUNCHED.get(key)
                 or _launched(key, u, face, starts, sizes))


# -- ops + choice menu ---------------------------------------------------------


class _KernelPack(PackFlat):
    """A pack slot running halo_pack.  ``FLAT``: the kernel writes the
    staging buffer itself; otherwise it writes the direction's 4D face
    scratch, and a PyTorch copy flattens it into the staging buffer.
    ``BATCHED``: rows per block from ``_batch_rows``, else 1."""

    SUFFIX = ""
    FLAT = False
    BATCHED = False

    def __init__(self, args: HaloArgs, d):
        super().__init__(args, d)
        self._name = f"pack_{dir_name(d)}{self.SUFFIX}"

    def _face_name(self) -> str:
        return f"face_{dir_name(self._d)}"

    def uses_pallas(self) -> bool:
        return True

    def scratch(self):
        if self.FLAT:
            return {}
        _, sizes = _face_slices(self._args, self._d, "pack")
        return {self._face_name(): (tuple(sizes), self._args.dtype)}

    def apply(self, bufs, ctx):
        starts, sizes = _face_slices(self._args, self._d, "pack")
        u = bufs["U"]
        staging = bufs[f"buf_{dir_name(self._d)}"]
        rpb = _rows_per_block(u, starts, sizes) if self.BATCHED else 1
        out = staging if self.FLAT else ctx.scratch[self._face_name()]
        if ctx.plain_kernels:
            halo_pack_plain(u, out, starts, sizes)
        else:
            halo_pack(u, out, starts, sizes, rpb)
        if not self.FLAT:
            unflatten_face(staging, sizes).copy_(out)


class _KernelUnpack(UnpackRecv):
    """An unpack slot running halo_unpack on the received staging buffer
    (its face view: no unflatten copy is needed)."""

    SUFFIX = ""
    BATCHED = False

    def __init__(self, args: HaloArgs, d):
        super().__init__(args, d)
        self._name = f"unpack_{dir_name(d)}{self.SUFFIX}"

    def uses_pallas(self) -> bool:
        return True

    def apply(self, bufs, ctx):
        starts, _ = _face_slices(self._args, self._d, "unpack")
        _, sizes = _face_slices(self._args, self._d, "pack")
        u = bufs["U"]
        recv = bufs[f"recv_{dir_name(self._d)}"]
        rpb = _rows_per_block(u, starts, sizes) if self.BATCHED else 1
        if ctx.plain_kernels:
            halo_unpack_plain(u, recv, starts, sizes)
        else:
            halo_unpack(u, recv, starts, sizes, rpb)


class PackXla(PackFlat):
    """The plain PyTorch indexing pack under its menu name."""

    def __init__(self, args: HaloArgs, d):
        super().__init__(args, d)
        self._name = f"pack_{dir_name(d)}.xla"


class PackPallas(_KernelPack):
    """halo_pack one face row per block into the 4D face, then flatten
    (reference pack_face_pallas)."""

    SUFFIX = ".pallas"


class PackPallasB(_KernelPack):
    """halo_pack with batched rows into the 4D face, then flatten (reference
    pack_face_pallas_batched)."""

    SUFFIX = ".pallasb"
    BATCHED = True


class PackPallasF(_KernelPack):
    """halo_pack with batched rows straight into the staging buffer
    (reference pack_face_flat_pallas)."""

    SUFFIX = ".pallasf"
    BATCHED = True
    FLAT = True


class UnpackXla(UnpackRecv):
    """The plain PyTorch indexing unpack under its menu name."""

    def __init__(self, args: HaloArgs, d):
        super().__init__(args, d)
        self._name = f"unpack_{dir_name(d)}.xla"


class UnpackPallas(_KernelUnpack):
    """halo_unpack one face row per block (reference unpack_face_pallas)."""

    SUFFIX = ".pallas"


class UnpackPallasB(_KernelUnpack):
    """halo_unpack with batched rows (reference unpack_face_pallas_batched)."""

    SUFFIX = ".pallasb"
    BATCHED = True


class UnpackPallasF(_KernelUnpack):
    """halo_unpack with batched rows from the staging buffer (reference
    unpack_face_flat_pallas)."""

    SUFFIX = ".pallasf"
    BATCHED = True


class PackChoice(ChoiceOp):
    """The pack kernel menu for one direction (the reference's storage-order
    kernel-family selection as a searched ChoiceOp)."""

    def __init__(self, args: HaloArgs, d):
        super().__init__(f"pack_{dir_name(d)}")
        self._args, self._d = args, tuple(d)

    def choices(self) -> List[OpBase]:
        menu: List[OpBase] = [
            PackXla(self._args, self._d), PackPallas(self._args, self._d)
        ]
        if _face_bx(self._args, self._d) > 1:
            menu.append(PackPallasB(self._args, self._d))
        if _flat_ok(self._args, self._d):
            menu.append(PackPallasF(self._args, self._d))
        return menu


class UnpackChoice(ChoiceOp):
    def __init__(self, args: HaloArgs, d):
        super().__init__(f"unpack_{dir_name(d)}")
        self._args, self._d = args, tuple(d)

    def choices(self) -> List[OpBase]:
        menu: List[OpBase] = [
            UnpackXla(self._args, self._d), UnpackPallas(self._args, self._d)
        ]
        if _face_bx(self._args, self._d, which="unpack") > 1:
            menu.append(UnpackPallasB(self._args, self._d))
        if _flat_ok(self._args, self._d):
            menu.append(UnpackPallasF(self._args, self._d))
        return menu
