"""The launch plan of the halo kernels (csrc/halo_copy.cuh), on the CPU.

``ops/halo_kernels.halo_launch_plan`` mirrors the library's plan (which body,
the box, the ring, the grid, the face's tensor map) and ``tma_box_walk`` the
unpack's TMA box walk; their constants are read here from the source.  A
numpy emulation of both bodies' walks (the TMA body: each face box loaded
through its map with zeros past the map's dims, then the consumer warps' row
stores into U; the SIMT body: each thread's runs and lanes) must copy
exactly what ``halo_pack_plain`` / ``halo_unpack_plain`` copy, bit for bit,
and what the reference's Pallas kernels compute in interpret mode.  The
library's own plan is held against the mirror on the card
(tests/test_torch_halo_kernels.py, marker ``needs_cuda``)."""

import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenzing_tpu.ops import halo_pallas as ref
from tenzing_tpu_torch.models.halo import DIRECTIONS, HaloArgs, _face_slices, dir_name
from tenzing_tpu_torch.models.halo_pipeline import _padded_shape
from tenzing_tpu_torch.ops import halo_kernels as hk

SOURCE = (Path(__file__).resolve().parents[1] / "tenzing_tpu_torch" / "csrc"
          / "halo_copy.cuh").read_text()

# (HaloArgs, U padded as the pipeline pads it): the flagship, the test sizes
# of tests/test_torch_halo_kernels.py, and its card shapes.  r1-nq2's x and
# y unpacks end in a ragged box along z, y and x
SHAPES = {
    "flagship": (dict(nq=3, lx=512, ly=512, lz=512, radius=3), True),
    "smoke": (dict(nq=2, lx=4, ly=4, lz=4, radius=1), True),
    "multiblock": (dict(nq=2, lx=64, ly=2, lz=1200, radius=2), True),
    "flat": (dict(nq=1, lx=8, ly=64, lz=128, radius=2), True),
    "r1-nq2": (dict(nq=2, lx=41, ly=37, lz=300, radius=1), True),
    "r2-lz30": (dict(nq=1, lx=24, ly=20, lz=30, radius=2), True),
    "unpadded-nq2": (dict(nq=2, lx=30, ly=28, lz=26, radius=2), False),
    "unpadded-z4": (dict(nq=2, lx=20, ly=12, lz=36, radius=2), False),
}
SMALL = [s for s in SHAPES if s != "flagship"]
SMEM_PER_SM = 233_472  # 228 KB: what one SM's blocks share
THREADS_PER_SM = 2048


def _constexpr(name: str) -> str:
    found = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert found, name
    return found.group(1).strip()


def _shape(name):
    kw, padded = SHAPES[name]
    args = HaloArgs(**kw)
    return args, (_padded_shape(args.local_shape()) if padded
                  else args.local_shape())


def _cuts(name):
    """(direction, pack, starts, sizes) of every cut of the grid."""
    args, _ = _shape(name)
    for d, pack in itertools.product(DIRECTIONS, (True, False)):
        starts, _ = _face_slices(args, d, "pack" if pack else "unpack")
        _, sizes = _face_slices(args, d, "pack")
        yield d, pack, starts, sizes


def _tma_plans(name):
    """The TMA plan of every cut of the grid that takes one (the unpacks
    whose rows are a multiple of 4 floats)."""
    _, shape = _shape(name)
    for d, pack, starts, sizes in _cuts(name):
        plan = hk.halo_launch_plan(shape, starts, sizes, pack)
        if plan["body"] == "tma":
            yield d, starts, sizes, plan


def test_constants_match_the_source():
    for name, value in (("kConsumerWarps", hk.CONSUMER_WARPS),
                        ("kBoxBytes", hk.BOX_BYTES), ("kStages", hk.STAGES),
                        ("kBlocksPerSm", hk.BLOCKS_PER_SM),
                        ("kMaxStages", hk.MAX_STAGES),
                        ("kMaxBoxDim", hk.MAX_BOX_DIM),
                        ("kStageAlign", hk.STAGE_ALIGN),
                        ("kSmemLimit", hk.SMEM_LIMIT),
                        ("kSimtThreads", hk.SIMT_THREADS),
                        ("kSimtRuns", hk.SIMT_RUNS),
                        ("kPlanFields", len(hk.PLAN_FIELDS))):
        assert int(_constexpr(name)) == value, name
    assert _constexpr("kTmaThreads") == "32 * (1 + kConsumerWarps)"
    assert hk.TMA_THREADS == 32 * (1 + hk.CONSUMER_WARPS)
    assert _constexpr("kRingLimit") == "kSmemLimit - 16 * kMaxStages"
    # the Plan struct's fields, in the order tz_halo_plan writes them out
    body = re.search(r"struct Plan \{\s*int64_t ([^;]+);", SOURCE).group(1)
    fields = [f.strip() for f in body.split(",")]
    assert fields == [f.replace("smem_bytes", "smem") for f in hk.PLAN_FIELDS]


@pytest.mark.parametrize("name", list(SHAPES))
def test_bodies_by_cut(name):
    """TMA takes the unpacks whose rows are a multiple of 4 floats, from a
    16-byte aligned face, wherever U lies; everything else (every pack, the
    z faces, a misaligned face) takes SIMT, and a TMA body named for such a
    cut is refused."""
    _, shape = _shape(name)
    for d, pack, starts, sizes in _cuts(name):
        want = "simt" if pack or sizes[3] % 4 else "tma"
        assert hk.halo_launch_plan(shape, starts, sizes, pack)["body"] == want
        if name == "flagship":
            assert want == ("simt" if pack or d[2] else "tma")
        plan = hk.halo_launch_plan(shape, starts, sizes, pack, face_ptr=4)
        assert plan["body"] == "simt"
        if want == "simt":
            with pytest.raises(ValueError):
                hk.halo_launch_plan(shape, starts, sizes, pack, body="tma")


@pytest.mark.parametrize("name", list(SHAPES))
def test_tma_boxes_fit_the_hardware(name):
    """Every box dim is at most 256, the box's rows are a multiple of 16
    bytes and every load starts on a 16-byte boundary, the map's strides are
    multiples of 16 bytes, and the ring and the blocks an SM holds fit its
    shared memory and threads."""
    for d, starts, sizes, plan in _tma_plans(name):
        bz, by, bx = plan["bz"], plan["by"], plan["bx"]
        assert 1 <= min(bz, by, bx) and max(bz, by, bx) <= hk.MAX_BOX_DIM
        assert plan["map"]["box"] == (bz, by, bx, 1)
        assert plan["map"]["dims"] == (sizes[3], sizes[2], sizes[1], sizes[0])
        assert (4 * bz) % 16 == 0
        assert all(s % 16 == 0 for s in plan["map"]["strides"])
        for boxes in hk.tma_box_walk(plan, sizes):
            for load in boxes:
                assert (4 * load[0]) % 16 == 0, (d, load)
        barriers = 16 * hk.MAX_STAGES
        assert plan["smem_bytes"] + barriers <= hk.SMEM_LIMIT
        per_sm = hk.BLOCKS_PER_SM
        assert per_sm * (plan["smem_bytes"] + barriers + 1024) <= SMEM_PER_SM
        assert per_sm * plan["threads"] <= THREADS_PER_SM


def _stored(plan, sizes, origin):
    """The face slices one box's consumer warps store."""
    nq, sx, sy, sz = sizes
    cz, cy, cx, q = origin
    return (q, slice(cx, min(cx + plan["bx"], sx)),
            slice(cy, min(cy + plan["by"], sy)),
            slice(cz, min(cz + plan["bz"], sz)))


@pytest.mark.parametrize("name", list(SHAPES))
def test_tma_boxes_cover_each_cut_once(name):
    """The walk visits every box once over the blocks and the boxes' stored
    rows tile the cut exactly once; r1-nq2's boxes end ragged along each of
    z, y and x."""
    ragged = set()
    for d, starts, sizes, plan in _tma_plans(name):
        walk = hk.tma_box_walk(plan, sizes)
        assert len(walk) == plan["grid"]
        assert sum(len(b) for b in walk) == plan["boxes"]
        count = np.zeros(sizes, dtype=np.int16)
        for boxes in walk:
            for origin in boxes:
                count[_stored(plan, sizes, origin)] += 1
        assert (count == 1).all(), (name, dir_name(d))
        ragged |= {axis for axis, n, b in zip("zyx", sizes[::-1],
                                               (plan["bz"], plan["by"],
                                                plan["bx"])) if n % b}
    if name == "r1-nq2":
        assert ragged == set("zyx")


def _emulate_tma(u, face, plan, starts, sizes):
    """The unpack's TMA body on numpy arrays: each box loaded through the
    face's map (zeros past its dims) into a (bx, by, bz) stage, then the
    consumer warps' rows into U."""
    nq, sx, sy, sz = sizes
    _, x0, y0, z0 = starts
    src = face.reshape(sizes)
    bz, by, bx = plan["bz"], plan["by"], plan["bx"]
    for boxes in hk.tma_box_walk(plan, sizes):
        for cz, cy, cx, q in boxes:
            stage = np.zeros((bx, by, bz), dtype=np.float32)
            ez, ey, ex = min(cz + bz, sz), min(cy + by, sy), min(cx + bx, sx)
            stage[:ex - cx, :ey - cy, :ez - cz] = src[q, cx:ex, cy:ey, cz:ez]
            kv = min(bz, sz - cz)
            for r in range(by * bx):
                ii, jj = divmod(r, by)
                if cy + jj >= sy or cx + ii >= sx:
                    continue
                u[q, x0 + cx + ii, y0 + cy + jj,
                  z0 + cz:z0 + cz + kv] = stage[ii, jj, :kv]


def _simt_pairs(plan, sizes):
    """(run, k) of every element the SIMT body's threads copy, in thread
    order: block b, thread t, run slot r, then k."""
    g = plan["group"]
    lanes = hk.SIMT_THREADS // g
    b, t, r = np.meshgrid(np.arange(plan["grid"]), np.arange(hk.SIMT_THREADS),
                          np.arange(hk.SIMT_RUNS), indexing="ij")
    run = b * lanes * hk.SIMT_RUNS + t // g + r * lanes
    k0 = t % g
    runs, ks = [], []
    for m in range(-(-sizes[3] // g)):
        k = k0 + m * g
        live = (run < plan["runs"]) & (k < sizes[3])
        runs.append(run[live])
        ks.append(k[live])
    return np.concatenate(runs), np.concatenate(ks)


def _emulate_simt(u, face, plan, starts, sizes, pack):
    nq, sx, sy, sz = sizes
    _, x0, y0, z0 = starts
    _, X, Y, Z = u.shape
    run, k = _simt_pairs(plan, sizes)
    qi, j = np.divmod(run, sy)
    q, i = np.divmod(qi, sx)
    uo = ((q * X + x0 + i) * Y + y0 + j) * Z + z0 + k
    fo = run * sz + k
    if pack:
        face.reshape(-1)[fo] = u.reshape(-1)[uo]
    else:
        u.reshape(-1)[uo] = face.reshape(-1)[fo]


@pytest.mark.parametrize("name", SMALL)
def test_simt_walk_covers_each_cut_once(name):
    _, shape = _shape(name)
    for d, pack, starts, sizes in _cuts(name):
        plan = hk.halo_launch_plan(shape, starts, sizes, pack, body="simt")
        run, k = _simt_pairs(plan, sizes)
        flat = run * sizes[3] + k
        assert np.array_equal(np.sort(flat), np.arange(int(np.prod(sizes))))


def test_flagship_simt_walk_covers_the_z_faces_once():
    _, shape = _shape("flagship")
    for d, pack, starts, sizes in _cuts("flagship"):
        if not d[2]:
            continue
        plan = hk.halo_launch_plan(shape, starts, sizes, pack)
        assert plan["body"] == "simt" and plan["group"] == 4
        run, k = _simt_pairs(plan, sizes)
        assert np.array_equal(np.bincount(run * 3 + k),
                              np.ones(int(np.prod(sizes)), dtype=np.int64))


CANARY = np.float32(-12345.5)


def _emulate(u, face, plan, starts, sizes, pack):
    if plan["body"] == "tma":
        _emulate_tma(u, face, plan, starts, sizes)
    else:
        _emulate_simt(u, face, plan, starts, sizes, pack)


@pytest.mark.parametrize("name", SMALL)
def test_emulated_walks_match_the_plain_versions(name):
    """Both bodies' walks copy what the plain versions copy, bit for bit;
    an unpack leaves every cell outside its cut as it was (U filled with a
    canary)."""
    _, shape = _shape(name)
    rng = np.random.default_rng(31)
    u0 = rng.random(shape, dtype=np.float32)
    for d, pack, starts, sizes in _cuts(name):
        n = int(np.prod(sizes))
        plans = [hk.halo_launch_plan(shape, starts, sizes, pack, body=body)
                 for body in ("simt", "auto")]
        for plan in plans:
            if pack:
                face = np.zeros(n + 128, dtype=np.float32)
                _emulate(u0, face[:n], plan, starts, sizes, True)
                want = torch.zeros(n + 128)
                hk.halo_pack_plain(torch.from_numpy(u0), want, starts, sizes)
                np.testing.assert_array_equal(face, want.numpy())
            else:
                face = rng.random(n, dtype=np.float32)
                u = np.full(shape, CANARY, dtype=np.float32)
                _emulate(u, face, plan, starts, sizes, False)
                want = torch.full(shape, float(CANARY))
                hk.halo_unpack_plain(want, torch.from_numpy(face), starts,
                                     sizes)
                np.testing.assert_array_equal(u, want.numpy())


@pytest.mark.parametrize("name", ["smoke", "multiblock", "flat"])
def test_emulated_walks_match_the_reference_kernels(name):
    """The library's own pick of body for each cut, emulated, against the
    reference's per-row Pallas kernels in interpret mode."""
    args, shape = _shape(name)
    rng = np.random.default_rng(32)
    u0 = rng.random(shape, dtype=np.float32)
    for d in DIRECTIONS:
        starts, sizes = _face_slices(args, d, "pack")
        ustarts, _ = _face_slices(args, d, "unpack")
        n = int(np.prod(sizes))
        face = np.zeros(n, dtype=np.float32)
        plan = hk.halo_launch_plan(shape, starts, sizes, True)
        _emulate(u0, face, plan, starts, sizes, True)
        want = np.asarray(ref.pack_face_pallas(
            jnp.asarray(u0), tuple(starts), tuple(sizes), interpret=True))
        np.testing.assert_array_equal(face.reshape(sizes), want)
        recv = rng.random(n, dtype=np.float32)
        u = u0.copy()
        plan = hk.halo_launch_plan(shape, ustarts, sizes, False)
        _emulate(u, recv, plan, ustarts, sizes, False)
        want = np.asarray(ref.unpack_face_pallas(
            jnp.asarray(u0), jnp.asarray(recv.reshape(sizes)), tuple(ustarts),
            interpret=True))
        np.testing.assert_array_equal(u, want)


def test_flagship_plan_numbers():
    """The flagship's x and y faces: the boxes, the ring and the grid of the
    unpacks' TMA body on 132 SMs, and the packs' SIMT grid."""
    _, shape = _shape("flagship")
    got = {}
    for d, pack, starts, sizes in _cuts("flagship"):
        if d[2]:
            continue
        plan = hk.halo_launch_plan(shape, starts, sizes, pack)
        got[(dir_name(d)[1], pack)] = (
            (plan["group"], plan["runs"], plan["grid"]) if pack else
            (plan["bz"], plan["by"], plan["bx"], plan["boxes"], plan["grid"]))
    assert got[("x", True)] == (256, 3 * 3 * 512, 3 * 3 * 512 // 4)
    assert got[("x", False)] == (256, 8, 1, 3 * 3 * 64 * 2, 1056)
    assert got[("y", True)] == (256, 3 * 512 * 3, 3 * 512 * 3 // 4)
    assert got[("y", False)] == (256, 3, 2, 3 * 256 * 2, 1056)
