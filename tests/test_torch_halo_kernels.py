"""The port's halo pack/unpack and device-copy kernels against the JAX
package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference kernels run in the Pallas interpreter (``interpret=True``) as
tests/test_halo_pipeline.py runs them.  Both are pure data movement, so the
comparison is exact (tolerance 0).  The same numpy inputs feed both.  The
menu gates must be the reference's functions on every shape, so the two
packages offer the same search space.

The ``test_cuda_*`` tests need the card (marker ``needs_cuda``): ``python -m
pytest tests/test_torch_halo_kernels.py -m needs_cuda`` on the machine with
the GPU.  They hold both bodies of the kernels (TMA and SIMT, forced through
``launch_body``) bit-exact against the plain versions on every face and slot,
at the flagship and at odd shapes, the library's launch plan against
:func:`halo_launch_plan`, the cells outside every unpack's cut against a
canary, and unpacks on two streams at once against the same unpacks in
turn."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenzing_tpu.models.halo import HaloArgs as RefArgs
from tenzing_tpu.models.halo_pipeline import _padded_shape as ref_padded_shape
from tenzing_tpu.models.halo_pipeline import flatten_face as ref_flatten_face
from tenzing_tpu.ops import halo_pallas as ref
from tenzing_tpu.ops.rdma import rdma_copy_fused_local
from tenzing_tpu_torch.models.halo import (
    DIRECTIONS,
    HaloArgs,
    _face_slices,
    dir_name,
    face_view,
)
from tenzing_tpu_torch.models.halo_pipeline import _padded_shape, flatten_face
from tenzing_tpu_torch.ops import halo_kernels as hk
from tenzing_tpu_torch.ops import rdma

# tests/test_halo_pipeline.py's sizes: smoke, multi-block batched, flat
SIZES = {
    "smoke": dict(nq=2, lx=4, ly=4, lz=4, radius=1),
    "multiblock": dict(nq=2, lx=64, ly=2, lz=1200, radius=2),
    "flat": dict(nq=1, lx=8, ly=64, lz=128, radius=2),
}


def _grid(kw, seed):
    shape = _padded_shape(HaloArgs(**kw).local_shape())
    assert shape == ref_padded_shape(RefArgs(**kw).local_shape())
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _cases():
    for size, d in itertools.product(SIZES, DIRECTIONS):
        yield pytest.param(size, d, id=f"{size}-{dir_name(d)}")


@pytest.mark.parametrize("size,d", list(_cases()))
def test_pack_slots_match_reference_kernels(size, d):
    kw = SIZES[size]
    args = HaloArgs(**kw)
    u_np = _grid(kw, seed=11)
    u = torch.from_numpy(u_np.copy())
    starts, sizes = _face_slices(args, d, "pack")
    uj = jnp.asarray(u_np)
    # .pallas: one row per block, 4D face
    want = np.asarray(ref.pack_face_pallas(uj, tuple(starts), tuple(sizes),
                                           interpret=True))
    got = torch.zeros(tuple(sizes))
    hk.halo_pack(u, got, starts, sizes, rows_per_block=1)
    np.testing.assert_array_equal(got.numpy(), want)
    # .pallasb: batched rows, 4D face
    want_b = np.asarray(ref.pack_face_pallas_batched(
        uj, tuple(starts), tuple(sizes), interpret=True))
    got_b = torch.zeros(tuple(sizes))
    hk.halo_pack(u, got_b, starts, sizes,
                 rows_per_block=hk._rows_per_block(u, starts, sizes))
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    # .pallasf: straight into the (rows, 128) staging layout
    if hk._flat_ok(args, d):
        want_f = np.asarray(ref.pack_face_flat_pallas(
            uj, tuple(starts), tuple(sizes), interpret=True))
        got_f = torch.zeros(want_f.shape)
        hk.halo_pack(u, got_f, starts, sizes,
                     rows_per_block=hk._rows_per_block(u, starts, sizes))
        np.testing.assert_array_equal(got_f.numpy(), want_f)
    # the staged result of every slot: the reference's flatten of the face
    want_flat = np.asarray(ref_flatten_face(jnp.asarray(want), sizes))
    staging = torch.zeros(want_flat.shape)
    hk.halo_pack(u, staging, starts, sizes)
    np.testing.assert_array_equal(staging.numpy(), want_flat)
    np.testing.assert_array_equal(
        flatten_face(torch.from_numpy(want.copy()), sizes).numpy(), want_flat)


@pytest.mark.parametrize("size,d", list(_cases()))
def test_unpack_slots_match_reference_kernels(size, d):
    kw = SIZES[size]
    args = HaloArgs(**kw)
    rng = np.random.default_rng(12)
    u_np = _grid(kw, seed=13)
    starts, _ = _face_slices(args, d, "unpack")
    _, sizes = _face_slices(args, d, "pack")
    face_np = rng.random(tuple(sizes), dtype=np.float32)
    uj, fj = jnp.asarray(u_np), jnp.asarray(face_np)
    want = np.asarray(ref.unpack_face_pallas(uj, fj, tuple(starts),
                                             interpret=True))
    u = torch.from_numpy(u_np.copy())
    hk.halo_unpack(u, torch.from_numpy(face_np), starts, sizes, rows_per_block=1)
    np.testing.assert_array_equal(u.numpy(), want)
    want_b = np.asarray(ref.unpack_face_pallas_batched(uj, fj, tuple(starts),
                                                       interpret=True))
    u = torch.from_numpy(u_np.copy())
    hk.halo_unpack(u, torch.from_numpy(face_np), starts, sizes,
                   rows_per_block=hk._rows_per_block(u, starts, sizes))
    np.testing.assert_array_equal(u.numpy(), want_b)
    if hk._flat_ok(args, d):
        flat = np.asarray(ref_flatten_face(fj, sizes))
        want_f = np.asarray(ref.unpack_face_flat_pallas(
            uj, jnp.asarray(flat), tuple(starts), tuple(sizes), interpret=True))
        u = torch.from_numpy(u_np.copy())
        hk.halo_unpack(u, torch.from_numpy(flat.copy()), starts, sizes,
                       rows_per_block=hk._rows_per_block(u, starts, sizes))
        np.testing.assert_array_equal(u.numpy(), want_f)


@pytest.mark.parametrize("shape", [(18, 128), (7, 128), (1, 3)])
def test_device_copy_matches_reference_rdma_copy(shape):
    x = np.random.default_rng(14).random(shape, dtype=np.float32)
    want = np.asarray(rdma_copy_fused_local(jnp.asarray(x), interpret=True))
    dst = torch.zeros(shape)
    rdma.device_copy(torch.from_numpy(x), dst)
    np.testing.assert_array_equal(dst.numpy(), want)


def _gate_shapes():
    out = [RefArgs(nq=3, lx=512, ly=512, lz=512, radius=3)]
    for n, r, nq in itertools.product((4, 8, 33, 64, 128, 200, 256),
                                      (1, 2, 3), (1, 3)):
        out.append(RefArgs(nq=nq, lx=n, ly=n, lz=n, radius=r))
    out.append(RefArgs(nq=2, lx=64, ly=2, lz=1200, radius=2))
    out.append(RefArgs(nq=1, lx=8, ly=64, lz=128, radius=2))
    out.append(RefArgs(nq=1, lx=16, ly=16, lz=16, radius=1, dtype="bfloat16"))
    return out


def test_menu_gates_equal_reference():
    for ra in _gate_shapes():
        pa = HaloArgs(nq=ra.nq, lx=ra.lx, ly=ra.ly, lz=ra.lz, radius=ra.radius,
                      dtype=ra.dtype)
        for d in DIRECTIONS:
            assert hk._face_bx(pa, d) == ref._face_bx(ra, d)
            assert hk._face_bx(pa, d, "unpack") == ref._face_bx(ra, d, "unpack")
            assert hk._flat_ok(pa, d) == ref._flat_ok(ra, d)
            assert ([c.name() for c in hk.PackChoice(pa, d).choices()]
                    == [c.name() for c in ref.PackChoice(ra, d).choices()])
            assert ([c.name() for c in hk.UnpackChoice(pa, d).choices()]
                    == [c.name() for c in ref.UnpackChoice(ra, d).choices()])
    for args in itertools.product((0, 3, 5, 8, 13), (1, 3, 6, 64),
                                  (0, 3, 128, 131), (3, 128, 512),
                                  (8, 70, 520), (128, 640), (1, 2, 4)):
        y0, sy, z0, sz, Y, Z, itemsize = args
        assert hk._tile_window(y0, sy, z0, sz, Y, Z, itemsize) == \
            ref._tile_window(y0, sy, z0, sz, Y, Z, itemsize)
    for sx, row_bytes in itertools.product((1, 3, 6, 64, 512),
                                           (4, 1000, 30720, 2_621_440)):
        assert hk._batch_rows(sx, row_bytes) == ref._batch_rows(sx, row_bytes)


def test_flagship_menu_sizes():
    """At 512^3: x-faces batch one row (no .pallasb), z-faces fail the lane
    gate (no .pallasf), y-faces get all four — as in the reference."""
    args = HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3)
    assert [len(hk.PackChoice(args, d).choices()) for d in DIRECTIONS] == [
        3, 3, 4, 4, 3, 3]


@pytest.mark.parametrize("bad", ["dtype", "bounds", "rows", "small", "noncontig"])
def test_wrappers_reject_bad_arguments(bad):
    u = torch.zeros((2, 6, 8, 128))
    starts, sizes = [0, 1, 1, 1], [2, 2, 2, 2]
    out = torch.zeros(16)
    if bad == "dtype":
        u = u.double()
    elif bad == "bounds":
        starts = [0, 5, 1, 1]
    elif bad == "rows":
        sizes = [2, 3, 2, 2]
        out = torch.zeros(24)
        with pytest.raises(ValueError):
            hk.halo_pack(u, out, starts, sizes, rows_per_block=2)
        return
    elif bad == "small":
        out = torch.zeros(15)
    else:
        u = u.transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        hk.halo_pack(u, out, starts, sizes)
    with pytest.raises((TypeError, ValueError)):
        hk.halo_unpack(u, out, starts, sizes)


def test_cpu_wrappers_do_not_count_launches():
    before = dict(hk.LAUNCHES), dict(rdma.LAUNCHES)
    u = torch.zeros((2, 6, 8, 128))
    hk.halo_pack(u, torch.zeros(16), [0, 1, 1, 1], [2, 2, 2, 2])
    hk.halo_unpack(u, torch.zeros(16), [0, 1, 1, 1], [2, 2, 2, 2])
    rdma.device_copy(torch.zeros(8), torch.zeros(8))
    assert (dict(hk.LAUNCHES), dict(rdma.LAUNCHES)) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("size", list(SIZES))
def test_cuda_kernels_match_plain(cuda_device, size):
    """Every kernel slot on the card, bit-exact against its plain version."""
    kw = SIZES[size]
    args = HaloArgs(**kw)
    u0 = torch.from_numpy(_grid(kw, seed=15)).to(cuda_device)
    for d in DIRECTIONS:
        starts, sizes = _face_slices(args, d, "pack")
        ustarts, _ = _face_slices(args, d, "unpack")
        n = int(np.prod(sizes))
        for rpb in sorted({1, hk._rows_per_block(u0, starts, sizes)}):
            got = torch.zeros(n, device=cuda_device)
            want = torch.zeros(n, device=cuda_device)
            hk.halo_pack(u0, got, starts, sizes, rpb)
            hk.halo_pack_plain(u0, want, starts, sizes)
            assert torch.equal(got, want)
            ug, uw = u0.clone(), u0.clone()
            hk.halo_unpack(ug, got, ustarts, sizes, rpb)
            hk.halo_unpack_plain(uw, got, ustarts, sizes)
            assert torch.equal(ug, uw)
        dst = torch.zeros(n, device=cuda_device)
        rdma.device_copy(got, dst)
        assert torch.equal(dst, got)
    torch.cuda.synchronize()


# the card tests' grids: HaloArgs and whether U is padded as the pipeline
# pads it (an unpadded grid's x and y faces with rows that are not a multiple
# of 4 floats take no TMA).  r1-nq2's x and y unpacks end in a ragged box
# along z, y and x
CARD_SHAPES = {
    "flagship": (dict(nq=3, lx=512, ly=512, lz=512, radius=3), True),
    "r1-nq2": (dict(nq=2, lx=41, ly=37, lz=300, radius=1), True),
    "r2-lz30": (dict(nq=1, lx=24, ly=20, lz=30, radius=2), True),
    "unpadded-nq2": (dict(nq=2, lx=30, ly=28, lz=26, radius=2), False),
    "unpadded-z4": (dict(nq=2, lx=20, ly=12, lz=36, radius=2), False),
}
CANARY = -12345.5


def _card_grid(name, device, fill=None):
    kw, padded = CARD_SHAPES[name]
    args = HaloArgs(**kw)
    shape = (_padded_shape(args.local_shape()) if padded
             else args.local_shape())
    gen = torch.Generator(device=device)
    gen.manual_seed(21)
    if fill is not None:
        return args, torch.full(shape, fill, device=device)
    return args, torch.rand(shape, device=device, generator=gen)


def _slots(u, args, d, starts, sizes):
    """(slot, rows_per_block, face buffer) of every kernel slot of this face."""
    n = int(np.prod(sizes))
    rpb = hk._rows_per_block(u, starts, sizes)
    out = [(".pallas", 1, torch.zeros(tuple(sizes), device=u.device)),
           (".pallasb", rpb, torch.zeros(tuple(sizes), device=u.device))]
    if hk._flat_ok(args, d):
        out.append((".pallasf", rpb,
                    torch.zeros((-(-n // 128), 128), device=u.device)))
    return out


def _bodies(kind, face, sizes):
    """The wrappers' own pick ("auto") and, for an unpack, each body the
    library takes for this call: SIMT always, TMA where the face allows it
    (a pack has one body)."""
    if kind == "pack":
        return ["auto"]
    return ["auto", "simt"] + (["tma"] if hk.tma_fits(
        sizes, face.data_ptr()) else [])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_cuda_bodies_match_plain(cuda_device, shape):
    """Both bodies (and the wrappers' own pick) on every face and slot,
    bit-exact against the plain versions; the wrappers count each launch
    under the body the library's plan names."""
    args, u = _card_grid(shape, cuda_device)
    for d in DIRECTIONS:
        starts, sizes = _face_slices(args, d, "pack")
        ustarts, _ = _face_slices(args, d, "unpack")
        n = int(np.prod(sizes))
        for slot, rpb, face in _slots(u, args, d, starts, sizes):
            want = torch.zeros_like(face)
            hk.halo_pack_plain(u, want, starts, sizes)
            uw = u.clone()
            hk.halo_unpack_plain(uw, want, ustarts, sizes)
            for body in _bodies("pack", face, sizes):
                tag = f"pack {dir_name(d)}{slot} {body}"
                face.zero_()
                if body == "auto":
                    before = hk.LAUNCHES["halo_pack.simt"]
                    hk.halo_pack(u, face, starts, sizes, rpb)
                    assert hk.LAUNCHES["halo_pack.simt"] == before + 1, tag
                else:
                    hk.launch_body("pack", u, face, starts, sizes, rpb, body)
                assert torch.equal(face.view(-1)[:n], want.view(-1)[:n]), tag
            for body in _bodies("unpack", want, sizes):
                tag = f"unpack {dir_name(d)}{slot} {body}"
                ug = u.clone()
                if body == "auto":
                    key = "halo_unpack." + hk.library_plan(
                        ug, want, ustarts, sizes, False)["body"]
                    before = hk.LAUNCHES[key]
                    hk.halo_unpack(ug, want, ustarts, sizes, rpb)
                    assert hk.LAUNCHES[key] == before + 1, tag
                else:
                    hk.launch_body("unpack", ug, want, ustarts, sizes, rpb,
                                   body)
                assert torch.equal(ug, uw), tag
                del ug
            del uw
    torch.cuda.synchronize()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_cuda_library_plan_matches_mirror(cuda_device, shape):
    """The library's plan (tz_halo_plan) is :func:`halo_launch_plan` on every
    cut and body; the flagship's x and y unpacks take TMA, every other cut
    SIMT; a TMA body named where the library has none is refused."""
    args, u = _card_grid(shape, cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for d, which in itertools.product(DIRECTIONS, ("pack", "unpack")):
        starts, _ = _face_slices(args, d, which)
        _, sizes = _face_slices(args, d, "pack")
        pack = which == "pack"
        face = torch.zeros(int(np.prod(sizes)) + 128, device=cuda_device)
        for body in ("auto", "simt", "tma"):
            try:
                want = hk.halo_launch_plan(u.shape, starts, sizes, pack,
                                           face.data_ptr(), body, sms)
            except ValueError:
                with pytest.raises(RuntimeError):
                    hk.library_plan(u, face, starts, sizes, pack, body)
                with pytest.raises(ValueError if pack else RuntimeError):
                    hk.launch_body(which, u, face, starts, sizes, 1, body)
                continue
            got = hk.library_plan(u, face, starts, sizes, pack, body)
            assert got == {k: want[k] for k in hk.PLAN_FIELDS}, (d, body)
        if shape == "flagship":
            body = hk.library_plan(u, face, starts, sizes, pack)["body"]
            assert body == ("simt" if pack or d[2] else "tma"), (d, which)
        # a face buffer off a 16-byte boundary takes the SIMT body
        plan = hk.library_plan(u, face[1:], starts, sizes, pack)
        assert plan["body"] == "simt"
        with pytest.raises(ValueError if pack else RuntimeError):
            hk.launch_body(which, u, face[1:], starts, sizes, 1, "tma")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_cuda_unpack_writes_only_its_cut(cuda_device, shape):
    """U filled with a canary: after every unpack (each face, slot and body;
    r1-nq2's boxes end ragged along z, y and x) the cut holds the face and
    every other cell the canary."""
    args, u = _card_grid(shape, cuda_device, fill=CANARY)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(22)
    for d in DIRECTIONS:
        ustarts, _ = _face_slices(args, d, "unpack")
        pstarts, sizes = _face_slices(args, d, "pack")
        for slot, rpb, face in _slots(u, args, d, pstarts, sizes):
            face.copy_(torch.rand(face.shape, device=cuda_device,
                                  generator=gen))
            n = int(np.prod(sizes))
            want = face.view(-1)[:n].view(tuple(sizes))
            for body in _bodies("unpack", face, sizes):
                hk.launch_body("unpack", u, face, ustarts, sizes, rpb, body)
                cut = face_view(u, ustarts, sizes)
                assert torch.equal(cut, want), (d, slot, body)
                cut.fill_(CANARY)
                assert bool((u == CANARY).all()), (d, slot, body)
    torch.cuda.synchronize()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", ["flagship", "unpadded-nq2"])
def test_cuda_unpacks_on_two_streams(cuda_device, shape):
    """The six faces' unpacks alternating over two streams at once equal the
    same unpacks in turn on one stream."""
    args, u0 = _card_grid(shape, cuda_device)
    faces = []
    for d in DIRECTIONS:
        ustarts, _ = _face_slices(args, d, "unpack")
        pstarts, sizes = _face_slices(args, d, "pack")
        face = torch.empty(int(np.prod(sizes)), device=cuda_device)
        hk.halo_pack(u0, face, pstarts, sizes)
        faces.append((ustarts, sizes, face))
    want = u0.clone()
    for ustarts, sizes, face in faces:
        hk.halo_unpack_plain(want, face, ustarts, sizes)
    got = u0.clone()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    for i, (ustarts, sizes, face) in enumerate(faces):
        with torch.cuda.stream(streams[i % 2]):
            hk.halo_unpack(got, face, ustarts, sizes)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
