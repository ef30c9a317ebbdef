"""The port's halo pack/unpack and device-copy kernels against the JAX
package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference kernels run in the Pallas interpreter (``interpret=True``) as
tests/test_halo_pipeline.py runs them.  Both are pure data movement, so the
comparison is exact (tolerance 0).  The same numpy inputs feed both.  The
menu gates must be the reference's functions on every shape, so the two
packages offer the same search space.

``test_cuda_kernels_match_plain`` needs the card (marker ``needs_cuda``):
``python -m pytest tests/test_torch_halo_kernels.py -m needs_cuda`` on the
machine with the GPU."""

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
from tenzing_tpu_torch.models.halo import DIRECTIONS, HaloArgs, _face_slices, dir_name
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
