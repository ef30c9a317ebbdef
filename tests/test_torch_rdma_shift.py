"""The mesh shift and the collective posts of the port (``ops/rdma.py``
``RdmaShiftStart`` and the ``rdma_shift_post`` / ``rdma_shift_wait``
kernels; ``ops/comm_ops.py`` ``PermuteStart`` and ``PsumStart``) against
the JAX package (``tenzing_tpu/ops/rdma.py``, ``tenzing_tpu/ops/comm_ops.py``).

* Over gloo on 8 CPU ranks (parallel/launch.py), one post and its await run
  through the port's stream executor on each rank's block of a seeded
  global array; the gathered result must equal ``np.roll`` (``torch.roll``
  of the blocks: ``ops.rdma.shift_roll``) and the reference's
  ``rdma_shift_fused`` in interpret mode under ``shard_map`` on the 8-device
  CPU mesh (tests/test_rdma.py), exactly: the shift is pure data movement.
  On the CPU the shift runs its plain version (``isend`` / ``irecv`` over
  the axis group).
* ``PermuteStart`` against ``lax.ppermute`` and ``PsumStart`` against
  ``lax.psum`` the same way (the sum of float32 blocks at tolerance 0: both
  add the same 2-8 integers' worth of values, exactly representable).
* On an axis of size 1 the shift is the loopback copy.
* The ops' kinds and JSON are the reference's.

The card tests (``needs_cuda``) run the kernels between two ranks that share
GPU 0 through CUDA IPC: the shift against ``torch.roll`` bit for bit, and
back-to-back runs with a changed interior and a delayed unpack that would
expose a neighbour's post landing before this rank's unpack read its
receive buffer (parallel/dryrun.py ``war_check``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from tenzing_tpu.ops import comm_ops as ref_comm
from tenzing_tpu.ops import rdma as ref_rdma
from tenzing_tpu_torch.core.operation import kind_registry
from tenzing_tpu_torch.ops import comm_ops, rdma
from tenzing_tpu_torch.parallel import dryrun
from tenzing_tpu_torch.parallel.launch import launch

TIMEOUT_S = 120.0


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ints(shape, seed):
    # small integers: every partial sum is exact in float32 in any order
    return np.random.default_rng(seed).integers(-8, 8, shape).astype(
        np.float32)


# every case of one mesh shape runs in one launch (module fixture below)
CASES = {
    (8,): {
        "shift-1d": dict(x=_x((8, 16)), spec=("x",), kind="rdma", axis="x"),
        "permute-1d": dict(x=_x((8, 8), 5), spec=("x",), kind="permute",
                           axis="x"),
        "psum-1d": dict(x=_ints((8, 8), 9), spec=("x",), kind="psum",
                        axis="x"),
    },
    (2, 2, 2): {
        **{f"shift-3d-{a}": dict(x=_x((2, 2, 2, 16), seed=d),
                                 spec=("x", "y", "z"), kind="rdma", axis=a)
           for d, a in enumerate("xyz")},
        "permute-3d-y-back": dict(x=_x((2, 2, 2, 8), 5), spec=("x", "y", "z"),
                                  kind="permute", axis="y", shift=-1),
        "permute-3d-z": dict(x=_x((2, 2, 2, 8), 6), spec=("x", "y", "z"),
                             kind="permute", axis="z"),
        "psum-3d-y": dict(x=_ints((2, 2, 2, 8), 9), spec=("x", "y", "z"),
                          kind="psum", axis="y"),
    },
    (4,): {f"shift-by-{s}": dict(x=_x((4, 3, 5), seed=7), spec=("x",),
                                 kind="rdma", axis="x", shift=s)
           for s in (1, -1, 3)},
    (1,): {
        "shift-size1": dict(x=_x((2, 16), seed=3), spec=(None,), kind="rdma",
                            axis="x"),
        "permute-size1": dict(x=_x((1, 8), 5), spec=(None,), kind="permute",
                              axis="x"),
    },
}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """The port's gathered destination of every case, by case name."""
    out = {}
    for shape, cases in CASES.items():
        ys = launch("tenzing_tpu_torch.parallel.dryrun:comm_cases",
                    int(np.prod(shape)), "cpu",
                    dict(cases=list(cases.values())), timeout_s=TIMEOUT_S,
                    workdir=str(tmp_path_factory.mktemp("launch")),
                    mesh_axes=("x", "y", "z")[:len(shape)],
                    mesh_shape=shape)[0]
        out.update(zip(cases, ys))
    return out


def _case(name):
    return next(c for cases in CASES.values() for k, c in cases.items()
                if k == name)


def _ref_shard_map(fn, x, mesh_shape, spec):
    names = ("x", "y", "z")[:len(mesh_shape)]
    devs = np.array(jax.devices()[:int(np.prod(mesh_shape))])
    mesh = JaxMesh(devs.reshape(mesh_shape), names)
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(*spec),
                              out_specs=P(*spec), check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.needs_shard_map
def test_shift_fused_matches_roll_1d(port_results):
    x = _case("shift-1d")["x"]
    want = _ref_shard_map(
        lambda v: ref_rdma.rdma_shift_fused(v, ("x",), "x", 1, collective_id=1),
        x, (8,), ("x",))
    np.testing.assert_array_equal(want, np.roll(x, 1, 0))
    np.testing.assert_array_equal(port_results["shift-1d"], want)


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("axis,dim", [("x", 0), ("y", 1), ("z", 2)])
def test_shift_fused_matches_roll_3d_mesh(axis, dim, port_results):
    x = _case(f"shift-3d-{axis}")["x"]
    spec = ("x", "y", "z")
    want = _ref_shard_map(
        lambda v: ref_rdma.rdma_shift_fused(v, spec, axis, 1, collective_id=2),
        x, (2, 2, 2), spec)
    np.testing.assert_array_equal(want, np.roll(x, 1, dim))
    np.testing.assert_array_equal(port_results[f"shift-3d-{axis}"], want)


@pytest.mark.parametrize("shift", [1, -1, 3])
def test_shift_backwards_and_by_more_than_one(shift, port_results):
    x = torch.from_numpy(_case(f"shift-by-{shift}")["x"])
    np.testing.assert_array_equal(port_results[f"shift-by-{shift}"],
                                  rdma.shift_roll(x, shift).numpy())


@pytest.mark.needs_shard_map
def test_shift_axis_size_one_is_loopback_copy(port_results):
    """n = 1 degenerates to the self copy (no barrier): the loopback's
    device_copy, as the reference's rdma_shift_fused on a 1-device axis."""
    x = _case("shift-size1")["x"]
    want = _ref_shard_map(
        lambda v: ref_rdma.rdma_shift_fused(v, ("x",), "x", 1), x, (1,), ())
    np.testing.assert_array_equal(want, x)
    np.testing.assert_array_equal(port_results["shift-size1"], x)


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("name,mesh_shape",
                         [("permute-1d", (8,)), ("permute-3d-y-back", (2, 2, 2)),
                          ("permute-3d-z", (2, 2, 2)), ("permute-size1", (1,))])
def test_permute_start_matches_ppermute(name, mesh_shape, port_results):
    c = _case(name)
    spec = c["spec"] if c["spec"] != (None,) else ()
    op = ref_comm.PermuteStart("p", "s", "d", c["axis"], c.get("shift", 1))
    want = _ref_shard_map(lambda v: op.apply({"s": v}, None)["d"], c["x"],
                          mesh_shape, spec)
    np.testing.assert_array_equal(port_results[name], want)


@pytest.mark.needs_shard_map
@pytest.mark.parametrize("name,mesh_shape", [("psum-1d", (8,)),
                                             ("psum-3d-y", (2, 2, 2))])
def test_psum_start_matches_psum(name, mesh_shape, port_results):
    c = _case(name)
    names = c["spec"]
    op = ref_comm.PsumStart("p", "s", "d", c["axis"])
    want = _ref_shard_map(lambda v: op.apply({"s": v}, None)["d"], c["x"],
                          mesh_shape, names)
    # the reference's psum leaves every member of the axis with the sum;
    # the port gathers one of them along that axis
    dim = names.index(c["axis"])
    np.testing.assert_array_equal(port_results[name],
                                  np.take(want, [0], axis=dim))
    np.testing.assert_array_equal(port_results[name],
                                  c["x"].sum(axis=dim, keepdims=True))


def test_ops_json_and_kinds_are_the_references():
    reg = kind_registry()
    pairs = [
        (rdma.RdmaShiftStart("exchange_px.rdma", "buf_px", "recv_px", "x", 1,
                             0),
         ref_rdma.RdmaShiftStart("exchange_px.rdma", "buf_px", "recv_px", "x",
                                 1, 0)),
        (rdma.RdmaShiftStart("e", "s", "d", "y", -1, 3),
         ref_rdma.RdmaShiftStart("e", "s", "d", "y", -1, 3)),
        (comm_ops.PermuteStart("p", "s", "d", "z", -1),
         ref_comm.PermuteStart("p", "s", "d", "z", -1)),
        (comm_ops.PsumStart("q", "s", "d", "x"),
         ref_comm.PsumStart("q", "s", "d", "x")),
    ]
    for port, ref in pairs:
        assert port.to_json() == ref.to_json()
        assert reg[port.KIND] is type(port)
    assert {"rdma_shift_start", "permute_start", "psum_start"} <= set(reg)


def test_plain_shift_and_roll_agree_on_one_rank():
    """At size 1 the plain shift is the copy; ``shift_roll`` is the roll of
    the blocks along the axis's dim."""
    x = torch.arange(24.0).reshape(4, 6)
    y = torch.zeros_like(x)
    rdma.rdma_shift_plain(x, y, None, 1, 1)
    assert torch.equal(y, x)
    assert torch.equal(rdma.shift_roll(x, 1, 0), torch.roll(x, 1, 0))


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rdma.rdma_shift_post(x, 0, x, 0, 0, 0, 1, x)
    with pytest.raises(ValueError, match="flags on cpu"):
        rdma.rdma_shift_wait(x, 0, 1, x)


def test_handoff_names_are_checked():
    """The hand-off is the stream's or the spin kernels'; any other name is
    refused before anything is enqueued."""
    assert rdma.HANDOFF in rdma.HANDOFFS == ("stream", "spin")
    assert rdma._spin("stream") == 0 and rdma._spin("spin") == 1
    with pytest.raises(ValueError, match="hand-off"):
        rdma._spin("poll")


def test_check_memops_raises_without_stream_memory_operations(monkeypatch):
    """No 64-bit stream memory operations: the shift raises (there is no
    fall back to the spin kernels)."""
    from tenzing_tpu_torch.ops import kernel_lib

    class Lib:
        def __init__(self, rc):
            self.rc = rc

        def tz_rdma_shift_memops(self):
            return self.rc

    monkeypatch.setattr(kernel_lib, "lib", lambda: Lib(801))
    with pytest.raises(RuntimeError, match="STREAM_MEM_OPS"):
        rdma.check_memops()
    monkeypatch.setattr(kernel_lib, "lib", lambda: Lib(0))
    rdma.check_memops()


class _Stuck:
    """An event that never completes until ``released``."""

    def __init__(self):
        self.released = False

    def query(self):
        return self.released


@pytest.mark.parametrize("code,step", [(1, "barrier"), (2, "arrival")])
def test_await_shift_deadline_names_the_stuck_step(monkeypatch, code, step):
    """Past the deadline the await writes the stuck step's code into the
    error word, releases the wait and raises naming the step, instead of
    blocking for ever."""
    import time

    ev, calls = _Stuck(), []
    monkeypatch.setattr(rdma, "_stuck_code", lambda f, c, e: code)

    def release(flags, cid, epoch):
        calls.append((cid, epoch))
        ev.released = True

    monkeypatch.setattr(rdma, "_release", release)
    err = torch.zeros(1, dtype=torch.int32)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=step):
        rdma.await_shift(ev, None, 3, 7, err, deadline_s=0.05)
    assert 0.05 <= time.monotonic() - t0 < 5.0
    assert calls == [(3, 7)]
    assert rdma.shift_error(err) == rdma.SHIFT_ERRORS[code]


def test_await_shift_returns_when_the_event_completes(monkeypatch):
    ev = _Stuck()
    ev.released = True
    monkeypatch.setattr(rdma, "_release", lambda *a: pytest.fail("released"))
    err = torch.zeros(1, dtype=torch.int32)
    rdma.await_shift(ev, None, 0, 1, err, deadline_s=0.01)
    assert rdma.shift_error(err) is None


def test_shift_post_needs_an_await():
    """A shift posted without its await fails the run, as any transfer."""
    from tenzing_tpu_torch.core.platform import Mesh, MeshAxis, Platform
    from tenzing_tpu_torch.core.sequence import Sequence
    from tenzing_tpu_torch.runtime.executor import StreamExecutor

    mesh = Mesh({"x": MeshAxis(size=1, index=0)})
    ex = StreamExecutor(Platform.make_n_lanes(1, mesh=mesh),
                        {"s": torch.ones(4), "d": torch.zeros(4)},
                        device="cpu")
    with pytest.raises(ValueError, match="un-awaited"):
        ex.run(Sequence([rdma.RdmaShiftStart("post", "s", "d", "x")]))


# -- the card: two ranks on GPU 0 through CUDA IPC --------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _shared(args, **kw):
    return launch("tenzing_tpu_torch.parallel.dryrun:halo_shared_main", 2,
                  "cuda", dict(args=args, **kw), timeout_s=240.0,
                  mesh_axes=("x", "y", "z"), mesh_shape=(2, 1, 1),
                  shared_card=True)


@pytest.mark.needs_cuda
def test_cuda_two_rank_shift_matches_roll(cuda_device):
    rows = _shared(dict(nq=2, lx=16, ly=32, lz=64, radius=2), time_reps=3)
    for r in rows:
        t = r["timing"]
        assert t["exact_vs_roll"] and t["max_abs_err"] == 0.0
        assert t["plain_exact"]
        assert all(s["u_exact"] for s in r["schedules"])
        assert r["launches"]["rdma_shift_post"] > 0
        assert r["launches"]["rdma_shift_wait"] > 0


@pytest.mark.needs_cuda
def test_cuda_back_to_back_runs_with_a_changed_interior(cuda_device):
    rows = _shared(dict(nq=2, lx=16, ly=32, lz=64, radius=2), war_runs=4,
                   time_reps=3)
    for r in rows:
        assert r["war"]["acc_exact"] and r["war"]["runs"] == 4
        assert r["launches_war"]["rdma_shift_post"] == 4 * 2


@pytest.mark.needs_cuda
@pytest.mark.parametrize("stuck", ["barrier", "arrival"])
def test_cuda_missing_peer_raises_within_the_deadline(cuda_device, stuck):
    """One rank alone: its neighbours' flag blocks are words nobody writes,
    so its barrier (or, with both barrier words set beforehand, its
    arrival) never completes.  The await raises naming the step within its
    deadline, and the released stream drains: no hang."""
    import time

    from tenzing_tpu_torch.ops import kernel_lib

    slots = int(kernel_lib.lib().tz_rdma_shift_slots())
    flags = torch.zeros(rdma.MAX_COLLECTIVE_IDS * slots, dtype=torch.int64,
                        device=cuda_device)
    nobody = torch.zeros_like(flags)  # the absent neighbours' blocks
    err = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    x = torch.arange(4096.0, device=cuda_device)
    y = torch.zeros_like(x)
    cid, epoch = 3, 1
    if stuck == "arrival":
        flags[cid * slots + rdma.FROM_BWD] = epoch
        flags[cid * slots + rdma.FROM_FWD] = epoch
    torch.cuda.synchronize()
    stream = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(stream):
        rdma.rdma_shift_post(x, y.data_ptr(), flags, nobody.data_ptr(),
                             nobody.data_ptr(), cid, epoch, err)
        rdma.rdma_shift_wait(flags, cid, epoch, err)
        done = torch.cuda.Event()
        done.record(stream)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=stuck):
        rdma.await_shift(done, flags, cid, epoch, err, deadline_s=1.0)
    assert time.monotonic() - t0 < 5.0
    assert rdma.shift_error(err) == rdma.SHIFT_ERRORS[
        1 if stuck == "barrier" else 2]
    torch.cuda.synchronize()  # the released wait let the stream drain
    assert time.monotonic() - t0 < 10.0
    assert torch.equal(y, x)  # the copy ran once the barrier was released


@pytest.mark.needs_cuda
def test_cuda_device_has_stream_memory_operations(cuda_device):
    rdma.check_memops()
