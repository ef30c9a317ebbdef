"""The port's halo pipeline and stream executor against the JAX package.

The same schedule JSONs run through the reference ``TraceExecutor`` and the
port's ``StreamExecutor(device="cpu")``; the final ``U`` must equal both the
other package's and ``make_pipeline_buffers``'s expected grid exactly
(tolerance 0: the pipeline only moves data).  Covered: the naive order, the
greedy host/rdma/mixed and paired incumbents, and seeded completions over the
kernel x engine choice graph that between them pick every menu entry."""

import random

import jax
import numpy as np
import pytest
import torch

from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.models import halo as ref_halo
from tenzing_tpu.models import halo_pipeline as ref_pipe
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.core.state import ChooseOp, State
from tenzing_tpu_torch.models import halo_pipeline as pipe
from tenzing_tpu_torch.models.halo import HaloArgs
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy

SMOKE = dict(nq=2, lx=4, ly=4, lz=4, radius=1)
FLAT = dict(nq=1, lx=8, ly=64, lz=128, radius=2)


def _port_run(kw, js, menus, engine="host", n_lanes=3):
    """Deserialize ``js`` against the port's graph and run it on the CPU;
    returns (final U, executor)."""
    args = HaloArgs(**kw)
    g = pipe.build_graph(args, impl_choice=menus, xfer_choice=menus,
                         engine=engine)
    order = sequence_from_json(js, g)
    bufs, _ = pipe.make_pipeline_buffers(args, seed=0, with_expected=False)
    ex = StreamExecutor(Platform.make_n_lanes(n_lanes),
                        buffers_from_numpy(bufs, "cpu", pipe.host_buffer_names()),
                        device="cpu")
    return ex.run(order)["U"].numpy(), ex


def _ref_run(kw, js, menus, engine="host", n_lanes=3):
    args = ref_halo.HaloArgs(**kw)
    g = ref_pipe.build_graph(args, impl_choice=menus, xfer_choice=menus,
                             engine=engine)
    bufs, _ = ref_pipe.make_pipeline_buffers(args, seed=0, with_expected=False)
    jbufs = TraceExecutor.place_host_buffers(bufs, ref_pipe.host_buffer_names())
    ex = TraceExecutor(RefPlatform.make_n_lanes(n_lanes), jbufs)
    return np.asarray(jax.device_get(ex.run(ref_from_json(js, g))["U"]))


def _expected(kw):
    _, want = pipe.make_pipeline_buffers(HaloArgs(**kw), seed=0)
    return want


def _menu_completion(kw, k, seed):
    """A complete schedule over the choice graph: a ChoiceOp's pick is
    alternative (k + offset) % len with a fixed per-op offset, so k = 0..3
    (four consecutive residues, menus hold at most four entries) cover every
    menu entry; every other decision is seeded-random."""
    args = HaloArgs(**kw)
    g = pipe.build_graph(args, impl_choice=True, xfer_choice=True)
    plat = Platform.make_n_lanes(3)
    rng = random.Random(seed)
    st = State(g)
    while not st.is_terminal():
        ds = st.get_decisions(plat)
        chooses = [d for d in ds if isinstance(d, ChooseOp)]
        if chooses:
            name = chooses[0].op.name()
            grp = [d for d in chooses if d.op.name() == name]
            st = st.apply(grp[(k + sum(map(ord, name))) % len(grp)])
        else:
            st = st.apply(rng.choice(ds))
    return sequence_to_json(st.sequence)


def _schedules():
    """(label, size kwargs, JSON, menus, engine) — incumbents written by the
    reference, the port's naive order, and menu completions."""
    out = []
    for size, kw in (("smoke", SMOKE), ("flat", FLAT)):
        rargs = ref_halo.HaloArgs(**kw)
        from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json

        out.append((f"{size}-naive", kw, sequence_to_json(
            pipe.naive_order(HaloArgs(**kw), Platform.make_n_lanes(1))),
            False, "host"))
        for engine, lanes in (("host", 2), ("rdma", 3), ("mixed", 3)):
            out.append((f"{size}-greedy-{engine}", kw, ref_to_json(
                ref_pipe.greedy_overlap_order(
                    rargs, RefPlatform.make_n_lanes(lanes), engine=engine)),
                False, engine))
        out.append((f"{size}-paired", kw, ref_to_json(
            ref_pipe.paired_overlap_order(rargs, RefPlatform.make_n_lanes(2))),
            False, "mixed"))
        for k in range(4):
            out.append((f"{size}-menu{k}", kw, _menu_completion(kw, k, seed=k),
                        True, "host"))
    return out


SCHEDULES = _schedules()
IDS = [s[0] for s in SCHEDULES]


@pytest.mark.parametrize("label,kw,js,menus,engine", SCHEDULES, ids=IDS)
def test_port_executor_reproduces_expected_grid(label, kw, js, menus, engine):
    got, _ = _port_run(kw, js, menus, engine)
    np.testing.assert_array_equal(got, _expected(kw))


@pytest.mark.needs_pinned_host
@pytest.mark.parametrize("label,kw,js,menus,engine", SCHEDULES, ids=IDS)
def test_port_executor_equals_reference_executor(label, kw, js, menus, engine):
    got, _ = _port_run(kw, js, menus, engine)
    want = _ref_run(kw, js, menus, engine)
    np.testing.assert_array_equal(got, want)


def test_menu_completions_cover_every_menu_entry():
    for kw in (SMOKE, FLAT):
        args = HaloArgs(**kw)
        g = pipe.build_graph(args, impl_choice=True, xfer_choice=True)
        menu = set()
        for v in g.vertices():
            if hasattr(v, "choices"):
                menu.update(c.name() for c in v.choices())
        seen = set()
        for k in range(4):
            for op in _menu_completion(kw, k, seed=k):
                name = op.get("name", "")
                seen.add(name)
                if name.startswith(("spill_", "fetch_")):
                    seen.add(f"xfer_{name.split('_', 1)[1]}.host")
        assert menu <= seen, sorted(menu - seen)


def test_pipeline_buffers_bit_identical_to_reference():
    for kw in (SMOKE, FLAT, dict(nq=3, lx=16, ly=8, lz=32, radius=3)):
        mine, want_m = pipe.make_pipeline_buffers(HaloArgs(**kw), seed=5)
        ref, want_r = ref_pipe.make_pipeline_buffers(ref_halo.HaloArgs(**kw), seed=5)
        assert mine.keys() == ref.keys()
        for k in ref:
            assert mine[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(mine[k], ref[k])
        np.testing.assert_array_equal(want_m, want_r)


def test_timed_runs_write_in_place():
    """prepare_n runs update the executor's own buffers: no buffer is
    re-allocated (every data_ptr is unchanged), and the grid is right."""
    kw = FLAT
    js = _menu_completion(kw, 1, seed=1)
    _, ex = _port_run(kw, js, True)
    ptrs = {k: v.data_ptr() for k, v in ex.init_bufs.items()}
    g = pipe.build_graph(HaloArgs(**kw), impl_choice=True, xfer_choice=True)
    ex.prepare_n(sequence_from_json(js, g))(3)
    assert {k: v.data_ptr() for k, v in ex.init_bufs.items()} == ptrs
    np.testing.assert_array_equal(ex.init_bufs["U"].numpy(), _expected(kw))


def test_await_without_post_and_unawaited_post_raise():
    from tenzing_tpu_torch.core.operation import Finish, Start
    from tenzing_tpu_torch.core.sequence import Sequence
    from tenzing_tpu_torch.ops.comm_ops import AwaitTransfer
    from tenzing_tpu_torch.ops.rdma import RdmaCopyStart

    kw = SMOKE
    bufs, _ = pipe.make_pipeline_buffers(HaloArgs(**kw), seed=0)
    ex = StreamExecutor(Platform.make_n_lanes(1),
                        buffers_from_numpy(bufs, "cpu", pipe.host_buffer_names()),
                        device="cpu")
    with pytest.raises(RuntimeError, match="no transfer in flight"):
        ex.run(Sequence([Start(), AwaitTransfer("await_px", "recv_px"), Finish()]))
    with pytest.raises(ValueError, match="un-awaited"):
        ex.run(Sequence([Start(), RdmaCopyStart("xfer_px.rdma", "buf_px",
                                                "recv_px"), Finish()]))


def test_executor_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bufs, _ = pipe.make_pipeline_buffers(HaloArgs(**SMOKE), seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamExecutor(Platform.make_n_lanes(1),
                       buffers_from_numpy(bufs, "cpu", pipe.host_buffer_names()))


def test_plain_kernel_mode_matches_kernel_mode_on_cpu():
    """The plain-version executor (chip_smoke's on-card reference) computes
    the same grid as the default mode."""
    kw = FLAT
    js = _menu_completion(kw, 2, seed=2)
    args = HaloArgs(**kw)
    g = pipe.build_graph(args, impl_choice=True, xfer_choice=True)
    bufs, want = pipe.make_pipeline_buffers(args, seed=0)
    ex = StreamExecutor(Platform.make_n_lanes(3),
                        buffers_from_numpy(bufs, "cpu", pipe.host_buffer_names()),
                        device="cpu", plain_kernels=True)
    np.testing.assert_array_equal(ex.run(sequence_from_json(js, g))["U"].numpy(),
                                  want)
