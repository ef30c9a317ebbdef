"""The port's MoE pipeline and stream executor against the JAX package.

The same schedule JSONs run through the reference ``TraceExecutor`` and the
port's ``StreamExecutor(device="cpu")`` at two small sizes; the final ``Y``
must agree:

* f32 staging: rtol = atol = 1e-5 (both sum the expert MLP in float32, in
  different orders);
* bf16 staging: within one bf16 ulp (rtol 2^-7): the dispatched tokens round
  identically, but an f32 summation difference in the MLP can flip the
  rounding of an expert output to bfloat16.

Covered: the port's naive order, the reference's four greedy incumbents, and
completions of the choice graph that between them pick every menu entry
(all four stagings and both MLP slots for f32 and bf16 chains).  Also: the
routing tables and buffers are the reference's, the naive order against the
float64 expected output, the gate's transport-scratch skip beside the
reference gate's flags, and the verifier's choice projection of ``-rdma``
chains (ROADMAP Queue 3)."""

import jax
import numpy as np
import pytest
import torch

from tenzing_tpu.bench.driver import _mismatched_outputs as ref_mismatched
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu.models import moe_pipeline as ref_pipe
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu.verify import ScheduleVerifier as RefVerifier
from tenzing_tpu_torch.bench.driver import mismatched_outputs
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.models import moe_pipeline as pipe
from tenzing_tpu_torch.runtime.executor import (
    StreamExecutor,
    ZerosSpec,
    buffers_from_numpy,
)
from tenzing_tpu_torch.solve.local import drive, phase_policy
from tenzing_tpu_torch.verify import ScheduleVerifier

SMALL = dict(n_experts=4, tokens=32, d_model=8, d_ff=16, n_chunks=2)
MID = dict(n_experts=4, tokens=256, d_model=64, d_ff=128, n_chunks=2)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
STAGINGS = ("f32-host", "f32-rdma", "bf16-host", "bf16-rdma")


def _cap(kw):
    return pipe.make_pipe_buffers(pipe.MoEPipeArgs(**kw), seed=0,
                                  with_expected=False)[2]


def _port_graph(kw, staging, engine="host", menus=False):
    return pipe.build_graph(pipe.MoEPipeArgs(**kw), _cap(kw),
                            impl_choice=menus, staging=staging, engine=engine)


def _ref_graph(kw, staging, engine="host", menus=False):
    a = ref_pipe.MoEPipeArgs(**kw)
    cap = ref_pipe.make_pipe_buffers(a, seed=0, with_expected=False)[2]
    return ref_pipe.build_graph(a, cap, impl_choice=menus, staging=staging,
                                engine=engine)


def _completion(kw, k):
    """A complete schedule of the choice graph on 2 lanes: chunk c's chain
    takes staging STAGINGS[(k + c) % 4] and its MLP ``.xla`` when
    (k + c) is even, else ``.pallas`` — k = 0..3 pick every menu entry."""
    g = _port_graph(kw, "choice", menus=True)
    plat = Platform.make_n_lanes(2)

    def prefer(op_name, choices):
        c = int(op_name.split(".")[0].rsplit("_", 1)[1])
        want = ("." + STAGINGS[(k + c) % 4] if op_name.startswith("chain_")
                else (".xla", ".pallas")[(k + c) % 2])
        return next(x for x in choices if x.endswith(want))

    return sequence_to_json(drive(g, plat, phase_policy(plat, pipe.PHASES,
                                                        prefer))[0])


def _schedules():
    """(label, size kwargs, JSON, staging, engine, menus, bf16)."""
    out = []
    for size, kw in (("small", SMALL), ("mid", MID)):
        a = ref_pipe.MoEPipeArgs(**kw)
        cap = _cap(kw)
        out.append((f"{size}-naive", kw, sequence_to_json(pipe.naive_order(
            pipe.MoEPipeArgs(**kw), cap, Platform.make_n_lanes(1))),
            "f32", "host", False, False))
        greedy = ((("f32", "host"), ("bf16", "host"), ("bf16", "rdma"),
                   ("f32", "rdma")) if size == "small" else (("bf16", "rdma"),))
        for st, en in greedy:
            out.append((f"{size}-greedy-{st}-{en}", kw, ref_to_json(
                ref_pipe.greedy_overlap_order(a, cap, RefPlatform.make_n_lanes(2),
                                              staging=st, engine=en)),
                st, en, False, st == "bf16"))
        for k in (range(4) if size == "small" else (3,)):
            out.append((f"{size}-menu{k}", kw, _completion(kw, k), "choice",
                        "host", True, True))
    return out


SCHEDULES = _schedules()
IDS = [s[0] for s in SCHEDULES]


def _port_run(kw, js, staging, engine, menus, buf_staging=None):
    """Deserialize ``js`` against the port's graph of (staging, engine,
    menus) and run it on the CPU over buffers of ``buf_staging`` (default:
    the graph's staging); returns (outputs as float32 numpy, expected Y,
    executor)."""
    args = pipe.MoEPipeArgs(**kw)
    g = _port_graph(kw, staging, engine, menus)
    buf_staging = buf_staging or staging
    bufs, want, _ = pipe.make_pipe_buffers(args, seed=0, staging=buf_staging)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(
        bufs, "cpu", pipe.host_buffer_names(args, buf_staging)), device="cpu")
    out = ex.run(sequence_from_json(js, g))
    return {k: v.float().numpy() for k, v in out.items()}, want, ex


def _ref_run(kw, js, staging, engine, menus, buf_staging=None):
    a = ref_pipe.MoEPipeArgs(**kw)
    g = _ref_graph(kw, staging, engine, menus)
    buf_staging = buf_staging or staging
    bufs, _, _ = ref_pipe.make_pipe_buffers(a, seed=0, with_expected=False,
                                            staging=buf_staging)
    ex = TraceExecutor(RefPlatform.make_n_lanes(2), TraceExecutor.place_host_buffers(
        bufs, ref_pipe.host_buffer_names(a, buf_staging)))
    out = ex.run(ref_from_json(js, g))
    return {k: np.asarray(jax.device_get(v), np.float32) for k, v in out.items()}


@pytest.mark.needs_pinned_host
@pytest.mark.parametrize("label,kw,js,staging,engine,menus,bf16", SCHEDULES,
                         ids=IDS)
def test_port_executor_equals_reference_executor(label, kw, js, staging,
                                                 engine, menus, bf16):
    got, _, _ = _port_run(kw, js, staging, engine, menus)
    want = _ref_run(kw, js, staging, engine, menus)
    tol = BF16_ULP_TOL if bf16 else F32_TOL
    for name in ["Y"] + [f"Y_{c}" for c in range(kw["n_chunks"])]:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


def test_menu_completions_cover_every_menu_entry():
    g = _port_graph(SMALL, "choice", menus=True)
    menu = set()

    def walk(op):
        for c in getattr(op, "choices", lambda: [])():
            menu.add(c.name())
            if hasattr(c, "graph"):
                for v in c.graph().vertices():
                    walk(v)

    for v in g.vertices():
        walk(v)
    picked = set()
    for k in range(4):
        ran = {j.get("name", "") for j in _completion(SMALL, k)}
        picked |= ran
        for c in range(2):  # the chain a completion expanded, by its ops
            for s in STAGINGS:
                sfx = "16" if s.startswith("bf16") else ""
                rdma = f"xferd{sfx}_{c}.rdma" in ran
                if f"pack{sfx}_{c}" in ran and rdma == s.endswith("rdma"):
                    picked.add(f"chain_{c}.{s}")
    assert len(menu) == 2 * (4 + 4)
    assert menu <= picked, sorted(menu - picked)


@pytest.mark.parametrize("label,kw,js,staging,engine,menus,bf16",
                         [s for s in SCHEDULES if s[0].endswith("naive")],
                         ids=[i for i in IDS if i.endswith("naive")])
def test_naive_matches_dense_expected(label, kw, js, staging, engine, menus,
                                      bf16):
    got, want, _ = _port_run(kw, js, staging, engine, menus)
    np.testing.assert_allclose(got["Y"], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [SMALL, MID], ids=["small", "mid"])
@pytest.mark.parametrize("staging", ["f32", "bf16", "choice"])
def test_buffers_and_routing_equal_reference(kw, staging):
    mine, want_m, cap_m = pipe.make_pipe_buffers(pipe.MoEPipeArgs(**kw), seed=4,
                                                 staging=staging)
    ref, want_r, cap_r = ref_pipe.make_pipe_buffers(ref_pipe.MoEPipeArgs(**kw),
                                                    seed=4, staging=staging)
    assert cap_m == cap_r and mine.keys() == ref.keys()
    for k, r in ref.items():
        m = mine[k]
        if isinstance(m, ZerosSpec):  # bfloat16: compared as float32 values
            assert str(r.dtype) == "bfloat16" and m.dtype == "bfloat16"
            assert tuple(m.shape) == r.shape
            np.testing.assert_array_equal(m.zeros().float().numpy(),
                                          r.astype(np.float32))
        else:
            assert m.dtype == r.dtype, k
            np.testing.assert_array_equal(m, r, err_msg=k)
    np.testing.assert_array_equal(want_m, want_r)
    assert pipe.host_buffer_names(pipe.MoEPipeArgs(**kw), staging) == \
        ref_pipe.host_buffer_names(ref_pipe.MoEPipeArgs(**kw), staging)


def test_route_tokens_equal_reference():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    wg = rng.standard_normal((16, 4)).astype(np.float32)
    a = dict(n_experts=4, tokens=64, d_model=16, d_ff=8, n_chunks=4)
    cap_m, tab_m = pipe.route_tokens(x, wg, pipe.MoEPipeArgs(**a))
    cap_r, tab_r = ref_pipe.route_tokens(x, wg, ref_pipe.MoEPipeArgs(**a))
    assert cap_m == cap_r and tab_m.keys() == tab_r.keys()
    for k in tab_r:
        np.testing.assert_array_equal(tab_m[k], tab_r[k])


def test_reference_choice_schedules_deserialize_in_the_port():
    """The reference's own completion of its choice graph (first decision at
    every step) round-trips through the port's serdes unchanged."""
    from tenzing_tpu.core.state import State as RefState

    g = _ref_graph(SMALL, "choice", menus=True)
    st = RefState(g)
    plat = RefPlatform.make_n_lanes(2)
    while not st.is_terminal():
        st = st.apply(st.get_decisions(plat)[0])
    js = ref_to_json(st.sequence)
    seq = sequence_from_json(js, _port_graph(SMALL, "choice", menus=True))
    assert sequence_to_json(seq) == js


@pytest.mark.needs_pinned_host
def test_gate_skips_transport_scratch_the_reference_gate_flags():
    """Naive (f32, host) against a bf16-rdma and an f32-rdma completion:
    the reference's gate flags the unused staging set's transport and host
    buffers; the port's skips them and holds only Y (ROADMAP Queue 3)."""
    kw = SMALL
    args = pipe.MoEPipeArgs(**kw)
    naive_js = SCHEDULES[0][2]
    skip = set(pipe.host_buffer_names(args, "choice")) | set(
        pipe.transport_buffer_names(args, "choice"))
    out_n, _, _ = _port_run(kw, naive_js, "f32", "host", False, "choice")
    ref_n = _ref_run(kw, naive_js, "f32", "host", False, "choice")
    plat = Platform.make_n_lanes(2)
    g = _port_graph(kw, "choice", menus=True)
    for staging in ("bf16-rdma", "f32-rdma"):
        def prefer(op, choices, s=staging):
            want = "." + s if op.startswith("chain_") else ".xla"
            return next(c for c in choices if c.endswith(want))

        js = sequence_to_json(drive(g, plat, phase_policy(
            plat, pipe.PHASES, prefer))[0])
        out_w, _, _ = _port_run(kw, js, "choice", "host", True)
        ref_w = _ref_run(kw, js, "choice", "host", True)
        port_flags = mismatched_outputs(
            {k: torch.from_numpy(v) for k, v in out_n.items()},
            {k: torch.from_numpy(v) for k, v in out_w.items()}, 0.02, skip=skip)
        ref_flags = ref_mismatched(ref_n, ref_w, 0.02)
        outputs = {"Y"} | {f"Y_{c}" for c in range(args.n_chunks)}
        assert set(port_flags) <= outputs
        assert set(ref_flags) - outputs, ref_flags  # transport/host flagged
        assert set(ref_flags) - outputs <= skip
        if staging == "f32-rdma":
            assert port_flags == []
            assert set(ref_flags) <= set(pipe.host_buffer_names(args, "choice"))


def test_port_verifier_accepts_rdma_chains_the_reference_rejects():
    """The reference resolves a staging choice by the first alternative
    sharing an executed name, so every -rdma chain projects onto its -host
    sibling (``missing_op: spilld16_0``); the port's projection takes the
    alternative whose ops all ran."""
    kw = SMALL
    cap = _cap(kw)
    ref_v = RefVerifier(_ref_graph(kw, "choice", menus=True))
    port_v = ScheduleVerifier(_port_graph(kw, "choice", menus=True))
    for st, en in (("f32", "host"), ("bf16", "host"), ("bf16", "rdma"),
                   ("f32", "rdma")):
        mine = pipe.greedy_overlap_order(pipe.MoEPipeArgs(**kw), cap,
                                         Platform.make_n_lanes(2), st, en)
        ref = ref_pipe.greedy_overlap_order(ref_pipe.MoEPipeArgs(**kw), cap,
                                            RefPlatform.make_n_lanes(2), st, en)
        assert sequence_to_json(mine) == ref_to_json(ref)
        assert port_v(mine).ok, (st, en)
        assert ref_v(ref).ok == (en == "host"), (st, en)


def test_timed_runs_write_in_place():
    """prepare_n updates the executor's own buffers: every data_ptr is
    unchanged and Y is right."""
    kw = SMALL
    js = _completion(kw, 3)
    _, want, ex = _port_run(kw, js, "choice", "host", True)
    ptrs = {k: v.data_ptr() for k, v in ex.init_bufs.items()}
    g = _port_graph(kw, "choice", menus=True)
    ex.prepare_n(sequence_from_json(js, g))(3)
    assert {k: v.data_ptr() for k, v in ex.init_bufs.items()} == ptrs
    np.testing.assert_allclose(ex.init_bufs["Y"].numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_plain_kernel_mode_matches_kernel_mode_on_cpu():
    kw = MID
    js = _completion(kw, 1)
    args = pipe.MoEPipeArgs(**kw)
    g = _port_graph(kw, "choice", menus=True)
    bufs, _, _ = pipe.make_pipe_buffers(args, seed=0, staging="choice")
    outs = []
    for plain in (False, True):
        ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(
            bufs, "cpu", pipe.host_buffer_names(args, "choice")), device="cpu",
            plain_kernels=plain)
        outs.append(ex.run(sequence_from_json(js, g))["Y"].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_ops_allocate_only_declared_scratch():
    """Each chunk's ops declare per-chunk scratch (chunks run on different
    lanes at once); the kernel slot's hidden activations go to the same
    per-chunk buffer as the ``.xla`` slot's (the split-TF32 kernel's h
    workspace between its two launches)."""
    args = pipe.MoEPipeArgs(**SMALL)
    cap = _cap(SMALL)
    xla = pipe.ExpertFFNPipe("ffn16_1.xla", 1, args, cap, "bf16").scratch()
    pal = pipe.ExpertFFNPipePallas("ffn16_1.pallas", 1, args, cap, "bf16").scratch()
    assert set(xla) == {"moe_h_1", "moe_x_1", "moe_y_1"}
    assert pal == xla
    assert pipe.ExpertFFNPipePallas("ffn_0.pallas", 0, args, cap).scratch() \
        == {"moe_h_0": ((args.n_experts, cap, args.d_ff), "float32")}
    assert set(pipe.DispatchPackPipe("pack16_0", 0, args, cap, "bf16").scratch()) \
        == {"moe_slots_0"}
    assert pipe.DispatchPackPipe("pack_0", 0, args, cap).scratch() == {}
