"""The port's SDP core (tenzing_tpu_torch.core) against the JAX package's.

The same graphs are built in both packages; walking them with the same
decision indices must offer the same decisions at every step (compared by
their JSON: decision kind, op kind, op name, lane and event ids), and a
schedule JSON the reference writes must come back unchanged through the
port's serdes."""

import random

import pytest

from tenzing_tpu.core import graph as ref_graph
from tenzing_tpu.core import operation as ref_operation
from tenzing_tpu.core import serdes as ref_serdes
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.state import State as RefState
from tenzing_tpu.models import halo as ref_halo
from tenzing_tpu.models import halo_pipeline as ref_pipe
from tenzing_tpu_torch.core import graph as port_graph
from tenzing_tpu_torch.core import operation as port_operation
from tenzing_tpu_torch.core import serdes as port_serdes
from tenzing_tpu_torch.core.platform import Platform as PortPlatform
from tenzing_tpu_torch.core.state import State as PortState
from tenzing_tpu_torch.models import halo as port_halo
from tenzing_tpu_torch.models import halo_pipeline as port_pipe

SMOKE = dict(nq=2, lx=4, ly=4, lz=4, radius=1)


def _diamond(pkg_graph, pkg_operation):
    """start -> a(host) -> {b, c}(device) -> d(device) -> finish."""

    class Dev(pkg_operation.DeviceOp):
        def __init__(self, name):
            super().__init__(name)

    g = pkg_graph.Graph()
    a = pkg_operation.NoOp("a")
    b, c, d = Dev("b"), Dev("c"), Dev("d")
    g.start_then(a)
    g.then(a, b)
    g.then(a, c)
    g.then(b, d)
    g.then(c, d)
    g.then_finish(d)
    return g


def _walk_both(ref_g, port_g, n_lanes, seed):
    """Walk both graphs with the same random decision indices, asserting the
    decision lists agree at every step; returns the step count."""
    rng = random.Random(seed)
    rs, ps = RefState(ref_g), PortState(port_g)
    rplat, pplat = RefPlatform.make_n_lanes(n_lanes), PortPlatform.make_n_lanes(n_lanes)
    steps = 0
    while not rs.is_terminal():
        rds, pds = rs.get_decisions(rplat), ps.get_decisions(pplat)
        assert [d.to_json() for d in rds] == [d.to_json() for d in pds], steps
        assert [type(d).__name__ for d in rds] == [type(d).__name__ for d in pds]
        i = rng.randrange(len(rds))
        rs, ps = rs.apply(rds[i]), ps.apply(pds[i])
        steps += 1
    assert ps.is_terminal()
    assert ref_serdes.sequence_to_json(rs.sequence) == port_serdes.sequence_to_json(
        ps.sequence)
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_diamond_decisions_match_reference(seed):
    steps = _walk_both(_diamond(ref_graph, ref_operation),
                       _diamond(port_graph, port_operation), 2, seed)
    assert steps >= 8


@pytest.mark.parametrize("seed", [0, 1])
def test_halo_choice_graph_decisions_match_reference(seed):
    ref_g = ref_pipe.build_graph(ref_halo.HaloArgs(**SMOKE), impl_choice=True,
                                 xfer_choice=True)
    port_g = port_pipe.build_graph(port_halo.HaloArgs(**SMOKE), impl_choice=True,
                                   xfer_choice=True)
    assert _walk_both(ref_g, port_g, 2, seed) > 40


def _reference_schedules():
    args = ref_halo.HaloArgs(**SMOKE)
    return {
        "naive": ref_pipe.naive_order(args, RefPlatform.make_n_lanes(1)),
        "greedy-host": ref_pipe.greedy_overlap_order(
            args, RefPlatform.make_n_lanes(2), engine="host"),
        "greedy-rdma": ref_pipe.greedy_overlap_order(
            args, RefPlatform.make_n_lanes(2), engine="rdma"),
        "greedy-mixed": ref_pipe.greedy_overlap_order(
            args, RefPlatform.make_n_lanes(3), engine="mixed"),
        "paired": ref_pipe.paired_overlap_order(
            args, RefPlatform.make_n_lanes(2), engine="mixed"),
    }


@pytest.mark.parametrize("label", ["naive", "greedy-host", "greedy-rdma",
                                   "greedy-mixed", "paired"])
def test_reference_schedule_json_roundtrips_through_port(label):
    ref_seq = _reference_schedules()[label]
    js = ref_serdes.sequence_to_json(ref_seq)
    engine = {"greedy-rdma": "rdma", "greedy-mixed": "mixed",
              "paired": "mixed"}.get(label, "host")
    g = port_pipe.build_graph(port_halo.HaloArgs(**SMOKE), engine=engine)
    back = port_serdes.sequence_from_json(js, g)
    assert port_serdes.sequence_to_json(back) == js


def test_port_greedy_orders_equal_reference():
    """The port derives its incumbents with the same machinery: identical
    schedules, op for op."""
    rargs, pargs = ref_halo.HaloArgs(**SMOKE), port_halo.HaloArgs(**SMOKE)
    for engine, lanes in (("host", 2), ("rdma", 2), ("mixed", 3)):
        r = ref_pipe.greedy_overlap_order(rargs, RefPlatform.make_n_lanes(lanes),
                                          engine=engine)
        p = port_pipe.greedy_overlap_order(pargs, PortPlatform.make_n_lanes(lanes),
                                           engine=engine)
        assert ref_serdes.sequence_to_json(r) == port_serdes.sequence_to_json(p)


def test_kind_registries_are_separate():
    """Registering kinds in the port never touches the reference's serdes
    registry (and vice versa): each resolves its own classes."""
    ref_kinds = ref_operation.kind_registry()
    port_kinds = port_operation.kind_registry()
    for kind in ("start", "finish", "event_record", "await_transfer",
                 "host_spill_start", "rdma_copy_start"):
        assert ref_kinds[kind].__module__.startswith("tenzing_tpu.")
        assert port_kinds[kind].__module__.startswith("tenzing_tpu_torch.")


def test_port_naive_order_is_verified_and_fully_synchronous():
    """The port's naive order passes the independent verifier (the
    reference's hand-written one does not: its spill is unordered after its
    pack), and still awaits every transfer right after its fetch."""
    from tenzing_tpu.verify import ScheduleVerifier as RefVerifier
    from tenzing_tpu_torch.verify import ScheduleVerifier

    pargs = port_halo.HaloArgs(**SMOKE)
    order = port_pipe.naive_order(pargs, PortPlatform.make_n_lanes(1))
    assert ScheduleVerifier(port_pipe.build_graph(pargs))(order).ok
    names = [op.name() for op in order.vector()]
    for d in port_halo.DIRECTIONS:
        nd = port_halo.dir_name(d)
        assert names.index(f"await_{nd}") == names.index(f"fetch_{nd}") + 1
    rargs = ref_halo.HaloArgs(**SMOKE)
    ref_naive = ref_pipe.naive_order(rargs, RefPlatform.make_n_lanes(1))
    verdict = RefVerifier(ref_pipe.build_graph(rargs))(ref_naive)
    assert not verdict.ok and verdict.violations[0].kind == "race:raw"
    # the reference's verifier accepts the port's naive order as well
    js = port_serdes.sequence_to_json(order)
    assert RefVerifier(ref_pipe.build_graph(rargs))(
        ref_serdes.sequence_from_json(js, ref_pipe.build_graph(rargs))).ok
