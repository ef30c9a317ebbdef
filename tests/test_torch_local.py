"""The port's hill-climb (``solve/local.py``) against the JAX package's.

Both climbs run on the same smoke graphs with the same seed, budget and
policy, each against a deterministic fake benchmarker whose cost is a hash of
the schedule JSON — a text both packages write identically for the same
schedule.  The climbs must measure the same schedules in the same order,
accept the same chain and end on the same tip, paired and unpaired; and
``replay_with_substitution`` must build the same neighbors."""

import hashlib
import json

import pytest

from tenzing_tpu.bench import driver as ref_driver
from tenzing_tpu.bench.benchmarker import BenchOpts as RefBenchOpts
from tenzing_tpu.bench.benchmarker import BenchResult as RefBenchResult
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
from tenzing_tpu.core.state import State as RefState
from tenzing_tpu.models import halo as ref_halo
from tenzing_tpu.models import halo_pipeline as ref_halo_pipe
from tenzing_tpu.models import moe_pipeline as ref_moe
from tenzing_tpu.solve import local as ref_local
from tenzing_tpu.verify import ScheduleVerifier as RefVerifier
from tenzing_tpu_torch.bench import driver
from tenzing_tpu_torch.bench.benchmarker import BenchOpts, BenchResult
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_to_json
from tenzing_tpu_torch.core.state import State
from tenzing_tpu_torch.models import halo_pipeline as halo_pipe
from tenzing_tpu_torch.models import moe_pipeline as moe_pipe
from tenzing_tpu_torch.models.halo import HaloArgs
from tenzing_tpu_torch.solve import local
from tenzing_tpu_torch.verify import ScheduleVerifier

HALO = dict(nq=2, lx=4, ly=4, lz=4, radius=1)
MOE = dict(n_experts=4, tokens=32, d_model=8, d_ff=16, n_chunks=2)


def _cost(js) -> float:
    """A deterministic per-schedule time in [1, 2) ms from its JSON."""
    h = hashlib.sha256(json.dumps(js, sort_keys=True).encode()).digest()
    return 1e-3 * (1.0 + int.from_bytes(h[:4], "little") / 2.0 ** 32)


class _Fake:
    """A benchmarker answering from :func:`_cost`; ``log`` records the JSON
    of every schedule it was asked to measure, batches included."""

    def __init__(self, to_json, result_cls):
        self.to_json, self.result_cls, self.log = to_json, result_cls, []

    def benchmark(self, seq, opts=None):
        js = self.to_json(seq)
        self.log.append(js)
        return self.result_cls.from_times([_cost(js)] * 3)

    def benchmark_batch_times(self, orders, opts=None, seed=0):
        out = []
        for seq in orders:
            js = self.to_json(seq)
            self.log.append(js)
            out.append([_cost(js)] * opts.n_iters)
        return out


def _graphs(workload):
    """(port graph, reference graph, phases, port prefer, reference prefer,
    lanes): the smoke sizes with every menu on."""
    if workload == "halo":
        g = halo_pipe.build_graph(HaloArgs(**HALO), impl_choice=True,
                                  xfer_choice=True)
        rg = ref_halo_pipe.build_graph(ref_halo.HaloArgs(**HALO),
                                       impl_choice=True, xfer_choice=True)
        return (g, rg, halo_pipe.HALO_PHASES, driver.halo_alias_prefer,
                ref_driver.halo_alias_prefer, 3)
    a = moe_pipe.MoEPipeArgs(**MOE)
    cap = moe_pipe.make_pipe_buffers(a, seed=0, with_expected=False)[2]
    g = moe_pipe.build_graph(a, cap, impl_choice=True, staging="choice")
    rg = ref_moe.build_graph(ref_moe.MoEPipeArgs(**MOE), cap, impl_choice=True,
                             staging="choice")
    return g, rg, moe_pipe.PHASES, driver.moe_bf16_prefer, \
        ref_driver.moe_bf16_prefer, 2


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "unpaired"])
@pytest.mark.parametrize("workload,budget,seed", [
    ("halo", 12, 2), ("halo", 7, 3), ("moe", 10, 2), ("moe", 6, 5)])
def test_climb_equals_reference(workload, budget, seed, paired):
    g, rg, phases, prefer, ref_prefer, lanes = _graphs(workload)
    mine = _Fake(sequence_to_json, BenchResult)
    ref = _Fake(ref_to_json, RefBenchResult)
    verify = workload == "halo"  # the reference verifier rejects moe -rdma chains
    res = local.hill_climb(
        g, Platform.make_n_lanes(lanes), mine, phases, prefer=prefer,
        opts=local.LocalOpts(budget=budget, seed=seed, paired=paired,
                             bench_opts=BenchOpts(n_iters=4),
                             verify=ScheduleVerifier(g) if verify else None))
    rres = ref_local.hill_climb(
        rg, RefPlatform.make_n_lanes(lanes), ref, phases, prefer=ref_prefer,
        opts=ref_local.LocalOpts(budget=budget, seed=seed, paired=paired,
                                 bench_opts=RefBenchOpts(n_iters=4),
                                 verify=RefVerifier(rg) if verify else None))
    assert mine.log == ref.log  # the same schedules measured, in order
    assert len(res.sims) == len(rres.sims)
    assert [sequence_to_json(s.order) for s in res.sims] == \
        [ref_to_json(s.order) for s in rres.sims]
    assert sequence_to_json(res.final.order) == ref_to_json(rres.final.order)
    assert res.final.result.pct50 == rres.final.result.pct50
    assert res.spent <= budget and res.spent == len(res.sims)


def test_climbs_accept_moves():
    """The fixture is not vacuous: some climb accepts a move."""
    g, _, phases, prefer, _, lanes = _graphs("moe")
    fake = _Fake(sequence_to_json, BenchResult)
    res = local.hill_climb(g, Platform.make_n_lanes(lanes), fake, phases,
                           prefer=prefer,
                           opts=local.LocalOpts(budget=10, seed=2, paired=True,
                                                bench_opts=BenchOpts(n_iters=4)))
    assert res.accepted > 0
    assert res.final.result.pct50 < res.sims[0].result.pct50


@pytest.mark.parametrize("workload", ["halo", "moe"])
def test_replay_with_substitution_equals_reference(workload):
    g, rg, phases, prefer, ref_prefer, lanes = _graphs(workload)
    plat, rplat = Platform.make_n_lanes(lanes), RefPlatform.make_n_lanes(lanes)
    _, decs = local.drive(g, plat, local.phase_policy(plat, phases, prefer))
    _, rdecs = ref_local.drive(rg, rplat, ref_local.phase_policy(
        rplat, phases, ref_prefer))
    assert len(decs) == len(rdecs)
    checked = 0
    for i in range(0, len(decs), max(1, len(decs) // 12)):
        st, rst = State(g), RefState(rg)
        for d, rd in zip(decs[:i], rdecs[:i]):
            st, rst = st.apply(d), rst.apply(rd)
        alts = [d for d in st.get_decisions(plat) if d.key() != decs[i].key()]
        ralts = [d for d in rst.get_decisions(rplat)
                 if d.key() != rdecs[i].key()]
        assert len(alts) == len(ralts)
        for j in range(min(2, len(alts))):
            seq, _ = local.replay_with_substitution(
                g, plat, decs, i, alts[j],
                local.phase_policy(plat, phases, prefer))
            rseq, _ = ref_local.replay_with_substitution(
                rg, rplat, rdecs, i, ralts[j],
                ref_local.phase_policy(rplat, phases, ref_prefer))
            assert sequence_to_json(seq) == ref_to_json(rseq)
            checked += 1
    assert checked > 5


def test_climb_configs_split_the_budget_as_the_reference():
    """Halo: 3 and 6 lanes split 4:3; moe: one climb over the whole budget on
    the search lanes; attn and the smoke: none (reference
    bench/driver.py:1457-1495, no recorded climb)."""
    plat = Platform.make_n_lanes(2)
    halo = driver.climb_configs(driver.DriverRequest(), plat)
    assert [(len(p.lanes), b) for p, _, _, b in halo] == [(3, 25), (6, 19)]
    moe = driver.climb_configs(driver.DriverRequest(workload="moe"), plat)
    assert [(len(p.lanes), b) for p, _, _, b in moe] == [(2, 44)]
    assert moe[0][2] is driver.moe_bf16_prefer
    assert driver.climb_configs(driver.DriverRequest(workload="attn"), plat) == []
    assert driver.climb_configs(driver.DriverRequest(smoke=True), plat) == []
    assert driver.climb_configs(driver.DriverRequest(climb_budget=0), plat) == []


@pytest.mark.parametrize("op,choices", [
    ("xfer_px", ["xfer_px.host", "xfer_px.rdma"]),
    ("unpack_mz", ["unpack_mz.xla", "unpack_mz.pallas", "unpack_mz.pallasb"]),
    ("pack_py", ["pack_py.xla", "pack_py.pallas"]),
])
def test_halo_alias_prefer_equals_reference(op, choices):
    assert driver.halo_alias_prefer(op, choices) == \
        ref_driver.halo_alias_prefer(op, choices)


@pytest.mark.parametrize("op,choices", [
    ("chain_0", ["chain_0.bf16-host", "chain_0.bf16-rdma", "chain_0.f32-host"]),
    ("ffn16_1", ["ffn16_1.pallas", "ffn16_1.xla"]),
])
def test_moe_bf16_prefer_equals_reference(op, choices):
    assert driver.moe_bf16_prefer(op, choices) == \
        ref_driver.moe_bf16_prefer(op, choices)
