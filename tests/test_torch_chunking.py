"""Op chunking in the port (tenzing_tpu_torch/core/chunking.py, the chunk
menus of models/ring_attention.py and models/moe_pipeline.py, the pruning of
bench/roofline.py) against the JAX package's, the attn and moe parts of
tests/test_chunking.py.

* the protocol and the directive: serdes, ``chunk_menus``, ``chunks_of``;
* numerics: ``chunks=1`` is the op itself (bit for bit); every chunked count
  agrees with the unchunked order and with the reference executor on the
  same schedule JSON (attention within ``F32_STATE_TOL``, the expert-MLP
  partials within float32 rounding, bf16 staging within one bf16 ulp);
* the verifier certifies chunked projections; DFS, MCTS and the climb visit
  at least two chunk counts;
* the pruning arithmetic equals the reference's with the reference's
  constants passed in, and the card's constants give the menus stated.

The reference's tp_mlp fold is not mirrored: it fails in the reference
(ROADMAP Queue 3 item 3)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenzing_tpu.bench import roofline as ref_roofline
from tenzing_tpu.core import chunking as ref_chunking
from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.models import moe_pipeline as ref_pipe
from tenzing_tpu.models import ring_attention as ref_ra
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu_torch.bench import roofline
from tenzing_tpu_torch.bench.benchmarker import BenchOpts, EmpiricalBenchmarker
from tenzing_tpu_torch.core.chunking import (
    CHUNK_MARK,
    ChunkDirective,
    ChunkedOp,
    chunk_menus,
    chunk_variants,
    chunks_of,
    menu_info,
)
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.sequence import Sequence
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.core.state import State
from tenzing_tpu_torch.models import moe_pipeline as pipe
from tenzing_tpu_torch.models import ring_attention as ra
from tenzing_tpu_torch.ops import attention_kernels as ak
from tenzing_tpu_torch.core.operation import BoundDeviceOp
from tenzing_tpu_torch.runtime import fused
from tenzing_tpu_torch.runtime.executor import RunContext, StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.verify import ScheduleVerifier

ATTN = dict(n_devices=2, batch=2, seq_local=8, head_dim=4)
MOE = dict(n_experts=4, tokens=32, d_model=8, d_ff=16, n_chunks=2)
# the reference's constants, to hold the port's arithmetic to its own
V5E = dict(dispatch_us=ref_roofline.CHUNK_DISPATCH_US,
           min_chunk_bytes=ref_roofline.MIN_TILE_BYTES,
           peak_flops=ref_roofline.V5E_PEAK_BF16_FLOPS,
           hbm_bytes_per_s=ref_roofline.V5E_PEAK_HBM_BYTES)


def _attn_graph(impl_choice=False, ref=False, **kw):
    mod, G = (ref_ra, RefGraph) if ref else (ra, Graph)
    g = G()
    op = mod.BlockedAttention(mod.RingAttnArgs(**(kw or ATTN)),
                              impl_choice=impl_choice, chunk=True,
                              chunk_relax=True)
    g.start_then(op)
    g.then_finish(op)
    return g


def _drive(g, plat, want_suffix=None, rng=None):
    """The first decision at every step (a random one with ``rng``),
    preferring a choice alternative whose name ends with ``want_suffix``."""
    st = State(g)
    while not st.is_terminal():
        ds = st.get_decisions(plat)
        pick = None
        if want_suffix is not None:
            pick = next((d for d in ds
                         if getattr(d, "choice", None) is not None
                         and d.choice.name().endswith(want_suffix)), None)
        if pick is None:
            pick = ds[rng.randrange(len(ds))] if rng else ds[0]
        st = st.apply(pick)
    return st.sequence


def _attn_ex(n_lanes=1, seed=3):
    bufs, want = ra.make_blocked_buffers(ra.RingAttnArgs(**ATTN), seed=seed)
    return StreamExecutor(Platform.make_n_lanes(n_lanes),
                          buffers_from_numpy(bufs, "cpu"), device="cpu"), want


def _ref_attn_run(js, n_lanes=1, seed=3):
    bufs, _ = ref_ra.make_blocked_buffers(ref_ra.RingAttnArgs(**ATTN), seed=seed)
    rex = TraceExecutor(RefPlatform.make_n_lanes(n_lanes),
                        {k: jnp.asarray(v) for k, v in bufs.items()})
    out = rex.run(ref_from_json(js, _attn_graph(ref=True)))
    return {k: torch.from_numpy(np.asarray(jax.device_get(v)).copy())
            for k, v in out.items()}


def _state_close(got, want):
    names = ("acc", "m_run", "l_run")
    ok, errs = ak.state_check([got[n] for n in names], [want[n] for n in names],
                              ak.F32_STATE_TOL)
    assert ok, errs
    torch.testing.assert_close(got["O"], want["O"], **ak.F32_STATE_TOL["acc/l"])


# -- the protocol ---------------------------------------------------------------


def test_chunk_counts_and_split_equal_reference():
    a, ra_ = ra.RingAttnArgs(**ATTN), ref_ra.RingAttnArgs(**ATTN)
    step, rstep = ra.BlockAttnStep("attn_0", 1, a), ref_ra.BlockAttnStep("attn_0", 1, ra_)
    assert step.chunk_counts() == rstep.chunk_counts() == [1, 2, 4, 8]
    for n in (2, 4):
        parts, rparts = step.split(n), rstep.split(n)
        assert [p.name() for p in parts] == [p.name() for p in rparts]
        assert [p.reads() for p in parts] == [p.reads() for p in rparts]
        assert [p.writes() for p in parts] == [p.writes() for p in rparts]
        assert not any(p.chunkable() for p in parts)
        # sub-fold j of block 1 folds keys 8 + j*8/n, all 16 queries
        assert [p.fused_params()["key_off"] for p in parts] == \
            [8 + j * 8 // n for j in range(n)]
        assert {p._queries() for p in parts} == {16}
    m, rm = pipe.MoEPipeArgs(**MOE), ref_pipe.MoEPipeArgs(**MOE)
    ffn, rffn = pipe.ExpertFFNPipe("ffn_0", 0, m, 5, "bf16"), \
        ref_pipe.ExpertFFNPipe("ffn_0", 0, rm, 5, "bf16")
    assert ffn.chunk_counts() == rffn.chunk_counts() == [1, 2, 4]
    parts, rparts = ffn.split(2), rffn.split(2)
    assert [(p.name(), p.reads(), p.writes()) for p in parts] == \
        [(p.name(), p.reads(), p.writes()) for p in rparts]
    with pytest.raises(ValueError, match="do not split"):
        ffn.split(3)
    with pytest.raises(ValueError, match="do not split"):
        step.split(3)
    # the bound op delegates the protocol
    from tenzing_tpu_torch.core.resources import Lane

    bound = step.bind(Lane(0))
    assert bound.chunkable() and bound.chunk_counts() == step.chunk_counts()
    assert [p.name() for p in bound.split(2)] == [p.name() for p in step.split(2)]


def test_split_partials_chain_through_directive():
    v = ChunkedOp(ra.BlockAttnStep("attn_0", 0, ra.RingAttnArgs(**ATTN)), 2)
    g = v.graph()
    by = {op.name(): op for op in g.vertices()}
    assert f"attn_0{CHUNK_MARK}2" in by
    assert by["attn_0.c2p0"] in g.succs(by[f"attn_0{CHUNK_MARK}2"])
    assert by["attn_0.c2p1"] in g.succs(by["attn_0.c2p0"])
    assert v.name() == "attn_0.chunked.c2" and v.chunks() == 2


def test_chunked_op_guards():
    a = ra.RingAttnArgs(**ATTN)
    step = ra.BlockAttnStep("attn_0", 0, a)
    with pytest.raises(ValueError):
        ChunkedOp(step, 1)
    for kernel in (ra.BlockAttnStepPallas("attn_0.pallas", 0, a),
                   pipe.ExpertFFNPipePallas("ffn_0.pallas", 0,
                                            pipe.MoEPipeArgs(**MOE), 5)):
        with pytest.raises(ValueError, match="chunkable"):
            ChunkedOp(kernel, 2)
    assert [v.chunks() for v in chunk_variants(step, [1, 2, 2, 4])] == [2, 4]


def test_directive_serdes_and_markers():
    assert CHUNK_MARK == ref_chunking.CHUNK_MARK
    seq = [ChunkDirective("ffn_0.xla", 4), ChunkDirective("attn_1", 2)]
    assert chunks_of(seq) == {"ffn_0.xla": 4, "attn_1": 2}
    assert chunks_of([]) == {}
    d = ChunkDirective("attn_0", 2)
    assert d.to_json() == ref_chunking.ChunkDirective("attn_0", 2).to_json()
    back = sequence_from_json(sequence_to_json(Sequence([d])), _attn_graph())
    assert chunks_of(back) == {"attn_0": 2}
    m = menu_info("x", [4, 2, 2], {2: 10.0, 4: None})
    assert m == ref_chunking.menu_info("x", [4, 2, 2], {2: 10.0, 4: None})
    assert m["counts"] == [1, 2, 4] and m["est_hidden_us"] == {2: 10.0}


@pytest.mark.parametrize("n", [2, 4])
def test_reference_chunked_schedule_deserializes_in_the_port(n):
    """A chunked schedule driven in the reference runs here by name."""
    from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json
    from tenzing_tpu.core.state import State as RefState

    rg = _attn_graph(impl_choice=True, ref=True)
    st = RefState(rg)
    plat = RefPlatform.make_n_lanes(2)
    while not st.is_terminal():
        ds = st.get_decisions(plat)
        st = st.apply(next((d for d in ds if getattr(d, "choice", None) is not None
                            and d.choice.name().endswith(f".chunked.c{n}")), ds[0]))
    js = ref_to_json(st.sequence)
    g = _attn_graph(impl_choice=True)
    back = sequence_from_json(js, g)
    assert [op.name() for op in back] == [op.name() for op in st.sequence]
    assert set(chunks_of(back).values()) == {n}
    assert ScheduleVerifier(g)(back).ok


def test_chunk_menus_equal_reference():
    for impl in (False, True):
        menus = chunk_menus(_attn_graph(impl_choice=impl))
        rmenus = ref_chunking.chunk_menus(_attn_graph(impl_choice=impl, ref=True))
        assert menus == rmenus
        sfx = ".xla" if impl else ""
        assert set(menus) == {f"attn_{s}{sfx}" for s in range(2)}
        assert all(m["counts"] == [1, 2, 4] for m in menus.values())
    m, rm = pipe.MoEPipeArgs(**MOE), ref_pipe.MoEPipeArgs(**MOE)
    g = pipe.build_graph(m, 5, chunk=True, chunk_relax=True)
    rg = ref_pipe.build_graph(rm, 5, chunk=True, chunk_relax=True)
    assert chunk_menus(g) == ref_chunking.chunk_menus(rg)
    assert set(chunk_menus(g)) == {"ffn_0", "ffn_1"}


def test_chunk_menus_finds_every_staging_menu():
    """Under the staging menu every chain alternative carries its own menu.
    The reference's walk marks visited ops by ``id`` without keeping them
    alive, so a later temporary can reuse a freed id and be skipped; it
    misses some of these menus (ROADMAP Queue 3 item 8).  The port's keeps
    every visited op referenced and finds all four."""
    m, rm = pipe.MoEPipeArgs(**MOE), ref_pipe.MoEPipeArgs(**MOE)
    kw = dict(impl_choice=True, staging="choice", chunk=True, chunk_relax=True)
    menus = chunk_menus(pipe.build_graph(m, 5, **kw))
    assert set(menus) == {f"ffn{s}_{c}.xla" for s in ("", "16") for c in range(2)}
    rmenus = ref_chunking.chunk_menus(ref_pipe.build_graph(rm, 5, **kw))
    assert rmenus.items() <= menus.items()


# -- numerics ------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_naive_chunked_matches_unchunked_and_reference(n):
    ex, want = _attn_ex()
    plat = Platform.make_n_lanes(1)
    g = _attn_graph()
    base = ex.run(_drive(g, plat))
    seq = _drive(g, plat, want_suffix=f".chunked.c{n}")
    assert set(chunks_of(seq).values()) == {n}
    out = ex.run(seq)
    _state_close(out, base)
    _state_close(out, _ref_attn_run(sequence_to_json(seq)))
    np.testing.assert_allclose(out["O"].numpy(), want, rtol=2e-4, atol=2e-5)


def test_chunks_one_is_bit_identical():
    ex, _ = _attn_ex(seed=4)
    plat = Platform.make_n_lanes(1)
    plain = Graph()
    op = ra.BlockedAttention(ra.RingAttnArgs(**ATTN))
    plain.start_then(op)
    plain.then_finish(op)
    seq1 = _drive(_attn_graph(), plat)  # the first choice: the op itself
    assert not chunks_of(seq1)
    assert torch.equal(ex.run(_drive(plain, plat))["O"], ex.run(seq1)["O"])


@pytest.mark.parametrize("trial", range(3))
def test_randomized_two_lane_chunked_schedules_match(trial):
    ex, want = _attn_ex(n_lanes=2, seed=5)
    g = _attn_graph(impl_choice=True)
    plat = Platform.make_n_lanes(2)
    rng = random.Random(trial)
    seq = _drive(g, plat, want_suffix=f".chunked.c{2 ** (trial % 2 + 1)}", rng=rng)
    assert chunks_of(seq) and ScheduleVerifier(g)(seq).ok
    np.testing.assert_allclose(ex.run(seq)["O"].numpy(), want, rtol=2e-4,
                               atol=2e-5)


def _moe(staging, seed=1):
    m = pipe.MoEPipeArgs(**MOE)
    bufs, want, cap = pipe.make_pipe_buffers(m, seed=seed, staging=staging)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(
        bufs, "cpu", pipe.host_buffer_names(m, staging)), device="cpu")
    return m, cap, ex, want


@pytest.mark.parametrize("staging", ["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_moe_chunked_matches_unchunked_and_dense(staging, n):
    m, cap, ex, want = _moe(staging)
    g = pipe.build_graph(m, cap, staging=staging, chunk=True, chunk_relax=True)
    plat = Platform.make_n_lanes(2)
    base = ex.run(_drive(g, plat))["Y"]
    seq = _drive(g, plat, want_suffix=f".chunked.c{n}")
    assert set(chunks_of(seq).values()) == {n} and ScheduleVerifier(g)(seq).ok
    y = ex.run(seq)["Y"]
    # f32: the partials' products are the whole op's, per expert; bf16: an
    # expert output may round to its neighbour bf16 value
    tol = dict(rtol=1e-6, atol=1e-6) if staging == "f32" else \
        dict(rtol=2.0 ** -7, atol=1e-5)
    torch.testing.assert_close(y, base, **tol)
    dense = dict(rtol=2e-3, atol=2e-5) if staging == "f32" else \
        dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(y.numpy(), want, **dense)


@pytest.mark.parametrize("staging", ["f32", "bf16"])
def test_moe_partials_fold_to_the_reference_op(staging):
    """The n partials' slice updates fold to the whole op's output, and to
    the reference op's on the same received table."""
    m, rm = pipe.MoEPipeArgs(**MOE), ref_pipe.MoEPipeArgs(**MOE)
    bufs, _, cap = pipe.make_pipe_buffers(m, seed=3, with_expected=False,
                                          staging=staging)
    sfx = "16" if staging == "bf16" else ""
    recv = np.random.default_rng(4).standard_normal(
        bufs[f"send{sfx}_0"].shape).astype(np.float32)
    rbufs, _, _ = ref_pipe.make_pipe_buffers(rm, seed=3, with_expected=False,
                                             staging=staging)
    jb = {k: jnp.asarray(v) for k, v in rbufs.items()}
    dt = jnp.bfloat16 if sfx else jnp.float32
    jb[f"recv{sfx}_0"] = jnp.asarray(recv).astype(dt)
    ref_out = np.asarray(ref_pipe.ExpertFFNPipe("ffn_0", 0, rm, cap, staging)
                         .apply(dict(jb), None)[f"out{sfx}_0"], np.float32)
    tb = buffers_from_numpy(bufs, "cpu")
    tb[f"recv{sfx}_0"].copy_(torch.from_numpy(recv))
    op = pipe.ExpertFFNPipe("ffn_0", 0, m, cap, staging)
    ex = StreamExecutor(Platform.make_n_lanes(1), tb, device="cpu")
    ex._provision([op])
    ex.ctx.bufs = tb
    op.apply(tb, ex.ctx)
    whole = tb[f"out{sfx}_0"].float().clone()
    tol = dict(rtol=1e-5, atol=1e-5) if not sfx else dict(rtol=2.0 ** -7, atol=1e-4)
    np.testing.assert_allclose(whole.numpy(), ref_out, **tol)
    for n in (2, 4):
        tb[f"out{sfx}_0"].zero_()
        parts = op.split(n)
        ex._provision(parts)
        for p in parts:
            p.apply(tb, ex.ctx)
        torch.testing.assert_close(tb[f"out{sfx}_0"].float(), whole,
                                   **(dict(rtol=1e-6, atol=1e-6) if not sfx
                                      else dict(rtol=2.0 ** -7, atol=1e-4)))


# -- the verifier and the solvers ------------------------------------------------


def test_randomized_chunked_rollouts_verify_clean():
    for gi, g in enumerate([_attn_graph(), _attn_graph(impl_choice=True)]):
        ver = ScheduleVerifier(g)
        rng = random.Random(100 + gi)
        n_chunked = 0
        for _ in range(8):
            st = State(g)
            while not st.is_terminal():
                ds = st.get_decisions(Platform.make_n_lanes(2))
                pick = next((d for d in ds
                             if getattr(d, "choice", None) is not None
                             and ".chunked.c" in d.choice.name()
                             and rng.random() < 0.7), None)
                st = st.apply(pick or ds[rng.randrange(len(ds))])
            assert ver(st.sequence).ok, ver(st.sequence).witness()
            n_chunked += bool(chunks_of(st.sequence))
        assert n_chunked >= 1 and ver.unsound == 0


def test_projection_resolves_the_executed_count():
    from tenzing_tpu_torch.verify.soundness import project_graph

    g = _attn_graph()
    seq = _drive(g, Platform.make_n_lanes(1), want_suffix=".chunked.c4")
    evolved, notes = project_graph(g, frozenset(op.name() for op in seq))
    assert not notes
    names = {v.name() for v in evolved.vertices()}
    assert "attn_0.c4p0" in names and "attn_0.c2p0" not in names
    assert ScheduleVerifier(g)(seq).ok


def test_exhaustive_small_space_verifies_clean():
    from tenzing_tpu_torch.solve.dfs import enumerate_schedules

    g = _attn_graph()
    ver = ScheduleVerifier(g)
    states = enumerate_schedules(g, Platform.make_n_lanes(2), max_seqs=64,
                                 log=lambda m: None)
    assert any(chunks_of(s.sequence) for s in states)
    assert all(ver(s.sequence).ok for s in states) and ver.unsound == 0


def _bench(plat):
    ex, _ = _attn_ex(n_lanes=len(plat.lanes), seed=0)
    return EmpiricalBenchmarker(ex)


def _seen_counts(sims):
    seen = set()
    for s in sims:
        seen.update(set(chunks_of(s.order.vector()).values()) or {1})
    return seen


FAST = BenchOpts(n_iters=2, target_secs=0.0002)


def test_dfs_enumerates_chunk_alternatives():
    from tenzing_tpu_torch.solve.dfs import DfsOpts, explore

    plat = Platform.make_n_lanes(1)
    res = explore(_attn_graph(), plat, _bench(plat),
                  DfsOpts(max_seqs=24, bench_opts=FAST))
    seen = _seen_counts(res.sims)
    assert 1 in seen and len(seen) >= 2


def test_hill_climb_searches_chunks():
    from tenzing_tpu_torch.solve.local import LocalOpts, hill_climb

    plat = Platform.make_n_lanes(1)

    def prefer(op_name, choices):  # seed unchunked; the moves explore the menu
        return next((c for c in choices if ".chunked." not in c), None)

    res = hill_climb(_attn_graph(), plat, _bench(plat), phases=("attn",),
                     prefer=prefer, opts=LocalOpts(budget=6, seed=0,
                                                   bench_opts=FAST))
    seen = _seen_counts(res.sims)
    assert 1 in seen and len(seen) >= 2


def test_mcts_searches_chunks():
    from tenzing_tpu_torch.solve.mcts import MctsOpts, explore

    plat = Platform.make_n_lanes(1)
    res = explore(_attn_graph(), plat, _bench(plat),
                  MctsOpts(n_iters=12, seed=3, bench_opts=FAST, screen_opts=FAST))
    assert len(_seen_counts(res.sims)) >= 2


# -- the pruning -------------------------------------------------------------------


def test_prune_chunkings_equals_reference_with_its_constants():
    rng = random.Random(0)
    for _ in range(200):
        flops = rng.choice([0.0, 1e9, 1e11, 2e12])
        hbm = rng.choice([1e3, 3e5, 8 * 2**20, 1e9])
        comm = rng.choice([None, 0.0, 5.0, 300.0, 5e3])
        comb = rng.choice([0.0, 1e6, 1e8])
        counts = [1, 2, 4, 8, 16]
        mine = roofline.prune_chunkings(roofline.Cost(flops, hbm), counts,
                                        comm_us=comm, combine_bytes=comb, **V5E)
        theirs = ref_roofline.prune_chunkings(
            ref_roofline.Cost(flops, hbm), counts, comm_us=comm,
            combine_bytes=comb)
        assert mine == theirs
        for n in counts:
            assert roofline.hidden_comm_bound_us(
                roofline.Cost(flops, hbm), n, comm or 0.0,
                V5E["peak_flops"], V5E["hbm_bytes_per_s"]) == pytest.approx(
                ref_roofline.hidden_comm_bound_us(
                    ref_roofline.Cost(flops, hbm), n, comm or 0.0))


def test_card_constants_and_goldens():
    # an op whose least time on the card is 1000 us (f32 operations)
    c = roofline.Cost(flops=roofline.H100_PEAK_F32_FLOPS * 1e-3, hbm_bytes=1e6)
    assert roofline.op_roofline_us(c) == pytest.approx(1000.0)
    assert roofline.hidden_comm_bound_us(c, 2, 800.0) == pytest.approx(500.0)
    assert roofline.hidden_comm_bound_us(c, 4, 1e9) == pytest.approx(750.0)
    d = roofline.CHUNK_DISPATCH_US
    # n=2 hides up to 500 us for one dispatch: kept while the dispatch is less
    assert roofline.prune_chunkings(c, [1, 2], comm_us=500.0) == [1, 2]
    assert roofline.prune_chunkings(c, [1, 2], comm_us=d * 0.5) == [1]
    assert roofline.prune_chunkings(c, [1, 2, 4], comm_us=0.0) == [1]
    # the card's floor is the tile floor: nothing is too small to chunk
    assert roofline.prune_chunkings(roofline.Cost(0.0, 10.0), [1, 2, 4]) == [1, 2, 4]
    # no v5e number is a card constant
    ref = {ref_roofline.CHUNK_DISPATCH_US, ref_roofline.V5E_XFER_GBS,
           ref_roofline.V5E_PEAK_BF16_FLOPS, ref_roofline.V5E_PEAK_HBM_BYTES,
           ref_roofline.MIN_TILE_BYTES}
    assert not ref & {roofline.CHUNK_DISPATCH_US, roofline.XFER_GBS,
                      roofline.H100_PEAK_F32_FLOPS, roofline.H100_PEAK_HBM_BYTES,
                      roofline.MIN_TILE_BYTES}
    assert roofline.MENU_CHUNK_CAP == ref_roofline.MENU_CHUNK_CAP


def test_model_menus_relaxed_and_pruned():
    a = ra.RingAttnArgs(**ATTN)
    assert ra.fold_chunk_menu(a, relax=True) == \
        ref_ra.fold_chunk_menu(ref_ra.RingAttnArgs(**ATTN), relax=True) == \
        ([1, 2, 4], {})
    # the full-size blocked fold has no transfer to hide: every n > 1 pruned
    full = ra.RingAttnArgs(n_devices=8, batch=4, seq_local=1024, head_dim=128)
    assert ra.fold_chunk_menu(full) == ([1], {})
    m = pipe.MoEPipeArgs(**MOE)
    assert pipe.ffn_chunk_menu(m, 5, relax=True) == ([1, 2, 4], {})
    # full-size moe (one chunk's 8 x 304 slot table): the combine hop at the
    # card's copy rate against the MLP's f32 time and the card's dispatch
    mf = pipe.MoEPipeArgs(tokens=8192)
    counts, est = pipe.ffn_chunk_menu(mf, 304)
    table = 8 * 304 * 512 * 4
    comm = table / (roofline.XFER_GBS * 1e9) * 1e6
    cost = roofline.Cost(4.0 * 8 * 304 * 512 * 2048,
                         2.0 * table + 8 * 2 * 512 * 2048 * 4)
    assert counts == roofline.prune_chunkings(cost, [1, 2, 4], comm_us=comm,
                                              combine_bytes=2.0 * table)
    assert est == {n: roofline.hidden_comm_bound_us(cost, n, comm)
                   for n in counts if n > 1}


# -- the executor: no host block at a chunk directive ---------------------------


class _Recorder(RunContext):
    """A CPU run context that logs what the executor does: the EventSyncs it
    runs, the host blocks and stream waits it issues, and every op it runs
    (device ops with their lanes, host ops with whether they touch a
    buffer)."""

    def __init__(self, defer: bool = True):
        super().__init__(torch.device("cpu"), defer_host_syncs=defer)
        self.log = []

    def run_default(self, op):
        if isinstance(op, BoundDeviceOp):
            self.log.append(("launch", op.name(),
                             tuple(lane.id for lane in op.lanes())))
        else:
            self.log.append(("host", op.name(),
                             bool(op.reads() or op.writes())))
        super().run_default(op)

    def post_transfer(self, op):
        self.log.append(("host", op.name(), True))
        super().post_transfer(op)

    def await_transfer(self, buf):
        self.log.append(("host", f"await {buf}", True))
        super().await_transfer(buf)

    def sync_event_host(self, event):
        self.log.append(("event_sync", event.id))
        super().sync_event_host(event)

    def host_wait_event(self, event):
        self.log.append(("host_wait", event.id))
        super().host_wait_event(event)

    def wait_event(self, lane, event):
        self.log.append(("stream_wait", lane.id, event.id))
        super().wait_event(lane, event)


def _check_ordering(log):
    """Every op runs after every earlier EventSync's event, as a blocking
    EventSync would order it: a device op through a host block or a stream
    wait of each of its lanes, a host op that touches a buffer through a
    host block; and the schedule ends with every event waited on.  Returns,
    per directive, the events still pending (not host-waited) when it ran."""
    synced, host_done, stream_done, at_directives = [], set(), set(), []
    for entry in log:
        if entry[0] == "event_sync":
            synced.append(entry[1])
        elif entry[0] == "host_wait":
            host_done.add(entry[1])
        elif entry[0] == "stream_wait":
            stream_done.add(entry[1:])
        elif entry[0] == "launch":
            for e in synced:
                assert e in host_done or all(
                    (lane, e) in stream_done for lane in entry[2]), entry
        elif entry[0] == "host":
            if entry[2]:
                assert set(synced) <= host_done, entry
            if CHUNK_MARK in entry[1]:
                at_directives.append(set(synced) - host_done)
    assert set(synced) <= host_done
    return at_directives


def _recorded(ex, order, defer):
    ex.ctx = _Recorder(defer)
    out = ex.run(order)
    return ex.ctx, out


@pytest.mark.parametrize("fuse", [False, True], ids=["stream", "fused"])
def test_chunk_directive_does_not_block_the_host(fuse):
    """Attention's chunked naive order: the synchronizer puts an
    EventRecord / EventSync before the second block's directive (its
    predecessor is the first block's last sub-fold).  With the host syncs
    deferred the directive runs with that event pending, the sub-folds
    after it wait on it on their stream, and the run still ends with every
    event waited on; blocking at every EventSync gives the same outputs
    with one more host block.  The fused executor runs the same rule."""
    plat = Platform.make_n_lanes(1)
    seq = _drive(_attn_graph(), plat, want_suffix=".chunked.c2")
    runs = {}
    for defer in (True, False):
        ex, _ = _attn_ex()
        runner = fused.FusedExecutor(ex, tiles=1) if fuse else ex
        if fuse:
            runner.plan(seq)  # lowered before the recorder is installed
        ctx, out = _recorded(ex, runner.fused_order(seq) if fuse else seq,
                             defer)
        runs[defer] = (ctx, out)
    (on, out_on), (off, out_off) = runs[True], runs[False]
    pending = _check_ordering(on.log)
    assert len(pending) == 2 and pending[0] == set() and pending[1], pending
    assert all(not p for p in _check_ordering(off.log))
    # the block after the pending sync waits on it on the device
    assert any(e[0] == "stream_wait" for e in on.log)
    assert not any(e[0] == "stream_wait" for e in off.log)
    assert on.host_syncs == off.host_syncs - 1
    for k in out_on:
        assert torch.equal(out_on[k], out_off[k]), k


def test_moe_chunked_orders_keep_their_host_syncs():
    """The moe pipeline's chunk directive follows the dispatch await, a host
    op: no EventSync precedes it, so deferring changes nothing there — the
    same host blocks and the same Y, bit for bit."""
    m, cap, _, _ = _moe("f32")
    g = pipe.build_graph(m, cap, staging="f32", chunk=True, chunk_relax=True)
    plat = Platform.make_n_lanes(2)
    for n in (2, 4):
        seq = _drive(g, plat, want_suffix=f".chunked.c{n}")
        runs = {}
        for defer in (True, False):
            ex = _moe("f32")[2]
            runs[defer] = _recorded(ex, seq, defer)
        (on, y_on), (off, y_off) = runs[True], runs[False]
        assert all(not p for p in _check_ordering(on.log))
        assert on.host_syncs == off.host_syncs
        assert torch.equal(y_on["Y"], y_off["Y"])
