"""The port's SpMV iteration (tenzing_tpu_torch/models/spmv.py) and its
``ell_spmv`` kernel (ops/spmv_kernels.py) against the JAX package.

* Host structures: the buffers, the split, the slab and the .mtx reader give
  the reference's arrays bit for bit.
* Row 15: the reference's ``ell_spmv_pallas`` in the Pallas interpreter
  (``interpret=True``, as tests/test_spmv.py reaches it) against the port's
  ``ell_spmv`` on CPU tensors (its plain version) at ``ELL_TOL``: both sum w
  float32 products per row in different orders.  A control that drops one
  slab column must fail that tolerance.
* Whole orders: the naive order and seeded random legal 2-lane orders, as
  schedule JSON, through the reference ``TraceExecutor`` and the port's
  ``StreamExecutor(device="cpu")``; y against each other and against the
  float64 ``CsrMat.matvec``.
* The reference fault the port keeps out: ``SpMVPallasOp`` falls back to the
  gather path off the kernel's gate; the port's raises.

``test_cuda_kernel_matches_plain`` needs the card (marker ``needs_cuda``)."""

import json
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tenzing_tpu.core.graph import Graph as RefGraph
from tenzing_tpu.core.platform import Platform as RefPlatform
from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
from tenzing_tpu.models import spmv as ref
from tenzing_tpu.ops.spmv_pallas import ell_spmv_pallas
from tenzing_tpu.ops.spmv_pallas import supports as ref_supports
from tenzing_tpu.runtime.executor import TraceExecutor
from tenzing_tpu_torch.core.graph import Graph
from tenzing_tpu_torch.core.platform import Platform
from tenzing_tpu_torch.core.serdes import sequence_from_json, sequence_to_json
from tenzing_tpu_torch.core.state import State
from tenzing_tpu_torch.models import spmv
from tenzing_tpu_torch.ops import spmv_kernels as sk
from tenzing_tpu_torch.runtime.executor import StreamExecutor, buffers_from_numpy
from tenzing_tpu_torch.verify import ScheduleVerifier

ELL_TOL = sk.ELL_TOL


@pytest.mark.parametrize("m", [64, 512])
def test_buffers_bit_identical_to_reference(m):
    mine, want = spmv.make_spmv_buffers(m=m, nnz_per_row=10, seed=3)
    theirs, ref_want = ref.make_spmv_buffers(m=m, nnz_per_row=10, seed=3)
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    np.testing.assert_array_equal(want, ref_want)


@pytest.mark.parametrize("m", [64, 512])
def test_split_local_remote_bit_identical(m):
    for a_mine, a_ref in (
            (spmv.random_band_matrix(m, m // 8, 6 * m, seed=1),
             ref.random_band_matrix(m, m // 8, 6 * m, seed=1)),
            (spmv.random_matrix(m, m, 3 * m, seed=2),
             ref.random_matrix(m, m, 3 * m, seed=2))):
        for lo, hi in ((0, m // 2), (m // 3, m)):
            got = spmv.split_local_remote(a_mine, lo, hi)
            want = ref.split_local_remote(a_ref, lo, hi)
            np.testing.assert_array_equal(got.remote_cols, want.remote_cols)
            for part in ("local", "remote"):
                g, w = getattr(got, part), getattr(want, part)
                assert (g.m, g.n) == (w.m, w.n)
                for f in ("indptr", "cols", "vals"):
                    assert getattr(g, f).dtype == getattr(w, f).dtype
                    np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_csr_helpers_equal_reference():
    a, b = spmv.random_band_matrix(40, 5, 200, seed=4), \
        ref.random_band_matrix(40, 5, 200, seed=4)
    for width in (None, 20):
        for x, y in zip(a.to_slab(width), b.to_slab(width)):
            np.testing.assert_array_equal(x, y)
    r1, r2 = a.retain_rows(7, 30), b.retain_rows(7, 30)
    for f in ("indptr", "cols", "vals"):
        np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f))
    x = np.random.default_rng(0).random(40, dtype=np.float32)
    np.testing.assert_array_equal(a.matvec(x), b.matvec(x))
    np.testing.assert_array_equal(a.toarray(), b.toarray())
    with pytest.raises(ValueError):
        a.to_slab(1)
    for m, parts in ((10, 3), (7, 7), (100, 8)):
        assert spmv.part_by_rows(m, parts) == ref.part_by_rows(m, parts)
        assert [spmv.get_owner(m, parts, r) for r in range(m)] == \
            [ref.get_owner(m, parts, r) for r in range(m)]


@pytest.mark.parametrize("field,symmetry", [("real", "general"),
                                            ("integer", "symmetric"),
                                            ("pattern", "general"),
                                            ("real", "skew-symmetric")])
def test_read_matrix_market_equals_reference(tmp_path, field, symmetry):
    entries = [(1, 1, 2.5), (3, 1, -1.0), (2, 2, 4.0), (4, 3, 7.25), (4, 4, 1.0)]
    if symmetry == "skew-symmetric":
        entries = [e for e in entries if e[0] != e[1]]
    lines = [f"%%MatrixMarket matrix coordinate {field} {symmetry}",
             "% a comment", "", f"4 4 {len(entries)}"]
    for r, c, v in entries:
        val = "" if field == "pattern" else (
            f" {int(v)}" if field == "integer" else f" {v}")
        lines.append(f"{r} {c}{val}")
    path = tmp_path / "m.mtx"
    path.write_text("\n".join(lines) + "\n")
    got, want = spmv.read_matrix_market(str(path)), ref.read_matrix_market(str(path))
    assert (got.m, got.n) == (want.m, want.n)
    for f in ("indptr", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # the examples' path: the matrix in place of the band matrix
    bufs, y = spmv.make_spmv_buffers(matrix=got)
    rbufs, ry = ref.make_spmv_buffers(matrix=want)
    np.testing.assert_array_equal(y, ry)
    for k in rbufs:
        np.testing.assert_array_equal(bufs[k], rbufs[k])


def test_read_matrix_market_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    with pytest.raises(ValueError, match="coordinate"):
        spmv.read_matrix_market(str(bad))
    short = tmp_path / "short.mtx"
    short.write_text("%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1.0\n")
    with pytest.raises(ValueError, match="promised"):
        spmv.read_matrix_market(str(short))


# -- row 15: ell_spmv ----------------------------------------------------------

# (m, w, n): ragged m against the reference's 512-row block, w = 1, n = 1,
# n = 4096 (the gate's edge) and a width above one warp
ELL_CASES = [(37, 5, 300), (1000, 23, 4093), (64, 1, 50), (50, 7, 1),
             (513, 12, 4096), (9, 40, 128)]


def _ell_inputs(m, w, n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((m, w)).astype(np.float32)
    cols = rng.integers(0, n, size=(m, w)).astype(np.int32)
    x = rng.standard_normal(n).astype(np.float32)
    return vals, cols, x


@pytest.mark.parametrize("m,w,n", ELL_CASES)
def test_ell_spmv_matches_reference_kernel(m, w, n):
    vals, cols, x = _ell_inputs(m, w, n, seed=m + w + n)
    want = np.asarray(ell_spmv_pallas(jnp.asarray(vals), jnp.asarray(cols),
                                      jnp.asarray(x), interpret=True))
    before = sk.LAUNCHES["ell_spmv"]
    got = sk.ell_spmv(torch.from_numpy(vals), torch.from_numpy(cols),
                      torch.from_numpy(x))
    assert sk.LAUNCHES["ell_spmv"] == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, **ELL_TOL)
    exact = (vals.astype(np.float64) * x.astype(np.float64)[cols]).sum(1)
    np.testing.assert_allclose(got.numpy(), exact, **ELL_TOL)


def test_ell_tolerance_rejects_a_dropped_column():
    vals, cols, x = _ell_inputs(1000, 23, 4093, seed=5)
    got = sk.ell_spmv_plain(torch.from_numpy(vals), torch.from_numpy(cols),
                            torch.from_numpy(x))
    ctl = sk.ell_spmv_plain(torch.from_numpy(vals[:, :-1].copy()),
                            torch.from_numpy(cols[:, :-1].copy()),
                            torch.from_numpy(x))
    assert not torch.allclose(ctl, got, **ELL_TOL)


CSRC = Path(__file__).resolve().parents[1] / "tenzing_tpu_torch" / "csrc"

# the kernel's staging plan (csrc/ell_spmv.cu), mirrored by ell_row_plan:
# widths around the 16-byte boundary (w % 4), the staged width (32) and
# above it; slab views 0, 4 and 104 bytes off a 16-byte boundary
PLAN_WIDTHS = [1, 5, 22, 23, 32, 33, 40]
PLAN_OFFSETS = [0, 4, 104]


@pytest.mark.parametrize("off", PLAN_OFFSETS)
@pytest.mark.parametrize("w", PLAN_WIDTHS)
def test_ell_row_plan_covers_every_row_once(w, off):
    """Each warp piece of 32 rows copies its 16-byte aligned part into
    shared memory; a row is read from there only where it lies inside
    that part, every other row from global memory, and no row twice."""
    for m in (1, 31, 32, 33, 1000, 1001, 8192):
        plan = sk.ell_row_plan(m, w, off, off)
        assert [p[0] for p in plan] == list(range(0, m, 32))
        seen = 0
        for r0, r1, b0, a0, a1, rows in plan:
            assert r1 - r0 == len(rows) and r1 == min(r0 + 32, m)
            seen += len(rows)
            assert b0 % 4 == 0 and a0 % 4 == 0 and a1 % 4 == 0
            assert b0 <= r0 * w <= a0 <= a1 <= r1 * w
            assert a1 - b0 <= 32 * sk.SLAB_WIDTH + 4  # the piece fits
            for i, staged in enumerate(rows):
                r = r0 + i
                assert staged == (a0 <= r * w and r * w + w <= a1)
            if off or w > sk.SLAB_WIDTH:
                assert a1 == a0 and not any(rows)  # all from global memory
            else:
                # a piece's first row starts 16-byte aligned, so only the
                # rows reaching into its last < 16 bytes (of a ragged m) are
                # read from global memory: a suffix, one row where w >= 4
                assert a0 == r0 * w
                g0 = rows.index(False) if False in rows else len(rows)
                assert not any(rows[g0:])
                assert (len(rows) - g0 - 1) * w < 4
                assert all(rows) == (r1 * w % 4 == 0)
        assert seen == m


def test_ell_row_plan_at_the_main_shape_stages_every_row():
    plan = sk.ell_row_plan(8192, 22)
    assert len(plan) == 256  # 256 warps: one wave of 128 two-warp blocks
    assert all(all(rows) for *_, rows in plan)


def _kernel_order(vals, cols, x, x_batch):
    """The kernels' row sum (csrc/ell_row.cuh) in numpy: entry j into partial
    j % x_batch by a fused multiply-add (the exact float64 product added to
    the float32 partial, rounded once to float32), then the partials added
    pairwise as a tree in float32."""
    t = vals.astype(np.float64) * x.astype(np.float64)[cols]
    acc = np.zeros((vals.shape[0], x_batch), np.float32)
    for j in range(vals.shape[1]):
        u = j % x_batch
        acc[:, u] = (acc[:, u].astype(np.float64) + t[:, j]).astype(np.float32)
    s = x_batch // 2
    while s:
        acc[:, :s] = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    return acc[:, 0]


@pytest.mark.parametrize("x_batch", [8, 16, 32])
@pytest.mark.parametrize("w", PLAN_WIDTHS)
def test_row_sum_bound_holds_the_kernel_order(w, x_batch):
    """The kernels' order on signed rows (which cancel) stays within
    row_sum_bound at its batch (8, and the bench's 16 and 32 ablations),
    and a dropped slab column breaks the same bound."""
    vals, cols, x = _ell_inputs(1000, w, 4093, seed=w + x_batch)
    got = torch.from_numpy(_kernel_order(vals, cols, x, x_batch))
    vt, ct, xt = (torch.from_numpy(a) for a in (vals, cols, x))
    y64, bound = sk.row_sum_bound(vt, ct, xt, x_batch)
    assert bool(((got.double() - y64).abs() <= bound).all())
    if w > 1:
        ctl = torch.from_numpy(_kernel_order(
            np.ascontiguousarray(vals[:, :-1]), np.ascontiguousarray(cols[:, :-1]),
            x, x_batch))
        assert not bool(((ctl.double() - y64).abs() <= bound).all())


def test_ell_ablation_edits_apply_to_the_source():
    from tenzing_tpu_torch.bench import ell_spmv

    texts = {f: (CSRC / f).read_text() for f in ell_spmv.FILES}
    for name, edits in ell_spmv.ABLATIONS.items():
        for f, old, new in edits:
            assert texts[f].count(old) == 1, (name, old)
            assert old != new
    for name in ("kWarps", "kSlabWidth"):
        assert re.search(rf"constexpr int {name} = \d+;", texts["ell_spmv.cu"]), name
    assert '#include "ell_row.cuh"' in texts["ell_spmv.cu"]
    assert re.search(r"constexpr int kXBatch = (\d+);",
                     texts["ell_row.cuh"]).group(1) == str(sk.X_BATCH)
    assert re.search(r"constexpr int kSlabWidth = (\d+);",
                     texts["ell_spmv.cu"]).group(1) == str(sk.SLAB_WIDTH)


def test_fused_spmv_ablation_edits_apply_to_the_source():
    """Every ablation of bench/fused_spmv.py applies to this tree's
    fused_region.cu and the row sum it includes from ell_row.cuh."""
    from tenzing_tpu_torch.bench import fused_spmv

    texts = {f: (CSRC / f).read_text() for f in fused_spmv.FILES}
    assert '#include "ell_row.cuh"' in texts["fused_region.cu"]
    for name, (alternatives, _) in fused_spmv.ABLATIONS.items():
        edited = fused_spmv.apply(texts, alternatives)
        assert edited is not None, name
        assert edited != texts, name


@pytest.mark.parametrize("case", range(11))
def test_ell_bench_cases_pass_their_checks_on_the_cpu(case, monkeypatch):
    """bench/ell_spmv.py's cases (signed values, slab views off 16 bytes)
    through its checks with the wrapper's plain version (CPU tensors): the
    float64 bound holds, the dropped column is rejected."""
    from tenzing_tpu_torch.bench import ell_spmv

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    m, w, n, off = ell_spmv.CASES[case]
    vals, cols, x = ell_spmv.case_inputs(torch, torch.device("cpu"), m, w, n, off)
    assert vals.data_ptr() % 16 == 4 * off % 16
    row = ell_spmv.check_case(torch, None, "cpu", vals, cols, x)
    assert row["within_f64_bound"] and row["deterministic"] and row["finite"]
    assert row["control_rejected"] or w == 1


def test_row_sum_bound_holds_the_plain_version_and_rejects_a_dropped_column():
    vals, cols, x = (torch.from_numpy(t) for t in _ell_inputs(1000, 23, 4093, 6))
    y64, bound = sk.row_sum_bound(vals, cols, x)
    got = sk.ell_spmv_plain(vals, cols, x)
    assert bool(((got.double() - y64).abs() <= bound).all())
    ctl = sk.ell_spmv_plain(vals[:, :-1].contiguous(), cols[:, :-1].contiguous(), x)
    assert not bool(((ctl.double() - y64).abs() <= bound).all())


def test_supports_equals_reference_gate():
    for n in (1, 127, 128, 4095, 4096, 4097, 8192, 150000):
        assert sk.supports(n) == ref_supports(n)
    assert sk.MAX_X == 4096


def test_ell_spmv_refuses_what_the_kernel_does_not_take():
    vals, cols, x = (torch.from_numpy(t) for t in _ell_inputs(8, 3, 5000, 1))
    with pytest.raises(ValueError, match="4096"):
        sk.ell_spmv(vals, cols, x)
    with pytest.raises(TypeError, match="int32"):
        sk.ell_spmv(vals, cols.long(), x[:10])
    with pytest.raises(ValueError, match="shape"):
        sk.ell_spmv(vals, cols[:, :2].contiguous(), x[:10])


def test_ell_bound_counts_bytes():
    """At m=8192 (the --m 8192 path's spmv_remote: a (8192, 22) slab, x of
    4093) the kernel must move 1.49 MB: ~0.44 us at 3.35 TB/s."""
    nbytes = sk.ell_bytes(8192, 22, 4093)
    assert nbytes == pytest.approx(1.49e6, rel=0.01)
    assert nbytes / 3.35e12 > sk.ell_flops(8192, 22) / 67e12


@pytest.mark.parametrize("x_size", [None, 100, 4096, 4097])
def test_impl_menu_equals_reference(x_size):
    mine = spmv.SpMVImplChoice("spmv_remote", "x", "y", "v", "c", x_size=x_size)
    theirs = ref.SpMVImplChoice("spmv_remote", "x", "y", "v", "c", x_size=x_size)
    assert [o.name() for o in mine.choices()] == [o.name() for o in theirs.choices()]
    assert [o.KIND for o in mine.choices()] == [o.KIND for o in theirs.choices()]


def test_pallas_slot_raises_off_the_gate_where_the_reference_falls_back():
    """The reference fault (ROADMAP Queue 3): off its gate the reference's
    SpMVPallasOp quietly runs the gather path (models/spmv.py:314-315); the
    port's refuses."""
    vals, cols, x = _ell_inputs(16, 3, 5000, seed=2)
    rop = ref.SpMVPallasOp("s.pallas", "x", "y", "v", "c")
    out = rop.apply({"x": jnp.asarray(x), "v": jnp.asarray(vals),
                     "c": jnp.asarray(cols)}, None)
    assert out["y"].shape == (16,)  # no error: the silent fallback
    op = spmv.SpMVPallasOp("s.pallas", "x", "y", "v", "c")
    bufs = {"x": torch.from_numpy(x), "v": torch.from_numpy(vals),
            "c": torch.from_numpy(cols), "y": torch.zeros(16)}

    class Ctx:
        plain_kernels = False

    with pytest.raises(ValueError, match="ell_spmv"):
        op.apply(bufs, Ctx())


def test_synth_is_refused():
    """The pipe sketch routes the host link: ``synth=True`` on the local
    exchange is refused, as in the reference (the synthesized exchange
    itself: tests/test_torch_collectives.py)."""
    with pytest.raises(ValueError, match="exchange='host'"):
        spmv.SpMVCompound(exchange="local", synth=True)
    assert spmv.spmv_synth_counts(None) == [] and spmv.spmv_synth_counts(3) == [2]
    assert spmv.spmv_host_buffer_names(8, synth=True) == [
        "host_x", "x_exchange.pipe2.x0.hst", "x_exchange.pipe2.x1.hst",
        "x_exchange.pipe4.x0.hst", "x_exchange.pipe4.x1.hst",
        "x_exchange.pipe4.x2.hst", "x_exchange.pipe4.x3.hst"]


# -- whole orders through both executors --------------------------------------

SIZE = dict(m=96, nnz_per_row=4, seed=1)
MENU_X = {"x_local": 96}


def _graphs(exchange, menus):
    kw = dict(exchange=exchange)
    if menus:
        bufs, _ = spmv.make_spmv_buffers(**SIZE)
        kw.update(impl_choice=True,
                  x_sizes={"x_local": 96, "x_remote": len(bufs["x_remote"])})
    g, rg = Graph(), RefGraph()
    g.start_then(spmv.SpMVCompound(**kw))
    g.then_finish(spmv.SpMVCompound(**kw))
    rg.start_then(ref.SpMVCompound(**kw))
    rg.then_finish(ref.SpMVCompound(**kw))
    return g, rg


def _orders(exchange, menus):
    """(label, JSON): the naive order and seeded random legal 2-lane ones."""
    g, _ = _graphs(exchange, menus)
    out = []
    st = State(g)
    one = Platform.make_n_lanes(1)
    while not st.is_terminal():
        st = st.apply(st.get_decisions(one)[0])
    out.append(("naive", sequence_to_json(st.sequence)))
    two = Platform.make_n_lanes(2)
    for k in range(3):
        rng = random.Random(k)
        st = State(g)
        while not st.is_terminal():
            ds = st.get_decisions(two)
            st = st.apply(ds[rng.randrange(len(ds))])
        out.append((f"random{k}", sequence_to_json(st.sequence)))
    return out


def _cases():
    out = []
    for exchange in ("local", "host"):
        for menus in (False, True):
            for label, js in _orders(exchange, menus):
                out.append((f"{exchange}-{'menu' if menus else 'plain'}-{label}",
                            exchange, menus, js))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _port_run(exchange, menus, js):
    g, _ = _graphs(exchange, menus)
    order = sequence_from_json(js, g)
    assert ScheduleVerifier(g)(order).ok
    bufs, want = spmv.make_spmv_buffers(**SIZE)
    ex = StreamExecutor(Platform.make_n_lanes(2),
                        buffers_from_numpy(bufs, "cpu",
                                           spmv.spmv_host_buffer_names()),
                        device="cpu")
    return {k: v.numpy() for k, v in ex.run(order).items()}, want


@pytest.mark.parametrize("label,exchange,menus,js",
                         [c for c in CASES if c[1] == "local"],
                         ids=[c[0] for c in CASES if c[1] == "local"])
def test_local_exchange_orders_equal_reference_executor(label, exchange, menus, js):
    got, want = _port_run(exchange, menus, js)
    _, rg = _graphs(exchange, menus)
    bufs, _ = ref.make_spmv_buffers(**SIZE)
    ex = TraceExecutor(RefPlatform.make_n_lanes(2),
                       {k: jnp.asarray(v) for k, v in bufs.items()})
    out = ex.run(ref_from_json(js, rg))
    for k in ("y", "y_local", "y_remote", "send_buf", "x_remote"):
        np.testing.assert_allclose(got[k], np.asarray(jax.device_get(out[k])),
                                   **ELL_TOL, err_msg=k)
    np.testing.assert_allclose(got["y"], want, **ELL_TOL)


@pytest.mark.parametrize("label,exchange,menus,js", CASES, ids=IDS)
def test_orders_reproduce_the_expected_y(label, exchange, menus, js):
    got, want = _port_run(exchange, menus, js)
    np.testing.assert_allclose(got["y"], want, **ELL_TOL)
    if exchange == "host":
        np.testing.assert_array_equal(got["host_x"], got["send_buf"])


@pytest.mark.needs_pinned_host
@pytest.mark.parametrize("label,exchange,menus,js",
                         [c for c in CASES if c[1] == "host"],
                         ids=[c[0] for c in CASES if c[1] == "host"])
def test_host_exchange_orders_equal_reference_executor(label, exchange, menus, js):
    got, _ = _port_run(exchange, menus, js)
    _, rg = _graphs(exchange, menus)
    bufs, _ = ref.make_spmv_buffers(**SIZE)
    ex = TraceExecutor(RefPlatform.make_n_lanes(2), TraceExecutor.place_host_buffers(
        bufs, ref.spmv_host_buffer_names()))
    out = ex.run(ref_from_json(js, rg))
    for k in ("y", "y_local", "y_remote", "x_remote"):
        np.testing.assert_allclose(got[k], np.asarray(jax.device_get(out[k])),
                                   **ELL_TOL, err_msg=k)


def test_schedule_json_round_trips_between_packages():
    for exchange in ("local", "host"):
        g, rg = _graphs(exchange, True)
        for _, js in _orders(exchange, True):
            from tenzing_tpu.core.serdes import sequence_to_json as ref_to_json

            assert json.dumps(ref_to_json(ref_from_json(js, rg))) == json.dumps(js)


def test_timed_runs_write_in_place_and_allocate_scratch_once():
    g, _ = _graphs("host", True)
    bufs, want = spmv.make_spmv_buffers(**SIZE)
    ex = StreamExecutor(Platform.make_n_lanes(2), buffers_from_numpy(
        bufs, "cpu", spmv.spmv_host_buffer_names()), device="cpu")
    _, js = _orders("host", True)[1]
    order = sequence_from_json(js, g)
    ptrs = {k: v.data_ptr() for k, v in ex.init_bufs.items()}
    ex.prepare_n(order)(3)
    assert ptrs == {k: v.data_ptr() for k, v in ex.init_bufs.items()}
    np.testing.assert_allclose(ex.init_bufs["y"].numpy(), want, **ELL_TOL)
    scratch = dict(ex.ctx.scratch)
    ex.prepare_n(order)(2)
    assert all(ex.ctx.scratch[k] is v for k, v in scratch.items())


def test_kernel_slots_never_join_a_region():
    op = spmv.SpMVPallasOp("s.pallas", "x", "y", "v", "c")
    assert op.uses_pallas() and op.bind(Platform.make_n_lanes(1).lanes[0]).uses_pallas()
    assert not spmv.SpMVOp("s", "x", "y", "v", "c").uses_pallas()
    for mine, theirs in ((spmv.SpMVOp("s", "x", "y", "v", "c"),
                          ref.SpMVOp("s", "x", "y", "v", "c")),
                         (spmv.Scatter("s", "x", "i", "o"), ref.Scatter("s", "x", "i", "o")),
                         (spmv.VectorAdd("s", "a", "b", "o"),
                          ref.VectorAdd("s", "a", "b", "o")),
                         (spmv.LocalExchange("s", "a", "b"),
                          ref.LocalExchange("s", "a", "b"))):
        assert mine.fusible() == theirs.fusible() is True
        assert mine.fuse_tiling() == theirs.fuse_tiling()
        assert mine.KIND == theirs.KIND


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("m,w,n", ELL_CASES)
def test_cuda_kernel_matches_plain(cuda_device, m, w, n):
    vals, cols, x = (torch.from_numpy(t).to(cuda_device)
                     for t in _ell_inputs(m, w, n, seed=9))
    before = sk.LAUNCHES["ell_spmv"]
    got = sk.ell_spmv(vals, cols, x)
    again = sk.ell_spmv(vals, cols, x)
    want = sk.ell_spmv_plain(vals, cols, x)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ell_spmv"] == before + 2
    torch.testing.assert_close(got, want, **ELL_TOL)
    assert torch.equal(got, again)


# (m, w, n, slab offset in floats): the plan's widths, n = 1, 4093 and 4096,
# slab views 4 and 104 bytes off a 16-byte boundary, m ragged against a warp
CARD_CASES = ([(1001, w, 4093, 0) for w in PLAN_WIDTHS]
              + [(300, 22, 1, 0), (300, 22, 4096, 0), (1000, 22, 4093, 1),
                 (1000, 26, 4093, 26), (8192, 22, 4093, 0)])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("m,w,n,off", CARD_CASES,
                         ids=[f"m{m}-w{w}-n{n}-off{o}" for m, w, n, o in CARD_CASES])
def test_cuda_kernel_signed_rows_within_rounding_bound(cuda_device, m, w, n, off):
    """Signed rows cancel, so the kernel's order and the plain version's
    differ by a few ulps of the partial sums; the kernel is held against
    the float64 product within its order's rounding bound, two launches bit
    for bit, and a dropped slab column is rejected by the same bound."""
    vals_h, cols_h, x_h = _ell_inputs(m, w, n, seed=m + w + off)

    def placed(host):
        flat = torch.zeros(host.size + off, dtype=torch.from_numpy(host).dtype,
                           device=cuda_device)
        flat[off:] = torch.from_numpy(host.ravel()).to(cuda_device)
        return flat[off:].view(host.shape)

    vals, cols = placed(vals_h), placed(cols_h)
    x = torch.from_numpy(x_h).to(cuda_device)
    got, again = sk.ell_spmv(vals, cols, x), sk.ell_spmv(vals, cols, x)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    y64, bound = sk.row_sum_bound(vals, cols, x)
    assert bool(((got.double() - y64).abs() <= bound).all())
    if w > 1:
        ctl = sk.ell_spmv_plain(vals[:, :-1].contiguous(),
                                cols[:, :-1].contiguous(), x)
        assert not bool(((ctl.double() - y64).abs() <= bound).all())
