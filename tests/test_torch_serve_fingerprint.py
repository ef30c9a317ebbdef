"""The port's workload fingerprints (tenzing_tpu_torch/serve/fingerprint.py)
against the JAX package's (tenzing_tpu/serve/fingerprint.py; reference tests
test_serve_fingerprint.py), test for test, plus the recorded deviation
(ROADMAP Queue 3 item 19): the port's fingerprint carries the platform its
records are for.  Less that field its digests are the reference's, for every
workload at smoke and full width; a ``cpu`` and a ``cuda`` fingerprint of
one request differ.  Also ``graph_for`` (bench/driver.py), the device-free
graph the serving plane resolves against, held op for op and menu for menu
against the graph the driver searches.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tenzing_tpu.bench import driver as ref_driver
from tenzing_tpu.serve import fingerprint as ref_fp
from tenzing_tpu_torch.bench import driver
from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
from tenzing_tpu_torch.core.graph import get_equivalence
from tenzing_tpu_torch.core.operation import ChoiceOp, CompoundOp
from tenzing_tpu_torch.obs.tracer import short_digest
from tenzing_tpu_torch.serve.fingerprint import (
    WorkloadFingerprint,
    _canonical,
    fingerprint_of,
    schedule_key,
    shape_bucket,
)

REPO = str(Path(__file__).resolve().parents[1])

# golden bucket boundaries: 2^k stays, 2^k + 1 rounds up (the reference's)
BUCKET_GOLDENS = [
    (0, 0), (-3, 0), (1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
    (7, 8), (8, 8), (9, 16), (300, 512), (511, 512), (512, 512),
    (513, 1024), (1024, 1024), (1025, 2048), (150_000, 262_144),
]

# every workload at smoke and full width (spmv also at the card's --m 8192)
REQUESTS = [
    dict(workload=w, smoke=s) for w in ("halo", "spmv", "attn", "moe")
    for s in (True, False)
] + [dict(workload="spmv", m=8192), dict(workload="spmv", m=512, lanes=4),
     dict(workload="halo", halo_n=256), dict(workload="moe", moe_tokens=4096)]


def _ids(reqs):
    return ["-".join(f"{k}={v}" for k, v in r.items()) for r in reqs]


def test_bucket_goldens():
    for n, want in BUCKET_GOLDENS:
        assert shape_bucket(n) == want == ref_fp.shape_bucket(n), n


def test_bucket_is_idempotent():
    for n in (1, 2, 4, 64, 512, 4096):
        assert shape_bucket(shape_bucket(n)) == shape_bucket(n)


def test_field_order_cannot_leak_into_digest():
    a = WorkloadFingerprint(
        workload="spmv", variant="full",
        shape=(("bw", 0), ("m", 512), ("nnz_per_row", 10)),
        bucket=(("bw", 0), ("m", 512), ("nnz_per_row", 16)),
        mesh=(("lanes", 2),),
        engines=(("ici", ("a", "b")), ("pcie", ("c",))),
        platform="cuda",
    )
    b = WorkloadFingerprint.from_json(a.to_json())
    assert a == b
    assert a.exact_digest == b.exact_digest
    assert a.bucket_digest == b.bucket_digest


def test_digest_stable_across_process_restarts():
    """Byte-identical digests under different PYTHONHASHSEEDs, in fresh
    interpreters, and equal to this process's."""
    prog = (
        "from tenzing_tpu_torch.bench.driver import DriverRequest\n"
        "from tenzing_tpu_torch.serve.fingerprint import fingerprint_of\n"
        "f = fingerprint_of(DriverRequest(workload='spmv', m=512))\n"
        "import sys\n"
        "sys.stdout.write(f.exact_digest + ' ' + f.bucket_digest)\n"
    )
    outs = set()
    for seed in ("0", "1", "31337"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=REPO)
        r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                           text=True, env=env, cwd=REPO, check=True,
                           timeout=120)
        outs.add(r.stdout.strip())
    assert len(outs) == 1, outs
    f = fingerprint_of(DriverRequest(workload="spmv", m=512))
    assert outs.pop() == f"{f.exact_digest} {f.bucket_digest}"


def test_exact_vs_bucket_relationships():
    base = fingerprint_of(DriverRequest(workload="spmv", m=512))
    near = fingerprint_of(DriverRequest(workload="spmv", m=500))
    far = fingerprint_of(DriverRequest(workload="spmv", m=100_000))
    assert base.exact_digest != near.exact_digest
    assert base.bucket_digest == near.bucket_digest
    assert base.bucket_digest != far.bucket_digest
    assert fingerprint_of(DriverRequest(workload="halo")).exact_digest \
        != base.exact_digest
    assert fingerprint_of(
        DriverRequest(workload="spmv", m=512, smoke=True)).exact_digest \
        != base.exact_digest
    assert fingerprint_of(
        DriverRequest(workload="spmv", m=512, lanes=4)).exact_digest \
        != base.exact_digest


def test_fingerprint_json_roundtrip_carries_digests():
    f = fingerprint_of(DriverRequest(workload="attn", smoke=True),
                       platform="cpu")
    j = f.to_json()
    assert j["exact"] == f.exact_digest
    assert j["bucket_digest"] == f.bucket_digest
    assert j["platform"] == "cpu"
    assert WorkloadFingerprint.from_json(
        json.loads(json.dumps(j))).exact_digest == f.exact_digest


@pytest.fixture(scope="module")
def spmv_graph():
    g, _ = graph_for(DriverRequest(workload="spmv", m=512))
    return g


def _drive(g, n_lanes, picks):
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.core.state import State

    plat = Platform.make_n_lanes(n_lanes)
    st = State(g)
    i = 0
    while not st.is_terminal():
        ds = st.get_decisions(plat)
        st = st.apply(ds[picks[i % len(picks)] % len(ds)])
        i += 1
    return st.sequence


def test_schedule_key_matches_canonical_equivalence(spmv_graph):
    a = _drive(spmv_graph, 2, [1, 2, 0])
    b = _drive(spmv_graph, 2, [1, 2, 0])
    c = _drive(spmv_graph, 2, [2, 1, 0])
    assert schedule_key(a) == schedule_key(b)
    assert schedule_key(a) != schedule_key(c)
    from tenzing_tpu_torch.core.schedule import remove_redundant_syncs

    assert schedule_key(a) == schedule_key(remove_redundant_syncs(a))


# -- parity with the reference, and the platform deviation ---------------------

@pytest.mark.parametrize("kw", REQUESTS, ids=_ids(REQUESTS))
def test_digests_equal_the_references_less_the_platform(kw):
    """With ``platform`` removed from the canonical document, both digests
    are the reference's for the same request; the JSON document is the
    reference's plus ``platform``; shape and lanes are the reference's."""
    ref = ref_fp.fingerprint_of(ref_driver.DriverRequest(**kw))
    for platform in ("cuda", "cpu"):
        f = fingerprint_of(DriverRequest(**kw), platform=platform)
        for digest, field in ((ref.exact_digest, f.shape),
                              (ref.bucket_digest, f.bucket)):
            doc = f.digest_doc(field)
            assert doc.pop("platform") == platform
            assert short_digest(_canonical(doc)) == digest
        j, rj = f.to_json(), ref.to_json()
        for k in ("exact", "bucket_digest"):
            j.pop(k), rj.pop(k)
        assert j.pop("platform") == platform
        assert j == rj
    assert driver.workload_shape(DriverRequest(**kw)) == \
        ref_driver.workload_shape(ref_driver.DriverRequest(**kw))


@pytest.mark.parametrize("kw", REQUESTS, ids=_ids(REQUESTS))
def test_platforms_partition_the_key_space(kw):
    """A record measured on the CPU (or by the reference, whose key has no
    platform) never shares an exact or bucket digest with the card's."""
    cuda = fingerprint_of(DriverRequest(**kw), platform="cuda")
    cpu = fingerprint_of(DriverRequest(**kw), platform="cpu")
    ref = ref_fp.fingerprint_of(ref_driver.DriverRequest(**kw))
    assert len({cuda.exact_digest, cpu.exact_digest, ref.exact_digest}) == 3
    assert len({cuda.bucket_digest, cpu.bucket_digest,
                ref.bucket_digest}) == 3
    assert fingerprint_of(DriverRequest(**kw)) == cuda  # the default
    with pytest.raises(ValueError, match="platform"):
        fingerprint_of(DriverRequest(**kw), platform="tpu")


def test_engine_kinds_are_the_references():
    from tenzing_tpu.bench.model import ICI_KINDS as REF_ICI
    from tenzing_tpu.bench.model import PCIE_KINDS as REF_PCIE
    from tenzing_tpu_torch.ops.comm_ops import ICI_KINDS, PCIE_KINDS

    assert tuple(ICI_KINDS) == tuple(REF_ICI)
    assert tuple(PCIE_KINDS) == tuple(REF_PCIE)
    f = fingerprint_of(DriverRequest(workload="halo"))
    assert dict(f.engines) == {"ici": tuple(REF_ICI), "pcie": tuple(REF_PCIE)}


def test_fingerprinting_opens_no_device():
    """Fingerprints and device-free graphs of every workload leave CUDA
    uninitialized (they run on hosts with no card)."""
    for kw in REQUESTS:
        fingerprint_of(DriverRequest(**kw))
    graph_for(DriverRequest(workload="halo"))
    assert not torch.cuda.is_initialized()


def test_schedule_key_equals_the_references(spmv_graph):
    """The same schedule keys one store slot in both packages, so stores
    written by either merge slot for slot."""
    from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
    from tenzing_tpu_torch.core.serdes import sequence_to_json

    ref_g, _ = ref_driver.graph_for(ref_driver.DriverRequest(workload="spmv",
                                                             m=512))
    for picks in ([0], [1, 2, 0], [2, 1, 0], [1, 0, 2]):
        seq = _drive(spmv_graph, 2, picks)
        ref_seq = ref_from_json(json.loads(json.dumps(sequence_to_json(seq))),
                                ref_g)
        assert schedule_key(seq) == ref_fp.schedule_key(ref_seq)


# -- graph_for against the graph the driver searches --------------------------

def _describe(op):
    """An op as its name, kind and (recursively) its menu or sub-graph."""
    out = [type(op).__name__, op.name()]
    if isinstance(op, ChoiceOp):
        out.append(sorted((_describe(c) for c in op.choices()), key=repr))
    if isinstance(op, CompoundOp):
        out.append(_describe_graph(op.graph()))
    return out


def _describe_graph(g):
    verts = sorted((_describe(v) for v in g.vertices()), key=repr)
    edges = sorted((a.name(), b.name()) for a in g.vertices()
                   for b in g.succs(a))
    return [verts, edges]


_BUILDERS = {"halo": driver.build_halo, "spmv": driver.build_spmv,
             "attn": driver.build_attn, "moe": driver.build_moe}
# full width where building the driver's buffers on the CPU is cheap (halo's
# 2 GB grid and moe's float64 expected Y are not)
GRAPH_CASES = [dict(workload=w, smoke=True)
               for w in ("halo", "spmv", "attn", "moe")] + [
    dict(workload="spmv"), dict(workload="spmv", m=8192),
    dict(workload="spmv", m=8192, synth_collectives=True),
    dict(workload="attn"), dict(workload="attn", smoke=True, chunk=True),
    dict(workload="moe", smoke=True, chunk=True)]


@pytest.mark.parametrize("kw", GRAPH_CASES, ids=_ids(GRAPH_CASES))
def test_graph_for_is_the_graph_run_searches(kw):
    req = DriverRequest(**kw)
    g, nbytes = graph_for(req)
    want, bufs, _, _ = _BUILDERS[req.workload](req, torch.device("cpu"))
    assert get_equivalence(g, want)
    assert _describe_graph(g) == _describe_graph(want)
    # the buffer sizes the surrogate features read are the placed buffers'
    # (what the driver's --learn-* flags feed it)
    assert nbytes == {k: int(v.nbytes) for k, v in bufs.items()}


def test_graph_for_full_halo_and_moe_without_buffers():
    """Full-width halo: the graph build_halo searches, and an empty size map
    (the reference's: its grid is not built); full-width moe: the staging
    and expert menus of build_moe's graph."""
    from tenzing_tpu_torch.models.halo import HaloArgs
    from tenzing_tpu_torch.models.halo_pipeline import build_graph

    g, nbytes = graph_for(DriverRequest())
    want = build_graph(HaloArgs(nq=3, lx=512, ly=512, lz=512, radius=3),
                       impl_choice=True, xfer_choice=True)
    assert nbytes == {} and get_equivalence(g, want)
    assert _describe_graph(g) == _describe_graph(want)
    ref_g, ref_nb = ref_driver.graph_for(ref_driver.DriverRequest())
    assert ref_nb == {}
    assert sorted(v.name() for v in g.vertices()) == \
        sorted(v.name() for v in ref_g.vertices())

    from tenzing_tpu_torch.models.moe_pipeline import (
        build_graph as moe_graph,
        make_pipe_buffers,
    )

    req = DriverRequest(workload="moe")
    g, nbytes = graph_for(req)
    margs = driver.moe_args(req)
    bufs, _, cap = make_pipe_buffers(margs, seed=0, with_expected=False,
                                     staging="choice")
    want = moe_graph(margs, cap, impl_choice=True, staging="choice")
    assert _describe_graph(g) == _describe_graph(want)
    # the bf16 staging buffers (ZerosSpec here) count their 2-byte elements
    ref_g, ref_nb = ref_driver.graph_for(ref_driver.DriverRequest(
        workload="moe"))
    assert nbytes == ref_nb
