"""The port's serving plane (tenzing_tpu_torch/serve/: resolver, service,
CLI) against the JAX package's (reference tests test_serve.py), test for
test, on the CPU: exact hits are zero-compile and verified, near misses
carry the surrogate's uncertainty and ``was_predicted`` and flag their entry,
cold requests become checkpointed work items; the unsound-entry guard, the
uncertainty gate, merge through the service, the CLI.  Then the same
requests through both packages, compared as JSON field by field (less
timings, trace ids and the digests, which the port's platform field
changes), and the recorded deviation: a record warmed by the reference, or
under the other platform, never answers exact in the port.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tenzing_tpu.bench import driver as ref_driver
from tenzing_tpu.serve import service as ref_service
from tenzing_tpu_torch.bench.benchmarker import BenchResult, result_row
from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of, schedule_key
from tenzing_tpu_torch.serve.resolver import Resolver
from tenzing_tpu_torch.serve.service import ScheduleService
from tenzing_tpu_torch.serve.store import ScheduleStore, WorkQueue

REQ = DriverRequest(workload="spmv", m=512)
NEAR_REQ = DriverRequest(workload="spmv", m=500)      # same bucket
COLD_REQ = DriverRequest(workload="spmv", m=100_000)  # different bucket


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


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A synthetic recorded-search database for the spmv/512 workload:
    row 0 the naive anchor at full fidelity, then distinct 2-lane
    schedules beating it — the dump format the warm path mines
    (bench.py --dump-csv invariants included)."""
    import itertools

    d = tmp_path_factory.mktemp("serve_corpus")
    g, _ = graph_for(REQ)
    naive = _drive(g, 1, [0])
    alts, seen = [], set()
    for picks in itertools.product((0, 1, 2), repeat=3):
        s = _drive(g, 2, list(picks))
        k = schedule_key(s)
        if k not in seen:
            seen.add(k)
            alts.append(s)
        if len(alts) >= 8:
            break
    rows = [result_row(0, BenchResult.from_times([2.0, 2.1, 2.05]), naive)]
    for i, a in enumerate(alts):
        t = 1.0 + 0.1 * i
        rows.append(result_row(
            i + 1, BenchResult.from_times([t, t * 1.02, t * 0.99]), a))
    path = d / "spmv_search.csv"
    path.write_text("\n".join(rows) + "\n")
    return {"csv": str(path), "graph": g, "naive": naive, "alts": alts}


@pytest.fixture(scope="module")
def warmed(tmp_path_factory, corpus):
    d = tmp_path_factory.mktemp("serve_state")
    svc = ScheduleService(str(d / "store.json"),
                          queue_dir=str(d / "queue"))
    summary = svc.warm(REQ, [corpus["csv"]], topk=2)
    return {"svc": svc, "summary": summary, "dir": d}


def test_warm_mines_topk_and_trains(warmed):
    s = warmed["summary"]
    assert s["added"] == 2
    assert s["rows"] >= 8
    model = s["model"]
    assert "error" not in model
    assert model["rows"] >= 8
    # the store is self-contained: model saved next to it
    assert os.path.exists(warmed["svc"].model_path)
    # provenance carries the source corpus digest
    rec = warmed["svc"].store.best(fingerprint_of(REQ).exact_digest)
    assert len(rec["sources"]) == 1 and len(rec["sources"][0]) == 64


def test_exact_hit_zero_compile_verified(warmed):
    res = warmed["svc"].query(REQ)
    assert res.tier == "exact"
    p = res.provenance
    assert p["verified"] is True
    assert p["was_predicted"] is False
    assert p["compiles"] == 0 and p["measurements"] == 0
    # the stored winner: best in-file paired ratio of the corpus
    assert res.vs_naive == pytest.approx(2.05, rel=0.02)
    assert res.sequence is not None and len(res.sequence) > 0
    # deterministic: the same request resolves identically
    again = warmed["svc"].query(REQ)
    assert again.record["key"] == res.record["key"]


def test_near_miss_predicted_flagged_and_queued(warmed):
    svc = warmed["svc"]
    res = svc.query(NEAR_REQ)
    assert res.tier == "near"
    p = res.provenance
    assert p["was_predicted"] is True
    assert p["uncertainty"] is not None and p["uncertainty"] >= 0
    assert p["compiles"] == 0 and p["measurements"] == 0
    assert res.vs_naive is not None  # the model's predicted paired ratio
    # the answering entry is flagged for refinement...
    rec = svc.store.best(fingerprint_of(REQ).exact_digest)
    assert rec["flags"].get("needs_refinement") is True
    # ...and the requested fingerprint is queued for a background search
    items = svc.queue.items()
    reasons = {i[1]["reason"] for i in items}
    assert "refine-near-miss" in reasons
    near_fp = fingerprint_of(NEAR_REQ)
    assert any(i[1]["fingerprint"]["exact"] == near_fp.exact_digest
               for i in items)


def test_cold_writes_checkpointed_work_item(warmed):
    from tenzing_tpu_torch.fault.checkpoint import read_checked_json

    svc = warmed["svc"]
    res = svc.query(COLD_REQ)
    assert res.tier == "cold"
    assert res.work_item is not None and os.path.exists(res.work_item)
    payload = read_checked_json(res.work_item)  # envelope digest verifies
    assert payload["kind"] == "search_request"
    assert payload["reason"] == "cold"
    # the payload IS a drainable DriverRequest; its checkpoint dir makes
    # the queued search itself kill-resumable
    drained = DriverRequest(**payload["request"])
    assert drained.workload == "spmv" and drained.m == 100_000
    assert payload["checkpoint"]


def test_uncertainty_gate_demotes_near_to_cold(warmed, tmp_path):
    svc = warmed["svc"]
    strict = Resolver(svc.store, queue=WorkQueue(str(tmp_path / "q")),
                      model=svc.model, near_max_sigma=0.0)
    res = strict.resolve(NEAR_REQ)
    assert res.tier == "cold"  # every prediction is too uncertain to serve


def test_without_model_near_demotes_to_cold(warmed, tmp_path):
    svc = warmed["svc"]
    unpriced = Resolver(svc.store, queue=WorkQueue(str(tmp_path / "q")),
                        model=None)
    assert unpriced.resolve(NEAR_REQ).tier == "cold"


def test_unsound_store_entry_flagged_not_served(corpus, tmp_path):
    """The re-verification guard: a stored schedule that fails the
    independent verifier (here: all its syncs stripped — racy by
    construction) must never be served, only flagged."""
    from tenzing_tpu_torch.core.sequence import Sequence
    from tenzing_tpu_torch.core.sync_ops import SyncOp

    g = corpus["graph"]
    winner = corpus["alts"][0]
    stripped = Sequence([op for op in winner if not isinstance(op, SyncOp)])
    store = ScheduleStore(str(tmp_path / "store.json"))
    store.add(fingerprint_of(REQ), stripped, pct50_us=1.0, vs_naive=99.0)
    r = Resolver(store, queue=WorkQueue(str(tmp_path / "q")))
    res = r.resolve(REQ)
    assert res.tier == "cold"  # not served
    rec = store.best(fingerprint_of(REQ).exact_digest)
    assert rec["flags"].get("unsound") is True


def test_unsound_best_does_not_block_sound_runner_up(corpus, tmp_path):
    """The exact tier walks records best-first: an unsound best record
    (here vs_naive 99 with its syncs stripped) must not permanently
    demote a fingerprint with a sound runner-up to cold — the near tier
    excludes the requester's own digest, so exact is the only tier that
    can serve it."""
    from tenzing_tpu_torch.core.sequence import Sequence
    from tenzing_tpu_torch.core.sync_ops import SyncOp

    winner = corpus["alts"][0]
    stripped = Sequence([op for op in winner if not isinstance(op, SyncOp)])
    store = ScheduleStore(str(tmp_path / "store.json"))
    fp = fingerprint_of(REQ)
    store.add(fp, stripped, pct50_us=1.0, vs_naive=99.0)   # poisoned best
    store.add(fp, corpus["alts"][1], pct50_us=2.0, vs_naive=1.4)  # sound
    r = Resolver(store, queue=WorkQueue(str(tmp_path / "q")))
    res = r.resolve(REQ)
    assert res.tier == "exact"
    assert res.vs_naive == 1.4  # the sound runner-up, not the poisoned 99
    assert res.provenance["verified"] is True
    bad = [rec for rec in store.records() if rec["vs_naive"] == 99.0][0]
    assert bad["flags"].get("unsound") is True


def test_merge_through_service_is_lossless(corpus, tmp_path):
    a = ScheduleService(str(tmp_path / "a.json"))
    b = ScheduleService(str(tmp_path / "b.json"))
    a.warm(REQ, [corpus["csv"]], topk=1, train=False)
    b.warm(DriverRequest(workload="spmv", m=700), [corpus["csv"]],
           topk=1, train=False)
    out = a.merge(str(tmp_path / "b.json"))
    assert out["records"] == 2
    stats = a.stats()["store"]
    assert stats["fingerprints"] == 2 and stats["records"] == 2


def test_warm_into_missing_nested_directory(corpus, tmp_path):
    """The CLI promises the store is created on first flush: warming
    into a not-yet-existing directory must create it for the store,
    the model, and (on first enqueue) the queue."""
    d = tmp_path / "fleet" / "stores"
    svc = ScheduleService(str(d / "store.json"),
                          queue_dir=str(d / "queue"))
    s = svc.warm(REQ, [corpus["csv"]], topk=1)
    assert s["added"] == 1 and "error" not in s["model"]
    assert os.path.exists(d / "store.json")
    assert os.path.exists(svc.model_path)


def test_serve_counters_land(warmed):
    from tenzing_tpu_torch.obs.metrics import get_metrics

    reg = get_metrics()
    # the tier counters observed by the queries above (exact-hit test ran
    # two exact queries; near/cold at least one each)
    assert reg.counter("serve.exact").value >= 2
    assert reg.counter("serve.near").value >= 1
    assert reg.counter("serve.cold").value >= 1


def test_cli_query_round_trip(warmed):
    """The ``python -m tenzing_tpu_torch.serve`` CLI answers the same exact
    hit the in-process service does, as one JSON line on stdout."""
    repo = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=repo)
    r = subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.serve", "query",
         "--store", str(warmed["dir"] / "store.json"),
         "--queue", str(warmed["dir"] / "queue"),
         "--workload", "spmv", "--m", "512"],
        capture_output=True, text=True, env=env, cwd=repo, check=True,
        timeout=120)
    doc = json.loads(r.stdout.strip())
    assert doc["tier"] == "exact"
    assert doc["provenance"]["verified"] is True
    assert doc["provenance"]["compiles"] == 0
    assert doc["ops"], "the answer carries the serialized schedule"


# -- the same requests through both packages ----------------------------------

_PER_REQUEST = ("phase_us", "trace_id")


def _body(doc):
    """A response less timings, trace id and digests; the fingerprint less
    its platform (held separately)."""
    out = {k: v for k, v in doc.items() if k not in _PER_REQUEST}
    fp = dict(out.pop("fingerprint"))
    for k in ("exact", "bucket_digest", "platform"):
        fp.pop(k, None)
    out["fingerprint"] = fp
    prov = dict(out.get("provenance", {}))
    prov.pop("source_exact", None)
    out["provenance"] = prov
    out.pop("work_item", None)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory, corpus):
    """The reference's service and the port's (platform ``cpu``), each
    warmed from the same database."""
    d = tmp_path_factory.mktemp("serve_both")
    ref = ref_service.ScheduleService(str(d / "ref.json"),
                                      queue_dir=str(d / "ref_q"))
    port = ScheduleService(str(d / "port.json"), queue_dir=str(d / "port_q"),
                           platform="cpu")
    return {"ref": ref, "port": port, "dir": d,
            "ref_summary": ref.warm(ref_driver.DriverRequest(workload="spmv",
                                                             m=512),
                                    [corpus["csv"]], topk=2),
            "port_summary": port.warm(REQ, [corpus["csv"]], topk=2)}


def test_warm_summaries_agree(both):
    """Files, rows, candidates, admissions and the model's training rows
    agree; the model's in-sample Spearman does not have to, because the
    port's features price the makespan with the card's constants
    (learn/features.py ``ModelEnv``), the reference's with the TPU's."""
    a, b = dict(both["port_summary"]), dict(both["ref_summary"])
    for s in (a, b):
        s.pop("exact"), s.pop("bucket")
        s["model"] = s["model"]["rows"]
    assert a == b


@pytest.mark.parametrize("kw", [dict(workload="spmv", m=512),
                                dict(workload="spmv", m=500),
                                dict(workload="spmv", m=100_000)],
                         ids=["exact", "near", "cold"])
def test_responses_agree_field_by_field(both, kw):
    port = both["port"].query(DriverRequest(**kw)).to_json()
    ref = both["ref"].query(ref_driver.DriverRequest(**kw)).to_json()
    assert port["fingerprint"]["platform"] == "cpu"
    a, b = _body(port), _body(ref)
    if a["tier"] == "near":
        # the same neighbour answers, priced by each package's surrogate
        # (features on the card's constants in the port): the prediction
        # and its spread are each package's own
        for doc in (a, b):
            assert doc.pop("vs_naive") > 0
            assert doc["provenance"].pop("uncertainty") >= 0
    assert a == b
    if a["tier"] == "cold":
        from tenzing_tpu.fault.checkpoint import read_checked_json as ref_read
        from tenzing_tpu_torch.fault.checkpoint import read_checked_json

        pi, ri = read_checked_json(port["work_item"]), ref_read(
            ref["work_item"])
        assert pi["request"] == ri["request"]
        assert pi["reason"] == ri["reason"] == "cold"
        assert os.path.basename(pi["checkpoint"]) == \
            f"ckpt-{port['fingerprint']['exact']}"


def test_reference_warmed_record_never_answers_exact(both):
    """The reference's fingerprint has no platform: a store it warmed (on a
    TPU, or as here on the CPU) holds records under digests no port
    fingerprint has, so the port answers cold, on either platform, and
    queues the request for its own measurement."""
    ref_path = both["ref"].store.path
    assert both["ref"].query(ref_driver.DriverRequest(
        workload="spmv", m=512)).tier == "exact"
    for platform in ("cuda", "cpu"):
        svc = ScheduleService(ref_path, queue_dir=str(
            both["dir"] / f"q_{platform}"), platform=platform,
            model_path=both["ref"].model_path)
        assert len(svc.store) == 2
        res = svc.query(REQ)
        assert res.tier == "cold", res.to_json()
        assert res.provenance["measurements"] == 0


def test_record_of_another_platform_never_answers_exact(both):
    """A store warmed under ``cpu`` answers exact for ``cpu`` and cold for
    ``cuda`` (a CPU run's pct50 is never served as the card's)."""
    path = both["port"].store.path
    cpu = ScheduleService(path, queue_dir=str(both["dir"] / "qc"),
                          platform="cpu")
    cuda = ScheduleService(path, queue_dir=str(both["dir"] / "qg"),
                           platform="cuda")
    assert cpu.query(REQ).tier == "exact"
    assert cuda.query(REQ).tier == "cold"
    assert cuda.query(NEAR_REQ).tier == "cold"  # no neighbour either


def test_resolver_opens_no_cuda_context(corpus, tmp_path):
    """Exact, near and cold resolutions of the full-width halo request on
    the ``cuda`` platform build no executor and leave CUDA uninitialized."""
    import torch

    from tenzing_tpu_torch.bench.driver import graph_for as gf

    req = DriverRequest()  # full-width halo: the driver's default
    g, _ = gf(req)
    naive = _drive(g, 1, [0])
    alts = [_drive(g, 8, list(p)) for p in ([1, 0, 2], [2, 1, 0], [0, 2, 1])]
    rows = [result_row(0, BenchResult.from_times([2.0, 2.1, 2.05]), naive)]
    rows += [result_row(i + 1, BenchResult.from_times([1.0 + 0.1 * i] * 3), a)
             for i, a in enumerate(alts)]
    db = tmp_path / "halo.csv"
    db.write_text("\n".join(rows) + "\n")
    svc = ScheduleService(str(tmp_path / "s.json"),
                          queue_dir=str(tmp_path / "q"))
    s = svc.warm(req, [str(db)], topk=3)
    assert s["added"] >= 1 and "error" not in s["model"]
    assert svc.query(req).tier == "exact"
    near = svc.query(DriverRequest(halo_n=500))
    assert near.tier in ("near", "cold")
    assert svc.query(DriverRequest(halo_n=1024)).tier == "cold"
    assert not torch.cuda.is_initialized()


def test_cli_warm_requires_the_platform(corpus, tmp_path, capsys):
    """A recorded database names no device, so ``serve warm`` has no
    default platform: without ``--platform`` it exits with a usage error
    and stores nothing; with it, the records sit under that platform."""
    from tenzing_tpu_torch.serve import __main__ as cli

    store = str(tmp_path / "s.json")
    argv = ["warm", "--store", store, "--workload", "spmv", "--m", "512",
            "--csv", corpus["csv"], "--no-train"]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert "--platform" in capsys.readouterr().err
    assert not os.path.exists(store)
    assert cli.main(argv + ["--platform", "cpu"]) == 0
    recs = ScheduleStore(store).records()
    assert recs and {r["fingerprint"]["platform"] for r in recs} == {"cpu"}


def test_warm_refuses_a_driver_json_of_another_platform(corpus, tmp_path):
    """A driver JSON given with the database that names a CPU run refuses a
    ``cuda`` warm before anything is stored; under ``cpu`` it is accepted
    and its device becomes the records' provenance ``device``."""
    from tenzing_tpu_torch.bench.driver import metric_for

    verdict = tmp_path / "verdict.json"
    verdict.write_text(json.dumps({
        "metric": metric_for("spmv", REQ), "value": 1.0, "unit": "us",
        "vs_baseline": 2.0, "device": {"type": "cpu", "name": "cpu"}}))
    cuda = ScheduleService(str(tmp_path / "g.json"), platform="cuda")
    with pytest.raises(ValueError, match="cannot warm cuda records"):
        cuda.warm(REQ, [corpus["csv"]], bench_globs=[str(verdict)],
                  topk=2, train=False)
    assert len(cuda.store) == 0 and not os.path.exists(cuda.store.path)
    cpu = ScheduleService(str(tmp_path / "c.json"), platform="cpu")
    s = cpu.warm(REQ, [corpus["csv"]], bench_globs=[str(verdict)], topk=2,
                 train=False)
    assert s["added"] == 2 and s["driver_provenance"]["matched"] == 1
    assert {r["provenance"]["device"] for r in cpu.store.records()} == {"cpu"}
