"""The port's listen loop (tenzing_tpu_torch/serve/listen.py) against the JAX
package's (tenzing_tpu/serve/listen.py; reference tests
test_serve_listen.py), test for test: exact hits from the sealed cache with
no verifier call, an unstamped record verified once, an unsound one never
served, shedding at the bounded queue with ``retry_after``, busy-poll
workers, the watchdog, the graceful drain and its status document, the
batch and malformed ops, the socket transport, trace contexts and phases,
the ``metrics`` verb with its SLO block, tenant histograms and admission
caps.  Then: exact hits after the first go through
``Resolver.resolve_fast``, ``--record`` writes one record per admitted
request, the CLI over stdin, and the same transcript (ping, query, batch, a
malformed op, a shed) answers the same in both packages, less timings and
the platform.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of, schedule_key
from tenzing_tpu_torch.serve.listen import ListenOpts, ServeLoop
from tenzing_tpu_torch.serve.resolver import Resolver
from tenzing_tpu_torch.serve.service import ScheduleService
from tenzing_tpu_torch.serve.store import ScheduleStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQ = DriverRequest(workload="spmv", m=512)
REQ_KW = {"workload": "spmv", "m": 512}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A recorded database of spmv/512: row 0 the naive anchor, then
    distinct 2-lane schedules that beat it."""
    import itertools

    from tenzing_tpu_torch.bench.benchmarker import BenchResult, result_row
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.core.state import State

    d = tmp_path_factory.mktemp("listen_corpus")
    g, _ = graph_for(REQ)

    def drive(n_lanes, picks):
        plat = Platform.make_n_lanes(n_lanes)
        st = State(g)
        i = 0
        while not st.is_terminal():
            ds = st.get_decisions(plat)
            st = st.apply(ds[picks[i % len(picks)] % len(ds)])
            i += 1
        return st.sequence

    naive = drive(1, [0])
    alts, seen = [], set()
    for picks in itertools.product((0, 1, 2), repeat=3):
        s = drive(2, list(picks))
        k = schedule_key(s)
        if k not in seen:
            seen.add(k)
            alts.append(s)
        if len(alts) >= 6:
            break
    rows = [result_row(0, BenchResult.from_times([2.0, 2.1, 2.05]), naive)]
    for i, a in enumerate(alts):
        t = 1.0 + 0.1 * i
        rows.append(result_row(
            i + 1, BenchResult.from_times([t, t * 1.02, t * 0.99]), a))
    path = d / "spmv_search.csv"
    path.write_text("\n".join(rows) + "\n")
    return {"csv": str(path), "graph": g, "alts": alts}


@pytest.fixture()
def warmed(tmp_path, corpus):
    """A freshly warmed segmented service per test."""
    svc = ScheduleService(str(tmp_path / "store"),
                          queue_dir=str(tmp_path / "queue"))
    summary = svc.warm(REQ, [corpus["csv"]], topk=2, train=False)
    assert summary["added"] == 2
    assert summary["admission"] == {"verified": 2, "rejected_unsound": 0}
    return svc


def _opts(tmp_path, **kw):
    kw.setdefault("handle_signals", False)
    kw.setdefault("status_path", str(tmp_path / "status.json"))
    return ListenOpts(**kw)


# -- admission-time verification and the exact cache ------------------------------

def test_exact_hit_zero_verifier_calls_then_cache(warmed):
    fallback0 = get_metrics().counter("serve.verify_fallback").value
    r1 = warmed.query(REQ)
    assert r1.tier == "exact"
    p = r1.provenance
    assert p["verified"] is True and p["verified_at_admission"] is True
    assert p["verifier_calls"] == 0 and p["cache_hit"] is False
    assert p["compiles"] == 0 and p["measurements"] == 0
    r2 = warmed.query(REQ)
    assert r2.provenance["cache_hit"] is True
    assert r2.sequence is r1.sequence
    assert get_metrics().counter("serve.verify_fallback").value == fallback0


def test_unstamped_record_lazy_verifies_exactly_once(tmp_path, corpus):
    store = ScheduleStore(str(tmp_path / "legacy.json"))
    store.add(fingerprint_of(REQ), corpus["alts"][0], pct50_us=10.0,
              vs_naive=2.0)  # no stamp
    resolver = Resolver(store, graph_builder=lambda r: (corpus["graph"], {}))
    fallback0 = get_metrics().counter("serve.verify_fallback").value
    r1 = resolver.resolve(REQ)
    assert r1.tier == "exact"
    assert r1.provenance["verifier_calls"] == 1
    assert r1.provenance["verified_at_admission"] is False
    assert resolver.resolve(REQ).provenance["cache_hit"] is True
    assert get_metrics().counter(
        "serve.verify_fallback").value == fallback0 + 1


def test_store_mutation_invalidates_exact_cache(warmed, corpus):
    r1 = warmed.query(REQ)
    assert warmed.query(REQ).provenance["cache_hit"] is True
    warmed.store.add(fingerprint_of(REQ), corpus["alts"][-1], pct50_us=0.5,
                     vs_naive=9.0, verified=True)
    r3 = warmed.query(REQ)
    assert r3.provenance["cache_hit"] is False
    assert r3.vs_naive == 9.0 and r1.vs_naive != 9.0


def test_flagging_served_record_invalidates_exact_cache(warmed):
    r1 = warmed.query(REQ)
    assert r1.tier == "exact"
    assert warmed.query(REQ).provenance["cache_hit"] is True
    warmed.store.flag(r1.record["exact"], r1.record["key"], unsound=True)
    r2 = warmed.query(REQ)
    assert r2.tier == "exact"
    assert r2.record["key"] != r1.record["key"]


def test_unsound_at_admission_stored_flagged_never_served(tmp_path, corpus):
    svc = ScheduleService(str(tmp_path / "store"),
                          queue_dir=str(tmp_path / "queue"))
    fp = fingerprint_of(REQ)
    svc.store.add(fp, corpus["alts"][0], pct50_us=1.0, vs_naive=9.0,
                  verified=False)
    svc.store.add(fp, corpus["alts"][1], pct50_us=2.0, vs_naive=1.5,
                  verified=True)
    svc.store.flush()
    fallback0 = get_metrics().counter("serve.verify_fallback").value
    res = svc.query(REQ)
    assert res.tier == "exact" and res.vs_naive == 1.5
    assert res.provenance["verifier_calls"] == 0
    assert get_metrics().counter("serve.verify_fallback").value == fallback0
    assert svc.store.stats()["admission"]["unsound"] == 1


def test_cache_put_represent_key_updates_in_place(corpus):
    r = Resolver(ScheduleStore(None))
    r.cache_cap = 3
    cache = {}
    for k in ("a", "b", "c"):
        r._cache_put(cache, k, k.upper())
    r._cache_put(cache, "b", "B2")  # at the cap: in place
    assert cache == {"a": "A", "b": "B2", "c": "C"}
    r._cache_put(cache, "d", "D")
    assert list(cache) == ["b", "c", "d"]


# -- the serve loop ------------------------------------------------------------------

class _StubService:
    """A service whose latency the tests set."""

    def __init__(self, delay=0.0):
        self.delay = delay
        self.store = ScheduleStore(None)
        self.calls = 0

    def query(self, req):
        from tenzing_tpu_torch.serve.resolver import Resolution

        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        return Resolution(tier="exact", fingerprint=fingerprint_of(REQ),
                          provenance={"stub": True})

    def stats(self):
        return {"stub": True}


def _collect():
    docs, lock = [], threading.Lock()

    def respond(doc):
        with lock:
            docs.append(doc)

    return docs, respond


def _query(i, **kw):
    return {"op": "query", "id": i, "request": dict(REQ_KW), **kw}


def test_bounded_queue_sheds_with_retry_after(tmp_path):
    svc = _StubService(delay=0.4)
    loop = ServeLoop(svc, _opts(tmp_path, max_pending=1, workers=1,
                                request_timeout_secs=30.0,
                                shed_retry_after_secs=0.125))
    shed0 = get_metrics().counter("serve.shed").value
    loop.start()
    docs, respond = _collect()
    for i in range(4):
        loop.submit(_query(i), respond)
    loop.drain(timeout=10.0)
    shed = [d for d in docs if d.get("shed")]
    assert len(docs) == 4 and shed
    assert all(d["retry_after"] == 0.125 for d in shed)
    assert all(d["error_class"] == "transient" for d in shed)
    assert sum(1 for d in docs if d.get("ok")) + len(shed) == 4
    assert loop.counters["shed"] == len(shed)
    assert get_metrics().counter("serve.shed").value == shed0 + len(shed)


def test_busy_poll_workers_drain_correctly(tmp_path):
    svc = _StubService()
    loop = ServeLoop(svc, _opts(tmp_path, max_pending=32, workers=2,
                                request_timeout_secs=30.0,
                                busy_poll_us=200.0))
    loop.start()
    docs, respond = _collect()
    for i in range(12):
        loop.submit(_query(i), respond)
    assert loop.drain(timeout=10.0) is True
    assert sorted(d["id"] for d in docs if d.get("ok")) == list(range(12))
    assert svc.calls == 12


def test_watchdog_times_out_stuck_request(tmp_path):
    svc = _StubService(delay=1.0)
    loop = ServeLoop(svc, _opts(tmp_path, max_pending=4, workers=1,
                                request_timeout_secs=0.2))
    loop.start()
    docs, respond = _collect()
    loop.submit(_query(1), respond)
    t0 = time.time()
    while not docs and time.time() - t0 < 5.0:
        time.sleep(0.02)
    assert docs, "the watchdog never answered"
    assert docs[0]["timed_out"] is True
    assert docs[0]["error_class"] == "transient"
    assert time.time() - t0 < 0.9  # before the worker finished
    loop.drain(timeout=10.0)
    assert len(docs) == 1  # the late result was dropped
    assert loop.counters["timeouts"] == 1


def test_graceful_drain_answers_queued_and_stamps_status(tmp_path):
    svc = _StubService(delay=0.05)
    loop = ServeLoop(svc, _opts(tmp_path, max_pending=16, workers=2,
                                request_timeout_secs=30.0))
    loop.start()
    docs, respond = _collect()
    for i in range(6):
        loop.submit(_query(i), respond)
    loop.stop()
    loop.submit(_query(99), respond)  # intake stopped: shed "draining"
    assert loop.drain(timeout=10.0) is True
    assert len(docs) == 7
    assert sum(1 for d in docs if d.get("ok")) == 6
    assert [d for d in docs if d.get("shed")][0]["reason"] == "draining"
    st = json.load(open(tmp_path / "status.json"))
    assert st["kind"] == "serve_loop" and st["state"] == "stopped"
    assert st["counters"]["requests"] == 7


def test_batch_and_malformed_ops(warmed, tmp_path):
    loop = ServeLoop(warmed, _opts(tmp_path, max_pending=8, workers=1,
                                   request_timeout_secs=60.0))
    loop.start()
    docs, respond = _collect()
    loop.submit({"op": "batch", "id": 1, "requests": [
        dict(REQ_KW), {"request": dict(REQ_KW)}]}, respond)
    loop.submit({"op": "nope", "id": 2}, respond)
    loop.drain(timeout=30.0)
    by_id = {d.get("id"): d for d in docs}
    assert len(by_id[1]["results"]) == 2
    assert by_id[1]["results"][0]["tier"] == "exact"
    assert by_id[1]["results"][1]["provenance"]["cache_hit"] is True
    assert "resolve_us" in by_id[1]["results"][0]
    assert by_id[2]["ok"] is False
    assert by_id[2]["error_class"] == "deterministic"
    assert loop.counters["batches"] == 1 and loop.counters["malformed"] == 1


def _short_socket_path():
    """A socket path well under the 108-byte limit of ``sun_path``."""
    d = tempfile.mkdtemp(prefix="tzs")
    path = os.path.join(d, "s.sock")
    if len(path) > 100:
        path = os.path.relpath(path)
    assert len(path) <= 100, path
    return d, path


def test_socket_transport_round_trip(warmed, tmp_path):
    d, sock_path = _short_socket_path()
    loop = ServeLoop(warmed, _opts(tmp_path, max_pending=8, workers=1,
                                   request_timeout_secs=60.0,
                                   socket_path=sock_path))
    result = {}

    def run():
        result["summary"] = loop.serve_socket(sock_path)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        deadline = time.time() + 10
        while not os.path.exists(sock_path) and time.time() < deadline:
            time.sleep(0.02)
        cli = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        cli.settimeout(60.0)
        cli.connect(sock_path)
        cli.sendall((json.dumps(_query(7)) + "\n"
                     + json.dumps({"op": "ping", "id": 8}) + "\n").encode())
        buf = b""
        while buf.count(b"\n") < 2:
            chunk = cli.recv(1 << 16)
            assert chunk, "the server closed early"
            buf += chunk
        docs = {x["id"]: x for x in
                (json.loads(line) for line in buf.decode().splitlines())}
        assert docs[7]["result"]["tier"] == "exact"
        assert docs[8]["pong"] is True
        cli.close()
    finally:
        loop.stop()
        t.join(timeout=10.0)
    assert not t.is_alive()
    assert result["summary"]["counters"]["requests"] == 2
    assert not os.path.exists(sock_path)  # removed on exit
    os.rmdir(d)


# -- telemetry --------------------------------------------------------------------------

def test_trace_context_and_phase_breakdown(warmed, tmp_path):
    loop = ServeLoop(warmed, _opts(tmp_path, max_pending=8, workers=1,
                                   request_timeout_secs=60.0))
    loop.start()
    docs, respond = _collect()
    loop.submit(_query(1), respond)
    loop.submit(_query(2, trace={"trace_id": "feed" * 4,
                                 "span_id": "00" * 8}), respond)
    loop.drain(timeout=10.0)
    by_id = {d["id"]: d for d in docs}
    d1 = by_id[1]
    assert d1["ok"] and len(d1["trace_id"]) == 16
    r1 = d1["result"]
    assert r1["trace_id"] == d1["trace_id"]
    assert {"fingerprint", "cache_probe", "serialize"} <= set(r1["phase_us"])
    assert all(v >= 0 for v in r1["phase_us"].values())
    assert by_id[2]["trace_id"] == "feed" * 4
    assert by_id[2]["result"]["trace_id"] == "feed" * 4
    assert get_metrics().histogram("serve.resolve_us.exact").count >= 2


def test_metrics_verb_and_snapshot_ring(warmed, tmp_path):
    loop = ServeLoop(warmed, _opts(tmp_path, max_pending=8, workers=1,
                                   request_timeout_secs=60.0, owner="msnap",
                                   slo_target_us=1e9))
    loop.start()
    docs, respond = _collect()
    loop.submit(_query(0), respond)
    loop.submit({"op": "metrics", "id": 1}, respond)
    loop.drain(timeout=10.0)
    m = next(d for d in docs if d["id"] == 1)["metrics"]
    assert m["kind"] == "metrics_snapshot" and m["owner"] == "msnap"
    assert "counters" in m["metrics"] and "dropped_spans" in m["tracer"]
    slo = m["slo"]
    assert slo["target_us"] == 1e9
    assert slo["histogram"] == "serve.resolve_us.exact"
    assert slo["count"] >= 1 and slo["within_target"] is True
    from tenzing_tpu_torch.obs.metrics import latest_snapshots

    latest = latest_snapshots(str(tmp_path))
    assert latest["msnap"]["state"] == "stopped"
    assert latest["msnap"]["queue_depth"] == 0


def test_tenant_histograms_bounded(warmed, tmp_path):
    from tenzing_tpu_torch.obs.metrics import MetricsRegistry, set_metrics

    reg = MetricsRegistry()
    prev = set_metrics(reg)
    try:
        loop = ServeLoop(warmed, _opts(tmp_path, max_pending=8, workers=1,
                                       request_timeout_secs=60.0,
                                       tenant_cap=2))
        loop.start()
        docs, respond = _collect()
        for i, tenant in enumerate(("t-a", "t-b", "t-c", "t-d", "t-a")):
            loop.submit(_query(i, tenant=tenant), respond)
        loop.drain(timeout=10.0)
        assert all(d.get("ok") for d in docs)
        names = set(reg.histograms())
        assert {"serve.tenant.t-a.resolve_us", "serve.tenant.t-b.resolve_us",
                "serve.tenant.other.resolve_us"} <= names
        assert "serve.tenant.t-c.resolve_us" not in names
        assert "serve.tenant.t-d.resolve_us" not in names
        assert reg.histogram("serve.tenant.t-a.resolve_us").count == 2
        assert reg.histogram("serve.tenant.other.resolve_us").count == 2
        assert reg.counter("serve.tenant.other.exact").value == 2
    finally:
        set_metrics(prev)


def test_cold_work_item_carries_ingress_trace(tmp_path, corpus):
    from tenzing_tpu_torch.fault.checkpoint import read_checked_json

    svc = ScheduleService(str(tmp_path / "store"),
                          queue_dir=str(tmp_path / "queue"))
    loop = ServeLoop(svc, _opts(tmp_path, max_pending=8, workers=1,
                                request_timeout_secs=60.0))
    loop.start()
    docs, respond = _collect()
    loop.submit(_query(1), respond)
    loop.drain(timeout=10.0)
    d = docs[0]
    assert d["result"]["tier"] == "cold"
    item = read_checked_json(d["result"]["work_item"])
    assert item["trace"]["trace_id"] == d["trace_id"]


# -- per-tenant admission ------------------------------------------------------------------

def test_tenant_cap_sheds_over_cap_tenant_only(tmp_path):
    from tenzing_tpu_torch.obs.metrics import MetricsRegistry, set_metrics

    prev = set_metrics(MetricsRegistry())
    try:
        loop = ServeLoop(_StubService(delay=0.3), _opts(
            tmp_path, max_pending=16, workers=1, tenant_max_pending=2,
            request_timeout_secs=30.0))
        loop.start()
        docs, respond = _collect()
        for i in range(6):
            loop.submit(_query(f"hog-{i}", tenant="hog"), respond)
        loop.submit(_query("quiet", tenant="quiet"), respond)
        loop.submit(_query("untagged"), respond)
        loop.drain(timeout=20.0)
        by_id = {d.get("id"): d for d in docs}
        shed = [d for d in docs if d.get("shed")]
        assert len(shed) == 4
        assert all(d["reason"] == "tenant_cap" for d in shed)
        assert all(str(d["id"]).startswith("hog-") for d in shed)
        assert by_id["quiet"]["ok"] is True
        assert by_id["untagged"]["ok"] is True
        assert get_metrics().counter("serve.shed.hog").value == 4
        assert get_metrics().counter("serve.shed.quiet").value == 0
    finally:
        set_metrics(prev)


def test_tenant_cap_default_derivation_and_disable(tmp_path):
    svc = _StubService()
    assert ServeLoop(svc, ListenOpts(
        max_pending=64, handle_signals=False,
        status_path=str(tmp_path / "s1.json")))._tenant_pending_cap() == 32
    assert ServeLoop(svc, ListenOpts(
        max_pending=64, tenant_max_pending=0, handle_signals=False,
        status_path=str(tmp_path / "s2.json")))._tenant_pending_cap() == 0
    loop3 = ServeLoop(_StubService(delay=0.2), ListenOpts(
        max_pending=4, workers=1, tenant_max_pending=0,
        request_timeout_secs=30.0, handle_signals=False,
        status_path=str(tmp_path / "s3.json")))
    loop3.start()
    docs, respond = _collect()
    for i in range(8):
        loop3.submit(_query(i, tenant="hog"), respond)
    loop3.drain(timeout=20.0)
    shed = [d for d in docs if d.get("shed")]
    assert shed and all(d["reason"] == "queue-full" for d in shed)


def test_non_string_tenant_never_crashes_admission(tmp_path):
    loop = ServeLoop(_StubService(), _opts(
        tmp_path, max_pending=8, workers=1, tenant_max_pending=1,
        request_timeout_secs=30.0))
    loop.start()
    docs, respond = _collect()
    for i, tenant in enumerate(({"x": 1}, [1, 2], 5, None)):
        loop.submit(_query(i, tenant=tenant), respond)
    loop.drain(timeout=10.0)
    assert len(docs) == 4 and all(d.get("ok") for d in docs), docs
    assert loop._tenant_live == {}


def test_tenant_cap_weighs_batch_members(tmp_path):
    loop = ServeLoop(_StubService(delay=0.3), _opts(
        tmp_path, max_pending=16, workers=1, tenant_max_pending=3,
        request_timeout_secs=30.0))
    loop.start()
    docs, respond = _collect()
    member = {"request": dict(REQ_KW)}
    loop.submit({"op": "batch", "id": "big", "tenant": "hog",
                 "requests": [dict(member) for _ in range(4)]}, respond)
    loop.submit({"op": "batch", "id": "ok", "tenant": "hog",
                 "requests": [dict(member) for _ in range(2)]}, respond)
    loop.submit({"op": "batch", "id": "over", "tenant": "hog",
                 "requests": [dict(member) for _ in range(2)]}, respond)
    loop.drain(timeout=20.0)
    by_id = {d.get("id"): d for d in docs}
    assert by_id["big"].get("shed") and by_id["big"]["reason"] == "tenant_cap"
    assert by_id["ok"]["ok"] is True and len(by_id["ok"]["results"]) == 2
    assert by_id["over"].get("shed") and \
        by_id["over"]["reason"] == "tenant_cap"
    assert loop._tenant_live == {}


def test_tenant_cap_charges_batch_members_to_their_own_tenant(tmp_path):
    loop = ServeLoop(_StubService(delay=0.3), _opts(
        tmp_path, max_pending=16, workers=1, tenant_max_pending=3,
        request_timeout_secs=30.0))
    loop.start()
    docs, respond = _collect()
    member = {"tenant": "hog", "request": dict(REQ_KW)}
    loop.submit({"op": "batch", "id": "smuggle",
                 "requests": [dict(member) for _ in range(5)]}, respond)
    loop.submit({"op": "batch", "id": "mixed", "requests": [
        dict(member), {"tenant": "quiet", "request": dict(REQ_KW)}]},
        respond)
    loop.drain(timeout=20.0)
    by_id = {d.get("id"): d for d in docs}
    assert by_id["smuggle"].get("shed") and \
        by_id["smuggle"]["reason"] == "tenant_cap"
    assert by_id["mixed"]["ok"] is True
    assert loop._tenant_live == {}


def test_derived_tenant_cap_is_work_conserving(tmp_path):
    from tenzing_tpu_torch.obs.metrics import MetricsRegistry, set_metrics

    prev = set_metrics(MetricsRegistry())
    try:
        loop = ServeLoop(_StubService(delay=0.25), _opts(
            tmp_path, max_pending=16, workers=1, request_timeout_secs=30.0))
        loop.start()
        docs, respond = _collect()
        for i in range(10):  # a sole tenant past the derived cap of 8
            loop.submit(_query(f"a{i}", tenant="hog"), respond)
        assert not [d for d in docs if d.get("shed")]
        loop.submit(_query("q", tenant="quiet"), respond)
        for i in range(4):
            loop.submit(_query(f"b{i}", tenant="hog"), respond)
        loop.drain(timeout=30.0)
        shed = [d for d in docs if d.get("shed")]
        assert shed and all(d["reason"] == "tenant_cap" for d in shed)
        assert all(str(d["id"]).startswith("b") for d in shed), shed
    finally:
        set_metrics(prev)


def test_member_tenant_shed_charged_to_over_cap_tenant(tmp_path):
    from tenzing_tpu_torch.obs.metrics import MetricsRegistry, set_metrics

    prev = set_metrics(MetricsRegistry())
    try:
        loop = ServeLoop(_StubService(delay=0.3), _opts(
            tmp_path, max_pending=16, workers=1, tenant_max_pending=2,
            request_timeout_secs=30.0))
        loop.start()
        docs, respond = _collect()
        member = {"tenant": "noisy", "request": dict(REQ_KW)}
        loop.submit({"op": "batch", "id": "b",
                     "requests": [dict(member) for _ in range(5)]}, respond)
        loop.drain(timeout=20.0)
        assert docs[0].get("shed") and docs[0]["reason"] == "tenant_cap"
        assert get_metrics().counter("serve.shed.noisy").value == 1
    finally:
        set_metrics(prev)


def test_counters_and_tenant_counts_survive_a_thread_storm(tmp_path):
    """More workers and submitting threads than cores, the interpreter
    switching threads often: every request is answered once, the counters
    lose no update, and the per-tenant in-flight counts return to empty."""
    loop = ServeLoop(_StubService(), _opts(
        tmp_path, max_pending=1000, workers=8, request_timeout_secs=30.0,
        tenant_max_pending=0))
    docs, respond = _collect()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        loop.start()

        def submit(k):
            for i in range(100):
                loop.submit(_query(f"{k}-{i}", tenant=f"t{i % 3}"), respond)

        ts = [threading.Thread(target=submit, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert loop.drain(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(d["id"] for d in docs) == sorted(
        f"{k}-{i}" for k in range(4) for i in range(100))
    assert all(d.get("ok") for d in docs)
    assert loop.counters["requests"] == loop.counters["served_exact"] == 400
    assert loop._tenant_live == {} and not loop._live


# -- the fast path, recording, the CLI ------------------------------------------------

def test_exact_hits_after_the_first_take_the_fast_path(warmed, tmp_path):
    """The loop's workers call ``Resolver.resolve_fast`` first: the first
    exact query walks the store under the lock, every later one (and a
    batch's members) is answered lock-free from the snapshot."""
    fast = []
    real = warmed.resolver.resolve_fast

    def counting(key):
        res = real(key)
        fast.append(res is not None)
        return res

    warmed.resolver.resolve_fast = counting
    loop = ServeLoop(warmed, _opts(tmp_path, max_pending=8, workers=1,
                                   request_timeout_secs=60.0))
    loop.start()
    docs, respond = _collect()
    for i in range(5):
        loop.submit(_query(i), respond)
    loop.submit({"op": "batch", "id": 9, "requests": [dict(REQ_KW)] * 2},
                respond)
    loop.drain(timeout=30.0)
    assert fast == [False] + [True] * 6
    results = [d["result"] for d in docs if "result" in d]
    results += next(d for d in docs if d["id"] == 9)["results"]
    assert [r["tier"] for r in results] == ["exact"] * 7
    assert [r["provenance"]["cache_hit"] for r in results] == \
        [False] + [True] * 6


def test_record_writes_one_record_per_admitted_request(warmed, tmp_path):
    from tenzing_tpu_torch.serve.reqlog import read_request_log

    rec_dir = str(tmp_path / "rec")
    loop = ServeLoop(warmed, _opts(tmp_path, max_pending=8, workers=1,
                                   request_timeout_secs=60.0,
                                   record_dir=rec_dir, exemplar_k=1))
    loop.start()
    docs, respond = _collect()
    loop.submit(_query(1), respond)
    loop.submit({"op": "batch", "id": 2, "requests": [
        dict(REQ_KW), {"workload": "spmv", "m": 100000}]}, respond)
    loop.submit({"op": "ping", "id": 3}, respond)  # not recorded
    loop.stop()
    loop.submit(_query(4), respond)  # shed: recorded with its outcome
    loop.drain(timeout=30.0)
    log = read_request_log(rec_dir)
    assert log["checksum_failed"] == 0 and log["damaged"] == 0
    recs = log["records"]
    assert [r["outcome"] for r in recs] == \
        ["served", "served", "served", "shed"]
    assert [r.get("tier") for r in recs] == ["exact", "exact", "cold", None]
    assert recs[2]["request"] == {"workload": "spmv", "m": 100000}
    assert loop.summary()["reqlog"]["records"] == 4
    assert os.listdir(os.path.join(rec_dir, "exemplars"))


def test_cli_listen_over_stdin(warmed, tmp_path):
    """``python -m tenzing_tpu_torch.serve listen --platform cuda`` on a
    segmented store: each request line gets its response line, the summary
    follows at EOF, and the status document reads ``stopped``."""
    status = str(tmp_path / "st.json")
    lines = [json.dumps(x) for x in (
        {"op": "ping", "id": "p"}, _query("q"),
        {"op": "batch", "id": "b", "requests": [dict(REQ_KW)]},
        {"op": "metrics", "id": "m"})] + ["not json"]
    p = subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.serve", "listen",
         "--store", warmed.store.path, "--queue", str(tmp_path / "q2"),
         "--platform", "cuda", "--workers", "1", "--status", status,
         "--record", str(tmp_path / "rec")],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=120, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode == 0, p.stderr[-2000:]
    out = [json.loads(line) for line in p.stdout.strip().splitlines()]
    by_id = {d.get("id"): d for d in out[:-1]}
    assert by_id["p"]["pong"] is True
    assert by_id["q"]["result"]["tier"] == "exact"
    assert by_id["q"]["result"]["fingerprint"]["platform"] == "cuda"
    assert by_id["b"]["results"][0]["provenance"]["cache_hit"] is True
    assert by_id["m"]["metrics"]["slo"]["count"] >= 2
    assert by_id[None]["error_class"] == "deterministic"  # the bad line
    assert out[-1]["counters"]["served_exact"] == 2
    assert out[-1]["reqlog"]["records"] == 2
    assert json.load(open(status))["state"] == "stopped"


# -- across the packages -----------------------------------------------------------------

def _normal(doc):
    """A response less timings and trace ids, its fingerprint less the
    platform and the digests that hash it."""
    out = {k: v for k, v in doc.items() if k != "trace_id"}
    for key in ("result", "results"):
        if key not in out:
            continue
        rs = out[key] if key == "results" else [out[key]]
        norm = []
        for r in rs:
            r = {k: v for k, v in r.items()
                 if k not in ("resolve_us", "phase_us", "trace_id",
                              "work_item")}
            fp = dict(r.pop("fingerprint"))
            for k in ("exact", "bucket_digest", "platform"):
                fp.pop(k, None)
            r["fingerprint"] = fp
            r["provenance"] = {k: v for k, v in r["provenance"].items()
                               if k != "source_exact"}
            norm.append(r)
        out[key] = norm if key == "results" else norm[0]
    return out


def test_the_same_transcript_answers_the_same(tmp_path, corpus):
    """Ping, an exact query twice, a batch with a cold member, a malformed
    op and a shed after the stop, through each package's loop over a
    segmented store warmed from one database: the same responses, less
    timings and the platform."""
    from tenzing_tpu.bench.driver import DriverRequest as RefRequest
    from tenzing_tpu.serve.listen import ListenOpts as RefOpts
    from tenzing_tpu.serve.listen import ServeLoop as RefLoop
    from tenzing_tpu.serve.service import ScheduleService as RefService

    transcript = [
        {"op": "ping", "id": 1}, _query(2), _query(3),
        {"op": "batch", "id": 4, "requests": [
            dict(REQ_KW), {"workload": "spmv", "m": 100000}]},
        {"op": "frobnicate", "id": 5}]

    def run(svc, loop_cls, opts_cls, d):
        loop = loop_cls(svc, opts_cls(
            max_pending=8, workers=1, request_timeout_secs=60.0,
            handle_signals=False, owner="same",
            status_path=str(d / "status.json")))
        loop.start()
        docs, respond = _collect()
        for x in transcript:
            loop.submit(json.loads(json.dumps(x)), respond)
        t0 = time.time()
        while len(docs) < len(transcript) and time.time() - t0 < 30:
            time.sleep(0.01)
        loop.stop()
        loop.submit(_query(6), respond)
        assert loop.drain(timeout=30.0)
        return {d.get("id"): _normal(d) for d in docs}, loop.counters

    port_svc = ScheduleService(str(tmp_path / "port"),
                               queue_dir=str(tmp_path / "pq"), platform="cpu")
    port_svc.warm(REQ, [corpus["csv"]], topk=2, train=False)
    ref_svc = RefService(str(tmp_path / "ref"), queue_dir=str(tmp_path / "rq"))
    ref_svc.warm(RefRequest(**REQ_KW), [corpus["csv"]], topk=2, train=False)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    port, pc = run(port_svc, ServeLoop, ListenOpts, tmp_path / "a")
    ref, rc = run(ref_svc, RefLoop, RefOpts, tmp_path / "b")
    assert port == ref
    assert pc == rc
    assert port[2]["result"]["tier"] == "exact"
    assert [r["tier"] for r in port[4]["results"]] == ["exact", "cold"]
    assert port[5]["error_class"] == "deterministic"
    assert port[6]["reason"] == "draining"
