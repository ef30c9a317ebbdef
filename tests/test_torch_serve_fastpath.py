"""The serving fast path of the port (tenzing_tpu_torch/serve/resolver.py:
sealed-response memoization, the fingerprint canonicalization cache,
lock-free exact reads) against the reference's tests
(test_serve_fastpath.py), test for test.  The contract is byte identity: a
memoized response patched with the per-request fields serializes to the
bytes of a fresh serialization; the memo dies with the store generation
(records landing, flags) and on eviction; the lock-free path answers what
the locked path answers while a writer bumps the generation, and the listen
loop's workers (serve/listen.py) serve exact hits through it concurrently.
"""

import itertools
import json
import threading

import pytest

from tenzing_tpu.serve.resolver import fp_cache_key as ref_fp_cache_key
from tenzing_tpu_torch.bench.benchmarker import BenchResult, result_row
from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of, schedule_key
from tenzing_tpu_torch.serve.resolver import Resolver, fp_cache_key
from tenzing_tpu_torch.serve.service import ScheduleService

REQ_KW = {"workload": "spmv", "m": 512}
REQ = DriverRequest(**REQ_KW)
NEAR_KW = {"workload": "spmv", "m": 500}       # same bucket
COLD_KW = {"workload": "spmv", "m": 100_000}   # different bucket


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
    d = tmp_path_factory.mktemp("fastpath_corpus")
    g, _ = graph_for(REQ)
    naive = _drive(g, 1, [0])
    alts, seen = [], set()
    for picks in itertools.product((0, 1, 2), repeat=3):
        s = _drive(g, 2, list(picks))
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


def _service(tmp_path, corpus, train=True):
    svc = ScheduleService(str(tmp_path / "store.json"),
                          queue_dir=str(tmp_path / "queue"))
    svc.warm(REQ, [corpus["csv"]], topk=2, train=train)
    return svc


def _strip_request_fields(doc):
    out = dict(doc)
    out.pop("phase_us", None)
    out.pop("trace_id", None)
    return out


# -- byte identity ----------------------------------------------------------

def test_memo_byte_identity_to_fresh_serialization(corpus, tmp_path):
    """THE memo contract: for an exact cache hit, the memoized
    copy-and-patch document serializes to exactly the bytes a fresh,
    never-memoized serialization of the same resolution produces."""
    svc = _service(tmp_path, corpus, train=False)
    key = fp_cache_key(REQ_KW)
    svc.query(REQ, fp_key=key)          # walk: populates cache + memo
    memoized = svc.query(REQ, fp_key=key)   # cache hit: memo-backed
    assert memoized.memo is not None
    assert memoized.provenance["cache_hit"] is True

    # the fresh reference: a brand-new resolver over the SAME store
    # object (a disk round-trip may reorder record keys cosmetically —
    # the memo contract is about serializing the same in-memory record),
    # taken to the same cache-hit state, with the memo surgically
    # removed so its to_json serializes from scratch
    fresh_r = Resolver(svc.store, queue=None)
    fresh_r.resolve(REQ)
    fresh = fresh_r.resolve(REQ)
    assert fresh.provenance["cache_hit"] is True
    fresh.memo = None  # force the from-scratch serialization path
    fresh.phase_us = memoized.phase_us
    fresh.trace_id = memoized.trace_id
    assert json.dumps(memoized.to_json()) == json.dumps(fresh.to_json())


def test_memo_byte_identity_every_tier_shape(corpus, tmp_path):
    """Every tier/outcome shape a resolution can serialize: the memoized
    path and the fresh path agree byte-for-byte where both exist, and
    the non-memoized tiers (walk-serve, near, cold) still serialize
    with their documented fields."""
    svc = _service(tmp_path, corpus, train=True)
    key = fp_cache_key(REQ_KW)

    walk = svc.query(REQ, fp_key=key)
    assert walk.tier == "exact" and walk.memo is None
    assert walk.provenance["cache_hit"] is False
    wj = walk.to_json()
    assert {"tier", "fingerprint", "provenance", "key", "ops",
            "pct50_us", "vs_naive", "phase_us", "trace_id"} <= set(wj)

    hit = svc.query(REQ, fp_key=key)
    hj = hit.to_json()
    # identical documents modulo the per-request fields and the
    # cache-hit provenance + walk-only phase
    assert _strip_request_fields(hj)["ops"] == \
        _strip_request_fields(wj)["ops"]
    assert hj["provenance"]["cache_hit"] is True
    assert "store_walk" not in hj["phase_us"]

    near = svc.query(DriverRequest(**NEAR_KW),
                     fp_key=fp_cache_key(NEAR_KW))
    assert near.tier == "near" and near.memo is None
    nj = near.to_json()
    assert nj["provenance"]["was_predicted"] is True

    cold = svc.query(DriverRequest(**COLD_KW),
                     fp_key=fp_cache_key(COLD_KW))
    assert cold.tier == "cold" and cold.memo is None
    cj = cold.to_json()
    assert cj["work_item"]

    # re-querying near/cold through the fast path must decline (only
    # exact hits are lock-free servable)
    assert svc.resolver.resolve_fast(fp_cache_key(COLD_KW)) is None


def test_fast_path_byte_identity_and_provenance(corpus, tmp_path):
    svc = _service(tmp_path, corpus, train=False)
    key = fp_cache_key(REQ_KW)
    svc.query(REQ, fp_key=key)
    slow_hit = svc.query(REQ, fp_key=key)
    fast = svc.resolver.resolve_fast(key)
    assert fast is not None and fast.tier == "exact"
    fj, sj = fast.to_json(), slow_hit.to_json()
    sj["phase_us"] = fj["phase_us"]
    sj["trace_id"] = fj["trace_id"]
    assert json.dumps(fj) == json.dumps(sj)
    assert fast.record["key"] == slow_hit.record["key"]
    assert fast.pct50_us == slow_hit.pct50_us
    assert fast.provenance["verifier_calls"] == 0
    assert fast.phase_us.keys() == {"fingerprint", "cache_probe"}


# -- fingerprint cache ------------------------------------------------------

def test_fp_cache_key_shapes():
    assert fp_cache_key({"workload": "spmv", "m": 512}) == \
        (("m", 512), ("workload", "spmv"))
    assert fp_cache_key({}) == ()
    assert fp_cache_key(None) is None
    assert fp_cache_key("nope") is None
    # unhashable values are honestly uncacheable, never a crash
    assert fp_cache_key({"learn_train": ["a.csv"]}) is None


def test_fp_cache_counters_and_bound(corpus, tmp_path):
    svc = _service(tmp_path, corpus, train=False)
    reg = get_metrics()
    h0 = reg.counter("serve.fp_cache.hits").value
    m0 = reg.counter("serve.fp_cache.misses").value
    key = fp_cache_key(REQ_KW)
    svc.query(REQ, fp_key=key)
    assert reg.counter("serve.fp_cache.misses").value == m0 + 1
    svc.query(REQ, fp_key=key)
    assert reg.counter("serve.fp_cache.hits").value == h0 + 1
    # the cached fingerprint has both digests precomputed (the whole
    # point: probe-time digest hashing collapses to an attribute read)
    fp = svc.resolver._fp_cache[key]
    assert "exact_digest" in fp.__dict__ and "bucket_digest" in fp.__dict__
    # bounded: a sweep of distinct keys evicts oldest-first
    svc.resolver.fp_cache_cap = 4
    for m in (601, 602, 603, 604):
        kw = {"workload": "spmv", "m": m}
        svc.query(DriverRequest(**kw), fp_key=fp_cache_key(kw))
    assert len(svc.resolver._fp_cache) <= 4
    assert key not in svc.resolver._fp_cache  # the oldest fell out


# -- invalidation -----------------------------------------------------------

def test_memo_invalidates_on_store_generation_bump(corpus, tmp_path):
    svc = _service(tmp_path, corpus, train=False)
    reg = get_metrics()
    key = fp_cache_key(REQ_KW)
    svc.query(REQ, fp_key=key)
    assert svc.resolver.resolve_fast(key) is not None
    inv0 = reg.counter("serve.memo.invalidations").value
    # any record landing bumps the generation...
    svc.store.add(fingerprint_of(DriverRequest(**COLD_KW)),
                  corpus["alts"][0], pct50_us=5.0, vs_naive=1.1)
    # ...which kills the snapshot for the lock-free path immediately
    assert svc.resolver.resolve_fast(key) is None
    res = svc.query(REQ, fp_key=key)  # exclusive path refreshes
    assert res.tier == "exact"
    assert reg.counter("serve.memo.invalidations").value > inv0
    assert svc.resolver.resolve_fast(key) is not None


def test_memo_invalidates_on_flag_mutation(corpus, tmp_path):
    svc = _service(tmp_path, corpus, train=False)
    key = fp_cache_key(REQ_KW)
    res = svc.query(REQ, fp_key=key)
    assert svc.resolver.resolve_fast(key) is not None
    # a flag mutation (the unsound case above all) must invalidate:
    # store.flag bumps the generation exactly like a record landing
    svc.store.flag(res.record["exact"], res.record["key"],
                   needs_refinement=True)
    assert svc.resolver.resolve_fast(key) is None
    again = svc.query(REQ, fp_key=key)
    assert again.tier == "exact"
    assert again.record["flags"]["needs_refinement"] is True


def test_unsound_flag_never_served_after_invalidation(corpus, tmp_path):
    svc = _service(tmp_path, corpus, train=False)
    key = fp_cache_key(REQ_KW)
    res = svc.query(REQ, fp_key=key)
    served_key = res.record["key"]
    svc.store.flag(res.record["exact"], served_key, unsound=True)
    assert svc.resolver.resolve_fast(key) is None  # snapshot is stale
    again = svc.query(REQ, fp_key=key)
    # the runner-up (or a demotion) — never the flagged record
    assert again.record is None or again.record["key"] != served_key


def test_memo_invalidates_on_cache_eviction(corpus, tmp_path):
    svc = _service(tmp_path, corpus, train=False)
    reg = get_metrics()
    svc.resolver.exact_cache_cap = 1
    key = fp_cache_key(REQ_KW)
    svc.query(REQ, fp_key=key)
    inv0 = reg.counter("serve.memo.invalidations").value
    # a second fingerprint entering the size-1 cache evicts the first —
    # and the evicted sealed memo is counted as an invalidation
    kw2 = {"workload": "spmv", "m": 700}
    svc.store.add(fingerprint_of(DriverRequest(**kw2)),
                  corpus["alts"][1], pct50_us=3.0, vs_naive=1.2)
    svc.query(DriverRequest(**kw2), fp_key=fp_cache_key(kw2))
    svc.query(DriverRequest(**kw2), fp_key=fp_cache_key(kw2))
    r2 = svc.query(REQ, fp_key=key)          # misses, re-walks, evicts
    assert r2.tier == "exact"
    assert reg.counter("serve.memo.invalidations").value > inv0
    assert len(svc.resolver._exact_cache) == 1


def test_memo_counters_economics(corpus, tmp_path):
    svc = _service(tmp_path, corpus, train=False)
    reg = get_metrics()
    h0 = reg.counter("serve.memo.hits").value
    m0 = reg.counter("serve.memo.misses").value
    key = fp_cache_key(REQ_KW)
    svc.query(REQ, fp_key=key)          # walk = memo miss (seal here)
    svc.query(REQ, fp_key=key)          # cache hit = memo hit
    svc.resolver.resolve_fast(key)      # fast path = memo hit
    assert reg.counter("serve.memo.misses").value == m0 + 1
    assert reg.counter("serve.memo.hits").value == h0 + 2


# -- concurrent reads (the hammer) -----------------------------------------

def test_concurrent_fast_reads_identical_under_mutating_writer(
        corpus, tmp_path):
    """Hammer: reader threads resolve the same exact request through the
    listen-style fast-or-exclusive split while a writer keeps bumping
    the store generation (re-adding the same records — the answer never
    legitimately changes).  Every response must be identical to the
    serialized reference modulo the per-request fields, and nothing may
    error — a stale snapshot falls through to the exclusive path, never
    to a wrong answer."""
    svc = _service(tmp_path, corpus, train=False)
    key = fp_cache_key(REQ_KW)
    ref = svc.query(REQ, fp_key=key)
    ref_body = _strip_request_fields(svc.query(REQ, fp_key=key).to_json())
    lock = threading.Lock()  # the listen loop's exclusive lock, modeled
    stop = threading.Event()
    errors: list = []
    mismatches: list = []
    served = [0]

    fp = fingerprint_of(REQ)
    rec = svc.store.best(fp.exact_digest)

    def writer():
        # same content re-added: generation bumps (merge is idempotent),
        # the served answer must not change
        while not stop.is_set():
            svc.store._put(dict(rec))

    def reader():
        for _ in range(300):
            try:
                res = svc.resolver.resolve_fast(key)
                if res is None:
                    with lock:
                        res = svc.query(REQ, fp_key=key)
                body = _strip_request_fields(res.to_json())
                body["provenance"] = dict(body["provenance"],
                                          cache_hit=True)
                body.pop("phase_us", None)
                want = dict(ref_body, provenance=dict(
                    ref_body["provenance"], cache_hit=True))
                if json.dumps(body, sort_keys=True) != \
                        json.dumps(want, sort_keys=True):
                    mismatches.append((body, want))
                with lock:
                    served[0] += 1
            except Exception as e:  # pragma: no cover - the assertion
                errors.append(repr(e))

    wt = threading.Thread(target=writer, daemon=True)
    readers = [threading.Thread(target=reader, daemon=True)
               for _ in range(4)]
    wt.start()
    for t in readers:
        t.start()
    for t in readers:
        t.join(timeout=60)
    stop.set()
    wt.join(timeout=5)
    assert not errors, errors[:3]
    assert not mismatches, mismatches[:1]
    assert served[0] == 4 * 300
    assert ref.tier == "exact"


def test_worker_threads_serve_exact_hits_concurrently(corpus, tmp_path):
    """The split lock through the real listen loop (serve/listen.py): four
    workers answer 32 queued requests, each trying ``resolve_fast`` and
    falling back to the locked path; every answer is exact, the steady
    state comes from the memo, and every hit serializes to the same
    bytes."""
    from tenzing_tpu_torch.serve.listen import ListenOpts, ServeLoop

    svc = _service(tmp_path, corpus, train=False)
    loop = ServeLoop(svc, ListenOpts(
        max_pending=64, workers=4, request_timeout_secs=30.0,
        handle_signals=False, status_path=str(tmp_path / "status.json")))
    loop.start()
    docs, lock = [], threading.Lock()

    def respond(doc):
        with lock:
            docs.append(doc)

    for i in range(32):
        loop.submit({"op": "query", "id": i, "request": dict(REQ_KW)},
                    respond)
    assert loop.drain(timeout=30.0)
    ok = [d for d in docs if d.get("ok")]
    assert len(ok) == 32
    assert {d["result"]["tier"] for d in ok} == {"exact"}
    hits = [d for d in ok if d["result"]["provenance"].get("cache_hit")]
    assert len(hits) >= 30
    bodies = {json.dumps(_strip_request_fields(
        {k: v for k, v in d["result"].items() if k != "resolve_us"}))
        for d in hits}
    assert len(bodies) == 1  # every concurrent hit: the same bytes


def test_fp_cache_key_rejects_oversized_kwargs():
    """The key retains verbatim client kwargs for the cache's lifetime:
    a multi-megabyte string value (a valid DriverRequest path field) is
    honestly uncacheable instead of pinning memory in the serve loop."""
    small = {"workload": "spmv", "dump_csv": "x" * 100}
    assert fp_cache_key(small) is not None
    huge = {"workload": "spmv", "dump_csv": "x" * 1_000_000}
    assert fp_cache_key(huge) is None
    many = {f"k{i}": "v" * 64 for i in range(64)}
    assert fp_cache_key(many) is None  # aggregate size counts too


def test_fp_cache_key_is_the_references():
    for kw in (REQ_KW, NEAR_KW, COLD_KW, {}, {"learn_train": ["a.csv"]},
               {"workload": "spmv", "dump_csv": "x" * 5000}, None, "nope"):
        assert fp_cache_key(kw) == ref_fp_cache_key(kw)
