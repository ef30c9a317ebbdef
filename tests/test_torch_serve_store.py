"""The port's schedule store and work queue (tenzing_tpu_torch/serve/
store.py) against the JAX package's (tenzing_tpu/serve/store.py; reference
tests test_serve_store.py), test for test: two writers disjoint and
overlapping, merge commutative and idempotent, schema 1 migrated, a newer
schema skipped, a corrupt or malformed file quarantined or skipped and never
fatal, simultaneous flushes under the lock, the work queue's envelope,
idempotence, torn items and concurrent writers.  Then across the packages: a
store written by either loads in the other with the same records and
``stats``, merges commute and are idempotent across them, and
``open_store`` opens a directory as the segmented store.
"""

import json
import os

import pytest

from tenzing_tpu.bench import driver as ref_driver
from tenzing_tpu.serve import store as ref_store
from tenzing_tpu.serve.fingerprint import fingerprint_of as ref_fingerprint_of
from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of
from tenzing_tpu_torch.serve.store import (
    RECORD_SCHEMA,
    STORE_VERSION,
    ScheduleStore,
    WorkQueue,
    merge_records,
    migrate_record,
    open_store,
)


@pytest.fixture(scope="module")
def spmv():
    """(graph, fingerprints, sequences): one workload neighborhood with
    enough distinct schedules to exercise every store path."""
    from tenzing_tpu_torch.core.platform import Platform
    from tenzing_tpu_torch.core.state import State

    req = DriverRequest(workload="spmv", m=512)
    g, _ = graph_for(req)

    def drive(picks, n_lanes=2):
        plat = Platform.make_n_lanes(n_lanes)
        st = State(g)
        i = 0
        while not st.is_terminal():
            ds = st.get_decisions(plat)
            st = st.apply(ds[picks[i % len(picks)] % len(ds)])
            i += 1
        return st.sequence

    fps = {
        "a": fingerprint_of(req),
        "b": fingerprint_of(DriverRequest(workload="spmv", m=500)),
    }
    seqs = [drive(p) for p in ([0], [1, 2, 0], [2, 1, 0], [1, 0, 2])]
    return g, fps, seqs


def test_two_writers_disjoint_fingerprints(tmp_path, spmv):
    _, fps, seqs = spmv
    path = str(tmp_path / "store.json")
    a = ScheduleStore(path, tenant="host-a")
    b = ScheduleStore(path, tenant="host-b")  # loaded before a flushed
    a.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    a.flush()
    b.add(fps["b"], seqs[2], pct50_us=12.0, vs_naive=1.5)
    b.flush()  # flush re-reads + merges: a's record must survive
    merged = ScheduleStore(path)
    assert len(merged) == 2
    assert merged.best(fps["a"].exact_digest)["vs_naive"] == 2.0
    assert merged.best(fps["b"].exact_digest)["vs_naive"] == 1.5
    tenants = {r["provenance"]["tenant"] for r in merged.records()}
    assert tenants == {"host-a", "host-b"}


def test_two_writers_overlapping_fingerprint(tmp_path, spmv):
    _, fps, seqs = spmv
    path = str(tmp_path / "store.json")
    a = ScheduleStore(path, tenant="host-a")
    b = ScheduleStore(path, tenant="host-b")
    # same fingerprint, same schedule: the better measurement must win
    # regardless of flush order, and both source sets must survive
    a.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    b.add(fps["a"], seqs[1], pct50_us=8.0, vs_naive=2.5)
    # and a second schedule only one writer knows about
    b.add(fps["a"], seqs[2], pct50_us=11.0, vs_naive=1.8)
    a.flush()
    b.flush()
    merged = ScheduleStore(path)
    assert len(merged) == 2  # two distinct schedules under one exact
    assert merged.best(fps["a"].exact_digest)["vs_naive"] == 2.5


def _store_doc(store: ScheduleStore) -> str:
    return json.dumps(store.to_json(), sort_keys=True)


def test_merge_commutative_and_idempotent(tmp_path, spmv):
    _, fps, seqs = spmv

    def mk(tag, entries):
        s = ScheduleStore(str(tmp_path / f"{tag}.json"), tenant=tag)
        for fp, seq, pct, vs in entries:
            s.add(fp, seq, pct50_us=pct, vs_naive=vs)
        return s

    def x():
        return mk("x", [(fps["a"], seqs[1], 10.0, 2.0),
                        (fps["a"], seqs[2], 11.0, 1.8),
                        (fps["b"], seqs[3], 9.0, 2.2)])

    def y():
        return mk("y", [(fps["a"], seqs[1], 9.0, 2.4),   # conflict: better
                        (fps["b"], seqs[1], 14.0, 1.2)])  # disjoint slot

    xy = x()
    xy.merge_from(y())
    yx = y()
    yx.merge_from(x())
    assert _store_doc(xy) == _store_doc(yx)  # commutative
    xyx = x()
    xyx.merge_from(y())
    xyx.merge_from(y())
    xyx.merge_from(x())
    assert _store_doc(xyx) == _store_doc(xy)  # idempotent
    # conflict resolved to the better record, sources/tenant of winner
    assert xy.best(fps["a"].exact_digest)["vs_naive"] == 2.4


def test_merge_records_flags_sticky_and_sources_union():
    a = {"schema": RECORD_SCHEMA, "exact": "e", "bucket": "b", "key": "k",
         "ops": [], "workload": "spmv", "vs_naive": 2.0, "pct50_us": 10.0,
         "sources": ["s1"], "flags": {"needs_refinement": True}}
    b = {"schema": RECORD_SCHEMA, "exact": "e", "bucket": "b", "key": "k",
         "ops": [], "workload": "spmv", "vs_naive": 2.5, "pct50_us": 9.0,
         "sources": ["s2"], "flags": {"unsound": False}}
    m1, m2 = merge_records(a, b), merge_records(b, a)
    assert m1 == m2
    assert m1["vs_naive"] == 2.5
    assert m1["sources"] == ["s1", "s2"]
    assert m1["flags"] == {"needs_refinement": True, "unsound": False}


def test_schema_v1_record_loads_with_defaults(tmp_path, spmv):
    _, fps, seqs = spmv
    path = str(tmp_path / "store.json")
    s = ScheduleStore(path)
    s.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    s.flush()
    doc = json.load(open(path))
    (exact, by_key), = doc["entries"].items()
    (key, rec), = by_key.items()
    # rewrite as a schema-1 record: predates sources/flags/provenance
    for gone in ("sources", "flags", "provenance"):
        rec.pop(gone)
    rec["schema"] = 1
    json.dump(doc, open(path, "w"))
    loaded = ScheduleStore(path)
    assert loaded.skipped == 0
    got = loaded.best(fps["a"].exact_digest)
    assert got["schema"] == RECORD_SCHEMA  # migrated in place
    assert got["sources"] == [] and got["flags"] == {}
    assert got["vs_naive"] == 2.0


def test_newer_schema_record_skipped_loudly(tmp_path, spmv):
    _, fps, seqs = spmv
    path = str(tmp_path / "store.json")
    s = ScheduleStore(path)
    s.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    s.flush()
    doc = json.load(open(path))
    next(iter(next(iter(doc["entries"].values())).values()))["schema"] = \
        RECORD_SCHEMA + 1
    json.dump(doc, open(path, "w"))
    notes = []
    loaded = ScheduleStore(path, log=notes.append)
    assert loaded.skipped == 1 and len(loaded) == 0
    assert any("skipped record" in n for n in notes)
    # migrate_record's contract directly: never mis-read the future
    assert migrate_record({"schema": RECORD_SCHEMA + 1}) is None


def test_corrupt_store_quarantined_not_fatal(tmp_path, spmv):
    _, fps, seqs = spmv
    path = str(tmp_path / "store.json")
    with open(path, "w") as f:
        f.write('{"version": 1, "entries": {trunca')  # torn write
    notes = []
    s = ScheduleStore(path, log=notes.append)  # must not raise
    assert len(s) == 0
    assert any("quarantined" in n for n in notes)
    # the damaged bytes moved aside for post-mortem...
    corpses = [p for p in os.listdir(tmp_path)
               if p.startswith("store.json.corrupt-")]
    assert len(corpses) == 1
    # ...and a fresh flush starts a clean, loadable file
    s.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    s.flush()
    assert len(ScheduleStore(path)) == 1


def test_simultaneous_flushes_lose_nothing(tmp_path, spmv):
    """The flock around flush()'s read-merge-rename: two writers
    flushing at the same moment must both land (without the lock, both
    re-read the same disk state and the second rename drops the
    first's records)."""
    import threading

    _, fps, seqs = spmv
    path = str(tmp_path / "store.json")
    a = ScheduleStore(path, tenant="t-a")
    b = ScheduleStore(path, tenant="t-b")
    a.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    b.add(fps["b"], seqs[2], pct50_us=12.0, vs_naive=1.5)
    barrier = threading.Barrier(2)

    def go(store):
        barrier.wait()
        store.flush()

    ts = [threading.Thread(target=go, args=(s,)) for s in (a, b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(ScheduleStore(path)) == 2
    assert os.path.exists(path + ".lock")


def test_merge_tie_preserves_one_sided_provenance():
    """A driver-verdict stamp (warm --bench) on one twin must survive
    merging with an unstamped twin in BOTH orders — the tiebreak picks
    a winner, but provenance keys the winner lacks fill from the
    loser."""
    base = {"schema": RECORD_SCHEMA, "exact": "e", "bucket": "b",
            "key": "k", "ops": [], "workload": "spmv", "vs_naive": 2.0,
            "pct50_us": 10.0, "sources": [], "flags": {}}
    stamped = dict(base, provenance={"tenant": "a", "fid": "full",
                                     "driver": {"best_vs_baseline": 2.9,
                                                "verified": True}})
    plain = dict(base, provenance={"tenant": "b", "fid": "full"})
    for m in (merge_records(stamped, plain), merge_records(plain, stamped)):
        assert m["provenance"]["driver"]["verified"] is True, m


def test_flag_idempotent_set_does_not_rewrite(tmp_path, spmv):
    _, fps, seqs = spmv
    path = str(tmp_path / "store.json")
    s = ScheduleStore(path)
    rec = s.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    s.flag(rec["exact"], rec["key"], needs_refinement=True)
    mtime = os.path.getmtime(path)
    stat = os.stat(path)
    # the hot serving path re-flags on every near query: an already-set
    # flag must not pay another read-merge-fsync-rename cycle
    s.flag(rec["exact"], rec["key"], needs_refinement=True)
    assert os.stat(path).st_ino == stat.st_ino  # no atomic replace ran
    assert os.path.getmtime(path) == mtime


def test_flush_creates_missing_store_directory(tmp_path, spmv):
    # the CLI promises "created on first flush" — the .lock sidecar
    # must not trip over the not-yet-existing directory first
    _, fps, seqs = spmv
    path = str(tmp_path / "new" / "nested" / "store.json")
    s = ScheduleStore(path)
    s.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    s.flush()
    assert len(ScheduleStore(path)) == 1


def test_flush_does_not_inflate_load_merge_counters(tmp_path, spmv):
    from tenzing_tpu_torch.obs.metrics import get_metrics

    _, fps, seqs = spmv
    path = str(tmp_path / "store.json")
    s = ScheduleStore(path)
    s.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    s.flush()
    loaded = get_metrics().counter("serve.store.loaded").value
    merged = get_metrics().counter("serve.store.merged").value
    for _ in range(3):  # flush bookkeeping is not a load or a merge
        s.flush()
    assert get_metrics().counter("serve.store.loaded").value == loaded
    assert get_metrics().counter("serve.store.merged").value == merged


def test_structurally_malformed_store_never_fatal(tmp_path):
    """Valid JSON with wrong shapes (null slot, list record) must load
    as skips, not crash construction — flush()'s re-read runs under the
    flock and the CLI/report construct stores on arbitrary files."""
    path = str(tmp_path / "store.json")
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": {
            "aaa": None,                      # malformed slot
            "bbb": {"k1": ["not", "a", "record"], "k2": "nope"},
        }}, f)
    notes = []
    s = ScheduleStore(path, log=notes.append)  # must not raise
    assert len(s) == 0 and s.skipped == 3
    assert any("malformed slot" in n for n in notes)
    assert migrate_record(["not", "a", "dict"]) is None


def test_workqueue_ensure_skips_valid_rewrite(tmp_path, spmv):
    _, fps, _ = spmv
    q = WorkQueue(str(tmp_path / "queue"))
    req = DriverRequest(workload="spmv", m=512)
    p1 = q.ensure(fps["a"], req.to_json(), reason="cold")
    mtime = os.path.getmtime(p1)
    ino = os.stat(p1).st_ino
    # the hot path: an identical re-ensure must not rewrite the item
    p2 = q.ensure(fps["a"], req.to_json(), reason="cold")
    assert p1 == p2
    assert os.stat(p1).st_ino == ino and os.path.getmtime(p1) == mtime
    # a torn item IS re-asserted
    with open(p1, "w") as f:
        f.write("{")
    q.ensure(fps["a"], req.to_json(), reason="cold")
    from tenzing_tpu_torch.fault.checkpoint import read_checked_json

    assert read_checked_json(p1)["reason"] == "cold"


def test_readonly_load_leaves_corrupt_file_in_place(tmp_path):
    # valid JSON, wrong version: parses fine but fails store validation
    path = str(tmp_path / "store.json")
    with open(path, "w") as f:
        json.dump({"version": 99, "entries": {}}, f)
    notes = []
    s = ScheduleStore(path, log=notes.append, quarantine_corrupt=False)
    assert len(s) == 0
    assert os.path.exists(path), "read-only load must not rename"
    assert not [p for p in os.listdir(tmp_path) if ".corrupt-" in p]
    assert any("left in place" in n for n in notes)


def test_workqueue_checkpoint_format_and_idempotence(tmp_path, spmv):
    from tenzing_tpu_torch.fault.checkpoint import read_checked_json

    _, fps, _ = spmv
    q = WorkQueue(str(tmp_path / "queue"))
    # read-only use must not materialize the directory (a typo'd
    # --queue path would silently shadow the real queue); first enqueue
    # creates it
    assert len(q) == 0 and not os.path.isdir(q.dir)
    req = DriverRequest(workload="spmv", m=512)
    p1 = q.enqueue(fps["a"], req.to_json(), reason="cold")
    assert os.path.isdir(q.dir)
    p2 = q.enqueue(fps["a"], req.to_json(), reason="cold")  # re-assert
    assert p1 == p2 and len(q) == 1  # keyed by exact digest: no piling
    payload = read_checked_json(p1)  # the digest-checked envelope parses
    assert payload["kind"] == "search_request"
    assert payload["fingerprint"]["exact"] == fps["a"].exact_digest
    rt = DriverRequest(**payload["request"])
    assert rt.workload == "spmv" and rt.m == 512
    # a torn item never crashes a drainer
    with open(os.path.join(q.dir, "work-torn.json"), "w") as f:
        f.write("{")
    assert len(q.items()) == 1
    # ...and is VISIBLE, not silently dropped: the
    # scan records the torn set for serve stats / the report CLI
    assert [os.path.basename(p) for p in q.torn_paths] == ["work-torn.json"]
    st = q.stats()
    assert st["depth"] == 1 and st["torn"] == ["work-torn.json"]


def test_workqueue_concurrent_writers_one_valid_item(tmp_path, spmv):
    """Two writers asserting the same fingerprint concurrently (the
    fleet-rate near-miss path): exactly one item file survives, and it
    is a VALID digest-checked envelope — atomic_write_json's
    tmp+fsync+rename means last-wins, never torn."""
    import threading

    from tenzing_tpu_torch.fault.checkpoint import read_checked_json

    _, fps, _ = spmv
    q = WorkQueue(str(tmp_path / "queue"))
    req = DriverRequest(workload="spmv", m=512)
    barrier = threading.Barrier(2)
    errors = []

    def writer(tenant):
        try:
            barrier.wait()
            for i in range(25):
                q.ensure(fps["a"], req.to_json(), reason=f"cold-{tenant}")
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    ts = [threading.Thread(target=writer, args=(t,)) for t in ("a", "b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors
    names = [n for n in os.listdir(q.dir) if n.startswith("work-")]
    assert names == [f"work-{fps['a'].exact_digest}.json"]
    payload = read_checked_json(q.path_for(fps["a"].exact_digest))
    assert payload["kind"] == "search_request"
    assert payload["reason"].startswith("cold-")
    assert DriverRequest(**payload["request"]).m == 512


def test_workqueue_torn_item_reassert_under_concurrent_ensure(tmp_path, spmv):
    """The ensure() torn-item re-assert path raced by a second ensure:
    whatever interleaving wins, the surviving file is a valid envelope
    for the fingerprint."""
    import threading

    from tenzing_tpu_torch.fault.checkpoint import read_checked_json

    _, fps, _ = spmv
    q = WorkQueue(str(tmp_path / "queue"))
    req = DriverRequest(workload="spmv", m=512)
    path = q.ensure(fps["a"], req.to_json(), reason="cold")
    with open(path, "w") as f:
        f.write("{not json")  # torn by a crashed writer
    barrier = threading.Barrier(2)

    def reassert():
        barrier.wait()
        q.ensure(fps["a"], req.to_json(), reason="cold")

    ts = [threading.Thread(target=reassert) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    payload = read_checked_json(path)  # valid again, digest-checked
    assert payload["fingerprint"]["exact"] == fps["a"].exact_digest


# -- across the packages -------------------------------------------------------

def _cross_stores(tmp_path, spmv):
    """A store written by the port and one written by the reference, for
    the same requests and schedules (each under its own fingerprints)."""
    from tenzing_tpu.core.serdes import sequence_from_json as ref_from_json
    from tenzing_tpu_torch.core.serdes import sequence_to_json

    _, fps, seqs = spmv
    ref_g, _ = ref_driver.graph_for(ref_driver.DriverRequest(workload="spmv",
                                                             m=512))
    ref_fps = {"a": ref_fingerprint_of(ref_driver.DriverRequest(
        workload="spmv", m=512)), "b": ref_fingerprint_of(
        ref_driver.DriverRequest(workload="spmv", m=500))}
    port = ScheduleStore(str(tmp_path / "port.json"), tenant="port")
    ref = ref_store.ScheduleStore(str(tmp_path / "ref.json"), tenant="ref")
    for tag, i, pct, vs in (("a", 1, 10.0, 2.0), ("a", 2, 11.0, 1.8),
                            ("b", 3, 9.0, 2.2)):
        port.add(fps[tag], seqs[i], pct50_us=pct, vs_naive=vs,
                 verified=True)
        ref.add(ref_fps[tag], ref_from_json(
            json.loads(json.dumps(sequence_to_json(seqs[i]))), ref_g),
            pct50_us=pct - 1.0, vs_naive=vs + 0.1, verified=True)
    port.flush()
    ref.flush()
    return port, ref


def _doc(store) -> str:
    return json.dumps(store.to_json(), sort_keys=True)


def test_store_written_by_either_package_loads_in_the_other(tmp_path, spmv):
    port, ref = _cross_stores(tmp_path, spmv)
    assert STORE_VERSION == ref_store.STORE_VERSION
    assert RECORD_SCHEMA == ref_store.RECORD_SCHEMA
    in_port = ScheduleStore(ref.path)
    in_ref = ref_store.ScheduleStore(port.path)
    assert in_port.skipped == 0 and in_ref.skipped == 0
    assert _doc(in_port) == _doc(ref) and _doc(in_ref) == _doc(port)
    for a, b in ((in_port, ref), (in_ref, port)):
        sa, sb = a.stats(), b.stats()
        assert sa == sb
        assert sa["records"] == 3 and sa["fingerprints"] == 2
    # the schedules keyed the same slots in both packages
    assert sorted(r["key"] for r in in_port.records()) == \
        sorted(r["key"] for r in port.records())


def test_cross_package_merge_commutative_and_idempotent(tmp_path, spmv):
    port, ref = _cross_stores(tmp_path, spmv)
    # the port merging the reference's file, and the reference the port's
    pr = ScheduleStore(port.path)
    pr.merge_from(ScheduleStore(ref.path))
    rp = ref_store.ScheduleStore(ref.path)
    rp.merge_from(ref_store.ScheduleStore(port.path))
    assert _doc(pr) == _doc(rp)  # commutative, across the packages
    assert len(pr) == 6  # disjoint fingerprints: the platform is in the key
    again = ScheduleStore(port.path)
    for _ in range(2):
        again.merge_from(ScheduleStore(ref.path))
        again.merge_from(ScheduleStore(port.path))
    assert _doc(again) == _doc(pr)  # idempotent
    # merge_records agrees with the reference's on one slot's conflict
    a, b = port.records()[0], dict(port.records()[0], vs_naive=9.0,
                                   provenance={"tenant": "x", "device": "y"})
    for x, y in ((a, b), (b, a)):
        assert merge_records(x, y) == ref_store.merge_records(x, y)


def test_open_store_refuses_the_segmented_store(tmp_path):
    """A directory (existing or not) names the segmented store
    (serve/segments.py): ``open_store`` opens it as one and never opens a
    monolithic file there; a ``*.json`` path stays monolithic."""
    from tenzing_tpu_torch.serve.segments import SegmentedStore

    assert type(open_store(str(tmp_path / "s.json"))) is ScheduleStore
    assert open_store(None).path is None
    for path in (str(tmp_path), str(tmp_path / "segmented")):
        st = open_store(path)
        assert isinstance(st, SegmentedStore) and st.dir == path
    assert not os.path.exists(tmp_path / "segmented")  # made on flush
