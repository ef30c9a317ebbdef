"""The port's segmented store and compactor (tenzing_tpu_torch/serve/
segments.py) against the JAX package's (tenzing_tpu/serve/segments.py;
reference tests test_serve_segments.py), test for test: the backend parity
with the monolithic store, a flush that costs the dirty records, every
damage recovered to a superset and never fatal (a truncated segment, a
flipped bit, a torn manifest, a compactor killed in either window),
compaction's ledger and lease, and a read-only load that leaves a damaged
tree as it was.  Then across the packages: ``record_digest`` and the
segment lines are the reference's, a directory written by either loads in
the other with every checksum valid, a compactor of either converges a
tree both wrote, and the reference's records answer nothing on the card's
platform.
"""

import hashlib
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from tenzing_tpu.serve import segments as ref_segments
from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of, schedule_key
from tenzing_tpu_torch.serve.lease import LeaseFile
from tenzing_tpu_torch.serve.segments import (
    Compactor,
    SegmentedStore,
    record_digest,
    segment_bucket_of,
)
from tenzing_tpu_torch.serve.store import (
    RECORD_SCHEMA,
    ScheduleStore,
    merge_records,
    open_store,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def spmv():
    """(graph, fingerprints, sequences): the neighbourhood the monolithic
    store's tests drive (tests/test_torch_serve_store.py)."""
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
        # another bucket (m=100000 buckets to 131072)
        "c": fingerprint_of(DriverRequest(workload="spmv", m=100000)),
    }
    seqs = [drive(p) for p in ([0], [1, 2, 0], [2, 1, 0], [1, 0, 2])]
    return g, fps, seqs


def _seg_files(store_dir):
    segdir = os.path.join(store_dir, "segments")
    if not os.path.isdir(segdir):
        return []
    return sorted(n for n in os.listdir(segdir)
                  if n.startswith("seg-") and n.endswith(".jsonl"))


def _records_doc(store):
    return json.dumps(sorted(json.dumps(r, sort_keys=True)
                             for r in store.records()))


def _tree(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, d)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


# -- parity and dispatch ------------------------------------------------------

def test_open_store_dispatch(tmp_path):
    assert isinstance(open_store(str(tmp_path / "s.json")), ScheduleStore)
    seg = open_store(str(tmp_path / "segdir"))
    assert isinstance(seg, SegmentedStore)
    assert not isinstance(open_store(str(tmp_path / "s.json")),
                          SegmentedStore)


def test_roundtrip_parity_with_monolithic(tmp_path, spmv):
    """The same adds into both backends give the same records and the same
    best answers."""
    _, fps, seqs = spmv
    mono = ScheduleStore(str(tmp_path / "mono.json"), tenant="t")
    seg = SegmentedStore(str(tmp_path / "seg"), tenant="t")
    for s in (mono, seg):
        s.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0, verified=True)
        s.add(fps["a"], seqs[2], pct50_us=11.0, vs_naive=1.8)
        s.add(fps["b"], seqs[3], pct50_us=9.0, vs_naive=2.2)
        s.flush()
    seg2 = SegmentedStore(str(tmp_path / "seg"))
    mono2 = ScheduleStore(str(tmp_path / "mono.json"))
    assert _records_doc(seg2) == _records_doc(mono2)
    assert seg2.best(fps["a"].exact_digest)["vs_naive"] == 2.0
    assert seg2.best(fps["a"].exact_digest)["verified_at_admission"] is True


def test_flush_cost_is_dirty_records_not_corpus(tmp_path, spmv):
    """A flush writes one segment per dirty bucket holding only the dirty
    records: the store's size never serializes again."""
    _, fps, seqs = spmv
    s = SegmentedStore(str(tmp_path / "seg"))
    s.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    s.add(fps["a"], seqs[2], pct50_us=11.0, vs_naive=1.8)
    s.flush()
    assert len(_seg_files(s.dir)) == 1
    s.flush()  # nothing dirty: no segment
    assert len(_seg_files(s.dir)) == 1
    s.add(fps["a"], seqs[3], pct50_us=9.0, vs_naive=2.5)
    s.flush()
    files = _seg_files(s.dir)
    assert len(files) == 2
    with open(os.path.join(s.dir, "segments", sorted(files)[-1])) as f:
        assert json.loads(f.readline())["n_records"] == 1
    distinct = len({schedule_key(q) for q in (seqs[1], seqs[2], seqs[3])})
    assert len(SegmentedStore(s.dir)) == distinct


def test_two_writers_concurrent_flush(tmp_path, spmv):
    """Two stores flushing at once: the manifest's read-modify-write goes
    under the flock and its backoff, segments are files per writer — both
    land."""
    _, fps, seqs = spmv
    path = str(tmp_path / "seg")
    a = SegmentedStore(path, tenant="w-a")
    b = SegmentedStore(path, tenant="w-b")
    a.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    b.add(fps["b"], seqs[2], pct50_us=12.0, vs_naive=1.5)
    barrier = threading.Barrier(2)
    errors = []

    def go(store):
        try:
            barrier.wait(timeout=30)
            store.flush()
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    ts = [threading.Thread(target=go, args=(s,)) for s in (a, b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not errors
    merged = SegmentedStore(path)
    assert len(merged) == 2
    assert merged.orphan_segments == []


# -- damage --------------------------------------------------------------------

def _warmed(tmp_path, spmv, name="seg", cls=SegmentedStore, fps_=None):
    _, fps, seqs = spmv
    fps = fps_ or fps
    s = cls(str(tmp_path / name))
    s.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0, verified=True)
    s.add(fps["a"], seqs[2], pct50_us=11.0, vs_naive=1.8, verified=True)
    s.add(fps["b"], seqs[3], pct50_us=9.0, vs_naive=2.2, verified=True)
    s.flush()
    return s


def test_truncated_segment_salvages_prefix_and_quarantines(tmp_path, spmv):
    s = _warmed(tmp_path, spmv)
    (name,) = _seg_files(s.dir)
    path = os.path.join(s.dir, "segments", name)
    text = open(path).read()
    open(path, "w").write(text[:int(len(text) * 0.8)])  # a torn append
    notes = []
    loaded = SegmentedStore(s.dir, log=notes.append)
    assert len(loaded) == 2 and loaded.salvaged == 2
    assert loaded.quarantined_segments == [name]
    assert len([n for n in os.listdir(os.path.join(s.dir, "segments"))
                if ".corrupt-" in n]) == 1
    assert any("quarantined damaged segment" in n for n in notes)
    loaded.flush()  # the salvage is written again
    final = SegmentedStore(s.dir)
    assert len(final) == 2 and final.quarantined_segments == []


def test_bitflipped_record_checksum_catches_it(tmp_path, spmv):
    s = _warmed(tmp_path, spmv)
    (name,) = _seg_files(s.dir)
    path = os.path.join(s.dir, "segments", name)
    lines = open(path).read().splitlines()
    assert '"pct50_us": 11.0' in lines[2]
    lines[2] = lines[2].replace("11.0", "71.0", 1)  # still JSON
    open(path, "w").write("\n".join(lines) + "\n")
    loaded = SegmentedStore(s.dir, log=lambda m: None)
    assert loaded.checksum_failed == 1
    assert len(loaded) == 2
    assert loaded.quarantined_segments == [name]


def test_torn_manifest_recovers_by_scan(tmp_path, spmv):
    s = _warmed(tmp_path, spmv)
    man = os.path.join(s.dir, "manifest.json")
    open(man, "w").write('{"version": 1, "segments": {tor')
    notes = []
    loaded = SegmentedStore(s.dir, log=notes.append)
    assert len(loaded) == 3  # the scan is the truth
    assert not os.path.exists(man)
    assert [n for n in os.listdir(s.dir) if "manifest.json.corrupt-" in n]
    assert any("recovering from segment scan" in n for n in notes)
    summary = Compactor(s.dir, log=lambda m: None).run()
    assert summary["orphans_adopted"] + summary["buckets_compacted"] > 0
    again = SegmentedStore(s.dir)
    assert len(again) == 3 and again.orphan_segments == []


def test_readonly_load_reports_damage_without_touching(tmp_path, spmv):
    """``quarantine_corrupt=False`` (and fsck, which loads so) leaves a
    damaged tree byte for byte as it was while still reading its records."""
    from tenzing_tpu_torch.serve import dr

    s = _warmed(tmp_path, spmv)
    (name,) = _seg_files(s.dir)
    seg_path = os.path.join(s.dir, "segments", name)
    text = open(seg_path).read()
    open(seg_path, "w").write(text[:int(len(text) * 0.8)])
    open(os.path.join(s.dir, "manifest.json"), "w").write("{torn")
    before = _tree(s.dir)
    ro = SegmentedStore(s.dir, log=[].append, quarantine_corrupt=False)
    assert len(ro) == 2  # salvaged in memory only
    assert _tree(s.dir) == before
    doc = dr.fsck_store(s.dir, check_backups=False)
    assert doc["rc"] == dr.RC_DAMAGED and doc["records"] == 2
    assert _tree(s.dir) == before


# -- compaction ----------------------------------------------------------------

def test_compactor_merges_reclaims_and_ledgers(tmp_path, spmv):
    _, fps, seqs = spmv
    s = SegmentedStore(str(tmp_path / "seg"))
    for fp, seq, pct, vs in [(fps["a"], seqs[1], 10.0, 2.0),
                             (fps["a"], seqs[2], 11.0, 1.8),
                             (fps["b"], seqs[3], 9.0, 2.2)]:
        s.add(fp, seq, pct50_us=pct, vs_naive=vs)
        s.flush()  # a segment a flush: a bucket of several
    assert len(_seg_files(s.dir)) == 3
    before = _records_doc(SegmentedStore(s.dir))
    summary = Compactor(s.dir, log=lambda m: None).run()
    assert summary["buckets_compacted"] == 1  # a and b share one bucket
    assert summary["segments_reclaimed"] == 3
    assert summary["skipped"] is None
    files = _seg_files(s.dir)
    assert len(files) == 1
    after = SegmentedStore(s.dir)
    assert _records_doc(after) == before
    ledger = after.manifest_doc["compactions"]
    assert ledger[-1]["output"] == files[0] and len(ledger[-1]["inputs"]) == 3


def test_compactor_lease_excludes_rivals(tmp_path, spmv):
    s = _warmed(tmp_path, spmv)
    rival = LeaseFile(os.path.join(s.dir, "compact.lease"), "rival",
                      ttl_secs=300.0)
    assert rival.claim() is not None
    summary = Compactor(s.dir, log=lambda m: None).run()
    assert summary["skipped"] == "lease-held"
    assert summary["buckets_compacted"] == 0
    rival.release()
    assert Compactor(s.dir, log=lambda m: None).run()["skipped"] is None


def _compact_cli(store_dir, *extra):
    return subprocess.run(
        [sys.executable, "-m", "tenzing_tpu_torch.serve", "compact",
         "--store", store_dir, "--lease-ttl", "0.2", *extra],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))


@pytest.mark.parametrize("window", ["segment", "manifest"])
def test_mid_compaction_sigkill_recovers_to_superset(tmp_path, spmv,
                                                     window):
    """``kill -9`` in either window (after the merged segment, before the
    manifest; after the manifest, before the reclaim): every record before
    the kill survives with a valid checksum, and the next compaction
    converges the tree."""
    _, fps, seqs = spmv
    s = SegmentedStore(str(tmp_path / f"seg-{window}"))
    for fp, seq, pct, vs in [(fps["a"], seqs[1], 10.0, 2.0),
                             (fps["a"], seqs[2], 11.0, 1.8),
                             (fps["c"], seqs[3], 9.0, 2.2)]:
        s.add(fp, seq, pct50_us=pct, vs_naive=vs)
        s.flush()
    before = _records_doc(SegmentedStore(s.dir))
    r = _compact_cli(s.dir, "--crash-after", window)
    assert r.returncode == -9, (r.returncode, r.stderr[-500:])
    crashed = SegmentedStore(s.dir, log=[].append)
    assert _records_doc(crashed) == before
    assert crashed.checksum_failed == 0
    assert crashed.quarantined_segments == []
    time.sleep(0.25)  # the dead compactor's lease expires
    r2 = _compact_cli(s.dir)
    assert r2.returncode == 0, r2.stderr[-500:]
    final = SegmentedStore(s.dir)
    assert _records_doc(final) == before
    assert final.orphan_segments == []
    buckets = {segment_bucket_of(n) for n in _seg_files(s.dir)}
    assert len(_seg_files(s.dir)) == len(buckets) == 2


def test_compactor_never_reclaims_unseen_rival_segment(tmp_path, spmv,
                                                       monkeypatch):
    """A segment a live writer published after the compactor loaded the
    store survives the pass: the merge and reclaim sets are the loaded
    segments, never a fresh scan."""
    import tenzing_tpu_torch.serve.segments as segments

    _, fps, seqs = spmv
    path = str(tmp_path / "seg")
    s = SegmentedStore(path)
    s.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    s.flush()
    s.add(fps["a"], seqs[2], pct50_us=11.0, vs_naive=1.8)
    s.flush()
    real_flush = segments.SegmentedStore.flush
    fired = {}

    def flush_with_rival(self):
        if not fired and self.tenant == "compactor":
            fired["x"] = True
            rival = SegmentedStore(path, tenant="rival")
            rival.add(fps["b"], seqs[3], pct50_us=9.0, vs_naive=2.2)
            real_flush(rival)
        return real_flush(self)

    monkeypatch.setattr(segments.SegmentedStore, "flush", flush_with_rival)
    summary = Compactor(path, log=lambda m: None).run()
    assert summary["buckets_compacted"] == 1
    final = SegmentedStore(path)
    assert final.best(fps["b"].exact_digest) is not None
    assert final.best(fps["a"].exact_digest)["vs_naive"] == 2.0


# -- the admission stamp's merge, the digest, the lease -------------------------

def test_admission_stamp_merges_sticky_both_orders():
    base = {"schema": RECORD_SCHEMA, "exact": "e", "bucket": "b",
            "key": "k", "ops": [], "workload": "spmv", "vs_naive": 2.0,
            "pct50_us": 10.0, "sources": [], "flags": {}}
    stamped = dict(base, verified_at_admission=True)
    for m in (merge_records(stamped, dict(base)),
              merge_records(dict(base), stamped)):
        assert m["verified_at_admission"] is True
    assert "verified_at_admission" not in merge_records(dict(base),
                                                        dict(base))


def test_record_digest_canonical():
    a = {"x": 1, "y": [1, 2]}
    assert record_digest({"y": [1, 2], "x": 1}) == record_digest(a)
    assert record_digest({"x": 2, "y": [1, 2]}) != record_digest(a)
    for rec in (a, {}, {"u": "ü", "f": 1.5, "n": None, "l": [{"k": 1}]}):
        assert record_digest(rec) == ref_segments.record_digest(rec)


def test_lease_file_protocol(tmp_path):
    path = str(tmp_path / "x.lease")
    a = LeaseFile(path, "a", ttl_secs=300.0)
    b = LeaseFile(path, "b", ttl_secs=300.0)
    info = a.claim()
    assert info is not None and info.reclaimed is False
    assert b.claim() is None
    assert a.owns() and a.renew()
    past = os.path.getmtime(path) - 1000
    os.utime(path, (past, past))
    info_b = b.claim()
    assert info_b is not None and info_b.reclaimed is True
    assert info_b.prev_owner == "a"
    assert a.renew() is False
    a.release()  # never deletes b's live lease
    assert os.path.exists(path) and b.owns()
    assert b.release() is True
    assert not os.path.exists(path)


# -- across the packages ----------------------------------------------------------

def test_segment_lines_and_headers_are_the_references(tmp_path, spmv):
    """The same records flushed by each package: every record line is the
    reference's byte for byte, and the headers differ only in their stamp
    and owner."""
    port = _warmed(tmp_path, spmv, "port")
    ref = ref_segments.SegmentedStore(str(tmp_path / "ref"))
    ref.merge_from(port)
    ref.flush()
    (pn,), (rn,) = _seg_files(port.dir), _seg_files(ref.dir)
    assert segment_bucket_of(pn) == ref_segments.segment_bucket_of(rn)
    pl = open(os.path.join(port.dir, "segments", pn)).read().splitlines()
    rl = open(os.path.join(ref.dir, "segments", rn)).read().splitlines()
    assert sorted(pl[1:]) == sorted(rl[1:])
    ph, rh = json.loads(pl[0]), json.loads(rl[0])
    for h in (ph, rh):
        h.pop("created_at"), h.pop("owner")
    assert ph == rh
    assert set(json.load(open(os.path.join(port.dir, "manifest.json")))) \
        == set(json.load(open(os.path.join(ref.dir, "manifest.json"))))


def test_a_store_either_package_wrote_loads_in_the_other(tmp_path, spmv):
    from tenzing_tpu.bench.driver import DriverRequest as RefRequest
    from tenzing_tpu.serve.fingerprint import fingerprint_of as ref_fp

    port = _warmed(tmp_path, spmv, "port")
    ref_fps = {k: ref_fp(RefRequest(workload="spmv", m=m))
               for k, m in (("a", 512), ("b", 500))}
    ref = _warmed(tmp_path, spmv, "ref", cls=ref_segments.SegmentedStore,
                  fps_=ref_fps)
    for d in (port.dir, ref.dir):
        p = SegmentedStore(d)
        r = ref_segments.SegmentedStore(d)
        assert _records_doc(p) == _records_doc(r)
        assert len(p) == 3 and p.checksum_failed == r.checksum_failed == 0
        assert p.orphan_segments == r.orphan_segments == []
        assert p.stats()["segments"] == r.stats()["segments"]
    # the reference's fingerprint names no platform: its records answer
    # neither exact nor near on the card's
    from tenzing_tpu_torch.serve.resolver import Resolver

    res = Resolver(SegmentedStore(ref.dir), platform="cuda").resolve(
        DriverRequest(workload="spmv", m=512))
    assert res.tier == "cold"


def test_either_compactor_converges_a_tree_both_wrote(tmp_path, spmv):
    """Segments of both packages in one directory: the reference's
    compactor, then the port's, each leave one segment a bucket and the
    union of the records, every checksum valid in the other."""
    _, fps, seqs = spmv
    d = str(tmp_path / "mixed")
    p = SegmentedStore(d)
    p.add(fps["a"], seqs[1], pct50_us=10.0, vs_naive=2.0)
    p.flush()
    r = ref_segments.SegmentedStore(d)
    r.merge_from(_warmed(tmp_path, spmv, "src"))
    r.flush()
    p.add(fps["c"], seqs[2], pct50_us=7.0, vs_naive=3.0)
    p.flush()
    before = _records_doc(SegmentedStore(d))
    assert ref_segments.Compactor(d, log=lambda m: None).run()[
        "buckets_compacted"] == 1
    assert _records_doc(SegmentedStore(d)) == before
    p2 = SegmentedStore(d)
    p2.add(fps["c"], seqs[3], pct50_us=6.0, vs_naive=3.5)
    p2.flush()
    Compactor(d, log=lambda m: None).run()
    final = ref_segments.SegmentedStore(d)
    assert final.checksum_failed == 0 and final.orphan_segments == []
    assert len(_seg_files(d)) == len({segment_bucket_of(n)
                                      for n in _seg_files(d)}) == 2
    assert len(final) == len(SegmentedStore(d)) == 5
