"""The port's disaster recovery (tenzing_tpu_torch/serve/dr.py) against the
JAX package's (tenzing_tpu/serve/dr.py; reference tests test_serve_dr.py),
test for test: backup, loss and restore give the store back byte for byte,
a restore into a live store keeps both sides, a tampered generation is
refused without ``--force``, fsck's exit codes (clean, damaged,
unreadable) with adoption its only write, and the CLI's round trip.  Then
across the packages: a generation either wrote restores in the other, and
fsck gives the same verdict in both on the same trees, monolithic ones
included.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tenzing_tpu.serve import dr as ref_dr
from tenzing_tpu.serve.segments import SegmentedStore as RefSegmentedStore
from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
from tenzing_tpu_torch.serve import dr
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of
from tenzing_tpu_torch.serve.segments import SegmentedStore
from tenzing_tpu_torch.serve.store import ScheduleStore, open_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def spmv():
    """(graph, fingerprints, sequences): the neighbourhood of
    tests/test_torch_serve_segments.py."""
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
        "c": fingerprint_of(DriverRequest(workload="spmv", m=100000)),
    }
    seqs = [drive(p) for p in ([0], [1, 2, 0], [2, 1, 0])]
    return g, fps, seqs


def _seed_store(store_dir, spmv, keys=("a", "b")):
    _, fps, seqs = spmv
    s = SegmentedStore(str(store_dir))
    for i, k in enumerate(keys):
        s.add(fps[k], seqs[i % len(seqs)], pct50_us=10.0 + i,
              vs_naive=2.0, verified=True)
    s.flush()
    return s


def _tree_bytes(store_dir):
    """rel-path -> content of every store file (segments and manifest)."""
    out = {}
    for root, _dirs, names in os.walk(store_dir):
        for n in names:
            p = os.path.join(root, n)
            rel = os.path.relpath(p, store_dir)
            if rel.startswith("backups") or rel.endswith(".lock"):
                continue  # lock files are lease artifacts, not content
            with open(p, "rb") as f:
                out[rel] = f.read()
    return out


def _one_segment(store_dir):
    segdir = os.path.join(str(store_dir), "segments")
    return os.path.join(segdir, sorted(
        n for n in os.listdir(segdir) if n.endswith(".jsonl"))[0])


def _records(store):
    return sorted(json.dumps(r, sort_keys=True) for r in store.records())


# -- the round trip ---------------------------------------------------------------

def test_backup_rm_restore_byte_identical(tmp_path, spmv):
    store = tmp_path / "store"
    _seed_store(store, spmv)
    before = _tree_bytes(store)
    cat = dr.backup_store(str(store), out_dir=str(tmp_path / "bk"))
    assert cat["n_files"] == len(cat["files"]) >= 2  # segments + manifest
    assert cat["captured"]["linked"] >= 1  # one filesystem: hard links
    shutil.rmtree(store)
    out = dr.restore_store(str(store), cat["generation"])
    assert out["mode"] == "verbatim"
    assert _tree_bytes(store) == before
    doc = dr.fsck_store(str(store), check_backups=False)
    assert doc["ok"] and doc["rc"] == dr.RC_CLEAN and doc["records"] == 2


def test_merge_restore_is_a_superset_of_both_sides(tmp_path, spmv):
    """A restore into a live store: records written after the snapshot
    survive, records lost since come back."""
    _, fps, seqs = spmv
    store = tmp_path / "store"
    _seed_store(store, spmv, keys=("a",))
    cat = dr.backup_store(str(store), out_dir=str(tmp_path / "bk"))
    live = SegmentedStore(str(store))
    live.add(fps["b"], seqs[1], pct50_us=5.0, vs_naive=3.0, verified=True)
    live.flush()
    out = dr.restore_store(str(store), cat["generation"])
    assert out["mode"] == "merge"
    after = open_store(str(store))
    assert after.best(fps["a"].exact_digest) is not None
    assert after.best(fps["b"].exact_digest) is not None


# -- tampering and refusal -----------------------------------------------------------

def test_tampered_generation_refused_without_force(tmp_path, spmv):
    store = tmp_path / "store"
    _seed_store(store, spmv)
    cat = dr.backup_store(str(store), out_dir=str(tmp_path / "bk"))
    gen = cat["generation"]
    # a segment is captured by hard link: rewrite a copy, so the damage
    # stays inside the generation
    victim = os.path.join(gen, sorted(
        rel for rel in cat["files"] if rel.endswith(".jsonl"))[0])
    blob = open(victim, "rb").read()
    os.unlink(victim)
    with open(victim, "wb") as f:
        f.write(blob[:-7] + b"garbage")
    verdict = dr.verify_backup(gen)
    assert not verdict["ok"] and verdict["mismatched"]
    shutil.rmtree(store)
    with pytest.raises(dr.DrError):
        dr.restore_store(str(store), gen)
    out = dr.restore_store(str(store), gen, force=True)
    assert out["damaged_skipped"]  # reported, not dropped in silence


def test_generation_without_catalog_is_an_aborted_backup(tmp_path):
    gen = tmp_path / "bk" / "gen-123-1"
    os.makedirs(gen / "segments")
    with pytest.raises(dr.DrError):
        dr.load_catalog(str(gen))
    with pytest.raises(dr.DrError):
        dr.restore_store(str(tmp_path / "store"), str(gen))


# -- fsck ----------------------------------------------------------------------------

def test_fsck_exit_codes_clean_damaged_unreadable(tmp_path, spmv):
    store = tmp_path / "store"
    _seed_store(store, spmv)
    assert dr.fsck_store(str(store), check_backups=False)["rc"] == \
        dr.RC_CLEAN
    seg = _one_segment(store)
    blob = bytearray(open(seg, "rb").read())
    blob[len(blob) // 2] ^= 0xFF  # a flipped byte in a record line
    with open(seg, "wb") as f:
        f.write(blob)
    doc = dr.fsck_store(str(store), check_backups=False)
    assert doc["rc"] == dr.RC_DAMAGED and doc["errors"]
    assert dr.fsck_store(str(tmp_path / "nope"),
                         check_backups=False)["rc"] == dr.RC_UNREADABLE


def test_fsck_adopts_orphan_segments(tmp_path, spmv):
    """A published segment the manifest does not list (its writer died
    between the two) warns read-only and joins the manifest under
    ``--adopt``, fsck's only write."""
    _, fps, seqs = spmv
    store = tmp_path / "store"
    _seed_store(store, spmv, keys=("a",))
    donor = tmp_path / "donor"
    d = SegmentedStore(str(donor))
    d.add(fps["c"], seqs[2], pct50_us=7.0, vs_naive=4.0, verified=True)
    d.flush()
    shutil.copy2(_one_segment(donor),
                 os.path.join(str(store), "segments",
                              os.path.basename(_one_segment(donor))))
    doc = dr.fsck_store(str(store), check_backups=False)
    assert doc["orphan_segments"] and doc["rc"] == dr.RC_CLEAN
    doc = dr.fsck_store(str(store), adopt=True, check_backups=False)
    assert doc["adopted_orphans"]
    assert not dr.fsck_store(str(store),
                             check_backups=False)["orphan_segments"]
    assert open_store(str(store)).best(fps["c"].exact_digest) is not None


def test_fsck_stamp_feeds_report_follow(tmp_path, spmv):
    store = tmp_path / "store"
    _seed_store(store, spmv)
    dr.fsck_store(str(store), stamp=True, check_backups=False)
    doc = json.load(open(os.path.join(str(store), dr.FSCK_STAMP)))
    assert doc["kind"] == "fsck" and doc["ok"] and doc["rc"] == 0


# -- the CLI --------------------------------------------------------------------------

def test_serve_cli_backup_restore_fsck_round_trip(tmp_path, spmv):
    """``serve backup``, then ``serve restore`` (the latest generation by
    default), then ``serve fsck`` exiting 0."""
    store = tmp_path / "store"
    _seed_store(store, spmv)
    env = dict(os.environ, PYTHONPATH=REPO)

    def serve(*argv):
        return subprocess.run(
            [sys.executable, "-m", "tenzing_tpu_torch.serve", *argv],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)

    # --out: the default root of generations is inside the store, and this
    # drill loses the store
    p = serve("backup", "--store", str(store), "--out", str(tmp_path / "bk"))
    assert p.returncode == 0, p.stderr
    shutil.rmtree(store)
    p = serve("restore", "--store", str(store), "--out", str(tmp_path / "bk"))
    assert p.returncode == 0, p.stderr
    p = serve("fsck", "--store", str(store), "--stamp", "--no-backups")
    assert p.returncode == 0, p.stderr
    assert json.load(open(os.path.join(str(store), dr.FSCK_STAMP)))["ok"]
    p = serve("restore", "--store", str(tmp_path / "other"))
    assert p.returncode == 2 and "no backup generations" in p.stderr


# -- across the packages ----------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_generation_either_wrote_restores_in_the_other(tmp_path, spmv,
                                                         writer):
    """Backup by one package, loss, restore by the other: the same bytes
    come back, both catalogs carry the same keys, and a merge-restore by the
    other keeps the records written after the snapshot."""
    _, fps, seqs = spmv
    backup, restore = ((dr, ref_dr) if writer == "port" else (ref_dr, dr))
    store = tmp_path / "store"
    _seed_store(store, spmv)
    before = _tree_bytes(store)
    cat = backup.backup_store(str(store), out_dir=str(tmp_path / "bk"))
    assert restore.verify_backup(cat["generation"])["ok"]
    shutil.rmtree(store)
    assert restore.restore_store(str(store), cat["generation"])["mode"] == \
        "verbatim"
    assert _tree_bytes(store) == before
    live = SegmentedStore(str(store))
    live.add(fps["c"], seqs[2], pct50_us=5.0, vs_naive=3.0, verified=True)
    live.flush()
    out = restore.restore_store(str(store), cat["generation"])
    assert out["mode"] == "merge" and out["records_after"] == 3
    other = ref_dr.backup_store(str(store), out_dir=str(tmp_path / "bk2")) \
        if writer == "port" else dr.backup_store(
            str(store), out_dir=str(tmp_path / "bk2"))
    assert set(cat) == set(other)
    assert _records(SegmentedStore(str(store))) == \
        _records(RefSegmentedStore(str(store)))


def _verdict(doc):
    out = dict(doc)
    out.pop("checked_at")
    return out


def test_fsck_verdicts_are_the_references(tmp_path, spmv):
    """The same trees, one after another damaged: fsck of either package
    reports the same document and exit code (less its clock)."""
    _, fps, seqs = spmv
    store = tmp_path / "store"
    _seed_store(store, spmv)
    dr.backup_store(str(store))  # a generation in the default root
    mono = ScheduleStore(str(tmp_path / "mono.json"))
    mono.add(fps["a"], seqs[1], pct50_us=3.0, vs_naive=2.0, verified=True)
    mono.flush()

    def both(path, **kw):
        p, r = dr.fsck_store(path, **kw), ref_dr.fsck_store(path, **kw)
        assert _verdict(p) == _verdict(r)
        assert p["rc"] == dr.fsck_exit_code(p) == ref_dr.fsck_exit_code(r)
        return p

    assert both(str(store))["rc"] == dr.RC_CLEAN
    assert both(str(tmp_path / "mono.json"))["rc"] == dr.RC_CLEAN
    assert both(str(tmp_path / "absent"))["rc"] == dr.RC_UNREADABLE
    assert both(str(tmp_path / "absent.json"))["rc"] == dr.RC_UNREADABLE
    # an orphan, then a flipped byte, then a listed segment gone
    d = SegmentedStore(str(tmp_path / "donor"))
    d.add(fps["c"], seqs[2], pct50_us=7.0, vs_naive=4.0, verified=True)
    d.flush()
    shutil.copy2(_one_segment(tmp_path / "donor"), os.path.join(
        str(store), "segments", os.path.basename(_one_segment(
            tmp_path / "donor"))))
    assert both(str(store))["orphan_segments"]
    seg = _one_segment(store)
    blob = bytearray(open(seg, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(seg, "wb") as f:
        f.write(blob)
    assert both(str(store))["rc"] == dr.RC_DAMAGED
    listed = json.load(open(os.path.join(str(store), "manifest.json")))
    os.unlink(os.path.join(str(store), "segments",
                           sorted(listed["segments"])[0]))
    doc = both(str(store), check_backups=False)
    assert doc["missing_segments"] and doc["rc"] == dr.RC_DAMAGED
    with open(tmp_path / "mono.json", "w") as f:
        f.write("{torn")
    assert both(str(tmp_path / "mono.json"))["rc"] == dr.RC_UNREADABLE
