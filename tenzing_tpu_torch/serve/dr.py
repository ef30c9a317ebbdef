"""Disaster recovery for the serving plane: ``serve backup``, ``serve
restore``, ``serve fsck``.

Counterpart of ``tenzing_tpu/serve/dr.py``, the same generation layout,
catalog and verdicts: a generation either package wrote restores in the
other, and fsck of one store reads the same in both.  The segmented store
survives torn writes, bit flips and ``kill -9`` (serve/segments.py); it
cannot survive the disk itself (an ``rm -rf``, a dead volume).  Three
tools close that gap:

* **backup** — one point-in-time generation under
  ``<store>/backups/gen-<stamp>-<pid>/`` (or ``--out`` elsewhere).  Sealed
  segments are immutable (writers only publish new files and unlink old
  ones), so a backup hard-links them — no bytes copied on one filesystem;
  a copy where a link is impossible, another filesystem for ``--out`` —
  and copies the manifest's bytes.  A ``catalog.json`` with each captured
  file's sha256 is published last: a generation without a catalog is an
  aborted backup, and restore refuses it.  A compactor that reclaims a
  segment during the snapshot published its output first, which one more
  listing picks up: the captured set is always a superset of some
  instant's acknowledged records.
* **restore** — catalog-verified first.  Into an empty or absent store the
  generation's files come back verbatim, byte for byte.  Into a live store
  it merges through the store's commutative
  :func:`~tenzing_tpu_torch.serve.store.merge_records`: records written
  after the snapshot survive, records lost since come back, nothing is
  overwritten.
* **fsck** — a deep, read-only walk: every record's sha256 checked again
  against its segment line (the loader's salvage with
  ``quarantine_corrupt=False``: report, never move the evidence), the
  manifest against the disk (orphans, missing segments), a census of
  quarantined ``*.corrupt-*`` files, stale temp files and backup
  generations.  ``--adopt`` also indexes orphan segments into the manifest
  (its only write); ``--stamp`` writes the verdict to ``<store>/fsck.json``.
  Exit codes: 0 clean, 1 damage found, 2 unreadable.

Both store backends are covered: a ``*.json`` path is the monolithic store
(its backup a checksummed link or copy), anything else the segmented
directory.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

from tenzing_tpu_torch.serve.segments import (
    MANIFEST_NAME,
    SEGMENTS_DIR,
    SegmentedStore,
    is_segment_name,
)
from tenzing_tpu_torch.serve.store import (
    STORE_VERSION,
    ScheduleStore,
    file_digest,
    open_store,
    store_readonly,
)
from tenzing_tpu_torch.utils.atomic import atomic_dump_json, fsync_dir

BACKUPS_DIR = "backups"
CATALOG_NAME = "catalog.json"
CATALOG_VERSION = 1
FSCK_STAMP = "fsck.json"
FSCK_VERSION = 1
# the compactor's publish strictly precedes its reclaim, so one
# re-list after a vanished link target always finds the output — the
# bound is paranoia, not protocol
SNAPSHOT_PASSES = 5

RC_CLEAN = 0
RC_DAMAGED = 1
RC_UNREADABLE = 2


class DrError(RuntimeError):
    """A backup/restore precondition failed (missing generation, torn
    catalog, checksum mismatch): the operation refused to run — exit 2,
    never a half-applied restore."""


def _is_monolithic(store_path: str) -> bool:
    return store_path.endswith(".json") and not os.path.isdir(store_path)


def backups_root(store_path: str) -> str:
    """Where a store's generations live by default: inside the store
    directory (the segment scan only reads ``segments/``, so backups
    are invisible to loads) or next to a monolithic file."""
    if _is_monolithic(store_path):
        return os.path.abspath(store_path) + ".backups"
    return os.path.join(store_path, BACKUPS_DIR)


def list_generations(root: str) -> List[str]:
    try:
        return sorted(n for n in os.listdir(root)
                      if n.startswith("gen-")
                      and os.path.isdir(os.path.join(root, n)))
    except OSError:
        return []


def latest_generation(root: str) -> Optional[str]:
    gens = list_generations(root)
    return os.path.join(root, gens[-1]) if gens else None


def _link_or_copy(src: str, dst: str) -> str:
    """Hard-link (same filesystem: O(1), and sealed segments are
    immutable so sharing the inode is safe) with a byte-copy fallback
    for ``--out`` on another device."""
    try:
        os.link(src, dst)
        return "linked"
    except FileExistsError:
        return "linked"
    except OSError:
        shutil.copy2(src, dst)
        return "copied"


# -- backup ------------------------------------------------------------------

def backup_store(store_path: str, out_dir: Optional[str] = None,
                 note: str = "",
                 log: Optional[Callable[[str], None]] = None
                 ) -> Dict[str, Any]:
    """One point-in-time generation (module docstring).  Returns the
    catalog doc plus the generation path; raises :class:`DrError` when
    there is nothing to back up."""
    store_path = os.path.abspath(store_path)
    root = out_dir or backups_root(store_path)
    gen_name = f"gen-{int(time.time() * 1e6)}-{os.getpid()}"
    gen_dir = os.path.join(root, gen_name)
    files: Dict[str, Dict[str, Any]] = {}
    captured = {"linked": 0, "copied": 0}

    if _is_monolithic(store_path):
        if not os.path.exists(store_path):
            raise DrError(f"nothing to back up: {store_path} is absent")
        os.makedirs(gen_dir, exist_ok=True)
        dst = os.path.join(gen_dir, "store.json")
        # a monolithic store is REPLACED atomically, never appended:
        # the link captures exactly one published version
        captured[_link_or_copy(store_path, dst)] += 1
        files["store.json"] = {"sha256": file_digest(dst),
                               "bytes": os.path.getsize(dst)}
        backend = "monolithic"
    else:
        seg_src = os.path.join(store_path, SEGMENTS_DIR)
        if not os.path.isdir(store_path):
            raise DrError(f"nothing to back up: {store_path} is absent")
        seg_dst = os.path.join(gen_dir, SEGMENTS_DIR)
        os.makedirs(seg_dst, exist_ok=True)
        done: set = set()
        for _pass in range(SNAPSHOT_PASSES):
            vanished = 0
            try:
                names = sorted(n for n in os.listdir(seg_src)
                               if is_segment_name(n))
            except OSError:
                names = []
            for name in names:
                if name in done:
                    continue
                src = os.path.join(seg_src, name)
                try:
                    how = _link_or_copy(src, os.path.join(seg_dst, name))
                except OSError:
                    # reclaimed between listdir and link: the
                    # compactor's published output shows up on re-list
                    vanished += 1
                    continue
                done.add(name)
                captured[how] += 1
            if not vanished:
                break
            if log:
                log(f"backup: {vanished} segment(s) reclaimed "
                    "mid-snapshot; re-listing")
        for name in sorted(done):
            dst = os.path.join(seg_dst, name)
            files[f"{SEGMENTS_DIR}/{name}"] = {
                "sha256": file_digest(dst),
                "bytes": os.path.getsize(dst)}
        man_src = os.path.join(store_path, MANIFEST_NAME)
        if os.path.exists(man_src):
            man_dst = os.path.join(gen_dir, MANIFEST_NAME)
            # manifests mutate (atomic replace): byte-copy the snapshot
            # instead of sharing the inode
            shutil.copy2(man_src, man_dst)
            files[MANIFEST_NAME] = {"sha256": file_digest(man_dst),
                                    "bytes": os.path.getsize(man_dst)}
        fsync_dir(seg_dst)
        backend = "segmented"

    catalog = {
        "kind": "backup", "version": CATALOG_VERSION,
        "created_at": time.time(), "store": store_path,
        "backend": backend, "note": note,
        "n_files": len(files),
        "bytes": sum(f["bytes"] for f in files.values()),
        "captured": captured,
        "files": files,
    }
    # published LAST: a generation without a catalog is an aborted
    # backup, and restore refuses it
    atomic_dump_json(os.path.join(gen_dir, CATALOG_NAME), catalog,
                     prefix=".catalog.")
    fsync_dir(gen_dir)
    if log:
        log(f"backup: {gen_name}: {len(files)} file(s), "
            f"{catalog['bytes']} bytes ({captured['linked']} linked, "
            f"{captured['copied']} copied)")
    return dict(catalog, generation=gen_dir)


def load_catalog(gen_dir: str) -> Dict[str, Any]:
    path = os.path.join(gen_dir, CATALOG_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise DrError(f"generation {gen_dir}: no readable catalog "
                      f"({e}) — aborted backup?") from e
    if not isinstance(doc, dict) or doc.get("kind") != "backup" or \
            not isinstance(doc.get("files"), dict):
        raise DrError(f"generation {gen_dir}: catalog is not a backup "
                      "catalog")
    if doc.get("version", 0) > CATALOG_VERSION:
        raise DrError(f"generation {gen_dir}: catalog version "
                      f"{doc.get('version')!r} > {CATALOG_VERSION}")
    return doc


def verify_backup(gen_dir: str) -> Dict[str, Any]:
    """Deep-check one generation against its catalog: every captured
    file present with matching sha256/size.  Returns a verdict doc
    (never raises on damage — the caller decides)."""
    cat = load_catalog(gen_dir)
    missing: List[str] = []
    mismatched: List[str] = []
    for rel, meta in sorted(cat["files"].items()):
        path = os.path.join(gen_dir, rel)
        if not os.path.exists(path):
            missing.append(rel)
            continue
        try:
            if file_digest(path) != meta.get("sha256"):
                mismatched.append(rel)
        except OSError:
            missing.append(rel)
    return {"generation": gen_dir, "checked": len(cat["files"]),
            "missing": missing, "mismatched": mismatched,
            "ok": not missing and not mismatched,
            "catalog": cat}


# -- restore -----------------------------------------------------------------

def _store_is_empty(store_path: str) -> bool:
    if _is_monolithic(store_path):
        return not os.path.exists(store_path)
    if not os.path.isdir(store_path):
        return True
    if os.path.exists(os.path.join(store_path, MANIFEST_NAME)):
        return False
    try:
        seg = os.listdir(os.path.join(store_path, SEGMENTS_DIR))
    except OSError:
        return True
    return not any(is_segment_name(n) for n in seg)


def restore_store(store_path: str, gen_dir: str, force: bool = False,
                  log: Optional[Callable[[str], None]] = None
                  ) -> Dict[str, Any]:
    """Point-in-time restore (module docstring): catalog-verified
    first; verbatim into an empty store (byte-identical with the
    snapshot), commutative merge-restore into a live one (superset of
    both sides).  ``force`` restores from a generation that fails
    verification — the intact files still restore; the damaged ones
    are reported, not silently skipped."""
    store_path = os.path.abspath(store_path)
    verdict = verify_backup(gen_dir)
    damaged = sorted(set(verdict["missing"]) | set(verdict["mismatched"]))
    if not verdict["ok"] and not force:
        raise DrError(
            f"generation {gen_dir} fails verification "
            f"(missing {verdict['missing']!r}, mismatched "
            f"{verdict['mismatched']!r}); --force restores the intact "
            "files anyway")
    cat = verdict["catalog"]
    intact = [rel for rel in sorted(cat["files"])
              if rel not in damaged]

    if _store_is_empty(store_path):
        # verbatim: link/copy the generation back — byte-identical
        restored = 0
        for rel in intact:
            dst = os.path.join(store_path, rel) \
                if not _is_monolithic(store_path) \
                else store_path
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            _link_or_copy(os.path.join(gen_dir, rel), dst)
            restored += 1
        if not _is_monolithic(store_path):
            fsync_dir(os.path.join(store_path, "segments"))
            fsync_dir(store_path)
        if log:
            log(f"restore: {restored} file(s) restored verbatim into "
                f"empty store {store_path}")
        return {"kind": "restore", "mode": "verbatim",
                "generation": gen_dir, "store": store_path,
                "files_restored": restored, "records_merged": None,
                "damaged_skipped": damaged}

    # live store: merge-restore through the commutative record algebra
    if _is_monolithic(store_path):
        src = open_store(os.path.join(gen_dir, "store.json"),
                         quarantine_corrupt=False, _count_metrics=False)
    else:
        # the generation IS a store layout (segments/ + manifest.json)
        src = open_store(gen_dir, quarantine_corrupt=False,
                         _count_metrics=False)
    dest = open_store(store_path)
    n = dest.merge_from(src)
    dest.flush()
    if log:
        log(f"restore: merged {n} snapshot record(s) into live store "
            f"{store_path} (superset-safe)")
    return {"kind": "restore", "mode": "merge",
            "generation": gen_dir, "store": store_path,
            "files_restored": None, "records_merged": n,
            "records_after": len(dest), "damaged_skipped": damaged}


# -- fsck --------------------------------------------------------------------

def _census(directory: str) -> Dict[str, List[str]]:
    """Quarantine/dropping census of one directory (non-recursive)."""
    out: Dict[str, List[str]] = {"quarantined": [], "tmp": []}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if ".corrupt-" in name:
            out["quarantined"].append(name)
        elif name.startswith(".") and not name.startswith(".."):
            out["tmp"].append(name)
    return out


def fsck_store(store_path: str, adopt: bool = False, stamp: bool = False,
               check_backups: bool = True,
               log: Optional[Callable[[str], None]] = None
               ) -> Dict[str, Any]:
    """The deep integrity walk (module docstring).  Read-only by
    default; ``adopt`` indexes orphan segments into the manifest,
    ``stamp`` writes the verdict to ``<store>/fsck.json``."""
    store_path = os.path.abspath(store_path)
    now = time.time()
    doc: Dict[str, Any] = {"kind": "fsck", "version": FSCK_VERSION,
                           "store": store_path, "checked_at": now,
                           "errors": [], "warnings": []}

    if _is_monolithic(store_path):
        doc["backend"] = "monolithic"
        try:
            with open(store_path) as f:
                raw = json.load(f)
            if raw.get("version") != STORE_VERSION:
                doc["errors"].append(
                    f"store version {raw.get('version')!r} != "
                    f"{STORE_VERSION}")
            elif not isinstance(raw.get("entries"), dict):
                doc["errors"].append("entries is not an object")
        except FileNotFoundError:
            doc["errors"].append("store file is absent")
        except (OSError, ValueError) as e:
            doc["errors"].append(f"unreadable store: {e}")
        store = ScheduleStore(store_path if os.path.exists(store_path)
                              else None, quarantine_corrupt=False,
                              _count_metrics=False, log=log)
        doc["records"] = len(store)
        doc["skipped_records"] = store.skipped
        if store.skipped:
            doc["warnings"].append(
                f"{store.skipped} record(s) failed validation")
        census = _census(os.path.dirname(store_path) or ".")
        doc["quarantine_census"] = [
            n for n in census["quarantined"]
            if n.startswith(os.path.basename(store_path))]
    else:
        doc["backend"] = "segmented"
        if not os.path.isdir(store_path):
            doc["errors"].append("store directory is absent")
            store = None
        else:
            # quarantine_corrupt=False: fsck reports damage, it never
            # moves evidence — re-running it is always safe
            store = SegmentedStore(store_path, quarantine_corrupt=False,
                                   _count_metrics=False, log=log)
        if store is not None:
            doc.update({
                "records": len(store),
                "segments": len(store.segment_info),
                "orphan_segments": list(store.orphan_segments),
                "missing_segments": list(store.missing_segments),
                "newer_segments": list(store.newer_segments),
                "checksum_failed": store.checksum_failed,
                "salvaged": store.salvaged,
                "skipped_records": store.skipped,
                "damaged_segments": sorted(
                    n for n, i in store.segment_info.items()
                    if i.get("damaged")),
                "manifest_ok": store.manifest_doc is not None,
            })
            if store.checksum_failed:
                doc["errors"].append(
                    f"{store.checksum_failed} record(s) failed their "
                    "sha256 (bit flips)")
            if doc["damaged_segments"]:
                doc["errors"].append(
                    f"{len(doc['damaged_segments'])} damaged "
                    "segment(s) (torn/truncated; valid records "
                    "salvaged)")
            if store.missing_segments:
                doc["errors"].append(
                    f"{len(store.missing_segments)} segment(s) listed "
                    "in the manifest but missing on disk")
            if store.manifest_doc is None and store.segment_info:
                doc["warnings"].append(
                    "manifest unreadable/absent; corpus recovered "
                    "from the segment scan")
            if store.orphan_segments:
                doc["warnings"].append(
                    f"{len(store.orphan_segments)} orphan segment(s) "
                    "(published, not indexed)")
            if adopt and store.orphan_segments:
                adopted = {
                    name: dict(store.segment_info[name],
                               source="fsck-adopt", adopted_at=now)
                    for name in store.orphan_segments
                    if name in store.segment_info}

                def mutate(man):
                    for name, meta in adopted.items():
                        man["segments"].setdefault(name, {
                            k: meta.get(k)
                            for k in ("bucket", "records", "bytes",
                                      "source", "adopted_at")})
                    return man

                store._mutate_manifest(mutate)
                doc["adopted_orphans"] = sorted(adopted)
                if log:
                    log(f"fsck: adopted {len(adopted)} orphan "
                        "segment(s) into the manifest")
            seg_census = _census(os.path.join(store_path, "segments"))
            top_census = _census(store_path)
            doc["quarantine_census"] = sorted(
                seg_census["quarantined"] + top_census["quarantined"])
            doc["tmp_droppings"] = sorted(
                seg_census["tmp"] + top_census["tmp"])

    ro = store_readonly(store_path)
    if ro is not None:
        doc["store_readonly"] = ro
        doc["warnings"].append(
            f"store is latched read-only ({ro.get('error')})")

    if check_backups:
        root = backups_root(store_path)
        gens = list_generations(root)
        backups: List[Dict[str, Any]] = []
        for name in gens:
            gd = os.path.join(root, name)
            try:
                cat = load_catalog(gd)
                backups.append({"generation": name, "ok": True,
                                "created_at": cat.get("created_at"),
                                "n_files": cat.get("n_files"),
                                "bytes": cat.get("bytes")})
            except DrError as e:
                backups.append({"generation": name, "ok": False,
                                "error": str(e)})
                doc["warnings"].append(
                    f"backup {name}: unreadable catalog (aborted "
                    "backup?)")
        doc["backups"] = backups

    doc["ok"] = not doc["errors"]
    doc["rc"] = fsck_exit_code(doc)
    if stamp:
        stamp_path = store_path + "." + FSCK_STAMP \
            if _is_monolithic(store_path) \
            else os.path.join(store_path, FSCK_STAMP)
        try:
            atomic_dump_json(stamp_path, doc, prefix=".fsck.")
        except OSError as e:
            doc["warnings"].append(f"fsck stamp not written ({e})")
    return doc


def fsck_exit_code(doc: Dict[str, Any]) -> int:
    """The CI gate: 0 clean, 1 damage found (the store still serves —
    salvage recovered what it could — but someone must look), 2 the
    tree could not be read at all."""
    errors = doc.get("errors") or []
    if any("absent" in e or "unreadable" in e.lower() for e in errors):
        return RC_UNREADABLE
    return RC_DAMAGED if errors else RC_CLEAN
