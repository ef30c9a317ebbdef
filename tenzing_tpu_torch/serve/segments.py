"""The segmented schedule store: sealed segments per bucket, a small atomic
manifest, and a compactor that survives a crash at any instant.

Counterpart of ``tenzing_tpu/serve/segments.py``, the same layout and
formats: a store directory written by either package loads in the other,
and :func:`record_digest` of a record is the reference's.  The monolithic
store (serve/store.py) re-reads and re-merges one JSON document on every
flush, so its flush cost grows with the store and one torn byte quarantines
all of it.  Here:

**Layout** (one store is one directory)::

    <store>/manifest.json        # the index (atomic, under flock)
    <store>/manifest.lock        # the flock's file (never renamed)
    <store>/segments/seg-<bucket>-<stamp>-<owner>-<n>.jsonl
    <store>/compact.lease        # the compactor's lease (serve/lease.py)

**Segments** are sealed JSONL files, one *bucket digest* each: line 0 is a
header (``kind/version/bucket/n_records``), every following line is
``{"sha256": <hex>, "record": {...}}``, the checksum of the record's
canonical serialization.  Every record certifies itself: a bit flip shows
in one record's checksum, a truncation against the header's count, and
salvage never trusts the framing.  A segment is published whole (utils/
atomic.py ``publish_sealed``), so a reader never sees a torn segment that
its writer acknowledged.

**The manifest is an index, not the truth.**  Loading scans the segments
directory; the manifest adds listed status, byte counts and the compaction
ledger.  A torn manifest costs metadata only: the scan recovers every
record (the torn file is moved aside).  A crash anywhere in a flush or a
compaction leaves at worst an *orphan* segment (published, not indexed),
which still loads and which the compactor adopts.  ``SIGKILL`` at any
instant recovers a superset of the acknowledged records.

**Damage**, per kind, never fatal:

* a bit-flipped record fails its checksum: it is skipped and counted
  (``serve.store.checksum_failed``), the segment's other records salvaged;
* a truncated or torn segment: every checksum-valid record is salvaged and
  marked dirty (the next flush writes it again), and the file is moved to
  ``*.corrupt-<id>`` (writers only; read-only loaders report and leave it);
* a torn manifest is moved aside (writers only); the scan recovers the
  records and the next flush or compaction rebuilds the index;
* a segment or manifest of a newer version is skipped loudly, never moved:
  future data is not damage.

**Flush** groups the records dirtied since the last flush by bucket,
publishes one new segment per dirty bucket, and adds their names to the
manifest under a non-blocking ``flock`` taken through the shared bounded
backoff (fault/backoff.py; when it runs out,
:class:`~tenzing_tpu_torch.fault.errors.StoreLockTimeout`, a transient).  A
flush costs the dirty records, not the store.

**Compaction** (:class:`Compactor`, ``python -m tenzing_tpu_torch.serve
compact``) merges each bucket of several segments through the store's
commutative :func:`~tenzing_tpu_torch.serve.store.merge_records`, publishes
the merged segment, republishes the manifest (inputs out, output in, a
ledger entry), and only then unlinks the inputs: the order that makes
``kill -9`` recover a superset at every instant.  Two compactors race
safely on the lease protocol (serve/lease.py); orphans are adopted into the
manifest; temp files older than a grace period are collected.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import signal
import socket
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

from tenzing_tpu_torch.fault.backoff import BackoffPolicy, retry_call
from tenzing_tpu_torch.fault.errors import StoreLockTimeout
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer, short_digest
from tenzing_tpu_torch.serve.lease import LeaseFile
from tenzing_tpu_torch.serve.store import (
    RECORD_SCHEMA,
    Record,
    ScheduleStore,
    guarded_store_write,
    migrate_record,
)
from tenzing_tpu_torch.utils.atomic import atomic_dump_json, publish_sealed

SEGMENT_VERSION = 1
MANIFEST_VERSION = 1
# a long-lived store compacts forever; the ledger is bounded like the
# daemon's history (consumers only ever read the tail)
COMPACTION_HISTORY_CAP = 50

MANIFEST_NAME = "manifest.json"
MANIFEST_LOCK = "manifest.lock"
SEGMENTS_DIR = "segments"
COMPACT_LEASE = "compact.lease"


def record_digest(rec: Record) -> str:
    """sha256 hex of the record's canonical serialization — the
    per-record checksum that makes every stored record self-certifying
    (module docstring)."""
    return hashlib.sha256(
        json.dumps(rec, sort_keys=True, separators=(",", ":"))
        .encode()).hexdigest()


def _owner_token(owner: str) -> str:
    """Owner id as a filename token (dashes survive; the bucket field is
    parsed positionally so an owner dash cannot confuse it)."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", owner) or "anon"


def segment_bucket_of(name: str) -> str:
    """The bucket digest a segment file is keyed by (positional: the
    digest is hex, never dashed — owner tokens after it may be)."""
    parts = name.split("-")
    return parts[1] if len(parts) > 1 else "?"


def is_segment_name(name: str) -> bool:
    return name.startswith("seg-") and name.endswith(".jsonl")


class SegmentedStore(ScheduleStore):
    """Drop-in :class:`~tenzing_tpu_torch.serve.store.ScheduleStore` with
    segmented persistence (module docstring).  The in-memory view, the merge
    algebra, the record schema and the queries are the store's; only
    ``_load``/``flush``/``flag``/``stats`` change, so the resolver cannot
    tell the backends apart except by speed."""

    def __init__(self, directory: Optional[str], tenant: str = "local",
                 log: Optional[Callable[[str], None]] = None,
                 quarantine_corrupt: bool = True,
                 _count_metrics: bool = True):
        self.dir = directory
        self.owner = _owner_token(f"{socket.gethostname()}-{os.getpid()}")
        self._seg_counter = 0
        self._loading = False
        # ordered set of (exact, key) mutated since the last flush — the
        # flush unit; segment append cost is proportional to THIS, never
        # to the corpus
        self._dirty: Dict[Tuple[str, str], None] = {}
        # per live segment file: bucket/records/bytes/listed/salvaged —
        # built on load, read by stats(), the compactor and fsck
        # (serve/dr.py)
        self.segment_info: Dict[str, Dict[str, Any]] = {}
        self.manifest_doc: Optional[Dict[str, Any]] = None
        self.quarantined_segments: List[str] = []
        self.orphan_segments: List[str] = []
        self.missing_segments: List[str] = []
        self.vanished_segments: List[str] = []
        self.newer_segments: List[str] = []
        self.checksum_failed = 0
        self.salvaged = 0
        super().__init__(path=None, tenant=tenant, log=log,
                         quarantine_corrupt=quarantine_corrupt,
                         _count_metrics=_count_metrics)
        self.path = directory
        if directory is not None and os.path.isdir(directory):
            self._loading = True
            try:
                self._load_segments()
            finally:
                self._loading = False

    # -- paths ---------------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST_NAME)

    @property
    def segments_path(self) -> str:
        return os.path.join(self.dir, SEGMENTS_DIR)

    # -- dirty tracking -------------------------------------------------------
    def _put(self, rec: Record) -> Record:
        if self._loading:
            return super()._put(rec)
        slot = self.entries.get(rec.get("exact"), {})
        prev = slot.get(rec.get("key"))
        out = super()._put(rec)
        if prev is None or prev != out:
            self._dirty[(out["exact"], out["key"])] = None
        return out

    def flag(self, exact: str, key: str, **flags: Any) -> None:
        rec = self.entries.get(exact, {}).get(key)
        if rec is None:
            return
        cur = rec.setdefault("flags", {})
        if all(cur.get(k) == v for k, v in flags.items()):
            return  # hot-path short-circuit, same as the monolithic store
        cur.update(flags)
        self.generation += 1  # the exact cache must see the mutation
        self._dirty[(exact, key)] = None
        self.flush()

    # -- manifest ------------------------------------------------------------
    @contextmanager
    def _manifest_lock(self):
        """Non-blocking ``flock`` on the sidecar, acquired through the
        shared bounded backoff (fault/backoff.py) — a serving request
        must never wait forever behind a stuck writer; exhaustion raises
        :class:`StoreLockTimeout` (transient: the rival will finish)."""
        try:
            import fcntl
        except ImportError:  # pragma: no cover — non-POSIX fallback
            yield
            return
        lock_f = open(os.path.join(self.dir, MANIFEST_LOCK), "w")

        def acquire():
            try:
                fcntl.flock(lock_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError as e:
                raise StoreLockTimeout(
                    f"manifest lock contended ({e})") from None

        try:
            retry_call(acquire,
                       policy=BackoffPolicy(retries=40, base_secs=0.005,
                                            factor=1.5, max_secs=0.25,
                                            jitter=0.5),
                       where="serve.manifest_lock")
            yield
        finally:
            lock_f.close()  # releases the flock

    def _read_manifest(self) -> Optional[Dict[str, Any]]:
        path = self.manifest_path
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError("manifest is not an object")
            if doc.get("version", 0) > MANIFEST_VERSION:
                # future data is not damage: ignore the index (the scan
                # is ground truth), never quarantine it
                self._note(f"store: manifest version {doc.get('version')!r}"
                           f" > {MANIFEST_VERSION}; scanning instead")
                return None
            if not isinstance(doc.get("segments"), dict):
                raise ValueError("manifest without a segments object")
            return doc
        except Exception as e:
            # the manifest is an index: losing it costs metadata, never
            # records — quarantine (writers) or report (read-only) and
            # fall back to the scan
            if self.quarantine_corrupt:
                quarantined = f"{path}.corrupt-{short_digest(str(e))[:8]}"
                try:
                    os.replace(path, quarantined)
                    self._note(f"store: quarantined torn manifest -> "
                               f"{quarantined} ({type(e).__name__}: {e}); "
                               "recovering from segment scan")
                except OSError:
                    self._note(f"store: torn manifest {path} "
                               f"({type(e).__name__}: {e})")
                if self._count_metrics:
                    get_metrics().counter(
                        "serve.store.manifest_quarantined").inc()
            else:
                self._note(f"store: torn manifest {path} "
                           f"({type(e).__name__}: {e}); left in place")
            return None

    def _mutate_manifest(self, fn: Callable[[Dict[str, Any]],
                                            Dict[str, Any]]) -> None:
        """Read-modify-write under the flock: ``fn`` mutates (and
        returns) the manifest doc; a missing/torn manifest starts empty
        — the scan-recovered records become orphans the compactor
        re-indexes, never losses."""
        with self._manifest_lock():
            doc = self._read_manifest() or {
                "version": MANIFEST_VERSION, "segments": {},
                "compactions": []}
            doc = fn(doc)
            # hardened: transient EIO retries through the shared backoff;
            # ENOSPC/EROFS latches the store read-only (serve/store.py)
            guarded_store_write(
                self.dir,
                lambda: atomic_dump_json(self.manifest_path, doc,
                                         prefix=".manifest."),
                where="serve.store.manifest")
        self.manifest_doc = doc

    # -- loading -------------------------------------------------------------
    def _scan_names(self) -> List[str]:
        try:
            return sorted(n for n in os.listdir(self.segments_path)
                          if is_segment_name(n))
        except OSError:
            return []

    def _load_segments(self) -> None:
        man = self._read_manifest()
        self.manifest_doc = man
        listed = dict((man or {}).get("segments", {}))
        n_loaded = 0
        seen: set = set()
        names = self._scan_names()
        for _pass in (0, 1):
            for name in names:
                if name in seen:
                    continue
                seen.add(name)
                n_loaded += self._load_one_segment(name, name in listed)
            vanished = [n for n in self.vanished_segments if n in seen]
            if _pass == 0 and vanished:
                # a compactor published + reclaimed between our listdir
                # and our reads: one re-list picks up its output segment
                # (publish strictly precedes reclaim, so it exists now)
                names = self._scan_names()
            else:
                break
        self.orphan_segments = sorted(
            n for n in self.segment_info if n not in listed)
        self.missing_segments = sorted(
            n for n in listed
            if n not in self.segment_info
            and n not in self.vanished_segments
            and n not in self.quarantined_segments)
        for name in self.missing_segments:
            self._note(f"store: segment {name} listed in the manifest "
                       "but missing on disk")
        if self._count_metrics:
            get_metrics().counter("serve.store.loaded").inc(n_loaded)

    def _load_one_segment(self, name: str, listed: bool) -> int:
        path = os.path.join(self.segments_path, name)
        try:
            # bytes first: a bit flip can make the file invalid UTF-8,
            # and that must damage ONE line's checksum, not crash the
            # whole load
            with open(path, "rb") as f:
                lines = f.read().decode(
                    "utf-8", errors="replace").splitlines()
        except OSError:
            # unlinked between listdir and open: a compactor reclaimed
            # it — its records live in the published compact segment
            self.vanished_segments.append(name)
            return 0
        header: Dict[str, Any] = {}
        damage: List[str] = []
        if lines:
            try:
                header = json.loads(lines[0])
                if not isinstance(header, dict) or \
                        header.get("kind") != "segment":
                    raise ValueError("not a segment header")
            except ValueError:
                header = {}
                damage.append("bad-header")
        else:
            damage.append("empty")
        if header.get("version", 0) > SEGMENT_VERSION:
            # future data is not damage — skip loudly, never quarantine
            self.newer_segments.append(name)
            self._note(f"store: segment {name} has newer version "
                       f"{header.get('version')!r}; skipped")
            return 0
        valid: List[Record] = []
        bad_checksum = torn_lines = 0
        for line in lines[1:]:
            if not line.strip():
                continue
            try:
                j = json.loads(line)
            except ValueError:
                torn_lines += 1
                continue
            rec = j.get("record") if isinstance(j, dict) else None
            if not isinstance(rec, dict) or \
                    record_digest(rec) != j.get("sha256"):
                bad_checksum += 1
                continue
            valid.append(rec)
        n_expected = header.get("n_records")
        if torn_lines:
            damage.append(f"torn-lines:{torn_lines}")
        if bad_checksum:
            damage.append(f"checksum:{bad_checksum}")
            self.checksum_failed += bad_checksum
            if self._count_metrics:
                get_metrics().counter(
                    "serve.store.checksum_failed").inc(bad_checksum)
        if isinstance(n_expected, int) and \
                len(valid) + bad_checksum < n_expected:
            damage.append(
                f"truncated:{len(valid) + bad_checksum}/{n_expected}")
        n = 0
        for rec in valid:
            mig = migrate_record(rec)
            if mig is None:
                self.skipped += 1
                continue
            out = self._put(mig)
            if damage:
                # salvage: every checksum-valid record survives, and is
                # re-persisted by the next flush (the damaged file moves
                # aside below — without the dirty mark the salvage would
                # evaporate on the next load)
                self._dirty[(out["exact"], out["key"])] = None
                self.salvaged += 1
            n += 1
        if damage:
            tag = ",".join(damage)
            if self.quarantine_corrupt:
                quarantined = f"{path}.corrupt-{short_digest(tag)[:8]}"
                try:
                    os.replace(path, quarantined)
                    self._note(f"store: quarantined damaged segment "
                               f"{name} ({tag}; salvaged {n} record(s))")
                except OSError:
                    self._note(f"store: damaged segment {name} ({tag})")
                self.quarantined_segments.append(name)
                if self._count_metrics:
                    get_metrics().counter(
                        "serve.store.segment_quarantined").inc()
                tr = get_tracer()
                if tr.enabled:
                    tr.event("serve.store.segment_quarantined",
                             segment=name, damage=tag, salvaged=n)
                return n
            self._note(f"store: damaged segment {name} ({tag}; "
                       f"{n} valid record(s)); left in place")
        self.segment_info[name] = {
            "bucket": header.get("bucket", segment_bucket_of(name)),
            "records": n,
            "bytes": sum(len(line) + 1 for line in lines),
            "listed": listed,
            "damaged": bool(damage),
        }
        return n

    # -- flushing ------------------------------------------------------------
    def _publish_segment(self, bucket: str, recs: List[Record],
                         source: str) -> Tuple[str, Dict[str, Any]]:
        """Write one sealed segment (complete, fsynced, hard-linked into
        place, directory fsynced — utils/atomic.py ``publish_sealed``)
        and return ``(name, manifest meta)``.  The caller indexes it;
        until then it is a loadable orphan."""
        header = {"kind": "segment", "version": SEGMENT_VERSION,
                  "bucket": bucket, "n_records": len(recs),
                  "schema": RECORD_SCHEMA, "created_at": time.time(),
                  "owner": self.owner, "source": source}
        body = [json.dumps(header, sort_keys=True)]
        body += [json.dumps({"sha256": record_digest(r), "record": r},
                            sort_keys=True)
                 for r in recs]
        text = "\n".join(body) + "\n"

        def make_name() -> str:
            # fresh stamp per attempt: a rival writer's collision re-draws
            self._seg_counter += 1
            return (f"seg-{bucket}-{int(time.time() * 1e6)}-"
                    f"{self.owner}-{self._seg_counter}.jsonl")

        name = guarded_store_write(
            self.dir,
            lambda: publish_sealed(self.segments_path, make_name, text),
            where="serve.store.publish_segment")
        meta = {"bucket": bucket, "records": len(recs),
                "bytes": len(text), "created_at": header["created_at"],
                "source": source, "sealed": True}
        self.segment_info[name] = {**meta, "listed": False,
                                   "damaged": False}
        return name, meta

    def flush(self) -> None:
        """Publish one new segment per *dirty* bucket and index them in
        the manifest — cost proportional to the records mutated since
        the last flush, never to the corpus (module docstring)."""
        if self.dir is None:
            return
        # the "store merge" leg of a request's cross-process trace: a
        # drain daemon flushes under the work item's ambient context, so
        # this span carries the originating query's trace_id
        with get_tracer().span("serve.store.flush",
                               backend="segmented") as sp:
            os.makedirs(self.dir, exist_ok=True)
            by_bucket: Dict[str, List[Record]] = {}
            for exact, key in self._dirty:
                rec = self.entries.get(exact, {}).get(key)
                if rec is not None:
                    by_bucket.setdefault(rec.get("bucket") or "unbucketed",
                                         []).append(rec)
            added: Dict[str, Dict[str, Any]] = {}
            for bucket in sorted(by_bucket):
                name, meta = self._publish_segment(
                    bucket, by_bucket[bucket], source="flush")
                added[name] = meta
            sp.set("segments", len(added))
            sp.set("dirty_records", sum(len(v) for v in by_bucket.values()))
            if added or not os.path.exists(self.manifest_path):

                def mutate(doc):
                    doc["segments"].update(added)
                    return doc

                self._mutate_manifest(mutate)
                for name in added:
                    self.segment_info[name]["listed"] = True
            self._dirty.clear()
        get_metrics().counter("serve.store.flushed").inc()

    # -- stats ---------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        st = super().stats()
        by_bucket: Dict[str, Dict[str, Any]] = {}
        for name, info in self.segment_info.items():
            b = by_bucket.setdefault(info["bucket"], {
                "segments": 0, "records": 0, "bytes": 0, "live": 0})
            b["segments"] += 1
            b["records"] += info.get("records", 0)
            b["bytes"] += info.get("bytes", 0)
            b["live"] += 1 if info.get("listed") else 0
        admission = {"verified": 0, "unsound": 0, "unstamped": 0}
        for rec in self.records():
            if rec.get("flags", {}).get("unsound"):
                admission["unsound"] += 1
            elif rec.get("verified_at_admission"):
                admission["verified"] += 1
            else:
                admission["unstamped"] += 1
        compactions = list((self.manifest_doc or {}).get("compactions", []))
        st.update({
            "backend": "segmented",
            "segments": {
                "count": len(self.segment_info),
                "bytes": sum(i.get("bytes", 0)
                             for i in self.segment_info.values()),
                "orphans": len(self.orphan_segments),
                "missing": len(self.missing_segments),
                "quarantined": len(self.quarantined_segments),
                "newer_skipped": len(self.newer_segments),
            },
            "by_bucket": dict(sorted(by_bucket.items())),
            "checksum_failed": self.checksum_failed,
            "salvaged": self.salvaged,
            "admission": admission,
            "compactions": len(compactions),
            "last_compaction": compactions[-1] if compactions else None,
            "dirty": len(self._dirty),
        })
        return st


class Compactor:
    """The offline segment compactor (module docstring): merge each
    multi-segment bucket via the commutative record merge, publish, index,
    then reclaim — ``SIGKILL``-safe at every instant, lease-exclusive via
    serve/lease.py.  ``crash_after`` is the chaos hook (the CLI's hidden
    ``--crash-after``): ``"segment"`` SIGKILLs this process after the
    first merged segment is published but *before* the manifest lands,
    ``"manifest"`` after the manifest lands but *before* the inputs are
    reclaimed — the two windows a real ``kill -9`` could hit."""

    def __init__(self, store_dir: str, owner: str = "",
                 min_segments: int = 2, lease_ttl_secs: float = 60.0,
                 grace_secs: float = 60.0,
                 log: Optional[Callable[[str], None]] = None,
                 crash_after: Optional[str] = None):
        self.dir = store_dir
        self.owner = _owner_token(
            owner or f"{socket.gethostname()}-{os.getpid()}")
        self.min_segments = max(2, int(min_segments))
        self.lease_ttl_secs = float(lease_ttl_secs)
        self.grace_secs = float(grace_secs)
        self._log = log
        self.crash_after = crash_after

    def _note(self, msg: str) -> None:
        if self._log is not None:
            self._log(msg)

    def _crash(self, point: str) -> None:
        if self.crash_after == point:  # pragma: no cover — chaos only
            os.kill(os.getpid(), signal.SIGKILL)

    def _gc_tmp(self, now: float) -> int:
        """Collect stale ``*.tmp`` droppings a SIGKILLed writer left
        (never acknowledged — their writer died before the publish, so
        removing them removes nothing a reader could have seen)."""
        n = 0
        for d in (self.dir, os.path.join(self.dir, SEGMENTS_DIR)):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if not name.endswith(".tmp"):
                    continue
                path = os.path.join(d, name)
                try:
                    if now - os.path.getmtime(path) > self.grace_secs:
                        os.unlink(path)
                        n += 1
                except OSError:
                    continue
        return n

    def run(self) -> Dict[str, Any]:
        """One compaction pass; returns the summary dict the CLI prints.
        A held lease skips (another compactor is live); an expired one is
        reclaimed through the shared protocol."""
        reg = get_metrics()
        summary: Dict[str, Any] = {
            "store": self.dir, "owner": self.owner,
            "buckets_compacted": 0, "segments_reclaimed": 0,
            "orphans_adopted": 0, "tmp_collected": 0, "records": 0,
            "lease_lost": False, "skipped": None,
        }
        if not os.path.isdir(self.dir):
            summary["skipped"] = "missing-store"
            return summary
        lease = LeaseFile(os.path.join(self.dir, COMPACT_LEASE),
                          self.owner, ttl_secs=self.lease_ttl_secs,
                          log=self._log)
        info = lease.claim()
        if info is None:
            reg.counter("serve.compaction.contended").inc()
            summary["skipped"] = "lease-held"
            return summary
        if info.reclaimed:
            self._note(f"compact: reclaimed expired lease (owner "
                       f"{info.prev_owner}, {info.age_s}s stale)")
        reg.counter("serve.compaction.runs").inc()
        tr = get_tracer()
        try:
            with tr.span("serve.compaction", store=self.dir,
                         owner=self.owner):
                # loading salvages damage + quarantines; flushing
                # persists the salvage (and creates a missing manifest)
                store = SegmentedStore(self.dir, tenant="compactor",
                                       log=self._log)
                store.flush()
                summary["records"] = len(store)
                man = store._read_manifest() or {"segments": {}}
                listed = man.get("segments", {})
                by_bucket: Dict[str, List[str]] = {}
                # compact (and later reclaim) ONLY the segments this
                # pass actually loaded into memory — a rival writer may
                # publish a new segment between our load and now, and a
                # fresh scan here would reclaim it without its records
                # ever entering the merged output (permanent loss, not
                # a superset); the unseen segment just waits for the
                # next pass
                for name, info in store.segment_info.items():
                    by_bucket.setdefault(info["bucket"], []).append(name)
                for bucket in sorted(by_bucket):
                    names = sorted(by_bucket[bucket])
                    orphans = [n for n in names if n not in listed]
                    if len(names) >= self.min_segments:
                        self._compact_bucket(store, bucket, names, summary)
                    elif orphans:
                        self._adopt(store, orphans, summary)
                    if not lease.renew():
                        # a rival reclaimed us mid-pass (stall past the
                        # TTL): every published step is already
                        # consistent; just stop competing
                        summary["lease_lost"] = True
                        self._note("compact: lease lost mid-pass — "
                                   "stopping")
                        break
                summary["tmp_collected"] = self._gc_tmp(time.time())
        finally:
            lease.release()
        return summary

    def _compact_bucket(self, store: SegmentedStore, bucket: str,
                        names: List[str], summary: Dict[str, Any]) -> None:
        recs = [r for r in store.records() if r.get("bucket") == bucket]
        if not recs:
            return
        new_name, meta = store._publish_segment(bucket, recs,
                                                source="compact")
        self._crash("segment")  # chaos window 1: orphan output, inputs live

        def mutate(doc):
            for n in names:
                doc["segments"].pop(n, None)
            doc["segments"][new_name] = meta
            ledger = doc.setdefault("compactions", [])
            ledger.append({
                "at": time.time(), "owner": self.owner, "bucket": bucket,
                "inputs": names, "output": new_name,
                "records": len(recs),
            })
            del ledger[:-COMPACTION_HISTORY_CAP]
            return doc

        store._mutate_manifest(mutate)
        store.segment_info[new_name]["listed"] = True
        self._crash("manifest")  # chaos window 2: inputs orphaned on disk
        reclaimed = 0
        for n in names:
            try:
                os.unlink(os.path.join(store.segments_path, n))
                reclaimed += 1
            except OSError:
                pass
            store.segment_info.pop(n, None)
        summary["buckets_compacted"] += 1
        summary["segments_reclaimed"] += reclaimed
        reg = get_metrics()
        reg.counter("serve.compaction.buckets").inc()
        reg.counter("serve.compaction.reclaimed").inc(reclaimed)
        tr = get_tracer()
        if tr.enabled:
            tr.event("serve.compaction.bucket", bucket=bucket,
                     inputs=len(names), output=new_name, records=len(recs))
        self._note(f"compact: bucket {bucket[:12]} {len(names)} -> 1 "
                   f"segment(s), {len(recs)} record(s)")

    def _adopt(self, store: SegmentedStore, orphans: List[str],
               summary: Dict[str, Any]) -> None:
        """Index orphan segments (a flush or compaction that died after
        publish, before the manifest) without rewriting them — adoption
        is what turns 'loaded by scan' into 'listed', so the ledgered
        view converges back to the disk truth."""
        metas: Dict[str, Dict[str, Any]] = {}
        for name in orphans:
            path = os.path.join(store.segments_path, name)
            try:
                with open(path) as f:
                    header = json.loads(f.readline())
                size = os.path.getsize(path)
            except (OSError, ValueError):
                continue  # vanished or unreadable: the loader's problem
            metas[name] = {
                "bucket": header.get("bucket", segment_bucket_of(name)),
                "records": header.get("n_records", 0), "bytes": size,
                "created_at": header.get("created_at"),
                "source": "adopted", "sealed": True,
            }
        if not metas:
            return

        def mutate(doc):
            for name, meta in metas.items():
                doc["segments"].setdefault(name, meta)
            return doc

        store._mutate_manifest(mutate)
        summary["orphans_adopted"] += len(metas)
        get_metrics().counter("serve.compaction.adopted").inc(len(metas))
        self._note(f"compact: adopted {len(metas)} orphan segment(s)")
