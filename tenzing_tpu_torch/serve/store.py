"""The persistent schedule store and the cold-request work queue.

Counterpart of ``tenzing_tpu/serve/store.py``, the same formats: a store
written by either package loads and merges in the other.

**Store file** (one JSON document, written atomically through
utils/atomic.py)::

    {"version": 1, "entries": {<exact-digest>: {<schedule-key>: record}}}

A **record** is schema-versioned (``"schema"``) and carries what a
resolution needs: the fingerprint document, the winning sequence's
serialized ops, its measured ``pct50_us`` and ``vs_naive`` (the in-file
paired ratio against the database's own naive anchor, bench/recorded.py),
a provenance block (tenant, source file, fidelity; a drained record also
the device that measured it), the sha256 digests of the source files, and
sticky ``flags`` (``needs_refinement``, ``unsound``).

**Merge** is commutative and idempotent: records union by
``(exact-digest, schedule-key)``; a conflict resolves by a total order
(higher ``vs_naive``, then lower ``pct50_us``, then the larger canonical
serialization), ``sources`` union and ``flags`` OR sticky.

**Durability**: a corrupt store file is quarantined (renamed to
``<path>.corrupt-<id>``) and reported, never fatal and never clobbered
(read-only callers pass ``quarantine_corrupt=False``); a record that fails
validation is skipped with a note.  ``flush()`` re-reads the file and
merges before writing, the read-merge-rename held under an advisory
``flock`` on ``<path>.lock``.  A write that fails with ENOSPC / EDQUOT /
EROFS latches the store read-only (:func:`mark_store_unwritable`); the
resolver then sheds cold and near requests and the daemon pauses claims
until a probe write lands.

**Schema evolution**: ``RECORD_SCHEMA`` stamps every record;
:func:`migrate_record` upgrades schema 1 on load, and a record of a newer
schema is skipped loudly.

This is the monolithic ``*.json`` store; :func:`open_store` opens any
other path as the segmented store (serve/segments.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tenzing_tpu_torch.fault.backoff import BackoffPolicy, retry_call
from tenzing_tpu_torch.fault.checkpoint import atomic_write_json, read_checked_json
from tenzing_tpu_torch.fault.errors import is_transient_io, is_unwritable_io
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer, short_digest
from tenzing_tpu_torch.utils.atomic import atomic_dump_json

STORE_VERSION = 1
RECORD_SCHEMA = 2

Record = Dict[str, Any]

# -- read-only degradation latch --------------------------------------------
# One process-wide latch per store path (abspath-keyed): when a durable
# store write dies on the unwritable errno family (ENOSPC/EDQUOT/EROFS —
# fault/errors.py), the serve plane degrades instead of thrashing: the
# resolver keeps answering exact and sheds cold/near with
# StoreReadonlyError, and the drain daemon pauses claims instead of
# accumulating bogus poison verdicts.  The latch clears on any successful
# write — a real flush or an explicit probe.
_READONLY: Dict[str, Dict[str, Any]] = {}
_READONLY_LOCK = threading.Lock()

# transient-EIO policy for durable store writes: a flaky-disk write
# retries through THE shared backoff (fault/backoff.py) on a millisecond
# timescale; the unwritable family never retries (space does not come
# back between attempts), it latches
_IO_RETRY = BackoffPolicy(retries=2, base_secs=0.05, factor=4.0,
                          max_secs=0.5, jitter=0.25)


def _store_key(path: str) -> str:
    return os.path.abspath(path)


def mark_store_unwritable(path: str, exc: BaseException) -> Dict[str, Any]:
    """Latch ``path``'s store read-only (idempotent; first trip counts
    ``serve.store.readonly_trips`` and stamps the latch doc)."""
    key = _store_key(path)
    with _READONLY_LOCK:
        doc = _READONLY.get(key)
        if doc is None:
            doc = {
                "reason": "store_readonly",
                "errno": getattr(exc, "errno", None),
                "error": f"{type(exc).__name__}: {str(exc)[:200]}",
                "since": time.time(),
            }
            _READONLY[key] = doc
            get_metrics().counter("serve.store.readonly_trips").inc()
            get_metrics().gauge("serve.store.readonly").set(1.0)
            tr = get_tracer()
            if tr.enabled:
                tr.event("serve.store.readonly", store=key,
                         error=doc["error"])
    return doc


def store_readonly(path: Optional[str]) -> Optional[Dict[str, Any]]:
    """The latch doc when ``path``'s store is degraded read-only, else
    None.  Read by the resolver's cold/near gates, the daemon's pause
    loop, and every status/report surface."""
    if path is None:
        return None
    with _READONLY_LOCK:
        return _READONLY.get(_store_key(path))


def clear_store_unwritable(path: str) -> bool:
    """Drop the latch (a write landed / a probe succeeded); True iff it
    was set."""
    with _READONLY_LOCK:
        doc = _READONLY.pop(_store_key(path), None)
    if doc is not None:
        get_metrics().gauge("serve.store.readonly").set(0.0)
        tr = get_tracer()
        if tr.enabled:
            tr.event("serve.store.writable", store=_store_key(path))
    return doc is not None


def probe_store_writable(path: str) -> bool:
    """Attempt one tiny durable write next to the store (through the
    same atomic seam real writes use, so chaos governs it too); clears
    the latch and returns True on success.  The paused daemon polls
    this."""
    if path.endswith(".json") and not os.path.isdir(path):
        probe = path + ".probe"
    else:
        probe = os.path.join(path, ".probe.json")
    try:
        atomic_dump_json(probe, {"probe_at": time.time()}, prefix=".probe.")
    except OSError:
        return False
    try:
        os.unlink(probe)
    except OSError:
        pass
    clear_store_unwritable(path)
    return True


def guarded_store_write(store_path: Optional[str], fn,
                        where: str = "serve.store.write"):
    """Run one durable store write: transient I/O errors (EIO family)
    retry through THE shared fault/backoff.py; the unwritable family
    latches the store read-only and re-raises; success clears any
    latch.  Every store flush funnels through here."""
    try:
        out = retry_call(fn, policy=_IO_RETRY, retry_on=is_transient_io,
                         where=where)
    except OSError as e:
        if store_path is not None and is_unwritable_io(e):
            mark_store_unwritable(store_path, e)
        raise
    if store_path is not None and store_readonly(store_path) is not None:
        clear_store_unwritable(store_path)
    return out


def file_digest(path: str) -> str:
    """sha256 hex of a source corpus file — the provenance link from a
    store record back to the bytes it was mined from."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def migrate_record(rec: Record) -> Optional[Record]:
    """Upgrade ``rec`` to :data:`RECORD_SCHEMA`; None when it cannot be
    trusted (newer schema, or missing the identity fields no default can
    supply)."""
    if not isinstance(rec, dict):
        return None
    schema = rec.get("schema", 1)
    if schema > RECORD_SCHEMA:
        return None
    for key in ("exact", "bucket", "key", "ops", "workload"):
        if key not in rec:
            return None
    out = dict(rec)
    if schema < 2:
        # schema 1 predates multi-tenant merge provenance
        out.setdefault("sources", [])
        out.setdefault("flags", {})
        out.setdefault("provenance", {})
    out["schema"] = RECORD_SCHEMA
    return out


def _order_key(rec: Record) -> Tuple:
    """The total order merge resolves conflicts by: best record wins,
    deterministically in either merge order."""
    return (
        float(rec.get("vs_naive") or 0.0),
        -float(rec.get("pct50_us") or float("inf")),
        # canonical serialization as the final tiebreak: NO pair of
        # distinct records compares equal, so max() is order-independent
        json.dumps(rec, sort_keys=True),
    )


def merge_records(a: Record, b: Record) -> Record:
    """One (exact, key) slot's merge: the better record by
    :func:`_order_key`, with ``sources`` unioned, ``flags`` ORed sticky
    (a refinement flag set by either tenant survives), and provenance
    keys the winner lacks filled from the loser — a driver-verdict stamp
    (service.py ``warm --bench``) must survive merging with an unstamped
    twin of the same schedule.  Winner precedence keeps this commutative:
    which record is "winner" depends only on the pair, not the order."""
    win, lose = (a, b) if _order_key(a) >= _order_key(b) else (b, a)
    winner = dict(win)
    winner["provenance"] = {**lose.get("provenance", {}),
                            **win.get("provenance", {})}
    winner["sources"] = sorted(
        set(a.get("sources", [])) | set(b.get("sources", [])))
    # the admission-time verification stamp ORs sticky, exactly like a
    # flag: two spellings of one (exact, key) slot name the SAME schedule
    # under the SAME deterministic graph, so a verdict from either host
    # covers both (docs/serving.md "Admission-time verification")
    if a.get("verified_at_admission") or b.get("verified_at_admission"):
        winner["verified_at_admission"] = True
    flags: Dict[str, bool] = {}
    for src in (a.get("flags", {}), b.get("flags", {})):
        for k, v in src.items():
            # boolean OR — commutative by construction, so merge order
            # cannot change the outcome (flags are sticky booleans)
            flags[k] = bool(flags.get(k, False) or v)
    winner["flags"] = dict(sorted(flags.items()))
    return winner


class ScheduleStore:
    """In-memory store view, optionally file-backed (see module
    docstring).  ``tenant`` stamps the provenance of records added
    through this instance; merged records keep their original tenants."""

    def __init__(self, path: Optional[str] = None, tenant: str = "local",
                 log: Optional[Callable[[str], None]] = None,
                 quarantine_corrupt: bool = True,
                 _count_metrics: bool = True):
        self.path = path
        self.tenant = tenant
        self._log = log
        # False = read-only callers (the report CLI): an unreadable file
        # is reported but LEFT IN PLACE — renaming evidence aside is the
        # serving process's prerogative, not a diagnostics command's
        self.quarantine_corrupt = quarantine_corrupt
        # False = flush()'s throwaway re-read: bookkeeping, not a real
        # load — counting it would inflate serve.store.loaded by the
        # full record count on every flush
        self._count_metrics = _count_metrics
        self.entries: Dict[str, Dict[str, Record]] = {}
        self.skipped = 0  # records dropped by validation/migration on load
        # bumped on every record landing (_put: load, add, merge) — the
        # resolver's exact-tier cache keys its validity on this, so a
        # merge can never serve a stale cached answer
        self.generation = 0
        if path is not None and os.path.exists(path):
            self._load(path)

    # -- loading ------------------------------------------------------------
    def _note(self, msg: str) -> None:
        if self._log is not None:
            self._log(msg)

    def _load(self, path: str) -> None:
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc.get("version") != STORE_VERSION:
                raise ValueError(
                    f"store version {doc.get('version')!r} != "
                    f"{STORE_VERSION}")
            entries = doc["entries"]
            if not isinstance(entries, dict):
                raise ValueError("entries is not an object")
        except Exception as e:
            if not self.quarantine_corrupt:
                self._note(f"store: unreadable {path} "
                           f"({type(e).__name__}: {e}); left in place")
                return
            # quarantine, don't clobber: the damaged bytes move aside for
            # post-mortem and the next flush starts a fresh file — losing
            # a store to corruption is recoverable (re-warm), silently
            # overwriting evidence is not
            quarantined = f"{path}.corrupt-{short_digest(str(e))[:8]}"
            try:
                os.replace(path, quarantined)
                self._note(f"store: quarantined unreadable {path} -> "
                           f"{quarantined} ({type(e).__name__}: {e})")
            except OSError:
                self._note(f"store: unreadable {path} "
                           f"({type(e).__name__}: {e})")
            get_metrics().counter("serve.store.quarantined").inc()
            return
        n = 0
        for exact, by_key in entries.items():
            if not isinstance(by_key, dict):
                # structurally malformed slot (valid JSON, wrong shape):
                # skip it like a bad record — construction must stay
                # never-fatal so flush()'s re-read (under the flock),
                # the CLI, and the report all survive a damaged file
                self.skipped += 1
                self._note(f"store: skipped malformed slot {exact[:8]}")
                continue
            for key, rec in by_key.items():
                mig = migrate_record(rec)
                if mig is None:
                    self.skipped += 1
                    schema = (rec.get("schema")
                              if isinstance(rec, dict) else type(rec).__name__)
                    self._note(f"store: skipped record {exact[:8]}/{key[:8]} "
                               f"(schema {schema!r})")
                    continue
                self._put(mig)
                n += 1
        if self._count_metrics:
            get_metrics().counter("serve.store.loaded").inc(n)

    # -- writing ------------------------------------------------------------
    def _put(self, rec: Record) -> Record:
        slot = self.entries.setdefault(rec["exact"], {})
        prev = slot.get(rec["key"])
        slot[rec["key"]] = rec if prev is None else merge_records(prev, rec)
        self.generation += 1
        return slot[rec["key"]]

    def add(self, fingerprint, seq, pct50_us: float, vs_naive: float,
            source: Optional[str] = None, fidelity: str = "full",
            extra_provenance: Optional[Dict[str, Any]] = None,
            verified: Optional[bool] = None) -> Record:
        """Record ``seq`` (a Sequence) as a winner for ``fingerprint``.
        ``source`` is the corpus file it was mined from (digested into
        ``sources``).  ``verified`` is the **admission-time** soundness
        verdict (docs/serving.md): ``True`` stamps
        ``verified_at_admission`` (the exact tier serves it with zero
        per-query verifier invocations), ``False`` flags the record
        ``unsound`` (stored for visibility, never served, never cached),
        ``None`` leaves it unstamped (the resolver verifies lazily,
        once)."""
        from tenzing_tpu_torch.bench.benchmarker import schedule_id
        from tenzing_tpu_torch.core.serdes import sequence_to_json
        from tenzing_tpu_torch.serve.fingerprint import schedule_key

        prov: Dict[str, Any] = {"tenant": self.tenant, "fid": fidelity}
        if source is not None:
            prov["source"] = os.path.basename(source)
        if extra_provenance:
            prov.update(extra_provenance)
        rec: Record = {
            "schema": RECORD_SCHEMA,
            "workload": fingerprint.workload,
            "exact": fingerprint.exact_digest,
            "bucket": fingerprint.bucket_digest,
            "fingerprint": fingerprint.to_json(),
            "key": schedule_key(seq),
            "sid": schedule_id(seq),
            "ops": sequence_to_json(seq),
            "pct50_us": float(pct50_us),
            "vs_naive": float(vs_naive),
            "provenance": prov,
            "sources": ([file_digest(source)]
                        if source is not None and os.path.exists(source)
                        else []),
            "flags": {},
        }
        if verified is True:
            rec["verified_at_admission"] = True
        elif verified is False:
            rec["flags"]["unsound"] = True
        get_metrics().counter("serve.store.added").inc()
        return self._put(rec)

    def flag(self, exact: str, key: str, **flags: Any) -> None:
        """Set sticky flags on a record (e.g. ``needs_refinement=True``
        from the resolver's near-miss tier) and persist — but only when
        something actually changed: a hot near-tier fingerprint re-flags
        on every query, and an already-set flag must not pay the full
        read-merge-fsync-rename cycle per request."""
        rec = self.entries.get(exact, {}).get(key)
        if rec is None:
            return
        cur = rec.setdefault("flags", {})
        if all(cur.get(k) == v for k, v in flags.items()):
            return
        cur.update(flags)
        # a flag mutation changes what may be served (unsound above
        # all): the resolver's exact cache must see it as a new
        # generation, same as a record landing
        self.generation += 1
        self.flush()

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(v) for v in self.entries.values())

    def records(self) -> List[Record]:
        return [r for by_key in self.entries.values()
                for r in by_key.values()]

    def best(self, exact: str) -> Optional[Record]:
        """The best record for an exact fingerprint digest, by the same
        total order merge resolves with — resolution and merge can never
        disagree about which schedule a fingerprint serves."""
        slot = self.entries.get(exact)
        if not slot:
            return None
        return max(slot.values(), key=_order_key)

    def exact_records(self, exact: str) -> List[Record]:
        """ALL records under an exact digest, best-first — the exact
        tier walks this so one unsound/unresolvable best record cannot
        permanently block a sound runner-up (resolver.py)."""
        slot = self.entries.get(exact)
        if not slot:
            return []
        return sorted(slot.values(), key=_order_key, reverse=True)

    def bucket_records(self, bucket: str,
                       exclude_exact: Optional[str] = None) -> List[Record]:
        """All records in a fingerprint bucket (the near-miss
        neighborhood), best-first, optionally excluding one exact
        digest (the requester's own)."""
        out = [r for r in self.records()
               if r.get("bucket") == bucket
               and (exclude_exact is None or r["exact"] != exclude_exact)]
        out.sort(key=_order_key, reverse=True)
        return out

    # -- merge / persistence ------------------------------------------------
    def merge_from(self, other: "ScheduleStore") -> int:
        """Merge another store's records into this one (see module
        docstring for the algebra); returns how many records were
        examined."""
        n = 0
        for rec in other.records():
            self._put(dict(rec))
            n += 1
        get_metrics().counter("serve.store.merged").inc(n)
        return n

    def to_json(self) -> Dict[str, Any]:
        return {"version": STORE_VERSION, "entries": self.entries}

    def flush(self) -> None:
        """Persist: re-read the file, merge (another writer may have
        flushed since our load), write atomically — the whole
        read-merge-rename held under an advisory ``flock`` on a sidecar
        ``<path>.lock`` so two *simultaneous* writers serialize instead
        of racing (without the lock, both could re-read the same disk
        state and the second rename would drop the first's records).
        The lock file is never renamed — flocking the store file itself
        would be defeated by the atomic-replace.  On platforms without
        ``fcntl`` the merge-on-flush still protects interleaved (
        non-simultaneous) writers."""
        if self.path is None:
            return
        # the flush span is the "store merge" leg of a request's
        # cross-process trace: under a drain's ambient context it stamps
        # the trace_id that started the cold query (obs/context.py)
        with get_tracer().span("serve.store.flush", backend="monolithic",
                               records=len(self)):
            # the CLI promises "created on first flush": the directory
            # must exist before the .lock sidecar opens (atomic_dump_json
            # would create it, but the lock comes first)
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            try:
                import fcntl
            except ImportError:  # pragma: no cover — non-POSIX fallback
                fcntl = None
            lock_f = None
            try:
                if fcntl is not None:
                    lock_f = open(self.path + ".lock", "w")
                    fcntl.flock(lock_f, fcntl.LOCK_EX)
                if os.path.exists(self.path):
                    # uncounted throwaway read + plain re-puts: this is
                    # flush bookkeeping, not a real load or merge — the
                    # documented store-economics counters must not grow
                    # with flush count
                    disk = ScheduleStore(self.path, tenant=self.tenant,
                                         log=self._log,
                                         _count_metrics=False)
                    for rec in disk.records():
                        self._put(dict(rec))
                # transient-EIO retries + the read-only latch on the
                # unwritable errno family (guarded_store_write above)
                guarded_store_write(
                    self.path,
                    lambda: atomic_dump_json(self.path, self.to_json(),
                                             prefix=".store."),
                    where="serve.store.flush")
            finally:
                if lock_f is not None:
                    lock_f.close()  # releases the flock
        get_metrics().counter("serve.store.flushed").inc()

    def stats(self) -> Dict[str, Any]:
        by_wl: Dict[str, int] = {}
        flagged = 0
        tenants = set()
        for rec in self.records():
            by_wl[rec.get("workload", "?")] = \
                by_wl.get(rec.get("workload", "?"), 0) + 1
            if any(rec.get("flags", {}).values()):
                flagged += 1
            t = rec.get("provenance", {}).get("tenant")
            if t:
                tenants.add(t)
        out = {
            "path": self.path,
            "fingerprints": len(self.entries),
            "records": len(self),
            "by_workload": dict(sorted(by_wl.items())),
            "flagged": flagged,
            "tenants": sorted(tenants),
            "skipped_on_load": self.skipped,
        }
        ro = store_readonly(self.path) if self.path else None
        if ro is not None:
            out["readonly"] = ro
        return out


def open_store(path: Optional[str], **kwargs) -> "ScheduleStore":
    """The store-backend dispatcher: a ``*.json`` path opens the monolithic
    :class:`ScheduleStore`; any other path — a directory, existing or not —
    opens the segmented store (serve/segments.py).  One rule for the
    service, the CLI and disaster recovery (serve/dr.py), so no two entry
    points disagree about what a store path means."""
    if path is None:
        return ScheduleStore(None, **kwargs)
    if path.endswith(".json") and not os.path.isdir(path):
        return ScheduleStore(path, **kwargs)
    from tenzing_tpu_torch.serve.segments import SegmentedStore

    return SegmentedStore(path, **kwargs)


class WorkQueue:
    """The cold-request queue: one checkpointed work item per missing
    fingerprint, written in the fault/checkpoint.py envelope format
    (``atomic_write_json`` — versioned, sha256-digest-checked) so a
    drainer validates an item with the same ``read_checked_json`` the
    resume path trusts.  The payload is a serialized
    :class:`~tenzing_tpu_torch.bench.driver.DriverRequest`:
    ``run(DriverRequest(**item["request"]))`` IS the drain step, and the
    suggested ``checkpoint`` directory makes the search itself
    kill-resumable.  Item filenames key on the exact fingerprint digest,
    so re-querying a cold fingerprint re-asserts one item instead of
    piling duplicates.

    The queue directory is also where the drain daemon
    (serve/daemon.py, docs/serving.md "Drain daemon") keeps its
    per-item protocol state, all keyed by the same exact digest:

    * ``lease-<exact>.json``  — a live claim (owner payload; the file's
      mtime is the heartbeat — a stale mtime is an expired lease);
    * ``fail-<exact>.json``   — the persistent failure history a poison
      verdict accumulates across daemon restarts;
    * ``poison-<exact>.json`` — a poisoned item (checkpoint envelope,
      ``kind: "poisoned_request"``) quarantined out of the drain loop;
    * ``ckpt-<exact>/``       — the item's ``SearchCheckpoint``
      directory (suggested at enqueue time, used by the drain);
    * ``status-<owner>.json`` — each daemon's liveness/status document.

    Only ``work-*.json`` files are queue *items*; every listing method
    here ignores the rest, and vice versa.
    """

    def __init__(self, directory: str):
        # the directory is created on first enqueue, NOT here: read-only
        # callers (serve stats/query before anything is queued, the
        # report CLI) must not silently materialize a typo'd --queue
        # path and then report an empty queue where the real one lives
        # elsewhere
        self.dir = directory
        # torn/corrupt item files seen by the LAST items() scan — the
        # visible-rot satellite: a drainer must skip a torn item, but
        # skipping silently hides queue damage from every dashboard
        self.torn_paths: List[str] = []
        # (name, mtime) pairs already counted, so a polling daemon does
        # not inflate serve.queue.torn once per scan of the same damage
        # (a rewrite of the file — new mtime — counts again)
        self._torn_seen: set = set()

    def path_for(self, exact: str) -> str:
        return os.path.join(self.dir, f"work-{exact}.json")

    def lease_path_for(self, exact: str) -> str:
        return os.path.join(self.dir, f"lease-{exact}.json")

    def fail_path_for(self, exact: str) -> str:
        return os.path.join(self.dir, f"fail-{exact}.json")

    def poison_path_for(self, exact: str) -> str:
        return os.path.join(self.dir, f"poison-{exact}.json")

    def checkpoint_dir_for(self, exact: str) -> str:
        return os.path.join(self.dir, f"ckpt-{exact}")

    @staticmethod
    def exact_of(path: str) -> str:
        """The exact fingerprint digest a queue file is keyed by."""
        name = os.path.basename(path)
        stem = name[:-len(".json")] if name.endswith(".json") else name
        return stem.split("-", 1)[1] if "-" in stem else stem

    def ensure(self, fingerprint, request: Dict[str, Any],
               reason: str, trace=None) -> str:
        """:meth:`enqueue` only when no valid item already exists for
        this fingerprint — the hot-path variant (the near tier
        re-resolves a popular fingerprint at fleet rates, and an
        identical re-write would pay json+sha256+fsync+rename per
        request); an existing-but-unreadable item IS rewritten.  The
        first enqueuer's trace context sticks: re-asserting queries do
        not rewrite the item, so the drain links back to the query that
        actually created the work."""
        path = self.path_for(fingerprint.exact_digest)
        if os.path.exists(path):
            try:
                read_checked_json(path)
                return path
            except Exception:
                pass  # torn/corrupt item: re-assert it below
        return self.enqueue(fingerprint, request, reason, trace=trace)

    def enqueue(self, fingerprint, request: Dict[str, Any],
                reason: str, trace=None) -> str:
        """``trace`` is an :class:`~tenzing_tpu_torch.obs.context.TraceContext`
        (or None): stamped into the checkpoint envelope so the drain —
        possibly days later, on another host, after the enqueuing
        process died — still runs under the originating query's
        trace_id (docs/observability.md "Fleet telemetry plane")."""
        os.makedirs(self.dir, exist_ok=True)
        path = self.path_for(fingerprint.exact_digest)
        doc = {
            "kind": "search_request",
            "reason": reason,
            "fingerprint": fingerprint.to_json(),
            "request": request,
            "checkpoint": self.checkpoint_dir_for(fingerprint.exact_digest),
        }
        if trace is not None:
            doc["trace"] = trace.to_json()
        atomic_write_json(path, doc)
        get_metrics().counter("serve.queue.enqueued").inc()
        tr = get_tracer()
        if tr.enabled:
            tr.event("serve.enqueue", exact=fingerprint.exact_digest,
                     reason=reason, workload=fingerprint.workload)
        return path

    def items(self) -> List[Tuple[str, Dict[str, Any]]]:
        """(path, payload) per valid queued item; invalid files are
        skipped (a drainer must never crash on one torn item), and a
        not-yet-created queue directory is simply empty.  Torn/corrupt
        item files are *counted* (``serve.queue.torn`` + a
        ``serve.queue.torn_item`` tracer event, deduped per damaged
        version) and kept in :attr:`torn_paths` so queue rot is visible
        in ``serve stats`` and the report CLI instead of silently
        shrinking the depth."""
        out = []
        torn: List[str] = []
        torn_keys: set = set()
        if not os.path.isdir(self.dir):
            self._torn_seen = torn_keys
            self.torn_paths = torn
            return out
        for name in sorted(os.listdir(self.dir)):
            if not (name.startswith("work-") and name.endswith(".json")):
                continue
            path = os.path.join(self.dir, name)
            try:
                out.append((path, read_checked_json(path)))
            except Exception as e:
                torn.append(path)
                try:
                    key = (name, os.path.getmtime(path))
                except OSError:
                    key = (name, None)
                torn_keys.add(key)
                if key not in self._torn_seen:
                    self._torn_seen.add(key)
                    get_metrics().counter("serve.queue.torn").inc()
                    tr = get_tracer()
                    if tr.enabled:
                        tr.event("serve.queue.torn_item", file=name,
                                 error=type(e).__name__,
                                 message=str(e)[:200])
                continue
        # the dedup set tracks only the *currently* torn versions — a
        # long-lived poller facing an ever-rewriting broken producer must
        # not accumulate one key per damaged version forever
        self._torn_seen &= torn_keys
        self.torn_paths = torn
        return out

    def leases(self) -> List[Dict[str, Any]]:
        """Live-claim documents, one per ``lease-*.json``: the owner
        payload (tolerating a torn lease — only the mtime is
        load-bearing for expiry) plus ``age_s`` since the last heartbeat
        renewal."""
        out: List[Dict[str, Any]] = []
        if not os.path.isdir(self.dir):
            return out
        now = time.time()
        for name in sorted(os.listdir(self.dir)):
            if not (name.startswith("lease-") and name.endswith(".json")):
                continue
            path = os.path.join(self.dir, name)
            doc: Dict[str, Any] = {"path": path,
                                   "exact": self.exact_of(path)}
            try:
                doc["age_s"] = round(now - os.path.getmtime(path), 3)
            except OSError:
                continue  # released between listdir and stat
            try:
                with open(path) as f:
                    doc.update(json.load(f))
            except (OSError, ValueError):
                pass  # claim raced mid-publish; mtime alone still counts
            out.append(doc)
        return out

    def poisoned(self) -> List[Tuple[str, Dict[str, Any]]]:
        """(path, payload) per poison-quarantined item (the drain
        daemon's deterministic-failure verdicts, docs/serving.md);
        unreadable poison files are returned with an ``unreadable``
        payload rather than hidden — poison is exactly the rot a
        dashboard must see."""
        out: List[Tuple[str, Dict[str, Any]]] = []
        if not os.path.isdir(self.dir):
            return out
        for name in sorted(os.listdir(self.dir)):
            if not (name.startswith("poison-") and name.endswith(".json")):
                continue
            path = os.path.join(self.dir, name)
            try:
                out.append((path, read_checked_json(path)))
            except Exception as e:
                out.append((path, {"unreadable": f"{type(e).__name__}: "
                                                 f"{str(e)[:200]}"}))
        return out

    def stats(self) -> Dict[str, Any]:
        """Queue occupancy for ``serve stats`` and the report CLI:
        depth + reasons, the torn set (visible rot), live leases, and
        poison quarantine size."""
        items = self.items()
        by_reason: Dict[str, int] = {}
        for _, payload in items:
            r = payload.get("reason", "?")
            by_reason[r] = by_reason.get(r, 0) + 1
        return {
            "dir": self.dir,
            "depth": len(items),
            "reasons": sorted(by_reason),
            "by_reason": dict(sorted(by_reason.items())),
            "torn": [os.path.basename(p) for p in self.torn_paths],
            "leases": self.leases(),
            "poisoned": [os.path.basename(p) for p, _ in self.poisoned()],
        }

    def __len__(self) -> int:
        return len(self.items())
