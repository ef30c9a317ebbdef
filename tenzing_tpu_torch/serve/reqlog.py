"""The request log and the tail-sampled exemplars: the record of what the
listen loop served.

Counterpart of ``tenzing_tpu/serve/reqlog.py``, the same formats: a log or
an exemplar bundle written by either package reads in the other.

**Request log** (:class:`RequestLog`) — ``serve listen --record DIR``
appends one compact record per admitted request (timestamp, trace_id,
tenant, tier, fingerprint digests, ``resolve_us`` and its phases, the shed
or timeout outcome, and the request's own kwargs, so the query can be
issued again) to a sampled, size-bounded, checksummed JSONL log, sealed as
the segmented store seals its segments (serve/segments.py):

* records buffer in memory and publish as sealed segments
  (``req-<stamp>-<owner>-<n>.jsonl``): line 0 a header (``kind:
  "reqlog_segment"``, version, counts, the cumulative count dropped by
  sampling), each further line ``{"sha256", "record"}`` over the record's
  canonical serialization, so every line certifies itself;
* a publish is atomic (utils/atomic.py ``publish_sealed``): a reader never
  sees a torn acknowledged segment, and a SIGKILLed writer loses at most
  its unpublished buffer;
* **sampling** is decided per ``trace_id`` by a stable hash, never a
  process RNG (the solvers' seeded streams stay as they are), and what it
  drops is counted (``position()``, the segment headers,
  ``serve.reqlog.sampled_out``);
* **rotation**: the oldest segments beyond ``retain_segments`` are
  reclaimed, so the directory stays bounded.

:func:`read_request_log` reads a log and salvages damage: bit-flipped lines
are skipped and counted, a truncated segment yields its checksum-valid
prefix, a segment of a newer version is skipped loudly — the segmented
store's taxonomy, strictly read-only.

**Exemplars** (:class:`ExemplarStore`) — a histogram says the pct99 is
bad, not which request made it so.  The listen loop keeps whole span
bundles only for the requests worth a look: the slowest K served in each
heartbeat window, and at once every shed, timed-out, failed or unverified
one.  Each is a JSONL bundle (``exemplar-<trace>-<reason>.jsonl``: line 0 a
header with the request's record, then the tracer's span and event records
of that trace_id), bounded to ``cap`` files, the oldest evicted first.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tenzing_tpu_torch.fault.backoff import BackoffPolicy, retry_call
from tenzing_tpu_torch.fault.errors import is_transient_io
from tenzing_tpu_torch.obs.metrics import get_metrics
# THE per-line checksum, owner-token and sealed-publish helpers —
# shared with the segmented store so neither the checksum format nor
# the publish discipline can silently diverge between the two
from tenzing_tpu_torch.serve.segments import _owner_token, record_digest
from tenzing_tpu_torch.utils.atomic import publish_sealed

# transient-EIO retries for a segment publish — short and bounded: the
# recorder rides the heartbeat thread, not the request path
_PUBLISH_RETRY = BackoffPolicy(retries=2, base_secs=0.05, factor=4.0,
                               max_secs=0.5, jitter=0.25)

REQLOG_VERSION = 1
EXEMPLAR_VERSION = 1

RECORD_VERSION = 1          # the per-request record's "v" field
SAMPLE_BUCKETS = 1 << 16    # sampling quantum (per-trace hash space)


def is_reqlog_segment(name: str) -> bool:
    return name.startswith("req-") and name.endswith(".jsonl")


def sampled_in(trace_id: str, sample: float) -> bool:
    """Deterministic admission draw for one request: a stable hash of
    the trace_id against the sample rate.  Hash-based, not RNG-based —
    recording must never perturb the seeded solver streams, and the
    same trace must draw the same verdict on every host that sees it
    (a gateway retry is one request, not two coin flips)."""
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    h = hashlib.sha1(str(trace_id).encode()).digest()
    bucket = int.from_bytes(h[:4], "big") % SAMPLE_BUCKETS
    return bucket < int(sample * SAMPLE_BUCKETS)


class RequestLog:
    """The sampled, size-bounded, checksummed request log (module
    docstring).  Thread-safe: the listen loop appends from worker,
    watchdog and intake threads alike.  A full buffer rotates into a
    *pending* sealed batch without any I/O — the fsync-heavy publish
    runs from the heartbeat (:meth:`publish_pending` / :meth:`flush`),
    never on the request path, unless the pending backlog exceeds
    ``pending_batch_cap`` batches (extreme-storm backpressure: inline
    publish then beats unbounded memory)."""

    def __init__(self, directory: str, owner: str = "",
                 sample: float = 1.0, segment_records: int = 256,
                 retain_segments: int = 16, pending_batch_cap: int = 16,
                 log: Optional[Callable[[str], None]] = None):
        self.dir = directory
        self.owner = _owner_token(
            owner or f"{socket.gethostname()}-{os.getpid()}")
        self.sample = float(sample)
        self.segment_records = max(1, int(segment_records))
        self.retain_segments = max(1, int(retain_segments))
        self.pending_batch_cap = max(1, int(pending_batch_cap))
        self._log = log
        self._lock = threading.Lock()
        self._buffer: List[Dict[str, Any]] = []
        self._pending: List[List[Dict[str, Any]]] = []
        self._seg_counter = 0
        self.records_written = 0
        self.bytes_written = 0
        self.dropped_sampling = 0
        self.segments_published = 0
        self.segments_reclaimed = 0
        # count-and-drop bookkeeping (the store's read-only mode): a
        # full or hostile filesystem costs records,
        # visibly, never the serving path — both surface in position()
        self.dropped_write = 0
        self.write_errors = 0
        self.last_segment: Optional[str] = None

    def _note(self, msg: str) -> None:
        if self._log is not None:
            self._log(msg)

    def append(self, record: Dict[str, Any]) -> bool:
        """Record one request; False when the sampling draw dropped it
        (counted, never silent).  A full buffer rotates into a pending
        sealed batch with no I/O on this (request-path) thread."""
        if not sampled_in(record.get("trace_id") or "", self.sample):
            with self._lock:
                self.dropped_sampling += 1
            get_metrics().counter("serve.reqlog.sampled_out").inc()
            return False
        # coerce to plain JSON NOW (default=str absorbs stray bytes /
        # numpy scalars a caller smuggled into request kwargs): a
        # non-serializable record surfacing at segment-publish time
        # would throw away every other buffered record with it
        record = json.loads(json.dumps(record, sort_keys=True,
                                       default=str))
        overflow: Optional[List[List[Dict[str, Any]]]] = None
        with self._lock:
            self._buffer.append(record)
            if len(self._buffer) >= self.segment_records:
                self._pending.append(self._buffer)
                self._buffer = []
                if len(self._pending) > self.pending_batch_cap:
                    # backpressure: the heartbeat is not keeping up with
                    # an extreme storm — pay the publish inline rather
                    # than grow memory without bound
                    overflow, self._pending = self._pending, []
        get_metrics().counter("serve.reqlog.recorded").inc()
        for batch in overflow or []:
            self._publish(batch)
        return True

    def publish_pending(self) -> int:
        """Publish every full sealed batch (the cheap per-heartbeat
        hook; a no-op when nothing rotated since the last call)."""
        with self._lock:
            batches, self._pending = self._pending, []
        for batch in batches:
            self._publish(batch)
        return len(batches)

    def flush(self) -> Optional[str]:
        """Publish pending batches plus whatever is part-buffered (the
        drain / cadence hook); None when everything was already out."""
        n = self.publish_pending()
        with self._lock:
            recs, self._buffer = self._buffer, []
        if not recs:
            return self.last_segment if n else None
        return self._publish(recs)

    def _publish(self, recs: List[Dict[str, Any]]) -> Optional[str]:
        """Seal + atomically publish one segment, then apply retention
        (utils/atomic.py ``publish_sealed`` — the same discipline as
        the segmented store's segments).  Transient EIO retries through
        THE shared backoff; a publish that still fails (ENOSPC, dead
        disk) **counts and drops** the batch — recording must degrade,
        never wedge the loop or grow memory without bound.  Returns the
        published name, or None when the batch was dropped."""
        with self._lock:
            dropped = self.dropped_sampling
        header = {"kind": "reqlog_segment", "version": REQLOG_VERSION,
                  "n_records": len(recs), "owner": self.owner,
                  "created_at": time.time(),
                  # cumulative, so a reader can report recording
                  # coverage without the writer process being alive
                  "dropped_sampling": dropped}
        body = [json.dumps(header, sort_keys=True)]
        body += [json.dumps({"sha256": record_digest(r), "record": r},
                            sort_keys=True) for r in recs]
        text = "\n".join(body) + "\n"

        def make_name() -> str:
            with self._lock:
                self._seg_counter += 1
                n = self._seg_counter
            return (f"req-{int(time.time() * 1e6)}-"
                    f"{self.owner}-{n}.jsonl")

        try:
            name = retry_call(
                lambda: publish_sealed(self.dir, make_name, text),
                policy=_PUBLISH_RETRY, retry_on=is_transient_io,
                where="serve.reqlog.publish")
        except OSError as e:
            with self._lock:
                self.dropped_write += len(recs)
                self.write_errors += 1
            get_metrics().counter(
                "serve.reqlog.dropped_write").inc(len(recs))
            self._note(f"reqlog: dropped {len(recs)} record(s), publish "
                       f"failed ({e})")
            return None
        with self._lock:
            self.records_written += len(recs)
            self.bytes_written += len(text)
            self.segments_published += 1
            self.last_segment = name
        get_metrics().counter("serve.reqlog.segments").inc()
        self._retain()
        return name

    def _retain(self) -> None:
        """Reclaim the oldest sealed segments beyond the retention cap
        (names sort by their microsecond stamp — lexicographic order is
        publish order for one writer; cross-writer ties don't matter,
        retention is a bound, not an ordering contract)."""
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if is_reqlog_segment(n))
        except OSError:
            return
        n_excess = len(names) - self.retain_segments
        for name in names[:max(0, n_excess)]:
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                continue
            with self._lock:
                self.segments_reclaimed += 1
            get_metrics().counter("serve.reqlog.reclaimed").inc()

    def position(self) -> Dict[str, Any]:
        """Where the recorder stands — the block metric snapshots carry
        so the recorder is itself observable: current segment, bytes/records published, buffered backlog, and
        the dropped-by-sampling count."""
        with self._lock:
            return {
                "dir": self.dir,
                "sample": self.sample,
                "segment": self.last_segment,
                "segments": self.segments_published,
                "segments_reclaimed": self.segments_reclaimed,
                "records": self.records_written,
                "bytes": self.bytes_written,
                # buffered = everything acknowledged but not yet sealed
                # on disk: the open buffer plus rotated pending batches
                "buffered": (len(self._buffer)
                             + sum(len(b) for b in self._pending)),
                "dropped_sampling": self.dropped_sampling,
                "dropped_write": self.dropped_write,
                "write_errors": self.write_errors,
            }


def read_request_log(directory: str,
                     log: Optional[Callable[[str], None]] = None
                     ) -> Dict[str, Any]:
    """Salvage-on-damage read of a request-log directory (module
    docstring).  Returns ``{"records": [...], "segments", "damaged",
    "checksum_failed", "torn_lines", "newer_skipped",
    "dropped_sampling"}`` — records sorted by their ``ts`` stamp so
    inter-arrival reconstruction is order-correct.  Strictly read-only:
    damage is counted and reported, never quarantined (the writer owns
    its directory)."""

    def note(msg: str) -> None:
        if log is not None:
            log(msg)

    out: Dict[str, Any] = {"records": [], "segments": 0, "damaged": 0,
                           "checksum_failed": 0, "torn_lines": 0,
                           "newer_skipped": 0, "dropped_sampling": 0}
    # the header count is cumulative PER WRITER: max within an owner,
    # summed across owners (two loops recording into one directory must
    # not have one's coverage shadow the other's)
    dropped_by_owner: Dict[str, int] = {}
    try:
        names = sorted(n for n in os.listdir(directory)
                       if is_reqlog_segment(n))
    except OSError as e:
        raise OSError(f"request log {directory} unreadable: {e}") from e
    for name in names:
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            continue  # reclaimed between listdir and open
        damaged = False
        header: Dict[str, Any] = {}
        if lines:
            try:
                header = json.loads(lines[0])
                if not isinstance(header, dict) or \
                        header.get("kind") != "reqlog_segment":
                    raise ValueError("not a reqlog segment header")
            except ValueError:
                header, damaged = {}, True
        else:
            damaged = True
        if header.get("version", 0) > REQLOG_VERSION:
            out["newer_skipped"] += 1
            note(f"reqlog: segment {name} has newer version "
                 f"{header.get('version')!r}; skipped")
            continue
        own = str(header.get("owner", "?"))
        dropped_by_owner[own] = max(
            dropped_by_owner.get(own, 0),
            int(header.get("dropped_sampling") or 0))
        n_valid = 0
        for line in lines[1:]:
            if not line.strip():
                continue
            try:
                j = json.loads(line)
            except ValueError:
                out["torn_lines"] += 1
                damaged = True
                continue
            rec = j.get("record") if isinstance(j, dict) else None
            if not isinstance(rec, dict) or \
                    record_digest(rec) != j.get("sha256"):
                out["checksum_failed"] += 1
                damaged = True
                continue
            out["records"].append(rec)
            n_valid += 1
        n_expected = header.get("n_records")
        if isinstance(n_expected, int) and n_valid < n_expected:
            damaged = True
        if damaged:
            out["damaged"] += 1
            note(f"reqlog: segment {name} damaged; salvaged "
                 f"{n_valid} record(s)")
        out["segments"] += 1
    out["dropped_sampling"] = sum(dropped_by_owner.values())
    out["records"].sort(key=lambda r: (r.get("ts") or 0.0))
    return out


# -- tail-sampled exemplars --------------------------------------------------

# outcomes that make a request interesting unconditionally (module
# docstring): its full span bundle is written immediately, never
# subject to the slowest-K window
ALWAYS_KEEP = ("shed", "timeout", "error", "unverified")


class ExemplarStore:
    """Tail-sampled span bundles for the requests behind a bad pct99
    (module docstring).  ``offer`` every completed request; the
    heartbeat calls :meth:`roll` to close the current window and write
    the slowest ``k`` served exemplars; interesting outcomes write
    immediately.  Thread-safe, bounded to ``cap`` files."""

    def __init__(self, directory: str, k: int = 4, cap: int = 64,
                 immediate_per_window: int = 8, tracer=None,
                 log: Optional[Callable[[str], None]] = None):
        self.dir = directory
        self.k = max(0, int(k))
        self.cap = max(1, int(cap))
        # interesting outcomes write on the REQUEST path (intake /
        # watchdog thread), and a shed storm makes them anything but
        # rare — the per-window budget keeps overload from buying an
        # O(tracer-ring) snapshot + a file write per rejected request;
        # beyond it the storm is counted (suppressed), never amplified
        self.immediate_per_window = max(1, int(immediate_per_window))
        self._immediate_left = self.immediate_per_window
        self.suppressed = 0
        self._tracer = tracer
        self._log = log
        self._lock = threading.Lock()
        # the current window's served candidates: (resolve_us, record)
        self._window: List[Tuple[float, Dict[str, Any]]] = []
        self.written = 0
        self._seq = 0  # filename uniquifier (batch members share a trace)

    def offer(self, record: Dict[str, Any],
              interesting: Optional[str] = None) -> Optional[str]:
        """One completed request.  ``interesting`` (an
        :data:`ALWAYS_KEEP` reason) writes the bundle now — up to the
        per-window budget; otherwise the record becomes a slowest-K
        candidate for the current window."""
        if interesting is not None:
            with self._lock:
                if self._immediate_left <= 0:
                    self.suppressed += 1
                    over_budget = True
                else:
                    self._immediate_left -= 1
                    over_budget = False
            if over_budget:
                get_metrics().counter("serve.exemplars.suppressed").inc()
                return None
            return self._write(record, interesting)
        us = record.get("resolve_us")
        if us is None:
            return None
        with self._lock:
            self._window.append((float(us), record))
            # bound the candidate list between rolls: only the current
            # top-k can ever be written, so keep a small multiple
            if len(self._window) > max(32, 4 * self.k):
                self._window.sort(key=lambda t: -t[0])
                del self._window[max(32, 4 * self.k):]
        return None

    def roll(self) -> List[str]:
        """Close the window: write the slowest-K served candidates seen
        since the last roll and refill the immediate-write budget (the
        heartbeat hook).  ONE tracer snapshot serves the whole roll —
        never one per exemplar."""
        with self._lock:
            window, self._window = self._window, []
            self._immediate_left = self.immediate_per_window
        window.sort(key=lambda t: -t[0])
        top = window[:self.k]
        if not top:
            return []
        by_trace = self._trace_records_many(
            [str(rec.get("trace_id") or "no-trace") for _, rec in top])
        out = []
        for _, rec in top:
            tid = str(rec.get("trace_id") or "no-trace")
            p = self._write(rec, "slow", trace_recs=by_trace.get(tid, []))
            if p is not None:
                out.append(p)
        return out

    def _trace_records_many(self, trace_ids: List[str]
                            ) -> Dict[str, List[Dict[str, Any]]]:
        """The tracer's span/event records bucketed by ``trace_id`` —
        ONE O(ring) snapshot shared by every requested trace (a roll
        writes K exemplars from a single scan; the immediate path pays
        one scan per write, bounded by the per-window budget)."""
        wanted = set(trace_ids)
        out: Dict[str, List[Dict[str, Any]]] = {t: [] for t in wanted}
        tracer = self._tracer
        if tracer is None:
            from tenzing_tpu_torch.obs.tracer import get_tracer
            tracer = get_tracer()
        if not wanted or not getattr(tracer, "enabled", False):
            return out
        spans, events, open_spans = tracer.snapshot(block=False,
                                                    flush_open=True)
        for r in spans + open_spans + events:
            j = r.to_json()
            tid = (j.get("attrs") or {}).get("trace_id")
            if tid in wanted:
                out[tid].append(j)
        for recs in out.values():
            recs.sort(key=lambda r: r.get("ts_us", 0.0))
        return out

    def _write(self, record: Dict[str, Any], reason: str,
               trace_recs: Optional[List[Dict[str, Any]]] = None
               ) -> Optional[str]:
        trace_id = str(record.get("trace_id") or "no-trace")
        if trace_recs is None:
            trace_recs = self._trace_records_many([trace_id])[trace_id]
        with self._lock:
            self._seq += 1
            seq = self._seq
        # the sequence uniquifies the name: every member of a shed or
        # errored batch shares the pending's one trace_id, and N bundles
        # overwriting one file would silently lose N-1 of them
        name = (f"exemplar-{_owner_token(trace_id)[:16]}-{reason}"
                f"-{seq}.jsonl")
        path = os.path.join(self.dir, name)
        header = {"kind": "exemplar", "version": EXEMPLAR_VERSION,
                  "reason": reason, "trace_id": trace_id,
                  "written_at": time.time(), "record": record}
        lines = [json.dumps(header, sort_keys=True, default=str)]
        lines += [json.dumps(r, sort_keys=True, default=str)
                  for r in trace_recs]
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write("\n".join(lines) + "\n")
            os.replace(tmp, path)
        except OSError as e:
            if self._log is not None:
                self._log(f"exemplar write failed ({e})")
            return None
        with self._lock:
            self.written += 1
        get_metrics().counter("serve.exemplars.written").inc()
        self._evict()
        return path

    def _evict(self) -> None:
        """Oldest-first eviction beyond ``cap`` (mtime order: exemplar
        names key on trace_id, so name order is meaningless here)."""
        try:
            entries = [(os.path.getmtime(os.path.join(self.dir, n)), n)
                       for n in os.listdir(self.dir)
                       if n.startswith("exemplar-") and
                       n.endswith(".jsonl")]
        except OSError:
            return
        entries.sort()
        for _, name in entries[:max(0, len(entries) - self.cap)]:
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                continue


def read_exemplars(directory: str) -> List[Dict[str, Any]]:
    """The exemplar headers found in ``directory`` (newest first): the
    worst requests behind the pct99.  Their span lines stay on disk."""
    out: List[Tuple[float, Dict[str, Any]]] = []
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("exemplar-") and n.endswith(".jsonl")]
    except OSError:
        return []
    for name in names:
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                header = json.loads(f.readline())
                n_lines = sum(1 for line in f if line.strip())
        except (OSError, ValueError):
            continue
        if not isinstance(header, dict) or header.get("kind") != "exemplar":
            continue
        header["path"] = path
        header["n_trace_records"] = max(0, n_lines)
        out.append((float(header.get("written_at") or 0.0), header))
    out.sort(key=lambda t: -t[0])
    return [h for _, h in out]
