"""Persistent per-schedule quarantine of deterministic failures.

Counterpart of ``tenzing_tpu/fault/quarantine.py``.  A schedule that fails
deterministically (it cannot be captured, it does not fit, the verifier
rejects it) fails the same way every time; the quarantine records it by its
telemetry schedule id (``bench.benchmarker.schedule_id``, the id every span
and event carries) and answers later queries at once.

File format (the reference's): ``{"version": 1, "entries": {<schedule id>:
{"error": <exception type>, "error_class": ..., "message": ...,
"n_ops": ...}}}``, rewritten atomically (utils/atomic.py) on every
addition.  A missing or unreadable file is an empty quarantine — the
quarantine saves work, it decides nothing — but an unreadable one is
reported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from tenzing_tpu_torch.bench.benchmarker import schedule_id
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.utils.atomic import atomic_dump_json

QUARANTINE_VERSION = 1


class Quarantine:
    """The set of broken schedule ids, file-backed when ``path`` is given
    (loaded by the constructor, persisted by every :meth:`add`)."""

    def __init__(self, path: Optional[str] = None, log=None):
        self.path = path
        self._log = log
        self.entries: Dict[str, dict] = {}
        if path is not None and os.path.exists(path):
            self._load(path)

    def _load(self, path: str) -> None:
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc.get("version") != QUARANTINE_VERSION:
                raise ValueError(
                    f"quarantine version {doc.get('version')!r} != "
                    f"{QUARANTINE_VERSION}")
            self.entries = dict(doc["entries"])
        except Exception as e:
            self.entries = {}
            if self._log is not None:
                self._log(f"quarantine: ignoring unreadable {path}: "
                          f"{type(e).__name__}: {e}")

    def __len__(self) -> int:
        return len(self.entries)

    def key(self, order) -> str:
        return schedule_id(order)

    def check(self, order) -> Optional[dict]:
        """The quarantine record of ``order``, or None when clean."""
        return self.entries.get(self.key(order))

    def add(self, order, exc: BaseException, error_class: str) -> str:
        """Quarantine ``order`` (idempotent) and persist; returns its id."""
        sid = self.key(order)
        if sid not in self.entries:
            self.entries[sid] = {
                "error": type(exc).__name__,
                "error_class": error_class,
                "message": str(exc)[:500],
                "n_ops": len(order) if hasattr(order, "__len__") else None,
            }
            get_metrics().counter("fault.quarantined").inc()
            tr = get_tracer()
            if tr.enabled:
                tr.event("fault.quarantine", schedule=sid,
                         error=type(exc).__name__, error_class=error_class)
            self._persist()
        return sid

    def _persist(self) -> None:
        if self.path is None:
            return
        atomic_dump_json(
            self.path,
            {"version": QUARANTINE_VERSION, "entries": self.entries},
            prefix=".quarantine.")
