"""Reading driver verdicts back.

Counterpart of ``tenzing_tpu/obs/report.py``, of which only
:func:`load_driver_json` (:70-97) is ported: the schedule service stamps a
warmed record with the verdicts it finds (serve/service.py
``warm(bench_globs=)``).  The rest of the report — the corpus, queue and
fleet sections and ``python -m tenzing_tpu.obs.report`` — is ROADMAP Queue
1 item 8c.
"""

from __future__ import annotations

import json
from typing import Any, Dict


def load_driver_json(path: str) -> Dict[str, Any]:
    """A driver verdict dict from ``path``: a raw driver JSON object or
    line, a file whose last line holding one is the driver JSON (a captured
    stdout), or a ``BENCH_*.json`` wrapper (its ``parsed`` field)."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
        if isinstance(doc, dict):
            if "parsed" in doc and isinstance(doc["parsed"], dict):
                return doc["parsed"]
            if "metric" in doc:
                return doc
    except ValueError:
        pass
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict) and "metric" in doc:
            return doc
    raise ValueError(f"{path}: no driver JSON found")
