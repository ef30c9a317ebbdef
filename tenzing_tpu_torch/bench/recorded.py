"""The search database's row writer: ``result_row``.

Counterpart of the row writer the reference's DFS and MCTS dumps use
(``tenzing_tpu/bench/benchmarker.py`` ``result_row``; the reference's
mcts.cpp:13-31 / dfs.cpp:84-105 dump format).  The reader, the recorded warm
starts and their ranking come with a later slice.
"""

from __future__ import annotations

import json
from typing import Optional

CSV_DELIM = "|"


def result_row(idx: int, res, order, fidelity: Optional[str] = None) -> str:
    """One CSV row: ``idx|pct01|pct10|pct50|pct90|pct99|stddev|op-json|...``.
    ``fidelity`` (e.g. "screen") inserts a ``fid=<tag>`` cell before the ops;
    a tag containing the delimiter is rejected."""
    if fidelity is not None and CSV_DELIM in fidelity:
        raise ValueError(f"fidelity tag {fidelity!r} contains the CSV delimiter")
    cells = [
        str(idx),
        # float() first: a numpy scalar's repr would not parse back
        repr(float(res.pct01)),
        repr(float(res.pct10)),
        repr(float(res.pct50)),
        repr(float(res.pct90)),
        repr(float(res.pct99)),
        repr(float(res.stddev)),
    ] + ([f"fid={fidelity}"] if fidelity is not None else []) + [
        # '|' can only occur inside JSON strings; the | escape keeps the
        # cell valid JSON while making the row safely splittable
        json.dumps(op.to_json()).replace(CSV_DELIM, "\\u007c")
        for op in order
    ]
    return CSV_DELIM.join(cells)
