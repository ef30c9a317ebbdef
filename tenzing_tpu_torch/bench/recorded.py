"""Cross-run search memory: rank recorded search-database rows for warm
starts.

Counterpart of ``tenzing_tpu/bench/recorded.py``.  The driver dumps every
run's measured schedules as a CSV database (``--dump-csv``: one row per
distinct schedule, naive as row 0 at full fidelity; the reader and the row
writer are ``bench/benchmarker.py``'s ``CsvBenchmarker`` and
``result_row``).  :func:`rank_recorded` turns a set of such databases into
the best distinct schedules to carry into the next run as candidates and
as a climb seed.

Rows are ranked by their paired ratio against their own file's row-0
anchor: absolute times are not comparable across files recorded in
different regimes (on another machine, or another device altogether — the
repository's ``experiments/*_search_tpu_*.csv`` were recorded on a TPU, so
their ratios only rank rows; a picked row counts once the card measures it).
"""

from typing import List, Optional, Tuple

from tenzing_tpu_torch.bench.benchmarker import (  # noqa: F401 (re-exported)
    CSV_DELIM,
    CsvBenchmarker,
    result_row,
    split_fidelity,
)
from tenzing_tpu_torch.core.schedule import remove_redundant_syncs
from tenzing_tpu_torch.core.sequence import Sequence, canonical_key


def naive_anchor_of(path: str) -> Optional[float]:
    """The file's row-0 pct50, read as a number (the naive ops themselves
    need not resolve against the graph).  None when the file has no row 0,
    or when row 0 carries a fidelity other than "full": an anchor measured
    at another floor would skew every in-file ratio."""
    with open(path) as f:
        first = f.readline().split(CSV_DELIM)
    try:
        if not first or first[0] != "0":
            return None
        fid, _ = split_fidelity([c.strip() for c in first])
        if fid != "full":
            return None
        return float(first[3])
    except (ValueError, IndexError):
        return None


def scored_rows(paths: List[str], graph, log=None
                ) -> Tuple[List[Tuple[float, float, Sequence, str]], dict]:
    """``(scored, stats)``: every admissible recorded row across ``paths``
    as ``(in-file ratio, pct50, sequence, source path)``, best ratio first,
    and ``{"files", "rows", "skipped"}`` counts.

    A row is admitted when it is full fidelity, its pct50 is positive and
    it beats its own file's naive anchor.  Rows that do not resolve against
    ``graph`` are skipped (``strict=False``); a file without an anchor
    contributes nothing; an unreadable file is reported and passed over."""
    scored: List[Tuple[float, float, Sequence, str]] = []
    n_files = n_rows = n_skip = 0
    for path in paths:
        try:
            anchor = naive_anchor_of(path)
            db = CsvBenchmarker.from_file(path, graph, strict=False,
                                          normalize=True)
        except Exception as e:
            if log:
                log(f"recorded db: {path} unreadable ({e})")
            continue
        n_files += 1
        n_rows += len(db.entries)
        n_skip += len(db.skipped)
        assert len(db.fidelities) == len(db.entries)
        if anchor is None:
            continue
        for (seq, res), fid in zip(db.entries, db.fidelities):
            if fid == "full" and res.pct50 > 0 and anchor / res.pct50 > 1.0:
                scored.append((anchor / res.pct50, res.pct50, seq, path))
    scored.sort(key=lambda e: -e[0])
    return scored, {"files": n_files, "rows": n_rows, "skipped": n_skip}


def rank_recorded(paths: List[str], graph, topk: int, log=None,
                  stats: Optional[dict] = None) -> List[Tuple[Sequence, float]]:
    """The top ``topk`` distinct recorded schedules across ``paths``, best
    in-file ratio first (admission: :func:`scored_rows`).  Two rows are the
    same schedule when they are equal modulo ``remove_redundant_syncs``
    under ``canonical_key`` (the equivalence ``CsvBenchmarker`` matches
    on with ``normalize=True``).  ``stats``, where given, receives
    :func:`scored_rows`' counts."""
    scored, counts = scored_rows(paths, graph, log=log)
    if stats is not None:
        stats.update(counts)
    seen: set = set()
    out: List[Tuple[Sequence, float]] = []
    for ratio, _pct50, seq, _path in scored:
        if len(out) >= topk:
            break
        key = canonical_key(remove_redundant_syncs(seq))
        if key in seen:
            continue
        seen.add(key)
        out.append((seq, ratio))
    if log and paths:
        log(f"recorded db: {len(paths)} files, {counts['rows']} rows "
            f"({counts['skipped']} skipped), carrying top {len(out)} by "
            "in-file ratio: " + ", ".join(f"{r:.3f}" for _, r in out))
    return out
