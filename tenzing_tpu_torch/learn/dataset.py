"""Measurement-corpus ingestion: search databases -> normalized training
rows.

Counterpart of ``tenzing_tpu/learn/dataset.py``.  Every search run archives
its measurements as a CSV database (``--dump-csv``, naive as row 0 at full
fidelity) and, with ``--trace-out``, a telemetry bundle whose
``bench.benchmark`` spans name each measured schedule.  This module turns a
set of such archives into one corpus:

* rows parse through the replay reader (bench/benchmarker.py
  ``CsvBenchmarker``, ``strict=False``: a row of another structural variant
  is skipped, not fatal);
* **labels are in-file ratios**, ``log(pct50 / anchor)`` against the file's
  own row-0 naive anchor (bench/recorded.py ``naive_anchor_of``): absolute
  times from different runs, or from different devices, never mix;
* **only full-fidelity rows train**; a file without a full-fidelity anchor
  contributes nothing;
* rows are keyed by the ``canonical_key`` of the sync-normalized sequence,
  and duplicate recordings of one program merge into one row with the
  geometric-mean ratio.

:meth:`Corpus.attach_traces` joins ``--trace-out`` bundles
(obs/export.py ``read_jsonl``) by schedule id, counting each row's
``bench.benchmark`` spans.  A corpus may hold another device's databases
(the TPU's in ``experiments/``): the ratios are valid training data for
that device's model, never for the card's numbers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tenzing_tpu_torch.bench.benchmarker import CsvBenchmarker, schedule_id
from tenzing_tpu_torch.bench.recorded import naive_anchor_of
from tenzing_tpu_torch.core.schedule import remove_redundant_syncs
from tenzing_tpu_torch.core.sequence import Sequence, canonical_key
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer


@dataclass
class CorpusRow:
    """One distinct schedule with its regime-normalized label."""

    key: tuple                 # canonical_key of the normalized sequence
    seq: Sequence              # redundant-sync-normalized (featurize input)
    label: float               # log(pct50 / in-file naive anchor)
    pct50: float               # as recorded (absolute, regime-bound)
    anchor: float              # the file's naive anchor (absolute)
    source: str                # path of the database the row came from
    schedule: str = ""         # primary schedule_id digest (trace join key)
    # ALL as-recorded digests, one per duplicate recording merged into this
    # row: bijection-equivalent spellings (e.g. lanes 0/1 vs 1/0) hash to
    # different digests, and trace spans were tagged with whichever spelling
    # that run benchmarked — joins must try every one
    schedules: List[str] = field(default_factory=list)
    n_trace_measurements: int = 0  # bench.benchmark spans backing this row

    @property
    def ratio(self) -> float:
        """anchor / pct50 — the warm-start convention (>1 = beats naive)."""
        return math.exp(-self.label)


@dataclass
class Corpus:
    """Merged rows from any number of databases (see module docstring)."""

    rows: List[CorpusRow] = field(default_factory=list)
    n_files: int = 0
    n_skipped: int = 0         # unresolvable rows (strict=False skips)
    n_screen: int = 0          # screen-fidelity rows excluded from training
    n_merged: int = 0          # duplicate-schedule recordings merged away

    @classmethod
    def from_files(cls, paths: List[str], graph,
                   log: Optional[Callable[[str], None]] = None) -> "Corpus":
        """Ingest ``paths`` against ``graph``.  Files without a full-fidelity
        naive anchor contribute nothing (regime unknown — the recorded.py
        rule); unreadable files are reported and skipped."""
        tr = get_tracer()
        corpus = cls()
        by_key: Dict[tuple, List[CorpusRow]] = {}
        with tr.span("learn.ingest", n_files=len(paths)) as sp:
            for path in paths:
                try:
                    anchor = naive_anchor_of(path)
                    db = CsvBenchmarker.from_file(path, graph, strict=False,
                                                  normalize=True)
                except Exception as e:
                    if log:
                        log(f"learn corpus: {path} unreadable ({e})")
                    continue
                corpus.n_files += 1
                corpus.n_skipped += len(db.skipped)
                if anchor is None or anchor <= 0.0:
                    if log:
                        log(f"learn corpus: {path} has no naive anchor — "
                            "skipped (regime unknown)")
                    continue
                for (seq, res), fid in zip(db.entries, db.fidelities):
                    if fid != "full":
                        corpus.n_screen += 1
                        continue
                    if res.pct50 <= 0.0:
                        corpus.n_skipped += 1
                        continue
                    norm = remove_redundant_syncs(seq)
                    row = CorpusRow(
                        # the NORMALIZED sequence is the row: search-time
                        # queries featurize post-normalization (MCTS cleans
                        # every rollout; SurrogateBenchmarker.predict
                        # normalizes), so training on raw DFS dumps would
                        # skew the sync-count feature distribution between
                        # train and serve.  The trace-join digest stays on
                        # the sequence AS RECORDED — that is the form the
                        # bench.benchmark spans were tagged with.
                        key=canonical_key(norm),
                        seq=norm,
                        label=math.log(res.pct50 / anchor),
                        pct50=res.pct50,
                        anchor=anchor,
                        source=path,
                        schedule=schedule_id(seq),
                    )
                    row.schedules = [row.schedule]
                    by_key.setdefault(row.key, []).append(row)
            for key, dups in by_key.items():
                first = dups[0]
                if len(dups) > 1:
                    # geometric-mean ratio: one program recorded in several
                    # regimes averages in log space, where the per-file
                    # normalization made the labels commensurable
                    first.label = sum(r.label for r in dups) / len(dups)
                    # keep every duplicate's as-recorded digest: trace spans
                    # were tagged with the spelling each run benchmarked
                    seen_digests = set(first.schedules)
                    for r in dups[1:]:
                        if r.schedule not in seen_digests:
                            seen_digests.add(r.schedule)
                            first.schedules.append(r.schedule)
                    corpus.n_merged += len(dups) - 1
                corpus.rows.append(first)
            sp.set("n_rows", len(corpus.rows))
            sp.set("n_merged", corpus.n_merged)
        get_metrics().counter("learn.corpus.rows").inc(len(corpus.rows))
        if log:
            log(f"learn corpus: {corpus.n_files} files -> "
                f"{len(corpus.rows)} distinct rows "
                f"({corpus.n_merged} merged, {corpus.n_screen} screen-"
                f"fidelity excluded, {corpus.n_skipped} skipped)")
        return corpus

    def attach_traces(self, trace_paths: List[str],
                      log: Optional[Callable[[str], None]] = None) -> int:
        """Join telemetry bundles (``--trace-out`` JSONL) onto the corpus by
        schedule digest: each row's ``n_trace_measurements`` counts the
        ``bench.benchmark`` spans recorded for that schedule.  Returns the
        number of spans matched to a row."""
        from tenzing_tpu_torch.obs.export import read_jsonl

        counts: Dict[str, int] = {}
        for path in trace_paths:
            try:
                records = read_jsonl(path)
            except Exception as e:
                if log:
                    log(f"learn corpus: trace {path} unreadable ({e})")
                continue
            for rec in records:
                if rec.get("kind") == "span" and (
                        rec.get("name") == "bench.benchmark"):
                    sid = (rec.get("attrs") or {}).get("schedule")
                    if sid:
                        counts[sid] = counts.get(sid, 0) + 1
        matched = 0
        for row in self.rows:
            n = sum(counts.get(sid, 0)
                    for sid in (row.schedules or [row.schedule]))
            row.n_trace_measurements += n
            matched += n
        if log and trace_paths:
            log(f"learn corpus: {matched} bench.benchmark spans joined from "
                f"{len(trace_paths)} trace files")
        return matched

    def matrices(self, nbytes: Optional[Dict[str, int]] = None,
                 env=None, cost_fn=None) -> Tuple["np.ndarray", "np.ndarray"]:
        """(X, y) training matrices: featurized rows and their log-ratio
        labels, row-aligned with ``self.rows``.  ``nbytes``/``env``/
        ``cost_fn`` must match what the search-time surrogate will
        featurize with (the feature-contract rule, learn/features.py)."""
        import numpy as np

        from tenzing_tpu_torch.learn.features import featurize

        X = np.asarray(
            [featurize(r.seq, nbytes=nbytes, env=env, cost_fn=cost_fn)
             for r in self.rows],
            dtype=float,
        )
        y = np.asarray([r.label for r in self.rows], dtype=float)
        return X, y
