"""Checkpoint and resume of long searches.

Counterpart of ``tenzing_tpu/fault/checkpoint.py``, with the reference's
directory layout and file formats (``--checkpoint DIR``):

* ``measurements.jsonl`` — the measurement journal: one JSON line per
  completed measurement (the schedule JSON, the ``BenchOpts`` key, the
  ``BenchResult``, a provenance tag), appended, flushed and fsynced as each
  measurement lands; a torn tail line (killed mid-write) is skipped on
  load.  Paired batches (``benchmark_batch_times``) journal into the same
  file as ``{"batch": ...}`` lines keyed by the members' schedule ids, the
  seed and the ``BenchOpts`` key.
* ``state.json`` — solver cursors and run configuration, written
  atomically as a versioned, sha256-checked envelope
  (:func:`atomic_write_json`); a corrupt or mismatched file raises
  :class:`CheckpointError`.
* ``quarantine.json`` — fault/quarantine.py's broken-schedule set.

On the card this is the only way a search keeps what it measured past a
*sticky* CUDA error: such an error leaves the process's context unusable,
so recovery is a new process, and ``--resume`` in that process restores the
journal into the run's ``CachingBenchmarker`` and re-runs the search from
the top.  The searches are deterministic given their seeds and their
measurements, so every schedule measured before is a cache hit (no device
time, the same ``BenchResult`` bit for bit: floats round-trip through JSON)
and the search reaches the point of the failure exactly.

Rows answered by a fallback (``degraded``) or a model are journaled with
that provenance and never restored: only ``measured`` rows are.

The drain daemon (serve/daemon.py) fences the journal with its lease's
epoch, as the reference does: ``$TENZING_FENCE`` holds
``<lease-path>:<epoch>``, and every journal append and state write first
checks the lease's epoch registry (serve/lease.py ``check_epoch``), so a
holder whose claim a rival superseded raises ``FencedWriteError`` instead
of interleaving stale rows into the successor's journal.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from tenzing_tpu_torch.bench.benchmarker import BenchOpts, BenchResult, schedule_id
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.utils.atomic import atomic_dump_json

CHECKPOINT_VERSION = 1

FENCE_ENV = "TENZING_FENCE"

# journal provenance tags: only MEASURED rows restore into the cache
PROVENANCE_MEASURED = "measured"
PROVENANCE_DEGRADED = "degraded"
PROVENANCE_MODEL = "model"


class CheckpointError(RuntimeError):
    """A checkpoint file exists but cannot be trusted (digest, version)."""


def _fence_from_env():
    """The fence check ``$TENZING_FENCE`` declares (``<lease-path>:<epoch>``),
    or None when it declares none.  Read when a checkpoint is opened: the
    daemon sets the variable around each drained item."""
    spec = os.environ.get(FENCE_ENV)
    if not spec or ":" not in spec:
        return None
    path, _, epoch_s = spec.rpartition(":")
    try:
        epoch = int(epoch_s)
    except ValueError:
        return None

    def check() -> None:
        from tenzing_tpu_torch.serve.lease import check_epoch

        check_epoch(path, epoch)

    return check


def _digest(payload_text: str) -> str:
    return hashlib.sha256(payload_text.encode()).hexdigest()


def atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` as a versioned, digest-checked envelope."""
    text = json.dumps(payload, sort_keys=True)
    atomic_dump_json(path, {"version": CHECKPOINT_VERSION,
                            "digest": _digest(text), "payload": payload},
                     prefix=".ckpt.")


def read_checked_json(path: str) -> Dict[str, Any]:
    """Read an :func:`atomic_write_json` envelope, checking its version and
    digest; raises :class:`CheckpointError` on any mismatch."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"unreadable checkpoint {path}: {e}") from e
    if doc.get("version") != CHECKPOINT_VERSION:
        raise CheckpointError(
            f"checkpoint {path}: version {doc.get('version')!r} != "
            f"{CHECKPOINT_VERSION}")
    payload = doc.get("payload")
    if _digest(json.dumps(payload, sort_keys=True)) != doc.get("digest"):
        raise CheckpointError(f"checkpoint {path}: digest mismatch "
                              "(truncated or corrupted)")
    return payload


def _opts_key(opts: Optional[BenchOpts]) -> Optional[List[float]]:
    if opts is None:
        return None
    return [opts.n_iters, opts.max_retries, opts.target_secs]


def _opts_from_key(key) -> Optional[BenchOpts]:
    if key is None:
        return None
    return BenchOpts(n_iters=int(key[0]), max_retries=int(key[1]),
                     target_secs=float(key[2]))


def _result_from_json(j: Dict[str, Any]) -> BenchResult:
    return BenchResult(
        pct01=j["pct01"], pct10=j["pct10"], pct50=j["pct50"],
        pct90=j["pct90"], pct99=j["pct99"], stddev=j["stddev"],
        times=j.get("times"), fetch_overhead=j.get("fetch_overhead"),
    )


def _batch_key(ids, seed: int, opts_key, groups=None) -> Tuple:
    key = (tuple(ids), int(seed),
           tuple(opts_key) if opts_key is not None else None)
    if groups is not None:
        key = key + (tuple((int(n), int(s)) for n, s in groups),)
    return key


class SearchCheckpoint:
    """One checkpoint directory (module docstring).  ``fence`` is an
    optional zero-argument callable that raises when this writer may no
    longer write; it is checked before every journal line and snapshot."""

    def __init__(self, directory: str, fence=None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._journal_f = None
        self._state: Dict[str, Any] = {}
        self._fence = fence if fence is not None else _fence_from_env()

    def _check_fence(self) -> None:
        if self._fence is not None:
            self._fence()

    @property
    def state_path(self) -> str:
        return os.path.join(self.dir, "state.json")

    @property
    def journal_path(self) -> str:
        return os.path.join(self.dir, "measurements.jsonl")

    @property
    def quarantine_path(self) -> str:
        return os.path.join(self.dir, "quarantine.json")

    # -- the measurement journal --------------------------------------------
    def _append(self, line: str) -> None:
        self._check_fence()
        if self._journal_f is None:
            self._journal_f = open(self.journal_path, "a")
        self._journal_f.write(line + "\n")
        self._journal_f.flush()
        os.fsync(self._journal_f.fileno())

    def record(self, order, opts: Optional[BenchOpts], res: BenchResult,
               provenance: str = PROVENANCE_MEASURED) -> None:
        """Append one measurement, fsynced before this returns."""
        from tenzing_tpu_torch.core.serdes import sequence_to_json

        self._append(json.dumps({
            "opts": _opts_key(opts),
            "prov": provenance,
            "result": res.to_json(),
            "ops": sequence_to_json(order),
        }, sort_keys=True))
        get_metrics().counter("fault.checkpoint.journaled").inc()

    def record_batch(self, ids: List[str], opts: Optional[BenchOpts],
                     seed: int, times: List[List[float]],
                     groups=None) -> None:
        """Append one ``benchmark_batch_times`` result, keyed by the members'
        schedule ids, the seed and the ``BenchOpts`` key (and ``groups``,
        the per-group seeds of a fused round, where given)."""
        b = {"ids": list(ids), "seed": seed,
             "opts": _opts_key(opts), "times": times}
        if groups is not None:
            b["groups"] = [[int(n), int(s)] for n, s in groups]
        self._append(json.dumps({"batch": b}, sort_keys=True))
        get_metrics().counter("fault.checkpoint.journaled_batches").inc()

    def _lines(self):
        if not os.path.exists(self.journal_path):
            return
        with open(self.journal_path) as f:
            for i, line in enumerate(f):
                if line.strip():
                    yield i, line

    def load_measurements(self, graph, log=None) -> List[
            Tuple[Any, Optional[BenchOpts], BenchResult, str]]:
        """(sequence, opts, result, provenance) of each complete journal
        line, its ops resolved against ``graph``.  A torn line or one whose
        ops do not resolve is skipped with a note."""
        from tenzing_tpu_torch.core.serdes import sequence_from_json

        out = []
        for i, line in self._lines():
            try:
                j = json.loads(line)
                if "batch" in j:
                    continue  # batch lines load through load_batches()
                out.append((sequence_from_json(j["ops"], graph),
                            _opts_from_key(j["opts"]),
                            _result_from_json(j["result"]),
                            j.get("prov", PROVENANCE_MEASURED)))
            except Exception as e:
                if log is not None:
                    log(f"checkpoint: journal line {i} skipped "
                        f"({type(e).__name__}: {str(e)[:120]})")
        return out

    def load_batches(self, log=None) -> Dict[Tuple, List[List[float]]]:
        """The journaled batch results keyed by (ids, seed, opts key[,
        groups]); later lines win."""
        out: Dict[Tuple, List[List[float]]] = {}
        for i, line in self._lines():
            try:
                b = json.loads(line).get("batch")
                if b is None:
                    continue
                out[_batch_key(b["ids"], b["seed"], b["opts"],
                               b.get("groups"))] = [list(ts)
                                                    for ts in b["times"]]
            except Exception as e:
                if log is not None:
                    log(f"checkpoint: batch journal line {i} skipped "
                        f"({type(e).__name__}: {str(e)[:120]})")
        return out

    def restore_into(self, caching, graph, log=None) -> int:
        """Fill a ``CachingBenchmarker`` from the journal's ``measured``
        rows (later lines win), and the batch cache of the first
        :class:`JournalingBenchmarker` on its ``inner`` chain from the batch
        lines.  Returns the number of cache entries installed."""
        n = 0
        for seq, opts, res, prov in self.load_measurements(graph, log=log):
            if prov != PROVENANCE_MEASURED:
                continue
            caching._cache[caching._key(seq, opts)] = res
            n += 1
        get_metrics().counter("fault.checkpoint.restored").inc(n)
        layer = caching
        while layer is not None:
            if isinstance(layer, JournalingBenchmarker):
                batches = self.load_batches(log=log)
                layer._batch_cache.update(batches)
                get_metrics().counter(
                    "fault.checkpoint.restored_batches").inc(len(batches))
                break
            layer = getattr(layer, "inner", None)
        return n

    # -- the solver-state snapshot -------------------------------------------
    def save_state(self, state: Optional[Dict[str, Any]] = None,
                   **merge: Any) -> None:
        """Snapshot solver cursors and configuration atomically: ``state``
        replaces the document, keyword arguments merge into it (each solver
        updates only its own key).  A transient I/O error retries."""
        from tenzing_tpu_torch.fault.backoff import BackoffPolicy, retry_call

        if state is not None:
            self._state = dict(state)
        self._state.update(merge)
        self._check_fence()
        retry_call(
            lambda: atomic_write_json(self.state_path, self._state),
            policy=BackoffPolicy(retries=4, base_secs=0.05, factor=2.0,
                                 max_secs=0.5),
            retry_on=lambda e: isinstance(e, OSError),
            where="fault.checkpoint.state")

    def load_state(self) -> Optional[Dict[str, Any]]:
        """The last snapshot, digest-checked; None when absent."""
        if not os.path.exists(self.state_path):
            return None
        self._state = read_checked_json(self.state_path)
        return dict(self._state)

    def close(self) -> None:
        if self._journal_f is not None:
            self._journal_f.close()
            self._journal_f = None


class JournalingBenchmarker:
    """Journals every completed measurement of the wrapped benchmarker into
    a :class:`SearchCheckpoint`.  It sits inside the run's
    ``CachingBenchmarker`` (a cache hit was journaled when it was measured)
    and outside the resilient layer (only completed measurements land; a
    fallback's answer lands as ``degraded``).

    ``benchmark_batch_times`` is journaled too, and answered from
    :attr:`_batch_cache` (filled by ``restore_into``) on resume;
    :attr:`batch_hits` counts those answers, so a budgeted caller
    (solve/local.py) treats them as free."""

    def __init__(self, inner, checkpoint: SearchCheckpoint):
        self.inner = inner
        self.checkpoint = checkpoint
        self.rank_coherent = getattr(inner, "rank_coherent", False)
        self._batch_cache: Dict[Tuple, List[List[float]]] = {}
        self.batch_hits = 0
        if hasattr(inner, "benchmark_batch_times"):
            self.benchmark_batch_times = self._batch_times

    def was_degraded(self, order) -> bool:
        fn = getattr(self.inner, "was_degraded", None)
        return bool(fn(order)) if fn is not None else False

    def benchmark(self, order, opts: Optional[BenchOpts] = None) -> BenchResult:
        res = self.inner.benchmark(order, opts)
        prov = (PROVENANCE_DEGRADED if self.was_degraded(order)
                else PROVENANCE_MEASURED)
        self.checkpoint.record(order, opts, res, provenance=prov)
        return res

    def _batch_times(self, orders, opts: Optional[BenchOpts] = None,
                     seed: int = 0, times_out=None, group_seeds=None):
        ids = [schedule_id(o) for o in orders]
        key = _batch_key(ids, seed, _opts_key(opts), group_seeds)
        cached = self._batch_cache.get(key)
        if cached is not None:
            self.batch_hits += 1
            get_metrics().counter("fault.checkpoint.batch_hits").inc()
            times = [list(ts) for ts in cached]
        else:
            kw = {} if group_seeds is None else {"group_seeds": group_seeds}
            times = [list(ts) for ts in self.inner.benchmark_batch_times(
                orders, opts, seed=seed, **kw)]
            self._batch_cache[key] = times
            self.checkpoint.record_batch(ids, opts, seed, times,
                                         groups=group_seeds)
        return _fill(times_out, times)


def _fill(times_out, times):
    """``times`` copied into the caller's ``times_out`` lists (returned), or
    ``times`` itself when the caller gave none."""
    if times_out is None:
        return times
    for dst, src in zip(times_out, times):
        dst.clear()
        dst.extend(src)
    return times_out
