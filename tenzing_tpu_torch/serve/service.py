"""The in-process schedule service: warm, query, merge, stats.

Counterpart of ``tenzing_tpu/serve/service.py``; the object a host embeds
and ``python -m tenzing_tpu_torch.serve`` wraps (serve/__main__.py):

* ``warm`` — mine recorded search databases (the driver's ``--dump-csv``)
  into the store under the request's fingerprint for this service's
  platform: per-file paired ratios against the row-0 naive anchor (the
  admission rule of bench/recorded.py ``scored_rows``), the top-k distinct
  winners by ``canonical_key``, each verified at admission, sha256 source
  digests in provenance.  Optionally trains the surrogate (the near tier's
  pricing model) and stamps driver-verdict provenance.
* ``query`` — tiered resolution (serve/resolver.py).
* ``merge`` — combine stores (commutative, idempotent; serve/store.py).
* ``stats`` — store and queue occupancy.

The service never opens a device: warm deserializes and featurizes against
the driver's device-free graphs (bench/driver.py ``graph_for``), and
resolution is store and model arithmetic.  Measurement happens only when
the drain daemon (serve/daemon.py) runs a cold item.  An exact answer
promises that its record was stored for the fingerprint's platform: a
drain stores what it measured on its own device, and ``warm`` stores a
database under the platform its caller names (``serve warm`` requires
``--platform``), since a CSV does not say where it was measured.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Dict, List, Optional

from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for, metric_for
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.serve.fingerprint import fingerprint_of, schedule_key
from tenzing_tpu_torch.serve.resolver import Resolution, Resolver
from tenzing_tpu_torch.serve.store import ScheduleStore, WorkQueue, open_store


def default_model_path(store_path: str) -> str:
    """Where ``warm --train`` saves the surrogate next to its store —
    one convention shared by the CLI and the service so a warmed store
    directory is self-contained.  Works for both backends: a trailing
    separator on a segmented store *directory* is stripped so the model
    lands beside the store, never hidden inside it."""
    return store_path.rstrip(os.sep).rstrip("/") + ".model.json"


class ScheduleService:
    """See module docstring.  ``platform`` (``"cuda"`` or ``"cpu"``) is
    the device the store's records are for: it enters every fingerprint
    this service warms and resolves.  ``model_path`` defaults next to the
    store; an existing model loads eagerly (the near tier needs it), a
    missing one leaves the near tier off until ``warm(train=True)`` makes
    it.

    Point ``model_path`` only at a surrogate trained with the same
    device-free ``nbytes`` map resolution featurizes with, i.e. one that
    ``warm(train=True)`` produced: a model from the driver's
    ``--learn-train`` was trained on the placed buffers' sizes, and where
    :func:`~tenzing_tpu_torch.bench.driver.graph_for` returns an empty map
    (full-size halo) its byte features would shift at predict time."""

    def __init__(self, store_path: str, queue_dir: Optional[str] = None,
                 model_path: Optional[str] = None, tenant: str = "local",
                 verify: bool = True, near_max_sigma: float = 0.75,
                 log: Optional[Callable[[str], None]] = None,
                 platform: str = "cuda"):
        self._log = log
        self.platform = platform
        # .json paths open the monolithic store; anything else opens the
        # segmented store (serve/store.py open_store)
        self.store = open_store(store_path, tenant=tenant, log=log)
        self.queue = WorkQueue(queue_dir) if queue_dir else None
        self.verify = verify
        self.model_path = model_path or default_model_path(store_path)
        self.model = self._load_model()
        self.resolver = Resolver(self.store, queue=self.queue,
                                 model=self.model, verify=verify,
                                 near_max_sigma=near_max_sigma, log=log,
                                 platform=platform)

    def _note(self, msg: str) -> None:
        if self._log is not None:
            self._log(msg)

    def _load_model(self):
        if not os.path.exists(self.model_path):
            return None
        from tenzing_tpu_torch.learn import FEATURE_NAMES, RidgeEnsemble

        return RidgeEnsemble.load(self.model_path,
                                  expect_features=list(FEATURE_NAMES))

    # -- warm ----------------------------------------------------------------
    def warm(self, req: DriverRequest, csv_globs: List[str],
             bench_globs: Optional[List[str]] = None, topk: int = 3,
             train: bool = True,
             provenance: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Mine recorded databases for ``req``'s workload into the store,
        under the fingerprint of this service's platform (see module
        docstring); ``provenance`` keys join every admitted record's (the
        daemon's ``device``).  A CSV names no device, so the platform is
        the caller's word for it; a driver JSON among ``bench_globs`` that
        names another platform's device raises before anything is stored,
        and one card named by them all becomes the records' ``device``.
        Returns a summary dict."""
        from tenzing_tpu_torch.bench.recorded import scored_rows

        tr = get_tracer()
        paths = sorted(p for pat in csv_globs for p in _glob.glob(pat))
        fp = fingerprint_of(req, platform=self.platform)
        # checked before anything is stored; a verdict's card names the
        # records' device unless the caller's provenance does
        docs = self._driver_jsons(req, bench_globs) if bench_globs else []
        names = {d["device"]["name"] for d in docs
                 if isinstance(d.get("device"), dict)
                 and d["device"].get("name")}
        if len(names) == 1 and "device" not in (provenance or {}):
            provenance = {**(provenance or {}), "device": names.pop()}
        graph, nbytes = graph_for(req)
        with tr.span("serve.warm", workload=req.workload,
                     n_files=len(paths)):
            # THE shared admission/ranking rule (bench/recorded.py):
            # the serving corpus and the search's warm-start loader can
            # never drift on which recorded rows count
            scored, stats = scored_rows(paths, graph, log=self._note)
            seen: set = set()
            added = rejected = 0
            verifier = None
            for ratio, pct50, seq, path in scored:
                if added >= topk:
                    break
                key = schedule_key(seq)
                if key in seen:
                    continue
                seen.add(key)
                # ADMISSION-TIME verification (docs/serving.md): verify
                # once, here, under this fingerprint's graph — the exact
                # tier then serves the stamped record with zero per-query
                # verifier invocations.  An unsound row is stored flagged
                # (visible in stats/report, never served, never counted
                # against topk) — the never-serve-unsound guarantee
                # moves to the door instead of being re-proved per query.
                verified = None
                if self.verify:
                    if verifier is None:
                        from tenzing_tpu_torch.verify import ScheduleVerifier

                        verifier = ScheduleVerifier(graph)
                    verified = bool(verifier(seq).ok)
                    if not verified:
                        get_metrics().counter(
                            "serve.admission.unsound").inc()
                        self._note(f"serve: admission rejected unsound "
                                   f"{key[:8]} from "
                                   f"{os.path.basename(path)} — stored "
                                   "flagged, never served")
                        self.store.add(fp, seq, pct50_us=pct50 * 1e6,
                                       vs_naive=ratio, source=path,
                                       extra_provenance=provenance,
                                       verified=False)
                        rejected += 1
                        continue
                    get_metrics().counter("serve.admission.verified").inc()
                self.store.add(fp, seq, pct50_us=pct50 * 1e6,
                               vs_naive=ratio, source=path,
                               extra_provenance=provenance,
                               verified=verified)
                added += 1
            summary: Dict[str, Any] = {
                "workload": req.workload, "exact": fp.exact_digest,
                "bucket": fp.bucket_digest, "files": stats["files"],
                "rows": stats["rows"], "candidates": len(scored),
                "added": added,
                "admission": {"verified": added if self.verify else None,
                              "rejected_unsound": rejected},
            }
            if bench_globs:
                summary["driver_provenance"] = self._stamp_driver_jsons(
                    fp, docs)
            if train:
                summary["model"] = self._train(req, paths, graph, nbytes)
            self.store.flush()
        get_metrics().counter("serve.warmed").inc(added)
        return summary

    def _driver_jsons(self, req: DriverRequest,
                      bench_globs: List[str]) -> List[Dict[str, Any]]:
        """The driver verdicts of ``req``'s metric among ``bench_globs``.
        Raises ``ValueError`` when one names a device of another platform
        (the port's verdicts carry ``device.type``): its run's records
        would be served as this platform's."""
        from tenzing_tpu_torch.obs.report import load_driver_json

        metric = metric_for(req.workload, req)
        out = []
        for pat in bench_globs:
            for path in sorted(_glob.glob(pat)):
                try:
                    d = load_driver_json(path)
                except (OSError, ValueError):
                    continue
                if d.get("metric") != metric:
                    continue
                dev = d.get("device")
                if isinstance(dev, dict) and dev.get("type") not in (
                        None, self.platform):
                    raise ValueError(
                        f"{path}: a run on {dev.get('type')} "
                        f"({dev.get('name')}) cannot warm {self.platform} "
                        "records")
                out.append(d)
        return out

    def _stamp_driver_jsons(self, fp, docs: List[Dict[str, Any]]
                            ) -> Dict[str, Any]:
        """Attach driver-JSON verdict provenance (vs_baseline, the
        result-integrity gate's ``verified`` stamp) to the warmed
        fingerprint — the store records not just what the corpus says
        but what the last full driver runs concluded."""
        best_vs = None
        verified = None
        for d in docs:
            vs = d.get("vs_baseline")
            if vs is not None and (best_vs is None or vs > best_vs):
                best_vs = vs
                verified = (d.get("fault") or {}).get("verified")
        out = {"matched": len(docs), "best_vs_baseline": best_vs,
               "verified": verified}
        rec = self.store.best(fp.exact_digest)
        if rec is not None and docs:
            rec.setdefault("provenance", {})["driver"] = out
        return out

    def _train(self, req: DriverRequest, paths: List[str], graph,
               nbytes) -> Dict[str, Any]:
        """Train the near tier's surrogate on the warmed corpus through
        THE shared recipe (learn/train.py — the same call behind
        the driver's ``--learn-train``), with this workload's device-free
        ``nbytes`` map so train-time and resolve-time features agree by
        construction."""
        from tenzing_tpu_torch.learn import train_from_corpus

        model, info = train_from_corpus(paths, graph, nbytes=nbytes,
                                        log=self._note)
        if model is None:
            return info
        # warm trains before the store's first flush creates the
        # directory — the model save must not trip over it either
        os.makedirs(os.path.dirname(os.path.abspath(self.model_path)),
                    exist_ok=True)
        model.save(self.model_path)
        self.model = model
        self.resolver.model = model
        return {"path": self.model_path, "rows": info["rows"],
                "train_spearman": info["train_spearman"]}

    # -- query / merge / stats ----------------------------------------------
    def query(self, req: DriverRequest,
              fp_key: Optional[tuple] = None) -> Resolution:
        """Tiered resolution.  ``fp_key`` (the verbatim request-kwargs
        tuple, :func:`~tenzing_tpu_torch.serve.resolver.fp_cache_key`) seeds
        the fingerprint cache and the lock-free fast path for callers
        that have the raw kwargs (the listen loop)."""
        return self.resolver.resolve(req, fp_key=fp_key)

    def merge(self, other_path: str) -> Dict[str, Any]:
        other = ScheduleStore(other_path, log=self._note)
        n = self.store.merge_from(other)
        self.store.flush()
        return {"merged_records": n, "from": other_path,
                "records": len(self.store)}

    def stats(self) -> Dict[str, Any]:
        out = {"store": self.store.stats(),
               "model": (self.model_path
                         if os.path.exists(self.model_path) else None)}
        if self.queue is not None:
            # full queue stats (serve/store.py WorkQueue.stats): depth by
            # reason plus the drain-daemon protocol state — the torn set
            # (visible rot, never silently dropped), live leases with
            # heartbeat ages, and the poison quarantine
            out["queue"] = self.queue.stats()
        return out
