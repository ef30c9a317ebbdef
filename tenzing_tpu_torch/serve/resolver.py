"""Tiered request resolution: exact hit, near miss, cold.

Counterpart of ``tenzing_tpu/serve/resolver.py``, strictly cheapest first:

* **exact** — the store holds a schedule under the request's exact
  fingerprint digest: deserialize it against the request's graph and, unless
  it was verified at admission, re-verify it through the independent
  :class:`~tenzing_tpu_torch.verify.ScheduleVerifier`.  Zero compiles, zero
  measurements: resolution never builds an executor, and the provenance
  says so.  An entry that fails verification is flagged, not served.
* **near** — no exact entry, but the bucket (same bucketed shape, mesh,
  engines and platform) has neighbours: answer with the best neighbour's
  schedule, priced by the learned surrogate under an **uncertainty gate**
  (an ensemble spread above ``near_max_sigma`` falls through to cold).
  Served predictions carry ``was_predicted: true``; the request is queued
  for refinement and the answering entry flagged ``needs_refinement``.
* **cold** — enqueue a checkpointed
  :class:`~tenzing_tpu_torch.bench.driver.DriverRequest` work item
  (serve/store.py ``WorkQueue``) for the drain daemon, and say so.

The fingerprint carries the resolver's ``platform``, so a record measured on
another device (a store warmed by the reference on a TPU, or by a CPU run)
never answers exact or near on the card.

Every resolution lands a ``serve.query`` span, a ``serve.<tier>`` counter,
``serve.resolve_us`` and ``serve.resolve_us.<tier>`` observations, and a
per-phase breakdown (``Resolution.phase_us``: fingerprint, cache probe,
store walk).

**The fast path**: a sealed response is memoized when a record enters the
exact cache (a hit is a dict copy and two slot patches, byte-identical to a
fresh serialization); fingerprints are cached by the verbatim request
kwargs (:func:`fp_cache_key`); and :meth:`Resolver.resolve_fast` answers
exact hits from an immutable snapshot of the exact cache without a lock.
A snapshot whose generation lags the store falls through to the locked
path, so a merge or a flag never serves a stale answer.

Resolution runs under a trace context (obs/context.py): the caller's, or one
minted here; it rides the cold tier's work item, so the drain a cold query
causes links back to the query.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from tenzing_tpu_torch.fault.errors import StoreReadonlyError, is_unwritable_io
from tenzing_tpu_torch.obs import context as obs_context
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.serve.fingerprint import WorkloadFingerprint, fingerprint_of
from tenzing_tpu_torch.serve.store import (
    Record,
    ScheduleStore,
    WorkQueue,
    mark_store_unwritable,
    store_readonly,
)

# sealed-response slot sentinels: a memoized response carries these at
# the per-request fields' natural positions, so patching them in place
# preserves key order and the patched document is byte-identical to a
# fresh serialization of the same resolution (the correctness contract
# tests/test_serve_fastpath.py pins literally)
_PHASE_SLOT: Dict[str, float] = {"_slot": 0.0}
_TRACE_SLOT = "_slot"


# an fp-cache key retains the VERBATIM client kwargs for the cache's
# lifetime: entry-count bounds alone would let 4096 multi-megabyte
# string values (valid DriverRequest path fields) pin gigabytes in a
# long-lived serve loop, so oversized keys are simply uncacheable
_FP_KEY_MAX_CHARS = 2048


def fp_cache_key(kwargs: Any) -> Optional[Tuple]:
    """The fingerprint-cache key: the **verbatim request kwargs** as a
    sorted hashable tuple — no canonicalization, no shape resolution
    (that is exactly the work the cache exists to skip).  ``None`` when
    the kwargs are not a dict, carry an unhashable value, or are
    oversized (module comment above) — such a request simply resolves
    through the uncached path."""
    if not isinstance(kwargs, dict):
        return None
    try:
        key = tuple(sorted(kwargs.items()))
        hash(key)
    except TypeError:
        return None
    size = 0
    for k, v in key:
        size += len(k) + (len(v) if isinstance(v, str) else 8)
        if size > _FP_KEY_MAX_CHARS:
            return None
    return key


@dataclass
class Resolution:
    """One resolved request.  ``provenance`` always carries
    ``compiles: 0`` / ``measurements: 0`` — the serving tiers never
    touch an executor; a number in here is either a stored measurement
    (exact) or an explicitly-marked prediction (near)."""

    tier: str  # "exact" | "near" | "cold"
    fingerprint: WorkloadFingerprint
    record: Optional[Record] = None
    sequence: Optional[Any] = None  # Sequence, resolved against the request
    pct50_us: Optional[float] = None
    vs_naive: Optional[float] = None
    provenance: Dict[str, Any] = field(default_factory=dict)
    work_item: Optional[str] = None  # cold: the queued item's path
    # per-phase latency breakdown (µs): fingerprint / cache_probe /
    # store_walk (+ serialize, added by the transport) — the exact-tier
    # profile of one resolution
    phase_us: Dict[str, float] = field(default_factory=dict)
    trace_id: Optional[str] = None
    # the sealed response body (docs/serving.md "Fast path"): the
    # to_json document precomputed when the record entered the exact
    # cache, with slot sentinels where the per-request fields go —
    # serving is then a dict copy + slot patches instead of fingerprint
    # re-serialization and digest hashing
    memo: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        if self.memo is not None:
            # copy-and-patch: assigning to a present key keeps its
            # position, so the patched document's key order (and hence
            # its json.dumps bytes) matches a fresh serialization
            out = dict(self.memo)
            if self.phase_us:
                out["phase_us"] = self.phase_us
            else:
                out.pop("phase_us", None)
            if self.trace_id is not None:
                out["trace_id"] = self.trace_id
            else:
                out.pop("trace_id", None)
            return out
        out = {
            "tier": self.tier,
            "fingerprint": self.fingerprint.to_json(),
            "provenance": self.provenance,
        }
        if self.phase_us:
            out["phase_us"] = self.phase_us
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.record is not None:
            out["key"] = self.record["key"]
            out["ops"] = self.record["ops"]
        if self.pct50_us is not None:
            out["pct50_us"] = self.pct50_us
        if self.vs_naive is not None:
            out["vs_naive"] = self.vs_naive
        if self.work_item is not None:
            out["work_item"] = self.work_item
        return out


class Resolver:
    """The tier policy over one :class:`ScheduleStore` (see module
    docstring), for records measured on ``platform`` (``"cuda"`` or
    ``"cpu"``: it enters every fingerprint, so a record of another
    platform answers neither exact nor near).

    ``model`` is a loaded :class:`~tenzing_tpu_torch.learn.RidgeEnsemble`
    (the surrogate): without one the near tier is off and bucket neighbours
    fall through to cold, since an unpriced neighbour is not an answer.
    ``graph_builder`` defaults to the driver's device-free
    :func:`~tenzing_tpu_torch.bench.driver.graph_for`; graphs and verifiers
    are cached per exact digest.  The resolver builds no executor and opens
    no CUDA context."""

    def __init__(self, store: ScheduleStore, queue: Optional[WorkQueue] = None,
                 model=None, near_max_sigma: float = 0.75,
                 verify: bool = True,
                 graph_builder: Optional[Callable] = None,
                 log: Optional[Callable[[str], None]] = None,
                 serve_cache: bool = True,
                 legacy_verify: bool = False,
                 platform: str = "cuda"):
        self.store = store
        self.platform = platform
        self.queue = queue
        self.model = model
        self.near_max_sigma = float(near_max_sigma)
        self.verify = verify
        # serve_cache=False disables the exact-tier sealed-record cache;
        # legacy_verify=True additionally ignores admission stamps and
        # re-verifies every exact hit — together they replay the uncached
        # resolution path exactly (a baseline to time the fast path against;
        # never the serving configuration)
        self.serve_cache = serve_cache
        self.legacy_verify = legacy_verify
        self._graph_builder = graph_builder
        # per-exact-digest caches, BOUNDED: the digests are derived from
        # client-controlled shape parameters, and a long-lived server
        # sweeping shapes (one graph + verifier + surrogate each) must
        # not grow without limit — insertion-order eviction is enough
        # because serving traffic concentrates on few fingerprints
        self.cache_cap = 32
        # the exact-tier answer cache is the serving hot path (one dict
        # probe per hit) and its entries are small (a record reference +
        # a materialized Sequence): it earns a much larger bound
        self.exact_cache_cap = 4096
        self._graphs: Dict[str, Tuple[Any, Dict[str, int]]] = {}
        self._verifiers: Dict[str, Any] = {}
        # exact digest -> (record, sequence, provenance, sealed response
        # memo) of the admitted best answer; validity keyed on the
        # store's generation counter (any record landing anywhere — and
        # every flag mutation — invalidates wholesale: coarse, but
        # merges are rare and wrong answers are forever)
        self._exact_cache: Dict[
            str, Tuple[Record, Any, Dict[str, Any], Dict[str, Any]]] = {}
        self._exact_cache_gen = -1
        # the lock-free read path's view: an immutable (generation,
        # dict) pair replaced wholesale on every cache mutation —
        # readers grab the attribute once (atomic under the GIL) and
        # probe a dict no writer will ever mutate in place
        self._exact_snapshot: Tuple[int, Dict[str, Any]] = (-1, {})
        # verbatim-kwargs tuple -> canonicalized fingerprint with both
        # digests precomputed (docs/serving.md "Fast path"); bounded
        # like the exact cache — the key space is client-controlled
        self.fp_cache_cap = 4096
        self._fp_cache: Dict[Any, WorkloadFingerprint] = {}
        # (model, surrogate) per exact digest: the surrogate's
        # canonical-key prediction cache must survive across queries of
        # a hot fingerprint (re-featurizing the same neighbors per
        # request is O(schedule length) on the serve.resolve_us path);
        # keyed with the model so a retrain invalidates
        self._surrogates: Dict[str, Tuple[Any, Any]] = {}
        self._log = log

    def _note(self, msg: str) -> None:
        if self._log is not None:
            self._log(msg)

    def _cache_put(self, cache: Dict[str, Any], key: str, value,
                   cap: Optional[int] = None,
                   on_evict: Optional[Callable[[Any], None]] = None) -> None:
        if key in cache:
            # re-put of a present key must update in place: evicting an
            # oldest entry for it would shrink the cache by one per
            # refresh (and could evict the very entry being refreshed)
            cache[key] = value
            return
        cap = self.cache_cap if cap is None else cap
        while len(cache) >= cap:
            evicted = cache.pop(next(iter(cache)))  # oldest insertion
            if on_evict is not None:
                on_evict(evicted)
        cache[key] = value

    # -- fast path (docs/serving.md "Fast path") -----------------------------
    def _publish_snapshot(self) -> None:
        """Replace the lock-free readers' view after any exact-cache
        mutation.  The copy is bounded by ``exact_cache_cap`` and only
        paid on the mutation path (miss/invalidation) — never per hit."""
        self._exact_snapshot = (self._exact_cache_gen,
                                dict(self._exact_cache))

    def _seal_response(self, fp: WorkloadFingerprint, rec: Record, seq,
                       prov: Dict[str, Any]) -> Dict[str, Any]:
        """The memoized response body for a cache hit of this record:
        the full ``to_json`` document — fingerprint serialization and
        digest hashing paid HERE, once — with slot sentinels at the
        per-request fields' positions (patched per request by
        :meth:`Resolution.to_json`)."""
        sealed = Resolution(
            tier="exact", fingerprint=fp, record=rec, sequence=seq,
            pct50_us=rec.get("pct50_us"), vs_naive=rec.get("vs_naive"),
            provenance=dict(prov, cache_hit=True))
        # per-seal copy: aliasing the module-level sentinel into every
        # memo would make one in-place mutation corrupt all of them
        sealed.phase_us = dict(_PHASE_SLOT)
        sealed.trace_id = _TRACE_SLOT
        return sealed.to_json()

    def _cache_exact(self, fp: WorkloadFingerprint, rec: Record, seq,
                     prov: Dict[str, Any]) -> None:
        """Admit one record into the exact cache: seal its response
        memo, evict (counting the dropped memo as an invalidation), and
        publish a fresh snapshot for the lock-free readers."""
        memo = self._seal_response(fp, rec, seq, prov)
        self._cache_put(
            self._exact_cache, fp.exact_digest, (rec, seq, prov, memo),
            cap=self.exact_cache_cap,
            on_evict=lambda _: get_metrics().counter(
                "serve.memo.invalidations").inc())
        self._publish_snapshot()

    def _drop_exact(self, exact: str) -> None:
        """Invalidate one cached answer (e.g. a record flagged unsound
        by a caller holding the same dict) — counted, and republished so
        the lock-free readers stop seeing it immediately."""
        if self._exact_cache.pop(exact, None) is not None:
            get_metrics().counter("serve.memo.invalidations").inc()
            self._publish_snapshot()

    def _invalidate_exact_cache(self, gen: int) -> None:
        """The store-generation bump: every record landing and every
        flag mutation moves the generation, and the whole answer cache
        (records, sequences, sealed memos) dies with it."""
        if self._exact_cache:
            get_metrics().counter("serve.memo.invalidations").inc(
                len(self._exact_cache))
            self._exact_cache.clear()
        self._exact_cache_gen = gen
        self._publish_snapshot()

    def _fingerprint(self, req, fp_key: Optional[Tuple]):
        """:func:`fingerprint_of` through the canonicalization cache:
        a request arriving with a verbatim-kwargs key
        (:func:`fp_cache_key`) probes the bounded cache first; a miss
        canonicalizes once, precomputes both digests, and caches — the
        recorded-traffic mix repeats shape buckets, so the steady state
        is one dict probe."""
        if fp_key is not None:
            fp = self._fp_cache.get(fp_key)
            if fp is not None:
                get_metrics().counter("serve.fp_cache.hits").inc()
                return fp
        fp = fingerprint_of(req, platform=self.platform)
        if fp_key is not None:
            _ = (fp.exact_digest, fp.bucket_digest)  # warm both digests
            self._cache_put(self._fp_cache, fp_key, fp,
                            cap=self.fp_cache_cap)
            get_metrics().counter("serve.fp_cache.misses").inc()
        return fp

    def resolve_fast(self, fp_key: Optional[Tuple]) -> Optional[Resolution]:
        """The lock-free exact tier: fingerprint-cache probe + snapshot
        probe + memoized response, **no lock, no store access beyond one
        generation read** — safe to call from any number of threads
        concurrently (serve/listen.py's workers do).  ``None`` means
        "not servable lock-free" (cold fingerprint cache, stale
        snapshot, non-exact tier): the caller falls through to
        :meth:`resolve` under its exclusive lock, which repopulates
        every cache this path reads."""
        if fp_key is None:
            return None
        t0 = time.perf_counter()
        fp = self._fp_cache.get(fp_key)
        if fp is None:
            return None
        reg = get_metrics()
        phases: Dict[str, float] = {}
        phases["fingerprint"] = round((time.perf_counter() - t0) * 1e6, 2)
        t_probe = time.perf_counter()
        gen_snap, snap = self._exact_snapshot
        if gen_snap != getattr(self.store, "generation", 0):
            return None  # the exclusive path refreshes the snapshot
        hit = snap.get(fp.exact_digest)
        if hit is None:
            return None
        rec, seq, prov, memo = hit
        if rec.get("flags", {}).get("unsound"):
            # flagged by a caller holding the same record dict (a
            # store.flag goes through the generation bump and never
            # reaches here): let the exclusive path drop + re-walk
            return None
        phases["cache_probe"] = round(
            (time.perf_counter() - t_probe) * 1e6, 2)
        ctx = obs_context.current() or obs_context.new_trace()
        reg.counter("serve.fp_cache.hits").inc()
        reg.counter("serve.exact_cache.hits").inc()
        reg.counter("serve.memo.hits").inc()
        reg.counter("serve.exact").inc()
        res = Resolution(
            tier="exact", fingerprint=fp, record=rec, sequence=seq,
            pct50_us=rec.get("pct50_us"), vs_naive=rec.get("vs_naive"),
            provenance=dict(prov, cache_hit=True), memo=memo)
        res.phase_us = phases
        res.trace_id = ctx.trace_id
        dt_us = (time.perf_counter() - t0) * 1e6
        reg.histogram("serve.resolve_us", window=True).observe(dt_us)
        reg.histogram("serve.resolve_us.exact", window=True).observe(dt_us)
        tr = get_tracer()
        if tr.enabled:
            # emitted AFTER the fact so a fall-through never produces a
            # duplicate serve.query span next to the exclusive path's:
            # the span's own duration is therefore ~0 — the real
            # latency rides the resolve_us attribute (and phase_us on
            # the response), which is what timing analyses must read
            # for fast-path traffic
            with obs_context.use(ctx), tr.span("serve.query") as sp:
                sp.set("workload", fp.workload)
                sp.set("exact", fp.exact_digest)
                sp.set("tier", "exact")
                sp.set("fast_path", True)
                sp.set("resolve_us", round(dt_us, 2))
        return res

    def _graph(self, req, fp: WorkloadFingerprint):
        got = self._graphs.get(fp.exact_digest)
        if got is None:
            builder = self._graph_builder
            if builder is None:
                from tenzing_tpu_torch.bench.driver import graph_for as builder
            got = builder(req)
            self._cache_put(self._graphs, fp.exact_digest, got)
        return got

    def _verifier(self, graph, fp: WorkloadFingerprint):
        v = self._verifiers.get(fp.exact_digest)
        if v is None:
            from tenzing_tpu_torch.verify import ScheduleVerifier

            v = ScheduleVerifier(graph)
            self._cache_put(self._verifiers, fp.exact_digest, v)
        return v

    def _materialize(self, rec: Record, graph) -> Optional[Any]:
        """The record's ops resolved against the *request's* graph; None
        when they no longer resolve (recorded against a different
        structural variant) — a store answer the request cannot execute
        is no answer."""
        from tenzing_tpu_torch.core.serdes import sequence_from_json

        try:
            return sequence_from_json(rec["ops"], graph)
        except Exception as e:
            self._note(f"serve: record {rec['key'][:8]} does not resolve "
                       f"({type(e).__name__}: {str(e)[:120]})")
            return None

    # -- tiers ---------------------------------------------------------------
    def _try_exact(self, req, fp: WorkloadFingerprint,
                   phases: Dict[str, float]) -> Optional[Resolution]:
        reg = get_metrics()
        t0 = time.perf_counter()
        with get_tracer().span("serve.cache_probe") as psp:
            if self.serve_cache:
                hit = self._exact_cache.get(fp.exact_digest)
                if hit is not None and \
                        hit[0].get("flags", {}).get("unsound"):
                    # belt-and-braces behind the generation check: a
                    # record flagged between the generation bump and this
                    # probe (or by a caller holding the same dict) must
                    # never be served
                    self._drop_exact(fp.exact_digest)
                    hit = None
                if hit is not None:
                    # the hot path: one dict probe, zero
                    # materializations, zero verifier invocations — the
                    # record was admitted (verified + sealed) when it
                    # entered the cache, and its response body was
                    # sealed with it (the memo the transport patches)
                    rec, seq, prov, memo = hit
                    phases["cache_probe"] = round(
                        (time.perf_counter() - t0) * 1e6, 2)
                    psp.set("hit", True)
                    reg.counter("serve.exact_cache.hits").inc()
                    reg.counter("serve.memo.hits").inc()
                    return Resolution(
                        tier="exact", fingerprint=fp, record=rec,
                        sequence=seq, pct50_us=rec.get("pct50_us"),
                        vs_naive=rec.get("vs_naive"),
                        provenance=dict(prov, cache_hit=True),
                        memo=memo)
            psp.set("hit", False)
        phases["cache_probe"] = round((time.perf_counter() - t0) * 1e6, 2)
        t_walk = time.perf_counter()
        records = self.store.exact_records(fp.exact_digest)
        # the walk phase covers everything past the probe (store listing,
        # materialization, verification fallback) — the cold/near paths
        # overwrite nothing, so an exact miss still reports what the
        # exact tier spent before falling through
        try:
            return self._walk_exact(req, fp, records, reg)
        finally:
            phases["store_walk"] = round(
                (time.perf_counter() - t_walk) * 1e6, 2)

    def _walk_exact(self, req, fp: WorkloadFingerprint,
                    records, reg) -> Optional[Resolution]:
        if not records:
            return None
        if self.serve_cache:
            reg.counter("serve.exact_cache.misses").inc()
        graph = None
        # best-first WALK, not best-only: one unsound or unresolvable
        # best record must not permanently block a sound runner-up under
        # the same exact digest (the near tier excludes the requester's
        # own digest, so falling through here would skip it entirely)
        for rec in records:
            if rec.get("flags", {}).get("unsound"):
                # flagged at admission (or by a prior discovery): never
                # served, and never worth re-verifying — the verdict is
                # deterministic
                continue
            if graph is None:
                graph, _ = self._graph(req, fp)
            seq = self._materialize(rec, graph)
            if seq is None:
                continue
            admission_stamped = (bool(rec.get("verified_at_admission"))
                                 and not self.legacy_verify)
            verified = None
            verifier_calls = 0
            if admission_stamped:
                # verified once when it was merged into the store, under
                # this same fingerprint's (deterministic) graph — serving
                # it again needs no second opinion (docs/serving.md
                # "Admission-time verification")
                verified = True
            elif self.verify:
                verifier_calls = 1
                reg.counter("serve.verify_fallback").inc()
                verdict = self._verifier(graph, fp)(seq)
                verified = bool(verdict.ok)
                if not verified:
                    # an unsound stored schedule must never be served —
                    # flag it (visible in stats + the report CLI) and
                    # try the next-best record
                    self.store.flag(rec["exact"], rec["key"],
                                    unsound=True, needs_refinement=True)
                    get_metrics().counter("serve.store.unsound").inc()
                    self._note(f"serve: exact entry {rec['key'][:8]} "
                               "failed re-verification — flagged, "
                               "not served")
                    continue
                # the lazy-verified record is now as good as stamped for
                # this process's lifetime (in-memory only: persistence of
                # the stamp belongs to admission, not resolution); the
                # legacy replay path must not stamp — it would leak
                # new-path state into the baseline it exists to measure
                if not self.legacy_verify:
                    rec["verified_at_admission"] = True
            prov = {
                "verified": verified,
                "verified_at_admission": admission_stamped,
                "verifier_calls": verifier_calls,
                "cache_hit": False,
                "was_predicted": False,
                "compiles": 0,
                "measurements": 0,
                "source_exact": rec["exact"],
                **rec.get("provenance", {}),
            }
            if self.serve_cache and verified is not False:
                # entering the cache seals the response memo: this
                # fresh serve paid full serialization (counted as the
                # memo miss), every cache hit after it is copy-and-patch
                reg.counter("serve.memo.misses").inc()
                self._cache_exact(fp, rec, seq, prov)
            return Resolution(tier="exact", fingerprint=fp, record=rec,
                              sequence=seq, pct50_us=rec.get("pct50_us"),
                              vs_naive=rec.get("vs_naive"),
                              provenance=prov)
        return None

    def _try_near(self, req, fp: WorkloadFingerprint) -> Optional[Resolution]:
        if self.model is None:
            return None
        neighbors = self.store.bucket_records(
            fp.bucket_digest, exclude_exact=fp.exact_digest)
        if not neighbors:
            return None
        graph, nbytes = self._graph(req, fp)
        ent = self._surrogates.get(fp.exact_digest)
        if ent is None or ent[0] is not self.model:
            from tenzing_tpu_torch.learn import SurrogateBenchmarker

            surrogate = SurrogateBenchmarker(self.model, nbytes=nbytes)
            self._cache_put(self._surrogates, fp.exact_digest,
                            (self.model, surrogate))
        else:
            surrogate = ent[1]
        for rec in neighbors:
            if rec.get("flags", {}).get("unsound"):
                continue  # same rule as the exact tier: known-bad, skip
            seq = self._materialize(rec, graph)
            if seq is None:
                continue
            mu, sigma = surrogate.predict(seq)
            if sigma > self.near_max_sigma:
                # uncertainty gate: the ensemble cannot price this
                # schedule for the requested shape — falling through to
                # cold is honest, serving a wide guess is not
                get_metrics().counter("serve.near_rejected").inc()
                self._note(f"serve: near candidate {rec['key'][:8]} "
                           f"rejected (sigma {sigma:.3f} > "
                           f"{self.near_max_sigma})")
                continue
            verified = None
            if self.verify:
                verified = bool(self._verifier(graph, fp)(seq).ok)
                if not verified:
                    # same treatment as the exact tier: counted, flagged
                    # for refinement, never served — a poisoned entry
                    # first discovered via a near miss must not be
                    # invisible to the serve.store.unsound dashboards
                    self.store.flag(rec["exact"], rec["key"],
                                    unsound=True, needs_refinement=True)
                    get_metrics().counter("serve.store.unsound").inc()
                    self._note(f"serve: near candidate {rec['key'][:8]} "
                               "failed re-verification — flagged, "
                               "not served")
                    continue
            # the label space is log(t / naive anchor): exp(-mu) is the
            # predicted paired ratio vs naive for the requested shape
            pred_vs = math.exp(-mu)
            self.store.flag(rec["exact"], rec["key"], needs_refinement=True)
            if self.queue is not None:
                # ensure, not enqueue: a hot near-miss fingerprint
                # re-resolves per request and must not rewrite an
                # identical work item each time (same reasoning as
                # flag()'s unchanged-short-circuit above)
                self.queue.ensure(fp, self._request_payload(req),
                                  reason="refine-near-miss",
                                  trace=obs_context.current())
            prov = {
                "verified": verified,
                "was_predicted": True,
                "uncertainty": round(float(sigma), 4),
                "compiles": 0,
                "measurements": 0,
                "source_exact": rec["exact"],
                "neighbor_vs_naive": rec.get("vs_naive"),
                **rec.get("provenance", {}),
            }
            return Resolution(tier="near", fingerprint=fp, record=rec,
                              sequence=seq, pct50_us=None,
                              vs_naive=round(pred_vs, 4), provenance=prov)
        return None

    def _cold(self, req, fp: WorkloadFingerprint) -> Resolution:
        path = None
        if self.queue is not None:
            # the ambient trace context rides the work-item envelope:
            # the daemon drain this item causes is linkable back to the
            # query that caused it (obs/context.py)
            path = self.queue.ensure(fp, self._request_payload(req),
                                     reason="cold",
                                     trace=obs_context.current())
        return Resolution(
            tier="cold", fingerprint=fp, work_item=path,
            provenance={"was_predicted": False, "compiles": 0,
                        "measurements": 0})

    def _near_or_cold(self, req, fp: WorkloadFingerprint) -> Resolution:
        """The write-needing tiers, gated on the read-only latch
        (serve/store.py): near flags + enqueues, cold enqueues — none of
        that can land while the store is degraded, so both shed with
        :class:`StoreReadonlyError` (a listen loop converts it to a
        ``{"shed": true, "reason": "store_readonly"}`` response; exact
        hits above keep answering from the sealed cache throughout).  An
        ENOSPC-family OSError escaping a tier write trips the latch
        here, so the *next* request sheds before touching the disk."""
        ro = store_readonly(self.store.path)
        if ro is not None:
            get_metrics().counter("serve.shed.store_readonly").inc()
            raise StoreReadonlyError(
                f"store degraded read-only ({ro.get('error')})")
        try:
            return self._try_near(req, fp) or self._cold(req, fp)
        except OSError as e:
            if is_unwritable_io(e):
                mark_store_unwritable(self.store.path, e)
                get_metrics().counter("serve.shed.store_readonly").inc()
                raise StoreReadonlyError(str(e)) from e
            raise

    @staticmethod
    def _request_payload(req) -> Dict[str, Any]:
        fn = getattr(req, "to_json", None)
        return fn() if callable(fn) else dict(vars(req))

    # -- entry ---------------------------------------------------------------
    def resolve(self, req, fp_key: Optional[Tuple] = None) -> Resolution:
        """Resolve a :class:`~tenzing_tpu_torch.bench.driver.DriverRequest`
        through the tiers, under the ambient trace context (one is
        minted here when the caller arrived without one — the resolver
        is the ingress of record for non-listen paths).  ``fp_key`` is
        the request's verbatim-kwargs tuple (:func:`fp_cache_key`) when
        the caller has one: it keys the fingerprint canonicalization
        cache and seeds :meth:`resolve_fast` for the next arrival."""
        ctx = obs_context.current() or obs_context.new_trace()
        with obs_context.use(ctx):
            return self._resolve(req, ctx, fp_key)

    def _resolve(self, req, ctx, fp_key: Optional[Tuple] = None) -> Resolution:
        reg = get_metrics()
        tr = get_tracer()
        t0 = time.perf_counter()
        gen = getattr(self.store, "generation", 0)
        if gen != self._exact_cache_gen:
            # any record landing anywhere (add/merge/load/flag)
            # invalidates the whole answer cache: coarse, but merges are
            # rare and a stale answer would outlive the better record
            # that beat it — counted per sealed memo dropped, and the
            # lock-free snapshot is republished empty
            self._invalidate_exact_cache(gen)
        phases: Dict[str, float] = {}
        with tr.span("serve.query") as sp:
            # fingerprint canonicalization is the first per-hit phase the
            # ROADMAP's tens-of-µs item profiles — timed always (two
            # perf_counter reads), sub-spanned only when tracing is on
            t_fp = time.perf_counter()
            if tr.enabled:
                with tr.span("serve.fingerprint"):
                    fp = self._fingerprint(req, fp_key)
            else:
                fp = self._fingerprint(req, fp_key)
            phases["fingerprint"] = round(
                (time.perf_counter() - t_fp) * 1e6, 2)
            sp.set("workload", fp.workload)
            sp.set("exact", fp.exact_digest)
            sp.set("bucket", fp.bucket_digest)
            res = self._try_exact(req, fp, phases)
            if res is None:
                res = self._near_or_cold(req, fp)
            sp.set("tier", res.tier)
        res.phase_us = phases
        res.trace_id = ctx.trace_id
        reg.counter(f"serve.{res.tier}").inc()
        dt_us = (time.perf_counter() - t0) * 1e6
        # windowed retention (obs/metrics.py): a live SLO block must
        # read the pct99 of CURRENT traffic — first-N retention would
        # freeze the series at whatever the process saw before the cap
        # filled and hide every post-warm-up regression
        reg.histogram("serve.resolve_us", window=True).observe(dt_us)
        # the per-tier series the SLO block and the follow view read:
        # exact-tier pct99 mixed with cold-tier enqueue latency would
        # steer the tens-of-µs target with the wrong number
        reg.histogram(f"serve.resolve_us.{res.tier}",
                      window=True).observe(dt_us)
        return res
