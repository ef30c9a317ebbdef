"""Surrogate benchmarkers: the trained model as a (screening) benchmarker.

Counterpart of ``tenzing_tpu/learn/surrogate.py``.  Two drop-ins for the
benchmarker protocol (``benchmark(order, opts) -> BenchResult``):

* :class:`SurrogateBenchmarker` answers every query from the model, with no
  device;
* :class:`ScreeningBenchmarker` predicts first and escalates to the wrapped
  benchmarker only when the query needs a measurement: a query at another
  fidelity than the screen's (``screen_only_opts``), the warm-up before the
  screen has calibrated, or a candidate whose optimistic bound reaches the
  empirical top-k.

Calibration: the model predicts ``log(t / anchor)`` in its training regime;
every escalation gives a (predicted, measured) pair, their running median
residual becomes a log-space bias, and the residuals' spread widens the
escalation band, so a model that is wrong for this run measures more
instead of mis-ranking.  A fidelity escalation (the confirm pass) is
measured at another floor and does not feed the calibration.

Observability: the ``learn.screen.surrogate_hits`` / ``escalations``
counters, the ``learn.screen.abs_log_err`` histogram, the
``learn.screen.bias`` gauge and a ``learn.screen`` trace event per query.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from tenzing_tpu_torch.bench.benchmarker import (
    BenchOpts,
    BenchResult,
    schedule_id,
)
from tenzing_tpu_torch.core.sequence import Sequence, canonical_key
from tenzing_tpu_torch.obs.metrics import get_metrics
from tenzing_tpu_torch.obs.tracer import get_tracer
from tenzing_tpu_torch.utils.numeric import med, stddev


class SurrogateBenchmarker:
    """Model-only benchmarker: predicted time + uncertainty, no device.

    ``anchor_s`` maps the model's relative label back to seconds
    (``pct50 = anchor_s * exp(prediction)``); with the default 1.0 the
    returned "times" are relative to the training corpus's naive — fine for
    ranking, which is all a screen needs.  Predictions are cached by
    ``canonical_key``, the same equivalence every other benchmarker layer
    keys on."""

    def __init__(self, model, nbytes: Optional[Dict[str, int]] = None,
                 env=None, anchor_s: float = 1.0, cost_fn=None):
        self.model = model
        self.nbytes = dict(nbytes) if nbytes else {}
        self.env = env
        self.anchor_s = float(anchor_s)
        self.cost_fn = cost_fn
        self._cache: Dict[tuple, Tuple[float, float]] = {}

    def predict(self, order: Sequence) -> Tuple[float, float]:
        """(mean, std) of the predicted label ``log(t / anchor)``.

        The sequence is redundant-sync-normalized before featurization —
        the same equivalence the cache key uses, and the same normalization
        the corpus applies at train time (learn/dataset.py) — so two
        sync-layout spellings of one program cannot produce different
        feature vectors, and train/serve feature distributions agree."""
        from tenzing_tpu_torch.core.schedule import remove_redundant_syncs

        norm = remove_redundant_syncs(order)
        return self.predict_normalized(norm, canonical_key(norm))

    def predict_normalized(self, norm: Sequence,
                           key: tuple) -> Tuple[float, float]:
        """:meth:`predict` for an already-normalized sequence with its
        canonical key precomputed — the screen's hot path normalizes once
        and shares the work instead of re-deriving it here."""
        got = self._cache.get(key)
        if got is None:
            from tenzing_tpu_torch.learn.features import featurize

            mu, sigma = self.model.predict(
                featurize(norm, nbytes=self.nbytes, env=self.env,
                          cost_fn=self.cost_fn))
            got = self._cache[key] = (float(mu), float(sigma))
            get_metrics().counter("learn.surrogate.predictions").inc()
        return got

    def predicted_secs(self, order: Sequence) -> float:
        return self.anchor_s * math.exp(self.predict(order)[0])

    def benchmark(self, order: Sequence,
                  opts: Optional[BenchOpts] = None) -> BenchResult:
        mu, sigma = self.predict(order)
        t = self.anchor_s * math.exp(mu)
        lo = self.anchor_s * math.exp(mu - 2.0 * sigma)
        hi = self.anchor_s * math.exp(mu + 2.0 * sigma)
        return BenchResult(pct01=lo, pct10=lo, pct50=t, pct90=hi, pct99=hi,
                           stddev=t * sigma)


class ScreeningBenchmarker:
    """Surrogate-prescreen in front of an empirical benchmarker.

    Escalation policy, per query (first match wins):

    1. **fidelity** — ``screen_only_opts`` is set and the query's opts
       differ: full-fidelity queries (the MCTS confirm pass, the paired
       final) always measure; only the cheap screen floor may be answered
       from the model.
    2. **warmup** — fewer than ``escalate_topk`` empirical results so far:
       the bias correction needs residuals before predictions are
       trustworthy for this run's regime.
    3. **topk** — the calibrated optimistic bound ``mu + bias - z * (sigma
       + resid_sigma)`` reaches the k-th best empirical time seen: the
       candidate plausibly belongs in the top-k, so it earns a real
       measurement (anything the screen answers cheaply is, with
       confidence ~z, outside the money).

    Everything else returns the surrogate's (bias-corrected) prediction.
    ``hits`` / ``escalations`` count the split — the measurement-economy
    counters the acceptance gate asserts on."""

    def __init__(self, surrogate: SurrogateBenchmarker, inner,
                 escalate_topk: int = 8, z: float = 2.0,
                 screen_only_opts: Optional[BenchOpts] = None):
        self.surrogate = surrogate
        self.inner = inner
        self.escalate_topk = max(1, int(escalate_topk))
        self.z = float(z)
        self.screen_only_opts = screen_only_opts
        # model answers are deterministic and identical on every rank, so
        # the screen is exactly as rank-coherent as the benchmarker it
        # escalates to (fault/resilient.py's agreement protocol propagates
        # through wrappers via this attribute — solvers check it before
        # treating a multi-host benchmark failure as a reject)
        self.rank_coherent = getattr(inner, "rank_coherent", False)
        self.hits = 0          # surrogate-answered queries
        self.escalations = 0   # queries forwarded to the empirical inner
        self._deltas: List[float] = []   # log(measured) - log(predicted)
        self._bias = 0.0                 # running median of _deltas
        self._emp_logs: List[float] = []  # log pct50 of escalated results
        self._predicted: set = set()     # normalized keys answered by model

    def was_predicted(self, order: Sequence) -> bool:
        """True if a query equivalent to ``order`` was ever answered from
        the model rather than measured — dump paths use this to tag such
        rows ``fid=model`` so archived databases never pass predictions off
        as device measurements."""
        from tenzing_tpu_torch.core.schedule import remove_redundant_syncs

        return canonical_key(remove_redundant_syncs(order)) in self._predicted

    def _escalation_reason(self, mu: float,
                           sigma: float,
                           opts: Optional[BenchOpts]) -> Optional[str]:
        if self.screen_only_opts is not None and (
                opts != self.screen_only_opts):
            return "fidelity"
        if len(self._emp_logs) < self.escalate_topk:
            return "warmup"
        resid = stddev(self._deltas) if len(self._deltas) > 1 else 0.0
        lcb = (math.log(self.surrogate.anchor_s) + mu + self._bias
               - self.z * (sigma + resid))
        kth = sorted(self._emp_logs)[self.escalate_topk - 1]
        if lcb <= kth:
            return "topk"
        return None

    def benchmark(self, order: Sequence,
                  opts: Optional[BenchOpts] = None) -> BenchResult:
        from tenzing_tpu_torch.core.schedule import remove_redundant_syncs

        reg = get_metrics()
        tr = get_tracer()
        # one normalization + canonicalization per query, shared with the
        # surrogate's prediction cache and the provenance set
        norm = remove_redundant_syncs(order)
        key = canonical_key(norm)
        mu, sigma = self.surrogate.predict_normalized(norm, key)
        reason = self._escalation_reason(mu, sigma, opts)
        if reason is None:
            self.hits += 1
            reg.counter("learn.screen.surrogate_hits").inc()
            self._predicted.add(key)
            t = self.surrogate.anchor_s * math.exp(mu + self._bias)
            if tr.enabled:
                tr.event("learn.screen", schedule=schedule_id(order),
                         escalated=False, pct50=t, sigma=sigma)
            lo = t * math.exp(-2.0 * sigma)
            hi = t * math.exp(2.0 * sigma)
            return BenchResult(pct01=lo, pct10=lo, pct50=t, pct90=hi,
                               pct99=hi, stddev=t * sigma)
        self.escalations += 1
        reg.counter("learn.screen.escalations").inc()
        reg.counter(f"learn.screen.escalations.{reason}").inc()
        res = self.inner.benchmark(order, opts)
        # "fidelity" escalations measure at a DIFFERENT floor (the confirm
        # pass's full bench_opts, ~10-100x the screen floor) — their
        # absolute times belong to another measurement regime and must not
        # feed the screen-floor calibration: a confirm result in _deltas
        # would shift the bias gauge and fatten the abs_log_err histogram
        # with pure regime offset, and one in _emp_logs would poison the
        # top-k threshold the screen-floor LCBs compare against
        if reason != "fidelity" and res.pct50 > 0.0:
            delta = math.log(res.pct50) - (
                math.log(self.surrogate.anchor_s) + mu)
            # post-calibration error: how wrong the *corrected* prediction
            # was — the regime offset itself lands in the bias gauge
            reg.histogram("learn.screen.abs_log_err").observe(
                abs(delta - self._bias))
            self._deltas.append(delta)
            self._bias = med(self._deltas)
            reg.gauge("learn.screen.bias").set(self._bias)
            self._emp_logs.append(math.log(res.pct50))
        if tr.enabled:
            tr.event("learn.screen", schedule=schedule_id(order),
                     escalated=True, reason=reason, pct50=res.pct50)
        return res
