"""Corpus analytics and the regression check:
``python -m tenzing_tpu_torch.obs.report``.

Counterpart of ``tenzing_tpu/obs/report.py``, the same sections, flags,
verdicts and exit codes.  It mines what runs leave on disk — recorded
search databases, driver JSON verdicts, checkpoint journals, quarantines,
telemetry bundles, stores and work queues — into one markdown report, and
runs the noise-aware regression check.

Sections (each optional, driven by which inputs are given):

* ``--csv GLOB``   — each recorded database: rows, naive anchor, best
  in-file paired ratio (the ranking bench/recorded.py warm-starts from;
  numbers only, no graph);
* ``--bench GLOB`` — driver verdicts: value, vs_baseline, naive, and the
  fault, perf and attrib blocks; the port's own blocks (``device``,
  ``reported_schedule``, the result ``gate``) in a table of their own;
* ``--journal DIR`` — checkpoint journals: measurements by provenance,
  batch replays, quarantine contents;
* ``--trace GLOB`` — telemetry bundles: top spans by total duration,
  event counts;
* ``--metrics GLOB`` — metrics JSON histograms; a summary whose raw series
  was truncated (``truncated: true``, obs/metrics.py) is labeled
  prefix-only;
* ``--store PATH [--queue-dir DIR]`` — schedule stores (records per
  fingerprint, best ``vs_naive``, flags, tenants; a segmented directory's
  segments, listen-loop status and request log) and the work queue;
* ``--causal GLOB`` — per-request critical paths (obs/causal.py).

Regression check (``--check FRESH --baseline BASELINE [--tol T]``):
compares two driver verdicts (raw driver lines or the ``{"parsed": ...}``
wrapper).  The primary series is ``vs_baseline`` (the paired speedup);
the secondary the naive-relative value (``value / naive_us``).  When the
fresh verdict's attrib block carries the winner's raw measurement series
and that series fails bench/randomness.py's runs test, a would-be
regression is reported ``inconclusive`` (drift or interference:
re-measure).  Exit status: 0 ok or inconclusive, 1 regression, 2 usage
error.

The same flags take the replay family (serve/replay.py documents, ``kind:
"serve_trace_replay"``): the primary series is the segmented exact tier's
``pct99_us`` (a ceiling), the secondaries per-query verifier calls and
sheds reappearing, the noise rule runs over the document's raw
``exact_samples_us``, and two documents whose measured host-noise floors
differ (obs/noise.py) are not compared.

``--follow`` is the live view: it renders the ``status-*.json`` and
``metrics-*.json`` documents of every listen loop and drain daemon under
``--store`` / ``--queue-dir`` (liveness, queue depth and age, tier mix,
SLO state, firing alerts) every ``--interval`` seconds.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from tenzing_tpu_torch.bench.benchmarker import CSV_DELIM, split_fidelity
from tenzing_tpu_torch.bench.randomness import runs_test_z
from tenzing_tpu_torch.bench.recorded import naive_anchor_of
from tenzing_tpu_torch.obs.alerts import backlog_summary, firing_lines
from tenzing_tpu_torch.obs.causal import aggregate, analyze_bundles, localize_phases
from tenzing_tpu_torch.obs.export import read_jsonl
from tenzing_tpu_torch.obs.metrics import latest_snapshots
from tenzing_tpu_torch.obs.noise import floor_vs_tail, floors_differ
from tenzing_tpu_torch.serve import dr
from tenzing_tpu_torch.serve.reqlog import read_exemplars, read_request_log
from tenzing_tpu_torch.serve.store import WorkQueue, open_store
from tenzing_tpu_torch.utils.numeric import percentile


# -- driver-JSON loading ----------------------------------------------------

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


def _load_check_doc(path: str) -> Dict[str, Any]:
    """A document for the regression check: a trace-replay document
    (serve/replay.py) (``kind: "serve_trace_replay"``) is returned whole; anything
    else goes through the driver-JSON loader."""
    try:
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and \
                doc.get("kind") == "serve_trace_replay":
            return doc
    except ValueError:
        pass
    return load_driver_json(path)


# -- regression check -------------------------------------------------------

def check_regression(fresh: Dict[str, Any], baseline: Dict[str, Any],
                     tol: float = 0.05) -> Dict[str, Any]:
    """Noise-aware comparison of a fresh driver verdict against a
    committed baseline (see module docstring).  Returns ``{"verdict":
    "ok"|"regression"|"inconclusive", "reasons": [...], ...}``."""
    reasons: List[str] = []
    checks: Dict[str, Any] = {}

    f_vs, b_vs = fresh.get("vs_baseline"), baseline.get("vs_baseline")
    if f_vs is not None and b_vs is not None and b_vs > 0:
        floor = b_vs * (1.0 - tol)
        checks["vs_baseline"] = {"fresh": f_vs, "baseline": b_vs,
                                 "floor": round(floor, 4)}
        if f_vs < floor:
            reasons.append(
                f"vs_baseline {f_vs:.4f} < {floor:.4f} "
                f"(baseline {b_vs:.4f} - {tol:.0%})")

    # naive-relative value: value/naive_us is regime-honest where raw value
    # is not (chip regimes swing >1.3x run to run — bench/recorded.py)
    def rel(d):
        v, n = d.get("value"), d.get("naive_us")
        return (v / n) if v and n else None

    f_rel, b_rel = rel(fresh), rel(baseline)
    if f_rel is not None and b_rel is not None and b_rel > 0:
        ceil = b_rel * (1.0 + tol)
        checks["relative_value"] = {"fresh": round(f_rel, 4),
                                    "baseline": round(b_rel, 4),
                                    "ceiling": round(ceil, 4)}
        if f_rel > ceil:
            reasons.append(
                f"value/naive {f_rel:.4f} > {ceil:.4f} "
                f"(baseline {b_rel:.4f} + {tol:.0%})")

    verdict = "regression" if reasons else "ok"
    times = (fresh.get("attrib") or {}).get("measured_times")
    verdict, checks2 = _noise_downgrade(verdict, reasons, times)
    checks.update(checks2)
    return {"verdict": verdict, "tol": tol, "reasons": reasons,
            "checks": checks}


def _noise_downgrade(verdict: str, reasons: List[str],
                     times) -> Tuple[str, Dict[str, Any]]:
    """THE shared noise rule: a would-be regression whose fresh raw
    series fails bench/randomness.py's i.i.d. runs test downgrades to
    ``inconclusive`` — the measurement, not the code, is suspect.  Used
    by both the driver-verdict and the serve-replay check."""
    checks: Dict[str, Any] = {}
    if verdict == "regression" and times and len(times) >= 8:
        z_crit = 1.96  # is_random's 95%-confidence default
        z = runs_test_z(list(times))
        checks["runs_test_z"] = round(z, 3)
        if abs(z) > z_crit:
            verdict = "inconclusive"
            reasons.append(
                f"fresh measurement series fails the runs test "
                f"(|Z|={abs(z):.2f} > {z_crit}) — re-measure before "
                "trusting the regression")
    return verdict, checks


def check_serve_regression(fresh: Dict[str, Any], baseline: Dict[str, Any],
                           tol: float = 0.25) -> Dict[str, Any]:
    """The replay-family twin of :func:`check_regression`
    (module docstring): segmented exact-tier pct99 as a ceiling,
    verifier-call and shed reappearance as secondaries, the same
    noise-aware downgrade over the fresh ``exact_samples_us`` series.
    The default tolerance is wider than the bench gate's — wall-clock
    microsecond latencies swing more host-to-host than paired ratios."""
    reasons: List[str] = []
    checks: Dict[str, Any] = {}

    def exact(doc):
        return ((doc.get("segmented") or {}).get("resolve_us") or {}).get(
            "exact") or {}

    f_p99, b_p99 = exact(fresh).get("pct99_us"), \
        exact(baseline).get("pct99_us")
    if f_p99 is not None and b_p99:
        ceil = b_p99 * (1.0 + tol)
        checks["exact_pct99_us"] = {"fresh": f_p99, "baseline": b_p99,
                                    "ceiling": round(ceil, 1)}
        if f_p99 > ceil:
            reasons.append(
                f"segmented exact pct99 {f_p99:.1f}us > {ceil:.1f}us "
                f"(baseline {b_p99:.1f}us + {tol:.0%})")
    f_ver = (fresh.get("segmented") or {}).get("verifier_calls")
    b_ver = (baseline.get("segmented") or {}).get("verifier_calls")
    if f_ver is not None and b_ver is not None:
        checks["verifier_calls"] = {"fresh": f_ver, "baseline": b_ver}
        if f_ver > b_ver:
            # zero per-query verifier invocations is an admission-time
            # design guarantee, not a tolerance band
            reasons.append(
                f"per-query verifier calls reappeared "
                f"({b_ver} -> {f_ver})")
    f_shed = (fresh.get("segmented") or {}).get("shed")
    b_shed = (baseline.get("segmented") or {}).get("shed")
    if f_shed is not None and b_shed is not None:
        checks["shed"] = {"fresh": f_shed, "baseline": b_shed}
        if f_shed > b_shed:
            reasons.append(f"shed responses grew ({b_shed} -> {f_shed}) "
                           "at the same paced QPS")

    # differential localization (obs/causal.py): when the per-phase
    # samples are present in both documents, name the segment that moved
    # — "cache_probe regressed 3.1x" steers a fix; a bare pct99 doesn't
    loc = localize_phases(fresh, baseline, tol=tol)
    if loc["compared"]:
        checks["segments"] = loc
        for m in loc["moved"]:
            reasons.append(
                f"phase '{m['segment']}' pct99 regressed "
                f"{m['ratio']:.1f}x ({m['baseline_pct99_us']:.1f}us -> "
                f"{m['fresh_pct99_us']:.1f}us)")

    verdict = "regression" if reasons else "ok"
    samples = (fresh.get("segmented") or {}).get("exact_samples_us")
    verdict, checks2 = _noise_downgrade(verdict, reasons, samples)
    checks.update(checks2)

    # measured host-noise floors (obs/noise.py): a fresh document from a
    # materially noisier/quieter host is not comparable — downgrade any
    # would-be regression rather than blame the code for the scheduler
    f_noise, b_noise = fresh.get("host_noise"), baseline.get("host_noise")
    fvt = floor_vs_tail(f_noise, f_p99)
    if fvt is not None:
        checks["host_noise"] = fvt
    diff = floors_differ(f_noise, b_noise)
    if diff is not None:
        checks["host_floors"] = diff
        if verdict == "regression":
            verdict = "inconclusive"
            reasons.append(
                f"hosts are not comparable: {diff} — re-measure both "
                "documents on one host before trusting the regression")
    return {"verdict": verdict, "tol": tol, "reasons": reasons,
            "checks": checks, "family": "serve_trace_replay"}


# -- recorded-database mining (numeric parse, no graph) ---------------------

def _csv_rows(path: str) -> List[Tuple[int, float, str]]:
    """(row idx, pct50, fidelity) per parseable row of a recorded DB."""
    out = []
    with open(path) as f:
        for line in f:
            cells = line.rstrip("\n").split(CSV_DELIM)
            try:
                idx = int(cells[0])
                pct50 = float(cells[3])
                fid, _ = split_fidelity(cells)
            except (ValueError, IndexError):
                continue
            out.append((idx, pct50, fid))
    return out


def _workload_of(path: str) -> str:
    base = os.path.basename(path)
    return base.split("_")[0] if "_" in base else base


def corpus_section(csv_paths: List[str]) -> List[str]:
    lines = ["## Recorded search databases", "",
             "| file | workload | rows (full) | naive anchor (us) | "
             "best in-file ratio | best pct50 (us) |",
             "|---|---|---|---|---|---|"]
    best_by_wl: Dict[str, float] = {}
    for path in csv_paths:
        try:
            rows = _csv_rows(path)
            anchor = naive_anchor_of(path)
        except OSError as e:
            lines.append(f"| {os.path.basename(path)} | — | unreadable "
                         f"({e.__class__.__name__}) | | | |")
            continue
        full = [(i, p) for i, p, fid in rows
                if fid == "full" and i > 0 and p > 0]
        wl = _workload_of(path)
        if anchor and full:
            best_p = min(p for _, p in full)
            ratio = anchor / best_p
            best_by_wl[wl] = max(best_by_wl.get(wl, 0.0), ratio)
            lines.append(
                f"| {os.path.basename(path)} | {wl} | {len(rows)} "
                f"({len(full)}) | {anchor * 1e6:.1f} | {ratio:.3f} | "
                f"{best_p * 1e6:.1f} |")
        else:
            lines.append(
                f"| {os.path.basename(path)} | {wl} | {len(rows)} "
                f"({len(full)}) | {'—' if not anchor else f'{anchor*1e6:.1f}'}"
                " | — | — |")
    if best_by_wl:
        lines += ["", "Best recorded in-file paired ratio per workload: " +
                  ", ".join(f"**{wl}** {r:.3f}x"
                            for wl, r in sorted(best_by_wl.items()))]
    lines.append("")
    return lines


# -- driver-JSON mining -----------------------------------------------------

def bench_section(paths: List[str]) -> List[str]:
    lines = ["## Driver verdicts", "",
             "| file | metric | value (us) | vs_baseline | naive (us) | "
             "compile (s) | prefetch hit/issued | quarantined | verified | "
             "overlap eff | dispatch ovh (us) |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    fused_lines: List[str] = []
    chunk_lines: List[str] = []
    synth_lines: List[str] = []
    port_lines: List[str] = []
    for path in paths:
        try:
            d = load_driver_json(path)
        except (OSError, ValueError) as e:
            lines.append(f"| {os.path.basename(path)} | unreadable "
                         f"({e.__class__.__name__}) | | | | | | | | | |")
            continue
        perf = d.get("perf") or {}
        pf = perf.get("prefetch") or {}
        fault = d.get("fault") or {}
        at = d.get("attrib") or {}
        ver = fault.get("verified")
        lines.append(
            "| {f} | {m} | {v} | {vs} | {n} | {c} | {ph}/{pi} | {q} | {ok} "
            "| {oe} | {do} |".format(
                f=os.path.basename(path), m=d.get("metric", "—"),
                v=d.get("value", "—"), vs=d.get("vs_baseline", "—"),
                n=d.get("naive_us", "—"),
                c=perf.get("compile_secs", "—"),
                ph=pf.get("hits", "—"), pi=pf.get("issued", "—"),
                q=fault.get("quarantined", 0),
                ok=("—" if ver is None else ver),
                oe=at.get("overlap_efficiency", "—"),
                do=at.get("dispatch_overhead_us", "—")))
        if any(k in d for k in ("device", "reported_schedule", "gate")):
            port_lines.append(_port_row(os.path.basename(path), d))
        ch = perf.get("chunked")
        if ch:
            # op-chunking economics: what the roofline let onto the menus, what the
            # search visited/chose, and the hidden comm the chunking
            # bought — estimated bound vs stepped-timeline measurement
            if "error" in ch and "menus" not in ch:
                chunk_lines.append(
                    f"- `{os.path.basename(path)}`: chunk provenance "
                    f"failed ({ch['error']})")
            else:
                menus = ch.get("menus") or {}
                n_gt1 = sum(1 for m in menus.values()
                            if [c for c in m.get("counts", []) if c > 1])
                chosen = ch.get("chosen") or {}
                hc = ch.get("hidden_comm_us") or {}
                msd = hc.get("measured")
                chunk_lines.append(
                    f"- `{os.path.basename(path)}`: {len(menus)} menu(s) "
                    f"({n_gt1} with counts>1), searched counts "
                    f"{ch.get('searched_counts', [])} over "
                    f"{ch.get('n_candidates_chunked', 0)} candidate(s), "
                    f"winner {'unchunked' if not chosen else chosen}, "
                    f"hidden comm est {hc.get('estimated', 0)}us / "
                    f"measured {'—' if msd is None else f'{msd}us'}"
                    + (f" — {ch['note']}" if ch.get("note") else ""))
        sy = perf.get("synth")
        if sy:
            # synthesized-collective economics: the sketch menus the pricing let
            # stand next to the fixed engine, what the search visited and
            # chose, and the est-vs-measured comm of the decomposition
            if "error" in sy and "menus" not in sy:
                synth_lines.append(
                    f"- `{os.path.basename(path)}`: synth provenance "
                    f"failed ({sy['error']})")
            else:
                smenus = sy.get("menus") or {}
                n_alt = sum(1 for m in smenus.values()
                            if len(m.get("menu", [])) > 1)
                schosen = sy.get("chosen") or {}
                msd = sy.get("measured_hidden_us")
                synth_lines.append(
                    f"- `{os.path.basename(path)}`: {len(smenus)} site(s) "
                    f"({n_alt} with sketch alternatives), searched "
                    f"{sy.get('searched_sketches', [])} over "
                    f"{sy.get('n_candidates_synth', 0)} candidate(s), "
                    f"winner {'fixed-engine' if not schosen else schosen}, "
                    f"est comm {sy.get('est_comm_us', 0)}us / hidden "
                    f"measured {'—' if msd is None else f'{msd}us'}, "
                    f"verified {sy.get('verified', False)}"
                    + (f" — {sy['note']}" if sy.get("note") else ""))
        fu = perf.get("fused")
        if fu:
            # fused-region economics: regions
            # lowered, tile chosen, and the dispatch overhead the fused
            # program removed vs its stepped twin
            if "error" in fu and "regions" not in fu:
                fused_lines.append(
                    f"- `{os.path.basename(path)}`: fusion failed "
                    f"({fu['error']})")
                continue
            do = fu.get("dispatch_overhead_us") or {}
            before, after = do.get("before"), do.get("after")
            removed = (f"{before - after:.1f}us removed "
                       f"({before} -> {after})"
                       if before is not None and after is not None else "—")
            fused_lines.append(
                f"- `{os.path.basename(path)}`: {fu.get('regions', 0)} "
                f"region(s) over {fu.get('fused_ops', 0)}/"
                f"{fu.get('n_ops_total', 0)} ops, tiles "
                f"{(fu.get('tiles') or {}).get('chosen', 1)}, dispatch "
                f"overhead {removed}, verified "
                f"{fu.get('verified', False)}")
    lines.append("")
    if port_lines:
        lines += ["### Device, reported schedule and result gate", "",
                  "| file | device | reported schedule | gate |",
                  "|---|---|---|---|"] + port_lines + [""]
    if fused_lines:
        lines += ["### Megakernel fusion", ""] + fused_lines + [""]
    if chunk_lines:
        lines += ["### Chunked overlap", ""] + chunk_lines + [""]
    if synth_lines:
        lines += ["### Synthesized collectives", ""] + synth_lines + [""]
    return lines


def _port_row(name: str, d: Dict[str, Any]) -> str:
    """One row of the blocks only the port's driver verdict carries: the
    device it ran on, the id of the schedule whose number it reports, and
    the result gate's verdict per side (buffers within the limit of their
    precision)."""
    dev = d.get("device") or {}
    device = (f"{dev.get('type', '?')} ({dev.get('name', '?')})"
              if isinstance(dev, dict) and dev else "—")
    sched = d.get("reported_schedule")
    gate = d.get("gate") or {}
    sides = []
    for side in ("winner", "naive"):
        g = gate.get(side)
        if not isinstance(g, dict):
            continue
        bufs = g.get("buffers") or {}
        n_ok = sum(1 for b in bufs.values()
                   if isinstance(b, dict) and b.get("ok"))
        sides.append(f"{side} {g.get('precision', '?')} {n_ok}/{len(bufs)} "
                     "within limit")
    return (f"| {name} | {device} | "
            f"{'—' if not sched else f'`{str(sched)[:16]}`'} | "
            f"{'; '.join(sides) if sides else '—'} |")


# -- checkpoint-journal mining ----------------------------------------------

def journal_section(dirs: List[str]) -> List[str]:
    lines = ["## Checkpoint journals", ""]
    for d in dirs:
        jpath = os.path.join(d, "measurements.jsonl")
        qpath = os.path.join(d, "quarantine.json")
        lines.append(f"### `{d}`")
        if not os.path.exists(jpath):
            lines += ["", "no measurement journal", ""]
        else:
            by_prov: Dict[str, int] = {}
            pct50s: List[float] = []
            batches = 0
            skipped = 0
            with open(jpath) as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        j = json.loads(line)
                    except ValueError:
                        skipped += 1  # torn tail line
                        continue
                    if "batch" in j:
                        batches += 1
                        continue
                    prov = j.get("prov", "measured")
                    by_prov[prov] = by_prov.get(prov, 0) + 1
                    try:
                        pct50s.append(float(j["result"]["pct50"]))
                    except (KeyError, TypeError, ValueError):
                        pass
            lines.append("")
            lines.append(f"- measurements: {sum(by_prov.values())} (" +
                         ", ".join(f"{k}={v}"
                                   for k, v in sorted(by_prov.items())) +
                         f"), paired batches: {batches}" +
                         (f", torn/skipped lines: {skipped}" if skipped
                          else ""))
            if pct50s:
                xs = sorted(pct50s)
                lines.append(
                    f"- journaled pct50 (us): min {xs[0]*1e6:.1f} / p50 "
                    f"{percentile(xs, 50)*1e6:.1f} / max {xs[-1]*1e6:.1f}")
        if os.path.exists(qpath):
            try:
                with open(qpath) as f:
                    q = json.load(f)
                entries = q.get("entries", {})
                by_cls: Dict[str, int] = {}
                for e in entries.values():
                    c = e.get("error_class", "?")
                    by_cls[c] = by_cls.get(c, 0) + 1
                lines.append(
                    f"- quarantine: {len(entries)} schedule(s)" +
                    (" (" + ", ".join(f"{k}={v}"
                                      for k, v in sorted(by_cls.items())) +
                     ")" if by_cls else ""))
            except (OSError, ValueError):
                lines.append("- quarantine: unreadable")
        lines.append("")
    return lines


# -- telemetry-bundle mining ------------------------------------------------

def trace_section(paths: List[str], top: int = 12) -> List[str]:
    lines = ["## Telemetry bundles", ""]
    for path in paths:
        try:
            recs = read_jsonl(path)
        except (OSError, ValueError) as e:
            lines += [f"### `{path}`", "", f"unreadable ({e})", ""]
            continue
        span_tot: Dict[str, float] = {}
        span_n: Dict[str, int] = {}
        ev_n: Dict[str, int] = {}
        for r in recs:
            if r.get("kind") == "span":
                nm = r.get("name", "?")
                span_tot[nm] = span_tot.get(nm, 0.0) + float(
                    r.get("dur_us", 0.0))
                span_n[nm] = span_n.get(nm, 0) + 1
            elif r.get("kind") == "event":
                nm = r.get("name", "?")
                ev_n[nm] = ev_n.get(nm, 0) + 1
        lines += [f"### `{path}`", "",
                  f"- records: {len(recs)} ({sum(span_n.values())} spans, "
                  f"{sum(ev_n.values())} events)",
                  "", "| span | count | total (s) |", "|---|---|---|"]
        for nm in sorted(span_tot, key=lambda n: -span_tot[n])[:top]:
            lines.append(f"| {nm} | {span_n[nm]} | "
                         f"{span_tot[nm] / 1e6:.3f} |")
        if ev_n:
            lines += ["", "events: " + ", ".join(
                f"{nm}={ev_n[nm]}"
                for nm in sorted(ev_n, key=lambda n: -ev_n[n])[:top])]
        lines.append("")
    return lines


# -- metrics-JSON mining ----------------------------------------------------

def metrics_section(paths: List[str], top: int = 12) -> List[str]:
    lines = ["## Metrics", ""]
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            lines += [f"### `{path}`", "", f"unreadable ({e})", ""]
            continue
        hists = doc.get("histograms", {})
        lines += [f"### `{path}`", "",
                  "| histogram | count | sum | p50 | p99 | coverage |",
                  "|---|---|---|---|---|---|"]
        for nm in sorted(hists,
                         key=lambda n: -hists[n].get("sum", 0.0))[:top]:
            h = hists[nm]
            if h.get("window"):
                # windowed retention (obs/metrics.py): percentiles cover
                # the most recent raw_retained observations
                cov = (f"recent-window ({h.get('raw_retained', '?')}/"
                       f"{h.get('count', '?')})")
            elif h.get("truncated") or "raw_retained" in h:
                # obs/metrics.py Histogram.summary: the raw series was
                # capped; percentiles cover only the first raw_retained.
                # Legacy summaries (pre-``truncated`` flag) carried only
                # raw_retained — label those prefix-only too.
                cov = (f"prefix-only ({h.get('raw_retained', '?')}/"
                       f"{h.get('count', '?')})")
            else:
                cov = "full"
            lines.append(
                f"| {nm} | {h.get('count', 0)} | "
                f"{h.get('sum', 0.0):.4g} | {h.get('p50', '—')} | "
                f"{h.get('p99', '—')} | {cov} |")
        lines.append("")
    return lines


# -- serving-store mining ---------------------------------------------------

def store_section(store_paths: List[str],
                  queue_dir: Optional[str] = None) -> List[str]:
    """The schedule-serving store as a report section:
    what the fleet can answer without a search, and what is queued.
    Handles both backends via ``open_store`` — segmented directories gain
    a per-bucket segment table, the compaction ledger, the admission
    tally, and any serve-loop status documents found in the store."""
    lines = ["## Schedule-serving stores", ""]
    for path in store_paths:
        store = None
        if os.path.exists(path):
            # read-only: quarantine_corrupt=False means an unreadable or
            # version-mismatched file is reported but LEFT IN PLACE for
            # the serving process to quarantine — a diagnostics command
            # must never rename the store it was asked to describe
            notes: List[str] = []
            store = open_store(path, log=notes.append,
                               quarantine_corrupt=False)
            if notes and len(store) == 0:
                lines += [f"### `{path}`", "", notes[0], ""]
                continue
        if store is None or len(store) == 0:
            lines += [f"### `{path}`", "", "empty or missing store", ""]
            continue
        lines += [f"### `{path}`", "",
                  "| workload | fingerprint | schedules | best vs_naive | "
                  "flagged | tenants |",
                  "|---|---|---|---|---|---|"]
        for exact in sorted(store.entries):
            recs = list(store.entries[exact].values())
            best = store.best(exact)
            flagged = sum(1 for r in recs if any(r.get("flags", {}).values()))
            tenants = sorted({r.get("provenance", {}).get("tenant", "?")
                              for r in recs})
            lines.append(
                f"| {best.get('workload', '?')} | `{exact[:12]}` | "
                f"{len(recs)} | {best.get('vs_naive', 0):.3f} | {flagged} | "
                f"{', '.join(tenants)} |")
        st = store.stats()
        lines += ["",
                  f"- records: {st['records']} across "
                  f"{st['fingerprints']} fingerprint(s); "
                  f"{st['flagged']} flagged; "
                  f"{st['skipped_on_load']} skipped on load", ""]
        if st.get("backend") == "segmented":
            lines += segment_lines(st)
        if os.path.isdir(path):
            lines += serve_status_lines(path)
            lines += reqlog_lines(path)
    if queue_dir is not None:
        if not os.path.isdir(queue_dir):
            # surface the operator error (a typo'd path) instead of
            # silently creating it and reporting an empty queue
            lines += [f"### work queue `{queue_dir}`", "",
                      "missing directory", ""]
            return lines
        lines += queue_section(queue_dir)
    return lines


def segment_lines(st: Dict[str, Any]) -> List[str]:
    """The segmented-store internals (serve/segments.py stats): what the
    compactor sees — per-bucket segment counts, live/orphan/damage
    tallies, the admission verdicts, and the compaction ledger tail."""
    seg = st.get("segments", {})
    lines = ["#### segments", "",
             "| bucket | segments | live | records | bytes |",
             "|---|---|---|---|---|"]
    for bucket, b in sorted(st.get("by_bucket", {}).items()):
        lines.append(f"| `{bucket[:12]}` | {b.get('segments', 0)} | "
                     f"{b.get('live', 0)} | {b.get('records', 0)} | "
                     f"{b.get('bytes', 0)} |")
    lines += ["",
              f"- segments: {seg.get('count', 0)} "
              f"({seg.get('bytes', 0)} bytes); "
              f"orphans {seg.get('orphans', 0)}, "
              f"missing {seg.get('missing', 0)}, "
              f"quarantined {seg.get('quarantined', 0)}, "
              f"newer-skipped {seg.get('newer_skipped', 0)}; "
              f"checksum-failed records {st.get('checksum_failed', 0)}, "
              f"salvaged {st.get('salvaged', 0)}"]
    adm = st.get("admission", {})
    lines.append(
        f"- admission: {adm.get('verified', 0)} verified / "
        f"{adm.get('unsound', 0)} unsound (never served) / "
        f"{adm.get('unstamped', 0)} unstamped (lazy-verified)")
    last = st.get("last_compaction")
    if last:
        lines.append(
            f"- compactions: {st.get('compactions', 0)} ledgered; last: "
            f"bucket `{str(last.get('bucket', '?'))[:12]}` "
            f"{len(last.get('inputs', []))} -> 1 "
            f"({last.get('records', 0)} record(s)) by "
            f"{last.get('owner', '?')}")
    else:
        lines.append("- compactions: none ledgered")
    lines.append("")
    return lines


def _fastpath_rates(counters: Dict[str, Any]) -> Optional[str]:
    """The fast-path economics line from
    a metric snapshot's counter block: memo and fingerprint-cache hit
    rates + memo invalidations.  None when the process never served
    through either cache (nothing to rate)."""
    def rate(hits_key, misses_key):
        h = counters.get(hits_key, 0)
        m = counters.get(misses_key, 0)
        return (h, m, h / (h + m)) if (h + m) else None

    memo = rate("serve.memo.hits", "serve.memo.misses")
    fpc = rate("serve.fp_cache.hits", "serve.fp_cache.misses")
    if memo is None and fpc is None:
        return None
    parts = []
    if memo is not None:
        parts.append(f"memo hit rate {memo[2]:.1%} "
                     f"({memo[0]}/{memo[0] + memo[1]}, "
                     f"{counters.get('serve.memo.invalidations', 0)} "
                     "invalidated)")
    if fpc is not None:
        parts.append(f"fp-cache hit rate {fpc[2]:.1%} "
                     f"({fpc[0]}/{fpc[0] + fpc[1]})")
    return "fast path: " + ", ".join(parts)


def serve_status_lines(store_dir: str) -> List[str]:
    """Serve-loop status documents (serve/listen.py ``status-*.json``)
    found in a segmented store directory: liveness staleness + the
    served/shed/timeout economics — the same probe-target treatment the
    queue section gives daemon status docs.  Each loop's fast-path
    cache economics (memo + fingerprint-cache hit rates) render from
    its newest metric snapshot."""
    snapshots = latest_snapshots(store_dir)
    lines: List[str] = []
    now = time.time()
    for name in sorted(os.listdir(store_dir)):
        if not (name.startswith("status-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(store_dir, name)) as f:
                st = json.load(f)
        except (OSError, ValueError):
            lines.append(f"- service `{name}`: unreadable")
            continue
        if st.get("kind") != "serve_loop":
            continue
        c = st.get("counters", {})
        stale = now - float(st.get("heartbeat_at", 0))
        lines.append(
            f"- service `{st.get('owner', name)}`: {st.get('state')}, "
            f"heartbeat {stale:.1f}s ago — requests "
            f"{c.get('requests', 0)} (exact {c.get('served_exact', 0)}, "
            f"near {c.get('served_near', 0)}, cold "
            f"{c.get('served_cold', 0)}), shed {c.get('shed', 0)}, "
            f"timeouts {c.get('timeouts', 0)}, queue depth "
            f"{st.get('queue_depth', 0)}")
        snap = snapshots.get(st.get("owner"))
        if snap:
            rates = _fastpath_rates(
                (snap.get("metrics") or {}).get("counters") or {})
            if rates:
                lines.append(f"  - {rates}")
    if lines:
        lines.append("")
    return lines


def reqlog_lines(store_dir: str) -> List[str]:
    """The watchtower's recording state under a store directory
    (serve/reqlog.py, conventionally ``<store>/reqlog``): recorded
    traffic coverage and the exemplar bundles — THE exact worst
    requests behind a bad pct99, not an aggregate."""
    d = os.path.join(store_dir, "reqlog")
    if not os.path.isdir(d):
        return []
    lines: List[str] = []
    try:
        data = read_request_log(d)
    except OSError:
        return [f"- request log `{d}`: unreadable", ""]
    lines.append(
        f"- request log `{d}`: {len(data['records'])} record(s) across "
        f"{data['segments']} segment(s), {data['dropped_sampling']} "
        f"sampled out" +
        (f"; damage: {data['damaged']} segment(s), "
         f"{data['checksum_failed']} bad checksum(s), "
         f"{data['torn_lines']} torn line(s)"
         if data["damaged"] else ""))
    exemplars = read_exemplars(os.path.join(d, "exemplars"))
    if exemplars:
        # run the worst requests through the causal analyzer so the
        # table says WHERE each one's time went, not just how much
        # (obs/causal.py)
        chains: Dict[str, str] = {}
        paths = [ex["path"] for ex in exemplars[:12] if ex.get("path")]
        if paths:
            try:
                for tid, t in analyze_bundles(paths).items():
                    segs = t.get("segments_us") or {}
                    if segs:
                        top = sorted(segs.items(), key=lambda kv: -kv[1])
                        chains[tid] = ", ".join(
                            f"{k} {v:.0f}" for k, v in top[:3])
            except (OSError, ValueError):
                pass
        lines += ["", "| exemplar (worst requests) | reason | tier | "
                  "resolve (us) | top segments (us) |",
                  "|---|---|---|---|---|"]
        for ex in exemplars[:12]:
            rec = ex.get("record") or {}
            tid = str(ex.get("trace_id", "?"))
            lines.append(
                f"| `{tid[:16]}` | "
                f"{ex.get('reason', '?')} | {rec.get('tier', '—')} | "
                f"{rec.get('resolve_us', '—')} | "
                f"{chains.get(tid, '—')} |")
    lines.append("")
    return lines


def queue_section(queue_dir: str) -> List[str]:
    """The drain-daemon view of one work queue: depth by reason, the torn set (visible rot), live leases
    with heartbeat staleness, the poison quarantine, each worker's
    status JSON, and per-item drain economics mined from the status
    histories + the ``ckpt-*`` checkpoint journals."""
    q = WorkQueue(queue_dir)
    items = q.items()
    by_reason: Dict[str, int] = {}
    for _, payload in items:
        r = payload.get("reason", "?")
        by_reason[r] = by_reason.get(r, 0) + 1
    lines = [f"### work queue `{queue_dir}`", "",
             f"- depth: {len(items)}" +
             (" (" + ", ".join(f"{k}={v}" for k, v in
                               sorted(by_reason.items())) + ")"
              if by_reason else "")]
    if q.torn_paths:
        lines.append(
            f"- torn items: {len(q.torn_paths)} (" +
            ", ".join(f"`{os.path.basename(p)}`"
                      for p in q.torn_paths) + ")")
    leases = q.leases()
    if leases:
        lines += ["", "| lease | owner | heartbeat age (s) |", "|---|---|---|"]
        for l in leases:
            lines.append(f"| `{l['exact'][:12]}` | {l.get('owner', '?')} | "
                         f"{l['age_s']:.1f} |")
    poisoned = q.poisoned()
    if poisoned:
        lines += ["", "| poisoned | reason | attempts | last failure |",
                  "|---|---|---|---|"]
        for path, doc in poisoned:
            atts = doc.get("attempts", [])
            last = atts[-1] if atts else {}
            lines.append(
                f"| `{doc.get('exact', os.path.basename(path))[:12]}` | "
                f"{doc.get('reason', '?')} | {len(atts)} | "
                f"{last.get('error_class', '—')}: "
                f"{(last.get('message') or '—')[:60]} |")
    # daemon status documents: liveness + per-item drain economics
    now = time.time()
    for name in sorted(os.listdir(queue_dir)):
        if not (name.startswith("status-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(queue_dir, name)) as f:
                st = json.load(f)
        except (OSError, ValueError):
            lines += ["", f"- daemon `{name}`: unreadable"]
            continue
        c = st.get("counters", {})
        stale = now - float(st.get("heartbeat_at", 0))
        lines += ["",
                  f"- daemon `{st.get('owner', name)}`: {st.get('state')}"
                  f", heartbeat {stale:.1f}s ago — claimed "
                  f"{c.get('claimed', 0)}, completed {c.get('completed', 0)}"
                  f", retried {c.get('retried', 0)}, poisoned "
                  f"{c.get('poisoned', 0)}, reclaimed "
                  f"{c.get('reclaimed', 0)}"]
        hist = st.get("history", [])
        if hist:
            lines += ["",
                      "| item | outcome | wall (s) | attempts | "
                      "journal replays | merged |", "|---|---|---|---|---|---|"]
            for h in hist:
                lines.append(
                    f"| `{h.get('exact', '?')[:12]}` | {h.get('outcome')} | "
                    f"{h.get('wall_s', 0):.1f} | {h.get('attempts', 1)} | "
                    f"{h.get('journal_lines_prior', 0)} | "
                    f"{h.get('merged', 0)} |")
    # per-item checkpoint journals: what a re-drain would replay free
    ckpts = sorted(n for n in os.listdir(queue_dir)
                   if n.startswith("ckpt-")
                   and os.path.isdir(os.path.join(queue_dir, n)))
    econ = []
    for n in ckpts:
        jpath = os.path.join(queue_dir, n, "measurements.jsonl")
        meas = batches = 0
        if os.path.exists(jpath):
            with open(jpath) as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        j = json.loads(line)
                    except ValueError:
                        continue  # torn tail line
                    if "batch" in j:
                        batches += 1
                    else:
                        meas += 1
        econ.append(f"`{n[5:17]}`: {meas} measurement(s), "
                    f"{batches} batch(es)")
    if econ:
        lines += ["", "- checkpoint journals: " + "; ".join(econ)]
    lines.append("")
    return lines


# -- live fleet view (--follow) ---------------------------------------------

def _age(doc: Dict[str, Any], key: str, now: float) -> str:
    try:
        return f"{now - float(doc.get(key, 0)):.1f}s"
    except (TypeError, ValueError):
        return "?"


def _slo_line(slo: Dict[str, Any]) -> str:
    pct99 = slo.get("pct99_us")
    bits = [f"{slo.get('histogram', '?')} pct99 "
            f"{'—' if pct99 is None else f'{pct99:.1f}us'}"]
    if slo.get("target_us") is not None:
        mark = ("OK" if slo.get("within_target")
                else "MISS" if slo.get("within_target") is False else "?")
        bits.append(f"target {slo['target_us']:.0f}us [{mark}]")
    if slo.get("baseline_pct99_us"):
        bits.append(f"burn {slo.get('burn', '?')} "
                    f"(x{slo.get('vs_baseline', '?')} vs baseline "
                    f"{slo['baseline_pct99_us']:.1f}us)")
    return ", ".join(bits)


def dr_lines(store_dir: str, now: float) -> List[str]:
    """The disaster-recovery posture of one store directory
    (serve/dr.py): the last ``serve fsck
    --stamp`` verdict and the backup-generation census — rendered so a
    follow screen answers "when did anyone last prove this store clean,
    and how far back could we restore?" without running either tool."""
    lines: List[str] = []
    stamps = [os.path.join(store_dir, dr.FSCK_STAMP)]
    stamps += sorted(_glob.glob(os.path.join(store_dir, "*.fsck.json")))
    for sp in stamps:
        try:
            with open(sp) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if doc.get("kind") != "fsck":
            continue
        lines.append(
            f"fsck   {doc.get('store', store_dir)}: "
            f"{'clean' if doc.get('ok') else 'DAMAGED'} (rc "
            f"{doc.get('rc', '?')}), {doc.get('records', 0)} record(s), "
            f"{len(doc.get('errors') or [])} error(s) / "
            f"{len(doc.get('warnings') or [])} warning(s), stamped "
            f"{_age(doc, 'checked_at', now)} ago")
    root = dr.backups_root(store_dir)
    try:
        gens = dr.list_generations(root)
    except OSError:
        gens = []
    if gens:
        latest = os.path.join(root, gens[-1])
        try:
            cat = dr.load_catalog(latest)
            detail = (f"{len(cat.get('files') or [])} file(s), "
                      f"{_age(cat, 'created_at', now)} ago")
        except dr.DrError as e:
            detail = f"catalog unreadable: {e}"
        lines.append(
            f"backup {store_dir}: {len(gens)} generation(s), latest "
            f"`{os.path.basename(latest)}` ({detail})")
    return lines


def fleet_lines(store_dirs: List[str],
                queue_dirs: List[str]) -> List[str]:
    """One render of the live fleet: serve-loop and daemon status documents joined
    with their latest metric snapshots — per-process liveness, queue
    depth/age, tier hit mix, SLO state.  Pure reads: follow never
    mutates the tree it watches."""
    now = time.time()
    lines = [f"# fleet @ {time.strftime('%H:%M:%S')}", ""]
    for d in store_dirs:
        if not os.path.isdir(d):
            continue
        snaps = latest_snapshots(d)
        for name in sorted(os.listdir(d)):
            if not (name.startswith("status-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(d, name)) as f:
                    st = json.load(f)
            except (OSError, ValueError):
                lines.append(f"serve  {name}: unreadable")
                continue
            if st.get("kind") != "serve_loop":
                continue
            c = st.get("counters", {})
            served = {t: c.get(f"served_{t}", 0)
                      for t in ("exact", "near", "cold")}
            total = sum(served.values()) or 1
            mix = "/".join(f"{t}:{n} ({100 * n // total}%)"
                           for t, n in served.items())
            ro = st.get("store_readonly")
            lines.append(
                f"serve  {st.get('owner', name)}: {st.get('state')}"
                + (" [STORE READONLY — exact only, near/cold shed]"
                   if ro else "")
                + f", hb {_age(st, 'heartbeat_at', now)} ago, queue "
                f"{st.get('queue_depth', 0)} (+{st.get('in_flight', 0)} "
                f"in flight), shed {c.get('shed', 0)}, timeouts "
                f"{c.get('timeouts', 0)}, mix {mix}")
            snap = snaps.get(st.get("owner", ""))
            if snap:
                gauges = (snap.get("metrics") or {}).get("gauges", {})
                tr = snap.get("tracer") or {}
                extras = [f"queue age {gauges.get('serve.queue_age_s', 0)}s",
                          f"shed rate {gauges.get('serve.shed_rate', 0)}/s"]
                if snap.get("uptime_s") is not None:
                    extras.append(f"up {snap['uptime_s']}s")
                if tr.get("dropped_spans") or tr.get("dropped_events"):
                    extras.append(
                        f"tracer dropped {tr.get('dropped_spans', 0)}sp/"
                        f"{tr.get('dropped_events', 0)}ev")
                lines.append(f"       {', '.join(extras)}")
                if snap.get("slo"):
                    lines.append(f"       slo: {_slo_line(snap['slo'])}")
                rl = snap.get("reqlog")
                if rl:
                    # the traffic recorder's own position (serve/
                    # reqlog.py): the watchtower is observable too
                    lines.append(
                        f"       reqlog: {rl.get('records', 0)} rec / "
                        f"{rl.get('segments', 0)} seg "
                        f"({rl.get('bytes', 0)}B, "
                        f"{rl.get('buffered', 0)} buffered, "
                        f"{rl.get('dropped_sampling', 0)} sampled out)")
        # disaster-recovery posture: last fsck verdict + backup census
        lines += dr_lines(d, now)
    for qd in queue_dirs:
        if not os.path.isdir(qd):
            lines.append(f"queue  {qd}: missing directory")
            continue
        q = WorkQueue(qd)
        items = q.items()
        ages = []
        for p, _ in items:
            try:
                ages.append(now - os.path.getmtime(p))
            except OSError:
                pass
        leases = q.leases()
        lines.append(
            f"queue  {qd}: depth {len(items)}"
            + (f", oldest {max(ages):.1f}s" if ages else "")
            + (f", torn {len(q.torn_paths)}" if q.torn_paths else "")
            + f", leases {len(leases)}"
            + (f" (max hb age {max(l['age_s'] for l in leases):.1f}s)"
               if leases else "")
            + f", poisoned {len(q.poisoned())}")
        snaps = latest_snapshots(qd)
        for name in sorted(os.listdir(qd)):
            if not (name.startswith("status-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(qd, name)) as f:
                    st = json.load(f)
            except (OSError, ValueError):
                lines.append(f"daemon {name}: unreadable")
                continue
            if st.get("kind") == "serve_loop":
                continue  # a listen loop pointed at the queue dir
            if st.get("kind") == "supervisor":
                # the fleet controller (serve/supervisor.py): members,
                # scaling verdict, and any open crash-loop breakers
                sc = st.get("scaling") or {}
                lines.append(
                    f"superv {st.get('owner', name)}: "
                    f"{st.get('state')}, hb "
                    f"{_age(st, 'heartbeat_at', now)} ago, members "
                    f"{st.get('n_members', 0)} (desired "
                    f"{sc.get('desired', st.get('desired_n', '?'))})"
                    + (", scale-up suppressed (poison)"
                       if sc.get("suppressed_poison") else ""))
                for mb in st.get("members") or []:
                    lines.append(
                        f"       member {mb.get('owner')}: "
                        f"{mb.get('state')}"
                        + (" (adopted)" if mb.get("adopted") else "")
                        + (f", {mb.get('restarts')} restart(s)"
                           if mb.get("restarts") else ""))
                for owner, b in sorted(
                        (st.get("breakers") or {}).items()):
                    lines.append(
                        f"       breaker {owner}: {b.get('state')} "
                        f"({b.get('restarts_in_window')}/"
                        f"{b.get('max_restarts')} restarts in "
                        f"{b.get('window_s')}s)")
                continue
            c = st.get("counters", {})
            item = st.get("item") or {}
            lines.append(
                f"daemon {st.get('owner', name)}: {st.get('state')}"
                + (" [STORE READONLY — claims paused]"
                   if st.get("store_readonly") else "")
                + f", hb {_age(st, 'heartbeat_at', now)} ago, claimed "
                f"{c.get('claimed', 0)}, completed {c.get('completed', 0)}"
                f", retried {c.get('retried', 0)}, poisoned "
                f"{c.get('poisoned', 0)}"
                + (f", draining {str(item.get('exact', ''))[:12]} "
                   f"({now - float(item.get('since', now)):.0f}s)"
                   if item else ""))
            snap = snaps.get(st.get("owner", ""))
            if snap:
                gauges = (snap.get("metrics") or {}).get("gauges", {})
                lines.append(
                    f"       item age "
                    f"{gauges.get('daemon.item_age_s', 0)}s, lease age "
                    f"{gauges.get('daemon.lease_age_s', 0)}s")
    # arrival-vs-drain backlog economics (obs/alerts.py): the always-on
    # fleet-sizing line the queue_backlog_burn rule fires from
    bl = backlog_summary(store_dirs, queue_dirs)
    if bl.get("depth") or bl.get("arrival_per_s"):
        lines.append(
            f"burn   arrival {bl['arrival_per_s']:.2f}/s vs drain "
            f"{bl['drain_per_s']:.2f}/s ({bl['daemons']} daemon(s)), "
            f"depth {bl['depth']}, recommended fleet "
            f"{bl['recommended_daemons']}")
    # worst recent exemplar through the causal analyzer: one line of
    # where the tail's time went, refreshed every tick (obs/causal.py)
    for d in store_dirs:
        ex_dir = os.path.join(d, "reqlog", "exemplars")
        if not os.path.isdir(ex_dir):
            continue
        try:
            exemplars = read_exemplars(ex_dir)[:4]
            paths = [ex["path"] for ex in exemplars if ex.get("path")]
            traces = analyze_bundles(paths) if paths else {}
        except (OSError, ValueError):
            continue
        good = [t for t in traces.values() if t.get("segments_us")]
        if good:
            worst = max(good, key=lambda t: t["window_us"])
            top = sorted(worst["segments_us"].items(),
                         key=lambda kv: -kv[1])[:3]
            lines.append(
                f"causal {worst['trace_id'][:16]}: "
                f"{worst['window_us']:.0f}us window, "
                + ", ".join(f"{k} {v:.0f}us" for k, v in top)
                + f", coverage {worst['coverage']:.0%}")

    lines += firing_lines(store_dirs, queue_dirs)
    for d in dict.fromkeys(store_dirs + queue_dirs):
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if not (name.startswith("alerts-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(d, name)) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            firing = doc.get("firing", [])
            lines.append(
                f"ledger {name}: {len(firing)} firing, updated "
                f"{_age(doc, 'updated_at', now)} ago"
                + (f" ({', '.join(firing[:4])}"
                   + (", ..." if len(firing) > 4 else "") + ")"
                   if firing else ""))
    if len(lines) <= 2:
        lines.append("(no status documents found)")
    lines.append("")
    return lines


def causal_section(bundle_paths: List[str]) -> List[str]:
    """The causal-analysis section (obs/causal.py): per-trace critical-path
    chains over telemetry bundles plus the fleet-wide "where the pct99
    lives" rollup."""
    traces = analyze_bundles(bundle_paths)
    lines = ["## Causal analysis", "",
             f"- bundles: {len(bundle_paths)}, traces: {len(traces)}"]
    good = sorted((t for t in traces.values() if "error" not in t),
                  key=lambda t: -t["window_us"])
    if good:
        lines += ["", "| trace | tier | window (us) | queue wait (us) | "
                  "coverage | chain |", "|---|---|---|---|---|---|"]
        for t in good[:12]:
            chain = " > ".join(
                c["segment"] for c in t["chain"]
                if c["segment"] != "unattributed")
            lines.append(
                f"| `{t['trace_id'][:16]}` | {t['tier']} | "
                f"{t['window_us']:.0f} | {t['queue_wait_us']:.0f} | "
                f"{t['coverage']:.0%} | {chain} |")
        agg = aggregate(traces)
        rank = agg.get("pct99_ranking") or []
        if rank:
            lines += ["", "where the pct99 lives (tail traces, "
                      f"window >= {agg['pct99_window_us']:.0f}us):"]
            for r in rank[:6]:
                lines.append(f"- {r['segment']}: {r['sum_us']:.0f}us "
                             f"({r['share']:.0%})")
        dec = agg.get("decomposition") or {}
        if dec:
            qw, sv = dec["queue_wait_us"], dec["service_us"]
            lines.append(
                f"- queue wait vs service p99: {qw['p99_us']:.0f}us vs "
                f"{sv['p99_us']:.0f}us")
    lines.append("")
    return lines


def follow(store_dirs: List[str], queue_dirs: List[str],
           interval: float = 2.0, max_ticks: Optional[int] = None,
           out=None) -> int:
    """Render :func:`fleet_lines` every ``interval`` seconds until
    Ctrl-C (or ``max_ticks`` renders — the CI/test bound)."""
    out = out if out is not None else sys.stdout
    ticks = 0
    try:
        while True:
            out.write("\n".join(fleet_lines(store_dirs, queue_dirs)) + "\n")
            out.flush()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


# -- CLI --------------------------------------------------------------------

def _expand(globs: Optional[List[str]]) -> List[str]:
    out: List[str] = []
    for pat in globs or []:
        hits = sorted(_glob.glob(pat))
        out.extend(hits if hits else ([pat] if os.path.exists(pat) else []))
    return out


def build_report(args) -> Tuple[str, Optional[Dict[str, Any]]]:
    lines: List[str] = ["# tenzing-tpu corpus report", ""]
    verdict: Optional[Dict[str, Any]] = None
    csvs = _expand(args.csv)
    if csvs:
        lines += corpus_section(csvs)
    benches = _expand(args.bench)
    if benches:
        lines += bench_section(benches)
    if args.journal:
        lines += journal_section(args.journal)
    traces = _expand(args.trace)
    if traces:
        lines += trace_section(traces)
    metrics = _expand(args.metrics)
    if metrics:
        lines += metrics_section(metrics)
    stores = _expand(args.store)
    if stores or args.queue_dir:
        lines += store_section(stores, queue_dir=args.queue_dir)
    causal_globs = _expand(getattr(args, "causal", None))
    if causal_globs:
        lines += causal_section(causal_globs)
    if args.check:
        fresh = _load_check_doc(args.check)
        baseline = _load_check_doc(args.baseline)
        f_serve = fresh.get("kind") == "serve_trace_replay"
        b_serve = baseline.get("kind") == "serve_trace_replay"
        if f_serve != b_serve:
            # a mixed pair means a mis-wired gate (e.g. a BENCH baseline
            # against a replay fresh): every extraction would come
            # back None and the check would vacuously pass — fail the
            # wiring loudly instead (exit 2, usage error)
            raise ValueError(
                f"regression-check family mismatch: {args.check} is "
                f"{'serve-replay' if f_serve else 'driver'}-family but "
                f"{args.baseline} is "
                f"{'serve-replay' if b_serve else 'driver'}-family")
        if f_serve:
            # the replay family gates on serving latency, not
            # search quality — same CLI, same exit-code contract
            verdict = check_serve_regression(fresh, baseline, tol=args.tol)
        else:
            verdict = check_regression(fresh, baseline, tol=args.tol)
        lines += ["## Regression check", "",
                  f"- fresh: `{args.check}`",
                  f"- baseline: `{args.baseline}` (tol {args.tol:.0%})",
                  f"- **verdict: {verdict['verdict']}**"]
        for r in verdict["reasons"]:
            lines.append(f"  - {r}")
        fvt = verdict["checks"].get("host_noise")
        if isinstance(fvt, dict) and fvt.get("line"):
            # the measured floor-vs-tail read (obs/noise.py): is the
            # residual tail the host's fault or the serving path's?
            lines.append(f"- {fvt['line']}")
        lines += ["", "```json",
                  json.dumps(verdict["checks"], indent=2, sort_keys=True),
                  "```", ""]
    if len(lines) <= 2:
        lines += ["(no inputs given — see --help)", ""]
    return "\n".join(lines), verdict


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tenzing_tpu_torch.obs.report",
        description="Mine the measurement corpus into a markdown report "
                    "and run the noise-aware regression check.")
    ap.add_argument("--csv", nargs="*", default=None, metavar="GLOB",
                    help="recorded search databases (the driver's --dump-csv)")
    ap.add_argument("--bench", nargs="*", default=None, metavar="GLOB",
                    help="driver JSON verdicts (raw lines or BENCH_*.json "
                         "wrappers)")
    ap.add_argument("--journal", nargs="*", default=None, metavar="DIR",
                    help="checkpoint directories (the driver's --checkpoint)")
    ap.add_argument("--trace", nargs="*", default=None, metavar="GLOB",
                    help="telemetry JSONL bundles (the driver's --trace-out)")
    ap.add_argument("--metrics", nargs="*", default=None, metavar="GLOB",
                    help="metrics JSON files (the driver's --metrics-json)")
    ap.add_argument("--store", nargs="*", default=None, metavar="PATH",
                    help="schedule-serving store files or segmented "
                         "directories (python -m tenzing_tpu_torch.serve)")
    ap.add_argument("--queue-dir", default=None, metavar="DIR",
                    help="serving work-queue directory (cold/refinement "
                         "depth by reason)")
    ap.add_argument("--causal", nargs="*", default=None, metavar="GLOB",
                    help="telemetry bundles for the per-request "
                         "critical-path section (obs/causal.py)")
    ap.add_argument("--check", default=None, metavar="FRESH",
                    help="fresh driver JSON for the regression check")
    ap.add_argument("--baseline", default=None, metavar="BASE",
                    help="baseline driver JSON or replay document")
    ap.add_argument("--tol", type=float, default=0.05,
                    help="relative regression tolerance (default 0.05)")
    ap.add_argument("--out", default=None,
                    help="write the markdown report here (default stdout)")
    ap.add_argument("--follow", action="store_true",
                    help="live fleet view: tail status + metric-snapshot "
                         "documents under --store / --queue-dir")
    ap.add_argument("--interval", type=float, default=2.0, metavar="SECS",
                    help="--follow refresh interval")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="--follow: stop after N renders (CI/tests)")
    args = ap.parse_args(argv)
    if bool(args.check) != bool(args.baseline):
        ap.error("--check and --baseline must be given together")
    if args.follow:
        store_dirs = []
        for p in args.store or []:
            if os.path.isdir(p):
                store_dirs.append(p)
            elif p.endswith(".json"):
                # a monolithic store: its status docs live beside it
                store_dirs.append(os.path.dirname(os.path.abspath(p)))
        if not store_dirs and not args.queue_dir:
            ap.error("--follow needs --store and/or --queue-dir")
        return follow(store_dirs,
                      [args.queue_dir] if args.queue_dir else [],
                      interval=args.interval, max_ticks=args.max_ticks)
    try:
        report, verdict = build_report(args)
    except (OSError, ValueError) as e:
        sys.stderr.write(f"report: {e}\n")
        return 2
    if args.out:
        with open(args.out, "w") as f:
            f.write(report)
        sys.stderr.write(f"report: {args.out}\n")
    else:
        sys.stdout.write(report)
    return 1 if (verdict and verdict["verdict"] == "regression") else 0


if __name__ == "__main__":
    sys.exit(main())
