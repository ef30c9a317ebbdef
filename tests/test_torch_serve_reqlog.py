"""The port's request log and exemplars (tenzing_tpu_torch/serve/reqlog.py)
against the JAX package's (tenzing_tpu/serve/reqlog.py; reference tests
test_serve_reqlog.py), test for test: sampling decided by the trace_id,
sealed segments published off the request path, reads that salvage damage,
rotation under a retention cap, the position block, and the exemplar store
(the slowest K a window, shed and timed-out requests at once, bounded files,
bundles the reference's stitcher reads).  Then across the packages: the
same sampling verdicts, and a log and exemplars written by either read in
the other with the same records.
"""

import json
import os

import pytest

from tenzing_tpu.serve import reqlog as ref_reqlog
from tenzing_tpu_torch.serve.reqlog import (
    ExemplarStore,
    RequestLog,
    read_exemplars,
    read_request_log,
    record_digest,
    sampled_in,
)


def _rec(i, tier="exact", outcome="served", trace=None, ts=None):
    return {"v": 1, "ts": 1000.0 + i * 0.01 if ts is None else ts,
            "trace_id": trace or f"{i:016x}", "tenant": "t", "op": "query",
            "outcome": outcome, "tier": tier, "workload": "spmv",
            "exact": "e" * 12, "bucket": "b" * 12,
            "resolve_us": 100.0 + i,
            "request": {"workload": "spmv", "m": 512 + i}}


# -- the request log ---------------------------------------------------------------

def test_append_publish_read_roundtrip(tmp_path):
    d = str(tmp_path / "rl")
    rl = RequestLog(d, owner="t1", segment_records=4)
    for i in range(10):
        assert rl.append(_rec(i)) is True
    rl.flush()
    pos = rl.position()
    assert pos["records"] == 10 and pos["buffered"] == 0
    assert pos["segments"] == 3  # 4 + 4 + the flush's 2
    data = read_request_log(d)
    assert len(data["records"]) == 10 and data["segments"] == 3
    assert data["damaged"] == 0 and data["checksum_failed"] == 0
    ts = [r["ts"] for r in data["records"]]
    assert ts == sorted(ts)
    assert data["records"][3]["request"] == {"workload": "spmv", "m": 515}


def test_full_buffer_rotates_without_request_path_io(tmp_path):
    """A full buffer becomes a pending batch with no I/O on the appending
    thread; ``publish_pending`` pays the fsyncs, unless the backlog passes
    its cap and the publish happens inline."""
    d = str(tmp_path / "rl")
    rl = RequestLog(d, owner="t1", segment_records=2, pending_batch_cap=2)
    for i in range(4):
        rl.append(_rec(i))
    assert not os.path.exists(d)  # two batches pending, no file
    assert rl.position()["buffered"] == 4
    assert rl.publish_pending() == 2
    assert rl.position()["buffered"] == 0
    assert len(read_request_log(d)["records"]) == 4
    for i in range(6):  # the third rotation passes cap=2: inline
        rl.append(_rec(10 + i))
    assert rl.position()["segments"] >= 5
    assert rl.position()["buffered"] == 0


def test_sampling_deterministic_and_counted(tmp_path):
    traces = [f"{i:016x}" for i in range(200)]
    kept = {t for t in traces if sampled_in(t, 0.5)}
    assert kept == {t for t in traces if sampled_in(t, 0.5)}
    assert 60 <= len(kept) <= 140
    assert all(sampled_in(t, 1.0) for t in traces)
    assert not any(sampled_in(t, 0.0) for t in traces)
    d = str(tmp_path / "rl")
    rl = RequestLog(d, owner="t1", sample=0.5, segment_records=1000)
    n_in = sum(1 for i, t in enumerate(traces)
               if rl.append(_rec(i, trace=t)))
    assert n_in == len(kept)
    assert rl.position()["dropped_sampling"] == len(traces) - len(kept)
    rl.flush()
    data = read_request_log(d)
    # the coverage survives the writer: the header's cumulative count
    assert data["dropped_sampling"] == len(traces) - len(kept)
    assert len(data["records"]) == len(kept)


def test_dropped_sampling_sums_across_writers(tmp_path):
    """Two loops recording into one directory: the drop count is the most
    within a writer, summed across writers."""
    d = str(tmp_path / "rl")
    for owner, n_drop in (("w1", 3), ("w2", 5)):
        rl = RequestLog(d, owner=owner, sample=0.0)
        for i in range(n_drop):
            assert rl.append(_rec(i)) is False
        rl.sample = 1.0
        rl.append(_rec(99, trace=owner * 8))
        rl.flush()
    data = read_request_log(d)
    assert data["dropped_sampling"] == 8
    assert len(data["records"]) == 2


def test_unserializable_record_coerced_not_fatal(tmp_path):
    """A value JSON cannot hold in the kwargs is coerced (``default=str``)
    and never costs the segment's publish."""
    d = str(tmp_path / "rl")
    rl = RequestLog(d, owner="t1", segment_records=100)
    rec = _rec(0)
    rec["request"]["blob"] = b"\x00raw"
    assert rl.append(rec) is True
    rl.append(_rec(1))
    rl.flush()
    data = read_request_log(d)
    assert len(data["records"]) == 2 and data["damaged"] == 0
    assert isinstance(data["records"][0]["request"]["blob"], str)


def test_rotation_retention_cap(tmp_path):
    d = str(tmp_path / "rl")
    rl = RequestLog(d, owner="t1", segment_records=1, retain_segments=3)
    for i in range(6):
        rl.append(_rec(i))
    rl.flush()
    assert len([n for n in os.listdir(d) if n.endswith(".jsonl")]) == 3
    assert rl.position()["segments_reclaimed"] == 3
    assert [r["request"]["m"] for r in read_request_log(d)["records"]] == \
        [515, 516, 517]


def test_salvage_on_damage(tmp_path):
    d = str(tmp_path / "rl")
    rl = RequestLog(d, owner="t1", segment_records=2)
    for i in range(6):
        rl.append(_rec(i))
    rl.flush()
    names = sorted(n for n in os.listdir(d) if n.endswith(".jsonl"))
    assert len(names) == 3
    p0 = os.path.join(d, names[0])  # a stale checksum
    lines = open(p0).read().splitlines()
    bad = json.loads(lines[1])
    bad["record"]["resolve_us"] = 999999.0
    lines[1] = json.dumps(bad, sort_keys=True)
    open(p0, "w").write("\n".join(lines) + "\n")
    open(os.path.join(d, names[1]), "a").write('{"sha256": "zz", "reco')
    p2 = os.path.join(d, names[2])  # truncated below the header's count
    lines2 = open(p2).read().splitlines()
    open(p2, "w").write("\n".join(lines2[:-1]) + "\n")
    data = read_request_log(d)
    assert data["checksum_failed"] == 1 and data["torn_lines"] == 1
    assert data["damaged"] == 3
    assert len(data["records"]) == 4  # 6 - 1 flipped - 1 truncated
    assert sorted(n for n in os.listdir(d) if n.endswith(".jsonl")) == names


def test_newer_version_skipped_loudly(tmp_path):
    d = str(tmp_path / "rl")
    os.makedirs(d)
    header = {"kind": "reqlog_segment", "version": 99, "n_records": 1}
    rec = _rec(0)
    body = json.dumps(header) + "\n" + json.dumps(
        {"sha256": record_digest(rec), "record": rec}) + "\n"
    open(os.path.join(d, "req-1-x-1.jsonl"), "w").write(body)
    notes = []
    data = read_request_log(d, log=notes.append)
    assert data["newer_skipped"] == 1 and data["records"] == []
    assert any("newer version" in n for n in notes)


def test_reader_missing_dir_raises(tmp_path):
    with pytest.raises(OSError):
        read_request_log(str(tmp_path / "nope"))


# -- exemplars -----------------------------------------------------------------------

def test_interesting_outcomes_written_immediately(tmp_path):
    d = str(tmp_path / "ex")
    ex = ExemplarStore(d, k=2)
    p = ex.offer(_rec(0, outcome="shed", trace="aa" * 8), interesting="shed")
    assert p is not None and os.path.exists(p)
    ex.offer(_rec(1, outcome="timeout", trace="bb" * 8),
             interesting="timeout")
    headers = read_exemplars(d)
    assert {h["reason"] for h in headers} == {"shed", "timeout"}
    assert headers[0]["record"]["request"]["workload"] == "spmv"
    assert ex.written == 2


def test_slowest_k_per_window(tmp_path):
    d = str(tmp_path / "ex")
    ex = ExemplarStore(d, k=2)
    for i, us in enumerate([50, 900, 120, 80, 700, 60]):
        rec = _rec(i, trace=f"{i:02d}" * 8)
        rec["resolve_us"] = float(us)
        assert ex.offer(rec) is None  # candidates wait for the roll
    assert read_exemplars(d) == []
    assert len(ex.roll()) == 2
    headers = read_exemplars(d)
    assert all(h["reason"] == "slow" for h in headers)
    assert sorted(h["record"]["resolve_us"] for h in headers) == [700, 900]
    assert ex.roll() == []  # the window closed


def test_exemplars_sharing_a_trace_do_not_overwrite(tmp_path):
    d = str(tmp_path / "ex")
    ex = ExemplarStore(d, cap=8)
    paths = [ex.offer(_rec(i, trace="ab" * 8), interesting="shed")
             for i in range(3)]
    assert len(set(paths)) == 3
    assert len(read_exemplars(d)) == 3 and ex.written == 3


def test_exemplar_immediate_budget_bounds_a_shed_storm(tmp_path):
    d = str(tmp_path / "ex")
    ex = ExemplarStore(d, k=1, cap=64, immediate_per_window=3)
    written = [ex.offer(_rec(i, trace=f"{i:02d}" * 8), interesting="shed")
               for i in range(10)]
    assert sum(1 for p in written if p) == 3
    assert ex.suppressed == 7
    assert len(read_exemplars(d)) == 3
    ex.roll()  # the budget refills
    assert ex.offer(_rec(11, trace="ee" * 8),
                    interesting="timeout") is not None


def test_exemplar_cap_eviction(tmp_path):
    d = str(tmp_path / "ex")
    ex = ExemplarStore(d, k=1, cap=3)
    for i in range(5):
        p = ex.offer(_rec(i, trace=f"{i:02d}" * 8), interesting="error")
        os.utime(p, (1000 + i, 1000 + i))
    files = [n for n in os.listdir(d) if n.startswith("exemplar-")]
    assert len(files) == 3
    assert any("0404" in n for n in files)
    assert not any("0000" in n for n in files)


def test_exemplar_bundle_carries_trace_spans_and_stitches(tmp_path):
    """A bundle holds its header and only its trace's spans; the port's
    stitcher and the reference's read the port's bundle, find the trace
    and return the same document and summary."""
    from tenzing_tpu.obs.export import stitch_records as ref_stitch_records
    from tenzing_tpu_torch.obs import context as obs_context
    from tenzing_tpu_torch.obs.export import read_jsonl, stitch_records
    from tenzing_tpu_torch.obs.tracer import Tracer

    tracer = Tracer(enabled=True)
    ctx = obs_context.new_trace()
    with obs_context.use(ctx):
        with tracer.span("serve.query", tier="exact"):
            pass
    with tracer.span("unrelated.span"):
        pass
    d = str(tmp_path / "ex")
    ex = ExemplarStore(d, tracer=tracer)
    path = ex.offer(_rec(0, trace=ctx.trace_id), interesting="timeout")
    recs = read_jsonl(path)
    assert recs[0]["kind"] == "exemplar"
    assert recs[0]["trace_id"] == ctx.trace_id
    assert [s["name"] for s in recs[1:] if s.get("kind") == "span"] == \
        ["serve.query"]
    assert read_exemplars(d)[0]["n_trace_records"] == 1
    doc, summary = stitch_records([("exemplar", recs)])
    assert "serve.query" in summary["traces"][ctx.trace_id]["names"]
    assert (doc, summary) == ref_stitch_records([("exemplar", recs)])


# -- across the packages -------------------------------------------------------------

def test_sampling_verdicts_are_the_references():
    traces = [f"{i:016x}" for i in range(300)] + ["", "x", "ab" * 20]
    for rate in (0.0, 0.1, 0.5, 0.97, 1.0):
        assert [sampled_in(t, rate) for t in traces] == \
            [ref_reqlog.sampled_in(t, rate) for t in traces]
    rec = _rec(3)
    assert record_digest(rec) == ref_reqlog.record_digest(rec)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_log_either_wrote_reads_in_the_other(tmp_path, writer):
    """One log, two writers' segments and some damage: both readers return
    the same document, and a segment's record lines are the reference's."""
    mod = {"port": RequestLog, "ref": ref_reqlog.RequestLog}[writer]
    d = str(tmp_path / "rl")
    rl = mod(d, owner=f"{writer}-1", sample=0.5, segment_records=3)
    for i in range(20):
        rl.append(_rec(i))
    rl.flush()
    other = (ref_reqlog.RequestLog if writer == "port" else RequestLog)(
        d, owner="other", segment_records=50)
    other.append(_rec(50))
    other.flush()
    names = sorted(n for n in os.listdir(d) if n.endswith(".jsonl"))
    with open(os.path.join(d, names[0]), "a") as f:
        f.write('{"sha256": "zz", "reco')
    port, ref = read_request_log(d), ref_reqlog.read_request_log(d)
    assert port == ref
    assert port["torn_lines"] == 1 and port["dropped_sampling"] > 0
    body = open(os.path.join(d, names[1])).read().splitlines()[1:]
    recs = [json.loads(line)["record"] for line in body]
    assert body == [json.dumps({"sha256": ref_reqlog.record_digest(r),
                                "record": r}, sort_keys=True)
                    for r in recs]


def test_exemplars_either_wrote_read_in_the_other(tmp_path):
    d = str(tmp_path / "ex")
    ExemplarStore(d, k=1).offer(_rec(0, trace="aa" * 8), interesting="shed")
    ref_reqlog.ExemplarStore(d, k=1).offer(_rec(1, trace="bb" * 8),
                                           interesting="error")

    def strip(hs):
        return sorted((h["reason"], h["trace_id"], json.dumps(h["record"]),
                       h["n_trace_records"], os.path.basename(h["path"]))
                      for h in hs)

    assert strip(read_exemplars(d)) == strip(ref_reqlog.read_exemplars(d))
    assert len(read_exemplars(d)) == 2
