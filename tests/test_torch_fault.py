"""The port's fault layer (tenzing_tpu_torch.fault) against the reference's
units (tests/test_fault.py) and, where both packages draw, against the
reference itself: the injection grammar, the hash draws, corrupt_schedule's
pick on the same serdes schedules, the backoff delays, and the
classification of the new error types.

The port's watchdog differs on purpose: an attempt it abandons is cancelled
and drained before the next one starts (fault/cancel.py), and an attempt
that never returns is a device loss; those cases are in
tests/test_torch_chaos_search.py."""

import json
import os
import random
import time

import pytest

from tenzing_tpu.fault import backoff as ref_backoff
from tenzing_tpu.fault import errors as ref_errors
from tenzing_tpu.fault import inject as ref_inject
from tenzing_tpu_torch.bench.benchmarker import (
    BenchOpts,
    BenchResult,
    CachingBenchmarker,
    schedule_id,
)
from tenzing_tpu_torch.fault import (
    BackoffPolicy,
    DeterministicScheduleError,
    DeviceLostError,
    FaultClass,
    FaultInjectingBenchmarker,
    InjectSpec,
    InjectedDeterministicError,
    InjectedTransientError,
    MeasurementTimeout,
    Quarantine,
    QuarantinedScheduleError,
    ResilientBenchmarker,
    TransientError,
    UnsoundScheduleError,
    cancel,
    classify_error,
    fault_code,
    parse_inject_specs,
    retry_call,
)
from tenzing_tpu_torch.fault import inject as port_inject
from tenzing_tpu_torch.fault.inject import _schedule_fails
from tenzing_tpu_torch.obs.metrics import MetricsRegistry, set_metrics
from tenzing_tpu_torch.obs.tracer import Tracer, set_tracer
from tenzing_tpu_torch.parallel.control_plane import ControlPlane


@pytest.fixture
def tracer():
    tr = Tracer(enabled=True)
    prev = set_tracer(tr)
    try:
        yield tr
    finally:
        set_tracer(prev)


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = set_metrics(reg)
    try:
        yield reg
    finally:
        set_metrics(prev)


def _ok(t=1.0):
    return BenchResult.from_times([t, t, t])


class ScriptedBench:
    """Pops one scripted behavior per call: an exception to raise, a float
    to stall for (on the attempt's cancel token) and then succeed, or None
    to succeed."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def benchmark(self, order, opts=None):
        self.calls += 1
        step = self.script.pop(0) if self.script else None
        if isinstance(step, BaseException):
            raise step
        if isinstance(step, float):
            cancel.wait(step)
        return _ok()


# -- taxonomy -------------------------------------------------------------------

@pytest.mark.parametrize("exc,want", [
    (InjectedTransientError("x"), FaultClass.TRANSIENT),
    (MeasurementTimeout("x"), FaultClass.TRANSIENT),
    (TransientError("x"), FaultClass.TRANSIENT),
    (DeviceLostError("x"), FaultClass.DEVICE_LOST),
    (InjectedDeterministicError("x"), FaultClass.DETERMINISTIC),
    (QuarantinedScheduleError("x"), FaultClass.DETERMINISTIC),
    (UnsoundScheduleError("x"), FaultClass.DETERMINISTIC),
    (TimeoutError("anything"), FaultClass.TRANSIENT),
    (ConnectionResetError("peer"), FaultClass.TRANSIENT),
    (RuntimeError("connection reset by peer"), FaultClass.TRANSIENT),
    (RuntimeError("UNAVAILABLE: tunnel hiccup"), FaultClass.TRANSIENT),
    (RuntimeError("DEADLINE_EXCEEDED while fetching"), FaultClass.TRANSIENT),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     FaultClass.DETERMINISTIC),
    (ValueError("operand shape mismatch"), FaultClass.DETERMINISTIC),
    (RuntimeError("device lost: chip rebooted"), FaultClass.DEVICE_LOST),
    (RuntimeError("CUDA error: device-side assert triggered"),
     FaultClass.DEVICE_LOST),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     FaultClass.DEVICE_LOST),
    (RuntimeError("CUDA error: operation not permitted when stream is "
                  "capturing"), FaultClass.DETERMINISTIC),
    # any other CUDA runtime or library error ends the process
    (RuntimeError("CUDA error: invalid argument"), FaultClass.DEVICE_LOST),
    (RuntimeError("CUDA error: out of memory"), FaultClass.DEVICE_LOST),
    (RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasSgemm"),
     FaultClass.DEVICE_LOST),
    (RuntimeError("mysterious"), FaultClass.DETERMINISTIC),
])
def test_classification(exc, want):
    assert classify_error(exc) == want


def _wrapped(cause: BaseException) -> BaseException:
    """``cause`` as the executor's capture wraps an op's error."""
    from tenzing_tpu_torch.runtime.executor import CaptureError

    try:
        try:
            raise cause
        except Exception as e:
            raise CaptureError(f"cannot capture op 'attn' (position 3): "
                               f"{type(e).__name__}: {e}") from e
    except CaptureError as e:
        return e


@pytest.mark.parametrize("cause,want", [
    (RuntimeError("CUDA error: invalid argument"), FaultClass.DEVICE_LOST),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     FaultClass.DEVICE_LOST),
    (RuntimeError("CUDA error: operation not permitted when stream is "
                  "capturing"), FaultClass.DETERMINISTIC),
    (ValueError("operand shape mismatch"), FaultClass.DETERMINISTIC),
])
def test_classification_reads_the_chain_of_causes(cause, want):
    """A CUDA error that the capture wraps is still a loss: the wrapper's
    type (deterministic) does not hide it."""
    assert classify_error(_wrapped(cause)) == want


@pytest.mark.parametrize("name", ["MeasurementTimeout",
                                  "QuarantinedScheduleError",
                                  "UnsoundScheduleError"])
def test_new_error_types_classify_as_the_reference(name):
    """The three types this layer adds sit in the reference's hierarchy and
    classify as the reference's do."""
    port_t = getattr(__import__("tenzing_tpu_torch.fault.errors",
                                fromlist=[name]), name)
    ref_t = getattr(ref_errors, name)
    assert [c.__name__ for c in port_t.__mro__] == [
        c.__name__ for c in ref_t.__mro__]
    assert classify_error(port_t("x")) == ref_errors.classify_error(ref_t("x"))


def test_fault_codes_are_severity_ordered():
    assert (fault_code(TransientError("x"))
            < fault_code(ValueError("shape"))
            < fault_code(DeviceLostError("x")))
    assert FaultClass.FROM_CODE[FaultClass.CODES[FaultClass.TRANSIENT]] == \
        FaultClass.TRANSIENT
    assert FaultClass.CODES == ref_errors.FaultClass.CODES


# -- backoff ----------------------------------------------------------------------

def test_backoff_policy_growth_and_cap():
    p = BackoffPolicy(base_secs=1.0, factor=2.0, max_secs=5.0, jitter=0.0)
    assert [p.delay(k) for k in range(4)] == [1.0, 2.0, 4.0, 5.0]


def test_backoff_jitter_bounds():
    p = BackoffPolicy(base_secs=1.0, factor=1.0, jitter=0.5)
    rng = random.Random(0)
    ds = [p.delay(0, rng) for _ in range(100)]
    assert all(0.5 <= d <= 1.5 for d in ds)
    assert len(set(ds)) > 1


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_backoff_delays_match_the_reference(seed):
    kw = dict(retries=6, base_secs=0.3, factor=1.7, max_secs=4.0, jitter=0.4)
    port_p, ref_p = BackoffPolicy(**kw), ref_backoff.BackoffPolicy(**kw)
    port_rng, ref_rng = random.Random(seed), random.Random(seed)
    assert [port_p.delay(k, port_rng) for k in range(8)] == [
        ref_p.delay(k, ref_rng) for k in range(8)]


def test_retry_call_retries_transient_then_succeeds(tracer, registry):
    sleeps = []
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientError("flaky")
        return "ok"

    out = retry_call(fn, policy=BackoffPolicy(retries=3, base_secs=0.25,
                                              factor=2.0, jitter=0.0),
                     where="test", sleep=sleeps.append)
    assert out == "ok" and calls["n"] == 3
    assert sleeps == [0.25, 0.5]
    retries = [e for e in tracer.events() if e.name == "fault.retry"]
    assert len(retries) == 2
    assert retries[0].attrs["where"] == "test"
    assert retries[0].attrs["error_class"] == FaultClass.TRANSIENT
    assert retries[0].attrs["attempt"] == 1
    assert registry.counter("fault.retries").value == 2


def test_retry_call_does_not_retry_deterministic(registry):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        retry_call(fn, sleep=lambda s: None)
    assert calls["n"] == 1
    assert registry.counter("fault.retries").value == 0


def test_retry_call_exhausts_and_reraises():
    with pytest.raises(TransientError):
        retry_call(lambda: (_ for _ in ()).throw(TransientError("always")),
                   policy=BackoffPolicy(retries=2, base_secs=0.0),
                   sleep=lambda s: None)


def test_retry_call_on_retry_hook_runs_before_sleep():
    seen = []
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] == 1:
            raise TransientError("once")
        return 1

    retry_call(fn, policy=BackoffPolicy(retries=1, base_secs=0.1, jitter=0.0),
               on_retry=lambda e, a, d: seen.append((type(e).__name__, a, d)),
               sleep=lambda s: seen.append(("slept", s)))
    assert seen == [("TransientError", 0, 0.1), ("slept", 0.1)]


# -- quarantine ---------------------------------------------------------------------

def test_quarantine_persists_across_instances(tmp_path, registry):
    path = str(tmp_path / "q.json")
    q = Quarantine(path)
    sid = q.add("sched-a", ValueError("bad shape"), FaultClass.DETERMINISTIC)
    assert q.check("sched-a")["error"] == "ValueError"
    assert q.check("sched-b") is None
    q2 = Quarantine(path)
    assert len(q2) == 1
    assert q2.check("sched-a")["error_class"] == FaultClass.DETERMINISTIC
    assert q2.key("sched-a") == sid
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []


def test_quarantine_add_is_idempotent(tmp_path, registry):
    q = Quarantine(str(tmp_path / "q.json"))
    q.add("s", ValueError("x"), FaultClass.DETERMINISTIC)
    q.add("s", ValueError("y"), FaultClass.DETERMINISTIC)
    assert len(q) == 1
    assert q.check("s")["message"] == "x"
    assert registry.counter("fault.quarantined").value == 1


@pytest.mark.parametrize("text", ["{ not json",
                                  json.dumps({"version": 99,
                                              "entries": {"x": {}}})])
def test_quarantine_unreadable_or_mismatched_file_is_empty_but_reported(
        tmp_path, text):
    path = tmp_path / "q.json"
    path.write_text(text)
    notes = []
    q = Quarantine(str(path), log=notes.append)
    assert len(q) == 0 and notes and "unreadable" in notes[0]


def test_quarantine_file_reads_in_the_reference(tmp_path):
    """The file format is the reference's: each package reads the other's."""
    from tenzing_tpu.fault.quarantine import Quarantine as RefQuarantine

    path = str(tmp_path / "q.json")
    Quarantine(path).add("port-side", ValueError("x"),
                         FaultClass.DETERMINISTIC)
    RefQuarantine(path).add("ref-side", ValueError("y"),
                            ref_errors.FaultClass.DETERMINISTIC)
    both = Quarantine(path)
    assert both.check("port-side") and both.check("ref-side")
    assert len(RefQuarantine(path)) == 2


# -- ResilientBenchmarker -------------------------------------------------------------

def _resilient(inner, **kw):
    kw.setdefault("policy", BackoffPolicy(retries=3, base_secs=0.0,
                                          jitter=0.0))
    kw.setdefault("sleep", lambda s: None)
    return ResilientBenchmarker(inner, **kw)


def test_resilient_retries_transient(tracer, registry):
    inner = ScriptedBench([TransientError("flake"), TransientError("flake")])
    rb = _resilient(inner)
    res = rb.benchmark("sched", BenchOpts())
    assert res.pct50 == 1.0 and inner.calls == 3
    errs = [e for e in tracer.events() if e.name == "fault.error"]
    assert len(errs) == 2
    assert all(e.attrs["error_class"] == FaultClass.TRANSIENT for e in errs)
    assert registry.counter(
        f"fault.errors.{FaultClass.TRANSIENT}").value == 2


def test_resilient_transient_exhaustion_reraises():
    inner = ScriptedBench([TransientError(f"flake {i}") for i in range(9)])
    rb = _resilient(inner, policy=BackoffPolicy(retries=2, base_secs=0.0))
    with pytest.raises(TransientError):
        rb.benchmark("sched")
    assert inner.calls == 3


def test_resilient_quarantines_deterministic(tmp_path, tracer, registry):
    qpath = str(tmp_path / "q.json")
    inner = ScriptedBench([ValueError("bad shape forever")])
    rb = _resilient(inner, quarantine=Quarantine(qpath))
    with pytest.raises(ValueError):
        rb.benchmark("sched-broken")
    assert inner.calls == 1
    with pytest.raises(QuarantinedScheduleError):
        rb.benchmark("sched-broken")
    assert inner.calls == 1
    rb2 = _resilient(ScriptedBench([]), quarantine=Quarantine(qpath))
    with pytest.raises(QuarantinedScheduleError):
        rb2.benchmark("sched-broken")
    assert registry.counter("fault.quarantine_hits").value == 2
    assert [e.name for e in tracer.events()
            if e.name.startswith("fault.quarantine")] == [
        "fault.quarantine", "fault.quarantine_hit", "fault.quarantine_hit"]


def test_resilient_watchdog_times_out_hang_and_retries(tracer):
    inner = ScriptedBench([30.0])  # the first attempt stalls until cancelled
    quiesced = []
    rb = _resilient(inner, timeout_secs=0.1,
                    quiesce=lambda: quiesced.append(1))
    t0 = time.monotonic()
    res = rb.benchmark("sched")
    assert res.pct50 == 1.0 and time.monotonic() - t0 < 5.0
    errs = [e for e in tracer.events() if e.name == "fault.error"]
    assert len(errs) == 1 and errs[0].attrs["error"] == "MeasurementTimeout"
    assert errs[0].attrs["error_class"] == FaultClass.TRANSIENT
    # the device was quiesced after the drain (and once more by the
    # classification of the timeout) before the retry
    assert len(quiesced) >= 1


def test_resilient_device_lost_without_fallback_is_fatal(registry):
    inner = ScriptedBench([DeviceLostError("gone")])
    rb = _resilient(inner)
    with pytest.raises(DeviceLostError):
        rb.benchmark("sched")
    assert inner.calls == 1
    assert registry.counter("fault.device_lost_fatal").value == 1


def test_failed_quiesce_turns_any_failure_into_a_device_loss():
    """After a failure that is not already a device loss the device is
    synchronized: a sticky error shows there, and the process never goes on
    as if the context were usable."""
    def broken():
        raise RuntimeError("CUDA error: unspecified launch failure")

    inner = ScriptedBench([ValueError("looks deterministic")])
    rb = _resilient(inner, quiesce=broken)
    with pytest.raises(DeviceLostError):
        rb.benchmark("sched")
    assert inner.calls == 1 and len(rb.quarantine) == 0


def test_resilient_degrades_to_fallback(tracer, registry):
    class Fallback:
        def __init__(self):
            self.calls = 0

        def benchmark(self, order, opts=None):
            self.calls += 1
            return _ok(9.0)

    inner = ScriptedBench([DeviceLostError("gone")])
    fb = Fallback()
    rb = _resilient(inner, fallback=fb)
    res = rb.benchmark("sched-a")
    assert res.pct50 == 9.0 and rb.degraded
    assert rb.was_degraded("sched-a") and not rb.was_degraded("sched-b")
    rb.benchmark("sched-b")
    assert rb.was_degraded("sched-b")
    assert inner.calls == 1 and fb.calls == 2
    assert registry.counter("fault.degraded").value == 1
    assert any(e.name == "fault.degraded" for e in tracer.events())


class TwoRankCP(ControlPlane):
    """A peer rank: ``agree_fault`` takes the maximum of the local code and
    a scripted peer code per call."""

    def __init__(self, peer_codes):
        self.peer_codes = list(peer_codes)
        self.seen = []

    def size(self):
        return 2

    def agree_fault(self, code):
        peer = self.peer_codes.pop(0) if self.peer_codes else 0
        self.seen.append(int(code))
        return max(int(code), peer)


def test_rank_agreement_peer_transient_forces_local_retry():
    inner = ScriptedBench([])
    cp = TwoRankCP(peer_codes=[0, FaultClass.CODES[FaultClass.TRANSIENT],
                               0, 0])
    rb = _resilient(inner, control_plane=cp)
    assert rb.benchmark("sched").pct50 == 1.0
    assert inner.calls == 2


def test_rank_agreement_peer_deterministic_quarantines_everywhere(tmp_path):
    inner = ScriptedBench([])
    cp = TwoRankCP(peer_codes=[0, FaultClass.CODES[FaultClass.DETERMINISTIC]])
    q = Quarantine(str(tmp_path / "q.json"))
    rb = _resilient(inner, control_plane=cp, quarantine=q)
    with pytest.raises(QuarantinedScheduleError):
        rb.benchmark("sched-peer-broken")
    assert q.check("sched-peer-broken") is not None


def test_resilient_is_rank_coherent_and_forwards_through_wrappers():
    from tenzing_tpu_torch.bench.pipeline import PrefetchingBenchmarker

    rb = _resilient(ScriptedBench([]))
    assert rb.rank_coherent
    assert CachingBenchmarker(rb).rank_coherent
    assert not CachingBenchmarker(ScriptedBench([])).rank_coherent

    class Exec:
        def precompile(self, order):
            return False

    with PrefetchingBenchmarker(rb, executor=Exec(), workers=1) as p:
        assert p.rank_coherent


class Batchy:
    """A batch benchmarker (the port's signature: no ``times_out``) whose
    first call fails with ``first``."""

    def __init__(self, first):
        self.first = first
        self.calls = 0

    def benchmark(self, order, opts=None):
        return _ok()

    def benchmark_batch_times(self, orders, opts=None, seed=0):
        self.calls += 1
        if self.calls == 1:
            if isinstance(self.first, float):
                cancel.wait(self.first)
            else:
                raise self.first
        return [[1.0], [2.0]]


@pytest.mark.parametrize("first,timeout", [
    (TransientError("mid-batch flake"), None),
    (30.0, 0.05),
])
def test_resilient_batch_retry_fills_caller_lists_from_completed_attempt(
        first, timeout):
    inner = Batchy(first)
    rb = _resilient(inner, timeout_secs=timeout)
    t0, t1 = [9.0], []  # stale content is replaced, not appended to
    times = rb.benchmark_batch_times(["a", "b"], None, seed=0,
                                     times_out=[t0, t1])
    assert inner.calls == 2
    assert t0 == [1.0] and t1 == [2.0] and times[0] is t0


def test_keyboard_interrupt_passes_straight_through():
    inner = ScriptedBench([KeyboardInterrupt()])
    rb = _resilient(inner)
    with pytest.raises(KeyboardInterrupt):
        rb.benchmark("sched")
    assert inner.calls == 1


# -- fault injection ----------------------------------------------------------------

@pytest.mark.parametrize("text", ["transient:0.25:7,hang:0.02:11",
                                  " corrupt:0.1:4 ,deterministic:1:0,",
                                  "device_lost:0:3"])
def test_parse_inject_specs_matches_the_reference(text):
    got = parse_inject_specs(text)
    want = ref_inject.parse_inject_specs(text)
    assert [(s.kind, s.rate, s.seed) for s in got] == [
        (s.kind, s.rate, s.seed) for s in want]


@pytest.mark.parametrize("bad", ["transient", "transient:0.5", "bogus:0.5:1",
                                 "transient:1.5:1", ""])
def test_parse_inject_specs_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        parse_inject_specs(bad)
    with pytest.raises(ValueError):
        ref_inject.parse_inject_specs(bad)


def test_hash_draws_match_the_reference():
    sids = [schedule_id(f"s{i}") for i in range(64)]
    for kind, rate, seed in (("transient", 0.3, 1), ("hang", 0.1, 2),
                             ("deterministic", 0.5, 3), ("corrupt", 0.2, 4)):
        port_spec = InjectSpec(kind, rate, seed)
        ref_spec = ref_inject.InjectSpec(kind, rate, seed)
        for sid in sids:
            assert port_inject._hash_draw(f"{sid}:{seed}") == \
                ref_inject._hash_draw(f"{sid}:{seed}")
            assert _schedule_fails(sid, port_spec) == \
                ref_inject._schedule_fails(sid, ref_spec)
            for attempt in range(3):
                assert port_inject._attempt_fires(sid, attempt, port_spec) == \
                    ref_inject._attempt_fires(sid, attempt, ref_spec)


def test_injection_is_seed_deterministic(registry):
    def run(seed):
        inj = FaultInjectingBenchmarker(
            ScriptedBench([]), [InjectSpec("transient", 0.5, seed)])
        pattern = []
        for i in range(40):
            try:
                inj.benchmark(f"s{i}")
                pattern.append(0)
            except InjectedTransientError:
                pattern.append(1)
        return pattern, inj

    p1, inj1 = run(3)
    p2, _ = run(3)
    p3, _ = run(4)
    assert p1 == p2 and p1 != p3
    assert inj1.injected["transient"] == sum(p1) > 0
    assert inj1.calls == 40


def test_deterministic_injection_keyed_by_schedule_identity():
    spec = InjectSpec("deterministic", 0.5, 123)
    inj = FaultInjectingBenchmarker(ScriptedBench([]), [spec])
    fails = next(f"s{i}" for i in range(50)
                 if _schedule_fails(schedule_id(f"s{i}"), spec))
    passes = next(f"s{i}" for i in range(50)
                  if not _schedule_fails(schedule_id(f"s{i}"), spec))
    for _ in range(3):
        with pytest.raises(InjectedDeterministicError):
            inj.benchmark(fails)
        inj.benchmark(passes)
    assert issubclass(InjectedDeterministicError, DeterministicScheduleError)


def test_hang_injection_stalls_then_proceeds():
    naps = []
    inj = FaultInjectingBenchmarker(
        ScriptedBench([]), [InjectSpec("hang", 1.0, 5)],
        hang_secs=12.5, sleep=naps.append)
    assert inj.benchmark("s").pct50 == 1.0
    assert naps == [12.5]


def test_device_lost_injection():
    inj = FaultInjectingBenchmarker(
        ScriptedBench([]), [InjectSpec("device_lost", 1.0, 5)])
    with pytest.raises(DeviceLostError):
        inj.benchmark("s")


def test_injected_hang_plus_watchdog_end_to_end(tracer):
    """An injected hang fires the watchdog; its stall ends on the cancel
    token (the schedule is not measured on the abandoned thread), the
    timeout classifies transient and the retry passes."""
    rate = 0.6

    def draws(s):
        spec = InjectSpec("hang", rate, s)
        sid = schedule_id("sched")
        return (port_inject._attempt_fires(sid, 0, spec),
                port_inject._attempt_fires(sid, 1, spec))

    seed = next(s for s in range(1000) if draws(s)[0] and not draws(s)[1])
    inner = ScriptedBench([])
    inj = FaultInjectingBenchmarker(inner, [InjectSpec("hang", rate, seed)],
                                    hang_secs=30.0)
    rb = _resilient(inj, timeout_secs=0.1)
    t0 = time.monotonic()
    assert rb.benchmark("sched").pct50 == 1.0
    assert time.monotonic() - t0 < 5.0
    assert inner.calls == 1  # the cancelled hang never reached the device
    names = [e.name for e in tracer.events()]
    assert "fault.injected" in names
    assert "fault.error" in names and "fault.retry" in names


def test_injection_draws_agree_across_instances():
    specs = [InjectSpec("transient", 0.4, 3), InjectSpec("hang", 0.1, 5)]
    queries = [0, 1, 2, 0, 0, 1, 2, 2, 0, 1] * 4

    def run():
        naps = []
        inj = FaultInjectingBenchmarker(ScriptedBench([]), specs,
                                        hang_secs=1.0, sleep=naps.append)
        pattern = []
        for i in queries:
            try:
                inj.benchmark(f"s{i}")
                pattern.append(0)
            except InjectedTransientError:
                pattern.append(1)
        return pattern, len(naps)

    p1, n1 = run()
    p2, n2 = run()
    assert p1 == p2 and n1 == n2
    assert sum(p1) > 0 and n1 > 0
    by_attempt = [p1[i] for i, q in enumerate(queries) if q == 0]
    assert 0 < sum(by_attempt) < len(by_attempt)


def _spmv_schedules_both(n: int = 40):
    """The reference's DFS terminals of the two-compound SpMV graph, and the
    same schedules read into the port's graph through serdes."""
    from tenzing_tpu.core.graph import Graph as RefGraph
    from tenzing_tpu.core.platform import Platform as RefPlatform
    from tenzing_tpu.core.serdes import sequence_to_json
    from tenzing_tpu.models.spmv import SpMVCompound as RefSpMV
    from tenzing_tpu.solve.dfs import enumerate_schedules
    from tenzing_tpu_torch.core.graph import Graph
    from tenzing_tpu_torch.core.serdes import sequence_from_json
    from tenzing_tpu_torch.models.spmv import SpMVCompound

    rg = RefGraph()
    rg.start_then(RefSpMV())
    rg.then_finish(RefSpMV())
    ref_seqs = [st.sequence for st in enumerate_schedules(
        rg, RefPlatform.make_n_lanes(2), max_seqs=n)]
    pg = Graph()
    pg.start_then(SpMVCompound())
    pg.then_finish(SpMVCompound())
    port_seqs = [sequence_from_json(sequence_to_json(s), pg) for s in ref_seqs]
    return rg, ref_seqs, pg, port_seqs


def test_corrupt_schedule_picks_the_reference_mutation():
    """The same serdes schedule draws the same corruption in both packages:
    the same ids, the same identity draw, the same mutated schedule."""
    from tenzing_tpu.bench.benchmarker import schedule_id as ref_sid
    from tenzing_tpu.core.serdes import sequence_to_json as ref_json
    from tenzing_tpu_torch.core.serdes import sequence_to_json as port_json

    _, ref_seqs, _, port_seqs = _spmv_schedules_both()
    n_mutated = 0
    for rs, ps in zip(ref_seqs, port_seqs):
        assert schedule_id(ps) == ref_sid(rs)
        for seed in (4, 11):
            rm = ref_inject.corrupt_schedule(rs, seed)
            pm = port_inject.corrupt_schedule(ps, seed)
            assert (rm is None) == (pm is None)
            if pm is not None:
                n_mutated += 1
                assert port_json(pm) == ref_json(rm)
                assert schedule_id(pm) == ref_sid(rm)
    assert n_mutated > 0


def test_corrupt_injection_mutates_by_schedule_identity(registry):
    from tenzing_tpu_torch.core.sequence import Sequence
    from tenzing_tpu_torch.fault import corrupt_schedule

    _, _, g, seqs = _spmv_schedules_both()
    spec = InjectSpec("corrupt", 0.5, 11)
    seen = {}

    class Recorder:
        def benchmark(self, order, opts=None):
            seen[schedule_id(order)] = order
            return BenchResult.from_times([1.0])

    inj = FaultInjectingBenchmarker(Recorder(), [spec])
    for s in seqs:
        inj.benchmark(s)
    assert inj.injected["corrupt"] > 0
    assert set(inj.corrupted) != set(inj.corrupted.values())
    for orig, mutated in inj.corrupted.items():
        assert mutated in seen and orig != mutated
    inj2 = FaultInjectingBenchmarker(Recorder(), [spec])
    for s in seqs:
        inj2.benchmark(s)
    assert inj2.corrupted == inj.corrupted
    assert corrupt_schedule(Sequence([g.start(), g.finish()]), 1) is None


def test_injector_forwards_degraded_provenance():
    class DegradedInner:
        def was_degraded(self, order):
            return order == "degraded-one"

        def benchmark(self, order, opts=None):
            return BenchResult.from_times([1.0])

    inj = FaultInjectingBenchmarker(DegradedInner(),
                                    [InjectSpec("corrupt", 1.0, 1)])
    assert inj.was_degraded("degraded-one") is True
    assert inj.was_degraded("other") is False
    assert FaultInjectingBenchmarker(
        ScriptedBench([]), [InjectSpec("corrupt", 1.0, 1)]
    ).was_degraded("x") is False


def test_exempt_ids_skip_identity_keyed_kinds_only():
    det = InjectSpec("deterministic", 0.5, 123)
    fails = next(f"s{i}" for i in range(50)
                 if _schedule_fails(schedule_id(f"s{i}"), det))
    inj = FaultInjectingBenchmarker(ScriptedBench([]), [det],
                                    exempt_ids={schedule_id(fails)})
    inj.benchmark(fails)
    assert inj.injected["deterministic"] == 0
    tr = InjectSpec("transient", 1.0, 1)
    inj2 = FaultInjectingBenchmarker(ScriptedBench([]), [tr],
                                     exempt_ids={schedule_id(fails)})
    with pytest.raises(InjectedTransientError):
        inj2.benchmark(fails)


# -- the I/O seam -------------------------------------------------------------------

def test_fsinject_env_raises_until_its_backend_is_ported(monkeypatch, tmp_path):
    """``$TENZING_FSINJECT`` installs the filesystem-chaos backend at the
    seam's first use (fault/fsinject.py): a malformed spec raises loudly, a
    valid one injects its faults, and without the variable nothing does."""
    from tenzing_tpu_torch.fault import fsinject
    from tenzing_tpu_torch.utils import atomic

    monkeypatch.setattr(atomic, "_env_checked", False)
    monkeypatch.setattr(atomic, "_io_backend", None)
    monkeypatch.setenv(atomic.FSINJECT_ENV, "seed=1")
    with pytest.raises(ValueError, match="fsinject"):
        atomic.atomic_dump_json(str(tmp_path / "x.json"), {"a": 1})
    monkeypatch.setattr(atomic, "_env_checked", False)
    monkeypatch.setenv(atomic.FSINJECT_ENV, "enospc:1.0:3:1")
    try:
        with pytest.raises(OSError, match="injected enospc"):
            atomic.atomic_dump_json(str(tmp_path / "x.json"), {"a": 1})
        assert fsinject.installed().injected["enospc"] == 1
    finally:
        fsinject.uninstall()
    monkeypatch.delenv(atomic.FSINJECT_ENV)
    monkeypatch.setattr(atomic, "_env_checked", False)
    atomic.atomic_dump_json(str(tmp_path / "x.json"), {"a": 1})
    assert json.loads((tmp_path / "x.json").read_text()) == {"a": 1}
    assert atomic.io_backend() is None


def test_set_io_backend_sees_every_write_step(tmp_path):
    from tenzing_tpu_torch.utils import atomic

    class Recorder:
        def __init__(self):
            self.ops = []

        def check(self, op, path):
            self.ops.append(op)

    rec = Recorder()
    atomic.set_io_backend(rec)
    try:
        atomic.atomic_dump_json(str(tmp_path / "y.json"), {"b": 2})
    finally:
        atomic.set_io_backend(None)
    assert rec.ops == ["write", "fsync", "replace"]


def test_watchdog_bound_adds_the_measurement_floor():
    """An attempt may take its options' floor (``measurement_floor_s``) plus
    ``timeout_secs``: a measurement long by design is not cut, a stall
    beyond the slack still is."""
    from tenzing_tpu_torch.bench.benchmarker import measurement_floor_s

    opts = BenchOpts(n_iters=5, max_retries=2, target_secs=0.02)
    assert measurement_floor_s(None) == 0.0
    assert measurement_floor_s(opts) == pytest.approx(2 * 2 * 5 * 0.02)
    assert measurement_floor_s(opts, 4, batch=True) == pytest.approx(
        2 * 4 * 5 * 0.02)
    inner = ScriptedBench([0.25, 30.0])
    rb = _resilient(inner, timeout_secs=0.05)
    assert rb.benchmark("long", opts).pct50 == 1.0  # 0.25 s < 0.05 + 0.4
    assert inner.calls == 1
    t0 = time.monotonic()
    assert rb.benchmark("stalled", opts).pct50 == 1.0  # cut, then retried
    assert inner.calls == 3 and time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("coherent,exc,want", [
    (True, ValueError("operand shape mismatch"), True),
    (True, QuarantinedScheduleError("x"), True),
    (True, DeviceLostError("x"), False),
    (True, RuntimeError("CUDA error: invalid argument"), False),
    (False, ValueError("operand shape mismatch"), False),
])
def test_solvers_search_past_no_device_loss(coherent, exc, want):
    """A solver takes a failure as a rejected candidate only from a
    rank-coherent benchmarker, and never a device loss or a CUDA error."""
    from tenzing_tpu_torch.bench.benchmarker import rejects_failures

    class Bench:
        rank_coherent = coherent

    assert rejects_failures(Bench(), exc) is want
