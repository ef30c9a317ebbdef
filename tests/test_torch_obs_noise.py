"""The port's host-noise floors (tenzing_tpu_torch/obs/noise.py) against
the JAX package's (tenzing_tpu/obs/noise.py; reference tests
test_obs_noise.py), test for test: the probes' arithmetic against a
scripted clock, the ``host_noise`` block, the re-probe when a series fails
the runs test, and the floor verdicts.  Then across the packages: the same
scripted series give the same block less ``host`` and ``measured_at``, and
the same blocks the same verdicts.
"""

import pytest

from tenzing_tpu.obs import noise as ref_noise
from tenzing_tpu_torch.obs.noise import (
    NOISE_VERSION,
    floor_vs_tail,
    floors_differ,
    probe_host_noise,
    probe_hot_spin,
    probe_timer_wake,
    series_summary,
)


class ScriptedClock:
    """A fake ``perf_counter`` / ``sleep`` pair: a sleep advances by the
    request plus a scripted overshoot, each clock read costs a fixed tick,
    so the probes are arithmetic."""

    def __init__(self, overshoots_us, tick_us=1.0):
        self.overshoots = list(overshoots_us)
        self.tick_us = tick_us
        self.t = 0.0
        self.i = 0

    def clock(self):
        self.t += self.tick_us / 1e6
        return self.t

    def sleep(self, secs):
        over = self.overshoots[self.i % len(self.overshoots)]
        self.i += 1
        self.t += secs + over / 1e6


def test_probe_timer_wake_deterministic_golden():
    c = ScriptedClock([10.0, 20.0, 30.0, 40.0])
    xs = probe_timer_wake(samples=4, sleep_us=100.0, clock=c.clock,
                          sleeper=c.sleep)
    # each sample: the scripted overshoot plus one clock tick
    assert [round(x, 6) for x in xs] == [11.0, 21.0, 31.0, 41.0]


def test_probe_hot_spin_shape_and_overshoot_bound():
    c = ScriptedClock([], tick_us=5.0)
    xs = probe_hot_spin(samples=3, target_us=20.0, clock=c.clock)
    assert len(xs) == 3
    assert all(0.0 <= x <= 10.0 for x in xs)


def test_series_summary_shape():
    s = series_summary([1.0, 2.0, 3.0, 4.0])
    assert set(s) == {"count", "p50_us", "p99_us", "mean_us", "max_us",
                      "runs_z", "iid"}
    assert s["count"] == 4 and s["max_us"] == 4.0
    assert s["mean_us"] == 2.5
    assert isinstance(s["iid"], bool)


def test_probe_host_noise_block_shape():
    c = ScriptedClock([3.0, 7.0, 5.0, 9.0, 2.0, 8.0, 4.0, 6.0])
    block = probe_host_noise(samples=16, clock=c.clock, sleeper=c.sleep)
    assert block["version"] == NOISE_VERSION
    assert block["samples"] == 16
    assert block["timer_wake_us"]["count"] == 16
    assert block["hot_spin_us"]["count"] == 16
    assert block["attempts"] >= 1
    assert isinstance(block["host"], str) and block["host"]
    assert block["measured_at"] > 0


def test_probe_host_noise_reprobes_on_runs_failure():
    # a monotone ramp fails the runs test on every pass: the probe retries,
    # keeps the last pass and says so (attempts, iid False)
    c = ScriptedClock([float(i) for i in range(32)])
    block = probe_host_noise(samples=32, retries=2, clock=c.clock,
                             sleeper=c.sleep)
    assert block["attempts"] == 3
    assert block["timer_wake_us"]["iid"] is False


def _block(wake_p99, spin_p99=2.0):
    return {"timer_wake_us": {"p99_us": wake_p99, "p50_us": wake_p99 / 2},
            "hot_spin_us": {"p99_us": spin_p99, "p50_us": spin_p99 / 2}}


def test_floors_differ_verdicts():
    assert floors_differ(_block(10.0), _block(15.0)) is None
    r = floors_differ(_block(50.0), _block(10.0))
    assert r is not None and "timer-wake" in r
    assert floors_differ(_block(10.0), _block(50.0)) is not None
    r = floors_differ(_block(10.0, spin_p99=40.0), _block(10.0))
    assert r is not None and "hot-spin" in r
    # floors under 1us are clamped: clock granularity is not a host
    assert floors_differ(_block(10.0, spin_p99=0.01),
                         _block(10.0, spin_p99=0.9)) is None
    assert floors_differ(None, _block(10.0)) is None
    assert floors_differ(_block(10.0), {}) is None


def test_floor_vs_tail_verdicts():
    v = floor_vs_tail(_block(26.0), 98.8)
    assert v["ratio"] == 3.8
    assert v["host_bound"] is True
    assert "host-bound" in v["line"]
    v = floor_vs_tail(_block(10.0), 500.0)
    assert v["host_bound"] is False and "serving-bound" in v["line"]
    assert floor_vs_tail(None, 100.0) is None
    assert floor_vs_tail(_block(10.0), None) is None


# -- across the packages -------------------------------------------------------------

def _series(seed, n):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.gamma(2.0, 6.0, size=n)]


@pytest.mark.parametrize("seed,samples,retries,tick", [
    (0, 16, 1, 1.0), (1, 64, 1, 0.5), (2, 32, 0, 2.0), (3, 8, 3, 1.0)])
def test_host_noise_block_is_the_references(seed, samples, retries, tick):
    """The same scripted clock gives both packages the same block, less the
    host's name and the wall time it was taken at."""
    over = _series(seed, samples)
    blocks = []
    for mod in (ref_noise, None):
        c = ScriptedClock(over, tick_us=tick)
        fn = mod.probe_host_noise if mod else probe_host_noise
        b = fn(samples=samples, retries=retries, clock=c.clock,
               sleeper=c.sleep)
        blocks.append({k: v for k, v in b.items()
                       if k not in ("host", "measured_at")})
    assert blocks[0] == blocks[1]
    assert set(blocks[0]) == {"version", "samples", "sleep_us",
                              "spin_target_us", "attempts", "timer_wake_us",
                              "hot_spin_us"}


@pytest.mark.parametrize("seed", range(4))
def test_probes_and_summary_are_the_references(seed):
    over = _series(seed, 24)
    c1, c2 = ScriptedClock(over), ScriptedClock(over)
    assert probe_timer_wake(24, 80.0, c1.clock, c1.sleep) == \
        ref_noise.probe_timer_wake(24, 80.0, c2.clock, c2.sleep)
    c1, c2 = ScriptedClock([], tick_us=3.0), ScriptedClock([], tick_us=3.0)
    assert probe_hot_spin(12, 20.0, c1.clock) == \
        ref_noise.probe_hot_spin(12, 20.0, c2.clock)
    assert series_summary(over) == ref_noise.series_summary(over)


def test_floor_verdicts_are_the_references():
    pairs = [(_block(a, s), _block(b, t))
             for a, b in ((10.0, 15.0), (50.0, 10.0), (0.2, 0.9), (3.0, 7.0))
             for s, t in ((2.0, 2.0), (40.0, 10.0), (0.01, 0.9))]
    pairs += [(None, _block(10.0)), (_block(10.0), {}),
              ({"timer_wake_us": {"p99_us": "x"}}, _block(10.0))]
    for a, b in pairs:
        assert floors_differ(a, b) == ref_noise.floors_differ(a, b)
        assert floors_differ(a, b, 4.0) == ref_noise.floors_differ(a, b, 4.0)
    for blk, p99 in ((_block(26.0), 98.8), (_block(10.0), 500.0),
                     (_block(0.0), 5.0), (None, 1.0), (_block(3.0), None)):
        assert floor_vs_tail(blk, p99) == ref_noise.floor_vs_tail(blk, p99)
