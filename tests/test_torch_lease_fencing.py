"""Lease epoch fencing on hostile clocks (tenzing_tpu_torch/serve/lease.py;
reference tests test_lease_fencing.py), test for test.  A coarse or skewed
observed mtime lets a rival reclaim a live lease (the first half shows the
hole, which the protocol allows); the fencing registry catches the
superseded holder before any fenced effect lands.  The hostile clock comes
from the filesystem-chaos backend (fault/fsinject.py), as in the
reference: every observed mtime floored to the minute and skewed a minute
back.  Then the checkpoint journal's fence: a holder whose lease a rival
superseded cannot append (``$TENZING_FENCE``), and the reference agrees on
the epochs and the files.
"""

import json
import os

import pytest

from tenzing_tpu_torch.fault import fsinject
from tenzing_tpu_torch.fault.errors import FencedWriteError, classify_error
from tenzing_tpu_torch.serve.lease import (
    EPOCH_KEEP,
    LeaseFile,
    check_epoch,
    epoch_registry_of,
    issued_epoch,
)
from tenzing_tpu_torch.utils import atomic


# every observed mtime floored to the minute and skewed a minute back: any
# TTL under a minute sees every lease as expired, whatever the wall clock
HOSTILE_CLOCK = "mtime_coarse:1.0:{s}:60,mtime_skew:1.0:{s}:60"


@pytest.fixture
def clock():
    """Installs the hostile clock with ``clock(seed)``; the well-behaved
    filesystem comes back after the test."""
    fsinject.uninstall()
    yield lambda seed: fsinject.install(HOSTILE_CLOCK.format(s=seed))
    fsinject.uninstall()


class _StaleOnce:
    """Serves ``payload`` to one read of ``path`` (a stale attribute cache):
    the seam's read check, canned as in the reference's test."""

    def __init__(self, path, payload):
        self.path, self.payload = path, payload

    def check(self, op, path):
        pass

    def observe_mtime(self, path, mtime):
        return mtime

    def maybe_stale_json(self, path):
        if path == self.path and self.payload is not None:
            out, self.payload = self.payload, None
            return out
        return None


def _lease(tmp_path, owner, ttl=30.0):
    return LeaseFile(str(tmp_path / "lease-item.json"), owner, ttl_secs=ttl)


# -- the hole ----------------------------------------------------------------------

def test_coarse_clock_reclaims_a_live_lease(tmp_path, clock):
    a = _lease(tmp_path, "alice")
    info_a = a.claim()
    assert info_a is not None and not info_a.reclaimed
    clock(11)
    b = _lease(tmp_path, "bob")
    info_b = b.claim()
    assert info_b is not None and info_b.reclaimed  # a live lease taken
    assert info_b.prev_owner == "alice"
    # the nonce re-read catches alice at her next heartbeat
    assert not a.owns() and not a.renew()


def test_stale_read_defeats_the_nonce_check_alone(tmp_path, clock):
    a = _lease(tmp_path, "alice")
    a.claim()
    with open(a.path) as f:
        stale_payload = json.load(f)
    clock(13)
    b = _lease(tmp_path, "bob")
    assert b.claim().reclaimed
    atomic.set_io_backend(_StaleOnce(a.path, stale_payload))
    assert a.owns()  # the lie: the nonce check passes on stale bytes
    with pytest.raises(FencedWriteError):
        a.check_fence()  # the fence is not fooled


# -- the fix -----------------------------------------------------------------------

def test_epoch_fences_zombie_and_passes_holder(tmp_path, clock):
    a = _lease(tmp_path, "alice")
    assert a.claim().epoch == 1
    clock(17)
    b = _lease(tmp_path, "bob")
    assert b.claim().epoch == 2
    fsinject.uninstall()
    assert issued_epoch(a.path) == 2
    b.check_fence()
    with pytest.raises(FencedWriteError):
        a.check_fence()
    with pytest.raises(FencedWriteError):
        check_epoch(a.path, 1)
    # a zombie's refused write is transient: never evidence against the item
    try:
        check_epoch(a.path, 1)
    except FencedWriteError as e:
        assert classify_error(e) == "transient"


def test_purge_restarts_epochs_for_fresh_work(tmp_path):
    a = _lease(tmp_path, "alice")
    a.claim()
    a.release()
    a.purge_epochs()
    assert issued_epoch(a.path) == 0
    assert not os.path.isdir(epoch_registry_of(a.path))
    b = _lease(tmp_path, "bob")
    assert b.claim().epoch == 1


def test_unfenced_claim_degrades_to_nonce_checks(tmp_path):
    a = _lease(tmp_path, "alice")
    assert a.claim() is not None
    a.epoch = None  # as if the registry marker had not landed
    a.check_fence()
    assert a.owns()


def test_registry_trims_to_epoch_keep(tmp_path, clock):
    path = str(tmp_path / "lease-item.json")
    clock(19)
    last = None
    for g in range(EPOCH_KEEP + 4):
        last = LeaseFile(path, f"gen-{g}", ttl_secs=30.0).claim()
    assert last.epoch == EPOCH_KEEP + 4
    markers = [n for n in os.listdir(epoch_registry_of(path))
               if n.startswith("c-")]
    assert len(markers) <= EPOCH_KEEP
    assert issued_epoch(path) == EPOCH_KEEP + 4


# -- the checkpoint journal's fence -------------------------------------------------

def _seq():
    from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
    from tenzing_tpu_torch.solve.local import first_decision_order
    from tenzing_tpu_torch.core.platform import Platform

    g, _ = graph_for(DriverRequest(workload="spmv", smoke=True))
    return g, first_decision_order(g, Platform.make_n_lanes(1))


def test_fenced_journal_append_raises_for_a_superseded_holder(
        tmp_path, clock, monkeypatch):
    """The daemon exports ``<lease-path>:<epoch>`` to its drain: the holder's
    appends land while its epoch is the newest, and raise
    ``FencedWriteError`` once a rival's claim supersedes it — the journal
    keeps only the holder's rows from before."""
    from tenzing_tpu_torch.bench.benchmarker import BenchResult
    from tenzing_tpu_torch.fault.checkpoint import FENCE_ENV, SearchCheckpoint

    g, seq = _seq()
    a = _lease(tmp_path, "alice")
    assert a.claim().epoch == 1
    monkeypatch.setenv(FENCE_ENV, f"{a.path}:{a.epoch}")
    ck = SearchCheckpoint(str(tmp_path / "ckpt"))
    res = BenchResult.from_times([1e-3, 1.1e-3, 0.9e-3])
    ck.record(seq, None, res)
    ck.save_state({"mcts": {"it": 1}})
    clock(23)
    assert _lease(tmp_path, "bob").claim().epoch == 2
    fsinject.uninstall()
    with pytest.raises(FencedWriteError, match="epoch 1 fenced"):
        ck.record(seq, None, res)
    with pytest.raises(FencedWriteError):
        ck.save_state({"mcts": {"it": 2}})
    ck.close()
    monkeypatch.delenv(FENCE_ENV)
    assert len(SearchCheckpoint(str(tmp_path / "ckpt")).load_measurements(
        g)) == 1
    # a purged registry (the rival completed and cleaned up) fences too
    _lease(tmp_path, "carol").purge_epochs()
    with pytest.raises(FencedWriteError):
        check_epoch(a.path, 1)


def test_lease_files_and_epochs_agree_with_the_reference(tmp_path, clock):
    """The reference's lease protocol and the port's are one protocol: a
    lease the port claimed is live to the reference, the reference's
    reclaim advances the port's registry, and each fences the other."""
    from tenzing_tpu.serve.lease import LeaseFile as RefLease
    from tenzing_tpu.serve.lease import issued_epoch as ref_issued

    a = _lease(tmp_path, "port")
    assert a.claim().epoch == 1
    assert RefLease(a.path, "ref", ttl_secs=30.0).claim() is None  # live
    with open(a.path) as f:
        doc = json.load(f)
    assert {"owner", "pid", "host", "claimed_at", "ttl_s", "nonce",
            "epoch"} <= set(doc)
    os.utime(a.path, (1.0, 1.0))  # long expired
    ref = RefLease(a.path, "ref", ttl_secs=30.0)
    info = ref.claim()
    assert info.reclaimed and info.prev_owner == "port" and info.epoch == 2
    assert issued_epoch(a.path) == ref_issued(a.path) == 2
    with pytest.raises(FencedWriteError):
        a.check_fence()
    assert ref.release() and not os.path.exists(a.path)
