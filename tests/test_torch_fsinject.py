"""The port's hostile-filesystem fault injection (tenzing_tpu_torch/fault/
fsinject.py) against the JAX package's (tenzing_tpu/fault/fsinject.py;
reference tests test_fsinject.py), test for test: the spec grammar, draws
keyed by identity, each kind through utils/atomic.py's seam, bursts bounded
by ``param``, and the lazy install from ``$TENZING_FSINJECT``.  Then across
the packages: one spec fires on the same calls of the same files in both,
observes the same clocks, and serves the same stale reads; a sealed publish
under a torn rename leaves the same files in both.
"""

import errno
import json
import os

import pytest

from tenzing_tpu.fault import fsinject as ref_fsinject
from tenzing_tpu.utils import atomic as ref_atomic
from tenzing_tpu_torch.fault import fsinject
from tenzing_tpu_torch.fault.fsinject import (
    FsInjectSpec,
    InjectedTornRename,
    format_fs_specs,
    parse_fs_specs,
)
from tenzing_tpu_torch.utils import atomic
from tenzing_tpu_torch.utils.atomic import (
    atomic_dump_json,
    io_getmtime,
    publish_sealed,
    read_json,
)


@pytest.fixture(autouse=True)
def _clean_backend():
    """Every test starts and ends with the well-behaved filesystem, in both
    packages (each backend is global to its process)."""
    fsinject.uninstall()
    ref_fsinject.uninstall()
    yield
    fsinject.uninstall()
    ref_fsinject.uninstall()


# -- the spec grammar -----------------------------------------------------------

def test_parse_fs_specs_golden():
    specs = parse_fs_specs("eio:0.5:7,mtime_skew:1.0:11:2.5")
    assert specs == [FsInjectSpec("eio", 0.5, 7),
                     FsInjectSpec("mtime_skew", 1.0, 11, 2.5)]


def test_parse_fs_specs_loud_errors():
    """A mistyped spec fails loudly: one that injected nothing would make a
    chaos run prove nothing."""
    for bad in ("eioo:0.5:7", "eio:1.5:7", "eio:0.5", ""):
        with pytest.raises(ValueError):
            parse_fs_specs(bad)
        with pytest.raises(ValueError):
            ref_fsinject.parse_fs_specs(bad)  # the reference refuses alike


def test_format_fs_specs_roundtrip():
    text = "eio:0.5:7,torn_rename:0.1:3:1,mtime_coarse:1.0:9:2"
    assert format_fs_specs(parse_fs_specs(text)) == text
    assert format_fs_specs(parse_fs_specs(text)) == \
        ref_fsinject.format_fs_specs(ref_fsinject.parse_fs_specs(text))


# -- the draws ------------------------------------------------------------------

def _fire_pattern(mod, spec_text, path, n=24, op="write"):
    b = mod.FsInjectBackend(mod.parse_fs_specs(spec_text))
    out = []
    for _ in range(n):
        try:
            b.check(op, path)
            out.append(False)
        except OSError:
            out.append(True)
    return out


def test_draws_are_identity_keyed_and_replayable(tmp_path):
    """The same writes to the same file fire the same faults under one seed;
    another seed is another schedule."""
    path = str(tmp_path / "seg-x.jsonl")
    a = _fire_pattern(fsinject, "eio:0.4:7", path)
    assert a == _fire_pattern(fsinject, "eio:0.4:7", path) and any(a)
    assert _fire_pattern(fsinject, "eio:0.4:8", path) != a


def test_max_fires_bounds_the_burst(tmp_path):
    """An integer param on eio / enospc / stale_read caps the fires: a burst,
    then recovery."""
    b = fsinject.install("enospc:1.0:3:2")
    fired = 0
    for _ in range(10):
        try:
            b.check("write", str(tmp_path / "f.json"))
        except OSError as e:
            assert e.errno == errno.ENOSPC
            fired += 1
    assert fired == 2 and b.injected["enospc"] == 2


# -- the seam, kind by kind -----------------------------------------------------

def test_eio_fires_on_write_through_seam(tmp_path):
    fsinject.install("eio:1.0:5:1")
    with pytest.raises(OSError) as ei:
        atomic_dump_json(str(tmp_path / "doc.json"), {"k": 1})
    assert ei.value.errno == errno.EIO
    # the burst is spent: the retry lands whole
    atomic_dump_json(str(tmp_path / "doc.json"), {"k": 1})
    assert json.loads((tmp_path / "doc.json").read_text()) == {"k": 1}


def test_torn_rename_raise_mode_leaves_temp_bytes(tmp_path):
    """param=1: the publish raises after the temp bytes landed, the stand-in
    in one process for dying between the fsync and the link."""
    fsinject.install("torn_rename:1.0:5:1")
    path = str(tmp_path / "doc.json")
    with pytest.raises(InjectedTornRename):
        atomic_dump_json(path, {"k": 1})
    assert not os.path.exists(path)  # never published
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    fsinject.uninstall()
    atomic_dump_json(path, {"k": 2})
    assert json.loads(open(path).read()) == {"k": 2}


def test_stale_read_serves_previous_content_once(tmp_path):
    """A stale read returns the superseded complete JSON, at most once per
    replaced version: the lie the lease's epoch fence must survive."""
    path = str(tmp_path / "lease.json")
    fsinject.install("stale_read:1.0:5")
    atomic_dump_json(path, {"v": 1})
    atomic_dump_json(path, {"v": 2})  # the replace keeps v1
    assert read_json(path) == {"v": 1}   # the lie
    assert read_json(path) == {"v": 2}   # once; the truth after


def test_mtime_skew_and_coarse_shift_observed_clock(tmp_path):
    path = str(tmp_path / "lease.json")
    atomic_dump_json(path, {"v": 1})
    real = os.path.getmtime(path)
    fsinject.install("mtime_skew:1.0:5:3.5")
    assert io_getmtime(path) == pytest.approx(real - 3.5)
    fsinject.install("mtime_coarse:1.0:5:2")
    seen = io_getmtime(path)
    assert seen <= real and seen % 2 == 0


def test_env_install_is_lazy_and_inherited(tmp_path, monkeypatch):
    """utils/atomic.py installs from $TENZING_FSINJECT at the first use of
    the seam: what a subprocess inherits, with no arguments."""
    monkeypatch.setenv(fsinject.FSINJECT_ENV, "eio:1.0:5:1")
    # a fresh process: no backend yet, the variable not read
    monkeypatch.setattr(atomic, "_io_backend", None)
    monkeypatch.setattr(atomic, "_env_checked", False)
    with pytest.raises(OSError):
        atomic_dump_json(str(tmp_path / "doc.json"), {"k": 1})
    assert isinstance(fsinject.installed(), fsinject.FsInjectBackend)
    assert fsinject.installed().injected["eio"] == 1


def test_injected_counters_per_kind(tmp_path):
    b = fsinject.install("eio:1.0:5:1,enospc:1.0:5:1")
    for _ in range(2):
        try:
            atomic_dump_json(str(tmp_path / "doc.json"), {"k": 1})
        except OSError:
            pass
    assert b.injected["eio"] + b.injected["enospc"] == 2


# -- across the packages --------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "eio:0.3:7", "enospc:0.5:11:3", "torn_rename:0.4:2:1",
    "eio:0.2:1,enospc:0.2:2"])
def test_the_same_spec_fires_on_the_same_calls(tmp_path, spec):
    """One spec, the same sequence of checks over three files and every seam
    operation: the same calls fire, with the same errno, in both packages."""
    def pattern(mod):
        b = mod.FsInjectBackend(mod.parse_fs_specs(spec))
        out = []
        for i in range(60):
            path = str(tmp_path / f"seg-{i % 3}.jsonl")
            op = ("write", "fsync", "link", "replace")[i % 4]
            try:
                b.check(op, path)
                out.append(None)
            except OSError as e:
                out.append((type(e).__name__, e.errno))
        return out, b.injected

    port, ref = pattern(fsinject), pattern(ref_fsinject)
    assert port == ref
    assert any(x is not None for x in port[0])


def test_the_same_clocks_and_stale_reads(tmp_path):
    """mtime skew and coarsening draw alike and observe the same clock;
    a stale read serves the same superseded content in both."""
    spec = "mtime_skew:0.5:3:7,mtime_coarse:0.5:4:10,stale_read:1.0:9"
    port = fsinject.FsInjectBackend(parse_fs_specs(spec))
    ref = ref_fsinject.FsInjectBackend(ref_fsinject.parse_fs_specs(spec))
    for i in range(30):
        path = str(tmp_path / f"lease-{i % 2}.json")
        assert port.observe_mtime(path, 1000.0 + 3.3 * i) == \
            ref.observe_mtime(path, 1000.0 + 3.3 * i)
    path = str(tmp_path / "lease.json")
    with open(path, "w") as f:
        json.dump({"v": 1}, f)
    port.check("replace", path)
    ref.check("replace", path)
    assert port.maybe_stale_json(path) == ref.maybe_stale_json(path) == \
        {"v": 1}
    assert port.maybe_stale_json(path) is ref.maybe_stale_json(path) is None


def test_sealed_publish_under_a_torn_rename_leaves_the_same_files(tmp_path):
    """``publish_sealed`` through each package's seam with the same raising
    torn rename: the first publish fails in both after its bytes were
    written and leaves no file; the next one lands the same bytes."""
    def run(mod, at, d):
        mod.install("torn_rename:1.0:5:1")
        try:
            with pytest.raises(OSError):
                at.publish_sealed(str(d), lambda: "req-1.jsonl", "x\n")
        finally:
            mod.uninstall()
        left = sorted(os.listdir(d))
        name = at.publish_sealed(str(d), lambda: "req-1.jsonl", "x\n")
        return left, name, (d / name).read_text()

    port = run(fsinject, atomic, tmp_path / "port")
    ref = run(ref_fsinject, ref_atomic, tmp_path / "ref")
    assert port == ref == ([], "req-1.jsonl", "x\n")
    # a rival's name is never overwritten: the maker is asked again
    names = iter(["req-1.jsonl", "req-2.jsonl"])
    assert publish_sealed(str(tmp_path / "port"), lambda: next(names),
                          "y\n") == "req-2.jsonl"
    assert (tmp_path / "port" / "req-1.jsonl").read_text() == "x\n"
