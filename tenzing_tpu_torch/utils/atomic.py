"""The atomic file-write helper (tmp + fsync + rename).

Counterpart of ``tenzing_tpu/utils/atomic.py``: one definition shared by
every persistent-state writer of the port — the checkpoint's state
snapshots (fault/checkpoint.py), the quarantine file (fault/quarantine.py),
the schedule store and work queue (serve/store.py), and the sealed files of
the segmented store and the request log (:func:`publish_sealed`;
serve/segments.py, serve/reqlog.py).  Readers see either the previous
complete file or the new complete file, never a torn write, and the rename
lands only after the bytes are on disk.

Every durable writer goes through here, so this module is also the
injectable I/O seam: an installed backend (:func:`set_io_backend`;
fault/fsinject.py is the one that injects) gets a check before each write,
fsync, link and replace, and may skew an observed mtime
(:func:`io_getmtime`) or serve a file's previous content once
(:func:`read_json`) — the clocks and reads the serving plane's lease
protocol trusts (serve/lease.py).  With none installed — the default —
every hook is a branch on a None global.  ``$TENZING_FSINJECT`` installs
the filesystem-chaos backend lazily, once, at the first use of the seam, so
a subprocess inherits a chaos run's faults without arguments.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

FSINJECT_ENV = "TENZING_FSINJECT"

_io_backend: Optional[Any] = None
_env_checked = False


def set_io_backend(backend: Optional[Any]) -> None:
    """Install (or with None, remove) a fault-injecting I/O backend —
    fault/fsinject.py is the one that injects."""
    global _io_backend, _env_checked
    _io_backend = backend
    _env_checked = True


def io_backend() -> Optional[Any]:
    """The active backend, installed from ``$TENZING_FSINJECT`` at the first
    call.  A malformed spec raises at the first write: a chaos run that
    silently injected nothing would prove nothing."""
    global _env_checked
    if not _env_checked:
        _env_checked = True
        if os.environ.get(FSINJECT_ENV):
            from tenzing_tpu_torch.fault.fsinject import install_from_env

            install_from_env()
    return _io_backend


def _check(op: str, path: str) -> None:
    b = io_backend()
    if b is not None:
        b.check(op, path)


def io_getmtime(path: str) -> float:
    """``os.path.getmtime`` as observed through the seam: an installed
    backend may skew or coarsen it (the lease protocol's expiry clock)."""
    t = os.path.getmtime(path)
    b = io_backend()
    return b.observe_mtime(path, t) if b is not None else t


def read_json(path: str):
    """``json.load`` of ``path`` through the seam: an installed backend may
    serve the file's previous complete content once (a stale read).  Raises
    OSError / ValueError as the plain read does."""
    b = io_backend()
    if b is not None:
        doc = b.maybe_stale_json(path)
        if doc is not None:
            return doc
    with open(path) as f:
        return json.load(f)


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename or link inside it is durable;
    best-effort where the platform refuses to open or fsync a directory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def publish_sealed(directory: str, make_name, text: str) -> str:
    """Publish one complete, immutable file into ``directory``: a private
    temp file, fsynced, hard-linked to the name ``make_name()`` returns
    (called again when a rival publisher took that name, so the maker must
    stamp fresh names), the temp unlinked, the directory fsynced.  A reader
    never sees a torn file that the writer acknowledged.  The segmented
    store's segments and the request log's share it (serve/segments.py,
    serve/reqlog.py).  Returns the published name."""
    os.makedirs(directory, exist_ok=True)
    while True:
        name = make_name()
        final = os.path.join(directory, name)
        tmp = final + ".tmp"
        _check("write", final)
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            _check("fsync", final)
            os.fsync(f.fileno())
        try:
            # the torn-rename point: the temp bytes durable, the link not
            # landed yet — the crash the sealed formats must survive
            _check("link", final)
            os.link(tmp, final)
        except FileExistsError:
            continue
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        break
    fsync_dir(directory)
    return name


def atomic_dump_json(path: str, doc: Dict[str, Any],
                     prefix: str = ".atomic.") -> None:
    """Write ``doc`` as sorted-key JSON to ``path`` atomically: the temp file
    lives in the destination directory (a rename must not cross
    filesystems), is fsynced before the rename and unlinked on any failure;
    the directory is fsynced after the rename."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    _check("write", path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=prefix, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, sort_keys=True)
            f.flush()
            _check("fsync", path)
            os.fsync(f.fileno())
        _check("replace", path)
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
