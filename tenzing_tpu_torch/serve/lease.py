"""The lease-file protocol: claim by hard link, heartbeat by mtime, reclaim
by rename, release by grab-inspect-release, and epoch fencing.

Counterpart of ``tenzing_tpu/serve/lease.py``, the same protocol and file
formats.  One mutual-exclusion discipline for every long exclusive job of
the serving plane (the drain daemon's per-item claims):

* **Claim** — the owner payload (owner, pid, host, claim time, a unique
  **nonce**, the epoch) is written and fsynced to a private temp file, then
  hard-linked to the lease path: one of any number of rivals wins the link,
  and no rival reads a torn lease.
* **Heartbeat** — renewing bumps the lease file's **mtime**; a lease whose
  mtime is older than the TTL is *expired*.  A renew re-reads the payload's
  nonce first (inode numbers recycle on unlink), so a holder that lost its
  lease during a stall learns it at its next heartbeat and aborts.
* **Reclaim** — an expired lease is reclaimed by atomic rename (one winner;
  the losers' rename gets ``ENOENT``), so a SIGKILLed holder's claim is
  never lost for good.
* **Release** — delete iff still ours, atomically: the lease is grabbed by
  rename, inspected, then deleted (ours) or put back by hard link (a
  rival's).

**Epoch fencing**: the mtime TTL trusts the observed mtime and the
freshness of the nonce re-read, which a shared mount does not guarantee.
Every successful claim records a monotonically increasing **epoch** in a
registry next to the lease (``<path>.epochs/c-<N>``, created ``O_EXCL``).
Before any effect lands — the daemon's store merge, a checkpoint journal
append (fault/checkpoint.py ``$TENZING_FENCE``) — the holder calls
:meth:`LeaseFile.check_fence` / :func:`check_epoch`: a newer epoch in the
registry means a rival claimed since, and the write raises
:class:`~tenzing_tpu_torch.fault.errors.FencedWriteError`.

Expiry clocks and nonce re-reads go through utils/atomic.py's seam
(``io_getmtime`` / ``read_json``), where a backend may inject the skewed
clocks and stale reads the fence exists for; the registry operations do
not.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from tenzing_tpu_torch.fault.errors import FencedWriteError
from tenzing_tpu_torch.utils.atomic import io_getmtime, read_json

# the fencing registry rides next to the lease file; entries are
# c-<epoch> markers, one per *successful* claim, newest few kept
EPOCH_DIR_SUFFIX = ".epochs"
EPOCH_KEEP = 8


def epoch_registry_of(path: str) -> str:
    """The fencing registry directory of lease ``path``."""
    return path + EPOCH_DIR_SUFFIX


def issued_epoch(path: str) -> int:
    """The highest epoch any successful claim of ``path`` has recorded
    (0 when none / the registry is absent)."""
    best = 0
    try:
        names = os.listdir(epoch_registry_of(path))
    except OSError:
        return 0
    for n in names:
        if n.startswith("c-"):
            try:
                best = max(best, int(n[2:]))
            except ValueError:
                pass
    return best


def check_epoch(path: str, epoch: int) -> None:
    """Raise :class:`FencedWriteError` unless ``epoch`` is exactly the
    newest successful claim of lease ``path`` (see module docstring —
    newer means a rival reclaimed us; older/absent means the rival
    already completed and purged the registry).  THE one fence check,
    shared by the holder object, the daemon's merge gate, and the
    checkpoint journal's env-wired hook (fault/checkpoint.py)."""
    newest = issued_epoch(path)
    if newest != epoch:
        raise FencedWriteError(
            f"lease {os.path.basename(path)} epoch {epoch} fenced "
            f"(registry newest: {newest}) — a rival claim supersedes "
            "this holder; abandoning the write")


@dataclass
class ClaimInfo:
    """What :meth:`LeaseFile.claim` reports on success: whether the claim
    reclaimed an expired rival first (the caller's counter/telemetry
    decision, not the protocol's), whose, and the claim's fencing epoch
    (None when the registry could not record it — fencing degrades to
    the nonce checks, never blocks the claim)."""

    reclaimed: bool = False
    prev_owner: Optional[str] = None
    age_s: Optional[float] = None
    epoch: Optional[int] = None


class LeaseFile:
    """One lease path's view of the protocol (module docstring).  The
    object is single-claim: ``claim()`` then ``renew()``/``owns()`` until
    ``release()``; a fresh claim needs a fresh nonce but may reuse the
    object."""

    def __init__(self, path: str, owner: str,
                 ttl_secs: float = 60.0,
                 log: Optional[Callable[[str], None]] = None):
        self.path = path
        self.owner = owner
        self.ttl_secs = float(ttl_secs)
        self.nonce: Optional[str] = None
        self.epoch: Optional[int] = None
        self._log = log

    def _note(self, msg: str) -> None:
        if self._log is not None:
            self._log(msg)

    # -- fencing -------------------------------------------------------------
    def _record_epoch(self, epoch: int) -> bool:
        """Record a successful claim's epoch marker (O_EXCL — atomic) and
        trim the registry tail.  False when the marker could not land:
        the claim stands, fencing degrades to the nonce checks."""
        d = epoch_registry_of(self.path)
        try:
            os.makedirs(d, exist_ok=True)
            fd = os.open(os.path.join(d, f"c-{epoch}"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except OSError:
            return False
        try:
            for n in os.listdir(d):
                if not n.startswith("c-"):
                    continue
                try:
                    k = int(n[2:])
                except ValueError:
                    continue
                if k <= epoch - EPOCH_KEEP:
                    try:
                        os.unlink(os.path.join(d, n))
                    except OSError:
                        pass
        except OSError:
            pass
        return True

    def check_fence(self) -> None:
        """Raise :class:`FencedWriteError` iff a rival claim supersedes
        this holder's epoch (module docstring).  A no-op for unfenced
        claims (epoch marker never landed): those fall back to the
        nonce-re-read protection alone."""
        if self.epoch is not None:
            check_epoch(self.path, self.epoch)

    def purge_epochs(self) -> None:
        """Drop the fencing registry — called by the *completing* holder
        after the guarded effect landed and the work item is gone (a
        later zombie is fenced by the registry's absence, and a fresh
        item at the same path restarts epochs from 1)."""
        d = epoch_registry_of(self.path)
        try:
            for n in os.listdir(d):
                try:
                    os.unlink(os.path.join(d, n))
                except OSError:
                    pass
            os.rmdir(d)
        except OSError:
            pass

    # -- claim ---------------------------------------------------------------
    def claim(self, extra: Optional[Dict[str, Any]] = None
              ) -> Optional[ClaimInfo]:
        """Claim the lease; ``None`` when a rival holds a fresh lease or
        wins either race.  ``extra`` keys ride in the payload (the daemon
        stamps the claimed item's exact digest)."""
        now = time.time()
        info = ClaimInfo()
        self.epoch = None
        try:
            # the expiry clock reads through the I/O seam: coarse or
            # skewed observed mtimes are exactly the chaos the fence
            # (below) exists to survive
            age = now - io_getmtime(self.path)
        except OSError:
            age = None  # no lease: go straight to the fresh claim
        if age is not None:
            if age <= self.ttl_secs:
                return None  # live rival
            # expired: reclaim by atomic rename — one winner among any
            # number of contenders (the losers' rename gets ENOENT)
            stale = (f"{self.path}.stale-{self.owner}-{os.getpid()}-"
                     f"{int(now * 1e6)}")
            try:
                os.rename(self.path, stale)
            except OSError:
                return None  # lost the reclaim race
            prev_owner = "?"
            try:
                with open(stale) as f:
                    prev_owner = json.load(f).get("owner", "?")
            except (OSError, ValueError):
                pass
            try:
                os.unlink(stale)
            except OSError:
                pass
            info = ClaimInfo(reclaimed=True, prev_owner=prev_owner,
                             age_s=round(age, 3))
        # fresh claim: publish-by-hard-link — the payload is fully
        # written and fsynced in a private temp file before the link, so
        # a rival never reads a torn lease, and the link itself is the
        # atomic winner-takes-all step
        epoch = issued_epoch(self.path) + 1
        nonce = (f"{self.owner}-{os.getpid()}-{threading.get_ident()}-"
                 f"{int(now * 1e6)}")
        payload = {"owner": self.owner, "pid": os.getpid(),
                   "host": socket.gethostname(),
                   "claimed_at": now, "ttl_s": self.ttl_secs,
                   "nonce": nonce, "epoch": epoch, **(extra or {})}
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        # thread id in the temp name: two same-owner holders embedded in
        # one process must not interleave writes to one temp file
        tmp = (f"{self.path}.{self.owner}.{os.getpid()}."
               f"{threading.get_ident()}.tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            try:
                os.link(tmp, self.path)
            except OSError:
                return None  # a rival landed first
            self.nonce = nonce
            # record the fence marker ONLY as the winner — losers must
            # never advance the registry past the live holder's epoch
            if self._record_epoch(epoch):
                self.epoch = epoch
                info.epoch = epoch
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return info

    # -- heartbeat -----------------------------------------------------------
    def owns(self) -> bool:
        if self.nonce is None:
            return False  # nothing claimed; never matches a nonce-less file
        try:
            # through the seam: an NFS-style stale read can serve OUR OWN
            # superseded payload here and lie to a reclaimed zombie —
            # which is why effects must also pass check_fence()
            return read_json(self.path).get("nonce") == self.nonce
        except (OSError, ValueError):
            return False

    def renew(self) -> bool:
        """Bump the lease mtime — but only while it is still OUR lease
        (nonce re-read; see module docstring).  False means a rival
        reclaimed it: the holder must abort, not double-run."""
        if not self.owns():
            return False
        try:
            os.utime(self.path, None)
            return True
        except OSError:
            return False

    # -- release -------------------------------------------------------------
    def release(self) -> bool:
        """Grab-inspect-release (module docstring); returns True iff the
        lease was ours and is now deleted.  Always clears the nonce —
        after a release attempt this object holds nothing."""
        self.epoch = None
        if self.nonce is None:
            return False
        grab = (f"{self.path}.release.{self.owner}.{os.getpid()}."
                f"{threading.get_ident()}")
        try:
            os.rename(self.path, grab)
        except OSError:
            self.nonce = None
            return False  # already gone (reclaimed + released by a rival)
        ours = False
        try:
            with open(grab) as f:
                ours = json.load(f).get("nonce") == self.nonce
        except (OSError, ValueError):
            pass
        if not ours:
            try:
                os.link(grab, self.path)  # a rival's live claim: restore it
            except OSError:
                pass
        try:
            os.unlink(grab)
        except OSError:
            pass
        self.nonce = None
        return ours
