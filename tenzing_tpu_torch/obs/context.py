"""Cross-process trace context: one ``trace_id`` carried through every
process of one run.

Counterpart of ``tenzing_tpu/obs/context.py``.  A :class:`TraceContext`
(``trace_id`` plus the minting side's ``span_id``) is minted with
:func:`new_trace`, made ambient with :func:`use` (a thread-local stack with
a process-global fallback, :func:`set_process_default`), stamped by the
tracer onto every span and event recorded while it is ambient
(``trace_id`` / ``parent_span`` attrs, obs/tracer.py), and handed to a
child process through the :data:`TRACE_ENV` environment variable
(:func:`to_env` / :func:`from_env`) or a JSON envelope
(:meth:`TraceContext.to_json` / :func:`from_json`).

Stdlib only; imports nothing from the rest of ``obs`` (the tracer imports
this module, not the other way round).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

# the environment variable a parent sets for its children ("trace_id:span_id")
TRACE_ENV = "TENZING_TRACE_CONTEXT"


# minting entropy is buffered: context ids come from ``os.urandom`` —
# never ``random``, so the solvers' seeded RNG streams stay untouched —
# but one urandom *syscall* per id is real microseconds on the serving
# ingress (each request mints two).  One 4 KiB read amortizes the
# syscall over 256 mints; the buffer is reset in a forked child so two
# processes can never replay the same entropy window.
_MINT_REFILL = 4096
_mint_lock = threading.Lock()
_mint_buf = b""
_mint_pos = 0


def _mint_reset() -> None:
    global _mint_lock, _mint_buf, _mint_pos
    # rebind the lock too: a child forked while another thread held it
    # would otherwise deadlock on its first mint
    _mint_lock = threading.Lock()
    _mint_buf = b""
    _mint_pos = 0


if hasattr(os, "register_at_fork"):  # pragma: no branch
    os.register_at_fork(after_in_child=_mint_reset)


def _mint_id(nbytes: int = 8) -> str:
    """A random hex id (default 16 hex chars) from the buffered urandom
    pool (module comment above)."""
    global _mint_buf, _mint_pos
    with _mint_lock:
        if _mint_pos + nbytes > len(_mint_buf):
            _mint_buf = os.urandom(max(_MINT_REFILL, nbytes))
            _mint_pos = 0
        out = _mint_buf[_mint_pos:_mint_pos + nbytes]
        _mint_pos += nbytes
    return out.hex()


@dataclass(frozen=True)
class TraceContext:
    """One request's identity: ``trace_id`` names the whole journey,
    ``span_id`` the hop that handed it to us (the remote parent)."""

    trace_id: str
    span_id: str

    def child(self) -> "TraceContext":
        """The context to hand DOWNSTREAM: same trace, fresh hop id."""
        return TraceContext(self.trace_id, _mint_id())

    def to_json(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def to_env_value(self) -> str:
        return f"{self.trace_id}:{self.span_id}"


def new_trace() -> TraceContext:
    """Mint a fresh context — THE ingress call (one per request)."""
    return TraceContext(_mint_id(), _mint_id())


def from_json(doc: Any) -> Optional[TraceContext]:
    """A context from its envelope form; None for anything malformed —
    a torn ``trace`` key must never fail the drain it rides with."""
    if not isinstance(doc, dict):
        return None
    tid, sid = doc.get("trace_id"), doc.get("span_id")
    if not (isinstance(tid, str) and tid):
        return None
    return TraceContext(tid, sid if isinstance(sid, str) and sid else "0")


def from_env(environ: Optional[Dict[str, str]] = None) -> Optional[TraceContext]:
    """The context a parent process exported via :data:`TRACE_ENV`."""
    raw = (environ if environ is not None else os.environ).get(TRACE_ENV)
    if not raw:
        return None
    tid, _, sid = raw.partition(":")
    if not tid:
        return None
    return TraceContext(tid, sid or "0")


def to_env(environ: Dict[str, str], ctx: Optional[TraceContext]) -> Dict[str, str]:
    """Stamp ``ctx`` into an environment mapping (for a child process);
    a None context leaves the mapping untouched."""
    if ctx is not None:
        environ[TRACE_ENV] = ctx.to_env_value()
    return environ


# -- ambient context --------------------------------------------------------

_local = threading.local()
_process_default: Optional[TraceContext] = None
_default_lock = threading.Lock()


def current() -> Optional[TraceContext]:
    """The ambient context: this thread's innermost :func:`use`, else
    the process default (set by a drain child adopting its parent's
    envelope — worker threads inherit it without any threading of
    arguments)."""
    stack = getattr(_local, "stack", None)
    if stack:
        return stack[-1]
    return _process_default


class _Use:
    """Re-entrant-friendly context manager pushing one context onto the
    thread-local stack; ``use(None)`` is a no-op (callers never need a
    conditional ``with``)."""

    __slots__ = ("ctx", "_pushed")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx
        self._pushed = False

    def __enter__(self) -> Optional[TraceContext]:
        if self.ctx is not None:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            stack.append(self.ctx)
            self._pushed = True
        return self.ctx

    def __exit__(self, *exc) -> None:
        if self._pushed:
            _local.stack.pop()


def use(ctx: Optional[TraceContext]) -> _Use:
    """``with use(ctx): ...`` — make ``ctx`` ambient on this thread."""
    return _Use(ctx)


def set_process_default(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Set (or clear, with None) the process-wide fallback context;
    returns the previous default so a scoped caller can restore it."""
    global _process_default
    with _default_lock:
        prev, _process_default = _process_default, ctx
    return prev


def current_trace_attrs() -> Optional[Dict[str, str]]:
    """What the tracer stamps onto a record while a context is ambient
    (obs/tracer.py) — None (the common case) costs one thread-local
    probe and one global read."""
    ctx = current()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "parent_span": ctx.span_id}
