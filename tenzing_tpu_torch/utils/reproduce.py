"""Reproducibility stamp: one JSON line with versions, VCS state and argv.

Counterpart of ``tenzing_tpu/utils/reproduce.py`` (reference
``src/reproduce.cpp:22-46``): ``{"tenzing_tpu_torch": <version>, "torch":
<version>, "git": {"hash", "dirty"}, "argv": [...]}``, the reference's keys
with this package and its framework in place of ``tenzing_tpu`` and ``jax``.
The git state is read from the checkout that holds the package, at call
time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import List, Optional


def git_info(cwd: Optional[str] = None) -> dict:
    """{"hash": ..., "dirty": bool} of the checkout enclosing this package (not
    the caller's cwd), or {} when it is not in one."""
    if cwd is None:
        cwd = os.path.dirname(os.path.abspath(__file__))
    try:
        h = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd, capture_output=True, text=True, timeout=5,
        )
        if h.returncode != 0:
            return {}
        s = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=cwd, capture_output=True, text=True, timeout=5,
        )
        return {"hash": h.stdout.strip(), "dirty": bool(s.stdout.strip())}
    except (OSError, subprocess.SubprocessError):
        return {}


def stamp(argv: Optional[List[str]] = None) -> dict:
    import torch

    from tenzing_tpu_torch import __version__

    return {
        "tenzing_tpu_torch": __version__,
        "torch": torch.__version__,
        "git": git_info(),
        "argv": list(sys.argv if argv is None else argv),
    }


def dump_with_cli(argv: Optional[List[str]] = None, stream=None) -> str:
    """Write the stamp as one JSON line (reference reproduce.cpp:22-37), to
    stderr unless ``stream`` is given, and return it."""
    line = json.dumps(stamp(argv))
    (stream or sys.stderr).write(line + "\n")
    return line
