"""One-shot library initialization and research-notice gate.

Counterpart of ``tenzing_tpu/utils/initgate.py`` (reference
``src/init.cpp:24-67``): ``init()`` is idempotent, prints a research-software
notice once, and stays silent once the notice is acknowledged through the
environment (``TENZING_TPU_ACK_NOTICE``, the reference's variable).  Nothing
is brought up here: the port's processes start their own process groups
(parallel/launch.py), so ``init()`` is host bookkeeping only, the notice and
the start time the reproduce stamp (utils/reproduce.py) sits beside.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

ACK_ENV = "TENZING_TPU_ACK_NOTICE"

NOTICE = """\
tenzing_tpu_torch is research software: schedules it explores are executed and
timed on the attached devices.  Set {env}=1 to acknowledge and silence this
notice.
""".format(env=ACK_ENV)

_initialized = False
_init_time: Optional[float] = None


def is_initialized() -> bool:
    return _initialized


def init_time() -> Optional[float]:
    """Wall-clock time of the first init() call (for reproduce stamps)."""
    return _init_time


def init(stream=None) -> None:
    """Idempotent library init (reference init.cpp:24-41): print the research
    notice unless acknowledged through the environment."""
    global _initialized, _init_time
    if _initialized:
        return
    _initialized = True
    _init_time = time.time()
    if os.environ.get(ACK_ENV, "") not in ("1", "true", "yes"):
        (stream or sys.stderr).write(NOTICE)


def _reset_for_tests() -> None:
    global _initialized, _init_time
    _initialized = False
    _init_time = None
