"""The one way the port's command-line tools write a line of output.

A CLI's result line (a JSON document, a CSV row, a report line) goes to
stdout through :func:`write_line`, flushed at once so a parent reading the
pipe sees each line as it is written.  There is no bare ``print`` in the
package (``tests/test_torch_no_print.py``).
"""

from __future__ import annotations

import sys


def write_line(line: str) -> None:
    """Write ``line`` and a newline to stdout, and flush."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()
