"""Lint: no bare ``print(`` in tenzing_tpu_torch/, as the reference holds
itself (test_no_print.py).

A command-line tool writes its result lines through
``tenzing_tpu_torch.utils.cli.write_line`` (stdout, flushed) and its notes
through an explicit ``sys.stderr.write``: a stray line on stdout would break
the one-JSON-line protocol the drivers and the serving plane's children
speak.  Tokenize-based, so ``print`` inside strings, comments and
docstrings does not trip it.  The allowlist (paths relative to
tenzing_tpu_torch/) is empty.
"""

import io
import tokenize
from pathlib import Path

PORT_ROOT = Path(__file__).resolve().parent.parent / "tenzing_tpu_torch"

# relative-to-tenzing_tpu_torch paths allowed to keep a bare print()
ALLOWLIST: set = set()

_SKIP = (tokenize.NL, tokenize.NEWLINE, tokenize.INDENT, tokenize.DEDENT,
         tokenize.COMMENT)


def _print_calls(source: str):
    """(line, col) of every call of the builtin ``print`` in ``source``."""
    toks = list(tokenize.generate_tokens(io.StringIO(source).readline))
    hits = []
    for i, tok in enumerate(toks):
        if tok.type != tokenize.NAME or tok.string != "print":
            continue
        prev = next((t for t in reversed(toks[:i]) if t.type not in _SKIP),
                    None)
        if prev is not None and prev.type == tokenize.OP and prev.string == ".":
            continue  # x.print is not the builtin
        nxt = next((t for t in toks[i + 1:]
                    if t.type not in (tokenize.NL, tokenize.NEWLINE,
                                      tokenize.COMMENT)), None)
        if nxt is not None and nxt.type == tokenize.OP and nxt.string == "(":
            hits.append((tok.start[0], tok.start[1]))
    return hits


def test_no_bare_print_in_the_port():
    offenders = []
    for path in sorted(PORT_ROOT.rglob("*.py")):
        rel = path.relative_to(PORT_ROOT).as_posix()
        if rel in ALLOWLIST:
            continue
        for line, col in _print_calls(path.read_text()):
            offenders.append(f"tenzing_tpu_torch/{rel}:{line}:{col}")
    assert not offenders, (
        "bare print() in the port (write a CLI line through utils/cli.py "
        "write_line, a note to sys.stderr):\n  " + "\n  ".join(offenders))


def test_allowlist_entries_still_exist():
    for rel in ALLOWLIST:
        assert (PORT_ROOT / rel).is_file(), f"stale allowlist entry: {rel}"


def test_print_detector_self_check():
    src = (
        "x = 'print(not me)'\n"
        "# print(also not me)\n"
        "obj.print('method, not builtin')\n"
        "print('caught')\n"
        "f(print)\n"
        "print (\n  'spaced')\n"
    )
    assert _print_calls(src) == [(4, 0), (6, 0)]


def test_write_line_writes_one_flushed_line(capsys):
    from tenzing_tpu_torch.utils.cli import write_line

    write_line('{"a": 1}')
    write_line("row|2")
    assert capsys.readouterr().out == '{"a": 1}\nrow|2\n'
