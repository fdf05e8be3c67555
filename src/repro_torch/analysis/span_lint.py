"""Span-coverage AST lint: every traced Clock charge opens a span.

The observability pipeline (repro_torch.obs) carries one invariant the trace
tooling cannot check at runtime: span accounting only closes exactly
when every ``clock.advance`` charge in a traced serving stage happens
inside a leaf span. A charge added OUTSIDE any span doesn't crash
anything — it silently widens the root/leaf gap, and the accounting
gate only catches it on code paths the fault suites happen to drive.
This lint closes the bug class statically, the same way
``mirror_lint`` closes dirty-log omissions: parse the traced modules
and demand that every function charging the clock also opens a span on
the same path.

The counterpart of ``repro.analysis.span_lint``, rule for rule, over the
port's files.

A *charge* is a call whose attribute chain ends ``.clock.advance(...)``
(``self.clock.advance``, ``self.parent.clock.advance``). A function is
*covered* when it also contains one of:

* a span call — ``<obj>.span(...)`` (the TraceRecorder entry point) or
  ``<obj>._span(...)`` (the NULL_SPAN-returning helper every traced
  component defines);
* a ``# span-ok`` pragma on the charge's line or the line directly
  above it, for charges that are deliberately un-spanned: a store whose
  latency is timed by the CALLER's open span (``LatencyModelStore``,
  ``RetryingStore`` backoff), inter-arrival idle time that is not a
  serving stage, or the untraced VDB baseline.

Granularity is per-function, matching mirror_lint: a function that
opens any span has demonstrated it knows the protocol; the bug shape
is the function that charges the clock and *never* does.
"""

from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.contracts import Violation

SPAN_METHODS = frozenset({"span", "_span"})
PRAGMA = "# span-ok"


def _is_clock_advance(node: ast.AST) -> bool:
    """``<anything>.clock.advance(...)`` — the attribute chain's last
    two links are what make it a Clock charge."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    return (isinstance(fn, ast.Attribute) and fn.attr == "advance"
            and isinstance(fn.value, ast.Attribute)
            and fn.value.attr == "clock")


def _is_span_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    return isinstance(fn, ast.Attribute) and fn.attr in SPAN_METHODS


def _has_pragma(lines: list[str], lineno: int) -> bool:
    """``# span-ok`` on the charge's line or the line directly above
    (long charge expressions push the comment up a line)."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and PRAGMA in lines[ln - 1]:
            return True
    return False


def lint_source(src: str, filename: str = "<string>") -> list[Violation]:
    """Lint one module's source text. Returns a Violation per Clock
    charge in a function with no span call and no pragma."""
    tree = ast.parse(src, filename=filename)
    lines = src.splitlines()
    out: list[Violation] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        charges: list[int] = []
        covered = False
        for node in ast.walk(fn):
            if _is_clock_advance(node):
                if not _has_pragma(lines, node.lineno):
                    charges.append(node.lineno)
            elif _is_span_call(node):
                covered = True
        if charges and not covered:
            first = min(charges)
            out.append(Violation(
                "SpanCoverage", f"{filename}:{fn.name}",
                f"charges the clock (`.clock.advance`) without opening "
                f"a span (`.span`/`._span`) or a `{PRAGMA}` pragma — "
                f"the charge lands outside every leaf span and silently "
                f"breaks exact span accounting",
                f"first charge at line {first}: "
                f"{lines[first - 1].strip()[:120]}"))
    return out


def default_paths() -> list[Path]:
    src = Path(__file__).resolve().parent.parent
    return [src / "core" / "cache.py", src / "core" / "shard.py",
            src / "core" / "storage.py",
            src / "serving" / "simulator.py"]


def lint_paths(paths=None) -> list[Violation]:
    """Lint every traced module (default: the cache/shard/storage/
    simulator stack the TraceRecorder is threaded through)."""
    out: list[Violation] = []
    for p in (default_paths() if paths is None else paths):
        p = Path(p)
        out.extend(lint_source(p.read_text(), filename=p.name))
    return out
