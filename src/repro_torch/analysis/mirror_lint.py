"""Mirror-coherence AST lint: every host-table write marks dirty rows.

The device-residency protocol (core/hnsw.py) keeps host numpy tables as
the source of truth and a persistent device mirror synced by a dirty-row
delta scatter. The protocol's one unfixable failure mode is a host write
that never lands in the dirty log: the device serves stale rows forever,
and a coherence test can only catch it if its sampled
workload happens to hit the drifted row. This lint closes the bug class
statically: it parses the source and demands that every function writing
a mirror table also marks rows dirty on the same path.

The counterpart of ``repro.analysis.mirror_lint``, rule for rule, over the
port's files.

A *write* is a subscript assignment whose base attribute is a mirror
table — ``self.emb[slot] = vec``, ``idx.neighbors[0][slot] = ...``,
``self.slot_inserted[slot] = now`` (the cache-layer aliases of
``index.inserted`` / ``index.category`` count too). A function is
*covered* when it also contains one of:

* a dirty-log call — ``<base>._dirty.add(...)`` / ``._dirty.update(...)``;
* a delegate insert — ``.add_batch(...)`` (the index entry point that
  does its own marking, which is how the cache layer's alias writes
  ride the same delta flush);
* a ``# mirror-ok`` pragma on the write's line, for writes whose
  marking provably happens in every caller (e.g. ``_quantize_slot``,
  which every call site already dirties).

Granularity is deliberately per-function, not per-statement: dataflow
through local views (``row = self.neighbors[l][nb]; row[...] = ...``)
is beyond static subscript matching, and a function that touches the
dirty log at all has demonstrated it knows the protocol. The lint's job
is the function that *never* does — the exact shape of the incoherence
bug.
"""

from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.contracts import Violation

# Host-side tables with a device mirror (core/hnsw.py) plus the cache
# layer's aliases of them (core/cache.py binds slot_inserted /
# slot_category to the index's inserted / category tables).
MIRROR_TABLES = frozenset({
    "emb", "emb_q", "emb_scale", "valid", "category", "inserted",
    "neighbors", "slot_inserted", "slot_category",
})
DIRTY_METHODS = frozenset({"add", "update"})
DELEGATE_METHODS = frozenset({"add_batch"})
PRAGMA = "# mirror-ok"


def _mirror_table_of(target: ast.expr) -> str | None:
    """The mirror table a subscript-assignment target writes, if any:
    peel subscript layers (``neighbors[l][slot, :]`` nests two) down to
    the base attribute."""
    node = target
    depth = 0
    while isinstance(node, ast.Subscript):
        node = node.value
        depth += 1
    if depth and isinstance(node, ast.Attribute) \
            and node.attr in MIRROR_TABLES:
        return node.attr
    return None


def _is_dirty_marker(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr in DELEGATE_METHODS:
        return True
    return (fn.attr in DIRTY_METHODS
            and isinstance(fn.value, ast.Attribute)
            and fn.value.attr == "_dirty")


def _assign_targets(node: ast.AST):
    if isinstance(node, ast.Assign):
        for t in node.targets:
            yield from (t.elts if isinstance(t, (ast.Tuple, ast.List))
                        else (t,))
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        yield node.target


def lint_source(src: str, filename: str = "<string>") -> list[Violation]:
    """Lint one module's source text. Returns a Violation per mirror
    write in a function with no dirty marking and no pragma."""
    tree = ast.parse(src, filename=filename)
    lines = src.splitlines()
    out: list[Violation] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        writes: list[tuple[str, int]] = []
        covered = False
        for node in ast.walk(fn):
            for target in _assign_targets(node):
                table = _mirror_table_of(target)
                if table is None:
                    continue
                line = lines[node.lineno - 1] if node.lineno <= len(lines) \
                    else ""
                if PRAGMA in line:
                    continue
                writes.append((table, node.lineno))
            if _is_dirty_marker(node):
                covered = True
        if writes and not covered:
            tables = sorted({t for t, _ in writes})
            first = min(ln for _, ln in writes)
            out.append(Violation(
                "MirrorCoherence", f"{filename}:{fn.name}",
                f"writes mirror table(s) {tables} without marking rows "
                f"dirty (`_dirty.add/update`), delegating to add_batch, "
                f"or a `{PRAGMA}` pragma — the device mirror will serve "
                f"stale rows after the next delta flush",
                f"first write at line {first}: "
                f"{lines[first - 1].strip()[:120]}"))
    return out


def default_paths() -> list[Path]:
    core = Path(__file__).resolve().parent.parent / "core"
    return [core / "hnsw.py", core / "cache.py", core / "shard.py"]


def lint_paths(paths=None) -> list[Violation]:
    """Lint every file that touches mirror tables (default: the core
    index / cache / shard modules)."""
    out: list[Violation] = []
    for p in (default_paths() if paths is None else paths):
        p = Path(p)
        out.extend(lint_source(p.read_text(), filename=p.name))
    return out
