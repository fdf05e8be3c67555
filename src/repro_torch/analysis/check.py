"""``python -m repro_torch.analysis.check [--device cuda|cpu] [-q]`` — the
static-analysis gate of the port.

The counterpart of ``repro.analysis.check``. Applies every hot-path
contract to the real system; nothing is timed:

1. **Op-trace contracts** (``contracts.py``) on every {index kind} x
   {resident dtype} cell: the classified search and the delta flush,
   recorded op by op, checked for materialized candidate gathers, host
   transfers, a flush that is not in place and an int8 table rebuilt as
   fp32. On the card the searches run under
   ``torch.cuda.set_sync_debug_mode("error")``.
2. **Compile budget** on the serving tier: a {flat, hnsw} x {fp32, int8} x
   {1, 2}-shard sweep of ``ShardedSemanticCache`` serve batches B = 1, 2,
   3, 5, 8, each shard index holding exactly one program.
3. **Kernel budgets** (``smem.py``, the card only): registers, shared
   memory and spills of every kernel from the build's ``-Xptxas -v``
   report against the card's limits, and each cache kernel launched at
   the reference's shape families against its plain version.
4. **Mirror-coherence lint** (``mirror_lint.py``) over the core index /
   cache / shard modules.
5. **Span-coverage lint** (``span_lint.py``) over the traced serving stack.

The default device is the card, as for every entry point of the port:
without one it raises unless ``--device cpu`` is given. On the CPU section
3 is not run; the gate says so and does not count it as held. Exit status
0 = every section it ran holds; 1 = violations (one per line with
evidence).
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np

from repro_torch.analysis import mirror_lint, smem, span_lint
from repro_torch.analysis.contracts import (CompileBudget, Violation, collect_compile_census,
                                            collect_hot_path_traces, run_rules)

INDEX_KINDS = ("flat", "hnsw")
EMB_DTYPES = ("float32", "int8")
SHARD_COUNTS = (1, 2)
SERVE_BATCHES = (1, 2, 3, 5, 8)


def _policies():
    from repro_torch.core.policy import CategoryConfig, PolicyEngine
    return PolicyEngine([
        CategoryConfig("a", threshold=0.85, ttl=1e6, quota=0.4),
        CategoryConfig("b", threshold=0.80, ttl=1e6, quota=0.4),
    ])


@contextlib.contextmanager
def sync_debug_error():
    """A host sync raises while the block runs on the card."""
    import torch
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def check_op_traces(device: str = "cpu", log=print) -> list[Violation]:
    out: list[Violation] = []
    for kind in INDEX_KINDS:
        for dtype in EMB_DTYPES:
            guard = sync_debug_error() if device == "cuda" else None
            traces = collect_hot_path_traces(kind, dtype, device=device, search_guard=guard)
            viols = run_rules(traces)
            log(f"  {kind}/{dtype}: {len(traces)} traces "
                f"({', '.join(f'{t.name.split(':')[1]} {len(t.ops)} ops' for t in traces)})"
                f" — {len(viols)} violations")
            out.extend(viols)
    return out


def check_compile_budget(device: str = "cpu", log=print) -> list[Violation]:
    from repro_torch.core.shard import ShardedSemanticCache
    out: list[Violation] = []
    rng = np.random.default_rng(0)
    for kind in INDEX_KINDS:
        for dtype in EMB_DTYPES:
            for n_shards in SHARD_COUNTS:
                cache = ShardedSemanticCache(
                    _policies(), dim=384, capacity=256, n_shards=n_shards,
                    index_kind=kind, use_device=True, emb_dtype=dtype, seed=0,
                    device=device)
                # a little content, so the sweep searches a live index
                vecs = rng.standard_normal((8, 384)).astype(np.float32)
                vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
                cache.insert_batch(vecs, ["a", "b"] * 4, [f"q{i}" for i in range(8)],
                                   [f"r{i}" for i in range(8)])
                census = collect_compile_census(cache, batches=SERVE_BATCHES,
                                                name=f"{kind}/{dtype}/shards={n_shards}")
                viols = CompileBudget().check(census)
                log(f"  {census.name}: families={dict(sorted(census.families.items()))}"
                    f" — {len(viols)} violations")
                out.extend(viols)
    return out


def check_kernel_budgets(device: str = "cuda", log=print) -> list[Violation]:
    from repro_torch.kernels import _build
    _build.library()                     # the report comes with the build
    viols, _, _ = smem.check_kernels(device, log=log)
    return viols


def check_mirror(device: str = "cpu", log=print) -> list[Violation]:
    paths = mirror_lint.default_paths()
    viols = mirror_lint.lint_paths(paths)
    log(f"  {len(paths)} modules linted ({', '.join(p.name for p in paths)}) — "
        f"{len(viols)} violations")
    return viols


def check_spans(device: str = "cpu", log=print) -> list[Violation]:
    paths = span_lint.default_paths()
    viols = span_lint.lint_paths(paths)
    log(f"  {len(paths)} modules linted ({', '.join(p.name for p in paths)}) — "
        f"{len(viols)} violations")
    return viols


SECTIONS = (
    ("Op-trace contracts (gather / host transfer / in-place flush / dtype)",
     check_op_traces, False),
    ("Compile budget (serve-batch bucketing)", check_compile_budget, False),
    ("Kernel budgets (registers / shared memory / spills, shape families)",
     check_kernel_budgets, True),
    ("Mirror-coherence lint", check_mirror, False),
    ("Span-coverage lint (traced Clock charges)", check_spans, False),
)


def run(device: str, log=print) -> tuple[list[Violation], list[str]]:
    """Every section this device can run: (violations, sections not run)."""
    violations: list[Violation] = []
    skipped = []
    for title, fn, card_only in SECTIONS:
        log(f"[{title}]")
        if card_only and device != "cuda":
            log("  needs the card (nvcc's report and the device's limits): not run, "
                "not counted as held")
            skipped.append(title)
            continue
        violations.extend(fn(device, log))
    return violations, skipped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: the card (raises without one)")
    ap.add_argument("-q", action="store_true", help="print violations only")
    args = ap.parse_args(argv)
    import torch
    device = args.device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch.analysis.check: no CUDA device available; "
                               "pass --device cpu to check on the CPU")
        device = "cuda"
    torch.set_num_threads(1)
    log = (lambda *a, **k: None) if args.q else print
    violations, skipped = run(device, log)
    if violations:
        print(f"\nFAIL: {len(violations)} contract violation(s)", file=sys.stderr)
        for v in violations:
            print(str(v), file=sys.stderr)
        return 1
    held = f"\nOK: every section run holds on {device}"
    log(held + (f" ({len(skipped)} not run: {'; '.join(skipped)})" if skipped else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
