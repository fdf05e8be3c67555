"""Static analysis of the port and its dry-runs (``python -m
repro_torch.analysis.check``): the hot-path contracts as rules over a torch
op trace (``contracts``), the kernels' register and shared-memory budgets
(``smem``), the mirror-coherence and span-coverage AST lints
(``mirror_lint``, ``span_lint``), per-rank FLOP and byte counts
(``op_cost``) and the H100 roofline and its report (``roofline``,
``report``). The counterpart of ``repro.analysis``."""
