"""Per-kernel register and shared-memory budgets on the H100.

The counterpart of ``repro.analysis.vmem``. A Pallas kernel that
overflows VMEM fails when it is compiled for the TPU, which the
reference's interpret-mode tests never do, so ``vmem`` estimates every
kernel's VMEM and SMEM footprint from its BlockSpecs. A CUDA kernel has
other limits: the registers of a block (registers a thread × threads a
block ≤ 65,536 on an SM) and the shared memory of a block (static + dynamic
≤ ``shared_memory_per_block_optin``, 227 KB on the H100), and a kernel that
spills registers to local memory still runs, slower. ``nvcc`` knows the
first and the static part of the second exactly: ``kernels/_build.py``
compiles with ``-Xptxas -v`` and keeps its report in
``build/repro_torch/<hash>/build.log`` (``build_log``). This module:

* parses that report (``parse_ptxas``): each entry function's registers,
  static shared memory, stack and spill bytes, by source file;
* checks them against the limits (``budget_violations``): registers ×
  ``MAX_THREADS`` (each entry's largest block, from its
  ``__launch_bounds__`` or launch) ≤ 65,536; static + dynamic shared
  memory ≤ the card's opt-in limit; no spill unless ``SPILL_REASONS``
  names why;
* launches each cache kernel once at the reference's shape families
  (``SHAPE_FAMILIES``, the families of ``repro/analysis/vmem.py``'s
  sweep), fp32 and int8, against its plain version (``sweep``), and
  reports each launch's dynamic shared memory, computed by the launch's
  own formula (``dynamic_smem``: ``frontier_hop``'s stage plan,
  ``gather_scores``' row slots; ``flat_topk`` and ``scatter_rows`` use
  none).

The report and the limits need the card (``nvcc`` and the device's
properties); the parser and the checks are plain Python, tested on a
report written in the test.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from pathlib import Path

from repro_torch.analysis.contracts import Violation

REGS_PER_SM = 65_536            # 32-bit registers a block may use on sm_90
SCORE_ATOL = 1e-4               # fp32 scores of unit rows: kernel and plain sum in other orders

# Each entry function's largest block (threads), from its source.
MAX_THREADS = {
    "frontier_hop_kernel": 256,         # kHopThreads
    "gather_scores_kernel": 512,        # kGroupThreads: up to 16 query warps
    "flat_topk_partial_kernel": 128,    # 32 * kWarps
    "flat_topk_reduce_kernel": 256,     # 32 * warps_per_block
    "scatter_rows_kernel": 256,         # kScatterThreads
    "flash_kernel": 256,                # kFlashWarps * 32
    "flash_wgmma_kernel": 128,          # one warpgroup
    "decode_kernel": 256,               # kDecWarps * 32
    "combine_kernel": 256,              # DH threads, dh <= 256
    "mamba_scan_kernel": 128,           # kThreads
    "mamba_step_kernel": 128,           # kThreads
    "moe_route_kernel": 256,            # kThreads (moe_fused.cu)
    "moe_dispatch_kernel": 256,         # kThreads
    "swiglu_cast_kernel": 256,          # kThreads
    "moe_combine_kernel": 256,          # kThreads
}

# chip_smoke's kernel rows -> (source file, entry functions) in the report.
KERNEL_ENTRIES = {
    "frontier_hop": ("frontier_hop.cu", ("frontier_hop_kernel",)),
    "gather_scores": ("gather_scores.cu", ("gather_scores_kernel",)),
    "gather_scores_masked": ("gather_scores.cu", ("gather_scores_kernel",)),
    "flat_topk": ("flat_topk.cu", ("flat_topk_partial_kernel", "flat_topk_reduce_kernel")),
    "scatter_rows": ("scatter_rows.cu", ("scatter_rows_kernel",)),
    "flash_attention": (("flash_attention.cu", "flash_attention_wgmma.cu"),
                        ("flash_kernel", "flash_wgmma_kernel")),
    "decode_attention": ("decode_attention.cu", ("decode_kernel", "combine_kernel")),
    "mamba_scan": ("mamba_scan.cu", ("mamba_scan_kernel", "mamba_step_kernel")),
}

# Entry functions allowed to spill (by mangled name, so another instance
# of the same template still may not), with the reason. From the H100
# build's report (PERF.md §6); each is perf work, not a fault.
SPILL_REASONS: dict[str, str] = {
    "_ZN11repro_torch4attn2wg18flash_wgmma_kernelILi256EEEvNS1_6ParamsE":
        "dh 256 (gemma2's heads): the output accumulator alone is 128 fp32 "
        "registers a thread (o[DH / 2]) beside the score tile; at the 255-register "
        "cap 192 B spill. The dh 64 and 128 instances do not spill",
    "_ZN11repro_torch4topk24flat_topk_partial_kernelILb0ELb0EEEvPKvPKhPKiPKfS9_S7_PfPixii":
        "the slice walk for d > 384 (fp32): 16 B spill beside an 8 B stack frame. "
        "The d <= 384 instances, the cache's, do not spill",
    "_ZN11repro_torch4topk24flat_topk_partial_kernelILb1ELb0EEEvPKvPKhPKiPKfS9_S7_PfPixii":
        "the slice walk for d > 384 (int8): 16 B spill beside an 8 B stack frame",
    "_ZN11repro_torch5mamba17mamba_scan_kernelIfLi8EEEvPKT_PKfS6_S6_S6_S6_S6_PS2_Pfii":
        "state width N 8 (fp32 x): 16 B spill beside an 8 B stack frame. The N 16 "
        "instances (falcon-mamba's and jamba's) do not spill",
    "_ZN11repro_torch5mamba17mamba_scan_kernelI13__nv_bfloat16Li8EEEvPKT_PKfS7_S7_S7_S7_S7_PS3_Pfii":
        "state width N 8 (bf16 x): 16 B spill beside an 8 B stack frame",
}

# The reference's shape families (repro/analysis/vmem.py's sweep), d 384.
SHAPE_FAMILIES = (
    *(("flat_topk", dict(N=N, B=B)) for N in (4096, 65536, 1 << 20) for B in (8, 128)),
    *(("gather_scores", dict(N=65536, B=B, K=K)) for B, K in ((8, 256), (128, 1024))),
    *(("gather_scores_masked", dict(N=65536, B=B, K=K)) for B, K in ((8, 256), (128, 1024))),
    *(("frontier_hop", dict(N=65536, B=B, F=32, M=32)) for B in (8, 128)),
    *(("scatter_rows", dict(N=65536, R=R)) for R in (8, 1024, 8192)),
)
DTYPES = ("float32", "int8")


@dataclass
class KernelResources:
    """One entry function's line of the ``-Xptxas -v`` report."""
    source: str
    entry: str                 # the mangled name
    name: str                  # its function name (templates folded)
    registers: int = 0
    smem_static: int = 0
    stack_bytes: int = 0
    spill_bytes: int = 0       # spill stores + spill loads


_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_PROPS_RE = re.compile(r"Function properties for (\S+)")
_FRAME_RE = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads")
_USED_RE = re.compile(r"Used (\d+) registers")
_SMEM_RE = re.compile(r"(\d+) bytes smem")
_SOURCE_RE = re.compile(r"^== (\S+\.cu) \(rc")


def function_name(mangled: str) -> str:
    """The function's own name in an Itanium-mangled symbol
    (``_ZN11repro_torch19frontier_hop_kernelE7HopArgs`` ->
    ``frontier_hop_kernel``); an unmangled name as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    s, pos, last = mangled[2:], 0, mangled
    if s.startswith("N"):
        pos = 1
    while pos < len(s) and s[pos].isdigit():
        m = re.match(r"\d+", s[pos:])
        n = int(m.group())
        pos += len(m.group())
        last = s[pos:pos + n]
        pos += n
        if not mangled[2:].startswith("N"):
            break
    return last


def parse_ptxas(text: str) -> list[KernelResources]:
    """Every entry function of a ``build.log`` (``nvcc -Xptxas -v``
    output, one ``== <file> (rc N)`` section a source)."""
    out: list[KernelResources] = []
    source, cur, props = "", None, None
    frames: dict[str, tuple] = {}
    for line in text.splitlines():
        m = _SOURCE_RE.match(line.strip())
        if m:
            source, cur, props = m.group(1), None, None
            continue
        m = _ENTRY_RE.search(line)
        if m:
            cur = KernelResources(source, m.group(1), function_name(m.group(1)))
            out.append(cur)
            continue
        m = _PROPS_RE.search(line)
        if m:
            props = m.group(1)
            continue
        m = _FRAME_RE.search(line)
        if m and props:
            frames[(source, props)] = tuple(int(x) for x in m.groups())
            continue
        m = _USED_RE.search(line)
        if m and cur is not None:
            cur.registers = int(m.group(1))
            s = _SMEM_RE.search(line)
            cur.smem_static = int(s.group(1)) if s else 0
    for k in out:
        stack, stores, loads = frames.get((k.source, k.entry), (0, 0, 0))
        k.stack_bytes, k.spill_bytes = stack, stores + loads
    return out


def build_log() -> Path:
    """The ``build.log`` of the kernels as the sources stand (built on the
    card by ``kernels._build.build``)."""
    from repro_torch.kernels import _build
    return _build.BUILD_ROOT / _build._source_hash() / "build.log"


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def dynamic_smem(kernel: str, shape: dict, dtype: str, d: int = 384) -> int:
    """A launch's dynamic shared memory (bytes), by the launch's own
    formula: ``frontier_hop``'s ``_stage_plan`` (``csrc/frontier_hop.cu``'s
    ``HopLayout``), ``gather_scores``' slots (group × slot,
    ``csrc/gather_scores.cu:launch_gather``); ``flat_topk`` and
    ``scatter_rows`` launch with none."""
    itemsize = 1 if dtype == "int8" else 4
    if kernel == "frontier_hop":
        from repro_torch.kernels import frontier_hop as fh
        return fh._stage_plan(d, shape["M"], itemsize)["smem_bytes"]
    if kernel in ("gather_scores", "gather_scores_masked"):
        slot = _round16(d * itemsize)
        group = min(16, shape["B"], max(1, 128 * 1024 // slot))
        return group * slot
    return 0


def budget_violations(resources: list[KernelResources], smem_limit: int, *,
                      dynamic: dict | None = None,
                      spill_reasons: dict | None = None) -> list[Violation]:
    """Each entry function against the card's limits. ``dynamic`` maps an
    entry's name to the most dynamic shared memory a launch of it asks
    for (0 where absent); ``spill_reasons`` names the entries allowed to
    spill, by mangled or function name (default ``SPILL_REASONS``)."""
    dynamic = dynamic or {}
    reasons = SPILL_REASONS if spill_reasons is None else spill_reasons
    out = []
    for k in resources:
        target = f"{k.source}:{k.name}"
        threads = MAX_THREADS.get(k.name)
        if threads is None:
            out.append(Violation("RegisterBudget", target,
                                 "entry function with no block size in MAX_THREADS",
                                 k.entry))
        elif k.registers * threads > REGS_PER_SM:
            out.append(Violation(
                "RegisterBudget", target,
                f"{k.registers} registers × {threads} threads = "
                f"{k.registers * threads} > {REGS_PER_SM}: the block cannot launch",
                k.entry))
        smem = k.smem_static + dynamic.get(k.name, 0)
        if smem > smem_limit:
            out.append(Violation(
                "SharedMemoryBudget", target,
                f"{k.smem_static} static + {dynamic.get(k.name, 0)} dynamic = {smem} "
                f"bytes of shared memory > the block's {smem_limit}", k.entry))
        if k.spill_bytes and k.entry not in reasons and k.name not in reasons:
            out.append(Violation(
                "SpillBudget", target,
                f"{k.spill_bytes} bytes of register spills and no reason in "
                f"SPILL_REASONS", k.entry))
    return out


def kernel_resources(resources: list[KernelResources], kernel: str) -> dict:
    """chip_smoke's row fields for ``kernel``: the most registers, static
    shared memory and spill bytes over its entry functions."""
    files, names = KERNEL_ENTRIES[kernel]
    files = (files,) if isinstance(files, str) else files
    ks = [k for k in resources if k.source in files and k.name in names]
    if not ks:
        raise KeyError(f"{kernel}: no entry of {names} in the report of {files}")
    return {"registers": max(k.registers for k in ks),
            "smem_static": max(k.smem_static for k in ks),
            "spill_bytes": max(k.spill_bytes for k in ks)}


# ---------------------------------------------------------------------------
# On the card: one launch per shape family against its plain version.
# ---------------------------------------------------------------------------

def _table(gen, N: int, d: int, dtype: str, device):
    import torch
    x = torch.randn((N, d), generator=gen, device=device)
    x = x / x.norm(dim=1, keepdim=True)
    if dtype == "float32":
        return x, None
    scale = (x.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    return torch.round(x / scale[:, None]).clamp(-127, 127).to(torch.int8), scale


def _err(a, b) -> float:
    """Largest |a - b| over finite entries; infinities must agree."""
    import torch
    fin = torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), fin) or not torch.equal(a[~fin], b[~fin]):
        return math.inf
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def launch_family(kernel: str, shape: dict, dtype: str, device, *, d: int = 384,
                  seed: int = 0) -> float:
    """One launch of ``kernel``'s wrapper at ``shape`` and ``dtype`` on
    ``device`` against its plain version on the same inputs: the largest
    score error (ids and scattered tables must be equal; ``inf`` where they
    are not)."""
    import torch

    from repro_torch.kernels import flat_topk as ft
    from repro_torch.kernels import frontier_hop as fh
    from repro_torch.kernels import gather_scores as gs
    from repro_torch.kernels import ref
    from repro_torch.kernels import scatter_update as su
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    N = shape["N"]
    table, scales = _table(gen, N, d, dtype, device)

    def ints(low, high, size):
        return torch.randint(low, high, size, generator=gen, device=device,
                             dtype=torch.int32)

    def queries(B):
        q = torch.randn((B, d), generator=gen, device=device)
        return q / q.norm(dim=1, keepdim=True)

    if kernel == "flat_topk":
        B = shape["B"]
        valid = torch.rand((N,), generator=gen, device=device) < 0.9
        cats, q, qc = ints(0, 4, (N,)), queries(B), ints(-1, 4, (B,))
        got_s, got_i = ft.flat_topk(table, valid, q, cats, qc, scales)
        want_s, want_i = ft.flat_topk_plain(table, valid, q, cats, qc, scales)
        err = _err(got_s, want_s)
        # a differing id is a tie: its own plain score equals the best
        differ = got_i != want_i
        if differ.any():
            rows = ref.gather_scores_ref(table, got_i[:, None], q, scales)[:, 0]
            err = max(err, _err(rows[differ], want_s[differ]))
        return err
    if kernel in ("gather_scores", "gather_scores_masked"):
        B, K = shape["B"], shape["K"]
        idx = ints(-1, N, (B, K))
        q = queries(B)
        if kernel == "gather_scores":
            return _err(gs.gather_scores(table, idx, q, scales),
                        gs.gather_scores_plain(table, idx, q, scales))
        cats, qc = ints(0, 4, (N,)), ints(-1, 4, (B,))
        return _err(gs.gather_scores_masked(table, idx, q, cats, qc, scales),
                    gs.gather_scores_masked_plain(table, idx, q, cats, qc, scales))
    if kernel == "frontier_hop":
        B, F, M = shape["B"], shape["F"], shape["M"]
        nbrs = ints(-1, N, (N, M))
        meta = torch.where(torch.rand((N,), generator=gen, device=device) < 0.9,
                           ints(0, 4, (N,)), ref.TOMBSTONE).to(torch.int32)
        args = (table, nbrs, meta, ints(-1, N, (B, F)), queries(B), ints(-1, 4, (B,)),
                ints(0, 2, (B,)), scales)
        got, want = fh.frontier_hop(*args), ref.frontier_hop_ref(*args)
        if not torch.equal(got[0], want[0]):
            return math.inf
        return max(_err(got[1], want[1]), _err(got[2], want[2]))
    if kernel == "scatter_rows":
        R = shape["R"]
        rows = torch.randperm(N, generator=gen, device=device)[:R].to(torch.int32)
        vals, _ = _table(gen, R, d, dtype, device)
        got = su.scatter_rows(table.clone(), rows, vals)
        want = su.scatter_rows_plain(table.clone(), rows, vals)
        return 0.0 if torch.equal(got, want) else math.inf
    raise KeyError(kernel)


def sweep(device, *, families=SHAPE_FAMILIES, dtypes=DTYPES, d: int = 384) -> list[dict]:
    """Every shape family in every dtype, launched once on ``device``
    against its plain version: one row each (kernel, shape, dtype, error,
    the launch's dynamic shared memory)."""
    rows = []
    for i, (kernel, shape) in enumerate(families):
        for dtype in dtypes:
            rows.append(dict(kernel=kernel, shape=shape, dtype=dtype,
                             max_abs_err=launch_family(kernel, shape, dtype, device,
                                                       d=d, seed=i),
                             dynamic_smem=dynamic_smem(kernel, shape, dtype, d)))
    return rows


def check_kernels(device, log_text: str | None = None, *, log=print
                  ) -> tuple[list[Violation], list[KernelResources], list[dict]]:
    """The whole budget section on the card: the build report against the
    device's limits (each entry's dynamic shared memory the most the sweep
    asked for) and the sweep against the plain versions (``SCORE_ATOL``).
    Returns (violations, resources, sweep rows)."""
    import torch
    text = build_log().read_text() if log_text is None else log_text
    resources = parse_ptxas(text)
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    rows = sweep(device)
    dynamic: dict[str, int] = {}
    for r in rows:
        for name in KERNEL_ENTRIES[r["kernel"]][1]:
            dynamic[name] = max(dynamic.get(name, 0), r["dynamic_smem"])
    viols = budget_violations(resources, limit, dynamic=dynamic)
    for r in rows:
        if not r["max_abs_err"] <= SCORE_ATOL:
            viols.append(Violation("KernelSweep", f"{r['kernel']}[{r['dtype']}] {r['shape']}",
                                   f"kernel against its plain version: max abs err "
                                   f"{r['max_abs_err']} > {SCORE_ATOL} (inf: ids or "
                                   f"tables differ)"))
    log(f"  {len(resources)} entry functions, smem opt-in limit {limit} B; "
        f"{len(rows)} launches at the reference's shape families, largest error "
        f"{max(r['max_abs_err'] for r in rows):.3g}, most dynamic smem "
        f"{max(r['dynamic_smem'] for r in rows)} B — {len(viols)} violations")
    return viols, resources, rows
