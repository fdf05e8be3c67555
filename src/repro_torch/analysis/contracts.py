"""Static hot-path contract checker: rules over a torch op trace.

The counterpart of ``repro.analysis.contracts``, which states its rules
over jaxprs and optimized HLO. The port has no compiled program to parse:
what runs is the sequence of aten ops that a search or a flush issues, and
on the card the CUDA graph captured from exactly that sequence
(``core/graphs.py``). So the target here is an **op trace**: every aten op
the function dispatches, with its output shapes, dtypes and devices, taken
by a ``TorchDispatchMode`` (``OpRecorder``). The function recorded is the
one ``CapturedProgram`` captures: the flat and beam classified searches of
``core/hnsw.py``, and the delta flush ``_flush_device_tables``. On the CPU
it runs eagerly on the same static buffers, on the card it is the capture's
warm-up, so the same trace is taken on both.

**Kernel wrappers are opaque.** Each ``kernels/ops.py`` wrapper
(``KERNEL_WRAPPERS``) is recorded as ONE op with its inputs and outputs,
as a Pallas custom call is one opaque op in HLO: the plain version it runs
on the CPU, and whatever it allocates on the card, stay out of the trace.

The reference's five rules, stated over the trace:

* **NoMaterializedGather**: no op outside a wrapper yields ≥ B·K·d
  elements, K the candidates a search scores per query (F·M for a hop, N
  for a flat scan): candidate rows move inside the kernels, never as a
  materialized (B, K, d) gather.
* **NoHostTransfer**: no ``aten._local_scalar_dense`` (``.item()``), no
  copy between devices beyond the trace's declared uploads (a flush's
  packed delta and the HNSW entry set), and no op whose output shape depends on the data
  (``nonzero``, boolean-mask indexing, ``unique``, ...). On the card the
  searches also run under ``torch.cuda.set_sync_debug_mode("error")``.
* **InPlaceFlush** (the counterpart of ``DonationHonored``): every device
  table's ``data_ptr()`` is unchanged across a delta flush, and no op of
  the flush yields a whole table.
* **DtypeDiscipline**: an int8 trace hands the wrappers an int8 table and
  no fp32 one, and no op yields a float tensor of ≥ N·d elements (an fp32
  copy of the int8 table).
* **CompileBudget**: one captured program per batch bucket per shard
  (``CompileCensus``, from ``index.programs.captures`` on the card and
  ``search_stats["compilations"]`` everywhere).

Every rule is a pure function of its target: nothing is timed.
``python -m repro_torch.analysis.check`` applies them to the real hot
paths; ``tests/test_torch_analysis.py`` holds a seeded violation per rule.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

# The ``kernels/ops.py`` wrappers a trace keeps opaque.
KERNEL_WRAPPERS = ("cache_topk", "hop_scores", "frontier_hop", "scatter_rows",
                   "scatter_flush", "flash_attention", "decode_attention", "mamba_scan",
                   "moe_route", "moe_dispatch", "swiglu_cast", "moe_combine")

# Ops whose output shape depends on the data: on the card each needs the
# host to learn a size, so none may sit inside a captured program.
_DATA_DEPENDENT = ("nonzero", "masked_select", "unique", "_unique", "repeat_interleave",
                   "argwhere", "bincount", "histc")
_COPIES = ("aten._to_copy", "aten.copy_", "aten._copy_from", "aten.to.")
_FLOAT = ("float32", "float64", "float16", "bfloat16")


# ---------------------------------------------------------------------------
# Targets.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Violation:
    """One broken contract: which rule, on which target, and the evidence
    a reviewer needs to locate the regression."""
    rule: str
    target: str
    message: str
    evidence: str = ""

    def __str__(self) -> str:
        ev = f"\n      {self.evidence}" if self.evidence else ""
        return f"[{self.rule}] {self.target}: {self.message}{ev}"


@dataclass(frozen=True)
class TensorInfo:
    shape: tuple
    dtype: str
    device: str

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * _itemsize(self.dtype)


@dataclass
class OpRecord:
    """One recorded op: an aten op (``aten.mm.default``) or an opaque kernel
    wrapper (``kernel:frontier_hop``) with its tensor inputs and outputs."""
    name: str
    inputs: tuple = ()
    outputs: tuple = ()
    bool_index: bool = False      # aten.index with a boolean mask
    params: dict = field(default_factory=dict)   # a kernel call's scalar arguments

    @property
    def kernel(self) -> bool:
        return self.name.startswith("kernel:")

    def __str__(self) -> str:
        ins = ", ".join(f"{t.dtype}{list(t.shape)}@{t.device}" for t in self.inputs)
        outs = ", ".join(f"{t.dtype}{list(t.shape)}@{t.device}" for t in self.outputs)
        return f"{self.name}({ins}) -> ({outs})"


@dataclass
class OpTrace:
    """One hot-path function as a static-analysis target. ``meta`` carries
    the structural facts the rules check against:

      B, K, d       padded batch, candidates per query, embedding width
      capacity      index capacity (full-table row count)
      emb_dtype     "float32" | "int8" (selects DtypeDiscipline)
      uploads       host-to-device copies the function may make (a
                    flush's packed delta and the HNSW entry set; 0 for
                    a search)
      tables        name -> shape of every device table (a flush)
      ptrs_before / ptrs_after   name -> data_ptr across a flush
    """
    name: str
    ops: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)


@dataclass
class CompileCensus:
    """Captured programs per shard index over a batch-size sweep. Bucketing's
    contract: each family holds ``expected`` programs however many batch
    sizes it served."""
    name: str
    families: dict = field(default_factory=dict)
    expected: int = 1


# ---------------------------------------------------------------------------
# Recording.
# ---------------------------------------------------------------------------

def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def _tensors(tree) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _infos(tree) -> tuple:
    return tuple(TensorInfo(tuple(t.shape), str(t.dtype).removeprefix("torch."),
                            str(t.device)) for t in _tensors(tree))


class OpRecorder(TorchDispatchMode):
    """Record every aten op dispatched while active (``ops``). Kernel
    wrappers patched by ``opaque_kernels`` add themselves as one op each
    and run with every dispatch mode suspended, so nothing inside them is
    recorded."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        bool_index = name.startswith("aten.index.") and any(
            isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
            for t in (args[1] if len(args) > 1 and isinstance(args[1], (list, tuple))
                      else ()))
        self.ops.append(OpRecord(name, _infos((args, kwargs)), _infos(out), bool_index))
        return out

    def add_kernel(self, name: str, args, kwargs, out) -> None:
        self.ops.append(OpRecord(f"kernel:{name}", _infos((args, kwargs)), _infos(out),
                                 params=_scalars(kwargs)))


def _scalars(kwargs: dict) -> dict:
    return {k: v for k, v in kwargs.items()
            if v is None or isinstance(v, (bool, int, float, str))}


class _MetaKernel(torch.autograd.Function):
    """An opaque call on "meta" tensors under autograd: forward its
    contract's output shapes, backward "meta" gradients for every float
    input and one ``kernel:<name>.backward`` record."""

    @staticmethod
    def forward(ctx, run, record_backward, *tensors):
        ctx.record_backward = record_backward
        ctx.infos = [(t.shape, t.dtype, t.device, t.is_floating_point()) for t in tensors]
        return run()

    @staticmethod
    def backward(ctx, *grads):
        ctx.record_backward()
        return (None, None, *[torch.empty(s, dtype=dt, device=dev) if fl else None
                              for s, dt, dev, fl in ctx.infos])


def opaque_call(rec: OpRecorder, name: str, run, tensors: list, params: dict):
    """Record one opaque call on "meta" tensors: ``run()`` gives its
    outputs; under autograd (an input that requires grad) it goes through
    ``_MetaKernel``, so the ops around it still get their gradients, and
    its backward is recorded as ``kernel:<name>.backward``."""
    infos = _infos(tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        def record_backward():
            rec.ops.append(OpRecord(f"kernel:{name}.backward", infos, (), params=params))
        out = _MetaKernel.apply(run, record_backward, *tensors)
    else:
        with torch.no_grad():
            out = run()
    rec.ops.append(OpRecord(f"kernel:{name}", infos, _infos(out), params=params))
    return out


def _meta_out(name: str, args, kwargs):
    """A wrapper's outputs on "meta" tensors, by its contract (the kernels
    take no "meta" tensor): the op-cost counter's shapes."""
    def empty(shape, dtype, like):
        return torch.empty(shape, dtype=dtype, device=like.device)
    a = args
    if name == "cache_topk":
        B = a[2].shape[0]
        return empty((B,), torch.float32, a[0]), empty((B,), torch.int32, a[0])
    if name == "hop_scores":
        return empty(tuple(a[1].shape), torch.float32, a[0])
    if name == "frontier_hop":
        B, F = a[3].shape
        n = F * a[1].shape[1]
        return (empty((B, n), torch.int32, a[0]), empty((B, n), torch.float32, a[0]),
                empty((B, n), torch.float32, a[0]))
    if name == "scatter_rows":
        return a[0]
    if name == "scatter_flush":
        return None
    if name == "flash_attention":
        return torch.empty_like(a[0])
    if name == "decode_attention":
        out = torch.empty_like(a[0])
        if kwargs.get("return_lse"):
            return out, empty(tuple(a[0].shape[:2]), torch.float32, a[0])
        return out
    if name == "mamba_scan":
        x, A = a[0], a[2]
        return torch.empty_like(x), empty((x.shape[0], x.shape[2], A.shape[1]),
                                          torch.float32, x)
    if name == "moe_route":
        T, k = a[0].shape[0], a[2]
        return empty((T, k), torch.int32, a[0]), empty((T, k), torch.float32, a[0])
    if name == "moe_dispatch":
        ids, x = a[0], a[1]
        N = ids.numel()
        return (empty((N,), torch.int32, x), empty((a[2],), torch.int32, x),
                empty((N, x.shape[1]), x.dtype, x))
    if name == "swiglu_cast":
        return empty(tuple(a[0].shape), a[2], a[0])
    if name == "moe_combine":
        part, w = a[0], a[2]
        return empty((w.shape[0], part.shape[1]), part.dtype, part)
    raise KeyError(name)


@contextlib.contextmanager
def opaque_kernels(recorder: OpRecorder, extra: dict | None = None):
    """Patch every ``kernels/ops.py`` wrapper so that a call records itself
    on ``recorder`` as one op and runs with the dispatch modes suspended;
    on "meta" tensors (which no kernel takes) it returns outputs of its
    contract's shapes through ``opaque_call``. ``extra`` maps (module,
    attribute) -> a replacement that records itself (the op-cost
    counter's MoE FFN)."""
    from repro_torch.kernels import ops
    saved = {(ops, n): getattr(ops, n) for n in KERNEL_WRAPPERS}
    saved.update({key: getattr(*key) for key in (extra or {})})

    def wrap(name, real):
        def call(*args, **kwargs):
            tensors = _tensors((args, kwargs))
            if any(t.is_meta for t in tensors):
                return opaque_call(recorder, name, lambda: _meta_out(name, args, kwargs),
                                   tensors, _scalars(kwargs))
            with _disable_current_modes():
                out = real(*args, **kwargs)
            recorder.add_kernel(name, args, kwargs, out)
            return out
        return call

    for n in KERNEL_WRAPPERS:
        setattr(ops, n, wrap(n, saved[(ops, n)]))
    for (mod, attr), fn in (extra or {}).items():
        setattr(mod, attr, fn)
    try:
        yield recorder
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


@contextlib.contextmanager
def recording():
    """``with recording() as rec:`` — every aten op in ``rec.ops``, the
    kernel wrappers opaque."""
    rec = OpRecorder()
    with opaque_kernels(rec), rec:
        yield rec


# ---------------------------------------------------------------------------
# Rule framework.
# ---------------------------------------------------------------------------

class Rule:
    """One hot-path contract. ``target_kind`` selects which targets the
    rule sees; ``check`` returns the violations (empty = contract holds)."""

    name = "Rule"
    target_kind: type = OpTrace

    def check(self, target) -> list[Violation]:
        raise NotImplementedError

    def _v(self, target, message: str, evidence: str = "") -> Violation:
        return Violation(self.name, target.name, message, evidence)


def run_rules(targets, rules=None) -> list[Violation]:
    """Apply every rule to every target it understands."""
    rules = DEFAULT_RULES if rules is None else rules
    out: list[Violation] = []
    for t in targets:
        for r in rules:
            if isinstance(t, r.target_kind):
                out.extend(r.check(t))
    return out


# ---------------------------------------------------------------------------
# Rules.
# ---------------------------------------------------------------------------

class NoMaterializedGather(Rule):
    """No op outside a kernel wrapper yields ≥ B·K·d elements: candidate
    rows round-tripping through device memory as a (B, K, d) tensor are
    exactly what the frontier-hop and flat_topk kernels exist to avoid."""

    name = "NoMaterializedGather"

    def check(self, trace: OpTrace) -> list[Violation]:
        m = trace.meta
        limit = int(m.get("B", 0)) * int(m.get("K", 0)) * int(m.get("d", 0))
        if not limit:
            return []
        out = []
        for op in trace.ops:
            if op.kernel:
                continue
            for t in op.outputs:
                if t.numel >= limit:
                    out.append(self._v(
                        trace, f"materialized {t.dtype}{list(t.shape)} ({t.numel} elements "
                        f">= B·K·d = {limit}) — candidate rows must move inside the "
                        f"kernels, not as a gathered tensor", str(op)[:200]))
        return out


class NoHostTransfer(Rule):
    """No host round trip inside a hot-path function: no ``.item()``
    (``_local_scalar_dense``), no copy between devices beyond the declared
    uploads, no op whose output shape depends on the data."""

    name = "NoHostTransfer"

    def check(self, trace: OpTrace) -> list[Violation]:
        allowed = int(trace.meta.get("uploads", 0))
        out = []
        for op in trace.ops:
            base = op.name.split(".")[1] if op.name.startswith("aten.") else ""
            if base == "_local_scalar_dense":
                out.append(self._v(trace, "host sync '_local_scalar_dense' (.item()) on "
                                   "the hot path", str(op)[:200]))
            elif op.bool_index or any(base == n or base.startswith(n + "_")
                                      for n in _DATA_DEPENDENT):
                out.append(self._v(trace, f"data-dependent output shape ('{op.name}') on "
                                   f"the hot path: the host must learn its size",
                                   str(op)[:200]))
            elif op.name.startswith(_COPIES) and len(
                    {t.device for t in op.inputs + op.outputs}) > 1:
                # an upload: a host source, and every output off the host
                if allowed > 0 and any(t.device == "cpu" for t in op.inputs) and \
                        all(t.device != "cpu" for t in op.outputs):
                    allowed -= 1
                    continue
                out.append(self._v(trace, f"copy between devices ('{op.name}') on the "
                                   f"hot path", str(op)[:200]))
        return out


class InPlaceFlush(Rule):
    """A delta flush writes the device tables in place: each table's
    storage is the same before and after it, and no op of the flush yields
    a whole table (a copy of O(capacity·d) bytes every sync, the cost
    delta sync exists to avoid)."""

    name = "InPlaceFlush"

    def check(self, trace: OpTrace) -> list[Violation]:
        m = trace.meta
        if "ptrs_before" not in m:
            return []
        out = []
        for k, ptr in m["ptrs_before"].items():
            if m["ptrs_after"].get(k) != ptr:
                out.append(self._v(trace, f"table '{k}' has a new storage after the "
                                   f"flush — the delta flush copied it instead of "
                                   f"writing it in place",
                                   f"data_ptr {ptr:#x} -> {m['ptrs_after'].get(k)}"))
        shapes = {tuple(s) for s in m.get("tables", {}).values()}
        for op in trace.ops:
            if op.kernel:
                continue
            for t in op.outputs:
                if t.shape in shapes:
                    out.append(self._v(trace, f"op yields a whole table "
                                       f"{t.dtype}{list(t.shape)} inside the flush",
                                       str(op)[:200]))
        return out


class DtypeDiscipline(Rule):
    """An int8 trace keeps the int8 table int8: the wrappers get the int8
    table (and never an fp32 (N, d) one), and no op yields a float tensor
    of ≥ N·d elements — a silent fp32 rematerialization of the table
    before the dot (the dequant stays fused inside the kernels)."""

    name = "DtypeDiscipline"

    def check(self, trace: OpTrace) -> list[Violation]:
        m = trace.meta
        if m.get("emb_dtype") != "int8":
            return []
        cap, d = int(m.get("capacity", 0)), int(m.get("d", 0))
        out = []
        kernels = [op for op in trace.ops if op.kernel]
        table = (cap, d)
        if kernels and not any(t.dtype == "int8" and t.shape == table
                               for op in kernels for t in op.inputs):
            out.append(self._v(trace, "quantized trace hands no kernel the int8 table — "
                               "the int8 resident tier is not on this hot path",
                               "; ".join(str(op)[:120] for op in kernels)))
        for op in trace.ops:
            if op.kernel:
                for t in op.inputs:
                    if t.dtype in _FLOAT and t.shape == table:
                        out.append(self._v(trace, f"kernel gets a {t.dtype} copy of the "
                                           f"table {list(t.shape)}", str(op)[:200]))
                continue
            for t in op.outputs:
                if t.dtype in _FLOAT and cap and d and t.numel >= cap * d:
                    out.append(self._v(
                        trace, f"silent fp32 materialization: {op.name} -> "
                        f"{t.dtype}{list(t.shape)} rebuilds the int8 table as float "
                        f"before the dot", str(op)[:200]))
        return out


class CompileBudget(Rule):
    """One captured program per batch bucket and shard: bucketing pads B
    to powers of two, so B = 1..8 share one program. ``families`` maps a
    shard index to its programs; each must equal ``expected``."""

    name = "CompileBudget"
    target_kind = CompileCensus

    def check(self, census: CompileCensus) -> list[Violation]:
        out = []
        for fam, n in sorted(census.families.items()):
            if n != census.expected:
                out.append(Violation(
                    self.name, census.name,
                    f"family {fam}: {n} programs over the batch sweep (expected "
                    f"{census.expected}) — batch bucketing regressed",
                    f"families: {census.families}"))
        return out


DEFAULT_RULES: tuple[Rule, ...] = (
    NoMaterializedGather(), NoHostTransfer(), InPlaceFlush(), DtypeDiscipline(),
    CompileBudget(),
)


# ---------------------------------------------------------------------------
# Trace collection: the real hot paths.
# ---------------------------------------------------------------------------

def _unit_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def build_index(index_kind: str, emb_dtype: str, *, dim: int = 384,
                capacity: int = 4096, n: int = 64, seed: int = 0, device="cpu"):
    """A small populated index of the production shape family (d 384), as
    the reference's ``build_index``. The HNSW hop is forced to the fused
    path (``ops.frontier_hop``, the kernel on the card), so the CPU trace
    has the structure the card runs."""
    from repro_torch.core.hnsw import FlatIndex, HNSWIndex, HNSWParams
    rng = np.random.default_rng(seed)
    vecs = _unit_rows(rng, n, dim)
    cats = (np.arange(n) % 2).astype(np.int32)
    if index_kind == "flat":
        idx = FlatIndex(dim, capacity, emb_dtype=emb_dtype, device=device)
    else:
        idx = HNSWIndex(dim, capacity,
                        params=HNSWParams(M=4, M0=8, beam=8, max_hops=4, n_entries=4,
                                          emb_dtype=emb_dtype, hop_impl="fused"),
                        seed=seed, device=device)
    idx.add_batch(vecs, cats)
    return idx


@contextlib.contextmanager
def _first_program_recorded(index, rec: OpRecorder, guard=None):
    """Record the first run of the program ``index.programs`` runs or
    captures, under ``guard``: the eager call on the CPU, the capture's
    warm-up on the card (which runs under sync debug "error" already)."""
    programs = index.programs
    real_run, real_capture = programs.run, programs.capture
    state = {"done": False}

    def recorded(fn):
        def call(*views):
            if state["done"]:
                return fn(*views)
            state["done"] = True
            with guard or contextlib.nullcontext(), opaque_kernels(rec), rec:
                return fn(*views)
        return call

    programs.run = lambda key, fn, inputs=(): real_run(key, recorded(fn), inputs)
    programs.capture = lambda key, fn, inputs=(): real_capture(key, recorded(fn), inputs)
    try:
        yield
    finally:
        del programs.run, programs.capture


def record_search(index, *, B: int = 8, seed: int = 0, name: str | None = None,
                  guard=None) -> OpTrace:
    """The index's classified search (the program ``CapturedProgram``
    runs) as an :class:`OpTrace`. The tables are synced first, so the
    trace holds the search alone; ``guard`` (a context manager, e.g. sync
    debug "error" on the card) is held around the program's recorded run."""
    from repro_torch.core import hnsw as H
    rng = np.random.default_rng(seed)
    q = _unit_rows(rng, B, index.dim)
    index.device_tables()
    index.programs.clear()
    rec = OpRecorder()
    with _first_program_recorded(index, rec, guard):
        index.search_classified(q, np.full(B, 0.9, np.float32),
                                categories=(np.arange(B) % 2).astype(np.int32),
                                ttls=np.full(B, 60.0, np.float32), now=0.0)
    Bp = H._bucket_batch(B)
    flat = isinstance(index, H.FlatIndex)
    K = index.capacity if flat else index.p.beam * index.p.M0
    label = "flat_search_classified" if flat else "beam_search_classified"
    return OpTrace(name=name or f"{label}[{index.emb_dtype}]", ops=rec.ops,
                   meta={"B": Bp, "K": K, "d": index.dim, "capacity": index.capacity,
                         "emb_dtype": index.emb_dtype, "uploads": 0})


def record_delta_flush(index, *, rows: int = 8, seed: int = 1,
                       name: str | None = None) -> OpTrace:
    """The delta flush ``_flush_device_tables`` (``index.device_tables()``
    after ``rows`` new rows) as an :class:`OpTrace`, with every table's
    ``data_ptr`` before and after it."""
    tables = index.device_tables()
    ptrs_before = {k: t.data_ptr() for k, t in tables.items()}
    # The row tables (the HNSW entry set, E ids, is rewritten whole at
    # every sync by design: it rides along, ``HNSWIndex._finish_sync``).
    shapes = {k: tuple(t.shape) for k, t in tables.items() if t.shape[0] == index.capacity}
    rng = np.random.default_rng(seed)
    index.add_batch(_unit_rows(rng, rows, index.dim), np.zeros(rows, np.int32))
    full_before = index.sync_stats["full_uploads"]
    with recording() as rec:
        after = index.device_tables()
    if index.sync_stats["full_uploads"] != full_before:
        raise RuntimeError("record_delta_flush: the flush was a full upload")
    # Its uploads: the packed delta, and the HNSW entry set beside it.
    uploads = 2 if "entries" in after else 1
    return OpTrace(name=name or f"delta_flush[{index.emb_dtype}]", ops=rec.ops,
                   meta={"d": index.dim, "capacity": index.capacity,
                         "emb_dtype": index.emb_dtype, "uploads": uploads, "tables": shapes,
                         "ptrs_before": ptrs_before,
                         "ptrs_after": {k: t.data_ptr() for k, t in after.items()}})


def collect_hot_path_traces(index_kind: str, emb_dtype: str, *, dim: int = 384,
                            capacity: int = 4096, seed: int = 0, device="cpu",
                            search_guard=None) -> list[OpTrace]:
    """Every contract target of one {index kind, dtype} cell: the classified
    search (the read hot loop, under ``search_guard``) and the delta flush
    (the write hot loop)."""
    idx = build_index(index_kind, emb_dtype, dim=dim, capacity=capacity, seed=seed,
                      device=device)
    prefix = f"{index_kind}/{emb_dtype}"
    return [record_search(idx, seed=seed, name=f"{prefix}:search_classified",
                          guard=search_guard),
            record_delta_flush(idx, name=f"{prefix}:delta_flush")]


def collect_compile_census(cache, *, batches=(1, 2, 3, 5, 8),
                           name: str = "serve") -> CompileCensus:
    """Drive a (possibly sharded) cache through a serve-batch sweep and
    count each shard index's programs: distinct search signatures
    (``search_stats["compilations"]``) and, on the card, the captures of
    each (``programs.captures``: a program captured twice is a second
    program)."""
    rng = np.random.default_rng(0)
    cats = sorted(cache.policies.categories())
    for B in batches:
        q = _unit_rows(rng, B, cache.dim)
        cache.lookup_batch(q, [cats[i % len(cats)] for i in range(B)])
    shards = getattr(cache, "shards", None) or [cache]
    families = {}
    for si, shard in enumerate(shards):
        index = shard.index
        key = f"{index.__class__.__name__}[{index.emb_dtype}] shard{si}"
        n = index.search_stats["compilations"]
        if index.programs.graphs:
            n = max(n, sum(index.programs.captures.values()))
        families[key] = n
    return CompileCensus(name=name, families=families, expected=1)
