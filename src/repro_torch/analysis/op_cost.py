"""Per-rank FLOPs, bytes and collectives of one step, counted op by op.

The counterpart of ``repro.analysis.hlo_cost``, which re-walks optimized
HLO because XLA's ``cost_analysis`` counts a while loop's body once. The
port has no program text: a step is the ops it dispatches, so this module
runs the step on "meta" tensors (nothing is computed or allocated) under
the contracts' ``OpRecorder`` and ``torch.utils.flop_counter``'s
``FlopCounterMode``, and counts every op as it runs. A loop counts each of
its trips, so the reference's while-loop undercount cannot arise.

* **FLOPs**: ``FlopCounterMode``'s count of the aten ops, plus each opaque
  kernel call (``contracts.KERNEL_WRAPPERS``, and the MoE FFN
  ``models.moe.moe_apply``) by the formulas behind chip_smoke.py's bounds
  (``kernel_cost``: ``flash_work``, ``scan_work``, the cache kernels' dots,
  the MoE FFN's routed products). Under autograd a kernel is an opaque
  ``torch.autograd.Function`` on "meta" whose backward counts twice its
  forward (chip_smoke's ``train_step_bound``: attention 4 forward, 8
  backward; the scan once forward, twice backward), so the projections
  around it still get their gradients counted.
* **Bytes**: every op's inputs read and outputs written once (views and
  allocations are free; an in-place indexed write its indices and twice
  its values), the eager counterpart of hlo_cost's fusion-boundary bytes;
  a kernel's by its formula.
* **Collectives**: every c10d op the port's collectives issue on a "fake"
  process group (which accepts "meta" tensors), by kind: the bytes of its
  result (what a rank receives) and the count. The MoE FFN is opaque, so
  its expert-parallel dispatch and combine are added by the plan's rule
  (``moe_collectives``): two all-to-alls of the rank's routed rows.

``step_cost`` counts one step of a cell per rank. To keep full-size cells
tractable it runs the model at 1 and at 2 repeating layer groups
(``transformer.layer_groups``: one layer of each distinct kind in the
config's pattern) at the rank's local shapes and extrapolates linearly:
``cost(G) = cost(1) + (G - 1) · (cost(2) - cost(1))`` — exact, since every
group of a config costs the same. ``tests/test_torch_dryrun.py`` holds the
extrapolation against a whole-model count of a reduced config.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from unittest import mock

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.contracts import (OpRecord, OpRecorder, TensorInfo, opaque_call,
                                            opaque_kernels)

COLLECTIVES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
               "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_":
               "all-gather", "reduce_scatter_": "reduce-scatter",
               "_reduce_scatter_base_": "reduce-scatter", "alltoall_base_": "all-to-all",
               "alltoall_": "all-to-all", "send": "send", "recv_": "recv",
               "broadcast_": "broadcast"}
# Ops that move no bytes: views, metadata and allocations.
FREE_OPS = frozenset({
    "view", "_unsafe_view", "t", "transpose", "permute", "expand", "slice", "select",
    "as_strided", "unsqueeze", "squeeze", "detach", "alias", "lift_fresh", "_reshape_alias",
    "split", "split_with_sizes", "unbind", "narrow", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "unflatten", "view_as_real",
    "view_as_complex", "_local_scalar_dense", "resize_", "set_", "diagonal", "movedim",
    "expand_as", "real", "imag", "chunk", "indices", "values", "is_same_size",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "reshape", "numpy_T",
    "flatten", "mT", "mH", "swapaxes", "adjoint"})
# In-place indexed writes touch the rows they write, not the whole
# destination: the indices and twice the values (read-modify-write), as
# hlo_cost charges a dynamic-update-slice.
INDEXED_WRITES = frozenset({"index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
                            "scatter_reduce_", "index_copy_", "index_add_"})


@dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    bytes_by_dtype: dict = field(default_factory=dict)
    collective_bytes: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    kernel_flops: dict = field(default_factory=dict)

    def add(self, other: "Totals", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for mine, theirs in ((self.bytes_by_dtype, other.bytes_by_dtype),
                             (self.collective_bytes, other.collective_bytes),
                             (self.collective_counts, other.collective_counts),
                             (self.kernel_flops, other.kernel_flops)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v * mult

    def _bytes(self, infos) -> None:
        for t in infos:
            self.bytes += t.nbytes
            self.bytes_by_dtype[t.dtype] = self.bytes_by_dtype.get(t.dtype, 0) + t.nbytes

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_by_dtype": dict(self.bytes_by_dtype),
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "kernel_flops": dict(self.kernel_flops),
                "total_collective_bytes": self.total_collective_bytes}


# ---------------------------------------------------------------------------
# Opaque calls: their costs by formula.
# ---------------------------------------------------------------------------

def _esz(t: TensorInfo) -> int:
    return t.nbytes // max(1, t.numel)


def _attended(Sq: int, Skv: int, causal: bool, window, offset: int) -> int:
    """(query, key) pairs a causal / windowed attention computes."""
    if not causal:
        return Sq * Skv
    pos = np.arange(Sq, dtype=np.int64) + offset + 1
    n = np.minimum(pos, Skv)
    if window:
        n = np.minimum(n, window)
    return int(n.sum())


def kernel_cost(op: OpRecord) -> tuple[float, float]:
    """(FLOPs, bytes) of one opaque call, by the formulas behind
    chip_smoke.py's bounds; a backward (``<name>.backward``) twice its
    forward. "Meta" tensors carry no data, so what depends on it counts
    its most: every hop lane live, every cached row attended (kv_len =
    the cache's length)."""
    name = op.name.removeprefix("kernel:")
    if name.endswith(".backward"):
        f, b = kernel_cost(dataclasses.replace(op, name=op.name.removesuffix(".backward")))
        return 2 * f, 2 * b
    ins, outs, kw = op.inputs, op.outputs, op.params
    if name == "flash_attention":                        # chip_smoke flash_work
        q, k = ins[0], ins[1]
        B, Hq, Sq, dh = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        pairs = _attended(Sq, Skv, kw.get("causal", True), kw.get("window"),
                          kw.get("kv_offset", 0))
        return 4.0 * B * Hq * dh * pairs, _esz(q) * (2 * B * Hq * Sq * dh + 2 * B * Hkv * Skv * dh)
    if name == "decode_attention":                       # every cached row read (kv_len = S)
        q, k = ins[0], ins[1]
        B, Hq, dh = q.shape
        Hkv, S = k.shape[1], k.shape[2]
        rows = min(S, kw.get("window") or S)
        return 4.0 * B * Hq * dh * rows, _esz(q) * (2 * B * Hq * dh + 2 * B * Hkv * rows * dh)
    if name == "mamba_scan":                             # chip_smoke scan_work
        x, A = ins[0], ins[2]
        Bt, L, Dm = x.shape
        N = A.shape[1]
        n = Bt * L * Dm
        with_h0 = len(ins) > 6
        nbytes = (n * (2 * _esz(x) + 4) + 2 * Bt * L * N * 4 + Dm * (N + 1) * 4
                  + Bt * Dm * N * 4 * (2 if with_h0 else 1))
        return 7.0 * n * N, nbytes
    if name == "cache_topk":                             # every row scored
        table, q = ins[0], ins[2]
        N, d = table.shape
        return 2.0 * q.shape[0] * N * d, sum(t.nbytes for t in ins + outs)
    if name == "hop_scores":                             # B·K rows gathered
        table, idx = ins[0], ins[1]
        B, K = idx.shape
        d = table.shape[1]
        return 2.0 * B * K * d, B * K * (d * _esz(table) + 4) + ins[2].nbytes + outs[0].nbytes
    if name == "frontier_hop":                           # B·F·M candidate rows
        emb, nbrs, frontier = ins[0], ins[1], ins[3]
        B, F = frontier.shape
        M, d = nbrs.shape[1], emb.shape[1]
        cand = B * F * M
        return 2.0 * cand * d, cand * (d * _esz(emb) + 8) + sum(t.nbytes for t in outs)
    if name in ("scatter_rows", "scatter_flush"):        # staged rows read, then written
        staged = ins[-1] if name == "scatter_flush" else ins[2]
        return 0.0, 2.0 * staged.nbytes
    if name == "moe_ffn":
        return moe_cost(op)
    return 0.0, sum(t.nbytes for t in ins + outs)


def moe_cost(op: OpRecord) -> tuple[float, float]:
    """The MoE FFN on this rank's rows: the router's product, then each
    row's k experts (gate, up and down products) over the expert columns
    this rank holds (expert parallelism moves rows, not work: a rank
    computes as many routed rows as it sends); bytes: the rows in and out
    and the expert blocks this rank holds (each read once)."""
    kw = op.params
    x = op.inputs[0]
    T = x.numel // x.shape[-1]
    d, k, E = kw["d_model"], kw["top_k"], kw["n_experts"]
    flops = 2.0 * T * d * E + 6.0 * T * k * d * kw["ffe_local"]
    weights = sum(t.nbytes for t in op.inputs[1:])
    return flops, 2 * x.nbytes + weights


# ---------------------------------------------------------------------------
# Counting.
# ---------------------------------------------------------------------------

def totals_of(ops: list[OpRecord], aten_flops: float) -> Totals:
    """Totals over recorded ops: aten FLOPs as counted, every op's bytes,
    kernels by formula, collectives by kind."""
    t = Totals(flops=float(aten_flops))
    for op in ops:
        if op.kernel:
            f, b = kernel_cost(op)
            name = op.name.removeprefix("kernel:")
            t.flops += f
            t.kernel_flops[name] = t.kernel_flops.get(name, 0) + f
            t.bytes += b
            key = op.inputs[0].dtype if op.inputs else "unknown"
            t.bytes_by_dtype[key] = t.bytes_by_dtype.get(key, 0) + b
            for kind, (nbytes, count) in op.params.get("collectives", {}).items():
                t.collective_bytes[kind] = t.collective_bytes.get(kind, 0) + nbytes
                t.collective_counts[kind] = t.collective_counts.get(kind, 0) + count
            continue
        ns, _, rest = op.name.partition(".")
        base = rest.split(".")[0]
        if ns == "c10d":
            kind = COLLECTIVES.get(base)
            if kind is None:
                continue
            # the result a rank receives: the output tensors (a send, which
            # returns none, its input)
            nbytes = sum(o.nbytes for o in (op.outputs or op.inputs))
            t.collective_bytes[kind] = t.collective_bytes.get(kind, 0) + nbytes
            t.collective_counts[kind] = t.collective_counts.get(kind, 0) + 1
            continue
        if base in FREE_OPS:
            continue
        if base in INDEXED_WRITES:
            t._bytes(op.inputs[1:])
            t._bytes(op.inputs[-1:])
            continue
        t._bytes(op.inputs)
        t._bytes(op.outputs)
    return t


def _moe_meta(rec: OpRecorder):
    """``moe.moe_apply`` as an opaque call: (y like x, aux or None) on
    "meta", its cost by ``moe_cost`` and its EP collectives by
    ``moe_collectives``."""
    def call(x, p, cfg, dist=None, *, pspec=None, rows=..., aux=True):
        params = dict(d_model=cfg.d_model, top_k=cfg.moe_top_k, n_experts=cfg.n_experts,
                      ffe_local=p["w_gate"].shape[-1],
                      collectives=moe_collectives(x, cfg, dist))
        leaves = [x] + [p[n] for n in ("router", "w_gate", "w_up", "w_down") if n in p]

        def run():
            return torch.empty_like(x), (torch.zeros((), dtype=torch.float32, device=x.device)
                                         if aux else None)

        return opaque_call(rec, "moe_ffn", run, leaves, params)
    return call


def moe_collectives(x: torch.Tensor, cfg, dist) -> dict:
    """The MoE FFN's expert-parallel traffic by the plan's rule
    (``moe.moe_apply``): where the experts are spread over more than one
    data shard, every routed row goes to its expert's rank and back, two
    all-to-alls of T·k rows of d elements."""
    if dist is None or dist.mesh is None or dist.n_data <= 1:
        return {}
    T = x.numel() // x.shape[-1]
    nbytes = T * cfg.moe_top_k * cfg.d_model * x.element_size()
    return {"all-to-all": (2.0 * nbytes, 2)}


@contextlib.contextmanager
def counting():
    """``with counting() as result:`` — after the block, ``result[0]`` is
    the Totals of everything it ran on "meta" tensors."""
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe
    rec = OpRecorder()
    result: list = []
    extra = {(moe, "moe_apply"): _moe_meta(rec)}
    flops = FlopCounterMode(display=False)
    # the host check of a decode step's room reads kv_len: no "meta" value
    with mock.patch.object(model_mod, "_check_room", lambda *a, **k: None), \
            opaque_kernels(rec, extra=extra), flops, rec:
        yield result
    result.append(totals_of(rec.ops, flops.get_total_flops()))


# ---------------------------------------------------------------------------
# A cell's step, per rank.
# ---------------------------------------------------------------------------

def _stacks(cfg) -> dict:
    """Each layer stack of ``cfg`` ("dec", and "enc" for encdec): (its
    repeating group's length, its group count)."""
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import layer_groups
    group, G = layer_groups(cfg)
    out = {"dec": (len(group), G)}
    if cfg.family == "encdec":
        enc_group, G_enc = layer_groups(Model(cfg, device="meta")._enc_cfg())
        out["enc"] = (len(enc_group), G_enc)
    return out


def _with_groups(cfg, groups: dict):
    """``cfg`` with ``groups[stack]`` repeating groups in each stack."""
    stacks = _stacks(cfg)
    kw = {"n_layers": groups["dec"] * stacks["dec"][0]}
    if "enc" in stacks:
        kw["enc_layers"] = groups["enc"] * stacks["enc"][0]
    return dataclasses.replace(cfg, **kw)


def local_batch(cfg, kind: str, B: int, S: int, dist) -> dict:
    """This rank's inputs of a step on "meta" (shapes as the reference's
    ``dryrun.input_specs``, split by ``launch.sharding``'s specs)."""
    from repro_torch.launch import sharding as shd
    meta = "meta"
    n = dist.axis_size(shd.batch_spec(dist, B)) if dist.mesh is not None else 1
    b = B // n
    bf16 = torch.bfloat16
    if kind == "decode":
        return {"tokens": torch.empty((b,), dtype=torch.int32, device=meta),
                "kv_len": torch.empty((b,), dtype=torch.int32, device=meta)}
    s = S - cfg.n_patches if cfg.family == "vlm" else S
    out = {"tokens": torch.empty((b, s), dtype=torch.int32, device=meta)}
    if kind == "train":
        out["labels"] = torch.empty((b, s), dtype=torch.int32, device=meta)
    if cfg.family == "vlm":
        out["patches"] = torch.empty((b, cfg.n_patches, cfg.d_model), dtype=bf16, device=meta)
    if cfg.family == "encdec":
        out["audio"] = torch.empty((b, cfg.enc_ctx, cfg.enc_dim), dtype=bf16, device=meta)
    return out


def _run_step(cfg, kind: str, B: int, S: int, dist) -> Totals:
    """Count one step of ``cfg`` (all its layers) on this rank."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models.model import Model
    model = Model(cfg, device="meta", dist=dist)
    full = model.init_params(0)
    meshed = dist.mesh is not None
    training = kind == "train"
    params = full
    if meshed:
        plan = model.plan if training else model.serve_plan
        params = shd.shard_tree(full, plan, dist)
    batch = local_batch(cfg, kind, B, S, dist)
    if training:
        params = _tree_map(lambda t: t.requires_grad_(t.is_floating_point()), params)
    if kind == "decode":        # the cache a decode step reads exists before it
        cache = model.init_cache(B if meshed else batch["tokens"].shape[0], S)
    with counting() as result:
        if training:
            loss, _ = model.loss_fn(params, batch)
            loss.backward()
        elif kind == "prefill":
            model.prefill(params, batch, max_len=S, **({"batch_size": B} if meshed else {}))
        else:
            model.decode_step(params, cache, batch["tokens"], batch["kv_len"])
    t = result[0]
    if training:
        t.add(adamw_cost(params, cfg.opt_state_dtype))
    return t


MOMENT_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def adamw_cost(params, state_dtype: str = "fp32") -> Totals:
    """AdamW's update of this rank's parameters: the parameter and its
    gradient read, the parameter written, both moments read and written
    (``state_dtype``'s bytes an element); 10 operations an element."""
    n = sum(t.numel() for t in _leaves(params))
    p_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    t = Totals(flops=10.0 * n)
    t.bytes = 3 * p_bytes + 4 * n * MOMENT_BYTES[state_dtype]
    t.bytes_by_dtype = {"optimizer": t.bytes}
    return t


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def step_cost(cfg, kind: str, B: int, S: int, dist, *, whole: bool = False) -> Totals:
    """One step of ``cfg`` (``kind`` train / prefill / decode, global batch
    B, sequence or cache length S) on this rank of ``dist``: counted with
    one group in every layer stack, then with two in one stack at a time,
    and extrapolated to the config's groups (``whole``: the model counted
    as it is)."""
    if whole:
        return _run_step(cfg, kind, B, S, dist)
    stacks = _stacks(cfg)
    ones = {k: 1 for k in stacks}
    base = _run_step(_with_groups(cfg, ones), kind, B, S, dist)
    out = Totals()
    out.add(base)
    for stack, (_, G) in stacks.items():
        if G > 1:
            two = _run_step(_with_groups(cfg, {**ones, stack: 2}), kind, B, S, dist)
            out.add(two, G - 1)
            out.add(base, -(G - 1))
    return out
