"""Logical-axis sharding rules (MaxText-style), resolved per (arch, mesh).

The counterpart of ``repro.launch.sharding``, rule for rule. Rules walk
the parameter tree by path and emit specs (``distributed.context.P``):

  * feature axes (heads, ffn, vocab, d_inner) → ``model``  (TP)
  * training adds FSDP: d_model dims → ``data``; the MoE expert axis is
    *stored* over the widest dividing prefix of (pod, data) and brought
    into the data-owned compute layout per layer (``models/moe.py``)
  * serving replicates weights over ``data``; batch/KV shard over
    (pod, data), the KV **sequence** goes to ``model`` when kv_heads don't
    divide the model axis, and to (data, model) for batch-1 long context

Divisibility is checked against the actual mesh: anything non-divisible
falls back to replication on that axis, recorded in ``notes`` in the
reference's words: 8-head gemma2 attention ends up TP-replicated while
its 9216-wide FFN TP-shards.

The port's stack is one dict per layer (``models/convert.py``), where the
reference's is group-stacked (G, …) under "stack". So the port's plan has
one spec per layer leaf, the reference's spec without its leading None,
and layer i takes the rule of the reference's ``stack.sub{i % len(group)}``
(``transformer.layer_groups``): every layer of a group position has its
shapes. ``notes`` name the reference's paths and shapes (the group-stacked
ones), once per group position, so the two packages' notes are equal.
The shape tree comes from ``Model(cfg).init_params`` on the "meta" device:
kimi-k2 plans without allocating anything.

``shard_tree`` (full tensors → this rank's blocks) and ``gather_tree``
(the inverse, on every rank) take the place of
``ShardingPlan.shardings(mesh)`` and ``jax.device_put``. ``cache_specs``
gives the specs of the port's cache layout (``transformer.init_cache``:
k / v (L_attn, B, S, Hkv, dh), h / conv (L_mamba, …)), whose leading
layer dim takes the place of the reference's group dim.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import Dist, P, axis_names
from repro_torch.models.config import ArchConfig


def _axis_size(dist: Dist, axis) -> int:
    if axis is None:
        return 1
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= dist.axis_size(a)
    return size


def _fit(dist: Dist, dim: int, *candidates):
    """First candidate axis (or axis tuple) whose size divides dim."""
    for axis in candidates:
        if axis is None:
            return None
        if dim % _axis_size(dist, axis) == 0:
            return axis
    return None


@dataclass
class ShardingPlan:
    params: dict                      # tree of P, like the params
    notes: list[str] = field(default_factory=list)


def param_plan(cfg: ArchConfig, dist: Dist, *, training: bool) -> ShardingPlan:
    """Spec tree matching ``Model.init_params``' structure."""
    from repro_torch.models.transformer import layer_groups
    shapes = _shape_tree(cfg)
    notes: list[str] = []
    fsdp = dist.data_axis if training else None
    model = dist.model_axis
    # Expert storage: widest dividing prefix of (pod, data); replicate else.
    expert_candidates = []
    if training and dist.pod_axis:
        expert_candidates.append((dist.pod_axis, dist.data_axis))
    expert_candidates.extend([(dist.data_axis,), None])

    def rule(path: str, base: tuple[int, ...], ref_path: str, stack: int | None,
             noted: bool) -> P:
        """``base`` the leaf's shape; ``ref_path`` the reference's path and
        ``stack`` its group count (None outside "stack") for the notes,
        written only where ``noted``."""
        leaf = path.split(".")[-1]

        def note(msg: str) -> None:
            if noted:
                notes.append(msg)

        def wrap(*axes):
            assert len(axes) == len(base), (path, axes, base)
            spec = tuple(_fit(dist, base[i], a, None) for i, a in enumerate(axes))
            for i, (want, got) in enumerate(zip(axes, spec)):
                if want is not None and got is None:
                    note(f"{ref_path}: dim{i}={base[i]} not divisible by {want}; replicated")
            return P(*spec)

        if leaf in ("embed", "head"):
            return wrap(model, fsdp)
        if leaf in ("final_norm", "ln_mix", "ln_mlp", "ln_cross", "conv_b",
                    "dt_bias", "D"):
            return wrap(*([None] * len(base)))
        if leaf in ("wq", "wk", "wv"):
            return wrap(fsdp, model, None)
        if leaf == "wo":
            return wrap(model, None, fsdp)
        if len(base) == 3 and leaf in ("w_gate", "w_up"):     # MoE experts
            e_axis = _fit(dist, base[0], *expert_candidates)
            return wrap(e_axis, None, model)
        if len(base) == 3 and leaf == "w_down":
            e_axis = _fit(dist, base[0], *expert_candidates)
            return wrap(e_axis, model, None)
        if leaf in ("w_gate", "w_up"):                         # dense MLP
            return wrap(fsdp, model)
        if leaf == "w_down":
            return wrap(model, fsdp)
        if leaf == "router":
            return wrap(fsdp, None)
        if leaf == "w_in":                                     # mamba (d, 2di)
            return wrap(fsdp, model)
        if leaf == "conv_w":
            return wrap(None, model)
        if leaf == "w_x_proj":
            return wrap(model, None)
        if leaf == "w_dt":
            return wrap(None, model)
        if leaf == "A_log":
            return wrap(model, None)
        if leaf == "w_out":                                    # (di, d)
            return wrap(model, fsdp)
        if leaf == "proj":                                     # whisper frontend
            return wrap(None, fsdp)
        shape = base if stack is None else (stack, *base)
        note(f"replicated (no rule): {ref_path} {shape}")
        return P(*([None] * len(base)))

    def in_ref_order(tree: dict):
        """A dict's items in the order the reference walks its tree: jax
        rebuilds dicts with sorted keys, and "layers" is its "stack"."""
        return sorted(tree.items(), key=lambda kv: "stack" if kv[0] == "layers" else kv[0])

    def walk(tree, path: str, ref_path: str, stack=None, noted=True):
        if isinstance(tree, dict):
            out = {k: walk(v, f"{path}.{k}", f"{ref_path}.{k}", stack, noted)
                   for k, v in in_ref_order(tree)}
            return {k: out[k] for k in tree}
        return rule(path.lstrip("."), tree, ref_path.lstrip("."), stack, noted)

    def walk_layers(layers, layer_cfg, prefix: str) -> list:
        group, n_groups = layer_groups(layer_cfg)
        n = len(group)

        def one(i, noted):
            return walk(layers[i], f"{prefix}.layers.{i}", f"{prefix}.stack.sub{i % n}",
                        n_groups, noted)

        first = {i: one(i, True) for i in sorted(range(n), key=lambda i: f"sub{i}")}
        return [first[i] if i < n else one(i, False) for i in range(len(layers))]

    specs = {}
    for key, sub in in_ref_order(shapes):
        if key == "layers":
            specs[key] = walk_layers(sub, cfg, "")
        elif key == "enc":
            from repro_torch.models.model import Model
            enc_cfg = Model(cfg, device="meta")._enc_cfg()
            enc = {k: (walk_layers(v, enc_cfg, ".enc") if k == "layers"
                       else walk(v, f".enc.{k}", f".enc.{k}"))
                   for k, v in in_ref_order(sub)}
            specs[key] = {k: enc[k] for k in sub}
        else:
            specs[key] = walk(sub, key, key)
    specs = {k: specs[k] for k in shapes}
    return ShardingPlan(params=specs, notes=notes)


def _shape_tree(cfg: ArchConfig) -> dict:
    from repro_torch.models.convert import tree_map
    from repro_torch.models.model import Model
    return tree_map(lambda t: tuple(t.shape), Model(cfg, device="meta").init_params(0))


# ---------------------------------------------------------------------------
# Input / cache specs per shape kind.
# ---------------------------------------------------------------------------

def batch_spec(dist: Dist, batch: int):
    """Shard batch over (pod, data) if divisible; fall back to data; none."""
    cands = []
    if dist.pod_axis:
        cands.append((dist.pod_axis, dist.data_axis))
    cands.extend([(dist.data_axis,), None])
    return _fit(dist, batch, *cands)


def input_specs_train(cfg: ArchConfig, dist: Dist, batch: int) -> dict:
    b = batch_spec(dist, batch)
    specs = {"tokens": P(b, None), "labels": P(b, None)}
    if cfg.family == "vlm":
        specs["patches"] = P(b, None, None)
    if cfg.family == "encdec":
        specs["audio"] = P(b, None, None)
    return specs


def cache_specs(cfg: ArchConfig, dist: Dist, batch: int, seq_len: int) -> dict:
    """Specs of the port's cache (``transformer.init_cache``): k / v for
    the attention layers, h / conv for the Mamba layers, each with the
    layer dim first (the reference's group dim)."""
    b = batch_spec(dist, batch)
    if b is not None:
        if cfg.n_kv_heads % max(1, dist.n_model) == 0:
            head_axis, seq_axis = dist.model_axis, None
        else:
            head_axis, seq_axis = None, dist.model_axis
    else:
        # batch-1 long context: shard the sequence over everything.
        head_axis = None
        seq_axis = _fit(dist, seq_len, (dist.data_axis, dist.model_axis), None)
    di_axis = _fit(dist, cfg.ssm_d_inner, dist.model_axis, None)

    out = {}
    kinds = cfg.layer_kinds()
    if "attn" in kinds:
        kv = P(None, b, seq_axis, head_axis, None)
        out.update(k=kv, v=kv)
    if "mamba" in kinds:
        out.update(h=P(None, b, di_axis, None), conv=P(None, b, None, di_axis))
    return out


def enc_kv_spec(cfg: ArchConfig, dist: Dist, batch: int) -> dict:
    b = batch_spec(dist, batch)
    s = P(None, b, None, None, None)
    return {"k": s, "v": s}


def opt_plan(param_specs: dict, opt_shapes: dict, dist: Dist) -> dict:
    """Moment specs mirror param specs; int8 block scales drop the last-axis
    sharding unless the block count still divides it. ``opt_shapes`` is
    ``init_opt_state`` of the params (on the "meta" device, say)."""

    def moment_spec(pspec: P, mo_shape) -> dict:
        if mo_shape["s"] is None:
            return {"q": pspec, "s": None}
        s_shape = mo_shape["s"].shape
        last = pspec[-1] if len(pspec) else None
        log_domain = len(s_shape) == mo_shape["q"].ndim + 1
        blocks = s_shape[-2] if log_domain else s_shape[-1]
        s_spec = (*pspec[:-1], _fit(dist, blocks, last, None))
        if log_domain:
            s_spec = (*s_spec, None)
        return {"q": pspec, "s": P(*s_spec)}

    def walk(spec_tree, shape_tree):
        if isinstance(spec_tree, P):
            return moment_spec(spec_tree, shape_tree)
        if isinstance(spec_tree, list):
            return [walk(s, t) for s, t in zip(spec_tree, shape_tree)]
        return {k: walk(spec_tree[k], shape_tree[k]) for k in spec_tree}

    return {
        "step": P(),
        "m": walk(param_specs, opt_shapes["m"]),
        "v": walk(param_specs, opt_shapes["v"]),
    }


# ---------------------------------------------------------------------------
# Placing trees on the mesh.
# ---------------------------------------------------------------------------

def _zip_specs(tree, specs, fn):
    """``fn(leaf, spec)`` over a tree and its spec tree (a None spec or
    leaf passes through as None)."""
    if isinstance(specs, P) or specs is None:
        return None if tree is None else fn(tree, specs if specs is not None else P())
    if isinstance(tree, list):
        return [_zip_specs(t, s, fn) for t, s in zip(tree, specs)]
    return {k: _zip_specs(v, specs[k], fn) for k, v in tree.items()}


def local_block(t: torch.Tensor, spec: P, dist: Dist) -> torch.Tensor:
    """This rank's block of a full tensor under ``spec`` (a copy)."""
    t = t.detach()
    for dim, axis in enumerate(spec):
        n = dist.axis_size(axis)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, dist.coord(axis) * size, size)
    return t.clone()


def shard_tree(tree, specs, dist: Dist):
    """Full tensors → this rank's blocks, leaf by leaf (``specs`` a spec
    tree like ``tree``: a ``ShardingPlan``'s ``params``, ``opt_plan``'s
    output, ``input_specs_train``'s)."""
    return _zip_specs(tree, specs, lambda t, s: local_block(t, s, dist))


def gather_tree(tree, specs, dist: Dist):
    """This rank's blocks → the full tensors, on every rank (collective:
    every rank calls it with its blocks)."""
    def full(t, spec):
        t = t.detach()
        for dim, axis in enumerate(spec):
            if axis_names(axis):
                t = coll.gather_value(t, dim, dist, axis)
        return t
    return _zip_specs(tree, specs, full)


def shard_batch(batch: dict, cfg: ArchConfig, dist: Dist) -> dict:
    """A global training batch → this rank's rows (``input_specs_train``)."""
    B = batch["tokens"].shape[0]
    return shard_tree(batch, input_specs_train(cfg, dist, B), dist)
