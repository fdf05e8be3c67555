"""Pipeline parallelism over the pod axis (a GPipe schedule).

The counterpart of ``repro.launch.pipeline``. The multi-pod mesh's slow
tier is the inter-pod link, which suits pipeline parallelism: each pod
holds a contiguous range of layers, and activations cross pods once per
microbatch instead of every gradient all-reduce.

  * stage params: ``reshape_stack_for_pp`` stacks the layers as the
    reference reshapes its (G, …) stack to (P, G/P, …): layer j of the
    result holds, at index p of every leaf, stage p's j-th layer (layer
    p·L/P + j); ``pp_stack_specs`` puts "pod" on that stage dim, so
    ``shard_tree`` leaves each rank its own stage's layers (a leading dim
    of 1) in the plan's (data, model) layout;
  * the schedule: n_micro + P − 1 steps; at step t stage p runs
    microbatch t − p where that is one, on its (data, model) sub-mesh
    (``transformer.stack_apply`` under the mesh without its pod axis). The
    first stage embeds its microbatch; every other stage receives it from
    the stage before, point to point (``collectives.send`` / ``recv``,
    where the reference ``jnp.roll``s its stage buffer, a collective-
    permute across pods); the last stage keeps its outputs;
  * the last stage runs the final norm and the vocab-parallel chunked
    cross-entropy over all the microbatches' outputs, the mean over every
    unmasked label, and the loss goes to every rank (a sum over ``pod``
    in which the other stages add 0).

The same layers in the same order as the sequential stack, so the loss
equals the sequential one within rounding. Dense families only, as the
reference's (its MoE ``shard_map`` cannot nest under the stage vmap).
The loss is computed forward only (under ``torch.no_grad``): the
point-to-point hand-off is not differentiated, so a GPipe backward is not
ported (ROADMAP queue 1 item 8); the reference's test and the port's hold the
loss.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import P
from repro_torch.launch.sharding import input_specs_train, shard_tree
from repro_torch.models import transformer as tf
from repro_torch.models.convert import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.layers import dtype_of, rms_norm
from repro_torch.models.model import Model


def reshape_stack_for_pp(layers: list[dict], n_stages: int) -> list[dict]:
    """L layer dicts → L/P layer dicts whose leaves are (P, …): index p of
    layer j is stage p's layer p·L/P + j."""
    L = len(layers)
    if L % n_stages:
        raise ValueError(f"{L} layers don't split over {n_stages} stages")
    per = L // n_stages
    out = []
    for j in range(per):
        stages = [tree_leaves(layers[p * per + j]) for p in range(n_stages)]
        out.append(tree_unflatten(layers[j], [torch.stack(ts) for ts in zip(*stages)]))
    return out


def pp_stack_specs(plan_layers: list[dict], n_stages: int) -> list[dict]:
    """The stage-stacked layers' specs: "pod" on the stage dim before each
    layer's own spec (every stage's j-th layer has the same spec)."""
    per = len(plan_layers) // n_stages
    return [tree_map(lambda s: P("pod", *s), spec) for spec in plan_layers[:per]]


def make_pp_loss(model: Model, n_micro: int):
    """Returns loss_fn(params_pp, batch) running the stack as a GPipe over
    the pod axis: ``params_pp`` this rank's blocks of the params with
    ``"layers"`` stage-stacked (``reshape_stack_for_pp`` +
    ``pp_stack_specs``), ``batch`` the global batch (every rank the same).
    Returns (loss, {"xent", "tokens"}) on every rank."""
    cfg, dist = model.cfg, model.dist
    if dist is None or dist.mesh is None or not dist.pod_axis:
        raise ValueError("pipeline parallelism needs the multi-pod mesh")
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: GPipe runs dense families only")
    n_stages = dist.n_pod
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers don't split over {n_stages} pods")
    per = cfg.n_layers // n_stages
    stage = Model(cfg, device=model.device, dist=replace(dist, pod_axis=None))
    me = dist.coord(dist.pod_axis)
    pods = dist.line_ranks(dist.pod_axis)
    pattern = tf.layer_pattern(cfg)[me * per:(me + 1) * per]
    specs = stage.plan["layers"][me * per:(me + 1) * per]

    @torch.no_grad()
    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
        Bm = B // n_micro
        layers = [tree_map(lambda t: t[0], layer) for layer in params["layers"]]
        positions = torch.arange(S, device=stage.device)
        rows = input_specs_train(cfg, stage.dist, Bm)

        def micro(i, key):
            mb = {key: batch[key][i * Bm:(i + 1) * Bm]}
            return shard_tree(mb, {key: rows[key]}, stage.dist)[key].to(stage.device)

        ys = []
        for t in range(n_micro + n_stages - 1):
            i = t - me
            if not 0 <= i < n_micro:
                continue
            tok = micro(i, "tokens")
            if me == 0:
                h = stage._embed_tokens(params, tok)
            else:
                like = torch.empty((*tok.shape, cfg.d_model), dtype=dtype_of(cfg),
                                   device=stage.device)
                h = coll.recv(like, pods[me - 1])
            h, _ = tf.stack_apply(h, layers, cfg, stage.dist, mode="train",
                                  positions=positions, pattern=pattern, specs=specs)
            if me < n_stages - 1:
                coll.send(h, pods[me + 1])
            else:
                ys.append(h)
        loss = torch.zeros((), dtype=torch.float32, device=stage.device)
        n_tok = torch.zeros((), dtype=torch.float32, device=stage.device)
        if me == n_stages - 1:
            x = rms_norm(torch.cat(ys), params["final_norm"], cfg.norm_eps)
            lab = torch.cat([micro(i, "labels") for i in range(n_micro)])
            nll, cnt = stage._chunked_xent(params, x, lab)
            axes = stage.dist.batch_axes
            n_tok = coll.all_reduce(cnt, stage.dist, axes)
            loss = coll.all_reduce(nll, stage.dist, axes) / n_tok.clamp(min=1.0)
        loss = coll.all_reduce(loss, dist, dist.pod_axis)
        n_tok = coll.all_reduce(n_tok, dist, dist.pod_axis)
        return loss, {"xent": loss, "tokens": n_tok}

    return loss_fn
