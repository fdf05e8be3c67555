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

The backward (GPipe's reverse drain), where the reference lets
``jax.grad`` differentiate its scan. With grad enabled and parameters
that require it, the forward keeps each microbatch's stage graph apart:
a received activation is a leaf of its own, and the last stage scores
detached copies of its outputs. The returned loss is the output of an
autograd Function (``_Drain``) over this rank's parameter leaves, whose
backward runs the stage's part explicitly, one microbatch at a time in a
fixed order (the last first) on every stage, so sends and receives pair
up between neighbours whatever order the autograd engine would pick:

  * the last stage differentiates its loss term (seeded by the loss's
    gradient) into the head, the final norm and its outputs' gradients;
  * every other stage receives microbatch i's output gradient from the
    stage after it;
  * each stage backprops microbatch i through its layers (and, on the
    first stage, the embedding), and every stage but the first sends the
    gradient of the activation it received to the stage before it.

Only the last stage's term seeds a backward: the loss is a sum over
``pod`` in which the other stages add 0, so each stage's parameters get
d loss / d them once. The microbatches' gradients add up in fp32; each
leaf's, cast to the leaf's dtype, is then summed over the batch axes
(pod, data) it is not stored over, as ``launch.steps.TrainStep`` sums
them (a stage's layers over its ``data`` line; the embedding, final norm
and head, which one stage uses, over ``pod`` too). So ``loss.backward()``
on every rank leaves each rank the gradient of its own blocks, as
``jax.grad`` of the reference's loss does; ``torch.autograd.grad`` of the
loss returns the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import Dist, P, axis_names
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


class _Drain(torch.autograd.Function):
    """The pipelined loss's value, as an output of this rank's parameter
    leaves; its backward is the stage's reverse drain (``_Stage.drain``)."""

    @staticmethod
    def forward(ctx, value, stage, *leaves):
        ctx.stage = stage
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return (None, None, *ctx.stage.drain(g))


@dataclass
class _Stage:
    """One rank's forward graphs, kept for the drain: its parameter leaves
    and their specs, per microbatch the received activation (None on the
    first stage) and the stage's output, and on the last stage its loss
    term and the detached outputs that term scores."""
    dist: Dist
    leaves: list
    specs: list
    prev: int | None
    next: int | None
    ins: list = field(default_factory=list)
    outs: list = field(default_factory=list)
    term: torch.Tensor | None = None
    scored: list = field(default_factory=list)

    def drain(self, g: torch.Tensor) -> list:
        n = len(self.leaves)
        grads = [None] * n

        def add(gs):
            for j, gj in enumerate(gs[:n]):
                if gj is not None:
                    grads[j] = gj.float() if grads[j] is None else grads[j] + gj.float()

        if self.term is not None:
            gs = torch.autograd.grad(self.term, self.leaves + self.scored, g,
                                     allow_unused=True)
            add(gs)
            d_outs = gs[n:]
        for i in reversed(range(len(self.outs))):
            out = self.outs[i]
            d_out = d_outs[i] if self.term is not None else coll.recv(out, self.next)
            wrt = self.leaves + ([self.ins[i]] if self.prev is not None else [])
            gs = torch.autograd.grad(out, wrt, d_out, allow_unused=True)
            add(gs)
            if self.prev is not None:
                coll.send(gs[n], self.prev)
        out = []
        for p, gp, spec in zip(self.leaves, grads, self.specs):
            gp = torch.zeros_like(p) if gp is None else gp.to(p.dtype)
            stored = {a for e in spec for a in axis_names(e)}
            axes = tuple(a for a in self.dist.batch_axes if a not in stored)
            out.append(coll.all_reduce(gp, self.dist, axes) if axes else gp)
        return out


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

    pp_specs = tree_leaves(dict(model.plan, layers=pp_stack_specs(model.plan["layers"],
                                                                  n_stages)))

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
        Bm = B // n_micro
        leaves = tree_leaves(params)
        train = torch.is_grad_enabled() and any(p.requires_grad for p in leaves)
        rank = _Stage(dist, [p for p in leaves if p.requires_grad],
                      [s for p, s in zip(leaves, pp_specs) if p.requires_grad],
                      pods[me - 1] if me > 0 else None,
                      pods[me + 1] if me < n_stages - 1 else None)
        layers = [tree_map(lambda t: t[0], layer) for layer in params["layers"]]
        positions = torch.arange(S, device=stage.device)
        rows = input_specs_train(cfg, stage.dist, Bm)

        def micro(i, key):
            mb = {key: batch[key][i * Bm:(i + 1) * Bm]}
            return shard_tree(mb, {key: rows[key]}, stage.dist)[key].to(stage.device)

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
                h = coll.recv(like, rank.prev).requires_grad_(train)
                rank.ins.append(h)
            h, _ = tf.stack_apply(h, layers, cfg, stage.dist, mode="train",
                                  positions=positions, pattern=pattern, specs=specs)
            rank.outs.append(h)
            if rank.next is not None:
                coll.send(h, rank.next)
        value = torch.zeros((), dtype=torch.float32, device=stage.device)
        n_tok = torch.zeros((), dtype=torch.float32, device=stage.device)
        if rank.next is None:
            rank.scored = [h.detach().requires_grad_(train) for h in rank.outs]
            x = rms_norm(torch.cat(rank.scored), params["final_norm"], cfg.norm_eps)
            lab = torch.cat([micro(i, "labels") for i in range(n_micro)])
            nll, cnt = stage._chunked_xent(params, x, lab)
            axes = stage.dist.batch_axes
            n_tok = coll.all_reduce(cnt, stage.dist, axes)
            rank.term = nll / n_tok.clamp(min=1.0)        # this rank's term
            value = coll.all_reduce(rank.term, stage.dist, axes)
        value = coll.all_reduce(value, dist, dist.pod_axis)
        n_tok = coll.all_reduce(n_tok, dist, dist.pod_axis)
        loss = _Drain.apply(value, rank, *rank.leaves) if train else value
        return loss, {"xent": value, "tokens": n_tok}

    return loss_fn
