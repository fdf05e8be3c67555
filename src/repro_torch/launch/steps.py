"""The train step (with gradient accumulation).

The counterpart of ``repro.launch.steps.make_train_step``. The reference
jits a pure function; here the step runs eagerly and updates the
parameters and the optimizer state in place.

Under a mesh (``Model(cfg, dist=...)``) every rank runs the step on its
parameter blocks and moments, with the same global batch: each
microbatch is split globally, as without a mesh, and each rank takes its
rows (``shard_batch``). The model's backward leaves each rank the
gradient of its own tokens' term; the step then sums every leaf's
gradient over the batch axes (pod, data) that leaf is NOT stored over
(those it is stored over were reduce-scattered into the block by the
FSDP gather's backward, or belong to expert parallelism's owners), so a
leaf replicated over the batch axes ends up with the same global
gradient on every rank. The model axis needs nothing: its ranks' grads
are already complete (``distributed/collectives.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import axis_names
from repro_torch.launch.sharding import shard_batch
from repro_torch.models.convert import tree_leaves, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, apply_adamw


@dataclass(frozen=True)
class TrainStep:
    """``step(params, opt_state, batch) -> metrics`` updates ``params``
    and ``opt_state`` in place; it is ``grads`` and then ``update``, which
    a caller may also run (and time) one at a time. Metrics ({"loss",
    "grad_norm", "lr"}) are device tensors: reading them is the caller's
    host sync."""
    model: Model
    opt_cfg: AdamWConfig

    def grads(self, params, batch) -> tuple[torch.Tensor, list]:
        """(the mean loss, one gradient per ``tree_leaves(params)`` leaf).
        ``cfg.grad_accum`` microbatches (the batch split along its first
        axis) accumulate fp32 gradients, divided by their count, as the
        reference's ``lax.scan`` does; one microbatch keeps the gradients
        in the parameters' dtypes. Under a mesh ``batch`` is the global
        batch and the gradients are this rank's blocks'."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        n_micro = max(1, self.model.cfg.grad_accum)
        if n_micro == 1:
            loss, grads = self._grads(leaves, params, batch)
            return loss, self._reduce(grads)
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
        size = B // n_micro
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        loss = 0.0
        for i in range(n_micro):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss_i, g = self._grads(leaves, params, mb)
            for acc, gi in zip(grads, g):
                acc += gi.to(torch.float32)
            loss = loss + loss_i
        return loss / n_micro, self._reduce([g / n_micro for g in grads])

    def _grads(self, leaves, params, batch):
        if self.model.meshed:
            batch = shard_batch(batch, self.model.cfg, self.model.dist)
        loss, _ = self.model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def _reduce(self, grads: list) -> list:
        """Under a mesh, each leaf's gradient summed over the batch axes it
        is not stored over; as it is otherwise."""
        model = self.model
        if not model.meshed:
            return grads
        dist = model.dist
        out = []
        for g, spec in zip(grads, tree_leaves(model.plan)):
            stored = {a for e in spec for a in axis_names(e)}
            axes = tuple(a for a in dist.batch_axes if a not in stored)
            out.append(coll.all_reduce(g, dist, axes) if axes else g)
        return out

    def update(self, params, opt_state, grads) -> dict:
        """AdamW in place from ``grads`` (in ``tree_leaves`` order)."""
        model = self.model
        return apply_adamw(params, tree_unflatten(params, grads), opt_state, self.opt_cfg,
                           dist=model.dist, specs=model.plan if model.meshed else None)

    def __call__(self, params, opt_state, batch) -> dict:
        loss, grads = self.grads(params, batch)
        return {"loss": loss, **self.update(params, opt_state, grads)}


def make_train_step(model: Model, opt_cfg: AdamWConfig) -> TrainStep:
    """The train step of ``model`` under ``opt_cfg`` (``TrainStep``)."""
    return TrainStep(model, opt_cfg)
