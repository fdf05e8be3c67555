"""Training driver: a fault-tolerant loop over any assigned architecture.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

The counterpart of ``repro.launch.train``, line for line: gradient
accumulation (``cfg.grad_accum``), async checkpointing with the data
pipeline's state (exactly-once batches on resume), a preemption handler
(SIGTERM → emergency save), the straggler watchdog, restart-resume, a
final save. It runs on the card unless ``--device cpu`` (``device="cpu"``).
One host sync a step: reading the loss.

The one API difference: ``run_training(params=...)`` starts from given
weights (copied, so the caller's stay as they were), since a
``torch.Generator`` cannot draw the reference's ``jax.random`` init; tests
carry the reference's weights across with ``convert.params_from_reference``.

Under a mesh (``dist=``, one process a rank, e.g. from
``launch.mesh.launch_ranks``): every rank draws or copies the full
weights, keeps its blocks (``launch.sharding.shard_tree`` under the
training plan) and frees the rest; every rank's batcher makes the same
global batch, of which the sharded step (``launch.steps``) takes the
rank's rows; a checkpoint stays in the one-process format, rank 0
writing the gathered full leaves (``gather_tree``, a collective every
rank joins), and a restart restores each rank's blocks
(``restore_checkpoint(plan=, dist=)``), so either package, and any mesh,
restores it. Only rank 0 logs.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import PackedBatcher, SyntheticCorpus
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.fault import PreemptionHandler, StepWatchdog
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.sharding import gather_tree, opt_plan, shard_tree
from repro_torch.models.convert import tree_map
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state


def _state_specs(model: Model, opt_cfg: AdamWConfig) -> dict:
    """The spec tree of {"params", "opt"} on the model's mesh."""
    meta = Model(model.cfg, device="meta").init_params(0)
    opt_shapes = init_opt_state(meta, opt_cfg)
    return {"params": model.plan, "opt": opt_plan(model.plan, opt_shapes, model.dist)}


def run_training(cfg, *, steps: int, batch: int, seq: int,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 lr: float = 3e-4, log_every: int = 10, seed: int = 0,
                 log=print, device=None, params: dict | None = None,
                 dist=None) -> dict:
    model = Model(cfg, device=device, dist=dist)
    opt_cfg = AdamWConfig(lr=lr, state_dtype=cfg.opt_state_dtype, total_steps=steps)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=seed)
    batcher = PackedBatcher(corpus, batch, seq)
    specs = _state_specs(model, opt_cfg) if model.meshed else None
    writer = not model.meshed or torch.distributed.get_rank() == 0
    if not writer:
        log = lambda *_: None  # noqa: E731  (rank 0 logs)

    start_step = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, extras, start_step = restore_checkpoint(ckpt_dir, device=model.device,
                                                      plan=specs, dist=dist)
        params, opt_state = tree["params"], tree["opt"]
        batcher.load_state_dict(extras["batcher"])
        log(f"[train] resumed from step {start_step}")
    else:
        if params is None:
            params = model.init_params(seed)
        if model.meshed:
            params = shard_tree(params, specs["params"], dist)
        else:
            params = tree_map(lambda t: t.detach().to(model.device, copy=True), params)
        opt_state = init_opt_state(params, opt_cfg, dist=dist,
                                   specs=specs["params"] if specs else None)

    def save(step: int) -> None:
        tree = {"params": params, "opt": opt_state}
        if model.meshed:
            tree = gather_tree(tree, specs, dist)
        if writer:
            ckpt.save(step, tree, extras={"batcher": batcher.state_dict()})

    step_fn = make_train_step(model, opt_cfg)
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    preempt = PreemptionHandler().install()
    watchdog = StepWatchdog(
        on_straggler=lambda dt, med: log(
            f"[watchdog] straggler step: {dt:.2f}s vs median {med:.2f}s"))

    losses = []
    t_start = time.time()
    step = start_step
    for step in range(start_step, steps):
        watchdog.step_start()
        np_batch = batcher.next_batch()
        batch_dev = {k: torch.from_numpy(v).to(model.device) for k, v in np_batch.items()}
        metrics = step_fn(params, opt_state, batch_dev)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = watchdog.step_end()
        if step % log_every == 0:
            log(f"[train] step {step} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s")
        if ckpt and (step + 1) % ckpt_every == 0:
            save(step + 1)
        stop = preempt.preempted
        if model.meshed:        # every rank stops at the same step (the save gathers)
            flag = torch.tensor(float(stop), device=model.device)
            stop = bool(coll.all_reduce(flag, dist, dist.mesh.mesh_dim_names, op="max"))
        if stop:
            log("[train] preemption signal — emergency checkpoint")
            if ckpt:
                save(step + 1)
                ckpt.wait()
            break
    if ckpt:
        save(step + 1)
        ckpt.wait()
    preempt.uninstall()
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "losses": losses,
        "steps_run": len(losses),
        "straggler_events": watchdog.straggler_events,
        "wall_s": time.time() - t_start,
        "params": params,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(grad_accum=1)
    res = run_training(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       lr=args.lr, device=args.device)
    print(f"[train] done: first_loss={res['first_loss']:.4f} "
          f"final_loss={res['final_loss']:.4f} "
          f"steps={res['steps_run']} wall={res['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
