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
The mesh (``dist=``) has no counterpart: the port trains on one device.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import PackedBatcher, SyntheticCorpus
from repro_torch.distributed.fault import PreemptionHandler, StepWatchdog
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import tree_map
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state


def run_training(cfg, *, steps: int, batch: int, seq: int,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 lr: float = 3e-4, log_every: int = 10, seed: int = 0,
                 log=print, device=None, params: dict | None = None) -> dict:
    model = Model(cfg, device=device)
    opt_cfg = AdamWConfig(lr=lr, state_dtype=cfg.opt_state_dtype, total_steps=steps)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=seed)
    batcher = PackedBatcher(corpus, batch, seq)

    start_step = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, extras, start_step = restore_checkpoint(ckpt_dir, device=model.device)
        params, opt_state = tree["params"], tree["opt"]
        batcher.load_state_dict(extras["batcher"])
        log(f"[train] resumed from step {start_step}")
    else:
        if params is None:
            params = model.init_params(seed)
        else:
            params = tree_map(lambda t: t.detach().to(model.device, copy=True), params)
        opt_state = init_opt_state(params, opt_cfg)

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
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      extras={"batcher": batcher.state_dict()})
        if preempt.preempted:
            log("[train] preemption signal — emergency checkpoint")
            if ckpt:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          extras={"batcher": batcher.state_dict()})
                ckpt.wait()
            break
    if ckpt:
        ckpt.save(step + 1, {"params": params, "opt": opt_state},
                  extras={"batcher": batcher.state_dict()})
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
