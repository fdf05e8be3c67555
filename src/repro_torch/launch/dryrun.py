"""Multi-pod dry-run of every (architecture × input shape) cell, per rank.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell on 256 and 512 emulated TPU devices and records XLA's memory and cost
analyses. The port compiles nothing and needs no device: each cell runs on
"meta" tensors under a one-process "fake" process group of the mesh's
size (``torch.testing._internal.distributed.fake_pg``), on the production
meshes (16, 16) and (2, 16, 16) of ``launch.mesh.make_production_mesh``.
It sets no ``XLA_FLAGS`` and imports no JAX. Per cell:

* **Per-rank bytes** of the parameters, the optimizer state (train), the
  serving cache (prefill, decode) and the inputs, from the sharding plan's
  specs (``launch.sharding``: ``param_plan``, ``opt_plan``, ``cache_specs``,
  ``enc_kv_spec``, ``input_specs_train``, ``batch_spec``) applied to the
  abstract shapes (``Model.init_params`` / ``init_opt_state`` /
  ``transformer.init_cache`` on "meta").
* ``model_flops`` (``roofline.model_flops``: 6·N·D train, 2·N·D
  inference), ``params`` and ``active_params``.
* **The per-rank cost of one step** (``analysis.op_cost.step_cost``): the
  port's own model code run at this rank's shapes — its blocks of the
  plan, its rows — on "meta", FLOPs and bytes counted op by op.
* **Collectives per operation**: taken from the port's own collectives
  (``distributed/collectives.py``), which run on the fake group with
  "meta" tensors: every c10d op of the step, its result bytes and count by
  kind. The MoE FFN is the exception: it is counted as one opaque call,
  so its expert-parallel all-to-alls come from the plan's rule
  (``op_cost.moe_collectives``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun                # all 64
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b \\
        --shape train_4k --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Results: ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` (existing
cells are skipped unless ``--force``); ``python -m
repro_torch.analysis.report`` renders their roofline on the H100's
constants.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.configs import ALIASES, SHAPES, get_config, runnable_cells, skipped_cells

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
MESHES = {"single": False, "multi": True}


def fake_world(n: int) -> None:
    """This process as rank 0 of a "fake" process group of ``n`` ranks
    (collectives return at once and accept "meta" tensors)."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        if tdist.get_world_size() == n:
            return
        tdist.destroy_process_group()
    tdist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def production_dist(multi_pod: bool):
    """A ``Dist`` over the production mesh on a fake group of its size."""
    from repro_torch.distributed.context import Dist
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(512 if multi_pod else 256)
    return Dist.from_mesh(make_production_mesh(multi_pod=multi_pod, device_type="cpu"))


def input_shapes(cfg, shape_name: str) -> dict:
    """(shape, dtype) of every model input of a cell, global (the
    reference's ``dryrun.input_specs``)."""
    spec = SHAPES[shape_name]
    B, S = spec.global_batch, spec.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if spec.kind == "decode":
        return {"tokens": ((B,), i32), "kv_len": ((B,), i32)}
    s = S - cfg.n_patches if cfg.family == "vlm" else S
    out = {"tokens": ((B, s), i32)}
    if spec.kind == "train":
        out["labels"] = ((B, s), i32)
    if cfg.family == "vlm":
        out["patches"] = ((B, cfg.n_patches, cfg.d_model), bf16)
    if cfg.family == "encdec":
        out["audio"] = ((B, cfg.enc_ctx, cfg.enc_dim), bf16)
    return out


def block_bytes(shape, dtype: torch.dtype, spec, dist) -> int:
    """Bytes of one rank's block of a (shape, dtype) leaf under ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    n = 1
    for dim, axis in zip(shape, spec):
        n *= dim // dist.axis_size(axis)
    return n * dtype.itemsize


def _tree_bytes(leaves, specs, dist) -> int:
    """Per-rank bytes over a tree of "meta" tensors and its spec tree (a
    None spec or leaf counts nothing)."""
    from repro_torch.distributed.context import P
    if leaves is None or specs is None:
        return 0
    if isinstance(specs, P):
        return block_bytes(tuple(leaves.shape), leaves.dtype, specs, dist)
    if isinstance(leaves, list):
        return sum(_tree_bytes(t, s, dist) for t, s in zip(leaves, specs))
    return sum(_tree_bytes(leaves[k], specs[k], dist) for k in leaves)


@functools.cache
def meta_state(cfg) -> tuple[dict, dict]:
    """A config's parameters and AdamW state on "meta" (shapes and dtypes
    only; a function of the config)."""
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    params = Model(cfg, device="meta").init_params(0)
    return params, init_opt_state(params, AdamWConfig(state_dtype=cfg.opt_state_dtype))


def per_rank_bytes(cfg, shape_name: str, dist) -> dict:
    """Per-rank bytes of the parameters, the optimizer state, the cache and
    the inputs of a cell under ``dist``'s plan."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models.transformer import init_cache
    spec = SHAPES[shape_name]
    B, S = spec.global_batch, spec.seq_len
    training = spec.kind == "train"
    params, opt = meta_state(cfg)
    plan = shd.param_plan(cfg, dist, training=training).params
    out = {"params": _tree_bytes(params, plan, dist), "opt_state": 0, "cache": 0}
    ins = input_shapes(cfg, shape_name)
    if training:
        out["opt_state"] = _tree_bytes(opt, shd.opt_plan(plan, opt, dist), dist)
        in_specs = shd.input_specs_train(cfg, dist, B)
    else:
        cache = init_cache(cfg, B, S, "meta")
        cspecs = shd.cache_specs(cfg, dist, B, S)
        if cfg.family == "encdec":
            enc = shd.enc_kv_spec(cfg, dist, B)
            cspecs.update(ck=enc["k"], cv=enc["v"])
        out["cache"] = _tree_bytes(cache, cspecs, dist)
        b = shd.batch_spec(dist, B)
        in_specs = {k: (b,) + (None,) * (len(shape) - 1) for k, (shape, _) in ins.items()}
    out["inputs"] = sum(block_bytes(shape, dt, in_specs[k], dist)
                        for k, (shape, dt) in ins.items())
    return out


def build_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One cell's payload (see the module docstring)."""
    from repro_torch.analysis import op_cost
    from repro_torch.launch import sharding as shd
    from repro_torch.models.transformer import init_cache
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    dist = production_dist(multi_pod)
    B, S = spec.global_batch, spec.seq_len
    tokens = B if spec.kind == "decode" else B * S
    cache_bytes = 0
    if spec.kind == "decode":
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in init_cache(cfg, B, S, "meta").values())
    payload = {
        "arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod else "single",
        "n_devices": dist.n_devices,
        "per_rank_bytes": per_rank_bytes(cfg, shape_name, dist),
        "model_flops": rl.model_flops(cfg, spec.kind, tokens),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "cache_bytes": cache_bytes,
        "sharding_notes": shd.param_plan(cfg, dist, training=spec.kind == "train").notes,
    }
    t0 = time.time()
    totals = op_cost.step_cost(cfg, spec.kind, B, S, dist)
    payload["op_cost"] = totals.to_dict()
    payload["collectives"] = {"bytes": totals.collective_bytes,
                              "counts": totals.collective_counts,
                              "total_bytes": totals.total_collective_bytes}
    payload["count_s"] = round(time.time() - t0, 2)
    return payload


def cell_path(arch: str, shape: str, mesh: str, out_dir) -> Path:
    return Path(out_dir) / f"{arch}__{shape}__{mesh}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    cells = runnable_cells()
    if args.arch:
        a = ALIASES.get(args.arch, args.arch).replace("-", "_").replace(".", "_")
        cells = [c for c in cells if c[0] == a]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.list:
        for arch, shape in cells:
            for mesh in meshes:
                print(arch, shape, mesh)
        for arch, shape, why in skipped_cells():
            print(arch, shape, f"SKIP({why})")
        return 0

    torch.set_num_threads(1)
    os.makedirs(args.out, exist_ok=True)
    failures = []
    # one mesh at a time: its fake group is made once
    for mesh in meshes:
        for arch, shape in cells:
            path = cell_path(arch, shape, mesh, args.out)
            if path.exists() and not args.force:
                print(f"[skip existing] {arch} {shape} {mesh}")
                continue
            print(f"[dryrun] {arch} {shape} {mesh} ...", flush=True)
            try:
                payload = build_cell(arch, shape, MESHES[mesh])
                path.write_text(json.dumps(payload, indent=1))
                rep = rl.report_from_dryrun(payload)
                gib = {k: round(v / 2**30, 3) for k, v in payload["per_rank_bytes"].items()}
                print(f"  OK count={payload['count_s']}s per-rank GiB={gib} "
                      f"bottleneck={rep.bottleneck} roofline_frac="
                      f"{rep.roofline_fraction:.3f}", flush=True)
            except Exception as exc:        # recorded and the run goes on
                failures.append((arch, shape, mesh, repr(exc)))
                Path(str(path) + ".err").write_text(traceback.format_exc())
                print(f"  FAIL {exc!r}", flush=True)
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", *f)
        return 1
    print("\nAll requested cells counted.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
