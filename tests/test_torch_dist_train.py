"""Sharded training and elastic restore, on four gloo CPU ranks.

(c) Two sharded train steps (``TrainStep`` under a (data 2, model 2)
    mesh: FSDP gathers, tensor parallelism, expert parallelism for the
    MoE, gradients reduced over the batch axes, AdamW on the blocks with a
    global grad norm) of reduced llama3.2-3b and granite-moe-3b-a800m in
    fp32, each step held against the port's one process at the same
    state: the one process computes its loss and gradients at the
    gathered parameters the mesh started the step from (loss within 1e-5
    relative, every gradient leaf within 1e-5 of its largest |grad|), and
    runs its AdamW from the gathered parameters, moments and gradients
    of the mesh (grad norm within 1e-5 relative, every parameter's update
    within 1e-5 of its largest, plus one fp32 rounding of the parameter:
    at lr 1e-3, 1e-5 of the largest update is below the spacing of fp32
    parameters of magnitude 0.1, and the global norm's other summation
    order moves the clip scale in its last bits). The update is held from the same
    gradients because Adam divides by sqrt(v) + eps: where a gradient is
    near eps (measured: 1e-9 to 1e-8 against leaf maxima of 1e-2), its
    1e-7 relative rounding difference moves the update by up to 6 % of
    lr, though the step is right. Granite runs at capacity 8.0, where EP
    drops nothing (held: the one-process routed path has no capacity). A
    leaf replicated over a batch axis ends equal, bit for bit, on every
    rank. One llama run takes grad_accum 2, one has 1 kv head and d_ff
    129, so its attention and MLP run replicated over the model axis (the
    plan's "replicated" notes). The other families train on the mesh too
    (2 layers; jamba its 8-layer period at capacity 8.0): falcon-mamba
    (ssm: the Mamba block's tensor parallelism, the scan's Function on
    local channels), jamba (hybrid: Mamba, attention and EP MoE layers),
    whisper (encdec: the encoder and the cross-attention under tensor
    parallelism) and llava (vlm: the patch prefix).
(e) Elastic restore: a checkpoint written by one process restores onto
    the (2, 2) mesh (``restore_checkpoint(plan=, dist=)``), every rank's
    blocks bit for bit those of the saved leaves; then ``run_training``
    on the mesh writes a checkpoint (rank 0, the gathered leaves) that
    one process restores, bit for bit the ranks' blocks.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import launch_ranks

# (arch, grad_accum); "llama-replicated" has 1 kv head and d_ff 129, which
# the model axis of 2 does not divide: attention and the MLP replicated.
# The ssm, hybrid, encdec and vlm families, one each.
FAMILIES = ["falcon-mamba-7b", "jamba-v0.1-52b", "whisper-large-v3", "llava-next-mistral-7b"]
ARCHS = [("llama3.2-3b", 1), ("llama3.2-3b", 2), ("granite-moe-3b-a800m", 1),
         ("llama-replicated", 1)] + [(arch, 1) for arch in FAMILIES]
B, S, STEPS = 8, 32, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (pytest-xdist runs
    a worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch: str, accum: int):
    if arch == "llama-replicated":
        return get_config("llama3.2-3b").reduced(dtype="float32", grad_accum=accum,
                                                 n_kv_heads=1, d_ff=129)
    cfg = get_config(arch).reduced(dtype="float32", grad_accum=accum)
    if arch in FAMILIES and cfg.family != "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=2)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def _batches(cfg):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        b = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
        b["labels"][2, :11] = -1
        if cfg.family == "encdec":
            b["audio"] = torch.from_numpy(
                rng.standard_normal((B, cfg.enc_ctx, cfg.enc_dim)).astype(np.float32))
        if cfg.family == "vlm":
            b["patches"] = torch.from_numpy(
                rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32))
        out.append(b)
    return out


OPT = dict(lr=1e-3, warmup_steps=1)


def _np(tree):
    from repro_torch.models.convert import tree_map
    return tree_map(lambda t: None if t is None else t.detach().numpy().copy(), tree)


def _train_rank(rank, world):
    """STEPS steps of each run on this rank; per step the gathered
    parameters, moments and gradients it started from and computed, its
    loss and grad norm; the replicated leaves' final values."""
    from repro_torch.distributed.context import Dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import gather_tree, shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _state_specs
    from repro_torch.models import moe
    from repro_torch.models.convert import tree_leaves, tree_unflatten
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    torch.set_num_threads(1)
    dist = Dist.from_mesh(make_mesh((2, 2), ("data", "model"), "cpu"))
    out = {}
    for arch, accum in ARCHS:
        cfg = _cfg(arch, accum)
        model = Model(cfg, device="cpu", dist=dist)
        opt_cfg = AdamWConfig(**OPT)
        specs = _state_specs(model, opt_cfg)
        params = shard_tree(Model(cfg, device="cpu").init_params(0), model.plan, dist)
        opt = init_opt_state(params, opt_cfg, dist=dist, specs=model.plan)
        step = make_train_step(model, opt_cfg)
        steps, routed = [], []
        for batch in _batches(cfg):
            state = _np(gather_tree({"params": params, "opt": opt}, specs, dist))
            with mock.patch.object(moe, "_moe_local", wraps=moe._moe_local) as spy:
                loss, grads = step.grads(params, batch)
            routed += spy.call_args_list
            full_grads = _np(gather_tree(tree_unflatten(params, grads), model.plan, dist))
            gnorm = float(step.update(params, opt, grads)["grad_norm"])
            steps.append(dict(state=state, grads=full_grads, loss=float(loss), gnorm=gnorm))
        replicated = [p.detach().clone() for p, s in zip(tree_leaves(params),
                                                         tree_leaves(model.plan)) if not any(s)]
        dropped = sum(int((~moe.kept_pairs(c.args[1], cfg, c.kwargs["n_data"],
                                           c.kwargs["e_pad"])).sum()) for c in routed)
        out[(arch, accum)] = dict(steps=steps, dropped=dropped, ep_calls=len(routed),
                                  replicated=replicated,
                                  final=_np(gather_tree(params, model.plan, dist)))
    return out


@pytest.fixture(scope="module")
def trained():
    return launch_ranks(_train_rank, 4, backend="gloo", device="cpu", timeout=300)


@pytest.mark.parametrize("arch,accum", ARCHS)
def test_sharded_steps_match_one_process(trained, arch, accum):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.convert import to_tensor, tree_leaves, tree_map, tree_unflatten
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, apply_adamw
    cfg = _cfg(arch, accum)
    model = Model(cfg, device="cpu")
    step = make_train_step(model, AdamWConfig(**OPT))
    ranks = [out[(arch, accum)] for out in trained]
    mesh = ranks[0]
    assert all(r["dropped"] == 0 for r in ranks)
    assert (mesh["ep_calls"] > 0) == bool(cfg.n_experts)     # the MoE went through EP
    assert all([(s["loss"], s["gnorm"]) for s in r["steps"]]
               == [(s["loss"], s["gnorm"]) for s in mesh["steps"]] for r in ranks)
    nxt = [s["state"]["params"] for s in mesh["steps"][1:]] + [mesh["final"]]
    for s, after, batch in zip(mesh["steps"], nxt, _batches(cfg)):
        params = tree_map(lambda a: to_tensor(a, "cpu"), s["state"]["params"])
        loss, grads = step.grads(params, batch)
        assert abs(float(loss) - s["loss"]) <= 1e-5 * abs(float(loss))
        for g, got in zip(grads, tree_leaves(s["grads"])):
            assert float((g - torch.from_numpy(got)).abs().max()) <= 1e-5 * float(g.abs().max())
        # AdamW from the mesh's state and gradients, in one process
        params = tree_map(lambda a: to_tensor(a, "cpu"), s["state"]["params"])
        opt = tree_map(lambda a: None if a is None else to_tensor(a, "cpu"), s["state"]["opt"])
        grads = tree_unflatten(params, [torch.from_numpy(g) for g in tree_leaves(s["grads"])])
        before = [t.clone() for t in tree_leaves(params)]
        gnorm = float(apply_adamw(params, grads, opt, AdamWConfig(**OPT))["grad_norm"])
        assert abs(gnorm - s["gnorm"]) <= 1e-5 * gnorm
        for p0, p1, got in zip(before, tree_leaves(params), tree_leaves(after)):
            # the update within 1e-5 of the largest, plus the one rounding of
            # p + update to fp32 (2^-23 |p|: above 1e-5 of an update of 1e-3)
            bound = 1e-5 * (p1 - p0).abs().max() + 2.0 ** -23 * p1.abs()
            assert bool(((torch.from_numpy(got) - p1).abs() <= bound).all())
    for leaves in zip(*(r["replicated"] for r in ranks)):
        assert all(torch.equal(leaves[0], t) for t in leaves)


def _restore_rank(rank, world, saved_dir, mesh_dir):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.distributed.context import Dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import local_block
    from repro_torch.launch.train import _state_specs, run_training
    from repro_torch.models.convert import tree_leaves
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    torch.set_num_threads(1)
    dist = Dist.from_mesh(make_mesh((2, 2), ("data", "model"), "cpu"))
    cfg = _cfg("llama3.2-3b", 1)
    specs = _state_specs(Model(cfg, device="cpu", dist=dist), AdamWConfig())
    full, _, _ = restore_checkpoint(saved_dir, device="cpu")
    mine, _, _ = restore_checkpoint(saved_dir, device="cpu", plan=specs, dist=dist)
    leaf_specs = [s for s in tree_leaves(specs) if s is not None]   # no int8 scales here
    restored = len(leaf_specs) == len(tree_leaves(full)) and all(
        torch.equal(local_block(f, s, dist), m)
        for f, s, m in zip(tree_leaves(full), leaf_specs, tree_leaves(mine)))
    res = run_training(cfg, steps=2, batch=B, seq=S, ckpt_dir=mesh_dir, device="cpu",
                       dist=dist, log=lambda *_: None)
    blocks = [t.detach().clone() for t in tree_leaves(res["params"])]
    return restored, blocks, specs["params"], (dist.coord("data"), dist.coord("model"))


def test_elastic_restore_both_ways(tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.models.convert import tree_leaves
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cfg = _cfg("llama3.2-3b", 1)
    params = Model(cfg, device="cpu").init_params(5)
    opt = init_opt_state(params, AdamWConfig())
    for t in tree_leaves(opt["m"]):
        if t is not None:
            t.normal_(generator=torch.Generator().manual_seed(2))
    save_checkpoint(str(tmp_path / "one"), 3, {"params": params, "opt": opt})
    out = launch_ranks(_restore_rank, 4, backend="gloo", device="cpu", timeout=300,
                       args=(str(tmp_path / "one"), str(tmp_path / "mesh")))
    assert all(restored for restored, _, _, _ in out)
    # the mesh's checkpoint in one process: each rank's blocks, bit for bit
    tree, _, step = restore_checkpoint(str(tmp_path / "mesh"), device="cpu")
    assert step == 2
    for _, blocks, plan, coords in out:
        at = {"data": coords[0], "model": coords[1]}
        for full, spec, block in zip(tree_leaves(tree["params"]), tree_leaves(plan), blocks):
            want = full
            for dim, axis in enumerate(spec):
                if axis is not None:
                    size = want.shape[dim] // 2
                    want = want.narrow(dim, at[axis] * size, size)
            assert torch.equal(want, block)
