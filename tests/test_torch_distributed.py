"""Distribution against the reference, on gloo CPU ranks.

The reference runs once, in a subprocess on 8 host devices
(``--xla_force_host_platform_device_count``), and writes its inputs,
parameters and results to a pickle; the port runs the same inputs in
ranks started by ``launch_ranks`` (gloo, CPU), and its one-process
counterparts run here. Inputs come from numpy seeds, the parameters from
the reference's init (``params_from_reference``, then ``shard_tree``).

(a) ``moe_ffn_ep`` on (pod 2, data 2, model 2), token-parallel (12
    experts, d_ff_expert 32: stored over (pod, data)) and the default
    layout (9 experts padded to 10, d_ff_expert 256, reduce-scattered
    over d), at capacity factors 4.0 and 1.0: output within 1e-5 (fp32)
    of the reference's ``moe_ffn_ep`` on the same mesh, aux within 1e-6,
    and the kept (token, choice) pairs equal to the reference's (its
    ``_moe_local`` capacity rule applied to its own routing). The router
    favours data shard 0's experts (their columns scaled by 3), so at 1.0
    pairs are dropped; at 4.0 none can be, and the output is also the
    port's ``moe_ffn_dense_exact``'s.
(b) The loss of reduced granite-moe (2 layers, capacity 4.0) on (data 2,
    model 2) against the reference's loss on the same mesh and the port's
    one-process loss: fp32 within 1e-5, bf16 within 5e-3 (the reference's
    own bound between its mesh and single-device losses).
(b') The loss of reduced falcon-mamba-7b (ssm), whisper-large-v3
    (encdec, with its audio) and llava-next-mistral-7b (vlm, with its
    patches), 2 layers, fp32, on (data 2, model 2) against the
    reference's meshed loss and the port's one-process loss, within 1e-5.
(d) ``make_pp_loss`` on (pod 2, data 1, model 2) with reduced llama, 4
    layers, n_micro 4: within 1e-5 (fp32) of the reference's pipeline loss
    and of the port's sequential loss (the reference's bound is 2e-3).
    Its gradients (``loss.backward()`` on every rank, the reverse drain),
    n_micro 1, 2 and 4, gathered: each leaf within 1e-4 of its largest
    |grad| of ``jax.grad`` of the reference's pipeline loss and of the
    port's sequential loss's gradients.
(e) ``layers.row_parallel`` in bf16 on (data 2, model 2), its rows split
    over ``model``: equal bit for bit to one device's bf16 product, on
    inputs where bf16 partial sums would round otherwise.
(f) A rank that raises makes ``launch_ranks`` raise, well within its
    timeout.

The reference's attention rounds its probabilities to bf16; the
subprocess swaps in ``attend_prefill_exact`` (fp32 probabilities, the
function the port's plain attention computes), as the training tests do.
Sharded training steps and elastic restore are in
``test_torch_dist_train.py``.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_ranks

ROOT = Path(__file__).resolve().parents[1]
MOE_CASES = [(tp, cf) for tp in (True, False) for cf in (4.0, 1.0)]
# The ssm, encdec and vlm families' sharded losses (b').
FAMILIES = ["falcon_mamba_7b", "whisper_large_v3", "llava_next_mistral_7b"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (pytest-xdist runs
    a worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REFERENCE = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, "tests")
import repro.models.attention as jattn
from _exact_attention import attend_prefill_exact
jattn.attend_prefill = attend_prefill_exact
from repro.configs import get_config
from repro.distributed.context import Dist
from repro.launch import sharding as shd
from repro.launch.mesh import make_mesh
from repro.launch.pipeline import make_pp_loss, reshape_stack_for_pp
from repro.models import moe as jmoe
from repro.models.config import ArchConfig
from repro.models.layers import init_moe
from repro.models.model import Model

def npy(tree):
    return jax.tree.map(np.asarray, tree)

out = {"moe": {}, "loss": {}}
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
dist = Dist.from_mesh(mesh)
x = np.random.default_rng(3).standard_normal((64, 64)).astype(np.float32)
for tp, cf in CASES:
    E, ffe = (12, 32) if tp else (9, 256)
    cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab_size=512, n_experts=E, moe_top_k=3,
                     d_ff_expert=ffe, capacity_factor=cf, dtype="float32")
    p = init_moe(jax.random.key(1), cfg)
    # the first half of the experts (data shard 0's) scored up: capacity
    # 1.0 then drops pairs
    p["router"] = p["router"].at[:, :E // 2].multiply(3.0)
    y, aux = jax.jit(lambda x, p: jmoe.moe_ffn_ep(x, p, cfg, dist, token_parallel=tp))(
        jnp.asarray(x), p)
    # the kept pairs: _moe_local's capacity rule on the reference's routing
    e_pad = jmoe.padded_experts(E, dist.n_data)
    ids, _, _ = jmoe.route(jnp.asarray(x), p["router"], cfg, e_pad)
    shards = 8 if tp else 4
    t_loc = 64 // shards
    e_loc = e_pad // dist.n_data
    C = jmoe._capacity(t_loc, cfg.moe_top_k, dist.n_data, cf)
    keep = []
    for s in range(shards):
        dest = (ids[s * t_loc:(s + 1) * t_loc].reshape(-1) // e_loc)
        order = jnp.argsort(dest, stable=True)
        s_dest = dest[order]
        starts = jnp.searchsorted(s_dest, jnp.arange(dist.n_data, dtype=s_dest.dtype))
        pos = jnp.arange(dest.shape[0]) - starts[s_dest]
        kept = jnp.zeros(dest.shape[0], bool).at[order].set(pos < C)
        keep.append(np.asarray(kept).reshape(t_loc, cfg.moe_top_k))
    out["moe"][(tp, cf)] = dict(params=npy(p), y=np.asarray(y), aux=float(aux),
                                keep=np.concatenate(keep), ids=np.asarray(ids))
out["x"] = x

rng = np.random.default_rng(0)
batch = {"tokens": rng.integers(1, 256, (8, 32)).astype(np.int32),
         "labels": rng.integers(0, 256, (8, 32)).astype(np.int32)}
batch["labels"][1, :9] = -1
out["batch"] = batch
jb = {k: jnp.asarray(v) for k, v in batch.items()}
mesh22 = make_mesh((2, 2), ("data", "model"))
dist22 = Dist.from_mesh(mesh22)
for dtype in ("float32", "bfloat16"):
    cfg = get_config("granite_moe_3b_a800m").reduced(
        n_layers=2, vocab_size=256, capacity_factor=4.0, dtype=dtype)
    params = Model(cfg, None).init_params(jax.random.key(0))
    single, _ = jax.jit(Model(cfg, None).loss_fn)(params, jb)
    sharded = jax.device_put(params, shd.param_plan(cfg, dist22, training=True).shardings(mesh22))
    meshed, _ = jax.jit(Model(cfg, dist22).loss_fn)(sharded, jb)
    out["loss"][dtype] = dict(params=npy(params), single=float(single), mesh=float(meshed))

out["family"] = {}
for name in FAMILIES:
    cfg = get_config(name).reduced(n_layers=2, vocab_size=256, dtype="float32")
    fb = dict(batch)
    if cfg.family == "encdec":
        fb["audio"] = rng.standard_normal((8, cfg.enc_ctx, cfg.enc_dim)).astype(np.float32)
    if cfg.family == "vlm":
        fb["patches"] = rng.standard_normal((8, cfg.n_patches, cfg.d_model)).astype(np.float32)
    fj = {k: jnp.asarray(v) for k, v in fb.items()}
    params = Model(cfg, None).init_params(jax.random.key(0))
    single, _ = jax.jit(Model(cfg, None).loss_fn)(params, fj)
    sharded = jax.device_put(params, shd.param_plan(cfg, dist22, training=True).shardings(mesh22))
    meshed, _ = jax.jit(Model(cfg, dist22).loss_fn)(sharded, fj)
    out["family"][name] = dict(params=npy(params), batch=fb, single=float(single),
                               mesh=float(meshed))

cfg = get_config("llama3_2_3b").reduced(n_layers=4, vocab_size=256, dtype="float32")
params = Model(cfg, None).init_params(jax.random.key(0))
seq, _ = jax.jit(Model(cfg, None).loss_fn)(params, jb)
mesh212 = make_mesh((2, 1, 2), ("pod", "data", "model"))
m = Model(cfg, Dist.from_mesh(mesh212))
pp_params = dict(params)
pp_params["stack"] = reshape_stack_for_pp(params["stack"], 2)
pp, _ = jax.jit(make_pp_loss(m, n_micro=4))(pp_params, jb)
grads = jax.jit(jax.grad(lambda p: make_pp_loss(m, n_micro=4)(p, jb)[0]))(pp_params)
grads["stack"] = jax.tree.map(lambda a: a.reshape(-1, *a.shape[2:]), grads["stack"])
out["pp"] = dict(params=npy(params), seq=float(seq), pp=float(pp), grads=npy(grads))
with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "out.pkl"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    code = (f"CASES = {MOE_CASES!r}\nFAMILIES = {FAMILIES!r}\nOUT = {str(path)!r}\n"
            + textwrap.dedent(REFERENCE))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:          # written by the subprocess above
        return pickle.load(f)


def _moe_cfg(tp: bool, cf: float):
    from repro_torch.models.config import ArchConfig
    E, ffe = (12, 32) if tp else (9, 256)
    return ArchConfig(name="t", family="moe", n_layers=1, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=512, n_experts=E, moe_top_k=3,
                      d_ff_expert=ffe, capacity_factor=cf, dtype="float32")


def _moe_rank(rank, world, cases, x, params):
    """Each case's moe_ffn_ep on this rank: (its token rows, y, the rows
    it routed, their kept mask, the global aux)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.context import Dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import param_plan, shard_tree
    from repro_torch.models import moe
    from repro_torch.models.convert import to_tensor, tree_map
    torch.set_num_threads(1)
    dist = Dist.from_mesh(make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu"))
    out = {}
    for (tp, cf), p in zip(cases, params):
        cfg = _moe_cfg(tp, cf)
        pspec = param_plan(cfg, dist, training=True).params["layers"][0]["mlp"]
        local = shard_tree(tree_map(lambda a: to_tensor(a, "cpu"), p), pspec, dist)
        t_loc = x.shape[0] // (dist.n_pod * dist.n_data)
        b = dist.coord(dist.batch_axes)
        xs = torch.from_numpy(x[b * t_loc:(b + 1) * t_loc])
        with mock.patch.object(moe, "_moe_local", wraps=moe._moe_local) as spy:
            y, aux = moe.moe_ffn_ep(xs, local, cfg, dist, token_parallel=tp, pspec=pspec)
        (call,) = spy.call_args_list        # the kept pairs, from the ids it routed
        keep = moe.kept_pairs(call.args[1], cfg, call.kwargs["n_data"], call.kwargs["e_pad"])
        rows = routed = slice(b * t_loc, (b + 1) * t_loc)
        if tp:              # each model rank routes its half of the rows
            m = dist.coord(dist.model_axis)
            routed = slice(rows.start + m * t_loc // 2, rows.start + (m + 1) * t_loc // 2)
        out[(tp, cf)] = (rows, y.numpy(), routed, keep.numpy(),
                         float(coll.all_reduce(aux, dist, dist.batch_axes)))
    return out


@pytest.fixture(scope="module")
def moe_ranks(reference):
    params = [reference["moe"][case]["params"] for case in MOE_CASES]
    return launch_ranks(_moe_rank, 8, backend="gloo", device="cpu", timeout=240,
                        args=(MOE_CASES, reference["x"], params))


@pytest.mark.parametrize("tp,cf", MOE_CASES)
def test_moe_ffn_ep_matches_reference(reference, moe_ranks, tp, cf):
    from repro_torch.models import moe
    from repro_torch.models.convert import to_tensor, tree_map
    ref = reference["moe"][(tp, cf)]
    y = np.full_like(ref["y"], np.nan)
    keep = np.zeros_like(ref["keep"])
    for out in moe_ranks:
        rows, y_r, routed, keep_r, aux = out[(tp, cf)]
        y[rows] = y_r
        keep[routed] = keep_r
        assert abs(aux - ref["aux"]) <= 1e-6
    assert np.array_equal(keep, ref["keep"])
    assert np.max(np.abs(y - ref["y"])) <= 1e-5
    if cf == 4.0:
        assert keep.all()
        p = tree_map(lambda a: to_tensor(a, "cpu"), ref["params"])
        want, aux = moe.moe_ffn_dense_exact(torch.from_numpy(reference["x"]), p,
                                            _moe_cfg(tp, cf))
        assert np.max(np.abs(y - want.numpy())) <= 1e-5
    else:
        assert not keep.all()          # capacity 1.0 drops pairs on this seed


def _row_parallel_inputs():
    """a (16, 64) in {-1, 0, 1}, w (64, 32) in 512ths up to 1/4, bf16: every
    product and sum exact in fp32 in any order, and a row split in two
    whose bf16-rounded partials sum otherwise than the whole on this
    seed."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(-1, 2, (16, 64)).astype(np.float32))
    w = torch.from_numpy((rng.integers(-128, 129, (64, 32)) / 512).astype(np.float32))
    return a.bfloat16(), w.bfloat16()


def _model_rank(rank, world, loss_params, pp_params, batch, family):
    """(b) the sharded granite-moe loss in fp32 and bf16 on (2, 2); (b')
    the other families' sharded losses on (2, 2); (e) the bf16 row-split
    product on (2, 2); (d) the GPipe loss of llama on (2, 1, 2) and, rank
    0, its gathered gradients for each n_micro."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import Dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.pipeline import make_pp_loss, pp_stack_specs, reshape_stack_for_pp
    from repro_torch.launch.sharding import gather_tree, shard_batch, shard_tree
    from repro_torch.models.convert import (params_from_reference, tree_leaves, tree_map,
                                            tree_unflatten)
    from repro_torch.models.layers import row_parallel
    from repro_torch.models.model import Model
    torch.set_num_threads(1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    dist = Dist.from_mesh(make_mesh((2, 2), ("data", "model"), "cpu"))
    for dtype, np_params in loss_params.items():
        cfg = get_config("granite_moe_3b_a800m").reduced(
            n_layers=2, vocab_size=256, capacity_factor=4.0, dtype=dtype)
        model = Model(cfg, device="cpu", dist=dist)
        local = shard_tree(params_from_reference(np_params, cfg, "cpu"), model.plan, dist)
        with torch.no_grad():
            out[dtype] = float(model.loss_fn(local, shard_batch(tb, cfg, dist))[0])
    for name, ref in family.items():
        cfg = get_config(name).reduced(n_layers=2, vocab_size=256, dtype="float32")
        model = Model(cfg, device="cpu", dist=dist)
        local = shard_tree(params_from_reference(ref["params"], cfg, "cpu"), model.plan, dist)
        fb = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
        with torch.no_grad():
            out[name] = float(model.loss_fn(local, shard_batch(fb, cfg, dist))[0])
    a, w = _row_parallel_inputs()
    k = a.shape[1] // dist.n_model
    m = dist.coord(dist.model_axis)
    out["row_parallel"] = row_parallel(a[:, m * k:(m + 1) * k], w[m * k:(m + 1) * k], dist,
                                       dist.model_axis)
    cfg = get_config("llama3_2_3b").reduced(n_layers=4, vocab_size=256, dtype="float32")
    dist = Dist.from_mesh(make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu"))
    model = Model(cfg, device="cpu", dist=dist)
    full = params_from_reference(pp_params, cfg, "cpu")
    full["layers"] = reshape_stack_for_pp(full["layers"], 2)
    specs = dict(model.plan, layers=pp_stack_specs(model.plan["layers"], 2))
    out["pp"] = float(make_pp_loss(model, n_micro=4)(shard_tree(full, specs, dist), tb)[0])
    out["pp_grads"] = {}
    for n_micro in (1, 2, 4):
        local = shard_tree(full, specs, dist)
        leaves = tree_leaves(local)
        for p in leaves:
            p.requires_grad_(True)
        make_pp_loss(model, n_micro=n_micro)(local, tb)[0].backward()
        grads = gather_tree(tree_unflatten(local, [p.grad for p in leaves]), specs, dist)
        # back to the sequential stack's layers: stage s's j-th is layer s·L/P + j
        grads["layers"] = [tree_map(lambda t: t[s], layer) for s in range(dist.n_pod)
                           for layer in grads["layers"]]
        if rank == 0:
            out["pp_grads"][n_micro] = [t.numpy() for t in tree_leaves(grads)]
    return out


@pytest.fixture(scope="module")
def model_ranks(reference):
    loss_params = {k: v["params"] for k, v in reference["loss"].items()}
    return launch_ranks(_model_rank, 4, backend="gloo", device="cpu", timeout=120,
                        args=(loss_params, reference["pp"]["params"], reference["batch"],
                              reference["family"]))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
def test_sharded_loss_matches_reference(reference, model_ranks, dtype, tol):
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.model import Model
    ref = reference["loss"][dtype]
    cfg = get_config("granite_moe_3b_a800m").reduced(
        n_layers=2, vocab_size=256, capacity_factor=4.0, dtype=dtype)
    batch = {k: torch.from_numpy(v) for k, v in reference["batch"].items()}
    with torch.no_grad():
        single = float(Model(cfg, device="cpu").loss_fn(
            params_from_reference(ref["params"], cfg, "cpu"), batch)[0])
    losses = {out[dtype] for out in model_ranks}
    assert len(losses) == 1                   # the same value on every rank
    (loss,) = losses
    assert abs(loss - ref["mesh"]) <= tol * abs(ref["mesh"])
    assert abs(loss - single) <= tol * abs(single)
    assert abs(single - ref["single"]) <= tol * abs(ref["single"])


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_family_loss_matches_reference(reference, model_ranks, name):
    """The ssm, encdec and vlm families' losses on (data 2, model 2): the
    same on every rank, within 1e-5 of the reference's meshed loss and of
    the port's one process."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.model import Model
    ref = reference["family"][name]
    cfg = get_config(name).reduced(n_layers=2, vocab_size=256, dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    with torch.no_grad():
        single = float(Model(cfg, device="cpu").loss_fn(
            params_from_reference(ref["params"], cfg, "cpu"), batch)[0])
    losses = {out[name] for out in model_ranks}
    assert len(losses) == 1
    (loss,) = losses
    assert abs(loss - ref["mesh"]) <= 1e-5 * abs(ref["mesh"])
    assert abs(loss - single) <= 1e-5 * abs(single)
    assert abs(single - ref["single"]) <= 1e-5 * abs(ref["single"])


def test_pipeline_loss_matches_reference(reference, model_ranks):
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.model import Model
    ref = reference["pp"]
    cfg = get_config("llama3_2_3b").reduced(n_layers=4, vocab_size=256, dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in reference["batch"].items()}
    with torch.no_grad():
        seq = float(Model(cfg, device="cpu").loss_fn(
            params_from_reference(ref["params"], cfg, "cpu"), batch)[0])
    losses = {out["pp"] for out in model_ranks}
    assert len(losses) == 1
    (pp,) = losses
    assert abs(ref["pp"] - ref["seq"]) <= 2e-3       # the reference's own bound
    assert abs(pp - ref["pp"]) <= 1e-5 * abs(ref["pp"])
    assert abs(pp - seq) <= 1e-5 * abs(seq)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipeline_grads_match_reference(reference, model_ranks, n_micro):
    """GPipe's backward on (pod 2, data 1, model 2): every gathered leaf
    within 1e-4 of its largest |grad| of the reference's pipeline grads
    (``jax.grad`` of its jitted ``make_pp_loss``) and of the port's
    sequential loss's grads."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_reference, tree_leaves
    from repro_torch.models.model import Model
    ref = reference["pp"]
    cfg = get_config("llama3_2_3b").reduced(n_layers=4, vocab_size=256, dtype="float32")
    params = params_from_reference(ref["params"], cfg, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in reference["batch"].items()}
    seq = torch.autograd.grad(Model(cfg, device="cpu").loss_fn(params, batch)[0], leaves)
    want = tree_leaves(params_from_reference(ref["grads"], cfg, "cpu"))
    got = model_ranks[0]["pp_grads"][n_micro]
    assert len(got) == len(want) == len(seq)
    for i, (g, w, s) in enumerate(zip(got, want, seq)):
        g = torch.from_numpy(g)
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), i
        assert float((g - s).abs().max()) <= 1e-4 * float(s.abs().max()), i


def test_row_parallel_bf16_rounds_once(model_ranks):
    """bf16 rows split over ``model``: the partial products summed in fp32
    and rounded once, equal bit for bit to one device's bf16 product on
    every rank. The inputs are such that bf16 partial sums would not be."""
    a, w = _row_parallel_inputs()
    single = a @ w
    assert torch.equal(single, (a.float() @ w.float()).bfloat16())
    k = a.shape[1] // 2
    halves = [a[:, :k].float() @ w[:k].float(), a[:, k:].float() @ w[k:].float()]
    assert not torch.equal(halves[0].bfloat16() + halves[1].bfloat16(), single)
    for out in model_ranks:
        assert out["row_parallel"].dtype == torch.bfloat16
        assert torch.equal(out["row_parallel"], single)


def _raises(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()        # the others wait for it, forever


def test_a_failing_rank_fails_the_launch():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        launch_ranks(_raises, 4, backend="gloo", device="cpu", timeout=60)
    assert time.monotonic() - t0 < 30


def test_no_card_no_cpu_refuses():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_ranks(_raises, 2, backend="nccl")
