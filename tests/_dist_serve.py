"""The sharded-serving harness of ``test_torch_dist_serve*.py``.

``run_reference`` runs the reference's meshed serving of a list of cases
(reference config name, B, mesh (data, model), config overrides) in a
subprocess on 8 host devices; ``serve_case`` runs one case on a port
rank, teacher-forced with the reference's tokens; ``check_case`` holds
the port's ranks to the reference's logits, cache and MoE dispatch.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
S, MAXLEN, NEW = 12, 24, 4
TOL = 1e-4


def case_ids(cases) -> list[str]:
    return [f"{n.split('_')[0]}-B{b}-{m[0]}x{m[1]}" + "".join(f"-{k}" for k in o)
            for n, b, m, o in cases]


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
from repro.models import moe as jmoe
from repro.models.model import Model

taken = []
orig_ep, orig_dense = jmoe.moe_ffn_ep, jmoe.moe_ffn_dense_exact
def ep(*a, **k):
    taken.append("ep")
    return orig_ep(*a, **k)
def dense(*a, **k):
    taken.append("dense")
    return orig_dense(*a, **k)
jmoe.moe_ffn_ep, jmoe.moe_ffn_dense_exact = ep, dense

def npy(tree):
    return jax.tree.map(np.asarray, tree)

meshes, out = {}, []
for name, B, shape, over in CASES:
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"))
    mesh = meshes[shape]
    dist = Dist.from_mesh(mesh)
    cfg = get_config(name).reduced(**CFG(name, over))
    rng = np.random.default_rng(B)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["audio"] = rng.standard_normal((B, cfg.enc_ctx, cfg.enc_dim)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    params = Model(cfg, None).init_params(jax.random.key(1))
    placed = jax.device_put(params, shd.param_plan(cfg, dist, training=False).shardings(mesh))
    m = Model(cfg, dist)
    del taken[:]
    logits, cache, kv = jax.jit(m.prefill, static_argnums=2)(
        placed, {k: jnp.asarray(v) for k, v in batch.items()}, MAXLEN)
    dispatch = {"prefill": list(taken)}
    del taken[:]
    step = jax.jit(m.decode_step)
    logits_all, toks = [np.asarray(logits)], []
    for _ in range(NEW):
        tok = jnp.argmax(logits[:, :cfg.vocab_size], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache, kv = step(placed, cache, tok, kv)
        logits_all.append(np.asarray(logits))
    dispatch["decode"] = list(taken)
    out.append(dict(params=npy(params), batch=batch, logits=logits_all, tokens=toks,
                    cache=npy(cache), dispatch=dispatch))
with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


def cfg_kwargs(name: str, over: dict) -> dict:
    """The reduced config's overrides: fp32, 2 layers (jamba keeps its
    8-layer period), and the case's own."""
    kw = {"dtype": "float32", **over}
    if not name.startswith("jamba"):
        kw["n_layers"] = 2
    return kw


def run_reference(cases, path: Path) -> list:
    """The reference's meshed serving of ``cases`` in a subprocess on 8
    host devices; its pickled results."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    code = (f"CASES = {cases!r}\nS, MAXLEN, NEW = {S}, {MAXLEN}, {NEW}\n"
            f"OUT = {str(path)!r}\n"
            "def CFG(name, over):\n"
            "    kw = {'dtype': 'float32', **over}\n"
            "    if not name.startswith('jamba'):\n"
            "        kw['n_layers'] = 2\n"
            "    return kw\n" + textwrap.dedent(REFERENCE))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:          # written by the subprocess above
        return pickle.load(f)


def serve_case(dist, name, B, over, ref) -> dict:
    """One case on this rank: prefill and the teacher-forced decode steps;
    every step's logits gathered over the batch axes, the cache gathered
    (on every rank), and the MoE dispatch per call, per layer."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.sharding import batch_spec, gather_tree, shard_tree
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.model import Model
    cfg = get_config(name).reduced(**cfg_kwargs(name, over))
    model = Model(cfg, device="cpu", dist=dist)
    params = shard_tree(params_from_reference(ref["params"], cfg, "cpu"), model.serve_plan,
                        dist)
    rows, axes = model.rows(B), batch_spec(dist, B)
    batch = {k: torch.from_numpy(v[rows]) for k, v in ref["batch"].items()}
    taken, calls = [], {}

    def spy(kind, fn):
        def wrapped(*a, **k):
            taken.append(kind)
            return fn(*a, **k)
        return wrapped

    with mock.patch.object(moe, "moe_ffn_ep", spy("ep", moe.moe_ffn_ep)), \
            mock.patch.object(moe, "_moe_dense_sharded",
                              spy("dense", moe._moe_dense_sharded)):
        logits, cache, kv = model.prefill(params, batch, MAXLEN, batch_size=B)
        calls["prefill"] = list(taken)
        out = [logits]
        for tok in ref["tokens"]:
            del taken[:]
            logits, cache, kv = model.decode_step(params, cache,
                                                  torch.from_numpy(tok[rows]), kv)
            calls.setdefault("decode", []).append(list(taken))
            out.append(logits)
    return {"logits": [coll.gather_value(o, 0, dist, axes).numpy() for o in out],
            "cache": {k: v.numpy() for k, v in gather_tree(dict(cache), cache.specs,
                                                           dist).items()},
            "kv_len": kv.numpy(), "dispatch": calls}


def port_cache(ref_cache: dict, name: str, over: dict) -> dict:
    """The reference's group-stacked cache ({"stack": {"sub<i>": ...},
    "enc_kv"}) in the port's layout: each kind's layers stacked in layer
    order, the cross K/V as ck / cv."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config(name).reduced(**cfg_kwargs(name, over))
    group, _ = tf.layer_groups(cfg)
    leaves = {}
    for layer in range(cfg.n_layers):
        i, g = layer % len(group), layer // len(group)
        for leaf, t in ref_cache["stack"][f"sub{i}"].items():
            leaves.setdefault(leaf, []).append(t[g])
    out = {k: np.stack(v) for k, v in leaves.items()}
    if "enc_kv" in ref_cache:
        out["ck"], out["cv"] = ref_cache["enc_kv"]["k"], ref_cache["enc_kv"]["v"]
    return out


def check_case(ref, ranks, i, name, over):
    """The case's logits on every rank, its cache and its MoE dispatch
    against the reference's."""
    for r in ranks:
        got = r["cases"][i]["logits"]
        assert len(got) == len(ref["logits"]) == NEW + 1
        for step, (g, w) in enumerate(zip(got, ref["logits"])):
            err = float(np.abs(g - w).max())
            assert err <= TOL, (step, err)
    mine = ranks[0]["cases"][i]
    want = port_cache(ref["cache"], name, over)
    assert sorted(mine["cache"]) == sorted(want)
    for leaf, w in want.items():
        assert mine["cache"][leaf].shape == w.shape, leaf
        assert float(np.abs(mine["cache"][leaf] - w).max()) <= TOL, leaf
    n_groups = max(1, len(mine["dispatch"]["prefill"]) // max(1, len(ref["dispatch"]["prefill"])))
    assert mine["dispatch"]["prefill"] == ref["dispatch"]["prefill"] * n_groups
    for step in mine["dispatch"]["decode"]:
        assert step == ref["dispatch"]["decode"] * n_groups
