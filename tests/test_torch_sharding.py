"""The port's sharding plans against the reference's, and its meshes.

For every config in ``configs`` on the meshes (4, 2), (2, 2, 2), (16, 16)
and (2, 16, 16): ``param_plan`` (training and serving) with its notes,
``opt_plan`` (fp32 and int8 moments), ``input_specs_train``,
``cache_specs``, ``enc_kv_spec`` and ``batch_spec`` equal the
reference's, leaf for leaf. The reference runs in one subprocess on 512
host devices (``--xla_force_host_platform_device_count``), the port in
one subprocess on a fake process group of the mesh's size
(``FakeStore``, backend "fake"), so this process's default group stays
uninitialized. Each prints JSON: every spec as a list of entries (a name,
null, or a list of names), keyed by its path.

The port's plan has one spec per layer where the reference's stack is
group-stacked: port layer i's spec is the reference's ``stack.sub{i %
len(group)}`` spec without its leading None (so are its moments'), and
the port's cache specs are the reference's per-sublayer ones (k / v of
an attention sublayer, h / conv of a Mamba one), which already carry the
layer (group) dim first.

Also: ``make_production_mesh``'s shapes, a mesh whose size differs from
the world raising, and ``shard_tree`` then ``gather_tree`` on four gloo
ranks giving back every leaf bit for bit.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models.model import Model
from repro_torch.models.transformer import layer_groups

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BATCHES = (1, 2, 8, 32, 256, 512)
CACHES = ((1, 32768), (8, 4096), (256, 2048))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (pytest-xdist runs
    a worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Shared by both subprocesses: walk a spec tree into {path: entries}.
FLAT = """
def enc(spec):
    return [None if a is None else (list(a) if isinstance(a, tuple) else a) for a in spec]

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: None if tree is None else enc(tree)}

def specs(shd, dist, cfg, opt_shapes):
    r = {}
    for training in (True, False):
        plan = shd.param_plan(cfg, dist, training=training)
        r[f"plan_{training}"], r[f"notes_{training}"] = flat(plan.params), plan.notes
    train = shd.param_plan(cfg, dist, training=True).params
    for sd, shapes in opt_shapes.items():
        r[f"opt_{sd}"] = flat(shd.opt_plan(train, shapes, dist))
    r["inputs"] = {b: flat(shd.input_specs_train(cfg, dist, b)) for b in BATCHES}
    r["cache"] = {f"{b}_{s}": flat(shd.cache_specs(cfg, dist, b, s)) for b, s in CACHES}
    r["enc_kv"] = {b: flat(shd.enc_kv_spec(cfg, dist, b)) for b in BATCHES}
    r["batch"] = {b: enc([shd.batch_spec(dist, b)]) for b in BATCHES}
    return r
"""

REFERENCE = """
import json, jax
from repro.configs import get_config
from repro.distributed.context import Dist
from repro.launch import sharding as shd
from repro.launch.mesh import make_mesh
from repro.models.model import Model
from repro.optim.adamw import AdamWConfig, init_opt_state
import functools
shd._shape_tree = functools.cache(shd._shape_tree)     # a function of the config
opt = {}
for arch in ARCH_IDS:
    shapes = Model(get_config(arch)).param_shapes()
    opt[arch] = {sd: jax.eval_shape(lambda p: init_opt_state(p, AdamWConfig(state_dtype=sd)),
                                    shapes) for sd in ("fp32", "int8")}
out = {}
for name, (shape, axes) in MESHES.items():
    dist = Dist.from_mesh(make_mesh(shape, axes))
    for arch in ARCH_IDS:
        out[f"{name}/{arch}"] = specs(shd, dist, get_config(arch), opt[arch])
print(json.dumps(out))
"""

PORT = """
import json, torch
import torch.distributed as tdist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.distributed.context import Dist
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

def world(n):
    if tdist.is_initialized():
        tdist.destroy_process_group()
    tdist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

import functools
shd._shape_tree = functools.cache(shd._shape_tree)     # a function of the config
opt = {}
for arch in ARCH_IDS:
    meta = Model(get_config(arch), device="meta").init_params(0)
    opt[arch] = {sd: init_opt_state(meta, AdamWConfig(state_dtype=sd)) for sd in ("fp32", "int8")}
out = {}
for name, (shape, axes) in MESHES.items():
    world(int(torch.tensor(shape).prod()))
    dist = Dist.from_mesh(make_mesh(shape, axes, "cpu"))
    for arch in ARCH_IDS:
        out[f"{name}/{arch}"] = specs(shd, dist, get_config(arch), opt[arch])
meshes = {}
world(256)
m = make_production_mesh(device_type="cpu")
meshes["single"] = [list(m.shape), list(m.mesh_dim_names)]
try:
    make_production_mesh(multi_pod=True, device_type="cpu")
except ValueError as exc:
    meshes["refused"] = str(exc)
world(512)
m = make_production_mesh(multi_pod=True, device_type="cpu")
meshes["multi"] = [list(m.shape), list(m.mesh_dim_names)]
out["meshes"] = meshes
print(json.dumps(out))
"""


def _run(code: str, env: dict) -> dict:
    prelude = (f"MESHES = {MESHES!r}\nARCH_IDS = {ARCH_IDS!r}\nBATCHES = {BATCHES!r}\n"
               f"CACHES = {CACHES!r}\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **env}
    proc = subprocess.run([sys.executable, "-c", prelude + textwrap.dedent(FLAT + code)],
                          capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    return _run(REFERENCE, {"XLA_FLAGS": "--xla_force_host_platform_device_count=512",
                            "JAX_PLATFORMS": "cpu"})


@pytest.fixture(scope="module")
def port():
    return _run(PORT, {"OMP_NUM_THREADS": "1"})


def _ref_path(path: str, n_sub: dict) -> tuple[str, bool]:
    """A port path → (the reference's path, whether its spec carries the
    group dim first): "layers.i.…" → "stack.sub{i % n}.…" and likewise
    under "enc"."""
    parts = path.split(".")
    for j, part in enumerate(parts):
        if part == "layers":
            i = int(parts[j + 1])
            n = n_sub["enc" if j and parts[j - 1] == "enc" else "dec"]
            return ".".join(parts[:j] + ["stack", f"sub{i % n}"] + parts[j + 2:]), True
    return path, False


def _groups(arch: str) -> dict:
    cfg = get_config(arch)
    out = {"dec": len(layer_groups(cfg)[0])}
    if cfg.family == "encdec":
        out["enc"] = len(layer_groups(Model(cfg, device="meta")._enc_cfg())[0])
    return out


def _held(port_flat: dict, ref_flat: dict, n_sub: dict) -> None:
    mapped = {}
    for path, spec in port_flat.items():
        rpath, stacked = _ref_path(path, n_sub)
        want = ref_flat[rpath]
        if stacked and want is not None:
            assert want[0] is None, (rpath, want)
            want = want[1:]
        assert spec == want, (path, spec, rpath, want)
        mapped[rpath] = True
    assert set(mapped) == set(ref_flat), sorted(set(ref_flat) - set(mapped))[:5]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_match_reference(reference, port, mesh, arch):
    key = f"{mesh}/{arch}"
    ref, got = reference[key], port[key]
    n_sub = _groups(arch)
    for kind in ("plan_True", "plan_False", "opt_fp32", "opt_int8"):
        _held(got[kind], ref[kind], n_sub)
    assert got["notes_True"] == ref["notes_True"]
    assert got["notes_False"] == ref["notes_False"]
    assert got["inputs"] == ref["inputs"]
    assert got["enc_kv"] == ref["enc_kv"]
    assert got["batch"] == ref["batch"]
    for shape, cache in ref["cache"].items():
        for path, spec in cache.items():
            leaf = path.split(".")[-1]
            assert got["cache"][shape][leaf] == spec, (shape, path)
        assert set(got["cache"][shape]) == {p.split(".")[-1] for p in cache}


def test_production_mesh_shapes(port):
    meshes = port["meshes"]
    assert meshes["single"] == [[16, 16], ["data", "model"]]
    assert meshes["multi"] == [[2, 16, 16], ["pod", "data", "model"]]
    assert "needs 512 ranks" in meshes["refused"]


def _roundtrip(rank, world, arch):
    from repro_torch.distributed.context import Dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    torch.set_num_threads(1)
    dist = Dist.from_mesh(make_mesh((2, 2), ("data", "model"), "cpu"))
    cfg = get_config(arch).reduced()
    full = Model(cfg, device="cpu").init_params(3)
    opt = init_opt_state(full, AdamWConfig())
    gen = torch.Generator().manual_seed(7)
    for mo in tree_leaves(opt["m"]):
        if mo is not None:
            mo.normal_(generator=gen)
    plan = shd.param_plan(cfg, dist, training=True).params
    specs = {"params": plan, "opt": shd.opt_plan(plan, init_opt_state(
        Model(cfg, device="meta").init_params(0), AdamWConfig()), dist)}
    tree = {"params": full, "opt": opt}
    blocks = shd.shard_tree(tree, specs, dist)
    back = shd.gather_tree(blocks, specs, dist)
    pairs = list(zip(tree_leaves(back), tree_leaves(tree)))
    return (len(pairs) == len(tree_leaves(tree)) and all(
                (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b))
                for a, b in pairs),
            sum(t.numel() for t in tree_leaves(blocks) if t is not None),
            sum(t.numel() for t in tree_leaves(tree) if t is not None))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-3b-a800m"])
def test_shard_then_gather_is_the_identity(arch):
    out = launch_ranks(_roundtrip, 4, backend="gloo", device="cpu", args=(arch,),
                       timeout=120)
    assert all(same for same, _, _ in out)
    # every rank holds less than the whole: the blocks are blocks
    assert all(local < whole for _, local, whole in out)
