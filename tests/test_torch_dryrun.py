"""The port's dry-runs (``repro_torch.launch.dryrun`` / ``cache_dryrun``) and
roofline against the reference's.

For all 64 (cell, mesh) pairs — the 32 ``runnable_cells()`` on (16, 16)
and (2, 16, 16) — the per-rank bytes of the parameters, the optimizer
state, the cache and the inputs equal the reference's plan applied to the
same abstract shapes: one reference subprocess on 512 host devices
(``jax.eval_shape`` and ``NamedSharding.shard_shape``, nothing compiled),
one port subprocess on a "fake" process group (so this process's default
group stays uninitialized). Also: ``model_flops`` equals the reference's
``roofline.model_flops`` for every config; the cache dry-run's delta
flush moves the same bytes at 4,096 and 65,536 entries; ``op_cost``'s
layer-group extrapolation equals a whole-model count of reduced configs,
its bytes split by dtype add up, and an int8 search's bytes are int8;
the roofline arithmetic and ``report.markdown_table`` on a ``tmp_path``.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis import roofline as jroofline
from repro.configs import get_config as j_get_config
from repro_torch.analysis import op_cost, report, roofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, runnable_cells
from repro_torch.distributed.context import Dist
from repro_torch.launch import cache_dryrun

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (pytest-xdist runs
    a worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REFERENCE = """
import functools, json, math
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import SHAPES, get_config, runnable_cells
from repro.distributed.context import Dist
from repro.launch import sharding as shd
from repro.launch.dryrun import input_specs
from repro.launch.mesh import make_production_mesh
from repro.models.model import Model
from repro.models.transformer import init_cache, layer_groups
from repro.optim.adamw import AdamWConfig, init_opt_state

def rank_bytes(specs, tree, mesh):
    def one(spec, sds):
        if spec is None or sds is None:
            return 0
        return math.prod(NamedSharding(mesh, spec).shard_shape(sds.shape)) * sds.dtype.itemsize
    out = jax.tree.map(one, specs, tree, is_leaf=lambda x: isinstance(x, P) or x is None)
    return int(sum(jax.tree.leaves(out)))

shd._shape_tree = functools.cache(shd._shape_tree)     # a function of the config
pshapes = functools.cache(lambda arch: Model(get_config(arch)).param_shapes())
out = {}
for mesh_name, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    dist = Dist.from_mesh(mesh)
    for arch, shape in runnable_cells():
        cfg, spec = get_config(arch), SHAPES[shape]
        B, S = spec.global_batch, spec.seq_len
        plan = shd.param_plan(cfg, dist, training=spec.kind == "train").params
        r = {"params": rank_bytes(plan, pshapes(arch), mesh), "opt_state": 0, "cache": 0}
        ins = input_specs(cfg, shape)
        if spec.kind == "train":
            opt = jax.eval_shape(lambda p: init_opt_state(
                p, AdamWConfig(state_dtype=cfg.opt_state_dtype)), pshapes(arch))
            r["opt_state"] = rank_bytes(shd.opt_plan(plan, opt, dist), opt, mesh)
            in_specs = shd.input_specs_train(cfg, dist, B)
        else:
            cache = {"stack": jax.eval_shape(lambda: init_cache(cfg, B, S))}
            cspecs = {"stack": shd.cache_specs(cfg, dist, B, S)}
            if cfg.family == "encdec":
                _, G = layer_groups(cfg)
                kv = jax.ShapeDtypeStruct((G, B, cfg.enc_ctx, cfg.n_kv_heads, cfg.head_dim),
                                          jnp.bfloat16)
                cache["enc_kv"] = {"k": kv, "v": kv}
                cspecs["enc_kv"] = shd.enc_kv_spec(cfg, dist, B)
            r["cache"] = rank_bytes(cspecs, cache, mesh)
            b = shd.batch_spec(dist, B)
            in_specs = {k: P(b, *([None] * (len(v.shape) - 1))) for k, v in ins.items()}
        r["inputs"] = rank_bytes(in_specs, ins, mesh)
        out[f"{arch}/{shape}/{mesh_name}"] = r
print(json.dumps(out))
"""

PORT = """
import functools, json
from repro_torch.configs import runnable_cells
from repro_torch.launch import cache_dryrun, dryrun, sharding as shd
shd._shape_tree = functools.cache(shd._shape_tree)     # a function of the config
from repro_torch.configs import get_config
out = {}
for mesh_name, multi in (("single", False), ("multi", True)):
    dist = dryrun.production_dist(multi)
    for arch, shape in runnable_cells():
        out[f"{arch}/{shape}/{mesh_name}"] = dryrun.per_rank_bytes(get_config(arch), shape, dist)
out["delta"] = {n: cache_dryrun.build("delta", False, n, 128)["op_cost"]["bytes"]
                for n in (4096, 65536)}
out["flat"] = {n: cache_dryrun.build("flat", False, n, 128)["op_cost"]["bytes"]
               for n in (4096, 65536)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def both():
    """The reference's and the port's per-rank bytes, computed in two
    subprocesses at once."""
    procs = {}
    for name, code, env in (
            ("reference", REFERENCE, {"XLA_FLAGS": "--xla_force_host_platform_device_count=512",
                                      "JAX_PLATFORMS": "cpu"}),
            ("port", PORT, {"OMP_NUM_THREADS": "1"})):
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **env})
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        assert proc.returncode == 0, f"{name}: {stderr[-3000:]}"
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


CELLS = [f"{a}/{s}/{m}" for m in ("single", "multi") for a, s in runnable_cells()]


def test_sixty_four_cells():
    assert len(CELLS) == 64


@pytest.mark.parametrize("cell", CELLS)
def test_per_rank_bytes_equal_the_reference_plan(both, cell):
    got, want = both["port"][cell], both["reference"][cell]
    assert got == want
    assert got["params"] > 0 and got["inputs"] > 0
    kind = SHAPES[cell.split("/")[1]].kind
    assert (got["opt_state"] > 0) == (kind == "train")
    assert (got["cache"] > 0) == (kind != "train")


def test_cache_dryrun_delta_bytes_do_not_scale_with_entries(both):
    delta, flat = both["port"]["delta"], both["port"]["flat"]
    assert delta["4096"] == delta["65536"] > 0
    assert flat["65536"] > 10 * flat["4096"]     # a flat scan streams every row


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for kind, tokens in (("train", 256 * 4096), ("prefill", 32 * 32768), ("decode", 128)):
        assert roofline.model_flops(cfg, kind, tokens) == \
            jroofline.model_flops(jcfg, kind, tokens)


@pytest.mark.parametrize("arch,kind", [("llama3_2_3b", "train"), ("jamba_v0_1_52b", "train"),
                                       ("whisper_large_v3", "prefill"),
                                       ("granite_moe_3b_a800m", "decode")])
def test_layer_group_extrapolation_equals_a_whole_count(arch, kind):
    """The count at 1 and 2 layer groups, extrapolated, against the whole
    reduced model counted op by op (jamba: 1 period of 8; whisper: encoder
    and decoder stacks apart)."""
    cfg = get_config(arch).reduced(n_layers=4 if arch != "jamba_v0_1_52b" else 16)
    ext = op_cost.step_cost(cfg, kind, 4, 64, Dist.single())
    whole = op_cost.step_cost(cfg, kind, 4, 64, Dist.single(), whole=True)
    assert ext.flops == pytest.approx(whole.flops, rel=1e-9)
    assert ext.bytes == pytest.approx(whole.bytes, rel=1e-9)
    assert ext.kernel_flops.keys() == whole.kernel_flops.keys()
    assert ext.flops > 0 and ext.bytes > 0


def test_op_cost_counts_kernels_by_formula():
    """One reduced llama prefill: the flash kernel counted by chip_smoke's
    flash_work (causal pairs), the matmuls by FlopCounterMode."""
    cfg = get_config("llama3_2_3b").reduced(n_layers=1)
    t = op_cost.step_cost(cfg, "prefill", 2, 64, Dist.single(), whole=True)
    pairs = 64 * 65 // 2
    assert t.kernel_flops == {"flash_attention": 4.0 * 2 * cfg.n_heads * cfg.head_dim * pairs}
    assert t.flops > t.kernel_flops["flash_attention"]


@pytest.mark.parametrize("impl,dtype", [("flat", "int8"), ("beam", "float32"),
                                        ("delta", "int8")])
def test_bytes_by_dtype_partition_the_total(impl, dtype):
    t = cache_dryrun._run(impl, 4096, 8, 8, dtype)
    assert t.bytes > 0
    assert sum(t.bytes_by_dtype.values()) == pytest.approx(t.bytes)


def test_quantized_search_moves_mostly_int8_table_bytes():
    """The int8 flat search's table traffic lands in the int8 bucket, and
    its fp32 traffic shrinks against the fp32 search's (the byte split the
    reference's quant gate reads from hlo_cost)."""
    fp32 = cache_dryrun._run("flat", 4096, 8, 8, "float32").bytes_by_dtype
    int8 = cache_dryrun._run("flat", 4096, 8, 8, "int8").bytes_by_dtype
    assert fp32.get("int8", 0) < int8["int8"]
    assert int8["int8"] > 0.9 * sum(int8.values())
    assert int8["float32"] < 0.01 * fp32["float32"]


def _payload(arch, shape, mesh, flops, nbytes, coll, model_flops, n=256):
    return {"arch": arch, "shape": shape, "mesh": mesh, "n_devices": n,
            "model_flops": model_flops, "active_params": 1e9, "cache_bytes": 0.0,
            "op_cost": {"flops": flops, "bytes": nbytes, "collective_bytes": {"all-gather": coll},
                        "collective_counts": {"all-gather": 3},
                        "total_collective_bytes": coll}}


def test_roofline_arithmetic():
    p = _payload("a", "train_4k", "single", 989e12, 3.35e12, 0.9e12, 989e12 * 256 * 0.5)
    r = roofline.report_from_dryrun(p)
    assert (r.compute_s, r.memory_s, r.collective_s) == pytest.approx((1.0, 1.0, 2.0))
    assert r.bottleneck == "collective" and r.step_time_s == pytest.approx(2.0)
    assert r.useful_flops_fraction == pytest.approx(0.5)
    assert r.ideal_step_s == pytest.approx(0.5) and r.roofline_fraction == pytest.approx(0.25)
    d = roofline.report_from_dryrun(_payload("a", "decode_32k", "multi", 1.0, 3.35e12, 0.0,
                                             0.0, n=512))
    assert d.kind == "decode" and d.bottleneck == "memory"
    assert d.ideal_step_s == pytest.approx(1e9 * 2 / 512 / roofline.HBM_BW)


def test_report_renders_a_results_directory(tmp_path):
    (tmp_path / "a__train_4k__single.json").write_text(json.dumps(
        _payload("a", "train_4k", "single", 989e12, 1e12, 1e9, 1e17)))
    (tmp_path / "b__decode_32k__multi.json").write_text(json.dumps(
        _payload("b", "decode_32k", "multi", 1e9, 3.35e12, 1e6, 1e12, n=512)))
    table = report.markdown_table(str(tmp_path))
    rows = table.splitlines()
    assert rows[0].startswith("| arch | shape | mesh |")
    assert rows[2].startswith("| a | train_4k | single | 1.00s |") and "| compute |" in rows[2]
    assert rows[3].startswith("| b | decode_32k | multi |") and "| memory |" in rows[3]
    assert "SKIP(quadratic-attention)" in table
    s = report.summary(str(tmp_path))
    assert s["n_cells"] == 2 and s["worst_fraction"][0][0] == "b"
