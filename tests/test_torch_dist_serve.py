"""Sharded serving against the reference's meshed run, on gloo CPU ranks.

The reference serves once, in a subprocess on 8 host devices
(``--xla_force_host_platform_device_count``): ``jax.jit`` of its
``Model(cfg, dist).prefill`` and ``decode_step`` on parameters placed by
``param_plan(training=False)``, a prefill of 12 tokens and 4 greedy
decode steps, fp32 (attention with fp32 probabilities, as the port's
plain version computes it: ``tests/_exact_attention.py``). The port runs
the same steps on 4 gloo CPU ranks (``launch_ranks``), the reference's
parameters carried by ``params_from_reference`` and ``shard_tree`` in the
serving plan, each rank given its rows of the inputs (``Model.rows``)
and, teacher-forced, the reference's greedy tokens. Cases, on (data 2,
model 2) unless named:

* reduced llama3.2-3b, granite-moe-3b-a800m and falcon-mamba-7b (2
  layers) at B 8 (batch over ``data``, KV heads over ``model``, the Mamba
  state's channels over ``model``) and B 3 (every rank all rows, the KV
  sequence over (data, model));
* llama at B 1; llama at B 8 on (data 1, model 4), whose 2 KV heads put
  the sequence over ``model``; gemma2 at B 3 with a window of 8 over a
  24-row cache of 6-row shards, so the window crosses the shards; llama
  at B 3 with ``prefill_chunk`` 4 (each chunk gathers the rows it reads);

each held to: every step's gathered logits within 1e-4 of the
reference's; the gathered cache (``gather_tree`` with the cache's specs)
within 1e-4 of the reference's, per layer; granite's dispatch (EP or
dense) per layer and per call the one the reference's ``moe_apply``
took (at B 3 the 36-token prefill takes EP on its block of the
replicated rows, the 3-token decode the dense path). The families with
an encoder, a patch prefix or a hybrid stack are in
``test_torch_dist_serve_families.py``.

Beside them, on the same ranks: the Mamba block's tensor parallelism on
2 model ranks against one process (and the rank's own ``w_in`` block
taken as its x and z, which is wrong, outside the tolerance); the
meshed engine (rank 0's cache, the other ranks following) with reduced
llama and granite in fp32 (granite at capacity 8.0, where EP drops
nothing), whose counters and tokens equal the one-process engine's and
are the same on every rank. On one process:
``decode_attention_plain`` with ``first_row`` and ``return_lse``, any cut
of the rows into blocks merged by ``merge_partials``, equal to one call
over every row (empty blocks and windows included), and its split-KV
algorithm equal to it.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _dist_serve import S, case_ids, check_case, run_reference, serve_case

from repro_torch.launch.mesh import launch_ranks

# (reference config name, B, mesh (data, model), config overrides)
CASES = [("llama3_2_3b", 8, (2, 2), {}), ("llama3_2_3b", 3, (2, 2), {}),
         ("granite_moe_3b_a800m", 8, (2, 2), {}), ("granite_moe_3b_a800m", 3, (2, 2), {}),
         ("falcon_mamba_7b", 8, (2, 2), {}), ("falcon_mamba_7b", 3, (2, 2), {}),
         ("llama3_2_3b", 1, (2, 2), {}), ("llama3_2_3b", 8, (1, 4), {}),
         ("gemma2_2b", 3, (2, 2), {"sliding_window": 8}),
         ("llama3_2_3b", 3, (2, 2), {"prefill_chunk": 4})]
ENGINE_ARCHS = ["llama3.2-3b", "granite-moe-3b-a800m"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (pytest-xdist runs
    a worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mamba_tp(dist) -> dict:
    """A reduced falcon-mamba block (fp32 weights from a seed) on this
    rank's channels, prefill then a decode step carrying the state;
    returns the outputs, the gathered state, and the output with the
    rank's own w_in block taken as its x and z (the wrong map)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.sharding import param_plan, shard_tree
    from repro_torch.models import mamba
    from repro_torch.models.model import Model
    cfg = get_config("falcon_mamba_7b").reduced(dtype="float32", n_layers=1)
    full = Model(cfg, device="cpu").init_params(3)["layers"][0]["mix"]
    spec = param_plan(cfg, dist, training=False).params["layers"][0]["mix"]
    p = shard_tree(full, spec, dist)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 7, cfg.d_model))
                         .astype(np.float32))
    n = cfg.ssm_d_inner // dist.n_model
    state = {"h": torch.zeros(2, n, cfg.ssm_d_state),
             "conv": torch.zeros(2, cfg.ssm_d_conv - 1, n)}
    with torch.no_grad():
        y0, _ = mamba.mamba_block(x[:, :6], p, cfg, out_state=state, dist=dist, pspec=spec)
        y1, _ = mamba.mamba_block(x[:, 6:], p, cfg, state=state, out_state=state,
                                  dist=dist, pspec=spec)
        # the wrong map: this rank's w_in block split in halves as x and z
        local, axis = mamba._channel_weights(p, spec, dist, cfg)
        xs, z = (x[:, :6] @ p["w_in"]).chunk(2, dim=-1)
        yw, _, _ = mamba.mamba_mix(xs, local, cfg, dist=dist, axis=axis)
        yw = coll.reduce_from((yw * torch.nn.functional.silu(z)) @ local["w_out"], dist, axis)
    M = dist.model_axis
    return {"y": torch.cat([y0, y1], 1).numpy(), "wrong": yw.numpy(),
            "h": coll.gather_value(state["h"], 1, dist, M).numpy(),
            "conv": coll.gather_value(state["conv"], 2, dist, M).numpy()}


def engine_cfg(arch: str):
    """The engine's model: reduced, fp32; granite at capacity 8.0, where
    EP drops nothing (one process has no capacity)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced(dtype="float32")
    return dataclasses.replace(cfg, capacity_factor=8.0) if cfg.n_experts else cfg


def _engine(dist, arch) -> dict:
    from repro_torch.launch.serve import run_serving
    out = run_serving(engine_cfg(arch), n_requests=48, device="cpu", dist=dist,
                      log=lambda *_: None)
    return {k: out[k] for k in ("served", "hit_rate", "model_tokens", "generated") if k in out}


def _rank(rank, world, cases, refs):
    from repro_torch.distributed.context import Dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dists = {}
    out = {"cases": []}
    for (name, B, shape, over), ref in zip(cases, refs):
        if shape not in dists:
            dists[shape] = Dist.from_mesh(make_mesh(shape, ("data", "model"), "cpu"))
        res = serve_case(dists[shape], name, B, over, ref)
        out["cases"].append(res if rank == 0 else {"logits": res["logits"]})
    dist = dists[(2, 2)]
    out["mamba"] = _mamba_tp(dist)
    out["engine"] = {arch: _engine(dist, arch) for arch in ENGINE_ARCHS}
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, tmp_path_factory.mktemp("reference") / "out.pkl")


@pytest.fixture(scope="module")
def ranks(reference):
    return launch_ranks(_rank, 4, backend="gloo", device="cpu", timeout=300,
                        args=(CASES, reference))


@pytest.mark.parametrize("i", range(len(CASES)), ids=case_ids(CASES))
def test_meshed_serving_matches_reference(reference, ranks, i):
    name, B, shape, over = CASES[i]
    check_case(reference[i], ranks, i, name, over)
    if name.startswith("granite"):
        # the reference's rule on the global tokens: EP where they split
        # over the token shards (token-parallel here: data · model)
        want = {"prefill": "ep" if B * S % 4 == 0 else "dense",
                "decode": "ep" if B % 4 == 0 else "dense"}
        assert reference[i]["dispatch"] == {k: [v] for k, v in want.items()}


def test_mamba_tensor_parallel_block(ranks):
    """The Mamba block on 2 model ranks (each its 128 of 256 channels)
    equals one process, output and carried state; the rank's own w_in
    block as its x and z does not."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba
    from repro_torch.models.model import Model
    cfg = get_config("falcon_mamba_7b").reduced(dtype="float32", n_layers=1)
    p = Model(cfg, device="cpu").init_params(3)["layers"][0]["mix"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 7, cfg.d_model))
                         .astype(np.float32))
    with torch.no_grad():
        y0, st = mamba.mamba_block(x[:, :6], p, cfg)
        y1, st = mamba.mamba_block(x[:, 6:], p, cfg, state=st)
    want = torch.cat([y0, y1], 1).numpy()
    for r in ranks:
        got = r["mamba"]
        assert float(np.abs(got["y"] - want).max()) <= 1e-5
        assert float(np.abs(got["h"] - st["h"].numpy()).max()) <= 1e-5
        assert float(np.abs(got["conv"] - st["conv"].numpy()).max()) <= 1e-5
        assert float(np.abs(got["wrong"] - y0.numpy()).max()) > 1e-2


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_meshed_engine_matches_one_process(ranks, arch):
    """Rank 0's cache in front of the meshed model: its counters equal the
    one-process engine's on the same 48 requests, and every rank generated
    the one-process engine's tokens for every miss batch."""
    from repro_torch.launch.serve import run_serving
    one = run_serving(engine_cfg(arch), n_requests=48, device="cpu", log=lambda *_: None)
    lead = ranks[0]["engine"][arch]
    assert (lead["served"], lead["hit_rate"], lead["model_tokens"]) == \
        (one["served"], one["hit_rate"], one["model_tokens"])
    assert len(one["generated"]) > 1
    for r in ranks:
        got = r["engine"][arch]["generated"]
        assert len(got) == len(one["generated"])
        assert all(np.array_equal(a, b) for a, b in zip(got, one["generated"]))


# --------------------------------------------- merging sequence shards (plain)
@pytest.mark.parametrize("cuts", [(0, 40), (0, 10, 20, 30, 40), (0, 5, 13, 40),
                                  (0, 1, 39, 40), (0, 25, 35, 40)])
@pytest.mark.parametrize("window", [None, 1, 9, 30])
def test_decode_lse_blocks_merge_to_one_call(cuts, window):
    """``decode_attention_plain`` on each block of rows [lo, hi) of the
    cache (``first_row`` lo, ``return_lse``), merged by ``merge_partials``,
    equals one call over every row, with and without a window, blocks
    that see no rows of a sequence (past its kv_len, or before its window)
    and a sequence with no rows (kv_len 0, which is 0) included;
    the split-KV algorithm gives the same (out, lse) on every block."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.models.attention import merge_partials
    rng = np.random.default_rng(len(cuts) + (window or 0))
    B, Hq, Hkv, Sk, dh = 4, 4, 2, 40, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Hq, dh), (B, Hkv, Sk, dh), (B, Hkv, Sk, dh)))
    lens = torch.tensor([0, 1, 17, 40], dtype=torch.int32)
    want, want_lse = tda.decode_attention_plain(q, k, v, kv_len=lens, window=window,
                                                return_lse=True)
    outs, lses = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        first = torch.full((B,), lo, dtype=torch.int32)
        o, lse = tda.decode_attention_plain(q, k[:, :, lo:hi], v[:, :, lo:hi], kv_len=lens,
                                            window=window, first_row=first, return_lse=True)
        so, slse = tda.decode_attention_split_plain(q, k[:, :, lo:hi], v[:, :, lo:hi], lens,
                                                    7, window=window, first_row=first,
                                                    return_lse=True)
        assert float((o - so).abs().max()) <= 1e-6
        assert torch.equal(torch.isinf(lse), torch.isinf(slse))
        live = torch.isfinite(lse)
        assert float(torch.where(live, lse - slse, 0.0).abs().max()) <= 1e-5
        outs.append(o)
        lses.append(lse)
    got = merge_partials(torch.stack(outs), torch.stack(lses))
    assert float((got - want).abs().max()) <= 1e-6
    assert bool((got[0] == 0).all()) and bool(torch.isinf(want_lse[0]).all())
    live = torch.isfinite(want_lse)
    assert float((torch.logsumexp(torch.stack(lses), 0) - want_lse)[live].abs().max()) <= 1e-5
