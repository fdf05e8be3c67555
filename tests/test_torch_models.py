"""repro_torch's model (dense family) against the JAX reference, on the CPU.
The ssm family (falcon-mamba) is held by ``test_torch_mamba.py``.

Configs are field-equal copies. For the reduced dense models the
reference's random-init parameters are carried across
(``models.convert.params_from_reference``) and both models run the same
numpy-seeded tokens.

Tolerance, and why: the reference's ``attend_prefill`` rounds the softmax
probabilities to bf16 before P·V; the TPU kernel and the port keep them in
fp32. That alone moves the prefill's layer outputs (the cache of every
layer after the first, the logits) by up to ~8e-3 in an fp32 model and
~5e-2 in a bf16 one, of logits of magnitude ~4 (measured on these seeds);
the tests allow 2e-2 and 0.15. Decode attention has no such rounding in
either package: from the SAME cache, decode logits agree within 1e-4
(fp32). Greedy tokens must be equal wherever the reference's top-2 margin
exceeds twice the tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_reference, to_tensor  # noqa: E402
from repro_torch.models.model import padded_vocab  # noqa: E402

DENSE = ["llama3_2_3b", "granite_8b"]
TOL = {"float32": 2e-2, "bfloat16": 0.15}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_field_equal(arch):
    ref = dataclasses.asdict(jget_config(arch))
    port = dataclasses.asdict(get_config(arch))
    assert port == ref
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jget_config(arch).reduced())


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if jget_config(a).family not in ("dense", "ssm")])
def test_unported_families_raise(arch):
    """MoE, hybrid, encoder-decoder and VLM models raise and name what is
    missing; they are later slices (the ssm family is held by
    ``test_torch_mamba.py``)."""
    with pytest.raises(NotImplementedError):
        Model(get_config(arch).reduced(), device="cpu")


def _pair(arch, dtype, seed=0):
    jcfg = jget_config(arch).reduced(dtype=dtype)
    cfg = get_config(arch).reduced(dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.key(seed))
    tm = Model(cfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jm, jp, tm, tp


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch, dtype, rng):
    cfg, jm, jp, tm, tp = _pair(arch, dtype)
    tol, V = TOL[dtype], cfg.vocab_size
    B, S = 2, 16
    toks = rng.integers(1, V, (B, S)).astype(np.int32)
    jl, jc, jk = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, S + 8)
    tl, tc, tk = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, S + 8)
    assert tl.shape == (B, padded_vocab(V)) and tl.dtype == torch.float32
    assert bool((tl[:, V:] == -1e30).all())
    np.testing.assert_allclose(_f32(tl)[:, :V], _f32(jl)[:, :V], atol=tol, rtol=0)
    # the KV cache after prefill: the reference's group-stacked (G, B, S,
    # Hkv, dh) and the port's (L, B, S, Hkv, dh) hold the same layout
    for name in ("k", "v"):
        ref_c = _f32(jc["stack"]["sub0"][name])
        np.testing.assert_allclose(_f32(tc[name]), ref_c, atol=tol, rtol=0)
        np.testing.assert_allclose(_f32(tc[name][0]), ref_c[0], atol=1e-5 if
                                   dtype == "float32" else 2e-2, rtol=0)  # layer 0: no attention yet
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    # 8 greedy decode steps, both fed the reference's tokens
    tok = np.asarray(jnp.argmax(jl[:, :V], -1)).astype(np.int32)
    for _ in range(8):
        jl, jc, jk = jm.decode_step(jp, jc, jnp.asarray(tok), jk)
        tl, tc, tk = tm.decode_step(tp, tc, torch.from_numpy(tok), tk)
        a, b = _f32(jl)[:, :V], _f32(tl)[:, :V]
        np.testing.assert_allclose(b, a, atol=tol, rtol=0)
        top2 = np.sort(a, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        assert np.array_equal(b.argmax(1)[clear], a.argmax(1)[clear])
        tok = a.argmax(1).astype(np.int32)
    assert np.array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("arch", DENSE)
def test_decode_from_the_same_cache_matches_reference(arch, rng):
    """Decode attention has no probability rounding in either package:
    from the reference's own cache, one decode step agrees within 1e-4."""
    cfg, jm, jp, tm, tp = _pair(arch, "float32")
    V = cfg.vocab_size
    toks = rng.integers(1, V, (2, 12)).astype(np.int32)
    _, jc, jk = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 20)
    cache = {n: to_tensor(jc["stack"]["sub0"][n], "cpu").clone() for n in ("k", "v")}
    nxt = rng.integers(1, V, 2).astype(np.int32)
    jl, jc2, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), jk)
    tl, cache, _ = tm.decode_step(tp, cache, torch.from_numpy(nxt),
                                  torch.from_numpy(np.array(jk)))
    np.testing.assert_allclose(_f32(tl)[:, :V], _f32(jl)[:, :V], atol=1e-4, rtol=0)
    np.testing.assert_allclose(_f32(cache["k"]), _f32(jc2["stack"]["sub0"]["k"]),
                               atol=1e-5, rtol=0)


def test_softcap_model_prefill_matches_reference_and_windowed_decode_raises(rng):
    """gemma2 (attention and final logit softcaps, embedding scale, local
    window layers of 64 in the reduced config): prefill of 60 tokens and
    12 greedy decode steps match the reference, and the local layers'
    window bites from the fifth step on (kv_len 65). A port model without
    the window departs from the reference once it bites, so the mask is
    what keeps them together."""
    cfg, jm, jp, tm, tp = _pair("gemma2_2b", "float32")
    assert cfg.sliding_window == 64 and cfg.local_global_alternating
    tol, V, S, steps = TOL["float32"], cfg.vocab_size, 60, 12
    nowin = Model(dataclasses.replace(cfg, sliding_window=None), device="cpu")
    toks = rng.integers(1, V, (2, S)).astype(np.int32)
    jl, jc, jk = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, S + steps)
    tl, tc, tk = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, S + steps)
    _, nc, nk = nowin.prefill(tp, {"tokens": torch.from_numpy(toks)}, S + steps)
    np.testing.assert_allclose(_f32(tl)[:, :V], _f32(jl)[:, :V], atol=tol, rtol=0)
    tok = np.asarray(jnp.argmax(jl[:, :V], -1)).astype(np.int32)
    apart = []
    for step in range(steps):
        jl, jc, jk = jm.decode_step(jp, jc, jnp.asarray(tok), jk)
        tl, tc, tk = tm.decode_step(tp, tc, torch.from_numpy(tok), tk)
        nl, nc, nk = nowin.decode_step(tp, nc, torch.from_numpy(tok), nk)
        a, b = _f32(jl)[:, :V], _f32(tl)[:, :V]
        np.testing.assert_allclose(b, a, atol=tol, rtol=0)
        top2 = np.sort(a, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        assert np.array_equal(b.argmax(1)[clear], a.argmax(1)[clear])
        apart.append(float(np.abs(_f32(nl)[:, :V] - a).max()))
        tok = a.argmax(1).astype(np.int32)
    assert int(tk[0]) == S + steps > cfg.sliding_window
    assert max(apart[:4]) <= tol < min(apart[4:])


def test_windowed_decode_from_the_same_cache_matches_reference(rng):
    """gemma2 from the reference's own cache after a 70-token prefill
    (past the window of 64): one windowed decode step agrees within 1e-4,
    as the unwindowed decode does."""
    cfg, jm, jp, tm, tp = _pair("gemma2_2b", "float32")
    V = cfg.vocab_size
    toks = rng.integers(1, V, (2, 70)).astype(np.int32)
    _, jc, jk = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 72)
    cache = {n: torch.stack([to_tensor(jc["stack"][f"sub{i}"][n][g], "cpu")
                             for g in range(cfg.n_layers // 2) for i in range(2)])
             for n in ("k", "v")}
    nxt = rng.integers(1, V, 2).astype(np.int32)
    jl, _, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), jk)
    tl, _, _ = tm.decode_step(tp, cache, torch.from_numpy(nxt),
                              torch.from_numpy(np.array(jk)))
    np.testing.assert_allclose(_f32(tl)[:, :V], _f32(jl)[:, :V], atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill(arch, rng):
    """Incremental decode of token S-1 == full prefill of S tokens (the
    reference's test_models scenario), in the port alone."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(1)
    B, S = 2, 24
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32))
    lf, _, _ = model.prefill(params, {"tokens": toks}, S + 4)
    lp, cache, kvl = model.prefill(params, {"tokens": toks[:, :S - 1]}, S + 4)
    ld, _, kv2 = model.decode_step(params, cache, toks[:, S - 1], kvl)
    V = cfg.vocab_size
    np.testing.assert_allclose(_f32(lf)[:, :V], _f32(ld)[:, :V], atol=5e-2)  # bf16 path
    assert kv2.tolist() == [S, S]


def test_init_params_shapes_follow_the_reference():
    """The seeded init draws the reference's shapes, dtypes and scales."""
    cfg = get_config("llama3_2_3b").reduced()
    jp = JModel(jget_config("llama3_2_3b").reduced()).param_shapes()
    tp = Model(cfg, device="cpu").init_params(0)
    assert tuple(tp["embed"].shape) == jp["embed"].shape
    assert tp["embed"].dtype == torch.bfloat16
    assert len(tp["layers"]) == cfg.n_layers
    for name, leaf in jp["stack"]["sub0"]["mix"].items():
        assert tuple(tp["layers"][0]["mix"][name].shape) == leaf.shape[1:]
    for name, leaf in jp["stack"]["sub0"]["mlp"].items():
        assert tuple(tp["layers"][0]["mlp"][name].shape) == leaf.shape[1:]
    std = float(tp["layers"][0]["mix"]["wq"].float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
