"""The moe and hybrid families of repro_torch's model against the JAX
reference, on the CPU: the reduced granite-moe-3b-a800m and kimi-k2 (every
layer MoE) and jamba (Mamba and attention 7:1, MoE FFNs on odd layers).

The reference's random-init parameters are carried across
(``models.convert.params_from_reference``) and both models run the same
numpy-seeded tokens: a prefill of 16 tokens and 4 greedy decode steps. The
reference serves through its dense exact MoE path, the port through its
routed one (``models/moe.py``).

Tolerances are ``test_torch_models.py``'s, 2e-2 (fp32) and 0.15 (bf16),
set by the reference's bf16 attention probabilities. Greedy tokens must
be equal wherever the reference's top-2 margin exceeds twice the
tolerance.

Routing is a step function of the router's input: an expert choice near
a tie flips under any difference in rounding, and a flipped choice moves
that token's FFN output by O(1), past any tolerance. In fp32 the two
packages' router inputs differ by ~1e-3 at most (the reference's bf16
probabilities) and no choice flips on these seeds. In bf16 they differ
by an ulp or two of the hidden state (~0.03-0.05 at magnitude 4), and
that is enough to flip a near-tied choice: 5 of a jamba prefill's 32
tokens in one layer on another seed, after which its logits were 0.3
apart. So in bf16 every MoE layer of the port takes the reference's
expert ids from the same call (weighted by the port's own
probabilities), and what is held is (1) the logits within 0.15, (2) the
router inputs within 0.15, and (3) the port's own choices equal to the
reference's except where the reference's k-th and (k+1)-th router logits
lie within twice the two packages' router-logit difference: a flip that
the input difference explains, not a routing fault. ``route`` itself is
held to equal ids on equal inputs in ``test_torch_moe.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402

import repro_torch.models.moe as tmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs: its many tiny CPU
    ops under pytest-xdist (a worker per core) with torch's default pool
    in every worker oversubscribe the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["granite_moe_3b_a800m", "kimi_k2_1t_a32b", "jamba_v0_1_52b"]
TOL = {"float32": 2e-2, "bfloat16": 0.15}


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


class Routing:
    """Both packages' ``route`` wrapped: every call's router input and
    expert ids recorded, in call order (layer order, prefill then each
    decode step). With ``force`` the port's call i returns the
    reference's call-i ids, weighted by the port's own probabilities."""

    def __init__(self, monkeypatch, force: bool):
        self.ref, self.port, self.force = [], [], force
        jroute, troute = jmoe.route, tmoe.route

        def ref_route(x, w, cfg, n_pad):
            out = jroute(x, w, cfg, n_pad)
            jax.debug.callback(lambda xv, iv: self.ref.append(
                (np.asarray(xv, np.float32), np.asarray(iv))), x, out[0])
            return out

        def port_route(x, w, cfg):
            ids, weights, aux = troute(x, w, cfg)
            self.port.append((_f32(x), ids.numpy(), w.numpy()))
            if self.force:
                ids = torch.from_numpy(np.array(self.ref[len(self.port) - 1][1])).to(ids.dtype)
                probs = torch.softmax(x.float() @ w.float(), dim=-1)
                weights = probs.gather(1, ids.long())
                weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
            return ids, weights, aux

        monkeypatch.setattr(jmoe, "route", ref_route)
        monkeypatch.setattr(tmoe, "route", port_route)

    def check(self, tol: float) -> int:
        """(2) and (3) above over every call so far; returns the number of
        tokens whose own choice differs from the reference's."""
        assert len(self.ref) == len(self.port) > 0
        flips = 0
        for (xr, ir), (xp, ip, w) in zip(self.ref, self.port):
            assert np.abs(xp - xr).max() <= tol
            lr, lp = xr @ w, xp @ w
            k = ir.shape[1]
            kth = -np.sort(-lr, axis=1)
            margin = kth[:, k - 1] - kth[:, k]
            noise = np.abs(lp - lr).max(axis=1)
            for t in range(len(ir)):
                if set(ir[t]) != set(ip[t]):
                    flips += 1
                    assert margin[t] <= 2 * noise[t] + 1e-6, (t, margin[t], noise[t])
        return flips


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, rng, monkeypatch):
    cfg, jm, jp, tm, tp = _pair(arch, dtype)
    routing = Routing(monkeypatch, force=dtype == "bfloat16")
    tol, V = TOL[dtype], cfg.vocab_size
    B, S = 2, 16
    toks = rng.integers(1, V, (B, S)).astype(np.int32)
    jl, jc, jk = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, S + 8)
    tl, tc, tk = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, S + 8)
    assert bool((tl[:, V:] == -1e30).all())
    np.testing.assert_allclose(_f32(tl)[:, :V], _f32(jl)[:, :V], atol=tol, rtol=0)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    tok = np.asarray(jnp.argmax(jl[:, :V], -1)).astype(np.int32)
    for _ in range(4):
        jl, jc, jk = jm.decode_step(jp, jc, jnp.asarray(tok), jk)
        tl, tc, tk = tm.decode_step(tp, tc, torch.from_numpy(tok), tk)
        a, b = _f32(jl)[:, :V], _f32(tl)[:, :V]
        np.testing.assert_allclose(b, a, atol=tol, rtol=0)
        top2 = np.sort(a, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        assert np.array_equal(b.argmax(1)[clear], a.argmax(1)[clear])
        tok = a.argmax(1).astype(np.int32)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    n_moe = cfg.mlp_kinds().count("moe")
    assert len(routing.port) == 5 * n_moe
    flips = routing.check(tol)
    if dtype == "float32":
        assert flips == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, rng):
    """Incremental decode of token S-1 equals the full prefill of S tokens,
    in the port alone (fp32: no routing choice sits within its rounding
    of a tie)."""
    cfg = get_config(arch).reduced(dtype="float32")
    model = Model(cfg, device="cpu")
    params = model.init_params(1)
    B, S = 2, 24
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32))
    lf, cf, _ = model.prefill(params, {"tokens": toks}, S + 4)
    _, cache, kvl = model.prefill(params, {"tokens": toks[:, :S - 1]}, S + 4)
    ld, cache, kv2 = model.decode_step(params, cache, toks[:, S - 1], kvl)
    V = cfg.vocab_size
    np.testing.assert_allclose(_f32(ld)[:, :V], _f32(lf)[:, :V], atol=1e-4, rtol=0)
    for name in cf:
        np.testing.assert_allclose(_f32(cache[name]), _f32(cf[name]), atol=1e-4, rtol=0)
    assert kv2.tolist() == [S, S]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_follow_the_reference(arch):
    """The seeded init draws the reference's shapes and dtypes, the MoE
    leaves included, one dict per layer in the reference's layer order."""
    cfg = get_config(arch).reduced()
    jp = JModel(jget_config(arch).reduced()).param_shapes()
    tp = Model(cfg, device="cpu").init_params(0)
    n_sub = len(jp["stack"])
    assert len(tp["layers"]) == cfg.n_layers
    for i, layer in enumerate(tp["layers"]):
        ref = jp["stack"][f"sub{i % n_sub}"]
        assert set(layer) == set(ref)
        for part in ("mix", "mlp"):
            for name, leaf in ref.get(part, {}).items():
                got = layer[part][name]
                assert tuple(got.shape) == leaf.shape[1:], (i, part, name)
                assert str(got.dtype).split(".")[1] == str(leaf.dtype), (i, part, name)
    moe_layers = [lay for lay in tp["layers"] if "router" in lay.get("mlp", {})]
    assert len(moe_layers) == cfg.mlp_kinds().count("moe") > 0
    w = moe_layers[0]["mlp"]["w_gate"].float()
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
