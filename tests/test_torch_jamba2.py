"""AI21-Jamba2-Mini (the benchmark's ``ai21-jamba2-mini``) on the CPU,
against the benchmark's plain reference (``portbench/reference/jamba.py``,
fp32, which imports nothing of the port), at the configuration file's
quick size (one 8-layer period, d 64, 4 experts top 2) on seeded random
weights.

The model is the port's jamba (hybrid family) with the three features of
the published model the JAX reference lacks (``models/variants.py``):
the Mamba mixer's Δ / B / C norms, routing weights that are not
renormalised, and attention without RoPE. Held here:

* fp32: prefill and 4 teacher-forced decode steps within 1e-4 of the
  reference's logits (the two compute the same function; the gap is fp32
  summation order, ~2e-6), and switching any one feature back moves the
  logits by more than 1e-2;
* bf16, ``test_torch_moe_models.py``'s rule: with the reference's
  expert choices forced on the port, the serving engine's tokens lie
  within 2 × 0.5 of the reference's best logit (so equal its first
  choice wherever its top-2 margin exceeds that), the logits within 0.5
  (``BF16_TOL``: bf16 against fp32,
  where that file compares bf16 with bf16), and every own choice of the
  port that differs is a near tie; unforced, the served tokens' mean gap
  below the reference's best logit (the benchmark's ``logit_gap_mean``)
  is within the cell's quick limit;
* the routing without renormalisation against numpy, and the expert
  counter against the distinct ids of the same rows;
* the other models' paths unchanged bit for bit: no variant, no norm
  weights, renormalised routing, and a counter that changes no result.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402
from portbench.reference import jamba as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cache import SemanticCache  # noqa: E402
from repro_torch.core.clock import SimClock  # noqa: E402
from repro_torch.core.policy import PolicyEngine, paper_policies  # noqa: E402
from repro_torch.kernels import moe_fused as mf  # noqa: E402
from repro_torch.models import mamba as mam  # noqa: E402
from repro_torch.models import moe, variants  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

CFG = spec.quick(spec.config("ai21-jamba2-mini"))
FP32_TOL = 1e-4
FEATURE_MOVES = 1e-2
# bf16 against the fp32 reference, with the reference's expert choices
# forced: every activation rounded to 8 bits of mantissa through 8
# layers (the scan's inputs, each residual add) puts the logits (|max| ~4)
# 0.15-0.40 from the fp32 ones at the widest position and ~0.03 on
# average (9 seeds); the port's fp32 model is within 6e-6.
BF16_TOL = 0.5
QUICK_LIMIT = json.loads((ROOT / "portbench" / "limits" /
                          "ai21-jamba2-mini.tail_cold.json").read_text())["quick"]["logit_gap_mean"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(t):
    if isinstance(t, dict):
        return {k: _f32(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_f32(v) for v in t]
    return t.float()


def _port_cfg(**kw) -> ArchConfig:
    return ArchConfig(**{**CFG["port"], **kw})


def _tokens(seed: int, b: int, s: int) -> torch.Tensor:
    return torch.randint(2, CFG["vocab_size"], (b, s), generator=torch.Generator().manual_seed(seed))


def _prefill_and_decode(model, params, toks, P: int) -> torch.Tensor:
    """Logits (b, S - P + 1, V) of positions P - 1 .. S - 1: a prefill of
    the first P tokens, then a decode step on each further one."""
    V = CFG["vocab_size"]
    logits, cache, kv_len = model.prefill(params, {"tokens": toks[:, :P]}, toks.shape[1])
    out = [logits[:, :V]]
    for j in range(P, toks.shape[1]):
        logits, cache, kv_len = model.decode_step(params, cache, toks[:, j].int(), kv_len)
        out.append(logits[:, :V])
    return torch.stack(out, 1)


def _fp32_gap(model, params, ref_params=None) -> float:
    toks = _tokens(0, 2, 16)
    got = _prefill_and_decode(model, params, toks, 12)
    want = ref.logits(ref_params or params, CFG, toks, 11)
    return float((got - want).abs().max())


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_every_variant_names_a_config_of_the_port(name):
    """A variant's key is the name of a config ``get_config`` resolves,
    whose ``.reduced()`` keeps the variant."""
    cfg = get_config(name)
    assert cfg.name == name
    assert variants.variant_of(cfg) is variants.VARIANTS[name]
    assert variants.variant_of(cfg.reduced()) is variants.VARIANTS[name]


def test_benchmark_runs_the_port_config_cut_in_depth():
    """The benchmark's port dict is the port's config at 16 layers (two
    whole periods), field for field but the provenance tag."""
    import dataclasses
    full = get_config("ai21-jamba2-mini")
    run = dataclasses.replace(ArchConfig(**spec.config("ai21-jamba2-mini")["port"]),
                              source=full.source)
    assert run == dataclasses.replace(full, n_layers=16)
    assert full.n_layers == 2 * run.n_layers and run.n_layers % run.hybrid_period == 0


def test_fp32_prefill_and_decode_match_the_reference():
    params = _f32(ref.make_weights(CFG, 3, "cpu"))
    model = Model(_port_cfg(dtype="float32"), device="cpu")
    assert _fp32_gap(model, params) < FP32_TOL


@pytest.mark.parametrize("feature", ["norms", "renorm", "rope"])
def test_each_feature_switched_back_fails(feature, monkeypatch):
    """Any one feature back to the port's behaviour without it moves the
    logits past the comparison's tolerance, and by far more than it."""
    params = _f32(ref.make_weights(CFG, 3, "cpu"))
    cfg = _port_cfg(dtype="float32")
    served = params
    if feature == "norms":
        served = {**params, "layers": [{**sp, "mix": {k: v for k, v in sp["mix"].items()
                                                      if k not in mam.INNER_NORMS}}
                                       for sp in params["layers"]]}
    elif feature == "renorm":
        monkeypatch.setattr(variants, "VARIANTS",
                            {CFG["port"]["name"]: variants.Variant(ssm_inner_norms=True)})
    else:
        cfg = _port_cfg(dtype="float32", rope_theta=10000.0)
    assert _fp32_gap(Model(cfg, device="cpu"), served, params) > FEATURE_MOVES


def test_init_params_make_the_inner_norms():
    """The port's own initialiser gives this model the norm weights (unit
    weights, fp32), and its logits are the reference's on them."""
    cfg = _port_cfg(dtype="float32")
    model = Model(cfg, device="cpu")
    params = model.init_params(5)
    mixers = [sp["mix"] for sp, kind in zip(params["layers"], cfg.layer_kinds())
              if kind == "mamba"]
    assert len(mixers) == 7
    for mix in mixers:
        assert [mix[k].shape[0] for k in mam.INNER_NORMS] == [4, 16, 16]
        assert all(mix[k].dtype == torch.float32 and not mix[k].any() for k in mam.INNER_NORMS)
    assert _fp32_gap(model, params) < FP32_TOL


def _reference_routing(params, toks) -> list:
    """Each MoE layer's router logits (b, S, E) and expert ids (b, S, k) in
    the reference's forward over ``toks``, as its ``_moe`` computes them."""
    out, moe_fn = [], ref._moe

    def spy(h, p, m, fp8):
        logits = h @ p["router"].float()
        order = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True).indices
        out.append((logits, order[..., :m["k"]]))
        return moe_fn(h, p, m, fp8)

    ref._moe = spy
    try:
        ref.logits(params, CFG, toks, toks.shape[1] - 1)
    finally:
        ref._moe = moe_fn
    return out


class ForcedRouting:
    """The port's MoE layers take the reference's expert ids (weighted by
    the port's own probabilities, not renormalised), call by call: the
    prefill's layers over positions 0..P-1, then each decode step's over
    its one position. Records, per call, the port's router logits and the
    reference's at the same positions."""

    def __init__(self, routing: list, P: int):
        self.routing, self.P, self.calls = routing, P, []

    def _at(self, t: torch.Tensor, step: int) -> torch.Tensor:
        t = t[:, :self.P] if step == 0 else t[:, self.P + step - 1]
        return t.reshape(-1, t.shape[-1])

    def __enter__(self):
        self._route = moe.route

        def route(x, router_w, cfg):
            n = len(self.routing)
            ref_logits, ref_ids = self.routing[len(self.calls) % n]
            step = len(self.calls) // n
            forced = self._at(ref_ids, step)
            logits = x.float() @ router_w.float()
            self.calls.append((logits, self._at(ref_logits, step), forced))
            return forced.int(), torch.softmax(logits, -1).gather(1, forced), None

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def test_engine_tokens_bf16_against_the_reference():
    """bf16, ``test_torch_moe_models.py``'s rule: the port's MoE layers
    take the reference's expert choices (a choice near a tie flips under
    any rounding and moves its token's FFN output by O(1)); then the
    serving engine's tokens lie within twice the bf16 tolerance of the
    reference's best logit (so equal its first choice wherever its top-2
    margin exceeds that), the model's teacher-forced logits lie within
    the tolerance of the reference's, and
    each of the port's own choices equals the reference's except where its
    k-th and (k+1)-th router logits lie within twice the widest
    router-logit difference between the two (a flip the bf16 input
    explains). Unforced, the served tokens' mean gap (the benchmark's
    ``logit_gap_mean``) is within the cell's quick limit."""
    P, NEW, B, k = 12, 6, 8, CFG["num_experts_per_tok"]
    params = ref.make_weights(CFG, 7, "cpu")
    model = Model(_port_cfg(), device="cpu")
    prompts = _tokens(1, B, P)

    def serve():
        cache = SemanticCache(PolicyEngine(paper_policies()), capacity=64, clock=SimClock(),
                              index_kind="flat", device="cpu")
        eng = ServingEngine(model, params, cache, max_batch=B, prompt_len=P,
                            max_new_tokens=NEW)
        for i in range(B):
            eng.submit(f"request {i}", "code_generation", prompts[i].numpy())
        out = sorted(eng.drain(), key=lambda r: r.req_id)
        return torch.from_numpy(np.stack([r.tokens for r in out])).long()

    def reference(served):
        toks = torch.cat([prompts, served[:, :-1]], 1)
        return toks, ref.logits(params, CFG, toks, P - 1)

    free = serve()
    toks, want = reference(free)
    gap = want.max(-1).values - want.gather(-1, free[..., None])[..., 0]
    assert float(gap.mean()) <= QUICK_LIMIT

    # the reference's choices depend on the served tokens, which depend on
    # the choices: serve until the tokens are those the choices came from
    served = free
    for _ in range(4):
        with ForcedRouting(_reference_routing(params, toks), P):
            again = serve()
        if torch.equal(again, served):
            break
        served = again
        toks, want = reference(served)
    assert torch.equal(again, served)
    with ForcedRouting(_reference_routing(params, toks), P) as forced:
        got = _prefill_and_decode(model, params, toks, P)
    assert float((got.float() - want).abs().max()) < BF16_TOL
    # the served token is the port's argmax: within 2 x the logits'
    # tolerance of the reference's best, so equal to it wherever the
    # reference's top-2 margin exceeds that
    gap = want.max(-1).values - want.gather(-1, served[..., None])[..., 0]
    assert bool((gap <= 2 * BF16_TOL).all())
    tie = 2 * max(float((own - theirs).abs().max()) for own, theirs, _ in forced.calls)
    for own, _, ids in forced.calls:
        top = own.sort(dim=-1, descending=True, stable=True)
        differ = (top.indices[:, :k].sort(-1).values != ids.sort(-1).values).any(-1)
        margin = top.values[:, k - 1] - top.values[:, k]
        assert bool((margin[differ] <= tie).all())


def test_route_without_renormalisation_matches_numpy():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(32, 64, generator=gen)
    w = torch.randn(64, 16, generator=gen) * 0.125
    probs, ids, weights = mf.route_plain(x, w, 2, renormalize=False)
    logits = x.double().numpy() @ w.double().numpy()
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want_ids = np.argsort(-p, axis=-1, kind="stable")[:, :2]
    assert np.array_equal(ids.numpy(), want_ids)
    assert np.allclose(weights.numpy(), np.take_along_axis(p, want_ids, -1), atol=1e-6)
    assert float(weights.sum(-1).max()) < 1.0
    _, _, renormed = mf.route_plain(x, w, 2)
    assert torch.equal(renormed, weights / weights.sum(-1, keepdim=True).clamp(min=1e-9))
    ids_k, w_k = mf.moe_route(x, w, 2, renormalize=False)
    assert torch.equal(ids_k, ids.int()) and torch.equal(w_k, weights)


@pytest.mark.parametrize("T", [1, 8, 64])
def test_expert_counter_counts_the_distinct_ids(T):
    cfg = _port_cfg(dtype="float32")
    p = ref.make_weights(CFG, 4, "cpu")["layers"][1]["mlp"]
    p = _f32(p)
    x = torch.randn(T, 64, generator=torch.Generator().manual_seed(T))
    count = torch.zeros(1, dtype=torch.int32)
    y, _ = moe.moe_ffn_routed(x, p, cfg, aux=False, count=count)
    ids = mf.route_plain(x, p["router"], 2, renormalize=False)[1]
    assert int(count) == ids.unique().numel()
    moe.moe_ffn_routed(x, p, cfg, aux=False, count=count)
    assert int(count) == 2 * ids.unique().numel()
    assert torch.equal(y, moe.moe_ffn_routed(x, p, cfg, aux=False)[0])


def test_engine_counts_each_layer_and_step():
    """``EngineStats`` and the ``model_generate`` span carry, for every
    generation, the distinct ids each MoE layer routed to, summed over the
    layers (prefill) and over the layers and decode steps (decode)."""
    from repro_torch.obs import TraceRecorder
    P, NEW = 12, 4
    params = ref.make_weights(CFG, 9, "cpu")
    model = Model(_port_cfg(), device="cpu")
    cache = SemanticCache(PolicyEngine(paper_policies()), capacity=64, clock=SimClock(),
                          index_kind="flat", device="cpu")
    rec = TraceRecorder(SimClock())
    eng = ServingEngine(model, params, cache, max_batch=3, prompt_len=P, max_new_tokens=NEW,
                        obs=rec)
    seen = []
    dispatch = mf.dispatch_plain

    def spy(ids, x, n_experts, count=None):
        seen.append((ids.shape[0], ids.unique().numel()))
        return dispatch(ids, x, n_experts, count)

    moe._PLAIN.moe_dispatch = spy
    try:
        for i, toks in enumerate(_tokens(2, 3, P)):
            eng.submit(f"r{i}", "code_generation", toks.numpy())
        eng.drain()
    finally:
        moe._PLAIN.moe_dispatch = dispatch
    n_moe = _port_cfg().mlp_kinds().count("moe")
    assert len(seen) == n_moe * NEW
    want_pre = sum(n for T, n in seen if T == 3 * P)
    want_dec = sum(n for T, n in seen if T == 3)
    assert (eng.stats.experts_prefill, eng.stats.experts_decode) == (want_pre, want_dec)
    span = [s for s in rec.spans if s.stage == "model_generate"][0]
    assert (span.attrs["experts_prefill"], span.attrs["experts_decode"]) == (want_pre, want_dec)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "granite_moe_3b_a800m", "jamba_v0_1_52b"])
def test_other_models_compute_what_they_did(arch):
    """No variant for the other models: no inner norm weights, renormalised
    routing, the SSM parameters and the routing bit for bit the formulas
    they had, and the engine's tokens with the counter equal to the eager
    loop's without it."""
    cfg = get_config(arch).reduced(dtype="float32")
    assert variants.variant_of(cfg) is variants.PLAIN
    model = Model(cfg, device="cpu")
    params = model.init_params(0)
    for sp, kind in zip(params["layers"], cfg.layer_kinds()):
        if kind == "mamba":
            p = sp["mix"]
            assert not set(mam.INNER_NORMS) & set(p)
            x = torch.randn(2, 5, cfg.ssm_d_inner, generator=torch.Generator().manual_seed(1))
            dt, Bc, Cc, A = mam._ssm_params(x, p, cfg)
            proj = (x @ p["w_x_proj"]).split([p["w_dt"].shape[0], cfg.ssm_d_state,
                                              cfg.ssm_d_state], dim=-1)
            assert torch.equal(dt, torch.nn.functional.softplus(proj[0] @ p["w_dt"]
                                                                + p["dt_bias"]))
            assert torch.equal(Bc, proj[1]) and torch.equal(Cc, proj[2])
        if "router" in sp.get("mlp", {}):
            x = torch.randn(8, cfg.d_model, generator=torch.Generator().manual_seed(2))
            probs, ids, w = moe._top_k(x, sp["mlp"]["router"], cfg, cfg.n_experts)
            top = probs.sort(dim=-1, descending=True, stable=True).values[:, :cfg.moe_top_k]
            assert torch.equal(w, top / top.sum(-1, keepdim=True).clamp(min=1e-9))
    toks = torch.randint(2, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(3))
    from repro_torch.core.graphs import CapturedProgram
    from repro_torch.serving.engine import generate
    state = generate(CapturedProgram("cpu"), model, params,
                     {"tokens": toks.int().numpy()}, 12, 4)
    logits, cache, kv_len = model.prefill(params, {"tokens": toks}, 12)
    want = [logits[:, :cfg.vocab_size].argmax(-1)]
    for _ in range(3):
        logits, cache, kv_len = model.decode_step(params, cache, want[-1].int(), kv_len)
        want.append(logits[:, :cfg.vocab_size].argmax(-1))
    assert torch.equal(state["out"], torch.stack(want, 1).int())
    n_moe = cfg.mlp_kinds().count("moe")
    assert (int(state["reached"][0]) > 0) == (n_moe > 0)
    assert int(state["reached"][0]) <= n_moe * cfg.n_experts
