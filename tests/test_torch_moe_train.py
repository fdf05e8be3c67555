"""Training through the MoE FFN's grouped product, on the CPU.

On the card the grouped product runs inside ``moe.GroupedMmFn``, the
counterpart of the reference's ``_ragged_dot`` custom VJP, over
``torch._grouped_mm``. Its backward is two more products of the same
function, so here the Function runs with the CPU loop (``moe._loop_mm``,
the op's function in fp32) as its product:

* against ``jax.vjp`` of the reference's ``_ragged_dot`` on the same
  seeded inputs, empty groups and a zero-weight spare group (as
  ``_moe_local``'s) included: fp32, each output within 1e-5 of its
  largest |value|;
* against autograd of the loop itself, fp32 and bf16, within the same
  bound; in bf16 each gradient has its operand's dtype;
* forced into ``moe_ffn_routed`` (in place of the loop), the loss and
  every gradient of reduced granite-moe and jamba against the
  reference's, with ``tests/test_torch_train.py``'s tolerances (loss
  within 1e-5 relative, each leaf within 1e-4 of its largest |grad|; the
  reference's attention with fp32 probabilities, as there);
* on "meta" tensors, which take the card's branch and run
  ``_grouped_mm``'s shape, dtype and stride checks, the routed FFN at
  granite's full width under grad, backward included, through the
  Function.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models.attention as jattn  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from _exact_attention import attend_prefill_exact  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_reference, tree_leaves  # noqa: E402

# Group sizes: two empty groups, and a last "spare" group whose weight is
# zero (``_moe_local``'s invalid rows).
SIZES = [3, 0, 5, 4, 0, 6]
K, M = 16, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (see
    ``tests/test_torch_shard.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grouped_inputs(seed: int):
    rng = np.random.default_rng(seed)
    N, G = sum(SIZES), len(SIZES)
    rows = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal((G, K, M)).astype(np.float32)
    w[-1] = 0.0
    ct = rng.standard_normal((N, M)).astype(np.float32)
    return rows, w, ct, torch.tensor(np.cumsum(SIZES), dtype=torch.int32)


def function_grads(rows, w, ct, offs, product):
    r, ww = rows.clone().requires_grad_(), w.clone().requires_grad_()
    out = product(r, ww, offs)
    return (out, *torch.autograd.grad(out, (r, ww), ct.to(out.dtype)))


def close(got, want, rel=1e-5):
    want = torch.from_numpy(np.array(want, np.float32))
    err = float((got.detach().float() - want).abs().max())
    return err <= rel * float(want.abs().max()), err


def test_function_matches_reference_ragged_dot_vjp():
    rows, w, ct, offs = grouped_inputs(0)
    sizes = jnp.asarray(SIZES, jnp.int32)
    out, vjp = jax.vjp(lambda a, b: jmoe._ragged_dot(a, b, sizes),
                       jnp.asarray(rows), jnp.asarray(w))
    want = (out, *vjp(jnp.asarray(ct)))
    got = function_grads(*(torch.from_numpy(a) for a in (rows, w, ct)), offs,
                         lambda r, ww, o: moe.GroupedMmFn.apply(r, ww, o, moe._loop_mm))
    for name, g, wt in zip(("out", "d_rows", "d_w"), got, want):
        ok, err = close(g, wt)
        assert ok, (name, err)
    # an empty group's weights get zeros; the spare group's rows get zeros
    assert not got[2][1].any() and not got[2][4].any()
    assert not got[1][-SIZES[-1]:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_matches_autograd_of_the_loop(dtype):
    rows, w, ct, offs = grouped_inputs(1)
    rows, w, ct = (torch.from_numpy(a).to(dtype) for a in (rows, w, ct))
    got = function_grads(rows, w, ct, offs,
                         lambda r, ww, o: moe.GroupedMmFn.apply(r, ww, o, moe._loop_mm))
    want = function_grads(rows, w, ct, offs, moe._loop_mm)
    assert got[1].dtype == rows.dtype == dtype and got[2].dtype == w.dtype == dtype
    for name, g, wt in zip(("out", "d_rows", "d_w"), got, want):
        assert g.dtype == wt.dtype, name
        ok, err = close(g, wt.detach().float().numpy())
        assert ok, (name, err)


def _function_in_the_routed_ffn(monkeypatch):
    applied = []

    def grouped(rows, w, offs):
        applied.append(1)
        return moe.GroupedMmFn.apply(rows, w, offs, moe._loop_mm)
    monkeypatch.setattr(moe, "grouped_mm", grouped)
    return applied


@pytest.mark.parametrize("arch,layers", [("granite_moe_3b_a800m", 2), ("jamba_v0_1_52b", 6)])
def test_model_grads_through_the_function_match_reference(arch, layers, monkeypatch):
    """Reduced granite-moe (2 layers, MoE in both) and jamba (6 layers:
    Mamba, attention at layer 4, MoE FFNs at 1, 3 and 5), fp32, B 2 × S
    32: the loss and every gradient leaf with the Function in
    ``moe_ffn_routed`` against ``jax.value_and_grad`` of the reference's
    loss."""
    monkeypatch.setattr(jattn, "attend_prefill", attend_prefill_exact)
    jcfg = jget_config(arch).reduced(dtype="float32", n_layers=layers)
    cfg = get_config(arch).reduced(dtype="float32", n_layers=layers)
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.key(0))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = tree_leaves(params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jg), cfg, "cpu"))

    applied = _function_in_the_routed_ffn(monkeypatch)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = Model(cfg, device="cpu").loss_fn(tp, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
    assert len(applied) == 3 * cfg.mlp_kinds().count("moe")    # the forward's products
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert all(g is not None for g in got)
    errs = [float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            for g, w in zip(got, want)]
    assert max(errs) <= 1e-4, (max(errs), int(np.argmax(errs)))


def test_card_branch_trains_at_full_width_on_meta(monkeypatch):
    """granite's routed FFN at full width (d 1,536, 40 experts, top-8,
    d_ff_expert 512; T 128, a B 2 × S 64 batch) on "meta" tensors under
    grad: forward and backward through ``GroupedMmFn`` over the op (its
    meta kernel checks the card's shapes, dtypes and strides: the
    transposed weights as views, the 2-D × 2-D weight gradient), each
    gradient of its operand's shape and dtype."""
    applied = []
    apply = moe.GroupedMmFn.apply
    monkeypatch.setattr(moe.GroupedMmFn, "apply", lambda *a: applied.append(a[3]) or apply(*a))
    cfg = get_config("granite_moe_3b_a800m")
    d, ffe, E, T = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, 128
    bf = dict(dtype=torch.bfloat16, device="meta", requires_grad=True)
    p = {"router": torch.empty(d, E, device="meta", requires_grad=True),
         "w_gate": torch.empty(E, d, ffe, **bf), "w_up": torch.empty(E, d, ffe, **bf),
         "w_down": torch.empty(E, ffe, d, **bf)}
    x = torch.empty(T, d, **bf)
    y, aux = moe.moe_ffn_routed(x, p, cfg)
    wrt = [x, *p.values()]
    grads = torch.autograd.grad((y.float().sum(), aux), wrt)
    assert applied == [moe._op_mm] * 3
    assert all(g.shape == t.shape and g.dtype == t.dtype for g, t in zip(grads, wrt))


def test_dense_exact_and_function_agree_on_a_moe_layers_grads(monkeypatch):
    """One MoE layer (granite's routing at a reduced width, bf16) through
    the Function against autograd of ``moe_ffn_dense_exact`` (every
    expert in fp32): dx, each expert matrix and the router within 2^-6 of
    each leaf's largest |grad|, the bound chip_smoke's card check uses."""
    _function_in_the_routed_ffn(monkeypatch)
    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m").reduced(dtype="bfloat16"),
                              n_experts=8, moe_top_k=2, d_model=64, d_ff_expert=32)
    from repro_torch.models.layers import init_moe
    gen = torch.Generator().manual_seed(3)
    p = init_moe(gen, cfg, "cpu")
    x = torch.randn((48, cfg.d_model), generator=gen).to(torch.bfloat16)
    dy = torch.randn((48, cfg.d_model), generator=gen)

    def grads(ffn):
        leaves = [x.clone().requires_grad_(), *(t.clone().requires_grad_() for t in p.values())]
        y, _ = ffn(leaves[0], dict(zip(p, leaves[1:])), cfg)
        return torch.autograd.grad((y.float() * dy).sum(), leaves)
    got, want = grads(moe.moe_ffn_routed), grads(moe.moe_ffn_dense_exact)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        err = float((g.float() - w.float()).abs().max())
        assert err <= 2.0 ** -6 * float(w.float().abs().max()), err
