"""repro_torch's mixture-of-experts FFN (``models/moe.py``) against the JAX
reference's, on the CPU.

Inputs are numpy-seeded and carried bit for bit into both packages (bf16
rounded from the same fp32 values). Tolerances, and why:

* ``route``: ids equal (ties to the lower expert, as ``lax.top_k``),
  weights within 1e-6 and aux within 1e-6 of its size (the router product
  sums in another order).
* ``moe_ffn_dense_exact``: within 1e-5 in fp32 (both all-fp32).
* ``moe_ffn_routed`` (the CPU loop) against the reference's dense path:
  within 1e-4 in fp32, the bound of the reference's own routed-against-
  dense test (``tests/test_distributed.py``). In bf16 the routed path
  rounds the hidden and each expert's output to bf16, as the reference's
  routed path does, where the dense path rounds only the sum: within
  2^-6 of the largest output (four bf16 ulps there; two measured).

The card's side of the grouped product (``torch._grouped_mm``) cannot run
here; its shape, dtype and stride checks can, on "meta" tensors, which
take the same non-CPU branch.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import to_tensor  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs: its many tiny CPU
    ops under pytest-xdist (a worker per core) with torch's default pool
    in every worker oversubscribe the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "granite_moe_3b_a800m"
SHAPES = [(8, 2), (40, 8), (384, 8)]          # (experts, top-k): jamba, granite, kimi
D, FFE = 64, 32
BF16_REL = 2.0 ** -6


def _cfgs(E, k, dtype="float32", d=D, ffe=FFE):
    kw = dict(n_experts=E, moe_top_k=k, d_model=d, d_ff_expert=ffe)
    return (dataclasses.replace(jget_config(ARCH).reduced(dtype=dtype), **kw),
            dataclasses.replace(get_config(ARCH).reduced(dtype=dtype), **kw))


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _both(x, dtype):
    """An fp32 numpy array in ``dtype`` for both packages, the same bits."""
    jx = jnp.asarray(x).astype(_jdt(dtype))
    return jx, to_tensor(np.asarray(jx), "cpu")


def _experts(rng, E, dtype, d=D, ffe=FFE, router=None):
    """The reference's MoE leaves (router fp32, experts in ``dtype``) in
    both packages."""
    p = {"router": rng.standard_normal((d, E)).astype(np.float32) * d ** -0.5
         if router is None else router,
         "w_gate": rng.standard_normal((E, d, ffe)).astype(np.float32) * d ** -0.5,
         "w_up": rng.standard_normal((E, d, ffe)).astype(np.float32) * d ** -0.5,
         "w_down": rng.standard_normal((E, ffe, d)).astype(np.float32) * ffe ** -0.5}
    jp = {n: _both(v, "float32" if n == "router" else dtype)[0] for n, v in p.items()}
    return jp, {n: to_tensor(np.asarray(v), "cpu") for n, v in jp.items()}


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _route_both(x, w, E, k, dtype):
    jcfg, cfg = _cfgs(E, k, dtype)
    jx, tx = _both(x, dtype)
    want = jmoe.route(jx, jnp.asarray(w), jcfg, E)
    got = moe.route(tx, torch.from_numpy(w), cfg)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    assert abs(float(got[2]) - float(want[2])) <= 1e-6 * abs(float(want[2]))
    return got[0].numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k", SHAPES)
def test_route_matches_reference(E, k, dtype, rng):
    x = rng.standard_normal((96, D)).astype(np.float32)
    w = rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5
    ids = _route_both(x, w, E, k, dtype)
    assert ids.shape == (96, k) and ids.min() >= 0 and ids.max() < E
    assert all(len(set(row)) == k for row in ids.tolist())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k", [(8, 2), (40, 8)])
def test_route_ties_go_to_the_lower_expert(E, k, dtype, rng):
    """Duplicated router columns give exactly equal probabilities (inputs
    in {-1, 0, 1}, weights in 64ths up to 1/8: every product and sum is
    exact in fp32, in any order, and no probability underflows). Where a
    tied pair straddles the k-th place, the lower expert is taken, as
    ``lax.top_k`` takes it."""
    x = rng.integers(-1, 2, (256, D)).astype(np.float32)
    w = rng.integers(-8, 9, (D, E)).astype(np.float32) / 64
    pairs = [(1, E - 2), (3, 4), (0, E - 1)]
    for lo, hi in pairs:
        w[:, hi] = w[:, lo]
    ids = _route_both(x, w, E, k, dtype)
    logits = x @ w                                           # exact
    assert np.array_equal(ids, np.argsort(-logits, axis=1, kind="stable")[:, :k])
    straddle = 0
    for t in range(len(x)):
        for lo, hi in pairs:
            if (lo in ids[t]) != (hi in ids[t]):             # a tie cut by the k-th place
                straddle += 1
                assert lo in ids[t]
    assert straddle > 0


@pytest.mark.parametrize("E,k", SHAPES)
def test_dense_exact_matches_reference(E, k, rng):
    jcfg, cfg = _cfgs(E, k)
    jx, tx = _both(rng.standard_normal((48, D)).astype(np.float32), "float32")
    jp, tp = _experts(rng, E, "float32")
    want, waux = jmoe.moe_ffn_dense_exact(jx, jp, jcfg)
    got, gaux = moe.moe_ffn_dense_exact(tx, tp, cfg)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)
    assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))


def _routed_case(case, rng, E, k):
    """(x, router) for a case: random tokens; 2 tokens over 40 experts
    (at most 16 groups filled, the rest empty); or every token choosing
    the same k experts (one row repeated)."""
    T = 2 if case == "empty_experts" else 64
    x = rng.standard_normal((T, D)).astype(np.float32)
    if case == "same_experts":
        x[:] = x[0]
    return x, rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "empty_experts", "same_experts"])
@pytest.mark.parametrize("E,k", SHAPES)
def test_routed_matches_reference_dense(E, k, case, dtype, rng):
    jcfg, cfg = _cfgs(E, k, dtype)
    x, router = _routed_case(case, rng, E, k)
    jx, tx = _both(x, dtype)
    jp, tp = _experts(rng, E, dtype, router=router)
    want, waux = jmoe.moe_ffn_dense_exact(jx, jp, jcfg)
    got, gaux = moe.moe_ffn_routed(tx, tp, cfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    w = _f32(want)
    tol = 1e-4 if dtype == "float32" else BF16_REL * np.abs(w).max()
    np.testing.assert_allclose(_f32(got), w, atol=tol, rtol=0)
    assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))
    ids = moe.route(tx, tp["router"], cfg)[0]
    used = len(set(ids.flatten().tolist()))
    if case == "empty_experts":
        assert used <= 2 * k < E
    if case == "same_experts":
        assert used == k


def test_moe_apply_keeps_the_leading_shape(rng):
    jcfg, cfg = _cfgs(8, 2)
    jp, tp = _experts(rng, 8, "float32")
    x = torch.from_numpy(rng.standard_normal((3, 5, D)).astype(np.float32))
    y, _ = moe.moe_apply(x, tp, cfg)
    want, _ = moe.moe_ffn_routed(x.reshape(15, D), tp, cfg)
    assert y.shape == x.shape and torch.equal(y.reshape(15, D), want)


def test_grouped_mm_cpu_loop_is_each_groups_product(rng):
    """Rows sorted by group, offsets as cumulative ends, empty groups
    included: each slice is its group's fp32 product."""
    w = torch.from_numpy(rng.standard_normal((5, 16, 8)).astype(np.float32))
    rows = torch.from_numpy(rng.standard_normal((11, 16)).astype(np.float32))
    ends = [3, 3, 7, 7, 11]
    out = moe.grouped_mm(rows.to(torch.bfloat16), w.to(torch.bfloat16),
                         torch.tensor(ends, dtype=torch.int32))
    assert out.dtype == torch.float32
    start = 0
    for e, end in enumerate(ends):
        want = rows[start:end].to(torch.bfloat16).float() @ w[e].to(torch.bfloat16).float()
        np.testing.assert_allclose(out[start:end].numpy(), want.numpy(), atol=1e-5, rtol=0)
        start = end


@pytest.mark.parametrize("arch,T", [("granite_moe_3b_a800m", 512),
                                    ("granite_moe_3b_a800m", 8),
                                    ("jamba_v0_1_52b", 128)])
def test_card_path_accepts_full_width_layouts(arch, T):
    """On a non-CPU tensor the routed path takes ``torch._grouped_mm``
    (here its meta kernel, which runs the card's shape, dtype and stride
    checks) at full width, with the experts in their stored order."""
    cfg = get_config(arch)
    d, ffe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    dev = "meta"
    p = {"router": torch.empty(d, E, device=dev),
         "w_gate": torch.empty(E, d, ffe, dtype=torch.bfloat16, device=dev),
         "w_up": torch.empty(E, d, ffe, dtype=torch.bfloat16, device=dev),
         "w_down": torch.empty(E, ffe, d, dtype=torch.bfloat16, device=dev)}
    y, _ = moe.moe_ffn_routed(torch.empty(T, d, dtype=torch.bfloat16, device=dev), p, cfg)
    assert y.shape == (T, d) and y.dtype == torch.bfloat16


def test_card_path_raises_instead_of_falling_back():
    """fp32 operands, or a layout ``_grouped_mm`` refuses, raise and name
    the cause; nothing falls back to the loop or the dense path."""
    rows = torch.empty(64, 128, dtype=torch.float32, device="meta")
    offs = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="bf16 operands only"):
        moe.grouped_mm(rows, torch.empty(8, 128, 64, device="meta"), offs)
    odd = torch.empty(8, 128, 65, dtype=torch.bfloat16, device="meta")[..., :64]
    with pytest.raises(RuntimeError, match="refused"):
        moe.grouped_mm(rows.to(torch.bfloat16), odd, offs)
