"""The MoE FFN's fused steps (``kernels/moe_fused.py``) on the CPU.

The card's kernels cannot run here. What can:

* each plain version against the op chain ``models/moe.py`` ran before the
  kernels (copied below as ``_chain_*``), bit for bit, at granite-moe's,
  jamba's and kimi-k2's experts and top-k (40 / 8, 16 / 2, 384 / 8) and
  at T 1, 8 and 512 (one token, a decode step of 8, a prefill of 8 x 64);
* the kernels' algorithms, written out in numpy as the CUDA source does
  them (``_counting_sort``: counts before each 32-pair segment, a scan,
  ranks among equal experts in the segment; ``_argmax_rounds``: k rounds
  of (probability descending, expert ascending); ``_inverse_rows``: each
  token's k rows found by a scan of order), against the stable sort,
  ``searchsorted`` and ``index_copy_`` they replace, with empty experts,
  every pair on one expert and exact ties;
* where each step runs: serving (prefill, decode) computes no aux and
  returns None, train mode's aux is the op chain's value; "meta" tensors
  and autograd take the plain versions; the kernels' wrappers raise off
  the card, and count their launches.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import moe_fused as mf
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (pytest-xdist runs
    a worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(40, 8), (16, 2), (384, 8)]          # (experts, top-k): granite, jamba, kimi
TOKENS = [1, 8, 512]
D, FFE = 64, 32


def _cfg(E, k, dtype="float32"):
    return dataclasses.replace(get_config("granite_moe_3b_a800m").reduced(dtype=dtype),
                               n_experts=E, moe_top_k=k, d_model=D, d_ff_expert=FFE)


def _inputs(E, T, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed + 1000 * E + T)
    x = torch.randn((T, D), generator=gen).to(dtype)
    p = {"router": torch.randn((D, E), generator=gen) * D ** -0.5,
         "w_gate": (torch.randn((E, D, FFE), generator=gen) * D ** -0.5).to(dtype),
         "w_up": (torch.randn((E, D, FFE), generator=gen) * D ** -0.5).to(dtype),
         "w_down": (torch.randn((E, FFE, D), generator=gen) * FFE ** -0.5).to(dtype)}
    return x, p


# ---------------------------------------------------- the op chain, as it was

def _chain_top_k(x, router_w, k, e_pad):
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    if e_pad > logits.shape[-1]:
        logits = F.pad(logits, (0, e_pad - logits.shape[-1]), value=-1e30)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, ids, weights


def _chain_route(x, router_w, k):
    probs, ids, weights = _chain_top_k(x, router_w, k, router_w.shape[-1])
    E = probs.shape[-1]
    f = torch.zeros(E, dtype=torch.float32).scatter_add_(
        0, ids.reshape(-1), torch.ones(ids.numel()))
    f = f / f.sum().clamp(min=1.0)
    aux = E * torch.sum(f * probs.mean(dim=0))
    return ids.to(torch.int32), weights, aux


def _chain_dispatch(ids, x, E):
    k = ids.shape[-1]
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    tok = torch.div(order, k, rounding_mode="floor")
    bounds = torch.arange(E, dtype=sorted_ids.dtype)
    offs = torch.searchsorted(sorted_ids, bounds, right=True).to(torch.int32)
    return order, offs, x.index_select(0, tok)


def _chain_ffn(x, p, k, E):
    T, d = x.shape
    ids, weights, aux = _chain_route(x, p["router"], k)
    order, offs, rows = _chain_dispatch(ids, x, E)
    g = moe.grouped_mm(rows, p["w_gate"], offs)
    u = moe.grouped_mm(rows, p["w_up"], offs)
    hidden = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    part = moe.grouped_mm(hidden, p["w_down"], offs).to(x.dtype)
    pairs = torch.empty_like(part).index_copy_(0, order, part)
    y = (pairs.view(T, k, d).to(torch.float32) * weights[..., None]).sum(dim=1)
    return y.to(x.dtype), aux


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------- the kernels' algorithms in numpy

def _counting_sort(flat_ids: np.ndarray, E: int, seg: int = 32):
    """``moe_dispatch_kernel``: every segment of ``seg`` pairs counts the
    pairs of each expert before it, scans the totals into starts, and ranks
    its own pairs among equal experts by lane."""
    N = len(flat_ids)
    total = np.bincount(flat_ids, minlength=E)
    ends = np.cumsum(total)
    order = np.full(N, -1, np.int64)
    for seg0 in range(0, N, seg):
        first = np.bincount(flat_ids[:seg0], minlength=E) + ends - total
        ids = flat_ids[seg0:seg0 + seg]
        for lane, e in enumerate(ids):
            rank = int((ids[:lane] == e).sum())
            order[first[e] + rank] = seg0 + lane
    return order, ends.astype(np.int32)


def _argmax_rounds(probs: np.ndarray, k: int):
    """``moe_route_kernel``'s selection: k rounds, each the largest
    probability left, the lower expert among equals."""
    pr = probs.astype(np.float32).copy()
    ids = np.zeros((len(pr), k), np.int64)
    for r in range(k):
        best = pr.max(axis=1, keepdims=True)
        ids[:, r] = (pr == best).argmax(axis=1)      # first (lowest) expert at the max
        pr[np.arange(len(pr)), ids[:, r]] = -3.0
    return ids


def _inverse_rows(order: np.ndarray, T: int, k: int, tb: int):
    """``moe_combine_kernel``: each block of ``tb`` tokens scans order for
    its pairs; row (t, q) is the sorted position of pair t·k + q."""
    src = np.full((T, k), -1, np.int64)
    for t0 in range(0, T, tb):
        mine = np.flatnonzero((order // k >= t0) & (order // k < t0 + tb))
        src[order[mine] // k, order[mine] % k] = mine
    return src


def _ids_case(case, T, E, k, seed=0):
    rng = np.random.default_rng(seed + T + E)
    if case == "random":
        return np.stack([rng.permutation(E)[:k] for _ in range(T)])
    if case == "empty_experts":         # only the first 2k experts reached
        return np.stack([rng.permutation(min(2 * k, E))[:k] for _ in range(T)])
    return np.tile(np.arange(k), (T, 1))   # every token on the same k experts


# ----------------------------------------------------------------- routing

@pytest.mark.parametrize("T", TOKENS)
@pytest.mark.parametrize("E,k", SHAPES)
def test_route_plain_is_the_op_chain(E, k, T):
    x, p = _inputs(E, T, torch.bfloat16)
    want = _chain_top_k(x, p["router"], k, E)
    for got, w in zip(mf.route_plain(x, p["router"], k, E), want):
        _same(got, w)
    for got, w in zip(moe.route(x, p["router"], _cfg(E, k)), _chain_route(x, p["router"], k)):
        _same(got, w)
    ids, weights = ops.moe_route(x, p["router"], k)
    _same(ids, want[1].to(torch.int32))
    _same(weights, want[2])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("E,k", SHAPES)
def test_route_kernel_selection_is_the_stable_top_k(E, k, ties):
    """k argmax rounds with ties to the lower expert pick what the stable
    descending sort's first k are, exact ties included: with ``ties`` the
    router has 5 distinct columns, expert e taking column e % 5, and
    inputs and weights whose products sum exactly in any order."""
    x, p = _inputs(E, 64)
    w = p["router"]
    if ties:
        x = torch.randint(-1, 2, x.shape, generator=torch.Generator().manual_seed(3)).float()
        base = torch.randint(-8, 9, (D, 5), generator=torch.Generator().manual_seed(4)) / 64
        w = base[:, torch.arange(E) % 5]
    probs, ids, _ = mf.route_plain(x, w, k)
    assert np.array_equal(_argmax_rounds(probs.numpy(), k), ids.numpy())
    if ties:                            # the k lowest experts of the best column
        best = (x @ base).argmax(dim=1)
        cls = torch.arange(E) % 5
        for t in range(0, 64, 7):
            mine = torch.nonzero(cls == best[t]).flatten()[:k]
            if len(mine) == k:
                assert ids[t].tolist() == mine.tolist()


def test_route_under_autograd_is_the_op_chain():
    x, p = _inputs(40, 8)
    router = p["router"].clone().requires_grad_(True)
    ids, weights, aux = moe.route(x, router, _cfg(40, 8))
    want = _chain_route(x, router, 8)
    _same(ids, want[0])
    assert torch.equal(weights, want[1]) and torch.equal(aux, want[2])
    aux.backward()
    assert router.grad is not None


# ---------------------------------------------------------------- dispatch

@pytest.mark.parametrize("T", TOKENS)
@pytest.mark.parametrize("E,k", SHAPES)
def test_dispatch_plain_is_the_op_chain(E, k, T):
    x, p = _inputs(E, T, torch.bfloat16)
    ids = ops.moe_route(x, p["router"], k)[0]
    for got, want in zip(mf.dispatch_plain(ids, x, E), _chain_dispatch(ids, x, E)):
        _same(got, want)
    for got, want in zip(ops.moe_dispatch(ids, x, E), _chain_dispatch(ids, x, E)):
        _same(got, want)


@pytest.mark.parametrize("case", ["random", "empty_experts", "same_experts"])
@pytest.mark.parametrize("T", TOKENS)
@pytest.mark.parametrize("E,k", SHAPES)
def test_dispatch_kernel_counting_sort_is_the_stable_sort(E, k, T, case):
    """The kernel's counting sort gives the stable sort's order and
    ``searchsorted``'s ends, with empty experts and with every pair on
    one expert's rows."""
    ids = _ids_case(case, T, E, k)
    x = torch.zeros((T, D))
    order, offs, _ = mf.dispatch_plain(torch.from_numpy(ids).to(torch.int32), x, E)
    got_order, got_offs = _counting_sort(ids.reshape(-1), E)
    assert np.array_equal(got_order, order.numpy())
    assert np.array_equal(got_offs, offs.numpy())
    if case == "same_experts":
        assert offs.numpy()[k - 1] == T * k and (np.diff(offs.numpy()[:k]) == T).all()
    if case == "empty_experts" and E > 2 * k:
        assert (offs.numpy()[2 * k:] == T * k).all()


# ------------------------------------------------------------ swiglu, combine

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_plain_is_the_op_chain(dtype):
    gen = torch.Generator().manual_seed(5)
    g, u = (torch.randn((64, FFE), generator=gen) * 4).to(dtype), \
        torch.randn((64, FFE), generator=gen).to(dtype)
    want = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(dtype)
    _same(mf.swiglu_plain(g, u, dtype), want)
    _same(ops.swiglu_cast(g, u, dtype), want)


@pytest.mark.parametrize("T", TOKENS)
@pytest.mark.parametrize("E,k", SHAPES)
def test_combine_plain_is_the_op_chain(E, k, T):
    x, p = _inputs(E, T, torch.bfloat16)
    ids, weights = ops.moe_route(x, p["router"], k)
    order, _, rows = mf.dispatch_plain(ids, x, E)
    part = (rows.float() * 1.5).to(torch.bfloat16)
    pairs = torch.empty_like(part).index_copy_(0, order, part)
    want = (pairs.view(T, k, D).to(torch.float32) * weights[..., None]).sum(dim=1)
    _same(mf.combine_plain(part, order, weights), want.to(torch.bfloat16))
    _same(ops.moe_combine(part, order, weights), want.to(torch.bfloat16))
    # the kernel's rows of each token: the inverse permutation of order
    tb = max(1, min(8, T // 128))
    src = _inverse_rows(order.numpy(), T, k, tb)
    inverse = torch.empty_like(order).index_copy_(0, order, torch.arange(T * k))
    assert np.array_equal(src.reshape(-1), inverse.numpy())


# ----------------------------------------------------------- the routed FFN

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", TOKENS)
@pytest.mark.parametrize("E,k", SHAPES)
def test_routed_ffn_is_the_op_chain(E, k, T, dtype):
    x, p = _inputs(E, T, getattr(torch, dtype))
    cfg = _cfg(E, k, dtype)
    want, waux = _chain_ffn(x, p, k, E)
    got, aux = moe.moe_ffn_routed(x, p, cfg)
    _same(got, want)
    _same(aux, waux)
    served, none = moe.moe_ffn_routed(x, p, cfg, aux=False)
    _same(served, want)
    assert none is None


def test_meta_and_autograd_take_the_plain_steps(monkeypatch):
    """Off the card (here "meta", the card's branch of the grouped product)
    and under autograd no kernel wrapper is called, with aux or without."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    for name in ("moe_route", "moe_dispatch", "swiglu_cast", "moe_combine"):
        monkeypatch.setattr(ops, name, refuse)
    cfg = get_config("granite_moe_3b_a800m")
    d, ffe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {"router": torch.empty(d, E, device="meta"),
         "w_gate": torch.empty(E, d, ffe, dtype=torch.bfloat16, device="meta"),
         "w_up": torch.empty(E, d, ffe, dtype=torch.bfloat16, device="meta"),
         "w_down": torch.empty(E, ffe, d, dtype=torch.bfloat16, device="meta")}
    for aux in (True, False):
        y, _ = moe.moe_ffn_routed(torch.empty(8, d, dtype=torch.bfloat16, device="meta"),
                                  p, cfg, aux=aux)
        assert y.shape == (8, d) and y.device.type == "meta"
    x, p = _inputs(16, 8)
    p = {n: t.requires_grad_(True) for n, t in p.items()}
    y, aux = moe.moe_ffn_routed(x, p, _cfg(16, 2))
    (y.sum() + aux).backward()
    assert all(t.grad is not None for t in p.values())


# ---------------------------------------------- serving computes no aux

def _moe_layer(cfg):
    model = Model(cfg, device="cpu")
    params = model.init_params(0)
    pattern = tf.layer_pattern(cfg)
    i = next(i for i, spec in enumerate(pattern) if spec.mlp == "moe")
    return model, params, params["layers"][i], pattern[i]


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_serving_modes_compute_no_aux(mode, monkeypatch):
    """Prefill and decode ask every MoE layer for no aux and return None
    from each layer: no Switch loss and no zero tensor per layer."""
    cfg = get_config("granite_moe_3b_a800m").reduced(dtype="float32")
    model, params, _, _ = _moe_layer(cfg)
    calls = []
    real = moe.moe_apply

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append((kw.get("aux", True), out[1]))
        return out

    layers = []
    real_layer = tf.sublayer_apply

    def layer_spy(*a, **kw):
        out = real_layer(*a, **kw)
        layers.append(out[1])
        return out

    monkeypatch.setattr(moe, "moe_apply", spy)
    monkeypatch.setattr(tf, "sublayer_apply", layer_spy)
    toks = torch.randint(1, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(7))
    _, cache, kv = model.prefill(params, {"tokens": toks}, 12)
    if mode == "decode":
        calls.clear()
        layers.clear()
        model.decode_step(params, cache, toks[:, -1], kv)
    assert len(calls) == cfg.mlp_kinds().count("moe") > 0
    assert all(want is False and got is None for want, got in calls)
    assert len(layers) == cfg.n_layers and all(a is None for a in layers)


def test_train_mode_aux_is_the_op_chain(monkeypatch):
    """Train mode's aux is the op chain's Switch loss of the layer's router
    input, bit for bit."""
    cfg = get_config("granite_moe_3b_a800m").reduced(dtype="float32")
    _, params, _, _ = _moe_layer(cfg)
    seen = []
    real = moe.route

    def spy(x, w, c):
        seen.append((x.detach().clone(), w.detach()))
        return real(x, w, c)

    monkeypatch.setattr(moe, "route", spy)
    pattern = tf.layer_pattern(cfg)
    h = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(8))
    positions = torch.arange(8)[None].expand(2, 8)
    total = torch.zeros(())
    for sp, spec in zip(params["layers"], pattern):
        h, aux = tf.sublayer_apply(h, sp, cfg, spec, mode="train", positions=positions)
        assert aux.dtype == torch.float32 and aux.shape == ()
        if spec.mlp == "moe":
            xin, w = seen[-1]
            _same(aux.detach(), _chain_route(xin, w, cfg.moe_top_k)[2])
            total = total + aux.detach()
        else:
            assert float(aux) == 0.0
    assert len(seen) == cfg.mlp_kinds().count("moe") > 0 and float(total) > 0


# ------------------------------------------------------------- the wrappers

@pytest.mark.parametrize("name", ["moe_route", "moe_dispatch", "swiglu_cast", "moe_combine"])
def test_wrappers_raise_off_the_card_and_count(name):
    """A tensor neither on the CPU nor on a CUDA device raises, naming the
    wrapper (no fallback to the plain version); each wrapper counts its
    launches and is one of the counted wrappers."""
    meta = dict(device="meta")
    args = {"moe_route": (torch.empty(8, D, **meta), torch.empty(D, 40, **meta), 8),
            "moe_dispatch": (torch.empty(8, 8, dtype=torch.int32, **meta),
                             torch.empty(8, D, dtype=torch.bfloat16, **meta), 40),
            "swiglu_cast": (torch.empty(64, FFE, dtype=torch.bfloat16, **meta),
                            torch.empty(64, FFE, dtype=torch.bfloat16, **meta),
                            torch.bfloat16),
            "moe_combine": (torch.empty(64, D, dtype=torch.bfloat16, **meta),
                            torch.empty(64, dtype=torch.int32, **meta),
                            torch.empty(8, 8, **meta))}[name]
    with pytest.raises(ValueError, match=name):
        getattr(ops, name)(*args)
    fn = getattr(mf, name)
    assert fn in ops.COUNTED and fn.launches == fn.recorded == 0
