"""repro_torch's training path against the JAX reference, on the CPU:
``Model.loss_fn`` and its gradients for every family, remat, the kernels'
autograd Functions, and the data pipeline.

The reference's parameters are carried across with
``convert.params_from_reference``, and so are its gradients (the same
tree), so leaves line up; inputs come from numpy seeds. Reduced configs,
2 layers, B 2, S 32.

Tolerances, and why. The reference's ``attend_prefill`` rounds the
softmax probabilities to bf16 before P·V; the port's plain attention (and
its fp32 kernel) does not. That alone moves a reduced model's loss by up
to ~5e-5 relative. So the loss comparisons run the reference with
``attend_prefill_exact`` in place of its ``attend_prefill`` (fixture
``exact_reference_attention``): the same function, P kept in
fp32. Then, in fp32: loss, xent, aux and tokens within 1e-5 relative,
every gradient leaf within 1e-4 of its largest |grad|. One bf16 case
(llama): loss within 1e-3 relative and each gradient leaf within 3e-2
(about 8 bf16 steps) of its largest |grad| (bf16 activations rounded at
different points, 2^-8 relative each, through 2 layers and a 512-way
softmax; measured 6e-5 and 1.5e-2 on this seed). The kernel
Functions against the unpatched reference's ``attend_prefill``: within
2^-7 of the largest |grad| (its bf16 probabilities; measured ≤ 3.3e-3); against the plain
versions' autograd on the same inputs: equal within 1e-6 (fp32).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models.attention as jattn  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import PackedBatcher as JBatcher  # noqa: E402
from repro.data import SyntheticCorpus as JCorpus  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402

from _exact_attention import attend_prefill_exact  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import BatcherState, PackedBatcher, SyntheticCorpus  # noqa: E402
from repro_torch.kernels import flash_attention as _fa  # noqa: E402
from repro_torch.kernels import mamba_scan as _ms  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models.convert import (params_from_reference, tree_leaves,  # noqa: E402
                                        tree_unflatten)

ARCHS = ["llama3_2_3b", "gemma2_2b", "falcon_mamba_7b", "whisper_large_v3",
         "llava_next_mistral_7b", "granite_moe_3b_a800m"]
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (see
    ``tests/test_torch_shard.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def opaque_kernels():
    """The wrappers' CPU versions run under ``no_grad``, as the card's
    kernels (ctypes launches into fresh outputs) are opaque to autograd:
    a gradient then comes only through the kernels' Functions."""
    def opaque(fn):
        return torch.no_grad()(fn)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_fa, "flash_attention_plain", opaque(_fa.flash_attention_plain))
        mp.setattr(_ms, "mamba_scan_plain", opaque(_ms.mamba_scan_plain))
        yield


@pytest.fixture
def exact_reference_attention():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattn, "attend_prefill", attend_prefill_exact)
        yield


def make_batch(cfg, seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels[0, :3] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        out["audio"] = rng.standard_normal((batch, cfg.enc_ctx, cfg.enc_dim)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((batch, cfg.n_patches, cfg.d_model)
                                             ).astype(np.float32)
    return out


def pair(arch, dtype="float32", **over):
    jcfg = jget_config(arch).reduced(dtype=dtype, n_layers=2, **over)
    cfg = get_config(arch).reduced(dtype=dtype, n_layers=2, **over)
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jm, jp, Model(cfg, device="cpu"), tp


def ref_loss_and_grads(jm, jp, batch, cfg):
    (loss, met), g = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    grads = params_from_reference(jax.tree.map(lambda a: np.asarray(a, np.float32), g),
                                  cfg, "cpu")
    return float(loss), {k: float(v) for k, v in met.items()}, grads


def port_loss_and_grads(tm, tp, batch):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, met, grads


def leaf_errors(got, want):
    """Each leaf's max |got - want| over the largest |want|."""
    return [float((g.float() - w).abs().max() / w.abs().max().clamp(min=1e-30))
            for g, w in zip(got, tree_leaves(want))]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, exact_reference_attention):
    cfg, jm, jp, tm, tp = pair(arch)
    batch = make_batch(cfg)
    jl, jmet, jg = ref_loss_and_grads(jm, jp, batch, cfg)
    tl, tmet, tg = port_loss_and_grads(tm, tp, batch)
    assert abs(float(tl) - jl) <= 1e-5 * abs(jl)
    for key in ("xent", "aux", "tokens"):
        assert abs(float(tmet[key]) - jmet[key]) <= 1e-5 * max(abs(jmet[key]), 1e-6), key
    if cfg.n_experts:
        assert float(tmet["aux"]) > 0                 # the MoE aux is carried
    assert all(g is not None for g in tg)
    errs = leaf_errors(tg, jg)
    assert max(errs) <= 1e-4, (max(errs), int(np.argmax(errs)))


def test_bf16_loss_and_grads_match_reference(exact_reference_attention):
    cfg, jm, jp, tm, tp = pair("llama3_2_3b", "bfloat16")
    batch = make_batch(cfg, seed=1)
    jl, _, jg = ref_loss_and_grads(jm, jp, batch, cfg)
    tl, _, tg = port_loss_and_grads(tm, tp, batch)
    assert abs(float(tl) - jl) <= 1e-3 * abs(jl)
    assert all(g.dtype == p.dtype for g, p in zip(tg, tree_leaves(tp)))
    assert max(leaf_errors(tg, jg)) <= 3e-2


@pytest.mark.parametrize("arch", ["llama3_2_3b", "falcon_mamba_7b", "granite_moe_3b_a800m"])
def test_remat_changes_nothing(arch, opaque_kernels):
    """remat none / dots / full: the same loss and gradients, bit for bit,
    and the kernels' forwards run again in the recompute."""
    out = {}
    for remat in ("none", "dots", "full"):
        cfg, _, _, tm, tp = pair(arch, remat=remat)
        batch = make_batch(cfg)
        wrapper = flash_attention if cfg.family != "ssm" else mamba_scan
        before = wrapper.launches
        out[remat] = port_loss_and_grads(tm, tp, batch)
        assert wrapper.launches == before       # the CPU path counts nothing
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][2], out["none"][2]))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_param_gets_a_gradient(arch, opaque_kernels):
    """Every leaf the loss reaches has a non-None, non-zero gradient, with
    the kernels opaque to autograd as on the card: a kernel call outside
    its Function would leave the projections before it without one."""
    cfg, _, _, tm, tp = pair(arch)
    _, _, grads = port_loss_and_grads(tm, tp, make_batch(cfg))
    named = tree_unflatten(tp, grads)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, f"{path}/{i}")
        else:
            yield path, tree
    missing = [p for p, g in walk(named) if g is None or not bool(g.abs().max() > 0)]
    assert not missing, missing


# ------------------------------------------------------------- kernel Functions
ATTN_CASES = [dict(causal=True), dict(causal=True, window=5), dict(causal=True, softcap=5.0),
              dict(causal=True, kv_offset=7), dict(causal=False)]


def attn_inputs(seed, Sq=12, Skv=12, H=4, Hkv=2, dh=16, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, s, dh)).astype(np.float32)
                                ).to(dtype) for n, s in ((H, Sq), (Hkv, Skv), (Hkv, Skv)))
    dout = torch.from_numpy(rng.standard_normal((B, H, Sq, dh)).astype(np.float32))
    return q, k, v, dout.to(dtype)


def grads(fn, inputs, dout):
    ins = [t.clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*ins), ins, dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_function_backward_is_the_plain_versions(case, dtype):
    Skv = 12 + case.get("kv_offset", 0)
    q, k, v, dout = attn_inputs(0, Skv=Skv, dtype=dtype)
    kw = dict(window=None, softcap=None, kv_offset=0) | case
    got = grads(lambda *t: FlashAttentionFn.apply(*t, kw["causal"], kw["window"],
                                                  kw["softcap"], kw["kv_offset"], None),
                (q, k, v), dout)
    want = grads(lambda *t: ref.attention_ref(*t, **kw), (q, k, v), dout)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attend_prefill_grads_match_reference(case):
    """The port's ``attend_prefill`` (through ``FlashAttentionFn``) against
    ``jax.grad`` of the reference's, on (B, S, H, dh) inputs: GQA, and the
    transposed views saved as they are."""
    Skv = 12 + case.get("kv_offset", 0)
    q, k, v, dout = (t.transpose(1, 2).contiguous() for t in attn_inputs(1, Skv=Skv))
    kw = dict(case)
    got = grads(lambda *t: tattn.attend_prefill(*t, **kw), (q, k, v), dout)

    def jfn(q, k, v):
        return jnp.sum(jattn.attend_prefill(q, k, v, **kw) * jnp.asarray(dout.numpy()))
    want = jax.grad(jfn, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float((g - torch.from_numpy(w)).abs().max()) <= 2.0 ** -7 * np.abs(w).max()


def scan_inputs(seed, Bt=2, L=9, Dm=24, N=8, h0=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x, dt = f(Bt, L, Dm), torch.nn.functional.softplus(f(Bt, L, Dm))
    A = -torch.exp(f(Dm, N) * 0.5)
    ins = [x, dt, A, f(Bt, L, N), f(Bt, L, N), f(Dm), f(Bt, Dm, N) if h0 else None]
    return ins, f(Bt, L, Dm), f(Bt, Dm, N)


@pytest.mark.parametrize("h0", [True, False])
def test_scan_function_backward_is_the_plain_versions(h0):
    ins, dy, dh = scan_inputs(2, h0=h0)
    wrt = [t for t in ins if t is not None]

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in wrt]
        it = iter(leaves)
        y, h = fn(*[None if t is None else next(it) for t in ins])
        return torch.autograd.grad((y, h), leaves, (dy, dh))
    got = run(lambda *t: ops.mamba_scan(*t))
    want = run(lambda *t: ref.mamba_scan_ref(*t))
    assert len(got) == (7 if h0 else 6)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


def test_scan_refuses_h_out_under_grad():
    ins, _, _ = scan_inputs(3)
    x = ins[0].clone().requires_grad_()
    with pytest.raises(ValueError, match="h_out"):
        ops.mamba_scan(x, *ins[1:], h_out=torch.zeros_like(ins[6]))


@pytest.mark.parametrize("kernel", ["flash_attention", "mamba_scan"])
@pytest.mark.parametrize("grad_enabled, requires_grad, function",
                         [(True, True, True), (True, False, False), (False, True, False)])
def test_wrappers_take_their_function_by_one_rule(kernel, grad_enabled, requires_grad,
                                                  function, monkeypatch):
    """Both wrappers go through their autograd Function exactly when grad
    is enabled and an input requires grad (``ops._differentiable``)."""
    if kernel == "flash_attention":
        ins, fn = list(attn_inputs(4)[:3]), _fa.FlashAttentionFn
    else:
        ins, fn = scan_inputs(4)[0], _ms.MambaScanFn
    applied = []
    apply = fn.apply
    monkeypatch.setattr(fn, "apply", lambda *a: applied.append(1) or apply(*a))
    ins[0] = ins[0].clone().requires_grad_(requires_grad)
    with torch.set_grad_enabled(grad_enabled):
        out = getattr(ops, kernel)(*ins)
    out = out if kernel == "flash_attention" else out[0]
    assert bool(applied) == function
    assert (out.grad_fn is not None) == function


def test_mamba_mix_grads_match_reference():
    """The port's ``mamba_mix`` (conv, projections, ``MambaScanFn``)
    against ``jax.grad`` of the reference's, with a carried state: grads
    for x, every mixer parameter and h0 within 1e-4 of the largest."""
    jcfg = jget_config("falcon_mamba_7b").reduced(dtype="float32")
    cfg = get_config("falcon_mamba_7b").reduced(dtype="float32")
    jp = JModel(jcfg).init_params(jax.random.key(1))
    jmix = jax.tree.map(lambda a: np.asarray(a)[0], jp["stack"]["sub0"]["mix"])
    names = ["conv_w", "conv_b", "w_x_proj", "w_dt", "dt_bias", "A_log", "D"]
    rng = np.random.default_rng(4)
    di, N, K = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_d_conv
    x = rng.standard_normal((B, 16, di)).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32) * 0.1
    conv0 = rng.standard_normal((B, K - 1, di)).astype(np.float32)
    dy = rng.standard_normal((B, 16, di)).astype(np.float32)

    def jfn(x, h0, *ws):
        p = dict(jmix) | dict(zip(names, ws))
        y, h, _ = jmamba.mamba_mix(x, p, jcfg, h0=h0, conv0=jnp.asarray(conv0))
        return jnp.sum(y * dy) + jnp.sum(h)
    want = jax.grad(jfn, argnums=tuple(range(2 + len(names))))(
        jnp.asarray(x), jnp.asarray(h0), *(jnp.asarray(jmix[n]) for n in names))

    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (x, h0, *(jmix[n] for n in names))]
    p = {n: torch.from_numpy(np.asarray(jmix[n]).copy()) for n in jmix} | dict(
        zip(names, leaves[2:]))
    y, h, _ = tmamba.mamba_mix(leaves[0], p, cfg, h0=leaves[1],
                               conv0=torch.from_numpy(conv0))
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + h.sum(), leaves)
    for name, g, w in zip(["x", "h0", *names], got, want):
        w = np.asarray(w)
        assert float((g - torch.from_numpy(w)).abs().max()) <= 1e-4 * np.abs(w).max(), name


# ------------------------------------------------------------------- data
def test_corpus_and_batches_equal_reference():
    for vocab, seed in ((512, 0), (128_256, 3)):
        jc, tc = JCorpus(vocab, seed=seed), SyntheticCorpus(vocab, seed=seed)
        for i in (0, 1, 17, 1_000):
            assert np.array_equal(jc.document(i), tc.document(i))
        jb, tb = JBatcher(jc, 3, 40), PackedBatcher(tc, 3, 40)
        for _ in range(4):
            a, b = jb.next_batch(), tb.next_batch()
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
        assert jb.state_dict() == tb.state_dict()


def test_batcher_state_round_trip():
    corpus = SyntheticCorpus(vocab_size=128, seed=3)
    b1 = PackedBatcher(corpus, batch=2, seq=32)
    for _ in range(3):
        b1.next_batch()
    state = b1.state_dict()
    assert BatcherState.from_dict(state).to_dict() == state
    want = b1.next_batch()
    b2 = PackedBatcher(SyntheticCorpus(vocab_size=128, seed=3), 2, 32)
    b2.load_state_dict(state)
    got = b2.next_batch()
    assert all(np.array_equal(want[k], got[k]) for k in want)


# ------------------------------------------------------------------- MoE gate
@pytest.mark.parametrize("grad_enabled", [False, True])
def test_moe_card_training_needs_a_grouped_mm_backward(grad_enabled, monkeypatch):
    """On a non-CPU tensor the grouped product takes ``GroupedMmFn`` over
    ``torch._grouped_mm``, with grad enabled or not: no raise, no switch
    to the loop ("meta" tensors stand in for the card). Its forward is the
    bare op: on CPU bf16 tensors (torch's own CPU ``_grouped_mm``) the
    Function's output equals the op's bit for bit, and under grad it also
    gives each operand a gradient of its shape and dtype."""
    from repro_torch.models import moe
    applied = []
    apply = moe.GroupedMmFn.apply
    monkeypatch.setattr(moe.GroupedMmFn, "apply", lambda *a: applied.append(1) or apply(*a))
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((8, 128, 64)).astype(np.float32)).bfloat16()
    offs = torch.tensor([5, 5, 20, 33, 33, 40, 51, 64], dtype=torch.int32)
    meta = [t.to("meta").requires_grad_(t.is_floating_point()) for t in (rows, w, offs)]
    with torch.set_grad_enabled(grad_enabled):
        assert moe.grouped_mm(*meta).shape == (64, 64)
        r, ww = rows.clone().requires_grad_(), w.clone().requires_grad_()
        got = moe.GroupedMmFn.apply(r, ww, offs, moe._op_mm)
    assert len(applied) == 2
    assert torch.equal(got, torch._grouped_mm(rows, w, offs=offs))
    assert (got.grad_fn is not None) == grad_enabled
    if grad_enabled:
        grads = torch.autograd.grad(got.float().sum(), (r, ww))
        assert [(g.shape, g.dtype) for g in grads] == [(rows.shape, rows.dtype),
                                                       (w.shape, w.dtype)]
