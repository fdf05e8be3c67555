"""repro_torch's selective scan and Mamba model (ssm family) against the
JAX reference, on the CPU.

The same numpy-seeded inputs go through the reference's Pallas
``mamba_scan`` (interpret mode) and its sequential oracle
``ref.mamba_scan_ref``, and through the port's oracle and ``ops.mamba_scan``,
which takes the plain version for CPU tensors (the CUDA kernel is held
against it on the card by ``chip_smoke.py``). The Mamba block and the
falcon-mamba model run with the reference's parameters carried across.

Tolerances, and why: the scan is fp32 in both packages and the port copies
the reference's block op for op, so they differ only in summation order.
Scans agree within 1e-4 (the reference kernel test's bound). The fp32 model
agrees within FP32_TOL = 1e-4 (prefill and 8 decode steps measured
within 3.6e-6 on logits of magnitude ~3.5, the state within 1.2e-7); the
bf16 model keeps the dense family's 0.15 (measured within 1e-6 on logits,
one bf16 step on the conv tail). Greedy tokens must be equal wherever the
reference's top-2 margin exceeds twice the tolerance.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba_scan  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import mamba_scan as tms  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models.convert import params_from_reference, to_tensor  # noqa: E402
from repro_torch.models.model import padded_vocab  # noqa: E402

ARCH = "falcon_mamba_7b"
ATOL = 1e-4
FP32_TOL = 1e-4
TOL = {"float32": FP32_TOL, "bfloat16": 0.15}


def T(a):
    return to_tensor(np.asarray(a), "cpu")


def F32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _scan_inputs(rng, Bt, L, Dm, N):
    """The reference kernel test's inputs (``tests/test_kernels.py``)."""
    x = (rng.standard_normal((Bt, L, Dm)) * 0.5).astype(np.float32)
    dt = np.abs(rng.standard_normal((Bt, L, Dm))).astype(np.float32) * 0.1
    A = -np.abs(rng.standard_normal((Dm, N))).astype(np.float32)
    B = (rng.standard_normal((Bt, L, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((Bt, L, N)) * 0.5).astype(np.float32)
    D = rng.standard_normal((Dm,)).astype(np.float32)
    return x, dt, A, B, C, D


# ------------------------------------------------------------ the scan (a, b)
@pytest.mark.parametrize("Bt,L,Dm,N,bd,bl", [
    (2, 128, 64, 16, 32, 32), (1, 64, 128, 8, 64, 64), (2, 96, 32, 16, 32, 32),
])
def test_mamba_scan_matches_reference(rng, Bt, L, Dm, N, bd, bl):
    args = _scan_inputs(rng, Bt, L, Dm, N)
    kern_y, kern_h = pallas_mamba_scan(*map(jnp.asarray, args), block_d=bd, block_l=bl,
                                       interpret=True)
    want_y, want_h = jref.mamba_scan_ref(*map(jnp.asarray, args))
    plain_y, plain_h = ref.mamba_scan_ref(*map(T, args))
    got_y, got_h = ops.mamba_scan(*map(T, args))
    assert got_y.dtype == torch.float32 and got_h.shape == (Bt, Dm, N)
    assert torch.equal(got_y, plain_y) and torch.equal(got_h, plain_h)
    for y, h in ((kern_y, kern_h), (want_y, want_h)):
        np.testing.assert_allclose(F32(got_y), F32(y), rtol=ATOL, atol=ATOL)
        np.testing.assert_allclose(F32(got_h), F32(h), rtol=ATOL, atol=ATOL)


def test_mamba_scan_bf16_x_rounds_y_only(rng):
    """bf16 x: y comes back in bf16 (the fp32 result rounded once) and the
    state stays fp32, as in the reference oracle."""
    x, dt, A, B, C, D = _scan_inputs(rng, 2, 40, 64, 8)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_y, want_h = jref.mamba_scan_ref(xb, *map(jnp.asarray, (dt, A, B, C, D)))
    got_y, got_h = ops.mamba_scan(T(xb), *map(T, (dt, A, B, C, D)))
    assert got_y.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    g, w = F32(got_y), F32(want_y)
    assert np.all(np.abs(g - w) <= np.maximum(np.abs(g), np.abs(w)) * 2.0 ** -7 + ATOL)
    np.testing.assert_allclose(F32(got_h), F32(want_h), rtol=ATOL, atol=ATOL)


def test_mamba_scan_initial_state_and_split(rng):
    """With h0 the port matches the reference oracle's h0; two calls over
    the halves of L that carry h give the one call's y and h; h_out may be
    h0 itself (a decode step's in-place update)."""
    x, dt, A, B, C, D = _scan_inputs(rng, 2, 48, 32, 16)
    h0 = (rng.standard_normal((2, 32, 16)) * 0.3).astype(np.float32)
    want_y, want_h = jref.mamba_scan_ref(*map(jnp.asarray, (x, dt, A, B, C, D)),
                                         h0=jnp.asarray(h0))
    got_y, got_h = ops.mamba_scan(*map(T, (x, dt, A, B, C, D)), T(h0))
    np.testing.assert_allclose(F32(got_y), F32(want_y), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(F32(got_h), F32(want_h), rtol=ATOL, atol=ATOL)
    y1, h1 = ops.mamba_scan(*map(T, (x[:, :20], dt[:, :20], A, B[:, :20], C[:, :20], D)),
                            T(h0))
    y2, h2 = ops.mamba_scan(*map(T, (x[:, 20:], dt[:, 20:], A, B[:, 20:], C[:, 20:], D)),
                            h1)
    np.testing.assert_allclose(F32(torch.cat([y1, y2], 1)), F32(got_y), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(F32(h2), F32(got_h), rtol=ATOL, atol=ATOL)
    state, ys = T(h0).clone(), []
    for t in range(x.shape[1]):                  # L = 1 steps, the state in place
        sl = slice(t, t + 1)
        y, h = ops.mamba_scan(*map(T, (x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], D)),
                              state, h_out=state)
        assert h is state
        ys.append(y)
    np.testing.assert_allclose(F32(torch.cat(ys, 1)), F32(got_y), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(F32(state), F32(got_h), rtol=ATOL, atol=ATOL)


def test_mamba_scan_refuses_off_cpu_and_bad_shapes():
    """A tensor that is not on the CPU never takes the plain version (meta
    tensors stand in for a device), and the kernel's limits raise."""
    meta = torch.device("meta")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    with pytest.raises(ValueError):
        tms.mamba_scan(empty(1, 4, 8), empty(1, 4, 8), empty(8, 16), empty(1, 4, 16),
                       empty(1, 4, 16), empty(8))
    with pytest.raises(ValueError):
        ops.mamba_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8), torch.zeros(8, 16),
                       torch.zeros(1, 4, 16), torch.zeros(1, 4, 16), torch.zeros(8),
                       h_out=torch.zeros(1, 8, 8))


def test_ops_mamba_scan_aligns_split_views(rng, monkeypatch):
    """B and C split from one projection at batch 1 are contiguous views at
    an offset; the kernel reads them as float4, so ``ops.mamba_scan`` hands
    the wrapper 16-byte aligned copies, and the result is the reference's."""
    x, dt, A, B, C, D = _scan_inputs(rng, 1, 1, 32, 16)
    proj = T(np.concatenate([rng.standard_normal((1, 1, 1)).astype(np.float32), B, C],
                            axis=-1))
    _, Bv, Cv = proj.split([1, 16, 16], dim=-1)
    assert Bv.is_contiguous() and Bv.data_ptr() % 16 and Cv.data_ptr() % 16
    seen = []
    real = tms.mamba_scan

    def spy(*args, **kw):
        seen.extend(args[2:5])
        return real(*args, **kw)

    monkeypatch.setattr(tms, "mamba_scan", spy)
    got_y, got_h = ops.mamba_scan(T(x), T(dt), T(A), Bv, Cv, T(D))
    assert all(t.data_ptr() % 16 == 0 for t in seen)
    want_y, want_h = jref.mamba_scan_ref(*map(jnp.asarray, (x, dt, A, B, C, D)))
    np.testing.assert_allclose(F32(got_y), F32(want_y), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(F32(got_h), F32(want_h), rtol=ATOL, atol=ATOL)


# ---------------------------------------------------------------- block (c)
def _ref_params(dtype="float32", seed=0, **kw):
    jcfg = jget_config(ARCH).reduced(dtype=dtype, **kw)
    cfg = get_config(ARCH).reduced(dtype=dtype, **kw)
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.key(seed))
    return jcfg, cfg, jm, jp


def _close_tree(got: dict, want: dict, tol):
    for name in want:
        np.testing.assert_allclose(F32(got[name]), F32(want[name]), atol=tol, rtol=0,
                                   err_msg=name)


def test_mamba_mix_and_block_match_reference(rng):
    """mamba_mix and mamba_block with the reference's layer-0 parameters:
    a 24-token prefill from no state, then one decode step from the
    carried state; outputs and the new state compared."""
    jcfg, cfg, _, jp = _ref_params()
    jmix = jax.tree.map(lambda a: a[0], jp["stack"]["sub0"]["mix"])
    tmix = {k: T(v) for k, v in jmix.items()}
    B, L, di, d = 2, 24, cfg.ssm_d_inner, cfg.d_model
    xs = (rng.standard_normal((B, L + 1, di)) * 0.5).astype(np.float32)
    jy, jh, jtail = jmamba.mamba_mix(jnp.asarray(xs[:, :L]), jmix, jcfg)
    ty, th, ttail = tmamba.mamba_mix(T(xs[:, :L]), tmix, cfg)
    _close_tree({"y": ty, "h": th, "conv": ttail}, {"y": jy, "h": jh, "conv": jtail}, ATOL)
    jy, jh, jtail = jmamba.mamba_mix(jnp.asarray(xs[:, L:]), jmix, jcfg, h0=jh, conv0=jtail)
    ty, th, ttail = tmamba.mamba_mix(T(xs[:, L:]), tmix, cfg, h0=th, conv0=ttail)
    _close_tree({"y": ty, "h": th, "conv": ttail}, {"y": jy, "h": jh, "conv": jtail}, ATOL)

    x = (rng.standard_normal((B, L + 1, d)) * 0.5).astype(np.float32)
    jo, jst = jmamba.mamba_block(jnp.asarray(x[:, :L]), jmix, jcfg, state=None)
    to, tst = tmamba.mamba_block(T(x[:, :L]), tmix, cfg)
    _close_tree({"out": to, **tst}, {"out": jo, **jst}, ATOL)
    cache = tmamba.init_mamba_state(cfg, B, torch.float32)
    jo, jst = jmamba.mamba_decode_step(jnp.asarray(x[:, L:]), jmix, jcfg, jst)
    cache["h"].copy_(tst["h"])
    cache["conv"].copy_(tst["conv"])
    h_ptr = cache["h"].data_ptr()
    to, tst = tmamba.mamba_block(T(x[:, L:]), tmix, cfg, state=cache, out_state=cache)
    assert tst is cache and cache["h"].data_ptr() == h_ptr          # in place
    _close_tree({"out": to, **cache}, {"out": jo, **jst}, ATOL)


# ---------------------------------------------------------------- model (d)
def _pair(dtype, seed=0, **kw):
    jcfg, cfg, jm, jp = _ref_params(dtype, seed, **kw)
    tm = Model(cfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jm, jp, tm, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, rng):
    """falcon-mamba reduced: prefill and 8 greedy decode steps against the
    reference Model, logits and the h/conv state cache compared."""
    cfg, jm, jp, tm, tp = _pair(dtype)
    tol, V = TOL[dtype], cfg.vocab_size
    B, S = 2, 16
    toks = rng.integers(1, V, (B, S)).astype(np.int32)
    jl, jc, jk = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, S + 8)
    tl, tc, tk = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, S + 8)
    assert tl.shape == (B, padded_vocab(V)) and bool((tl[:, V:] == -1e30).all())
    assert set(tc) == {"h", "conv"} and tc["h"].dtype == torch.float32
    assert tc["conv"].dtype == tp["embed"].dtype

    def check(jl, jc, tl, tc):
        np.testing.assert_allclose(F32(tl)[:, :V], F32(jl)[:, :V], atol=tol, rtol=0)
        # the reference's (n_groups = L, B, ...) stacks and the port's
        # (L_mamba, B, ...) hold the same layout
        _close_tree(tc, jc["stack"]["sub0"], tol)

    check(jl, jc, tl, tc)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    tok = np.asarray(jnp.argmax(jl[:, :V], -1)).astype(np.int32)
    for _ in range(8):
        jl, jc, jk = jm.decode_step(jp, jc, jnp.asarray(tok), jk)
        tl, tc, tk = tm.decode_step(tp, tc, torch.from_numpy(tok), tk)
        check(jl, jc, tl, tc)
        a, b = F32(jl)[:, :V], F32(tl)[:, :V]
        top2 = np.sort(a, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        assert np.array_equal(b.argmax(1)[clear], a.argmax(1)[clear])
        tok = a.argmax(1).astype(np.int32)
    assert np.array_equal(tk.numpy(), np.asarray(jk))


def test_decode_from_the_reference_state_matches(rng):
    """From the reference's own state cache, one decode step agrees within
    the fp32 tolerance and writes the same new state."""
    cfg, jm, jp, tm, tp = _pair("float32")
    V = cfg.vocab_size
    toks = rng.integers(1, V, (2, 12)).astype(np.int32)
    _, jc, jk = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    cache = {n: to_tensor(jc["stack"]["sub0"][n], "cpu") for n in ("h", "conv")}
    nxt = rng.integers(1, V, 2).astype(np.int32)
    jl, jc2, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), jk)
    tl, cache, _ = tm.decode_step(tp, cache, torch.from_numpy(nxt),
                                  torch.from_numpy(np.array(jk)))
    np.testing.assert_allclose(F32(tl)[:, :V], F32(jl)[:, :V], atol=FP32_TOL, rtol=0)
    _close_tree(cache, jc2["stack"]["sub0"], FP32_TOL)


def test_chunked_prefill_carries_the_state(rng):
    """A prefill in chunks (``prefill_chunk``) carries each layer's state
    from chunk to chunk: the same logits and state as one chunk."""
    cfg, _, _, tm, tp = _pair("float32")
    chunked = Model(get_config(ARCH).reduced(dtype="float32", prefill_chunk=8),
                    device="cpu")
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 24)).astype(np.int32))
    la, ca, _ = tm.prefill(tp, {"tokens": toks}, 24)
    lb, cb, _ = chunked.prefill(tp, {"tokens": toks}, 24)
    np.testing.assert_allclose(F32(lb), F32(la), atol=FP32_TOL, rtol=0)
    _close_tree(cb, ca, FP32_TOL)


# ------------------------------------------------------------ the port (e, f)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_prefill(dtype, rng):
    """Incremental decode of token S-1 == full prefill of S tokens, in the
    port alone (both walk the same sequential scan)."""
    cfg = get_config(ARCH).reduced(dtype=dtype)
    model = Model(cfg, device="cpu")
    params = model.init_params(1)
    B, S, V = 2, 24, cfg.vocab_size
    toks = torch.from_numpy(rng.integers(1, V, (B, S)).astype(np.int32))
    lf, cf, _ = model.prefill(params, {"tokens": toks}, S + 4)
    lp, cache, kvl = model.prefill(params, {"tokens": toks[:, :S - 1]}, S + 4)
    ld, cache, kv2 = model.decode_step(params, cache, toks[:, S - 1], kvl)
    np.testing.assert_allclose(F32(lf)[:, :V], F32(ld)[:, :V], atol=TOL[dtype] / 10)
    _close_tree(cache, cf, TOL[dtype] / 10)
    assert kv2.tolist() == [S, S]


def test_init_params_follow_the_reference():
    """The seeded init draws the reference's shapes, dtypes and scales."""
    cfg = get_config(ARCH).reduced()
    jp = JModel(jget_config(ARCH).reduced()).param_shapes()
    tp = Model(cfg, device="cpu").init_params(0)
    assert tuple(tp["head"].shape) == jp["head"].shape
    assert len(tp["layers"]) == cfg.n_layers
    ref_sub = jp["stack"]["sub0"]
    for layer in tp["layers"]:
        assert set(layer) == set(ref_sub) == {"ln_mix", "mix"}
        for name, leaf in ref_sub["mix"].items():
            got = layer["mix"][name]
            assert tuple(got.shape) == leaf.shape[1:], name
            assert str(got.dtype).split(".")[1] == str(leaf.dtype), name
    mix = tp["layers"][0]["mix"]
    d, di = cfg.d_model, cfg.ssm_d_inner
    assert abs(float(mix["w_in"].float().std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(mix["conv_w"].float().std()) - 0.2) < 0.02
    assert abs(float(mix["w_out"].float().std()) - di ** -0.5) < 0.1 * di ** -0.5
    dt0 = torch.nn.functional.softplus(mix["dt_bias"])
    assert bool(((dt0 >= 1e-3 * 0.999) & (dt0 <= 0.1 * 1.001)).all())
    A = -torch.exp(mix["A_log"])
    assert bool(((A <= -0.5 * 0.999) & (A >= -16 * 1.001)).all())
    assert float(A.max() - A.min()) > 10                # spread over [-16, -0.5]
    assert torch.equal(mix["D"], torch.ones(di)) and not mix["conv_b"].any()


def test_params_from_reference_carries_the_mamba_leaves():
    """Every leaf of the reference's falcon-mamba init arrives bit for bit,
    one dict per layer."""
    jcfg, cfg, _, jp = _ref_params("bfloat16", seed=4)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    sub = jp["stack"]["sub0"]
    for i, layer in enumerate(tp["layers"]):
        assert F32(layer["ln_mix"]).tobytes() == F32(sub["ln_mix"][i]).tobytes()
        for name, leaf in sub["mix"].items():
            got, want = layer["mix"][name], np.asarray(leaf[i])
            assert str(got.dtype).split(".")[1] == str(want.dtype), name
            assert np.array_equal(F32(got), want.astype(np.float32)), name
