"""repro_torch's AdamW against the JAX reference, on the CPU.

Both sides take the same parameters and the same numpy gradients for 5
steps (a train loop cannot be compared this tightly: where v is tiny,
Adam's m/√v is close to sign(g), so a rounding difference in a gradient
flips a whole step). Tolerances, each from the state's type: fp32
parameters and moments within 1e-6 relative plus 1e-6 of the leaf's
largest magnitude (a few fp32 ulps: XLA may fuse b1·m + (1-b1)·g, and
``exp2`` / ``cos`` / ``pow`` differ by an ulp between the libraries); bf16
moments within one bf16 step (2^-8 relative); int8 moments within one
quantization step of their block (its scale, or for the log-domain v
one step of span/254 in log2), and parameters within lr/127 for every
step taken (a moment one quantization step off moves an update of size
≈ lr by about 1/127 of it).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.optim.adamw as jadamw  # noqa: E402

import repro_torch.optim.adamw as tadamw  # noqa: E402
from repro_torch.optim import AdamWConfig, apply_adamw, global_norm, init_opt_state  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (see
    ``tests/test_torch_shard.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = {"w": (8, 256), "b": (256,), "odd": (4, 100), "scale": (), "stack": (2, 3, 128)}
STEPS = 5


def params_np(rng):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def grads_np(rng, step):
    # a spread of magnitudes, a few tiny, so v spans decades
    return {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 0, s)).astype(np.float32)
            * (3.0 if step == 2 else 1.0) for k, s in SHAPES.items()}


def to_t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def moment_f32(mo, read):
    return np.asarray(read(mo), np.float32)


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_apply_adamw_matches_reference(state_dtype):
    rng = np.random.default_rng(0)
    p0 = params_np(rng)
    cfg_kw = dict(lr=1e-2, state_dtype=state_dtype, warmup_steps=2, total_steps=10,
                  clip_norm=1.0)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = to_t(p0)
    jst, tst = jadamw.init_opt_state(jp, jcfg), init_opt_state(tp, tcfg)
    for step in range(STEPS):
        g = grads_np(rng, step)
        jp, jst, jmet = jadamw.apply_adamw(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                           jst, jcfg)
        tmet = apply_adamw(tp, to_t(g), tst, tcfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for k in SHAPES:
            tol = dict(rtol=1e-6, atol=1e-6 * np.abs(p0[k]).max()) \
                if state_dtype != "int8" else dict(rtol=0, atol=(step + 1) * cfg_kw["lr"] / 127)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **tol, err_msg=k)
            for name in ("m", "v"):
                tm, jm = tst[name][k], jst[name][k]
                got = moment_f32(tm, tadamw.moment_read)
                want = moment_f32(jm, jadamw._moment_read)
                assert (tm["s"] is None) == (jm["s"] is None), (k, name)
                if state_dtype == "fp32" or tm["s"] is None:
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-6 * np.abs(want).max(),
                                               err_msg=str((k, name)))
                elif state_dtype == "bf16":
                    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)
                elif name == "m":       # linear: one step of the block's scale
                    step_ = np.repeat(np.asarray(jm["s"]), tadamw.QBLOCK, axis=-1)
                    assert np.all(np.abs(got - want) <= step_ * 1.0001 + 1e-12), (k, name)
                else:                   # log2 domain: one step of span / 254
                    span = np.repeat(np.asarray(jm["s"])[..., 1], tadamw.QBLOCK, axis=-1)
                    lg = np.abs(np.log2(got + 1e-24) - np.log2(want + 1e-24))
                    assert np.all(lg <= span / 254.0 * 1.0001 + 1e-6), (k, name)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), AdamWConfig(**kw)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(jcfg.lr_at(jnp.asarray(s, jnp.int32)))
        got = float(tcfg.lr_at(torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=0), s


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_round_trips_match_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 256)) * 10.0 ** rng.uniform(-6, 1, (3, 256))
         ).astype(np.float32)
    v = np.abs(x) ** 2
    jq, js = jadamw._quantize(jnp.asarray(x))
    tq, ts = tadamw._quantize(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(tadamw._dequantize(tq, ts).numpy(),
                               np.asarray(jadamw._dequantize(jq, js)), rtol=1e-6)
    jq, js = jadamw._quantize_log(jnp.asarray(v))
    tq, ts = tadamw._quantize_log(torch.from_numpy(v))
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tadamw._dequantize_log(tq, ts).numpy(),
                               np.asarray(jadamw._dequantize_log(jq, js)), rtol=1e-5)


def test_init_state_layout_matches_reference():
    rng = np.random.default_rng(2)
    p0 = params_np(rng)
    for dt in ("fp32", "bf16", "int8"):
        jst = jadamw.init_opt_state({k: jnp.asarray(v) for k, v in p0.items()},
                                    jadamw.AdamWConfig(state_dtype=dt))
        tst = init_opt_state(to_t(p0), AdamWConfig(state_dtype=dt))
        for name in ("m", "v"):
            for k in SHAPES:
                for part in ("q", "s"):
                    a, b = tst[name][k][part], jst[name][k][part]
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert str(a.dtype).removeprefix("torch.") == np.asarray(b).dtype.name
                        np.testing.assert_array_equal(a.float().numpy(),
                                                      np.asarray(b, np.float32))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    g = params_np(rng)
    np.testing.assert_allclose(float(global_norm(to_t(g))),
                               float(jadamw.global_norm({k: jnp.asarray(v)
                                                         for k, v in g.items()})),
                               rtol=1e-6)


# The reference's two AdamW cases in tests/test_system.py, mirrored.
def test_adamw_moves_params_and_clips(rng):
    params = {"w": torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))}
    before = params["w"].clone()
    grads = {"w": torch.full((8, 128), 100.0)}          # huge → clipped
    cfg = AdamWConfig(lr=1e-2, clip_norm=1.0)
    st = init_opt_state(params, cfg)
    met = apply_adamw(params, grads, st, cfg)
    assert float(met["grad_norm"]) > 1.0
    assert not np.allclose(params["w"].numpy(), before.numpy())
    assert int(st["step"]) == 1


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_adamw_state_dtypes_converge(rng, state_dtype):
    """Quantized moments still optimize a quadratic."""
    target = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    params = {"w": torch.zeros((4, 128))}
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, state_dtype=state_dtype,
                      schedule="constant", warmup_steps=1)
    st = init_opt_state(params, cfg)
    for _ in range(200):
        apply_adamw(params, {"w": params["w"] - target}, st, cfg)
    err = float((params["w"] - target).abs().mean())
    assert err < 0.15, err


def test_bf16_params_update_in_place():
    """A bf16 leaf is updated in place (same storage), from an fp32 update
    of its fp32 value, as the reference's ``astype`` round trip."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32)).to(torch.bfloat16)
    ptr = w.data_ptr()
    params, grads = {"w": w}, {"w": torch.ones((4, 128), dtype=torch.bfloat16)}
    jp = {"w": jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)}
    cfg_kw = dict(lr=1e-2, warmup_steps=1)
    apply_adamw(params, grads, init_opt_state(params, AdamWConfig(**cfg_kw)),
                AdamWConfig(**cfg_kw))
    jp, _, _ = jadamw.apply_adamw(jp, {"w": jnp.ones((4, 128), jnp.bfloat16)},
                                  jadamw.init_opt_state(jp, jadamw.AdamWConfig(**cfg_kw)),
                                  jadamw.AdamWConfig(**cfg_kw))
    assert params["w"].data_ptr() == ptr and params["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["w"].float().numpy(),
                                  np.asarray(jp["w"], np.float32))
