"""repro_torch's encoder-decoder (whisper) and VLM (llava) families
against the JAX reference, on the CPU.

The reduced whisper-large-v3 (2 encoder and 4 decoder layers, 16 frames of
48) and llava-next-mistral-7b (8 patches prepended to the text) carry the
reference's random-init parameters across
(``models.convert.params_from_reference``) and both packages run the same
numpy-seeded tokens, audio and patches.

Tolerance, and why (as ``test_torch_models.py``): the reference's
``attend_prefill`` rounds the softmax probabilities to bf16 before P·V,
the port's CPU path keeps them in fp32. Whisper's encoder attends with
that rounding too, so the encoder output and the cross K/V already differ
by ~2e-3 (fp32) and ~3e-2 (bf16); the tests allow 2e-2 and 0.15. The
reference scans the encoder's queries in chunks of 250 (1,500 frames at
full size) where the port makes one call: that changes rounding only.

Where trouble is likely, each pinned here:
- the reference's whisper encoder is roped (its config is "dense") on top
  of the additive sinusoid, and the decoder is not: a port encoder without
  RoPE falls outside the tolerance;
- a VLM cache sized without the patches has no room to decode: the port
  raises where the reference drops the new K/V silently;
- a decode step's cross-attention is ``flash_attention`` with Sq = 1, not
  ``decode_attention``, as the reference calls ``attend_prefill`` there.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.model import _sinusoid_at as j_sinusoid_at  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import _sinusoid_at, padded_vocab  # noqa: E402

ARCHS = ["whisper_large_v3", "llava_next_mistral_7b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-2, "bfloat16": 0.15}
B, T, STEPS = 2, 12, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs: its many small CPU
    ops under pytest-xdist (a worker per core) with torch's default pool
    in every worker oversubscribe the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def _pair(arch, dtype):
    """(cfg, reference model, its params, port model, port params), built
    once per module for each (arch, dtype)."""
    if (arch, dtype) not in _PAIRS:
        jcfg = jget_config(arch).reduced(dtype=dtype)
        cfg = get_config(arch).reduced(dtype=dtype)
        jm = JModel(jcfg)
        jp = jm.init_params(jax.random.key(0))
        tm = Model(cfg, device="cpu")
        tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
        _PAIRS[arch, dtype] = (cfg, jm, jp, tm, tp)
    return _PAIRS[arch, dtype]


def _batches(cfg, seed=0):
    """The same numpy-seeded tokens and audio / patches for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    key, shape = (("audio", (B, cfg.enc_ctx, cfg.enc_dim)) if cfg.family == "encdec"
                  else ("patches", (B, cfg.n_patches, cfg.d_model)))
    extra = rng.standard_normal(shape).astype(np.float32)
    jb[key], tb[key] = jnp.asarray(extra), torch.from_numpy(extra)
    return jb, tb


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0)


def test_sinusoid_matches_reference():
    """Whisper's absolute positions, fp32, up to the encoder's 1,500 frames
    and a decode step's kv_len. The two packages' fp32 ``pow`` differ by
    one ulp in a few frequencies, which moves an angle by up to 1,500 x
    2^-23: within 2e-4 at position 1,500, within 1e-5 below 64."""
    pos = np.array([0, 1, 7, 63, 448, 1499, 1500], np.int32)
    want = np.asarray(j_sinusoid_at(jnp.asarray(pos), 1280))
    got = _sinusoid_at(torch.from_numpy(pos), 1280)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got[:4], want[:4], 1e-5)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_matches_reference(dtype):
    cfg, jm, jp, tm, tp = _pair("whisper_large_v3", dtype)
    jb, tb = _batches(cfg)
    want = jm._encode(jp, jb["audio"])
    got = tm._encode(tp, tb["audio"])
    assert got.dtype == tm.init_cache(1, 1)["k"].dtype
    assert tuple(got.shape) == (B, cfg.enc_ctx, cfg.d_model)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kv_matches_reference(dtype):
    """Each decoder layer's cross K/V, written into the cache by prefill,
    against the reference's ``_cross_kv`` (group-stacked (G, B, C, Hkv,
    dh): one group per layer)."""
    cfg, jm, jp, tm, tp = _pair("whisper_large_v3", dtype)
    jb, tb = _batches(cfg)
    want = jm._cross_kv(jp, jm._encode(jp, jb["audio"]))
    _, cache, _ = tm.prefill(tp, tb, T + STEPS)
    for name, ref in (("ck", want["k"]), ("cv", want["v"])):
        assert tuple(cache[name].shape) == (cfg.n_layers, B, cfg.enc_ctx,
                                            cfg.n_kv_heads, cfg.head_dim)
        for layer in range(cfg.n_layers):
            _close(cache[name][layer], ref[layer], TOL[dtype])


def _greedy_agree(got, want, tol):
    a, b = _f32(want), _f32(got)
    np.testing.assert_allclose(b, a, atol=tol, rtol=0)
    top2 = np.sort(a, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert np.array_equal(b.argmax(1)[clear], a.argmax(1)[clear])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits, the self K/V cache, kv_len (P + T for llava), then 8
    decode steps fed the reference's tokens: logits within the tolerance,
    greedy tokens equal wherever the reference's top-2 margin exceeds
    twice it."""
    cfg, jm, jp, tm, tp = _pair(arch, dtype)
    tol, V, P = TOL[dtype], cfg.vocab_size, cfg.n_patches
    jb, tb = _batches(cfg)
    max_len = P + T + STEPS
    jl, jc, jk = jm.prefill(jp, jb, max_len)
    tl, tc, tk = tm.prefill(tp, tb, max_len)
    assert tl.shape == (B, padded_vocab(V)) and tl.dtype == torch.float32
    assert bool((tl[:, V:] == -1e30).all())
    _greedy_agree(tl[:, :V], jl[:, :V], tol)
    assert tk.tolist() == np.asarray(jk).tolist() == [P + T] * B
    for name in ("k", "v"):
        ref = _f32(jc["stack"]["sub0"][name])
        assert tuple(tc[name].shape) == ref.shape
        _close(tc[name], ref, tol)
        # layer 0 holds projections of the inputs alone: no attention yet
        _close(tc[name][0], ref[0], 1e-5 if dtype == "float32" else 2e-2)
    tok = np.asarray(jnp.argmax(jl[:, :V], -1)).astype(np.int32)
    for _ in range(STEPS):
        jl, jc, jk = jm.decode_step(jp, jc, jnp.asarray(tok), jk)
        tl, tc, tk = tm.decode_step(tp, tc, torch.from_numpy(tok), tk)
        _greedy_agree(tl[:, :V], jl[:, :V], tol)
        tok = np.asarray(jnp.argmax(jl[:, :V], -1)).astype(np.int32)
    assert tk.tolist() == np.asarray(jk).tolist() == [max_len] * B


class _UnropedEncoder(Model):
    """A port whisper whose encoder drops RoPE: its config's family is the
    decoder's (encdec), so ``attn_sublayer`` takes no theta."""

    def _enc_cfg(self):
        return dataclasses.replace(super()._enc_cfg(), family="encdec")


def test_encoder_must_be_roped():
    """The reference's encoder is roped on top of its sinusoid: the port's
    encoder is within the tolerance of it, an encoder without RoPE is not
    (nor are its prefill logits)."""
    cfg, jm, jp, tm, tp = _pair("whisper_large_v3", "float32")
    tol = TOL["float32"]
    jb, tb = _batches(cfg)
    want = _f32(jm._encode(jp, jb["audio"]))
    unroped = _UnropedEncoder(cfg, device="cpu")
    assert np.abs(_f32(tm._encode(tp, tb["audio"])) - want).max() <= tol
    assert np.abs(_f32(unroped._encode(tp, tb["audio"])) - want).max() > 10 * tol
    jl, _, _ = jm.prefill(jp, jb, T + 1)
    ul, _, _ = unroped.prefill(tp, tb, T + 1)
    V = cfg.vocab_size
    assert np.abs(_f32(ul)[:, :V] - _f32(jl)[:, :V]).max() > tol


@pytest.mark.parametrize("arch,key", [("whisper_large_v3", "audio"),
                                      ("llava_next_mistral_7b", "patches")])
def test_missing_family_input_raises(arch, key):
    """A batch without the audio or the patches raises ValueError naming
    it (the reference raises KeyError)."""
    cfg, jm, jp, tm, tp = _pair(arch, "float32")
    jb, tb = _batches(cfg)
    del jb[key], tb[key]
    with pytest.raises(KeyError):
        jm.prefill(jp, jb, T + 4)
    with pytest.raises(ValueError, match=key):
        tm.prefill(tp, tb, T + 4)


def test_vlm_decode_past_the_cache_raises():
    """The cache holds max(max_len, P + T) positions. With max_len = T (the
    patches left out) prefill still fits, but a decode step has no room:
    the port raises where the reference's ``.at[bidx, kv_len].set`` drops
    the new K/V out of bounds. With room for one step, the second raises."""
    cfg, jm, jp, tm, tp = _pair("llava_next_mistral_7b", "float32")
    P = cfg.n_patches
    _, tb = _batches(cfg)
    tok = torch.ones(B, dtype=torch.int32)
    logits, cache, kv_len = tm.prefill(tp, tb, T)
    assert cache["k"].shape[2] == P + T and kv_len.tolist() == [P + T] * B
    with pytest.raises(ValueError, match="cache length"):
        tm.decode_step(tp, cache, tok, kv_len)
    _, cache, kv_len = tm.prefill(tp, tb, P + T + 1)
    _, cache, kv_len = tm.decode_step(tp, cache, tok, kv_len)
    with pytest.raises(ValueError, match="cache length"):
        tm.decode_step(tp, cache, tok, kv_len)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Decode of token T-1 after a prefill of T-1 tokens equals the prefill
    of all T, in the port alone (bf16, its own seeded weights)."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(1)
    _, tb = _batches(cfg, seed=3)
    head = dict(tb, tokens=tb["tokens"][:, :T - 1])
    lf, _, _ = model.prefill(params, tb, cfg.n_patches + T + 4)
    lp, cache, kvl = model.prefill(params, head, cfg.n_patches + T + 4)
    ld, _, kv2 = model.decode_step(params, cache, tb["tokens"][:, T - 1], kvl)
    V = cfg.vocab_size
    np.testing.assert_allclose(_f32(ld)[:, :V], _f32(lf)[:, :V], atol=5e-2)
    assert kv2.tolist() == [cfg.n_patches + T] * B


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_takes_the_family_input(arch):
    """The engine's greedy generation (``serving.engine.generate``, eager on
    the CPU) given the audio or the patches beside the tokens gives the
    tokens of the plain loop over ``prefill`` and ``decode_step``, starts
    decoding at kv_len P + T, and reports every logit finite."""
    from repro_torch.core.graphs import CapturedProgram
    from repro_torch.serving.engine import generate
    cfg, _, _, tm, tp = _pair(arch, "float32")
    _, tb = _batches(cfg, seed=5)
    P, V, new = cfg.n_patches, cfg.vocab_size, 4
    batch = dict(tb, tokens=tb["tokens"].numpy())
    state = generate(CapturedProgram("cpu"), tm, tp, batch, P + T + new, new, finite=True)
    logits, cache, kv_len = tm.prefill(tp, tb, P + T + new)
    want = []
    for step in range(new):
        want.append(logits[:, :V].argmax(-1).to(torch.int32))
        if step < new - 1:
            logits, cache, kv_len = tm.decode_step(tp, cache, want[-1], kv_len)
    assert torch.equal(state["out"], torch.stack(want, dim=1))
    assert state["start"].tolist() == [P + T] * B
    assert bool(state["finite"])


class _Calls:
    """Records the attention wrappers' calls: (name, Sq, causal)."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("flash_attention", "decode_attention"):
            orig = getattr(ops, name)

            def wrapped(q, *a, _name=name, _orig=orig, **kw):
                sq = q.shape[2] if _name == "flash_attention" else 1
                self.calls.append((_name, sq, kw.get("causal")))
                return _orig(q, *a, **kw)
            monkeypatch.setattr(ops, name, wrapped)

    def take(self):
        out, self.calls = self.calls, []
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_calls_per_prefill_and_decode_step(arch, monkeypatch):
    """Whisper's prefill calls flash_attention once per encoder layer
    (non-causal over the frames), once per decoder layer for self-attention
    (causal) and once for cross-attention (non-causal, T queries); a decode
    step calls flash_attention once per layer with Sq = 1 (cross) and
    decode_attention once per layer (self). Llava: flash_attention once per
    layer of a prefill over P + T, decode_attention once per layer of a
    step."""
    cfg, _, _, tm, tp = _pair(arch, "float32")
    _, tb = _batches(cfg)
    calls = _Calls(monkeypatch)
    L, P = cfg.n_layers, cfg.n_patches
    _, cache, kv_len = tm.prefill(tp, tb, P + T + 2)
    got = calls.take()
    if arch == "whisper_large_v3":
        want = ([("flash_attention", cfg.enc_ctx, False)] * cfg.enc_layers
                + [("flash_attention", T, True), ("flash_attention", T, False)] * L)
    else:
        want = [("flash_attention", P + T, True)] * L
    assert got == want
    tm.decode_step(tp, cache, torch.ones(B, dtype=torch.int32), kv_len)
    got = calls.take()
    if arch == "whisper_large_v3":
        want = [("decode_attention", 1, None), ("flash_attention", 1, False)] * L
    else:
        want = [("decode_attention", 1, None)] * L
    assert got == want


def test_decode_writes_the_cache_in_place():
    """A decode step reads the cross K/V that prefill wrote and writes the
    self K/V in place: every cache tensor keeps its storage (a captured
    decode step reads them at fixed addresses), and the cross K/V do not
    change."""
    cfg, _, _, tm, tp = _pair("whisper_large_v3", "float32")
    _, tb = _batches(cfg)
    _, cache, kv_len = tm.prefill(tp, tb, T + 2)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    cross = {k: cache[k].clone() for k in ("ck", "cv")}
    k_before = cache["k"].clone()
    _, cache2, _ = tm.decode_step(tp, cache, torch.ones(B, dtype=torch.int32), kv_len)
    assert cache2 is cache and {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert all(torch.equal(cache[k], cross[k]) for k in cross)
    assert not torch.equal(cache["k"][:, :, T], k_before[:, :, T])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _same_bits(got: torch.Tensor, want: np.ndarray) -> bool:
    """Equal dtype and bits (bf16 compared as int16)."""
    if str(got.dtype)[6:] != want.dtype.name:
        return False
    if want.dtype.name == "bfloat16":
        return np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    return np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_carries_every_leaf(arch, dtype):
    """Every leaf of the reference's tree, ``enc.*`` and ``cross.*``
    included, lands in the port's params bit for bit, dtype included:
    group g's sub i of a stack is layer g·n_sub + i."""
    cfg, _, jp, _, tp = _pair(arch, dtype)
    ref = dict(_leaves(jax.tree.map(np.asarray, jp)))
    for path, leaf in ref.items():
        parts = path.split(".")
        if "stack" not in parts:
            node = tp
            for part in parts:
                node = node[part]
            assert _same_bits(node, leaf), path
            continue
        at = parts.index("stack")
        owner, groups = tp, jp
        for part in parts[:at]:
            owner, groups = owner[part], groups[part]
        n_sub, sub = len(groups["stack"]), int(parts[at + 1][3:])
        for g in range(leaf.shape[0]):
            node = owner["layers"][g * n_sub + sub]
            for part in parts[at + 2:]:
                node = node[part]
            assert _same_bits(node, leaf[g]), f"{path}[{g}]"
    n_port = sum(1 for _ in _leaves({k: v for k, v in tp.items() if k != "layers"
                                     and k != "enc"}))
    n_port += sum(1 for layer in tp["layers"] for _ in _leaves(layer))
    if "enc" in tp:
        n_port += 2 + sum(1 for layer in tp["enc"]["layers"] for _ in _leaves(layer))
    n_ref = sum(leaf.shape[0] if "stack" in p.split(".") else 1 for p, leaf in ref.items())
    assert n_port == n_ref
    if arch == "whisper_large_v3":
        assert {"enc.proj", "enc.final_norm", "enc.stack.sub0.mix.wq",
                "stack.sub0.ln_cross", "stack.sub0.cross.wk"} <= set(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_follow_the_reference(arch):
    """The seeded init draws the reference's shapes and dtypes, the
    encoder's and the cross-attention's too (full width: shapes only, on
    the reference's side by ``eval_shape``)."""
    cfg = get_config(arch).reduced()
    jshapes = JModel(jget_config(arch).reduced()).param_shapes()
    tp = Model(cfg, device="cpu").init_params(0)
    for path, leaf in _leaves(jshapes):
        parts = path.split(".")
        node = tp
        if "stack" in parts:
            at = parts.index("stack")
            for part in parts[:at]:
                node = node[part]
            assert len(node["layers"]) == leaf.shape[0]
            node = node["layers"][0]
            for part in parts[at + 2:]:
                node = node[part]
            shape = leaf.shape[1:]
        else:
            for part in parts:
                node = node[part]
            shape = leaf.shape
        assert tuple(node.shape) == shape, path
        assert str(node.dtype)[6:] == leaf.dtype.name, path


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-mistral-7b"])
def test_full_width_cache_shapes(arch):
    """At full width, on the meta device: whisper's cross K/V (32, B,
    1,500, 20, 64) beside the self K/V, and llava's self K/V sized for its
    2,880 patches, the prompt and the new tokens."""
    cfg = get_config(arch)
    S = cfg.n_patches + 64 + 16
    cache = tf.init_cache(cfg, 8, S, "meta")
    assert tuple(cache["k"].shape) == (cfg.n_layers, 8, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.family == "encdec":
        assert tuple(cache["ck"].shape) == (32, 8, 1500, 20, 64) == tuple(cache["cv"].shape)
    else:
        assert set(cache) == {"k", "v"} and S == 2960


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-mistral-7b"])
def test_cli_refuses_cleanly(arch, monkeypatch):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced`` fails
    at its first miss batch with a ValueError naming the missing input, as
    the reference's CLI fails (KeyError): the engine passes tokens alone."""
    import repro.launch.serve as jserve

    import repro_torch.launch.serve as tserve
    args = ["serve", "--arch", arch, "--reduced", "--requests", "16"]
    monkeypatch.setattr("sys.argv", args)
    with pytest.raises(KeyError):
        jserve.main()
    monkeypatch.setattr("sys.argv", args + ["--device", "cpu"])
    key = "audio" if arch.startswith("whisper") else "patches"
    with pytest.raises(ValueError, match=key):
        tserve.main()
