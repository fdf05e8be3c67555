"""repro_torch's attention kernels against the JAX reference, on the CPU.

The same numpy-seeded inputs go through the reference's Pallas kernels
(``flash_attention`` / ``decode_attention`` in interpret mode) and its
oracles (``ref.attention_ref`` / ``ref.decode_attention_ref``), and through
the port's plain versions and ``ops`` wrappers, which take the plain path
for CPU tensors. Tolerances: fp32 1e-5 (the two sum in other orders); bf16
outputs are the same fp32 values rounded to bf16, so they may differ by one
bf16 step, 2^-7 of the magnitude. The CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402

from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ATOL = 1e-5


def T(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def F32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, bf16: bool):
    g, w = F32(got), F32(want)
    tol = (np.maximum(np.abs(g), np.abs(w)) * 2.0 ** -7 + ATOL) if bf16 else ATOL
    assert np.all(np.abs(g - w) <= tol), float(np.abs(g - w).max())


def _qkv(rng, B, Hq, Hkv, Sq, Skv, dh, dtype):
    q = (rng.standard_normal((B, Hq, Sq, dh)) * 0.3).astype(dtype)
    k = (rng.standard_normal((B, Hkv, Skv, dh)) * 0.3).astype(dtype)
    v = (rng.standard_normal((B, Hkv, Skv, dh)) * 0.3).astype(dtype)
    return q, k, v


# --------------------------------------------------------- flash_attention
@pytest.mark.parametrize("kwargs", [
    dict(causal=True), dict(causal=False),
    dict(causal=True, window=96), dict(causal=True, softcap=30.0),
    dict(causal=True, kv_offset=64),
])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_flash_attention_parity(rng, kwargs, dtype):
    """The sweep of the reference's kernel test (test_kernels.py): causal,
    window, softcap, kv_offset, GQA (Hq=4 over Hkv=2)."""
    B, Hq, Hkv, Sq, Skv, dh = 2, 4, 2, 128, 192, 64
    if kwargs.get("kv_offset"):
        Skv = Sq + kwargs["kv_offset"]
    q, k, v = _qkv(rng, B, Hq, Hkv, Sq, Skv, dh, dtype)
    bf16 = dtype == jnp.bfloat16
    kern = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        block_q=64, block_k=64, interpret=True, **kwargs)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs)
    plain = tfa.flash_attention_plain(T(q), T(k), T(v), **kwargs)
    got = ops.flash_attention(T(q), T(k), T(v), **kwargs)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert torch.equal(got, plain)          # a CPU tensor takes the plain version
    _close(got, kern, bf16)
    _close(got, want, bf16)


@pytest.mark.parametrize("Hq,Hkv,Sq,Skv", [(6, 2, 40, 40), (3, 3, 17, 50), (8, 1, 1, 33)])
def test_flash_attention_ragged_shapes_and_groups(rng, Hq, Hkv, Sq, Skv):
    """Shapes off every tile grid and group sizes 3, 1 and 8, causal with
    the query block at the end of the keys, against the oracle."""
    q, k, v = _qkv(rng, 2, Hq, Hkv, Sq, Skv, 32, np.float32)
    off = Skv - Sq
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, kv_offset=off)
    _close(ops.flash_attention(T(q), T(k), T(v), causal=True, kv_offset=off), want, False)


def test_flash_attention_non_causal_edge_is_masked_not_padded(rng):
    """Contract note: the reference's ops wrapper pads Skv to its tile with
    zero keys, and a non-causal call attends to them (softmax mass on
    score 0), so it departs from ``attention_ref``. The port masks the edge
    in the kernel: it matches the oracle."""
    q, k, v = _qkv(rng, 1, 2, 2, 64, 100, 32, np.float32)
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=False))
    padded = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=False, block_q=64, block_k=64))
    assert np.abs(padded - want).max() > 1e-3          # the reference's padding keys
    _close(ops.flash_attention(T(q), T(k), T(v), causal=False), want, False)


# -------------------------------------------------------- decode_attention
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_decode_attention_parity(rng, softcap, dtype):
    B, Hq, Hkv, S, dh = 3, 4, 2, 256, 64
    q = (rng.standard_normal((B, Hq, dh)) * 0.3).astype(dtype)
    k = (rng.standard_normal((B, Hkv, S, dh)) * 0.3).astype(dtype)
    v = (rng.standard_normal((B, Hkv, S, dh)) * 0.3).astype(dtype)
    lens = np.array([256, 100, 7], np.int32)
    bf16 = dtype == jnp.bfloat16
    kern = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                         softcap=softcap, block_k=64, interpret=True)
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     kv_len=jnp.asarray(lens), softcap=softcap)
    got = ops.decode_attention(T(q), T(k), T(v), T(lens), softcap=softcap)
    assert torch.equal(got, tda.decode_attention_plain(T(q), T(k), T(v), kv_len=T(lens),
                                                       softcap=softcap))
    _close(got, kern, bf16)
    _close(got, want, bf16)


def _windowed_oracle(q, k, v, lens, window, softcap):
    """The reference oracle under the reference model's window mask
    (``repro/models/attention.py:145-147``): sequence b sees rows
    [max(0, len - window), len), so the oracle runs on that slice alone."""
    outs = []
    for b, n in enumerate(lens):
        lo = max(0, int(n) - window)
        outs.append(np.asarray(jref.decode_attention_ref(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1, :, lo:]),
            jnp.asarray(v[b:b + 1, :, lo:]), kv_len=jnp.asarray([int(n) - lo]),
            softcap=softcap)))
    return np.concatenate(outs)


@pytest.mark.parametrize("window", [1, 48, 300])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_decode_attention_window(rng, window, softcap, dtype):
    """A sliding window keeps rows (len - 1) - window < j < len: the port's
    plain version and ops wrapper against the reference oracle on the
    window's rows, and against the reference model's ``attend_decode``."""
    from repro.models.attention import attend_decode as jattend_decode
    B, Hq, Hkv, S, dh = 4, 4, 2, 256, 64
    q = (rng.standard_normal((B, Hq, dh)) * 0.3).astype(dtype)
    k = (rng.standard_normal((B, Hkv, S, dh)) * 0.3).astype(dtype)
    v = (rng.standard_normal((B, Hkv, S, dh)) * 0.3).astype(dtype)
    lens = np.array([256, 100, 30, 1], np.int32)
    bf16 = dtype == jnp.bfloat16
    got = ops.decode_attention(T(q), T(k), T(v), T(lens), softcap=softcap, window=window)
    assert torch.equal(got, tda.decode_attention_plain(T(q), T(k), T(v), kv_len=T(lens),
                                                       softcap=softcap, window=window))
    _close(got, _windowed_oracle(q, k, v, lens, window, softcap).astype(dtype), bf16)
    model = jattend_decode(jnp.asarray(q), jnp.asarray(k).swapaxes(1, 2),
                           jnp.asarray(v).swapaxes(1, 2), jnp.asarray(lens),
                           window=window, softcap=softcap)
    _close(got, model, bf16)
    if window < S:                              # the window bites on the full row
        full = ops.decode_attention(T(q), T(k), T(v), T(lens), softcap=softcap)
        assert F32(full - got)[0].std() > 1e-3


def test_decode_attention_window_never_reads_outside(rng):
    """Rows before the window count no more than rows past kv_len: garbage
    there does not leak in, and kv_len 0 still gives 0."""
    B, Hq, Hkv, S, dh = 3, 2, 2, 128, 32
    q = rng.standard_normal((B, Hq, dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, dh)).astype(np.float32)
    lens = np.array([128, 70, 0], np.int32)
    got = ops.decode_attention(T(q), T(k), T(v), T(lens), window=16)
    k2, v2 = k.copy(), v.copy()
    k2[0, :, :112], v2[1, :, :54] = 1e4, -1e4
    k2[1, :, 70:] = 1e4
    _close(ops.decode_attention(T(q), T(k2), T(v2), T(lens), window=16), got, False)
    assert not got[2].any()
    with pytest.raises(ValueError):
        ops.decode_attention(T(q), T(k), T(v), T(lens), window=0)


def test_decode_attention_ragged_and_empty(rng):
    """Rows past kv_len never count, and kv_len = 0 gives 0 as the TPU
    kernel does (its oracle's softmax over nothing would give NaN)."""
    B, Hq, Hkv, S, dh = 3, 2, 2, 512, 32
    q = rng.standard_normal((B, Hq, dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, dh)).astype(np.float32)
    lens = np.array([3, 65, 0], np.int32)
    kern = np.asarray(pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lens), block_k=64, interpret=True))
    got = ops.decode_attention(T(q), T(k), T(v), T(lens))
    _close(got, kern, False)
    assert not got[2].any() and not kern[2].any()
    want = jref.decode_attention_ref(jnp.asarray(q[:2]), jnp.asarray(k[:2]),
                                     jnp.asarray(v[:2]), kv_len=jnp.asarray(lens[:2]))
    _close(got[:2], want, False)
    # garbage past kv_len does not leak in
    k2, v2 = k.copy(), v.copy()
    k2[0, :, 3:], v2[1, :, 65:] = 1e4, -1e4
    _close(ops.decode_attention(T(q), T(k2), T(v2), T(lens)), got, False)


def test_decode_attention_reads_the_cache_through_a_view(rng):
    """The model's cache is (B, S, Hkv, dh); decode reads it through a
    (B, Hkv, S, dh) transposed view, with no copy, and gives the result of
    the contiguous layout."""
    B, Hq, Hkv, S, dh = 2, 6, 2, 40, 64
    q = torch.from_numpy(rng.standard_normal((B, Hq, dh)).astype(np.float32))
    cache_k = torch.from_numpy(rng.standard_normal((B, S, Hkv, dh)).astype(np.float32))
    cache_v = torch.from_numpy(rng.standard_normal((B, S, Hkv, dh)).astype(np.float32))
    lens = torch.tensor([40, 9], dtype=torch.int32)
    kv, vv = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    assert kv.data_ptr() == cache_k.data_ptr() and not kv.is_contiguous()
    got = ops.decode_attention(q, kv, vv, lens)
    want = ops.decode_attention(q, kv.contiguous(), vv.contiguous(), lens)
    _close(got, want, False)
    jwant = jref.decode_attention_ref(jnp.asarray(q.numpy()), jnp.asarray(kv.numpy()),
                                      jnp.asarray(vv.numpy()), kv_len=jnp.asarray(lens.numpy()))
    _close(got, jwant, False)


# ------------------------------------------------- off-CPU tensors: no fallback
def test_attention_wrappers_raise_off_cpu():
    """A tensor that is not on the CPU never takes the plain version: meta
    tensors stand in for a device, and both wrappers refuse them."""
    meta = torch.device("meta")
    q4 = torch.empty((1, 4, 8, 64), device=meta)
    kv4 = torch.empty((1, 2, 8, 64), device=meta)
    with pytest.raises(ValueError):
        tfa.flash_attention(q4, kv4, kv4)
    with pytest.raises(ValueError):
        tda.decode_attention(torch.empty((1, 4, 64), device=meta), kv4, kv4,
                             torch.empty((1,), dtype=torch.int32, device=meta))


def test_ref_fully_masked_row_is_zero():
    """A query row with no visible key (window 1 with kv_offset past the
    keys) gives 0, as attention_ref's NaN-to-0 rule and the kernels'
    acc / max(l, 1e-30) do."""
    q = torch.ones((1, 1, 2, 8))
    k = torch.ones((1, 1, 4, 8))
    out = ref.attention_ref(q, k, k, causal=True, window=1, kv_offset=10)
    assert torch.equal(out, torch.zeros_like(out))


# ------------------------------------------------------------ split-KV decode
def _window_shift(x, lens, window):
    """Rows [max(0, len - window), len) of each sequence moved to the front
    (zeros behind): a windowed decode becomes a plain ragged decode with
    kv_len = len - lo, which the reference's windowless kernel and oracle
    take."""
    if window is None:
        return x, lens
    out = np.zeros_like(x)
    lo = np.maximum(lens - window, 0)
    for b, start in enumerate(lo):
        out[b, :, :x.shape[2] - start] = x[b, :, start:]
    return out, (lens - lo).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("chunk", [1, 7, 16, 48])
def test_decode_split_plain_matches_reference(rng, chunk, window, dtype):
    """The split-KV algorithm (partials per chunk, then the merge) against
    the reference's oracle and its Pallas kernel in interpret mode, with
    kv_len S, 0 and 1 present; chunk 48 = S is the one-pass case. A window
    is given to the windowless reference as its rows shifted to the front."""
    B, Hq, Hkv, S, dh = 4, 4, 2, 48, 32
    q = (rng.standard_normal((B, Hq, dh)) * 0.5).astype(dtype)
    k = (rng.standard_normal((B, Hkv, S, dh)) * 0.5).astype(dtype)
    v = (rng.standard_normal((B, Hkv, S, dh)) * 0.5).astype(dtype)
    lens = np.array([S, 0, 1, 29], np.int32)
    softcap = None if window is None else 2.0
    bf16 = dtype == jnp.bfloat16
    got = tda.decode_attention_split_plain(T(q), T(k), T(v), T(lens), chunk,
                                           window=window, softcap=softcap)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert not got[1].any()                          # kv_len 0 gives 0
    ks, wl = _window_shift(np.asarray(k), lens, window)
    vs, _ = _window_shift(np.asarray(v), lens, window)
    kern = pallas_decode(jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(wl),
                         softcap=softcap, block_k=16, interpret=True)
    _close(got, kern, bf16)
    live = lens > 0
    want = jref.decode_attention_ref(jnp.asarray(q[live]), jnp.asarray(ks[live]),
                                     jnp.asarray(vs[live]), kv_len=jnp.asarray(wl[live]),
                                     softcap=softcap)
    _close(got[torch.from_numpy(live)], want, bf16)
    _close(got, tda.decode_attention_plain(T(q), T(k), T(v), kv_len=T(lens),
                                           window=window, softcap=softcap), bf16)


@pytest.mark.parametrize("S,window,chunk,ns", [
    (80, None, 1024, 1), (32768, None, 1024, 32), (32768, None, 512, 64),
    (32768, 4096, 1024, 4), (32768, 4096, 2048, 2), (100, 5, 16, 1),
    (48, None, 7, 7), (0, None, 16, 1), (48, 100, 16, 3),
])
def test_decode_num_splits(S, window, chunk, ns):
    """NS = ceil(min(S, window or S) / chunk), at least 1, from static
    shapes only."""
    assert tda.num_splits(S, window, chunk) == ns


@pytest.mark.parametrize("window", [None, 1, 5, 300])
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_decode_split_bounds_tile_the_live_rows(window, chunk):
    """The NS splits of every sequence are disjoint, hold at most chunk rows
    each, and together hold exactly the rows the sequence sees:
    [max(0, kv_len - window), kv_len), nothing with kv_len 0."""
    S = 200
    lens = torch.tensor([0, 1, 5, 6, 63, 64, 65, 199, 200, 250], dtype=torch.int32)
    ns = tda.num_splits(S, window, chunk)
    seen = torch.zeros((len(lens), S), dtype=torch.int32)
    for c in range(ns):
        lo, hi = tda.split_bounds(lens, S, window, c, chunk)
        assert bool(((hi - lo) <= chunk).all())
        for b in range(len(lens)):
            if hi[b] > lo[b]:
                seen[b, lo[b]:hi[b]] += 1
    n = lens.clamp(max=S)
    first = n if window is None else (n - window).clamp(min=0)
    first = torch.zeros_like(n) if window is None else first
    pos = torch.arange(S)[None, :]
    want = ((pos >= first[:, None]) & (pos < n[:, None])).to(torch.int32)
    assert torch.equal(seen, want)


# ------------------------------------------- bf16 probabilities (tensor cores)
@pytest.mark.parametrize("kwargs", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=40),
    dict(causal=True, softcap=5.0), dict(causal=True, kv_offset=32),
])
def test_attention_ref_bf16_probabilities_match_reference_model(rng, kwargs):
    """``attention_ref(p_dtype=bf16)``, the numerics of the bf16 tensor-core
    kernel, against the reference model's ``attend_prefill``, which also
    rounds P to bf16 before P·V (``repro/models/attention.py``), on the
    same bf16 inputs, within 2^-7·max(|got|, |want|) + 2^-7·(P·|V|) + 1e-5;
    the oracle without rounding stays the default."""
    from repro.models.attention import attend_prefill as jattend_prefill
    B, Hq, Hkv, Sq, dh = 2, 4, 2, 96, 64
    Skv = Sq + kwargs.get("kv_offset", 0)
    q, k, v = _qkv(rng, B, Hq, Hkv, Sq, Skv, dh, jnp.bfloat16)
    q, k = (q * 3).astype(q.dtype), (k * 3).astype(k.dtype)    # peaked rows
    got = ref.attention_ref(T(q), T(k), T(v), p_dtype=torch.bfloat16, **kwargs)
    sw = {"kv_chunk": 32} if Skv % 32 == 0 else {}
    want = jattend_prefill(jnp.asarray(q).swapaxes(1, 2), jnp.asarray(k).swapaxes(1, 2),
                           jnp.asarray(v).swapaxes(1, 2), **kwargs, **sw).swapaxes(1, 2)
    want = torch.from_numpy(F32(want).copy())
    f32 = [T(x).to(torch.float32) for x in (q, k, v)]
    pv = ref.attention_ref(f32[0], f32[1], f32[2].abs(), **kwargs)
    tol = ref.bf16_probability_tol(got, want, pv)
    assert got.dtype == torch.bfloat16
    assert bool(((got.to(torch.float32) - want).abs() <= tol).all())
    exact = ref.attention_ref(*f32, **kwargs)
    rounded = ref.attention_ref(*f32, p_dtype=torch.bfloat16, **kwargs)
    assert not torch.equal(exact, rounded)
    assert torch.equal(ref.attention_ref(*f32, **kwargs, p_dtype=None), exact)
    assert bool(((rounded - exact).abs() <= ref.bf16_probability_tol(rounded, exact, pv)).all())
