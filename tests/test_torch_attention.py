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
