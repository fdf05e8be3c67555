"""The reference's ``repro.models.attention.attend_prefill`` with its
probabilities kept in fp32: the function the port's plain attention (and
its fp32 kernel) computes. The reference rounds P to bf16 before P·V,
which alone moves a reduced model's loss by ~5e-5 relative; the port's
training tests swap this in (``monkeypatch``) where they compare losses
and gradients more tightly than that.
"""

import jax.numpy as jnp

from repro.models.attention import NEG_INF


def attend_prefill_exact(q, k, v, *, causal=True, window=None, softcap=None,
                         kv_offset=0, kv_chunk=1024):
    """The reference's ``attend_prefill`` with its probabilities kept in
    fp32 (one chunk): the function the port's plain attention computes."""
    Bq, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(Bq, Sq, Hkv, H // Hkv, dh).astype(jnp.float32) * (dh ** -0.5)
    logits = jnp.einsum("bqhgd,bkhd->bhgqk", qg, k.astype(jnp.float32))
    if softcap is not None:
        logits = softcap * jnp.tanh(logits / softcap)
    qpos = jnp.arange(Sq)[:, None] + kv_offset
    kpos = jnp.arange(Skv)[None, :]
    mask = jnp.ones((Sq, Skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = jnp.where(mask[None, None, None], logits, NEG_INF)
    p = jnp.exp(logits - logits.max(-1, keepdims=True))
    out = jnp.einsum("bhgqk,bkhd->bhgqd", p, v.astype(jnp.float32))
    out = out / jnp.maximum(p.sum(-1), 1e-30)[..., None]
    return out.transpose(0, 3, 1, 2, 4).reshape(Bq, Sq, H, dh).astype(q.dtype)
