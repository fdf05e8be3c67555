"""GQA attention: projections, prefill and decode.

The counterpart of ``repro.models.attention``. Where the reference
computes attention in jnp (and names the Pallas kernels as its
replacement on the chip), the port calls the kernels: ``attend_prefill``
goes through ``ops.flash_attention`` and ``attend_decode`` through
``ops.decode_attention``, which run the CUDA kernels on CUDA tensors and
their plain PyTorch versions on CPU tensors.

Numerics of the prefill: the reference's ``attend_prefill`` rounds the
softmax probabilities to bf16 before P·V. On the card the port's bf16
kernel does the same (its tensor-core P·V takes bf16 P, and its ``l``
sums those rounded probabilities); fp32 inputs, and every CPU tensor,
keep them in fp32, as the TPU kernel does. Model outputs therefore agree
with the reference within a tolerance, not bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope


def qkv_project(x: torch.Tensor, p: dict, positions: torch.Tensor,
                rope_theta: float | None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q (B, S, H, dh), k/v (B, S, Hkv, dh), roped."""
    B, S, d = x.shape

    def proj(w):
        return (x @ w.to(x.dtype).reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attend_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int | None = None,
                   softcap: float | None = None, kv_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, dh); k/v (B, Skv, Hkv, dh) -> (B, Sq, H, dh). Query i
    sits at absolute position i + kv_offset, key j at j. The kernel reads
    the (B, S, H, dh) tensors through (B, H, S, dh) views: no copy."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window, softcap=softcap,
                              kv_offset=kv_offset)
    return out.transpose(1, 2)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  kv_len: torch.Tensor, *, window: int | None = None,
                  softcap: float | None = None) -> torch.Tensor:
    """One-token decode. q (B, H, dh); caches (B, S, Hkv, dh); kv_len (B,).
    The new token sits at position kv_len − 1 (already written). The
    kernel reads the cache through a (B, Hkv, S, dh) view, so no step
    transposes or copies it. A sliding window (gemma2's local layers)
    keeps positions > (kv_len − 1) − window, as the reference masks.
    """
    return ops.decode_attention(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2),
                                kv_len, softcap=softcap, window=window)


def out_project(attn: torch.Tensor, p: dict) -> torch.Tensor:
    """attn (..., H, dh) @ wo (H, dh, d) -> (..., d)."""
    wo = p["wo"].to(attn.dtype)
    return attn.reshape(*attn.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])
