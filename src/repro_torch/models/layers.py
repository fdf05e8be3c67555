"""Shared layers: norms, rotary embeddings, the SwiGLU MLP, parameter init.

The counterpart of ``repro.models.layers`` for the dense and ssm families.
Parameters are plain dicts of tensors. The norm, the rotary angles and the
SiLU run in fp32 whatever the activation dtype, as in the reference;
matrix products take the activation dtype (``torch.matmul``, as the
reference leaves them to XLA). Initializers draw from an explicit
``torch.Generator`` with the reference's shapes and scales; they cannot
reproduce ``jax.random``'s numbers, so tests carry the reference's
parameters across with ``models.convert``.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x²) + eps) * (1 + scale), in fp32, back to x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, dh); positions (..., S) integer. Rotates the two
    halves of the head dimension in fp32."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs        # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                           # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return h @ w_down.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers (the reference's shapes and scales).
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, dtype, scale: float, device) -> torch.Tensor:
    """N(0, scale²) drawn in fp32 on ``device`` from ``gen``, cast to dtype."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def init_mlp(gen, d_model: int, d_ff: int, dtype, device) -> dict:
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {"w_gate": normal(gen, (d_model, d_ff), dtype, s_in, device),
            "w_up": normal(gen, (d_model, d_ff), dtype, s_in, device),
            "w_down": normal(gen, (d_ff, d_model), dtype, s_out, device)}


def init_attention(gen, cfg, device) -> dict:
    dt = dtype_of(cfg)
    d, dh = cfg.d_model, cfg.head_dim
    s = d ** -0.5
    return {"wq": normal(gen, (d, cfg.n_heads, dh), dt, s, device),
            "wk": normal(gen, (d, cfg.n_kv_heads, dh), dt, s, device),
            "wv": normal(gen, (d, cfg.n_kv_heads, dh), dt, s, device),
            "wo": normal(gen, (cfg.n_heads, dh, d), dt, (cfg.n_heads * dh) ** -0.5,
                         device)}


def init_mamba(gen, cfg, device) -> dict:
    """A Mamba1 mixer's parameters: ``A_log``, ``dt_bias`` and ``D`` in fp32,
    the rest in the config's dtype. ``A_log`` is the draw U(log 0.5, log 16)
    itself (the reference's ``log(-A)`` with ``A = -exp(U)``)."""
    dt = dtype_of(cfg)
    d, di, ns = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state
    dt_rank = max(1, d // 16)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        return u.mul_(hi - lo).add_(lo)

    return {"w_in": normal(gen, (d, 2 * di), dt, d ** -0.5, device),       # [x, z]
            "conv_w": normal(gen, (cfg.ssm_d_conv, di), dt, 0.2, device),
            "conv_b": torch.zeros(di, dtype=dt, device=device),
            "w_x_proj": normal(gen, (di, dt_rank + 2 * ns), dt, di ** -0.5, device),
            "w_dt": normal(gen, (dt_rank, di), dt, dt_rank ** -0.5, device),
            "dt_bias": torch.log(torch.expm1(uniform((di,), 1e-3, 1e-1).clamp_(min=1e-4))),
            "A_log": uniform((di, ns), math.log(0.5), math.log(16.0)),
            "D": torch.ones(di, dtype=torch.float32, device=device),
            "w_out": normal(gen, (di, d), dt, di ** -0.5, device)}
