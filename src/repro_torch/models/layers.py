"""Shared layers: norms, rotary embeddings, the SwiGLU MLP, parameter init.

The counterpart of ``repro.models.layers``.
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

from repro_torch.distributed import collectives as coll

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
           w_down: torch.Tensor, dist=None, axis=None) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return row_parallel(h, w_down, dist, axis)


def row_parallel(a: torch.Tensor, w: torch.Tensor, dist=None, axis=None) -> torch.Tensor:
    """a @ w (w 2-D) in a's dtype. Where w's rows split over ``axis`` (a
    mesh's tensor parallelism) each rank's product is a partial sum: it is
    taken in fp32 (the products of a's and w's values, summed in fp32, as
    one device's bf16 product accumulates) and the partials are summed
    over ``axis`` in fp32, so the result rounds to a's dtype once, as one
    device's does. Without ``axis`` the plain product."""
    if axis is None:
        return a @ w.to(a.dtype)
    part = a.to(torch.float32) @ w.to(torch.float32)
    return coll.reduce_from(part, dist, axis).to(a.dtype)


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


def init_moe(gen, cfg, device) -> dict:
    """A mixture-of-experts FFN: the router (d, E) in fp32, and the experts'
    ``w_gate`` / ``w_up`` (E, d, ffe) and ``w_down`` (E, ffe, d) in the
    config's dtype."""
    dt = dtype_of(cfg)
    d, ffe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    s_in, s_out = d ** -0.5, ffe ** -0.5
    return {"router": normal(gen, (d, E), torch.float32, s_in, device),
            "w_gate": normal(gen, (E, d, ffe), dt, s_in, device),
            "w_up": normal(gen, (E, d, ffe), dt, s_in, device),
            "w_down": normal(gen, (E, ffe, d), dt, s_out, device)}
