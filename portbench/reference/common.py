"""Pieces every plain reference model shares: the norm, rotary
embeddings, the head, weight draws from a seed, and the lower-precision
arithmetic of the control.

The weights are drawn on the device from a ``torch.Generator`` in a few
large calls, in the type they are served in (bf16; norms, the router and
the Mamba ``A_log`` / ``dt_bias`` / ``D`` in fp32), with the shapes and
the scales of the port's initialisers, in the layout of the port's
parameter tree: the benchmark hands the same tensors to the program and
to the reference. Every reference computes in fp32 from those values,
with TF32 off.

``matmul(a, w, fp8=True)`` is the control's product: both operands
rounded to float8 e4m3 before an fp32 product, each scaled as a whole
tensor to the format's largest value (per-tensor scaling, the usual fp8
recipe).
"""

from __future__ import annotations

import math

import torch

VOCAB_PAD_UNIT = 2048
E4M3_MAX = 448.0


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD_UNIT) * VOCAB_PAD_UNIT


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def normal(g, shape, scale: float, device, dtype=torch.bfloat16) -> torch.Tensor:
    """N(0, scale²) in ``dtype``, drawn in one call."""
    return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(scale)


def uniform(g, shape, lo: float, hi: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device, dtype=torch.float32).mul_(hi - lo).add_(lo)


def embed_head(g, cfg: dict, device) -> dict:
    vp, d = padded_vocab(cfg["vocab_size"]), cfg["hidden_size"]
    return {"embed": normal(g, (vp, d), d ** -0.5, device),
            "head": normal(g, (vp, d), d ** -0.5, device),
            "final_norm": torch.zeros(d, dtype=torch.float32, device=device)}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · (1 + scale), fp32 (the port's
    parametrisation of the norm weight)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = E4M3_MAX / t.abs().amax().clamp(min=1e-12)
    return (t * s).to(torch.float8_e4m3fn).float() / s


def matmul(a: torch.Tensor, w: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """a (..., K) @ w (K, M) in fp32; with ``fp8`` both rounded to e4m3
    first."""
    a, w = a.float(), w.float()
    if fp8:
        a, w = _fp8(a), _fp8(w)
    return a @ w


def logits(x: torch.Tensor, params: dict, cfg: dict, fp8: bool = False) -> torch.Tensor:
    """The final norm and the head: (..., d) -> (..., V) fp32 over the
    unpadded vocab."""
    h = rms_norm(x, params["final_norm"], cfg["norm_eps"])
    return matmul(h, params["head"][:cfg["vocab_size"]].T, fp8)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, dh) rotated by halves, fp32."""
    dh = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device, dtype=torch.float32) / dh)
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


LOG_HALF, LOG_16 = math.log(0.5), math.log(16.0)
