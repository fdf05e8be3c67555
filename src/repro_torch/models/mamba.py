"""Mamba1 block (falcon-mamba; jamba's SSM layers when its slice comes).

The counterpart of ``repro.models.mamba``. The reference computes the scan
in jnp (an outer ``lax.scan`` over chunks around an ``associative_scan``
that materializes (B, chunk, d_inner, N) fp32 ``dA`` and ``dBx``) and names
the Pallas ``mamba_scan`` as its replacement on the chip; the port always
calls the kernel, through ``ops.mamba_scan``: the CUDA kernel on CUDA
tensors, its plain sequential version on CPU tensors. The D skip term
comes out of the kernel, so ``mamba_mix`` does not add it again.

The dtype steps are the reference's, one for one: the x-projection is
rounded to x's dtype before its fp32 split, the causal conv runs as K
shifted multiply-adds in x's dtype (``F.conv1d`` would accumulate bf16
otherwise), and ``silu`` of the conv output is rounded back to x's dtype.

A decode step is ``mamba_block`` at L = 1 with the carried state
{"h": (B, d_inner, N) fp32, "conv": (B, K-1, d_inner)}. With ``out_state``
the block writes the new state into those tensors in place (it may be the
``state`` it read: the kernel reads each state element before it writes
it, and the conv tail is a new tensor before it is copied).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def _ssm_params(x: torch.Tensor, p: dict, cfg):
    """x (B, L, di) → dt (B, L, di), B/C (B, L, N) fp32, A (di, N)."""
    dt_rank = p["w_dt"].shape[0]
    N = cfg.ssm_d_state
    proj = x @ p["w_x_proj"].to(x.dtype)
    dt_in, Bc, Cc = proj.to(torch.float32).split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_in @ p["w_dt"].to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))
    return dt, Bc, Cc, A


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   init: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. x (B, L, di); w (K, di); init (B, K-1, di)."""
    K, L = w.shape[0], x.shape[1]
    if init is None:
        init = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([init.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + L] * w[i].to(x.dtype) for i in range(K))
    return out + b.to(x.dtype)


def mamba_mix(x: torch.Tensor, p: dict, cfg, h0=None, conv0=None, h_out=None):
    """Core SSM mixer. x (B, L, di) (the in-projection's x half).
    Returns (y (B, L, di), h_final (B, di, N) fp32, conv_tail (B, K-1, di));
    ``h_out`` (may be ``h0``) receives h_final in place."""
    K = cfg.ssm_d_conv
    xc = _conv1d_causal(x, p["conv_w"], p["conv_b"], conv0)
    prev = conv0 if conv0 is not None else x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    conv_tail = torch.cat([prev.to(x.dtype), x], dim=1)[:, -(K - 1):]
    xc = F.silu(xc.to(torch.float32)).to(x.dtype)
    dt, Bc, Cc, A = _ssm_params(xc, p, cfg)
    y, h_final = ops.mamba_scan(xc, dt, A, Bc, Cc, p["D"], h0, h_out=h_out)
    return y, h_final, conv_tail


def mamba_block(x: torch.Tensor, p: dict, cfg, state: dict | None = None,
                out_state: dict | None = None):
    """Full Mamba block. x (B, L, d) → (B, L, d), new state. ``state``
    ({"h", "conv"}, or None for zeros) is the carried state; ``out_state``
    (same layout) receives the new one in place and is returned."""
    xs, z = (x @ p["w_in"].to(x.dtype)).chunk(2, dim=-1)
    h0 = state["h"] if state is not None else None
    conv0 = state["conv"] if state is not None else None
    y, h_final, conv_tail = mamba_mix(xs, p, cfg, h0=h0, conv0=conv0,
                                      h_out=None if out_state is None else out_state["h"])
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    out = y @ p["w_out"].to(y.dtype)
    if out_state is None:
        return out, {"h": h_final, "conv": conv_tail}
    out_state["conv"].copy_(conv_tail)
    return out, out_state


def init_mamba_state(cfg, batch: int, dtype=torch.bfloat16, device=None,
                     lead: tuple = ()) -> dict:
    """Zero state {"h": (*lead, B, di, N) fp32, "conv": (*lead, B, K-1, di)};
    ``lead`` stacks it, e.g. over a model's Mamba layers."""
    di = cfg.ssm_d_inner
    return {"h": torch.zeros((*lead, batch, di, cfg.ssm_d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((*lead, batch, cfg.ssm_d_conv - 1, di), dtype=dtype,
                                device=device)}
