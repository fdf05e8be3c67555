"""Plain reference of a Mamba-1 language model (falcon-mamba-7b), fp32.

Each layer: x + out_proj(scan(silu(conv(in_x))) · silu(z)), over an RMS
norm of x, where in_proj gives [in_x, z], the causal depthwise conv has
``conv_kernel`` taps and a bias, the x-projection gives [Δ_in, B, C],
Δ = softplus(Δ_in · W_dt + dt_bias), and the selective scan is
h_t = exp(Δ_t ⊙ A) h_{t−1} + (Δ_t x_t) ⊗ B_t, y_t = C_t · h_t + D ⊙ x_t
with A = −exp(A_log) (Gu and Dao 2023, Mamba-1). Then the final RMS norm
and an untied head.

Departure from Falcon-Mamba (arXiv:2410.05355), as the port runs it:
Falcon-Mamba's RMS norms on B, C and Δ (``mixer_rms_eps``) are left out,
here and in the port. The norms take the port's ``1 + scale`` weight.

``make_weights`` draws the weights in the port's parameter layout;
``logits`` runs the whole sequence from scratch, sequentially over
positions in the scan, a layer at a time. Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common as C


def dims(cfg: dict) -> dict:
    return dict(L=cfg["num_hidden_layers"], d=cfg["hidden_size"], di=cfg["intermediate_size"],
                N=cfg["state_size"], K=cfg["conv_kernel"], R=cfg["time_step_rank"],
                eps=cfg["layer_norm_epsilon"], V=cfg["vocab_size"])


def make_weights(cfg: dict, seed: int, device) -> dict:
    m = dims(cfg)
    L, d, di, N, K, R = m["L"], m["d"], m["di"], m["N"], m["K"], m["R"]
    g = C.generator(seed, device)
    params = C.embed_head(g, cfg, device)
    w_in = C.normal(g, (L, d, 2 * di), d ** -0.5, device)
    conv_w = C.normal(g, (L, K, di), 0.2, device)
    w_x = C.normal(g, (L, di, R + 2 * N), di ** -0.5, device)
    w_dt = C.normal(g, (L, R, di), R ** -0.5, device)
    dt_bias = torch.log(torch.expm1(C.uniform(g, (L, di), 1e-3, 1e-1, device).clamp_(min=1e-4)))
    a_log = C.uniform(g, (L, di, N), C.LOG_HALF, C.LOG_16, device)
    w_out = C.normal(g, (L, di, d), di ** -0.5, device)
    ln = torch.zeros((L, d), dtype=torch.float32, device=device)
    conv_b = torch.zeros((L, di), dtype=torch.bfloat16, device=device)
    ones = torch.ones((L, di), dtype=torch.float32, device=device)
    params["layers"] = [
        {"ln_mix": ln[i],
         "mix": {"w_in": w_in[i], "conv_w": conv_w[i], "conv_b": conv_b[i],
                 "w_x_proj": w_x[i], "w_dt": w_dt[i], "dt_bias": dt_bias[i],
                 "A_log": a_log[i], "D": ones[i], "w_out": w_out[i]}}
        for i in range(L)]
    return params


def step_shape(cfg: dict) -> dict:
    """Element counts for ``yardstick.step_bound``."""
    m = dims(cfg)
    d, di, N, K, R = m["d"], m["di"], m["N"], m["K"], m["R"]
    layer = d + d * 2 * di + K * di + di + di * (R + 2 * N) + R * di + di + di * N + di + di * d
    vp = C.padded_vocab(m["V"])
    return dict(dense=m["L"] * layer + d, head=vp * d, experts=0, n_experts=0, top_k=0, d=d,
                kv_per_pos=0, ssm_state=m["L"] * di * N, ssm_conv=m["L"] * (K - 1) * di,
                attn_ops_per_pair=0)


def _scan(x, dt, A, B, Cm, D):
    """x, dt (b, T, di); A (di, N); B, C (b, T, N) -> y (b, T, di), fp32."""
    h = torch.zeros((x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * x[:, t])[:, :, None] * B[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1) + D * x[:, t])
    return torch.stack(ys, 1)


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: torch.Tensor, first: int,
           fp8: bool = False) -> torch.Tensor:
    """tokens (b, T) -> fp32 logits (b, T − first, V) of positions first..T−1."""
    m = dims(cfg)
    K, N, R, eps = m["K"], m["N"], m["R"], m["eps"]
    T = tokens.shape[1]
    x = params["embed"][tokens.long()].float()
    for layer in params["layers"]:
        p = layer["mix"]
        h = C.rms_norm(x, layer["ln_mix"], eps)
        xs, z = C.matmul(h, p["w_in"], fp8).chunk(2, dim=-1)
        xp = F.pad(xs, (0, 0, K - 1, 0))
        xc = sum(xp[:, i:i + T] * p["conv_w"][i].float() for i in range(K)) + p["conv_b"].float()
        xc = F.silu(xc)
        dt_in, B, Cm = C.matmul(xc, p["w_x_proj"], fp8).split([R, N, N], dim=-1)
        dt = F.softplus(C.matmul(dt_in, p["w_dt"], fp8) + p["dt_bias"].float())
        y = _scan(xc, dt, -torch.exp(p["A_log"].float()), B, Cm, p["D"].float())
        x = x + C.matmul(y * F.silu(z), p["w_out"], fp8)
    return C.logits(x[:, first:], params, {**cfg, "norm_eps": eps}, fp8)
