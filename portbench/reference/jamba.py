"""Plain reference of a Jamba language model (AI21-Jamba2-Mini), fp32.

Layers come in periods of ``attn_layer_period``: layer i is attention
where i % period == ``attn_layer_offset``, a Mamba-1 mixer elsewhere; its
FFN is a mixture of experts where i % ``expert_layer_period`` ==
``expert_layer_offset``, a dense SwiGLU elsewhere (Lieber et al. 2024,
arXiv:2403.19887; HF ``JambaForCausalLM``). Each layer: x + mixer(RMS
norm of x), then x + FFN(RMS norm of x).

* Attention: grouped-query (query head h reads K/V head
  h // (Hq / Hkv)), causal, softmax scale head_dim^-0.5, and no
  positional encoding at all (Jamba's attention is NoPE).
* Mamba: in_proj gives [in_x, z]; a causal depthwise conv of
  ``mamba_d_conv`` taps with a bias; silu; the x-projection gives
  [Δ_in, B, C], each then RMS-normed with its own weight (HF
  ``dt_layernorm``, ``b_layernorm``, ``c_layernorm``, eps
  ``rms_norm_eps``); Δ = softplus(Δ_in · W_dt + dt_bias); the selective
  scan h_t = exp(Δ_t ⊙ A) h_{t−1} + (Δ_t x_t) ⊗ B_t,
  y_t = C_t · h_t + D ⊙ x_t, A = −exp(A_log), run sequentially over the
  positions; out_proj(y ⊙ silu(z)).
* MoE: softmax over the fp32 router's ``num_experts`` logits, the top
  ``num_experts_per_tok`` by a stable descending sort (ties to the lower
  expert), their probabilities as the weights, NOT renormalised (HF
  ``JambaSparseMoeBlock``; vLLM's Jamba passes ``renormalize=False``), and
  each chosen expert's SwiGLU silu(x W_gate) ⊙ (x W_up) W_down computed
  exactly on the tokens routed to it. Dense layers: the same SwiGLU.
* Then the final RMS norm and an untied head.

``logits`` turns TF32 off for its products, as the harness does for the
whole run. Departures from the published model, as the port runs it:
every RMS norm takes the port's ``1 + scale`` weight (HF's holds the
weight itself); the configuration is cut to its first
``num_hidden_layers`` (two whole periods of the 32:
portbench/configs/ai21-jamba2-mini.json says why).

``make_weights`` draws the weights in the port's parameter layout, the
inner norms' scales from the seed (not zeros, so that a program that
drops one weight is caught); ``logits`` runs the whole sequence from
scratch, a layer at a time, one expert's weights in fp32 at a time.
Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common as C
from portbench.reference.mamba1 import _scan

INNER_NORM_SCALE = 0.5      # the inner norms' scales: U(−0.5, 0.5)


def dims(cfg: dict) -> dict:
    H, d = cfg["num_attention_heads"], cfg["hidden_size"]
    L = cfg["num_hidden_layers"]
    kinds = ["attn" if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"] else "mamba"
             for i in range(L)]
    mlps = ["moe" if i % cfg["expert_layer_period"] == cfg["expert_layer_offset"] else "dense"
            for i in range(L)]
    return dict(L=L, d=d, H=H, Hkv=cfg["num_key_value_heads"], dh=d // H,
                E=cfg["num_experts"], k=cfg["num_experts_per_tok"],
                ff=cfg["intermediate_size"], di=cfg["mamba_expand"] * d,
                N=cfg["mamba_d_state"], K=cfg["mamba_d_conv"], R=cfg["mamba_dt_rank"],
                eps=cfg["rms_norm_eps"], V=cfg["vocab_size"], kinds=kinds, mlps=mlps)


def make_weights(cfg: dict, seed: int, device) -> dict:
    m = dims(cfg)
    d, H, Hkv, dh, E, ff = m["d"], m["H"], m["Hkv"], m["dh"], m["E"], m["ff"]
    di, N, K, R = m["di"], m["N"], m["K"], m["R"]
    na, nm = m["kinds"].count("attn"), m["kinds"].count("mamba")
    ne, nd = m["mlps"].count("moe"), m["mlps"].count("dense")
    g = C.generator(seed, device)
    params = C.embed_head(g, cfg, device)
    wq = C.normal(g, (na, d, H, dh), d ** -0.5, device)
    wk = C.normal(g, (na, d, Hkv, dh), d ** -0.5, device)
    wv = C.normal(g, (na, d, Hkv, dh), d ** -0.5, device)
    wo = C.normal(g, (na, H, dh, d), (H * dh) ** -0.5, device)
    w_in = C.normal(g, (nm, d, 2 * di), d ** -0.5, device)
    conv_w = C.normal(g, (nm, K, di), 0.2, device)
    conv_b = C.normal(g, (nm, di), 0.1, device)
    w_x = C.normal(g, (nm, di, R + 2 * N), di ** -0.5, device)
    w_dt = C.normal(g, (nm, R, di), R ** -0.5, device)
    dt_bias = torch.log(torch.expm1(C.uniform(g, (nm, di), 1e-3, 1e-1, device).clamp_(min=1e-4)))
    a_log = C.uniform(g, (nm, di, N), C.LOG_HALF, C.LOG_16, device)
    norms = C.uniform(g, (nm, R + 2 * N), -INNER_NORM_SCALE, INNER_NORM_SCALE, device)
    w_out = C.normal(g, (nm, di, d), di ** -0.5, device)
    router = C.normal(g, (ne, d, E), d ** -0.5, device, torch.float32)
    e_gate = C.normal(g, (ne, E, d, ff), d ** -0.5, device)
    e_up = C.normal(g, (ne, E, d, ff), d ** -0.5, device)
    e_down = C.normal(g, (ne, E, ff, d), ff ** -0.5, device)
    m_gate = C.normal(g, (nd, d, ff), d ** -0.5, device)
    m_up = C.normal(g, (nd, d, ff), d ** -0.5, device)
    m_down = C.normal(g, (nd, ff, d), ff ** -0.5, device)
    ln = torch.zeros((2, m["L"], d), dtype=torch.float32, device=device)
    ones = torch.ones((nm, di), dtype=torch.float32, device=device)
    layers, ia, im, ie, idn = [], 0, 0, 0, 0
    for i, (kind, mlp) in enumerate(zip(m["kinds"], m["mlps"])):
        if kind == "attn":
            mix = {"wq": wq[ia], "wk": wk[ia], "wv": wv[ia], "wo": wo[ia]}
            ia += 1
        else:
            dt_n, b_n, c_n = norms[im].split([R, N, N])
            mix = {"w_in": w_in[im], "conv_w": conv_w[im], "conv_b": conv_b[im],
                   "w_x_proj": w_x[im], "w_dt": w_dt[im], "dt_bias": dt_bias[im],
                   "A_log": a_log[im], "D": ones[im], "w_out": w_out[im],
                   "dt_norm": dt_n, "b_norm": b_n, "c_norm": c_n}
            im += 1
        if mlp == "moe":
            ffn = {"router": router[ie], "w_gate": e_gate[ie], "w_up": e_up[ie],
                   "w_down": e_down[ie]}
            ie += 1
        else:
            ffn = {"w_gate": m_gate[idn], "w_up": m_up[idn], "w_down": m_down[idn]}
            idn += 1
        layers.append({"ln_mix": ln[0, i], "mix": mix, "ln_mlp": ln[1, i], "mlp": ffn})
    params["layers"] = layers
    return params


def step_shape(cfg: dict) -> dict:
    """Element counts for ``yardstick.step_bound``, and for the counted
    experts' bytes (``portbench/expert_yardstick.py``): ``moe_layers`` and
    ``expert`` (one expert's elements in one layer)."""
    m = dims(cfg)
    d, H, Hkv, dh, E, ff = m["d"], m["H"], m["Hkv"], m["dh"], m["E"], m["ff"]
    di, N, K, R = m["di"], m["N"], m["K"], m["R"]
    na, nm = m["kinds"].count("attn"), m["kinds"].count("mamba")
    ne, nd = m["mlps"].count("moe"), m["mlps"].count("dense")
    attn = d * H * dh * 2 + d * Hkv * dh * 2
    mamba = (d * 2 * di + K * di + di + di * (R + 2 * N) + R * di + di + di * N + di
             + di * d + R + 2 * N)
    dense = na * attn + nm * mamba + nd * 3 * d * ff + ne * d * E + 2 * m["L"] * d + d
    return dict(dense=dense, head=C.padded_vocab(m["V"]) * d, experts=ne * E * 3 * d * ff,
                n_experts=E, top_k=m["k"], d=d, kv_per_pos=na * 2 * Hkv * dh,
                ssm_state=nm * di * N, ssm_conv=nm * (K - 1) * di,
                attn_ops_per_pair=na * 4 * H * dh, moe_layers=ne, expert=3 * d * ff)


def _attention(h, p, m, fp8):
    b, T, d = h.shape
    H, Hkv, dh = m["H"], m["Hkv"], m["dh"]
    q = C.matmul(h, p["wq"].reshape(d, H * dh), fp8).view(b, T, H, dh)
    k = C.matmul(h, p["wk"].reshape(d, Hkv * dh), fp8).view(b, T, Hkv, dh)
    v = C.matmul(h, p["wv"].reshape(d, Hkv * dh), fp8).view(b, T, Hkv, dh)
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=h.device).tril(), float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return C.matmul(o.reshape(b, T, H * dh), p["wo"].reshape(H * dh, d), fp8)


def _mamba(h, p, m, fp8):
    K, N, R, eps, T = m["K"], m["N"], m["R"], m["eps"], h.shape[1]
    xs, z = C.matmul(h, p["w_in"], fp8).chunk(2, dim=-1)
    xp = F.pad(xs, (0, 0, K - 1, 0))
    xc = sum(xp[:, i:i + T] * p["conv_w"][i].float() for i in range(K)) + p["conv_b"].float()
    xc = F.silu(xc)
    dt_in, B, Cm = C.matmul(xc, p["w_x_proj"], fp8).split([R, N, N], dim=-1)
    dt_in = C.rms_norm(dt_in, p["dt_norm"], eps)
    B, Cm = C.rms_norm(B, p["b_norm"], eps), C.rms_norm(Cm, p["c_norm"], eps)
    dt = F.softplus(C.matmul(dt_in, p["w_dt"], fp8) + p["dt_bias"].float())
    y = _scan(xc, dt, -torch.exp(p["A_log"].float()), B, Cm, p["D"].float())
    return C.matmul(y * F.silu(z), p["w_out"], fp8)


def _swiglu(x, w_gate, w_up, w_down, fp8):
    return C.matmul(F.silu(C.matmul(x, w_gate, fp8)) * C.matmul(x, w_up, fp8), w_down, fp8)


def _moe(h, p, m, fp8):
    b, T, d = h.shape
    x = h.reshape(-1, d)
    probs = torch.softmax(C.matmul(x, p["router"], fp8), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :m["k"]], ids[:, :m["k"]]           # not renormalised
    y = torch.zeros_like(x)
    for e in range(m["E"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel():
            out = _swiglu(x[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e], fp8)
            y.index_add_(0, tok, w[tok, slot, None] * out)
    return y.view(b, T, d)


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: torch.Tensor, first: int,
           fp8: bool = False) -> torch.Tensor:
    """tokens (b, T) -> fp32 logits (b, T − first, V) of positions first..T−1."""
    # every product in fp32, not TF32 (the harness sets the same for its whole run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = dims(cfg)
    x = params["embed"][tokens.long()].float()
    for layer, kind, mlp in zip(params["layers"], m["kinds"], m["mlps"]):
        h = C.rms_norm(x, layer["ln_mix"], m["eps"])
        x = x + (_attention(h, layer["mix"], m, fp8) if kind == "attn"
                 else _mamba(h, layer["mix"], m, fp8))
        h = C.rms_norm(x, layer["ln_mlp"], m["eps"])
        p = layer["mlp"]
        x = x + (_moe(h, p, m, fp8) if mlp == "moe"
                 else _swiglu(h, p["w_gate"], p["w_up"], p["w_down"], fp8))
    return C.logits(x[:, first:], params, {**cfg, "norm_eps": m["eps"]}, fp8)
