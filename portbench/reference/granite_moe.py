"""Plain reference of a GraniteMoE language model (granite-3.0-3b-a800m),
fp32.

Each layer: x + attention(RMS norm of x), then x + MoE(RMS norm of x).
Attention is grouped-query (``num_attention_heads`` query heads over
``num_key_value_heads`` K/V heads, query head h reading K/V head
h // (Hq / Hkv)), RoPE by halves at ``rope_theta``, causal, softmax scale
head_dim^-0.5. The MoE FFN routes each token by softmax over the fp32
router's logits, keeps the top ``num_experts_per_tok`` (ties to the lower
expert), renormalises their weights to sum to 1, and adds each chosen
expert's SwiGLU, silu(x W_gate) ⊙ (x W_up) W_down, weighted: every expert's
product computed exactly on the tokens routed to it. Then the final RMS
norm and an untied head.

Departures from Granite 3.0 as the port runs it: no embedding, attention
or residual multipliers and no logits scaling (the file's
``embedding_multiplier`` 1, ``attention_multiplier`` head_dim^-0.5,
``residual_multiplier`` 1, ``logits_scaling`` 1), an untied head, and the
port's ``1 + scale`` norm weight.

``make_weights`` draws the weights in the port's parameter layout;
``logits`` runs the whole sequence from scratch, a layer at a time.
Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common as C


def dims(cfg: dict) -> dict:
    H, d = cfg["num_attention_heads"], cfg["hidden_size"]
    return dict(L=cfg["num_hidden_layers"], d=d, H=H, Hkv=cfg["num_key_value_heads"],
                dh=cfg.get("head_dim", d // H), E=cfg["num_local_experts"],
                k=cfg["num_experts_per_tok"], ffe=cfg["intermediate_size"],
                theta=float(cfg["rope_theta"]), eps=cfg["rms_norm_eps"], V=cfg["vocab_size"])


def make_weights(cfg: dict, seed: int, device) -> dict:
    m = dims(cfg)
    L, d, H, Hkv, dh, E, ffe = m["L"], m["d"], m["H"], m["Hkv"], m["dh"], m["E"], m["ffe"]
    g = C.generator(seed, device)
    params = C.embed_head(g, cfg, device)
    wq = C.normal(g, (L, d, H, dh), d ** -0.5, device)
    wk = C.normal(g, (L, d, Hkv, dh), d ** -0.5, device)
    wv = C.normal(g, (L, d, Hkv, dh), d ** -0.5, device)
    wo = C.normal(g, (L, H, dh, d), (H * dh) ** -0.5, device)
    router = C.normal(g, (L, d, E), d ** -0.5, device, torch.float32)
    w_gate = C.normal(g, (L, E, d, ffe), d ** -0.5, device)
    w_up = C.normal(g, (L, E, d, ffe), d ** -0.5, device)
    w_down = C.normal(g, (L, E, ffe, d), ffe ** -0.5, device)
    ln = torch.zeros((2, L, d), dtype=torch.float32, device=device)
    params["layers"] = [
        {"ln_mix": ln[0, i], "mix": {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i]},
         "ln_mlp": ln[1, i],
         "mlp": {"router": router[i], "w_gate": w_gate[i], "w_up": w_up[i],
                 "w_down": w_down[i]}}
        for i in range(L)]
    return params


def step_shape(cfg: dict) -> dict:
    """Element counts for ``yardstick.step_bound``."""
    m = dims(cfg)
    L, d, H, Hkv, dh, E, ffe = m["L"], m["d"], m["H"], m["Hkv"], m["dh"], m["E"], m["ffe"]
    attn = d * H * dh * 2 + d * Hkv * dh * 2
    layer = 2 * d + attn + d * E
    return dict(dense=L * layer + d, head=C.padded_vocab(m["V"]) * d,
                experts=L * E * 3 * d * ffe, n_experts=E, top_k=m["k"], d=d,
                kv_per_pos=L * 2 * Hkv * dh, ssm_state=0, ssm_conv=0,
                attn_ops_per_pair=L * 4 * H * dh)


def _attention(h, p, m, pos, fp8):
    b, T, d = h.shape
    H, Hkv, dh = m["H"], m["Hkv"], m["dh"]
    q = C.matmul(h, p["wq"].reshape(d, H * dh), fp8).view(b, T, H, dh)
    k = C.matmul(h, p["wk"].reshape(d, Hkv * dh), fp8).view(b, T, Hkv, dh)
    v = C.matmul(h, p["wv"].reshape(d, Hkv * dh), fp8).view(b, T, Hkv, dh)
    q, k = C.rope(q, pos, m["theta"]), C.rope(k, pos, m["theta"])
    g = H // Hkv
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=h.device).tril(), float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return C.matmul(o.reshape(b, T, H * dh), p["wo"].reshape(H * dh, d), fp8)


def _moe(h, p, m, fp8):
    b, T, d = h.shape
    x = h.reshape(-1, d)
    probs = torch.softmax(C.matmul(x, p["router"], fp8), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :m["k"]], ids[:, :m["k"]]
    w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(m["E"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        he = F.silu(C.matmul(xe, p["w_gate"][e], fp8)) * C.matmul(xe, p["w_up"][e], fp8)
        y.index_add_(0, tok, w[tok, slot, None] * C.matmul(he, p["w_down"][e], fp8))
    return y.view(b, T, d)


@torch.no_grad()
def logits(params: dict, cfg: dict, tokens: torch.Tensor, first: int,
           fp8: bool = False) -> torch.Tensor:
    """tokens (b, T) -> fp32 logits (b, T − first, V) of positions first..T−1."""
    m = dims(cfg)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = params["embed"][tokens.long()].float()
    for layer in params["layers"]:
        x = x + _attention(C.rms_norm(x, layer["ln_mix"], m["eps"]), layer["mix"], m, pos, fp8)
        x = x + _moe(C.rms_norm(x, layer["ln_mlp"], m["eps"]), layer["mlp"], m, fp8)
    return C.logits(x[:, first:], params, {**cfg, "norm_eps": m["eps"]}, fp8)
