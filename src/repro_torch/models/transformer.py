"""The decoder stack for the dense family: attention + SwiGLU sublayers.

The counterpart of ``repro.models.transformer``. The reference scans
group-stacked parameters with ``lax.scan``; PyTorch runs eagerly, so the
port keeps one parameter dict per layer and loops over them. The KV cache
is two preallocated tensors, ``k`` and ``v``, of shape (L, B, S, Hkv, dh)
(the reference's per-layer (B, S, Hkv, dh) layout, stacked over layers):
prefill and decode write into them IN PLACE where the reference builds new
arrays (``dynamic_update_slice``, ``.at[].set``), and the decode kernel
reads a layer's cache through a (B, Hkv, S, dh) view, so no step copies or
transposes it. Attention takes any query length, so the reference's query
chunking (``_q_chunked_attend``) has no counterpart.

Only dense attention layers are ported. Mixture-of-experts FFNs, Mamba
layers and cross-attention raise ``NotImplementedError`` and name the
slice that will port them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import dtype_of, init_attention, init_mlp, rms_norm, swiglu

# What each unported branch waits for (ROADMAP queue 1).
NOT_PORTED = {
    "mamba": "Mamba layers come with mamba_scan in the falcon-mamba-7b slice",
    "moe": "mixture-of-experts FFNs are not ported yet (ROADMAP queue 1)",
    "cross": "encoder-decoder cross-attention (whisper) is not ported yet "
             "(ROADMAP queue 1)",
}


@dataclass(frozen=True)
class SubLayerSpec:
    kind: str                 # "attn" | "mamba"
    mlp: str                  # "dense" | "moe" | "none"
    window: int | None = None
    causal: bool = True
    cross: bool = False       # whisper decoder cross-attention


def layer_pattern(cfg) -> list[SubLayerSpec]:
    kinds, mlps = cfg.layer_kinds(), cfg.mlp_kinds()
    return [SubLayerSpec(kind=kinds[i], mlp=mlps[i], window=cfg.window_for_layer(i),
                         cross=(cfg.family == "encdec"))
            for i in range(cfg.n_layers)]


def check_ported(cfg) -> list[SubLayerSpec]:
    """The layer pattern, or NotImplementedError for a branch not ported."""
    pattern = layer_pattern(cfg)
    for spec in pattern:
        if spec.kind != "attn":
            raise NotImplementedError(f"{cfg.name}: {NOT_PORTED['mamba']}")
        if spec.mlp == "moe":
            raise NotImplementedError(f"{cfg.name}: {NOT_PORTED['moe']}")
        if spec.cross:
            raise NotImplementedError(f"{cfg.name}: {NOT_PORTED['cross']}")
    return pattern


# ---------------------------------------------------------------------------
# Parameters and caches.
# ---------------------------------------------------------------------------

def init_sublayer(gen, cfg, device) -> dict:
    d = cfg.d_model
    return {"ln_mix": torch.zeros(d, dtype=torch.float32, device=device),
            "mix": init_attention(gen, cfg, device),
            "ln_mlp": torch.zeros(d, dtype=torch.float32, device=device),
            "mlp": init_mlp(gen, d, cfg.d_ff, dtype_of(cfg), device)}


def init_stack(gen, cfg, device) -> list[dict]:
    check_ported(cfg)
    return [init_sublayer(gen, cfg, device) for _ in range(cfg.n_layers)]


def init_cache(cfg, batch: int, max_len: int, device, dtype=None) -> dict:
    """Preallocated KV cache {"k", "v"}, each (L, B, S, Hkv, dh), zeros;
    ``kv_len`` tracks which positions are valid."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# Sublayers.
# ---------------------------------------------------------------------------

def attn_sublayer(x, sp, cfg, spec: SubLayerSpec, *, mode: str, positions,
                  cache_k=None, cache_v=None, kv_len=None, kv_offset: int = 0):
    """x (B, S, d) -> x + attention. ``cache_k``/``cache_v`` are this
    layer's (B, S_max, Hkv, dh) cache, written in place (prefill, decode)."""
    h = rms_norm(x, sp["ln_mix"], cfg.norm_eps)
    theta = cfg.rope_theta if cfg.family != "encdec" else None
    q, k, v = attn.qkv_project(h, sp["mix"], positions, theta)

    if mode == "decode":
        # The new token's K/V go into row kv_len[b] of each sequence, in
        # place (the reference's .at[bidx, kv_len].set builds a new cache).
        bidx = torch.arange(x.shape[0], device=x.device)
        cache_k[bidx, kv_len] = k[:, 0].to(cache_k.dtype)
        cache_v[bidx, kv_len] = v[:, 0].to(cache_v.dtype)
        out = attn.attend_decode(q[:, 0], cache_k, cache_v, kv_len + 1,
                                 window=spec.window, softcap=cfg.attn_softcap)
        return x + attn.out_project(out, sp["mix"])[:, None, :].to(x.dtype)

    if mode == "prefill":
        # In-place write of this chunk's K/V at its offset (the reference's
        # dynamic_update_slice).
        S = x.shape[1]
        cache_k[:, kv_offset:kv_offset + S] = k.to(cache_k.dtype)
        cache_v[:, kv_offset:kv_offset + S] = v.to(cache_v.dtype)
        if kv_offset > 0:
            # Chunked prefill: attend against everything cached so far.
            k = cache_k[:, :kv_offset + S].to(q.dtype)
            v = cache_v[:, :kv_offset + S].to(q.dtype)
    out = attn.attend_prefill(q, k, v, causal=spec.causal, window=spec.window,
                              softcap=cfg.attn_softcap, kv_offset=kv_offset)
    return x + attn.out_project(out, sp["mix"]).to(x.dtype)


def sublayer_apply(x, sp, cfg, spec: SubLayerSpec, *, mode: str, positions,
                   cache_k=None, cache_v=None, kv_len=None, kv_offset: int = 0):
    x = attn_sublayer(x, sp, cfg, spec, mode=mode, positions=positions,
                      cache_k=cache_k, cache_v=cache_v, kv_len=kv_len,
                      kv_offset=kv_offset)
    h = rms_norm(x, sp["ln_mlp"], cfg.norm_eps)
    return x + swiglu(h, sp["mlp"]["w_gate"], sp["mlp"]["w_up"],
                      sp["mlp"]["w_down"]).to(x.dtype)


def stack_apply(x, layers: list[dict], cfg, *, mode: str, positions, cache=None,
                kv_len=None, kv_offset: int = 0):
    """Run every layer over x. ``cache`` ({"k", "v"}, (L, B, S, Hkv, dh))
    is updated in place in prefill and decode modes; train mode takes none."""
    pattern = check_ported(cfg)
    for i, (sp, spec) in enumerate(zip(layers, pattern)):
        ck = cv = None
        if cache is not None:
            ck, cv = cache["k"][i], cache["v"][i]
        x = sublayer_apply(x, sp, cfg, spec, mode=mode, positions=positions,
                           cache_k=ck, cache_v=cv, kv_len=kv_len, kv_offset=kv_offset)
    return x
