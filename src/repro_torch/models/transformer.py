"""The decoder stack for the dense and ssm families.

The counterpart of ``repro.models.transformer``. The reference scans
group-stacked parameters with ``lax.scan``; PyTorch runs eagerly, so the
port keeps one parameter dict per layer and loops over them. A sublayer is
attention + SwiGLU (dense) or a Mamba block with no MLP (ssm, falcon-mamba).

The cache keeps one stacked tensor per kind of state, indexed by the
layer's ordinal among the layers of its kind (so a hybrid stack slots in
later): ``k`` and ``v`` (L_attn, B, S, Hkv, dh) for attention layers, the
reference's per-layer (B, S, Hkv, dh) layout stacked; ``h`` (L_mamba, B,
d_inner, N) fp32 and ``conv`` (L_mamba, B, K-1, d_inner) for Mamba layers.
Prefill and decode write them IN PLACE where the reference builds new
arrays (``dynamic_update_slice``, ``.at[].set``): the decode kernel reads a
layer's KV through a (B, Hkv, S, dh) view, and the scan kernel writes a
layer's ``h`` over the state it read. Attention takes any query length, so
the reference's query chunking (``_q_chunked_attend``) has no counterpart.

Mixture-of-experts FFNs and cross-attention raise ``NotImplementedError``
and name the slice that will port them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models.layers import (dtype_of, init_attention, init_mamba, init_mlp,
                                       rms_norm, swiglu)

# What each unported branch waits for (ROADMAP queue 1).
NOT_PORTED = {
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
        if spec.mlp == "moe":
            raise NotImplementedError(f"{cfg.name}: {NOT_PORTED['moe']}")
        if spec.cross:
            raise NotImplementedError(f"{cfg.name}: {NOT_PORTED['cross']}")
    return pattern


# ---------------------------------------------------------------------------
# Parameters and caches.
# ---------------------------------------------------------------------------

def init_sublayer(gen, cfg, spec: SubLayerSpec, device) -> dict:
    d = cfg.d_model
    p = {"ln_mix": torch.zeros(d, dtype=torch.float32, device=device),
         "mix": (init_attention if spec.kind == "attn" else init_mamba)(gen, cfg, device)}
    if spec.mlp == "dense":
        p["ln_mlp"] = torch.zeros(d, dtype=torch.float32, device=device)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype_of(cfg), device)
    return p


def init_stack(gen, cfg, device) -> list[dict]:
    return [init_sublayer(gen, cfg, spec, device) for spec in check_ported(cfg)]


def cache_slots(pattern: list[SubLayerSpec]) -> list[int]:
    """Each layer's index into its kind's stacked cache tensors: its
    ordinal among the layers of its kind."""
    kinds = [spec.kind for spec in pattern]
    return [kinds[:i].count(kind) for i, kind in enumerate(kinds)]


def init_cache(cfg, batch: int, max_len: int, device, dtype=None) -> dict:
    """Preallocated zero cache: {"k", "v"} (L_attn, B, S, Hkv, dh) for the
    attention layers, {"h", "conv"} (L_mamba, ...) for the Mamba layers;
    ``kv_len`` tracks which KV positions are valid."""
    kinds = cfg.layer_kinds()
    dt = dtype or dtype_of(cfg)
    cache = {}
    if "attn" in kinds:
        shape = (kinds.count("attn"), batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    if "mamba" in kinds:
        cache.update(mam.init_mamba_state(cfg, batch, dt, device,
                                          lead=(kinds.count("mamba"),)))
    return cache


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


def mamba_sublayer(x, sp, cfg, *, state=None, fresh: bool = False):
    """x (B, L, d) -> x + Mamba block. ``state`` is this layer's {"h",
    "conv"} cache, read (unless ``fresh``: a prefill's first chunk starts
    from zeros) and written in place."""
    h = rms_norm(x, sp["ln_mix"], cfg.norm_eps)
    out, _ = mam.mamba_block(h, sp["mix"], cfg, state=None if fresh else state,
                             out_state=state)
    return x + out.to(x.dtype)


def sublayer_apply(x, sp, cfg, spec: SubLayerSpec, *, mode: str, positions,
                   cache=None, slot: int = 0, kv_len=None, kv_offset: int = 0):
    """One layer: its mixer, then its MLP if it has one. ``cache`` is the
    whole stacked cache and ``slot`` the layer's index into its kind's
    tensors (``cache_slots``)."""
    if spec.kind == "attn":
        ck = cv = None
        if cache is not None:
            ck, cv = cache["k"][slot], cache["v"][slot]
        x = attn_sublayer(x, sp, cfg, spec, mode=mode, positions=positions,
                          cache_k=ck, cache_v=cv, kv_len=kv_len, kv_offset=kv_offset)
    else:
        state = None
        if cache is not None:
            state = {"h": cache["h"][slot], "conv": cache["conv"][slot]}
        x = mamba_sublayer(x, sp, cfg, state=state,
                           fresh=mode == "prefill" and kv_offset == 0)
    if spec.mlp == "dense":
        h = rms_norm(x, sp["ln_mlp"], cfg.norm_eps)
        x = x + swiglu(h, sp["mlp"]["w_gate"], sp["mlp"]["w_up"],
                       sp["mlp"]["w_down"]).to(x.dtype)
    return x


def stack_apply(x, layers: list[dict], cfg, *, mode: str, positions, cache=None,
                kv_len=None, kv_offset: int = 0):
    """Run every layer over x. ``cache`` (``init_cache``'s dict) is updated
    in place in prefill and decode modes; train mode takes none."""
    pattern = check_ported(cfg)
    for sp, spec, slot in zip(layers, pattern, cache_slots(pattern)):
        x = sublayer_apply(x, sp, cfg, spec, mode=mode, positions=positions,
                           cache=cache, slot=slot, kv_len=kv_len, kv_offset=kv_offset)
    return x
