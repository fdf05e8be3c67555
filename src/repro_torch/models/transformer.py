"""The decoder stack of every family, and whisper's encoder stack.

The counterpart of ``repro.models.transformer``. The reference scans
group-stacked parameters with ``lax.scan``; PyTorch runs eagerly, so the
port keeps one parameter dict per layer and loops over them. A sublayer is
a mixer, attention or a Mamba block, then whisper's cross-attention (an
encdec decoder layer only), then its FFN: SwiGLU (dense), a mixture of
experts (``models/moe.py``: granite-moe, kimi-k2, jamba's odd layers) or
none (ssm, falcon-mamba). A hybrid stack (jamba) interleaves attention and
Mamba layers, each with a dense or MoE FFN. ``stack_apply`` takes a
caller's layer pattern, as the reference's takes ``group=``: whisper's
encoder runs the dense pattern with ``causal=False``.

The cache keeps one stacked tensor per kind of state, indexed by the
layer's ordinal among the layers of its kind (a hybrid stack holds both
side by side): ``k`` and ``v`` (L_attn, B, S, Hkv, dh) for attention
layers, the reference's per-layer (B, S, Hkv, dh) layout stacked; ``h`` (L_mamba, B,
d_inner, N) fp32 and ``conv`` (L_mamba, B, K-1, d_inner) for Mamba layers;
``ck`` and ``cv`` (L, B, enc_ctx, Hkv, dh) for an encdec decoder, each
layer's cross K/V of the encoder output (the reference's ``enc_kv``, which
it carries beside the cache). Prefill and decode write them IN PLACE where
the reference builds new arrays (``dynamic_update_slice``, ``.at[].set``):
the decode kernel reads a layer's KV through a (B, Hkv, S, dh) view, the
scan kernel writes a layer's ``h`` over the state it read, and a captured
decode step reads the cross K/V that prefill wrote at the same addresses.
Attention takes any query length, so the reference's query chunking
(``_q_chunked_attend``: whisper's 1,500-frame encoder in chunks of 250)
has no counterpart; it changes rounding only. The MoE layers'
load-balancing loss is discarded, as the reference's prefill and decode
discard it.

Train mode (``Model.loss_fn``) takes no cache: ``stack_apply`` returns
(x, aux), aux the MoE layers' summed load-balancing loss (0 without
experts), as the reference's returns it beside x. An encdec decoder
takes each layer's cross K/V as ``enc_kv`` (computed before the stack,
as the reference's ``_cross_kv``). With grad enabled each layer runs
under ``cfg.remat``, the reference's ``group_body`` policy: "full"
checkpoints the layer (``torch.utils.checkpoint``, non-reentrant) and
recomputes it in the backward; "dots" does the same but keeps the
outputs of the matrix products (``aten.mm`` / ``bmm`` / ``addmm``, the
reference's ``checkpoint_dots``) and recomputes the rest. The
attention and scan kernels are not matrix products to the policy, so
both run again in the recompute: a second real launch each. Remat moves
memory, never results.

Under a mesh (``dist``, train mode, the dense and moe families: the
model facade refuses the others) every layer takes its parameters as
this rank's blocks in the training plan's layout (``launch/sharding.py``,
the layer's specs as ``pspec``) and computes with explicit collectives
(``distributed/collectives.py``), Megatron's tensor parallelism over
``model`` and FSDP over ``data``. The functions are those of one device:
without a mesh every collective is the identity and the weights are
taken as they are (``_tp_weights``).

* the FSDP dims (d_model over ``data``) are gathered per layer, inside
  remat, so the recompute gathers again, and their gradients are
  reduce-scattered back into the blocks;
* attention: ``wq`` / ``wk`` / ``wv`` column-split over ``model`` (local
  heads Hq / n_model and Hkv / n_model, ``flash_attention`` on them),
  ``wo`` row-split, the partial outputs all-reduced over ``model`` in
  fp32 (``layers.row_parallel``: one rounding, as one device's product). Where
  the heads (Hq or Hkv) do not divide the model axis (the plan's
  "replicated" note), attention runs replicated over it: every model rank
  gathers the whole projections and computes every head. That is the
  reference's math: its ``_seq_shard`` splits the query sequence over
  ``model`` in that case, which changes where attention runs, not what it
  computes; the port does not split the sequence;
* the dense MLP: ``w_gate`` / ``w_up`` column-split, ``w_down`` row-split,
  an all-reduce over ``model``; replicated where d_ff does not divide;
* the MoE FFN: expert parallelism (``moe.moe_apply``).

The reference's ``_constrain`` pins the residual stream to the batch axes
for GSPMD; with explicit collectives the layout is what the code makes it,
so it has no counterpart. Its ``lax.scan`` over groups is the loop over
layers, as without a mesh.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import P
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (dtype_of, init_attention, init_mamba, init_mlp,
                                       init_moe, rms_norm, row_parallel, swiglu)


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


def layer_groups(cfg) -> tuple[list[SubLayerSpec], int]:
    """The reference's minimal repeating group of layers and its count
    (the port loops over layers; the sharding plan names the reference's
    group-stacked paths)."""
    pat = layer_pattern(cfg)
    L = len(pat)
    for p in range(1, L + 1):
        if L % p == 0 and all(pat[i] == pat[i % p] for i in range(L)):
            return pat[:p], L // p
    return pat, 1


# ---------------------------------------------------------------------------
# Parameters and caches.
# ---------------------------------------------------------------------------

def init_sublayer(gen, cfg, spec: SubLayerSpec, device) -> dict:
    d = cfg.d_model
    p = {"ln_mix": torch.zeros(d, dtype=torch.float32, device=device),
         "mix": (init_attention if spec.kind == "attn" else init_mamba)(gen, cfg, device)}
    if spec.cross:
        p["ln_cross"] = torch.zeros(d, dtype=torch.float32, device=device)
        p["cross"] = init_attention(gen, cfg, device)
    if spec.mlp == "dense":
        p["ln_mlp"] = torch.zeros(d, dtype=torch.float32, device=device)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype_of(cfg), device)
    elif spec.mlp == "moe":
        p["ln_mlp"] = torch.zeros(d, dtype=torch.float32, device=device)
        p["mlp"] = init_moe(gen, cfg, device)
    return p


def init_stack(gen, cfg, device) -> list[dict]:
    return [init_sublayer(gen, cfg, spec, device) for spec in layer_pattern(cfg)]


def cache_slots(pattern: list[SubLayerSpec]) -> list[int]:
    """Each layer's index into its kind's stacked cache tensors: its
    ordinal among the layers of its kind."""
    kinds = [spec.kind for spec in pattern]
    return [kinds[:i].count(kind) for i, kind in enumerate(kinds)]


def init_cache(cfg, batch: int, max_len: int, device, dtype=None) -> dict:
    """Preallocated zero cache: {"k", "v"} (L_attn, B, S, Hkv, dh) for the
    attention layers, {"h", "conv"} (L_mamba, ...) for the Mamba layers,
    {"ck", "cv"} (L, B, enc_ctx, Hkv, dh) for the cross K/V of an encdec
    decoder (every one of its layers is attention with cross-attention);
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
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, cfg.enc_ctx, cfg.n_kv_heads, cfg.head_dim)
        cache["ck"] = torch.zeros(shape, dtype=dt, device=device)
        cache["cv"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


# ---------------------------------------------------------------------------
# Sublayers.
# ---------------------------------------------------------------------------

def _split_on(spec: P, dim: int, axis: str) -> bool:
    return len(spec) > dim and spec[dim] == axis


def _tp_weights(block: dict, pblock: dict | None, dist, cols, rows):
    """A tensor-parallel region's weights and the axis its partial sums
    reduce over. Without a mesh (``pblock`` None) the block itself and
    None. Under one, the weights brought from their stored layout (specs
    ``pblock``) to the compute one: ``cols`` split over ``model`` on dim 1
    and ``rows`` on dim 0 where every one of ``cols`` is stored so (the
    axis ``model``), whole where one is not (the plan's "replicated" note:
    every model rank computes the whole region, None)."""
    if pblock is None:
        return block, None
    M = dist.model_axis
    axis = M if all(_split_on(pblock[k], 1, M) for k in cols) else None
    want = {**{k: P(None, axis) for k in cols}, **{k: P(axis) for k in rows}}
    return {k: coll.fetch(block[k], pblock[k], want[k], dist) for k in want}, axis


def _own_heads(t: torch.Tensor, dist, axis) -> torch.Tensor:
    """This model rank's block of the heads (dim 2, or 1 of a (B, H, dh)
    tensor) of a tensor that holds every head; as it is without ``axis``."""
    if axis is None:
        return t
    dim = 2 if t.dim() == 4 else 1
    n = t.shape[dim] // dist.n_model
    return t.narrow(dim, dist.coord(axis) * n, n)


def _all_heads(t: torch.Tensor, dist, axis) -> torch.Tensor:
    """Every head (dim 2) of a (B, S, H_loc, dh) tensor of local heads,
    gathered over ``axis`` (serving: outside autograd)."""
    return t if axis is None else coll.gather_value(t, 2, dist, axis)


def _first_row(cache: torch.Tensor, dist, seq_axis) -> int:
    """The absolute position of this rank's first cache row."""
    return 0 if seq_axis is None else dist.coord(seq_axis) * cache.shape[1]


def _write_span(cache: torch.Tensor, new: torch.Tensor, offset: int, dist, seq_axis) -> None:
    """Rows [offset, offset + S) of every sequence (new (B, S, Hkv, dh)),
    the part of them this rank's block of the cache's rows holds."""
    lo = _first_row(cache, dist, seq_axis)
    a = max(offset, lo)
    b = min(offset + new.shape[1], lo + cache.shape[1])
    if a < b:
        cache[:, a - lo:b - lo] = new[:, a - offset:b - offset].to(cache.dtype)


def _write_row(cache: torch.Tensor, new: torch.Tensor, kv_len, dist, seq_axis) -> None:
    """The new token's row (new (B, Hkv, dh)) at position kv_len[b] of each
    sequence, in place (the reference's .at[bidx, kv_len].set builds a new
    cache), on the rank whose block holds that row: its rank computes
    where with no host read, so a captured step stays valid."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    if seq_axis is None:
        cache[bidx, kv_len] = new.to(cache.dtype)
        return
    S = cache.shape[1]
    local = kv_len.long() - _first_row(cache, dist, seq_axis)
    mine = ((local >= 0) & (local < S))[:, None, None]
    at = local.clamp(0, S - 1)
    cache[bidx, at] = torch.where(mine, new.to(cache.dtype), cache[bidx, at])


def attn_sublayer(x, sp, cfg, spec: SubLayerSpec, *, mode: str, positions,
                  cache_k=None, cache_v=None, kv_len=None, kv_offset: int = 0,
                  dist=None, pspec=None, kvspec=None):
    """x (B, S, d) -> x + attention. ``cache_k``/``cache_v`` are this
    layer's (B, S_max, Hkv, dh) cache, written in place (prefill, decode).
    Under a mesh (``pspec`` the layer's specs) local heads where Hq and
    Hkv both divide ``model``, replicated over it otherwise
    (``_tp_weights``); in prefill and decode the cache is this rank's
    block in the layout of ``kvspec`` (``launch.sharding.cache_specs``):
    local heads, or every head and this rank's block of the sequence,
    which a decode step attends block by block and merges (see the
    module's docstring)."""
    w, axis = _tp_weights(sp["mix"], pspec and pspec["mix"], dist,
                          ("wq", "wk", "wv"), ("wo",))
    h = coll.copy_to(rms_norm(x, sp["ln_mix"], cfg.norm_eps), dist, axis)
    # By family, as the reference: whisper's decoder (encdec) is not roped,
    # but its encoder runs under a "dense" config (``Model._enc_cfg``) and
    # so takes RoPE at cfg.rope_theta on top of its additive sinusoid.
    theta = cfg.rope_theta if cfg.family != "encdec" else None
    q, k, v = attn.qkv_project(h, w, positions, theta)
    # the cache's KV head and sequence axes (its spec: P(L, B, S, Hkv, dh))
    head_axis, seq_axis = (kvspec[3], kvspec[2]) if kvspec is not None else (None, None)
    # the cache holds every head where it does not split them as the weights do
    gather = axis if head_axis is None else None

    if mode == "decode":
        q, k, v = (_all_heads(t, dist, gather) for t in (q, k, v))
        _write_row(cache_k, k[:, 0], kv_len, dist, seq_axis)
        _write_row(cache_v, v[:, 0], kv_len, dist, seq_axis)
        if seq_axis is None:
            out = attn.attend_decode(q[:, 0], cache_k, cache_v, kv_len + 1,
                                     window=spec.window, softcap=cfg.attn_softcap)
        else:
            # every query head over this rank's rows, merged over the shards
            first = torch.full_like(kv_len, _first_row(cache_k, dist, seq_axis))
            o, lse = attn.attend_decode(q[:, 0], cache_k, cache_v, kv_len + 1,
                                        window=spec.window, softcap=cfg.attn_softcap,
                                        first_row=first, return_lse=True)
            out = attn.merge_partials(coll.gather_value(o[None], 0, dist, seq_axis),
                                      coll.gather_value(lse[None], 0, dist, seq_axis))
            out = out.to(q.dtype)                 # rounded once, as one call's output
        out = _own_heads(out, dist, gather)                  # wo's rows on this rank
        return x + _out_project(out, w, dist, axis)[:, None, :].to(x.dtype)

    if mode == "prefill":
        # In-place write of this chunk's K/V at its offset (the reference's
        # dynamic_update_slice): the rows and heads this rank's block holds.
        S = x.shape[1]
        _write_span(cache_k, _all_heads(k, dist, gather), kv_offset, dist, seq_axis)
        _write_span(cache_v, _all_heads(v, dist, gather), kv_offset, dist, seq_axis)
        if kv_offset > 0:
            # Chunked prefill: attend against everything cached so far.
            k = _own_heads(coll.gather_value(cache_k, 1, dist, seq_axis)[:, :kv_offset + S],
                           dist, gather).to(q.dtype)
            v = _own_heads(coll.gather_value(cache_v, 1, dist, seq_axis)[:, :kv_offset + S],
                           dist, gather).to(q.dtype)
    out = attn.attend_prefill(q, k, v, causal=spec.causal, window=spec.window,
                              softcap=cfg.attn_softcap, kv_offset=kv_offset)
    return x + _out_project(out, w, dist, axis).to(x.dtype)


def _out_project(out: torch.Tensor, w: dict, dist, axis) -> torch.Tensor:
    """attn (..., H, dh) @ wo (H, dh, d): ``attn.out_project``, reduced over
    ``axis`` in fp32 where ``wo``'s rows split over it (``row_parallel``)."""
    if axis is None:
        return attn.out_project(out, w)
    wo = w["wo"]
    return row_parallel(out.reshape(*out.shape[:-2], -1), wo.reshape(-1, wo.shape[-1]),
                        dist, axis)


def cross_axis(cfg, dist, pspec) -> str | None:
    """The axis whisper's cross-attention splits its heads over: ``model``
    where the plan splits ``wq`` over it and the KV heads divide it, None
    (every head on every model rank) otherwise or without a mesh."""
    if pspec is None:
        return None
    M = dist.model_axis
    split = _split_on(pspec["cross"]["wq"], 1, M) and cfg.n_kv_heads % dist.n_model == 0
    return M if split else None


def cross_sublayer(x, sp, cfg, enc_k, enc_v, dist=None, pspec=None, *,
                   own_heads: bool = False):
    """Whisper's decoder cross-attention: x (B, S, d) -> x + attention of
    its queries over the encoder's K/V (B, enc_ctx, Hkv, dh), written by
    prefill. Non-causal, no window, no softcap, no RoPE. As in the
    reference, prefill and decode both take ``attend_prefill``: a decode
    step's cross-attention is a flash_attention call with Sq = 1 (rounding
    P to bf16 as the reference's prefill path does), not decode_attention.
    Under a mesh (``pspec`` the layer's specs) ``wq`` splits over
    ``model`` (``cross_axis``), each rank attends with its own heads of
    the K/V (the cache's hold every head, ``launch.sharding.enc_kv_spec``;
    training passes its own heads, ``own_heads``) and ``wo``'s partial
    outputs are reduced over ``model``."""
    w, axis = sp["cross"], cross_axis(cfg, dist, pspec)
    if pspec is not None:
        w = {k: coll.fetch(sp["cross"][k], pspec["cross"][k], want, dist)
             for k, want in (("wq", P(None, axis)), ("wo", P(axis)))}
    if not own_heads:
        enc_k, enc_v = _own_heads(enc_k, dist, axis), _own_heads(enc_v, dist, axis)
    h = coll.copy_to(rms_norm(x, sp["ln_cross"], cfg.norm_eps), dist, axis)
    B, S, d = h.shape
    wq = w["wq"]
    q = (h @ wq.to(h.dtype).reshape(d, -1)).view(B, S, wq.shape[1], wq.shape[2])
    out = attn.attend_prefill(q, enc_k, enc_v, causal=False)
    return x + _out_project(out, w, dist, axis).to(x.dtype)


def mamba_sublayer(x, sp, cfg, *, state=None, fresh: bool = False, dist=None, pspec=None):
    """x (B, L, d) -> x + Mamba block. ``state`` is this layer's {"h",
    "conv"} cache, read (unless ``fresh``: a prefill's first chunk starts
    from zeros) and written in place. Under a mesh (``pspec`` the layer's
    specs) tensor-parallel over ``model`` (``models/mamba.py``), ``state``
    this rank's channels' block."""
    h = rms_norm(x, sp["ln_mix"], cfg.norm_eps)
    out, _ = mam.mamba_block(h, sp["mix"], cfg, state=None if fresh else state,
                             out_state=state, dist=dist, pspec=pspec and pspec["mix"])
    return x + out.to(x.dtype)


def sublayer_apply(x, sp, cfg, spec: SubLayerSpec, dist=None, *, mode: str, positions,
                   cache=None, slot: int = 0, kv_len=None, kv_offset: int = 0,
                   enc_kv=None, pspec=None, cspecs=None):
    """One layer: its mixer, its cross-attention if it has one, then its
    MLP if it has one -> (x, aux), aux its MoE load-balancing loss (fp32,
    0 without experts) in train mode and None in prefill and decode, which
    compute none. ``cache`` is the whole stacked cache and ``slot``
    the layer's index into its kind's tensors (``cache_slots``; an encdec
    decoder layer's index into ``ck``/``cv`` too, every layer of it being
    attention). In train mode an encdec layer's cross K/V come as
    ``enc_kv`` = (k, v), each (B, enc_ctx, Hkv, dh), under a mesh this
    rank's heads of them (``cross_axis``). Under a mesh
    (``dist`` with a mesh) ``sp`` holds this rank's blocks and ``pspec``
    their specs; in prefill and decode ``cache`` holds this rank's blocks
    and ``cspecs`` their specs (``launch.sharding.cache_specs``), whose
    batch entry is also the axes the rows split over; in train mode the
    rows split over the batch axes and aux is this rank's term of the
    global loss (``moe.moe_apply``)."""
    meshed = dist is not None and dist.mesh is not None
    if meshed and (pspec is None or (mode != "train" and cspecs is None)):
        raise ValueError(f"{cfg.name}: a layer under a mesh needs its specs (pspec) "
                         f"and, in {mode} mode, the cache's (cspecs)")
    train = mode == "train"
    aux = torch.zeros((), dtype=torch.float32, device=x.device) if train else None
    if spec.kind == "attn":
        ck = cv = None
        if cache is not None:
            ck, cv = cache["k"][slot], cache["v"][slot]
        x = attn_sublayer(x, sp, cfg, spec, mode=mode, positions=positions,
                          cache_k=ck, cache_v=cv, kv_len=kv_len, kv_offset=kv_offset,
                          dist=dist, pspec=pspec, kvspec=cspecs and cspecs["k"])
    else:
        state = None
        if cache is not None:
            state = {"h": cache["h"][slot], "conv": cache["conv"][slot]}
        x = mamba_sublayer(x, sp, cfg, state=state, dist=dist, pspec=pspec,
                           fresh=mode == "prefill" and kv_offset == 0)
    if spec.cross and cache is not None:
        x = cross_sublayer(x, sp, cfg, cache["ck"][slot], cache["cv"][slot], dist, pspec)
    elif spec.cross and enc_kv is not None:
        x = cross_sublayer(x, sp, cfg, *enc_kv, dist, pspec, own_heads=True)
    if spec.mlp == "dense":
        # SwiGLU: w_gate / w_up columns over ``model``, w_down rows, where
        # d_ff divides it (``_tp_weights``)
        w, axis = _tp_weights(sp["mlp"], pspec and pspec["mlp"], dist,
                              ("w_gate", "w_up"), ("w_down",))
        h = coll.copy_to(rms_norm(x, sp["ln_mlp"], cfg.norm_eps), dist, axis)
        y = swiglu(h, w["w_gate"], w["w_up"], w["w_down"], dist, axis)
        x = x + y.to(x.dtype)
    elif spec.mlp == "moe":
        h = rms_norm(x, sp["ln_mlp"], cfg.norm_eps)
        rows = ... if cspecs is None else next(iter(cspecs.values()))[1]
        y, aux = moe_mod.moe_apply(h, sp["mlp"], cfg, dist, pspec=pspec and pspec["mlp"],
                                   rows=rows, aux=train)
        x = x + y.to(x.dtype)
    return x, aux


# The reference's ``checkpoint_dots``: keep the matrix products' outputs.
_SAVE_DOTS = functools.partial(create_selective_checkpoint_contexts,
                               [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                                torch.ops.aten.addmm.default])


def _remat(layer_fn, x, remat: str):
    """``layer_fn(x)`` under the config's remat policy ("none", "dots",
    "full"); only with grad enabled, since remat is a backward's trade."""
    if remat == "none" or not torch.is_grad_enabled():
        return layer_fn(x)
    if remat == "full":
        return checkpoint(layer_fn, x, use_reentrant=False)
    if remat == "dots":
        return checkpoint(layer_fn, x, use_reentrant=False, context_fn=_SAVE_DOTS)
    raise ValueError(f"remat must be none, dots or full, not {remat!r}")


def stack_apply(x, layers: list[dict], cfg, dist=None, *, mode: str, positions,
                cache=None, kv_len=None, kv_offset: int = 0, pattern=None, enc_kv=None,
                specs=None, cspecs=None):
    """Run every layer over x. ``cache`` (``init_cache``'s dict) is updated
    in place in prefill and decode modes, which return x; train mode takes
    none and returns (x, aux), aux the summed MoE load-balancing loss,
    each layer under ``cfg.remat``. ``enc_kv`` (train mode, encdec) holds
    each layer's cross (k, v). ``pattern`` (default ``layer_pattern(cfg)``)
    gives each layer's spec: whisper's encoder passes non-causal attention
    layers. Under a mesh (``dist``) ``layers`` are this rank's blocks and
    ``specs`` their specs (the plan's ``"layers"``), and in prefill and
    decode ``cache`` holds this rank's blocks in the layout ``cspecs``
    (``launch.sharding.cache_specs``)."""
    if pattern is None:
        pattern = layer_pattern(cfg)
    if mode == "train":
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (sp, spec) in enumerate(zip(layers, pattern)):
            layer_fn = functools.partial(
                sublayer_apply, sp=sp, cfg=cfg, spec=spec, dist=dist, mode=mode,
                positions=positions, enc_kv=None if enc_kv is None else enc_kv[i],
                pspec=None if specs is None else specs[i])
            x, aux = _remat(layer_fn, x, cfg.remat)
            # (the reference's _constrain goes here: under explicit
            # collectives x is already this rank's rows, nothing to pin)
            aux_total = aux_total + aux
        return x, aux_total
    for i, (sp, spec, slot) in enumerate(zip(layers, pattern, cache_slots(pattern))):
        x, _ = sublayer_apply(x, sp, cfg, spec, dist, mode=mode, positions=positions,
                              cache=cache, slot=slot, kv_len=kv_len, kv_offset=kv_offset,
                              pspec=None if specs is None else specs[i], cspecs=cspecs)
    return x
