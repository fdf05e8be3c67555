"""Model facade for every family: init, cache, prefill, decode step.

The counterpart of ``repro.models.model`` for serving. Vocab is padded to
a multiple of 2048 as in the reference, and padded rows score -1e30.

The LM head: the reference casts the (Vp, d) head to fp32 on every call
(``_logits_last``), which in eager PyTorch would allocate a 1.6 GB
temporary per token at llama3.2-3b's 129,024 × 3072. The port holds ONE
fp32 copy of the head, made on the first call for a given head tensor and
kept on the model, so logits stay fp32 (the same products of bf16 values,
summed in fp32) at the cost of Vp·d·4 bytes of memory.

An ssm model (falcon-mamba) carries its Mamba state in the cache instead
of K/V, and a hybrid one (jamba) both; ``kv_len`` is still returned and
advanced, as the reference does, so the serving loop is the same for
every family. An MoE layer's load-balancing loss is discarded, as the
reference's prefill and decode discard it.

Training: ``loss_fn`` is the reference's, one for one: whisper's encoder
and each layer's cross K/V (computed, never written into a cache),
llava's patch prefix with its labels masked (-1), the stack in train mode
under ``cfg.remat``, then a sequence-chunked fp32 cross-entropy over
``cfg.loss_chunk`` positions at a time (the head cast to fp32 per call,
differentiably; padded vocab columns at -1e30; ``final_softcap``; labels
< 0 masked), plus ``router_aux_weight`` times the MoE aux loss. It runs
outside ``inference_mode`` and needs parameters that are ordinary
tensors: ``init_params`` and ``convert.params_from_reference`` make
them so, and the train step sets ``requires_grad_`` on them. The
serving head copy is keyed by the head tensor and its version counter,
so an optimizer's in-place update makes a new copy.

Whisper (encdec): prefill runs the encoder over ``batch["audio"]`` (B,
enc_ctx, enc_dim), the frontend's frame embeddings: a projection, the
sinusoid at every frame, ``enc_layers`` non-causal attention layers that
are ALSO roped (the reference's encoder config is "dense", so its
attention takes RoPE at ``rope_theta``), the final norm. Each decoder
layer's cross K/V of that output is written into the cache (``ck``,
``cv``), which every decode step reads; a decoder token gets the sinusoid
at its position (in decode, ``kv_len``) and no RoPE; its vocab of 51,866
pads to 53,248 (an fp32 head copy of 0.27 GB at d 1,280), and padded rows
score -1e30, so a greedy argmax never picks them. Llava (vlm): prefill
prepends ``batch["patches"]`` (B, P, d), cast to the model dtype, to the
embedded text, positions run over all P + T, and ``kv_len`` comes back as
P + T; the cache is sized ``max(max_len, P + T)``, so a caller that wants
``new`` decode steps passes ``max_len = P + T + new``. A batch without its
family's input raises ``ValueError`` naming it (the reference raises
``KeyError``). A decode step raises ``ValueError`` where ``kv_len`` has
reached the cache's length, where the reference's ``.at[].set`` drops the
new K/V silently.

Under a mesh (``Model(cfg, dist=Dist.from_mesh(mesh))``, one process a
rank) every family trains and serves. ``loss_fn`` takes this rank's
parameter blocks in the training plan's layout
(``launch.sharding.param_plan(..., training=True)``, ``self.plan``) and
this rank's rows of the batch (``launch.sharding.shard_batch``), and
gives the reference's global loss: the mean over every unmasked label of
every batch shard, plus the global MoE aux. Its value is that global loss
on every rank; its gradient is this rank's term of it (its tokens' nll
over the global count, its aux term), so the train step's backward on
each rank, reduced over the batch axes as the plan says
(``launch/steps.py``), gives the global gradient. The embedding and the
head follow the plan: vocab over ``model``, d over ``data`` gathered per
call. The cross-entropy is vocab-parallel: each model rank scores its
vocab slice of every chunk in fp32, the max and the sum of exponentials
are reduced over ``model`` (the max outside autograd, where it cancels),
and so is the label's logit, which only its slice's rank holds; the head
is never gathered over ``model``. Whisper's encoder runs under the same
tensor parallelism, and so do each decoder layer's cross K/V (this rank's
heads of them; in serving every head, the cache's layout).

``prefill`` and ``decode_step`` under a mesh take this rank's blocks in
the serving plan's layout (``param_plan(..., training=False)``,
``self.serve_plan``: weights replicated over ``data``, experts stored over
it) and this rank's rows of the inputs (tokens, audio, patches:
``launch.sharding.batch_spec`` of the global batch, which ``prefill``
takes as ``batch_size``; every rank holds every row where it gives
None). The cache is this rank's block of every leaf in
``cache_specs`` / ``enc_kv_spec``'s layout (``MeshCache``, which carries
those specs and the global batch to the decode steps), and the logits
are this rank's rows of the whole-vocab (B, Vp) logits: the head is
vocab-split over ``model`` and its logits gathered over it once per
call. Inside the stack (``models/transformer.py``) attention runs on
local heads where the cache splits them, and block by block over the
sequence where it splits that; the port does not split the query
sequence where the heads do not divide ``model`` (the reference's
``_seq_shard`` changes where attention runs, not what it computes).
``Dist.single()`` and None keep the one-process path for every family.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from repro_torch.core.hnsw import resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import Dist, P
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dtype_of, normal, rms_norm

VOCAB_PAD_UNIT = 2048


def padded_vocab(v: int) -> int:
    return ((v + VOCAB_PAD_UNIT - 1) // VOCAB_PAD_UNIT) * VOCAB_PAD_UNIT


def _sinusoid_at(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Absolute sinusoidal embeddings at ``positions`` (whisper), fp32:
    (..., dim), sines then cosines."""
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv = torch.pow(10000.0, -i / half)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# Each family's input beside the tokens, with the shape prefill takes.
EXTRA_INPUT = {"encdec": ("audio", "(B, enc_ctx, enc_dim) frame embeddings"),
               "vlm": ("patches", "(B, n_patches, d_model) patch embeddings")}


class MeshCache(dict):
    """A meshed model's serving cache: this rank's block of each leaf (the
    dict's tensors), with ``specs`` (each leaf's spec: ``cache_specs``'
    k / v / h / conv and ``enc_kv_spec``'s as ck / cv) and the global
    ``batch``."""

    def __init__(self, leaves: dict, specs: dict, batch: int):
        super().__init__(leaves)
        self.specs = specs
        self.batch = batch

    def __reduce__(self):
        return MeshCache, (dict(self), self.specs, self.batch)


@dataclass
class Model:
    cfg: ArchConfig
    device: str | torch.device | None = None
    dist: Dist | None = None
    _head_f32: tuple | None = field(default=None, repr=False)
    _plan: dict | None = field(default=None, repr=False)
    _serve_plan: dict | None = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.dist is None:
            self.dist = Dist.single()

    @property
    def meshed(self) -> bool:
        return self.dist.mesh is not None

    @property
    def plan(self) -> dict:
        """The training plan's spec tree (``launch.sharding.param_plan``)."""
        if self._plan is None:
            from repro_torch.launch.sharding import param_plan
            self._plan = param_plan(self.cfg, self.dist, training=True).params
        return self._plan

    @property
    def serve_plan(self) -> dict:
        """The serving plan's spec tree (``param_plan(..., training=False)``):
        the layout of the blocks ``prefill`` and ``decode_step`` take."""
        if self._serve_plan is None:
            from repro_torch.launch.sharding import param_plan
            self._serve_plan = param_plan(self.cfg, self.dist, training=False).params
        return self._serve_plan

    def cache_specs(self, batch: int, max_len: int) -> dict:
        """Each serving cache leaf's spec under the mesh, for a global
        ``batch`` and a cache of ``max_len`` rows."""
        from repro_torch.launch.sharding import cache_specs, enc_kv_spec
        specs = cache_specs(self.cfg, self.dist, batch, max_len)
        if self.cfg.family == "encdec":
            enc = enc_kv_spec(self.cfg, self.dist, batch)
            specs.update(ck=enc["k"], cv=enc["v"])
        return specs

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global serving batch of ``batch``
        (``launch.sharding.batch_spec``; all of them where it is None)."""
        from repro_torch.launch.sharding import batch_spec
        axes = batch_spec(self.dist, batch) if self.meshed else None
        n = batch // self.dist.axis_size(axes)
        return slice(self.dist.coord(axes) * n, (self.dist.coord(axes) + 1) * n)

    # ------------------------------------------------------------- params
    def init_params(self, seed: int | torch.Generator = 0) -> dict:
        """Random weights with the reference's shapes and scales, drawn on
        the model's device from ``seed`` (an int or a torch.Generator)."""
        cfg, dev = self.cfg, self.device
        gen = seed
        if dev.type == "meta":          # shapes only (the sharding plan's tree)
            gen = None
        elif not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        dt = dtype_of(cfg)
        vp = padded_vocab(cfg.vocab_size)
        scale = cfg.d_model ** -0.5
        params = {"embed": normal(gen, (vp, cfg.d_model), dt, scale, dev),
                  "head": normal(gen, (vp, cfg.d_model), dt, scale, dev),
                  "final_norm": torch.zeros(cfg.d_model, dtype=torch.float32, device=dev),
                  "layers": tf.init_stack(gen, cfg, dev)}
        if cfg.family == "encdec":
            params["enc"] = {
                "proj": normal(gen, (cfg.enc_dim, cfg.d_model), dt, cfg.enc_dim ** -0.5,
                               dev),
                "layers": tf.init_stack(gen, self._enc_cfg(), dev),
                "final_norm": torch.zeros(cfg.d_model, dtype=torch.float32, device=dev)}
        return params

    def _enc_cfg(self) -> ArchConfig:
        """Whisper's encoder stack: dense attention layers (roped, by the
        family), run non-causal by ``_encode``."""
        return replace(self.cfg, family="dense", n_layers=self.cfg.enc_layers,
                       n_experts=0, moe_top_k=0, sliding_window=None,
                       local_global_alternating=False)

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int) -> dict:
        """The zero cache of a global ``batch`` and ``max_len`` rows; under
        a mesh this rank's block of it (``MeshCache``)."""
        if not self.meshed:
            return tf.init_cache(self.cfg, batch, max_len, self.device)
        specs = self.cache_specs(batch, max_len)
        full = tf.init_cache(self.cfg, batch, max_len, "meta")
        leaves = {}
        for name, t in full.items():
            shape = list(t.shape)
            for dim, axis in enumerate(specs[name]):
                shape[dim] //= self.dist.axis_size(axis)
            leaves[name] = torch.zeros(shape, dtype=t.dtype, device=self.device)
        return MeshCache(leaves, specs, batch)

    def _embed_tokens(self, params, tokens: torch.Tensor, plan=None) -> torch.Tensor:
        """The tokens' rows of the embedding. Under a mesh vocab-parallel:
        each model rank fills the rows of its vocab slice, the others zero,
        summed over ``model`` (exact). ``plan`` is the params' layout (the
        training plan by default)."""
        w, start, axis = self._vocab_slice(params, "embed", plan)
        if axis is None:
            x = w[tokens.long()]
        else:
            local = tokens.long() - start
            inside = (local >= 0) & (local < w.shape[0])
            x = w[local.clamp(0, w.shape[0] - 1)] * inside[..., None].to(w.dtype)
            x = coll.reduce_from(x, self.dist, axis)
        if self.cfg.final_softcap is not None:   # gemma-style embed scaling
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _vocab_slice(self, params, name: str, plan=None):
        """(this rank's rows of the embed / head, d whole; its first vocab
        row; the axis the vocab splits over, None where it is whole: without
        a mesh, or where the plan does not split it). ``plan``: the
        params' layout, the training plan by default."""
        if not self.meshed:
            return params[name], 0, None
        dist, M = self.dist, self.dist.model_axis
        spec = (plan or self.plan)[name]
        axis = M if len(spec) > 0 and spec[0] == M else None
        w = coll.fetch(params[name], spec, P(axis, None), dist)
        return w, (dist.coord(M) * w.shape[0] if axis else 0), axis

    def _encode(self, params, audio: torch.Tensor, plan=None) -> torch.Tensor:
        """Whisper's encoder on precomputed frame embeddings (B, enc_ctx,
        enc_dim) -> (B, enc_ctx, d) in the model dtype. Under a mesh
        (``plan`` the params' layout, the training plan by default) the
        encoder layers run tensor-parallel, as the decoder's do."""
        cfg, dt = self.cfg, dtype_of(self.cfg)
        specs = proj = None
        if self.meshed:
            plan = plan or self.plan
            specs = plan["enc"]["layers"]
            proj = coll.fetch(params["enc"]["proj"], plan["enc"]["proj"], P(), self.dist)
        else:
            proj = params["enc"]["proj"]
        x = audio.to(self.device, dt) @ proj.to(dt)
        pos = torch.arange(x.shape[1], device=self.device)
        x = x + _sinusoid_at(pos, cfg.d_model).to(x.dtype)
        enc_cfg = self._enc_cfg()
        pattern = [tf.SubLayerSpec(kind="attn", mlp="dense", causal=False)] * enc_cfg.n_layers
        x, _ = tf.stack_apply(x, params["enc"]["layers"], enc_cfg, self.dist, mode="train",
                              positions=pos, pattern=pattern, specs=specs)
        return rms_norm(x, params["enc"]["final_norm"], cfg.norm_eps)

    def _layer_cross_kv(self, layer: dict, enc_out: torch.Tensor, pspec=None,
                        whole: bool = True) -> tuple:
        """One decoder layer's cross (k, v) of the encoder output, each
        (B, enc_ctx, Hkv, dh). Under a mesh (``pspec`` the layer's specs)
        every head with ``wk`` / ``wv`` gathered whole (the cache's), or
        with ``whole`` False this rank's heads of them
        (``transformer.cross_axis``: training's tensor parallelism)."""
        axis = None if whole else tf.cross_axis(self.cfg, self.dist, pspec)
        enc_out = coll.copy_to(enc_out, self.dist, axis)
        B, C, d = enc_out.shape
        out = []
        for name in ("wk", "wv"):
            w = layer["cross"][name]
            if pspec is not None:
                w = coll.fetch(w, pspec["cross"][name], P(None, axis), self.dist)
            out.append((enc_out @ w.to(enc_out.dtype).reshape(d, -1)).view(B, C, *w.shape[1:]))
        return tuple(out)

    def _cross_kv(self, params, enc_out: torch.Tensor, cache: dict, plan=None) -> None:
        """Each decoder layer's cross K/V of the encoder output, written in
        place into the cache's ``ck`` / ``cv`` (L, B, enc_ctx, Hkv, dh)."""
        specs = plan["layers"] if plan is not None else [None] * len(params["layers"])
        for layer, pspec, ck, cv in zip(params["layers"], specs, cache["ck"], cache["cv"]):
            k, v = self._layer_cross_kv(layer, enc_out, pspec)
            ck.copy_(k)
            cv.copy_(v)

    def _dec_inputs(self, params, tokens: torch.Tensor, positions: torch.Tensor,
                    plan=None) -> torch.Tensor:
        x = self._embed_tokens(params, tokens, plan)
        if self.cfg.family == "encdec":
            x = x + _sinusoid_at(positions, self.cfg.d_model).to(x.dtype)
        return x

    def _extra_input(self, batch: dict) -> torch.Tensor | None:
        """The family's input beside the tokens (audio, patches), or None."""
        if self.cfg.family not in EXTRA_INPUT:
            return None
        key, what = EXTRA_INPUT[self.cfg.family]
        if key not in batch:
            raise ValueError(f"{self.cfg.name}: the {self.cfg.family} family "
                             f"needs batch[{key!r}], {what}")
        return batch[key]

    def _head(self, params) -> torch.Tensor:
        """The serving head's fp32 copy, made anew when the head tensor
        or its contents (its version counter) change."""
        head = params["head"]
        version = 0 if head.is_inference() else head._version
        cached = self._head_f32
        if cached is None or cached[0] is not head or cached[1] != version:
            self._head_f32 = (head, version, head.detach().to(torch.float32))
        return self._head_f32[2]

    # ------------------------------------------------------------ training
    def loss_fn(self, params, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: tokens (B, S), labels (B, S) int (-1 = masked), plus the
        family's input: audio (B, enc_ctx, enc_dim) [encdec], patches (B,
        P, d) [vlm]. Returns (total loss, {"xent", "aux", "tokens"}), fp32
        scalars on the model's device: total = xent + router_aux_weight ·
        aux, xent the mean over unmasked labels. Under a mesh: this rank's
        blocks and rows (see the module's docstring); the reductions over
        the batch axes are the identity without one."""
        cfg, dist = self.cfg, self.dist
        specs = self.plan["layers"] if self.meshed else None
        extra = self._extra_input(batch)
        tokens = batch["tokens"].to(self.device)
        labels = batch["labels"].to(self.device)
        positions = torch.arange(tokens.shape[1], device=self.device)
        enc_kv = None
        if cfg.family == "encdec":
            enc_out = self._encode(params, extra)
            enc_kv = [self._layer_cross_kv(layer, enc_out, None if specs is None else specs[i],
                                           whole=False)
                      for i, layer in enumerate(params["layers"])]
        x = self._dec_inputs(params, tokens, positions)
        if cfg.family == "vlm":
            patches = extra.to(self.device, x.dtype)
            x = torch.cat([patches, x], dim=1)
            positions = torch.arange(x.shape[1], device=self.device)
            pad = torch.full(patches.shape[:2], -1, dtype=labels.dtype, device=self.device)
            labels = torch.cat([pad, labels], dim=1)
        x, aux = tf.stack_apply(x, params["layers"], cfg, dist, mode="train",
                                positions=positions, enc_kv=enc_kv, specs=specs)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        nll, cnt = self._chunked_xent(params, x, labels)
        axes = dist.batch_axes                   # None without a mesh: no reduction
        n_tok = coll.all_reduce(cnt, dist, axes)
        xent = nll / n_tok.clamp(min=1.0)
        mine = xent + cfg.router_aux_weight * aux
        # the global loss's value, this rank's term's gradient (one process: its own)
        total = coll.all_reduce(mine, dist, axes) + (mine - mine.detach())
        return total, {"xent": coll.all_reduce(xent, dist, axes),
                       "aux": coll.all_reduce(aux, dist, axes), "tokens": n_tok}

    def _chunked_xent(self, params, x: torch.Tensor, labels: torch.Tensor):
        """Summed cross-entropy over labels >= 0 and their count (fp32),
        ``cfg.loss_chunk`` positions at a time (one chunk if it does not
        divide S), so the (B, S, Vp) fp32 logits never exist at once. Under
        a mesh this rank's rows, vocab-parallel: each model rank scores its
        vocab slice of a chunk, and the max, the sum of exponentials and
        the label's logit (which only its slice's rank holds) are reduced
        over ``model``; the max outside autograd, where it cancels."""
        cfg, dist = self.cfg, self.dist
        head, start, axis = self._vocab_slice(params, "head")
        head = head.to(torch.float32)
        vmask = (start + torch.arange(head.shape[0], device=x.device)) < cfg.vocab_size
        x = coll.copy_to(x, dist, axis)
        B, S, d = x.shape
        chunk = min(cfg.loss_chunk, S)
        if S % chunk:
            chunk = S
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for off in range(0, S, chunk):
            xc, lc = x[:, off:off + chunk], labels[:, off:off + chunk]
            logits = xc.to(torch.float32) @ head.T                       # (B, c, V_loc)
            if cfg.final_softcap is not None:
                logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
            logits = torch.where(vmask, logits, -1e30)
            lab = lc.clamp(min=0).long() - start
            own = (lab >= 0) & (lab < head.shape[0])
            tgt = logits.gather(-1, lab.clamp(0, head.shape[0] - 1)[..., None])[..., 0]
            tgt = coll.reduce_from(torch.where(own, tgt, 0.0), dist, axis)
            mx = coll.all_reduce(logits.amax(dim=-1), dist, axis, op="max")
            se = coll.reduce_from(torch.exp(logits - mx[..., None]).sum(dim=-1), dist, axis)
            take = tgt - mx - torch.log(se)
            mask = (lc >= 0).to(torch.float32)
            nll = nll + (-take * mask).sum()
            cnt = cnt + mask.sum()
        return nll, cnt

    def _logits_last(self, params, x_last: torch.Tensor) -> torch.Tensor:
        """(B, Vp) fp32 logits of the last positions; under a mesh the head
        is this rank's vocab slice (the serving plan's) and the logits are
        gathered over ``model``."""
        cfg = self.cfg
        logits = x_last.to(torch.float32) @ self._head(params).T
        if self.meshed and self.serve_plan["head"][:1] == (self.dist.model_axis,):
            logits = coll.gather_value(logits, 1, self.dist, self.dist.model_axis)
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        logits[:, cfg.vocab_size:] = -1e30
        return logits

    def _serve_args(self, cache: dict) -> dict:
        """The stack's mesh arguments for serving on ``cache``."""
        if not self.meshed:
            return {}
        return {"specs": self.serve_plan["layers"], "cspecs": cache.specs}

    @torch.inference_mode()
    def prefill(self, params, batch: dict, max_len: int, *, batch_size: int | None = None):
        """tokens (B, S) [+ audio (encdec) or patches (vlm)] -> (last-token
        logits (B, Vp) fp32, cache, kv_len (B,) int32). Chunked at
        ``cfg.prefill_chunk`` when it divides S (a Mamba layer's state
        carries from chunk to chunk). Under a mesh the inputs and outputs
        are this rank's rows of a global batch of ``batch_size`` (required
        there; see the module's docstring)."""
        cfg = self.cfg
        extra = self._extra_input(batch)
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        plan = None
        if self.meshed:
            if batch_size is None:
                raise ValueError(f"{cfg.name}: prefill under a mesh needs batch_size, the "
                                 f"global batch whose rows this rank holds")
            rows = self.rows(batch_size)
            if rows.stop - rows.start != B:
                raise ValueError(f"{cfg.name}: this rank holds rows {rows.start}:{rows.stop} "
                                 f"of a batch of {batch_size}, but was given {B}")
            B, plan = batch_size, self.serve_plan
        positions = torch.arange(S, device=self.device)
        x = self._dec_inputs(params, tokens, positions, plan)
        if cfg.family == "vlm":
            x = torch.cat([extra.to(self.device, x.dtype), x], dim=1)
            S = x.shape[1]
            positions = torch.arange(S, device=self.device)
        # the VLM's prefix counts toward the context: the cache grows to hold it
        cache = self.init_cache(B, max(max_len, S))
        if cfg.family == "encdec":
            self._cross_kv(params, self._encode(params, extra, plan), cache, plan)
        chunk = cfg.prefill_chunk or S
        if S % chunk:
            chunk = S
        for off in range(0, S, chunk):
            xc = tf.stack_apply(x[:, off:off + chunk], params["layers"], cfg, self.dist,
                                mode="prefill", positions=positions[off:off + chunk],
                                cache=cache, kv_offset=off, **self._serve_args(cache))
        x_last = rms_norm(xc[:, -1], params["final_norm"], cfg.norm_eps)
        return (self._logits_last(params, x_last), cache,
                torch.full((x.shape[0],), S, dtype=torch.int32, device=self.device))

    @torch.inference_mode()
    def decode_step(self, params, cache: dict, tokens: torch.Tensor,
                    kv_len: torch.Tensor):
        """One token per sequence: tokens (B,), kv_len (B,) int32. Writes
        the cache in place; returns (logits (B, Vp), cache, kv_len + 1).
        Under a mesh this rank's rows and ``prefill``'s ``MeshCache``."""
        cfg = self.cfg
        _check_room(cache, kv_len, self.dist)
        plan = self.serve_plan if self.meshed else None
        x = self._dec_inputs(params, tokens[:, None], kv_len[:, None], plan)
        x = tf.stack_apply(x, params["layers"], cfg, self.dist, mode="decode",
                           positions=kv_len[:, None], cache=cache, kv_len=kv_len,
                           **self._serve_args(cache))
        x_last = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
        return self._logits_last(params, x_last), cache, kv_len + 1


def _check_room(cache: dict, kv_len: torch.Tensor, dist: Dist) -> None:
    """Refuse a decode step where a sequence's ``kv_len`` has reached the
    KV cache's length (under a mesh the whole sequence's, over its
    blocks): its new K/V would land past the end. On the CPU a
    ValueError. On the card a device-side assertion, with no host read, so
    it holds in an eager step, a graph's warm-up and every replay of a
    captured step alike; a failed one ends the CUDA context."""
    if "k" not in cache:
        return
    room = cache["k"].shape[2]
    if isinstance(cache, MeshCache):
        room *= dist.axis_size(cache.specs["k"][2])
    if kv_len.is_cuda:
        torch._assert_async((kv_len < room).all(),
                            "decode_step: kv_len has reached the cache length")
        return
    longest = int(kv_len.max())
    if longest >= room:
        raise ValueError(f"decode_step: kv_len {longest} has reached the cache length "
                         f"{room}; prefill with a larger max_len")
