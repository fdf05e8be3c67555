"""Model facade for the dense and ssm families: init, cache, prefill, decode
step.

The counterpart of ``repro.models.model`` for serving. Vocab is padded to
a multiple of 2048 as in the reference, and padded rows score -1e30.

The LM head: the reference casts the (Vp, d) head to fp32 on every call
(``_logits_last``), which in eager PyTorch would allocate a 1.6 GB
temporary per token at llama3.2-3b's 129,024 × 3072. The port holds ONE
fp32 copy of the head, made on the first call for a given head tensor and
kept on the model, so logits stay fp32 (the same products of bf16 values,
summed in fp32) at the cost of Vp·d·4 bytes of memory.

An ssm model (falcon-mamba) carries its Mamba state in the cache instead
of K/V; ``kv_len`` is still returned and advanced, as the reference does,
so the serving loop is the same for both families. Training
(``loss_fn``), whisper's encoder and the VLM's patch prefix are not
ported: ``Model`` raises for those families, and ``transformer.check_ported``
for MoE layers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.hnsw import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dtype_of, normal, rms_norm

VOCAB_PAD_UNIT = 2048


def padded_vocab(v: int) -> int:
    return ((v + VOCAB_PAD_UNIT - 1) // VOCAB_PAD_UNIT) * VOCAB_PAD_UNIT


@dataclass
class Model:
    cfg: ArchConfig
    device: str | torch.device | None = None
    _head_f32: tuple | None = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(
                f"{self.cfg.name}: the {self.cfg.family} family (encoder / patch "
                f"prefix) is not ported yet (ROADMAP queue 1)")
        tf.check_ported(self.cfg)

    # ------------------------------------------------------------- params
    def init_params(self, seed: int | torch.Generator = 0) -> dict:
        """Random weights with the reference's shapes and scales, drawn on
        the model's device from ``seed`` (an int or a torch.Generator)."""
        cfg, dev = self.cfg, self.device
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        dt = dtype_of(cfg)
        vp = padded_vocab(cfg.vocab_size)
        scale = cfg.d_model ** -0.5
        return {"embed": normal(gen, (vp, cfg.d_model), dt, scale, dev),
                "head": normal(gen, (vp, cfg.d_model), dt, scale, dev),
                "final_norm": torch.zeros(cfg.d_model, dtype=torch.float32, device=dev),
                "layers": tf.init_stack(gen, cfg, dev)}

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int) -> dict:
        return tf.init_cache(self.cfg, batch, max_len, self.device)

    def _embed_tokens(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = params["embed"][tokens.long()]
        if self.cfg.final_softcap is not None:   # gemma-style embed scaling
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _head(self, params) -> torch.Tensor:
        head = params["head"]
        if self._head_f32 is None or self._head_f32[0] is not head:
            self._head_f32 = (head, head.to(torch.float32))
        return self._head_f32[1]

    def _logits_last(self, params, x_last: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        logits = x_last.to(torch.float32) @ self._head(params).T
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        logits[:, cfg.vocab_size:] = -1e30
        return logits

    @torch.inference_mode()
    def prefill(self, params, batch: dict, max_len: int):
        """tokens (B, S) -> (last-token logits (B, Vp) fp32, cache, kv_len
        (B,) int32). Chunked at ``cfg.prefill_chunk`` when it divides S (a
        Mamba layer's state carries from chunk to chunk)."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device)
        x = self._embed_tokens(params, tokens)
        cache = self.init_cache(B, max(max_len, S))
        chunk = cfg.prefill_chunk or S
        if S % chunk:
            chunk = S
        for off in range(0, S, chunk):
            xc = tf.stack_apply(x[:, off:off + chunk], params["layers"], cfg,
                                mode="prefill", positions=positions[off:off + chunk],
                                cache=cache, kv_offset=off)
        x_last = rms_norm(xc[:, -1], params["final_norm"], cfg.norm_eps)
        return (self._logits_last(params, x_last), cache,
                torch.full((B,), S, dtype=torch.int32, device=self.device))

    @torch.inference_mode()
    def decode_step(self, params, cache: dict, tokens: torch.Tensor,
                    kv_len: torch.Tensor):
        """One token per sequence: tokens (B,), kv_len (B,) int32. Writes
        the cache in place; returns (logits (B, Vp), cache, kv_len + 1)."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens[:, None])
        x = tf.stack_apply(x, params["layers"], cfg, mode="decode",
                           positions=kv_len[:, None], cache=cache, kv_len=kv_len)
        x_last = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
        return self._logits_last(params, x_last), cache, kv_len + 1
