"""Live batched serving engine: semantic cache in front of a real model.

The counterpart of ``repro.serving.engine`` in PyTorch. The reference
jits prefill and a ``lax.scan`` greedy decode into one function per
miss-batch size; here generation is two captured programs per miss-batch
size B (``core/graphs.py``; B is never padded, so every matrix product
keeps the shape, and the tokens, of the eager loop):

* **prefill**: ``Model.prefill`` of a static (B, prompt_len) token buffer,
  the argmax of the last logits (first index on ties, as ``jnp.argmax``)
  and token 0 of a static (B, max_new) output. The cache it allocates
  (K/V, or the Mamba state) lives in the engine's graph pool and is
  re-zeroed by every replay;
* **decode**: ``Model.decode_step`` on that cache (written in place) and
  the argmax, which writes the token into its column of the output and
  the token and ``kv_len + 1`` back over the program's own inputs. It is
  replayed ``max_new - 1`` times.

The tokens come to the host in ONE copy after the last step, never one
per token. On the CPU the same programs run eagerly. The programs are
the same for every ported family: a dense model's cache holds K/V, an
ssm model's (falcon-mamba) its Mamba state, and both take ``kv_len``.
Prompts are fixed at ``prompt_len``, so no padding token ever enters a
recurrence. The
sharded cache tier (``core/shard.py``) is not ported yet, so ``cache`` is
a ``SemanticCache``.

The end-to-end path (``repro_torch.launch.serve``):

    submit(Request) → queue → step():
        embed queries (feature-hash, 384-d)
        cache.lookup_batch with per-request categories  (Algorithm 1)
          — the per-request category vector rides into the index search
            (§5.3), so mixed-category batches resolve to same-category
            matches with no cross-category false misses
        hits  → respond from cache (no model tokens burned)
        misses → batch → prefill → greedy decode loop → respond +
                 ONE cache.insert_batch for the whole batch's write-backs
                 (one store pass, one index delta flush — the device
                 tables sync O(batch) bytes, not O(capacity))

Latency/queue-depth observations feed the ``AdaptiveController`` so cache
policies relax under load (§7.5).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.cache import SemanticCache
from repro_torch.core.embedding import FeatureHashEmbedder
from repro_torch.core.graphs import CapturedProgram
from repro_torch.core.policy import AdaptiveController, LoadSignal
from repro_torch.distributed.fault import StepWatchdog
from repro_torch.models.model import Model
from repro_torch.obs import NULL_SPAN


@dataclass
class Request:
    req_id: int
    text: str
    category: str
    prompt_tokens: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    arrival: float = 0.0


@dataclass
class Response:
    req_id: int
    text: str
    tokens: np.ndarray | None
    cached: bool
    latency_ms: float
    category: str
    reason: str = ""


@dataclass
class EngineStats:
    served: int = 0
    cache_hits: int = 0
    model_tokens: int = 0
    total_latency_ms: float = 0.0
    # per-reason serve counts ("hit", "hit_l1", "model", ...) — with the
    # category-masked index there is no "category_mismatch" miss anymore;
    # cross-category traffic shows up as genuine "no_match"/"model".
    reasons: dict = field(default_factory=dict)
    # device-search data-plane counters (from cache.last_lookup_stats):
    # beam hops run and embedding rows gathered across all lookups — the
    # deterministic cost signal the lookup benchmark gates on.
    search_hops: int = 0
    rows_gathered: int = 0
    # steps the watchdog flagged as stragglers (wall time > factor × the
    # trailing-median step time) — the serving-side liveness signal.
    straggler_steps: int = 0

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.served if self.served else 0.0

    def count_reason(self, reason: str) -> None:
        self.reasons[reason] = self.reasons.get(reason, 0) + 1


class ServingEngine:
    """Queue → embed → cache lookup → model on misses → batched
    write-back. The model runs on its own device (``model.device``)."""

    def __init__(self, model: Model, params, cache: SemanticCache,
                 *, max_batch: int = 8, prompt_len: int = 64,
                 max_new_tokens: int = 16,
                 controller: AdaptiveController | None = None,
                 model_name: str = "default",
                 watchdog: StepWatchdog | None = None,
                 obs=None):
        self.model = model
        self.params = params
        self.cache = cache
        # Optional TraceRecorder (repro_torch.obs). Share ONE recorder (and
        # one WallClock) with the cache — launch/serve.py does this —
        # so cache stage spans nest under the engine_step root. Wall
        # time is not exhaustively charged, so span accounting reports
        # leaf COVERAGE here, never equality (SimClock-only invariant).
        self.obs = obs
        self.embedder = FeatureHashEmbedder()
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.max_new = max_new_tokens
        self.controller = controller
        self.model_name = model_name
        # Straggler detection on the serve loop itself: every non-empty
        # step() is timed, and steps beyond the watchdog's trailing-
        # median threshold surface as stats.straggler_steps.
        self.watchdog = watchdog if watchdog is not None else StepWatchdog()
        self.queue: list[Request] = []
        self.stats = EngineStats()
        self._next_id = 0
        self._max_len = prompt_len + max_new_tokens
        # Generation's programs (prefill and decode per miss-batch size),
        # captured for one set of weights: their graphs read its storages.
        self.programs = CapturedProgram(model.device)
        self._program_params = None

    @torch.inference_mode()
    def _generate(self, params, tokens: np.ndarray) -> np.ndarray:
        """Prefill, then greedy decode: (B, S) int32 prompt tokens -> (B,
        new) tokens as numpy, copied to the host once, after the last
        step. On the card: a replay of the prefill graph of this B, then
        ``max_new - 1`` replays of its decode graph."""
        model, V, S = self.model, self.model.cfg.vocab_size, self.prompt_len
        tokens = np.ascontiguousarray(tokens, np.int32)
        B = tokens.shape[0]
        if params is not self._program_params:
            self.programs.clear()
            self._program_params = params

        def prefill(toks):
            logits, cache, kv_len = model.prefill(params, {"tokens": toks},
                                                  self._max_len)
            tok = logits[:, :V].argmax(-1).to(torch.int32)
            out = torch.empty((B, self.max_new), dtype=torch.int32,
                              device=model.device)
            out[:, 0] = tok
            return {"cache": cache, "kv_len": kv_len, "tok": tok, "out": out}

        def decode():
            logits, _, kv_len = model.decode_step(params, state["cache"],
                                                  state["tok"], state["kv_len"])
            tok = logits[:, :V].argmax(-1).to(torch.int32)
            # kv_len now counts the cached positions: this token is column kv_len - S
            state["out"].scatter_(1, (kv_len - S).long()[:, None], tok[:, None])
            state["tok"].copy_(tok)
            state["kv_len"].copy_(kv_len)

        pre, dec = ("prefill", B), ("decode", B)
        if not self.programs.ready(dec):
            # First use of B on the card: capture prefill, and replay it so
            # that decode's warm-up and capture read a real state (the
            # replay of prefill below starts the generation afresh).
            state = self.programs.run(pre, prefill, [tokens])
            self.programs.capture(dec, decode)
        state = self.programs.run(pre, prefill, [tokens])
        for _ in range(self.max_new - 1):
            self.programs.run(dec, decode)
        return state["out"].cpu().numpy()

    def _span(self, stage: str, **attrs):
        if self.obs is None:
            return NULL_SPAN
        return self.obs.span(stage, **attrs)

    # ------------------------------------------------------------------ api
    def submit(self, text: str, category: str, prompt_tokens: np.ndarray,
               max_new_tokens: int | None = None) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(
            req_id=rid, text=text, category=category,
            prompt_tokens=np.asarray(prompt_tokens, np.int32),
            max_new_tokens=max_new_tokens or self.max_new,
            arrival=time.monotonic()))
        return rid

    def step(self) -> list[Response]:
        """Serve one batch from the queue. Returns completed responses."""
        if not self.queue:
            return []
        with self._span("engine_step", batch=min(len(self.queue),
                                                 self.max_batch)):
            return self._step_impl()

    def _step_impl(self) -> list[Response]:
        self.watchdog.step_start()
        batch = self.queue[:self.max_batch]
        self.queue = self.queue[self.max_batch:]
        t0 = time.monotonic()

        with self._span("embed", batch=len(batch)):
            embs = self.embedder.embed_batch([r.text for r in batch])
        results = self.cache.lookup_batch(embs, [r.category for r in batch])
        ls = self.cache.last_lookup_stats
        if ls:
            self.stats.search_hops += ls.get("hops", 0)
            self.stats.rows_gathered += ls.get("rows_gathered", 0)

        responses: list[Response] = []
        misses: list[int] = []
        for i, (req, res) in enumerate(zip(batch, results)):
            if res.hit:
                lat = (time.monotonic() - req.arrival) * 1e3
                responses.append(Response(req.req_id, res.response, None,
                                          True, lat, req.category,
                                          reason=res.reason))
                self.stats.served += 1
                self.stats.cache_hits += 1
                self.stats.total_latency_ms += lat
                self.stats.count_reason(res.reason)
            else:
                misses.append(i)

        if misses:
            toks = np.zeros((len(misses), self.prompt_len), np.int32)
            for j, i in enumerate(misses):
                p = batch[i].prompt_tokens[:self.prompt_len]
                toks[j, :len(p)] = p
            with self._span("model_generate", batch=len(misses)):
                out = self._generate(self.params, toks)
            texts = ["tok:" + ",".join(map(str, out[j]))
                     for j in range(len(misses))]
            # one batched write-back for every miss in this step
            self.cache.insert_batch(
                embs[misses], [batch[i].category for i in misses],
                [batch[i].text for i in misses], texts)
            for j, i in enumerate(misses):
                req = batch[i]
                text = texts[j]
                lat = (time.monotonic() - req.arrival) * 1e3
                responses.append(Response(req.req_id, text, out[j], False,
                                          lat, req.category, reason="model"))
                self.stats.served += 1
                self.stats.model_tokens += out.shape[1]
                self.stats.total_latency_ms += lat
                self.stats.count_reason("model")
                if self.controller is not None:
                    self.controller.observe(self.model_name, LoadSignal(
                        latency_ms=lat, queue_depth=len(self.queue)))
        self.watchdog.step_end()
        self.stats.straggler_steps = self.watchdog.straggler_events
        return responses

    def drain(self) -> list[Response]:
        out = []
        while self.queue:
            out.extend(self.step())
        return out
