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
  re-zeroed by every replay, as are the two counters of the experts the
  MoE layers reach (in the prefill, and summed over the decode steps),
  which sit in one buffer after the output;
* **decode**: ``Model.decode_step`` on that cache (written in place) and
  the argmax, which writes the token into its column of the output and
  the token and ``kv_len + 1`` back over the program's own inputs. It is
  replayed ``max_new - 1`` times.

``generate`` runs the two programs; the engine gives it the prompt
tokens alone, a caller of the model facade may add a whisper's audio or
a llava's patches. The tokens come to the host in ONE copy after the
last step, never one per token, and the expert counters with them
(``EngineStats.experts_prefill`` / ``experts_decode``, and the
``model_generate`` span's attributes of the same names). On the CPU the
same programs run eagerly. The programs are the same for every ported
family: a dense or MoE model's cache holds
K/V, an ssm model's (falcon-mamba) its Mamba state, a hybrid one's
(jamba) both, and all take ``kv_len``. An MoE layer's routing keeps
static shapes and never syncs with the host (``models/moe.py``), so it
is captured with the rest. Prompts are fixed at ``prompt_len``, so no
padding token ever enters a recurrence. ``cache`` is a ``SemanticCache``
or the sharded tier's ``ShardedSemanticCache`` (``core/shard.py``).

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

A meshed model (``Model(cfg, dist=...)``, one process a rank) keeps the
reference's shape: one controller with one cache in front of the mesh.
Rank 0's engine holds the cache and runs ``step()``; every other rank's
engine holds none and runs ``follow()``. For each miss batch rank 0
broadcasts its size and prompt tokens, every rank runs ``generate`` on its
rows of it (``Model.rows``), and the tokens come back to every rank in one
gather after the last step; ``close()`` on rank 0 releases the followers.
The other ranks decide nothing themselves: a TTL read at different
instants on each rank would give different miss batches and deadlock the
collectives. Where the model's collectives stage through host memory
(gloo on the card), a decode step syncs with the host and cannot be
captured, so the engine runs its programs eagerly (``graphs=False``,
the reason logged once and kept in ``eager_reason``); graphs for a meshed
model wait for NCCL.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.cache import SemanticCache
from repro_torch.core.embedding import FeatureHashEmbedder
from repro_torch.core.graphs import CapturedProgram
from repro_torch.core.policy import AdaptiveController, LoadSignal
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.fault import StepWatchdog
from repro_torch.models.model import Model
from repro_torch.obs import NULL_SPAN

log = logging.getLogger(__name__)


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
    # experts the MoE layers reached, each layer's distinct experts summed
    # over the layers and the generations: in the prefills, and in the
    # decode steps (counted on the device by the dispatch, read with the
    # tokens' one copy; 0 without experts, and under a mesh).
    experts_prefill: int = 0
    experts_decode: int = 0

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.served if self.served else 0.0

    def count_reason(self, reason: str) -> None:
        self.reasons[reason] = self.reasons.get(reason, 0) + 1


@torch.inference_mode()
def generate(programs: CapturedProgram, model: Model, params, batch: dict,
             max_len: int, max_new: int, *, finite: bool = False, obs=None) -> dict:
    """Greedy generation of ``max_new`` tokens through ``programs``, keyed
    by batch size B. ``batch["tokens"]`` is the (B, T) int32 numpy prompt,
    copied into the prefill program's static input; any other entry (a
    whisper's ``audio``, a llava's ``patches``) is a tensor on the model's
    device that the prefill graph reads at its address. On the card: a
    replay of the prefill graph of this B, then ``max_new - 1`` replays of
    its decode graph, capturing both on first use. Returns the decode
    program's state: ``out`` (B, max_new) int32 tokens on the device,
    ``reached`` (2,) int32, the experts the MoE layers reached in the
    prefill and in the decode steps (each layer's distinct experts, summed
    over the layers and the steps), ``host`` the one buffer holding both
    (``out`` flat, then ``reached``), ``start`` (kv_len after prefill),
    and with ``finite`` a device flag ANDing whether every step's logits
    were finite. Under a mesh
    ``batch["tokens"]`` is the global prompt, of which this rank takes its
    rows (``Model.rows``), any other entry is this rank's rows, and the
    state is this rank's rows. With a ``TraceRecorder`` as ``obs`` every
    replay is a device span (``prefill``, then ``decode`` with its
    ``step``, each with ``batch``), left for the caller's
    ``obs.sync_point()`` after its copy of the tokens; a call that
    captures opens none."""
    V = model.cfg.vocab_size
    tokens = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    kw = {}
    if model.meshed:
        kw = {"batch_size": tokens.shape[0]}
        tokens = np.ascontiguousarray(tokens[model.rows(tokens.shape[0])])
    B = tokens.shape[0]

    def prefill(toks):
        host = torch.zeros(B * max_new + 2, dtype=torch.int32, device=model.device)
        out, reached = host[:B * max_new].view(B, max_new), host[B * max_new:]
        logits, cache, kv_len = model.prefill(params, {"tokens": toks, **extra}, max_len,
                                              reached=reached[:1], **kw)
        tok = logits[:, :V].argmax(-1).to(torch.int32)
        out[:, 0] = tok
        state = {"cache": cache, "kv_len": kv_len, "tok": tok, "out": out,
                 "reached": reached, "host": host, "start": kv_len.clone()}
        if finite:
            state["finite"] = torch.isfinite(logits[:, :V]).all()
        return state

    def decode():
        logits, _, kv_len = model.decode_step(params, state["cache"], state["tok"],
                                              state["kv_len"], reached=state["reached"][1:])
        tok = logits[:, :V].argmax(-1).to(torch.int32)
        # kv_len now counts the cached positions: this token is column kv_len - start
        state["out"].scatter_(1, (kv_len - state["start"]).long()[:, None], tok[:, None])
        state["tok"].copy_(tok)
        state["kv_len"].copy_(kv_len)
        if finite:
            state["finite"].logical_and_(torch.isfinite(logits[:, :V]).all())

    def timed(stage, **attrs):
        if obs is None:
            return NULL_SPAN
        return obs.device_span(stage, model.device, batch=B, **attrs)

    pre, dec = ("prefill", B), ("decode", B)
    if not programs.ready(dec):
        # First use of B on the card: capture prefill, and replay it so
        # that decode's warm-up and capture read a real state (the replay
        # of prefill below starts the generation afresh).
        state = programs.run(pre, prefill, [tokens])
        programs.capture(dec, decode)
        obs = None                      # a capturing call times no replay
    with timed("prefill"):
        state = programs.run(pre, prefill, [tokens])
    for j in range(1, max_new):
        with timed("decode", step=j):
            programs.run(dec, decode)
    return state


class ServingEngine:
    """Queue → embed → cache lookup → model on misses → batched
    write-back. The model runs on its own device (``model.device``).
    Under a mesh rank 0's engine holds the cache and the other ranks'
    hold None and ``follow()`` it (see the module's docstring)."""

    def __init__(self, model: Model, params, cache: SemanticCache | None,
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
        # On the card every graph replay of a generation is also a device
        # span (``prefill``, ``decode``) under ``model_generate``, as the
        # cache's index search is (``search_device`` under ``search``),
        # timed by CUDA events and placed on the recorder's clock at the
        # host copy that follows; without a recorder no event is made.
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
        self.eager_reason = None
        probe = torch.empty(0, device=model.device)
        if model.meshed and coll.stages_through_host(probe):
            self.eager_reason = ("the model's collectives stage through host memory "
                                 "(gloo), so a decode step syncs with the host and "
                                 "cannot be captured: generation runs eagerly")
            log.info("%s: %s", model.cfg.name, self.eager_reason)
        self.programs = CapturedProgram(model.device, graphs=self.eager_reason is None)
        self._program_params = None
        if model.meshed and (cache is None) != (torch.distributed.get_rank() != 0):
            raise ValueError("under a mesh rank 0's engine holds the cache and no "
                             "other rank's does")

    def _generate(self, params, tokens: np.ndarray) -> np.ndarray:
        """Prefill, then greedy decode: (B, S) int32 prompt tokens -> (B,
        new) tokens as numpy, copied to the host once, after the last
        step (``generate``), with the experts the MoE layers reached, which
        ``EngineStats`` sums."""
        if params is not self._program_params:
            self.programs.clear()
            self._program_params = params
        tokens = np.ascontiguousarray(tokens, np.int32)
        if self.model.meshed:
            header = torch.tensor(tokens.shape, dtype=torch.int64)
            coll.broadcast(header)
            coll.broadcast(torch.from_numpy(tokens))
        return self._run(params, tokens)

    def _run(self, params, tokens: np.ndarray) -> np.ndarray:
        state = generate(self.programs, self.model, params, {"tokens": tokens},
                         self._max_len, self.max_new, obs=self.obs)
        if self.model.meshed:           # every rank's rows, on every rank
            from repro_torch.launch.sharding import batch_spec
            dist = self.model.dist
            out = coll.gather_value(state["out"], 0, dist, batch_spec(dist, tokens.shape[0]))
            out, reached = out.cpu().numpy(), (0, 0)
        else:                           # the tokens and the expert counters, one copy
            host = state["host"].cpu().numpy()
            n = state["out"].numel()
            out = host[:n].reshape(state["out"].shape)
            reached = (int(host[n]), int(host[n + 1]))
        if self.obs is not None:        # the copy drained the stream
            self.obs.sync_point()
        self.stats.experts_prefill += reached[0]
        self.stats.experts_decode += reached[1]
        return out

    def follow(self) -> list[np.ndarray]:
        """A follower rank's loop (under a mesh, every rank but 0): each
        miss batch rank 0's engine broadcasts is generated here on this
        rank's rows, until rank 0's ``close()``. Returns every batch's
        (B, new) tokens, in order."""
        generated = []
        while True:
            header = torch.zeros(2, dtype=torch.int64)
            coll.broadcast(header)
            if int(header[0]) == 0:
                return generated
            tokens = torch.zeros(tuple(header.tolist()), dtype=torch.int32)
            coll.broadcast(tokens)
            if self.params is not self._program_params:
                self.programs.clear()
                self._program_params = self.params
            generated.append(self._run(self.params, tokens.numpy()))

    def close(self) -> None:
        """Rank 0 under a mesh: release the followers (a batch of size 0)."""
        if self.model.meshed:
            coll.broadcast(torch.zeros(2, dtype=torch.int64))

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
            with self._span("model_generate", batch=len(misses)) as span:
                pre, dec = self.stats.experts_prefill, self.stats.experts_decode
                out = self._generate(self.params, toks)
                span.set(experts_prefill=self.stats.experts_prefill - pre,
                         experts_decode=self.stats.experts_decode - dec)
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
