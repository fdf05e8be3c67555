"""The hybrid category-aware semantic cache (paper §5, Algorithm 1), in
PyTorch: the counterpart of ``repro.core.cache``.

In-memory index (HNSW or flat) over embeddings + per-slot category metadata;
documents live in an external ``DocumentStore`` reached by primary key only
on fresh, above-threshold hits. Policy enforcement points (§5.4):

    compliance  — before anything (Algorithm 1 line 5): restricted
                  categories never enter the cache, no temporary presence
    threshold   — during traversal (per-query τ vector, §5.3)
    isolation   — during traversal (per-query category vector, §5.3): the
                  index masks results by category, so the best SAME-category
                  match is returned — a nearer cross-category neighbor can
                  route the search but never produce a false miss
    TTL         — after match, BEFORE external fetch (line 18): expired
                  entries evict without wasting a network call
    quota       — at insertion: per-category share of capacity
    eviction    — score = priority × 1/age × hitRate (§5.4); lowest evicted

Extensions implemented from §7.6: hot-document L1 (in-memory docs for the
power-law head → hit latency 7 ms → 2 ms).

**Quantized residency + fp32 re-rank tier.** With ``emb_dtype="int8"``
the device-resident embedding tier is int8 (per-slot symmetric scales,
see core/hnsw.py) — ~4x fewer bytes per sync/gather and ~4x more entries
per quota byte. Mirroring the paper's hybrid split (compact in-memory
search structure vs external document storage), the full-precision fp32
embedding lives NEXT TO the document in the ``DocumentStore``: a device
result whose quantized score lands within the per-category
``rerank_margin`` of τ is exactly re-scored from that stored fp32 copy
before the hit/miss decision — both directions (a borderline "hit" can
demote to a miss, a borderline miss whose best candidate sits just under
τ can promote to a hit). Quantization therefore changes latency only:
the decision for the returned candidate always matches the fp32 oracle.
(Scope: the re-rank covers the ONE best candidate the device search
returns. If two same-category entries' exact scores straddle τ while
sitting within quantization error (~1e-3) of EACH OTHER, the quantized
search may surface the other member of the near-tie — the decision is
then exact for that candidate but can differ from an exact-search
oracle. That needs a near-tie exactly at τ; the τ-boundary property
test pins the guarantee for separated entries.)

The device search is one captured program on the card (a CUDA graph per
batch bucket, ``core/graphs.py``) whose tail packs (idx, score, cls, cand,
hops, rows) into one int32 word buffer; ``lookup_batch`` brings it to the
host in ONE copy, with no launch after the replay. The index runs on the
card unless ``device="cpu"`` is passed.

The write path is batched end-to-end: ``insert_batch`` runs one eviction
scoring pass, one ``store.put_many`` pass and one ``index.add_batch`` pass
for B entries, whose dirty rows coalesce into a single device delta flush
on the next search (see core/hnsw.py device residency). ``insert`` is a
B=1 wrapper — there is only one write path.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.admission import AdmissionController, make_eviction_scorer
from repro_torch.core.clock import Clock, SimClock
from repro_torch.core.faults import StoreTimeout
from repro_torch.core.hnsw import CLS_EXPIRED, CLS_HIT, CLS_MISS, FlatIndex, \
    HNSWIndex, HNSWParams, INVALID
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.policy import PolicyEngine
from repro_torch.core.storage import Document, DocumentStore, InMemoryStore
from repro_torch.obs.trace import NULL_SPAN


@dataclass
class CacheResult:
    hit: bool
    response: str | None = None
    score: float = float("-inf")
    category: str = ""
    slot: int = INVALID
    doc_id: int = INVALID
    reason: str = ""        # "hit" | "hit_l1" | "compliance" | "no_match" | "expired"
    latency_ms: float = 0.0
    meta: dict = field(default_factory=dict)


class SemanticCache:
    """Category-aware hybrid semantic cache.

    ``index_kind``: "hnsw" (default) or "flat" (exact; small caches).
    ``use_device``: route batched lookups through the device search
    (default; the CUDA kernels on the card); False keeps the host numpy
    search. ``device``: where the index tables live — None resolves to
    "cuda" and raises without one; pass "cpu" to run on the CPU.
    ``emb_dtype``: the device-resident embedding dtype — "float32" (the
    exact baseline) or "int8" (quantized residency: ~4x fewer bytes per
    sync/gather, with the fp32 re-rank tier deciding borderline matches
    from the embedding stored next to the document).
    """

    def __init__(self, policies: PolicyEngine, dim: int = 384,
                 capacity: int = 65536, store: DocumentStore | None = None,
                 clock: Clock | None = None, index_kind: str = "hnsw",
                 use_device: bool = True, search_ms: float = 2.0,
                 insert_ms: float = 1.0, l1_capacity: int = 0,
                 seed: int = 0, emb_dtype: str = "float32",
                 quota_capacity: int | None = None,
                 doc_id_start: int = 0, doc_id_step: int = 1,
                 eviction: str = "static",
                 durable_embeddings: bool = False,
                 obs=None, obs_shard: int = 0,
                 device: str | torch.device | None = None):
        self.policies = policies
        # Observability (repro_torch.obs.TraceRecorder or None). When None,
        # every instrumented site goes through the shared no-op span —
        # the empty-recorder parity contract: counters, device bytes
        # and clock charges are bit-identical to the untraced build.
        self.obs = obs
        self._obs_shard = obs_shard
        self.dim = dim
        self.capacity = capacity
        # Quota ceilings are fractions of ``quota_capacity`` (default: the
        # physical capacity). A shard of a ShardedSemanticCache passes the
        # GLOBAL capacity here so a category keeps the same entry ceiling
        # (int(quota · total)) it would have in one unsharded cache, while
        # ``capacity`` stays the shard's own preallocated table size.
        self.quota_capacity = capacity if quota_capacity is None \
            else quota_capacity
        # Doc ids stride so N shards sharing a workload mint disjoint id
        # sequences (shard i starts at i, steps by N) — CacheResult.doc_id
        # stays globally unique without a shared id service.
        self._doc_id_step = doc_id_step
        self.clock = clock or SimClock()
        self.store = store if store is not None else InMemoryStore()
        self.use_device = use_device
        self.search_ms = search_ms
        self.insert_ms = insert_ms
        # Persist the fp32 embedding next to EVERY document, not just
        # under quantized residency: a fault-tolerant tier (sharded cache
        # with an injector wired) needs the store alone to be sufficient
        # to rebuild a dead shard's resident set (outage rebalancing),
        # and the resident index of a down shard is by definition
        # unreachable. Costs store bytes only — no counter, decision or
        # clock charge depends on it.
        self.durable_embeddings = durable_embeddings
        self.metrics = MetricsRegistry()
        # Eviction scorer (core/admission.py): "static" = the §5.4
        # priority × 1/age × hitRate formula (seed behavior, default);
        # "cost_aware" prices slots by expected-hits × miss-cost per
        # resident byte (economics.ResidencyModel).
        self.eviction = eviction
        self._evictor = make_eviction_scorer(eviction)
        # Admission control plane: per-category repetition sketches,
        # lazily built and seeded from the category NAME, so shards of a
        # sharded cache reach identical admission decisions. Consulted
        # only for categories with admit_after > 1 — zero cost otherwise.
        self.admission = AdmissionController(dim)

        if index_kind == "hnsw":
            self.index: HNSWIndex | FlatIndex = HNSWIndex(
                dim, capacity, params=HNSWParams(emb_dtype=emb_dtype),
                seed=seed, device=device)
        elif index_kind == "flat":
            # FlatIndex has a first-class device path too (the flat_topk
            # kernel via ops.cache_topk), so use_device is legal here.
            self.index = FlatIndex(dim, capacity, emb_dtype=emb_dtype,
                                   device=device)
        else:
            raise ValueError(f"unknown index_kind {index_kind!r}")

        # Per-slot metadata (§5.1: ~112 B/entry overhead). The category
        # and insertion-time tables LIVE IN THE INDEX (category is a
        # search input, §5.3; insertion time feeds the on-device TTL
        # classification and rides the same delta-sync protocol);
        # ``slot_category``/``slot_inserted`` alias them so cache-side
        # bookkeeping and the index/device mirror never diverge.
        self.slot_category = self.index.category
        self.slot_inserted = self.index.inserted
        # The inserted table is float32 (the device dtype), whose spacing at epoch-scale absolute times
        # (~1.7e9 s) is minutes. All cache-internal timestamps are
        # therefore REBASED to the cache's construction instant: ages and
        # TTL comparisons only ever see small relative values, so float32
        # keeps sub-millisecond resolution for any realistic clock.
        self._t0 = self.clock.now()
        self.slot_hits = np.zeros(capacity, np.int64)
        self.slot_doc = np.full(capacity, INVALID, np.int64)
        self.slot_valid = np.zeros(capacity, bool)
        self._cat_names: dict[int, str] = {}
        self._next_doc_id = doc_id_start
        # Device-search observability (hops, rows gathered) from the last
        # lookup_batch, materialized at the single host-conversion point.
        self.last_lookup_stats: dict = {}
        # Write-path observability from the last insert_batch: batch
        # size, items past the compliance gate, admission skips.
        self.last_insert_stats: dict = {}

        # §7.6 hot-document L1: doc_id -> response, LRU by insertion order
        # (move-to-end on touch, evict from the front) — O(1) per hit.
        self.l1_capacity = l1_capacity
        self._l1: OrderedDict[int, str] = OrderedDict()

    # ------------------------------------------------------------------ utils
    def __len__(self) -> int:
        return int(self.slot_valid.sum())

    def _now(self) -> float:
        """Cache-relative time (see ``_t0``): what slot_inserted stores
        and every TTL/age comparison uses, host and device alike."""
        return self.clock.now() - self._t0

    def _cat_id(self, name: str) -> int:
        cid = self.policies.category_id(name)
        self._cat_names[cid] = name
        return cid

    def _span(self, stage: str, **attrs):
        """Clock-timed span when a ``TraceRecorder`` is attached; the
        shared no-op span otherwise (tracing off leaves the hot path
        untouched)."""
        if self.obs is None:
            return NULL_SPAN
        return self.obs.span(stage, shard=self._obs_shard, **attrs)

    def _event(self, name: str, **fields) -> None:
        if self.obs is not None:
            self.obs.event(name, shard=self._obs_shard, **fields)

    def category_count(self, name: str) -> int:
        cid = self.policies.category_id(name)
        return int((self.slot_valid & (self.slot_category == cid)).sum())

    # -------------------------------------------------------------- Algorithm 1
    def lookup(self, embedding: np.ndarray, category: str) -> CacheResult:
        return self.lookup_batch(embedding[None, :], [category])[0]

    def lookup_batch(self, embeddings: np.ndarray,
                     categories: Sequence[str]) -> list[CacheResult]:
        """Vectorized Algorithm 1 over a mixed-category batch."""
        with self._span("lookup", batch=int(embeddings.shape[0])):
            return self._lookup_batch_impl(embeddings, categories)

    def _lookup_batch_impl(self, embeddings: np.ndarray,
                           categories: Sequence[str]) -> list[CacheResult]:
        B = embeddings.shape[0]
        assert len(categories) == B
        now = self._now()
        self.last_lookup_stats = {}
        results: list[CacheResult] = [None] * B  # type: ignore[list-item]
        rerank_docs: dict[int, Document] = {}   # docs the re-rank fetched

        # Line 4-7: per-category config + compliance gate.
        effective = [self.policies.effective(c) for c in categories]
        active = [i for i in range(B) if effective[i].allow_caching]
        for i in range(B):
            st = self.metrics.cat(categories[i])
            st.lookups += 1
            if not effective[i].allow_caching:
                st.compliance_rejects += 1
                st.misses += 1
                results[i] = CacheResult(False, category=categories[i],
                                         reason="compliance")
        if not active:
            return results

        # Line 9-11: search with per-query thresholds AND categories DURING
        # traversal (§5.3). The index masks results by category, so the
        # returned neighbor is the best SAME-category match — a globally
        # nearer cross-category entry can route traffic but never shadows a
        # valid match (the seed's "category_mismatch" false-miss path is
        # gone by construction).
        # Span "search" covers the search-latency charge, the index
        # traversal and the single device→host sync; the fp32 re-rank
        # tier gets a SIBLING span so its borderline store fetches are
        # attributed separately from the traversal.
        with self._span("search", batch=len(active)):
            self.clock.advance(self.search_ms / 1e3)
            q = embeddings[active]
            taus = np.asarray([effective[i].threshold for i in active],
                              np.float32)
            qcats = np.asarray([self._cat_id(categories[i]) for i in active],
                               np.int32)
            ttls = np.asarray([effective[i].ttl for i in active], np.float64)
            if self.use_device:
                # Line 12-21 classification runs INSIDE the device search
                # (the synced ``inserted`` table + per-query TTL/now), so
                # the only host sync is this single copy — the Python
                # below then touches actual hits (doc fetch) and
                # expirations (evict), not all B results.
                self.index.search_classified(q, taus, categories=qcats,
                                             ttls=ttls, now=now)
                ls = self.index.last_search
                res = self.index.last_search_host()
                idxs = np.asarray(res["idx"], np.int64)
                scores = np.asarray(res["score"], np.float64)
                cls = np.array(res["cls"])  # writable: the re-rank tier may edit
                cands, hops, rows = res["cand"], res["hops"], res["rows_gathered"]
            else:
                idxs, scores = self.index.search_host(q, taus,
                                                      categories=qcats)
                # Host path: same vectorized classification in numpy.
                idxs = np.asarray(idxs, np.int64)
                scores = np.asarray(scores, np.float64)
                safe = np.maximum(idxs, 0)
                found = (idxs != INVALID) & self.slot_valid[safe]
                expired = found & ((now - self.slot_inserted[safe]) > ttls)
                cls = np.where(expired, CLS_EXPIRED,
                               np.where(found, CLS_HIT, CLS_MISS))
        if self.use_device:
            reranks = 0
            if self.index.quantized:
                # The fp32 re-rank tier: borderline quantized scores are
                # re-decided against the exact embedding stored next to
                # the document (may rewrite idxs/scores/cls in place;
                # fetched docs land in rerank_docs so a promoted hit
                # does not fetch the same document twice).
                with self._span("rerank", batch=len(active)):
                    reranks = self._rerank_boundary(
                        q, idxs, scores, cls, np.asarray(cands, np.int64),
                        taus, ttls, now, [effective[i] for i in active],
                        [categories[i] for i in active], rerank_docs)
            row_bytes = ls.get("gather_row_nbytes",
                               self.index.emb_row_nbytes())
            self.last_lookup_stats = {
                "batch": len(active), "hops": int(hops),
                "rows_gathered": int(np.sum(rows)),
                "gathered_bytes": int(np.sum(rows)) * row_bytes,
                "emb_dtype": self.index.emb_dtype,
                "reranks": reranks}
        hit = cls == CLS_HIT
        np.add.at(self.slot_hits, idxs[hit], 1)   # duplicate slots accumulate

        for pos, i in enumerate(active):
            cat = categories[i]
            st = self.metrics.cat(cat)
            slot, score = int(idxs[pos]), float(scores[pos])

            # Line 12-14: miss → return immediately, no external access.
            if cls[pos] == CLS_MISS:
                st.misses += 1
                results[i] = CacheResult(False, score=score, category=cat,
                                         reason="no_match",
                                         latency_ms=self.search_ms)
                continue

            # Line 18-21: TTL validated BEFORE the external fetch. Duplicate
            # matches of one slot within a batch evict (and count) once.
            if cls[pos] == CLS_EXPIRED:
                if self.slot_valid[slot]:
                    self._evict_slot(slot, reason="ttl")
                    st.ttl_evictions += 1
                st.misses += 1
                results[i] = CacheResult(False, score=score, category=cat,
                                         reason="expired",
                                         latency_ms=self.search_ms)
                continue

            # Line 23-25: fetch by ID (L1 first — §7.6 extension).
            doc_id = int(self.slot_doc[slot])
            st.hits += 1
            if doc_id in self._l1:
                self._l1_touch(doc_id)
                results[i] = CacheResult(True, response=self._l1[doc_id],
                                         score=score, category=cat, slot=slot,
                                         doc_id=doc_id, reason="hit_l1",
                                         latency_ms=self.search_ms)
                continue
            try:
                doc = rerank_docs.get(doc_id)
                if doc is None:
                    # A StoreTimeout raised inside the span still closes
                    # it (context-manager unwind) before the rollback.
                    with self._span("store_fetch", category=cat):
                        doc = self.store.get(doc_id)
            except StoreTimeout:
                # Retry budget exhausted on a transient store fault: the
                # would-be hit degrades to a served-from-model miss. The
                # entry STAYS resident (unlike missing_doc — the data is
                # not lost, the store is slow) and the hit bookkeeping
                # rolls back so counters match the serving outcome.
                st.store_timeouts += 1
                self._event("store_timeout", category=cat)
                st.misses += 1
                st.hits -= 1
                self.slot_hits[slot] -= 1
                results[i] = CacheResult(False, score=score, category=cat,
                                         reason="store_timeout",
                                         latency_ms=self.search_ms)
                continue
            if doc is None:   # store lost the doc (crash recovery): treat as miss
                self._evict_slot(slot, reason="missing_doc")
                st.misses += 1
                st.hits -= 1
                self.slot_hits[slot] -= 1
                results[i] = CacheResult(False, score=score, category=cat,
                                         reason="missing_doc",
                                         latency_ms=self.search_ms)
                continue
            self._l1_maybe_promote(doc_id, doc.response, self.slot_hits[slot])
            results[i] = CacheResult(True, response=doc.response, score=score,
                                     category=cat, slot=slot, doc_id=doc_id,
                                     reason="hit", latency_ms=self.search_ms)
        return results

    # --------------------------------------------------------- fp32 re-rank tier
    def _exact_score(self, query: np.ndarray, slot: int,
                     doc_cache: dict) -> float:
        """Exact fp32 score of one candidate slot: the embedding stored
        next to the document (the external tier's ground truth), falling
        back to the index's host fp32 control-plane row if the store
        copy is missing (crash recovery).

        This is one keyed ``store.get`` — on latency-modeled stores the
        clock advances like any fetch, and it happens even when the
        re-rank resolves to a MISS. That is the re-rank tier's one
        deliberate exception to Algorithm 1's "miss → no external
        access": only borderline queries (|score − τ| ≤ margin, rare by
        construction) pay it, in exchange for exact decisions at the
        boundary. The fetched doc lands in ``doc_cache`` so a promoted
        hit serves its response without a second fetch.
        ``CacheResult.latency_ms`` stays the search cost (as it does for
        ordinary hit fetches); the clock and the ``reranks`` counters
        carry the fetch accounting."""
        emb = None
        doc_id = int(self.slot_doc[slot])
        if doc_id != INVALID:
            try:
                doc = self.store.get(doc_id)
            except StoreTimeout:
                # Transient store fault mid-re-rank: the host fp32
                # control-plane row is the same exact embedding, so the
                # decision stays exact without the external fetch.
                doc = None
            if doc is not None:
                doc_cache[doc_id] = doc
                emb = doc.embedding_array()
        if emb is None:
            emb = self.index.emb[slot]
        return float(np.asarray(query, np.float32) @ emb)

    def _rerank_boundary(self, q: np.ndarray, idxs: np.ndarray,
                         scores: np.ndarray, cls: np.ndarray,
                         cands: np.ndarray, taus: np.ndarray,
                         ttls: np.ndarray, now: float,
                         effs: list, cats: list[str],
                         doc_cache: dict) -> int:
        """Re-decide borderline quantized results against fp32 (mutates
        idxs/scores/cls in place; returns the re-score count).

        A query is borderline when its best same-category candidate's
        quantized score lands within the category's ``rerank_margin`` of
        its τ — on EITHER side, so both false hits (quantized score
        crept over τ) and false misses (crept under) are corrected. The
        margin need only cover the int8 error (~1e-3 for unit rows), so
        re-scores stay rare; the decision then exactly matches the fp32
        oracle, with the TTL check reapplied to promoted hits."""
        n = 0
        for pos in range(len(cands)):
            margin = effs[pos].rerank_margin
            slot = int(cands[pos])
            if margin <= 0.0 or slot == INVALID or not self.slot_valid[slot]:
                continue
            if abs(float(scores[pos]) - float(taus[pos])) > margin:
                continue
            exact = self._exact_score(q[pos], slot, doc_cache)
            st = self.metrics.cat(cats[pos])
            st.reranks += 1
            n += 1
            hit = exact >= float(taus[pos])
            if hit != (cls[pos] != CLS_MISS):
                st.rerank_flips += 1
            scores[pos] = exact
            if hit:
                expired = (now - self.slot_inserted[slot]) > ttls[pos]
                cls[pos] = CLS_EXPIRED if expired else CLS_HIT
                idxs[pos] = slot
            else:
                cls[pos] = CLS_MISS
                idxs[pos] = INVALID
        return n

    # ------------------------------------------------------------------ insert
    def insert(self, embedding: np.ndarray, category: str, request: str,
               response: str, meta: dict | None = None) -> int:
        """Insert one (query → response) pair. Returns slot id or INVALID.

        Thin wrapper over ``insert_batch`` — the batched write path is the
        ONLY write path, so single inserts and batch inserts share policy
        enforcement, store writes and the index delta log.
        """
        return self.insert_batch(np.asarray(embedding)[None, :], [category],
                                 [request], [response], [meta])[0]

    def insert_batch(self, embeddings: np.ndarray,
                     categories: Sequence[str], requests: Sequence[str],
                     responses: Sequence[str],
                     metas: Sequence[dict | None] | None = None) -> list[int]:
        """Insert B (query → response) pairs in one write round.

        Enforcement matches the sequential semantics item by item —
        compliance pre-insertion (§5.4: restricted categories never create
        temporary data presence), per-category quota, global capacity
        eviction by economic score — but the batch pays batched costs:

        * ONE eviction-scoring pass (§5.4 score = priority × 1/age ×
          hitRate) over the live slots, updated incrementally as victims
          fall, instead of a per-item rescore;
        * ONE ``store.put_many`` pass for all accepted documents;
        * ONE index write pass (``index.add_batch``) whose touched rows
          coalesce into a single device delta flush on the next search.

        Returns a slot id per item; INVALID for compliance-rejected items
        and for items evicted *within the batch* by a later item's quota or
        capacity pressure (they count as inserted-then-evicted in metrics,
        matching the sequential path, but never touch the store or index).
        """
        embeddings = np.atleast_2d(np.asarray(embeddings, np.float32))
        with self._span("insert", batch=int(embeddings.shape[0])):
            return self._insert_batch_impl(embeddings, categories,
                                           requests, responses, metas)

    def _insert_batch_impl(self, embeddings, categories, requests,
                           responses, metas) -> list[int]:
        B = embeddings.shape[0]
        metas = list(metas) if metas is not None else [None] * B
        if not (len(categories) == len(requests) == len(responses)
                == len(metas) == B):
            raise ValueError("insert_batch: ragged batch")
        slots_out = [INVALID] * B

        # Compliance gate (one policy resolution per distinct category).
        eff = {c: self.policies.effective(c) for c in dict.fromkeys(categories)}
        admitted = []
        for i, c in enumerate(categories):
            if not eff[c].allow_caching or eff[c].quota <= 0.0:
                self.metrics.cat(c).insert_rejects += 1
            else:
                admitted.append(i)
        if not admitted:
            self.last_insert_stats = {"batch": B, "admitted": 0,
                                      "admission_skips": 0,
                                      "insert_rejects": B}
            return slots_out

        # Span "gate": the batched write-round charge plus the admission
        # sketch pass — everything that decides WHAT gets to spend quota.
        with self._span("gate", batch=len(admitted)):
            self.clock.advance(self.insert_ms / 1e3)  # one batched write round
            now = self._now()
            cids = {c: self._cat_id(c) for c in eff}

            # Admission gate (core/admission.py): a category with
            # admit_after > 1 only caches a miss once its canonical key has
            # repeated enough in the per-category sketch. The repetition
            # test reuses the category's OWN similarity threshold — "would
            # this query have hit, had we cached its earlier occurrence?" —
            # so gate and cache agree on what a repeat is. Skipped items
            # return INVALID and count as admission_skips — they were still
            # misses upstream (lookup already counted them), they just don't
            # spend quota bytes. The observed repetition count feeds the
            # fresh-entry eviction prior for items that DO land.
            freq: dict[int, int] = {}
            gated: list[int] = []
            # One batched ring-buffer/sketch pass per gated category (stream
            # order preserved; trackers are per-category, so grouping by
            # category is observation-order-equivalent to the item loop —
            # and a sharded front door routes a category wholly to one
            # shard, so the per-category groups are identical across
            # topologies, keeping single-vs-sharded parity exact).
            by_cat: dict[str, list[int]] = {}
            for i in admitted:
                c = categories[i]
                if eff[c].admit_after > 1:
                    by_cat.setdefault(c, []).append(i)
            counts: dict[int, int] = {}
            for c, items in by_cat.items():
                cnts = self.admission.observe_batch(c, embeddings[items],
                                                    tau=eff[c].threshold)
                counts.update(zip(items, (int(x) for x in cnts)))
            for i in admitted:
                c = categories[i]
                k = eff[c].admit_after
                if k > 1:
                    cnt = counts[i]
                    if cnt < k:
                        self.metrics.cat(c).admission_skips += 1
                        continue
                    freq[i] = cnt
                gated.append(i)
        self.last_insert_stats = {
            "batch": B, "admitted": len(gated),
            "admission_skips": len(admitted) - len(gated),
            "insert_rejects": B - len(admitted)}
        if not gated:
            return slots_out
        admitted = gated

        # Occupancy bookkeeping is one cheap pass; the eviction SCORING
        # pass (+inf marks non-candidates so victim selection is a masked
        # argmin, updated as evictions land) is built lazily — a batch
        # under no quota/capacity pressure never pays it.
        live_mask = self.slot_valid.copy()
        cat_snapshot = self.slot_category.copy()
        cat_counts = {cid: int((live_mask & (cat_snapshot == cid)).sum())
                      for cid in cids.values()}
        live_count = int(live_mask.sum())
        scores: np.ndarray | None = None

        def ensure_scores() -> np.ndarray:
            nonlocal scores
            if scores is None:
                scores = np.full(self.capacity, np.inf, np.float64)
                live = np.where(live_mask)[0]
                if live.size:
                    scores[live] = self._entry_score(live)
            return scores

        # pending: admitted items not yet materialized, as (batch_i, cid,
        # score) — a fresh entry's score comes from the active scorer's
        # ``fresh_score`` (static: pri × 1/age_clamp × 1; cost-aware:
        # sketch-repetition prior × miss-cost / bytes), so a later item's
        # quota pressure can evict an earlier batch item exactly like the
        # sequential path would.
        pending: list[list] = []
        pending_counts: dict[int, int] = {}

        def evict_existing(slot: int, reason: str) -> int:
            nonlocal live_count
            vic_cid = int(cat_snapshot[slot])
            self._evict_slot(slot, reason=reason)
            live_mask[slot] = False
            ensure_scores()[slot] = np.inf
            cat_counts[vic_cid] = cat_counts.get(vic_cid, 1) - 1
            live_count -= 1
            return vic_cid

        def pick_victim(cid: int | None):
            """Lowest-score candidate among live slots (optionally one
            category) and pending batch items. Returns (slot, pending_pos);
            exactly one is valid (INVALID / -1 for the other)."""
            s = ensure_scores()
            mask = live_mask if cid is None else \
                live_mask & (cat_snapshot == cid)
            cand = np.where(mask)[0]
            best_slot, best_score = INVALID, np.inf
            if cand.size:
                j = int(np.argmin(s[cand]))
                best_slot = int(cand[j])
                best_score = float(s[best_slot])
            best_pos = -1
            for pos, (_, p_cid, p_score) in enumerate(pending):
                if cid is not None and p_cid != cid:
                    continue
                if p_score < best_score:
                    best_pos, best_score = pos, p_score
                    best_slot = INVALID
            return best_slot, best_pos

        def drop_pending(pos: int, reason_counter: str) -> None:
            """A batch item fell to a later item's pressure before ever
            reaching the index: account it as inserted-then-evicted (the
            sequential outcome) without a store/index round trip."""
            p_i, p_cid, _ = pending.pop(pos)
            pending_counts[p_cid] -= 1
            p_st = self.metrics.cat(categories[p_i])
            p_st.inserts += 1
            setattr(p_st, reason_counter,
                    getattr(p_st, reason_counter) + 1)

        # Span "evict": quota/capacity victim selection for the batch.
        with self._span("evict", batch=len(admitted)):
            for i in admitted:
                c = categories[i]
                e = eff[c]
                cid = cids[c]
                st = self.metrics.cat(c)
                cat_quota = int(e.quota * self.quota_capacity)
                n_cat = cat_counts.get(cid, 0) + pending_counts.get(cid, 0)
                if n_cat >= max(1, cat_quota):
                    slot, pos = pick_victim(cid)
                    if slot != INVALID:
                        evict_existing(slot, "quota")
                        st.quota_evictions += 1
                    elif pos >= 0:
                        # seed attributes quota evictions to the inserting
                        # category — here victim and inserter share it
                        drop_pending(pos, "quota_evictions")
                if live_count + len(pending) >= self.capacity:
                    slot, pos = pick_victim(None)
                    if slot != INVALID:
                        vic_cat = self._cat_names.get(evict_existing(
                            slot, "capacity"), "?")
                        self.metrics.cat(vic_cat).capacity_evictions += 1
                    elif pos >= 0:
                        drop_pending(pos, "capacity_evictions")
                pending.append([i, cid,
                                self._evictor.fresh_score(self, cid,
                                                          freq.get(i, 1))])
                pending_counts[cid] = pending_counts.get(cid, 0) + 1

        if not pending:
            return slots_out

        # One store pass, one index pass; the index's dirty rows coalesce
        # into a single device delta flush on the next search_batch.
        # Persisted documents keep ABSOLUTE clock time: the rebased ``now``
        # exists only for the float32 index table, and a restart-durable
        # store must not serialize timestamps relative to this process's
        # private _t0.
        # Span "write": the store pass + index pass (store put retries
        # charge their backoff inside this span).
        with self._span("write", items=len(pending)):
            created_at = self.clock.now()
            docs = []
            for p_i, _, _ in pending:
                doc_id = self._next_doc_id
                self._next_doc_id += self._doc_id_step
                # Under quantized residency the fp32 embedding travels WITH
                # the document (external tier): the re-rank tier's exact
                # copy. The fp32 index already IS exact, so its documents
                # skip the duplicate (~4·dim bytes/doc).
                emb = (embeddings[p_i].copy()
                       if self.index.quantized or self.durable_embeddings
                       else None)
                docs.append(Document(doc_id, requests[p_i], responses[p_i],
                                     created_at, categories[p_i],
                                     metas[p_i] or {}, embedding=emb))
            self.store.put_many(docs)
            order = [p_i for p_i, _, _ in pending]
            # The index owns the category table (slot_category aliases it).
            slots = self.index.add_batch(
                embeddings[order],
                np.asarray([cid for _, cid, _ in pending], np.int32))
            for (p_i, _, _), slot, doc in zip(pending, slots, docs):
                slot = int(slot)
                self.slot_inserted[slot] = now
                self.slot_hits[slot] = 0
                self.slot_doc[slot] = doc.doc_id
                self.slot_valid[slot] = True
                self.metrics.cat(categories[p_i]).inserts += 1
                slots_out[p_i] = slot
            return slots_out

    # ---------------------------------------------------------------- migration
    def adopt_entries(self, embeddings: np.ndarray,
                      categories: Sequence[str], inserted: np.ndarray,
                      hits: np.ndarray,
                      docs: Sequence[Document]) -> list[tuple[int, int]]:
        """Materialize fully-formed entries exported from another shard
        (core/shard.py live migration): the fp32 rows re-enter through
        ``index.add_batch`` (graph wiring + dirty log + deterministic
        requantization, so the int8+scale mirror comes out bit-identical
        to the source's), while ``inserted`` timestamps and hit counts
        are PRESERVED — ages, TTL expiry and eviction scores carry over
        unchanged. Documents are re-minted under this cache's doc-id
        sequence with their payloads (request/response/meta/created_at/
        fp32 embedding) intact.

        Deliberately bypasses the compliance/quota gates and the metrics
        counters: a migration is a move of already-admitted entries, not
        new traffic, and the category's quota ceiling is a fraction of
        the shared ``quota_capacity`` — the same ceiling that admitted
        the entries at their source. Returns (slot, doc_id) per entry.
        """
        embeddings = np.atleast_2d(np.asarray(embeddings, np.float32))
        B = embeddings.shape[0]
        if not (len(categories) == len(inserted) == len(hits)
                == len(docs) == B):
            raise ValueError("adopt_entries: ragged batch")
        # All-or-nothing: fail BEFORE touching the index/store when the
        # batch cannot physically fit, so a migration step that hits a
        # full target aborts with both shards unchanged.
        avail = self.capacity - self.index._n + len(self.index._free)
        if B > avail:
            raise RuntimeError(
                f"adopt_entries: {B} entries exceed the {avail} free "
                f"slots (shard_capacity {self.capacity}) — free space "
                f"on the target or migrate in smaller batches")
        cids = np.asarray([self._cat_id(c) for c in categories], np.int32)
        slots = self.index.add_batch(embeddings, cids)
        new_docs, out = [], []
        for k, slot in enumerate(int(s) for s in slots):
            d = docs[k]
            doc_id = self._next_doc_id
            self._next_doc_id += self._doc_id_step
            new_docs.append(Document(doc_id, d.request, d.response,
                                     d.created_at, d.category, dict(d.meta),
                                     embedding=d.embedding))
            # Rows are already dirty from add_batch, so the preserved
            # timestamp rides the same delta flush as the embedding.
            self.slot_inserted[slot] = float(inserted[k])
            self.slot_hits[slot] = int(hits[k])
            self.slot_doc[slot] = doc_id
            self.slot_valid[slot] = True
            out.append((slot, doc_id))
        self.store.put_many(new_docs)
        return out

    def category_slots(self, name: str) -> np.ndarray:
        """Live slots currently holding ``name``'s entries (the unit a
        shard migration drains)."""
        cid = self.policies.category_id(name)
        return np.where(self.slot_valid & (self.slot_category == cid))[0]

    def doc_id_of(self, slot: int) -> int:
        """Doc id behind a slot returned by lookup/insert (INVALID for
        empty slots AND for slot == INVALID itself — never numpy
        negative indexing). ShardedSemanticCache overrides the slot
        encoding, so callers that branch on doc ids use this instead of
        indexing ``slot_doc`` directly."""
        return int(self.slot_doc[slot]) if slot >= 0 else INVALID

    def replica_doc_ids(self, slot: int) -> list[int]:
        """All doc ids that can serve the entry behind ``slot`` — just
        the slot's own doc here; the sharded cache overrides this with
        the full replica set so callers tracking per-doc ground truth
        (the simulator) cover hits served from any replica."""
        d = self.doc_id_of(slot)
        return [d] if d != INVALID else []

    @property
    def sync_stats(self) -> dict:
        """The index's device-sync accounting (uniform with the sharded
        cache's aggregated view)."""
        return dict(self.index.sync_stats)

    # ----------------------------------------------------------------- eviction
    def _per_category_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Dense cid → (effective TTL, priority) lookup tables.

        O(#categories) to build, then slot-level policy reads are pure
        numpy indexing — the per-slot Python policy resolution the seed did
        in ``_entry_score``/``sweep_expired`` loops is gone.
        """
        n = (max(self._cat_names) + 1) if self._cat_names else 0
        ttl = np.full(n, np.inf, np.float64)
        pri = np.ones(n, np.float64)
        for cid, name in self._cat_names.items():
            eff = self.policies.effective(name)
            ttl[cid] = eff.ttl
            pri[cid] = eff.priority
        return ttl, pri

    def _entry_score(self, slots: np.ndarray) -> np.ndarray:
        """Entry value under the active eviction scorer (higher = more
        valuable; the lowest-scored candidate evicts). ``static`` is the
        §5.4 priority × 1/age × hitRate formula; ``cost_aware`` prices
        slots by expected-hits × miss-cost per resident byte
        (core/admission.py). Vectorized over ``slots``."""
        return self._evictor.score(self, slots)

    def _evict_slot(self, slot: int, reason: str = "") -> None:
        if not self.slot_valid[slot]:
            return
        if self.obs is not None:
            self._event("eviction", reason=reason,
                        category=self._cat_names.get(
                            int(self.slot_category[slot]), "?"))
        self.index.remove(slot)   # also resets the (aliased) category entry
        doc_id = int(self.slot_doc[slot])
        self.store.delete(doc_id)
        self._l1.pop(doc_id, None)
        self.slot_valid[slot] = False
        self.slot_doc[slot] = INVALID

    def sweep_expired(self) -> int:
        """Background TTL sweep (complement to lookup-time validation).

        Expiry detection is vectorized: one numpy compare over all valid
        slots against the per-category TTL table; Python only touches the
        (typically few) slots actually being evicted.
        """
        now = self._now()
        slots = np.where(self.slot_valid)[0]
        if slots.size == 0:
            return 0
        ttl_by_cid, _ = self._per_category_arrays()
        ttl = ttl_by_cid[self.slot_category[slots]]
        expired = slots[(now - self.slot_inserted[slots]) > ttl]
        for slot in expired:
            cat = self._cat_names.get(int(self.slot_category[slot]),
                                      "__default__")
            self._evict_slot(int(slot), reason="ttl_sweep")
            self.metrics.cat(cat).ttl_evictions += 1
        return int(expired.size)

    # ----------------------------------------------------------------- L1 docs
    def _l1_touch(self, doc_id: int) -> None:
        self._l1.move_to_end(doc_id)

    def _l1_maybe_promote(self, doc_id: int, response: str, hits: int) -> None:
        if self.l1_capacity <= 0 or hits < 2:
            return
        if doc_id not in self._l1 and len(self._l1) >= self.l1_capacity:
            self._l1.popitem(last=False)        # evict LRU
        self._l1[doc_id] = response
        self._l1.move_to_end(doc_id)

    # ----------------------------------------------------------------- reports
    def memory_report(self) -> dict:
        """§5.1/§7.4 accounting: bytes/entry in-memory vs externalized.

        ``in_memory_bytes_per_entry`` prices the RESIDENT (device/search)
        tier — the paper's compact in-memory structure, and what the
        delta sync moves and a device HBM budget holds: fp32 rows, or
        int8 rows + the fp32 scale word under quantized residency (the
        ~4x shrink that quadruples entries per byte of quota). The host
        CONTROL PLANE is priced separately (``host_bytes_per_entry``):
        it always keeps the fp32 rows for graph wiring/exact search, so
        under int8 residency host RAM per entry is fp32 + the quantized
        mirror — quantization shrinks the device tier, not host numpy."""
        n = max(1, len(self))
        emb_bytes = self.index.emb_row_nbytes()
        # Host numpy: the fp32 row always, + the int8/scale mirror when
        # the resident tier is quantized.
        host_emb_bytes = self.dim * 4 + \
            (emb_bytes if self.index.quantized else 0)
        graph_bytes = 0
        if isinstance(self.index, HNSWIndex):
            graph_bytes = sum(nb.shape[1] * 4 for nb in self.index.neighbors)
        overhead = 16 + 64 + 32   # id map + category metadata + statistics
        doc_bytes = (self.store.total_bytes() // n
                     if isinstance(self.store, InMemoryStore) and len(self.store) else 0)
        return {
            "entries": len(self),
            "emb_dtype": self.index.emb_dtype,
            "in_memory_bytes_per_entry": emb_bytes + graph_bytes + overhead,
            "host_bytes_per_entry": host_emb_bytes + graph_bytes + overhead,
            "embedding_bytes": emb_bytes,
            "graph_bytes": graph_bytes,
            "metadata_overhead_bytes": overhead,
            "external_doc_bytes_per_entry": doc_bytes,
        }

    def category_memory_report(self) -> dict:
        """Per-category residency: entries held, resident bytes, the
        category's quota ceiling in entries (quota × capacity) and the
        headroom left under it — the §5.4 quota math in byte terms, per
        the active ``emb_dtype`` (int8 residency ~4x-ens entries/byte)."""
        rep = self.memory_report()
        per_entry = rep["in_memory_bytes_per_entry"]
        out: dict[str, dict] = {}
        for cid, name in sorted(self._cat_names.items()):
            n_cat = int((self.slot_valid & (self.slot_category == cid)).sum())
            quota = self.policies.effective(name).quota
            quota_entries = int(quota * self.quota_capacity)
            out[name] = {
                "entries": n_cat,
                "resident_bytes": n_cat * per_entry,
                "bytes_per_entry": per_entry,
                "quota_entries": quota_entries,
                "quota_headroom_entries": max(0, quota_entries - n_cat),
            }
        return out
