"""Discrete-event serving simulator (reproduces the paper's tables), in
PyTorch's package: the counterpart of ``repro.serving.simulator``.

Runs a category-heterogeneous query stream (``repro_torch.core.workload``) against
one of three serving stacks on a simulated clock:

    "hybrid" — the paper's architecture: local in-memory HNSW/flat search
               (2 ms), external doc fetch on hit (5 ms), Algorithm 1 policy
               enforcement, category-aware thresholds/TTLs/quotas
    "vdb"    — the baseline: remote vector DB (30 ms search hit-or-miss,
               post-search collection-level threshold, server-side TTL)
    "none"   — no cache: every query pays T_llm

Cache writes go through the unified batched write path
(``SemanticCache.insert_batch``, B=1 per simulated miss) and, with
``use_device`` (the default), lookups sync the device-resident index
per-delta; the per-run sync accounting is surfaced as
``SimResult.index_sync``. The indexes (the hybrid cache's and the vector
DB's) live on the card unless ``SimConfig.device`` is ``"cpu"``.

Ground truth from the workload generator gives true hit-correctness
(matched intent == query intent → else false positive) and staleness
(content version advanced since caching). Model load can be driven by an
exogenous α(t) profile; observed latencies feed the ``AdaptiveController``
when adaptive policies are enabled (§7.5).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.cache import SemanticCache
from repro_torch.core.clock import SimClock
from repro_torch.core.economics import ResidencyModel
from repro_torch.core.faults import FaultInjector, FaultSchedule
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.policy import AdaptiveController, LoadSignal, PolicyEngine
from repro_torch.core.shard import ShardedSemanticCache
from repro_torch.core.storage import (Document, FlakyStore, InMemoryStore,
                                RetryingStore, VectorDBEmulator)
from repro_torch.core.workload import Query, WorkloadGenerator
from repro_torch.obs import NULL_SPAN, LatencyHistogram, TraceRecorder


@dataclass
class SimConfig:
    architecture: str = "hybrid"        # hybrid | vdb | none
    cache_capacity: int = 20000
    index_kind: str = "hnsw"            # hybrid only: hnsw | flat
    use_device: bool = True             # hybrid: device-resident search
                                        # (beam search / flat_topk kernel)
    device: str | None = None           # where the indexes live: None = the
                                        # card, "cpu" for the plain versions
    n_shards: int = 1                   # hybrid: >1 = ShardedSemanticCache
                                        # (quota-byte planner placement)
    search_ms: float = 2.0
    fetch_ms: float = 5.0
    insert_ms: float = 1.0
    vdb_search_ms: float = 30.0
    vdb_threshold: float = 0.85
    vdb_ttl_s: float = 3600.0
    eviction: str = "static"            # hybrid: static | cost_aware
                                        # (core/admission.py scorers)
    adaptive: bool = False
    fp_rate_limit: float = 0.05     # §7.5.6 safety (1.0 disables feedback)
    # exogenous load profile: list of (t_start_s, t_end_s, model, alpha)
    load_spikes: list = field(default_factory=list)
    l1_capacity: int = 0
    seed: int = 0
    # hybrid fault injection (core/faults.py). None = no injector at all
    # — construction is identical to the pre-fault code path, which the
    # bench_faults baseline gate relies on. A FaultSchedule (even an
    # empty one) wires the injector + store retry stack in.
    fault_schedule: FaultSchedule | None = None
    store_retries: int = 3              # RetryingStore bounded attempts
    store_backoff_ms: float = 1.0       # base of the 2^k backoff ladder
    # sharded hybrid only: head-category replication ({cat: k} map or a
    # quota-mass threshold float) and the sustained-outage threshold
    # that triggers OutageRebalance for unreplicated categories. None /
    # None keeps the cache construction identical to the pre-replication
    # path (the bench_faults baseline gate relies on it).
    replication: dict | float | None = None
    rebalance_after_s: float | None = None
    store_budget_ms: float = 50.0       # per-op cumulative latency budget
    write_behind_capacity: int = 1024   # per-shard outage write queue
    # deterministic tracing (repro.obs): wire a TraceRecorder through
    # the whole stack (cache, shards, stores, injector). False keeps
    # every component on the shared NULL_SPAN no-op path — counters and
    # device bytes are bit-identical to the pre-tracing code (the
    # bench_faults parity gate relies on it, same discipline as an
    # absent FaultSchedule).
    trace: bool = False


@dataclass
class SimResult:
    per_category: dict
    overall_hit_rate: float
    mean_latency_ms: float
    p95_latency_ms: float
    model_calls: dict
    model_cost: float
    stale_served: int
    false_positives: int
    n_queries: int
    traffic_to_models: dict              # per model, query counts
    metrics: MetricsRegistry
    # hybrid only: device-sync accounting (full vs delta uploads, bytes
    # moved; summed across shards with a per_shard breakdown when
    # n_shards > 1) — the data-plane cost "Rethinking Caching" argues
    # decides viability alongside hit rate
    index_sync: dict | None = None
    # hybrid only: residency efficiency — mean resident entries sampled
    # once per query (a deterministic counter integral, not wall clock)
    # and hits per resident MB under the ResidencyModel's bytes/entry.
    # This is the unit admission control optimizes: the same hits out of
    # fewer resident bytes (benchmarks/bench_admission.py gates on it).
    mean_resident_entries: float = 0.0
    hits_per_resident_mb: float = 0.0
    # hybrid + fault injection only: availability/degraded accounting —
    # degraded_misses, store_timeouts, write-behind queue counters and
    # the injector's op/visit tallies. None when no injector is wired.
    fault_stats: dict | None = None
    # SimConfig.trace only: the run's TraceRecorder (spans + events +
    # per-stage histograms) for export / span-accounting checks.
    trace: TraceRecorder | None = None

    def summary(self) -> dict:
        return {
            "overall_hit_rate": round(self.overall_hit_rate, 4),
            "mean_latency_ms": round(self.mean_latency_ms, 2),
            "p95_latency_ms": round(self.p95_latency_ms, 2),
            "model_cost": round(self.model_cost, 2),
            "stale_served": self.stale_served,
            "false_positives": self.false_positives,
            "n_queries": self.n_queries,
        }


class ServingSimulator:
    def __init__(self, policies: PolicyEngine, sim: SimConfig,
                 controller: AdaptiveController | None = None):
        self.policies = policies
        self.sim = sim
        self.clock = SimClock()
        self.controller = controller
        if sim.adaptive and controller is None:
            self.controller = AdaptiveController(
                fp_rate_limit=sim.fp_rate_limit)
        if self.controller is not None:
            self.policies.controller = self.controller

        # One recorder shares the sim clock with every traced component;
        # None threads the NULL_SPAN no-op path everywhere.
        self.obs: TraceRecorder | None = \
            TraceRecorder(self.clock) if sim.trace else None

        self.faults: FaultInjector | None = None
        self._retry_stores: list[RetryingStore] = []
        if sim.architecture == "hybrid":
            kw = dict(capacity=sim.cache_capacity, clock=self.clock,
                      index_kind=sim.index_kind, use_device=sim.use_device,
                      search_ms=sim.search_ms, insert_ms=sim.insert_ms,
                      l1_capacity=sim.l1_capacity, seed=sim.seed,
                      eviction=sim.eviction, obs=self.obs,
                      device=sim.device)
            if sim.fault_schedule is not None:
                # Fault stack: one shared injector; every shard's doc
                # store becomes RetryingStore(FlakyStore(InMemoryStore))
                # — the injector raises scheduled transients, the retry
                # wrapper absorbs bounded runs with Clock-charged
                # backoff, exhaustion degrades the lookup (StoreTimeout
                # handling in core/cache.py).
                self.faults = FaultInjector(sim.fault_schedule, self.clock,
                                            obs=self.obs)

                def _store(_i: int) -> RetryingStore:
                    s = RetryingStore(FlakyStore(InMemoryStore(),
                                                 self.faults),
                                      clock=self.clock,
                                      retries=sim.store_retries,
                                      backoff_ms=sim.store_backoff_ms,
                                      budget_ms=sim.store_budget_ms,
                                      obs=self.obs)
                    self._retry_stores.append(s)
                    return s

                if sim.n_shards > 1:
                    kw["store_factory"] = _store
                else:
                    kw["store"] = _store(0)
            if sim.n_shards > 1:
                self.cache = ShardedSemanticCache(
                    policies, n_shards=sim.n_shards,
                    faults=self.faults,
                    write_behind_capacity=sim.write_behind_capacity,
                    replication=sim.replication,
                    rebalance_after_s=sim.rebalance_after_s, **kw)
            else:
                self.cache = SemanticCache(policies, **kw)
            # external fetch latency charged here (LatencyModelStore-like)
            self._fetch_ms = sim.fetch_ms
        elif sim.architecture == "vdb":
            self.vdb = VectorDBEmulator(
                dim=384, capacity=sim.cache_capacity, clock=self.clock,
                collection_threshold=sim.vdb_threshold,
                collection_ttl=sim.vdb_ttl_s,
                search_ms=sim.vdb_search_ms, fetch_ms=sim.fetch_ms,
                device=sim.device)
        self.metrics = MetricsRegistry()
        # §7.5.6 monitoring: windowed FP-rate feedback to the controller
        self._fp_window: dict[str, list[int]] = {}
        self.fp_window_size = 50
        # cached ground truth per doc: doc_id -> (intent, version)
        self._truth: dict[int, tuple[int, int]] = {}
        # fallback truth for writes acknowledged WITHOUT a slot (write-
        # behind / fence queues under fault injection): keyed by the
        # response payload, consulted only when a hit's doc_id is
        # unknown — baseline (no-fault) accounting is untouched.
        self._truth_text: dict[tuple[str, str], tuple[int, int]] = {}
        # e2e latency: fixed-bucket log-scale histogram (no per-sample
        # storage) — mean is exact (sum/count), quantiles are bucket
        # midpoints (≤ half a bucket width of relative error).
        self._lat_hist = LatencyHistogram()
        self._model_calls: dict[str, int] = {}
        self._traffic: dict[str, int] = {}
        self._cost = 0.0

    def _span(self, stage: str, **attrs):
        if self.obs is None:
            return NULL_SPAN
        return self.obs.span(stage, **attrs)

    # -- model serving -----------------------------------------------------
    def _alpha(self, model: str) -> float:
        t = self.clock.now()
        for (t0, t1, m, a) in self.sim.load_spikes:
            if m == model and t0 <= t < t1:
                return a
        return 1.0

    def _call_model(self, q: Query) -> float:
        alpha = self._alpha(q.model_name)
        t_ms = q.t_llm_ms * alpha
        with self._span("model_call", category=q.category,
                        model=q.model_name):
            self.clock.advance(t_ms / 1e3)
        self._model_calls[q.model_name] = \
            self._model_calls.get(q.model_name, 0) + 1
        self._cost += q.cost_per_call
        if self.controller is not None:
            # queue depth proxy: spike multiplies effective queueing
            qd = int((alpha - 1.0) * 20)
            self.controller.observe(q.model_name,
                                    LoadSignal(latency_ms=t_ms, queue_depth=qd))
        return t_ms

    # -- one query through the chosen stack ---------------------------------
    def _serve_hybrid(self, q: Query, gen: WorkloadGenerator) -> float:
        # "serve" is the per-query root span: every Clock charge below
        # it (cache stages, doc_fetch, model_call) lands inside a leaf
        # span, so leaf-sum accounting closes exactly under SimClock.
        with self._span("serve", category=q.category):
            return self._serve_hybrid_impl(q, gen)

    def _serve_hybrid_impl(self, q: Query, gen: WorkloadGenerator) -> float:
        t0 = self.clock.now()
        res = self.cache.lookup(q.embedding, q.category)
        st = self.metrics.cat(q.category)
        if res.hit:
            if res.reason != "hit_l1":
                with self._span("doc_fetch", category=q.category):
                    self.clock.advance(self._fetch_ms / 1e3)
            truth = self._truth.get(res.doc_id)
            if truth is None and self.faults is not None:
                truth = self._truth_text.get((q.category, res.response))
            intent, version = truth if truth is not None else (-1, -1)
            is_fp = intent != q.intent_id
            # §7.5.6: feed windowed FP observations back to the controller
            # so relaxation backs off when accuracy degrades.
            if self.controller is not None:
                w = self._fp_window.setdefault(q.category, [])
                w.append(1 if is_fp else 0)
                if len(w) >= self.fp_window_size:
                    self.controller.report_false_positive_rate(
                        q.category, sum(w) / len(w))
                    w.clear()
            if is_fp:
                st.false_positives += 1
                self.cache.metrics.cat(q.category).false_positives += 1
            else:
                st.true_positives += 1
                self.cache.metrics.cat(q.category).true_positives += 1
                cur = gen.version_of(q.category, q.intent_id, self.clock.now())
                if version < cur:
                    st.stale_served += 1
                    self.cache.metrics.cat(q.category).stale_served += 1
        else:
            self._call_model(q)
            slot = self.cache.insert(q.embedding, q.category, q.text,
                                     f"response:{q.text}")
            if slot >= 0:
                # doc_id_of decodes sharded caches' global slot ids too;
                # a replicated write gets the truth recorded under EVERY
                # replica's doc id so failover reads judge identically.
                if hasattr(self.cache, "replica_doc_ids"):
                    for doc_id in self.cache.replica_doc_ids(slot):
                        self._truth[doc_id] = (q.intent_id,
                                               q.content_version)
                else:
                    doc_id = self.cache.doc_id_of(slot)
                    self._truth[doc_id] = (q.intent_id, q.content_version)
            if self.faults is not None:
                # the write may be acknowledged-but-deferred (write-
                # behind / fence) or re-minted under a fresh doc id by a
                # replica catch-up / outage rebuild — the payload-keyed
                # fallback covers every copy whose id truth never saw
                self._truth_text[(q.category, f"response:{q.text}")] = \
                    (q.intent_id, q.content_version)
        return (self.clock.now() - t0) * 1e3

    def _serve_vdb(self, q: Query, gen: WorkloadGenerator) -> float:
        t0 = self.clock.now()
        doc = self.vdb.query(q.embedding)
        st = self.metrics.cat(q.category)
        st.lookups += 1
        if doc is not None:
            st.hits += 1
            intent, version = self._truth.get(("vdb", doc.doc_id),
                                              (-1, -1))
            if intent != q.intent_id:
                st.false_positives += 1
            else:
                st.true_positives += 1
                cur = gen.version_of(q.category, q.intent_id, self.clock.now())
                if version < cur:
                    st.stale_served += 1
        else:
            st.misses += 1
            self._call_model(q)
            self.vdb.insert(q.embedding, Document(
                0, q.text, f"response:{q.text}", 0.0, q.category))
            did = self.vdb._next_doc - 1
            self._truth[("vdb", did)] = (q.intent_id, q.content_version)
        return (self.clock.now() - t0) * 1e3

    def _serve_none(self, q: Query) -> float:
        t0 = self.clock.now()
        self._call_model(q)
        st = self.metrics.cat(q.category)
        st.lookups += 1
        st.misses += 1
        return (self.clock.now() - t0) * 1e3

    # -- main loop -------------------------------------------------------------
    def run(self, gen: WorkloadGenerator, n_queries: int) -> SimResult:
        queries = gen.generate(n_queries)
        resident_integral = 0
        for q in queries:
            # advance the sim clock to the arrival time if ahead
            if q.timestamp > self.clock.now():
                # span-ok: inter-arrival idle, not a serving stage
                self.clock.advance(q.timestamp - self.clock.now())
            self._traffic[q.model_name] = self._traffic.get(q.model_name, 0)
            if self.sim.architecture == "hybrid":
                lat = self._serve_hybrid(q, gen)
                st = self.cache.metrics.cat(q.category)
                resident_integral += len(self.cache)
            elif self.sim.architecture == "vdb":
                lat = self._serve_vdb(q, gen)
            else:
                lat = self._serve_none(q)
            self._lat_hist.observe(lat)
            if self.obs is not None:
                self.obs.observe_ms("e2e", lat, category=q.category)
            self.metrics.cat(q.category).latency_ms_sum += lat

        reg = (self.cache.metrics if self.sim.architecture == "hybrid"
               else self.metrics)
        mean_resident = 0.0
        hits_per_mb = 0.0
        if self.sim.architecture == "hybrid" and n_queries:
            mean_resident = resident_integral / n_queries
            total_hits = sum(s.hits for s in reg.per_category.values())
            bpe = ResidencyModel(dim=getattr(self.cache, "dim", 384)) \
                .bytes_per_entry()
            resident_mb = mean_resident * bpe / 1e6
            hits_per_mb = total_hits / resident_mb if resident_mb else 0.0
        # merge ground-truth counters into the hybrid registry view
        per_cat = {}
        for name, st in reg.per_category.items():
            d = st.to_dict()
            if self.sim.architecture == "hybrid":
                gt = self.metrics.cat(name)
                d["false_positives"] = gt.false_positives
                d["stale_served"] = gt.stale_served
                tot = gt.false_positives + gt.true_positives
                d["fp_rate"] = round(gt.false_positives / tot, 4) if tot else 0.0
            per_cat[name] = d
        fault_stats = None
        if self.faults is not None:
            per = reg.per_category.values()
            lookups = sum(s.lookups for s in per)
            degraded = sum(s.degraded_misses for s in per)
            fault_stats = {
                "degraded_misses": degraded,
                "store_timeouts": sum(s.store_timeouts for s in per),
                "availability": round(1.0 - degraded / lookups, 4)
                if lookups else 1.0,
                "injector": self.faults.stats(),
            }
            if hasattr(self.cache, "fault_stats"):
                fault_stats["front_door"] = dict(self.cache.fault_stats)
                fault_stats["wb_pending"] = self.cache.wb_pending
                # per-category availability SLO view (sharded only):
                # availability, degraded_misses/seconds, replica count
                fault_stats["slo"] = self.cache.metrics.slo_report()
            if self._retry_stores:
                store = {}
                for s in self._retry_stores:
                    for k, v in s.stats.items():
                        store[k] = store.get(k, 0) + v
                fault_stats["store"] = store
        h = self._lat_hist
        return SimResult(
            per_category=per_cat,
            overall_hit_rate=reg.overall_hit_rate(),
            mean_latency_ms=h.mean_ms,
            p95_latency_ms=h.quantile(0.95),
            model_calls=dict(self._model_calls),
            model_cost=self._cost,
            stale_served=sum(d.get("stale_served", 0)
                             for d in per_cat.values()),
            false_positives=sum(d.get("false_positives", 0)
                                for d in per_cat.values()),
            n_queries=n_queries,
            traffic_to_models=dict(self._model_calls),
            metrics=reg,
            # Both index kinds carry the residency protocol now, and the
            # sharded cache aggregates it (per-shard breakdown included).
            index_sync=(dict(self.cache.sync_stats)
                        if self.sim.architecture == "hybrid" else None),
            mean_resident_entries=mean_resident,
            hits_per_resident_mb=hits_per_mb,
            fault_stats=fault_stats,
            trace=self.obs,
        )
