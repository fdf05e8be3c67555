"""Heterogeneous workload generation (paper §3, Table 1).

Each ``CategorySpec`` controls the four properties the paper identifies:

    density     — via the category's ``SyntheticCategorySpace`` (sigma /
                  center_spread / n_centers)
    repetition  — Zipf(α) over an intent pool (code: α≈1.2 → top 10 % of
                  intents ≈ 45 % of traffic), uniform (chat), bursty
                  (rotating working set) or drifting (moving Zipf head)
    staleness   — Poisson content-update rate per intent (fraction/second);
                  a served response is *stale* iff the intent's content
                  version advanced since caching
    cost        — downstream model latency/price (drives economics)

The generator emits a time-ordered stream of ``Query`` records carrying the
ground-truth intent id + content version, so the simulator can measure true
hit rates, false positives (matched a different intent) and staleness.

``scenario_matrix()`` packages named workload shapes — per-category
power_law / uniform_tail / bursty / drifting plus the session_drift,
flash_crowd and stale_burst composites — keyed by the paper's category
names so ``paper_policies()`` applies unchanged. The matrix drives
``serving/simulator.py`` and ``benchmarks/bench_admission.py``; every
scenario is seed-deterministic (fixed seed → identical trace).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.embedding import EMBED_DIM, SyntheticCategorySpace


@dataclass
class CategorySpec:
    name: str
    traffic_share: float            # fraction of total queries
    pool_size: int                  # number of distinct intents
    zipf_alpha: float | None        # None → uniform repetition
    staleness_per_s: float          # per-intent content update rate (1/s)
    t_llm_ms: float                 # downstream model latency
    model_name: str = "default"
    cost_per_call: float = 0.01
    sigma: float = 0.10             # paraphrase noise (density)
    center_spread: float = 1.0      # cluster concentration (density)
    loose_frac: float = 0.30        # fraction of loose paraphrases
    loose_mult: float = 2.0         # loose paraphrase noise multiplier
    seed: int = 0
    # Repetition shape: "auto" resolves to "zipf" when zipf_alpha is set,
    # else "uniform" (the seed semantics — TABLE1 traces are unchanged).
    # "bursty" concentrates burst_frac of traffic on a working set that
    # rotates every burst_window_s; "drifting" slides a Zipf head through
    # the pool at drift_per_s intents/second (session topics wandering).
    repetition: str = "auto"        # auto | zipf | uniform | bursty | drifting
    burst_window_s: float = 60.0
    burst_working_set: int = 32
    burst_frac: float = 0.85
    drift_per_s: float = 0.0
    # Flash-crowd overlay (inert at flash_frac=0, composable with any
    # repetition kind): inside [flash_start_s, flash_end_s) a flash_frac
    # slice of the category's traffic collapses onto the first
    # flash_intents intents — the breaking-news spike of §7.5.
    flash_start_s: float = 0.0
    flash_end_s: float = 0.0
    flash_frac: float = 0.0
    flash_intents: int = 64

    def make_space(self, dim: int = EMBED_DIM) -> SyntheticCategorySpace:
        return SyntheticCategorySpace(
            name=self.name, n_centers=self.pool_size, sigma=self.sigma,
            center_spread=self.center_spread, loose_frac=self.loose_frac,
            loose_mult=self.loose_mult, dim=dim, seed=self.seed)


@dataclass
class Query:
    category: str
    intent_id: int                   # ground truth
    content_version: int             # ground truth at issue time
    embedding: np.ndarray
    t_llm_ms: float
    model_name: str
    cost_per_call: float
    timestamp: float
    text: str = ""


class WorkloadGenerator:
    """Streams queries across categories at ``rate_per_s`` aggregate QPS."""

    def __init__(self, specs: list[CategorySpec], rate_per_s: float = 30.0,
                 dim: int = EMBED_DIM, seed: int = 0):
        total = sum(s.traffic_share for s in specs)
        if abs(total - 1.0) > 1e-6:
            specs = [dataclass_replace(s, traffic_share=s.traffic_share / total)
                     for s in specs]
        self.specs = specs
        self.rate_per_s = rate_per_s
        self.dim = dim
        self.rng = np.random.default_rng(seed)
        self.spaces = {s.name: s.make_space(dim) for s in specs}
        self._shares = np.array([s.traffic_share for s in specs])
        # content versions advance lazily: we store last-update sample time
        self._versions: dict[str, np.ndarray] = {
            s.name: np.zeros(s.pool_size, np.int64) for s in specs}
        self._last_t: dict[str, float] = {s.name: 0.0 for s in specs}
        self._zipf_p: dict[str, np.ndarray] = {}

    def _advance_versions(self, spec: CategorySpec, now: float) -> None:
        """Poisson content updates since the last observation."""
        dt = now - self._last_t[spec.name]
        if dt <= 0 or spec.staleness_per_s <= 0:
            self._last_t[spec.name] = now
            return
        lam = spec.staleness_per_s * dt
        self._versions[spec.name] += self.rng.poisson(
            lam, size=spec.pool_size)
        self._last_t[spec.name] = now

    def _zipf_probs(self, spec: CategorySpec) -> np.ndarray:
        if spec.name not in self._zipf_p:
            # Bounded Zipf over [1, pool]: p(k) ∝ k^-α.
            alpha = 1.1 if spec.zipf_alpha is None else spec.zipf_alpha
            ranks = np.arange(1, spec.pool_size + 1, dtype=np.float64)
            p = ranks ** (-alpha)
            self._zipf_p[spec.name] = p / p.sum()
        return self._zipf_p[spec.name]

    def _draw_intent(self, spec: CategorySpec, t: float = 0.0) -> int:
        # Flash overlay first (no rng draw at all unless the spec opts
        # in AND the clock is inside the window — default-off specs keep
        # the seed's exact rng call sequence).
        if spec.flash_frac > 0.0 and \
                spec.flash_start_s <= t < spec.flash_end_s and \
                self.rng.random() < spec.flash_frac:
            return int(self.rng.integers(
                0, min(spec.flash_intents, spec.pool_size)))
        kind = spec.repetition
        if kind == "auto":
            kind = "uniform" if spec.zipf_alpha is None else "zipf"
        if kind == "uniform":
            return int(self.rng.integers(0, spec.pool_size))
        if kind == "zipf":
            return int(self.rng.choice(spec.pool_size,
                                       p=self._zipf_probs(spec)))
        if kind == "bursty":
            # A working set of burst_working_set intents receives
            # burst_frac of traffic; the set rotates (disjointly, until
            # the pool wraps) each burst_window_s.
            if self.rng.random() < spec.burst_frac:
                w = int(t // spec.burst_window_s)
                base = (w * spec.burst_working_set) % spec.pool_size
                off = int(self.rng.integers(
                    0, min(spec.burst_working_set, spec.pool_size)))
                return (base + off) % spec.pool_size
            return int(self.rng.integers(0, spec.pool_size))
        if kind == "drifting":
            # A Zipf head anchored to a center that slides through the
            # pool at drift_per_s intents/second: yesterday's hot topics
            # cool as the session moves on.
            center = int(t * spec.drift_per_s) % spec.pool_size
            off = int(self.rng.choice(spec.pool_size,
                                      p=self._zipf_probs(spec)))
            return (center + off) % spec.pool_size
        raise ValueError(f"{spec.name}: unknown repetition {kind!r}")

    def version_of(self, category: str, intent_id: int, now: float) -> int:
        spec = next(s for s in self.specs if s.name == category)
        self._advance_versions(spec, now)
        return int(self._versions[category][intent_id])

    def generate(self, n: int, start_time: float = 0.0) -> list[Query]:
        """n queries with exponential inter-arrival at the aggregate rate."""
        out: list[Query] = []
        t = start_time
        cat_idx = self.rng.choice(len(self.specs), size=n, p=self._shares)
        gaps = self.rng.exponential(1.0 / self.rate_per_s, size=n)
        for i in range(n):
            spec = self.specs[int(cat_idx[i])]
            t += float(gaps[i])
            self._advance_versions(spec, t)
            intent = self._draw_intent(spec, t)
            emb = self.spaces[spec.name].sample(intent, self.rng)
            out.append(Query(
                category=spec.name, intent_id=intent,
                content_version=int(self._versions[spec.name][intent]),
                embedding=emb, t_llm_ms=spec.t_llm_ms,
                model_name=spec.model_name, cost_per_call=spec.cost_per_call,
                timestamp=t,
                text=f"{spec.name}:intent{intent}",
            ))
        return out


def dataclass_replace(spec: CategorySpec, **kw) -> CategorySpec:
    from dataclasses import replace
    return replace(spec, **kw)


# ---------------------------------------------------------------------------
# Table 1 workload: calibrated so the paper's hit-rate long tail emerges.
# Head: power-law repetition, dense spaces, stable content → 45–55 %.
# Tail: uniform repetition / volatile content / sparse spaces → 6–12 %.
# ---------------------------------------------------------------------------

# Pool sizes / Zipf exponents calibrated (8 k queries @30 qps, 12 k-entry
# cache, flat index) so the paper's Table 1 hit-rate bands emerge:
# head 40–60 %, tail 5–15 %, volatility-limited financial, TTL-limited.
TABLE1_WORKLOAD: list[CategorySpec] = [
    CategorySpec("code_generation", traffic_share=0.35, pool_size=4000,
                 zipf_alpha=1.1, staleness_per_s=1.2e-9,    # ~0.01 %/day
                 t_llm_ms=500.0, model_name="o1", cost_per_call=0.10,
                 sigma=0.012, center_spread=0.25, seed=11),
    CategorySpec("api_documentation", traffic_share=0.25, pool_size=6500,
                 zipf_alpha=1.05, staleness_per_s=2.3e-7,     # ~2 %/day
                 t_llm_ms=500.0, model_name="gpt4o", cost_per_call=0.05,
                 sigma=0.013, center_spread=0.28, seed=12),
    CategorySpec("conversational_chat", traffic_share=0.15, pool_size=5200,
                 zipf_alpha=None, staleness_per_s=0.0,
                 t_llm_ms=200.0, model_name="haiku", cost_per_call=0.01,
                 sigma=0.022, center_spread=0.36, loose_mult=1.5, seed=13),
    CategorySpec("financial_data", traffic_share=0.10, pool_size=3200,
                 zipf_alpha=0.7, staleness_per_s=2.2e-4,     # ~80 %/hour
                 t_llm_ms=200.0, model_name="gpt4o_mini", cost_per_call=0.01,
                 sigma=0.015, center_spread=0.50, seed=14),
    CategorySpec("legal_queries", traffic_share=0.08, pool_size=8000,
                 zipf_alpha=0.7, staleness_per_s=1.2e-8,
                 t_llm_ms=500.0, model_name="gpt4o", cost_per_call=0.05,
                 sigma=0.020, center_spread=0.55, seed=15),
    CategorySpec("medical_queries", traffic_share=0.04, pool_size=3000,
                 zipf_alpha=0.6, staleness_per_s=1.2e-8,
                 t_llm_ms=500.0, model_name="gpt4o", cost_per_call=0.05,
                 sigma=0.021, center_spread=0.60, seed=16),
    CategorySpec("specialized_domains", traffic_share=0.03, pool_size=4500,
                 zipf_alpha=0.7, staleness_per_s=1.2e-8,
                 t_llm_ms=200.0, model_name="haiku", cost_per_call=0.01,
                 sigma=0.022, center_spread=0.60, seed=17),
]


# ---------------------------------------------------------------------------
# Scenario matrix (admission/eviction stress shapes). Categories reuse the
# paper's names so paper_policies() applies without edits; rates and spans
# are chosen so each scenario's defining pressure actually occurs inside a
# few-thousand-query run (deterministic at fixed seed).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Scenario:
    """One named workload shape: specs + the aggregate rate that makes
    its time-dependent structure (burst windows, flash spans, TTL storms)
    land inside a benchmark-sized run."""

    name: str
    specs: tuple
    rate_per_s: float = 30.0
    description: str = ""

    def generator(self, seed: int = 0, dim: int = EMBED_DIM,
                  rate_per_s: float | None = None) -> WorkloadGenerator:
        return WorkloadGenerator(list(self.specs),
                                 rate_per_s=rate_per_s or self.rate_per_s,
                                 dim=dim, seed=seed)


def _code(share: float, **kw) -> CategorySpec:
    return CategorySpec("code_generation", traffic_share=share,
                        pool_size=4000, zipf_alpha=1.1,
                        staleness_per_s=1.2e-9, t_llm_ms=500.0,
                        model_name="o1", cost_per_call=0.10, sigma=0.012,
                        center_spread=0.25, seed=11, **kw)


def _chat(share: float, pool: int = 5200, zipf_alpha: float | None = None,
          **kw) -> CategorySpec:
    return CategorySpec("conversational_chat", traffic_share=share,
                        pool_size=pool, zipf_alpha=zipf_alpha,
                        staleness_per_s=0.0, t_llm_ms=200.0,
                        model_name="haiku", cost_per_call=0.01, sigma=0.022,
                        center_spread=0.36, loose_mult=1.5, seed=13, **kw)


def scenario_matrix() -> dict[str, Scenario]:
    """The named workload shapes bench_admission / test_simulator sweep."""
    return {s.name: s for s in [
        # Per-category primitives -------------------------------------------
        Scenario("power_law", (_code(1.0),), description=(
            "Pure Zipf(1.1) code traffic — the head-repetition baseline; "
            "admission control must leave its hit rate untouched")),
        Scenario("uniform_tail", (
            _chat(1.0, pool=50000, flash_start_s=0.0, flash_end_s=1e9,
                  flash_frac=0.12, flash_intents=64),
        ), description=(
            "Uniform chat over a 50 k-intent pool (≈ no repetition) with "
            "a small persistent hot set — the shape where unconditional "
            "admission churns quota bytes on entries that never re-hit")),
        Scenario("bursty", (
            CategorySpec("api_documentation", traffic_share=1.0,
                         pool_size=6500, zipf_alpha=1.05,
                         staleness_per_s=2.3e-7, t_llm_ms=500.0,
                         model_name="gpt4o", cost_per_call=0.05,
                         sigma=0.013, center_spread=0.28, seed=12,
                         repetition="bursty", burst_window_s=60.0,
                         burst_working_set=32, burst_frac=0.85),
        ), description=(
            "85 % of traffic on a 32-intent working set that rotates "
            "every 60 s — repetition is high inside a window, zero "
            "across windows")),
        Scenario("drifting", (
            _chat(1.0, repetition="drifting", zipf_alpha=1.1,
                  drift_per_s=2.0),
        ), description=(
            "Zipf head sliding 2 intents/s through the chat pool — "
            "session topics wander, so old entries cool deterministically")),
        # Composites ---------------------------------------------------------
        Scenario("session_drift", (
            _code(0.5),
            _chat(0.5, repetition="drifting", zipf_alpha=1.1,
                  drift_per_s=2.0),
        ), description=(
            "Stable code head + drifting chat sessions competing for "
            "capacity — eviction must age out the drift's cold wake "
            "without touching the stable head")),
        Scenario("flash_crowd", (
            _chat(0.6, pool=20000, flash_start_s=20.0, flash_end_s=80.0,
                  flash_frac=0.5, flash_intents=16),
            _code(0.4),
        ), description=(
            "Breaking-news spike: between t=20 s and t=80 s half the "
            "chat traffic collapses onto 16 intents, then reverts to "
            "uniform-over-20k")),
        Scenario("stale_burst", (
            CategorySpec("financial_data", traffic_share=0.7,
                         pool_size=1200, zipf_alpha=0.9,
                         staleness_per_s=5e-3,          # ~version / 200 s
                         t_llm_ms=200.0, model_name="gpt4o_mini",
                         cost_per_call=0.01, sigma=0.015,
                         center_spread=0.50, seed=14,
                         flash_start_s=0.0, flash_end_s=1e9,
                         flash_frac=0.3, flash_intents=32),
            _code(0.3),
        ), rate_per_s=6.0, description=(
            "financial_data TTL storm: hot quotes re-asked faster than "
            "content updates land, at a 6 qps rate so a bench-sized run "
            "spans the 5-minute TTL repeatedly")),
    ]}


SCENARIO_NAMES = tuple(scenario_matrix())


def scenario_generator(name: str, seed: int = 0, dim: int = EMBED_DIM,
                       rate_per_s: float | None = None) -> WorkloadGenerator:
    """Build the named scenario's generator (KeyError on unknown name)."""
    return scenario_matrix()[name].generator(seed=seed, dim=dim,
                                             rate_per_s=rate_per_s)
