"""Category policy engine + adaptive load-based controller.

Paper §3 (category properties → policies), §5.4 (enforcement points),
§7.5 (adaptive load-based policies).

A ``CategoryConfig`` carries the per-category policy: similarity threshold,
TTL, quota fraction, priority, compliance gate. The ``PolicyEngine`` owns
all categories and resolves effective (possibly load-adjusted) policies.
The ``AdaptiveController`` implements §7.5.4: load factor
``λ = min(1, Lp/Ltarget·wL + Q/Qtarget·wQ)`` with moving-average damping,
hysteresis (Δλ ≥ 0.1), safety bounds, and a false-positive feedback loop
shrinking ``δ_max``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class CategoryConfig:
    """Per-category cache policy (paper §3, Table 1, §6 use cases)."""

    name: str
    threshold: float                  # τ0: base cosine-similarity threshold
    ttl: float                        # t0: base TTL, seconds
    quota: float                      # max fraction of cache capacity
    priority: float = 1.0             # economic weight in eviction (§5.4)
    allow_caching: bool = True        # compliance gate (§6.4: HIPAA/GDPR)
    # Quantized-residency re-rank tier: device results whose int8 score
    # lands within this margin of τ are exactly re-scored from the fp32
    # embedding stored next to the document (core/cache.py), so
    # quantization can never flip a hit/miss decision at the boundary.
    # Dense categories sitting close to their τ (code) may widen it;
    # 0 disables re-ranking for the category.
    rerank_margin: float = 0.02
    # Admission control (core/admission.py): a miss is only cached once
    # its canonical repetition key (nearest recent representative within
    # the category's own threshold τ, else a fresh SimHash fingerprint)
    # has been observed ``admit_after`` times by the per-category
    # frequency sketch. 1 (default) admits every miss unconditionally —
    # the seed behavior. Uniform-repetition categories (Table 1:
    # conversational) set 2 so the never-repeating tail stops churning
    # quota.
    admit_after: int = 1
    # Adaptive-policy parameters (§7.5.4):
    delta_max: float = 0.05           # max threshold relaxation δ_max
    beta_max: float = 2.0             # max TTL extension factor β_max
    tau_min: float = 0.70             # safety bound: never relax below this
    ttl_max: float | None = None      # safety bound: cap on extended TTL
    # Workload metadata (used by economics + routing, not enforcement):
    model_name: str = "default"
    expected_tllm_ms: float = 500.0   # T_llm for break-even analysis

    def __post_init__(self):
        if not (0.0 < self.threshold <= 1.0):
            raise ValueError(f"{self.name}: threshold must be in (0,1], got {self.threshold}")
        if self.ttl <= 0:
            raise ValueError(f"{self.name}: ttl must be positive")
        if not (0.0 <= self.quota <= 1.0):
            raise ValueError(f"{self.name}: quota must be in [0,1]")
        if self.delta_max < 0 or self.beta_max < 1.0:
            raise ValueError(f"{self.name}: invalid adaptive bounds")
        if self.rerank_margin < 0:
            raise ValueError(f"{self.name}: rerank_margin must be >= 0")
        if self.admit_after < 1:
            raise ValueError(f"{self.name}: admit_after must be >= 1")

    def effective(self, load_factor: float) -> "EffectivePolicy":
        """Resolve τ(λ), t(λ) under load factor λ ∈ [0,1] (§7.5.4)."""
        lam = min(1.0, max(0.0, load_factor))
        tau = max(self.tau_min, self.threshold - lam * self.delta_max)
        ttl = self.ttl * (1.0 + lam * (self.beta_max - 1.0))
        if self.ttl_max is not None:
            ttl = min(ttl, self.ttl_max)
        return EffectivePolicy(threshold=tau, ttl=ttl, quota=self.quota,
                               priority=self.priority,
                               allow_caching=self.allow_caching,
                               rerank_margin=self.rerank_margin,
                               admit_after=self.admit_after)


@dataclass(frozen=True)
class EffectivePolicy:
    threshold: float
    ttl: float
    quota: float
    priority: float
    allow_caching: bool
    rerank_margin: float = 0.02
    admit_after: int = 1


@dataclass
class LoadSignal:
    """One observation of a downstream model's load (§7.5.4 inputs)."""

    latency_ms: float        # observed request latency (we track P95)
    queue_depth: int


class ModelLoadTracker:
    """Per-model load observation → smoothed load factor λ.

    Moving average over a configurable window (paper: 5–10 min) plus
    hysteresis: the *published* λ only moves when the smoothed λ drifts
    ≥ ``hysteresis`` from the last published value (§7.5.6).
    """

    def __init__(self, latency_target_ms: float, queue_target: int,
                 w_latency: float = 0.6, w_queue: float = 0.4,
                 window: int = 64, hysteresis: float = 0.1):
        if abs((w_latency + w_queue) - 1.0) > 1e-9:
            raise ValueError("weights must sum to 1")
        self.latency_target_ms = latency_target_ms
        self.queue_target = queue_target
        self.w_latency = w_latency
        self.w_queue = w_queue
        self.hysteresis = hysteresis
        self._lat = deque(maxlen=window)
        self._queue = deque(maxlen=window)
        self._published = 0.0

    def observe(self, sig: LoadSignal) -> None:
        self._lat.append(sig.latency_ms)
        self._queue.append(sig.queue_depth)

    def p95_latency_ms(self) -> float:
        if not self._lat:
            return 0.0
        xs = sorted(self._lat)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    def mean_queue(self) -> float:
        return sum(self._queue) / len(self._queue) if self._queue else 0.0

    def raw_load_factor(self) -> float:
        """λ = min(1, Lp/Ltarget·wL + Q/Qtarget·wQ)   — eq (7)."""
        if not self._lat and not self._queue:
            return 0.0
        lterm = (self.p95_latency_ms() / self.latency_target_ms) * self.w_latency
        qterm = (self.mean_queue() / max(1, self.queue_target)) * self.w_queue
        return min(1.0, lterm + qterm)

    def load_factor(self) -> float:
        """Hysteresis-damped λ: only republish on ≥ hysteresis drift."""
        raw = self.raw_load_factor()
        if abs(raw - self._published) >= self.hysteresis:
            self._published = raw
        return self._published


class AdaptiveController:
    """§7.5: per-model load tracking + FP-rate feedback on δ_max.

    ``model_for_category`` maps categories to downstream models so that a
    load spike on model A relaxes only A's categories (§7.5.5).
    """

    def __init__(self, fp_rate_limit: float = 0.05, fp_backoff: float = 0.5):
        self._trackers: dict[str, ModelLoadTracker] = {}
        self._fp_rate_limit = fp_rate_limit
        self._fp_backoff = fp_backoff
        self._delta_scale: dict[str, float] = {}   # per-category δ_max scaling

    def register_model(self, model_name: str, latency_target_ms: float,
                       queue_target: int, **kw) -> ModelLoadTracker:
        tr = ModelLoadTracker(latency_target_ms, queue_target, **kw)
        self._trackers[model_name] = tr
        return tr

    def observe(self, model_name: str, sig: LoadSignal) -> None:
        if model_name not in self._trackers:
            self.register_model(model_name, latency_target_ms=500.0, queue_target=32)
        self._trackers[model_name].observe(sig)

    def load_factor(self, model_name: str) -> float:
        tr = self._trackers.get(model_name)
        return tr.load_factor() if tr else 0.0

    def report_false_positive_rate(self, category: str, fp_rate: float) -> None:
        """§7.5.6 monitoring: FP rate above the limit during relaxed
        operation shrinks the category's δ_max; sustained clean windows
        recover it slowly (multiplicative decrease / gentle increase, so
        the relaxation converges to the FP-safe level)."""
        scale = self._delta_scale.get(category, 1.0)
        if fp_rate > self._fp_rate_limit:
            scale *= self._fp_backoff
        elif fp_rate < 0.5 * self._fp_rate_limit:
            scale = min(1.0, scale * 1.15)
        self._delta_scale[category] = scale

    def delta_scale(self, category: str) -> float:
        return self._delta_scale.get(category, 1.0)


class PolicyEngine:
    """Owns all category configs; resolves effective per-query policies."""

    def __init__(self, configs: list[CategoryConfig] | None = None,
                 controller: AdaptiveController | None = None,
                 default: CategoryConfig | None = None):
        self._configs: dict[str, CategoryConfig] = {}
        self._ids: dict[str, int] = {}
        self.controller = controller
        self.default = default or CategoryConfig(
            name="__default__", threshold=0.85, ttl=3600.0, quota=1.0)
        for c in configs or []:
            self.add(c)

    # -- registry ----------------------------------------------------------
    def add(self, config: CategoryConfig) -> None:
        if config.name in self._configs:
            raise ValueError(f"duplicate category {config.name!r}")
        self._ids[config.name] = len(self._ids)
        self._configs[config.name] = config

    def update(self, name: str, **changes) -> None:
        self._configs[name] = replace(self._configs[name], **changes)

    def get(self, name: str) -> CategoryConfig:
        return self._configs.get(name, self.default)

    def category_id(self, name: str) -> int:
        if name not in self._ids:
            self._ids[name] = len(self._ids)
            if name not in self._configs:
                self._configs[name] = replace(self.default, name=name)
        return self._ids[name]

    def categories(self) -> list[str]:
        return list(self._configs)

    def __contains__(self, name: str) -> bool:
        return name in self._configs

    # -- resolution --------------------------------------------------------
    def effective(self, name: str) -> EffectivePolicy:
        """Effective policy: base config adjusted by the (per-model) load
        factor and the FP-feedback δ_max scaling."""
        cfg = self.get(name)
        lam = 0.0
        if self.controller is not None:
            lam = self.controller.load_factor(cfg.model_name)
            scale = self.controller.delta_scale(name)
            if scale != 1.0:
                cfg = replace(cfg, delta_max=cfg.delta_max * scale)
        return cfg.effective(lam)

    def threshold_vector(self, names: list[str]) -> list[float]:
        """Per-query thresholds for a batch — what the device traversal consumes."""
        return [self.effective(n).threshold for n in names]


# ---------------------------------------------------------------------------
# The paper's running-example policy set (§6, Table 1, §7.3 guidance).
# ---------------------------------------------------------------------------

DAY = 86400.0
MIN = 60.0


def paper_policies() -> list[CategoryConfig]:
    return [
        # Head categories — dense spaces, power-law repetition, stable content
        CategoryConfig("code_generation", threshold=0.90, ttl=7 * DAY, quota=0.40,
                       priority=4.0, delta_max=0.05, beta_max=2.0, tau_min=0.80,
                       model_name="o1", expected_tllm_ms=500.0),
        CategoryConfig("api_documentation", threshold=0.88, ttl=3 * DAY, quota=0.20,
                       priority=2.0, delta_max=0.05, beta_max=2.0, tau_min=0.80,
                       model_name="gpt4o", expected_tllm_ms=500.0),
        # Tail categories — sparse / volatile / specialized
        CategoryConfig("conversational_chat", threshold=0.75, ttl=6 * 3600.0, quota=0.15,
                       priority=1.0, delta_max=0.10, beta_max=2.0, tau_min=0.68,
                       model_name="haiku", expected_tllm_ms=200.0),
        CategoryConfig("financial_data", threshold=0.85, ttl=5 * MIN, quota=0.08,
                       priority=2.0, delta_max=0.05, beta_max=3.0, tau_min=0.80,
                       ttl_max=15 * MIN, model_name="gpt4o_mini", expected_tllm_ms=200.0),
        CategoryConfig("legal_queries", threshold=0.82, ttl=1 * DAY, quota=0.08,
                       priority=2.5, delta_max=0.06, beta_max=2.0, tau_min=0.76,
                       model_name="gpt4o", expected_tllm_ms=500.0),
        CategoryConfig("medical_queries", threshold=0.82, ttl=1 * DAY, quota=0.05,
                       priority=2.5, delta_max=0.04, beta_max=1.5, tau_min=0.78,
                       model_name="gpt4o", expected_tllm_ms=500.0),
        CategoryConfig("specialized_domains", threshold=0.80, ttl=12 * 3600.0, quota=0.04,
                       priority=1.5, delta_max=0.08, beta_max=2.0, tau_min=0.72,
                       model_name="haiku", expected_tllm_ms=200.0),
        # Compliance-restricted (§6.4): never cached.
        CategoryConfig("phi_medical_records", threshold=0.95, ttl=1.0, quota=0.0,
                       allow_caching=False, model_name="gpt4o"),
    ]
