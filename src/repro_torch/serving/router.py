"""Multi-model routing with per-model adaptive cache policies (§7.5.5),
in PyTorch's package: the counterpart of ``repro.serving.router`` (host
code; the caches it owns come from ``cache_factory``).

Each ``ModelBackend`` carries its own load tracker; the router maps
categories to backends and resolves effective cache policies per backend —
Model A under a 3× spike relaxes its categories' thresholds/TTLs while
Model B stays at base policy, steering cache capacity toward the loaded,
expensive model.

Also supports **category-sharded cache groups** (paper §7.4: beyond 10 M
entries, shard by category): the router owns N caches and routes lookups
by category through a ``ShardPlanner`` — quota-byte bin-packing
(core/shard.py), so head categories spread across shards instead of
colliding the way the old crc32-mod hash let them. The hash survives
only as the no-planner fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.cache import SemanticCache
from repro_torch.core.policy import AdaptiveController, LoadSignal, PolicyEngine
from repro_torch.core.shard import ShardPlanner, crc32_shard


@dataclass
class ModelBackend:
    name: str
    t_base_ms: float
    cost_per_call: float
    latency_target_ms: float = 600.0
    queue_target: int = 32
    calls: int = 0
    total_ms: float = 0.0

    def invoke_ms(self, alpha: float = 1.0) -> float:
        self.calls += 1
        t = self.t_base_ms * alpha
        self.total_ms += t
        return t


class ModelRouter:
    def __init__(self, policies: PolicyEngine,
                 backends: list[ModelBackend],
                 controller: AdaptiveController | None = None,
                 n_cache_shards: int = 1,
                 cache_factory=None,
                 planner: ShardPlanner | None = None,
                 shard_capacity: int = 65536):
        self.policies = policies
        self.controller = controller or AdaptiveController()
        self.policies.controller = self.controller
        self.backends = {b.name: b for b in backends}
        for b in backends:
            self.controller.register_model(
                b.name, latency_target_ms=b.latency_target_ms,
                queue_target=b.queue_target)
        self.n_shards = n_cache_shards
        # Placement: quota-byte bin-packing over the registered policies
        # (core/shard.py). A caller-provided planner wins; the crc32 hash
        # remains only as the explicit no-planner fallback
        # (``planner=False`` forces it, for the baseline benchmarks).
        if planner is None and n_cache_shards > 1:
            planner = ShardPlanner.from_policies(
                policies, n_cache_shards, shard_capacity)
        self.planner = planner or None
        if cache_factory is not None:
            self.caches = [cache_factory(i) for i in range(n_cache_shards)]
        else:
            self.caches = []

    # -- category → backend / cache shard -------------------------------------
    def backend_for(self, category: str) -> ModelBackend:
        cfg = self.policies.get(category)
        b = self.backends.get(cfg.model_name)
        if b is None:
            b = next(iter(self.backends.values()))
        return b

    def shard_for(self, category: str) -> int:
        """Cache shard for a category: the quota-byte planner's
        placement (balanced by construction, migration-aware via
        ``planner.assign``); crc32-mod only when no planner exists —
        the legacy hash collides head categories onto one shard."""
        if self.planner is not None:
            return self.planner.shard_of(category)
        return crc32_shard(category, self.n_shards)

    def cache_for(self, category: str) -> SemanticCache | None:
        if not self.caches:
            return None
        return self.caches[self.shard_for(category)]

    # -- load observation ---------------------------------------------------------
    def observe(self, model_name: str, latency_ms: float, queue_depth: int):
        self.controller.observe(model_name,
                                LoadSignal(latency_ms, queue_depth))

    def load_factor(self, model_name: str) -> float:
        return self.controller.load_factor(model_name)

    def effective_policy(self, category: str):
        return self.policies.effective(category)

    # -- reporting ----------------------------------------------------------------
    def report(self) -> dict:
        return {
            name: {"calls": b.calls,
                   "mean_ms": b.total_ms / b.calls if b.calls else 0.0,
                   "load_factor": round(self.load_factor(name), 3),
                   "cost": b.calls * b.cost_per_call}
            for name, b in self.backends.items()
        }
