"""The paper's contribution, ported: category-aware semantic caching.

Modules:
    policy     — per-category configs + adaptive load-based controller (§3, §7.5)
    admission  — frequency-sketch admission control + cost-aware eviction
    embedding  — 384-d feature-hash embedder + synthetic category spaces (§3.1)
    hnsw       — HNSW and flat indexes, device-resident tables (§5, §5.3)
    cache      — hybrid cache: Algorithm 1 lookup, insert, evict, quotas (§5)
    shard      — sharded cache tier: quota-byte placement planner, fan-out
                 masked search, live category migration (§7.4 scaling)
    storage    — external document stores + vector-DB baseline emulator (§4)
    faults     — deterministic fault injection
    economics  — break-even analysis, eqs (1)-(6) (§4.4, §5.5, §7.5.1)
    workload   — heterogeneous category workload generator (Table 1)
    metrics    — per-category statistics
    clock      — simulated / wall clocks
"""

from repro_torch.core.policy import (  # noqa: F401
    CategoryConfig,
    PolicyEngine,
    AdaptiveController,
    LoadSignal,
)
from repro_torch.core.admission import (  # noqa: F401
    AdmissionController,
    CategoryTracker,
    FrequencySketch,
    QueryFingerprinter,
    CostAwareEvictionScorer,
    StaticEvictionScorer,
)
from repro_torch.core.cache import SemanticCache, CacheResult  # noqa: F401
from repro_torch.core.shard import (  # noqa: F401
    ShardPlanner,
    ShardedSemanticCache,
    CategoryMigration,
    OutageRebalance,
    crc32_shard,
)
from repro_torch.core.economics import (  # noqa: F401
    break_even_hit_rate,
    expected_latency,
    CostModel,
    HYBRID_COSTS,
    VDB_COSTS,
)
from repro_torch.core.embedding import FeatureHashEmbedder, SyntheticCategorySpace  # noqa: F401
from repro_torch.core.hnsw import HNSWIndex, FlatIndex  # noqa: F401
from repro_torch.core.storage import (  # noqa: F401
    InMemoryStore,
    FileStore,
    LatencyModelStore,
    FlakyStore,
    RetryingStore,
    VectorDBEmulator,
)
from repro_torch.core.faults import (  # noqa: F401
    FaultInjector,
    FaultSchedule,
    InjectedCrash,
    StoreTimeout,
    TransientStoreError,
)
from repro_torch.core.workload import WorkloadGenerator, CategorySpec, TABLE1_WORKLOAD  # noqa: F401
from repro_torch.core.clock import SimClock, WallClock  # noqa: F401
