"""Break-even economics (paper §4.4, §5.5, §7.5.1) + residency capacity.

All latencies in milliseconds. The cost model generalizes eqs (1)–(6):

    L_cached = search_ms + h·fetch_ms + (1−h)·T_llm          (1)/(4)
    net benefit  ⇔  h > search_ms / (T_llm − fetch_ms)        (3)/(5)

Vector-DB:  search ≈ 30 ms (network 10–30 + server HNSW 10–15), fetch 5 ms.
Hybrid:     search ≈ 2 ms (local, in-memory), fetch 5 ms.
Under load: T_load = α·T_base  (§7.5.1, eq (6)).

``ResidencyModel`` prices the OTHER side of the ledger: how many entries
a byte budget holds in the compact in-memory tier, as a function of the
resident embedding dtype (§5.1 bytes-per-entry accounting). The paper's
per-category quota is a *fraction of capacity*; capacity itself is a
function of bytes/entry, so quantizing the resident tier to int8
(~4x smaller embedding component) multiplies the entries every category
quota can hold out of the same memory budget.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CostModel:
    """Latency cost model for one cache architecture."""

    name: str
    search_ms: float          # charged on EVERY query (hit or miss)
    hit_fetch_ms: float       # document fetch charged on hits only
    insert_ms: float = 1.0    # charged on miss-path insertion

    def expected_latency_ms(self, hit_rate: float, t_llm_ms: float) -> float:
        """Eq (1)/(4): expected per-query latency with this cache."""
        h = min(1.0, max(0.0, hit_rate))
        return self.search_ms + h * self.hit_fetch_ms + (1.0 - h) * t_llm_ms

    def break_even_hit_rate(self, t_llm_ms: float) -> float:
        """Eq (3)/(5): minimum hit rate for net benefit vs no cache."""
        denom = t_llm_ms - self.hit_fetch_ms
        if denom <= 0:
            return float("inf")  # model faster than the fetch: never viable
        return self.search_ms / denom

    def viable(self, hit_rate: float, t_llm_ms: float) -> bool:
        return hit_rate > self.break_even_hit_rate(t_llm_ms)

    def speedup(self, hit_rate: float, t_llm_ms: float) -> float:
        """T_llm / expected latency — >1 means the cache pays off."""
        return t_llm_ms / self.expected_latency_ms(hit_rate, t_llm_ms)


# The paper's calibrated constants.
VDB_COSTS = CostModel(name="vector_db", search_ms=30.0, hit_fetch_ms=5.0)
HYBRID_COSTS = CostModel(name="hybrid", search_ms=2.0, hit_fetch_ms=5.0)
# §7.6 document-caching extension: hot docs in memory → hit latency 2 ms.
HYBRID_HOT_COSTS = CostModel(name="hybrid_hotdocs", search_ms=2.0, hit_fetch_ms=0.0)


def expected_latency(hit_rate: float, t_llm_ms: float,
                     model: CostModel = HYBRID_COSTS) -> float:
    return model.expected_latency_ms(hit_rate, t_llm_ms)


def break_even_hit_rate(t_llm_ms: float, model: CostModel = HYBRID_COSTS) -> float:
    return model.break_even_hit_rate(t_llm_ms)


def break_even_under_load(t_base_ms: float, alpha: float,
                          model: CostModel = HYBRID_COSTS) -> float:
    """§7.5.1 eq (6): break-even with loaded model latency T_load = α·T_base."""
    return model.break_even_hit_rate(alpha * t_base_ms)


def traffic_reduction(h0: float, delta_h: float) -> float:
    """§7.5.2: load reduction factor Δh / (1 − h0).

    A category at hit rate h0 sends (1−h0) of traffic to the model; raising
    the hit rate by Δh cuts model traffic by Δh/(1−h0).
    """
    if not (0.0 <= h0 < 1.0):
        raise ValueError("h0 must be in [0,1)")
    return delta_h / (1.0 - h0)


def hit_rate_gain_linear(delta_threshold: float, sensitivity_k: float) -> float:
    """§7.5.4 linear model: Δh = k·δ  (k per unit threshold; the paper quotes
    k=0.5–2.0 per 0.01 of threshold, i.e. 50–200 per unit)."""
    return sensitivity_k * delta_threshold


# ---------------------------------------------------------------------------
# Residency capacity: entries per byte budget as a function of emb dtype.
# ---------------------------------------------------------------------------

# Embedding payload per resident row: fp32 rows, or int8 rows + one fp32
# symmetric dequant scale (matches DeviceResidentIndex.emb_row_nbytes).
EMB_TIER_BYTES = {
    "float32": lambda dim: dim * 4,
    "int8": lambda dim: dim + 4,
}


@dataclass(frozen=True)
class ResidencyModel:
    """Bytes-per-entry model of the compact in-memory tier (§5.1)."""

    dim: int = 384
    emb_dtype: str = "float32"     # resident embedding dtype
    graph_degree: int = 32         # level-0 neighbors per node, int32
    metadata_bytes: int = 112      # §5.1: id map + category + statistics

    def emb_bytes(self) -> int:
        try:
            return EMB_TIER_BYTES[self.emb_dtype](self.dim)
        except KeyError:
            raise ValueError(f"unknown emb_dtype {self.emb_dtype!r}")

    def bytes_per_entry(self) -> int:
        """Embedding tier + level-0 graph row + per-slot metadata."""
        return self.emb_bytes() + self.graph_degree * 4 + self.metadata_bytes

    def entries_per_mb(self) -> int:
        return int(1e6 // self.bytes_per_entry())

    def quota_entries(self, quota_fraction: float, budget_mb: float) -> int:
        """§5.4 quota math in byte terms: the entries a category's quota
        fraction holds out of a memory budget under this residency."""
        if not (0.0 <= quota_fraction <= 1.0):
            raise ValueError("quota_fraction must be in [0,1]")
        return int(quota_fraction * budget_mb * 1e6
                   // self.bytes_per_entry())

    def quota_bytes(self, quota_fraction: float, capacity_entries: int) -> int:
        """The inverse direction of ``quota_entries``: the resident bytes a
        category's quota ceiling pins out of an entry capacity — the unit
        the shard placement planner bin-packs (core/shard.py). A category
        entitled to ``int(quota · capacity)`` entries owns that many rows
        of the resident tier, priced at this residency's bytes/entry."""
        if not (0.0 <= quota_fraction <= 1.0):
            raise ValueError("quota_fraction must be in [0,1]")
        return int(quota_fraction * capacity_entries) * self.bytes_per_entry()


def entry_value_density(expected_hits_per_s, t_llm_ms, bytes_per_entry):
    """Economic eviction score: expected model-ms saved per second of
    residency, per byte pinned (core/admission.CostAwareEvictionScorer).

    ``density = E[hits/s] × T_llm / bytes_per_entry`` — an entry that
    re-hits often, fronts an expensive model, and costs few resident
    bytes is the last to evict; maximizing this over resident slots
    maximizes hit-rate-per-resident-byte, the unit ``bench_admission``
    gates on. Accepts scalars or numpy arrays (broadcasting)."""
    return expected_hits_per_s * t_llm_ms / bytes_per_entry


def residency_capacity_table(budget_mb: float, quotas: dict[str, float],
                             dim: int = 384, graph_degree: int = 32,
                             dtypes: tuple[str, ...] = ("float32", "int8")
                             ) -> dict:
    """Per-dtype capacity table: bytes/entry, entries/MB, and each
    category quota's entry ceiling under the budget — the quantized
    counterpart of Table 1's viability rows."""
    out: dict = {"budget_mb": budget_mb, "dim": dim, "dtypes": {}}
    for dt in dtypes:
        m = ResidencyModel(dim=dim, emb_dtype=dt, graph_degree=graph_degree)
        out["dtypes"][dt] = {
            "bytes_per_entry": m.bytes_per_entry(),
            "emb_bytes": m.emb_bytes(),
            "entries_per_mb": m.entries_per_mb(),
            "quota_entries": {c: m.quota_entries(qf, budget_mb)
                              for c, qf in quotas.items()},
        }
    return out


@dataclass(frozen=True)
class CategoryEconomics:
    """Economic report row for one category (feeds Table 1 viability)."""

    category: str
    traffic_share: float
    hit_rate: float
    t_llm_ms: float
    vdb_break_even: float
    hybrid_break_even: float
    vdb_viable: bool
    hybrid_viable: bool
    vdb_latency_ms: float
    hybrid_latency_ms: float
    uncached_latency_ms: float


def category_economics(category: str, traffic_share: float, hit_rate: float,
                       t_llm_ms: float,
                       vdb: CostModel = VDB_COSTS,
                       hybrid: CostModel = HYBRID_COSTS) -> CategoryEconomics:
    return CategoryEconomics(
        category=category,
        traffic_share=traffic_share,
        hit_rate=hit_rate,
        t_llm_ms=t_llm_ms,
        vdb_break_even=vdb.break_even_hit_rate(t_llm_ms),
        hybrid_break_even=hybrid.break_even_hit_rate(t_llm_ms),
        vdb_viable=vdb.viable(hit_rate, t_llm_ms),
        hybrid_viable=hybrid.viable(hit_rate, t_llm_ms),
        vdb_latency_ms=vdb.expected_latency_ms(hit_rate, t_llm_ms),
        hybrid_latency_ms=hybrid.expected_latency_ms(hit_rate, t_llm_ms),
        uncached_latency_ms=t_llm_ms,
    )


def workload_report(rows: list[CategoryEconomics]) -> dict:
    """Aggregate: coverage (traffic share cacheable) + mean latency under
    each architecture, weighting categories by traffic share. Non-viable
    categories bypass the cache (excluded) for their architecture."""
    total = sum(r.traffic_share for r in rows)
    cov_vdb = sum(r.traffic_share for r in rows if r.vdb_viable) / total
    cov_hyb = sum(r.traffic_share for r in rows if r.hybrid_viable) / total

    def mean_latency(which: str) -> float:
        acc = 0.0
        for r in rows:
            if which == "vdb":
                lat = r.vdb_latency_ms if r.vdb_viable else r.uncached_latency_ms
            elif which == "hybrid":
                lat = r.hybrid_latency_ms if r.hybrid_viable else r.uncached_latency_ms
            else:
                lat = r.uncached_latency_ms
            acc += r.traffic_share * lat
        return acc / total

    return {
        "coverage_vdb": cov_vdb,
        "coverage_hybrid": cov_hyb,
        "mean_latency_none_ms": mean_latency("none"),
        "mean_latency_vdb_ms": mean_latency("vdb"),
        "mean_latency_hybrid_ms": mean_latency("hybrid"),
    }
