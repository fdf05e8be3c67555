"""Per-category cache statistics (feeds Table 1 + adaptive feedback)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CategoryStats:
    lookups: int = 0
    hits: int = 0
    misses: int = 0
    compliance_rejects: int = 0
    insert_rejects: int = 0
    admission_skips: int = 0       # misses not cached by the admission gate
    degraded_misses: int = 0       # lookups served-from-model because the
                                   # category's shard was down (availability
                                   # accounting: hits + misses + degraded ==
                                   # lookups; degraded never enters the
                                   # hit-rate denominator)
    store_timeouts: int = 0        # would-be hits degraded to misses by an
                                   # exhausted store retry budget (these DO
                                   # count in misses — the entry stays
                                   # resident, the lookup still missed)
    degraded_seconds: float = 0.0  # observed wall (sim) time with NO live
                                   # replica for the category — accrued
                                   # incrementally by the sharded front door
                                   # between ops, so availability-vs-outage
                                   # SLO curves never re-derive window
                                   # overlap from the fault schedule
    ttl_evictions: int = 0
    quota_evictions: int = 0
    capacity_evictions: int = 0
    inserts: int = 0
    reranks: int = 0               # fp32 re-scores of borderline int8 hits
    rerank_flips: int = 0          # decisions the exact re-score changed
    stale_served: int = 0          # ground-truth staleness (simulator only)
    false_positives: int = 0       # ground-truth wrong-intent hits (sim only)
    true_positives: int = 0
    latency_ms_sum: float = 0.0

    @property
    def hit_rate(self) -> float:
        """hits / lookups the cache actually SERVED: degraded lookups
        (shard down — the cache never searched) are excluded from the
        denominator, like ``admission_skips`` on the insert side, so an
        outage window degrades availability, not the measured hit rate.
        With no faults injected this is exactly hits / lookups."""
        served = self.lookups - self.degraded_misses
        return self.hits / served if served else 0.0

    @property
    def availability(self) -> float:
        """Fraction of lookups the cache was reachable for."""
        if not self.lookups:
            return 1.0
        return 1.0 - self.degraded_misses / self.lookups

    @property
    def false_positive_rate(self) -> float:
        total = self.false_positives + self.true_positives
        return self.false_positives / total if total else 0.0

    @property
    def mean_latency_ms(self) -> float:
        """Mean over lookups the cache actually SERVED — the same
        denominator as ``hit_rate``: degraded lookups never reached the
        cache, so no latency was charged to them here."""
        served = self.lookups - self.degraded_misses
        return self.latency_ms_sum / served if served else 0.0

    def to_dict(self) -> dict:
        return {
            "lookups": self.lookups, "hits": self.hits, "misses": self.misses,
            "hit_rate": round(self.hit_rate, 4),
            "fp_rate": round(self.false_positive_rate, 4),
            "mean_latency_ms": round(self.mean_latency_ms, 3),
            "compliance_rejects": self.compliance_rejects,
            "insert_rejects": self.insert_rejects,
            "admission_skips": self.admission_skips,
            "degraded_misses": self.degraded_misses,
            "degraded_seconds": round(self.degraded_seconds, 3),
            "store_timeouts": self.store_timeouts,
            "ttl_evictions": self.ttl_evictions,
            "quota_evictions": self.quota_evictions,
            "capacity_evictions": self.capacity_evictions,
            "inserts": self.inserts,
            "reranks": self.reranks,
            "rerank_flips": self.rerank_flips,
            "stale_served": self.stale_served,
            "false_positives": self.false_positives,
            "true_positives": self.true_positives,
        }


#: Fields summed when aggregating CategoryStats across categories.
_SUM_FIELDS = tuple(CategoryStats.__dataclass_fields__)


def overall_stats(per_category: dict[str, CategoryStats]) -> CategoryStats:
    """Sum every counter field across categories; the derived
    properties (hit_rate, availability, mean_latency_ms) then hold the
    fleet-wide values for free."""
    out = CategoryStats()
    for st in per_category.values():
        for f in _SUM_FIELDS:
            setattr(out, f, getattr(out, f) + getattr(st, f))
    return out


def overall_row(per_category: dict[str, CategoryStats]) -> dict:
    """The ``"_overall"`` snapshot entry: a summed ``to_dict()`` plus
    ``availability`` (rates are recomputed from the summed counters,
    NOT averaged across categories)."""
    ov = overall_stats(per_category)
    row = ov.to_dict()
    row["availability"] = round(ov.availability, 4)
    return row


@dataclass
class MetricsRegistry:
    per_category: dict[str, CategoryStats] = field(default_factory=dict)

    def cat(self, name: str) -> CategoryStats:
        if name not in self.per_category:
            self.per_category[name] = CategoryStats()
        return self.per_category[name]

    def overall_hit_rate(self) -> float:
        lookups = sum(s.lookups for s in self.per_category.values())
        hits = sum(s.hits for s in self.per_category.values())
        return hits / lookups if lookups else 0.0

    def snapshot(self) -> dict:
        """Per-category rows plus an ``"_overall"`` aggregate row
        (sorted first by the ``_`` prefix; skip keys starting with
        ``_`` when iterating categories)."""
        snap = {k: v.to_dict() for k, v in sorted(self.per_category.items())}
        snap["_overall"] = overall_row(self.per_category)
        return snap
