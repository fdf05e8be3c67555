"""Fixed-bucket log-scale latency histograms (no sample storage).

``LatencyHistogram`` is the single latency-distribution primitive for
the repo: benches, the simulator and the trace recorder all feed it
instead of accumulating raw sample lists.  Buckets are fixed at import
time — 8 per octave (growth factor 2^(1/8) ~= 1.09) spanning 1e-3 ms
to ~1e5 ms — so two histograms are always mergeable bucket-by-bucket
and a quantile is reproducible from counts alone.  The exact sum and
count ride along, so ``mean`` has no bucketing error; quantiles carry
at most one bucket width (~9%) of relative error, which is the
resolution the bench gates are written against.

``HistogramSet`` keys histograms by ``(stage, category, shard)`` and
offers roll-ups across any of the three axes; it is the backing store
for the per-stage p50/p95/p99 surfaces in the telemetry report and
the Prometheus exposition.
"""

from __future__ import annotations

import math

# 8 buckets per octave from LO_MS up: bucket i covers
# (LO_MS * G**(i-1), LO_MS * G**i]; bucket 0 is the underflow bucket
# (-inf, LO_MS] and the last bucket is the overflow (everything above
# the top edge lands there).  log2(1e8) * 8 ~= 212.6 -> 214 finite
# edges reach ~1e5 ms.
LO_MS = 1e-3
BUCKETS_PER_OCTAVE = 8
GROWTH = 2.0 ** (1.0 / BUCKETS_PER_OCTAVE)
N_BUCKETS = 216


def bucket_of(ms: float) -> int:
    """Bucket index for a latency in milliseconds."""
    if ms <= LO_MS:
        return 0
    i = 1 + int(math.floor(math.log2(ms / LO_MS) * BUCKETS_PER_OCTAVE))
    # Edge samples: floating-point log2 can land exactly on an edge;
    # nudge down when the computed bucket's lower edge equals ms.
    if i > 0 and LO_MS * GROWTH ** (i - 1) >= ms:
        i -= 1
    return min(i, N_BUCKETS - 1)


def bucket_upper_ms(i: int) -> float:
    """Inclusive upper edge of bucket ``i`` (+inf for the overflow)."""
    if i >= N_BUCKETS - 1:
        return math.inf
    return LO_MS * GROWTH ** i


def _bucket_mid_ms(i: int) -> float:
    """Representative value: geometric midpoint of the bucket."""
    if i == 0:
        return LO_MS
    if i >= N_BUCKETS - 1:
        return LO_MS * GROWTH ** (N_BUCKETS - 2)
    lo = LO_MS * GROWTH ** (i - 1)
    hi = LO_MS * GROWTH ** i
    return math.sqrt(lo * hi)


class LatencyHistogram:
    """Counts-only latency distribution with exact sum/count."""

    __slots__ = ("counts", "count", "sum_ms", "min_ms", "max_ms")

    def __init__(self) -> None:
        self.counts: dict[int, int] = {}
        self.count = 0
        self.sum_ms = 0.0
        self.min_ms = math.inf
        self.max_ms = -math.inf

    def observe(self, ms: float) -> None:
        i = bucket_of(ms)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.count += 1
        self.sum_ms += ms
        if ms < self.min_ms:
            self.min_ms = ms
        if ms > self.max_ms:
            self.max_ms = ms

    @property
    def mean_ms(self) -> float:
        return self.sum_ms / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """q in [0, 1]; bucket geometric midpoint, 0.0 when empty."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i in sorted(self.counts):
            seen += self.counts[i]
            if seen >= rank:
                return _bucket_mid_ms(i)
        return _bucket_mid_ms(max(self.counts))

    def percentiles(self, qs=(0.50, 0.95, 0.99)) -> dict[str, float]:
        return {f"p{round(q * 100):d}": self.quantile(q) for q in qs}

    def merge(self, other: "LatencyHistogram") -> None:
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.count += other.count
        self.sum_ms += other.sum_ms
        self.min_ms = min(self.min_ms, other.min_ms)
        self.max_ms = max(self.max_ms, other.max_ms)

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "sum_ms": round(self.sum_ms, 6),
            "mean_ms": round(self.mean_ms, 6),
            "p50_ms": round(self.quantile(0.50), 6),
            "p95_ms": round(self.quantile(0.95), 6),
            "p99_ms": round(self.quantile(0.99), 6),
            "buckets": {str(i): self.counts[i] for i in sorted(self.counts)},
        }


class HistogramSet:
    """Histograms keyed by ``(stage, category, shard)``."""

    def __init__(self) -> None:
        self._h: dict[tuple[str, str, int], LatencyHistogram] = {}

    def observe(self, stage: str, ms: float, *,
                category: str = "", shard: int = -1) -> None:
        key = (stage, category, shard)
        h = self._h.get(key)
        if h is None:
            h = self._h[key] = LatencyHistogram()
        h.observe(ms)

    def items(self):
        return sorted(self._h.items())

    def __len__(self) -> int:
        return len(self._h)

    def rollup(self, *, stage: str | None = None,
               category: str | None = None,
               shard: int | None = None) -> LatencyHistogram:
        """Merge every histogram matching the given axes (None = any)."""
        out = LatencyHistogram()
        for (st, cat, sh), h in self._h.items():
            if stage is not None and st != stage:
                continue
            if category is not None and cat != category:
                continue
            if shard is not None and sh != shard:
                continue
            out.merge(h)
        return out

    def stages(self) -> list[str]:
        return sorted({st for (st, _, _) in self._h})

    def to_dict(self) -> dict:
        return {f"{st}|{cat}|{sh}": h.to_dict()
                for (st, cat, sh), h in self.items()}
