"""Cost-aware admission & eviction control plane (ROADMAP: beyond
static heuristics; "Rethinking Caching for LLM Serving Systems" +
SCALM's cluster-level repetition ranking, PAPERS.md).

The seed repro admitted every miss unconditionally and evicted with the
fixed §5.4 formula. That churns quota on uniform-tail categories (Table
1: conversational repetition is uniform — most queries never recur, yet
each one used to claim a resident row until eviction reclaimed it). Two
host-control-plane pieces fix both sides of the ledger:

``AdmissionController``
    A deterministic per-category repetition tracker, consulted by
    ``SemanticCache.insert_batch`` when a category's policy sets
    ``admit_after > 1``: a miss is only cached on its k-th observation,
    so the never-repeating uniform tail stops occupying quota while
    repeated intents are admitted on their second touch. Three layers
    per category (``CategoryTracker``):

    * ``QueryFingerprinter`` — SimHash (sign bits of fixed random
      projections) mints a stable 64-bit key per query embedding.
    * a similarity ring buffer canonicalizes paraphrases: a query whose
      cosine against a bounded window of recent representatives clears
      the category's own threshold τ inherits that REPRESENTATIVE's
      key. This matters because paraphrase noise is of the same order
      as inter-intent spacing under any fixed random projection
      (measured on the Table-1 chat space: raw 16-bit SimHash keeps
      only ~5 % of true repeats on one key while colliding ~40 % of
      distinct intents) — the only reliable repetition test here is the
      same exact-similarity test the cache itself uses for hits.
    * ``FrequencySketch`` — a conservative-update count-min sketch with
      periodic halving decay counts key occurrences: cheap, bounded
      over-count, mergeable (migration), sliding-window via decay.

    All state is keyed per category and seeded from the CATEGORY NAME —
    never from the owning cache's seed — so N shards each tracking their
    own categories reproduce the single cache's decisions bit-for-bit
    (tests/test_shard.py), and a live migration hands the tracker to the
    target shard at cutover.

``StaticEvictionScorer`` / ``CostAwareEvictionScorer``
    Pluggable victim scoring for ``SemanticCache`` (``eviction=``).
    Static is the paper's §5.4 ``priority × 1/age × hitRate`` formula
    (the default — bit-identical to the seed behavior). Cost-aware
    prices an entry by what its residency actually buys:

        score = expected_hits_per_s × miss_cost_ms / bytes_per_entry

    expected hits from the observed hit intensity ``(hits+1)/age``
    (fresh entries inherit the admission sketch's repetition count as
    their prior), miss cost from the category's ``expected_tllm_ms``
    (the model time a hit avoids), and bytes/entry from
    ``economics.ResidencyModel`` under the active resident dtype — so
    the evictor maximizes hit-rate-per-resident-byte, the metric
    ``bench_admission`` gates on, instead of a hand-tuned priority.

Everything here is plain numpy on the host control plane: no device
state, no wall clock, deterministic at fixed seed. Per gated category
the tracker holds ``buffer_size × dim`` fp32 (~1.5 MB at the defaults)
plus the ``depth × width`` uint32 sketch (~32 KB).
"""

from __future__ import annotations

import zlib

import numpy as np

from repro_torch.core.economics import ResidencyModel, entry_value_density

# Sketch hashing: multiply-shift with fixed odd 64-bit constants per
# row; the shift keeps the high (well-mixed) product bits.
_HASH_SHIFT = np.uint64(17)


class QueryFingerprinter:
    """SimHash fingerprint: sign bits of ``n_bits`` fixed random
    projections, packed into one uint64 key.

    The projection matrix is seeded deterministically, so fingerprints
    are stable across processes and shards, and at 64 bits distinct
    intents essentially never collide. What SimHash alone can NOT
    deliver on realistic paraphrase noise is keeping two paraphrases of
    one intent on one key (every near-zero projection margin flips) —
    that is the similarity ring buffer's job in ``CategoryTracker``.
    """

    def __init__(self, dim: int, n_bits: int = 64, seed: int = 0):
        if not (1 <= n_bits <= 64):
            raise ValueError("n_bits must be in [1, 64]")
        self.dim = dim
        self.n_bits = n_bits
        rng = np.random.default_rng(seed)
        self._proj = rng.standard_normal((dim, n_bits)).astype(np.float32)
        self._weights = (np.uint64(1) << np.arange(n_bits, dtype=np.uint64))

    def key(self, embedding: np.ndarray) -> int:
        emb = np.asarray(embedding, np.float32).reshape(-1)
        bits = (emb @ self._proj) >= 0.0
        return int((bits.astype(np.uint64) * self._weights).sum())


class FrequencySketch:
    """Conservative-update count-min sketch with periodic halving decay.

    ``observe(key)`` increments only the cells at the current minimum
    (conservative update — strictly less over-count than plain CMS) and
    returns the post-update estimate. Guarantees, property-tested in
    tests/test_admission.py:

        * never undercounts: ``estimate(k) ≥ true_count(k)`` (no decay)
        * bounded by traffic: ``estimate(k) ≤ total observations``
        * deterministic: same seed + same stream → identical state
        * ``decay()`` halves every estimate exactly (integer floor);
          auto-triggered every ``decay_every`` observations so the
          sketch tracks a sliding window, not all of history
        * ``merge`` adds cell-wise (same seed required): the merged
          sketch never undercounts the combined stream
    """

    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 0,
                 decay_every: int = 8192):
        if width < 1 or depth < 1:
            raise ValueError("width and depth must be positive")
        self.width = width
        self.depth = depth
        self.seed = seed
        self.decay_every = decay_every
        rng = np.random.default_rng(seed)
        self._a = rng.integers(1, 2**63, size=depth, dtype=np.uint64) \
            | np.uint64(1)                       # odd multipliers
        self._b = rng.integers(0, 2**63, size=depth, dtype=np.uint64)
        self._rows = np.arange(depth)
        self.counts = np.zeros((depth, width), np.uint32)
        self.observations = 0
        self._since_decay = 0

    def _cells(self, key: int) -> np.ndarray:
        k = np.uint64(key)
        h = (self._a * k + self._b) >> _HASH_SHIFT   # uint64 wrap is fine
        return (h % np.uint64(self.width)).astype(np.int64)

    def estimate(self, key: int) -> int:
        return int(self.counts[self._rows, self._cells(key)].min())

    def observe(self, key: int) -> int:
        """Count one occurrence; returns the post-update estimate."""
        cells = self._cells(key)
        cur = self.counts[self._rows, cells]
        new = np.uint32(int(cur.min()) + 1)
        self.counts[self._rows, cells] = np.maximum(cur, new)
        self.observations += 1
        self._since_decay += 1
        if self.decay_every and self._since_decay >= self.decay_every:
            self.decay()
        return int(new)

    def decay(self) -> None:
        """Halve every cell (sliding-window aging, TinyLFU-style)."""
        self.counts >>= np.uint32(1)
        self._since_decay = 0

    def merge(self, other: "FrequencySketch") -> None:
        """Cell-wise add ``other`` into this sketch (same seed/shape)."""
        if (self.width, self.depth, self.seed) != \
                (other.width, other.depth, other.seed):
            raise ValueError("merge: incompatible sketch parameters")
        self.counts = self.counts + other.counts
        self.observations += other.observations


class CategoryTracker:
    """One category's repetition state: representative ring buffer +
    fingerprinter + frequency sketch.

    ``observe(emb, tau)`` resolves the query to a canonical key — the
    nearest ring-buffer representative's key when its cosine clears
    ``tau`` (pass the category's own hit threshold), else a freshly
    minted SimHash key with the query enrolled as a new representative —
    then counts the key in the sketch and returns the post-update
    repetition estimate. Everything is a deterministic function of the
    observation order (argmax ties break to the lowest buffer slot), so
    identical per-category streams give identical decisions on any
    shard. Tail queries that never repeat each occupy one ring slot and
    age out; an intent re-queried within the window inherits its
    representative's key and crosses the admission bar.
    """

    def __init__(self, dim: int, tau: float = 0.80,
                 buffer_size: int = 1024, n_bits: int = 64,
                 width: int = 2048, depth: int = 4, seed: int = 0,
                 decay_every: int = 8192):
        self.tau = tau
        self.fingerprinter = QueryFingerprinter(dim, n_bits, seed=seed)
        self.sketch = FrequencySketch(width, depth,
                                      seed=seed ^ 0x9E3779B9,
                                      decay_every=decay_every)
        self._buf_emb = np.zeros((buffer_size, dim), np.float32)
        self._buf_key = np.zeros(buffer_size, np.uint64)
        self._buf_n = 0
        self._buf_pos = 0

    @property
    def representatives(self) -> int:
        return self._buf_n

    def key_of(self, embedding: np.ndarray, tau: float | None = None) -> int:
        """Canonical repetition key; enrolls unseen queries as
        representatives but adds no count."""
        t = self.tau if tau is None else tau
        emb = np.asarray(embedding, np.float32).reshape(-1)
        if self._buf_n:
            sims = self._buf_emb[:self._buf_n] @ emb
            j = int(np.argmax(sims))
            if float(sims[j]) >= t:
                return int(self._buf_key[j])
        key = self.fingerprinter.key(emb)
        self._buf_emb[self._buf_pos] = emb
        self._buf_key[self._buf_pos] = np.uint64(key)
        self._buf_pos = (self._buf_pos + 1) % len(self._buf_key)
        self._buf_n = min(self._buf_n + 1, len(self._buf_key))
        return key

    def observe(self, embedding: np.ndarray,
                tau: float | None = None) -> int:
        return self.sketch.observe(self.key_of(embedding, tau))

    def observe_batch(self, embeddings: np.ndarray,
                      tau: float | None = None) -> np.ndarray:
        """Sequential-equivalent batched observe: ONE ``(n_reps, B)``
        matmul scores the whole batch against the pre-batch ring buffer
        instead of an O(buffer·dim) host matvec per item, then the
        items resolve IN ORDER so intra-batch enrollments (an item
        minting a new representative that canonicalizes a later item)
        behave exactly like B sequential ``observe`` calls: slots
        (re)written within the batch are re-scored with a per-slot dot
        (at most B of them), everything else reads the snapshot column.
        Tie-breaking (argmax → lowest slot) matches the sequential
        path. B == 1 routes through ``observe`` itself, so single-item
        streams — the simulator's per-miss inserts — are bit-identical
        to the pre-batching behavior.
        """
        t = self.tau if tau is None else tau
        embs = np.atleast_2d(np.asarray(embeddings, np.float32))
        B = embs.shape[0]
        if B == 1:
            return np.asarray([self.observe(embs[0], t)], np.int64)
        base_n = self._buf_n
        snap = (self._buf_emb[:base_n] @ embs.T if base_n
                else np.zeros((0, B), np.float32))
        touched: set[int] = set()      # ring slots written by this batch
        out = np.empty(B, np.int64)
        for i in range(B):
            n = self._buf_n
            if n:
                sims = np.full(n, -np.inf, np.float32)
                m = min(base_n, n)
                sims[:m] = snap[:m, i]
                for j in touched:
                    sims[j] = self._buf_emb[j] @ embs[i]
                j = int(np.argmax(sims))
                if float(sims[j]) >= t:
                    out[i] = self.sketch.observe(int(self._buf_key[j]))
                    continue
            key = self.fingerprinter.key(embs[i])
            self._buf_emb[self._buf_pos] = embs[i]
            self._buf_key[self._buf_pos] = np.uint64(key)
            touched.add(self._buf_pos)
            self._buf_pos = (self._buf_pos + 1) % len(self._buf_key)
            self._buf_n = min(self._buf_n + 1, len(self._buf_key))
            out[i] = self.sketch.observe(key)
        return out

    def estimate(self, embedding: np.ndarray,
                 tau: float | None = None) -> int:
        return self.sketch.estimate(self.key_of(embedding, tau))

    def merge(self, other: "CategoryTracker") -> None:
        """Fold another shard's tracker in at migration: sketch counts
        add cell-wise; this side's representatives win. Keys are minted
        by the shared name-seeded fingerprinter, so counts from both
        sides keep referring to the same embeddings."""
        self.sketch.merge(other.sketch)


class AdmissionController:
    """Per-category repetition tracking for admission decisions.

    Trackers are created lazily per category and seeded from
    ``crc32(category name)`` — NOT from the owning cache's seed — so
    every shard of a sharded cache derives the identical tracker for
    the categories it serves, and the single-vs-sharded parity property
    holds with admission enabled. ``export_state`` / ``adopt_state``
    hand a category's tracker across shards at migration cutover so
    repetition history survives the move.
    """

    def __init__(self, dim: int, buffer_size: int = 1024,
                 n_bits: int = 64, width: int = 2048, depth: int = 4,
                 decay_every: int = 8192):
        self.dim = dim
        self.buffer_size = buffer_size
        self.n_bits = n_bits
        self.width = width
        self.depth = depth
        self.decay_every = decay_every
        self._trackers: dict[str, CategoryTracker] = {}

    def tracker(self, category: str) -> CategoryTracker:
        if category not in self._trackers:
            self._trackers[category] = CategoryTracker(
                self.dim, buffer_size=self.buffer_size,
                n_bits=self.n_bits, width=self.width, depth=self.depth,
                seed=zlib.crc32(category.encode()),
                decay_every=self.decay_every)
        return self._trackers[category]

    def observe(self, category: str, embedding: np.ndarray,
                tau: float | None = None) -> int:
        """Count one occurrence of the query's canonical key; returns
        the post-update repetition estimate (1 = first sighting)."""
        return self.tracker(category).observe(embedding, tau)

    def observe_batch(self, category: str, embeddings: np.ndarray,
                      tau: float | None = None) -> np.ndarray:
        """Batched ``observe`` over one category's items (in stream
        order): one ring-buffer matmul for the batch instead of a host
        matvec per item, with sequential-equivalent enrollment."""
        return self.tracker(category).observe_batch(embeddings, tau)

    def estimate(self, category: str, embedding: np.ndarray,
                 tau: float | None = None) -> int:
        if category not in self._trackers:
            return 0
        return self.tracker(category).estimate(embedding, tau)

    # -- migration ---------------------------------------------------------
    def export_state(self, category: str) -> CategoryTracker | None:
        """Detach and return the category's tracker (None if untracked)."""
        return self._trackers.pop(category, None)

    def adopt_state(self, category: str,
                    state: CategoryTracker | None) -> None:
        if state is None:
            return
        if category in self._trackers:
            self._trackers[category].merge(state)
        else:
            self._trackers[category] = state

    def stats(self) -> dict:
        return {c: {"observations": t.sketch.observations,
                    "representatives": t.representatives}
                for c, t in sorted(self._trackers.items())}


# ---------------------------------------------------------------------------
# Eviction scorers (SemanticCache ``eviction=``). Higher = more valuable.
# ---------------------------------------------------------------------------

class StaticEvictionScorer:
    """§5.4: score = priority × 1/age × (hits + 1). The seed formula and
    the default — existing eviction behavior is bit-identical."""

    name = "static"

    def score(self, cache, slots: np.ndarray) -> np.ndarray:
        now = cache._now()
        age = np.maximum(now - cache.slot_inserted[slots], 1e-3)
        _, pri_by_cid = cache._per_category_arrays()
        pri = pri_by_cid[cache.slot_category[slots]]
        return pri * (1.0 / age) * (cache.slot_hits[slots] + 1)

    def fresh_score(self, cache, cid: int, freq: int = 1) -> float:
        """A just-inserted entry: hits = 0, age clamped to 1e-3 — the
        sequential-path pending score (repetition count ignored)."""
        name = cache._cat_names.get(cid, "__default__")
        return float(cache.policies.effective(name).priority) * 1e3


class CostAwareEvictionScorer:
    """Economic scoring: expected-hits × miss-cost per resident byte.

    ``score = (hits + 1)/age × expected_tllm_ms / bytes_per_entry`` —
    the ms of downstream model time a slot's residency saves per second,
    per byte it pins (``economics.entry_value_density``). Bytes/entry
    come from ``ResidencyModel`` under the cache's resident dtype, so
    int8 residency uniformly re-prices the denominator; miss cost from
    the category's ``expected_tllm_ms``, so a code_generation entry
    (500 ms model) outranks an equally-hit chat entry (200 ms) instead
    of leaning on the hand-tuned ``priority``. Fresh entries use the
    admission sketch's repetition count as their expected-hits prior —
    SCALM's cluster-level repetition ranking at insert time.
    """

    name = "cost_aware"

    def _tables(self, cache) -> tuple[np.ndarray, float]:
        """cid → miss-cost table + bytes/entry under the residency."""
        n = (max(cache._cat_names) + 1) if cache._cat_names else 0
        cost = np.full(n, 500.0, np.float64)
        for cid, name in cache._cat_names.items():
            cost[cid] = cache.policies.get(name).expected_tllm_ms
        bpe = ResidencyModel(dim=cache.dim,
                             emb_dtype=cache.index.emb_dtype).bytes_per_entry()
        return cost, float(bpe)

    def score(self, cache, slots: np.ndarray) -> np.ndarray:
        now = cache._now()
        age = np.maximum(now - cache.slot_inserted[slots], 1e-3)
        cost_by_cid, bpe = self._tables(cache)
        cost = cost_by_cid[cache.slot_category[slots]]
        rate = (cache.slot_hits[slots] + 1) / age
        return entry_value_density(rate, cost, bpe)

    def fresh_score(self, cache, cid: int, freq: int = 1) -> float:
        name = cache._cat_names.get(cid, "__default__")
        cost = cache.policies.get(name).expected_tllm_ms
        bpe = ResidencyModel(dim=cache.dim,
                             emb_dtype=cache.index.emb_dtype).bytes_per_entry()
        # freq = the admission sketch's repetition count (1 when the
        # category admits unconditionally): observed pre-admission
        # frequency is the expected-hits prior, age clamps at 1e-3
        # exactly like score() on a zero-age slot.
        return float(entry_value_density(max(1, freq) / 1e-3, cost, bpe))


_SCORERS = {
    "static": StaticEvictionScorer,
    "cost_aware": CostAwareEvictionScorer,
}


def make_eviction_scorer(name: str):
    try:
        return _SCORERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown eviction policy {name!r} (have {sorted(_SCORERS)})")
