"""Sharded cache tier: category-aware placement, fan-out, live migration,
in PyTorch: the counterpart of ``repro.core.shard``, numpy above the
port's ``SemanticCache``. Every shard's index lives on the card unless
``device="cpu"`` is passed; on one card the shards share it, and the
front door searches them one after another.

The paper's §7.4 scaling note — beyond ~10 M entries, shard by category —
meets the ROADMAP north star here: one `SemanticCache` data plane tops
out at one device's memory no matter how fast the fused lookup loop is, so
the resident tier must spread category quotas across N device-resident
shards WITHOUT giving up the masked-search or delta-sync guarantees.
Three pieces:

* ``ShardPlanner`` — places categories on shards by **quota bytes**
  (``economics.ResidencyModel.quota_bytes``: a category's entry ceiling
  × bytes/entry under the resident dtype), greedy longest-processing-time
  bin-packing instead of the crc32-mod hash that piles head categories
  onto one shard (``CRC32Planner`` keeps that baseline as the no-planner
  fallback and the benchmark contrast — on the Table-1 quotas, crc32 %2
  lands 83 % of quota bytes on one shard).
* ``ShardedSemanticCache`` — the existing ``SemanticCache`` read/write
  API over N shards. ``lookup_batch`` partitions the query batch per
  shard by category, fans out to each shard's device-resident index
  (each shard captures its own search graph per batch bucket and runs
  the ``frontier_hop``/``flat_topk`` kernels unchanged), and merges the
  classified {hit, expired, miss} results — plus the pre-threshold
  re-rank candidates the int8 tier needs — back into request order.
  ``insert_batch``/``sweep_expired`` route writes through each shard's
  dirty-log delta sync; ``sync_stats``/``last_lookup_stats`` aggregate
  across shards with a per-shard breakdown. Because search is
  category-masked and quotas are per-category fractions of the GLOBAL
  capacity (each shard gets ``quota_capacity = total``), a sharded cache
  is behaviorally identical to a single cache on the same workload —
  held bit-identical for shard counts {1, 2, 4}
  (tests/test_torch_shard.py, beside the reference).
* ``CategoryMigration`` — live category movement (quota reassignment or
  an ``AdaptiveController``-driven ``rebalance``): COPY-THEN-CUTOVER.
  The drain exports the source rows (``index.export_rows``: fp32 rows +
  inserted timestamps + the int8/scale mirror) batch by batch into the
  target via ``adopt_entries`` — timestamps, hit counts and doc payloads
  preserved; requantization is deterministic, so the target's int8+scale
  rows come out bit-identical — while the OLD shard keeps serving every
  read and write until cutover. Cutover runs catch-up passes (entries
  written mid-drain), reconciles copies whose source entry was evicted
  during the drain, flips the planner's routing, then purges the source.
  At no point does a read see a missing or doubly-served entry. The
  cutover is journaled (fence → catchup → reconcile → flip → purge →
  unfence) with crash points between steps: an injected crash at ANY
  step index leaves exactly one authoritative owner — source until the
  journaled flip, target after — and ``recover()`` finishes or rolls
  back from whatever prefix the journal records.

Degraded mode (``core/faults.FaultInjector`` wired via ``faults=``):
a lookup routed to a shard inside a scheduled outage window resolves as
a counted ``degraded_miss`` — never an exception, never a hit-rate
denominator entry — and a write to a down shard lands in a bounded
per-shard write-behind queue that replays item by item through the
front door once the shard recovers (``crash_point("wb_replay")`` sites
bracket each item: an acknowledged write is applied exactly once no
matter where a crash lands — the ``_wb_applied`` id set deduplicates a
crash between apply and dequeue). Enqueued writes are ACKNOWLEDGED (the
caller got a normal INVALID-slot return); the zero-acknowledged-write-
loss tests (tests/test_torch_replication.py) pin that replay preserves
them all. An absent/inert injector leaves every hook a no-op, so the
no-fault path is bit-identical to the pre-fault-injection code.

Replication (``replication=`` — an explicit ``{category: k}`` map or a
quota-mass threshold float: quota ≥ θ ⇒ 2 replicas): head categories
are resident on a replica SET instead of exactly one shard. The planner
places the primary by LPT as always, then adds k−1 replicas on the
lightest shards not already holding the category (replica byte weight
counts toward the bins, so total placed bytes stay balanced). The front
door fans every write to all live replicas in the same batched round
(each replica's dirty-log delta sync stays O(batch)); lookups route
deterministically round-robin across the replica set, failing over to
the next live replica inside an outage window (counted
``failover_reads``) — a down shard with a live replica serves hits, not
degraded_misses. Replicas answer bit-identically: identical per-
category insert streams + name-seeded admission give identical entry
sets, and serving-replica hit counts are echoed to the siblings through
a doc-correspondence registry so eviction scores stay in step; any
observed drift (a hit whose sibling copy is gone while the sibling is
live) increments ``replica_divergence`` and prunes the mapping.
Replicated categories are pinned — they never migrate; their outage
story IS the replica set.

Self-healing (``rebalance_after_s=``): an outage that persists past the
threshold triggers ``OutageRebalance`` for each UNREPLICATED category
homed on the dead shard — the resident set is rebuilt from the shard's
(separately durable) document store into a live target, routing flips,
and the dead shard's write-behind queue drains into the new owner,
journaled with ``crash_point("outage_rebalance")`` sites between steps
(rebuild → flip → wb_drain → done; pre-flip crashes leave the dead
shard nominally authoritative and recovery re-runs or aborts, post-flip
crashes finish forward with the same exactly-once wb dedup). When the
original shard recovers, its stale copies are demoted (purged) and the
category re-absorbs to its planned home through a normal live
``CategoryMigration``.

Clock semantics: shards are constructed with ``search_ms = insert_ms =
0`` and the sharded front door advances the SHARED clock exactly once
per fan-out round — a lookup across 3 shards costs one ``search_ms``
(the fan-out is parallel on real hardware), and the ``now`` every shard
classifies TTLs against is the same instant a single cache would use.
All shards also share the cache-relative time origin ``_t0``, so
``inserted`` timestamps transfer across shards unrebased.
"""

from __future__ import annotations

import zlib
from collections import deque
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.cache import CacheResult, SemanticCache
from repro_torch.core.clock import Clock, SimClock
from repro_torch.core.economics import ResidencyModel
from repro_torch.core.faults import FaultInjector
from repro_torch.core.hnsw import INVALID
from repro_torch.core.metrics import CategoryStats, overall_row
from repro_torch.core.policy import PolicyEngine
from repro_torch.obs.trace import NULL_SPAN


def crc32_shard(category: str, n_shards: int) -> int:
    """The quota-blind hash placement: crc32(name) mod N. Kept as the
    no-planner fallback (serving/router.py) and the baseline the
    placement benchmark beats."""
    return zlib.crc32(category.encode()) % max(1, n_shards)


class CRC32Planner:
    """Hash placement behind the planner interface — the degenerate
    baseline: ignores quota bytes entirely, so head categories collide
    (benchmarks/bench_shard.py measures the resulting imbalance).
    ``assign`` still honors migrations via an override table."""

    def __init__(self, n_shards: int):
        self.n_shards = max(1, n_shards)
        self._overrides: dict[str, int] = {}

    def shard_of(self, category: str) -> int:
        ov = self._overrides.get(category)
        return crc32_shard(category, self.n_shards) if ov is None else ov

    def replica_set(self, category: str) -> list[int]:
        """Hash placement is single-home: every category has exactly one
        replica (the planner interface the front door routes by)."""
        return [self.shard_of(category)]

    def assign(self, category: str, shard: int, nbytes: int = 0) -> None:
        self._overrides[category] = int(shard)


class ShardPlanner:
    """Assigns categories to shards by quota-byte budgets.

    A category's placement weight is the resident bytes its quota
    ceiling pins: ``int(quota · capacity) × bytes/entry`` under the
    active ``ResidencyModel`` (so int8 residency shrinks every weight
    ~4x but keeps the RELATIVE packing identical). ``plan`` runs greedy
    LPT bin-packing — categories sorted by weight descending, each
    dropped on the currently lightest shard — which is deterministic
    (ties break by name, then by shard id) and within 4/3 of optimal.
    Categories first seen after planning (``shard_of`` on an unknown
    name) are placed on the lightest shard at their policy's quota
    weight.

    ``replication`` adds a replication pass after primary placement:
    an explicit ``{category: k}`` map, or a float quota-mass threshold
    (categories with quota ≥ θ get 2 replicas). Each extra replica goes
    on the lightest shard not already holding the category and its byte
    weight counts toward that bin, so LPT keeps balancing TOTAL placed
    bytes, copies included. ``assignments`` still names the PRIMARY
    (what ``shard_of`` returns); the full set is ``replica_set``.
    """

    def __init__(self, n_shards: int, capacity: int,
                 residency: ResidencyModel | None = None,
                 policies: PolicyEngine | None = None,
                 replication: dict[str, int] | float | None = None):
        self.n_shards = max(1, n_shards)
        self.capacity = capacity
        self.residency = residency or ResidencyModel()
        self.policies = policies
        self.replication = replication
        self.assignments: dict[str, int] = {}
        self._bytes: dict[str, int] = {}
        self.shard_bytes: list[int] = [0] * self.n_shards
        # category -> [primary, replica, ...]; only k >= 2 entries live
        # here — single-home categories resolve through shard_of.
        self.replica_sets: dict[str, list[int]] = {}

    @classmethod
    def from_policies(cls, policies: PolicyEngine, n_shards: int,
                      capacity: int, dim: int = 384,
                      emb_dtype: str = "float32",
                      graph_degree: int = 32,
                      replication: dict[str, int] | float | None = None,
                      ) -> "ShardPlanner":
        """Plan every registered category from its policy quota; the
        residency model prices bytes/entry for the resident dtype."""
        planner = cls(n_shards, capacity,
                      residency=ResidencyModel(dim=dim, emb_dtype=emb_dtype,
                                               graph_degree=graph_degree),
                      policies=policies, replication=replication)
        cachable = {n: policies.get(n).quota for n in policies.categories()
                    if policies.get(n).allow_caching
                    and policies.get(n).quota > 0}
        planner.plan(cachable)
        # Compliance-blocked / zero-quota categories still need a stable
        # home for their (rejected) traffic: zero placement weight.
        for name in sorted(policies.categories()):
            if name not in planner.assignments:
                planner._place(name, 0)
        return planner

    # -- placement -------------------------------------------------------------
    def quota_bytes(self, quota_fraction: float) -> int:
        return self.residency.quota_bytes(quota_fraction, self.capacity)

    def replica_count(self, name: str, quota: float) -> int:
        """Replicas the spec asks for, capped at the shard count."""
        spec = self.replication
        if spec is None:
            return 1
        if isinstance(spec, dict):
            k = int(spec.get(name, 1))
        else:
            k = 2 if quota >= float(spec) else 1
        return max(1, min(k, self.n_shards))

    def plan(self, quotas: dict[str, float]) -> dict[str, int]:
        """(Re)pack ``quotas`` from scratch; returns the assignment."""
        self.assignments.clear()
        self._bytes.clear()
        self.shard_bytes = [0] * self.n_shards
        self.replica_sets.clear()
        order = sorted(quotas, key=lambda c: (-self.quota_bytes(quotas[c]), c))
        for name in order:
            self._place(name, self.quota_bytes(quotas[name]))
        # Replication pass: heaviest categories first (same order), each
        # extra copy on the lightest shard that doesn't hold the
        # category yet — copies add real byte weight to the bins.
        for name in order:
            k = self.replica_count(name, quotas[name])
            if k <= 1:
                continue
            reps = [self.assignments[name]]
            w = self.quota_bytes(quotas[name])
            while len(reps) < k:
                cands = [i for i in range(self.n_shards) if i not in reps]
                if not cands:
                    break
                s = min(cands, key=lambda i: (self.shard_bytes[i], i))
                reps.append(s)
                self.shard_bytes[s] += w
            if len(reps) > 1:
                self.replica_sets[name] = reps
        return dict(self.assignments)

    def _place(self, category: str, nbytes: int) -> int:
        shard = min(range(self.n_shards),
                    key=lambda i: (self.shard_bytes[i], i))
        self.assignments[category] = shard
        self._bytes[category] = nbytes
        self.shard_bytes[shard] += nbytes
        return shard

    def shard_of(self, category: str) -> int:
        if category not in self.assignments:
            quota = (self.policies.get(category).quota
                     if self.policies is not None else 0.0)
            return self._place(category, self.quota_bytes(quota))
        return self.assignments[category]

    def replica_set(self, category: str) -> list[int]:
        """Every shard holding the category, primary first. Single-home
        categories (the common case) are just ``[shard_of]``."""
        reps = self.replica_sets.get(category)
        return list(reps) if reps else [self.shard_of(category)]

    def assign(self, category: str, shard: int,
               nbytes: int | None = None) -> None:
        """Pin a category to a shard (migration cutover / manual
        placement), moving its byte weight between bins."""
        old = self.assignments.get(category)
        weight = self._bytes.get(category, 0) if nbytes is None else nbytes
        if old is not None:
            self.shard_bytes[old] -= self._bytes.get(category, 0)
        self.assignments[category] = int(shard)
        self._bytes[category] = weight
        self.shard_bytes[shard] += weight

    # -- reporting -------------------------------------------------------------
    def imbalance(self) -> float:
        """max/mean planned shard bytes — 1.0 is a perfect spread (the
        placement gate bench_shard tracks against the crc32 baseline)."""
        mean = sum(self.shard_bytes) / self.n_shards
        return max(self.shard_bytes) / mean if mean > 0 else 1.0

    def report(self) -> dict:
        return {"n_shards": self.n_shards,
                "emb_dtype": self.residency.emb_dtype,
                "shard_bytes": list(self.shard_bytes),
                "imbalance": round(self.imbalance(), 4),
                "assignments": dict(self.assignments),
                "replica_sets": {c: list(r)
                                 for c, r in sorted(self.replica_sets.items())}}


class ShardedMetrics:
    """``MetricsRegistry`` view over the shards. ``cat(name)`` resolves
    to the category's serving shard (so simulator/engine counter writes
    land where the category lives); the merged views sum counters across
    shards — a migrated category's pre-move history stays on its old
    shard's registry and the merge reunifies it."""

    def __init__(self, parent: "ShardedSemanticCache"):
        self._parent = parent

    def cat(self, name: str) -> CategoryStats:
        shard = self._parent.shards[self._parent.shard_of(name)]
        return shard.metrics.cat(name)

    @property
    def per_category(self) -> dict[str, CategoryStats]:
        merged: dict[str, CategoryStats] = {}
        for shard in self._parent.shards:
            for name, st in shard.metrics.per_category.items():
                acc = merged.setdefault(name, CategoryStats())
                for f in CategoryStats.__dataclass_fields__:
                    setattr(acc, f, getattr(acc, f) + getattr(st, f))
        return merged

    def overall_hit_rate(self) -> float:
        per = self.per_category.values()
        lookups = sum(s.lookups for s in per)
        hits = sum(s.hits for s in per)
        return hits / lookups if lookups else 0.0

    def snapshot(self) -> dict:
        """Per-category rows plus the ``"_overall"`` aggregate row
        (same contract as ``MetricsRegistry.snapshot``)."""
        per = self.per_category
        snap = {k: v.to_dict() for k, v in sorted(per.items())}
        snap["_overall"] = overall_row(per)
        return snap

    def slo_report(self) -> dict:
        """Per-category availability SLO view: the degraded fraction of
        lookups plus the OBSERVED degraded window (``degraded_seconds``
        accrued by the front door between ops — no re-deriving overlap
        from the fault schedule) and the replica count that bounds it."""
        out = {}
        for name, st in sorted(self.per_category.items()):
            out[name] = {
                "availability": round(st.availability, 4),
                "lookups": st.lookups,
                "degraded_misses": st.degraded_misses,
                "degraded_seconds": round(st.degraded_seconds, 3),
                "replicas": len(self._parent.replica_set(name)),
            }
        return out


@dataclass
class _WbItem:
    """One acknowledged write parked in a shard's write-behind queue.

    ``wb_id`` is the exactly-once replay token: replay applies an item,
    records the id in the front door's ``_wb_applied`` set, THEN
    dequeues — a crash between apply and dequeue leaves the item queued
    but marked, so the retry skips the apply and never double-inserts.
    ``mode`` routes the replay: "front" re-enters through the front door
    (the category may have migrated while queued), "replica" catches a
    recovered replica up DIRECTLY (its live siblings already applied the
    write during the outage — fanning it out again would double-apply),
    back-dating ``slot_inserted`` to the acknowledgment time ``t_enq``
    so ages — and therefore TTL expiry and eviction scores — converge
    bit-identically with the siblings'.
    """

    wb_id: int
    mode: str                   # "front" | "replica"
    uid: int                    # replica-registry uid ("replica" mode)
    emb: np.ndarray
    category: str
    request: str
    response: str
    meta: dict | None
    t_enq: float                # absolute clock time at acknowledgment


class CategoryMigration:
    """Live category movement between shards: copy-then-cutover.

    Protocol (single-writer; steps interleave freely with serving):

    1. **Drain** (``step``): copy up to ``batch_size`` not-yet-copied
       live entries source → target via ``export_rows`` →
       ``adopt_entries`` (fp32 rows, preserved ``inserted`` timestamps
       and hit counts, doc payloads re-minted under the target's doc-id
       sequence; deterministic requantization reproduces the int8+scale
       rows bit-identically). The source keeps serving ALL reads and
       writes for the category — copies on the target are invisible to
       its traffic because search is category-masked and routing still
       points at the source.
    2. **Cutover** (``cutover``): a write fence goes up for the
       category; catch-up passes copy entries inserted during the drain
       (and re-copy any whose target copy was lost); reconciliation
       drops target copies whose source entry was evicted mid-drain and
       refreshes drained-while-serving hit counts; the planner's routing
       flips (the point of no return); the source purges its copies; the
       fence drops and queued writes replay into the new owner. Reads
       are correct at every intermediate point: before the flip the
       source holds (and serves) the authoritative set, after it the
       target does.

    Crash safety: each completed cutover step appends to ``journal``,
    and ``faults.crash_point("migration")`` sites sit between steps (and
    inside the drain's adopt→registry window, the one place a copy can
    exist that the registry doesn't know about). ``recover()`` reads the
    journal: pre-flip the source never lost authority, so the migration
    aborts (or, with ``mode="resume"``, sweeps orphan target copies and
    re-runs — every pre-flip step is idempotent); post-flip the target
    owns the category and recovery finishes the purge + fence replay.
    Either way exactly one shard serves the category afterwards, and
    every fenced (acknowledged) write survives into the final owner.
    """

    def __init__(self, parent: "ShardedSemanticCache", category: str,
                 src_id: int, dst_id: int, batch_size: int = 64):
        self.parent = parent
        self.category = category
        self.src_id = src_id
        self.dst_id = dst_id
        self.batch_size = batch_size
        self.moved = 0
        self.done = False
        # src doc_id -> (target slot, target doc_id): the copy registry
        # reconciliation audits at cutover.
        self._copied: dict[int, tuple[int, int]] = {}
        # Completed protocol steps, in order. In-process it is just a
        # list; it stands in for the persisted step journal a multi-
        # process deployment would fsync — recover() trusts it alone.
        self.journal: list[str] = []
        # Write fence: while up, front-door writes for the category
        # queue here (bounded by parent.write_behind_capacity) instead
        # of racing the flip; _drain_fence replays them to the owner.
        self.fenced = False
        self.fence_queue: deque = deque()

    # -- helpers ---------------------------------------------------------------
    def _ends(self) -> tuple[SemanticCache, SemanticCache]:
        return (self.parent.shards[self.src_id],
                self.parent.shards[self.dst_id])

    def _pending(self) -> np.ndarray:
        """Source slots still to copy: live, this category, not in the
        copy registry (covers both fresh writes and dropped copies)."""
        src, _ = self._ends()
        slots = src.category_slots(self.category)
        todo = [s for s in slots
                if int(src.slot_doc[s]) not in self._copied]
        return np.asarray(todo, np.int64)

    def _owns(self, slot: int, doc_id: int) -> bool:
        _, dst = self._ends()
        return bool(dst.slot_valid[slot]) and int(dst.slot_doc[slot]) == doc_id

    def _journal(self, entry: str) -> None:
        if entry not in self.journal:
            self.journal.append(entry)
            self.parent._event("migration_step", category=self.category,
                               step=entry, src=self.src_id, dst=self.dst_id)

    def _cp(self) -> None:
        faults = getattr(self.parent, "faults", None)
        if faults is not None:
            faults.crash_point("migration")

    @property
    def flipped(self) -> bool:
        """Past the point of no return? The journaled flip is the single
        bit authority pivots on."""
        return "flip" in self.journal

    @property
    def owner_id(self) -> int:
        """The shard currently authoritative for the category — what
        ``ShardedSemanticCache.shard_of`` routes by at every protocol
        point, crashed or not."""
        return self.dst_id if self.flipped else self.src_id

    # -- protocol --------------------------------------------------------------
    def step(self, max_entries: int | None = None) -> int:
        """Copy one batch; returns entries moved (0 = drained)."""
        if self.done:
            return 0
        self._cp()      # a drain-batch boundary
        # Span "migration_copy": one drain batch — the source store gets
        # plus the target's adopt (store put_many) charge inside it.
        with self.parent._span("migration_copy", category=self.category,
                               src=self.src_id, dst=self.dst_id):
            src, dst = self._ends()
            slots = self._pending()[:max_entries or self.batch_size]
            if slots.size == 0:
                return 0
            docs, keep = [], []
            for s in slots:
                doc = src.store.get(int(src.slot_doc[s]))
                if doc is None:  # store lost the doc: drop at the source too
                    src._evict_slot(int(s), reason="missing_doc")
                    continue
                docs.append(doc)
                keep.append(int(s))
            if not keep:
                return 0
            slots = np.asarray(keep, np.int64)
            rows = src.index.export_rows(slots)
            try:
                adopted = dst.adopt_entries(rows["emb"],
                                            [self.category] * len(keep),
                                            rows["inserted"],
                                            src.slot_hits[slots], docs)
            except RuntimeError:
                # Target out of physical slots (adopt_entries checks before
                # mutating anything): undo the drain so the source stays
                # authoritative and the migration is retryable after space
                # frees up or with a bigger shard_capacity.
                self.abort()
                raise
            # The adopt→registry window: a crash HERE leaves copies on the
            # target that _copied doesn't know about (orphans). Pre-flip
            # they are invisible to traffic (routing still points at the
            # source); recover() sweeps or purges them.
            self._cp()
            for s, (dst_slot, dst_doc) in zip(slots, adopted):
                self._copied[int(src.slot_doc[s])] = (dst_slot, dst_doc)
            self.moved += len(keep)
            return len(keep)

    def remaining(self) -> int:
        return int(self._pending().size)

    def abort(self) -> None:
        """Cancel before the flip: drop every target copy — registry-
        known AND orphans a crash in the adopt→registry window left
        behind (pre-flip the target never serves the category, so its
        category slots are exactly the copies) — keep the source (which
        served throughout) authoritative, unregister the migration so it
        can be retried, and replay any fenced writes to the source."""
        if self.done:
            return
        if self.flipped:
            raise RuntimeError(
                "cannot abort after the routing flip — the target owns "
                f"{self.category!r}; recover()/resume instead")
        _, dst = self._ends()
        for s in dst.category_slots(self.category):
            dst._evict_slot(int(s), reason="migration_abort")
        self._copied.clear()
        self.parent._migrations.pop(self.category, None)
        self.done = True
        self._journal("abort")
        self._drain_fence()

    def cutover(self) -> None:
        """Final catch-up + reconcile behind a write fence, then flip
        routing, purge the source, and replay fenced writes into the new
        owner. Journaled step by step with a crash point between steps;
        every pre-flip step is idempotent, so ``recover(mode="resume")``
        can re-run from the top after a crash at any index."""
        if self.done:
            return
        src, dst = self._ends()
        self._cp()
        # Fence first: from here to the flip, front-door writes for the
        # category queue on the migration instead of landing on either
        # end — a late write can no longer race the routing flip, and
        # the catch-up fixpoint below sees a quiescent source.
        self.fenced = True
        self._journal("fence")
        self._cp()
        # Catch-up until a fixpoint: no pending entries AND every live
        # source entry's copy still exists on the target (a copy lost to
        # target-side eviction while the source entry lives re-copies).
        while True:
            if self.step(self.batch_size):
                continue
            live = {int(src.slot_doc[s])
                    for s in src.category_slots(self.category)}
            lost = [d for d in self._copied
                    if d in live and not self._owns(*self._copied[d])]
            if not lost:
                break
            for d in lost:
                del self._copied[d]
        self._journal("catchup")
        self._cp()
        # Reconcile: source evictions during the drain win (no
        # resurrection), and hits accrued while the source served
        # transfer so eviction scores stay continuous.
        live_slots = {int(src.slot_doc[s]): int(s)
                      for s in src.category_slots(self.category)}
        for src_doc, (dst_slot, dst_doc) in self._copied.items():
            if not self._owns(dst_slot, dst_doc):
                continue
            if src_doc not in live_slots:
                dst._evict_slot(dst_slot, reason="migration_reconcile")
            else:
                dst.slot_hits[dst_slot] = src.slot_hits[live_slots[src_doc]]
        self._journal("reconcile")
        self._cp()
        # Flip routing — the point of no return. The category's
        # admission sketch moves with it: both ends derive the tracker
        # from the category NAME, so the counts transfer verbatim and
        # repetition history (admit-on-kth-touch progress) survives the
        # migration instead of resetting mid-stream.
        self.parent.planner.assign(self.category, self.dst_id)
        dst.admission.adopt_state(self.category,
                                  src.admission.export_state(self.category))
        self._journal("flip")
        self._cp()
        self._finish_post_flip()

    def _finish_post_flip(self) -> None:
        """Purge the source's copies and drop the fence — the post-flip
        tail, shared by the success path and post-flip recovery. Both
        steps are idempotent."""
        src, _ = self._ends()
        for s in src.category_slots(self.category):
            src._evict_slot(int(s), reason="migrated")
        self._journal("purge")
        self._cp()
        self.parent._migrations.pop(self.category, None)
        self.done = True
        self._journal("unfence")
        self._drain_fence()

    def _drain_fence(self) -> None:
        """Replay fenced (acknowledged) writes through the front door.
        Runs after the migration is unregistered, so routing points at
        the final owner and the replay takes the normal write path —
        admission, quota, and (if that owner is down) the write-behind
        queue all apply."""
        self.fenced = False
        if not self.fence_queue:
            return
        items = list(self.fence_queue)
        self.fence_queue.clear()
        embs = np.stack([it[0] for it in items])
        self.parent.insert_batch(embs, [self.category] * len(items),
                                 [it[1] for it in items],
                                 [it[2] for it in items],
                                 [it[3] for it in items])
        self.parent.fault_stats["fence_replayed"] += len(items)

    def recover(self, mode: str = "auto") -> str:
        """Resume-or-abort after a crash left the protocol mid-flight.

        Post-flip the journal names the target as owner, so the only
        legal move — whatever ``mode`` says — is to finish (idempotent
        purge + fence replay). Pre-flip the source never lost authority:
        ``"abort"`` (the ``"auto"`` default — cheapest path back to a
        steady state) rolls the copies back; ``"resume"`` sweeps orphan
        target copies from the adopt→registry window, then re-runs the
        drain + cutover from the top. Returns the action taken
        (``"resumed"`` | ``"aborted"`` | ``"noop"``)."""
        if self.done:
            return "noop"
        if self.flipped:
            self._finish_post_flip()
            return "resumed"
        if mode == "resume":
            _, dst = self._ends()
            known = {doc for (_, doc) in self._copied.values()}
            for s in dst.category_slots(self.category):
                if int(dst.slot_doc[s]) not in known:
                    dst._evict_slot(int(s), reason="migration_recover")
            self.run()
            return "resumed"
        self.abort()
        return "aborted"

    def run(self) -> int:
        """Drain to completion and cut over; returns entries moved."""
        while self.step():
            pass
        self.cutover()
        return self.moved


class OutageRebalance:
    """Evacuate an UNREPLICATED category off a DEAD shard.

    ``CategoryMigration`` cannot run here: its drain reads the source's
    index, and the source is unreachable. Instead the resident set is
    REBUILT on the target from the two places the data still exists —
    the source shard's document store (separately durable; shards
    persist fp32 embeddings per doc whenever a fault stack is wired) and
    the dead shard's write-behind queue (acknowledged writes the store
    never saw). Protocol, journaled with
    ``faults.crash_point("outage_rebalance")`` between steps:

    1. **rebuild** — sweep any partial target copies from a prior
       crashed attempt, then ``store.scan(category)`` → ``adopt_entries``
       in batches: original ``inserted`` timestamps reconstructed from
       each doc's absolute ``created_at``, hit counts start at zero (the
       source's in-memory hit counters died with it — an explicit,
       deterministic choice).
    2. **flip** — routing pivots to the target (point of no return).
    3. **wb_drain** — the dead shard's queued writes for the category
       replay into the NEW owner through the front door, with the same
       ``_wb_applied`` exactly-once dedup as normal wb replay. Draining
       strictly AFTER the journaled flip is what makes a crash safe: a
       pre-flip crash leaves every acknowledged write either in the
       still-intact queue or in the store, and recovery's rebuild sweep
       never touches the queue.
    4. **done** — unregister; the moved category is recorded in the
       parent's ``_moved_by_outage`` ledger so the source's eventual
       recovery can demote its stale copies and re-absorb the category.

    ``recover()``: post-flip crashes finish forward (idempotent drain +
    done); pre-flip crashes either re-run (``resume`` — the rebuild
    sweep makes step 1 idempotent) or abort back to the dead shard
    (``abort``: nothing was authoritative on the target yet).
    Duck-types the ``CategoryMigration`` surface the front door routes
    by (``owner_id``/``flipped``/``done``/``fenced``/``fence_queue``),
    so routing through ``_migrations`` works unchanged mid-protocol.
    """

    def __init__(self, parent: "ShardedSemanticCache", category: str,
                 src_id: int, dst_id: int, batch_size: int = 64):
        self.parent = parent
        self.category = category
        self.src_id = src_id
        self.dst_id = dst_id
        self.batch_size = batch_size
        self.moved = 0
        self.done = False
        self.journal: list[str] = []
        # Never fences: the source is down, so front-door writes already
        # divert to the write-behind queue; post-flip they route to the
        # target directly. Present for _migrations duck-typing only.
        self.fenced = False
        self.fence_queue: deque = deque()

    def _journal(self, entry: str) -> None:
        if entry not in self.journal:
            self.journal.append(entry)
            self.parent._event("rebalance_step", category=self.category,
                               step=entry, src=self.src_id, dst=self.dst_id)

    def _cp(self) -> None:
        faults = getattr(self.parent, "faults", None)
        if faults is not None:
            faults.crash_point("outage_rebalance")

    @property
    def flipped(self) -> bool:
        return "flip" in self.journal

    @property
    def owner_id(self) -> int:
        return self.dst_id if self.flipped else self.src_id

    # -- protocol --------------------------------------------------------------
    def _rebuild(self) -> None:
        """Sweep partial copies from a crashed prior attempt, then adopt
        the category's store-resident docs onto the target in batches.
        Docs without a persisted embedding cannot be rebuilt (fp32 runs
        before the fault stack wires ``durable_embeddings``) and are
        skipped — the entry is lost to the outage, not corrupted."""
        src, dst = (self.parent.shards[self.src_id],
                    self.parent.shards[self.dst_id])
        # Span "rebalance_rebuild": the store scan + adopt batches — the
        # only store charges the rebuild can incur land inside it.
        with self.parent._span("rebalance_rebuild", category=self.category,
                               src=self.src_id, dst=self.dst_id):
            for s in dst.category_slots(self.category):
                dst._evict_slot(int(s), reason="outage_rebuild_sweep")
            self._cp()
            docs = [d for d in src.store.scan(self.category)
                    if d.embedding is not None]
            t0 = self.parent._t0
            for lo in range(0, len(docs), self.batch_size):
                chunk = docs[lo:lo + self.batch_size]
                embs = np.stack([d.embedding_array() for d in chunk])
                inserted = np.asarray([d.created_at - t0 for d in chunk],
                                      np.float64)
                hits = np.zeros(len(chunk), np.int64)
                dst.adopt_entries(embs, [self.category] * len(chunk),
                                  inserted, hits, chunk)
                self.moved += len(chunk)
                self._cp()
        self._journal("rebuild")

    def _wb_drain(self) -> None:
        """Replay the dead shard's queued writes for this category into
        the new owner, exactly-once (``_wb_applied``), with a crash
        point bracketing each item like normal wb replay."""
        p = self.parent
        q = p._write_behind[self.src_id]
        mine = [it for it in q if it.category == self.category]
        for it in mine:
            self._cp()
            if it.wb_id not in p._wb_applied:
                p._wb_applied.add(it.wb_id)
                p._wb_apply(it)
            self._cp()
            q.remove(it)
            p.fault_stats["wb_replayed"] += 1
        self._journal("wb_drain")

    def _finish(self) -> None:
        self.parent._migrations.pop(self.category, None)
        self.done = True
        self._journal("done")
        self.parent.fault_stats["outage_rebalances"] += 1

    def run(self) -> int:
        if self.done:
            return 0
        self._cp()
        self._rebuild()
        self._cp()
        # Flip routing to the rebuilt copy — point of no return. The
        # admission sketch needs no transfer: trackers are seeded from
        # the category NAME, so the target derives identical state.
        self.parent.planner.assign(self.category, self.dst_id)
        self._journal("flip")
        self._cp()
        self._wb_drain()
        self._cp()
        self._finish()
        # The ledger entry lets the source's recovery demote its stale
        # copies and re-absorb the category to its planned home.
        self.parent._moved_by_outage[self.category] = (self.src_id,
                                                       self.dst_id)
        return self.moved

    def abort(self) -> None:
        """Pre-flip cancel: drop the partial target copies; the (dead)
        source keeps nominal authority and its store keeps the data."""
        if self.done:
            return
        if self.flipped:
            raise RuntimeError(
                "cannot abort after the routing flip — the target owns "
                f"{self.category!r}; recover()/resume instead")
        dst = self.parent.shards[self.dst_id]
        for s in dst.category_slots(self.category):
            dst._evict_slot(int(s), reason="outage_rebalance_abort")
        self.parent._migrations.pop(self.category, None)
        self.done = True
        self._journal("abort")

    def recover(self, mode: str = "auto") -> str:
        """Post-flip: finish forward (idempotent wb drain + done).
        Pre-flip: ``"resume"`` (the ``"auto"`` default — the store still
        holds the data and the rebuild sweep is idempotent, so finishing
        is both safe and cheap) re-runs; ``"abort"`` rolls back to the
        dead shard."""
        if self.done:
            return "noop"
        if self.flipped:
            self._wb_drain()
            self._finish()
            self.parent._moved_by_outage[self.category] = (self.src_id,
                                                           self.dst_id)
            return "resumed"
        if mode == "abort":
            self.abort()
            return "aborted"
        self.run()
        return "resumed"


class ShardedSemanticCache:
    """N category-sharded ``SemanticCache``s behind the single-cache API.

    ``capacity`` is the GLOBAL entry capacity: quota ceilings resolve
    against it on every shard (``quota_capacity``), so a category's
    entry budget is identical to the unsharded cache's. Each shard
    preallocates ``shard_capacity`` physical slots (default: the global
    capacity, the always-safe choice; size it from
    ``planner.shard_bytes`` when per-device memory is the constraint —
    with quotas summing ≤ 1 a shard never holds more than its
    categories' ceilings). Returned slot ids are globally encoded as
    ``shard · shard_capacity + local`` — decode with ``doc_id_of`` /
    ``shard_of_slot`` rather than indexing shard tables directly.

    ``use_device`` and ``device`` are the port's ``SemanticCache``'s and
    pass to every shard: the device search by default, with the tables
    on the card unless ``device="cpu"``.
    """

    def __init__(self, policies: PolicyEngine, dim: int = 384,
                 capacity: int = 65536, n_shards: int = 2,
                 clock: Clock | None = None, index_kind: str = "hnsw",
                 use_device: bool = True, search_ms: float = 2.0,
                 insert_ms: float = 1.0, l1_capacity: int = 0,
                 seed: int = 0, emb_dtype: str = "float32",
                 planner=None, shard_capacity: int | None = None,
                 store_factory=None, eviction: str = "static",
                 faults: FaultInjector | None = None,
                 write_behind_capacity: int = 1024,
                 replication: dict[str, int] | float | None = None,
                 rebalance_after_s: float | None = None,
                 obs=None, device: str | torch.device | None = None):
        self.policies = policies
        # Observability (repro.obs.TraceRecorder or None): the front
        # door records with shard=-1, each shard with its own id; all
        # shards share this recorder so shard spans nest inside the
        # front door's root span.
        self.obs = obs
        self._obs_shard = -1
        # Fault wiring: an absent (or inert — empty schedule) injector
        # makes every degraded-mode hook a no-op, keeping this cache
        # bit-identical to the pre-fault-injection behavior.
        self.faults = faults
        self.write_behind_capacity = write_behind_capacity
        self.replication = replication
        self.rebalance_after_s = rebalance_after_s
        self.dim = dim
        self.capacity = capacity
        self.n_shards = max(1, n_shards)
        self.index_kind = index_kind
        self.use_device = use_device
        self.emb_dtype = emb_dtype
        self.clock = clock or SimClock()
        self.search_ms = search_ms
        self.insert_ms = insert_ms
        self.eviction = eviction
        self.planner = planner if planner is not None else \
            ShardPlanner.from_policies(policies, self.n_shards, capacity,
                                       dim=dim, emb_dtype=emb_dtype,
                                       replication=replication)
        self.shard_capacity = shard_capacity or capacity
        self.shards = [
            SemanticCache(policies, dim=dim, capacity=self.shard_capacity,
                          store=(store_factory(i) if store_factory else None),
                          clock=self.clock, index_kind=index_kind,
                          use_device=use_device,
                          # the front door owns the clock charges — one
                          # advance per fan-out round, not one per shard
                          search_ms=0.0, insert_ms=0.0,
                          l1_capacity=l1_capacity, seed=seed + i,
                          emb_dtype=emb_dtype, quota_capacity=capacity,
                          doc_id_start=i, doc_id_step=self.n_shards,
                          # Admission state is seeded per category NAME
                          # (not this seed+i), so every shard reaches the
                          # single cache's admission decisions.
                          eviction=eviction,
                          # With a fault stack wired, persist fp32
                          # embeddings per doc so OutageRebalance can
                          # rebuild a dead shard's resident set from the
                          # store alone.
                          durable_embeddings=(faults is not None),
                          obs=obs, obs_shard=i, device=device)
            for i in range(self.n_shards)]
        # One shared cache-relative time origin: inserted timestamps are
        # directly transferable between shards (migration preserves them).
        self._t0 = self.shards[0]._t0
        for s in self.shards:
            s._t0 = self._t0
        self.metrics = ShardedMetrics(self)
        self.last_lookup_stats: dict = {}
        self.last_insert_stats: dict = {}
        self._migrations: dict[str, CategoryMigration] = {}
        # Bounded per-shard write-behind queues (writes acknowledged
        # while a shard is down; FIFO-replayed on recovery) plus the
        # degraded-serving counters bench_faults gates on.
        self._write_behind: list[deque] = [deque()
                                           for _ in range(self.n_shards)]
        self._replaying = False
        self.fault_stats = {"degraded_misses": 0, "wb_enqueued": 0,
                            "wb_replayed": 0, "wb_dropped": 0,
                            "fenced_writes": 0, "fence_replayed": 0,
                            "fence_dropped": 0, "failover_reads": 0,
                            "replica_divergence": 0, "outage_rebalances": 0,
                            "reabsorbed_categories": 0}
        # -- replication state ------------------------------------------
        # Deterministic round-robin read cursor per replicated category.
        self._rr: dict[str, int] = {}
        # Doc-correspondence registry: uid -> {shard: (local_slot,
        # doc_id)} plus the back-map (shard, doc_id) -> uid. Hit echo
        # walks it to mirror slot_hits onto live siblings (keeping
        # eviction scores in step); a hit whose sibling copy vanished
        # while the sibling is LIVE is counted replica_divergence.
        self._rep_registry: dict[int, dict[int, tuple[int, int]]] = {}
        self._rep_uid_of: dict[tuple[int, int], int] = {}
        self._next_uid = 0
        # Exactly-once wb replay: ids already applied (survives a crash
        # between apply and dequeue — in-process state is NOT rolled
        # back on an injected crash, mirroring a durable applied-log).
        self._wb_applied: set[int] = set()
        self._next_wb_id = 0
        # Degraded-window accrual (_degraded_since: category -> clock
        # time its last live replica went dark) and outage bookkeeping
        # (_down_since: shard -> clock time first observed down;
        # _moved_by_outage: category -> (src, dst) moved off a dead
        # shard, pending demote + re-absorb on its recovery).
        self._degraded_since: dict[str, float] = {}
        self._down_since: dict[int, float] = {}
        self._moved_by_outage: dict[str, tuple[int, int]] = {}
        self._in_fault_hooks = False
        # Last lookup's read routing: request index -> serving shard
        # (INVALID when degraded) — the determinism property tests
        # compare this byte-for-byte across runs.
        self.last_read_shards: list[int] = []

    # ------------------------------------------------------------------ tracing
    def _span(self, stage: str, **attrs):
        """Front-door span (shard=-1) when a recorder is attached; the
        shared no-op otherwise (empty-recorder parity)."""
        if self.obs is None:
            return NULL_SPAN
        return self.obs.span(stage, shard=self._obs_shard, **attrs)

    def _event(self, name: str, **fields) -> None:
        if self.obs is not None:
            self.obs.event(name, **fields)

    # ------------------------------------------------------------------ routing
    def shard_of(self, category: str) -> int:
        """The category's SERVING shard: its planned home, or — while a
        migration is in flight — whichever end the migration's journal
        says is authoritative (source until the cutover's flip, target
        after; a crashed cutover parks here until ``recover()``)."""
        mig = self._migrations.get(category)
        return mig.owner_id if mig is not None else \
            self.planner.shard_of(category)

    def replica_set(self, category: str) -> list[int]:
        """Every shard serving the category, primary first. A mid-flight
        migration pins the set to the single authoritative end (moving
        categories are never replicated — replicated ones are pinned)."""
        mig = self._migrations.get(category)
        if mig is not None:
            return [mig.owner_id]
        rs = getattr(self.planner, "replica_set", None)
        return rs(category) if rs is not None else \
            [self.planner.shard_of(category)]

    # -------------------------------------------------------------- degradation
    def _shard_down(self, shard: int) -> bool:
        return self.faults is not None and self.faults.shard_down(shard)

    @property
    def wb_pending(self) -> int:
        """Writes acknowledged during outages, not yet replayed."""
        return sum(len(q) for q in self._write_behind)

    def _fault_hooks(self) -> None:
        """Fault-layer bookkeeping at the top of every public lookup /
        insert: accrue per-category degraded_seconds, run outage
        detection (rebalance triggers + demote/re-absorb on recovery),
        then drain recovered write-behind queues. Everything is a no-op
        without an ACTIVE injector, keeping the no-fault path
        bit-identical to the pre-fault-injection code."""
        if self.faults is not None and self.faults.active \
                and not self._in_fault_hooks:
            self._in_fault_hooks = True
            try:
                self._accrue_degraded()
                self._check_outages()
            finally:
                self._in_fault_hooks = False
        self._maybe_replay()

    def _accrue_degraded(self) -> None:
        """Incrementally charge degraded wall-time to every category
        with NO live replica — the observed window ``slo_report`` and
        the availability curves read, accrued between ops so nothing
        downstream re-derives schedule overlap."""
        now = self.clock.now()
        for name in self.policies.categories():
            down = all(self._shard_down(s) for s in self.replica_set(name))
            since = self._degraded_since.get(name)
            if down:
                if since is None:
                    self._degraded_since[name] = now
                elif now > since:
                    self.metrics.cat(name).degraded_seconds += now - since
                    self._degraded_since[name] = now
                    self._event("degraded_accrue", category=name,
                                seconds=now - since)
            elif since is not None:
                del self._degraded_since[name]
                if now > since:
                    self.metrics.cat(name).degraded_seconds += now - since
                    self._event("degraded_accrue", category=name,
                                seconds=now - since)

    def _check_outages(self) -> None:
        """Outage lifecycle: track when each shard was first observed
        down; once an outage persists past ``rebalance_after_s``,
        evacuate its unreplicated categories (``OutageRebalance``); once
        a previously-evacuated shard recovers, demote its stale copies
        and re-absorb each moved category to its original home through a
        normal live migration."""
        now = self.clock.now()
        for si in range(self.n_shards):
            if self._shard_down(si):
                if si not in self._down_since:
                    self._down_since[si] = now
                    self._event("shard_down_observed", shard=si)
            elif self._down_since.pop(si, None) is not None:
                self._event("shard_up_observed", shard=si)
        if self.rebalance_after_s is not None:
            for si, since in sorted(self._down_since.items()):
                if now - since >= self.rebalance_after_s:
                    self._outage_rebalance(si)
        # Demote + re-absorb: scanned on EVERY call (not just the
        # down→up transition op) so a crash recovered out-of-band still
        # converges the next time any traffic arrives.
        for cat in sorted(self._moved_by_outage):
            src, dst = self._moved_by_outage[cat]
            if cat in self._migrations or self._shard_down(src):
                continue
            stale = self.shards[src]
            for s in stale.category_slots(cat):
                # Demote: the recovered shard's copies predate the
                # outage moves — the evacuated owner is authoritative.
                stale._evict_slot(int(s), reason="outage_stale")
            del self._moved_by_outage[cat]
            if self.shard_of(cat) != src:
                self.migrate_category(cat, src)
            self.fault_stats["reabsorbed_categories"] += 1

    def _outage_rebalance(self, si: int) -> None:
        """Evacuate every unreplicated cacheable category homed on the
        (dead) shard ``si`` to the lightest live shard. Runs to
        completion per category; an injected crash mid-protocol parks
        the ``OutageRebalance`` in ``_migrations`` for ``recover``."""
        stranded = sorted(
            c for c in self.policies.categories()
            if self.policies.get(c).allow_caching
            and self.policies.get(c).quota > 0
            and c not in self._migrations
            and self.replica_set(c) == [si])
        if not stranded:
            return
        live = [s for s in range(self.n_shards) if not self._shard_down(s)]
        if not live:
            return
        weights = getattr(self.planner, "shard_bytes", None)
        for cat in stranded:
            dst = min(live, key=(lambda s: (weights[s], s)) if weights
                      else (lambda s: s))
            reb = OutageRebalance(self, cat, si, dst)
            self._migrations[cat] = reb
            with self._span("outage_rebalance", category=cat,
                            src=si, dst=dst):
                reb.run()

    def _maybe_replay(self) -> None:
        """FIFO-replay each recovered shard's write-behind queue, item
        by item, through the write path (front-door for single-home
        items — categories may have migrated while queued, and a
        still-down target just re-enqueues; direct catch-up for
        replica-mode items whose siblings already applied the write).
        ``crash_point("wb_replay")`` brackets every item and the
        ``_wb_applied`` id set deduplicates a crash between apply and
        dequeue: each acknowledged write is applied exactly once. Runs
        at the top of every public lookup/insert, so recovery drains on
        the first post-outage operation — no background thread."""
        if self.faults is None or self._replaying:
            return
        todo = [si for si in range(self.n_shards)
                if self._write_behind[si] and not self._shard_down(si)]
        if not todo:
            return
        self._replaying = True
        try:
            for si in todo:
                q = self._write_behind[si]
                while q:
                    it = q[0]
                    self.faults.crash_point("wb_replay")
                    if it.wb_id not in self._wb_applied:
                        self._wb_applied.add(it.wb_id)
                        self._wb_apply(it, shard=si)
                    self.faults.crash_point("wb_replay")
                    q.popleft()
                    self.fault_stats["wb_replayed"] += 1
                    self._event("wb_replay", shard=si, wb_id=it.wb_id,
                                category=it.category, mode=it.mode)
        finally:
            self._replaying = False

    def _wb_apply(self, item: _WbItem, shard: int | None = None) -> None:
        """Apply one write-behind item. Front-mode re-enters the front
        door (normal routing / admission / fences; a still-down owner
        re-enqueues under a fresh id, which carries the acknowledgment
        forward). Replica-mode catches the recovered replica up
        DIRECTLY: its live siblings applied the write during the outage,
        so fanning out again would double-apply — and the fresh copy is
        back-dated to the acknowledgment instant and synced to a live
        sibling's hit count so TTL ages and eviction scores converge
        bit-identically across the replica set."""
        if item.mode == "replica" and shard is not None:
            sh = self.shards[shard]
            local = int(sh.insert_batch(
                item.emb[None, :], [item.category], [item.request],
                [item.response], [item.meta])[0])
            if local == INVALID:
                # Name-seeded admission replays the identical decision
                # stream, so a skip here matches the siblings' skip.
                return
            # The row is already dirty from the insert's add_batch, so
            # the back-dated timestamp rides the same delta flush.
            sh.slot_inserted[local] = np.float32(item.t_enq - self._t0)  # mirror-ok
            for sj, (oslot, odoc) in sorted(
                    self._rep_registry.get(item.uid, {}).items()):
                if sj == shard or self._shard_down(sj):
                    continue
                osh = self.shards[sj]
                if osh.slot_valid[oslot] and int(osh.slot_doc[oslot]) == odoc:
                    sh.slot_hits[local] = int(osh.slot_hits[oslot])
                    break
            self._rep_register(item.uid, shard, local, sh.doc_id_of(local))
            return
        self.insert_batch(item.emb[None, :], [item.category],
                          [item.request], [item.response], [item.meta])

    def _wb_enqueue(self, si: int, emb: np.ndarray, category: str,
                    request: str, response: str, meta: dict | None,
                    mode: str = "front", uid: int = -1) -> bool:
        """Acknowledge a write into shard ``si``'s bounded write-behind
        queue; a full queue DROPS (counted, unacknowledged-by-
        construction — only enqueued writes carry the zero-loss replay
        guarantee)."""
        q = self._write_behind[si]
        if len(q) >= self.write_behind_capacity:
            self.fault_stats["wb_dropped"] += 1
            self._event("wb_drop", shard=si, category=category)
            return False
        self._next_wb_id += 1
        q.append(_WbItem(self._next_wb_id, mode, uid, emb.copy(), category,
                         request, response, meta, self.clock.now()))
        self.fault_stats["wb_enqueued"] += 1
        self._event("wb_enqueue", shard=si, category=category,
                    wb_id=self._next_wb_id, mode=mode)
        return True

    # ------------------------------------------------------------- replication
    def _mint_uid(self) -> int:
        """Fresh doc-correspondence uid; piggybacks a periodic registry
        prune so the maps stay bounded by the LIVE replicated set."""
        uid = self._next_uid
        self._next_uid += 1
        if uid and uid % 4096 == 0:
            self._prune_registry()
        return uid

    def _rep_register(self, uid: int, shard: int, local: int,
                      doc_id: int) -> None:
        if uid < 0 or local == INVALID or doc_id == INVALID:
            return
        self._rep_registry.setdefault(uid, {})[shard] = (int(local),
                                                         int(doc_id))
        self._rep_uid_of[(shard, int(doc_id))] = uid

    def _prune_registry(self) -> None:
        """Drop uids with no surviving copy (evicted/expired everywhere)
        plus their back-map keys."""
        dead = []
        for uid, ent in self._rep_registry.items():
            for sj, (oslot, odoc) in ent.items():
                osh = self.shards[sj]
                if osh.slot_valid[oslot] and int(osh.slot_doc[oslot]) == odoc:
                    break
            else:
                dead.append(uid)
        for uid in dead:
            for sj, (_, odoc) in self._rep_registry.pop(uid).items():
                self._rep_uid_of.pop((sj, odoc), None)

    def _echo_hit(self, si: int, local_slot: int) -> None:
        """Mirror the serving replica's hit count onto live siblings so
        eviction scores stay in lockstep across the replica set. A live
        sibling whose copy is GONE while the serving copy took a hit is
        observed drift: counted ``replica_divergence`` and pruned."""
        sh = self.shards[si]
        doc_id = int(sh.slot_doc[local_slot])
        uid = self._rep_uid_of.get((si, doc_id))
        if uid is None:
            return
        ent = self._rep_registry.get(uid, {})
        h = int(sh.slot_hits[local_slot])
        for sj in sorted(ent):
            if sj == si:
                continue
            oslot, odoc = ent[sj]
            osh = self.shards[sj]
            if osh.slot_valid[oslot] and int(osh.slot_doc[oslot]) == odoc:
                osh.slot_hits[oslot] = h
            elif not self._shard_down(sj):
                self.fault_stats["replica_divergence"] += 1
                self._event("replica_divergence", shard=sj, uid=uid)
                del ent[sj]
                self._rep_uid_of.pop((sj, odoc), None)

    def replica_doc_ids(self, slot: int) -> list[int]:
        """Every replica's doc id behind a (global) slot, serving copy
        first — the simulator records ground truth under ALL of them so
        a failover read is judged against the same truth as a primary
        read."""
        shard, local = self.shard_of_slot(slot)
        if shard == INVALID:
            return []
        d = self.shards[shard].doc_id_of(local)
        if d == INVALID:
            return []
        out = [d]
        uid = self._rep_uid_of.get((shard, d))
        if uid is not None:
            for sj in sorted(self._rep_registry.get(uid, {})):
                if sj == shard:
                    continue
                odoc = self._rep_registry[uid][sj][1]
                if odoc not in out:
                    out.append(odoc)
        return out

    def recover_migrations(self, mode: str = "auto") -> dict[str, str]:
        """Run ``recover`` on every in-flight (crashed) migration or
        outage rebalance; returns {category: action taken}."""
        out = {}
        for cat in sorted(self._migrations):
            mig = self._migrations.get(cat)
            if mig is not None:
                out[cat] = mig.recover(mode)
        return out

    def shard_of_slot(self, slot: int) -> tuple[int, int]:
        """Decode a globally-encoded slot id to (shard, local slot);
        INVALID decodes to (INVALID, INVALID), never to a real shard."""
        if slot < 0:
            return INVALID, INVALID
        return divmod(slot, self.shard_capacity)

    def _global_slot(self, shard: int, local: int) -> int:
        return shard * self.shard_capacity + local if local != INVALID \
            else INVALID

    def doc_id_of(self, slot: int) -> int:
        shard, local = self.shard_of_slot(slot)
        return self.shards[shard].doc_id_of(local) if shard != INVALID \
            else INVALID

    # ------------------------------------------------------------------ reads
    def lookup(self, embedding: np.ndarray, category: str) -> CacheResult:
        return self.lookup_batch(embedding[None, :], [category])[0]

    def lookup_batch(self, embeddings: np.ndarray,
                     categories: Sequence[str]) -> list[CacheResult]:
        """Fan-out masked search: partition the batch per serving shard,
        run each shard's (device-resident) search, merge back into
        request order. One ``search_ms`` clock charge for the whole
        round — the shards search in parallel on real hardware — and the
        TTL ``now`` every shard classifies against is the same instant a
        single cache would use. Replicated categories route
        deterministically round-robin across the replica set, failing
        over to the next live replica inside an outage window (counted
        ``failover_reads``); a lookup is degraded only when NO replica
        is live."""
        embeddings = np.atleast_2d(np.asarray(embeddings, np.float32))
        # Fault hooks run BEFORE the root span opens: write-behind
        # replay and outage rebalancing re-enter the write path and
        # record their own root spans, not children of this lookup.
        self._fault_hooks()
        with self._span("lookup", batch=int(embeddings.shape[0])):
            return self._lookup_batch_impl(embeddings, categories)

    def _lookup_batch_impl(self, embeddings: np.ndarray,
                           categories: Sequence[str]) -> list[CacheResult]:
        B = embeddings.shape[0]
        assert len(categories) == B
        results: list[CacheResult] = [None] * B  # type: ignore[list-item]
        read_shards = [INVALID] * B
        per_shard: dict[int, list[int]] = {}
        degraded: dict[int, list[int]] = {}
        replicated: set[int] = set()
        # Span "route": shard routing + replica pick/failover for the
        # whole batch (no clock charge — routing is control-plane).
        with self._span("route", batch=B) as rsp:
            failovers = 0
            for i, c in enumerate(categories):
                reps = self.replica_set(c)
                if len(reps) == 1:
                    s0 = reps[0]
                    if self._shard_down(s0):
                        degraded.setdefault(s0, []).append(i)
                    else:
                        per_shard.setdefault(s0, []).append(i)
                        read_shards[i] = s0
                    continue
                # Deterministic round-robin read routing: the per-category
                # cursor advances on EVERY lookup (served or not), so the
                # assignment stream is a pure function of the request
                # stream + schedule — the determinism property tests
                # compare it byte-for-byte across runs.
                rr = self._rr.get(c, 0)
                self._rr[c] = rr + 1
                k = rr % len(reps)
                order = reps[k:] + reps[:k]
                si = next((s for s in order if not self._shard_down(s)), None)
                if si is None:
                    degraded.setdefault(reps[0], []).append(i)
                    continue
                if si != order[0]:
                    self.fault_stats["failover_reads"] += 1
                    failovers += 1
                    self._event("failover_read", category=c,
                                primary=order[0], served_by=si)
                replicated.add(i)
                read_shards[i] = si
                per_shard.setdefault(si, []).append(i)
            rsp.set(failovers=failovers,
                    degraded=sum(len(v) for v in degraded.values()))
        agg = {"batch": 0, "hops": 0, "rows_gathered": 0,
               "gathered_bytes": 0, "reranks": 0, "degraded": 0,
               "per_shard": {}}
        any_active = False
        for si in sorted(set(per_shard) | set(degraded)):
            # Degraded mode: no live replica holds the category, so
            # every cacheable lookup routed here resolves as a counted
            # degraded_miss — the caller serves from the model, exactly
            # like a miss, and the hit-rate denominator never sees it
            # (metrics.CategoryStats). Compliance-blocked traffic
            # classifies as usual: that decision is policy-side and
            # needs no index.
            for i in degraded.get(si, []):
                c = categories[i]
                st = self.metrics.cat(c)
                st.lookups += 1
                if not self.policies.effective(c).allow_caching:
                    st.compliance_rejects += 1
                    st.misses += 1
                    results[i] = CacheResult(False, category=c,
                                             reason="compliance")
                    continue
                st.degraded_misses += 1
                self.fault_stats["degraded_misses"] += 1
                self._event("degraded_miss", category=c, shard=si)
                agg["degraded"] += 1
                any_active = True
                results[i] = CacheResult(False, category=c,
                                         reason="degraded",
                                         latency_ms=self.search_ms)
            idxs = per_shard.get(si)
            if not idxs:
                continue
            sub = self.shards[si].lookup_batch(
                embeddings[idxs], [categories[i] for i in idxs])
            ls = self.shards[si].last_lookup_stats
            if ls:
                agg["per_shard"][si] = dict(ls)
                for k in ("batch", "hops", "rows_gathered",
                          "gathered_bytes", "reranks"):
                    agg[k] += ls.get(k, 0)
            for i, r in zip(idxs, sub):
                if r.reason != "compliance":
                    any_active = True
                    r.latency_ms = self.search_ms
                if r.slot != INVALID:
                    if r.hit and i in replicated:
                        # Echo the serving replica's hit count to live
                        # siblings BEFORE globalizing the slot id.
                        self._echo_hit(si, r.slot)
                    r.slot = self._global_slot(si, r.slot)
                results[i] = r
        self.last_read_shards = read_shards
        # Mirrors the single cache: a batch that is 100 % compliance-
        # rejected never reaches the index and costs no search time.
        if any_active:
            # The front door owns the ONE fan-out search charge (shards
            # run with search_ms=0); span "search" at shard=-1 carries it.
            with self._span("search", batch=B):
                self.clock.advance(self.search_ms / 1e3)
        self.last_lookup_stats = agg if any_active else {}
        return results

    # ------------------------------------------------------------------ writes
    def insert(self, embedding: np.ndarray, category: str, request: str,
               response: str, meta: dict | None = None) -> int:
        return self.insert_batch(np.asarray(embedding)[None, :], [category],
                                 [request], [response], [meta])[0]

    def insert_batch(self, embeddings: np.ndarray,
                     categories: Sequence[str], requests: Sequence[str],
                     responses: Sequence[str],
                     metas: Sequence[dict | None] | None = None) -> list[int]:
        """Partition the write batch per serving shard; each sub-batch
        pays the shard's single eviction-scoring/store/index pass and
        its touched rows land in that shard's dirty log (one delta flush
        per shard on its next search). Slot ids come back globally
        encoded; INVALID for rejected items, as in the single cache."""
        embeddings = np.atleast_2d(np.asarray(embeddings, np.float32))
        B = embeddings.shape[0]
        metas = list(metas) if metas is not None else [None] * B
        if not (len(categories) == len(requests) == len(responses)
                == len(metas) == B):
            raise ValueError("insert_batch: ragged batch")
        # Fault hooks run BEFORE the root span opens (see lookup_batch).
        self._fault_hooks()
        with self._span("insert", batch=B):
            return self._insert_batch_impl(embeddings, categories,
                                           requests, responses, metas)

    def _insert_batch_impl(self, embeddings, categories, requests,
                           responses, metas) -> list[int]:
        B = embeddings.shape[0]
        slots_out = [INVALID] * B
        agg = {"batch": B, "admitted": 0, "admission_skips": 0,
               "insert_rejects": 0, "per_shard": {}}
        per_shard: dict[int, list[int]] = {}
        rep_batches: dict[int, list[tuple[int, int]]] = {}  # si -> [(i, uid)]
        rep_primary: dict[int, int] = {}                    # i  -> primary
        # Span "route": the one write-round charge plus fence/replica/
        # write-behind partitioning of the batch.
        with self._span("route", batch=B):
            # One write-round clock charge iff anything is admissible —
            # matching the single cache, whose advance sits behind the
            # compliance gate.
            eff = {c: self.policies.effective(c)
                   for c in dict.fromkeys(categories)}
            if any(eff[c].allow_caching and eff[c].quota > 0.0
                   for c in categories):
                self.clock.advance(self.insert_ms / 1e3)
            for i, c in enumerate(categories):
                mig = self._migrations.get(c)
                if mig is not None and mig.fenced:
                    # Cutover write fence: the write queues on the migration
                    # (acknowledged — INVALID slot, like any deferred write)
                    # and replays to whichever shard owns the category once
                    # the fence drops. Non-cacheable traffic short-circuits
                    # as usual; the fence only defers writes that would land.
                    e = eff[c]
                    if not e.allow_caching or e.quota <= 0.0:
                        self.metrics.cat(c).insert_rejects += 1
                        agg["insert_rejects"] += 1
                        continue
                    if len(mig.fence_queue) >= self.write_behind_capacity:
                        self.fault_stats["fence_dropped"] += 1
                        self._event("fence_drop", category=c)
                        continue
                    mig.fence_queue.append((embeddings[i].copy(),
                                            requests[i], responses[i],
                                            metas[i]))
                    self.fault_stats["fenced_writes"] += 1
                    self._event("fenced_write", category=c)
                    continue
                reps = self.replica_set(c)
                if len(reps) == 1:
                    per_shard.setdefault(reps[0], []).append(i)
                    continue
                # Replicated write fan-out: compliance is decided ONCE at
                # the front door (the per-shard path would count the reject
                # on every replica), then every LIVE replica gets the write
                # in this same batched round; down replicas get a replica-
                # mode write-behind item that catches them up directly on
                # recovery (their siblings already applied the write).
                e = eff[c]
                if not e.allow_caching or e.quota <= 0.0:
                    self.metrics.cat(c).insert_rejects += 1
                    agg["insert_rejects"] += 1
                    continue
                uid = self._mint_uid()
                rep_primary[i] = reps[0]
                for sj in reps:
                    if self._shard_down(sj):
                        self._wb_enqueue(sj, embeddings[i], c, requests[i],
                                         responses[i], metas[i],
                                         mode="replica", uid=uid)
                    else:
                        rep_batches.setdefault(sj, []).append((i, uid))
        for si in sorted(per_shard):
            idxs = per_shard[si]
            if self._shard_down(si):
                # Shard outage: acknowledge the write into the bounded
                # write-behind queue (replayed FIFO on recovery by
                # _maybe_replay). A full queue DROPS — the drop is
                # counted and unacknowledged-by-construction: only
                # enqueued writes carry the zero-loss replay guarantee.
                for i in idxs:
                    c = categories[i]
                    e = eff[c]
                    if not e.allow_caching or e.quota <= 0.0:
                        self.metrics.cat(c).insert_rejects += 1
                        agg["insert_rejects"] += 1
                        continue
                    self._wb_enqueue(si, embeddings[i], c, requests[i],
                                     responses[i], metas[i])
                continue
            sub = self.shards[si].insert_batch(
                embeddings[idxs], [categories[i] for i in idxs],
                [requests[i] for i in idxs], [responses[i] for i in idxs],
                [metas[i] for i in idxs])
            self._merge_insert_stats(agg, si,
                                     self.shards[si].last_insert_stats)
            for i, local in zip(idxs, sub):
                slots_out[i] = self._global_slot(si, int(local))
        # Replicated fan-out: one sub-batch per live replica in the same
        # write round (each replica's dirty-log delta sync stays
        # O(batch)); the PRIMARY's slot is the caller-visible one.
        for sj in sorted(rep_batches):
            pairs = rep_batches[sj]
            idxs = [i for i, _ in pairs]
            sub = self.shards[sj].insert_batch(
                embeddings[idxs], [categories[i] for i in idxs],
                [requests[i] for i in idxs], [responses[i] for i in idxs],
                [metas[i] for i in idxs])
            self._merge_insert_stats(agg, sj,
                                     self.shards[sj].last_insert_stats)
            for (i, uid), local in zip(pairs, sub):
                local = int(local)
                if local == INVALID:
                    continue
                self._rep_register(uid, sj, local,
                                   self.shards[sj].doc_id_of(local))
                if rep_primary.get(i) == sj:
                    slots_out[i] = self._global_slot(sj, local)
        self.last_insert_stats = agg
        return slots_out

    @staticmethod
    def _merge_insert_stats(agg: dict, si: int, ins: dict) -> None:
        """Fold one shard sub-batch's insert stats into the round's
        aggregate; a shard can serve BOTH a single-home and a replicated
        sub-batch in one round, so per-shard entries sum-merge."""
        if not ins:
            return
        prev = agg["per_shard"].get(si)
        if prev is None:
            agg["per_shard"][si] = dict(ins)
        else:
            for k, v in ins.items():
                if isinstance(v, (int, float)):
                    prev[k] = prev.get(k, 0) + v
        for k in ("admitted", "admission_skips", "insert_rejects"):
            agg[k] += ins.get(k, 0)

    def sweep_expired(self) -> int:
        return sum(s.sweep_expired() for s in self.shards)

    # ---------------------------------------------------------------- migration
    def migrate_category(self, category: str, target: int,
                         batch_size: int = 64,
                         stepwise: bool = False) -> CategoryMigration | None:
        """Move a category to ``target``. Default: drain + cutover in
        one call. ``stepwise=True`` returns the live ``CategoryMigration``
        so the caller interleaves ``step()`` with serving traffic and
        invokes ``cutover()`` itself (reads stay on the source, and
        correct, throughout). The target must have physical headroom for
        the category: a drain step that finds the target full aborts the
        whole migration atomically (target copies dropped, source still
        authoritative, retryable) and re-raises."""
        src = self.shard_of(category)
        if target == src or not (0 <= target < self.n_shards):
            return None
        if category in self._migrations:
            raise RuntimeError(f"migration of {category!r} already active")
        if len(self.replica_set(category)) > 1:
            raise RuntimeError(
                f"{category!r} is replicated — replicated categories are "
                "pinned (their outage story is the replica set, not "
                "migration)")
        mig = CategoryMigration(self, category, src, target, batch_size)
        self._migrations[category] = mig
        if not stepwise:
            with self._span("migration", category=category,
                            src=src, dst=target):
                mig.run()
        return mig

    def rebalance(self, quotas: dict[str, float] | None = None) -> dict:
        """Re-plan placement (quota reassignment, an AdaptiveController
        retune, …) and live-migrate every category whose planned shard
        moved. Returns {category: (src, dst)} for the moves made.
        Requires a quota-byte ``ShardPlanner`` — the crc32 fallback has
        no byte bookkeeping to re-plan against."""
        if not isinstance(self.planner, ShardPlanner):
            raise TypeError(
                "rebalance() needs a ShardPlanner; this cache routes via "
                f"{type(self.planner).__name__} (the quota-blind "
                "fallback) — migrate_category() still works")
        if quotas is None:
            quotas = {n: self.policies.get(n).quota
                      for n in self.policies.categories()
                      if self.policies.get(n).allow_caching
                      and self.policies.get(n).quota > 0}
        scratch = ShardPlanner(self.n_shards, self.capacity,
                               residency=self.planner.residency,
                               policies=self.policies,
                               replication=self.planner.replication)
        target = scratch.plan(quotas)
        moves: dict[str, tuple[int, int]] = {}
        for cat, dst in target.items():
            if len(self.planner.replica_set(cat)) > 1:
                # Pinned: replicated categories keep their replica set
                # across re-plans — failover, not migration, covers them.
                continue
            src = self.planner.shard_of(cat)
            if src != dst:
                self.migrate_category(cat, dst)
                moves[cat] = (src, dst)
            # refresh the byte bookkeeping at the NEW quota weight (the
            # cutover's assign reuses the stored pre-change weight)
            self.planner.assign(cat, self.planner.shard_of(cat),
                                nbytes=self.planner.quota_bytes(quotas[cat]))
        return moves

    # ---------------------------------------------------------------- reporting
    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def category_count(self, name: str) -> int:
        return sum(s.category_count(name) for s in self.shards)

    @property
    def sync_stats(self) -> dict:
        """Delta-sync accounting summed across shards, with the
        per-shard breakdown under ``per_shard`` (what ``launch/serve``'s
        topology report prints)."""
        agg: dict = {"full_uploads": 0, "delta_updates": 0,
                     "rows_synced": 0, "bytes_synced": 0,
                     "emb_bytes_synced": 0}
        per = []
        for s in self.shards:
            st = dict(s.index.sync_stats)
            per.append(st)
            for k in agg:
                agg[k] += st.get(k, 0)
        agg["per_shard"] = per
        return agg

    def shard_report(self) -> list[dict]:
        """Per-shard residency: entries, resident bytes (entries × the
        resident tier's bytes/entry), categories served, sync counters —
        the spread the placement benchmark gates on."""
        out = []
        for si, s in enumerate(self.shards):
            rep = s.memory_report()
            cats = sorted(c for c, sid in self.planner.assignments.items()
                          if sid == si) if hasattr(self.planner,
                                                   "assignments") else []
            out.append({
                "shard": si,
                "entries": rep["entries"],
                "resident_bytes": rep["entries"]
                * rep["in_memory_bytes_per_entry"],
                "categories": cats,
                "replicated": sorted(
                    c for c, rs in getattr(self.planner, "replica_sets",
                                           {}).items() if si in rs),
                "sync_stats": dict(s.index.sync_stats),
                "search_stats": dict(s.index.search_stats),
            })
        return out
