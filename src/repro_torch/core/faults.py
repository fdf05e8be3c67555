"""Deterministic fault injection for the sharded serving stack.

The paper's hybrid architecture keeps low-hit-rate categories viable
because the miss path is cheap and the cache is *always available* — so
the repro's availability story has to be engineered, not assumed
("Rethinking Caching for LLM Serving Systems", PAPERS.md: serving caches
are systems components with explicit cost AND availability behavior).
This module is the control knob: a schedule-driven ``FaultInjector``
that the sharded cache, the store wrappers and the migration protocol
consult at well-defined points, so every failure mode the degraded-mode
tests exercise is reproducible bit-for-bit:

``FaultSchedule``
    A plain declarative schedule — no randomness at fire time:

    * ``shard_outages`` — ``(start_s, end_s, shard_id)`` windows in
      simulated-clock seconds: the shard's index is unreachable inside
      ``[start, end)``. Lookups degrade to counted ``degraded_miss``es,
      writes land in the front door's bounded write-behind queue
      (core/shard.py).
    * ``store_get_failures`` / ``store_put_failures`` — 0-based
      operation indices (per op kind, counted on the injector across
      every wrapped store) that raise ``TransientStoreError``. Bounded
      runs of consecutive indices model a flaky store that retries
      absorb; runs longer than the retry budget exhaust it and surface
      as ``store_timeout`` (storage.RetryingStore).
    * ``crash_at`` — ``{site: visit_index}``: the visit_index-th visit
      to a named crash site raises ``InjectedCrash``. Sites are placed
      between migration protocol steps (core/shard.py
      ``CategoryMigration``), so "crash at every step index" is an
      enumerable sweep: dry-run, read ``visits(site)``, rerun once per
      index. A crash point fires AT MOST once per injector (it disarms
      itself), so recovery can re-traverse the same sites.

``FaultInjector``
    The runtime: counts operations/visits, applies the schedule. With
    an EMPTY schedule every hook is a no-op returning the non-fault
    answer — callers wired against an inert injector are bit-identical
    to callers with no injector at all (the ``bench_faults`` baseline
    gate).

The store-op error type (``TransientStoreError``) and the retry-budget
exhaustion type (``StoreTimeout``) live here so ``core/storage`` and
``core/cache`` share them without a dependency cycle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

from repro_torch.core.clock import Clock, SimClock


class InjectedCrash(Exception):
    """Raised at a scheduled crash point (models a process dying between
    two protocol steps — in-process state is NOT rolled back, exactly
    like a real crash leaves partial effects behind). Deliberately NOT a
    ``RuntimeError``: retry loops and the migration's target-full
    handler catch RuntimeError, and an injected crash must never be
    absorbed by either."""

    def __init__(self, site: str, visit: int):
        super().__init__(f"injected crash at {site!r} (visit {visit})")
        self.site = site
        self.visit = visit


class TransientStoreError(RuntimeError):
    """A single failed store operation (network blip, lease lost). The
    ``RetryingStore`` wrapper absorbs bounded runs of these."""


class StoreTimeout(RuntimeError):
    """Retry/latency budget exhausted on a store operation. The cache
    lookup path degrades a would-be hit into a served-from-model miss
    (counted ``store_timeouts``) instead of letting this escape."""

    def __init__(self, op: str):
        super().__init__(f"store {op} exhausted its retry budget")
        self.op = op


@dataclass
class FaultSchedule:
    """Declarative fault plan; empty (the default) means no faults."""

    # (start_s, end_s, shard_id) — shard unreachable for clock times in
    # [start_s, end_s). Same shape as SimConfig.load_spikes windows.
    shard_outages: list = field(default_factory=list)
    # 0-based per-kind operation indices that fail transiently.
    store_get_failures: frozenset = frozenset()
    store_put_failures: frozenset = frozenset()
    # site name -> visit index at which to crash (once).
    crash_at: dict = field(default_factory=dict)

    def __post_init__(self):
        self.store_get_failures = frozenset(self.store_get_failures)
        self.store_put_failures = frozenset(self.store_put_failures)

    @staticmethod
    def op_range(start: int, n: int) -> frozenset:
        """``n`` consecutive failing op indices starting at ``start``."""
        return frozenset(range(start, start + n))

    @property
    def empty(self) -> bool:
        return not (self.shard_outages or self.store_get_failures
                    or self.store_put_failures or self.crash_at)


class FaultInjector:
    """Applies a ``FaultSchedule`` deterministically.

    One injector is shared by every component of a serving stack (front
    door, per-shard store wrappers, migrations): the operation counters
    that index into the schedule are global, so a schedule names THE
    k-th store get of the run, not the k-th of one shard. Single-writer
    (the simulator/engine loop), no locking.
    """

    def __init__(self, schedule: FaultSchedule | None = None,
                 clock: Clock | None = None, obs=None):
        self.schedule = schedule or FaultSchedule()
        self.clock = clock or SimClock()
        self.active = not self.schedule.empty
        # Optional TraceRecorder (repro_torch.obs): injected faults land on
        # the event stream so a degraded window is explainable. Never
        # consulted when the schedule is inert.
        self.obs = obs
        self._store_ops = {"get": 0, "put": 0, "delete": 0}
        self._visits: dict[str, int] = {}
        self._crashed: set[str] = set()
        self.injected = {"shard_down_checks": 0, "store_faults": 0,
                         "crashes": 0}

    # -- shard outages ---------------------------------------------------------
    def shard_down(self, shard: int) -> bool:
        """Is ``shard`` inside a scheduled outage window right now?"""
        if not self.active:
            return False
        now = self.clock.now()
        for (t0, t1, s) in self.schedule.shard_outages:
            if s == shard and t0 <= now < t1:
                self.injected["shard_down_checks"] += 1
                return True
        return False

    # -- store faults ----------------------------------------------------------
    def store_op(self, op: str) -> None:
        """Count one store operation; raise ``TransientStoreError`` when
        its index is scheduled to fail. Inert schedules count nothing,
        so wrapped and unwrapped stores behave identically."""
        if not self.active:
            return
        idx = self._store_ops.get(op, 0)
        self._store_ops[op] = idx + 1
        fails: Iterable[int] = ()
        if op == "get":
            fails = self.schedule.store_get_failures
        elif op == "put":
            fails = self.schedule.store_put_failures
        if idx in fails:
            self.injected["store_faults"] += 1
            if self.obs is not None:
                self.obs.event("injected_store_fault", op=op, op_index=idx)
            raise TransientStoreError(f"injected {op} fault (op {idx})")

    # -- crash points ----------------------------------------------------------
    def crash_point(self, site: str) -> None:
        """Count one visit to ``site``; raise ``InjectedCrash`` on the
        scheduled visit (at most once per site — recovery re-traverses
        the protocol without re-crashing)."""
        if not self.active:
            return
        visit = self._visits.get(site, 0)
        self._visits[site] = visit + 1
        if site in self._crashed:
            return
        target = self.schedule.crash_at.get(site)
        if target is not None and visit == target:
            self._crashed.add(site)
            self.injected["crashes"] += 1
            if self.obs is not None:
                self.obs.event("injected_crash", site=site, visit=visit)
            raise InjectedCrash(site, visit)

    def visits(self, site: str) -> int:
        """Visit count for a crash site (a no-crash dry run measures the
        enumerable crash-index space: ``range(visits(site))``)."""
        return self._visits.get(site, 0)

    # -- reporting -------------------------------------------------------------
    def stats(self) -> dict:
        return {"active": self.active,
                "store_ops": dict(self._store_ops),
                "crash_site_visits": dict(self._visits),
                **self.injected}
