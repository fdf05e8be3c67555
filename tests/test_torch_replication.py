"""The sharded tier's fault plane: repro_torch's replication, failover,
write-behind queues, crash-safe migration and ``OutageRebalance`` against
the JAX reference's, on the CPU, with every shard's device search on.

Both packages run the same seeded dim-48 fixtures (the reference tests')
under the same ``FaultSchedule``: decisions, ``fault_stats``,
``last_read_shards``, the replica registries, the per-category metrics and
SLO view, the journals, and the outcome of ``recover()`` after a crash at
every enumerable crash index must be identical.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.core.faults as jfaults  # noqa: E402
import repro.core.shard as jshard  # noqa: E402
import repro.core.storage as jstorage  # noqa: E402
from repro.core.cache import SemanticCache as JCache  # noqa: E402
from repro.core.clock import SimClock as JClock  # noqa: E402
from repro.core.policy import CategoryConfig as JConfig  # noqa: E402
from repro.core.policy import PolicyEngine as JEngine  # noqa: E402

import repro_torch.core.faults as tfaults  # noqa: E402
import repro_torch.core.shard as tshard  # noqa: E402
import repro_torch.core.storage as tstorage  # noqa: E402
from repro_torch.core.cache import SemanticCache as TCache  # noqa: E402
from repro_torch.core.clock import SimClock as TClock  # noqa: E402
from repro_torch.core.policy import CategoryConfig as TConfig  # noqa: E402
from repro_torch.core.policy import PolicyEngine as TEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs: its many tiny CPU
    ops under pytest-xdist (a worker per core) with torch's default pool
    in every worker oversubscribe the machine many times over."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIM = 48
ATOL = 1e-5
# (shard module, faults module, storage module, cache, clock, engine,
#  config, extra kwargs)
REF = (jshard, jfaults, jstorage, JCache, JClock, JEngine, JConfig, {})
PORT = (tshard, tfaults, tstorage, TCache, TClock, TEngine, TConfig, {"device": "cpu"})


def _policies(pkg):
    Engine, Config = pkg[5], pkg[6]
    return Engine([
        Config("a", threshold=0.80, ttl=1e6, quota=0.40),
        Config("b", threshold=0.78, ttl=1e6, quota=0.40),
        Config("d", threshold=0.95, ttl=1.0, quota=0.0, allow_caching=False),
    ])


def _bank(cat, n=64):
    v = np.random.default_rng({"a": 100, "b": 101, "d": 102}[cat])
    v = v.standard_normal((n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _injector(pkg, clock=None, **schedule):
    faults = pkg[1]
    return faults.FaultInjector(faults.FaultSchedule(**schedule), clock)


def _sharded(pkg, n_shards=2, faults=None, index_kind="flat", emb_dtype="float32",
             clock=None, **kw):
    sh, Clock, extra = pkg[0], pkg[4], pkg[7]
    return sh.ShardedSemanticCache(
        _policies(pkg), dim=DIM, capacity=256, n_shards=n_shards,
        clock=clock or Clock(), index_kind=index_kind, emb_dtype=emb_dtype,
        use_device=True, seed=0, faults=faults, **extra, **kw)


def _cat_state(shard, cat):
    out = {}
    for s in shard.category_slots(cat):
        doc = shard.store.get(int(shard.slot_doc[s]))
        out[doc.response] = (float(shard.slot_inserted[s]), int(shard.slot_hits[s]))
    return out


def _state(cache):
    """What the fault plane shows: counters, registries, routing, metrics."""
    return (dict(cache.fault_stats), cache.wb_pending, list(cache.last_read_shards),
            {u: dict(e) for u, e in cache._rep_registry.items()},
            dict(cache._rep_uid_of), cache.metrics.snapshot(),
            cache.metrics.slo_report(), sorted(cache._migrations),
            dict(cache._moved_by_outage),
            [s.category_count(c) for s in cache.shards for c in ("a", "b")],
            [_cat_state(s, c) for s in cache.shards for c in ("a", "b")],
            cache.clock.now())


def _decisions(res):
    return [(r.hit, r.reason, r.response, r.slot, r.doc_id) for r in res], \
        [r.score for r in res]


def _same(ref, port):
    """Equal structures, except score lists, which agree within ATOL."""
    assert len(ref) == len(port)
    for x, y in zip(ref, port):
        if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], list) \
                and x[1] and isinstance(x[1][0], float):
            assert x[0] == y[0]
            assert np.allclose(x[1], y[1], atol=ATOL, rtol=0)
        else:
            assert x == y


# --------------------------------------------------- zero correctness drift
def _run_trace(cache, rounds=8, per_cat=12):
    bank_a, bank_b = _bank("a", 128), _bank("b", 128)
    out = []
    for r in range(rounds):
        lo = r * per_cat
        embs = np.concatenate([bank_a[lo:lo + per_cat], bank_b[lo:lo + per_cat]])
        cats = ["a"] * per_cat + ["b"] * per_cat
        res = cache.lookup_batch(embs, cats)
        out.append(_decisions(res))
        miss = [i for i, x in enumerate(res) if not x.hit]
        if miss:
            cache.insert_batch(embs[miss], [cats[i] for i in miss],
                               [f"q{r}.{i}" for i in miss], [f"r{r}.{i}" for i in miss])
        out.append(_decisions(cache.lookup_batch(embs, cats)))
        out.append(list(cache.last_read_shards))
    return out


@pytest.mark.parametrize("index_kind,emb_dtype", [
    ("flat", "float32"), ("flat", "int8"), ("hnsw", "float32"), ("hnsw", "int8"),
])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_replicated_parity(n_shards, index_kind, emb_dtype):
    """Round-robin reads over replica sets: the same decisions, routing,
    registries and counters as the reference, and no divergence."""
    outs = []
    for pkg in (REF, PORT):
        cache = _sharded(pkg, n_shards, index_kind=index_kind, emb_dtype=emb_dtype,
                         replication={"a": 2, "b": 2})
        outs.append(_run_trace(cache) + list(_state(cache)) + [cache.sync_stats])
    _same(outs[0], outs[1])
    assert outs[1][-13]["replica_divergence"] == 0


def test_replicas_converge_after_write_catchup():
    outs = []
    for pkg in (REF, PORT):
        clk = pkg[4]()
        cache = _sharded(pkg, faults=_injector(pkg, clk, shard_outages=[(1.0, 5.0, 1)]),
                         clock=clk, replication={"a": 2})
        bank = _bank("a")
        seq = [cache.insert_batch(bank[:4], ["a"] * 4, [f"q{i}" for i in range(4)],
                                  [f"r{i}" for i in range(4)])]
        clk.advance(2.0)
        seq.append(cache.insert_batch(bank[4:8], ["a"] * 4,
                                      [f"q{i}" for i in range(4, 8)],
                                      [f"r{i}" for i in range(4, 8)]))
        seq.append(_decisions(cache.lookup_batch(bank[:8], ["a"] * 8)))
        seq.append(_state(cache))
        clk.advance(10.0)
        for _ in range(5):
            seq.append(_decisions(cache.lookup_batch(bank[:8], ["a"] * 8)))
        seq.append(_state(cache))
        outs.append(seq)
        assert _cat_state(cache.shards[0], "a") == _cat_state(cache.shards[1], "a")
    _same(outs[0], outs[1])
    fs = outs[1][-1][0]
    assert fs["wb_enqueued"] == fs["wb_replayed"] == 4 and fs["replica_divergence"] == 0


@pytest.mark.parametrize("outages,failover,degraded", [
    ([(1.0, 3.0, 0), (4.0, 6.0, 1)], True, True),    # each shard down in turn
    ([(1.0, 3.0, 0)], True, False),                   # a's replica on 0 only
    ([(1.0, 3.0, 0), (1.0, 3.0, 1)], False, True),   # both down: no live replica
])
def test_failover_routing_and_degraded_window(outages, failover, degraded):
    """Mixed traffic across an outage schedule: failover reads, the
    round-robin read assignment, degraded misses, the observed degraded
    window and the write-behind replay, step by step as the reference
    ("a" is replicated on both shards, "b" lives on one)."""
    outs = []
    for pkg in (REF, PORT):
        clk = pkg[4]()
        cache = _sharded(pkg, faults=_injector(pkg, clk, shard_outages=outages),
                         clock=clk, replication={"a": 2})
        bank_a, bank_b = _bank("a"), _bank("b")
        seq = []
        for r in range(16):
            embs = np.concatenate([bank_a[r:r + 3], bank_b[r:r + 3]])
            cats = ["a"] * 3 + ["b"] * 3
            res = cache.lookup_batch(embs, cats)
            seq.append(_decisions(res))
            seq.append(list(cache.last_read_shards))
            miss = [i for i, x in enumerate(res) if not x.hit]
            if miss:
                seq.append(cache.insert_batch(embs[miss], [cats[i] for i in miss],
                                              [f"q{r}.{i}" for i in miss],
                                              [f"r{r}.{i}" for i in miss]))
            clk.advance(0.5)
        seq.append(_state(cache))
        outs.append(seq)
    _same(outs[0], outs[1])
    fs = outs[1][-1][0]
    assert (fs["failover_reads"] > 0) == failover
    assert (fs["degraded_misses"] > 0) == degraded
    assert fs["wb_replayed"] == fs["wb_enqueued"] > 0


def test_degraded_serving_and_bounded_queue():
    outs = []
    for pkg in (REF, PORT):
        clk = pkg[4]()
        cache = _sharded(pkg, faults=_injector(pkg, clk, shard_outages=[(0.0, 5.0, 0)]),
                         clock=clk, write_behind_capacity=3)
        down = [c for c in ("a", "b") if cache.shard_of(c) == 0][0]
        bank = _bank(down)
        seq = [cache.insert_batch(bank[:5], [down] * 5, [f"q{i}" for i in range(5)],
                                  [f"r{i}" for i in range(5)])]
        seq.append(_decisions(cache.lookup_batch(bank[:5], [down] * 5)))
        seq.append(cache.lookup(_bank("d")[0], "d").reason)
        seq.append(_state(cache))
        clk.advance(10.0)
        seq.append(_decisions(cache.lookup_batch(bank[:5], [down] * 5)))
        seq.append(_state(cache))
        outs.append(seq)
    _same(outs[0], outs[1])
    assert outs[1][1][0][0][1] == "degraded" and outs[1][-1][0]["wb_dropped"] == 2


def test_store_timeouts_degrade_hits():
    """The fault stack under one cache: a retried store absorbs a short
    run of failures, an exhausted one degrades the hit to a counted miss."""
    outs = []
    for pkg in (REF, PORT):
        faults, storage, Cache, Clock = pkg[1], pkg[2], pkg[3], pkg[4]
        clk = Clock()
        inj = faults.FaultInjector(faults.FaultSchedule(
            store_get_failures=frozenset({0, 1, 3, 4, 5, 6})), clk)
        store = storage.RetryingStore(storage.FlakyStore(storage.InMemoryStore(), inj),
                                      clock=clk, retries=3, backoff_ms=1.0,
                                      budget_ms=50.0)
        cache = Cache(_policies(pkg), dim=DIM, capacity=64, clock=clk, store=store,
                      index_kind="flat", use_device=True, **pkg[7])
        emb = _bank("a")[0]
        cache.insert(emb, "a", "q", "r")
        seq = [(r.hit, r.reason, r.response) for r in
               (cache.lookup(emb, "a") for _ in range(3))]
        outs.append((seq, dict(store.stats), inj.stats(), cache.metrics.snapshot(),
                     clk.now()))
    assert outs[0] == outs[1]
    assert outs[1][3]["a"]["store_timeouts"] == 1


# --------------------------------------------------- crash-safe migration
def _seed(cache, cat, n=12):
    bank = _bank(cat)[:n]
    cache.insert_batch(bank, [cat] * n, [f"q{i}" for i in range(n)],
                       [f"r{i}" for i in range(n)])
    return bank


def _migration_outcome(pkg, k, mode, index_kind):
    cache = _sharded(pkg, faults=_injector(pkg, crash_at={"migration": k}),
                     index_kind=index_kind)
    bank = _seed(cache, "a")
    src = cache.shard_of("a")
    with pytest.raises(pkg[1].InjectedCrash):
        cache.migrate_category("a", 1 - src, batch_size=4)
    mig = cache._migrations["a"]
    before = (cache.shard_of("a"), list(mig.journal), mig.fenced, mig.flipped)
    late = cache.insert(_bank("a")[20], "a", "late-q", "late-r")
    action = mig.recover(mode)
    res = cache.lookup_batch(np.concatenate([bank, _bank("a")[20:21]]), ["a"] * 13)
    return (before, late, action, list(mig.journal), cache.shard_of("a"),
            [s.category_count("a") for s in cache.shards], _decisions(res),
            dict(cache.fault_stats), sorted(cache._migrations))


@pytest.mark.parametrize("mode", ["resume", "abort"])
def test_migration_crash_at_every_step(mode):
    """A crash at every enumerable index of a 2-shard HNSW migration (12
    entries in batches of 4, a late write during the crash), then
    ``recover(mode)``: the same journal, owner, counts, decisions and
    fence counters as the reference, with every acknowledged write held
    by exactly one owner."""
    inj = _injector(PORT, crash_at={"elsewhere": 0})
    cache = _sharded(PORT, faults=inj, index_kind="hnsw")
    _seed(cache, "a")
    mig = cache.migrate_category("a", 1 - cache.shard_of("a"), batch_size=4)
    assert mig.journal == ["fence", "catchup", "reconcile", "flip", "purge", "unfence"]
    n = inj.visits("migration")
    assert n >= 9
    for k in range(n):
        ref, port = (_migration_outcome(pkg, k, mode, "hnsw") for pkg in (REF, PORT))
        _same(ref, port)
        counts, decisions = port[5], port[6][0]
        assert sum(counts) == counts[port[4]] == 13, k     # the late write too
        assert all(d[0] for d in decisions), k


# --------------------------------------------- exactly-once wb replay
def _wb_outcome(pkg, k):
    clk = pkg[4]()
    crash = {"wb_replay": k} if k >= 0 else {"elsewhere": 0}
    inj = _injector(pkg, clk, shard_outages=[(0.0, 5.0, 1)], crash_at=crash)
    cache = _sharded(pkg, faults=inj, clock=clk, replication={"a": 2})
    bank_a, bank_b = _bank("a"), _bank("b")
    embs = np.concatenate([bank_a[:4], bank_b[:4]])
    cats = ["a"] * 4 + ["b"] * 4
    cache.insert_batch(embs, cats, [f"q{i}" for i in range(8)],
                       [f"r{i}" for i in range(8)])
    clk.advance(10.0)
    crashed = False
    try:
        cache.lookup_batch(bank_a[:1], ["a"])
    except pkg[1].InjectedCrash:
        crashed = True
    cache.lookup_batch(bank_a[:1], ["a"])
    res = cache.lookup_batch(embs, cats)
    return crashed, _decisions(res), _state(cache), inj.visits("wb_replay")


def test_wb_replay_crash_at_every_index():
    n = _wb_outcome(PORT, -1)[3]
    assert n == 16
    for k in range(n):
        ref, port = _wb_outcome(REF, k), _wb_outcome(PORT, k)
        _same(ref[:3], port[:3])
        fs = port[2][0]
        assert port[0] and fs["wb_replayed"] == fs["wb_enqueued"] == 8, k
        assert all(d[0] for d in port[1][0]), k


# -------------------------------------------------- self-healing rebalance
def _rebalance_outcome(pkg, k, mode):
    src = _sharded(pkg).shard_of("a")
    clk = pkg[4]()
    crash = {"outage_rebalance": k} if k >= 0 else {"elsewhere": 0}
    inj = _injector(pkg, clk, shard_outages=[(2.0, 30.0, src)], crash_at=crash)
    cache = _sharded(pkg, faults=inj, clock=clk, rebalance_after_s=1.0)
    bank = _bank("a")
    cache.insert_batch(bank[:12], ["a"] * 12, [f"q{i}" for i in range(12)],
                       [f"r{i}" for i in range(12)])
    clk.advance(2.5)
    cache.insert_batch(bank[12:15], ["a"] * 3, ["wq0", "wq1", "wq2"],
                       ["wr0", "wr1", "wr2"])
    clk.advance(1.5)
    seq = []
    try:
        seq.append(_decisions(cache.lookup_batch(bank[:15], ["a"] * 15)))
    except pkg[1].InjectedCrash:
        reb = cache._migrations["a"]
        seq.append((list(reb.journal), reb.flipped))
        seq.append(cache.recover_migrations(mode))
        seq.append(_decisions(cache.lookup_batch(bank[:15], ["a"] * 15)))
    seq.append(_state(cache))
    clk.advance(40.0)
    seq.append(_decisions(cache.lookup_batch(bank[:15], ["a"] * 15)))
    seq.append(_state(cache))
    return seq, inj.visits("outage_rebalance")


@pytest.mark.parametrize("mode", ["resume", "abort"])
def test_outage_rebalance_crash_at_every_step(mode):
    """A sustained outage past ``rebalance_after_s`` rebuilds the dead
    shard's category on a live one from its store and write-behind queue;
    with no crash and after a crash at every index (recovered by
    ``mode``) each step matches the reference, and the recovered shard
    re-absorbs the category with every acknowledged write once."""
    n = _rebalance_outcome(PORT, -1, mode)[1]
    assert n >= 8
    for k in range(-1, n):
        ref, port = _rebalance_outcome(REF, k, mode)[0], _rebalance_outcome(PORT, k, mode)[0]
        _same(ref, port)
        final = port[-1]
        assert all(d[0] for d in port[-2][0]), k
        assert final[0]["wb_replayed"] == final[0]["wb_enqueued"] == 3, k
        assert sum(final[9][0::2]) == 15 and not final[8], k
