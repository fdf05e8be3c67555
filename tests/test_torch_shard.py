"""The sharded cache tier: repro_torch's ``core/shard.py`` against the JAX
reference's, on the CPU, with every shard's device search on
(``use_device=True``, CPU tensors).

Both packages run the same seeded dim-48 fixtures (the reference tests'
banks and mixed-category schedule: revisits, fresh intents, a quota
overflow, TTL expiry and a compliance-blocked category): the CacheResult
(hit, reason, response, slot, doc_id) sequences, per-category metrics,
``sync_stats`` with ``per_shard``, ``last_lookup_stats`` and the shard
report must be identical, scores within 1e-5; and a sharded port cache
must decide as one port cache does. Then the planner's placement, the
router, and a live migration's journal and final tables.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.core.shard as jshard  # noqa: E402
from repro.core.cache import SemanticCache as JCache  # noqa: E402
from repro.core.clock import SimClock as JClock  # noqa: E402
from repro.core.economics import ResidencyModel as JResidency  # noqa: E402
from repro.core.policy import CategoryConfig as JConfig  # noqa: E402
from repro.core.policy import PolicyEngine as JEngine  # noqa: E402
from repro.core.policy import paper_policies as j_paper_policies  # noqa: E402
from repro.serving.router import ModelBackend as JBackend  # noqa: E402
from repro.serving.router import ModelRouter as JRouter  # noqa: E402

import repro_torch.core.shard as tshard  # noqa: E402
from repro_torch.core.cache import SemanticCache as TCache  # noqa: E402
from repro_torch.core.clock import SimClock as TClock  # noqa: E402
from repro_torch.core.economics import ResidencyModel as TResidency  # noqa: E402
from repro_torch.core.policy import CategoryConfig as TConfig  # noqa: E402
from repro_torch.core.policy import PolicyEngine as TEngine  # noqa: E402
from repro_torch.core.policy import paper_policies as t_paper_policies  # noqa: E402
from repro_torch.serving.router import ModelBackend as TBackend  # noqa: E402
from repro_torch.serving.router import ModelRouter as TRouter  # noqa: E402


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
# (package, cache class, sharded class, clock, engine, config, extra kwargs)
REF = (jshard, JCache, jshard.ShardedSemanticCache, JClock, JEngine, JConfig, {})
PORT = (tshard, TCache, tshard.ShardedSemanticCache, TClock, TEngine, TConfig,
        {"device": "cpu"})


def _policies(Engine, Config, admission=False):
    gate = dict(admit_after=2) if admission else {}
    return Engine([
        Config("a", threshold=0.80, ttl=25.0, quota=0.30, priority=2.0,
               **gate, **({"expected_tllm_ms": 800.0} if admission else {})),
        Config("b", threshold=0.78, ttl=1e6, quota=0.30,
               **({"expected_tllm_ms": 200.0} if admission else {})),
        Config("c", threshold=0.75, ttl=1e6, quota=0.05, priority=0.5,
               **gate, **({"expected_tllm_ms": 500.0} if admission else {})),
        Config("d", threshold=0.95, ttl=1.0, quota=0.0, allow_caching=False),
    ])


def _banks(n_intents=64):
    banks = {}
    for k, cat in enumerate(("a", "b", "c", "d")):
        v = np.random.default_rng(100 + k).standard_normal((n_intents, DIM))
        v = v.astype(np.float32)
        banks[cat] = v / np.linalg.norm(v, axis=1, keepdims=True)
    return banks


def _workload(rounds=8):
    sched, seen = [], {"a": 0, "b": 0, "c": 0}
    for r in range(rounds):
        batch = []
        for cat, new in (("a", 2), ("b", 2), ("c", 3)):
            for j in range(3):
                if seen[cat]:
                    batch.append((cat, (r + j) % seen[cat]))
            for j in range(new):
                batch.append((cat, seen[cat] + j))
            seen[cat] += new
        batch.append(("d", r))
        sched.append(batch)
    return sched


def _run(cache, banks, sched):
    """Per query (hit, reason, response, slot, doc_id, score); per round
    the lookup and insert stats."""
    trace, stats = [], []
    for r, batch in enumerate(sched):
        embs = np.stack([banks[c][i] for c, i in batch])
        cats = [c for c, _ in batch]
        res = cache.lookup_batch(embs, cats)
        trace += [(x.hit, x.reason, x.response, x.slot, x.doc_id, x.score)
                  for x in res]
        stats.append(dict(cache.last_lookup_stats))
        miss = [k for k, x in enumerate(res) if not x.hit and x.reason != "compliance"]
        if miss:
            cache.insert_batch(embs[miss], [cats[k] for k in miss],
                               [f"q:{batch[k][0]}:{batch[k][1]}" for k in miss],
                               [f"r:{batch[k][0]}:{batch[k][1]}" for k in miss])
            stats.append(dict(cache.last_insert_stats))
        cache.clock.advance(10.0)
        if r % 3 == 2:
            cache.sweep_expired()
    return trace, stats


def _same_trace(a, b):
    """Equal decisions, responses, slots and doc ids; scores within ATOL."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:5] == y[:5]
        assert np.isneginf(x[5]) == np.isneginf(y[5])
        if np.isfinite(x[5]):
            assert abs(x[5] - y[5]) <= ATOL


def _sharded(pkg, n_shards, policies=None, admission=False, **kw):
    _, _, Sharded, Clock, Engine, Config, extra = pkg
    return Sharded(policies or _policies(Engine, Config, admission),
                   n_shards=n_shards, clock=Clock(), dim=DIM, **extra, **kw)


# ------------------------------------------------ fan-out decisions, stats
@pytest.mark.parametrize("emb_dtype", ["float32", "int8"])
@pytest.mark.parametrize("index_kind", ["flat", "hnsw"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_decisions_match_reference(n_shards, index_kind, emb_dtype):
    banks, sched = _banks(), _workload()
    kw = dict(capacity=256, index_kind=index_kind, use_device=True,
              emb_dtype=emb_dtype, seed=0)
    ref, port = _sharded(REF, n_shards, **kw), _sharded(PORT, n_shards, **kw)
    (rt, rs), (pt, ps) = _run(ref, banks, sched), _run(port, banks, sched)
    _same_trace(rt, pt)
    assert rs == ps
    reasons = {t[1] for t in pt}
    assert {"hit", "expired", "compliance", "no_match"} <= reasons
    assert ref.metrics.snapshot() == port.metrics.snapshot()
    assert ref.sync_stats == port.sync_stats
    assert len(port.sync_stats["per_shard"]) == n_shards
    assert ref.shard_report() == port.shard_report()
    assert ref.planner.report() == port.planner.report()
    assert [ref.doc_id_of(t[3]) for t in rt] == [port.doc_id_of(t[3]) for t in pt]
    # the sharded port cache decides and serves as one port cache does
    # (a miss's best score may differ: an HNSW shard's graph holds only
    # its own categories)
    _, Cache, _, Clock, Engine, Config, extra = PORT
    single = Cache(_policies(Engine, Config), clock=Clock(), dim=DIM, **extra, **kw)
    st, _ = _run(single, banks, sched)
    assert [t[:3] for t in st] == [t[:3] for t in pt]
    if n_shards > 1:
        assert len({port.shard_of(c) for c in "abc"}) > 1


@pytest.mark.parametrize("index_kind", ["flat", "hnsw"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_admission_and_cost_aware_parity(n_shards, index_kind):
    """admit_after=2 on two categories and cost_aware eviction: the same
    decisions and admission skips as the reference."""
    banks, sched = _banks(), _workload(rounds=10)
    kw = dict(capacity=256, index_kind=index_kind, use_device=True,
              eviction="cost_aware", seed=0, admission=True)
    ref, port = _sharded(REF, n_shards, **kw), _sharded(PORT, n_shards, **kw)
    (rt, rs), (pt, ps) = _run(ref, banks, sched), _run(port, banks, sched)
    _same_trace(rt, pt)
    assert rs == ps
    snap = port.metrics.snapshot()
    assert snap == ref.metrics.snapshot()
    assert snap["a"]["admission_skips"] > 0 and snap["b"]["admission_skips"] == 0


def test_global_slots_doc_ids_and_stats_views():
    banks = _banks()
    embs = np.stack([banks["a"][0], banks["b"][0], banks["a"][1]])
    cats = ["a", "b", "a"]
    outs = []
    for pkg in (REF, PORT):
        cache = _sharded(pkg, 2, capacity=128, index_kind="flat", use_device=True)
        slots = cache.insert_batch(embs, cats, ["q0", "q1", "q2"], ["r0", "r1", "r2"])
        res = cache.lookup_batch(embs, cats)
        assert all(r.hit for r in res) and [r.slot for r in res] == slots
        assert {cache.shard_of_slot(s)[0] for s in slots} == {0, 1}
        outs.append((slots, [cache.doc_id_of(s) for s in slots],
                     cache.shard_of_slot(-1), cache.last_lookup_stats,
                     cache.last_insert_stats, cache.sync_stats,
                     cache.metrics.snapshot(), cache.metrics.slo_report(),
                     cache.shard_report(), len(cache)))
    assert outs[0] == outs[1]


# ------------------------------------------------------------- the planner
@pytest.mark.parametrize("replication", [None, 0.25, {"code_generation": 3}])
@pytest.mark.parametrize("emb_dtype", ["float32", "int8"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_planner_placement_matches_reference(n_shards, emb_dtype, replication):
    ref = jshard.ShardPlanner.from_policies(JEngine(j_paper_policies()), n_shards,
                                            100_000, emb_dtype=emb_dtype,
                                            replication=replication)
    port = tshard.ShardPlanner.from_policies(TEngine(t_paper_policies()), n_shards,
                                             100_000, emb_dtype=emb_dtype,
                                             replication=replication)
    assert port.report() == ref.report()
    assert port.imbalance() == ref.imbalance()
    names = sorted(TEngine(t_paper_policies()).categories())
    assert [port.replica_set(c) for c in names] == [ref.replica_set(c) for c in names]
    assert [tshard.crc32_shard(c, n_shards) for c in names] == \
        [jshard.crc32_shard(c, n_shards) for c in names]
    # quota-byte packing beats the crc32 hash on the Table-1 quotas
    crc = [0] * n_shards
    for c in names:
        crc[tshard.crc32_shard(c, n_shards)] += port.quota_bytes(
            TEngine(t_paper_policies()).get(c).quota)
    if replication is None:
        assert port.imbalance() < max(crc) / (sum(crc) / n_shards)


def test_planner_weights_and_assign_match_reference():
    assert TResidency(dim=384, emb_dtype="int8").quota_bytes(0.4, 10_000) == \
        JResidency(dim=384, emb_dtype="int8").quota_bytes(0.4, 10_000)
    outs = []
    for sh, Engine, Config in ((jshard, JEngine, JConfig), (tshard, TEngine, TConfig)):
        p = sh.ShardPlanner.from_policies(_policies(Engine, Config), 2, 1000)
        s = p.shard_of("never_seen")
        p.assign("a", 1 - p.shard_of("a"))
        crc = sh.CRC32Planner(4)
        crc.assign("code_generation", 2)
        outs.append((s, p.report(), p._bytes, crc.shard_of("code_generation"),
                     crc.replica_set("a")))
    assert outs[0] == outs[1]


# --------------------------------------------------------------- the router
@pytest.mark.parametrize("planner", [None, False])
def test_router_matches_reference(planner):
    outs = []
    for Engine, pp, Backend, Router in ((JEngine, j_paper_policies, JBackend, JRouter),
                                        (TEngine, t_paper_policies, TBackend, TRouter)):
        pol = Engine(pp())
        router = Router(pol, [Backend("gpt4o", 500.0, 0.01),
                              Backend("o1", 1800.0, 0.06, latency_target_ms=900.0)],
                        n_cache_shards=2, planner=planner)
        names = sorted(pol.categories())
        for i in range(160):
            b = router.backend_for(names[i % len(names)])
            alpha = 3.0 if b.name == "o1" else 1.0
            router.observe(b.name, b.invoke_ms(alpha), queue_depth=int(alpha * 20))
        outs.append((router.report(), [router.shard_for(c) for c in names],
                     [router.backend_for(c).name for c in names],
                     [router.effective_policy(c).threshold for c in names],
                     router.planner is None))
    assert outs[0] == outs[1]
    report = outs[1][0]
    assert report["o1"]["load_factor"] == 1.0 > report["gpt4o"]["load_factor"] > 0


# -------------------------------------------------------- live migration
def _migration_cache(pkg, emb_dtype, index_kind):
    sh, _, Sharded, Clock, Engine, Config, extra = pkg
    pol = Engine([Config("a", threshold=0.80, ttl=500.0, quota=0.45, priority=2.0),
                  Config("b", threshold=0.80, ttl=1e6, quota=0.45)])
    Residency = JResidency if sh is jshard else TResidency
    planner = sh.ShardPlanner(2, 256, residency=Residency(dim=DIM, emb_dtype=emb_dtype),
                              policies=pol)
    planner.plan({"a": 0.45, "b": 0.45})
    return Sharded(pol, dim=DIM, capacity=256, n_shards=2, clock=Clock(),
                   index_kind=index_kind, use_device=True, emb_dtype=emb_dtype,
                   planner=planner, seed=3, **extra)


def _migrate(cache, banks):
    """Stepwise drain with reads and writes interleaved, then cutover and
    a quota-driven rebalance; returns what each step showed."""
    n0 = 30
    cache.insert_batch(banks["a"][:n0], ["a"] * n0, [f"q{i}" for i in range(n0)],
                       [f"r{i}" for i in range(n0)])
    cache.insert_batch(banks["b"][:10], ["b"] * 10, [f"bq{i}" for i in range(10)],
                       [f"br{i}" for i in range(10)])
    cache.clock.advance(5.0)
    src, dst = cache.shard_of("a"), cache.shard_of("b")
    mig = cache.migrate_category("a", dst, batch_size=7, stepwise=True)
    seen, n = [], n0
    while mig.remaining() > 0:
        seen.append(mig.step())
        res = cache.lookup_batch(banks["a"][:n], ["a"] * n)
        seen.append([(r.hit, r.response, r.slot) for r in res])
        if n < n0 + 4:
            cache.insert_batch(banks["a"][n][None], ["a"], [f"q{n}"], [f"r{n}"])
            n += 1
    mig.cutover()
    res = cache.lookup_batch(banks["a"][:n], ["a"] * n)
    assert all(r.hit for r in res) and cache.shard_of("a") == dst != src
    seen.append([(r.hit, r.response, r.slot, r.score) for r in res])
    tables = [{k: v.copy() for k, v in s.index._host_tables().items()}
              for s in cache.shards]
    meta = [(s.slot_doc.copy(), s.slot_hits.copy(), s.slot_valid.copy())
            for s in cache.shards]
    cache.policies.update("a", quota=0.05)
    moves = cache.rebalance()
    res = cache.lookup_batch(banks["b"][:10], ["b"] * 10)
    cache.clock.advance(500.0)
    expired = cache.lookup_batch(banks["a"][:5], ["a"] * 5)
    return (mig.journal, mig.moved, seen, moves, [r.hit for r in res],
            [r.reason for r in expired], cache.sync_stats,
            cache.metrics.snapshot()), tables, meta


@pytest.mark.parametrize("emb_dtype,index_kind", [
    ("float32", "flat"), ("int8", "flat"), ("float32", "hnsw"), ("int8", "hnsw"),
])
def test_live_migration_matches_reference(emb_dtype, index_kind):
    banks = _banks()
    (r_out, r_tab, r_meta), (p_out, p_tab, p_meta) = (
        _migrate(_migration_cache(pkg, emb_dtype, index_kind), banks)
        for pkg in (REF, PORT))
    r_seen, p_seen = r_out[2], p_out[2]
    final_r, final_p = r_seen.pop(), p_seen.pop()
    assert [x[:3] for x in final_r] == [x[:3] for x in final_p]
    assert max(abs(x[3] - y[3]) for x, y in zip(final_r, final_p)) <= ATOL
    assert r_out == p_out
    assert p_out[0] == ["fence", "catchup", "reconcile", "flip", "purge", "unfence"]
    assert p_out[5] == ["expired"] * 5
    for rt, pt in zip(r_tab, p_tab):
        assert rt.keys() == pt.keys()
        for k in rt:
            assert np.array_equal(rt[k], pt[k]), k
    for rm, pm in zip(r_meta, p_meta):
        assert all(np.array_equal(x, y) for x, y in zip(rm, pm))


def test_migration_guards_and_full_target_abort():
    banks = _banks()
    outs = []
    for pkg in (REF, PORT):
        sh, _, Sharded, Clock, Engine, Config, extra = pkg
        pol = Engine([Config("a", threshold=0.80, ttl=1e6, quota=0.45),
                      Config("b", threshold=0.80, ttl=1e6, quota=0.45)])
        planner = sh.ShardPlanner(2, 40, policies=pol)
        planner.plan({"a": 0.45, "b": 0.45})
        cache = Sharded(pol, dim=DIM, capacity=40, n_shards=2, clock=Clock(),
                        index_kind="flat", planner=planner, shard_capacity=12,
                        **extra)
        cache.insert_batch(banks["a"][:10], ["a"] * 10, [f"q{i}" for i in range(10)],
                           [f"r{i}" for i in range(10)])
        cache.insert_batch(banks["b"][:10], ["b"] * 10, [f"bq{i}" for i in range(10)],
                           [f"br{i}" for i in range(10)])
        assert cache.migrate_category("a", cache.shard_of("a")) is None
        assert cache.migrate_category("a", 99) is None
        with pytest.raises(RuntimeError, match="free"):
            cache.migrate_category("a", cache.shard_of("b"), batch_size=5)
        res = cache.lookup_batch(banks["a"][:10], ["a"] * 10)
        outs.append(("a" in cache._migrations, [r.hit for r in res],
                     [s.category_count("a") for s in cache.shards]))
        crc = Sharded(pol, dim=DIM, capacity=64, n_shards=2, clock=Clock(),
                      index_kind="flat", planner=sh.CRC32Planner(2), **extra)
        with pytest.raises(TypeError, match="ShardPlanner"):
            crc.rebalance()
    assert outs[0] == outs[1] and outs[1][1] == [True] * 10


def test_sharded_tier_and_simulator_run_on_the_card_by_default():
    """``device=None`` (the default) puts every shard's index, and the
    simulator's, on the card; without one they raise instead of running
    on the CPU."""
    import torch

    from repro_torch.serving.simulator import ServingSimulator, SimConfig
    pol = TEngine(t_paper_policies())
    make = [lambda: tshard.ShardedSemanticCache(pol, dim=DIM, capacity=64, n_shards=2),
            lambda: ServingSimulator(pol, SimConfig(cache_capacity=64, n_shards=2)),
            lambda: ServingSimulator(pol, SimConfig(architecture="vdb", cache_capacity=64))]
    if torch.cuda.is_available():
        cache = make[0]()
        assert cache.use_device and {s.index.device.type for s in cache.shards} == {"cuda"}
        return
    for fn in make:
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    cache = tshard.ShardedSemanticCache(pol, dim=DIM, capacity=64, n_shards=2, device="cpu")
    assert cache.use_device and {s.index.device.type for s in cache.shards} == {"cpu"}
