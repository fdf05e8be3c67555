"""The slice as a whole: repro_torch's SemanticCache against the JAX
reference's, on the CPU, with the device search on (``use_device=True``).

Both caches serve the same Table-1 traffic (lookup_batch, then one
insert_batch of the misses) over {hnsw, flat} x {float32, int8}: the
CacheResult hit/reason/slot/doc_id sequences, per-category metrics,
last_lookup_stats and sync_stats must be identical and scores agree
within 1e-5. Fixtures keep every decision further than 1e-5 from its τ,
where two fp32 summation orders may legitimately disagree.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core.cache import SemanticCache as JCache  # noqa: E402
from repro.core.clock import SimClock as JClock  # noqa: E402
from repro.core.policy import CategoryConfig as JConfig  # noqa: E402
from repro.core.policy import PolicyEngine as JEngine  # noqa: E402
from repro.core.policy import paper_policies as j_paper_policies  # noqa: E402
from repro.core.workload import TABLE1_WORKLOAD, WorkloadGenerator  # noqa: E402

from repro_torch.core.cache import SemanticCache as TCache  # noqa: E402
from repro_torch.core.clock import SimClock as TClock  # noqa: E402
from repro_torch.core.policy import CategoryConfig as TConfig  # noqa: E402
from repro_torch.core.policy import PolicyEngine as TEngine  # noqa: E402
from repro_torch.core.policy import paper_policies as t_paper_policies  # noqa: E402
from repro_torch.core.workload import TABLE1_WORKLOAD as T_TABLE1  # noqa: E402
from repro_torch.core.workload import WorkloadGenerator as TWorkload  # noqa: E402

ATOL = 1e-5


def _serve(cache, clock, queries, batch=8):
    """Per query (hit, reason, slot, doc_id, score); per step the lookup
    stats."""
    out, stats = [], []
    for s in range(0, len(queries), batch):
        part = queries[s:s + batch]
        clock.advance(max(0.0, part[-1].timestamp - clock.now()))
        emb = np.stack([q.embedding for q in part])
        cats = [q.category for q in part]
        res = cache.lookup_batch(emb, cats)
        out += [(r.hit, r.reason, r.slot, r.doc_id, r.score,
                 cache.policies.effective(c).threshold) for r, c in zip(res, cats)]
        stats.append(dict(cache.last_lookup_stats))
        miss = [i for i, r in enumerate(res) if not r.hit and r.reason != "compliance"]
        if miss:
            cache.insert_batch(emb[miss], [cats[i] for i in miss],
                               [part[i].text for i in miss],
                               [f"response:{part[i].text}" for i in miss])
    return out, stats


def _assert_same(ref, port):
    (a, sa), (b, sb) = ref, port
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:4] == y[:4]
        assert np.isneginf(x[4]) == np.isneginf(y[4])
        if np.isfinite(x[4]):
            assert abs(x[4] - y[4]) <= ATOL
            assert abs(x[4] - x[5]) > ATOL     # fixture stays off the τ band
    assert sa == sb


@pytest.mark.parametrize("index_kind", ["hnsw", "flat"])
@pytest.mark.parametrize("emb_dtype", ["float32", "int8"])
def test_table1_traffic_parity(index_kind, emb_dtype):
    queries = WorkloadGenerator(TABLE1_WORKLOAD, rate_per_s=30.0, seed=3).generate(480)
    tq = TWorkload(T_TABLE1, rate_per_s=30.0, seed=3).generate(480)
    assert all(np.array_equal(x.embedding, y.embedding) for x, y in zip(queries, tq))
    jclk = JClock()
    ref = JCache(JEngine(j_paper_policies()), capacity=1024, clock=jclk,
                 index_kind=index_kind, use_device=True, emb_dtype=emb_dtype)
    tclk = TClock()
    port = TCache(TEngine(t_paper_policies()), capacity=1024, clock=tclk,
                  index_kind=index_kind, use_device=True, emb_dtype=emb_dtype,
                  device="cpu")
    r_out = _serve(ref, jclk, queries)
    t_out = _serve(port, tclk, tq)
    _assert_same(r_out, t_out)
    assert sum(1 for x in r_out[0] if x[0]) > 20         # hits really happen
    assert ref.metrics.snapshot() == port.metrics.snapshot()
    assert ref.sync_stats == port.sync_stats
    assert ref.index.search_stats == port.index.search_stats
    assert len(ref) == len(port)
    assert np.array_equal(ref.slot_doc, port.slot_doc)


@pytest.mark.parametrize("index_kind", ["hnsw", "flat"])
def test_ttl_expiry_and_epoch_clock_parity(index_kind):
    """Algorithm 1 lines 18-21 on the device path: fresh entries hit under
    an epoch-scale clock (timestamps rebased, fp32 inserted table), expire
    after their TTL and are evicted — the same in both packages."""
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((12, 128)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    outs = []
    for Cache, Clock, Engine, Config, kw in (
            (JCache, JClock, JEngine, JConfig, {}),
            (TCache, TClock, TEngine, TConfig, {"device": "cpu"})):
        clock = Clock(start=1.7e9)
        cache = Cache(Engine([Config("short", threshold=0.9, ttl=60.0, quota=1.0)]),
                      dim=128, capacity=128, clock=clock, index_kind=index_kind,
                      use_device=True, **kw)
        cache.insert_batch(vecs, ["short"] * 12, [f"q{i}" for i in range(12)],
                           [f"r{i}" for i in range(12)])
        seq = []
        for dt in (0.0, 59.0, 2.0, 0.0):
            clock.advance(dt)
            res = cache.lookup_batch(vecs[:6], ["short"] * 6)
            seq.append([(r.hit, r.reason, r.slot) for r in res])
        seq.append(cache.metrics.snapshot())
        seq.append(len(cache))
        outs.append(seq)
    assert outs[0] == outs[1]
    assert outs[1][2][0][1] == "expired" and outs[1][3][0][1] == "no_match"


@pytest.mark.parametrize("index_kind", ["hnsw", "flat"])
def test_int8_rerank_boundary_parity(index_kind):
    """Queries engineered inside the re-rank margin on both sides of τ: the
    int8 device path with the fp32 re-rank tier decides exactly as the
    reference does (hit/miss, slot, re-rank counters)."""
    rng = np.random.default_rng(99)
    dim, tau, n = 128, 0.90, 24
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    cats = ["a" if i % 2 else "b" for i in range(n)]
    offsets = [-0.03, -0.012, -0.006, -0.002, -0.0005,
               0.0005, 0.002, 0.006, 0.012, 0.03]
    targets = rng.integers(0, n, len(offsets))
    qs = []
    for t, off in zip(targets, offsets):
        v = vecs[t]
        r = rng.standard_normal(dim).astype(np.float32)
        r -= (r @ v) * v
        r /= np.linalg.norm(r)
        target = tau + off
        q = target * v + np.sqrt(1.0 - target * target) * r
        qs.append((q / np.linalg.norm(q)).astype(np.float32))
    q = np.stack(qs)
    qcats = [cats[t] for t in targets]
    outs = []
    for Cache, Clock, Engine, Config, kw in (
            (JCache, JClock, JEngine, JConfig, {}),
            (TCache, TClock, TEngine, TConfig, {"device": "cpu"})):
        eng = Engine([Config("a", threshold=tau, ttl=1e9, quota=0.6),
                      Config("b", threshold=tau, ttl=1e9, quota=0.6)])
        cache = Cache(eng, dim=dim, capacity=256, clock=Clock(),
                      index_kind=index_kind, use_device=True, seed=11,
                      emb_dtype="int8", **kw)
        cache.insert_batch(vecs, cats, [f"q{i}" for i in range(n)],
                           [f"r{i}" for i in range(n)])
        res = cache.lookup_batch(q, qcats)
        outs.append(([(r.hit, r.reason, r.slot) for r in res],
                     cache.last_lookup_stats, cache.metrics.snapshot()))
    assert outs[0] == outs[1]
    assert outs[1][1]["reranks"] > 0


def test_host_search_path_parity():
    """``use_device=False`` keeps the reference's host numpy search."""
    queries = WorkloadGenerator(TABLE1_WORKLOAD, rate_per_s=30.0, seed=4).generate(160)
    ref = JCache(JEngine(j_paper_policies()), capacity=512, clock=JClock(),
                 index_kind="hnsw", use_device=False)
    port = TCache(TEngine(t_paper_policies()), capacity=512, clock=TClock(),
                  index_kind="hnsw", use_device=False, device="cpu")
    _assert_same(_serve(ref, ref.clock, queries), _serve(port, port.clock, queries))
    assert ref.metrics.snapshot() == port.metrics.snapshot()
