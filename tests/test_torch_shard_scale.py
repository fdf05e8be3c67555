"""The sharded HNSW tier at a scale where its decisions depart from one
cache's: repro_torch's ``ShardedSemanticCache`` against the JAX
reference's, on the CPU, every shard's beam search on the device
(``use_device=True``, CPU tensors), fp32 rows.

At capacity 256 (``test_torch_shard.py``) the beam search is exact and a
sharded cache decides as one cache does. At a few thousand entries it is
not: a shard's graph holds only its own categories, so its beam walks
another graph than one cache's, and some decisions differ from one
cache's. Those departures must be the reference's own: the port decides
as the reference does, query for query.

Traffic: Table-1 (the paper's seven categories and policies), seed 0.
The first 2,000 queries are inserted in batches of 256 with no lookup
(a warm cache of ~2,200 entries once the served misses are in), then 160
are served in batches of 8: ``lookup_batch``, then one ``insert_batch``
of the misses.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.core.shard as jshard  # noqa: E402
from repro.core.clock import SimClock as JClock  # noqa: E402
from repro.core.policy import PolicyEngine as JEngine  # noqa: E402
from repro.core.policy import paper_policies as j_paper_policies  # noqa: E402
from repro.core.workload import TABLE1_WORKLOAD, WorkloadGenerator  # noqa: E402

import repro_torch.core.shard as tshard  # noqa: E402
from repro_torch.core.cache import SemanticCache as TCache  # noqa: E402
from repro_torch.core.clock import SimClock as TClock  # noqa: E402
from repro_torch.core.policy import PolicyEngine as TEngine  # noqa: E402
from repro_torch.core.policy import paper_policies as t_paper_policies  # noqa: E402


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


WARM, SERVED, CAPACITY = 2_000, 160, 4_096
ATOL = 1e-5
KW = dict(capacity=CAPACITY, index_kind="hnsw", use_device=True, emb_dtype="float32",
          seed=0)


@pytest.fixture(scope="module")
def queries():
    return WorkloadGenerator(TABLE1_WORKLOAD, rate_per_s=30.0, seed=0).generate(
        WARM + SERVED)


def _run(cache, clock, queries):
    """Warm inserts, then the served traffic. Per served query (hit,
    reason, response, slot, score)."""
    warm = queries[:WARM]
    for s in range(0, WARM, 256):
        part = warm[s:s + 256]
        cache.insert_batch(np.stack([q.embedding for q in part]),
                           [q.category for q in part], [q.text for q in part],
                           [f"response:{q.text}" for q in part])
    trace = []
    for s in range(WARM, WARM + SERVED, 8):
        part = queries[s:s + 8]
        clock.advance(max(0.0, part[-1].timestamp - clock.now()))
        emb = np.stack([q.embedding for q in part])
        cats = [q.category for q in part]
        res = cache.lookup_batch(emb, cats)
        trace += [(r.hit, r.reason, r.response, r.slot, r.score) for r in res]
        miss = [i for i, r in enumerate(res) if not r.hit and r.reason != "compliance"]
        if miss:
            cache.insert_batch(emb[miss], [cats[i] for i in miss],
                               [part[i].text for i in miss],
                               [f"response:{part[i].text}" for i in miss])
    return trace


@pytest.fixture(scope="module")
def single(queries):
    """One port cache on the same traffic."""
    clock = TClock()
    return _run(TCache(TEngine(t_paper_policies()), clock=clock, device="cpu", **KW),
                clock, queries)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_hnsw_at_scale_decides_as_the_reference(n_shards, queries, single):
    jclock, tclock = JClock(), TClock()
    ref = jshard.ShardedSemanticCache(JEngine(j_paper_policies()), n_shards=n_shards,
                                      clock=jclock, **KW)
    port = tshard.ShardedSemanticCache(TEngine(t_paper_policies()), n_shards=n_shards,
                                       clock=tclock, device="cpu", **KW)
    want, got = _run(ref, jclock, queries), _run(port, tclock, queries)
    assert len(got) == len(want) == SERVED
    for i, (a, b) in enumerate(zip(want, got)):
        assert a[:4] == b[:4], (i, a, b)
        assert np.isneginf(a[4]) == np.isneginf(b[4])
        if np.isfinite(a[4]):
            assert abs(a[4] - b[4]) <= ATOL, (i, a, b)
    assert ref.metrics.snapshot() == port.metrics.snapshot()
    assert ref.sync_stats == port.sync_stats
    assert len(port) == len(ref) > WARM
    # the scale is one where sharding changes decisions (25 / 26 of 160
    # at 2 / 4 shards when written)
    differ = sum(a[:3] != b[:3] for a, b in zip(got, single))
    assert differ > 0, f"{n_shards} shards decide as one cache at this scale"
