"""The paper's serving simulator: repro_torch's ``serving/simulator.py``
against the JAX reference's, on the CPU, with the hybrid cache's device
search on (``use_device=True``, CPU tensors).

The same seeded Table-1 traffic drives both packages'
``ServingSimulator`` through the hybrid (one cache and four shards, flat
and HNSW), vector-DB and no-cache architectures: ``SimResult.summary()``,
the per-category rows, model calls and index sync must be identical. Then
the port alone at the long-tail benchmark's size holds the paper's
comparisons (tests/test_torch_simulator_faults.py takes the scenarios,
adaptive policies and the fault stack).
"""

import pytest

jax = pytest.importorskip("jax")

from repro.core.policy import PolicyEngine as JEngine  # noqa: E402
from repro.core.policy import paper_policies as j_paper_policies  # noqa: E402
from repro.core.workload import TABLE1_WORKLOAD as J_TABLE1  # noqa: E402
from repro.core.workload import WorkloadGenerator as JWorkload  # noqa: E402
from repro.serving.simulator import ServingSimulator as JSim  # noqa: E402
from repro.serving.simulator import SimConfig as JSimConfig  # noqa: E402

from repro_torch.core.policy import PolicyEngine as TEngine  # noqa: E402
from repro_torch.core.policy import paper_policies as t_paper_policies  # noqa: E402
from repro_torch.core.workload import TABLE1_WORKLOAD as T_TABLE1  # noqa: E402
from repro_torch.core.workload import WorkloadGenerator as TWorkload  # noqa: E402
from repro_torch.serving import ServingSimulator as TSim  # noqa: E402
from repro_torch.serving import SimConfig as TSimConfig  # noqa: E402


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


N = {"flat": 400, "hnsw": 150}     # queries a run (the CPU's HNSW search is slow)
REF = (JSim, JSimConfig, JEngine, j_paper_policies, JWorkload, J_TABLE1, {})
PORT = (TSim, TSimConfig, TEngine, t_paper_policies, TWorkload, T_TABLE1,
        {"device": "cpu"})


def _run(pkg, n, seed=42, **kw):
    Sim, Config, Engine, policies, Workload, table1, extra = pkg
    gen = Workload(table1, rate_per_s=30.0, seed=seed)
    sim = Sim(Engine(policies()), Config(**{"cache_capacity": 2048,
                                            "use_device": True, **kw, **extra}))
    return sim.run(gen, n), sim


def _counters(res):
    out = dict(summary=res.summary(), per_category=res.per_category,
               model_calls=res.model_calls, traffic=res.traffic_to_models,
               index_sync=res.index_sync, resident=res.mean_resident_entries,
               hits_per_mb=res.hits_per_resident_mb, fault_stats=res.fault_stats,
               hit_rate=res.overall_hit_rate, mean_ms=res.mean_latency_ms,
               p95_ms=res.p95_latency_ms, cost=res.model_cost)
    if res.index_sync is not None:
        for s in res.index_sync.get("per_shard", []):
            assert s["bytes_synced"] > 0
    return out


@pytest.mark.parametrize("arch,index_kind,n_shards", [
    ("hybrid", "flat", 1), ("hybrid", "hnsw", 1), ("hybrid", "flat", 4),
    ("hybrid", "hnsw", 4), ("vdb", "flat", 1), ("none", "flat", 1),
])
def test_table1_run_matches_reference(arch, index_kind, n_shards):
    kw = dict(architecture=arch, index_kind=index_kind, n_shards=n_shards)
    n = N[index_kind]
    (ref, _), (port, _) = _run(REF, n, **kw), _run(PORT, n, **kw)
    assert _counters(port) == _counters(ref)
    assert port.n_queries == n
    per = port.per_category
    assert sum(s["lookups"] for s in per.values()) == n
    if arch == "hybrid":       # the long tail's shape, from a cold cache
        assert per["code_generation"]["hit_rate"] > \
            2.5 * per["conversational_chat"]["hit_rate"]
        assert all(s["hits"] + s["misses"] == s["lookups"] for s in per.values())


def test_sharded_flat_equals_one_cache_and_hybrid_wins():
    """The port alone at the long-tail benchmark's size (capacity 12,000,
    2,000 queries): four shards give one cache's counters on flat (the
    index sync aside, which is per shard); hybrid beats no cache on mean
    latency and model cost, and the vector DB on latency once each false
    positive pays a model call (its uniform threshold serves wrong answers
    fast), as the reference's simulator tests require."""
    kw = dict(index_kind="flat", cache_capacity=12000)
    one, four = (_counters(_run(PORT, 2000, architecture="hybrid", n_shards=n, **kw)[0])
                 for n in (1, 4))
    for k in ("summary", "per_category", "model_calls", "resident", "hits_per_mb"):
        assert one[k] == four[k], k
    hy, vdb, none = (_run(PORT, 2000, architecture=a, **kw)[0]
                     for a in ("hybrid", "vdb", "none"))
    assert hy.mean_latency_ms < none.mean_latency_ms and hy.model_cost < none.model_cost
    assert vdb.false_positives > 5 * max(1, hy.false_positives)
    t_fp = 500.0
    hy_q = hy.mean_latency_ms + hy.false_positives / hy.n_queries * t_fp
    vdb_q = vdb.mean_latency_ms + vdb.false_positives / vdb.n_queries * t_fp
    assert hy_q < vdb_q and vdb.mean_latency_ms > 30.0
