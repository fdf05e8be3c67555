"""The serving simulator beyond plain Table-1 traffic: repro_torch's
``serving/simulator.py`` against the JAX reference's on the CPU, with the
hybrid cache's device search on (``use_device=True``, CPU tensors).

The same seeded generators drive both packages' ``ServingSimulator``
through two workload scenarios, adaptive policies under a load spike, and
four shards behind the fault stack (``RetryingStore(FlakyStore(
InMemoryStore))``, shard outages, replication, outage rebalancing, the
trace recorder): ``SimResult.summary()``, the per-category rows, model
calls, index sync, fault counters and trace counts must be identical.
"""

import pytest

jax = pytest.importorskip("jax")

from repro.core.faults import FaultSchedule as JSchedule  # noqa: E402
from repro.core.policy import PolicyEngine as JEngine  # noqa: E402
from repro.core.policy import paper_policies as j_paper_policies  # noqa: E402
from repro.core.workload import TABLE1_WORKLOAD as J_TABLE1  # noqa: E402
from repro.core.workload import WorkloadGenerator as JWorkload  # noqa: E402
from repro.core.workload import scenario_generator as j_scenario  # noqa: E402
from repro.serving.simulator import ServingSimulator as JSim  # noqa: E402
from repro.serving.simulator import SimConfig as JSimConfig  # noqa: E402

from repro_torch.core.faults import FaultSchedule as TSchedule  # noqa: E402
from repro_torch.core.policy import PolicyEngine as TEngine  # noqa: E402
from repro_torch.core.policy import paper_policies as t_paper_policies  # noqa: E402
from repro_torch.core.workload import TABLE1_WORKLOAD as T_TABLE1  # noqa: E402
from repro_torch.core.workload import WorkloadGenerator as TWorkload  # noqa: E402
from repro_torch.core.workload import scenario_generator as t_scenario  # noqa: E402
from repro_torch.obs import span_accounting  # noqa: E402
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


REF = (JSim, JSimConfig, JEngine, j_paper_policies, JWorkload, J_TABLE1, j_scenario,
       JSchedule, {})
PORT = (TSim, TSimConfig, TEngine, t_paper_policies, TWorkload, T_TABLE1, t_scenario,
        TSchedule, {"device": "cpu"})


def _run(pkg, n, scenario=None, seed=42, schedule=None, **kw):
    Sim, Config, Engine, policies, Workload, table1, scenario_gen, Schedule, extra = pkg
    if schedule is not None:
        kw["fault_schedule"] = Schedule(**schedule)
    gen = (scenario_gen(scenario, seed=seed) if scenario else
           Workload(table1, rate_per_s=30.0, seed=seed))
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


@pytest.mark.parametrize("scenario", ["bursty", "drifting"])
def test_scenario_matches_reference(scenario):
    kw = dict(architecture="hybrid", index_kind="flat", cache_capacity=3000,
              scenario=scenario, seed=0)
    (ref, _), (port, _) = _run(REF, 600, **kw), _run(PORT, 600, **kw)
    assert _counters(port) == _counters(ref)


def test_adaptive_under_load_matches_reference():
    kw = dict(architecture="hybrid", index_kind="flat", adaptive=True,
              load_spikes=[(5.0, 30.0, "o1", 3.0)], seed=11)
    (ref, _), (port, _) = _run(REF, 400, **kw), _run(PORT, 400, **kw)
    assert _counters(port) == _counters(ref)
    base = _run(PORT, 400, architecture="hybrid", index_kind="flat",
                load_spikes=[(5.0, 30.0, "o1", 3.0)], seed=11)[0]
    assert port.model_calls["o1"] <= base.model_calls["o1"]


@pytest.mark.parametrize("index_kind", ["flat", "hnsw"])
def test_fault_stack_matches_reference(index_kind):
    """Four shards behind the fault stack: transient store failures, an
    outage of shard 1 with the head categories replicated, one outage of
    shard 2 past ``rebalance_after_s``, traced; the same counters, fault
    stats and span accounting as the reference."""
    schedule = dict(shard_outages=[(5.0, 15.0, 1), (20.0, 40.0, 2)],
                    store_get_failures=frozenset(range(5, 400, 7)))
    kw = dict(architecture="hybrid", index_kind=index_kind, n_shards=4,
              schedule=schedule, replication=0.15, rebalance_after_s=3.0,
              trace=True)
    n = {"flat": 600, "hnsw": 200}[index_kind]
    (ref, _), (port, _) = _run(REF, n, **kw), _run(PORT, n, **kw)
    assert _counters(port) == _counters(ref)
    fs = port.fault_stats
    assert fs["front_door"]["failover_reads"] > 0
    assert fs["front_door"]["outage_rebalances"] > 0
    assert fs["front_door"]["replica_divergence"] == 0
    assert fs["store"]["get_retries"] > 0
    assert port.trace.event_counts() == ref.trace.event_counts()
    acct, want = span_accounting(port.trace), span_accounting(ref.trace)
    assert {k: acct[k] for k in ("spans", "roots", "opened", "closed")} == \
        {k: want[k] for k in ("spans", "roots", "opened", "closed")}
