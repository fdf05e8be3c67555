"""repro_torch's serving engine and driver on the CPU, and their parity
with the JAX reference.

The engine tests of ``test_system.py`` re-run on the port. With the
reference's parameters carried across, the port's engine gives the
reference engine's tokens and reasons exactly: the models agree within
~5e-3 on these seeds (fp32, the reference's bf16 prefill probabilities
being the only difference, see ``test_torch_models.py``), well inside the
top-2 margins of the tokens generated here. ``run_serving`` draws its own
weights (``torch.Generator`` cannot give ``jax.random``'s numbers), but
hits and misses depend only on the request text, so its counters match
the reference's for the same seed.
"""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.cache import SemanticCache as JCache  # noqa: E402
from repro.core.clock import SimClock as JClock  # noqa: E402
from repro.core.policy import PolicyEngine as JPolicies  # noqa: E402
from repro.core.policy import paper_policies as jpaper  # noqa: E402
from repro.launch.serve import run_serving as jrun_serving  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cache import SemanticCache  # noqa: E402
from repro_torch.core.clock import SimClock  # noqa: E402
from repro_torch.core.policy import PolicyEngine, paper_policies  # noqa: E402
from repro_torch.distributed.fault import StepWatchdog  # noqa: E402
from repro_torch.launch.serve import run_serving  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


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


def _small(**kw):
    return dict(n_layers=2, d_model=64, vocab_size=256, **kw)


@pytest.fixture(scope="module")
def small_model():
    cfg = get_config("llama3_2_3b").reduced(**_small())
    model = Model(cfg, device="cpu")
    return cfg, model, model.init_params(0)


def _cache(capacity):
    return SemanticCache(PolicyEngine(paper_policies()), capacity=capacity,
                         clock=SimClock(), index_kind="flat", device="cpu")


def test_engine_serves_hits_without_model(small_model, rng):
    cfg, model, params = small_model
    eng = ServingEngine(model, params, _cache(1024), max_batch=4, prompt_len=16,
                        max_new_tokens=4)
    toks = rng.integers(2, cfg.vocab_size, 16)
    eng.submit("how do I sort a list in python", "code_generation", toks)
    r1 = eng.drain()
    assert len(r1) == 1 and not r1[0].cached
    assert r1[0].tokens.shape == (4,)
    tokens_after_first = eng.stats.model_tokens
    # paraphrase-identical resubmission → cache hit, no new model tokens
    eng.submit("how do I sort a list in python", "code_generation", toks)
    r2 = eng.drain()
    assert r2[0].cached
    assert eng.stats.model_tokens == tokens_after_first
    assert r2[0].text == r1[0].text


def test_engine_compliance_always_model(small_model, rng):
    cfg, model, params = small_model
    cache = _cache(128)
    eng = ServingEngine(model, params, cache, max_batch=2, prompt_len=16,
                        max_new_tokens=4)
    toks = rng.integers(2, cfg.vocab_size, 16)
    for _ in range(2):
        eng.submit("patient record 1234", "phi_medical_records", toks)
    res = eng.drain()
    assert all(not r.cached for r in res)
    assert len(cache) == 0


def test_engine_watchdog_counts_straggler_steps(small_model, rng):
    """The StepWatchdog rides every non-empty step(): fast steps build the
    median history, an artificially slowed step surfaces as
    ``stats.straggler_steps``."""
    cfg, model, params = small_model
    wd = StepWatchdog(timeout_factor=20.0, min_history=5)
    eng = ServingEngine(model, params, _cache(128), max_batch=1, prompt_len=16,
                        max_new_tokens=4, watchdog=wd)
    assert eng.step() == []                 # empty queue: never timed
    toks = rng.integers(2, cfg.vocab_size, 16)
    for _ in range(8):
        eng.submit("what is a closure", "code_generation", toks)
        eng.step()
    assert eng.stats.straggler_steps == 0
    orig = eng._generate

    def slow_generate(p, t):
        time.sleep(0.5)
        return orig(p, t)
    eng._generate = slow_generate
    eng.submit("a brand new uncached question", "code_generation", toks)
    eng.step()
    eng._generate = orig
    assert eng.stats.straggler_steps == 1
    assert wd.straggler_events == 1


def _traffic(n, seed):
    from repro_torch.core.workload import TABLE1_WORKLOAD, WorkloadGenerator
    return WorkloadGenerator(TABLE1_WORKLOAD, rate_per_s=1e9, seed=seed).generate(n)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "falcon_mamba_7b"])
def test_engine_tokens_and_reasons_match_reference(arch):
    """Carried-across parameters (fp32): the same requests give the same
    hit/miss reasons, the same generated tokens and the same counters,
    for the dense and the ssm family."""
    jcfg = jget_config(arch).reduced(**_small(dtype="float32"))
    cfg = get_config(arch).reduced(**_small(dtype="float32"))
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.key(3))
    tm = Model(cfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jeng = JEngine(jm, jp, JCache(JPolicies(jpaper()), capacity=512, clock=JClock(),
                                  index_kind="flat"),
                   max_batch=4, prompt_len=12, max_new_tokens=4)
    teng = ServingEngine(tm, tp, _cache(512), max_batch=4, prompt_len=12, max_new_tokens=4)
    rng = np.random.default_rng(5)
    queries = _traffic(24, seed=5)
    for q in queries:
        toks = rng.integers(2, cfg.vocab_size, 12)
        jeng.submit(q.text, q.category, toks)
        teng.submit(q.text, q.category, toks)
    jres = sorted(jeng.drain(), key=lambda r: r.req_id)
    tres = sorted(teng.drain(), key=lambda r: r.req_id)
    assert [(r.req_id, r.cached, r.reason, r.text) for r in tres] == \
        [(r.req_id, r.cached, r.reason, r.text) for r in jres]
    assert any(not r.cached for r in tres) and any(r.cached for r in tres)
    for a, b in zip(tres, jres):
        if not a.cached:
            assert np.array_equal(a.tokens, np.asarray(b.tokens))
    assert teng.stats.reasons == jeng.stats.reasons
    assert (teng.stats.served, teng.stats.cache_hits, teng.stats.model_tokens) == \
        (jeng.stats.served, jeng.stats.cache_hits, jeng.stats.model_tokens)


def _counters(out):
    keep = ("lookups", "hits", "misses", "inserts", "hit_rate")
    return (out["served"], out["hit_rate"], out["model_tokens"],
            {c: {k: v for k, v in row.items() if k in keep}
             for c, row in out["per_category"].items()})


@pytest.mark.parametrize("arch", ["llama3_2_3b", "falcon_mamba_7b"])
def test_run_serving_counters_match_reference(arch):
    """Same seed, different random weights: served, hit rate, model tokens
    and per-category counters are identical."""
    kw = dict(n_requests=48, max_batch=8, prompt_len=16, max_new_tokens=4, seed=2,
              log=lambda *_: None)
    want = jrun_serving(jget_config(arch).reduced(), **kw)
    got = run_serving(get_config(arch).reduced(), device="cpu", **kw)
    assert _counters(got) == _counters(want)
    assert got["served"] == 48 and 0 < got["hit_rate"] < 1


def test_run_serving_refuses_shards():
    """The refusal of ``n_shards > 1`` is lifted: a sharded, replicated run
    gives the reference's counters, replica sets and per-shard sync."""
    kw = dict(n_requests=48, max_batch=8, prompt_len=16, max_new_tokens=4, seed=2,
              n_shards=4, replicas=0.25, use_device=True, log=lambda *_: None)
    want = jrun_serving(jget_config("llama3_2_3b").reduced(), **kw)
    got = run_serving(get_config("llama3_2_3b").reduced(), device="cpu", **kw)
    assert _counters(got) == _counters(want)
    assert got["replica_sets"] == want["replica_sets"] and got["replica_sets"]
    assert got["index_sync"] == want["index_sync"]
    assert len(got["index_sync"]["per_shard"]) == 4


def _report(out: str) -> list[str]:
    """The driver's report lines without its wall-clock numbers."""
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
    return [ln.split(", mean_latency=")[0] for ln in lines]


@pytest.mark.parametrize("shards", ["1", "4"])
def test_cli_counters_match_reference(shards, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch llama3.2-3b --reduced
    --requests 48 [--shards 4] --device cpu`` searches on the device (CPU
    tensors) by default and prints the counters of the reference's CLI
    run with ``--use-device``."""
    import repro.launch.serve as jserve

    import repro_torch.launch.serve as tserve
    args = ["serve", "--arch", "llama3.2-3b", "--reduced", "--requests", "48",
            "--shards", shards]
    monkeypatch.setattr("sys.argv", args + ["--use-device"])
    jserve.main()
    want = _report(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", args + ["--device", "cpu"])
    captured = []
    orig = tserve.run_serving
    monkeypatch.setattr(tserve, "run_serving",
                        lambda *a, **kw: captured.append(kw) or orig(*a, **kw))
    tserve.main()
    got = _report(capsys.readouterr().out)
    assert captured[0]["use_device"] and got == want
    assert len(got) == 4 + (int(shards) if shards != "1" else 0)
