"""The port as a package: its imports, its device rule, its copied host
modules, and ``chip_smoke.py``'s refusal to run without a card.

repro_torch imports torch and numpy, never jax or the ``repro`` package
(the machine with the card has no JAX); entry points run on the card
unless the caller passes ``device="cpu"``; the host modules copied from
the reference draw the same numbers for the same seeds.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.obs, "
            "repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_none_means_the_card():
    """``device=None`` resolves to CUDA; without a card it raises instead
    of carrying on on the CPU."""
    from repro_torch.core.cache import SemanticCache
    from repro_torch.core.hnsw import FlatIndex, HNSWIndex, resolve_device
    from repro_torch.core.policy import PolicyEngine, paper_policies
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert FlatIndex(8, 4).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        HNSWIndex(8, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        FlatIndex(8, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        SemanticCache(PolicyEngine(paper_policies()), dim=8, capacity=4)
    cache = SemanticCache(PolicyEngine(paper_policies()), dim=8, capacity=4,
                          device="cpu")
    assert cache.use_device and cache.index.device.type == "cpu"


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """Without a card, or alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    scripts = [alone] if torch.cuda.is_available() else [ROOT / "chip_smoke.py", alone]
    for script in scripts:
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, PYTHONPATH=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


# ---------------------------------------------- copied host modules agree
@pytest.fixture
def reference():
    pytest.importorskip("jax")
    import repro.core.admission as admission
    import repro.core.embedding as embedding
    import repro.core.faults as faults
    import repro.core.storage as storage
    import repro.obs.hist as hist
    return admission, embedding, faults, storage, hist


def test_simhash_keys_and_count_min_counts_match(reference, rng):
    admission, *_ = reference
    from repro_torch.core import admission as tadm
    emb = rng.standard_normal((64, 384)).astype(np.float32)
    fr, ft = admission.QueryFingerprinter(384, seed=5), tadm.QueryFingerprinter(384, seed=5)
    assert [fr.key(e) for e in emb] == [ft.key(e) for e in emb]
    sr = admission.FrequencySketch(width=64, depth=3, seed=7, decay_every=50)
    st = tadm.FrequencySketch(width=64, depth=3, seed=7, decay_every=50)
    keys = rng.integers(0, 2**40, 300)
    keys = np.concatenate([keys, keys[:100]])
    assert [sr.observe(int(k)) for k in keys] == [st.observe(int(k)) for k in keys]
    assert np.array_equal(sr.counts, st.counts)
    tr = admission.CategoryTracker(384, tau=0.9, buffer_size=32, seed=3)
    tt = tadm.CategoryTracker(384, tau=0.9, buffer_size=32, seed=3)
    batch = np.concatenate([emb[:20], emb[:20] + 1e-3]).astype(np.float32)
    assert np.array_equal(tr.observe_batch(batch), tt.observe_batch(batch))


def test_histogram_buckets_match(reference, rng):
    *_, hist = reference
    from repro_torch.obs import hist as thist
    ms = np.concatenate([rng.lognormal(0.0, 3.0, 500), [0.0, 1e-3, 1.0, 1e9]])
    assert [hist.bucket_of(float(x)) for x in ms] == [thist.bucket_of(float(x)) for x in ms]
    hr, ht = hist.LatencyHistogram(), thist.LatencyHistogram()
    for x in ms:
        hr.observe(float(x))
        ht.observe(float(x))
    assert hr.to_dict() == ht.to_dict()


def test_store_retry_schedules_match(reference):
    _, _, faults, storage, _ = reference
    from repro_torch.core import faults as tfaults
    from repro_torch.core import storage as tstorage
    from repro_torch.core.clock import SimClock as TClock
    from repro.core.clock import SimClock as JClock

    def run(faults_mod, storage_mod, clock):
        sched = faults_mod.FaultSchedule(
            store_get_failures=faults_mod.FaultSchedule.op_range(1, 3) | {9},
            store_put_failures=frozenset({0}))
        inj = faults_mod.FaultInjector(sched, clock=clock)
        store = storage_mod.RetryingStore(
            storage_mod.FlakyStore(storage_mod.InMemoryStore(), inj),
            clock=clock, retries=3, backoff_ms=2.0, budget_ms=20.0)
        events = []
        for i in range(6):
            doc = storage_mod.Document(i, f"q{i}", f"r{i}", clock.now(), "c")
            try:
                store.put(doc)
                events.append(("put", i, clock.now()))
            except faults_mod.StoreTimeout:
                events.append(("put-timeout", i, clock.now()))
            try:
                got = store.get(i)
                events.append(("get", None if got is None else got.doc_id, clock.now()))
            except faults_mod.StoreTimeout:
                events.append(("get-timeout", i, clock.now()))
        return events, dict(store.stats), dict(inj.injected)

    assert run(faults, storage, JClock()) == run(tfaults, tstorage, TClock())


def test_embedder_and_workload_match(reference):
    _, embedding, *_ = reference
    from repro.core.workload import TABLE1_WORKLOAD, WorkloadGenerator
    from repro_torch.core import embedding as temb
    from repro_torch.core.workload import TABLE1_WORKLOAD as T1
    from repro_torch.core.workload import WorkloadGenerator as TW
    texts = ["how do I sort a list", "the weather in Paris", ""]
    er, et = embedding.FeatureHashEmbedder(), temb.FeatureHashEmbedder()
    for t in texts:
        assert np.array_equal(er.embed(t), et.embed(t))
    a = WorkloadGenerator(TABLE1_WORKLOAD, seed=8).generate(200)
    b = TW(T1, seed=8).generate(200)
    assert [(x.category, x.intent_id, x.timestamp) for x in a] == \
        [(y.category, y.intent_id, y.timestamp) for y in b]
    assert all(np.array_equal(x.embedding, y.embedding) for x, y in zip(a, b))
