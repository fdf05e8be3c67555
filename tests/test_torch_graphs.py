"""repro_torch's captured programs (``core/graphs.py``), on the CPU.

On the card every device search and every generation step is a replayed
CUDA graph; on the CPU the same programs run eagerly on the same static
buffers. These tests hold what the CPU can show: the static-input
plumbing (a captured search gives the eager search function's result for
every batch under one key, and a result outlives the next search), the
persistent entry buffer and the graph key across delta and full syncs,
the launch accounting of warm-ups, captures and replays (with a
stand-in for the CUDA graph), and the restructured generation against the JAX reference.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.cache import SemanticCache as JCache  # noqa: E402
from repro.core.clock import SimClock as JClock  # noqa: E402
from repro.core.policy import PolicyEngine as JPolicies  # noqa: E402
from repro.core.policy import paper_policies as jpaper  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hnsw as th  # noqa: E402
from repro_torch.core.cache import SemanticCache  # noqa: E402
from repro_torch.core.clock import SimClock  # noqa: E402
from repro_torch.core.graphs import CapturedProgram, StaticInputs  # noqa: E402
from repro_torch.core.policy import PolicyEngine, paper_policies  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

DIM = 64


def _unit(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _index(kind, emb_dtype, rng):
    if kind == "hnsw":
        p = th.HNSWParams(M=4, M0=8, ef_construction=16, beam=8, max_hops=5,
                          n_entries=4, emb_dtype=emb_dtype)
        idx = th.HNSWIndex(DIM, 256, params=p, seed=3, device="cpu")
    else:
        idx = th.FlatIndex(DIM, 256, emb_dtype=emb_dtype, device="cpu")
    idx.add_batch(_unit(rng, 80), rng.integers(0, 3, 80).astype(np.int32))
    return idx


def _eager(index, kind, q, taus, cats, ttls, now):
    """The eager search function on the index's device tables and the
    same padded inputs, packed as the captured program packs it."""
    t = index.device_tables()
    _, _, qp, taup, qcp, tp = th._pad_query_batch(q, taus, cats, ttls)
    args = [torch.from_numpy(a) for a in (qp, taup, qcp, tp)]
    now_t = torch.tensor(np.float32(now))
    if kind == "hnsw":
        p = index.p
        idx, score, cls, st = th.beam_search_classified(
            t["emb"], t["neighbors"], t["valid"], t["entries"], t["inserted"],
            args[0], args[1], args[3], now_t, t["category"], args[2], t.get("scale"),
            beam=p.beam, max_hops=p.max_hops, hop_impl=index._resolve_hop_impl())
        return th._pack_result(idx, score, cls, st["cand"], st["hops"],
                               st["rows_gathered"])
    return th._pack_result(*th._flat_search_classified(
        t["emb"], t["valid"], t["category"], t["inserted"], args[0], args[1],
        args[2], args[3], now_t, t.get("scale")))


@pytest.mark.parametrize("kind", ["hnsw", "flat"])
@pytest.mark.parametrize("emb_dtype", ["float32", "int8"])
def test_captured_search_equals_eager_for_every_batch_of_a_key(kind, emb_dtype):
    """Two batches (B 3 and 5) share one key (bucket 8): each search's
    packed result equals the eager function's on its own inputs (a stale
    static input would give the first batch's), and a result still holds
    its values after the next search."""
    rng = np.random.default_rng(5)
    index = _index(kind, emb_dtype, rng)
    kept = []
    for B, now in ((3, 0.5), (5, 2.0)):
        q = _unit(rng, B)
        taus = rng.uniform(0.2, 0.6, B).astype(np.float32)
        cats = rng.integers(-1, 3, B).astype(np.int32)
        ttls = rng.uniform(0.5, 3.0, B).astype(np.float32)
        res = index.search_classified(q, taus, categories=cats, ttls=ttls, now=now)
        ls = index.last_search
        assert torch.equal(ls["words"], _eager(index, kind, q, taus, cats, ttls, now))
        host = index.last_search_host()
        for name, dev in zip(("idx", "score", "cls", "cand"), res):
            assert dev.shape == (B,)
            assert np.array_equal(host[name], dev.numpy())
        assert int(host["hops"]) == int(ls["hops"])
        kept.append((res, [r.clone() for r in res]))
    assert len(index.programs.keys()) == 1
    assert index.programs.replays == {index.programs.keys()[0]: 2}
    assert index.search_stats == {"searches": 2, "compilations": 1}
    res, copy = kept[0]
    assert all(torch.equal(a, b) for a, b in zip(res, copy))


def test_entries_buffer_and_graph_key_change_only_on_a_full_upload():
    """The entry set lives in one persistent buffer, copied into on a
    delta sync (the graphs read it in place) and replaced only by a full
    upload; only then are the programs dropped, and the same key is
    captured anew."""
    rng = np.random.default_rng(8)
    index = _index("hnsw", "float32", rng)
    search = (_unit(rng, 4), np.full(4, 0.4, np.float32))
    index.search_batch(*search)
    entries = index.device_tables()["entries"]
    keys = index.programs.keys()
    for _ in range(3):                      # delta syncs
        index.add_batch(_unit(rng, 2), np.ones(2, np.int32))
        index.remove(int(rng.integers(0, 80)))
        index.search_batch(*search)
        assert index.device_tables()["entries"] is entries
        assert np.array_equal(entries.numpy(), index.entry_set())
        assert index.programs.keys() == keys
    assert index.sync_stats["full_uploads"] == 1
    assert index.sync_stats["delta_updates"] == 3
    index.p.rebuild_threshold = -1.0         # the next sync uploads everything
    index.add_batch(_unit(rng, 1), np.ones(1, np.int32))
    assert index.device_tables()["entries"] is not entries
    assert index.sync_stats["full_uploads"] == 2
    assert index.programs.keys() == []      # dropped with the old tables
    index.search_batch(*search)
    assert index.programs.keys() == keys    # the same key, set up anew
    assert index.programs.replays == {keys[0]: 5}


def test_search_batch_packs_hops_and_rows():
    """``search_batch`` (no classification) keeps hops and rows gathered
    in its packed result; both equal the eager ``beam_search``'s."""
    rng = np.random.default_rng(9)
    index = _index("hnsw", "float32", rng)
    q, taus = _unit(rng, 6), np.full(6, 0.5, np.float32)
    idx, score = index.search_batch(q, taus)
    t = index.device_tables()
    _, _, qp, taup, qcp, _ = th._pad_query_batch(q, taus, None, None)
    e_idx, e_score, st = th.beam_search(
        t["emb"], t["neighbors"], t["valid"], t["entries"], torch.from_numpy(qp),
        torch.from_numpy(taup), t["category"], torch.from_numpy(qcp),
        beam=index.p.beam, max_hops=index.p.max_hops)
    assert torch.equal(idx, e_idx[:6]) and torch.equal(score, e_score[:6])
    assert int(index.last_search["hops"]) == int(st["hops"])
    assert torch.equal(index.last_search["rows_gathered"], st["rows_gathered"][:6])


def test_static_inputs_refuse_another_layout():
    si = StaticInputs([np.zeros((8, 4), np.float32), np.float32(1.0)],
                      torch.device("cpu"))
    assert [v.data_ptr() % 16 for v in si.views] == [0, 0]
    si.fill([np.ones((8, 4), np.float32), np.float32(2.5)])
    assert float(si.views[1]) == 2.5 and float(si.views[0].sum()) == 32.0
    with pytest.raises(ValueError):
        si.fill([np.ones((8, 4), np.float64), np.float32(2.5)])
    with pytest.raises(ValueError):
        si.fill([np.ones((4, 4), np.float32), np.float32(2.5)])


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph``: a replay launches nothing
    through the Python wrappers, as a real replay does."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _kernel(x):
    _build.count(_kernel)                   # as every kernel wrapper counts
    return x + 1


_kernel.launches = _kernel.recorded = 0
_capturing = [False]


@pytest.fixture
def fake_card(monkeypatch):
    """A CPU holder that takes the card's path, the CUDA graph replaced by
    ``_Graph``: the warm-up and the capture call ``fn`` (the capture with
    the stream reported as capturing, so a wrapper records its launch),
    a replay does not."""
    monkeypatch.setattr(CapturedProgram, "graphs", property(lambda self: True))
    monkeypatch.setattr(CapturedProgram, "_warm_up", lambda self, fn, views: fn(*views))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: _capturing[0])

    def record(self, fn, views):
        _capturing[0] = True
        try:
            return _Graph(), fn(*views)
        finally:
            _capturing[0] = False
    monkeypatch.setattr(CapturedProgram, "_record", record)
    _kernel.launches = _kernel.recorded = 0
    return CapturedProgram("cpu", counters=(_kernel,))


def test_launch_accounting_counts_warm_ups_and_replays_not_captures(fake_card):
    """``.launches`` counts the launches that ran at a wrapper call (the
    warm-ups), ``.recorded`` those a capture recorded; the holder keeps
    each capture's recorded launches and counts the replays, and writes
    no counter."""
    holder = fake_card

    def program(x):
        return _kernel(_kernel(x))          # two launches per run

    x = np.arange(4, dtype=np.int32)
    assert not holder.ready("k")
    holder.run("k", program, [x])
    assert holder.ready("k")
    # the warm-up ran 2, the capture recorded 2, the replay called nothing
    assert (_kernel.launches, _kernel.recorded) == (2, 2)
    assert holder.recorded("k") == {_kernel: 2}
    for _ in range(3):
        holder.run("k", program, [x])
    assert (_kernel.launches, _kernel.recorded) == (2, 2)
    assert holder.captures == {"k": 1} and holder.replays == {"k": 4}
    assert holder._programs["k"].graph.replays == 4
    holder.capture("j", lambda x: _kernel(x), [x])     # capture alone: no replay
    assert (_kernel.launches, _kernel.recorded) == (3, 3)
    assert holder.recorded("j") == {_kernel: 1} and holder.recorded("k") == {_kernel: 2}
    assert holder.captures == {"k": 1, "j": 1} and "j" not in holder.replays


def test_a_failed_capture_raises_and_restores_the_counters(fake_card, monkeypatch):
    """A capture that fails raises and leaves no program: ``.launches``
    holds the warm-up's launch only, as before the capture."""
    holder = fake_card

    def record(self, fn, views):
        _capturing[0] = True
        try:
            fn(*views)
        finally:
            _capturing[0] = False
        raise RuntimeError("operation not permitted when stream is capturing")
    monkeypatch.setattr(CapturedProgram, "_record", record)
    with pytest.raises(RuntimeError, match="capturing"):
        holder.run("k", _kernel, [np.zeros(2, np.int32)])
    assert _kernel.launches == 1            # the warm-up's launch only
    assert _kernel.recorded == 1            # the failed capture's
    assert not holder.ready("k") and holder.captures == {} and holder.replays == {}


def _small(**kw):
    return dict(n_layers=2, d_model=64, vocab_size=256, **kw)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "falcon_mamba_7b"])
def test_generate_programs_match_reference_tokens(arch):
    """The prefill and decode programs (run eagerly here, replayed on the
    card) give the reference's jitted ``generate`` tokens for miss batches
    of 1, 3 and 8, with carried-across fp32 weights; a batch size seen
    before runs its programs again (one prefill and 3 decode runs a
    generate of 4 tokens)."""
    jcfg = jget_config(arch).reduced(**_small(dtype="float32"))
    cfg = get_config(arch).reduced(**_small(dtype="float32"))
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.key(3))
    tm = Model(cfg, device="cpu")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jeng = JEngine(jm, jp, JCache(JPolicies(jpaper()), capacity=64, clock=JClock(),
                                  index_kind="flat"),
                   max_batch=8, prompt_len=12, max_new_tokens=4)
    teng = ServingEngine(tm, tp, SemanticCache(PolicyEngine(paper_policies()),
                                               capacity=64, clock=SimClock(),
                                               index_kind="flat", device="cpu"),
                         max_batch=8, prompt_len=12, max_new_tokens=4)
    rng = np.random.default_rng(6)
    for B in (1, 3, 8, 3):
        toks = rng.integers(2, cfg.vocab_size, (B, 12)).astype(np.int32)
        want = np.asarray(jeng._generate(jp, jax.numpy.asarray(toks)))
        got = teng._generate(tp, toks)
        assert got.shape == (B, 4) and got.dtype == np.int32
        assert np.array_equal(got, want), B
    assert teng.programs.replays == {("prefill", 1): 1, ("decode", 1): 3,
                                     ("prefill", 3): 2, ("decode", 3): 6,
                                     ("prefill", 8): 1, ("decode", 8): 3}
