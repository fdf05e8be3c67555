"""Device spans of the port's ``TraceRecorder`` on the CPU: a timer driven
by a ``SimClock`` stands in for the card's CUDA events, so the spans'
nesting, their resolution onto the recorder's clock at ``sync_point()``,
the histograms they feed and their place outside the host accounting are
checked exactly; the engine and the cache open them where the card would,
and never touch the recorder or the card's timer without one."""

from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.cache import SemanticCache
from repro_torch.core.clock import SimClock, WallClock
from repro_torch.core.graphs import CapturedProgram
from repro_torch.core.policy import PolicyEngine, paper_policies
from repro_torch.models import Model
from repro_torch.obs import (NULL_SPAN, TraceRecorder, check_span_accounting,
                             coverage_fraction, span_accounting)
from repro_torch.obs.trace import CudaEventTimer
from repro_torch.serving.engine import ServingEngine, generate

EPOCH = 1024.0      # the stand-in card's clock starts elsewhere than the host's


class SimTimer:
    """The card's timer as these tests see it: an event completes at the
    clock's time when it is recorded, read on a device clock of its own
    epoch. Counts its calls."""

    def __init__(self, clock):
        self.clock = clock
        self.calls = 0

    def record(self):
        self.calls += 1
        return self.clock.now() + EPOCH

    def wait(self, ev):
        pass

    def elapsed_ms(self, a, b):
        return (b - a) * 1e3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread while this module runs (many tiny CPU
    ops under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_model():
    cfg = get_config("llama3_2_3b").reduced(n_layers=2, d_model=64, vocab_size=256)
    model = Model(cfg, device="cpu")
    return cfg, model, model.init_params(0)


def _cache(obs=None, index_kind="hnsw"):
    return SemanticCache(PolicyEngine(paper_policies()), capacity=256, clock=SimClock(),
                         index_kind=index_kind, device="cpu", obs=obs)


def _traced_generation(rec, clock):
    """A host root and leaf, a prefill and two decode device spans in the
    leaf, every clock charge inside the leaf; dyadic times, so every sum
    below is exact."""
    with rec.span("engine_step"):
        with rec.span("model_generate", batch=3):
            clock.advance(0.5)
            for stage, ms, attrs in (("prefill", 0.25, {}), ("decode", 0.125, {"step": 1}),
                                     ("decode", 0.0625, {"step": 2})):
                with rec.device_span(stage, "cpu", batch=3, **attrs):
                    clock.advance(ms)
            clock.advance(0.5)
            rec.sync_point()


def test_device_spans_nest_under_the_open_host_span():
    clock = SimClock(2.0)
    rec = TraceRecorder(clock, timer=SimTimer(clock))
    _traced_generation(rec, clock)
    root, gen, *dev = rec.spans
    assert [sp.on for sp in rec.spans] == ["host", "host", "device", "device", "device"]
    assert gen.parent_id == root.span_id
    assert all(sp.parent_id == gen.span_id for sp in dev)
    assert [sp.stage for sp in dev] == ["prefill", "decode", "decode"]
    assert [sp.attrs for sp in dev] == [{"batch": 3}, {"batch": 3, "step": 1},
                                        {"batch": 3, "step": 2}]


def test_device_spans_resolve_exactly_at_the_sync_point():
    clock = SimClock(2.0)
    rec = TraceRecorder(clock, timer=SimTimer(clock))
    with rec.span("search"):
        clock.advance(0.25)
        with rec.device_span("search_device", "cpu", batch=8):
            clock.advance(0.125)
        sp = rec.spans[-1]
        assert sp.dur_ms is None            # pending until the host copy
        clock.advance(0.5)                  # the copy
        rec.sync_point()
    assert (sp.t0, sp.dur_ms) == (2.25, 125.0)
    clock = SimClock(2.0)
    rec = TraceRecorder(clock, timer=SimTimer(clock))
    _traced_generation(rec, clock)
    assert [(sp.t0, sp.dur_ms) for sp in rec.spans[2:]] == \
        [(2.5, 250.0), (2.75, 125.0), (2.875, 62.5)]
    assert isinstance(rec.spans[2].t0, float) and not rec._pending


def test_device_spans_feed_their_stage_histograms():
    clock = SimClock()
    rec = TraceRecorder(clock, timer=SimTimer(clock))
    _traced_generation(rec, clock)
    assert rec.hist.rollup(stage="prefill").count == 1
    dec = rec.hist.rollup(stage="decode")
    assert (dec.count, dec.sum_ms) == (2, 187.5)
    assert {"prefill", "decode", "model_generate", "engine_step"} == set(rec.hist.stages())


def test_accounting_ignores_device_spans():
    """The same host spans with and without device spans under the leaf:
    the same accounting, and it closes exactly under the SimClock."""
    clock = SimClock()
    traced = TraceRecorder(clock, timer=SimTimer(clock))
    _traced_generation(traced, clock)
    clock = SimClock()
    plain = TraceRecorder(clock)
    _traced_generation(plain, clock)        # no timer, a CPU device: NULL_SPAN
    assert [sp.on for sp in plain.spans] == ["host", "host"]
    assert span_accounting(traced) == span_accounting(plain)
    assert span_accounting(traced)["spans"] == 2
    assert check_span_accounting(traced) == []
    assert coverage_fraction(traced) == coverage_fraction(plain) == 1.0
    assert (traced.opened, traced.closed) == (2, 2)


def test_no_timer_no_card_no_span():
    rec = TraceRecorder(SimClock())
    assert rec.device_span("decode", torch.device("cpu")) is NULL_SPAN
    assert rec.device_span("decode", "cpu") is NULL_SPAN
    assert rec.spans == [] and rec.timer is None
    rec.sync_point()                        # nothing pending: nothing recorded


def test_engine_and_cache_open_device_spans_resolved_by_step(small_model, rng):
    cfg, model, params = small_model
    clock = WallClock()
    rec = TraceRecorder(clock, timer=SimTimer(clock))
    eng = ServingEngine(model, params, _cache(rec), max_batch=3, prompt_len=8,
                        max_new_tokens=4, obs=rec)
    for k in range(3):
        eng.submit(f"question number {k}", "code_generation",
                   rng.integers(2, cfg.vocab_size, 8))
    assert len(eng.step()) == 3
    by_id = {sp.span_id: sp for sp in rec.spans}
    dev = [sp for sp in rec.spans if sp.on == "device"]
    assert [(sp.stage, sp.attrs) for sp in dev] == [
        ("search_device", {"batch": 3}), ("prefill", {"batch": 3}),
        ("decode", {"batch": 3, "step": 1}), ("decode", {"batch": 3, "step": 2}),
        ("decode", {"batch": 3, "step": 3})]
    assert all(isinstance(sp.t0, float) and isinstance(sp.dur_ms, float) for sp in rec.spans)
    assert by_id[dev[0].parent_id].stage == "search"
    gen = by_id[dev[1].parent_id]
    assert gen.stage == "model_generate" and all(sp.parent_id == gen.span_id for sp in dev[1:])
    for sp in dev[1:]:                      # inside the generation on the recorder's clock
        assert gen.t0 <= sp.t0 and sp.t0 + sp.dur_ms / 1e3 <= gen.t0 + gen.dur_ms / 1e3
    assert not rec._pending
    write = [sp for sp in rec.spans if sp.stage == "write"]
    assert len(write) == 1 and write[0].attrs["index_add_ms"] >= 0.0


def test_a_capturing_generation_opens_no_span(small_model):
    cfg, model, params = small_model
    clock = SimClock()
    rec = TraceRecorder(clock, timer=SimTimer(clock))
    programs = CapturedProgram("cpu")
    toks = np.full((2, 8), 5, np.int32)
    with mock.patch.object(programs, "ready", return_value=False):
        generate(programs, model, params, {"tokens": toks}, 12, 4, obs=rec)
    assert rec.spans == [] and rec.timer.calls == 0
    generate(programs, model, params, {"tokens": toks}, 12, 4, obs=rec)
    assert [sp.stage for sp in rec.spans] == ["prefill", "decode", "decode", "decode"]


def test_no_recorder_never_calls_the_timer(small_model, rng):
    """Tracing off: generate and lookup_batch make no CUDA event and no
    call into the recorder."""
    cfg, model, params = small_model
    boom = AssertionError("called with tracing off")
    event = mock.Mock(side_effect=boom)
    with mock.patch.object(torch.cuda, "Event", event), \
            mock.patch.object(CudaEventTimer, "record", side_effect=boom), \
            mock.patch.object(TraceRecorder, "device_span", side_effect=boom), \
            mock.patch.object(TraceRecorder, "sync_point", side_effect=boom), \
            mock.patch.object(TraceRecorder, "span", side_effect=boom):
        cache = _cache()
        eng = ServingEngine(model, params, cache, max_batch=2, prompt_len=8,
                            max_new_tokens=3)
        for k in range(2):
            eng.submit(f"an untraced question {k}", "code_generation",
                       rng.integers(2, cfg.vocab_size, 8))
        assert len(eng.step()) == 2
        generate(eng.programs, model, params, {"tokens": np.full((1, 8), 3, np.int32)},
                 11, 3)
        embs = np.stack([eng.embedder.embed(f"an untraced question {k}") for k in range(2)])
        res = cache.lookup_batch(embs, ["code_generation"] * 2)
        assert all(r.hit for r in res)
    assert event.call_count == 0


@pytest.mark.parametrize("index_kind", ["flat", "hnsw"])
def test_write_span_carries_index_add_ms(index_kind, rng):
    """``index_add_ms`` is the recorder clock's time across the index pass
    of ``insert_batch`` alone."""
    clock = SimClock(4.0)
    rec = TraceRecorder(clock)
    cache = _cache(rec, index_kind)
    add = cache.index.add_batch

    def slow_add(*a, **kw):
        clock.advance(0.125)
        return add(*a, **kw)

    cache.index.add_batch = slow_add
    embs = rng.standard_normal((3, 384)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    cache.insert_batch(embs, ["code_generation"] * 3, ["a", "b", "c"], ["x", "y", "z"])
    write = [sp for sp in rec.spans if sp.stage == "write"]
    assert len(write) == 1 and write[0].attrs["index_add_ms"] == 125.0
    assert write[0].dur_ms >= 125.0


@pytest.mark.parametrize("index_kind", ["flat", "hnsw"])
def test_write_span_carries_the_index_pass_work(index_kind, rng):
    """Under hnsw the ``write`` span carries its batch's ``index_expansions``
    and ``index_scored`` (``build_stats`` across the index pass): every
    expanded candidate was scored first, so scored ≥ expansions. A flat
    index wires no graph, and its span carries neither."""
    rec = TraceRecorder(SimClock(4.0))
    cache = _cache(rec, index_kind)
    embs = rng.standard_normal((12, 384)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    for a in (0, 6):
        cache.insert_batch(embs[a:a + 6], ["code_generation"] * 6,
                           [f"q{a + j}" for j in range(6)], ["r"] * 6)
    write = [sp for sp in rec.spans if sp.stage == "write"]
    assert len(write) == 2
    if index_kind == "flat":
        assert all("index_expansions" not in sp.attrs and "index_scored" not in sp.attrs
                   for sp in write)
        return
    for sp in write:
        assert sp.attrs["index_expansions"] > 0
        assert sp.attrs["index_scored"] >= sp.attrs["index_expansions"]
    st = cache.index.build_stats
    assert st["inserts"] == 12
    assert sum(sp.attrs["index_expansions"] for sp in write) == st["expansions"]
    assert sum(sp.attrs["index_scored"] for sp in write) == st["scored"]
