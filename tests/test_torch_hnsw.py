"""repro_torch.core.hnsw against repro.core.hnsw, on the CPU.

State is carried across with ``index_from_reference`` (or built by the
same seeded host control plane in both packages); then both indexes take
the same random add/remove interleaves and searches. Ids, classes,
candidates, hops, per-query rows gathered, sync and search counters must
be identical; scores agree within 1e-5 (fp32, other summation order).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import hnsw as jh  # noqa: E402
from repro_torch.core import hnsw as th  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DIM = 64
ATOL = 1e-5


def _unit(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _small(**kw):
    return dict(M=4, M0=8, ef_construction=16, ef_search=16, beam=8,
                max_hops=5, n_entries=4, **kw)


def _assert_search_parity(r, t, q, taus, cats, ttls, now):
    a = [np.asarray(x) for x in r.search_classified(q, taus, categories=cats,
                                                    ttls=ttls, now=now)]
    b = [x.numpy() for x in t.search_classified(q, taus, categories=cats,
                                                ttls=ttls, now=now)]
    for name, x, y in zip(("idx", "cls", "cand"), (a[0], a[2], a[3]),
                          (b[0], b[2], b[3])):
        assert np.array_equal(x, y), f"{name}: {x} vs {y}"
    assert np.array_equal(np.isneginf(a[1]), np.isneginf(b[1]))
    np.testing.assert_allclose(a[1], b[1], atol=ATOL, rtol=0)
    assert int(r.last_search["hops"]) == int(t.last_search["hops"])
    rows_r = np.asarray(r.last_search["rows_gathered"])
    rows_t = np.asarray(t.last_search["rows_gathered"])
    assert np.array_equal(rows_r, rows_t)
    assert r.sync_stats == t.sync_stats
    assert r.search_stats == t.search_stats
    return a


@pytest.mark.parametrize("kind,hop_impl", [("hnsw", "reference"),
                                           ("hnsw", "fused"), ("flat", None)])
@pytest.mark.parametrize("emb_dtype", ["float32", "int8"])
def test_search_parity_under_random_interleave(kind, hop_impl, emb_dtype):
    """State carried across, then random add_batch/remove interleaves and
    bucketed batches (B in 1..13): identical search results, hops,
    rows_gathered, sync_stats and compile-bucket counts. ``fused`` runs
    the hop through ``ops.frontier_hop``/``ops.hop_scores`` on both sides
    (their plain versions on the CPU)."""
    rng = np.random.default_rng(11)
    if kind == "hnsw":
        r = jh.HNSWIndex(DIM, 256, params=jh.HNSWParams(
            **_small(emb_dtype=emb_dtype, hop_impl=hop_impl)), seed=3)
    else:
        r = jh.FlatIndex(DIM, 256, emb_dtype=emb_dtype)
    live = [int(s) for s in r.add_batch(_unit(rng, 60), rng.integers(0, 3, 60))]
    st = th.reference_state(r)
    t = (th.index_from_reference(st, device="cpu") if kind == "hnsw"
         else th.flat_index_from_reference(st, device="cpu"))
    assert t.device == torch.device("cpu")
    for step in range(10):
        B = int(rng.choice([1, 3, 8, 13]))
        q = _unit(rng, B)
        taus = rng.uniform(0.2, 0.6, B).astype(np.float32)
        cats = rng.integers(-1, 3, B).astype(np.int32)
        ttls = rng.uniform(0.5, 3.0, B)
        now = float(step) * 0.4
        _assert_search_parity(r, t, q, taus, cats, ttls, now)
        if rng.random() < 0.6 or len(live) < 8:
            b = int(rng.integers(1, 6))
            v, c = _unit(rng, b), rng.integers(0, 3, b).astype(np.int32)
            s1, s2 = r.add_batch(v, c), t.add_batch(v, c)
            assert np.array_equal(s1, s2)
            for s in s1:
                r.inserted[s] = t.inserted[s] = now
            live.extend(int(s) for s in s1)
        else:
            for _ in range(int(rng.integers(1, 4))):
                victim = live.pop(int(rng.integers(len(live))))
                r.remove(victim)
                t.remove(victim)
    if kind == "hnsw":
        assert r.entry_point == t.entry_point
        for a, b in zip(r.neighbors, t.neighbors):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("emb_dtype", ["float32", "int8"])
def test_mirror_exact_and_in_place_after_delta_flush(emb_dtype):
    """The device tables are persistent tensors written in place: after a
    delta flush every table equals the host table exactly, and no table
    was reallocated."""
    rng = np.random.default_rng(4)
    t = th.HNSWIndex(DIM, 128, params=th.HNSWParams(**_small(emb_dtype=emb_dtype)),
                     seed=4, device="cpu")
    t.add_batch(_unit(rng, 40), np.zeros(40, np.int32))
    dev = t.device_tables()
    ptrs = {k: v.data_ptr() for k, v in dev.items() if k != "entries"}
    t.add_batch(_unit(rng, 3), np.ones(3, np.int32))
    t.remove(5)
    dev = t.device_tables()
    assert t.sync_stats["full_uploads"] == 1 and t.sync_stats["delta_updates"] == 1
    assert {k: v.data_ptr() for k, v in dev.items() if k != "entries"} == ptrs
    for k, host in t._host_tables().items():
        assert np.array_equal(dev[k].numpy(), host), k
        assert not np.shares_memory(dev[k].numpy(), host)
    assert np.array_equal(dev["entries"].numpy(), t.entry_set())


@pytest.mark.parametrize("fail_after", [0, 2])
def test_failed_delta_flush_drops_mirror_and_reraises(monkeypatch, fail_after):
    rng = np.random.default_rng(7)
    t = th.HNSWIndex(DIM, 128, params=th.HNSWParams(**_small()), seed=7,
                     device="cpu")
    t.add_batch(_unit(rng, 16), np.zeros(16, np.int32))
    t.device_tables()
    t.add_batch(_unit(rng, 2), np.ones(2, np.int32))
    real, calls = ops.scatter_rows, {"n": 0}

    def dying(dst, rows, vals):
        if calls["n"] >= fail_after:
            raise RuntimeError("injected flush fault")
        calls["n"] += 1
        return real(dst, rows, vals)

    monkeypatch.setattr(ops, "scatter_rows", dying)
    with pytest.raises(RuntimeError, match="injected flush fault"):
        t.device_tables()
    assert t._device is None and t._dirty
    monkeypatch.setattr(ops, "scatter_rows", real)
    dev = t.device_tables()
    assert t.sync_stats["full_uploads"] == 2
    for k, host in t._host_tables().items():
        assert np.array_equal(dev[k].numpy(), host)


def test_host_control_plane_draws_the_same_numbers():
    """Incremental insertion and bulk_build are the reference's numpy code:
    the same seed gives the same levels, wiring and entry point, and
    host searches agree exactly."""
    rng = np.random.default_rng(5)
    vecs, cats = _unit(rng, 80), rng.integers(0, 3, 80).astype(np.int32)
    r = jh.HNSWIndex(DIM, 128, params=jh.HNSWParams(**_small()), seed=9)
    t = th.HNSWIndex(DIM, 128, params=th.HNSWParams(**_small()), seed=9,
                     device="cpu")
    assert np.array_equal(r.add_batch(vecs, cats), t.add_batch(vecs, cats))
    assert np.array_equal(r.level, t.level) and r.entry_point == t.entry_point
    for a, b in zip(r.neighbors, t.neighbors):
        assert np.array_equal(a, b)
    q = _unit(rng, 6)
    for x, y in zip(r.search_host(q, 0.3, categories=cats[:6]),
                    t.search_host(q, 0.3, categories=cats[:6])):
        assert np.array_equal(x, y)
    rb = jh.HNSWIndex.bulk_build(_unit(rng, 300), categories=np.arange(300) % 4)
    tb = th.HNSWIndex.bulk_build(np.asarray(rb.emb[:300]),
                                 categories=np.arange(300) % 4, device="cpu")
    assert np.array_equal(rb.neighbors[0], tb.neighbors[0])
    assert np.array_equal(rb.neighbors[1], tb.neighbors[1])
    assert rb.entry_point == tb.entry_point and rb.capacity == tb.capacity


def test_quantize_and_padding_helpers_match(rng):
    v = np.vstack([_unit(rng, 9), np.zeros((1, DIM), np.float32)])
    for a, b in zip(jh.quantize_rows(v), th.quantize_rows(v)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for n in (1, 7, 8, 9, 33, 200):
        assert jh._bucket_batch(n) == th._bucket_batch(n)
    args = (_unit(rng, 5), 0.4, np.arange(5), np.full(5, 3.0))
    for a, b in zip(jh._pad_query_batch(*args), th._pad_query_batch(*args)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_stable_merge_breaks_ties_like_lax_top_k(rng):
    """jax.lax.top_k puts the lower position first among equal scores, and
    the beam's fixpoint test compares positions; ``_top_beam`` (a stable
    descending sort) must pick the same positions on tie-heavy rows."""
    s = rng.integers(0, 4, size=(6, 40)).astype(np.float32)
    s[s == 0] = -np.inf
    want_s, want_p = jax.lax.top_k(jax.numpy.asarray(s), 16)
    got_s, got_p = th._top_beam(torch.from_numpy(s), 16)
    assert np.array_equal(np.asarray(want_p), got_p.numpy())
    assert np.array_equal(np.asarray(want_s), got_s.numpy())


@pytest.mark.parametrize("emb_dtype", ["float32", "int8"])
def test_exact_routing_ties_between_distinct_nodes(emb_dtype):
    """Duplicate rows make exact routing ties between DISTINCT nodes (equal
    bits, different ids), so the merge's order of equal scores decides
    the frontier and the fixpoint test. With the stable merge the port
    walks exactly the reference's hops."""
    rng = np.random.default_rng(21)
    base = _unit(rng, 12)
    vecs = np.repeat(base, 6, axis=0)                # 6 copies of each row
    r = jh.HNSWIndex(DIM, 128, params=jh.HNSWParams(**_small(emb_dtype=emb_dtype)),
                     seed=2)
    r.add_batch(vecs, np.zeros(len(vecs), np.int32))
    t = th.index_from_reference(th.reference_state(r), device="cpu")
    q = (base[:8] + 0.05 * _unit(rng, 8)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _assert_search_parity(r, t, q, np.full(8, 0.999, np.float32),
                          np.zeros(8, np.int32), None, 0.0)
    assert int(t.last_search["hops"]) > 1


def test_classify_is_fp32_at_the_ttl_boundary(rng):
    """TTL classification computes ``now - inserted`` in fp32 like the
    reference; a float64 age would flip decisions at the boundary."""
    n = 512
    now = np.float32(20000.3)
    inserted = rng.uniform(0, 1, n).astype(np.float32)
    # each TTL is the fp32-rounded age: fp32 says "not expired" (age ==
    # ttl), float64 says "expired" wherever the rounding went down
    ttls = (np.float64(now) - inserted.astype(np.float64)).astype(np.float32)
    idx = np.arange(n, dtype=np.int32)
    idx[::7] = -1
    score = np.zeros(n, np.float32)
    want = np.asarray(jh._classify(jax.numpy.asarray(idx), jax.numpy.asarray(score),
                                   jax.numpy.asarray(inserted),
                                   jax.numpy.asarray(ttls), jax.numpy.float32(now)))
    got = th._classify(torch.from_numpy(idx), torch.from_numpy(score),
                       torch.from_numpy(inserted), torch.from_numpy(ttls),
                       torch.tensor(now)).numpy()
    assert np.array_equal(want, got)
    age64 = float(now) - inserted.astype(np.float64)
    flips = (idx >= 0) & ((age64 > ttls) != (got == th.CLS_EXPIRED))
    assert flips.any()      # the fixture really sits on the fp32 boundary


def test_reference_state_round_trip_keeps_rng(rng):
    """Carried state includes the level-draw RNG: later insertions draw
    the same levels and wire identically."""
    r = jh.HNSWIndex(DIM, 128, params=jh.HNSWParams(**_small()), seed=13)
    r.add_batch(_unit(rng, 30))
    t = th.index_from_reference(th.reference_state(r), device="cpu")
    v = _unit(rng, 10)
    assert np.array_equal(r.add_batch(v), t.add_batch(v))
    assert np.array_equal(r.level, t.level)
    assert np.array_equal(r.neighbors[0], t.neighbors[0])
    assert dataclasses.asdict(r.p) == dataclasses.asdict(t.p)
