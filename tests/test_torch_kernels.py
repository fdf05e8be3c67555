"""repro_torch's kernel layer against the JAX reference, on the CPU.

The same numpy-seeded inputs go through ``repro.kernels`` (the jnp oracles
and the Pallas kernels in interpret mode) and through ``repro_torch``'s
plain versions and wrappers, which take the plain path for CPU tensors.
Ids must be equal; fp32 scores agree within 1e-5 (the two sum in other
orders). The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``.
"""

import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flat_topk import flat_topk as pallas_flat_topk  # noqa: E402
from repro.kernels.frontier_hop import frontier_hop as pallas_frontier_hop  # noqa: E402
from repro.kernels.gather_scores import (  # noqa: E402
    gather_scores as pallas_gather_scores,
    gather_scores_masked as pallas_gather_scores_masked)
from repro.kernels.scatter_update import scatter_rows as pallas_scatter_rows  # noqa: E402

from repro_torch.analysis import smem  # noqa: E402
from repro_torch.core.hnsw import quantize_rows  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flat_topk as tft  # noqa: E402
from repro_torch.kernels import frontier_hop as tfh  # noqa: E402
from repro_torch.kernels import gather_scores as tgs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import scatter_update as su  # noqa: E402

ATOL = 1e-5      # fp32 scores, different summation order


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def J(a):
    return jnp.asarray(a)


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL):
    a, b = N(a), N(b)
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _table(rng, N_, d, quant):
    t = _unit_rows(rng, N_, d)
    if not quant:
        return t, None
    return quantize_rows(t)


# ---------------------------------------------------------------- flat_topk
@pytest.mark.parametrize("N_,d,B,block", [
    (1024, 384, 8, 256), (2048, 128, 16, 512), (512, 256, 8, 512),
])
def test_flat_topk_unmasked_parity(rng, N_, d, B, block):
    table = _unit_rows(rng, N_, d)
    valid = rng.random(N_) > 0.2
    q = _unit_rows(rng, B, d)
    rs, ri = jref.flat_topk_ref(J(table), J(valid), J(q))
    ts, ti = ref.flat_topk_ref(T(table), T(valid), T(q))
    _close(ts, rs)
    assert np.array_equal(N(ti), N(ri))
    ks, ki = pallas_flat_topk(J(table), J(valid), J(q), block_n=block,
                              interpret=True)
    ws, wi = ops.cache_topk(T(table), T(valid), T(q), block_n=block)
    _close(ws, ks)
    assert np.array_equal(N(wi), N(ki)) and wi.dtype == torch.int32


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("N_,d,B,block", [(1024, 384, 8, 256), (512, 128, 8, 128)])
def test_flat_topk_masked_parity(rng, N_, d, B, block, quant):
    """Category-masked top-1, fp32 and int8 (scale after the dot): the
    port's oracle against the reference's, and its wrapper against the
    Pallas kernel."""
    table, scales = _table(rng, N_, d, quant)
    valid = rng.random(N_) > 0.2
    cats = rng.integers(0, 4, N_).astype(np.int32)
    q = _unit_rows(rng, B, d)
    qc = rng.integers(-1, 4, B).astype(np.int32)
    js = None if scales is None else J(scales)
    tsc = None if scales is None else T(scales)
    rs, ri = jref.flat_topk_masked_ref(J(table), J(valid), J(q), J(cats), J(qc), js)
    ts, ti = ref.flat_topk_masked_ref(T(table), T(valid), T(q), T(cats), T(qc), tsc)
    _close(ts, rs)
    assert np.array_equal(N(ti), N(ri))
    ks, ki = pallas_flat_topk(J(table), J(valid), J(q), J(cats), J(qc), js,
                              block_n=block, interpret=True)
    ws, wi = tft.flat_topk(T(table), T(valid), T(q), T(cats), T(qc), tsc,
                           block_n=block)
    _close(ws, ks)
    assert np.array_equal(N(wi), N(ki))
    for b in range(B):
        if qc[b] >= 0 and wi[b] >= 0:
            assert cats[int(wi[b])] == qc[b]


@pytest.mark.parametrize("quant", [False, True])
def test_cache_topk_arbitrary_shapes_parity(rng, quant):
    """N=1000 (no tile multiple), B=5: the reference pads and slices back;
    the port takes any shape."""
    table, scales = _table(rng, 1000, 384, quant)
    valid = np.ones(1000, bool)
    cats = (np.arange(1000) % 3).astype(np.int32)
    q = _unit_rows(rng, 5, 384)
    qc = np.array([0, 1, 2, -1, 0], np.int32)
    js = None if scales is None else J(scales)
    tsc = None if scales is None else T(scales)
    rs, ri = jops.cache_topk(J(table), J(valid), J(q), J(cats), J(qc), js,
                             block_n=256, interpret=True)
    ws, wi = ops.cache_topk(T(table), T(valid), T(q), T(cats), T(qc), tsc)
    assert ws.shape == (5,) and wi.shape == (5,)
    _close(ws, rs)
    assert np.array_equal(N(wi), N(ri))


def test_cache_topk_no_match_gives_minus_one(rng):
    """When nothing qualifies the kernel contract is (-inf, -1), as the
    Pallas kernel gives; the argmax oracle alone would say 0."""
    table = _unit_rows(rng, 256, 128)
    valid = rng.random(256) > 0.5
    cats = np.zeros(256, np.int32)
    q = _unit_rows(rng, 8, 128)
    qc = np.array([0, 7, 0, 7, -1, 7, 0, 7], np.int32)     # 7: no such rows
    ks, ki = pallas_flat_topk(J(table), J(valid), J(q), J(cats), J(qc),
                              block_n=64, interpret=True)
    ws, wi = ops.cache_topk(T(table), T(valid), T(q), T(cats), T(qc))
    assert np.array_equal(N(wi), N(ki))
    assert (N(wi)[qc == 7] == -1).all() and np.isneginf(N(ws)[qc == 7]).all()
    _, oracle_i = ref.flat_topk_masked_ref(T(table), T(valid), T(q), T(cats), T(qc))
    assert (N(oracle_i)[qc == 7] == 0).all()
    empty = ops.cache_topk(T(table), T(np.zeros(256, bool)), T(q))
    assert (N(empty[1]) == -1).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_flat_topk_ties_lowest_index_wins(rng, quant, masked):
    """Exact ties across block_n chunks: each query's own direction is
    planted at several rows (the same chunk, the next 32-row group, later
    chunks). The Pallas kernel, the reference oracle, the port's oracle
    and its wrapper all pick the lowest copy; where no row has the query's
    category the kernels say -1 and the argmax oracles 0."""
    N_, d, B, block = 1024, 128, 8, 128
    offsets = np.array([0, 3, 32, 128, 300, 640])
    table = _unit_rows(rng, N_, d)
    valid = rng.random(N_) > 0.2
    cats = rng.integers(0, 4, N_).astype(np.int32)
    q = _unit_rows(rng, B, d)
    qc = np.array([-1, 0, 1, 2, 3, 0, 1, 9], np.int32)      # 9: no such rows
    bases = 11 * np.arange(B) + 1
    for b in range(B):
        rows = bases[b] + offsets
        table[rows] = q[b]
        valid[rows] = True
        cats[rows] = qc[b] if 0 <= qc[b] < 4 else b % 4
    table, scales = quantize_rows(table) if quant else (table, None)
    js = None if scales is None else J(scales)
    tsc = None if scales is None else T(scales)
    if masked:
        kc, kqc = cats, qc
        want = np.where(qc == 9, -1, bases)
    else:
        kc, kqc = np.full(N_, -1, np.int32), np.full(B, -1, np.int32)
        want = bases
    rs, ri = jref.flat_topk_masked_ref(J(table), J(valid), J(q), J(kc), J(kqc), js)
    ts, ti = ref.flat_topk_masked_ref(T(table), T(valid), T(q), T(kc), T(kqc), tsc)
    assert np.array_equal(N(ri), np.maximum(want, 0))
    assert np.array_equal(N(ti), N(ri))
    _close(ts, rs)
    cat_args = (J(cats), J(qc)) if masked else (None, None)
    ks, ki = pallas_flat_topk(J(table), J(valid), J(q), *cat_args, js, block_n=block,
                              interpret=True)
    tcat = (T(cats), T(qc)) if masked else (None, None)
    ws, wi = tft.flat_topk(T(table), T(valid), T(q), *tcat, tsc, block_n=block)
    assert np.array_equal(N(ki), want) and np.array_equal(N(wi), want)
    _close(ws, ks)


def test_category_args_must_travel_together(rng):
    table = T(_unit_rows(rng, 256, 128))
    valid = torch.ones(256, dtype=torch.bool)
    q = T(_unit_rows(rng, 8, 128))
    qc = torch.zeros(8, dtype=torch.int32)
    cats = torch.zeros(256, dtype=torch.int32)
    idx = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tft.flat_topk(table, valid, q, None, qc)
    with pytest.raises(ValueError):
        ops.cache_topk(table, valid, q, cats, None)
    with pytest.raises(ValueError):
        ops.hop_scores(table, idx, q, None, qc)
    with pytest.raises(ValueError):
        ops.hop_scores(table, idx, q, cats, None)


def test_dequantize_parity(rng):
    t, s = quantize_rows(_unit_rows(rng, 64, 128))
    np.testing.assert_array_equal(N(ref.dequantize_ref(T(t), T(s))),
                                  np.asarray(jref.dequantize_ref(J(t), J(s))))
    f = _unit_rows(rng, 8, 16)
    np.testing.assert_array_equal(N(ref.dequantize_ref(T(f), None)), f)


# ------------------------------------------------------------ gather_scores
def _gather_ids(rng, N_, B, K, E):
    """(B, K) int32 ids: uniform in [-1, N) for E = 0; for E > 0 the main
    path's entry-set shape (``core/hnsw.py:beam_search``): E distinct live
    ids broadcast over every query and a tail of -1, here with one id
    repeated inside the row and one query's row all -1."""
    if E == 0:
        return rng.integers(-1, N_, size=(B, K)).astype(np.int32)
    row = np.full(K, -1, dtype=np.int32)
    row[:E] = rng.choice(N_, E, replace=False)
    row[E] = row[0]
    idx = np.tile(row, (B, 1))
    idx[-1] = -1
    return idx


# (N, d, B, K, E): E = 0 random ids, E > 0 the entry-set shape.
GATHER_SHAPES = [pytest.param(256, 128, 4, 8, 0, id="256-128-4-8"),
                 pytest.param(512, 384, 2, 16, 0, id="512-384-2-16"),
                 pytest.param(256, 128, 4, 16, 4, id="entry_set-256-128-4-16-4")]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("N_,d,B,K,E", GATHER_SHAPES)
def test_gather_scores_parity(rng, N_, d, B, K, E, quant):
    table, scales = _table(rng, N_, d, quant)
    idx = _gather_ids(rng, N_, B, K, E)
    q = rng.standard_normal((B, d)).astype(np.float32)
    js = None if scales is None else J(scales)
    tsc = None if scales is None else T(scales)
    want = jref.gather_scores_ref(J(table), J(idx), J(q), js)
    _close(ref.gather_scores_ref(T(table), T(idx), T(q), tsc), want, atol=1e-4)
    kern = pallas_gather_scores(J(table), J(idx), J(q), js, interpret=True)
    got = ops.hop_scores(T(table), T(idx), T(q), scales=tsc)
    _close(got, kern, atol=1e-4)
    assert np.isneginf(N(got)[idx < 0]).all()
    # the wrapper on a CPU tensor is the plain version, bit for bit
    assert torch.equal(tgs.gather_scores(T(table), T(idx), T(q), tsc),
                       tgs.gather_scores_plain(T(table), T(idx), T(q), tsc))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("N_,d,B,K,E", GATHER_SHAPES)
def test_gather_scores_masked_parity(rng, N_, d, B, K, E, quant):
    """The masked variant on the CPU: padding and cross-category candidates
    are -inf, query category -1 is a wildcard."""
    table, scales = _table(rng, N_, d, quant)
    idx = _gather_ids(rng, N_, B, K, E)
    q = rng.standard_normal((B, d)).astype(np.float32)
    cats = rng.integers(0, 3, N_).astype(np.int32)
    qc = rng.integers(-1, 3, B).astype(np.int32)
    js = None if scales is None else J(scales)
    tsc = None if scales is None else T(scales)
    want = jref.gather_scores_masked_ref(J(table), J(idx), J(q), J(cats), J(qc), js)
    _close(ref.gather_scores_masked_ref(T(table), T(idx), T(q), T(cats), T(qc), tsc),
           want, atol=1e-4)
    kern = pallas_gather_scores_masked(J(table), J(idx), J(q), J(cats), J(qc), js,
                                       interpret=True)
    got = ops.hop_scores(T(table), T(idx), T(q), T(cats), T(qc), tsc)
    _close(got, kern, atol=1e-4)
    assert torch.equal(
        tgs.gather_scores_masked(T(table), T(idx), T(q), T(cats), T(qc), tsc),
        tgs.gather_scores_masked_plain(T(table), T(idx), T(q), T(cats), T(qc), tsc))


@pytest.mark.parametrize("quant", [False, True])
def test_gather_scores_masked_wrapper_is_the_plain_version_on_cpu(rng, quant):
    """On a CPU table the masked wrapper is its plain version bit for bit,
    and where the category test passes its scores are gather_scores's bits
    (the CUDA kernel shares the dot, which chip_smoke.py checks on the
    card); everything else is -inf."""
    table, scales = _table(rng, 300, 64, quant)
    tsc = None if scales is None else T(scales)
    idx = T(rng.integers(-1, 300, size=(4, 12)).astype(np.int32))
    q = T(rng.standard_normal((4, 64)).astype(np.float32))
    cats = T(rng.integers(0, 3, 300).astype(np.int32))
    qc = torch.tensor([-1, 0, 1, 2], dtype=torch.int32)
    got = tgs.gather_scores_masked(T(table), idx, q, cats, qc, tsc)
    assert torch.equal(got, tgs.gather_scores_masked_plain(T(table), idx, q, cats, qc, tsc))
    base = tgs.gather_scores(T(table), idx, q, tsc)
    ok = (idx >= 0) & ((qc[:, None] < 0) | (cats[idx.clamp(min=0).long()] == qc[:, None]))
    assert torch.equal(got[ok], base[ok])
    assert bool(torch.isneginf(got[~ok]).all())
    assert torch.equal(got[0], base[0])                 # wildcard query: no mask


# ------------------------------------------------------------ frontier_hop
def _hop_inputs(rng, N_, d, B, F, M):
    emb = rng.standard_normal((N_, d)).astype(np.float32)
    nbrs = rng.integers(-1, N_, size=(N_, M)).astype(np.int32)
    valid = rng.random(N_) > 0.3
    cats = rng.integers(0, 3, N_).astype(np.int32)
    meta = np.where(valid, cats, tfh.TOMBSTONE).astype(np.int32)
    frontier = rng.integers(-1, N_, size=(B, F)).astype(np.int32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    qc = rng.integers(-1, 3, B).astype(np.int32)
    done = (rng.random(B) > 0.6).astype(np.int32)
    return emb, nbrs, meta, frontier, q, qc, done


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("N_,d,B,F,M", [(64, 128, 3, 4, 8), (128, 256, 2, 3, 16)])
def test_frontier_hop_parity(rng, N_, d, B, F, M, quant):
    """One fused hop across tombstones, wildcards and done queries: ids
    equal, routing and result scores within tolerance, against the jnp
    oracle and the Pallas kernel; every ``impl`` of ``ops.frontier_hop``
    agrees on the CPU."""
    emb, nbrs, meta, frontier, q, qc, done = _hop_inputs(rng, N_, d, B, F, M)
    scales = None
    if quant:
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        emb, scales = quantize_rows(emb)
    args = (emb, nbrs, meta, frontier, q, qc, done)
    jargs = tuple(map(J, args)) + (None if scales is None else J(scales),)
    targs = tuple(map(T, args)) + (None if scales is None else T(scales),)
    ri, rr, rs = jref.frontier_hop_ref(*jargs)
    ki, kr, ks = pallas_frontier_hop(*jargs, interpret=True)
    for impl in (None, "ref"):
        ti, tr, ts = ops.frontier_hop(*targs, impl=impl)
        assert ti.dtype == torch.int32 and ti.shape == (B, F * M)
        assert np.array_equal(N(ti), np.asarray(ri))
        assert np.array_equal(N(ti), np.asarray(ki))
        _close(tr, rr, atol=1e-4)
        _close(ts, rs, atol=1e-4)
        _close(tr, kr, atol=1e-4)
        _close(ts, ks, atol=1e-4)
    with pytest.raises(ValueError):
        ops.frontier_hop(*targs, impl="pallas")


def test_frontier_hop_done_query_is_fully_dead(rng):
    emb, nbrs, meta, frontier, q, qc, _ = _hop_inputs(rng, 64, 128, 4, 4, 8)
    frontier = np.abs(frontier)
    done = np.array([1, 0, 1, 0], np.int32)
    ids, route, res = map(N, ops.frontier_hop(*map(T, (emb, nbrs, meta, frontier,
                                                        q, qc, done))))
    for b in range(4):
        if done[b]:
            assert (ids[b] == -1).all()
            assert np.isneginf(route[b]).all() and np.isneginf(res[b]).all()
        else:
            assert (ids[b] >= 0).any()


@pytest.mark.parametrize("N_,d,M,quant", [(64, 388, 8, True), (128, 1024, 64, False)])
def test_frontier_hop_parity_at_staging_edges(rng, N_, d, M, quant):
    """The shapes that take the card kernel's other staging paths (int8
    rows of 388 bytes: 4-byte copies; fp32 d 1,024 with M 64: chunks
    through two buffers) agree with the reference oracle on the CPU."""
    emb, nbrs, meta, frontier, q, qc, done = _hop_inputs(rng, N_, d, 2, 3, M)
    scales = None
    if quant:
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        emb, scales = quantize_rows(emb)
    args = (emb, nbrs, meta, frontier, q, qc, done)
    ri, rr, rs = jref.frontier_hop_ref(*map(J, args), None if scales is None else J(scales))
    ti, tr, ts = ops.frontier_hop(*map(T, args), None if scales is None else T(scales))
    assert np.array_equal(N(ti), np.asarray(ri))
    _close(tr, rr, atol=1e-4)
    _close(ts, rs, atol=1e-4)


@pytest.mark.parametrize("d,M,itemsize,copy,chunks", [
    (384, 32, 4, "bulk", 1), (384, 32, 1, "bulk", 1), (388, 32, 1, "word", 1),
    (1024, 64, 4, "bulk", 11), (12288, 32, 4, "bulk", 32)])
def test_stage_plan(d, M, itemsize, copy, chunks):
    """The card kernel's staging plan: one bulk stage at the main path's
    shape (fp32 d 384, M 32: 48 KB of rows and 1.5 KB of query, four blocks
    an SM), 4-byte copies for int8 rows that are not 16-byte multiples,
    chunks through two buffers where M rows exceed the budget, and every
    plan within a block's shared memory."""
    plan = tfh._stage_plan(d, M, itemsize)
    assert (plan["copy"], plan["chunks"]) == (copy, chunks)
    assert plan["slot_bytes"] % 16 == 0 and plan["slot_bytes"] >= d * itemsize
    assert plan["chunk"] * (plan["chunks"] - 1) < M <= plan["chunk"] * plan["chunks"]
    assert plan["smem_bytes"] <= tfh.SMEM_LIMIT
    if chunks == 1:
        assert plan["chunk"] == M
    if (d, M, itemsize) == (384, 32, 4):    # four blocks an SM, 1 KB reserved each
        assert 4 * (plan["smem_bytes"] + 1024) <= 233_472


# ---------------------------------------------------------- scatter_update
@pytest.mark.parametrize("N_,d,R", [(64, 128, 8), (256, 384, 32), (128, 32, 5)])
def test_scatter_rows_parity(rng, N_, d, R):
    """The delta flush writes in place: the same tensor comes back, the
    scattered rows hold the values, every other row is untouched, and
    the result equals the reference's scatter and Pallas kernel."""
    table = rng.standard_normal((N_, d)).astype(np.float32)
    rows = rng.choice(N_, R, replace=False).astype(np.int32)
    vals = rng.standard_normal((R, d)).astype(np.float32)
    want = np.asarray(jref.scatter_rows_ref(J(table), J(rows), J(vals)))
    kern = np.asarray(pallas_scatter_rows(J(table), J(rows), J(vals), interpret=True))
    np.testing.assert_array_equal(N(ref.scatter_rows_ref(T(table), T(rows), T(vals))),
                                  want)
    t = T(table.copy())
    ptr = t.data_ptr()
    out = ops.scatter_rows(t, T(rows), T(vals))
    assert out is t and out.data_ptr() == ptr
    np.testing.assert_array_equal(N(out), want)
    np.testing.assert_array_equal(N(out), kern)
    untouched = np.setdiff1d(np.arange(N_), rows)
    np.testing.assert_array_equal(N(out)[untouched], table[untouched])


def test_scatter_rows_duplicate_ids_identical_payload(rng):
    table = rng.standard_normal((32, 128)).astype(np.float32)
    vals = rng.standard_normal((2, 128)).astype(np.float32)
    rows = np.array([7, 7, 7, 3], np.int32)
    vals4 = np.stack([vals[0], vals[0], vals[0], vals[1]])
    out = N(ops.scatter_rows(T(table.copy()), T(rows), T(vals4)))
    np.testing.assert_array_equal(out[7], vals[0])
    np.testing.assert_array_equal(out[3], vals[1])


@pytest.mark.parametrize("dtype", [np.int32, np.bool_, np.float32, np.int8])
def test_ops_scatter_rows_1d_tables(rng, dtype):
    """1-D flag/metadata tables go through an (N, 1) column view, in place,
    keeping their dtype — the reference's ops wrapper gives the same."""
    table = (rng.random(64) * 100).astype(dtype)
    rows = np.array([3, 9, 40], np.int32)
    vals = (rng.random(3) * 100).astype(dtype)
    want = np.asarray(jops.scatter_rows(J(table), J(rows), J(vals)))
    t = T(table.copy())
    out = ops.scatter_rows(t, T(rows), T(vals))
    assert out is t and out.dtype == t.dtype
    np.testing.assert_array_equal(N(out), want)


def _resident_tables(rng, kind, quant, N_=256, d=128, M0=16):
    """Host tables as an index holds them: the embedding tier (fp32 rows,
    or int8 rows and their scales), the level-0 neighbors (hnsw only), and
    the valid/category/inserted columns."""
    emb = _unit_rows(rng, N_, d)
    tabs = {"emb": emb} if not quant else dict(zip(("emb", "scale"), quantize_rows(emb)))
    if kind == "hnsw":
        tabs["neighbors"] = rng.integers(-1, N_, (N_, M0)).astype(np.int32)
    tabs["valid"] = rng.random(N_) > 0.5
    tabs["category"] = rng.integers(-1, 7, N_).astype(np.int32)
    tabs["inserted"] = rng.random(N_).astype(np.float32)
    return tabs


@pytest.mark.parametrize("R", [8, 64])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kind", ["hnsw", "flat"])
def test_scatter_flush_matches_per_table_scatter(rng, kind, quant, R):
    """One flush of every resident table from one packed buffer (row ids,
    then each table's rows, every segment on a 16-byte boundary, the
    bucketing duplicate included) equals ``scatter_rows_plain`` table by
    table and the reference's Pallas ``scatter_rows`` (interpret mode)."""
    host = _resident_tables(rng, kind, quant)
    N_ = host["emb"].shape[0]
    rows = rng.choice(N_, R, replace=False).astype(np.int32)
    rows[-1] = rows[0]
    vals = {k: v[:R].copy() for k, v in _resident_tables(rng, kind, quant).items()}
    for v in vals.values():
        v[-1] = v[0]
    packed = ops.pack_flush(rows, list(vals.values()))
    offsets, total = su.flush_layout([v[0].nbytes for v in vals.values()], R)
    assert packed.dtype == np.uint8 and packed.shape == (total,)
    assert all(off % 16 == 0 for off in offsets)
    tables = {k: T(t.copy()) for k, t in host.items()}
    ops.scatter_flush(list(tables.values()), T(packed), R)
    for k, t in host.items():
        want = su.scatter_rows_plain(T(t.copy()), T(rows), T(vals[k]))
        np.testing.assert_array_equal(N(tables[k]), N(want), err_msg=k)
        col = (lambda a: a[:, None]) if t.ndim == 1 else (lambda a: a)
        kern = np.asarray(pallas_scatter_rows(J(col(t)), J(rows), J(col(vals[k])),
                                              interpret=True))
        np.testing.assert_array_equal(N(tables[k]), kern.reshape(t.shape), err_msg=k)


# ------------------------------------------------- off-CPU tensors: no fallback
def test_wrappers_raise_off_cpu_instead_of_falling_back():
    """A tensor that is not on the CPU never takes the plain version: a
    wrapper launches its CUDA kernel or raises. Meta tensors stand in
    for a device here, and every wrapper refuses them."""
    meta = torch.device("meta")
    table = torch.empty((16, 8), device=meta)
    q = torch.empty((2, 8), device=meta)
    idx = torch.empty((2, 4), dtype=torch.int32, device=meta)
    i32 = torch.empty((2,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        tgs.gather_scores(table, idx, q)
    with pytest.raises(ValueError):
        tft.flat_topk(table, torch.empty(16, dtype=torch.bool, device=meta), q)
    with pytest.raises(ValueError):
        tfh.frontier_hop(table, torch.empty((16, 4), dtype=torch.int32, device=meta),
                         torch.empty(16, dtype=torch.int32, device=meta), idx, q,
                         i32, i32)
    with pytest.raises(ValueError):
        ops.scatter_rows(table, torch.zeros(2, dtype=torch.int32),
                         torch.empty((2, 8), device=meta))
    with pytest.raises(ValueError):
        ops.scatter_flush([table], torch.zeros(128, dtype=torch.uint8), 2)
    with pytest.raises(ValueError):
        su.scatter_flush([torch.zeros((16, 8))],
                         torch.empty(128, dtype=torch.uint8, device=meta), 2)
    with pytest.raises(ValueError):
        ops.hop_scores(table, idx, q, torch.empty(16, dtype=torch.int32, device=meta),
                       i32)
    with pytest.raises(ValueError):
        tgs.gather_scores_masked(table, idx, q,
                                 torch.empty(16, dtype=torch.int32, device=meta), i32)


# ------------------------------------------- the kernel tables against csrc/
def _csrc_entries(pattern: str) -> set[str]:
    """Names ``pattern`` (one group) finds in ``csrc/*.cu`` once comments,
    template heads, ``__launch_bounds__`` and ``__cluster_dims__`` are
    taken out."""
    names = set()
    for path in sorted(_build.CSRC.glob("*.cu")):
        src = re.sub(r"/\*.*?\*/|//[^\n]*", "", path.read_text(), flags=re.S)
        src = re.sub(r"template\s*<[^<>]*>|__(launch_bounds|cluster_dims)__\s*\([^()]*\)",
                     " ", src)
        names.update(re.findall(pattern, src))
    return names


@pytest.mark.parametrize("table,pattern", [
    ("SIGNATURES", r'extern\s+"C"\s+int\s+(\w+)\s*\('),
    ("MAX_THREADS", r"__global__\s+void\s+(\w+)\s*\("),
])
def test_kernel_tables_name_exactly_the_sources_entries(table, pattern):
    """``_build.SIGNATURES`` holds one signature for each C entry the
    library defines, and ``smem.MAX_THREADS`` one block size for each
    kernel: no entry is missing, and none names code that is gone."""
    entries = _csrc_entries(pattern)
    keys = set(_build.SIGNATURES if table == "SIGNATURES" else smem.MAX_THREADS)
    assert entries, f"no entries parsed for {table}"
    assert keys == entries, (f"{table} only: {sorted(keys - entries)}; "
                             f"csrc only: {sorted(entries - keys)}")
