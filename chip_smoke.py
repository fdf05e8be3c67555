#!/usr/bin/env python3
"""Drive repro_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py [--phases build,kernels,index,main,parity]

Run from the root of a checkout: it puts ``src/`` on ``sys.path`` itself,
builds the CUDA kernels into ``build/repro_torch/`` with ``nvcc`` (sm_90a)
and needs one card. It imports nothing of JAX or of the ``repro`` package.
Phases (any failure exits non-zero and prints no result):

1. build   — compile ``src/repro_torch/csrc/*.cu`` (one nvcc per source);
2. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes, fp32 and int8, with times (CUDA events
             around CUDA-graph replays), the plain version's time, the
             bound and the library call's time where one exists;
3. index   — ``HNSWIndex.bulk_build`` of 100,000 Table-1 vectors at
             capacity 131,072: searches of 8, a delta flush, searches again,
             the kernel path against the plain path on the card;
4. main    — ``SemanticCache`` at capacity 1,048,576 for {hnsw, flat} x
             {float32, int8}, serving Table-1 traffic in batches of 8
             (lookup_batch, then insert_batch of the misses); every kernel
             the path uses must have launched;
5. parity  — the same traffic at capacity 16,384, card against CPU: equal
             decisions, except queries within 1e-5 of their τ.

The last lines are a ``{"kernels": [...]}`` object, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
SCORE_ATOL = 1e-5              # fp32 scores: kernel and plain sum in other orders
TAU_BAND = 1e-5                # card/CPU decisions may differ this close to τ
D, HOP_N, FLAT_N, B, F, M = 384, 131_072, 1_048_576, 8, 32, 32


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- timing
def graph_ms(torch, fns, replays: int = 5) -> float:
    """Median device time of one call: the calls in ``fns`` (distinct
    inputs, so repeated calls do not all hit a warm L2) are captured in
    one CUDA graph, which removes the host's launch overhead, and the graph
    is replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(fns))
    del graph
    return statistics.median(times)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b, torch) -> float:
    """Largest |a - b| over finite entries; -inf positions must agree."""
    require(torch.equal(torch.isneginf(a), torch.isneginf(b)),
            "-inf positions differ")
    fin = torch.isfinite(a)
    require(torch.equal(fin, torch.isfinite(b)), "finite positions differ")
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max())


# ---------------------------------------------------------------- phase 2
def unit_rows(torch, gen, n, d, device):
    x = torch.randn((n, d), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def check_kernels(torch, dev) -> dict:
    from repro_torch.core.hnsw import quantize_rows
    from repro_torch.kernels import flat_topk as ft
    from repro_torch.kernels import frontier_hop as fh
    from repro_torch.kernels import gather_scores as gs
    from repro_torch.kernels import scatter_update as su
    from repro_torch.kernels.ref import TOMBSTONE

    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    out = {}

    def quantize(t):
        q, s = quantize_rows(t.cpu().numpy())
        return torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)

    # -- frontier_hop + gather_scores at N=131,072, B=8, F=M=32 ----------
    emb = unit_rows(torch, gen, HOP_N, D, dev)
    emb_q, emb_s = quantize(emb)
    nbrs = torch.randint(0, HOP_N, (HOP_N, M), generator=gen, device=dev,
                         dtype=torch.int32)
    nbrs[torch.rand((HOP_N, M), generator=gen, device=dev) < 0.1] = -1
    valid = torch.rand(HOP_N, generator=gen, device=dev) > 0.1
    cats = torch.randint(0, 7, (HOP_N,), generator=gen, device=dev,
                         dtype=torch.int32)
    meta = torch.where(valid, cats, TOMBSTONE).to(torch.int32)
    variants = []
    for v in range(8):
        fr = torch.randint(0, HOP_N, (B, F), generator=gen, device=dev,
                           dtype=torch.int32)
        fr[:, F - 2:] = -1                              # padded frontier lanes
        q = unit_rows(torch, gen, B, D, dev)
        qc = torch.tensor([-1, 0, 1, 2, 3, 4, 5, 6], dtype=torch.int32, device=dev)
        done = torch.zeros(B, dtype=torch.int32, device=dev)
        if v == 0:
            done[3] = 1                                 # one frozen query
        idx = fr[:, :M].clone()                         # entry-set style ids
        idx[:, -3:] = -1
        variants.append((fr, q, qc, done, idx))

    for dtype, table, scales in (("float32", emb, None),
                                 ("int8", emb_q, emb_s)):
        errs_fh, errs_gs = [], []
        for fr, q, qc, done, idx in variants:
            ids_k, route_k, res_k = fh.frontier_hop(table, nbrs, meta, fr, q, qc,
                                                    done, scales)
            ids_p, route_p, res_p = fh.frontier_hop_plain(table, nbrs, meta, fr, q,
                                                          qc, done, scales)
            torch.cuda.synchronize()
            require(torch.equal(ids_k, ids_p), f"frontier_hop {dtype}: ids differ")
            errs_fh += [max_err(route_k, route_p, torch), max_err(res_k, res_p, torch)]
            g_k = gs.gather_scores(table, idx, q, scales)
            g_p = gs.gather_scores_plain(table, idx, q, scales)
            errs_gs.append(max_err(g_k, g_p, torch))
            # the shared dot: gather_scores on the hop's candidate ids gives
            # the hop's routing scores bit for bit
            g_on_hop = gs.gather_scores(table, ids_k, q, scales)
            require(torch.equal(g_on_hop, route_k),
                    f"gather_scores and frontier_hop differ ({dtype})")
        err_fh, err_gs = max(errs_fh), max(errs_gs)
        require(err_fh <= SCORE_ATOL, f"frontier_hop {dtype}: err {err_fh}")
        require(err_gs <= SCORE_ATOL, f"gather_scores {dtype}: err {err_gs}")
        # This run's data: live lanes of every variant, unique rows read.
        row_b = D * 4 if scales is None else D + 4
        hop_bytes, hop_ops, g_bytes, g_ops = [], [], [], []
        for fr, q, qc, done, idx in variants:
            ids, _, _ = fh.frontier_hop_plain(table, nbrs, meta, fr, q, qc, done, scales)
            live = ids[ids >= 0]
            live_fr = fr[(fr >= 0) & (done[:, None] == 0)]
            hop_bytes.append(live.unique().numel() * (row_b + 4)
                             + live_fr.unique().numel() * M * 4
                             + fr.numel() * 4 + q.numel() * 4 + 2 * B * 4
                             + 3 * ids.numel() * 4)
            hop_ops.append(2 * D * live.numel())
            gl = idx[idx >= 0]
            g_bytes.append(gl.unique().numel() * row_b + idx.numel() * 8
                           + q.numel() * 4)
            g_ops.append(2 * D * gl.numel())
        hop_fns = [lambda v=v: fh.frontier_hop(table, nbrs, meta, v[0], v[1], v[2],
                                               v[3], scales) for v in variants]
        hop_plain = [lambda v=v: fh.frontier_hop_plain(table, nbrs, meta, v[0], v[1],
                                                       v[2], v[3], scales)
                     for v in variants]
        g_fns = [lambda v=v: gs.gather_scores(table, v[4], v[1], scales)
                 for v in variants]
        g_plain = [lambda v=v: gs.gather_scores_plain(table, v[4], v[1], scales)
                   for v in variants]
        b_hop = bound(statistics.mean(hop_bytes), statistics.mean(hop_ops))
        b_g = bound(statistics.mean(g_bytes), statistics.mean(g_ops))
        out[("frontier_hop", dtype)] = dict(
            max_abs_err=err_fh, ms=graph_ms(torch, hop_fns),
            plain_ms=graph_ms(torch, hop_plain), bound_ms=b_hop[0],
            bound_by=b_hop[1], library_ms=None,
            bytes=statistics.mean(hop_bytes))
        out[("gather_scores", dtype)] = dict(
            max_abs_err=err_gs, ms=graph_ms(torch, g_fns),
            plain_ms=graph_ms(torch, g_plain), bound_ms=b_g[0],
            bound_by=b_g[1], library_ms=None, bytes=statistics.mean(g_bytes))
        log(f"kernels: frontier_hop {dtype} {out[('frontier_hop', dtype)]}")
        log(f"kernels: gather_scores {dtype} {out[('gather_scores', dtype)]}")
    del emb, emb_q, emb_s, nbrs, valid, cats, meta, variants
    torch.cuda.empty_cache()

    # -- flat_topk at N=1,048,576, B=8, with categories -----------------
    table = unit_rows(torch, gen, FLAT_N, D, dev)
    tq, ts = quantize(table)
    valid = torch.rand(FLAT_N, generator=gen, device=dev) > 0.1
    cats = torch.randint(0, 7, (FLAT_N,), generator=gen, device=dev,
                         dtype=torch.int32)
    qsets = [(unit_rows(torch, gen, B, D, dev),
              torch.tensor([-1, 0, 1, 2, 3, 4, 5, 99], dtype=torch.int32,
                           device=dev)) for _ in range(2)]
    for dtype, tab, scales in (("float32", table, None), ("int8", tq, ts)):
        errs = []
        for q, qc in qsets:
            s_k, i_k = ft.flat_topk(tab, valid, q, cats, qc, scales)
            s_p, i_p = ft.flat_topk_plain(tab, valid, q, cats, qc, scales)
            torch.cuda.synchronize()
            require(torch.equal(i_k, i_p), f"flat_topk {dtype}: idx {i_k} vs {i_p}")
            require(int(i_k[-1]) == -1, "flat_topk: an unmatched category must give -1")
            errs.append(max_err(s_k, s_p, torch))
            # category-blind scan (no category tables at all)
            s_k, i_k = ft.flat_topk(tab, valid, q, None, None, scales)
            s_p, i_p = ft.flat_topk_plain(tab, valid, q, None, None, scales)
            require(torch.equal(i_k, i_p), f"flat_topk {dtype} unmasked: idx differ")
            errs.append(max_err(s_k, s_p, torch))
        err = max(errs)
        require(err <= SCORE_ATOL, f"flat_topk {dtype}: err {err}")
        row_b = D * 4 if scales is None else D + 4
        q, qc = qsets[0]
        wanted = valid & ((qc[:, None] < 0) | (cats[None, :] == qc[:, None])).any(0)
        per_q = (valid[None, :] & ((qc[:, None] < 0) |
                                   (cats[None, :] == qc[:, None]))).sum()
        nbytes = int(wanted.sum()) * row_b + FLAT_N * 5 + q.numel() * 4 + B * 16
        b_ft = bound(nbytes, 2 * D * int(per_q))
        fns = [lambda q=q, qc=qc: ft.flat_topk(tab, valid, q, cats, qc, scales)
               for q, qc in qsets]
        plain = [lambda q=q, qc=qc: ft.flat_topk_plain(tab, valid, q, cats, qc, scales)
                 for q, qc in qsets]
        out[("flat_topk", dtype)] = dict(
            max_abs_err=err, ms=graph_ms(torch, fns), plain_ms=graph_ms(torch, plain),
            bound_ms=b_ft[0], bound_by=b_ft[1], library_ms=None, bytes=nbytes)
        log(f"kernels: flat_topk {dtype} {out[('flat_topk', dtype)]}")
    del table, tq, ts, valid, cats, qsets
    torch.cuda.empty_cache()

    # -- scatter_rows: R in {8, 64} over every resident table ------------
    tables = {
        "emb_f32": (torch.float32, (HOP_N, D)), "emb_i8": (torch.int8, (HOP_N, D)),
        "scale": (torch.float32, (HOP_N,)), "neighbors": (torch.int32, (HOP_N, M)),
        "valid": (torch.bool, (HOP_N,)), "category": (torch.int32, (HOP_N,)),
        "inserted": (torch.float32, (HOP_N,)),
    }

    def rand_table(dtype, shape):
        if dtype == torch.bool:
            return torch.rand(shape, generator=gen, device=dev) > 0.5
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device=dev)
        return torch.randint(-100, 100, shape, generator=gen, device=dev).to(dtype)

    from repro_torch.kernels import ops
    sc_err, timing = 0.0, {}
    for name, (dtype, shape) in tables.items():
        base = rand_table(dtype, shape)
        for R in (8, 64):
            rows = torch.randperm(HOP_N, generator=gen, device=dev)[:R].to(torch.int32)
            rows[-1] = rows[0]                          # bucketing duplicate
            vals = rand_table(dtype, (R,) + shape[1:])
            vals[-1] = vals[0]
            got = ops.scatter_rows(base.clone(), rows, vals)
            want = su.scatter_rows_plain(base.clone(), rows, vals)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"scatter_rows {name} R={R}: not bit-exact")
            if name == "emb_f32" and R == 64:
                tgt = base.clone()
                vsets = []
                for _ in range(4):
                    r = torch.randperm(HOP_N, generator=gen, device=dev)[:R]
                    vsets.append((r.to(torch.int32), r.long(),
                                  rand_table(dtype, (R,) + shape[1:])))
                row_b = D * 4
                b_sc = bound(2 * R * row_b + R * 4, 0)
                timing = dict(
                    ms=graph_ms(torch, [lambda v=v: su.scatter_rows(tgt, v[0], v[2])
                                        for v in vsets]),
                    plain_ms=graph_ms(torch, [lambda v=v: su.scatter_rows_plain(
                        tgt, v[0], v[2]) for v in vsets]),
                    library_ms=graph_ms(torch, [lambda v=v: tgt.index_copy_(0, v[1], v[2])
                                                for v in vsets]),
                    bound_ms=b_sc[0], bound_by=b_sc[1], bytes=2 * R * row_b + R * 4)
    out[("scatter_rows", "float32")] = dict(max_abs_err=sc_err, **timing)
    log(f"kernels: scatter_rows emb fp32 R=64 {out[('scatter_rows', 'float32')]}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- traffic
def table1_queries(n: int, seed: int):
    from repro_torch.core.workload import TABLE1_WORKLOAD, WorkloadGenerator
    return WorkloadGenerator(TABLE1_WORKLOAD, rate_per_s=30.0, seed=seed).generate(n)


def serve(cache, clock, queries, batch: int):
    """Serve ``queries`` in batches: lookup_batch, then one insert_batch of
    the misses. Returns per-query (hit, reason, score, tau) and the host
    milliseconds of each lookup_batch (which ends in the one device→host
    copy, so the host clock sees the device work)."""
    import numpy as np
    decisions, lookup_ms = [], []
    for s in range(0, len(queries), batch):
        part = queries[s:s + batch]
        clock.advance(max(0.0, part[-1].timestamp - clock.now()))
        emb = np.stack([q.embedding for q in part])
        cats = [q.category for q in part]
        t0 = time.perf_counter()
        res = cache.lookup_batch(emb, cats)
        lookup_ms.append((time.perf_counter() - t0) * 1e3)
        decisions += [(r.hit, r.reason, r.score,
                       cache.policies.effective(c).threshold)
                      for r, c in zip(res, cats)]
        miss = [i for i, r in enumerate(res) if not r.hit and r.reason != "compliance"]
        if miss:
            cache.insert_batch(emb[miss], [cats[i] for i in miss],
                               [part[i].text for i in miss],
                               [f"response:{part[i].text}" for i in miss])
    return decisions, lookup_ms


def make_cache(kind: str, dtype: str, capacity: int, device: str):
    from repro_torch.core.cache import SemanticCache
    from repro_torch.core.clock import SimClock
    from repro_torch.core.policy import PolicyEngine, paper_policies
    clock = SimClock()
    cache = SemanticCache(PolicyEngine(paper_policies()), capacity=capacity,
                          clock=clock, index_kind=kind, use_device=True,
                          emb_dtype=dtype, device=device)
    return cache, clock


def compare_decisions(card, cpu, label: str) -> None:
    """Equal (hit, reason) per query; a query whose score is within
    TAU_BAND of its τ may differ (summation order), and the caches may
    legitimately diverge after it, so the comparison stops there."""
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a[:2] == b[:2]:
            continue
        near = min(abs(a[2] - a[3]), abs(b[2] - b[3])) <= TAU_BAND
        require(near, f"{label}: query {i} decided {a[:2]} on the card, "
                f"{b[:2]} on the CPU (scores {a[2]}, {b[2]}, tau {a[3]})")
        log(f"parity {label}: query {i} within {TAU_BAND} of tau "
            f"(card {a}, cpu {b}); comparison stops here")
        return


# ---------------------------------------------------------------- phase 3
def check_index(torch) -> None:
    import dataclasses

    import numpy as np

    from repro_torch.core.hnsw import (HNSWIndex, index_from_reference, quantize_rows,
                                       reference_state)
    from repro_torch.core.policy import PolicyEngine, paper_policies
    from repro_torch.kernels import scatter_update as su

    t0 = time.perf_counter()
    qs = table1_queries(100_064, seed=5)
    build, probe = qs[:100_000], qs[100_000:]
    pe = PolicyEngine(paper_policies())
    vecs = np.stack([q.embedding for q in build])
    cats = np.array([pe.category_id(q.category) for q in build], np.int32)
    t1 = time.perf_counter()
    fp32 = HNSWIndex.bulk_build(vecs, capacity=131_072, categories=cats,
                                seed=0, device="cuda")
    t2 = time.perf_counter()
    st = reference_state(fp32)
    st["emb_q"], st["emb_scale"] = quantize_rows(st["emb"])
    st["emb_dtype"] = "int8"
    i8 = index_from_reference(st, params=dataclasses.replace(fp32.p, emb_dtype="int8"),
                              device="cuda")
    log(f"index: 100,000 Table-1 vectors generated in {t1 - t0:.1f} s, "
        f"bulk_build {t2 - t1:.1f} s")
    pq = np.stack([q.embedding for q in probe])
    pc = np.array([pe.category_id(q.category) for q in probe], np.int32)
    taus = np.array([pe.effective(q.category).threshold for q in probe], np.float32)
    ttls = np.array([pe.effective(q.category).ttl for q in probe], np.float32)
    rng = np.random.default_rng(3)
    for name, idx in (("float32", fp32), ("int8", i8)):
        for phase in ("before", "after"):
            if phase == "after":
                new = table1_queries(64, seed=9)
                idx.add_batch(np.stack([q.embedding for q in new]),
                              np.array([pe.category_id(q.category) for q in new],
                                       np.int32))
                for slot in rng.choice(100_000, 16, replace=False):
                    idx.remove(int(slot))
                su.scatter_rows.launches = 0
            n_hits = 0
            for s in range(0, len(probe), 8):
                sl = slice(s, s + 8)
                res = idx.search_classified(pq[sl], taus[sl], categories=pc[sl],
                                            ttls=ttls[sl], now=0.0)
                hops = int(idx.last_search["hops"])
                rows = idx.last_search["rows_gathered"].cpu().numpy()
                k_idx, k_score, k_cls, _ = (t.cpu().numpy() for t in res)
                plain = dataclasses.replace(idx.p, hop_impl="reference")
                saved, idx.p = idx.p, plain
                p_res = idx.search_classified(pq[sl], taus[sl], categories=pc[sl],
                                              ttls=ttls[sl], now=0.0)
                idx.p = saved
                p_idx, p_score, p_cls, _ = (t.cpu().numpy() for t in p_res)
                require(k_idx.shape == (8,) and np.isfinite(k_score[k_idx >= 0]).all(),
                        "index: one result per query, finite for every hit")
                for j in range(8):
                    if k_idx[j] >= 0:
                        require(int(idx.category[k_idx[j]]) == pc[sl][j],
                                "index: a hit of another category")
                        exact = float(pq[sl][j] @ idx.emb[k_idx[j]])
                        tol = SCORE_ATOL if name == "float32" else 2e-2
                        require(abs(exact - k_score[j]) <= tol, "index: score off")
                    same = (k_idx[j] == p_idx[j] and k_cls[j] == p_cls[j])
                    near = abs(float(k_score[j]) - float(taus[sl][j])) <= TAU_BAND
                    require(same or near, f"index {name}: kernel path and plain path "
                            f"differ on query {s + j}")
                n_hits += int((k_cls == 2).sum())
            if phase == "after":
                require(idx.sync_stats["delta_updates"] >= 1, "index: no delta flush")
                require(su.scatter_rows.launches > 0, "index: flush did not scatter")
                t = idx.device_tables()
                host = idx._host_tables()
                for k, v in host.items():
                    require(np.array_equal(t[k].cpu().numpy(), v),
                            f"index: device table {k} differs from host after flush")
            log(f"index {name} {phase} flush: {n_hits}/{len(probe)} hits, last hops "
                f"{hops}, rows/query {rows.mean():.0f}, sync {idx.sync_stats}")
    del fp32, i8
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def profile_lookups(torch, cache, queries) -> str:
    """Device time of ``lookup_batch`` under torch.profiler: the summed
    self device time of the kernels against the host wall time of the
    same window (the profiler's own host cost included), and the largest
    kernels by name."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batches = [queries[s:s + 8] for s in range(0, len(queries), 8)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for part in batches:
            cache.lookup_batch(np.stack([q.embedding for q in part]),
                               [q.category for q in part])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        return "device time not measured (the profiler saw no device events)"
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    names = ", ".join(f"{e.key[:48]} {e.self_device_time_total / busy_us:.0%}"
                      for e in top)
    return (f"{len(batches)} lookup_batch calls: device busy {busy_us / len(batches):.1f} "
            f"us/call of {wall_us / len(batches):.1f} us/call wall under the profiler "
            f"(idle share {1 - busy_us / wall_us:.3f}); top kernels: {names}")


def run_main_path(torch, counters, steps: int) -> dict:
    import numpy as np
    launches = {k: 0 for k in counters}
    qs = table1_queries(steps * 8 + 80, seed=1)
    qs, probe = qs[:steps * 8], qs[steps * 8:]
    uses = {"hnsw": ("frontier_hop", "gather_scores", "scatter_rows"),
            "flat": ("flat_topk", "scatter_rows")}
    for kind in ("hnsw", "flat"):
        for dtype in ("float32", "int8"):
            cache, clock = make_cache(kind, dtype, 1_048_576, "cuda")
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            decisions, lookup_ms = serve(cache, clock, qs, 8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in counters.items()}
            for k in counts:
                launches[k] += counts[k]
            for k in uses[kind]:
                require(counts[k] > 0, f"main {kind}/{dtype}: {k} never launched")
            require(all(np.isfinite(d[2]) or not d[0] for d in decisions),
                    "main: a hit without a finite score")
            rates = {c: round(st.hit_rate, 4)
                     for c, st in sorted(cache.metrics.per_category.items())}
            log(f"main {kind}/{dtype}: {len(qs)} queries in {wall:.2f} s; "
                f"lookup_batch ms p50 {np.percentile(lookup_ms, 50):.3f} "
                f"p99 {np.percentile(lookup_ms, 99):.3f}; launches {counts}")
            log(f"main {kind}/{dtype}: hit rates {rates}")
            log(f"main {kind}/{dtype}: sync_stats {cache.sync_stats}")
            log(f"main {kind}/{dtype}: last_lookup_stats {cache.last_lookup_stats}")
            log(f"main {kind}/{dtype}: entries {len(cache)}, device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak")
            log(f"main {kind}/{dtype}: profile: {profile_lookups(torch, cache, probe)}")
            del cache
            torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 5
def check_card_vs_cpu(steps: int) -> None:
    qs = table1_queries(steps * 8, seed=2)
    for kind in ("hnsw", "flat"):
        for dtype in ("float32", "int8"):
            runs = {}
            for dev in ("cuda", "cpu"):
                cache, clock = make_cache(kind, dtype, 16_384, dev)
                runs[dev], _ = serve(cache, clock, qs, 8)
            compare_decisions(runs["cuda"], runs["cpu"], f"{kind}/{dtype}")
            hits = sum(1 for d in runs["cuda"] if d[0])
            log(f"parity {kind}/{dtype}: {len(qs)} queries, {hits} hits, card and "
                f"CPU agree")


# ---------------------------------------------------------------- main
KERNELS = {
    "frontier_hop": ("src/repro_torch/csrc/frontier_hop.cu",
                     "src/repro/kernels/frontier_hop.py:182"),
    "gather_scores": ("src/repro_torch/csrc/gather_scores.cu",
                      "src/repro/kernels/gather_scores.py:96"),
    "flat_topk": ("src/repro_torch/csrc/flat_topk.cu",
                  "src/repro/kernels/flat_topk.py:127"),
    "scatter_rows": ("src/repro_torch/csrc/scatter_rows.cu",
                     "src/repro/kernels/scatter_update.py:66"),
}


PHASES = ("build", "kernels", "index", "main", "parity")


def main(argv: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run (the "
                         "result lines need all of them)")
    phases = set(ap.parse_args(argv).phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phase in {sorted(phases)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.flat_topk import flat_topk
    from repro_torch.kernels.frontier_hop import frontier_hop
    from repro_torch.kernels.gather_scores import gather_scores
    from repro_torch.kernels.scatter_update import scatter_rows
    counters = {"frontier_hop": frontier_hop, "gather_scores": gather_scores,
                "flat_topk": flat_topk, "scatter_rows": scatter_rows}
    dev = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        log(f"build: {lib} in {time.perf_counter() - t0:.1f} s")
        for line in (lib.parent / "build.log").read_text().splitlines():
            if "registers" in line or "rc " in line:
                log(f"build: {line.strip()}")
        if "kernels" in phases:
            t0 = time.perf_counter()
            numbers = check_kernels(torch, dev)
            log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
        if "index" in phases:
            t0 = time.perf_counter()
            check_index(torch)
            log(f"phase index: {time.perf_counter() - t0:.1f} s")
        if "main" in phases:
            t0 = time.perf_counter()
            launches = run_main_path(torch, counters, steps=400)
            log(f"phase main: {time.perf_counter() - t0:.1f} s; launches {launches}")
        if "parity" in phases:
            t0 = time.perf_counter()
            check_card_vs_cpu(steps=50)
            log(f"phase parity: {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    if phases != set(PHASES):
        print("chip_smoke: partial run (--phases); no result", file=sys.stderr)
        return 4

    rows = []
    for name, (source, replaces) in KERNELS.items():
        main_n = numbers[(name, "float32")]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name]}
        row.update({k: main_n[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by", "library_ms")})
        if (name, "int8") in numbers:
            row["int8"] = {k: numbers[(name, "int8")][k]
                           for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}
            row["max_abs_err"] = max(row["max_abs_err"], row["int8"]["max_abs_err"])
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
