#!/usr/bin/env python3
"""Drive repro_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py [--phases build,kernels,index,main,parity,serve]

Run from the root of a checkout: it puts ``src/`` on ``sys.path`` itself,
builds the CUDA kernels into ``build/repro_torch/`` with ``nvcc`` (sm_90a)
and needs one card. It imports nothing of JAX or of the ``repro`` package.
Phases (any failure exits non-zero and prints no result):

1. build   — compile ``src/repro_torch/csrc/*.cu`` (one nvcc per source);
2. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes: the cache kernels in fp32 and int8
             (frontier_hop also with every query done, with one live
             candidate beside an empty neighbor row, at int8 d 388 (4-byte
             copies) and at d 1,024 with M 64 (chunks through two
             buffers), each also held bit for bit against gather_scores on
             its candidate ids; gather_scores and gather_scores_masked
             at (a) random ids, (b) the main path's entry set (8 ids from
             the first 3,000 rows, the same for all 8 queries, padded to
             32 with INVALID) and (c) every id INVALID (the no-row
             floor), each bit for bit and timed beside (d) the earlier
             design (``gather_scores_serial``) on the same inputs, and
             held at int8 d 388 and at d 1,024 with B 40 (three
             query groups); scatter_rows as one flush launch over the
             hnsw fp32 and int8 table sets at R 8 and 64, timed beside one
             launch per table; flat_topk also at the main path's occupancy, a 3,000-row
             valid prefix of 1,048,576, and with exact ties across groups,
             warps, blocks and chunks, the lowest index held equal, at d
             384 and at 128, 256, 512, 1,024 and 12,288 on 4,096 rows), the
             attention kernels in fp32 and bf16 at the serve shape and at a
             long one (prefill 4,096; decode 32,768, and decode 32,768 with
             gemma2's window of 4,096), mamba_scan with fp32 and bf16 x at
             N 16 and 8: falcon-mamba-7b's serve prefill (8 × 64 × 8192),
             its decode step (L 1, the state read from h0 and written back
             over it in place, held bit for bit against a separate h_out)
             and a long scan (1 × 4,096), and a ragged L and Dm (77 × 1,000,
             held, not timed), with times (CUDA events around CUDA-graph
             replays), the plain version's time, the bound (mamba_scan's
             log lines also its exps' SFU floor) and the library call's
             time where one exists;
3. index   — ``HNSWIndex.bulk_build`` of 100,000 Table-1 vectors at
             capacity 131,072: searches of 8, a delta flush, searches again,
             the kernel path against the plain path on the card;
4. main    — ``SemanticCache`` at capacity 1,048,576 for {hnsw, flat} x
             {float32, int8}, serving Table-1 traffic in batches of 8
             (lookup_batch, then insert_batch of the misses). Each search
             replays the index's CUDA graph of its batch bucket
             (``core/graphs.py``; the log's "graphs:" line gives the
             captures, replays and compilations). Launches are counted
             where they are made: a wrapper counts the launches that run
             at its call (a capture's warm-up, an eager call) and records
             those a capture records; the holder keeps each capture's
             recorded launches and counts the replays. Both are exact:
             frontier_hop max_hops times and gather_scores once per warm-up
             and per search, flat_topk once, scatter_rows once per delta
             flush (eager, between replays). Then 80 probe queries: the
             graph's packed result (idx, score, cls, cand, hops, rows)
             equals bit for bit the eager ``beam_search_classified`` /
             ``_flat_search_classified`` on the same padded inputs and
             device tables; and in a profiled window of 10 lookups the
             port's kernels, counted by name in the trace, are exactly what
             the replayed graphs recorded;
5. parity  — the same traffic at capacity 16,384, card against CPU: equal
             decisions, except queries within 1e-5 of their τ;
6. serve   — ``launch.serve.run_serving``: 256 Table-1 requests through
             the cache (hnsw, fp32, device search) in front of
             llama3.2-3b at full width and depth (seeded random bf16
             weights), batch 8, prompt 64, 16 new tokens. Generation
             replays a prefill graph and 15 times a decode graph per
             miss-batch size (``serving/engine.py``), timed by CUDA events
             around the replays. The first replay of every graph runs under
             the profiler: its trace holds exactly the port's kernels its
             capture recorded. flash_attention and decode_attention must
             have launched 28 times per warm-up and per replay of a
             prefill and a decode graph. Then the same run in
             front of falcon-mamba-7b at full width and depth (64 Mamba
             layers, d_inner 8192): mamba_scan 64 times per prefill and
             decode step, and the served, hit and model-token counters
             must equal llama's (hits depend only on the text). For each
             model the graphs' tokens for a batch of 8 and one of 3 must
             equal the eager prefill/decode_step loop's. Then each model
             at full width and 2 layers: decode against prefill, and card
             against CPU.

The last lines are a ``{"kernels": [...]}`` object (``launches``: those
made at wrapper calls in the run of the kernel's path; ``replay_launches``:
those its graphs' replays made, each graph's recorded launches times its
replays), the card's name and power limit from nvidia-smi, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
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
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
SCORE_ATOL = 1e-5              # fp32 scores: kernel and plain sum in other orders
SCAN_ATOL = 1e-4               # fp32 scan (values O(1)): N-sums in another order,
                               # exp within 2 ulp, carried over up to 4,096 steps
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
def graph_ms(torch, fns, replays: int = 15, window_ms: float = 2.0) -> float:
    """Median device time of one call. The calls in ``fns`` (distinct
    inputs, so repeated calls do not all hit a warm L2) are captured in one
    CUDA graph, which removes the host's launch overhead, repeated until
    one replay lasts about ``window_ms`` (µs-scale kernels are timed over
    hundreds of calls, not a few), and the graph is replayed ``replays``
    times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    def capture(reps):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                for fn in fns:
                    fn()
        graph.replay()
        torch.cuda.synchronize()
        return graph

    def replay_ms(graph):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    graph = capture(1)
    once = replay_ms(graph)
    reps = max(1, min(256, int(window_ms / max(once, 1e-4))))
    if reps > 1:
        del graph
        graph = capture(reps)
    times = [replay_ms(graph) / (reps * len(fns)) for _ in range(replays)]
    del graph
    return statistics.median(times)


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


SPARSE_ROWS = 3_000            # the main path's occupancy (its cache stays below it)
N_ENTRIES = 8                  # HNSWParams.n_entries: the search's entry set
TIE_N = 65_536
# Where each query's planted duplicates sit past its base row: the same
# 32-row group, the next groups (other warps and blocks), the next chunk
# of 1,024 rows, and rows 8,192 and 32,768 further on.
TIE_OFFSETS = (0, 5, 31, 32, 160, 1_024, 8_192, 32_768)
# Every other width's kernel (the shared-memory kernel below d = 384, the
# slice walk above it), held on 4,096 rows with ties 512 and 1,024 rows on
# (the same warp's next flag loads).
TIE_WIDTHS = (128, 256, 512, 1_024, 12_288)
TIE_WIDE = (4_096, (0, 5, 31, 32, 160, 512, 1_024), 97)


def time_flat_topk(torch, ft, tab, valid, cats, qsets, scales, err) -> dict:
    """flat_topk's numbers on one table and valid mask: kernel and plain
    times over ``qsets``, and the bound from this data (every valid flag,
    the category of each valid row, once each row that a query of the
    batch wants, the queries and the outputs; 2·d operations per
    (row, query) pair that qualifies)."""
    row_b = D * 4 if scales is None else D + 4
    q, qc = qsets[0]
    ok = valid[None, :] & ((qc[:, None] < 0) | (cats[None, :] == qc[:, None]))
    nbytes = (int(ok.any(0).sum()) * row_b + FLAT_N + 4 * int(valid.sum())
              + q.numel() * 4 + B * 16)
    b_ft = bound(nbytes, 2 * D * int(ok.sum()))
    fns = [lambda q=q, qc=qc: ft.flat_topk(tab, valid, q, cats, qc, scales)
           for q, qc in qsets]
    plain = [lambda q=q, qc=qc: ft.flat_topk_plain(tab, valid, q, cats, qc, scales)
             for q, qc in qsets]
    return dict(max_abs_err=err, ms=graph_ms(torch, fns), plain_ms=graph_ms(torch, plain),
                bound_ms=b_ft[0], bound_by=b_ft[1], library_ms=None, bytes=nbytes)


def flat_topk_ties(torch, ft, gen, dev, quantize, d=D, n=TIE_N, offsets=TIE_OFFSETS,
                   stride=977) -> None:
    """Exact ties on n rows of width d: every query's own direction is
    planted at ``offsets`` past a base row of its own (valid, of its
    category), so each query ties with itself across groups, warps,
    blocks and chunks. The index must equal the plain version's, the
    lowest of the copies; the query of a category no row has gets -1."""
    table = unit_rows(torch, gen, n, d, dev)
    valid = torch.rand(n, generator=gen, device=dev) > 0.1
    cats = torch.randint(0, 7, (n,), generator=gen, device=dev, dtype=torch.int32)
    q = unit_rows(torch, gen, B, d, dev)
    qc = torch.tensor([-1, 0, 1, 2, 3, 4, 5, 99], dtype=torch.int32, device=dev)
    bases = [stride * b + 3 for b in range(B)]
    for b, base in enumerate(bases):
        rows = torch.tensor([base + o for o in offsets], device=dev)
        table[rows] = q[b]
        valid[rows] = True
        cats[rows] = int(qc[b]) if 0 <= int(qc[b]) < 7 else b % 7
    tq, ts = quantize(table)
    want = torch.tensor(bases[:-1] + [-1], dtype=torch.int32, device=dev)
    for dtype, tab, scales in (("float32", table, None), ("int8", tq, ts)):
        for c, qcat, expect in ((cats, qc, want),
                                (None, None, torch.tensor(bases, dtype=torch.int32,
                                                          device=dev))):
            s_k, i_k = ft.flat_topk(tab, valid, q, c, qcat, scales)
            s_p, i_p = ft.flat_topk_plain(tab, valid, q, c, qcat, scales)
            torch.cuda.synchronize()
            require(torch.equal(i_k, i_p) and torch.equal(i_k, expect),
                    f"flat_topk {dtype} d={d} ties: idx {i_k.tolist()}, plain "
                    f"{i_p.tolist()}, lowest copies {expect.tolist()}")
            err = max_err(s_k, s_p, torch)
            require(err <= SCORE_ATOL, f"flat_topk {dtype} d={d} ties: err {err}")
    log(f"kernels: flat_topk d={d} ties at offsets {offsets} of {n} rows, fp32 and "
        f"int8, masked and unmasked: lowest index held")


def hold_hop(torch, fh, gs, table, nbrs, meta, variant, scales, what: str) -> float:
    """One frontier_hop call against its plain version (ids equal, scores
    within SCORE_ATOL) and against gather_scores on its own candidate ids
    (the shared dot: routing scores bit for bit). Returns the largest
    score error."""
    fr, q, qc, done = variant[:4]
    ids_k, route_k, res_k = fh.frontier_hop(table, nbrs, meta, fr, q, qc, done, scales)
    ids_p, route_p, res_p = fh.frontier_hop_plain(table, nbrs, meta, fr, q, qc, done,
                                                  scales)
    torch.cuda.synchronize()
    require(torch.equal(ids_k, ids_p), f"frontier_hop {what}: ids differ")
    err = max(max_err(route_k, route_p, torch), max_err(res_k, res_p, torch))
    require(err <= SCORE_ATOL, f"frontier_hop {what}: err {err}")
    require(torch.equal(gs.gather_scores(table, ids_k, q, scales), route_k),
            f"gather_scores and frontier_hop differ ({what})")
    earlier = fh.frontier_hop_serial(table, nbrs, meta, fr, q, qc, done, scales)
    require(all(torch.equal(x, y) for x, y in zip(earlier, (ids_k, route_k, res_k))),
            f"frontier_hop and its earlier design differ ({what})")
    return err


def time_hop(torch, fh, table, nbrs, meta, variants, scales, err) -> dict:
    """frontier_hop's numbers over ``variants``: kernel, earlier design
    (``frontier_hop_serial``) and plain times, and the bound from this
    data (each unique live candidate row and its meta word, the neighbor
    rows of live frontier lanes, the frontier, queries, categories, done
    flags and the three outputs; 2·d operations per live candidate).
    ``gather_ms``, for the log only, is one ``index_select`` of the same
    live candidate rows: what PyTorch's own gather of the rows the hop
    must read costs (it also writes them out)."""
    d, M = table.shape[1], nbrs.shape[1]
    row_b = d * 4 if scales is None else d + 4
    nbytes, ops, rows = [], [], []
    for fr, q, qc, done in (v[:4] for v in variants):
        ids, _, _ = fh.frontier_hop_plain(table, nbrs, meta, fr, q, qc, done, scales)
        live = ids[ids >= 0]
        rows.append(live.long())
        live_fr = fr[(fr >= 0) & (done[:, None] == 0)]
        nbytes.append(live.unique().numel() * (row_b + 4) + live_fr.unique().numel() * M * 4
                      + fr.numel() * 4 + q.numel() * 4 + 2 * q.shape[0] * 4
                      + 3 * ids.numel() * 4)
        ops.append(2 * d * live.numel())
    b_hop = bound(statistics.mean(nbytes), statistics.mean(ops))
    fns = [lambda v=v: fh.frontier_hop(table, nbrs, meta, *v[:4], scales) for v in variants]
    plain = [lambda v=v: fh.frontier_hop_plain(table, nbrs, meta, *v[:4], scales)
             for v in variants]
    earlier = [lambda v=v: fh.frontier_hop_serial(table, nbrs, meta, *v[:4], scales)
               for v in variants]
    return dict(max_abs_err=err, ms=graph_ms(torch, fns), earlier_ms=graph_ms(torch, earlier),
                plain_ms=graph_ms(torch, plain),
                bound_ms=b_hop[0], bound_by=b_hop[1], library_ms=None,
                bytes=statistics.mean(nbytes),
                gather_ms=graph_ms(torch, [lambda r=r: table.index_select(0, r)
                                           for r in rows]))


def hop_dead_lanes(torch, fh, gs, table, nbrs, meta, variants, scales, dtype) -> None:
    """The mbarrier byte counts at their edges, on the main path's table:
    every query done (no block loads a row), and one live candidate in the
    whole hop beside a live frontier lane whose neighbors are all INVALID
    (a stage of zero bytes)."""
    fr, q, qc, done, _ = variants[0]
    dead = (fr, q, qc, torch.ones_like(done))
    hold_hop(torch, fh, gs, table, nbrs, meta, dead, scales, f"{dtype} all queries done")
    one, empty = int(fr[0, 0]), int(fr[1, 0])
    nb = nbrs.clone()
    nb[one] = -1
    nb[one, 5] = int(nbrs[one].clamp(min=0).max())
    nb[empty] = -1
    lanes = torch.full_like(fr, -1)
    lanes[0, 0], lanes[1, 3] = one, empty
    hold_hop(torch, fh, gs, table, nb, meta, (lanes, q, qc, torch.zeros_like(done)), scales,
             f"{dtype} one live candidate")
    dead_ms = graph_ms(torch, [lambda: fh.frontier_hop(table, nbrs, meta, *dead, scales)])
    log(f"kernels: frontier_hop {dtype}: all queries done, and one live candidate beside "
        f"an empty neighbor row: held; all done (no row loaded) {dead_ms:.6f} ms")


# Shapes that take the hop kernel's other staging paths: (label, N, d, M, F,
# int8). int8 d 388 rows are not 16-byte multiples (4-byte copies); d 1,024
# with M 64 walks 11 chunks (fp32) or 3 (int8) through two buffers.
HOP_STAGING = (("int8_d388", 16_384, 388, 32, 32, True),
               ("float32_d1024_m64", 16_384, 1_024, 64, 8, False),
               ("int8_d1024_m64", 16_384, 1_024, 64, 8, True))


def hop_staging_paths(torch, fh, gs, gen, dev, quantize) -> dict:
    """frontier_hop on HOP_STAGING's shapes (frontier lanes padded, one
    query done, tombstones and categories as on the main path): held
    against its plain version and gather_scores, and timed."""
    from repro_torch.kernels.ref import TOMBSTONE
    out = {}
    for label, n, d, m, f, int8 in HOP_STAGING:
        table = unit_rows(torch, gen, n, d, dev)
        scales = None
        if int8:
            table, scales = quantize(table)
        nbrs = torch.randint(0, n, (n, m), generator=gen, device=dev, dtype=torch.int32)
        nbrs[torch.rand((n, m), generator=gen, device=dev) < 0.1] = -1
        valid = torch.rand(n, generator=gen, device=dev) > 0.1
        cats = torch.randint(0, 7, (n,), generator=gen, device=dev, dtype=torch.int32)
        meta = torch.where(valid, cats, TOMBSTONE).to(torch.int32)
        variants = []
        for v in range(4):
            fr = torch.randint(0, n, (B, f), generator=gen, device=dev, dtype=torch.int32)
            fr[:, f - 2:] = -1
            done = torch.zeros(B, dtype=torch.int32, device=dev)
            done[v % B] = 1
            variants.append((fr, unit_rows(torch, gen, B, d, dev),
                             torch.tensor([-1, 0, 1, 2, 3, 4, 5, 6], dtype=torch.int32,
                                          device=dev), done))
        plan = fh._stage_plan(d, m, table.element_size())
        err = max(hold_hop(torch, fh, gs, table, nbrs, meta, v, scales, label)
                  for v in variants)
        out[("frontier_hop", label)] = time_hop(torch, fh, table, nbrs, meta, variants,
                                                scales, err)
        log(f"kernels: frontier_hop {label} N={n} B={B} F={f} M={m} ({plan['copy']} copies, "
            f"{plan['chunks']} chunks of {plan['chunk']} rows, {plan['smem_bytes']} bytes of "
            f"shared memory): {out[('frontier_hop', label)]}")
    return out


# The resident table sets of one delta flush, by index kind and dtype.
FLUSH_SETS = {"hnsw_float32": ("emb_f32", "neighbors", "valid", "category", "inserted"),
              "hnsw_int8": ("emb_i8", "scale", "neighbors", "valid", "category",
                            "inserted")}


def rand_table(torch, gen, dev, dtype, shape):
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen, device=dev) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=dev)
    return torch.randint(-100, 100, shape, generator=gen, device=dev).to(dtype)


def check_flush(torch, su, gen, dev, tables) -> dict:
    """scatter_flush (one launch for every table of a flush, from one
    packed buffer) over FLUSH_SETS at R 8 and 64, with a bucketing
    duplicate: bit-exact against the per-table plain version, then timed
    beside the per-table kernel (T launches), its plain version and T
    ``index_copy_`` calls (the library column). The bound counts the row
    ids once and every table's R rows read from the staged buffer and
    written into the table."""
    base = {k: rand_table(torch, gen, dev, dt, shape) for k, (dt, shape) in tables.items()}
    out = {}
    for label, names in FLUSH_SETS.items():
        tabs = [base[k] for k in names]
        for R in (8, 64):
            flushes = []
            for _ in range(4):
                rows = torch.randperm(HOP_N, generator=gen, device=dev)[:R].to(torch.int32)
                rows[-1] = rows[0]                      # bucketing duplicate
                vals = [rand_table(torch, gen, dev, tables[k][0], (R,) + tables[k][1][1:])
                        for k in names]
                for v in vals:
                    v[-1] = v[0]
                packed = torch.from_numpy(su.pack_flush(
                    rows.cpu().numpy(), [v.cpu().numpy() for v in vals])).to(dev)
                flushes.append((rows, rows.long(), vals, packed))
            for rows, _, vals, packed in flushes:
                got = [t.clone() for t in tabs]
                su.scatter_flush(got, packed, R)
                for k, g, t, v in zip(names, got, tabs, vals):
                    require(torch.equal(g, su.scatter_rows_plain(t.clone(), rows, v)),
                            f"scatter_flush {label} {k} R={R}: not bit-exact")
            nbytes = 4 * R + sum(2 * R * t[0].numel() * t.element_size() for t in tabs)
            b_sc = bound(nbytes, 0)
            tgt = [t.clone() for t in tabs]
            row = dict(
                max_abs_err=0.0,
                ms=graph_ms(torch, [lambda f=f: su.scatter_flush(tgt, f[3], R)
                                    for f in flushes]),
                per_table_ms=graph_ms(torch, [
                    lambda f=f: [su.scatter_rows(t, f[0], v) for t, v in zip(tgt, f[2])]
                    for f in flushes]),
                plain_ms=graph_ms(torch, [lambda f=f: su.scatter_flush_plain(tgt, f[3], R)
                                          for f in flushes]),
                library_ms=graph_ms(torch, [
                    lambda f=f: [t.index_copy_(0, f[1], v) for t, v in zip(tgt, f[2])]
                    for f in flushes]),
                bound_ms=b_sc[0], bound_by=b_sc[1], bytes=nbytes, tables=len(tabs))
            key = (("scatter_rows", "float32") if (label, R) == ("hnsw_float32", 64)
                   else ("scatter_rows", label, f"R{R}"))
            out[key] = row
            log(f"kernels: scatter_rows flush {label} R={R} ({len(tabs)} tables): {row}")
    return out


def gather_bound(sets, cats, scales, d: int, masked: bool) -> tuple[float, str]:
    """The bound of a gather over ``sets`` (mean over them): each distinct
    live row once (and its int8 scale; masked: the category of each distinct
    live id and each query's category), the ids, the queries and the scores;
    2·d operations per scored pair (masked: per pair that passes)."""
    row_b = d * 4 if scales is None else d + 4
    nbytes, ops = [], []
    for idx, q, qc in sets:
        live = idx[idx >= 0]
        rows = live.unique().numel()
        n = live.numel()
        extra = 0
        if masked:
            qce = qc[:, None].expand_as(idx)
            ok = (idx >= 0) & ((qce < 0) | (cats[idx.clamp(min=0).long()] == qce))
            n = int(ok.sum())
            extra = rows * 4 + q.shape[0] * 4
            rows = idx[ok].unique().numel()
        nbytes.append(rows * row_b + extra + idx.numel() * 8 + q.numel() * 4)
        ops.append(2 * d * n)
    return bound(statistics.mean(nbytes), statistics.mean(ops))


def hold_gather(torch, gs, table, scales, cats, sets, what: str) -> dict:
    """Both entries on ``sets`` of (idx, q, qc): against their plain versions
    (within SCORE_ATOL, -inf where they have it), the masked scores equal
    to gather_scores' where the category test passes, and both equal bit
    for bit to the earlier design (``gather_scores_serial``). Returns the
    largest error of each entry."""
    errs = {"gather_scores": 0.0, "gather_scores_masked": 0.0}
    for idx, q, qc in sets:
        g_k = gs.gather_scores(table, idx, q, scales)
        m_k = gs.gather_scores_masked(table, idx, q, cats, qc, scales)
        g_p = gs.gather_scores_plain(table, idx, q, scales)
        m_p = gs.gather_scores_masked_plain(table, idx, q, cats, qc, scales)
        torch.cuda.synchronize()
        errs["gather_scores"] = max(errs["gather_scores"], max_err(g_k, g_p, torch))
        errs["gather_scores_masked"] = max(errs["gather_scores_masked"],
                                           max_err(m_k, m_p, torch))
        passed = torch.isfinite(m_k)
        require(torch.equal(m_k[passed], g_k[passed]),
                f"gather_scores_masked and gather_scores differ ({what})")
        require(torch.equal(gs.gather_scores_serial(table, idx, q, scales), g_k),
                f"gather_scores and its earlier design differ ({what})")
        require(torch.equal(gs.gather_scores_serial(table, idx, q, scales, cats, qc), m_k),
                f"gather_scores_masked and its earlier design differ ({what})")
    for name, err in errs.items():
        require(err <= SCORE_ATOL, f"{name} {what}: err {err}")
    return errs


def check_gather(torch, gs, table, scales, cats, gather_sets, dtype) -> dict:
    """gather_scores and gather_scores_masked on check_kernels' three cases
    ("random" (a), "entry_set" (b), "floor" (c)): held (hold_gather), then
    timed with the earlier design (d) on the same inputs: ``ms``,
    ``earlier_ms``, ``plain_ms`` and the bound at (a); ``entry_set_ms``,
    ``earlier_entry_set_ms`` and ``entry_set_bound_ms`` at (b); ``floor_ms``
    and ``earlier_floor_ms`` at (c)."""
    d = table.shape[1]
    errs = {}
    for label, sets in gather_sets.items():
        for name, err in hold_gather(torch, gs, table, scales, cats, sets,
                                     f"{dtype} {label}").items():
            errs[name] = max(errs.get(name, 0.0), err)
    calls = {
        "gather_scores": (
            lambda s: gs.gather_scores(table, s[0], s[1], scales),
            lambda s: gs.gather_scores_serial(table, s[0], s[1], scales),
            lambda s: gs.gather_scores_plain(table, s[0], s[1], scales)),
        "gather_scores_masked": (
            lambda s: gs.gather_scores_masked(table, s[0], s[1], cats, s[2], scales),
            lambda s: gs.gather_scores_serial(table, s[0], s[1], scales, cats, s[2]),
            lambda s: gs.gather_scores_masked_plain(table, s[0], s[1], cats, s[2], scales)),
    }

    def timed(fn, label):
        return graph_ms(torch, [lambda s=s: fn(s) for s in gather_sets[label]])

    out = {}
    for name, (kern, earlier, plain) in calls.items():
        masked = name == "gather_scores_masked"
        b_a = gather_bound(gather_sets["random"], cats, scales, d, masked)
        b_b = gather_bound(gather_sets["entry_set"], cats, scales, d, masked)
        row = dict(max_abs_err=errs[name], ms=timed(kern, "random"),
                   earlier_ms=timed(earlier, "random"), plain_ms=timed(plain, "random"),
                   bound_ms=b_a[0], bound_by=b_a[1], library_ms=None,
                   entry_set_ms=timed(kern, "entry_set"),
                   earlier_entry_set_ms=timed(earlier, "entry_set"),
                   entry_set_bound_ms=b_b[0], floor_ms=timed(kern, "floor"),
                   earlier_floor_ms=timed(earlier, "floor"))
        out[(name, dtype)] = row
        log(f"kernels: {name} {dtype} random ids (a) {row['ms']:.6f} ms [earlier "
            f"{row['earlier_ms']:.6f}], entry set (b) {row['entry_set_ms']:.6f} [earlier "
            f"{row['earlier_entry_set_ms']:.6f}], no-row floor (c) {row['floor_ms']:.6f} "
            f"[earlier {row['earlier_floor_ms']:.6f}]; bound (a) {b_a[0]:.7f} (b) "
            f"{b_b[0]:.7f} ms, {b_a[1]}: {row}")
    return out


# Shapes of gather_scores' other paths: (label, N, d, B, int8). int8 d 388
# rows are 4-byte chunks that are not 16-byte multiples; d 1,024 with B 40
# (more queries than a warp has lanes) takes three query groups, 16, 16
# and 8, and rows shared across them.
GATHER_EDGES = (("int8_d388", 16_384, 388, 8, True),
                ("float32_d1024_b40", 16_384, 1_024, 40, False),
                ("int8_d1024_b40", 16_384, 1_024, 40, True))


def gather_edge_paths(torch, gs, gen, dev, quantize) -> None:
    """Both entries on GATHER_EDGES' shapes, held by hold_gather on random
    ids, on the entry-set shape, and on ids drawn from 12 rows (queries of
    both groups sharing rows); ids >= N score -inf like padding."""
    for label, n, d, b, int8 in GATHER_EDGES:
        table = unit_rows(torch, gen, n, d, dev)
        scales = None
        if int8:
            table, scales = quantize(table)
        cats = torch.randint(0, 7, (n,), generator=gen, device=dev, dtype=torch.int32)
        sets = []
        for _ in range(3):
            q = unit_rows(torch, gen, b, d, dev)
            qc = torch.randint(-1, 7, (b,), generator=gen, device=dev, dtype=torch.int32)
            rand = torch.randint(-1, n, (b, F), generator=gen, device=dev, dtype=torch.int32)
            f0 = torch.full((F,), -1, dtype=torch.int32, device=dev)
            f0[:N_ENTRIES] = torch.randperm(n, generator=gen, device=dev)[:N_ENTRIES]
            f0[N_ENTRIES] = f0[0]
            pool = torch.randperm(n, generator=gen, device=dev)[:12].to(torch.int32)
            shared = pool[torch.randint(0, 12, (b, F), generator=gen, device=dev)]
            shared[torch.rand((b, F), generator=gen, device=dev) < 0.2] = -1
            sets += [(rand, q, qc), (f0[None, :].expand(b, F).contiguous(), q, qc),
                     (shared, q, qc)]
        errs = hold_gather(torch, gs, table, scales, cats, sets, label)
        over = sets[0][0].clone()
        over[:, ::5] = n + 5
        g = gs.gather_scores(table, over, sets[0][1], scales)
        require(bool(torch.isneginf(g[:, ::5]).all()) and torch.equal(
            g, gs.gather_scores_serial(table, over, sets[0][1], scales)),
            f"gather_scores {label}: ids >= N must score -inf")
        log(f"kernels: gather_scores(_masked) {label} N={n} B={b} K={F}: random ids, the "
            f"entry set and ids shared across query groups held, max |err| {errs}")


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
        idx = fr[:, :M].clone()                         # random ids, 3 padded lanes
        idx[:, -3:] = -1
        variants.append((fr, q, qc, done, idx))

    # gather_scores' cases: (a) each variant's random ids (the hop's frontier
    # with 3 padded lanes); (b) the main path's entry set (core/hnsw.py:
    # beam_search): N_ENTRIES ids from the first SPARSE_ROWS rows, the same
    # for all B queries, padded to the beam F with INVALID; (c) every id
    # INVALID, the kernel's no-row floor.
    gather_sets = {"random": [(v[4], v[1], v[2]) for v in variants], "entry_set": [],
                   "floor": []}
    egen = torch.Generator(device=dev)     # its own, so the other phases' data stay
    egen.manual_seed(2027)
    for fr, q, qc, done, idx in variants:
        f0 = torch.full((F,), -1, dtype=torch.int32, device=dev)
        f0[:N_ENTRIES] = torch.randperm(SPARSE_ROWS, generator=egen, device=dev)[:N_ENTRIES]
        gather_sets["entry_set"].append((f0[None, :].expand(B, F).contiguous(), q, qc))
        gather_sets["floor"].append((torch.full_like(idx, -1), q, qc))

    for dtype, table, scales in (("float32", emb, None),
                                 ("int8", emb_q, emb_s)):
        errs_fh = []
        for fr, q, qc, done, idx in variants:
            ids_k, route_k, res_k = fh.frontier_hop(table, nbrs, meta, fr, q, qc,
                                                    done, scales)
            ids_p, route_p, res_p = fh.frontier_hop_plain(table, nbrs, meta, fr, q,
                                                          qc, done, scales)
            torch.cuda.synchronize()
            require(torch.equal(ids_k, ids_p), f"frontier_hop {dtype}: ids differ")
            errs_fh += [max_err(route_k, route_p, torch), max_err(res_k, res_p, torch)]
            # the shared dot: gather_scores on the hop's candidate ids gives
            # the hop's routing scores bit for bit
            g_on_hop = gs.gather_scores(table, ids_k, q, scales)
            require(torch.equal(g_on_hop, route_k),
                    f"gather_scores and frontier_hop differ ({dtype})")
        err_fh = max(errs_fh)
        require(err_fh <= SCORE_ATOL, f"frontier_hop {dtype}: err {err_fh}")
        out[("frontier_hop", dtype)] = time_hop(torch, fh, table, nbrs, meta, variants,
                                                scales, err_fh)
        log(f"kernels: frontier_hop {dtype} {out[('frontier_hop', dtype)]}")
        out.update(check_gather(torch, gs, table, scales, cats, gather_sets, dtype))
        hop_dead_lanes(torch, fh, gs, table, nbrs, meta, variants, scales, dtype)
        # the main path's occupancy: its cache holds < SPARSE_ROWS entries,
        # so every frontier and neighbor id falls in the first rows
        near = [(torch.where(v[0] >= 0, v[0] % SPARSE_ROWS, -1), *v[1:4]) for v in variants]
        nb = nbrs % SPARSE_ROWS
        nb[nbrs < 0] = -1
        err = max(hold_hop(torch, fh, gs, table, nb, meta, v, scales, f"{dtype} prefix")
                  for v in near)
        out[("frontier_hop", "prefix", dtype)] = time_hop(torch, fh, table, nb, meta, near,
                                                          scales, err)
        log(f"kernels: frontier_hop {dtype}, ids in the first {SPARSE_ROWS} rows "
            f"{out[('frontier_hop', 'prefix', dtype)]}")
    del emb, emb_q, emb_s, nbrs, valid, cats, meta, variants, gather_sets
    torch.cuda.empty_cache()
    out.update(hop_staging_paths(torch, fh, gs, gen, dev, quantize))
    gather_edge_paths(torch, gs, egen, dev, quantize)
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
        out[("flat_topk", dtype)] = time_flat_topk(torch, ft, tab, valid, cats, qsets,
                                                   scales, err)
        log(f"kernels: flat_topk {dtype} {out[('flat_topk', dtype)]}")
        # the main path's occupancy: FlatIndex fills slots from 0, so a cache
        # of 3,000 entries is a 3,000-row valid prefix of the 1,048,576 rows
        sparse = torch.zeros_like(valid)
        sparse[:SPARSE_ROWS] = True
        errs = []
        for q, qc in qsets:
            s_k, i_k = ft.flat_topk(tab, sparse, q, cats, qc, scales)
            s_p, i_p = ft.flat_topk_plain(tab, sparse, q, cats, qc, scales)
            require(torch.equal(i_k, i_p), f"flat_topk {dtype} sparse: idx {i_k} vs {i_p}")
            errs.append(max_err(s_k, s_p, torch))
        err = max(errs)
        require(err <= SCORE_ATOL, f"flat_topk {dtype} sparse: err {err}")
        out[("flat_topk", "sparse", dtype)] = time_flat_topk(
            torch, ft, tab, sparse, cats, qsets, scales, err)
        log(f"kernels: flat_topk {dtype} {SPARSE_ROWS} valid rows "
            f"{out[('flat_topk', 'sparse', dtype)]}")
    del table, tq, ts, valid, cats, qsets, sparse
    torch.cuda.empty_cache()
    flat_topk_ties(torch, ft, gen, dev, quantize)
    n, offsets, stride = TIE_WIDE
    for d in TIE_WIDTHS:
        flat_topk_ties(torch, ft, gen, dev, quantize, d, n, offsets, stride)
    torch.cuda.empty_cache()

    # -- scatter_rows: one flush launch over every resident table ---------
    tables = {
        "emb_f32": (torch.float32, (HOP_N, D)), "emb_i8": (torch.int8, (HOP_N, D)),
        "scale": (torch.float32, (HOP_N,)), "neighbors": (torch.int32, (HOP_N, M)),
        "valid": (torch.bool, (HOP_N,)), "category": (torch.int32, (HOP_N,)),
        "inserted": (torch.float32, (HOP_N,)),
    }
    out.update(check_flush(torch, su, gen, dev, tables))
    log(f"kernels: scatter_rows flush hnsw fp32 R=64 {out[('scatter_rows', 'float32')]}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- attention
# Serve shape: llama3.2-3b (Hq=24, Hkv=8, dh=128) at batch 8, prompt 64, 16
# new tokens; long prefill 4,096; decode_32k 32,768 positions.
HQ, HKV, DH = 24, 8, 128
EDGE_CASES = (dict(causal=True, window=48, kv_offset=64), dict(causal=False, softcap=30.0),
              dict(causal=True, kv_offset=64))


def attn_close(torch, got, want, atol: float = SCORE_ATOL, what: str = "attention"
               ) -> float:
    """Largest |got - want|. fp32 must agree within ``atol`` (summation
    order); a bf16 output rounds the same fp32 value, so the two may differ
    by one bf16 step: 2^-7 of the larger magnitude (plus ``atol``)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        tol = torch.maximum(g.abs(), w.abs()) * 2.0 ** -7 + atol
    else:
        tol = torch.full_like(err, atol)
    require(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    require(bool((err <= tol).all()),
            f"{what} {got.dtype}: err {float(err.max())} past its tolerance")
    return float(err.max())


def flash_close(torch, fa, q, k, v, what: str = "flash_attention", **kw) -> float:
    """The flash kernel against the fp32 oracle on the same inputs. fp32
    within SCORE_ATOL; bf16 (tensor cores, probabilities rounded to bf16
    before P·V) per element within 2^-7·max(|got|, |want|) + 2^-7·(P·|V|)
    + SCORE_ATOL, P·|V| being the oracle on |V|."""
    from repro_torch.kernels.ref import bf16_probability_tol
    got = fa.flash_attention(q, k, v, **kw)
    if q.dtype != torch.bfloat16:
        return attn_close(torch, got, fa.flash_attention_plain(q, k, v, **kw), what=what)
    f32 = [t.float() for t in (q, k, v)]
    want = fa.flash_attention_plain(*f32, **kw)
    pv = fa.flash_attention_plain(f32[0], f32[1], f32[2].abs(), **kw)
    err = (got.float() - want).abs()
    require(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
    require(bool((err <= bf16_probability_tol(got, want, pv, SCORE_ATOL)).all()),
            f"{what} bf16 {kw}: err {float(err.max())} past its tolerance")
    return float(err.max())


def sdpa_ms(torch, q, k, v, *, causal, mask=None) -> float:
    """The library yardstick: one scaled_dot_product_attention call on the
    same inputs (timed here only; the port never calls it)."""
    import torch.nn.functional as F
    return graph_ms(torch, [lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True)])


def check_attention(torch, dev) -> dict:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    out = {}

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- flash_attention, causal: serve shape and a long prefill ----------
    for label, B, S in (("serve", 8, 64), ("long", 1, 4096)):
        for dtype in (torch.float32, torch.bfloat16):
            sets = [(rnd(B, HQ, S, DH, dtype=dtype), rnd(B, HKV, S, DH, dtype=dtype),
                     rnd(B, HKV, S, DH, dtype=dtype)) for _ in range(2 if S < 1024 else 1)]
            err = max(flash_close(torch, fa, q, k, v, causal=True) for q, k, v in sets)
            esz = sets[0][0].element_size()
            nbytes = esz * (2 * B * HQ * S * DH + 2 * B * HKV * S * DH)
            flops = 4 * B * HQ * DH * S * (S + 1) // 2      # causal pairs
            rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
            b_fa = bound(nbytes, flops, rate)
            q, k, v = sets[0]
            out[("flash_attention", label, str(dtype)[6:])] = dict(
                max_abs_err=err,
                ms=graph_ms(torch, [lambda s=s: fa.flash_attention(*s, causal=True)
                                    for s in sets]),
                plain_ms=graph_ms(torch, [lambda s=s: fa.flash_attention_plain(
                    *s, causal=True) for s in sets]),
                bound_ms=b_fa[0], bound_by=b_fa[1],
                library_ms=sdpa_ms(torch, q, k, v, causal=True), bytes=nbytes,
                flops=flops)
            log(f"kernels: flash_attention {label} B={B} S={S} {dtype} "
                f"{out[('flash_attention', label, str(dtype)[6:])]}")
    # window, softcap, kv_offset and an Skv edge off the tile grid: held,
    # not timed
    for dtype in (torch.float32, torch.bfloat16):
        q = rnd(2, HQ, 100, DH, dtype=dtype)
        k, v = rnd(2, HKV, 164, DH, dtype=dtype), rnd(2, HKV, 164, DH, dtype=dtype)
        for kw in EDGE_CASES:
            flash_close(torch, fa, q, k, v, **kw)
    # the bf16 kernel at every head dim of the configs: the serve shape and
    # the edge cases (own generator, so the timed inputs stay as they were)
    hgen = torch.Generator(device=dev)
    hgen.manual_seed(2029)
    for dh in (64, 128, 256):
        def hrnd(*shape):
            return torch.randn(shape, generator=hgen, device=dev).to(torch.bfloat16)
        err = flash_close(torch, fa, hrnd(8, HQ, 64, dh), hrnd(8, HKV, 64, dh),
                          hrnd(8, HKV, 64, dh), causal=True)
        q, k, v = hrnd(2, HQ, 100, dh), hrnd(2, HKV, 164, dh), hrnd(2, HKV, 164, dh)
        for kw in EDGE_CASES:
            err = max(err, flash_close(torch, fa, q, k, v, **kw))
        log(f"kernels: flash_attention bf16 dh={dh}: serve shape and edge cases held "
            f"(max |err| {err:.3g})")

    # -- decode_attention through the model's (B, S, Hkv, dh) cache view ---
    for label, B, S in (("serve", 8, 80), ("decode_32k", 8, 32768)):
        for dtype in (torch.float32, torch.bfloat16):
            sets = []
            for i in range(2 if S < 1024 else 1):
                kc = rnd(B, S, HKV, DH, dtype=dtype)
                vc = rnd(B, S, HKV, DH, dtype=dtype)
                lo = 65 if S < 1024 else 1
                lens = torch.randint(lo, S + 1, (B,), generator=gen, device=dev,
                                     dtype=torch.int32)
                lens[0] = S
                if i == 1:
                    lens[1] = 0                               # attends to nothing
                sets.append((rnd(B, HQ, DH, dtype=dtype), kc.transpose(1, 2),
                             vc.transpose(1, 2), lens))
            err = 0.0
            for q, k, v, lens in sets:
                empty = lens.clone()
                empty[1] = 0                                  # attends to nothing
                for ln in (lens, empty):
                    got = da.decode_attention(q, k, v, ln)
                    err = max(err, attn_close(torch, got, da.decode_attention_plain(
                        q, k, v, kv_len=ln)))
                    require(not bool(got[ln == 0].any()), "decode: kv_len 0 must give 0")
                # softcap, and softcap with a window: held, not timed
                for kw in (dict(softcap=30.0), dict(softcap=30.0, window=48)):
                    attn_close(torch, da.decode_attention(q, k, v, lens, **kw),
                               da.decode_attention_plain(q, k, v, kv_len=lens, **kw))
            esz = sets[0][0].element_size()
            live = statistics.mean(int(s[3].sum()) for s in sets)
            nbytes = esz * (2 * live * HKV * DH + 2 * B * HQ * DH) + 4 * B
            flops = 4 * HQ * DH * live
            b_da = bound(nbytes, flops, BF16_OPS_PER_S if dtype == torch.bfloat16
                         else FP32_OPS_PER_S)
            q, k, v, lens = sets[0]
            mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
            out[("decode_attention", label, str(dtype)[6:])] = dict(
                max_abs_err=err, splits=da.num_splits(S, None, da.CHUNK), chunk=da.CHUNK,
                ms=graph_ms(torch, [lambda s=s: da.decode_attention(*s) for s in sets]),
                plain_ms=graph_ms(torch, [lambda s=s: da.decode_attention_plain(
                    *s[:3], kv_len=s[3]) for s in sets]),
                bound_ms=b_da[0], bound_by=b_da[1],
                library_ms=sdpa_ms(torch, q[:, :, None], k, v, causal=False, mask=mask),
                bytes=nbytes, flops=flops)
            log(f"kernels: decode_attention {label} B={B} S={S} {dtype} "
                f"{out[('decode_attention', label, str(dtype)[6:])]}")
            if label == "decode_32k":
                row = out[("decode_attention", label, str(dtype)[6:])]
                row["chunk_ms"] = chunk_sweep(torch, da, sets, None)
                log(f"kernels: decode_attention decode_32k {dtype} ms by chunk "
                    f"{row['chunk_ms']}")
                out[("decode_attention", f"decode_32k_w{WINDOW}", str(dtype)[6:])] = \
                    windowed_decode(torch, da, sets, dtype)
    torch.cuda.empty_cache()
    return out


WINDOW = 4096                  # gemma2's local layers
CHUNKS = (512, 1024, 2048)     # decode split sizes measured at decode_32k


def chunk_sweep(torch, da, sets, window) -> dict:
    """decode_attention's time at each split size in CHUNKS (the port's
    own is ``da.CHUNK``), each held against the plain version first."""
    times = {}
    for chunk in CHUNKS:
        def call(s, chunk=chunk):
            return da._decode(*s, softcap=None, window=window, scale=None, chunk=chunk)
        for s in sets:
            attn_close(torch, call(s), da.decode_attention_plain(*s[:3], kv_len=s[3],
                                                                 window=window))
        times[chunk] = graph_ms(torch, [lambda s=s: call(s) for s in sets])
    return times


def windowed_decode(torch, da, sets, dtype) -> dict:
    """decode_attention with a window of WINDOW on the decode_32k inputs:
    held against the plain version (kv_len 0 and the full length included)
    and timed at each split size; the bound counts only the rows inside
    each sequence's window."""
    err = 0.0
    for q, k, v, lens in sets:
        empty = lens.clone()
        empty[1] = 0
        for ln in (lens, empty):
            got = da.decode_attention(q, k, v, ln, window=WINDOW)
            err = max(err, attn_close(torch, got, da.decode_attention_plain(
                q, k, v, kv_len=ln, window=WINDOW)))
            require(not bool(got[ln == 0].any()), "decode: kv_len 0 must give 0")
    B = sets[0][0].shape[0]
    esz = sets[0][0].element_size()
    live = statistics.mean(int(s[3].clamp(max=WINDOW).sum()) for s in sets)
    nbytes = esz * (2 * live * HKV * DH + 2 * B * HQ * DH) + 4 * B
    b_w = bound(nbytes, 4 * HQ * DH * live, BF16_OPS_PER_S if dtype == torch.bfloat16
                else FP32_OPS_PER_S)
    q, k, v, lens = sets[0]
    S = k.shape[2]
    pos = torch.arange(S, device=q.device)[None, :]
    mask = ((pos < lens[:, None]) & (pos >= lens[:, None] - WINDOW))[:, None, None, :]
    row = dict(
        max_abs_err=err, splits=da.num_splits(S, WINDOW, da.CHUNK), chunk=da.CHUNK,
        ms=graph_ms(torch, [lambda s=s: da.decode_attention(*s, window=WINDOW)
                            for s in sets]),
        plain_ms=graph_ms(torch, [lambda s=s: da.decode_attention_plain(
            *s[:3], kv_len=s[3], window=WINDOW) for s in sets]),
        bound_ms=b_w[0], bound_by=b_w[1],
        library_ms=sdpa_ms(torch, q[:, :, None], k, v, causal=False, mask=mask),
        bytes=nbytes, chunk_ms=chunk_sweep(torch, da, sets, WINDOW))
    log(f"kernels: decode_attention decode_32k window {WINDOW} {dtype} {row}")
    return row


# ---------------------------------------------------------------- mamba_scan
# falcon-mamba-7b: d_inner 8192, d_state 16; serve batch 8, prompt 64. The
# reduced configs' d_state is 8: every shape runs at both.
DI, NS = 8192, 16
SCAN_STATES = (NS, 8)
SCAN_SHAPES = (("serve_prefill", 8, 64, False), ("serve_decode", 8, 1, True),
               ("long", 1, 4096, False))
# Held, not timed: a ragged L, and a Dm that is a multiple of no block's
# channel count, as a prefill and as a decode step.
SCAN_RAGGED = ((3, 77, 1000), (5, 1, 1000))
SFU_EXP_PER_CLK = 16           # exp2 per clock on each SM's special function units


def scan_inputs(torch, gen, dev, Bt, L, dtype, Dm=DI, N=NS):
    """Inputs at the model's scales: x ~ N(0, 0.25), dt log-uniform in
    [1e-3, 0.1] (its softplus(dt_bias) init), A = -exp(U(log 0.5, log 16)),
    B, C ~ N(0, 1), D ~ N(0, 1), h0 ~ N(0, 0.01)."""
    import math

    def u(*shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    x = (torch.randn((Bt, L, Dm), generator=gen, device=dev) * 0.5).to(dtype)
    dt = torch.exp(u(Bt, L, Dm, lo=math.log(1e-3), hi=math.log(0.1)))
    A = -torch.exp(u(Dm, N, lo=math.log(0.5), hi=math.log(16.0)))
    B = torch.randn((Bt, L, N), generator=gen, device=dev)
    C = torch.randn((Bt, L, N), generator=gen, device=dev)
    D = torch.randn((Dm,), generator=gen, device=dev)
    h0 = torch.randn((Bt, Dm, N), generator=gen, device=dev) * 0.1
    return x, dt, A, B, C, D, h0


def scan_check(torch, ms, inputs, start, label: str) -> float:
    """One mamba_scan call against the plain version (y and h within
    SCAN_ATOL); with an initial state, also the same call with h_out
    aliased over a copy of it, held bit for bit against a separate h_out."""
    x, dt, A, B, C, D = inputs[:6]
    y_k, h_k = ms.mamba_scan(x, dt, A, B, C, D, start)
    y_p, h_p = ms.mamba_scan_plain(x, dt, A, B, C, D, start)
    torch.cuda.synchronize()
    err = max(attn_close(torch, y_k, y_p, SCAN_ATOL, f"mamba_scan {label} y"),
              attn_close(torch, h_k, h_p, SCAN_ATOL, f"mamba_scan {label} h"))
    if start is not None:
        state = start.clone()
        y_a, h_a = ms.mamba_scan(x, dt, A, B, C, D, state, h_out=state)
        torch.cuda.synchronize()
        require(h_a.data_ptr() == state.data_ptr()
                and torch.equal(y_a, y_k) and torch.equal(state, h_k),
                f"mamba_scan {label}: aliased h0/h_out differs from a separate h_out")
    return err


def sfu_ms(torch, n_exp: int) -> float:
    """The special function units' floor: n_exp exps at SFU_EXP_PER_CLK a
    clock on every SM, at the card's highest SM clock (nvidia-smi)."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exp / (sms * SFU_EXP_PER_CLK * float(mhz) * 1e6) * 1e3


def check_mamba(torch, dev) -> dict:
    """mamba_scan against its plain version at N 16 and 8: the serve
    prefill (no h0), the serve decode step (h0 aliased with h_out) and a
    long scan, timed, and a ragged L and Dm, held; all with fp32 and bf16
    x. A prefill with h0 and every decode are also held bit for bit
    against the same call with a separate h_out. Each timed row's log
    line carries the SFU floor of its exps beside its bound. A B that
    starts off a 16-byte boundary is refused by the wrapper and copied by
    ``ops.mamba_scan``."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(2028)
    out = {}
    for N in SCAN_STATES:
        for label, Bt, L, with_h0 in SCAN_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                sets = [scan_inputs(torch, gen, dev, Bt, L, dtype, N=N)
                        for _ in range(2 if L < 1024 else 1)]
                err = 0.0
                for s in sets:
                    starts = (s[6],) if with_h0 else (None, s[6]) if L < 1024 else (None,)
                    for start in starts:
                        err = max(err, scan_check(torch, ms, s, start, label))
                esz = sets[0][0].element_size()
                n = Bt * L * DI
                nbytes = (n * (2 * esz + 4) + 2 * Bt * L * N * 4 + DI * (N + 1) * 4
                          + Bt * DI * N * 4 * (2 if with_h0 else 1))
                b_s = bound(nbytes, 7 * n * N)
                if with_h0:
                    fns = [lambda s=s: ms.mamba_scan(*s, h_out=s[6]) for s in sets]
                    plain = [lambda s=s: ms.mamba_scan_plain(*s) for s in sets]
                else:
                    fns = [lambda s=s: ms.mamba_scan(*s[:6]) for s in sets]
                    plain = [lambda s=s: ms.mamba_scan_plain(*s[:6]) for s in sets]
                key = ("mamba_scan", label if N == NS else f"{label}_n{N}",
                       str(dtype)[6:])
                out[key] = dict(max_abs_err=err, ms=graph_ms(torch, fns),
                                plain_ms=graph_ms(torch, plain,
                                                  replays=5 if L > 1024 else 15),
                                bound_ms=b_s[0], bound_by=b_s[1], library_ms=None,
                                sfu_ms=sfu_ms(torch, n * N), bytes=nbytes, ops=7 * n * N)
                log(f"kernels: mamba_scan {label} Bt={Bt} L={L} Dm={DI} N={N} {dtype} "
                    f"{out[key]}")
                del sets
        for Bt, L, Dm in SCAN_RAGGED:
            err = 0.0
            for dtype in (torch.float32, torch.bfloat16):
                s = scan_inputs(torch, gen, dev, Bt, L, dtype, Dm=Dm, N=N)
                for start in (None, s[6]):
                    err = max(err, scan_check(torch, ms, s, start, f"Dm={Dm} L={L} N={N}"))
            log(f"kernels: mamba_scan Bt={Bt} L={L} Dm={Dm} N={N} fp32 and bf16, with and "
                f"without h0: held (max |err| {err:.3g})")
    # B and C split from one projection at batch 1 are contiguous views at an
    # offset: the kernel reads them as float4, so the wrapper refuses one
    # that is not 16-byte aligned and ops.mamba_scan hands it a copy.
    x, dt, A, Bm, Cm, Dv, h0 = scan_inputs(torch, gen, dev, 1, 1, torch.float32)
    off = torch.empty(Bm.numel() + 1, device=dev)[1:].view_as(Bm).copy_(Bm)
    try:
        ms.mamba_scan(x, dt, A, off, Cm, Dv, h0)
        refused = False
    except ValueError:
        refused = True
    require(refused, "mamba_scan: a B off a 16-byte boundary must be refused")
    y_o, h_o = ops.mamba_scan(x, dt, A, off, Cm, Dv, h0)
    y_a, h_a = ms.mamba_scan(x, dt, A, Bm, Cm, Dv, h0)
    torch.cuda.synchronize()
    require(torch.equal(y_o, y_a) and torch.equal(h_o, h_a),
            "ops.mamba_scan on an unaligned B differs from the aligned call")
    log("kernels: mamba_scan refuses an unaligned B; ops.mamba_scan copies it")
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
                flushes = idx.sync_stats["delta_updates"]
                su.scatter_flush.launches = 0
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
                flushes = idx.sync_stats["delta_updates"] - flushes
                require(flushes >= 1, "index: no delta flush")
                require(su.scatter_flush.launches == flushes,
                        f"index: {su.scatter_flush.launches} scatter launches for "
                        f"{flushes} delta flushes")
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
    kernels by name. The port's kernels in the trace must be exactly what
    the search graphs replayed in the window recorded at their capture."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batches = [queries[s:s + 8] for s in range(0, len(queries), 8)]
    programs = cache.index.programs
    before = dict(programs.replays)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for part in batches:
            cache.lookup_batch(np.stack([q.embedding for q in part]),
                               [q.category for q in part])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    replays = {k: n - before.get(k, 0) for k, n in programs.replays.items()
               if n != before.get(k, 0)}
    traced, want = traced_launches(prof), recorded_launches(programs, replays)
    require(traced == want, f"lookups under the profiler: the trace holds {traced} "
            f"launches of the port's kernels, the {replays} graph replays recorded {want}")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        return "device time not measured (the profiler saw no device events)"
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    names = ", ".join(f"{e.key[:48]} {e.self_device_time_total / busy_us:.0%}"
                      for e in top)
    port_us = {}
    for w, e in port_kernels(prof):
        port_us[w] = port_us.get(w, 0.0) + e.self_device_time_total / len(batches)
    return (f"{len(batches)} lookup_batch calls: device busy {busy_us / len(batches):.1f} "
            f"us/call of {wall_us / len(batches):.1f} us/call wall under the profiler "
            f"(idle share {1 - busy_us / wall_us:.3f}); top kernels: {names}; the port's "
            f"kernels' device us/call { {k: round(v, 3) for k, v in port_us.items()} }; the "
            f"port's kernels in the trace {({k: n for k, n in traced.items() if n})} equal "
            f"what the {replays} graph replays recorded at capture")


# The CUDA kernel that each wrapper a graph may hold launches once a call,
# by its name in a profiler trace (flat_topk's reduce and decode_attention's
# combine kernel launch beside it and are not counted).
TRACE_KERNELS = {"frontier_hop": ("frontier_hop_kernel",),
                 "gather_scores": ("gather_scores_kernel",),
                 "flat_topk": ("flat_topk_partial_kernel",),
                 "flash_attention": ("flash_wgmma_kernel", "flash_kernel"),
                 "decode_attention": ("decode_kernel",),
                 "mamba_scan": ("mamba_scan_kernel", "mamba_step_kernel")}


def port_kernels(prof):
    """(wrapper of TRACE_KERNELS, event) for each device event of a
    torch.profiler window made by one of the port's kernels, by name
    (CUPTI records every kernel of a graph replay)."""
    import re

    from torch.autograd import DeviceType
    pats = {w: re.compile("|".join(rf"(?<!\w){n}(?!\w)" for n in names))
            for w, names in TRACE_KERNELS.items()}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for w, pat in pats.items():
                if pat.search(e.key):
                    yield w, e


def traced_launches(prof) -> dict:
    """The port's kernels that ran on the card in a torch.profiler window,
    counted by wrapper of TRACE_KERNELS."""
    out = dict.fromkeys(TRACE_KERNELS, 0)
    for w, e in port_kernels(prof):
        out[w] += e.count
    return out


def recorded_launches(programs, replays: dict) -> dict:
    """What ``replays`` (key -> number of replays) of a holder's graphs
    launch, by wrapper of TRACE_KERNELS: each graph's launches recorded at
    its capture, times its replays."""
    out = dict.fromkeys(TRACE_KERNELS, 0)
    for key, n in replays.items():
        for fn, k in programs.recorded(key).items():
            require(fn.__name__ in out, f"graph {key} recorded {fn.__name__}, whose "
                    f"kernel no trace check names")
            out[fn.__name__] += n * k
    return out


def graph_count(counts: dict, kind: str) -> int:
    """The sum of a holder's per-key ``counts`` (captures or replays) over
    the keys of ``kind`` (their first element)."""
    return sum(n for k, n in counts.items() if k[0] == kind)


def probe_graph_vs_eager(torch, cache, kind: str, probe) -> dict:
    """The captured search against the eager search function on the same
    padded inputs and ``index.device_tables()``: the packed results (idx,
    score, cls, cand, and hops and rows gathered for hnsw) equal bit for
    bit. Returns the host ms of each (search, and one copy to the host)."""
    import numpy as np

    from repro_torch.core.hnsw import (_flat_search_classified, _pack_result,
                                       _pad_query_batch, beam_search_classified)
    index, pe = cache.index, cache.policies
    times = {"graph": [], "eager": []}
    for s in range(0, len(probe), 8):
        part = probe[s:s + 8]
        q = np.stack([x.embedding for x in part])
        taus = np.array([pe.effective(x.category).threshold for x in part], np.float32)
        cats = np.array([pe.category_id(x.category) for x in part], np.int32)
        ttls = np.array([pe.effective(x.category).ttl for x in part], np.float32)
        now = cache._now()
        t0 = time.perf_counter()
        index.search_classified(q, taus, categories=cats, ttls=ttls, now=now)
        got = index.last_search["words"]
        got.cpu()
        t1 = time.perf_counter()
        t = index.device_tables()
        _, _, qp, taup, qcp, tp = _pad_query_batch(q, taus, cats, ttls)
        qd, taud, qcd, ttld = (torch.from_numpy(a).cuda() for a in (qp, taup, qcp, tp))
        now_t = torch.tensor(np.float32(now), device="cuda")
        t2 = time.perf_counter()
        if kind == "hnsw":
            p = index.p
            idx, score, cls, st = beam_search_classified(
                t["emb"], t["neighbors"], t["valid"], t["entries"], t["inserted"], qd,
                taud, ttld, now_t, t["category"], qcd, t.get("scale"), beam=p.beam,
                max_hops=p.max_hops, hop_impl=index._resolve_hop_impl())
            want = _pack_result(idx, score, cls, st["cand"], st["hops"],
                                st["rows_gathered"])
        else:
            want = _pack_result(*_flat_search_classified(
                t["emb"], t["valid"], t["category"], t["inserted"], qd, taud, qcd, ttld,
                now_t, t.get("scale")))
        want.cpu()
        t3 = time.perf_counter()
        require(torch.equal(got, want), f"main {kind}: the captured search and the "
                f"eager one differ on probe batch {s // 8}")
        times["graph"].append((t1 - t0) * 1e3)
        times["eager"].append((t3 - t2) * 1e3)
    return times


def run_main_path(torch, counters, steps: int) -> tuple[dict, dict]:
    """The main path's run (see the module docstring). Returns the
    launches made at wrapper calls and those made in graph replays, by
    wrapper, summed over the four caches."""
    import numpy as np
    launches = {k: 0 for k in counters}
    replayed_all = dict.fromkeys(TRACE_KERNELS, 0)
    qs = table1_queries(steps * 8 + 80, seed=1)
    qs, probe = qs[:steps * 8], qs[steps * 8:]
    for kind in ("hnsw", "flat"):
        for dtype in ("float32", "int8"):
            cache, clock = make_cache(kind, dtype, 1_048_576, "cuda")
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            decisions, lookup_ms = serve(cache, clock, qs, 8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in counters.items()}
            for k in counts:
                launches[k] += counts[k]
            index, programs = cache.index, cache.index.programs
            searches = index.search_stats["searches"]
            replays = sum(programs.replays.values())
            captures = sum(programs.captures.values())
            require(replays == searches and captures >= 1,
                    f"main {kind}/{dtype}: {searches} searches, {replays} graph replays")
            # Every search replays a graph. The wrappers launched at the
            # captures' warm-ups only; the replays ran what each capture
            # recorded (held against a profiled window in profile_lookups).
            replayed = recorded_launches(programs, programs.replays)
            for k in replayed:
                replayed_all[k] += replayed[k]
            per = ({"frontier_hop": index.p.max_hops, "gather_scores": 1}
                   if kind == "hnsw" else {"flat_topk": 1})
            for k, n in per.items():
                require(counts[k] == n * captures and replayed[k] == n * searches > 0,
                        f"main {kind}/{dtype}: {k} launched {counts[k]} times at wrapper "
                        f"calls and {replayed[k]} in graph replays, not {n * captures} "
                        f"({captures} warm-ups) and {n * searches} ({searches} searches)")
            flushes = cache.sync_stats["delta_updates"]
            require(counts["scatter_flush"] == flushes > 0,
                    f"main {kind}/{dtype}: {counts['scatter_flush']} scatter launches for "
                    f"{flushes} delta flushes (one launch a flush)")
            require(all(np.isfinite(d[2]) or not d[0] for d in decisions),
                    "main: a hit without a finite score")
            rates = {c: round(st.hit_rate, 4)
                     for c, st in sorted(cache.metrics.per_category.items())}
            log(f"main {kind}/{dtype}: {len(qs)} queries in {wall:.2f} s; "
                f"lookup_batch ms p50 {np.percentile(lookup_ms, 50):.3f} "
                f"p99 {np.percentile(lookup_ms, 99):.3f}; launches {counts}")
            log(f"main {kind}/{dtype}: graphs: captures {programs.captures}, replays "
                f"{programs.replays}, compilations {index.search_stats['compilations']}; "
                f"launches in graph replays {({k: n for k, n in replayed.items() if n})} "
                f"(each graph's recorded launches x its replays), at wrapper calls "
                f"{({k: n for k, n in counts.items() if n})}")
            log(f"main {kind}/{dtype}: hit rates {rates}")
            log(f"main {kind}/{dtype}: sync_stats {cache.sync_stats}")
            log(f"main {kind}/{dtype}: last_lookup_stats {cache.last_lookup_stats}")
            log(f"main {kind}/{dtype}: entries {len(cache)}, device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak (graphs included)")
            times = probe_graph_vs_eager(torch, cache, kind, probe)
            log(f"main {kind}/{dtype}: {len(probe)} probe queries, captured search equals "
                f"the eager one bit for bit; search + copy to host ms p50 graph "
                f"{np.percentile(times['graph'], 50):.3f}, eager "
                f"{np.percentile(times['eager'], 50):.3f}")
            log(f"main {kind}/{dtype}: profile: {profile_lookups(torch, cache, probe)}")
            del cache, index, programs
            torch.cuda.empty_cache()
    return launches, replayed_all


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


# ---------------------------------------------------------------- phase 6
SERVE_ARCHS = ("llama3.2-3b", "falcon-mamba-7b")
# bf16 logits (magnitude ~4): card and CPU, or decode and prefill, round
# activations at other places (cuBLAS and the CPU sum in other orders, the
# decode and flash kernels differ in summation order), and one bf16 step of
# a hidden state moves a logit by ~1e-2; 0.1 bounds two layers of that
# (0.031 and 0.038 measured on an H100 for llama3.2-3b).
LOGIT_TOL = 0.1


def kernel_summary(torch, prof, wall_us: float) -> str:
    """Summed self device time of a torch.profiler window against its host
    wall time, and the largest kernels by name."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        return "device time not measured (the profiler saw no device events)"
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    names = ", ".join(f"{e.key[:40]} {e.self_device_time_total / busy_us:.0%}"
                      for e in top)
    n_kernels = sum(e.count for e in kernels)
    return (f"{n_kernels} device kernels, busy {busy_us:.1f} us of {wall_us:.1f} us wall "
            f"under the profiler (idle share {1 - busy_us / wall_us:.3f}); top kernels: "
            f"{names}")


class GenerateTimer:
    """Times generation on the card while ``run_serving`` runs: CUDA
    events around every replay of a prefill and a decode graph (read
    after the run, so the serve loop never waits for them; one replay of
    each, the fourth, runs under torch.profiler instead), and the host
    wall of every ``ServingEngine._generate``. The first replay of every
    graph runs under the profiler too, untimed: ``traced`` keeps, per key,
    the port's kernels in its trace and the launches its capture recorded.
    Keeps the engine, whose model, weights and graph holder the checks
    read afterwards."""

    KINDS = ("prefill", "decode")

    def __init__(self, torch):
        from repro_torch.core.graphs import CapturedProgram
        from repro_torch.serving.engine import ServingEngine
        self.torch = torch
        self.events = {k: [] for k in self.KINDS}
        self.profiles = {}
        self.traced = {}
        self.generate_ms = []
        self.engine = None
        self._patches = [(CapturedProgram, "run", self._wrap_run),
                         (ServingEngine, "_generate", self._wrap_generate)]
        self._orig = []

    def __enter__(self):
        for cls, name, wrap in self._patches:
            orig = getattr(cls, name)
            self._orig.append((cls, name, orig))
            setattr(cls, name, wrap(orig))
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self._orig:
            setattr(cls, name, orig)

    def _wrap_generate(self, orig):
        def call(engine, params, tokens):
            self.engine = engine
            t0 = time.perf_counter()
            out = orig(engine, params, tokens)      # ends in one copy to the host
            self.generate_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def _wrap_run(self, orig):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        def call(programs, key, fn, inputs=()):
            kind = key[0] if key[0] in self.KINDS else None
            if kind is None or not programs.ready(key):
                return orig(programs, key, fn, inputs)    # a search, or a capture
            if key not in self.traced:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = orig(programs, key, fn, inputs)
                    torch.cuda.synchronize()
                self.traced[key] = (traced_launches(prof),
                                    recorded_launches(programs, {key: 1}))
                return out
            if len(self.events[kind]) == 3 and kind not in self.profiles:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    out = orig(programs, key, fn, inputs)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                self.profiles[kind] = kernel_summary(torch, prof, wall_us)
                return out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(programs, key, fn, inputs)
            end.record()
            self.events[kind].append((start, end, key[1]))
            return out
        return call

    def ms(self, kind) -> list[float]:
        return [s.elapsed_time(e) for s, e, _ in self.events[kind]]


def eager_tokens(torch, model, params, tokens, max_len: int, new: int):
    """Greedy generation as the plain eager loop over ``Model.prefill``
    and ``Model.decode_step`` (the yardstick of the captured programs)."""
    V = model.cfg.vocab_size
    with torch.inference_mode():
        logits, cache, kv_len = model.prefill(
            params, {"tokens": torch.from_numpy(tokens).cuda()}, max_len)
        tok = logits[:, :V].argmax(-1).to(torch.int32)
        out = [tok]
        for _ in range(new - 1):
            logits, cache, kv_len = model.decode_step(params, cache, tok, kv_len)
            tok = logits[:, :V].argmax(-1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy()


def run_serve(torch, counters, arch: str, n_requests: int) -> dict:
    """The port's run_serving on the card: ``arch`` at full width and
    depth, seeded random weights drawn on the device, SemanticCache (hnsw,
    fp32, device search) with Table-1 traffic, batch 8, prompt 64, 16 new
    tokens. Generation replays a prefill and a decode graph per miss-batch
    size. Every kernel of the model's path must have launched exactly once
    per layer of every prefill (flash_attention) or decode step
    (decode_attention) that ran on the card, a dense model's, or of both
    (mamba_scan), an ssm model's; afterwards the captured generation must
    give the eager loop's tokens for a batch of 8 and one of 3."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serving
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with GenerateTimer(torch) as timer:
        t0 = time.perf_counter()
        out = run_serving(cfg, n_requests=n_requests, max_batch=8, prompt_len=64,
                          max_new_tokens=16, seed=0, index_kind="hnsw",
                          use_device=True, emb_dtype="float32", telemetry=True,
                          device="cuda", log=lambda m: log(f"serve {arch}: {m}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    engine = timer.engine
    programs = engine.programs
    # One replay of every graph, profiled: the port's kernels in its trace
    # are exactly what its capture recorded.
    for key in programs.keys():
        require(key in timer.traced, f"serve {arch}: graph {key} never replayed")
        traced, recorded = timer.traced[key]
        require(traced == recorded, f"serve {arch}: a replay of graph {key} ran "
                f"{traced} launches of the port's kernels, its capture recorded {recorded}")
    # The wrappers launched at the captures' warm-ups only; the replays ran
    # what the captures recorded.
    replayed = recorded_launches(programs, programs.replays)
    caps = {k: graph_count(programs.captures, k) for k in GenerateTimer.KINDS}
    reps = {k: graph_count(programs.replays, k) for k in GenerateTimer.KINDS}
    path = ({"flash_attention": ("prefill",), "decode_attention": ("decode",)}
            if cfg.family == "dense" else {"mamba_scan": GenerateTimer.KINDS})
    for k, kinds in path.items():
        warm, runs = sum(caps[g] for g in kinds), sum(reps[g] for g in kinds)
        require(counts[k] == cfg.n_layers * warm > 0
                and replayed[k] == cfg.n_layers * runs > 0,
                f"serve {arch}: {k} launched {counts[k]} times at wrapper calls and "
                f"{replayed[k]} in graph replays, not {cfg.n_layers} per layer of "
                f"{warm} warm-ups and of {runs} replays of the {kinds} graphs")
    for k in ("frontier_hop", "gather_scores"):
        require(counts[k] > 0, f"serve {arch}: {k} never launched")
    snap = out["per_category"]
    misses = round(out["served"] * (1 - out["hit_rate"]))
    require(out["served"] == n_requests, f"serve {arch}: not every request was served")
    require(out["model_tokens"] == 16 * misses and misses > 0,
            f"serve {arch}: every miss must generate 16 model tokens")
    # Every generate replays its prefill graph once (and once more when it
    # captures, before decode's capture) and its decode graph 15 times.
    n_gen = len(timer.generate_ms)
    require(reps == {"prefill": n_gen + caps["prefill"], "decode": 15 * n_gen},
            f"serve {arch}: {n_gen} generates, graph replays {reps}")
    captured = sorted(k for k in programs.captures)
    pre, dec = timer.ms("prefill"), timer.ms("decode")
    batches = [b for *_, b in timer.events["decode"]]
    dec_s = sum(dec) / 1e3
    step = decode_step_bound(engine.params, cfg, statistics.mean(batches), prompt_len=64,
                             new_tokens=16)
    numbers = dict(
        served=out["served"], hit_rate=out["hit_rate"], model_tokens=out["model_tokens"],
        model_batches=n_gen, decode_steps=reps["decode"],
        prefill_ms_p50=float(np.percentile(pre, 50)),
        prefill_ms_p99=float(np.percentile(pre, 99)),
        decode_ms_p50=float(np.percentile(dec, 50)),
        decode_ms_p99=float(np.percentile(dec, 99)),
        generate_ms_p50=float(np.percentile(timer.generate_ms, 50)),
        decode_tokens_per_s=sum(batches) / dec_s,
        tokens_per_s=out["model_tokens"] / wall, wall_s=wall,
        peak_gib=peak / 2**30, launches=counts, replay_launches=replayed, **step)
    rates = {c: round(row["hit_rate"], 4) for c, row in sorted(snap.items())
             if "hit_rate" in row}
    log(f"serve {arch}: {out['served']} served, {misses} served by the model, "
        f"{out['model_tokens']} model tokens; hit rates {rates}")
    log(f"serve {arch}: graphs captured {len(captured)} ({captured}); replays "
        f"{dict(sorted(programs.replays.items()))}")
    log(f"serve {arch}: prefill replay ms per batch p50 {numbers['prefill_ms_p50']:.3f} "
        f"p99 {numbers['prefill_ms_p99']:.3f} ({len(pre)} timed); decode replay ms per "
        f"token p50 {numbers['decode_ms_p50']:.3f} p99 {numbers['decode_ms_p99']:.3f} "
        f"({len(dec)} timed, mean batch {statistics.mean(batches):.2f}); host wall of "
        f"_generate ms p50 {numbers['generate_ms_p50']:.3f} p99 "
        f"{np.percentile(timer.generate_ms, 99):.3f} ({len(timer.generate_ms)} calls)")
    log(f"serve {arch}: {numbers['decode_tokens_per_s']:.1f} decode tokens/s, "
        f"{numbers['tokens_per_s']:.1f} model tokens/s over {wall:.2f} s wall; "
        f"peak device memory {numbers['peak_gib']:.2f} GiB (graphs included); "
        f"launches at wrapper calls {({k: n for k, n in counts.items() if n})}, in "
        f"graph replays {({k: n for k, n in replayed.items() if n})} (each graph's "
        f"recorded launches x its replays; one profiled replay of each of the "
        f"{len(timer.traced)} graphs ran exactly its recorded launches)")
    log(f"serve {arch}: decode step bound {step['decode_bound_ms']:.4f} ms, "
        f"{step['decode_bound_by']} ({step['decode_bytes'] / 1e9:.4f} GB at the mean "
        f"batch: bf16 layers, bf16 head, {step['decode_state']}); the fp32 head copy "
        f"the port reads instead adds {step['fp32_head_extra_ms']:.4f} ms")
    for name, text in timer.profiles.items():
        log(f"serve {arch}: profile of one {name} replay: {text}")
    rng = np.random.default_rng(11)
    for B in (8, 3):
        toks = rng.integers(2, cfg.vocab_size, (B, 64)).astype(np.int32)
        got = engine._generate(engine.params, toks)
        want = eager_tokens(torch, engine.model, engine.params, toks, 80, 16)
        require(np.array_equal(got, want), f"serve {arch}: B={B} graph tokens "
                f"{got.tolist()} differ from the eager loop's {want.tolist()}")
    log(f"serve {arch}: graph tokens equal the eager loop's for B = 8 and B = 3 "
        f"(16 tokens each)")
    del engine, programs, timer
    return numbers


def tree_sum(tree, of) -> int:
    """``of(tensor)`` summed over a parameter tree (dicts, lists, tensors)."""
    if isinstance(tree, dict):
        return sum(tree_sum(v, of) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_sum(v, of) for v in tree)
    return of(tree)


def decode_step_bound(params, cfg, batch: float, *, prompt_len: int,
                      new_tokens: int) -> dict:
    """The least time of one decode step at ``batch`` sequences: the bytes
    it must move (every layer weight, the bf16 head, the final norm, the
    batch's embedding rows, and each layer's cached state: the live K/V
    rows of an attention layer, at the mean live length over the steps of
    a generate, read; the fp32 state and conv tail of a Mamba layer, read
    and written) at the HBM rate, or its products at the bf16 tensor-core
    rate, whichever is larger. The port's fp32 head copy is a cost of its
    design, reported apart."""
    head = params["head"]
    esz = head.element_size()
    read = [params["layers"], params["final_norm"], head]
    kinds = cfg.layer_kinds()
    # decode step i of a generate attends prompt_len + 1 + i positions
    live = prompt_len + 1 + (new_tokens - 2) / 2
    kv = 2 * kinds.count("attn") * cfg.n_kv_heads * cfg.head_dim * esz * live * batch
    di = cfg.ssm_d_inner
    ssm = (2 * kinds.count("mamba") * batch
           * (di * cfg.ssm_d_state * 4 + (cfg.ssm_d_conv - 1) * di * esz))
    state = " and ".join(
        text for n, text in ((kinds.count("attn"), "live KV"),
                             (kinds.count("mamba"), "the Mamba state read and written"))
        if n)
    nbytes = tree_sum(read, lambda t: t.nbytes) + kv + ssm + batch * cfg.d_model * esz
    flops = 2 * batch * tree_sum(read, lambda t: t.numel())
    t, by = bound(nbytes, flops, BF16_OPS_PER_S)
    extra = head.numel() * (4 - esz)
    return dict(decode_bound_ms=t, decode_bound_by=by, decode_bytes=nbytes,
                decode_state=state, fp32_head_extra_ms=extra / HBM_BYTES_PER_S * 1e3)


def tree_to(tree, device):
    """A copy of a parameter tree (dicts, lists, tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def check_model(torch, arch: str) -> dict:
    """``arch`` at full width and 2 layers, one seeded set of weights on
    the card and a copy on the CPU: decode of token S-1 against the prefill
    of S tokens on the card, and card against CPU logits and greedy tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    card = Model(cfg, device="cuda")
    params = card.init_params(0)
    host = tree_to(params, "cpu")
    cpu = Model(cfg, device="cpu")
    V, B, S = cfg.vocab_size, 2, 64
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(2, V, (B, S), generator=gen, dtype=torch.int32)
    lf, _, _ = card.prefill(params, {"tokens": toks}, S + 8)
    lp, cache, kvl = card.prefill(params, {"tokens": toks[:, :S - 1]}, S + 8)
    ld, _, _ = card.decode_step(params, cache, toks[:, S - 1].cuda(), kvl)
    err_dp = float((lf[:, :V] - ld[:, :V]).abs().max())
    require(err_dp <= LOGIT_TOL, f"model {arch}: decode vs prefill err {err_dp}")
    lc, cc, kc = card.prefill(params, {"tokens": toks}, S + 8)
    lh, ch, kh = cpu.prefill(host, {"tokens": toks}, S + 8)
    errs, agree, clear_n = [], 0, 0
    for step in range(5):
        a, b = lc[:, :V].cpu(), lh[:, :V]
        require(bool(torch.isfinite(a).all()), f"model {arch}: non-finite logits")
        errs.append(float((a - b).abs().max()))
        top2 = b.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
        require(torch.equal(a.argmax(1)[clear], b.argmax(1)[clear]),
                f"model {arch}: greedy tokens differ at step {step}")
        agree += int((a.argmax(1) == b.argmax(1)).sum())
        clear_n += int(clear.sum())
        tok = b.argmax(1).to(torch.int32)
        lc, cc, kc = card.decode_step(params, cc, tok.cuda(), kc)
        lh, ch, kh = cpu.decode_step(host, ch, tok, kh)
    require(max(errs) <= LOGIT_TOL, f"model {arch}: card vs CPU logits err {max(errs)}")
    log(f"model {arch}: 2-layer full width, decode vs prefill max |dlogit| {err_dp:.5f}; card vs "
        f"CPU max |dlogit| {max(errs):.5f} over prefill + 4 decode steps (tolerance "
        f"{LOGIT_TOL}); greedy tokens equal {agree}/{5 * B} ({clear_n} beyond the margin)")
    del card, params, cache, cc
    torch.cuda.empty_cache()
    return dict(decode_vs_prefill=err_dp, card_vs_cpu=max(errs))


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
    "gather_scores_masked": ("src/repro_torch/csrc/gather_scores.cu",
                             "src/repro/kernels/gather_scores.py:173"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_wgmma.cu",
                        "src/repro/kernels/flash_attention.py:117"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:103"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:81"),
}
# The row's own numbers come from the main path's shape and dtype; the
# others ride along under "variants". No single PyTorch call computes a
# selective scan, so mamba_scan's library_ms is null.
MAIN_KEY = {"flash_attention": ("serve", "bfloat16"),
            "decode_attention": ("serve", "bfloat16"),
            "mamba_scan": ("serve_prefill", "bfloat16")}
# The path whose run gives each kernel's launch count: the serve runs for
# the model's kernels, the main path for the cache's (gather_scores_masked
# is on neither and counts 0).
SERVE_KERNELS = {"flash_attention": "llama3.2-3b", "decode_attention": "llama3.2-3b",
                 "mamba_scan": "falcon-mamba-7b"}
# A kernel launched by more than one counted wrapper (by default its own):
# the scatter kernel by the delta flush's entry and the per-table one.
KERNEL_WRAPPERS = {"scatter_rows": ("scatter_flush", "scatter_rows")}


PHASES = ("build", "kernels", "index", "main", "parity", "serve")


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
    from repro_torch.kernels import _build, ops
    counters = {fn.__name__: fn for fn in ops.COUNTED}
    require(all(w in counters for k in KERNELS for w in KERNEL_WRAPPERS.get(k, (k,))),
            f"a kernel of {list(KERNELS)} has no counted wrapper in {list(counters)}")
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
            numbers.update(check_attention(torch, dev))
            numbers.update(check_mamba(torch, dev))
            log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
        if "index" in phases:
            t0 = time.perf_counter()
            check_index(torch)
            log(f"phase index: {time.perf_counter() - t0:.1f} s")
        if "main" in phases:
            t0 = time.perf_counter()
            launches, replayed = run_main_path(torch, counters, steps=400)
            log(f"phase main: {time.perf_counter() - t0:.1f} s; launches at wrapper calls "
                f"{launches}, in graph replays {replayed}")
        if "parity" in phases:
            t0 = time.perf_counter()
            check_card_vs_cpu(steps=50)
            log(f"phase parity: {time.perf_counter() - t0:.1f} s")
        if "serve" in phases:
            t0 = time.perf_counter()
            served = {}
            for arch in SERVE_ARCHS:             # one model on the card at a time
                served[arch] = run_serve(torch, counters, arch, n_requests=256)
                gc.collect()
                torch.cuda.empty_cache()
            same = ("served", "hit_rate", "model_tokens")
            require(all(served[a][k] == served[SERVE_ARCHS[0]][k]
                        for a in SERVE_ARCHS for k in same),
                    f"serve: counters differ between {SERVE_ARCHS}: "
                    f"{ {a: [served[a][k] for k in same] for a in SERVE_ARCHS} }")
            for arch in SERVE_ARCHS:
                check_model(torch, arch)
            log(f"phase serve: {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    if phases != set(PHASES):
        print("chip_smoke: partial run (--phases); no result", file=sys.stderr)
        return 4

    launches.update({k: served[arch]["launches"][k] for k, arch in SERVE_KERNELS.items()})
    replayed.update({k: served[arch]["replay_launches"][k]
                     for k, arch in SERVE_KERNELS.items()})
    fields = ("max_abs_err", "ms", "earlier_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "entry_set_ms", "earlier_entry_set_ms", "entry_set_bound_ms",
              "floor_ms", "earlier_floor_ms", "per_table_ms", "splits", "chunk", "chunk_ms")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        key = (name, *MAIN_KEY.get(name, ("float32",)))
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(launches[w] for w in KERNEL_WRAPPERS.get(name, (name,))),
               "replay_launches": replayed.get(name, 0)}
        row.update({f: numbers[key][f] for f in fields if f in numbers[key]})
        variants = {"_".join(k[1:]): {f: v[f] for f in fields if f in v}
                    for k, v in numbers.items() if k[0] == name and k != key}
        if variants:
            row["variants"] = variants
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
