#!/usr/bin/env python3
"""Drive repro_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py [--phases build,kernels,index,main,parity,serve]

Run from the root of a checkout: it puts ``src/`` on ``sys.path`` itself,
builds the CUDA kernels into ``build/repro_torch/`` with ``nvcc`` (sm_90a)
and needs one card. It imports nothing of JAX or of the ``repro`` package.
Phases (any failure exits non-zero and prints no result):

1. build   — compile ``src/repro_torch/csrc/*.cu`` (one nvcc per source);
2. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes: the cache kernels in fp32 and int8,
             the attention kernels in fp32 and bf16 at the serve shape and
             at a long one (prefill 4,096; decode 32,768, and decode 32,768
             with gemma2's window of 4,096), mamba_scan with fp32 and bf16
             x at falcon-mamba-7b's serve prefill (8 × 64 × 8192, N 16),
             its decode step (L 1, the state read from h0 and written back
             over it in place, held bit for bit against a separate h_out)
             and a long scan (1 × 4,096), with times (CUDA events around
             CUDA-graph replays), the plain version's time, the bound and
             the library call's time where one exists;
3. index   — ``HNSWIndex.bulk_build`` of 100,000 Table-1 vectors at
             capacity 131,072: searches of 8, a delta flush, searches again,
             the kernel path against the plain path on the card;
4. main    — ``SemanticCache`` at capacity 1,048,576 for {hnsw, flat} x
             {float32, int8}, serving Table-1 traffic in batches of 8
             (lookup_batch, then insert_batch of the misses); every kernel
             the path uses must have launched;
5. parity  — the same traffic at capacity 16,384, card against CPU: equal
             decisions, except queries within 1e-5 of their τ;
6. serve   — ``launch.serve.run_serving``: 256 Table-1 requests through
             the cache (hnsw, fp32, device search) in front of
             llama3.2-3b at full width and depth (seeded random bf16
             weights), batch 8, prompt 64, 16 new tokens; the attention
             kernels must have launched. Then the same run in front of
             falcon-mamba-7b at full width and depth (64 Mamba layers,
             d_inner 8192): mamba_scan must have launched 64 times per
             prefill and decode step, and the served, hit and model-token
             counters must equal llama's (hits depend only on the text).
             Then each model at full width and 2 layers: decode against
             prefill, and card against CPU.

The last lines are a ``{"kernels": [...]}`` object, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
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
        errs_fh, errs_gs, errs_gm = [], [], []
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
            # the masked gather: the plain version's -inf pattern, and
            # gather_scores's bits wherever the category test passes
            m_k = gs.gather_scores_masked(table, idx, q, cats, qc, scales)
            m_p = gs.gather_scores_masked_plain(table, idx, q, cats, qc, scales)
            errs_gm.append(max_err(m_k, m_p, torch))
            passed = torch.isfinite(m_k)
            require(torch.equal(m_k[passed], g_k[passed]),
                    f"gather_scores_masked and gather_scores differ ({dtype})")
        err_fh, err_gs, err_gm = max(errs_fh), max(errs_gs), max(errs_gm)
        require(err_fh <= SCORE_ATOL, f"frontier_hop {dtype}: err {err_fh}")
        require(err_gs <= SCORE_ATOL, f"gather_scores {dtype}: err {err_gs}")
        require(err_gm <= SCORE_ATOL, f"gather_scores_masked {dtype}: err {err_gm}")
        # This run's data: live lanes of every variant, unique rows read.
        row_b = D * 4 if scales is None else D + 4
        hop_bytes, hop_ops, g_bytes, g_ops, m_bytes, m_ops = [], [], [], [], [], []
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
            qce = qc[:, None].expand_as(idx)
            ok = (idx >= 0) & ((qce < 0) | (cats[idx.clamp(min=0).long()] == qce))
            ml = idx[ok]
            m_bytes.append(ml.unique().numel() * row_b + gl.unique().numel() * 4
                           + idx.numel() * 8 + q.numel() * 4 + B * 4)
            m_ops.append(2 * D * ml.numel())
        hop_fns = [lambda v=v: fh.frontier_hop(table, nbrs, meta, v[0], v[1], v[2],
                                               v[3], scales) for v in variants]
        hop_plain = [lambda v=v: fh.frontier_hop_plain(table, nbrs, meta, v[0], v[1],
                                                       v[2], v[3], scales)
                     for v in variants]
        g_fns = [lambda v=v: gs.gather_scores(table, v[4], v[1], scales)
                 for v in variants]
        g_plain = [lambda v=v: gs.gather_scores_plain(table, v[4], v[1], scales)
                   for v in variants]
        m_fns = [lambda v=v: gs.gather_scores_masked(table, v[4], v[1], cats, v[2], scales)
                 for v in variants]
        m_plain = [lambda v=v: gs.gather_scores_masked_plain(table, v[4], v[1], cats, v[2],
                                                             scales) for v in variants]
        b_hop = bound(statistics.mean(hop_bytes), statistics.mean(hop_ops))
        b_g = bound(statistics.mean(g_bytes), statistics.mean(g_ops))
        b_m = bound(statistics.mean(m_bytes), statistics.mean(m_ops))
        out[("frontier_hop", dtype)] = dict(
            max_abs_err=err_fh, ms=graph_ms(torch, hop_fns),
            plain_ms=graph_ms(torch, hop_plain), bound_ms=b_hop[0],
            bound_by=b_hop[1], library_ms=None,
            bytes=statistics.mean(hop_bytes))
        out[("gather_scores", dtype)] = dict(
            max_abs_err=err_gs, ms=graph_ms(torch, g_fns),
            plain_ms=graph_ms(torch, g_plain), bound_ms=b_g[0],
            bound_by=b_g[1], library_ms=None, bytes=statistics.mean(g_bytes))
        out[("gather_scores_masked", dtype)] = dict(
            max_abs_err=err_gm, ms=graph_ms(torch, m_fns),
            plain_ms=graph_ms(torch, m_plain), bound_ms=b_m[0],
            bound_by=b_m[1], library_ms=None, bytes=statistics.mean(m_bytes))
        for name in ("frontier_hop", "gather_scores", "gather_scores_masked"):
            log(f"kernels: {name} {dtype} {out[(name, dtype)]}")
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
# falcon-mamba-7b: d_inner 8192, d_state 16; serve batch 8, prompt 64.
DI, NS = 8192, 16


def scan_inputs(torch, gen, dev, Bt, L, dtype):
    """Inputs at the model's scales: x ~ N(0, 0.25), dt log-uniform in
    [1e-3, 0.1] (its softplus(dt_bias) init), A = -exp(U(log 0.5, log 16)),
    B, C ~ N(0, 1), D ~ N(0, 1), h0 ~ N(0, 0.01)."""
    import math

    def u(*shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    x = (torch.randn((Bt, L, DI), generator=gen, device=dev) * 0.5).to(dtype)
    dt = torch.exp(u(Bt, L, DI, lo=math.log(1e-3), hi=math.log(0.1)))
    A = -torch.exp(u(DI, NS, lo=math.log(0.5), hi=math.log(16.0)))
    B = torch.randn((Bt, L, NS), generator=gen, device=dev)
    C = torch.randn((Bt, L, NS), generator=gen, device=dev)
    D = torch.randn((DI,), generator=gen, device=dev)
    h0 = torch.randn((Bt, DI, NS), generator=gen, device=dev) * 0.1
    return x, dt, A, B, C, D, h0


def check_mamba(torch, dev) -> dict:
    """mamba_scan against its plain version at the serve prefill (no h0),
    the serve decode step (h0 aliased with h_out) and a long scan, with
    fp32 and bf16 x; a prefill with h0 and the aliased decode are also held
    bit for bit against the same call with a separate h_out."""
    from repro_torch.kernels import mamba_scan as ms
    gen = torch.Generator(device=dev)
    gen.manual_seed(2028)
    out = {}
    for label, Bt, L, with_h0 in (("serve_prefill", 8, 64, False),
                                  ("serve_decode", 8, 1, True), ("long", 1, 4096, False)):
        for dtype in (torch.float32, torch.bfloat16):
            sets = [scan_inputs(torch, gen, dev, Bt, L, dtype)
                    for _ in range(2 if L < 1024 else 1)]
            err = 0.0
            for x, dt, A, B, C, D, h0 in sets:
                starts = (h0,) if with_h0 else (None, h0) if L < 1024 else (None,)
                for start in starts:
                    y_k, h_k = ms.mamba_scan(x, dt, A, B, C, D, start)
                    y_p, h_p = ms.mamba_scan_plain(x, dt, A, B, C, D, start)
                    torch.cuda.synchronize()
                    err = max(err, attn_close(torch, y_k, y_p, SCAN_ATOL, "mamba_scan y"),
                              attn_close(torch, h_k, h_p, SCAN_ATOL, "mamba_scan h"))
                    if start is None:
                        continue
                    state = start.clone()                 # h_out over h0, in place
                    y_a, h_a = ms.mamba_scan(x, dt, A, B, C, D, state, h_out=state)
                    torch.cuda.synchronize()
                    require(h_a.data_ptr() == state.data_ptr()
                            and torch.equal(y_a, y_k) and torch.equal(state, h_k),
                            f"mamba_scan {label}: aliased h0/h_out differs from a "
                            f"separate h_out")
            esz = sets[0][0].element_size()
            n = Bt * L * DI
            nbytes = (n * (2 * esz + 4) + 2 * Bt * L * NS * 4 + DI * (NS + 1) * 4
                      + Bt * DI * NS * 4 * (2 if with_h0 else 1))
            b_s = bound(nbytes, 7 * n * NS)
            if with_h0:
                fns = [lambda s=s: ms.mamba_scan(*s, h_out=s[6]) for s in sets]
                plain = [lambda s=s: ms.mamba_scan_plain(*s) for s in sets]
            else:
                fns = [lambda s=s: ms.mamba_scan(*s[:6]) for s in sets]
                plain = [lambda s=s: ms.mamba_scan_plain(*s[:6]) for s in sets]
            key = ("mamba_scan", label, str(dtype)[6:])
            out[key] = dict(max_abs_err=err, ms=graph_ms(torch, fns),
                            plain_ms=graph_ms(torch, plain, replays=5 if L > 1024 else 15),
                            bound_ms=b_s[0], bound_by=b_s[1], library_ms=None,
                            bytes=nbytes, ops=7 * n * NS)
            log(f"kernels: mamba_scan {label} Bt={Bt} L={L} Dm={DI} N={NS} {dtype} "
                f"{out[key]}")
            del sets
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


class ModelTimer:
    """CUDA events around every ``Model.prefill`` and ``Model.decode_step``
    (read after the run, so the serve loop never waits for them), and one
    call of each (the fourth) under torch.profiler instead."""

    def __init__(self, torch, model_cls):
        self.torch, self.cls = torch, model_cls
        self.events = {"prefill": [], "decode_step": []}
        self.calls = {"prefill": 0, "decode_step": 0}
        self.profiles = {}
        self.params = None
        self._orig = {}

    def __enter__(self):
        for name in self.events:
            self._orig[name] = getattr(self.cls, name)
            setattr(self.cls, name, self._wrap(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.cls, name, orig)

    def _wrap(self, name, orig):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        def call(model, params, *args, **kw):
            self.params = params
            self.calls[name] += 1
            if len(self.events[name]) == 3 and name not in self.profiles:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    out = orig(model, params, *args, **kw)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                self.profiles[name] = kernel_summary(torch, prof, wall_us)
                return out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(model, params, *args, **kw)
            end.record()
            self.events[name].append((start, end, int(out[0].shape[0])))
            return out
        return call

    def ms(self, name) -> list[float]:
        return [s.elapsed_time(e) for s, e, _ in self.events[name]]


def run_serve(torch, counters, arch: str, n_requests: int) -> dict:
    """The port's run_serving on the card: ``arch`` at full width and
    depth, seeded random weights drawn on the device, SemanticCache (hnsw,
    fp32, device search) with Table-1 traffic, batch 8, prompt 64, 16 new
    tokens. Every kernel of the model's path must have launched: the
    attention kernels for a dense model, mamba_scan once per layer of
    every prefill and decode step for an ssm one."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serving
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with ModelTimer(torch, Model) as timer:
        t0 = time.perf_counter()
        out = run_serving(cfg, n_requests=n_requests, max_batch=8, prompt_len=64,
                          max_new_tokens=16, seed=0, index_kind="hnsw",
                          use_device=True, emb_dtype="float32", telemetry=True,
                          device="cuda", log=lambda m: log(f"serve {arch}: {m}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    path = (("flash_attention", "decode_attention") if cfg.family == "dense"
            else ("mamba_scan",))
    for k in path + ("frontier_hop", "gather_scores"):
        require(counts[k] > 0, f"serve {arch}: {k} never launched")
    if cfg.family == "ssm":
        calls = timer.calls["prefill"] + timer.calls["decode_step"]
        require(counts["mamba_scan"] == cfg.n_layers * calls,
                f"serve {arch}: mamba_scan launched {counts['mamba_scan']} times, "
                f"not {cfg.n_layers} per prefill and decode step ({calls})")
    peak = torch.cuda.max_memory_allocated()
    snap = out["per_category"]
    misses = round(out["served"] * (1 - out["hit_rate"]))
    require(out["served"] == n_requests, f"serve {arch}: not every request was served")
    require(out["model_tokens"] == 16 * misses and misses > 0,
            f"serve {arch}: every miss must generate 16 model tokens")
    pre, dec = timer.ms("prefill"), timer.ms("decode_step")
    batches = [b for *_, b in timer.events["decode_step"]]
    dec_s = sum(dec) / 1e3
    step = decode_step_bound(timer.params, cfg, statistics.mean(batches), prompt_len=64,
                             new_tokens=16)
    numbers = dict(
        served=out["served"], hit_rate=out["hit_rate"], model_tokens=out["model_tokens"],
        model_batches=timer.calls["prefill"], decode_steps=timer.calls["decode_step"],
        prefill_ms_p50=float(np.percentile(pre, 50)),
        prefill_ms_p99=float(np.percentile(pre, 99)),
        decode_ms_p50=float(np.percentile(dec, 50)),
        decode_ms_p99=float(np.percentile(dec, 99)),
        decode_tokens_per_s=sum(batches) / dec_s,
        tokens_per_s=out["model_tokens"] / wall, wall_s=wall,
        peak_gib=peak / 2**30, launches=counts, **step)
    rates = {c: round(row["hit_rate"], 4) for c, row in sorted(snap.items())
             if "hit_rate" in row}
    log(f"serve {arch}: {out['served']} served, {misses} served by the model, "
        f"{out['model_tokens']} model tokens; hit rates {rates}")
    log(f"serve {arch}: prefill ms per batch p50 {numbers['prefill_ms_p50']:.3f} p99 "
        f"{numbers['prefill_ms_p99']:.3f} ({len(pre)} timed of {timer.calls['prefill']}); "
        f"decode ms per token p50 {numbers['decode_ms_p50']:.3f} p99 "
        f"{numbers['decode_ms_p99']:.3f} ({len(dec)} timed of "
        f"{timer.calls['decode_step']}, mean batch {statistics.mean(batches):.2f})")
    log(f"serve {arch}: {numbers['decode_tokens_per_s']:.1f} decode tokens/s, "
        f"{numbers['tokens_per_s']:.1f} model tokens/s over {wall:.2f} s wall; "
        f"peak device memory {numbers['peak_gib']:.2f} GiB; launches {counts}")
    log(f"serve {arch}: decode step bound {step['decode_bound_ms']:.4f} ms, "
        f"{step['decode_bound_by']} ({step['decode_bytes'] / 1e9:.4f} GB at the mean "
        f"batch: bf16 layers, bf16 head, {step['decode_state']}); the fp32 head copy "
        f"the port reads instead adds {step['fp32_head_extra_ms']:.4f} ms")
    for name, text in timer.profiles.items():
        log(f"serve {arch}: profile of one {name}: {text}")
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
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flat_topk import flat_topk
    from repro_torch.kernels.frontier_hop import frontier_hop
    from repro_torch.kernels.gather_scores import gather_scores, gather_scores_masked
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.scatter_update import scatter_rows
    counters = {"frontier_hop": frontier_hop, "gather_scores": gather_scores,
                "flat_topk": flat_topk, "scatter_rows": scatter_rows,
                "gather_scores_masked": gather_scores_masked,
                "flash_attention": flash_attention, "decode_attention": decode_attention,
                "mamba_scan": mamba_scan}
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
            launches = run_main_path(torch, counters, steps=400)
            log(f"phase main: {time.perf_counter() - t0:.1f} s; launches {launches}")
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
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "splits", "chunk", "chunk_ms")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        key = (name, *MAIN_KEY.get(name, ("float32",)))
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name]}
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
