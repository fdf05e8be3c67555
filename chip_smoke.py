#!/usr/bin/env python3
"""Drive repro_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py [--phases build,contracts,kernels,index,main,parity,shard,sim,
                                    serve,encdec_vlm,train,dist,dist_serve]

Run from the root of a checkout: it puts ``src/`` on ``sys.path`` itself,
builds the CUDA kernels into ``build/repro_torch/`` with ``nvcc`` (sm_90a)
and needs one card. It imports nothing of JAX or of the ``repro`` package.
Phases (any failure exits non-zero and prints no result):

1. build   — compile ``src/repro_torch/csrc/*.cu`` (one nvcc per source);
   contracts — ``python -m repro_torch.analysis.check``'s sections on the
             card: the op-trace rules on {flat, hnsw} x {fp32, int8} (the
             searches under ``torch.cuda.set_sync_debug_mode("error")``),
             the compile budget (captures per batch bucket and shard), the
             mirror and span lints; the caching allocator's peak around
             one eager search and one delta flush of each cell (no
             (B, F·M, d) fp32 gather, no fp32 copy of an int8 table, no
             copy of a whole table); and the kernel budgets: each entry
             function's registers × block threads <= 65,536, static +
             dynamic shared memory <= the card's opt-in limit and no
             spill, from this build's ``-Xptxas -v`` report, with each
             cache kernel launched at the reference's shape families
             (flat_topk N 4,096 / 65,536 / 1,048,576 x B 8 / 128,
             gather_scores(_masked) B 8 K 256 and B 128 K 1,024,
             frontier_hop B 8 / 128 F = M = 32, scatter_rows R 8 / 1,024
             / 8,192; fp32 and int8) against its plain version;
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
             gemma2's window of 4,096; both also at granite-moe's serve
             shape, bf16, dh 64 over 24 / 8 heads; flash_attention fp32 and
             bf16 also at whisper's encoder (B 8, 20 heads, 1,500 x 1,500,
             dh 64, non-causal), its cross-attention at prefill (64 queries
             against 1,500 keys), at a decode step (Sq 1) and its causal
             self-attention (64 x 64), and llava's causal prefill (B 8,
             2,944, 32 / 8 heads, dh 128); decode_attention at whisper's
             decode step, 20 / 20 heads, at kv_len 1,500 as the yardstick
             of the Sq 1 cross call, and at llava's decode step, 32 / 8
             heads, dh 128, kv_len 2,945 to 2,960), mamba_scan with fp32 and bf16 x at
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
6. serve   — first the MoE FFN on the card: the routed path
             (``torch._grouped_mm``) against the dense exact one (every
             expert in fp32) on seeded bf16 inputs at granite-moe's layer
             (T 512, a prefill; T 8, a decode step) and jamba's (T 128),
             each timed beside the dense path and its bound, and route's
             ties (duplicated router columns) going to the lower expert.
             Then ``launch.serve.run_serving``: 256 Table-1 requests through
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
             decode step), and in front of granite-moe-3b-a800m at full
             width and depth (32 layers, each attention at dh 64 and an
             MoE FFN of 40 experts, top 8: flash_attention and
             decode_attention 32 times per prefill and decode step; its
             decode step bound counts the experts a batch reaches); the
             served, hit and model-token counters must equal llama's (hits
             depend only on the text). For each
             model the graphs' tokens for a batch of 8 and one of 3 must
             equal the eager prefill/decode_step loop's. Then 64 requests
             in front of llama3.2-3b behind a flat cache of 4 shards and
             of one: the same counters. Then each model at full width and
             2 layers: decode against prefill, and card against CPU (an
             MoE model's second computation takes the first's expert
             choices, and every choice it would have made otherwise must
             be a near tie: ``Routing``). Last, jamba at full width and one
             period of 8 layers (Mamba x 4, attention, Mamba x 3, MoE of 16
             experts top 2 on the odd layers), on the card only: decode
             against prefill, 4 greedy decode steps with finite logits,
             mamba_scan 7 times per prefill and decode step,
             flash_attention once per prefill, decode_attention once per
             decode step, and its peak memory;
7. shard   — ``ShardedSemanticCache`` of 4 shards at capacity 1,048,576
             (each shard's table too), main's traffic and combinations:
             the first 50 steps, a live ``migrate_category`` of
             code_generation to another shard and ``rebalance()`` back,
             each followed by 64 probe queries of it (on flat decided as
             before the move; an HNSW shard's graph changes with the
             move, so hnsw only logs how many differ), the last 50
             steps (cut from 100 each for the time limit). Launches per shard as in main, summed over the shards
             (each shard captures a graph per batch bucket its
             sub-batches reach); a profiled sharded lookup's trace holds
             the launches its replays recorded. Flat decides as one cache
             does; hnsw, probes included, as the same 4-shard run on the
             CPU, except within 1e-5 of τ. The flat move again at 1,024
             rows a shard, where it uploads in full: every dropped graph
             replayed after was captured anew, and the probes decide as
             before the move. Then two fault runs: a
             replicated head category with its primary down (failover,
             no degraded read, every queued write replayed), and an
             unreplicated category's shard down past
             ``rebalance_after_s`` (rebuilt on a live shard, then home).
             The move at 1,024 rows and the fault runs take 400 steps (the
             move must pass the rebuild threshold; the faults end 60 s
             into the traffic);
8. sim     — ``ServingSimulator`` (hybrid, device search, the long-tail
             benchmark's configuration: capacity 12,000, 4,000 Table-1
             queries, seed 42) for {hnsw, flat} x {1, 4} shards on the
             card: launches as in main; flat equal to the same runs on
             the CPU and 4 shards to one; hybrid against the vector DB
             and no cache as the reference's simulator tests hold them;
9. encdec_vlm — whisper-large-v3 (32 encoder + 32 decoder layers, d
             1,280, 20 / 20 heads, dh 64) and llava-next-mistral-7b (32
             layers, d 4,096, 32 / 8 heads, dh 128, 2,880 patches) at full
             width and depth, seeded bf16 weights, through the model
             facade (the engine passes no audio or patches): 64 text
             tokens, 16 new, at batch 8 and 3, whisper with audio (B, 1,500,
             1,280), llava with patches (B, 2,880, 4,096). Prefill and
             decode steps replay graphs (``core/graphs.py``) through the
             port's ``serving.engine.generate``, timed by CUDA events, the
             first replay of each graph traced; a whisper prefill records
             96 flash_attention launches (32 encoder, 32 self, 32 cross)
             and a decode step 32
             flash_attention (cross, Sq 1) and 32 decode_attention, a
             llava prefill 32 flash_attention (kv_len 2,944 after it) and a
             decode step 32 decode_attention; graph tokens equal the eager
             loop's; peak memory and the decode step's bound logged. Then
             each at full width and 2 layers, decode against prefill and
             card against CPU within 0.1 (llava's CPU side over 576
             patches).
10. train  — training through the port's train step (loss, autograd,
             AdamW in place). First the kernels' autograd Functions:
             FlashAttentionFn at llama3.2-3b's training attention (B 8,
             24 / 8 heads, S 512, dh 128, causal) and whisper's encoder
             (B 8, 20 / 20, 1,500, dh 64, non-causal), MambaScanFn at
             falcon-mamba-7b's training scan (8 × 128 × 8,192, N 16) and a
             short one with h0, fp32 and bf16: the forward equal to the
             kernel's output bit for bit and held against the plain
             version (as in ``kernels``), gradients against autograd of
             the plain version (fp32 within 1e-4, bf16 within 2^-6 of each
             input's largest |grad|) and, fp32, against a central
             difference of the kernel's own forward (FD_TOL); the forward
             timed beside its bound, the plain version's (and SDPA's), and
             forward + backward beside theirs. Then llama3.2-3b,
             falcon-mamba-7b and granite-moe-3b-a800m at full width and 2
             layers, card against CPU: loss within 0.1, every gradient
             leaf within 0.1 of its largest (granite's CPU run on the
             card's expert choices, forward and remat's recompute, each
             own choice that differs a near tie: ``Routing``). Then
             llama3.2-3b at full width and depth (28 layers, remat "dots",
             fp32 moments, B 8 × S 512 packed batches; one warm-up and 5
             timed steps), falcon-mamba-7b at full width and 8 of its 64
             layers (B 8 × S 128, 3 timed steps; 64 layers' bf16 weights
             and grads and fp32 moments, ≈ 87 GB, do not fit the card) and
             granite-moe-3b-a800m at full width and depth (32 layers, 40
             experts top-8 through ``GroupedMmFn``, B 8 × S 512, 3 timed
             steps): step ms, tokens/s, peak memory, the bound (an MoE
             layer's experts counted at the k of E a token reaches),
             finite losses, changed parameters, and flash_attention /
             mamba_scan launched twice per layer a step (forward and
             remat's recompute); one more step split into loss + backward
             and AdamW, and one profiled. Then jamba's 8-layer period at
             full width (d 4,096, 16 experts top-2, attention at layer 4),
             B 2 × S 64, loss and gradients only (no room for AdamW's
             state beside 27 GB of weights and as much of gradients):
             every leaf's gradient finite and none missing, mamba_scan 14
             and flash_attention 2 launches (remat), loss + backward ms
             and peak memory; one jamba MoE layer's gradients at T 128
             (x, router, each expert matrix) through ``GroupedMmFn``
             against autograd of the dense exact path, each within 2^-6
             of its largest |grad|; the backward's two products at
             granite's training shape (the transposed weights as a view,
             the weight gradient as one 2-D × 2-D product) against an
             fp32 loop, experts without rows zero, timed beside a
             contiguous copy and one ``mm`` per expert. Last, resume on
             the card (2 layers, full width, int8 moments: 6 steps
             straight against 3 + restart + 3, losses within 2e-2) and a
             checkpoint snapshot that survives an in-place change; and
             whether the card's ``torch._grouped_mm`` differentiates by
             itself, with the error where it does not.

11. dist   — distribution, four ranks on the one card over gloo
             (``launch.mesh.launch_ranks``; gloo stages every CUDA buffer
             through host memory, so its times are not a four-card
             deployment's). First FlashAttentionFn at a rank's local
             heads (B 4, 12 / 4, 512 causal, dh 128) as in ``train``.
             Then on (data 2, model 2), seeded bf16 weights: llama3.2-3b
             at full width and 4 of 28 layers (cut for the time limit),
             B 8 × S 512 — the sharded loss and every gathered gradient
             leaf against the one-process card run (0.1, ``train``'s
             tolerances), each rank's blocks' bytes equal to the plan's
             share, 2 timed train steps (step ms, peak GiB per rank,
             flash_attention 8 launches a step a rank: 4 layers × 2 with
             remat, the host seconds in the staged transfers
             (``time_collectives``)) and the gathered parameters after
             them against the one-process steps (each leaf's update within
             DIST_UPDATE_REL, each step's grad norm within
             DIST_GNORM_REL); granite-moe-3b-a800m at full width and 4
             of 32 layers, B 8 × S 128 (cut for the time limit), through
             ``moe_ffn_ep`` at capacity 8.0: 2 ``TrainStep`` steps (the EP backward through ``GroupedMmFn``
             and the all-to-alls), no pair dropped in any EP call, each
             step's loss within 0.1 and grad norm within DIST_GNORM_REL
             of the one-process routed steps, each leaf's update within
             DIST_UPDATE_REL, step ms, staged ms and calls; its forward
             loss at the config's 1.5 (drops counted); and one layer's
             EP FFN with its router biased to data shard 0, card against
             the same run on 4 CPU gloo ranks: equal drops and kept masks
             (``moe.kept_pairs`` on the ids each ``_moe_local`` call
             took), outputs within DIST_FFN_REL of max |y|. Then a GPipe
             of the 4-layer llama on (pod 2, data 1, model 2), 4
             microbatches: the loss within 2e-3 of the sequential loss,
             and ``loss.backward()`` on every rank (the reverse drain):
             the gathered gradients within 0.1 (||dg|| / ||g|| per leaf)
             of the sequential one-process gradients, forward and
             backward ms with their staged ms and calls, flash_attention
             8 launches a rank forward and 8 in remat's recompute. Logs
             the calls gloo staged.
12. dist_serve — sharded serving, four gloo ranks on the one card, (data
             2, model 2), seeded bf16 weights in the serving plan. First
             decode_attention on 4 sequence blocks of a cache (the
             sequence-sharded layout; ``first_row`` and ``return_lse``) at
             llama's serve shape and at 32,768 rows with a window of 4,096:
             each block against the plain version, the blocks merged
             (``merge_partials``) against one call over every row and the
             plain version, one block timed; mamba_scan at Dm 4,096 (a
             model rank's channels). Then the meshed engine
             (``run_serving(dist=...)``): rank 0's HNSW cache in front of
             llama3.2-3b at full width and depth, 64 Table-1 requests,
             batch <= 8, prompt 64, 16 new tokens (odd miss batches take
             the sequence-sharded cache), generation eager (gloo stages
             through host, so no graph): its counters equal the
             one-process engine's on the same requests, every rank ends
             with the same tokens, every step's logits within 0.1 of the
             one-process model teacher-forced on the engine's tokens and
             every greedy token that differs a near tie. Then, at full
             width with the depth cut for the time limit (granite-moe 4
             layers, falcon-mamba 4, whisper 4 + 4, llava 4 at B 2 with
             2,880 patches, jamba's 8-layer period, each rank drawing its
             blocks a layer at a time), a prefill of 64 and 4 decode steps
             at B 8 and 3 against the one-process card run within 0.1, MoE
             choices forced onto its (own choices that differ near ties)
             at capacity 8.0, where EP drops nothing (one process has no
             capacity), each MoE layer's dispatch equal to the reference's
             rule, the drops at the config's capacity counted from the same
             routing. Last, one sharded falcon-mamba-7b train step
             (4 layers, B 8 x S 128) against one process: loss within 0.1,
             each gradient leaf within 0.1 of its largest. Logs per rank
             prefill and decode ms, peak GiB, the staged transfers' count
             and ms by operation, the launches per call.

The last lines are a ``{"kernels": [...]}`` object (``registers``,
``smem_static`` and ``spill_bytes``: the ``contracts`` phase's, from this
build's report, the most over the kernel's entry functions; ``launches``: those
made at wrapper calls in the run of the kernel's path; ``replay_launches``:
those its graphs' replays made, each graph's recorded launches times its
replays; for the cache kernels also ``shard`` and ``sim``, the same counts
in the 4-shard card runs of phase 7, with ``per_shard`` replays (delta
flushes for scatter_rows), and in the hybrid card runs of phase 8; for
the model kernels ``serve``, the same two counts in each served model's
run that launched it, ``encdec_vlm``, those of phase 9's runs, and
``train``, those of phase 10's timed steps (llama3.2-3b, falcon-mamba-7b,
granite-moe-3b-a800m) and of jamba's period's loss and backward, for
flash_attention
``dist``, those of phase 11's ranks' timed steps, and ``dist_serve``,
those of phase 12's meshed serving summed over its ranks), the
card's name and power limit from nvidia-smi, and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

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


@functools.cache
def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return smi.stdout.strip().splitlines()[0]


def log_card(msg: str) -> None:
    """``log`` with the card's name and power limit."""
    log(f"{msg} [{card_name()}]")


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


# ------------------------------------------------------------ phase contracts
def alloc_growth(torch, fn) -> int:
    """Bytes the caching allocator held at its peak during ``fn()`` beyond
    what it held before: an upper bound on any one allocation ``fn`` made."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_stats()["allocated_bytes.all.current"]
    fn()
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["allocated_bytes.all.peak"] - base


def eager_search(torch, index, B: int = 8):
    """The index's classified search run eagerly (no graph) on its device
    tables, inputs on the card beforehand: ``fn()`` for ``alloc_growth``."""
    import numpy as np
    from repro_torch.core import hnsw as H
    t = index.device_tables()
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, index.dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    dev = index.device
    q = torch.from_numpy(q).to(dev)
    tau = torch.full((B,), 0.9, device=dev)
    qc = (torch.arange(B, device=dev) % 2).to(torch.int32)
    ttl = torch.full((B,), 60.0, device=dev)
    now = torch.zeros((), device=dev)
    if isinstance(index, H.FlatIndex):
        return lambda: H._flat_search_classified(t["emb"], t["valid"], t["category"],
                                                 t["inserted"], q, tau, qc, ttl, now,
                                                 t.get("scale"))
    p = index.p
    return lambda: H.beam_search_classified(
        t["emb"], t["neighbors"], t["valid"], t["entries"], t["inserted"], q, tau, ttl, now,
        t["category"], qc, t.get("scale"), beam=p.beam, max_hops=p.max_hops,
        hop_impl="fused")


def check_allocations(torch) -> None:
    """The caching allocator's evidence beside the op-trace rules, for each
    contract cell: an eager search allocates less than B·F·M·d·4 bytes at
    its peak (no (B, F·M, d) fp32 gather; for flat, B·N·d·4), an int8
    search less than N·d·4 (no fp32 copy of its table), and a delta flush
    less than its embedding table (no copy of a whole table)."""
    import numpy as np
    from repro_torch.analysis import contracts
    for kind in ("flat", "hnsw"):
        for dtype in ("float32", "int8"):
            idx = contracts.build_index(kind, dtype, device="cuda")
            search = eager_search(torch, idx)
            search()                                   # warm: cuBLAS, the build
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                grew = alloc_growth(torch, search)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            N, d = idx.capacity, idx.dim
            K = N if kind == "flat" else idx.p.beam * idx.p.M0
            limit = 8 * K * d * 4
            if dtype == "int8":
                limit = min(limit, N * d * 4)
            require(grew < limit, f"contracts {kind}/{dtype}: an eager search's allocations "
                                  f"peaked {grew} bytes above the start (limit {limit})")
            table = idx.device_tables()["emb"].nbytes
            rng = np.random.default_rng(6)
            vecs = rng.standard_normal((8, d)).astype(np.float32)
            idx.add_batch(vecs / np.linalg.norm(vecs, axis=1, keepdims=True),
                          np.zeros(8, np.int32))
            before = idx.sync_stats["delta_updates"]
            flush_grew = alloc_growth(torch, idx.device_tables)
            require(idx.sync_stats["delta_updates"] == before + 1,
                    f"contracts {kind}/{dtype}: the flush was not a delta")
            require(flush_grew < table, f"contracts {kind}/{dtype}: a delta flush's "
                                        f"allocations peaked {flush_grew} bytes (its table "
                                        f"is {table})")
            log(f"contracts {kind}/{dtype}: eager search peak +{grew} B (limit {limit}), "
                f"delta flush peak +{flush_grew} B (table {table} B), searches under "
                f"sync debug \"error\"")


def run_contracts_phase(torch, dev) -> dict:
    """``python -m repro_torch.analysis.check``'s sections on the card (the
    op-trace rules with the searches under sync debug "error", the compile
    budget with the captures counted, the two lints), the allocator's
    evidence (``check_allocations``) and the kernel budgets: every entry
    function's registers, static shared memory and spills from this
    build's ``-Xptxas -v`` report against the card's limits, and each
    cache kernel at the reference's shape families (``smem.SHAPE_FAMILIES``,
    fp32 and int8) against its plain version. Returns each kernel row's
    ``registers``, ``smem_static`` and ``spill_bytes``."""
    from repro_torch.analysis import check, smem
    viols = []
    for title, fn, _ in check.SECTIONS:
        log(f"contracts [{title}]")
        viols += fn("cuda", log)
    require(not viols, "contracts: " + "; ".join(str(v) for v in viols))
    check_allocations(torch)
    resources = smem.parse_ptxas(smem.build_log().read_text())
    budgets = {name: smem.kernel_resources(resources, name) for name in KERNELS}
    for name, b in budgets.items():
        log(f"contracts: {name} (most over its entry functions) {b['registers']} registers, "
            f"{b['smem_static']} B static smem, {b['spill_bytes']} B spills")
    for k in resources:
        if k.spill_bytes:
            log(f"contracts: spill {k.source}:{k.entry} {k.spill_bytes} B: "
                f"{smem.SPILL_REASONS[k.entry]}")
    return budgets


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


def flash_close(torch, fa, q, k, v, what: str = "flash_attention", got=None, **kw
                ) -> float:
    """The flash kernel's output (``got``, else a call made here) against
    the fp32 oracle on the same inputs. fp32 within SCORE_ATOL; bf16
    (tensor cores, probabilities rounded to bf16 before P·V) per element
    within 2^-7·max(|got|, |want|) + 2^-7·(P·|V|) + SCORE_ATOL, P·|V|
    being the oracle on |V|."""
    from repro_torch.kernels.ref import bf16_probability_tol
    if got is None:
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


def flash_work(B, Hq, Hkv, Sq, Skv, dh, causal, esz) -> tuple[int, int]:
    """(bytes, flops) of one flash_attention call: q, k, v read and the
    output written once; QK^T and PV over the attended pairs (Sq == Skv
    when causal)."""
    nbytes = esz * (2 * B * Hq * Sq * dh + 2 * B * Hkv * Skv * dh)
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    return nbytes, 4 * B * Hq * dh * pairs


def sdpa(q, k, v, *, causal, mask=None):
    """The library yardstick: PyTorch's scaled_dot_product_attention on the
    same inputs (timed here only; the port never calls it)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=causal,
                                          enable_gqa=True)


def sdpa_ms(torch, q, k, v, *, causal, mask=None) -> float:
    """One ``sdpa`` call's device time."""
    return graph_ms(torch, [lambda: sdpa(q, k, v, causal=causal, mask=mask)])


# flash_attention's timed shapes: (label, B, Hq, Hkv, Sq, Skv, dh, causal,
# dtypes, generator). llama's serve shape and a long prefill; granite-moe's
# serve shape (bf16, dh 64); whisper-large-v3's (20 / 20 heads, dh 64,
# 1,500 encoder frames: the encoder, the cross-attention of a prefill and
# of a decode step, Sq 1 as in the reference, and the decoder's causal
# self-attention) and llava-next-mistral-7b's prefill (32 / 8 heads, dh
# 128, 2,880 patches + 64 tokens). Each generator draws its rows' inputs
# in this order, so a row added to one leaves the others' inputs as they
# were.
FLASH_SHAPES = (
    ("serve", 8, HQ, HKV, 64, 64, DH, True, ("float32", "bfloat16"), "llama"),
    ("long", 1, HQ, HKV, 4096, 4096, DH, True, ("float32", "bfloat16"), "llama"),
    ("serve_dh64", 8, HQ, HKV, 64, 64, 64, True, ("bfloat16",), "granite"),
    ("whisper_enc", 8, 20, 20, 1500, 1500, 64, False, ("float32", "bfloat16"), "encdec"),
    ("whisper_cross_prefill", 8, 20, 20, 64, 1500, 64, False, ("float32", "bfloat16"),
     "encdec"),
    ("whisper_cross_decode", 8, 20, 20, 1, 1500, 64, False, ("float32", "bfloat16"),
     "encdec"),
    ("llava_prefill", 8, 32, 8, 2944, 2944, 128, True, ("float32", "bfloat16"), "encdec"),
    ("whisper_self_prefill", 8, 20, 20, 64, 64, 64, True, ("float32", "bfloat16"),
     "encdec"))
# decode_attention's timed shapes through the model's (B, S, Hkv, dh)
# cache view: (label, B, Hq, Hkv, S, dh, least kv_len, dtypes, generator).
# kv_len is drawn in [least, S], one sequence at S (and, in the second
# input set of a ragged row, one at 0). llama's serve shape and a long
# one; granite-moe's; whisper's decode step (g = 1), and, as the yardstick
# of its Sq = 1 cross call (on no path), every kv_len 1,500; llava's
# decode step (g = 4) after its 2,944-position prefill.
DECODE_SHAPES = (
    ("serve", 8, HQ, HKV, 80, DH, 65, ("float32", "bfloat16"), "llama"),
    ("decode_32k", 8, HQ, HKV, 32768, DH, 1, ("float32", "bfloat16"), "llama"),
    ("serve_dh64", 8, HQ, HKV, 80, 64, 65, ("bfloat16",), "granite"),
    ("whisper_decode", 8, 20, 20, 80, 64, 65, ("bfloat16",), "encdec"),
    ("whisper_cross_yardstick", 8, 20, 20, 1500, 64, 1500, ("bfloat16",), "encdec"),
    ("llava_decode", 8, 32, 8, 2960, 128, 2945, ("bfloat16",), "encdec"))
ATTN_SEEDS = {"llama": 2027, "granite": 2031, "encdec": 2033}


def check_attention(torch, dev) -> dict:
    """flash_attention (``FLASH_SHAPES``) held against its plain version
    (``flash_close``) and decode_attention (``DECODE_SHAPES``) against
    its plain version (``attn_close``, with kv_len 0, softcap and a window
    held too), each timed beside its plain version, SDPA and its bound;
    flash's window / softcap / kv_offset / ragged cases and every head
    dim held, not timed."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gens = {}
    for name, seed in ATTN_SEEDS.items():
        gens[name] = torch.Generator(device=dev)
        gens[name].manual_seed(seed)
    gen = gens["llama"]
    out = {}

    def rnd(*shape, dtype, g=gen):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for label, B, Hq, Hkv, Sq, Skv, dh, causal, dtypes, g in FLASH_SHAPES:
        for dtype in (getattr(torch, t) for t in dtypes):
            torch.cuda.empty_cache()
            sets = [(rnd(B, Hq, Sq, dh, dtype=dtype, g=gens[g]),
                     rnd(B, Hkv, Skv, dh, dtype=dtype, g=gens[g]),
                     rnd(B, Hkv, Skv, dh, dtype=dtype, g=gens[g]))
                    for _ in range(2 if Sq * Skv < 1024 * 1024 else 1)]
            err = max(flash_close(torch, fa, q, k, v, what=f"flash_attention {label}",
                                  causal=causal) for q, k, v in sets)
            nbytes, flops = flash_work(B, Hq, Hkv, Sq, Skv, dh, causal,
                                       sets[0][0].element_size())
            b = bound(nbytes, flops, BF16_OPS_PER_S if dtype == torch.bfloat16
                      else FP32_OPS_PER_S)
            q, k, v = sets[0]
            row = out[("flash_attention", label, str(dtype)[6:])] = dict(
                max_abs_err=err,
                ms=graph_ms(torch, [lambda s=s: fa.flash_attention(*s, causal=causal)
                                    for s in sets]),
                plain_ms=graph_ms(torch, [lambda s=s: fa.flash_attention_plain(
                    *s, causal=causal) for s in sets]),
                bound_ms=b[0], bound_by=b[1],
                library_ms=sdpa_ms(torch, q, k, v, causal=causal), bytes=nbytes,
                flops=flops)
            log_card(f"kernels: flash_attention {label} B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} "
                     f"Skv={Skv} dh={dh} causal={causal} {dtype} {row}")
            del sets, q, k, v
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

    for label, B, Hq, Hkv, S, dh, lo, dtypes, g in DECODE_SHAPES:
        what = f"decode_attention {label}"
        for dtype in (getattr(torch, t) for t in dtypes):
            sets = []
            for i in range(2 if S < 4096 else 1):
                kc = rnd(B, S, Hkv, dh, dtype=dtype, g=gens[g])
                vc = rnd(B, S, Hkv, dh, dtype=dtype, g=gens[g])
                lens = torch.randint(lo, S + 1, (B,), generator=gens[g], device=dev,
                                     dtype=torch.int32)
                lens[0] = S
                if i == 1 and lo < S:
                    lens[1] = 0                               # attends to nothing
                sets.append((rnd(B, Hq, dh, dtype=dtype, g=gens[g]), kc.transpose(1, 2),
                             vc.transpose(1, 2), lens))
            err = 0.0
            for q, k, v, lens in sets:
                empty = lens.clone()
                empty[1] = 0                                  # attends to nothing
                for ln in (lens, empty):
                    got = da.decode_attention(q, k, v, ln)
                    err = max(err, attn_close(torch, got, da.decode_attention_plain(
                        q, k, v, kv_len=ln), what=what))
                    require(not bool(got[ln == 0].any()), f"{what}: kv_len 0 must give 0")
                # softcap, and softcap with a window: held, not timed
                for kw in (dict(softcap=30.0), dict(softcap=30.0, window=48)):
                    attn_close(torch, da.decode_attention(q, k, v, lens, **kw),
                               da.decode_attention_plain(q, k, v, kv_len=lens, **kw),
                               what=what)
            esz = sets[0][0].element_size()
            live = statistics.mean(int(s[3].sum()) for s in sets)
            nbytes = esz * (2 * live * Hkv * dh + 2 * B * Hq * dh) + 4 * B
            flops = 4 * Hq * dh * live
            b_da = bound(nbytes, flops, BF16_OPS_PER_S if dtype == torch.bfloat16
                         else FP32_OPS_PER_S)
            q, k, v, lens = sets[0]
            mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
            row = out[("decode_attention", label, str(dtype)[6:])] = dict(
                max_abs_err=err, splits=da.num_splits(S, None, da.CHUNK), chunk=da.CHUNK,
                ms=graph_ms(torch, [lambda s=s: da.decode_attention(*s) for s in sets]),
                plain_ms=graph_ms(torch, [lambda s=s: da.decode_attention_plain(
                    *s[:3], kv_len=s[3]) for s in sets]),
                bound_ms=b_da[0], bound_by=b_da[1],
                library_ms=sdpa_ms(torch, q[:, :, None], k, v, causal=False, mask=mask),
                bytes=nbytes, flops=flops)
            log_card(f"kernels: decode_attention {label} B={B} Hq={Hq} Hkv={Hkv} S={S} "
                     f"dh={dh} {dtype} {row}")
            if label == "decode_32k":
                row["chunk_ms"] = chunk_sweep(torch, da, sets, None)
                log(f"kernels: decode_attention decode_32k {dtype} ms by chunk "
                    f"{row['chunk_ms']}")
                out[("decode_attention", f"decode_32k_w{WINDOW}", str(dtype)[6:])] = \
                    windowed_decode(torch, da, sets, dtype)
    cross = out[("flash_attention", "whisper_cross_decode", "bfloat16")]["ms"]
    yard = out[("decode_attention", "whisper_cross_yardstick", "bfloat16")]["ms"]
    log_card(f"kernels: whisper's decode-step cross-attention (Sq 1 against 1,500 keys): "
             f"flash_attention {cross:.6f} ms (64-row blocks, 63 rows dead), "
             f"decode_attention at kv_len 1,500 {yard:.6f} ms (yardstick, on no path)")
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


def scan_work(Bt, L, Dm, N, esz, with_h0) -> tuple[int, int]:
    """(bytes, operations) of one mamba_scan call: x and y in x's dtype,
    dt fp32, B and C, A and D read once, h_final written (and h0 read);
    7 operations per state element and step."""
    n = Bt * L * Dm
    nbytes = (n * (2 * esz + 4) + 2 * Bt * L * N * 4 + Dm * (N + 1) * 4
              + Bt * Dm * N * 4 * (2 if with_h0 else 1))
    return nbytes, 7 * n * N


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
                n = Bt * L * DI
                nbytes, n_ops = scan_work(Bt, L, DI, N, sets[0][0].element_size(), with_h0)
                b_s = bound(nbytes, n_ops)
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
                                sfu_ms=sfu_ms(torch, n * N), bytes=nbytes, ops=n_ops)
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
    the misses. Returns per-query (hit, reason, score, tau, response) and
    the host milliseconds of each lookup_batch (which ends in the one
    device→host copy, so the host clock sees the device work)."""
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
                       cache.policies.effective(c).threshold, r.response)
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
def indexes(cache) -> list:
    """The indexes a cache searches: its own, or each shard's."""
    return [s.index for s in getattr(cache, "shards", [cache])]


MARK_CYCLES = 40_000_000       # the trace's marker kernels spin ~20 ms each
EDGE_S = 0.05                  # idle host time at each end of a trace's session


@contextlib.contextmanager
def device_trace(torch, lead_in):
    """The card's events of the ``with`` block under torch.profiler: a
    list of (name, duration ns), filled when the block ends. The block is
    fenced by two marker kernels (``torch.cuda._sleep``), and only the
    events between them are kept; both markers must be in the trace.
    Device events near either end of a profiler session can go missing
    from its trace (on the card, in a process that has run for minutes: a
    lookup's first kernels, and once two graph replays of a block of
    sharded lookups that ended its session), so the session runs
    ``EDGE_S`` of host idle time and ``lead_in()`` before the first
    marker, and a burst of small kernels and ``EDGE_S`` after the second:
    the block's own work is neither the first nor the last the session sees."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    events = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        lead_in()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        yield events
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        device_burst(torch)
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
    found = sorted((e.start_ns(), e.name(), e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    marks = [k for k, e in enumerate(found) if "spin_kernel" in e[1]]
    require(len(marks) == 2, f"device trace: {len(marks)} marker kernels of 2 in the "
            f"trace's {len(found)} device events")
    events.extend((name, dur) for _, name, dur in found[marks[0] + 1:marks[1]])


def device_burst(torch) -> None:
    """1,000 tiny kernels on the current stream: a trace's lead-out, and
    its lead-in where the traced work cannot run twice."""
    x = torch.zeros(1, device="cuda")
    for _ in range(1_000):
        x.add_(1.0)


def profile_lookups(torch, cache, queries) -> str:
    """Device time of ``lookup_batch`` under torch.profiler (the same
    lookups once before as the trace's lead-in): the summed device time
    of the kernels and copies against the host wall time of the same
    window (the profiler's own host cost included), and the largest
    kernels by name. The port's kernels in the trace must be exactly what
    the search graphs replayed in the window (each shard's, for a sharded
    cache) recorded at their capture."""
    import numpy as np
    batches = [queries[s:s + 8] for s in range(0, len(queries), 8)]
    holders = [ix.programs for ix in indexes(cache)]

    def lookups():
        for part in batches:
            cache.lookup_batch(np.stack([q.embedding for q in part]),
                               [q.category for q in part])

    with device_trace(torch, lookups) as events:
        before = [dict(p.replays) for p in holders]
        t0 = time.perf_counter()
        lookups()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    want, replays = dict.fromkeys(TRACE_KERNELS, 0), []
    for programs, was in zip(holders, before):
        ran = {k: n - was.get(k, 0) for k, n in programs.replays.items()
               if n != was.get(k, 0)}
        replays.append(ran)
        for k, n in recorded_launches(programs, ran).items():
            want[k] += n
    replays = replays[0] if len(replays) == 1 else replays
    traced = traced_launches(events)
    require(traced == want, f"lookups under the profiler: the trace holds {traced} "
            f"launches of the port's kernels, the {replays} graph replays recorded {want}")
    by_name = {}
    for name, dur in events:
        by_name[name] = by_name.get(name, 0) + dur / 1e3
    busy_us = sum(by_name.values())
    if busy_us == 0:
        return "device time not measured (the profiler saw no device events)"
    top = sorted(by_name.items(), key=lambda x: -x[1])[:5]
    names = ", ".join(f"{k[:48]} {us / busy_us:.0%}" for k, us in top)
    port_us = {}
    for w, _, dur in port_kernels(events):
        port_us[w] = port_us.get(w, 0.0) + dur / 1e3 / len(batches)
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
                 "mamba_scan": ("mamba_scan_kernel", "mamba_step_kernel"),
                 "moe_route": ("moe_route_kernel",),
                 "moe_dispatch": ("moe_dispatch_kernel",),
                 "swiglu_cast": ("swiglu_cast_kernel",),
                 "moe_combine": ("moe_combine_kernel",)}


def port_kernels(events):
    """(wrapper of TRACE_KERNELS, name, duration ns) for each of a
    ``device_trace``'s events made by one of the port's kernels, by name
    (CUPTI records every kernel of a graph replay)."""
    import re
    pats = {w: re.compile("|".join(rf"(?<!\w){n}(?!\w)" for n in names))
            for w, names in TRACE_KERNELS.items()}
    for name, dur in events:
        for w, pat in pats.items():
            if pat.search(name):
                yield w, name, dur


def traced_launches(events) -> dict:
    """The port's kernels among a ``device_trace``'s events, counted by
    wrapper of TRACE_KERNELS."""
    out = dict.fromkeys(TRACE_KERNELS, 0)
    for w, _, _ in port_kernels(events):
        out[w] += 1
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


def hold_launches(cache, kind: str, counts: dict, label: str) -> dict:
    """A run's launches over every index of ``cache`` (each shard's): each
    search replayed a graph; frontier_hop max_hops times and gather_scores
    once (hnsw), or flat_topk once, at every capture's warm-up (wrapper
    calls) and in every replay (each graph's recorded launches x its
    replays); scatter_flush once per delta flush. Returns the replayed
    launches in total and per shard, and the captures per shard and
    batch bucket."""
    idx = indexes(cache)
    searches = [ix.search_stats["searches"] for ix in idx]
    replays = [sum(ix.programs.replays.values()) for ix in idx]
    captures = [sum(ix.programs.captures.values()) for ix in idx]
    require(replays == searches, f"{label}: searches {searches}, graph replays {replays}")
    per_shard = [recorded_launches(ix.programs, ix.programs.replays) for ix in idx]
    replayed = {k: sum(r[k] for r in per_shard) for k in TRACE_KERNELS}
    per = ({"frontier_hop": idx[0].p.max_hops, "gather_scores": 1}
           if kind == "hnsw" else {"flat_topk": 1})
    for k, n in per.items():
        require(counts[k] == n * sum(captures) and replayed[k] == n * sum(replays) > 0,
                f"{label}: {k} launched {counts[k]} times at wrapper calls and "
                f"{replayed[k]} in graph replays, not {n * sum(captures)} "
                f"({sum(captures)} warm-ups) and {n * sum(replays)} ({sum(replays)} searches)")
    flushes = [ix.sync_stats["delta_updates"] for ix in idx]
    require(counts["scatter_flush"] == sum(flushes) > 0,
            f"{label}: {counts['scatter_flush']} scatter launches for {flushes} delta "
            f"flushes (one launch a flush)")
    return dict(replayed=replayed, replays=replays, flushes=flushes,
                per_shard={k: [r[k] for r in per_shard] for k in per},
                buckets=[{key[0]: n for key, n in sorted(ix.programs.captures.items())}
                         for ix in idx])


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
            # Every search replays a graph. The wrappers launched at the
            # captures' warm-ups only; the replays ran what each capture
            # recorded (held against a profiled window in profile_lookups).
            replayed = hold_launches(cache, kind, counts, f"main {kind}/{dtype}")["replayed"]
            for k in replayed:
                replayed_all[k] += replayed[k]
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


# ---------------------------------------------------------------- phase 7
N_SHARDS = 4
HEAD = "code_generation"        # Table-1's largest quota: the category moved
UNREPLICATED = "api_documentation"   # the only category on its shard
MOVE_SHARD_CAPACITY = 1_024     # small enough that moving HEAD passes the
                                # rebuild threshold (a quarter of the table)


def make_sharded(kind: str, dtype: str, device: str, clock=None, **kw):
    """A 4-shard cache at capacity 1,048,576 (each shard's table too,
    unless ``shard_capacity`` says otherwise) over the Table-1 policies."""
    from repro_torch.core.clock import SimClock
    from repro_torch.core.policy import PolicyEngine, paper_policies
    from repro_torch.core.shard import ShardedSemanticCache
    clock = clock or SimClock()
    cache = ShardedSemanticCache(PolicyEngine(paper_policies()), n_shards=N_SHARDS,
                                 capacity=FLAT_N, clock=clock, index_kind=kind,
                                 use_device=True, emb_dtype=dtype, device=device, **kw)
    return cache, clock


def probe_decisions(cache, probe) -> list:
    """(hit, reason, score, tau, response) of ``probe`` (``serve``'s
    tuples), looked up in batches of 8 and not inserted."""
    import numpy as np
    out = []
    for s in range(0, len(probe), 8):
        part = probe[s:s + 8]
        cats = [q.category for q in part]
        res = cache.lookup_batch(np.stack([q.embedding for q in part]), cats)
        out += [(r.hit, r.reason, r.score, cache.policies.effective(c).threshold,
                 r.response) for r, c in zip(res, cats)]
    return out


def sync_state(cache) -> list:
    return [(ix.sync_stats["full_uploads"], dict(ix.programs.captures),
             dict(ix.programs.replays)) for ix in indexes(cache)]


def recaptured(cache, state, label: str) -> list:
    """The shards whose full upload since ``state`` dropped their graphs;
    every graph such a shard replayed since was captured anew."""
    full = []
    for i, (ix, (uploads, caps, reps)) in enumerate(zip(indexes(cache), state)):
        if ix.sync_stats["full_uploads"] == uploads:
            continue
        full.append(i)
        ran = [k for k, n in ix.programs.replays.items() if n != reps.get(k, 0)]
        require(ran and all(ix.programs.captures.get(k, 0) > caps.get(k, 0) for k in ran),
                f"{label}: shard {i} uploaded in full but replayed {ran} without "
                f"capturing them anew (captures {ix.programs.captures}, before {caps})")
    return full


def decided(d) -> tuple:
    """What a decision serves: hit, reason, response."""
    return d[0], d[1], d[4]


def move_head(cache, probe, label: str) -> dict:
    """A live migration mid-run: HEAD's probe queries, then
    ``migrate_category`` of HEAD to the lightest other shard, the probes
    again, then ``rebalance()`` (which re-plans and moves HEAD home), the
    probes again. On flat each probe decides as before the move (an HNSW
    shard's graph is rebuilt by the move, so it may not: the count is
    logged). A shard whose full upload dropped its graphs recaptured
    every graph it replayed after."""
    before = probe_decisions(cache, probe)
    src = cache.shard_of(HEAD)
    dst = min((s for s in range(N_SHARDS) if s != src),
              key=lambda s: (cache.planner.shard_bytes[s], s))
    state = sync_state(cache)
    mig = cache.migrate_category(HEAD, dst)
    require(mig.done and cache.shard_of(HEAD) == dst and mig.moved > 0
            and mig.journal == ["fence", "catchup", "reconcile", "flip", "purge", "unfence"],
            f"{label}: migration of {HEAD} {src} -> {dst} ended at {mig.journal}")
    moved = probe_decisions(cache, probe)
    full = recaptured(cache, state, label)
    state = sync_state(cache)
    moves = cache.rebalance()
    require(moves == {HEAD: (dst, src)} and cache.shard_of(HEAD) == src,
            f"{label}: rebalance() moved {moves}, not {HEAD} back to {src}")
    back = probe_decisions(cache, probe)
    full_back = recaptured(cache, state, label)
    differ = {what: sum(decided(x) != decided(y) for x, y in zip(got, before))
              for what, got in (("after the move", moved), ("after rebalance()", back))}
    if cache.index_kind == "flat":
        require(not any(differ.values()) and [x[2] for x in moved] == [x[2] for x in back]
                == [x[2] for x in before],
                f"{label}: {HEAD}'s {len(before)} probes decided differently: {differ}")
    return dict(src=src, dst=dst, moved=mig.moved, probes=len(probe),
                hits=sum(x[0] for x in before), differ=differ, full_uploads=full,
                full_uploads_back=full_back, decisions=before + moved + back)


def run_sharded(torch, counters, kind: str, dtype: str, qs, device: str, **kw) -> tuple:
    """``qs`` through a 4-shard cache on ``device``: the first half, the
    live move of HEAD (``move_head``, probed with the last 64 HEAD queries
    served, most of them cached), the second half. Returns the served
    traffic's decisions, its lookup_batch host ms, the cache and the
    move's log (with every decision in the order made)."""
    cache, clock = make_sharded(kind, dtype, device, **kw)
    half = len(qs) // 16 * 8
    first, ms1 = serve(cache, clock, qs[:half], 8)
    probe = [q for q in qs[:half] if q.category == HEAD][-64:]
    move = move_head(cache, probe, f"shard {kind}/{dtype} on {device}")
    second, ms2 = serve(cache, clock, qs[half:], 8)
    move["decisions"] = first + move["decisions"] + second
    return first + second, ms1 + ms2, cache, move


def run_outages(torch, counters, qs) -> dict:
    """Two 4-shard hnsw/float32 runs of ``qs`` on the card behind a fault
    injector. (a) HEAD replicated on 2 shards and its primary down from 20
    to 40 s: every read of the down shard fails over, nothing degrades,
    the replicas never diverge, and every write queued for the down
    replica replays. (b) UNREPLICATED's shard down from 20 to 60 s,
    ``rebalance_after_s`` 5: ``OutageRebalance`` rebuilds it on a live
    shard from the store (adopted rows, one delta flush), and it returns
    home once its shard recovers."""
    from repro_torch.core.clock import SimClock
    from repro_torch.core.faults import FaultInjector, FaultSchedule
    from repro_torch.core.policy import PolicyEngine, paper_policies
    from repro_torch.core.shard import ShardPlanner
    out = {}
    planner = ShardPlanner.from_policies(PolicyEngine(paper_policies()), N_SHARDS, FLAT_N,
                                         replication={HEAD: 2})
    down = planner.shard_of(HEAD)
    pe = PolicyEngine(paper_policies())
    alone = [c for c in pe.categories() if planner.replica_set(c) == [down]
             and pe.get(c).allow_caching and pe.get(c).quota > 0]
    require(not alone, f"outage: shard {down} holds unreplicated {alone}")
    for fn in counters.values():
        fn.launches = 0
    clock = SimClock()
    faults = FaultInjector(FaultSchedule(shard_outages=[(20.0, 40.0, down)]), clock)
    cache, _ = make_sharded("hnsw", "float32", "cuda", clock=clock, faults=faults,
                            planner=planner, replication={HEAD: 2})
    decisions, _ = serve(cache, clock, qs, 8)
    hold_launches(cache, "hnsw", {k: fn.launches for k, fn in counters.items()},
                  "outage (replicated)")
    fs, ov = dict(cache.fault_stats), cache.metrics.snapshot()["_overall"]
    require(ov["availability"] == 1.0 and fs["degraded_misses"] == 0
            and fs["failover_reads"] > 0 and fs["replica_divergence"] == 0
            and fs["wb_replayed"] == fs["wb_enqueued"] > 0,
            f"outage (replicated, shard {down} down 20-40 s): availability "
            f"{ov['availability']}, fault_stats {fs}")
    out["replicated"] = dict(down=down, replica_set=cache.replica_set(HEAD),
                             hits=sum(d[0] for d in decisions), **fs)
    log_card(f"shard outage: {HEAD} on shards {cache.replica_set(HEAD)}, shard {down} down "
        f"20-40 s of {clock.now():.1f} s: availability {ov['availability']}, "
        f"{sum(d[0] for d in decisions)} hits of {len(decisions)}, fault_stats {fs}")
    del cache
    for fn in counters.values():
        fn.launches = 0
    down = ShardPlanner.from_policies(pe, N_SHARDS, FLAT_N).shard_of(UNREPLICATED)
    clock = SimClock()
    faults = FaultInjector(FaultSchedule(shard_outages=[(20.0, 60.0, down)]), clock)
    cache, _ = make_sharded("hnsw", "float32", "cuda", clock=clock, faults=faults,
                            rebalance_after_s=5.0)
    split = next(i for i, q in enumerate(qs) if q.timestamp >= 30.0) // 8 * 8
    first, _ = serve(cache, clock, qs[:split], 8)
    home = cache.shard_of(UNREPLICATED)
    rebuilt = cache.shards[home].category_count(UNREPLICATED)
    require(cache.fault_stats["outage_rebalances"] >= 1 and home != down and rebuilt > 0,
            f"outage (unreplicated, shard {down} down 20-60 s): at {clock.now():.1f} s "
            f"{UNREPLICATED} is on shard {home} with {rebuilt} entries, fault_stats "
            f"{cache.fault_stats}")
    second, _ = serve(cache, clock, qs[split:], 8)
    hold_launches(cache, "hnsw", {k: fn.launches for k, fn in counters.items()},
                  "outage (rebuilt)")
    fs = dict(cache.fault_stats)
    require(fs["reabsorbed_categories"] >= 1 and cache.shard_of(UNREPLICATED) == down
            and fs["wb_replayed"] == fs["wb_enqueued"],
            f"outage (unreplicated): after recovery {UNREPLICATED} is on shard "
            f"{cache.shard_of(UNREPLICATED)}, fault_stats {fs}")
    out["rebuilt"] = dict(down=down, rebuilt_on=home, rebuilt_entries=rebuilt, **fs)
    log_card(f"shard outage: {UNREPLICATED} alone on shard {down}, down 20-60 s, "
        f"rebalance_after_s 5: rebuilt from the store on shard {home} ({rebuilt} entries "
        f"at {qs[split - 1].timestamp:.1f} s), home again after recovery; "
        f"degraded misses {fs['degraded_misses']}, fault_stats {fs}")
    del cache
    return out


def run_shard_path(torch, counters, steps: int, long_steps: int) -> dict:
    """Phase 7 (see the module docstring): ``steps`` batches of 8 through
    each 4-shard run, the move at half of them; the move at 1,024 rows a
    shard and the outage runs take ``long_steps`` (the move must carry
    enough entries to pass the rebuild threshold, and the faults end at 60
    s of traffic time, 30 queries a second). Returns, for the cache
    kernels, the launches of the four 4-shard card runs: at wrapper calls,
    in graph replays, and in replays per shard."""
    import numpy as np
    qs = table1_queries(steps * 8, seed=1)
    total = {k: dict(launches=0, replay_launches=0, per_shard=[0] * N_SHARDS)
             for k in ("frontier_hop", "gather_scores", "flat_topk", "scatter_rows")}
    for kind in ("hnsw", "flat"):
        for dtype in ("float32", "int8"):
            label = f"shard {kind}/{dtype}"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            card, ms, cache, move = run_sharded(torch, counters, kind, dtype, qs, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            counts = {k: fn.launches for k, fn in counters.items()}
            held = hold_launches(cache, kind, counts, label)
            for k in total:
                w = "scatter_flush" if k == "scatter_rows" else k
                total[k]["launches"] += counts[w]
                total[k]["replay_launches"] += held["replayed"].get(k, 0)
                per = held["flushes"] if k == "scatter_rows" else held["per_shard"].get(
                    k, [0] * N_SHARDS)
                total[k]["per_shard"] = [a + b for a, b in zip(total[k]["per_shard"], per)]
            n_lookups = len(ms) + 3 * -(-move["probes"] // 8)
            log_card(f"{label}: {len(qs)} queries in {wall:.2f} s; lookup_batch ms p50 "
                f"{np.percentile(ms, 50):.3f} p99 {np.percentile(ms, 99):.3f}; search "
                f"replays per lookup_batch {sum(held['replays']) / n_lookups:.2f} "
                f"(per shard {held['replays']}); placement {cache.planner.assignments}")
            log_card(f"{label}: captures per shard and batch bucket {held['buckets']}; "
                f"launches in graph replays {({k: n for k, n in held['replayed'].items() if n})}"
                f" (per shard {held['per_shard']}), at wrapper calls "
                f"{({k: n for k, n in counts.items() if n})}; delta flushes per shard "
                f"{held['flushes']}")
            log_card(f"{label}: sync_stats {cache.sync_stats}")
            log_card(f"{label}: device memory {peak / 2**30:.2f} GiB peak (4 shards of "
                f"{FLAT_N:,} rows, graphs included); entries per shard "
                f"{[len(s) for s in cache.shards]}")
            log_card(f"{label}: live move of {HEAD} shard {move['src']} -> {move['dst']} "
                f"({move['moved']} entries) and back by rebalance(): of its "
                f"{move['probes']} probes ({move['hits']} hits before), decided "
                f"otherwise than before the move: {move['differ']}; full uploads during "
                f"the move on shards {move['full_uploads']}, {move['full_uploads_back']}")
            log_card(f"{label}: profile: {profile_lookups(torch, cache, qs[-80:])}")
            del cache
            gc.collect()
            torch.cuda.empty_cache()
            one, clock = make_cache(kind, dtype, FLAT_N, "cuda")
            single, one_ms = serve(one, clock, qs, 8)
            del one
            gc.collect()
            torch.cuda.empty_cache()
            diff = [i for i, (a, b) in enumerate(zip(card, single))
                    if (a[0], a[1], a[4]) != (b[0], b[1], b[4])]
            if kind == "flat":
                require(not diff and [a[2] for a in card] == [b[2] for b in single],
                        f"{label}: {len(diff)} decisions differ from one cache's "
                        f"(first at query {diff[:1]})")
            log_card(f"{label}: 1-shard lookup_batch ms p50 {np.percentile(one_ms, 50):.3f} "
                f"(4 shards: {np.percentile(ms, 50):.3f}); decisions (hit, reason, "
                f"response) that differ from one cache's: {len(diff)} of {len(card)}")
            if kind == "hnsw":
                _, _, cpu_cache, cpu_move = run_sharded(torch, counters, kind, dtype, qs,
                                                        "cpu")
                del cpu_cache
                gc.collect()
                compare_decisions(move["decisions"], cpu_move["decisions"], label)
                log_card(f"{label}: the same 4-shard run on the CPU, move and probes "
                         f"included, decides as the card (queries within {TAU_BAND} of "
                         f"tau aside)")
    gc.collect()
    torch.cuda.empty_cache()
    # The move again with shard tables of 1,024 rows: moving HEAD now
    # passes the rebuild threshold, so the target (and then the source)
    # uploads in full and drops its graphs. On flat the probes decide as
    # before the move only if the new graphs read the new tables.
    for fn in counters.values():
        fn.launches = 0
    long_qs = table1_queries(long_steps * 8, seed=1)
    _, _, cache, move = run_sharded(torch, counters, "flat", "float32", long_qs, "cuda",
                                    shard_capacity=MOVE_SHARD_CAPACITY)
    require(move["full_uploads"] and move["full_uploads_back"],
            f"shard move at {MOVE_SHARD_CAPACITY} rows a shard: no full upload "
            f"({move})")
    hold_launches(cache, "flat", {k: fn.launches for k, fn in counters.items()},
                  "shard move with full uploads")
    log_card(f"shard flat/float32 at {MOVE_SHARD_CAPACITY:,} rows a shard: moving {HEAD} "
        f"({move['moved']} entries) uploaded shards {move['full_uploads']} in full, and "
        f"moving it back shards {move['full_uploads_back']}; each recaptured every graph "
        f"it replayed after (captures per shard and bucket "
        f"{[dict(ix.programs.captures) for ix in indexes(cache)]}), and the probes "
        f"decided as before the move")
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    run_outages(torch, counters, long_qs)
    return total


# ---------------------------------------------------------------- phase 8
SIM_QUERIES = 4_000            # bench_longtail.run_scenarios' count


def simulate(device, **kw):
    """``bench_longtail.run``'s simulator: paper_policies(), capacity
    12,000, Table-1 traffic at 30 queries/s from seed 42, with the device
    search; ``device`` None is the card."""
    from repro_torch.core.policy import PolicyEngine, paper_policies
    from repro_torch.core.workload import TABLE1_WORKLOAD, WorkloadGenerator
    from repro_torch.serving.simulator import ServingSimulator, SimConfig
    sim = ServingSimulator(PolicyEngine(paper_policies()), SimConfig(
        cache_capacity=12000, use_device=True, device=device, **kw))
    t0 = time.perf_counter()
    res = sim.run(WorkloadGenerator(TABLE1_WORKLOAD, rate_per_s=30.0, seed=42), SIM_QUERIES)
    return res, sim, time.perf_counter() - t0


def sim_counters(res, sync: bool = True) -> dict:
    out = dict(summary=res.summary(), per_category=res.per_category,
               model_calls=res.model_calls, resident=res.mean_resident_entries)
    if sync:
        out["index_sync"] = res.index_sync
    return out


def run_sim(torch, counters) -> dict:
    """Phase 8 (see the module docstring). Returns the cache kernels'
    launches in the four hybrid card runs (at wrapper calls, in graph
    replays)."""
    total = {k: dict(launches=0, replay_launches=0)
             for k in ("frontier_hop", "gather_scores", "flat_topk", "scatter_rows")}
    card = {}
    for kind in ("hnsw", "flat"):
        for n in (1, N_SHARDS):
            label = f"sim hybrid {kind} {n} shard(s)"
            for fn in counters.values():
                fn.launches = 0
            res, sim, wall = simulate(None, architecture="hybrid", index_kind=kind,
                                      n_shards=n)
            counts = {k: fn.launches for k, fn in counters.items()}
            held = hold_launches(sim.cache, kind, counts, label)
            for k in total:
                w = "scatter_flush" if k == "scatter_rows" else k
                total[k]["launches"] += counts[w]
                total[k]["replay_launches"] += held["replayed"].get(k, 0)
            card[kind, n] = res
            rates = {c: round(d["hit_rate"], 4) for c, d in sorted(res.per_category.items())}
            log_card(f"{label}: {SIM_QUERIES} queries in {wall:.2f} s on the card; summary "
                f"{res.summary()}; model calls {res.model_calls}")
            log_card(f"{label}: hit rates {rates}; captures per shard and batch bucket "
                f"{held['buckets']}; search replays {sum(held['replays'])}, delta flushes "
                f"{sum(held['flushes'])}")
            del sim
            gc.collect()
    for n in (1, N_SHARDS):
        res, _, wall = simulate("cpu", architecture="hybrid", index_kind="flat", n_shards=n)
        require(sim_counters(res) == sim_counters(card["flat", n]),
                f"sim flat {n} shard(s): the card's counters differ from the CPU's: "
                f"{res.summary()} on the CPU, {card['flat', n].summary()} on the card")
        log_card(f"sim hybrid flat {n} shard(s): the CPU run ({wall:.2f} s) gives the card's "
            f"summary, per-category rows, model calls and index sync")
    require(sim_counters(card["flat", 1], False) == sim_counters(card["flat", N_SHARDS], False),
            f"sim flat: {N_SHARDS} shards {card['flat', N_SHARDS].summary()} differ from "
            f"one cache {card['flat', 1].summary()}")
    hnsw_1, hnsw_n = (sim_counters(card["hnsw", n], False) for n in (1, N_SHARDS))
    log_card(f"sim flat: {N_SHARDS} shards give one cache's counters; hnsw: "
        f"{'the same' if hnsw_1 == hnsw_n else 'different'} counters "
        f"({card['hnsw', 1].summary()} against {card['hnsw', N_SHARDS].summary()})")
    hy = card["flat", 1]
    vdb, _, _ = simulate(None, architecture="vdb")
    none, _, _ = simulate(None, architecture="none")
    t_fp = 500.0          # a false positive is asked again: one more model call
    hy_q = hy.mean_latency_ms + hy.false_positives / hy.n_queries * t_fp
    vdb_q = vdb.mean_latency_ms + vdb.false_positives / vdb.n_queries * t_fp
    require(hy.mean_latency_ms < none.mean_latency_ms and hy.model_cost < none.model_cost
            and vdb.false_positives > 5 * max(1, hy.false_positives) and hy_q < vdb_q
            and vdb.mean_latency_ms > 30.0,
            f"sim: hybrid {hy.summary()} against vdb {vdb.summary()} and none "
            f"{none.summary()}")
    log_card(f"sim architectures: mean latency ms hybrid {hy.mean_latency_ms:.2f}, vdb "
        f"{vdb.mean_latency_ms:.2f}, none {none.mean_latency_ms:.2f}; with {t_fp:.0f} ms a "
        f"false positive hybrid {hy_q:.2f}, vdb {vdb_q:.2f}; false positives hybrid "
        f"{hy.false_positives}, vdb {vdb.false_positives}; model cost hybrid "
        f"{hy.model_cost:.2f}, none {none.model_cost:.2f}")
    rows = ", ".join(f"{c} {d['hit_rate']:.3f} ({d['lookups']} lookups)"
                     for c, d in sorted(hy.per_category.items(), key=lambda x: -x[1]["lookups"]))
    log_card(f"sim long-tail table (hybrid flat, the card): {rows}")
    return total


# ---------------------------------------------------------------- phase 6, sharded
def run_sharded_serve(torch, counters, n_requests: int) -> dict:
    """``run_serving`` in front of full-width llama3.2-3b with a flat cache
    of 4 shards and of one, on the same requests: the same served,
    hit-rate, model-token and per-category counters; flat_topk and the
    delta flush launched on the card in both."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serving
    cfg = get_config("llama3.2-3b")
    outs = {}
    for n in (1, N_SHARDS):
        gc.collect()
        torch.cuda.empty_cache()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = run_serving(cfg, n_requests=n_requests, max_batch=8, prompt_len=64,
                          max_new_tokens=16, seed=0, index_kind="flat", use_device=True,
                          n_shards=n, device="cuda",
                          log=lambda m, n=n: log_card(f"serve llama3.2-3b {n} shard(s): {m}"))
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        flushes = out["index_sync"]["delta_updates"]
        require(counts["flat_topk"] > 0 and counts["scatter_flush"] == flushes > 0,
                f"serve {n} shard(s): flat_topk {counts['flat_topk']} launches at "
                f"warm-ups, {counts['scatter_flush']} scatter launches for {flushes} "
                f"delta flushes")
        outs[n] = out
        log_card(f"serve llama3.2-3b {n} shard(s): {out['served']} served in "
            f"{time.perf_counter() - t0:.2f} s, launches at wrapper calls "
            f"{({k: v for k, v in counts.items() if v})}")
    keep = ("lookups", "hits", "misses", "inserts", "hit_rate")
    same = [{k: out[k] for k in ("served", "hit_rate", "model_tokens")} |
            {c: {k: v for k, v in row.items() if k in keep}
             for c, row in out["per_category"].items()} for out in outs.values()]
    require(same[0] == same[1], f"serve: {N_SHARDS} shards {same[1]} against one cache "
            f"{same[0]}")
    log_card(f"serve llama3.2-3b: {N_SHARDS} flat shards and one flat cache give the same "
        f"counters over {n_requests} requests: {same[0]['served']} served, hit rate "
        f"{same[0]['hit_rate']:.3f}, {same[0]['model_tokens']} model tokens")
    return outs


# ---------------------------------------------------------------- phase 6
SERVE_ARCHS = ("llama3.2-3b", "falcon-mamba-7b", "granite-moe-3b-a800m")
# The model kernels each family's generation runs, once per layer of every
# prefill and / or decode step (moe: granite-moe, every layer attention).
MOE_KERNELS = ("moe_route", "moe_dispatch", "swiglu_cast", "moe_combine")
SERVE_PATH = {"dense": {"flash_attention": ("prefill",), "decode_attention": ("decode",)},
              "moe": {"flash_attention": ("prefill",), "decode_attention": ("decode",),
                      **{k: ("prefill", "decode") for k in MOE_KERNELS}},
              "ssm": {"mamba_scan": ("prefill", "decode")}}
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
# bf16 logits (magnitude ~4): card and CPU, or decode and prefill, round
# activations at other places (cuBLAS and the CPU sum in other orders, the
# decode and flash kernels differ in summation order), and one bf16 step of
# a hidden state moves a logit by ~1e-2; 0.1 bounds two layers of that
# (0.031 and 0.038 measured on an H100 for llama3.2-3b).
LOGIT_TOL = 0.1


def kernel_summary(torch, prof, wall_us: float, top: int = 6) -> str:
    """Summed self device time of a torch.profiler window against its host
    wall time, and the ``top`` largest kernels by name."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        return "device time not measured (the profiler saw no device events)"
    largest = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    names = ", ".join(f"{e.key[:40]} {e.self_device_time_total / busy_us:.0%}"
                      for e in largest)
    n_kernels = sum(e.count for e in kernels)
    return (f"{n_kernels} device kernels, busy {busy_us:.1f} us of {wall_us:.1f} us wall "
            f"under the profiler (idle share {1 - busy_us / wall_us:.3f}); top kernels: "
            f"{names}")


class GenerateTimer:
    """Times generation on the card while ``run_serving`` (or the port's
    ``serving.engine.generate``) runs: CUDA
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
                with device_trace(torch, lambda: device_burst(torch)) as events:
                    out = orig(programs, key, fn, inputs)
                self.traced[key] = (traced_launches(events),
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
                self.profiles[kind] = f"B {key[1]}, " + kernel_summary(torch, prof, wall_us)
                return out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(programs, key, fn, inputs)
            end.record()
            self.events[kind].append((start, end, key[1]))
            return out
        return call

    def ms(self, kind, B: int | None = None) -> list[float]:
        """The timed replays of ``kind`` (at batch ``B`` only, if given),
        ms each."""
        return [s.elapsed_time(e) for s, e, b in self.events[kind] if B in (None, b)]


def eager_tokens(torch, model, params, tokens, new: int, extra=None, reached=None):
    """Greedy generation of ``new`` tokens as the plain eager loop over
    ``Model.prefill`` and ``Model.decode_step`` (the yardstick of the
    captured programs), every step's logits required finite; ``extra``
    the family's input beside the tokens (``family_inputs``); ``reached``
    a (2,) int32 device tensor the MoE layers' expert counters add to (the
    prefill's, then the decode steps')."""
    V = model.cfg.vocab_size
    extra = extra or {}
    max_len = prefix_len(extra) + tokens.shape[1] + new
    pre, dec = ({"reached": reached[:1]}, {"reached": reached[1:]}) if reached is not None \
        else ({}, {})
    with torch.inference_mode():
        logits, cache, kv_len = model.prefill(
            params, {"tokens": torch.from_numpy(tokens).to(model.device), **extra}, max_len,
            **pre)
        out = []
        for step in range(new):
            require(bool(torch.isfinite(logits[:, :V]).all()),
                    f"{model.cfg.name}: non-finite logits at step {step}")
            tok = logits[:, :V].argmax(-1).to(torch.int32)
            out.append(tok)
            if step < new - 1:
                logits, cache, kv_len = model.decode_step(params, cache, tok, kv_len, **dec)
        return torch.stack(out, dim=1).cpu().numpy()


def run_serve(torch, counters, arch: str, n_requests: int) -> dict:
    """The port's run_serving on the card: ``arch`` at full width and
    depth, seeded random weights drawn on the device, SemanticCache (hnsw,
    fp32, device search) with Table-1 traffic, batch 8, prompt 64, 16 new
    tokens. Generation replays a prefill and a decode graph per miss-batch
    size. Every kernel of the model's path must have launched exactly once
    per layer of every prefill (flash_attention) or decode step
    (decode_attention) that ran on the card, a dense or MoE model's, or of
    both (mamba_scan), an ssm model's (``SERVE_PATH``); afterwards the
    captured generation must give the eager loop's tokens for a batch of 8
    and one of 3."""
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
    path = SERVE_PATH[cfg.family]
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
        f"batch: bf16 layers{step['decode_experts']}, bf16 head, "
        f"{step['decode_state']}); the fp32 head copy the port reads instead adds "
        f"{step['fp32_head_extra_ms']:.4f} ms")
    for name, text in timer.profiles.items():
        log(f"serve {arch}: profile of one {name} replay: {text}")
    for kind in GenerateTimer.KINDS:
        key = max((k for k in programs.keys() if k[0] == kind), key=lambda k: k[1])
        log(f"serve {arch}: launches recorded by the {key} graph: "
            f"{ {fn.__name__: n for fn, n in programs.recorded(key).items()} }")
    rng = np.random.default_rng(11)
    for B in (8, 3):
        toks = rng.integers(2, cfg.vocab_size, (B, 64)).astype(np.int32)
        got = engine._generate(engine.params, toks)
        want = eager_tokens(torch, engine.model, engine.params, toks, 16)
        require(np.array_equal(got, want), f"serve {arch}: B={B} graph tokens "
                f"{got.tolist()} differ from the eager loop's {want.tolist()}")
    log(f"serve {arch}: graph tokens equal the eager loop's for B = 8 and B = 3 "
        f"(16 tokens each)")
    del engine, programs, timer
    return numbers


def tree_sum(tree, of) -> int:
    """``of(tensor)`` summed over a parameter tree's leaves."""
    from repro_torch.models.convert import tree_leaves
    return sum(of(t) for t in tree_leaves(tree))


def decode_step_bound(params, cfg, batch: float, *, prompt_len: int,
                      new_tokens: int, hit: float | None = None) -> dict:
    """The least time of one decode step at ``batch`` sequences: the bytes
    it must move (every layer weight, the bf16 head, the final norm, the
    batch's embedding rows, and each layer's cached state: the live K/V
    rows of an attention layer, at the mean live length over the steps of
    a generate, read; the fp32 state and conv tail of a Mamba layer, read
    and written) at the HBM rate, or its products at the bf16 tensor-core
    rate, whichever is larger. An MoE layer reads only the experts its
    batch routes to: under uniform routing E·(1 − (1 − k/E)^batch) of E
    (33.3 of granite-moe's 40 at batch 8), or ``hit`` where the experts
    reached were counted, and does k experts' products a token, not E. The port's fp32 head copy is a cost of its design,
    reported apart. An encdec decoder (whisper) also reads each layer's
    cross K/V of the encoder output, and never its cross ``wk`` / ``wv``
    (prefill made the K/V with them); its encoder is not read at all."""
    head = params["head"]
    esz = head.element_size()
    read = [params["layers"], params["final_norm"], head]
    experts = [layer["mlp"][n] for layer in params["layers"]
               if "router" in layer.get("mlp", {}) for n in EXPERT_LEAVES]
    routed = {id(t) for t in experts}
    unread = {id(layer["cross"][n]) for layer in params["layers"] if "cross" in layer
              for n in ("wk", "wv")}

    def dense(of):
        return tree_sum(read, lambda t: 0 if id(t) in routed | unread else of(t))

    uniform = hit is None
    if uniform:
        hit = expected_experts(cfg.n_experts, cfg.moe_top_k, batch) if experts else 0.0
    exp_bytes = tree_sum(experts, lambda t: t.nbytes) * (hit / max(cfg.n_experts, 1))
    exp_flops = (2 * batch * cfg.moe_top_k / max(cfg.n_experts, 1)
                 * tree_sum(experts, lambda t: t.numel()))
    kinds = cfg.layer_kinds()
    # decode step i of a generate attends prompt_len + 1 + i positions
    live = prompt_len + 1 + (new_tokens - 2) / 2
    kv = 2 * kinds.count("attn") * cfg.n_kv_heads * cfg.head_dim * esz * live * batch
    cross = (2 * cfg.n_layers * batch * cfg.enc_ctx * cfg.n_kv_heads * cfg.head_dim * esz
             if cfg.family == "encdec" else 0)
    di = cfg.ssm_d_inner
    ssm = (2 * kinds.count("mamba") * batch
           * (di * cfg.ssm_d_state * 4 + (cfg.ssm_d_conv - 1) * di * esz))
    state = " and ".join(
        text for n, text in ((kinds.count("attn"), "live KV"),
                             (cross, "the cross K/V"),
                             (kinds.count("mamba"), "the Mamba state read and written"))
        if n)
    nbytes = (dense(lambda t: t.nbytes) + exp_bytes + kv + cross + ssm
              + batch * cfg.d_model * esz)
    flops = 2 * batch * dense(lambda t: t.numel()) + exp_flops
    t, by = bound(nbytes, flops, BF16_OPS_PER_S)
    extra = head.numel() * (4 - esz)
    reach = (f"uniform top-{cfg.moe_top_k} routing reaches at the mean batch" if uniform
             else "the steps reached, counted")
    note = (f", of each MoE layer's {cfg.n_experts} experts the {hit:.1f} that {reach}, "
            f"not all" if experts else "")
    return dict(decode_bound_ms=t, decode_bound_by=by, decode_bytes=nbytes,
                decode_state=state, decode_experts=note, decode_experts_hit=hit,
                decode_cross_bytes=cross, fp32_head_extra_ms=extra / HBM_BYTES_PER_S * 1e3)


class Routing:
    """``repro_torch.models.moe.route`` wrapped while a model check runs:
    every call's router input (fp32), its own expert ids and the router
    are kept per device in call order (layer order, prefill then each
    decode step). ``force(device, i)`` may give the ids the i-th call on
    that device returns instead, weighted by its own probabilities at
    them. Routing is a step function of its input: two computations of
    the same model that round differently (card and CPU, decode and
    prefill) flip a choice that sits within that rounding of a tie, and
    a flipped choice moves its token's FFN output by O(1). So a check of
    two computations forces the second onto the first's choices, and
    ``near_ties`` holds each choice it would have made itself to the
    first's except where the first's k-th and (k+1)-th router logits lie
    within twice the two router inputs' logit difference."""

    def __init__(self, torch, force=None):
        self.torch, self.force = torch, force
        self.calls = {"cpu": [], "cuda": []}

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._orig = moe, moe.route
        torch = self.torch

        def route(x, w, cfg):
            ids, weights, aux = self._orig(x, w, cfg)
            mine = self.calls[x.device.type]
            mine.append((x.detach().float().cpu(), ids.cpu(), w.detach().float().cpu()))
            forced = self.force(x.device.type, len(mine) - 1) if self.force else None
            if forced is not None:
                ids = forced.to(device=x.device, dtype=ids.dtype)
                probs = torch.softmax(x.float() @ w.float(), dim=-1)
                weights = probs.gather(1, ids.long())
                weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
            return ids, weights, aux

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._orig


def near_ties(torch, first, second, label: str) -> tuple[int, float]:
    """``first`` and ``second``: lists of (x, ids, router) of the same
    calls. Every choice of ``second`` that differs from ``first``'s must
    be a near tie (``Routing``). Returns (flips, largest |x| difference)."""
    require(len(first) == len(second) > 0, f"{label}: {len(first)} routing calls "
            f"against {len(second)}")
    flips, dx = 0, 0.0
    for (xa, ia, w), (xb, ib, _) in zip(first, second):
        dx = max(dx, float((xa - xb).abs().max()))
        la, lb = xa @ w, xb @ w
        k = ia.shape[1]
        top = la.sort(dim=1, descending=True).values
        margin = top[:, k - 1] - top[:, k]
        noise = (la - lb).abs().max(dim=1).values
        for t in range(ia.shape[0]):
            if set(ia[t].tolist()) != set(ib[t].tolist()):
                flips += 1
                require(float(margin[t]) <= 2 * float(noise[t]) + 1e-6,
                        f"{label}: token {t} routed to {ib[t].tolist()} against "
                        f"{ia[t].tolist()} with a margin {float(margin[t])} beyond twice "
                        f"the router-logit difference {float(noise[t])}")
    return flips, dx


def split_calls(calls, B: int, S: int) -> tuple[list, list]:
    """A prefill's routing calls over B x S tokens, cut into those of its
    first S-1 positions and those of its last (a decode step's)."""
    head, last = [], []
    for x, ids, w in calls:
        xs, ii = x.view(B, S, -1), ids.view(B, S, -1)
        head.append((xs[:, :S - 1].reshape(B * (S - 1), -1),
                     ii[:, :S - 1].reshape(B * (S - 1), -1), w))
        last.append((xs[:, S - 1], ii[:, S - 1], w))
    return head, last


def family_inputs(torch, cfg, B: int, gen, n_patches: int | None = None) -> dict:
    """The input beside the tokens that whisper (audio: frame embeddings
    (B, 1,500, 1,280)) or llava (patches: (B, n_patches, 4,096)) takes,
    N(0, 1) in bf16 from ``gen`` on its device; {} for other families."""
    if cfg.family == "encdec":
        shape, key = (B, cfg.enc_ctx, cfg.enc_dim), "audio"
    elif cfg.family == "vlm":
        shape, key = (B, cfg.n_patches if n_patches is None else n_patches,
                      cfg.d_model), "patches"
    else:
        return {}
    return {key: torch.randn(shape, generator=gen, device=gen.device).to(torch.bfloat16)}


def prefix_len(extra: dict) -> int:
    """Positions a VLM's patches add before the text (0 without them)."""
    return extra["patches"].shape[1] if "patches" in extra else 0


def decode_vs_prefill(torch, model, params, toks, label: str, extra=None) -> dict:
    """Decode of token S-1 after a prefill of S-1 against the prefill of
    all S, on the card, each MoE layer forced onto the full prefill's
    choices (``Routing``); ``extra`` the family's input beside the tokens
    (``family_inputs``). Returns the logits' largest difference, the full
    prefill's (logits, cache, kv_len) and the routing flips."""
    B, S = toks.shape
    V = model.cfg.vocab_size
    extra = extra or {}
    room = prefix_len(extra) + S + 8
    with Routing(torch) as full:
        lf, cf, kf = model.prefill(params, {"tokens": toks, **extra}, room)
    head, last = split_calls(full.calls["cuda"], B, S)
    n = len(head)
    forced = [c[1] for c in head] + [c[1] for c in last]
    with Routing(torch, force=lambda dev, i: forced[i] if i < 2 * n else None) as part:
        _, cache, kvl = model.prefill(params, {"tokens": toks[:, :S - 1], **extra}, room)
        ld, _, _ = model.decode_step(params, cache, toks[:, S - 1].cuda(), kvl)
    flips, dx = near_ties(torch, head + last, part.calls["cuda"], label) if n else (0, 0.0)
    err = float((lf[:, :V] - ld[:, :V]).abs().max())
    require(err <= LOGIT_TOL, f"{label}: decode vs prefill err {err}")
    return dict(err=err, flips=flips, router_dx=dx, full=(lf, cf, kf))


# llava's card-vs-CPU check prepends one anyres tile of patches, not 5: a
# 2,944-position bf16 prefill of two 4,096-wide layers is slow on the host
CPU_PATCHES = 576


def check_model(torch, arch: str) -> dict:
    """``arch`` at full width and 2 layers (whisper: 2 encoder and 2
    decoder layers), one seeded set of weights on the card and a copy on
    the CPU: decode of token S-1 against the prefill of S tokens on the
    card, and card against CPU logits and greedy tokens over a prefill and
    4 decode steps. An MoE model's card run takes the reference
    computation's expert choices (``Routing``): the full prefill's for the
    decode, the CPU's for the card. Whisper takes seeded audio (B, 1,500,
    1,280) in both; llava seeded patches, all 2,880 on the card and the
    first CPU_PATCHES of them in the card-vs-CPU comparison."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.convert import tree_map
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              enc_layers=min(get_config(arch).enc_layers, 2))
    card = Model(cfg, device="cuda")
    params = card.init_params(0)
    host = tree_map(lambda t: t.to("cpu"), params)
    cpu = Model(cfg, device="cpu")
    V, B, S = cfg.vocab_size, 2, 64
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(2, V, (B, S), generator=gen, dtype=torch.int32)
    extra = family_inputs(torch, cfg, B, gen)
    dp = decode_vs_prefill(torch, card, params, toks, f"model {arch}",
                           {k: t.cuda() for k, t in extra.items()})
    cut = ""
    if "patches" in extra:
        extra = {"patches": extra["patches"][:, :CPU_PATCHES]}
        cut = (f"; card vs CPU over {CPU_PATCHES} of the {cfg.n_patches} patches "
               f"(the CPU side cut), decode vs prefill over all of them")
    room = prefix_len(extra) + S + 8
    errs, agree, clear_n = [], 0, 0
    t_cpu = time.perf_counter()
    with Routing(torch, force=lambda dev, i: (routes.calls["cpu"][i][1]
                                              if dev == "cuda" else None)) as routes:
        lh, ch, kh = cpu.prefill(host, {"tokens": toks, **extra}, room)
        lc, cc, kc = card.prefill(params, {"tokens": toks, **{k: t.cuda() for k, t
                                                               in extra.items()}}, room)
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
            if step == 4:
                break
            tok = b.argmax(1).to(torch.int32)
            lh, ch, kh = cpu.decode_step(host, ch, tok, kh)
            lc, cc, kc = card.decode_step(params, cc, tok.cuda(), kc)
    flips, dx = (near_ties(torch, routes.calls["cpu"], routes.calls["cuda"],
                           f"model {arch} card vs CPU")
                 if routes.calls["cpu"] else (0, 0.0))
    require(max(errs) <= LOGIT_TOL, f"model {arch}: card vs CPU logits err {max(errs)}")
    routing = (f"; MoE routing forced onto the full prefill's / the CPU's choices "
               f"(router inputs within {dp['router_dx']:.4f} / {dx:.4f}; own choices "
               f"that differ, each a near tie: {dp['flips']} / {flips})"
               if routes.calls["cpu"] else "")
    log(f"model {arch}: 2-layer full width, decode vs prefill max |dlogit| "
        f"{dp['err']:.5f}; card vs CPU max |dlogit| {max(errs):.5f} over prefill + 4 "
        f"decode steps (tolerance {LOGIT_TOL}); greedy tokens equal {agree}/{5 * B} "
        f"({clear_n} beyond the margin){routing}{cut}; card and CPU runs "
        f"{time.perf_counter() - t_cpu:.1f} s")
    del card, params, cc, dp["full"]
    torch.cuda.empty_cache()
    return dict(decode_vs_prefill=dp["err"], card_vs_cpu=max(errs))


HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_LAYERS = 8              # one period: Mamba x 4, attention, Mamba x 3
# AI21-Jamba2-Mini, the benchmark's hybrid cell (configs/ai21_jamba2_mini.py:
# jamba's shapes, its variant's inner norms and routing without
# renormalisation, no RoPE), cut as the cell cuts it: two whole periods.
JAMBA2_ARCH = "ai21-jamba2-mini"
JAMBA2_LAYERS = 16


def check_hybrid(torch, counters) -> dict:
    """jamba at full width and one period of 8 layers (attention at 4, MoE
    FFNs of 16 experts top-2 on the odd layers), seeded bf16 weights on
    the card (no CPU copy: 27 GB of CPU MoE is too slow): decode of token
    63 against the prefill of 64 (``decode_vs_prefill``), then 4 greedy
    decode steps from the full prefill, every logit finite. mamba_scan
    must launch 7 times per prefill and decode step, flash_attention once
    per prefill and decode_attention once per decode step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_LAYERS)
    kinds = cfg.layer_kinds()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init_params(0)
    n_params = tree_sum(params, lambda t: t.numel())
    V, B, S, steps = cfg.vocab_size, 2, 64, 4
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(2, V, (B, S), generator=gen, dtype=torch.int32)
    dp = decode_vs_prefill(torch, model, params, toks, f"model {HYBRID_ARCH}")
    logits, cache, kv_len = dp.pop("full")
    for _ in range(steps):
        require(bool(torch.isfinite(logits[:, :V]).all()),
                f"model {HYBRID_ARCH}: non-finite logits")
        tok = logits[:, :V].argmax(-1).to(torch.int32)
        logits, cache, kv_len = model.decode_step(params, cache, tok, kv_len)
    require(bool(torch.isfinite(logits[:, :V]).all()), f"model {HYBRID_ARCH}: non-finite logits")
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
    prefills, decodes = 2, 1 + steps
    want = {"mamba_scan": kinds.count("mamba") * (prefills + decodes),
            "flash_attention": kinds.count("attn") * prefills,
            "decode_attention": kinds.count("attn") * decodes,
            **{k: cfg.mlp_kinds().count("moe") * (prefills + decodes) for k in MOE_KERNELS}}
    require(counts == want, f"model {HYBRID_ARCH}: launches {counts}, not {want} "
            f"({prefills} prefills and {decodes} decode steps)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log_card(f"model {HYBRID_ARCH}: full width, {HYBRID_LAYERS} layers {kinds} "
             f"(MoE on {cfg.mlp_kinds().count('moe')}), {n_params / 1e9:.2f} B parameters: "
             f"decode vs prefill max |dlogit| {dp['err']:.5f} (tolerance {LOGIT_TOL}; "
             f"routing forced onto the full prefill's, router inputs within "
             f"{dp['router_dx']:.4f}, own choices that differ, each a near tie: "
             f"{dp['flips']}); {steps} greedy decode steps finite; launches {counts}; "
             f"peak device memory {peak:.2f} GiB; {time.perf_counter() - t0:.1f} s")
    del model, params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return dict(decode_vs_prefill=dp["err"], launches=counts, peak_gib=peak)


def check_hybrid_serve(torch) -> dict:
    """AI21-Jamba2-Mini as the benchmark's cell runs it: the port's config
    cut to JAMBA2_LAYERS layers, every width as published, seeded bf16
    weights drawn on the card, through the engine's captured generation
    (``serving.engine.generate``) at B 8 and 3, prompt 64, 16 new tokens.
    Every prefill graph must record one mamba_scan per Mamba layer, one
    flash_attention per attention layer and one of each MoE kernel per
    MoE layer, every decode graph the same with decode_attention, and a
    profiled replay of each must run exactly what it recorded; the graph
    tokens and the expert counters must equal the eager loop's. The
    replays at B 8 are timed (CUDA events) beside the decode step's bound
    at the experts the steps reached."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.graphs import CapturedProgram
    from repro_torch.models import mamba as mam
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import generate
    cfg = dataclasses.replace(get_config(JAMBA2_ARCH), n_layers=JAMBA2_LAYERS)
    kinds, mlps = cfg.layer_kinds(), cfg.mlp_kinds()
    n_mamba, n_attn, n_moe = kinds.count("mamba"), kinds.count("attn"), mlps.count("moe")
    P, NEW, V, E = 64, 16, cfg.vocab_size, cfg.n_experts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init_params(0)
    n_params = tree_sum(params, lambda t: t.numel())
    normed = sum(all(n in sp["mix"] for n in mam.INNER_NORMS)
                 for kind, sp in zip(kinds, params["layers"]) if kind == "mamba")
    require(normed == n_mamba, f"serve {JAMBA2_ARCH}: {normed} of {n_mamba} Mamba layers "
            f"hold the inner norms")
    programs = CapturedProgram(model.device)
    rng = np.random.default_rng(13)
    counted, last = {8: [], 3: []}, {}
    with GenerateTimer(torch) as timer:
        for B, runs in ((8, 6), (3, 2)):
            for _ in range(runs):
                toks = rng.integers(2, V, (B, P)).astype(np.int32)
                state = generate(programs, model, params, {"tokens": toks}, P + NEW, NEW)
                host = state["host"].cpu().numpy()
                n = state["out"].numel()
                counted[B].append((int(host[n]), int(host[n + 1])))
                last[B] = (toks, host[:n].reshape(B, NEW))
        torch.cuda.synchronize()
    for key in programs.keys():
        require(key in timer.traced, f"serve {JAMBA2_ARCH}: graph {key} never replayed")
        traced, recorded = timer.traced[key]
        require(traced == recorded, f"serve {JAMBA2_ARCH}: a replay of graph {key} ran "
                f"{traced} launches of the port's kernels, its capture recorded {recorded}")
        got = {fn.__name__: k for fn, k in programs.recorded(key).items()}
        attn = "flash_attention" if key[0] == "prefill" else "decode_attention"
        want = {"mamba_scan": n_mamba, attn: n_attn, **dict.fromkeys(MOE_KERNELS, n_moe)}
        require(got == want, f"serve {JAMBA2_ARCH}: graph {key} recorded {got}, not {want}")
    for B, (toks, got) in last.items():
        reached = torch.zeros(2, dtype=torch.int32, device="cuda")
        want = eager_tokens(torch, model, params, toks, NEW, reached=reached)
        require(np.array_equal(got, want), f"serve {JAMBA2_ARCH}: B={B} graph tokens "
                f"{got.tolist()} differ from the eager loop's {want.tolist()}")
        require(tuple(reached.tolist()) == counted[B][-1], f"serve {JAMBA2_ARCH}: B={B} "
                f"graph counted experts {counted[B][-1]}, the eager loop {reached.tolist()}")
    pre = [c for c, _ in counted[8]]
    dec = [c for _, c in counted[8]]
    per_layer = statistics.mean(dec) / ((NEW - 1) * n_moe)
    require(all(2 * n_moe <= c <= E * n_moe for c in pre)
            and all(2 * n_moe * (NEW - 1) <= c <= E * n_moe * (NEW - 1) for c in dec),
            f"serve {JAMBA2_ARCH}: expert counts at B 8 {counted[8]} outside their bounds")
    step = decode_step_bound(params, cfg, 8, prompt_len=P, new_tokens=NEW, hit=per_layer)
    pre_ms, dec_ms = timer.ms("prefill", 8), timer.ms("decode", 8)
    numbers = dict(
        layers=JAMBA2_LAYERS, params=n_params, prefill_ms_p50=statistics.median(pre_ms),
        decode_ms_p50=statistics.median(dec_ms), decode_ms_p90=float(np.percentile(dec_ms, 90)),
        timed=(len(pre_ms), len(dec_ms)), experts_prefill=pre, experts_decode=dec,
        experts_per_moe_layer_decode=per_layer,
        uniform_expectation=expected_experts(E, cfg.moe_top_k, 8),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, **step)
    log_card(f"serve {JAMBA2_ARCH}: {JAMBA2_LAYERS} layers {kinds} (MoE on {n_moe}), "
             f"{n_params / 1e9:.2f} B parameters; graphs {sorted(programs.keys())} each "
             f"recorded, and ran when profiled, mamba_scan {n_mamba}, flash / decode "
             f"{n_attn}, each MoE kernel {n_moe}; graph tokens and expert counters equal "
             f"the eager loop's at B 8 and 3; {numbers}; "
             f"{time.perf_counter() - t0:.1f} s")
    for name, text in timer.profiles.items():
        log(f"serve {JAMBA2_ARCH}: profile of one {name} replay: {text}")
    del model, params, programs, timer, state
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


# ---------------------------------------------------------------- phase 9
ENCDEC_VLM_ARCHS = ("whisper-large-v3", "llava-next-mistral-7b")
GEN_PROMPT, GEN_NEW = 64, 16   # text tokens of a prompt, tokens generated
# generations per batch size: each graph's first replay is traced, the
# fourth prefill (B 3's second) and decode (B 8's) replays are profiled,
# the rest are timed
GEN_RUNS = {8: 4, 3: 3}


def path_launches(cfg) -> dict:
    """The model kernels one prefill and one decode step launch: whisper's
    prefill one flash_attention per encoder layer (non-causal over the
    frames) and two per decoder layer (causal self, non-causal cross), its
    decode step one flash_attention (cross, Sq 1) and one decode_attention
    (self) per layer; llava one flash_attention per layer of a prefill and
    one decode_attention per layer of a step."""
    L = cfg.n_layers
    if cfg.family == "encdec":
        return {"prefill": {"flash_attention": cfg.enc_layers + 2 * L},
                "decode": {"flash_attention": L, "decode_attention": L}}
    return {"prefill": {"flash_attention": L}, "decode": {"decode_attention": L}}


def run_encdec_vlm(torch, counters, arch: str) -> dict:
    """``arch`` (whisper-large-v3 or llava-next-mistral-7b) at full width
    and depth, seeded random bf16 weights drawn on the card, through the
    model facade: greedy generation of GEN_NEW tokens after GEN_PROMPT
    text tokens through the port's ``serving.engine.generate`` (a prefill
    and a decode-step graph per batch size, held by ``CapturedProgram``),
    with whisper's audio (B, 1,500, 1,280) or llava's patches (B, 2,880,
    4,096) made on the card before any timed window, at batch 8 and 3
    (``GEN_RUNS`` generations each). ``GenerateTimer`` times every replay
    by CUDA events, traces the first replay of each graph and profiles
    the fourth of each kind. Each prefill graph must have recorded exactly
    ``path_launches``' prefill launches and each decode graph its decode
    launches, and a traced replay must run what its capture recorded; the
    wrappers must have launched exactly those of the warm-ups and of the
    eager loops; kv_len after prefill is P + T (llava's P 2,880); the
    graphs' tokens equal the eager loop's for both batches, and every
    logit is finite."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.graphs import CapturedProgram
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import generate
    cfg = get_config(arch)
    path = path_launches(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init_params(0)
    n_params = tree_sum(params, lambda t: t.numel())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rng = np.random.default_rng(13)
    inputs = {B: {"tokens": rng.integers(2, cfg.vocab_size, (B, GEN_PROMPT)).astype(np.int32),
                  **family_inputs(torch, cfg, B, gen)} for B in GEN_RUNS}
    torch.cuda.synchronize()
    P = cfg.n_patches
    max_len = P + GEN_PROMPT + GEN_NEW
    programs = CapturedProgram(model.device)
    tokens = {}
    with GenerateTimer(torch) as timer:
        for B, n in GEN_RUNS.items():
            for _ in range(n):
                state = generate(programs, model, params, inputs[B], max_len, GEN_NEW,
                                 finite=True)
                require(bool(state["finite"]), f"{arch}: B={B} non-finite logits in a "
                        f"graph replay")
                kv0 = state["start"].tolist()
                require(kv0 == [P + GEN_PROMPT] * B, f"{arch}: kv_len after prefill "
                        f"{kv0}, not {P + GEN_PROMPT}")
                tokens[B] = state["out"].cpu().numpy()
        torch.cuda.synchronize()
    for B in GEN_RUNS:
        for kind in ("prefill", "decode"):
            got = programs.recorded((kind, B))
            got = {w.__name__: n for w, n in got.items()}
            require(got == path[kind], f"{arch}: a {kind} graph at B={B} recorded "
                    f"{got}, not {path[kind]}")
    for key in programs.keys():
        require(key in timer.traced, f"{arch}: graph {key} never replayed")
        traced, recorded = timer.traced[key]
        require(traced == recorded, f"{arch}: a replay of graph {key} ran {traced} "
                f"launches of the port's kernels, its capture recorded {recorded}")
    for B in GEN_RUNS:
        batch = dict(inputs[B])
        want = eager_tokens(torch, model, params, batch.pop("tokens"), GEN_NEW, batch)
        require(np.array_equal(tokens[B], want), f"{arch}: B={B} graph tokens "
                f"{tokens[B].tolist()} differ from the eager loop's {want.tolist()}")
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
    # wrapper calls: per batch size one warm-up and one eager run of each
    # program kind, the eager loop's decode GEN_NEW - 1 times
    n_pre, n_dec = 2 * len(GEN_RUNS), (1 + GEN_NEW - 1) * len(GEN_RUNS)
    want = {}
    for kind, n in (("prefill", n_pre), ("decode", n_dec)):
        for k, per in path[kind].items():
            want[k] = want.get(k, 0) + per * n
    require(counts == want, f"{arch}: launches at wrapper calls {counts}, not {want}")
    replayed = recorded_launches(programs, programs.replays)
    replayed = {k: n for k, n in replayed.items() if n}
    reps = {k: graph_count(programs.replays, k) for k in ("prefill", "decode")}
    peak = torch.cuda.max_memory_allocated() / 2**30
    pre8, pre3 = timer.ms("prefill", 8), timer.ms("prefill", 3)
    dec8, dec3 = timer.ms("decode", 8), timer.ms("decode", 3)
    step = decode_step_bound(params, cfg, 8, prompt_len=P + GEN_PROMPT, new_tokens=GEN_NEW)
    numbers = dict(
        params_b=n_params / 1e9, prefill_ms_b8=pre8, prefill_ms_b3=pre3,
        decode_ms_p50_b8=statistics.median(dec8),
        decode_ms_p99_b8=float(np.percentile(dec8, 99)),
        decode_ms_p50_b3=statistics.median(dec3), peak_gib=peak,
        launches=counts, replay_launches=replayed, **step)
    log_card(f"encdec_vlm {arch}: full width and depth, {n_params / 1e9:.3f} B parameters "
             f"({cfg.enc_layers} encoder + {cfg.n_layers} decoder layers)"
             if cfg.family == "encdec" else
             f"encdec_vlm {arch}: full width and depth, {n_params / 1e9:.3f} B parameters, "
             f"{cfg.n_layers} layers, {P} patches + {GEN_PROMPT} tokens: kv_len after "
             f"prefill {P + GEN_PROMPT}")
    log_card(f"encdec_vlm {arch}: prefill replay ms at B 8 {[round(t, 3) for t in pre8]}, "
             f"at B 3 {[round(t, 3) for t in pre3]}; decode replay ms a token at B 8 p50 "
             f"{numbers['decode_ms_p50_b8']:.4f} p99 {numbers['decode_ms_p99_b8']:.4f} "
             f"({len(dec8)} timed), at B 3 p50 {numbers['decode_ms_p50_b3']:.4f} "
             f"({len(dec3)} timed); "
             f"peak device memory {peak:.2f} GiB (graphs included)")
    log_card(f"encdec_vlm {arch}: decode step bound at B 8 {step['decode_bound_ms']:.4f} ms, "
             f"{step['decode_bound_by']} ({step['decode_bytes'] / 1e9:.4f} GB: bf16 decoder "
             f"layers, bf16 head, {step['decode_state']}"
             + (f", the cross K/V {step['decode_cross_bytes'] / 1e9:.4f} GB; the cross "
                f"wk / wv and the encoder not read" if step["decode_cross_bytes"] else "")
             + f"); the fp32 head copy the port reads instead adds "
             f"{step['fp32_head_extra_ms']:.4f} ms; decode p50 / bound "
             f"{numbers['decode_ms_p50_b8'] / step['decode_bound_ms']:.2f}")
    for kind, text in timer.profiles.items():
        log(f"encdec_vlm {arch}: profile of one {kind} replay: {text}")
    log(f"encdec_vlm {arch}: each prefill graph recorded {path['prefill']}, each decode "
        f"graph {path['decode']}; graph replays {reps}, their launches {replayed} (a traced "
        f"replay of each of the {len(timer.traced)} graphs ran exactly its recorded "
        f"launches); launches at wrapper calls {counts} (warm-ups and eager loops); graph tokens "
        f"equal the eager loop's for B = 8 and B = 3 ({GEN_NEW} tokens each), every logit "
        f"finite; {time.perf_counter() - t0:.1f} s")
    del timer, programs, model, params, inputs, state
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


# ---------------------------------------------------------------- MoE FFN
MOE_REL = 2.0 ** -6           # routed (bf16 products) against dense exact (fp32):
                               # of the largest |y|, four bf16 ulps there (the card
                               # rounds g, u, the hidden and each expert's output)
MOE_SHAPES = (("granite_prefill", "granite-moe-3b-a800m", 512),
              ("granite_decode", "granite-moe-3b-a800m", 8),
              ("jamba_prefill", HYBRID_ARCH, 128),
              ("jamba2_decode", JAMBA2_ARCH, 8),
              ("jamba2_prefill", JAMBA2_ARCH, 512))
TIE_PAIRS = ((1, 38), (3, 4), (0, 39))   # duplicated router columns (granite's 40)


def expected_experts(E: int, k: int, batch: float) -> float:
    """Distinct experts that ``batch`` tokens reach under uniform top-k."""
    return E * (1 - (1 - k / E) ** batch)


def route_ties(torch, moe, cfg, T: int) -> int:
    """A router with duplicated columns and inputs whose logits are exact
    (inputs in {-1, 0, 1}, weights in 64ths up to 1/8: every sum exact in
    any order, and spread little enough that no probability underflows),
    on the card: the ids equal the stable descending order of the exact
    logits, so where a tied pair straddles the k-th place the lower
    expert is taken. Returns how many tokens it decided so."""
    gen = torch.Generator().manual_seed(41)
    x = torch.randint(-1, 2, (T, cfg.d_model), generator=gen).to(torch.float32)
    w = torch.randint(-8, 9, (cfg.d_model, cfg.n_experts), generator=gen) / 64
    for lo, hi in TIE_PAIRS:
        w[:, hi] = w[:, lo]
    ids = moe.route(x.to(torch.bfloat16).cuda(), w.cuda(), cfg)[0].cpu()
    want = (x.double() @ w.double()).sort(dim=1, descending=True, stable=True).indices
    require(torch.equal(ids.long(), want[:, :cfg.moe_top_k]),
            "moe route: ids on the card are not the exact logits' stable top-k")
    straddle = sum((lo in row) != (hi in row) for row in ids.tolist()
                   for lo, hi in TIE_PAIRS)
    require(straddle > 0 and all(lo in row for row in ids.tolist()
                                 for lo, hi in TIE_PAIRS if (lo in row) != (hi in row)),
            f"moe route: {straddle} tied pairs cut by the k-th place, the lower "
            f"expert not always taken")
    return straddle


def bf16_ulps(torch, a, b) -> int:
    """The largest distance in bf16 steps between two bf16 tensors."""
    def ordered(t):
        u = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def route_flips(torch, x, w, plain_ids, ids, label: str) -> int:
    """The routing kernel's choices against the plain version's on the same
    input (``near_ties``' rule with the two router products' own rounding
    as their difference): a token whose choice differs must have its k-th
    and (k+1)-th logits within twice the bound on two fp32 sums of d
    products in different orders, d·2^-24·Σ|x·w|. Returns the flips."""
    xf, wf = x.float().cpu(), w.float().cpu()
    logits = xf.double() @ wf.double()
    k = ids.shape[1]
    top = logits.sort(dim=1, descending=True).values
    margin = top[:, k - 1] - top[:, k]
    noise = xf.shape[1] * 2.0 ** -24 * (xf.abs() @ wf.abs()).max(dim=1).values
    flips = 0
    for t in range(ids.shape[0]):
        if set(plain_ids[t].tolist()) != set(ids[t].tolist()):
            flips += 1
            require(float(margin[t]) <= 2 * float(noise[t]) + 1e-6,
                    f"{label}: token {t} routed to {ids[t].tolist()} by the kernel, "
                    f"{plain_ids[t].tolist()} by the plain version, margin "
                    f"{float(margin[t])} beyond twice the rounding bound {float(noise[t])}")
    return flips


def check_moe_kernels(torch, moe, mf, p, cfg, x) -> dict:
    """Each of ``moe_fused``'s kernels against its plain version on the
    card, on one input: routing (ids equal but at near ties, weights
    within 1e-5 where the ids agree), dispatch (order, offsets and rows
    bit for bit, on the kernel's ids, and the count it adds the distinct
    ids), SwiGLU and combine (within one bf16
    step), and each kernel's device time beside the plain version's; the
    routing in the model's own mode (renormalised or not, its variant's)."""
    from repro_torch.kernels import ops
    from repro_torch.models.variants import variant_of
    k, E = cfg.moe_top_k, cfg.n_experts
    renorm = variant_of(cfg).moe_renormalize
    before = {f.__name__: (f.launches, f.recorded) for f in
              (mf.moe_route, mf.moe_dispatch, mf.swiglu_cast, mf.moe_combine)}
    _, plain_ids, plain_w = mf.route_plain(x, p["router"], k, renormalize=renorm)
    ids, weights = ops.moe_route(x, p["router"], k, renormalize=renorm)
    flips = route_flips(torch, x, p["router"], plain_ids.cpu(), ids.cpu(),
                        f"moe_route {cfg.name} T {x.shape[0]}")
    same = (plain_ids.to(torch.int32) == ids).all(dim=1)
    werr = float((weights - plain_w)[same].abs().max()) if bool(same.any()) else 0.0
    require(werr <= 1e-5, f"moe_route: weights {werr} from the plain version's")
    count = torch.full((1,), 5, dtype=torch.int32, device=x.device)
    order, offs, rows = ops.moe_dispatch(ids, x, E, count)
    p_order, p_offs, p_rows = mf.dispatch_plain(ids, x, E)
    require(torch.equal(order.long(), p_order) and torch.equal(offs, p_offs)
            and torch.equal(rows, p_rows), "moe_dispatch: order, offs or rows differ "
            "from the stable sort's")
    reached = int(count) - 5
    require(reached == ids.unique().numel(), f"moe_dispatch: the counter gained {reached}, "
            f"the ids hold {ids.unique().numel()} experts")
    g = moe.grouped_mm(rows, p["w_gate"], offs)
    u = moe.grouped_mm(rows, p["w_up"], offs)
    hidden = ops.swiglu_cast(g, u, x.dtype)
    s_ulps = bf16_ulps(torch, hidden, mf.swiglu_plain(g, u, x.dtype))
    part = moe.grouped_mm(hidden, p["w_down"], offs)
    y = ops.moe_combine(part, order, weights)
    c_ulps = bf16_ulps(torch, y, mf.combine_plain(part, p_order, weights))
    require(s_ulps <= 1 and c_ulps <= 1, f"swiglu_cast {s_ulps}, moe_combine {c_ulps} "
            f"bf16 steps from their plain versions (at most 1); combine's largest |dy| "
            f"{float((y.float() - mf.combine_plain(part, p_order, weights).float()).abs().max())}"
            f" of max |y| {float(y.float().abs().max())}")
    times = dict(
        route_ms=graph_ms(torch, [lambda: ops.moe_route(x, p["router"], k,
                                                         renormalize=renorm)]),
        route_plain_ms=graph_ms(torch, [lambda: mf.route_plain(x, p["router"], k,
                                                                 renormalize=renorm)]),
        dispatch_ms=graph_ms(torch, [lambda: ops.moe_dispatch(ids, x, E)]),
        dispatch_plain_ms=graph_ms(torch, [lambda: mf.dispatch_plain(ids, x, E)]),
        swiglu_ms=graph_ms(torch, [lambda: ops.swiglu_cast(g, u, x.dtype)]),
        swiglu_plain_ms=graph_ms(torch, [lambda: mf.swiglu_plain(g, u, x.dtype)]),
        combine_ms=graph_ms(torch, [lambda: ops.moe_combine(part, order, weights)]),
        combine_plain_ms=graph_ms(torch, [lambda: mf.combine_plain(part, p_order, weights)]))
    return dict(renormalize=renorm, route_flips=flips, route_weight_err=werr,
                swiglu_ulps=s_ulps,
                combine_ulps=c_ulps, experts_reached=reached, **times,
                launches={n: (f.launches - before[n][0], f.recorded - before[n][1])
                          for n, f in ((f.__name__, f) for f in (
                              mf.moe_route, mf.moe_dispatch, mf.swiglu_cast,
                              mf.moe_combine))})


def chain_ffn(torch, moe, mf, x, p, cfg):
    """The routed FFN as PyTorch ops on the card, the Switch loss included:
    the path serving took before the kernels (``moe_fused``'s plain
    versions, in the model's routing mode), timed beside it."""
    from repro_torch.models.variants import variant_of
    k, E = cfg.moe_top_k, cfg.n_experts
    probs, ids, weights = mf.route_plain(x, p["router"], k,
                                         renormalize=variant_of(cfg).moe_renormalize)
    aux = moe._switch_aux(probs, ids)
    order, offs, rows = mf.dispatch_plain(ids.to(torch.int32), x, E)
    g = moe.grouped_mm(rows, p["w_gate"], offs)
    u = moe.grouped_mm(rows, p["w_up"], offs)
    hidden = mf.swiglu_plain(g, u, x.dtype)
    part = moe.grouped_mm(hidden, p["w_down"], offs).to(x.dtype)
    return mf.combine_plain(part, order, weights), aux


def check_moe_ffn(torch) -> dict:
    """The routed MoE FFN as serving runs it (``moe_ffn_routed`` without
    aux: ``moe_fused``'s kernels around ``torch._grouped_mm`` on the card)
    against the dense exact path (every expert in fp32) on the same card,
    seeded bf16 inputs, at granite-moe's layer (T 512: a prefill of 8 x
    64; T 8: a decode step at batch 8), jamba's (T 128: 2 x 64) and
    AI21-Jamba2-Mini's (jamba's widths, top-2 weights not renormalised:
    T 8 and 512, the benchmark cell's decode step and prefill), each
    timed (CUDA events around graph replays) beside the op chain it
    replaced (``chain_ms``), the dense path and the bound (the experts
    this run's tokens reach, their weight bytes at the HBM rate, or the
    routed products at the bf16 rate); each kernel against its plain
    version (``check_moe_kernels``); and route's ties at granite's
    width."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_fused as mf
    from repro_torch.models import moe
    from repro_torch.models.layers import init_moe
    out = {}
    for label, arch, T in MOE_SHAPES:
        cfg = get_config(arch)
        d, ffe, E, k = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.moe_top_k
        gen = torch.Generator(device="cuda")
        gen.manual_seed(31)
        p = init_moe(gen, cfg, "cuda")
        xs = [torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2)]
        err, tol, used = 0.0, math.inf, []
        for x in xs:
            got, none = moe.moe_ffn_routed(x, p, cfg, aux=False)
            want, _ = moe.moe_ffn_dense_exact(x, p, cfg)
            require(none is None and got.dtype == torch.bfloat16 and got.shape == (T, d)
                    and bool(torch.isfinite(got).all()), f"moe {label}: bad output")
            e = float((got.float() - want.float()).abs().max())
            t = MOE_REL * float(want.float().abs().max())
            require(e <= t, f"moe {label}: routed vs dense exact err {e} > {t}")
            err, tol = max(err, e), min(tol, t)
            used.append(moe.route(x, p["router"], cfg)[0].unique().numel())
        w_bytes = 3 * d * ffe * p["w_gate"].element_size()
        nbytes = (statistics.mean(used) * w_bytes + p["router"].nbytes
                  + 2 * T * d * xs[0].element_size())
        flops = 2 * T * k * 3 * d * ffe + 2 * T * d * E
        b = bound(nbytes, flops, BF16_OPS_PER_S)
        out[label] = dict(
            arch=arch, T=T, max_abs_err=err, tol=tol, experts_used=used,
            ms=graph_ms(torch, [lambda x=x: moe.moe_ffn_routed(x, p, cfg, aux=False)
                                for x in xs]),
            chain_ms=graph_ms(torch, [lambda x=x: chain_ffn(torch, moe, mf, x, p, cfg)
                                      for x in xs]),
            dense_ms=graph_ms(torch, [lambda x=x: moe.moe_ffn_dense_exact(x, p, cfg)
                                      for x in xs]),
            bound_ms=b[0], bound_by=b[1], bytes=nbytes, flops=flops,
            kernels=check_moe_kernels(torch, moe, mf, p, cfg, xs[0]))
        if label == "granite_prefill":
            out[label]["tie_straddles"] = route_ties(torch, moe, cfg, T)
        log_card(f"moe_ffn {label}: {arch} d {d} ffe {ffe} E {E} top {k}, T {T}: "
                 f"{out[label]}")
        del p, xs
        torch.cuda.empty_cache()
    return out


# moe_route's two modes at Jamba's routing (d 4,096, E 16, top 2): a decode
# step at batch 8 and a prefill of 8 x 64.
ROUTE_MODE_T = (8, 512)


def check_route_modes(torch) -> dict:
    """``moe_route`` without renormalisation (Jamba's router,
    ``models/variants.py``) against its plain version on the card at
    Jamba's routing: ids equal but at near ties (``route_flips``), the
    weights within 1e-5 where they agree, the renormalising mode's ids
    the same and its weights these divided by their sum; each mode and
    the plain version timed (CUDA events around graph replays)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_fused as mf
    from repro_torch.kernels import ops
    from repro_torch.models.layers import normal
    cfg = get_config(HYBRID_ARCH)
    d, E, k = cfg.d_model, cfg.n_experts, cfg.moe_top_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(37)
    router = normal(gen, (d, E), torch.float32, d ** -0.5, "cuda")
    out = {}
    for T in ROUTE_MODE_T:
        x = torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)
        _, p_ids, p_w = mf.route_plain(x, router, k, renormalize=False)
        ids, w = ops.moe_route(x, router, k, renormalize=False)
        flips = route_flips(torch, x, router, p_ids.cpu(), ids.cpu(),
                            f"moe_route without renormalisation T {T}")
        same = (p_ids.to(torch.int32) == ids).all(dim=1)
        werr = float((w - p_w)[same].abs().max()) if bool(same.any()) else 0.0
        require(werr <= 1e-5, f"moe_route without renormalisation: weights {werr} from "
                f"the plain version's")
        r_ids, r_w = ops.moe_route(x, router, k)
        rerr = float((r_w - w / w.sum(-1, keepdim=True)).abs().max())
        require(torch.equal(r_ids, ids) and rerr <= 1e-6,
                f"moe_route: the renormalising mode chose other experts or weights "
                f"{rerr} from the other mode's over their sum")
        out[T] = dict(flips=flips, weight_err=werr, renorm_err=rerr,
                      weight_sum_max=float(w.sum(-1).max()),
                      ms=graph_ms(torch, [lambda: ops.moe_route(x, router, k, renormalize=False)]),
                      renorm_ms=graph_ms(torch, [lambda: ops.moe_route(x, router, k)]),
                      plain_ms=graph_ms(torch, [lambda: mf.route_plain(x, router, k,
                                                                       renormalize=False)]))
        log_card(f"moe_route jamba2 T {T}: d {d} E {E} top {k}, no renormalisation: {out[T]}")
    return out


# ---------------------------------------------------------------- main
# ---------------------------------------------------------------- phase 10
GRAD_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# The fp32 gradients against the kernel's own forward: each input's
# directional derivative along t·r against the central difference at
# t·(1 ± FD_EPS·r), over |grad ⊙ t|. On the CPU with the plain versions
# this is ≤ 8e-5 at FD_EPS 1e-2; a k/v gradient swapped, or a causal
# flag lost, gives ≥ 2e-2.
FD_EPS, FD_TOL = 1e-2, 1e-3
# FlashAttentionFn's checked shapes: (label, B, Hq, Hkv, S, dh, causal).
# llama3.2-3b's training attention (B 8, S 512) and whisper's encoder
# (non-causal, 1,500 frames).
TRAIN_FLASH = (("llama", 8, HQ, HKV, 512, DH, True),
               ("whisper_enc", 8, 20, 20, 1500, 64, False))
# MambaScanFn's: falcon-mamba-7b's training scan (no h0, as training
# passes none), and a short one with h0 for its gradient.
TRAIN_SCAN = (("falcon", 8, 128, DI, False), ("h0", 2, 16, 1024, True))
TRAIN_CPU_REL = 0.1            # card vs CPU, each gradient leaf, of its largest |grad|
TRAIN_LOSS_TOL = 0.1           # card vs CPU loss (bf16 weights and activations)
RESUME_TOL = 2e-2              # the reference's tests/test_checkpoint.py tolerance
OPT_BYTES_PER_PARAM = 22       # AdamW, bf16 p and g, fp32 m and v: read 12, write 10
# The full-width runs: (arch, layers (None: all), B, S, timed steps).
TRAIN_RUNS = (("llama3.2-3b", None, 8, 512, 5), ("falcon-mamba-7b", 8, 8, 128, 3),
              ("granite-moe-3b-a800m", None, 8, 512, 3))
TRAIN_MODELS = ("llama3.2-3b", "falcon-mamba-7b", "granite-moe-3b-a800m")
MOE_GRAD_T = 128               # one jamba MoE layer's gradients, routed vs dense exact


def grad_errs(got, want) -> list:
    """Each pair's max |got - want| over the largest |want| (fp32)."""
    return [float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp(min=1e-30))
            for g, w in zip(got, want)]


def event_ms(torch, fn) -> tuple[float, object]:
    """(device ms of ``fn()`` between CUDA events, its result)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def warm_ms(torch, fn, reps: int = 3) -> float:
    """Median ``event_ms`` of ``fn()`` over ``reps`` calls after one
    untimed call (a library's first call loads and picks its kernels)."""
    fn()
    return statistics.median(event_ms(torch, fn)[0] for _ in range(reps))


def fd_errs(torch, gen, fn, ins, grads, cots) -> list:
    """Each input's gradient against ``fn`` (the kernel's forward, a
    tuple of outputs): <grad, t·r> (r ~ N(0, 1)) against the central
    difference of <cotangents, fn> at t·(1 ± FD_EPS·r), over |grad ⊙ t|
    (sums in fp64)."""
    def dot(outs):
        return sum(float((o.double() * c.double()).sum()) for o, c in zip(outs, cots))
    errs = []
    for i, (t, g) in enumerate(zip(ins, grads)):
        d = t * torch.randn(t.shape, generator=gen, device=t.device)
        plus, minus = list(ins), list(ins)
        plus[i], minus[i] = t + FD_EPS * d, t - FD_EPS * d
        fd = (dot(fn(*plus)) - dot(fn(*minus))) / (2 * FD_EPS)
        exact = float((g.double() * d.double()).sum())
        errs.append(abs(fd - exact) / float((g.double() * t.double()).norm()))
    return errs


def check_train_kernels(torch, dev, flash_shapes=TRAIN_FLASH, scan_shapes=TRAIN_SCAN
                        ) -> dict:
    """FlashAttentionFn and MambaScanFn on the card at the training
    shapes (``flash_shapes``, ``scan_shapes``; phase ``dist`` passes the
    local heads of a rank), fp32 and bf16:
    - the Function's forward equals the kernel wrapper's output bit for
      bit, and is held against the plain version: attention by
      ``flash_close``, the scan's y and h_final by ``attn_close`` within
      SCAN_ATOL (bf16 y: one bf16 step more);
    - the gradients of a random cotangent equal autograd of the plain
      version on the same inputs (the backward is that autograd, so this
      holds the saved inputs and flags), fp32 within 1e-4 and bf16 within
      2^-6 (four bf16 steps) of the largest |grad| of each input;
    - fp32: each input's gradient against the kernel's own forward
      (``fd_errs``, within FD_TOL), which ties the backward to what the
      card computes.
    Attention takes the model's (B, S, H, dh) projections through
    transposed views, as ``attend_prefill`` passes them. Each row is
    timed as the kernel table is (the kernel's forward, the plain
    version's and, for attention, SDPA's, CUDA graphs, beside the bound)
    and forward + backward (CUDA events, the median of 3 after one
    untimed call) beside the plain version's autograd and SDPA's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(2039)
    out = {}

    def fwd_bwd(fn, ins, dout):
        leaves = [t.detach().requires_grad_() for t in ins]
        y = fn(*leaves)
        return y, torch.autograd.grad(y, leaves, dout)

    for label, B, Hq, Hkv, S, dh, causal in flash_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            torch.cuda.empty_cache()
            name = str(dtype)[6:]
            what = f"train flash {label} {name}"
            q, k, v = (torch.randn((B, S, h, dh), generator=gen, device=dev).to(dtype)
                       .transpose(1, 2) for h in (Hq, Hkv, Hkv))
            dout = torch.randn((B, Hq, S, dh), generator=gen, device=dev).to(dtype)
            kw = dict(causal=causal, window=None, softcap=None, kv_offset=0)
            args = (kw["causal"], None, None, 0, None)
            y, got = fwd_bwd(lambda *t: fa.FlashAttentionFn.apply(*t, *args), (q, k, v), dout)
            require(torch.equal(y, fa.flash_attention(q, k, v, causal=causal)),
                    f"{what}: Function forward differs from the kernel's")
            err = flash_close(torch, fa, q, k, v, what=what, got=y.detach(), causal=causal)
            _, want = fwd_bwd(lambda *t: ref.attention_ref(*t, **kw), (q, k, v), dout)
            errs = grad_errs(got, want)
            require(all(g.dtype == dtype for g in got) and max(errs) <= GRAD_REL[name],
                    f"{what}: grad errors {errs} past {GRAD_REL[name]}")
            fd = []
            if dtype == torch.float32:
                fd = fd_errs(torch, gen, lambda *t: (fa.flash_attention(*t, causal=causal),),
                             (q, k, v), got, (dout,))
                require(max(fd) <= FD_TOL, f"{what}: grads against the kernel's forward "
                        f"{fd} past {FD_TOL}")
            nbytes, flops = flash_work(B, Hq, Hkv, S, S, dh, causal, q.element_size())
            b = bound(nbytes, flops, BF16_OPS_PER_S if dtype == torch.bfloat16
                      else FP32_OPS_PER_S)
            row = out[("flash_attention", f"train_{label}", name)] = dict(
                max_abs_err=err,
                ms=graph_ms(torch, [lambda: fa.flash_attention(q, k, v, causal=causal)]),
                plain_ms=graph_ms(torch, [lambda: fa.flash_attention_plain(q, k, v, **kw)]),
                bound_ms=b[0], bound_by=b[1],
                library_ms=sdpa_ms(torch, q, k, v, causal=causal),
                grad_rel_err=errs, fd_rel_err=fd,
                fwd_bwd_ms=warm_ms(torch, lambda: fwd_bwd(
                    lambda *t: fa.FlashAttentionFn.apply(*t, *args), (q, k, v), dout)),
                plain_fwd_bwd_ms=warm_ms(torch, lambda: fwd_bwd(
                    lambda *t: ref.attention_ref(*t, **kw), (q, k, v), dout)),
                library_fwd_bwd_ms=warm_ms(torch, lambda: fwd_bwd(
                    lambda *t: sdpa(*t, causal=causal), (q, k, v), dout)))
            log_card(f"train: FlashAttentionFn {label} B={B} Hq={Hq} Hkv={Hkv} S={S} "
                     f"dh={dh} causal={causal} {name} (transposed views): forward bit for "
                     f"bit with the kernel's, max |err| {err:.3g} against the plain "
                     f"version (held); grads (q, k, v) against the plain version's "
                     f"autograd {[f'{e:.2e}' for e in errs]} (bound {GRAD_REL[name]})"
                     + (f", against the kernel's forward {[f'{e:.2e}' for e in fd]} "
                        f"(bound {FD_TOL})" if fd else "")
                     + f"; forward {row['ms']:.6f} ms, bound {row['bound_ms']:.6f} "
                     f"({row['bound_by']}), plain {row['plain_ms']:.6f}, SDPA "
                     f"{row['library_ms']:.6f}; fwd+bwd {row['fwd_bwd_ms']:.3f} ms, plain "
                     f"{row['plain_fwd_bwd_ms']:.3f}, SDPA {row['library_fwd_bwd_ms']:.3f}")
            del q, k, v, dout, y, got, want
    for label, Bt, L, Dm, with_h0 in scan_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            torch.cuda.empty_cache()
            name = str(dtype)[6:]
            what = f"train scan {label} {name}"
            x, dt, A, Bc, Cc, D, h0 = scan_inputs(torch, gen, dev, Bt, L, dtype, Dm=Dm)
            h0 = h0 if with_h0 else None
            ins = [t for t in (x, dt, A, Bc, Cc, D, h0) if t is not None]
            no_h0 = [] if with_h0 else [None]
            dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
            dh = torch.randn((Bt, Dm, NS), generator=gen, device=dev)

            def run(fn):
                leaves = [t.detach().requires_grad_() for t in ins]
                y, h = fn(*leaves, *no_h0)
                return (y, h), torch.autograd.grad((y, h), leaves, (dy, dh))
            (y, h), got = run(ms.MambaScanFn.apply)
            yk, hk = ms.mamba_scan(x, dt, A, Bc, Cc, D, h0)
            require(torch.equal(y, yk) and torch.equal(h, hk),
                    f"{what}: Function forward differs from the kernel's")
            (yp, hp), want = run(ref.mamba_scan_ref)
            err = max(attn_close(torch, y.detach(), yp.detach(), SCAN_ATOL, f"{what} y"),
                      attn_close(torch, h.detach(), hp.detach(), SCAN_ATOL, f"{what} h"))
            errs = grad_errs(got, want)
            require(got[0].dtype == dtype and max(errs) <= GRAD_REL[name],
                    f"{what}: grad errors {errs} past {GRAD_REL[name]}")
            fd = []
            if dtype == torch.float32:
                fd = fd_errs(torch, gen, lambda *t: ms.mamba_scan(*t, *no_h0), ins, got,
                             (dy, dh))
                require(max(fd) <= FD_TOL, f"{what}: grads against the kernel's forward "
                        f"{fd} past {FD_TOL}")
            nbytes, n_ops = scan_work(Bt, L, Dm, NS, x.element_size(), with_h0)
            b = bound(nbytes, n_ops)
            row = out[("mamba_scan", f"train_{label}", name)] = dict(
                max_abs_err=err, ms=graph_ms(torch, [lambda: ms.mamba_scan(*ins, *no_h0)]),
                plain_ms=graph_ms(torch, [lambda: ms.mamba_scan_plain(*ins, *no_h0)],
                                  replays=5),
                bound_ms=b[0], bound_by=b[1], library_ms=None, grad_rel_err=errs,
                fd_rel_err=fd, fwd_bwd_ms=warm_ms(torch, lambda: run(ms.MambaScanFn.apply)),
                plain_fwd_bwd_ms=warm_ms(torch, lambda: run(ref.mamba_scan_ref)))
            log_card(f"train: MambaScanFn {label} Bt={Bt} L={L} Dm={Dm} N={NS} h0={with_h0} "
                     f"{name}: forward bit for bit with the kernel's, max |err| {err:.3g} "
                     f"against the plain version (y, h; held); grads (x, dt, A, B, C, D"
                     f"{', h0' * with_h0}) against the plain version's autograd "
                     f"{[f'{e:.2e}' for e in errs]} (bound {GRAD_REL[name]})"
                     + (f", against the kernel's forward {[f'{e:.2e}' for e in fd]} "
                        f"(bound {FD_TOL})" if fd else "")
                     + f"; forward {row['ms']:.6f} ms, bound {row['bound_ms']:.6f} "
                     f"({row['bound_by']}), plain {row['plain_ms']:.6f}; fwd+bwd "
                     f"{row['fwd_bwd_ms']:.3f} ms, plain {row['plain_fwd_bwd_ms']:.3f}")
            del x, dt, A, Bc, Cc, D, h0, ins, got, want, y, h, yp, hp
    return out


def train_batch(torch, cfg, B: int, S: int, device, seed: int = 0) -> dict:
    """One ``PackedBatcher`` batch of the synthetic corpus on ``device``."""
    from repro_torch.data import PackedBatcher, SyntheticCorpus
    nb = PackedBatcher(SyntheticCorpus(cfg.vocab_size, seed=seed), B, S).next_batch()
    return {k: torch.from_numpy(v).to(device) for k, v in nb.items()}


def loss_and_grads(torch, model, params, batch):
    """(the loss, autograd's gradient of every parameter leaf, None where
    the loss does not reach it)."""
    from repro_torch.models.convert import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), grads


def check_train_model(torch, arch: str) -> dict:
    """``arch`` at full width and 2 layers, one seeded set of bf16 weights
    on the card and a copy on the CPU (the plain versions), one packed
    batch (B 2, S 64): loss within TRAIN_LOSS_TOL, and every gradient
    leaf within TRAIN_CPU_REL of its largest |grad| (each leaf's error
    printed), none missing. An MoE model's CPU run takes the card's expert
    choices (``Routing``: the forward's and remat's recompute's), and every
    choice it would have made otherwise must be a near tie."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.convert import tree_map
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    card = Model(cfg, device="cuda")
    params = card.init_params(0)
    host = tree_map(lambda t: t.to("cpu"), params)
    t0 = time.perf_counter()
    with Routing(torch, force=lambda dev, i: (routes.calls["cuda"][i][1]
                                              if dev == "cpu" else None)) as routes:
        lc, gc_ = loss_and_grads(torch, card, params, train_batch(torch, cfg, 2, 64, "cuda"))
        lh, gh = loss_and_grads(torch, Model(cfg, device="cpu"), host,
                                train_batch(torch, cfg, 2, 64, "cpu"))
    flips, dx = (near_ties(torch, routes.calls["cuda"], routes.calls["cpu"],
                           f"train model {arch} card vs CPU")
                 if routes.calls["cuda"] else (0, 0.0))
    require(all(g is not None for g in gc_) and all(g is not None for g in gh),
            f"train model {arch}: a parameter got no gradient")
    errs = grad_errs([g.cpu() for g in gc_], gh)
    require(math.isfinite(lc) and abs(lc - lh) <= TRAIN_LOSS_TOL,
            f"train model {arch}: loss card {lc} vs CPU {lh}")
    require(max(errs) <= TRAIN_CPU_REL,
            f"train model {arch}: gradient errors {errs} past {TRAIN_CPU_REL}")
    routing = (f"; the CPU on the card's expert choices ({len(routes.calls['cuda'])} routing "
               f"calls, router inputs within {dx:.4f}; own choices that differ, each a near "
               f"tie: {flips})" if routes.calls["cuda"] else "")
    log_card(f"train model {arch}: 2-layer full width, loss card {lc:.5f} vs CPU {lh:.5f} "
             f"(tolerance {TRAIN_LOSS_TOL}); grad rel err per leaf (bound {TRAIN_CPU_REL}) "
             f"max {max(errs):.4f} {[round(e, 4) for e in errs]}{routing}; "
             f"{time.perf_counter() - t0:.1f} s")
    del card, params, gc_
    torch.cuda.empty_cache()
    return dict(loss_card=lc, loss_cpu=lh, grad_rel_max=max(errs), flips=flips)


def train_step_bound(params, cfg, B: int, S: int) -> dict:
    """The least time of one train step of B × S tokens: its phases, each
    at its own roofline, summed. The bf16 layers: 6 · (N − embed − head)
    products a token at the bf16 tensor-core rate (every layer parameter
    counted as a matmul weight: norm scales, the scan's A and D and the
    conv taps are under 0.1 % of them), of an MoE layer's experts only the
    k of E a token is routed to (granite's top-8 of 40: a fifth). The
    head, which the loss computes in fp32: 6 · head a token at the fp32
    rate. Causal attention's QK^T and P·V: 12 · B · Hq · dh · S(S+1)/2 per
    attention layer (forward 4, backward 8) at the bf16 rate. The scan: 3
    · 7 · B · S · d_inner · d_state per Mamba layer (forward, backward
    twice) at the fp32 rate. AdamW: OPT_BYTES_PER_PARAM a parameter (every
    expert's too) at the HBM rate. The embedding lookup does no
    products."""
    n_params = tree_sum(params, lambda t: t.numel())
    n_embed, n_head = params["embed"].numel(), params["head"].numel()
    experts = tree_sum([layer["mlp"][n] for layer in params["layers"]
                        if "router" in layer.get("mlp", {}) for n in EXPERT_LEAVES],
                       lambda t: t.numel())
    active = n_params - n_embed - n_head - experts * (1 - cfg.moe_top_k / max(cfg.n_experts, 1))
    tokens = B * S
    kinds = cfg.layer_kinds()
    parts = {
        "layers_ms": 6 * active * tokens / BF16_OPS_PER_S,
        "head_fp32_ms": 6 * n_head * tokens / FP32_OPS_PER_S,
        "attention_ms": (12 * kinds.count("attn") * B * cfg.n_heads * cfg.head_dim
                         * S * (S + 1) // 2 / BF16_OPS_PER_S),
        "scan_ms": (3 * 7 * kinds.count("mamba") * tokens * cfg.ssm_d_inner
                    * cfg.ssm_d_state / FP32_OPS_PER_S),
        "adamw_ms": OPT_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S}
    parts = {k: v * 1e3 for k, v in parts.items()}
    return dict(bound_ms=sum(parts.values()), bound_parts=parts, params=n_params,
                embed_params=n_embed, head_params=n_head, expert_params=experts)


def step_split(torch, step_fn, params, opt_state, batch) -> dict:
    """One train step run as its two parts, ``step_fn.grads`` (the loss
    and its backward) and then ``step_fn.update`` (AdamW), each timed by
    CUDA events."""
    fb_ms, (_, grads) = event_ms(torch, lambda: step_fn.grads(params, batch))
    opt_ms, _ = event_ms(torch, lambda: float(
        step_fn.update(params, opt_state, grads)["grad_norm"]))
    return dict(fwd_bwd_ms=fb_ms, adamw_ms=opt_ms)


def run_train(torch, counters, arch: str, layers, B: int, S: int, timed: int) -> dict:
    """``arch`` trained at full width (``layers`` of its depth, None for
    all) on the card from seeded bf16 weights through the port's train
    step (``launch.steps.make_train_step``: loss, autograd, AdamW in
    place), ``PackedBatcher`` batches of B × S: one warm-up step, then
    ``timed`` steps, each timed by CUDA events around the step and the
    host's read of its loss. The kernels' launches are counted over the
    timed steps (set to 0 before them) and must be one per layer of
    their kind in the forward and one more in remat's recompute. Logs
    step ms (each and p50), tokens/s, peak memory, the bound
    (``train_step_bound``, each phase's share printed), each step's loss
    and grad norm (finite) and the change of the parameters (non-zero);
    then one more step run as its two parts (``step_split``), and one
    under the profiler (its largest kernels and idle share)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import PackedBatcher, SyntheticCorpus
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    t_run = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda")
    params = model.init_params(0)
    n_params = tree_sum(params, lambda t: t.numel())
    opt_cfg = AdamWConfig(lr=3e-4, state_dtype=cfg.opt_state_dtype, warmup_steps=1,
                          total_steps=timed + 1)
    opt_state = init_opt_state(params, opt_cfg)
    batcher = PackedBatcher(SyntheticCorpus(cfg.vocab_size, seed=0), B, S)
    step_fn = make_train_step(model, opt_cfg)

    def batch():
        return {k: torch.from_numpy(v).cuda() for k, v in batcher.next_batch().items()}

    t0 = time.perf_counter()
    warm = step_fn(params, opt_state, batch())
    warm_s = time.perf_counter() - t0
    watched = {"layer 0 mixer": next(iter(params["layers"][0]["mix"].values())),
               "head": params["head"], "final_norm": params["final_norm"]}
    before = {k: t.detach().clone() for k, t in watched.items()}
    kinds = cfg.layer_kinds()
    expect = {"flash_attention": kinds.count("attn"), "mamba_scan": kinds.count("mamba")}
    remat = 2 if cfg.remat in ("dots", "full") else 1
    for name in expect:
        counters[name].launches = 0
    steps = []
    for _ in range(timed):
        ms_, (loss, gnorm) = event_ms(torch, lambda: (
            lambda m: (float(m["loss"]), float(m["grad_norm"])))(
                step_fn(params, opt_state, batch())))
        steps.append((ms_, loss, gnorm))
    launches = {n: counters[n].launches for n in expect}
    for name, per_layer in expect.items():
        require(launches[name] == per_layer * remat * timed,
                f"train {arch}: {name} launched {launches[name]} times in {timed} steps, "
                f"not {per_layer} layers x {remat} (remat {cfg.remat}) x {timed}")
    require(all(math.isfinite(x) for s in steps for x in s[1:]),
            f"train {arch}: non-finite loss or grad norm {steps}")
    change = {k: float((t.detach().float() - before[k].float()).abs().max())
              for k, t in watched.items()}
    require(all(c > 0 for c in change.values()), f"train {arch}: parameters unchanged {change}")
    split = step_split(torch, step_fn, params, opt_state, batch())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        float(step_fn(params, opt_state, batch())["loss"])
        wall_us = (time.perf_counter() - t1) * 1e6
    trace = kernel_summary(torch, prof, wall_us, top=10)
    p50 = statistics.median(s[0] for s in steps)
    tokens = B * S
    sb = train_step_bound(params, cfg, B, S)
    bound_ms = sb["bound_ms"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = dict(arch=arch, layers=cfg.n_layers, params=n_params, B=B, S=S,
               step_ms=[s[0] for s in steps], step_ms_p50=p50,
               tokens_per_s=tokens / (p50 / 1e3), peak_gib=peak, bound_ms=bound_ms,
               bound_parts=sb["bound_parts"], bound_share=bound_ms / p50, warmup_s=warm_s,
               warmup_loss=float(warm["loss"]), losses=[s[1] for s in steps],
               grad_norms=[s[2] for s in steps], param_change=change,
               launches={n: c for n, c in launches.items() if expect[n]},
               launches_per_step={n: c // timed for n, c in launches.items() if expect[n]},
               **split)
    log_card(f"train {arch}: {cfg.n_layers} layers at full width, {n_params / 1e9:.3f} B "
             f"params, remat {cfg.remat}, {cfg.opt_state_dtype} moments, B {B} x S {S}: "
             f"step ms {[round(s[0], 3) for s in steps]} p50 {p50:.3f} "
             f"({tokens / (p50 / 1e3):.0f} tokens/s), bound {bound_ms:.3f} ms "
             f"({ {k: round(v, 3) for k, v in sb['bound_parts'].items()} }; the step at "
             f"{bound_ms / p50:.3f} of its bound), peak {peak:.2f} GiB, warm-up step "
             f"{warm_s:.1f} s, losses {[round(s[1], 4) for s in steps]}, grad norms "
             f"{[round(s[2], 4) for s in steps]}, param change {change}, launches a step "
             f"{res['launches_per_step']} ({remat} per layer with remat {cfg.remat}); one "
             f"more step split: loss + backward {split['fwd_bwd_ms']:.3f} ms, AdamW "
             f"{split['adamw_ms']:.3f} ms; a profiled step: {trace}; this run "
             f"{time.perf_counter() - t_run:.1f} s")
    del model, params, opt_state, watched, before, warm, prof
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_hybrid_train(torch, counters) -> dict:
    """jamba's period (HYBRID_LAYERS) at full width on the card from seeded
    bf16 weights: the loss and every gradient, B 2 × S 64, through
    ``GroupedMmFn``, ``FlashAttentionFn`` and ``MambaScanFn`` together (no
    optimizer: ≈ 27 GB of bf16 weights and as much of gradients leave no
    room for AdamW's fp32 state). The loss and every leaf finite, none
    missing; flash_attention and mamba_scan launched once per layer of
    their kind in the forward and once more in remat's recompute. Run
    twice: the first checked, the second timed (CUDA events)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_LAYERS)
    kinds = cfg.layer_kinds()
    remat = 2 if cfg.remat in ("dots", "full") else 1
    B, S = 2, 64
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init_params(0)
    n_params = tree_sum(params, lambda t: t.numel())
    batch = train_batch(torch, cfg, B, S, "cuda")
    for fn in counters.values():
        fn.launches = 0
    loss, grads = loss_and_grads(torch, model, params, batch)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
    missing = sum(g is None for g in grads)
    finite = all(bool(torch.isfinite(g).all()) for g in grads if g is not None)
    require(missing == 0 and finite and math.isfinite(loss),
            f"train {HYBRID_ARCH}: loss {loss}, {missing} leaves without a gradient, "
            f"gradients finite: {finite}")
    want = {"flash_attention": kinds.count("attn") * remat,
            "mamba_scan": kinds.count("mamba") * remat}
    require(counts == want, f"train {HYBRID_ARCH}: launches {counts}, not {want}")
    del grads
    ms, (_, grads) = event_ms(torch, lambda: loss_and_grads(torch, model, params, batch))
    del grads
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log_card(f"train {HYBRID_ARCH}: full width, {HYBRID_LAYERS} layers {kinds} (MoE on "
             f"{cfg.mlp_kinds().count('moe')}), {n_params / 1e9:.2f} B params, B {B} x S {S}, "
             f"loss and grads only: loss {loss:.5f}, every leaf's gradient finite, none "
             f"missing; launches {counts} ({remat} per layer with remat {cfg.remat}); loss + "
             f"backward {ms:.3f} ms; peak {peak:.2f} GiB; {time.perf_counter() - t0:.1f} s")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=HYBRID_ARCH, layers=HYBRID_LAYERS, params=n_params, B=B, S=S,
                loss=loss, fwd_bwd_ms=ms, peak_gib=peak, launches=counts,
                launches_per_step=counts)


def grouped_backward_paths(torch) -> dict:
    """The two products of ``GroupedMmFn``'s backward at granite's training
    shape (B 8 × S 512 tokens, top-8 of 40 experts: 32,768 rows, d 1,536,
    d_ff_expert 512; two experts with no rows), seeded bf16, each against
    the alternative it was chosen over, timed by CUDA events: dRows with
    the experts' transposed weights as a strided view (the port) against
    a contiguous copy of them; dW as one 2-D × 2-D ``_grouped_mm`` (the
    port) against one bf16 ``mm`` per expert. Both held against an fp32
    loop within MOE_REL of the largest |value|; the 2-D × 2-D product
    computed into memory filled with NaN first, and the experts with no
    rows held at zero."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-3b-a800m")
    E, d, f, N = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, 8 * 512 * cfg.moe_top_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    sizes = torch.rand(E, generator=gen, device="cuda") + 0.5
    sizes[[3, 17]] = 0.0
    sizes = (sizes / sizes.sum() * N).long()
    sizes[-1] += N - sizes.sum()
    offs = sizes.cumsum(0).to(torch.int32)
    rows = torch.randn((N, d), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((E, d, f), generator=gen, device="cuda") * d ** -0.5).to(torch.bfloat16)
    d_out = torch.randn((N, f), generator=gen, device="cuda").to(torch.bfloat16)
    ends = offs.tolist()
    starts = [0] + ends[:-1]
    want_rows = torch.empty((N, d), device="cuda")
    want_w = torch.zeros((E, d, f), device="cuda")
    for e, (a, b) in enumerate(zip(starts, ends)):
        want_rows[a:b] = d_out[a:b].float() @ w[e].float().t()
        want_w[e] = rows[a:b].float().t() @ d_out[a:b].float()

    def per_expert():
        out = torch.empty((E, d, f), dtype=torch.bfloat16, device="cuda")
        for e, (a, b) in enumerate(zip(starts, ends)):
            torch.mm(rows[a:b].t(), d_out[a:b], out=out[e])
        return out
    paths = {"d_rows_view": (lambda: moe._op_mm(d_out, w.transpose(-1, -2), offs), want_rows),
             "d_rows_copy": (lambda: moe._op_mm(d_out, w.transpose(-1, -2).contiguous(), offs),
                             want_rows),
             "d_w_grouped_2d": (lambda: moe._op_mm(rows.t(), d_out, offs), want_w),
             "d_w_per_expert": (per_expert, want_w)}
    out = {}
    for name, (fn, want) in paths.items():
        torch.full((E * d * f * 2,), float("nan"), dtype=torch.bfloat16, device="cuda")
        got = fn()                       # into memory that held NaN
        err = float((got.float() - want).abs().max())
        tol = MOE_REL * float(want.abs().max())
        require(err <= tol, f"moe grads {name}: max |err| {err} past {tol}")
        if name.startswith("d_w"):
            require(not got[3].any() and not got[17].any(),
                    f"moe grads {name}: an expert with no rows got a nonzero gradient")
        out[name] = dict(max_abs_err=err, ms=graph_ms(torch, [fn]))
    log_card(f"train: GroupedMmFn's backward products at granite's training shape (N {N}, "
             f"d {d}, ffe {f}, {E} experts, 2 without rows), each vs an fp32 loop (bound "
             f"{MOE_REL} of the largest |value|), the experts without rows zero: "
             f"{ {k: {m: round(v, 6) for m, v in r.items()} for k, r in out.items()} }")
    del rows, w, d_out, want_rows, want_w
    torch.cuda.empty_cache()
    return out


def check_moe_grads(torch) -> dict:
    """One MoE layer at jamba's full width (d 4,096, 16 experts top-2,
    d_ff_expert 14,336), seeded bf16 weights and MOE_GRAD_T rows on the
    card: the gradients of sum(y · dy) for x, the router and each expert
    matrix through ``moe_ffn_routed`` (``GroupedMmFn``) against autograd of
    ``moe_ffn_dense_exact`` (every expert in fp32), each within MOE_REL of
    its largest |grad| (the forward's bound); each timed (CUDA events)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import init_moe
    cfg = get_config(HYBRID_ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(37)
    p = init_moe(gen, cfg, "cuda")
    x = torch.randn((MOE_GRAD_T, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn((MOE_GRAD_T, cfg.d_model), generator=gen, device="cuda")
    names = ["x", *p]

    def grads(ffn):
        leaves = [x.clone().requires_grad_(), *(t.detach().requires_grad_() for t in p.values())]
        y, _ = ffn(leaves[0], dict(zip(p, leaves[1:])), cfg)
        return torch.autograd.grad((y.float() * dy).sum(), leaves)
    routed_ms, got = event_ms(torch, lambda: grads(moe.moe_ffn_routed))
    dense_ms, want = event_ms(torch, lambda: grads(moe.moe_ffn_dense_exact))
    errs = dict(zip(names, grad_errs(got, want)))
    dtypes = all(g.dtype == w.dtype for g, w in zip(got, want))
    require(dtypes and max(errs.values()) <= MOE_REL,
            f"moe grads {HYBRID_ARCH}: routed vs dense exact {errs} past {MOE_REL} "
            f"(dtypes equal: {dtypes})")
    log_card(f"train: moe_ffn grads {HYBRID_ARCH} T {MOE_GRAD_T} (d {cfg.d_model}, "
             f"{cfg.n_experts} experts top-{cfg.moe_top_k}, ffe {cfg.d_ff_expert}): routed "
             f"through GroupedMmFn vs autograd of the dense exact path, rel err per leaf "
             f"{ {k: round(v, 5) for k, v in errs.items()} } (bound {MOE_REL}); loss + "
             f"backward {routed_ms:.3f} ms, dense exact {dense_ms:.3f} ms (first calls)")
    del p, x, dy, got, want
    torch.cuda.empty_cache()
    return dict(grad_rel_err=errs, ms=routed_ms, dense_ms=dense_ms)


def check_train_resume(torch) -> dict:
    """llama3.2-3b at full width and 2 layers on the card, int8 moments
    (kimi-k2's setting: a 4 GB checkpoint where fp32 moments make 10 GB,
    and the quantized state through a save and a restore): 6 steps
    straight against 3, a restart from the ``AsyncCheckpointer``'s save,
    and 3 more; losses within RESUME_TOL (the embedding's backward sums
    bf16 rows with atomics, so a step need not be bit-reproducible). Then a
    checkpoint saved, the parameters changed in place before the writer
    finished, and restored: the saved values come back."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_training
    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=2, opt_state_dtype="int8")
    ckpt = ROOT / "build" / "train_resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    quiet = lambda *_: None  # noqa: E731
    kw = dict(batch=2, seq=64, log=quiet, device="cuda")
    t0 = time.perf_counter()
    full = run_training(cfg, steps=6, **kw)["losses"]
    t1 = time.perf_counter()
    run_training(cfg, steps=3, ckpt_dir=str(ckpt), ckpt_every=100, **kw)
    resumed = run_training(cfg, steps=6, ckpt_dir=str(ckpt), ckpt_every=100, **kw)
    t2 = time.perf_counter()
    require(resumed["steps_run"] == 3, f"train resume: ran {resumed['steps_run']} steps")
    again = resumed["losses"]
    err = max(abs(a - b) for a, b in zip(full[3:], again))
    require(err <= RESUME_TOL, f"train resume: losses {full[3:]} vs {again}")
    del resumed
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    tree = {"w": torch.randn((1024, 4096), generator=gen, device="cuda").to(torch.bfloat16),
            "n": torch.randn((4096,), generator=gen, device="cuda")}
    want = {k: t.clone() for k, t in tree.items()}
    snap = ckpt / "snapshot"
    writer = AsyncCheckpointer(str(snap))
    writer.save(1, tree)
    for t in tree.values():
        t.add_(1.0)                        # the next step's in-place update
    writer.wait()
    got, _, _ = restore_checkpoint(str(snap), device="cuda")
    require(all(torch.equal(got[k], want[k]) for k in want),
            "train resume: a restored snapshot differs from the values saved")
    shutil.rmtree(ckpt, ignore_errors=True)
    log_card(f"train resume: llama3.2-3b 2 layers full width, int8 moments, B 2 x S 64: "
             f"losses straight "
             f"{[round(x, 4) for x in full[3:]]} vs resumed "
             f"{[round(x, 4) for x in again]} max |diff| {err:.5f} (tolerance "
             f"{RESUME_TOL}); 6 straight steps {t1 - t0:.1f} s, 3 + save + restore + 3 + "
             f"save {t2 - t1:.1f} s; snapshot restored equal after an in-place change")
    return dict(resume_err=err)


def run_train_phase(torch, dev, counters) -> dict:
    """Phase 10: the kernels' Functions, the 2-layer card-vs-CPU checks,
    the full-width runs, jamba's period's gradients, one MoE layer's
    gradients against the dense path and the resume check. Also logs
    whether the card's ``torch._grouped_mm`` differentiates by itself, and
    why not (the port's ``GroupedMmFn`` does not use that backward)."""
    from repro_torch.models.moe import grouped_mm_has_backward
    out = {"kernels": check_train_kernels(torch, dev)}
    for arch in TRAIN_MODELS:
        out[f"model {arch}"] = check_train_model(torch, arch)
    out["runs"] = [run_train(torch, counters, *run) for run in TRAIN_RUNS]
    out["runs"].append(check_hybrid_train(torch, counters))
    out["moe_grads"] = check_moe_grads(torch)
    out["moe_backward_paths"] = grouped_backward_paths(torch)
    out["resume"] = check_train_resume(torch)
    has, why = grouped_mm_has_backward("cuda")
    log(f"train: torch._grouped_mm differentiates by itself on this card's torch "
        f"{torch.__version__} (two groups of 8 rows, 16 x 16, the gradient of a sum): "
        f"{has}{f' ({why})' if why else ''}")
    return out


# ---------------------------------------------------------------- phase 11
# Four ranks on the one card over gloo (``launch.mesh.launch_ranks``): the
# layouts, the collectives' results and every kernel on its local shard.
# Four processes share one card and gloo stages every CUDA buffer through
# host memory, so the times say nothing of a four-card deployment.
DIST_WORLD = 4
DIST_DEVICE = "cuda"
DIST_LLAMA = ("llama3.2-3b", 4, 8, 512, 2)      # arch, layers, B, S, timed steps
# arch, layers, B, S, steps. At capacity 8.0 each EP all-to-all carries
# eight times the tokens' pairs, staged through host: at S 512 a step took
# 31-34 s a rank (H100 80GB HBM3, 700.00 W), so S is cut to 128.
DIST_GRANITE = ("granite-moe-3b-a800m", 4, 8, 128, 2)
DIST_FFN_TOKENS = 4096                           # granite's EP FFN, card against CPU
DIST_PP_MICRO = 4
DIST_FLASH = (("dist_llama_local", 4, HQ // 2, HKV // 2, 512, DH, True),)
DIST_PP_TOL = 2e-3             # the reference's GPipe-vs-sequential bound
# Each leaf's update after the steps, ||mesh - one process|| / ||one process||.
# bf16 parameters: p - lr·u rounds to a bf16 step of 2^-14 near the init
# scale d^-0.5 (2^-13 above 0.0156), against updates of a few lr (3e-4),
# so half a step of rounding alone is ~0.2 of an update; a gradient that
# the mesh got wrong moves whole leaves the other way.
DIST_UPDATE_REL = 0.5
# Each step's grad norm against the one-process run's, relative (the
# first card run measured 0.18 %: bf16 gradients summed in another order).
DIST_GNORM_REL = 0.01
# The EP FFN, card against 4 CPU ranks: max |dy| over max |y| (bf16 grouped
# products on the card, fp32 loops on the CPU; the first card run measured
# 0.0234 of 3.344, 0.7 %), the bound the serve phase's MoE checks use.
DIST_FFN_REL = 2.0 ** -6


def time_collectives(torch, coll) -> dict:
    """Wraps the collectives' transports (all-gather and all-to-all, which
    every collective of a gloo group goes through, and the pipeline's send
    and receive) so that each call's host seconds add up in the returned
    dict. A stream sync before and after each call leaves the compute
    queued before it outside: staging syncs there anyway (``.cpu()``)."""
    spent = {"s": 0.0, "calls": 0, "by_op": {}}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.current_stream().synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.current_stream().synchronize()
            dt = time.perf_counter() - t0
            spent["s"] += dt
            spent["calls"] += 1
            op = spent["by_op"].setdefault(name.strip("_"), [0, 0.0])
            op[0] += 1
            op[1] += dt * 1e3
            return out
        return call

    for name in ("_all_gather", "_all_to_all", "send", "recv"):
        setattr(coll, name, timed(name, getattr(coll, name)))
    return spent


def ep_drops(torch, moe, calls) -> tuple[int, int]:
    """(pairs, dropped) over the ``_moe_local`` calls a spy recorded, the
    kept pairs recomputed from the expert ids each call took."""
    pairs = dropped = 0
    for c in calls:
        keep = moe.kept_pairs(c.args[1], c.kwargs["cfg"], c.kwargs["n_data"], c.kwargs["e_pad"])
        pairs += keep.numel()
        dropped += int((~keep).sum())
    return pairs, dropped


def dist_share(torch, blocks, full_shapes, plan, dist) -> dict:
    """This rank's bytes against the plan's share of the full tree (each
    leaf's bytes over the product of its spec's axis sizes)."""
    from repro_torch.models.convert import tree_leaves
    local = share = full = 0
    for t, shape, spec in zip(tree_leaves(blocks), tree_leaves(full_shapes), tree_leaves(plan)):
        n = math.prod(shape) * t.element_size()
        local += t.numel() * t.element_size()
        share += n // math.prod(dist.axis_size(a) for a in spec)
        full += n
    return dict(local_bytes=local, plan_share_bytes=share, full_bytes=full)


def dist_batches(torch, cfg, B: int, S: int, n: int) -> list:
    """``n`` successive ``PackedBatcher`` batches on the card (the same on
    every rank)."""
    from repro_torch.data import PackedBatcher, SyntheticCorpus
    batcher = PackedBatcher(SyntheticCorpus(cfg.vocab_size, seed=0), B, S)
    return [{k: torch.from_numpy(v).to(DIST_DEVICE) for k, v in batcher.next_batch().items()}
            for _ in range(n)]


def dist_llama(torch, rank, dist, counters, spent) -> dict:
    """llama3.2-3b at full width and DIST_LLAMA's layers on (data 2, model
    2): the sharded loss and gathered gradients at init against the
    one-process card run (rank 0), then timed train steps and the gathered
    parameters after them against the one-process steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.sharding import gather_tree, shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.convert import tree_leaves, tree_map, tree_unflatten
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    arch, layers, B, S, timed = DIST_LLAMA
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=DIST_DEVICE, dist=dist)
    full = Model(cfg, device=DIST_DEVICE).init_params(0)
    shapes = tree_map(lambda t: tuple(t.shape), full)
    params = shard_tree(full, model.plan, dist)
    del full
    torch.cuda.empty_cache()
    share = dist_share(torch, params, shapes, model.plan, dist)
    require(share["local_bytes"] == share["plan_share_bytes"],
            f"dist {arch} rank {rank}: blocks {share}")
    batches = dist_batches(torch, cfg, B, S, timed)
    opt_cfg = AdamWConfig(lr=3e-4, state_dtype=cfg.opt_state_dtype, warmup_steps=1,
                          total_steps=timed)
    opt = init_opt_state(params, opt_cfg, dist=dist, specs=model.plan)
    step = make_train_step(model, opt_cfg)
    t0 = time.perf_counter()
    loss0, grads = step.grads(params, batches[0])
    loss0 = float(loss0)
    grads = gather_tree(tree_unflatten(params, grads), model.plan, dist)
    torch.cuda.synchronize()
    out = dict(share=share, loss=loss0, grads_s=time.perf_counter() - t0)
    if rank == 0:
        one = Model(cfg, device=DIST_DEVICE)
        ref_params = one.init_params(0)
        ref_loss, ref_grads = loss_and_grads(torch, one, ref_params, batches[0])
        out.update(ref_loss=ref_loss, grad_errs=grad_errs(tree_leaves(grads), ref_grads))
        del ref_grads
    del grads
    torch.cuda.empty_cache()
    coll.all_reduce(torch.zeros(1, device=DIST_DEVICE), dist, ("data", "model"))   # a barrier
    steps, flash = [], []
    for batch in batches:
        counters["flash_attention"].launches = 0
        torch.cuda.synchronize()
        c0, t0 = spent["s"], time.perf_counter()
        m = step(params, opt, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t0) * 1e3, loss, gnorm,
                      (spent["s"] - c0) * 1e3))
        flash.append(counters["flash_attention"].launches)
    out.update(step_ms=[s[0] for s in steps], losses=[s[1] for s in steps],
               grad_norms=[s[2] for s in steps], coll_ms=[s[3] for s in steps],
               flash_per_step=flash,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    after = gather_tree(params, model.plan, dist)
    del params, opt, step
    torch.cuda.empty_cache()
    if rank == 0:
        init = [t.detach().clone() for t in tree_leaves(one.init_params(0))]
        one_step = make_train_step(one, opt_cfg)
        ref_opt = init_opt_state(ref_params, opt_cfg)
        ref = [tuple(float(v) for v in (m["loss"], m["grad_norm"]))
               for m in (one_step(ref_params, ref_opt, b) for b in batches)]
        out.update(ref_losses=[r[0] for r in ref], ref_grad_norms=[r[1] for r in ref],
                   update_rel=update_errs(init, tree_leaves(after), tree_leaves(ref_params)))
        del init, ref_params, ref_opt, one_step
    del after
    torch.cuda.empty_cache()
    return out


def dist_granite(torch, rank, dist, spent) -> dict:
    """granite-moe-3b-a800m at full width and DIST_GRANITE's layers on
    (data 2, model 2) through ``moe_ffn_ep`` (default layout,
    ``rs_combine``): at capacity 8.0 ``timed`` train steps (``TrainStep``:
    the EP backward through ``GroupedMmFn`` and the all-to-alls), no pair
    dropped in any EP call (forward or remat's recompute), and the
    gathered parameters after them against the one-process steps (rank 0,
    the routed path: nothing to drop); at the config's 1.5 the forward
    loss, its drops counted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.sharding import gather_tree, shard_batch, shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe
    from repro_torch.models.convert import tree_leaves
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    arch, layers, B, S, timed = DIST_GRANITE
    base = dataclasses.replace(get_config(arch), n_layers=layers)
    remat = 2 if base.remat in ("dots", "full") else 1
    torch.cuda.reset_peak_memory_stats()
    full = Model(base, device=DIST_DEVICE).init_params(0)
    batches = dist_batches(torch, base, B, S, timed)
    opt_cfg = AdamWConfig(lr=3e-4, state_dtype=base.opt_state_dtype, warmup_steps=1,
                          total_steps=timed)
    cfg = dataclasses.replace(base, capacity_factor=8.0)
    model = Model(cfg, device=DIST_DEVICE, dist=dist)
    params = shard_tree(full, model.plan, dist)
    del full
    opt = init_opt_state(params, opt_cfg, dist=dist, specs=model.plan)
    step = make_train_step(model, opt_cfg)
    coll.all_reduce(torch.zeros(1, device=DIST_DEVICE), dist, ("data", "model"))   # a barrier
    steps, staged = [], []
    with mock.patch.object(moe, "_moe_local", wraps=moe._moe_local) as spy:
        for batch in batches:
            torch.cuda.synchronize()
            c0, t0, n0 = spent["s"], time.perf_counter(), sum(coll.STAGED.values())
            m = step(params, opt, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3, loss, gnorm,
                          (spent["s"] - c0) * 1e3))
            staged.append(sum(coll.STAGED.values()) - n0)
    require(len(spy.call_args_list) == layers * remat * timed,
            f"dist {arch}: {len(spy.call_args_list)} EP calls in {timed} steps of {layers} "
            f"layers, not {layers} x {remat} (remat {cfg.remat}) x {timed}")
    counts = torch.tensor(ep_drops(torch, moe, spy.call_args_list), dtype=torch.float32,
                          device=DIST_DEVICE)
    pairs, dropped = (int(v) for v in coll.all_reduce(counts, dist, dist.batch_axes))
    out = {8.0: dict(step_ms=[s[0] for s in steps], losses=[s[1] for s in steps],
                     grad_norms=[s[2] for s in steps], coll_ms=[s[3] for s in steps],
                     staged_per_step=staged, pairs=pairs, dropped=dropped)}
    after = gather_tree(params, model.plan, dist)
    del params, opt, step
    torch.cuda.empty_cache()
    if rank == 0:          # the same steps in one process, from the same init
        one = Model(cfg, device=DIST_DEVICE)
        ref_params = one.init_params(0)
        init = [t.detach().clone() for t in tree_leaves(ref_params)]
        one_step = make_train_step(one, opt_cfg)
        ref_opt = init_opt_state(ref_params, opt_cfg)
        ref = [tuple(float(v) for v in (m["loss"], m["grad_norm"]))
               for m in (one_step(ref_params, ref_opt, b) for b in batches)]
        out[8.0].update(ref_losses=[r[0] for r in ref], ref_grad_norms=[r[1] for r in ref],
                        update_rel=update_errs(init, tree_leaves(after),
                                               tree_leaves(ref_params)))
        del one_step, ref_opt, ref_params, init
    del after
    full = Model(base, device=DIST_DEVICE).init_params(0)
    model = Model(base, device=DIST_DEVICE, dist=dist)
    params = shard_tree(full, model.plan, dist)
    del full
    torch.cuda.synchronize()
    c0, t0 = spent["s"], time.perf_counter()
    with torch.no_grad(), mock.patch.object(moe, "_moe_local", wraps=moe._moe_local) as spy:
        loss = float(model.loss_fn(params, shard_batch(batches[0], base, dist))[0])
    ms = (time.perf_counter() - t0) * 1e3
    require(len(spy.call_args_list) == layers,
            f"dist {arch}: {len(spy.call_args_list)} EP calls in {layers} layers")
    counts = torch.tensor(ep_drops(torch, moe, spy.call_args_list), dtype=torch.float32,
                          device=DIST_DEVICE)
    pairs, dropped = (int(v) for v in coll.all_reduce(counts, dist, dist.batch_axes))
    out[base.capacity_factor] = dict(loss=loss, pairs=pairs, dropped=dropped, forward_ms=ms,
                                     coll_ms=(spent["s"] - c0) * 1e3)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params
    torch.cuda.empty_cache()
    return out


def l2_errs(got, want) -> list:
    """Each pair's ||got - want|| / ||want|| (fp32)."""
    return [float((g.detach().float() - w.detach().float()).norm()
                  / w.detach().float().norm().clamp(min=1e-30)) for g, w in zip(got, want)]


def update_errs(init, got, want) -> list:
    """Each leaf's update ||(got - init) - (want - init)|| / ||want - init||."""
    return [l2_errs([g.detach().float() - p0.float()], [w.detach().float() - p0.float()])[0]
            for p0, g, w in zip(init, got, want)]


def dist_ffn_inputs(torch, device: str):
    """granite's MoE FFN at full width (its experts, seeded on the CPU, the
    same in every process) and DIST_FFN_TOKENS seeded bf16 rows. The
    router favours data shard 0's experts (their columns scaled by 5: 87 % of
    the pairs go to shard 0 at full width, against 75 % that fit): with
    an even routing over two shards capacity 1.5 would drop nothing."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.layers import init_moe
    cfg = dataclasses.replace(get_config(DIST_GRANITE[0]), n_layers=1)
    gen = torch.Generator()
    gen.manual_seed(11)
    p = init_moe(gen, cfg, "cpu")
    p["router"][:, :cfg.n_experts // 2] *= 5.0
    p = {k: t.to(device) for k, t in p.items()}
    x = torch.randn((DIST_FFN_TOKENS, cfg.d_model), generator=gen).to(torch.bfloat16)
    return cfg, p, x.to(device)


def dist_ffn(torch, dist, device: str) -> dict:
    """``moe_ffn_ep`` (default layout) at the config's capacity on this
    rank's rows: the kept mask of the pairs it routed and the drops."""
    from repro_torch.launch.sharding import param_plan, shard_tree
    from repro_torch.models import moe
    cfg, p, x = dist_ffn_inputs(torch, device)
    pspec = param_plan(cfg, dist, training=True).params["layers"][0]["mlp"]
    rows = x.shape[0] // (dist.n_pod * dist.n_data)
    b = dist.coord(dist.batch_axes)
    with torch.no_grad(), mock.patch.object(moe, "_moe_local", wraps=moe._moe_local) as spy:
        y, _ = moe.moe_ffn_ep(x[b * rows:(b + 1) * rows], shard_tree(p, pspec, dist), cfg,
                              dist, pspec=pspec)
    (c,) = spy.call_args_list
    keep = moe.kept_pairs(c.args[1], cfg, c.kwargs["n_data"], c.kwargs["e_pad"])
    return dict(batch_shard=b, keep=keep.cpu().numpy(), dropped=int((~keep).sum()),
                y=y.float().cpu().numpy())


def dist_gpipe(torch, rank, dist, counters, spent) -> dict:
    """llama3.2-3b at full width and DIST_LLAMA's layers as a GPipe over
    pod 2 (data 1, model 2), DIST_PP_MICRO microbatches: the loss, then
    ``loss.backward()`` on every rank (the reverse drain), the gradients
    gathered, against the sequential one-process loss and gradients (rank
    0). The forward and the backward timed apart (host clock, synced),
    each with the ms in the staged transfers and the calls staged."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.pipeline import make_pp_loss, pp_stack_specs, reshape_stack_for_pp
    from repro_torch.launch.sharding import gather_tree, shard_tree
    from repro_torch.models.convert import tree_leaves, tree_map, tree_unflatten
    from repro_torch.models.model import Model
    arch, layers, B, S, _ = DIST_LLAMA
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = Model(cfg, device=DIST_DEVICE, dist=dist)
    full = Model(cfg, device=DIST_DEVICE).init_params(0)
    batch = dist_batches(torch, cfg, B, S, 1)[0]
    out = {}
    if rank == 0:
        out["seq_loss"], seq = loss_and_grads(torch, Model(cfg, device=DIST_DEVICE), full, batch)
    pp = dict(full, layers=reshape_stack_for_pp(full["layers"], dist.n_pod))
    specs = dict(model.plan, layers=pp_stack_specs(model.plan["layers"], dist.n_pod))
    local = tree_map(lambda t: t.detach().requires_grad_(), shard_tree(pp, specs, dist))
    leaves = tree_leaves(local)
    del full, pp
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counters["flash_attention"].launches = 0
    c0, n0, t0 = spent["s"], sum(coll.STAGED.values()), time.perf_counter()
    loss, _ = make_pp_loss(model, DIST_PP_MICRO)(local, batch)
    torch.cuda.synchronize()
    c1, n1, t1 = spent["s"], sum(coll.STAGED.values()), time.perf_counter()
    out["flash"] = counters["flash_attention"].launches
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out.update(pp_loss=float(loss.detach()), pp_ms=(t1 - t0) * 1e3, coll_ms=(c1 - c0) * 1e3,
               staged=n1 - n0, bwd_ms=(t2 - t1) * 1e3, bwd_coll_ms=(spent["s"] - c1) * 1e3,
               bwd_staged=sum(coll.STAGED.values()) - n1,
               bwd_flash=counters["flash_attention"].launches - out["flash"])
    grads = gather_tree(tree_unflatten(local, [p.grad for p in leaves]), specs, dist)
    # back to the sequential stack: stage s's j-th layer is layer s·L/P + j
    grads["layers"] = [tree_map(lambda t: t[st], layer) for st in range(dist.n_pod)
                       for layer in grads["layers"]]
    if rank == 0:
        got = tree_leaves(grads)
        out.update(grad_errs=grad_errs(got, seq), grad_l2=l2_errs(got, seq))
        del seq
    del local, leaves, grads, loss
    torch.cuda.empty_cache()
    return out


def dist_rank(rank, world) -> dict:
    """One rank of phase 11 on the card: llama training, granite's EP
    loss and FFN on (data 2, model 2), then the GPipe on (pod 2, data 1,
    model 2). Returns its measurements (rank 0 also the one-process
    references)."""
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.context import Dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {fn.__name__: fn for fn in ops.COUNTED}
    dist = Dist.from_mesh(make_mesh((2, 2), ("data", "model"), DIST_DEVICE))
    spent = time_collectives(torch, coll)
    t0 = time.perf_counter()
    out = dict(llama=dist_llama(torch, rank, dist, counters, spent))
    out["granite"] = dist_granite(torch, rank, dist, spent)
    out["ffn"] = dist_ffn(torch, dist, DIST_DEVICE)
    pp = Dist.from_mesh(make_mesh((2, 1, 2), ("pod", "data", "model"), DIST_DEVICE))
    out["gpipe"] = dist_gpipe(torch, rank, pp, counters, spent)
    out["staged"] = dict(coll.STAGED)
    out["seconds"] = time.perf_counter() - t0
    return out


def dist_ffn_cpu_rank(rank, world) -> dict:
    """The same EP FFN as ``dist_ffn`` on a CPU gloo rank."""
    import torch

    from repro_torch.distributed.context import Dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(2)
    return dist_ffn(torch, Dist.from_mesh(make_mesh((2, 2), ("data", "model"), "cpu")),
                    "cpu")


def run_dist_phase(torch, dev, counters) -> dict:
    """Phase 11 (see the module docstring)."""
    import numpy as np

    from repro_torch.launch.mesh import launch_ranks
    kernels = check_train_kernels(torch, dev, flash_shapes=DIST_FLASH, scan_shapes=())
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = launch_ranks(dist_rank, DIST_WORLD, backend="gloo", device="cuda",
                             timeout=600)
        t1 = time.perf_counter()
        cpu = launch_ranks(dist_ffn_cpu_rank, DIST_WORLD, backend="gloo", device="cpu",
                           timeout=300)
    except (RuntimeError, TimeoutError) as exc:
        raise SmokeFailure(f"dist: {exc}") from exc
    t2 = time.perf_counter()
    r0 = ranks[0]
    # llama: loss, gradients, steps
    ll = r0["llama"]
    arch, layers, B, S, timed = DIST_LLAMA
    require(all(r["llama"]["loss"] == ll["loss"] for r in ranks),
            f"dist {arch}: the ranks' losses differ {[r['llama']['loss'] for r in ranks]}")
    require(abs(ll["loss"] - ll["ref_loss"]) <= TRAIN_LOSS_TOL,
            f"dist {arch}: sharded loss {ll['loss']} vs one process {ll['ref_loss']}")
    require(max(ll["grad_errs"]) <= TRAIN_CPU_REL,
            f"dist {arch}: gathered gradient errors {ll['grad_errs']} past {TRAIN_CPU_REL}")
    require(all(math.isfinite(x) for x in ll["losses"] + ll["grad_norms"]),
            f"dist {arch}: non-finite losses {ll['losses']} or grad norms {ll['grad_norms']}")
    require(max(abs(a - b) for a, b in zip(ll["losses"], ll["ref_losses"])) <= TRAIN_LOSS_TOL,
            f"dist {arch}: step losses {ll['losses']} vs one process {ll['ref_losses']}")
    gnorm_rel = [abs(a - b) / b for a, b in zip(ll["grad_norms"], ll["ref_grad_norms"])]
    require(max(gnorm_rel) <= DIST_GNORM_REL,
            f"dist {arch}: grad norms {ll['grad_norms']} vs one process "
            f"{ll['ref_grad_norms']} (relative {gnorm_rel}, bound {DIST_GNORM_REL})")
    require(max(ll["update_rel"]) <= DIST_UPDATE_REL,
            f"dist {arch}: parameter updates after {timed} steps differ from the one "
            f"process's by {ll['update_rel']} (bound {DIST_UPDATE_REL})")
    from repro_torch.configs import get_config
    remat = 2 if get_config(arch).remat in ("dots", "full") else 1
    require(all(f == layers * remat for r in ranks for f in r["llama"]["flash_per_step"]),
            f"dist {arch}: flash_attention launches a step per rank "
            f"{[r['llama']['flash_per_step'] for r in ranks]}, not {layers} x {remat}")
    step_p50 = [statistics.median(r["llama"]["step_ms"]) for r in ranks]
    log_card(f"dist {arch}: {layers} layers at full width, bf16, (data 2, model 2) over "
             f"gloo, 4 ranks on one card, B {B} x S {S}: sharded loss {ll['loss']:.5f} vs "
             f"one process {ll['ref_loss']:.5f} (tolerance {TRAIN_LOSS_TOL}); gathered "
             f"grad rel err per leaf max {max(ll['grad_errs']):.4f} (bound {TRAIN_CPU_REL}); "
             f"{timed} steps: losses {[round(x, 4) for x in ll['losses']]} vs one process "
             f"{[round(x, 4) for x in ll['ref_losses']]}, grad norms "
             f"{[round(x, 4) for x in ll['grad_norms']]} vs "
             f"{[round(x, 4) for x in ll['ref_grad_norms']]} (relative max "
             f"{max(gnorm_rel):.5f}, bound {DIST_GNORM_REL}); gathered parameters' update "
             f"rel err per leaf max {max(ll['update_rel']):.4f} (bound {DIST_UPDATE_REL}); "
             f"step ms per rank {[[round(x, 1) for x in r['llama']['step_ms']] for r in ranks]}"
             f" (p50 per rank {[round(x, 1) for x in step_p50]}), of which in the staged "
             f"collectives (host clock, a stream sync before and after each) "
             f"{[[round(x, 1) for x in r['llama']['coll_ms']] for r in ranks]}; "
             f"flash_attention launches "
             f"a step per rank {ll['flash_per_step']} ({layers} layers x {remat}, remat "
             f"dots); peak GiB per rank {[round(r['llama']['peak_gib'], 2) for r in ranks]} "
             f"(rank 0 also holds the one-process run); blocks {ll['share']['local_bytes']:,} "
             f"bytes a rank = the plan's share {ll['share']['plan_share_bytes']:,} of "
             f"{ll['share']['full_bytes']:,}; first loss + gathered grads "
             f"{ll['grads_s']:.1f} s")
    # granite: EP train steps, drops
    gr = r0["granite"]
    g_arch, g_layers, gB, gS, g_timed = DIST_GRANITE
    tr, cfg_cf = gr[8.0], [k for k in gr if k not in (8.0, "peak_gib")][0]
    require(tr["dropped"] == 0, f"dist {g_arch}: capacity 8.0 dropped {tr['dropped']} of "
            f"{tr['pairs']} pairs")
    require(all(math.isfinite(x) for x in tr["losses"] + tr["grad_norms"]),
            f"dist {g_arch}: non-finite losses {tr['losses']} or grad norms {tr['grad_norms']}")
    require(max(abs(a - b) for a, b in zip(tr["losses"], tr["ref_losses"])) <= TRAIN_LOSS_TOL,
            f"dist {g_arch}: step losses {tr['losses']} vs one process {tr['ref_losses']}")
    g_gnorm_rel = [abs(a - b) / b for a, b in zip(tr["grad_norms"], tr["ref_grad_norms"])]
    require(max(g_gnorm_rel) <= DIST_GNORM_REL,
            f"dist {g_arch}: grad norms {tr['grad_norms']} vs one process "
            f"{tr['ref_grad_norms']} (relative {g_gnorm_rel}, bound {DIST_GNORM_REL})")
    require(max(tr["update_rel"]) <= DIST_UPDATE_REL,
            f"dist {g_arch}: parameter updates after {g_timed} steps differ from the one "
            f"process's by {tr['update_rel']} (bound {DIST_UPDATE_REL})")
    require(all(r["granite"][8.0]["losses"] == tr["losses"]
                and r["granite"][cfg_cf]["loss"] == gr[cfg_cf]["loss"] for r in ranks),
            f"dist {g_arch}: the ranks' losses differ")
    ffn = {r["ffn"]["batch_shard"]: r["ffn"] for r in ranks}
    ffn_cpu = {r["batch_shard"]: r for r in cpu}
    card_drop = sum(f["dropped"] for f in ffn.values())
    cpu_drop = sum(f["dropped"] for f in ffn_cpu.values())
    same_keep = all(np.array_equal(ffn[b]["keep"], ffn_cpu[b]["keep"]) for b in ffn)
    y_err = max(float(np.abs(ffn[b]["y"] - ffn_cpu[b]["y"]).max()) for b in ffn)
    y_max = max(float(np.abs(ffn_cpu[b]["y"]).max()) for b in ffn)
    require(card_drop == cpu_drop and same_keep and card_drop > 0,
            f"dist {g_arch} EP FFN at capacity {cfg_cf}: the card dropped {card_drop} pairs, "
            f"the CPU {cpu_drop} (kept masks equal: {same_keep})")
    require(y_err <= DIST_FFN_REL * y_max,
            f"dist {g_arch} EP FFN: max |y card - y CPU| {y_err} past {DIST_FFN_REL} of "
            f"max |y| {y_max}")
    log_card(f"dist {g_arch}: {g_layers} layers at full width, bf16, (data 2, model 2), "
             f"B {gB} x S {gS}, through moe_ffn_ep (default layout, rs_combine): capacity "
             f"8.0, {g_timed} train steps (TrainStep; the EP backward through GroupedMmFn): "
             f"losses {[round(x, 4) for x in tr['losses']]} vs one process (routed) "
             f"{[round(x, 4) for x in tr['ref_losses']]}, grad norms "
             f"{[round(x, 4) for x in tr['grad_norms']]} vs "
             f"{[round(x, 4) for x in tr['ref_grad_norms']]} (relative max "
             f"{max(g_gnorm_rel):.5f}, bound {DIST_GNORM_REL}); gathered parameters' update "
             f"rel err per leaf max {max(tr['update_rel']):.4f} (bound {DIST_UPDATE_REL}); "
             f"dropped {tr['dropped']} of {tr['pairs']} pairs in the steps' EP calls; step ms "
             f"per rank {[[round(x, 1) for x in r['granite'][8.0]['step_ms']] for r in ranks]}"
             f", of which in the staged collectives "
             f"{[[round(x, 1) for x in r['granite'][8.0]['coll_ms']] for r in ranks]}, staged "
             f"calls a step (rank 0) {tr['staged_per_step']}; capacity {cfg_cf} forward loss "
             f"{gr[cfg_cf]['loss']:.5f}, dropped {gr[cfg_cf]['dropped']} of "
             f"{gr[cfg_cf]['pairs']} pairs, forward {gr[cfg_cf]['forward_ms']:.1f} ms (rank 0; "
             f"in the staged collectives {gr[cfg_cf]['coll_ms']:.1f}); peak GiB per rank "
             f"{[round(r['granite']['peak_gib'], 2) for r in ranks]}")
    log_card(f"dist {g_arch} EP FFN, one layer's experts at full width, {DIST_FFN_TOKENS} "
             f"seeded bf16 rows, capacity {cfg_cf}: card dropped {card_drop} pairs, the same "
             f"run on 4 CPU gloo ranks {cpu_drop}; kept masks equal {same_keep}; max |y card "
             f"- y CPU| {y_err:.4g} (max |y| {y_max:.4g}, bound {DIST_FFN_REL} of it; the "
             f"card's grouped products are bf16)")
    # GPipe
    gp = r0["gpipe"]
    require(all(r["gpipe"]["pp_loss"] == gp["pp_loss"] for r in ranks),
            f"dist gpipe: the ranks' losses differ")
    require(all(r["gpipe"]["flash"] == r["gpipe"]["bwd_flash"] == layers // 2 * DIST_PP_MICRO
                for r in ranks),
            f"dist gpipe: flash_attention launches per rank in the forward "
            f"{[r['gpipe']['flash'] for r in ranks]}, in the backward (remat's recompute) "
            f"{[r['gpipe']['bwd_flash'] for r in ranks]}")
    require(abs(gp["pp_loss"] - gp["seq_loss"]) <= DIST_PP_TOL,
            f"dist gpipe {arch}: pipeline loss {gp['pp_loss']} vs sequential "
            f"{gp['seq_loss']} (bound {DIST_PP_TOL})")
    require(max(gp["grad_l2"]) <= TRAIN_CPU_REL,
            f"dist gpipe {arch}: gathered gradients vs sequential, ||dg|| / ||g|| per leaf "
            f"{gp['grad_l2']} past {TRAIN_CPU_REL}")
    log_card(f"dist gpipe {arch}: {layers} layers at full width over (pod 2, data 1, model "
             f"2), {DIST_PP_MICRO} microbatches of B {B // DIST_PP_MICRO} x S {S}: loss "
             f"{gp['pp_loss']:.6f} vs sequential one process {gp['seq_loss']:.6f} (|diff| "
             f"{abs(gp['pp_loss'] - gp['seq_loss']):.2e}, bound {DIST_PP_TOL}); gradients by "
             f"loss.backward() on every rank (the reverse drain), gathered, vs the sequential "
             f"one process's: ||dg|| / ||g|| per leaf max {max(gp['grad_l2']):.5f} (bound "
             f"{TRAIN_CPU_REL}, DIST_UPDATE_REL's measure), max |dg| / max |g| max "
             f"{max(gp['grad_errs']):.5f}; forward ms per rank "
             f"{[round(r['gpipe']['pp_ms'], 1) for r in ranks]}, of which in the staged "
             f"transfers {[round(r['gpipe']['coll_ms'], 1) for r in ranks]} "
             f"({gp['staged']} calls staged, rank 0); backward ms per rank "
             f"{[round(r['gpipe']['bwd_ms'], 1) for r in ranks]}, of which in the staged "
             f"transfers {[round(r['gpipe']['bwd_coll_ms'], 1) for r in ranks]} "
             f"({gp['bwd_staged']} calls staged, rank 0); flash_attention launches per rank "
             f"{[r['gpipe']['flash'] for r in ranks]} forward + "
             f"{[r['gpipe']['bwd_flash'] for r in ranks]} in remat's recompute (each stage's "
             f"{layers // 2} layers x {DIST_PP_MICRO} microbatches)")
    log(f"dist: gloo staged through host memory (calls per rank 0, by operation): "
        f"{r0['staged']}; the card ranks {t1 - t0:.1f} s (rank 0's work "
        f"{r0['seconds']:.1f} s), the CPU ranks {t2 - t1:.1f} s")
    return dict(kernels=kernels, launches=sum(sum(r["llama"]["flash_per_step"]) for r in ranks),
                per_step=ll["flash_per_step"][0])


# ---------------------------------------------------------------- phase 12
# Sharded serving: four gloo ranks on the one card, (data 2, model 2),
# seeded bf16 weights in the serving plan (``Model.serve_plan``). As in
# phase 11 the staged transfers make the times no four-card deployment's.
DS_ENGINE = ("llama3.2-3b", 64, 8, 64, 16)   # arch, requests, max batch, prompt, new tokens
# arch, decoder layers, encoder layers (whisper), batches: the depth cut for
# the time limit, full width
DS_MODELS = (("granite-moe-3b-a800m", 4, 0, (8, 3)), ("falcon-mamba-7b", 4, 0, (8, 3)),
             ("whisper-large-v3", 4, 4, (8, 3)), ("llava-next-mistral-7b", 4, 0, (2,)),
             ("jamba-v0.1-52b", 8, 0, (8, 3)))
DS_PROMPT, DS_STEPS = 64, 4
DS_TRAIN = ("falcon-mamba-7b", 4, 8, 128)     # arch, layers, B, S
# decode_attention on sequence blocks: label, B, S, least kv_len, window
DS_DECODE = (("serve_seq4", 8, 80, 65, None), ("decode_32k_seq4_w4096", 8, 32768, 1, WINDOW))
DS_BLOCKS = 4
DS_SCAN_DM = DI // 2           # a model rank's channels of falcon-mamba-7b's 8,192
DS_SCAN = (("serve_prefill_dm4096", 8, 64, False), ("serve_decode_dm4096", 8, 1, True))
LSE_REL = 1e-4                 # the kernel's lse against the plain one (fp32 sums)


def ds_merge_close(torch, got, want, what: str) -> float:
    """The merge of fp32 partials, rounded to bf16 once, against one call
    (bf16) or the plain version (bf16): one bf16 step (``attn_close``)."""
    return attn_close(torch, got.to(want.dtype), want, what=what)


def ds_kernels(torch, dev) -> dict:
    """decode_attention on DS_BLOCKS sequence blocks of a cache (the
    sequence-sharded layout of ``cache_specs``: ``first_row`` and
    ``return_lse``, fp32 partials): each block's (out, lse) against the
    plain version on it, the blocks merged by ``merge_partials`` and
    rounded to bf16 once against one kernel call over every row and
    against the plain version; one block timed beside
    its plain version and SDPA on it (SDPA returns no lse). mamba_scan at
    Dm 4,096, a model rank's channels of falcon-mamba-7b, against its
    plain version (the serve prefill and decode step)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models.attention import merge_partials
    gen = torch.Generator(device=dev)
    gen.manual_seed(2039)
    out = {}
    dtype = torch.bfloat16
    for label, B, S, lo, window in DS_DECODE:
        torch.cuda.empty_cache()
        q = torch.randn((B, HQ, DH), generator=gen, device=dev).to(dtype)
        kc = torch.randn((B, S, HKV, DH), generator=gen, device=dev).to(dtype)
        vc = torch.randn((B, S, HKV, DH), generator=gen, device=dev).to(dtype)
        lens = torch.randint(lo, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        lens[0], lens[1] = S, 0
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        n = S // DS_BLOCKS
        blocks, parts, lses, err, lse_err = [], [], [], 0.0, 0.0
        for i in range(DS_BLOCKS):
            first = torch.full((B,), i * n, dtype=torch.int32, device=dev)
            args = (q, k[:, :, i * n:(i + 1) * n], v[:, :, i * n:(i + 1) * n], lens)
            o, lse = da.decode_attention(*args, window=window, first_row=first,
                                         return_lse=True)
            po, plse = da.decode_attention_plain(*args[:3], kv_len=lens, window=window,
                                                 first_row=first, return_lse=True)
            err = max(err, attn_close(torch, o, po, what=f"decode_attention {label} block {i}"))
            require(torch.equal(torch.isinf(lse), torch.isinf(plse)),
                    f"decode_attention {label} block {i}: lse -inf where the plain's is not")
            live = torch.isfinite(plse)
            d_lse = torch.where(live, (lse - plse).abs() / plse.abs().clamp(min=1.0), 0.0)
            require(float(d_lse.max()) <= LSE_REL,
                    f"decode_attention {label} block {i}: lse rel err {float(d_lse.max())}")
            lse_err = max(lse_err, float(d_lse.max()))
            blocks.append((args, first))
            parts.append(o)
            lses.append(lse)
        stacked = torch.stack(parts)
        merged = merge_partials(stacked, torch.stack(lses)).to(dtype)
        one = da.decode_attention(q, k, v, lens, window=window)
        plain = da.decode_attention_plain(q, k, v, kv_len=lens, window=window)
        e_one = ds_merge_close(torch, merged, one, f"decode_attention {label} merge")
        e_plain = ds_merge_close(torch, merged, plain, f"decode_attention {label} merge vs plain")
        require(not bool(merged[1].any()), f"decode_attention {label}: kv_len 0 must give 0")
        # the timed block: the last, which holds every sequence's newest rows
        args, first = blocks[-1]
        pos = torch.arange(n, device=dev)[None, :] + (DS_BLOCKS - 1) * n
        mask = pos < lens[:, None]
        if window is not None:
            mask &= pos >= lens[:, None] - window
        live = int(mask.sum())
        nbytes = 2 * (2 * live * HKV * DH + 2 * B * HQ * DH) + 4 * B * (2 + HQ)
        b_da = bound(nbytes, 4 * HQ * DH * live, BF16_OPS_PER_S)
        row = out[("decode_attention", label, "bfloat16")] = dict(
            max_abs_err=max(err, e_one, e_plain), lse_rel_err=lse_err, merge_vs_one=e_one,
            merge_vs_plain=e_plain, blocks=DS_BLOCKS,
            ms=graph_ms(torch, [lambda: da.decode_attention(
                *args, window=window, first_row=first, return_lse=True)]),
            plain_ms=graph_ms(torch, [lambda: da.decode_attention_plain(
                *args[:3], kv_len=lens, window=window, first_row=first, return_lse=True)],
                replays=5 if S > 4096 else 15),
            bound_ms=b_da[0], bound_by=b_da[1],
            library_ms=sdpa_ms(torch, q[:, :, None], args[1], args[2], causal=False,
                               mask=mask[:, None, None, :]),
            bytes=nbytes)
        log_card(f"dist_serve kernels: decode_attention {label} B={B} Hq={HQ} Hkv={HKV} "
                 f"S={S} dh={DH} window={window} in {DS_BLOCKS} blocks of {n} rows: {row}")
        del q, kc, vc, k, v, blocks, parts, lses, stacked
    for label, Bt, L, with_h0 in DS_SCAN:
        s = scan_inputs(torch, gen, dev, Bt, L, dtype, Dm=DS_SCAN_DM)
        err = scan_check(torch, ms, s, s[6] if with_h0 else None, label)
        nbytes, n_ops = scan_work(Bt, L, DS_SCAN_DM, NS, s[0].element_size(), with_h0)
        b_s = bound(nbytes, n_ops)
        fn = ((lambda: ms.mamba_scan(*s, h_out=s[6])) if with_h0
              else (lambda: ms.mamba_scan(*s[:6])))
        plain = (lambda: ms.mamba_scan_plain(*s)) if with_h0 else \
            (lambda: ms.mamba_scan_plain(*s[:6]))
        row = out[("mamba_scan", label, "bfloat16")] = dict(
            max_abs_err=err, ms=graph_ms(torch, [fn]), plain_ms=graph_ms(torch, [plain]),
            bound_ms=b_s[0], bound_by=b_s[1], library_ms=None, bytes=nbytes, ops=n_ops)
        log_card(f"dist_serve kernels: mamba_scan {label} Bt={Bt} L={L} Dm={DS_SCAN_DM} "
                 f"N={NS} bf16 {row}")
    torch.cuda.empty_cache()
    return out


# The model checks' MoE capacity: EP drops nothing there, as one process
# (no capacity) does not; the drops at the config's own capacity are counted
# from the same routing (``ds_drops``).
DS_CAPACITY = 8.0


def ds_cfg(arch: str, layers: int, enc_layers: int):
    """A model check's config: full width, ``layers`` (and whisper's
    ``enc_layers``), an MoE model at DS_CAPACITY."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers, enc_layers=enc_layers or cfg.enc_layers)
    return dataclasses.replace(cfg, capacity_factor=DS_CAPACITY) if cfg.n_experts else cfg


def ds_drops(torch, moe, calls, capacity: float) -> tuple[int, int]:
    """(pairs, dropped) over the ``_moe_local`` calls a spy recorded, the
    kept pairs recomputed from each call's expert ids at ``capacity``."""
    import dataclasses
    pairs = dropped = 0
    for c in calls:
        cfg = dataclasses.replace(c.kwargs["cfg"], capacity_factor=capacity)
        keep = moe.kept_pairs(c.args[1], cfg, c.kwargs["n_data"], c.kwargs["e_pad"])
        pairs += keep.numel()
        dropped += int((~keep).sum())
    return pairs, dropped


def serve_blocks(torch, model, seed: int) -> dict:
    """This rank's blocks, in the serving plan, of the weights
    ``Model.init_params(seed)`` draws on the card: drawn in its order from
    one generator, a layer at a time, each cut to its block at once, so no
    rank holds more than one whole layer (jamba's MoE layers are 5.6 GB)."""
    from repro_torch.launch.sharding import shard_tree
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import dtype_of, normal
    from repro_torch.models.model import padded_vocab
    cfg, dev, plan, dist = model.cfg, model.device, model.serve_plan, model.dist
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt, d = dtype_of(cfg), cfg.d_model

    def cut(t, spec):
        return shard_tree(t, spec, dist)

    def stack(layer_cfg, specs):
        return [cut(tf.init_sublayer(gen, layer_cfg, spec, dev), s)
                for spec, s in zip(tf.layer_pattern(layer_cfg), specs)]

    vp = padded_vocab(cfg.vocab_size)
    out = {"embed": cut(normal(gen, (vp, d), dt, d ** -0.5, dev), plan["embed"]),
           "head": cut(normal(gen, (vp, d), dt, d ** -0.5, dev), plan["head"]),
           "final_norm": torch.zeros(d, dtype=torch.float32, device=dev),
           "layers": stack(cfg, plan["layers"])}
    if cfg.family == "encdec":
        out["enc"] = {"proj": cut(normal(gen, (cfg.enc_dim, d), dt, cfg.enc_dim ** -0.5, dev),
                                  plan["enc"]["proj"]),
                      "layers": stack(model._enc_cfg(), plan["enc"]["layers"]),
                      "final_norm": torch.zeros(d, dtype=torch.float32, device=dev)}
    return out


class TopK:
    """``repro_torch.models.moe._top_k`` and ``ops.moe_route`` (every
    routing's choice: the routed path's, the routing kernel's, EP's and
    the dense paths') wrapped: each call's router
    input (fp32), its own ids and the router are kept in call order. With
    ``ref`` (a list of such calls of the one-process run) the i-th call
    takes, for each of its tokens, the ids of the reference's token of
    call i nearest to it (its rows are some of the reference's), weighted
    by its own probabilities at them; ``near_ties`` then holds its own
    choices to the reference's."""

    def __init__(self, torch, ref=None):
        self.torch, self.ref, self.calls, self.matched = torch, ref, [], []

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import moe
        self._moe, self._orig = moe, moe._top_k
        self._ops, self._orig_kernel = ops, ops.moe_route
        torch = self.torch

        def choose(x, router_w, ids, probs):
            self.calls.append((x.float().cpu(), ids.cpu(), router_w.float().cpu()))
            if self.ref is None:
                return None
            rx, rids, _ = self.ref[len(self.calls) - 1]
            near = torch.cdist(x.float(), rx.to(x.device)).argmin(1).cpu()
            self.matched.append((rx[near], rids[near], router_w.float().cpu()))
            ids = rids[near].to(device=x.device, dtype=ids.dtype)
            weights = probs.gather(1, ids.long())
            return ids, weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)

        def top_k(x, router_w, cfg, e_pad):
            probs, ids, weights = self._orig(x, router_w, cfg, e_pad)
            forced = choose(x, router_w, ids, probs)
            return (probs, ids, weights) if forced is None else (probs, *forced)

        def kernel(x, router_w, k, renormalize=True):   # the routing kernel (serving on the card)
            ids, weights = self._orig_kernel(x, router_w, k, renormalize)
            probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
            forced = choose(x, router_w, ids, probs)
            return (ids, weights) if forced is None else forced

        moe._top_k, ops.moe_route = top_k, kernel
        return self

    def __exit__(self, *exc):
        self._moe._top_k = self._orig
        self._ops.moe_route = self._orig_kernel


def ds_reference(torch, arch, layers, enc_layers, batches) -> dict:
    """The one-process card run of each model check: seeded tokens (and
    audio or patches), a prefill of DS_PROMPT and DS_STEPS greedy decode
    steps; per batch the logits (vocab columns, fp32, on the host), the
    tokens and every routing call (``TopK``)."""
    from repro_torch.models.model import Model
    cfg = ds_cfg(arch, layers, enc_layers)
    model = Model(cfg, device=DIST_DEVICE)
    params = model.init_params(0)
    V, out = cfg.vocab_size, {}
    for B in batches:
        gen = torch.Generator().manual_seed(11 + B)
        toks = torch.randint(2, V, (B, DS_PROMPT), generator=gen, dtype=torch.int32)
        extra = family_inputs(torch, cfg, B, gen)
        room = prefix_len(extra) + DS_PROMPT + DS_STEPS + 4
        with TopK(torch) as routes:
            lg, cache, kv = model.prefill(params, {"tokens": toks.to(DIST_DEVICE), **{
                k: t.to(DIST_DEVICE) for k, t in extra.items()}}, room)
            logits, tokens = [lg[:, :V].cpu()], []
            for _ in range(DS_STEPS):
                tok = lg[:, :V].argmax(1).to(torch.int32)
                tokens.append(tok.cpu())
                lg, cache, kv = model.decode_step(params, cache, tok, kv)
                logits.append(lg[:, :V].cpu())
        del cache
        # the same run with each row alone (its MoE layers on the batched
        # run's choices): how far one process is from itself
        noise = 0.0
        for i in range(B):
            with TopK(torch, routes.calls or None):
                lg, cache, kv = model.prefill(params, {"tokens": toks[i:i + 1].to(DIST_DEVICE), **{
                    k: t[i:i + 1].to(DIST_DEVICE) for k, t in extra.items()}}, room)
                noise = max(noise, float((lg[:, :V].cpu() - logits[0][i:i + 1]).abs().max()))
                for step, tok in enumerate(tokens):
                    lg, cache, kv = model.decode_step(params, cache,
                                                      tok[i:i + 1].to(DIST_DEVICE), kv)
                    noise = max(noise, float((lg[:, :V].cpu()
                                              - logits[step + 1][i:i + 1]).abs().max()))
            del cache
        out[B] = dict(tokens=toks, extra=extra, room=room, logits=logits, steps=tokens,
                      routes=routes.calls, noise=noise)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ds_moe_rule(cfg, dist, tokens: int) -> str:
    """The reference's ``moe_apply`` dispatch for ``tokens`` global tokens."""
    tp = dist.n_model > 1 and cfg.d_ff_expert < 128 * dist.n_model
    shards = dist.n_pod * dist.n_data * (dist.n_model if tp else 1)
    return "ep" if dist.n_data > 1 and tokens % shards == 0 else "dense"


def ds_model(torch, rank, dist, counters, spent, arch, layers, enc_layers, refs) -> dict:
    """One model check on this rank: its serving-plan blocks
    (``serve_blocks``), then per batch the meshed prefill and DS_STEPS
    decode steps on the one-process run's tokens, its MoE layers forced
    onto that run's choices (``TopK``); the logits gathered to every rank
    (rank 0 holds them against the one-process run's), the time and
    staged transfers of each call, the port's launches per call, the MoE
    dispatch of each layer and its drops."""
    from unittest import mock

    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.sharding import batch_spec
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    cfg = ds_cfg(arch, layers, enc_layers)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=DIST_DEVICE, dist=dist)
    params = serve_blocks(torch, model, 0)
    V, out = cfg.vocab_size, {}
    for B, ref in refs.items():
        rows, axes = model.rows(B), batch_spec(dist, B)
        batch = {"tokens": ref["tokens"][rows].to(DIST_DEVICE),
                 **{k: t[rows].to(DIST_DEVICE) for k, t in ref["extra"].items()}}
        taken = []

        def spy(kind, fn):
            def call(*a, **k):
                taken.append(kind)
                return fn(*a, **k)
            return call

        calls, ms, staged, launches, logits = [], [], [], [], []
        with TopK(torch, ref["routes"] or None) as routes, \
                mock.patch.object(moe, "_moe_local", wraps=moe._moe_local) as local, \
                mock.patch.object(moe, "moe_ffn_ep", spy("ep", moe.moe_ffn_ep)), \
                mock.patch.object(moe, "_moe_dense_sharded",
                                  spy("dense", moe._moe_dense_sharded)):
            for step in range(DS_STEPS + 1):
                for fn in counters.values():
                    fn.launches = 0
                del taken[:]
                torch.cuda.synchronize()
                c0, t0 = spent["s"], time.perf_counter()
                if step == 0:
                    lg, cache, kv = model.prefill(params, batch, ref["room"], batch_size=B)
                else:
                    lg, cache, kv = model.decode_step(
                        params, cache, ref["steps"][step - 1][rows].to(DIST_DEVICE), kv)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                staged.append((spent["s"] - c0) * 1e3)
                launches.append({k: f.launches for k, f in counters.items() if f.launches})
                calls.append(list(taken))
                logits.append(coll.gather_value(lg[:, :V].contiguous(), 0, dist, axes).cpu())
        res = dict(prefill_ms=ms[0], decode_ms=ms[1:], staged_ms=staged, launches=launches,
                   dispatch=calls, routed_calls=len(routes.calls))
        if calls[0]:
            n_tok = [B * (prefix_len(ref["extra"]) + DS_PROMPT)] + [B] * DS_STEPS
            res["rule"] = [ds_moe_rule(cfg, dist, t) for t in n_tok]
            res["pairs_dropped"] = ep_drops(torch, moe, local.call_args_list)
            require(res["pairs_dropped"][1] == 0,
                    f"dist_serve {arch} B {B}: EP dropped pairs at capacity {DS_CAPACITY}")
            from repro_torch.configs import get_config
            res["config_capacity"] = get_config(arch).capacity_factor
            res["dropped_at_config"] = ds_drops(torch, moe, local.call_args_list,
                                                res["config_capacity"])
            res["flips"] = near_ties(torch, routes.matched, routes.calls,
                                     f"dist_serve {arch} B {B} rank {rank}")[0]
        if rank == 0:
            errs, differ, ties = [], 0, 0
            tol = max(LOGIT_TOL, DS_NOISE_FACTOR * ref["noise"])
            for step, (got, want) in enumerate(zip(logits, ref["logits"])):
                require(bool(torch.isfinite(got).all()),
                        f"dist_serve {arch} B {B}: non-finite logits at step {step}")
                errs.append(float((got - want).abs().max()))
                top2 = want.topk(2, dim=1).values
                clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
                other = got.argmax(1) != want.argmax(1)
                require(not bool((other & clear).any()),
                        f"dist_serve {arch} B {B}: a greedy token differs beyond a near "
                        f"tie at step {step}")
                differ += int(other.sum())
                ties += int((~clear).sum())
            require(max(errs) <= tol,
                    f"dist_serve {arch} B {B}: meshed vs one-process logits err {errs} past "
                    f"{tol} (one process against itself {ref['noise']})")
            res.update(errs=errs, differ=differ, near_ties=ties, noise=ref["noise"], tol=tol)
        out[B] = res
        del cache
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Meshed logits against one process: LOGIT_TOL, or this factor of the
# one-process model's disagreement with itself over the same steps (its
# rows run one at a time against together) where that is larger: at full
# width in bf16 it is ~0.09 after 28 llama layers or 8 jamba layers.
DS_NOISE_FACTOR = 1.25


def ds_teacher_forced(torch, model, params, prompt, toks, max_len: int) -> list:
    """One process's logits (vocab columns, fp32) of a prefill of
    ``prompt`` and the decode steps on the tokens ``toks`` (B, new): one
    (B, V) tensor a step, the new-th after the last token but one."""
    V = model.cfg.vocab_size
    lg, cache, kv = model.prefill(params, {"tokens": torch.from_numpy(prompt).to(
        DIST_DEVICE)}, max_len)
    out = [lg[:, :V].float()]
    for step in range(toks.shape[1] - 1):
        tok = torch.from_numpy(toks[:, step]).to(DIST_DEVICE, torch.int32)
        lg, cache, kv = model.decode_step(params, cache, tok, kv)
        out.append(lg[:, :V].float())
    return out


def ds_engine(torch, rank, dist, counters, spent) -> dict:
    """The meshed engine (``launch.serve.run_serving(dist=...)``): rank 0's
    HNSW cache in front of llama3.2-3b at full width and depth, the other
    ranks following. Every call of the meshed model is timed and its
    logits gathered; rank 0 then runs the one-process model on each miss
    batch's prompt and the engine's tokens (teacher-forced) and holds
    every step's logits to it, every greedy token that differs a near
    tie."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.serve import run_serving
    from repro_torch.launch.sharding import batch_spec
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine
    arch, n_req, max_batch, P, new = DS_ENGINE
    cfg = get_config(arch)
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    rec = {"prefill": [], "decode": [], "batches": [], "logits": []}
    orig_prefill, orig_decode, orig_run = Model.prefill, Model.decode_step, ServingEngine._run

    def timed(kind, fn):
        def call(self, *a, **kw):
            torch.cuda.synchronize()
            c0, t0 = spent["s"], time.perf_counter()
            res = fn(self, *a, **kw)
            torch.cuda.synchronize()
            rec[kind].append(((time.perf_counter() - t0) * 1e3, (spent["s"] - c0) * 1e3))
            B = rec["batches"][-1][0].shape[0]
            lg = coll.gather_value(res[0][:, :V].contiguous(), 0, self.dist,
                                   batch_spec(self.dist, B))
            if rank == 0:
                rec["logits"][-1].append(lg)
            return res
        return call

    def run(self, params, tokens):
        rec["batches"].append([tokens.copy(), None])
        rec["logits"].append([])
        out = orig_run(self, params, tokens)
        rec["batches"][-1][1] = out.copy()
        return out

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(Model, "prefill", timed("prefill", orig_prefill)), \
            mock.patch.object(Model, "decode_step", timed("decode", orig_decode)), \
            mock.patch.object(ServingEngine, "_run", run):
        res = run_serving(cfg, n_requests=n_req, max_batch=max_batch, prompt_len=P,
                          max_new_tokens=new, index_kind="hnsw", dist=dist, device=DIST_DEVICE,
                          log=lambda *_: None)
    torch.cuda.synchronize()
    probe = torch.empty(0, device=DIST_DEVICE)
    out = dict(seconds=time.perf_counter() - t0,
               eager=("generation runs eagerly on purpose (CapturedProgram(graphs=False)): "
                      "the model's collectives stage through host memory (gloo)"
                      if coll.stages_through_host(probe) else "graphs"),
               launches={k: f.launches for k, f in counters.items() if f.launches},
               prefill=rec["prefill"], decode=rec["decode"],
               generated=res["generated"], peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               staged_by_op={k: list(v) for k, v in spent["by_op"].items()})
    if rank == 0:
        out.update({k: res[k] for k in ("served", "hit_rate", "model_tokens")})
        gc.collect()
        torch.cuda.empty_cache()
        one = Model(cfg, device=DIST_DEVICE)
        p1 = one.init_params(0)
        errs, noise, per_batch, tokens = [], [], [], []
        for (prompt, toks), logits in zip(rec["batches"], rec["logits"]):
            B = prompt.shape[0]
            alone = [ds_teacher_forced(torch, one, p1, prompt[i:i + 1], toks[i:i + 1],
                                       P + new) for i in range(B)]
            for step, (got, want) in enumerate(zip(logits, ds_teacher_forced(
                    torch, one, p1, prompt, toks, P + new))):
                errs.append(float((got - want).abs().max()))
                noise.append(float((torch.cat([a[step] for a in alone]) - want).abs().max()))
                tokens.append((want, torch.from_numpy(toks[:, step]).to(DIST_DEVICE), B, step))
            per_batch.append((B, round(max(errs[-len(logits):]), 5),
                              round(max(noise[-len(logits):]), 5)))
        # at full depth in bf16 the one-process model disagrees with itself
        # (its rows run one at a time against together: only the GEMMs'
        # summation order differs) by about this much on the same steps
        tol = max(LOGIT_TOL, DS_NOISE_FACTOR * max(noise))
        differ = ties = 0
        for want, mine, B, step in tokens:
            top2 = want.topk(2, dim=1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
            other = mine != want.argmax(1)
            require(not bool((other & clear).any()),
                    f"dist_serve engine: a greedy token differs beyond a near tie "
                    f"(batch of {B}, step {step})")
            differ += int(other.sum())
            ties += int((~clear).sum())
        require(max(errs) <= tol,
                f"dist_serve engine: meshed vs one-process logits err max {max(errs)} past "
                f"{tol}; (batch size, max err, one process against itself) per miss batch "
                f"{per_batch}")
        out.update(errs_max=max(errs), steps_held=len(errs), differ=differ, near_ties=ties,
                   per_batch=per_batch, noise_max=max(noise), tol=tol,
                   batch_sizes=[b[0].shape[0] for b in rec["batches"]])
        del one, p1
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ds_train(torch, rank, dist) -> dict:
    """One sharded train step's loss and gathered gradients of
    falcon-mamba-7b at full width and DS_TRAIN's layers (the Mamba
    block's tensor parallelism under ``MambaScanFn``), against the
    one-process card run (rank 0)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import gather_tree, shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.convert import tree_leaves, tree_unflatten
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    arch, layers, B, S = DS_TRAIN
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = Model(cfg, device=DIST_DEVICE, dist=dist)
    params = shard_tree(Model(cfg, device=DIST_DEVICE).init_params(0), model.plan, dist)
    torch.cuda.empty_cache()
    batch = train_batch(torch, cfg, B, S, DIST_DEVICE)
    step = make_train_step(model, AdamWConfig())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = step.grads(params, batch)
    torch.cuda.synchronize()
    out = dict(loss=float(loss), ms=(time.perf_counter() - t0) * 1e3)
    grads = gather_tree(tree_unflatten(params, grads), model.plan, dist)
    del params
    torch.cuda.empty_cache()
    if rank == 0:
        one = Model(cfg, device=DIST_DEVICE)
        ref_loss, ref_grads = loss_and_grads(torch, one, one.init_params(0), batch)
        out.update(ref_loss=ref_loss, grad_errs=grad_errs(tree_leaves(grads), ref_grads))
        del ref_grads
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_serve_rank(rank, world, refs_path) -> dict:
    """One rank of phase 12 on the card (see the module docstring)."""
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.context import Dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {fn.__name__: fn for fn in ops.COUNTED}
    dist = Dist.from_mesh(make_mesh((2, 2), ("data", "model"), DIST_DEVICE))
    spent = time_collectives(torch, coll)
    refs = torch.load(refs_path, weights_only=False)
    t0 = time.perf_counter()
    out = {"engine": ds_engine(torch, rank, dist, counters, spent)}
    # a barrier: rank 0 ends the engine check alone, and the model checks'
    # times should not include the other ranks' wait for it
    coll.all_reduce(torch.zeros(1, device=DIST_DEVICE), dist, ("data", "model"))
    for arch, layers, enc_layers, _ in DS_MODELS:
        out[arch] = ds_model(torch, rank, dist, counters, spent, arch, layers, enc_layers,
                             refs[arch])
    out["train"] = ds_train(torch, rank, dist)
    out["staged"] = dict(coll.STAGED)
    out["staged_by_op"] = spent["by_op"]
    out["seconds"] = time.perf_counter() - t0
    return out


def run_dist_serve_phase(torch, dev, counters) -> dict:
    """Phase 12 (see the module docstring)."""
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import launch_ranks
    from repro_torch.launch.serve import run_serving
    kernels = ds_kernels(torch, dev)
    t0 = time.perf_counter()
    refs = {arch: ds_reference(torch, arch, layers, enc, batches)
            for arch, layers, enc, batches in DS_MODELS}
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "refs.pt")
        torch.save(refs, path)
        try:
            ranks = launch_ranks(dist_serve_rank, DIST_WORLD, backend="gloo", device=DIST_DEVICE,
                                 timeout=900, args=(path,))
        except (RuntimeError, TimeoutError) as exc:
            raise SmokeFailure(f"dist_serve: {exc}") from exc
    t2 = time.perf_counter()
    arch, n_req, max_batch, P, new = DS_ENGINE
    for fn in counters.values():
        fn.launches = 0
    one = run_serving(get_config(arch), n_requests=n_req, max_batch=max_batch, prompt_len=P,
                      max_new_tokens=new, index_kind="hnsw", device=DIST_DEVICE,
                      log=lambda *_: None)
    one_launches = {k: f.launches for k, f in counters.items() if f.launches}
    t3 = time.perf_counter()
    r0, en = ranks[0], ranks[0]["engine"]
    same = ("served", "hit_rate", "model_tokens")
    require(all(en[k] == one[k] for k in same),
            f"dist_serve engine: counters {[en[k] for k in same]} vs one process "
            f"{[one[k] for k in same]}")
    require(all(len(r["engine"]["generated"]) == len(en["generated"]) and all(
        np.array_equal(a, b) for a, b in zip(r["engine"]["generated"], en["generated"]))
        for r in ranks), "dist_serve engine: the ranks' tokens differ")
    tok_equal = sum(int((a == b).sum()) for a, b in zip(en["generated"], one["generated"]))
    tok_all = sum(a.size for a in one["generated"])
    for name in ("flash_attention", "decode_attention"):
        require(all(r["engine"]["launches"].get(name, 0) > 0 for r in ranks),
                f"dist_serve engine: {name} launched on no rank's run "
                f"{[r['engine']['launches'] for r in ranks]}")
    layers = get_config(arch).n_layers
    pre = [[round(x[0], 1) for x in r["engine"]["prefill"]] for r in ranks]
    dec = [statistics.median(x[0] for x in r["engine"]["decode"]) for r in ranks]
    dec_coll = [statistics.median(x[1] for x in r["engine"]["decode"]) for r in ranks]
    log(f"dist_serve engine: {r0['engine'].get('eager', '')}")
    log_card(f"dist_serve engine {arch}: {layers} layers at full width, bf16, serving plan on "
             f"(data 2, model 2) over gloo, 4 ranks on one card, HNSW cache on rank 0, "
             f"{n_req} requests, batch <= {max_batch}, prompt {P}, {new} new tokens: counters "
             f"{[en[k] for k in same]} = one process's {[one[k] for k in same]}; miss batches "
             f"{en['batch_sizes']}; every rank's tokens equal; tokens equal to the "
             f"one-process (graph) engine's {tok_equal}/{tok_all}; {en['steps_held']} steps' "
             f"logits vs the one-process model teacher-forced max |d| {en['errs_max']:.5f}, "
             f"the one-process model against itself (each row alone) {en['noise_max']:.5f}, "
             f"(batch size, max |d|, against itself) per miss batch {en['per_batch']} "
             f"(tolerance max({LOGIT_TOL}, {DS_NOISE_FACTOR} x against itself) = "
             f"{en['tol']:.5f}), greedy tokens that differ {en['differ']} (each a near "
             f"tie; {en['near_ties']} within 2x the tolerance); prefill ms per rank {pre}; "
             f"decode step ms p50 per rank {[round(x, 1) for x in dec]}, of which in the "
             f"staged transfers {[round(x, 1) for x in dec_coll]}; engine seconds per rank "
             f"{[round(r['engine']['seconds'], 1) for r in ranks]}; launches per rank "
             f"{[r['engine']['launches'] for r in ranks]} (one process, graphs: "
             f"{one_launches} at wrapper calls); peak GiB per rank in the engine run "
             f"{[round(r['engine']['peak_gib'], 2) for r in ranks]}; staged transfers by op "
             f"(count, ms) per rank "
             f"{[r['engine']['staged_by_op'] for r in ranks]}")
    launches = {k: sum(r["engine"]["launches"].get(k, 0) for r in ranks)
                for k in ("flash_attention", "decode_attention", "mamba_scan")}
    for arch, layers, enc_layers, batches in DS_MODELS:
        for B in batches:
            m0 = r0[arch][B]
            require(all(r[arch][B]["dispatch"] == m0["dispatch"] for r in ranks),
                    f"dist_serve {arch} B {B}: the ranks' MoE dispatch differs")
            rule = ""
            if "rule" in m0:
                got = [sorted(set(d)) for d in m0["dispatch"]]
                require(got == [[r] for r in m0["rule"]],
                        f"dist_serve {arch} B {B}: MoE dispatch {m0['dispatch']} against "
                        f"the reference's rule {m0['rule']}")
                rule = (f"; MoE dispatch per call {m0['dispatch']} = the reference's rule "
                        f"{m0['rule']}, EP (pairs, dropped) per rank at capacity "
                        f"{DS_CAPACITY} {[r[arch][B]['pairs_dropped'] for r in ranks]}, at "
                        f"the config's {m0['config_capacity']} "
                        f"{[r[arch][B]['dropped_at_config'] for r in ranks]}, own choices that "
                        f"differ from the one-process run's (each a near tie) per rank "
                        f"{[r[arch][B]['flips'] for r in ranks]}")
            kinds = [k for k in ("flash_attention", "decode_attention", "mamba_scan")
                     if any(k in c for c in m0["launches"])]
            for k in kinds:
                launches[k] += sum(c.get(k, 0) for r in ranks for c in r[arch][B]["launches"])
            per_call = [{k: c.get(k, 0) for k in kinds} for c in m0["launches"]]
            log_card(f"dist_serve {arch}: {layers} layers"
                     f"{f' + {enc_layers} encoder layers' if enc_layers else ''} at full "
                     f"width (depth cut for the time limit), bf16, (data 2, model 2), B {B}, "
                     f"prompt {DS_PROMPT}{' + patches' if 'llava' in arch else ''}: logits vs "
                     f"one process per step max |d| {[round(e, 5) for e in m0['errs']]}, one "
                     f"process against itself (each row alone) {m0['noise']:.5f} (tolerance "
                     f"max({LOGIT_TOL}, {DS_NOISE_FACTOR} x that) = {m0['tol']:.5f}), greedy "
                     f"tokens that differ {m0['differ']} "
                     f"(near ties; {m0['near_ties']} within 2x the tolerance); prefill ms per "
                     f"rank {[round(r[arch][B]['prefill_ms'], 1) for r in ranks]}, decode ms "
                     f"rank 0 {[round(x, 1) for x in m0['decode_ms']]}, staged ms rank 0 per "
                     f"call {[round(x, 1) for x in m0['staged_ms']]}; launches rank 0 per call "
                     f"{per_call}{rule}")
        log(f"dist_serve {arch}: peak GiB per rank {[round(r[arch]['peak_gib'], 2) for r in ranks]}")
    for k in ("flash_attention", "decode_attention", "mamba_scan"):
        require(launches[k] > 0, f"dist_serve: {k} launched on no meshed path")
    tr = r0["train"]
    t_arch, t_layers, tB, tS = DS_TRAIN
    require(all(r["train"]["loss"] == tr["loss"] for r in ranks),
            f"dist_serve train: the ranks' losses differ")
    require(abs(tr["loss"] - tr["ref_loss"]) <= TRAIN_LOSS_TOL,
            f"dist_serve train {t_arch}: sharded loss {tr['loss']} vs {tr['ref_loss']}")
    require(max(tr["grad_errs"]) <= TRAIN_CPU_REL,
            f"dist_serve train {t_arch}: gradient errors {tr['grad_errs']}")
    log_card(f"dist_serve train {t_arch}: {t_layers} layers at full width, bf16, training "
             f"plan on (data 2, model 2), B {tB} x S {tS}: sharded loss {tr['loss']:.5f} vs "
             f"one process {tr['ref_loss']:.5f} (tolerance {TRAIN_LOSS_TOL}); gathered grad "
             f"rel err per leaf max {max(tr['grad_errs']):.4f} (bound {TRAIN_CPU_REL}); "
             f"loss + backward ms per rank {[round(r['train']['ms'], 1) for r in ranks]}")
    log(f"dist_serve: gloo staged through host memory (calls per rank 0, by operation): "
        f"{r0['staged']}, (count, ms) {r0['staged_by_op']}; one-process references "
        f"{t1 - t0:.1f} s, the card ranks {t2 - t1:.1f} s (rank 0's work "
        f"{r0['seconds']:.1f} s), the one-process engine {t3 - t2:.1f} s")
    return dict(kernels=kernels, launches=launches)


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


PHASES = ("build", "contracts", "kernels", "index", "main", "parity", "shard", "sim",
          "serve", "encdec_vlm", "train", "dist", "dist_serve")


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
        if "contracts" in phases:
            t0 = time.perf_counter()
            budgets = run_contracts_phase(torch, dev)
            log_card(f"phase contracts: {time.perf_counter() - t0:.1f} s")
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
        if "shard" in phases:
            t0 = time.perf_counter()
            sharded = run_shard_path(torch, counters, steps=100, long_steps=400)
            log_card(f"phase shard: {time.perf_counter() - t0:.1f} s; launches of the 4-shard "
                f"card runs {sharded}")
        if "sim" in phases:
            t0 = time.perf_counter()
            simulated = run_sim(torch, counters)
            log_card(f"phase sim: {time.perf_counter() - t0:.1f} s; launches of the hybrid "
                f"card runs {simulated}")
        if "serve" in phases:
            t0 = time.perf_counter()
            check_moe_ffn(torch)
            check_route_modes(torch)
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
            run_sharded_serve(torch, counters, n_requests=64)
            for arch in SERVE_ARCHS:
                check_model(torch, arch)
            check_hybrid(torch, counters)
            check_hybrid_serve(torch)
            log(f"phase serve: {time.perf_counter() - t0:.1f} s")
        if "encdec_vlm" in phases:
            t0 = time.perf_counter()
            encdec = {}
            for arch in ENCDEC_VLM_ARCHS:        # one model on the card at a time
                encdec[arch] = run_encdec_vlm(torch, counters, arch)
            for arch in ENCDEC_VLM_ARCHS:
                check_model(torch, arch)
            log_card(f"phase encdec_vlm: {time.perf_counter() - t0:.1f} s")
        if "train" in phases:
            t0 = time.perf_counter()
            trained = run_train_phase(torch, dev, counters)
            log_card(f"phase train: {time.perf_counter() - t0:.1f} s")
        if "dist" in phases:
            t0 = time.perf_counter()
            distributed = run_dist_phase(torch, dev, counters)
            log_card(f"phase dist: {time.perf_counter() - t0:.1f} s")
        if "dist_serve" in phases:
            t0 = time.perf_counter()
            dist_served = run_dist_serve_phase(torch, dev, counters)
            log_card(f"phase dist_serve: {time.perf_counter() - t0:.1f} s")
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
    numbers.update(trained["kernels"])   # the training shapes ride under "variants"
    numbers.update(distributed["kernels"])   # and a rank's local heads
    numbers.update(dist_served["kernels"])   # sequence blocks, a rank's channels
    fields = ("max_abs_err", "ms", "earlier_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "entry_set_ms", "earlier_entry_set_ms", "entry_set_bound_ms",
              "floor_ms", "earlier_floor_ms", "per_table_ms", "splits", "chunk", "chunk_ms",
              "grad_rel_err", "fd_rel_err", "fwd_bwd_ms", "plain_fwd_bwd_ms",
              "library_fwd_bwd_ms")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        key = (name, *MAIN_KEY.get(name, ("float32",)))
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(launches[w] for w in KERNEL_WRAPPERS.get(name, (name,))),
               "replay_launches": replayed.get(name, 0)}
        row.update({f: numbers[key][f] for f in fields if f in numbers[key]})
        row.update(budgets[name])       # this build's registers, static smem, spills
        if name in SERVE_KERNELS:   # each served model's run that launched it
            row["serve"] = {a: {"launches": out["launches"][name],
                                "replay_launches": out["replay_launches"][name]}
                            for a, out in served.items() if out["launches"][name]}
        if any(name in out["launches"] for out in encdec.values()):
            # whisper's and llava's runs through the model facade
            row["encdec_vlm"] = {a: {"launches": out["launches"].get(name, 0),
                                     "replay_launches": out["replay_launches"].get(name, 0)}
                                 for a, out in encdec.items()}
        if any(name in run["launches"] for run in trained["runs"]):
            # the full-width training runs' timed steps
            row["train"] = {run["arch"]: {"launches": run["launches"][name],
                                          "per_step": run["launches_per_step"][name]}
                            for run in trained["runs"] if name in run["launches"]}
        if name == "flash_attention":   # phase dist: 4 ranks' timed llama steps
            row["dist"] = {"launches": distributed["launches"],
                           "per_step_per_rank": distributed["per_step"]}
        if name in dist_served["launches"]:   # phase dist_serve: 4 ranks' meshed serving
            row["dist_serve"] = {"launches": dist_served["launches"][name]}
        if name in sharded:       # the cache kernels on the sharded and simulator paths
            row["shard"], row["sim"] = sharded[name], simulated[name]
        variants = {"_".join(k[1:]): {f: v[f] for f in fields if f in v}
                    for k, v in numbers.items() if k[0] == name and k != key}
        if variants:
            row["variants"] = variants
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(card_name())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
