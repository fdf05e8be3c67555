"""Serving driver: category-aware semantic cache in front of a real model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --index hnsw --use-device                       # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --reduced --requests 48 --device cpu            # on the CPU

The counterpart of ``repro.launch.serve``: feature-hash embeddings →
category policies → hybrid cache (Algorithm 1) → batched prefill/decode on
the PyTorch model for misses (a dense model such as llama3.2-3b through
the attention kernels on the card, an ssm model such as falcon-mamba-7b
through the selective-scan kernel; MoE, hybrid, encoder-decoder and VLM
architectures raise until their slices are ported) → cache insertion, with adaptive load-based policy adjustment. ``--cache none``
serves everything from the model (the uncached baseline). Weights are
random, drawn on the device from ``seed`` with a ``torch.Generator``;
they differ from the reference's ``jax.random`` draws, but hits and
misses depend only on the request text, so the served, hit, model-token
and per-category counters match the reference's for the same seed.
``--shards > 1`` raises until the sharded tier (``core/shard.py``) is
ported.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.cache import SemanticCache
from repro_torch.core.clock import WallClock
from repro_torch.core.policy import AdaptiveController, PolicyEngine, \
    paper_policies
from repro_torch.core.workload import TABLE1_WORKLOAD, WorkloadGenerator
from repro_torch.models.model import Model
from repro_torch.obs import (TraceRecorder, coverage_fraction, prometheus_text,
                             span_accounting, telemetry_report)
from repro_torch.serving.engine import ServingEngine


def run_serving(cfg, *, n_requests: int, cache_kind: str = "hybrid",
                max_batch: int = 8, prompt_len: int = 32,
                max_new_tokens: int = 8, seed: int = 0,
                index_kind: str = "flat", use_device: bool = False,
                emb_dtype: str = "float32", n_shards: int = 1,
                telemetry: bool = False,
                telemetry_jsonl: str | None = None,
                telemetry_prom: str | None = None,
                device: str | torch.device | None = None,
                log=print) -> dict:
    """Serve ``n_requests`` of Table-1 traffic; ``device`` None means the
    card (cache index and model)."""
    if n_shards > 1:
        raise NotImplementedError("--shards > 1 needs the sharded cache tier "
                                  "(core/shard.py), which is not ported yet")
    model = Model(cfg, device=device)
    params = model.init_params(seed)
    controller = AdaptiveController()
    policies = PolicyEngine(paper_policies(), controller=controller)

    # One WallClock shared by the cache and the recorder so span
    # timestamps and cache timestamps are the same timeline. Under a
    # wall clock span accounting reports leaf coverage, not equality.
    clock = WallClock()
    trace = telemetry or telemetry_jsonl is not None \
        or telemetry_prom is not None
    obs = TraceRecorder(clock) if trace else None
    cache = SemanticCache(policies, capacity=max(4096, n_requests), clock=clock,
                          index_kind=index_kind, use_device=use_device,
                          l1_capacity=256, emb_dtype=emb_dtype, obs=obs,
                          device=model.device)
    if cache_kind == "none":
        for name in policies.categories():
            policies.update(name, allow_caching=False)

    engine = ServingEngine(model, params, cache, max_batch=max_batch,
                           prompt_len=prompt_len,
                           max_new_tokens=max_new_tokens,
                           controller=controller, obs=obs)

    gen = WorkloadGenerator(TABLE1_WORKLOAD, rate_per_s=1e9, seed=seed)
    queries = gen.generate(n_requests)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    for q in queries:
        toks = rng.integers(2, cfg.vocab_size, size=prompt_len)
        engine.submit(q.text, q.category, toks)
        if len(engine.queue) >= max_batch:
            engine.step()
    engine.drain()
    wall = time.time() - t0
    st = engine.stats
    log(f"[serve] {st.served} served, hit_rate={st.hit_rate:.3f}, "
        f"model_tokens={st.model_tokens}, "
        f"mean_latency={st.total_latency_ms / max(1, st.served):.1f}ms, "
        f"wall={wall:.1f}s")
    log(f"[serve] search data plane: {st.search_hops} hops, "
        f"{st.rows_gathered} embedding rows gathered")
    sync = getattr(cache, "sync_stats", None)
    if sync is not None:
        log(f"[serve] index sync ({emb_dtype} residency): "
            f"{sync['full_uploads']} full / "
            f"{sync['delta_updates']} delta uploads, "
            f"{sync['bytes_synced'] / 1e6:.2f} MB synced "
            f"({sync['emb_bytes_synced'] / 1e6:.2f} MB embeddings)")
    snap = cache.metrics.snapshot()
    ov = snap["_overall"]
    log(f"[serve] overall: hit_rate={ov['hit_rate']:.3f}, "
        f"availability={ov.get('availability', 1.0):.3f}, "
        f"{ov['inserts']} inserts, "
        f"{ov['ttl_evictions'] + ov['quota_evictions'] + ov['capacity_evictions']}"
        f" evictions")
    tele = None
    if obs is not None:
        acct = span_accounting(obs)
        tele = {"spans": acct["spans"], "roots": acct["roots"],
                "opened": acct["opened"], "closed": acct["closed"],
                "leaf_coverage": round(coverage_fraction(obs), 4),
                "events": obs.event_counts()}
        if telemetry:
            log(telemetry_report(obs, snapshot=snap))
        if telemetry_jsonl:
            n_lines = obs.to_jsonl(telemetry_jsonl)
            log(f"[serve] trace: {n_lines} JSONL lines -> {telemetry_jsonl}")
        if telemetry_prom:
            with open(telemetry_prom, "w") as f:
                f.write(prometheus_text(snapshot=snap, rec=obs))
            log(f"[serve] metrics exposition -> {telemetry_prom}")
    return {"served": st.served, "hit_rate": st.hit_rate,
            "model_tokens": st.model_tokens, "wall_s": wall,
            "search_hops": st.search_hops,
            "rows_gathered": st.rows_gathered,
            "n_shards": n_shards,
            "per_category": snap,
            "telemetry": tele,
            "index_sync": dict(sync) if sync is not None else None}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--cache", choices=["hybrid", "none"], default="hybrid")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--index", choices=["flat", "hnsw"], default="flat",
                    help="cache index; hnsw enables the graph index")
    ap.add_argument("--use-device", action="store_true",
                    help="route lookups through the device-resident "
                         "(delta-synced) index: the beam search with the "
                         "frontier_hop kernel for hnsw, the flat_topk "
                         "kernel for flat")
    ap.add_argument("--emb-dtype", choices=["float32", "int8"],
                    default="float32",
                    help="resident embedding tier: int8 = quantized "
                         "residency (fused-dequant kernels, ~4x fewer "
                         "sync/gather bytes, fp32 re-rank at the τ "
                         "boundary)")
    ap.add_argument("--shards", type=int, default=1,
                    help="category-sharded cache tier; only 1 until "
                         "core/shard.py is ported")
    ap.add_argument("--device", default=None,
                    help="where the model and the cache index run: the "
                         "card by default, 'cpu' for the plain versions")
    ap.add_argument("--telemetry", action="store_true",
                    help="wire a TraceRecorder through the stack and "
                         "print the telemetry report (span accounting, "
                         "per-stage latency table, event counts)")
    ap.add_argument("--telemetry-jsonl", default=None, metavar="PATH",
                    help="dump the span/event trace as JSONL to PATH "
                         "(implies tracing on)")
    ap.add_argument("--telemetry-prom", default=None, metavar="PATH",
                    help="write a Prometheus-style text exposition of "
                         "counters + stage histograms to PATH "
                         "(implies tracing on)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    run_serving(cfg, n_requests=args.requests, cache_kind=args.cache,
                max_batch=args.max_batch, index_kind=args.index,
                use_device=args.use_device, emb_dtype=args.emb_dtype,
                n_shards=args.shards, device=args.device,
                telemetry=args.telemetry,
                telemetry_jsonl=args.telemetry_jsonl,
                telemetry_prom=args.telemetry_prom)


if __name__ == "__main__":
    main()
