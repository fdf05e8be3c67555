"""One run of one cell: set-up, the measured window, the check against
the plain references, and the result line.

The system under test is the port's serving engine
(``repro_torch.serving.engine.ServingEngine``: ``submit``, then ``step``)
in front of a ``SemanticCache`` (hnsw index, fp32 residency, the search on
the card) and a ``Model`` whose generation replays CUDA graphs, with
``max_batch`` = the mix's clients, ``prompt_len`` and ``max_new_tokens``
from the mix. Three settings keep the cache's decisions a function of the
traffic alone:

* the engine's ``embedder`` is the traffic's: each request's calibrated
  vector, keyed by a text unique to the request;
* the cache's clock is a ``SimClock``, moved before each step to the
  arrival time of the batch's last request (the cache charges no
  simulated search or insert time); the trace recorder has its own
  ``WallClock``;
* no ``AdaptiveController``: the policies are ``policies.json``'s.

The loop is closed: ``clients`` clients, each sending its next request
when the ``step()`` that answered its last one returns, so every step
serves the next ``clients`` requests of the traffic in order, whatever
the timing. A request's latency runs from its ``submit`` to the return of
that ``step()``.

``--trace 1`` attaches a ``TraceRecorder`` to the engine and the cache
for the window, then serves on for a short segment under
``torch.profiler`` (``trace.py``); the per-layer metrics read both. Every
answer of a run, the segment's too, is checked, and so is what the cache
holds at the end.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from portbench import spec, traffic_gen, trace as devtrace
from portbench.reference.cache import ReferenceCache

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_COMPLIANCE = "__portbench_warmup__"
WARMUP_SEARCH = "__portbench_warmup_search__"
PROFILE_S = 2.0                # the traced segment's length (``--trace 1``)
CHECK_ROWS = 24                # model-served requests the model check samples
CHECK_BLOCK = 8                # rows per reference forward


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class TrafficEmbedder:
    """The engine's embedder for a run: a request's text names its row of
    the traffic's calibrated embeddings."""

    def __init__(self, table: dict):
        self.table = table

    def embed_batch(self, texts):
        return np.stack([self.table[t] for t in texts]).astype(np.float32)


@dataclass
class Step:
    idx: list                 # traffic rows of the batch, in order
    now: float                # the cache's clock at the lookup
    results: list             # the cache's CacheResult per row


@dataclass
class RunRecord:
    """What a per-layer metric's reader is given."""
    config: dict
    mix: dict
    shape: dict               # the reference's step_shape (yardstick.step_bound)
    steps: list               # Step, window only
    spans: list               # the recorder's spans inside the window
    lookups: int
    rows_gathered: int
    device: object = None     # trace.DeviceTrace of the profiled segment
    device_gens: list = field(default_factory=list)   # its generations' miss-batch sizes
    hits: int = 0             # the window's hits (each judged right by the check)
    false_misses: int = 0     # its misses where the exact search holds a hit


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--quick", action="store_true",
                    help="CPU rehearsal at the files' quick sizes (not a measurement)")
    return ap.parse_args(argv)


def seed_seq(seed: int, k: int) -> list:
    """The numpy seed of stream ``k`` of a run's ``--seed``."""
    return [int(seed) % (2 ** 63), k]


def main(argv, t_start: float) -> int:
    """One run: the result line on stdout, 0; or another code and no
    result where the cell cannot run here or the run loaded JAX."""
    out = execute(parse(argv), t_start)
    if isinstance(out, int):
        return out
    result = out[0]
    seen = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if seen:
        log(f"portbench: the run loaded {seen}; the benchmark may load none of "
            f"{list(FORBIDDEN)}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result))
    return 0


def execute(args, t_start: float):
    """Set up, serve the window (and with ``--trace 1`` the traced
    segment), check. Returns (result, context) or an exit code."""
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    if args.quick:
        cfg, mix = spec.quick(cfg), spec.quick_mix(mix)
        limits = {**limits, **limits.get("quick", {})}

    import torch
    if not args.quick:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"portbench: {cell['name']} needs {cell['chips']} CUDA device(s), found {n}")
            return 3
    device = torch.device("cpu" if args.quick else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.cache import SemanticCache
    from repro_torch.core.clock import SimClock, WallClock
    from repro_torch.core.policy import CategoryConfig, PolicyEngine
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.model import Model
    from repro_torch.obs import TraceRecorder
    from repro_torch.serving.engine import ServingEngine

    ref = spec.reference(cfg)
    clients, P, NEW = mix["clients"], mix["prompt_len"], mix["new_tokens"]

    # -- set-up: traffic, weights, program ---------------------------------
    tr = traffic_gen.make_traffic(mix, args.seed, mix["requests"], cfg["vocab_size"], P)
    fill_cats, fill_embs = traffic_gen.fill_entries(mix, args.seed)
    params = ref.make_weights(cfg, args.seed, device)
    t_made = time.perf_counter()
    pols = spec.policies()
    confs = [CategoryConfig(p["name"], threshold=p["threshold"], ttl=p["ttl"],
                            quota=p["quota"], priority=p["priority"],
                            allow_caching=p["allow_caching"]) for p in pols.values()]
    confs.append(CategoryConfig(WARMUP_COMPLIANCE, threshold=0.99, ttl=1.0, quota=0.0,
                                allow_caching=False))
    sim = SimClock()
    cache = SemanticCache(PolicyEngine(confs), capacity=mix["capacity"], clock=sim,
                          index_kind="hnsw", use_device=True, emb_dtype="float32",
                          search_ms=0.0, insert_ms=0.0, device=device)
    model = Model(ArchConfig(**cfg["port"]), device=device)
    engine = ServingEngine(model, params, cache, max_batch=clients, prompt_len=P,
                           max_new_tokens=NEW)
    table = {f"q{i}": tr.embeddings[i] for i in range(len(tr))}
    wrng = np.random.default_rng(seed_seq(args.seed, 4))
    for j in range(clients):
        v = wrng.standard_normal(tr.embeddings.shape[1]).astype(np.float32)
        table[f"w{j}"] = v / np.linalg.norm(v)
    engine.embedder = TrafficEmbedder(table)

    for a in range(0, len(fill_cats), 512):
        b = min(a + 512, len(fill_cats))
        cache.insert_batch(fill_embs[a:b], fill_cats[a:b], [f"f{j}" for j in range(a, b)],
                           [f"fill:{j}" for j in range(a, b)])
    # Warm-up: the search's graph (batch bucket `clients`, after the fill's
    # full upload), then prefill and decode graphs for every miss-batch size.
    cache.lookup_batch(np.stack([table[f"w{j}"] for j in range(clients)]),
                       [WARMUP_SEARCH] * clients)
    for B in range(1, clients + 1):
        for j in range(B):
            engine.submit(f"w{j}", WARMUP_COMPLIANCE,
                          wrng.integers(2, cfg["vocab_size"], P).astype(np.int32))
        engine.step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    base_rows = engine.stats.rows_gathered

    steps: list[Step] = []
    recorded: list = []
    lookup = cache.lookup_batch

    def recording_lookup(embs, cats):
        res = lookup(embs, cats)
        recorded.append(res)
        return res

    cache.lookup_batch = recording_lookup
    rec = None
    if args.trace:
        rec = TraceRecorder(WallClock())
        engine.obs = cache.obs = rec

    rid_idx, t_sub, lat, answers = {}, {}, {}, {}
    next_row = 0

    def submit() -> None:
        nonlocal next_row
        if next_row >= len(tr):
            return
        i = next_row
        next_row += 1
        rid_idx[engine.submit(f"q{i}", tr.categories[i], tr.prompts[i])] = i
        t_sub[i] = time.perf_counter()

    def serve_step() -> int:
        idx = [rid_idx[r.req_id] for r in engine.queue[:clients]]
        sim.advance(max(0.0, float(tr.timestamps[idx[-1]]) - sim.now()))
        now = sim.now()
        out = engine.step()
        t1 = time.perf_counter()
        steps.append(Step(idx, now, recorded[-1]))
        for r in out:
            i = rid_idx[r.req_id]
            lat[i] = (t1 - t_sub[i]) * 1e3
            answers[i] = r
        return len(out)

    setup_s = time.perf_counter() - t_start
    log(f"portbench: set-up {setup_s:.1f} s (traffic and weights by {t_made - t_start:.1f} s, "
        f"fill and warm-up {setup_s - (t_made - t_start):.1f} s)")
    for _ in range(clients):
        submit()
    w0 = time.perf_counter()
    deadline = w0 + args.seconds
    while engine.queue:
        for _ in range(serve_step()):
            if time.perf_counter() < deadline:
                submit()
        if time.perf_counter() >= deadline:
            break
    w1 = time.perf_counter()
    n_window = len(steps)
    window_rows = sum(1 for s in steps for i in s.idx if i in answers)
    lookups, rows = n_window, engine.stats.rows_gathered - base_rows

    dev_trace, dev_gens = None, []
    if args.trace and device.type == "cuda":
        def segment():
            for _ in range(clients):
                submit()
            end = time.perf_counter() + PROFILE_S
            while engine.queue:
                for _ in range(serve_step()):
                    if time.perf_counter() < end:
                        submit()
        dev_trace = devtrace.profile_segment(torch, segment)
        dev_gens = [sum(not r.hit for r in s.results) for s in steps[n_window:]]
        dev_gens = [b for b in dev_gens if b]
    # Every submitted request is due: wait up to a minute for any left.
    t_wait = time.perf_counter() + 60.0
    while engine.queue and time.perf_counter() < t_wait:
        serve_step()

    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    held = held_entries(torch, cache, pols)
    spans = list(rec.spans) if rec is not None else []
    window_spans = spans[:_span_cut(spans, n_window)]
    record = RunRecord(config=cfg, mix=mix, shape=ref.step_shape(cfg), steps=steps[:n_window],
                       spans=window_spans, lookups=lookups, rows_gathered=rows,
                       device=dev_trace, device_gens=dev_gens)

    # Free the program's state before the references run on the card.
    engine.programs.clear()
    cache.index.programs.clear()
    del engine, model, cache, lookup
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    submitted = next_row
    answered = len(answers)
    t_check = time.perf_counter()
    checks, notes, picked, fmiss = check(args, cfg, mix, ref, params, tr, fill_cats,
                                         fill_embs, steps, answers, held, pols, limits,
                                         device, submitted)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    record.hits = sum(r.hit for s in record.steps for r in s.results)
    record.false_misses = sum(fmiss[:n_window])
    notes += f"; check {time.perf_counter() - t_check:.1f} s"
    hit_rates = category_hits(steps[:n_window], tr)

    result = {"correct": bool(correct), "attempted": submitted,
              "failed": submitted - answered,
              "metrics": {}, "device": device_info(torch, device, peak)}
    if not args.trace:
        lat_w = [lat[i] for s in steps[:n_window] for i in s.idx if i in lat]
        values = {"served_rps": window_rows / (w1 - w0),
                  "latency_p95_ms": float(np.percentile(lat_w, 95)),
                  "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if m["name"] in values and cell["name"] in m.get("workloads", [cell["name"]]):
                result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            v = spec.metric_reader(m["name"]).read(record)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if dev_trace is not None:
            result["device"]["busy_s"] = dev_trace.busy_s
            result["device"]["window_s"] = dev_trace.window_s
            seg_spans = [s for s in spans if s.t0 >= dev_trace.t0]
            result["breakdown"] = devtrace.breakdown(dev_trace, seg_spans)
    log(f"portbench: {cell['name']} seed {args.seed}: {window_rows} answered in "
        f"{w1 - w0:.3f} s over {n_window} steps; set-up {setup_s:.3f} s; hit rate by "
        f"category {json.dumps(hit_rates)}; {notes}")
    result["checks"] = checks
    context = dict(cfg=cfg, mix=mix, ref=ref, params=params, tr=tr, steps=steps,
                   answers=answers, pols=pols, fill=(fill_cats, fill_embs), device=device,
                   picked=picked, record=record, spans=spans)
    return result, context


def _span_cut(spans, n_window: int) -> int:
    """The number of leading spans that belong to the window's steps: up
    to and including the ``n_window``-th root ``engine_step`` span's
    subtree."""
    roots = 0
    for k, sp in enumerate(spans):
        if sp.stage == "engine_step" and sp.parent_id < 0:
            roots += 1
            if roots == n_window + 1:
                return k
    return len(spans)


def category_hits(steps, tr) -> dict:
    tot, hit = {}, {}
    for s in steps:
        for i, r in zip(s.idx, s.results):
            c = tr.categories[i]
            tot[c] = tot.get(c, 0) + 1
            hit[c] = hit.get(c, 0) + int(r.hit)
    out = {c: round(hit[c] / tot[c], 4) for c in sorted(tot)}
    n = sum(tot.values())
    out["_overall"] = round(sum(hit.values()) / n, 4) if n else 0.0
    return out


def device_info(torch, device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}


def held_entries(torch, cache, pols) -> list[dict]:
    """What the program's cache holds once the run is over, as its next
    lookup would read it: each live row of the search's tables (synced as
    that lookup syncs them) with the document its doc id names."""
    tabs = cache.index.device_tables()
    slots = np.flatnonzero(tabs["valid"].bool().cpu().numpy())
    at = torch.from_numpy(slots).to(tabs["emb"].device)
    emb = tabs["emb"][at].float().cpu().numpy()
    cid = tabs["category"][at].cpu().numpy()
    ins = tabs["inserted"][at].float().cpu().numpy()
    names = {cache.policies.category_id(n): n for n in pols}
    held = []
    for k, slot in enumerate(slots):
        d = cache.doc_id_of(int(slot))
        doc = cache.store.get(d)
        held.append(dict(doc_id=d, category=names.get(int(cid[k])), emb=emb[k],
                         inserted=ins[k], doc_category=doc.category if doc else None,
                         request=doc.request if doc else None,
                         response=doc.response if doc else None))
    return held


def check(args, cfg, mix, ref, params, tr, fill_cats, fill_embs, steps, answers, held,
          pols, limits, device, submitted) -> tuple[dict, str, list, list]:
    """The numbers compared (those the cell's limits file names, and the
    unanswered requests), each with its limit; a note; the traffic rows
    the model check sampled; each step's false misses."""
    import torch
    # 1-2. The cache's answers and the write-back, against the exact search.
    rc = ReferenceCache(pols, mix["capacity"])
    for j, (c, e) in enumerate(zip(fill_cats, fill_embs)):
        rc.insert(c, e, 0.0, f"fill:{j}", f"f{j}")
    gap, mism, fmiss, expired = 0.0, 0, [], 0
    for s in steps:
        decs = [dict(hit=r.hit, reason=r.reason, doc_id=r.doc_id, score=r.score)
                for r in s.results]
        texts = [answers[i].text if i in answers else "" for i in s.idx]
        j = rc.judge_batch(tr.embeddings[s.idx], [tr.categories[i] for i in s.idx], s.now,
                           decs, texts, [f"q{i}" for i in s.idx])
        gap = max([gap] + j["gap"])
        mism += sum(j["mismatch"])
        fmiss.append(sum(j["false_miss"]))
        expired += sum(r.reason == "expired" for r in s.results)
    wb = rc.writeback(held)
    # 3. The model's tokens, against the reference's full forward pass.
    served = [i for s in steps for i, r in zip(s.idx, s.results)
              if not r.hit and i in answers and answers[i].tokens is not None]
    rng = np.random.default_rng(seed_seq(args.seed, 3))
    pick = sorted(rng.choice(served, size=min(CHECK_ROWS, len(served)), replace=False)) \
        if served else []
    gaps = model_gap(torch, ref, cfg, params, tr, answers, pick, mix["prompt_len"], device)
    values = {"hit_gap": gap, "answer_mismatches": mism, "logit_gap": gaps["max"],
              "logit_gap_mean": gaps["mean"], "writeback_errors": sum(wb.values())}
    checks = {k: {"value": values[k], "limit": v} for k, v in limits.items() if k in values}
    checks["unanswered"] = {"value": submitted - len(answers), "limit": 0}
    note = (f"{len(pick)} model-served rows checked ({len(pick) * mix['new_tokens']} tokens: "
            f"widest gap {gaps['max']:.6f}, mean gap {gaps['mean']:.6f}, share not the "
            f"reference's first {gaps['flips']:.4f}); "
            f"{sum(fmiss)} false misses (a fresh same-category entry at or above its "
            f"threshold that the index search did not return); {expired} expired; "
            f"write-back over {len(held)} entries held: {json.dumps(wb)}")
    return checks, note, pick, fmiss


def model_gap(torch, ref, cfg, params, tr, answers, rows, P: int, device,
              want_control: bool = False) -> dict:
    """How far the served tokens of ``rows`` lie below the reference's
    best: the reference runs once over each prompt and its served tokens
    (the last one needs no position), and at each served position the gap
    is the reference's best logit less its logit of the served token.
    Returns the widest gap (``max``), the mean gap over the served tokens
    (``mean``) and the share of them that are not the reference's first
    choice (``flips``). With ``want_control`` the same of the tokens the
    fp8 reference puts first instead."""
    worst, total, flips, n = 0.0, 0.0, 0, 0
    for a in range(0, len(rows), CHECK_BLOCK):
        blk = rows[a:a + CHECK_BLOCK]
        served = np.stack([np.asarray(answers[i].tokens, np.int64) for i in blk])
        toks = np.concatenate([tr.prompts[blk].astype(np.int64), served[:, :-1]], axis=1)
        t = torch.from_numpy(toks).to(device)
        want = ref.logits(params, cfg, t, P - 1)                  # (b, new, V)
        if want_control:
            pick = ref.logits(params, cfg, t, P - 1, fp8=True).argmax(-1, keepdim=True)
        else:
            pick = torch.from_numpy(served).to(device)[..., None]
        best = want.max(-1)
        g = best.values - want.gather(-1, pick)[..., 0]
        worst = max(worst, float(g.max()))
        total += float(g.sum())
        flips += int((pick[..., 0] != best.indices).sum())
        n += g.numel()
        del want
    return {"max": worst, "mean": total / max(n, 1), "flips": flips / max(n, 1)}
