"""Dry-run of the cache's own data plane on the production meshes, per rank.

The counterpart of ``repro.launch.cache_dryrun``: the batched lookup and
the index maintenance at a deployment's scale, with nothing computed and
nothing allocated (every tensor on "meta", numpy host tables that are
never touched beyond the delta's rows). The programs are the port's own:

    flat  — ``core/hnsw.py:_flat_search_classified``: the ``flat_topk``
            kernel over every row of the table, then the TTL classification;
    beam  — ``core/hnsw.py:beam_search_classified`` with the fused hop
            (``frontier_hop`` a hop, ``gather_scores`` for the entry set),
            beam 32, 12 hops, 8 entry points;
    delta — ``core/hnsw.py:_flush_device_tables``: the delta flush of
            ``--delta-rows`` dirty rows into every resident table (one packed
            upload, one ``scatter_flush`` launch). The bytes it moves must
            scale with the delta rows and not with ``--entries``: the
            dry-run proof that a steady-state sync costs O(delta).

Each program's bytes and FLOPs are ``analysis.op_cost``'s count of its ops
(the kernels by their formulas). Placement, as the reference's: the table
is replicated on every rank (reads need no collectives) and the queries
split over the batch axes (``launch.sharding.batch_spec``); with
``--shard-table`` each data rank holds 1/n_data of the rows (a category
shard, paper §7.4), serves the queries routed to it (1/n_data of the
batch) and applies its share of a delta.

    PYTHONPATH=src python -m repro_torch.launch.cache_dryrun \\
        [--entries 1048576] [--batch 128] [--impl flat|beam|delta|both|all] \\
        [--delta-rows 256] [--shard-table] [--dtype float32|int8]

Results: ``results/dryrun_torch/cache/cache__<impl>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis import roofline as rl
from repro_torch.launch.dryrun import RESULTS_DIR, production_dist

D, M0, ENTRIES, BEAM, MAX_HOPS = 384, 32, 8, 32, 12


def table_shapes(n: int, dtype: str, impl: str) -> dict:
    """name -> (shape, dtype) of a rank's resident tables (``_host_tables``
    of the flat or the HNSW index)."""
    out = {"emb": ((n, D), torch.int8 if dtype == "int8" else torch.float32)}
    if dtype == "int8":
        out["scale"] = ((n,), torch.float32)
    if impl != "flat":
        out["neighbors"] = ((n, M0), torch.int32)
    out.update(valid=((n,), torch.bool), category=((n,), torch.int32),
               inserted=((n,), torch.float32))
    return out


def _meta(shapes: dict) -> dict:
    return {k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt) in shapes.items()}


def _run(impl: str, n: int, batch: int, delta_rows: int, dtype: str):
    """One program of ``impl`` on a rank holding ``n`` rows: its op_cost
    Totals."""
    from repro_torch.analysis import op_cost
    from repro_torch.core import hnsw as H
    t = _meta(table_shapes(n, dtype, impl))
    q = torch.empty((batch, D), dtype=torch.float32, device="meta")
    per_query = {k: torch.empty((batch,), dtype=dt, device="meta")
                 for k, dt in (("tau", torch.float32), ("qc", torch.int32),
                               ("ttl", torch.float32))}
    now = torch.empty((), dtype=torch.float32, device="meta")
    with op_cost.counting() as result:
        if impl == "flat":
            H._flat_search_classified(t["emb"], t["valid"], t["category"], t["inserted"], q,
                                      per_query["tau"], per_query["qc"], per_query["ttl"],
                                      now, t.get("scale"))
        elif impl == "beam":
            entries = torch.empty((ENTRIES,), dtype=torch.int32, device="meta")
            H.beam_search_classified(t["emb"], t["neighbors"], t["valid"], entries,
                                     t["inserted"], q, per_query["tau"], per_query["ttl"],
                                     now, t["category"], per_query["qc"], t.get("scale"),
                                     beam=BEAM, max_hops=MAX_HOPS, hop_impl="fused")
        else:
            host = {k: np.zeros(s, dtype=torch.empty(0, dtype=dt).numpy().dtype)
                    for k, (s, dt) in table_shapes(n, dtype, impl).items()}
            dirty = set(range(0, n, max(1, n // delta_rows)))
            dirty = set(sorted(dirty)[:delta_rows])
            stats = dict.fromkeys(("full_uploads", "delta_updates", "rows_synced",
                                   "bytes_synced", "emb_bytes_synced"), 0)
            H._flush_device_tables(t, host, dirty, n, 1.0, 0, 0, stats, torch.device("meta"))
            if stats["delta_updates"] != 1:
                raise RuntimeError(f"cache_dryrun: the flush was not a delta: {stats}")
    return result[0]


def build(impl: str, multi_pod: bool, n_entries: int, batch: int, *,
          shard_table: bool = False, dtype: str = "float32", delta_rows: int = 256) -> dict:
    from repro_torch.launch import sharding as shd
    dist = production_dist(multi_pod)
    n_data = dist.n_data
    n_local = n_entries // n_data if shard_table else n_entries
    if shard_table:
        b_local, rows = max(1, batch // n_data), max(1, delta_rows // n_data)
    else:
        b_local = batch // dist.axis_size(shd.batch_spec(dist, batch))
        rows = delta_rows
    tot = _run(impl, n_local, b_local, rows, dtype)
    table_bytes = sum(int(np.prod(s)) * dt.itemsize
                      for s, dt in table_shapes(n_local, dtype, impl).values())
    esz = 1 if dtype == "int8" else 4
    row_bytes = sum(dt.itemsize * int(np.prod(s[1:]))
                    for s, dt in table_shapes(1, dtype, "beam").values())
    return {
        "arch": f"cache_{impl}" + ("_sharded" if shard_table else ""),
        "shape": (f"delta_r{delta_rows}_n{n_entries}" if impl == "delta"
                  else f"lookup_b{batch}_n{n_entries}"),
        "mesh": "multi" if multi_pod else "single",
        "n_devices": dist.n_devices, "dtype": dtype,
        "rank_rows": n_local, "rank_batch": b_local if impl != "delta" else 0,
        "rank_delta_rows": rows if impl == "delta" else 0,
        "per_rank_bytes": {"tables": table_bytes},
        "op_cost": tot.to_dict(),
        "collectives": {"bytes": tot.collective_bytes, "counts": tot.collective_counts,
                        "total_bytes": tot.total_collective_bytes},
        # ideal: the table streamed once per query batch (global); the delta
        # flush moves only its rows
        "model_flops": 0.0 if impl == "delta" else 2.0 * n_entries * D * batch,
        "active_params": 0, "cache_bytes": 0,
        "table_bytes": n_entries * D * esz,
        "delta_bytes": delta_rows * row_bytes if impl == "delta" else 0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entries", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--impl", default="both",
                    help="flat | beam | delta | both (flat+beam) | all")
    ap.add_argument("--delta-rows", type=int, default=256,
                    help="delta impl: dirty rows per flush")
    ap.add_argument("--shard-table", action="store_true")
    ap.add_argument("--dtype", default="float32", choices=["float32", "int8"])
    ap.add_argument("--out", default=str(RESULTS_DIR / "cache"))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    os.makedirs(args.out, exist_ok=True)
    impls = {"both": ["flat", "beam"], "all": ["flat", "beam", "delta"]}.get(
        args.impl, [args.impl])
    for impl in impls:
        for mp in (False, True):
            name = impl + ("_sharded" if args.shard_table else "") + \
                ("_int8" if args.dtype == "int8" else "")
            tag = f"cache__{name}__{'multi' if mp else 'single'}"
            payload = build(impl, mp, args.entries, args.batch, shard_table=args.shard_table,
                            dtype=args.dtype, delta_rows=args.delta_rows)
            Path(args.out, tag + ".json").write_text(json.dumps(payload, indent=1))
            cost = payload["op_cost"]
            print(f"[cache-dryrun] {tag}: rank rows={payload['rank_rows']} table="
                  f"{payload['per_rank_bytes']['tables'] / 2**20:.1f} MiB flops="
                  f"{cost['flops']:.3e} bytes={cost['bytes']:.3e} "
                  f"mem_ms={cost['bytes'] / rl.HBM_BW * 1e3:.4f} (H100 HBM, computed) "
                  f"coll={payload['collectives']['total_bytes']:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
