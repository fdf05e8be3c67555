"""Fused frontier hop: one whole HNSW beam expansion per launch.

Replaces the TPU kernel ``repro/kernels/frontier_hop.py:frontier_hop``
(``_frontier_hop_kernel``) with ``csrc/frontier_hop.cu``. The beam search
calls it once per hop (``ops.frontier_hop``).

Each (query b, frontier lane f) expands the neighbor row
``neighbors[frontier[b,f]]`` into M candidates, scores each live one
against the query and emits (ids, routing scores, result scores), each
(B, F·M). Masking contract (shared with ``ref.frontier_hop_ref``):

* a lane is dead when its frontier id or neighbor id is INVALID, or its
  query is done; it loads nothing and emits INVALID / -inf;
* routing scores mask only dead lanes (tombstones and other categories
  still route);
* result scores also mask ``meta == TOMBSTONE`` and candidates whose
  ``meta`` (the slot's category) differs from the query's (< 0 = wildcard).

Bound on the H100: bytes. A fully live hop at B=8, F=M=32 reads 8,192
candidate rows (1,536 B fp32, or 384 B int8 plus a 4-byte scale) and their
meta words, about 12.6 MB in fp32. The TPU kernel had the frontier ids
scalar-prefetched and started one DMA per live candidate before waiting for
any. Here one block per (b, f) does the same with bulk async copies: it
reads its neighbor row, starts one ``cp.async.bulk`` per live candidate
row into a shared-memory slot on one mbarrier, stages the query beside
them, and its warps score the rows from shared memory through the shared
dot of ``csrc/dot.cuh`` (bit-identical to ``gather_scores``). Rows that do
not fit the block's budget go through two buffers in chunks (``_stage_plan``);
int8 rows that are not 16-byte multiples take 4-byte ``cp.async`` copies.
The TPU packed the int8 scale bits beside the meta word to save a DMA; the
card reads the separate ``scale`` table.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gather_scores import check_table

INVALID = ref.INVALID
TOMBSTONE = ref.TOMBSTONE

frontier_hop_plain = ref.frontier_hop_ref

ROW_BUDGET = 48 * 1024      # staged row bytes a block holds in one stage
SMEM_LIMIT = 232_448        # a block's dynamic shared memory on the H100


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _stage_plan(d: int, M: int, itemsize: int) -> dict:
    """How the card kernel stages a lane's M candidate rows of d elements
    of ``itemsize`` bytes: ``copy`` is "bulk" (one ``cp.async.bulk`` a row,
    rows a multiple of 16 bytes) or "word" (4-byte ``cp.async``); ``chunk``
    rows go into a buffer, ``chunks`` stages walk the M rows (two buffers
    when there is more than one); ``smem_bytes`` is the block's dynamic
    shared memory, as ``csrc/frontier_hop.cu:HopLayout`` lays it out."""
    row = d * itemsize
    slot = _round16(row)
    if M * slot <= ROW_BUDGET:
        chunk, buffers = max(M, 1), 1
    else:
        chunk, buffers = max(1, ROW_BUDGET // (2 * slot)), 2
    chunks = -(-M // chunk)
    smem = 16 + _round16(4 * d) + buffers * chunk * slot + 20 * M
    return dict(copy="bulk" if row % 16 == 0 else "word", slot_bytes=slot,
                chunk=chunk, chunks=chunks, smem_bytes=smem)


def _launch(name: str, serial: bool, emb: torch.Tensor, neighbors: torch.Tensor,
            meta: torch.Tensor, frontier: torch.Tensor, queries: torch.Tensor,
            query_categories: torch.Tensor, done: torch.Tensor,
            scales: torch.Tensor | None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    tensors = (emb, neighbors, meta, frontier, queries, query_categories,
               done) + (() if scales is None else (scales,))
    _build.require_cuda(name, *tensors)
    check_table(name, emb, scales)
    N, d = emb.shape
    M = neighbors.shape[1]
    B, F = frontier.shape
    for arg, t, shape in (("neighbors", neighbors, (N, M)),
                          ("meta", meta, (N,)), ("frontier", frontier, (B, F)),
                          ("query_categories", query_categories, (B,)),
                          ("done", done, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape} int32")
    if queries.dtype != torch.float32 or queries.shape != (B, d):
        raise ValueError(f"{name}: queries must be (B, d) float32")
    plan = _stage_plan(d, M, emb.element_size())
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(f"{name}: d={d}, M={M} needs {plan['smem_bytes']} "
                         f"bytes of shared memory (limit {SMEM_LIMIT})")
    dev = emb.device
    ids = torch.empty((B, F * M), dtype=torch.int32, device=dev)
    route = torch.empty((B, F * M), dtype=torch.float32, device=dev)
    res = torch.empty((B, F * M), dtype=torch.float32, device=dev)
    err = _build.library().frontier_hop_launch(
        emb.data_ptr(), None if scales is None else scales.data_ptr(),
        neighbors.data_ptr(), meta.data_ptr(), frontier.data_ptr(),
        queries.data_ptr(), query_categories.data_ptr(), done.data_ptr(),
        ids.data_ptr(), route.data_ptr(), res.data_ptr(),
        N, d, M, B, F, int(scales is not None), plan["chunk"], int(serial),
        _build.stream(dev))
    _build.check(err, name)
    return ids, route, res


def frontier_hop(emb: torch.Tensor, neighbors: torch.Tensor,
                 meta: torch.Tensor, frontier: torch.Tensor,
                 queries: torch.Tensor, query_categories: torch.Tensor,
                 done: torch.Tensor, scales: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """emb (N, d) fp32 or int8 with ``scales`` (N,) fp32; neighbors (N, M)
    int32; meta (N,) int32; frontier (B, F) int32; queries (B, d) fp32;
    query_categories and done (B,) int32 -> (ids int32, route fp32, res
    fp32), each (B, F·M). A CPU table takes the plain version."""
    if emb.device.type == "cpu":
        return frontier_hop_plain(emb, neighbors, meta, frontier, queries,
                                  query_categories, done, scales)
    out = _launch("frontier_hop", False, emb, neighbors, meta, frontier, queries,
                  query_categories, done, scales)
    _build.count(frontier_hop)
    return out


frontier_hop.launches = frontier_hop.recorded = 0


def frontier_hop_serial(emb: torch.Tensor, neighbors: torch.Tensor,
                        meta: torch.Tensor, frontier: torch.Tensor,
                        queries: torch.Tensor, query_categories: torch.Tensor,
                        done: torch.Tensor, scales: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The earlier card design of ``frontier_hop`` (each warp walks its
    candidates one after another, rows loaded straight from global memory),
    on a CUDA tensor only. No path calls it: ``chip_smoke.py`` times it
    beside ``frontier_hop`` on the same inputs."""
    return _launch("frontier_hop_serial", True, emb, neighbors, meta, frontier,
                   queries, query_categories, done, scales)
