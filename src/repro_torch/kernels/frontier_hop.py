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
scalar-prefetched and issued one DMA per candidate; here one block per
(b, f) stages the query row in shared memory, loads its own neighbor row,
and each warp scores candidates with 16-byte loads through the shared dot
of ``csrc/dot.cuh`` (bit-identical to ``gather_scores``). The TPU packed
the int8 scale bits beside the meta word to save a DMA; the card reads
the separate ``scale`` table.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gather_scores import check_table

INVALID = ref.INVALID
TOMBSTONE = ref.TOMBSTONE

frontier_hop_plain = ref.frontier_hop_ref


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
    tensors = (emb, neighbors, meta, frontier, queries, query_categories,
               done) + (() if scales is None else (scales,))
    _build.require_cuda("frontier_hop", *tensors)
    check_table("frontier_hop", emb, scales)
    N, d = emb.shape
    M = neighbors.shape[1]
    B, F = frontier.shape
    for name, t, shape in (("neighbors", neighbors, (N, M)),
                           ("meta", meta, (N,)), ("frontier", frontier, (B, F)),
                           ("query_categories", query_categories, (B,)),
                           ("done", done, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"frontier_hop: {name} must be {shape} int32")
    if queries.dtype != torch.float32 or queries.shape != (B, d):
        raise ValueError("frontier_hop: queries must be (B, d) float32")
    dev = emb.device
    ids = torch.empty((B, F * M), dtype=torch.int32, device=dev)
    route = torch.empty((B, F * M), dtype=torch.float32, device=dev)
    res = torch.empty((B, F * M), dtype=torch.float32, device=dev)
    err = _build.library().frontier_hop_launch(
        emb.data_ptr(), None if scales is None else scales.data_ptr(),
        neighbors.data_ptr(), meta.data_ptr(), frontier.data_ptr(),
        queries.data_ptr(), query_categories.data_ptr(), done.data_ptr(),
        ids.data_ptr(), route.data_ptr(), res.data_ptr(),
        N, d, M, B, F, int(scales is not None), _build.stream(dev))
    _build.check(err, "frontier_hop")
    frontier_hop.launches += 1
    return ids, route, res


frontier_hop.launches = 0
