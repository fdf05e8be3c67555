"""Plain PyTorch oracles for the cache data-plane kernels.

Each function is the direct mathematical definition (no tiling, no
chunking), the counterpart of ``repro.kernels.ref``'s cache oracles. The
CPU path of every wrapper in ``repro_torch.kernels`` runs these, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

Dot products are an elementwise product summed over the last axis in
fp32, so a (row, query) pair scores the same bits wherever it sits in a
batch: a node met twice in one beam merge ties exactly, on the CPU as on
the card.
"""

from __future__ import annotations

import torch

INVALID = -1
TOMBSTONE = -2          # meta word of a removed (invalid) slot


def dequantize_ref(table: torch.Tensor,
                   scales: torch.Tensor | None) -> torch.Tensor:
    """Per-row symmetric dequant: row i is ``table[i] * scales[i]``;
    ``scales`` None means the table is already fp32."""
    t = table.to(torch.float32)
    return t if scales is None else t * scales.to(torch.float32)[:, None]


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.clamp(min=0).long()]


def _row_dots(vecs: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(B, K, d) rows against (B, d) queries -> (B, K) fp32 dots."""
    return (vecs.to(torch.float32)
            * queries.to(torch.float32)[:, None, :]).sum(-1)


def flat_topk_ref(table: torch.Tensor, valid: torch.Tensor,
                  queries: torch.Tensor, scales: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-1 over the whole table: (best_score (B,), best_idx
    (B,) int32); invalid rows excluded. argmax semantics: index 0 when
    nothing qualifies (``ops.cache_topk`` turns that into -1)."""
    scores = queries.to(torch.float32) @ dequantize_ref(table, scales).T
    scores = scores.masked_fill(~valid.bool()[None, :], float("-inf"))
    best_idx = scores.argmax(dim=1)
    best_score = scores.gather(1, best_idx[:, None])[:, 0]
    return best_score, best_idx.to(torch.int32)


def flat_topk_masked_ref(table: torch.Tensor, valid: torch.Tensor,
                         queries: torch.Tensor, categories: torch.Tensor,
                         query_categories: torch.Tensor,
                         scales: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Category-masked exact top-1: a row qualifies only when valid AND
    same-category as the query (query category < 0 = wildcard)."""
    scores = queries.to(torch.float32) @ dequantize_ref(table, scales).T
    qc = query_categories.to(torch.int32)[:, None]
    ok = valid.bool()[None, :] & ((qc < 0) |
                                  (categories.to(torch.int32)[None, :] == qc))
    scores = scores.masked_fill(~ok, float("-inf"))
    best_idx = scores.argmax(dim=1)
    best_score = scores.gather(1, best_idx[:, None])[:, 0]
    return best_score, best_idx.to(torch.int32)


def gather_scores_ref(table: torch.Tensor, indices: torch.Tensor,
                      queries: torch.Tensor,
                      scales: torch.Tensor | None = None) -> torch.Tensor:
    """scores[b,k] = <table[indices[b,k]], queries[b]>; -inf where idx < 0.
    With ``scales`` (N,) the table is int8 and the dot multiplies by the
    gathered row's scale after the sum."""
    s = _row_dots(_take_rows(table, indices), queries)
    if scales is not None:
        s = s * _take_rows(scales.to(torch.float32), indices)
    return s.masked_fill(indices < 0, float("-inf"))


def gather_scores_masked_ref(table: torch.Tensor, indices: torch.Tensor,
                             queries: torch.Tensor,
                             slot_categories: torch.Tensor,
                             query_categories: torch.Tensor,
                             scales: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """As ``gather_scores_ref``, plus -inf where the gathered row's
    category differs from the query's (< 0 = wildcard)."""
    s = gather_scores_ref(table, indices, queries, scales)
    cat = _take_rows(slot_categories.to(torch.int32), indices)
    qc = query_categories.to(torch.int32)[:, None]
    return s.masked_fill(~((qc < 0) | (cat == qc)), float("-inf"))


def frontier_hop_ref(emb: torch.Tensor, neighbors: torch.Tensor,
                     meta: torch.Tensor, frontier: torch.Tensor,
                     queries: torch.Tensor, query_categories: torch.Tensor,
                     done: torch.Tensor, scales: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam expansion: ``neighbors[frontier]`` -> (B, F·M) candidate
    (ids, route, res). Dead lanes (INVALID frontier or neighbor, or a done
    query) get id INVALID and -inf; result scores also mask candidates
    whose ``meta`` word is TOMBSTONE or another category."""
    B = frontier.shape[0]
    nbr = _take_rows(neighbors, frontier)                         # (B,F,M)
    alive = (frontier >= 0)[:, :, None] & (done.to(torch.int32) == 0)[:, None, None]
    ids = torch.where(alive & (nbr >= 0), nbr,
                      torch.full_like(nbr, INVALID)).reshape(B, -1)
    ids = ids.to(torch.int32)
    route = gather_scores_ref(emb, ids, queries, scales)
    m = _take_rows(meta.to(torch.int32), ids)
    qc = query_categories.to(torch.int32)[:, None]
    ok = (ids >= 0) & (m != TOMBSTONE) & ((qc < 0) | (m == qc))
    res = route.masked_fill(~ok, float("-inf"))
    return ids, route, res


def scatter_rows_ref(table: torch.Tensor, rows: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """Row scatter into a copy: out[rows[r]] = vals[r]. Duplicate row ids
    must carry identical vals rows."""
    out = table.clone()
    out[rows.long()] = vals.to(table.dtype)
    return out
