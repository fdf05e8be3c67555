"""Category-masked cosine top-1 over the whole table: the flat index's scan.

Replaces the TPU kernel ``repro/kernels/flat_topk.py:flat_topk``
(``_flat_topk_kernel``) with ``csrc/flat_topk.cu``. ``FlatIndex`` calls
it through ``ops.cache_topk`` on every device search.

A row qualifies for a query when it is valid and its category equals the
query's (query category < 0 = wildcard). The result is the best
(score, idx) per query, lowest index first among equal scores, and
(-inf, -1) when no row qualifies (the TPU kernel's contract; the argmax
oracle ``ref.flat_topk_masked_ref`` would say 0).

Bound on the H100: bytes. At N = 1,048,576 x 384 the fp32 table is
1.61 GB (int8: 0.40 GB plus 4 MB of scales), and every query of a batch
shares one pass over it. The TPU kernel streamed the table through a
sequential grid and carried the running best in VMEM scratch; Hopper's
blocks run in no order, so the scan is two kernels: pass 1 gives each
block a chunk of ``block_n`` rows and a tile of 8 queries held in shared
memory, scores each row against the whole tile from one 16-byte-per-lane
row load (fp32 FMA, no TF32), skips rows that no query of the tile can
take (invalid, or of a category none asks for), and writes one partial
per (chunk, query); pass 2 reduces the partials.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gather_scores import check_table


def flat_topk_plain(table: torch.Tensor, valid: torch.Tensor,
                    queries: torch.Tensor,
                    categories: torch.Tensor | None = None,
                    query_categories: torch.Tensor | None = None,
                    scales: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version, with the kernel's -1 when nothing qualifies."""
    if categories is None:
        categories = torch.full((table.shape[0],), -1, dtype=torch.int32,
                                device=table.device)
        query_categories = torch.full((queries.shape[0],), -1,
                                      dtype=torch.int32, device=table.device)
    score, idx = ref.flat_topk_masked_ref(table, valid, queries, categories,
                                          query_categories, scales)
    idx = torch.where(torch.isneginf(score), torch.full_like(idx, -1), idx)
    return score, idx


def flat_topk(table: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor,
              categories: torch.Tensor | None = None,
              query_categories: torch.Tensor | None = None,
              scales: torch.Tensor | None = None, *, block_n: int = 1024
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 cosine search. table (N, d) fp32, or int8 with ``scales`` (N,)
    fp32; valid (N,) bool; queries (B, d) fp32; ``categories`` (N,) and
    ``query_categories`` (B,) int32 travel together (exactly one is a
    ValueError: a silent category-blind scan would bypass isolation).
    Returns (best_score (B,) fp32, best_idx (B,) int32). A CPU table takes
    the plain version."""
    if (categories is None) != (query_categories is None):
        raise ValueError("flat_topk: categories and query_categories must "
                         "be passed together (got exactly one)")
    if table.device.type == "cpu":
        return flat_topk_plain(table, valid, queries, categories,
                               query_categories, scales)
    N, d = table.shape
    B = queries.shape[0]
    dev = table.device
    if query_categories is None:
        query_categories = torch.full((B,), -1, dtype=torch.int32, device=dev)
    tensors = (table, valid, queries, query_categories) + \
        tuple(t for t in (categories, scales) if t is not None)
    _build.require_cuda("flat_topk", *tensors)
    check_table("flat_topk", table, scales)
    if valid.dtype != torch.bool or valid.shape != (N,):
        raise ValueError("flat_topk: valid must be (N,) bool")
    if categories is not None and (categories.dtype != torch.int32
                                   or categories.shape != (N,)):
        raise ValueError("flat_topk: categories must be (N,) int32")
    if query_categories.dtype != torch.int32 or query_categories.shape != (B,):
        raise ValueError("flat_topk: query_categories must be (B,) int32")
    if queries.dtype != torch.float32 or queries.shape != (B, d):
        raise ValueError("flat_topk: queries must be (B, d) float32")
    if block_n <= 0:
        raise ValueError("flat_topk: block_n must be positive")
    n_chunks = max(1, -(-N // block_n))
    part_s = torch.empty((B, n_chunks), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, n_chunks), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    idx = torch.empty((B,), dtype=torch.int32, device=dev)
    err = _build.library().flat_topk_launch(
        table.data_ptr(), valid.data_ptr(),
        None if categories is None else categories.data_ptr(),
        None if scales is None else scales.data_ptr(),
        queries.data_ptr(), query_categories.data_ptr(),
        part_s.data_ptr(), part_i.data_ptr(), score.data_ptr(), idx.data_ptr(),
        N, d, B, int(scales is not None), block_n, n_chunks,
        _build.stream(dev))
    _build.check(err, "flat_topk")
    flat_topk.launches += 1
    return score, idx


flat_topk.launches = 0
