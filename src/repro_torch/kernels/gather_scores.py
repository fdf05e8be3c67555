"""Gather + dot: ``scores[b,k] = <table[idx[b,k]], q[b]>``.

Replaces the TPU kernel ``repro/kernels/gather_scores.py:gather_scores``
(``_gather_scores_kernel`` and ``_gather_scores_quant_kernel``) with
``csrc/gather_scores.cu``. The HNSW search scores its entry set with it
before the first hop (``ops.hop_scores``).

Bound on the H100: bytes, and at the main path's shape (B=8 queries, K=32
entries) launch latency: the work is B·K rows of d floats (or d int8 plus a
scale) and B queries, about 0.4 MB in fp32. One warp scores one (b, k)
pair with the shared dot of ``csrc/dot.cuh`` (16-byte loads, fixed lane
order, xor-shuffle tree), so its scores are bit-identical to
``frontier_hop``'s for the same (row, query) and a node met in both ties
exactly in the beam merge. A padding id (< 0) loads nothing and scores
-inf.

``gather_scores_masked`` (the category-masked variant) is not on the
lookup path and has no CUDA kernel yet; ``ops.hop_scores`` raises for it
on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

gather_scores_plain = ref.gather_scores_ref


def check_table(name: str, table: torch.Tensor,
                scales: torch.Tensor | None) -> None:
    """The embedding-table contract shared by the cache kernels: (N, d)
    fp32, or int8 with (N,) fp32 scales; d a multiple of 4 (16-byte fp32
    and 4-byte int8 row loads) and at most 12,288 (the query row is staged
    in 48 KB of shared memory)."""
    if table.dim() != 2:
        raise ValueError(f"{name}: table must be (N, d)")
    if scales is None:
        if table.dtype != torch.float32:
            raise ValueError(f"{name}: an fp32 table is required without scales")
    else:
        if table.dtype != torch.int8:
            raise ValueError(f"{name}: scales require an int8 table")
        if scales.dtype != torch.float32 or scales.shape != (table.shape[0],):
            raise ValueError(f"{name}: scales must be (N,) float32")
    d = table.shape[1]
    if d % 4 or d > 12288:
        raise ValueError(f"{name}: d={d} must be a multiple of 4, <= 12288")
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: table must be 16-byte aligned")


def gather_scores(table: torch.Tensor, indices: torch.Tensor,
                  queries: torch.Tensor,
                  scales: torch.Tensor | None = None) -> torch.Tensor:
    """table (N, d) fp32, or int8 with ``scales`` (N,) fp32; indices (B, K)
    int32 (-1 = padding); queries (B, d) fp32 -> scores (B, K) fp32 (-inf
    at padding). A CPU table takes the plain version."""
    if table.device.type == "cpu":
        return gather_scores_plain(table, indices, queries, scales)
    tensors = (table, indices, queries) + (() if scales is None else (scales,))
    _build.require_cuda("gather_scores", *tensors)
    check_table("gather_scores", table, scales)
    B, K = indices.shape
    if indices.dtype != torch.int32:
        raise ValueError("gather_scores: indices must be int32")
    if queries.dtype != torch.float32 or queries.shape != (B, table.shape[1]):
        raise ValueError("gather_scores: queries must be (B, d) float32")
    out = torch.empty((B, K), dtype=torch.float32, device=table.device)
    err = _build.library().gather_scores_launch(
        table.data_ptr(), None if scales is None else scales.data_ptr(),
        indices.data_ptr(), queries.data_ptr(), out.data_ptr(),
        table.shape[0], table.shape[1], B, K, int(scales is not None),
        _build.stream(table.device))
    _build.check(err, "gather_scores")
    gather_scores.launches += 1
    return out


gather_scores.launches = 0
