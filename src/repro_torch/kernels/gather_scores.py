"""Gather + dot: ``scores[b,k] = <table[idx[b,k]], q[b]>``.

Replaces the TPU kernel ``repro/kernels/gather_scores.py:gather_scores``
(line 96; ``_gather_scores_kernel`` and ``_gather_scores_quant_kernel``)
with ``csrc/gather_scores.cu``. The HNSW search scores its entry set with
it before the first hop (``ops.hop_scores``): 8 entry ids, the same for
all B = 8 queries, padded to K = 32 with -1.

Bound on the H100: at that shape the bytes (8 rows, 8 queries, the ids
and scores: 26,624 B in fp32) take 0.0000079 ms, far below one launch;
what bounds the call is the launch and two dependent loads (the id, then
the row) before a warp reduction and the store. One block scores one
column k for a group of up to 16 queries, a warp per query. The queries
on one row (a ballot over the column's ids) form its group, and the
lowest of them alone loads the row, staging it in shared memory when
others share it: a row that 8 queries ask for is read once, not 8 times.
Every warp loads its own query in the same step as the row, so nothing
waits on the queries. The dot is ``csrc/dot.cuh``'s order for every
(row, query) (lane l sums chunks l, l + 32, ... by ``fmaf``, then the
xor-shuffle tree, then the int8 scale), so its scores are bit-identical
to ``frontier_hop``'s and a node met in both ties exactly in the beam
merge. A padding id (< 0, or >= N) loads nothing and scores -inf; a
column with no live id loads no row at all.

``gather_scores_masked`` replaces the TPU kernel
``gather_scores.py:gather_scores_masked`` (line 173) with the same CUDA
kernel and a category test: a candidate of another category than its
query's (query category < 0 = wildcard) scores -inf. The row's category
is loaded beside the row, both off the id, and the test applied after:
a row whose queries all fail is still read (one round trip saved against
loading the category first). One that passes goes through the same dot,
so its score is bit-equal to ``gather_scores``'s. ``ops.hop_scores``
with categories launches it.

``gather_scores_serial`` launches the earlier design (one warp per (b, k)
pair, each loading its own row), which no path runs: ``chip_smoke.py``
times it beside the kernel on the same inputs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

gather_scores_plain = ref.gather_scores_ref
gather_scores_masked_plain = ref.gather_scores_masked_ref


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


def _check_gather(name: str, table: torch.Tensor, indices: torch.Tensor,
                  queries: torch.Tensor, scales: torch.Tensor | None,
                  *more: torch.Tensor) -> torch.Tensor:
    """Check a CUDA call's inputs and allocate its (B, K) output."""
    tensors = (table, indices, queries, *more) + (() if scales is None else (scales,))
    _build.require_cuda(name, *tensors)
    check_table(name, table, scales)
    B, K = indices.shape
    if indices.dtype != torch.int32:
        raise ValueError(f"{name}: indices must be int32")
    if queries.dtype != torch.float32 or queries.shape != (B, table.shape[1]):
        raise ValueError(f"{name}: queries must be (B, d) float32")
    if queries.data_ptr() % 16:
        raise ValueError(f"{name}: queries must be 16-byte aligned")
    return torch.empty((B, K), dtype=torch.float32, device=table.device)


def gather_scores(table: torch.Tensor, indices: torch.Tensor,
                  queries: torch.Tensor,
                  scales: torch.Tensor | None = None) -> torch.Tensor:
    """table (N, d) fp32, or int8 with ``scales`` (N,) fp32; indices (B, K)
    int32 (-1 = padding); queries (B, d) fp32 -> scores (B, K) fp32 (-inf
    at padding). A CPU table takes the plain version."""
    if table.device.type == "cpu":
        return gather_scores_plain(table, indices, queries, scales)
    out = _check_gather("gather_scores", table, indices, queries, scales)
    B, K = indices.shape
    err = _build.library().gather_scores_launch(
        table.data_ptr(), None if scales is None else scales.data_ptr(),
        indices.data_ptr(), queries.data_ptr(), out.data_ptr(),
        table.shape[0], table.shape[1], B, K, int(scales is not None),
        _build.stream(table.device))
    _build.check(err, "gather_scores")
    _build.count(gather_scores)
    return out


gather_scores.launches = gather_scores.recorded = 0


def gather_scores_masked(table: torch.Tensor, indices: torch.Tensor,
                         queries: torch.Tensor, slot_categories: torch.Tensor,
                         query_categories: torch.Tensor,
                         scales: torch.Tensor | None = None) -> torch.Tensor:
    """As ``gather_scores``, plus slot_categories (N,) int32 and
    query_categories (B,) int32: -inf where the candidate's category is not
    the query's (query category < 0 = wildcard). A CPU table takes the
    plain version."""
    if table.device.type == "cpu":
        return gather_scores_masked_plain(table, indices, queries, slot_categories,
                                          query_categories, scales)
    out = _check_gather("gather_scores_masked", table, indices, queries, scales,
                        slot_categories, query_categories)
    B, K = indices.shape
    if (slot_categories.dtype != torch.int32 or query_categories.dtype != torch.int32
            or slot_categories.shape != (table.shape[0],)
            or query_categories.shape != (B,)):
        raise ValueError("gather_scores_masked: slot_categories (N,) and "
                         "query_categories (B,) must be int32")
    err = _build.library().gather_scores_masked_launch(
        table.data_ptr(), None if scales is None else scales.data_ptr(),
        indices.data_ptr(), queries.data_ptr(), slot_categories.data_ptr(),
        query_categories.data_ptr(), out.data_ptr(),
        table.shape[0], table.shape[1], B, K, int(scales is not None),
        _build.stream(table.device))
    _build.check(err, "gather_scores_masked")
    _build.count(gather_scores_masked)
    return out


gather_scores_masked.launches = gather_scores_masked.recorded = 0


def gather_scores_serial(table: torch.Tensor, indices: torch.Tensor,
                         queries: torch.Tensor, scales: torch.Tensor | None = None,
                         slot_categories: torch.Tensor | None = None,
                         query_categories: torch.Tensor | None = None) -> torch.Tensor:
    """The earlier card design of ``gather_scores`` (with both category
    tensors, of ``gather_scores_masked``), on CUDA tensors only and not
    counted. No path calls it: ``chip_smoke.py`` times it beside the kernel
    on the same inputs."""
    cats = () if slot_categories is None else (slot_categories, query_categories)
    out = _check_gather("gather_scores_serial", table, indices, queries, scales, *cats)
    B, K = indices.shape
    err = _build.library().gather_scores_serial_launch(
        table.data_ptr(), None if scales is None else scales.data_ptr(),
        indices.data_ptr(), queries.data_ptr(),
        *(None if t is None else t.data_ptr()
          for t in (slot_categories, query_categories)),
        out.data_ptr(), table.shape[0], table.shape[1], B, K, int(scales is not None),
        _build.stream(table.device))
    _build.check(err, "gather_scores_serial")
    return out
