"""Public wrappers around the cache data-plane kernels.

The counterpart of ``repro.kernels.ops`` for the four kernels on the
lookup/insert path. Dispatch follows the tensors' device: a CPU tensor
goes to the kernel module's plain PyTorch version, a CUDA tensor to the
hand-written kernel, or the call raises. There is no fallback from one to
the other. Kernels take any N, B and d (a multiple of 4), so unlike the
TPU wrappers nothing is padded and no output needs slicing back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flat_topk as _ft
from repro_torch.kernels import frontier_hop as _fh
from repro_torch.kernels import gather_scores as _gs
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import scatter_update as _su


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def cache_topk(table: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor,
               categories: torch.Tensor | None = None,
               query_categories: torch.Tensor | None = None,
               scales: torch.Tensor | None = None, *, block_n: int = 1024
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cache-table cosine top-1 (the flat index's local search). Any N, B, d.

    ``categories`` (N,) + ``query_categories`` (B,) restrict each query's
    result to its own category (< 0 = wildcard); pass both or neither
    (exactly one raises: a silent fallback would bypass isolation).
    ``scales`` (N,) marks the table as int8 with per-row dequant scales.
    Returns (score (B,), idx (B,) int32), idx -1 where nothing qualifies.
    """
    if (categories is None) != (query_categories is None):
        raise ValueError("cache_topk: categories and query_categories must "
                         "be passed together (got exactly one)")
    return _ft.flat_topk(
        table.contiguous(), valid.to(torch.bool).contiguous(), _f32(queries),
        None if categories is None else _i32(categories),
        None if query_categories is None else _i32(query_categories),
        None if scales is None else _f32(scales), block_n=block_n)


def hop_scores(table: torch.Tensor, indices: torch.Tensor, queries: torch.Tensor,
               slot_categories: torch.Tensor | None = None,
               query_categories: torch.Tensor | None = None,
               scales: torch.Tensor | None = None) -> torch.Tensor:
    """Gather + dot over candidate ids: indices (B, K), -1 padded.

    With ``slot_categories`` (N,) + ``query_categories`` (B,) the category
    mask applies too; pass both or neither (exactly one raises). The masked
    variant has no CUDA kernel yet: it runs on CPU tensors only and raises
    on the card. ``scales`` (N,) marks an int8 table.
    """
    if (slot_categories is None) != (query_categories is None):
        raise ValueError("hop_scores: slot_categories and query_categories "
                         "must be passed together (got exactly one)")
    table, indices, queries = table.contiguous(), _i32(indices), _f32(queries)
    scales = None if scales is None else _f32(scales)
    if slot_categories is not None:
        if table.device.type != "cpu":
            raise NotImplementedError(
                "hop_scores: the category-masked gather (gather_scores_masked) "
                "has no CUDA kernel yet")
        return _ref.gather_scores_masked_ref(table, indices, queries,
                                             slot_categories, query_categories,
                                             scales)
    return _gs.gather_scores(table, indices, queries, scales)


def frontier_hop(emb: torch.Tensor, neighbors: torch.Tensor, meta: torch.Tensor,
                 frontier: torch.Tensor, queries: torch.Tensor,
                 query_categories: torch.Tensor, done: torch.Tensor,
                 scales: torch.Tensor | None = None, *, impl: str | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused HNSW beam expansion -> (candidate ids, routing scores,
    result scores), each (B, F·M). Dead lanes (INVALID frontier/neighbor,
    or a done query) emit INVALID / -inf; ``meta`` is the per-slot word
    ``category if valid else -2``; ``scales`` (N,) marks an int8 table.

    ``impl``: None follows the device (the CUDA kernel on the card, its
    plain version on the CPU); "ref" forces the plain PyTorch oracle on
    either device, for parity checks.
    """
    args = (emb.contiguous(), _i32(neighbors), _i32(meta), _i32(frontier),
            _f32(queries), _i32(query_categories), _i32(done),
            None if scales is None else _f32(scales))
    if impl is None:
        return _fh.frontier_hop(*args)
    if impl == "ref":
        return _ref.frontier_hop_ref(*args)
    raise ValueError(f"frontier_hop: impl must be None or 'ref', got {impl!r}")


def scatter_rows(table: torch.Tensor, rows: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """Delta flush: write ``vals[r]`` into ``table[rows[r]]`` IN PLACE and
    return ``table`` (the same tensor, so the resident tables are never
    copied). Any dtype; a 1-D table goes through an (N, 1) column view.

    Contract (callers pad the delta to a bucket size): rows >= 0, and
    duplicate row ids carry identical vals rows.
    """
    if not table.is_contiguous():
        raise ValueError("scatter_rows: the table must be contiguous "
                         "(it is updated in place)")
    vals = vals.to(device=table.device, dtype=table.dtype).contiguous()
    rows = _i32(rows.to(table.device))
    if table.dim() == 1:
        _su.scatter_rows(table.view(-1, 1), rows, vals.view(-1, 1))
    else:
        _su.scatter_rows(table, rows, vals)
    return table
