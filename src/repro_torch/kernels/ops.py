"""Public wrappers around the port's kernels.

The counterpart of ``repro.kernels.ops`` for the cache data plane
(lookup/insert), the model's attention (prefill/decode) and its Mamba
layers' selective scan, and beyond it the MoE FFN's routing, dispatch,
SwiGLU and combine around its grouped products. Dispatch
follows the tensors' device: a CPU tensor goes to the kernel module's
plain PyTorch version, a CUDA tensor to the hand-written kernel, or the
call raises. There is no fallback from one to the other. Kernels take any
N, B and d (a multiple of 4), any Sq and Skv, and any L, so unlike the
TPU wrappers nothing is padded and no output needs slicing back; the TPU
wrappers' tile sizes and ``interpret`` switch have no counterpart.

With grad enabled and an input that requires grad (``_differentiable``),
``flash_attention`` and ``mamba_scan`` go through their kernels'
``torch.autograd.Function``s (``FlashAttentionFn``,
``MambaScanFn``): the same forward, on either device, and a backward by
autograd of the plain version, so the CPU tests run the backward code
the card runs.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flat_topk as _ft
from repro_torch.kernels import frontier_hop as _fh
from repro_torch.kernels import gather_scores as _gs
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import moe_fused as _mf
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import scatter_update as _su


# Every wrapper that counts its kernel's launches (``<wrapper>.launches``,
# and ``.recorded`` under a graph capture: see ``_build.count``).
COUNTED = (_fh.frontier_hop, _gs.gather_scores, _gs.gather_scores_masked,
           _ft.flat_topk, _su.scatter_rows, _su.scatter_flush,
           _fa.flash_attention, _da.decode_attention, _ms.mamba_scan,
           _mf.moe_route, _mf.moe_dispatch, _mf.swiglu_cast, _mf.moe_combine)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _f32_16(t: torch.Tensor) -> torch.Tensor:
    """_f32, copied when its start is not 16-byte aligned (a contiguous
    slice, such as B and C split from one projection at batch 1)."""
    t = _f32(t)
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _differentiable(*tensors) -> bool:
    """Whether a call must go through its kernel's autograd Function: grad
    is enabled and one of ``tensors`` (None skipped) requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


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
    mask applies too (``gather_scores_masked``); pass both or neither
    (exactly one raises). ``scales`` (N,) marks an int8 table.
    """
    if (slot_categories is None) != (query_categories is None):
        raise ValueError("hop_scores: slot_categories and query_categories "
                         "must be passed together (got exactly one)")
    table, indices, queries = table.contiguous(), _i32(indices), _f32(queries)
    scales = None if scales is None else _f32(scales)
    if slot_categories is not None:
        return _gs.gather_scores_masked(table, indices, queries,
                                        _i32(slot_categories),
                                        _i32(query_categories), scales)
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


def scatter_flush(tables: Sequence[torch.Tensor], packed: torch.Tensor,
                  R: int) -> None:
    """A whole delta flush in one launch: for every table, write its R
    staged rows into ``table[rows[r]]`` IN PLACE. ``packed`` is
    ``pack_flush(rows, [vals, ...])`` on the tables' device (the row ids
    and every table's rows, uploaded once). Any dtypes, 1-D tables too;
    the same contract as ``scatter_rows``."""
    for t in tables:
        if not t.is_contiguous():
            raise ValueError("scatter_flush: every table must be contiguous "
                             "(it is updated in place)")
    _su.scatter_flush(tables, packed, R)


pack_flush = _su.pack_flush


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, kv_offset: int = 0
                    ) -> torch.Tensor:
    """Prefill attention: q (B, Hq, Sq, dh), k/v (B, Hkv, Skv, dh) -> like
    q. Any Sq and Skv: the kernel masks its edges (nothing is padded, so a
    non-causal call never attends to a padding key). Differentiable
    (``FlashAttentionFn``) where ``_differentiable`` says so."""
    if _differentiable(q, k, v):
        return _fa.FlashAttentionFn.apply(q, k, v, causal, window, softcap, kv_offset,
                                          None)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, kv_offset=kv_offset)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, softcap: float | None = None,
                     window: int | None = None, first_row: torch.Tensor | None = None,
                     return_lse: bool = False):
    """Decode one token against the KV cache: q (B, Hq, dh), k/v
    (B, Hkv, S, dh) (strided views welcome), kv_len (B,) masks the ragged
    tail exactly; kv_len 0 gives 0. ``window`` keeps only the last
    ``window`` positions before kv_len (gemma2's local layers). A block of
    a sequence-sharded cache passes ``first_row`` (B,), its row 0's
    absolute position, and ``return_lse`` for (out, lse (B, Hq) fp32)."""
    return _da.decode_attention(q, k, v, _i32(kv_len.to(q.device)), softcap=softcap,
                                window=window, return_lse=return_lse,
                                first_row=None if first_row is None
                                else _i32(first_row.to(q.device)))


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, D: torch.Tensor, h0: torch.Tensor | None = None, *,
               h_out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan: x, dt (Bt, L, Dm); A (Dm, N); B, C (Bt, L, N);
    D (Dm,); h0 (Bt, Dm, N) or None (zeros) -> (y like x, h_final fp32).
    Any L ≥ 1, nothing padded. ``h_out`` (contiguous fp32, 16-byte
    aligned as h0, may be ``h0`` itself) receives h_final in place: a decode step updates the layer's
    cached state without a copy. Differentiable (``MambaScanFn``) where
    ``_differentiable`` says so, and then it refuses ``h_out``."""
    args = (x.contiguous(), _f32(dt), _f32_16(A), _f32_16(B), _f32_16(C), _f32(D),
            None if h0 is None else _f32(h0))
    if _differentiable(*args):
        if h_out is not None:
            raise ValueError("mamba_scan: h_out (a decode step's in-place state) "
                             "takes no gradient; pass h_out=None when training")
        return _ms.MambaScanFn.apply(*args)
    return _ms.mamba_scan(*args, h_out=h_out)


def moe_route(x: torch.Tensor, router_w: torch.Tensor, k: int, renormalize: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing: x (T, d), router (d, E) -> (ids (T, k) int32, weights
    (T, k) fp32 renormalised over the k, or the k probabilities without
    ``renormalize``); ties go to the lower expert."""
    return _mf.moe_route(x.contiguous(), router_w.contiguous(), k, renormalize)


def moe_dispatch(ids: torch.Tensor, x: torch.Tensor, n_experts: int,
                 count: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (token, choice) pairs of ids (T, k) stable-sorted by expert ->
    (order (T·k,), offs (E,) int32 cumulative ends, rows (T·k, d) =
    x[order // k]); ``count`` (one int32 element) gains the experts the
    pairs reach."""
    return _mf.moe_dispatch(_i32(ids), x.contiguous(), n_experts, count)


def swiglu_cast(g: torch.Tensor, u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """silu(g) · u in fp32, rounded to ``dtype``."""
    return _mf.swiglu_cast(g.contiguous(), u.contiguous(), dtype)


def moe_combine(part: torch.Tensor, order: torch.Tensor, weights: torch.Tensor
                ) -> torch.Tensor:
    """part (T·k, d) in ``moe_dispatch``'s order -> y (T, d) in part's
    dtype: each token's k rows weighted (weights (T, k) fp32) and summed in
    fp32."""
    return _mf.moe_combine(part.contiguous(), order.contiguous(), _f32(weights))
