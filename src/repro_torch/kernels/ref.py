"""Plain PyTorch oracles for the port's kernels.

Each function is the direct mathematical definition (no tiling, no
chunking), the counterpart of ``repro.kernels.ref``'s oracles. The
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


NEG_INF = -1e30         # the attention kernels' running-max floor


def _attend_plain(logits: torch.Tensor, mask: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Masked softmax(logits) @ v in fp32, as the attention kernels compute
    it: a masked score takes no probability mass, the row max ignores it,
    and the output is ``acc / max(l, 1e-30)``, so a row with no visible key
    is 0 (``attention_ref``'s fully-masked rows, the decode kernel's
    ``kv_len = 0``)."""
    m = logits.masked_fill(~mask, NEG_INF).amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(-1, keepdim=True)
    return (p @ v) / l.clamp_min(1e-30)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None, kv_offset: int = 0,
                  scale: float | None = None) -> torch.Tensor:
    """Full-materialization GQA attention with masks and softcap.

    q (B, Hq, Sq, dh); k/v (B, Hkv, Skv, dh); Hq % Hkv == 0. Query i sits at
    absolute position i + kv_offset and sees key j iff j <= i + kv_offset
    (causal) and j > i + kv_offset - window (window). Scores, softmax and
    P·V are fp32 (the probabilities are not rounded); the output takes q's
    dtype.
    """
    B, Hq, Sq, dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else dh ** -0.5
    qf = q.to(torch.float32).reshape(B, Hkv, g, Sq, dh)
    logits = qf @ k.to(torch.float32)[:, :, None].transpose(-1, -2) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + kv_offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    out = _attend_plain(logits, mask, v.to(torch.float32)[:, :, None])
    return out.reshape(B, Hq, Sq, dh).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         kv_len: torch.Tensor | int | None = None,
                         softcap: float | None = None, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """One-token GQA decode: q (B, Hq, dh) against k/v (B, Hkv, S, dh).

    ``kv_len`` (scalar or (B,); None = S) hides positions >= kv_len; a
    sequence with kv_len 0 attends to nothing and gives 0. ``window`` also
    hides positions <= (kv_len - 1) - window, as the reference's
    ``models.attention.attend_decode`` masks it. k/v may be strided views
    (the model's cache is (B, S, Hkv, dh) seen through a transpose).
    """
    B, Hq, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else dh ** -0.5
    qf = q.to(torch.float32).reshape(B, Hkv, g, 1, dh)
    logits = qf @ k.to(torch.float32)[:, :, None].transpose(-1, -2) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    kpos = torch.arange(S, device=q.device)[None, :]
    lens = torch.as_tensor(S if kv_len is None else kv_len, device=q.device)
    lens = lens.reshape(-1).expand(B)[:, None]
    mask = kpos < lens
    if window is not None:
        mask &= kpos > (lens - 1) - window
    out = _attend_plain(logits, mask[:, None, None, None, :],
                        v.to(torch.float32)[:, :, None])
    return out.reshape(B, Hq, dh).to(q.dtype)


def mamba_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan (Mamba1), a sequential loop over L.

    x, dt (Bt, L, Dm); A (Dm, N); B, C (Bt, L, N); D (Dm,); h0 (Bt, Dm, N)
    or None (zeros).
    h_t = exp(dt_t ⊙ A) * h_{t-1} + (dt_t * x_t) ⊗ B_t
    y_t = Σ_n h_t[:, :, n] C_t[n] + D ⊙ x_t
    All arithmetic is fp32. Returns (y (Bt, L, Dm) in x's dtype, h_final
    (Bt, Dm, N) fp32).
    """
    Bt, L, Dm = x.shape
    f32 = torch.float32
    xf, dtf, Bf, Cf = (t.to(f32) for t in (x, dt, B, C))
    Af, Df = A.to(f32), D.to(f32)
    h = (torch.zeros((Bt, Dm, A.shape[1]), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t, :, None] * Af[None])
        dBx = (dtf[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        h = dA * h + dBx
        ys.append((h * Cf[:, t, None, :]).sum(-1) + Df[None] * xf[:, t])
    return torch.stack(ys, 1).to(x.dtype), h
