"""The MoE FFN's glue around its grouped products, in four kernels.

Replaces no TPU kernel: the reference routes, sorts, gathers and combines
in XLA around ``lax.ragged_dot`` (``repro/models/moe.py:_moe_local``).
On the card the same steps as PyTorch ops launched ~40 kernels in every
MoE layer of every captured prefill and decode graph, each a few
microseconds of a launch's latency on a few kilobytes at a decode step.
``csrc/moe_fused.cu`` does them in four launches; ``models/moe.py`` takes
them where the layer runs on the card outside autograd and without its
load-balancing loss (serving), and the plain versions below, which are
those PyTorch ops, everywhere else.

    moe_route    — x · router in fp32 FMAs, softmax, top-k (ties to the
                   lower expert), the k weights renormalised
    moe_dispatch — the (token, choice) pairs' stable sort by expert (the
                   order ``torch.sort(stable=True)`` gives), the cumulative
                   per-expert ends, and the pairs' rows of x gathered
    swiglu_cast  — silu(g) · u in fp32 from bf16 g and u, rounded to bf16
    moe_combine  — each token's k rows of the down product, weighted and
                   summed in fp32 in the order torch's sum takes, rounded
                   to bf16

Bound on the H100: launches. At granite-moe's decode step (T 8, d 1,536,
E 40, k 8) the four move ~0.9 MB (the fp32 router is 245 KB of it), under
a third of a microsecond at 3.35 TB/s; at a prefill of 8 x 64 (T 512)
~42 MB, ~13 µs.
The sources say how each spreads its bytes over the SMs without a host
sync, atomics on device memory or a data-dependent shape.

What may differ from the plain versions on the card: the router logits
sum over d in another order than cuBLAS, so a choice within a rounding of
a tie may go the other way (chip_smoke's ``near_ties`` judges it) and the
weights differ in the last bits. The dispatch is exact (the same order,
offsets and rows); SwiGLU and the combine compute the plain versions'
fp32 operations in their order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _DTYPES

MAX_EXPERTS = 512
MAX_TOP_K = 16
_ROUTE_TOKENS = 8     # tokens a routing cluster at most (kRouteTokens)
_FILL_BLOCKS = 64     # blocks the dispatch and combine aim for at a small T


# ------------------------------------------------------------ plain versions

def route_plain(x: torch.Tensor, router_w: torch.Tensor, k: int, e_pad: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs (T, e_pad), ids (T, k) int64, weights (T, k) fp32
    renormalised). Ties go to the lower expert, as ``lax.top_k`` breaks
    them: a stable descending sort of the probabilities, first k taken
    (``torch.topk`` promises no order among equals). Padding experts
    (``e_pad`` beyond the router's columns) score -1e30, as the
    reference's."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)          # (T, E)
    if e_pad is not None and e_pad > logits.shape[-1]:
        logits = F.pad(logits, (0, e_pad - logits.shape[-1]), value=-1e30)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, ids, weights


def dispatch_plain(ids: torch.Tensor, x: torch.Tensor, n_experts: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ids (T, k), x (T, d) -> (order (T·k,) int64: the pairs stable-sorted
    by expert; offs (E,) int32: each expert's cumulative row end, empty
    experts repeating; rows (T·k, d) = x[order // k]). The per-expert ends
    come from a ``searchsorted`` of the sorted ids on the device
    (``bincount`` would read its maximum back)."""
    k = ids.shape[-1]
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    tok = torch.div(order, k, rounding_mode="floor")            # pair -> token
    bounds = torch.arange(n_experts, dtype=sorted_ids.dtype, device=x.device)
    offs = torch.searchsorted(sorted_ids, bounds, right=True).to(torch.int32)
    return order, offs, x.index_select(0, tok)


def swiglu_plain(g: torch.Tensor, u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """silu(g) · u in fp32, rounded to ``dtype``."""
    return (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(dtype)


def combine_plain(part: torch.Tensor, order: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """part (T·k, d) in sorted order -> y (T, d) in part's dtype: the rows
    back in (token, choice) order, unique indices (so the fp32 sums run in
    a fixed order, as an atomic ``index_add_`` would not), weighted and
    summed over the k choices in fp32."""
    T, k = weights.shape
    pairs = torch.empty_like(part).index_copy_(0, order, part)
    y = (pairs.view(T, k, -1).to(torch.float32) * weights[..., None]).sum(dim=1)
    return y.to(part.dtype)


# ------------------------------------------------------------------ kernels

def _aligned(name: str, *tensors: torch.Tensor) -> None:
    """Rows travel as 16-byte words: each tensor's start and row bytes
    must be multiples of 16."""
    for t in tensors:
        if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
            raise ValueError(f"{name}: rows must start 16-byte aligned and hold a "
                             f"multiple of 16 bytes (got {tuple(t.shape)} "
                             f"{t.dtype} at {t.data_ptr() % 16} past 16)")


def _column_blocks(row_blocks: int, vec: int) -> int:
    """Column blocks a row block splits into: enough blocks to spread a
    small T over the SMs, at least 16 words of 16 bytes a block's row."""
    return max(1, min(-(-_FILL_BLOCKS // max(row_blocks, 1)), vec // 16))


def moe_route(x: torch.Tensor, router_w: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) and router (d, E), each fp32 or bf16 -> (ids (T, k) int32,
    weights (T, k) fp32 renormalised over the k). A CPU x takes
    ``route_plain``; a CUDA x launches the kernel (contiguous tensors, E ≤
    512, k ≤ 16 and k ≤ E)."""
    if x.device.type == "cpu":
        _, ids, weights = route_plain(x, router_w, k)
        return ids.to(torch.int32), weights
    _build.require_cuda("moe_route", x, router_w)
    T, d = x.shape
    E = router_w.shape[-1]
    if x.dtype not in _DTYPES or router_w.dtype not in _DTYPES:
        raise ValueError(f"moe_route: x and the router must be fp32 or bf16 (got "
                         f"{x.dtype} and {router_w.dtype})")
    if router_w.shape != (d, E) or not 1 <= E <= MAX_EXPERTS or not 1 <= k <= min(E, MAX_TOP_K):
        raise ValueError(f"moe_route: the router must be (d={d}, E) with 1 ≤ E ≤ "
                         f"{MAX_EXPERTS} and 1 ≤ k ≤ min(E, {MAX_TOP_K}) (got "
                         f"{tuple(router_w.shape)}, k {k})")
    ids = torch.empty((T, k), dtype=torch.int32, device=x.device)
    weights = torch.empty((T, k), dtype=torch.float32, device=x.device)
    tb = max(1, min(_ROUTE_TOKENS, T // 64))
    err = _build.library().moe_route_launch(
        x.data_ptr(), router_w.data_ptr(), ids.data_ptr(), weights.data_ptr(), T, d, E, k,
        _DTYPES[x.dtype], _DTYPES[router_w.dtype], tb, _build.stream(x.device))
    _build.check(err, "moe_route")
    _build.count(moe_route)
    return ids, weights


def moe_dispatch(ids: torch.Tensor, x: torch.Tensor, n_experts: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ids (T, k) int32 in [0, E), x (T, d) -> (order (T·k,), offs (E,)
    int32, rows (T·k, d) in x's dtype), as ``dispatch_plain`` (which a CPU
    x takes; its order is int64, the kernel's int32). A CUDA x launches
    the kernel: contiguous tensors, E ≤ 512, 16-byte rows."""
    if x.device.type == "cpu":
        return dispatch_plain(ids, x, n_experts)
    _build.require_cuda("moe_dispatch", ids, x)
    T, d = x.shape
    if ids.dtype != torch.int32 or ids.dim() != 2 or ids.shape[0] != T:
        raise ValueError(f"moe_dispatch: ids must be (T={T}, k) int32 (got "
                         f"{tuple(ids.shape)} {ids.dtype})")
    if not 1 <= n_experts <= MAX_EXPERTS:
        raise ValueError(f"moe_dispatch: E {n_experts} outside 1..{MAX_EXPERTS}")
    _aligned("moe_dispatch", x)
    N, k = ids.numel(), ids.shape[1]
    order = torch.empty((N,), dtype=torch.int32, device=x.device)
    offs = torch.zeros((n_experts,), dtype=torch.int32, device=x.device) if N == 0 else \
        torch.empty((n_experts,), dtype=torch.int32, device=x.device)
    rows = torch.empty((N, d), dtype=x.dtype, device=x.device)
    vec = d * x.element_size() // 16
    err = _build.library().moe_dispatch_launch(
        ids.data_ptr(), x.data_ptr(), order.data_ptr(), offs.data_ptr(), rows.data_ptr(),
        N, k, n_experts, vec, _column_blocks(-(-N // 32), vec), _build.stream(x.device))
    _build.check(err, "moe_dispatch")
    _build.count(moe_dispatch)
    return order, offs, rows


def swiglu_cast(g: torch.Tensor, u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """silu(g) · u in fp32, rounded to ``dtype``: ``swiglu_plain`` for a
    CPU g; on the card the kernel, for contiguous bf16 g and u of one
    shape, 16-byte aligned, a multiple of 8 elements, and bf16 out."""
    if g.device.type == "cpu":
        return swiglu_plain(g, u, dtype)
    _build.require_cuda("swiglu_cast", g, u)
    if g.dtype != torch.bfloat16 or u.dtype != torch.bfloat16 or dtype != torch.bfloat16:
        raise ValueError(f"swiglu_cast: bf16 g and u to bf16 only on the card (got "
                         f"{g.dtype}, {u.dtype} -> {dtype})")
    if g.shape != u.shape or g.numel() % 8:
        raise ValueError(f"swiglu_cast: g and u must share a shape of a multiple of 8 "
                         f"elements (got {tuple(g.shape)} and {tuple(u.shape)})")
    if g.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("swiglu_cast: g and u must start 16-byte aligned")
    h = torch.empty_like(g)
    err = _build.library().swiglu_cast_launch(g.data_ptr(), u.data_ptr(), h.data_ptr(),
                                              g.numel() // 8, _build.stream(g.device))
    _build.check(err, "swiglu_cast")
    _build.count(swiglu_cast)
    return h


def moe_combine(part: torch.Tensor, order: torch.Tensor, weights: torch.Tensor
                ) -> torch.Tensor:
    """part (T·k, d) in sorted order, order (T·k,), weights (T, k) fp32 ->
    y (T, d) in part's dtype, as ``combine_plain`` (which a CPU part
    takes). A CUDA part launches the kernel: contiguous tensors, bf16 part
    with 16-byte rows, int32 order, k ≤ 16."""
    if part.device.type == "cpu":
        return combine_plain(part, order, weights)
    _build.require_cuda("moe_combine", part, order, weights)
    T, k = weights.shape
    N, d = part.shape
    if part.dtype != torch.bfloat16 or order.dtype != torch.int32 \
            or weights.dtype != torch.float32:
        raise ValueError(f"moe_combine: bf16 part, int32 order and fp32 weights only "
                         f"(got {part.dtype}, {order.dtype}, {weights.dtype})")
    if N != T * k or order.shape != (N,) or not 1 <= k <= MAX_TOP_K:
        raise ValueError(f"moe_combine: part ({N}, d) and order ({N},) must hold T·k "
                         f"rows for weights {tuple(weights.shape)}, k ≤ {MAX_TOP_K}")
    _aligned("moe_combine", part)
    y = torch.empty((T, d), dtype=part.dtype, device=part.device)
    vec = d * part.element_size() // 16
    tb = max(1, min(8, T // 128))
    err = _build.library().moe_combine_launch(
        part.data_ptr(), order.data_ptr(), weights.data_ptr(), y.data_ptr(), T, N, k, vec,
        tb, _column_blocks(-(-T // tb), vec), _build.stream(part.device))
    _build.check(err, "moe_combine")
    _build.count(moe_combine)
    return y


for _fn in (moe_route, moe_dispatch, swiglu_cast, moe_combine):
    _fn.launches = _fn.recorded = 0
