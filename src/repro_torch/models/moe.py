"""Mixture-of-experts FFN on one device.

The counterpart of ``repro.models.moe``. Two implementations share one
routing function:

``moe_ffn_dense_exact``
    The plain version: every expert applied to every token in fp32, then
    combined with the top-k weights. O(T·E) work; the oracle of the tests
    and of the card checks. Nothing on the serving path calls it.

``moe_ffn_routed``
    The main path: the reference's ``_moe_local`` at one data shard and
    no model axis. The (token, choice) pairs are stable-sorted by expert,
    each expert's rows run through grouped products (``grouped_mm``), and
    the weighted outputs are combined per token in fp32.

Nothing is dropped. The reference's capacity (``_capacity``) is
⌈T·k / n_data · factor⌉ ≥ T·k at one data shard, so every pair fits and
the routed path computes the dense path's function; on one card there is
no capacity at all, and every buffer is sized T·k.

The routed path syncs nothing with the host and keeps static shapes, so
the engine's CUDA graphs capture it (``core/graphs.py`` warms every
program up with host syncs raising): the per-expert offsets come from a
``searchsorted`` of the sorted ids on the device (``bincount`` would read
its maximum back), experts with no rows are empty groups, and the combine
gathers each pair's output back to its token with unique indices, so its
fp32 sums run in a fixed order (an atomic ``index_add_`` would not).

The grouped product dispatches by device, as the kernel wrappers do. The
reference computes it outside any Pallas kernel (``lax.ragged_dot``), so
the card takes a library product: ``torch._grouped_mm`` on bf16 operands
with the offsets as a device int32 tensor, accumulating in fp32 and
returning bf16 (the only output type it offers). So on the card ``g`` and
``u`` are rounded to bf16 before ``silu(g)·u``, where the reference keeps
them in fp32 and rounds only the hidden; the down product is rounded to
the activation dtype in both, as ``_moe_local`` does before its combine.
A CPU tensor takes a plain loop over the experts with host-known offsets,
in fp32, which is the reference's arithmetic. Any other case on the card
(fp32 operands, a missing op, a layout it refuses) raises, naming the
cause; it never falls back to the loop or the dense path. The expert
matrices are used in their stored (E, d, ffe) / (E, ffe, d) row-major
order, which ``_grouped_mm`` takes as they are (16-byte-aligned strides),
so no copy of the weights is made.

The reference's ``_ragged_dot`` custom VJP works around a jax 0.4.x
cotangent dtype bug in training; it has no counterpart here.

Training: on the CPU the whole FFN, the Switch aux loss included, is
differentiable (the loop's products, the sort's values, the index ops).
On the card the backward needs one of ``torch._grouped_mm``, which a
given torch build may lack: with grad enabled and an operand that
requires grad, ``grouped_mm`` first asks the card's build
(``grouped_mm_has_backward``) and raises ``NotImplementedError`` naming
it where there is none, rather than switch to the loop.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def route(x: torch.Tensor, router_w: torch.Tensor, cfg
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. x (T, d) -> ids (T, k) int32, weights (T, k) fp32
    (renormalised over the k), aux load-balancing loss (scalar, Switch).

    Ties go to the lower expert, as ``lax.top_k`` breaks them: a stable
    descending sort of the E probabilities, first k taken (``torch.topk``
    promises no order among equals)."""
    k = cfg.moe_top_k
    logits = x.to(torch.float32) @ router_w.to(torch.float32)          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    # Switch aux loss: E · Σ_e f_e · P_e (serving discards it).
    E = probs.shape[-1]
    f = torch.zeros(E, dtype=torch.float32, device=x.device)
    f.scatter_add_(0, ids.reshape(-1), torch.ones(ids.numel(), device=x.device))
    f = f / f.sum().clamp(min=1.0)
    aux = E * torch.sum(f * probs.mean(dim=0))
    return ids.to(torch.int32), weights, aux


def moe_ffn_dense_exact(x: torch.Tensor, p: dict, cfg
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token in fp32, weighted by the top-k combine.
    x (T, d) -> (y (T, d) in x's dtype, aux). One expert at a time, so
    only one expert's weights are held in fp32 at once."""
    ids, weights, aux = route(x, p["router"], cfg)
    xf = x.to(torch.float32)
    combine = torch.zeros(x.shape[0], cfg.n_experts, dtype=torch.float32,
                          device=x.device)
    combine.scatter_add_(1, ids.long(), weights)                        # (T, E)
    y = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        g = xf @ p["w_gate"][e].to(torch.float32)
        u = xf @ p["w_up"][e].to(torch.float32)
        y += combine[:, e:e + 1] * ((F.silu(g) * u) @ p["w_down"][e].to(torch.float32))
    return y.to(x.dtype), aux


def grouped_mm(rows: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """``out[offs[e-1]:offs[e]] = rows[offs[e-1]:offs[e]] @ w[e]``: rows
    (N, K) sorted by group, w (G, K, M), offs (G,) int32 cumulative ends
    (offs[-1] == N). fp32 on the CPU, bf16 on the card (fp32 accumulation
    in both)."""
    if rows.device.type == "cpu":
        out = rows.new_zeros((rows.shape[0], w.shape[-1]), dtype=torch.float32)
        start = 0
        for e, end in enumerate(offs.tolist()):
            if end > start:
                out[start:end] = rows[start:end].to(torch.float32) @ w[e].to(torch.float32)
            start = end
        return out
    if rows.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"moe grouped product on {rows.device}: torch._grouped_mm "
                        f"takes bf16 operands only, got {rows.dtype} rows and "
                        f"{w.dtype} experts (an fp32 expert product is not "
                        f"supported on the card)")
    op = getattr(torch, "_grouped_mm", None)
    if op is None:
        raise RuntimeError(f"moe grouped product: torch {torch.__version__} has no "
                           f"torch._grouped_mm")
    if (torch.is_grad_enabled() and (rows.requires_grad or w.requires_grad)
            and not grouped_mm_has_backward(str(rows.device))):
        raise NotImplementedError(f"moe training on {rows.device}: torch._grouped_mm "
                                  f"has no backward in torch {torch.__version__}")
    try:
        return op(rows, w, offs=offs)
    except RuntimeError as exc:
        raise RuntimeError(f"moe grouped product: torch._grouped_mm refused rows "
                           f"{tuple(rows.shape)} {rows.stride()} and experts "
                           f"{tuple(w.shape)} {w.stride()}: {exc}") from exc


@functools.cache
def grouped_mm_has_backward(device: str) -> bool:
    """Whether ``torch._grouped_mm`` on ``device`` differentiates: one
    product of two groups of 8 bf16 rows, and its gradients."""
    op = getattr(torch, "_grouped_mm", None)
    if op is None:
        return False
    with torch.enable_grad():
        rows = torch.ones((16, 16), dtype=torch.bfloat16, device=device, requires_grad=True)
        w = torch.ones((2, 16, 16), dtype=torch.bfloat16, device=device, requires_grad=True)
        offs = torch.tensor([8, 16], dtype=torch.int32, device=device)
        try:
            torch.autograd.grad(op(rows, w, offs=offs).sum(), (rows, w))
        except (RuntimeError, NotImplementedError):
            return False
    return True


def moe_ffn_routed(x: torch.Tensor, p: dict, cfg
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based routed MoE (the reference's ``_moe_local`` at one data
    shard). x (T, d) -> (y (T, d) in x's dtype, aux)."""
    T, d = x.shape
    k, E = cfg.moe_top_k, cfg.n_experts
    ids, weights, aux = route(x, p["router"], cfg)
    flat_ids = ids.reshape(-1)                                  # (N = T·k,)
    sorted_ids, order = torch.sort(flat_ids, stable=True)
    tok = torch.div(order, k, rounding_mode="floor")            # pair -> token
    # Cumulative row ends per expert, on the device; empty experts repeat.
    bounds = torch.arange(E, dtype=sorted_ids.dtype, device=x.device)
    offs = torch.searchsorted(sorted_ids, bounds, right=True).to(torch.int32)
    rows = x.index_select(0, tok)                               # (N, d)
    g = grouped_mm(rows, p["w_gate"], offs)
    u = grouped_mm(rows, p["w_up"], offs)
    hidden = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    part = grouped_mm(hidden, p["w_down"], offs).to(x.dtype)   # (N, d)
    # Back to (token, choice) order, then the weighted sum over the k
    # choices in fp32.
    pairs = torch.empty_like(part).index_copy_(0, order, part)
    y = (pairs.view(T, k, d).to(torch.float32) * weights[..., None]).sum(dim=1)
    return y.to(x.dtype), aux


def moe_apply(x: torch.Tensor, p: dict, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) or (T, d) -> (y of x's shape, aux), through the routed
    path."""
    shape = x.shape
    y, aux = moe_ffn_routed(x.reshape(-1, shape[-1]), p, cfg)
    return y.reshape(shape), aux
