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

In serving on the card (a CUDA tensor, nothing that needs a gradient, no
aux asked for: ``sublayer_apply``'s prefill and decode) the steps around
the three grouped products are four hand-written kernels
(``kernels/moe_fused.py``): ``route`` takes ``moe_route``, then
``moe_dispatch`` (the stable sort, the offsets and the gathered rows in
one launch), ``swiglu_cast`` and ``moe_combine``; the Switch loss is not
computed. Everywhere else (the CPU, "meta", training) the same steps are
the PyTorch ops they replace (``moe_fused``'s plain versions).

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
(fp32 operands, a layout it refuses) raises, naming the cause; it never
falls back to the loop or the dense path. The expert matrices are used in
their stored (E, d, ffe) / (E, ffe, d) row-major order, which
``_grouped_mm`` takes as they are (16-byte-aligned strides), so no copy of
the weights is made.

Expert parallelism (``moe_ffn_ep``, under a mesh): the reference's
``_moe_local`` per rank, with the collectives written out. Experts are
padded to a multiple of ``n_data`` (``padded_experts``; padding logits
-1e30) and owned by ``data`` shards. Each rank routes its own tokens;
the Switch aux loss is the reference's global one (expert counts summed
over the token shards, mean probabilities over all tokens), returned as
this rank's term (its tokens' share of the probability mean), whose sum
over the token shards is the aux. Per destination shard the (token,
choice) pairs are stable-sorted, the first ``_capacity`` kept and the
rest dropped (the reference's order and ``slot`` arithmetic), tokens and
expert ids go to their owners by ``all_to_all`` over ``data``, the
owner's grouped products run on its local experts (the invalid rows in
one more group of zero weights, so every row belongs to a group), the
down products' partial sums over ``model`` are all-reduced or, with
``rs_combine``, reduce-scattered over d, the rows go back by
``all_to_all`` and are combined per token in fp32. Two layouts, as the
reference's: by default the tokens are this rank's (pod, data) rows,
replicated over ``model``, and each expert's FFN width splits over
``model``; ``token_parallel`` (``d_ff_expert < 128 · n_model``) splits
the rows over ``model`` as well and runs full-width experts. The drops
depend on the routing alone: ``kept_pairs`` gives them from a rank's
expert ids, for callers that count them; the FFN keeps no record.

Serving under a mesh (``moe_apply`` with ``rows``, the axes this rank's
rows split over: ``launch.sharding.batch_spec`` of the serving batch,
None where every rank holds every row) follows the reference's
dispatch on the global token count: EP where it splits over the token
shards, every rank then taking its block of replicated rows and
gathering the output back (EP drops at capacity, so choosing it where
the reference does not would change the result); otherwise, outside
autograd, each rank runs its stored experts (its ``data`` block, its
``model`` slice of their width) on every token of its batch line and
the partial outputs are summed over the axes the experts are stored on,
in rank order: the reference's "every device computes its expert shard
for all tokens", with no expert ever gathered. Training keeps its dense
path (``_moe_dense_dist``).

Training: on the CPU the whole FFN, the Switch aux loss included, is
differentiable (the loop's products, the sort's values, the index ops).
On the card the product runs inside ``GroupedMmFn``, with grad or
without: the counterpart of the reference's ``_ragged_dot`` custom VJP.
Its forward is the op itself, so serving computes what it did; its
backward is two more grouped products of the same op: the rows'
gradient against each expert's transposed weight (a strided view, no
copy), and the weights' gradient rowsᵀ·dOut as one 2-D × 2-D product
with the offsets over the rows (an expert with no rows gets zeros); each
accumulates in fp32 and is cast to its operand's dtype, as
``_ragged_dot_bwd`` casts.
"""

from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import P, axis_names
from repro_torch.kernels import moe_fused as _mf
from repro_torch.kernels import ops
from repro_torch.models.variants import variant_of

# The plain versions of ``moe_fused``'s steps under the ``ops`` wrappers'
# names: ``moe_ffn_routed`` takes one or the other.
_PLAIN = types.SimpleNamespace(moe_dispatch=_mf.dispatch_plain, swiglu_cast=_mf.swiglu_plain,
                               moe_combine=_mf.combine_plain)


def _top_k(x, router_w, cfg, e_pad: int):
    """(probs (T, e_pad), ids (T, k), weights (T, k) renormalised unless
    the model's variant says not, ``models/variants.py``):
    ``moe_fused.route_plain``, ties to the lower expert, padding experts
    at -1e30."""
    return _mf.route_plain(x, router_w, cfg.moe_top_k, e_pad,
                           renormalize=variant_of(cfg).moe_renormalize)


def _expert_counts(ids: torch.Tensor, e_pad: int) -> torch.Tensor:
    counts = torch.zeros(e_pad, dtype=torch.float32, device=ids.device)
    return counts.scatter_add_(0, ids.reshape(-1), torch.ones(ids.numel(), device=ids.device))


def _switch_aux(probs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss E · Σ_e f_e · P_e of one routing."""
    E = probs.shape[-1]
    f = _expert_counts(ids, E)
    f = f / f.sum().clamp(min=1.0)
    return E * torch.sum(f * probs.mean(dim=0))


def route(x: torch.Tensor, router_w: torch.Tensor, cfg
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Top-k routing. x (T, d) -> ids (T, k) int32, weights (T, k) fp32
    (renormalised over the k, or the k probabilities where the model's
    variant keeps them, ``models/variants.py``), aux load-balancing loss
    (scalar, Switch: ``_switch_aux``). On the card outside autograd the
    ``moe_route`` kernel routes and aux is None (serving discards it; a
    caller that wants it computes it, ``moe_ffn_routed``); otherwise
    ``_top_k``."""
    if x.device.type == "cuda" and not ops._differentiable(x, router_w):
        ids, weights = ops.moe_route(x, router_w, cfg.moe_top_k,
                                     variant_of(cfg).moe_renormalize)
        return ids, weights, None
    probs, ids, weights = _top_k(x, router_w, cfg, router_w.shape[-1])
    return ids.to(torch.int32), weights, _switch_aux(probs, ids)


def moe_ffn_dense_exact(x: torch.Tensor, p: dict, cfg
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token in fp32, weighted by the top-k combine.
    x (T, d) -> (y (T, d) in x's dtype, ``route``'s aux). One expert at a
    time, so only one expert's weights are held in fp32 at once."""
    ids, weights, aux = route(x, p["router"], cfg)
    return _dense_combine(x, ids, weights, p, cfg), aux


def _dense_combine(x, ids, weights, p: dict, cfg) -> torch.Tensor:
    xf = x.to(torch.float32)
    combine = torch.zeros(x.shape[0], cfg.n_experts, dtype=torch.float32,
                          device=x.device)
    combine.scatter_add_(1, ids.long(), weights)                        # (T, E)
    y = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        g = xf @ p["w_gate"][e].to(torch.float32)
        u = xf @ p["w_up"][e].to(torch.float32)
        y += combine[:, e:e + 1] * ((F.silu(g) * u) @ p["w_down"][e].to(torch.float32))
    return y.to(x.dtype)


def _loop_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``torch._grouped_mm``'s function as a plain loop over the groups, in
    fp32 (offs (G,) int32 cumulative ends): a (N, K) and b (G, K, M) give
    (N, M), rows offs[g-1]:offs[g] of a times b[g]; a (K, N) and b (N, M)
    give (G, K, M), each group's columns of a times its rows of b, zeros
    for an empty group. Autograd differentiates it."""
    start = 0
    if b.dim() == 3:
        out = a.new_zeros((a.shape[0], b.shape[-1]), dtype=torch.float32)
        for e, end in enumerate(offs.tolist()):
            if end > start:
                out[start:end] = a[start:end].to(torch.float32) @ b[e].to(torch.float32)
            start = end
        return out
    out = a.new_zeros((offs.shape[0], a.shape[0], b.shape[1]), dtype=torch.float32)
    for e, end in enumerate(offs.tolist()):
        if end > start:
            out[e] = a[:, start:end].to(torch.float32) @ b[start:end].to(torch.float32)
        start = end
    return out


def _op_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``torch._grouped_mm(a, b, offs=offs)``; a refusal names the
    operands' shapes and strides."""
    try:
        return torch._grouped_mm(a, b, offs=offs)
    except RuntimeError as exc:
        raise RuntimeError(f"moe grouped product: torch._grouped_mm refused "
                           f"{tuple(a.shape)} {a.stride()} and {tuple(b.shape)} "
                           f"{b.stride()}: {exc}") from exc


class GroupedMmFn(torch.autograd.Function):
    """``product(rows, w, offs)`` under autograd, where ``product`` computes
    ``torch._grouped_mm``'s function (the op on the card; ``_loop_mm`` in
    the CPU tests): rows (N, K) sorted by group, w (G, K, M), offs (G,)
    int32 cumulative ends. Backward: dRows = product(dOut, wᵀ) (each
    group's transposed weight, a view), dW = product(rowsᵀ, dOut) (the
    2-D × 2-D form: offsets over the rows, zeros for an empty group),
    each cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, rows, w, offs, product):
        ctx.save_for_backward(rows, w, offs)
        ctx.product = product
        return product(rows, w, offs)

    @staticmethod
    def backward(ctx, d_out):
        rows, w, offs = ctx.saved_tensors
        d_out = d_out.contiguous()
        d_rows = d_w = None
        if ctx.needs_input_grad[0]:
            d_rows = ctx.product(d_out, w.transpose(-1, -2), offs).to(rows.dtype)
        if ctx.needs_input_grad[1]:
            d_w = ctx.product(rows.transpose(0, 1), d_out, offs).to(w.dtype)
        return d_rows, d_w, None, None


def grouped_mm(rows: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """``out[offs[e-1]:offs[e]] = rows[offs[e-1]:offs[e]] @ w[e]``: rows
    (N, K) sorted by group, w (G, K, M), offs (G,) int32 cumulative ends
    (offs[-1] == N). fp32 on the CPU (``_loop_mm``), bf16 on the card
    (``GroupedMmFn`` over ``torch._grouped_mm``), fp32 accumulation in
    both."""
    if rows.device.type == "cpu":
        return _loop_mm(rows, w, offs)
    if rows.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"moe grouped product on {rows.device}: torch._grouped_mm "
                        f"takes bf16 operands only, got {rows.dtype} rows and "
                        f"{w.dtype} experts (an fp32 expert product is not "
                        f"supported on the card)")
    return GroupedMmFn.apply(rows, w, offs, _op_mm)


def moe_ffn_routed(x: torch.Tensor, p: dict, cfg, *, aux: bool = True,
                   count: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Sort-based routed MoE (the reference's ``_moe_local`` at one data
    shard). x (T, d) -> (y (T, d) in x's dtype, aux; None without
    ``aux``). The (token, choice) pairs are stable-sorted by expert, each
    expert's rows run through the grouped products, and the down rows go
    back to (token, choice) order and are summed over the k choices in
    fp32. On the card outside autograd and without ``aux`` (serving) the
    steps around the products are ``moe_fused``'s kernels; otherwise
    (the CPU, "meta", training) their plain versions. ``count`` (one
    int32 element on x's device) gains the number of experts the tokens
    reach, added on the device by the dispatch."""
    E = cfg.n_experts
    ids, weights, loss = route(x, p["router"], cfg)
    if aux and loss is None:        # the routing kernel ran (on the card, no autograd)
        loss = _switch_aux(_top_k(x, p["router"], cfg, E)[0], ids)
    fused = (x.device.type == "cuda" and not aux
             and not ops._differentiable(x, *p.values()))
    step = ops if fused else _PLAIN
    order, offs, rows = step.moe_dispatch(ids, x, E, count)    # rows (N = T·k, d)
    g = grouped_mm(rows, p["w_gate"], offs)
    u = grouped_mm(rows, p["w_up"], offs)
    hidden = step.swiglu_cast(g, u, x.dtype)
    part = grouped_mm(hidden, p["w_down"], offs).to(x.dtype)   # (N, d)
    return step.moe_combine(part, order, weights), loss if aux else None


def padded_experts(n_experts: int, n_data: int) -> int:
    return int(math.ceil(n_experts / n_data) * n_data)


def _capacity(t_loc: int, top_k: int, n_data: int, factor: float) -> int:
    c = int(math.ceil(t_loc * top_k / n_data * factor))
    return max(8, ((c + 7) // 8) * 8)


def _route_global(x, router_w, cfg, e_pad: int, dist, token_axes):
    """``route`` over this rank's tokens with the global aux loss: ids,
    weights, and this rank's term of the aux (summing to it over
    ``token_axes``): expert counts summed over the token shards, the
    probability mean over all their tokens."""
    E = cfg.n_experts
    probs, ids, weights = _top_k(x, router_w, cfg, e_pad)
    counts = coll.all_reduce(_expert_counts(ids, e_pad), dist, token_axes)
    f = counts / counts.sum().clamp(min=1.0)
    t_global = x.shape[0] * dist.axis_size(token_axes)
    aux = E * torch.sum(f[:E] * probs[:, :E].sum(dim=0) / t_global)
    return ids.to(torch.int32), weights, aux


def _dispatch(ids: torch.Tensor, e_loc: int, n_data: int, C: int):
    """The reference's dispatch order of one rank's (token, choice) pairs
    (ids (T_loc, k), in that order): a stable sort by owner shard, the
    first C of each shard kept, the rest dropped. Returns (order, the
    sorted pairs' keep mask, their send slot: owner · C + position, or
    n_data · C, a spare row, where dropped)."""
    flat_ids = ids.reshape(-1).long()                            # (N = T_loc·k,)
    dest = torch.div(flat_ids, e_loc, rounding_mode="floor")    # owner shard
    order = torch.sort(dest, stable=True).indices
    s_dest = dest[order]
    starts = torch.searchsorted(s_dest, torch.arange(n_data, device=ids.device))
    pos = torch.arange(flat_ids.shape[0], device=ids.device) - starts[s_dest]
    keep = pos < C                                               # drop overflow
    slot = torch.where(keep, s_dest * C + pos, n_data * C)      # OOB → dropped
    return order, keep, slot


def kept_pairs(ids: torch.Tensor, cfg, n_data: int, e_pad: int) -> torch.Tensor:
    """Which of one rank's (token, choice) pairs (ids (T_loc, k), the ids
    ``_moe_local`` takes) expert parallelism keeps at ``cfg``'s capacity:
    (T_loc, k) bool."""
    T_loc, k = ids.shape
    C = _capacity(T_loc, k, n_data, cfg.capacity_factor)
    order, keep, _ = _dispatch(ids, e_pad // n_data, n_data, C)
    return torch.empty_like(keep).index_copy_(0, order, keep).view(T_loc, k)


def _moe_local(x, ids, weights, w_gate, w_up, w_down, *, cfg, n_data: int, e_pad: int,
               dist, model_axis: str | None, rs_combine: bool = False):
    """Per rank: x (T_loc, d); expert blocks w_gate / w_up (E_loc, d,
    ff_loc), w_down (E_loc, ff_loc, d). Returns y (T_loc, d_out) in x's
    dtype, d_out = d / n_model with ``rs_combine``."""
    T_loc, d = x.shape
    k = cfg.moe_top_k
    e_loc = e_pad // n_data
    dev = x.device
    my = dist.coord(dist.data_axis)
    C = _capacity(T_loc, k, n_data, cfg.capacity_factor)
    order, keep, slot = _dispatch(ids, e_loc, n_data, C)
    flat_ids = ids.reshape(-1).long()
    flat_w = weights.reshape(-1)
    s_tok = torch.div(order, k, rounding_mode="floor")          # each pair's token
    s_eid = flat_ids[order]

    # One spare row takes every dropped pair; it is cut off before sending.
    send_tok = x.new_zeros((n_data * C + 1, d)).index_put((slot,), x[s_tok])[:-1]
    send_eid = torch.full((n_data * C + 1,), -1, dtype=torch.long, device=dev)
    send_eid = send_eid.index_put((slot,), s_eid)[:-1]

    # all_to_all over data: shard i's block j → shard j's block i.
    recv_tok = coll.all_to_all(send_tok, dist, dist.data_axis)
    recv_eid = coll.all_to_all(send_eid, dist, dist.data_axis)

    # Local expert compute: rows grouped by local expert, the invalid ones
    # (empty slots) last, in one more group of zero weights.
    leid = recv_eid - my * e_loc
    invalid = (recv_eid < 0) | (leid < 0) | (leid >= e_loc)
    leid = torch.where(invalid, e_loc, leid)
    s_leid, g_order = torch.sort(leid, stable=True)
    rows = recv_tok[g_order]
    offs = torch.searchsorted(s_leid, torch.arange(e_loc + 1, device=dev),
                              right=True).to(torch.int32)
    spare = (0, 0, 0, 0, 0, 1)
    h = grouped_mm(rows, F.pad(w_gate.to(rows.dtype), spare), offs)
    u = grouped_mm(rows, F.pad(w_up.to(rows.dtype), spare), offs)
    hidden = (F.silu(h.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    part = grouped_mm(hidden, F.pad(w_down.to(hidden.dtype), spare), offs).to(torch.float32)
    if model_axis is not None:
        if rs_combine:      # (M, d) partials → this rank's (M, d / n_model) sums
            part = coll.reduce_scatter(part, 1, dist, model_axis)
        else:
            part = coll.reduce_from(part, dist, model_axis)      # ffn partials

    # Unsort, return to senders, weighted combine.
    part = part.to(x.dtype)
    unsorted = torch.zeros_like(part).index_copy(0, g_order, part)
    back = coll.all_to_all(unsorted, dist, dist.data_axis)
    contrib = back[slot.clamp(max=n_data * C - 1)]               # (N, d_out)
    contrib = torch.where(keep[:, None], contrib.to(torch.float32), 0.0)
    y = torch.zeros((T_loc, contrib.shape[1]), dtype=torch.float32, device=dev)
    y = y.index_add(0, s_tok, contrib * flat_w[order][:, None])
    return y.to(x.dtype)


def _experts(p: dict, ps: dict, cfg, dist, e_pad: int, ff_axis, *, model_replica: bool):
    """This rank's expert blocks in the compute layout: experts (padded to
    ``e_pad``) over ``data``, the FFN width over ``ff_axis``, from their
    stored layout."""
    out = []
    for name, ff_dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        want = [dist.data_axis, None, None]
        want[ff_dim] = ff_axis
        t = p[name]
        if e_pad == cfg.n_experts:
            t = coll.fetch(t, ps[name], P(*want), dist, model_replica=model_replica)
        else:
            want[0] = None
            t = coll.fetch(t, ps[name], P(*want), dist, model_replica=model_replica)
            t = F.pad(t, (0, 0, 0, 0, 0, e_pad - cfg.n_experts))
            t = coll.split(t, 0, dist, dist.data_axis, gather_grad=False)
        out.append(t)
    return out


def moe_ffn_ep(x: torch.Tensor, p: dict, cfg, dist, token_parallel: bool = False, *,
               pspec: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE. x (T_loc, d): this rank's (pod, data) rows,
    replicated over ``model``; ``p`` this rank's blocks, stored as
    ``pspec`` says. Returns (y (T_loc, d), this rank's aux term).

    Default layout: each expert's FFN width splits over ``model``, the
    down products' partials reduce-scattered over d (``rs_combine``,
    where d divides) or all-reduced. ``token_parallel``: the rows split
    over ``model`` too, full-width experts, no model-axis reduction."""
    n_data, M = dist.n_data, dist.model_axis
    e_pad = padded_experts(cfg.n_experts, n_data)
    router = coll.fetch(p["router"], pspec["router"], P(), dist)
    ids, weights, aux = _route_global(x, router, cfg, e_pad, dist, dist.batch_axes)
    kw = dict(cfg=cfg, n_data=n_data, e_pad=e_pad, dist=dist)

    if token_parallel and dist.n_model > 1:
        w = _experts(p, pspec, cfg, dist, e_pad, None, model_replica=False)
        xs = coll.split(x, 0, dist, M, gather_grad=True)
        ws = coll.split(weights, 0, dist, M, gather_grad=True)
        ids_s = ids.narrow(0, dist.coord(M) * xs.shape[0], xs.shape[0])
        y = _moe_local(xs, ids_s, ws, *w, model_axis=None, **kw)
        return coll.gather(y, 0, dist, M, sum_grad=False), aux

    if dist.n_model > 1 and cfg.d_ff_expert % dist.n_model:
        raise ValueError(f"{cfg.name}: d_ff_expert {cfg.d_ff_expert} does not split "
                         f"over model {dist.n_model}")
    w = _experts(p, pspec, cfg, dist, e_pad, M, model_replica=True)
    rs = dist.n_model > 1 and cfg.d_model % dist.n_model == 0
    xin = coll.copy_to(x, dist, M)
    win = coll.copy_to(weights, dist, M) if rs else weights
    y = _moe_local(xin, ids, win, *w, model_axis=M if dist.n_model > 1 else None,
                   rs_combine=rs, **kw)
    if rs:
        y = coll.gather(y, 1, dist, M, sum_grad=False)
    return y, aux


def _moe_dense_dist(x, p, ps, cfg, dist):
    """Under a mesh where EP does not apply (one data shard, or tokens
    that do not split): every expert on this rank's tokens, the weights
    gathered whole, the reference's global aux."""
    router = coll.fetch(p["router"], ps["router"], P(), dist)
    ids, weights, aux = _route_global(x, router, cfg, cfg.n_experts, dist, dist.batch_axes)
    full = {k: coll.fetch(p[k], ps[k], P(), dist) for k in ("w_gate", "w_up", "w_down")}
    return _dense_combine(x, ids, weights, full, cfg), aux


def _moe_dense_sharded(x, p, ps, cfg, dist, rows):
    """The dense path in serving (no autograd): every token of this rank's
    batch line (its rows gathered over ``rows``) routed once, this rank's
    stored experts run on all of them in fp32 (their ``model`` slice of
    the FFN width: silu(g)·u is per column, the down product a partial
    sum), the partials summed over the experts' storage axes in rank
    order, this rank's rows taken back. Returns (y, the batch line's aux
    as ``route`` gives it, which serving discards)."""
    router = coll.fetch(p["router"], ps["router"], P(), dist)
    xa = coll.fetch(x, P(rows), P(), dist)
    ids, weights, aux = route(xa, router, cfg)
    combine = torch.zeros(xa.shape[0], cfg.n_experts, dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, ids.long(), weights)
    spec = ps["w_gate"]
    e_loc = p["w_gate"].shape[0]
    e0 = dist.coord(spec[0]) * e_loc
    xf = xa.to(torch.float32)
    y = torch.zeros_like(xf)
    for e in range(e_loc):
        g = xf @ p["w_gate"][e].to(torch.float32)
        u = xf @ p["w_up"][e].to(torch.float32)
        y += combine[:, e0 + e:e0 + e + 1] * (
            (F.silu(g) * u) @ p["w_down"][e].to(torch.float32))
    stored = set(axis_names(spec[0]) + axis_names(spec[2]))
    axes = tuple(a for a in dist.mesh.mesh_dim_names if a in stored)
    y = coll.all_reduce(y, dist, axes or None).to(x.dtype)
    return coll.fetch(y, P(), P(rows), dist), aux


def moe_apply(x: torch.Tensor, p: dict, cfg, dist=None, *, pspec: dict | None = None,
              rows=..., aux: bool = True, count: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x (B, S, d) or (T, d) -> (y of x's shape, aux; None without
    ``aux``, which serving passes). Without a mesh the routed path, which
    then computes no aux, and adds the experts its tokens reach to
    ``count`` where one is given (``moe_ffn_routed``). Under a mesh, which
    keeps no ``count`` (``p`` this rank's blocks,
    ``pspec`` their specs, x this rank's rows), the reference's dispatch on the global
    token count: EP, token-parallel for small experts (``d_ff_expert <
    128 · n_model``), where there is more than one data shard and the
    global tokens split over the token shards; every expert on every token
    otherwise. Training leaves ``rows`` out: the rows split over the batch
    axes, the dense path is ``_moe_dense_dist`` and aux is this rank's
    term of the global aux (``moe_ffn_ep``). Serving passes ``rows``, the
    axes its rows split over (None: replicated), and takes
    ``_moe_dense_sharded``."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if dist is None or dist.mesh is None:
        y, loss = moe_ffn_routed(x2, p, cfg, aux=aux, count=count)
        return y.reshape(shape), loss
    batch = dist.batch_axes
    serving = rows is not ...
    rows = rows if serving else batch
    tp = dist.n_model > 1 and cfg.d_ff_expert < 128 * dist.n_model
    tok_shards = dist.n_pod * dist.n_data * (dist.n_model if tp else 1)
    t_global = x2.shape[0] * dist.axis_size(rows)
    if dist.n_data > 1 and t_global % tok_shards == 0:
        # EP on this rank's block of the tokens over the batch axes
        xs = coll.fetch(x2, P(rows), P(batch), dist)
        y, loss = moe_ffn_ep(xs, p, cfg, dist, token_parallel=tp, pspec=pspec)
        y = coll.fetch(y, P(batch), P(rows), dist)
    elif serving:
        y, loss = _moe_dense_sharded(x2, p, pspec, cfg, dist, rows)
    else:
        y, loss = _moe_dense_dist(x2, p, pspec, cfg, dist)
    return y.reshape(shape), loss if aux else None
