"""Autograd-aware collectives over a ``Dist``'s process groups.

The reference leaves communication to GSPMD; the port says it. Every
function takes the ``Dist`` and the axes (one name or a tuple of names in
the mesh's order) it runs over, and is the identity on a line of one rank:
without a mesh (``dist`` None or ``Dist.single()``) or where ``axes`` is
None, so the model code calls them on every path.
Each launches on PyTorch's current stream, synchronously (gloo blocks the
host; a CUDA tensor's result is ordered on the current stream).

Two conventions meet in the model code, and each collective's backward
follows the one of its axis:

* ``model`` (tensor parallelism): the ranks of a model line compute the
  same loss, and each backward starts from the same seed (Megatron's). A
  tensor that every model rank holds whole (the residual stream) has the
  same, complete gradient on each. ``copy_to`` (f: forward identity,
  backward all-reduce) opens a region whose ranks each compute a part
  (local heads, FFN columns), ``reduce_from`` (g: forward all-reduce,
  backward identity) closes it. ``gather(..., sum_grad=False)`` assembles
  a tensor every rank then uses whole, its backward takes the rank's own
  block of the (equal) gradients; ``split(..., gather_grad=True)`` hands
  each rank its block of such a tensor, its backward assembles the
  gradient again.
* ``pod`` / ``data`` (the batch axes): the ranks see different tokens and
  their losses add up. An FSDP dim is gathered forward and reduce-
  scattered (summed) backward (``gather(..., sum_grad=True)``);
  ``all_to_all`` is its own inverse; a block taken from a tensor replicated
  over a batch axis (``split(..., gather_grad=False)``) passes back a
  zero-padded gradient, and the train step sums those over the axis.

Transport: on a ``gloo`` group a CUDA tensor is staged through host
memory, explicitly: copied to the CPU, sent, copied back; ``STAGED``
counts those calls by operation. Every operation stages: on the card's
torch 2.11 a gloo all-reduce of CUDA tensors (four ranks on one card)
killed the ranks with a gloo ``IoException``. That is transport only:
gloo moves bytes (all-gather, all-to-all, send / receive) and never
reduces. A sum is an all-gather and an addition in rank order, a maximum
an all-gather and an ``amax``, a reduce-scatter an all-to-all of the
blocks and an addition in rank order, each on the tensors' device. So
every rank of a line gets the same bits (gloo's own all-reduce of four
ranks did not), and a replicated leaf's gradient, and so the leaf, stays
equal on every rank. Another backend (NCCL) reduces with its own
collectives.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as tdist

from repro_torch.distributed.context import Dist, axis_names

STAGED: Counter = Counter()
# torch 2.13 renames reduce_scatter_tensor (same arguments) and deprecates the old name.
_REDUCE_SCATTER = getattr(tdist, "reduce_scatter_single", None) or tdist.reduce_scatter_tensor


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and _gloo(group)


def _host(op: str, t: torch.Tensor) -> torch.Tensor:
    STAGED[op] += 1
    return t.cpu()


# -- plain collectives (no autograd) -----------------------------------------

def _gloo(group) -> bool:
    return tdist.get_backend(group) == "gloo"


def _sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    """parts (n, ...) -> their sum, added in rank order."""
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out


def _all_reduce(t: torch.Tensor, group, op=tdist.ReduceOp.SUM) -> torch.Tensor:
    if _gloo(group):
        parts = _all_gather(t[None], 0, group, tdist.get_world_size(group))
        return _sum_in_order(parts) if op == tdist.ReduceOp.SUM else parts.amax(dim=0)
    out = t.clone()
    tdist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    src = t.contiguous()
    if _staged(src, group):
        src = _host("all_gather", src)
    parts = [torch.empty_like(src) for _ in range(n)]
    tdist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _reduce_scatter(t: torch.Tensor, dim: int, group, n: int, idx: int) -> torch.Tensor:
    """The sum over the group of each rank's ``t``, split along ``dim``:
    this rank's block (``idx``)."""
    if _gloo(group):
        # block j to rank j; the blocks received, one from each rank, added
        return _sum_in_order(_all_to_all(torch.stack(t.chunk(n, dim)), group))
    chunks = [c.contiguous().reshape(-1) for c in t.chunk(n, dim)]
    out = t.new_empty(chunks[0].numel())
    _REDUCE_SCATTER(out, torch.cat(chunks), group=group)
    return out.view(t.chunk(n, dim)[idx].shape)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    src = t.contiguous()
    if _staged(src, group):
        src = _host("all_to_all", src)
    out = torch.empty_like(src)
    tdist.all_to_all_single(out, src, group=group)
    return out.to(t.device)


def _block(t: torch.Tensor, dim: int, n: int, idx: int) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {n}")
    size = t.shape[dim] // n
    return t.narrow(dim, idx * size, size)


# -- autograd Functions ---------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, idx, sum_grad):
        ctx.args = (dim, group, n, idx, sum_grad)
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, idx, sum_grad = ctx.args
        if sum_grad:
            return _reduce_scatter(g, dim, group, n, idx), None, None, None, None, None
        return _block(g, dim, n, idx).contiguous(), None, None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, idx, gather_grad):
        ctx.args = (x.shape, dim, group, n, idx, gather_grad)
        return _block(x, dim, n, idx).contiguous()

    @staticmethod
    def backward(ctx, g):
        shape, dim, group, n, idx, gather_grad = ctx.args
        if gather_grad:
            return _all_gather(g, dim, group, n), None, None, None, None, None
        full = g.new_zeros(shape)
        _block(full, dim, n, idx).copy_(g)
        return full, None, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, idx):
        ctx.args = (dim, group, n)
        return _reduce_scatter(x, dim, group, n, idx)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return _all_gather(g, dim, group, n), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


# -- the model code's entry points ------------------------------------------------

def _line(dist: Dist, axes):
    """(group, size, this rank's index) along ``axes``, or None on a line
    of one rank."""
    if dist is None or dist.mesh is None:
        return None
    n = dist.axis_size(axes)
    if n == 1:
        return None
    return dist.group(axes), n, dist.coord(axes)


def copy_to(x: torch.Tensor, dist: Dist, axes) -> torch.Tensor:
    """Megatron's f: identity forward, all-reduce of the gradient."""
    line = _line(dist, axes)
    return x if line is None else _CopyTo.apply(x, line[0])


def reduce_from(x: torch.Tensor, dist: Dist, axes) -> torch.Tensor:
    """Megatron's g: all-reduce (sum) forward, identity backward."""
    line = _line(dist, axes)
    return x if line is None else _ReduceFrom.apply(x, line[0])


def gather(x: torch.Tensor, dim: int, dist: Dist, axes, *, sum_grad: bool) -> torch.Tensor:
    """All-gather along ``dim``. Backward: reduce-scatter (``sum_grad``,
    ranks with different contributions) or this rank's block (ranks that
    hold the same gradient)."""
    line = _line(dist, axes)
    return x if line is None else _Gather.apply(x, dim, *line, sum_grad)


def split(x: torch.Tensor, dim: int, dist: Dist, axes, *, gather_grad: bool) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``. Backward: all-gather of
    the blocks' gradients (``gather_grad``) or the gradient zero-padded."""
    line = _line(dist, axes)
    return x if line is None else _Split.apply(x, dim, *line, gather_grad)


def reduce_scatter(x: torch.Tensor, dim: int, dist: Dist, axes) -> torch.Tensor:
    """The sum over the line, this rank's block along ``dim``; backward an
    all-gather."""
    line = _line(dist, axes)
    return x if line is None else _ReduceScatter.apply(x, dim, *line)


def all_to_all(x: torch.Tensor, dist: Dist, axes) -> torch.Tensor:
    """Equal blocks along dim 0: block j goes to rank j of the line, and
    block i of the result came from rank i. Its own inverse, forward and
    backward."""
    line = _line(dist, axes)
    return x if line is None else _AllToAll.apply(x, line[0])


def all_reduce(x: torch.Tensor, dist: Dist, axes, op: str = "sum") -> torch.Tensor:
    """A value reduced over the line ("sum" or "max"), outside autograd:
    counts, maxima, reported metrics."""
    line = _line(dist, axes)
    x = x.detach()
    if line is None:
        return x
    ops = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}
    return _all_reduce(x, line[0], ops[op])


def gather_value(x: torch.Tensor, dim: int, dist: Dist, axes) -> torch.Tensor:
    """All-gather along ``dim`` outside autograd (``gather_tree``)."""
    line = _line(dist, axes)
    x = x.detach()
    return x if line is None else _all_gather(x, dim, line[0], line[1])


def fetch(t: torch.Tensor, stored, want, dist: Dist, *, model_replica: bool = True
          ) -> torch.Tensor:
    """A parameter block in its stored layout (spec ``stored``) brought to
    the layout a computation wants (spec ``want``), dim by dim: gathered
    over the stored axes, then split over the wanted ones. A batch axis
    gathers with summed gradients and splits with zero-padded ones (the
    train step reduces those over the axis). The model axis follows
    ``model_replica``: True where every model rank then computes the same
    thing (gradients equal on each: gather takes the block, split gathers
    it), False where the model ranks compute on different tokens
    (gradients summed)."""
    for dim in range(t.dim()):
        have = axis_names(stored[dim]) if dim < len(stored) else ()
        need = axis_names(want[dim]) if dim < len(want) else ()
        if have == need:
            continue
        on_model = dist.model_axis in have + need
        summed = not (on_model and model_replica)
        if have:
            t = gather(t, dim, dist, have, sum_grad=summed)
        if need:
            t = split(t, dim, dist, need, gather_grad=not summed)
    return t


def stages_through_host(t: torch.Tensor) -> bool:
    """Whether a collective of ``t`` over the default group stages it
    through host memory (a CUDA tensor on gloo): such a collective syncs
    the stream with the host, so a CUDA graph cannot capture it."""
    return tdist.is_initialized() and _staged(t, None)


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Global rank ``src``'s ``t`` on every rank of the default group, in
    place (outside autograd): each rank passes a tensor of the same shape
    and dtype."""
    buf = t.detach()
    if _staged(buf, None):
        buf = _host("broadcast", buf)
    tdist.broadcast(buf, src)
    if buf is not t:
        t.copy_(buf)
    return t


def send(t: torch.Tensor, dst: int) -> None:
    """Point-to-point send to global rank ``dst`` (the pipeline's hand-off)."""
    src = t.detach().contiguous()
    if _staged(src, None):
        src = _host("send_recv", src)
    tdist.send(src, dst)


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """Receive a tensor shaped and typed like ``like`` from global rank
    ``src``, on ``like``'s device."""
    buf = torch.empty_like(like)
    if _staged(buf, None):
        buf = _host("send_recv", buf)
    tdist.recv(buf, src)
    return buf.to(like.device)
