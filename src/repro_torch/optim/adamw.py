"""AdamW from scratch, with optionally int8-blockwise-quantized moments.

The counterpart of ``repro.optim.adamw``. State layout per parameter
leaf, as in the reference:
    fp32  — m, v in fp32 (default; exact Adam)
    bf16  — m, v in bf16 (half-memory)
    int8  — m, v int8 with fp32 scales per 128-wide block of the last axis;
            m linear symmetric, v in the log2 domain with (lo, span) scales.
            Scalars and leaves whose last dim is not a multiple of 128 stay
            fp32.

Parameter trees are nested dicts and lists of tensors (the port's
``Model`` params keep one dict per layer); the moments mirror the tree
with a {"q", "s"} dict at each leaf. The reference returns new arrays;
here ``apply_adamw`` updates the parameters and the state IN PLACE under
``torch.no_grad()`` (``p.copy_(new.to(p.dtype))``) and returns only the
metrics, so nothing of the size of the model is allocated twice beyond
one leaf's temporaries. The arithmetic is the reference's, operation for
operation, in fp32 (the clip scale applied to the fp32 gradient, as
JAX's bf16 × fp32 promotion does), and ``torch.round`` rounds half to
even as ``jnp.round`` does.

Under a mesh the parameters are this rank's blocks (the training plan's
specs) and so are the moments: ``init_opt_state`` of the blocks is the
reference's ``opt_plan`` layout, the int8 block scales included, as long
as each block's last dim holds whole 128-wide blocks (where it does not,
the state cannot be quantized per rank and ``init_opt_state`` raises).
The update is elementwise, so it runs on the blocks as they are; the
clip's ``global_norm`` counts every element once: each leaf's local sum
of squares is reduced over the axes that leaf is sharded on, and over no
other (a norm scale replicated over ``model`` holds the same values on
every model rank and is counted once).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.context import axis_names
from repro_torch.models.convert import tree_leaves, tree_map, tree_zip

QBLOCK = 128
F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    state_dtype: str = "fp32"          # fp32 | bf16 | int8
    warmup_steps: int = 100
    schedule: str = "cosine"           # cosine | constant
    total_steps: int = 10000

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup, then cosine to 0.1 × lr (or constant); fp32."""
        s = torch.as_tensor(step).to(F32)
        warm = torch.clamp((s + 1.0) / max(1, self.warmup_steps), max=1.0)
        if self.schedule == "constant":
            return self.lr * warm
        frac = torch.clamp((s - self.warmup_steps)
                           / max(1, self.total_steps - self.warmup_steps), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return self.lr * warm * (0.1 + 0.9 * cos)


# -- int8 blockwise quantization -------------------------------------------------

_V_FLOOR = 1e-24


def _blocks(x: torch.Tensor) -> torch.Tensor:
    D = x.shape[-1]
    assert D % QBLOCK == 0, f"int8 state needs last dim % {QBLOCK} == 0, got {D}"
    return x.reshape(*x.shape[:-1], D // QBLOCK, QBLOCK)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (..., D) -> (int8 (..., D), fp32 scales (..., D/QBLOCK))."""
    xb = _blocks(x)
    scale = xb.abs().amax(dim=-1) / 127.0
    q = torch.round(xb / torch.clamp(scale[..., None], min=1e-12)).to(torch.int8)
    return q.reshape(x.shape), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (_blocks(q).to(F32) * scale[..., None]).reshape(q.shape)


def _quantize_log(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-negative fp32 -> int8 in the log2 domain, scales (..., blocks, 2)."""
    xb = torch.log2(_blocks(x) + _V_FLOOR)
    lo = xb.amin(dim=-1)
    span = torch.clamp(xb.amax(dim=-1) - lo, min=1e-6)
    q = torch.round((xb - lo[..., None]) / span[..., None] * 254.0 - 127.0)
    return q.to(torch.int8).reshape(x.shape), torch.stack([lo, span], dim=-1)


def _dequantize_log(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    qb = _blocks(q).to(F32)
    lo, span = scale[..., 0], scale[..., 1]
    x = torch.exp2(lo[..., None] + (qb + 127.0) / 254.0 * span[..., None])
    return torch.clamp(x - _V_FLOOR, min=0.0).reshape(q.shape)


# -- state -------------------------------------------------------------------------

def _moment_init(p: torch.Tensor, state_dtype: str, kind: str) -> dict:
    dev = p.device
    if state_dtype == "int8":
        D = p.shape[-1] if p.dim() else 0
        if p.dim() == 0 or D % QBLOCK:
            # scalars / norm vectors stay fp32 (tiny)
            return {"q": torch.zeros(p.shape, dtype=F32, device=dev), "s": None}
        blocks = (*p.shape[:-1], D // QBLOCK)
        if kind == "v":   # log domain: scales are (lo, span) pairs
            lo = torch.log2(torch.tensor(_V_FLOOR, dtype=F32))
            return {"q": torch.full(p.shape, -127, dtype=torch.int8, device=dev),
                    "s": torch.stack([torch.full(blocks, float(lo), dtype=F32, device=dev),
                                      torch.full(blocks, 1e-6, dtype=F32, device=dev)],
                                     dim=-1)}
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=dev),
                "s": torch.zeros(blocks, dtype=F32, device=dev)}
    dt = torch.bfloat16 if state_dtype == "bf16" else F32
    return {"q": torch.zeros(p.shape, dtype=dt, device=dev), "s": None}


def _is_log_scale(q: torch.Tensor, s: torch.Tensor) -> bool:
    return s.dim() == q.dim() + 1


def moment_read(mo: dict) -> torch.Tensor:
    """A moment leaf ({"q", "s"}) as fp32 (dequantized where int8)."""
    s = mo.get("s")
    if s is None:
        return mo["q"].to(F32)
    if _is_log_scale(mo["q"], s):
        return _dequantize_log(mo["q"], s)
    return _dequantize(mo["q"], s)


def _moment_write(mo: dict, val: torch.Tensor) -> None:
    """Store ``val`` (fp32) into the moment leaf in place."""
    s = mo.get("s")
    if s is None:
        mo["q"].copy_(val)
        return
    q, s_new = (_quantize_log if _is_log_scale(mo["q"], s) else _quantize)(val)
    mo["q"].copy_(q)
    s.copy_(s_new)


def init_opt_state(params, cfg: AdamWConfig, *, dist=None, specs=None) -> dict:
    """{"step": int32 scalar, "m", "v": moment trees shaped like params},
    on the params' device. Under a mesh (``dist``, ``specs`` the params'
    spec tree) the params are blocks, and int8 moments need whole 128-wide
    blocks in each."""
    dev = tree_leaves(params)[0].device
    if cfg.state_dtype == "int8" and dist is not None and dist.mesh is not None:
        for p, spec in zip(tree_leaves(params), tree_leaves(specs)):
            n = dist.axis_size(spec[-1]) if p.dim() and len(spec) == p.dim() else 1
            if p.dim() and (p.shape[-1] * n) % QBLOCK == 0 and p.shape[-1] % QBLOCK:
                raise ValueError(f"int8 moments: a block of last dim {p.shape[-1]} "
                                 f"(of {p.shape[-1] * n}) splits a {QBLOCK}-wide "
                                 f"quantization block")
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(lambda p: _moment_init(p, cfg.state_dtype, "m"), params),
            "v": tree_map(lambda p: _moment_init(p, cfg.state_dtype, "v"), params)}


def global_norm(tree, *, dist=None, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares.
    Under a mesh (``specs`` the blocks' spec tree) each leaf's local sum
    is reduced over the axes it is sharded on, one reduction per set of
    axes."""
    leaves = tree_leaves(tree)
    if dist is None or dist.mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(leaf.to(F32))) for leaf in leaves))
    by_axes: dict = {}
    for leaf, spec in zip(leaves, tree_leaves(specs)):
        axes = tuple(a for a in dist.mesh.mesh_dim_names
                     if any(a in axis_names(e) for e in spec))
        by_axes[axes] = by_axes.get(axes, 0.0) + torch.sum(torch.square(leaf.to(F32)))
    return torch.sqrt(sum(coll.all_reduce(part, dist, axes) if axes else part
                          for axes, part in sorted(by_axes.items())))


@torch.no_grad()
def apply_adamw(params, grads, state: dict, cfg: AdamWConfig, *, dist=None,
                specs=None) -> dict:
    """One AdamW step, IN PLACE: ``params`` and ``state`` are updated;
    ``grads`` is a tree like ``params`` (any float dtypes). Returns the
    metrics {"grad_norm", "lr"} as fp32 scalar tensors (no host sync).
    Under a mesh: blocks, ``specs`` their spec tree (``global_norm``)."""
    state["step"] += 1
    step = state["step"].to(F32)
    lr = cfg.lr_at(state["step"])
    gnorm = global_norm(grads, dist=dist, specs=specs)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    for p, g, mo, vo in tree_zip(params, grads, state["m"], state["v"]):
        g = g.to(F32)
        if scale is not None:
            g = g * scale
        m = cfg.b1 * moment_read(mo) + (1 - cfg.b1) * g
        v = cfg.b2 * moment_read(vo) + (1 - cfg.b2) * g * g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:                      # no decay on norms / biases
            upd = upd + cfg.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * upd).to(p.dtype))
        _moment_write(mo, m)
        _moment_write(vo, v)
    return {"grad_norm": gnorm, "lr": lr}
