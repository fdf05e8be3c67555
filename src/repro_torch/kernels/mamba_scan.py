"""Mamba1 selective scan, the state carried over the whole sequence.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py:mamba_scan``
(``_mamba_kernel``) with ``csrc/mamba_scan.cu``. The port's Mamba block
(``models/mamba.mamba_mix``) calls it through ``ops.mamba_scan`` for every
Mamba layer of every prefill and decode step.

Bound on the H100: bytes. At the serve prefill shape (Bt = 8, L = 64,
Dm = 8192, N = 16) the call moves ~38 MB (x and dt in, y out, B and C, the
state out), ~11 µs, and takes 67 M ``exp``s, ~16 µs on the SFUs (16 a
clock per SM), which are the floor of a long scan; a decode step (L = 1)
is launch latency. The TPU kernel walks L over a sequential grid with
the state in VMEM; here one block of 128 threads owns 32 channels (N =
16; 64 for N = 8) of one sequence for the whole of L, each lane 4 state
elements of one channel in registers, so nothing of size (Bt, L, Dm, N)
is materialized (the reference's jnp path builds (B, L, Dm, N) fp32
``dA`` and ``dBx``). A step is one ``ex2`` of a pre-scaled A per state
element, an FMA for h and one for h·C, and a lane's partial of y goes to
shared memory, so the unrolled walk has no shuffle; chunks of 32 steps of
x, dt, B and C are staged in shared memory with the next chunk's loads in
flight, and y is summed from the partials and written as coalesced rows.
L = 1 takes a second kernel that stages nothing. y sums its N terms in
another order than the plain version (each lane's 4, then across lanes).

Beyond the TPU kernel: an optional initial state ``h0`` (the oracle has
it; a decode step needs it), and ``h_out``, which may be ``h0`` itself, so
decode updates a layer's state in the cache in place. The TPU wrapper's
padding of L with dt = 0 and its ``block_d``, ``block_l`` and
``interpret`` have no counterpart: the kernel takes any L ≥ 1 and any Dm.

Training goes through ``MambaScanFn``, a ``torch.autograd.Function``
whose forward is this wrapper and whose backward is autograd of the
plain sequential scan ``ref.mamba_scan_ref`` recomputed from the saved
inputs (the reference differentiates its jnp scan; it has no backward
kernel). It gives gradients for x, dt, A, B, C, D and h0, launches no
hand-written kernel and counts none. ``h_out`` is a decode-step path and
takes no part in it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import _DTYPES

mamba_scan_plain = ref.mamba_scan_ref
STATE_SIZES = (8, 16)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, D: torch.Tensor, h0: torch.Tensor | None = None, *,
               h_out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (Bt, L, Dm) fp32 or bf16; dt (Bt, L, Dm), A (Dm, N), B, C (Bt, L, N),
    D (Dm,) and h0 (Bt, Dm, N) fp32 -> (y (Bt, L, Dm) in x's dtype, h_final
    (Bt, Dm, N) fp32). ``h_out`` (may alias ``h0``) receives h_final in
    place and is returned. A CPU x takes the plain version; a CUDA x
    launches the kernel (contiguous tensors, A, B, C, h0 and h_out 16-byte
    aligned, N in {8, 16}, L ≥ 1)."""
    Bt, L, Dm = x.shape
    N = A.shape[1]
    if h_out is not None and (h_out.shape != (Bt, Dm, N) or h_out.dtype != torch.float32):
        raise ValueError("mamba_scan: h_out must be (Bt, Dm, N) fp32")
    if x.device.type == "cpu":
        y, h = mamba_scan_plain(x, dt, A, B, C, D, h0)
        return y, h if h_out is None else h_out.copy_(h)
    tensors = [x, dt, A, B, C, D] + [t for t in (h0, h_out) if t is not None]
    _build.require_cuda("mamba_scan", *tensors)
    if x.dtype not in _DTYPES or any(t.dtype != torch.float32 for t in tensors[1:]):
        raise ValueError("mamba_scan: x must be fp32 or bf16 and every other "
                         "tensor fp32")
    if N not in STATE_SIZES or L < 1:
        raise ValueError(f"mamba_scan: N={N} must be in {STATE_SIZES} and L={L} ≥ 1")
    if (dt.shape != x.shape or A.shape != (Dm, N) or B.shape != (Bt, L, N)
            or C.shape != B.shape or D.shape != (Dm,)
            or (h0 is not None and h0.shape != (Bt, Dm, N))):
        raise ValueError("mamba_scan: shapes must be x, dt (Bt, L, Dm); A (Dm, N); "
                         "B, C (Bt, L, N); D (Dm,); h0 (Bt, Dm, N)")
    if any(t.data_ptr() % 16 for t in (A, B, C, h0, h_out) if t is not None):
        raise ValueError("mamba_scan: A, B, C, h0 and h_out must be 16-byte aligned "
                         "(the kernel reads them as float4)")
    y = torch.empty_like(x)
    h = h_out if h_out is not None else torch.empty((Bt, Dm, N), dtype=torch.float32,
                                                    device=x.device)
    err = _build.library().mamba_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        Bt, L, Dm, N, _DTYPES[x.dtype], _build.stream(x.device))
    _build.check(err, "mamba_scan")
    _build.count(mamba_scan)
    return y, h


mamba_scan.launches = mamba_scan.recorded = 0


class MambaScanFn(torch.autograd.Function):
    """``mamba_scan`` under autograd -> (y, h_final): the forward launches
    the kernel (the plain version on a CPU tensor); the backward is
    ``torch.autograd.grad`` of ``ref.mamba_scan_ref`` recomputed from the
    saved inputs, for every input that needs one."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0):
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        return mamba_scan(x, dt, A, B, C, D, h0)

    @staticmethod
    def backward(ctx, dy, dh):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(saved, ctx.needs_input_grad)]
            y, h = ref.mamba_scan_ref(*ins)
            wrt = [t for t in ins if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad((y, h), wrt, (dy, dh), allow_unused=True))
        return tuple(next(got) if t is not None and t.requires_grad else None
                     for t in ins)
