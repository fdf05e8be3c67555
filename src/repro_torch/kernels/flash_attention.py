"""Tiled GQA prefill attention: causal, sliding window, softcap, kv_offset.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
(``_flash_kernel``) with two CUDA kernels, chosen by the input type: bf16
goes to ``csrc/flash_attention_wgmma.cu`` on the tensor cores, fp32 to
``csrc/flash_attention.cu``, the exact path in fp32 FMA. The model's
prefill (``models/attention.attend_prefill``) calls it through
``ops.flash_attention`` for every attention layer.

Bound on the H100: bytes at the serve shape (B=8, Hq=24, Hkv=8, S=64,
dh=128: ~0.2 GFLOP of causal work over ~8.4 MB of bf16 q, k, v and output,
~24 operations per byte, below the card's ~295), operations at long
prefills (S=4,096: ~103 GFLOP over ~67 MB), where the tensor cores' 989
TFLOP/s bf16 rate is the bound. The bf16 kernel reaches for that rate:
wgmma for Q·Kᵀ and P·V, one warpgroup of 64 query rows a block, K/V
tiles of 64 keys copied asynchronously (cp.async) into the swizzled
layout wgmma reads, and the online softmax on the accumulator fragments
in registers (the kernel's source note says more). It rounds the
probabilities to bf16 before P·V, as the reference model's
``attend_prefill`` does, and ``l`` sums those rounded probabilities;
against the fp32 oracle it is within 2^-7·max(|got|, |want|) +
2^-7·(P·|V|) + 1e-5 (``ref.bf16_probability_tol``). The fp32 kernel
never rounds: one block owns 32 query rows of one head and does its
arithmetic in fp32 FMA, within 1e-5 of the oracle. Both skip the
whole tiles that causal or window masks hide, as the TPU kernel's
``pl.when(visible)`` does, mask the Sq and Skv edges in the kernel (so
nothing is padded), index KV head ``h // g`` (GQA costs nothing extra),
and take any strides with the head dimension contiguous, so the model
passes (B, S, H, dh) projections through transposed views.

Routing by dtype is a choice by input type, not a fallback: a CUDA tensor
launches one of the two kernels or raises. The CPU path is the fp32
oracle ``ref.attention_ref`` for both types.

One difference from the TPU wrapper: ``repro.kernels.ops.flash_attention``
pads Skv with zero keys, which non-causal calls then attend to; here the
edge is masked, so a key past Skv never takes probability mass.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

flash_attention_plain = ref.attention_ref
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_HEAD_DIMS = (64, 128, 256)


def check_heads(name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> None:
    """Device, dtype and layout checks shared by the attention kernels: one
    CUDA device, fp32 or bf16 for all three, head dimension contiguous."""
    dev = q.device
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA device "
                             f"(got {t.device} and {dev})")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name}: q, k, v must share fp32 or bf16 "
                             f"(got {q.dtype}, {t.dtype})")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    if q.shape[1] % k.shape[1] or k.shape != v.shape:
        raise ValueError(f"{name}: Hq must divide by Hkv and k, v must match")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, kv_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, dh); k, v (B, Hkv, Skv, dh) -> (B, Hq, Sq, dh) in q's
    dtype. Query i sits at position i + kv_offset. A CPU q takes the plain
    version; a CUDA q launches a kernel: bf16 the tensor-core kernel (dh in
    {64, 128, 256}, 16-byte aligned rows), fp32 the FMA kernel (dh <=
    256)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, kv_offset=kv_offset,
                                     scale=scale)
    check_heads("flash_attention", q, k, v)
    B, Hq, Sq, dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or dh > 256:
        raise ValueError("flash_attention: k/v must be (B, Hkv, Skv, dh), dh <= 256")
    if window is not None and window <= 0:
        raise ValueError("flash_attention: window must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError("flash_attention: softcap must be positive")
    out = torch.empty((B, Hq, Sq, dh), dtype=q.dtype, device=q.device)
    # element strides (batch, head, seq) of q, k, v, out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), B, Hq, Hkv, Sq, Skv, dh, int(causal),
            window or 0, kv_offset, scale if scale is not None else dh ** -0.5,
            softcap or 0.0)
    lib = _build.library()
    if q.dtype == torch.bfloat16:
        if dh not in WGMMA_HEAD_DIMS:
            raise ValueError(f"flash_attention: bf16 takes dh in {WGMMA_HEAD_DIMS}, "
                             f"not {dh}")
        if any(st % 8 for st in strides[:9]) or any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: bf16 rows must be 16-byte aligned")
        err = lib.flash_attention_wgmma_launch(*args, _build.stream(q.device))
    else:
        err = lib.flash_attention_launch(*args, _DTYPES[q.dtype], _build.stream(q.device))
    _build.check(err, "flash_attention")
    _build.count(flash_attention)
    return out


flash_attention.launches = flash_attention.recorded = 0
