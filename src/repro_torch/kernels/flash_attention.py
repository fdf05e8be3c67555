"""Tiled GQA prefill attention: causal, sliding window, softcap, kv_offset.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
(``_flash_kernel``) with ``csrc/flash_attention.cu``. The model's prefill
(``models/attention.attend_prefill``) calls it through
``ops.flash_attention`` for every attention layer.

Bound on the H100: bytes at the serve shape (B=8, Hq=24, Hkv=8, S=64,
dh=128: ~0.2 GFLOP of causal work over ~8.4 MB of bf16 q, k, v and output,
~24 operations per byte, below the card's ~295), operations at long
prefills (S=4,096: ~103 GFLOP over ~67 MB), where the tensor cores' 989
TFLOP/s bf16 rate is the bound. This first kernel does its arithmetic in
fp32 FMA on the CUDA cores (the TPU kernel's fp32 softmax and fp32 P·V,
probabilities never rounded), so it cannot reach that rate; wgmma tiles
are later work. What the design does: one block owns 32 query rows of one
head, so a
staged KV tile serves 32 rows from shared memory; GQA costs nothing extra
(the block indexes KV head ``h // g``); whole tiles that causal or window
masks hide are never loaded, as the TPU kernel's ``pl.when(visible)``
skips them; and Sq and Skv edges are masked in the kernel, so nothing is
padded. It takes any strides with the head dimension contiguous, so the
model passes (B, S, H, dh) projections through transposed views.

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
    version; a CUDA q launches the kernel (fp32 or bf16, dh <= 256)."""
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
    err = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), B, Hq, Hkv, Sq, Skv, dh, int(causal),
        window or 0, kv_offset, scale if scale is not None else dh ** -0.5,
        softcap or 0.0, _DTYPES[q.dtype], _build.stream(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
