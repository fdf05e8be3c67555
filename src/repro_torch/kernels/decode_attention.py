"""One-token GQA decode attention against a ragged KV cache.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:
decode_attention`` (``_decode_kernel``) with ``csrc/decode_attention.cu``.
The model's decode step (``models/attention.attend_decode``) calls it
through ``ops.decode_attention`` for every attention layer and token.

Bound on the H100: bytes. Each step reads every live K and V row once
(about 4 flops per byte), so at 3.35 TB/s a batch of 8 sequences at 32,768
positions (bf16, Hkv=8, dh=128) needs ~0.32 ms, and the serve shape (80
positions) is launch latency. The design: one block per (sequence, KV
head) takes all g query heads of the group, so a K/V row is read once per
group, not g times; rows are read as 16-byte words with several rows in
flight per warp; rows at or past ``kv_len[b]`` are never read (the TPU
kernel's ragged tile skip, at row granularity); the softmax is fp32 and
online. The kernel takes strides, so the model's (B, S, Hkv, dh) cache is
read through a (B, Hkv, S, dh) view with no transpose or copy per step.

Beyond the TPU kernel, a sliding ``window`` (gemma2's local layers, as the
reference's ``attend_decode`` masks it): sequence b sees rows
[max(0, kv_len[b] - window), kv_len[b]), and the row loop starts at that
lower bound, so rows before the window are never read either.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import _DTYPES, check_heads

decode_attention_plain = ref.decode_attention_ref
HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 3, 4, 8)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, softcap: float | None = None,
                     window: int | None = None, scale: float | None = None
                     ) -> torch.Tensor:
    """q (B, Hq, dh); k, v (B, Hkv, S, dh), any strides with dh contiguous
    and 16-byte aligned rows; kv_len (B,) int32 -> (B, Hq, dh) in q's dtype.
    ``window`` (None = none) keeps the last ``window`` rows before kv_len.
    A CPU q takes the plain version; a CUDA q launches the kernel (fp32 or
    bf16, dh in {64, 128, 256}, Hq / Hkv in {1, 2, 3, 4, 8})."""
    if window is not None and window <= 0:
        raise ValueError("decode_attention: window must be positive")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len=kv_len, softcap=softcap,
                                      window=window, scale=scale)
    check_heads("decode_attention", q, k, v)
    B, Hq, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError("decode_attention: k/v must be (B, Hkv, S, dh)")
    if dh not in HEAD_DIMS or Hq // Hkv not in GROUPS:
        raise ValueError(f"decode_attention: dh={dh} must be in {HEAD_DIMS} and "
                         f"Hq/Hkv={Hq // Hkv} in {GROUPS}")
    if kv_len.device != q.device or kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError("decode_attention: kv_len must be (B,) int32 on q's device")
    if softcap is not None and softcap <= 0:
        raise ValueError("decode_attention: softcap must be positive")
    vec = 16 // q.element_size()
    strides = [*q.stride()[:2], *k.stride()[:3], *v.stride()[:3]]
    if any(s % vec for s in strides) or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention: rows must be 16-byte aligned")
    kv_len = kv_len.contiguous()
    out = torch.empty((B, Hq, dh), dtype=q.dtype, device=q.device)
    arr = (ctypes.c_longlong * 10)(*strides, *out.stride()[:2])
    err = _build.library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        ctypes.addressof(arr), B, Hq, Hkv, S, dh,
        scale if scale is not None else dh ** -0.5, softcap or 0.0, window or 0,
        _DTYPES[q.dtype], _build.stream(q.device))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
