"""One-token GQA decode attention against a ragged KV cache, split-KV.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:
decode_attention`` (``_decode_kernel``) with ``csrc/decode_attention.cu``.
The model's decode step (``models/attention.attend_decode``) calls it
through ``ops.decode_attention`` for every attention layer and token.

Bound on the H100: bytes. Each step reads every live K and V row once
(about 4 flops per byte), so at 3.35 TB/s a batch of 8 sequences at 32,768
positions (bf16, Hkv=8, dh=128) needs ~0.32 ms, and the serve shape (80
positions) is launch latency. The design: a block per (sequence, KV head,
split) takes all g query heads of the group, so a K/V row is read once per
group, not g times; rows are read as 16-byte words with several rows in
flight per warp; rows at or past ``kv_len[b]`` are never read (the TPU
kernel's ragged tile skip, at row granularity); the softmax is fp32 and
online. The kernel takes strides, so the model's (B, S, Hkv, dh) cache is
read through a (B, Hkv, S, dh) view with no transpose or copy per step.

Split-KV: the rows of a sequence are cut into ``num_splits`` chunks of
``CHUNK`` rows, one block each, so a long sequence spreads over the card's
132 SMs instead of one block walking it alone. NS comes from static shapes
(``S``, ``window``), never from ``kv_len``, so the call syncs nothing to
the host and stays capturable in a CUDA graph. Each split writes a partial
(m, l, acc) to fp32 scratch and a second kernel merges them; with NS = 1
(the serve shape) the one pass writes the output directly.
``decode_attention_split_plain`` is that algorithm in PyTorch.

Beyond the TPU kernel, a sliding ``window`` (gemma2's local layers, as the
reference's ``attend_decode`` masks it): sequence b sees rows
[max(0, kv_len[b] - window), kv_len[b]), and the splits start at that
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
CHUNK = 1024            # rows per split


def num_splits(S: int, window: int | None, chunk: int) -> int:
    """NS: the splits that cover the most rows a sequence can show,
    min(S, window), in chunks of ``chunk`` rows (at least 1)."""
    span = S if window is None else min(S, window)
    return max(1, -(-span // chunk))


def split_bounds(kv_len: torch.Tensor, S: int, window: int | None, split: int,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows [lo, hi) of split ``split`` for each sequence: lo = first +
    split * chunk, hi = min(lo + chunk, kv_len), first = max(0, kv_len -
    window) with a window and 0 without; hi <= lo means no rows."""
    n = kv_len.to(torch.int64).clamp(0, S)
    first = torch.zeros_like(n) if window is None else (n - window).clamp(min=0)
    lo = first + split * chunk
    return lo, torch.minimum(lo + chunk, n)


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 kv_len: torch.Tensor, chunk: int, *,
                                 window: int | None = None,
                                 softcap: float | None = None,
                                 scale: float | None = None) -> torch.Tensor:
    """The split-KV kernel's algorithm in PyTorch: per split its partial
    (m, l, acc) over its rows, then the merge out = sum_c acc_c e^(m_c - m*)
    / max(sum_c l_c e^(m_c - m*), 1e-30) over the splits that hold rows.
    All fp32; the output takes q's dtype."""
    B, Hq, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else dh ** -0.5
    qf = q.to(torch.float32).reshape(B, Hkv, g, 1, dh)
    logits = (qf @ k.to(torch.float32)[:, :, None].transpose(-1, -2))[..., 0, :] * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)          # (B, Hkv, g, S)
    vf = v.to(torch.float32)[:, :, None]                         # (B, Hkv, 1, S, dh)
    pos = torch.arange(S, device=q.device)
    ms, ls, accs = [], [], []
    for c in range(num_splits(S, window, chunk)):
        lo, hi = split_bounds(kv_len.to(q.device), S, window, c, chunk)
        rows = ((pos >= lo[:, None]) & (pos < hi[:, None]))[:, None, None, :]
        m = logits.masked_fill(~rows, ref.NEG_INF).amax(-1)      # (B, Hkv, g)
        p = torch.where(rows, torch.exp(logits - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append((p[..., None, :] @ vf)[..., 0, :])          # (B, Hkv, g, dh)
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.where(l > 0, torch.exp(m - m.amax(0)), 0.0)
    out = (w[..., None] * acc).sum(0) / (w * l).sum(0).clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, softcap: float | None = None,
                     window: int | None = None, scale: float | None = None
                     ) -> torch.Tensor:
    """q (B, Hq, dh); k, v (B, Hkv, S, dh), any strides with dh contiguous
    and 16-byte aligned rows; kv_len (B,) int32 -> (B, Hq, dh) in q's dtype.
    ``window`` (None = none) keeps the last ``window`` rows before kv_len.
    A CPU q takes the plain version; a CUDA q launches the kernel (fp32 or
    bf16, dh in {64, 128, 256}, Hq / Hkv in {1, 2, 3, 4, 8})."""
    return _decode(q, k, v, kv_len, softcap=softcap, window=window, scale=scale,
                   chunk=CHUNK)


def _decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor,
            *, softcap: float | None, window: int | None, scale: float | None,
            chunk: int) -> torch.Tensor:
    """``decode_attention`` with the split size as an argument (the card's
    measurements of other sizes call it; the port calls it with CHUNK)."""
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
    ns = num_splits(S, window, chunk)
    part_acc = part_ml = None
    if ns > 1:
        part_acc = torch.empty((B, Hq, ns, dh), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, Hq, ns, 2), dtype=torch.float32, device=q.device)
    arr = (ctypes.c_longlong * 10)(*strides, *out.stride()[:2])
    err = _build.library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        ctypes.addressof(arr), B, Hq, Hkv, S, dh,
        scale if scale is not None else dh ** -0.5, softcap or 0.0, window or 0,
        chunk, ns, _DTYPES[q.dtype], _build.stream(q.device))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
