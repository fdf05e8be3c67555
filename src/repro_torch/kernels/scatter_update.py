"""Row-scatter update, the device-residency delta flush.

Replaces the TPU kernel ``repro/kernels/scatter_update.py:scatter_rows``
with ``csrc/scatter_rows.cu``. The index tables live persistently on the
card; host mutations log their rows, and a flush writes
``table[rows[r]] = vals[r]`` in place, so a sync moves O(delta) bytes,
never a copy of the table.

Bound on the H100: bytes. A flush moves R rows of the table's row width
(read from the staged values, written into the table) plus the R row ids;
at the main path's R (8 to 64) that is a few to a hundred KB, so a launch
costs more than its bytes. The kernel views any table as raw bytes
(N, row_bytes) and copies the widest aligned word (up to 16 bytes) a
thread can, so one launch per table serves every dtype and width: fp32 or
int8 embeddings, scales, neighbor lists, flags, categories, timestamps.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def scatter_rows_plain(table: torch.Tensor, rows: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """The plain version: in-place index assignment. Returns ``table``."""
    table[rows.long()] = vals.to(table.dtype)
    return table


def _word_bytes(row_bytes: int, *ptrs: int) -> int:
    for w in (16, 8, 4, 2, 1):
        if row_bytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def scatter_rows(table: torch.Tensor, rows: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """In place: ``table[rows[r]] = vals[r]``. table (N, ...) of any dtype,
    rows (R,) int32 in [0, N) (rows outside are skipped on the card), vals
    (R, ...) of the table's dtype and row shape. Duplicate ids must carry
    identical rows. Returns ``table``; a CPU table takes the plain version."""
    if table.device.type == "cpu":
        return scatter_rows_plain(table, rows, vals)
    _build.require_cuda("scatter_rows", table, rows, vals)
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError("scatter_rows: rows must be (R,) int32")
    if vals.dtype != table.dtype or vals.shape != (rows.shape[0],) + table.shape[1:]:
        raise ValueError(f"scatter_rows: vals {tuple(vals.shape)} {vals.dtype} "
                         f"does not match table rows {tuple(table.shape[1:])} "
                         f"{table.dtype}")
    if table.dim() < 1 or table.shape[0] == 0:
        raise ValueError("scatter_rows: table must have at least one row")
    row_bytes = table[0].numel() * table.element_size()
    word = _word_bytes(row_bytes, table.data_ptr(), vals.data_ptr())
    err = _build.library().scatter_rows_launch(
        table.data_ptr(), rows.data_ptr(), vals.data_ptr(), table.shape[0],
        rows.shape[0], row_bytes, word, _build.stream(table.device))
    _build.check(err, "scatter_rows")
    scatter_rows.launches += 1
    return table


scatter_rows.launches = 0
