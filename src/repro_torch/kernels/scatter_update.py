"""Row-scatter update, the device-residency delta flush.

Replaces the TPU kernel ``repro/kernels/scatter_update.py:scatter_rows``
with ``csrc/scatter_rows.cu``. The index tables live persistently on the
card; host mutations log their rows, and a flush writes
``table[rows[r]] = vals[r]`` in place, so a sync moves O(delta) bytes,
never a copy of the table.

Bound on the H100: bytes. A flush moves R rows of every table's row width
(read from the staged values, written into the table) plus the R row ids;
at the main path's R (8 to 64) that is a few to a few hundred KB, so a
launch costs more than its bytes. ``scatter_flush`` therefore writes every
resident table of a flush in one launch, from one packed buffer
(``pack_flush``: the row ids, then each table's staged rows, each segment
on a 16-byte boundary) that the caller uploads once. The kernel views any
table as raw bytes (N, row_bytes) and copies the widest aligned word (up
to 16 bytes) a thread can, so one launch serves every dtype and width:
fp32 or int8 embeddings, scales, neighbor lists, flags, categories,
timestamps. ``scatter_rows`` is the same kernel on one table.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_TABLES = 8      # descriptors the kernel takes by value


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


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _row_bytes(table: torch.Tensor) -> int:
    return table[0].numel() * table.element_size()


def flush_layout(row_bytes: Sequence[int], R: int) -> tuple[list[int], int]:
    """Byte offsets of each table's segment in a packed flush buffer of R
    rows, and the buffer's size: the (R,) int32 row ids at 0, then each
    table's R rows, every segment starting on a 16-byte boundary."""
    offsets, pos = [], _round16(4 * R)
    for rb in row_bytes:
        offsets.append(pos)
        pos = _round16(pos + R * rb)
    return offsets, pos


def pack_flush(rows: np.ndarray, vals: Sequence[np.ndarray]) -> np.ndarray:
    """The host side of a flush: one uint8 buffer holding ``rows`` (R,)
    int32 and each table's staged rows ``vals[i]`` (R, ...) as raw bytes,
    laid out by ``flush_layout``. Padding bytes are zero."""
    rows = np.ascontiguousarray(rows, np.int32)
    R = rows.shape[0]
    raw = [np.ascontiguousarray(v).reshape(R, -1).view(np.uint8) for v in vals]
    offsets, total = flush_layout([r.shape[1] for r in raw], R)
    packed = np.zeros(total, np.uint8)
    packed[:4 * R] = rows.view(np.uint8)
    for off, r in zip(offsets, raw):
        packed[off:off + r.size] = r.reshape(-1)
    return packed


def _segments(tables: Sequence[torch.Tensor], packed: torch.Tensor, R: int
              ) -> list[torch.Tensor]:
    """Each table's (R, ...) staged rows, as views of ``packed``."""
    offsets, total = flush_layout([_row_bytes(t) for t in tables], R)
    if packed.dtype != torch.uint8 or packed.dim() != 1 or packed.numel() < total:
        raise ValueError(f"scatter_flush: packed must be a uint8 buffer of at "
                         f"least {total} bytes")
    return [packed[off:off + R * _row_bytes(t)].view(t.dtype).view((R,) + t.shape[1:])
            for off, t in zip(offsets, tables)]


def scatter_flush_plain(tables: Sequence[torch.Tensor], packed: torch.Tensor,
                        R: int) -> None:
    """The plain version: per-table index assignment from views of
    ``packed``."""
    rows = packed[:4 * R].view(torch.int32).long()
    for table, vals in zip(tables, _segments(tables, packed, R)):
        table[rows] = vals


def _c_array(ctype, values: list):
    return (ctype * len(values))(*values)


def _launch(name: str, rows_ptr: int, R: int, tables: Sequence[torch.Tensor],
            srcs: Sequence[int]) -> None:
    """One launch over ``tables``: the kernel's descriptors travel as host
    arrays that the C entry copies into its by-value parameters."""
    rbs = [_row_bytes(t) for t in tables]
    words = [_word_bytes(rb, t.data_ptr(), s) for rb, t, s in zip(rbs, tables, srcs)]
    err = _build.library().scatter_rows_launch(
        rows_ptr, R, len(tables),
        _c_array(ctypes.c_void_p, [t.data_ptr() for t in tables]),
        _c_array(ctypes.c_void_p, list(srcs)),
        _c_array(ctypes.c_longlong, [t.shape[0] for t in tables]),
        _c_array(ctypes.c_longlong, rbs), _c_array(ctypes.c_int, words),
        _build.stream(tables[0].device))
    _build.check(err, name)


def _check_tables(name: str, tables: Sequence[torch.Tensor]) -> None:
    for t in tables:
        if t.dim() < 1 or t.shape[0] == 0:
            raise ValueError(f"{name}: every table must have at least one row")


def scatter_flush(tables: Sequence[torch.Tensor], packed: torch.Tensor,
                  R: int) -> None:
    """In place, for every table: ``table[rows[r]] = vals[r]``, the row ids
    and each table's staged rows read from ``packed`` (``pack_flush``'s
    layout, uploaded once). Up to ``MAX_TABLES`` tables (N_i, ...) of any
    dtype; rows outside [0, N_i) are skipped on the card; duplicate ids
    must carry identical rows. One kernel launch on the card; CPU tables
    take the plain version."""
    tables = list(tables)
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"scatter_flush: 1 to {MAX_TABLES} tables, got {len(tables)}")
    if packed.device.type == "cpu" and all(t.device.type == "cpu" for t in tables):
        scatter_flush_plain(tables, packed, R)
        return
    _build.require_cuda("scatter_flush", packed, *tables)
    _check_tables("scatter_flush", tables)
    segs = _segments(tables, packed, R)
    if packed.data_ptr() % 16:
        raise ValueError("scatter_flush: packed must be 16-byte aligned")
    if R > 0:
        _launch("scatter_flush", packed.data_ptr(), R, tables,
                [s.data_ptr() for s in segs])
        _build.count(scatter_flush)


scatter_flush.launches = scatter_flush.recorded = 0


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
    _check_tables("scatter_rows", [table])
    if rows.shape[0] > 0:
        _launch("scatter_rows", rows.data_ptr(), rows.shape[0], [table], [vals.data_ptr()])
        _build.count(scatter_rows)
    return table


scatter_rows.launches = scatter_rows.recorded = 0
