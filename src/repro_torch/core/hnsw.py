"""HNSW and flat cache indexes with a device-resident data plane (paper §5,
§5.3, §7.4), in PyTorch.

The counterpart of ``repro.core.hnsw``, held against it by the parity
tests. Two planes:

* **Host control plane** (numpy, as in the reference and drawing the same
  random numbers): hierarchical HNSW insertion, level assignment,
  neighbor wiring, tombstoning, entry-point maintenance, and an exact
  hierarchical host search.
* **Device data plane** (PyTorch on ``device``): a batched fixed-width
  beam search over the level-0 graph from a multi-entry start set. One
  hop is ``ops.frontier_hop`` (the fused CUDA kernel on the card), the
  entry set is scored by ``ops.hop_scores`` (the ``gather_scores``
  kernel), and the flat index scans with ``ops.cache_topk`` (the
  ``flat_topk`` kernel). Early exit is per query: a query is *done* once
  its best same-category score reaches its τ or its frontier stops
  changing, and a done query's lanes load no rows.

The reference's ``jax.lax.while_loop`` is a fixed loop of ``max_hops``
here, with no host sync per hop: ``hops`` counts on the device while any
query is live (``done`` only grows, so the count matches), and frozen
lanes gather nothing, so ``rows_gathered`` matches too. Where the
reference jits each search, the port captures it: on the card every
search (``FlatIndex.search_classified``, ``HNSWIndex.search_batch`` and
``search_classified``) is one CUDA graph per batch bucket, dropped on a
full upload (``core/graphs.py``), fed from one packed input buffer and
writing one packed int32 word buffer of results; on the CPU the same
program runs eagerly. ``beam_search`` and ``beam_search_classified``
stay plain functions (the yardstick of the captured programs). The reference's
``jax.lax.top_k`` puts the lower position first on ties, and the
fixpoint test compares positions, so the merge sorts stably
(``torch.sort(..., stable=True)``), never with ``torch.topk``.

**Device residency (delta synchronization).** The device tables are
persistent tensors on ``device``. Every host mutation logs its touched
rows; ``device_tables()`` writes the log into the tables in place with
``ops.scatter_flush`` (one ``scatter_rows`` kernel launch for every
table, from one packed upload, on the card), so a sync moves O(delta)
bytes. A full upload happens on first use and when the
dirty fraction exceeds the rebuild threshold. ``sync_stats`` counts
uploads, rows and bytes with the reference's formulas.

**Quantized residency.** With ``emb_dtype="int8"`` the device holds int8
rows plus a per-slot fp32 scale table that rides the same delta sync;
every kernel fuses the dequant into its dot (fp32 query, int8 row, score
× scale after the dot). The host keeps fp32 rows as the control plane.

**Entry points run on the card** unless the caller asks for the CPU:
``device=None`` resolves to ``"cuda"`` and raises when there is none.
``index_from_reference`` builds an index from a reference index's numpy
host state, so both packages search the same graph.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.graphs import CapturedProgram
from repro_torch.kernels import ops, ref

INVALID = -1
TOMBSTONE = ref.TOMBSTONE

# Lookup classification (paper Algorithm 1 lines 12-21), computed on the
# device inside the search so the cache's Python loop only touches actual
# hits (doc fetch) and expirations (evict):
CLS_MISS, CLS_EXPIRED, CLS_HIT = 0, 1, 2

# A device search's results travel as ONE packed int32 word buffer (the
# captured program's output, fp32 scores bit-cast so nothing is rounded),
# field after field: Bp words each, ``hops`` one word.
FLAT_RESULT = ("idx", "score", "cls", "cand")
BEAM_RESULT = ("idx", "score", "hops", "rows_gathered")
CLASSIFIED_RESULT = ("idx", "score", "cls", "cand", "hops", "rows_gathered")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card: resolve it to ``cuda`` and raise when there
    is no CUDA device, never carrying on on the CPU. Callers that want the
    CPU pass ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: repro_torch runs on "
                               "the card unless device='cpu' is passed")
        return torch.device("cuda")
    return torch.device(device)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host table (never a view of the numpy buffer,
    also on the CPU: the mirror must not alias the host tables)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _bucket_batch(n: int) -> int:
    """Pad serve batches to the next power of two (min 8): engine queue
    drains produce B = 1..max_batch, and bucketing keeps the device
    shapes (and the ``compilations`` counter) to O(log max_batch)."""
    return max(8, 1 << (max(1, n) - 1).bit_length())


def _pad_query_batch(queries: np.ndarray, thresholds, categories, ttls
                     ) -> tuple[int, int, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    """Bucket the batch dimension. Padding lanes get τ = -inf, so they
    are born *done*: beyond the one-time entry-set scoring every query
    pays at init, the frozen hop emits INVALID candidates for them."""
    q = np.atleast_2d(np.asarray(queries, np.float32))
    B = q.shape[0]
    Bp = _bucket_batch(B)
    qp = np.zeros((Bp, q.shape[1]), np.float32)
    qp[:B] = q
    taup = np.full(Bp, -np.inf, np.float32)
    taup[:B] = np.broadcast_to(np.asarray(thresholds, np.float32), (B,))
    qcp = np.full(Bp, -1, np.int32)
    if categories is not None:
        qcp[:B] = np.broadcast_to(np.asarray(categories, np.int32), (B,))
    tp = np.full(Bp, np.inf, np.float32)
    if ttls is not None:
        tp[:B] = np.broadcast_to(np.asarray(ttls, np.float32), (B,))
    return B, Bp, qp, taup, qcp, tp


def _pack_result(*parts: torch.Tensor) -> torch.Tensor:
    """A search's results (in a ``*_RESULT`` order) as one int32 word
    buffer: fp32 tensors bit-cast, the others converted."""
    return torch.cat([p.reshape(-1).view(torch.int32) if p.dtype == torch.float32
                      else p.reshape(-1).to(torch.int32) for p in parts])


def split_result(words, fields: tuple, Bp: int, B: int) -> dict:
    """Views of a packed search result (a device tensor, or its numpy copy
    on the host): each field's first B entries, scores as fp32, ``hops``
    a scalar."""
    f32 = torch.float32 if isinstance(words, torch.Tensor) else np.float32
    out, pos = {}, 0
    for name in fields:
        if name == "hops":
            out[name] = words[pos]
            pos += 1
            continue
        part = words[pos:pos + B]
        out[name] = part.view(f32) if name == "score" else part
        pos += Bp
    return out


def quantize_rows(vecs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization: ``q = round(v / s)`` with
    ``s = max|v| / 127`` — the layout of the quantized resident tier.
    Returns (int8 rows (B, d), fp32 scales (B,)). Zero rows get scale
    eps so the dequant ``q · s`` is exactly zero, never NaN."""
    vecs = np.atleast_2d(np.asarray(vecs, np.float32))
    scale = (np.max(np.abs(vecs), axis=1) / 127.0).astype(np.float32)
    scale = np.maximum(scale, np.float32(1e-12))
    q = np.clip(np.rint(vecs / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def _flush_device_tables(device_tables: dict | None,
                         host: dict[str, np.ndarray], dirty: set,
                         capacity: int, rebuild_threshold: float,
                         row_nbytes: int, emb_row_nbytes: int,
                         sync_stats: dict, device: torch.device) -> dict:
    """The delta-sync protocol, shared by FlatIndex and HNSWIndex: write
    the dirty-row log into the persistent tables in place (O(delta)
    bytes), or upload everything on first use / past
    ``rebuild_threshold`` (negative = always full, the benchmark
    contrast). ``emb_row_nbytes`` is the embedding payload per row (incl.
    the quant scale word), tracked separately."""
    if device_tables is None or len(dirty) > rebuild_threshold * capacity:
        device_tables = {k: _upload(v, device) for k, v in host.items()}
        sync_stats["full_uploads"] += 1
        sync_stats["rows_synced"] += capacity
        sync_stats["bytes_synced"] += capacity * row_nbytes
        sync_stats["emb_bytes_synced"] += capacity * emb_row_nbytes
    elif dirty:
        rows = np.fromiter(dirty, np.int64, len(dirty))
        rows.sort()
        # Bucket the row count (same power-of-two policy as the batch
        # dimension); padding repeats row 0 of the delta with identical
        # payload — a deterministic no-op.
        bucket = _bucket_batch(len(rows))
        rows = np.concatenate(
            [rows, np.full(bucket - len(rows), rows[0])]).astype(np.int32)
        # One upload (the row ids and every table's rows, packed) and one
        # launch for every resident table.
        packed = ops.pack_flush(rows, [host[k][rows] for k in host])
        ops.scatter_flush([device_tables[k] for k in host],
                          _upload(packed, device), len(rows))
        sync_stats["delta_updates"] += 1
        sync_stats["rows_synced"] += len(rows)
        sync_stats["bytes_synced"] += len(rows) * row_nbytes
        sync_stats["emb_bytes_synced"] += len(rows) * emb_row_nbytes
    return device_tables


def _batched_add(index, vecs: np.ndarray,
                 categories: np.ndarray | None) -> np.ndarray:
    """Shared add_batch body: normalize the batch, loop ``index.add``,
    return the (B,) assigned slot ids."""
    vecs = np.atleast_2d(np.asarray(vecs, np.float32))
    B = vecs.shape[0]
    cats = (np.full(B, -1, np.int32) if categories is None
            else np.broadcast_to(np.asarray(categories, np.int32), (B,)))
    slots = np.empty(B, np.int32)
    for i in range(B):
        slots[i] = index.add(vecs[i], category=int(cats[i]))
    return slots


# ---------------------------------------------------------------------------
# Shared device-residency protocol.
# ---------------------------------------------------------------------------

class DeviceResidentIndex:
    """Device-residency + search-observability protocol shared by
    ``FlatIndex`` and ``HNSWIndex``: the version counter, dirty-row log,
    persistent device tables with in-place delta flush
    (``_flush_device_tables``), sync accounting, the embedding-tier dtype
    (fp32 / int8 with per-slot scales), the captured search programs
    (``programs``), and the searches/compilations/last-search counters.
    A subclass provides ``_host_tables()``,
    ``_row_nbytes()``, ``_rebuild_threshold()`` and (optionally)
    ``_finish_sync()`` for state that rides along on every sync (the HNSW
    entry set)."""

    def _init_residency(self, emb_dtype: str = "float32",
                        device: str | torch.device | None = None) -> None:
        if emb_dtype not in ("float32", "int8"):
            raise ValueError(f"emb_dtype must be 'float32' or 'int8', "
                             f"got {emb_dtype!r}")
        self.device = resolve_device(device)
        self.emb_dtype = emb_dtype
        if self.quantized:
            # The quantized resident tier: what the device actually holds
            # and the delta sync actually moves. The fp32 ``emb`` host
            # table remains the control plane and is never uploaded.
            self.emb_q = np.zeros((self.capacity, self.dim), np.int8)
            self.emb_scale = np.zeros((self.capacity,), np.float32)
        self._version = 0
        self._device: dict | None = None
        self._device_version = -1
        # Delta log: rows whose host tables changed since the last device
        # sync. A set — rows touched repeatedly coalesce to one row.
        self._dirty: set[int] = set()
        self.sync_stats = {"full_uploads": 0, "delta_updates": 0,
                           "rows_synced": 0, "bytes_synced": 0,
                           "emb_bytes_synced": 0}
        self.search_stats = {"searches": 0, "compilations": 0}
        self._compiled_keys: set = set()
        self.last_search: dict = {}
        # The device searches, one captured program per search signature
        # (a full upload replaces the storages and drops them).
        self.programs = CapturedProgram(self.device)

    @property
    def quantized(self) -> bool:
        return self.emb_dtype == "int8"

    def emb_row_nbytes(self) -> int:
        """Bytes the resident tier moves per embedding row: the row itself
        plus the fp32 dequant scale when quantized."""
        return self.dim + 4 if self.quantized else self.dim * 4

    def row_nbytes(self) -> int:
        """Bytes one full synced delta row moves (embedding tier + the
        subclass's graph/flag columns)."""
        return self._row_nbytes()

    def _emb_tables(self) -> dict[str, np.ndarray]:
        """The embedding tier as host tables: the fp32 rows, or the int8
        rows plus the per-slot scale table."""
        if self.quantized:
            return {"emb": self.emb_q, "scale": self.emb_scale}
        return {"emb": self.emb}

    def _quantize_slot(self, slot: int, vec: np.ndarray) -> None:
        """Keep the quantized mirror of one row in lockstep with the fp32
        write (callers already mark the row dirty)."""
        if self.quantized:
            q, s = quantize_rows(vec[None])
            self.emb_q[slot] = q[0]
            self.emb_scale[slot] = s[0]

    def export_rows(self, slots: np.ndarray) -> dict[str, np.ndarray]:
        """Copy the per-slot tables for ``slots`` out of the index (fp32
        rows, category/inserted metadata, and under int8 residency the
        quantized rows + scales). Does not touch the dirty log."""
        slots = np.asarray(slots, np.int64)
        out = {"emb": self.emb[slots].copy(),
               "category": self.category[slots].copy(),
               "inserted": self.inserted[slots].copy()}
        if self.quantized:
            out["emb_q"] = self.emb_q[slots].copy()
            out["scale"] = self.emb_scale[slots].copy()
        return out

    # -- subclass hooks --------------------------------------------------------
    def _host_tables(self) -> dict:
        raise NotImplementedError

    def _row_nbytes(self) -> int:
        raise NotImplementedError

    def _rebuild_threshold(self) -> float:
        raise NotImplementedError

    def _finish_sync(self, device_tables: dict) -> None:
        pass

    # -- the protocol ----------------------------------------------------------
    def device_tables(self) -> dict:
        """The persistent device tables, synced to the host state.

        No mutation since the last sync → returned as-is. Otherwise the
        dirty-row log is written into the tables in place (O(delta)
        bytes); a full upload happens only on first use or when the dirty
        fraction exceeds the rebuild threshold.
        """
        if self._device is not None and self._device_version == self._version:
            return self._device
        prev = self._device
        try:
            self._device = _flush_device_tables(
                self._device, self._host_tables(), self._dirty, self.capacity,
                self._rebuild_threshold(), self._row_nbytes(),
                self.emb_row_nbytes(), self.sync_stats, self.device)
        except BaseException:
            # A flush that dies mid-delta (device OOM, a refused launch)
            # may have written some tables and not others: the mirror can
            # no longer be trusted. Drop it so the retry rebuilds it from
            # the (authoritative, untouched) host tables with a full
            # upload; the dirty log is preserved unconsumed.
            self._device = None
            raise
        if self._device is not prev:
            # A full upload: new storages. Drop the graphs that read the
            # old ones (their programs hold them) before any is captured
            # anew; a delta flush writes in place and keeps them valid.
            self.programs.clear()
        self._finish_sync(self._device)
        self._dirty.clear()
        self._device_version = self._version
        return self._device

    def _search(self, B: int, Bp: int, key_extra: tuple, program, inputs: tuple,
                fields: tuple) -> dict:
        """Run one device search: ``program(*views of inputs)`` returns its
        packed result (``fields``). On the card it is the graph captured
        for this signature since the last full upload, replayed; on the CPU an
        eager call. The result is cloned (it outlives the next replay),
        counted, and kept in ``last_search``, whose views it returns."""
        key = (Bp,) + tuple(key_extra)
        words = self.programs.run(key, program, [np.asarray(a) for a in inputs]).clone()
        self._record_search(B, Bp, key, words, fields)
        return self.last_search

    def _record_search(self, B: int, Bp: int, key: tuple, words: torch.Tensor,
                       fields: tuple) -> None:
        """Count a device search: ``compilations`` is the number of
        distinct search signatures seen (padded batch + impl knobs), the
        reference's count of compiled programs; ``last_search`` keeps the
        packed result and its device views (hops, rows gathered) without
        a host sync."""
        st = self.search_stats
        st["searches"] += 1
        self._compiled_keys.add(key)
        st["compilations"] = len(self._compiled_keys)
        self.last_search = {"batch": B, "padded_batch": Bp, "words": words,
                            "fields": fields, **split_result(words, fields, Bp, B)}
        if "hops" not in fields:   # flat scan: the whole table streams per batch
            self.last_search.update(hops=0, rows_gathered=np.full(B, self.capacity,
                                                                  np.int64))
        self.last_search["gather_row_nbytes"] = self.emb_row_nbytes()

    def last_search_host(self) -> dict:
        """The last search's results on the host: ONE device→host copy of
        its packed words, no launch (hops and rows gathered of a flat scan
        are host values already)."""
        ls = self.last_search
        out = split_result(ls["words"].cpu().numpy(), ls["fields"],
                           ls["padded_batch"], ls["batch"])
        out.setdefault("hops", ls["hops"])
        out.setdefault("rows_gathered", ls["rows_gathered"])
        return out


# ---------------------------------------------------------------------------
# Flat (brute force) index — exact oracle + small-category fast path.
# ---------------------------------------------------------------------------

class FlatIndex(DeviceResidentIndex):
    """Exact cosine top-1 with threshold. O(n·d) per query batch; the
    device search is the ``flat_topk`` kernel (``ops.cache_topk``).

    Search is category-masked (§5.3): a slot only qualifies as a result
    for queries of the same category (query category < 0 = wildcard).
    """

    rebuild_threshold: float = 0.25     # delta-sync protocol (see HNSWParams)

    def __init__(self, dim: int, capacity: int, emb_dtype: str = "float32",
                 device: str | torch.device | None = None):
        self.dim = dim
        self.capacity = capacity
        self.emb = np.zeros((capacity, dim), dtype=np.float32)
        self.valid = np.zeros((capacity,), dtype=bool)
        self.category = np.full((capacity,), -1, dtype=np.int32)
        # Insertion timestamps (the cache's slot_inserted aliases this),
        # a device table like emb/valid/category, so TTL classification
        # runs inside the device search (Algorithm 1 line 18).
        self.inserted = np.zeros((capacity,), dtype=np.float32)
        self._n = 0
        self._free: list[int] = []
        self._init_residency(emb_dtype, device)

    def __len__(self) -> int:
        return int(self.valid.sum())

    def add(self, vec: np.ndarray, category: int = -1) -> int:
        slot = self._free.pop() if self._free else self._n
        if slot >= self.capacity:
            raise RuntimeError("FlatIndex full — evict before inserting")
        if slot == self._n:
            self._n += 1
        self.emb[slot] = vec
        self._quantize_slot(slot, np.asarray(vec, np.float32))
        self.valid[slot] = True
        self.category[slot] = category
        self._dirty.add(int(slot))
        self._version += 1
        return slot

    def add_batch(self, vecs: np.ndarray,
                  categories: np.ndarray | None = None) -> np.ndarray:
        """Multi-insert (same signature as HNSWIndex.add_batch).
        Returns the (B,) assigned slot ids."""
        return _batched_add(self, vecs, categories)

    def remove(self, slot: int) -> None:
        if self.valid[slot]:
            self.valid[slot] = False
            self.category[slot] = -1
            self._free.append(slot)
            self._dirty.add(int(slot))
            self._version += 1

    def search_host(self, queries: np.ndarray, thresholds: np.ndarray,
                    ef: int | None = None, *,
                    categories: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (idx, score) per query; idx = -1 below threshold.
        ``categories`` (B,) restricts each query's results to its own
        category (< 0 = no restriction)."""
        queries = np.atleast_2d(queries)
        if self._n == 0:
            B = queries.shape[0]
            return np.full(B, INVALID, np.int32), np.full(B, -np.inf, np.float32)
        sims = queries @ self.emb[:self._n].T                     # (B, n)
        sims = np.where(self.valid[None, :self._n], sims, -np.inf)
        if categories is not None:
            qc = np.asarray(categories, np.int32).reshape(-1, 1)  # (B, 1)
            allowed = (qc < 0) | (self.category[None, :self._n] == qc)
            sims = np.where(allowed, sims, -np.inf)
        idx = np.argmax(sims, axis=1)
        score = sims[np.arange(len(idx)), idx]
        # isfinite guard: with every slot masked out, argmax lands on an
        # arbitrary -inf slot, which a -inf threshold would accept.
        ok = (score >= thresholds) & np.isfinite(score)
        return (np.where(ok, idx, INVALID).astype(np.int32),
                score.astype(np.float32))

    # -- device path (ops.cache_topk over the resident tables) -----------------
    def _row_nbytes(self) -> int:
        """Bytes one synced delta row moves (emb [+ scale] + valid + cat +
        ts + id)."""
        return self.emb_row_nbytes() + 1 + 4 + 4 + 4

    def _host_tables(self) -> dict:
        return {**self._emb_tables(), "valid": self.valid,
                "category": self.category, "inserted": self.inserted}

    def _rebuild_threshold(self) -> float:
        return self.rebuild_threshold

    def search_batch(self, queries: np.ndarray, thresholds: np.ndarray, *,
                     categories: np.ndarray | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched device search (``ops.cache_topk``). Returns DEVICE
        tensors — convert once at the cache layer."""
        idx, score, _, _ = self.search_classified(queries, thresholds,
                                                  categories=categories)
        return idx, score

    def search_classified(self, queries: np.ndarray, thresholds: np.ndarray,
                          *, categories: np.ndarray | None = None,
                          ttls: np.ndarray | None = None, now: float = 0.0
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
        """Search + device TTL classification. Returns device (idx, score,
        cls, cand) with cls ∈ {CLS_MISS, CLS_EXPIRED, CLS_HIT} and ``cand``
        the best same-category candidate BEFORE thresholding (INVALID only
        when nothing matched at all), which the cache's fp32 re-rank tier
        re-scores near τ. Batches are bucketed to powers of two."""
        t = self.device_tables()
        B, Bp, qp, taup, qcp, tp = _pad_query_batch(
            queries, thresholds, categories, ttls)

        def program(q, tau, qc, ttl, now_t):
            return _pack_result(*_flat_search_classified(
                t["emb"], t["valid"], t["category"], t["inserted"], q, tau, qc,
                ttl, now_t, t.get("scale")))

        r = self._search(B, Bp, (), program, (qp, taup, qcp, tp, np.float32(now)),
                         FLAT_RESULT)
        return r["idx"], r["score"], r["cls"], r["cand"]


# ---------------------------------------------------------------------------
# Device-side batched beam search (plain PyTorch around the kernels).
# ---------------------------------------------------------------------------

def _classify(idx: torch.Tensor, score: torch.Tensor, inserted: torch.Tensor,
              ttls: torch.Tensor, now: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 lines 12-21 on the device: {miss, expired, hit} per
    query from the synced ``inserted`` table and the per-query TTLs. All
    fp32, like the reference: a float64 age would flip decisions at the
    TTL boundary."""
    found = idx != INVALID
    age = now - inserted[idx.clamp(min=0).long()]
    expired = found & (age > ttls)
    return torch.where(expired, CLS_EXPIRED,
                       torch.where(found, CLS_HIT, CLS_MISS)).to(torch.int8)


def _flat_search_classified(emb, valid, category, inserted, queries, taus,
                            qcat, ttls, now, scale=None):
    score, idx = ops.cache_topk(emb, valid, queries, category, qcat,
                                scales=scale)
    cand = torch.where(torch.isfinite(score), idx, INVALID).to(torch.int32)
    ok = (score >= taus) & torch.isfinite(score)
    idx = torch.where(ok, idx, INVALID).to(torch.int32)
    return idx, score, _classify(idx, score, inserted, ttls, now), cand


def _top_beam(scores: torch.Tensor, beam: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``beam`` per row, descending, with the LOWER position first
    among equal scores (``jax.lax.top_k``'s order): a stable descending
    sort. ``torch.topk`` promises no order for ties, and every dead lane
    ties at -inf."""
    s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :beam], pos[:, :beam]


def beam_search(emb: torch.Tensor,        # (cap, d) float32 or int8 rows
                neighbors: torch.Tensor,  # (cap, M0) int32, INVALID padded
                valid: torch.Tensor,      # (cap,) bool
                entries: torch.Tensor,    # (E,) int32 entry points
                queries: torch.Tensor,    # (B, d) float32, L2-normalized
                thresholds: torch.Tensor,  # (B,) float32 per-query τ
                slot_category: torch.Tensor | None = None,   # (cap,) int32
                query_category: torch.Tensor | None = None,  # (B,) int32
                scales: torch.Tensor | None = None,  # (cap,) f32: emb is int8
                *, beam: int = 32, max_hops: int = 12,
                hop_impl: str = "reference"):
    """Batched fixed-width beam search with per-query threshold early exit.

    Returns (best_idx (B,), best_score (B,), stats) with stats =
    ``{"hops": (), "rows_gathered": (B,), "cand": (B,)}``, all device
    tensors. best_idx is -1 where no valid same-category node reached the
    query's τ; ``stats["cand"]`` keeps the best same-category candidate
    regardless of τ (the cache's fp32 re-rank tier re-scores it).

    Tombstoned and cross-category nodes route traffic but are excluded
    from results; both masks travel as ONE per-slot ``meta`` word
    (category, or -2 for tombstones).

    ``hop_impl``: ``"reference"`` expands with plain PyTorch gathers (the
    reference's jnp path); ``"fused"`` calls ``ops.frontier_hop`` per hop
    and ``ops.hop_scores`` for the entry set — the CUDA kernels on the
    card, their plain versions on the CPU.

    A done query (τ reached, or its frontier reached a fixpoint) stops
    gathering: its hop lanes come back INVALID. ``rows_gathered`` counts
    the rows each query actually fetched (init + hops).
    """
    if hop_impl not in ("reference", "fused"):
        raise ValueError(f"hop_impl must be 'reference' or 'fused', "
                         f"got {hop_impl!r}")
    B = queries.shape[0]
    E = entries.shape[0]
    cap = emb.shape[0]
    dev = emb.device
    qcat = (torch.full((B,), -1, dtype=torch.int32, device=dev)
            if query_category is None else query_category.to(torch.int32))
    scat = (torch.full((cap,), -1, dtype=torch.int32, device=dev)
            if slot_category is None else slot_category.to(torch.int32))
    meta = torch.where(valid, scat, TOMBSTONE).to(torch.int32)
    fused = hop_impl == "fused"
    neg_inf = float("-inf")

    def score_nodes(idx):  # idx (B, K) -> cosine scores (B, K)
        return ref.gather_scores_ref(emb, idx, queries, scales)

    def res_mask(idx, scores):  # -inf at non-results (tombstone/category)
        m = meta[idx.clamp(min=0).long()]
        ok = (idx != INVALID) & (m != TOMBSTONE) & \
            ((qcat[:, None] < 0) | (m == qcat[:, None]))
        return scores.masked_fill(~ok, neg_inf)

    def expand(f_idx, done):
        """One hop: (B, F) frontier -> (B, F·M) candidate (ids, routing
        scores, result scores). Done queries emit INVALID / -inf lanes."""
        if fused:
            return ops.frontier_hop(emb, neighbors, meta, f_idx, queries,
                                    qcat, done.to(torch.int32), scales)
        nbr = neighbors[f_idx.clamp(min=0).long()]
        dead = (f_idx == INVALID)[:, :, None] | done[:, None, None]
        cand = torch.where(dead, INVALID, nbr).reshape(B, -1)
        route = score_nodes(cand)
        return cand, route, res_mask(cand, route)

    # Initial frontier: entry points (same for all queries), padded to beam.
    entries = entries.to(torch.int32)
    if E >= beam:
        f0 = entries[:beam]
    else:
        f0 = torch.cat([entries, torch.full((beam - E,), INVALID,
                                            dtype=torch.int32, device=dev)])
    f_idx = f0[None, :].expand(B, beam).contiguous()
    f_score = (ops.hop_scores(emb, f_idx, queries, scales=scales) if fused
               else score_nodes(f_idx))
    f_res = res_mask(f_idx, f_score)
    rows = (f_idx != INVALID).sum(dim=1, dtype=torch.int32)

    best_s = f_res.max(dim=1).values
    best_i = f_idx.gather(1, f_res.argmax(dim=1, keepdim=True))[:, 0]
    best_i = torch.where(torch.isfinite(best_s), best_i, INVALID)
    done = best_s >= thresholds
    hops = torch.zeros((), dtype=torch.int32, device=dev)

    # The reference's while_loop as a fixed loop: once every query is done
    # a hop changes nothing (frozen lanes gather nothing and keep their
    # frontier), and ``hops`` only counts hops that ran with a live query.
    for _ in range(max_hops):
        hops += (~done.all()).to(torch.int32)
        cand, c_route, c_res = expand(f_idx, done)
        rows += (cand != INVALID).sum(dim=1, dtype=torch.int32)

        # Merge frontier ∪ candidates, keep top-beam by raw routing score;
        # the result-masked scores ride along through the same positions.
        all_idx = torch.cat([f_idx, cand], dim=1)
        all_route = torch.cat([f_score, c_route], dim=1)
        all_res = torch.cat([f_res, c_res], dim=1)
        top_s, top_pos = _top_beam(all_route, beam)
        top_i = all_idx.gather(1, top_pos)
        top_r = all_res.gather(1, top_pos)

        # Result tracking only over valid same-category nodes — exactly
        # the lanes top_r left finite.
        hop_best_s = top_r.max(dim=1).values
        hop_best_i = top_i.gather(1, top_r.argmax(dim=1, keepdim=True))[:, 0]
        improved = hop_best_s > best_s + 1e-9
        best_s = torch.where(improved, hop_best_s, best_s)
        best_i = torch.where(improved, hop_best_i, best_i)

        # Early exit (§5.3): done once τ is reached, or once the merge
        # returns the previous frontier unchanged (a routing fixpoint).
        converged = (top_i == f_idx).all(dim=1)
        frozen = done[:, None]
        f_idx = torch.where(frozen, f_idx, top_i)
        f_score = torch.where(frozen, f_score, top_s)
        f_res = torch.where(frozen, f_res, top_r)
        done = done | (best_s >= thresholds) | converged

    hit = best_s >= thresholds
    return (torch.where(hit, best_i, INVALID), best_s,
            {"hops": hops, "rows_gathered": rows, "cand": best_i})


def beam_search_classified(emb, neighbors, valid, entries, inserted,
                           queries, thresholds, ttls, now,
                           slot_category=None, query_category=None,
                           scales=None, *,
                           beam: int = 32, max_hops: int = 12,
                           hop_impl: str = "reference"):
    """Algorithm 1 lines 9-21 on the device: masked beam search plus TTL
    classification against the synced ``inserted`` table. Returns (idx,
    score, cls, stats)."""
    idx, score, stats = beam_search(
        emb, neighbors, valid, entries, queries, thresholds,
        slot_category, query_category, scales,
        beam=beam, max_hops=max_hops, hop_impl=hop_impl)
    return idx, score, _classify(idx, score, inserted, ttls, now), stats


# ---------------------------------------------------------------------------
# HNSW proper.
# ---------------------------------------------------------------------------

@dataclass
class HNSWParams:
    M: int = 16                 # neighbors per node, upper levels
    M0: int = 32                # neighbors per node, level 0
    ef_construction: int = 64
    ef_search: int = 48         # host-search beam
    beam: int = 32              # device-search beam width F
    max_hops: int = 12          # device-search hop cap
    n_entries: int = 8          # device-search entry set size E
    # Delta-sync protocol: apply dirty rows in place until their fraction
    # of capacity exceeds this, then re-upload the full tables. Negative
    # forces a full upload on every sync (the O(capacity) contrast).
    rebuild_threshold: float = 0.25
    # Hop data plane: None = by the tables' device ("fused" on CUDA, the
    # kernels; "reference" on the CPU); "reference" | "fused" force one.
    hop_impl: str | None = None
    # Device-resident embedding dtype: "float32" (exact baseline) or
    # "int8" (per-slot symmetric scales; every kernel fuses the dequant).
    emb_dtype: str = "float32"


class HNSWIndex(DeviceResidentIndex):
    """Hierarchical build on host; batched beam search on the device.

    Fixed ``capacity``; slots are recycled through a freelist on removal
    (cache eviction). The device tables are persistent: mutations log
    their touched rows and ``device_tables()`` writes the log in place.
    """

    def __init__(self, dim: int, capacity: int, params: HNSWParams | None = None,
                 seed: int = 0, device: str | torch.device | None = None):
        self.dim = dim
        self.capacity = capacity
        self.p = params or HNSWParams()
        self.rng = np.random.default_rng(seed)
        self.ml = 1.0 / math.log(self.p.M)

        self.emb = np.zeros((capacity, dim), dtype=np.float32)
        self.valid = np.zeros((capacity,), dtype=bool)
        self.category = np.full((capacity,), -1, dtype=np.int32)
        # Insertion timestamps (the cache's slot_inserted aliases this).
        self.inserted = np.zeros((capacity,), dtype=np.float32)
        self.level = np.full((capacity,), -1, dtype=np.int8)
        # neighbors[0] is the device-visible level-0 graph.
        self.neighbors: list[np.ndarray] = [
            np.full((capacity, self.p.M0), INVALID, dtype=np.int32)
        ]
        self.entry_point: int = INVALID
        self.max_level: int = -1
        self._n = 0
        self._free: list[int] = []
        self._entries_cache: np.ndarray | None = None
        self._entries_version = -1
        self._init_residency(self.p.emb_dtype, device)

    # -- basic bookkeeping ---------------------------------------------------
    def __len__(self) -> int:
        return int(self.valid.sum())

    def _alloc_slot(self) -> int:
        if self._free:
            return self._free.pop()
        if self._n >= self.capacity:
            raise RuntimeError("HNSWIndex full — evict before inserting")
        slot = self._n
        self._n += 1
        return slot

    def _ensure_level_arrays(self, level: int) -> None:
        while len(self.neighbors) <= level:
            self.neighbors.append(
                np.full((self.capacity, self.p.M), INVALID, dtype=np.int32))

    def _draw_level(self) -> int:
        return int(-math.log(max(self.rng.random(), 1e-12)) * self.ml)

    # -- host greedy search helpers -------------------------------------------
    def _greedy_descend(self, q: np.ndarray, entry: int, level: int) -> int:
        """Greedy 1-best descent at one level (used above the target level)."""
        cur = entry
        cur_sim = float(q @ self.emb[cur])
        improved = True
        nbrs = self.neighbors[level]
        while improved:
            improved = False
            nb = nbrs[cur]
            nb = nb[nb != INVALID]
            if nb.size == 0:
                break
            sims = self.emb[nb] @ q
            j = int(np.argmax(sims))
            if sims[j] > cur_sim:
                cur_sim = float(sims[j])
                cur = int(nb[j])
                improved = True
        return cur

    def _search_level(self, q: np.ndarray, entries: list[int], level: int,
                      ef: int) -> tuple[np.ndarray, np.ndarray]:
        """Best-first search at one level. Returns (ids, sims) sorted desc."""
        nbrs = self.neighbors[level]
        visited = set(entries)
        cand_ids = list(entries)
        cand_sims = list(self.emb[entries] @ q)
        # results kept as parallel arrays, pruned to ef
        res_ids = list(cand_ids)
        res_sims = list(cand_sims)
        while cand_ids:
            j = int(np.argmax(cand_sims))
            c_sim = cand_sims.pop(j)
            c = cand_ids.pop(j)
            worst = min(res_sims) if len(res_sims) >= ef else -np.inf
            if c_sim < worst:
                break
            nb = nbrs[c]
            nb = nb[nb != INVALID]
            nb = [int(x) for x in nb if int(x) not in visited]
            if not nb:
                continue
            visited.update(nb)
            sims = self.emb[nb] @ q
            for node, s in zip(nb, sims):
                if len(res_sims) < ef or s > min(res_sims):
                    res_ids.append(node)
                    res_sims.append(float(s))
                    cand_ids.append(node)
                    cand_sims.append(float(s))
                    if len(res_sims) > ef:
                        k = int(np.argmin(res_sims))
                        res_ids.pop(k)
                        res_sims.pop(k)
        order = np.argsort(res_sims)[::-1]
        return (np.asarray(res_ids, np.int32)[order],
                np.asarray(res_sims, np.float32)[order])

    # -- insertion -------------------------------------------------------------
    def add(self, vec: np.ndarray, category: int = -1) -> int:
        vec = np.asarray(vec, np.float32)
        slot = self._alloc_slot()
        self.emb[slot] = vec
        self._quantize_slot(slot, vec)
        self.valid[slot] = True
        self.category[slot] = category
        lvl = min(self._draw_level(), 8)
        self.level[slot] = lvl
        self._ensure_level_arrays(lvl)
        for l in range(len(self.neighbors)):
            self.neighbors[l][slot] = INVALID
        self._dirty.add(slot)

        if self.entry_point == INVALID:
            self.entry_point = slot
            self.max_level = lvl
            self._version += 1
            return slot

        cur = self.entry_point
        for l in range(self.max_level, lvl, -1):
            cur = self._greedy_descend(vec, cur, l)
        entries = [cur]
        for l in range(min(lvl, self.max_level), -1, -1):
            ids, _sims = self._search_level(vec, entries, l, self.p.ef_construction)
            m = self.p.M0 if l == 0 else self.p.M
            chosen = ids[:m]
            self.neighbors[l][slot, :len(chosen)] = chosen
            # bidirectional wiring with pruning to closest-m
            for nb in chosen:
                row = self.neighbors[l][nb]
                empty = np.where(row == INVALID)[0]
                if empty.size:
                    row[empty[0]] = slot
                else:
                    cand = np.concatenate([row, [slot]])
                    sims = self.emb[cand] @ self.emb[nb]
                    keep = cand[np.argsort(sims)[::-1][:m]]
                    self.neighbors[l][nb] = keep
            if l == 0:     # only the level-0 graph is device-visible
                self._dirty.update(int(nb) for nb in chosen)
            entries = list(ids[:1]) if len(ids) else entries

        if lvl > self.max_level:
            self.max_level = lvl
            self.entry_point = slot
        self._version += 1
        return slot

    def add_batch(self, vecs: np.ndarray,
                  categories: np.ndarray | None = None) -> np.ndarray:
        """Insert a batch of vectors. Returns the (B,) assigned slot ids.

        Graph wiring stays host-sequential (HNSW insertion is inherently
        so), but the whole batch's touched rows coalesce in the delta log,
        so the device pays ONE scatter flush on the next search instead of
        B full-table uploads.
        """
        return _batched_add(self, vecs, categories)

    def remove(self, slot: int) -> None:
        """Tombstone: stays routable until slot reuse, excluded from results."""
        if not self.valid[slot]:
            return
        self.valid[slot] = False
        self.category[slot] = -1
        self._free.append(slot)
        self._dirty.add(int(slot))
        if slot == self.entry_point:
            alive = np.where(self.valid)[0]
            if alive.size:
                lv = self.level[alive]
                best = alive[int(np.argmax(lv))]
                self.entry_point = int(best)
                self.max_level = int(self.level[best])
            else:
                self.entry_point = INVALID
                self.max_level = -1
        self._version += 1

    # -- host search (exact hierarchical; CPU latency benchmarks) --------------
    def search_host(self, queries: np.ndarray, thresholds: np.ndarray,
                    ef: int | None = None, *,
                    categories: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-query best match above threshold; -1 on miss.

        ``categories`` (B,) int32 masks result tracking by category (< 0 =
        wildcard): traversal stays category-blind — cross-category nodes
        route traffic exactly like tombstones do — but only same-category
        nodes can be returned, so a globally-nearer cross-category neighbor
        no longer shadows a valid same-category match (§5.3).
        """
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        thresholds = np.broadcast_to(np.asarray(thresholds, np.float32),
                                     (queries.shape[0],))
        if categories is not None:
            categories = np.broadcast_to(
                np.asarray(categories, np.int32), (queries.shape[0],))
        ef = ef or self.p.ef_search
        out_idx = np.full(queries.shape[0], INVALID, np.int32)
        out_sim = np.full(queries.shape[0], -np.inf, np.float32)
        if self.entry_point == INVALID:
            return out_idx, out_sim
        for i, q in enumerate(queries):
            entries = [self.entry_point]
            for l in range(self.max_level, 0, -1):
                # small-beam descent (more robust than 1-greedy on the
                # bulk-built pivot graphs; negligible cost on upper levels)
                ids_l, _ = self._search_level(q, entries, l, ef=16)
                entries = [int(x) for x in ids_l[:8]] or entries
            ids, sims = self._search_level(q, entries, 0, ef)
            ok = self.valid[ids]
            if categories is not None and categories[i] >= 0:
                ok &= self.category[ids] == categories[i]
            ids, sims = ids[ok], sims[ok]
            if len(ids) and sims[0] >= thresholds[i]:
                out_idx[i] = ids[0]
                out_sim[i] = sims[0]
            elif len(ids):
                out_sim[i] = sims[0]
        return out_idx, out_sim

    # -- device search ----------------------------------------------------------
    def entry_set(self) -> np.ndarray:
        """Multi-entry start set: entry point + highest-level live nodes.

        Cached on ``_version``: a delta flush re-derives this at most once
        per mutation batch, and selection is O(n) ``argpartition`` (top-E
        by level, order within the set is irrelevant to the beam), not a
        full argsort of all live nodes.
        """
        if self._entries_version == self._version and \
                self._entries_cache is not None:
            return self._entries_cache
        E = self.p.n_entries
        ents = np.full((E,), INVALID, np.int32)
        if self.entry_point != INVALID:
            alive = np.where(self.valid)[0]
            if alive.size > E:
                top = np.argpartition(self.level[alive], alive.size - E)[-E:]
                chosen = alive[top].astype(np.int32)
            else:
                chosen = alive.astype(np.int32)
            ents[:len(chosen)] = chosen
            if self.entry_point not in chosen:
                ents[0] = self.entry_point
        self._entries_cache = ents
        self._entries_version = self._version
        return ents

    def _row_nbytes(self) -> int:
        """Bytes one synced delta row moves (emb [+ scale] + nbrs + valid
        + cat + inserted-timestamp + id)."""
        return (self.emb_row_nbytes()
                + self.neighbors[0].itemsize * self.p.M0
                + self.valid.itemsize + self.category.itemsize
                + self.inserted.itemsize + 4)

    def _host_tables(self) -> dict:
        return {**self._emb_tables(), "neighbors": self.neighbors[0],
                "valid": self.valid, "category": self.category,
                "inserted": self.inserted}

    def _rebuild_threshold(self) -> float:
        return self.p.rebuild_threshold

    def _finish_sync(self, device_tables: dict) -> None:
        # The tiny entry set (E ints, INVALID-padded) rides along on every
        # sync, copied into one persistent buffer: a captured search reads
        # it in place, and only a full upload (a new table dict) makes a
        # new one.
        entries = self.entry_set()
        if "entries" in device_tables:
            device_tables["entries"].copy_(torch.from_numpy(entries))
        else:
            device_tables["entries"] = _upload(entries, self.device)
        self.sync_stats["bytes_synced"] += entries.nbytes

    def _resolve_hop_impl(self) -> str:
        impl = self.p.hop_impl
        if impl is None:
            impl = "fused" if self.device.type == "cuda" else "reference"
        return impl

    def search_batch(self, queries: np.ndarray, thresholds: np.ndarray, *,
                     categories: np.ndarray | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched device beam search over the resident tables; returns
        DEVICE (idx, score). Per-search hops/rows-gathered land in
        ``self.last_search`` as device tensors (no sync)."""
        t = self.device_tables()
        B, Bp, qp, taup, qcp, _ = _pad_query_batch(
            queries, thresholds, categories, None)
        impl, p = self._resolve_hop_impl(), self.p

        def program(q, tau, qc):
            idx, score, stats = beam_search(
                t["emb"], t["neighbors"], t["valid"], t["entries"], q, tau,
                t["category"], qc, t.get("scale"), beam=p.beam,
                max_hops=p.max_hops, hop_impl=impl)
            return _pack_result(idx, score, stats["hops"], stats["rows_gathered"])

        r = self._search(B, Bp, ("beam", p.beam, p.max_hops, impl), program,
                         (qp, taup, qcp), BEAM_RESULT)
        return r["idx"], r["score"]

    def search_classified(self, queries: np.ndarray, thresholds: np.ndarray,
                          *, categories: np.ndarray | None = None,
                          ttls: np.ndarray | None = None, now: float = 0.0
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
        """Beam search + device TTL classification (Algorithm 1 lines
        9-21): returns device (idx, score, cls, cand) with cls ∈
        {CLS_MISS, CLS_EXPIRED, CLS_HIT}; ``cand`` is the best
        same-category candidate BEFORE the τ test."""
        t = self.device_tables()
        B, Bp, qp, taup, qcp, tp = _pad_query_batch(
            queries, thresholds, categories, ttls)
        impl, p = self._resolve_hop_impl(), self.p

        def program(q, tau, qc, ttl, now_t):
            idx, score, cls, stats = beam_search_classified(
                t["emb"], t["neighbors"], t["valid"], t["entries"],
                t["inserted"], q, tau, ttl, now_t, t["category"], qc,
                t.get("scale"), beam=p.beam, max_hops=p.max_hops, hop_impl=impl)
            return _pack_result(idx, score, cls, stats["cand"], stats["hops"],
                                stats["rows_gathered"])

        r = self._search(B, Bp, ("classified", p.beam, p.max_hops, impl), program,
                         (qp, taup, qcp, tp, np.float32(now)), CLASSIFIED_RESULT)
        return r["idx"], r["score"], r["cls"], r["cand"]

    # -- bulk build (benchmarks) -------------------------------------------------
    @classmethod
    def bulk_build(cls, vecs: np.ndarray, capacity: int | None = None,
                   params: HNSWParams | None = None, seed: int = 0,
                   categories: np.ndarray | None = None,
                   device: str | torch.device | None = None) -> "HNSWIndex":
        """Pivot-clustered approximate build: O(n·√n·d), for large benchmark
        indexes where incremental insertion would dominate runtime.

        ``categories`` (n,) int32 assigns per-slot categories (the masked
        search input, §5.3); omitted → -1 (matched only by wildcard
        queries, i.e. category-blind search still works)."""
        n, dim = vecs.shape
        capacity = capacity or int(n * 1.25) + 8
        idx = cls(dim, capacity, params, seed, device=device)
        if categories is not None:
            idx.category[:n] = np.asarray(categories, np.int32)
        p = idx.p
        n_piv = max(1, int(math.sqrt(n) * 2))
        rng = np.random.default_rng(seed)
        piv = rng.choice(n, size=min(n_piv, n), replace=False)
        pivots = vecs[piv]
        sims_pv = vecs @ pivots.T                               # (n, P)
        assign = np.argmax(sims_pv, axis=1)
        # overlap: second-best pivot too, for boundary connectivity
        assign2 = np.argsort(-sims_pv, axis=1)[:, 1] if pivots.shape[0] > 1 \
            else assign
        idx.emb[:n] = vecs
        if idx.quantized:
            idx.emb_q[:n], idx.emb_scale[:n] = quantize_rows(vecs)
        idx.valid[:n] = True
        idx.level[:n] = 0
        idx._n = n
        piv_nodes = piv.astype(np.int64)      # pivots ARE real points
        for c in range(pivots.shape[0]):
            members = np.where((assign == c) | (assign2 == c))[0]
            if members.size <= 1:
                continue
            sims = vecs[members] @ vecs[members].T
            np.fill_diagonal(sims, -np.inf)
            k = min(p.M0 - 2, members.size - 1)   # leave room for hub edges
            nn = np.argpartition(-sims, k - 1, axis=1)[:, :k]
            idx.neighbors[0][members[:, None].repeat(k, 1),
                             np.arange(k)[None, :]] = members[nn]
            # hub edges: every member ↔ its pivot keeps the graph connected
            idx.neighbors[0][members, p.M0 - 1] = piv_nodes[c]
        # pivot-to-pivot kNN edges (level 0 + level 1) bridge clusters
        psims = pivots @ pivots.T
        np.fill_diagonal(psims, -np.inf)
        kp = min(p.M, piv_nodes.size - 1)
        idx._ensure_level_arrays(1)
        idx.level[piv_nodes] = 1
        if kp > 0:
            pnn = np.argpartition(-psims, kp - 1, axis=1)[:, :kp]
            for j, node in enumerate(piv_nodes):
                idx.neighbors[1][node, :kp] = piv_nodes[pnn[j]]
                idx.neighbors[0][node, p.M0 - kp - 1:p.M0 - 1] = \
                    piv_nodes[pnn[j][:kp]]
        idx.entry_point = int(piv_nodes[0])
        idx.max_level = 1
        # Every row was written above; log them all dirty. The first sync
        # is a full upload anyway (no device mirror exists yet), but a
        # build into a PRE-SYNCED index must not skip the delta log.
        idx._dirty.update(range(n))
        idx._version += 1
        return idx

# ---------------------------------------------------------------------------
# State carried across from a reference index.
# ---------------------------------------------------------------------------

def reference_state(index) -> dict:
    """The numpy host state of an index — of this package or of the
    reference, which keep the same attributes: the tables (``emb``,
    ``emb_q``/``emb_scale`` under int8, ``valid``, ``category``,
    ``inserted``; for HNSW every ``neighbors`` level and ``level``), the
    bookkeeping (``_n``, ``_free``, the dirty log) and, for HNSW,
    ``entry_point``, ``max_level``, the params and the level-draw RNG
    state. All arrays are copies."""
    st = {"dim": index.dim, "capacity": index.capacity,
          "emb_dtype": index.emb_dtype, "_n": int(index._n),
          "_free": [int(s) for s in index._free],
          "_dirty": sorted(int(s) for s in index._dirty)}
    for k in ("emb", "valid", "category", "inserted"):
        st[k] = np.array(getattr(index, k))
    if index.emb_dtype == "int8":
        st["emb_q"] = np.array(index.emb_q)
        st["emb_scale"] = np.array(index.emb_scale)
    if hasattr(index, "neighbors"):
        st["neighbors"] = [np.array(a) for a in index.neighbors]
        st["level"] = np.array(index.level)
        st["entry_point"] = int(index.entry_point)
        st["max_level"] = int(index.max_level)
        st["params"] = dataclasses.asdict(index.p)
        st["rng_state"] = index.rng.bit_generator.state
    return st


def _load_common(idx: DeviceResidentIndex, state: dict) -> None:
    for k in ("emb", "valid", "category", "inserted"):
        getattr(idx, k)[...] = state[k]
    if idx.quantized:
        idx.emb_q[...] = state["emb_q"]
        idx.emb_scale[...] = state["emb_scale"]
    idx._n = int(state["_n"])
    idx._free = [int(s) for s in state["_free"]]
    idx._dirty = {int(s) for s in state["_dirty"]}


def index_from_reference(state: dict, params: HNSWParams | None = None,
                         device: str | torch.device | None = None
                         ) -> HNSWIndex:
    """An ``HNSWIndex`` on ``device`` holding the graph of a reference
    index's host state (``reference_state``): both packages then search
    the same graph, and later insertions draw the same levels. ``params``
    defaults to the state's own; the device tables upload on first
    search."""
    p = params or HNSWParams(**state["params"])
    idx = HNSWIndex(state["dim"], state["capacity"], params=p, device=device)
    _load_common(idx, state)
    idx.neighbors = [np.array(a, np.int32) for a in state["neighbors"]]
    idx.level[...] = state["level"]
    idx.entry_point = int(state["entry_point"])
    idx.max_level = int(state["max_level"])
    idx.rng.bit_generator.state = state["rng_state"]
    idx._version += 1
    return idx


def flat_index_from_reference(state: dict,
                              device: str | torch.device | None = None
                              ) -> FlatIndex:
    """A ``FlatIndex`` on ``device`` holding a reference flat index's host
    state (``reference_state``)."""
    idx = FlatIndex(state["dim"], state["capacity"],
                    emb_dtype=state["emb_dtype"], device=device)
    _load_common(idx, state)
    idx._version += 1
    return idx
