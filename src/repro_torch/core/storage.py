"""External document storage + the vector-DB baseline (paper §4, §5.1).

The hybrid architecture keeps only embeddings + metadata in memory and the
documents (request body, response body, timestamps) in an external store
accessed by primary key. Stores are pluggable:

    InMemoryStore      — dict-backed (tests, simulator)
    FileStore          — one file per doc + manifest (restart-durable)
    LatencyModelStore  — wraps any store and charges simulated latency on a
                         ``Clock`` (the 5 ms fetch of §4.4)
    FlakyStore         — wraps any store and injects scheduled transient
                         failures from a ``core.faults.FaultInjector``
    RetryingStore      — wraps any store with bounded retries, Clock-charged
                         deterministic exponential backoff and a per-call
                         latency budget; exhaustion raises ``StoreTimeout``
                         (the cache lookup path degrades it to a counted
                         served-from-model miss instead of a stall)
    VectorDBEmulator   — the *baseline the paper argues against*: coupled
                         remote search+storage. Charges 30 ms search on every
                         query (hit or miss), applies thresholds post-search,
                         collection-level config, server-side TTL checks that
                         waste a fetch on expired entries (§4.1–4.3).
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.clock import Clock, SimClock
from repro_torch.core.faults import FaultInjector, StoreTimeout, \
    TransientStoreError


@dataclass
class Document:
    """A cached (request, response) pair with timestamps (§5.1).

    ``embedding`` is the full-precision fp32 query embedding, stored
    NEXT TO the document — i.e. in the external tier, not the compact
    in-memory one. It is the ground truth for the cache's re-rank tier:
    when the device index holds quantized (int8) rows, borderline
    matches (|score − τ| ≤ margin) are exactly re-scored against this
    copy, so the resident tier can shrink 4x without moving hit/miss
    decisions at the threshold boundary.
    """

    doc_id: int
    request: str
    response: str
    created_at: float
    category: str = ""
    meta: dict = field(default_factory=dict)
    embedding: Any = None            # fp32 vector (np.ndarray or list)

    def embedding_array(self) -> np.ndarray | None:
        """The stored embedding as fp32 numpy (None if absent)."""
        if self.embedding is None:
            return None
        return np.asarray(self.embedding, np.float32)

    def to_json(self) -> str:
        emb = self.embedding
        if emb is not None:
            emb = np.asarray(emb, np.float32).tolist()
        return json.dumps({
            "doc_id": self.doc_id, "request": self.request,
            "response": self.response, "created_at": self.created_at,
            "category": self.category, "meta": self.meta,
            "embedding": emb,
        })

    @classmethod
    def from_json(cls, s: str) -> "Document":
        return cls(**json.loads(s))

    def nbytes(self) -> int:
        emb_bytes = 0 if self.embedding is None else 4 * len(self.embedding)
        return (len(self.request.encode()) + len(self.response.encode())
                + emb_bytes + 64)


class DocumentStore:
    """Primary-key document store interface."""

    def put(self, doc: Document) -> None:
        raise NotImplementedError

    def put_many(self, docs: list[Document]) -> None:
        """Batched write — ONE store pass for a whole insert batch.

        Default loops ``put``; stores with per-call round-trip cost
        (network, fsync) override this to amortize it.
        """
        for doc in docs:
            self.put(doc)

    def get(self, doc_id: int) -> Document | None:
        raise NotImplementedError

    def delete(self, doc_id: int) -> None:
        raise NotImplementedError

    def scan(self, category: str | None = None) -> list[Document]:
        """Bulk-iterate documents (optionally one category), ordered by
        doc_id for determinism. This is the RECOVERY path — outage
        rebalancing rebuilds a dead shard's resident set from its
        (separately durable) store — not the per-key hot path, so
        wrappers delegate it without per-op fault/latency accounting.
        """
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class InMemoryStore(DocumentStore):
    def __init__(self):
        self._docs: dict[int, Document] = {}

    def put(self, doc: Document) -> None:
        self._docs[doc.doc_id] = doc

    def put_many(self, docs: list[Document]) -> None:
        self._docs.update((d.doc_id, d) for d in docs)

    def get(self, doc_id: int) -> Document | None:
        return self._docs.get(doc_id)

    def delete(self, doc_id: int) -> None:
        self._docs.pop(doc_id, None)

    def scan(self, category: str | None = None) -> list[Document]:
        docs = sorted(self._docs.values(), key=lambda d: d.doc_id)
        if category is not None:
            docs = [d for d in docs if d.category == category]
        return docs

    def __len__(self) -> int:
        return len(self._docs)

    def total_bytes(self) -> int:
        return sum(d.nbytes() for d in self._docs.values())


class FileStore(DocumentStore):
    """One compressed file per document; atomic writes; restart-durable."""

    def __init__(self, root: str, compress: bool = True):
        self.root = root
        self.compress = compress
        os.makedirs(root, exist_ok=True)

    def _path(self, doc_id: int) -> str:
        return os.path.join(self.root, f"{doc_id:016x}.doc")

    def put(self, doc: Document) -> None:
        payload = doc.to_json().encode()
        if self.compress:
            payload = zlib.compress(payload, level=1)
        fd, tmp = tempfile.mkstemp(dir=self.root)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, self._path(doc.doc_id))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, doc_id: int) -> Document | None:
        path = self._path(doc_id)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            payload = f.read()
        if self.compress:
            payload = zlib.decompress(payload)
        return Document.from_json(payload.decode())

    def delete(self, doc_id: int) -> None:
        path = self._path(doc_id)
        if os.path.exists(path):
            os.unlink(path)

    def scan(self, category: str | None = None) -> list[Document]:
        ids = sorted(int(n[:-4], 16) for n in os.listdir(self.root)
                     if n.endswith(".doc"))
        docs = [d for d in (self.get(i) for i in ids) if d is not None]
        if category is not None:
            docs = [d for d in docs if d.category == category]
        return docs

    def __len__(self) -> int:
        return sum(1 for n in os.listdir(self.root) if n.endswith(".doc"))


class LatencyModelStore(DocumentStore):
    """Charges per-op latency on a simulated clock (paper's 5 ms fetch)."""

    def __init__(self, inner: DocumentStore, clock: Clock,
                 get_ms: float = 5.0, put_ms: float = 1.0, delete_ms: float = 0.5):
        self.inner = inner
        self.clock = clock
        self.get_ms = get_ms
        self.put_ms = put_ms
        self.delete_ms = delete_ms

    def put(self, doc: Document) -> None:
        self.clock.advance(self.put_ms / 1e3)   # span-ok: caller-owned span
        self.inner.put(doc)

    def put_many(self, docs: list[Document]) -> None:
        # one batched round trip, not one per document
        self.clock.advance(self.put_ms / 1e3)   # span-ok: caller-owned span
        self.inner.put_many(docs)

    def get(self, doc_id: int) -> Document | None:
        self.clock.advance(self.get_ms / 1e3)   # span-ok: caller-owned span
        return self.inner.get(doc_id)

    def delete(self, doc_id: int) -> None:
        self.clock.advance(self.delete_ms / 1e3)  # span-ok: caller-owned span
        self.inner.delete(doc_id)

    def scan(self, category: str | None = None) -> list[Document]:
        # one bulk round trip, not one per document
        self.clock.advance(self.get_ms / 1e3)   # span-ok: caller-owned span
        return self.inner.scan(category)

    def __len__(self) -> int:
        return len(self.inner)


class FlakyStore(DocumentStore):
    """Injects scheduled transient failures in front of any store.

    Every operation first consults the shared ``FaultInjector`` (which
    counts ops globally and raises ``TransientStoreError`` on scheduled
    indices), then delegates. With an inert injector the consult is a
    no-op and behavior is identical to the inner store — the
    empty-schedule baseline gate depends on that.
    """

    def __init__(self, inner: DocumentStore, faults: FaultInjector):
        self.inner = inner
        self.faults = faults

    def put(self, doc: Document) -> None:
        self.faults.store_op("put")
        self.inner.put(doc)

    def put_many(self, docs: list[Document]) -> None:
        # one batched round trip = one failure opportunity
        self.faults.store_op("put")
        self.inner.put_many(docs)

    def get(self, doc_id: int) -> Document | None:
        self.faults.store_op("get")
        return self.inner.get(doc_id)

    def delete(self, doc_id: int) -> None:
        self.faults.store_op("delete")
        self.inner.delete(doc_id)

    def scan(self, category: str | None = None) -> list[Document]:
        # recovery/bulk path: not indexed into the per-op fault schedule
        # (op indices name hot-path gets/puts, and a recovery scan racing
        # the schedule would make crash sweeps non-enumerable)
        return self.inner.scan(category)

    def __len__(self) -> int:
        return len(self.inner)


class RetryingStore(DocumentStore):
    """Bounded retries + deterministic Clock-charged backoff + a per-call
    latency budget over any store.

    A failed operation (``TransientStoreError`` from the inner store)
    retries up to ``retries`` times with exponential backoff
    ``backoff_ms · 2^attempt`` charged on the injected ``Clock`` — on a
    ``SimClock`` that is simulated latency, never a wall-clock sleep, so
    retry behavior is deterministic in tests and benchmarks. Retrying
    stops early once the CUMULATIVE backoff would exceed ``budget_ms``
    (the per-lookup latency budget: a cache hit that needs the external
    doc is only worth so much stall). Exhaustion — by retry count or by
    budget — raises ``StoreTimeout``; ``SemanticCache.lookup_batch``
    catches it on the hit path and degrades the lookup to a
    served-from-model miss with a ``store_timeouts`` counter, keeping
    the entry resident (the fault was transient, not data loss).

    ``stats`` counts retries/timeouts/backoff per op kind — all
    deterministic under a fixed schedule.
    """

    def __init__(self, inner: DocumentStore, clock: Clock | None = None,
                 retries: int = 3, backoff_ms: float = 1.0,
                 budget_ms: float = 50.0, obs=None):
        self.inner = inner
        self.clock = clock or SimClock()
        self.retries = int(retries)
        self.backoff_ms = float(backoff_ms)
        self.budget_ms = float(budget_ms)
        # Optional TraceRecorder: retries/timeouts land on the event
        # stream; the backoff charge itself is timed by whichever span
        # the caller has open (store_fetch / write / migration_copy).
        self.obs = obs
        self.stats = {"get_retries": 0, "put_retries": 0,
                      "delete_retries": 0, "get_timeouts": 0,
                      "put_timeouts": 0, "delete_timeouts": 0,
                      "backoff_ms_charged": 0.0}

    def _call(self, op: str, fn):
        spent = 0.0
        last: BaseException | None = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except TransientStoreError as e:
                last = e
                wait = self.backoff_ms * (2.0 ** attempt)
                if attempt >= self.retries or spent + wait > self.budget_ms:
                    break
                spent += wait
                self.stats[f"{op}_retries"] += 1
                self.stats["backoff_ms_charged"] += wait
                if self.obs is not None:
                    self.obs.event("store_retry", op=op, attempt=attempt,
                                   wait_ms=wait)
                self.clock.advance(wait / 1e3)  # span-ok: caller-owned span
        self.stats[f"{op}_timeouts"] += 1
        if self.obs is not None:
            self.obs.event("store_timeout_raised", op=op)
        raise StoreTimeout(op) from last

    def put(self, doc: Document) -> None:
        self._call("put", lambda: self.inner.put(doc))

    def put_many(self, docs: list[Document]) -> None:
        self._call("put", lambda: self.inner.put_many(docs))

    def get(self, doc_id: int) -> Document | None:
        return self._call("get", lambda: self.inner.get(doc_id))

    def delete(self, doc_id: int) -> None:
        self._call("delete", lambda: self.inner.delete(doc_id))

    def scan(self, category: str | None = None) -> list[Document]:
        return self.inner.scan(category)

    def __len__(self) -> int:
        return len(self.inner)


# ---------------------------------------------------------------------------
# Baseline: remote vector database (what the paper argues against).
# ---------------------------------------------------------------------------

class VectorDBEmulator:
    """Coupled remote search + storage with the paper's cost structure.

    Architectural constraints faithfully reproduced (§4):
      * every query pays ``search_ms`` network+server cost, hit or miss (§4.4)
      * ONE collection-level threshold; per-category thresholds are not
        supported (§4.2) — caller gets the raw top-1 and the collection
        threshold is applied post-search (§4.1)
      * TTL enforced server-side AFTER fetching the document, wasting the
        fetch on expired entries (§4.3)
    """

    def __init__(self, dim: int, capacity: int, clock: Clock | None = None,
                 collection_threshold: float = 0.85, collection_ttl: float = 3600.0,
                 search_ms: float = 30.0, fetch_ms: float = 5.0, insert_ms: float = 10.0,
                 device=None):
        from repro_torch.core.hnsw import FlatIndex  # exact search server-side
        self.index = FlatIndex(dim, capacity, device=device)
        self.docs: dict[int, Document] = {}
        self.slot_doc: dict[int, int] = {}
        self.created: dict[int, float] = {}
        self.clock = clock or SimClock()
        self.collection_threshold = collection_threshold
        self.collection_ttl = collection_ttl
        self.search_ms = search_ms
        self.fetch_ms = fetch_ms
        self.insert_ms = insert_ms
        self._next_doc = 0

    def __len__(self) -> int:
        return len(self.index)

    def query(self, emb: np.ndarray) -> Document | None:
        """Remote search → post-search threshold → fetch → server TTL check."""
        self.clock.advance(self.search_ms / 1e3)  # span-ok: untraced baseline
        idx, score = self.index.search_host(emb[None, :], np.array([-np.inf]))
        slot, score = int(idx[0]), float(score[0])
        if slot < 0 or score < self.collection_threshold:  # §4.1 post-search
            return None
        self.clock.advance(self.fetch_ms / 1e3)   # span-ok: untraced baseline
        doc_id = self.slot_doc[slot]
        if self.clock.now() - self.created[slot] > self.collection_ttl:  # §4.3
            self._evict(slot)
            return None
        return self.docs.get(doc_id)

    def insert(self, emb: np.ndarray, doc: Document) -> None:
        self.clock.advance(self.insert_ms / 1e3)  # span-ok: untraced baseline
        if len(self.index) >= self.index.capacity:
            oldest = min(self.created, key=self.created.get)
            self._evict(oldest)
        slot = self.index.add(emb)
        doc = Document(self._next_doc, doc.request, doc.response,
                       self.clock.now(), doc.category, doc.meta)
        self._next_doc += 1
        self.docs[doc.doc_id] = doc
        self.slot_doc[slot] = doc.doc_id
        self.created[slot] = doc.created_at

    def _evict(self, slot: int) -> None:
        self.index.remove(slot)
        doc_id = self.slot_doc.pop(slot, None)
        if doc_id is not None:
            self.docs.pop(doc_id, None)
        self.created.pop(slot, None)
