"""The plain reference of the cache's decisions (paper Algorithm 1) over
an exact fp32 cosine search in numpy.

It keeps its own copy of what the cache should hold: every entry the
set-up fill and each served miss put in, with its category, embedding,
insertion time on the traffic's clock, the request that made it and the
response it stores, minus what a TTL expiry evicted. Doc ids are
numbered in insertion order from 0, as the cache numbers its documents.

``judge_batch`` takes one step's requests and what the cache answered
for each (hit or miss, the reason, the doc id and the score it read) and
judges each answer by what it says:

* a hit must name a live entry of its own category that has not expired,
  whose exact score is at least τ, and whose stored response is the text
  the engine answered with. Its *gap* is the larger of ``|s − s_exact|``
  (the score the cache read against the exact fp32 one) and ``τ −
  s_exact``; a hit on an entry that is not live, of another category or
  expired scores 1.0, and a text that differs counts as a mismatch;
* an expiry must have an expired entry of the category at or above τ to
  evict (else 1.0); the best such entry is evicted;
* a miss says nothing wrong: the index is approximate (HNSW), so a miss
  where the exact search holds a fresh entry at or above τ costs a model
  call and no wrong answer. It is counted as a *false miss*, beside.

The reference then takes the decisions as the cache made them: it
evicts what an expiry names and inserts every miss of the step, in
order, after the step's lookups, as ``insert_batch`` does.

``writeback`` judges the write-back exactly, recall aside: once the run
is over, what the cache holds as a lookup reads it (each live entry's
document and its row of the search's tables) must be, doc id by doc id,
what this reference holds: every entry present, none besides, and each
with its category, request, response, insertion time and embedding.

``scores="bfloat16"`` rounds both sides of every dot product to bf16
first (the products summed in fp32, as a bf16 tensor-core product does);
``decide`` then gives this reference's own decisions: the control of the
comparison, put in the cache's place.

Quota and capacity evictions are not modelled: a step that would need
one raises, so a mix that reaches a quota cannot pass unseen.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

WRONG = 1.0          # the gap of an answer no score can explain


def round_bf16(x: np.ndarray) -> np.ndarray:
    """fp32 values rounded to the nearest bf16 (ties to even), as fp32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bias = ((bits >> 16) & 1) + np.uint32(0x7FFF)
    return ((bits + bias) & np.uint32(0xFFFF0000)).view(np.float32)


class _Category:
    def __init__(self, dim: int):
        self.ids = np.zeros(0, np.int64)
        self.emb = np.zeros((0, dim), np.float32)
        self.n = 0

    def add(self, doc: int, emb: np.ndarray) -> None:
        if self.n == self.emb.shape[0]:
            cap = max(256, 2 * self.n)
            emb2 = np.zeros((cap, self.emb.shape[1]), np.float32)
            emb2[:self.n] = self.emb[:self.n]
            ids2 = np.zeros(cap, np.int64)
            ids2[:self.n] = self.ids[:self.n]
            self.emb, self.ids = emb2, ids2
        self.emb[self.n] = emb
        self.ids[self.n] = doc
        self.n += 1


class ReferenceCache:
    def __init__(self, policies: dict, capacity: int, dim: int = 384,
                 scores: str = "float32"):
        self.policies = policies              # name -> {"threshold", "ttl", "quota", ...}
        self.capacity = capacity
        self.dim = dim
        self.bf16 = scores == "bfloat16"
        self.cat: list[str] = []
        self.inserted: list[float] = []
        self.response: list[str] = []
        self.request: list[str] = []
        self.vec: list[np.ndarray] = []
        self.live = np.zeros(0, bool)
        self.n_live = 0
        self._cats: dict[str, _Category] = {}
        self._count: dict[str, int] = {}

    def insert(self, category: str, emb: np.ndarray, now: float, response: str,
               request: str = "") -> int:
        """Store one entry; its doc id, or -1 where policy keeps it out."""
        pol = self.policies[category]
        if not pol["allow_caching"] or pol["quota"] <= 0.0:
            return -1
        if self._count.get(category, 0) + 1 > max(1, int(pol["quota"] * self.capacity)) \
                or self.n_live + 1 > self.capacity:
            raise NotImplementedError(
                f"{category}: an insert past its quota or the capacity needs an "
                f"eviction by score, which the reference does not model")
        d = len(self.cat)
        self.cat.append(category)
        self.inserted.append(float(now))
        self.response.append(response)
        self.request.append(request)
        self.vec.append(np.asarray(emb, np.float32))
        if d >= self.live.shape[0]:
            self.live = np.concatenate([self.live, np.zeros(max(1024, d), bool)])
        self.live[d] = True
        self.n_live += 1
        self._count[category] = self._count.get(category, 0) + 1
        self._cats.setdefault(category, _Category(self.dim)).add(d, emb)
        return d

    def evict(self, d: int) -> None:
        if self.live[d]:
            self.live[d] = False
            self.n_live -= 1
            self._count[self.cat[d]] -= 1

    def expired(self, d: int, now: float) -> bool:
        return (now - self.inserted[d]) > self.policies[self.cat[d]]["ttl"]

    def _scores(self, q: np.ndarray, category: str) -> tuple[np.ndarray, np.ndarray]:
        """(doc ids, exact scores) of the category's live entries."""
        c = self._cats.get(category)
        if c is None or c.n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        ids, mat = c.ids[:c.n], c.emb[:c.n]
        if self.bf16:
            mat, q = round_bf16(mat), round_bf16(q)
        s = (mat @ np.asarray(q, np.float32)).astype(np.float64)
        keep = self.live[ids]
        return ids[keep], s[keep]

    # ---------------------------------------------------------- judging
    def decide(self, embs: np.ndarray, cats: list[str], now: float) -> list[dict]:
        """This reference's own decisions (exact search over its state, in
        its score precision), in the form ``judge_batch`` takes."""
        out = []
        for q, cat in zip(embs, cats):
            pol = self.policies[cat]
            if not pol["allow_caching"]:
                out.append(dict(hit=False, reason="compliance", doc_id=-1, score=-np.inf))
                continue
            ids, s = self._scores(q, cat)
            if ids.size == 0 or s.max() < np.float32(pol["threshold"]):
                out.append(dict(hit=False, reason="no_match", doc_id=-1,
                                score=float(s.max()) if ids.size else -np.inf))
                continue
            b = int(ids[np.argmax(s)])
            expired = self.expired(b, now)
            out.append(dict(hit=not expired, reason="expired" if expired else "hit",
                            doc_id=-1 if expired else b, score=float(s.max())))
        return out

    def judge_batch(self, embs: np.ndarray, cats: list[str], now: float,
                    decisions: list[dict], responses: list[str],
                    requests: list[str] | None = None) -> dict:
        """``decisions[i]``: {"hit", "reason", "doc_id", "score"} as the
        cache returned them; ``responses[i]`` the text the engine answered
        with (what the cache stores for a miss), ``requests[i]`` the
        request's text (what it stores beside). Returns each request's
        ``gap``, ``mismatch`` and ``false_miss`` (lists), and takes the
        step's decisions into the state."""
        gaps, mismatch, false_miss, evict, inserts = [], [], [], set(), []
        requests = requests if requests is not None else [""] * len(cats)
        for q, cat, dec, text, req in zip(embs, cats, decisions, responses, requests):
            pol = self.policies[cat]
            tau = float(np.float32(pol["threshold"]))
            ids, s = self._scores(q, cat)
            gap, bad_text, fm = 0.0, False, False
            if not pol["allow_caching"]:
                gap = 0.0 if (not dec["hit"] and dec["reason"] == "compliance") else WRONG
            elif dec["hit"]:
                d = dec["doc_id"]
                at = np.flatnonzero(ids == d)
                if at.size == 0 or self.expired(d, now):
                    gap = WRONG
                else:
                    s_d = float(s[at[0]])
                    gap = max(abs(float(dec["score"]) - s_d), tau - s_d)
                    bad_text = text != self.response[d]
            elif dec["reason"] == "expired":
                old = [(float(v), int(d)) for d, v in zip(ids, s)
                       if v >= tau and self.expired(int(d), now)]
                if old:
                    evict.add(max(old)[1])
                else:
                    gap = WRONG
            elif dec["reason"] == "no_match":
                fm = bool(ids.size) and float(s.max()) >= tau
            else:
                gap = WRONG
            gaps.append(gap)
            mismatch.append(bad_text)
            false_miss.append(fm)
            if not dec["hit"] and pol["allow_caching"]:
                inserts.append((cat, q, text, req))
        for d in evict:
            self.evict(d)
        for cat, q, text, req in inserts:
            self.insert(cat, q, now, text, req)
        return {"gap": gaps, "mismatch": mismatch, "false_miss": false_miss}

    def writeback(self, held: list[dict]) -> dict:
        """``held``: what the cache holds, one dict per live entry as a
        lookup reads it ({"doc_id", "category" of its row, "doc_category",
        "request", "response" of its document, None where the store has
        none, "inserted", "emb" of its row}). Counts
        this reference's live entries that are ``missing`` there, entries
        held ``beside`` them (or held twice), and entries held ``wrong``:
        any field unequal, the insertion time as the cache's float32
        table holds it, the embedding bit for bit."""
        want = {d for d in range(len(self.cat)) if self.live[d]}
        seen, beside, wrong = set(), 0, 0
        for h in held:
            d = h["doc_id"]
            if d not in want or d in seen:
                beside += 1
                continue
            seen.add(d)
            same = (h["category"] == self.cat[d] == h["doc_category"]
                    and h["request"] == self.request[d]
                    and h["response"] == self.response[d]
                    and np.float32(h["inserted"]) == np.float32(self.inserted[d])
                    and np.array_equal(np.asarray(h["emb"], np.float32), self.vec[d]))
            wrong += not same
        return {"missing": len(want - seen), "beside": beside, "wrong": wrong}
