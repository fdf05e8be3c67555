"""Training data pipeline.

A verbatim copy of ``repro.data.pipeline`` (numpy only), so the port's
batches are bit-equal to the reference's; ``tests/test_torch_train.py``
holds them equal.

``SyntheticCorpus`` generates a deterministic token stream with real
statistical structure (a Zipfian unigram mixture over latent "topics", so
the loss actually goes down during the example training runs).

``PackedBatcher`` packs documents into fixed (batch, seq) blocks with
next-token labels, document-boundary loss masking, and an explicitly
checkpointable cursor: ``state_dict()`` round-trips through the training
checkpoint so a restarted job resumes mid-epoch exactly-once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class SyntheticCorpus:
    """Deterministic document stream: doc i is reproducible in isolation."""

    def __init__(self, vocab_size: int, n_topics: int = 32,
                 mean_len: int = 192, seed: int = 0):
        self.vocab_size = vocab_size
        self.n_topics = n_topics
        self.mean_len = mean_len
        self.seed = seed
        base = np.random.default_rng(seed)
        # Per-topic Zipfian unigram distributions over a topic vocabulary.
        self._topic_vocab = base.integers(
            2, vocab_size, size=(n_topics, max(64, vocab_size // 8)))
        ranks = np.arange(1, self._topic_vocab.shape[1] + 1, dtype=np.float64)
        p = ranks ** -1.1
        self._p = p / p.sum()

    def document(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 32) ^ idx)
        topic = int(rng.integers(0, self.n_topics))
        length = max(8, int(rng.poisson(self.mean_len)))
        words = rng.choice(self._topic_vocab.shape[1], size=length, p=self._p)
        toks = self._topic_vocab[topic][words]
        return np.concatenate([[1], toks]).astype(np.int32)   # BOS = 1


@dataclass
class BatcherState:
    doc_cursor: int = 0
    carry: list = None

    def to_dict(self) -> dict:
        return {"doc_cursor": self.doc_cursor,
                "carry": [] if self.carry is None else list(map(int, self.carry))}

    @classmethod
    def from_dict(cls, d: dict) -> "BatcherState":
        return cls(doc_cursor=int(d["doc_cursor"]),
                   carry=list(d.get("carry") or []))


class PackedBatcher:
    """Packs documents into (batch, seq+1) blocks → tokens/labels pairs.

    Labels are next-token; positions crossing a document boundary into a
    new document keep training (BOS separates docs); trailing padding is
    masked with −1.
    """

    def __init__(self, corpus: SyntheticCorpus, batch: int, seq: int,
                 state: BatcherState | None = None):
        self.corpus = corpus
        self.batch = batch
        self.seq = seq
        self.state = state or BatcherState(carry=[])

    def state_dict(self) -> dict:
        return self.state.to_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = BatcherState.from_dict(d)

    def _fill(self, n_tokens: int) -> np.ndarray:
        buf = list(self.state.carry or [])
        cur = self.state.doc_cursor
        while len(buf) < n_tokens:
            buf.extend(self.corpus.document(cur).tolist())
            cur += 1
        self.state.doc_cursor = cur
        self.state.carry = buf[n_tokens:]
        return np.asarray(buf[:n_tokens], np.int32)

    def next_batch(self) -> dict:
        need = self.batch * (self.seq + 1)
        flat = self._fill(need).reshape(self.batch, self.seq + 1)
        return {"tokens": flat[:, :-1].copy(),
                "labels": flat[:, 1:].astype(np.int32).copy()}
