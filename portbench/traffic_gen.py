"""The benchmark's traffic generator: a frozen copy, so that no change to
the program moves the yardstick.

Copied at commit 24d51c8 from ``src/repro_torch/core/workload.py``
(``CategorySpec``, ``WorkloadGenerator.generate`` and ``_draw_intent``'s
``uniform`` and ``zipf`` kinds) and ``src/repro_torch/core/embedding.py``
(``SyntheticCategorySpace``, ``_unit``), trimmed to what a traffic file
sets: content versions, the cost fields, and the bursty, drifting and
flash shapes are left out. What is kept computes what the original
computes, call for call on the random generator.

``make_traffic(mix, seed, n, vocab, prompt_len)`` turns a traffic file's
parameters into the requests a run offers: per request its category, its
calibrated 384-d embedding, its arrival time on the traffic's
own clock, and a prompt of ``prompt_len`` token ids drawn from the seed.
``fill_entries`` gives the paraphrases a warm mix puts into the cache in
set-up.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

EMBED_DIM = 384


def _unit(v: np.ndarray, axis: int = -1) -> np.ndarray:
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.maximum(n, 1e-12)


@dataclass
class SyntheticCategorySpace:
    """One category's intents: cluster centres on the unit sphere, and
    paraphrases ``centre + sigma * noise`` renormalised, a ``loose_frac``
    share of them at ``sigma * loose_mult``."""

    name: str
    n_centers: int
    sigma: float
    center_spread: float = 1.0
    loose_frac: float = 0.30
    loose_mult: float = 2.4
    dim: int = EMBED_DIM
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(zlib.crc32(self.name.encode()) ^ self.seed)
        anchor = _unit(rng.standard_normal(self.dim))
        raw = rng.standard_normal((self.n_centers, self.dim))
        w = self.center_spread * rng.uniform(0.85, 1.30, (self.n_centers, 1))
        mixed = w * raw + (1.0 - w) * anchor * np.sqrt(self.dim)
        self.centers = _unit(mixed).astype(np.float32)

    def _sigmas(self, n: int, rng: np.random.Generator) -> np.ndarray:
        loose = rng.random(n) < self.loose_frac
        return np.where(loose, self.sigma * self.loose_mult, self.sigma)

    def sample(self, intent_id: int, rng: np.random.Generator) -> np.ndarray:
        c = self.centers[intent_id % self.n_centers]
        sig = self._sigmas(1, rng)[0]
        noisy = c + sig * rng.standard_normal(self.dim).astype(np.float32)
        return _unit(noisy).astype(np.float32)

    def sample_batch(self, intent_ids: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        c = self.centers[np.asarray(intent_ids) % self.n_centers]
        sig = self._sigmas(c.shape[0], rng)[:, None].astype(np.float32)
        noisy = c + sig * rng.standard_normal(c.shape).astype(np.float32)
        return _unit(noisy).astype(np.float32)


@dataclass
class CategorySpec:
    name: str
    traffic_share: float
    pool_size: int
    zipf_alpha: float | None          # None: uniform repetition
    sigma: float = 0.10
    center_spread: float = 1.0
    loose_frac: float = 0.30
    loose_mult: float = 2.0
    seed: int = 0

    def make_space(self) -> SyntheticCategorySpace:
        return SyntheticCategorySpace(
            name=self.name, n_centers=self.pool_size, sigma=self.sigma,
            center_spread=self.center_spread, loose_frac=self.loose_frac,
            loose_mult=self.loose_mult, seed=self.seed)


@dataclass
class Traffic:
    """``n`` requests in arrival order."""

    categories: list[str]
    embeddings: np.ndarray            # (n, 384) float32, unit rows
    timestamps: np.ndarray            # (n,) float64 seconds on the traffic's clock
    prompts: np.ndarray               # (n, prompt_len) int32

    def __len__(self) -> int:
        return len(self.categories)


class WorkloadGenerator:
    """Requests across categories, exponential gaps at ``rate_per_s``."""

    def __init__(self, specs: list[CategorySpec], rate_per_s: float, seed):
        total = sum(s.traffic_share for s in specs)
        self.specs = [CategorySpec(**{**s.__dict__, "traffic_share": s.traffic_share / total})
                      for s in specs]
        self.rate_per_s = rate_per_s
        self.rng = np.random.default_rng(seed)
        self.spaces = {s.name: s.make_space() for s in self.specs}
        self._shares = np.array([s.traffic_share for s in self.specs])
        self._zipf_p: dict[str, np.ndarray] = {}

    def _zipf_probs(self, spec: CategorySpec) -> np.ndarray:
        if spec.name not in self._zipf_p:
            ranks = np.arange(1, spec.pool_size + 1, dtype=np.float64)
            p = ranks ** (-spec.zipf_alpha)
            self._zipf_p[spec.name] = p / p.sum()
        return self._zipf_p[spec.name]

    def _draw_intent(self, spec: CategorySpec) -> int:
        if spec.zipf_alpha is None:
            return int(self.rng.integers(0, spec.pool_size))
        return int(self.rng.choice(spec.pool_size, p=self._zipf_probs(spec)))

    def generate(self, n: int):
        cats, embs, stamps = [], [], []
        t = 0.0
        cat_idx = self.rng.choice(len(self.specs), size=n, p=self._shares)
        gaps = self.rng.exponential(1.0 / self.rate_per_s, size=n)
        for i in range(n):
            spec = self.specs[int(cat_idx[i])]
            t += float(gaps[i])
            intent = self._draw_intent(spec)
            cats.append(spec.name)
            embs.append(self.spaces[spec.name].sample(intent, self.rng))
            stamps.append(t)
        return cats, np.stack(embs), np.asarray(stamps)


def specs_of(mix: dict) -> list[CategorySpec]:
    return [CategorySpec(**c) for c in mix["categories"]]


def make_traffic(mix: dict, seed: int, n: int, vocab: int, prompt_len: int) -> Traffic:
    """The first ``n`` requests of the mix for ``seed`` (any whole number:
    it seeds numpy's streams [seed, 0] and [seed, 1])."""
    seed = int(seed) % (2 ** 63)
    gen = WorkloadGenerator(specs_of(mix), mix["rate_per_s"], [seed, 0])
    cats, embs, stamps = gen.generate(n)
    prng = np.random.default_rng([seed, 1])
    prompts = prng.integers(2, vocab, size=(n, prompt_len), dtype=np.int64).astype(np.int32)
    return Traffic(cats, embs.astype(np.float32), stamps, prompts)


def fill_entries(mix: dict, seed: int) -> tuple[list[str], np.ndarray]:
    """A warm mix's set-up fill (``"fill": "one_per_intent"``): one
    paraphrase of every intent of every category, category by category in
    the file's order, drawn from the seed; none for a cold mix."""
    if mix.get("fill") != "one_per_intent":
        return [], np.zeros((0, EMBED_DIM), np.float32)
    rng = np.random.default_rng([int(seed) % (2 ** 63), 2])
    cats, embs = [], []
    for spec in specs_of(mix):
        space = spec.make_space()
        embs.append(space.sample_batch(np.arange(spec.pool_size), rng))
        cats += [spec.name] * spec.pool_size
    return cats, np.concatenate(embs).astype(np.float32)
