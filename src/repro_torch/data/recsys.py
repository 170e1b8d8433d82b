"""Synthetic CTR stream with a planted logistic ground truth (so DCN-v2
training has signal); deterministic + resumable like the other pipelines.

The port's copy of the reference pipeline: the same numpy calls in the
same order, so a seed and step give identical batches in both packages."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class RecsysPipeline:
    n_dense: int = 13
    n_sparse: int = 26
    vocab: int = 1000
    batch: int = 256
    bag: int = 1
    seed: int = 0
    step: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed + 999)
        self._w_dense = rng.normal(size=(self.n_dense,)).astype(np.float32)
        self._w_field = rng.normal(size=(self.n_sparse,)).astype(np.float32)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step]))
        dense = rng.normal(size=(self.batch, self.n_dense)).astype(np.float32)
        sparse = rng.integers(0, self.vocab,
                              size=(self.batch, self.n_sparse, self.bag),
                              dtype=np.int32)
        logit = dense @ self._w_dense + (
            (sparse[..., 0] % 7 - 3) * self._w_field).sum(-1) * 0.1
        labels = (rng.random(self.batch) < 1 /
                  (1 + np.exp(-logit))).astype(np.float32)
        self.step += 1
        return {"dense": dense, "sparse": sparse, "labels": labels}

    def state(self):
        return {"step": self.step, "seed": self.seed}

    def restore(self, state):
        self.step = int(state["step"])
