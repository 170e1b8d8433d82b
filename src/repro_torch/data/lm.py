"""Synthetic LM token pipeline: deterministic per (seed, shard, step).

Tokens for step s are a pure function of (seed, shard_id, s) -- restart at
any step reproduces the exact stream, which is what makes checkpoint/resume
bitwise reproducible (tested).  State is one integer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class LMDataPipeline:
    vocab: int
    batch: int            # per-shard batch
    seq_len: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    step: int = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.shard_id, self.step]))
        # markov-ish stream so the loss is learnable, not pure noise
        base = rng.integers(0, self.vocab, size=(self.batch, self.seq_len),
                            dtype=np.int32)
        drift = np.cumsum(rng.integers(0, 3, base.shape, dtype=np.int32) - 1,
                          axis=1)
        tokens = np.abs(base // 7 + drift) % self.vocab
        labels = np.roll(tokens, -1, axis=1).astype(np.int32)
        labels[:, -1] = -100
        self.step += 1
        return {"tokens": tokens.astype(np.int32), "labels": labels}

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed,
                "shard_id": self.shard_id, "num_shards": self.num_shards}

    def restore(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])
