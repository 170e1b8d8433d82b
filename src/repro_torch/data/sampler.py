"""GraphSAGE-style layered neighbor sampler (minibatch_lg shape).

Produces fixed-shape sampled blocks: seed nodes (batch,), then per hop a
padded (n_prev * fanout) frontier with masks -- ready for segment_sum
message passing on device.  Sampling runs on host CSR (the data-pipeline
tier of the system); deterministic per (seed, step).

The port's copy of the reference sampler: the same numpy calls in the
same order, so a seed and step give identical blocks in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from ..core.graph import Graph


@dataclasses.dataclass
class NeighborSampler:
    graph: Graph
    batch_nodes: int
    fanouts: Sequence[int]          # e.g. (15, 10)
    seed: int = 0
    step: int = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step]))
        g = self.graph
        seeds = rng.integers(0, g.n, size=self.batch_nodes).astype(np.int64)
        layers = [seeds]
        blocks = []
        frontier = seeds
        for fanout in self.fanouts:
            nbrs = np.zeros((len(frontier), fanout), dtype=np.int64)
            mask = np.zeros((len(frontier), fanout), dtype=np.float32)
            for i, v in enumerate(frontier):
                adj = g.indices[g.indptr[v]:g.indptr[v + 1]]
                if len(adj) == 0:
                    continue
                take = rng.choice(adj, size=fanout,
                                  replace=len(adj) < fanout)
                nbrs[i] = take
                mask[i] = 1.0
            blocks.append({"nbrs": nbrs, "mask": mask})
            frontier = nbrs.reshape(-1)
            layers.append(frontier)
        self.step += 1
        return {"seeds": seeds, "blocks": blocks}

    def state(self):
        return {"step": self.step, "seed": self.seed}

    def restore(self, state):
        self.step = int(state["step"])


def sampled_block_shapes(batch_nodes: int, fanouts: Sequence[int],
                         d_feat: int):
    """ShapeDtypeStruct-compatible shape dict for the dry-run input specs."""
    shapes = {"seed_feats": ((batch_nodes, d_feat), np.float32)}
    prev = batch_nodes
    for h, f in enumerate(fanouts):
        shapes[f"hop{h}_feats"] = ((prev * f, d_feat), np.float32)
        shapes[f"hop{h}_mask"] = ((prev * f,), np.float32)
        prev *= f
    return shapes
