"""Graph generators (offline substitutes for the paper's 19 SNAP graphs).

Generators are calibrated to the paper's regimes: power-law graphs have
tau/delta well below 1 (Table 1's social/web graphs), planted-clique graphs
approach tau ~ delta (the dense DB/CI/WE family).

The port's copy of the reference generators: the same numpy calls in the
same order, so one seed gives identical edge arrays in both packages, and
of its padded-batch builder for GNN training (``GraphBatcher``), whose
batches are byte-identical to the reference's for a seed and step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..core.graph import Graph, from_edges


def erdos_renyi(n: int, p: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(n, k=1)
    keep = rng.random(len(ii)) < p
    return from_edges(n, np.stack([ii[keep], jj[keep]], 1))


def powerlaw_graph(n: int, m_per_node: int, seed: int = 0) -> Graph:
    """Barabasi-Albert style preferential attachment (vectorized-ish)."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_per_node))
    repeated: list = []
    edges = []
    for v in range(m_per_node, n):
        ts = set()
        pool = repeated if repeated else targets
        while len(ts) < m_per_node:
            ts.add(int(pool[rng.integers(0, len(pool))]))
        for t in ts:
            edges.append((v, t))
            repeated.extend([v, t])
    return from_edges(n, np.asarray(edges, dtype=np.int64))


def rmat_graph(scale: int, edge_factor: int = 8, seed: int = 0,
               a=0.57, b=0.19, c=0.19) -> Graph:
    """RMAT / Graph500-style generator."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src_bit = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        dst_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    keep = src != dst
    return from_edges(n, np.stack([src[keep], dst[keep]], 1))


def planted_cliques(n: int, n_cliques: int, clique_size: int,
                    p_noise: float = 0.01, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(n_cliques):
        verts = rng.choice(n, size=clique_size, replace=False)
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                edges.append((verts[i], verts[j]))
    ii, jj = np.triu_indices(n, k=1)
    keep = rng.random(len(ii)) < p_noise
    edges.extend(zip(ii[keep].tolist(), jj[keep].tolist()))
    return from_edges(n, np.asarray(edges, dtype=np.int64))


@dataclasses.dataclass
class GraphBatcher:
    """Deterministic resumable batches of small graphs (molecule regime)."""
    n_nodes: int = 30
    n_edges: int = 64
    batch: int = 128
    d_feat: int = 16
    seed: int = 0
    step: int = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step]))
        B, N, E = self.batch, self.n_nodes, self.n_edges
        feats = rng.normal(size=(B * N, self.d_feat)).astype(np.float32)
        pos = rng.normal(size=(B * N, 3)).astype(np.float32)
        src = rng.integers(0, N, size=(B, E))
        dst = (src + 1 + rng.integers(0, N - 1, size=(B, E))) % N
        offset = (np.arange(B) * N)[:, None]
        edges = np.stack([(src + offset).reshape(-1),
                          (dst + offset).reshape(-1)], 0).astype(np.int32)
        graph_ids = np.repeat(np.arange(B, dtype=np.int32), N)
        # synthetic label: a smooth function of mean pairwise distance
        y = np.tanh(pos.reshape(B, N, 3).std(axis=(1, 2))).astype(np.float32)
        self.step += 1
        return {"nodes": feats, "pos": pos, "edges": edges,
                "edge_mask": np.ones(edges.shape[1], np.float32),
                "graph_ids": graph_ids, "labels": y}

    def state(self):
        return {"step": self.step, "seed": self.seed}

    def restore(self, state):
        self.step = int(state["step"])
