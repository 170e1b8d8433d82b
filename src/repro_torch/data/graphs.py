"""Graph generators (offline substitutes for the paper's 19 SNAP graphs).

Generators are calibrated to the paper's regimes: power-law graphs have
tau/delta well below 1 (Table 1's social/web graphs), planted-clique graphs
approach tau ~ delta (the dense DB/CI/WE family).

The port's copy of the reference generators: the same numpy calls in the
same order, so one seed gives identical edge arrays in both packages.  The
GNN batch generator (``GraphBatcher``) waits for the model slice.
"""
from __future__ import annotations

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
