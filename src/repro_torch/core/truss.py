"""Truss decomposition and the truss-based edge ordering (paper Section 4.2).

The ordering pi_tau iteratively removes the edge whose endpoints have the
minimum number of common neighbors (the edge *support*), appending it to the
order.  This is exactly truss decomposition peeling; the max support observed
at removal time is tau = k_max - 2, and Lemma 4.1 proves tau < delta.

Host implementation: bucket-queue peeling, O(m * delta) like the paper's.
The port keeps its own copy of the reference's numpy/python code, so the
peel order (and with it every tile) is identical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .graph import Graph, ragged_expand


@dataclasses.dataclass(frozen=True)
class TrussDecomposition:
    order: np.ndarray      # (m,) edge ids in removal order (= pi_tau)
    rank: np.ndarray       # (m,) rank[e] = position of edge e in pi_tau
    support0: np.ndarray   # (m,) initial supports (triangles per edge)
    peel_support: np.ndarray  # (m,) support at removal time (<= tau)
    trussness: np.ndarray  # (m,) classic trussness t(e); k_max = max+2
    tau: int               # max peel support == k_max - 2


def edge_supports(g: Graph) -> np.ndarray:
    """Initial support (number of triangles containing each edge).

    Vectorized: one ragged CSR expansion of the lower-degree endpoint's
    neighborhood per edge, membership-tested against the sorted canonical
    edge keys with a single ``searchsorted``.
    """
    if g.m == 0:
        return np.zeros(0, dtype=np.int64)
    deg = np.diff(g.indptr)
    u, v = g.edges[:, 0], g.edges[:, 1]
    a = np.where(deg[u] <= deg[v], u, v)
    b = np.where(deg[u] <= deg[v], v, u)
    counts = deg[a]
    owner, pos = ragged_expand(counts)
    idx = g.indptr[a][owner] + pos
    w = g.indices[idx]
    hit = g.has_edges(b[owner], w)
    return np.bincount(owner[hit], minlength=g.m).astype(np.int64)


def edge_subset_supports(g: Graph, eids: np.ndarray) -> np.ndarray:
    """Support (triangle count) for just the edges ``eids`` of ``g``.

    The localized half of :func:`edge_supports`: cost is bounded by the
    neighborhoods of the requested edges, not m -- this is what lets
    :mod:`repro_torch.delta` re-derive supports only for the edges an update
    batch touched.
    """
    eids = np.asarray(eids, dtype=np.int64)
    if eids.size == 0 or g.m == 0:
        return np.zeros(eids.size, dtype=np.int64)
    deg = np.diff(g.indptr)
    u, v = g.edges[eids, 0], g.edges[eids, 1]
    a = np.where(deg[u] <= deg[v], u, v)
    b = np.where(deg[u] <= deg[v], v, u)
    counts = deg[a]
    owner, pos = ragged_expand(counts)
    idx = g.indptr[a][owner] + pos
    w = g.indices[idx]
    hit = g.has_edges(b[owner], w) & (w != b[owner])
    return np.bincount(owner[hit], minlength=eids.size).astype(np.int64)


def truss_decomposition(g: Graph) -> TrussDecomposition:
    m = g.m
    if m == 0:
        z = np.zeros(0, dtype=np.int64)
        return TrussDecomposition(z, z, z, z, z, 0)
    sup0 = edge_supports(g)
    sup = sup0.copy()
    # mutable adjacency: vertex -> {neighbor: edge_id}
    adj: List[Dict[int, int]] = [dict() for _ in range(g.n)]
    for i in range(m):
        u, v = int(g.edges[i, 0]), int(g.edges[i, 1])
        adj[u][v] = i
        adj[v][u] = i
    maxsup = int(sup.max())
    bucket: List[List[int]] = [[] for _ in range(maxsup + 1)]
    for i in range(m):
        bucket[sup[i]].append(i)
    removed = np.zeros(m, dtype=bool)
    order = np.empty(m, dtype=np.int64)
    peel = np.empty(m, dtype=np.int64)
    trussness = np.empty(m, dtype=np.int64)
    cur = 0
    level = 0  # running max of min-support at removal -> tau
    cnt = 0
    while cnt < m:
        while cur <= maxsup and not bucket[cur]:
            cur += 1
        e = bucket[cur].pop()
        if removed[e] or sup[e] != cur:
            # stale entry (support changed since push)
            continue
        removed[e] = True
        level = max(level, cur)
        order[cnt] = e
        peel[cnt] = cur
        trussness[e] = level
        cnt += 1
        u, v = int(g.edges[e, 0]), int(g.edges[e, 1])
        del adj[u][v]
        del adj[v][u]
        a, b = (u, v) if len(adj[u]) <= len(adj[v]) else (v, u)
        bn = adj[b]
        for w, ea in list(adj[a].items()):
            eb = bn.get(w)
            if eb is None:
                continue
            for ee in (ea, eb):
                if not removed[ee]:
                    s = sup[ee] - 1
                    sup[ee] = s
                    bucket[s].append(ee)
                    if s < cur:
                        cur = s
    rank = np.empty(m, dtype=np.int64)
    rank[order] = np.arange(m)
    peel_by_edge = np.empty(m, dtype=np.int64)
    peel_by_edge[order] = peel
    return TrussDecomposition(order=order, rank=rank, support0=sup0,
                              peel_support=peel_by_edge,
                              trussness=trussness, tau=int(level))


def tau_delta_gap(g: Graph) -> Tuple[int, int]:
    """(tau, delta) pair; Lemma 4.1 asserts tau < delta on every graph."""
    from .graph import degeneracy_order
    td = truss_decomposition(g)
    _, delta = degeneracy_order(g)
    return td.tau, delta
