"""Graph container and basic decompositions (host side).

The preprocessing phase of EBBkC (truss decomposition, degeneracy ordering,
greedy coloring) is O(delta*m) work with irregular data-dependent updates --
in a production deployment it runs on the host data pipeline (CPU), exactly
like the paper's C++ preprocessing, while the exponential enumeration phase
runs on the accelerator.  A vectorized torch truss variant lives in
``repro_torch.core.truss_torch`` for fully on-device pipelines.

This is the PyTorch port's own copy of the reference package's graph module
(same numpy code, so plans and tiles come out bit-for-bit identical).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected simple graph in canonical form.

    edges: (m, 2) int64, u < v, lexicographically sorted, unique.
    indptr/indices: CSR over both directions, neighbor lists sorted.
    """

    n: int
    edges: np.ndarray
    indptr: np.ndarray
    indices: np.ndarray

    @property
    def m(self) -> int:
        return int(self.edges.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def edge_keys(self) -> np.ndarray:
        """Canonical int64 key u*n+v (u<v) per edge, sorted ascending."""
        return self.edges[:, 0] * np.int64(self.n) + self.edges[:, 1]

    def has_edges(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Vectorized membership test for vertex pairs (any order)."""
        a = np.minimum(u, v).astype(np.int64)
        b = np.maximum(u, v).astype(np.int64)
        keys = a * np.int64(self.n) + b
        ek = self.edge_keys()
        pos = np.searchsorted(ek, keys)
        pos = np.clip(pos, 0, len(ek) - 1)
        return (ek[pos] == keys) & (a != b)

    def edge_ids(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Edge index for pairs known to be edges (canonical order enforced)."""
        a = np.minimum(u, v).astype(np.int64)
        b = np.maximum(u, v).astype(np.int64)
        keys = a * np.int64(self.n) + b
        return np.searchsorted(self.edge_keys(), keys)


def ragged_expand(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(owner, position-within-segment) index arrays for ragged segments.

    The bulk-CSR-expansion idiom shared by the tile pipeline and
    truss.edge_supports: one np.repeat/cumsum pass replaces a Python loop
    over segments.
    """
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    owner = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    seg = np.repeat(np.cumsum(counts) - counts, counts)
    pos = np.arange(total, dtype=np.int64) - seg
    return owner, pos


def from_edges(n: int, edges: Iterable[Tuple[int, int]] | np.ndarray) -> Graph:
    e = np.asarray(list(edges) if not isinstance(edges, np.ndarray) else edges,
                   dtype=np.int64).reshape(-1, 2)
    if e.size:
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        keep = lo != hi  # drop self loops
        lo, hi = lo[keep], hi[keep]
        keys = lo * np.int64(n) + hi
        keys = np.unique(keys)
        lo, hi = keys // n, keys % n
        e = np.stack([lo, hi], axis=1)
    else:
        e = np.zeros((0, 2), dtype=np.int64)
    # CSR over both directions
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(n=n, edges=e, indptr=indptr, indices=dst)


def _canon_keys(n: int, pairs, name: str) -> np.ndarray:
    """Canonical sorted-unique edge keys (u*n+v, u<v) for a pair batch.

    Self loops are dropped; endpoints outside ``[0, n)`` raise (an edge
    batch can never grow the vertex set -- delta plans key on ``n``).
    """
    if pairs is None:
        return np.zeros(0, dtype=np.int64)
    e = np.asarray(list(pairs) if not isinstance(pairs, np.ndarray)
                   else pairs, dtype=np.int64).reshape(-1, 2)
    if e.size == 0:
        return np.zeros(0, dtype=np.int64)
    if e.min() < 0 or e.max() >= n:
        raise ValueError(
            f"{name} batch references vertices outside [0, {n})")
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    keep = lo != hi
    return np.unique(lo[keep] * np.int64(n) + hi[keep])


def apply_edge_batch(g: Graph, insert=None, delete=None) -> Graph:
    """Functional edge mutation: a new canonical Graph, same vertex set.

    ``insert`` / ``delete`` are iterables (or arrays) of vertex pairs in
    any orientation.  Deletes are applied first, then inserts; inserting
    a present edge or deleting an absent one is a no-op, so the batch is
    idempotent.  A pair appearing in both is inserted (insert wins).
    This is the mutable-graph seam the incremental plan index
    (:mod:`repro_torch.delta`) maintains tiles over -- the returned graph is in
    the exact canonical form :func:`from_edges` produces, so plans built
    on it are byte-identical to from-scratch plans of the same edge set.
    """
    delk = _canon_keys(g.n, delete, "delete")
    insk = _canon_keys(g.n, insert, "insert")
    keys = g.edge_keys()
    if delk.size:
        keys = np.setdiff1d(keys, delk, assume_unique=True)
    if insk.size:
        keys = np.union1d(keys, insk)
    edges = np.stack([keys // np.int64(g.n), keys % np.int64(g.n)], axis=1)
    return from_edges(g.n, edges)


def degeneracy_order(g: Graph) -> Tuple[np.ndarray, int]:
    """Bucket peeling. Returns (order, delta): order[i] = i-th removed vertex.

    Every vertex has <= delta neighbors later in the order.
    """
    n = g.n
    deg = g.degrees().astype(np.int64).copy()
    maxdeg = int(deg.max()) if n else 0
    # bucket lists
    bucket_head = np.full(maxdeg + 2, -1, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    prv = np.full(n, -1, dtype=np.int64)
    for v in range(n):
        d = deg[v]
        nxt[v] = bucket_head[d]
        if bucket_head[d] != -1:
            prv[bucket_head[d]] = v
        bucket_head[d] = v
    removed = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    delta = 0
    cur = 0
    for i in range(n):
        while cur <= maxdeg and bucket_head[cur] == -1:
            cur += 1
        v = int(bucket_head[cur])
        delta = max(delta, cur)
        # pop v
        bucket_head[cur] = nxt[v]
        if nxt[v] != -1:
            prv[nxt[v]] = -1
        removed[v] = True
        order[i] = v
        for w in g.neighbors(v):
            if removed[w]:
                continue
            d = deg[w]
            # unlink w from bucket d
            if prv[w] != -1:
                nxt[prv[w]] = nxt[w]
            else:
                bucket_head[d] = nxt[w]
            if nxt[w] != -1:
                prv[nxt[w]] = prv[w]
            deg[w] = d - 1
            # push w to bucket d-1
            prv[w] = -1
            nxt[w] = bucket_head[d - 1]
            if bucket_head[d - 1] != -1:
                prv[bucket_head[d - 1]] = w
            bucket_head[d - 1] = w
            if d - 1 < cur:
                cur = d - 1
    return order, delta


def greedy_coloring(g: Graph, order: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, int]:
    """Greedy color in reverse degeneracy order -> <= delta+1 colors.

    Returns (colors starting at 1, num_colors). Paper Section 4.3.
    """
    if order is None:
        order, _ = degeneracy_order(g)
    colors = np.zeros(g.n, dtype=np.int64)
    for v in order[::-1]:
        used = set()
        for w in g.neighbors(int(v)):
            c = colors[w]
            if c:
                used.add(int(c))
        c = 1
        while c in used:
            c += 1
        colors[int(v)] = c
    return colors, int(colors.max()) if g.n else 0


def color_vertex_order(colors: np.ndarray) -> np.ndarray:
    """Non-increasing color, ties by vertex id. Returns order array."""
    n = len(colors)
    return np.lexsort((np.arange(n), -colors))


def max_clique_size(g: Graph, ub: Optional[int] = None) -> int:
    """omega via simple BB with greedy-color bound (small graphs / stats only)."""
    order, delta = degeneracy_order(g)
    colors, _ = greedy_coloring(g, order)
    adj = [set(g.neighbors(v).tolist()) for v in range(g.n)]
    best = 0
    rank = np.empty(g.n, dtype=np.int64)
    rank[order] = np.arange(g.n)

    def expand(cand, size):
        nonlocal best
        if size + len(cand) <= best:
            return
        # color bound
        cs = sorted({int(colors[v]) for v in cand}, reverse=True)
        if size + len(cs) <= best:
            return
        for i, v in enumerate(sorted(cand, key=lambda x: -colors[x])):
            if size + len(cand) - i <= best:
                return
            nc = [w for w in cand if w in adj[v] and rank[w] > rank[v]]
            if size + 1 > best:
                best = size + 1
            expand(nc, size + 1)

    for v in order:
        cand = [w for w in adj[int(v)] if rank[w] > rank[int(v)]]
        expand(cand, 1)
        if ub is not None and best >= ub:
            break
    return best
