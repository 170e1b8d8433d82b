"""Brute-force oracles for correctness tests (small graphs only).

The port's copy of the reference oracles.  ``count_kcliques_nx`` imports
``networkx`` only when it is called.
"""
from __future__ import annotations

from itertools import combinations
from typing import List, Tuple


from .graph import Graph


def count_kcliques_brute(g: Graph, k: int) -> int:
    return len(list_kcliques_brute(g, k))


def list_kcliques_brute(g: Graph, k: int) -> List[Tuple[int, ...]]:
    if k == 1:
        return [(v,) for v in range(g.n)]
    adj = [set(g.neighbors(v).tolist()) for v in range(g.n)]
    out = []
    for combo in combinations(range(g.n), k):
        ok = True
        for a, b in combinations(combo, 2):
            if b not in adj[a]:
                ok = False
                break
        if ok:
            out.append(combo)
    return out


def count_kcliques_nx(g: Graph, k: int) -> int:
    """networkx-based count (handles moderately larger graphs)."""
    import networkx as nx

    G = nx.Graph()
    G.add_nodes_from(range(g.n))
    G.add_edges_from(map(tuple, g.edges.tolist()))
    total = 0
    for c in nx.enumerate_all_cliques(G):
        if len(c) == k:
            total += 1
        elif len(c) > k:
            break
    return total
