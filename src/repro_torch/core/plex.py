"""Early-termination on dense branches (paper Section 5).

A branch graph g that is a t-plex (every vertex has at most t non-neighbors
including itself) can be finished without further BB branching:

* t <= 2: closed-form / combinatorial (kC2Plex, Alg. 6).  The vertex set
  partitions into F (universal vertices) and a perfect matching of
  non-adjacent pairs L+R.  An l-clique takes any c vertices from F and any
  j = l-c vertices from the p pairs, at most one per pair:

      count(l) = sum_c C(|F|, c) * C(p, l-c) * 2^(l-c)

  TPU adaptation: the whole ET becomes branch-free arithmetic.

* t >= 3: kCtPlex (Alg. 7) branches on the sparse inverse graph.  The
  count-only adaptation keeps its key ingredient -- factoring out the
  universal set I combinatorially -- and finishes the (small) non-universal
  remainder with the generic engine.

This slice ports the counting helpers the host engine needs; the listing
enumerators (``list_2plex``, ``list_tplex``) come with the listing slice.
"""
from __future__ import annotations

from math import comb
from typing import Sequence, Tuple

from .bitops import bits, popcount


def plexity(rows: Sequence[int], cand: int) -> Tuple[int, int]:
    """Return (nv, t) where the candidate-induced graph is a t-plex.

    t = nv - min_degree_within (counting the vertex itself as a non-neighbor).
    """
    nv = popcount(cand)
    if nv == 0:
        return 0, 0
    mind = min(popcount(rows[v] & cand) for v in bits(cand))
    return nv, nv - mind


def split_universal(rows: Sequence[int], cand: int) -> Tuple[int, int]:
    """(F, rest): F = vertices adjacent to all other cand vertices."""
    nv = popcount(cand)
    F = 0
    for v in bits(cand):
        if popcount(rows[v] & cand) == nv - 1:
            F |= 1 << v
    return F, cand & ~F


def count_2plex(f: int, p: int, l: int) -> int:
    """l-cliques in (f universal vertices) + (p disjoint non-adjacent pairs)."""
    total = 0
    for c in range(max(0, l - p), min(l, f) + 1):
        j = l - c
        total += comb(f, c) * comb(p, j) * (1 << j)
    return total


def count_in_2plex(rows: Sequence[int], cand: int, l: int) -> int:
    F, rest = split_universal(rows, cand)
    p, r = divmod(popcount(rest), 2)
    assert r == 0, "2-plex non-universal part must pair up"
    return count_2plex(popcount(F), p, l)
